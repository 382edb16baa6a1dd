"""Tests that need an NVIDIA GPU (``@pytest.mark.gpu``): they skip elsewhere,
and ``python chip_smoke.py`` runs them on the card. Each pins something a
CPU run cannot show: which lowering a selector takes on the GPU, the
precision the GPU's dots give, and host callbacks from the device program."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gnuradio4_tpu as gr
from gnuradio4_tpu.blocks.testing import VectorSink, VectorSource

pytestmark = pytest.mark.gpu


def _snr_db(y, ref):
    err = np.abs(np.asarray(y, np.complex128) - ref)
    return 10 * np.log10(np.sum(np.abs(ref) ** 2) / np.sum(err ** 2))


def test_selectors_take_the_gpu_paths():
    from gnuradio4_tpu.ops.fir import auto_method
    from gnuradio4_tpu.ops.ldpc import ldpc_layout
    from gnuradio4_tpu.ops.resample import auto_resample_method
    assert jax.default_backend() == "gpu"
    assert auto_method(127) == auto_method(127, backend="gpu")
    assert auto_resample_method(1 << 20, 2) == auto_resample_method(
        1 << 20, 2, backend="gpu")
    assert ldpc_layout() == ldpc_layout("gpu")


@pytest.mark.parametrize("cx", [False, True])
def test_fir_default_rung_meets_contract(rng, cx):
    """The rung a FIR takes when none is asked for holds >= 90 dB on the
    GPU's dot units (a float32 dot may run in TF32 unless told otherwise)."""
    from gnuradio4_tpu.ops.fir import fir_apply, fir_init_state
    taps = rng.standard_normal(127).astype(np.float32) / 10
    n = 1 << 16
    x = rng.standard_normal(n).astype(np.float32)
    if cx:
        x = (x + 1j * rng.standard_normal(n)).astype(np.complex64)
    ref = np.convolve(x.astype(np.complex128), taps)[:n]
    y, _ = jax.jit(lambda v, s: fir_apply(v, taps, s))(
        jnp.asarray(x), fir_init_state(0, 127, x.dtype))
    assert _snr_db(y, ref) >= 90.0


def test_fir_high_rung_is_tf32_on_gpu(rng):
    """'high' asks XLA for a float32 dot of HIGH precision; the GPU runs that
    in TF32 (10-bit mantissa), below the >= 90 dB the CPU gives the rung
    (TestHighRungContract). 'highest' keeps float32 on the card."""
    from gnuradio4_tpu.ops.fir import fir_apply, fir_init_state
    taps = rng.standard_normal(127).astype(np.float32) / 10
    x = (rng.standard_normal(1 << 16)
         + 1j * rng.standard_normal(1 << 16)).astype(np.complex64)
    ref = np.convolve(x.astype(np.complex128), taps)[: len(x)]
    snr = {}
    for rung in ("high", "highest"):
        y, _ = jax.jit(lambda v, s, r=rung: fir_apply(
            v, taps, s, method="matmul", precision=r))(
            jnp.asarray(x), fir_init_state(0, 127, jnp.complex64))
        snr[rung] = _snr_db(y, ref)
    assert snr["high"] < 90.0 < snr["highest"], snr


@pytest.mark.parametrize("n,n1", [(4096, 64), (1024, 32)])
def test_matmul_fft_highest_rung_is_float32_on_gpu(rng, n, n1):
    """The four-step matmul FFT keeps its float32 (> 120 dB) contract at
    'highest' on the card; 'high' is TF32 there, as for the FIR."""
    from gnuradio4_tpu.ops.fft import matmul_fft
    x = (rng.standard_normal((8, n)) + 1j * rng.standard_normal((8, n))
         ).astype(np.complex64)
    ref = np.fft.fft(x.astype(np.complex128), axis=-1)
    hi = _snr_db(matmul_fft(jnp.asarray(x), n, n1=n1, mode="high"), ref)
    top = _snr_db(matmul_fft(jnp.asarray(x), n, n1=n1, mode="highest"), ref)
    assert top > 120.0 and hi < top, (hi, top)


def test_bf16_rung_uses_bf16_operands(rng):
    from gnuradio4_tpu.ops.fir import bf16_einsum
    a = jnp.asarray(rng.standard_normal((2, 8, 64)).astype(np.float32))
    w = jnp.asarray(rng.standard_normal((64, 32)).astype(np.float32))
    hlo = jax.jit(lambda p, q: bf16_einsum("bnj,ji->bni", p, q)).lower(
        a, w).as_text()
    assert "bf16" in hlo and "dot_general" in hlo
    got = np.asarray(bf16_einsum("bnj,ji->bni", a, w))
    ref = np.einsum("bnj,ji->bni", np.asarray(a, np.float64), np.asarray(w))
    assert _snr_db(got, ref) > 40.0


def test_host_callback_block_runs_on_gpu():
    x = np.arange(4096, dtype=np.float32)
    g = gr.Graph()
    src = g.add(VectorSource(x))
    hb = g.emplace("HostBlock", fn=lambda a: a * 2)
    snk = g.add(VectorSink())
    g.connect_chain(src, hb, snk)
    gr.Scheduler(g, block_len=1024).run_and_wait()
    np.testing.assert_array_equal(snk.data(), 2 * x)


def test_iir_auto_takes_parallel_and_matches_scan(rng):
    b = (0.020083365564211, 0.040166731128423, 0.020083365564211)
    a = (1.0, -1.561018075800718, 0.641351538057563)
    x = rng.standard_normal(1 << 14).astype(np.float32)
    outs = {}
    for eng in ("auto", "scan"):
        g = gr.Graph()
        src = g.add(VectorSource(x))
        iir = g.emplace("IirFilter", b=b, a=a, engine=eng)
        snk = g.add(VectorSink())
        g.connect_chain(src, iir, snk)
        gr.Scheduler(g, block_len=4096).run_and_wait()
        outs[eng] = snk.data()
        if eng == "auto":
            assert iir._engine() == "parallel"
    np.testing.assert_allclose(outs["auto"], outs["scan"], atol=1e-4)


def test_ldpc_dense_layout_matches_segment(rng):
    from gnuradio4_tpu.ops.ldpc import (LdpcGraph, make_ldpc,
                                        min_sum_decode_dense,
                                        min_sum_decode_segment)
    H, _ = make_ldpc(256, 128, wc=3, seed=0)
    g = LdpcGraph(H)
    llr = jnp.asarray((4 + 2 * rng.standard_normal((64, 256))).astype(np.float32))
    h1, ok1 = min_sum_decode_dense(g, llr, 25)
    h2, ok2 = min_sum_decode_segment(g, llr, 25)
    np.testing.assert_array_equal(np.asarray(h1), np.asarray(h2))
    np.testing.assert_array_equal(np.asarray(ok1), np.asarray(ok2))
