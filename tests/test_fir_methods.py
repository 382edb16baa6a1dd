"""Equivalence of the three FIR lowering strategies (conv HLO, matmul framing,
FFT overlap-save) — all must match the NumPy reference within f32 tolerance.

The equivalence asserts request ``precision="highest"`` explicitly: a lower
rung on an accelerator is a documented perf/accuracy trade, not an
equivalence bug. The 'high' rung's CPU contract is pinned by
TestHighRungContract below (>= 90 dB), and the int8 rung by TestInt8Matmul."""

import jax.numpy as jnp
import numpy as np
import pytest

from gnuradio4_tpu.ops.fir import fir_apply, fir_init_state


METHODS = ["conv", "matmul", "fft"]


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("ntaps", [9, 64, 127, 513])
def test_real_matches_reference(method, ntaps, rng):
    taps = rng.standard_normal(ntaps).astype(np.float32)
    x = rng.standard_normal(2048).astype(np.float32)
    ref = np.convolve(x.astype(np.float64), taps)[: len(x)]
    y, _ = fir_apply(jnp.asarray(x), jnp.asarray(taps),
                     fir_init_state(0, ntaps, jnp.float32), method=method,
                     precision="highest")
    np.testing.assert_allclose(np.asarray(y), ref, atol=ntaps * 3e-6)


@pytest.mark.parametrize("method", METHODS)
def test_complex_input_real_taps(method, rng):
    taps = rng.standard_normal(63).astype(np.float32)
    x = (rng.standard_normal(1024) + 1j * rng.standard_normal(1024)
         ).astype(np.complex64)
    ref = np.convolve(x.astype(np.complex128), taps)[: len(x)]
    y, _ = fir_apply(jnp.asarray(x), jnp.asarray(taps),
                     fir_init_state(0, 63, jnp.complex64), method=method,
                     precision="highest")
    np.testing.assert_allclose(np.asarray(y), ref, atol=3e-4)


@pytest.mark.parametrize("method", METHODS)
def test_complex_taps(method, rng):
    taps = (rng.standard_normal(31) + 1j * rng.standard_normal(31)
            ).astype(np.complex64)
    x = (rng.standard_normal(1024) + 1j * rng.standard_normal(1024)
         ).astype(np.complex64)
    ref = np.convolve(x.astype(np.complex128), taps.astype(np.complex128)
                      )[: len(x)]
    y, _ = fir_apply(jnp.asarray(x), jnp.asarray(taps),
                     fir_init_state(0, 31, jnp.complex64), method=method,
                     precision="highest")
    np.testing.assert_allclose(np.asarray(y), ref, atol=3e-4)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("decim", [2, 4, 8])
def test_decimation(method, decim, rng):
    taps = rng.standard_normal(32).astype(np.float32)
    x = rng.standard_normal(1024).astype(np.float32)
    ref = np.convolve(x.astype(np.float64), taps)[: len(x)][::decim]
    y, _ = fir_apply(jnp.asarray(x), jnp.asarray(taps),
                     fir_init_state(0, 32, jnp.float32), decim=decim,
                     method=method, precision="highest")
    np.testing.assert_allclose(np.asarray(y), ref, atol=2e-4)


@pytest.mark.parametrize("method", METHODS)
def test_streaming_continuity(method, rng):
    taps = rng.standard_normal(65).astype(np.float32)
    x = rng.standard_normal(4096).astype(np.float32)
    ref = np.convolve(x.astype(np.float64), taps)[: len(x)]
    state = fir_init_state(0, 65, jnp.float32)
    parts = []
    for chunk in x.reshape(4, 1024):
        y, state = fir_apply(jnp.asarray(chunk), jnp.asarray(taps), state,
                             method=method, precision="highest")
        parts.append(np.asarray(y))
    np.testing.assert_allclose(np.concatenate(parts), ref, atol=3e-4)


@pytest.mark.parametrize("method", ["matmul", "fft"])
def test_multichannel(method, rng):
    taps = rng.standard_normal(17).astype(np.float32)
    x = rng.standard_normal((5, 512)).astype(np.float32)
    y, _ = fir_apply(jnp.asarray(x), jnp.asarray(taps),
                     fir_init_state(5, 17, jnp.float32), method=method,
                     precision="highest")
    for c in range(5):
        ref = np.convolve(x[c].astype(np.float64), taps)[:512]
        np.testing.assert_allclose(np.asarray(y)[c], ref, atol=2e-4)


@pytest.mark.parametrize("method", ["matmul", "fft"])
def test_odd_sizes(method, rng):
    """Non-power-of-two stream lengths (single-tile / padded paths)."""
    taps = rng.standard_normal(40).astype(np.float32)
    x = rng.standard_normal(700).astype(np.float32)
    ref = np.convolve(x.astype(np.float64), taps)[:700]
    y, _ = fir_apply(jnp.asarray(x), jnp.asarray(taps),
                     fir_init_state(0, 40, jnp.float32), method=method,
                     precision="highest")
    assert np.asarray(y).shape == (700,)
    np.testing.assert_allclose(np.asarray(y), ref, atol=2e-4)


class TestInt8Matmul:
    def test_real_snr(self, rng):
        taps = rng.standard_normal(127).astype(np.float32)
        x = rng.standard_normal(4096).astype(np.float32)
        ref = np.convolve(x.astype(np.float64), taps)[: len(x)]
        y, _ = fir_apply(jnp.asarray(x), taps,
                         fir_init_state(0, 127, jnp.float32),
                         method="matmul_int8")
        err = np.asarray(y) - ref
        snr = 10 * np.log10(np.mean(ref ** 2) / np.mean(err ** 2))
        assert snr > 40.0, f"int8 SNR {snr:.1f} dB"

    def test_complex_snr(self, rng):
        taps = (rng.standard_normal(63) + 1j * rng.standard_normal(63)
                ).astype(np.complex64)
        x = (rng.standard_normal(2048) + 1j * rng.standard_normal(2048)
             ).astype(np.complex64)
        ref = np.convolve(x.astype(np.complex128), taps.astype(np.complex128)
                          )[: len(x)]
        y, _ = fir_apply(jnp.asarray(x), taps,
                         fir_init_state(0, 63, jnp.complex64),
                         method="matmul_int8")
        err = np.abs(np.asarray(y) - ref)
        snr = 10 * np.log10(np.mean(np.abs(ref) ** 2) / np.mean(err ** 2))
        assert snr > 38.0, f"int8 SNR {snr:.1f} dB"

    def test_decimating(self, rng):
        taps = rng.standard_normal(32).astype(np.float32)
        x = rng.standard_normal(2048).astype(np.float32)
        ref = np.convolve(x.astype(np.float64), taps)[: len(x)][::4]
        y, _ = fir_apply(jnp.asarray(x), taps,
                         fir_init_state(0, 32, jnp.float32), decim=4,
                         method="matmul_int8")
        err = np.asarray(y) - ref
        snr = 10 * np.log10(np.mean(ref ** 2) / (np.mean(err ** 2) + 1e-30))
        assert snr > 40.0


class TestFreqXlatingGolden:
    """Round-4 rotate-then-filter path: FreqXlatingFir's complex-input lowering
    (input NCO rotation + REAL-tap FIR — half the matmul dots) must match the
    float64 textbook freq-xlating form (heterodyned taps + output de-rotation)
    including across decimation, step boundaries, and the real-input path."""

    def _reference(self, x, taps, fc, fs, decim):
        """f64 direct form: y[m] = sum_k h[k]·(x·e^{-j2πfc/fs·n})[m·decim−k]."""
        n = np.arange(len(x), dtype=np.float64)
        xr = x.astype(np.complex128) * np.exp(-2j * np.pi * fc / fs * n)
        y = np.convolve(xr, taps.astype(np.float64))[: len(x)]
        return y[::decim]

    @pytest.mark.parametrize("decim", [1, 4])
    def test_complex_input_matches_direct_form(self, rng, decim):
        import gnuradio4_tpu as gr
        from gnuradio4_tpu.blocks.filter import FreqXlatingFir
        from gnuradio4_tpu.blocks.testing import VectorSink, VectorSource
        fs, fc = 1e6, 123e3
        taps = rng.standard_normal(63).astype(np.float32) / 8
        x = (rng.standard_normal(4096) + 1j * rng.standard_normal(4096)
             ).astype(np.complex64)
        g = gr.Graph()
        src = g.add(VectorSource(data=x))
        fir = g.add(FreqXlatingFir(taps=taps, center_freq=fc,
                                   sample_rate_in=fs, decim=decim))
        snk = g.add(VectorSink())
        g.connect_chain(src, fir, snk)
        gr.Scheduler(g, block_len=1024, sample_rate=fs).run_and_wait()
        got = snk.data()
        ref = self._reference(x, taps, fc, fs, decim)[: len(got)]
        # uint32 NCO quantizes fc/fs to 2^-32 cycles: bound phase drift + f32
        np.testing.assert_allclose(got, ref, atol=2e-3)

    def test_real_input_matches_direct_form(self, rng):
        # real RF input enters through IQDemodulator (untyped input port);
        # it exercises the heterodyned-taps rail of the same block
        import gnuradio4_tpu as gr
        from gnuradio4_tpu.blocks.filter import IQDemodulator
        from gnuradio4_tpu.blocks.testing import VectorSink, VectorSource
        fs, fc, decim = 1e6, 200e3, 2
        taps = rng.standard_normal(31).astype(np.float32) / 8
        x = rng.standard_normal(4096).astype(np.float32)
        g = gr.Graph()
        src = g.add(VectorSource(data=x))
        fir = g.add(IQDemodulator(taps=tuple(taps.tolist()), center_freq=fc,
                                  sample_rate_in=fs, decim=decim))
        snk = g.add(VectorSink())
        g.connect_chain(src, fir, snk)
        gr.Scheduler(g, block_len=1024, sample_rate=fs).run_and_wait()
        got = snk.data()
        ref = self._reference(x, taps, fc, fs, decim)[: len(got)]
        np.testing.assert_allclose(got, ref, atol=2e-3)


def test_bf16_one_pass_snr(rng, monkeypatch):
    """GR4_FIR_PRECISION=bf16 (bf16 operands, f32 accumulation): ~52 dB SNR
    on a 127-tap complex chain — the middle rung of the precision ladder
    (int8 ~40 dB < bf16 ~50 dB < high ~f32)."""
    import gnuradio4_tpu.ops.fir as fir_mod
    monkeypatch.setattr(fir_mod, "_MODE", "bf16")
    taps = rng.standard_normal(127).astype(np.float32) / 10
    x = (rng.standard_normal(1 << 14) + 1j * rng.standard_normal(1 << 14)
         ).astype(np.complex64)
    ref = np.convolve(x.astype(np.complex128), taps)[: len(x)]
    y, _ = fir_apply(jnp.asarray(x), taps, fir_init_state(0, 127, jnp.complex64),
                     method="matmul")
    err = np.abs(np.asarray(y) - ref)
    snr = 10 * np.log10(np.mean(np.abs(ref) ** 2) / np.mean(err ** 2))
    assert snr > 45.0, f"bf16 SNR {snr:.1f} dB"


def test_per_block_precision_setting(rng):
    """FirFilter(precision='bf16'|'int8') overrides the process-wide mode:
    outputs carry the rung's SNR class while a sibling at default stays f32."""
    import gnuradio4_tpu as gr
    taps = rng.standard_normal(63).astype(np.float32) / 8
    x = (rng.standard_normal(8192) + 1j * rng.standard_normal(8192)
         ).astype(np.complex64)
    ref = np.convolve(x.astype(np.complex128), taps)[: len(x)]
    outs = {}
    for prec in ("auto", "bf16", "int8"):
        g = gr.Graph()
        src = g.emplace("VectorSource")
        src.data = x
        fir = g.emplace("FirFilter", taps=tuple(taps.tolist()),
                        precision=prec)
        snk = g.emplace("VectorSink")
        g.connect_chain(src, fir, snk)
        gr.Scheduler(g, block_len=4096, sample_rate=1e6).run_and_wait()
        outs[prec] = np.asarray(snk.data())

    def snr(y):
        e = np.abs(y - ref)
        return 10 * np.log10(np.mean(np.abs(ref) ** 2) / np.mean(e ** 2))
    assert snr(outs["auto"]) > 90.0       # f32 class (conv path on CPU)
    assert 40.0 < snr(outs["bf16"])       # one-pass class
    assert 30.0 < snr(outs["int8"]) < snr(outs["auto"])


def test_explicit_precision_unsatisfiable_raises(rng):
    """An explicit precision rung with ntaps > 512 (no matmul path) must fail
    loudly with GrError at trace time, not silently run the full-precision
    fallback (round-4 advisor finding)."""
    from gnuradio4_tpu.core.errors import GrError
    taps = rng.standard_normal(1024).astype(np.float32)
    x = rng.standard_normal(4096).astype(np.float32)
    with pytest.raises(GrError, match="precision"):
        fir_apply(jnp.asarray(x), taps,
                  fir_init_state(0, len(taps), np.float32),
                  precision="bf16")
    # traced taps (no host constants) are equally unsatisfiable
    with pytest.raises(GrError, match="precision"):
        fir_apply(jnp.asarray(x), jnp.asarray(taps[:63]) * 2.0,
                  fir_init_state(0, 63, np.float32), precision="int8")
    # 'auto' (precision=None) still runs the default lowering
    y, _ = fir_apply(jnp.asarray(x), taps,
                     fir_init_state(0, len(taps), np.float32))
    ref = np.convolve(x.astype(np.float64), taps.astype(np.float64))[:4096]
    assert np.max(np.abs(np.asarray(y) - ref)) < 1e-2


class TestHighRungContract:
    """The 'high' rung on the CPU: >= 90 dB vs the f64 reference on every
    rail combination (the CPU runs every rung in float32). This contract is
    the CPU's only: a GPU runs 'high' in TF32, about 76 dB for FIR127 on an
    H100 (tests/test_gpu.py pins that), which is why 'highest' is the
    default rung."""

    def _snr(self, y, ref):
        err = np.abs(np.asarray(y, dtype=np.complex128) - ref)
        return 10 * np.log10(np.mean(np.abs(ref) ** 2)
                             / (np.mean(err ** 2) + 1e-300))

    def test_real(self, rng):
        taps = rng.standard_normal(127).astype(np.float32)
        x = rng.standard_normal(4096).astype(np.float32)
        ref = np.convolve(x.astype(np.float64), taps)[: len(x)]
        y, _ = fir_apply(jnp.asarray(x), taps,
                         fir_init_state(0, 127, jnp.float32),
                         method="matmul", precision="high")
        assert self._snr(np.asarray(y), ref) > 90.0

    def test_complex(self, rng):
        taps = (rng.standard_normal(63) + 1j * rng.standard_normal(63)
                ).astype(np.complex64)
        x = (rng.standard_normal(2048) + 1j * rng.standard_normal(2048)
             ).astype(np.complex64)
        ref = np.convolve(x.astype(np.complex128),
                          taps.astype(np.complex128))[: len(x)]
        y, _ = fir_apply(jnp.asarray(x), taps,
                         fir_init_state(0, 63, jnp.complex64),
                         method="matmul", precision="high")
        assert self._snr(np.asarray(y), ref) > 90.0
