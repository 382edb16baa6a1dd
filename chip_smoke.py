#!/usr/bin/env python3
"""On-card smoke check: the flowgraph main path, end to end, on one NVIDIA GPU.

Every phase builds a ``gr.Graph``, runs it through ``gr.Scheduler`` into real
sinks at the size users run, and compares what comes out with a plain
NumPy/SciPy float64 reference that shares no code with the package. Inputs
are made from ``--seed``.

  1. device      JAX must report a GPU (no CPU fallback); card name, power limit
  2. headline    FreqXlatingFir(127) → FFT-4096 magnitude, → QuadratureDemod →
                 FirFilter(63, decim 8); 8 Mi complex samples per step, 3 steps;
                 plus the error of each FIR precision rung against float64
  3. scheduler   PFBChannelizer(256, 8 taps/phase) → QuadratureDemod with tags,
                 block 2 Mi, batch_steps=8, 2 super-steps
  4. ldpc        LdpcDecoder n=256 R=1/2, 25 iterations, blocks of 128 Ki LLRs
  5. callback    PolarDecoder (a host pure_callback inside the device program)
  6. tests       the tests marked ``gpu`` (pytest, in this process)

Each phase prints one ``phase`` line; the last line is the JSON result
``{"ok": true, "device": {...}}``, printed only when every phase passed on a GPU.

  python chip_smoke.py                 one card, all phases
  python chip_smoke.py --multi         four cards: the phase-3 graph on an
                                       ("sp",) mesh of 4 and an ("sp","chan")
                                       mesh of 2x2, each against one device
  python chip_smoke.py --check-compile first call after a change of shapes:
                                       one step per phase, memory analysis,
                                       no timing, no tests
  JAX_PLATFORMS=cpu python chip_smoke.py --tiny
                                       CPU rehearsal at tiny sizes; never
                                       prints the ok line
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass(frozen=True)
class Sizes:
    headline_block: int
    headline_steps: int
    sched_block: int
    sched_batch: int
    sched_supersteps: int
    tag_period: int
    ldpc_block: int
    ldpc_steps: int


FULL = Sizes(headline_block=1 << 23, headline_steps=3, sched_block=1 << 21,
             sched_batch=8, sched_supersteps=2, tag_period=1 << 20,
             ldpc_block=1 << 17, ldpc_steps=3)
TINY = Sizes(headline_block=1 << 13, headline_steps=3, sched_block=1 << 13,
             sched_batch=2, sched_supersteps=2, tag_period=5000,
             ldpc_block=1 << 10, ldpc_steps=3)

# Tolerances, each with its reason.
FIR_SNR_MIN_DB = 90.0       # the default FIR rung's contract (tests/test_fir_methods.py)
SPEC_REL_TOL = 1e-4         # ||Δ|| / ||ref|| of the FFT magnitude: f32 FIR + cuFFT
PHASE_TOL_RAD = 1e-3        # demod output, wrapped to (−π, π]
MAG_FLOOR = 0.1             # demod samples whose |input| (or |input[n−1]|) is below
#                             this fraction of the rms are left out: arg() of a
#                             near-zero sample is ill-conditioned
MESH_TOL = 1e-4             # --multi: sharded vs one device (as __graft_entry__.py)
FS = 20e6                   # headline sample rate
CHANNELS, TAPS_PER_PHASE = 256, 8
LDPC_N, LDPC_M, LDPC_ITERS, LDPC_ALPHA, LDPC_SIGMA = 256, 128, 25, 0.8125, 0.6


class PhaseFailure(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailure(what)


# -- the card ------------------------------------------------------------------

def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for the first card."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    lines = r.stdout.strip().splitlines()
    return lines[0].strip() if lines else f"nvidia-smi rc={r.returncode}"


def peak_bytes() -> int | None:
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def memory_analysis(sched) -> str:
    """XLA's memory analysis of the scheduler's compiled step."""
    c = sched.compiled
    args = [sched._states, c.gather_params(), {}]
    if c.batch_steps > 1:
        args.append({})
    return str(c.step_fn.lower(*args).compile().memory_analysis())


# -- plain float64 references (NumPy/SciPy only) ---------------------------------

def ref_fir(x: np.ndarray, taps: np.ndarray, decim: int = 1) -> np.ndarray:
    """y[m] = Σ_k h[k]·x[m·decim − k], zero prehistory, float64."""
    from scipy.signal import oaconvolve
    y = oaconvolve(x.astype(np.complex128 if np.iscomplexobj(x) else np.float64),
                   taps.astype(np.float64))[: len(x)]
    return y[::decim]


def ref_demod(y: np.ndarray, prev: complex = 1.0) -> np.ndarray:
    """gain-1 FM discriminator arg(y[n]·conj(y[n−1])), y[−1] = ``prev``."""
    yp = np.concatenate([[prev], y[:-1]])
    return np.angle(y * np.conj(yp))


def ref_hann(n: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / (n - 1))


def ref_pfb(x: np.ndarray, taps: np.ndarray, m: int) -> np.ndarray:
    """Critically sampled analysis bank: channels [m, len(x)/m], float64.
    v[n, p] = Σ_j h[j·m + p]·X[n − j, p] with X[n, p] = x[n·m + p]; channel k
    is Σ_p v[n, p]·e^{−j2πpk/m}."""
    rows = x.astype(np.complex128).reshape(-1, m)
    p_taps = len(taps) // m
    hp = taps.astype(np.float64).reshape(p_taps, m)
    pad = np.concatenate([np.zeros((p_taps - 1, m)), rows])
    r = rows.shape[0]
    v = np.zeros_like(rows)
    for j in range(p_taps):
        v += hp[j] * pad[p_taps - 1 - j: p_taps - 1 - j + r]
    return np.fft.fft(v, axis=1).T


def ref_min_sum(H: np.ndarray, llr: np.ndarray, n_iters: int, alpha: float
                ) -> tuple[np.ndarray, np.ndarray]:
    """Normalized min-sum BP on [frames, n] LLRs (positive = bit 0), in
    float32 like the device. Returns (hard bits uint8, syndrome_ok bool)."""
    m, n = H.shape
    wr = int(H.sum(axis=1).max())
    V = np.zeros((m, wr), np.int64)
    mask = np.zeros((m, wr), bool)
    for i in range(m):
        vs = np.nonzero(H[i])[0]
        V[i, : len(vs)] = vs
        mask[i, : len(vs)] = True
    l = llr.astype(np.float32)
    lv = np.where(mask, l[:, V], np.float32(0))             # [b, m, wr]
    big = np.float32(1e30)
    fa = np.float32(alpha)
    flat_v = V[mask]

    def to_vars(c2v):                                        # Σ per variable
        tot = np.zeros((l.shape[0], n), np.float32)
        for e, var in enumerate(flat_v):
            tot[:, var] += c2v[:, mask][:, e]
        return tot

    v2c = lv.copy()
    c2v = np.zeros_like(lv)
    for _ in range(n_iters):
        mag = np.where(mask, np.abs(v2c), big)
        neg = mask & (v2c < 0)
        odd = (neg.sum(axis=-1, keepdims=True) - neg) % 2
        sign = np.where(odd == 1, np.float32(-1), np.float32(1))
        first = np.argmin(mag, axis=-1)
        is_first = np.arange(wr) == first[..., None]
        min1 = mag.min(axis=-1, keepdims=True)
        min2 = np.where(is_first, big, mag).min(axis=-1, keepdims=True)
        c2v = np.where(mask, fa * sign * np.where(is_first, min2, min1),
                       np.float32(0)).astype(np.float32)
        tot = to_vars(c2v)
        v2c = np.where(mask, lv + tot[:, V] - c2v, np.float32(0))
    hard = ((l + to_vars(c2v)) < 0).astype(np.uint8)
    ok = ((hard.astype(np.int64) @ H.T.astype(np.int64)) % 2 == 0).all(axis=1)
    return hard, ok


def wrapped(d: np.ndarray) -> np.ndarray:
    return np.angle(np.exp(1j * d))


def snr_db(got: np.ndarray, ref: np.ndarray) -> float:
    err = np.asarray(got, np.complex128) - ref
    return float(10 * np.log10(np.sum(np.abs(ref) ** 2)
                               / max(np.sum(np.abs(err) ** 2), 1e-300)))


# -- inputs made from the seed ---------------------------------------------------

def fm_signal(rng, n: int) -> np.ndarray:
    """An FM carrier at +3 MHz (three message tones, 75 kHz deviation), an
    interferer at −5 MHz and complex white noise, at FS."""
    t = np.arange(n, dtype=np.float64)
    msg = sum(a * np.sin(2 * np.pi * f / FS * t + p) for a, f, p in zip(
        rng.uniform(0.2, 0.4, 3), rng.uniform(1e3, 15e3, 3),
        rng.uniform(0, 2 * np.pi, 3)))
    phase = 2 * np.pi * 3e6 / FS * t + 2 * np.pi * 75e3 / FS * np.cumsum(msg)
    x = np.exp(1j * phase) + 0.5 * np.exp(-2j * np.pi * 5e6 / FS * t)
    x += 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return x.astype(np.complex64)


def design_lowpass(ntaps: int, cutoff: float) -> np.ndarray:
    """Hamming-windowed sinc, unity DC gain; ``cutoff`` in cycles/sample."""
    k = np.arange(ntaps) - (ntaps - 1) / 2.0
    h = 2 * cutoff * np.sinc(2 * cutoff * k) * np.hamming(ntaps)
    return (h / h.sum()).astype(np.float32)


# -- phases ----------------------------------------------------------------------

def phase_device(tiny: bool) -> dict:
    import jax
    dev = jax.devices()[0]
    check(tiny or dev.platform == "gpu",
          f"JAX's first device is {dev.platform!r}, not a GPU")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def phase_headline(sizes: Sizes, seed: int, check_compile: bool = False
                   ) -> dict:
    import jax
    import jax.numpy as jnp
    import gnuradio4_tpu as gr
    from gnuradio4_tpu.blocks.testing import VectorSink, VectorSource
    from gnuradio4_tpu.ops import fir as fir_ops
    from gnuradio4_tpu.utils.timing import median_call_s, run_scheduler_timed

    rng = np.random.default_rng(seed)
    b = sizes.headline_block
    steps = 1 if check_compile else sizes.headline_steps
    n = b * steps
    x = fm_signal(rng, n)
    taps = design_lowpass(127, 2e6 / FS)
    audio_taps = design_lowpass(63, 1e6 / FS)

    g = gr.Graph()
    src = g.add(VectorSource(x, device_resident=True))
    fir = g.emplace("FreqXlatingFir", taps=taps, center_freq=3e6,
                    sample_rate_in=FS, decim=1)
    fft = g.emplace("FFT", fft_size=4096, window="Hann", output="magnitude",
                    calibrate=False)
    dem = g.emplace("QuadratureDemod", gain=1.0)
    audio = g.emplace("FirFilter", taps=audio_taps, decim=8)
    spec_snk, dem_snk, audio_snk = (g.add(VectorSink()) for _ in range(3))
    g.connect_chain(src, fir, fft, spec_snk)
    g.connect_chain(fir, dem, audio, audio_snk)
    g.connect(dem, dem_snk)
    sched = gr.Scheduler(g, block_len=b, sample_rate=FS)
    sched.init()
    rec = run_scheduler_timed(sched)
    if check_compile:
        rec["memory_analysis"] = memory_analysis(sched)

    # reference: rotate-then-filter is the textbook freq-xlating FIR
    t = np.arange(n, dtype=np.float64)
    x_rot = x.astype(np.complex128) * np.exp(-2j * np.pi * 3e6 / FS * t)
    y_ref = ref_fir(x_rot, taps)
    frames = y_ref.reshape(-1, 4096) * ref_hann(4096)
    spec_ref = np.abs(np.fft.fft(frames, axis=-1)).reshape(-1)
    dem_ref = ref_demod(y_ref)
    spec, demod, aud = spec_snk.data(), dem_snk.data(), audio_snk.data()
    check(spec.shape == (n,) and demod.shape == (n,) and aud.shape == (n // 8,),
          f"sink shapes {spec.shape} {demod.shape} {aud.shape}")
    check(all(np.isfinite(a).all() for a in (spec, demod, aud)), "non-finite")
    rec["spec_rel_err"] = float(np.linalg.norm(spec - spec_ref)
                                / np.linalg.norm(spec_ref))
    mag = np.abs(y_ref)
    floor = MAG_FLOOR * np.sqrt(np.mean(mag ** 2))
    keep = (mag >= floor) & (np.concatenate([[1.0], mag[:-1]]) >= floor)
    rec["demod_max_err_rad"] = float(np.max(np.abs(wrapped(demod - dem_ref))[keep]))
    rec["demod_kept"] = float(keep.mean())
    # the audio FIR alone: its reference filters the card's own demod output
    rec["audio_fir_snr_db"] = snr_db(aud, ref_fir(demod.astype(np.float64),
                                                   audio_taps, 8))

    # the precision rungs of the banded-matmul FIR, one block, vs float64
    xb = jnp.asarray(x_rot[:b].astype(np.complex64))
    yb_ref = ref_fir(x_rot[:b].astype(np.complex64), taps)
    state0 = fir_ops.fir_init_state(0, len(taps), jnp.complex64)
    rungs = {}
    for rung in ("default", "high", "highest"):
        f = jax.jit(lambda v, s, r=rung: fir_ops.fir_apply(
            v, taps, s, method="matmul", precision=r)[0])
        rungs[rung] = snr_db(np.asarray(f(xb, state0)), yb_ref)
    rec["rung_snr_db"] = rungs
    rec["rung_choice"] = next((r for r in ("default", "high", "highest")
                               if rungs[r] >= FIR_SNR_MIN_DB), None)
    rec["rung_default"] = fir_ops.default_rung()
    # the same rungs of the four-step matmul FFT (off the default path:
    # FFT blocks take cuFFT) on up to 64 frames of 4096, vs float64
    from gnuradio4_tpu.ops.fft import matmul_fft
    n_fr = min(64, n // 4096)
    fr = x[: n_fr * 4096].reshape(n_fr, 4096)
    fr_ref = np.fft.fft(fr.astype(np.complex128), axis=-1)
    rec["fft_matmul_rung_snr_db"] = {
        r: snr_db(np.asarray(matmul_fft(jnp.asarray(fr), 4096, mode=r)), fr_ref)
        for r in ("high", "highest")}
    rec["method_auto"] = fir_ops.auto_method(len(taps))
    # XLA's time for the plain FIR127 → demod pair on one block: the number
    # a fused FIR+demod kernel would have to beat
    from gnuradio4_tpu.ops.demod import quadrature_demod
    pair = jax.jit(lambda v, s: quadrature_demod(
        fir_ops.fir_apply(v, taps, s)[0], jnp.ones((), jnp.complex64),
        gain=1.0)[0])
    rec["fir127_demod_xla_ms"] = median_call_s(pair, xb, state0) * 1e3
    check(rec["spec_rel_err"] <= SPEC_REL_TOL,
          f"spectrum rel err {rec['spec_rel_err']:.3g} > {SPEC_REL_TOL}")
    check(rec["demod_max_err_rad"] <= PHASE_TOL_RAD,
          f"demod err {rec['demod_max_err_rad']:.3g} rad > {PHASE_TOL_RAD}")
    check(rec["audio_fir_snr_db"] >= FIR_SNR_MIN_DB,
          f"audio FIR SNR {rec['audio_fir_snr_db']:.1f} dB < {FIR_SNR_MIN_DB}")
    check(rungs[rec["rung_default"]] >= FIR_SNR_MIN_DB,
          f"default rung {rec['rung_default']!r} at "
          f"{rungs[rec['rung_default']]:.1f} dB < {FIR_SNR_MIN_DB}")
    return rec


def _channelizer_graph(x: np.ndarray, sizes: Sizes, taps: np.ndarray):
    import gnuradio4_tpu as gr
    from gnuradio4_tpu.blocks.testing import VectorSink, VectorSource
    from gnuradio4_tpu.core.tags import Tag
    marks = list(range(1000, len(x), sizes.tag_period))
    g = gr.Graph()
    src = g.add(VectorSource(x, device_resident=True, tags=[
        Tag(i, {"trigger_time": i / 1e9}) for i in marks]))
    chan = g.emplace("PFBChannelizer", n_channels=CHANNELS,
                     taps_per_phase=TAPS_PER_PHASE, taps=tuple(taps.tolist()))
    dem = g.emplace("QuadratureDemod", gain=1.0)
    snk = g.add(VectorSink())
    g.connect_chain(src, chan, dem, snk)
    return g, snk, marks


def _channelizer_input(sizes: Sizes, seed: int, supersteps: int):
    rng = np.random.default_rng(seed + 1)
    n = sizes.sched_block * sizes.sched_batch * supersteps
    x = ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
         / np.sqrt(2)).astype(np.complex64)
    taps = design_lowpass(CHANNELS * TAPS_PER_PHASE, 0.5 / CHANNELS)
    return x, taps


def _sink_tags(snk) -> list[tuple[int, float]]:
    return [(int(t.index), float(t.map["trigger_time"]))
            for t in snk.tags if "trigger_time" in t.map]


def _demod_keep(x, taps):
    """(float64 reference demod, mask of well-conditioned samples)."""
    y = ref_pfb(x, taps, CHANNELS)
    mag = np.abs(y)
    floor = MAG_FLOOR * np.sqrt(np.mean(mag ** 2))
    prev = np.concatenate([np.ones((CHANNELS, 1)), mag[:, :-1]], axis=1)
    return ref_demod_rows(y), (mag >= floor) & (prev >= floor)


def ref_demod_rows(y: np.ndarray) -> np.ndarray:
    yp = np.concatenate([np.ones((y.shape[0], 1)), y[:, :-1]], axis=1)
    return np.angle(y * np.conj(yp))


def phase_scheduler(sizes: Sizes, seed: int, check_compile: bool = False
                    ) -> dict:
    import gnuradio4_tpu as gr
    from gnuradio4_tpu.utils.timing import run_scheduler_timed
    supersteps = 1 if check_compile else sizes.sched_supersteps
    x, taps = _channelizer_input(sizes, seed, supersteps)
    g, snk, marks = _channelizer_graph(x, sizes, taps)
    sched = gr.Scheduler(g, block_len=sizes.sched_block, sample_rate=1e9,
                         pipeline_depth=2, async_delivery=True,
                         batch_steps=sizes.sched_batch)
    sched.init()
    rec = run_scheduler_timed(sched)
    if check_compile:
        rec["memory_analysis"] = memory_analysis(sched)
    out = snk.data()
    n_out = len(x) // CHANNELS
    check(out.shape == (CHANNELS, n_out), f"sink shape {out.shape}")
    check(np.isfinite(out).all(), "non-finite")
    dem_ref, keep = _demod_keep(x, taps)
    rec["demod_max_err_rad"] = float(np.max(np.abs(wrapped(out - dem_ref))[keep]))
    rec["demod_kept"] = float(keep.mean())
    want = [(i // CHANNELS, i / 1e9) for i in marks]
    got = _sink_tags(snk)
    rec["tags"] = len(got)
    check(rec["demod_max_err_rad"] <= PHASE_TOL_RAD,
          f"demod err {rec['demod_max_err_rad']:.3g} rad > {PHASE_TOL_RAD}")
    check(got == want, f"tags at the sink {got[:4]}… != expected {want[:4]}…")
    return rec


def phase_ldpc(sizes: Sizes, seed: int, check_compile: bool = False) -> dict:
    import jax.numpy as jnp
    import gnuradio4_tpu as gr
    from gnuradio4_tpu.blocks.testing import VectorSink, VectorSource
    from gnuradio4_tpu.ops.ldpc import LdpcGraph, encode, make_ldpc, min_sum_decode
    from gnuradio4_tpu.utils.timing import run_scheduler_timed

    rng = np.random.default_rng(seed + 2)
    steps = 1 if check_compile else sizes.ldpc_steps
    H, G = make_ldpc(LDPC_N, LDPC_M, wc=3, seed=0)   # the decoder block's code
    k = G.shape[0]
    frames = sizes.ldpc_block * steps // LDPC_N
    u = rng.integers(0, 2, (frames, k)).astype(np.uint8)
    c = encode(G, u)
    y = 1.0 - 2.0 * c + LDPC_SIGMA * rng.standard_normal(c.shape)
    llr = (2 * y / LDPC_SIGMA ** 2).astype(np.float32)

    g = gr.Graph()
    src = g.add(VectorSource(llr.reshape(-1), device_resident=True))
    dec = g.emplace("LdpcDecoder", n=LDPC_N, m=LDPC_M, seed=0,
                    n_iters=LDPC_ITERS, alpha=LDPC_ALPHA)
    snk = g.add(VectorSink())
    g.connect_chain(src, dec, snk)
    sched = gr.Scheduler(g, block_len=sizes.ldpc_block, sample_rate=1e6)
    sched.init()
    rec = run_scheduler_timed(sched)
    if check_compile:
        rec["memory_analysis"] = memory_analysis(sched)
    hard_ref, ok_ref = ref_min_sum(H, llr, LDPC_ITERS, LDPC_ALPHA)
    bits = snk.data().reshape(frames, k)
    hard, ok = min_sum_decode(LdpcGraph(H), jnp.asarray(llr), LDPC_ITERS,
                              LDPC_ALPHA)
    rec["frames"] = frames
    rec["syndrome_ok"] = int(ok_ref.sum())
    rec["bit_errors_vs_sent"] = int((hard_ref[:, :k] != u).sum())
    check(np.array_equal(bits, hard_ref[:, :k].astype(np.float32)),
          f"{int((bits != hard_ref[:, :k]).sum())} decoded bits differ")
    check(np.array_equal(np.asarray(hard), hard_ref), "hard decisions differ")
    check(np.array_equal(np.asarray(ok), ok_ref), "syndrome_ok flags differ")
    return rec


def phase_callback(seed: int) -> dict:
    import gnuradio4_tpu as gr
    from gnuradio4_tpu.blocks.testing import VectorSink, VectorSource
    from gnuradio4_tpu.ops.polar import frozen_mask, polar_encode
    from gnuradio4_tpu.utils.timing import run_scheduler_timed

    rng = np.random.default_rng(seed + 3)
    n, k, sigma = 256, 128, 0.5
    fr = frozen_mask(n, k)
    bits = rng.integers(0, 2, 8 * k).astype(np.uint8)
    cw = polar_encode(bits, fr)
    y = 1.0 - 2.0 * cw + sigma * rng.standard_normal(len(cw))
    llr = (2 * y / sigma ** 2).astype(np.float32)
    g = gr.Graph()
    src = g.add(VectorSource(llr))
    dec = g.emplace("PolarDecoder", n=n, k=k)
    snk = g.add(VectorSink())
    g.connect_chain(src, dec, snk)
    sched = gr.Scheduler(g, block_len=2 * n, sample_rate=1e6)
    sched.init()
    rec = run_scheduler_timed(sched)
    rec["channel_bit_errors"] = int(((y < 0) != cw).sum())
    check(rec["channel_bit_errors"] > 0, "the channel made no errors")
    check(np.array_equal(snk.data(), bits.astype(np.float32)),
          "polar decode differs from the sent bits")
    return rec


def phase_tests() -> dict:
    """The tests marked ``gpu``, run by pytest in this process (a second
    JAX process could not get the card's memory)."""
    import pytest
    files = sorted(str(p) for p in (HERE / "tests").glob("test_*.py")
                   if "mark.gpu" in p.read_text())
    check(bool(files), "no tests are marked gpu")
    os.environ["GR4_TEST_PLATFORM"] = "gpu"
    t0 = time.perf_counter()
    rc = pytest.main(["-q", "-p", "no:cacheprovider", "-m", "gpu", *files])
    rec = {"files": len(files), "pytest_rc": int(rc),
           "wall_s": time.perf_counter() - t0}
    check(rc == 0, f"pytest exit code {int(rc)}")
    return rec


def phase_multi(sizes: Sizes, seed: int, n_dev: int = 4) -> dict:
    """The phase-3 graph on an ("sp",) mesh of 4 and an ("sp", "chan") mesh of
    2x2, each against the single-device run in this process."""
    import jax
    import gnuradio4_tpu as gr
    from jax.sharding import Mesh
    from gnuradio4_tpu.utils.timing import run_scheduler_timed

    devs = jax.devices()
    check(len(devs) >= n_dev, f"need {n_dev} devices, JAX has {len(devs)}")
    x, taps = _channelizer_input(sizes, seed, sizes.sched_supersteps)
    _, keep = _demod_keep(x, taps)

    def run(mesh):
        g, snk, marks = _channelizer_graph(x, sizes, taps)
        sched = gr.Scheduler(g, block_len=sizes.sched_block, sample_rate=1e9,
                             pipeline_depth=2, mesh=mesh,
                             batch_steps=sizes.sched_batch)
        sched.init()
        rec = run_scheduler_timed(sched)
        return snk.data(), _sink_tags(snk), rec

    ref, ref_tags, rec1 = run(None)
    check(len(ref_tags) > 0, "the single-device run delivered no tags")
    out = {"single": rec1}
    meshes = {"sp4": Mesh(np.asarray(devs[:n_dev]), ("sp",)),
              "sp2xchan2": Mesh(np.asarray(devs[:n_dev]).reshape(2, 2),
                                ("sp", "chan"))}
    for name, mesh in meshes.items():
        got, got_tags, rec = run(mesh)
        check(got.shape == ref.shape, f"{name}: shape {got.shape} != {ref.shape}")
        rec["max_abs_diff"] = float(np.max(np.abs(wrapped(got - ref))[keep]))
        rec["tags"] = len(got_tags)
        out[name] = rec
        check(rec["max_abs_diff"] < MESH_TOL,
              f"{name}: max|Δ| {rec['max_abs_diff']:.3g} >= {MESH_TOL}")
        check(got_tags == ref_tags, f"{name}: tags differ from one device")
    return out


# -- main ----------------------------------------------------------------------

def emit(name: str, ok: bool, rec: dict, card: str) -> None:
    line = {"phase": name, "ok": ok, **rec, "card": card}
    print("phase " + json.dumps(line, default=str), flush=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true",
                    help="CPU rehearsal at tiny sizes (never prints the ok line)")
    ap.add_argument("--multi", action="store_true",
                    help="only the four-card mesh phase")
    ap.add_argument("--check-compile", action="store_true",
                    help="one step per phase + XLA memory analysis; no tests")
    args = ap.parse_args(argv)
    sizes = TINY if args.tiny else FULL
    try:
        device = phase_device(args.tiny)
    except PhaseFailure as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    card = card_line() if device["platform"] == "gpu" else "no GPU (rehearsal)"
    print(f"device: {device['kind']} x{device['count']} ({device['platform']})",
          flush=True)
    print(f"card: {card}", flush=True)
    # the package is imported only now, from next to this script
    sys.path.insert(0, str(HERE))
    import gnuradio4_tpu
    if Path(gnuradio4_tpu.__file__).resolve().parent.parent != HERE:
        print(f"chip_smoke: imported {gnuradio4_tpu.__file__}, not this "
              f"checkout's package", file=sys.stderr)
        return 1
    from gnuradio4_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    if args.multi:
        phases = [("multi", lambda: phase_multi(sizes, args.seed))]
    else:
        cc = args.check_compile
        phases = [
            ("headline", lambda: phase_headline(sizes, args.seed, cc)),
            ("scheduler", lambda: phase_scheduler(sizes, args.seed, cc)),
            ("ldpc", lambda: phase_ldpc(sizes, args.seed, cc)),
            ("callback", lambda: phase_callback(args.seed)),
        ]
        if not (args.tiny or cc):
            phases.append(("tests", phase_tests))
    failed = []
    for name, fn in phases:
        try:
            rec = fn()
            ok = True
        except Exception as e:            # report, then fail the run below
            traceback.print_exc()
            rec, ok = {"error": f"{type(e).__name__}: {e}"}, False
            failed.append(name)
        rec["peak_bytes"] = peak_bytes()
        emit(name, ok, rec, card)
    if failed:
        print(f"chip_smoke: FAILED phases {failed}", file=sys.stderr)
        return 1
    if args.tiny or args.check_compile:
        print("chip_smoke: all phases passed (no ok line in this mode)")
        return 0
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
