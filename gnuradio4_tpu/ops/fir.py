"""FIR filtering kernels (overlap-save, decimating, frequency-translating).

Reference capability: per-sample FIR with a HistoryBuffer of tap history
(blocks/filter/include/gnuradio-4.0/filter/time_domain_filter.hpp:24 ``fir_filter``;
history: core HistoryBuffer.hpp:68).

Design: **overlap-save over time blocks** — the carried state is the last
``ntaps-1`` input samples (the exact analog of the HistoryBuffer tail); each step
filters ``concat([state, x])`` "valid", producing exactly ``len(x)`` outputs.

Three lowering strategies, selected by ``method`` (default ``auto``):

- ``matmul`` (accelerator default with decimation, K ≤ 512): conv-as-matmul.
  The stream is framed into overlapping tiles [n_tiles, L+K−1] using two
  *reshape/slice* ops (no gather): with A = xc.reshape(n_tiles+1, L) and
  K−1 ≤ L, frames = concat([A[:-1], A[1:, :K−1]], axis=1). One dense
  [L+K−1, L/decim] banded-Toeplitz matmul per tile → ~2× MAC overhead, but it
  runs on the matrix units instead of a long 1-D convolution.
- ``fft`` (accelerator default without decimation, and long taps): classic FFT
  overlap-save — frames FFT'd, multiplied by the taps' spectrum, inverse-FFT'd,
  valid region kept.
- ``conv``: XLA conv HLO (CPU default; decimation fused via window_strides).

Complex data decomposes into re/im rails sharing the real pipelines (complex taps
use the full 4-matmul mix).
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

# Precision rung of the FIR matmuls (the XLA dot ``precision``). On an H100
# both 'default' and 'high' run float32 dots in TF32 (measured 71 dB SNR for
# a 127-tap FIR against float64) and only 'highest' keeps float32 (136 dB),
# so 'highest' is the default: the FIR contract is >= 90 dB. The CPU computes
# every rung in float32. Override with
# GR4_FIR_PRECISION=default|high|highest|bf16|int8.
# 'bf16' casts both operands to bf16 explicitly (f32 accumulation, ~45-52 dB
# SNR) — the filter analog of an 8-bit-mantissa front-end, for links whose
# budget allows it; 'int8' quantizes both operands (~40 dB).
_ENV_AT_IMPORT = os.environ.get("GR4_FIR_PRECISION", "highest").lower()
_MODE = _ENV_AT_IMPORT
_PRECISION = {
    "default": jax.lax.Precision.DEFAULT,
    "high": jax.lax.Precision.HIGH,
    "highest": jax.lax.Precision.HIGHEST,
}.get(_MODE, jax.lax.Precision.HIGHEST)  # 'bf16'/'int8' select op modes


def _live_mode() -> str:
    """Effective process-wide mode: a direct _MODE override (tests, sweep)
    wins; otherwise the env is consulted LIVE so GR4_FIR_PRECISION set
    after import still takes effect (the int8 method switch already reads
    the env per call — this makes bf16 consistent with it)."""
    if _MODE != _ENV_AT_IMPORT:
        return _MODE
    return os.environ.get("GR4_FIR_PRECISION", _MODE).lower()


def default_rung() -> str:
    """The precision rung the matmul lowerings use when a block asks for
    none: GR4_FIR_PRECISION, else 'highest'."""
    return _live_mode()


_PREC_MAP = {"default": jax.lax.Precision.DEFAULT,
             "high": jax.lax.Precision.HIGH,
             "highest": jax.lax.Precision.HIGHEST}


def bf16_einsum(sub: str, a, w, backend: str | None = None) -> jnp.ndarray:
    """``einsum`` with both operands rounded to bf16 and f32 accumulation.

    Accelerators take real bf16 operands. The CPU's dot thunks reject bf16
    operands, so there the same bf16-rounded products are emulated in f32."""
    a16 = jnp.asarray(a).astype(jnp.bfloat16)
    w16 = jnp.asarray(w).astype(jnp.bfloat16)
    if (backend or jax.default_backend()) == "cpu":
        return jnp.einsum(sub, a16.astype(jnp.float32),
                          w16.astype(jnp.float32),
                          precision=jax.lax.Precision.DEFAULT,
                          preferred_element_type=jnp.float32)
    return jnp.einsum(sub, a16, w16, preferred_element_type=jnp.float32)


def _banded_dot(a: jnp.ndarray, w: jnp.ndarray, mode: str | None = None
                ) -> jnp.ndarray:
    """[B, n, j] @ [j, i] → [B, n, i] f32 under the given precision mode
    (None → the process-wide GR4_FIR_PRECISION mode)."""
    if mode is None:
        mode = _live_mode()
    if mode == "bf16":
        return bf16_einsum("bnj,ji->bni", a, w)
    return jnp.einsum("bnj,ji->bni", a, w,
                      precision=_PREC_MAP.get(mode, _PRECISION),
                      preferred_element_type=jnp.float32)


def _as_cx(taps: jnp.ndarray) -> bool:
    return jnp.issubdtype(taps.dtype, jnp.complexfloating)


def fir_init_state(channels: int, ntaps: int, dtype) -> jnp.ndarray:
    """Zero prehistory of ``ntaps-1`` samples (≈ HistoryBuffer zero-init)."""
    shape = (ntaps - 1,) if channels == 0 else (channels, ntaps - 1)
    return jnp.zeros(shape, dtype)


def _conv_valid_real(x2: jnp.ndarray, taps: jnp.ndarray, stride: int) -> jnp.ndarray:
    """x2: [B, T'] real, taps: [K] real → [B, (T'-K)//stride+1] via conv HLO.

    FIR is y[n] = Σ_k taps[k]·x[n-k]; XLA conv computes correlation, so flip taps.
    """
    k = taps[::-1].reshape(1, 1, -1)          # [out_feat, in_feat, K]
    lhs = x2[:, None, :]                      # [batch, feat, T]
    y = jax.lax.conv_general_dilated(
        lhs, k.astype(x2.dtype), window_strides=(stride,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=jax.lax.Precision.HIGHEST)
    return y[:, 0, :]


def _conv_valid_complex(x2: jnp.ndarray, taps: jnp.ndarray, stride: int) -> jnp.ndarray:
    """Complex FIR as one real conv with 2 in/out feature planes (re, im)."""
    tr = jnp.real(taps)[::-1]
    ti = jnp.imag(taps)[::-1]
    real_dt = jnp.real(x2).dtype
    # kernel [out=2, in=2, K]: y_r = x_r*t_r - x_i*t_i ; y_i = x_r*t_i + x_i*t_r
    k = jnp.stack([jnp.stack([tr, -ti]), jnp.stack([ti, tr])]).astype(real_dt)
    lhs = jnp.stack([jnp.real(x2), jnp.imag(x2)], axis=1)   # [B, 2, T]
    y = jax.lax.conv_general_dilated(
        lhs, k, window_strides=(stride,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=jax.lax.Precision.HIGHEST)
    out = jax.lax.complex(y[:, 0, :], y[:, 1, :])
    return out.astype(x2.dtype) if jnp.issubdtype(
        x2.dtype, jnp.complexfloating) else out.astype(jnp.complex64)


def _frame_overlapping(xc: jnp.ndarray, step: int, width: int) -> jnp.ndarray:
    """[B, n·step + (width−step)] → overlapping frames [B, n, width] with NO gather:
    two reshape/slice ops. Requires overlap = width − step ≤ step."""
    b, t = xc.shape
    overlap = width - step
    n = (t - overlap) // step
    assert overlap <= step, (overlap, step)
    # pad one extra tile so A[1:] slicing below stays in range
    pad = (n + 1) * step - t
    a = jnp.pad(xc, ((0, 0), (0, pad))).reshape(b, n + 1, step)
    if overlap == 0:
        return a[:, :n, :]
    return jnp.concatenate([a[:, :-1, :], a[:, 1:, :overlap]], axis=2)


@lru_cache(maxsize=256)
def _toeplitz_np(taps_key, ntaps: int, tile: int, decim: int) -> np.ndarray:
    """Banded Toeplitz weights W[j, i]: frame[j] → output column i (decimated).

    frame[m, j] = xc[m·L + j]; y[m·L + i·decim] = Σ_k h[k]·xc[m·L + i·decim +
    (K−1) − k]  ⇒  W[j, i] = h[i·decim + K−1 − j] (0 ≤ · < K).
    """
    h = np.asarray(taps_key)
    k = ntaps
    n_out = tile // decim
    w = np.zeros((tile + k - 1, n_out), dtype=h.dtype)
    for i in range(n_out):
        j0 = i * decim
        w[j0: j0 + k, i] = h[::-1]
    return w


def _choose_tile(n: int, ntaps: int, decim: int) -> int:
    """Tile length: ≥ ntaps−1 (framing constraint), multiple of decim,
    matmul-friendly (~128–1024). The stream is zero-PADDED up to a tile multiple
    (never a single giant tile — a prime-ish n would otherwise materialize an
    O(n²) Toeplitz). GR4_FIR_TILE overrides the base (perf sweeps)."""
    import math
    base = int(os.environ.get("GR4_FIR_TILE", "0")) \
        or max(128, _next_pow2(ntaps - 1))
    base = max(base, _next_pow2(ntaps - 1))   # framing needs overlap ≤ step
    tile = base * decim // math.gcd(base, decim)
    return min(tile, max(_next_pow2(max(n, 1)), decim))


def _next_pow2(v: int) -> int:
    p = 1
    while p < v:
        p <<= 1
    return p


def _fir_matmul(xc: jnp.ndarray, taps_np: np.ndarray, decim: int,
                mode: str | None = None) -> jnp.ndarray:
    """Banded-matmul path with ZERO-COPY framing: two matmuls on two shifted
    views.

    The banded-Toeplitz product over overlapping frames splits exactly as

        y[m] = frames[m] @ W = A[m] @ W[:L] + A[m+1] @ W[L:]·(padded)

    where A = xc.reshape(n+1, L) — so the overlapping frames are never
    materialized (a concat would write a 1.5× copy of the stream to device
    memory, and this op is bandwidth-bound). Costs 2·L vs L+K−1 MAC
    columns — matrix-unit redundancy is cheaper than memory traffic.
    ``taps_np`` must be host NumPy — weights enter the trace as constants
    (never a device round-trip)."""
    b, tc = xc.shape
    k = taps_np.shape[-1]
    t = tc - (k - 1)
    tile = _choose_tile(t, k, decim)
    # pad so xc = [K-1 prehistory, t_pad stream] = (n+1)·tile exactly:
    # A[m] rows then cover frames m=0..n-1 with one lookahead row
    t_pad = -(-t // tile) * tile
    n = t_pad // tile
    total = (n + 1) * tile
    if total != tc:
        xc = jnp.pad(xc, ((0, 0), (0, total - tc)))
    n_out_true = t // decim
    cx_t = np.iscomplexobj(taps_np)
    cx_x = jnp.issubdtype(xc.dtype, jnp.complexfloating)
    real_dt = jnp.float32

    def mk_w(h: np.ndarray):
        # trace-time only (weights become jit constants); _toeplitz_np is
        # itself lru_cached on the taps
        w = _toeplitz_np(tuple(h.tolist()), k, tile, decim)  # [tile+k-1, n_out]
        w_hi = np.zeros_like(w[:tile])
        w_hi[: k - 1] = w[tile:]
        return jnp.asarray(w[:tile], real_dt), jnp.asarray(w_hi, real_dt)

    dot = lambda a, w: _banded_dot(a, w, mode)

    def banded(a_rows):             # [B, n+1, tile] → [B, n, n_out]
        return lambda lo, hi: dot(a_rows[:, :-1, :], lo) \
            + dot(a_rows[:, 1:, :], hi)

    if cx_x or cx_t:
        ar = jnp.real(xc).astype(real_dt).reshape(b, n + 1, tile)
        ai = (jnp.imag(xc).astype(real_dt).reshape(b, n + 1, tile)
              if cx_x else None)
        if cx_t:
            lo_r, hi_r = mk_w(taps_np.real)
            lo_i, hi_i = mk_w(taps_np.imag)
        else:
            lo_r, hi_r = mk_w(taps_np)
            lo_i = hi_i = None
        br, bi_ = banded(ar), (banded(ai) if ai is not None else None)
        if lo_i is None:
            yr = br(lo_r, hi_r)
            yi = bi_(lo_r, hi_r) if bi_ is not None else jnp.zeros_like(yr)
        else:
            yr = br(lo_r, hi_r) - (bi_(lo_i, hi_i) if bi_ is not None
                                   else jnp.zeros(()))
            yi = br(lo_i, hi_i) + (bi_(lo_r, hi_r) if bi_ is not None
                                   else jnp.zeros(()))
        y = jax.lax.complex(yr.astype(jnp.float32),
                            yi.astype(jnp.float32))   # no eager 1j constant
    else:
        a = xc.astype(real_dt).reshape(b, n + 1, tile)
        lo, hi = mk_w(taps_np)
        y = (dot(a[:, :-1, :], lo) + dot(a[:, 1:, :], hi)).astype(xc.dtype)
    return y.reshape(b, -1)[:, :n_out_true]


def _fir_matmul_int8(xc: jnp.ndarray, taps_np: np.ndarray, decim: int
                     ) -> jnp.ndarray:
    """Quantized path: int8×int8→int32 matmuls (twice the bf16 tensor rate).

    Weights use one global scale (taps are constants); frames are per-row
    dynamically quantized (max-abs → int8). SNDR ≈ 45–50 dB — opt-in via
    GR4_FIR_PRECISION=int8 for links whose budget allows it.
    """
    b, tc = xc.shape
    k = taps_np.shape[-1]
    t = tc - (k - 1)
    tile = _choose_tile(t, k, decim)
    t_pad = -(-t // tile) * tile
    if t_pad != t:
        xc = jnp.pad(xc, ((0, 0), (0, t_pad - t)))
    n_out_true = t // decim
    cx_t = np.iscomplexobj(taps_np)
    cx_x = jnp.issubdtype(xc.dtype, jnp.complexfloating)

    def quant_w(h: np.ndarray):
        w = _toeplitz_np(tuple(h.tolist()), k, tile, decim)
        s = float(np.max(np.abs(w))) / 127.0 or 1.0
        return jnp.asarray(np.round(w / s).astype(np.int8)), s

    def qdot(frames_f32, wq, w_scale):
        row_max = jnp.max(jnp.abs(frames_f32), axis=-1, keepdims=True)
        row_scale = jnp.maximum(row_max / 127.0, 1e-20)
        fq = jnp.round(frames_f32 / row_scale).astype(jnp.int8)
        acc = jnp.einsum("bnj,ji->bni", fq, wq,
                         preferred_element_type=jnp.int32)
        return acc.astype(jnp.float32) * (row_scale * jnp.float32(w_scale))

    rails = []
    if cx_x or cx_t:
        xr = jnp.real(xc).astype(jnp.float32)
        xi = jnp.imag(xc).astype(jnp.float32) if cx_x else jnp.zeros_like(xr)
        fr = _frame_overlapping_general(xr, tile, tile + k - 1)
        fi = _frame_overlapping_general(xi, tile, tile + k - 1)
        if cx_t:
            wr, sr = quant_w(taps_np.real)
            wi, si = quant_w(taps_np.imag)
            yr = qdot(fr, wr, sr) - qdot(fi, wi, si)
            yi = qdot(fr, wi, si) + qdot(fi, wr, sr)
        else:
            wr, sr = quant_w(taps_np)
            yr, yi = qdot(fr, wr, sr), qdot(fi, wr, sr)
        y = jax.lax.complex(yr.astype(jnp.float32),
                            yi.astype(jnp.float32))   # no eager 1j constant
    else:
        wr, sr = quant_w(taps_np)
        frames = _frame_overlapping_general(xc.astype(jnp.float32), tile,
                                            tile + k - 1)
        y = qdot(frames, wr, sr).astype(xc.dtype)
    return y.reshape(b, -1)[:, :n_out_true]


def _fir_fft(xc: jnp.ndarray, taps: jnp.ndarray, decim: int) -> jnp.ndarray:
    """FFT overlap-save: good for long taps. Frame step L, FFT size N = L + K − 1
    rounded to power of two; valid region = last L samples of each ifft."""
    b, tc = xc.shape
    k = taps.shape[-1]
    t = tc - (k - 1)
    nfft = 1 << int(np.ceil(np.log2(max(4 * k, 1024))))
    step = nfft - (k - 1)
    # pad stream so step divides t
    pad = (-t) % step
    xcp = jnp.pad(xc, ((0, 0), (0, pad)))
    frames = _frame_overlapping_general(xcp, step, nfft)
    cx = jnp.issubdtype(xc.dtype, jnp.complexfloating) or _as_cx(taps)
    h = jnp.fft.fft(taps.astype(jnp.complex64 if cx else jnp.float32), n=nfft)
    spec = jnp.fft.fft(frames, n=nfft, axis=-1) * h
    y = jnp.fft.ifft(spec, axis=-1)[..., k - 1:]
    y = y.reshape(b, -1)[:, : t]
    if not cx:
        y = jnp.real(y).astype(xc.dtype)
    else:
        y = y.astype(jnp.complex64)
    if decim > 1:
        y = y[:, ::decim]
    return y


def _frame_overlapping_general(xc: jnp.ndarray, step: int, width: int
                               ) -> jnp.ndarray:
    """Overlapping frames for arbitrary overlap (may exceed step): built from
    ceil(overlap/step)+1 shifted reshapes — still gather-free."""
    b, t = xc.shape
    overlap = width - step
    n = (t - overlap) // step
    if overlap <= step:
        return _frame_overlapping(xc, step, width)
    parts = []
    n_shift = int(np.ceil(width / step))
    pad = (n + n_shift) * step - t
    a = jnp.pad(xc, ((0, 0), (0, pad))).reshape(b, n + n_shift, step)
    for s in range(n_shift):
        need = min(step, width - s * step)
        if need <= 0:
            break
        parts.append(a[:, s: s + n, :need])
    return jnp.concatenate(parts, axis=2)


def auto_method(ntaps: int, *, decim: int = 1, host_taps: bool = True,
                backend: str | None = None) -> str:
    """The lowering ``method='auto'`` takes.

    The CPU keeps XLA's direct convolution: its conv thunk is fast there and
    the banded matmul would double the MACs. On a GPU (H100, 700 W, 8 Mi
    samples, float32-exact rungs): a 127-tap complex FIR took 0.41 ms as FFT
    overlap-save, 0.51 ms as the banded matmul and 5.2 ms as cuDNN's conv;
    a 63-tap real FIR with decimation 8 took 0.143 ms as the matmul, 0.146
    ms as conv and 0.34 ms as FFT (which filters at the full rate). So
    accelerators take FFT overlap-save without decimation and the banded
    matmul with it (or the int8 rung when GR4_FIR_PRECISION=int8). Taps
    too long for a dense band, or device-resident taps (the band is built on
    the host), take FFT overlap-save."""
    if (backend or jax.default_backend()) == "cpu":
        return "conv"
    if not host_taps or ntaps > 512:
        return "fft"
    if os.environ.get("GR4_FIR_PRECISION", "").lower() == "int8":
        return "matmul_int8"
    return "fft" if decim == 1 else "matmul"


def fir_apply(x: jnp.ndarray, taps: jnp.ndarray, state: jnp.ndarray,
              *, decim: int = 1, method: str = "auto",
              precision: str | None = None
              ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Overlap-save FIR step.

    ``x``: [T] or [C, T]; ``state``: prehistory [*, K-1]; returns
    ``(y, new_state)`` with ``y`` of length T//decim (on the decimated grid aligned
    to the first input sample) and new_state = last K-1 inputs.
    """
    ntaps = taps.shape[-1]
    # Host-side taps (NumPy) are strongly preferred: the matmul path builds its
    # Toeplitz weights on the host. A concrete device array would need a
    # device-to-host copy at trace time — route it to fft/conv.
    is_tracer = isinstance(taps, jax.core.Tracer)
    taps_np = None
    if not is_tracer and not isinstance(taps, jax.Array):
        taps_np = np.asarray(taps)
    squeeze = x.ndim == 1
    x2 = x[None, :] if squeeze else x
    st2 = state[None, :] if squeeze else state
    cx_stream = jnp.issubdtype(x2.dtype, jnp.complexfloating)
    cx = cx_stream or _as_cx(taps)
    # NOTE: a real stream with complex taps stays REAL here — every lowering
    # handles the mixed case with half the rail dots (a forced complex cast
    # would push a provably-zero imaginary rail through the matmuls)
    xc = jnp.concatenate([st2.astype(x2.dtype), x2], axis=-1)
    if method == "auto":
        if precision is not None and taps_np is not None and ntaps <= 512:
            # an explicit precision rung is a matmul-path request on every
            # backend (conv/fft have no pass-count ladder)
            method = "matmul_int8" if precision == "int8" else "matmul"
        elif precision is not None:
            # An explicit precision rung is UNSATISFIABLE here (the matmul
            # ladder needs host taps and ntaps<=512). A trace-time warning
            # vanishes inside compiled pipelines, so fail loudly instead —
            # users who want the fallback can say precision='auto' +
            # GR4_FIR_PRECISION.
            from ..core.errors import GrError
            raise GrError(
                f"fir_apply: precision={precision!r} requires the matmul "
                f"path (host taps, ntaps<=512; got ntaps={ntaps}, "
                f"host_taps={taps_np is not None}). Drop the explicit "
                f"precision setting (use 'auto') to run the default "
                f"fft/conv lowering at full precision.")
        else:
            method = auto_method(ntaps, decim=decim,
                                 host_taps=taps_np is not None)
    if method in ("matmul", "matmul_int8") and ntaps > 1:
        if taps_np is None:
            taps_np = np.asarray(taps)    # explicit opt-in only
        if precision == "int8" or method == "matmul_int8":
            y = _fir_matmul_int8(xc, taps_np, decim)
        else:
            y = _fir_matmul(xc, taps_np, decim, mode=precision)
    elif method == "fft" and ntaps > 1:
        y = _fir_fft(xc, taps, decim)
    else:
        if cx:
            y = _conv_valid_complex(xc, taps.astype(jnp.complex64), decim)
        else:
            y = _conv_valid_real(xc, taps.astype(x2.dtype), decim)
    new_state = xc[:, -(ntaps - 1):] if ntaps > 1 else xc[:, :0]
    if squeeze:
        return y[0], new_state[0]
    return y, new_state


@lru_cache(maxsize=128)
def _resample_toeplitz_np(taps_key, ntaps: int, interp: int, decim: int,
                          tile: int) -> np.ndarray:
    """Banded weights W[j, i] for rational L/M resampling as ONE matmul.

    frame[t][j] = xc[t·B + j] (xc = [K_p−1 prehistory, x]); output column
    i ∈ [0, B·L/M) of tile t is global output m = t·B·L/M + i, upsampled
    index u = m·M, phase p = u mod L = (i·M) mod L (tile-invariant), input
    n_local = (i·M)//L. Then y[m] = L·Σ_k h[k·L+p]·x[n−k] ⇒
    W[n_local + (K_p−1) − k, i] = L·h[k·L + p].

    This replaces the stack/reshape interleave of per-phase FIR outputs —
    a relayout with a tiny minor dimension; the matmul form keeps outputs
    contiguous.
    """
    h = np.asarray(taps_key)
    pad = (-len(h)) % interp
    hp = np.pad(h, (0, pad)).reshape(-1, interp)   # hp[k, p] = h[k·L + p]
    k_per_phase = hp.shape[0]
    n_out = tile * interp // decim
    w = np.zeros((tile + k_per_phase - 1, n_out), dtype=h.dtype)
    for i in range(n_out):
        p = (i * decim) % interp
        n_local = (i * decim) // interp
        for k in range(k_per_phase):
            w[n_local + (k_per_phase - 1) - k, i] = interp * hp[k, p]
    return w


def fir_resample_matmul(xc: jnp.ndarray, taps_np: np.ndarray, interp: int,
                        decim: int) -> jnp.ndarray:
    """Banded-matmul rational resampler: frames [B, n, tile+K_p−1] @ W → [B, n·tile·L/M].

    ``xc`` = [channels, (K_p−1) + T] with T divisible by ``decim``;
    ``taps_np`` host NumPy (weights built host-side, enter as constants)."""
    import math
    b, tc = xc.shape
    k_total = taps_np.shape[-1]
    k_per_phase = -(-k_total // interp)
    t = tc - (k_per_phase - 1)
    base = max(128, _next_pow2(k_per_phase - 1))
    tile = base * decim // math.gcd(base, decim)
    tile = min(tile, max(_next_pow2(max(t, 1)), decim))
    t_pad = -(-t // tile) * tile
    if t_pad != t:
        xc = jnp.pad(xc, ((0, 0), (0, t_pad - t)))
    n_out_true = t * interp // decim
    cx_t = np.iscomplexobj(taps_np)
    cx_x = jnp.issubdtype(xc.dtype, jnp.complexfloating)
    real_dt = jnp.float32
    mk = lambda arr: jnp.asarray(_resample_toeplitz_np(
        tuple(arr.tolist()), k_total, interp, decim, tile), real_dt)
    wr = mk(taps_np.real if cx_t else taps_np)
    wi = mk(taps_np.imag) if cx_t else None
    dot = _banded_dot
    frame_len = tile + k_per_phase - 1
    if cx_x or cx_t:
        xr = jnp.real(xc).astype(real_dt)
        xi = jnp.imag(xc).astype(real_dt) if cx_x else jnp.zeros_like(xr)
        fr = _frame_overlapping_general(xr, tile, frame_len)
        fi = _frame_overlapping_general(xi, tile, frame_len)
        if wi is None:
            yr, yi = dot(fr, wr), dot(fi, wr)
        else:
            yr = dot(fr, wr) - dot(fi, wi)
            yi = dot(fr, wi) + dot(fi, wr)
        y = jax.lax.complex(yr.astype(jnp.float32),
                            yi.astype(jnp.float32))   # no eager 1j constant
    else:
        frames = _frame_overlapping_general(xc, tile, frame_len)
        y = dot(frames.astype(real_dt), wr).astype(xc.dtype)
    return y.reshape(b, -1)[:, :n_out_true]


def fir_interpolate(x: jnp.ndarray, taps: jnp.ndarray, state: jnp.ndarray,
                    interp: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Polyphase interpolating FIR: T inputs → T·interp outputs.

    Decompose taps into ``interp`` phases; each phase filters the input stream, and
    outputs interleave. One conv call with ``interp`` output features, then a
    reshape-interleave — all static shapes.
    """
    # keep the polyphase decomposition on the HOST so each phase reaches
    # fir_apply as NumPy (the matmul path builds Toeplitz weights host-side)
    taps_h = np.asarray(taps)
    ntaps = taps_h.shape[-1]
    pad = (-ntaps) % interp
    tp = np.pad(taps_h, (0, pad))
    phases = tp.reshape(-1, interp).T          # [interp, K/interp] phase p taps
    k_per_phase = phases.shape[1]
    squeeze = x.ndim == 1
    x2 = x[None, :] if squeeze else x
    st2 = state[None, :] if squeeze else state
    # each phase is an ordinary FIR over the same input; route through fir_apply
    # so each backend gets its own lowering
    outs = []
    for p in range(phases.shape[0]):
        yp, _ = fir_apply(x2, phases[p], st2)
        outs.append(yp)
    y = jnp.stack(outs, axis=-1).reshape(x2.shape[0], -1) * interp
    xc = jnp.concatenate([st2.astype(x2.dtype), x2], axis=-1)
    new_state = xc[:, -(k_per_phase - 1):] if k_per_phase > 1 else xc[:, :0]
    if squeeze:
        return y[0], new_state[0]
    return y, new_state


def freq_xlating_taps(taps: np.ndarray, center_freq: float, sample_rate: float
                      ) -> np.ndarray:
    """Heterodyne low-pass taps up to ``center_freq`` (frequency-xlating FIR design)."""
    n = np.arange(len(taps), dtype=np.float64)
    rot = np.exp(1j * 2.0 * np.pi * center_freq / sample_rate * n)
    return (np.asarray(taps, dtype=np.float64) * rot).astype(np.complex64)
