"""FFT / spectrum kernels.

Reference: in-house radix FFT + SIMD split-radix (algorithm/fourier/fft.hpp:91,
SimdFFT.hpp) and the FFT block producing DataSet spectra (blocks/fourier/fft.hpp:33).

Design: XLA's native FFT HLO (``jnp.fft``, cuFFT on a GPU) — hand-rolling radix
kernels would fight the compiler. We provide windowed
chunked transforms over ``[..., n_chunks, fft_size]`` with static shapes, plus the
spectrum post-processing (magnitude, dB, shift, phase) the reference FFT block emits.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from .windows import enbw, make_window


def chunked_fft(x: jnp.ndarray, fft_size: int, *, window: jnp.ndarray | None = None
                ) -> jnp.ndarray:
    """Reshape the trailing time axis into ``[-1, fft_size]`` chunks, window, FFT.

    x: [..., T] with T % fft_size == 0 → complex spectra [..., T//fft_size, fft_size].
    """
    lead = x.shape[:-1]
    xr = x.reshape(*lead, -1, fft_size)
    if window is not None:
        xr = xr * window.astype(jnp.real(xr).dtype)
    return jnp.fft.fft(xr, axis=-1)


def magnitude(spectrum: jnp.ndarray) -> jnp.ndarray:
    return jnp.abs(spectrum)


def magnitude_db(spectrum: jnp.ndarray, *, floor: float = 1e-20) -> jnp.ndarray:
    p = jnp.real(spectrum) ** 2 + jnp.imag(spectrum) ** 2
    return 10.0 * jnp.log10(jnp.maximum(p, floor))


def phase(spectrum: jnp.ndarray, *, unwrap: bool = False) -> jnp.ndarray:
    ph = jnp.angle(spectrum)
    if unwrap:
        d = jnp.diff(ph, axis=-1)
        d = jnp.mod(d + jnp.pi, 2 * jnp.pi) - jnp.pi
        ph = jnp.concatenate([ph[..., :1], ph[..., :1] + jnp.cumsum(d, axis=-1)],
                             axis=-1)
    return ph


def fftshift(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.fft.fftshift(x, axes=-1)


def freq_axis(fft_size: int, sample_rate: float, *, shifted: bool = False,
              one_sided: bool = False) -> np.ndarray:
    f = np.fft.fftfreq(fft_size, d=1.0 / sample_rate)
    if one_sided:
        return f[: fft_size // 2 + 1].copy()
    if shifted:
        return np.fft.fftshift(f)
    return f


def spectrum_scale(fft_size: int, window: np.ndarray | None, *, power: bool,
                   density: bool, sample_rate: float) -> float:
    """Scale factor for calibrated amplitude/power spectra (coherent/noise gain)."""
    if window is None:
        cg = 1.0
        nbw = 1.0
    else:
        w = np.asarray(window, dtype=np.float64)
        cg = float(np.mean(w))
        nbw = enbw(w)
    if power and density:
        return 1.0 / (fft_size * cg * np.sqrt(nbw * sample_rate))
    return 1.0 / (fft_size * cg)


# ---------------------------------------------------------------------------
# Matmul FFT — a four-step Cooley-Tukey alternative to the FFT HLO that runs
# on the matrix units. N = N1·N2 splits
# the transform into two dense [N1,N1]/[N2,N2] matmul stages plus an
# elementwise twiddle:
#
#   X[k1 + N1·k2] = Σ_{n2} W_N^{n2·k1} W_{N2}^{n2·k2} (Σ_{n1} x[n1,n2] W_{N1}^{n1·k1})
#
# (x reshaped [n1, n2] row-major). Precision modes mirror ops/fir.py:
# 'highest' = exact f32, 'high' = the backend's HIGH dot precision,
# 'bf16' = bf16 operands (~45 dB per stage — monitoring-grade, opt-in).
# ---------------------------------------------------------------------------


@lru_cache(maxsize=32)
def _fft_mats(fft_size: int, n1: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(F1[n1,k1], TW[k1,n2], F2[n2,k2]) as float64 complex — jit constants."""
    n2 = fft_size // n1
    i1 = np.arange(n1)
    i2 = np.arange(n2)
    f1 = np.exp(-2j * np.pi * np.outer(i1, i1) / n1)
    f2 = np.exp(-2j * np.pi * np.outer(i2, i2) / n2)
    tw = np.exp(-2j * np.pi * np.outer(i1, i2) / fft_size)
    return f1, tw, f2


def _cx_dot(ar, ai, w: np.ndarray, sub: str, mode: str):
    """Rail-decomposed complex matmul: (ar+j·ai) @ (wr+j·wi) → (zr, zi).

    ``sub`` is the einsum subscript; ``w`` enters as host-NumPy constants.
    Real input (ai=None) skips the dead rail (2 dots instead of 4)."""
    wr = np.ascontiguousarray(w.real.astype(np.float32))
    wi = np.ascontiguousarray(w.imag.astype(np.float32))
    if mode == "bf16":
        from .fir import bf16_einsum
        dot = lambda a, m: bf16_einsum(sub, a, m)
    else:
        prec = jax.lax.Precision.HIGHEST if mode == "highest" \
            else jax.lax.Precision.HIGH
        dot = lambda a, m: jnp.einsum(sub, a, jnp.asarray(m), precision=prec,
                                      preferred_element_type=jnp.float32)
    if ai is None:
        return dot(ar, wr), dot(ar, wi)
    return (dot(ar, wr) - dot(ai, wi)), (dot(ar, wi) + dot(ai, wr))


def matmul_fft(x: jnp.ndarray, fft_size: int, *, n1: int | None = None,
               mode: str = "high") -> jnp.ndarray:
    """FFT over the trailing axis via two matmul stages.

    x: [..., fft_size] (real or complex) → complex64 [..., fft_size].
    ``n1`` picks the split (default 64 for 4096-class sizes); ``mode`` is the
    precision rung ('highest' | 'high' | 'bf16')."""
    if n1 is None:
        n1 = 1 << ((fft_size.bit_length() - 1) // 2)   # ~sqrt, power of two
    n2 = fft_size // n1
    assert n1 * n2 == fft_size, (fft_size, n1)
    lead = x.shape[:-1]
    cx = jnp.issubdtype(x.dtype, jnp.complexfloating)
    a = x.reshape(*lead, n1, n2)
    ar = jnp.real(a).astype(jnp.float32)
    ai = jnp.imag(a).astype(jnp.float32) if cx else None
    f1, tw, f2 = _fft_mats(fft_size, n1)
    # stage 1: contract n1 → Y[..., k1, n2]
    yr, yi = _cx_dot(ar, ai, f1, "...ns,nk->...ks", mode)
    # twiddle (elementwise, f32 constants — fuses into the next matmul's read)
    twr = jnp.asarray(tw.real.astype(np.float32))
    twi = jnp.asarray(tw.imag.astype(np.float32))
    zr = yr * twr - yi * twi
    zi = yr * twi + yi * twr
    # stage 2: contract n2 → Z[..., k1, k2]
    zr, zi = _cx_dot(zr, zi, f2, "...ks,st->...kt", mode)
    # output index k = k1 + N1·k2 → lay out k2-major then flatten
    zr = jnp.swapaxes(zr, -1, -2).reshape(*lead, fft_size)
    zi = jnp.swapaxes(zi, -1, -2).reshape(*lead, fft_size)
    return jax.lax.complex(zr, zi)
