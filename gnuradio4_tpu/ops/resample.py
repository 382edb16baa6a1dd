"""Rational polyphase resampling (≈ reference Decimator/interpolation capabilities;
GR4 expresses rate change via Resampling<in,out> chunk policy, Block.hpp:1611 — the
actual polyphase math is what this module provides).

Up-by-L runs as a single conv with L output feature planes (fir.fir_interpolate —
no zero-stuffing waste) or as one banded matmul (fir.fir_resample_matmul);
down-by-M fuses into the conv stride when
L == 1, else strided-slices the interpolated stream. State carries the FIR history
(overlap-save), so streaming across block boundaries is exact.
"""

from __future__ import annotations

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np

from . import filter_design as fd
from .fir import (fir_apply, fir_init_state, fir_interpolate,
                  fir_resample_matmul)


def design_resampler_taps(interp: int, decim: int, *, ntaps_per_phase: int = 16,
                          beta: float = 8.6, rolloff: float = 0.8) -> np.ndarray:
    """Kaiser low-pass at min(fs/2L, fs/2M) on the upsampled grid."""
    L, M = interp, decim
    ntaps = ntaps_per_phase * max(L, 1)
    if ntaps % 2 == 0:
        ntaps += 1
    fs_up = float(L)
    fc = 0.5 * rolloff / max(L, M)  # cycles/sample on the upsampled grid
    return fd.design_fir("lowpass", ntaps, sample_rate=fs_up, f_low=fc * fs_up,
                         window="Kaiser", beta=beta)


def auto_resample_method(t: int, decim: int, backend: str | None = None
                         ) -> str:
    """The lowering ``RationalResamplerKernel.apply(method='auto')`` takes.

    The CPU keeps the per-phase interleave: its convs are cheap there, and
    the dense band would multiply the MACs. Accelerators take the one-matmul
    form whenever the block frames (``t % decim == 0``): the interleave
    stacks per-phase outputs along a tiny minor dimension, a relayout."""
    if (backend or jax.default_backend()) == "cpu" or t % decim:
        return "interleave"
    return "matmul"


class RationalResamplerKernel:
    """Stateless helper bundling taps + shapes for an L/M polyphase resampler."""

    def __init__(self, interp: int, decim: int, taps: np.ndarray | None = None,
                 ntaps_per_phase: int = 16):
        frac = Fraction(interp, decim)
        self.interp = frac.numerator
        self.decim = frac.denominator
        if taps is None:
            taps = design_resampler_taps(self.interp, self.decim,
                                         ntaps_per_phase=ntaps_per_phase)
        self.taps = np.asarray(taps)
        self.k_per_phase = -(-len(self.taps) // max(self.interp, 1))

    @property
    def ratio(self) -> Fraction:
        return Fraction(self.interp, self.decim)

    def init_state(self, channels: int, dtype) -> jnp.ndarray:
        ntaps_eff = self.k_per_phase if self.interp > 1 else len(self.taps)
        return fir_init_state(channels, ntaps_eff, dtype)

    def apply(self, x: jnp.ndarray, state: jnp.ndarray, *,
              method: str = "auto") -> tuple[jnp.ndarray, jnp.ndarray]:
        L, M = self.interp, self.decim
        cx = jnp.issubdtype(x.dtype, jnp.complexfloating)
        taps = self.taps.astype(np.complex64 if cx else np.float32)
        if L == 1:
            return fir_apply(x, taps, state, decim=M)
        squeeze = x.ndim == 1
        x2 = x[None, :] if squeeze else x
        t = x2.shape[-1]
        if method == "auto":
            method = auto_resample_method(t, M)
        if method == "matmul" and t % M == 0:
            st2 = state[None, :] if squeeze else state
            xc = jnp.concatenate([st2.astype(x2.dtype), x2], axis=-1)
            y = fir_resample_matmul(xc, taps, L, M)
            kp = self.k_per_phase
            new_state = xc[:, -(kp - 1):] if kp > 1 else xc[:, :0]
            if squeeze:
                return y[0], new_state[0]
            return y, new_state
        y_up, new_state = fir_interpolate(x, taps, state, L)
        if M > 1:
            y_up = y_up[..., ::M]
        return y_up, new_state
