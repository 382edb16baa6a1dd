"""Polyphase filter-bank (PFB) channelizer / synthesizer.

The reference has no channelizer block (GR "mainline" does); BASELINE configs 4–5
require a 64/256-channel PFB — this is the flagship multi-chip kernel.

Device-native design (critically sampled M-channel analysis bank):

    X[n, p] = x[nM + p]                                  (corner turn, reshape)
    v[n, p] = Σ_j h[jM + p] · X[n−j, p]                  (M parallel branch FIRs —
                                                          ONE conv with M features)
    y[n, m] = M · IFFT_p(v[n, ·])[m]                     (batched FFT HLO)

Channel m is centered at m·fs/M, output rate fs/M. The branch convs vectorize as a
grouped conv (feature dim = M) which XLA lowers onto the matrix units; the FFT across the
branch axis is a batched XLA FFT. Multi-chip: shard the branch/channel axis and
`all_to_all` the corner turn (parallel/channelizer sharding).

Weighted overlap-add synthesis bank inverts it (channel → wideband).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from . import filter_design as fd


def design_pfb_taps(n_channels: int, taps_per_phase: int = 8, *,
                    beta: float = 9.6, rolloff: float = 1.0) -> np.ndarray:
    """Prototype low-pass for an M-channel PFB: cutoff fs/(2M), length M·P."""
    m = n_channels
    ntaps = m * taps_per_phase
    if ntaps % 2 == 0:
        ntaps += 1
    h = fd.design_fir("lowpass", ntaps, sample_rate=float(m),
                      f_low=0.5 * rolloff, window="Kaiser", beta=beta)
    return np.pad(h, (0, m * taps_per_phase + m - len(h)))[: m * taps_per_phase]


def branch_fir_macs(xc: jnp.ndarray, hp: jnp.ndarray, r: int) -> jnp.ndarray:
    """Per-branch FIR via shift-multiply-accumulate.

    xc: [..., P−1+R, M] rows-with-history; hp: [P, M] branch taps → [..., R, M].
    P small (taps/phase): P fused elementwise FMAs elementwise — no conv HLO.
    """
    p = hp.shape[0]
    real_h = hp.astype(jnp.real(xc).dtype if jnp.issubdtype(
        xc.dtype, jnp.complexfloating) else xc.dtype)
    acc = None
    for j in range(p):
        seg = xc[..., (p - 1 - j): (p - 1 - j) + r, :]
        term = seg * real_h[j]
        acc = term if acc is None else acc + term
    return acc


def pfb_init_state(n_channels: int, taps_per_phase: int, dtype=jnp.complex64
                   ) -> jnp.ndarray:
    """Branch FIR history: [taps_per_phase-1, M] previous corner-turn rows."""
    return jnp.zeros((taps_per_phase - 1, n_channels), dtype)


def pfb_analyze(x: jnp.ndarray, taps: jnp.ndarray, state: jnp.ndarray
                ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Analysis channelizer step.

    x: [T] complex with T % M == 0; taps: [M·P] prototype; state: [P-1, M].
    Returns (channels [M, T//M], new_state).
    """
    m = state.shape[-1]
    p = state.shape[0] + 1
    rows = x.reshape(-1, m)                           # [T/M, M] corner turn
    r = rows.shape[0]
    xc = jnp.concatenate([state.astype(rows.dtype), rows], axis=0)  # [P-1+T/M, M]
    hp = np.asarray(taps).reshape(p, m)    # h[j·M + p] → [P, M] (host constant)
    # branch FIR as P shift-MAC slices (P is small, XLA fuses into one pass;
    # no conv HLO):
    #   v[n, p] = Σ_j hp[j, p] · xc[n + (P−1) − j, p]
    v = branch_fir_macs(xc, hp, r)
    # channel m (centered at +m·fs/M) picks the e^{-j2πpm/M} combination → FFT.
    # branch gain ≈ 1/M (prototype sums to 1) × FFT sum M → unity channel gain.
    y = jnp.fft.fft(v, axis=-1)
    new_state = xc[-(p - 1):] if p > 1 else xc[:0]
    return jnp.moveaxis(y, 0, 1).astype(jnp.complex64), new_state


def pfb_synthesize(channels: jnp.ndarray, taps: jnp.ndarray, state: jnp.ndarray
                   ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Synthesis bank (inverse): channels [M, N] → wideband [N·M].

    FFT across channels, branch-filter each phase, interleave. State: [P-1, M].
    """
    m, n = channels.shape
    p = state.shape[0] + 1
    # inverse of the analysis FFT: IFFT·M recovers the branch signals
    rows = jnp.fft.ifft(jnp.moveaxis(channels, 0, 1), axis=-1) * m   # [N, M]
    xc = jnp.concatenate([state.astype(rows.dtype), rows], axis=0)
    hp = np.asarray(taps).reshape(p, m) * m
    v = branch_fir_macs(xc, hp, n)                              # [N, M]
    new_state = xc[-(p - 1):] if p > 1 else xc[:0]
    return v.reshape(-1).astype(jnp.complex64), new_state


def channel_center_freqs(n_channels: int, sample_rate: float) -> np.ndarray:
    """Center frequency of each channel (FFT bin convention, wraps at fs/2)."""
    return np.fft.fftfreq(n_channels, d=1.0 / sample_rate)
