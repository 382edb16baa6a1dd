"""SVD utilities + SVD-based denoising (≈ reference algorithm/filter/SvdFilter.hpp
Hankel-matrix denoiser and core SVD.hpp one-sided Jacobi).

Device-native: ``jnp.linalg.svd`` (XLA's batched SVD) on Hankel embeddings. The
Hankel matrix is built with the same gather-free overlapping-frame trick as the
FIR framing; rank truncation keeps the top-k singular values; the denoised signal
is recovered by anti-diagonal averaging.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def hankel(x: jnp.ndarray, window: int) -> jnp.ndarray:
    """[T] → Hankel [T - window + 1, window] via overlapping frames (stride 1)."""
    t = x.shape[-1]
    n = t - window + 1
    idx = jnp.arange(n)[:, None] + jnp.arange(window)[None, :]
    return x[idx]


def rank_mask(s: jnp.ndarray, *, max_rank: int | None = None,
              energy_fraction: float = 1.0, rel_threshold: float = 0.0,
              abs_threshold: float = 0.0) -> jnp.ndarray:
    """Effective-rank selection mask over descending singular values.

    Mirrors the reference's ``computeEffectiveRank`` rule
    (algorithm SvdFilter.hpp:42-64): keep σ_i while i < max_rank,
    σ_i/σ_0 ≥ rel_threshold, σ_i ≥ abs_threshold, and the cumulative energy
    *before* σ_i is below ``energy_fraction``·total (the crossing component is
    kept). Because σ descends, every break condition is a prefix property, so
    the sequential loop collapses to one elementwise mask — no control flow.
    Always keeps σ_0.
    """
    e = s * s
    cum_before = jnp.cumsum(e, axis=-1) - e
    cutoff = energy_fraction * jnp.sum(e, axis=-1, keepdims=True)
    idx = jnp.arange(s.shape[-1])
    keep = cum_before < cutoff
    if max_rank is not None:
        keep &= idx < max_rank
    if rel_threshold > 0.0:
        keep &= s >= rel_threshold * s[..., :1]
    if abs_threshold > 0.0:
        keep &= s >= abs_threshold
    return keep.at[..., 0].set(True)


def svd_denoise(x: jnp.ndarray, *, window: int = 32, rank: int = 4,
                method: str = "xla", energy_fraction: float = 1.0,
                rel_threshold: float = 0.0, abs_threshold: float = 0.0
                ) -> jnp.ndarray:
    """Truncated-SVD denoise of a 1-D signal via Hankel embedding.

    Keeps the largest singular components selected by :func:`rank_mask`
    (``rank`` cap ∧ ``energy_fraction`` ∧ σ thresholds — the reference's
    adaptive-rank rule, SvdFilter.hpp:42-64) and reconstructs by averaging
    anti-diagonals (the unbiased Hankel inverse). ``method='jacobi'`` uses the
    one-sided Jacobi kernel (:func:`jacobi_svd`) instead of XLA's QR-iteration
    SVD — static control flow end to end.
    """
    t = x.shape[-1]
    h = hankel(x, window)                                   # [N, W]
    u, s, vt = svd(h, method=method)
    keep = rank_mask(s, max_rank=rank, energy_fraction=energy_fraction,
                     rel_threshold=rel_threshold, abs_threshold=abs_threshold)
    s_trunc = jnp.where(keep, s, 0.0)
    h_hat = (u * s_trunc[None, :].astype(u.dtype)) @ vt
    # anti-diagonal averaging: y[k] = mean over {(i,j): i+j=k} of h_hat[i, j]
    n, w = h_hat.shape
    ii = jnp.arange(n)[:, None] + jnp.arange(w)[None, :]    # output index per cell
    flat = h_hat.reshape(-1)
    sums = jnp.zeros(t, h_hat.dtype).at[ii.reshape(-1)].add(flat)
    counts = jnp.zeros(t, jnp.float32).at[ii.reshape(-1)].add(1.0)
    return (sums / counts).astype(x.dtype)


def svd(a: jnp.ndarray, *, full_matrices: bool = False, method: str = "xla"):
    """SVD with selectable engine.

    ``method='xla'`` → ``jnp.linalg.svd`` (LAPACK-style QR iteration lowered by
    XLA — heavy data-dependent control flow on an accelerator). ``method='jacobi'`` →
    :func:`jacobi_svd`, the same algorithm family as the reference's own
    implementation (core SVD.hpp:1-10 one-sided Jacobi) in device-idiomatic form.
    """
    if method == "jacobi":
        if a.shape[-2] < a.shape[-1]:
            # jacobi needs m ≥ n; SVD the transpose and swap factors:
            # A = (Aᵀ)ᵀ = (U'SV'ᴴ)ᵀ ⇒ U = conj(V') = vtᵀ*, Vᴴ = U'ᵀ
            u2, s2, vt2 = jacobi_svd(jnp.swapaxes(a, -1, -2))
            return (jnp.swapaxes(vt2, -1, -2), s2,
                    jnp.swapaxes(u2, -1, -2))
        return jacobi_svd(a)
    return jnp.linalg.svd(a, full_matrices=full_matrices)


def _tournament_schedule(n: int) -> np.ndarray:
    """Round-robin pairings: [n-1 rounds, n/2 pairs, 2] column indices.

    Classic circle method: player 0 fixed, the rest rotate. Over n-1 rounds
    every unordered column pair meets exactly once — one full Jacobi sweep.
    Host-side numpy; the schedule is a compile-time constant in the kernel.
    """
    players = list(range(n))
    rounds = []
    for _ in range(n - 1):
        rounds.append([[players[i], players[n - 1 - i]]
                       for i in range(n // 2)])
        players = [players[0]] + [players[-1]] + players[1:-1]
    return np.asarray(rounds, np.int32)          # [n-1, n/2, 2]


def jacobi_svd(a: jnp.ndarray, *, sweeps: int = 12, eps: float = 1e-12):
    """One-sided Jacobi SVD (≈ reference core SVD.hpp one-sided Jacobi, built
    device-first instead of ported).

    The reference iterates column pairs serially with convergence checks; on
    an accelerator that is all the things XLA hates (data-dependent trip counts, scalar
    column walks). Idiomatic inversion: a FIXED number of sweeps under
    ``lax.fori_loop``; within each round of a sweep, the round-robin
    tournament schedule gives n/2 DISJOINT column pairs, so all rotations of
    the round apply as one batched [m, n/2, 2] einsum (static gathers from a
    host-precomputed schedule, no control flow). Converged pairs rotate by
    identity via ``jnp.where`` instead of branching.

    Returns ``(u [m,n], s [n], vt [n,n])`` with s descending, for m ≥ n
    (leading batch dims allowed; 12 sweeps ≈ float32 machine precision for
    n ≤ 256 — Jacobi converges quadratically). Complex input is supported:
    the column pair rotation becomes the unitary Givens
    ``[[c, s·φ], [-s·conj(φ), c]]`` with ``φ = γ/|γ|`` the phase of the
    complex column inner product, and ``vt`` is the conjugate transpose.
    """
    orig_n = a.shape[-1]
    if a.shape[-2] < orig_n:
        raise ValueError("jacobi_svd needs m >= n; transpose the input")
    cplx = jnp.issubdtype(a.dtype, jnp.complexfloating)
    if orig_n % 2:                       # schedule needs an even player count
        a = jnp.concatenate([a, jnp.zeros_like(a[..., :1])], axis=-1)
    n = a.shape[-1]
    sched = jnp.asarray(_tournament_schedule(n))        # [R, n/2, 2]
    v0 = jnp.broadcast_to(jnp.eye(n, dtype=a.dtype),
                          (*a.shape[:-2], n, n))

    def round_step(r, carry):
        aa, vv = carry
        pq = sched[r]                                   # [n/2, 2] static round
        p, q = pq[:, 0], pq[:, 1]
        ap, aq = aa[..., :, p], aa[..., :, q]           # [..., m, n/2]
        alpha = jnp.sum(jnp.abs(ap) ** 2, axis=-2) if cplx \
            else jnp.sum(ap * ap, axis=-2)
        beta = jnp.sum(jnp.abs(aq) ** 2, axis=-2) if cplx \
            else jnp.sum(aq * aq, axis=-2)
        gamma = jnp.sum(jnp.conj(ap) * aq, axis=-2)     # [..., n/2]
        g = jnp.abs(gamma)
        # Rutishauser rotation solving  [[alpha,|γ|],[|γ|,beta]]; a complex
        # γ first rotates column q by conj(φ) to make the pair product real.
        if cplx:
            phi = gamma / jnp.where(g == 0.0, 1.0, g)   # unit phase of γ
            gr = g
        else:
            phi = None
            gr = gamma
        zeta = (beta - alpha) / (2.0 * jnp.where(gr == 0.0, 1.0, gr))
        # sign(0)=0 would freeze equal-norm pairs (α=β ⇒ 45° rotation, t=1)
        sgn = jnp.where(zeta == 0.0, 1.0, jnp.sign(zeta))
        t = sgn / (jnp.abs(zeta) + jnp.sqrt(1.0 + zeta * zeta))
        live = g > eps * jnp.sqrt(alpha * beta)
        t = jnp.where(live, t, 0.0)                     # identity when converged
        c = 1.0 / jnp.sqrt(1.0 + t * t)
        s = c * t
        c_ = c[..., None, :].astype(aa.dtype)
        if cplx:
            s_p = (s * jnp.conj(phi))[..., None, :]     # applies to column q
            s_q = (s * phi)[..., None, :]               # applies to column p
        else:
            s_p = s_q = s[..., None, :]
        new_p, new_q = c_ * ap - s_p * aq, s_q * ap + c_ * aq
        aa = aa.at[..., :, p].set(new_p).at[..., :, q].set(new_q)
        vp, vq = vv[..., :, p], vv[..., :, q]
        vv = vv.at[..., :, p].set(c_ * vp - s_p * vq) \
               .at[..., :, q].set(s_q * vp + c_ * vq)
        return aa, vv

    def sweep(_, carry):
        return jax.lax.fori_loop(0, n - 1, round_step, carry)

    aa, vv = jax.lax.fori_loop(0, sweeps, sweep, (a, v0))
    s = jnp.sqrt(jnp.sum(jnp.abs(aa) ** 2, axis=-2)) if cplx \
        else jnp.sqrt(jnp.sum(aa * aa, axis=-2))        # column norms
    order = jnp.argsort(-s, axis=-1)
    s = jnp.take_along_axis(s, order, axis=-1)
    aa = jnp.take_along_axis(aa, order[..., None, :], axis=-1)
    vv = jnp.take_along_axis(vv, order[..., None, :], axis=-1)
    u = aa / jnp.where(s[..., None, :] == 0.0, 1.0,
                       s[..., None, :]).astype(aa.dtype)
    if orig_n != n:                                     # drop the pad column
        u, s = u[..., :, :orig_n], s[..., :orig_n]
        vv = vv[..., :orig_n, :orig_n]
    vt = jnp.swapaxes(jnp.conj(vv) if cplx else vv, -1, -2)
    return u, s, vt


def low_rank_approx(a: jnp.ndarray, rank: int) -> jnp.ndarray:
    u, s, vt = jnp.linalg.svd(a, full_matrices=False)
    return (u[..., :, :rank] * s[..., None, :rank]) @ vt[..., :rank, :]
