"""IIR filtering kernels.

Reference: direct-form I/II per-sample IIR (blocks/filter time_domain_filter.hpp:64).

Design: the recursion y[n] = f(y[n-1], …) is inherently sequential — the
accelerator-friendly strategies, in order of preference:

1. **Channel parallelism**: ``lax.scan`` over time carrying per-channel state vectors;
   all channels advance in lock-step elementwise (the main axis for wide streams).
2. **Parallel linear recurrence** (first-order sections): y[n] = c·y[n-1] + v[n] is an
   associative operation on pairs (c, v), so ``lax.associative_scan`` evaluates it in
   O(log T) depth — used for biquads decomposed into complex one-pole sections
   (:func:`one_pole_apply` / :func:`biquad_parallel_apply`).

State layout (transposed direct-form II): ``s[..., i]``, i ∈ [0, order).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _normalize_ba(b: np.ndarray, a: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    b = b / a[0]
    a = a / a[0]
    order = max(len(b), len(a)) - 1
    b = np.pad(b, (0, order + 1 - len(b)))
    a = np.pad(a, (0, order + 1 - len(a)))
    return b, a, order


def iir_init_state(channels: int, nb: int, na: int) -> jnp.ndarray:
    order = max(nb, na) - 1
    shape = (order,) if channels == 0 else (channels, order)
    return jnp.zeros(shape, jnp.float32)


def iir_apply(x: jnp.ndarray, b: np.ndarray, a: np.ndarray, state: jnp.ndarray
              ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Transposed DF-II scan. x: [T] or [C, T]; state: [..., order]."""
    b, a, order = _normalize_ba(b, a)
    if order == 0:
        return x * jnp.asarray(b[0], x.dtype), state
    bj = jnp.asarray(b, x.dtype)
    aj = jnp.asarray(a, x.dtype)
    xT = jnp.moveaxis(x, -1, 0)  # [T, ...]

    def step(s, xn):
        yn = bj[0] * xn + s[..., 0]
        # s_i ← b_{i+1}·x − a_{i+1}·y + s_{i+1}
        s_shift = jnp.concatenate(
            [s[..., 1:], jnp.zeros_like(s[..., :1])], axis=-1)
        new_s = (bj[1:] * xn[..., None] - aj[1:] * yn[..., None] + s_shift)
        return new_s, yn

    new_state, yT = jax.lax.scan(step, state.astype(x.dtype), xT)
    return jnp.moveaxis(yT, 0, -1), new_state


def one_pole_apply(x: jnp.ndarray, pole: complex | jnp.ndarray,
                   y_prev: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Parallel first-order recurrence y[n] = pole·y[n-1] + x[n].

    Host-constant poles on long streams take the BLOCKED two-level path
    (:func:`_one_pole_blocked`): an O(log T)-depth associative scan costs
    log₂T full-stream HBM passes (~1.5 GB for 8 Mi f32 — the dominant cost
    of FM de-emphasis in the WBFM chain), while the blocked form is one
    [L,L] Toeplitz matmul (matrix units), a scan over T/L block carries (KB-sized),
    and one fused correction pass: ~4 stream passes total. Traced poles
    (dynamic settings) keep the associative scan.

    x: [..., T]; y_prev: [...] (y[-1]); returns (y, y[T-1]).
    """
    host_pole = None
    if isinstance(pole, (int, float, np.floating)):
        host_pole = complex(float(pole), 0.0)
    elif isinstance(pole, (complex, np.complexfloating)):
        host_pole = complex(pole)
    t = x.shape[-1]
    import os
    if host_pole is not None and abs(host_pole) <= 1.0 and t >= 4096 \
            and t % _BLK == 0 \
            and os.environ.get("GR4_NO_BLOCKED_ONEPOLE") != "1":
        # GR4_NO_BLOCKED_ONEPOLE=1: A/B escape to the associative scan
        # (the round-3 lowering) for within-window comparisons
        return _one_pole_blocked(x, host_pole, y_prev)
    pole = jnp.asarray(pole, x.dtype)
    c = jnp.broadcast_to(pole, x.shape)
    v = x.at[..., 0].add(pole * y_prev)

    cs, ys = _one_pole_scan(c, v)
    return ys, ys[..., -1]


_BLK = 128   # in-block Toeplitz size (matmul contraction width)


def _one_pole_blocked(x: jnp.ndarray, pole: complex, y_prev: jnp.ndarray
                      ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Two-level linear recurrence (host-constant pole, T % 128 == 0).

    y_loc = in-block zero-init responses via a lower-triangular Toeplitz
    matmul W[j,i] = p^{i−j}; block carries chain through a KB-sized
    associative scan; the entering state folds back in one elementwise
    correction pass (y[b,i] = y_loc[b,i] + p^{i+1}·ent_b). Exact algebra —
    only f32/c64 rounding differs from the sequential scan."""
    L = _BLK
    t = x.shape[-1]
    nb = t // L
    cx = jnp.issubdtype(x.dtype, jnp.complexfloating) or pole.imag != 0.0
    idx = np.arange(L)
    d = idx[None, :] - idx[:, None]          # i − j
    with np.errstate(over="ignore", under="ignore", invalid="ignore"):
        w = np.where(d >= 0, np.asarray(pole, np.complex128) ** np.maximum(d, 0),
                     0.0)
        pv = np.asarray(pole, np.complex128) ** (idx + 1)       # p^{i+1}
        cl = complex(np.asarray(pole, np.complex128) ** L)       # p^L
    dt = jnp.complex64 if cx else x.dtype
    if cx:
        w_dev = jnp.asarray(w, jnp.complex64)
        pv_dev = jnp.asarray(pv, jnp.complex64)
    else:
        w_dev = jnp.asarray(w.real.astype(np.float32))
        pv_dev = jnp.asarray(pv.real.astype(np.float32))
    xb = x.astype(dt).reshape(*x.shape[:-1], nb, L)
    y_loc = jnp.einsum("...bj,ji->...bi", xb, w_dev,
                       precision=jax.lax.Precision.HIGHEST)
    e = y_loc[..., :, L - 1]                 # end-of-block local responses
    if cx:
        cl_dev = jax.lax.complex(jnp.float32(cl.real), jnp.float32(cl.imag))
    else:
        cl_dev = jnp.asarray(cl.real, dt)
    v = e.at[..., 0].add(cl_dev * y_prev.astype(dt))
    _, s = _one_pole_scan(jnp.broadcast_to(cl_dev, v.shape), v)  # KB-sized
    ent = jnp.concatenate([y_prev.astype(dt)[..., None], s[..., :-1]], axis=-1)
    y = y_loc + ent[..., :, None] * pv_dev
    return y.reshape(x.shape).astype(dt), s[..., -1]


def _one_pole_combine(l, r):
    cl, vl = l
    cr, vr = r
    return cl * cr, cr * vl + vr


@jax.jit
def _one_pole_scan(c, v):
    return jax.lax.associative_scan(_one_pole_combine, (c, v), axis=-1)


def sos_init_state(channels: int, n_sections: int) -> jnp.ndarray:
    shape = (n_sections, 2) if channels == 0 else (channels, n_sections, 2)
    return jnp.zeros(shape, jnp.float32)


def sos_apply(x: jnp.ndarray, sos: np.ndarray, state: jnp.ndarray
              ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Cascaded-biquad IIR (scan). sos: [S, 6]; state: [..., S, 2] transposed-DF2."""
    sos = np.atleast_2d(np.asarray(sos, dtype=np.float64))
    S = sos.shape[0]
    bj = jnp.asarray(sos[:, :3] / sos[:, 3:4], x.dtype)   # [S, 3], a0-normalized
    aj = jnp.asarray(sos[:, 3:] / sos[:, 3:4], x.dtype)
    xT = jnp.moveaxis(x, -1, 0)

    def step(s, xn):
        new_s = []
        v = xn
        for k in range(S):
            sk = s[..., k, :]
            y = bj[k, 0] * v + sk[..., 0]
            s0 = bj[k, 1] * v - aj[k, 1] * y + sk[..., 1]
            s1 = bj[k, 2] * v - aj[k, 2] * y
            new_s.append(jnp.stack([s0, s1], axis=-1))
            v = y
        return jnp.stack(new_s, axis=-2), v

    new_state, yT = jax.lax.scan(step, state.astype(x.dtype), xT)
    return jnp.moveaxis(yT, 0, -1), new_state


def one_pole_ba_apply(x: jnp.ndarray, b: np.ndarray, a: np.ndarray,
                      u_prev: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """First-order section y = b0·x + b1·x⁻¹ − a1·y⁻¹ in O(log T):
    H(w) = K + A/(1 − p·w) with p = −a1, K = b1/a1, A = b0 − b1/a1.
    State: the one-pole carry u[-1] (real)."""
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    b = b / a[0]; a = a / a[0]
    b0 = float(b[0]); b1 = float(b[1]) if len(b) > 1 else 0.0
    a1 = float(a[1]) if len(a) > 1 else 0.0
    if a1 == 0.0:
        y = b0 * x + b1 * jnp.concatenate(
            [u_prev[..., None].astype(x.dtype), x[..., :-1]], axis=-1)
        return y.astype(x.dtype), x[..., -1]
    p = -a1
    K = b1 / a1
    A = b0 - b1 / a1
    u, last = one_pole_apply(x.astype(jnp.float32), p,
                             u_prev.astype(jnp.float32))
    y = jnp.float32(K) * x + jnp.float32(A) * u
    return y.astype(x.dtype), last


# Partial fractions carry an A ∝ 1/(p1−p2) amplitude: as the poles cluster the
# two rails cancel catastrophically in f32 (measured ~68 dB SNR loss at
# separation 2e-5 vs the sequential scan). Require |disc| ≥ EPS_REL·scale with
# scale = max(a1², 4|a2|) — i.e. RELATIVE pole separation ≳ 1e-3 — on BOTH the
# real branch (p1−p2 = √disc) and the conjugate branch (p−p̄ = i√−disc);
# anything closer takes the sequential scan. (round-4 advisor finding)
_POLE_SEP_EPS_REL = 1e-6


def _disc_scale(a1: float, a2: float) -> float:
    return max(a1 * a1, 4.0 * abs(a2), 1e-300)


def sos_supports_parallel(sos: np.ndarray) -> bool:
    """True when every section's poles admit the O(log T) / blocked
    partial-fraction path: complex-conjugate pairs OR two DISTINCT real
    poles (round 4) with RELATIVE separation ≥ ~1e-3. Near-repeated poles
    (either sign of the discriminant) and first-order leftovers (a2 == 0)
    keep the sequential scan — the partial-fraction amplitudes ∝ 1/(p1−p2)
    cancel catastrophically in f32 otherwise."""
    sos = np.atleast_2d(np.asarray(sos, np.float64))
    for row in sos:
        b0, b1, b2, a0, a1, a2 = row
        a1, a2 = a1 / a0, a2 / a0
        if a2 == 0.0:
            return False  # FIR/first-order section → scan path
        disc = a1 * a1 - 4.0 * a2
        if abs(disc) < _POLE_SEP_EPS_REL * _disc_scale(a1, a2):
            return False  # (near-)repeated pole → scan path
    return True


def sos_parallel_init_state(channels: int, n_sections: int) -> jnp.ndarray:
    shape = (n_sections,) if channels == 0 else (channels, n_sections)
    return jnp.zeros(shape, jnp.complex64)


def sos_parallel_apply(x: jnp.ndarray, sos: np.ndarray, state: jnp.ndarray
                       ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Biquad cascade in O(log T) depth: each section via partial fractions +
    one complex associative scan; sections chain sequentially (S is small).
    State: complex one-pole carries u[-1], [..., S]."""
    sos = np.atleast_2d(np.asarray(sos, np.float64))
    v = x
    carries = []
    for k, row in enumerate(sos):
        v, last = biquad_parallel_apply(v, row, state[..., k])
        carries.append(last)
    return v, jnp.stack(carries, axis=-1)


def biquad_parallel_apply(x: jnp.ndarray, sos_row: np.ndarray,
                          state: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """One biquad in O(log T) via complex one-pole decomposition.

    H(z) = (b0 + b1 z⁻¹ + b2 z⁻²)/(1 + a1 z⁻¹ + a2 z⁻²). With complex-conjugate
    poles p, p̄: partial fractions give y = 2·Re[r·u] + d·x where u is a one-pole
    recurrence with pole p. ``state``: complex carry u[-1] shape [...].
    Falls back to sequential scan for real/repeated poles.
    """
    b0, b1, b2, a0, a1, a2 = (float(v) for v in np.asarray(sos_row, np.float64))
    b0, b1, b2, a1, a2 = b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0
    if a2 == 0.0:
        raise ValueError(
            "biquad_parallel_apply requires a full second-order section "
            "(a2 != 0); first-order/FIR sections take the sequential scan "
            "path (sos_supports_parallel gates this)")
    disc = a1 * a1 - 4.0 * a2
    if abs(disc) < _POLE_SEP_EPS_REL * _disc_scale(a1, a2):
        raise ValueError(
            "biquad_parallel_apply requires well-separated poles "
            "(relative separation >= ~1e-3): near-repeated poles make the "
            "partial-fraction amplitudes cancel in f32 — use the sequential "
            "scan path (sos_supports_parallel gates this)")
    if disc > 0.0:
        # two DISTINCT REAL poles: H = K + A1/(1−p1·w) + A2/(1−p2·w) — two
        # real one-pole rails (both take the blocked fast path); their
        # carries pack as (re, im) of the section's one complex state slot,
        # keeping the state pytree identical to the conjugate-pair case.
        sq = float(np.sqrt(disc))
        p1, p2 = (-a1 + sq) / 2.0, (-a1 - sq) / 2.0
        K = b2 / a2
        A1 = (b0 * p1 * p1 + b1 * p1 + b2) / (p1 * (p1 - p2))
        A2 = (b0 * p2 * p2 + b1 * p2 + b2) / (p2 * (p2 - p1))
        xf = x.astype(jnp.float32)
        u1, l1 = one_pole_apply(xf, p1, jnp.real(state).astype(jnp.float32))
        u2, l2 = one_pole_apply(xf, p2, jnp.imag(state).astype(jnp.float32))
        y = (jnp.asarray(K, x.dtype) * x
             + jnp.float32(A1) * u1 + jnp.float32(A2) * u2)
        return y.astype(x.dtype), jax.lax.complex(
            l1.astype(jnp.float32), l2.astype(jnp.float32))
    p = complex(-a1 / 2.0, np.sqrt(-disc) / 2.0)
    # Exact partial fractions in w = z⁻¹:  H = K + A/(1−p w) + Ā/(1−p̄ w)
    # with K = b2/a2 and A = (b0 p² + b1 p + b2)/(p (p − p̄)); the k=0 term checks
    # out: K + 2·Re A = b0.
    K = b2 / a2
    A = (b0 * p * p + b1 * p + b2) / (p * (p - np.conj(p)))
    xc = x.astype(jnp.complex64)
    # p passes to one_pole_apply as a HOST complex (enables the blocked path)
    a_dev = jnp.asarray(A, jnp.complex64)
    u, u_last = one_pole_apply(xc, p, state)
    y = jnp.asarray(K, x.dtype) * x + 2.0 * jnp.real(a_dev * u)
    return y.astype(x.dtype), u_last
