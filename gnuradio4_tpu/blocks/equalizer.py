"""Adaptive channel equalizers (beyond the reference's blocklib — classic
GNU Radio capability: cma_equalizer_cc / lms_dd_equalizer_cc).

Design: **block-LMS / block-CMA** — taps update once per
``update_len`` symbols using the averaged gradient over the sub-block, so the
inner work is a frames×taps matmul (matrix units) instead of a per-symbol scalar loop.
Block-gradient adaptation is the standard fast-LMS formulation; convergence is
the same fixed point with slightly slower time constants.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.block import Block, Port
from ..core.registry import register_block
from ..core.settings import Setting
from ..ops.digital import make_constellation


def _frames(x: jnp.ndarray, k: int) -> jnp.ndarray:
    """[n, k] windows: row i = x[i .. i+k-1] (gather-free, 2 slices)."""
    n = x.shape[-1] - k + 1
    cols = [jax.lax.dynamic_slice_in_dim(x, j, n) for j in range(k)]
    return jnp.stack(cols, axis=-1)


class _BlockEqualizer(Block):
    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"),)
    num_taps = Setting(default=11, kind="static", limits=(1, 256))
    gain = Setting(default=0.01, kind="static", limits=(1e-8, 1.0),
                   description="adaptation step size mu")
    update_len = Setting(default=64, kind="static", limits=(1, 8192),
                         description="symbols per tap update (block gradient)")

    def init_state(self, ctx):
        k = int(self.settings.get("num_taps"))
        taps = jnp.zeros((k,), jnp.complex64).at[k // 2].set(1.0 + 0j)
        return {"taps": taps,
                "hist": jnp.zeros((k - 1,), jnp.complex64)}

    def _error(self, y):  # -> gradient-driving error term e (see subclasses)
        raise NotImplementedError

    def apply(self, state, ins, ctx):
        x = ins["in"]
        k = int(self.settings.get("num_taps"))
        mu = jnp.float32(self.settings.get("gain"))
        ul = int(self.settings.get("update_len"))
        xa = jnp.concatenate([state["hist"], x], axis=-1)
        n = x.shape[-1]
        nblk = max(n // ul, 1)
        ul_eff = n // nblk

        F = _frames(xa, k)[:nblk * ul_eff]          # [n, k] windows
        Fb = F.reshape(nblk, ul_eff, k)

        def step(w, fb):
            y = fb @ w                              # [ul] equalized symbols
            e = self._error(y)                      # same shape
            # block gradient of the cost wrt conj(w): mean e·conj(window)
            grad = jnp.mean(e[:, None] * jnp.conj(fb), axis=0)
            w = w - mu * grad
            # keep taps bounded (divergence guard; CMA can blow up at high mu)
            nrm = jnp.sqrt(jnp.sum(jnp.abs(w) ** 2))
            w = jnp.where(nrm > 4.0, w * (4.0 / nrm), w)
            return w, y

        w, yb = jax.lax.scan(step, state["taps"].astype(jnp.complex64), Fb)
        y = yb.reshape(-1)
        if n > nblk * ul_eff:                       # equalize the remainder
            rest = F[nblk * ul_eff:] if F.shape[0] > nblk * ul_eff else None
            tailF = _frames(xa, k)[nblk * ul_eff: n]
            y = jnp.concatenate([y, tailF @ w], axis=-1)
        new_hist = jax.lax.dynamic_slice_in_dim(xa, n, k - 1)
        return ({"taps": w, "hist": new_hist},
                {"out": y.astype(jnp.complex64)})


@register_block("CmaEqualizer")
class CmaEqualizer(_BlockEqualizer):
    """Constant-modulus (Godard) blind equalizer: drives |y|² toward
    ``modulus`` (1.0 for PSK). Blind — leaves a phase ambiguity; follow with
    CostasLoop. ≈ GNU Radio cma_equalizer_cc, block-gradient formulation."""

    modulus = Setting(default=1.0, kind="static", limits=(1e-6, 1e6))

    def _error(self, y):
        r = jnp.float32(self.settings.get("modulus"))
        return y * (jnp.abs(y) ** 2 - r)


@register_block("LmsDDEqualizer")
class LmsDDEqualizer(_BlockEqualizer):
    """Decision-directed LMS equalizer: error against the nearest
    constellation point (needs carrier lock first — run after CostasLoop, or
    seed with CmaEqualizer). ≈ GNU Radio lms_dd_equalizer_cc."""

    constellation = Setting(default="qpsk", kind="static",
                            choices=("bpsk", "qpsk", "8psk", "qam16"))

    def _points(self):
        if getattr(self, "_pts", None) is None:
            self._pts = np.asarray(
                make_constellation(str(self.settings.get("constellation"))),
                np.complex64)
        return self._pts

    def _error(self, y):
        pts = jnp.asarray(self._points())
        d = pts[jnp.argmin(jnp.abs(y[:, None] - pts[None, :]), axis=-1)]
        return y - d
