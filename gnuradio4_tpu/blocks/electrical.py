"""Electrical / power-metering blocks (≈ reference blocks/electrical/
PowerEstimators.hpp: PowerMetrics<T, nPhases>, PowerFactor, SystemUnbalance).

Windowed power estimation is a reduction over decimation windows — a reshape +
mean elementwise, fully fused.
"""

from __future__ import annotations

from fractions import Fraction

import jax.numpy as jnp
import numpy as np

from ..core.block import Block, Port
from ..core.registry import register_block
from ..core.settings import Setting


@register_block("PowerMetrics")
class PowerMetrics(Block):
    """Per-phase P/Q/S + RMS voltage/current over decimation windows.

    inputs: ``u`` and ``i`` (both [n_phases, T] or [T] for single phase);
    outputs: p, q, s, u_rms, i_rms at rate fs/decim.
    """

    IN = (Port("u", dtype="float32"), Port("i", dtype="float32"),
          Port("u_sigma", dtype="float32", optional=True),
          Port("i_sigma", dtype="float32", optional=True))
    OUT = (Port("p", dtype="float32"), Port("q", dtype="float32"),
           Port("s", dtype="float32"), Port("u_rms", dtype="float32"),
           Port("i_rms", dtype="float32"),
           Port("p_sigma", dtype="float32"),
           Port("s_sigma", dtype="float32"),
           Port("u_rms_sigma", dtype="float32"),
           Port("i_rms_sigma", dtype="float32"))
    decim = Setting(default=1000, kind="static", limits=(1, 1 << 24),
                    description="samples per estimate window")

    @property
    def ratio(self):
        return Fraction(1, int(self.settings.get("decim")))

    @property
    def alignment(self):
        return int(self.settings.get("decim"))

    def apply(self, state, ins, ctx):
        d = int(self.settings.get("decim"))
        u, i = ins["u"], ins["i"]
        uw = u.reshape(*u.shape[:-1], -1, d)
        iw = i.reshape(*i.shape[:-1], -1, d)
        p = jnp.mean(uw * iw, axis=-1)
        u_rms = jnp.sqrt(jnp.mean(uw * uw, axis=-1))
        i_rms = jnp.sqrt(jnp.mean(iw * iw, axis=-1))
        s = u_rms * i_rms
        q = jnp.sqrt(jnp.maximum(s * s - p * p, 0.0))
        # Measurement-uncertainty propagation (≈ the reference's
        # PowerMetrics<UncertainValue<T>> instantiation, first-order Gaussian
        # uncorrelated — same rules as utils/uncertain.UncertainValue):
        # optional u_sigma/i_sigma streams carry per-sample σ; outputs ride
        # parallel *_sigma ports (zeros when no σ inputs are connected).
        su = ins.get("u_sigma")
        si = ins.get("i_sigma")
        eps = 1e-20
        suw = su.reshape(*uw.shape) if su is not None else jnp.zeros_like(uw)
        siw = si.reshape(*iw.shape) if si is not None else jnp.zeros_like(iw)
        # var(mean of d uncorrelated terms) = Σ var / d²
        var_p = jnp.sum(iw * iw * suw * suw + uw * uw * siw * siw,
                        axis=-1) / (d * d)
        # u_rms = sqrt(m), m = mean(u²): σ_m = sqrt(Σ(2uσ)²)/d, σ = σ_m/(2√m)
        sm_u = jnp.sqrt(jnp.sum(4.0 * uw * uw * suw * suw, axis=-1)) / d
        sm_i = jnp.sqrt(jnp.sum(4.0 * iw * iw * siw * siw, axis=-1)) / d
        s_ur = sm_u / (2.0 * jnp.maximum(u_rms, eps))
        s_ir = sm_i / (2.0 * jnp.maximum(i_rms, eps))
        # s = u_rms · i_rms (uncorrelated product rule)
        s_s = s * jnp.sqrt((s_ur / jnp.maximum(u_rms, eps)) ** 2
                           + (s_ir / jnp.maximum(i_rms, eps)) ** 2)
        return state, {"p": p, "q": q, "s": s, "u_rms": u_rms, "i_rms": i_rms,
                       "p_sigma": jnp.sqrt(var_p), "s_sigma": s_s,
                       "u_rms_sigma": s_ur, "i_rms_sigma": s_ir}


@register_block("PowerFactor")
class PowerFactor(Block):
    """cos φ = P/S and phase angle from P/S streams (≈ PowerFactor)."""

    IN = (Port("p", dtype="float32"), Port("s", dtype="float32"),
          Port("p_sigma", dtype="float32", optional=True),
          Port("s_sigma", dtype="float32", optional=True))
    OUT = (Port("power_factor", dtype="float32"),
           Port("phase", dtype="float32"),
           Port("power_factor_sigma", dtype="float32"))

    def apply(self, state, ins, ctx):
        eps = 1e-20
        s_ = jnp.maximum(ins["s"], eps)
        pf = jnp.clip(ins["p"] / s_, -1.0, 1.0)
        # first-order σ of a quotient (uncorrelated): continues PowerMetrics'
        # uncertainty side-channel through cos φ = P/S
        sp = ins.get("p_sigma")
        ss = ins.get("s_sigma")
        zero = jnp.zeros_like(pf)
        sp = zero if sp is None else sp
        ss = zero if ss is None else ss
        # stable quotient rule: |pf|·sqrt((sp/p)²+(ss/s)²) overflows float32
        # to 0·inf = NaN as p → 0; the equivalent form below limits to sp/s
        pf_sigma = jnp.sqrt((sp / s_) ** 2 + (pf * ss / s_) ** 2)
        return state, {"power_factor": pf, "phase": jnp.arccos(pf),
                       "power_factor_sigma": pf_sigma}


@register_block("SystemUnbalance")
class SystemUnbalance(Block):
    """Three-phase voltage/current unbalance (max deviation / mean, in %).

    inputs: u_rms and i_rms as [3, T] multi-channel streams; outputs unbalance
    percentages + total power (≈ SystemUnbalance for nPhases=3).
    """

    IN = (Port("u_rms", dtype="float32"), Port("i_rms", dtype="float32"),
          Port("p", dtype="float32"))
    OUT = (Port("u_unbalance", dtype="float32"),
           Port("i_unbalance", dtype="float32"),
           Port("p_total", dtype="float32"))

    def out_channels(self, port, in_channels):
        return 0  # scalar streams out

    def apply(self, state, ins, ctx):
        def unbal(x):
            m = jnp.mean(x, axis=0)
            dev = jnp.max(jnp.abs(x - m[None, :]), axis=0)
            return 100.0 * dev / jnp.maximum(m, 1e-20)
        return state, {
            "u_unbalance": unbal(ins["u_rms"]),
            "i_unbalance": unbal(ins["i_rms"]),
            "p_total": jnp.sum(ins["p"], axis=0),
        }
