"""Squelch blocks (gr-analog equivalents): power squelch and CTCSS tone
squelch, both fully on device.

The reference ships no squelch blocks; these extend the analog receiver
set (WbfmReceiver, AmDemod, SsbDemod) with the classic mute gates:

- :class:`PowerSquelch` (≈ gr pwr_squelch_cc/ff + simple_squelch_cc):
  a one-pole envelope of |x|² gates the stream sample-accurately.  The
  envelope recurrence runs as an O(log T) ``associative_scan``
  (ops/iir.one_pole_apply) rather than a sequential loop — the
  device-native form of the reference-style per-sample IIR.
- :class:`CtcssSquelch` (≈ gr ctcss_squelch_ff): per-chunk Goertzel
  power at the sub-audible tone frequency, compared against the total
  chunk power, gates whole chunks (vmapped Goertzel over the chunk
  grid; ops/farrow.goertzel_power).

Thresholds are dynamic settings (``ctx.p``) — changing them mid-run is a
parameter update, not a recompile.
"""

from __future__ import annotations

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np

from ..core.block import Block, Port
from ..core.registry import register_block
from ..core.settings import Setting
from ..ops.farrow import goertzel_power
from ..ops.iir import one_pole_apply


@register_block("PowerSquelch")
class PowerSquelch(Block):
    """Mute samples whose smoothed power falls below ``threshold_db``:
    env[n] = (1−α)·env[n−1] + α·|x[n]|², y[n] = x[n]·[env[n] ≥ thr].

    ``threshold_db`` is dynamic (no recompile); ``alpha`` sets the
    envelope time constant (gr pwr_squelch's alpha).  The gr ``ramp``
    option is intentionally absent — a hard gate on the smoothed
    envelope is already click-free for practical alphas."""

    IN = (Port("in"),)
    OUT = (Port("out"),)
    threshold_db = Setting(default=-40.0, unit="dB",
                           description="mute below this smoothed power")
    alpha = Setting(default=1e-3, kind="static", limits=(1e-9, 1.0),
                    description="envelope smoothing per sample")
    invert = Setting(default=False, kind="static",
                     description="mute ABOVE the threshold instead")

    def init_state(self, ctx):
        ch = ctx.channels.get("in", 0)
        return jnp.zeros(() if ch == 0 else (ch,), jnp.float32)

    def apply(self, state, ins, ctx):
        x = ins["in"]
        a = float(self.settings.get("alpha"))
        p = (jnp.abs(x) ** 2).astype(jnp.float32)
        env, last = one_pole_apply(a * p, jnp.float32(1.0 - a), state)
        thr_db = jnp.asarray(ctx.p("threshold_db", -40.0), jnp.float32)
        thr = jnp.power(jnp.float32(10.0), thr_db / 10.0)
        gate = env >= thr
        if bool(self.settings.get("invert")):
            gate = ~gate
        return last, {"out": x * gate.astype(x.dtype)}


@register_block("CtcssSquelch")
class CtcssSquelch(Block):
    """CTCSS sub-audible tone squelch for demodulated FM audio: per
    ``chunk`` samples, the Goertzel power at ``frequency`` must exceed
    ``level`` × the mean chunk power for the chunk to pass (muted
    otherwise).  Gate decisions are chunk-granular like the gr block's
    internal Goertzel window."""

    IN = (Port("in", dtype="float32"),)
    OUT = (Port("out", dtype="float32"),)
    frequency = Setting(default=88.5, kind="static", unit="Hz",
                        description="CTCSS tone (67–254 Hz)")
    level = Setting(default=0.1,
                    description="tone-power : mean-power gate ratio")
    chunk = Setting(default=2048, kind="static", limits=(64, 1 << 20))
    sample_rate_in = Setting(default=0.0, kind="static",
                             description="0 → inherit resolved edge rate")

    @property
    def alignment(self):
        return int(self.settings.get("chunk"))

    def apply(self, state, ins, ctx):
        n = int(self.settings.get("chunk"))
        fs = float(self.settings.get("sample_rate_in")) or ctx.sample_rate
        f = float(self.settings.get("frequency"))
        x = ins["in"]
        xw = x.reshape(*x.shape[:-1], -1, n)
        flat = xw.reshape(-1, n)
        tone = jax.vmap(lambda c: goertzel_power(
            c, freq=f, sample_rate=fs))(flat)
        total = jnp.mean(flat.astype(jnp.float32) ** 2, axis=-1)
        lvl = jnp.asarray(ctx.p("level", 0.1), jnp.float32)
        gate = tone >= lvl * jnp.maximum(total, jnp.float32(1e-30))
        y = flat * gate[:, None].astype(x.dtype)
        return state, {"out": y.reshape(x.shape)}
