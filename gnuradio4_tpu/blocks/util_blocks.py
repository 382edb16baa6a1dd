"""Classic stream utility blocks (GNU Radio staples): Throttle, MovingAverage,
DC blocker, Threshold, Mute — small, always-wanted pieces."""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from ..core.block import Block, Port
from ..core.registry import register_block
from ..core.settings import Setting


@register_block("Throttle")
class Throttle(Block):
    """Pass-through that paces the *host pump* to ``sample_rate`` wall-clock
    (like GNU Radio's throttle: keeps a flowgraph without hardware from
    free-running). Device compute is untouched; the sleep happens in the host
    tag hook."""

    IN = (Port("in"),)
    OUT = (Port("out"),)
    sample_rate = Setting(default=32000.0, unit="Hz", limits=(1.0, 1e12))

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._t0 = None
        self._served = 0

    def start(self):
        self._t0 = None
        self._served = 0

    def emit_tags(self, ctx):  # runs once per step on the host
        n = next(iter(ctx.in_len.values()), 0)
        fs = float(self.settings.get("sample_rate"))
        now = time.monotonic()
        if self._t0 is None:
            self._t0 = now
        self._served += n
        target = self._t0 + self._served / fs
        if target > now:
            time.sleep(min(target - now, 1.0))
        return []

    def apply(self, state, ins, ctx):
        return state, {"out": ins["in"]}


@register_block("MovingAverage")
class MovingAverage(Block):
    """Length-N moving average as a uniform-tap FIR on the matrix units (matmul
    framing, bounded error ~N·ε); carried state = last N−1 inputs. Very long
    windows (> 4096) fall back to prefix sums — note that cumsum error grows
    with block_len × signal mean (catastrophic cancellation of large prefix
    sums), so the FIR path is also the accurate one."""

    IN = (Port("in"),)
    OUT = (Port("out"),)
    length = Setting(default=16, kind="static", limits=(1, 1 << 20))
    scale = Setting(default=0.0, description="0 → 1/length (true average)")

    def init_state(self, ctx):
        n = int(self.settings.get("length"))
        ch = ctx.channels.get("in", 0)
        shape = (n - 1,) if ch == 0 else (ch, n - 1)
        return jnp.zeros(shape, ctx.dtype("in", jnp.float32))

    def apply(self, state, ins, ctx):
        x = ins["in"]
        n = int(self.settings.get("length"))
        if n == 1:
            return state, {"out": x}
        scale = float(self.settings.get("scale")) or (1.0 / n)
        if n <= 4096:
            from ..ops.fir import fir_apply
            import numpy as np
            taps = np.full(n, scale, np.float32)
            y, new_state = fir_apply(x, taps, state.astype(x.dtype))
            return new_state, {"out": y.astype(x.dtype)}
        xc = jnp.concatenate([state.astype(x.dtype), x], axis=-1)
        c = jnp.cumsum(xc, axis=-1)
        zero = jnp.zeros_like(c[..., :1])
        c = jnp.concatenate([zero, c], axis=-1)          # prefix sums, len+1
        window_sums = c[..., n:] - c[..., :-n]           # len = t
        y = window_sums * jnp.asarray(scale, jnp.real(x).dtype)
        return xc[..., -(n - 1):], {"out": y.astype(x.dtype)}

    def sp_halo(self, ctx):
        # state is exactly the last length−1 inputs → default halo converters
        return int(self.settings.get("length")) - 1


@register_block("DcBlocker")
class DcBlocker(Block):
    """Single-pole DC-removal high-pass: y = x − x⁻¹ + R·y⁻¹ (exact O(log T)
    parallel recurrence)."""

    IN = (Port("in", dtype="float32"),)
    OUT = (Port("out", dtype="float32"),)
    pole = Setting(default=0.995, kind="static", limits=(0.5, 0.999999))

    def init_state(self, ctx):
        ch = ctx.channels.get("in", 0)
        shape = () if ch == 0 else (ch,)
        return {"u": jnp.zeros(shape, jnp.float32),
                "x_last": jnp.zeros(shape, jnp.float32)}

    def apply(self, state, ins, ctx):
        from ..ops.iir import one_pole_apply
        x = ins["in"]
        r = float(self.settings.get("pole"))
        prev = jnp.concatenate([state["x_last"][..., None], x[..., :-1]],
                               axis=-1)
        v = x - prev                       # differentiator
        y, u_last = one_pole_apply(v, jnp.float32(r), state["u"])
        return ({"u": u_last, "x_last": x[..., -1]},
                {"out": y.astype(jnp.float32)})


@register_block("Threshold")
class Threshold(Block):
    """Hysteresis-free comparator: 1.0 where x ≥ level else 0.0."""

    IN = (Port("in", dtype="float32"),)
    OUT = (Port("out", dtype="float32"),)
    level = Setting(default=0.0)

    def apply(self, state, ins, ctx):
        lvl = jnp.asarray(ctx.p("level", 0.0), jnp.float32)
        return state, {"out": (ins["in"] >= lvl).astype(jnp.float32)}


@register_block("MuteSwitch")
class MuteSwitch(Block):
    """Runtime mute: zeros the stream while ``mute`` is set (dynamic — no
    recompile; flip it via messages or block message edges)."""

    IN = (Port("in"),)
    OUT = (Port("out"),)
    mute = Setting(default=False, dtype=np.bool_)

    def apply(self, state, ins, ctx):
        x = ins["in"]
        gate = jnp.where(jnp.asarray(ctx.p("mute", False)), 0.0, 1.0)
        return state, {"out": x * gate.astype(jnp.real(x).dtype)}


@register_block("KeepOneInN")
class KeepOneInN(Block):
    """Every N-th sample (≈ gr keep_one_in_n): ratio 1/N, the kept sample
    is the one at ``offset`` within each group."""

    IN = (Port("in"),)
    OUT = (Port("out"),)
    n = Setting(default=2, kind="static", limits=(1, 1 << 20))
    offset = Setting(default=0, kind="static")

    @property
    def ratio(self):
        from fractions import Fraction
        return Fraction(1, int(self.settings.get("n")))

    @property
    def alignment(self):
        return int(self.settings.get("n"))

    def apply(self, state, ins, ctx):
        x = ins["in"]
        n = int(self.settings.get("n"))
        off = int(self.settings.get("offset")) % n
        frames = x.reshape(x.shape[:-1] + (-1, n))
        return state, {"out": frames[..., off]}


@register_block("Repeat")
class Repeat(Block):
    """Repeat each sample N times (≈ gr repeat): ratio N/1."""

    IN = (Port("in"),)
    OUT = (Port("out"),)
    n = Setting(default=2, kind="static", limits=(1, 1 << 20))

    @property
    def ratio(self):
        from fractions import Fraction
        return Fraction(int(self.settings.get("n")), 1)

    def apply(self, state, ins, ctx):
        return state, {"out": jnp.repeat(ins["in"],
                                         int(self.settings.get("n")),
                                         axis=-1)}


@register_block("Integrate")
class Integrate(Block):
    """Sum groups of N samples into one (≈ gr integrate): ratio 1/N."""

    IN = (Port("in"),)
    OUT = (Port("out"),)
    n = Setting(default=2, kind="static", limits=(1, 1 << 20))

    @property
    def ratio(self):
        from fractions import Fraction
        return Fraction(1, int(self.settings.get("n")))

    @property
    def alignment(self):
        return int(self.settings.get("n"))

    def apply(self, state, ins, ctx):
        x = ins["in"]
        n = int(self.settings.get("n"))
        return state, {"out": x.reshape(x.shape[:-1] + (-1, n)).sum(axis=-1)}


@register_block("PeakDetector")
class PeakDetector(Block):
    """1.0 at strict local maxima above ``threshold``, else 0.0 (≈ gr
    peak_detector's steady-state behavior). The one-sample halo at each
    step boundary is carried in state so peaks at seams are not missed."""

    IN = (Port("in", dtype="float32"),)
    OUT = (Port("out", dtype="float32"),)
    threshold = Setting(default=0.0)

    def init_state(self, ctx):
        ch = ctx.channels.get("in", 0)
        shape = (2,) if ch == 0 else (ch, 2)
        return jnp.full(shape, -jnp.inf, jnp.float32)

    def apply(self, state, ins, ctx):
        x = ins["in"]
        ext = jnp.concatenate([state, x], axis=-1)
        left = ext[..., :-2]
        mid = ext[..., 1:-1]
        right = ext[..., 2:]
        thr = jnp.asarray(ctx.p("threshold", 0.0), jnp.float32)
        peak = (mid > left) & (mid > right) & (mid > thr)
        # output is aligned one sample behind the input (the last sample's
        # peak-ness needs its right neighbor — it resolves next step)
        return ext[..., -2:], {"out": peak.astype(jnp.float32)}


@register_block("SampleAndHold")
class SampleAndHold(Block):
    """y[n] = x[n] while ctrl[n] > 0, else the last sampled value (≈ gr
    sample_and_hold); the held value carries across steps."""

    IN = (Port("in"), Port("ctrl", dtype="float32"))
    OUT = (Port("out"),)

    def init_state(self, ctx):
        ch = ctx.channels.get("in", 0)
        return jnp.zeros(() if ch == 0 else (ch,), jnp.float32)

    def apply(self, state, ins, ctx):
        x = ins["in"]
        gate = ins["ctrl"] > 0.0

        def step_fn(held, xg):
            xi, gi = xg
            held = jnp.where(gi, xi, held)
            return held, held

        held, y = jax.lax.scan(step_fn, state.astype(x.dtype),
                               (x, gate))
        return held.astype(jnp.float32), {"out": y}


@register_block("DiffPhasor")
class DiffPhasor(Block):
    """Differential phasor y[n] = x[n]·x̄[n−1] (≈ gr diff_phasor_cc) — the
    complex form of differential decoding for DPSK constellations; one
    carried sample of state, same halo protocol as QuadratureDemod."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"),)

    def init_state(self, ctx):
        ch = ctx.channels.get("in", 0)
        return jnp.ones(() if ch == 0 else (ch,), jnp.complex64)

    def apply(self, state, ins, ctx):
        x = ins["in"]
        prev = jnp.concatenate([state[..., None], x[..., :-1]], axis=-1)
        return x[..., -1], {"out": (x * jnp.conj(prev)).astype(jnp.complex64)}

    def sp_halo(self, ctx):
        return 1

    def sp_state_to_tail(self, state, ctx):
        return state[..., None]

    def sp_tail_to_state(self, tail, state, ctx):
        return tail[..., 0].astype(jnp.complex64)
