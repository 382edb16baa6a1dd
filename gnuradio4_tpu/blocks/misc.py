"""Remaining reference block families: FunctionGenerator, ClockSource, SyncBlock,
SchmittTrigger, FrequencyEstimator, SavitzkyGolayFilter, SvdDenoiser, BurstTaper,
Expression blocks (≈ blocks/basic FunctionGenerator.hpp:138, ClockSource.hpp:25,
SyncBlock.hpp:13, Trigger.hpp; blocks/filter FrequencyEstimator.hpp,
SavitzkyGolay, SvdDenoiser; blocks/math ExpressionBlocks.hpp:68)."""

from __future__ import annotations

import time
from fractions import Fraction
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..core.block import Block, Port, SourceBlock
from ..core.errors import GrError
from ..core.registry import register_block
from ..core.settings import Setting
from ..core.tags import Keys, Tag
from ..ops.estimators import schmitt_device
from ..ops.savgol import design_savgol
from ..ops.fir import fir_apply, fir_init_state


FUNCTION_MODES = ("Const", "LinearRamp", "ParabolicRamp", "CubicSpline",
                  "ImpulseResponse", "UniformNoise", "TriangularNoise",
                  "GaussianNoise", "Sin", "Cos", "FastSin", "FastCos")
_FG_NOISE = ("UniformNoise", "TriangularNoise", "GaussianNoise")
_FG_TONES = ("Sin", "Cos", "FastSin", "FastCos")


@register_block("FunctionGenerator")
class FunctionGenerator(SourceBlock):
    """Segment-programmable function source (≈ FunctionGenerator.hpp:138).

    One segment at a time, the reference's full type list
    (FunctionGenerator.hpp:21): ramps {Const, LinearRamp, ParabolicRamp,
    CubicSpline} from ``start_value`` → ``final_value`` over ``duration``
    seconds; ``ImpulseResponse`` (``final_value`` inside [impulse_time0,
    impulse_time0+impulse_time1], ``start_value`` outside); noise types
    (``start_value`` = amplitude, device threefry); tones Sin/Cos/FastSin/
    FastCos (``final_value`` = amplitude, ``start_value`` = offset; a
    positive ``duration`` expires the tone back to the offset).
    Segments are switched by (context) tags or Set messages — applying
    settings restarts the segment clock (state reset), matching the
    reference's context-tag-driven operation.
    """

    # optional clock/tag input (≈ FunctionGenerator.hpp clk_in): carries no
    # sample information here — its TAGS (CMD_BP_START contexts from a
    # ClockSource) drive the stored-settings timeline
    IN = (Port("clk_in", optional=True),)
    OUT = (Port("out", dtype="float32"),)
    signal_type = Setting(default="Const", kind="static", choices=FUNCTION_MODES)
    start_value = Setting(default=0.0)
    final_value = Setting(default=0.0)
    duration = Setting(default=1.0, unit="s", limits=(0.0, 1e12))
    round_off_time = Setting(default=0.0, unit="s",
                             description="parabolic ease-in/out time")
    impulse_time0 = Setting(default=0.0, unit="s")
    impulse_time1 = Setting(default=0.0, unit="s")
    frequency = Setting(default=0.0, unit="Hz")
    phase = Setting(default=0.0, unit="rad")
    seed = Setting(default=0, kind="static",
                   description="PRNG seed for the noise types")
    sample_rate = Setting(default=0.0, unit="Hz")
    n_samples = Setting(default=0, kind="static")

    def init_state(self, ctx):
        self._ctx_rate = ctx.sample_rate
        if str(self.settings.get("signal_type")) in _FG_NOISE:
            from ..ops.noise import noise_init_state
            return noise_init_state(int(self.settings.get("seed")))
        return jnp.zeros((), jnp.uint32)  # samples since segment start (blocks)

    def on_settings_applied(self, result):
        if result.applied:
            self._state_reset = True  # restart segment clock on any change

    def host_done(self, abs_out, n):
        total = int(self.settings.get("n_samples"))
        if total and abs_out + n >= total:
            return max(0, total - abs_out)
        return None

    def apply(self, state, ins, ctx):
        n = ctx.out_len["out"]
        fs = float(self.settings.get("sample_rate")) or ctx.sample_rate
        a = jnp.asarray(ctx.p("start_value", 0.0), jnp.float32)
        b = jnp.asarray(ctx.p("final_value", 0.0), jnp.float32)
        dur = jnp.asarray(ctx.p("duration", 1.0), jnp.float32)
        mode = str(self.settings.get("signal_type"))
        if mode in _FG_NOISE:
            from ..ops import noise as nz
            fn = {"UniformNoise": lambda k: nz.uniform(k, (n,)),
                  "TriangularNoise": lambda k: nz.triangular(k, (n,)),
                  "GaussianNoise": lambda k: nz.gaussian(k, (n,))}[mode]
            y, key = fn(state)
            return key, {"out": (a * y).astype(jnp.float32)}
        idx = jax.lax.broadcasted_iota(jnp.float32, (n, 1), 0)[:, 0]
        t = (state.astype(jnp.float32) + idx) / jnp.float32(fs)
        if mode in _FG_TONES:
            # final_value = amplitude, start_value = offset; expires to offset
            f = jnp.asarray(ctx.p("frequency", 0.0), jnp.float32)
            ph = jnp.asarray(ctx.p("phase", 0.0), jnp.float32)
            theta = 2.0 * np.pi * f * t + ph
            tone = jnp.sin(theta) if mode in ("Sin", "FastSin") \
                else jnp.cos(theta)
            y = jnp.where((dur > 0.0) & (t > dur), a, b * tone + a)
            return state + jnp.uint32(n), {"out": y.astype(jnp.float32)}
        if mode == "ImpulseResponse":
            it0 = jnp.asarray(ctx.p("impulse_time0", 0.0), jnp.float32)
            it1 = jnp.asarray(ctx.p("impulse_time1", 0.0), jnp.float32)
            y = jnp.where((t < it0) | (t > it0 + it1), a, b)
            return state + jnp.uint32(n), {"out": y.astype(jnp.float32)}
        u = jnp.clip(t / jnp.maximum(dur, 1e-12), 0.0, 1.0)
        if mode == "Const":
            y = jnp.broadcast_to(a, (n,))
        elif mode == "LinearRamp":
            y = a + (b - a) * u
        elif mode == "CubicSpline":
            y = a + (b - a) * (3.0 * u * u - 2.0 * u * u * u)  # smoothstep
        else:  # ParabolicRamp: parabolic ease for round_off_time at both ends
            r = jnp.asarray(ctx.p("round_off_time", 0.0), jnp.float32)
            rho = jnp.clip(r / dur, 0.0, 0.5)
            # piecewise: parabola [0,ρ], linear [ρ,1−ρ], parabola [1−ρ,1]
            denom = jnp.maximum(1.0 - rho, 1e-9)
            v = 1.0 / denom  # peak slope so the curve still spans 0→1
            seg1 = 0.5 * v / jnp.maximum(rho, 1e-9) * u * u
            seg2 = v * (u - 0.5 * rho)
            seg3 = 1.0 - 0.5 * v / jnp.maximum(rho, 1e-9) * (1.0 - u) ** 2
            shape = jnp.where(u < rho, seg1, jnp.where(u > 1.0 - rho, seg3, seg2))
            shape = jnp.where(rho <= 0.0, u, jnp.clip(shape, 0.0, 1.0))
            y = a + (b - a) * shape
        return state + jnp.uint32(n), {"out": y.astype(jnp.float32)}


@register_block("ClockSource")
class ClockSource(SourceBlock):
    """Wall-clock-paced source emitting zeros + scheduled trigger tags
    (≈ ClockSource.hpp:25 + BlockingSync). ``do_zero_order_hold`` semantics: the
    sample content is a constant; the value of the block is its tag timeline.
    """

    OUT = (Port("out", dtype="uint8"),)
    FEED = True
    sample_rate = Setting(default=1000.0, unit="Hz", kind="static")
    n_samples = Setting(default=0, kind="static")
    realtime = Setting(default=False, kind="static",
                       description="pace host feed at sample_rate wall-clock")

    def __init__(self, name=None, tag_times: list[float] = (),
                 tag_values: list[dict] = (), **settings):
        super().__init__(name=name, **settings)
        self.tag_times = list(tag_times)   # seconds
        self.tag_values = [dict(v) for v in tag_values] or \
            [{Keys.TRIGGER_NAME: f"trigger{i}"} for i in range(len(self.tag_times))]
        self._t0: float | None = None

    def start(self):
        self._t0 = time.monotonic()

    def host_feed(self, n, abs_index):
        total = int(self.settings.get("n_samples"))
        fs = float(self.settings.get("sample_rate"))
        if total and abs_index >= total:
            return None
        if self.settings.get("realtime"):
            if self._t0 is None:
                self._t0 = time.monotonic()
            target = self._t0 + (abs_index + n) / fs
            delay = target - time.monotonic()
            if delay > 0:
                time.sleep(delay)
        nv = n if not total else min(n, total - abs_index)
        return {"out": np.zeros(n, np.uint8)}, nv

    def emit_tags(self, ctx):
        fs = float(self.settings.get("sample_rate"))
        n = next(iter(ctx.out_len.values()), 0)
        lo, hi = ctx.abs_index, ctx.abs_index + n
        out = []
        for t_s, tmap in zip(self.tag_times, self.tag_values):
            idx = int(round(t_s * fs))
            if lo <= idx < hi:
                m = dict(tmap)
                m.setdefault(Keys.TRIGGER_TIME, t_s)
                out.append(Tag(idx - lo, m))
        return out

    def apply(self, state, ins, ctx):
        return state, {"out": ins["out"]}


@register_block("SchmittTrigger")
class SchmittTrigger(Block):
    """Hysteresis comparator (≈ blocks/basic Trigger.hpp SchmittTrigger +
    algorithm/SchmittTrigger.hpp).

    Two output modes:

    - ``output='gate'`` (default): the binary comparator state as a ±1 stream
      — the pure device form;
    - ``output='pass'``: the input passed through verbatim, as the reference
      block does (Trigger.hpp:133 copies input to output).

    Edge *tags*: when ``trigger_name_rising_edge`` / ``falling_edge`` are
    non-empty (reference defaults: "RISING"/"FALLING"; "" omits), the block
    emits trigger tags at the detected (sub-sample interpolated) edge
    positions, carrying trigger_name/trigger_time/trigger_offset/context
    (Trigger.hpp:122-130 publishTag). Edge positions are data-dependent, so
    the tags are computed host-side on the landed device results and ride the
    delivery path (scheduler ``host_emit_tags``) — enabling them costs one
    D2H copy of this block's input per step. ``interpolation``:
    'none' | 'basic_linear' | 'regression' | 'polynomial'
    (= NO/BASIC_LINEAR/LINEAR/POLYNOMIAL_INTERPOLATION).

    Thresholds: legacy ``low``/``high``, or the reference's
    ``offset``±``threshold`` pair (algorithm/SchmittTrigger.hpp:67) —
    offset/threshold win when explicitly set.
    """

    IN = (Port("in", dtype="float32"),)
    OUT = (Port("out", dtype="float32"),)
    low = Setting(default=-0.5, kind="static")
    high = Setting(default=0.5, kind="static")
    offset = Setting(default=0.0, kind="static",
                     description="trigger offset (band midpoint)")
    threshold = Setting(default=0.0, kind="static",
                        description="hysteresis half-width; band = offset±threshold")
    output = Setting(default="gate", kind="static", choices=("gate", "pass"))
    trigger_name_rising_edge = Setting(default="", kind="static")
    trigger_name_falling_edge = Setting(default="", kind="static")
    interpolation = Setting(default="basic_linear", kind="static",
                            choices=("none", "basic_linear", "regression",
                                     "polynomial"))
    forward_tag = Setting(default=True, kind="static")

    def __init__(self, name=None, **settings):
        explicit_band = "offset" in settings or "threshold" in settings
        super().__init__(name=name, **settings)
        if explicit_band:
            off = float(self.settings.get("offset"))
            thr = float(self.settings.get("threshold"))
            self.settings.set({"low": off - thr, "high": off + thr})
            self.settings.apply_staged()
        self._rise = str(self.settings.get("trigger_name_rising_edge"))
        self._fall = str(self.settings.get("trigger_name_falling_edge"))
        if self._rise or self._fall:
            # data-derived tag emission: opt into HOST_TAP delivery of this
            # block's input + the host_emit_tags hook (core/scheduler.py)
            self.HOST_TAP = True
            self.EMITS_HOST_TAGS = True
        from ..ops.estimators import SchmittState
        self._edge_state = SchmittState()
        self._fs = 1.0

    def init_state(self, ctx):
        ch = ctx.channels.get("in", 0)
        self._fs = ctx.sample_rate
        return jnp.zeros(() if ch == 0 else (ch,), jnp.bool_)

    def apply(self, state, ins, ctx):
        states, carry = schmitt_device(ins["in"], state,
                                       low=float(self.settings.get("low")),
                                       high=float(self.settings.get("high")))
        if str(self.settings.get("output")) == "pass":
            return carry, {"out": ins["in"]}
        return carry, {"out": jnp.where(states, 1.0, -1.0).astype(jnp.float32)}

    def process_tags(self, in_tags, ctx):
        if not bool(self.settings.get("forward_tag")):
            return {"out": []}
        return super().process_tags(in_tags, ctx)

    def consume(self, arrays, tags, n_valid, abs_index):
        """No-op sink hook — present because HOST_TAP delivery feeds this
        block's input back to the host for edge extraction."""

    def host_emit_tags(self, arrays, tags, n_valid, abs_index):
        from ..core.tags import Tag
        from ..ops.estimators import schmitt_edges
        x = np.asarray(arrays["in"][..., :n_valid], np.float64)
        if x.ndim > 1:
            x = x[0]
        method = {"none": "none", "basic_linear": "basic_linear",
                  "regression": "regression", "polynomial": "polynomial"}[
            str(self.settings.get("interpolation"))]
        edges, self._edge_state = schmitt_edges(
            x, low=float(self.settings.get("low")),
            high=float(self.settings.get("high")),
            state=self._edge_state, method=method)
        fs = self._fs if self._fs else 1.0
        out = []
        for pos, kind in edges:
            name = self._rise if kind > 0 else self._fall
            if not name:
                continue
            ipos = int(np.floor(pos))
            if abs_index + ipos < 0:
                # interpolation extrapolated before the stream start — the
                # reference skips out-of-range edge positions
                # (Trigger.hpp:146 edgePosition >= 0 gate)
                continue
            out.append(Tag(ipos, {
                Keys.TRIGGER_NAME: name,
                Keys.TRIGGER_TIME: int((abs_index + pos) * 1e9 / fs),
                Keys.TRIGGER_OFFSET: float(pos - ipos) / fs,
                Keys.CONTEXT: "",
            }))
        return out


@register_block("FrequencyEstimator")
class FrequencyEstimator(Block):
    """Chunked frequency estimation (≈ FrequencyEstimator.hpp, decimating).

    method 'fft': windowed FFT + parabolic peak interpolation per chunk;
    method 'zero_crossing': mean spacing of sign changes. One estimate per
    ``chunk`` samples (rate fs/chunk).

    Complex IQ input is accepted on both methods (beyond the reference's
    float/double instantiations): 'fft' searches the full signed spectrum
    [−fs/2, fs/2); 'zero_crossing' becomes the phase-slope (Kay) estimator
    fs/2π·arg Σ x[n+1]·x̄[n] — the ML tone-frequency estimator at high SNR.
    """

    IN = (Port("in"),)
    OUT = (Port("out", dtype="float32"),)
    chunk = Setting(default=1024, kind="static", limits=(8, 1 << 24))
    method = Setting(default="fft", kind="static",
                     choices=("fft", "zero_crossing", "period"))
    # grid-frequency band (≈ FrequencyEstimator.hpp f_min/f_expected/f_max):
    # 'period' estimates outside [f_min, f_max] fall back to f_expected
    f_min = Setting(default=0.0)
    f_max = Setting(default=0.0, description="0 = unbounded")
    f_expected = Setting(default=0.0)

    @property
    def ratio(self):
        return Fraction(1, int(self.settings.get("chunk")))

    @property
    def alignment(self):
        return int(self.settings.get("chunk"))

    def apply(self, state, ins, ctx):
        n = int(self.settings.get("chunk"))
        x = ins["in"]
        xw = x.reshape(*x.shape[:-1], -1, n)
        fs = ctx.sample_rate
        is_complex = jnp.issubdtype(x.dtype, jnp.complexfloating)
        if self.settings.get("method") == "fft":
            w = jnp.asarray(np.hanning(n), jnp.float32)
            if is_complex:
                # full signed spectrum, fftshifted so DC sits at bin n//2
                spec = jnp.abs(jnp.fft.fftshift(
                    jnp.fft.fft(xw * w, axis=-1), axes=-1))
                spec = spec.at[..., n // 2].set(0.0)  # ignore DC
                half = n - 1
                bin0 = -(n // 2)
            else:
                spec = jnp.abs(jnp.fft.rfft(xw * w, axis=-1))
                spec = spec.at[..., 0].set(0.0)  # ignore DC
                half = n // 2
                bin0 = 0
            k = jnp.argmax(spec, axis=-1)
            # parabolic interpolation around the peak
            km = jnp.clip(k, 1, half - 1)
            a = jnp.take_along_axis(spec, km[..., None] - 1, axis=-1)[..., 0]
            b = jnp.take_along_axis(spec, km[..., None], axis=-1)[..., 0]
            c = jnp.take_along_axis(spec, km[..., None] + 1, axis=-1)[..., 0]
            denom = a - 2 * b + c
            d = jnp.where(jnp.abs(denom) > 1e-20, 0.5 * (a - c) / denom, 0.0)
            freq = (km.astype(jnp.float32) + d + bin0) * (fs / n)
        elif self.settings.get("method") == "period":
            # zero-crossing period regression — the reference's grid-frequency
            # time-domain estimator (FrequencyEstimator.hpp TimeDomain):
            # linear-interpolated rising crossings; f = (k−1)/(t_last−t_first).
            # All static-shape: first/last crossings via masked min/max.
            a = jnp.real(xw[..., :-1])
            b = jnp.real(xw[..., 1:])
            rising = (a < 0) & (b >= 0)
            base = jnp.arange(n - 1, dtype=jnp.float32)
            frac = a / jnp.where(a - b == 0, 1.0, a - b)
            pos = base + frac
            big = jnp.float32(1e12)
            first = jnp.min(jnp.where(rising, pos, big), axis=-1)
            last = jnp.max(jnp.where(rising, pos, -big), axis=-1)
            k = jnp.sum(rising, axis=-1).astype(jnp.float32)
            span = jnp.maximum(last - first, 1e-9)
            freq = jnp.where(k >= 2, (k - 1.0) * fs / span, 0.0)
            f_lo = jnp.asarray(ctx.p("f_min", 0.0), jnp.float32)
            f_hi = jnp.asarray(ctx.p("f_max", 0.0), jnp.float32)
            f_exp = jnp.asarray(ctx.p("f_expected", 0.0), jnp.float32)
            out_of_band = (freq < f_lo) | ((f_hi > 0) & (freq > f_hi))
            freq = jnp.where(out_of_band, f_exp, freq).astype(jnp.float32)
        elif is_complex:
            # phase-slope (Kay) estimator: signed, sub-bin, one arg per chunk
            acc = jnp.sum(xw[..., 1:] * jnp.conj(xw[..., :-1]), axis=-1)
            freq = jnp.angle(acc).astype(jnp.float32) * (fs / (2.0 * np.pi))
        else:
            sign = jnp.signbit(xw)
            crossings = jnp.sum(sign[..., 1:] != sign[..., :-1], axis=-1)
            freq = crossings.astype(jnp.float32) * fs / (2.0 * (n - 1))
        return state, {"out": freq.astype(jnp.float32)}


@register_block("SavitzkyGolayFilter")
class SavitzkyGolayFilter(Block):
    """Polynomial smoothing / differentiation (≈ SavitzkyGolayFilter). An FIR with
    S-G designed taps → matmul framing path; centered output (group-delay removed)
    costs (window−1)/2 samples of latency carried in state."""

    IN = (Port("in", dtype="float32"),)
    OUT = (Port("out", dtype="float32"),)
    window = Setting(default=11, kind="static", limits=(3, 4097))
    poly_order = Setting(default=3, kind="static", limits=(0, 32))
    deriv = Setting(default=0, kind="static", limits=(0, 8))

    def _taps(self):
        return design_savgol(int(self.settings.get("window")),
                             int(self.settings.get("poly_order")),
                             deriv=int(self.settings.get("deriv"))
                             ).astype(np.float32)

    def init_state(self, ctx):
        ch = ctx.channels.get("in", 0)
        return fir_init_state(ch, int(self.settings.get("window")), jnp.float32)

    def apply(self, state, ins, ctx):
        y, st = fir_apply(ins["in"], self._taps(), state)
        return st, {"out": y}


@register_block("SvdDenoiser")
class SvdDenoiser(Block):
    """Truncated-SVD (Hankel) denoiser per chunk (≈ SvdDenoiser)."""

    IN = (Port("in"),)                    # polymorphic: real or complex IQ
    OUT = (Port("out"),)
    chunk = Setting(default=256, kind="static", limits=(16, 1 << 16))
    window = Setting(default=16, kind="static", limits=(2, 4096))
    rank = Setting(default=2, kind="static", limits=(1, 4096))
    energy_fraction = Setting(default=1.0, kind="static", limits=(0.0, 1.0),
                              description="keep components until this "
                                          "fraction of total σ² energy is "
                                          "covered (≈ SvdFilter.hpp:33 "
                                          "energyFraction)")
    engine = Setting(default="auto", kind="static",
                     choices=("auto", "xla", "jacobi"),
                     description="SVD kernel: XLA QR-iteration or the "
                                 "one-sided Jacobi sweep (static control "
                                 "flow, ≈ reference SVD.hpp); auto = xla")

    @property
    def alignment(self):
        return int(self.settings.get("chunk"))

    def apply(self, state, ins, ctx):
        from ..ops.svd import svd_denoise
        n = int(self.settings.get("chunk"))
        x = ins["in"]
        xw = x.reshape(-1, n)
        eng = str(self.settings.get("engine"))
        if eng == "auto":
            eng = "xla"
        den = jax.vmap(lambda c: svd_denoise(
            c, window=int(self.settings.get("window")),
            rank=int(self.settings.get("rank")),
            energy_fraction=float(self.settings.get("energy_fraction")),
            method=eng))(xw)
        return state, {"out": den.reshape(x.shape)}


@register_block("BurstTaper")
class BurstTaper(Block):
    """Burst ramp-up/down envelope driven by trigger tags (≈ BurstTaper.hpp).

    Tags named ``burst_start``/``burst_stop`` (per step, host sideband) are packed
    into fixed-capacity index arrays (dynamic params) and the envelope is built on
    device — the canonical tag→device data path.
    """

    IN = (Port("in"),)
    OUT = (Port("out"),)
    ramp_len = Setting(default=64, kind="static", limits=(1, 1 << 16))
    shape = Setting(default="raised_cosine", kind="static",
                    choices=("none", "linear", "raised_cosine", "tukey",
                             "gaussian", "mushroom", "mushroom_sine"),
                    description="edge shape family "
                                "(≈ BurstTaper.hpp TaperType)")
    shape_param = Setting(default=0.0, kind="static",
                          description="shape parameter: raised_cosine power, "
                                      "tukey alpha, gaussian sigma (0 → the "
                                      "reference's default per shape)")
    max_bursts_per_step = Setting(default=8, kind="static", limits=(1, 64))

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._starts: list[int] = []
        self._stops: list[int] = []

    def process_tags(self, in_tags, ctx):
        self._starts = [t.index for t in in_tags.get("in", [])
                        if t.map.get(Keys.TRIGGER_NAME) == "burst_start"]
        self._stops = [t.index for t in in_tags.get("in", [])
                       if t.map.get(Keys.TRIGGER_NAME) == "burst_stop"]
        return super().process_tags(in_tags, ctx)

    def prepare_params(self, params):
        params = dict(params)
        cap = int(self.settings.get("max_bursts_per_step"))
        def pack(idxs):
            arr = np.full(cap, -(1 << 30), np.int32)
            for i, v in enumerate(idxs[:cap]):
                arr[i] = v
            return arr
        params["_starts"] = pack(self._starts)
        params["_stops"] = pack(self._stops)
        return params

    def apply(self, state, ins, ctx):
        x = ins["in"]
        n = x.shape[-1]
        ramp_l = int(self.settings.get("ramp_len"))
        from ..ops.estimators import taper_edge
        ramp = jnp.asarray(taper_edge(str(self.settings.get("shape")), ramp_l,
                                      rising=True,
                                      param=float(self.settings.get(
                                          "shape_param"))), jnp.float32)
        idx = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)[:, 0]
        env = jnp.ones(n, jnp.float32)
        starts = jnp.asarray(ctx.params.get("_starts",
                                            np.full(1, -(1 << 30), np.int32)))
        stops = jnp.asarray(ctx.params.get("_stops",
                                           np.full(1, -(1 << 30), np.int32)))
        for k in range(starts.shape[0]):
            off = idx - starts[k]
            ramp_val = ramp[jnp.clip(off, 0, ramp_l - 1)]
            env = jnp.where((off >= 0) & (off < ramp_l), env * ramp_val, env)
        for k in range(stops.shape[0]):
            off = stops[k] - idx  # ramp down *into* the stop index
            ramp_val = ramp[jnp.clip(off, 0, ramp_l - 1)]
            env = jnp.where((off >= 0) & (off < ramp_l), env * ramp_val, env)
        return state, {"out": x * env.astype(jnp.real(x).dtype)}


@register_block("StreamFilter")
class StreamFilter(Block):
    """Trigger-gated stream (≈ StreamFilter, StreamToDataSet.hpp:27).

    The reference emits a *variable-rate* stream containing only the samples
    inside start→stop trigger windows; static shapes forbid that, so the
    device-native form gates out-of-window samples to zero (dense stream, same
    rate) — pair with StreamToDataSet when true extraction is needed. Window
    state carries across steps.
    """

    IN = (Port("in"),)
    OUT = (Port("out"),)
    filter = Setting(default="", kind="static", description="start matcher DSL")
    filter_stop = Setting(default="", kind="static",
                          description="stop matcher ('' → same as start toggles)")
    max_events_per_step = Setting(default=16, kind="static", limits=(1, 256))

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        from ..core.trigger import match_trigger
        self._start = match_trigger(str(self.settings.get("filter") or "^."))
        stop = str(self.settings.get("filter_stop"))
        self._stop = match_trigger(stop) if stop else None
        self._starts: list[int] = []
        self._stops: list[int] = []

    def process_tags(self, in_tags, ctx):
        from ..core.trigger import MatchResult
        self._starts, self._stops = [], []
        toggle_open = None
        for t in sorted(in_tags.get("in", [])):
            if self._stop is None:
                if self._start(t) is MatchResult.MATCHED:
                    if toggle_open is None or not toggle_open:
                        self._starts.append(t.index)
                        toggle_open = True
                    else:
                        self._stops.append(t.index)
                        toggle_open = False
            else:
                if self._start(t) is MatchResult.MATCHED:
                    self._starts.append(t.index)
                if self._stop(t) is MatchResult.MATCHED:
                    self._stops.append(t.index)
        return super().process_tags(in_tags, ctx)

    def prepare_params(self, params):
        params = dict(params)
        cap = int(self.settings.get("max_events_per_step"))
        far = 1 << 30
        def pack(idxs, fill):
            arr = np.full(cap, fill, np.int32)
            for i, v in enumerate(idxs[:cap]):
                arr[i] = v
            return arr
        params["_gate_starts"] = pack(self._starts, far)
        params["_gate_stops"] = pack(self._stops, far)
        return params

    def init_state(self, ctx):
        return jnp.zeros((), jnp.bool_)  # window open at step start?

    def apply(self, state, ins, ctx):
        x = ins["in"]
        n = x.shape[-1]
        idx = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)[:, 0]
        far = np.int32(1 << 30)
        starts = jnp.asarray(ctx.params.get("_gate_starts", np.full(1, far)))
        stops = jnp.asarray(ctx.params.get("_gate_stops", np.full(1, far)))
        # open[i] = state XOR (#starts ≤ i) − (#stops ≤ i) parity bookkeeping:
        n_started = jnp.sum(starts[None, :] <= idx[:, None], axis=1)
        n_stopped = jnp.sum(stops[None, :] <= idx[:, None], axis=1)
        open_now = (state.astype(jnp.int32) + n_started - n_stopped) > 0
        new_state = open_now[-1]
        gate = open_now.astype(jnp.float32)
        if jnp.issubdtype(x.dtype, jnp.complexfloating):
            gate = gate.astype(jnp.complex64)
        return new_state, {"out": x * gate}


class _ExpressionBase(Block):
    """Shared plumbing for the ExprTk-subset expression blocks
    (≈ ExpressionBlocks.hpp:68): the expression string is parsed by
    ``ops.expression`` into an AST and traced straight into XLA — the XLA
    compiler plays the role of the reference's embedded ExprTk JIT.  Free
    parameters a/b/c mirror the reference's ``param_a/b/c`` Annotated
    settings and are *dynamic* (retunable without a recompile)."""

    expression = Setting(default="x", kind="static")
    param_a = Setting(default=1.0, description="free parameter 'a'")
    param_b = Setting(default=0.0, description="free parameter 'b'")
    param_c = Setting(default=0.0, description="free parameter 'c'")

    _ARGS: tuple[str, ...] = ("x",)
    _OUT_VAR = "y"

    # string variables (≈ ExprTk symbol_table.add_stringvar): "k=v,k2=v2";
    # trace-time host values, so changes re-jit at the step boundary like
    # any static setting (a string cannot vary per sample on the device)
    strings = Setting(default="", kind="static",
                      description="expression string variables as "
                                  "'name=value[,name2=value2…]' — trace-"
                                  "time constants (ExprTk stringvar)")

    def __init__(self, name=None, expr_string=None, functions=None,
                 string_vars=None, **settings):
        if expr_string is not None:      # reference setting-name alias
            settings.setdefault("expression", expr_string)
        if string_vars:                  # dict convenience constructor form
            settings.setdefault("strings", ",".join(
                f"{k}={v}" for k, v in string_vars.items()))
        # per-block user functions (≈ ExprTk symbol_table.add_function,
        # ExpressionBlocks.hpp:68): name -> JAX callable (or (fn, arity)),
        # traced into the XLA program; layered over the global
        # ops.expression.register_function registry
        self._user_functions = dict(functions or {})
        super().__init__(name=name, **settings)
        self._compile_expr()

    def _string_vars(self) -> dict[str, str]:
        raw = str(self.settings.get("strings")).strip()
        out: dict[str, str] = {}
        for part in (p for p in raw.split(",") if p.strip()):
            if "=" not in part:
                from ..core.errors import GrError
                raise GrError(f"{self.name}: strings entry {part!r} is not "
                              f"'name=value'")
            k, v = part.split("=", 1)
            out[k.strip()] = v.strip()
        return out

    def _compile_expr(self):
        from ..ops.expression import compile_expression
        self._fn = compile_expression(
            str(self.settings.get("expression")),
            self._ARGS + ("a", "b", "c") + tuple(self._string_vars()),
            out_var=self._OUT_VAR, functions=self._user_functions)

    def on_settings_applied(self, result):
        if "expression" in result.applied or "strings" in result.applied:
            self._compile_expr()

    def _abc(self, ctx) -> dict:
        return {"a": jnp.asarray(ctx.p("param_a", 1.0), jnp.float32),
                "b": jnp.asarray(ctx.p("param_b", 0.0), jnp.float32),
                "c": jnp.asarray(ctx.p("param_c", 0.0), jnp.float32),
                **self._string_vars()}


@register_block("ExpressionSISO")
class ExpressionSISO(_ExpressionBase):
    """y = f(x) per sample (≈ ExpressionSISO, ExpressionBlocks.hpp:68).

    The reference's recursive idiom ``y := y + 0.1*x`` (its doc example of
    an IIR-like update where ``y`` is the previous output) is detected
    statically and compiled into a ``lax.scan`` over the time axis with
    ``y`` carried across scheduler steps; pure expressions stay fully
    vectorized."""

    IN = (Port("in"),)
    OUT = (Port("out"),)
    extra_outputs = Setting(default="", kind="static",
                            description="comma-separated expression variables "
                                        "exposed as additional output ports "
                                        "(multi-output assignment)")

    def __init__(self, name=None, expr_string=None, functions=None,
                 **settings):
        super().__init__(name=name, expr_string=expr_string,
                         functions=functions, **settings)
        extra = [s.strip() for s in
                 str(self.settings.get("extra_outputs")).split(",")
                 if s.strip()]
        if extra:
            missing = [v for v in extra if v not in self._fn.writes]
            if missing:
                from ..core.errors import GrError
                raise GrError(f"extra_outputs {missing} are never assigned "
                              f"by the expression (writes: "
                              f"{sorted(self._fn.writes)})")
            if self._fn.reads_output:
                from ..core.errors import GrError
                raise GrError("extra_outputs cannot combine with the "
                              "recursive y-feedback idiom (the scan carries "
                              "only y)")
            self.out_ports = (Port("out"),
                              *(Port(v) for v in extra))
        self._extra = extra

    def init_state(self, ctx):
        if not self._fn.reads_output:
            return ()
        ch = ctx.channels.get("in", 0)
        return jnp.zeros((ch,) if ch else (), jnp.float32)

    def apply(self, state, ins, ctx):
        x = ins["in"]
        abc = self._abc(ctx)
        if not self._fn.reads_output:
            if self._extra:
                y, env = self._fn.eval_all(x=x, **abc)
                outs = {"out": jnp.broadcast_to(jnp.asarray(y, x.dtype),
                                                x.shape)}
                for v in self._extra:
                    outs[v] = jnp.broadcast_to(
                        jnp.asarray(env[v]).astype(x.dtype), x.shape)
                return state, outs
            return state, {"out": self._fn(x=x, **abc)}

        def step(y_prev, x_n):
            y_new = self._fn(x=x_n, y=y_prev, **abc)
            return y_new, y_new

        xT = jnp.moveaxis(x, -1, 0)          # scan over time
        y_last, yT = jax.lax.scan(step, state, xT)
        return y_last, {"out": jnp.moveaxis(yT, 0, -1)}


@register_block("ExpressionDISO")
class ExpressionDISO(_ExpressionBase):
    """z = f(x, y) over two input streams (≈ ExpressionDISO; the reference
    binds in0→x, in1→y and returns z, ExpressionBlocks.hpp)."""

    IN = (Port("x"), Port("y"))
    OUT = (Port("out"),)
    expression = Setting(default="x + y", kind="static")

    _ARGS = ("x", "y")
    _OUT_VAR = "z"

    def apply(self, state, ins, ctx):
        return state, {"out": self._fn(x=ins["x"], y=ins["y"],
                                       **self._abc(ctx))}


@register_block("ExpressionBulk")
class ExpressionBulk(_ExpressionBase):
    """Whole-span expression over vectors vecIn → vecOut (≈ ExpressionBulk,
    ExpressionBlocks.hpp; reference example ``vecOut := a * vecIn``).

    Vector indexing and ``for (var i := 0; i < N; i += 1) { … }`` loops with
    static bounds are unrolled into the trace; out-of-range accesses raise
    at compile time (≈ the reference's vector_access_runtime_check,
    ExpressionBlocks.hpp:48)."""

    IN = (Port("in"),)
    OUT = (Port("out"),)
    expression = Setting(default="vecOut := vecIn", kind="static")

    _ARGS = ("vecIn", "vecOut", "x")
    _OUT_VAR = "vecOut"

    def apply(self, state, ins, ctx):
        x = ins["in"]
        out = self._fn(vecIn=x, vecOut=jnp.zeros_like(x), x=x,
                       **self._abc(ctx))
        return state, {"out": jnp.broadcast_to(jnp.asarray(out, x.dtype),
                                               x.shape)}


@register_block("SyncBlock")
class SyncBlock(Block):
    """Multi-stream aligner (≈ SyncBlock.hpp:13): shifts each input by a per-port
    skew so matching trigger tags line up. Skews are measured host-side from the
    first matching trigger tag per port and applied on device via dynamic-slice
    over a carried history window (± ``max_skew`` samples).
    """

    n_inputs = Setting(default=2, kind="static", limits=(2, 64))
    max_skew = Setting(default=256, kind="static", limits=(1, 1 << 20))
    trigger = Setting(default="", kind="static",
                      description="trigger_name to align on ('' = any trigger)")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        n = int(self.settings.get("n_inputs"))
        self.in_ports = tuple(Port(f"in{i}") for i in range(n))
        self.out_ports = tuple(Port(f"out{i}") for i in range(n))
        self._skews = np.zeros(n, np.int32)

    def process_tags(self, in_tags, ctx):
        name = str(self.settings.get("trigger"))
        max_skew = int(self.settings.get("max_skew"))
        marks: dict[int, int] = {}
        for i in range(len(self.in_ports)):
            for t in in_tags.get(f"in{i}", []):
                tn = t.map.get(Keys.TRIGGER_NAME)
                if tn is not None and (not name or tn == name):
                    marks[i] = t.index
                    break
        if len(marks) == len(self.in_ports) and marks:
            latest = max(marks.values())
            for i, idx in marks.items():
                self._skews[i] = int(np.clip(latest - idx, 0, max_skew))
        out = {}
        for i in range(len(self.in_ports)):
            out[f"out{i}"] = [t.shifted(int(self._skews[i]))
                              for t in in_tags.get(f"in{i}", [])]
        return out

    def prepare_params(self, params):
        params = dict(params)
        params["_skews"] = self._skews.copy()
        return params

    def init_state(self, ctx):
        m = int(self.settings.get("max_skew"))
        return {f"h{i}": jnp.zeros((m,), ctx.dtype(f"in{i}", jnp.float32))
                for i in range(len(self.in_ports))}

    def apply(self, state, ins, ctx):
        m = int(self.settings.get("max_skew"))
        skews = jnp.asarray(ctx.params.get(
            "_skews", np.zeros(len(self.in_ports), np.int32)))
        outs = {}
        new_state = {}
        for i in range(len(self.in_ports)):
            x = ins[f"in{i}"]
            hist = state[f"h{i}"].astype(x.dtype)
            xc = jnp.concatenate([hist, x], axis=-1)
            start = m - skews[i]  # skew s ⇒ delay by s samples
            outs[f"out{i}"] = jax.lax.dynamic_slice_in_dim(
                xc, start, x.shape[-1], axis=-1)
            new_state[f"h{i}"] = xc[..., -m:]
        return new_state, outs
