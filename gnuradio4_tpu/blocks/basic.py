"""Basic blocks (≈ reference blocks/basic/).

SignalGenerator (SignalGenerator.hpp:25), Selector N×M router (Selector.hpp:15),
converter blocks (ConverterBlocks.hpp: Convert, ScalingConvert, Abs/Real/Imag/Arg,
complex↔interleaved/RealImag, deg↔rad).
"""

from __future__ import annotations

from fractions import Fraction
from typing import Any

import jax.numpy as jnp
import numpy as np

from ..core.block import Block, Port, SourceBlock
from ..core.registry import register_block
from ..core.settings import Setting
from ..core.stream import canonical_dtype
from ..ops.signal import (NOISE_WAVEFORMS, WAVEFORMS,
                          nco_phases, phase_increment, phase_to_frac,
                          waveform, complex_exp, complex_exp_ramp)


@register_block("SignalGenerator")
class SignalGenerator(SourceBlock):
    """Waveform source with drift-free integer-NCO phase (≈ SignalGenerator.hpp:25).

    settings: signal ∈ {Const,Sin,Cos,Square,Saw,Triangle,FastSin,FastCos,
    UniformNoise,TriangularNoise,GaussianNoise} (the reference's full type
    list, SignalGenerator.hpp:18), frequency [Hz], amplitude, offset,
    phase [rad], sample_rate [Hz], n_samples (0=∞), seed (noise types).
    Noise conventions match NoiseGenerator.hpp: Uniform/Triangular on
    [−A, +A) + O, Gaussian N(0, A²) + O; generated on-device (threefry).
    """

    OUT = (Port("out"),)
    signal = Setting(default="Sin", kind="static",
                     choices=WAVEFORMS + NOISE_WAVEFORMS)
    dtype = Setting(default="float32", kind="static",
                    choices=("float32", "int8", "int16", "int32", "uint8",
                             "uint16", "uint32", "complex64"),
                    description="output sample type: integers saturate like "
                                "the reference's SignalGeneratorCore<T> "
                                "(qa_SignalGeneratorCore int8/uint8 clamps); "
                                "complex64 emits the analytic signal for the "
                                "sinusoids (|z| = amplitude) and zero "
                                "imaginary otherwise")
    seed = Setting(default=0, kind="static",
                   description="PRNG seed for the noise signal types")
    frequency = Setting(default=1.0, unit="Hz")
    amplitude = Setting(default=1.0)
    offset = Setting(default=0.0)
    phase = Setting(default=0.0, unit="rad")
    sample_rate = Setting(default=0.0, unit="Hz",
                          description="0 → inherit scheduler sample_rate")
    n_samples = Setting(default=0, kind="static", description="0 = unbounded")
    channels = Setting(default=0, kind="static")

    def out_channels(self, port, in_channels):
        return int(self.settings.get("channels"))

    def out_dtype(self, port, in_dtypes):
        return canonical_dtype(self.settings.get("dtype"))

    def _cast_out(self, y: jnp.ndarray) -> jnp.ndarray:
        """Saturating cast to the configured output type
        (≈ SignalGeneratorCore<T>'s double→T saturate, qa:94-196)."""
        dt = canonical_dtype(self.settings.get("dtype"))
        if jnp.issubdtype(dt, jnp.integer):
            info = np.iinfo(dt)
            return jnp.clip(jnp.round(y), info.min, info.max).astype(dt)
        return y.astype(dt)

    def _fs(self, ctx_rate: float) -> float:
        fs = float(self.settings.get("sample_rate"))
        return fs if fs > 0 else ctx_rate

    def _is_noise(self) -> bool:
        return str(self.settings.get("signal")).endswith("Noise")

    def init_state(self, ctx):
        self._ctx_rate = ctx.sample_rate
        if self._is_noise():
            from ..ops.noise import noise_init_state
            return noise_init_state(int(self.settings.get("seed")))
        return jnp.zeros((), jnp.uint32)

    def prepare_params(self, params):
        params = dict(params)
        fs = self._fs(getattr(self, "_ctx_rate", 1.0))
        params["_dphi"] = phase_increment(float(self.settings.get("frequency")), fs)
        ph0 = float(self.settings.get("phase")) / (2.0 * np.pi)
        params["_phase0_u32"] = np.uint32(int((ph0 % 1.0) * 4294967296.0))
        return params

    def host_done(self, abs_out, n):
        total = int(self.settings.get("n_samples"))
        if total and abs_out + n >= total:
            return max(0, total - abs_out)
        return None

    def apply(self, state, ins, ctx):
        n = ctx.out_len["out"]
        ch = ctx.channels["out"]
        amp = jnp.asarray(ctx.p("amplitude", 1.0), jnp.float32)
        off = jnp.asarray(ctx.p("offset", 0.0), jnp.float32)
        if self._is_noise():
            from ..ops import noise as nz
            shape = (n,) if ch == 0 else (ch, n)
            kind = str(self.settings.get("signal"))
            if kind == "UniformNoise":
                y, key = nz.uniform(state, shape, low=-1.0, high=1.0)
            elif kind == "TriangularNoise":
                y, key = nz.triangular(state, shape)
            else:
                y, key = nz.gaussian(state, shape)
            return key, {"out": self._cast_out(amp * y + off)}
        dphi = jnp.asarray(ctx.params.get("_dphi", np.uint32(0)), jnp.uint32)
        ph0 = jnp.asarray(ctx.params.get("_phase0_u32", np.uint32(0)), jnp.uint32)
        ph = nco_phases(state + ph0, dphi, n)
        kind = str(self.settings.get("signal"))
        frac = phase_to_frac(ph)
        if str(self.settings.get("dtype")) == "complex64":
            # analytic signal for the sinusoids: real = the scalar waveform,
            # |z - offset| = amplitude (qa_ToneGenerator fillComplex:99-139);
            # Sin → A·e^{j(θ-π/2)} (real A·sinθ), Cos → A·e^{jθ};
            # non-sinusoidal types carry zero imaginary
            if kind in ("Sin", "FastSin"):
                z = off + amp * complex_exp(frac - jnp.float32(0.25))
            elif kind in ("Cos", "FastCos"):
                z = off + amp * complex_exp(frac)
            else:
                z = (waveform(kind, frac, amplitude=amp, offset=off)
                     + jnp.complex64(0))
            if ch:
                z = jnp.broadcast_to(z, (ch, n))
            return state + dphi * jnp.uint32(n), {"out": z.astype(jnp.complex64)}
        y = waveform(kind, frac, amplitude=amp, offset=off)
        if ch:
            y = jnp.broadcast_to(y, (ch, n))
        return state + dphi * jnp.uint32(n), {"out": self._cast_out(y)}

    def apply_sp(self, state, ins, ctx, local_ctx, axis_name):
        """Time-sharded lowering: the integer-NCO phase is a pure function of
        global sample position, so each shard generates its local segment from
        a position-offset start phase — no halo, no gather island (exact:
        uint32 phase arithmetic wraps identically). Noise signal types run as
        a replicated island (every shard draws the identical full-length
        stream and keeps its slice — sharded == unsharded exactly).
        Per-sample param ramps (arrays) fall back to the island too."""
        if self._is_noise():
            from ..core.block import Block
            return Block.apply_sp(self, state, ins, ctx, local_ctx, axis_name)
        if any(jnp.ndim(ctx.params.get(k, 0.0))
               for k in ("_dphi", "amplitude", "offset")):
            return super().apply_sp(state, ins, ctx, local_ctx, axis_name)
        from ..parallel.halo import nco_shard_apply
        dphi = jnp.asarray(ctx.params.get("_dphi", np.uint32(0)), jnp.uint32)
        n_local = next(iter(local_ctx.out_len.values()))
        return nco_shard_apply(self, state, ins, local_ctx, axis_name,
                               dphi, n_local)


@register_block("ComplexToneSource")
class ComplexToneSource(SignalGenerator):
    """Complex exponential source e^{j2πft/fs} (baseband tone)."""

    OUT = (Port("out", dtype="complex64"),)

    def out_dtype(self, port, in_dtypes):
        return np.dtype("complex64")   # always complex, ignore dtype setting

    def apply(self, state, ins, ctx):
        n = ctx.out_len["out"]
        ch = ctx.channels["out"]
        dphi = jnp.asarray(ctx.params.get("_dphi", np.uint32(0)), jnp.uint32)
        ph0 = jnp.asarray(ctx.params.get("_phase0_u32", np.uint32(0)), jnp.uint32)
        amp = jnp.asarray(ctx.p("amplitude", 1.0), jnp.float32)
        if dphi.ndim == 0 and amp.ndim == 0:
            # factored outer-product NCO: O(√n) transcendentals, HBM-write-
            # bound (round-4 — direct sin/cos cost 18% of the headline chain)
            y = complex_exp_ramp(state + ph0, dphi, n, amplitude=amp)
        else:   # per-sample param ramps (tag-accurate) keep the direct form
            y = complex_exp(phase_to_frac(nco_phases(state + ph0, dphi, n)),
                            amplitude=amp)
        y = y + jnp.asarray(ctx.p("offset", 0.0), jnp.float32).astype(jnp.complex64)
        if ch:
            y = jnp.broadcast_to(y, (ch, n))
        return state + dphi * jnp.uint32(n), {"out": y.astype(jnp.complex64)}


@register_block("NoiseSource")
class NoiseSource(SourceBlock):
    """Gaussian/uniform noise source generated on-device (≈ NoiseGenerator +
    Xoshiro256pp; here counter-based threefry so the device generates in parallel)."""

    OUT = (Port("out"),)
    noise = Setting(default="gaussian", kind="static",
                    choices=("gaussian", "uniform", "triangular",
                             "complex_gaussian"))
    std = Setting(default=1.0, description="std-dev / half-range")
    mean = Setting(default=0.0)
    seed = Setting(default=0, kind="static")
    channels = Setting(default=0, kind="static")
    n_samples = Setting(default=0, kind="static")

    def out_channels(self, port, in_channels):
        return int(self.settings.get("channels"))

    def out_dtype(self, port, in_dtypes):
        return (jnp.complex64 if self.settings.get("noise") == "complex_gaussian"
                else jnp.float32)

    def init_state(self, ctx):
        from ..ops.noise import noise_init_state
        return noise_init_state(int(self.settings.get("seed")))

    def host_done(self, abs_out, n):
        total = int(self.settings.get("n_samples"))
        if total and abs_out + n >= total:
            return max(0, total - abs_out)
        return None

    def apply(self, state, ins, ctx):
        from ..ops import noise as nz
        n = ctx.out_len["out"]
        ch = ctx.channels["out"]
        shape = (n,) if ch == 0 else (ch, n)
        kind = self.settings.get("noise")
        std = jnp.asarray(ctx.p("std", 1.0), jnp.float32)
        mean = jnp.asarray(ctx.p("mean", 0.0), jnp.float32)
        if kind == "gaussian":
            y, key = nz.gaussian(state, shape, std=std, mean=mean)
        elif kind == "uniform":
            y, key = nz.uniform(state, shape, low=mean - std, high=mean + std)
        elif kind == "triangular":
            y, key = nz.triangular(state, shape, half_range=std, mean=mean)
        else:
            y, key = nz.complex_gaussian(state, shape, std=std)
        return key, {"out": y}


@register_block("Selector")
class Selector(Block):
    """N×M stream router (≈ Selector.hpp:15). ``map_in``/``map_out`` pair up
    connections; unrouted outputs emit zeros, unrouted inputs are dropped (the
    reference's back-pressure option is meaningless with fused execution).

    Reference parity extras (Selector.hpp:83-95): an optional ``select``
    input (uint32 stream; the last sample of each step picks the monitored
    input, ≈ ``selectSpan.back()``, Selector.hpp:149) and an optional
    ``monitor`` output mirroring the selected input.  ``selected_src`` is the
    message-settable equivalent when no select stream is connected.

    Fan-in (several inputs mapped to one output) *sums* in this build; the
    reference's round-robin interleave (``sync_combined_ports``,
    Selector.hpp:60-66) is a per-port rate change, which the fused-graph
    model expresses as the dedicated :class:`Interleave` block instead."""

    n_inputs = Setting(default=1, kind="static", limits=(1, 64))
    n_outputs = Setting(default=1, kind="static", limits=(1, 64))
    map_in = Setting(default=(0,), kind="static", description="routing: input idx list")
    map_out = Setting(default=(0,), kind="static", description="routing: output idx list")
    selected_src = Setting(default=0, description="input index mirrored to the "
                                                  "monitor output (≈ _selectedSrc)")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        n_in = int(self.settings.get("n_inputs"))
        n_out = int(self.settings.get("n_outputs"))
        self.in_ports = tuple(Port(f"in{i}") for i in range(n_in)) + (
            Port("select", dtype="uint32", optional=True, asynchronous=True),)
        self.out_ports = tuple(Port(f"out{i}") for i in range(n_out)) + (
            Port("monitor", optional=True),)

    def apply(self, state, ins, ctx):
        m_in = list(self.settings.get("map_in"))
        m_out = list(self.settings.get("map_out"))
        outs = {}
        n_in = int(self.settings.get("n_inputs"))
        example = ins["in0"] if "in0" in ins else next(iter(ins.values()))
        for o in range(int(self.settings.get("n_outputs"))):
            routed = [ins[f"in{i}"] for i, oo in zip(m_in, m_out) if oo == o]
            if routed:
                outs[f"out{o}"] = routed[0] if len(routed) == 1 else sum(routed)
            else:
                outs[f"out{o}"] = jnp.zeros_like(example)
        # monitor: mirror the dynamically selected input (Selector.hpp:239-243)
        sel = jnp.asarray(ctx.p("selected_src", 0), jnp.int32)
        if "select" in ins:
            sel = ins["select"][..., -1].astype(jnp.int32)  # selectSpan.back()
        sel = jnp.clip(sel, 0, n_in - 1)
        stacked = jnp.stack([ins[f"in{i}"] for i in range(n_in)], axis=0)
        outs["monitor"] = jnp.take(stacked, sel, axis=0)
        return state, outs


@register_block("Interleave")
class Interleave(Block):
    """Round-robin stream combiner — the reference Selector's synchronised
    fan-in semantics (Selector.hpp:60-66: inputs mapped to one output emit
    ``in0[0], in1[0], …, in0[1], in1[1], …``) as a dedicated block, because a
    per-port rate change rides the block-level ``ratio`` in the fused-graph
    model.  ``chunk_size`` samples are taken from each input per visit."""

    n_inputs = Setting(default=2, kind="static", limits=(1, 64))
    chunk_size = Setting(default=1, kind="static", limits=(1, None))

    OUT = (Port("out"),)

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self.in_ports = tuple(
            Port(f"in{i}") for i in range(int(self.settings.get("n_inputs"))))

    @property
    def ratio(self) -> Fraction:
        return Fraction(int(self.settings.get("n_inputs")))

    @property
    def alignment(self) -> int:
        return int(self.settings.get("chunk_size"))

    def apply(self, state, ins, ctx):
        k = int(self.settings.get("n_inputs"))
        cs = int(self.settings.get("chunk_size"))
        xs = [ins[f"in{i}"] for i in range(k)]
        t = xs[0].shape[-1]
        # [..., T] per input → [..., T/cs, k, cs] → [..., k·T]
        parts = [x.reshape(*x.shape[:-1], t // cs, 1, cs) for x in xs]
        out = jnp.concatenate(parts, axis=-2)
        return state, {"out": out.reshape(*xs[0].shape[:-1], k * t)}


@register_block("Deinterleave")
class Deinterleave(Block):
    """Round-robin stream splitter (inverse of :class:`Interleave`)."""

    n_outputs = Setting(default=2, kind="static", limits=(1, 64))
    chunk_size = Setting(default=1, kind="static", limits=(1, None))

    IN = (Port("in"),)

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self.out_ports = tuple(
            Port(f"out{i}") for i in range(int(self.settings.get("n_outputs"))))

    @property
    def ratio(self) -> Fraction:
        return Fraction(1, int(self.settings.get("n_outputs")))

    @property
    def alignment(self) -> int:
        return int(self.settings.get("n_outputs")) * \
            int(self.settings.get("chunk_size"))

    def apply(self, state, ins, ctx):
        k = int(self.settings.get("n_outputs"))
        cs = int(self.settings.get("chunk_size"))
        x = ins["in"]
        t = x.shape[-1]
        parts = x.reshape(*x.shape[:-1], t // (k * cs), k, cs)
        return state, {f"out{i}":
                       parts[..., i, :].reshape(*x.shape[:-1], t // k)
                       for i in range(k)}


# -- converters (≈ ConverterBlocks.hpp) ----------------------------------------

@register_block("Convert")
class Convert(Block):
    """dtype cast (≈ Convert<T,U>); target dtype is a static setting."""

    IN = (Port("in"),)
    OUT = (Port("out"),)
    to = Setting(default="float32", kind="static", description="target dtype")

    def out_dtype(self, port, in_dtypes):
        return self.settings.get("to")

    def apply(self, state, ins, ctx):
        return state, {"out": ins["in"].astype(canonical_dtype(self.settings.get("to")))}


@register_block("ScalingConvert")
class ScalingConvert(Convert):
    scale = Setting(default=1.0)

    def apply(self, state, ins, ctx):
        y = ins["in"] * jnp.asarray(ctx.p("scale", 1.0)).astype(ins["in"].dtype)
        return state, {"out": y.astype(canonical_dtype(self.settings.get("to")))}


@register_block("ComplexToReal")
class ComplexToReal(Block):
    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="float32"),)

    def apply(self, state, ins, ctx):
        return state, {"out": jnp.real(ins["in"]).astype(jnp.float32)}


@register_block("ComplexToImag")
class ComplexToImag(Block):
    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="float32"),)

    def apply(self, state, ins, ctx):
        return state, {"out": jnp.imag(ins["in"]).astype(jnp.float32)}


@register_block("ToRealImag")
class ToRealImag(Block):
    """Complex → (real, imag) component streams (≈ ConverterBlocks ToRealImag)."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("real", dtype="float32"), Port("imag", dtype="float32"))

    def apply(self, state, ins, ctx):
        x = ins["in"]
        return state, {"real": jnp.real(x).astype(jnp.float32),
                       "imag": jnp.imag(x).astype(jnp.float32)}


@register_block("ComplexToMagPhase")
class ComplexToMagPhase(Block):
    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("mag", dtype="float32"), Port("phase", dtype="float32"))

    def apply(self, state, ins, ctx):
        x = ins["in"]
        return state, {"mag": jnp.abs(x).astype(jnp.float32),
                       "phase": jnp.angle(x).astype(jnp.float32)}


@register_block("Arg")
class Arg(Block):
    """Complex argument/angle in radians (≈ ConverterBlocks Arg)."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="float32"),)

    def apply(self, state, ins, ctx):
        return state, {"out": jnp.angle(ins["in"]).astype(jnp.float32)}


@register_block("MagPhaseToComplex")
class MagPhaseToComplex(Block):
    """(magnitude, phase) → complex (≈ ConverterBlocks.hpp:219)."""

    IN = (Port("mag", dtype="float32"), Port("phase", dtype="float32"))
    OUT = (Port("out", dtype="complex64"),)

    def apply(self, state, ins, ctx):
        return state, {"out": (ins["mag"] * jnp.exp(1j * ins["phase"])
                               ).astype(jnp.complex64)}


@register_block("RealImagToComplex")
class RealImagToComplex(Block):
    IN = (Port("real", dtype="float32"), Port("imag", dtype="float32"))
    OUT = (Port("out", dtype="complex64"),)

    def apply(self, state, ins, ctx):
        return state, {"out": (ins["real"] + 1j * ins["imag"]).astype(jnp.complex64)}


@register_block("ComplexToInterleaved")
class ComplexToInterleaved(Block):
    """complex64 [T] → float32 [2T] (re,im interleaved); rate 2/1."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="float32"),)

    @property
    def ratio(self):
        from fractions import Fraction
        return Fraction(2, 1)

    def apply(self, state, ins, ctx):
        x = ins["in"]
        y = jnp.stack([jnp.real(x), jnp.imag(x)], axis=-1).reshape(*x.shape[:-1], -1)
        return state, {"out": y.astype(jnp.float32)}


@register_block("InterleavedToComplex")
class InterleavedToComplex(Block):
    IN = (Port("in", dtype="float32"),)
    OUT = (Port("out", dtype="complex64"),)

    @property
    def ratio(self):
        from fractions import Fraction
        return Fraction(1, 2)

    @property
    def alignment(self):
        return 2

    def apply(self, state, ins, ctx):
        x = ins["in"]
        xr = x.reshape(*x.shape[:-1], -1, 2)
        return state, {"out": (xr[..., 0] + 1j * xr[..., 1]).astype(jnp.complex64)}


@register_block("DegToRad")
class DegToRad(Block):
    IN = (Port("in", dtype="float32"),)
    OUT = (Port("out", dtype="float32"),)

    def apply(self, state, ins, ctx):
        return state, {"out": ins["in"] * jnp.float32(np.pi / 180.0)}


@register_block("RadToDeg")
class RadToDeg(Block):
    IN = (Port("in", dtype="float32"),)
    OUT = (Port("out", dtype="float32"),)

    def apply(self, state, ins, ctx):
        return state, {"out": ins["in"] * jnp.float32(180.0 / np.pi)}
