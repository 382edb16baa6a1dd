"""Arithmetic blocks (≈ reference blocks/math/Math.hpp, Rotator.hpp).

Add/Subtract/Multiply/Divide over N inputs and the *Const variants, plus the complex
Rotator (NCO frequency shifter). All are pure elementwise vector work that XLA fuses
into neighbors — a chain of these compiles to a single fused kernel, the accelerator analog
of the reference's compile-time BlockMerging (BlockMerging.hpp).
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp
import numpy as np

from ..core.block import Block, Port
from ..core.registry import register_block
from ..core.settings import Setting
from ..ops.signal import (nco_phases, phase_increment, phase_to_frac,
                          complex_exp, complex_exp_ramp)


class _NAry(Block):
    """N-input elementwise reducer; inputs in0..in{N-1} (≈ multi-port Add etc.).

    ``uncertain=True`` runs the reducer on 2-plane (value, sigma) streams with
    first-order Gaussian propagation — the sample type is UncertainValue, as in
    the reference's ``Add<gr::UncertainValue<float>>`` registrations
    (Math.hpp:68-71)."""

    OUT = (Port("out"),)
    n_inputs = Setting(default=2, kind="static", limits=(1, 64))
    uncertain = Setting(default=False, kind="static",
                        description="inputs are 2-plane (value, sigma) streams")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        n = int(self.settings.get("n_inputs"))
        self.in_ports = tuple(Port(f"in{i}") for i in range(n))

    def _reduce(self, vals):
        raise NotImplementedError

    def apply(self, state, ins, ctx):
        if self.settings.get("uncertain"):
            from .uncertain import check_uncertain_channels, uv_join, uv_split
            for p in self.in_ports:
                check_uncertain_channels(ctx, p.name, self.name)
            out = self._reduce([uv_split(ins[p.name]) for p in self.in_ports])
            return state, {"out": uv_join(out)}
        vals = [ins[p.name] for p in self.in_ports]
        return state, {"out": self._reduce(vals)}


@register_block("Add")
class Add(_NAry):
    def _reduce(self, vals):
        out = vals[0]
        for v in vals[1:]:
            out = out + v
        return out


@register_block("Subtract")
class Subtract(_NAry):
    def _reduce(self, vals):
        out = vals[0]
        for v in vals[1:]:
            out = out - v
        return out


@register_block("Multiply")
class Multiply(_NAry):
    def _reduce(self, vals):
        out = vals[0]
        for v in vals[1:]:
            out = out * v
        return out


@register_block("Divide")
class Divide(_NAry):
    def _reduce(self, vals):
        out = vals[0]
        for v in vals[1:]:
            out = out / v
        return out


class _ConstOp(Block):
    """Elementwise op against a constant. With ``uncertain=True`` the stream is
    a 2-plane (value, sigma) pair and the constant itself may carry an
    uncertainty (``value_sigma``) — ≈ the reference's
    ``AddConst<gr::UncertainValue<T>>`` (Math.hpp:25-28), whose constant is an
    UncertainValue."""

    IN = (Port("in"),)
    OUT = (Port("out"),)
    SAMPLE_ACCURATE = frozenset({"value"})   # tag-driven changes hit at index k
    value = Setting(default=1.0, description="constant operand")
    uncertain = Setting(default=False, kind="static",
                        description="stream is a 2-plane (value, sigma) pair")
    value_sigma = Setting(default=0.0, limits=(0.0, None),
                          description="1-sigma uncertainty of the constant "
                                      "(uncertain mode)")

    _OP = staticmethod(lambda x, c: x)

    def apply(self, state, ins, ctx):
        x = ins["in"]
        if self.settings.get("uncertain"):
            from ..utils.uncertain import UncertainValue
            from .uncertain import check_uncertain_channels, uv_join, uv_split
            check_uncertain_channels(ctx, "in", self.name)
            c = UncertainValue(
                jnp.asarray(ctx.p("value", 1.0), jnp.float32),
                jnp.asarray(ctx.p("value_sigma", 0.0), jnp.float32))
            return state, {"out": uv_join(self._OP(uv_split(x), c))}
        return state, {"out": self._OP(
            x, jnp.asarray(ctx.p("value", 1.0)).astype(x.dtype))}


@register_block("AddConst")
class AddConst(_ConstOp):
    _OP = staticmethod(lambda x, c: x + c)


@register_block("SubtractConst")
class SubtractConst(_ConstOp):
    _OP = staticmethod(lambda x, c: x - c)


@register_block("MultiplyConst")
class MultiplyConst(_ConstOp):
    _OP = staticmethod(lambda x, c: x * c)


@register_block("DivideConst")
class DivideConst(_ConstOp):
    _OP = staticmethod(lambda x, c: x / c)


@register_block("Rotator")
class Rotator(Block):
    """Complex NCO frequency shifter: y[n] = x[n]·e^{j2πf/fs·n} (≈ Rotator.hpp:14).

    Integer-NCO phase state (uint32) — drift-free over unbounded streams; the phase
    increment is derived host-side in float64 (prepare_params).
    """

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"),)
    SAMPLE_ACCURATE = frozenset({"frequency_shift"})
    frequency_shift = Setting(default=0.0, unit="Hz",
                              description="rotation frequency (± = direction)")
    # reference surface (Rotator.hpp:33-34): XOR-alternative to
    # frequency_shift; activating it also switches to the reference's
    # pre-increment phase convention (processOne adds the increment BEFORE
    # applying, Rotator.hpp:53) with initial_phase as the chunk offset —
    # the frequency_shift surface keeps this framework's zero-phase-at-
    # sample-0 NCO convention
    phase_increment = Setting(default=0.0, unit="rad",
                              description="radians added per sample "
                                          "(alternative to frequency_shift)")
    initial_phase = Setting(default=0.0, unit="rad")

    def __init__(self, name=None, sample_rate: float | None = None,
                 **settings):
        if "frequency_shift" in settings and "phase_increment" in settings:
            from ..core.errors import GrError
            raise GrError("cannot set both 'frequency_shift' and "
                          "'phase_increment' (XOR, Rotator.hpp:46)")
        self._use_increment = "phase_increment" in settings
        super().__init__(name=name, **settings)
        self._sample_rate_hint = float(sample_rate or 1.0)

    def prepare_params(self, params):
        params = dict(params)
        if self._use_increment:
            inc = float(self.settings.get("phase_increment"))
            frac = inc / (2.0 * np.pi)
            frac -= np.floor(frac)
            params["_dphi"] = np.uint32(round(frac * 4294967296.0)
                                        % 4294967296)
            # pre-increment + initial phase as a constant offset
            params["_phoff"] = np.float32(
                float(self.settings.get("initial_phase")) + inc)
        else:
            params["_dphi"] = phase_increment(
                float(self.settings.get("frequency_shift")),
                self._sample_rate_hint)
            params["_phoff"] = np.float32(
                float(self.settings.get("initial_phase")))
        return params

    def tag_param_ramps(self, events, n):
        """frequency_shift tag at index k → per-sample uint32 phase-increment
        array (the derived param, not the raw Hz value): the NCO switches
        frequency at exactly sample k with continuous phase."""
        fs = self._sample_rate_hint
        f = np.full(n, float(self.settings.get("frequency_shift")), np.float64)
        for k, m in events:
            if "frequency_shift" in m:
                f[min(max(k, 0), n):] = float(m["frequency_shift"])
        frac = f / np.float64(fs)
        frac -= np.floor(frac)
        return {"_dphi": (np.round(frac * 4294967296.0)
                          % 4294967296.0).astype(np.uint32)}

    def init_state(self, ctx):
        self._sample_rate_hint = ctx.sample_rate
        return jnp.zeros((), jnp.uint32)

    def apply(self, state, ins, ctx):
        x = ins["in"]
        n = x.shape[-1]
        dphi = jnp.asarray(ctx.params.get("_dphi", np.uint32(0)), jnp.uint32)
        if dphi.ndim:   # per-sample increments (tag-accurate frequency ramp)
            inc = jnp.cumsum(dphi, dtype=jnp.uint32) - dphi  # exclusive, wraps
            ph = state + inc
            new_phase = state + jnp.sum(dphi, dtype=jnp.uint32)
            y = x * complex_exp(phase_to_frac(ph))
        else:
            new_phase = state + dphi * jnp.uint32(n)
            y = x * complex_exp_ramp(state, dphi, n)
        phoff = jnp.asarray(ctx.params.get("_phoff", np.float32(0.0)),
                            jnp.float32)
        y = jnp.where(phoff != 0.0,
                      y * jnp.exp(1j * phoff).astype(jnp.complex64), y)
        return new_phase, {"out": y.astype(jnp.complex64)}

    def apply_sp(self, state, ins, ctx, local_ctx, axis_name):
        """Time-sharded lowering: per-shard integer phase offset (exact, no
        collective); per-sample dphi ramps use the generic island."""
        dphi = ctx.params.get("_dphi", np.uint32(0))
        if jnp.ndim(dphi):
            return super().apply_sp(state, ins, ctx, local_ctx, axis_name)
        from ..parallel.halo import nco_shard_apply
        # NOTE: nco_shard_apply re-enters self.apply with the full params
        # (including _phoff), so the phase offset is already applied — no
        # post-multiply here (it would double the offset on the sp path)
        return nco_shard_apply(self, state, ins, local_ctx, axis_name,
                               jnp.asarray(dphi, jnp.uint32),
                               ins["in"].shape[-1])


@register_block("Abs")
class Abs(Block):
    IN = (Port("in"),)
    OUT = (Port("out"),)

    def out_dtype(self, port, in_dtypes):
        dt = next(iter(in_dtypes.values()), jnp.float32)
        return jnp.float32 if np.dtype(dt) == np.dtype(np.complex64) else dt

    def apply(self, state, ins, ctx):
        return state, {"out": jnp.abs(ins["in"])}


@register_block("Conjugate")
class Conjugate(Block):
    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"),)

    def apply(self, state, ins, ctx):
        return state, {"out": jnp.conj(ins["in"])}


@register_block("Log10")
class Log10(Block):
    """20·k·log10(|x|) convenience block (dB conversion)."""

    IN = (Port("in"),)
    OUT = (Port("out", dtype="float32"),)
    scale = Setting(default=20.0)
    floor = Setting(default=1e-12, kind="static")

    def apply(self, state, ins, ctx):
        x = ins["in"]
        mag = jnp.abs(x) if jnp.issubdtype(x.dtype, jnp.complexfloating) else x
        f = float(self.settings.get("floor"))
        y = jnp.asarray(ctx.p("scale", 20.0), jnp.float32) * \
            jnp.log10(jnp.maximum(mag.astype(jnp.float32), f))
        return state, {"out": y}
