"""Filter blocks (≈ reference blocks/filter/time_domain_filter.hpp).

``FirFilter`` (:24 fir_filter), ``IirFilter`` (:64, direct-form), ``BasicFilter`` /
``BasicDecimatingFilter`` auto-designed from FilterTool (:131-211), ``Decimator``
(:216), ``FreqXlatingFir`` (channel extraction). FIR runs overlap-save (conv, FFT
or banded matmul per backend, ops/fir.py); IIR runs per-channel scan (ops/iir.py).
"""

from __future__ import annotations

from fractions import Fraction
from typing import Any

import jax.numpy as jnp
import numpy as np

from ..core.block import Block, Port
from ..core.errors import GrError
from ..core.registry import register_block
from ..core.settings import Setting
from ..ops import filter_design as fd
from ..ops.fir import fir_apply, fir_init_state, freq_xlating_taps


@register_block("FirFilter")
class FirFilter(Block):
    """Overlap-save FIR with optional decimation (≈ fir_filter + Decimator fused).

    State carries the last ``ntaps-1`` inputs (the HistoryBuffer analog).
    """

    IN = (Port("in"),)
    OUT = (Port("out"),)
    taps = Setting(default=(1.0,), kind="static", description="FIR taps b[k]")
    decim = Setting(default=1, kind="static", limits=(1, 1 << 16))
    precision = Setting(default="auto", kind="static",
                        choices=("auto", "default", "high", "highest",
                                 "bf16", "int8"),
                        description="matmul precision for this block's matmuls: "
                                    "auto → process-wide mode "
                                    "(GR4_FIR_PRECISION, default highest "
                                    "= f32; high may be TF32 on a GPU); "
                                    "bf16 = one pass (~50 dB), "
                                    "int8 ≈ 40 dB — per-link SNR budgeting. "
                                    "Explicit rungs need the matmul path "
                                    "(host taps, ntaps<=512) and raise "
                                    "GrError otherwise; 'auto' falls back "
                                    "to fft/conv at full precision")
    uncertain = Setting(default=False, kind="static",
                        description="input is a 2-plane (value, sigma) stream; "
                                    "sigma propagates as sqrt(fir(sigma^2, "
                                    "taps^2)) — the uncorrelated first-order "
                                    "rule of the reference's "
                                    "fir_filter<UncertainValue<T>> "
                                    "(time_domain_filter.hpp:213)")

    def __init__(self, name=None, taps: Any = None, **settings):
        if taps is not None:
            settings["taps"] = tuple(np.asarray(taps).tolist())
        super().__init__(name=name, **settings)

    @property
    def ratio(self):
        return Fraction(1, int(self.settings.get("decim")))

    @property
    def alignment(self):
        return int(self.settings.get("decim"))

    def _taps_array(self):
        t = np.asarray(self.settings.get("taps"))
        if t.size == 0:
            t = np.ones(1)  # identity filter when no taps configured
        return t.astype(np.complex64 if np.iscomplexobj(t) else np.float32)

    def out_dtype(self, port, in_dtypes):
        t = self._taps_array()
        up = next(iter(in_dtypes.values()), np.float32)
        if np.iscomplexobj(t) or np.dtype(up) == np.dtype(np.complex64):
            return jnp.complex64
        return up

    def init_state(self, ctx):
        t = self._taps_array()
        in_dt = np.dtype(ctx.dtype("in", jnp.float32))
        # history follows the STREAM dtype — a real stream with complex taps
        # stays real through every lowering (ops/fir.py keeps the real rail)
        dt = jnp.complex64 if in_dt == np.dtype(np.complex64) \
            else jnp.dtype(in_dt)
        ch = ctx.channels.get("in", 0)
        return fir_init_state(ch, len(t), dt)

    def apply(self, state, ins, ctx):
        x = ins["in"]
        d = int(self.settings.get("decim"))
        if self.settings.get("uncertain"):
            from .uncertain import check_uncertain_channels
            check_uncertain_channels(ctx, "in", self.name)
            t = self._taps_array()
            if np.iscomplexobj(t):
                raise GrError(f"{self.name}: uncertain mode needs real taps")
            # state holds the raw input planes (value, sigma) — same layout as
            # the plain path, so halo sharding and checkpoints are unchanged
            uprec = str(self.settings.get("precision"))
            uprec = None if uprec == "auto" else uprec
            yv, hv = fir_apply(x[..., 0, :], t, state[..., 0, :], decim=d,
                               precision=uprec)
            s2, hs = fir_apply(jnp.square(x[..., 1, :]), (t * t),
                               jnp.square(state[..., 1, :]), decim=d,
                               precision=uprec)
            y = jnp.stack([yv, jnp.sqrt(jnp.maximum(s2, 0.0))], axis=-2)
            new_state = jnp.stack([hv, jnp.sqrt(jnp.maximum(hs, 0.0))], axis=-2)
            return new_state, {"out": y}
        prec = str(self.settings.get("precision"))
        y, new_state = fir_apply(x, self._taps_array(), state, decim=d,
                                 precision=None if prec == "auto" else prec)
        return new_state, {"out": y}

    def sp_halo(self, ctx):
        """Time-shardable: state is exactly the last ntaps−1 raw inputs, so the
        default ppermute-halo lowering applies (per-shard lengths are
        decim-divisible by the rate algebra's shard alignment)."""
        return len(self._taps_array()) - 1


@register_block("FreqXlatingFir")
class FreqXlatingFir(FirFilter):
    """Frequency-translating FIR: heterodyne + low-pass + decimate in one pass
    (taps rotated by center_freq; output de-rotated by the decimated NCO).
    ≈ GNU Radio's freq_xlating_fir; reference analog: IQDemodulator front-end."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"),)
    center_freq = Setting(default=0.0, kind="static", unit="Hz")
    sample_rate_in = Setting(default=0.0, kind="static", unit="Hz",
                             description="0 → inherit resolved edge rate")
    f_cut = Setting(default=0.0, kind="static", unit="Hz",
                    description="> 0 → auto-design a lowpass prototype at the "
                                "resolved rate instead of explicit taps "
                                "(YAML-friendly, like BasicFilter)")
    ntaps = Setting(default=121, kind="static", limits=(1, 1 << 16),
                    description="prototype length when f_cut is set")
    window = Setting(default="Hamming", kind="static")

    def _fs(self, ctx_rate: float = 1.0) -> float:
        fs = float(self.settings.get("sample_rate_in"))
        return fs if fs > 0 else ctx_rate

    def _prec(self):
        p = str(self.settings.get("precision"))
        return None if p == "auto" else p

    _fs_cached: float = 1.0

    def _taps_array(self):
        f_cut = float(self.settings.get("f_cut"))
        if f_cut > 0.0:
            return fd.design_fir(
                "lowpass", int(self.settings.get("ntaps")),
                sample_rate=self._fs(self._fs_cached), f_low=f_cut,
                window=self.settings.get("window")).astype(np.float32)
        return super()._taps_array()

    def _rotated_taps(self, fs: float):
        self._fs_cached = fs
        base = np.asarray(self._taps_array(), dtype=np.float64)
        return freq_xlating_taps(base, float(self.settings.get("center_freq")), fs)

    def init_state(self, ctx):
        self._fs_cached = ctx.sample_rate     # design rate for f_cut mode
        ntaps = len(self._taps_array())
        ch = ctx.channels.get("in", 0)
        # complex input → rotate-then-filter path: history holds ROTATED
        # samples (complex64). Real input → heterodyned-taps path: history is
        # the raw real stream (no zero imaginary rail through the matmuls).
        in_dt = np.dtype(ctx.dtype("in", np.complex64))
        dt = jnp.complex64 if in_dt == np.dtype(np.complex64) else jnp.float32
        hist = fir_init_state(ch, ntaps, dt)
        return {"hist": hist, "phase": jnp.zeros((), jnp.uint32)}

    def rotation_descriptor(self, ctx_rate: float):
        """Compiler rotation-absorption hook. ``dphi_out`` is the uint32
        increment of the SKIPPED de-rotation: consumers must RE-APPLY
        e^{j·2π·frac32(m·dphi_out)/2³²} per output sample m (equivalently,
        the raw output carries the conjugate residual), plus a step/shard-
        constant phase all absorbing consumers are invariant to. See
        FFT._rotation_window and QuadratureDemod.apply for the two
        reference consumers."""
        from ..ops.signal import phase_increment
        fc = float(self.settings.get("center_freq"))
        if fc == 0.0:
            return None
        decim = int(self.settings.get("decim"))
        return {"dphi_out": int(phase_increment(-fc * decim,
                                                self._fs(ctx_rate)))}

    def apply(self, state, ins, ctx):
        from ..ops.signal import complex_exp_ramp, phase_increment
        x = ins["in"]
        fs = self._fs(ctx.sample_rate)
        decim = int(self.settings.get("decim"))
        fc = float(self.settings.get("center_freq"))
        if getattr(self, "_rotation_absorbed", False) and fc != 0.0:
            # every consumer absorbs the residual rotation: heterodyned-taps
            # FIR with NO NCO pass anywhere (the de-rotation's phase0 term is
            # step-constant; absorbers are invariant to it). History = raw x.
            xt = x.astype(jnp.complex64 if jnp.issubdtype(
                x.dtype, jnp.complexfloating) else jnp.float32)
            y, hist = fir_apply(xt, self._rotated_taps(fs),
                                state["hist"].astype(xt.dtype), decim=decim,
                                precision=self._prec())
            return ({"hist": hist.astype(state["hist"].dtype),
                     "phase": state["phase"]},
                    {"out": y.astype(jnp.complex64)})
        if fc == 0.0:
            # no translation: both NCO ramps are identically 1 (dphi = 0 and
            # the phase state never leaves its initial 0) — plain FIR, no
            # elementwise pass over the stream (config-3's channel filter)
            self._fs_cached = fs
            xt = x.astype(jnp.complex64 if jnp.issubdtype(
                x.dtype, jnp.complexfloating) else jnp.float32)
            y, hist = fir_apply(xt, self._taps_array(),
                                state["hist"].astype(xt.dtype), decim=decim,
                                precision=self._prec())
            return ({"hist": hist.astype(state["hist"].dtype),
                     "phase": state["phase"]},
                    {"out": y.astype(jnp.complex64)})
        if jnp.issubdtype(x.dtype, jnp.complexfloating):
            # Rotate-then-filter: the heterodyned-taps form's output
            # de-rotation cancels the tap heterodyne EXACTLY —
            #   e^{-jωn}·Σₖ h[k]e^{jωk} x[n−k] = Σₖ h[k]·(x·e^{-jω·})[n−k]
            # — so rotating the INPUT (O(√n)-transcendental factored-ramp NCO,
            # a fused elementwise pass) lets the FIR run with REAL taps:
            # 4 banded matmul dots instead of 8. History carries the rotated
            # stream; the uint32 phase accumulates at the INPUT rate.
            x = x.astype(jnp.complex64)
            n_in = x.shape[-1]
            dphi = phase_increment(-fc, fs)
            # measured on-device: the materialized-ramp multiply beats both
            # the broadcast-fused nco_rotate (2.30 ms) and the 8-dot
            # heterodyned-taps form + derotate (~2.1 ms) at 1.70 ms / 8 Mi
            xr = (x * complex_exp_ramp(state["phase"], dphi, n_in)
                  ).astype(jnp.complex64)
            self._fs_cached = fs              # design rate for f_cut mode
            y, hist = fir_apply(xr, self._taps_array(),
                                state["hist"].astype(jnp.complex64),
                                decim=decim, precision=self._prec())
            new_phase = state["phase"] \
                + jnp.asarray(dphi, jnp.uint32) * jnp.uint32(n_in)
            return ({"hist": hist, "phase": new_phase},
                    {"out": y.astype(jnp.complex64)})
        # Real input: heterodyned complex taps over the REAL rail (4 dots) +
        # de-rotation at the decimated output rate (n/decim NCO samples).
        y, hist = fir_apply(x.astype(jnp.float32), self._rotated_taps(fs),
                            state["hist"].astype(jnp.float32), decim=decim,
                            precision=self._prec())
        n_out = y.shape[-1]
        dphi = phase_increment(-fc * decim, fs)
        y = (y * complex_exp_ramp(state["phase"], dphi, n_out)
             ).astype(jnp.complex64)
        new_phase = state["phase"] + jnp.asarray(dphi, jnp.uint32) * jnp.uint32(n_out)
        return {"hist": hist, "phase": new_phase}, {"out": y}

    def apply_sp(self, state, ins, ctx, local_ctx, axis_name):
        """Time-sharded lowering: FIR history via ppermute halo; the NCO phase
        is position-dependent, so each shard offsets its start phase by its
        global position (integer phase wraps mod 2³² exactly). Complex input
        rotates BEFORE the halo exchange (the carried tail is the rotated
        stream, matching ``apply``'s history)."""
        import jax
        from ..ops.signal import complex_exp_ramp, phase_increment
        from ..parallel.halo import halo_left, last_shard_tail
        x = ins["in"]
        h = len(self._taps_array()) - 1
        fs = self._fs(ctx.sample_rate)
        decim = int(self.settings.get("decim"))
        fc = float(self.settings.get("center_freq"))
        idx = jax.lax.axis_index(axis_name)
        size = jax.lax.axis_size(axis_name)
        absorbed = getattr(self, "_rotation_absorbed", False) and fc != 0.0
        if fc == 0.0 or absorbed:
            # fc=0: both NCO ramps are 1. Absorbed: consumers handle the
            # residual rotation (it is linear in the GLOBAL index, which is
            # exactly the form absorbers are built for) — either way the FIR
            # runs raw with a ppermute halo and no elementwise pass.
            xt = x.astype(jnp.complex64 if jnp.issubdtype(
                x.dtype, jnp.complexfloating) else jnp.float32)
            taps = self._rotated_taps(fs) if absorbed else self._taps_array()
            self._fs_cached = fs
            halo = halo_left(xt, h, axis_name,
                             state["hist"].astype(xt.dtype)) \
                if h > 0 else xt[..., :0]
            y, _ = fir_apply(xt, taps, halo, decim=decim,
                             precision=self._prec())
            tail = last_shard_tail(xt, h, axis_name)
            return ({"hist": tail.astype(state["hist"].dtype),
                     "phase": state["phase"]},
                    {"out": y.astype(jnp.complex64)})
        if jnp.issubdtype(x.dtype, jnp.complexfloating):
            x = x.astype(jnp.complex64)
            n_in = x.shape[-1]
            dphi = jnp.asarray(phase_increment(-fc, fs), jnp.uint32)
            phase0 = state["phase"] + dphi * (idx * n_in).astype(jnp.uint32)
            xr = (x * complex_exp_ramp(phase0, dphi, n_in)
                  ).astype(jnp.complex64)
            self._fs_cached = fs              # design rate for f_cut mode
            halo = halo_left(xr, h, axis_name,
                             state["hist"].astype(xr.dtype)) \
                if h > 0 else xr[..., :0]
            y, _ = fir_apply(xr, self._taps_array(), halo, decim=decim,
                             precision=self._prec())
            tail = last_shard_tail(xr, h, axis_name)
            new_phase = state["phase"] + dphi * jnp.uint32(size * n_in)
            return ({"hist": tail.astype(state["hist"].dtype),
                     "phase": new_phase},
                    {"out": y.astype(jnp.complex64)})
        x = x.astype(jnp.float32)
        halo = halo_left(x, h, axis_name, state["hist"].astype(x.dtype)) \
            if h > 0 else x[..., :0]
        y, _ = fir_apply(x, self._rotated_taps(fs), halo, decim=decim,
                         precision=self._prec())
        n_out = y.shape[-1]
        dphi = jnp.asarray(phase_increment(-fc * decim, fs), jnp.uint32)
        phase0 = state["phase"] + dphi * (idx * n_out).astype(jnp.uint32)
        y = (y * complex_exp_ramp(phase0, dphi, n_out)).astype(jnp.complex64)
        tail = last_shard_tail(x, h, axis_name)
        new_phase = state["phase"] + dphi * jnp.uint32(size * n_out)
        return ({"hist": tail.astype(state["hist"].dtype),
                 "phase": new_phase}, {"out": y})


@register_block("IQDemodulator")
class IQDemodulator(FreqXlatingFir):
    """RF → decimated complex baseband in one block (≈ reference IQDemodulator,
    blocks/filter FrequencyEstimator.hpp, Resampling<1024,1>): heterodyne at
    ``center_freq``, anti-alias low-pass, decimate by ``decim``. Taps are
    auto-designed (windowed-sinc, cutoff 0.4·fs/decim, 8·decim+1 taps) unless
    given explicitly. Accepts real or complex input."""

    IN = (Port("in"),)   # real RF or complex IF both work
    OUT = (Port("out", dtype="complex64"),)
    taps = Setting(default=(), kind="static",
                   description="anti-alias taps; empty → auto-designed")

    def _taps_array(self):
        user = np.asarray(self.settings.get("taps"))
        if user.size:   # explicit taps win over the auto design
            return super()._taps_array()
        if getattr(self, "_auto_taps", None) is None:
            from ..ops.filter_design import design_fir
            d = int(self.settings.get("decim"))
            ntaps = 8 * d + 1
            self._auto_taps = design_fir(
                "lowpass", ntaps, sample_rate=1.0, f_low=0.4 / max(d, 1),
                window="Hamming").astype(np.float32)
        return self._auto_taps


@register_block("LockInDemodulator")
class LockInDemodulator(Block):
    """Dual-channel lock-in / transfer-function analyzer (≈ the reference's
    two-input ``IQDemodulator``, blocks/filter FrequencyEstimator.hpp:
    Resampling<1024,1> with amp/phase/frequency outputs — our single-input
    heterodyne block keeps the ``IQDemodulator`` name, so the reference's
    dual-input instantiation lives here).

    Per ``chunk`` input samples, one sample on each output: the response/
    reference amplitude ratio, their phase difference (radians or degrees,
    optionally inverted) and the reference frequency. Device-native math: both
    chunks FFT together; the reference's dominant (non-DC) bin carries both
    complex coefficients, so window scalloping and DC offsets cancel in the
    ratio — |S_k|/|R_k| and arg(S_k R̄_k) need no HP/LP settling, and the
    frequency comes from parabolic interpolation around k."""

    IN = (Port("ref", dtype="float32"), Port("resp", dtype="float32"))
    OUT = (Port("amp", dtype="float32"), Port("phase", dtype="float32"),
           Port("freq", dtype="float32"))
    chunk = Setting(default=1024, kind="static", limits=(8, 1 << 24))
    phase_unit = Setting(default="radians", kind="static",
                         choices=("radians", "degrees"))
    invert_phase = Setting(default=False, kind="static")

    @property
    def ratio(self):
        return Fraction(1, int(self.settings.get("chunk")))

    @property
    def alignment(self):
        return int(self.settings.get("chunk"))

    def apply(self, state, ins, ctx):
        n = int(self.settings.get("chunk"))
        fs = ctx.sample_rate
        ref = ins["ref"].reshape(*ins["ref"].shape[:-1], -1, n)
        resp = ins["resp"].reshape(*ins["resp"].shape[:-1], -1, n)
        r = jnp.fft.rfft(ref, axis=-1)
        s = jnp.fft.rfft(resp, axis=-1)
        mag = jnp.abs(r).at[..., 0].set(0.0)      # ignore DC
        k = jnp.argmax(mag, axis=-1)
        km = jnp.clip(k, 1, n // 2 - 1)
        take = lambda a, idx: jnp.take_along_axis(a, idx[..., None],
                                                  axis=-1)[..., 0]
        rk, sk = take(r, km), take(s, km)
        amp = jnp.abs(sk) / jnp.maximum(jnp.abs(rk), 1e-30)
        ph = jnp.angle(sk * jnp.conj(rk))
        if bool(self.settings.get("invert_phase")):
            ph = -ph
        if str(self.settings.get("phase_unit")) == "degrees":
            ph = ph * jnp.float32(180.0 / np.pi)
        # parabolic peak interpolation for the reference frequency
        a = take(mag, km - 1)
        b = take(mag, km)
        c = take(mag, km + 1)
        denom = a - 2 * b + c
        d = jnp.where(jnp.abs(denom) > 1e-20, 0.5 * (a - c) / denom, 0.0)
        freq = (km.astype(jnp.float32) + d) * (fs / n)
        return state, {"amp": amp.astype(jnp.float32),
                       "phase": ph.astype(jnp.float32),
                       "freq": freq.astype(jnp.float32)}


@register_block("Decimator")
class Decimator(Block):
    """Keep every N-th sample (≈ Decimator, time_domain_filter.hpp:216)."""

    IN = (Port("in"),)
    OUT = (Port("out"),)
    decim = Setting(default=1, kind="static", limits=(1, 1 << 20))

    @property
    def ratio(self):
        return Fraction(1, int(self.settings.get("decim")))

    @property
    def alignment(self):
        return int(self.settings.get("decim"))

    def apply(self, state, ins, ctx):
        d = int(self.settings.get("decim"))
        return state, {"out": ins["in"][..., ::d]}


@register_block("BasicFilter")
class BasicFilter(FirFilter):
    """Auto-designed FIR from high-level parameters (≈ BasicFilter,
    time_domain_filter.hpp:131): set filter_type/f_low/f_high/ntaps/window and the
    taps are designed at compile time via ops.filter_design."""

    filter_type = Setting(default="lowpass", kind="static",
                          choices=("lowpass", "highpass", "bandpass", "bandstop"))
    f_low = Setting(default=0.1, kind="static", unit="Hz")
    f_high = Setting(default=0.0, kind="static", unit="Hz")
    ntaps = Setting(default=127, kind="static", limits=(1, 1 << 16))
    window = Setting(default="Hamming", kind="static")
    sample_rate_design = Setting(default=0.0, kind="static",
                                 description="0 → inherit resolved edge rate")

    def _design(self, fs: float) -> np.ndarray:
        fh = float(self.settings.get("f_high")) or None
        return fd.design_fir(self.settings.get("filter_type"),
                             int(self.settings.get("ntaps")),
                             sample_rate=fs, f_low=float(self.settings.get("f_low")),
                             f_high=fh, window=self.settings.get("window"))

    def _taps_array(self):
        fs = float(self.settings.get("sample_rate_design")) or self._fs_cached
        return self._design(fs).astype(np.float32)

    def init_state(self, ctx):
        self._fs_cached = ctx.sample_rate
        return super().init_state(ctx)

    _fs_cached: float = 1.0


@register_block("BasicDecimatingFilter")
class BasicDecimatingFilter(BasicFilter):
    """BasicFilter + decimation (≈ BasicDecimatingFilter) — just set decim>1."""


@register_block("RationalResampler")
class RationalResampler(Block):
    """L/M polyphase rational resampler (BASELINE config 2).

    Up-by-L as one conv with L feature planes, down-by-M fused into conv stride
    (L==1) or strided slice. Auto-designs Kaiser taps unless given.
    """

    IN = (Port("in"),)
    OUT = (Port("out"),)
    interp = Setting(default=1, kind="static", limits=(1, 1 << 16))
    decim = Setting(default=1, kind="static", limits=(1, 1 << 16))
    taps = Setting(default=(), kind="static")
    ntaps_per_phase = Setting(default=16, kind="static", limits=(2, 1024))

    def _kernel(self):
        from ..ops.resample import RationalResamplerKernel
        t = self.settings.get("taps")
        return RationalResamplerKernel(
            int(self.settings.get("interp")), int(self.settings.get("decim")),
            taps=(np.asarray(t) if t is not None and len(t) else None),
            ntaps_per_phase=int(self.settings.get("ntaps_per_phase")))

    @property
    def ratio(self):
        k = self._kernel()
        return Fraction(k.interp, k.decim)

    @property
    def alignment(self):
        return int(self.settings.get("decim"))

    def init_state(self, ctx):
        k = self._kernel()
        ch = ctx.channels.get("in", 0)
        return k.init_state(ch, ctx.dtype("in", jnp.float32))

    def apply(self, state, ins, ctx):
        k = self._kernel()
        y, st = k.apply(ins["in"], state)
        return st, {"out": y}

    def sp_halo(self, ctx):
        """Time-shardable: the polyphase state is the last ntaps_eff−1 inputs
        and the decimation/interpolation phase restarts cleanly at shard
        boundaries (local lengths are alignment·sp-divisible)."""
        k = self._kernel()
        ntaps_eff = k.k_per_phase if k.interp > 1 else len(k.taps)
        return ntaps_eff - 1


@register_block("IirFilter")
class IirFilter(Block):
    """Direct-form IIR y[n] = Σb·x − Σa·y via per-channel scan (≈ iir_filter,
    time_domain_filter.hpp:64). Sequential recursion is an accelerator's weak
    axis — the scan runs one device loop iteration per sample; for wide-channel
    streams the channel axis provides the parallelism. Biquad-cascade (sos) form
    for numerics."""

    IN = (Port("in", dtype="float32"),)
    OUT = (Port("out", dtype="float32"),)
    b = Setting(default=(1.0,), kind="static", description="feed-forward coeffs")
    a = Setting(default=(1.0,), kind="static", description="feedback coeffs, a[0]=1")
    engine = Setting(default="auto", kind="static",
                     choices=("auto", "scan", "parallel"),
                     description="'parallel': O(log T) associative-scan partial "
                                 "fractions (needs complex-conjugate poles); "
                                 "'scan': one sequential step per sample")
    uncertain = Setting(default=False, kind="static",
                        description="input is a 2-plane (value, sigma) stream; "
                                    "sigma^2 runs the per-op uncorrelated "
                                    "recursion sy2[n] = Σb^2·sx2[n-k] + "
                                    "Σa^2·sy2[n-j] (≈ iir_filter<Uncertain"
                                    "Value<T>>, time_domain_filter.hpp:64); "
                                    "forces the scan engine")

    def __init__(self, name=None, b: Any = None, a: Any = None, **settings):
        if b is not None:
            settings["b"] = tuple(np.asarray(b, dtype=np.float64).tolist())
        if a is not None:
            settings["a"] = tuple(np.asarray(a, dtype=np.float64).tolist())
        super().__init__(name=name, **settings)

    def _engine(self, backend: str | None = None) -> str:
        from ..ops import iir as iir_ops
        from ..ops.filter_design import ba_to_sos
        eng = str(self.settings.get("engine"))
        if eng != "auto":
            return eng
        import jax
        if (backend or jax.default_backend()) == "cpu":
            # a sequential scan is cheap on the host; the parallel form pays
            # its partial-fraction rewrite for no gain there
            return "scan"
        try:
            # accelerators: O(log T) rewrite when the poles allow it — a
            # per-sample scan is one device loop iteration per sample
            # (1 Mi samples through 4 sections: 14 s as a scan, 0.26 ms in
            # parallel form, measured on an H100 at 700 W)
            return "parallel" if iir_ops.sos_supports_parallel(
                ba_to_sos(self.settings.get("b"), self.settings.get("a"))) \
                else "scan"
        except Exception:
            return "scan"

    def init_state(self, ctx):
        from ..ops.iir import iir_init_state, sos_parallel_init_state
        from ..ops.filter_design import ba_to_sos
        ch = ctx.channels.get("in", 0)
        if self.settings.get("uncertain"):
            nb = len(self.settings.get("b"))
            na = len(self.settings.get("a"))
            # per-plane scalar scan states (value path + variance path)
            return {"v": iir_init_state(0, nb, na),
                    "s2": iir_init_state(0, nb, na)}
        eng = self._engine()
        if eng == "parallel":
            sos = ba_to_sos(self.settings.get("b"), self.settings.get("a"))
            return sos_parallel_init_state(ch, sos.shape[0])
        nb = len(self.settings.get("b"))
        na = len(self.settings.get("a"))
        return iir_init_state(ch, nb, na)

    def apply(self, state, ins, ctx):
        from ..ops.iir import iir_apply, sos_parallel_apply
        from ..ops.filter_design import ba_to_sos
        b = np.asarray(self.settings.get("b"), dtype=np.float64)
        a = np.asarray(self.settings.get("a"), dtype=np.float64)
        if self.settings.get("uncertain"):
            from .uncertain import check_uncertain_channels
            check_uncertain_channels(ctx, "in", self.name)
            x = ins["in"]
            bn, an = b / a[0], a / a[0]
            yv, sv = iir_apply(x[..., 0, :], bn, an, state["v"])
            # variance recursion: sy2 = Σ bn² sx2 − Σ (−an²) sy2
            av = np.concatenate([[1.0], -np.square(an[1:])])
            s2, ss = iir_apply(jnp.square(x[..., 1, :]), np.square(bn), av,
                               state["s2"])
            y = jnp.stack([yv, jnp.sqrt(jnp.maximum(s2, 0.0))], axis=-2)
            return {"v": sv, "s2": ss}, {"out": y}
        eng = self._engine()
        if eng == "parallel":
            y, new_state = sos_parallel_apply(ins["in"], ba_to_sos(b, a), state)
        else:
            y, new_state = iir_apply(ins["in"], b, a, state)
        return new_state, {"out": y}
