"""SDR demodulation blocks + the wideband-FM receive chain (BASELINE config 3).

≈ reference blocks/filter IQDemodulator (FrequencyEstimator.hpp) and the capability
set of a classic SDR receiver. The WBFM receiver is a nested Graph (subgraph —
exercising GraphWrapper-style composition, reference Graph.hpp:169) built from
FreqXlatingFir → QuadratureDemod → audio decimator → de-emphasis.
"""

from __future__ import annotations

from fractions import Fraction

import jax.numpy as jnp
import numpy as np

from ..core.block import Block, Port, SinkBlock
from ..core.graph import Graph
from ..core.registry import register_block
from ..core.settings import Setting
from ..ops import filter_design as fd
from ..ops.demod import am_demod, fm_deemphasis_coeffs, quadrature_demod


@register_block("QuadratureDemod")
class QuadratureDemod(Block):
    """FM discriminator y[n] = gain·arg(x[n]·x̄[n−1]) (state: one carried sample)."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="float32"),)
    SAMPLE_ACCURATE = frozenset({"gain"})
    # single-reader elementwise consumer: its producer's edge barrier may be
    # skipped under GR4_FUSE_EPILOGUE=1 (compiler epilogue fusion) — the
    # intermediate complex stream then never round-trips HBM
    EPILOGUE_FUSABLE = True
    gain = Setting(default=1.0, description="rad→output scaling (fs/(2π·Δf))")

    def init_state(self, ctx):
        ch = ctx.channels.get("in", 0)
        shape = () if ch == 0 else (ch,)
        return jnp.ones(shape, jnp.complex64)  # x[-1] = 1 (zero phase)

    def absorb_rotation(self, desc, port) -> bool:
        """Rotation-absorption consumer hook: a residual e^{jθ(m)} with θ
        linear in m shifts arg(x[m]·x̄[m−1]) by the CONSTANT Δθ — absorbed as
        a post-demod offset, saving the producer's full-rate NCO pass."""
        return port == "in"

    def apply(self, state, ins, ctx):
        gain = jnp.asarray(ctx.p("gain", 1.0), jnp.float32)
        desc = getattr(self, "_absorbed_rotation", None) or {}
        rot = None
        if "in" in desc:
            # residual per-sample phase increment → constant phasor folded
            # INSIDE arg (exact (−π,π] wrap match with the de-rotated stream)
            frac = (desc["in"]["dphi_out"] % 4294967296) / 4294967296.0
            rot = complex(np.exp(2j * np.pi * frac))
        y, last = quadrature_demod(ins["in"], state, gain=gain, rot=rot)
        return last, {"out": y}

    # time-sharding protocol: one-sample halo; state has no trailing time axis
    def sp_halo(self, ctx):
        return 1

    def sp_state_to_tail(self, state, ctx):
        return state[..., None]

    def sp_tail_to_state(self, tail, state, ctx):
        return tail[..., 0].astype(jnp.complex64)


@register_block("AmDemod")
class AmDemod(Block):
    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="float32"),)
    gain = Setting(default=1.0)

    def apply(self, state, ins, ctx):
        return state, {"out": am_demod(ins["in"],
                                       gain=jnp.asarray(ctx.p("gain", 1.0),
                                                        jnp.float32))}


@register_block("FmDeemphasis")
class FmDeemphasis(Block):
    """Single-pole FM de-emphasis (τ = 75 µs US / 50 µs EU)."""

    IN = (Port("in", dtype="float32"),)
    OUT = (Port("out", dtype="float32"),)
    tau = Setting(default=75e-6, kind="static", unit="s")
    sample_rate_in = Setting(default=0.0, kind="static",
                             description="0 → inherit resolved edge rate")

    def _ba(self, fs: float):
        fs_eff = float(self.settings.get("sample_rate_in")) or fs
        return fm_deemphasis_coeffs(fs_eff, float(self.settings.get("tau")))

    def init_state(self, ctx):
        self._fs_cached = ctx.sample_rate
        ch = ctx.channels.get("in", 0)
        import jax.numpy as jnp
        return jnp.zeros(() if ch == 0 else (ch,), jnp.float32)

    def apply(self, state, ins, ctx):
        # single real pole → exact O(log T) parallel recurrence
        from ..ops.iir import one_pole_ba_apply
        b, a = self._ba(getattr(self, "_fs_cached", ctx.sample_rate))
        y, last = one_pole_ba_apply(ins["in"], b, a, state)
        return last, {"out": y}


def make_wbfm_receiver(*, quad_rate: float, audio_decim: int,
                       center_freq: float = 0.0, channel_width: float = 200e3,
                       max_dev: float = 75e3, rf_decim: int = 1,
                       ntaps: int = 127, deemph_tau: float = 75e-6,
                       name: str = "wbfm") -> Graph:
    """Wideband FM receiver subgraph (BASELINE config 3).

    input: complex baseband at ``quad_rate·rf_decim`` centered ``center_freq`` away
    from the station; output: float32 audio at ``quad_rate/audio_decim``.
    Structure: FreqXlatingFir(channel LP, decim rf_decim) → QuadratureDemod →
    audio low-pass FIR (decim audio_decim) → de-emphasis.
    """
    from .filter import FirFilter, FreqXlatingFir
    g = Graph(name=name)
    fs_in = quad_rate * rf_decim
    chan_taps = fd.design_fir("lowpass", ntaps, sample_rate=fs_in,
                              f_low=channel_width / 2.0)
    xlate = g.add(FreqXlatingFir(taps=chan_taps.astype(np.float32),
                                 center_freq=center_freq, decim=rf_decim,
                                 sample_rate_in=fs_in, name=f"{name}.channel"))
    demod = g.add(QuadratureDemod(gain=quad_rate / (2.0 * np.pi * max_dev),
                                  name=f"{name}.demod"))
    audio_rate = quad_rate / audio_decim
    audio_taps = fd.design_fir("lowpass", ntaps, sample_rate=quad_rate,
                               f_low=min(15e3, 0.4 * audio_rate))
    audio = g.add(FirFilter(taps=audio_taps.astype(np.float32), decim=audio_decim,
                            name=f"{name}.audio"))
    deemph = g.add(FmDeemphasis(tau=deemph_tau, sample_rate_in=audio_rate,
                                name=f"{name}.deemph"))
    g.connect_chain(xlate, demod, audio, deemph)
    g.export_in("in", xlate, "in")
    g.export_out("out", deemph, "out")
    return g


# -- SDR device abstraction (≈ SoapyRaiiWrapper.hpp / LoopbackDevice.hpp) ------

class SdrDevice:
    """Minimal Soapy-shaped device interface: configure → activate → readStream/
    writeStream (complex64 baseband)."""

    def configure(self, *, sample_rate: float, center_frequency: float,
                  gain: float = 0.0, antenna: str = "", bandwidth: float = 0.0,
                  channels: int = 1) -> None:
        self.sample_rate = sample_rate
        self.center_frequency = center_frequency
        self.gain = gain
        self.antenna = antenna
        self.bandwidth = bandwidth
        self.channels = channels

    def activate(self) -> None: ...
    def deactivate(self) -> None: ...

    def read_stream(self, n: int) -> tuple[np.ndarray | None, dict]:
        """Return ([channels?, n] complex64 or None at EOS, info dict with
        optional 'n_dropped_samples' / 'rx_overflow')."""
        raise NotImplementedError

    def write_stream(self, samples: np.ndarray) -> None:
        raise NotImplementedError


class LoopbackDevice(SdrDevice):
    """Fake SDR for tests (≈ blocks/sdr LoopbackDevice.hpp): generates a set of
    tones at absolute RF frequencies; the source sees them mixed to baseband
    around its ``center_frequency``. TX writes are recorded."""

    def __init__(self, tone_freqs=(), tone_amps=(), noise_std: float = 0.0,
                 total_samples: int = 0, seed: int = 1234,
                 waveform: np.ndarray | None = None,
                 waveform_freq: float = 0.0):
        self.tone_freqs = list(tone_freqs)
        self.tone_amps = list(tone_amps) or [1.0] * len(self.tone_freqs)
        self.noise_std = noise_std
        self.total_samples = total_samples
        # optional complex-baseband transmission centered at waveform_freq
        # (absolute RF), repeated cyclically — lets tests put a *modulated*
        # station on the air (≈ LoopbackDevice.hpp fake-radio behavior)
        self.waveform = None if waveform is None else np.asarray(
            waveform, np.complex128)
        self.waveform_freq = waveform_freq
        self._pos = 0
        self._rng = np.random.default_rng(seed)
        self.tx_record: list[np.ndarray] = []
        self.overflows = 0

    def read_stream(self, n):
        if self.total_samples and self._pos >= self.total_samples:
            return None, {}
        if self.total_samples:
            n = min(n, self.total_samples - self._pos)
        t = (self._pos + np.arange(n)) / self.sample_rate
        nch = max(1, getattr(self, "channels", 1))
        out = np.zeros((nch, n), np.complex128)
        for c in range(nch):
            # per-RX-channel phase offset models antenna spacing (MIMO-ish)
            for f, a in zip(self.tone_freqs, self.tone_amps):
                out[c] += a * np.exp(2j * np.pi * (
                    (f - self.center_frequency) * t + 0.1 * c))
        if self.waveform is not None:
            idx = (self._pos + np.arange(n)) % len(self.waveform)
            mix = np.exp(2j * np.pi * (self.waveform_freq
                                       - self.center_frequency) * t)
            out += (self.waveform[idx] * mix)[None, :]
        if self.noise_std:
            out += self.noise_std / np.sqrt(2) * (
                self._rng.standard_normal(out.shape)
                + 1j * self._rng.standard_normal(out.shape))
        out *= 10.0 ** (self.gain / 20.0)
        self._pos += n
        out = out.astype(np.complex64)
        return (out[0] if nch == 1 else out), {}

    def write_stream(self, samples):
        self.tx_record.append(np.array(samples, copy=True))


_SDR_DRIVERS: dict[str, Any] = {"loopback": LoopbackDevice}


def register_sdr_driver(name: str, factory) -> None:
    _SDR_DRIVERS[name] = factory


@register_block("SdrSource")
class SdrSource(Block):
    """Receive stream from an SDR device (≈ SoapySource.hpp:27).

    Emits sample_rate/frequency tags on start; device IO runs on the feed path.
    """

    IN = ()
    OUT = (Port("out", dtype="complex64"),)
    FEED = True
    driver = Setting(default="loopback", kind="static")
    sample_rate = Setting(default=1e6, unit="Hz", kind="static")
    center_frequency = Setting(default=100e6, unit="Hz", kind="static")
    gain = Setting(default=0.0, unit="dB", kind="static")
    antenna = Setting(default="RX", kind="static")
    channels = Setting(default=1, kind="static", limits=(1, 16),
                       description="RX channels (1/2/4 ≈ Soapy variants)")

    def __init__(self, name=None, device: SdrDevice | None = None, **settings):
        super().__init__(name=name, **settings)
        self._dev = device
        self._started = False

    def out_channels(self, port, in_channels):
        c = int(self.settings.get("channels"))
        return 0 if c <= 1 else c

    def start(self):
        if self._dev is None:
            self._dev = _SDR_DRIVERS[str(self.settings.get("driver"))]()
        self._dev.configure(
            sample_rate=float(self.settings.get("sample_rate")),
            center_frequency=float(self.settings.get("center_frequency")),
            gain=float(self.settings.get("gain")),
            antenna=str(self.settings.get("antenna")),
            channels=int(self.settings.get("channels")))
        self._dev.activate()
        self._started = True

    def emit_tags(self, ctx):
        from ..core.tags import Keys, Tag
        if ctx.abs_index == 0:
            return [Tag(0, {Keys.SAMPLE_RATE: float(self.settings.get("sample_rate")),
                            Keys.FREQUENCY: float(self.settings.get("center_frequency"))})]
        return []

    def host_feed(self, n, abs_index):
        if not self._started:
            self.start()
        got, info = self._dev.read_stream(n)
        if got is None:
            return None
        return {"out": got}, got.shape[-1]

    def apply(self, state, ins, ctx):
        return state, {"out": ins["out"]}

    def stop(self):
        if self._dev:
            self._dev.deactivate()


@register_block("SdrSink")
class SdrSink(SinkBlock):
    """Transmit stream to an SDR device (≈ SoapySink.hpp:18)."""

    IN = (Port("in", dtype="complex64"),)
    driver = Setting(default="loopback", kind="static")
    sample_rate = Setting(default=1e6, unit="Hz", kind="static")
    center_frequency = Setting(default=100e6, unit="Hz", kind="static")
    gain = Setting(default=0.0, unit="dB", kind="static")

    def __init__(self, name=None, device: SdrDevice | None = None, **settings):
        super().__init__(name=name, **settings)
        self._dev = device
        self._started = False

    def consume(self, arrays, tags, n_valid, abs_index):
        if not self._started:
            if self._dev is None:
                self._dev = _SDR_DRIVERS[str(self.settings.get("driver"))]()
            self._dev.configure(
                sample_rate=float(self.settings.get("sample_rate")),
                center_frequency=float(self.settings.get("center_frequency")),
                gain=float(self.settings.get("gain")))
            self._dev.activate()
            self._started = True
        self._dev.write_stream(arrays["in"][..., :n_valid])


@register_block("WbfmReceiver")
class WbfmReceiver(Graph):
    """Registry-constructible WBFM receiver (nested graph block)."""

    def __init__(self, name=None, quad_rate: float = 250e3, audio_decim: int = 5,
                 center_freq: float = 0.0, rf_decim: int = 1, max_dev: float = 75e3,
                 deemph_tau: float = 75e-6, **settings):
        inner = make_wbfm_receiver(quad_rate=quad_rate, audio_decim=audio_decim,
                                   center_freq=center_freq, rf_decim=rf_decim,
                                   max_dev=max_dev, deemph_tau=deemph_tau,
                                   name=name or "wbfm")
        # adopt the prepared graph's contents
        super().__init__(name=name or "wbfm")
        self.blocks = inner.blocks
        self.edges = inner.edges
        self._exports_in = inner._exports_in
        self._exports_out = inner._exports_out
        self.in_ports = inner.in_ports
        self.out_ports = inner.out_ports


@register_block("SsbDemod")
class SsbDemod(Block):
    """SSB (USB/LSB) demodulator, filter method: translate the wanted sideband
    to baseband, low-pass to the audio bandwidth, take 2·Re — all one fused
    device program (NCO + matmul FIR). ≈ classic GNU Radio SSB receiver flowgraphs
    (no single reference block; beyond the GR4 reference's blocklib).

    Input: complex IQ centered on the (suppressed) carrier. Output: real audio
    at the input rate — follow with a decimating FIR/resampler for sound-card
    rates.
    """

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="float32"),)
    sideband = Setting(default="usb", kind="static", choices=("usb", "lsb"))
    bandwidth = Setting(default=2700.0, kind="static", unit="Hz")
    ntaps = Setting(default=127, kind="static", limits=(15, 4097))
    sample_rate_in = Setting(default=0.0, kind="static",
                             description="0 → inherit resolved edge rate")

    def _fs(self, ctx_rate: float) -> float:
        fs = float(self.settings.get("sample_rate_in"))
        return fs if fs > 0 else ctx_rate

    def _taps(self, fs: float) -> np.ndarray:
        if getattr(self, "_tp", None) is None or self._tp_fs != fs:
            from ..ops.filter_design import design_fir
            bw = float(self.settings.get("bandwidth"))
            self._tp = design_fir(
                "lowpass", int(self.settings.get("ntaps")), sample_rate=fs,
                f_low=bw / 2.0, window="Hamming").astype(np.float32)
            self._tp_fs = fs
        return self._tp

    def init_state(self, ctx):
        from ..ops.fir import fir_init_state
        return {"hist": fir_init_state(ctx.channels.get("in", 0),
                                       int(self.settings.get("ntaps")),
                                       jnp.complex64),
                "phase": jnp.zeros((), jnp.uint32)}

    def apply(self, state, ins, ctx):
        from ..ops.fir import fir_apply
        from ..ops.signal import complex_exp_ramp, phase_increment
        x = ins["in"].astype(jnp.complex64)
        fs = self._fs(ctx.sample_rate)
        bw = float(self.settings.get("bandwidth"))
        sign = -1.0 if str(self.settings.get("sideband")) == "usb" else 1.0
        # Weaver: shift the sideband center (±bw/2) to 0, low-pass with a
        # symmetric bw/2 filter, shift BACK, take 2·Re (the second mixer —
        # without the shift-back the audio lands offset by bw/2)
        dphi = phase_increment(sign * bw / 2.0, fs)
        n = x.shape[-1]
        rot = complex_exp_ramp(state["phase"], dphi, n)
        xb = x * rot
        y, hist = fir_apply(xb, self._taps(fs), state["hist"])
        y = y * jnp.conj(rot)
        new_phase = state["phase"] + jnp.asarray(dphi, jnp.uint32) * jnp.uint32(n)
        return ({"hist": hist, "phase": new_phase},
                {"out": (2.0 * jnp.real(y)).astype(jnp.float32)})


@register_block("FmStereoDecoder")
class FmStereoDecoder(Block):
    """FM stereo MPX decoder: composite (FM-demodulated baseband) → L and R.

    Feed-forward device-native pilot recovery (no feedback loop): the 19 kHz
    pilot is band-passed and SQUARED to regenerate the 38 kHz subcarrier
    (classic doubling trick), which demodulates the DSB-SC L−R band; L+R is
    the 0–15 kHz baseband. Everything is windowed-sinc FIRs (matrix units) +
    elementwise math in one fused program. De-emphasize each channel
    downstream at audio rate. Outputs at the input (quadrature) rate.
    """

    IN = (Port("in", dtype="float32"),)
    OUT = (Port("left", dtype="float32"), Port("right", dtype="float32"))
    sample_rate_in = Setting(default=0.0, kind="static",
                             description="0 → inherit resolved edge rate")
    ntaps = Setting(default=129, kind="static", limits=(31, 1025))

    def _fs(self, ctx_rate: float) -> float:
        fs = float(self.settings.get("sample_rate_in"))
        return fs if fs > 0 else ctx_rate

    def _filters(self, fs: float):
        if getattr(self, "_flt", None) is None or self._flt_fs != fs:
            from ..ops.filter_design import design_fir
            k = int(self.settings.get("ntaps"))
            lp15 = design_fir("lowpass", k, sample_rate=fs,
                              f_low=15e3).astype(np.float32)
            # ANALYTIC 19 kHz pilot filter (one-sided): narrow lowpass
            # heterodyned to +19 kHz — output a = A·e^{jθ}, so the phase-true
            # 38 kHz subcarrier is Im((a/|a|)²) = sin 2θ. (Squaring the REAL
            # pilot gives cos 2θ — orthogonal to the DSB subcarrier; measured
            # 0.6 dB separation that way.)
            n = np.arange(k, dtype=np.float64) - (k - 1) / 2.0
            lp500 = design_fir("lowpass", k, sample_rate=fs, f_low=500.0)
            bp19c = (lp500 * np.exp(2j * np.pi * 19e3 / fs * n)
                     ).astype(np.complex64)
            bp38 = design_fir("bandpass", k, sample_rate=fs, f_low=23e3,
                              f_high=53e3).astype(np.float32)
            self._flt = (lp15, bp19c, bp38)
            self._flt_fs = fs
        return self._flt

    def init_state(self, ctx):
        from ..ops.fir import fir_init_state
        k = int(self.settings.get("ntaps"))
        return {"h_sum": fir_init_state(0, k, jnp.float32),
                "h_pil": fir_init_state(0, k, jnp.complex64),
                "h_dsb": fir_init_state(0, k, jnp.float32),
                "h_dif": fir_init_state(0, k, jnp.float32),
                # the difference arm passes TWO filters (bp38 then lp15); the
                # mono arm only one — delay mono by (k-1)/2 so L/R re-align
                # (without this the sum/difference mix and separation is ~4 dB)
                "d_mono": jnp.zeros(((k - 1) // 2,), jnp.float32)}

    def apply(self, state, ins, ctx):
        from ..ops.fir import fir_apply
        x = ins["in"].astype(jnp.float32)
        fs = self._fs(ctx.sample_rate)
        lp15, bp19c, bp38 = self._filters(fs)
        mono, h_sum = fir_apply(x, lp15, state["h_sum"])        # L+R
        a, h_pil = fir_apply(x.astype(jnp.complex64), bp19c,
                             state["h_pil"])                    # analytic pilot
        dsb, h_dsb = fir_apply(x, bp38, state["h_dsb"])         # 38 kHz DSB
        u = a / (jnp.abs(a) + 1e-12)
        # analytic filter of sin(θ) yields u = e^{j(θ-π/2)}, so u² = -e^{j2θ};
        # negate to recover +sin 2θ (without this L and R swap exactly)
        carrier = -jnp.imag(u * u)
        diff_raw = dsb * carrier * 2.0
        diff, h_dif = fir_apply(diff_raw, lp15, state["h_dif"])  # L−R
        k = int(self.settings.get("ntaps"))
        d = (k - 1) // 2
        mono_al = jnp.concatenate([state["d_mono"], mono], axis=-1)
        mono_d = mono_al[..., :mono.shape[-1]]
        new_d = mono_al[..., mono.shape[-1]:]
        left = mono_d + diff
        right = mono_d - diff
        return ({"h_sum": h_sum, "h_pil": h_pil, "h_dsb": h_dsb,
                 "h_dif": h_dif, "d_mono": new_d},
                {"left": left.astype(jnp.float32),
                 "right": right.astype(jnp.float32)})
