"""Digital modem blocks: constellation mapper/demapper, OFDM mod/demod."""

from __future__ import annotations

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np

from ..core.block import Block, Port, SinkBlock
from ..core.errors import GrError
from ..core.registry import register_block
from ..core.settings import Setting
from ..ops.digital import (default_occupied, iq_to_symbols, make_constellation,
                           ofdm_demodulate, ofdm_modulate, symbols_to_iq)

CONSTELLATIONS = ("BPSK", "QPSK", "8PSK", "QAM16", "QAM64")


@register_block("ConstellationMapper")
class ConstellationMapper(Block):
    """int32 symbols → complex64 IQ points (Gray-coded PSK/QAM)."""

    IN = (Port("in", dtype="int32"),)
    OUT = (Port("out", dtype="complex64"),)
    constellation = Setting(default="QPSK", kind="static",
                            choices=CONSTELLATIONS)

    def apply(self, state, ins, ctx):
        table = make_constellation(str(self.settings.get("constellation")))
        return state, {"out": symbols_to_iq(ins["in"], table)}


@register_block("ConstellationDemapper")
class ConstellationDemapper(Block):
    """complex64 IQ → nearest-symbol int32 (hard decision)."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="int32"),)
    constellation = Setting(default="QPSK", kind="static",
                            choices=CONSTELLATIONS)

    def apply(self, state, ins, ctx):
        table = make_constellation(str(self.settings.get("constellation")))
        return state, {"out": iq_to_symbols(ins["in"], table)}


@register_block("OfdmModulator")
class OfdmModulator(Block):
    """IQ symbols → OFDM time-domain stream (IFFT + cyclic prefix).

    Consumes ``n_occupied`` symbols per OFDM symbol; produces
    ``fft_size + cp_len`` samples — ratio (fft+cp)/occupied.
    """

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"),)
    fft_size = Setting(default=64, kind="static", limits=(8, 1 << 16))
    cp_len = Setting(default=16, kind="static", limits=(0, 1 << 14))
    n_occupied = Setting(default=48, kind="static", limits=(1, 1 << 16))

    def _occ(self):
        return default_occupied(int(self.settings.get("fft_size")),
                                int(self.settings.get("n_occupied")))

    @property
    def ratio(self):
        n = int(self.settings.get("fft_size")) + int(self.settings.get("cp_len"))
        return Fraction(n, int(self.settings.get("n_occupied")))

    @property
    def alignment(self):
        return int(self.settings.get("n_occupied"))

    def apply(self, state, ins, ctx):
        x = ins["in"]
        n_occ = int(self.settings.get("n_occupied"))
        sym = x.reshape(*x.shape[:-1], -1, n_occ)
        y = ofdm_modulate(sym, fft_size=int(self.settings.get("fft_size")),
                          cp_len=int(self.settings.get("cp_len")),
                          occupied=self._occ())
        return state, {"out": y}


@register_block("RrcFilter")
class RrcFilter(Block):
    """Root-raised-cosine pulse shaping / matched filter (matmul FIR path)."""

    IN = (Port("in"),)
    OUT = (Port("out"),)
    sps = Setting(default=4, kind="static", limits=(1, 256))
    ntaps = Setting(default=65, kind="static", limits=(3, 1 << 14))
    beta = Setting(default=0.35, kind="static", limits=(0.01, 1.0))

    def _taps(self):
        from ..ops.digital import rrc_taps
        return rrc_taps(int(self.settings.get("sps")),
                        int(self.settings.get("ntaps")),
                        beta=float(self.settings.get("beta"))).astype(np.float32)

    def init_state(self, ctx):
        from ..ops.fir import fir_init_state
        return fir_init_state(ctx.channels.get("in", 0), len(self._taps()),
                              ctx.dtype("in", jnp.complex64))

    def apply(self, state, ins, ctx):
        from ..ops.fir import fir_apply
        y, st = fir_apply(ins["in"], self._taps(), state)
        return st, {"out": y}


@register_block("SymbolSampler")
class SymbolSampler(Block):
    """Square-law (non-data-aided) symbol timing: per step, pick the sampling
    phase with maximum symbol-rate energy and decimate by ``sps``.

    For static channels this equals ideal timing; a feedback M&M loop is
    round-2 work. State smooths the phase estimate across steps.
    """

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"),)
    sps = Setting(default=4, kind="static", limits=(2, 256))

    @property
    def ratio(self):
        return Fraction(1, int(self.settings.get("sps")))

    @property
    def alignment(self):
        return int(self.settings.get("sps"))

    def init_state(self, ctx):
        sps = int(self.settings.get("sps"))
        return jnp.zeros((sps,), jnp.float32)  # smoothed per-phase energy

    def apply(self, state, ins, ctx):
        from ..ops.digital import timing_phase_energy
        import jax
        x = ins["in"]
        sps = int(self.settings.get("sps"))
        e = timing_phase_energy(x, sps)
        e_s = 0.5 * state + 0.5 * (e if e.ndim == 1 else jnp.mean(
            e.reshape(-1, sps), axis=0))
        phase = jnp.argmax(e_s)
        frames = x.reshape(*x.shape[:-1], -1, sps)
        y = jnp.take_along_axis(
            frames, jnp.broadcast_to(phase, (*frames.shape[:-1], 1)),
            axis=-1)[..., 0]
        return e_s, {"out": y.astype(jnp.complex64)}


@register_block("MMSymbolSync")
class MMSymbolSync(Block):
    """Mueller & Müller decision-directed symbol synchronizer (feedback loop;
    tracks small timing offsets/clock drift; state = μ + last symbol)."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"),)
    sps = Setting(default=4, kind="static", limits=(2, 256))
    gain = Setting(default=0.01, kind="static", limits=(1e-6, 1.0))

    @property
    def ratio(self):
        return Fraction(1, int(self.settings.get("sps")))

    @property
    def alignment(self):
        return int(self.settings.get("sps"))

    def init_state(self, ctx):
        return {"mu": jnp.zeros((), jnp.float32),
                "last": jnp.zeros((), jnp.complex64)}

    def apply(self, state, ins, ctx):
        from ..ops.digital import mm_timing_recovery
        syms, mu, last = mm_timing_recovery(
            ins["in"], sps=int(self.settings.get("sps")),
            mu0=state["mu"], last_sym=state["last"],
            gain=float(self.settings.get("gain")))
        return {"mu": mu, "last": last}, {"out": syms}


@register_block("OfdmDemodulator")
class OfdmDemodulator(OfdmModulator):
    """OFDM time-domain stream → IQ symbols (CP strip + FFT); assumes symbol
    alignment (synchronization is upstream)."""

    @property
    def ratio(self):
        n = int(self.settings.get("fft_size")) + int(self.settings.get("cp_len"))
        return Fraction(int(self.settings.get("n_occupied")), n)

    @property
    def alignment(self):
        return (int(self.settings.get("fft_size"))
                + int(self.settings.get("cp_len")))

    def apply(self, state, ins, ctx):
        sym = ofdm_demodulate(ins["in"],
                              fft_size=int(self.settings.get("fft_size")),
                              cp_len=int(self.settings.get("cp_len")),
                              occupied=self._occ())
        return state, {"out": sym.reshape(*sym.shape[:-2], -1)}


@register_block("PfbClockSync")
class PfbClockSync(Block):
    """Polyphase-filterbank clock recovery (≈ GNU Radio pfb_clock_sync_ccf;
    beyond the reference's blocklib): matched filtering and symbol timing in
    one block. ``nfilts`` polyphase arms of the RRC prototype give fractional
    delays; the derivative-filter timing detector err = Re{conj(y)·dy} steers
    a 2nd-order loop selecting the arm (and slipping whole samples as the
    accumulated offset crosses sample boundaries).

    Emits one matched-filtered symbol per ``sps`` input samples.
    """

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"),)
    sps = Setting(default=4, kind="static", limits=(2, 64))
    nfilts = Setting(default=32, kind="static", limits=(4, 256))
    rolloff = Setting(default=0.35, kind="static", limits=(0.0, 1.0))
    taps_per_arm = Setting(default=11, kind="static", limits=(3, 64))
    loop_bw = Setting(default=0.05, kind="static", limits=(1e-6, 1.0))

    @property
    def ratio(self):
        return Fraction(1, int(self.settings.get("sps")))

    @property
    def alignment(self):
        return int(self.settings.get("sps"))

    def _banks(self):
        if getattr(self, "_bk", None) is None:
            from ..ops.digital import rrc_taps
            sps = int(self.settings.get("sps"))
            M = int(self.settings.get("nfilts"))
            L = int(self.settings.get("taps_per_arm"))
            proto = rrc_taps(sps * M, L * M, beta=float(
                self.settings.get("rolloff"))).astype(np.float64)
            proto = proto[: L * M]
            dproto = np.gradient(proto) * M      # d/dt in arm-index units
            arms = np.stack([proto[m::M][::-1] for m in range(M)])
            darms = np.stack([dproto[m::M][::-1] for m in range(M)])
            # unit-energy arms: matched output of a unit-energy RRC pulse ≈ 1
            norms = np.linalg.norm(arms, axis=1, keepdims=True)
            arms = arms / norms
            darms = darms / norms   # same scale keeps the detector S-curve
            self._bk = (arms.astype(np.float32), darms.astype(np.float32))
        return self._bk

    def init_state(self, ctx):
        sps = int(self.settings.get("sps"))
        L = int(self.settings.get("taps_per_arm"))
        H = L + 2 * sps
        return {"hist": jnp.zeros((H,), jnp.complex64),
                "acc": jnp.asarray(float(sps), jnp.float32),  # mid-range
                "rate": jnp.zeros((), jnp.float32),
                "prev": jnp.zeros((), jnp.complex64)}

    def apply(self, state, ins, ctx):
        x = ins["in"]
        sps = int(self.settings.get("sps"))
        M = int(self.settings.get("nfilts"))
        L = int(self.settings.get("taps_per_arm"))
        bw = float(self.settings.get("loop_bw"))
        damp = float(np.sqrt(2.0) / 2.0)
        denom = 1.0 + 2.0 * damp * bw + bw * bw
        alpha = jnp.float32(4.0 * damp * bw / denom)
        beta = jnp.float32(4.0 * bw * bw / denom)
        arms_np, darms_np = self._banks()
        arms = jnp.asarray(arms_np)
        darms = jnp.asarray(darms_np)
        xa = jnp.concatenate([state["hist"], x], axis=-1)
        nsym = x.shape[-1] // sps

        max_rate = jnp.float32(0.05)  # samples/symbol clock-deviation clamp

        def step(carry, i):
            acc, rate, prev = carry
            ioff = jnp.clip(jnp.floor(acc).astype(jnp.int32), 0, 2 * sps)
            frac = acc - jnp.floor(acc)
            ki = jnp.clip((frac * M).astype(jnp.int32), 0, M - 1)
            base = i * sps + ioff
            w = jax.lax.dynamic_slice_in_dim(xa, base, L)
            y = jnp.sum(arms[ki] * w)
            # Gardner TED on the matched output: rotation-invariant to first
            # order (the derivative TED's Re{conj(y)dy} has a CFO bias that
            # winds the rate integrator to the clamp — measured)
            wm = jax.lax.dynamic_slice_in_dim(xa, base - sps // 2, L)
            ymid = jnp.sum(arms[ki] * wm)
            # RAW error — no |y|^2 normalization: off-lock the instantaneous
            # normalization blows up asymmetrically (+25 vs -0.1 measured) and
            # winds the rate integrator to its clamp; the raw S-curve is a
            # clean symmetric sinusoid over the symbol period
            err = jnp.real(jnp.conj(ymid) * (prev - y))
            rate = jnp.clip(rate + beta * err, -max_rate, max_rate)
            acc = jnp.clip(acc + alpha * err + rate, 0.0,
                           jnp.float32(2.0 * sps))
            return (acc, rate, y), y

        (acc, rate, prev), ys = jax.lax.scan(
            step, (state["acc"], state["rate"], state["prev"]),
            jnp.arange(nsym, dtype=jnp.int32))
        H = L + 2 * sps
        new_hist = jax.lax.dynamic_slice_in_dim(
            xa, nsym * sps, H)
        return ({"hist": new_hist, "acc": acc, "rate": rate, "prev": prev},
                {"out": ys.astype(jnp.complex64)})


@register_block("DiffEncoder")
class DiffEncoder(Block):
    """Differential phase encoder: y[n] = x[n]·y[n-1] (phases accumulate).
    O(log T) via associative scan — cumulative complex product — instead of a
    sequential loop; state carries the last output for stream continuity.
    ≈ GNU Radio diff_encoder (phase-domain form)."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"),)

    def init_state(self, ctx):
        return jnp.ones((), jnp.complex64)

    def apply(self, state, ins, ctx):
        x = ins["in"]
        prod = jax.lax.associative_scan(jnp.multiply, x, axis=-1)
        y = (state * prod).astype(jnp.complex64)
        # renormalize: pure phase accumulation must not drift in magnitude
        y = y / jnp.maximum(jnp.abs(y), 1e-30)
        return y[..., -1], {"out": y}


@register_block("DiffDecoder")
class DiffDecoder(Block):
    """Differential phase decoder: y[n] = x[n]·conj(x[n-1]) — embarrassingly
    parallel; state carries the previous input sample."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"),)

    def init_state(self, ctx):
        return jnp.ones((), jnp.complex64)

    def apply(self, state, ins, ctx):
        x = ins["in"]
        prev = jnp.concatenate([state[None], x[..., :-1]], axis=-1)
        y = (x * jnp.conj(prev)).astype(jnp.complex64)
        return x[..., -1], {"out": y}


@register_block("PreambleCorrelator")
class PreambleCorrelator(Block):
    """Burst/preamble detection: correlates against a known symbol sequence
    on-device (framed matmul), emits the stream unchanged on ``out`` and
    a fixed-capacity detection record ``[2, max_det]`` (row 0: in-step index,
    row 1: normalized correlation magnitude) on ``det``.

    Pair with :class:`DetectionSink` to collect absolute-indexed detections
    on the host (≈ GNU Radio correlate_access_code / corr_est, redesigned for
    the one-fused-program model: detection indices ride a data port instead
    of stream tags, since data-dependent tags cannot exist within the step
    that computes them)."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"), Port("det", dtype="float32"))
    threshold = Setting(default=0.7, kind="static", limits=(0.0, 1.0),
                        description="normalized correlation threshold")
    max_detections = Setting(default=8, kind="static", limits=(1, 256))

    def __init__(self, preamble=(), name=None, **settings):
        super().__init__(name=name, **settings)
        self._pre = np.asarray(preamble, np.complex64)
        if self._pre.size == 0:
            raise GrError("PreambleCorrelator needs a preamble sequence")
        self._pre = self._pre / np.linalg.norm(self._pre)

    def out_channels(self, port, in_channels):
        if port == "det":
            return 2
        return in_channels.get("in", 0)

    def init_state(self, ctx):
        k = len(self._pre)
        return jnp.zeros((k - 1,), jnp.complex64)

    def apply(self, state, ins, ctx):
        x = ins["in"]
        k = len(self._pre)
        cap = int(self.settings.get("max_detections"))
        thr = jnp.float32(self.settings.get("threshold"))
        xa = jnp.concatenate([state, x], axis=-1)
        n = x.shape[-1]
        cols = [jax.lax.dynamic_slice_in_dim(xa, j, n) for j in range(k)]
        F = jnp.stack(cols, axis=-1)                       # [n, k] windows
        pre = jnp.asarray(np.conj(self._pre))
        c = jnp.abs(F @ pre)                               # correlation mag
        e = jnp.sqrt(jnp.sum(jnp.abs(F) ** 2, axis=-1)) + 1e-12
        rho = c / e                                        # normalized [0,1]
        # local maxima above threshold, then top-cap by magnitude
        left = jnp.concatenate([jnp.zeros(1), rho[:-1]])
        right = jnp.concatenate([rho[1:], jnp.zeros(1)])
        peak = (rho >= left) & (rho > right) & (rho >= thr)
        score = jnp.where(peak, rho, 0.0)
        mags, idxs = jax.lax.top_k(score, cap)
        idxs = jnp.where(mags > 0, idxs - (k - 1), -(1 << 30))
        # det stream matches the data length (single rate algebra); only the
        # first max_detections columns carry records, the rest are padding
        det = jnp.zeros((2, n), jnp.float32)
        det = det.at[0, :cap].set(idxs.astype(jnp.float32))
        det = det.at[1, :cap].set(mags)
        new_state = jax.lax.dynamic_slice_in_dim(xa, n, k - 1)
        return new_state, {"out": x, "det": det}


@register_block("DetectionSink")
class DetectionSink(SinkBlock):
    """Collects PreambleCorrelator ``det`` records into absolute-indexed
    detections: ``.detections`` = list of (abs_sample_index, correlation)."""

    IN = (Port("in", dtype="float32"),)

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self.detections: list[tuple[int, float]] = []

    def consume(self, arrays, tags, n_valid, abs_index):
        det = np.asarray(arrays["in"])
        cap = det.shape[-1]
        for i, m in zip(det[0, :cap], det[1, :cap]):
            if m > 0 and i > -(1 << 29):
                self.detections.append((int(abs_index + i), float(m)))


_PRBS_TAPS = {7: (7, 6), 9: (9, 5), 15: (15, 14), 23: (23, 18), 31: (31, 28)}


@register_block("PrbsSource")
class PrbsSource(Block):
    """ITU-T PRBS bit source (PRBS7/9/15/23/31, Fibonacci LFSR) — the standard
    link-measurement stimulus (≈ GNU Radio glfsr_source_b). Bits are generated
    host-side per step (FEED) and streamed as int32 0/1."""

    IN = ()
    OUT = (Port("out", dtype="int32"),)
    FEED = True
    order = Setting(default=15, kind="static", choices=tuple(_PRBS_TAPS))
    n_bits = Setting(default=0, kind="static",
                     description="0 = endless")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        deg = int(self.settings.get("order"))
        self._state = (1 << deg) - 1          # all-ones seed (never zero)

    def _gen(self, n: int) -> np.ndarray:
        deg, tap2 = _PRBS_TAPS[int(self.settings.get("order"))]
        s = self._state
        out = np.empty(n, np.int32)
        for i in range(n):
            b = ((s >> (deg - 1)) ^ (s >> (tap2 - 1))) & 1
            s = ((s << 1) | b) & ((1 << deg) - 1)
            out[i] = b
        self._state = s
        return out

    def host_feed(self, n, abs_index):
        total = int(self.settings.get("n_bits"))
        if total and abs_index >= total:
            return None
        take = n if not total else min(n, total - abs_index)
        return {"out": self._gen(take)}, take

    def apply(self, state, ins, ctx):
        return state, {"out": ins["out"]}


@register_block("PackBits")
class PackBits(Block):
    """k bits (int32 0/1, MSB first) → one symbol int32 (≈ pack_k_bits_bb)."""

    IN = (Port("in", dtype="int32"),)
    OUT = (Port("out", dtype="int32"),)
    k = Setting(default=2, kind="static", limits=(1, 30))

    @property
    def ratio(self):
        return Fraction(1, int(self.settings.get("k")))

    @property
    def alignment(self):
        return int(self.settings.get("k"))

    def apply(self, state, ins, ctx):
        k = int(self.settings.get("k"))
        x = ins["in"].reshape(*ins["in"].shape[:-1], -1, k)
        w = (2 ** jnp.arange(k - 1, -1, -1)).astype(jnp.int32)
        return state, {"out": jnp.sum(x * w, axis=-1)}


@register_block("UnpackBits")
class UnpackBits(Block):
    """One symbol int32 → k bits (MSB first) (≈ unpack_k_bits_bb)."""

    IN = (Port("in", dtype="int32"),)
    OUT = (Port("out", dtype="int32"),)
    k = Setting(default=2, kind="static", limits=(1, 30))

    @property
    def ratio(self):
        return Fraction(int(self.settings.get("k")), 1)

    def apply(self, state, ins, ctx):
        k = int(self.settings.get("k"))
        shifts = jnp.arange(k - 1, -1, -1, dtype=jnp.int32)
        bits = (ins["in"][..., None] >> shifts) & 1
        return state, {"out": bits.reshape(*ins["in"].shape[:-1], -1)}


@register_block("BerSink")
class BerSink(SinkBlock):
    """Bit-error-rate meter: compares the incoming bit stream against a local
    PRBS replica after self-synchronizing to it (correlation over the first
    window). ``.report()`` → dict(bits, errors, ber, synced)."""

    IN = (Port("in", dtype="int32"),)
    order = Setting(default=15, kind="static", choices=tuple(_PRBS_TAPS))
    sync_window = Setting(default=4096, kind="static", limits=(64, 1 << 20))

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._rx: list[np.ndarray] = []
        self._synced = None      # (lag, invert)
        self._bits = 0
        self._errors = 0
        deg = int(self.settings.get("order"))
        self._period = (1 << deg) - 1

    def _replica(self, n: int, phase: int) -> np.ndarray:
        deg, tap2 = _PRBS_TAPS[int(self.settings.get("order"))]
        s = (1 << deg) - 1
        out = np.empty(phase + n, np.int8)
        for i in range(phase + n):
            b = ((s >> (deg - 1)) ^ (s >> (tap2 - 1))) & 1
            s = ((s << 1) | b) & ((1 << deg) - 1)
            out[i] = b
        return out[phase:]

    def consume(self, arrays, tags, n_valid, abs_index):
        if n_valid <= 0:
            return
        self._rx.append(np.asarray(arrays["in"][..., :n_valid]).ravel())
        if self._synced is None:
            w = int(self.settings.get("sync_window"))
            have = sum(len(c) for c in self._rx)
            if have < w:
                return
            rx = np.concatenate(self._rx)[:w].astype(np.int8)
            ref = self._replica(w + self._period, 0)
            best = (w + 1, 0, False)
            x = 2 * rx - 1
            for lag in range(self._period):
                r = 2 * ref[lag:lag + w].astype(np.int32) - 1
                c = int(np.dot(x, r))
                if w - abs(c) < best[0] * 2:
                    best = ((w - abs(c)) // 2, lag, c < 0)
            self._synced = (best[1], best[2])
            self._pos = 0
            self._pending = [np.concatenate(self._rx)]
            self._rx = []
        else:
            self._pending = [self._rx.pop()]
        lag, inv = self._synced
        for chunk in self._pending:
            ref = self._replica(len(chunk), lag + self._pos)
            if inv:
                ref = 1 - ref
            self._errors += int(np.sum(chunk.astype(np.int8) != ref))
            self._bits += len(chunk)
            self._pos += len(chunk)
        self._pending = []

    def report(self) -> dict:
        return {"bits": self._bits, "errors": self._errors,
                "ber": self._errors / self._bits if self._bits else None,
                "synced": self._synced is not None}


@register_block("PacketFramer")
class PacketFramer(Block):
    """Bits → framed QPSK burst symbols: [preamble | 16-bit length | payload
    bits as QPSK | 32-bit CRC32C]. Fixed frame geometry per step: consumes
    ``payload_bits`` per frame, emits ``frame_syms`` symbols (rate algebra
    stays static). Pair with PreambleCorrelator + PacketReceiver.
    """

    IN = (Port("in", dtype="int32"),)
    OUT = (Port("out", dtype="complex64"),)
    payload_bits = Setting(default=512, kind="static", limits=(8, 1 << 16))
    preamble_len = Setting(default=63, kind="static", limits=(15, 255))

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        rng = np.random.default_rng(0xC0FFEE)   # fixed, shared with receiver
        m = int(self.settings.get("preamble_len"))
        self._preamble = np.exp(
            1j * np.pi / 4 * (2 * rng.integers(0, 4, m) + 1)
        ).astype(np.complex64)

    @property
    def preamble(self) -> np.ndarray:
        return self._preamble

    def _geometry(self):
        pb = int(self.settings.get("payload_bits"))
        if pb % 2:
            raise GrError("payload_bits must be even (QPSK: 2 bits/symbol)")
        header_syms = 8            # 16-bit length as QPSK
        crc_syms = 16              # 32-bit CRC32C as QPSK
        m = int(self.settings.get("preamble_len"))
        return pb, m + header_syms + pb // 2 + crc_syms

    @property
    def ratio(self):
        pb, fs = self._geometry()
        return Fraction(fs, pb)

    @property
    def alignment(self):
        return self._geometry()[0]

    def host_feed(self, n, abs_index):
        return None  # not a source

    def prepare_params(self, params):
        return params

    def apply(self, state, ins, ctx):
        # framing is host-friendly logic but must trace: build per-frame
        # symbol layout with static shapes (frames per step is static)
        from ..core.errors import GrError as _  # noqa: F401
        bits = ins["in"].astype(jnp.int32)
        pb, fsyms = self._geometry()
        nframes = bits.shape[-1] // pb
        payload = bits.reshape(nframes, pb)

        def frame(pl):
            length = jnp.asarray(pb, jnp.uint32)
            hdr_bits = ((length[None] >> jnp.arange(15, -1, -1)) & 1
                        ).astype(jnp.int32)
            crc = _crc32c_bits_jax(pl)
            crc_bits = ((crc[None] >> jnp.arange(31, -1, -1)) & 1
                        ).astype(jnp.int32)
            allbits = jnp.concatenate([hdr_bits, pl, crc_bits])
            pairs = allbits.reshape(-1, 2)
            symidx = pairs[:, 0] * 2 + pairs[:, 1]
            # Gray-coded QPSK at pi/4 offsets
            gray = jnp.asarray([0, 1, 3, 2], jnp.int32)
            ang = jnp.pi / 4 + jnp.pi / 2 * gray[symidx].astype(jnp.float32)
            body = jnp.exp(1j * ang.astype(jnp.complex64))
            return jnp.concatenate([jnp.asarray(self._preamble), body])

        out = jax.vmap(frame)(payload).reshape(-1)
        return state, {"out": out.astype(jnp.complex64)}


def _crc32c_bits_jax(bits):
    """CRC32C (Castagnoli, reflected) over a bit array — bitwise LFSR via
    fori_loop; frames are short so this stays cheap and traceable."""
    poly = jnp.uint32(0x82F63B78)

    def step(i, crc):
        b = bits[i].astype(jnp.uint32)
        crc = crc ^ b
        crc = jnp.where(crc & 1, (crc >> 1) ^ poly, crc >> 1)
        return crc

    crc = jax.lax.fori_loop(0, bits.shape[0], step,
                            jnp.uint32(0xFFFFFFFF))
    return crc ^ jnp.uint32(0xFFFFFFFF)


def _crc32c_bits_np(bits: np.ndarray) -> int:
    crc = 0xFFFFFFFF
    for b in bits.astype(np.uint32):
        crc ^= int(b)
        crc = ((crc >> 1) ^ 0x82F63B78) if (crc & 1) else (crc >> 1)
    return crc ^ 0xFFFFFFFF


@register_block("PacketReceiver")
class PacketReceiver(SinkBlock):
    """Host-side packet extraction: feed it the SAME stream the
    PreambleCorrelator saw (its ``out`` port) — it buffers samples, and
    :meth:`on_detection` (call with DetectionSink results, or connect the
    correlator's ``det`` port to input ``det``) demodulates header/payload/CRC
    at each detection. ``.packets`` = list of dicts(index, ok, bits)."""

    IN = (Port("in", dtype="complex64"), Port("det", dtype="float32"))
    preamble_len = Setting(default=63, kind="static")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._buf = np.zeros(0, np.complex64)
        self._buf_start = 0            # absolute index of _buf[0]
        self.packets: list[dict] = []

    def consume(self, arrays, tags, n_valid, abs_index):
        x = np.asarray(arrays["in"][..., :n_valid])
        if self._buf.size == 0:
            self._buf_start = abs_index
        self._buf = np.concatenate([self._buf, x])
        det = np.asarray(arrays.get("det", np.zeros((2, 0))))
        for i, m in zip(det[0], det[1]):
            if m > 0 and i > -(1 << 29):
                self._try_decode(int(abs_index + i))
        # bound the buffer: keep 1<<18 most recent samples
        if len(self._buf) > (1 << 18):
            drop = len(self._buf) - (1 << 18)
            self._buf = self._buf[drop:]
            self._buf_start += drop

    def _try_decode(self, det_abs: int) -> None:
        pre = int(self.settings.get("preamble_len"))
        start = det_abs - self._buf_start + pre
        if start < 0:
            return
        buf = self._buf

        def read_syms(off, n):
            if start + off + n > len(buf):
                return None
            return buf[start + off: start + off + n]

        hdr = read_syms(0, 8)
        if hdr is None:
            return
        gray_rev = {0: 0, 1: 1, 3: 2, 2: 3}

        def demod_bits(syms):
            k = np.round((np.angle(syms) - np.pi / 4) / (np.pi / 2)) % 4
            out = []
            for s in k.astype(int):
                v = gray_rev[s]
                out += [(v >> 1) & 1, v & 1]
            return np.asarray(out, np.int64)

        hbits = demod_bits(hdr)
        length = int("".join(map(str, hbits)), 2)
        if length <= 0 or length > (1 << 15) or length % 2:
            return
        body = read_syms(8, length // 2 + 16)
        if body is None:
            return
        bbits = demod_bits(body)
        payload, crc_bits = bbits[:length], bbits[length:]
        crc_rx = int("".join(map(str, crc_bits)), 2)
        ok = (_crc32c_bits_np(payload) == crc_rx)
        self.packets.append({"index": det_abs, "ok": ok,
                             "bits": payload.astype(np.int32)})


def schmidl_cox_preamble(fft_size: int, cp_len: int, seed: int = 0x5C) -> np.ndarray:
    """Time-domain Schmidl & Cox preamble: PN symbols on EVEN subcarriers only
    → the useful part repeats [A A]; receivers detect via lag-N/2
    autocorrelation. Returns fft_size+cp_len complex samples."""
    rng = np.random.default_rng(seed)
    spec = np.zeros(fft_size, complex)
    even = np.arange(2, fft_size // 2, 2)
    pn = np.exp(1j * np.pi / 2 * rng.integers(0, 4, len(even)))
    spec[even] = pn
    spec[-even] = np.conj(pn)[::-1] * 0 + np.exp(
        1j * np.pi / 2 * rng.integers(0, 4, len(even)))
    td = np.fft.ifft(spec) * np.sqrt(fft_size)
    td = td / np.sqrt(np.mean(np.abs(td) ** 2))
    return np.concatenate([td[-cp_len:], td]).astype(np.complex64)


@register_block("OfdmSync")
class OfdmSync(Block):
    """Schmidl & Cox OFDM synchronizer: lag-N/2 autocorrelation over the
    repeated preamble half gives a timing metric (plateau → peak) and the
    fractional CFO from the correlation angle. Fully feed-forward (cumsum
    sliding sums — no sequential loop).

    Ports: ``out`` passes the stream through; ``det`` carries up to
    ``max_detections`` records [3 rows: in-step index, metric, cfo_est
    (subcarrier-spacing units)] — collect with :class:`OfdmSyncSink`.
    """

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"), Port("det", dtype="float32"))
    fft_size = Setting(default=64, kind="static", limits=(16, 1 << 14))
    cp_len = Setting(default=16, kind="static")
    threshold = Setting(default=0.6, kind="static", limits=(0.0, 1.0))
    max_detections = Setting(default=4, kind="static", limits=(1, 64))

    def out_channels(self, port, in_channels):
        return 3 if port == "det" else in_channels.get("in", 0)

    def init_state(self, ctx):
        nf = int(self.settings.get("fft_size"))
        return jnp.zeros((nf,), jnp.complex64)   # carry N samples of history

    def apply(self, state, ins, ctx):
        x = ins["in"].astype(jnp.complex64)
        nf = int(self.settings.get("fft_size"))
        half = nf // 2
        cap = int(self.settings.get("max_detections"))
        thr = jnp.float32(self.settings.get("threshold"))
        n = x.shape[-1]
        xa = jnp.concatenate([state, x], axis=-1)      # [nf + n]
        # P(d) = sum_{m<half} conj(xa[d+m]) xa[d+m+half]  via cumsum
        prod = jnp.conj(xa[:-half]) * xa[half:]        # [nf/2 + n]
        cp_ = jnp.cumsum(jnp.concatenate([jnp.zeros(1, prod.dtype), prod]))
        P = cp_[half:] - cp_[:-half]                   # windows of length half
        e = jnp.abs(xa) ** 2
        ce = jnp.cumsum(jnp.concatenate([jnp.zeros(1, e.dtype), e]))
        d = jnp.arange(n)
        E1 = ce[d + half] - ce[d]              # energy of window 1 [d, d+half)
        E2 = ce[d + nf] - ce[d + half]         # energy of window 2
        # Cauchy-Schwarz normalization: |P|^2 <= E1*E2, so m in [0, 1] —
        # the naive |P|^2/R^2 blows up where the R window covers only noise
        # (measured spurious metrics of 2.8-80 in noise/stream-end regions)
        m = jnp.abs(P[:n]) ** 2 / (E1 * E2 + 1e-12)
        # peak-pick: local maxima above threshold, top-cap
        left = jnp.concatenate([jnp.zeros(1), m[:-1]])
        right = jnp.concatenate([m[1:], jnp.zeros(1)])
        peak = (m >= left) & (m > right) & (m >= thr)
        score = jnp.where(peak, m, 0.0)
        mags, idxs = jax.lax.top_k(score, cap)
        cfo = jnp.angle(P[:n][idxs]) / jnp.pi          # subcarrier-spacing units
        base = idxs - nf                                # relative to step start
        det = jnp.zeros((3, n), jnp.float32)
        det = det.at[0, :cap].set(jnp.where(mags > 0, base, -(1 << 30)
                                            ).astype(jnp.float32))
        det = det.at[1, :cap].set(mags)
        det = det.at[2, :cap].set(jnp.where(mags > 0, cfo, 0.0))
        new_state = jax.lax.dynamic_slice_in_dim(xa, n, nf)
        return new_state, {"out": x, "det": det}


@register_block("OfdmSyncSink")
class OfdmSyncSink(SinkBlock):
    """Collects OfdmSync detections, clustering the S&C plateau (multiple
    peaks per preamble within ``min_gap`` samples → keep the strongest):
    ``.detections`` = list of (abs_sample_index, metric, cfo_subcarriers)."""

    IN = (Port("in", dtype="float32"),)
    min_gap = Setting(default=256, kind="static")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self.detections: list[tuple[int, float, float]] = []

    def consume(self, arrays, tags, n_valid, abs_index):
        det = np.asarray(arrays["in"])
        gap = int(self.settings.get("min_gap"))
        for i, m, c in sorted(zip(det[0], det[1], det[2])):
            if m <= 0 or i <= -(1 << 29):
                continue
            rec = (int(abs_index + i), float(m), float(c))
            if self.detections and rec[0] - self.detections[-1][0] < gap:
                if rec[1] > self.detections[-1][1]:   # keep the stronger
                    self.detections[-1] = rec
            else:
                self.detections.append(rec)


@register_block("OfdmPilotInserter")
class OfdmPilotInserter(Block):
    """Insert comb-type pilots into the occupied-subcarrier stream: every
    ``pilot_spacing``-th occupied subcarrier carries a known BPSK pilot
    (sign alternates by pilot index), the rest carry data. Pairs with
    :class:`OfdmChannelEqualizer` on the receive side; sits between the
    symbol mapper and :class:`OfdmModulator`."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"),)
    n_occupied = Setting(default=48, kind="static")
    pilot_spacing = Setting(default=8, kind="static", limits=(2, 1 << 10))

    def _pilot_mask(self):
        n_occ = int(self.settings.get("n_occupied"))
        sp = int(self.settings.get("pilot_spacing"))
        idx = np.arange(0, n_occ, sp)
        mask = np.zeros(n_occ, bool)
        mask[idx] = True
        vals = np.where(np.arange(len(idx)) % 2 == 0, 1.0, -1.0)
        return mask, idx, vals.astype(np.complex64)

    @property
    def n_data(self):
        mask, _, _ = self._pilot_mask()
        return int((~mask).sum())

    @property
    def ratio(self):
        return Fraction(int(self.settings.get("n_occupied")), self.n_data)

    @property
    def alignment(self):
        return self.n_data

    def apply(self, state, ins, ctx):
        x = ins["in"]
        mask, idx, vals = self._pilot_mask()
        n_occ, nd = len(mask), self.n_data
        frames = x.reshape(*x.shape[:-1], -1, nd)
        out = jnp.zeros(frames.shape[:-1] + (n_occ,), jnp.complex64)
        out = out.at[..., np.flatnonzero(~mask)].set(frames)
        out = out.at[..., idx].set(jnp.asarray(vals))
        return state, {"out": out.reshape(*x.shape[:-1],
                                          x.shape[-1] // nd * n_occ)}


@register_block("OfdmChannelEqualizer")
class OfdmChannelEqualizer(Block):
    """Pilot-based per-subcarrier channel estimation + equalization on the
    demodulated occupied-subcarrier stream (the output of
    :class:`OfdmDemodulator`).

    LS estimate at the comb pilots (known BPSK pattern, matching
    :class:`OfdmPilotInserter`), linear interpolation across subcarriers,
    optional EMA smoothing across OFDM symbols (``smoothing`` 0..1, carried
    in state so it spans scheduler steps), then zero-forcing or MMSE
    equalization; pilots are stripped from the output (ratio
    n_data/n_occupied)."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"),)
    fft_size = Setting(default=64, kind="static",
                       description="FFT size of the upstream demodulator — "
                                   "needed to interpolate in true (signed) "
                                   "frequency, not occupied-array order")
    n_occupied = Setting(default=48, kind="static")
    pilot_spacing = Setting(default=8, kind="static", limits=(2, 1 << 10))
    mode = Setting(default="zf", kind="static", choices=("zf", "mmse"))
    noise_var = Setting(default=0.0, description="MMSE noise variance")
    smoothing = Setting(default=0.0, kind="static", limits=(0.0, 0.999),
                        description="EMA factor across OFDM symbols "
                                    "(0 = per-symbol estimates)")

    def _pilot_mask(self):
        n_occ = int(self.settings.get("n_occupied"))
        sp = int(self.settings.get("pilot_spacing"))
        idx = np.arange(0, n_occ, sp)
        mask = np.zeros(n_occ, bool)
        mask[idx] = True
        vals = np.where(np.arange(len(idx)) % 2 == 0, 1.0, -1.0)
        return mask, idx, vals.astype(np.complex64)

    @property
    def n_data(self):
        mask, _, _ = self._pilot_mask()
        return int((~mask).sum())

    @property
    def ratio(self):
        return Fraction(self.n_data, int(self.settings.get("n_occupied")))

    @property
    def alignment(self):
        return int(self.settings.get("n_occupied"))

    def init_state(self, ctx):
        n_occ = int(self.settings.get("n_occupied"))
        # carried channel estimate (EMA) + a has-history flag
        return {"h": jnp.ones(n_occ, jnp.complex64),
                "warm": jnp.zeros((), jnp.bool_)}

    def apply(self, state, ins, ctx):
        x = ins["in"]
        mask, pidx, pvals = self._pilot_mask()
        n_occ, nd = len(mask), self.n_data
        didx = np.flatnonzero(~mask)
        frames = x.reshape(-1, n_occ)
        # LS at pilots, per symbol
        h_p = frames[:, pidx] / jnp.asarray(pvals)
        # linear interpolation in SIGNED frequency: the occupied map is
        # [+1..+half, -half..-1] in FFT-bin order, so array position is not
        # monotonic in frequency — interpolating over it would bridge the
        # band edges straight across DC
        fft = int(self.settings.get("fft_size"))
        occ = default_occupied(fft, n_occ)
        freq = np.where(occ < fft // 2, occ, occ - fft).astype(np.float32)
        xp_f = freq[pidx]
        psort = np.argsort(xp_f)
        xs = jnp.asarray(freq)
        xp = jnp.asarray(xp_f[psort])
        h_p = h_p[:, psort]
        interp = jax.vmap(lambda hp: jnp.interp(xs, xp, hp.real)
                          + 1j * jnp.interp(xs, xp, hp.imag))
        h_sym = interp(h_p).astype(jnp.complex64)   # [n_sym, n_occ]
        a = float(self.settings.get("smoothing"))
        if a > 0.0:
            def ema(carry, h):
                h_prev, warm = carry
                h_new = jnp.where(warm, a * h_prev + (1 - a) * h, h)
                return (h_new, jnp.ones((), jnp.bool_)), h_new
            (h_last, warm), h_sym = jax.lax.scan(
                ema, (state["h"], state["warm"]), h_sym)
            new_state = {"h": h_last, "warm": warm}
        else:
            new_state = state
        if str(self.settings.get("mode")) == "mmse":
            nv = jnp.asarray(ctx.p("noise_var", 0.0), jnp.float32)
            w = jnp.conj(h_sym) / (jnp.abs(h_sym) ** 2 + nv)
            eq = frames * w
        else:
            eq = frames / h_sym
        out = eq[:, didx].astype(jnp.complex64)
        return new_state, {"out": out.reshape(*x.shape[:-1],
                                              x.shape[-1] // n_occ * nd)}


@register_block("SoftDemapper")
class SoftDemapper(Block):
    """complex64 IQ → per-bit max-log-MAP LLRs (positive = bit 0), the glue
    between any Gray constellation and the soft FEC decoders (Viterbi
    soft path, LdpcDecoder, PolarDecoder).

    For each bit position b: LLR_b = (min_{s: bit_b(s)=0} |y−s|²
    − min_{s: bit_b(s)=1} |y−s|²) / noise_var. Bits come out LSB-first per
    symbol (the constellation index IS the bit label, matching
    ConstellationMapper). Ratio bits_per_symbol/1."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="float32"),)
    constellation = Setting(default="QPSK", kind="static",
                            choices=CONSTELLATIONS)
    noise_var = Setting(default=1.0,
                        description="channel noise variance (per complex "
                                    "sample); scales LLR confidence")

    def _table(self):
        return make_constellation(str(self.settings.get("constellation")))

    @property
    def bits_per_symbol(self):
        return int(np.log2(len(self._table())))

    @property
    def ratio(self):
        return Fraction(self.bits_per_symbol, 1)

    def apply(self, state, ins, ctx):
        y = ins["in"]
        table = self._table()
        m = len(table)
        nbits = self.bits_per_symbol
        pts = jnp.asarray(table)
        d2 = jnp.abs(y[..., :, None] - pts[(None,) * y.ndim]) ** 2  # [.., T, M]
        labels = np.arange(m)
        big = jnp.float32(1e30)
        llrs = []
        for b in range(nbits):
            zero = (labels >> b) & 1 == 0
            d0 = jnp.min(jnp.where(jnp.asarray(zero), d2, big), axis=-1)
            d1 = jnp.min(jnp.where(jnp.asarray(~zero), d2, big), axis=-1)
            llrs.append(d1 - d0)
        nv = jnp.maximum(jnp.asarray(ctx.p("noise_var", 1.0), jnp.float32),
                         1e-12)
        out = jnp.stack(llrs, axis=-1) / nv          # [.., T, nbits]
        return state, {"out": out.reshape(y.shape[:-1]
                                          + (y.shape[-1] * nbits,))
                       .astype(jnp.float32)}
