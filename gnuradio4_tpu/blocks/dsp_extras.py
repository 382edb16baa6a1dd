"""Beyond-reference DSP blocks every SDR user expects: arbitrary-rate Farrow
resampler, AGC, Goertzel tone detector, PLL carrier tracking.

(The GR4 reference stops at rational resampling and has no AGC/PLL blocks;
these close the gap to classic GNU Radio capability.)
"""

from __future__ import annotations

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np

from ..core.block import Block, Port
from ..core.registry import register_block
from ..core.settings import Setting
from ..ops.farrow import agc_apply, farrow_apply, farrow_init_state, goertzel_power


@register_block("FarrowResampler")
class FarrowResampler(Block):
    """Arbitrary-rate resampler (cubic Farrow interpolator).

    ``rate`` = output rate / input rate (e.g. 0.9837). The rate is rationalized
    to ≤ 1e-9 relative error for the static block-size algebra; the fractional
    phase carries exactly, so the stream is drift-free at that rational rate.
    """

    IN = (Port("in"),)
    OUT = (Port("out"),)
    rate = Setting(default=1.0, kind="static", limits=(1e-6, 1e6),
                   description="output/input sample-rate ratio")

    def _frac(self) -> Fraction:
        return Fraction(float(self.settings.get("rate"))).limit_denominator(10 ** 6)

    @property
    def ratio(self):
        return self._frac()

    @property
    def alignment(self):
        return self._frac().denominator

    def init_state(self, ctx):
        return farrow_init_state(ctx.channels.get("in", 0),
                                 ctx.dtype("in", jnp.float32))

    def apply(self, state, ins, ctx):
        x = ins["in"]
        frac = self._frac()
        n_out = int(next(iter(ctx.in_len.values())) * frac)
        src_step = 1.0 / float(frac)  # input samples per output sample
        y, st = farrow_apply(x, state, ratio=src_step, n_out=n_out)
        return st, {"out": y}


@register_block("Agc")
class Agc(Block):
    """Automatic gain control: drives |y| toward ``reference`` with loop gain
    ``rate`` (per-sample feedback via scan; channels advance in parallel)."""

    IN = (Port("in"),)
    OUT = (Port("out"),)
    reference = Setting(default=1.0, limits=(1e-9, 1e9))
    rate = Setting(default=1e-3, limits=(1e-9, 1.0))
    max_gain = Setting(default=65536.0, kind="static")

    def init_state(self, ctx):
        ch = ctx.channels.get("in", 0)
        return jnp.ones(() if ch == 0 else (ch,), jnp.float32)

    def apply(self, state, ins, ctx):
        y, g = agc_apply(ins["in"], state,
                         reference=float(self.settings.get("reference")),
                         rate=float(self.settings.get("rate")),
                         max_gain=float(self.settings.get("max_gain")))
        return g, {"out": y}


@register_block("GoertzelDetector")
class GoertzelDetector(Block):
    """Single-frequency power detector (Goertzel): one normalized power value
    per ``chunk`` input samples — cheap DTMF/pilot detection."""

    IN = (Port("in", dtype="float32"),)
    OUT = (Port("out", dtype="float32"),)
    frequency = Setting(default=1000.0, kind="static", unit="Hz")
    chunk = Setting(default=1024, kind="static", limits=(8, 1 << 24))
    sample_rate_in = Setting(default=0.0, kind="static",
                             description="0 → inherit resolved edge rate")

    @property
    def ratio(self):
        return Fraction(1, int(self.settings.get("chunk")))

    @property
    def alignment(self):
        return int(self.settings.get("chunk"))

    def apply(self, state, ins, ctx):
        n = int(self.settings.get("chunk"))
        fs = float(self.settings.get("sample_rate_in")) or ctx.sample_rate
        x = ins["in"]
        xw = x.reshape(*x.shape[:-1], -1, n)
        p = jax.vmap(lambda c: goertzel_power(
            c, freq=float(self.settings.get("frequency")), sample_rate=fs))(
            xw.reshape(-1, n))
        return state, {"out": p.reshape(xw.shape[:-1])
                       if x.ndim == 1 else p.reshape(*x.shape[:-1], -1)}


@register_block("IqImbalanceCorrector")
class IqImbalanceCorrector(Block):
    """Blind IQ gain/phase imbalance correction: estimates E[I²]/E[Q²] and
    E[I·Q] per step (IIR-smoothed in state) and applies the standard
    de-imbalance transform. ≈ GNU Radio iq_imbal correction."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"),)
    alpha = Setting(default=0.05, limits=(1e-6, 1.0),
                    description="estimator smoothing per step")

    def init_state(self, ctx):
        ch = ctx.channels.get("in", 0)
        shape = () if ch == 0 else (ch,)
        return {"gain": jnp.ones(shape, jnp.float32),
                "phase": jnp.zeros(shape, jnp.float32)}

    def apply(self, state, ins, ctx):
        x = ins["in"]
        i, q = jnp.real(x), jnp.imag(x)
        a = jnp.asarray(ctx.p("alpha", 0.05), jnp.float32)
        # model: q_meas = g·q + φ·i with E[i·q] = 0 for a balanced signal
        # ⇒ φ̂ = E[i·q_m]/E[i²],  ĝ² = E[q_m²]/E[i²] − φ̂²
        pi = jnp.mean(i * i, axis=-1) + 1e-20
        pq = jnp.mean(q * q, axis=-1)
        piq = jnp.mean(i * q, axis=-1)
        phase_inst = piq / pi
        gain_inst = jnp.sqrt(jnp.maximum(pq / pi - phase_inst ** 2, 1e-12))
        gain = (1 - a) * state["gain"] + a * gain_inst
        phase = (1 - a) * state["phase"] + a * phase_inst
        # invert: q̂ = (q_m − φ̂·i)/ĝ
        qc = (q - phase[..., None] * i) / gain[..., None]
        y = (i + 1j * qc).astype(jnp.complex64)
        return {"gain": gain, "phase": phase}, {"out": y}


@register_block("CoarseFrequencyCorrector")
class CoarseFrequencyCorrector(Block):
    """M-th-power coarse CFO estimate + correction for M-PSK: the offset shows
    up at M·Δf in x^M; one FFT peak per step estimates it, an NCO removes it.
    State carries the correction phase for continuity."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"),)
    order = Setting(default=4, kind="static", choices=(2, 4, 8),
                    description="constellation order M (PSK)")

    def init_state(self, ctx):
        return {"phase": jnp.zeros((), jnp.float32),
                "freq": jnp.zeros((), jnp.float32)}  # rad/sample estimate

    def apply(self, state, ins, ctx):
        x = ins["in"]
        m = int(self.settings.get("order"))
        n = x.shape[-1]
        xm = x ** m
        spec = jnp.abs(jnp.fft.fft(xm))
        k = jnp.argmax(spec)
        # parabolic sub-bin interpolation around the peak (cyclic neighbors)
        sa = spec[(k - 1) % n]
        sb = spec[k]
        sc = spec[(k + 1) % n]
        denom = sa - 2.0 * sb + sc
        d = jnp.where(jnp.abs(denom) > 1e-20, 0.5 * (sa - sc) / denom, 0.0)
        k_signed = jnp.where(k > n // 2, k - n, k).astype(jnp.float32) + d
        # the block-length estimate is already an average — no cross-step
        # smoothing (it would slow convergence to the true offset)
        freq = 2.0 * jnp.pi * k_signed / (n * m)
        idx = jnp.arange(n, dtype=jnp.float32)
        ph = state["phase"] + freq * idx
        y = x * jnp.exp(-1j * ph.astype(jnp.complex64))
        new_phase = jnp.mod(state["phase"] + freq * n, 2.0 * jnp.pi)
        return ({"phase": new_phase, "freq": freq}, {"out": y.astype(jnp.complex64)})


@register_block("PllCarrierTracking")
class PllCarrierTracking(Block):
    """2nd-order PLL that tracks and removes a residual carrier:
    y[n] = x[n]·e^{-jφ[n]} (≈ GNU Radio pll_carriertracking_cc)."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"),)
    loop_bw = Setting(default=0.02, kind="static", limits=(1e-6, 1.0))
    max_freq = Setting(default=1.0, kind="static",
                       description="frequency clamp, rad/sample")

    def init_state(self, ctx):
        ch = ctx.channels.get("in", 0)
        shape = () if ch == 0 else (ch,)
        return {"phase": jnp.zeros(shape, jnp.float32),
                "freq": jnp.zeros(shape, jnp.float32)}

    def apply(self, state, ins, ctx):
        x = ins["in"]
        bw = float(self.settings.get("loop_bw"))
        fmax = float(self.settings.get("max_freq"))
        damp = float(np.sqrt(2.0) / 2.0)
        denom = 1.0 + 2.0 * damp * bw + bw * bw
        alpha = jnp.float32(4.0 * damp * bw / denom)
        beta = jnp.float32(4.0 * bw * bw / denom)

        def step(carry, xn):
            ph, fr = carry
            rot = jnp.exp(-1j * ph.astype(jnp.complex64))
            yn = xn * rot
            err = jnp.arctan2(jnp.imag(yn), jnp.real(yn))
            fr = jnp.clip(fr + beta * err, -fmax, fmax)
            ph = jnp.mod(ph + fr + alpha * err + np.pi, 2.0 * np.pi) - np.pi
            return (ph, fr), yn

        xT = jnp.moveaxis(x, -1, 0)
        (ph, fr), yT = jax.lax.scan(step, (state["phase"], state["freq"]), xT)
        return ({"phase": ph, "freq": fr},
                {"out": jnp.moveaxis(yT, 0, -1).astype(jnp.complex64)})


@register_block("CostasLoop")
class CostasLoop(Block):
    """Decision-directed carrier recovery for M-PSK (≈ GNU Radio
    costas_loop_cc; beyond the reference's blocklib, expected by GR users).

    Order 2 (BPSK): e = Re·Im; order 4 (QPSK): e = sign(Re)·Im − sign(Im)·Re;
    order 8 (8PSK): QPSK detector with the K = √2−1 axis weighting.
    """

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"),)
    loop_bw = Setting(default=0.02, kind="static", limits=(1e-6, 1.0))
    order = Setting(default=4, kind="static", choices=(2, 4, 8))
    max_freq = Setting(default=1.0, kind="static",
                       description="frequency clamp, rad/sample")

    def init_state(self, ctx):
        ch = ctx.channels.get("in", 0)
        shape = () if ch == 0 else (ch,)
        return {"phase": jnp.zeros(shape, jnp.float32),
                "freq": jnp.zeros(shape, jnp.float32)}

    def apply(self, state, ins, ctx):
        x = ins["in"]
        order = int(self.settings.get("order"))
        bw = float(self.settings.get("loop_bw"))
        fmax = float(self.settings.get("max_freq"))
        damp = float(np.sqrt(2.0) / 2.0)
        denom = 1.0 + 2.0 * damp * bw + bw * bw
        alpha = jnp.float32(4.0 * damp * bw / denom)
        beta = jnp.float32(4.0 * bw * bw / denom)
        k8 = jnp.float32(np.sqrt(2.0) - 1.0)

        def detector(yn):
            re, im = jnp.real(yn), jnp.imag(yn)
            if order == 2:
                return re * im
            if order == 4:
                return jnp.sign(re) * im - jnp.sign(im) * re
            # 8PSK (GR costas_loop_cc order-8 detector)
            cond = jnp.abs(re) >= jnp.abs(im)
            return jnp.where(cond,
                             jnp.sign(re) * im - jnp.sign(im) * re * k8,
                             jnp.sign(re) * im * k8 - jnp.sign(im) * re)

        def step(carry, xn):
            ph, fr = carry
            yn = xn * jnp.exp(-1j * ph.astype(jnp.complex64))
            err = detector(yn)
            fr = jnp.clip(fr + beta * err, -fmax, fmax)
            ph = jnp.mod(ph + fr + alpha * err + np.pi, 2.0 * np.pi) - np.pi
            return (ph, fr), yn

        xT = jnp.moveaxis(x, -1, 0)
        (ph, fr), yT = jax.lax.scan(step, (state["phase"], state["freq"]), xT)
        return ({"phase": ph, "freq": fr},
                {"out": jnp.moveaxis(yT, 0, -1).astype(jnp.complex64)})


@register_block("FllBandEdge")
class FllBandEdge(Block):
    """Band-edge frequency-locked loop (≈ GNU Radio fll_band_edge_cc; beyond
    the reference's blocklib). Acquires carrier offsets up to ~half the symbol
    bandwidth using the energy difference between upper/lower band-edge
    filters of the matched (RRC) pulse.

    Design: instead of the per-sample loop (O(T·K) sequential),
    the loop updates once per ``subblock`` samples — each sub-block is
    de-rotated, run through both band-edge filters as ONE batched matmul,
    and the averaged energy difference drives a first-order integrator.
    Acquisition is slower by the sub-block factor but each step is matmul work.

    In cascades keep ``loop_bw`` small (default 0.01): a wide FLL bandwidth
    jitters the de-rotation frequency at sub-block rate, phase-random-walking
    the stream and smearing downstream decision loops (measured: fll bw 0.05
    -> 67% symbol accuracy after PfbClockSync+Costas; bw 0.01 -> 100%).
    """

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"),)
    samples_per_symbol = Setting(default=4.0, kind="static")
    rolloff = Setting(default=0.35, kind="static", limits=(0.0, 1.0))
    filter_size = Setting(default=45, kind="static", limits=(3, 1024))
    loop_bw = Setting(default=0.01, kind="static", limits=(1e-6, 1.0))
    subblock = Setting(default=64, kind="static", limits=(8, 4096))
    max_freq = Setting(default=1.0, kind="static")

    def _band_edge_taps(self):
        """Upper/lower band-edge filters: a sinc-squared edge prototype
        heterodyned to ±(1+a)/(2·sps) cycles/sample (GR's design intent)."""
        if getattr(self, "_be", None) is None:
            sps = float(self.settings.get("samples_per_symbol"))
            a = float(self.settings.get("rolloff"))
            k = int(self.settings.get("filter_size"))
            n = np.arange(k, dtype=np.float64) - (k - 1) / 2.0
            # edge prototype: squared sinc ramp over the transition band a/sps
            g = np.sinc(a * n / sps) ** 2
            g /= np.sum(g)
            fe = (1.0 + a) / (2.0 * sps)          # band-edge center, cyc/sample
            rot = np.exp(2j * np.pi * fe * n)
            self._be = (np.asarray(g * rot, np.complex64),
                        np.asarray(g * np.conj(rot), np.complex64))
        return self._be

    def init_state(self, ctx):
        return {"phase": jnp.zeros((), jnp.float32),
                "freq": jnp.zeros((), jnp.float32)}

    def apply(self, state, ins, ctx):
        x = ins["in"]
        sb = int(self.settings.get("subblock"))
        k = int(self.settings.get("filter_size"))
        bw = float(self.settings.get("loop_bw"))
        fmax = float(self.settings.get("max_freq"))
        up, lo = self._band_edge_taps()
        # correlation with conj(h): downconverts the band at +fe (resp. -fe)
        # to DC, so |frames @ upj|^2 measures upper-band-edge energy. NO tap
        # reversal — reversing the symmetric-envelope taps flips e^{+j} to
        # e^{-j} and swaps the two bands (measured: loop diverges to -clamp)
        upj = jnp.asarray(np.conj(up))
        loj = jnp.asarray(np.conj(lo))
        n = x.shape[-1]
        nblk = n // sb
        xb = x[..., : nblk * sb].reshape(nblk, sb)

        def step(carry, blk):
            ph, fr = carry
            idx = jnp.arange(sb, dtype=jnp.float32)
            rot = jnp.exp(-1j * (ph + fr * idx).astype(jnp.complex64))
            y = blk * rot
            # band-edge energies over the valid region of this sub-block
            frames = jnp.stack([jax.lax.dynamic_slice_in_dim(y, i, k)
                                for i in range(0, sb - k + 1,
                                               max(1, (sb - k) // 8 or 1))])
            eu = jnp.mean(jnp.abs(frames @ upj) ** 2)
            el = jnp.mean(jnp.abs(frames @ loj) ** 2)
            err = (eu - el) / (eu + el + 1e-20)
            fr = jnp.clip(fr + jnp.float32(bw) * err, -fmax, fmax)
            ph = jnp.mod(ph + fr * sb + np.pi, 2.0 * np.pi) - np.pi
            return (ph, fr), y

        (ph, fr), yb = jax.lax.scan(step, (state["phase"], state["freq"]), xb)
        y = yb.reshape(-1)
        if n > nblk * sb:  # rotate the tail with the final estimate
            idx = jnp.arange(n - nblk * sb, dtype=jnp.float32)
            tail = x[..., nblk * sb:] * jnp.exp(
                -1j * (ph + fr * idx).astype(jnp.complex64))
            y = jnp.concatenate([y, tail], axis=-1)
            ph = jnp.mod(ph + fr * (n - nblk * sb) + np.pi,
                         2.0 * np.pi) - np.pi
        return ({"phase": ph, "freq": fr},
                {"out": y.astype(jnp.complex64)})

    def estimated_freq(self, state) -> float:
        """Current frequency estimate, rad/sample (for tests/monitoring)."""
        return float(state["freq"])


@register_block("SnrEstimator")
class SnrEstimator(Block):
    """M2M4 moments SNR estimator (≈ GNU Radio's mpsk_snr_est_cc, the
    blind/non-data-aided default): for constant-modulus constellations,
    S = sqrt(2·M2² − M4) and N = M2 − S with M2 = E|x|², M4 = E|x|⁴.
    Decimating probe: one SNR (dB) estimate per ``chunk`` samples; running
    moments carry in state with an EMA (``alpha``) across chunks."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="float32"),)
    chunk = Setting(default=1024, kind="static")
    alpha = Setting(default=0.0, kind="static",
                    description="EMA across chunks (0 = independent)")

    @property
    def ratio(self):
        from fractions import Fraction
        return Fraction(1, int(self.settings.get("chunk")))

    @property
    def alignment(self):
        return int(self.settings.get("chunk"))

    def init_state(self, ctx):
        return {"m2": jnp.zeros((), jnp.float32),
                "m4": jnp.zeros((), jnp.float32),
                "warm": jnp.zeros((), jnp.bool_)}

    def apply(self, state, ins, ctx):
        x = ins["in"]
        n = int(self.settings.get("chunk"))
        frames = x.reshape(x.shape[:-1] + (-1, n))
        p = (frames.real ** 2 + frames.imag ** 2).astype(jnp.float32)
        m2 = p.mean(axis=-1)
        m4 = (p * p).mean(axis=-1)
        a = float(self.settings.get("alpha"))
        if a > 0.0:
            def ema(carry, mm):
                m2p, m4p, warm = carry
                m2c, m4c = mm
                m2n = jnp.where(warm, a * m2p + (1 - a) * m2c, m2c)
                m4n = jnp.where(warm, a * m4p + (1 - a) * m4c, m4c)
                return (m2n, m4n, jnp.ones((), jnp.bool_)), (m2n, m4n)
            (m2l, m4l, warm), (m2, m4) = jax.lax.scan(
                ema, (state["m2"], state["m4"], state["warm"]),
                (m2.reshape(-1), m4.reshape(-1)))
            new_state = {"m2": m2l, "m4": m4l, "warm": warm}
            m2 = m2.reshape(frames.shape[:-1])
            m4 = m4.reshape(frames.shape[:-1])
        else:
            new_state = state
        s = jnp.sqrt(jnp.maximum(2.0 * m2 * m2 - m4, 1e-20))
        noise = jnp.maximum(m2 - s, 1e-20)
        snr_db = 10.0 * jnp.log10(s / noise)
        return new_state, {"out": snr_db.astype(jnp.float32)}
