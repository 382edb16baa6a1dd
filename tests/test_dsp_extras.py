"""Farrow arbitrary-rate resampler, AGC, Goertzel, PLL carrier tracking."""

import numpy as np
import pytest

import gnuradio4_tpu as gr
from gnuradio4_tpu.blocks.dsp_extras import (Agc, FarrowResampler,
                                             GoertzelDetector,
                                             PllCarrierTracking)
from gnuradio4_tpu.blocks.basic import ComplexToneSource
from gnuradio4_tpu.blocks.testing import VectorSink, VectorSource


def run_chain(*blocks, block_len=1024, sample_rate=1.0):
    g = gr.Graph()
    g.connect_chain(*blocks)
    gr.Scheduler(g, block_len=block_len,
                 sample_rate=sample_rate).run_and_wait()


class TestFarrow:
    @pytest.mark.parametrize("rate", [0.75, 1.0, 1.5, 0.9837])
    def test_tone_frequency_preserved(self, rate):
        fs = 48000.0
        f0 = 1000.0
        n = 48000
        t = np.arange(n) / fs
        x = np.sin(2 * np.pi * f0 * t).astype(np.float32)
        src = VectorSource(x)
        fr = FarrowResampler(rate=rate)
        snk = VectorSink()
        run_chain(src, fr, snk, block_len=8000, sample_rate=fs)
        y = snk.data()
        fs_out = fs * rate
        assert abs(len(y) - n * rate) <= 8000 * rate + 1
        seg = y[1000:1000 + 8192]
        spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
        f_meas = np.argmax(spec) * fs_out / len(seg)
        assert abs(f_meas - f0) < fs_out / len(seg) * 1.5
        # amplitude preserved (cubic interpolation ripple < 1%)
        assert abs(np.max(np.abs(seg)) - 1.0) < 0.02

    def test_sine_waveform_accuracy(self):
        """Resampled sine matches the analytically resampled signal."""
        fs = 1000.0
        rate = 4.0 / 3.0
        n = 3000
        x = np.sin(2 * np.pi * 50.0 * np.arange(n) / fs).astype(np.float32)
        src = VectorSource(x)
        fr = FarrowResampler(rate=rate)
        snk = VectorSink()
        run_chain(src, fr, snk, block_len=600, sample_rate=fs)
        y = snk.data()
        # the streaming interpolator has a fixed 2-input-sample latency
        t_out = (np.arange(len(y)) * (1.0 / rate) - 2.0) / fs
        ref = np.sin(2 * np.pi * 50.0 * t_out)
        # skip edges (history priming)
        np.testing.assert_allclose(y[10:-10], ref[10:-10], atol=5e-3)


class TestAgc:
    def test_levels_varying_amplitude(self):
        n = 20000
        env = np.concatenate([np.full(n // 2, 0.1), np.full(n // 2, 5.0)])
        x = (env * np.sin(2 * np.pi * 0.05 * np.arange(n))).astype(np.float32)
        src = VectorSource(x)
        agc = Agc(reference=1.0, rate=5e-3)
        snk = VectorSink()
        run_chain(src, agc, snk, block_len=5000)
        y = snk.data()
        # a 34 dB input step must be leveled: both settled halves have similar
        # RMS near the reference (loop tracks |x| so ripple remains)
        rms1 = np.sqrt(np.mean(y[7000:9000] ** 2))
        rms2 = np.sqrt(np.mean(y[17000:] ** 2))
        assert 0.4 < rms1 < 1.6 and 0.4 < rms2 < 1.6
        assert abs(rms1 - rms2) / rms1 < 0.25
        # without AGC the halves differ by 50×
        assert np.std(x[17000:]) / np.std(x[7000:9000]) > 40


class TestGoertzel:
    def test_detects_target_tone_only(self):
        fs = 8000.0
        n = 8192
        t = np.arange(n) / fs
        x = (np.sin(2 * np.pi * 941.0 * t)).astype(np.float32)  # DTMF column
        src = VectorSource(x)
        det_hit = GoertzelDetector(frequency=941.0, chunk=1024,
                                   sample_rate_in=fs)
        snk = VectorSink()
        run_chain(src, det_hit, snk, block_len=2048, sample_rate=fs)
        hit = snk.data()
        assert hit.shape == (8,)
        np.testing.assert_allclose(hit, 1.0, atol=0.05)  # unit-amp tone → ~1

        src2 = VectorSource(x)
        det_miss = GoertzelDetector(frequency=1336.0, chunk=1024,
                                    sample_rate_in=fs)
        snk2 = VectorSink()
        run_chain(src2, det_miss, snk2, block_len=2048, sample_rate=fs)
        assert np.all(snk2.data() < 0.01)


class TestPll:
    def test_removes_carrier_offset(self):
        fs = 100e3
        f_off = 500.0
        g = gr.Graph()
        src = ComplexToneSource(frequency=f_off, n_samples=65536)
        pll = PllCarrierTracking(loop_bw=0.02)
        snk = VectorSink()
        g.connect_chain(src, pll, snk)
        gr.Scheduler(g, block_len=16384, sample_rate=fs).run_and_wait()
        y = snk.data()
        # after lock the output sits at DC: residual rotation per sample → 0
        tail = y[40000:]
        dphi = np.angle(tail[1:] * np.conj(tail[:-1]))
        assert np.abs(np.mean(dphi)) < 1e-3
        # locked output magnitude ≈ 1
        np.testing.assert_allclose(np.abs(tail), 1.0, atol=1e-2)


class TestIqImbalance:
    def test_corrects_gain_and_phase_skew(self, rng):
        n = 65536
        clean = np.exp(2j * np.pi * rng.random(n)).astype(np.complex64)
        # introduce imbalance: q scaled 0.8, phase skew 0.1·i leaking into q
        i, q = clean.real, clean.imag
        skewed = (i + 1j * (0.8 * q - 0.1 * i)).astype(np.complex64)
        from gnuradio4_tpu.blocks.dsp_extras import IqImbalanceCorrector
        from gnuradio4_tpu.blocks.testing import VectorSink, VectorSource
        import gnuradio4_tpu as gr
        g = gr.Graph()
        src = VectorSource(skewed)
        fix = IqImbalanceCorrector(alpha=0.4)
        snk = VectorSink()
        g.connect_chain(src, fix, snk)
        gr.Scheduler(g, block_len=8192).run_and_wait()
        y = snk.data()[32768:]
        # image rejection: for a circular signal, E[y²] ≈ 0 when balanced
        image_in = abs(np.mean(skewed[32768:] ** 2))
        image_out = abs(np.mean(y ** 2))
        assert image_out < 0.2 * image_in


class TestCoarseCfo:
    def test_removes_qpsk_offset(self, rng):
        from gnuradio4_tpu.blocks.dsp_extras import CoarseFrequencyCorrector
        from gnuradio4_tpu.blocks.testing import VectorSink, VectorSource
        from gnuradio4_tpu.ops.digital import make_constellation, symbols_to_iq
        import gnuradio4_tpu as gr
        import jax.numpy as jnp
        n = 32768
        syms = rng.integers(0, 4, n)
        iq = np.asarray(symbols_to_iq(jnp.asarray(syms), make_constellation("QPSK")))
        w = 2 * np.pi * 0.003  # offset well within bin resolution
        rot = iq * np.exp(1j * w * np.arange(n))
        g = gr.Graph()
        src = VectorSource(rot.astype(np.complex64))
        cfo = CoarseFrequencyCorrector(order=4)
        snk = VectorSink()
        g.connect_chain(src, cfo, snk)
        gr.Scheduler(g, block_len=8192).run_and_wait()
        y = snk.data()[16384:]
        # residual rotation ≈ 0: the 4th-power spectrum of y peaks at DC
        y4 = y ** 4
        spec = np.abs(np.fft.fft(y4))
        k = np.argmax(spec)
        assert k == 0 or k == len(y4) - 1 or k == 1


class TestCostasLoop:
    @staticmethod
    def _run(order, syms_per_sym, cfo, ph0, nsym=16384, bw=0.05):
        rng = np.random.default_rng(0)
        m = order
        # BPSK locks to the real axis (no offset); QPSK/8PSK to pi/m offsets
        off = 0.0 if m == 2 else np.pi / m
        pts = np.exp(1j * (off + 2 * np.pi / m *
                           rng.integers(0, m, nsym)))
        x = (pts * np.exp(1j * (cfo * np.arange(nsym) + ph0))
             ).astype(np.complex64)
        g = gr.Graph()
        src = g.emplace("StreamSource", dtype="complex64")
        cl = g.emplace("CostasLoop", order=order, loop_bw=bw)
        snk = g.emplace("VectorSink")
        g.connect_chain(src, cl, snk)
        src.push(x)
        src.close()
        gr.Scheduler(g, block_len=4096, sample_rate=1e6).run_and_wait()
        return np.asarray(snk.data())[:nsym]

    @pytest.mark.parametrize("order", [2, 4, 8])
    def test_locks_on_residual_carrier(self, order):
        y = self._run(order, 1, cfo=0.003, ph0=0.7)
        tail = y[10000:]
        m = order
        off = 0.0 if m == 2 else np.pi / m
        # post-lock samples sit on the constellation modulo the 2pi/m ambiguity
        ang = np.angle(tail * np.exp(-1j * off))
        err = np.abs(((ang + np.pi / m) % (2 * np.pi / m)) - np.pi / m)
        assert np.degrees(err.mean()) < 4.0, \
            f"order {m}: mean angular error {np.degrees(err.mean()):.2f} deg"

    def test_state_continuity_across_blocks(self):
        y1 = self._run(4, 1, cfo=0.002, ph0=0.3)
        # same input through tiny blocks must match (state carries phase/freq)
        rng = np.random.default_rng(0)
        pts = np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, 16384)))
        x = (pts * np.exp(1j * (0.002 * np.arange(16384) + 0.3))
             ).astype(np.complex64)
        g = gr.Graph()
        src = g.emplace("StreamSource", dtype="complex64")
        cl = g.emplace("CostasLoop", order=4, loop_bw=0.05)
        snk = g.emplace("VectorSink")
        g.connect_chain(src, cl, snk)
        src.push(x)
        src.close()
        gr.Scheduler(g, block_len=512, sample_rate=1e6).run_and_wait()
        y2 = np.asarray(snk.data())[:16384]
        np.testing.assert_allclose(y1, y2, atol=2e-5)


class TestFllBandEdge:
    @staticmethod
    def _shaped_qpsk(nsym=16384, sps=4, alpha=0.35, cfo=0.0, seed=0):
        from gnuradio4_tpu.ops.digital import rrc_taps
        rng = np.random.default_rng(seed)
        syms = np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, nsym)))
        ups = np.zeros(nsym * sps, complex)
        ups[::sps] = syms
        h = rrc_taps(sps, 11 * sps + 1, beta=alpha)
        shaped = np.convolve(ups, h)[: nsym * sps]
        return (shaped * np.exp(1j * cfo * np.arange(len(shaped)))
                ).astype(np.complex64)

    @pytest.mark.parametrize("cfo", [0.02, -0.05])
    def test_acquires_cfo(self, cfo):
        x = self._shaped_qpsk(cfo=cfo)
        g = gr.Graph()
        src = g.emplace("StreamSource", dtype="complex64")
        fll = g.emplace("FllBandEdge", samples_per_symbol=4, rolloff=0.35,
                        loop_bw=0.05)
        snk = g.emplace("VectorSink")
        g.connect_chain(src, fll, snk)
        src.push(x)
        src.close()
        sch = gr.Scheduler(g, block_len=8192, sample_rate=1e6)
        sch.run_and_wait()
        est = float(np.asarray(sch._states[fll.unique_name]["freq"]))
        assert abs(est - cfo) < 0.005, f"estimate {est} vs true {cfo}"

    def test_fll_costas_cascade_zeroes_cfo(self):
        """Classic receiver front half: FLL coarse pull-in + Costas fine."""
        x = self._shaped_qpsk(cfo=0.04)
        g = gr.Graph()
        src = g.emplace("StreamSource", dtype="complex64")
        fll = g.emplace("FllBandEdge", samples_per_symbol=4, rolloff=0.35,
                        loop_bw=0.05)
        cst = g.emplace("CostasLoop", order=4, loop_bw=0.02)
        snk = g.emplace("VectorSink")
        g.connect_chain(src, fll, cst, snk)
        src.push(x)
        src.close()
        gr.Scheduler(g, block_len=8192, sample_rate=1e6).run_and_wait()
        y = np.asarray(snk.data())[-16384:]
        S = np.abs(np.fft.fftshift(np.fft.fft(y ** 4)))
        f = np.fft.fftshift(np.fft.fftfreq(len(y)))
        resid = abs(f[np.argmax(S)] * 2 * np.pi / 4)
        assert resid < 1e-3


class TestSnrEstimator:
    """M2M4 blind SNR estimation on QPSK: accuracy across the SNR range,
    decimation geometry, and the cross-chunk EMA state."""

    def _run(self, snr_db, chunk=4096, alpha=0.0, n=65536, seed=0):
        import gnuradio4_tpu as gr
        from gnuradio4_tpu.blocks.testing import VectorSink, VectorSource
        rng = np.random.default_rng(seed)
        sym = np.exp(1j * (np.pi / 4 + np.pi / 2
                           * rng.integers(0, 4, n))).astype(np.complex64)
        npow = 10 ** (-snr_db / 10)
        x = (sym + np.sqrt(npow / 2)
             * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
             ).astype(np.complex64)
        g = gr.Graph()
        s = g.add(VectorSource(x))
        est = g.emplace("SnrEstimator", chunk=chunk, alpha=alpha)
        v = g.add(VectorSink())
        g.connect_chain(s, est, v)
        gr.Scheduler(g, block_len=4 * chunk,
                     sample_rate=1e6).run_and_wait()
        return np.asarray(v.data())

    @pytest.mark.parametrize("snr", [3.0, 10.0, 20.0])
    def test_accuracy(self, snr):
        out = self._run(snr)
        assert len(out) == 16            # decimating: one per chunk
        assert abs(np.mean(out) - snr) < 0.5

    def test_ema_smooths_variance(self):
        raw = self._run(10.0, chunk=512)
        smooth = self._run(10.0, chunk=512, alpha=0.9)
        assert np.std(smooth[16:]) < 0.5 * np.std(raw[16:])
        assert abs(np.mean(smooth[32:]) - 10.0) < 0.7


class TestSoftDemapper:
    """Max-log LLR demapping: sign correctness across constellations,
    noise_var confidence scaling, and the QPSK+LDPC soft link."""

    def _llrs(self, kind, iq, nv=0.01):
        import gnuradio4_tpu as gr
        from gnuradio4_tpu.blocks.testing import VectorSink, VectorSource
        g = gr.Graph()
        s = g.add(VectorSource(np.asarray(iq, np.complex64)))
        d = g.emplace("SoftDemapper", constellation=kind, noise_var=nv)
        v = g.add(VectorSink())
        g.connect_chain(s, d, v)
        gr.Scheduler(g, block_len=len(iq),
                     sample_rate=1e6).run_and_wait()
        return np.asarray(v.data())

    @pytest.mark.parametrize("kind", ["BPSK", "QPSK", "8PSK", "QAM16"])
    def test_clean_points_sign_correct(self, kind):
        from gnuradio4_tpu.ops.digital import make_constellation
        table = make_constellation(kind)
        m = len(table)
        nb = int(np.log2(m))
        llr = self._llrs(kind, table).reshape(m, nb)
        bits = (np.arange(m)[:, None] >> np.arange(nb)) & 1
        assert np.all((llr < 0) == (bits == 1))

    def test_noise_var_scales_confidence(self):
        from gnuradio4_tpu.ops.digital import make_constellation
        table = make_constellation("QPSK")
        hi = self._llrs("QPSK", table, nv=0.01)
        lo = self._llrs("QPSK", table, nv=1.0)
        np.testing.assert_allclose(hi, lo * 100.0, rtol=1e-4)

    def test_qpsk_ldpc_soft_link(self):
        import gnuradio4_tpu as gr
        from gnuradio4_tpu.blocks.testing import VectorSink, VectorSource
        from gnuradio4_tpu.ops.digital import make_constellation
        from gnuradio4_tpu.ops.ldpc import encode, make_ldpc
        H, G = make_ldpc(256, 128, wc=3, seed=0)
        k = G.shape[0]
        rng = np.random.default_rng(5)
        u = rng.integers(0, 2, 8 * k).astype(np.uint8)
        c = encode(G, u.reshape(-1, k)).reshape(-1)
        labels = (c[0::2] | (c[1::2] << 1)).astype(np.int64)
        table = make_constellation("QPSK")
        sigma = 0.35
        y = (table[labels] + sigma / np.sqrt(2)
             * (rng.standard_normal(len(labels))
                + 1j * rng.standard_normal(len(labels))
                )).astype(np.complex64)
        g = gr.Graph()
        s = g.add(VectorSource(y))
        sd = g.emplace("SoftDemapper", constellation="QPSK",
                       noise_var=sigma ** 2)
        dec = g.emplace("LdpcDecoder", n=256, m=128, seed=0)
        v = g.add(VectorSink())
        g.connect_chain(s, sd, dec, v)
        gr.Scheduler(g, block_len=512, sample_rate=1e6).run_and_wait()
        np.testing.assert_array_equal(np.asarray(v.data()),
                                      u.astype(np.float32))


class TestComplexExpRamp:
    """Factored outer-product NCO (round-4): O(√n) transcendentals must match
    the direct per-sample sin/cos NCO to f32 rounding, across the small-n
    direct path, non-power-of-two lengths, and phase/dphi wraps."""

    # NB: the ramp calls run under jax.jit — production always traces them
    # (compiled block programs).

    def test_matches_direct_form(self):
        import jax
        import jax.numpy as jnp
        from gnuradio4_tpu.ops.signal import (complex_exp, complex_exp_ramp,
                                              nco_phases, phase_to_frac)
        for n in (64, 8192, 16384, 40960, 12288 * 3):
            for dphi in (7, 123456789, 0x80000001, 0):
                for ph0 in (0, 0xDEADBEEF):
                    direct = jax.jit(lambda p, d, n=n: complex_exp(
                        phase_to_frac(nco_phases(p, d, n))))(
                        jnp.uint32(ph0), jnp.uint32(dphi))
                    fact = jax.jit(lambda p, d, n=n: complex_exp_ramp(
                        p, d, n))(jnp.uint32(ph0), jnp.uint32(dphi))
                    np.testing.assert_allclose(
                        np.asarray(fact), np.asarray(direct), atol=2e-6,
                        err_msg=f"n={n} dphi={dphi} ph0={ph0}")

    def test_amplitude_folded(self):
        import jax
        import jax.numpy as jnp
        from gnuradio4_tpu.ops.signal import complex_exp_ramp
        y = jax.jit(lambda: complex_exp_ramp(
            jnp.uint32(0), jnp.uint32(1 << 20), 16384,
            amplitude=jnp.float32(2.5)))()
        np.testing.assert_allclose(np.abs(np.asarray(y)), 2.5, atol=1e-5)

    def test_phase_continuity_across_steps(self):
        # two steps of n/2 starting from the carried phase == one step of n
        import jax
        import jax.numpy as jnp
        from gnuradio4_tpu.ops.signal import complex_exp_ramp
        n, dphi = 32768, 987654321
        ramp = lambda nn: jax.jit(
            lambda p, d: complex_exp_ramp(p, d, nn))
        full = np.asarray(ramp(n)(jnp.uint32(5), jnp.uint32(dphi)))
        a = np.asarray(ramp(n // 2)(jnp.uint32(5), jnp.uint32(dphi)))
        ph2 = np.uint32((5 + np.uint64(dphi) * (n // 2)) % (1 << 32))
        b = np.asarray(ramp(n // 2)(jnp.asarray(ph2, jnp.uint32),
                                 jnp.uint32(dphi)))
        np.testing.assert_allclose(np.concatenate([a, b]), full, atol=4e-7)
