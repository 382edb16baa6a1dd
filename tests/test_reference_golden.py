"""Golden parity against the reference's own qa stimulus (VERDICT #10).

Reproduces the behavioral contracts of the reference test suite on IDENTICAL
stimulus — same coefficients, signals, thresholds — so "within GR4's tolerance
on identical stimulus" is asserted directly, not approximated via SciPy:

- blocks/filter/test/qa_filter.cpp:46-127  (FIR/IIR step responses, settling
  times, direct-form equality)
- blocks/filter/test/qa_filter.cpp:134-219 (BasicFilter in-band/out-of-band)
- blocks/fourier/test/qa_fourier.cpp:49-100 (N=256 FFT of a 0.1·fs tone:
  Gauss-interpolated peak within 1/N of the test frequency)

All expected values are re-derived here from the reference's *stated*
parameters; no code is copied.
"""

import numpy as np
import pytest
import jax.numpy as jnp

import gnuradio4_tpu as gr
from gnuradio4_tpu.blocks.testing import VectorSink, VectorSource


def settling_time(resp, step_value=1.0, threshold=1e-3):
    """Index from which the response stays within step_value ± threshold
    (≈ reference estimate_settling_time, qa_filter.cpp:15-44: the index of the
    last out-of-bounds excursion, or of the first in-bounds sample)."""
    lo, hi = step_value - threshold, step_value + threshold
    inb = [(lo <= v <= hi) for v in resp]
    if not any(inb):
        raise AssertionError("no settling")
    first = inb.index(True)
    last_bad = max((i for i in range(first, len(resp)) if not inb[i]),
                   default=None)
    return last_bad if last_bad is not None else first


def _run_chain(block, x, block_len=None):
    g = gr.Graph()
    src = VectorSource(np.asarray(x, np.float32))
    snk = VectorSink()
    g.connect_chain(src, block, snk)
    gr.Scheduler(g, block_len=block_len or len(x),
                 pipeline_depth=1).run_and_wait()
    return snk.data()


STEP20 = np.array([0.0] + [1.0] * 19, np.float32)   # qa_filter's step input


class TestQaFilterGolden:
    def test_fir_boxcar_step_settling(self):
        """10-tap 0.1 boxcar on the step: y[0]=0, settles at index 10
        (qa_filter.cpp:51,80-84)."""
        fir = gr.global_registry.create("FirFilter", taps=(0.1,) * 10)
        y = _run_chain(fir, STEP20)
        assert y[0] == 0.0
        assert settling_time(y) == 10

    def test_iir_one_pole_step(self):
        """b=[0.55,0], a=[1,-0.45] step: y[0]=0; y[n]=1-0.45^n for n>=1
        (qa_filter.cpp:52-53). The reference's asserted settling of 5 comes
        from its loop stepping the same filter object twice per index
        (qa_filter.cpp:74-77) — equivalent to the even subsequence of the true
        response; both views are pinned here."""
        iir = gr.global_registry.create("IirFilter", b=(0.55, 0.0),
                                        a=(1.0, -0.45))
        y = _run_chain(iir, STEP20)
        assert y[0] == 0.0
        n = np.arange(1, 20)
        np.testing.assert_allclose(y[1:], 1.0 - 0.45 ** n, atol=1e-5)
        assert settling_time(y) == 9            # honest single-stepped filter
        y2 = np.asarray([1.0 - 0.45 ** (2 * i) if i else 0.0
                         for i in range(20)])   # reference's double-stepped view
        assert settling_time(y2) == 5           # matches qa_filter.cpp:85-86

    def test_iir_second_order_forms_agree(self):
        """The reference checks 4 direct forms agree within 1e-5 on the exact
        Butterworth-ish biquad (qa_filter.cpp:95-126); here both engines
        (sequential scan, O(log T) parallel partial fractions) must match the
        double-precision reference recurrence."""
        b = (0.020083365564211, 0.040166731128423, 0.020083365564211)
        a = (1.0, -1.561018075800718, 0.641351538057563)
        # double-precision direct-form reference
        yref = np.zeros(20)
        for n in range(20):
            x0 = 0.0 if n == 0 else 1.0
            x1 = 0.0 if n - 1 <= 0 else 1.0
            x2 = 0.0 if n - 2 <= 0 else 1.0
            yref[n] = (b[0] * x0 + b[1] * x1 + b[2] * x2
                       - a[1] * (yref[n - 1] if n >= 1 else 0.0)
                       - a[2] * (yref[n - 2] if n >= 2 else 0.0))
        for engine in ("scan", "parallel"):
            iir = gr.global_registry.create("IirFilter", b=b, a=a,
                                            engine=engine)
            y = _run_chain(iir, STEP20)
            np.testing.assert_allclose(y, yref, atol=1e-5), engine

    @pytest.mark.parametrize("kind,f_sig,bound,cmp", [
        ("inband", 50.0, 0.9, "ge"),
        ("outofband", 300.0, 0.2, "le"),
    ])
    def test_basic_filter_band_behavior(self, kind, f_sig, bound, cmp):
        """BasicFilter LP (fs=1000, f_low=100, Hamming FIR): in-band 50 Hz sine
        keeps max |y| >= 0.9, out-of-band 300 Hz attenuates to <= 0.2 over the
        second 1000 samples (qa_filter.cpp:141-196)."""
        n = 2000
        t = np.arange(1, n + 1)
        x = np.sin(2 * np.pi * f_sig / 1000.0 * t).astype(np.float32)
        filt = gr.global_registry.create(
            "BasicFilter", filter_type="lowpass", f_low=100.0, ntaps=29,
            window="Hamming", sample_rate_design=1000.0)
        y = _run_chain(filt, x, block_len=1000)
        mx = float(np.max(np.abs(y[1000:])))
        if cmp == "ge":
            assert mx >= bound, (kind, mx)
        else:
            assert mx <= bound, (kind, mx)

    def test_basic_decimating_filter_band_behavior(self):
        """BasicDecimatingFilter (decim 5): same band contract at the
        decimated rate (qa_filter.cpp:209-219)."""
        n = 2000
        t = np.arange(1, n + 1)
        filt_args = dict(filter_type="lowpass", f_low=100.0, ntaps=30,
                         window="Hamming", sample_rate_design=1000.0, decim=5)
        x_in = np.sin(2 * np.pi * 50.0 / 1000.0 * t).astype(np.float32)
        f1 = gr.global_registry.create("BasicDecimatingFilter", **filt_args)
        y = _run_chain(f1, x_in, block_len=1000)
        assert y.shape[0] == n // 5
        # 50 Hz decimated to fs=200 samples the sine on a fixed π/2 phase
        # grid, so max|y| depends on the design's group delay (the reference's
        # own 0.9 bound holds only for its particular phase luck) — assert the
        # phase-independent quantity instead: full sine RMS = 1/√2
        rms = float(np.sqrt(np.mean(y[200:] ** 2)))
        assert rms >= 0.9 / np.sqrt(2), rms
        x_out = np.sin(2 * np.pi * 300.0 / 1000.0 * t).astype(np.float32)
        f2 = gr.global_registry.create("BasicDecimatingFilter", **filt_args)
        y2 = _run_chain(f2, x_out, block_len=1000)
        assert float(np.max(np.abs(y2[200:]))) <= 0.2


class TestQaFourierGolden:
    def test_fft_tone_peak_gauss_interpolated(self):
        """N=256, fs=1, f=0.1·fs unit sine → the interpolated magnitude peak
        lies within 1/N of the test frequency (qa_fourier.cpp:49-100)."""
        from gnuradio4_tpu.ops.estimators import gauss_interpolated_peak
        n = 256
        fs = 1.0
        f = 0.1 * fs
        t = np.arange(1, n + 1)
        x = np.sin(2 * np.pi * f / fs * t).astype(np.float32)

        g = gr.Graph()
        src = VectorSource(x)
        fft = g.emplace("FFT", fft_size=n, window="None", output="magnitude")
        snk = VectorSink()
        g.connect_chain(src, fft, snk)
        gr.Scheduler(g, block_len=n, sample_rate=fs,
                     pipeline_depth=1).run_and_wait()
        mag = snk.data()[:n]
        # real-signal spectrum: search the positive-frequency half like the
        # reference's real-input magnitude spectrum
        half = mag[: n // 2]
        pos = gauss_interpolated_peak(half)   # the reference's interpolator
        freq_est = pos * fs / n
        assert abs(freq_est - f) <= 1.0 / n, freq_est

    def test_fft_frequency_axis_conventions(self):
        """Complex input: axis spans [-N/2·Δf, (N/2-1)·Δf]; real input starts
        at 0 (qa_fourier.cpp:76-84)."""
        from gnuradio4_tpu.ops.fft import freq_axis
        n = 256
        fs = 1.0
        ax_c = freq_axis(n, fs, shifted=True)
        assert ax_c[0] == pytest.approx(-(n / 2) * fs / n, abs=1e-4)
        assert ax_c[-1] == pytest.approx((n / 2 - 1) * fs / n, abs=1e-4)
        ax_r = freq_axis(n, fs, one_sided=True)
        assert ax_r[0] == pytest.approx(0.0, abs=1e-9)


class TestQaSvdDenoiserGolden:
    """Mirrors the reference's qa_SvdDenoiser.cpp 'denoising quality' stimulus
    (blocks/filter/test/qa_SvdDenoiser.cpp:48-89): 512-sample 50 Hz sine at
    fs=1000 with sigma=0.3 Gaussian noise, window 64, max_rank 3,
    energy_fraction 0.95 — denoised RMS error must beat the noisy RMS error."""

    def test_denoising_quality_stimulus(self):
        rng = np.random.default_rng(42)
        fs, n = 1000.0, 512
        t = np.arange(n) / fs
        clean = np.sin(2 * np.pi * 50.0 * t).astype(np.float32)
        noisy = clean + 0.3 * rng.standard_normal(n).astype(np.float32)
        for engine in ("xla", "jacobi"):
            g = gr.Graph()
            src = g.emplace("VectorSource", data=noisy)
            dn = g.emplace("SvdDenoiser", chunk=256, window=64, rank=3,
                           energy_fraction=0.95, engine=engine)
            snk = g.emplace("VectorSink")
            g.connect_chain(src, dn, snk)
            gr.Scheduler(g, block_len=256, sample_rate=fs).run_and_wait()
            den = snk.data()
            rms_noisy = np.sqrt(np.mean((noisy - clean) ** 2))
            rms_den = np.sqrt(np.mean((den - clean) ** 2))
            assert rms_den < rms_noisy, (engine, rms_den, rms_noisy)

    def test_energy_fraction_rank_rule(self):
        # rank_mask == the reference's computeEffectiveRank sequential loop
        from gnuradio4_tpu.ops.svd import rank_mask

        def ref_rank(s, max_rank, frac, rel=0.0, absth=0.0):
            total = float(np.sum(np.square(s)))
            cutoff, cum, rank = frac * total, 0.0, 0
            for sigma in s:
                if rank >= max_rank or sigma / s[0] < rel or sigma < absth:
                    break
                cum += sigma * sigma
                rank += 1
                if cum >= cutoff:
                    break
            return max(rank, 1)

        rng = np.random.default_rng(5)
        for _ in range(50):
            s = np.sort(rng.random(8).astype(np.float32))[::-1]
            max_rank = int(rng.integers(1, 9))
            frac = float(rng.random())
            rel = float(rng.random() * 0.5)
            absth = float(rng.random() * 0.3)
            m = np.asarray(rank_mask(jnp.asarray(s), max_rank=max_rank,
                                     energy_fraction=frac, rel_threshold=rel,
                                     abs_threshold=absth))
            got = int(np.sum(m))
            want = ref_rank(s, max_rank, frac, rel, absth)
            assert got == want, (s, max_rank, frac, rel, absth, got, want)
            assert np.all(m[:got]) and not np.any(m[got:])   # prefix mask


class TestQaBurstTaperGolden:
    """Mirrors qa_BurstTaper.cpp coefficient-generation properties
    (algorithm/test/qa_BurstTaper.cpp:25-65) against ops.estimators.taper_edge
    (same formula family as BurstTaper.hpp:256-283 computeRise)."""

    SHAPES = ("linear", "raised_cosine", "gaussian", "mushroom",
              "mushroom_sine")

    def test_lengths_and_empty(self):
        from gnuradio4_tpu.ops.estimators import taper_edge, TAPER_SHAPES
        for kind in TAPER_SHAPES:
            assert taper_edge(kind, 64).shape == (64,)
            assert taper_edge(kind, 0).shape == (0,)
            assert taper_edge(kind, 1).shape == (1,)

    def test_rising_edge_endpoints(self):
        from gnuradio4_tpu.ops.estimators import taper_edge
        for kind in self.SHAPES:
            e = taper_edge(kind, 128, rising=True)
            assert abs(e[0]) < 1e-6, kind
            assert abs(e[-1] - 1.0) < 1e-6, kind

    def test_falling_edge_endpoints_and_symmetry(self):
        from gnuradio4_tpu.ops.estimators import taper_edge
        for kind in self.SHAPES:
            rise = taper_edge(kind, 128, rising=True)
            fall = taper_edge(kind, 128, rising=False)
            assert abs(fall[0] - 1.0) < 1e-6 and abs(fall[-1]) < 1e-6, kind
            np.testing.assert_allclose(fall[::-1], rise, atol=1e-12)

    def test_tukey_flat_region_and_param(self):
        from gnuradio4_tpu.ops.estimators import taper_edge
        e = taper_edge("tukey", 100, param=0.5)
        u = np.arange(100) / 99.0
        assert np.all(e[u >= 0.25] == 1.0)          # flat above alpha/2
        assert np.all(e[u < 0.25] <= 1.0)

    def test_full_taper_layout(self):
        from gnuradio4_tpu.ops.estimators import taper
        env = taper("raised_cosine", 16, 32, 16)
        assert env.shape == (64,)
        assert np.all(env[16:48] == 1.0)
        assert abs(env[0]) < 1e-9 and abs(env[-1]) < 1e-9

    def test_mushroom_bounded_below(self):
        # the reference's block test only demands samples >= -1
        from gnuradio4_tpu.ops.estimators import taper_edge
        for kind in ("mushroom", "mushroom_sine"):
            e = taper_edge(kind, 256)
            assert np.all(e >= -1.0), kind

    def test_block_uses_shape(self):
        from gnuradio4_tpu.ops.estimators import taper_edge
        from gnuradio4_tpu.core.tags import Tag, Keys
        n, ramp_l = 512, 32
        for kind in ("linear", "gaussian"):
            g = gr.Graph()
            src = g.emplace("TagSource", value=1.0, n_samples=n,
                            tags=[Tag(64, {Keys.TRIGGER_NAME:
                                           "burst_start"})])
            bt = g.emplace("BurstTaper", ramp_len=ramp_l, shape=kind)
            snk = g.emplace("VectorSink")
            g.connect_chain(src, bt, snk)
            gr.Scheduler(g, block_len=n).run_and_wait()
            y = snk.data()
            ramp = taper_edge(kind, ramp_l).astype(np.float32)
            np.testing.assert_allclose(y[64:64 + ramp_l], ramp, atol=1e-6)
            np.testing.assert_allclose(y[64 + ramp_l:], 1.0, atol=1e-6)


class TestQaDataSetEstimatorsGolden:
    """Mirrors qa_DataSetEstimators.cpp 'basic estimators' (algorithm/test/
    qa_DataSetEstimators.cpp:186-260): the 11-sample triangular dataset
    [0, 0.2, …, 1, …, 0.2, 0] and the reference's exact expectations.
    Name map: reference getRms = deviation from mean (our ``std``);
    computeInterpolatedFWHM = our ``fwhm``."""

    TRI = np.array([0, .2, .4, .6, .8, 1., .8, .6, .4, .2, 0])

    def test_triangular_table(self):
        from gnuradio4_tpu.ops import estimators as est
        y = self.TRI
        assert est.peak_index(y) == 5                      # getMaximum index
        assert est.maximum(y) == 1.0 and est.minimum(y) == 0.0
        assert abs(est.mean(y) - 0.454545) < 1e-3          # getMean
        assert abs(est.median(y) - 0.4) < 1e-3             # getMedian
        assert abs(est.peak_to_peak(y) - 1.0) < 1e-9       # getRange
        assert abs(est.std(y) - 0.320124) < 1e-3           # getRms (≡ stddev)
        assert abs(est.integral(y) - 5.0) < 1e-3           # getIntegral
        assert abs(est.centre_of_mass(y) - 5.0) < 1e-3     # computeCentreOfMass
        edges = est.edge_detect(y, threshold=0.5)
        assert edges and abs(edges[0] - 3.0) <= 0.5        # getEdgeDetect ≈ 3

    def test_fwhm_table(self):
        from gnuradio4_tpu.ops import estimators as est
        data = np.array([1.0, 2.0, 3.0, 2.0, 1.0])
        # computeInterpolatedFWHM(data, 2) == 3 (baseline 0, half-height 1.5)
        assert abs(est.fwhm(data, baseline=0.0) - 3.0) < 1e-5

    def test_duty_cycle_table(self):
        from gnuradio4_tpu.ops import estimators as est
        y = np.array([0, 0, 0, 1, 1, 1], np.float64)       # 3-high/3-low
        assert abs(est.duty_cycle(y) - 0.5) < 1e-9

    def test_frequency_estimate_table(self):
        from gnuradio4_tpu.ops import estimators as est
        y = np.array([0, 1, 0, 1, 0, 1], np.float64)       # period-2 square
        assert abs(est.frequency_estimate(y, 1.0) - 0.5) < 1e-6

    def test_gauss_interpolated_location(self):
        from gnuradio4_tpu.ops import estimators as est
        # 7-sample gaussian peaked exactly at index 3 (their ds1)
        idx = np.arange(7, dtype=np.float64)
        y = np.exp(-0.5 * ((idx - 3.0) / 1.2) ** 2)
        assert abs(est.gauss_interpolated_peak(y) - 3.0) < 1e-3

    def test_decibel_helpers(self):
        # tenLog10 / decibel / inverseDecibel (qa:150-177) — jnp-side helpers
        assert abs(float(10 * np.log10(10.0)) - 10.0) < 1e-9
        from gnuradio4_tpu.ops.fft import magnitude_db
        x = jnp.asarray([10.0 + 0j, 1.0 + 0j, 0.1 + 0j])
        np.testing.assert_allclose(np.asarray(magnitude_db(x)),
                                   [20.0, 0.0, -20.0], atol=1e-3)


class TestQaSchmittTriggerGolden:
    """Mirrors qa_SchmittTrigger.cpp stimulus tables (algorithm/test/
    qa_SchmittTrigger.cpp:74-145): threshold 0.1, offset 0.5 → our
    low=0.4, high=0.6, midpoint 0.5. Expected sub-sample positions are the
    reference's own expected_edges values (tolerance 0.1 like theirs)."""

    LOW, HIGH = 0.4, 0.6

    def _edges(self, sig, method):
        from gnuradio4_tpu.ops import estimators as est
        e, _ = est.schmitt_edges(np.asarray(sig, np.float64),
                                 low=self.LOW, high=self.HIGH, method=method)
        return e

    def test_no_interpolation(self):
        sig = [0.3, 0.4, 0.45, 0.5, 0.55, 0.6, 1.0, 1.0, 0.0]
        assert self._edges(sig, "none") == [(5.0, 1), (8.0, -1)]
        sig = [0.0, 0.8, 1.2, 0.9, 0.4, -0.2, -1.1, -0.5, 0.0, 1.1, 1.1,
               1.0, 0.0, 0.0]
        assert self._edges(sig, "none") == [(1.0, 1), (4.0, -1),
                                            (9.0, 1), (12.0, -1)]
        sig = [0.0, 1.0, 0.0]                       # Dirac delta
        assert self._edges(sig, "none") == [(1.0, 1), (2.0, -1)]

    @pytest.mark.parametrize("method", ["basic_linear", "regression"])
    def test_interpolated_positions(self, method):
        # reference expects identical values for BASIC_LINEAR and
        # LINEAR_INTERPOLATION (regression) on these tables
        cases = [
            ([0.3, 0.4, 0.45, 0.5, 0.55, 0.6, 1.0, 1.0, 0.0],
             [(3.0, 1), (7.5, -1)]),                 # slow rising edge
            ([0.0, 0.8, 1.2, 0.9, 0.4, -0.2, -1.1, -0.5, 0.0, 1.1, 1.1,
              1.0, 0.0, 0.0],
             [(0.625, 1), (3.8, -1), (8.45455, 1), (11.5, -1)]),
            ([0.0, 1.0, 0.0], [(0.5, 1), (1.5, -1)]),   # Dirac delta
        ]
        for sig, want in cases:
            got = self._edges(sig, method)
            assert len(got) == len(want), (method, sig, got)
            for (gp, gk), (wp, wk) in zip(got, want):
                assert gk == wk and abs(gp - wp) <= 0.1, (method, sig, got)

    @pytest.mark.parametrize("method", ["basic_linear", "regression"])
    def test_slow_falling_edge(self, method):
        sig = [1.0, 0.9, 0.85, 0.8, 0.75, 0.7, 0.65, 0.6, 0.55, 0.5,
               0.45, 0.4, 0.35, 0.3]
        got = self._edges(sig, method)
        # initial RISING at stream start (position differs from the
        # reference's history-warm-up extrapolation of -0.5), then the
        # FALLING edge the reference pins at 9.0
        assert [k for _, k in got] == [1, -1]
        assert abs(got[1][0] - 9.0) <= 0.1, (method, got)

    def test_regression_noise_robust(self):
        # regression over the band beats two-point interpolation on a noisy
        # slow ramp (the point of LINEAR_INTERPOLATION per SchmittTrigger.hpp)
        rng = np.random.default_rng(0)
        true_pos = 50.0                              # midpoint crossing
        n = 101
        sig = 0.5 + (np.arange(n) - true_pos) * 0.01   # slope 0.01/sample
        err_basic, err_reg = [], []
        for _ in range(50):
            noisy = sig + 0.01 * rng.standard_normal(n)
            for method, acc in (("basic_linear", err_basic),
                                ("regression", err_reg)):
                e = self._edges(noisy, method)
                rising = [p for p, k in e if k == 1]
                if rising:
                    acc.append(abs(rising[0] - true_pos))
        assert np.mean(err_reg) < np.mean(err_basic), (np.mean(err_reg),
                                                       np.mean(err_basic))

    def test_streaming_matches_oneshot(self):
        from gnuradio4_tpu.ops import estimators as est
        rng = np.random.default_rng(1)
        x = np.sin(2 * np.pi * 3 * np.arange(900) / 300.0) * 0.8 + 0.5 \
            + 0.02 * rng.standard_normal(900)
        one, _ = est.schmitt_edges(x, low=self.LOW, high=self.HIGH,
                                   method="regression")
        st = None
        acc = []
        for k in range(0, 900, 128):
            e, st = est.schmitt_edges(x[k:k + 128], low=self.LOW,
                                      high=self.HIGH, state=st,
                                      method="regression")
            acc.extend((p + k, s) for p, s in e)
        assert len(acc) == len(one)
        for (ap, ak), (op_, ok) in zip(acc, one):
            assert ak == ok and abs(ap - op_) < 1e-9


class TestQaXoshiroGolden:
    """Mirrors qa_Xoshiro256pp.cpp (algorithm/test/qa_Xoshiro256pp.cpp):
    known-answer vectors for seed=0, determinism, re-seeding, and the
    uniform/triangular conversion statistics."""

    def test_known_answer_seed0(self):
        from gnuradio4_tpu.ops.noise import Xoshiro256pp
        r = Xoshiro256pp(0)
        expected = [0x53175D61490B23DF, 0x61DA6F3DC380D507,
                    0x5C0FDF91EC9A7BFC, 0x02EEBF8C3BBE5E1A,
                    0x7ECA04EBAF4A5EEA]
        assert [r() for _ in range(5)] == expected

    def test_determinism_and_reseed(self):
        from gnuradio4_tpu.ops.noise import Xoshiro256pp
        a, b = Xoshiro256pp(42), Xoshiro256pp(42)
        first = [a() for _ in range(100)]
        assert first == [b() for _ in range(100)]
        a.seed(123)
        ref = [a() for _ in range(10)]
        a.seed(123)
        assert [a() for _ in range(10)] == ref
        assert [Xoshiro256pp(1)() ] != [Xoshiro256pp(2)()]

    def test_uniform01_range_and_mean(self):
        from gnuradio4_tpu.ops.noise import Xoshiro256pp
        r = Xoshiro256pp(7)
        xs = r.array(50_000, kind="uniform01")
        assert xs.min() >= 0.0 and xs.max() < 1.0
        assert abs(xs.mean() - 0.5) < 0.005
        xf = Xoshiro256pp(7).array(10_000, kind="uniform01", dtype=np.float32)
        assert xf.min() >= 0.0 and xf.max() < 1.0

    def test_uniform_m11_and_triangular(self):
        from gnuradio4_tpu.ops.noise import Xoshiro256pp
        u = Xoshiro256pp(11).array(50_000, kind="uniformM11")
        assert u.min() >= -1.0 and u.max() < 1.0
        assert abs(u.mean()) < 0.005
        t = Xoshiro256pp(13).array(50_000, kind="triangularM11")
        assert t.min() >= -1.0 and t.max() < 1.0
        assert abs(t.mean()) < 0.005
        # Irwin-Hall(2) on [-1,1): var = 1/6 (vs 1/3 uniform)
        assert abs(t.var() - 1.0 / 6.0) < 0.01


class TestQaSystemUnbalanceGolden:
    """Mirrors qa_PowerEstimators.cpp 'SystemUnbalance' (blocks/electrical/
    test/qa_PowerEstimators.cpp:229-291): ±1% voltage / ±2% current unbalance
    → 1.0% / 2.0% by the max-deviation/mean rule, total P = Σ U·I·cosφ."""

    def test_unbalance_table(self):
        v_rms, i_rms = 230.0, 10.0
        phi = np.array([0.1, 0.2, 0.3])
        u = np.array([v_rms, v_rms * 1.01, v_rms * 0.99], np.float32)
        i = np.array([i_rms, i_rms * 1.02, i_rms * 0.98], np.float32)
        p = (u * i * np.cos(phi)).astype(np.float32)
        n = 8                                   # constant streams
        g = gr.Graph()
        su = g.emplace("SystemUnbalance")
        s_u = g.emplace("VectorSource", data=np.tile(u[:, None], (1, n)))
        s_i = g.emplace("VectorSource", data=np.tile(i[:, None], (1, n)))
        s_p = g.emplace("VectorSource", data=np.tile(p[:, None], (1, n)))
        k_u = g.emplace("VectorSink")
        k_i = g.emplace("VectorSink")
        k_p = g.emplace("VectorSink")
        g.connect(s_u["out"], su["u_rms"])
        g.connect(s_i["out"], su["i_rms"])
        g.connect(s_p["out"], su["p"])
        g.connect(su["u_unbalance"], k_u["in"])
        g.connect(su["i_unbalance"], k_i["in"])
        g.connect(su["p_total"], k_p["in"])
        gr.Scheduler(g, block_len=n).run_and_wait()
        np.testing.assert_allclose(k_u.data(), 1.0, atol=0.05)
        np.testing.assert_allclose(k_i.data(), 2.0, atol=0.05)
        np.testing.assert_allclose(k_p.data(), float(p.sum()), rtol=0.01)


class TestQaSampleRateEstimatorGolden:
    """Mirrors qa_SampleRateEstimator.cpp (algorithm/test/
    qa_SampleRateEstimator.cpp:12-90) against ops.estimators.SampleRateDll:
    reset semantics incl. ppm_initial, +30 ppm convergence to <1 ppm with zero
    jitter, bounded error under 100 us Gaussian timestamp jitter, and
    reset_phase preserving the filter state."""

    def test_reset_semantics(self):
        from gnuradio4_tpu.ops.estimators import SampleRateDll
        est = SampleRateDll()
        assert est.filter_cutoff_hz == 0.1 and est.ppm_initial == 0.0
        est.reset(2.048e6)
        assert abs(est._period_est - 1.0 / 2.048e6) < 1e-15
        assert est.estimated_rate() == 2.048e6       # uninitialised → nominal
        est2 = SampleRateDll(ppm_initial=50.0)
        est2.reset(2.048e6)
        assert abs(est2._period_est - (1.0 / 2.048e6) * (1 + 50e-6)) < 1e-18

    def test_converges_zero_jitter(self):
        from gnuradio4_tpu.ops.estimators import SampleRateDll
        nominal, true_ppm, per_xfer = 2.048e6, 30.0, 8192
        true_rate = nominal * (1 + true_ppm * 1e-6)
        dt = per_xfer / true_rate
        est = SampleRateDll(filter_cutoff_hz=1.0)
        est.reset(nominal, 1.0 / dt)
        t = 0.0
        for _ in range(5000):
            t += dt
            est.update(t, per_xfer)
        assert abs(est.estimated_ppm() - true_ppm) < 1.0, est.estimated_ppm()
        rate_err_ppm = abs(est.estimated_rate() - true_rate) / true_rate * 1e6
        assert rate_err_ppm < 1.0

    def test_converges_with_jitter(self):
        from gnuradio4_tpu.ops.estimators import SampleRateDll
        rng = np.random.default_rng(42)
        nominal, true_ppm, per_xfer = 2.048e6, -20.0, 8192
        true_rate = nominal * (1 + true_ppm * 1e-6)
        dt = per_xfer / true_rate
        est = SampleRateDll(filter_cutoff_hz=0.05)
        est.reset(nominal, 1.0 / dt)
        t = 0.0
        tail = []
        for i in range(50_000):                       # ~200 s of data
            t += dt + rng.normal(0.0, 100e-6)         # USB scheduling jitter
            est.update(t, per_xfer)
            if i >= 40_000:
                tail.append(est.estimated_ppm())
        # reference tolerance: 1000 ppm residual under this jitter (their
        # single-point read is seed-dependent; the tail mean is the fair read)
        assert abs(float(np.mean(tail)) - true_ppm) < 1000.0

    def test_reset_phase_preserves_filter_state(self):
        from gnuradio4_tpu.ops.estimators import SampleRateDll
        nominal, per_xfer = 1.024e6, 4096
        true_rate = nominal * (1 + 15e-6)
        dt = per_xfer / true_rate
        est = SampleRateDll(filter_cutoff_hz=1.0)
        est.reset(nominal, 1.0 / dt)
        t = 0.0
        for _ in range(3000):
            t += dt
            est.update(t, per_xfer)
        before = est.estimated_ppm()
        est.reset_phase()                             # retune: gap in time
        t += 5.0
        for _ in range(50):
            t += dt
            est.update(t, per_xfer)
        assert abs(est.estimated_ppm() - before) < 1.0   # no transient

    def test_simple_estimator_still_converges(self):
        # the lightweight alpha-IIR estimator keeps its (coarser) contract
        from gnuradio4_tpu.ops import estimators as est
        sre = est.SampleRateEstimator(alpha=0.5)
        for k in range(1, 10):
            r = sre.update(k * 1000, k * 1.0)
        np.testing.assert_allclose(r, 1000.0, rtol=0.01)


class TestQaNoiseGeneratorGolden:
    """≈ algorithm/test/qa_NoiseGenerator.cpp + qa_GaussianNoise.cpp: noise
    stream conventions over the bit-compatible host Xoshiro256++/Marsaglia
    engine (output = A·noise + O; complex rails; Option B power)."""

    N = 20000

    def _gen(self, kind, **kw):
        from gnuradio4_tpu.ops.noise import NoiseGenerator
        return NoiseGenerator(kind, **kw)

    @pytest.mark.parametrize("kind", ["uniform", "triangular"])
    def test_range_and_mean(self, kind):
        x = self._gen(kind, seed=42).fill(self.N)
        assert np.all(x >= -1.0) and np.all(x < 1.0)
        assert abs(x.mean()) < 0.02

    def test_gaussian_mean_and_variance(self):
        x = self._gen("gaussian", seed=42).fill(self.N)
        assert abs(x.mean()) < 0.02
        assert abs(x.var() - 1.0) < 0.05

    @pytest.mark.parametrize("kind", ["uniform", "triangular", "gaussian"])
    def test_amplitude_and_offset(self, kind):
        x = self._gen(kind, amplitude=3.0, offset=5.0, seed=7).fill(self.N)
        assert abs(x.mean() - 5.0) < 0.3   # qa_NoiseGenerator.cpp:65-78

    @pytest.mark.parametrize("kind", ["uniform", "triangular", "gaussian"])
    def test_fill_matches_repeated_sample(self, kind):
        a = self._gen(kind, amplitude=2.0, offset=1.0, seed=3)
        b = self._gen(kind, amplitude=2.0, offset=1.0, seed=3)
        filled = a.fill(64)
        singles = np.asarray([b.sample() for _ in range(64)])
        np.testing.assert_array_equal(filled, singles)

    @pytest.mark.parametrize("kind", ["uniform", "triangular", "gaussian"])
    def test_reset_restores_sequence(self, kind):
        g = self._gen(kind, seed=11)
        first = g.fill(128)
        g.reset(11)
        np.testing.assert_array_equal(first, g.fill(128))

    def test_gaussian_determinism(self):
        from gnuradio4_tpu.ops.noise import GaussianNoise, Xoshiro256pp
        g1 = GaussianNoise(Xoshiro256pp(123))
        g2 = GaussianNoise(Xoshiro256pp(123))
        for _ in range(1000):
            assert g1() == g2()

    def test_gaussian_polar_pairs_from_uniform_stream(self):
        """Each accepted polar pair reconstructs exactly from the raw
        uniformM11 stream — pins the Marsaglia rejection loop bit-for-bit."""
        from gnuradio4_tpu.ops.noise import GaussianNoise, Xoshiro256pp
        g = GaussianNoise(Xoshiro256pp(5))
        got = [g() for _ in range(40)]       # 20 polar pairs
        rng = Xoshiro256pp(5)
        exp = []
        while len(exp) < 40:
            u, v = rng.uniformM11(), rng.uniformM11()
            s = u * u + v * v
            if 0.0 < s < 1.0:
                f = np.sqrt(-2.0 * np.log(s) / s)
                exp += [u * f, v * f]
        np.testing.assert_array_equal(got, exp)

    def test_complex_uniform_independent_rails(self):
        z = self._gen("uniform", seed=9).fill_complex(self.N)
        for rail in (z.real, z.imag):
            assert np.all(rail >= -1.0) and np.all(rail < 1.0)
            assert abs(rail.mean()) < 0.02
        # independent draws: rails are uncorrelated
        assert abs(np.corrcoef(z.real, z.imag)[0, 1]) < 0.03

    def test_complex_gaussian_option_b(self):
        z = self._gen("gaussian", seed=13).fill_complex(self.N)
        assert abs(np.mean(np.abs(z) ** 2) - 1.0) < 0.05
        assert abs(z.real.var() - 0.5) < 0.05
        assert abs(z.imag.var() - 0.5) < 0.05

    def test_complex_gaussian_amplitude_power(self):
        z = self._gen("gaussian", amplitude=3.0, seed=17).fill_complex(self.N)
        assert abs(np.mean(np.abs(z) ** 2) - 9.0) < 0.5

    def test_complex_offset_real_rail_only(self):
        z = self._gen("gaussian", offset=5.0, seed=19).fill_complex(4000)
        assert abs(z.real.mean() - 5.0) < 0.1
        assert abs(z.imag.mean()) < 0.1

    def test_fill_complex_matches_repeated_complex_sample(self):
        for kind in ("uniform", "triangular", "gaussian"):
            a = self._gen(kind, seed=23)
            b = self._gen(kind, seed=23)
            filled = a.fill_complex(64)
            singles = np.asarray([b.complex_sample() for _ in range(64)])
            np.testing.assert_array_equal(filled, singles)


class TestQaSignalGeneratorNoiseTypes:
    """≈ SignalGenerator.hpp:18 noise signal types (UniformNoise,
    TriangularNoise, GaussianNoise) through the block path; device threefry
    with the reference's A/O conventions."""

    def _run(self, **settings):
        g = gr.Graph()
        src = g.emplace("SignalGenerator", n_samples=32768, **settings)
        snk = g.emplace("VectorSink")
        g.connect(src, snk)
        gr.Scheduler(g, block_len=8192, sample_rate=48000.0).run_and_wait()
        return snk.data()[:32768]

    def test_uniform_range_mean(self):
        x = self._run(signal="UniformNoise", amplitude=2.0, offset=1.0)
        assert np.all(x >= -1.0) and np.all(x <= 3.0)
        assert abs(x.mean() - 1.0) < 0.05

    def test_triangular_stats(self):
        x = self._run(signal="TriangularNoise", amplitude=3.0)
        assert np.all(np.abs(x) <= 3.0)
        # Irwin-Hall(2) on [-1,1): var = 1/6 → A²/6
        assert abs(x.var() - 9.0 / 6.0) < 0.1

    def test_gaussian_stats(self):
        x = self._run(signal="GaussianNoise", amplitude=2.0, offset=-1.0)
        assert abs(x.mean() + 1.0) < 0.05
        assert abs(x.var() - 4.0) < 0.15

    def test_seed_determinism_and_divergence(self):
        a = self._run(signal="GaussianNoise", seed=5)
        b = self._run(signal="GaussianNoise", seed=5)
        c = self._run(signal="GaussianNoise", seed=6)
        np.testing.assert_array_equal(a, b)
        assert not np.array_equal(a, c)

    def test_fast_sin_cos_alias_exact(self):
        a = self._run(signal="Sin", frequency=1000.0)
        b = self._run(signal="FastSin", frequency=1000.0)
        np.testing.assert_array_equal(a, b)

    def test_noise_sp_island_exact(self):
        """Noise SignalGenerator under an sp mesh: the replicated-island
        lowering keeps sharded == unsharded bitwise."""
        import jax
        from jax.sharding import Mesh
        devs = jax.devices()
        if len(devs) < 8:
            pytest.skip("needs 8 devices")
        mesh = Mesh(np.asarray(devs[:8]), ("sp",))

        def run(m):
            g = gr.Graph()
            src = g.emplace("SignalGenerator", signal="GaussianNoise",
                            seed=3, n_samples=16384)
            fir = g.emplace("FirFilter",
                            taps=tuple((np.ones(16) / 16).tolist()))
            snk = g.emplace("VectorSink")
            g.connect_chain(src, fir, snk)
            gr.Scheduler(g, block_len=8192, sample_rate=48e3,
                         mesh=m).run_and_wait()
            return snk.data()[:16384]

        np.testing.assert_array_equal(run(None), run(mesh))
