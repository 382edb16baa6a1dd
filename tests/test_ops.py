"""Golden-value DSP kernel tests vs NumPy/SciPy references with explicit tolerances
(≈ reference qa_fourier, qa_FilterTool, qa_filter — SURVEY §4 strategy)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from gnuradio4_tpu.ops import filter_design as fd
from gnuradio4_tpu.ops.fir import fir_apply, fir_init_state, fir_interpolate
from gnuradio4_tpu.ops.iir import (biquad_parallel_apply, iir_apply, iir_init_state,
                                   one_pole_apply, sos_apply, sos_init_state)
from gnuradio4_tpu.ops.windows import enbw, make_window
from gnuradio4_tpu.ops.fft import chunked_fft, freq_axis


def _np_lfilter(b, a, x):
    """Direct-form reference IIR/FIR in float64 (scipy-free)."""
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    b = b / a[0]; a = a / a[0]
    y = np.zeros_like(np.asarray(x, np.float64))
    for n in range(len(x)):
        acc = 0.0
        for k in range(len(b)):
            if n - k >= 0:
                acc += b[k] * x[n - k]
        for k in range(1, len(a)):
            if n - k >= 0:
                acc -= a[k] * y[n - k]
        y[n] = acc
    return y


class TestFir:
    def test_matches_numpy_convolve_streaming(self, rng):
        taps = rng.standard_normal(33).astype(np.float32)
        x = rng.standard_normal(1024).astype(np.float32)
        ref = np.convolve(x, taps)[: len(x)]
        state = fir_init_state(0, len(taps), jnp.float32)
        # stream in 4 chunks — state carries the overlap
        ys = []
        for chunk in x.reshape(4, -1):
            y, state = fir_apply(jnp.asarray(chunk), jnp.asarray(taps), state)
            ys.append(np.asarray(y))
        out = np.concatenate(ys)
        np.testing.assert_allclose(out, ref, rtol=0, atol=2e-4)

    def test_complex_fir(self, rng):
        taps = (rng.standard_normal(17) + 1j * rng.standard_normal(17)).astype(np.complex64)
        x = (rng.standard_normal(256) + 1j * rng.standard_normal(256)).astype(np.complex64)
        ref = np.convolve(x, taps)[: len(x)]
        state = fir_init_state(0, len(taps), jnp.complex64)
        y, _ = fir_apply(jnp.asarray(x), jnp.asarray(taps), state)
        np.testing.assert_allclose(np.asarray(y), ref, rtol=0, atol=5e-4)

    def test_multichannel(self, rng):
        taps = rng.standard_normal(9).astype(np.float32)
        x = rng.standard_normal((4, 128)).astype(np.float32)
        state = fir_init_state(4, len(taps), jnp.float32)
        y, _ = fir_apply(jnp.asarray(x), jnp.asarray(taps), state)
        for c in range(4):
            ref = np.convolve(x[c], taps)[:128]
            np.testing.assert_allclose(np.asarray(y)[c], ref, rtol=0, atol=2e-4)

    def test_decimating_fir(self, rng):
        taps = rng.standard_normal(16).astype(np.float32)
        x = rng.standard_normal(512).astype(np.float32)
        ref = np.convolve(x, taps)[: len(x)][::4]
        state = fir_init_state(0, len(taps), jnp.float32)
        y, _ = fir_apply(jnp.asarray(x), jnp.asarray(taps), state, decim=4)
        np.testing.assert_allclose(np.asarray(y), ref, rtol=0, atol=2e-4)

    def test_interpolating_fir_polyphase(self, rng):
        interp = 4
        taps = fd.design_fir("lowpass", 64, sample_rate=interp * 2.0, f_low=0.5 * 0.8)
        x = rng.standard_normal(256).astype(np.float32)
        # reference: zero-stuff then filter
        up = np.zeros(len(x) * interp, np.float64)
        up[::interp] = x
        ref = np.convolve(up, taps)[: len(up)] * interp
        state = fir_init_state(0, (len(taps) + interp - 1) // interp, jnp.float32)
        y, _ = fir_interpolate(jnp.asarray(x), jnp.asarray(taps, dtype=jnp.float32),
                               state, interp)
        np.testing.assert_allclose(np.asarray(y), ref, rtol=0, atol=5e-4)


class TestIir:
    def test_matches_reference_lfilter(self, rng):
        res = fd.design_iir("butterworth", "lowpass", 4, sample_rate=100.0, f_low=10.0)
        x = rng.standard_normal(256).astype(np.float32)
        ref = _np_lfilter(res.b, res.a, x)
        state = iir_init_state(0, len(res.b), len(res.a))
        y, _ = iir_apply(jnp.asarray(x), res.b, res.a, state)
        np.testing.assert_allclose(np.asarray(y), ref, rtol=0, atol=1e-4)

    def test_streaming_state_continuity(self, rng):
        res = fd.design_iir("butterworth", "lowpass", 2, sample_rate=10.0, f_low=1.0)
        x = rng.standard_normal(400).astype(np.float32)
        ref = _np_lfilter(res.b, res.a, x)
        state = iir_init_state(0, len(res.b), len(res.a))
        ys = []
        for chunk in x.reshape(4, -1):
            y, state = iir_apply(jnp.asarray(chunk), res.b, res.a, state)
            ys.append(np.asarray(y))
        np.testing.assert_allclose(np.concatenate(ys), ref, rtol=0, atol=1e-4)

    def test_sos_cascade(self, rng):
        res = fd.design_iir("butterworth", "lowpass", 4, sample_rate=100.0, f_low=10.0)
        x = rng.standard_normal(256).astype(np.float32)
        ref = _np_lfilter(res.b, res.a, x)
        state = sos_init_state(0, res.sos.shape[0])
        y, _ = sos_apply(jnp.asarray(x), res.sos, state)
        np.testing.assert_allclose(np.asarray(y), ref, rtol=0, atol=1e-3)

    def test_sos_unnormalized_a0(self, rng):
        """SOS rows with a0 != 1 must normalize b and a consistently."""
        res = fd.design_iir("butterworth", "lowpass", 4, sample_rate=100.0,
                            f_low=10.0)
        x = rng.standard_normal(256).astype(np.float32)
        ref = _np_lfilter(res.b, res.a, x)
        sos_scaled = res.sos * 3.0  # same transfer function, a0 = 3
        state = sos_init_state(0, sos_scaled.shape[0])
        y, _ = sos_apply(jnp.asarray(x), sos_scaled, state)
        np.testing.assert_allclose(np.asarray(y), ref, rtol=0, atol=1e-3)

    def test_one_pole_parallel_scan(self):
        pole = 0.95
        x = np.ones(128, np.float32)
        y, last = one_pole_apply(jnp.asarray(x), pole, jnp.asarray(0.0))
        ref = _np_lfilter([1.0], [1.0, -pole], x)
        np.testing.assert_allclose(np.asarray(y), ref, rtol=1e-5, atol=1e-5)
        assert np.isclose(np.asarray(last), ref[-1], rtol=1e-5)

    def test_biquad_parallel_matches_sequential(self, rng):
        res = fd.design_iir("butterworth", "lowpass", 2, sample_rate=50.0, f_low=5.0)
        x = rng.standard_normal(512).astype(np.float32)
        ref = _np_lfilter(res.b, res.a, x)
        y, _ = biquad_parallel_apply(jnp.asarray(x), res.sos[0],
                                     jnp.zeros((), jnp.complex64))
        np.testing.assert_allclose(np.asarray(y), ref, rtol=0, atol=1e-3)


class TestFilterDesign:
    def test_fir_lowpass_response(self):
        fs, fc = 1000.0, 100.0
        taps = fd.design_fir("lowpass", 127, sample_rate=fs, f_low=fc)
        f, h = fd.freq_response(taps, sample_rate=fs, n=1024)
        mag = np.abs(h)
        assert np.allclose(mag[f < 0.5 * fc], 1.0, atol=0.01)     # passband flat
        assert np.all(mag[f > 2.0 * fc] < 10 ** (-40 / 20))       # ≥40 dB stop

    def test_fir_highpass_response(self):
        fs, fc = 1000.0, 200.0
        taps = fd.design_fir("highpass", 129, sample_rate=fs, f_low=fc)
        f, h = fd.freq_response(taps, sample_rate=fs, n=1024)
        mag = np.abs(h)
        assert np.all(mag[f < 0.5 * fc] < 0.02)
        assert np.allclose(mag[f > 1.8 * fc], 1.0, atol=0.02)

    def test_fir_bandpass_response(self):
        fs = 1000.0
        taps = fd.design_fir("bandpass", 201, sample_rate=fs, f_low=100.0, f_high=200.0)
        f, h = fd.freq_response(taps, sample_rate=fs, n=2048)
        mag = np.abs(h)
        inband = (f > 130) & (f < 170)
        assert np.allclose(mag[inband], 1.0, atol=0.02)
        assert np.all(mag[(f < 60) | (f > 280)] < 0.01)

    @pytest.mark.parametrize("design", ["butterworth", "chebyshev1", "chebyshev2",
                                        "bessel"])
    def test_iir_lowpass_response(self, design):
        fs, fc = 1000.0, 100.0
        res = fd.design_iir(design, "lowpass", 4, sample_rate=fs, f_low=fc,
                            ripple_db=1.0, atten_db=40.0)
        f, h = fd.freq_response(res.b, res.a, sample_rate=fs, n=2048)
        mag = np.abs(h)
        # DC gain ≈ 1 (Chebyshev1 even order: -ripple)
        dc_min = 10 ** (-1.2 / 20) if design == "chebyshev1" else 0.97
        assert dc_min <= mag[1] <= 1.03
        if design == "chebyshev2":
            assert np.all(mag[f > 2.0 * fc] < 10 ** (-39 / 20))
        else:
            assert np.all(mag[f > 4.0 * fc] < 0.12)
        # stability: poles inside unit circle
        assert np.all(np.abs(res.zpk.p) < 1.0)

    def test_iir_cutoff_at_3db_butterworth(self):
        fs, fc = 1000.0, 100.0
        res = fd.design_iir("butterworth", "lowpass", 5, sample_rate=fs, f_low=fc)
        f, h = fd.freq_response(res.b, res.a, sample_rate=fs, n=4096)
        i = np.argmin(np.abs(f - fc))
        np.testing.assert_allclose(np.abs(h[i]), 1 / np.sqrt(2), atol=0.02)

    def test_iir_bandpass(self):
        fs = 1000.0
        res = fd.design_iir("butterworth", "bandpass", 2, sample_rate=fs,
                            f_low=100.0, f_high=200.0)
        f, h = fd.freq_response(res.b, res.a, sample_rate=fs, n=4096)
        mag = np.abs(h)
        i_mid = np.argmin(np.abs(f - 141.0))  # sqrt(100·200)
        assert mag[i_mid] > 0.95
        assert np.all(mag[f < 30] < 0.1) and np.all(mag[f > 450] < 0.1)
        assert np.all(np.abs(res.zpk.p) < 1.0)

    def test_sos_equals_ba(self):
        res = fd.design_iir("butterworth", "lowpass", 6, sample_rate=48e3, f_low=4e3)
        f, h_ba = fd.freq_response(res.b, res.a, sample_rate=48e3, n=512)
        _, h_sos = fd.sos_freq_response(res.sos, sample_rate=48e3, n=512)
        np.testing.assert_allclose(np.abs(h_sos), np.abs(h_ba), rtol=1e-5, atol=1e-7)


class TestWindows:
    def test_known_enbw(self):
        # textbook ENBW values (bins): Hann 1.5, Hamming 1.363, Blackman ~1.727
        assert abs(enbw(make_window("Hann", 4096)) - 1.5) < 0.01
        assert abs(enbw(make_window("Hamming", 4096)) - 1.363) < 0.01
        assert abs(enbw(make_window("Blackman", 4096)) - 1.727) < 0.01

    def test_symmetry(self):
        for kind in ("Hann", "Hamming", "Blackman", "Nuttall", "FlatTop", "Kaiser"):
            w = make_window(kind, 101)
            np.testing.assert_allclose(w, w[::-1], atol=1e-6)

    def test_unknown_raises(self):
        with pytest.raises(ValueError):
            make_window("nope", 16)


class TestFft:
    def test_matches_numpy(self, rng):
        x = rng.standard_normal(4 * 256).astype(np.float32)
        spec = np.asarray(chunked_fft(jnp.asarray(x), 256))
        ref = np.fft.fft(x.reshape(4, 256), axis=-1)
        np.testing.assert_allclose(spec, ref, rtol=1e-4, atol=1e-3)

    def test_windowed_tone_peak(self):
        fs, n = 1024.0, 1024
        f0 = 128.0  # exactly bin 128
        t = np.arange(n) / fs
        x = np.sin(2 * np.pi * f0 * t).astype(np.float32)
        w = jnp.asarray(make_window("Hann", n))
        spec = np.asarray(chunked_fft(jnp.asarray(x), n, window=w))[0]
        peak_bin = np.argmax(np.abs(spec[: n // 2]))
        assert peak_bin == 128
        f = freq_axis(n, fs)
        assert f[peak_bin] == f0


class TestParallelIir:
    def test_sos_parallel_matches_scan(self, rng):
        res = fd.design_iir("butterworth", "lowpass", 6, sample_rate=100.0,
                            f_low=10.0)
        from gnuradio4_tpu.ops.iir import (sos_parallel_apply,
                                           sos_parallel_init_state,
                                           sos_supports_parallel)
        assert sos_supports_parallel(res.sos)
        x = rng.standard_normal((4, 512)).astype(np.float32)
        y_ref, _ = sos_apply(jnp.asarray(x), res.sos, sos_init_state(4, 3))
        y, _ = sos_parallel_apply(jnp.asarray(x), res.sos,
                                  sos_parallel_init_state(4, 3))
        np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref),
                                   rtol=1e-3, atol=1e-4)

    def test_sos_parallel_streaming(self, rng):
        res = fd.design_iir("chebyshev1", "lowpass", 4, sample_rate=50.0,
                            f_low=5.0)
        from gnuradio4_tpu.ops.iir import (sos_parallel_apply,
                                           sos_parallel_init_state)
        x = rng.standard_normal(1024).astype(np.float32)
        y1, _ = sos_parallel_apply(jnp.asarray(x), res.sos,
                                   sos_parallel_init_state(0, 2))
        st = sos_parallel_init_state(0, 2)
        parts = []
        for chunk in x.reshape(4, 256):
            y, st = sos_parallel_apply(jnp.asarray(chunk), res.sos, st)
            parts.append(np.asarray(y))
        np.testing.assert_allclose(np.concatenate(parts), np.asarray(y1),
                                   rtol=1e-4, atol=1e-4)

    def test_one_pole_ba_matches_lfilter(self, rng):
        from gnuradio4_tpu.ops.demod import fm_deemphasis_coeffs
        from gnuradio4_tpu.ops.iir import one_pole_ba_apply
        b, a = fm_deemphasis_coeffs(50000.0, 75e-6)
        x = rng.standard_normal(500).astype(np.float32)
        ref = _np_lfilter(b, a, x)
        y, _ = one_pole_ba_apply(jnp.asarray(x), b, a, jnp.asarray(0.0))
        np.testing.assert_allclose(np.asarray(y), ref, rtol=1e-4, atol=1e-4)

    def test_ba_to_sos_response_matches(self):
        res = fd.design_iir("butterworth", "bandpass", 3, sample_rate=1000.0,
                            f_low=100.0, f_high=200.0)
        sos2 = fd.ba_to_sos(res.b, res.a)
        f, h1 = fd.freq_response(res.b, res.a, sample_rate=1000.0, n=256)
        _, h2 = fd.sos_freq_response(sos2, sample_rate=1000.0, n=256)
        np.testing.assert_allclose(np.abs(h2), np.abs(h1), rtol=1e-4, atol=1e-6)


class TestDataSetEstimatorTail:
    """Estimators matching reference DataSetEstimators.hpp semantics
    (median/integral/centre-of-mass/duty-cycle/frequency/zero-crossing/
    Gauss peak/settling)."""

    def test_median_even_odd(self):
        from gnuradio4_tpu.ops import estimators as est
        assert est.median([3.0, 1.0, 2.0]) == 2.0
        assert est.median([4.0, 1.0, 3.0, 2.0]) == 2.5

    def test_integral_trapezoid(self):
        from gnuradio4_tpu.ops import estimators as est
        x = np.linspace(0, 1, 101)
        y = x ** 2
        assert abs(est.integral(y, x) - 1 / 3) < 1e-3
        assert est.integral([1.0, 1.0, 1.0]) == 2.0  # unit index axis

    def test_centre_of_mass(self):
        from gnuradio4_tpu.ops import estimators as est
        y = np.zeros(11)
        y[7] = 2.0
        assert est.centre_of_mass(y) == 7.0
        assert np.isnan(est.centre_of_mass(np.zeros(5)))

    def test_duty_cycle_square(self):
        from gnuradio4_tpu.ops import estimators as est
        y = np.tile(np.r_[np.ones(30), np.zeros(10)], 16)
        assert abs(est.duty_cycle(y) - 0.75) < 0.01

    def test_frequency_estimate_square_and_sine(self):
        from gnuradio4_tpu.ops import estimators as est
        fs = 1000.0
        t = np.arange(4000) / fs
        sq = (np.sin(2 * np.pi * 50.0 * t) > 0).astype(float)
        assert abs(est.frequency_estimate(sq, fs) - 50.0) < 1.0
        sine = np.sin(2 * np.pi * 25.0 * t)
        assert abs(est.frequency_estimate(sine, fs) - 25.0) < 1.0

    def test_gauss_interpolated_peak_exact_for_gaussian(self):
        from gnuradio4_tpu.ops import estimators as est
        idx = np.arange(64, dtype=float)
        true_pos = 31.37
        y = np.exp(-0.5 * ((idx - true_pos) / 2.5) ** 2)
        assert abs(est.gauss_interpolated_peak(y) - true_pos) < 1e-6
        # with a physical axis
        xs = idx * 0.5 + 10.0
        assert abs(est.gauss_interpolated_peak(y, xs)
                   - (10.0 + true_pos * 0.5)) < 1e-5

    def test_zero_crossing_interpolated(self):
        from gnuradio4_tpu.ops import estimators as est
        y = np.array([0.0, 0.2, 0.4, 0.6, 0.8, 1.0])
        assert abs(est.zero_crossing(y, 0.5) - 2.5) < 1e-9
        y_fall = y[::-1].copy()
        assert abs(est.zero_crossing(y_fall, 0.5) - 2.5) < 1e-9
        assert np.isnan(est.zero_crossing(np.zeros(4), 0.5))

    def test_settling_time_with_excursion(self):
        from gnuradio4_tpu.ops import estimators as est
        y = np.ones(20)
        y[:5] = 0.5        # settles at 5
        assert est.settling_time(y) == 5
        y2 = y.copy()
        y2[12] = 1.5       # later excursion moves the settling index
        assert est.settling_time(y2) == 12


class TestJacobiSvd:
    """One-sided Jacobi SVD (ops/svd.py jacobi_svd) — the reference's own SVD
    algorithm family (core SVD.hpp:1-10) rebuilt with static control flow."""

    def test_reconstruction_and_singular_values(self):
        from gnuradio4_tpu.ops.svd import jacobi_svd
        rng = np.random.default_rng(7)
        for m, n in [(16, 8), (40, 17), (64, 64), (128, 33)]:
            a = jnp.asarray(rng.standard_normal((m, n)), jnp.float32)
            u, s, vt = jacobi_svd(a)
            rec = jnp.einsum('ij,jk->ik', u * s[None, :], vt,
                             precision=jax.lax.Precision.HIGHEST)
            np.testing.assert_allclose(np.asarray(rec), np.asarray(a),
                                       atol=2e-4)
            ref = np.linalg.svd(np.asarray(a), compute_uv=False)
            np.testing.assert_allclose(np.asarray(s), ref, atol=2e-3)
            # descending order + orthogonality
            assert np.all(np.diff(np.asarray(s)) <= 1e-5)
            eye = np.asarray(vt @ vt.T)
            np.testing.assert_allclose(eye, np.eye(n), atol=5e-5)
            uu = np.asarray(u.T @ u)
            np.testing.assert_allclose(uu, np.eye(n), atol=5e-5)

    def test_batched(self):
        from gnuradio4_tpu.ops.svd import jacobi_svd
        rng = np.random.default_rng(8)
        a = jnp.asarray(rng.standard_normal((3, 20, 10)), jnp.float32)
        u, s, vt = jacobi_svd(a)
        rec = jnp.einsum('bmn,bn,bnk->bmk', u, s, vt)
        np.testing.assert_allclose(np.asarray(rec), np.asarray(a), atol=1e-4)

    def test_jit_and_input_errors(self):
        import jax
        from gnuradio4_tpu.ops.svd import jacobi_svd
        rng = np.random.default_rng(9)
        a = jnp.asarray(rng.standard_normal((12, 6)), jnp.float32)
        u, s, vt = jax.jit(jacobi_svd)(a)
        rec = (u * s[None, :]) @ vt
        np.testing.assert_allclose(np.asarray(rec), np.asarray(a), atol=1e-4)
        with pytest.raises(ValueError):
            jacobi_svd(jnp.zeros((4, 8), jnp.float32))      # m < n

    def test_complex(self):
        from gnuradio4_tpu.ops.svd import jacobi_svd
        rng = np.random.default_rng(11)
        for m, n in [(24, 12), (33, 15)]:
            a = jnp.asarray((rng.standard_normal((m, n))
                         + 1j * rng.standard_normal((m, n))
                         ).astype(np.complex64))
            u, s, vt = jacobi_svd(a)
            rec = (u * s[None, :].astype(a.dtype)) @ vt
            np.testing.assert_allclose(np.asarray(rec), np.asarray(a),
                                       atol=5e-4)
            ref = np.linalg.svd(np.asarray(a), compute_uv=False)
            np.testing.assert_allclose(np.asarray(s), ref, atol=5e-3)
            eye = np.asarray(vt @ jnp.conj(vt).T)
            np.testing.assert_allclose(eye, np.eye(n), atol=1e-4)

    def test_equal_norm_columns_rotate(self):
        # α == β exactly ⇒ zeta == 0; sign(0)=0 would freeze the pair
        from gnuradio4_tpu.ops.svd import jacobi_svd
        a = jnp.asarray([[1.0, 1.0], [1.0, -1.0], [1.0, 1.0], [1.0, 1.0]],
                        jnp.float32) * jnp.asarray([[2.0, 2.0]], jnp.float32)
        u, s, vt = jacobi_svd(a)
        rec = (u * s[None, :]) @ vt
        np.testing.assert_allclose(np.asarray(rec), np.asarray(a), atol=1e-5)
        ref = np.linalg.svd(np.asarray(a), compute_uv=False)
        np.testing.assert_allclose(np.asarray(s), ref, atol=1e-5)

    def test_denoise_engines_agree(self):
        from gnuradio4_tpu.ops.svd import svd_denoise
        rng = np.random.default_rng(10)
        t = np.linspace(0.0, 1.0, 400)
        clean = np.sin(2 * np.pi * 8 * t).astype(np.float32)
        noisy = clean + 0.3 * rng.standard_normal(400).astype(np.float32)
        xla = np.asarray(svd_denoise(jnp.asarray(noisy), window=32, rank=2))
        jac = np.asarray(svd_denoise(jnp.asarray(noisy), window=32, rank=2,
                                     method="jacobi"))
        np.testing.assert_allclose(jac, xla, atol=1e-3)
        assert np.std(jac - clean) < 0.4 * np.std(noisy - clean)


class TestJacobiWideMatrices:
    def test_m_less_than_n_via_transpose(self):
        from gnuradio4_tpu.ops.svd import svd
        rng = np.random.default_rng(12)
        for shape, dtype in [((6, 14), jnp.float32), ((5, 9), jnp.complex64)]:
            a = rng.standard_normal(shape)
            if dtype == jnp.complex64:
                a = a + 1j * rng.standard_normal(shape)
            a = jnp.asarray(np.asarray(a).astype(dtype))
            u, s, vt = svd(a, method="jacobi")
            rec = (u * s[None, :].astype(a.dtype)) @ vt
            np.testing.assert_allclose(np.asarray(rec), np.asarray(a),
                                       atol=1e-3)

    def test_denoiser_wide_window_any_engine(self):
        # window > (chunk+1)/2 must work on both engines (configs must not
        # be engine-dependent crashes)
        from gnuradio4_tpu.ops.svd import svd_denoise
        x = jnp.asarray(np.random.default_rng(1).standard_normal(64),
                        jnp.float32)
        for eng in ("xla", "jacobi"):
            y = svd_denoise(x, window=48, rank=2, method=eng)
            assert y.shape == x.shape


class TestMatmulFFT:
    """Four-step matmul FFT (ops/fft.matmul_fft): two dense matmul stages +
    twiddle must match the FFT HLO — on the CPU 'high' >= 90 dB and
    'highest' at f32 class (>120 dB), 'bf16' at monitoring grade (>45 dB).
    On a GPU 'high' is TF32 (tests/test_gpu.py). Ref: reference algorithm/fourier/fft.hpp:91
    (its radix engine); ours targets the matrix units instead of SIMD lanes."""

    def _snr(self, y, ref):
        err = np.abs(np.asarray(y).astype(np.complex128) - ref)
        return 10 * np.log10(np.mean(np.abs(ref) ** 2) / np.mean(err ** 2))

    @pytest.mark.parametrize("n,n1", [(4096, 64), (4096, 128), (1024, 32),
                                      (256, 16)])
    def test_high_matches_hlo(self, rng, n, n1):
        from gnuradio4_tpu.ops.fft import matmul_fft
        x = (rng.standard_normal((8, n)) + 1j * rng.standard_normal((8, n))
             ).astype(np.complex64)
        ref = np.fft.fft(x.astype(np.complex128), axis=-1)
        # on the CPU the 'high' rung holds 90 dB; 'highest' carries the
        # f32-exact (>120 dB) contract on every backend
        assert self._snr(matmul_fft(jnp.asarray(x), n, n1=n1, mode="high"),
                         ref) > 90.0
        assert self._snr(matmul_fft(jnp.asarray(x), n, n1=n1, mode="highest"),
                         ref) > 120.0

    def test_bf16_monitoring_grade(self, rng):
        from gnuradio4_tpu.ops.fft import matmul_fft
        x = (rng.standard_normal((8, 4096)) + 1j
             * rng.standard_normal((8, 4096))).astype(np.complex64)
        ref = np.fft.fft(x.astype(np.complex128), axis=-1)
        assert self._snr(matmul_fft(jnp.asarray(x), 4096, mode="bf16"),
                         ref) > 45.0

    def test_real_input(self, rng):
        from gnuradio4_tpu.ops.fft import matmul_fft
        x = rng.standard_normal((4, 1024)).astype(np.float32)
        ref = np.fft.fft(x.astype(np.float64), axis=-1)
        assert self._snr(matmul_fft(jnp.asarray(x), 1024, mode="high"),
                         ref) > 90.0
        assert self._snr(matmul_fft(jnp.asarray(x), 1024, mode="highest"),
                         ref) > 120.0

    def test_fft_block_engine_setting(self, rng):
        """FFT(engine='matmul') through the Scheduler == engine='xla'."""
        import gnuradio4_tpu as gr
        x = (rng.standard_normal(8192) + 1j * rng.standard_normal(8192)
             ).astype(np.complex64)
        outs = {}
        for eng in ("xla", "matmul", "matmul_exact"):
            g = gr.Graph()
            src = g.emplace("VectorSource")
            src.data = x
            fft = g.emplace("FFT", fft_size=1024, window="Hann",
                            output="magnitude", engine=eng)
            snk = g.emplace("VectorSink")
            g.connect_chain(src, fft, snk)
            gr.Scheduler(g, block_len=4096, sample_rate=1e6).run_and_wait()
            outs[eng] = np.asarray(snk.data())
        np.testing.assert_allclose(outs["matmul"], outs["xla"],
                                   atol=1e-5, rtol=1e-4)

    def test_matmul_engine_size_cap_falls_back_to_hlo(self, rng):
        """engine='matmul' above 65536 must NOT build the dense four-step
        factor matrices (~n-entry complex128 host arrays in an lru_cache —
        memory hazard, round-4 advisor) — the block falls back to the FFT
        HLO and the cache stays untouched."""
        from gnuradio4_tpu.ops.fft import _fft_mats
        import gnuradio4_tpu as gr
        n = 1 << 17
        _fft_mats.cache_clear()
        x = (rng.standard_normal(2 * n) + 1j * rng.standard_normal(2 * n)
             ).astype(np.complex64)
        for name, kw in (("FFT", dict(window="none", output="complex",
                                      calibrate=False)),
                         ("IFFT", {})):
            g = gr.Graph()
            src = g.emplace("VectorSource")
            src.data = x
            blk = g.emplace(name, fft_size=n, engine="matmul", **kw)
            snk = g.emplace("VectorSink")
            g.connect_chain(src, blk, snk)
            gr.Scheduler(g, block_len=n, sample_rate=1e6).run_and_wait()
            got = np.asarray(snk.data())
            ref = (np.fft.fft if name == "FFT" else np.fft.ifft)(
                x.reshape(-1, n).astype(np.complex128), axis=-1).reshape(-1)
            assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 1e-4
        assert _fft_mats.cache_info().currsize == 0


class TestBlockedOnePole:
    """Blocked two-level linear recurrence (ops/iir._one_pole_blocked): the
    host-constant-pole fast path (Toeplitz matmul + carry scan + correction)
    must match the sequential recurrence to f32 class, including the carry
    across calls and the chunking-invariance the streaming contract needs."""

    def _seq(self, x, pole, y_prev):
        ref = np.empty(len(x), np.complex128)
        acc = complex(y_prev)
        for i, v in enumerate(x):
            acc = pole * acc + complex(v)
            ref[i] = acc
        return ref

    @pytest.mark.parametrize("pole", [0.88, -0.6, 0.9999])
    def test_matches_sequential(self, rng, pole):
        from gnuradio4_tpu.ops.iir import one_pole_apply
        x = rng.standard_normal(8192).astype(np.float32)
        ref = self._seq(x, pole, 0.7).real
        y, last = one_pole_apply(jnp.asarray(x), pole, jnp.float32(0.7))
        rel = np.max(np.abs(np.asarray(y) - ref)) / np.max(np.abs(ref))
        assert rel < 2e-5, rel

    def test_complex_pole_and_chunk_invariance(self, rng):
        from gnuradio4_tpu.ops.iir import one_pole_apply
        p = 0.92 * np.exp(1j * 0.3)
        x = rng.standard_normal(16384).astype(np.float32)
        ref = self._seq(x, p, 0.1 + 0.2j)
        # one shot (blocked path)
        y1, _ = one_pole_apply(jnp.asarray(x).astype(jnp.complex64), p,
                               jnp.asarray(np.complex64(0.1 + 0.2j)))
        # four chunks of 4096 (blocked path each, carry chained)
        parts, carry = [], jnp.asarray(np.complex64(0.1 + 0.2j))
        for c in np.split(x, 4):
            yc, carry = one_pole_apply(jnp.asarray(c).astype(jnp.complex64),
                                       p, carry)
            parts.append(np.asarray(yc))
        for got in (np.asarray(y1), np.concatenate(parts)):
            rel = np.max(np.abs(got - ref)) / np.max(np.abs(ref))
            assert rel < 3e-5, rel

    def test_short_and_unaligned_fall_back(self, rng):
        from gnuradio4_tpu.ops.iir import one_pole_apply
        for t in (100, 4100):   # < threshold / not a multiple of 128
            x = rng.standard_normal(t).astype(np.float32)
            ref = self._seq(x, 0.8, 0.0).real
            y, _ = one_pole_apply(jnp.asarray(x), 0.8, jnp.float32(0.0))
            assert np.max(np.abs(np.asarray(y) - ref)) < 1e-3


class TestRealPoleParallelBiquad:
    """Round-4: distinct REAL poles take the partial-fraction path too (two
    blocked real one-pole rails; carries packed as re/im of the section's
    complex state slot — state pytree unchanged vs the conjugate-pair case)."""

    @pytest.mark.parametrize("p1,p2", [(0.9, 0.4), (-0.5, 0.8), (0.99, 0.95)])
    def test_matches_scan(self, rng, p1, p2):
        from gnuradio4_tpu.ops.iir import (biquad_parallel_apply, sos_apply,
                                           sos_init_state,
                                           sos_supports_parallel)
        row = np.array([0.7, -0.3, 0.2, 1.0, -(p1 + p2), p1 * p2])
        assert sos_supports_parallel(row[None])
        x = rng.standard_normal(8192).astype(np.float32)
        y_ref, _ = sos_apply(jnp.asarray(x), row[None], sos_init_state(0, 1))
        y, _ = biquad_parallel_apply(jnp.asarray(x), row,
                                     jnp.zeros((), np.complex64))
        rel = np.max(np.abs(np.asarray(y) - np.asarray(y_ref))) \
            / np.max(np.abs(np.asarray(y_ref)))
        assert rel < 2e-4, rel

    def test_repeated_pole_declines(self):
        from gnuradio4_tpu.ops.iir import sos_supports_parallel
        p = 0.8           # repeated real pole: a1=-2p, a2=p^2 -> disc == 0
        row = np.array([1.0, 0.0, 0.0, 1.0, -2 * p, p * p])
        assert not sos_supports_parallel(row[None])

    @pytest.mark.parametrize("sep", [2e-5, 1e-4])
    def test_near_repeated_real_poles_decline(self, sep):
        """Round-4 advisor (medium): A1,A2 ∝ 1/(p1−p2) cancel catastrophically
        in f32 for clustered real poles (~68 dB SNR loss at sep 2e-5) — the
        relative-separation guard must route them to the sequential scan."""
        from gnuradio4_tpu.ops.iir import (biquad_parallel_apply,
                                           sos_supports_parallel)
        p1, p2 = 0.9, 0.9 - sep
        row = np.array([0.7, -0.3, 0.2, 1.0, -(p1 + p2), p1 * p2])
        assert not sos_supports_parallel(row[None])
        with pytest.raises(ValueError, match="well-separated"):
            biquad_parallel_apply(jnp.zeros(64), row,
                                  jnp.zeros((), np.complex64))

    def test_near_repeated_complex_poles_decline(self):
        """The conjugate branch has the same A ∝ 1/(p−p̄) cancellation."""
        from gnuradio4_tpu.ops.iir import sos_supports_parallel
        p = complex(0.9, 1e-5)          # |Im p| tiny → p−p̄ ≈ 0
        row = np.array([1.0, 0.3, 0.1, 1.0, -2 * p.real, abs(p) ** 2])
        assert not sos_supports_parallel(row[None])

    def test_separated_poles_still_accepted(self):
        """The guard is RELATIVE: ordinary designs (e.g. cheby2 sections,
        round-4 fast-path rows) must keep the parallel path."""
        from gnuradio4_tpu.ops.iir import sos_supports_parallel
        for p1, p2 in [(0.9, 0.4), (0.99, 0.95)]:
            row = np.array([0.7, -0.3, 0.2, 1.0, -(p1 + p2), p1 * p2])
            assert sos_supports_parallel(row[None]), (p1, p2)

    def test_first_order_section_raises_descriptive(self):
        """a2 == 0 must raise the descriptive ValueError, not hit a bare
        ZeroDivisionError in the partial-fraction algebra (round-4 advisor)."""
        from gnuradio4_tpu.ops.iir import biquad_parallel_apply
        row = np.array([1.0, 0.5, 0.0, 1.0, -0.9, 0.0])
        with pytest.raises(ValueError, match="second-order"):
            biquad_parallel_apply(jnp.zeros(64), row,
                                  jnp.zeros((), np.complex64))


def test_ifft_matmul_engine(rng):
    """IFFT(engine='matmul') == IFFT HLO (conjugate four-step)."""
    import gnuradio4_tpu as gr
    x = (rng.standard_normal(4096) + 1j * rng.standard_normal(4096)
         ).astype(np.complex64)
    outs = {}
    for eng in ("xla", "matmul", "matmul_exact"):
        g = gr.Graph()
        src = g.emplace("VectorSource")
        src.data = x
        ifft = g.emplace("IFFT", fft_size=1024, engine=eng)
        snk = g.emplace("VectorSink")
        g.connect_chain(src, ifft, snk)
        gr.Scheduler(g, block_len=2048, sample_rate=1e6).run_and_wait()
        outs[eng] = np.asarray(snk.data())
    np.testing.assert_allclose(outs["matmul"], outs["xla"], atol=1e-5)
    # the f32-exact rung
    np.testing.assert_allclose(outs["matmul_exact"], outs["xla"], atol=2e-6)
