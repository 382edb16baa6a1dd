"""Rotation-absorption pass: absorbed vs non-absorbed outputs must agree."""
import numpy as np, pytest
import jax.numpy as jnp


def _build_and_run(monkeypatch, absorb: bool, output="magnitude"):
    import gnuradio4_tpu as gr
    from gnuradio4_tpu.blocks.filter import FreqXlatingFir
    if not absorb:
        monkeypatch.setenv("GR4_NO_ROTATION_ABSORB", "1")
    fs, fc = 1e6, 123e3
    from gnuradio4_tpu.ops import filter_design as fd
    taps = fd.design_fir("lowpass", 63, sample_rate=fs, f_low=100e3
                         ).astype(np.float32)
    g = gr.Graph()
    src = g.emplace("NoiseSource", noise="complex_gaussian", n_samples=16384)
    fir = g.add(FreqXlatingFir(taps=taps, center_freq=fc, sample_rate_in=fs))
    fft = g.emplace("FFT", fft_size=1024, window="Hann", output=output)
    dem = g.emplace("QuadratureDemod", gain=2.5)
    s1, s2 = g.emplace("VectorSink"), g.emplace("VectorSink")
    g.connect_chain(src, fir, fft, s1)
    g.connect(fir, dem)
    g.connect(dem, s2)
    gr.Scheduler(g, block_len=4096, sample_rate=fs).run_and_wait()
    return (np.asarray(s1.data()), np.asarray(s2.data()),
            getattr(fir, "_rotation_absorbed", False))


def test_absorbed_matches_derotated(monkeypatch, rng):
    spec_a, dem_a, flag_a = _build_and_run(monkeypatch, absorb=True)
    spec_b, dem_b, flag_b = _build_and_run(monkeypatch, absorb=False)
    assert flag_a and not flag_b
    np.testing.assert_allclose(spec_a, spec_b, atol=2e-3)
    # demod transient: first sample uses the x[-1]=1 seed; skip it
    np.testing.assert_allclose(dem_a[1:], dem_b[1:], atol=2e-3)


def test_complex_output_blocks_absorption(monkeypatch):
    spec_a, _, flag = _build_and_run(monkeypatch, absorb=True,
                                     output="complex")
    assert not flag     # complex FFT view cannot absorb -> pass declined


def test_absorbed_sharded_matches_unsharded(rng):
    """sp-sharded absorbed lowering == unsharded absorbed run: the residual
    phase is linear in the GLOBAL index, so per-shard frames/demod must line
    up through the ppermute halo."""
    import jax
    from jax.sharding import Mesh
    import gnuradio4_tpu as gr
    from gnuradio4_tpu.blocks.filter import FreqXlatingFir
    from gnuradio4_tpu.blocks.testing import VectorSink, VectorSource
    from gnuradio4_tpu.ops import filter_design as fd
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 devices")
    mesh = Mesh(np.array(devs[:8]), ("sp",))
    fs, fc = 1e6, 123e3
    taps = fd.design_fir("lowpass", 63, sample_rate=fs, f_low=100e3
                         ).astype(np.float32)
    iq = (rng.standard_normal(16384) + 1j * rng.standard_normal(16384)
          ).astype(np.complex64)

    def run(mesh_arg):
        g = gr.Graph()
        src = g.add(VectorSource(data=iq))
        fir = g.add(FreqXlatingFir(taps=taps, center_freq=fc,
                                   sample_rate_in=fs))
        fft = g.emplace("FFT", fft_size=1024, window="Hann",
                        output="magnitude")
        dem = g.emplace("QuadratureDemod", gain=1.0)
        s1, s2 = g.emplace("VectorSink"), g.emplace("VectorSink")
        g.connect_chain(src, fir, fft, s1)
        g.connect(fir, dem)
        g.connect(dem, s2)
        gr.Scheduler(g, block_len=8192, sample_rate=fs,
                     mesh=mesh_arg).run_and_wait()
        assert getattr(fir, "_rotation_absorbed", False)
        return np.asarray(s1.data()), np.asarray(s2.data())

    spec_u, dem_u = run(None)
    spec_s, dem_s = run(mesh)
    np.testing.assert_allclose(spec_s, spec_u, atol=2e-3)
    np.testing.assert_allclose(dem_s, dem_u, atol=2e-3)


def test_mixed_consumers_decline(monkeypatch, rng):
    """One absorbing consumer (FFT-mag) + one that cannot (VectorSink on the
    raw stream): the pass must decline and keep the de-rotation, so the sink
    sees the true translated stream."""
    import gnuradio4_tpu as gr
    from gnuradio4_tpu.blocks.filter import FreqXlatingFir
    from gnuradio4_tpu.ops import filter_design as fd
    fs, fc = 1e6, 123e3
    taps = fd.design_fir("lowpass", 63, sample_rate=fs, f_low=100e3
                         ).astype(np.float32)
    x = (rng.standard_normal(8192) + 1j * rng.standard_normal(8192)
         ).astype(np.complex64)
    g = gr.Graph()
    src = g.emplace("VectorSource")
    src.data = x
    fir = g.add(FreqXlatingFir(taps=taps, center_freq=fc, sample_rate_in=fs))
    fft = g.emplace("FFT", fft_size=1024, window="Hann", output="magnitude")
    s1, s2 = g.emplace("VectorSink"), g.emplace("VectorSink")
    g.connect_chain(src, fir, fft, s1)
    g.connect(fir, s2)     # raw-stream consumer: cannot absorb
    gr.Scheduler(g, block_len=4096, sample_rate=fs).run_and_wait()
    assert not getattr(fir, "_rotation_absorbed", False)
    # and the sink's stream is the truly translated/filtered one
    n = np.arange(len(x), dtype=np.float64)
    xr = x.astype(np.complex128) * np.exp(-2j * np.pi * fc / fs * n)
    ref = np.convolve(xr, taps.astype(np.float64))[: len(x)]
    got = np.asarray(s2.data())
    np.testing.assert_allclose(got, ref[: len(got)], atol=2e-3)
