"""Compiler epilogue fusion: GR4_FUSE_EPILOGUE=1 skips the
per-edge optimization_barrier on single-reader edges whose consumer declares
EPILOGUE_FUSABLE (QuadratureDemod) — XLA may fuse the producer into the
elementwise consumer so the intermediate never round-trips HBM. Must be
bit-class identical and must NOT drop barriers on multi-reader edges."""

import numpy as np
import pytest

import gnuradio4_tpu as gr


@pytest.fixture
def iq():
    rng = np.random.default_rng(3)
    return (rng.standard_normal(1 << 14)
            + 1j * rng.standard_normal(1 << 14)).astype(np.complex64), rng


def _wbfm(iq_data, taps):
    g = gr.Graph()
    src = g.emplace("VectorSource")
    src.data = iq_data
    fir = g.emplace("FirFilter", taps=taps)
    dem = g.emplace("QuadratureDemod", gain=1.5)
    snk = g.emplace("VectorSink")
    g.connect_chain(src, fir, dem, snk)
    gr.Scheduler(g, block_len=4096).run_and_wait()
    return np.asarray(snk.data())


def test_fused_matches_unfused(iq, monkeypatch):
    data, rng = iq
    taps = tuple((rng.standard_normal(31) / 8).tolist())
    ref = _wbfm(data, taps)
    monkeypatch.setenv("GR4_FUSE_EPILOGUE", "1")
    out = _wbfm(data, taps)
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_multi_reader_edge_keeps_barrier(iq, monkeypatch):
    """FIR feeding BOTH an FFT and a demod (the headline chain shape): the
    fusion must decline (2 consumers) — outputs stay identical and the
    compiled program still works."""
    data, rng = iq
    taps = tuple((rng.standard_normal(31) / 8).tolist())

    def run():
        g = gr.Graph()
        src = g.emplace("VectorSource")
        src.data = data
        fir = g.emplace("FirFilter", taps=taps)
        fft = g.emplace("FFT", fft_size=1024, window="none",
                        output="magnitude", calibrate=False)
        dem = g.emplace("QuadratureDemod", gain=1.0)
        s1 = g.emplace("VectorSink")
        s2 = g.emplace("VectorSink")
        g.connect_chain(src, fir, fft, s1)
        g.connect(fir, dem)
        g.connect(dem, s2)
        gr.Scheduler(g, block_len=4096).run_and_wait()
        return np.asarray(s1.data()), np.asarray(s2.data())

    a1, a2 = run()
    monkeypatch.setenv("GR4_FUSE_EPILOGUE", "1")
    b1, b2 = run()
    np.testing.assert_allclose(b1, a1, atol=1e-5)
    np.testing.assert_allclose(b2, a2, atol=1e-6)
