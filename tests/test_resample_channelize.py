"""BASELINE configs 2 & 4 kernels: rational polyphase resampler and PFB channelizer,
validated against NumPy references / known-signal behavior."""

import numpy as np
import jax.numpy as jnp
import pytest

import gnuradio4_tpu as gr
from gnuradio4_tpu.blocks.basic import ComplexToneSource, NoiseSource
from gnuradio4_tpu.blocks.channelizer import (ChannelSelect, PFBChannelizer,
                                              PFBSynthesizer)
from gnuradio4_tpu.blocks.filter import RationalResampler
from gnuradio4_tpu.blocks.testing import VectorSink, VectorSource
from gnuradio4_tpu.ops.channelizer import (design_pfb_taps, pfb_analyze,
                                           pfb_init_state, pfb_synthesize)
from gnuradio4_tpu.ops.resample import RationalResamplerKernel


class TestRationalResampler:
    def test_upsample_matches_zero_stuff_reference(self, rng):
        k = RationalResamplerKernel(3, 1, ntaps_per_phase=12)
        x = rng.standard_normal(300).astype(np.float32)
        up = np.zeros(len(x) * 3)
        up[::3] = x
        ref = np.convolve(up, k.taps)[: len(up)] * 3
        y, _ = k.apply(jnp.asarray(x), k.init_state(0, jnp.float32))
        np.testing.assert_allclose(np.asarray(y), ref, atol=1e-4)

    def test_rational_2_3_preserves_tone(self, rng):
        """48k → 32k: a 1 kHz tone must survive with the right frequency."""
        fs_in, fs_out = 48000.0, 32000.0
        n = 4800
        t = np.arange(n) / fs_in
        x = np.sin(2 * np.pi * 1000.0 * t).astype(np.float32)
        g = gr.Graph()
        src = VectorSource(x)
        rs = RationalResampler(interp=2, decim=3)
        snk = VectorSink()
        g.connect_chain(src, rs, snk)
        gr.Scheduler(g, block_len=1200, sample_rate=fs_in).run_and_wait()
        y = snk.data()
        assert len(y) == n * 2 // 3
        # measure output tone frequency via FFT peak
        spec = np.abs(np.fft.rfft(y[200:200 + 2048] * np.hanning(2048)))
        f_peak = np.argmax(spec) * fs_out / 2048
        assert abs(f_peak - 1000.0) < fs_out / 2048 * 1.5
        # amplitude preserved within 5%
        assert abs(np.max(np.abs(y[500:])) - 1.0) < 0.05

    def test_streaming_continuity(self, rng):
        """Chunked processing must equal one-shot processing exactly."""
        k = RationalResamplerKernel(5, 2, ntaps_per_phase=8)
        x = rng.standard_normal(1000).astype(np.float32)
        y1, _ = k.apply(jnp.asarray(x), k.init_state(0, jnp.float32))
        state = k.init_state(0, jnp.float32)
        parts = []
        for chunk in x.reshape(5, 200):
            y, state = k.apply(jnp.asarray(chunk), state)
            parts.append(np.asarray(y))
        np.testing.assert_allclose(np.concatenate(parts), np.asarray(y1),
                                   rtol=1e-5, atol=1e-5)

    def test_ratio_in_graph_algebra(self):
        g = gr.Graph()
        src = NoiseSource(n_samples=6000)
        rs = RationalResampler(interp=2, decim=3)
        snk = VectorSink()
        g.connect_chain(src, rs, snk)
        gr.Scheduler(g, block_len=600).run_and_wait()
        assert len(snk.data()) == 4000


class TestPFBChannelizer:
    def test_tone_lands_in_its_channel(self):
        m = 8
        fs = 8000.0
        # tone at channel-3 center: 3·fs/M = 3000 Hz
        n = 4096
        t = np.arange(n) / fs
        x = np.exp(2j * np.pi * 3000.0 * t).astype(np.complex64)
        taps = design_pfb_taps(m, 8)
        y, _ = pfb_analyze(jnp.asarray(x), jnp.asarray(taps), pfb_init_state(m, 8))
        y = np.asarray(y)
        assert y.shape == (m, n // m)
        power = np.mean(np.abs(y[:, 32:]) ** 2, axis=-1)
        assert np.argmax(power) == 3
        # adjacent-channel rejection ≥ 40 dB
        rej = 10 * np.log10(power[3] / (np.max(np.delete(power, 3)) + 1e-20))
        assert rej > 40.0

    def test_channel_is_baseband_tone(self):
        """Offset from channel center appears as baseband tone at that offset."""
        m = 4
        fs = 4000.0
        offset = 100.0
        n = 8192
        t = np.arange(n) / fs
        x = np.exp(2j * np.pi * (1000.0 + offset) * t).astype(np.complex64)
        taps = design_pfb_taps(m, 8)
        y, _ = pfb_analyze(jnp.asarray(x), jnp.asarray(taps), pfb_init_state(m, 8))
        ch1 = np.asarray(y)[1, 64:]
        spec = np.abs(np.fft.fft(ch1 * np.hanning(len(ch1))))
        f_meas = np.fft.fftfreq(len(ch1), m / fs)[np.argmax(spec)]
        assert abs(f_meas - offset) < (fs / m) / len(ch1) * 2

    def test_streaming_continuity(self, rng):
        m = 4
        taps = design_pfb_taps(m, 6)
        x = (rng.standard_normal(1024) + 1j * rng.standard_normal(1024)
             ).astype(np.complex64)
        y1, _ = pfb_analyze(jnp.asarray(x), jnp.asarray(taps), pfb_init_state(m, 6))
        state = pfb_init_state(m, 6)
        parts = []
        for chunk in x.reshape(4, 256):
            y, state = pfb_analyze(jnp.asarray(chunk), jnp.asarray(taps), state)
            parts.append(np.asarray(y))
        np.testing.assert_allclose(np.concatenate(parts, axis=-1), np.asarray(y1),
                                   rtol=1e-4, atol=1e-4)

    def test_analysis_synthesis_roundtrip(self, rng):
        """Perfect-ish reconstruction through analysis → synthesis."""
        m = 8
        taps = design_pfb_taps(m, 12)
        n = 8192
        t = np.arange(n)
        x = np.exp(2j * np.pi * 0.13 * t).astype(np.complex64)  # in-band tone
        ch, _ = pfb_analyze(jnp.asarray(x), jnp.asarray(taps), pfb_init_state(m, 12))
        y, _ = pfb_synthesize(ch, jnp.asarray(taps), pfb_init_state(m, 12))
        y = np.asarray(y)
        # compare steady-state magnitude (group delay shifts the signal)
        assert abs(np.mean(np.abs(y[2000:6000])) - 1.0) < 0.1

    def test_channelizer_block_in_graph(self):
        m = 8
        fs = 80000.0
        g = gr.Graph()
        src = ComplexToneSource(frequency=2 * fs / m, n_samples=8192)  # channel 2
        chan = PFBChannelizer(n_channels=m)
        sel = ChannelSelect(channel=2)
        snk = VectorSink()
        g.connect_chain(src, chan, sel, snk)
        gr.Scheduler(g, block_len=2048, sample_rate=fs).run_and_wait()
        y = snk.data()
        assert y.shape == (8192 // m,)
        assert np.mean(np.abs(y[64:])) > 0.9  # tone captured ≈ unit amplitude
