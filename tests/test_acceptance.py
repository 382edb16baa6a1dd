"""Full-system acceptance test (≈ reference qa_SoapyLoopback: complete RF chain
over a fake radio): an FM station 'on the air' via LoopbackDevice → SdrSource →
WbfmReceiver → WAV file + DataSink poller, tags flowing end-to-end."""

import wave

import numpy as np

import gnuradio4_tpu as gr
from gnuradio4_tpu.blocks.fileio import WavSink
from gnuradio4_tpu.blocks.sdr import LoopbackDevice, SdrSource, make_wbfm_receiver
from gnuradio4_tpu.core.datasink import DataSink, global_data_sink_registry
from gnuradio4_tpu.core.tags import Keys


def test_fm_station_to_audio_file(tmp_path):
    fs = 250e3
    fc = 100.0e6           # tuner frequency
    station = 100.02e6     # station 20 kHz above → freq-xlating picks it
    f_tone = 2000.0
    max_dev = 75e3
    n = 250000             # 1 second on air

    # build the station's baseband FM waveform
    t = np.arange(n) / fs
    message = np.sin(2 * np.pi * f_tone * t)
    phase = 2 * np.pi * np.cumsum(max_dev * message) / fs
    tx = np.exp(1j * phase)

    dev = LoopbackDevice(waveform=tx, waveform_freq=station,
                         noise_std=0.001, total_samples=n)

    g = gr.Graph()
    src = SdrSource(device=dev, sample_rate=fs, center_frequency=fc)
    rx = make_wbfm_receiver(quad_rate=fs, audio_decim=5,
                            center_freq=station - fc, max_dev=max_dev)
    wav_path = tmp_path / "air.wav"
    wav = WavSink(path=str(wav_path), sample_rate=fs / 5)
    ds = DataSink(name="acceptance_audio")
    g.add(rx)
    g.connect(src, rx["in"])
    g.connect(rx["out"], wav)
    g.connect(rx["out"], ds)
    poller = global_data_sink_registry.get_streaming_poller("acceptance_audio")

    gr.Scheduler(g, block_len=25000, sample_rate=fs).run_and_wait()
    wav.stop()

    # 1. WAV exists with the right length/rate and carries the message tone
    with wave.open(str(wav_path), "rb") as w:
        assert w.getframerate() == int(fs / 5)
        frames = w.getnframes()
        assert frames == n // 5
        pcm = np.frombuffer(w.readframes(frames), "<i2").astype(np.float32)
    audio = pcm / 32768.0
    seg = audio[5000:45000]
    spec = np.abs(np.fft.rfft((seg - seg.mean()) * np.hanning(len(seg))))
    f_peak = np.argmax(spec) * (fs / 5) / len(seg)
    assert abs(f_peak - f_tone) < 5.0

    # 2. poller saw the same stream
    chunks = poller.read_all()
    streamed = np.concatenate([c.data for c in chunks], axis=-1)
    assert streamed.shape == (n // 5,)
    np.testing.assert_allclose(streamed, audio, atol=2.0 / 32768)

    # 3. radio metadata tags reached the sinks — the sample_rate value was
    # rescaled through the decimating chain to the audio rate
    all_tags = [t for c in chunks for t in c.tags]
    assert any(t.map.get(Keys.SAMPLE_RATE) == fs / 5 for t in all_tags)
    assert any(t.map.get(Keys.FREQUENCY) == fc for t in all_tags)


def test_full_fm_broadcast_stereo_plus_rds():
    """Capstone: one FM carrier carrying a COMPLETE broadcast multiplex —
    stereo program (L+R, 19 kHz pilot, 38 kHz DSB L−R) plus 57 kHz RDS —
    demodulated by one flowgraph that splits the MPX into the stereo decoder
    and the RDS chain. Asserts >40 dB stereo separation and a full RDS
    PI/PS decode simultaneously."""
    from gnuradio4_tpu.blocks import rds
    from gnuradio4_tpu.ops.filter_design import design_fir

    fs_if, dev = 456000.0, 75000.0
    groups = rds.make_0a_groups(0x52A1, 9, "GR4-GPU!") * 4
    rds_wave = rds.modulate_mpx(groups, fs=fs_if)
    n = len(rds_wave)
    t = np.arange(n) / fs_if
    L = np.sin(2 * np.pi * 800.0 * t)
    R = np.sin(2 * np.pi * 1400.0 * t)
    th = 2 * np.pi * 19000.0 * t
    mpx = (0.20 * (L + R) + 0.1 * np.sin(th)
           + 0.20 * (L - R) * np.sin(2 * th) + 0.08 * rds_wave)
    phase = 2 * np.pi * np.cumsum(dev * mpx) / fs_if
    tx = np.exp(1j * phase).astype(np.complex64)

    g = gr.Graph()
    src = g.emplace("VectorSource", data=tx)
    qd = g.emplace("QuadratureDemod", gain=fs_if / (2 * np.pi * dev))
    lp = g.emplace("FirFilter", decim=2, taps=tuple(design_fir(
        "lowpass", 121, sample_rate=fs_if, f_low=80000.0).tolist()))
    st = g.emplace("FmStereoDecoder", sample_rate_in=228000.0)
    kl, kr = g.emplace("VectorSink"), g.emplace("VectorSink")
    cvt = g.emplace("Convert", to="complex64")
    xlat = g.emplace("FreqXlatingFir", center_freq=57000.0, decim=24,
                     f_cut=2400.0, ntaps=241)
    costas = g.emplace("CostasLoop", order=2, loop_bw=0.01)
    mm = g.emplace("MMSymbolSync", sps=4, gain=0.05)
    dec = g.emplace("RdsDecoder")
    g.connect_chain(src, qd, lp)
    g.connect(lp["out"], st["in"])
    g.connect(st["left"], kl["in"])
    g.connect(st["right"], kr["in"])
    g.connect(lp["out"], cvt["in"])
    g.connect_chain(cvt, xlat, costas, mm, dec)
    gr.Scheduler(g, block_len=48000, sample_rate=fs_if).run_and_wait()

    yl, yr = np.asarray(kl.data()), np.asarray(kr.data())

    def tone(y, f0):
        seg = y[65536:65536 + 131072] * np.hanning(131072)
        spec = np.abs(np.fft.rfft(seg))
        f = np.fft.rfftfreq(131072, 1 / 228000.0)
        return spec[np.argmin(np.abs(f - f0))]

    sep_l = 20 * np.log10(tone(yl, 800) / (tone(yl, 1400) + 1e-12))
    sep_r = 20 * np.log10(tone(yr, 1400) / (tone(yr, 800) + 1e-12))
    assert sep_l > 40 and sep_r > 40, (sep_l, sep_r)
    assert dec.pi == 0x52A1 and dec.ps == "GR4-GPU!"
    assert len(dec.groups) >= 12
