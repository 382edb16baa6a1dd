"""Shipped example flowgraphs load, validate, and run."""

import glob
from pathlib import Path

import numpy as np
import pytest

import gnuradio4_tpu as gr
from gnuradio4_tpu.core.yaml_io import load_grc

EXAMPLES = sorted(glob.glob("/root/repo/examples/*.yaml"))


@pytest.mark.parametrize("path", EXAMPLES, ids=[Path(p).stem for p in EXAMPLES])
def test_example_loads_and_compiles(path):
    g = load_grc(Path(path).read_text())
    meta = getattr(g, "yaml_meta", {})
    compiled = gr.compile_graph(g, block_len=meta.get("block_len", 4096),
                                sample_rate=meta.get("sample_rate", 1.0),
                                jit=False)
    assert compiled.order


def test_spectrum_analyzer_runs(tmp_path):
    src = Path("/root/repo/examples/spectrum_analyzer.yaml").read_text()
    src = src.replace("refresh_every: 4", "refresh_every: 2, stream: none")
    from gnuradio4_tpu.core.yaml_io import run_grc
    sched = run_grc(src, n_steps=4)
    mon = [b for b in sched.graph.blocks if b.name == "scope"][0]
    assert mon._renders >= 1


def test_fm_receiver_example_runs(tmp_path):
    src = Path("/root/repo/examples/fm_receiver.yaml").read_text()
    src = src.replace("/tmp/fm_audio.wav", str(tmp_path / "audio.wav"))
    from gnuradio4_tpu.core.yaml_io import run_grc
    sched = run_grc(src, n_steps=4)
    wav = [b for b in sched.graph.blocks if b.name == "wav"][0]
    wav.stop()
    assert (tmp_path / "audio.wav").exists()
    assert wav.n_written == 4 * 24000 // 5


def test_channelizer_example_with_poller():
    from gnuradio4_tpu.core.datasink import global_data_sink_registry
    src = Path("/root/repo/examples/channelizer.yaml").read_text()
    g = load_grc(src)
    p = global_data_sink_registry.get_streaming_poller("channel5_power")
    sched = gr.Scheduler(g, block_len=65536, sample_rate=16e6)
    sched.run_and_wait(n_steps=3)
    chunks = p.read_all()
    assert chunks
    data = np.concatenate([c.data for c in chunks], axis=-1)
    # tone at 5 MHz = channel 5 of 16 @ 16 MHz → strong dB level
    assert np.median(data[2000:]) > -10.0


class TestCliDashboard:
    """`python -m gnuradio4_tpu run --draw` (live Drawable dashboard)."""

    YAML = """
name: dash
sample_rate: 48000.0
block_len: 8192
blocks:
  - name: src
    id: SignalGenerator
    parameters: {frequency: 440.0, n_samples: 262144}
  - name: mon
    id: ImChartMonitor
    parameters: {window: 256}
connections:
  - [src, out, mon, in]
"""

    def test_draw_renders_final_frame(self, tmp_path):
        import subprocess, sys
        f = tmp_path / "dash.yaml"
        f.write_text(self.YAML)
        r = subprocess.run(
            [sys.executable, "-m", "gnuradio4_tpu", "run", str(f), "--cpu",
             "--draw", "--draw-interval", "0.1"],
            capture_output=True, text=True, timeout=180)
        assert r.returncode == 0, r.stderr[-500:]
        assert "mon" in r.stdout          # chart header for the monitor block
        assert "[STOPPED] step" in r.stdout

    def test_draw_without_drawables_falls_back(self, tmp_path):
        import subprocess, sys
        yaml = self.YAML.replace("ImChartMonitor", "NullSink").replace(
            "    parameters: {window: 256}\n", "")
        f = tmp_path / "plain.yaml"
        f.write_text(yaml)
        r = subprocess.run(
            [sys.executable, "-m", "gnuradio4_tpu", "run", str(f), "--cpu",
             "--draw"],
            capture_output=True, text=True, timeout=180)
        assert r.returncode == 0, r.stderr[-500:]
        assert "no drawable blocks" in r.stderr


def test_tour_runs_end_to_end(tmp_path):
    import subprocess, sys
    r = subprocess.run([sys.executable, "examples/tour.py", "--cpu"],
                       capture_output=True, text=True, timeout=600,
                       cwd=str(Path(__file__).resolve().parent.parent))
    assert r.returncode == 0, r.stderr[-800:]
    assert "tour complete" in r.stdout
    assert "post-lock angular error 0.00 deg" in r.stdout


def test_agc_loop_example_converges():
    src = Path("/root/repo/examples/agc_loop.yaml").read_text()
    from gnuradio4_tpu.core.yaml_io import run_grc
    sched = run_grc(src)
    cap = [b for b in sched.graph.blocks if b.name == "audio"][0]
    y = cap.data()
    assert y.shape == (16384,)
    # loop drives |y| toward the reference level 1.0
    assert 0.7 < float(np.mean(np.abs(y[-4096:]))) < 1.3


def test_ais_receiver_example_decodes_vessels():
    src = Path("/root/repo/examples/ais_receiver.yaml").read_text()
    from gnuradio4_tpu.core.yaml_io import run_grc
    sched = run_grc(src)
    tracker = [b for b in sched.graph.blocks if b.name == "tracker"][0]
    assert set(tracker.vessels) == {477553000, 211234560}
    assert tracker.vessels[477553000]["nav_status"] == 5


def test_rtty_teletype_example_prints_text():
    src = Path("/root/repo/examples/rtty_teletype.yaml").read_text()
    from gnuradio4_tpu.core.yaml_io import run_grc
    sched = run_grc(src)
    printer = [b for b in sched.graph.blocks if b.name == "printer"][0]
    assert printer.text == "CQ CQ CQ DE GR4GPU GR4GPU K"


def test_lora_link_example_decodes_frame():
    src = Path("/root/repo/examples/lora_link.yaml").read_text()
    from gnuradio4_tpu.core.yaml_io import run_grc
    sched = run_grc(src)
    rx = [b for b in sched.graph.blocks if b.name == "rx"][0]
    assert rx.frames == [b"LoRa over GPU"]


def test_coded_link_example_zero_ber():
    src = Path("/root/repo/examples/coded_link.yaml").read_text()
    from gnuradio4_tpu.core.yaml_io import run_grc
    import numpy as np
    sched = run_grc(src)
    blocks = {b.name: b for b in sched.graph.blocks}
    tx = np.asarray(blocks["tx_bits"].data())
    rx = np.asarray(blocks["rx_bits"].data())
    n = min(len(tx), len(rx))
    assert n >= 8000
    assert np.mean(tx[:n] != rx[:n]) == 0.0


def test_wifi_link_example_decodes_frame():
    src = Path("/root/repo/examples/wifi_link.yaml").read_text()
    from gnuradio4_tpu.core.yaml_io import run_grc
    sched = run_grc(src)
    rx = [b for b in sched.graph.blocks if b.name == "rx"][0]
    assert len(rx.frames) == 1, rx.frames
    assert rx.frames[0]["rate_mbps"] == 24 and rx.frames[0]["fcs_ok"]
    assert rx.frames[0]["psdu"][:-4] == b"Hello from the 802.11a OFDM PHY"


def test_ble_scanner_example_finds_devices():
    src = Path("/root/repo/examples/ble_scanner.yaml").read_text()
    from gnuradio4_tpu.core.yaml_io import run_grc
    sched = run_grc(src)
    scan = [b for b in sched.graph.blocks if b.name == "scan"][0]
    assert set(scan.devices) == {"BC:9A:78:56:34:12", "05:04:03:02:01:00"}
    assert scan.devices["BC:9A:78:56:34:12"]["name"] == "GR4-GPU"
