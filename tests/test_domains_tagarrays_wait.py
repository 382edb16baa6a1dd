"""Round-2 wiring: ComputeDomain consumption, device-visible TagArrays path
(TriggerGate), futex blocking waits, thread-pool registration."""

import threading
import time

import numpy as np
import pytest

import gnuradio4_tpu as gr
from gnuradio4_tpu.core.feeder import read_exact
from gnuradio4_tpu.core.tags import Keys, Tag
from gnuradio4_tpu.native.ring import HostRing


class TestComputeDomainConsumed:
    def test_host_domain_forces_host_delivery(self):
        g = gr.Graph()
        src = g.emplace("SignalGenerator", frequency=10.0, n_samples=512)
        mul = g.emplace("MultiplyConst", value=2.0)
        probe = gr.global_registry.create("VectorSink")
        out = gr.global_registry.create("VectorSink")
        g.connect(src, mul)
        g.connect(mul, probe, domain="host")
        g.connect(mul, out)
        gr.Scheduler(g, block_len=256, sample_rate=100.0).run_and_wait()
        assert probe.data().shape == (512,)
        np.testing.assert_allclose(probe.data(), out.data())

    def test_host_domain_requires_consume_hook(self):
        g = gr.Graph()
        src = g.emplace("ConstantSource", n_samples=64)
        mul = g.emplace("MultiplyConst", value=2.0)
        snk = gr.global_registry.create("NullSink")
        g.connect(src, mul, domain="host")  # MultiplyConst has no consume()
        g.connect(mul, snk)
        with pytest.raises(gr.GrError, match="consume"):
            gr.Scheduler(g, block_len=64).run_and_wait()

    def test_unsupported_domain_rejected(self):
        g = gr.Graph()
        a = g.emplace("ConstantSource", n_samples=16)
        b = gr.global_registry.create("VectorSink")
        g.connect(a, b, domain="fpga")
        with pytest.raises(gr.GrError, match="fpga"):
            gr.Scheduler(g, block_len=16).run_and_wait()

    def test_gpu_domain_runs_in_the_fused_program(self):
        g = gr.Graph()
        a = g.emplace("ConstantSource", value=3.0, n_samples=64)
        b = gr.global_registry.create("VectorSink")
        g.connect(a, b, domain="gpu:xla:0")
        gr.Scheduler(g, block_len=16).run_and_wait()
        np.testing.assert_array_equal(b.data(), np.full(64, 3.0, np.float32))


class TestTriggerGateDeviceTagPath:
    def test_windows_gate_on_device(self):
        tags = [Tag(100, {Keys.TRIGGER_NAME: "T"}),
                Tag(500, {Keys.TRIGGER_NAME: "T"}),
                Tag(1000, {Keys.TRIGGER_NAME: "X"})]  # filtered out
        g = gr.Graph()
        src = g.emplace("TagSource", value=1.0, n_samples=2048, tags=tags)
        gate = g.emplace("TriggerGate", filter="T", n_pre=10, n_post=50)
        snk = gr.global_registry.create("VectorSink")
        g.connect_chain(src, gate, snk)
        gr.Scheduler(g, block_len=256, pipeline_depth=1).run_and_wait()
        expect = np.zeros(2048, np.float32)
        for i in (100, 500):
            expect[i - 10:i + 50] = 1.0
        np.testing.assert_array_equal(snk.data(), expect)

    def test_window_carries_across_step_boundary(self):
        g = gr.Graph()
        src = g.emplace("TagSource", value=1.0, n_samples=1024,
                        tags=[Tag(250, {Keys.TRIGGER_NAME: "T"})])
        gate = g.emplace("TriggerGate", filter="T", n_post=100)
        snk = gr.global_registry.create("VectorSink")
        g.connect_chain(src, gate, snk)
        gr.Scheduler(g, block_len=256, pipeline_depth=1).run_and_wait()
        expect = np.zeros(1024, np.float32)
        expect[250:350] = 1.0
        np.testing.assert_array_equal(snk.data(), expect)

    def test_capacity_from_scheduler(self):
        # more tags than max_tags_per_step: the first `capacity` gate; the
        # overflow tags are dropped from the device view (host sideband keeps
        # them — fixed-capacity arrays are the static-shape contract)
        tags = [Tag(i * 100, {Keys.TRIGGER_NAME: "T"}) for i in range(8)]
        g = gr.Graph()
        src = g.emplace("TagSource", value=1.0, n_samples=1024, tags=tags)
        gate = g.emplace("TriggerGate", filter="T", n_post=10)
        snk = gr.global_registry.create("VectorSink")
        g.connect_chain(src, gate, snk)
        gr.Scheduler(g, block_len=1024, pipeline_depth=1,
                     max_tags_per_step=4).run_and_wait()
        y = snk.data()
        assert y[:10].all() and y[300:310].all()
        assert not y[400:410].any()  # tag 5..8 beyond capacity 4


class TestBlockingWait:
    def test_futex_wait_woken_by_producer(self):
        r = HostRing(1 << 12, dtype=np.float32)
        rd = r.add_reader()

        def prod():
            time.sleep(0.1)
            r.write(np.arange(100, dtype=np.float32))

        t = threading.Thread(target=prod)
        t.start()
        got = read_exact(r, rd, 100, wait="block", timeout=5.0)
        t.join()
        assert got is not None and len(got) == 100

    def test_wait_timeout_and_eos(self):
        r = HostRing(1 << 10, dtype=np.float32)
        rd = r.add_reader()
        assert r.wait_readable(rd, 10, timeout=0.05) == -1
        r.set_eos()
        assert r.wait_readable(rd, 10, timeout=1.0) == 0

    def test_wait_writable_woken_by_release(self):
        r = HostRing(1 << 10, dtype=np.float32)
        rd = r.add_reader()
        r.write(np.zeros(r.capacity, np.float32), block=False)
        assert r.writable() == 0

        def consume():
            time.sleep(0.1)
            r.release(rd, 64)

        t = threading.Thread(target=consume)
        t.start()
        assert r.wait_writable(64, timeout=5.0) == 1
        t.join()

    def test_blocked_writer_completes(self):
        r = HostRing(256, dtype=np.float32)
        rd = r.add_reader()
        data = np.arange(1024, dtype=np.float32)

        def drain():
            seen = 0
            while seen < len(data):
                chunk = read_exact(r, rd, min(128, len(data) - seen),
                                   wait="block", timeout=5.0)
                assert chunk is not None
                np.testing.assert_array_equal(
                    chunk, data[seen:seen + len(chunk)])
                seen += len(chunk)

        t = threading.Thread(target=drain)
        t.start()
        wrote = r.write(data, block=True, timeout=5.0)
        t.join()
        assert wrote == len(data)


class TestThreadPoolWired:
    def test_runtime_threads_registered(self):
        from gnuradio4_tpu.utils import thread_pool
        g = gr.Graph()
        src = g.emplace("ConstantSource", value=1.0, n_samples=1 << 16)
        snk = gr.global_registry.create("VectorSink")
        g.connect(src, snk)
        sched = gr.Scheduler(g, block_len=1 << 14, watchdog_timeout=30.0)
        sched.start()
        deadline = time.monotonic() + 5.0
        names = []
        while time.monotonic() < deadline:
            names = thread_pool.active_threads()
            if any("runner" in n for n in names):
                break
            time.sleep(0.005)
        sched.wait_done(30.0)
        assert any("runner" in n for n in names), names
