"""Steady-state discipline (≈ reference qa_NoHeapScheduler: a graph must run
allocation-free once warmed up) + externalStep-style driving.

The device analogs of "no heap in steady state": (1) ZERO recompiles after
warm-up — the jitted step is traced once and every subsequent step is a cache
hit; (2) bounded host allocation per step — the pump must not accumulate or
churn large host buffers.
"""

import gc
import tracemalloc

import numpy as np

import gnuradio4_tpu as gr


def _chain(n=1 << 16):
    g = gr.Graph()
    src = g.emplace("SignalGenerator", frequency=1000.0, n_samples=0)
    fir = g.emplace("BasicFilter", filter_type="lowpass", f_low=2000.0,
                    ntaps=63, sample_rate_design=48000.0)
    snk = gr.global_registry.create("NullSink")
    g.connect_chain(src, fir, snk)
    return g


class TestSteadyState:
    def test_no_recompiles_after_warmup(self):
        sched = gr.Scheduler(_chain(), block_len=1 << 14, sample_rate=48000.0,
                             pipeline_depth=1)
        sched.init()
        for _ in range(2):
            sched._pump_once()
        compiled = sched.compiled
        # run 20 more steps: same CompiledGraph object, no re-jit
        for _ in range(20):
            sched._pump_once()
        assert sched.compiled is compiled
        assert not sched._dirty
        sched.request_stop()

    def test_bounded_host_allocation_per_step(self):
        """After warm-up, 30 steps must not grow host memory by more than a
        small per-step bound (the analog of allocation-free steady state —
        Python always allocates a little, but nothing proportional to the
        stream should stick)."""
        sched = gr.Scheduler(_chain(), block_len=1 << 14, sample_rate=48000.0,
                             pipeline_depth=1)
        sched.init()
        for _ in range(5):
            sched._pump_once()
        gc.collect()
        tracemalloc.start()
        base, _ = tracemalloc.get_traced_memory()
        for _ in range(30):
            sched._pump_once()
        gc.collect()
        now, _ = tracemalloc.get_traced_memory()
        tracemalloc.stop()
        sched.request_stop()
        growth = now - base
        # 30 steps × 16384 float32 samples = 2 MB of stream; retained host
        # growth must be far below that (no per-step stream buffering)
        assert growth < 256 * 1024, f"steady-state host growth {growth} B"

    def test_external_step_driving(self):
        """externalStep policy: the caller owns the cadence; step_once()
        advances exactly one step and reports completion."""
        g = gr.Graph()
        src = g.emplace("CountingSource", n_samples=2048)
        snk = gr.global_registry.create("VectorSink")
        g.connect(src, snk)
        sched = gr.Scheduler(g, block_len=512, pipeline_depth=1)
        steps = 0
        while sched.step_once():
            steps += 1
            assert sched.state is gr.State.RUNNING
        assert sched.state is gr.State.STOPPED
        np.testing.assert_array_equal(snk.data(), np.arange(2048))
        assert steps >= 4
