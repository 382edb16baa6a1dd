"""Multi-graph Runtime (core/runtime.py): independent schedulers + ring pipes
(≈ reference multiple scheduler instances / ScheduledBlockGroup,
Scheduler.hpp:89, Block.hpp:579-585)."""

import numpy as np
import pytest

import gnuradio4_tpu as gr


def test_cross_graph_pipe_exact():
    rt = gr.Runtime()
    acq = gr.Graph()
    a_src = acq.emplace("SignalGenerator", frequency=1000.0, n_samples=65536)
    a_pipe = acq.emplace("PipeSink")
    acq.connect(a_src, a_pipe)
    dsp = gr.Graph()
    d_src = dsp.emplace("StreamSource", dtype="float32")
    d_mul = dsp.emplace("MultiplyConst", value=3.0)
    d_snk = dsp.emplace("VectorSink")
    dsp.connect_chain(d_src, d_mul, d_snk)
    rt.add(acq, block_len=8192, sample_rate=48000.0)
    rt.add(dsp, block_len=2048, sample_rate=48000.0)   # different cadence
    rt.pipe(a_pipe, d_src)
    rt.run_all(timeout=120)

    ref_g = gr.Graph()
    r_src = ref_g.emplace("SignalGenerator", frequency=1000.0, n_samples=65536)
    r_snk = ref_g.emplace("VectorSink")
    ref_g.connect(r_src, r_snk)
    gr.Scheduler(ref_g, block_len=8192, sample_rate=48000.0).run_and_wait()
    ref = (3.0 * np.asarray(r_snk.data())[:65536]).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(d_snk.data())[:65536], ref)


def test_unconnected_pipe_error_surfaces_to_waiter():
    g = gr.Graph()
    src = g.emplace("SignalGenerator", n_samples=4096)
    ps = g.emplace("PipeSink")
    g.connect(src, ps)
    rt = gr.Runtime()
    rt.add(g, block_len=2048, sample_rate=1e6)
    with pytest.raises(gr.GrError, match="not connected"):
        rt.run_all(timeout=60)


def test_stop_all_mid_run():
    import time
    rt = gr.Runtime()
    ga = gr.Graph()
    sa = ga.emplace("SignalGenerator")          # infinite
    pa = ga.emplace("PipeSink")
    ga.connect(sa, pa)
    gb = gr.Graph()
    sb = gb.emplace("StreamSource")
    kb = gb.emplace("NullSink")
    gb.connect(sb, kb)
    rt.add(ga, block_len=4096, sample_rate=1e6)
    rt.add(gb, block_len=4096, sample_rate=1e6)
    rt.pipe(pa, sb)
    rt.start_all()
    time.sleep(0.3)
    rt.stop_all()
    # generous: cold jit compiles can take minutes on a loaded host
    rt.wait_all(300)
    assert all(s.state is gr.State.STOPPED for s in rt.schedulers)


def test_pipe_rejects_non_source():
    rt = gr.Runtime()
    g = gr.Graph()
    ps = g.emplace("PipeSink")
    snk = g.emplace("NullSink")
    with pytest.raises(gr.GrError, match="StreamSource"):
        rt.pipe(ps, snk)
