"""Stage-per-device pipeline parallelism (PP) over the virtual CPU mesh."""

import jax
import numpy as np
import pytest

import gnuradio4_tpu as gr
from gnuradio4_tpu.blocks.math import AddConst, MultiplyConst
from gnuradio4_tpu.parallel.pipeline import StagePipeline


def _stage(*blocks, name):
    g = gr.Graph(name=name)
    for b in blocks:
        g.add(b)
    for a, b in zip(blocks, blocks[1:]):
        g.connect(a, b)
    g.export_in("in", blocks[0], "in")
    g.export_out("out", blocks[-1], "out")
    return g


@pytest.fixture(scope="module")
def devices():
    devs = jax.devices()
    if len(devs) < 3:
        pytest.skip("needs >= 3 devices")
    return devs


def test_three_stage_pipeline_matches_fused(devices):
    s1 = _stage(MultiplyConst(value=2.0), name="x2")
    s2 = _stage(AddConst(value=10.0), name="+10")
    s3 = _stage(MultiplyConst(value=0.5), name="half")
    pipe = StagePipeline([s1, s2, s3], block_len=256,
                         boundary_dtype=np.float32, devices=devices[:3])
    blocks_in = [np.full(256, float(i), np.float32) for i in range(5)]
    outs = [np.asarray(pipe.push(b)) for b in blocks_in]
    for i, o in enumerate(outs):
        np.testing.assert_allclose(o, (i * 2.0 + 10.0) * 0.5)


def test_stage_devices_distinct(devices):
    s1 = _stage(MultiplyConst(value=1.0), name="a")
    s2 = _stage(MultiplyConst(value=1.0), name="b")
    pipe = StagePipeline([s1, s2], block_len=128, boundary_dtype=np.float32,
                         devices=devices[:2])
    out = pipe.push(np.ones(128, np.float32))
    assert out is not None
    # output lives on the second stage's device
    assert list(out.devices())[0] == devices[1]


def test_from_graph_domain_stage_cuts(devices):
    """Per-edge ComputeDomain device_index cuts a flowgraph into pipeline
    stages; output matches the single-device fused graph bit-for-bit."""
    import gnuradio4_tpu as gr

    def build():
        g = gr.Graph()
        src = g.emplace("SignalGenerator", frequency=1000.0, n_samples=16384)
        fir = g.emplace("BasicFilter", filter_type="lowpass", f_low=2000.0,
                        ntaps=63, sample_rate_design=48000.0)
        mul = g.emplace("MultiplyConst", value=3.0)
        return g, src, fir, mul

    g, src, fir, mul = build()
    g.connect(src, fir)
    g.connect(fir, mul, domain="gpu:xla:1")
    pipe = StagePipeline.from_graph(g, block_len=4096, sample_rate=48000.0,
                                    devices=devices[:2])
    assert len(pipe.stages) == 2
    outs = [np.asarray(pipe.push()) for _ in range(4)]

    g2, s2, f2, m2 = build()
    snk = gr.global_registry.create("VectorSink")
    g2.connect_chain(s2, f2, m2, snk)
    gr.Scheduler(g2, block_len=4096, sample_rate=48000.0).run_and_wait()
    np.testing.assert_allclose(np.concatenate(outs), snk.data(), atol=1e-6)
