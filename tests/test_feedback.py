"""Graph-level feedback loops (VERDICT #2; ≈ reference feedback merges,
BlockMerging.hpp:628-645): connect(..., feedback=True, delay=N) closes a cycle
whose back-edge value is a lax.scan carry, delayed N samples, persisting across
scheduler steps."""

import numpy as np
import pytest

import gnuradio4_tpu as gr


def _agc_loop_graph(x, rate, delay):
    """AGC as a graph CYCLE: y = x·g; g' = clip(g + rate·(1 − |y|)) fed back
    into the multiplier (and the updater itself) with ``delay`` samples lag."""
    g = gr.Graph()
    src = g.emplace("VectorSource", data=x)
    mul = g.emplace("Multiply", n_inputs=2)
    upd = g.emplace("ExpressionDISO",
                    expression=f"clip(y + {rate}*(1.0 - abs(x)), 1e-6, 65536.0)")
    snk = gr.global_registry.create("VectorSink")
    g.connect(src, mul["in0"])
    g.connect(mul, upd["x"])
    g.connect(upd["out"], mul["in1"], feedback=True, delay=delay, fb_init=1.0)
    g.connect(upd["out"], upd["y"], feedback=True, delay=delay, fb_init=1.0)
    g.connect(mul, snk)
    return g, snk


class TestFeedbackLoops:
    def test_agc_graph_loop_matches_monolithic_block(self):
        """Per-sample (delay=1) graph loop reproduces the monolithic Agc block
        exactly, across multiple scheduler steps (back-edge state persists)."""
        rng = np.random.default_rng(3)
        x = (0.25 * rng.standard_normal(4096)).astype(np.float32)

        g1 = gr.Graph()
        src1 = g1.emplace("VectorSource", data=x)
        agc = g1.emplace("Agc", reference=1.0, rate=1e-2)
        snk1 = gr.global_registry.create("VectorSink")
        g1.connect_chain(src1, agc, snk1)
        gr.Scheduler(g1, block_len=1024, pipeline_depth=1).run_and_wait()
        ref = snk1.data()

        g2, snk2 = _agc_loop_graph(x, 0.01, delay=1)
        gr.Scheduler(g2, block_len=1024, pipeline_depth=1).run_and_wait()
        np.testing.assert_allclose(snk2.data(), ref, atol=1e-5)
        # and it converges: output magnitude approaches the reference level
        assert 0.8 < np.mean(np.abs(snk2.data()[-512:])) < 1.2

    def test_chunked_feedback_converges(self):
        """delay=64 sub-chunk feedback: a block-update control loop."""
        rng = np.random.default_rng(4)
        x = (0.25 * rng.standard_normal(4096)).astype(np.float32)
        g, snk = _agc_loop_graph(x, 0.5, delay=64)
        gr.Scheduler(g, block_len=1024, pipeline_depth=1).run_and_wait()
        assert 0.8 < np.mean(np.abs(snk.data()[-512:])) < 1.2

    def test_plain_cycle_still_rejected(self):
        g = gr.Graph()
        a = g.emplace("MultiplyConst", value=0.5)
        b = g.emplace("AddConst", value=1.0)
        g.connect(a, b)
        g.connect(b, a)   # no feedback=True → hard error
        with pytest.raises(gr.GrError, match="feedback=True"):
            g.topological_order()

    def test_feedback_without_forward_path_rejected(self):
        g = gr.Graph()
        src = g.emplace("ConstantSource", n_samples=64)
        a = g.emplace("MultiplyConst", value=1.0)
        snk = gr.global_registry.create("NullSink")
        g.connect_chain(src, a, snk)
        srcb = g.emplace("ConstantSource", n_samples=64)
        b = g.emplace("Multiply", n_inputs=2)
        snkb = gr.global_registry.create("NullSink")
        g.connect(srcb, b["in0"])
        g.connect(b, snkb)
        # a and b are in disjoint branches: the back-edge a→b closes no cycle
        g.connect(a, b["in1"], feedback=True)
        with pytest.raises(gr.GrError, match="forward path"):
            gr.compile_graph(g, block_len=64)

    def test_rate_changing_loop_member_rejected(self):
        g = gr.Graph()
        src = g.emplace("ConstantSource", n_samples=256)
        mul = g.emplace("Multiply", n_inputs=2)
        dec = g.emplace("Decimator", decim=2)
        snk = gr.global_registry.create("NullSink")
        g.connect(src, mul["in0"])
        g.connect(mul, dec)
        g.connect(dec, mul["in1"], feedback=True)
        g.connect(dec, snk)
        with pytest.raises(gr.GrError, match="rate-1"):
            gr.compile_graph(g, block_len=256)

    def test_feedback_under_sp_mesh_matches_unsharded(self):
        """Under time sharding the loop group runs as a replicated island
        (all_gather inputs, identical scan per shard, re-slice outputs) —
        bit-exact vs the unsharded run."""
        import jax
        from jax.sharding import Mesh
        devs = jax.devices()
        if len(devs) < 8:
            pytest.skip("needs 8 devices")
        rng = np.random.default_rng(3)
        x = (0.25 * rng.standard_normal(4096)).astype(np.float32)
        g1, s1 = _agc_loop_graph(x, 0.01, delay=1)
        gr.Scheduler(g1, block_len=1024, pipeline_depth=1).run_and_wait()
        mesh = Mesh(np.asarray(devs[:8]), ("sp",))
        g2, s2 = _agc_loop_graph(x, 0.01, delay=1)
        gr.Scheduler(g2, block_len=1024, mesh=mesh,
                     pipeline_depth=1).run_and_wait()
        np.testing.assert_array_equal(s2.data(), s1.data())

    def test_checkpoint_preserves_backedge(self, tmp_path):
        """The __fb__ state round-trips through save/load_checkpoint
        (checkpointable seeded NoiseSource feeds the loop)."""
        from gnuradio4_tpu.core.checkpoint import (load_checkpoint,
                                                   save_checkpoint)

        def build():
            g = gr.Graph()
            src = g.emplace("NoiseSource", seed=7, n_samples=2048)
            src.name = "noise"
            att = g.emplace("MultiplyConst", value=0.25)
            att.name = "att"
            mul = g.emplace("Multiply", n_inputs=2)
            mul.name = "vga"
            upd = g.emplace(
                "ExpressionDISO",
                expression="clip(y + 0.01*(1.0 - abs(x)), 1e-6, 65536.0)")
            upd.name = "loopfilter"
            snk = gr.global_registry.create("VectorSink")
            snk.name = "cap"
            g.connect_chain(src, att)
            g.connect(att, mul["in0"])
            g.connect(mul, upd["x"])
            g.connect(upd["out"], mul["in1"], feedback=True, delay=1,
                      fb_init=1.0)
            g.connect(upd["out"], upd["y"], feedback=True, delay=1,
                      fb_init=1.0)
            g.connect(mul, snk)
            return g, snk

        g_ref, snk_ref = build()
        gr.Scheduler(g_ref, block_len=512, pipeline_depth=1).run_and_wait()
        ref = snk_ref.data()

        g, snk = build()
        sched = gr.Scheduler(g, block_len=512, pipeline_depth=1)
        sched.init()
        for _ in range(2):
            sched._pump_once()
        sched._drain()
        first = snk.data()
        ck = save_checkpoint(sched, tmp_path / "fb")
        sched.request_stop()

        resumed = load_checkpoint(ck, pipeline_depth=1)
        snk2 = [b for b in resumed.compiled.order if b.name == "cap"][0]
        while resumed._pump_once():
            pass
        resumed._drain()
        joined = np.concatenate([first, snk2.data()])
        assert joined.shape == ref.shape
        np.testing.assert_allclose(joined, ref, atol=1e-5)


class TestLoopTopologies:
    def test_sourceless_oscillator_self_loop(self):
        """A self-contained loop with NO external stream input (feedback
        oscillator): the scan runs with an explicit length. Each delay-chunk
        increments by 1 (x+1 around the loop)."""
        g = gr.Graph()
        osc = g.emplace("ExpressionSISO", expression="x + 1.0")
        head = g.emplace("HeadBlock", n_samples=512)
        snk = gr.global_registry.create("VectorSink")
        g.connect(osc["out"], osc["in"], feedback=True, delay=64, fb_init=0.0)
        g.connect(osc, head)
        g.connect(head, snk)
        gr.Scheduler(g, block_len=256, pipeline_depth=1).run_and_wait()
        y = snk.data()
        assert y.shape == (512,)
        expect = np.repeat(np.arange(1, 9, dtype=np.float32), 64)
        np.testing.assert_array_equal(y, expect)

    def test_two_disjoint_loops(self):
        """Two independent feedback groups in one graph lower separately."""
        x = np.ones(1024, np.float32)

        def loop(g, src, rate):
            mul = g.emplace("Multiply", n_inputs=2)
            upd = g.emplace("ExpressionDISO",
                            expression=f"clip(y + {rate}*(1.0 - abs(x)), "
                                       f"1e-6, 1e4)")
            g.connect(src, mul["in0"])
            g.connect(mul, upd["x"])
            g.connect(upd["out"], mul["in1"], feedback=True, fb_init=1.0)
            g.connect(upd["out"], upd["y"], feedback=True, fb_init=1.0)
            return mul

        g = gr.Graph()
        s1 = g.add(gr.global_registry.create("VectorSource", data=0.5 * x))
        s2 = g.add(gr.global_registry.create("VectorSource", data=0.25 * x))
        m1, m2 = loop(g, s1, 0.05), loop(g, s2, 0.1)
        k1 = gr.global_registry.create("VectorSink")
        k2 = gr.global_registry.create("VectorSink")
        g.connect(m1, k1)
        g.connect(m2, k2)
        sched = gr.Scheduler(g, block_len=512, pipeline_depth=1)
        sched.run_and_wait()
        assert len(sched.compiled.loop_groups) == 2
        assert 0.8 < abs(k1.data()[-1]) < 1.2
        assert 0.8 < abs(k2.data()[-1]) < 1.2
