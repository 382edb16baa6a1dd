"""Step batching (round-5): ``Scheduler(batch_steps=S)`` fuses S logical
sub-steps into ONE jitted dispatch via lax.scan, amortizing the per-dispatch
host floor, which dominates small blocks. The analog of the reference
amortizing per-work() overhead in its hot loop (Scheduler.hpp:722).

Semantics pinned here:
- bit-class equivalence with the unbatched scheduler on stateful chains,
- tag-accurate SAMPLE_ACCURATE settings still hit the exact sample even when
  the tag lands mid-batch (per-sub-step param overlays),
- post-ramp sub-steps inside the SAME batch use the new scalar value,
- EOS mid-batch (partial final batch) delivers exactly the right samples,
- tags arrive at sinks with correct absolute indices,
- ring-bridged subgraphs reject batching (their feeds consume the previous
  step's delivery),
- sp-mesh sharding composes with batching (scan over shard_map),
- async delivery composes with batching.
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import gnuradio4_tpu as gr
from gnuradio4_tpu.blocks.testing import TagSink, VectorSink, VectorSource
from gnuradio4_tpu.core.errors import GrError
from gnuradio4_tpu.core.tags import Tag


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _run_chain(x, bs, *, block_len=4096, taps=(0.5, 0.25, 0.125),
               fshift=1000.0, async_delivery=False):
    g = gr.Graph()
    src = g.emplace("VectorSource")
    src.data = x
    rot = g.emplace("Rotator", frequency_shift=fshift)
    fir = g.emplace("FirFilter", taps=taps)
    dem = g.emplace("QuadratureDemod", gain=1.0)
    snk = g.emplace("VectorSink")
    g.connect_chain(src, rot, fir, dem, snk)
    gr.Scheduler(g, block_len=block_len, sample_rate=1e6, batch_steps=bs,
                 async_delivery=async_delivery).run_and_wait()
    return np.asarray(snk.data())


class TestEquivalence:
    def test_stateful_chain_matches_unbatched(self, rng):
        """Rotator (NCO phase) + FIR (history) + demod (carried sample):
        state must thread through the scan carry exactly as it threads
        across dispatches."""
        n = 1 << 16
        x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
             ).astype(np.complex64)
        ref = _run_chain(x, 1)
        for bs in (2, 4, 8):
            out = _run_chain(x, bs)
            assert out.shape == ref.shape
            np.testing.assert_allclose(out, ref, atol=1e-5)

    def test_async_delivery_composes(self, rng):
        n = 1 << 15
        x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
             ).astype(np.complex64)
        ref = _run_chain(x, 1)
        out = _run_chain(x, 4, async_delivery=True)
        np.testing.assert_allclose(out, ref, atol=1e-5)

    def test_eos_mid_batch_partial_final(self, rng):
        """n_samples NOT a multiple of block_len*S: the final batch has
        valid sub-steps followed by zero-valid padding sub-steps — output
        length and content must be exact."""
        for n in (3 * 4096 + 1234, 5 * 4096, 4096 - 7):
            x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
                 ).astype(np.complex64)
            ref = _run_chain(x, 1)
            out = _run_chain(x, 4)
            assert out.shape == ref.shape, n
            np.testing.assert_allclose(out, ref, atol=1e-5)


class TestTagAccuracy:
    def test_value_switch_mid_batch_exact_sample(self):
        """value tag at abs 700 lands in sub-step 1 of the first batch
        (block_len 512, S=4): old·x before 700, new·x from 700 — zero slop."""
        g = gr.Graph()
        src = g.emplace("TagSource", value=1.0, n_samples=4096,
                        tags=[Tag(700, {"value": 3.0})])
        mul = g.emplace("MultiplyConst", value=2.0)
        snk = gr.global_registry.create("VectorSink")
        g.connect_chain(src, mul, snk)
        gr.Scheduler(g, block_len=512, pipeline_depth=1,
                     batch_steps=4).run_and_wait()
        y = snk.data()
        expect = np.where(np.arange(4096) < 700, 2.0, 3.0)
        np.testing.assert_array_equal(y, expect)

    def test_post_ramp_substeps_use_new_scalar(self):
        """Sub-steps AFTER the ramp sub-step — inside the same batch AND in
        the next batch — must run on the new scalar (the overlay forward-fill
        must not leak the ramp array)."""
        g = gr.Graph()
        src = g.emplace("TagSource", value=1.0, n_samples=8192,
                        tags=[Tag(100, {"value": 4.0})])
        mul = g.emplace("MultiplyConst", value=2.0)
        snk = gr.global_registry.create("VectorSink")
        g.connect_chain(src, mul, snk)
        gr.Scheduler(g, block_len=512, pipeline_depth=1,
                     batch_steps=4).run_and_wait()
        y = snk.data()
        expect = np.where(np.arange(8192) < 100, 2.0, 4.0)
        np.testing.assert_array_equal(y, expect)
        assert float(mul.settings.get("value")) == 4.0

    def test_two_ramps_in_different_substeps(self):
        """Two tags hitting different sub-steps of one batch each apply at
        their exact sample."""
        g = gr.Graph()
        src = g.emplace("TagSource", value=1.0, n_samples=4096,
                        tags=[Tag(300, {"value": 5.0}),
                              Tag(1500, {"value": 7.0})])
        mul = g.emplace("MultiplyConst", value=2.0)
        snk = gr.global_registry.create("VectorSink")
        g.connect_chain(src, mul, snk)
        gr.Scheduler(g, block_len=512, pipeline_depth=1,
                     batch_steps=8).run_and_wait()
        y = snk.data()
        expect = np.full(4096, 2.0, np.float32)
        expect[300:] = 5.0
        expect[1500:] = 7.0
        np.testing.assert_array_equal(y, expect)

    def test_rotator_frequency_switch_mid_batch_phase_continuous(self):
        """Derived-param ramp (uint32 _dphi array) mid-batch: instantaneous
        frequency switches at the exact sample; the integer-NCO phase stays
        continuous (the scalar sub-steps are promoted to constant ramp
        arrays — cumsum of a constant — with identical phase arithmetic)."""
        x = np.ones(8192, np.complex64)
        g = gr.Graph()
        src = VectorSource(x, tags=[Tag(1000, {"frequency_shift": 0.02})])
        g.add(src)
        rot = g.emplace("Rotator", sample_rate=1.0, frequency_shift=0.05)
        snk = gr.global_registry.create("VectorSink")
        g.connect_chain(src, rot, snk)
        gr.Scheduler(g, block_len=512, sample_rate=1.0, pipeline_depth=1,
                     batch_steps=4).run_and_wait()
        y = snk.data()
        inst = np.angle(y[1:] * np.conj(y[:-1])) / (2 * np.pi)
        np.testing.assert_allclose(inst[:1000], 0.05, atol=1e-4)
        np.testing.assert_allclose(inst[1000:], 0.02, atol=1e-4)
        np.testing.assert_allclose(np.abs(y), 1.0, atol=1e-5)

    def test_tags_delivered_at_correct_abs_indices(self):
        marks = [Tag(10, {"a": 1}), Tag(3000, {"b": 2}), Tag(7777, {"c": 3})]
        g = gr.Graph()
        src = g.emplace("TagSource", value=1.0, n_samples=8192,
                        tags=list(marks))
        snk = TagSink()
        g.connect_chain(src, snk)
        gr.Scheduler(g, block_len=1024, pipeline_depth=1,
                     batch_steps=4).run_and_wait()
        got = [(int(t.index), {k: v for k, v in t.map.items()
                               if k in ("a", "b", "c")})
               for t in snk.tags if set(t.map) & {"a", "b", "c"}]
        assert got == [(10, {"a": 1}), (3000, {"b": 2}), (7777, {"c": 3})]


class TestBoundaries:
    def test_ring_bridge_rejects_batching(self):
        """A ScheduledSubgraph bridge (FEED + consume) feeds from the
        previous step's delivery — batching must be rejected loudly."""
        from gnuradio4_tpu.core.subgraph import ScheduledSubgraph
        inner = gr.Graph()
        a = inner.emplace("MultiplyConst", value=2.0)
        inner.export_in("in", a, "in")
        inner.export_out("out", a, "out")
        g = gr.Graph()
        src = g.emplace("VectorSource")
        src.data = np.ones(4096, np.float32)
        bridge = g.add(ScheduledSubgraph(inner))
        snk = g.emplace("VectorSink")
        g.connect_chain(src, bridge, snk)
        with pytest.raises(GrError, match="batch_steps"):
            gr.Scheduler(g, block_len=1024, batch_steps=4).run_and_wait()

    def test_batch_steps_validation(self):
        g = gr.Graph()
        with pytest.raises(GrError, match="batch_steps"):
            gr.Scheduler(g, batch_steps=0)

    def test_head_block_terminates_inside_batch(self, rng):
        """HeadBlock clamp mid-batch: exactly n samples delivered, graph
        winds down even though the clamp lands on an inner sub-step."""
        g = gr.Graph()
        src = g.emplace("ConstantSource", value=1.0)
        head = g.emplace("HeadBlock", n_samples=5000)
        snk = g.emplace("VectorSink")
        g.connect_chain(src, head, snk)
        gr.Scheduler(g, block_len=512, pipeline_depth=1,
                     batch_steps=4).run_and_wait()
        assert snk.data().shape[-1] == 5000


class TestMesh:
    @pytest.fixture(scope="class")
    def sp_mesh(self):
        devs = jax.devices()
        if len(devs) < 8:
            pytest.skip("needs 8 devices")
        return Mesh(np.asarray(devs[:8]), ("sp",))

    def test_sp_sharded_batched_matches_unsharded(self, sp_mesh, rng):
        """scan-over-shard_map: the batched program under an sp mesh stays
        bit-class equal to the plain unbatched unsharded run."""
        n = 1 << 15
        x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
             ).astype(np.complex64)

        def build():
            g = gr.Graph()
            src = VectorSource(x)
            g.add(src)
            fir = g.emplace("FirFilter", taps=(0.5, 0.25, 0.125))
            dem = g.emplace("QuadratureDemod", gain=1.0)
            snk = VectorSink()
            g.connect_chain(src, fir, dem, snk)
            return g, snk

        g1, snk1 = build()
        gr.Scheduler(g1, block_len=4096, sample_rate=1e6).run_and_wait()
        ref = snk1.data()
        g2, snk2 = build()
        gr.Scheduler(g2, block_len=4096, sample_rate=1e6, mesh=sp_mesh,
                     batch_steps=4).run_and_wait()
        out = snk2.data()
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, atol=1e-5)


class TestProgressGranularity:
    """VERDICT r4 item 8: batching coarsens progress S-fold — the watchdog,
    pipeline depth, and async delivery all operate on SUPER-steps."""

    def test_step_counter_advances_by_batch(self):
        g = gr.Graph()
        src = g.emplace("ConstantSource", value=1.0)
        head = g.emplace("HeadBlock", n_samples=8192)
        snk = g.emplace("VectorSink")
        g.connect_chain(src, head, snk)
        sched = gr.Scheduler(g, block_len=512, pipeline_depth=1,
                             batch_steps=4)
        sched.init()
        assert sched._step == 0
        sched._pump_once()
        assert sched._step == 4      # one super-step = 4 logical steps
        t1 = sched._last_progress
        sched._pump_once()
        assert sched._step == 8
        assert sched._last_progress >= t1   # progress stamps per super-step

    def test_watchdog_not_tripped_by_healthy_batches(self):
        """A watchdog window longer than one super-step must not flag a
        stall merely because progress lands S steps at a time."""
        g = gr.Graph()
        src = g.emplace("ConstantSource", value=1.0)
        head = g.emplace("HeadBlock", n_samples=1 << 16)
        snk = g.emplace("VectorSink")
        g.connect_chain(src, head, snk)
        sched = gr.Scheduler(g, block_len=512, pipeline_depth=1,
                             batch_steps=8, watchdog_timeout=30.0)
        flagged = []
        sched.bus.subscribe("Watchdog", lambda m: flagged.append(m))
        sched.run_and_wait()
        assert not flagged
        assert snk.data().shape[-1] == 1 << 16

    def test_inflight_counts_super_steps(self):
        """pipeline_depth bounds in-flight SUPER-steps: delivery lag in
        logical blocks is depth*batch_steps (the latency/throughput trade
        LATENCY_r05 quantifies)."""
        g = gr.Graph()
        src = g.emplace("ConstantSource", value=1.0)
        head = g.emplace("HeadBlock", n_samples=1 << 15)
        snk = g.emplace("VectorSink")
        g.connect_chain(src, head, snk)
        sched = gr.Scheduler(g, block_len=512, pipeline_depth=2,
                             batch_steps=4)
        sched.init()
        sched._pump_once()
        sched._pump_once()
        assert len(sched._inflight) == 2
        assert all(len(r.batch) == 4 for r in sched._inflight)
        # nothing delivered yet at depth 2 → sink is 2*4 logical blocks behind
        assert snk.data().shape[-1] == 0
        sched._drain()
        assert snk.data().shape[-1] == 4096


class TestDeviceTagPathUnderBatching:
    """WANTS_TAG_ARRAYS blocks (TriggerGate) derive device params from the
    per-sub-step tag walk — under batching these ride the per-sub-step
    overlay, so a trigger landing in sub-step k must gate exactly its
    samples, including windows carried across sub-step boundaries."""

    def test_trigger_gate_windows_exact_under_batching(self):
        from gnuradio4_tpu.core.tags import Keys
        tags = [Tag(100, {Keys.TRIGGER_NAME: "T"}),
                Tag(500, {Keys.TRIGGER_NAME: "T"}),
                Tag(1000, {Keys.TRIGGER_NAME: "X"})]  # filtered out
        g = gr.Graph()
        src = g.emplace("TagSource", value=1.0, n_samples=2048,
                        tags=[Tag(t.index, dict(t.map)) for t in tags])
        gate = g.emplace("TriggerGate", filter="T", n_pre=10, n_post=50)
        snk = gr.global_registry.create("VectorSink")
        g.connect_chain(src, gate, snk)
        gr.Scheduler(g, block_len=256, pipeline_depth=1,
                     batch_steps=4).run_and_wait()
        expect = np.zeros(2048, np.float32)
        for i in (100, 500):
            expect[i - 10:i + 50] = 1.0
        np.testing.assert_array_equal(snk.data(), expect)

    def test_window_carries_across_substep_boundary(self):
        from gnuradio4_tpu.core.tags import Keys
        g = gr.Graph()
        src = g.emplace("TagSource", value=1.0, n_samples=1024,
                        tags=[Tag(250, {Keys.TRIGGER_NAME: "T"})])
        gate = g.emplace("TriggerGate", filter="T", n_post=100)
        snk = gr.global_registry.create("VectorSink")
        g.connect_chain(src, gate, snk)
        gr.Scheduler(g, block_len=256, pipeline_depth=1,
                     batch_steps=2).run_and_wait()
        expect = np.zeros(1024, np.float32)
        expect[250:350] = 1.0
        np.testing.assert_array_equal(snk.data(), expect)


def test_graph_done_mid_batch_stops_host_feeds():
    """Round-5 review finding: when HeadBlock terminates the graph at
    sub-step k, the remaining sub-steps of the batch must be INERT — a live
    host source's read position must not advance past the stop, and sinks
    must not receive post-stop samples."""
    from gnuradio4_tpu.core.block import Block, Port

    calls = []

    class CountingFeed(Block):
        OUT = (Port("out", dtype="float32"),)
        FEED = True

        def host_feed(self, n, abs_index):
            calls.append(abs_index)
            return {"out": np.full(n, 1.0, np.float32)}

        def apply(self, state, ins, ctx):
            return state, {"out": ins["out"]}

    g = gr.Graph()
    src = g.add(CountingFeed())
    head = g.emplace("HeadBlock", n_samples=600)   # stops in sub-step 2 of 8
    snk = g.emplace("VectorSink")
    g.connect_chain(src, head, snk)
    gr.Scheduler(g, block_len=256, pipeline_depth=1,
                 batch_steps=8).run_and_wait()
    assert snk.data().shape[-1] == 600
    # 600 samples need 3 blocks of 256; the terminating sub-step may fetch
    # one block — anything beyond 4 fetched blocks means the batch kept
    # pulling the source after the stop
    assert len(calls) <= 4, calls
