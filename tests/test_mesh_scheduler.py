"""Mesh-aware scheduler paths.

1. GSPMD 'chan' constraints on multi-channel streams (config-5 shape).
2. Unified time-axis ('sp') sharding: the graph compiler lowers ANY flowgraph
   inside shard_map — ppermute halo exchange for carried stream state,
   replicated gather islands for sequential blocks — verified bit-equal to the
   unsharded run (the sharded_rx pipeline re-expressed as a plain Graph)."""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import gnuradio4_tpu as gr
from gnuradio4_tpu.blocks.channelizer import PFBChannelizer
from gnuradio4_tpu.blocks.filter import FirFilter
from gnuradio4_tpu.blocks.sdr import QuadratureDemod
from gnuradio4_tpu.blocks.testing import VectorSink, VectorSource
from gnuradio4_tpu.ops import filter_design as fd


@pytest.fixture(scope="module")
def chan_mesh():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 devices")
    return Mesh(np.asarray(devs[:8]), ("chan",))


@pytest.fixture(scope="module")
def sp_mesh():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 devices")
    return Mesh(np.asarray(devs[:8]), ("sp",))


def _build(iq):
    g = gr.Graph()
    src = VectorSource(iq)
    chan = PFBChannelizer(n_channels=64, taps_per_phase=4)
    dem = QuadratureDemod(gain=1.0)
    snk = VectorSink()
    g.connect_chain(src, chan, dem, snk)
    return g, snk


def test_mesh_run_matches_unsharded(chan_mesh):
    rng = np.random.default_rng(5)
    n = 64 * 512
    iq = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
          ).astype(np.complex64)

    g1, snk1 = _build(iq)
    gr.Scheduler(g1, block_len=n // 2).run_and_wait()
    ref = snk1.data()

    g2, snk2 = _build(iq)
    gr.Scheduler(g2, block_len=n // 2, mesh=chan_mesh).run_and_wait()
    out = snk2.data()

    assert out.shape == ref.shape == (64, 512)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_mesh_sharding_constraint_present(chan_mesh):
    """The compiled program actually carries the sharding constraint."""
    iq = np.zeros(64 * 128, np.complex64)
    g, _ = _build(iq)
    compiled = gr.compile_graph(g, block_len=64 * 128, mesh=chan_mesh, jit=False)
    import jax.numpy as jnp
    lowered = jax.jit(compiled.step_fn).lower(
        compiled.init_states(), compiled.gather_params(),
        {b.unique_name: {p.name: jnp.zeros((64 * 128,), jnp.complex64)
                         for p in b.out_ports}
         for b in compiled.fed_blocks})
    txt = lowered.as_text()
    assert "sharding" in txt  # GSPMD annotations present in the HLO


class TestUnifiedSpSharding:
    """Any graph time-shards through Scheduler(mesh=('sp',)) — VERDICT #1."""

    def _rx_graph(self, iq, audio_taps):
        g = gr.Graph()
        src = VectorSource(iq)
        chan = PFBChannelizer(n_channels=64, taps_per_phase=4)
        dem = QuadratureDemod(gain=1.0)
        fir = FirFilter(taps=audio_taps, decim=4)
        snk = VectorSink()
        g.connect_chain(src, chan, dem, fir, snk)
        return g, snk

    def test_sharded_rx_as_plain_graph(self, sp_mesh):
        """The flagship sharded_rx pipeline expressed as a plain Graph of
        PFBChannelizer→QuadratureDemod→FirFilter runs sp-sharded through the
        Scheduler and matches the unsharded run bitwise (halo exchange keeps
        every overlap-save boundary exact, across scheduler steps too)."""
        rng = np.random.default_rng(5)
        n = 64 * 1024
        iq = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
              ).astype(np.complex64)
        taps = fd.design_fir("lowpass", 33, sample_rate=1.0, f_low=0.1,
                             window="Hamming").astype(np.float32)

        g1, s1 = self._rx_graph(iq, taps)
        gr.Scheduler(g1, block_len=n // 2, pipeline_depth=1).run_and_wait()
        ref = s1.data()

        g2, s2 = self._rx_graph(iq, taps)
        gr.Scheduler(g2, block_len=n // 2, mesh=sp_mesh,
                     pipeline_depth=1).run_and_wait()
        out = s2.data()
        assert out.shape == ref.shape == (64, 256)
        np.testing.assert_array_equal(out, ref)

    def test_freq_xlating_nco_phase_offsets(self, sp_mesh):
        """Position-dependent NCO de-rotation stays exact: each shard offsets
        its integer phase by its global output position."""
        def build():
            g = gr.Graph()
            src = g.emplace("ComplexToneSource", frequency=0.12,
                            n_samples=32768)
            fx = g.emplace("FreqXlatingFir", center_freq=0.1,
                           sample_rate_in=1.0, decim=4,
                           taps=tuple(np.hamming(31) / np.hamming(31).sum()))
            snk = gr.global_registry.create("VectorSink")
            g.connect_chain(src, fx, snk)
            return g, snk

        g1, s1 = build()
        gr.Scheduler(g1, block_len=8192, pipeline_depth=1).run_and_wait()
        g2, s2 = build()
        gr.Scheduler(g2, block_len=8192, mesh=sp_mesh,
                     pipeline_depth=1).run_and_wait()
        # decim=4 gives 256-sample local outputs (< the 1024 NCO tile), so the
        # shards take the direct per-sample form while the unsharded run
        # takes the factored form: both are valid f32 roundings of the exact
        # integer phase — they agree to the phase-quantisation floor (~7e-7)
        np.testing.assert_allclose(
            s2.data(), s1.data(), rtol=0.0, atol=1e-6)

    def test_sequential_block_gather_island(self, sp_mesh):
        """Blocks that cannot time-shard (IIR scan state) fall back to a
        replicated all_gather island and stay exact."""
        def build():
            g = gr.Graph()
            src = g.emplace("SignalGenerator", frequency=1000.0,
                            n_samples=16384)
            de = g.emplace("FmDeemphasis", tau=75e-6, sample_rate_in=48000.0)
            mul = g.emplace("MultiplyConst", value=2.0)
            snk = gr.global_registry.create("VectorSink")
            g.connect_chain(src, de, mul, snk)
            return g, snk

        g1, s1 = build()
        gr.Scheduler(g1, block_len=4096, sample_rate=48000.0,
                     pipeline_depth=1).run_and_wait()
        g2, s2 = build()
        gr.Scheduler(g2, block_len=4096, sample_rate=48000.0, mesh=sp_mesh,
                     pipeline_depth=1).run_and_wait()
        np.testing.assert_array_equal(s2.data(), s1.data())

    def test_collectives_present_in_sharded_program(self, sp_mesh):
        """The lowered sp program really contains the halo/psum collectives."""
        iq = np.zeros(64 * 512, np.complex64)
        taps = np.ones(17, np.float32) / 17
        g, _ = self._rx_graph(iq, taps)
        compiled = gr.compile_graph(g, block_len=64 * 512, mesh=sp_mesh,
                                    jit=False)
        import jax.numpy as jnp
        lowered = jax.jit(compiled.step_fn).lower(
            compiled.init_states(), compiled.gather_params(),
            {b.unique_name: {p.name: jnp.zeros((64 * 512,), jnp.complex64)
                             for p in b.out_ports}
             for b in compiled.fed_blocks})
        txt = lowered.as_text()
        assert "permute" in txt       # ppermute halo exchange (StableHLO)
        assert "all_reduce" in txt    # psum tail broadcast


class TestIndexedNcoSharding:
    """Position-deterministic NCO blocks generate per shard without gather
    islands (exact uint32 phase offsets). Since round 4 the NCO uses the
    factored outer-product form (ops/signal.complex_exp_ramp): integer
    phases stay exact, but the final unit-vector product's FMA contraction
    may differ between program shapes, so sharded-vs-unsharded agreement is
    ≤2 f32 ulps rather than bitwise."""

    _NCO_ULP = dict(rtol=0.0, atol=2.4e-7)   # 2 ulps at |z| = 1

    def test_sources_and_rotator_bit_exact(self, sp_mesh):
        def build():
            g = gr.Graph()
            src = g.emplace("SignalGenerator", frequency=1234.5,
                            n_samples=32768)
            snk1 = gr.global_registry.create("VectorSink")
            g.connect(src, snk1)
            tone = g.emplace("ComplexToneSource", frequency=777.0,
                             n_samples=32768)
            rot = g.emplace("Rotator", frequency_shift=0.01,
                            sample_rate=48000.0)
            snk2 = gr.global_registry.create("VectorSink")
            g.connect_chain(tone, rot, snk2)
            return g, snk1, snk2

        g1, a1, b1 = build()
        gr.Scheduler(g1, block_len=8192, sample_rate=48000.0,
                     pipeline_depth=1).run_and_wait()
        g2, a2, b2 = build()
        gr.Scheduler(g2, block_len=8192, sample_rate=48000.0, mesh=sp_mesh,
                     pipeline_depth=1).run_and_wait()
        np.testing.assert_array_equal(a2.data(), a1.data())
        np.testing.assert_allclose(b2.data(), b1.data(), **self._NCO_ULP)

    def test_rotator_phase_increment_surface_sharded(self, sp_mesh):
        """Regression: the _phoff phase offset (phase_increment/initial_phase
        surface) must be applied exactly ONCE on the sp path — nco_shard_apply
        re-enters apply() which already multiplies it in."""
        def build():
            g = gr.Graph()
            tone = g.emplace("ComplexToneSource", frequency=777.0,
                             n_samples=32768)
            rot = g.emplace("Rotator", phase_increment=np.pi / 2,
                            initial_phase=0.3)
            snk = gr.global_registry.create("VectorSink")
            g.connect_chain(tone, rot, snk)
            return g, snk
        g1, s1 = build()
        gr.Scheduler(g1, block_len=8192, sample_rate=48000.0,
                     pipeline_depth=1).run_and_wait()
        g2, s2 = build()
        gr.Scheduler(g2, block_len=8192, sample_rate=48000.0, mesh=sp_mesh,
                     pipeline_depth=1).run_and_wait()
        np.testing.assert_allclose(s2.data(), s1.data(), **self._NCO_ULP)

    def test_no_gather_island_in_program(self, sp_mesh):
        g = gr.Graph()
        src = g.emplace("ComplexToneSource", frequency=777.0, n_samples=0)
        rot = g.emplace("Rotator", frequency_shift=0.01, sample_rate=48000.0)
        snk = gr.global_registry.create("NullSink")
        g.connect_chain(src, rot, snk)
        c = gr.compile_graph(g, block_len=8192, sample_rate=48000.0,
                             mesh=sp_mesh, jit=False)
        txt = jax.jit(c.step_fn).lower(
            c.init_states(), c.gather_params(), {}).as_text()
        assert txt.count("all_gather") == 0


class TestCombinedSpChanMesh:
    """Manual-sp shard_map composed with GSPMD 'chan' constraints: a 2-D
    (sp×chan) mesh runs the receiver chain bit-exact vs unsharded."""

    def test_receiver_on_2d_mesh(self):
        devs = jax.devices()
        if len(devs) < 8:
            pytest.skip("needs 8 devices")
        mesh = Mesh(np.asarray(devs[:8]).reshape(4, 2), ("sp", "chan"))
        rng = np.random.default_rng(5)
        n = 64 * 1024
        iq = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
              ).astype(np.complex64)
        taps = fd.design_fir("lowpass", 33, sample_rate=1.0, f_low=0.1,
                             window="Hamming").astype(np.float32)

        def build():
            g = gr.Graph()
            src = VectorSource(iq)
            chan = PFBChannelizer(n_channels=64, taps_per_phase=4)
            dem = QuadratureDemod(gain=1.0)
            fir = FirFilter(taps=taps, decim=4)
            snk = VectorSink()
            g.connect_chain(src, chan, dem, fir, snk)
            return g, snk

        g1, s1 = build()
        gr.Scheduler(g1, block_len=n // 2, pipeline_depth=1).run_and_wait()
        g2, s2 = build()
        gr.Scheduler(g2, block_len=n // 2, mesh=mesh,
                     pipeline_depth=1).run_and_wait()
        np.testing.assert_array_equal(s2.data(), s1.data())


class TestMoreHaloBlocks:
    """History-pattern blocks declared on the sp protocol: MovingAverage and
    overlapped FFT shard with ppermute halos, bit-exact vs unsharded."""

    def test_moving_average_and_overlap_fft(self, sp_mesh):
        def build():
            g = gr.Graph()
            src = g.emplace("SignalGenerator", frequency=997.0,
                            n_samples=65536)
            ma = g.emplace("MovingAverage", length=33)
            fft = g.emplace("FFT", fft_size=256, stride=128, window="Hann",
                            output="magnitude")
            snk = gr.global_registry.create("VectorSink")
            g.connect_chain(src, ma, fft, snk)
            return g, snk

        g1, s1 = build()
        gr.Scheduler(g1, block_len=16384, sample_rate=48000.0,
                     pipeline_depth=1).run_and_wait()
        g2, s2 = build()
        gr.Scheduler(g2, block_len=16384, sample_rate=48000.0, mesh=sp_mesh,
                     pipeline_depth=1).run_and_wait()
        # cumsum/window reduction orders differ at shard seams → float32 ulps
        np.testing.assert_allclose(s2.data(), s1.data(), atol=1e-6)


class TestRandomGraphSpEquivalence:
    """Property test: random chains drawn from the shardable block pool
    compile under sp and match the unsharded run (seeded, deterministic)."""

    POOL = (
        lambda g: g.emplace("MultiplyConst", value=1.7),
        lambda g: g.emplace("AddConst", value=0.3),
        lambda g: g.emplace("MovingAverage", length=17),
        lambda g: g.emplace("FirFilter",
                            taps=tuple((np.hamming(21) / 11).tolist())),
        lambda g: g.emplace("FmDeemphasis", tau=75e-6,
                            sample_rate_in=48000.0),   # island member
        lambda g: g.emplace("Abs"),
    )

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_random_chain(self, sp_mesh, seed):
        rng = np.random.default_rng(seed)
        n_blocks = int(rng.integers(2, 5))
        picks = [int(rng.integers(0, len(self.POOL)))
                 for _ in range(n_blocks)]

        def build():
            g = gr.Graph()
            src = g.emplace("SignalGenerator", frequency=500.0 + seed,
                            n_samples=32768)
            prev = src
            for p in picks:
                blk = self.POOL[p](g)
                g.connect(prev, blk)
                prev = blk
            snk = gr.global_registry.create("VectorSink")
            g.connect(prev, snk)
            return g, snk

        g1, s1 = build()
        gr.Scheduler(g1, block_len=8192, sample_rate=48000.0,
                     pipeline_depth=1).run_and_wait()
        g2, s2 = build()
        gr.Scheduler(g2, block_len=8192, sample_rate=48000.0, mesh=sp_mesh,
                     pipeline_depth=1).run_and_wait()
        np.testing.assert_allclose(s2.data(), s1.data(), atol=2e-6,
                                   err_msg=f"picks={picks}")


class TestResamplerSpSharding:
    """BASELINE config 2 (rational polyphase resampler) time-shards with a
    ppermute halo; decimation/interpolation phase stays continuous at seams."""

    @pytest.mark.parametrize("interp,decim", [(1, 4), (3, 2), (2, 3)])
    def test_resampler_matches_unsharded(self, sp_mesh, interp, decim):
        rng = np.random.default_rng(interp * 10 + decim)
        x = rng.standard_normal(3 * 2 * 4 * 8 * 512).astype(np.float32)

        def build():
            g = gr.Graph()
            src = VectorSource(x)
            rs = g.emplace("RationalResampler", interp=interp, decim=decim,
                           ntaps_per_phase=12)
            snk = VectorSink()
            g.connect(src, rs)
            g.connect(rs, snk)
            return g, snk

        g1, s1 = build()
        gr.Scheduler(g1, block_len=len(x) // 2,
                     pipeline_depth=1).run_and_wait()
        g2, s2 = build()
        gr.Scheduler(g2, block_len=len(x) // 2, mesh=sp_mesh,
                     pipeline_depth=1).run_and_wait()
        assert s2.data().shape == s1.data().shape
        np.testing.assert_allclose(s2.data(), s1.data(), atol=1e-6)


def _placement_graph(resident: bool):
    rng = np.random.default_rng(9)
    n = 64 * 256 * 4
    iq = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
          ).astype(np.complex64)
    g = gr.Graph()
    src = VectorSource(iq, device_resident=resident)
    g.connect_chain(src, PFBChannelizer(n_channels=64, taps_per_phase=4),
                    QuadratureDemod(gain=1.0), snk := VectorSink())
    return g, snk


@pytest.mark.parametrize("axes,shape", [(("sp",), (4,)), (("chan",), (4,)),
                                        (("sp", "chan"), (2, 2))])
@pytest.mark.parametrize("batch_steps", [1, 2])
def test_mesh_step_compiles_once_and_copies_nothing(axes, shape, batch_steps):
    """States and params start where the step leaves them (replicated on the
    mesh): the second dispatch must not compile the step again for a new
    input placement, and no dispatch copies params or states between
    devices."""
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(shape), axes)
    g_ref, snk_ref = _placement_graph(resident=True)
    gr.Scheduler(g_ref, block_len=64 * 256,
                 batch_steps=batch_steps).run_and_wait()
    g, snk = _placement_graph(resident=True)
    sched = gr.Scheduler(g, block_len=64 * 256, mesh=mesh,
                         batch_steps=batch_steps)
    sched.init()
    more = sched.step_once()
    with jax.transfer_guard_device_to_device("disallow"):
        while more:
            more = sched.step_once()
        jax.block_until_ready(sched._states)
    assert sched.compiled.step_fn._cache_size() == 1
    for leaf in jax.tree_util.tree_leaves(sched._states):
        assert leaf.sharding.is_fully_replicated
    np.testing.assert_allclose(snk.data(), snk_ref.data(), atol=1e-5)
