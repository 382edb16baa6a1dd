"""LDPC: construction invariants (sparse H, systematic G, null-space),
min-sum decoding gain over AWGN, device/NumPy reference equality, early
behaviors (clean input, undecodable garbage syndrome flag), and the
device stream blocks through the Scheduler."""

import jax.numpy as jnp
import numpy as np
import pytest

import gnuradio4_tpu as gr
from gnuradio4_tpu.blocks.testing import VectorSink, VectorSource
from gnuradio4_tpu.core.errors import GrError
from gnuradio4_tpu.ops.ldpc import (LdpcGraph, decode_np, encode, make_ldpc,
                                    min_sum_decode)


class TestConstruction:
    @pytest.mark.parametrize("n,m", [(96, 48), (256, 128), (120, 40)])
    def test_invariants(self, n, m):
        H, G = make_ldpc(n, m, wc=3, seed=2)
        k = G.shape[0]
        assert H.shape[1] == n and G.shape == (k, n)
        assert k >= n - m                    # rank deficiency only helps k
        assert not ((G @ H.T) % 2).any()     # null space
        # G systematic in the first k columns
        np.testing.assert_array_equal(G[:, :k], np.eye(k, dtype=np.uint8))
        # H stays SPARSE (BP quality depends on it): column weight == wc
        np.testing.assert_array_equal(H.sum(axis=0), 3)

    def test_encode_batch(self):
        H, G = make_ldpc(96, 48, seed=1)
        rng = np.random.default_rng(0)
        u = rng.integers(0, 2, (7, G.shape[0])).astype(np.uint8)
        c = encode(G, u)
        assert not ((c @ H.T) % 2).any()
        np.testing.assert_array_equal(c[:, :G.shape[0]], u)  # systematic

    def test_bad_params(self):
        with pytest.raises(GrError):
            make_ldpc(10, 10)


class TestDecoder:
    def _channel(self, n, m, snr_db, n_frames, seed=0):
        H, G = make_ldpc(n, m, wc=3, seed=1)
        k = G.shape[0]
        rng = np.random.default_rng(seed)
        u = rng.integers(0, 2, (n_frames, k)).astype(np.uint8)
        c = encode(G, u)
        sigma = np.sqrt(1.0 / (2 * 10 ** (snr_db / 10) * k / n))
        y = 1.0 - 2.0 * c + sigma * rng.standard_normal(c.shape)
        return H, G, k, u, c, y, 2 * y / sigma ** 2

    def test_coding_gain_at_4db(self):
        H, G, k, u, c, y, llr = self._channel(256, 128, 4.0, 50)
        bits, ok = min_sum_decode(LdpcGraph(H),
                                  jnp.asarray(llr, jnp.float32), 25)
        raw_ber = np.mean((y < 0) != c)
        coded_ber = np.mean(np.asarray(bits)[:, :k] != u)
        assert raw_ber > 0.03                # the channel is genuinely bad
        assert coded_ber == 0.0              # and the code cleans it fully
        assert np.asarray(ok).all()

    def test_gain_at_2db_partial(self):
        H, G, k, u, c, y, llr = self._channel(256, 128, 2.0, 50)
        bits, ok = min_sum_decode(LdpcGraph(H),
                                  jnp.asarray(llr, jnp.float32), 25)
        raw = np.mean((y < 0) != c)
        coded = np.mean(np.asarray(bits)[:, :k] != u)
        assert coded < raw / 3               # large gain even pre-waterfall

    def test_clean_input_converges_with_flags(self):
        H, G, k, u, c, y, llr = self._channel(96, 48, 30.0, 5)
        bits, ok = min_sum_decode(LdpcGraph(H),
                                  jnp.asarray(llr, jnp.float32), 5)
        assert np.asarray(ok).all()
        np.testing.assert_array_equal(np.asarray(bits), c)

    def test_garbage_flags_bad_syndrome(self):
        H, G = make_ldpc(96, 48, seed=1)
        rng = np.random.default_rng(3)
        llr = rng.standard_normal((4, 96)).astype(np.float32)
        _, ok = min_sum_decode(LdpcGraph(H), jnp.asarray(llr), 10)
        assert not np.asarray(ok).all()

    def test_device_matches_numpy_reference(self):
        H, G, k, u, c, y, llr = self._channel(96, 48, 3.0, 10, seed=7)
        b_d, ok_d = min_sum_decode(LdpcGraph(H),
                                   jnp.asarray(llr, jnp.float32), 25)
        b_n, ok_n = decode_np(H, llr, 25)
        np.testing.assert_array_equal(np.asarray(b_d), b_n)
        np.testing.assert_array_equal(np.asarray(ok_d), ok_n)


class TestBlocks:
    def test_decoder_block_cleans_channel(self):
        H, G = make_ldpc(256, 128, wc=3, seed=0)
        k = G.shape[0]
        rng = np.random.default_rng(1)
        u = rng.integers(0, 2, 4 * k).astype(np.float32)
        c = encode(G, u.reshape(-1, k).astype(np.uint8)).reshape(-1)
        sigma = 0.6
        y = 1.0 - 2.0 * c + sigma * rng.standard_normal(len(c))
        llr = (2 * y / sigma ** 2).astype(np.float32)
        assert np.mean((y < 0) != c) > 0.02
        g = gr.Graph()
        src = g.add(VectorSource(llr))
        dec = g.emplace("LdpcDecoder", n=256, m=128, seed=0)
        snk = g.add(VectorSink())
        g.connect_chain(src, dec, snk)
        gr.Scheduler(g, block_len=512, sample_rate=1e6).run_and_wait()
        np.testing.assert_array_equal(np.asarray(snk.data()), u)

    def test_encoder_decoder_chain(self):
        # bits -> LdpcEncoder -> {0,1}->LLR map -> LdpcDecoder -> bits,
        # all four stages fused into one device program
        H, G = make_ldpc(256, 128, wc=3, seed=0)
        k = G.shape[0]
        rng = np.random.default_rng(2)
        u = rng.integers(0, 2, 4 * k).astype(np.float32)
        g = gr.Graph()
        src = g.add(VectorSource(u))
        enc = g.emplace("LdpcEncoder", n=256, m=128, seed=0)
        scale = g.emplace("MultiplyConst", value=-16.0)
        off = g.emplace("AddConst", value=8.0)
        dec = g.emplace("LdpcDecoder", n=256, m=128, seed=0)
        snk = g.add(VectorSink())
        g.connect_chain(src, enc, scale, off, dec, snk)
        gr.Scheduler(g, block_len=2 * k, sample_rate=1e6).run_and_wait()
        np.testing.assert_array_equal(np.asarray(snk.data()), u)

    def test_rate_properties(self):
        enc = gr.Graph().emplace("LdpcEncoder", n=96, m=48, seed=1)
        dec = gr.Graph().emplace("LdpcDecoder", n=96, m=48, seed=1)
        assert enc.alignment == enc.k and dec.alignment == 96
        assert float(enc.ratio) * float(dec.ratio) == 1.0


def test_decoder_sp_sharded_bit_exact():
    """Framewise device blocks must survive the unified sp lowering
    unchanged (alignment-aware islanding): sharded == unsharded bits."""
    import jax
    from jax.sharding import Mesh
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    cpu_mesh8 = Mesh(np.asarray(devs[:8]), ("sp",))
    H, G = make_ldpc(256, 128, wc=3, seed=0)
    k = G.shape[0]
    rng = np.random.default_rng(4)
    u = rng.integers(0, 2, 8 * k).astype(np.float32)
    c = encode(G, u.reshape(-1, k).astype(np.uint8)).reshape(-1)
    y = 1.0 - 2.0 * c + 0.6 * rng.standard_normal(len(c))
    llr = (2 * y / 0.36).astype(np.float32)

    def run(mesh):
        g = gr.Graph()
        src = g.add(VectorSource(llr))
        dec = g.emplace("LdpcDecoder", n=256, m=128, seed=0)
        snk = g.add(VectorSink())
        g.connect_chain(src, dec, snk)
        gr.Scheduler(g, block_len=1024, sample_rate=1e6,
                     mesh=mesh).run_and_wait()
        return np.asarray(snk.data())

    un = run(None)
    sh = run(cpu_mesh8)
    np.testing.assert_array_equal(un, sh)
    np.testing.assert_array_equal(un, u)


def test_dense_decoder_matches_segment_formulation():
    """The accelerator dense check-layout decoder (one-hot matmuls, per-row
    two-minimum — no scatter/segment HLOs) must bit-match the flat
    segment-op reference on identical LLRs."""
    from gnuradio4_tpu.ops.ldpc import (LdpcGraph, encode, make_ldpc,
                                        min_sum_decode, min_sum_decode_dense)
    H, G = make_ldpc(256, 128, wc=3, seed=0)
    g = LdpcGraph(H)
    rng = np.random.default_rng(11)
    u = rng.integers(0, 2, (32, G.shape[0])).astype(np.uint8)
    c = encode(G, u)
    y = 1.0 - 2.0 * c + 0.5 * rng.standard_normal(c.shape)
    llr = (2 * y / 0.25).astype(np.float32)
    h1, ok1 = min_sum_decode(g, llr, 25)
    h2, ok2 = min_sum_decode_dense(g, llr, 25)
    np.testing.assert_array_equal(np.asarray(h1), np.asarray(h2))
    np.testing.assert_array_equal(np.asarray(ok1), np.asarray(ok2))
    assert np.asarray(ok2).all()
    np.testing.assert_array_equal(np.asarray(h2), c)
