"""Polar codes: butterfly involution, bit-reversed Bhattacharyya
construction (the natural-order encoder's reliabilities map through the
bit-reversal permutation — regression for the round-3 construction bug),
SC decoding gain, SC ≈ ML on a small code, device encoder equality, and
the stream blocks through the Scheduler."""

import numpy as np
import pytest

import gnuradio4_tpu as gr
from gnuradio4_tpu.blocks.testing import VectorSink, VectorSource
from gnuradio4_tpu.core.errors import GrError
from gnuradio4_tpu.ops.polar import (encode, frozen_mask, polar_decode,
                                     polar_encode)


class TestConstruction:
    def test_butterfly_involution(self):
        rng = np.random.default_rng(0)
        u = rng.integers(0, 2, (4, 256)).astype(np.uint8)
        np.testing.assert_array_equal(encode(encode(u)), u)

    def test_frozen_count_and_known_n8_set(self):
        fr = frozen_mask(8, 4)
        assert fr.sum() == 4
        np.testing.assert_array_equal(np.flatnonzero(~fr), [3, 5, 6, 7])

    def test_bad_params(self):
        with pytest.raises(GrError):
            frozen_mask(100, 50)    # not a power of two
        with pytest.raises(GrError):
            frozen_mask(64, 64)

    def test_sc_close_to_ml_n32(self):
        # regression for the bit-reversal construction bug: with the wrong
        # index mapping SC ran 30x worse than ML
        N, K = 32, 8
        fr = frozen_mask(N, K)
        rng = np.random.default_rng(1)
        msgs = [np.array([(m >> i) & 1 for i in range(K)], np.uint8)
                for m in range(256)]
        cws = np.stack([polar_encode(m, fr) for m in msgs])
        err_sc = err_ml = 0
        T = 200
        for _ in range(T):
            mi = rng.integers(256)
            y = 1.0 - 2.0 * cws[mi] + 0.9 * rng.standard_normal(N)
            dec = polar_decode(2 * y / 0.81, fr)
            err_sc += not np.array_equal(dec, msgs[mi])
            d = np.sum((y[None, :] - (1.0 - 2.0 * cws)) ** 2, axis=1)
            err_ml += int(np.argmin(d) != mi)
        assert err_sc <= err_ml + 0.05 * T


class TestDecode:
    def test_clean_roundtrip(self):
        rng = np.random.default_rng(2)
        fr = frozen_mask(256, 128)
        bits = rng.integers(0, 2, 10 * 128).astype(np.uint8)
        cw = polar_encode(bits, fr)
        llr = 8.0 * (1.0 - 2.0 * cw.astype(np.float64))
        np.testing.assert_array_equal(polar_decode(llr, fr), bits)

    @pytest.mark.parametrize("N", [64, 256])
    def test_coding_gain_at_3db(self, N):
        rng = np.random.default_rng(0)
        K = N // 2
        fr = frozen_mask(N, K)
        bits = rng.integers(0, 2, 20 * K).astype(np.uint8)
        cw = polar_encode(bits, fr)
        sigma = np.sqrt(1.0 / (2 * 10 ** 0.3 * 0.5))
        y = 1.0 - 2.0 * cw + sigma * rng.standard_normal(len(cw))
        dec = polar_decode(2 * y / sigma ** 2, fr)
        raw = np.mean((y < 0) != cw)
        coded = np.mean(dec != bits)
        assert raw > 0.04 and coded < raw / 2


class TestBlocks:
    def test_device_encoder_matches_host(self):
        rng = np.random.default_rng(2)
        N, K = 256, 128
        bits = rng.integers(0, 2, 8 * K).astype(np.float32)
        fr = frozen_mask(N, K)
        host = polar_encode(bits.astype(np.uint8), fr).astype(np.float32)
        g = gr.Graph()
        s = g.add(VectorSource(bits))
        e = g.emplace("PolarEncoder", n=N, k=K)
        v = g.add(VectorSink())
        g.connect_chain(s, e, v)
        gr.Scheduler(g, block_len=2 * K, sample_rate=1e6).run_and_wait()
        np.testing.assert_array_equal(np.asarray(v.data()), host)

    def test_decoder_block_cleans_channel(self):
        rng = np.random.default_rng(3)
        N, K = 256, 128
        fr = frozen_mask(N, K)
        bits = rng.integers(0, 2, 8 * K).astype(np.uint8)
        cw = polar_encode(bits, fr)
        sigma = 0.65
        y = 1.0 - 2.0 * cw + sigma * rng.standard_normal(len(cw))
        llr = (2 * y / sigma ** 2).astype(np.float32)
        assert np.mean((y < 0) != cw) > 0.03
        g = gr.Graph()
        s = g.add(VectorSource(llr))
        d = g.emplace("PolarDecoder", n=N, k=K)
        v = g.add(VectorSink())
        g.connect_chain(s, d, v)
        gr.Scheduler(g, block_len=2 * N, sample_rate=1e6).run_and_wait()
        np.testing.assert_array_equal(np.asarray(v.data()),
                                      bits.astype(np.float32))

    def test_rate_properties(self):
        e = gr.Graph().emplace("PolarEncoder", n=128, k=64)
        d = gr.Graph().emplace("PolarDecoder", n=128, k=64)
        assert e.alignment == 64 and d.alignment == 128
        assert float(e.ratio) * float(d.ratio) == 1.0
