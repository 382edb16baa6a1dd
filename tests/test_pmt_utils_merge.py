"""pmt wire format round-trips (≈ reference qa_Value/qa_ValueMap), CRC32C,
UncertainValue propagation, HistoryBuffer, merge API, user-function blocks."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import gnuradio4_tpu as gr
from gnuradio4_tpu.core import pmt
from gnuradio4_tpu.core.merge import merge
from gnuradio4_tpu.core.utils_crc import crc32c
from gnuradio4_tpu.utils import HistoryBuffer, UncertainValue
from gnuradio4_tpu.blocks.math import AddConst, MultiplyConst
from gnuradio4_tpu.blocks.filter import Decimator
from gnuradio4_tpu.blocks.python_block import HostBlock, LambdaBlock
from gnuradio4_tpu.blocks.testing import VectorSink, VectorSource


class TestCrc32c:
    def test_known_vectors(self):
        # RFC 3720 test vector: 32 zero bytes → 0x8A9136AA
        assert crc32c(b"\x00" * 32) == 0x8A9136AA
        assert crc32c(b"123456789") == 0xE3069283

    def test_incremental_vs_whole(self):
        data = b"hello gnuradio gpu world"
        assert crc32c(data) == crc32c(data[8:], crc32c(data[:8]))


class TestPmt:
    @pytest.mark.parametrize("value", [
        None, True, False, 42, -7, 3.14159, complex(1.5, -2.5), "hello",
        "unicode: ütf∞", b"\x00\x01\x02raw",
    ])
    def test_scalar_round_trip(self, value):
        packed = pmt.pack(value)
        out = pmt.unpack(packed)
        if isinstance(value, bytes):
            assert bytes(out.tobytes()) == value
        else:
            assert out == value

    def test_prefix_layout(self):
        packed = pmt.pack(7)
        assert len(packed) % 8 == 0
        total = int.from_bytes(packed[0:4], "little")
        assert total == len(packed)
        assert packed[4] == int(pmt.ValueType.INT64)
        assert packed[5] == int(pmt.ContainerType.SCALAR)
        assert packed[7] == 8  # payload offset

    @pytest.mark.parametrize("dtype", ["int16", "int32", "uint8", "float32",
                                       "float64", "complex64"])
    def test_vector_round_trip(self, dtype):
        arr = (np.arange(17) * 1.5).astype(dtype)
        out = pmt.unpack(pmt.pack(arr))
        np.testing.assert_array_equal(out, arr)
        assert out.dtype == arr.dtype

    def test_map_round_trip(self):
        m = {"sample_rate": 48000.0, "name": "chan0", "count": 7,
             "taps": np.array([1.0, 2.0, 3.0], np.float32),
             "nested": {"flag": True, "ctx": "FAIR.SEL"}}
        out = pmt.unpack_map(pmt.pack_map(m))
        assert out["sample_rate"] == 48000.0
        assert out["name"] == "chan0"
        assert out["count"] == 7
        np.testing.assert_array_equal(out["taps"], m["taps"])
        assert out["nested"] == {"flag": True, "ctx": "FAIR.SEL"}

    def test_crc_protects_payload(self):
        packed = bytearray(pmt.pack({"k": 123}, crc=True))
        assert pmt.unpack(bytes(packed)) == {"k": 123}
        # flip one payload bit → CRC must catch it
        packed[20] ^= 0x01
        with pytest.raises(gr.GrError):
            pmt.unpack(bytes(packed))

    def test_concatenated_stream_scan(self):
        """Elements are self-delimiting: a blob of N elements can be scanned."""
        blob = pmt.pack(1) + pmt.pack("two") + pmt.pack([3.0, 4.0])
        mv = memoryview(blob)
        vals = []
        off = 0
        while off < len(blob):
            v, off = pmt._unpack_one(mv, off)
            vals.append(v)
        assert vals[0] == 1 and vals[1] == "two"
        np.testing.assert_array_equal(vals[2], [3.0, 4.0])

    def test_truncated_rejected(self):
        packed = pmt.pack({"a": 1})
        with pytest.raises(gr.GrError):
            pmt.unpack(packed[: len(packed) // 2])


class TestUncertainValue:
    def test_add_propagation(self):
        a = UncertainValue(10.0, 3.0)
        b = UncertainValue(20.0, 4.0)
        c = a + b
        assert float(c.value) == 30.0
        np.testing.assert_allclose(float(c.uncertainty), 5.0)

    def test_mul_propagation(self):
        a = UncertainValue(10.0, 1.0)   # 10%
        b = UncertainValue(5.0, 0.5)    # 10%
        c = a * b
        np.testing.assert_allclose(float(c.value), 50.0)
        np.testing.assert_allclose(float(c.relative()), np.sqrt(2) * 0.1,
                                   rtol=1e-6)

    def test_flows_through_jit(self):
        @jax.jit
        def f(u: UncertainValue):
            return u * 2.0 + UncertainValue(1.0, 0.1)
        out = f(UncertainValue(jnp.asarray(3.0), jnp.asarray(0.3)))
        np.testing.assert_allclose(float(out.value), 7.0)
        np.testing.assert_allclose(float(out.uncertainty),
                                   np.hypot(0.6, 0.1), rtol=1e-6)


class TestHistoryBuffer:
    def test_newest_first_view(self):
        h = HistoryBuffer(8)
        h.push([1, 2, 3])
        np.testing.assert_array_equal(h.view(), [3, 2, 1])
        h.push([4, 5])
        np.testing.assert_array_equal(h.view(3), [5, 4, 3])

    def test_wrap_and_capacity(self):
        h = HistoryBuffer(8, newest_first=False)
        h.push(np.arange(20))
        assert len(h) == 8
        np.testing.assert_array_equal(h.view(), np.arange(12, 20))

    def test_contiguous_across_wrap(self):
        h = HistoryBuffer(8, newest_first=False)
        h.push(np.arange(6))
        h.push(np.arange(6, 10))
        v = h.view(8)
        np.testing.assert_array_equal(v, np.arange(2, 10))


class TestMerge:
    def test_merged_equals_chain(self):
        data = np.arange(256, dtype=np.float32)
        fused = merge(MultiplyConst(value=2.0), AddConst(value=1.0),
                      Decimator(decim=2))
        g = gr.Graph()
        src = VectorSource(data)
        snk = VectorSink()
        g.connect_chain(src, fused, snk)
        gr.Scheduler(g, block_len=128).run_and_wait()
        ref = (data * 2.0 + 1.0)[::2]
        np.testing.assert_allclose(snk.data(), ref)

    def test_merged_ratio(self):
        fused = merge(MultiplyConst(), Decimator(decim=4))
        from fractions import Fraction
        assert fused.ratio == Fraction(1, 4)


class TestUserBlocks:
    def test_lambda_block(self):
        g = gr.Graph()
        src = VectorSource(np.arange(64, dtype=np.float32))
        lb = LambdaBlock(lambda x: jnp.square(x))
        snk = VectorSink()
        g.connect_chain(src, lb, snk)
        gr.Scheduler(g, block_len=64).run_and_wait()
        np.testing.assert_allclose(snk.data(), np.arange(64.0) ** 2)

    def test_host_block_callback(self):
        calls = []
        def host_fn(x):
            calls.append(x.shape)
            return np.cumsum(x).astype(np.float32)
        g = gr.Graph()
        src = VectorSource(np.ones(128, np.float32))
        hb = HostBlock(host_fn)
        snk = VectorSink()
        g.connect_chain(src, hb, snk)
        gr.Scheduler(g, block_len=128).run_and_wait()
        np.testing.assert_allclose(snk.data(), np.arange(1, 129, dtype=np.float32))
        assert calls  # actually ran on host


class TestBenchmarkHarness:
    """utils/benchmark.py (≈ reference bench/benchmark.hpp)."""

    def test_benchmark_basic(self):
        from gnuradio4_tpu.utils.benchmark import benchmark
        acc = []
        r = benchmark(lambda: acc.append(1), n=1000, warmup=1, name="append")
        assert r.n_ops == 1000 and len(acc) >= 1000
        assert r.wall_s > 0 and r.ops_per_s > 0
        assert "append" in str(r) and "ops/s" in str(r)

    def test_benchmark_autocalibration(self):
        from gnuradio4_tpu.utils.benchmark import benchmark
        r = benchmark(lambda: sum(range(100)), min_time=0.05, name="sum")
        assert r.wall_s >= 0.02  # calibrated into the ballpark

    def test_counters_graceful_when_unavailable(self):
        from gnuradio4_tpu.utils.benchmark import PerfCounters, benchmark
        pc = PerfCounters()
        try:
            r = benchmark(lambda: None, n=100)
            if pc.available:   # real PMU: counters must be populated + sane
                assert r.counters.get("cycles", 0) > 0
                assert r.ipc is None or r.ipc > 0
            else:              # VM without PMU: clean empty-dict degradation
                assert r.counters == {}
                assert r.cycles_per_op is None and r.ipc is None
        finally:
            pc.close()

    def test_marker_map(self):
        import time
        from gnuradio4_tpu.utils.benchmark import MarkerMap
        mm = MarkerMap()
        mm.mark("a"); time.sleep(0.01); mm.mark("b"); mm.mark("c")
        iv = dict(mm.intervals())
        assert iv["a→b"] >= 0.009 and iv["b→c"] < 0.01
        assert mm.total_s() >= 0.009
        mm.clear()
        assert mm.intervals() == [] and mm.total_s() == 0.0


class TestPmtViewsAndSI:
    """Round-2 pmt depth: zero-copy MapView, element scanning, SI annotations."""

    def test_mapview_lazy_zero_copy(self):
        from gnuradio4_tpu.core import pmt
        vec = np.arange(1024, dtype=np.float32)
        blob = pmt.pack({"rate": 48000.0, "data": vec,
                         "meta": {"name": "ch0", "idx": 7}})
        view = pmt.MapView(blob)
        assert set(view.keys()) == {"rate", "data", "meta"}
        assert view["rate"] == 48000.0
        arr = view["data"]
        np.testing.assert_array_equal(arr, vec)
        # zero copy: the array aliases the packed buffer
        assert not arr.flags.owndata
        sub = view["meta"]
        assert isinstance(sub, pmt.MapView)
        assert sub["name"] == "ch0" and sub["idx"] == 7
        assert view.get("missing", 42) == 42
        assert "rate" in view and "missing" not in view
        assert view.to_dict()["meta"]["idx"] == 7

    def test_scan_elements(self):
        from gnuradio4_tpu.core import pmt
        blob = pmt.pack("hello") + pmt.pack(3.5) + pmt.pack({"k": 1})
        kinds = [(vt, ct) for _, _, vt, ct in pmt.scan(blob)]
        assert kinds == [
            (pmt.ValueType.STRING, pmt.ContainerType.STRING),
            (pmt.ValueType.FLOAT64, pmt.ContainerType.SCALAR),
            (pmt.ValueType.MAP, pmt.ContainerType.MAP),
        ]

    def test_si_annotation_roundtrip(self):
        from gnuradio4_tpu.core import pmt
        blob = pmt.pack({"f": pmt.SIValue(100e6, "Hz"),
                         "taps": pmt.SIValue(np.ones(4, np.float32), "V"),
                         "name": pmt.SIValue("probe", "")})
        out = pmt.unpack(blob)
        assert out["f"] == pmt.SIValue(100e6, "Hz")
        assert out["f"].unit == "Hz"
        assert out["taps"].unit == "V"
        np.testing.assert_array_equal(out["taps"].value, np.ones(4))
        # SI + CRC together
        blob2 = pmt.pack(pmt.SIValue(3.3, "V"), crc=True)
        v2 = pmt.unpack(blob2)
        assert v2 == pmt.SIValue(3.3, "V")

    def test_si_on_map_rejected(self):
        import pytest as _pytest
        from gnuradio4_tpu.core import pmt
        with _pytest.raises(gr.GrError):
            pmt.pack(pmt.SIValue({"a": 1}, "Hz"))
