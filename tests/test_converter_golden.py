"""Golden mirror of the reference's qa_Converter.cpp
(blocks/basic/test/qa_Converter.cpp:38-270): the Convert/ScalingConvert cast
matrix (up- and down-conversion across the arithmetic types), complex
decompositions (Abs/Real/Imag/Arg), rad↔deg, complex↔{real,imag},
complex↔{magnitude,phase}, and complex↔interleaved roundtrips."""

import numpy as np
import pytest

import gnuradio4_tpu as gr
from gnuradio4_tpu.blocks.testing import VectorSink, VectorSource

# the reference's [u]int64/double instantiations have no device-native stream
# dtype (no f64/i64 on the device path; jax x64 stays off) — the framework's
# documented stance is that double-typed reference flowgraphs run as float32
ARITH = ["uint8", "uint16", "uint32", "int8", "int16", "int32", "float32"]


def run_chain(data, *blocks, block_len=None):
    g = gr.Graph()
    src = VectorSource(np.asarray(data))
    snk = VectorSink()
    g.connect_chain(src, *[g.emplace(b, **kw) for b, kw in blocks], snk)
    gr.Scheduler(g, block_len=block_len or len(data)).run_and_wait()
    return snk.data()


def run_two_out(data, block, out_ports, **kw):
    g = gr.Graph()
    b = g.emplace(block, **kw)
    g.connect(VectorSource(np.asarray(data)), b)
    sinks = [VectorSink() for _ in out_ports]
    for p, s in zip(out_ports, sinks):
        g.connect(b, s, src_port=p)
    gr.Scheduler(g, block_len=len(data)).run_and_wait()
    return [s.data() for s in sinks]


class TestConvertMatrix:
    @pytest.mark.parametrize("to", ARITH)
    def test_up_convert_uint8(self, to):
        # ≈ cpp:54: Convert<uint8, R>(42) == R(42)
        y = run_chain(np.full(8, 42, np.uint8), ("Convert", {"to": to}))
        assert y.dtype == np.dtype(to)
        assert np.all(y == 42)

    @pytest.mark.parametrize("to", ARITH)
    def test_down_convert_float(self, to):
        # ≈ cpp:78: Convert<float, R>(21) == R(21)
        y = run_chain(np.full(8, 21.0, np.float32), ("Convert", {"to": to}))
        assert y.dtype == np.dtype(to)
        assert np.all(y == 21)

    @pytest.mark.parametrize("to", ARITH)
    def test_scaling_convert(self, to):
        # ≈ cpp:78 kIsScalingBlock: ScalingConvert<float, R>(42, scale=.5)
        y = run_chain(np.full(8, 42.0, np.float32),
                      ("ScalingConvert", {"to": to, "scale": 0.5}))
        assert y.dtype == np.dtype(to)
        assert np.all(y == 21)


class TestComplexDecompositions:
    DATA = np.asarray([3 + 4j, -1 + 0j, 0 - 2j, 1 + 1j], np.complex64)

    def test_abs(self):
        # ≈ cpp:126 std::abs
        y = run_chain(self.DATA, ("Abs", {}))
        np.testing.assert_allclose(y, np.abs(self.DATA), rtol=1e-6)

    def test_abs_real_input(self):
        y = run_chain(np.asarray([-3.0, 2.0, -1.5], np.float32), ("Abs", {}))
        np.testing.assert_array_equal(y, [3.0, 2.0, 1.5])

    def test_real_imag_arg(self):
        # ≈ cpp:141/156/171
        np.testing.assert_allclose(run_chain(self.DATA, ("ComplexToReal", {})),
                                   self.DATA.real)
        np.testing.assert_allclose(run_chain(self.DATA, ("ComplexToImag", {})),
                                   self.DATA.imag)
        np.testing.assert_allclose(run_chain(self.DATA, ("Arg", {})),
                                   np.angle(self.DATA), rtol=1e-6)

    def test_rad_deg_roundtrip(self):
        # ≈ cpp:186 "rad <-> deg"
        x = np.asarray([0.0, np.pi / 4, np.pi / 2, np.pi, -np.pi / 3],
                       np.float32)
        deg = run_chain(x, ("RadToDeg", {}))
        np.testing.assert_allclose(deg, [0, 45, 90, 180, -60], atol=1e-4)
        back = run_chain(deg.astype(np.float32), ("DegToRad", {}))
        np.testing.assert_allclose(back, x, atol=1e-6)

    def test_complex_real_imag_roundtrip(self):
        # ≈ cpp:208 "complex <-> {real, imag}"
        re, im = run_two_out(self.DATA, "ToRealImag", ["real", "imag"])
        np.testing.assert_allclose(re, self.DATA.real)
        np.testing.assert_allclose(im, self.DATA.imag)
        g = gr.Graph()
        b = g.emplace("RealImagToComplex")
        g.connect(VectorSource(re.astype(np.float32)), b, dst_port="real")
        g.connect(VectorSource(im.astype(np.float32)), b, dst_port="imag")
        snk = VectorSink()
        g.connect(b, snk)
        gr.Scheduler(g, block_len=len(re)).run_and_wait()
        np.testing.assert_allclose(snk.data(), self.DATA, rtol=1e-6)

    def test_complex_mag_phase_roundtrip(self):
        # ≈ cpp:225 "complex <-> {magnitude, phase}"
        mag, ph = run_two_out(self.DATA, "ComplexToMagPhase", ["mag", "phase"])
        np.testing.assert_allclose(mag, np.abs(self.DATA), rtol=1e-6)
        np.testing.assert_allclose(ph, np.angle(self.DATA), rtol=1e-6)
        g = gr.Graph()
        b = g.emplace("MagPhaseToComplex")
        g.connect(VectorSource(mag.astype(np.float32)), b, dst_port="mag")
        g.connect(VectorSource(ph.astype(np.float32)), b, dst_port="phase")
        snk = VectorSink()
        g.connect(b, snk)
        gr.Scheduler(g, block_len=len(mag)).run_and_wait()
        np.testing.assert_allclose(snk.data(), self.DATA, rtol=1e-5,
                                   atol=1e-6)

    def test_complex_interleaved_roundtrip(self):
        # ≈ cpp:242 "complex <-> interleaved" (2:1 rate change both ways)
        inter = run_chain(self.DATA, ("ComplexToInterleaved", {}))
        np.testing.assert_allclose(
            inter, np.column_stack([self.DATA.real,
                                    self.DATA.imag]).ravel())
        back = run_chain(inter.astype(np.float32),
                         ("InterleavedToComplex", {}))
        np.testing.assert_allclose(back, self.DATA)
