"""AX.25 / APRS (blocks/ax25.py — beyond-reference model family)."""

import numpy as np
import pytest

import gnuradio4_tpu as gr
from gnuradio4_tpu.blocks import ax25


class TestAx25Coding:
    def test_fcs_known_answer(self):
        # X.25 FCS of "123456789" is the published 0x906E check value
        assert ax25.crc16_x25(b"123456789") == 0x906E

    def test_address_encoding(self):
        frame = ax25.build_ui_frame("APRS", "N0CALL", "hi", src_ssid=9)
        # callsigns ride shifted-ASCII with SSID + last-bit in byte 7
        assert frame[0] == ord("A") << 1
        p = ax25.parse_frame(frame)
        assert p["dest"] == ("APRS", 0) and p["src"] == ("N0CALL", 9)
        assert p["control"] == 0x03 and p["pid"] == 0xF0
        assert p["info"] == "hi"

    def test_hdlc_bit_stuffing_roundtrip(self):
        # 0xFF bytes force maximal stuffing
        payload = ax25.build_ui_frame("TEST", "CALL", "\x7f\x7f~~~~")
        bits = ax25.hdlc_bits(payload)
        frames = ax25.deframe(bits)
        assert frames == [payload]

    def test_corrupted_fcs_rejected(self):
        payload = ax25.build_ui_frame("TEST", "CALL", "hello")
        bits = ax25.hdlc_bits(payload)
        # flip a payload bit inside the frame body
        bits2 = bits.copy()
        bits2[16 * 8 + 30] ^= 1
        assert ax25.deframe(bits2) == []

    def test_nrzi_roundtrip(self):
        rng = np.random.default_rng(0)
        bits = rng.integers(0, 2, 200).astype(np.uint8)
        np.testing.assert_array_equal(
            ax25.nrzi_decode(ax25.nrzi_encode(bits))[1:], bits[1:])


class TestAfskModem:
    FRAME = ax25.build_ui_frame("APRS", "N0CALL",
                                "!4903.50N/07201.75W-Test GR4 GPU",
                                path=["WIDE1"], src_ssid=9)

    @pytest.mark.parametrize("noise", [0.0, 0.2, 0.4])
    def test_host_loopback(self, noise):
        rng = np.random.default_rng(1)
        wave = ax25.afsk_modulate(self.FRAME, fs=48000.0)
        wave = wave + noise * rng.standard_normal(len(wave)).astype(np.float32)
        disc = ax25.afsk_discriminate(wave)
        tones = ax25.demod_bits(disc, 40.0)
        pkts = [p for f in ax25.deframe(ax25.nrzi_decode(tones))
                if (p := ax25.parse_frame(f))]
        assert len(pkts) == 1
        assert pkts[0]["src"] == ("N0CALL", 9)
        assert pkts[0]["path"] == [("WIDE1", 0)]
        assert pkts[0]["info"].endswith("GR4 GPU")

    def test_graph_chain_dual_tone_correlator(self):
        """The Bell-202 detector expressed as a flowgraph: two FreqXlatingFir
        branches (one-bit boxcars at 1200/2200 Hz) → Abs → Subtract →
        Ax25Decoder; two packets back-to-back through scheduler chunking."""
        rng = np.random.default_rng(2)
        f2 = ax25.build_ui_frame("APRS", "W1AW", ">APRS test via GPU")
        wave = np.concatenate([
            ax25.afsk_modulate(self.FRAME, fs=48000.0),
            np.zeros(4800, np.float32),
            ax25.afsk_modulate(f2, fs=48000.0)])
        wave = wave + 0.15 * rng.standard_normal(len(wave)).astype(np.float32)

        boxcar = tuple((np.ones(40) / 40.0).tolist())
        g = gr.Graph()
        src = g.emplace("VectorSource", data=wave)
        cvt = g.emplace("Convert", to="complex64")
        mark = g.emplace("FreqXlatingFir", center_freq=1200.0, decim=4,
                         taps=boxcar)
        space = g.emplace("FreqXlatingFir", center_freq=2200.0, decim=4,
                          taps=boxcar)
        amark, aspace = g.emplace("Abs"), g.emplace("Abs")
        sub = g.emplace("Subtract")
        dec = g.emplace("Ax25Decoder", sps=10.0)
        g.connect(src, cvt)
        g.connect(cvt["out"], mark["in"])
        g.connect(cvt["out"], space["in"])
        g.connect(mark["out"], amark["in"])
        g.connect(space["out"], aspace["in"])
        g.connect(amark["out"], sub["in0"])
        g.connect(aspace["out"], sub["in1"])
        g.connect(sub, dec)
        gr.Scheduler(g, block_len=4800, sample_rate=48000.0).run_and_wait()

        assert len(dec.packets) == 2, dec.packets
        assert dec.packets[0]["src"] == ("N0CALL", 9)
        assert dec.packets[0]["info"].endswith("GR4 GPU")
        assert dec.packets[1]["src"] == ("W1AW", 0)
        assert dec.packets[1]["info"] == ">APRS test via GPU"


class TestDeframeEdgeCases:
    def test_closing_flag_at_exact_buffer_end(self):
        payload = ax25.build_ui_frame("TEST", "CALL", "edge")
        bits = ax25.hdlc_bits(payload, tail_flags=1)
        assert ax25.deframe(bits) == [payload]     # last 8 bits ARE the flag
