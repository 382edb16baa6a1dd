"""POCSAG paging with BCH(31,21) ECC (blocks/pocsag.py — beyond-reference)."""

import numpy as np
import pytest

import gnuradio4_tpu as gr
from gnuradio4_tpu.blocks import pocsag


class TestBch:
    def test_valid_codeword_zero_syndrome(self):
        for data in (0x00000, 0x12345, 0x1FFFFF, 0x0F0F0):
            cw = pocsag.encode_codeword(data)
            assert pocsag.correct_codeword(cw) == (data & 0x1FFFFF, 0)

    def test_corrects_all_one_and_two_bit_errors(self):
        cw = pocsag.encode_codeword(0x12345)
        rng = np.random.default_rng(0)
        for _ in range(300):
            k = int(rng.integers(1, 3))
            pos = rng.choice(31, size=k, replace=False)
            w = cw
            for e in pos:
                w ^= 1 << (int(e) + 1)          # above the parity bit
            data, nerr = pocsag.correct_codeword(w)
            assert data == 0x12345 and nerr == k

    def test_three_bit_errors_detected_or_miscorrected_not_silent(self):
        # beyond the guarantee: decoder must not return the original data
        # claiming zero corrections
        cw = pocsag.encode_codeword(0x12345)
        w = cw ^ (1 << 5) ^ (1 << 9) ^ (1 << 20)
        out = pocsag.correct_codeword(w)
        assert out is None or out != (0x12345, 0)


class TestTransmission:
    def test_loopback(self):
        bits = pocsag.encode_transmission(1234567, 2, "GR4-GPU PAGING OK")
        pages = pocsag.decode_transmission(bits)
        assert len(pages) == 1
        assert pages[0]["ric"] == 1234567
        assert pages[0]["function"] == 2
        assert pages[0]["message"] == "GR4-GPU PAGING OK"

    def test_two_bit_errors_per_codeword_still_decode(self):
        rng = np.random.default_rng(1)
        bits = pocsag.encode_transmission(99, 0, "ECC WORKS")
        noisy = bits.copy()
        for start in range(576, len(noisy) - 32, 32):
            for e in rng.choice(31, size=2, replace=False):
                noisy[start + int(e)] ^= 1
        pages = pocsag.decode_transmission(noisy)
        assert pages and pages[0]["message"] == "ECC WORKS"
        assert pages[0]["corrected_bits"] > 0

    def test_frame_position_carries_ric_lsbs(self):
        for ric in (8, 13, 1048575):
            bits = pocsag.encode_transmission(ric, 1, "X")
            pages = pocsag.decode_transmission(bits)
            assert pages and pages[0]["ric"] == ric


class TestPocsagGraphChain:
    def test_fsk_chain_decodes_page(self):
        """NRZ FSK (±4.5 kHz at 1200 bps, 38.4 ksps) → QuadratureDemod →
        PocsagDecoder, with AWGN."""
        rng = np.random.default_rng(2)
        bits = pocsag.encode_transmission(423133, 3, "CALL THE GPU ROOM")
        sps, dev = 32, 4500.0
        fs = 1200.0 * sps
        # POCSAG convention: bit 0 = +deviation (high), bit 1 = −deviation
        freq = np.repeat(np.where(bits == 0, dev, -dev), sps)
        phase = 2 * np.pi * np.cumsum(freq) / fs
        iq = np.exp(1j * phase).astype(np.complex64)
        iq += (0.05 * (rng.standard_normal(len(iq))
                       + 1j * rng.standard_normal(len(iq)))).astype(np.complex64)

        g = gr.Graph()
        src = g.emplace("VectorSource", data=iq)
        qd = g.emplace("QuadratureDemod", gain=fs / (2 * np.pi * dev))
        dec = g.emplace("PocsagDecoder", sps=float(sps), invert=True)
        g.connect_chain(src, qd, dec)
        gr.Scheduler(g, block_len=4800, sample_rate=fs).run_and_wait()

        assert len(dec.pages) == 1, dec.pages
        assert dec.pages[0]["ric"] == 423133
        assert dec.pages[0]["function"] == 3
        assert dec.pages[0]["message"] == "CALL THE GPU ROOM"
