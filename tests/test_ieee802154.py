"""IEEE 802.15.4 O-QPSK family: FCS/chip-table primitives, waveform
properties, RF loop under noise/phase offset, chip-error resilience, and
the full flowgraph (Ieee802154Source → Ieee802154Decoder) through the
real Scheduler."""

import numpy as np
import pytest

import gnuradio4_tpu as gr
from gnuradio4_tpu.blocks.ieee802154 import (build_data_frame, append_fcs,
                                             bytes_to_symbols, check_fcs,
                                             chip_table, crc16_kermit,
                                             decode_stream, frame_symbols,
                                             ieee802154_modulate,
                                             oqpsk_modulate,
                                             parse_mac_header,
                                             symbols_to_bytes)

SPS = 4


class TestPrimitives:
    def test_crc16_kermit_check_vector(self):
        # the published CRC-16/KERMIT check value
        assert crc16_kermit(b"123456789") == 0x2189

    def test_fcs_roundtrip_and_rejection(self):
        psdu = append_fcs(b"\x01\x02\x03hello")
        assert check_fcs(psdu)
        bad = bytearray(psdu)
        bad[2] ^= 0x10
        assert not check_fcs(bytes(bad))
        assert not check_fcs(b"\x00")           # too short

    def test_chip_table_structure(self):
        tab = chip_table()
        assert tab.shape == (16, 32)
        # all sequences distinct, pairwise distance >= 12 (DSSS margin)
        d = (tab[:, None, :] != tab[None, :, :]).sum(axis=2)
        off = d[~np.eye(16, dtype=bool)]
        assert off.min() >= 12
        # symbols 8-15 are 0-7 with odd chips complemented
        flip = np.zeros(32, np.uint8)
        flip[1::2] = 1
        assert np.array_equal(tab[8:], tab[:8] ^ flip)
        # symbols 1-7 are 4-chip cyclic shifts of symbol 0
        for k in range(1, 8):
            assert np.array_equal(tab[k], np.roll(tab[0], 4 * k))

    def test_nibble_order(self):
        syms = bytes_to_symbols(b"\xa7")
        assert list(syms) == [0x7, 0xA]          # low nibble first
        assert symbols_to_bytes(syms) == b"\xa7"

    def test_frame_symbols_guard(self):
        with pytest.raises(ValueError):
            frame_symbols(b"\x00")               # < 2 bytes
        with pytest.raises(ValueError):
            frame_symbols(bytes(128))


class TestWaveform:
    def test_near_constant_envelope(self):
        # MSK-equivalent: away from the ramp-in/out the envelope is flat
        sps = 8
        iq = oqpsk_modulate(np.arange(16, dtype=np.uint8), sps=sps)
        env = np.abs(iq[2 * sps:-(4 * sps)])     # skip the ramp-in/out
        assert env.min() > 0.6 and env.max() < 1.2

    def test_clean_loop_exact(self):
        psdu = build_data_frame(b"ZIGBEE-GPU", seq=7, dst_addr=0x1234,
                                src_addr=0x00AB)
        iq = ieee802154_modulate(psdu, sps=SPS)
        frames = decode_stream(iq, sps=SPS)
        assert len(frames) == 1
        f = frames[0]
        assert f["fcs_ok"] and f["chip_errors"] == 0
        assert f["frame_type"] == "data" and f["seq"] == 7
        assert f["dst_addr"] == 0x1234 and f["src_addr"] == 0x00AB
        assert f["payload"] == b"ZIGBEE-GPU"

    def test_loop_with_noise_phase_and_padding(self):
        psdu = build_data_frame(b"NOISY", seq=1)
        iq = ieee802154_modulate(psdu, sps=SPS)
        iq = np.concatenate([np.zeros(333, np.complex64), iq,
                             np.zeros(200, np.complex64)])
        iq = iq * np.exp(1j * 1.1)               # constant carrier phase
        rng = np.random.default_rng(5)
        iq = iq + 0.15 * (rng.standard_normal(len(iq))
                          + 1j * rng.standard_normal(len(iq))
                          ).astype(np.complex64)  # ≈ 13 dB SNR
        frames = decode_stream(iq, sps=SPS)
        assert len(frames) == 1 and frames[0]["payload"] == b"NOISY"

    def test_chip_error_resilience_via_dsss(self):
        # flip raw chips by negating short sample spans: DSSS margin absorbs
        psdu = build_data_frame(b"ROBUST", seq=2)
        iq = ieee802154_modulate(psdu, sps=SPS).copy()
        body_start = 12 * 32 * SPS               # past SHR+PHR
        for k in range(0, 20):
            s = body_start + k * 97 * SPS
            iq[s:s + SPS] = -iq[s:s + SPS]
        frames = decode_stream(iq, sps=SPS)
        assert len(frames) == 1 and frames[0]["payload"] == b"ROBUST"
        assert frames[0]["chip_errors"] > 0

    def test_corrupted_fcs_rejected(self):
        psdu = bytearray(append_fcs(build_data_frame(b"BAD")))
        psdu[4] ^= 0xFF
        iq = oqpsk_modulate(frame_symbols(bytes(psdu)), sps=SPS)
        assert decode_stream(iq, sps=SPS) == []

    def test_mac_parse_non_intra_pan(self):
        fcf = 0x8801                             # data, both 16-bit, no intra
        psdu = bytes([fcf & 0xFF, fcf >> 8, 9,
                      0xCD, 0xAB, 0x34, 0x12,    # dst pan+addr
                      0xEF, 0xBE, 0x78, 0x56])   # src pan+addr
        h = parse_mac_header(append_fcs(psdu + b"PP"))
        assert h["dst_pan"] == 0xABCD and h["dst_addr"] == 0x1234
        assert h["src_pan"] == 0xBEEF and h["src_addr"] == 0x5678
        assert h["payload"] == b"PP"


class TestGraphChain:
    @pytest.mark.parametrize("block_len", [8192, 3000])
    def test_two_frames_through_scheduler(self, block_len):
        frames = [
            {"payload": b"HELLO-PAN", "seq": 1, "src_addr": 0x0001},
            {"payload": b"SECOND", "seq": 2, "src_addr": 0x0002,
             "dst_addr": 0x00FE},
        ]
        g = gr.Graph()
        src = g.emplace("Ieee802154Source", frames=frames, sps=SPS)
        dec = g.emplace("Ieee802154Decoder", sps=SPS)
        g.connect_chain(src, dec)
        fs = SPS * 2_000_000.0
        gr.Scheduler(g, block_len=block_len, sample_rate=fs).run_and_wait()
        assert len(dec.frames) == 2, dec.frames
        assert [f["seq"] for f in dec.frames] == [1, 2]
        assert dec.frames[0]["payload"] == b"HELLO-PAN"
        assert dec.frames[1]["payload"] == b"SECOND"
        assert dec.frames[1]["dst_addr"] == 0x00FE
        assert all(f["fcs_ok"] for f in dec.frames)
