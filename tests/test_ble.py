"""BLE advertising link layer: CRC-24 / whitening primitives, bit-level
codec roundtrip, GFSK RF loop, and the full flowgraph
(BleSource → QuadratureDemod → BleDecoder) through the real Scheduler."""

import numpy as np
import pytest

import gnuradio4_tpu as gr
from gnuradio4_tpu.blocks.ble import (ADV_ACCESS_ADDRESS, build_ad_structures,
                                      ble_demod_bits, ble_modulate, crc24,
                                      crc24_bits, decode_bits,
                                      encode_advertising, gfsk_modulate,
                                      parse_ad_structures, whiten_bits,
                                      whitening_sequence)

FS = 8e6
SPS = 8.0
ADDR = bytes([0x12, 0x34, 0x56, 0x78, 0x9A, 0xBC])   # little-endian on air


class TestPrimitives:
    def test_crc_detects_single_bit_errors(self):
        pdu = bytes([0x00, 0x08]) + ADDR + bytes([2, 0x01, 0x06])
        good = crc24(pdu)
        for byte_i in range(len(pdu)):
            for bit_i in range(8):
                bad = bytearray(pdu)
                bad[byte_i] ^= 1 << bit_i
                assert crc24(bytes(bad)) != good

    def test_crc_bits_shape_and_determinism(self):
        b = crc24_bits(b"\x42\x10\xff")
        assert b.shape == (24,) and set(np.unique(b)) <= {0, 1}
        assert np.array_equal(b, crc24_bits(b"\x42\x10\xff"))

    def test_whitening_involution_and_channel_dependence(self):
        rng = np.random.default_rng(7)
        bits = rng.integers(0, 2, 300).astype(np.uint8)
        for ch in (37, 38, 39):
            assert np.array_equal(whiten_bits(whiten_bits(bits, ch), ch),
                                  bits)
        seqs = {ch: whitening_sequence(64, ch).tobytes()
                for ch in (37, 38, 39)}
        assert len(set(seqs.values())) == 3
        # period of the maximal-length 7-bit LFSR is 127
        s = whitening_sequence(254, 37)
        assert np.array_equal(s[:127], s[127:])
        assert s[:127].sum() == 64                   # 64 ones, 63 zeros

    def test_ad_structures_roundtrip(self):
        data = build_ad_structures(flags=0x06, name="GR4",
                                   manufacturer=b"\x4c\x00\x02")
        ads = parse_ad_structures(data)
        assert (0x01, b"\x06") in ads
        assert (0x09, b"GR4") in ads
        assert (0xFF, b"\x4c\x00\x02") in ads
        # malformed tail is ignored, prefix survives
        assert parse_ad_structures(data + b"\x09\x01")[:3] == ads


class TestBitCodec:
    def test_encode_decode_roundtrip(self):
        data = build_ad_structures(flags=0x05, name="GR4-GPU")
        bits = encode_advertising(ADDR, data, channel=38)
        # preamble 0xAA LSB-first then the AA LSB-first
        assert list(bits[:8]) == [0, 1, 0, 1, 0, 1, 0, 1]
        aa = sum(int(b) << k for k, b in enumerate(bits[8:40]))
        assert aa == ADV_ACCESS_ADDRESS
        pkts = decode_bits(bits, channel=38)
        assert len(pkts) == 1
        p = pkts[0]
        assert p["crc_ok"] and p["pdu_type"] == "ADV_IND"
        assert p["name"] == "GR4-GPU" and p["flags"] == 0x05
        assert p["adv_addr"] == "BC:9A:78:56:34:12"

    def test_wrong_channel_whitening_rejected(self):
        bits = encode_advertising(ADDR, build_ad_structures(name="X"),
                                  channel=37)
        assert decode_bits(bits, channel=39) == []

    def test_crc_corruption_rejected(self):
        bits = encode_advertising(ADDR, build_ad_structures(name="X"),
                                  channel=37)
        bits[60] ^= 1                                # a whitened PDU bit
        assert decode_bits(bits, channel=37) == []

    def test_aa_bit_error_budget(self):
        bits = encode_advertising(ADDR, build_ad_structures(name="Y"),
                                  channel=37)
        bits[10] ^= 1                                # error inside the AA
        bits[20] ^= 1
        pkts = decode_bits(bits, channel=37)
        assert len(pkts) == 1 and pkts[0]["name"] == "Y"

    def test_payload_length_guard(self):
        with pytest.raises(ValueError):
            encode_advertising(ADDR, bytes(32))      # 6 + 32 > 37
        with pytest.raises(ValueError):
            encode_advertising(b"\x01", b"")


class TestRfLoop:
    def test_gfsk_loop_with_noise_and_offset(self):
        data = build_ad_structures(flags=0x06, name="NOISY")
        iq = ble_modulate(ADDR, data, fs=FS, channel=37)
        iq = np.concatenate([np.zeros(777, np.complex64), iq,
                             np.zeros(500, np.complex64)])
        rng = np.random.default_rng(3)
        iq = iq + 0.05 * (rng.standard_normal(len(iq))
                          + 1j * rng.standard_normal(len(iq))
                          ).astype(np.complex64)     # ≈ 23 dB SNR
        disc = np.angle(iq[1:] * np.conj(iq[:-1]))
        pkts = decode_bits(np.asarray(ble_demod_bits(disc, SPS)), channel=37)
        assert len(pkts) == 1 and pkts[0]["name"] == "NOISY"

    def test_gfsk_constant_envelope(self):
        iq = gfsk_modulate(np.array([1, 0, 1, 1, 0, 0, 1, 0] * 8), fs=FS)
        assert np.allclose(np.abs(iq), 1.0, atol=1e-5)


class TestGraphChain:
    @pytest.mark.parametrize("block_len", [8192, 3000])
    def test_two_advertisers_through_scheduler(self, block_len):
        advertisers = [
            {"adv_addr": ADDR, "name": "GR4-GPU", "flags": 0x06},
            {"adv_addr": bytes(range(6)), "name": "BEACON-2",
             "pdu_type": 2, "manufacturer": b"\x4c\x00"},
        ]
        g = gr.Graph()
        src = g.emplace("BleSource", advertisers=advertisers,
                        sample_rate=FS, channel=37)
        demod = g.emplace("QuadratureDemod", gain=1.0)
        dec = g.emplace("BleDecoder", sps=SPS, channel=37)
        g.connect_chain(src, demod, dec)
        gr.Scheduler(g, block_len=block_len, sample_rate=FS).run_and_wait()
        assert len(dec.packets) == 2, dec.packets
        names = {p.get("name") for p in dec.packets}
        assert names == {"GR4-GPU", "BEACON-2"}
        by_name = {p["name"]: p for p in dec.packets}
        assert by_name["GR4-GPU"]["adv_addr"] == "BC:9A:78:56:34:12"
        assert by_name["GR4-GPU"]["pdu_type"] == "ADV_IND"
        assert by_name["BEACON-2"]["pdu_type"] == "ADV_NONCONN_IND"
        assert (0xFF, b"\x4c\x00") in by_name["BEACON-2"]["ad"]
        assert dec.devices["05:04:03:02:01:00"]["name"] == "BEACON-2"
