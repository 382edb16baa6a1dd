"""ADS-B / Mode S decoder (blocks/adsb.py — beyond-reference model family)."""

import numpy as np
import pytest

import gnuradio4_tpu as gr
from gnuradio4_tpu.blocks import adsb


class TestModeSCoding:
    def test_crc_of_valid_frame_is_zero(self):
        f = adsb.make_df17_identification(0xABCDEF, "GR4GPU01")
        assert len(f) == 112
        assert adsb.crc24(f) == 0

    def test_single_bit_error_breaks_crc(self):
        f = adsb.make_df17_identification(0x4840D6, "KLM1023")
        for i in (0, 5, 31, 87, 111):
            g = f.copy()
            g[i] ^= 1
            assert adsb.crc24(g) != 0

    def test_callsign_roundtrip(self):
        for cs in ("KLM1023", "BAW38K", "N123AB", "A"):
            f = adsb.make_df17_identification(0x123456, cs)
            recs = adsb.decode_bits_stream(adsb.modulate([f]))
            assert len(recs) == 1
            assert recs[0]["callsign"] == cs
            assert recs[0]["icao"] == 0x123456 and recs[0]["df"] == 17

    def test_decode_under_noise(self):
        rng = np.random.default_rng(0)
        frames = [adsb.make_df17_identification(0x100000 + k, f"AC{k:05d}")
                  for k in range(5)]
        wave = adsb.modulate(frames)
        noisy = wave + 0.05 * rng.standard_normal(len(wave))
        recs = adsb.decode_bits_stream(noisy)
        assert len(recs) == 5
        assert [r["callsign"] for r in recs] == [f"AC{k:05d}" for k in range(5)]


class TestAdsbGraphChain:
    def test_iq_stream_to_aircraft_table(self):
        """Complex IQ at 2 Msps (random carrier phase) → |·| → AdsbDecoder,
        frames split across scheduler steps; no duplicates, all aircraft."""
        rng = np.random.default_rng(1)
        frames = [adsb.make_df17_identification(0xABC000 + k, f"GPU{k:04d}")
                  for k in range(8)]
        wave = adsb.modulate(frames, gap_us=137.5)   # frames straddle steps
        phase = np.cumsum(rng.normal(0.0, 0.3, len(wave)))
        iq = (wave * np.exp(1j * phase)).astype(np.complex64)
        iq += (0.02 * (rng.standard_normal(len(iq))
                       + 1j * rng.standard_normal(len(iq)))).astype(np.complex64)

        g = gr.Graph()
        src = g.emplace("VectorSource", data=iq)
        mag = g.emplace("Abs")
        dec = g.emplace("AdsbDecoder", threshold=0.3)
        g.connect_chain(src, mag, dec)
        gr.Scheduler(g, block_len=1000, sample_rate=2e6).run_and_wait()

        assert len(dec.frames) == 8, [f.get("callsign") for f in dec.frames]
        assert {i: a["callsign"] for i, a in dec.aircraft.items()} \
            == {0xABC000 + k: f"GPU{k:04d}" for k in range(8)}


class TestAdsbPosition:
    # published worked example ("the 1090 MHz riddle" / mode-s.org):
    # ICAO 40621D at (52.2572, 3.91937), 38000 ft
    EVEN = "8D40621D58C382D690C8AC2863A7"
    ODD = "8D40621D58C386435CC412692AD6"

    def test_published_vector_pair(self):
        ev, od = adsb.hex_to_bits(self.EVEN), adsb.hex_to_bits(self.ODD)
        assert adsb.crc24(ev) == 0 and adsb.crc24(od) == 0
        pe, po = adsb.parse_position_fields(ev), adsb.parse_position_fields(od)
        assert not pe["odd"] and po["odd"]
        assert pe["alt_ft"] == 38000 and po["alt_ft"] == 38000
        lat, lon = adsb.cpr_decode(pe["lat_cpr"], pe["lon_cpr"],
                                   po["lat_cpr"], po["lon_cpr"])
        assert abs(lat - 52.2572) < 1e-3 and abs(lon - 3.91937) < 1e-3

    def test_encode_decode_roundtrip(self):
        for lat, lon, alt in [(52.2572, 3.91937, 38000),
                              (-33.9461, 151.1772, 2500),
                              (37.6188, -122.3756, 12775)]:
            fe = adsb.make_df17_airborne_position(0x111111, lat, lon, alt,
                                                  odd=False)
            fo = adsb.make_df17_airborne_position(0x111111, lat, lon, alt,
                                                  odd=True)
            assert adsb.crc24(fe) == 0 and adsb.crc24(fo) == 0
            pe = adsb.parse_position_fields(fe)
            po = adsb.parse_position_fields(fo)
            assert pe["alt_ft"] == alt
            glat, glon = adsb.cpr_decode(pe["lat_cpr"], pe["lon_cpr"],
                                         po["lat_cpr"], po["lon_cpr"])
            assert abs(glat - lat) < 1e-3 and abs(glon - lon) < 1e-3

    def test_graph_chain_builds_aircraft_picture(self):
        """Identification + even/odd position squitters through the IQ chain
        → complete per-aircraft picture (callsign, position, altitude)."""
        rng = np.random.default_rng(2)
        frames = [
            adsb.make_df17_identification(0x40621D, "KLM1023"),
            adsb.make_df17_airborne_position(0x40621D, 52.2572, 3.91937,
                                             38000, odd=False),
            adsb.make_df17_airborne_position(0x40621D, 52.2572, 3.91937,
                                             38000, odd=True),
        ]
        wave = adsb.modulate(frames)
        iq = (wave * np.exp(1j * np.cumsum(rng.normal(0, 0.25, len(wave))))
              ).astype(np.complex64)
        g = gr.Graph()
        src = g.emplace("VectorSource", data=iq)
        mag = g.emplace("Abs")
        dec = g.emplace("AdsbDecoder")
        g.connect_chain(src, mag, dec)
        gr.Scheduler(g, block_len=700, sample_rate=2e6).run_and_wait()
        ac = dec.aircraft[0x40621D]
        assert ac["callsign"] == "KLM1023"
        assert ac["alt_ft"] == 38000
        assert abs(ac["lat"] - 52.2572) < 1e-3
        assert abs(ac["lon"] - 3.91937) < 1e-3
