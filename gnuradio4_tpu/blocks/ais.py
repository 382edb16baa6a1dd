"""Maritime AIS (Automatic Identification System, ITU-R M.1371) model family.

The VHF Data Link: GMSK (9600 baud, BT≈0.4, modulation index 0.5) on
161.975/162.025 MHz, NRZI encoding, HDLC framing with X.25 FCS — the link
layer is shared with AX.25 (blocks/ax25.py), so the bit-stuffing, NRZI, FCS
and DPLL machinery is reused verbatim. On top rides the 168-bit Class-A
position report (message types 1-3): MMSI, navigation status, rate of turn,
SOG, position in 1/10000 arc-minutes, COG, heading, timestamp.

Device/host split (the same shape as the RDS/ADS-B/AX.25 families): waveform
synthesis and the FM discriminator run as device math (GMSK synthesis here,
QuadratureDemod in-graph); bit-clock recovery, HDLC deframing and bitfield
decode are O(bits) host work inside the :class:`AisDecoder` sink.

Field layout cross-checked against the published AIVDM/AIVDO worked example
(`!AIVDM,1,1,,B,177KQJ5000G?tO`K>RA1wUbN0TKH,0*5C` — the GPSd protocol
documentation's canonical type-1 decode) in tests/test_ais.py.
"""

from __future__ import annotations

import numpy as np

from ..core.block import Port, SinkBlock, SourceBlock
from ..core.registry import register_block
from ..core.settings import Setting
from .ax25 import (crc16_x25, deframe, demod_bits, hdlc_bits, nrzi_decode,
                   nrzi_encode)

# -- bit packing ---------------------------------------------------------------


def bits_to_bytes(bits: np.ndarray) -> bytes:
    """Pack MSB-first (ITU-R M.1371 byte assembly; HDLC then sends each byte
    LSB-first — blocks/ax25.hdlc_bits)."""
    bits = np.asarray(bits, np.uint8)
    if len(bits) % 8:
        bits = np.concatenate([bits, np.zeros(8 - len(bits) % 8, np.uint8)])
    out = bytearray()
    for i in range(0, len(bits), 8):
        byte = 0
        for j in range(8):
            byte = (byte << 1) | int(bits[i + j])
        out.append(byte)
    return bytes(out)


def bytes_to_bits(data: bytes) -> np.ndarray:
    out = np.zeros(len(data) * 8, np.uint8)
    for i, byte in enumerate(data):
        for j in range(8):
            out[i * 8 + j] = (byte >> (7 - j)) & 1
    return out


def sixbit_decode(armored: str) -> np.ndarray:
    """NMEA AIVDM payload armoring → bit vector (6 bits per char, MSB first;
    char−48, minus another 8 above 40 — the AIVDM de-armoring rule)."""
    bits: list[int] = []
    for c in armored:
        v = ord(c) - 48
        if v > 40:
            v -= 8
        bits += [(v >> (5 - j)) & 1 for j in range(6)]
    return np.asarray(bits, np.uint8)


def sixbit_encode(bits: np.ndarray) -> str:
    """Bit vector → NMEA armoring (inverse of :func:`sixbit_decode`)."""
    bits = np.asarray(bits, np.uint8)
    if len(bits) % 6:
        bits = np.concatenate([bits, np.zeros(6 - len(bits) % 6, np.uint8)])
    out = []
    for i in range(0, len(bits), 6):
        v = 0
        for j in range(6):
            v = (v << 1) | int(bits[i + j])
        out.append(chr(v + 48 if v < 40 else v + 56))
    return "".join(out)


# -- message type 1-3: Class-A position report (168 bits) -----------------------

def _put(bits, pos, width, value):
    v = int(value) & ((1 << width) - 1)
    for j in range(width):
        bits[pos + j] = (v >> (width - 1 - j)) & 1


def _get(bits, pos, width, *, signed=False) -> int:
    v = 0
    for j in range(width):
        v = (v << 1) | int(bits[pos + j])
    if signed and (v >> (width - 1)) & 1:
        v -= 1 << width
    return v


def build_position_report(*, mmsi: int, lat: float, lon: float,
                          sog_kn: float = 0.0, cog_deg: float = 0.0,
                          heading_deg: int = 511, nav_status: int = 0,
                          msg_type: int = 1, timestamp: int = 60,
                          rot: int = -128, repeat: int = 0) -> np.ndarray:
    """168-bit type 1/2/3 position report (ITU-R M.1371 table 45)."""
    bits = np.zeros(168, np.uint8)
    _put(bits, 0, 6, msg_type)
    _put(bits, 6, 2, repeat)
    _put(bits, 8, 30, mmsi)
    _put(bits, 38, 4, nav_status)
    _put(bits, 42, 8, rot)
    _put(bits, 50, 10, round(sog_kn * 10))
    _put(bits, 60, 1, 0)                       # position accuracy
    _put(bits, 61, 28, round(lon * 600000.0))  # 1/10000 arc-minute
    _put(bits, 89, 27, round(lat * 600000.0))
    _put(bits, 116, 12, round(cog_deg * 10))
    _put(bits, 128, 9, heading_deg)
    _put(bits, 137, 6, timestamp)
    # maneuver(2) + spare(3) + RAIM(1) + radio status(19) stay zero
    return bits


def parse_position_report(bits: np.ndarray) -> dict | None:
    """Decode a 168-bit type 1/2/3 report; None for other types/short frames."""
    bits = np.asarray(bits, np.uint8)
    if len(bits) < 168:
        return None
    msg_type = _get(bits, 0, 6)
    if msg_type not in (1, 2, 3):
        return None
    return {
        "type": msg_type,
        "repeat": _get(bits, 6, 2),
        "mmsi": _get(bits, 8, 30),
        "nav_status": _get(bits, 38, 4),
        "rot": _get(bits, 42, 8, signed=True),
        "sog_kn": _get(bits, 50, 10) / 10.0,
        "accuracy": _get(bits, 60, 1),
        "lon": _get(bits, 61, 28, signed=True) / 600000.0,
        "lat": _get(bits, 89, 27, signed=True) / 600000.0,
        "cog_deg": _get(bits, 116, 12) / 10.0,
        "heading_deg": _get(bits, 128, 9),
        "timestamp": _get(bits, 137, 6),
    }


# -- VDL physical layer ----------------------------------------------------------

def ais_frame_bits(msg_bits: np.ndarray, *, training_bits: int = 24
                   ) -> np.ndarray:
    """On-air bit stream for one AIS transmission: alternating training
    sequence, HDLC flag, zero-stuffed payload+FCS, closing flag
    (ITU-R M.1371 §3.2.2; the HDLC body reuses blocks/ax25.hdlc_bits)."""
    payload = bits_to_bytes(msg_bits)
    body = hdlc_bits(payload, preamble_flags=1, tail_flags=1)
    training = np.tile(np.asarray([0, 1], np.uint8), training_bits // 2)
    return np.concatenate([training, body])


def gmsk_modulate(bits: np.ndarray, *, fs: float = 96000.0,
                  baud: float = 9600.0, bt: float = 0.4,
                  amplitude: float = 1.0) -> np.ndarray:
    """GMSK baseband IQ for an on-air bit stream: NRZI → ±1 levels →
    Gaussian pulse shaping (BT) → phase integration at modulation index 0.5
    (peak deviation baud/4)."""
    levels = nrzi_encode(np.asarray(bits, np.uint8)).astype(np.float64) * 2 - 1
    sps = fs / baud
    n_total = int(round(len(levels) * sps))
    idx = np.minimum((np.arange(n_total) / sps).astype(np.int64),
                     len(levels) - 1)
    x = levels[idx]
    # Gaussian filter: sigma from BT (B = bt*baud; sigma_t = sqrt(ln2)/(2πB))
    sigma = np.sqrt(np.log(2.0)) / (2.0 * np.pi * bt * baud) * fs
    half = int(np.ceil(4 * sigma))
    t = np.arange(-half, half + 1)
    g = np.exp(-0.5 * (t / sigma) ** 2)
    g /= g.sum()
    shaped = np.convolve(x, g, mode="same")
    freq = (baud / 4.0) * shaped               # modulation index 0.5
    phase = 2.0 * np.pi * np.cumsum(freq) / fs
    return (amplitude * np.exp(1j * phase)).astype(np.complex64)


def ais_modulate(msg_bits: np.ndarray, *, fs: float = 96000.0,
                 baud: float = 9600.0, **kw) -> np.ndarray:
    """Complete transmission: frame + GMSK (test stimulus / AisSource)."""
    return gmsk_modulate(ais_frame_bits(msg_bits), fs=fs, baud=baud, **kw)


def ais_demod_bits(disc: np.ndarray, sps: float) -> np.ndarray:
    """Bit decisions from a raw FM-discriminator stream: a ~¾-bit boxcar
    matched-ish filter first (the GMSK pulse spans most of the bit — the raw
    per-sample discriminator is far too noisy to slice directly, unlike the
    AX.25 dual-tone correlator which already integrates over the bit), then
    the shared DPLL slicer (blocks/ax25.demod_bits)."""
    disc = np.asarray(disc, np.float64)
    m = max(int(round(sps * 0.75)), 1)
    smooth = np.convolve(disc, np.ones(m) / m, mode="same")
    return demod_bits(smooth, sps)


@register_block("AisDecoder")
class AisDecoder(SinkBlock):
    """AIS receiver sink for an FM-discriminator stream (QuadratureDemod
    output): DPLL bit clock at 9600 baud, NRZI + HDLC deframe (FCS-gated),
    type 1-3 position decode. ``vessels`` maps MMSI → the latest report;
    ``packets`` lists every decoded report in order. Incremental with a
    bounded history, like the other receiver sinks."""

    IN = (Port("in", dtype="float32"),)
    sps = Setting(default=10.0, kind="static",
                  description="discriminator samples per 9600-baud bit")
    max_buffer_s = Setting(default=60.0, kind="static")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._buf = np.zeros(0, np.float64)
        self._n_seen = 0
        self._pending = 0
        self.packets: list[dict] = []
        self.vessels: dict[int, dict] = {}

    def consume(self, arrays, tags, n_valid, abs_index):
        if n_valid <= 0:
            return
        x = np.real(np.asarray(arrays["in"][..., :n_valid]))
        self._buf = np.concatenate([self._buf,
                                    x.reshape(-1).astype(np.float64)])
        self._pending += n_valid
        if self._pending >= 4096:
            self._pending = 0
            self._process()

    def stop(self):
        self._process()

    def _process(self) -> None:
        if not len(self._buf):
            return
        tones = ais_demod_bits(self._buf, float(self.settings.get("sps")))
        frames = deframe(nrzi_decode(tones))
        for f in frames[self._n_seen:]:
            rpt = parse_position_report(bytes_to_bits(f))
            if rpt is not None:
                self.packets.append(rpt)
                self.vessels[rpt["mmsi"]] = rpt
        self._n_seen = len(frames)
        cap = int(float(self.settings.get("max_buffer_s"))
                  * float(self.settings.get("sps")) * 9600.0)
        if len(self._buf) > cap:
            self._buf = self._buf[-cap // 2:]
            tail = ais_demod_bits(self._buf, float(self.settings.get("sps")))
            self._n_seen = len(deframe(nrzi_decode(tail)))


@register_block("AisSource")
class AisSource(SourceBlock):
    """Transmit-side stimulus: plays GMSK transmissions for a list of vessel
    position reports with silence gaps, cyclically (the AIS twin of
    RdsSource). ``reports`` is a list of dicts accepted by
    :func:`build_position_report`."""

    OUT = (Port("out", dtype="complex64"),)
    FEED = True
    sample_rate = Setting(default=96000.0, kind="static")
    baud = Setting(default=9600.0, kind="static")
    gap_s = Setting(default=0.01, kind="static",
                    description="silence between transmissions")
    repeat = Setting(default=False, kind="static")

    def __init__(self, reports: list[dict] = (), name=None, **settings):
        super().__init__(name=name, **settings)
        fs = float(self.settings.get("sample_rate"))
        baud = float(self.settings.get("baud"))
        gap = np.zeros(int(float(self.settings.get("gap_s")) * fs),
                       np.complex64)
        parts: list[np.ndarray] = [gap]
        for rpt in reports:
            parts.append(ais_modulate(build_position_report(**rpt),
                                      fs=fs, baud=baud))
            parts.append(gap)
        self._wave = (np.concatenate(parts) if parts
                      else np.zeros(0, np.complex64))

    def host_feed(self, n, abs_index):
        total = len(self._wave)
        if not total:
            return None
        if self.settings.get("repeat"):
            idx = np.arange(abs_index, abs_index + n) % total
            return {"out": self._wave[idx]}, n
        if abs_index >= total:
            return None
        chunk = self._wave[abs_index:abs_index + n]
        return {"out": chunk}, len(chunk)

    def apply(self, state, ins, ctx):
        return state, {"out": ins["out"]}
