"""Bluetooth Low Energy advertising-channel link layer (LE 1M uncoded PHY).

Beyond-reference model family (gr-bluetooth / btlejack equivalent): BLE
advertising PDUs ride GFSK at 1 Msym/s, modulation index 0.5, BT = 0.5.
An advertising packet is

    preamble (0xAA, 8 bits) | access address 0x8E89BED6 (32 bits) |
    PDU header (2 bytes) + payload (<= 37 bytes) + CRC-24  -- all whitened

Every field is transmitted LSB-first.  Whitening is the 7-bit LFSR
x^7 + x^4 + 1 seeded from the channel index (Core spec Vol 6 Part B
section 3.2, fig 3.5); the CRC is the 24-bit LFSR x^24 + x^10 + x^9 +
x^6 + x^4 + x^3 + x + 1 with init 0x555555 on advertising channels
(section 3.1.1, fig 3.4).  Advertising channels are 37 (2402 MHz),
38 (2426 MHz), 39 (2480 MHz).

Device/host split (the receiver-family pattern, see blocks/ais.py /
pocsag.py): waveform synthesis is a vectorized Gaussian-shaped
phase-integration timeline (:func:`gfsk_modulate`); the receiver consumes
an FM-discriminator stream (``QuadratureDemod`` output) in the
:class:`BleDecoder` sink — DPLL bit clock, access-address hunt with a
small Hamming budget, de-whitening, CRC gate, AD-structure parse — and
accumulates decoded ``packets``.

Reference parity anchor: the reference ships no BLE blocks; this extends
the receiver set on machinery validated by the blocks/filter and
blocks/basic qa mirrors (QuadratureDemod front end, host sink decoders).
"""

from __future__ import annotations

import numpy as np

from ..core.block import Port, SinkBlock, SourceBlock
from ..core.registry import register_block
from ..core.settings import Setting
from .ax25 import demod_bits

ADV_ACCESS_ADDRESS = 0x8E89BED6
CRC_INIT_ADV = 0x555555
_CRC_POLY = 0x00065B            # x^10+x^9+x^6+x^4+x^3+x+1 (x^24 implicit)
ADV_CHANNELS = (37, 38, 39)

PDU_TYPES = {0: "ADV_IND", 1: "ADV_DIRECT_IND", 2: "ADV_NONCONN_IND",
             3: "SCAN_REQ", 4: "SCAN_RSP", 5: "CONNECT_IND",
             6: "ADV_SCAN_IND"}

AD_FLAGS = 0x01
AD_SHORT_NAME = 0x08
AD_COMPLETE_NAME = 0x09
AD_MANUFACTURER = 0xFF


# ---------------------------------------------------------------- CRC-24

def crc24(data: bytes | np.ndarray, init: int = CRC_INIT_ADV) -> int:
    """BLE CRC-24 over ``data`` (bits taken LSB-first per byte, the on-air
    order).  Galois form of the Core spec fig 3.4 LFSR: feedback =
    input xor register MSB, taps 0x00065B."""
    state = init & 0xFFFFFF
    for byte in bytes(data):
        for i in range(8):
            fb = ((byte >> i) & 1) ^ ((state >> 23) & 1)
            state = (state << 1) & 0xFFFFFF
            if fb:
                state ^= _CRC_POLY
    return state


def crc24_bits(data: bytes, init: int = CRC_INIT_ADV) -> np.ndarray:
    """The 24 on-air CRC bits (most significant register position first,
    Core spec section 3.1.1: 'transmitted most significant bit first')."""
    c = crc24(data, init)
    return np.asarray([(c >> (23 - k)) & 1 for k in range(24)], np.uint8)


# -------------------------------------------------------------- whitening

def whitening_sequence(n: int, channel: int) -> np.ndarray:
    """First ``n`` whitening bits for ``channel`` — 7-bit LFSR x^7+x^4+1,
    position 0 seeded 1, positions 1..6 the channel index MSB-first
    (Core spec fig 3.5)."""
    p = [1] + [(channel >> (5 - k)) & 1 for k in range(6)]
    out = np.empty(n, np.uint8)
    for i in range(n):
        o = p[6]
        out[i] = o
        p = [o, p[0], p[1], p[2], p[3] ^ o, p[4], p[5]]
    return out


def whiten_bits(bits: np.ndarray, channel: int) -> np.ndarray:
    """XOR the whitening sequence onto ``bits`` (involution — the same call
    de-whitens).  Whitening starts at the first PDU header bit."""
    bits = np.asarray(bits, np.uint8)
    return bits ^ whitening_sequence(len(bits), channel)


# ------------------------------------------------------------- packet build

def _bytes_to_bits_lsb(data: bytes) -> np.ndarray:
    b = np.frombuffer(bytes(data), np.uint8)
    return ((b[:, None] >> np.arange(8)) & 1).astype(np.uint8).reshape(-1)


def _bits_to_bytes_lsb(bits: np.ndarray) -> bytes:
    bits = np.asarray(bits, np.uint8)[: len(bits) // 8 * 8].reshape(-1, 8)
    return bytes((bits << np.arange(8)).sum(axis=1).astype(np.uint8))


def build_ad_structures(*, flags: int | None = 0x06,
                        name: str | None = None,
                        manufacturer: bytes | None = None) -> bytes:
    """Assemble AdvData AD structures (length | type | data each)."""
    out = bytearray()
    if flags is not None:
        out += bytes([2, AD_FLAGS, flags & 0xFF])
    if name is not None:
        nb = name.encode()
        out += bytes([1 + len(nb), AD_COMPLETE_NAME]) + nb
    if manufacturer is not None:
        out += bytes([1 + len(manufacturer), AD_MANUFACTURER]) + manufacturer
    return bytes(out)


def parse_ad_structures(data: bytes) -> list[tuple[int, bytes]]:
    """AdvData → [(ad_type, ad_data), ...]; stops at a zero/overrun length."""
    out: list[tuple[int, bytes]] = []
    i = 0
    while i < len(data):
        ln = data[i]
        if ln == 0 or i + 1 + ln > len(data):
            break
        out.append((data[i + 1], bytes(data[i + 2:i + 1 + ln])))
        i += 1 + ln
    return out


def encode_advertising(adv_addr: bytes, adv_data: bytes, *,
                       channel: int = 37, pdu_type: int = 0,
                       tx_add: int = 0) -> np.ndarray:
    """On-air bit stream for one advertising PDU on ``channel``:
    preamble + access address + whitened (header | AdvA | AdvData | CRC)."""
    if len(adv_addr) != 6:
        raise ValueError("adv_addr must be 6 bytes (little-endian on air)")
    payload = bytes(adv_addr) + bytes(adv_data)
    if len(payload) > 37:
        raise ValueError("advertising payload exceeds 37 bytes")
    header = bytes([(pdu_type & 0xF) | ((tx_add & 1) << 6), len(payload)])
    pdu = header + payload
    body = np.concatenate([_bytes_to_bits_lsb(pdu), crc24_bits(pdu)])
    preamble = np.asarray([0, 1] * 4, np.uint8)        # 0xAA LSB-first
    aa = np.asarray([(ADV_ACCESS_ADDRESS >> k) & 1 for k in range(32)],
                    np.uint8)
    return np.concatenate([preamble, aa, whiten_bits(body, channel)])


def gfsk_modulate(bits: np.ndarray, *, fs: float = 8e6, baud: float = 1e6,
                  bt: float = 0.5, h: float = 0.5,
                  amplitude: float = 1.0) -> np.ndarray:
    """GFSK baseband IQ: bits → ±1 → Gaussian pulse (BT) → phase integration
    at modulation index ``h`` (peak deviation h·baud/2 = ±250 kHz)."""
    levels = np.asarray(bits, np.uint8).astype(np.float64) * 2 - 1
    sps = fs / baud
    n_total = int(round(len(levels) * sps))
    idx = np.minimum((np.arange(n_total) / sps).astype(np.int64),
                     len(levels) - 1)
    x = levels[idx]
    sigma = np.sqrt(np.log(2.0)) / (2.0 * np.pi * bt * baud) * fs
    half = int(np.ceil(4 * sigma))
    t = np.arange(-half, half + 1)
    g = np.exp(-0.5 * (t / sigma) ** 2)
    g /= g.sum()
    shaped = np.convolve(x, g, mode="same")
    freq = (h * baud / 2.0) * shaped
    phase = 2.0 * np.pi * np.cumsum(freq) / fs
    return (amplitude * np.exp(1j * phase)).astype(np.complex64)


def ble_modulate(adv_addr: bytes, adv_data: bytes, *, fs: float = 8e6,
                 channel: int = 37, pdu_type: int = 0, tx_add: int = 0,
                 **kw) -> np.ndarray:
    """Complete advertising transmission as baseband IQ (test stimulus /
    :class:`BleSource`)."""
    bits = encode_advertising(adv_addr, adv_data, channel=channel,
                              pdu_type=pdu_type, tx_add=tx_add)
    return gfsk_modulate(bits, fs=fs, **kw)


# ---------------------------------------------------------------- decode

_AA_BITS = np.asarray([(ADV_ACCESS_ADDRESS >> k) & 1 for k in range(32)],
                      np.int8)


def decode_bits(bits: np.ndarray, *, channel: int = 37,
                max_aa_errors: int = 2) -> list[dict]:
    """Hunt advertising PDUs in a recovered bit stream: access-address
    correlation (Hamming distance <= ``max_aa_errors``), de-whiten, CRC
    gate, header/AdvA/AD parse.  Both discriminator polarities are tried
    by the caller via the slicer sign; here bits are taken as-is."""
    bits = np.asarray(bits, np.int8)
    n = len(bits)
    packets: list[dict] = []
    if n < 32 + 16 + 24:
        return packets
    # sliding Hamming distance against the 32-bit AA, all offsets at once
    windows = np.lib.stride_tricks.sliding_window_view(bits, 32)
    dist = (windows != _AA_BITS[None, :]).sum(axis=1)
    hits = np.flatnonzero(dist <= max_aa_errors)
    last_end = -1
    for pos in hits:
        if pos < last_end:
            continue                    # inside the previous packet
        start = pos + 32
        if start + 16 > n:
            break
        head = whiten_bits(bits[start:start + 16].astype(np.uint8), channel)
        hdr = _bits_to_bytes_lsb(head)
        length = hdr[1]
        total = 16 + 8 * length + 24
        if length > 37 or start + total > n:
            continue
        body = whiten_bits(bits[start:start + total].astype(np.uint8),
                           channel)
        pdu = _bits_to_bytes_lsb(body[:16 + 8 * length])
        crc_ok = bool(np.array_equal(body[16 + 8 * length:total],
                                     crc24_bits(pdu)))
        if not crc_ok:
            continue
        payload = pdu[2:]
        pkt: dict = {"pdu_type": PDU_TYPES.get(pdu[0] & 0xF,
                                               f"RFU_{pdu[0] & 0xF}"),
                     "length": length, "crc_ok": True, "channel": channel,
                     "bit_offset": int(pos)}
        if length >= 6:
            pkt["adv_addr"] = ":".join(f"{b:02X}"
                                       for b in payload[5::-1])
            ads = parse_ad_structures(payload[6:])
            pkt["ad"] = ads
            for t, d in ads:
                if t in (AD_COMPLETE_NAME, AD_SHORT_NAME):
                    pkt["name"] = d.decode(errors="replace")
                elif t == AD_FLAGS and d:
                    pkt["flags"] = d[0]
        packets.append(pkt)
        last_end = pos + 32 + total
    return packets


def ble_demod_bits(disc: np.ndarray, sps: float) -> np.ndarray:
    """Bit decisions from a raw FM-discriminator stream: ~3/4-bit boxcar
    (the Gaussian pulse spans most of the bit) then the shared DPLL slicer
    (blocks/ax25.demod_bits) — same recipe as blocks/ais.ais_demod_bits."""
    disc = np.asarray(disc, np.float64)
    m = max(int(round(sps * 0.75)), 1)
    smooth = np.convolve(disc, np.ones(m) / m, mode="same")
    return demod_bits(smooth, sps)


# ---------------------------------------------------------------- blocks

@register_block("BleSource")
class BleSource(SourceBlock):
    """Transmit-side stimulus: plays GFSK advertising transmissions for a
    list of advertisers with silence gaps, optionally cyclic (the BLE twin
    of AisSource).  Each advertiser dict: ``{"adv_addr": bytes, "name":
    str, "flags": int, "manufacturer": bytes, "pdu_type": int}``."""

    OUT = (Port("out", dtype="complex64"),)
    FEED = True
    sample_rate = Setting(default=8e6, kind="static")
    channel = Setting(default=37, kind="static", choices=(37, 38, 39))
    gap_s = Setting(default=200e-6, kind="static",
                    description="silence between transmissions")
    repeat = Setting(default=False, kind="static")

    def __init__(self, advertisers: list[dict] = (), name=None, **settings):
        super().__init__(name=name, **settings)
        fs = float(self.settings.get("sample_rate"))
        ch = int(self.settings.get("channel"))
        gap = np.zeros(int(float(self.settings.get("gap_s")) * fs),
                       np.complex64)
        parts: list[np.ndarray] = [gap]
        for adv in advertisers:
            addr = adv["adv_addr"]
            if isinstance(addr, str):            # YAML convenience: AA:BB:…
                addr = bytes(int(b, 16)
                             for b in reversed(addr.split(":")))
            data = build_ad_structures(
                flags=adv.get("flags", 0x06), name=adv.get("name"),
                manufacturer=adv.get("manufacturer"))
            parts.append(ble_modulate(addr, data, fs=fs,
                                      channel=ch,
                                      pdu_type=adv.get("pdu_type", 0)))
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


@register_block("BleDecoder")
class BleDecoder(SinkBlock):
    """BLE advertising scanner sink for an FM-discriminator stream
    (``QuadratureDemod`` output at ``sps`` samples per microsecond-bit).
    Accumulates decoded ``packets``; ``devices`` maps adv_addr → the
    latest packet.  Incremental with a bounded history, like the other
    receiver-family sinks."""

    IN = (Port("in", dtype="float32"),)
    sps = Setting(default=8.0, kind="static",
                  description="discriminator samples per 1 Mbps bit")
    channel = Setting(default=37, kind="static", choices=(37, 38, 39))
    max_buffer_s = Setting(default=2.0, kind="static")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._buf = np.zeros(0, np.float64)
        self._pending = 0
        self._base = 0                  # absolute sample index of _buf[0]
        self._seen_bits: set[int] = set()
        self.packets: list[dict] = []
        self.devices: dict[str, dict] = {}

    def consume(self, arrays, tags, n_valid, abs_index):
        if n_valid <= 0:
            return
        x = np.real(np.asarray(arrays["in"][..., :n_valid]))
        self._buf = np.concatenate([self._buf,
                                    x.reshape(-1).astype(np.float64)])
        self._pending += n_valid
        if self._pending >= 65536:
            self._pending = 0
            self._process()

    def stop(self):
        self._process()

    def _process(self) -> None:
        if not len(self._buf):
            return
        sps = float(self.settings.get("sps"))
        ch = int(self.settings.get("channel"))
        bits = ble_demod_bits(self._buf, sps)
        base_bits = int(round(self._base / sps))
        for pkt in decode_bits(np.asarray(bits), channel=ch):
            abs_bit = base_bits + int(pkt.get("bit_offset", 0))
            if abs_bit in self._seen_bits:
                continue            # re-found inside the retained tail
            self._seen_bits.add(abs_bit)
            pkt["bit_offset"] = abs_bit
            self.packets.append(pkt)
            if "adv_addr" in pkt:
                self.devices[pkt["adv_addr"]] = pkt
        cap = int(float(self.settings.get("max_buffer_s")) * sps * 1e6)
        if len(self._buf) > cap:
            # retain one max-packet window (512 bits covers the longest
            # legacy adv PDU + margin) across the trim, a whole number of
            # bit periods so demod alignment is preserved — a packet
            # spanning the trim instant now decodes on the next pass
            # (ADVICE r2: the old reset-to-empty lost it); duplicates from
            # the overlap dedupe on absolute bit offset above
            keep = int(512 * sps)
            keep -= keep % max(int(sps), 1)
            self._base += len(self._buf) - keep
            self._buf = self._buf[-keep:]
