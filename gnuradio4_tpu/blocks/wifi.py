"""IEEE 802.11a/g OFDM PHY (20 MHz, 6–54 Mbps) — gr-ieee802-11 equivalent.

Beyond-reference model family: the classic OFDM WLAN physical layer.
64-point FFT, 48 data + 4 pilot subcarriers, 16-sample cyclic prefix;
PLCP preamble = 10 short training symbols (STF) + 2 long training symbols
(LTF, 32-sample guard); SIGNAL field (BPSK, rate 1/2, never scrambled)
carries RATE + LENGTH; DATA symbols are scrambled (x^7 + x^4 + 1),
convolutionally encoded (K=7, g0=0o133/g1=0o171, punctured to 2/3 or
3/4), block-interleaved per symbol and Gray-mapped to BPSK/QPSK/16/64-QAM
(IEEE 802.11-2012 clause 18).

Device/host split (the receiver-family pattern, blocks/ieee802154.py):
synthesis is a vectorized frequency-domain assembly + IFFT timeline; the
:class:`WifiDecoder` sink consumes complex baseband at 20 Msps, finds the
LTF by cross-correlation, estimates CFO from the LTF repetition and the
channel from the known LTF spectrum, equalizes + pilot-tracks every
symbol, and runs deinterleave → depuncture (erasure-aware soft Viterbi)
→ descramble → PSDU with an FCS (CRC-32) gate.

The stream Viterbi machinery lives in blocks/fec.py (device lax.scan);
this module uses a terminated soft-decision NumPy twin for framed decode
(frames end in 6 tail zeros, so termination is exact).
"""

from __future__ import annotations

import binascii

import numpy as np

from ..core.block import Port, SinkBlock, SourceBlock
from ..core.registry import register_block
from ..core.settings import Setting
from .fec import _tables

N_FFT = 64
N_CP = 16
N_DATA = 48
PILOT_CARRIERS = (-21, -7, 7, 21)
PILOT_VALUES = np.asarray([1.0, 1.0, 1.0, -1.0])

# clause 18.3.5.10: rate-dependent parameters, keyed by Mbps
RATES = {
    6:  dict(bits=0b1101, mod="bpsk",  nbpsc=1, ncbps=48,  ndbps=24,  punct="1/2"),
    9:  dict(bits=0b1111, mod="bpsk",  nbpsc=1, ncbps=48,  ndbps=36,  punct="3/4"),
    12: dict(bits=0b0101, mod="qpsk",  nbpsc=2, ncbps=96,  ndbps=48,  punct="1/2"),
    18: dict(bits=0b0111, mod="qpsk",  nbpsc=2, ncbps=96,  ndbps=72,  punct="3/4"),
    24: dict(bits=0b1001, mod="qam16", nbpsc=4, ncbps=192, ndbps=96,  punct="1/2"),
    36: dict(bits=0b1011, mod="qam16", nbpsc=4, ncbps=192, ndbps=144, punct="3/4"),
    48: dict(bits=0b0001, mod="qam64", nbpsc=6, ncbps=288, ndbps=192, punct="2/3"),
    54: dict(bits=0b0011, mod="qam64", nbpsc=6, ncbps=288, ndbps=216, punct="3/4"),
}
_RATE_BY_BITS = {v["bits"]: r for r, v in RATES.items()}

# clause 18.3.3: LTF frequency sequence for subcarriers −26..26 (0 at DC)
LTF_FREQ = np.asarray(
    [1, 1, -1, -1, 1, 1, -1, 1, -1, 1, 1, 1, 1, 1, 1, -1, -1, 1, 1, -1,
     1, -1, 1, 1, 1, 1,
     0,
     1, -1, -1, 1, 1, -1, 1, -1, 1, -1, -1, -1, -1, -1, 1, 1, -1, -1, 1,
     -1, 1, -1, 1, 1, 1, 1], np.float64)

# clause 18.3.3: STF frequency sequence (sqrt(13/6) scaling), −26..26
_S = 1.0 + 1.0j
STF_FREQ = np.sqrt(13.0 / 6.0) * np.asarray(
    [0, 0, _S, 0, 0, 0, -_S, 0, 0, 0, _S, 0, 0, 0, -_S, 0, 0, 0, -_S, 0,
     0, 0, _S, 0, 0, 0,
     0,
     0, 0, 0, -_S, 0, 0, 0, -_S, 0, 0, 0, _S, 0, 0, 0, _S, 0, 0, 0, _S,
     0, 0, 0, _S, 0, 0], np.complex128)

_K_MOD = {"bpsk": 1.0, "qpsk": 1 / np.sqrt(2.0),
          "qam16": 1 / np.sqrt(10.0), "qam64": 1 / np.sqrt(42.0)}
# Gray level maps per clause 18.3.5.8, indexed by the axis bit value:
# (b0 b1) 00→−3 01→−1 11→+1 10→+3, and the 3-bit analogue
# 000→−7 001→−5 011→−3 010→−1 110→+1 111→+3 101→+5 100→+7
_GRAY_AXIS = {1: np.asarray([-1.0, 1.0]),
              2: np.asarray([-3.0, -1.0, 3.0, 1.0]),
              3: np.asarray([-7.0, -5.0, -1.0, -3.0, 7.0, 5.0, 1.0, 3.0])}


def data_carrier_indices() -> np.ndarray:
    """The 48 data subcarrier indices in −26..26 order (pilots/DC removed)."""
    idx = [k for k in range(-26, 27)
           if k != 0 and k not in PILOT_CARRIERS]
    return np.asarray(idx)


_DATA_IDX = data_carrier_indices()


# ---------------------------------------------------------- bit plumbing

def scramble_sequence(n: int, seed: int) -> np.ndarray:
    """n bits of the clause-18.3.5.5 x^7+x^4+1 scrambler from 7-bit seed."""
    s = [(seed >> k) & 1 for k in range(7)]          # s[0] newest
    out = np.empty(n, np.uint8)
    for i in range(n):
        fb = s[3] ^ s[6]
        out[i] = fb
        s = [fb] + s[:6]
    return out


def _conv_encode(bits: np.ndarray) -> np.ndarray:
    """Rate-1/2 K=7 encoder (g0=0o133 first — clause 18.3.5.6), state 0."""
    enc_out, _ = _tables(7, (0o133, 0o171))
    out = np.empty(2 * len(bits), np.uint8)
    s = 0
    for i, b in enumerate(np.asarray(bits, np.uint8)):
        out[2 * i:2 * i + 2] = enc_out[s, b]
        s = ((s << 1) | int(b)) & 0x3F
    return out


_PUNCT = {"1/2": np.asarray([1, 1], bool),
          "2/3": np.asarray([1, 1, 1, 0], bool),
          "3/4": np.asarray([1, 1, 1, 0, 0, 1], bool)}


def puncture(coded: np.ndarray, punct: str) -> np.ndarray:
    pat = _PUNCT[punct]
    keep = np.resize(pat, len(coded))
    return np.asarray(coded)[keep]


def depuncture(received: np.ndarray, punct: str) -> np.ndarray:
    """Re-insert punctured positions as 0.5 erasures (soft stream)."""
    pat = _PUNCT[punct]
    n_out = len(received) // pat.sum() * len(pat)
    out = np.full(n_out, 0.5, np.float64)
    keep = np.resize(pat, n_out)
    out[keep] = np.asarray(received, np.float64)
    return out


def interleave_map(ncbps: int, nbpsc: int) -> np.ndarray:
    """perm[k] = transmitted position of coded bit k (clause 18.3.5.7)."""
    s = max(nbpsc // 2, 1)
    k = np.arange(ncbps)
    i = (ncbps // 16) * (k % 16) + k // 16
    j = s * (i // s) + (i + ncbps - (16 * i // ncbps)) % s
    return j


def interleave(bits: np.ndarray, ncbps: int, nbpsc: int) -> np.ndarray:
    out = np.empty_like(np.asarray(bits))
    out[interleave_map(ncbps, nbpsc)] = np.asarray(bits)
    return out


def deinterleave(vals: np.ndarray, ncbps: int, nbpsc: int) -> np.ndarray:
    return np.asarray(vals)[interleave_map(ncbps, nbpsc)]


def map_symbols(bits: np.ndarray, mod: str) -> np.ndarray:
    """Interleaved bits → complex constellation points (Gray, K_mod)."""
    nbpsc = {"bpsk": 1, "qpsk": 2, "qam16": 4, "qam64": 6}[mod]
    b = np.asarray(bits, np.uint8).reshape(-1, nbpsc)
    if mod == "bpsk":
        return (b[:, 0] * 2.0 - 1.0).astype(np.complex128)
    half = nbpsc // 2
    pw = 1 << np.arange(half - 1, -1, -1)
    i_v = (b[:, :half] * pw).sum(axis=1)
    q_v = (b[:, half:] * pw).sum(axis=1)
    axis = _GRAY_AXIS[half]
    return _K_MOD[mod] * (axis[i_v] + 1j * axis[q_v])


def demap_soft(pts: np.ndarray, mod: str) -> np.ndarray:
    """Constellation points → per-bit soft values in [0,1] (1 = bit one),
    nearest-point hard decision softened by distance margin (max-log)."""
    nbpsc = {"bpsk": 1, "qpsk": 2, "qam16": 4, "qam64": 6}[mod]
    pts = np.asarray(pts) / _K_MOD[mod]
    if mod == "bpsk":
        return np.clip(np.real(pts) * 0.5 + 0.5, 0, 1)
    half = nbpsc // 2
    axis = _GRAY_AXIS[half]
    out = np.empty((len(pts), nbpsc))
    for comp, sl in ((np.real(pts), slice(0, half)),
                     (np.imag(pts), slice(half, nbpsc))):
        # per-bit max-log soft value from distances to the level sets
        d = np.abs(comp[:, None] - axis[None, :])       # [n, L]
        for bit in range(half):
            mask1 = (np.arange(len(axis)) >> (half - 1 - bit)) & 1 == 1
            d1 = d[:, mask1].min(axis=1)
            d0 = d[:, ~mask1].min(axis=1)
            out[:, sl][:, bit] = np.clip(0.5 + (d0 - d1) / 4.0, 0, 1)
    return out.reshape(-1)


def viterbi_decode_soft(soft: np.ndarray) -> np.ndarray:
    """Terminated soft-decision Viterbi for the K=7 g0=0o133/g1=0o171 code:
    soft pairs in [0,1] (0.5 = erasure), start AND end state 0 (the 802.11
    tail bits guarantee termination)."""
    enc_out, pred = _tables(7, (0o133, 0o171))
    ns = 64
    r = np.asarray(soft, np.float64).reshape(-1, 2)
    n = len(r)
    t_idx = np.arange(ns)
    br = np.stack([enc_out[pred[:, 0], t_idx & 1],
                   enc_out[pred[:, 1], t_idx & 1]], axis=1).astype(np.float64)
    metrics = np.full(ns, 1e9)
    metrics[0] = 0.0
    decisions = np.empty((n, ns), np.int8)
    for i in range(n):
        bm = np.abs(br - r[i][None, None, :]).sum(axis=-1)     # [ns, 2]
        cand = metrics[pred] + bm
        decisions[i] = np.argmin(cand, axis=-1)
        metrics = cand[t_idx, decisions[i]]
        metrics -= metrics.min()
    bits = np.empty(n, np.uint8)
    s = 0                                       # terminated at state 0
    for i in range(n - 1, -1, -1):
        bits[i] = s & 1
        s = pred[s, decisions[i][s]]
    return bits


def _bytes_to_bits(data: bytes) -> np.ndarray:
    b = np.frombuffer(bytes(data), np.uint8)
    return ((b[:, None] >> np.arange(8)) & 1).astype(np.uint8).reshape(-1)


def _bits_to_bytes(bits: np.ndarray) -> bytes:
    bits = np.asarray(bits, np.uint8)[: len(bits) // 8 * 8].reshape(-1, 8)
    return bytes((bits << np.arange(8)).sum(axis=1).astype(np.uint8))


def append_fcs(mpdu: bytes) -> bytes:
    """MAC frame + the 802.11 FCS (standard reflected CRC-32, LE bytes)."""
    c = binascii.crc32(bytes(mpdu)) & 0xFFFFFFFF
    return bytes(mpdu) + c.to_bytes(4, "little")


def check_fcs(psdu: bytes) -> bool:
    return (len(psdu) > 4 and
            (binascii.crc32(bytes(psdu[:-4])) & 0xFFFFFFFF)
            == int.from_bytes(psdu[-4:], "little"))


# ------------------------------------------------------- symbol assembly

def _ofdm_symbol(freq53: np.ndarray) -> np.ndarray:
    """53 subcarrier values (−26..26) → 80-sample CP+IFFT time symbol."""
    spec = np.zeros(N_FFT, np.complex128)
    spec[1:27] = freq53[27:]                    # +1..+26
    spec[38:] = freq53[:26]                     # −26..−1
    sym = np.fft.ifft(spec) * (N_FFT / np.sqrt(52.0))
    return np.concatenate([sym[-N_CP:], sym])


def _data_symbol(points48: np.ndarray, pilot_polarity: float) -> np.ndarray:
    freq = np.zeros(53, np.complex128)
    freq[_DATA_IDX + 26] = points48
    for c, v in zip(PILOT_CARRIERS, PILOT_VALUES):
        freq[c + 26] = v * pilot_polarity
    return _ofdm_symbol(freq)


def preamble() -> np.ndarray:
    """STF (160 samples) + LTF (160 samples), clause 18.3.3."""
    # same N/sqrt(52) normalization as LTF/data symbols: the clause-18.3.3
    # sqrt(13/6) carrier scaling already equalizes STF power with the
    # 52-carrier symbols — an extra 12·13/6 here made the STF 3 dB hot
    # (ADVICE r2; decode was unaffected, the emitted power profile was)
    stf64 = np.fft.ifft(np.concatenate([
        np.zeros(1), STF_FREQ[27:], np.zeros(11), STF_FREQ[:26]])
    ) * (N_FFT / np.sqrt(52.0))
    stf = np.tile(stf64[:16], 10)               # 10 short symbols
    ltf64 = np.fft.ifft(np.concatenate([
        np.zeros(1), LTF_FREQ[27:], np.zeros(11), LTF_FREQ[:26]])
    ) * (N_FFT / np.sqrt(52.0))
    ltf = np.concatenate([ltf64[-32:], ltf64, ltf64])
    return np.concatenate([stf, ltf])


_PILOT_POLARITY = 1.0 - 2.0 * scramble_sequence(127, 0x7F).astype(np.float64)


def encode_frame(psdu: bytes, *, rate: int = 12,
                 scrambler_seed: int = 0x5D) -> np.ndarray:
    """Full PLCP frame waveform at 20 Msps baseband for a PSDU."""
    p = RATES[rate]
    length = len(psdu)
    if not 1 <= length <= 4095:
        raise ValueError("PSDU length must be 1..4095 bytes")
    # SIGNAL: RATE(4, MSB first) R LENGTH(12, LSB first) parity tail(6)
    sig = np.zeros(24, np.uint8)
    for k in range(4):
        sig[k] = (p["bits"] >> (3 - k)) & 1
    for k in range(12):
        sig[5 + k] = (length >> k) & 1
    sig[17] = sig[:17].sum() & 1
    sig_coded = interleave(_conv_encode(sig), 48, 1)
    symbols = [_data_symbol(map_symbols(sig_coded, "bpsk"),
                            _PILOT_POLARITY[0])]
    # DATA: SERVICE(16) + PSDU + tail(6) + pad, scrambled (tail re-zeroed)
    bits = np.concatenate([np.zeros(16, np.uint8), _bytes_to_bits(psdu)])
    n_sym = int(np.ceil((len(bits) + 6) / p["ndbps"]))
    n_data = n_sym * p["ndbps"]
    data = np.zeros(n_data, np.uint8)
    data[:len(bits)] = bits
    data ^= scramble_sequence(n_data, scrambler_seed)
    data[len(bits):len(bits) + 6] = 0           # tail bits after scrambling
    coded = puncture(_conv_encode(data), p["punct"])
    for i in range(n_sym):
        chunk = coded[i * p["ncbps"]:(i + 1) * p["ncbps"]]
        pts = map_symbols(interleave(chunk, p["ncbps"], p["nbpsc"]),
                          p["mod"])
        symbols.append(_data_symbol(pts, _PILOT_POLARITY[(i + 1) % 127]))
    return np.concatenate([preamble()] + symbols).astype(np.complex64)


# ---------------------------------------------------------------- decode

def _ltf_reference() -> np.ndarray:
    ltf64 = np.fft.ifft(np.concatenate([
        np.zeros(1), LTF_FREQ[27:], np.zeros(11), LTF_FREQ[:26]])
    ) * (N_FFT / np.sqrt(52.0))
    return ltf64


def _fft_symbol(x80: np.ndarray) -> np.ndarray:
    """80 time samples → 53 subcarrier values (−26..26)."""
    spec = np.fft.fft(x80[N_CP:N_CP + N_FFT]) / (N_FFT / np.sqrt(52.0))
    out = np.empty(53, np.complex128)
    out[27:] = spec[1:27]
    out[:26] = spec[38:]
    out[26] = 0.0
    return out


def decode_frames(x: np.ndarray, *, corr_threshold: float = 0.75,
                  max_frames: int = 64) -> list[dict]:
    """Hunt PLCP frames in 20 Msps complex baseband.  LTF cross-correlation
    gives timing; the LTF repetition gives fine CFO; the known LTF spectrum
    gives the one-shot channel estimate; pilots track residual phase."""
    x = np.asarray(x, np.complex128)
    ref = _ltf_reference()
    if len(x) < 400:
        return []
    corr = np.abs(np.correlate(x, ref, mode="valid"))
    norm = np.sqrt(np.convolve(np.abs(x) ** 2, np.ones(N_FFT),
                               mode="valid")[:len(corr)]
                   * np.sum(np.abs(ref) ** 2))
    score = corr / np.maximum(norm, 1e-12)
    frames: list[dict] = []
    pos = 0
    while pos < len(score) and len(frames) < max_frames:
        hits = np.flatnonzero(score[pos:] >= corr_threshold)
        if not len(hits):
            break
        p1 = pos + hits[0]
        # refine: the LTF guard is a cyclic copy, so the first hit can lock
        # onto the 32-sample CP — search a window wide enough to cover that
        # and pick the offset maximizing BOTH repeats (64 apart)
        lo = max(p1 - 4, 0)
        hi = min(p1 + 40, len(score) - 65)
        if hi <= lo:
            break
        pair = score[lo:hi] + score[lo + 64:hi + 64]
        p1 = lo + int(np.argmax(pair))
        if p1 + 64 + N_FFT > len(x):
            break
        # fine CFO from the repetition
        seg1 = x[p1:p1 + N_FFT]
        seg2 = x[p1 + 64:p1 + 64 + N_FFT]
        dphi = np.angle(np.vdot(seg1, seg2))     # over 64 samples
        cfo = dphi / 64.0
        n_idx = np.arange(len(x) - p1)
        y = x[p1:] * np.exp(-1j * cfo * n_idx)
        # channel estimate from both LTF repeats
        l1 = np.fft.fft(y[:N_FFT]) / (N_FFT / np.sqrt(52.0))
        l2 = np.fft.fft(y[64:64 + N_FFT]) / (N_FFT / np.sqrt(52.0))
        lavg = 0.5 * (l1 + l2)
        known = np.concatenate([np.zeros(1), LTF_FREQ[27:], np.zeros(11),
                                LTF_FREQ[:26]])
        with np.errstate(divide="ignore", invalid="ignore"):
            h = np.where(known != 0, lavg / np.where(known == 0, 1, known),
                         1.0)
        data_start = 64 + N_FFT                  # after the 2nd LTF repeat

        def eq_symbol(i_sym: int) -> np.ndarray | None:
            s0 = data_start + i_sym * 80
            if s0 + 80 > len(y):
                return None
            f = _fft_symbol(y[s0:s0 + 80])
            spec = np.empty(53, np.complex128)
            hh = np.empty(53, np.complex128)
            hh[27:] = h[1:27]
            hh[:26] = h[38:]
            hh[26] = 1.0
            spec = f / np.where(np.abs(hh) < 1e-9, 1e-9, hh)
            pol = _PILOT_POLARITY[i_sym % 127]
            pil = np.asarray([spec[c + 26] for c in PILOT_CARRIERS])
            expect = PILOT_VALUES * pol
            rot = np.vdot(expect, pil)
            rot = rot / max(np.abs(rot), 1e-12)
            return spec * np.conj(rot)

        sig_spec = eq_symbol(0)
        if sig_spec is None:
            break
        sig_soft = demap_soft(sig_spec[_DATA_IDX + 26], "bpsk")
        sig_bits = viterbi_decode_soft(deinterleave(sig_soft, 48, 1))
        rate_bits = int((sig_bits[:4] * (1 << np.arange(3, -1, -1))).sum())
        length = int((sig_bits[5:17] * (1 << np.arange(12))).sum())
        parity_ok = int(sig_bits[:18].sum()) % 2 == 0
        rate = _RATE_BY_BITS.get(rate_bits)
        if rate is None or not parity_ok or not 1 <= length <= 4095:
            pos = p1 + 32
            continue
        p = RATES[rate]
        n_sym = int(np.ceil((16 + 8 * length + 6) / p["ndbps"]))
        soft_all = []
        ok = True
        for i_sym in range(1, n_sym + 1):
            spec = eq_symbol(i_sym)
            if spec is None:
                ok = False
                break
            soft = demap_soft(spec[_DATA_IDX + 26], p["mod"])
            soft_all.append(deinterleave(soft, p["ncbps"], p["nbpsc"]))
        if not ok:
            pos = p1 + 32
            continue
        soft = depuncture(np.concatenate(soft_all), p["punct"])
        data = viterbi_decode_soft(soft)[: n_sym * p["ndbps"]]
        # descramble: SERVICE's first 7 bits are zero pre-scramble, so the
        # received first 7 bits ARE the seed sequence — regenerate from them
        seq7 = data[:7]
        seq = np.empty(len(data), np.uint8)
        seq[:7] = seq7
        st = [int(b) for b in seq7[6::-1]]       # s[0] newest = bit 6
        for i in range(7, len(data)):
            fb = st[3] ^ st[6]
            seq[i] = fb
            st = [fb] + st[:6]
        plain = data ^ seq
        psdu = _bits_to_bytes(plain[16:16 + 8 * length])
        frame = {"rate_mbps": rate, "length": length, "psdu": psdu,
                 "cfo_hz": cfo * 20e6 / (2 * np.pi),
                 "sample_offset": int(p1),
                 "fcs_ok": check_fcs(psdu)}
        frames.append(frame)
        pos = p1 + data_start + n_sym * 80
    return frames


# ---------------------------------------------------------------- blocks

@register_block("WifiSource")
class WifiSource(SourceBlock):
    """Transmit-side stimulus: plays 802.11a/g PLCP frames for a list of
    dicts ``{"psdu": bytes, "rate": Mbps}`` with silence gaps (SIFS-ish),
    optionally cyclic."""

    OUT = (Port("out", dtype="complex64"),)
    FEED = True
    gap_s = Setting(default=16e-6, kind="static")
    repeat = Setting(default=False, kind="static")

    def __init__(self, frames: list[dict] = (), name=None, **settings):
        super().__init__(name=name, **settings)
        gap = np.zeros(int(float(self.settings.get("gap_s")) * 20e6),
                       np.complex64)
        parts: list[np.ndarray] = [gap]
        for fr in frames:
            psdu = fr["psdu"]
            if isinstance(psdu, str):            # YAML convenience: text
                psdu = psdu.encode()
            if fr.get("add_fcs"):
                psdu = append_fcs(psdu)
            parts.append(encode_frame(psdu,
                                      rate=int(fr.get("rate", 12))))
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


@register_block("WifiDecoder")
class WifiDecoder(SinkBlock):
    """802.11a/g OFDM receiver sink for 20 Msps complex baseband.
    Accumulates decoded ``frames`` (rate, length, PSDU, FCS verdict).
    Incremental with a bounded history like the other receiver sinks."""

    IN = (Port("in", dtype="complex64"),)
    corr_threshold = Setting(default=0.75, kind="static")
    max_buffer_s = Setting(default=1.0, kind="static")
    max_frames_per_scan = Setting(
        default=256, kind="static", limits=(1, 1 << 20),
        description="decode_frames cap per incremental scan; hitting it sets "
                    ".truncated (ADVICE r2: the old hidden cap of 64 "
                    "silently dropped frames in dense captures)")

    # longest legal 802.11a frame: 4095-byte PSDU at 6 Mbps ≈ 110k samples
    # at 20 Msps — the scan-overlap and trim-retention window
    _MAX_FRAME_SAMPLES = 1 << 17

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._buf = np.zeros(0, np.complex64)
        self._pending = 0
        self._base = 0          # absolute sample index of _buf[0]
        self._scanned_abs = 0   # absolute index scanned so far
        self.frames: list[dict] = []
        self._seen_offsets: set[int] = set()
        self.truncated = False  # a scan hit max_frames_per_scan

    def consume(self, arrays, tags, n_valid, abs_index):
        if n_valid <= 0:
            return
        xx = np.asarray(arrays["in"][..., :n_valid])
        self._buf = np.concatenate([self._buf,
                                    xx.reshape(-1).astype(np.complex64)])
        self._pending += n_valid
        if self._pending >= 262144:
            self._pending = 0
            self._process()

    def stop(self):
        self._process()

    def _process(self) -> None:
        """Incremental scan: only data past the resume point (minus one
        max-frame overlap) is re-correlated — the old full-buffer rescan was
        quadratic in stream length (ADVICE r2). Frames dedupe on absolute
        sample offset across the overlap."""
        if not len(self._buf):
            return
        cap = int(self.settings.get("max_frames_per_scan"))
        local_from = max(0, self._scanned_abs - self._base
                         - self._MAX_FRAME_SAMPLES)
        got = decode_frames(
            self._buf[local_from:],
            corr_threshold=float(self.settings.get("corr_threshold")),
            max_frames=cap)
        if len(got) >= cap:
            self.truncated = True
        for f in got:
            abs_off = int(f["sample_offset"]) + self._base + local_from
            if abs_off in self._seen_offsets:
                continue
            self._seen_offsets.add(abs_off)
            f["sample_offset"] = abs_off
            self.frames.append(f)
        self._scanned_abs = self._base + len(self._buf)
        buf_cap = int(float(self.settings.get("max_buffer_s")) * 20e6)
        if len(self._buf) > buf_cap:
            # retain one max-frame window across the trim so a frame
            # spanning the trim instant still decodes (ADVICE r2: the old
            # reset-to-empty lost it)
            keep = self._MAX_FRAME_SAMPLES
            self._base += len(self._buf) - keep
            self._buf = self._buf[-keep:]
