"""RTTY (radioteletype) model family — Baudot/ITA2 over 170 Hz-shift FSK.

The amateur standard: 45.45 baud, mark 2125 Hz / space 2295 Hz AFSK (or the
same shift at RF), ITA2 5-bit code with LTRS/FIGS shift states, asynchronous
character framing (1 start bit = space, 5 data bits LSB-first, ≥1.5 stop bits
= mark; idle line = mark).

Device/host split (the family pattern, see blocks/sstv.py / dcf77.py):
synthesis is a vectorized per-sample frequency timeline integrated into
phase-continuous FM; the receiver consumes an audio (or discriminator)
stream in the :class:`RttyDecoder` sink — analytic-signal discriminator,
mark/space slicing, async start-bit framing with mid-bit sampling — and
exposes the rolling decoded ``text``.

Reference parity anchor: the reference ships no RTTY blocks; this family
extends the receiver set built on the same machinery validated against
blocks/basic + blocks/filter qa suites (QuadratureDemod front ends, host
sinks).
"""

from __future__ import annotations

import numpy as np

from ..core.block import Port, SinkBlock, SourceBlock
from ..core.registry import register_block
from ..core.settings import Setting
from .sstv import instantaneous_frequency

BAUD = 45.45
F_MARK = 2125.0
F_SPACE = 2295.0

# ITA2 (US-TTY flavour): index = 5-bit code, LSB-first transmission
_LTRS = list("\x00E\nA SIU\rDRJNFCKTZLWHYPQOBG\x0eMXV\x0f")
_FIGS = list("\x003\n- \x0787\r$4',!:(5\")2#6019?&\x0e./;\x0f")
_LTRS_SHIFT = 0x1F
_FIGS_SHIFT = 0x1B


def _tables() -> tuple[dict[str, int], dict[str, int]]:
    lt = {c: i for i, c in enumerate(_LTRS) if c not in "\x00\x0e\x0f"}
    fg = {c: i for i, c in enumerate(_FIGS) if c not in "\x00\x0e\x0f"}
    return lt, fg


def baudot_encode(text: str) -> list[int]:
    """Text → 5-bit ITA2 codes with LTRS/FIGS shifts injected; starts in
    LTRS (transmitters conventionally lead with a LTRS to set state)."""
    lt, fg = _tables()
    out = [_LTRS_SHIFT]
    shift = "L"
    for ch in text.upper():
        if ch in lt and (ch not in fg or shift == "L" or ch in "\r\n "):
            if shift != "L" and ch not in "\r\n ":
                out.append(_LTRS_SHIFT)
                shift = "L"
            out.append(lt[ch])
        elif ch in fg:
            if shift != "F" and ch not in "\r\n ":
                out.append(_FIGS_SHIFT)
                shift = "F"
            out.append(fg[ch])
        # unknown characters are dropped (teletype behavior)
    return out


def baudot_decode(codes: list[int]) -> str:
    out = []
    shift = "L"
    for c in codes:
        c &= 0x1F
        if c == _LTRS_SHIFT:
            shift = "L"
        elif c == _FIGS_SHIFT:
            shift = "F"
        else:
            ch = (_LTRS if shift == "L" else _FIGS)[c]
            if ch != "\x00":
                out.append(ch)
    return "".join(out)


def rtty_modulate(text: str, *, fs: float = 48000.0, baud: float = BAUD,
                  f_mark: float = F_MARK, f_shift: float = 170.0,
                  amplitude: float = 0.8, stop_bits: float = 1.5,
                  lead_s: float = 0.1) -> np.ndarray:
    """Phase-continuous AFSK audio for ``text`` (mark idle lead-in, per
    character: start space + 5 LSB-first data bits + mark stop)."""
    f_space = f_mark + f_shift
    bit_n = fs / baud
    segs: list[tuple[float, float]] = [(f_mark, lead_s * fs)]
    for code in baudot_encode(text):
        segs.append((f_space, bit_n))              # start bit
        for k in range(5):
            bit = (code >> k) & 1
            segs.append((f_mark if bit else f_space, bit_n))
        segs.append((f_mark, stop_bits * bit_n))   # stop
    segs.append((f_mark, lead_s * fs))
    # sample-exact boundaries from the cumulative (fractional) timeline
    bounds = np.cumsum([0.0] + [d for _, d in segs])
    n = int(round(bounds[-1]))
    freq = np.empty(n)
    for (f, _), lo, hi in zip(segs, bounds[:-1], bounds[1:]):
        freq[int(round(lo)):int(round(hi))] = f
    phase = 2.0 * np.pi * np.cumsum(freq) / fs
    return (amplitude * np.sin(phase)).astype(np.float32)


def demod_bits(freq: np.ndarray, fs: float, *, baud: float = BAUD,
               f_mark: float = F_MARK, f_shift: float = 170.0
               ) -> list[int]:
    """Async framing on a frequency stream: mark=1/space=0 slicing at the
    mark/space midpoint, start-bit edge sync, mid-bit sampling."""
    thresh = f_mark + f_shift / 2.0
    mark = freq < thresh                           # mark is the LOWER tone
    bit_n = fs / baud
    codes: list[int] = []
    i = 0
    n = len(mark)
    while i < n:
        if mark[i]:
            i += 1
            continue
        # candidate start bit: verify its center is still space
        c = i + int(bit_n / 2)
        if c >= n:
            break
        if mark[c]:
            i += 1
            continue
        code = 0
        ok = True
        for k in range(5):
            s = i + int((1.5 + k) * bit_n)
            if s >= n:
                ok = False
                break
            code |= int(mark[s]) << k
        stop = i + int(6.5 * bit_n)
        if ok and stop < n and mark[stop]:
            codes.append(code)
            i += int(7.0 * bit_n)                  # past the stop bit
        else:
            i += 1
    return codes


@register_block("RttySource")
class RttySource(SourceBlock):
    """Plays the AFSK audio for a text message (test stimulus / TX)."""

    OUT = (Port("out", dtype="float32"),)
    FEED = True
    sample_rate = Setting(default=48000.0, kind="static")
    baud = Setting(default=BAUD, kind="static")

    def __init__(self, text: str = "", name=None, **settings):
        super().__init__(name=name, **settings)
        fs = float(self.settings.get("sample_rate"))
        self._wave = rtty_modulate(text, fs=fs,
                                   baud=float(self.settings.get("baud")))

    def host_feed(self, n, abs_index):
        if abs_index >= len(self._wave):
            return None
        chunk = self._wave[abs_index:abs_index + n]
        return {"out": chunk}, len(chunk)

    def apply(self, state, ins, ctx):
        return state, {"out": ins["out"]}


@register_block("RttyDecoder")
class RttyDecoder(SinkBlock):
    """RTTY receiver sink for an audio stream: analytic-signal discriminator
    (~1/4-bit smoothing), mark/space slicing, async start-bit framing and
    ITA2 decode with shift tracking. ``text`` holds everything decoded so
    far; re-decodes the buffered stream as new samples arrive."""

    IN = (Port("in", dtype="float32"),)
    sample_rate = Setting(default=48000.0, kind="static")
    baud = Setting(default=BAUD, kind="static")
    max_buffer_s = Setting(default=60.0, kind="static",
                           description="history bound for a continuous "
                                       "stream: once exceeded, decoded text "
                                       "is archived and the buffer flushes "
                                       "at the next idle (all-mark) seam")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._buf = np.zeros(0, np.float32)
        self._pending = 0
        self._done = ""
        self.text = ""

    def consume(self, arrays, tags, n_valid, abs_index):
        if n_valid <= 0:
            return
        x = np.asarray(arrays["in"][..., :n_valid], np.float32).reshape(-1)
        self._buf = np.concatenate([self._buf, x])
        self._pending += n_valid
        fs = float(self.settings.get("sample_rate"))
        if self._pending >= int(fs / 2):
            self._pending = 0
            self._decode()

    def stop(self):
        self._decode()

    def _decode(self) -> None:
        fs = float(self.settings.get("sample_rate"))
        baud = float(self.settings.get("baud"))
        if len(self._buf) < 2.0 * fs / baud:
            return
        freq = instantaneous_frequency(self._buf, fs)
        k = max(1, int(round(fs / baud / 4.0)))
        if k > 1:
            freq = np.convolve(freq, np.full(k, 1.0 / k), mode="same")
        txt = baudot_decode(demod_bits(freq, fs, baud=baud))
        cap = int(float(self.settings.get("max_buffer_s")) * fs)
        if len(self._buf) > cap:
            # flush at an idle seam (line idles at mark between characters)
            # so no in-flight character straddles the cut; past 2×cap flush
            # unconditionally (worst case: one character lost)
            tail = freq[-int(8 * fs / baud):]
            idle = np.all(np.abs(tail - F_MARK) < 60.0) if len(tail) else True
            if idle or len(self._buf) > 2 * cap:
                self._done += txt
                txt = ""
                self._buf = np.zeros(0, np.float32)
        self.text = self._done + txt
