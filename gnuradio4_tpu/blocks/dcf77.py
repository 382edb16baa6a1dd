"""DCF77 time-signal model family (the 77.5 kHz German longwave time
broadcast; PTB dissemination of CET/CEST).

Protocol: one bit per second by carrier-amplitude reduction to ~15% at the
second boundary — 100 ms reduction = 0, 200 ms = 1; second 59 carries NO
reduction (the minute marker). The 59-bit frame encodes, BCD, little-endian
per field: minutes (21-27, even parity 28), hours (29-34, parity 35),
day-of-month (36-41), day-of-week (42-44), month (45-49), year-of-century
(50-57), date parity 58 over bits 36-57; bit 0 is always 0, bit 20 (start of
encoded time) always 1; bits 17/18 flag CEST/CET.

Device/host split (the family pattern): carrier synthesis and AM envelope
detection are device math (the stimulus here, ``ComplexToneSource →
Multiply`` or any AM front end in-graph); the per-second pulse-width
classification and BCD decode are O(seconds) host work in the
:class:`Dcf77Decoder` sink.
"""

from __future__ import annotations

import numpy as np

from ..core.block import Port, SinkBlock, SourceBlock
from ..core.registry import register_block
from ..core.settings import Setting

_REDUCED = 0.15          # carrier amplitude during the reduction window


def _bcd(value: int, bits: int) -> list[int]:
    """Little-endian BCD over ``bits`` positions (1,2,4,8,10,20,40,80)."""
    weights = [1, 2, 4, 8, 10, 20, 40, 80][:bits]
    digits = (value % 10, value // 10)
    out = []
    for i, w in enumerate(weights):
        d = digits[0] if w < 10 else digits[1]
        out.append((d >> (i if w < 10 else i - 4)) & 1)
    return out


def _from_bcd(bits: list[int]) -> int:
    weights = [1, 2, 4, 8, 10, 20, 40, 80][:len(bits)]
    return int(sum(int(b) * w for b, w in zip(bits, weights)))


def encode_minute(*, minute: int, hour: int, day: int, weekday: int,
                  month: int, year2: int, cest: bool = False) -> np.ndarray:
    """The 59 transmitted bits for one minute (second 59 has no bit)."""
    bits = np.zeros(59, np.uint8)
    bits[0] = 0                       # start of minute: always 0
    bits[17] = 1 if cest else 0       # CEST
    bits[18] = 0 if cest else 1       # CET
    bits[20] = 1                      # start of encoded time: always 1
    bits[21:28] = _bcd(minute, 7)
    bits[28] = int(bits[21:28].sum()) & 1      # even parity P1
    bits[29:35] = _bcd(hour, 6)
    bits[35] = int(bits[29:35].sum()) & 1      # P2
    bits[36:42] = _bcd(day, 6)
    bits[42:45] = _bcd(weekday, 3)
    bits[45:50] = _bcd(month, 5)
    bits[50:58] = _bcd(year2, 8)
    bits[58] = int(bits[36:58].sum()) & 1      # P3 over the date block
    return bits


def decode_minute(bits: np.ndarray) -> dict | None:
    """Decode+validate a 59-bit frame; None when any check fails."""
    bits = np.asarray(bits, np.uint8)
    if len(bits) != 59 or bits[0] != 0 or bits[20] != 1:
        return None
    if int(bits[21:29].sum()) & 1 or int(bits[29:36].sum()) & 1 \
            or int(bits[36:59].sum()) & 1:
        return None                   # parity P1/P2/P3
    out = {
        "minute": _from_bcd(list(bits[21:28])),
        "hour": _from_bcd(list(bits[29:35])),
        "day": _from_bcd(list(bits[36:42])),
        "weekday": _from_bcd(list(bits[42:45])),
        "month": _from_bcd(list(bits[45:50])),
        "year2": _from_bcd(list(bits[50:58])),
        "cest": bool(bits[17]),
    }
    if not (out["minute"] < 60 and out["hour"] < 24 and 1 <= out["day"] <= 31
            and 1 <= out["month"] <= 12 and 1 <= out["weekday"] <= 7):
        return None
    return out


def am_envelope(bits: np.ndarray, *, fs: float = 1000.0,
                include_marker: bool = True, phase_s: float = 0.0
                ) -> np.ndarray:
    """Baseband amplitude-envelope for one minute of transmission (plus the
    second-59 marker gap when ``include_marker``): 1.0 carrier with
    100/200 ms reductions to 15% at each second boundary."""
    n_sec = 60 if include_marker else 59
    n = int(round((n_sec + phase_s) * fs))
    env = np.ones(n, np.float32)
    for sec, b in enumerate(np.asarray(bits, np.uint8)):
        start = int(round((sec + phase_s) * fs))
        width = int(round((0.2 if b else 0.1) * fs))
        env[start:start + width] = _REDUCED
    return env


@register_block("Dcf77Source")
class Dcf77Source(SourceBlock):
    """Plays the AM envelope for a sequence of encoded minutes (stimulus for
    receiver chains; multiply with a carrier for RF-like tests)."""

    OUT = (Port("out", dtype="float32"),)
    FEED = True
    sample_rate = Setting(default=1000.0, kind="static")
    repeat = Setting(default=False, kind="static")

    def __init__(self, minutes: list[dict] = (), name=None, **settings):
        super().__init__(name=name, **settings)
        fs = float(self.settings.get("sample_rate"))
        parts = [am_envelope(encode_minute(**m), fs=fs) for m in minutes]
        self._wave = (np.concatenate(parts) if parts
                      else np.zeros(0, np.float32))

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


@register_block("Dcf77Decoder")
class Dcf77Decoder(SinkBlock):
    """Envelope-stream decoder sink: finds second boundaries (falling edges
    into the reduced-amplitude window), classifies 100 vs 200 ms reductions,
    locates the minute marker (a >1.5 s gap between reductions) and decodes
    each full frame. ``frames`` lists validated decodes; ``last_time`` holds
    the most recent one."""

    IN = (Port("in", dtype="float32"),)
    sample_rate = Setting(default=1000.0, kind="static")
    threshold = Setting(default=0.5, kind="static",
                        description="envelope slice level (fraction of peak)")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._buf = np.zeros(0, np.float64)
        self.frames: list[dict] = []
        self.last_time: dict | None = None
        self._n_seen = 0
        self._pending = 0

    def consume(self, arrays, tags, n_valid, abs_index):
        if n_valid <= 0:
            return
        x = np.asarray(arrays["in"][..., :n_valid], np.float64).reshape(-1)
        self._buf = np.concatenate([self._buf, x])
        self._pending += n_valid
        if self._pending >= int(float(self.settings.get("sample_rate"))) * 5:
            self._pending = 0
            self._process()

    def stop(self):
        self._process()

    def _process(self) -> None:
        fs = float(self.settings.get("sample_rate"))
        x = self._buf
        if len(x) < fs * 2:
            return
        level = float(self.settings.get("threshold")) * np.max(x)
        low = x < level
        # reduction pulses: runs of low samples starting at falling edges
        # (a stream that BEGINS inside a reduction is a pulse at sample 0)
        edges = np.flatnonzero(low[1:] & ~low[:-1]) + 1
        if low[0]:
            edges = np.concatenate([[0], edges])
        pulses = []                       # (start_sample, width_samples)
        for e in edges:
            end = e
            while end < len(x) and low[end]:
                end += 1
            if end >= len(x):
                break                     # pulse may continue into next chunk
            pulses.append((e, end - e))
        # group into minutes at >1.5 s gaps (the missing second 59)
        frames = []
        current: list[int] = []
        for i, (s, w) in enumerate(pulses):
            if current and s - pulses[i - 1][0] > 1.5 * fs:
                if len(current) == 59:
                    frames.append(current)
                current = []
            current.append(1 if w > 0.15 * fs else 0)
        # a trailing complete frame flushes once the marker gap has elapsed
        if len(current) == 59 and pulses \
                and len(x) - pulses[-1][0] > 1.5 * fs:
            frames.append(current)
        for bits in frames[self._n_seen:]:
            decoded = decode_minute(np.asarray(bits, np.uint8))
            if decoded is not None:
                self.frames.append(decoded)
                self.last_time = decoded
        self._n_seen = len(frames)
