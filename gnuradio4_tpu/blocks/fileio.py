"""File IO blocks (≈ reference blocks/fileio: BasicFileIo.hpp BasicFileSource/
BasicFileSink, WavBlocks.hpp WavSource/WavSink).

Sources stream through the native ring on an IO thread (core/feeder.py) so disk
latency never stalls device dispatch — the device-native analog of the reference's
IO-bound thread pool feeding ring buffers.
"""

from __future__ import annotations

import struct
import wave
from pathlib import Path
from typing import Any, Iterator

import numpy as np

from ..core.block import Port, SinkBlock, SourceBlock
from ..core.errors import GrError
from ..core.feeder import ThreadedFeeder, read_exact
from ..core.registry import register_block
from ..core.settings import Setting
from ..core.stream import canonical_dtype
from ..core.tags import Keys, Tag


def _chunks_from_file(path: str, dtype: np.dtype, chunk_items: int,
                      repeat: bool) -> Iterator[np.ndarray]:
    while True:
        with open(path, "rb") as f:
            while True:
                raw = f.read(chunk_items * dtype.itemsize)
                if not raw:
                    break
                yield np.frombuffer(raw[: len(raw) // dtype.itemsize
                                        * dtype.itemsize], dtype=dtype)
        if not repeat:
            return


@register_block("FileSource")
class FileSource(SourceBlock):
    """Raw binary file source (≈ BasicFileSource) with threaded ring feed."""

    OUT = (Port("out"),)
    FEED = True
    path = Setting(default="", kind="static")
    dtype = Setting(default="float32", kind="static")
    wire_format = Setting(default="", kind="static",
                          choices=("", "i16", "u8", "i16iq", "u8iq"),
                          description="on-disk format converted on the IO thread "
                                      "(native SIMD): i16/u8 → float32, "
                                      "i16iq/u8iq → complex64")
    repeat = Setting(default=False, kind="static")
    offset_items = Setting(default=0, kind="static")
    n_items = Setting(default=0, kind="static", description="0 = whole file")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._feeder: ThreadedFeeder | None = None
        self._reader = -1
        self._served = 0

    _WIRE = {"i16": (np.dtype(np.int16), 1, "float32"),
             "u8": (np.dtype(np.uint8), 1, "float32"),
             "i16iq": (np.dtype(np.int16), 2, "complex64"),
             "u8iq": (np.dtype(np.uint8), 2, "complex64")}

    def out_dtype(self, port, in_dtypes):
        wf = str(self.settings.get("wire_format"))
        if wf:
            return self._WIRE[wf][2]
        return self.settings.get("dtype")

    def _converter(self):
        wf = str(self.settings.get("wire_format"))
        if not wf:
            return None
        from ..native import convert as cv
        return {"i16": cv.i16_to_f32, "u8": cv.u8_to_f32,
                "i16iq": cv.i16iq_to_c64, "u8iq": cv.u8iq_to_c64}[wf]

    def start(self):
        path = str(self.settings.get("path"))
        if not Path(path).is_file():
            raise GrError(f"{self.name}: no such file {path!r}")
        wf = str(self.settings.get("wire_format"))
        if wf:
            raw_dt, per_item, _ = self._WIRE[wf]
            conv = self._converter()
            raw_src = _chunks_from_file(path, raw_dt, (1 << 16) * per_item,
                                        bool(self.settings.get("repeat")))
            src = (conv(chunk) for chunk in raw_src)
            dt = np.dtype(canonical_dtype(self._WIRE[wf][2]))
        else:
            dt = np.dtype(canonical_dtype(self.settings.get("dtype")))
            src = _chunks_from_file(path, dt, 1 << 16,
                                    bool(self.settings.get("repeat")))
        off = int(self.settings.get("offset_items"))
        limit = int(self.settings.get("n_items"))

        def limited():
            skipped = 0
            sent = 0
            for chunk in src:
                if skipped < off:
                    take = min(len(chunk), off - skipped)
                    skipped += take
                    chunk = chunk[take:]
                    if not len(chunk):
                        continue
                if limit:
                    room = limit - sent
                    if room <= 0:
                        return
                    chunk = chunk[:room]
                sent += len(chunk)
                yield chunk
                if limit and sent >= limit:
                    return

        self._feeder = ThreadedFeeder(limited(), dt, name=f"{self.name}.io").start()
        self._reader = self._feeder.reader
        self._served = 0

    def stop(self):
        if self._feeder:
            self._feeder.stop()

    def host_feed(self, n, abs_index):
        if self._feeder is None:
            self.start()
        # checkpoint resume: the restored scheduler asks for samples from
        # abs_index, but a freshly-started IO feeder streams from offset_items
        # again — discard the already-consumed prefix so the resumed stream is
        # bit-exact (contract documented in core/checkpoint.py)
        while self._served < abs_index:
            skip = read_exact(self._feeder.ring, self._reader,
                              min(n, abs_index - self._served))
            if self._feeder.error is not None:
                raise GrError(f"{self.name}: IO thread failed: "
                              f"{self._feeder.error}")
            if skip is None:
                return None  # file shorter than the resume point → EOS
            self._served += len(skip)
        got = read_exact(self._feeder.ring, self._reader, n)
        if self._feeder.error is not None:
            raise GrError(f"{self.name}: IO thread failed: {self._feeder.error}")
        if got is None:
            return None
        self._served += len(got)
        return {"out": got}, len(got)

    def apply(self, state, ins, ctx):
        return state, {"out": ins["out"]}


@register_block("FileSink")
class FileSink(SinkBlock):
    """Raw binary file sink (≈ BasicFileSink); writes on the deliver path."""

    IN = (Port("in"),)
    path = Setting(default="", kind="static")
    append = Setting(default=False, kind="static")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._f = None
        self.n_written = 0

    def start(self):
        mode = "ab" if self.settings.get("append") else "wb"
        self._f = open(str(self.settings.get("path")), mode)
        self.n_written = 0

    def stop(self):
        if self._f:
            self._f.close()
            self._f = None

    def consume(self, arrays, tags, n_valid, abs_index):
        if self._f is None:
            self.start()
        data = np.ascontiguousarray(arrays["in"][..., :n_valid])
        self._f.write(data.tobytes())
        self.n_written += n_valid


@register_block("WavSource")
class WavSource(SourceBlock):
    """PCM WAV source → float32 in [-1, 1] (multi-channel aware; ≈ WavSource)."""

    OUT = (Port("out", dtype="float32"),)
    FEED = True
    path = Setting(default="", kind="static")
    repeat = Setting(default=False, kind="static")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._data: np.ndarray | None = None
        self.sample_rate = 0.0

    def _load(self):
        if self._data is not None:
            return
        path = str(self.settings.get("path"))
        with wave.open(path, "rb") as w:
            nch = w.getnchannels()
            width = w.getsampwidth()
            self.sample_rate = float(w.getframerate())
            raw = w.readframes(w.getnframes())
        if width == 2:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif width == 1:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128) / 128.0
        elif width == 4:
            x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        else:
            raise GrError(f"unsupported WAV sample width {width}")
        x = x.reshape(-1, nch).T  # [channels, T]
        self._data = x[0] if nch == 1 else x

    def out_channels(self, port, in_channels):
        self._load()
        return 0 if self._data.ndim == 1 else self._data.shape[0]

    def emit_tags(self, ctx):
        if ctx.abs_index == 0 and self.sample_rate:
            return [Tag(0, {Keys.SAMPLE_RATE: self.sample_rate})]
        return []

    def host_feed(self, n, abs_index):
        self._load()
        total = self._data.shape[-1]
        if self.settings.get("repeat"):
            idx = np.arange(abs_index, abs_index + n) % total
            return {"out": self._data[..., idx]}, n
        if abs_index >= total:
            return None
        chunk = self._data[..., abs_index: abs_index + n]
        return {"out": chunk}, chunk.shape[-1]

    def apply(self, state, ins, ctx):
        return state, {"out": ins["out"]}


@register_block("WavSink")
class WavSink(SinkBlock):
    """float32 [-1,1] → 16-bit PCM WAV (≈ WavSink)."""

    IN = (Port("in", dtype="float32"),)
    path = Setting(default="", kind="static")
    sample_rate = Setting(default=48000.0)

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._w = None
        self.n_written = 0

    def consume(self, arrays, tags, n_valid, abs_index):
        for t in tags.get("in", []):
            if Keys.SAMPLE_RATE in t.map:
                self.settings.set({"sample_rate": float(t.map[Keys.SAMPLE_RATE])})
                self.settings.apply_staged()
        if self._w is None:
            x = arrays["in"]
            nch = 1 if x.ndim == 1 else x.shape[0]
            self._w = wave.open(str(self.settings.get("path")), "wb")
            self._w.setnchannels(nch)
            self._w.setsampwidth(2)
            self._w.setframerate(int(self.settings.get("sample_rate")))
        x = arrays["in"][..., :n_valid]
        pcm = np.clip(np.round(x * 32768.0), -32768, 32767).astype("<i2")
        if pcm.ndim == 2:
            pcm = pcm.T.reshape(-1)  # interleave channels
        self._w.writeframes(pcm.tobytes())
        self.n_written += n_valid

    def stop(self):
        if self._w:
            self._w.close()
            self._w = None
