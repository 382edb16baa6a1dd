"""ctypes wrapper for the native double-mapped ring (+ pure-Python fallback).

The native ring (ringbuf.cpp) provides wrap-free contiguous spans — producer and
consumers exchange numpy views with zero copies, across threads, without locks.
Used by the threaded host feed pipeline (ThreadedFeeder) and available to
DataSink consumers. ≈ reference CircularBuffer (SURVEY §2.1)."""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from .build import build_library

_HERE = Path(__file__).resolve().parent
_SO = _HERE / "libgr4ring.so"
_lib = None
_lib_blocking = None   # CDLL view of the same .so (releases the GIL per call)
_build_lock = threading.Lock()


def build_native(force: bool = False) -> bool:
    """Compile ringbuf.cpp → libgr4ring.so (idempotent). Returns success."""
    with _build_lock:
        return build_library(_HERE / "ringbuf.cpp", _SO, force)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not build_native():  # mtime-checked: rebuilds BEFORE the first dlopen
        return None         # (dlopen caches by path; a later rebuild is invisible)
    try:
        # PyDLL: the ring ops are nanosecond-scale and never block, so holding
        # the GIL is cheaper than CDLL's release/reacquire per call (measured
        # 2x producer throughput with 4 spinning readers)
        lib = ctypes.PyDLL(str(_SO))
        lib.gr4_ring_data, lib.gr4_ring_reserve_mp  # stale prebuilt .so → no native path
    except (OSError, AttributeError):
        return None
    lib.gr4_ring_create.restype = ctypes.c_void_p
    lib.gr4_ring_create.argtypes = [ctypes.c_size_t]
    lib.gr4_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.gr4_ring_capacity.restype = ctypes.c_size_t
    lib.gr4_ring_capacity.argtypes = [ctypes.c_void_p]
    lib.gr4_ring_data.restype = ctypes.c_void_p
    lib.gr4_ring_data.argtypes = [ctypes.c_void_p]
    lib.gr4_ring_add_reader.restype = ctypes.c_int
    lib.gr4_ring_add_reader.argtypes = [ctypes.c_void_p]
    lib.gr4_ring_reserve.restype = ctypes.c_void_p
    lib.gr4_ring_reserve.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                     ctypes.POINTER(ctypes.c_size_t)]
    lib.gr4_ring_publish.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.gr4_ring_read.restype = ctypes.c_void_p
    lib.gr4_ring_read.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t,
                                  ctypes.POINTER(ctypes.c_size_t)]
    lib.gr4_ring_release.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_size_t]
    lib.gr4_ring_readable.restype = ctypes.c_size_t
    lib.gr4_ring_readable.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.gr4_ring_writable.restype = ctypes.c_size_t
    lib.gr4_ring_writable.argtypes = [ctypes.c_void_p]
    lib.gr4_ring_set_eos.argtypes = [ctypes.c_void_p]
    lib.gr4_ring_eos.restype = ctypes.c_int
    lib.gr4_ring_eos.argtypes = [ctypes.c_void_p]
    lib.gr4_ring_reserve_mp.restype = ctypes.c_void_p
    lib.gr4_ring_reserve_mp.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                        ctypes.POINTER(ctypes.c_size_t),
                                        ctypes.POINTER(ctypes.c_uint64)]
    # publish_mp spin-waits for predecessor producers — it MUST release the GIL
    # (through PyDLL the spinning thread would hold the GIL the predecessor
    # needs to finish its copy: instant deadlock). CDLL view of the same lib.
    global _lib_blocking
    libb = ctypes.CDLL(str(_SO))
    libb.gr4_ring_publish_mp.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                         ctypes.c_size_t]
    # futex-parked waits (BlockingWaitStrategy) — CDLL only: they sleep in the
    # kernel and must release the GIL
    libb.gr4_ring_wait_readable.restype = ctypes.c_int
    libb.gr4_ring_wait_readable.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_size_t, ctypes.c_long]
    libb.gr4_ring_wait_writable.restype = ctypes.c_int
    libb.gr4_ring_wait_writable.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                            ctypes.c_long]
    _lib_blocking = libb
    _lib = lib
    return lib


def native_available() -> bool:
    return _load() is not None


class HostRing:
    """Typed SPMC ring. All span methods return numpy views (zero-copy, native
    path) valid until the matching publish/release."""

    def __init__(self, capacity_items: int, dtype=np.float32, *,
                 force_python: bool = False, producers: str = "single"):
        """``producers="multi"`` enables the CAS-claim multi-producer path
        (≈ MultiProducerStrategy, ClaimStrategy.hpp:116): concurrent
        :meth:`write` calls from many threads claim disjoint ranges and
        publish in ticket order. Zero-copy reserve/publish stays
        single-producer-only."""
        if producers not in ("single", "multi"):
            raise ValueError("producers must be 'single' or 'multi'")
        self.producers = producers
        self._mp_lock = threading.Lock()  # python-fallback MP serialization
        self.dtype = np.dtype(dtype)
        self.itemsize = self.dtype.itemsize
        lib = None if force_python else _load()
        self._lib = lib
        self._eos = False
        if lib is not None:
            self._h = lib.gr4_ring_create(capacity_items * self.itemsize)
            if not self._h:
                raise MemoryError("gr4_ring_create failed")
            cap_bytes = lib.gr4_ring_capacity(self._h)
            self.capacity = cap_bytes // self.itemsize
            # one persistent typed view over the whole double-mapped region:
            # reserve/read pointers become cheap slices (offset = ptr - base)
            self._base = lib.gr4_ring_data(self._h)
            raw = (ctypes.c_char * (2 * cap_bytes)).from_address(self._base)
            self._view = np.frombuffer(raw, dtype=self.dtype)
        else:  # pure-python fallback (locked deque of bytes)
            self._h = None
            self.capacity = 1
            while self.capacity < capacity_items:
                self.capacity <<= 1
            self._buf = np.zeros(self.capacity, self.dtype)
            self._head = 0
            self._tails: list[int] = []
            self._lock = threading.Lock()

    # -- producer --------------------------------------------------------------
    def reserve(self, n: int) -> np.ndarray:
        """Writable contiguous view of ≤ n items (may be shorter; len 0 = full)."""
        if self.producers == "multi":
            raise RuntimeError(
                "zero-copy reserve/publish is single-producer-only; on a "
                "producers='multi' ring use write() (CAS range claim)")
        return self._reserve_unchecked(n)

    def _reserve_unchecked(self, n: int) -> np.ndarray:
        if self._h is not None:
            avail = ctypes.c_size_t()
            ptr = self._lib.gr4_ring_reserve(self._h, n * self.itemsize,
                                             ctypes.byref(avail))
            cnt = avail.value // self.itemsize
            if not ptr or cnt == 0:
                return np.empty(0, self.dtype)
            off = (ptr - self._base) // self.itemsize
            return self._view[off:off + cnt]
        with self._lock:
            tail = min(self._tails, default=self._head)
            free = self.capacity - (self._head - tail)
            cnt = min(n, free)
            self._pending = cnt
            if cnt == 0:
                return np.empty(0, self.dtype)
            start = self._head & (self.capacity - 1)
            if start + cnt <= self.capacity:
                return self._buf[start:start + cnt]
            self._wrap_tmp = np.zeros(cnt, self.dtype)
            return self._wrap_tmp

    def publish(self, n: int) -> None:
        if self._h is not None:
            self._lib.gr4_ring_publish(self._h, n * self.itemsize)
            return
        with self._lock:
            start = self._head & (self.capacity - 1)
            if hasattr(self, "_wrap_tmp") and self._wrap_tmp is not None \
                    and start + n > self.capacity:
                first = self.capacity - start
                self._buf[start:] = self._wrap_tmp[:first]
                self._buf[: n - first] = self._wrap_tmp[first:n]
            self._wrap_tmp = None
            self._head += n

    def write(self, data: np.ndarray, *, block: bool = True,
              timeout: float = 10.0) -> int:
        """Convenience copy-in; blocks for space if requested. Returns items written.

        Thread-safe across concurrent writers when the ring was created with
        ``producers="multi"`` (CAS range claim + ticket-ordered publish)."""
        import time as _t
        data = np.ascontiguousarray(data, dtype=self.dtype)
        done = 0
        deadline = _t.monotonic() + timeout
        multi = self.producers == "multi"
        while done < len(data):
            if multi and self._h is not None:
                avail = ctypes.c_size_t()
                ticket = ctypes.c_uint64()
                ptr = self._lib.gr4_ring_reserve_mp(
                    self._h, (len(data) - done) * self.itemsize,
                    ctypes.byref(avail), ctypes.byref(ticket))
                cnt = avail.value // self.itemsize
                if not ptr or cnt == 0:
                    if not block or _t.monotonic() > deadline:
                        return done
                    self.wait_writable(1, timeout=max(
                        1e-3, deadline - _t.monotonic()))
                    continue
                off = (ptr - self._base) // self.itemsize
                self._view[off:off + cnt] = data[done:done + cnt]
                _lib_blocking.gr4_ring_publish_mp(self._h, ticket.value,
                                                  cnt * self.itemsize)
                done += cnt
                continue
            if multi:
                with self._mp_lock:  # python fallback: serialize writers
                    span = self._reserve_unchecked(len(data) - done)
                    if len(span):
                        span[:] = data[done:done + len(span)]
                        self.publish(len(span))
                        done += len(span)
                        continue
            else:
                span = self.reserve(len(data) - done)
                if len(span):
                    span[:] = data[done:done + len(span)]
                    self.publish(len(span))
                    done += len(span)
                    continue
            if not block or _t.monotonic() > deadline:
                return done
            self.wait_writable(1, timeout=max(1e-3, deadline - _t.monotonic()))
        return done

    # -- consumers -------------------------------------------------------------
    def add_reader(self) -> int:
        if self._h is not None:
            rid = self._lib.gr4_ring_add_reader(self._h)
            if rid < 0:
                raise RuntimeError("too many readers (max 8)")
            return rid
        with self._lock:
            self._tails.append(self._head)
            return len(self._tails) - 1

    def read(self, reader: int, max_n: int = 0) -> np.ndarray:
        """Readable contiguous view (≤ max_n items; 0 = all available)."""
        if self._h is not None:
            avail = ctypes.c_size_t()
            ptr = self._lib.gr4_ring_read(self._h, reader, max_n * self.itemsize,
                                          ctypes.byref(avail))
            cnt = avail.value // self.itemsize
            if not ptr or cnt == 0:
                return np.empty(0, self.dtype)
            off = (ptr - self._base) // self.itemsize
            return self._view[off:off + cnt]
        with self._lock:
            tail = self._tails[reader]
            n = self._head - tail
            if max_n:
                n = min(n, max_n)
            if n == 0:
                return np.empty(0, self.dtype)
            start = tail & (self.capacity - 1)
            if start + n <= self.capacity:
                return self._buf[start:start + n]
            return np.concatenate([self._buf[start:], self._buf[: n - (self.capacity - start)]])

    def release(self, reader: int, n: int) -> None:
        if self._h is not None:
            self._lib.gr4_ring_release(self._h, reader, n * self.itemsize)
            return
        with self._lock:
            self._tails[reader] += n

    def readable(self, reader: int) -> int:
        if self._h is not None:
            return self._lib.gr4_ring_readable(self._h, reader) // self.itemsize
        with self._lock:
            return self._head - self._tails[reader]

    def writable(self) -> int:
        if self._h is not None:
            return self._lib.gr4_ring_writable(self._h) // self.itemsize
        with self._lock:
            return self.capacity - (self._head - min(self._tails,
                                                     default=self._head))

    # -- blocking waits (≈ BlockingWaitStrategy, WaitStrategy.hpp:54) ----------
    def wait_readable(self, reader: int, n: int, timeout: float = 30.0) -> int:
        """Park in the kernel (futex) until ≥ n items are readable.

        Returns 1 = satisfied, 0 = EOS first (partial data may remain),
        -1 = timed out. Falls back to a sleep loop on the pure-python ring.
        """
        if self._h is not None:
            return _lib_blocking.gr4_ring_wait_readable(
                self._h, reader, n * self.itemsize, int(timeout * 1e6))
        import time as _t
        deadline = _t.monotonic() + timeout
        while self.readable(reader) < n:
            if self.eos:
                return 0
            if _t.monotonic() > deadline:
                return -1
            _t.sleep(1e-3)
        return 1

    def wait_writable(self, n: int, timeout: float = 30.0) -> int:
        """Park until ≥ n items of free space (1/0/-1 as wait_readable)."""
        if self._h is not None:
            return _lib_blocking.gr4_ring_wait_writable(
                self._h, n * self.itemsize, int(timeout * 1e6))
        import time as _t
        deadline = _t.monotonic() + timeout
        while self.writable() < n:
            if self.eos:
                return 0
            if _t.monotonic() > deadline:
                return -1
            _t.sleep(1e-3)
        return 1

    # -- EOS -------------------------------------------------------------------
    def set_eos(self) -> None:
        self._eos = True
        if self._h is not None:
            self._lib.gr4_ring_set_eos(self._h)

    @property
    def eos(self) -> bool:
        if self._h is not None:
            return bool(self._lib.gr4_ring_eos(self._h))
        return self._eos

    def __del__(self):
        h = getattr(self, "_h", None)
        if h and self._lib is not None:
            try:
                self._lib.gr4_ring_destroy(h)
            except Exception:
                pass
            self._h = None

    @property
    def is_native(self) -> bool:
        return self._h is not None
