"""Native (C++) runtime components.

``ringbuf.cpp`` — the double-mmapped lock-free ring (host data plane). Built on
demand into ``libgr4ring.so`` next to this file (:mod:`.build`; no binary is
committed); :mod:`.ring` wraps it via ctypes
with a pure-Python fallback, so the framework works before/without the toolchain.
"""

from .ring import HostRing, build_native, native_available
