"""ctypes bindings for the native sample-format converters (numpy fallback)."""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from .build import build_library

_HERE = Path(__file__).resolve().parent
_SO = _HERE / "libgr4convert.so"
_lib = None
_lock = threading.Lock()


def build_native(force: bool = False) -> bool:
    """Compile convert.cpp → libgr4convert.so (rebuilt when the source is
    newer). Returns success."""
    with _lock:
        return build_library(_HERE / "convert.cpp", _SO, force)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not build_native():  # mtime-checked: rebuilds BEFORE the first dlopen
        return None
    try:
        lib = ctypes.CDLL(str(_SO))
    except OSError:
        return None
    i16p = np.ctypeslib.ndpointer(np.int16, flags="C")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
    for name, argtypes in {
        "gr4_i16_to_f32": [i16p, f32p, ctypes.c_size_t, ctypes.c_float],
        "gr4_u8_to_f32": [u8p, f32p, ctypes.c_size_t, ctypes.c_float],
        "gr4_i16iq_to_c64": [i16p, f32p, ctypes.c_size_t, ctypes.c_float],
        "gr4_u8iq_to_c64": [u8p, f32p, ctypes.c_size_t, ctypes.c_float],
        "gr4_f32_to_i16": [f32p, i16p, ctypes.c_size_t, ctypes.c_float],
        "gr4_deinterleave_f32": [f32p, f32p, f32p, ctypes.c_size_t],
    }.items():
        getattr(lib, name).argtypes = argtypes
    _lib = lib
    return lib


def native_available() -> bool:
    return _load() is not None


def i16_to_f32(x: np.ndarray, scale: float = 1.0 / 32768.0) -> np.ndarray:
    x = np.ascontiguousarray(x, np.int16)
    lib = _load()
    if lib is None:
        return x.astype(np.float32) * np.float32(scale)
    y = np.empty(x.size, np.float32)
    lib.gr4_i16_to_f32(x.ravel(), y, x.size, scale)
    return y.reshape(x.shape)


def u8_to_f32(x: np.ndarray, scale: float = 1.0 / 127.5) -> np.ndarray:
    x = np.ascontiguousarray(x, np.uint8)
    lib = _load()
    if lib is None:
        return (x.astype(np.float32) - 127.5) * np.float32(scale)
    y = np.empty(x.size, np.float32)
    lib.gr4_u8_to_f32(x.ravel(), y, x.size, scale)
    return y.reshape(x.shape)


def i16iq_to_c64(x: np.ndarray, scale: float = 1.0 / 32768.0) -> np.ndarray:
    x = np.ascontiguousarray(x, np.int16).ravel()
    n = x.size // 2
    lib = _load()
    if lib is None:
        f = x.astype(np.float32) * np.float32(scale)
        return (f[0::2] + 1j * f[1::2]).astype(np.complex64)
    y = np.empty(2 * n, np.float32)
    lib.gr4_i16iq_to_c64(x[: 2 * n], y, n, scale)
    return y.view(np.complex64)


def u8iq_to_c64(x: np.ndarray, scale: float = 1.0 / 127.5) -> np.ndarray:
    x = np.ascontiguousarray(x, np.uint8).ravel()
    n = x.size // 2
    lib = _load()
    if lib is None:
        f = (x.astype(np.float32) - 127.5) * np.float32(scale)
        return (f[0::2] + 1j * f[1::2]).astype(np.complex64)
    y = np.empty(2 * n, np.float32)
    lib.gr4_u8iq_to_c64(x[: 2 * n], y, n, scale)
    return y.view(np.complex64)


def f32_to_i16(x: np.ndarray, scale: float = 32767.0) -> np.ndarray:
    x = np.ascontiguousarray(x, np.float32)
    lib = _load()
    if lib is None:
        return np.clip(np.round(x * scale), -32768, 32767).astype(np.int16)
    y = np.empty(x.size, np.int16)
    lib.gr4_f32_to_i16(x.ravel(), y, x.size, scale)
    return y.reshape(x.shape)
