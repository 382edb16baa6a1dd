"""Build the native libraries from their C++ sources on the machine that
runs them. No binary is shipped: each ``.so`` is compiled at first use next
to its source (or wherever the caller asks) and rebuilt when the source is
newer."""

from __future__ import annotations

import os
import subprocess
from pathlib import Path


def build_library(src: Path, so: Path, force: bool = False) -> bool:
    """Compile ``src`` into the shared library ``so``; returns success.

    Idempotent: an ``so`` at least as new as ``src`` is kept. The compiler
    writes a private temporary that is renamed into place, so concurrent
    builders (test workers) never load a half-written library. Portable
    flags only: the library never carries another host's instruction set."""
    src, so = Path(src), Path(so)
    if so.exists() and not force and so.stat().st_mtime >= src.stat().st_mtime:
        return True
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f".{so.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++20",
                        str(src), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.SubprocessError):   # no g++, compile error
        tmp.unlink(missing_ok=True)
        return False
