"""Named thread-pool manager (≈ reference thread/thread_pool.hpp: BasicThreadPool
with TaskType{IO_BOUND, CPU_BOUND} and the global Manager singleton with named
pools, thread_pool.hpp:272,725).

In this framework CPU-bound sample work lives on the device, so the pools here
serve the HOST side: IO feeders (file/net/SDR readers), sink drains, and user
callbacks. Pools are named and lazily created; `io()` / `cpu()` return the two
conventional defaults. Also provides `spawn()` for the fire-and-forget daemon
threads the runtime uses (scheduler runner, watchdog, feeders) so they are
registered and enumerable — `active_threads()` answers "what is the framework
running right now?" the way the reference's Manager does.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable

_lock = threading.Lock()
_pools: dict[str, ThreadPoolExecutor] = {}
_spawned: list[threading.Thread] = []

DEFAULT_IO = "default_io"
DEFAULT_CPU = "default_cpu"


def pool(name: str, *, max_workers: int | None = None) -> ThreadPoolExecutor:
    """Get or create the named pool (≈ Manager::get, thread_pool.hpp:725)."""
    with _lock:
        p = _pools.get(name)
        if p is None:
            p = ThreadPoolExecutor(max_workers=max_workers,
                                   thread_name_prefix=f"gr4-{name}")
            _pools[name] = p
        return p


def io() -> ThreadPoolExecutor:
    """The IO-bound default pool (blocking reads/writes; generous workers)."""
    return pool(DEFAULT_IO, max_workers=16)


def cpu() -> ThreadPoolExecutor:
    """The CPU-bound default pool (host-side number crunching)."""
    import os
    return pool(DEFAULT_CPU, max_workers=max(2, (os.cpu_count() or 4) - 1))


def submit(name: str, fn: Callable[..., Any], /, *args, **kwargs) -> Future:
    return pool(name).submit(fn, *args, **kwargs)


def spawn(target: Callable[[], None], *, name: str, daemon: bool = True
          ) -> threading.Thread:
    """Start a registered daemon thread (runtime long-runners: feeders,
    scheduler runners, watchdogs)."""
    t = threading.Thread(target=target, daemon=daemon, name=name)
    with _lock:
        _spawned.append(t)
        _spawned[:] = [x for x in _spawned if x.is_alive() or x is t]
    t.start()
    return t


def active_threads() -> list[str]:
    """Names of live framework threads (spawned + pool workers)."""
    with _lock:
        alive = [t.name for t in _spawned if t.is_alive()]
    alive += [t.name for t in threading.enumerate()
              if t.name.startswith("gr4-")]
    return sorted(set(alive))


def shutdown_all(wait: bool = False) -> None:
    with _lock:
        pools = list(_pools.values())
        _pools.clear()
    for p in pools:
        p.shutdown(wait=wait)
