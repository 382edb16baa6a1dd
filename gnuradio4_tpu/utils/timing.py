"""Wall-clock timing of device work, ended by ``block_until_ready``.

The one yardstick for the scripts that time the package (``chip_smoke.py``,
``bench_suite.py``, ``scripts/``): JAX returns before the device finishes, so
every window here ends in ``jax.block_until_ready``.
"""

from __future__ import annotations

import statistics
import time
from typing import Any, Callable


def run_scheduler_timed(sched: Any) -> dict:
    """Drive an initialised ``Scheduler`` to EOS through ``step_once``.

    The first dispatch carries the compile and is left out of the rate. The
    scheduler counts logical steps (a ``batch_steps=S`` dispatch advances it
    by S), so ``step_s`` is wall seconds per logical step and ``compile_s``
    subtracts the whole first dispatch (``first_steps`` logical steps) from
    its wall time."""
    import jax
    t0 = time.perf_counter()
    more = sched.step_once()
    jax.block_until_ready(sched._states)
    first = time.perf_counter() - t0
    n0 = sched._step
    t1 = time.perf_counter()
    while more:
        more = sched.step_once()
    jax.block_until_ready(sched._states)
    rest = time.perf_counter() - t1
    steps = sched._step - n0
    step_s = rest / max(steps, 1)
    return {"compile_s": max(first - n0 * step_s, 0.0), "step_s": step_s,
            "first_steps": n0, "timed_steps": steps}


def median_call_s(fn: Callable, *args: Any, reps: int = 5,
                  inner: int = 10) -> float:
    """Median wall seconds per call of a jitted ``fn(*args)``: two warm-up
    calls, then ``reps`` windows of ``inner`` calls, each window ended by
    ``block_until_ready``."""
    import jax
    jax.block_until_ready(fn(*args))
    jax.block_until_ready(fn(*args))
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(inner):
            out = fn(*args)
        jax.block_until_ready(out)
        walls.append((time.perf_counter() - t0) / inner)
    return statistics.median(walls)
