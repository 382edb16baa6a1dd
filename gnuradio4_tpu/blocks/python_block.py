"""User-function blocks (≈ reference blocks/basic PythonBlock.hpp:22 — embedded
CPython user blocks).

In a Python-first framework the "PythonBlock" degenerates to wrapping a user
callable. Two flavors:

- :class:`LambdaBlock` — pure jax function over the sample block (traced into the
  fused device program; the fast path);
- :class:`HostBlock` — arbitrary host NumPy function executed OUTSIDE the jitted
  step via ``jax.pure_callback`` (escape hatch for non-traceable code; slow path,
  device round-trip per step — same perf caveat as the reference's embedded
  interpreter).
"""

from __future__ import annotations

import threading

from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..core.block import Block, Port
from ..core.registry import register_block
from ..core.settings import Setting


@register_block("LambdaBlock")
class LambdaBlock(Block):
    """Wrap a pure jax function ``fn(x, ctx) -> y`` (or ``fn(x) -> y``)."""

    IN = (Port("in"),)
    OUT = (Port("out"),)

    def __init__(self, fn: Callable = None, name=None, n_inputs: int = 1,
                 **settings):
        super().__init__(name=name, **settings)
        if fn is None:
            fn = lambda x: x
        self.fn = fn
        if n_inputs != 1:
            self.in_ports = tuple(Port(f"in{i}") for i in range(n_inputs))

    def apply(self, state, ins, ctx):
        args = [ins[p.name] for p in self.in_ports]
        try:
            y = self.fn(*args, ctx=ctx)
        except TypeError:
            y = self.fn(*args)
        return state, {"out": y}


@register_block("HostBlock")
class HostBlock(Block):
    """Run a host NumPy function inside the traced step via pure_callback.

    ``fn(np.ndarray) -> np.ndarray`` must preserve shape/dtype (or declare
    ``out_shape_fn``). Every step pays a device↔host round-trip — use for
    prototyping only (same caveat as the reference's PythonBlock).
    """

    IN = (Port("in"),)
    OUT = (Port("out"),)

    def __init__(self, fn: Callable[[np.ndarray], np.ndarray] = None,
                 name=None, out_shape_fn: Callable | None = None, **settings):
        super().__init__(name=name, **settings)
        self.fn = fn or (lambda x: x)
        self.out_shape_fn = out_shape_fn

    def apply(self, state, ins, ctx):
        x = ins["in"]
        shape = jax.ShapeDtypeStruct(x.shape, x.dtype) if self.out_shape_fn is None \
            else self.out_shape_fn(x)
        y = jax.pure_callback(self.fn, shape, x, vmap_method="sequential")
        return state, {"out": y}


@register_block("PythonBlock")
class PythonBlock(Block):
    """Reference-parity user-source-code block (≈ blocks/basic PythonBlock.hpp:22,
    which embeds CPython+NumPy to run a user script per work() call).

    The ``code`` setting is Python source that must define
    ``process(x)`` (single in/out) or ``process(ins, ctx)`` (dict of arrays →
    dict of arrays). It executes with ``np``/``jnp``/``jax`` in scope. Like the
    reference, this runs *arbitrary user code* — it is a programming surface,
    not a sandbox.

    ``mode='jax'`` (default): ``process`` is traced into the fused device
    program (arrays are jnp tracers — the fast path). ``mode='host'``: runs as
    host NumPy via ``pure_callback``, shape/dtype-preserving (the slow path,
    same caveat as the reference's embedded interpreter).
    """

    IN = (Port("in"),)
    OUT = (Port("out"),)
    code = Setting(default="def process(x):\n    return x", kind="static")
    mode = Setting(default="jax", kind="static", choices=("jax", "host"))

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        ns: dict[str, Any] = {"np": np, "jnp": jnp, "jax": jax}
        exec(str(self.settings.get("code")), ns)          # noqa: S102 — the point
        fn = ns.get("process")
        if not callable(fn):
            from ..core.errors import GrError
            raise GrError(f"{self.name}: code must define a callable "
                          f"'process(x)' or 'process(ins, ctx)'")
        import inspect
        self._fn = fn
        self._two_arg = len(inspect.signature(fn).parameters) >= 2

    def _call(self, ins, ctx):
        if self._two_arg:
            out = self._fn(dict(ins), ctx)
            return out if isinstance(out, dict) else {"out": out}
        return {"out": self._fn(ins["in"])}

    def apply(self, state, ins, ctx):
        if str(self.settings.get("mode")) == "jax":
            return state, self._call(ins, ctx)
        from ..core.errors import GrError
        if self._two_arg:
            raise GrError(f"{self.name}: mode='host' supports the single-arg "
                          f"'process(x)' form only")
        x = ins["in"]
        y = jax.pure_callback(
            lambda a: np.asarray(self._fn(a)).astype(x.dtype),
            jax.ShapeDtypeStruct(x.shape, x.dtype), x,
            vmap_method="sequential")
        return state, {"out": y}


@register_block("StreamSource")
class StreamSource(Block):
    """Generic host-push streaming source: any thread calls :meth:`push` with
    sample arrays; the scheduler drains them through the lock-free host ring
    (native/ringbuf.cpp ≈ reference CircularBuffer.hpp). Call :meth:`close`
    to signal end-of-stream.

    This is the programmatic twin of FileSource/SdrSource for data that
    originates in the user's own Python code (network handlers, simulators,
    test harnesses)::

        src = g.emplace("StreamSource", dtype="complex64")
        ...
        src.push(samples)        # from any thread, before or during run
        src.close()              # flowgraph drains remaining data, then stops
    """

    IN = ()
    OUT = (Port("out"),)
    FEED = True
    dtype = Setting(default="float32", kind="static",
                    choices=("float32", "complex64", "int32", "int16", "uint8"))
    capacity = Setting(default=1 << 20, kind="static")   # ring items
    timeout = Setting(default=30.0, kind="static")       # starvation limit (s)
    wait = Setting(default="sleep", kind="static",
                   choices=("spin", "yield", "sleep", "block"))

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._ring = None
        self._reader = None
        self._ring_lock = threading.Lock()

    def _ensure_ring(self):
        # user threads (push/close) race the scheduler thread (host_feed) for
        # first touch — without the lock each side can build its own ring and
        # the producer's data lands in an orphan
        with self._ring_lock:
            if self._ring is None:
                from ..native.ring import HostRing
                ring = HostRing(int(self.settings.get("capacity")),
                                np.dtype(str(self.settings.get("dtype"))))
                self._reader = ring.add_reader()
                self._ring = ring
        return self._ring

    # -- producer side (user threads) ------------------------------------------
    def push(self, data, *, block: bool = True, timeout: float = 10.0) -> int:
        """Queue samples for the flowgraph. Returns items accepted (may be short
        only when ``block=False`` or on timeout against a stalled graph)."""
        ring = self._ensure_ring()
        if ring.eos:
            from ..core.errors import GrError
            raise GrError(f"{self.name}: push() after close()")
        return ring.write(np.asarray(data), block=block, timeout=timeout)

    def close(self) -> None:
        """Mark end-of-stream; the graph stops once the ring drains."""
        self._ensure_ring().set_eos()

    # -- scheduler side --------------------------------------------------------
    def host_feed(self, n, abs_index):
        from ..core.feeder import read_exact
        self._ensure_ring()
        if n > self._ring.capacity:
            from ..core.errors import GrError
            raise GrError(
                f"{self.name}: ring capacity {self._ring.capacity} < scheduler "
                f"block_len {n}; raise the 'capacity' setting")
        got = read_exact(self._ring, self._reader, n,
                         timeout=float(self.settings.get("timeout")),
                         wait=str(self.settings.get("wait")))
        if got is None:
            return None
        return {"out": got}, len(got)

    def out_dtype(self, port, in_dtypes):
        return np.dtype(str(self.settings.get("dtype")))

    def apply(self, state, ins, ctx):
        return state, {"out": ins["out"]}
