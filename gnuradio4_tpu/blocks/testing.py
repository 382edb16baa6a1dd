"""Deterministic test/instrumentation blocks.

≈ reference blocks/testing/: NullSource/NullSink, ConstantSource, CountingSource,
CountingSink, Copy, HeadBlock, VectorSource/VectorSink, TagSource/TagSink/TagMonitor,
Delay, SlowSource, PerformanceMonitor (NullSources.hpp, TagMonitors.hpp, Delay.hpp,
CollectionTestBlocks.hpp, PerformanceMonitor.hpp). These drive the golden-value test
strategy (SURVEY §4): deterministic sources → block under test → capturing sinks.
"""

from __future__ import annotations

import time
from typing import Any, ClassVar

import jax
import jax.numpy as jnp
import numpy as np

from ..core.block import Block, BlockCtx, Port, SinkBlock, SourceBlock
from ..core.errors import GrError
from ..core.registry import register_block
from ..core.settings import Setting
from ..core.stream import canonical_dtype
from ..core.tags import Tag, TagPropagation


@register_block("NullSource")
class NullSource(SourceBlock):
    """Zeros forever (≈ NullSource, NullSources.hpp)."""

    OUT = (Port("out"),)
    dtype = Setting(default="float32", kind="static", description="sample dtype")
    channels = Setting(default=0, kind="static", description="0 → 1-D stream")

    def out_channels(self, port, in_channels):
        return int(self.settings.get("channels"))

    def out_dtype(self, port, in_dtypes):
        return self.settings.get("dtype")

    def apply(self, state, ins, ctx):
        n = ctx.out_len["out"]
        ch = ctx.channels["out"]
        shape = (n,) if ch == 0 else (ch, n)
        return state, {"out": jnp.zeros(shape, canonical_dtype(self.settings.get("dtype")))}


@register_block("ConstantSource")
class ConstantSource(SourceBlock):
    OUT = (Port("out"),)
    value = Setting(default=1.0, description="constant sample value")
    dtype = Setting(default="float32", kind="static")
    channels = Setting(default=0, kind="static")
    n_samples = Setting(default=0, kind="static",
                        description="stop after N samples (0 = unbounded)")

    def out_channels(self, port, in_channels):
        return int(self.settings.get("channels"))

    def out_dtype(self, port, in_dtypes):
        return self.settings.get("dtype")

    def host_done(self, abs_out, n):
        total = int(self.settings.get("n_samples"))
        if total and abs_out + n >= total:
            return max(0, total - abs_out)
        return None

    def apply(self, state, ins, ctx):
        n = ctx.out_len["out"]
        ch = ctx.channels["out"]
        shape = (n,) if ch == 0 else (ch, n)
        dt = canonical_dtype(self.settings.get("dtype"))
        v = jnp.asarray(ctx.p("value", 1.0)).astype(dt)
        return state, {"out": jnp.broadcast_to(v, shape).astype(dt)}


@register_block("CountingSource")
class CountingSource(SourceBlock):
    """0,1,2,… ramp (≈ CountingSource). State = int64-ish counter kept as two u32? —
    a single f64-free int32 counter wraps at 2³¹; we carry uint32 lo/hi words."""

    OUT = (Port("out"),)
    dtype = Setting(default="float32", kind="static")
    n_samples = Setting(default=0, kind="static", description="0 = unbounded")
    start = Setting(default=0.0, description="first value")
    step = Setting(default=1.0, description="increment per sample")

    def out_dtype(self, port, in_dtypes):
        return self.settings.get("dtype")

    def init_state(self, ctx):
        return jnp.zeros((), jnp.uint32)  # block counter (steps, not samples)

    def host_done(self, abs_out, n):
        total = int(self.settings.get("n_samples"))
        if total and abs_out + n >= total:
            return max(0, total - abs_out)
        return None

    def apply(self, state, ins, ctx):
        n = ctx.out_len["out"]
        dt = canonical_dtype(self.settings.get("dtype"))
        base = state.astype(jnp.float32) * jnp.float32(n)
        idx = jax.lax.broadcasted_iota(jnp.float32, (n, 1), 0)[:, 0] + base
        out = (jnp.asarray(ctx.p("start", 0.0), jnp.float32)
               + idx * jnp.asarray(ctx.p("step", 1.0), jnp.float32))
        return state + jnp.uint32(1), {"out": out.astype(dt)}


@register_block("VectorSource")
class VectorSource(SourceBlock):
    """Plays back a host array once (or repeated); ≈ VectorSource qa helper.

    ``device_resident=True`` uploads the array ONCE, into the block's carried
    state at ``init_states`` (not as a jit constant, which would embed the
    whole array in the program), and each step slices it on-device — no
    per-step host→device feed. This is the accelerator analog of the reference's
    mmap'd file playback (BasicFileIo.hpp): the data plane stays on the
    device, the host only paces steps. EOS/partial-final-step semantics,
    tags, repeat, and sp-sharding (replicated-island default) are identical
    to the host-feed path (pinned by tests/test_device_vector_source.py)."""

    OUT = (Port("out"),)
    FEED = True
    repeat = Setting(default=False, kind="static")
    device_resident = Setting(default=False, kind="static",
                              description="upload the array once into the "
                                          "block's carried state; per-step "
                                          "on-device slice instead of host "
                                          "feeds")

    def __init__(self, data: Any = (), name: str | None = None, tags: list[Tag] = (),
                 **settings: Any):
        super().__init__(name=name, **settings)
        self.data = np.asarray(data)
        self.tags = list(tags)
        if self.settings.get("device_resident"):
            self.FEED = False          # instance attr shadows the class flag

    def out_channels(self, port, in_channels):
        return 0 if self.data.ndim <= 1 else self.data.shape[0]

    def out_dtype(self, port, in_dtypes):
        return self.data.dtype

    def host_feed(self, n, abs_index):
        total = self.data.shape[-1]
        if self.settings.get("repeat"):
            idx = (np.arange(abs_index, abs_index + n) % total)
            return {"out": self.data[..., idx]}, n
        if abs_index >= total:
            return None
        chunk = self.data[..., abs_index:abs_index + n]
        return {"out": chunk}, chunk.shape[-1]

    def host_done(self, abs_out, n):
        # EOS for the device-resident path (the FEED path signals EOS by
        # returning None from host_feed instead)
        if not self.settings.get("device_resident") \
                or self.settings.get("repeat"):
            return None
        total = self.data.shape[-1]
        if abs_out + n >= total:
            return max(0, total - abs_out)
        return None

    def init_state(self, ctx):
        if not self.settings.get("device_resident"):
            return None
        # the data rides in STATE (one host→device upload at init_states,
        # then donated through every step) rather than as a jit constant —
        # a constant would embed the whole array in the HLO and balloon
        # compile time/size for big recordings
        if self.settings.get("repeat"):
            payload = self.data
        else:
            # zero-pad up to a whole block so the final partial step's valid
            # prefix stays aligned (dynamic_slice would otherwise CLAMP the
            # start and shift the data; the scheduler's n_valid masks the
            # tail)
            n = ctx.out_len["out"]
            pad = (-self.data.shape[-1]) % n
            payload = np.pad(self.data,
                             [(0, 0)] * (self.data.ndim - 1) + [(0, pad)])
        return {"idx": jnp.zeros((), jnp.int32), "data": jnp.asarray(payload)}

    def emit_tags(self, ctx):
        lo, hi = ctx.abs_index, ctx.abs_index + next(iter(ctx.out_len.values()), 0)
        return [t.shifted(-lo) for t in self.tags if lo <= t.index < hi]

    def apply(self, state, ins, ctx):
        if not self.settings.get("device_resident"):
            return state, {"out": ins["out"]}
        n = ctx.out_len["out"]
        idx, data = state["idx"], state["data"]
        total = self.data.shape[-1]
        if self.settings.get("repeat"):
            # modular gather (repeat wraps mid-block in general)
            take = (idx + jnp.arange(n, dtype=jnp.int32)) % jnp.int32(total)
            out = jnp.take(data, take, axis=-1)
            nxt = (idx + jnp.int32(n)) % jnp.int32(total)
        else:
            out = jax.lax.dynamic_slice_in_dim(data, idx, n, axis=-1)
            nxt = idx + jnp.int32(n)
        return {"idx": nxt, "data": data}, {"out": out}


@register_block("VectorSink")
class VectorSink(SinkBlock):
    """Captures everything (host list → np.concatenate); ≈ VectorSink qa helper."""

    IN = (Port("in"),)

    def __init__(self, name: str | None = None, **settings):
        super().__init__(name=name, **settings)
        self._chunks: list[np.ndarray] = []
        self.tags: list[Tag] = []
        self._n = 0

    def consume(self, arrays, tags, n_valid, abs_index):
        a = arrays["in"][..., :n_valid]
        if n_valid:
            self._chunks.append(a)
        for t in tags.get("in", []):
            if t.index <= n_valid:  # keep in-range tags incl. EOS at the boundary
                self.tags.append(t.shifted(abs_index))
        self._n += n_valid

    def data(self) -> np.ndarray:
        if not self._chunks:
            return np.zeros(0)
        return np.concatenate(self._chunks, axis=-1)

    def clear(self):
        self._chunks.clear()
        self.tags.clear()
        self._n = 0


@register_block("NullSink")
class NullSink(SinkBlock):
    IN = (Port("in"),)
    WANTS_HOST_DATA = False  # count only — no device→host copy
    CONSUME_IGNORES_DATA = True  # counters never read array contents

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self.count = 0

    def consume(self, arrays, tags, n_valid, abs_index):
        self.count += n_valid


@register_block("CountingSink")
class CountingSink(NullSink):
    """Counts valid samples (≈ CountingSink)."""


@register_block("Copy")
class Copy(Block):
    """Identity (≈ Copy block) — useful to test fusion/scheduling."""

    IN = (Port("in"),)
    OUT = (Port("out"),)

    def apply(self, state, ins, ctx):
        return state, {"out": ins["in"]}


@register_block("HeadBlock")
class HeadBlock(Block):
    """Pass the first N samples, then end the stream (≈ HeadBlock): the runtime
    clamps valid counts mid-graph and winds the graph down once exhausted."""

    IN = (Port("in"),)
    OUT = (Port("out"),)
    n_samples = Setting(default=1024, kind="static")
    terminate_graph_when_done = True

    def apply(self, state, ins, ctx):
        return state, {"out": ins["in"]}

    def clamp_valid(self, n_valid_out, abs_out):
        total = int(self.settings.get("n_samples"))
        return max(0, min(n_valid_out, total - abs_out))


@register_block("Delay")
class Delay(Block):
    """Integer-sample delay (≈ Delay.hpp): carries the last D samples as state."""

    IN = (Port("in"),)
    OUT = (Port("out"),)
    delay = Setting(default=0, kind="static", limits=(0, 2 ** 31),
                    description="delay in samples")

    def init_state(self, ctx):
        d = int(self.settings.get("delay"))
        ch = ctx.channels.get("in", 0)
        shape = (d,) if ch == 0 else (ch, d)
        return jnp.zeros(shape, ctx.dtype("in", jnp.float32))

    def apply(self, state, ins, ctx):
        x = ins["in"]
        d = int(self.settings.get("delay"))
        if d == 0:
            return state, {"out": x}
        buf = state.astype(x.dtype)
        xc = jnp.concatenate([buf, x], axis=-1)
        y = xc[..., :x.shape[-1]]
        return xc[..., -d:], {"out": y}

    def process_tags(self, in_tags, ctx):
        d = int(self.settings.get("delay"))
        out = {}
        for p, tags in in_tags.items():
            out["out"] = [t.shifted(d) for t in tags]
        return out


@register_block("TagSource")
class TagSource(SourceBlock):
    """Emits a constant stream + user-scheduled tags at absolute indices
    (≈ TagSource, TagMonitors.hpp)."""

    OUT = (Port("out"),)
    value = Setting(default=0.0)
    n_samples = Setting(default=0, kind="static")

    def __init__(self, tags: list[Tag] = (), name=None, **settings):
        super().__init__(name=name, **settings)
        self.scheduled = sorted(tags)

    def host_done(self, abs_out, n):
        total = int(self.settings.get("n_samples"))
        if total and abs_out + n >= total:
            return max(0, total - abs_out)
        return None

    def emit_tags(self, ctx):
        n = next(iter(ctx.out_len.values()), 0)
        lo, hi = ctx.abs_index, ctx.abs_index + n
        return [t.shifted(-lo) for t in self.scheduled if lo <= t.index < hi]

    def apply(self, state, ins, ctx):
        n = ctx.out_len["out"]
        v = jnp.asarray(ctx.p("value", 0.0), jnp.float32)
        return state, {"out": jnp.broadcast_to(v, (n,))}


@register_block("TagSink")
class TagSink(VectorSink):
    """VectorSink that is primarily inspected for received tags (≈ TagSink)."""


@register_block("TagMonitor")
class TagMonitor(Block):
    """Pass-through recording tags it sees (≈ TagMonitor)."""

    IN = (Port("in"),)
    OUT = (Port("out"),)

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self.observed: list[Tag] = []

    def apply(self, state, ins, ctx):
        return state, {"out": ins["in"]}

    def process_tags(self, in_tags, ctx):
        for t in in_tags.get("in", []):
            self.observed.append(t.shifted(ctx.abs_index))
        return {"out": list(in_tags.get("in", []))}


@register_block("SlowSource")
class SlowSource(ConstantSource):
    """Wall-clock-throttled source (≈ SlowSource, NullSources.hpp): sleeps
    ``delay_s`` per feed step to simulate a slow producer."""

    delay_s = Setting(default=0.01, limits=(0.0, 10.0))

    def host_done(self, abs_out, n):
        time.sleep(float(self.settings.get("delay_s")))
        return super().host_done(abs_out, n)


@register_block("SimCompute")
class SimCompute(Block):
    """Simulated compute load: N fused multiply-adds per sample (≈ SimCompute with
    target_throughput; here the knob is explicit ops/sample)."""

    IN = (Port("in"),)
    OUT = (Port("out"),)
    ops_per_sample = Setting(default=64, kind="static", limits=(1, 1 << 20))

    def apply(self, state, ins, ctx):
        x = ins["in"]
        k = int(self.settings.get("ops_per_sample"))
        def body(i, acc):
            return acc * jnp.asarray(1.0000001, x.dtype) + jnp.asarray(1e-9, x.dtype)
        y = jax.lax.fori_loop(0, k, body, x)
        return state, {"out": y}


@register_block("PerformanceMonitor")
class PerformanceMonitor(SinkBlock):
    """Measures delivered samples/s at its input (≈ PerformanceMonitor.hpp)."""

    IN = (Port("in"),)
    WANTS_HOST_DATA = False
    CONSUME_IGNORES_DATA = True   # rate metering never reads contents

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self.n = 0
        self.t0: float | None = None
        self.t_last: float | None = None

    def consume(self, arrays, tags, n_valid, abs_index):
        now = time.monotonic()
        if self.t0 is None:
            self.t0 = now
        self.t_last = now
        self.n += n_valid

    @property
    def samples_per_second(self) -> float:
        if self.t0 is None or self.t_last is None or self.t_last <= self.t0:
            return 0.0
        return self.n / (self.t_last - self.t0)


@register_block("SettingsChangeRecorder")
class SettingsChangeRecorder(Block):
    """Pass-through that scales by ``scaling_factor`` and records every applied
    settings change (≈ reference SettingsChangeRecorder test block) — used to
    assert staged→applied timing, tag auto-update, and context switches.

    ``recorded`` holds ``(step_or_None, {key: new_value})`` in apply order.
    """

    IN = (Port("in"),)
    OUT = (Port("out"),)
    scaling_factor = Setting(default=1.0, kind="dynamic")
    context = Setting(default="", kind="static")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self.recorded: list[tuple[int | None, dict]] = []
        self._step = 0

    def apply(self, state, ins, ctx):
        return state, {"out": ins["in"] * ctx.params["scaling_factor"]}

    def on_settings_applied(self, res) -> None:
        if res.applied:
            self.recorded.append((self._step, dict(res.applied)))

    def process_tags(self, in_tags, ctx):
        self._step = ctx.step
        return super().process_tags(in_tags, ctx)


@register_block("ArraySource")
class ArraySource(SourceBlock):
    """Multi-port playback source: one host array per output port
    (≈ ArraySource qa helper, CollectionTestBlocks.hpp). All arrays must share
    the trailing (time) length; ports are named out0..outN-1."""

    OUT = ()
    FEED = True
    repeat = Setting(default=False, kind="static")

    def __init__(self, arrays=(), name=None, **settings):
        super().__init__(name=name, **settings)
        self.arrays = [np.asarray(a) for a in arrays]
        if not self.arrays:
            raise GrError("ArraySource needs at least one array")
        if len({a.shape[-1] for a in self.arrays}) != 1:
            raise GrError("ArraySource arrays must share the time length")
        self.out_ports = tuple(Port(f"out{i}") for i in range(len(self.arrays)))

    def out_dtype(self, port, in_dtypes):
        return self.arrays[int(port[3:])].dtype

    def out_channels(self, port, in_channels):
        a = self.arrays[int(port[3:])]
        return 0 if a.ndim <= 1 else a.shape[0]

    def host_feed(self, n, abs_index):
        total = self.arrays[0].shape[-1]
        if self.settings.get("repeat"):
            idx = (np.arange(abs_index, abs_index + n) % total)
            return {f"out{i}": a[..., idx] for i, a in enumerate(self.arrays)}, n
        if abs_index >= total:
            return None
        out = {f"out{i}": a[..., abs_index:abs_index + n]
               for i, a in enumerate(self.arrays)}
        return out, self.arrays[0][..., abs_index:abs_index + n].shape[-1]

    def apply(self, state, ins, ctx):
        return state, dict(ins)


@register_block("ArraySink")
class ArraySink(SinkBlock):
    """Multi-port collecting sink: captures each input port into its own list
    (≈ ArraySink qa helper). ``data(i)`` returns port i's concatenated stream."""

    IN = ()

    def __init__(self, n_inputs: int = 1, name=None, **settings):
        super().__init__(name=name, **settings)
        self.in_ports = tuple(Port(f"in{i}") for i in range(int(n_inputs)))
        self._chunks: dict[str, list[np.ndarray]] = \
            {p.name: [] for p in self.in_ports}

    def consume(self, arrays, tags, n_valid, abs_index):
        for pname, arr in arrays.items():
            if n_valid > 0:
                self._chunks[pname].append(np.asarray(arr[..., :n_valid]))

    def data(self, port: int = 0) -> np.ndarray:
        chunks = self._chunks[f"in{port}"]
        if not chunks:
            return np.zeros(0)
        return np.concatenate(chunks, axis=-1)
