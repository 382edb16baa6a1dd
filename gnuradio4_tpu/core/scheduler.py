"""Host streaming scheduler (L3).

Reference (core/include/gnuradio-4.0/Scheduler.hpp): thread-pool workers round-robin
``block->work()`` over job lists, with lifecycle FSM, message pumping between stream
work, watchdog, zombie cleanup and runtime graph mutation.

Device-native inversion: the device does all the stream compute in one fused jitted step
(compiler.py); the scheduler is a thin host pump that per step

  1. drains the message plane (settings get/set, lifecycle, graph mutation),
  2. applies staged settings — dynamic ones land as new param arrays (no recompile),
     static/structural ones mark the graph dirty and re-jit at the step boundary
     (the analog of the reference renegotiating chunks each work() call),
  3. feeds host-fed sources (double-buffered device_put ≈ the ring between producer
     and compute),
  4. dispatches the jitted step (JAX async dispatch pipelines step i+1 behind i),
  5. advances the host tag sideband in topological order,
  6. drains device→host sink arrays a few steps behind dispatch (pipeline_depth).

Lifecycle, pause/resume, EOS propagation and the watchdog mirror the reference's
semantics (Scheduler.hpp:515 runAndWait, :845 watchdog).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from fractions import Fraction
from typing import Any

import jax
import numpy as np

from .block import Block, HostCtx, SinkBlock
from .compiler import CompiledGraph, compile_graph
from .errors import Error, GrError
from .graph import Graph
from .lifecycle import State, StateMachine
from .messages import Command, Message, MessageBus, Property
from .registry import register_scheduler
from .tags import Keys, Tag


@dataclasses.dataclass
class _SubStep:
    """Per-sub-step host bookkeeping of a batched dispatch (batch_steps > 1)."""
    step: int
    sink_tags: dict[str, dict[str, list[Tag]]]
    n_valid: dict[str, int]
    abs_in: dict[str, int]
    n_valid_ports: dict[str, dict[str, int]]


@dataclasses.dataclass
class _InFlight:
    step: int
    sink_ins: dict[str, dict[str, Any]]
    sink_tags: dict[str, dict[str, list[Tag]]]
    n_valid: dict[str, int]
    abs_in: dict[str, int]
    t_dispatch: float
    n_valid_ports: dict[str, dict[str, int]] = dataclasses.field(
        default_factory=dict)   # PER_PORT_VALID sinks: per-port counts
    batch: list[_SubStep] | None = None   # batched dispatch: sink_ins leaves
                                          # carry a leading [S] axis


class Scheduler:
    """Single jitted-program streaming scheduler (≈ gr::scheduler::Simple)."""

    def __init__(self, graph: Graph, *, block_len: int = 1 << 16,
                 sample_rate: float = 1.0, mesh: Any = None,
                 pipeline_depth: int = 2, profiler: Any = None,
                 watchdog_timeout: float | None = None,
                 watchdog_action: str = "notify",
                 max_tags_per_step: int = 64, name: str = "scheduler",
                 on_block_error: str = "shutdown",
                 async_delivery: bool = False, batch_steps: int = 1):
        self.name = name
        self.graph = graph
        self.block_len = block_len
        self.sample_rate = sample_rate
        self.mesh = mesh
        # step batching: fuse S sub-steps into one jitted dispatch (lax.scan)
        # to amortize the per-dispatch host floor (≈ the reference
        # amortizing per-work() overhead in its hot loop, Scheduler.hpp:722).
        # Semantics at batch granularity: STATIC/structural settings changes
        # and block state resets staged mid-batch take effect at the next
        # super-step boundary (up to S-1 logical steps late); tag-accurate
        # SAMPLE_ACCURATE ramps and dynamic settings changes still hit their
        # exact sub-block via per-sub-step param overlays.
        self.batch_steps = int(batch_steps)
        if self.batch_steps < 1:
            raise GrError(f"batch_steps must be >= 1, got {batch_steps}")
        # multi-host (multi-controller jax): every process runs this same
        # scheduler; feeds are assembled into global arrays from per-process
        # local time shards, sinks drain only addressable shards
        self._multihost = mesh is not None and jax.process_count() > 1
        if self._multihost and set(getattr(mesh, "axis_names", ())) != {"sp"}:
            raise GrError("multi-host scheduling currently requires a mesh "
                          "with exactly the 'sp' (time) axis spanning all "
                          "processes")
        self.pipeline_depth = max(1, pipeline_depth)
        from .profiler import NullProfiler
        self.profiler = profiler if profiler is not None else NullProfiler()
        self.watchdog_timeout = watchdog_timeout
        self.watchdog_action = watchdog_action  # 'notify' | 'stop'
        self.max_tags_per_step = max_tags_per_step
        # 'shutdown' (default): any block failure stops the whole graph;
        # 'prune': failed blocks go zombie — they and their dependent branch
        # are removed, the rest of the graph re-jits and keeps streaming
        # (≈ reference cleanupZombieBlocks, Scheduler.hpp:1210-1217)
        if on_block_error not in ("shutdown", "prune"):
            raise GrError("on_block_error must be 'shutdown' or 'prune'")
        self.on_block_error = on_block_error
        self.zombies: list[str] = []   # names of pruned blocks

        self.fsm = StateMachine()
        self.bus = MessageBus()
        # every lifecycle transition notifies the message plane — the
        # reference's setAndNotifyState publishing kLifecycleState
        # (qa_Messages.cpp:789 "Subscribe to scheduler lifecycle messages")
        for _st in State:
            self.fsm.on(_st, (lambda s: lambda: self.bus.notify(
                self.name, Property.LIFECYCLE_STATE, {"state": s.value}))(_st))
        self.compiled: CompiledGraph | None = None
        self._states: dict[str, Any] = {}
        self._dirty = True            # needs (re)compile
        self._step = 0
        self._abs_in: dict[str, int] = {}   # block → absolute input-sample counter
        self._abs_out: dict[str, int] = {}
        self._pending_out_tags: dict[tuple[str, str], list[Tag]] = {}
        self._tag_ramps: dict[str, list] = {}   # uname → tag-settings events
        self._finished_sources: set[str] = set()
        self._eos_announced: set[str] = set()
        self._drain_steps = 0
        self._inflight: collections.deque[_InFlight] = collections.deque()
        # async delivery (≈ reference DataSink poller threads,
        # DataSink.hpp:21-37 Backpressure): sink D2H + consume run on ONE
        # dedicated worker (FIFO order preserved) so the pump never blocks
        # on device→host latency — inline delivery would serialize each
        # readback with the next dispatch.
        # Opt-in: delivery errors are deferred to the pump thread, and
        # graphs where a feed depends on a delivery (ring-bridged
        # subgraphs, any block with both FEED and consume) must stay sync.
        self.async_delivery = bool(async_delivery)
        self._dq: Any = None
        self._dworker: threading.Thread | None = None
        self._deferred_errors: list = []
        self._runner: threading.Thread | None = None
        self._watchdog: threading.Thread | None = None
        # step-boundary lock: held for the whole of _pump_once so external
        # snapshotters (core/checkpoint.py) see states/counters atomically and
        # never race a dispatch that donates the state buffers
        self.step_lock = threading.RLock()
        self._last_progress = time.monotonic()
        self._stall_flagged = False
        self.error: Error | None = None

    # -- public control --------------------------------------------------------
    @property
    def state(self) -> State:
        return self.fsm.state

    def init(self) -> None:
        """Compile the graph (≈ changeStateTo(INITIALISED) → customInit)."""
        if self.fsm.state is State.IDLE:
            self._recompile(reset_state=True)
            self.fsm.transition_to(State.INITIALISED)

    def run_and_wait(self, n_steps: int | None = None) -> None:
        """Run the pump on the calling thread until EOS/stop (≈ runAndWait,
        Scheduler.hpp:515; ExecutionPolicy::singleThreaded)."""
        self.init()
        self.fsm.transition_to(State.RUNNING)
        self._start_watchdog()
        self._call_hooks("start")
        try:
            self._pump(n_steps)
        except Exception as e:
            self.error = Error.here(str(e), block=self.name)
            self.fsm.force_error()
            raise
        finally:
            try:
                self._drain()
            except Exception as e:
                if self.error is None:
                    self.error = Error.here(str(e), block=self.name)
                self.fsm.force_error()
                raise
            finally:
                self._stop_delivery_worker()
            if self.fsm.state in (State.RUNNING, State.PAUSED, State.REQUESTED_PAUSE):
                self.fsm.transition_to(State.REQUESTED_STOP)
            if self.fsm.state is State.REQUESTED_STOP:
                self.fsm.transition_to(State.STOPPED)
            self._call_hooks("stop")
            self._process_messages()  # final message pump (≈ Scheduler.hpp:543-554)

    def start(self, n_steps: int | None = None) -> None:
        """Run the pump on a background thread (≈ multiThreaded policy)."""
        from ..utils import thread_pool

        def runner():
            try:
                self.run_and_wait(n_steps)
            except Exception:
                # already recorded in self.error / ERROR state; wait_done()
                # re-raises it on the waiter's thread — re-raising here too
                # would only crash the daemon thread noisily
                pass

        self._runner = thread_pool.spawn(runner, name=f"{self.name}-runner")

    def wait_done(self, timeout: float | None = None) -> None:
        if self._runner is not None:
            self._runner.join(timeout)
            if self._runner.is_alive():
                if self.fsm.state is State.ERROR and self.error is not None:
                    # fail FAST: the pump thread is wedged (e.g. inside a
                    # collective whose peer died) but the watchdog has
                    # already marked the run failed — raise the diagnosis
                    # instead of timing out on a thread that can never join
                    raise GrError(f"{self.name} failed: {self.error.message}")
                raise TimeoutError(f"{self.name} still running")
        if self.fsm.state is State.ERROR and self.error is not None:
            # surface runner-thread failures to the waiter (a dead background
            # thread would otherwise look like a clean finish)
            raise GrError(f"{self.name} failed: {self.error.message}")

    def step_once(self) -> bool:
        """Advance the graph by exactly one scheduler step under EXTERNAL
        control (≈ ExecutionPolicy::externalStep, Scheduler.hpp:79 — MCU/
        freestanding-style operation where the caller owns the cadence).

        Returns True while the graph can make further progress, False once the
        stream completed (pending deliveries are then drained). The scheduler
        must be INITIALISED or RUNNING; lifecycle hooks fire on first use.
        """
        if self.fsm.state is State.IDLE:
            self.init()
        if self.fsm.state is State.INITIALISED:
            self.fsm.transition_to(State.RUNNING)
            self._call_hooks("start")
        if self.fsm.state is not State.RUNNING:
            raise GrError(f"step_once in state {self.fsm.state.name}")
        more = self._pump_once()
        if not more:
            self._drain()
            self._stop_delivery_worker()
            self.fsm.transition_to(State.REQUESTED_STOP)
            self.fsm.transition_to(State.STOPPED)
            self._call_hooks("stop")
        return more

    def request_pause(self) -> None:
        self.fsm.transition_to(State.REQUESTED_PAUSE)

    def resume(self) -> None:
        self.fsm.transition_to(State.RUNNING)
        self._call_hooks("resume")

    def request_stop(self) -> None:
        st = self.fsm.state
        if st in (State.RUNNING, State.PAUSED, State.REQUESTED_PAUSE, State.INITIALISED):
            self.fsm.transition_to(State.REQUESTED_STOP)

    def reset(self) -> None:
        if self.fsm.state is State.ERROR:
            self.fsm.transition_to(State.IDLE)
        self._stop_delivery_worker()
        self._deferred_errors.clear()
        self._step = 0
        self._dirty = True
        self._finished_sources.clear()
        self._eos_announced.clear()
        self._inflight.clear()
        self._pending_out_tags.clear()
        self.error = None
        self._call_hooks("reset")

    # -- compile ---------------------------------------------------------------
    def _recompile(self, *, reset_state: bool) -> None:
        old_states = None if reset_state else self._states
        while True:
            try:
                self.compiled = compile_graph(
                    self.graph, block_len=self.block_len,
                    sample_rate=self.sample_rate, mesh=self.mesh,
                    batch_steps=self.batch_steps)
                if self.batch_steps > 1 and any(
                        getattr(b, "FEED", False) and hasattr(b, "consume")
                        for b in self.compiled.order):
                    # a ring-bridged subgraph's feed depends on the PREVIOUS
                    # step's delivery — batching would starve it S steps deep
                    raise GrError(
                        "batch_steps > 1 is incompatible with ring-bridged "
                        "subgraphs (a block with both FEED and consume): its "
                        "feed consumes the previous step's delivery, which a "
                        "batched dispatch only produces at the super-step "
                        "boundary. Run this graph with batch_steps=1.")
                break
            except GrError as e:
                # zombie path: remove the failing block (+ its dependent
                # branch), keep the rest running (≈ Scheduler.hpp:1210-1217)
                if self.on_block_error != "prune" or not e.block:
                    raise
                self._zombify(e.block, str(e))
        self._states = self.compiled.init_states()
        if old_states:
            # best-effort carry state across re-jit when shapes still match
            for k, v in old_states.items():
                if k in self._states and _same_struct(v, self._states[k]):
                    self._states[k] = v
        for b in self.compiled.order:
            self._abs_in.setdefault(b.unique_name, 0)
            self._abs_out.setdefault(b.unique_name, 0)
        self._dirty = False

    def _globalize_feeds(self, feeds: dict) -> dict:
        """Per-process local time shards → global jax.Arrays over the mesh.

        Convention (parallel/multihost.py): every process's host_feed returns
        the full global block (sources like files/generators are replicated
        inputs); each process contributes its contiguous time slice — devices
        in ``jax.devices()`` order are process-major, so slice p covers
        [p·T/nproc, (p+1)·T/nproc).
        """
        from jax.sharding import NamedSharding, PartitionSpec as P
        npz = jax.process_count()
        pid = jax.process_index()
        out: dict = {}
        for uname, d in feeds.items():
            od = {}
            for port, arr in d.items():
                arr = np.asarray(arr)
                spec = P(*([None] * (arr.ndim - 1)), "sp")
                t = arr.shape[-1]
                tl = t // npz
                local = np.ascontiguousarray(arr[..., pid * tl:(pid + 1) * tl])
                od[port] = jax.make_array_from_process_local_data(
                    NamedSharding(self.mesh, spec), local, arr.shape)
            out[uname] = od
        return out

    def _zombify(self, name: str, reason: str) -> None:
        """Remove a failed block and every block whose non-optional input
        depends on it; the survivors keep streaming after a re-jit."""
        flat = self.graph.flatten()
        target = next((b for b in flat.blocks
                       if b.name == name or b.unique_name == name), None)
        if target is None:
            raise GrError(f"cannot prune unknown block {name!r}: {reason}")
        doomed = {target}
        changed = True
        while changed:
            changed = False
            for e in flat.edges:
                if e.src in doomed and e.dst not in doomed:
                    decl = next((p for p in e.dst.in_ports
                                 if p.name == e.dst_port), None)
                    if decl is None or not decl.optional:
                        doomed.add(e.dst)
                        changed = True
        survivors = [b for b in flat.blocks if b not in doomed]
        if not survivors:
            raise GrError(f"block {name!r} failed and nothing survives "
                          f"pruning it: {reason}")
        for b in doomed:
            _remove_deep(self.graph, b)
            self._states.pop(b.unique_name, None)
            self._finished_sources.discard(b.unique_name)
        self.zombies.extend(b.name for b in doomed)
        self.bus.notify(self.name, "BlockError",
                        {"block": name, "reason": reason,
                         "removed": sorted(b.name for b in doomed)})

    def _contain_block_error(self, block: Block, err: Exception,
                             what: str) -> bool:
        """Prune-mode containment for host-side block failures (feed/consume).
        Returns True when the error was absorbed (block zombified)."""
        if self.on_block_error != "prune":
            return False
        self._zombify(block.name, f"{what}: {err}")
        self._dirty = True
        return True

    # -- per-step planning (shared by the unbatched and batched pumps) ---------
    def _plan_substep(self, c, feed_failures: list | None = None):
        """Collect feeds + per-source valid counts and propagate validity
        through the DAG for ONE logical step (the former inline steps 1-2 of
        the pump). Reads/updates ``_finished_sources`` and reads the abs
        counters (advanced by the caller afterwards).

        Returns ``(feeds, n_valid, n_valid_deliver, n_valid_ports,
        produced_any, graph_done)`` or None when a feed failure was contained
        by zombie-pruning (caller should retry the pump on the pruned graph).
        With ``feed_failures`` (batched planning), failing feed blocks are NOT
        pruned mid-batch — they are recorded as ``(block, err)``, treated as
        finished sources for the remaining sub-steps (zero feeds), and the
        caller prunes after the batched dispatch completes.
        """
        # "source" = no *connected* inputs: a block with only unconnected
        # optional ports, e.g. a FunctionGenerator without its clk_in, still
        # self-terminates
        in_edges = c.in_edges_by_dst()
        plan = c.pump_plan()
        feeds: dict[str, dict[str, np.ndarray]] = {}
        n_valid: dict[str, int] = {}
        for b, uname, is_feed, has_ins, srcs, num, den, stock_clamp, \
                allow_underrun in plan:
            if uname in self._finished_sources:
                n_valid[uname] = 0
                if is_feed:
                    feeds[uname] = c.zero_feeds()[uname]
            elif is_feed:
                try:
                    got = b.host_feed(c.out_len[uname], self._abs_out[uname])
                except Exception as err:
                    if feed_failures is not None \
                            and self.on_block_error == "prune":
                        # batched planning: keep the compiled program intact —
                        # feed zeros from here on; prune at the batch boundary
                        feed_failures.append((b, err))
                        self._finished_sources.add(uname)
                        n_valid[uname] = 0
                        feeds[uname] = c.zero_feeds()[uname]
                        continue
                    if self._contain_block_error(b, err, "host_feed"):
                        return None   # retry next pump on the pruned graph
                    raise
                if got is None:
                    self._finished_sources.add(uname)
                    n_valid[uname] = 0
                    feeds[uname] = c.zero_feeds()[uname]
                else:
                    arrays, nv = got if isinstance(got, tuple) else (got, c.out_len[uname])
                    zero = c.zero_feeds()[uname]
                    feeds[uname] = {p: _pad_to(np.asarray(a), zero[p].shape, zero[p].dtype)
                                    for p, a in arrays.items()}
                    nv = min(nv, min((np.asarray(a).shape[-1] for a in arrays.values()),
                                     default=nv))
                    n_valid[uname] = nv
                    # ALLOW_UNDERRUN feeds (live sources, subgraph bridges
                    # warming up) signal EOS only by returning None; a partial
                    # block is a transient underrun, not the end of the stream
                    if nv < c.out_len[uname] and not allow_underrun:
                        self._finished_sources.add(uname)
            elif not has_ins:  # pure device source
                done = b.host_done(self._abs_out[uname], c.out_len[uname])
                if done is not None and done <= c.out_len[uname]:
                    n_valid[uname] = max(0, done)
                    self._finished_sources.add(uname)
                else:
                    n_valid[uname] = c.out_len[uname]

        # 2. propagate valid counts through the DAG (host-side bookkeeping)
        graph_done = False
        nv_get = n_valid.get
        for b, uname, is_feed, has_ins, srcs, num, den, stock_clamp, _au \
                in plan:
            if (not has_ins or is_feed) and uname in n_valid:
                # sources and host-fed bridges: validity comes from the feed
                continue
            if has_ins:
                nv_in = None
                for s, dflt in srcs:
                    v = nv_get(s, dflt)
                    if nv_in is None or v < nv_in:
                        nv_in = v
                nv_out = nv_in if num == den else (nv_in * num) // den
            else:
                nv_out = nv_get(uname, c.out_len[uname])
            # mid-graph valid clamp (HeadBlock-style truncation, ≈ reference
            # disconnect_on_done): the block may pass fewer samples and signal
            # that the whole graph should wind down once it has
            if not stock_clamp:
                clamp = b.clamp_valid(nv_out, self._abs_out[uname])
                if clamp is not None:
                    nv_out = min(nv_out, clamp)
                    if clamp <= 0 and b.terminate_graph_when_done:
                        graph_done = True
            n_valid[uname] = nv_out

        produced_any = any(nv_get(uname, 0) > 0
                           for _b, uname, _f, has_ins, *_ in plan
                           if not has_ins)

        # delivery-side validity: a FEED block WITH inputs (subgraph bridge) has
        # its n_valid set by its own feed (output side); what its consume()
        # receives is the INPUT stream, whose validity is the upstream's.
        # Sinks flagged PER_PORT_VALID additionally get each port's own count —
        # the analog of the reference's Async input ports progressing
        # independently (e.g. SyncBlock.hpp:124 PortIn<T, Async>)
        n_valid_deliver = dict(n_valid)
        n_valid_ports: dict[str, dict[str, int]] = {}
        for b, uname, is_feed, has_ins, srcs, *_ in plan:
            if not has_ins:
                continue
            if is_feed:
                n_valid_deliver[uname] = min(nv_get(s, d) for s, d in srcs)
            if getattr(b, "PER_PORT_VALID", False):
                n_valid_ports[uname] = {
                    e.dst_port: nv_get(e.src.unique_name,
                                       c.out_len[e.src.unique_name])
                    for e in in_edges[uname]}
        return (feeds, n_valid, n_valid_deliver, n_valid_ports,
                produced_any, graph_done)

    # -- the pump --------------------------------------------------------------
    def _pump(self, n_steps: int | None) -> None:
        while True:
            st = self.fsm.state
            if st is State.REQUESTED_STOP or st is State.ERROR:
                return
            if st is State.REQUESTED_PAUSE:
                self.fsm.transition_to(State.PAUSED)
                self._call_hooks("pause")
                st = self.fsm.state
            if st is State.PAUSED:
                self._process_messages()
                time.sleep(0.001)
                continue
            if n_steps is not None and self._step >= n_steps:
                return
            if not self._pump_once():
                return

    def _pump_once(self) -> bool:
        """One scheduler step (a SUPER-step of ``batch_steps`` logical steps
        when batching). Returns False on EOS completion."""
        with self.step_lock, \
                self.profiler.duration("scheduler.step", step=self._step):
            if self.batch_steps > 1:
                return self._pump_once_batched()
            return self._pump_once_inner()

    def _pump_once_inner(self) -> bool:
        self._process_messages()
        if self.fsm.state in (State.REQUESTED_STOP, State.ERROR):
            return False
        # block-to-block message edges (≈ MsgPortIn/Out): deliver posted
        # property maps before settings staging so they apply this step
        if self.compiled is not None:
            for src, dst in self.compiled.graph.message_edges:
                for m in src.drain_messages():
                    dst.handle_message(m, from_block=src)
        self._apply_staged_settings()
        if self._dirty:
            with self.profiler.duration("scheduler.compile"):
                self._recompile(reset_state=False)
        c = self.compiled

        # 0. deliver matured in-flight results FIRST — feeds may depend on sink
        # deliveries (ring-bridged subgraphs); delivering after dispatch would
        # deadlock two coupled schedulers
        if self._async_delivery_active():
            self._flush_deferred_errors()
            while len(self._inflight) >= self.pipeline_depth:
                # bounded queue (maxsize = pipeline_depth) gives backpressure:
                # put() blocks when the delivery worker lags too far behind
                self._dq.put(self._inflight.popleft())
        else:
            while len(self._inflight) >= self.pipeline_depth:
                self._deliver(self._inflight.popleft())

        # 1-2. collect feeds + propagate valid counts (extracted so the
        # batched pump can plan S sub-steps per dispatch)
        planned = self._plan_substep(c)
        if planned is None:
            return True   # feed failure contained (prune): retry next pump
        (feeds, n_valid, n_valid_deliver, n_valid_ports, produced_any,
         graph_done) = planned

        # multi-host: every process computed the full (global) feed blocks —
        # slice out this process's time shard and assemble global jax.Arrays
        if self._multihost and feeds:
            feeds = self._globalize_feeds(feeds)

        # 3. host tag sideband FIRST — tag-derived dynamic params (TagArrays via
        # Block.prepare_params) must be visible to this step's device dispatch
        with self.profiler.duration("scheduler.tags"):
            sink_tags = self._advance_tags(n_valid)

        # 3b. settings staged by the tag walk (auto-update, context
        # activation) apply THIS step — the reference chunk-breaks work at
        # the tag (Block.hpp:1986), so a tag at the step head must govern
        # these samples, including *static* changes (e.g. a context tag
        # switching FunctionGenerator's signal_type re-jits before dispatch).
        # Blocks with pending SAMPLE_ACCURATE ramps keep their applied value
        # as the pre-tag baseline — the ramp IS their exact application.
        self._apply_staged_settings(exclude=set(self._tag_ramps))
        if self._dirty:
            old_compiled, old_states = self.compiled, self._states
            with self.profiler.duration("scheduler.compile"):
                self._recompile(reset_state=False)
            c = self.compiled
            if c.in_len != old_compiled.in_len \
                    or c.out_len != old_compiled.out_len:
                # the tag-staged change re-solved the RATE solution — this
                # step's feeds/validity/tag bookkeeping were computed on the
                # old chunk grid and cannot be delivered on the new one.
                # Dispatch the old program once more; the new solution takes
                # over at the next step boundary (its trace is jit-cached).
                self.compiled, self._states = old_compiled, old_states
                self._dirty = True
                c = old_compiled
            else:
                # same grid: refit feeds defensively (same pattern as the
                # zombie-prune retry below)
                zf = c.zero_feeds()
                feeds = {
                    uname: {p: _pad_to(
                        np.asarray(a)[..., :zf[uname][p].shape[-1]],
                        zf[uname][p].shape, zf[uname][p].dtype)
                            for p, a in fd.items() if p in zf.get(uname, {})}
                    for uname, fd in feeds.items() if uname in zf}

        # 4. dispatch device step (async); tag-driven settings at index k
        # become per-sample param arrays for this step (exact application)
        with self.profiler.duration("scheduler.dispatch", step=self._step):
            ramp_events = self._tag_ramps
            self._tag_ramps = {}

            def _params_with_ramps(c):
                params = c.gather_params()
                if not ramp_events:
                    return params
                params = dict(params)
                for uname, events in ramp_events.items():
                    blk = next((b for b in c.order
                                if b.unique_name == uname), None)
                    if blk is None:      # ramped block was zombie-pruned
                        continue
                    over = blk.tag_param_ramps(events, c.in_len[uname])
                    if over:
                        params[uname] = {**params.get(uname, {}), **over}
                return params

            params = _params_with_ramps(c)
            while True:
                try:
                    new_states, sink_ins = c.step(self._states, params, feeds)
                    break
                except GrError as e:
                    # jit traces lazily, so a broken apply surfaces HERE on
                    # the first dispatch after a (re)compile — zombie-prune
                    # and retry the same step on the surviving graph
                    if self.on_block_error != "prune" or not e.block:
                        raise
                    self._zombify(e.block, str(e))
                    self._recompile(reset_state=False)
                    c = self.compiled
                    # the feeds dict was built for the pre-prune graph: drop
                    # entries for pruned blocks and re-fit surviving arrays to
                    # the (possibly re-solved) rate solution so the retried
                    # dispatch sees exactly the compiled feed signature
                    zf = c.zero_feeds()
                    feeds = {
                        uname: {p: _pad_to(np.asarray(a)[..., :zf[uname][p].shape[-1]],
                                           zf[uname][p].shape, zf[uname][p].dtype)
                                for p, a in fd.items() if p in zf.get(uname, {})}
                        for uname, fd in feeds.items() if uname in zf}
                    params = _params_with_ramps(c)
            self._states = new_states

        # 5. book-keeping + pipelined sink delivery
        abs_in_snapshot = dict(self._abs_in)
        for b in c.order:
            uname = b.unique_name
            self._abs_in[uname] += c.in_len[uname]
            self._abs_out[uname] += c.out_len[uname]
        self._inflight.append(_InFlight(
            step=self._step, sink_ins=sink_ins, sink_tags=sink_tags,
            n_valid=n_valid_deliver, abs_in=abs_in_snapshot,
            t_dispatch=time.monotonic(), n_valid_ports=n_valid_ports))
        self._step += 1
        self._last_progress = time.monotonic()

        # EOS: all sources finished and nothing produced this step → stop;
        # a completed terminate-graph block (HeadBlock) also ends the run.
        # Mid-graph FEED bridges (ScheduledSubgraph) count as sources: the
        # graph is not done while their inner pipeline still holds data.
        sources = [uname for _b, uname, is_feed, has_ins, *_ in c.pump_plan()
                   if not has_ins or is_feed]
        all_done = sources and all(u in self._finished_sources
                                   for u in sources)
        if (all_done and not produced_any) or graph_done:
            return False
        return True

    # -- batched pump (batch_steps > 1) ----------------------------------------
    def _pump_once_batched(self) -> bool:
        """One SUPER-step: plan ``batch_steps`` logical sub-steps on the host
        (feeds, validity, tag walk, staged settings — advancing the abs
        counters per sub-step), then dispatch them all in ONE jitted lax.scan
        program. Tag-accurate ramps and mid-batch dynamic-settings changes
        ride a per-sub-step params overlay (scan xs); static/structural
        changes and state resets land at the next super-step boundary.
        """
        self._process_messages()
        if self.fsm.state in (State.REQUESTED_STOP, State.ERROR):
            return False
        if self.compiled is not None:
            for src, dst in self.compiled.graph.message_edges:
                for m in src.drain_messages():
                    dst.handle_message(m, from_block=src)
        self._apply_staged_settings()
        if self._dirty:
            with self.profiler.duration("scheduler.compile"):
                self._recompile(reset_state=False)
        c = self.compiled
        S = c.batch_steps

        # deliver matured in-flight results first (same ordering contract as
        # the unbatched pump)
        if self._async_delivery_active():
            self._flush_deferred_errors()
            while len(self._inflight) >= self.pipeline_depth:
                self._dq.put(self._inflight.popleft())
        else:
            while len(self._inflight) >= self.pipeline_depth:
                self._deliver(self._inflight.popleft())

        # params snapshot for the whole batch; blocks whose params change
        # mid-batch (or that derive params from the per-step tag walk) get
        # per-sub-step overlays instead — so the base needs no per-step
        # refresh (overlays supersede those keys every sub-step)
        params_base = c.gather_params(refresh=False)
        by_uname = {b.unique_name: b for b in c.order}
        prep_overriders = [b.unique_name for b in c.order
                           if type(b).prepare_params is not Block.prepare_params]

        feeds_list: list[dict] = []
        sub_meta: list[_SubStep] = []
        snaps: dict[str, dict[int, dict]] = {}
        feed_failures: list[tuple[Block, Exception]] = []
        deferred_resets: list[Block] = []
        produced_any = False
        graph_done = False

        done_planning = False
        for k in range(S):
            if done_planning:
                # a terminate-graph block (HeadBlock) completed in an earlier
                # sub-step: the remaining sub-steps are INERT — no host_feed
                # calls (a live source's read position must not advance past
                # the stop), zero validity everywhere, no counter advance.
                # The scan still needs S slices; delivery clamps them to 0.
                sub_meta.append(_SubStep(
                    step=self._step, sink_tags={},
                    n_valid={b.unique_name: 0 for b in c.order},
                    abs_in=dict(self._abs_in), n_valid_ports={}))
                feeds_list.append(c.zero_feeds())
                continue
            planned = self._plan_substep(c, feed_failures=feed_failures)
            if planned is None:   # only reachable when on_block_error=shutdown
                return True
            (feeds_k, n_valid, n_valid_deliver, n_valid_ports,
             produced_k, done_k) = planned
            with self.profiler.duration("scheduler.tags"):
                sink_tags = self._advance_tags(n_valid)
            ramp_events = self._tag_ramps
            self._tag_ramps = {}
            # ramps use the PRE-apply baseline (old value before the tag)
            ramp_over: dict[str, dict] = {}
            for uname, events in ramp_events.items():
                blk = by_uname.get(uname)
                if blk is None:
                    continue
                over = blk.tag_param_ramps(events, c.in_len[uname])
                if over:
                    ramp_over[uname] = over
            applied = self._apply_staged_settings(
                defer_state_reset=deferred_resets)
            # snapshot effective params for this sub-step: tag-walk-derived
            # (prepare_params overriders refresh every step in the unbatched
            # pump too), freshly-applied settings, and ramped blocks
            for uname in set(prep_overriders) | set(applied) | set(ramp_over):
                blk = by_uname.get(uname)
                if blk is None:
                    continue
                snap = blk.prepare_params(blk.settings.dynamic_params())
                if uname in ramp_over:
                    snap = {**snap, **ramp_over[uname]}
                snaps.setdefault(uname, {})[k] = snap
                if uname in ramp_over and k + 1 < S:
                    # the sub-step after a ramp reverts to the (new) scalar
                    # params; a later snapshot at k+1 overwrites this
                    snaps[uname][k + 1] = blk.prepare_params(
                        blk.settings.dynamic_params())
            abs_in_snapshot = dict(self._abs_in)
            for b in c.order:
                uname = b.unique_name
                self._abs_in[uname] += c.in_len[uname]
                self._abs_out[uname] += c.out_len[uname]
            sub_meta.append(_SubStep(
                step=self._step, sink_tags=sink_tags,
                n_valid=n_valid_deliver, abs_in=abs_in_snapshot,
                n_valid_ports=n_valid_ports))
            feeds_list.append(feeds_k)
            produced_any = produced_any or produced_k
            graph_done = graph_done or done_k
            done_planning = done_planning or done_k
            self._step += 1

        # stack feeds [S, ...]. Port sets are normally identical across
        # sub-steps (zero_feeds fills finished sources); a feed returning a
        # port in SOME sub-steps only gets zero-filled in the others — the
        # scan needs one static structure (union of ports seen).
        feeds: dict[str, dict[str, np.ndarray]] = {}
        if feeds_list and feeds_list[0]:
            zf = c.zero_feeds()
            for uname in feeds_list[0]:
                ports = {p for fl in feeds_list for p in fl[uname]}
                feeds[uname] = {
                    p: np.stack([fl[uname].get(p, zf[uname][p])
                                 for fl in feeds_list])
                    for p in ports}
        overlays = self._build_overlays(c, snaps, params_base, S)
        if self._multihost and feeds:
            feeds = self._globalize_feeds(feeds)

        with self.profiler.duration("scheduler.dispatch", step=self._step):
            while True:
                try:
                    new_states, sink_ins = c.step(self._states, params_base,
                                                  feeds, overlays)
                    break
                except GrError as e:
                    # first-dispatch trace failures: zombie-prune + retry the
                    # same super-step on the surviving graph
                    if self.on_block_error != "prune" or not e.block:
                        raise
                    self._zombify(e.block, str(e))
                    self._recompile(reset_state=False)
                    c = self.compiled
                    zf = c.zero_feeds()
                    # refit from the PLANNED host feeds (missing ports
                    # zero-fill, matching the primary stacking path), then
                    # re-apply the same multihost conversion as the first
                    # dispatch
                    feeds = {
                        uname: {p: np.stack([_pad_to(
                            np.asarray(fl[uname].get(p, zf[uname][p]))[
                                ..., :zf[uname][p].shape[-1]],
                            zf[uname][p].shape, zf[uname][p].dtype)
                            for fl in feeds_list])
                            for p in zf[uname]}
                        for uname in zf if uname in feeds_list[0]} \
                        if feeds_list and feeds_list[0] else {}
                    if self._multihost and feeds:
                        feeds = self._globalize_feeds(feeds)
                    params_base = c.gather_params()
                    alive = {b.unique_name for b in c.order}
                    overlays = {u: o for u, o in overlays.items()
                                if u in alive}
            self._states = new_states

        self._inflight.append(_InFlight(
            step=sub_meta[0].step, sink_ins=sink_ins,
            sink_tags=sub_meta[0].sink_tags, n_valid=sub_meta[0].n_valid,
            abs_in=sub_meta[0].abs_in, t_dispatch=time.monotonic(),
            n_valid_ports=sub_meta[0].n_valid_ports, batch=sub_meta))
        self._last_progress = time.monotonic()

        # post-batch: prune feed-failed blocks (kept alive through the batch
        # so the compiled program's states stayed intact), apply deferred
        # state resets
        for blk, err in feed_failures:
            if blk.unique_name not in self.zombies and blk.name not in self.zombies:
                self._zombify(blk.name, f"host_feed: {err}")
                self._dirty = True
        for blk in deferred_resets:
            uname = blk.unique_name
            if uname in self._states:
                self._states[uname] = blk.init_state(c.block_ctx[uname])

        sources = [uname for _b, uname, is_feed, has_ins, *_ in c.pump_plan()
                   if not has_ins or is_feed]
        all_done = sources and all(u in self._finished_sources
                                   for u in sources)
        if (all_done and not produced_any) or graph_done:
            return False
        return True

    def _build_overlays(self, c, snaps: dict[str, dict[int, dict]],
                        params_base: dict, S: int) -> dict:
        """Per-sub-step params snapshots → stacked overlay pytree
        ``{uname: {key: leaf[S, ...]}}`` for the batched dispatch's scan xs.

        Sub-steps without a snapshot forward-fill from the latest snapshot
        (or the batch-start base params). Mixed scalar/per-sample leaves for
        one key (a ramp in one sub-step) broadcast every sub-step to the
        common shape — constant per-sample arrays are semantically identical
        to the scalar (e.g. cumsum of a constant dphi)."""
        if not snaps:
            return {}
        overlays: dict[str, dict] = {}
        for uname, by_k in snaps.items():
            base = dict(params_base.get(uname, {}))
            per_step: list[dict] = []
            cur = base
            for k in range(S):
                if k in by_k:
                    cur = by_k[k]
                per_step.append(cur)
            keys = set().union(*[set(d) for d in per_step])
            od = {}
            for key in keys:
                leaves = []
                for k in range(S):
                    v = per_step[k].get(key, base.get(key))
                    if v is None:
                        # key introduced mid-batch (ramp-only param): before
                        # the event the block ran on its scalar path — the
                        # ramp array's first element IS the pre-tag value
                        first = np.asarray(next(
                            per_step[j][key] for j in range(S)
                            if key in per_step[j]))
                        v = (np.full_like(first, first.flat[0])
                             if first.ndim else first)
                    leaves.append(np.asarray(v))
                tgt = np.broadcast_shapes(*[lv.shape for lv in leaves])
                dt = np.result_type(*[lv.dtype for lv in leaves])
                od[key] = np.stack([
                    np.broadcast_to(lv.astype(dt, copy=False), tgt)
                    for lv in leaves])
            overlays[uname] = od
        return overlays

    def _drain(self) -> None:
        if self._async_delivery_active():
            while self._inflight:
                self._dq.put(self._inflight.popleft())
            self._dq.join()            # wait for the worker to finish FIFO
            self._flush_deferred_errors()
            return
        while self._inflight:
            self._deliver(self._inflight.popleft())

    # -- async delivery (opt-in) ----------------------------------------------
    def _async_delivery_active(self) -> bool:
        if not self.async_delivery:
            return False
        c = self.compiled
        if c is not None and any(getattr(b, "FEED", False)
                                 and hasattr(b, "consume") for b in c.order):
            # a feed depending on a delivery (ring-bridged subgraph) would
            # deadlock behind its own queue — force the sync path
            return False
        if self._dworker is None or not self._dworker.is_alive():
            import queue as _q
            self._dq = _q.Queue(maxsize=self.pipeline_depth)
            from ..utils import thread_pool

            def worker():
                while True:
                    rec = self._dq.get()
                    if rec is None:
                        self._dq.task_done()
                        return
                    try:
                        self._deliver(rec, deferred=self._deferred_errors)
                    except Exception as err:  # defensive: never kill the worker
                        self._deferred_errors.append((None, err, "deliver"))
                    finally:
                        self._dq.task_done()

            self._dworker = thread_pool.spawn(
                worker, name=f"{self.name}-delivery")
        return True

    def _flush_deferred_errors(self) -> None:
        """Handle delivery-thread errors on the PUMP thread (zombie pruning
        mutates the graph and must never run concurrently with dispatch)."""
        while self._deferred_errors:
            block, err, stage = self._deferred_errors.pop(0)
            if block is not None and (block.unique_name in self.zombies
                                      or block.name in self.zombies):
                continue   # queued deliveries raced a block already pruned
            if block is None or not self._contain_block_error(
                    block, err, stage):
                raise err

    def _stop_delivery_worker(self) -> None:
        if self._dworker is not None and self._dworker.is_alive():
            self._dq.put(None)
            self._dworker.join(timeout=10)
        self._dworker = None
        self._dq = None

    def _late_tag_routes(self, c, src_uname: str):
        """Downstream sink/tap consumers reachable from ``src_uname`` with the
        cumulative rate ratio along the path and the arrival port: data-derived
        tags (host_emit_tags) are produced only once device results land, so
        they ride the *delivery* path to consumers, not the dispatch-time
        sideband (≈ the reference publishing data-dependent tags inline in
        processBulk, e.g. blocks/basic Trigger.hpp:122 publishTag)."""
        routes: list[tuple[str, str, Fraction]] = []
        out_edges: dict[str, list] = {}
        for e in c.graph.edges:
            out_edges.setdefault(e.src.unique_name, []).append(e)
        seen = set()
        frontier = [(src_uname, Fraction(1))]
        while frontier:
            uname, ratio = frontier.pop()
            for e in out_edges.get(uname, []):
                dst = e.dst.unique_name
                if (dst, e.dst_port) in seen:
                    continue
                seen.add((dst, e.dst_port))
                blk = next((b for b in c.order if b.unique_name == dst), None)
                if blk is None:
                    continue
                if isinstance(blk, SinkBlock) or getattr(blk, "HOST_TAP",
                                                         False):
                    routes.append((dst, e.dst_port, ratio))
                frontier.append((dst, ratio * blk.ratio))
        return routes

    def _deliver(self, rec: _InFlight, deferred: list | None = None) -> None:
        if rec.batch is None:
            return self._deliver_one(rec, deferred)
        # batched record: ONE device→host transfer per sink port for the whole
        # batch (leading [S] axis), then S logical deliveries from host slices
        c = self.compiled
        host_cache: dict[str, dict[str, np.ndarray]] = {}
        for uname, ins in rec.sink_ins.items():
            block = next((b for b in c.order if b.unique_name == uname), None)
            if block is None:
                continue
            wants_host = getattr(block, "WANTS_HOST_DATA", True) \
                or getattr(block, "EMITS_HOST_TAGS", False)
            if not wants_host:
                continue
            if self._multihost:
                from ..parallel.multihost import drain_local
                host_cache[uname] = {p: drain_local(a) for p, a in ins.items()}
            else:
                host_cache[uname] = {p: np.asarray(a) for p, a in ins.items()}
        skip_slice = {
            uname for uname in rec.sink_ins
            if uname not in host_cache and getattr(
                next((b for b in c.order if b.unique_name == uname), None),
                "CONSUME_IGNORES_DATA", False)}
        for k, meta in enumerate(rec.batch):
            sub_ins = {
                uname: (ins if uname in skip_slice else
                        {p: (host_cache[uname][p][k] if uname in host_cache
                             else a[k])
                         for p, a in ins.items()})
                for uname, ins in rec.sink_ins.items()}
            self._deliver_one(_InFlight(
                step=meta.step, sink_ins=sub_ins, sink_tags=meta.sink_tags,
                n_valid=meta.n_valid, abs_in=meta.abs_in,
                t_dispatch=rec.t_dispatch, n_valid_ports=meta.n_valid_ports),
                deferred, pre_host=True)

    def _deliver_one(self, rec: _InFlight, deferred: list | None = None,
                     pre_host: bool = False) -> None:
        c = self.compiled
        with self.profiler.duration("scheduler.deliver", step=rec.step):
            # pass 1: data-derived tags from emitting blocks (topological) —
            # computed on landed host data, routed to downstream consumers
            late: dict[str, dict[str, list[Tag]]] = {}
            for b in c.order:
                uname = b.unique_name
                if uname not in rec.sink_ins or \
                        not getattr(b, "EMITS_HOST_TAGS", False):
                    continue
                arrays = {p: (a if pre_host else np.asarray(a))
                          for p, a in rec.sink_ins[uname].items()}
                emitted = b.host_emit_tags(
                    arrays, rec.sink_tags.get(uname, {}),
                    rec.n_valid.get(uname, c.in_len[uname]),
                    rec.abs_in.get(uname, 0))
                if not emitted:
                    continue
                for dst, port, ratio in self._late_tag_routes(c, uname):
                    bucket = late.setdefault(dst, {}).setdefault(port, [])
                    bucket += [t if ratio == 1 else t.rescaled(ratio)
                               for t in emitted]
            for uname, ins in rec.sink_ins.items():
                # None: the block was zombie-pruned after this step's dispatch
                block = next((b for b in c.order if b.unique_name == uname),
                             None)
                if block is None or not (isinstance(block, SinkBlock)
                                         or getattr(block, "HOST_TAP", False)):
                    continue
                if getattr(block, "WANTS_HOST_DATA", True):
                    if pre_host:   # batched delivery already landed the data
                        arrays = dict(ins)
                    elif self._multihost:
                        # only this process's shards are addressable; sinks
                        # receive the local time slice (global gather is the
                        # application's job if it wants it)
                        from ..parallel.multihost import drain_local
                        arrays = {p: drain_local(a) for p, a in ins.items()}
                    else:
                        arrays = {p: np.asarray(a) for p, a in ins.items()}
                else:  # metrics-only sink: keep device arrays, skip the copy
                    arrays = dict(ins)
                tags = rec.sink_tags.get(uname, {})
                if uname in late:
                    tags = {p: sorted(list(tags.get(p, [])) + extra)
                            for p, extra in late[uname].items()} | \
                           {p: v for p, v in tags.items()
                            if p not in late[uname]}
                nv = rec.n_valid.get(uname, c.in_len[uname])
                if getattr(block, "PER_PORT_VALID", False):
                    nv = rec.n_valid_ports.get(uname) or \
                        {p.name: nv for p in block.in_ports}
                try:
                    block.consume(arrays, tags, nv,
                                  rec.abs_in.get(uname, 0))
                except Exception as err:
                    if deferred is not None:
                        # async worker: zombie pruning mutates the graph —
                        # marshal to the pump thread instead of acting here
                        deferred.append((block, err, "consume"))
                        continue
                    if not self._contain_block_error(block, err, "consume"):
                        raise

    # -- tags ------------------------------------------------------------------
    def _advance_tags(self, n_valid: dict[str, int]) -> dict[str, dict[str, list[Tag]]]:
        c = self.compiled
        edge_tags: dict[tuple[str, str], list[Tag]] = {}
        sink_tags: dict[str, dict[str, list[Tag]]] = {}
        in_edges = c.in_edges_by_dst()
        # one-shot per-step work that can inject tags outside the propagation
        # walk: pending forward-on-apply publishes and fresh source EOS
        pending = self._pending_out_tags
        new_eos = [u for u in self._finished_sources
                   if u not in self._eos_announced]
        for b, uname, in_keys, fast, is_sink, out_names, is_src in c.tag_plan():
            in_tags: dict[str, list[Tag]] = {}
            any_in = False
            for sk, dp in in_keys:
                ts = edge_tags.get(sk)
                in_tags[dp] = list(ts) if ts else []
                any_in = any_in or bool(ts)
            # steady-state fast path: no incoming tags, stock propagation, no
            # host tag emission — nothing below can produce output tags, so
            # skip the HostCtx/auto-update machinery (it dominated the
            # per-step host budget on deep tag-quiet graphs)
            if fast and not any_in:
                if pending:
                    for pn in out_names:
                        pend = pending.pop((uname, pn), None)
                        if pend:
                            edge_tags[(uname, pn)] = list(pend)
                if is_src and new_eos and uname in new_eos:
                    self._eos_announced.add(uname)
                    t = Tag(n_valid.get(uname, 0),
                            {Keys.END_OF_STREAM: True})
                    for pn in out_names:
                        edge_tags.setdefault((uname, pn), []).append(t)
                if is_sink:
                    sink_tags[uname] = in_tags
                continue
            hc = HostCtx(step=self._step,
                         in_len={p.name: c.in_len[uname] for p in b.in_ports},
                         out_len={p.name: c.out_len[uname] for p in b.out_ports},
                         sample_rate=c.block_ctx[uname].sample_rate,
                         abs_index=self._abs_in[uname])
            # auto-update settings from incoming tag maps (Settings.hpp:329);
            # changes to SAMPLE_ACCURATE dynamic params additionally become
            # per-sample ramps applied at the exact tag index THIS step
            # (≈ the reference chunk-breaking at the next tag, Block.hpp:1986)
            events: list[tuple[int, dict]] = []
            for tags in in_tags.values():
                for t in tags:
                    hits = b.settings.auto_update(t.map)
                    if hits and (b.SAMPLE_ACCURATE & hits.keys()):
                        events.append((int(t.index), hits))
                    if Keys.CONTEXT in t.map:
                        from .settings import SettingsCtx
                        b.settings.activate_context(SettingsCtx(
                            time=float(t.map.get(Keys.CTX_TIME, 0.0)),
                            context=str(t.map[Keys.CONTEXT])))
                    elif Keys.CTX_TIME in t.map:
                        # bare ctx_time advances the preset clock: pick the
                        # latest stored context whose time has come (the
                        # reference's time-multiplexed SettingsCtx semantics)
                        b.settings.activate_context_for_time(
                            float(t.map[Keys.CTX_TIME]))
            if events:
                # per-sample ramp arrays are full-step-length params; inside a
                # manual-sp shard_map they would mismatch the local shards —
                # under sp meshes tag settings keep step-boundary granularity
                if self.mesh is not None and \
                        "sp" in getattr(self.mesh, "axis_names", ()):
                    self.bus.notify(b.name, "TagSettings",
                                    {"note": "sample-accurate ramp skipped "
                                             "under sp sharding; applied at "
                                             "the next step boundary"})
                else:
                    # sort by index only — two tags at the same index would
                    # otherwise fall through to comparing dict payloads
                    # (TypeError); stable sort keeps arrival order for ties
                    self._tag_ramps[uname] = sorted(events, key=lambda e: e[0])
            # device-visible tag path: blocks that gate on tags on-device
            # (WANTS_TAG_ARRAYS) receive this step's input tags; their
            # prepare_params packs them into fixed-capacity TagArrays
            # (static shapes, capacity = max_tags_per_step)
            if getattr(b, "WANTS_TAG_ARRAYS", False):
                b._step_in_tags = [t for ts in in_tags.values() for t in ts]
                b._tag_capacity = self.max_tags_per_step
            out_tags = b.process_tags(in_tags, hc)
            # source-emitted tags (host hook, e.g. TagSource / EOS)
            emitted = b.emit_tags(hc) if hasattr(b, "emit_tags") else []
            for t in emitted:
                for p in b.out_ports:
                    out_tags.setdefault(p.name, []).append(t)
            # EOS tag when this source just finished (Tag.hpp end_of_stream);
            # "source" = no CONNECTED inputs (an unconnected optional clk_in
            # must not suppress the announcement)
            if (not in_edges[uname] and uname in self._finished_sources
                    and uname not in self._eos_announced):
                self._eos_announced.add(uname)
                for p in b.out_ports:
                    out_tags.setdefault(p.name, []).append(
                        Tag(n_valid.get(uname, 0), {Keys.END_OF_STREAM: True}))
            # forward-on-apply settings published as tags (pending from apply)
            for p in b.out_ports:
                pend = self._pending_out_tags.pop((uname, p.name), None)
                if pend:
                    out_tags.setdefault(p.name, []).extend(pend)
                edge_tags[(uname, p.name)] = out_tags.get(p.name, [])
            if uname in c.sink_names:
                sink_tags[uname] = in_tags
        return sink_tags

    # -- settings --------------------------------------------------------------
    def _apply_staged_settings(self, exclude: set[str] = frozenset(),
                               defer_state_reset: list | None = None
                               ) -> list[str]:
        """Apply staged settings on every block. Returns the unique_names of
        blocks whose settings actually changed (the batched pump snapshots
        their params per sub-step). With ``defer_state_reset`` (batched
        planning — the states pytree is mid-scan), requested state resets are
        recorded there instead of applied, and land at the super-step
        boundary."""
        applied_unames: list[str] = []
        if self.compiled is None:
            return applied_unames
        for b in self.compiled.order:
            if b.unique_name in exclude or not b.settings.changed():
                continue
            res = b.settings.apply_staged()
            self.compiled.invalidate_params()
            b.on_settings_applied(res)
            if getattr(b, "_state_reset", False):
                # block asked for a fresh state after this settings change
                # (e.g. FunctionGenerator restarting its segment clock)
                b._state_reset = False
                if defer_state_reset is not None:
                    defer_state_reset.append(b)
                else:
                    self._states[b.unique_name] = b.init_state(
                        self.compiled.block_ctx[b.unique_name])
            if res.static_changed:
                self._dirty = True
            if res.forward:
                for p in b.out_ports:
                    self._pending_out_tags.setdefault(
                        (b.unique_name, p.name), []).append(Tag(0, dict(res.forward)))
            if res.applied:
                applied_unames.append(b.unique_name)
                self.bus.notify(b.name, Property.SETTING, dict(res.applied))
        return applied_unames

    # -- messages --------------------------------------------------------------
    def _process_messages(self) -> None:
        for msg in self.bus.drain_inbox():
            try:
                self._handle_message(msg)
            except Exception as e:
                self.bus.reply(msg, Error.here(str(e)))

    def _handle_message(self, msg: Message) -> None:
        if msg.service_name in ("", self.name):
            self._handle_scheduler_message(msg)
            return
        block = self._find_block(msg.service_name)
        if block is None:
            self.bus.reply(msg, Error.here(f"no block named {msg.service_name!r}"))
            return
        ep, cmd, data = msg.endpoint, msg.command, msg.data or {}
        if ep == Property.HEARTBEAT:
            self.bus.reply(msg, {"heartbeat": time.time()})
        elif ep == Property.ECHO:
            self.bus.reply(msg, dict(data))
        elif ep == Property.SETTING:
            if cmd is Command.Set:
                unknown = block.settings.set(dict(data))
                if unknown:
                    self.bus.reply(msg, Error.here(f"unknown keys {sorted(unknown)}"))
                    return
            self.bus.reply(msg, block.settings.as_dict())
        elif ep == Property.STAGED_SETTING:
            if cmd is Command.Set:
                block.settings.set(dict(data))
            self.bus.reply(msg, dict(block.settings._staged))
        elif ep == Property.STORE_DEFAULTS:
            block.settings.store_defaults()
            self.bus.reply(msg, {})
        elif ep == Property.RESET_DEFAULTS:
            block.settings.reset_defaults()
            self.bus.reply(msg, {})
        elif ep == Property.ACTIVE_CONTEXT:
            from .settings import SettingsCtx
            if cmd is Command.Set:
                ctx = SettingsCtx(time=float(data.get("time", 0.0)),
                                  context=str(data.get("context", "")))
                # Set creates-and-activates (≈ Block.hpp kActiveContext Set,
                # qa_Messages "create active test_context"): the context
                # becomes a stored preset even before any values land in it
                if ctx.context:
                    block.settings._contexts.setdefault(ctx, {})
                block.settings.activate_context(ctx)
            ctx = block.settings.active_context
            self.bus.reply(msg, {"context": ctx.context, "time": ctx.time})
        elif ep == Property.SETTINGS_CONTEXTS:
            from .settings import SettingsCtx
            if cmd is Command.Set:       # create/store a context preset
                ctx = SettingsCtx(time=float(data.get("time", 0.0)),
                                  context=str(data.get("context", "")))
                block.settings.set(dict(data.get("properties", {})), ctx=ctx)
                block.settings._contexts.setdefault(ctx, {})
            elif cmd is Command.Disconnect:   # remove (≈ kSettingsCtx removal)
                ctx = SettingsCtx(time=float(data.get("time", 0.0)),
                                  context=str(data.get("context", "")))
                if not block.settings.remove_context(ctx):
                    self.bus.reply(msg, Error.here(
                        f"no stored context {ctx.context!r}"))
                    return
            ctxs = block.settings.stored_contexts()
            self.bus.reply(msg, {"contexts": [c.context for c in ctxs],
                                 "times": [c.time for c in ctxs]})
        elif ep == Property.META_INFORMATION:
            self.bus.reply(msg, {
                "type": type(block).__name__, "name": block.name,
                "unique_name": block.unique_name,
                "settings": {k: s.description for k, s in block.settings.spec.items()}})
        elif ep == Property.INSPECT_BLOCK:
            self.bus.reply(msg, _inspect_block(block))
        elif ep == Property.LIFECYCLE_STATE:
            self.bus.reply(msg, {"state": self.fsm.state.value})
        elif cmd in (Command.Subscribe, Command.Unsubscribe):
            # notifications for applied settings already flow to the outbox;
            # acknowledge the (un)subscription (clients filter via bus.subscribe)
            self.bus.reply(msg, {"endpoint": ep}, command=Command.Ready)
        else:
            self.bus.reply(msg, Error.here(f"unknown endpoint {ep!r}"))

    def _handle_scheduler_message(self, msg: Message) -> None:
        ep, cmd, data = msg.endpoint, msg.command, msg.data or {}
        if ep == Property.LIFECYCLE_STATE:
            if cmd is Command.Set:
                target = State(data["state"])
                if target is State.REQUESTED_STOP:
                    self.request_stop()
                elif target is State.REQUESTED_PAUSE:
                    self.request_pause()
                elif target is State.RUNNING:
                    self.resume()
                else:
                    self.fsm.transition_to(target)
            self.bus.reply(msg, {"state": self.fsm.state.value})
        elif ep == Property.HEARTBEAT:
            self.bus.reply(msg, {"heartbeat": time.time()})
        elif ep == Property.INSPECT_GRAPH:
            g = self.compiled.graph if self.compiled else self.graph
            self.bus.reply(msg, {
                "blocks": [{"name": b.name, "unique_name": b.unique_name,
                            "type": type(b).__name__} for b in g.blocks],
                "edges": [{"src": e.src.name, "src_port": e.src_port,
                           "dst": e.dst.name, "dst_port": e.dst_port,
                           "samples_per_step": e.samples_per_step}
                          for e in g.edges]})
        elif ep == Property.REGISTRY_BLOCK_TYPES:
            # ≈ Graph.hpp:528 propertyCallbackRegistryBlockTypes
            # (qa_GraphMessages "Get available block types")
            from .registry import global_registry
            self.bus.reply(msg, {"types": sorted(global_registry.known_blocks())})
        elif ep == Property.EMPLACE_BLOCK:
            b = self.graph.emplace(data["type"], **data.get("properties", {}))
            self._dirty = True
            self.bus.reply(msg, {"unique_name": b.unique_name, "name": b.name})
        elif ep == Property.REMOVE_BLOCK:
            b = self._find_block(data["name"])
            if b is None:
                raise GrError(f"no block {data['name']!r}")
            self.graph.remove(b)
            self._dirty = True
            self.bus.reply(msg, {})
        elif ep == Property.REPLACE_BLOCK:
            # ≈ kReplaceBlock (Scheduler.hpp:227-238): a new block takes over
            # the old one's name and connections; re-jit at the boundary
            old = self._find_block(data["name"])
            if old is None:
                raise GrError(f"replace: no block {data['name']!r}")
            new = self.graph.registry.create(data["type"],
                                             **data.get("properties", {}))
            new.name = old.name
            # validate EVERY rewired port before mutating anything — a
            # mismatch must leave the running graph untouched
            for e in self.graph.edges:
                if e.src is old:
                    new.port(e.src_port, output=True)
                if e.dst is old:
                    new.port(e.dst_port, output=False)
            for e in self.graph.edges:
                if e.src is old:
                    e.src = new
                if e.dst is old:
                    e.dst = new
            self.graph.blocks[self.graph.blocks.index(old)] = new
            self.graph.message_edges = [
                (new if s is old else s, new if d is old else d)
                for s, d in self.graph.message_edges]
            self._dirty = True
            self.bus.reply(msg, {"unique_name": new.unique_name,
                                 "name": new.name})
        elif ep == Property.EMPLACE_EDGE:
            src = self._find_block(data["src"]); dst = self._find_block(data["dst"])
            if src is None or dst is None:
                raise GrError("emplace edge: unknown block")
            self.graph.connect(src, dst, src_port=data.get("src_port"),
                               dst_port=data.get("dst_port"))
            self._dirty = True
            self.bus.reply(msg, {})
        elif ep == Property.GRAPH_GRC:
            # ≈ kGraphGRC (Scheduler.hpp:233): Get returns the running graph
            # as GRC YAML; Set hot-swaps the WHOLE flowgraph from YAML (new
            # graph compiles at the next step boundary, fresh states)
            from .yaml_io import load_grc, save_grc
            if cmd is Command.Set:
                new_graph = load_grc(str(data["grc"]),
                                     registry=self.graph.registry)
                self.graph = new_graph
                self._states = {}
                self._abs_in.clear()
                self._abs_out.clear()
                self._finished_sources.clear()
                self._eos_announced.clear()
                self._inflight.clear()
                self._dirty = True
                self.bus.reply(msg, {"blocks": len(new_graph.blocks)})
            else:
                self.bus.reply(msg, {"grc": save_grc(
                    self.graph, sample_rate=self.sample_rate,
                    block_len=self.block_len)})
        elif ep == Property.REMOVE_EDGE:
            before = len(self.graph.edges)
            self.graph.edges = [
                e for e in self.graph.edges
                if not (e.src.name == data["src"] and e.dst.name == data["dst"])]
            if len(self.graph.edges) == before:
                raise GrError("remove edge: no match")
            self._dirty = True
            self.bus.reply(msg, {})
        else:
            self.bus.reply(msg, Error.here(f"unknown scheduler endpoint {ep!r}"))

    def _find_block(self, name: str) -> Block | None:
        g = self.graph
        for b in g.blocks:
            if b.name == name or b.unique_name == name:
                return b
        if self.compiled:
            for b in self.compiled.order:
                if b.name == name or b.unique_name == name:
                    return b
        return None

    # -- watchdog (≈ Scheduler.hpp:845) ---------------------------------------
    def _start_watchdog(self) -> None:
        if self.watchdog_timeout is None or self._watchdog is not None:
            return
        def monitor():
            while self.fsm.state in (State.RUNNING, State.REQUESTED_PAUSE, State.PAUSED,
                                     State.INITIALISED):
                time.sleep(self.watchdog_timeout / 4)
                if (self.fsm.state is State.RUNNING
                        and time.monotonic() - self._last_progress > self.watchdog_timeout
                        and not self._stall_flagged):
                    self._stall_flagged = True
                    stalled_s = time.monotonic() - self._last_progress
                    self.bus.notify(self.name, "Watchdog",
                                    {"stalled_for_s": stalled_s,
                                     "step": self._step})
                    if self.watchdog_action == "stop":
                        # ≈ the reference watchdog escalating on non-responsive
                        # blocks (Scheduler.hpp:845): wind the graph down
                        self.request_stop()
                    elif self.watchdog_action == "error":
                        # collective-timeout escalation (SURVEY §7): a pump
                        # wedged inside a collective cannot be unwound from
                        # Python — a dead peer process leaves the survivor
                        # blocked in Gloo/NCCL forever. Mark the run failed
                        # NOW so waiters fail fast and diagnosably; the
                        # wedged pump thread is abandoned (daemon).
                        multi = jax.process_count() > 1
                        msg = (f"watchdog: no progress for {stalled_s:.1f}s "
                               f"at step {self._step}"
                               + (" — collective timeout: a peer process "
                                  "has likely died or partitioned "
                                  f"(process {jax.process_index()} of "
                                  f"{jax.process_count()})" if multi else
                                  " — pump stalled (device hang or wedged "
                                  "host feeder)"))
                        self.error = Error.here(msg, block=self.name)
                        self.bus.notify(self.name, "Error", {"message": msg})
                        self.fsm.force_error()
                        return
        from ..utils import thread_pool
        self._watchdog = thread_pool.spawn(monitor, name=f"{self.name}-watchdog")

    def _call_hooks(self, which: str) -> None:
        if self.compiled is None:
            return
        for b in self.compiled.order:
            try:
                getattr(b, which)()
            except Exception as e:
                self.error = Error.here(f"{b.name}.{which}(): {e}", block=b.name)
                self.bus.notify(b.name, "Error", {"message": str(e)})


def _remove_deep(g: Graph, block: Block) -> bool:
    """Remove a block from ``g`` or any nested subgraph (+ dangling exports)."""
    if block in g.blocks:
        g.remove(block)
        g._exports_in = {k: v for k, v in g._exports_in.items()
                         if v[0] is not block}
        g._exports_out = {k: v for k, v in g._exports_out.items()
                          if v[0] is not block}
        return True
    for b in g.blocks:
        if isinstance(b, Graph) and _remove_deep(b, block):
            return True
    return False


def _pad_to(a: np.ndarray, shape: tuple[int, ...], dtype) -> np.ndarray:
    """Zero-pad a host-fed array up to the static per-step shape (partial final block)."""
    a = np.asarray(a, dtype=dtype)
    if a.shape == tuple(shape):
        return a
    out = np.zeros(shape, dtype=dtype)
    sl = tuple(slice(0, min(s, t)) for s, t in zip(a.shape, shape))
    out[sl] = a[sl]
    return out


def _same_struct(a: Any, b: Any) -> bool:
    try:
        ta = jax.tree.structure(a); tb = jax.tree.structure(b)
        if ta != tb:
            return False
        la = jax.tree.leaves(a); lb = jax.tree.leaves(b)
        return all(getattr(x, "shape", None) == getattr(y, "shape", None)
                   and getattr(x, "dtype", None) == getattr(y, "dtype", None)
                   for x, y in zip(la, lb))
    except Exception:
        return False


def _inspect_block(block: Block) -> dict[str, Any]:
    return {
        "name": block.name,
        "unique_name": block.unique_name,
        "type": type(block).__name__,
        "inputs": [p.name for p in block.in_ports],
        "outputs": [p.name for p in block.out_ports],
        "settings": block.settings.as_dict(),
        "ratio": [block.ratio.numerator, block.ratio.denominator],
    }


@register_scheduler("Simple")
class SimpleScheduler(Scheduler):
    """Insertion-order scheduling (≈ gr::scheduler::Simple, Scheduler.hpp:1514).
    With a single fused device program, execution order is the topological order —
    the policy distinction only affects host-side tag walking, which is already topo."""


@register_scheduler("BreadthFirst")
class BreadthFirstScheduler(Scheduler):
    """≈ gr::scheduler::BreadthFirst (Scheduler.hpp:1580); same fused execution."""


@register_scheduler("DepthFirst")
class DepthFirstScheduler(Scheduler):
    """≈ gr::scheduler::DepthFirst (Scheduler.hpp:1658). With one fused device
    program the traversal-order distinction vanishes (XLA schedules the DAG);
    kept for API parity."""
