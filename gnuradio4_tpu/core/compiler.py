"""Graph → jitted XLA program.

The reference pumps samples through per-block virtual ``work()`` calls scheduled by
thread pools (core/include/gnuradio-4.0/Scheduler.hpp:722 poolWorker →
Block.hpp:2054 workInternal). Device-side inversion: the *entire flattened graph* is
traced once into a single jitted step function

    step(states, params, feeds) → (states', sink_inputs)

so XLA fuses all elementwise blocks into neighboring FFT/matmul kernels, keeps
intermediates in device memory without host round-trips, and the only per-step host work is
feeding sources and draining sinks. Carried block state (FIR tails, NCO phase — the
analog of HistoryBuffer) threads through the step as a donated pytree, so state stays
on-device across steps.

Static shapes: per-edge samples-per-step come from Graph.resolve_rates (the rate
algebra replacing the reference's per-work() computeResampling, Block.hpp:1611).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from .block import Block, BlockCtx, SinkBlock
from .errors import GrError
from .graph import Edge, Graph
from .stream import canonical_dtype


@dataclasses.dataclass
class CompiledGraph:
    """A jit-compiled, rate-resolved flowgraph ready for the streaming scheduler."""

    graph: Graph                      # flattened
    order: list[Block]
    in_len: dict[str, int]            # block unique_name → input samples/step
    out_len: dict[str, int]
    block_ctx: dict[str, BlockCtx]
    step_fn: Callable                 # jitted
    fed_blocks: list[Block]           # sources taking host-fed arrays
    sink_names: list[str]
    sample_rate: float
    block_len: int
    mesh: Any = None
    loop_groups: list = dataclasses.field(default_factory=list)
    fb_init_states: dict = dataclasses.field(default_factory=dict)
    batch_steps: int = 1              # sub-steps fused per dispatch (lax.scan)

    # -- runtime-facing helpers ------------------------------------------------
    def init_states(self) -> dict[str, Any]:
        states = {b.unique_name: b.init_state(self.block_ctx[b.unique_name])
                  for b in self.order}
        states.update(self.fb_init_states)
        if self.mesh is not None:
            # under a mesh the step returns every state replicated (P()); a
            # state left on one device would make the second dispatch compile
            # the step again for the new input placement
            from jax.sharding import NamedSharding, PartitionSpec
            states = jax.device_put(
                states, NamedSharding(self.mesh, PartitionSpec()))
        return states

    _params_cache: Any = None

    def gather_params(self, refresh: bool = True) -> dict[str, dict[str, Any]]:
        """Dynamic params for the next step. Blocks that override
        ``prepare_params`` (tag-derived values) refresh every step; the rest are
        cached until :meth:`invalidate_params` (settings applied).

        ``refresh=False`` (batched pump): skip the per-step refresh — the
        batched dispatch carries per-sub-step overlay snapshots for every
        prepare_params-overriding block, so refreshing the base too is a
        redundant host-to-device copy every super-step."""
        from .block import Block
        if self._params_cache is None:
            self._params_cache = _device_params({
                b.unique_name: b.prepare_params(b.settings.dynamic_params())
                for b in self.order}, self.mesh)
        elif refresh:
            for b in self.order:
                if type(b).prepare_params is not Block.prepare_params:
                    self._params_cache[b.unique_name] = _device_params(
                        b.prepare_params(b.settings.dynamic_params()),
                        self.mesh)
        return self._params_cache

    def invalidate_params(self) -> None:
        self._params_cache = None

    _zero_feeds_cache: Any = None

    def zero_feeds(self) -> dict[str, dict[str, np.ndarray]]:
        if self._zero_feeds_cache is None:
            feeds: dict[str, dict[str, np.ndarray]] = {}
            for b in self.fed_blocks:
                ctx = self.block_ctx[b.unique_name]
                feeds[b.unique_name] = {
                    p.name: np.zeros(_shape(ctx.channels.get(p.name, 0),
                                            ctx.out_len[p.name]),
                                     dtype=_feed_dtype(b, p.name))
                    for p in b.out_ports}
            self._zero_feeds_cache = feeds
        return self._zero_feeds_cache

    _ratio_cache: Any = None

    def ratio_cache(self, b) -> tuple[int, int]:
        """``b.ratio`` as a static (numerator, denominator) pair — the ratio is
        settings-derived, so it is fixed for the lifetime of one compile (any
        change marks the scheduler dirty and produces a new CompiledProgram)."""
        if self._ratio_cache is None:
            self._ratio_cache = {}
        got = self._ratio_cache.get(b.unique_name)
        if got is None:
            r = b.ratio
            got = (r.numerator, r.denominator)
            self._ratio_cache[b.unique_name] = got
        return got

    _pump_plan: Any = None

    def pump_plan(self):
        """Static per-block record for the scheduler's per-step validity
        passes: (block, uname, is_feed, has_ins, srcs=((src_uname,
        src_out_len)...), ratio_num, ratio_den, stock_clamp, allow_underrun).
        Everything here is settings/graph-derived and fixed per compile."""
        if self._pump_plan is None:
            from .block import Block
            in_edges = self.in_edges_by_dst()
            plan = []
            for b in self.order:
                uname = b.unique_name
                srcs = tuple(
                    (e.src.unique_name, self.out_len[e.src.unique_name])
                    for e in in_edges[uname])
                num, den = self.ratio_cache(b)
                plan.append((b, uname, bool(getattr(b, "FEED", False)),
                             bool(srcs), srcs, num, den,
                             type(b).clamp_valid is Block.clamp_valid,
                             bool(getattr(b, "ALLOW_UNDERRUN", False))))
            self._pump_plan = plan
        return self._pump_plan

    _tag_plan: Any = None

    def tag_plan(self):
        """Static per-block tag-walk plan: (block, uname, [(src_key,
        dst_port)], fast, is_sink, out_port_names, is_source). ``fast`` marks
        blocks with stock propagation and no host tag emission — with no
        incoming tags they can be skipped wholesale each step."""
        if self._tag_plan is None:
            from .block import Block
            in_edges = self.in_edges_by_dst()
            plan = []
            for b in self.order:
                uname = b.unique_name
                in_keys = [((e.src.unique_name, e.src_port), e.dst_port)
                           for e in in_edges[uname]]
                fast = (type(b).emit_tags is Block.emit_tags
                        and type(b).process_tags is Block.process_tags
                        and not getattr(b, "WANTS_TAG_ARRAYS", False))
                plan.append((b, uname, in_keys, fast,
                             uname in self.sink_names,
                             [p.name for p in b.out_ports],
                             not in_edges[uname]))
            self._tag_plan = plan
        return self._tag_plan

    def in_edges_by_dst(self) -> dict[str, list]:
        if not hasattr(self, "_in_edges_cache") or self._in_edges_cache is None:
            m: dict[str, list] = {b.unique_name: [] for b in self.order}
            for e in self.graph.edges:
                m[e.dst.unique_name].append(e)
            self._in_edges_cache = m
        return self._in_edges_cache

    def step(self, states, params, feeds, overlays=None):
        if self.batch_steps > 1:
            return self.step_fn(states, params, feeds,
                                {} if overlays is None else overlays)
        return self.step_fn(states, params, feeds)


def _shape(channels: int, n: int) -> tuple[int, ...]:
    return (n,) if channels == 0 else (channels, n)


def _device_params(tree, mesh=None):
    """Push a params tree to the device once, so that cached host scalars
    do not pay an implicit host-to-device copy on every step. Under a mesh
    the params are placed replicated on it (the step takes them as ``P()``);
    on one device they would be copied to every other device each step."""
    if mesh is None:
        return jax.device_put(tree)
    from jax.sharding import NamedSharding, PartitionSpec
    return jax.device_put(tree, NamedSharding(mesh, PartitionSpec()))


def _run_loop_group_replicated(group: dict, states, params, values, new_states,
                               run_loop_group, in_edges, axis_name: str
                               ) -> None:
    """Run a feedback-loop group inside a manual shard_map as a replicated
    island: all_gather its external inputs to global length, execute the scan
    (identical on every shard — carry is replicated), re-slice the group's
    outputs to local shards."""
    member_names = group["members"]
    ext: dict[tuple[str, str], Any] = {}
    for b in group["order"]:
        for e in in_edges[b.unique_name]:
            if e.feedback or e.src.unique_name in member_names:
                continue
            key = (e.src.unique_name, e.src_port)
            if key not in ext:
                ext[key] = values[key]
                values[key] = jax.lax.all_gather(values[key], axis_name,
                                                 axis=-1, tiled=True)
    run_loop_group(group, states, params, values, new_states)
    idx = jax.lax.axis_index(axis_name)
    size = jax.lax.axis_size(axis_name)
    for key, v in ext.items():
        values[key] = v   # restore locals for non-loop consumers
    for b in group["order"]:
        for p in b.out_ports:
            key = (b.unique_name, p.name)
            if key in values:
                full = values[key]
                n_l = full.shape[-1] // size
                values[key] = jax.lax.dynamic_slice_in_dim(
                    full, idx * n_l, n_l, axis=-1)


def _fb_init_values(group: dict, out_channels: dict, out_dtypes: dict
                    ) -> dict[str, jnp.ndarray]:
    """Initial back-edge values: fb_init broadcast over [channels?, delay]."""
    fb0 = {}
    for e in group["fb"]:
        key = (e.src.unique_name, e.src_port)
        ch = out_channels[key]
        shape = (group["delay"],) if ch == 0 else (ch, group["delay"])
        fb0[group["fb_keys"][key]] = jnp.full(
            shape, e.fb_init, dtype=np.dtype(out_dtypes[key]))
    return fb0


def _plan_feedback(flat: Graph, order: list[Block], fb_edges: list[Edge],
                   in_len: dict[str, int], in_edges: dict[str, list[Edge]],
                   sink_names: list[str], fed_names: set[str]
                   ) -> tuple[list[Any], list[dict]]:
    """Identify feedback-loop groups and build a contracted execution plan.

    A loop group = the blocks on any forward path from a feedback edge's dst to
    its src (overlapping groups merge). The plan is a topological order over
    the condensation: plain blocks interleaved with group dicts
    ``{members, order, delay, fb}``.
    """
    from fractions import Fraction
    fwd_out: dict[str, list[Edge]] = {b.unique_name: [] for b in flat.blocks}
    for e in flat.edges:
        if not e.feedback:
            fwd_out[e.src.unique_name].append(e)

    def descendants(u0: str) -> set[str]:
        seen: set[str] = set()
        stack = [u0]
        while stack:
            u = stack.pop()
            for e in fwd_out[u]:
                v = e.dst.unique_name
                if v not in seen:
                    seen.add(v)
                    stack.append(v)
        return seen

    desc_cache = {b.unique_name: descendants(b.unique_name) for b in order}
    raw_groups: list[set[str]] = []
    for e in fb_edges:
        d, s = e.dst.unique_name, e.src.unique_name
        reach = desc_cache[d] | {d}
        members = {u for u in reach if s == u or s in desc_cache[u]}
        if s not in members:
            raise GrError(f"feedback edge {e} closes no forward path "
                          f"{e.dst.name} → {e.src.name}")
        raw_groups.append(members)
    merged: list[set[str]] = []
    for g in raw_groups:
        acc = set(g)
        rest = []
        for m in merged:
            if m & acc:
                acc |= m
            else:
                rest.append(m)
        merged = rest + [acc]

    by_uname = {b.unique_name: b for b in order}
    groups: list[dict] = []
    gid_of: dict[str, int] = {}
    for gi, mem in enumerate(merged):
        blocks = [b for b in order if b.unique_name in mem]  # topo within group
        lens = {in_len[u] for u in mem}
        for b in blocks:
            if b.ratio != Fraction(1):
                raise GrError(f"feedback loop member {b.name} has ratio "
                              f"{b.ratio}; loop blocks must be rate-1")
            if b.unique_name in sink_names or b.unique_name in fed_names:
                raise GrError(f"feedback loop member {b.name} is a sink/"
                              f"host-fed block; move it outside the loop")
        if len(lens) != 1:
            raise GrError(f"feedback loop {[b.name for b in blocks]} has "
                          f"unequal step lengths {sorted(lens)}")
        edges_in = [e for e in fb_edges if e.src.unique_name in mem]
        # stable back-edge value keys (distinct src ports, group-local index):
        # checkpoint-portable across processes, unlike unique_names
        fb_keys: dict[tuple[str, str], str] = {}
        for e in edges_in:
            k = (e.src.unique_name, e.src_port)
            if k not in fb_keys:
                fb_keys[k] = f"v{len(fb_keys)}"
        delays = {e.delay for e in edges_in}
        if len(delays) != 1:
            raise GrError(f"feedback edges of one loop must share a delay; "
                          f"got {sorted(delays)}")
        delay = delays.pop()
        n = lens.pop()
        if n % delay:
            raise GrError(f"feedback delay {delay} must divide the loop's "
                          f"samples-per-step {n}")
        groups.append({"members": mem, "order": blocks, "delay": delay,
                       "fb": edges_in, "fb_keys": fb_keys,
                       "state_key": f"__fb__{gi}"})
        for u in mem:
            gid_of[u] = gi

    # condensation topo sort (groups contracted to one node each)
    def node_of(u: str):
        return ("g", gid_of[u]) if u in gid_of else ("b", u)

    nodes: list[tuple[str, Any]] = []
    seen_nodes: set = set()
    for b in order:
        nd = node_of(b.unique_name)
        if nd not in seen_nodes:
            seen_nodes.add(nd)
            nodes.append(nd)
    indeg = {nd: 0 for nd in nodes}
    succ: dict[Any, list[Any]] = {nd: [] for nd in nodes}
    for e in flat.edges:
        if e.feedback:
            continue
        a, b_ = node_of(e.src.unique_name), node_of(e.dst.unique_name)
        if a != b_:
            succ[a].append(b_)
            indeg[b_] += 1
    ready = [nd for nd in nodes if indeg[nd] == 0]
    plan_nodes: list[Any] = []
    while ready:
        nd = ready.pop(0)
        plan_nodes.append(nd)
        for m in succ[nd]:
            indeg[m] -= 1
            if indeg[m] == 0:
                ready.append(m)
    if len(plan_nodes) != len(nodes):
        raise GrError("feedback loop groups form a cycle among themselves; "
                      "restructure the graph")
    exec_plan: list[Any] = []
    for kind, v in plan_nodes:
        exec_plan.append(groups[v] if kind == "g" else by_uname[v])
    return exec_plan, groups


def _feed_dtype(block: Block, port: str):
    d = block.out_dtype(port, {})
    return np.dtype(canonical_dtype(d)) if d is not None else np.float32


def compile_graph(graph: Graph, *, block_len: int = 1 << 16,
                  sample_rate: float = 1.0, mesh: Any = None,
                  jit: bool = True, donate_state: bool = True,
                  barrier_edges: bool = True,
                  batch_steps: int = 1) -> CompiledGraph:
    """Flatten, validate, solve rates/dtypes/channels, trace, and jit the graph.

    Mesh lowering: a mesh axis named ``sp`` time-shards the WHOLE graph — the
    step is traced inside ``shard_map`` (manual over ``sp``), every stream value
    becomes a local time shard, and each block lowers per its sp protocol
    (Block.sp_halo: time-local map / ppermute halo exchange / replicated gather
    island). A ``chan`` axis (without ``sp``) shards multi-channel streams via
    GSPMD constraints. This is the runtime parallelizing *arbitrary* flowgraphs,
    the analog of the reference scheduler running any graph over its worker
    pool (Scheduler.hpp:79-86,722).
    """
    flat = graph.flatten()
    flat.validate()
    # Edge ComputeDomain consumption (≈ reference per-edge domain consumed at
    # buffer binding, BlockModel.hpp:89-97): a 'host' domain forces the dst
    # block's inputs through the host each step (HOST_TAP delivery — the data
    # crosses the device→host boundary instead of staying fused on device).
    from .compute_domain import DomainKind
    for e in flat.edges:
        if e.domain is None:
            continue
        if e.domain.kind is DomainKind.FPGA:
            raise GrError(f"edge {e} requests compute domain "
                          f"{e.domain.kind.value!r}; this build targets "
                          f"gpu/host only")
        if e.domain.kind is DomainKind.HOST:
            if not hasattr(e.dst, "consume"):
                raise GrError(
                    f"edge {e} has domain=host but {e.dst.name} has no "
                    f"consume() hook to receive host-side data; use a "
                    f"SinkBlock or a block with HOST_TAP semantics")
            e.dst.HOST_TAP = True
    order = flat.topological_order()
    sp = int(mesh.shape["sp"]) if (
        mesh is not None and "sp" in getattr(mesh, "axis_names", ())) else 1
    in_len, out_len = flat.resolve_rates(block_len, sample_rate, shard=sp)

    # per-edge dtype/channel resolution (compile-time type inference over the
    # DAG — feedback back-edges resolve afterwards from their src's outputs)
    in_edges: dict[str, list[Edge]] = {b.unique_name: [] for b in flat.blocks}
    for e in flat.edges:
        in_edges[e.dst.unique_name].append(e)

    block_ctx: dict[str, BlockCtx] = {}
    out_channels: dict[tuple[str, str], int] = {}
    out_dtypes: dict[tuple[str, str], Any] = {}

    for b in order:
        ins = [e for e in in_edges[b.unique_name] if not e.feedback]
        in_ch = {e.dst_port: out_channels[(e.src.unique_name, e.src_port)] for e in ins}
        in_dt = {e.dst_port: out_dtypes[(e.src.unique_name, e.src_port)] for e in ins}
        # input-side sample rate = the producing edges' resolved rate
        rate_b = max((e.sample_rate for e in ins), default=sample_rate)
        ch_map: dict[str, int] = dict(in_ch)
        for p in b.out_ports:
            ch = b.out_channels(p.name, in_ch)
            dt = canonical_dtype(b.out_dtype(p.name, in_dt))
            out_channels[(b.unique_name, p.name)] = ch
            out_dtypes[(b.unique_name, p.name)] = dt
            ch_map[p.name] = ch
        n_in = in_len[b.unique_name]
        n_out = out_len[b.unique_name]
        dt_map = dict(in_dt)
        for p in b.out_ports:
            dt_map[p.name] = out_dtypes[(b.unique_name, p.name)]
        block_ctx[b.unique_name] = BlockCtx(
            in_len={p.name: n_in for p in b.in_ports},
            out_len={p.name: n_out for p in b.out_ports},
            sample_rate=rate_b,
            params={},  # filled per-trace
            channels=ch_map,
            dtypes=dt_map,
            mesh=mesh,
        )
    for e in flat.edges:
        e.channels = out_channels[(e.src.unique_name, e.src_port)]
        e.dtype = out_dtypes[(e.src.unique_name, e.src_port)]
        # resolved-dtype check against declared input port types (≈ Graph.hpp:493)
        for p in e.dst.in_ports:
            if p.name == e.dst_port and p.dtype is not None \
                    and np.dtype(p.dtype) != np.dtype(e.dtype):
                raise GrError(
                    f"dtype mismatch on {e}: {e.src.name}.{e.src_port} produces "
                    f"{np.dtype(e.dtype).name}, {e.dst.name}.{e.dst_port} expects "
                    f"{np.dtype(p.dtype).name}")

    # -- rotation absorption (graph-level algebraic pass) ---------------------
    # A frequency-translating producer's output de-rotation y·e^{-jωm} is a
    # full-rate elementwise HBM pass. Consumers that are invariant to (FFT
    # magnitude views: a linear phase ramp folds into a COMPLEX window, the
    # per-frame unit phasor cancels in |·|) or can correct for (quadrature
    # demod: a constant offset) a residual linear phase absorb it instead, and
    # the producer skips the NCO multiply entirely. The analog of GNU Radio's
    # rotator-merging optimizations, done at compile time over the whole graph.
    import os
    for b in order:
        b._rotation_absorbed = False                  # reset stale flags
        if hasattr(b, "_absorbed_rotation"):
            b._absorbed_rotation = {}
    for b in order:
        if os.environ.get("GR4_NO_ROTATION_ABSORB") == "1":
            break                                     # A/B + debugging escape
        fn = getattr(b, "rotation_descriptor", None)
        if fn is None:
            continue
        desc = fn(block_ctx[b.unique_name].sample_rate)
        if desc is None:
            continue
        outs = [e for e in flat.edges if e.src is b]
        if not outs or any(e.feedback for e in outs):
            continue
        if all(getattr(e.dst, "absorb_rotation", None) is not None
               and e.dst.absorb_rotation(desc, e.dst_port) for e in outs):
            b._rotation_absorbed = True
            for e in outs:
                if not getattr(e.dst, "_absorbed_rotation", None):
                    e.dst._absorbed_rotation = {}
                e.dst._absorbed_rotation[e.dst_port] = desc

    # epilogue fusion (opt-in, GR4_FUSE_EPILOGUE=1): the per-edge
    # optimization_barrier exists to stop XLA fusing expensive producers
    # into MULTI-read consumers (measured 2× on the headline chain) — but a
    # SINGLE-reader elementwise consumer (quadrature demod: arg(v·conj v⁻¹))
    # is exactly where producer fusion saves a full HBM round trip of the
    # intermediate. Blocks declare EPILOGUE_FUSABLE; the barrier is skipped
    # on edges whose one consumer opts in.
    out_consumers: dict[tuple[str, str], int] = {}
    for e in flat.edges:
        k = (e.src.unique_name, e.src_port)
        out_consumers[k] = out_consumers.get(k, 0) + 1
    epilogue_ok: set[tuple[str, str]] = set()
    if os.environ.get("GR4_FUSE_EPILOGUE") == "1":
        for e in flat.edges:
            k = (e.src.unique_name, e.src_port)
            if out_consumers[k] == 1 and not e.feedback \
                    and getattr(e.dst, "EPILOGUE_FUSABLE", False):
                epilogue_ok.add(k)

    fed_blocks = [b for b in order if getattr(b, "FEED", False)]
    fed_names = {b.unique_name for b in fed_blocks}
    # sinks: terminal blocks + HOST_TAP blocks (mid-graph blocks whose inputs
    # must reach the host each step, e.g. nested-scheduler subgraphs)
    sinks = [b for b in order if isinstance(b, SinkBlock) or not b.out_ports
             or getattr(b, "HOST_TAP", False)]
    sink_names = [b.unique_name for b in sinks]

    # local (per-shard) contexts for the sp path: lengths divided by sp
    local_ctx = {
        uname: dataclasses.replace(
            c, in_len={k: v // sp for k, v in c.in_len.items()},
            out_len={k: v // sp for k, v in c.out_len.items()})
        for uname, c in block_ctx.items()} if sp > 1 else block_ctx

    # -- feedback loops (≈ reference feedback merges, BlockMerging.hpp:628-645):
    # each cycle closed by a feedback edge is lowered as a lax.scan over
    # delay-sized sub-chunks — the back-edge value is the scan carry, one
    # sub-chunk behind, and member block states thread through the carry too.
    fb_edges = [e for e in flat.edges if e.feedback]
    loop_groups: list[dict] = []
    exec_plan: list[Any] = list(order)
    if fb_edges:
        exec_plan, loop_groups = _plan_feedback(
            flat, order, fb_edges, in_len, in_edges, sink_names, fed_names)

    def run_loop_group(group, states, params, values, new_states):
        L = group["delay"]
        members: list[Block] = group["order"]
        S = in_len[members[0].unique_name] // L

        def split(v):   # [..., T] → [S, ..., L]
            return jnp.moveaxis(v.reshape(*v.shape[:-1], S, L), -2, 0)

        def unsplit(v):  # [S, ..., L] → [..., T]
            w = jnp.moveaxis(v, 0, -2)
            return w.reshape(*w.shape[:-2], S * L)

        member_names = {b.unique_name for b in members}
        xs = {}
        for b in members:
            for e in in_edges[b.unique_name]:
                if e.feedback or e.src.unique_name in member_names:
                    continue
                xs[(b.unique_name, e.dst_port)] = split(
                    values[(e.src.unique_name, e.src_port)])
        # the back-edge values persist ACROSS scheduler steps as graph state
        # (keyed "__fb__<i>"), seeded from fb_init on the very first step
        fb0 = states.get(group["state_key"])
        if fb0 is None:
            fb0 = _fb_init_values(group, out_channels, out_dtypes)
        carry0 = (fb0, {b.unique_name: states.get(b.unique_name)
                        for b in members})

        def body(carry, x_t):
            fb, sts = carry
            vals: dict[tuple[str, str], jnp.ndarray] = {}
            new_sts = {}
            for b in members:
                uname = b.unique_name
                lctx = dataclasses.replace(
                    block_ctx[uname], params=params.get(uname, {}),
                    in_len={p.name: L for p in b.in_ports},
                    out_len={p.name: L for p in b.out_ports})
                ins = {}
                for e in in_edges[uname]:
                    skey = (e.src.unique_name, e.src_port)
                    if e.feedback:
                        ins[e.dst_port] = fb[group["fb_keys"][skey]]
                    elif e.src.unique_name in member_names:
                        ins[e.dst_port] = vals[skey]
                    else:
                        ins[e.dst_port] = x_t[(uname, e.dst_port)]
                st, outs = b.apply(sts[uname], ins, lctx)
                new_sts[uname] = st
                for pname, arr in outs.items():
                    vals[(uname, pname)] = arr
            new_fb = {fk: vals[skey]
                      for skey, fk in group["fb_keys"].items()}
            return (new_fb, new_sts), vals

        # xs may be empty (a self-contained oscillator loop with no external
        # stream inputs) — scan then needs an explicit length
        (fb_f, sts_f), ys = jax.lax.scan(body, carry0, xs if xs else None,
                                         length=S)
        new_states[group["state_key"]] = fb_f
        for b in members:
            new_states[b.unique_name] = sts_f[b.unique_name]
        for key, stacked in ys.items():
            values[key] = unsplit(stacked)

    def step(states, params, feeds):
        values: dict[tuple[str, str], jnp.ndarray] = {}
        new_states = {}
        sink_ins: dict[str, dict[str, jnp.ndarray]] = {}
        for item in exec_plan:
            if isinstance(item, dict):   # contracted feedback-loop group
                try:
                    if sp > 1:
                        # under time sharding the sequential loop runs as a
                        # replicated island: gather its external inputs to
                        # full length, scan identically on every shard (the
                        # carry is replicated state), slice outputs local
                        _run_loop_group_replicated(
                            item, states, params, values, new_states,
                            run_loop_group, in_edges, "sp")
                    else:
                        run_loop_group(item, states, params, values,
                                       new_states)
                except Exception as e:
                    if isinstance(e, GrError):
                        raise
                    names = [b.name for b in item["order"]]
                    raise GrError(f"feedback loop {names} failed during "
                                  f"trace: {type(e).__name__}: {e}") from e
                continue
            b = item
            uname = b.unique_name
            ctx = dataclasses.replace(block_ctx[uname], params=params.get(uname, {}))
            ins = {e.dst_port: values[(e.src.unique_name, e.src_port)]
                   for e in in_edges[uname]}
            if uname in fed_names:
                # host-fed sources see their fed arrays as inputs (identity default)
                ins = {**feeds.get(uname, {}), **ins}
            if uname in sink_names:
                sink_ins[uname] = ins
            try:
                if sp > 1:
                    lctx = dataclasses.replace(local_ctx[uname],
                                               params=ctx.params)
                    st, outs = b.apply_sp(states.get(uname), ins, ctx, lctx,
                                          "sp")
                else:
                    st, outs = b.apply(states.get(uname), ins, ctx)
            except Exception as e:
                if isinstance(e, GrError):
                    raise
                raise GrError(f"{b.name} ({type(b).__name__}).apply failed "
                              f"during trace: {type(e).__name__}: {e}",
                              block=b.name) from e
            new_states[uname] = st
            for pname, arr in outs.items():
                if barrier_edges and hasattr(arr, "dtype") \
                        and (uname, pname) not in epilogue_ok:
                    # Materialize each block's output once (the analog of the
                    # reference's per-edge ring buffer, CircularBuffer.hpp:75):
                    # without this, XLA fuses expensive producers INTO
                    # multi-read consumers — e.g. the tone source's sin/cos
                    # recomputed inside every one of a 127-tap FIR's input
                    # windows — measured 2x slowdown on the headline chain.
                    arr = jax.lax.optimization_barrier(arr)
                if mesh is not None and \
                        (sp == 1 or "chan" in getattr(mesh, "axis_names", ())):
                    # GSPMD: constrain multi-channel streams onto the mesh —
                    # XLA partitions the fused program + inserts collectives.
                    # Composes with manual sp sharding: shard_map is manual
                    # over 'sp' only, so 'chan' constraints stay GSPMD-auto.
                    spec = b.out_sharding(pname, mesh,
                                          out_channels.get((uname, pname), 0))
                    if spec is not None:
                        from jax.sharding import NamedSharding
                        arr = jax.lax.with_sharding_constraint(
                            arr, NamedSharding(mesh, spec))
                values[(uname, pname)] = arr
        return new_states, sink_ins

    step_fn = step
    if sp > 1:
        from jax.sharding import PartitionSpec as P

        def _tspec(channels: int) -> Any:
            return P("sp") if channels == 0 else P(None, "sp")

        state_specs = {b.unique_name: P() for b in order}   # replicated
        for g_ in loop_groups:
            state_specs[g_["state_key"]] = P()   # back-edge carries: replicated
        feed_specs = {}
        for b in fed_blocks:
            ctx = block_ctx[b.unique_name]
            feed_specs[b.unique_name] = {
                p.name: _tspec(ctx.channels.get(p.name, 0))
                for p in b.out_ports}
        sink_specs: dict[str, dict[str, Any]] = {}
        for uname in sink_names:
            specs: dict[str, Any] = {}
            for e in flat.edges:
                if e.dst.unique_name == uname:
                    specs[e.dst_port] = _tspec(e.channels)
            b = next(bb for bb in order if bb.unique_name == uname)
            if uname in fed_names:   # fed host-tap: feeds appear in its ins
                ctx = block_ctx[uname]
                for p in b.out_ports:
                    specs.setdefault(p.name,
                                     _tspec(ctx.channels.get(p.name, 0)))
            sink_specs[uname] = specs
        step_fn = jax.shard_map(
            step, mesh=mesh, in_specs=(state_specs, P(), feed_specs),
            out_specs=(state_specs, sink_specs), axis_names={"sp"},
            check_vma=False)
    batch_steps = int(batch_steps)
    if batch_steps < 1:
        raise GrError(f"batch_steps must be >= 1, got {batch_steps}")
    if batch_steps > 1:
        # -- step batching (the per-dispatch host floor dominates small
        # blocks): fuse S scheduler sub-steps into ONE
        # jitted dispatch via lax.scan. Feeds arrive stacked [S, ...]; sink
        # inputs return stacked; block states thread through the scan carry
        # exactly as they thread across dispatches. ``overlays`` is a per-
        # sub-step params pytree (scan xs) carrying tag-accurate ramps and
        # mid-batch dynamic-settings changes — merged over the constant
        # ``params`` per sub-step, so per-key overrides keep the same
        # semantics as the unbatched per-step param refresh.
        # The analog of the reference amortizing per-work() overhead in its
        # hot loop (Scheduler.hpp:722).
        inner_fn = step_fn
        S = batch_steps

        def step_batched(states, params, feeds_stacked, overlays):
            def body(st, xs):
                fd, ov = xs
                p = params
                if ov:                      # static structure check (pytree)
                    p = dict(p)
                    for uname_, od in ov.items():
                        p[uname_] = {**p.get(uname_, {}), **od}
                return inner_fn(st, p, fd)

            return jax.lax.scan(body, states, (feeds_stacked, overlays),
                                length=S)

        step_fn = step_batched
    if jit:
        donate = (0,) if donate_state else ()
        pin = {}
        if mesh is not None:
            # states leave every dispatch replicated, as init_states places
            # them: GSPMD would otherwise shard per-channel states over
            # 'chan', and the next dispatch would recompile for that layout
            from jax.sharding import NamedSharding, PartitionSpec
            pin["out_shardings"] = (NamedSharding(mesh, PartitionSpec()), None)
        step_fn = jax.jit(step_fn, donate_argnums=donate, **pin)

    return CompiledGraph(
        graph=flat, order=order, in_len=in_len, out_len=out_len,
        block_ctx=block_ctx, step_fn=step_fn, fed_blocks=fed_blocks,
        sink_names=sink_names, sample_rate=sample_rate,
        block_len=in_len[order[0].unique_name] if order else block_len,
        mesh=mesh, loop_groups=loop_groups,
        fb_init_states={g["state_key"]:
                        _fb_init_values(g, out_channels, out_dtypes)
                        for g in loop_groups},
        batch_steps=batch_steps)
