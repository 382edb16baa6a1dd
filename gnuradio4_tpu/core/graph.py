"""Graph model: blocks + edges, validation, flatten, topological order, rate algebra.

Reference (core/include/gnuradio-4.0/Graph.hpp): ``Graph : Block<Graph>`` owns
type-erased blocks + lazy ``Edge`` records; ``connectPendingEdges`` binds ports to
shared ring buffers at scheduler start (Graph.hpp:744-812); ``graph::flatten``
(Graph.hpp:916) inlines nested graphs; ``computeAdjacencyList`` (Graph.hpp:932).

Design: the graph is a *description* that the compiler traces into one
jitted XLA program per scheduler step. Edges carry no buffers — they are SSA values in
the traced program (XLA fuses across them); buffer-ish behavior only exists at the
host↔device boundary (scheduler.py). The reference's per-work() chunk negotiation
(Block.hpp:1611 computeResampling) becomes a one-shot **rate algebra**: solve per-edge
samples-per-step from block ``ratio``/``alignment`` descriptors at compile time.
"""

from __future__ import annotations

import dataclasses
import math
from fractions import Fraction
from typing import Any, Iterable

from .block import Block, Port, PortRef
from .errors import ConnectionError_, GrError, RateError
from .registry import BlockRegistry, global_registry
from .stream import canonical_dtype


@dataclasses.dataclass
class Edge:
    """Connection descriptor (≈ gr::Edge, BlockModel.hpp:70-198). Buffer-size/weight
    fields are kept as scheduling metadata (host queue sizing), not device buffers."""

    src: Block
    src_port: str
    dst: Block
    dst_port: str
    name: str = ""
    min_buffer_size: int = 0
    weight: int = 0
    domain: Any = None  # ComputeDomain annotation (≈ per-edge domain, BlockModel.hpp:94)
    # feedback edges close graph cycles (≈ reference feedback merges,
    # BlockMerging.hpp:628-645): the value arrives at dst delayed by ``delay``
    # samples, initialized to ``fb_init``; lowered by the compiler as a
    # lax.scan carry over delay-sized sub-chunks
    feedback: bool = False
    delay: int = 1
    fb_init: float = 0.0
    # resolved by the compiler:
    samples_per_step: int = 0
    channels: int = 0
    dtype: Any = None
    sample_rate: float = 0.0

    def key(self) -> tuple[str, str]:
        return (self.src.unique_name, self.src_port)

    def __repr__(self):
        return (f"Edge({self.src.name}.{self.src_port} → {self.dst.name}.{self.dst_port}"
                + (f", n={self.samples_per_step}" if self.samples_per_step else "") + ")")


class Graph(Block):
    """Flowgraph container. Nests as a block (≈ Graph : Block<Graph>, Graph.hpp:347):
    use :meth:`export_in`/:meth:`export_out` to expose inner ports, then connect the
    Graph instance inside a parent graph; the compiler flattens before tracing."""

    def __init__(self, name: str | None = None, registry: BlockRegistry | None = None):
        super().__init__(name=name)
        self.blocks: list[Block] = []
        self.edges: list[Edge] = []
        self.message_edges: list[tuple[Block, Block]] = []
        self.registry = registry or global_registry
        # exported ports for subgraph use: public name -> (inner block, inner port)
        self._exports_in: dict[str, tuple[Block, str]] = {}
        self._exports_out: dict[str, tuple[Block, str]] = {}

    # -- construction ----------------------------------------------------------
    def add(self, block: Block) -> Block:
        if block in self.blocks:
            return block
        if any(b.unique_name == block.unique_name for b in self.blocks):
            raise GrError(f"duplicate block {block.unique_name}")
        self.blocks.append(block)
        block._graph = self
        return block

    def emplace(self, type_name: str, /, **settings: Any) -> Block:
        """Registry-based construction (≈ emplaceBlock(typeName, settings), Graph.hpp:429)."""
        return self.add(self.registry.create(type_name, **settings))

    def remove(self, block: Block) -> None:
        self.blocks.remove(block)
        self.edges = [e for e in self.edges if e.src is not block and e.dst is not block]
        self.message_edges = [(s, d) for s, d in self.message_edges
                              if s is not block and d is not block]

    def connect(self, src: Block | PortRef, dst: Block | PortRef,
                *, src_port: str | None = None, dst_port: str | None = None,
                name: str = "", min_buffer_size: int = 0, weight: int = 0,
                domain: Any = None, feedback: bool = False, delay: int = 1,
                fb_init: float = 0.0) -> Edge:
        """Connect an output port to an input port. Accepts ``blk["port"]`` refs,
        bare blocks (single-port inference), or string port names. ``domain``
        annotates device placement (ComputeDomain or "kind:backend:idx").

        ``feedback=True`` closes a cycle: dst sees src's output delayed by
        ``delay`` samples (initial value ``fb_init``) — graph-level loops
        (AGC/PLL control) without fusing into one block.
        """
        sref = self._resolve(src, src_port, output=True)
        dref = self._resolve(dst, dst_port, output=False)
        for b in (sref.block, dref.block):
            self.add(b)
        self._check_ports(sref, dref)
        if isinstance(domain, str):
            from .compute_domain import ComputeDomain
            domain = ComputeDomain.parse(domain)
        if feedback and delay < 1:
            raise ConnectionError_("feedback delay must be >= 1 sample")
        edge = Edge(sref.block, sref.port, dref.block, dref.port,
                    name=name, min_buffer_size=min_buffer_size, weight=weight,
                    domain=domain, feedback=feedback, delay=int(delay),
                    fb_init=float(fb_init))
        # single-writer per input port (ring semantics): reject double connection
        for e in self.edges:
            if e.dst is dref.block and e.dst_port == dref.port:
                raise ConnectionError_(
                    f"input {dref.block.name}.{dref.port} already connected")
        self.edges.append(edge)
        return edge

    def connect_chain(self, *blocks: Block) -> list[Edge]:
        """Convenience: connect b0→b1→…→bn via their sole stream ports."""
        return [self.connect(a, b) for a, b in zip(blocks, blocks[1:])]

    def connect_message(self, src: Block, dst: Block) -> None:
        """Async message edge (≈ MsgPortIn/Out): property maps posted by ``src``
        (Block.post_message) are delivered to ``dst.handle_message`` at step
        boundaries — no stream-rate coupling."""
        self.add(src)
        self.add(dst)
        self.message_edges.append((src, dst))

    def _resolve(self, obj: Block | PortRef, port: str | None, *, output: bool) -> PortRef:
        if isinstance(obj, PortRef):
            if obj.is_output != output:
                kind = "output" if output else "input"
                raise ConnectionError_(f"{obj.block.name}.{obj.port} is not an {kind} port")
            return obj
        ports = obj.out_ports if output else obj.in_ports
        if port is not None:
            return obj.port(port, output=output)
        if len(ports) != 1:
            kind = "output" if output else "input"
            raise ConnectionError_(
                f"{obj.name} has {len(ports)} {kind} ports; specify one of "
                f"{[p.name for p in ports]}")
        return PortRef(obj, ports[0].name, output)

    def _check_ports(self, sref: PortRef, dref: PortRef) -> None:
        sp = _port_decl(sref.block.out_ports, sref.port, sref.block, "output")
        dp = _port_decl(dref.block.in_ports, dref.port, dref.block, "input")
        if sp.dtype is not None and dp.dtype is not None and sp.dtype != dp.dtype:
            raise ConnectionError_(
                f"dtype mismatch {sref.block.name}.{sref.port}:{sp.dtype} → "
                f"{dref.block.name}.{dref.port}:{dp.dtype}")

    # -- subgraph port export (≈ kSubgraphExportPort, Graph.hpp:178-225) -------
    def export_in(self, public_name: str, block: Block, port: str) -> None:
        block.port(port, output=False)
        self._exports_in[public_name] = (block, port)
        self.in_ports = tuple(list(self.in_ports) + [Port(public_name)])

    def export_out(self, public_name: str, block: Block, port: str) -> None:
        block.port(port, output=True)
        self._exports_out[public_name] = (block, port)
        self.out_ports = tuple(list(self.out_ports) + [Port(public_name)])

    # -- analysis --------------------------------------------------------------
    def flatten(self) -> "Graph":
        """Inline nested Graph blocks (≈ graph::flatten, Graph.hpp:916)."""
        if not any(isinstance(b, Graph) for b in self.blocks):
            return self
        flat = Graph(name=self.name, registry=self.registry)
        remap: dict[tuple[str, str, bool], tuple[Block, str]] = {}
        for b in self.blocks:
            if isinstance(b, Graph):
                inner = b.flatten()
                for ib in inner.blocks:
                    flat.add(ib)
                flat.edges.extend(inner.edges)
                flat.message_edges.extend(inner.message_edges)
                for pub, (blk, prt) in inner._exports_in.items():
                    remap[(b.unique_name, pub, False)] = (blk, prt)
                for pub, (blk, prt) in inner._exports_out.items():
                    remap[(b.unique_name, pub, True)] = (blk, prt)
            else:
                flat.add(b)
        for e in self.edges:
            s = remap.get((e.src.unique_name, e.src_port, True), (e.src, e.src_port))
            d = remap.get((e.dst.unique_name, e.dst_port, False), (e.dst, e.dst_port))
            flat.edges.append(dataclasses.replace(e, src=s[0], src_port=s[1],
                                                  dst=d[0], dst_port=d[1]))
        flat.message_edges.extend(self.message_edges)
        return flat

    def adjacency(self) -> dict[Block, list[Edge]]:
        """src block → outgoing edges (≈ computeAdjacencyList, Graph.hpp:932)."""
        adj: dict[Block, list[Edge]] = {b: [] for b in self.blocks}
        for e in self.edges:
            adj[e.src].append(e)
        return adj

    def source_blocks(self) -> list[Block]:
        has_in = {e.dst for e in self.edges}
        return [b for b in self.blocks if b not in has_in]

    def sink_blocks(self) -> list[Block]:
        has_out = {e.src for e in self.edges}
        return [b for b in self.blocks if b not in has_out]

    def topological_order(self) -> list[Block]:
        # feedback edges are excluded: they close cycles by construction and
        # carry their value one delay behind (compiler lowers them as scan
        # carries), so the forward dataflow stays a DAG
        fwd = [e for e in self.edges if not e.feedback]
        indeg = {b: 0 for b in self.blocks}
        for e in fwd:
            indeg[e.dst] += 1
        ready = [b for b in self.blocks if indeg[b] == 0]
        # stable order: keep insertion order among ready blocks (≈ Simple scheduler)
        order: list[Block] = []
        adj: dict[Block, list[Edge]] = {b: [] for b in self.blocks}
        for e in fwd:
            adj[e.src].append(e)
        while ready:
            b = ready.pop(0)
            order.append(b)
            for e in adj[b]:
                indeg[e.dst] -= 1
                if indeg[e.dst] == 0:
                    ready.append(e.dst)
        if len(order) != len(self.blocks):
            cyc = [b.name for b in self.blocks if b not in order]
            raise GrError(f"graph has a cycle involving {cyc}; close loops with "
                          f"connect(..., feedback=True, delay=N) so the "
                          f"back-edge becomes a delayed scan carry")
        return order

    def validate(self) -> None:
        for b in self.blocks:
            connected_in = {e.dst_port for e in self.edges if e.dst is b}
            for p in b.in_ports:
                if not p.optional and p.name not in connected_in:
                    raise ConnectionError_(f"{b.name}.{p.name} (input) not connected")

    # -- rate algebra ----------------------------------------------------------
    def resolve_rates(self, block_len: int, sample_rate: float = 1.0,
                      shard: int = 1) -> tuple[dict[str, int], dict[str, int]]:
        """Solve per-block input/output samples-per-step (static shapes for XLA).

        Every block's input length is ``k * f_b`` for a per-component base ``k`` and a
        propagated Fraction ``f_b`` (product of upstream ratios). We pick the smallest
        ``k`` making every length an integer multiple of its block's ``alignment``,
        then scale to ≈ ``block_len`` at the sources. Returns
        ``(in_len, out_len)`` keyed by block unique_name. Also stamps each edge's
        ``samples_per_step``/``sample_rate``.

        ``shard`` > 1 (time-axis sp sharding): every per-step length must
        additionally divide into ``shard`` equal time shards that each still
        satisfy the block's alignment — i.e. divisible by ``alignment·shard``.
        """
        order = self.topological_order()
        f: dict[Block, Fraction] = {}
        rate: dict[Block, Fraction] = {}
        anc: dict[Block, set[Block]] = {}
        in_edges: dict[Block, list[Edge]] = {b: [] for b in self.blocks}
        for e in self.edges:
            if not e.feedback:   # back-edges don't constrain rates (ratio-1 loop)
                in_edges[e.dst].append(e)
        for b in order:
            ins = in_edges[b]
            if not ins:
                f[b] = Fraction(1)
                rate[b] = Fraction(sample_rate)
                anc[b] = set()
                continue
            cands = [(e, f[e.src] * e.src.ratio) for e in ins]
            target = cands[0][1]
            for e, v in cands[1:]:
                if v == target:
                    continue
                # source sample rates are free variables: a join mismatch can be
                # fixed by rescaling the offending input's entire upstream
                # closure — legal only if that closure is disjoint from the
                # other inputs' closures (a shared source ⇒ true inconsistency)
                closure = anc[e.src] | {e.src}
                others: set[Block] = set()
                for e2, _ in cands:
                    if e2 is not e:
                        others |= anc[e2.src] | {e2.src}
                if closure & others:
                    detail = {f"{ee.src.name}→{b.name}": str(vv)
                              for ee, vv in cands}
                    raise RateError(f"inconsistent rates at {b.name}: {detail}")
                scale = target / v
                for blk in closure:
                    f[blk] *= scale
                    rate[blk] *= scale
            f[b] = target
            rates = {Fraction(rate[e.src]) * e.src.ratio for e in ins}
            rate[b] = max(rates)
            anc[b] = set().union(*(anc[e.src] | {e.src} for e in ins))
        # minimal base k: for each block need k*f integer and divisible by alignment
        k0 = 1
        for b in order:
            a = max(1, int(b.alignment)) * max(1, int(shard))
            frac = f[b]
            need = (frac.denominator * a) // math.gcd(frac.numerator, frac.denominator * a)
            k0 = k0 * need // math.gcd(k0, need)
        k = k0 * max(1, round(block_len / k0))
        in_len: dict[str, int] = {}
        out_len: dict[str, int] = {}
        for b in order:
            n_in = int(k * f[b])
            in_len[b.unique_name] = n_in
            out_len[b.unique_name] = int(n_in * b.ratio)
        for e in self.edges:
            e.samples_per_step = out_len[e.src.unique_name]
            e.sample_rate = float(rate[e.src] * e.src.ratio)
        return in_len, out_len

    def __repr__(self):
        return f"<Graph {self.name!r}: {len(self.blocks)} blocks, {len(self.edges)} edges>"


def _port_decl(ports: Iterable[Port], name: str, block: Block, kind: str) -> Port:
    for p in ports:
        if p.name == name:
            return p
    raise ConnectionError_(f"{block.name}: no {kind} port {name!r}")
