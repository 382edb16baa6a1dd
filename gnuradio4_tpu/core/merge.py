"""Explicit block fusion (≈ reference core BlockMerging.hpp: mergeByIndex
compile-time fusion).

On an accelerator, XLA already fuses chained elementwise blocks inside the single jitted
step — fusion is the *default*, not an optimization the user must opt into. This
module provides the explicit ``merge`` API for parity and for cases where one
wants a single reusable Block object (e.g. to register a fused composite): the
merged block chains the members' apply functions in one trace, with states kept
as a tuple pytree.
"""

from __future__ import annotations

from fractions import Fraction
from functools import reduce
from typing import Sequence

from .block import Block, BlockCtx, Port
from .errors import GrError


class MergedBlock(Block):
    """Chain of single-in/single-out blocks fused into one Block."""

    def __init__(self, members: Sequence[Block], name: str | None = None):
        if not members:
            raise GrError("merge needs at least one block")
        for i, b in enumerate(members):
            if i > 0 and len(b.in_ports) != 1:
                raise GrError(f"merge: {b.name} must have exactly one input")
            if i < len(members) - 1 and len(b.out_ports) != 1:
                raise GrError(f"merge: {b.name} must have exactly one output")
        super().__init__(name=name or "+".join(b.name for b in members))
        self.members = list(members)
        self.in_ports = tuple(members[0].in_ports)
        self.out_ports = tuple(members[-1].out_ports)

    @property
    def ratio(self) -> Fraction:
        return reduce(lambda acc, b: acc * b.ratio, self.members, Fraction(1))

    @property
    def alignment(self) -> int:
        # conservative: lcm of member alignments scaled by upstream ratios
        import math
        align = 1
        scale = Fraction(1)
        for b in self.members:
            need = Fraction(int(b.alignment), 1) / scale
            align = align * need.numerator // math.gcd(align, need.numerator)
            scale = scale * b.ratio
        return align

    def out_channels(self, port, in_channels):
        ch = in_channels
        for b in self.members:
            pname = b.out_ports[0].name if b.out_ports else port
            ch = {p.name: b.out_channels(pname, ch) for p in b.in_ports} or \
                {pname: b.out_channels(pname, ch)}
        return next(iter(ch.values())) if ch else 0

    def out_dtype(self, port, in_dtypes):
        dt = in_dtypes
        for b in self.members:
            pname = b.out_ports[0].name if b.out_ports else port
            dt = {pname: b.out_dtype(pname, dt)}
        return next(iter(dt.values()))

    def _member_ctx(self, ctx: BlockCtx, b: Block, n_in: int) -> BlockCtx:
        import dataclasses
        n_out = int(n_in * b.ratio)
        return dataclasses.replace(
            ctx,
            in_len={p.name: n_in for p in b.in_ports},
            out_len={p.name: n_out for p in b.out_ports},
            params=b.prepare_params(b.settings.dynamic_params()),
        )

    def init_state(self, ctx):
        states = []
        n = next(iter(ctx.in_len.values()), 0)
        for b in self.members:
            states.append(b.init_state(self._member_ctx(ctx, b, n)))
            n = int(n * b.ratio)
        return tuple(states)

    def apply(self, state, ins, ctx):
        n = next(iter(ctx.in_len.values()), 0)
        val = next(iter(ins.values())) if ins else None
        new_states = []
        for i, b in enumerate(self.members):
            mctx = self._member_ctx(ctx, b, n)
            b_ins = {b.in_ports[0].name: val} if b.in_ports else {}
            st, outs = b.apply(state[i], b_ins, mctx)
            new_states.append(st)
            val = next(iter(outs.values())) if outs else None
            n = int(n * b.ratio)
        out_name = self.out_ports[0].name if self.out_ports else "out"
        return tuple(new_states), ({out_name: val} if val is not None else {})


def merge(*blocks: Block, name: str | None = None) -> MergedBlock:
    """Fuse a chain of blocks into one (≈ mergeByIndex<0,0>, BlockMerging.hpp)."""
    return MergedBlock(blocks, name=name)
