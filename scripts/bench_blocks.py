"""Time each REAL block of the headline chain in isolation (its own jit),
using the exact same Block.apply the compiled graph traces (differential
timing, each window ended by a readback). Explains where the fused chain's
milliseconds go. Needs a GPU: ``python scripts/bench_blocks.py``.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import jax
    import jax.numpy as jnp
    from bench import build_step, require_gpu

    require_gpu()
    block_len = 1 << 23
    compiled = build_step(block_len)
    params = compiled.gather_params()
    states = compiled.init_states()
    in_edges = compiled.in_edges_by_dst()

    def checksum(tree):
        leaves = jax.tree_util.tree_leaves(tree)
        s = sum(jnp.sum(jnp.abs(v)) for v in leaves if hasattr(v, "dtype"))
        return jnp.broadcast_to(jnp.asarray(s, jnp.float32), (8,))

    results = {}
    total = 0.0
    for b in compiled.order:
        uname = b.unique_name
        ctx = dataclasses.replace(compiled.block_ctx[uname],
                                  params=params.get(uname, {}))
        # build device inputs of the right shape/dtype (tone-ish content)
        def mk_ins():
            ins = {}
            for e in in_edges[uname]:
                ch = e.channels
                n = compiled.in_len[uname]
                shape = (n,) if ch == 0 else (ch, n)
                t = jnp.arange(n, dtype=jnp.float32) * 1e-3
                v = jnp.cos(t)
                if np.dtype(e.dtype) == np.complex64:
                    v = (jnp.cos(t) + 1j * jnp.sin(t)).astype(jnp.complex64)
                ins[e.dst_port] = jnp.broadcast_to(v, shape)
            return ins

        ins0 = jax.jit(mk_ins)()

        def fn(st, ins, p):
            c = dataclasses.replace(ctx, params=p)
            new_st, outs = b.apply(st, ins, c)
            return checksum((new_st, outs))

        jf = jax.jit(fn)
        st0 = states.get(uname)
        p0 = params.get(uname, {})
        h = np.asarray(jf(st0, ins0, p0))
        assert np.isfinite(h[0]), (uname, h)
        walls = {}
        for steps in (4, 32):
            t0 = time.perf_counter()
            out = None
            for _ in range(steps):
                out = jf(st0, ins0, p0)
            np.asarray(out)
            walls[steps] = time.perf_counter() - t0
        dt = (walls[32] - walls[4]) / 28
        results[uname] = dt
        total += dt
        print(f"{uname:24s} {dt*1e3:8.3f} ms/step  "
              f"{block_len/max(dt,1e-9)/1e6:9.1f} Msps", flush=True)

    print(f"{'sum(blocks)':24s} {total*1e3:8.3f} ms/step  "
          f"{block_len/total/1e6:9.1f} Msps")


if __name__ == "__main__":
    sys.exit(main())
