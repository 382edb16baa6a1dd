"""Source→sink latency vs block_len through the REAL Scheduler.

The reference's scheduler benchmark reports first/last-sample latency markers
(core/benchmarks/bm_Scheduler.cpp:88-130). This build's analog: the time
from a step's DISPATCH (its samples start existing on device) to its sink
data LANDING on the host (delivery), as a function of block_len and
pipeline_depth — the latency/throughput trade a streaming user actually
tunes.

Per step k: latency_first = t_deliver(k) − t_dispatch(k)   (the step's first
sample waited the whole round trip); the last sample's wait is the same
minus the in-block generation span, which on-device is the step compute
time. We report p50/p95 of the per-step round trip plus the achieved
throughput, one JSON line per configuration.

Usage: python scripts/bench_latency.py [--steps N]   (needs a GPU)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def measure(block_len: int, pipeline_depth: int, steps: int,
            async_delivery: bool = False, batch: int = 1) -> dict:
    import jax
    import gnuradio4_tpu as gr
    from gnuradio4_tpu.core.block import Port, SinkBlock
    from gnuradio4_tpu.ops import filter_design as fd

    arrivals: list[float] = []

    class LatencySink(SinkBlock):
        IN = (Port("in", dtype="float32"),)

        def consume(self, arrays, tags, n_valid, abs_index):
            np.asarray(arrays["in"][..., :1])   # touch host data
            arrivals.append(time.perf_counter())

    g = gr.Graph()
    src = g.emplace("CountingSource", n_samples=steps * block_len,
                    dtype="float32")
    fir = g.emplace("FirFilter",
                    taps=fd.design_fir("lowpass", 63, sample_rate=1e6,
                                       f_low=1e5).astype(np.float32))
    snk = g.add(LatencySink())
    g.connect_chain(src, fir, snk)
    sched = gr.Scheduler(g, block_len=block_len, sample_rate=1e6,
                         pipeline_depth=pipeline_depth,
                         async_delivery=async_delivery, batch_steps=batch)
    sched.init()

    dispatches: list[float] = []
    orig = sched.compiled.step_fn

    def stamped(*a, **kw):
        dispatches.append(time.perf_counter())
        return orig(*a, **kw)

    sched.compiled.step_fn = stamped

    t0 = time.perf_counter()
    while sched._pump_once():
        pass
    sched._drain()
    wall = time.perf_counter() - t0

    # skip the first super-step's deliveries (jit compile rides on them).
    # Under batching, one dispatch covers ``batch`` logical blocks: each
    # arrival maps to its super-step's dispatch stamp, so the per-LOGICAL-
    # block round trip measured here directly shows the S-times-coarser
    # progress granularity batching trades for throughput (sub-blocks of one
    # batch share a dispatch time; the early ones wait out the whole scan).
    lat = [a - dispatches[min(i // batch, len(dispatches) - 1)]
           for i, a in enumerate(arrivals)][batch:]
    if not lat:
        return {"error": "no deliveries"}
    lat = np.asarray(lat)
    return {
        "block_len": block_len,
        "pipeline_depth": pipeline_depth,
        "async_delivery": async_delivery,
        "batch_steps": batch,
        "steps_delivered": int(len(lat)),
        "latency_p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 3),
        "latency_p95_ms": round(float(np.percentile(lat, 95)) * 1e3, 3),
        "latency_max_ms": round(float(np.max(lat)) * 1e3, 3),
        "throughput_msps": round(steps * block_len / wall / 1e6, 1),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--depths", default="1,2,4")
    ap.add_argument("--block-lens", default="1024,16384,262144,2097152,8388608")
    ap.add_argument("--async-modes", default="0,1",
                    help="comma list of 0/1: sync and/or async delivery rows")
    ap.add_argument("--batches", default="1",
                    help="comma list of batch_steps values (latency-under-"
                         "batching rows; one dispatch = S logical blocks)")
    ap.add_argument("--out", default=None,
                    help="also write all rows to this JSON file")
    args = ap.parse_args()
    from bench import require_gpu
    platform = require_gpu().platform
    lens = [int(x) for x in args.block_lens.split(",")]
    rows = []
    for batch in [int(b) for b in args.batches.split(",")]:
        for mode in [int(m) for m in args.async_modes.split(",")]:
            for depth in [int(d) for d in args.depths.split(",")]:
                for bl in lens:
                    try:
                        r = measure(bl, depth, max(args.steps, 2 * batch),
                                    async_delivery=bool(mode), batch=batch)
                    except Exception as e:
                        r = {"block_len": bl, "pipeline_depth": depth,
                             "async_delivery": bool(mode),
                             "batch_steps": batch,
                             "error": f"{type(e).__name__}: {e}"}
                    r["platform"] = platform
                    rows.append(r)
                    print(json.dumps(r), flush=True)
    if args.out:
        import datetime
        with open(args.out, "w") as f:
            json.dump({"date": datetime.datetime.now(datetime.timezone.utc)
                       .strftime("%Y-%m-%dT%H:%M:%SZ"),
                       "protocol": "dispatch->host-delivery round trip per "
                                   "step through the real Scheduler, p50/p95"
                                   " over delivered steps (first skipped: "
                                   "jit compile)",
                       "rows": rows}, f, indent=1)


if __name__ == "__main__":
    sys.exit(main())
