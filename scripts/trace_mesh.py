#!/usr/bin/env python3
"""Where the time of the time-sharded config-5 graph goes.

Runs the ``chip_smoke.py`` phase-3 graph (PFBChannelizer(256) → QuadratureDemod
→ VectorSink, tags, block 2 Mi, batch_steps=8) in variants that each take one
suspect away, in one process:

  single     one device (no mesh)
  sp4        ("sp",) mesh of 4, as ``chip_smoke.py --multi`` runs it
  sp4_b1     sp4 with batch_steps=1 (no scan around the sharded step)
  sp4_host   sp4 with a host-fed source (feeds sharded, no replicated state)
  sp4_null   sp4 with a NullSink (no device→host delivery)

For each: compile seconds, wall seconds per logical step after
``block_until_ready``, and the scheduler's host spans (``core.profiler``) per
logical step. Then one super-step of ``single`` and of ``sp4`` under
``jax.profiler``: per device, the busy time and the ten longest operations.

  python scripts/trace_mesh.py [--out chiprun_out/trace_mesh] [--tiny]

Needs four devices (``--tiny`` rehearses on four virtual CPU devices).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def device_summary(logdir: Path, top: int = 10,
                   plane_prefix: str = "/device:") -> dict:
    """Per device plane, per line (a GPU stream): the busy time (the union of
    its event intervals), the window from first start to last end, and the
    ``top`` event names by summed duration, all in ms."""
    import jax
    files = sorted(logdir.rglob("*.xplane.pb"))
    if not files:
        return {"error": f"no xplane under {logdir}"}
    prof = jax.profiler.ProfileData.from_file(str(files[-1]))
    out = {}
    for plane in prof.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        lines = {}
        for line in plane.lines:
            evs = [(e.start_ns, e.duration_ns, e.name) for e in line.events]
            if not evs:
                continue
            spans = sorted((s, s + d) for s, d, _ in evs)
            busy, cur_s, cur_e = 0.0, *spans[0]
            for s, e in spans[1:]:
                if s > cur_e:
                    busy += cur_e - cur_s
                    cur_s, cur_e = s, e
                else:
                    cur_e = max(cur_e, e)
            busy += cur_e - cur_s
            by_name: dict[str, float] = {}
            for _, d, n in evs:
                by_name[n] = by_name.get(n, 0.0) + d
            lines[line.name] = {
                "events": len(evs), "busy_ms": busy / 1e6,
                "window_ms": (spans[-1][1] - spans[0][0]) / 1e6,
                "top_ms": {n: d / 1e6 for n, d in sorted(
                    by_name.items(), key=lambda kv: -kv[1])[:top]}}
        out[plane.name] = lines
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "trace_mesh"))
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--supersteps", type=int, default=4)
    ap.add_argument("--variants", default="single,sp4,sp4_b1,sp4_host,sp4_null",
                    help="comma-separated subset of the variants above")
    args = ap.parse_args(argv)
    if args.tiny:
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import numpy as np
    from jax.sharding import Mesh
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import gnuradio4_tpu as gr
    from gnuradio4_tpu.blocks.testing import NullSink, VectorSink, VectorSource
    from gnuradio4_tpu.core.profiler import Profiler
    from gnuradio4_tpu.core.tags import Tag
    from gnuradio4_tpu.utils.compile_cache import enable_compile_cache
    from gnuradio4_tpu.utils.timing import run_scheduler_timed

    devs = jax.devices()
    if len(devs) < 4 or (not args.tiny and devs[0].platform != "gpu"):
        print(f"trace_mesh: needs 4 GPUs, JAX has {len(devs)} "
              f"{devs[0].platform} devices", file=sys.stderr)
        return 1
    enable_compile_cache()
    sizes = cs.TINY if args.tiny else cs.FULL
    x, taps = cs._channelizer_input(sizes, 0, args.supersteps)
    sp4 = Mesh(np.asarray(devs[:4]), ("sp",))
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    def build(mesh, batch, resident=True, null=False):
        g = gr.Graph()
        src = g.add(VectorSource(x, device_resident=resident, tags=[
            Tag(i, {"trigger_time": i / 1e9})
            for i in range(1000, len(x), sizes.tag_period)]))
        chan = g.emplace("PFBChannelizer", n_channels=cs.CHANNELS,
                         taps_per_phase=cs.TAPS_PER_PHASE,
                         taps=tuple(taps.tolist()))
        dem = g.emplace("QuadratureDemod", gain=1.0)
        snk = g.add(NullSink() if null else VectorSink())
        g.connect_chain(src, chan, dem, snk)
        prof = Profiler()
        sched = gr.Scheduler(g, block_len=sizes.sched_block, sample_rate=1e9,
                             pipeline_depth=2, mesh=mesh, batch_steps=batch,
                             profiler=prof)
        sched.init()
        return sched, prof

    variants = {
        "single": dict(mesh=None, batch=sizes.sched_batch),
        "sp4": dict(mesh=sp4, batch=sizes.sched_batch),
        "sp4_b1": dict(mesh=sp4, batch=1),
        "sp4_host": dict(mesh=sp4, batch=sizes.sched_batch, resident=False),
        "sp4_null": dict(mesh=sp4, batch=sizes.sched_batch, null=True),
    }
    report = {"card": cs.card_line(), "device_kind": devs[0].device_kind}
    for name in args.variants.split(","):
        sched, prof = build(**variants[name])
        rec = run_scheduler_timed(sched)
        rec["step_compiles"] = sched.compiled.step_fn._cache_size()
        n = max(rec["timed_steps"], 1)
        # host spans after the first step_once (which carries the compile)
        t_first = min((e["ts"] + e["dur"] for e in prof.events()
                       if e["name"] == "scheduler.step"), default=0.0)
        spans: dict[str, float] = {}
        for e in prof.events():
            if e.get("ph") == "X" and e["ts"] >= t_first:
                spans[e["name"]] = spans.get(e["name"], 0.0) + e["dur"]
        rec["host_ms_per_step"] = {k: v / 1e3 / n for k, v in spans.items()}
        report[name] = rec
        print(name, json.dumps(rec), flush=True)
        del sched

    for name in ("single", "sp4"):
        sched, _ = build(**variants[name])
        more = sched.step_once()             # compile outside the window
        jax.block_until_ready(sched._states)
        logdir = out_dir / name
        with jax.profiler.trace(str(logdir)):
            if more:
                sched.step_once()
            jax.block_until_ready(sched._states)
        report[f"trace_{name}"] = device_summary(logdir)
        del sched
    (out_dir / "summary.json").write_text(json.dumps(report, indent=1))
    for name in ("single", "sp4"):
        for plane, lines in sorted(report[f"trace_{name}"].items()):
            for lname, s in lines.items():
                print(f"trace {name} {plane} [{lname}] events={s['events']} "
                      f"busy={s['busy_ms']:.3f} ms window="
                      f"{s['window_ms']:.3f} ms top=" + json.dumps(
                          {k[:60]: round(v, 3) for k, v in
                           list(s["top_ms"].items())[:6]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
