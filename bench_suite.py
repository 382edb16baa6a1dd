"""Extended benchmark suite over the BASELINE configs (one JSON line each),
all in one process on one GPU.

``bench.py`` remains the single-metric benchmark; this suite measures the
other BASELINE.md configs:

  1. mono chain: tone → FIR127 → FFT4096 → magnitude
  2. rational polyphase resampler (L/M = 3/2)
  3. wideband FM receiver (freq-xlating FIR → quad demod → audio decim → deemph)
  4. 64-channel PFB channelizer + per-channel power
  5. 256-channel channelizer + demod + tags through the Scheduler loop
  6. 40-block cascade (scheduler overhead)
  7. LDPC min-sum decode through the Scheduler loop; 7k: decoder alone

Usage: python bench_suite.py [--block-len N] [--steps N] [--configs 1,2,...]
Needs a GPU: exits nonzero when JAX finds none.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _run(compiled, steps: int, block_len: int) -> float:
    """Msps of ``steps`` compiled steps after a warm-up, timed to
    ``block_until_ready``."""
    import jax
    states = compiled.init_states()
    params = compiled.gather_params()
    for _ in range(3):
        states, sink_ins = compiled.step(states, params, {})
    jax.block_until_ready((states, sink_ins))
    t0 = time.perf_counter()
    for _ in range(steps):
        states, sink_ins = compiled.step(states, params, {})
    jax.block_until_ready((states, sink_ins))
    return steps * block_len / (time.perf_counter() - t0) / 1e6


def config1(block_len, batch=1):
    import gnuradio4_tpu as gr
    from gnuradio4_tpu.blocks.basic import ComplexToneSource
    from gnuradio4_tpu.blocks.filter import FirFilter
    from gnuradio4_tpu.blocks.fourier import FFT
    from gnuradio4_tpu.blocks.testing import NullSink
    from gnuradio4_tpu.ops import filter_design as fd
    fs = 20e6
    g = gr.Graph()
    src = ComplexToneSource(frequency=1e6)
    fir = FirFilter(taps=fd.design_fir("lowpass", 127, sample_rate=fs,
                                       f_low=2e6).astype(np.float32))
    fft = FFT(fft_size=4096, window="Hann", output="magnitude", calibrate=False)
    g.connect_chain(src, fir, fft, NullSink())
    return gr.compile_graph(g, block_len=block_len, sample_rate=fs,
                            batch_steps=batch)


def config2(block_len, batch=1):
    import gnuradio4_tpu as gr
    from gnuradio4_tpu.blocks.basic import NoiseSource
    from gnuradio4_tpu.blocks.filter import RationalResampler
    from gnuradio4_tpu.blocks.testing import NullSink
    g = gr.Graph()
    g.connect_chain(g.add(NoiseSource()),
                    g.add(RationalResampler(interp=3, decim=2)),
                    g.add(NullSink()))
    return gr.compile_graph(g, block_len=block_len, sample_rate=1e6,
                            batch_steps=batch)


def config3(block_len, batch=1):
    import gnuradio4_tpu as gr
    from gnuradio4_tpu.blocks.basic import ComplexToneSource
    from gnuradio4_tpu.blocks.sdr import make_wbfm_receiver
    from gnuradio4_tpu.blocks.testing import NullSink
    quad_rate = 250e3
    g = gr.Graph()
    src = ComplexToneSource(frequency=10e3)
    rx = make_wbfm_receiver(quad_rate=quad_rate, audio_decim=5)
    snk = NullSink()
    g.add(rx)
    g.connect(src, rx["in"])
    g.connect(rx["out"], snk)
    return gr.compile_graph(g, block_len=block_len, sample_rate=quad_rate,
                            batch_steps=batch)


def config4(block_len, batch=1):
    import gnuradio4_tpu as gr
    from gnuradio4_tpu.blocks.basic import NoiseSource
    from gnuradio4_tpu.blocks.channelizer import PFBChannelizer
    from gnuradio4_tpu.blocks.math import Abs
    from gnuradio4_tpu.blocks.testing import NullSink
    g = gr.Graph()
    src = NoiseSource(noise="complex_gaussian")
    chan = PFBChannelizer(n_channels=64, taps_per_phase=8)
    g.connect_chain(g.add(src), g.add(chan), g.add(Abs()), g.add(NullSink()))
    return gr.compile_graph(g, block_len=block_len, sample_rate=1e9,
                            batch_steps=batch)


def _run_sched(build, block_len, steps) -> float:
    """Msps through the REAL scheduler loop (``build(n_steps) ->
    Scheduler``), driven by ``step_once``: the first dispatch carries the
    compile and is left out; the rest is timed to ``block_until_ready``."""
    from gnuradio4_tpu.utils.timing import run_scheduler_timed
    sched = build(steps)
    sched.init()
    return block_len / run_scheduler_timed(sched)["step_s"] / 1e6


def config5_scheduler(block_len, steps, batch=1):
    """Config 5 shape through the REAL scheduler loop (tag plane, message pump,
    pipelined delivery): 256-ch channelizer + per-channel demod + tag source.
    Returns Msps."""
    steps = max(steps, 32 * batch)
    import gnuradio4_tpu as gr
    from gnuradio4_tpu.blocks.basic import NoiseSource
    from gnuradio4_tpu.blocks.channelizer import PFBChannelizer
    from gnuradio4_tpu.blocks.sdr import QuadratureDemod
    from gnuradio4_tpu.blocks.testing import NullSink
    from gnuradio4_tpu.core.tags import Tag

    class TaggedNoise(NoiseSource):
        """BASELINE config 5 requires TAG PROPAGATION at rate: a timing tag
        every 2^20 input samples rides the host sideband through the PFB's
        1/256 rate change and the demod to the sink (same plane the
        reference's trigger_time tags use)."""

        TAG_PERIOD = 1 << 20

        def emit_tags(self, ctx):
            n = next(iter(ctx.out_len.values()), 0)
            lo, hi = ctx.abs_index, ctx.abs_index + n
            p = self.TAG_PERIOD
            first = -(-lo // p) * p
            return [Tag(i - lo, {"trigger_time": float(i / 1e9)})
                    for i in range(first, hi, p)]

    def build(n):
        g = gr.Graph()
        src = TaggedNoise(noise="complex_gaussian", n_samples=n * block_len)
        chan = PFBChannelizer(n_channels=256, taps_per_phase=8)
        dem = QuadratureDemod(gain=1.0)
        snk = NullSink()
        g.connect_chain(g.add(src), g.add(chan), g.add(dem), g.add(snk))
        return gr.Scheduler(g, block_len=block_len, sample_rate=1e9,
                            pipeline_depth=2, async_delivery=True,
                            batch_steps=batch)

    return _run_sched(build, block_len, steps)


def config6_cascade(block_len, steps):
    """The reference's bm_Scheduler shape (core/benchmarks/bm_Scheduler.cpp:
    20-26): a deep linear MultiplyConst/DivideConst cascade (40 blocks) —
    measures per-step scheduler overhead, not FLOPs. Returns Msps through
    the real scheduler loop."""
    import gnuradio4_tpu as gr

    def build(n):
        g = gr.Graph()
        src = g.emplace("CountingSource", n_samples=n * block_len,
                        dtype="float32")
        prev = src
        for _ in range(20):
            m = g.emplace("MultiplyConst", value=2.0)
            d = g.emplace("DivideConst", value=2.0)
            g.connect(prev, m)
            g.connect(m, d)
            prev = d
        snk = g.emplace("CountingSink")
        g.connect(prev, snk)
        return gr.Scheduler(g, block_len=block_len, sample_rate=1e9,
                            pipeline_depth=2, async_delivery=True)

    return _run_sched(build, block_len, steps)


def config7_ldpc(block_len, steps):
    """Device LDPC min-sum decode throughput (n=256, R=1/2, 25 iters):
    coded Mbits/s through the real scheduler loop."""
    import numpy as np
    import gnuradio4_tpu as gr
    from gnuradio4_tpu.ops.ldpc import make_ldpc, encode
    from gnuradio4_tpu.blocks.testing import VectorSink

    H, G = make_ldpc(256, 128, wc=3, seed=0)
    k = G.shape[0]
    bl = (block_len // 256) * 256
    rng = np.random.default_rng(0)
    u = rng.integers(0, 2, (steps * bl // 256) * k).astype(np.uint8)
    c = encode(G, u.reshape(-1, k)).reshape(-1)
    y = 1.0 - 2.0 * c + 0.6 * rng.standard_normal(len(c))
    llr = (2 * y / 0.36).astype(np.float32)

    def build(n):
        g = gr.Graph()
        # device_resident: one upload at init, on-device slice per step —
        # measures the DECODER through the scheduler loop, not a per-step
        # host→device LLR copy (the kernel-only view is config 7k)
        src = g.emplace("VectorSource", device_resident=True)
        src.data = llr[: n * bl]
        dec = g.emplace("LdpcDecoder", n=256, m=128, seed=0)
        snk = g.emplace("NullSink")   # metrics-only egress (decode
        # correctness is pinned by tests/test_ldpc.py and chip_smoke.py)
        g.connect_chain(src, dec, snk)
        return gr.Scheduler(g, block_len=bl, sample_rate=1e9,
                            pipeline_depth=2, async_delivery=True)

    return _run_sched(build, bl, steps)


def config7k(block_len, batch=1):
    """LDPC decode KERNEL rate: device-born random LLRs (decode cost is
    content-independent for fixed iterations) -> min-sum decoder -> sink,
    one compiled graph (config 7 measures the full scheduler loop)."""
    import gnuradio4_tpu as gr
    from gnuradio4_tpu.blocks.basic import NoiseSource
    from gnuradio4_tpu.blocks.testing import NullSink
    g = gr.Graph()
    src = NoiseSource(noise="gaussian")
    dec = g.emplace("LdpcDecoder", n=256, m=128, seed=0)
    g.connect_chain(g.add(src), dec, g.add(NullSink()))
    return gr.compile_graph(g, block_len=(block_len // 256) * 256,
                            sample_rate=1e9, batch_steps=batch)


def _run_one(key: str, block_len: int, steps: int) -> dict:
    """Run one config in THIS process; returns its result record."""
    import jax
    builders = {"1": ("mono FIR127+FFT4096", config1),
                "2": ("polyphase resampler 3/2", config2),
                "3": ("WBFM receiver (latency block)", config3),
                "3t": ("WBFM receiver (throughput block)", config3),
                "4": ("PFB channelizer 64ch", config4),
                "7k": ("LDPC min-sum decode kernel rate (n=256 R=1/2 "
                       "25 iters), coded Mbit/s", config7k)}
    # per-config operating points
    bl = block_len
    if key == "3":
        bl = min(bl, 1 << 18)          # latency-oriented natural block
    elif key == "3t":
        bl = max(bl, 1 << 22)          # throughput point
    elif key == "5":
        bl = max(bl, 1 << 21)
    elif key in ("1", "2", "4"):
        bl = max(bl, 1 << 22)
    elif key == "7k":
        bl = min(bl, 1 << 19)          # decode-bound; keep compile light
    batch = _BATCH_DEFAULTS.get(key, 1)
    rec: dict = {"config": key, "platform": jax.devices()[0].platform,
                 "device_kind": jax.devices()[0].device_kind,
                 "block_len": bl, "batch_steps": batch}
    if key == "5":
        rec["name"] = "scheduler loop: 256ch PFB + demod + tags"
        msps = config5_scheduler(bl, steps, batch)
    elif key == "6":
        bl = min(bl, 1 << 16)          # overhead shows at small blocks
        rec.update(name="scheduler overhead: 40-block cascade "
                        "(bm_Scheduler mirror)", block_len=bl)
        msps = config6_cascade(bl, max(steps, 200))
    elif key == "7":
        bl = min(bl, 1 << 17)
        rec.update(name="LDPC min-sum decode (n=256 R=1/2 25 iters), "
                        "coded Mbit/s", block_len=bl)
        msps = config7_ldpc(bl, max(steps, 40))
    else:
        name, builder = builders[key]
        rec["name"] = name
        if bl * batch <= (1 << 19):    # small blocks: many steps per window
            steps = max(steps, 200)
        msps = _run(builder(bl, batch), steps, bl * batch)
    rec["msps"] = msps
    return rec


# Per-config step-batching defaults: small-block configs amortize the
# per-dispatch host floor over S fused steps.
_BATCH_DEFAULTS: dict[str, int] = {"3": 8, "5": 8}

ALL_CONFIGS = "1,2,3,3t,4,5,6,7,7k"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--block-len", type=int, default=1 << 20)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--configs", default=ALL_CONFIGS)
    ap.add_argument("--out", default=None,
                    help="write all result records to this JSON file")
    args = ap.parse_args()
    from bench import require_gpu
    from gnuradio4_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    require_gpu()
    results = []
    for key in [k.strip() for k in args.configs.split(",") if k.strip()]:
        rec = _run_one(key, args.block_len, args.steps)
        results.append(rec)
        print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"results": results}, f, indent=1)


if __name__ == "__main__":
    sys.exit(main())
