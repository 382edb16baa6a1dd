"""HLO collective audit of the sharded flowgraph programs.

Compiles the sharded headline chain and the PFB-channelizer program on n
virtual CPU devices, extracts every collective op and its byte volume from
the optimized HLO, and asserts that halo traffic is O(taps·channels) per step
(block-length INVARIANT — the sp analog of ring attention's fixed neighbor
exchange). Times on the cards come from ``chip_smoke.py --multi``.

Usage: python scripts/audit_collectives.py [--devices 8,16,32] [--out FILE]

Runs on the CPU backend with 32 virtual devices (set before jax import).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

os.environ.setdefault("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in os.environ["XLA_FLAGS"]:
    os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=32"
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "c64": 8, "c128": 16,
                "s64": 8, "s32": 4, "s16": 2, "s8": 1, "u64": 8, "u32": 4,
                "u16": 2, "u8": 1, "pred": 1}

_COLLECTIVES = ("all-gather", "all-reduce", "all-to-all", "collective-permute",
                "reduce-scatter", "collective-broadcast")

_SHAPE_RE = re.compile(r"(f64|f32|bf16|f16|c64|c128|s64|s32|s16|s8|u64|u32|"
                       r"u16|u8|pred)\[([\d,]*)\]")


def _shape_bytes(shape_txt: str) -> int:
    """Total bytes of all array shapes in an HLO result-type string."""
    total = 0
    for m in _SHAPE_RE.finditer(shape_txt):
        dt, dims = m.group(1), m.group(2)
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def audit_hlo(hlo_text: str) -> dict:
    """Collective-op census of an optimized HLO module: per-op kind, count,
    and summed result-shape bytes (the data each participating device
    sources per step)."""
    ops: dict[str, dict] = {}
    for line in hlo_text.splitlines():
        s = line.strip()
        m = re.match(r"[%\w.\-]+ = (\([^)]*\)|\S+) ([\w\-]+)\(", s)
        if not m:
            continue
        kind = m.group(2)
        # the -start/-done pairs of async collectives must not double-count
        base = kind.removesuffix("-start").removesuffix("-done")
        if base not in _COLLECTIVES or kind.endswith("-done"):
            continue
        b = _shape_bytes(m.group(1))
        rec = ops.setdefault(base, {"count": 0, "bytes": 0})
        rec["count"] += 1
        rec["bytes"] += b
    return ops


def lower_text(compiled_graph) -> str:
    states = compiled_graph.init_states()
    params = compiled_graph.gather_params()
    lowered = compiled_graph.step_fn.lower(states, params, {})
    return lowered.compile().as_text()


def build_headline(block_len: int, mesh):
    import gnuradio4_tpu as gr
    from gnuradio4_tpu.blocks.basic import ComplexToneSource
    from gnuradio4_tpu.blocks.filter import FirFilter, FreqXlatingFir
    from gnuradio4_tpu.blocks.fourier import FFT
    from gnuradio4_tpu.blocks.sdr import QuadratureDemod
    from gnuradio4_tpu.blocks.testing import NullSink
    from gnuradio4_tpu.ops import filter_design as fd
    fs = 20e6
    g = gr.Graph()
    src = ComplexToneSource(frequency=1e6)
    taps = fd.design_fir("lowpass", 127, sample_rate=fs, f_low=2e6)
    fir = FreqXlatingFir(taps=taps.astype(np.float32), center_freq=3e6,
                         sample_rate_in=fs, decim=1)
    fft = FFT(fft_size=4096, window="Hann", output="magnitude",
              calibrate=False)
    dem = QuadratureDemod(gain=1.0)
    audio = FirFilter(taps=fd.design_fir("lowpass", 63, sample_rate=fs,
                                         f_low=1e6).astype(np.float32),
                      decim=8)
    s1, s2 = NullSink(name="spec"), NullSink(name="audio")
    g.connect_chain(src, fir, fft, s1)
    g.connect(fir, dem)
    g.connect_chain(dem, audio, s2)
    return gr.compile_graph(g, block_len=block_len, sample_rate=fs, mesh=mesh)


def build_channelizer(block_len: int, mesh, n_channels: int = 64):
    import gnuradio4_tpu as gr
    from gnuradio4_tpu.blocks.basic import NoiseSource
    from gnuradio4_tpu.blocks.channelizer import PFBChannelizer
    from gnuradio4_tpu.blocks.sdr import QuadratureDemod
    from gnuradio4_tpu.blocks.testing import NullSink
    g = gr.Graph()
    src = NoiseSource(noise="complex_gaussian")
    chan = PFBChannelizer(n_channels=n_channels, taps_per_phase=8)
    dem = QuadratureDemod(gain=1.0)
    g.connect_chain(g.add(src), g.add(chan), g.add(dem), g.add(NullSink()))
    return gr.compile_graph(g, block_len=block_len, sample_rate=1e9, mesh=mesh)


def make_mesh(n: int, chan: bool):
    import jax
    from jax.sharding import Mesh
    devs = np.asarray(jax.devices("cpu")[:n])
    if chan and n >= 4:
        return Mesh(devs.reshape(n // 2, 2), ("sp", "chan"))
    return Mesh(devs, ("sp",))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--devices", default="8,16,32")
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    assert jax.devices()[0].platform == "cpu"

    result: dict = {"hlo_audit": {}, "halo_invariance": {}}

    # ---- audit the headline chain at n devices ----------------------------
    ns = [int(x) for x in args.devices.split(",")]
    T = 1 << 18
    for n in ns:
        mesh = make_mesh(n, chan=False)
        comp = build_headline(T, mesh)
        ops = audit_hlo(lower_text(comp))
        per_dev = {k: {"count": v["count"], "bytes": v["bytes"]}
                   for k, v in ops.items()}
        result["hlo_audit"][f"headline_sp{n}"] = {
            "block_len": T, "mesh": f"sp={n}", "collectives": per_dev}
        print(f"headline sp={n}: {per_dev}", flush=True)

    # channelizer under the composed sp×chan mesh (corner-turn audit)
    for n in (8,):
        mesh = make_mesh(n, chan=True)
        comp = build_channelizer(T, mesh)
        ops = audit_hlo(lower_text(comp))
        result["hlo_audit"][f"channelizer_sp{n // 2}x_chan2"] = {
            "block_len": T, "mesh": f"sp={n // 2},chan=2",
            "collectives": {k: dict(v) for k, v in ops.items()}}
        print(f"channelizer sp{n // 2}×chan2: {ops}", flush=True)

    # ---- halo invariance: permute bytes must NOT scale with T -------------
    inv = {}
    for T_test in (1 << 18, 1 << 20):
        mesh = make_mesh(8, chan=False)
        comp = build_headline(T_test, mesh)
        ops = audit_hlo(lower_text(comp))
        inv[str(T_test)] = ops.get("collective-permute", {"bytes": 0,
                                                          "count": 0})
    b1, b2 = inv[str(1 << 18)]["bytes"], inv[str(1 << 20)]["bytes"]
    result["halo_invariance"] = {
        "headline_sp8": inv,
        "invariant": b1 == b2,
        "note": "collective-permute (halo) bytes identical at 256Ki and 1Mi "
                "block lengths ⇒ per-step halo traffic is O(taps·"
                "channels), independent of T — the overlap-save boundary "
                "exchange, not a data re-shard",
    }
    print(f"halo invariance: {b1} vs {b2} bytes → "
          f"{'INVARIANT' if b1 == b2 else 'SCALES WITH T!'}", flush=True)
    if b1 != b2:
        raise SystemExit("halo traffic scales with block length — "
                         "sp lowering regression")

    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    else:
        print(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
