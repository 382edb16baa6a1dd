"""Time each backend-dependent lowering choice on the GPU at its benchmark
config's size, so the ``auto`` selectors can be decided by measurement.

One process, one card. Each candidate is jitted, warmed up, then timed to
``block_until_ready`` (median of 5 windows of 10 calls). Prints one JSON line
per site (``--out FILE`` also writes them all as one JSON list).

  python scripts/select_paths.py            # needs a GPU
  JAX_PLATFORMS=cpu python scripts/select_paths.py --tiny   # rehearsal

Sites: FIR ``auto`` (FIR127 on 8 Mi complex samples; FIR63 decimation 8 on
8 Mi real samples), the rational resampler (config 2, 4 Mi samples, 3/2),
the LDPC decoder layout (config 7k, 512 Ki LLRs), the IFFT engine (n=4096
over 8 Mi samples) and the IIR engines (1 Mi samples, 4 biquad sections).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from gnuradio4_tpu.utils.timing import median_call_s as timed  # noqa: E402


def site_fir(n: int, rng) -> list[dict]:
    import jax
    import jax.numpy as jnp
    from gnuradio4_tpu.ops import filter_design as fd
    from gnuradio4_tpu.ops.fir import fir_apply, fir_init_state
    cases = [
        ("fir127_complex", 127, 1, (rng.standard_normal(n)
                                    + 1j * rng.standard_normal(n)).astype(np.complex64)),
        ("fir63_decim8_real", 63, 8, rng.standard_normal(n).astype(np.float32)),
    ]
    out = []
    for name, ntaps, decim, x in cases:
        taps = fd.design_fir("lowpass", ntaps, sample_rate=1.0,
                             f_low=0.1 / decim).astype(np.float32)
        xd = jnp.asarray(x)
        st = fir_init_state(0, ntaps, xd.dtype)
        ref = np.convolve(x.astype(np.complex128), taps)[: n][::decim]
        row = {"site": "fir_auto", "case": name, "samples": n}
        for method, rung in (("conv", None), ("fft", None),
                             ("matmul", "default"), ("matmul", "high"),
                             ("matmul", "highest"), ("matmul", "bf16")):
            f = jax.jit(lambda v, s, m=method, r=rung: fir_apply(
                v, taps, s, decim=decim, method=m, precision=r)[0])
            key = method if rung is None else f"{method}@{rung}"
            y = np.asarray(f(xd, st))
            err = np.sum(np.abs(y - ref) ** 2)
            row[key + "_ms"] = timed(f, xd, st) * 1e3
            row[key + "_snr_db"] = float(10 * np.log10(
                np.sum(np.abs(ref) ** 2) / max(err, 1e-300)))
        out.append(row)
    return out


def site_resampler(n: int, rng) -> dict:
    import jax
    import jax.numpy as jnp
    from gnuradio4_tpu.ops.resample import RationalResamplerKernel
    k = RationalResamplerKernel(3, 2)
    x = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    st = k.init_state(0, jnp.float32)
    row = {"site": "resample_auto", "samples": n, "ratio": "3/2"}
    ys = {}
    for method in ("interleave", "matmul"):
        f = jax.jit(lambda v, s, m=method: k.apply(v, s, method=m)[0])
        ys[method] = np.asarray(f(x, st))
        row[method + "_ms"] = timed(f, x, st) * 1e3
    row["max_abs_diff"] = float(np.max(np.abs(ys["interleave"] - ys["matmul"])))
    return row


def site_ldpc(n_llr: int, rng) -> dict:
    import jax.numpy as jnp
    from gnuradio4_tpu.ops.ldpc import (LdpcGraph, make_ldpc,
                                        min_sum_decode_dense,
                                        min_sum_decode_segment)
    H, _ = make_ldpc(256, 128, wc=3, seed=0)
    g = LdpcGraph(H)
    llr = jnp.asarray(rng.standard_normal((n_llr // 256, 256)).astype(np.float32) * 4)
    row = {"site": "ldpc_layout", "llrs": n_llr}
    outs = {}
    for name, f in (("dense", min_sum_decode_dense),
                    ("segment", min_sum_decode_segment)):
        fn = lambda v, f=f: f(g, v, 25)
        outs[name] = [np.asarray(a) for a in fn(llr)]
        row[name + "_ms"] = timed(fn, llr) * 1e3
    row["bits_equal"] = bool(np.array_equal(outs["dense"][0], outs["segment"][0]))
    return row


def site_ifft(n: int, rng) -> dict:
    import jax
    import jax.numpy as jnp
    from gnuradio4_tpu.ops.fft import matmul_fft
    size = 4096
    x = jnp.asarray((rng.standard_normal((n // size, size))
                     + 1j * rng.standard_normal((n // size, size))).astype(np.complex64))
    cands = {
        "xla": jax.jit(lambda v: jnp.fft.ifft(v, axis=-1)),
        "matmul_exact": jax.jit(lambda v: jnp.conj(matmul_fft(
            jnp.conj(v), size, mode="highest")) * jnp.float32(1.0 / size)),
    }
    row = {"site": "ifft_auto", "samples": n, "fft_size": size}
    ref = np.fft.ifft(np.asarray(x).astype(np.complex128), axis=-1)
    for name, f in cands.items():
        row[name + "_ms"] = timed(f, x) * 1e3
        row[name + "_max_err"] = float(np.max(np.abs(np.asarray(f(x)) - ref)))
    return row


def site_iir(n: int, rng) -> dict:
    import jax
    import jax.numpy as jnp
    from gnuradio4_tpu.ops import filter_design as fd
    from gnuradio4_tpu.ops.iir import (iir_apply, iir_init_state,
                                       sos_parallel_apply,
                                       sos_parallel_init_state,
                                       sos_supports_parallel)
    res = fd.design_iir("butterworth", "lowpass", 8, sample_rate=1.0, f_low=0.05)
    x = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    row = {"site": "iir_auto", "samples": n, "sections": int(res.sos.shape[0]),
           "parallel_ok": bool(sos_supports_parallel(res.sos))}
    scan = jax.jit(lambda v, s: iir_apply(v, res.b, res.a, s)[0])
    par = jax.jit(lambda v, s: sos_parallel_apply(v, res.sos, s)[0])
    s0 = iir_init_state(0, len(res.b), len(res.a))
    p0 = sos_parallel_init_state(0, res.sos.shape[0])
    row["scan_ms"] = timed(scan, x, s0, reps=3, inner=2) * 1e3
    row["parallel_ms"] = timed(par, x, p0) * 1e3
    row["max_abs_diff"] = float(np.max(np.abs(np.asarray(scan(x, s0))
                                              - np.asarray(par(x, p0)))))
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--sites", default="fir,resample,ldpc,ifft,iir",
                    help="comma-separated subset of the sites")
    ap.add_argument("--out", default=None, help="write all rows to this file")
    args = ap.parse_args()
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.tiny:
        print(f"select_paths: needs a GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 1
    from gnuradio4_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[:1] \
        if dev.platform == "gpu" else ["no GPU (rehearsal)"]
    s = 1024 if args.tiny else 1            # tiny: 1/1024 of each size
    rng = np.random.default_rng(0)
    sites = {"fir": lambda: site_fir((1 << 23) // s, rng),
             "resample": lambda: [site_resampler((1 << 22) // s, rng)],
             "ldpc": lambda: [site_ldpc((1 << 19) // s, rng)],
             "ifft": lambda: [site_ifft((1 << 23) // s, rng)],
             "iir": lambda: [site_iir((1 << 20) // s, rng)]}
    rows = [r for name in args.sites.split(",") for r in sites[name]()]
    for r in rows:
        r["device"] = dev.device_kind
        r["card"] = card[0] if card else "?"
        print(json.dumps(r), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
