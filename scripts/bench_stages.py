"""Per-stage GPU timing of the headline chain (differential: the wall time
of 32 vs 4 calls, each window ended by a readback).

Times each stage of the FIR127+FFT4096+demod chain in isolation over the
same 8 Mi-sample block the headline bench uses, so optimization effort goes
where the milliseconds are. Needs a GPU: ``python scripts/bench_stages.py``.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import jax
    import jax.numpy as jnp
    from gnuradio4_tpu.ops import filter_design as fd
    from gnuradio4_tpu.ops.fir import fir_apply, fir_init_state
    from gnuradio4_tpu.ops.windows import make_window

    from bench import require_gpu
    require_gpu()
    n = 1 << 23
    fs = 20e6
    taps = fd.design_fir("lowpass", 127, sample_rate=fs, f_low=2e6).astype(np.float32)
    audio_taps = fd.design_fir("lowpass", 63, sample_rate=fs, f_low=1e6).astype(np.float32)

    def tone():
        t = jnp.arange(n, dtype=jnp.float32)
        ph = 2 * jnp.pi * (1e6 / fs) * t
        return (jnp.cos(ph) + 1j * jnp.sin(ph)).astype(jnp.complex64)

    x0 = jax.jit(tone)()
    hist = jax.jit(lambda: fir_init_state(0, 127, jnp.complex64))()
    ahist = jax.jit(lambda: fir_init_state(0, 63, jnp.float32))()
    win = make_window("Hann", 4096).astype(np.float32)

    def st_tone():
        return tone()

    # NB: hist/ahist are passed as jit ARGS, never closure-captured — a
    # closure-captured device array would be embedded as a jit constant
    def st_fir(x, h=None):
        y, _ = fir_apply(x, taps, h)
        return y

    def st_xlate(x, h=None):
        t = jnp.arange(n, dtype=jnp.float32)
        ph = 2 * jnp.pi * (3e6 / fs) * t
        rot = (jnp.cos(ph) - 1j * jnp.sin(ph)).astype(jnp.complex64)
        y, _ = fir_apply(x * rot, taps, h)
        return y

    def st_fft(x):
        fr = x[: (n // 4096) * 4096].reshape(-1, 4096) * win
        return jnp.abs(jnp.fft.fft(fr, axis=-1))

    def st_demod(x):
        prev = jnp.concatenate([jnp.ones((1,), jnp.complex64), x[:-1]])
        return jnp.angle(x * jnp.conj(prev))

    def st_audio(x, h=None):
        y, _ = fir_apply(x, audio_taps, h, decim=8)
        return y

    stages = [
        ("tone", st_tone, None, None),
        ("fir127", st_fir, "c", hist),
        ("xlating_fir127", st_xlate, "c", hist),
        ("fft4096_mag", st_fft, "c", None),
        ("quad_demod", st_demod, "c", None),
        ("audio_fir63_d8", st_audio, "r", ahist),
    ]

    xr = jax.jit(lambda x: jnp.abs(x))(x0)  # real input for audio stage

    def checksum(v):
        return jnp.broadcast_to(jnp.sum(jnp.abs(v)).astype(jnp.float32), (8,))

    results = {}
    for name, fn, kind, st in stages:
        if kind is None:
            jf = jax.jit(lambda: checksum(fn()))
            call = lambda: jf()
        elif st is not None:
            jf = jax.jit(lambda x, h, fn=fn: checksum(fn(x, h)))
            xin = x0 if kind == "c" else xr
            call = lambda: jf(xin, st)
        else:
            jf = jax.jit(lambda x, fn=fn: checksum(fn(x)))
            xin = x0 if kind == "c" else xr
            call = lambda: jf(xin)
        # warm
        h = np.asarray(call())
        assert np.isfinite(h[0]) and h[0] > 0, (name, h)
        walls = {}
        for steps in (4, 32):
            t0 = time.perf_counter()
            out = None
            for _ in range(steps):
                out = call()
            np.asarray(out)
            walls[steps] = time.perf_counter() - t0
        dt = (walls[32] - walls[4]) / 28
        results[name] = dt
        print(f"{name:16s} {dt*1e3:8.3f} ms/step  {n/dt/1e6:9.1f} Msps",
              flush=True)

    total = sum(v for k, v in results.items() if k != "fir127")
    print(f"{'sum(chain)':16s} {total*1e3:8.3f} ms/step  {n/total/1e6:9.1f} Msps")


if __name__ == "__main__":
    sys.exit(main())
