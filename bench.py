"""Headline benchmark: complex Msamples/s on one GPU for the FIR+FFT+demod
chain. Prints ONE JSON line.

Chain (all on device, no host transfer in the hot loop):
  complex tone → 127-tap freq-xlating FIR → {4096-pt FFT magnitude, quadrature
  demod → 63-tap audio FIR, decimation 8}, at 8 Mi samples per step.

Needs a GPU: it exits nonzero when JAX finds none (a CPU rate is not this
metric). Usage: ``python bench.py`` (``GR4_BENCH_BATCH=S`` fuses S steps
per dispatch; the timed window is 64 steps).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def require_gpu():
    """The first JAX device, which must be a GPU — never a CPU fallback."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"{os.path.basename(sys.argv[0])}: needs a GPU; "
                         f"JAX found {dev.platform!r}")
    return dev


def build_step(block_len: int, batch_steps: int = 1):
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
    fft = FFT(fft_size=4096, window="Hann", output="magnitude", calibrate=False)
    dem = QuadratureDemod(gain=1.0)
    audio = FirFilter(taps=fd.design_fir("lowpass", 63, sample_rate=fs,
                                         f_low=1e6).astype(np.float32), decim=8)
    s1, s2 = NullSink(name="spec"), NullSink(name="audio")
    g.connect_chain(src, fir, fft, s1)
    g.connect(fir, dem)
    g.connect_chain(dem, audio, s2)
    compiled = gr.compile_graph(g, block_len=block_len, sample_rate=fs,
                                batch_steps=batch_steps)
    return compiled


def main() -> None:
    import jax
    from gnuradio4_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    dev = require_gpu()
    block_len = 1 << 23
    batch = max(1, int(os.environ.get("GR4_BENCH_BATCH", "1")))
    steps = max(1, 64 // batch)
    compiled = build_step(block_len, batch_steps=batch)
    states = compiled.init_states()
    params = compiled.gather_params()
    t0 = time.perf_counter()
    for _ in range(3):                       # compile + warm-up
        states, sink_ins = compiled.step(states, params, {})
    jax.block_until_ready((states, sink_ins))
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(steps):
        states, sink_ins = compiled.step(states, params, {})
    jax.block_until_ready((states, sink_ins))
    dt = time.perf_counter() - t0
    print(json.dumps({
        "metric": "complex Msamples/s, FIR127+FFT4096+demod chain",
        "value": steps * batch * block_len / dt / 1e6,
        "unit": "Msps",
        "step_ms": dt / steps * 1e3,
        "warmup_s": warm_s,
        "batch_steps": batch,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }), flush=True)


if __name__ == "__main__":
    main()
