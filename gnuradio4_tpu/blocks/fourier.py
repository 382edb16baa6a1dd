"""Fourier blocks (≈ reference blocks/fourier/fft.hpp:33).

The reference FFT block chunks the stream into ``fft_size`` windows (Resampling<N,1>)
and emits a DataSet spectrum per chunk. Here: the FFT block consumes ``k·fft_size``
samples per step and emits the spectra as a ``[n_bins]`` stream (one spectrum per
chunk concatenated — channels axis carries chunk structure for 1-D inputs), all on
device via XLA's FFT HLO.
"""

from __future__ import annotations

from fractions import Fraction

import jax.numpy as jnp
import numpy as np

from ..core.block import Block, Port
from ..core.registry import register_block
from ..core.settings import Setting
from ..ops.fft import fftshift, magnitude, magnitude_db, spectrum_scale
from ..ops.windows import WINDOWS, make_window


@register_block("FFT")
class FFT(Block):
    """Windowed chunked FFT (≈ blocks/fourier FFT).

    outputs per chunk of ``fft_size`` inputs: ``fft_size`` output samples on the
    selected view — complex spectrum, magnitude, dB, or power. ``shift`` centers DC.
    Rate 1:1 so block-size algebra stays simple; alignment pins steps to whole chunks.
    """

    IN = (Port("in"),)
    OUT = (Port("out"),)
    fft_size = Setting(default=1024, kind="static", limits=(2, 1 << 24))
    stride = Setting(default=0, kind="static", limits=(0, 1 << 24),
                     description="hop between windows; 0/fft_size = back-to-back,"
                                 " < fft_size = overlapping (≈ Stride NTTP)")
    window = Setting(default="Hann", kind="static", choices=WINDOWS + ("none",))
    output = Setting(default="magnitude", kind="static",
                     choices=("complex", "magnitude", "magnitude_db", "power"))
    shift = Setting(default=False, kind="static", description="fftshift spectra")
    calibrate = Setting(default=True, kind="static",
                        description="scale by window coherent gain / N")
    engine = Setting(default="auto", kind="static",
                     choices=("auto", "xla", "matmul", "matmul_exact",
                              "matmul_bf16"),
                     description="auto/xla → FFT HLO; matmul → four-step "
                                 "matmul FFT at the 'high' precision rung; "
                                 "matmul_exact → four-step at HIGHEST "
                                 "(f32-exact); matmul_bf16 → bf16-operand "
                                 "four-step (~50 dB, monitoring-grade). "
                                 "'auto' honors GR4_FFT_ENGINE")

    def _engine(self) -> str:
        import os
        eng = str(self.settings.get("engine"))
        if eng == "auto":
            eng = os.environ.get("GR4_FFT_ENGINE", "xla").lower()
        return eng

    def _fft(self, frames: jnp.ndarray, n: int) -> jnp.ndarray:
        eng = self._engine()
        # matmul engine bounds: the four-step factor matrices are dense host
        # complex128 of ~n entries each in an lru_cache — unbounded n would
        # exhaust host memory (n=2²⁴ → ~3×256 MB per entry). Above 65536 the
        # FFT HLO wins anyway; fall back to it (mirrors the n >= 64 guard).
        if eng in ("matmul", "matmul_exact", "matmul_bf16") \
                and 64 <= n <= 65536 and (n & (n - 1)) == 0:
            from ..ops.fft import matmul_fft
            mode = {"matmul": "high", "matmul_exact": "highest",
                    "matmul_bf16": "bf16"}[eng]
            return matmul_fft(frames, n, mode=mode)
        return jnp.fft.fft(frames, axis=-1)

    def absorb_rotation(self, desc, port) -> bool:
        """Rotation-absorption consumer hook: a residual linear phase
        e^{j2π·frac32(m·dphi)/2³²} factors per frame into (unit phasor) ×
        e^{j…·l} — the phasor cancels in magnitude-class views and the ramp
        folds into a COMPLEX window at zero runtime cost. Complex output
        keeps the phase, so it cannot absorb."""
        return str(self.settings.get("output")) in ("magnitude",
                                                    "magnitude_db", "power")

    def _rotation_window(self, win_np, n: int):
        """Fold the absorbed residual rotation into the window (exact uint32
        phase grid; pure host NumPy — the result enters the trace as a jit
        constant). ``win_np``: host real window or None."""
        desc = (getattr(self, "_absorbed_rotation", None) or {}).get("in")
        if desc is None:
            return win_np
        ph = (np.arange(n, dtype=np.uint64) * np.uint64(
            desc["dphi_out"] % 4294967296)) & np.uint64(0xFFFFFFFF)
        ramp = np.exp(2j * np.pi * (ph.astype(np.float64) / 4294967296.0))
        w = ramp if win_np is None else np.asarray(win_np, np.float64) * ramp
        return w.astype(np.complex64)

    def _stride(self) -> int:
        s = int(self.settings.get("stride"))
        return s if s > 0 else int(self.settings.get("fft_size"))

    @property
    def ratio(self):
        n = int(self.settings.get("fft_size"))
        s = self._stride()
        return Fraction(n, s)

    @property
    def alignment(self):
        return self._stride()

    def out_dtype(self, port, in_dtypes):
        return jnp.complex64 if self.settings.get("output") == "complex" else jnp.float32

    def init_state(self, ctx):
        n = int(self.settings.get("fft_size"))
        s = self._stride()
        if s >= n:
            return None
        ch = ctx.channels.get("in", 0)
        shape = (n - s,) if ch == 0 else (ch, n - s)
        return jnp.zeros(shape, ctx.dtype("in", jnp.float32))

    def sp_halo(self, ctx):
        # overlap state is the last fft_size−stride inputs → default halo
        # converters apply (back-to-back windows are stateless/time-local)
        n = int(self.settings.get("fft_size"))
        s = self._stride()
        return 0 if s >= n else n - s

    def apply(self, state, ins, ctx):
        x = ins["in"]
        n = int(self.settings.get("fft_size"))
        s = self._stride()
        wname = str(self.settings.get("window"))
        win_np = None if wname.lower() in ("none", "") else make_window(wname, n)
        win_np = self._rotation_window(win_np, n)  # absorbed → complex window
        win = None if win_np is None else jnp.asarray(win_np)
        def _apply_win(frames):
            if win is None:
                return frames
            if jnp.issubdtype(win.dtype, jnp.complexfloating):
                return frames * win           # complex window (absorbed ramp)
            return frames * win.astype(jnp.real(frames).dtype)
        if s >= n:
            frames = x.reshape(*x.shape[:-1], -1, n)
            frames = _apply_win(frames)
            spec = self._fft(frames, n)
        else:
            # overlapping windows: carried (n−s)-sample history + gather-free
            # framing (the Stride<stride<chunk> overlap semantics)
            from ..ops.fir import _frame_overlapping_general
            squeeze = x.ndim == 1
            x2 = x[None, :] if squeeze else x
            st2 = state[None, :] if state is not None and squeeze else state
            xc = jnp.concatenate([st2.astype(x2.dtype), x2], axis=-1)
            frames = _frame_overlapping_general(xc, s, n)   # [B, k, n]
            frames = _apply_win(frames)
            spec = self._fft(frames, n)
            state = xc[..., -(n - s):]
            if squeeze:
                spec = spec[0]
                state = state[0]
        if self.settings.get("shift"):
            spec = fftshift(spec)
        scale = 1.0
        if self.settings.get("calibrate"):
            # the ORIGINAL real window decides calibration (an absorbed
            # rotation ramp is unit-modulus — it moves the peak, not the gain)
            wnp = None if wname.lower() in ("none", "") \
                else np.asarray(make_window(wname, n))
            scale = spectrum_scale(n, wnp, power=False, density=False,
                                   sample_rate=ctx.sample_rate)
        view = self.settings.get("output")
        if view == "complex":
            out = spec * jnp.complex64(scale)
        elif view == "magnitude":
            out = magnitude(spec) * jnp.float32(scale)
        elif view == "magnitude_db":
            out = magnitude_db(spec * jnp.complex64(scale))
        elif view == "power":
            out = (jnp.real(spec) ** 2 + jnp.imag(spec) ** 2) * jnp.float32(scale * scale)
        else:
            raise ValueError(f"unknown output view {view}")
        # flatten chunk axis back into the stream: [..., n_chunks, n] → [..., T]
        out = out.reshape(*x.shape[:-1], -1)
        return state, {"out": out}


@register_block("IFFT")
class IFFT(Block):
    """Inverse chunked FFT (complex in → complex out). ``engine=matmul*``
    runs the inverse as the conjugate of the four-step matmul transform
    (IFFT(x) = conj(FFT(conj(x)))/N)."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"),)
    fft_size = Setting(default=1024, kind="static", limits=(2, 1 << 24))
    engine = Setting(default="auto", kind="static",
                     choices=("auto", "xla", "matmul", "matmul_exact",
                              "matmul_bf16"))

    @property
    def alignment(self):
        return int(self.settings.get("fft_size"))

    def apply(self, state, ins, ctx):
        import os
        x = ins["in"]
        n = int(self.settings.get("fft_size"))
        xr = x.reshape(*x.shape[:-1], -1, n)
        eng = str(self.settings.get("engine"))
        if eng == "auto":
            eng = os.environ.get("GR4_IFFT_ENGINE", "xla").lower()
        # same 64..65536 bounds as FFT._fft (dense host factor matrices)
        if eng in ("matmul", "matmul_exact", "matmul_bf16") \
                and 64 <= n <= 65536 and (n & (n - 1)) == 0:
            from ..ops.fft import matmul_fft
            mode = {"matmul": "high", "matmul_exact": "highest",
                    "matmul_bf16": "bf16"}[eng]
            y = jnp.conj(matmul_fft(jnp.conj(xr), n, mode=mode)) \
                * jnp.float32(1.0 / n)
            y = y.astype(jnp.complex64)
        else:
            y = jnp.fft.ifft(xr, axis=-1).astype(jnp.complex64)
        return state, {"out": y.reshape(*x.shape[:-1], -1)}
