"""GNSS (GPS L1 C/A) signal processing: Gold codes + FFT acquisition.

Beyond-reference model family — and, unlike the host-side frame decoders,
a DEVICE-side workload: acquisition is a 2-D search over Doppler × code
phase, evaluated as a batch of FFT circular correlations (one [D, N]
element-wise wipe + FFT per coherent block) — exactly the dense batched
compute the accelerator is for. Everything here is jnp and jit-able.

C/A codes are the standard 1023-chip Gold codes (IS-GPS-200: G1 = 1+x³+x¹⁰,
G2 = 1+x²+x³+x⁶+x⁸+x⁹+x¹⁰ with per-PRN G2 phase taps), validated against the
published first-10-chips octal table.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# per-PRN G2 phase-select taps (IS-GPS-200 table 3-I, PRN 1..32)
_G2_TAPS = [(2, 6), (3, 7), (4, 8), (5, 9), (1, 9), (2, 10), (1, 8), (2, 9),
            (3, 10), (2, 3), (3, 4), (5, 6), (6, 7), (7, 8), (8, 9), (9, 10),
            (1, 4), (2, 5), (3, 6), (4, 7), (5, 8), (6, 9), (1, 3), (4, 6),
            (5, 7), (6, 8), (7, 9), (8, 10), (1, 6), (2, 7), (3, 8), (4, 9)]

CHIP_RATE = 1.023e6
CODE_LEN = 1023


@functools.lru_cache(maxsize=None)
def ca_code(prn: int) -> np.ndarray:
    """1023-chip C/A Gold code for PRN 1..32, as ±1 float32."""
    if not 1 <= prn <= 32:
        raise ValueError("PRN must be 1..32")
    t1, t2 = _G2_TAPS[prn - 1]
    g1 = [1] * 10
    g2 = [1] * 10
    chips = np.empty(CODE_LEN, np.float32)
    for i in range(CODE_LEN):
        out = g1[9] ^ (g2[t1 - 1] ^ g2[t2 - 1])
        chips[i] = 1.0 - 2.0 * out          # 0 → +1, 1 → −1
        new1 = g1[2] ^ g1[9]
        new2 = g2[1] ^ g2[2] ^ g2[5] ^ g2[7] ^ g2[8] ^ g2[9]
        g1 = [new1] + g1[:9]
        g2 = [new2] + g2[:9]
    return chips


def ca_code_first_octal(prn: int) -> int:
    """First 10 chips as the IS-GPS-200 octal check value."""
    chips = ca_code(prn)[:10]
    bits = (chips < 0).astype(int)          # −1 ↔ chip value 1
    return int("".join(map(str, bits)), 2)


def sampled_code(prn: int, fs: float, n: int) -> np.ndarray:
    """C/A code resampled to ``fs`` over ``n`` samples (code repeats each ms)."""
    chips = ca_code(prn)
    idx = (np.arange(n) * (CHIP_RATE / fs)).astype(np.int64) % CODE_LEN
    return chips[idx]


@functools.partial(jax.jit, static_argnames=("fs", "n_coherent"))
def acquire_metric(iq: jnp.ndarray, code: jnp.ndarray,
                   dopplers: jnp.ndarray, *, fs: float,
                   n_coherent: int = 1) -> jnp.ndarray:
    """Doppler × code-phase search surface [D, N].

    For each Doppler bin: wipe the carrier, circularly correlate with the
    local code via FFT, magnitude-square; non-coherently sum ``n_coherent``
    consecutive 1-code blocks (robust to data-bit flips). One batched
    [D, n_coherent, N] FFT — the whole search is a single fused program.
    """
    n = code.shape[0]
    x = iq[:n * n_coherent].reshape(n_coherent, n)
    t = (jnp.arange(n * n_coherent, dtype=jnp.float32) / fs).reshape(
        n_coherent, n)
    carriers = jnp.exp(-2j * jnp.pi * dopplers[:, None, None] * t[None])
    xw = x[None] * carriers.astype(jnp.complex64)          # [D, K, N]
    cf = jnp.conj(jnp.fft.fft(code.astype(jnp.complex64)))
    corr = jnp.fft.ifft(jnp.fft.fft(xw, axis=-1) * cf[None, None], axis=-1)
    return jnp.sum(jnp.abs(corr) ** 2, axis=1)             # [D, N]


def acquire(iq: np.ndarray, prn: int, *, fs: float,
            doppler_max: float = 5000.0, doppler_step: float = 250.0,
            n_coherent: int = 2, threshold: float = 2.5) -> dict | None:
    """Acquire one PRN → {prn, doppler, code_phase, metric} or None.

    ``metric`` is peak / (second peak outside ±1 chip) — the standard
    acquisition quality ratio; ``threshold`` gates detection.
    """
    code = jnp.asarray(sampled_code(prn, fs, int(round(fs * 1e-3))))
    n = code.shape[0]
    dopplers = jnp.arange(-doppler_max, doppler_max + doppler_step / 2,
                          doppler_step, dtype=jnp.float32)
    surf = np.asarray(acquire_metric(jnp.asarray(iq, jnp.complex64), code,
                                     dopplers, fs=fs, n_coherent=n_coherent))
    d_idx, c_idx = np.unravel_index(np.argmax(surf), surf.shape)
    peak = surf[d_idx, c_idx]
    # second peak on the same Doppler row, outside one chip of the first
    spc = int(round(fs / CHIP_RATE))
    row = surf[d_idx].copy()
    lo, hi = c_idx - spc, c_idx + spc + 1
    row[max(lo, 0):hi] = 0.0
    if lo < 0:
        row[lo:] = 0.0
    if hi > n:
        row[:hi - n] = 0.0
    second = row.max()
    metric = float(peak / max(second, 1e-30))
    if metric < threshold:
        return None
    return {"prn": prn, "doppler": float(dopplers[d_idx]),
            "code_phase": int(c_idx), "metric": metric}


def synthesize(prns_dopplers_phases: list[tuple], *,
               fs: float, n_ms: int = 4, amplitude: float = 1.0,
               rng: np.random.Generator | None = None,
               noise_std: float = 0.0) -> np.ndarray:
    """Composite baseband: Σ satellites (PRN, Doppler Hz, code-phase samples
    [, 50 bps nav bits]) + complex AWGN. Test/simulation stimulus. Nav bits
    BPSK-modulate the code at the 20 ms cadence."""
    n = int(round(fs * 1e-3)) * n_ms
    spms = int(round(fs * 1e-3))
    t = np.arange(n) / fs
    out = np.zeros(n, np.complex128)
    for sat in prns_dopplers_phases:
        prn, dopp, phase = sat[:3]
        nav = np.asarray(sat[3], np.int8) if len(sat) > 3 else None
        rolled = np.roll(np.tile(sampled_code(prn, fs, spms), n_ms),
                         phase)[:n]
        if nav is not None:
            ms_bit = (np.arange(n) // (20 * spms)) % len(nav)
            rolled = rolled * (1.0 - 2.0 * nav[ms_bit])
        out += amplitude * rolled * np.exp(2j * np.pi * dopp * t)
    if noise_std > 0.0:
        rng = rng or np.random.default_rng(0)
        out += noise_std * (rng.standard_normal(n)
                            + 1j * rng.standard_normal(n))
    return out.astype(np.complex64)


@functools.partial(jax.jit, static_argnames=("fs",))
def _track_scan(iq_blocks: jnp.ndarray, code: jnp.ndarray, init_code_phase,
                init_freq, *, fs: float, dll_gain: float = 0.05,
                pll_alpha: float = 0.6, pll_beta: float = 30.0):
    """Closed-loop C/A tracking over [n_ms, N] 1 ms blocks (lax.scan).

    Per block: early/prompt/late code correlators (±0.5 chip) after carrier
    wipe; a normalized early-late envelope DLL steers the code phase, a
    Costas atan PLL steers carrier phase/frequency. Everything stays on
    device; vmap over satellites gives parallel tracking channels.

    Returns (prompt I+jQ per ms [n_ms], code phases [n_ms], freqs [n_ms]).
    """
    n = iq_blocks.shape[-1]
    spc = fs / CHIP_RATE                        # samples per chip
    t = jnp.arange(n, dtype=jnp.float32) / fs
    base_idx = jnp.arange(n, dtype=jnp.float32) * (CHIP_RATE / fs)

    def replica(chip_offset):
        idx = jnp.floor(base_idx + chip_offset) % CODE_LEN
        return code[idx.astype(jnp.int32)]

    def step(carry, x):
        code_chips, phase, freq = carry
        carrier = jnp.exp(-1j * (2.0 * jnp.pi * freq * t + phase))
        wiped = x * carrier.astype(jnp.complex64)
        e = jnp.sum(wiped * replica(code_chips - 0.5))
        p = jnp.sum(wiped * replica(code_chips))
        l = jnp.sum(wiped * replica(code_chips + 0.5))
        # DLL: normalized early-late envelope
        ae, al = jnp.abs(e), jnp.abs(l)
        dll = (ae - al) / jnp.maximum(ae + al, 1e-12)
        code_chips = (code_chips - dll_gain * dll) % CODE_LEN
        # Costas PLL (data-bit insensitive); phase advances with the
        # frequency that was actually applied during the block — advancing
        # with the freshly-updated one injects a bias proportional to the
        # error and the loop settles tens of Hz off
        # atan(Q/I), NOT atan2: the half-plane discriminator is what makes
        # Costas insensitive to the 180-degree data-bit flips
        err = jnp.arctan(jnp.imag(p) / jnp.where(
            jnp.abs(jnp.real(p)) < 1e-20, 1e-20, jnp.real(p)))
        phase = (phase + 2.0 * jnp.pi * freq * n / fs
                 + pll_alpha * err) % (2.0 * jnp.pi)
        freq = freq + pll_beta * err
        return (code_chips, phase, freq), (p, code_chips, freq)

    init = (init_code_phase * (CHIP_RATE / fs) % CODE_LEN,
            jnp.float32(0.0), jnp.float32(init_freq))
    _, (prompts, code_chips, freqs) = jax.lax.scan(step, init, iq_blocks)
    return prompts, code_chips, freqs


def track(iq: np.ndarray, prn: int, *, fs: float, code_phase: int,
          doppler: float, n_ms: int | None = None) -> dict:
    """Track one acquired satellite → prompt correlator series + nav bits.

    ``code_phase``/``doppler`` come from :func:`acquire`. Nav bits are the
    sign of the prompt I arm after settling, grouped at the 50 bps (20 ms)
    cadence with the bit boundary found from sign transitions.
    """
    spms = int(round(fs * 1e-3))
    total = len(iq) // spms if n_ms is None else n_ms
    blocks = jnp.asarray(iq[:total * spms], jnp.complex64).reshape(total, spms)
    code = jnp.asarray(ca_code(prn))
    prompts, code_chips, freqs = _track_scan(
        blocks, code, jnp.float32(-code_phase), jnp.float32(doppler), fs=fs)
    return _finish_track(np.asarray(prompts), np.asarray(code_chips),
                         np.asarray(freqs), total)


def track_channels(iq: np.ndarray, acquisitions: list[dict], *, fs: float
                   ) -> list[dict]:
    """Parallel tracking channels: one vmapped scan tracks every acquired
    satellite simultaneously (the device-native form of a receiver's channel
    bank — channels are a batch axis, not threads)."""
    if not acquisitions:
        return []
    spms = int(round(fs * 1e-3))
    total = len(iq) // spms
    blocks = jnp.asarray(iq[:total * spms], jnp.complex64).reshape(total, spms)
    codes = jnp.stack([jnp.asarray(ca_code(a["prn"])) for a in acquisitions])
    phases = jnp.asarray([-a["code_phase"] for a in acquisitions], jnp.float32)
    freqs = jnp.asarray([a["doppler"] for a in acquisitions], jnp.float32)
    prompts, chips, f = jax.vmap(
        lambda c, p0, f0: _track_scan(blocks, c, p0, f0, fs=fs))(
            codes, phases, freqs)
    out = []
    for k, a in enumerate(acquisitions):
        r = _finish_track(np.asarray(prompts[k]), np.asarray(chips[k]),
                          np.asarray(f[k]), total)
        r["prn"] = a["prn"]
        out.append(r)
    return out


def _finish_track(prompts: np.ndarray, code_chips: np.ndarray,
                  freqs: np.ndarray, total: int) -> dict:
    settle = min(30, total // 4)
    sgn = np.sign(np.real(prompts))
    trans = np.nonzero(sgn[settle + 1:] != sgn[settle:-1])[0] + settle + 1
    boundary = int(np.argmax(np.bincount(trans % 20, minlength=20))) \
        if len(trans) else 0
    bits = []
    k = boundary if boundary > settle else boundary + 20 * (
        (settle - boundary + 19) // 20)
    while k + 20 <= total:
        bits.append(1 if np.sum(np.real(prompts[k:k + 20])) >= 0 else 0)
        k += 20
    return {"prompts": prompts, "doppler": freqs, "code_chips": code_chips,
            "bits": np.asarray(bits, np.uint8), "bit_boundary": boundary}


def acquire_all(iq: np.ndarray, *, fs: float, prns=range(1, 33),
                doppler_max: float = 5000.0, doppler_step: float = 250.0,
                n_coherent: int = 2, threshold: float = 2.5,
                mesh=None) -> list[dict]:
    """Sky search: acquire every PRN in one batched program.

    The PRN axis is a pure batch (vmap) — under a ``mesh`` it is sharded
    across devices (expert-parallel style: each chip searches its slice of
    the constellation; the Doppler×code FFTs stay chip-local, no collectives
    in the hot loop)."""
    prns = list(prns)
    n = int(round(fs * 1e-3))
    codes = jnp.stack([jnp.asarray(sampled_code(p, fs, n)) for p in prns])
    dopplers = jnp.arange(-doppler_max, doppler_max + doppler_step / 2,
                          doppler_step, dtype=jnp.float32)
    x = jnp.asarray(iq, jnp.complex64)

    fn = jax.vmap(lambda c: acquire_metric(x, c, dopplers, fs=fs,
                                           n_coherent=n_coherent))
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        axis = mesh.axis_names[-1]
        codes = jax.device_put(codes, NamedSharding(mesh, P(axis, None)))
        fn = jax.jit(fn, in_shardings=NamedSharding(mesh, P(axis, None)),
                     out_shardings=NamedSharding(mesh, P(axis, None, None)))
    surfs = np.asarray(fn(codes))                       # [P, D, N]

    spchip = int(round(fs / CHIP_RATE))
    out = []
    for k, prn in enumerate(prns):
        surf = surfs[k]
        d_idx, c_idx = np.unravel_index(np.argmax(surf), surf.shape)
        peak = surf[d_idx, c_idx]
        row = surf[d_idx].copy()
        lo, hi = c_idx - spchip, c_idx + spchip + 1
        row[max(lo, 0):hi] = 0.0
        if lo < 0:
            row[lo:] = 0.0
        if hi > n:
            row[:hi - n] = 0.0
        metric = float(peak / max(row.max(), 1e-30))
        if metric >= threshold:
            out.append({"prn": prn, "doppler": float(dopplers[d_idx]),
                        "code_phase": int(c_idx), "metric": metric})
    return out
