"""Noise generation (≈ reference algorithm/rng Xoshiro256pp + GaussianNoise).

Device-native: JAX's counter-based threefry PRNG — splittable, reproducible, and
generated entirely on-device (no host RNG feed). The carried state is the PRNG key,
split once per step; this is the idiomatic replacement for the reference's
sequential xoshiro256++ stream (a sequential generator would serialize the vector units).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def noise_init_state(seed: int) -> jax.Array:
    return jax.random.key(np.uint32(seed))


def gaussian(key: jax.Array, shape: tuple[int, ...], *, std=1.0, mean=0.0
             ) -> tuple[jnp.ndarray, jax.Array]:
    key, sub = jax.random.split(key)
    x = jax.random.normal(sub, shape, dtype=jnp.float32) * std + mean
    return x, key


def uniform(key: jax.Array, shape: tuple[int, ...], *, low=-1.0, high=1.0
            ) -> tuple[jnp.ndarray, jax.Array]:
    key, sub = jax.random.split(key)
    x = jax.random.uniform(sub, shape, dtype=jnp.float32, minval=low, maxval=high)
    return x, key


def complex_gaussian(key: jax.Array, shape: tuple[int, ...], *, std=1.0
                     ) -> tuple[jnp.ndarray, jax.Array]:
    """Circularly-symmetric complex Gaussian with total power std² (std/√2 per rail)."""
    key, sub = jax.random.split(key)
    ri = jax.random.normal(sub, (2, *shape), dtype=jnp.float32) * (std / np.sqrt(2.0))
    return (ri[0] + 1j * ri[1]).astype(jnp.complex64), key


# -- host-side Xoshiro256++ (≈ reference algorithm/rng/Xoshiro256pp.hpp) -------
#
# The device-side noise above is threefry (jax.random) — the device-native
# counterless PRNG. This host engine exists for bit-exact stimulus parity with
# the reference: xoshiro256++ is the public Blackman/Vigna algorithm
# (prng.di.unimi.it), seeded via SplitMix64 exactly like the reference, so a
# test vector generated there reproduces here to the bit.

_U64 = np.uint64


def _splitmix64(state: int) -> tuple[int, int]:
    state = (state + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = state
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return state, z ^ (z >> 31)


def _rotl(x: int, k: int) -> int:
    return ((x << k) | (x >> (64 - k))) & 0xFFFFFFFFFFFFFFFF


class Xoshiro256pp:
    """xoshiro256++ PRNG, SplitMix64-seeded (host-side; bit-compatible with the
    reference's gr::rng::Xoshiro256pp — known-answer vectors pinned in tests).

    Draws are python-int uint64; ``uniform01``/``uniformM11`` follow the
    reference's mantissa-shift conversions (>>11 · 2^-53 for float64,
    >>40 · 2^-24 for float32); ``triangularM11`` is the Irwin-Hall(2)
    semi-Gaussian on [-1, 1).
    """

    def __init__(self, seed: int = 0):
        self.seed(seed)

    def seed(self, seed: int) -> None:
        sm = seed & 0xFFFFFFFFFFFFFFFF
        s = []
        for _ in range(4):
            sm, v = _splitmix64(sm)
            s.append(v)
        self._s = s

    def __call__(self) -> int:
        s0, s1, s2, s3 = self._s
        result = (_rotl((s0 + s3) & 0xFFFFFFFFFFFFFFFF, 23) + s0) \
            & 0xFFFFFFFFFFFFFFFF
        t = (s1 << 17) & 0xFFFFFFFFFFFFFFFF
        s2 ^= s0
        s3 ^= s1
        s1 ^= s2
        s0 ^= s3
        s2 ^= t
        s3 = _rotl(s3, 45)
        self._s = [s0, s1, s2, s3]
        return result

    def uniform01(self, dtype=np.float64) -> float:
        raw = self()
        if np.dtype(dtype) == np.float32:
            return float((raw >> 40) * 2.0 ** -24)
        return float((raw >> 11) * 2.0 ** -53)

    def uniformM11(self, dtype=np.float64) -> float:
        return 2.0 * self.uniform01(dtype) - 1.0

    def triangularM11(self, dtype=np.float64) -> float:
        return self.uniform01(dtype) + self.uniform01(dtype) - 1.0

    def array(self, n: int, *, kind: str = "uniform01",
              dtype=np.float64) -> np.ndarray:
        fn = {"raw": self.__call__, "uniform01": lambda: self.uniform01(dtype),
              "uniformM11": lambda: self.uniformM11(dtype),
              "triangularM11": lambda: self.triangularM11(dtype)}[kind]
        out = [fn() for _ in range(n)]
        return np.asarray(out, _U64 if kind == "raw" else dtype)


def triangular(key: jax.Array, shape: tuple[int, ...], *, half_range=1.0,
               mean=0.0) -> tuple[jnp.ndarray, jax.Array]:
    """Irwin-Hall(2) triangular noise on [mean−half_range, mean+half_range)
    (device path of the reference's NoiseType::Triangular,
    NoiseGenerator.hpp:95)."""
    key, sub = jax.random.split(key)
    u = jax.random.uniform(sub, (2, *shape), dtype=jnp.float32)
    return (u[0] + u[1] - 1.0) * half_range + mean, key


class GaussianNoise:
    """Marsaglia-polar N(0,1) over :class:`Xoshiro256pp` — bit-compatible with
    the reference's gr::rng::GaussianNoise (algorithm/rng/GaussianNoise.hpp):
    rejection pairs cache the spare variate; ``complex_sample`` uses Option B
    (nI, nQ ~ N(0, 1/2), E[|n|²] = 1); ``fill_complex`` draws a fresh polar
    pair per sample (no spare, offset applied to the real rail only)."""

    def __init__(self, rng: Xoshiro256pp):
        self._rng = rng
        self._spare = 0.0
        self._has_spare = False

    def reset(self) -> None:
        self._has_spare = False

    def __call__(self, dtype=np.float64) -> float:
        if self._has_spare:
            self._has_spare = False
            return self._spare
        u, v = self._polar_pair(dtype)
        self._spare = v
        self._has_spare = True
        return u

    def _polar_pair(self, dtype=np.float64) -> tuple[float, float]:
        while True:
            u = self._rng.uniformM11(dtype)
            v = self._rng.uniformM11(dtype)
            s = u * u + v * v
            if 0.0 < s < 1.0:
                break
        factor = float(np.sqrt(-2.0 * np.log(s) / s))
        return u * factor, v * factor

    def complex_sample(self, dtype=np.float64) -> complex:
        scale = 1.0 / float(np.sqrt(2.0))
        return complex(self(dtype) * scale, self(dtype) * scale)

    def fill(self, n: int, *, amplitude=1.0, offset=0.0,
             dtype=np.float64) -> np.ndarray:
        # the reference's bulk fill starts from a cleared spare (local
        # hasSpare=false, GaussianNoise.hpp:60) and writes the end state back
        self._has_spare = False
        return np.asarray([amplitude * self(dtype) + offset for _ in range(n)],
                          dtype)

    def fill_complex(self, n: int, *, amplitude=1.0, offset=0.0,
                     dtype=np.float64) -> np.ndarray:
        scaled = amplitude / float(np.sqrt(2.0))
        out = np.empty(n, np.complex128 if np.dtype(dtype) == np.float64
                       else np.complex64)
        for i in range(n):
            g1, g2 = self._polar_pair(dtype)
            out[i] = complex(scaled * g1 + offset, scaled * g2)
        self._has_spare = False
        return out


class NoiseGenerator:
    """Uniform/Triangular/Gaussian noise stream, output = A·noise + O —
    host-side mirror of the reference's gr::rng::NoiseGenerator
    (algorithm/rng/NoiseGenerator.hpp): same Xoshiro draws, same complex
    conventions (independent rails for uniform/triangular; Gaussian Option B;
    offset on the real rail only). Device streams use the threefry functions
    above instead — this engine exists for bit-exact stimulus parity."""

    TYPES = ("uniform", "triangular", "gaussian")

    def __init__(self, noise_type: str = "uniform", *, amplitude=1.0,
                 offset=0.0, seed: int = 0):
        self.configure(noise_type, amplitude=amplitude, offset=offset,
                       seed=seed)

    def configure(self, noise_type: str, *, amplitude=1.0, offset=0.0,
                  seed: int = 0) -> None:
        if noise_type not in self.TYPES:
            raise ValueError(f"noise_type {noise_type!r} not in {self.TYPES}")
        self.noise_type = noise_type
        self.amplitude = float(amplitude)
        self.offset = float(offset)
        self._rng = Xoshiro256pp(seed)
        self._gauss = GaussianNoise(self._rng)

    def reset(self, seed: int = 0) -> None:
        self._rng.seed(seed)
        self._gauss.reset()

    def _raw(self, dtype=np.float64) -> float:
        if self.noise_type == "uniform":
            return self._rng.uniformM11(dtype)
        if self.noise_type == "triangular":
            return self._rng.triangularM11(dtype)
        return self._gauss(dtype)

    def sample(self, dtype=np.float64) -> float:
        return self.amplitude * self._raw(dtype) + self.offset

    def complex_sample(self, dtype=np.float64) -> complex:
        if self.noise_type == "gaussian":
            raw = self._gauss.complex_sample(dtype)
            return complex(self.amplitude * raw.real + self.offset,
                           self.amplitude * raw.imag)
        return complex(self.amplitude * self._raw(dtype) + self.offset,
                       self.amplitude * self._raw(dtype))

    def fill(self, n: int, dtype=np.float64) -> np.ndarray:
        if self.noise_type == "gaussian":
            return self._gauss.fill(n, amplitude=self.amplitude,
                                    offset=self.offset, dtype=dtype)
        return np.asarray([self.sample(dtype) for _ in range(n)], dtype)

    def fill_complex(self, n: int, dtype=np.float64) -> np.ndarray:
        if self.noise_type == "gaussian":
            return self._gauss.fill_complex(n, amplitude=self.amplitude,
                                            offset=self.offset, dtype=dtype)
        return np.asarray([self.complex_sample(dtype) for _ in range(n)],
                          np.complex128 if np.dtype(dtype) == np.float64
                          else np.complex64)
