"""Tensor math helpers (≈ reference core Tensor.hpp / TensorMath.hpp /
math/gemm_simd.hpp).

The reference built its own N-D tensor + SIMD GEMM because C++ lacks one; here
jax *is* the tensor library — this module provides the named operations the
reference exposes (norms, GEMM/GEMV with accumulation control, outer/kron,
solve) so callers porting from GR4 find the same vocabulary, each lowering to
the matrix units via jnp.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def gemm(a: jnp.ndarray, b: jnp.ndarray, *, alpha=1.0, beta=0.0,
         c: jnp.ndarray | None = None) -> jnp.ndarray:
    """alpha·A@B + beta·C (≈ gemm_simd.hpp:17) on the matrix units, f32 accumulation."""
    out = alpha * jnp.matmul(a, b, preferred_element_type=jnp.float32)
    if c is not None and beta != 0.0:
        out = out + beta * c
    return out


def gemv(a: jnp.ndarray, x: jnp.ndarray, *, alpha=1.0, beta=0.0,
         y: jnp.ndarray | None = None) -> jnp.ndarray:
    out = alpha * jnp.matmul(a, x[..., None],
                             preferred_element_type=jnp.float32)[..., 0]
    if y is not None and beta != 0.0:
        out = out + beta * y
    return out


def norm_l1(x: jnp.ndarray, axis=None) -> jnp.ndarray:
    return jnp.sum(jnp.abs(x), axis=axis)


def norm_l2(x: jnp.ndarray, axis=None) -> jnp.ndarray:
    return jnp.sqrt(jnp.sum(jnp.abs(x) ** 2, axis=axis))


def norm_inf(x: jnp.ndarray, axis=None) -> jnp.ndarray:
    return jnp.max(jnp.abs(x), axis=axis)


def frobenius(a: jnp.ndarray) -> jnp.ndarray:
    return norm_l2(a.reshape(-1))


def outer(x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    return jnp.outer(x, y)


def kron(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.kron(a, b)


def solve(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.linalg.solve(a, b)


def lstsq(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.linalg.lstsq(a, b)[0]


def matrix_power(a: jnp.ndarray, n: int) -> jnp.ndarray:
    return jnp.linalg.matrix_power(a, n)
