"""LDPC codes: GF(2) construction/encoding (host) + a device-side
normalized min-sum belief-propagation decoder.

The decoder is the device-side piece: messages live on the Tanner-graph
edges as one flat array, check updates are the two-minimum trick over
segment reductions, variable updates are segment sums, and the iteration
loop is a ``lax.scan`` — so a whole batch of codewords decodes as one
fused device program (`vmap` over the batch).

Construction: regular Gallager-style (column weight ``wc``) parity
matrices with a deterministic RNG, then Gaussian elimination over GF(2)
to a systematic generator — encoding is a plain 0/1 matmul.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.errors import GrError


# -- construction (host) -------------------------------------------------------

def make_ldpc(n: int, m: int, *, wc: int = 3, seed: int = 0
              ) -> tuple[np.ndarray, np.ndarray]:
    """Build a regular-ish LDPC code: returns (H [m, n], G [k, n]) with
    G·Hᵀ = 0 and G systematic in the first k columns (k = n − rank(H)).
    Column weight ``wc``; rows balanced."""
    if not (0 < m < n):
        raise GrError(f"ldpc: need 0 < m < n (got m={m}, n={n})")
    rng = np.random.default_rng(seed)
    H = np.zeros((m, n), np.uint8)
    fill = rng.permutation(np.arange(n * wc) % m)
    for j in range(n):
        rows = set()
        for s in fill[j * wc:(j + 1) * wc]:
            r = int(s)
            while r in rows:
                r = int(rng.integers(m))
            rows.add(r)
            H[r, j] = 1
    # systematic form: column-permute + eliminate so the LAST m columns of
    # H are invertible → H = [P | I-ish], G = [I | Pᵀ]
    Hw = H.copy()
    perm = np.arange(n)
    r = 0
    for col in range(n - 1, -1, -1):        # aim pivots at the right side
        if r >= m:
            break
        pivot = None
        for i in range(r, m):
            if Hw[i, col]:
                pivot = i
                break
        if pivot is None:
            continue
        if pivot != r:
            Hw[[r, pivot]] = Hw[[pivot, r]]
        for i in range(m):
            if i != r and Hw[i, col]:
                Hw[i] ^= Hw[r]
        # move this column to position n-1-r
        tgt = n - 1 - r
        if col != tgt:
            Hw[:, [col, tgt]] = Hw[:, [tgt, col]]
            perm[[col, tgt]] = perm[[tgt, col]]
        r += 1
    if r < m:
        # rank-deficient H: drop dependent rows
        Hw = Hw[:r]
        m = r
    k = n - m
    # Hw = [A | B] with B (m x m) = permuted identity from elimination; make
    # it exactly I by row permutation
    B = Hw[:, k:]
    # rows of Hw already reduced: B is a permutation of I — reorder rows
    row_for_col = np.argmax(B, axis=0)
    Hw = Hw[row_for_col]
    A = Hw[:, :k]
    # codeword c = [u | p], p = u·Aᵀ (since A·u + I·p = 0 over GF(2))
    G = np.concatenate([np.eye(k, dtype=np.uint8), A.T], axis=1)
    # CRITICAL: belief propagation needs the SPARSE parity matrix — the
    # row-reduced Hw is dense. The original H with the same column
    # permutation has the same null space (row ops preserve it), so decode
    # with that; redundant (dependent) rows are harmless extra checks.
    H_dec = H[:, perm].astype(np.uint8)
    assert not ((G @ H_dec.T) % 2).any(), "ldpc: G·Hᵀ != 0"
    return H_dec, G


def encode(G: np.ndarray, u: np.ndarray) -> np.ndarray:
    """u [*, k] data bits → c [*, n] codeword bits (systematic)."""
    u = np.asarray(u, np.uint8)
    return (u @ G) % 2


# -- device decoder -------------------------------------------------------------

class LdpcGraph:
    """Static Tanner-graph arrays for the device decoder.

    Two layouts are prepared host-side:
    - flat edge arrays (chk/var) for the segment-op formulation (CPU);
    - a dense check-layout for accelerators: ``V [m, wr_max]`` = variable
      index per check slot (padded), ``mask [m, wr_max]``, and the one-hot
      scatter matrix ``S [m·wr_max, n]`` that turns every segment
      reduction into a matmul. The dense form is pure matmul + per-row
      mins over a tiny wr axis — no scatter or segment reductions.
    """

    def __init__(self, H: np.ndarray):
        H = np.asarray(H, np.uint8)
        self.m, self.n = H.shape
        chk, var = np.nonzero(H)
        self.chk = jnp.asarray(chk, jnp.int32)     # edge → check index
        self.var = jnp.asarray(var, jnp.int32)     # edge → variable index
        self.n_edges = len(chk)
        self.H = H
        # dense check-layout (host constants, embedded at trace time)
        wr = int(np.max(H.sum(axis=1)))
        V = np.zeros((self.m, wr), np.int32)
        mask = np.zeros((self.m, wr), np.float32)
        for i in range(self.m):
            vs = np.nonzero(H[i])[0]
            V[i, : len(vs)] = vs
            mask[i, : len(vs)] = 1.0
        S = np.zeros((self.m * wr, self.n), np.float32)
        rows = np.arange(self.m * wr)
        S[rows, V.reshape(-1)] = mask.reshape(-1)
        self.wr = wr
        self.V_np = V           # [m, wr] variable index per slot
        self.mask_np = mask     # [m, wr] 1.0 on real edges
        self.S_np = S           # [m·wr, n] masked one-hot scatter


@partial(jax.jit, static_argnums=(0, 2))
def min_sum_decode_dense(graph: LdpcGraph, llr: jnp.ndarray,
                         n_iters: int = 25, alpha: float = 0.8125):
    """Normalized min-sum BP in the dense check-layout (accelerator path).

    Messages live as [batch, m, wr]; every segment reduction is either a
    per-row min/sum over the wr axis (wr ≈ 6, elementwise) or a matmul with
    the constant one-hot S at HIGHEST precision (exact for one-hot weights).
    No scatter/segment HLOs anywhere.
    Algebraically identical to :func:`min_sum_decode` (tie-breaking on
    exactly-equal minima may pick a different edge; with continuous LLRs
    that is measure-zero)."""
    m, n, wr = graph.m, graph.n, graph.wr
    V = jnp.asarray(graph.V_np)
    mask = jnp.asarray(graph.mask_np)          # [m, wr]
    S = graph.S_np                              # host constant
    big = jnp.float32(1e30)
    HI = jax.lax.Precision.HIGHEST

    def scatter_sum(x):                         # [b, m, wr] → [b, n]
        return jnp.einsum("be,en->bn", x.reshape(x.shape[0], m * wr), S,
                          precision=HI, preferred_element_type=jnp.float32)

    def gather(y):                              # [b, n] → [b, m, wr]
        out = jnp.einsum("bn,en->be", y, S, precision=HI,
                         preferred_element_type=jnp.float32)
        return out.reshape(y.shape[0], m, wr)

    def decode(l):
        lv = gather(l)                          # l[V[i,s]] per slot
        v2c = lv                                # [b, m, wr]

        def body(v2c, _):
            mag = jnp.where(mask > 0, jnp.abs(v2c), big)
            neg = jnp.where(mask > 0, (v2c < 0).astype(jnp.float32), 0.0)
            tot_neg = jnp.sum(neg, axis=-1, keepdims=True)
            s_ex = 1.0 - 2.0 * ((tot_neg - neg) % 2.0)      # sign excl. self
            min1 = jnp.min(mag, axis=-1, keepdims=True)
            first = jnp.argmin(mag, axis=-1)                 # [b, m]
            is_first = jax.nn.one_hot(first, wr, dtype=jnp.float32)
            masked = jnp.where(is_first > 0, big, mag)
            min2 = jnp.min(masked, axis=-1, keepdims=True)
            c2v = alpha * s_ex * jnp.where(is_first > 0, min2, min1)
            c2v = c2v * mask
            tot = scatter_sum(c2v)                           # [b, n]
            v2c_new = (lv + gather(tot) - c2v) * mask
            return v2c_new, c2v

        v2c, c2v_hist = jax.lax.scan(body, v2c, None, length=n_iters)
        c2v = c2v_hist[-1]
        posterior = l + scatter_sum(c2v)
        hard = (posterior < 0).astype(jnp.uint8)
        par = jnp.sum(gather(hard.astype(jnp.float32)) * mask, axis=-1) % 2.0
        ok = ~(par > 0.5).any(axis=-1)
        return hard, ok

    return decode(llr)


def ldpc_layout(backend: str | None = None) -> str:
    """Decoder layout :func:`min_sum_decode` takes. The CPU keeps the flat
    segment-op form: segment reductions are plain loops on the host, while
    the dense form spends O(m·wr·n) one-hot MACs per reduction."""
    return "segment" if (backend or jax.default_backend()) == "cpu" \
        else "dense"


@partial(jax.jit, static_argnums=(0, 2))
def min_sum_decode(graph: LdpcGraph, llr: jnp.ndarray, n_iters: int = 25,
                   alpha: float = 0.8125):
    """Normalized min-sum BP. ``llr`` is [batch, n] (positive = bit 0).
    Returns (hard_bits [batch, n] uint8, syndrome_ok [batch] bool).

    Accelerators dispatch to the dense check-layout path
    (:func:`min_sum_decode_dense`), the CPU to the flat segment-op
    formulation (:func:`min_sum_decode_segment`); see :func:`ldpc_layout`."""
    if ldpc_layout() == "dense":
        return min_sum_decode_dense(graph, llr, n_iters, alpha=alpha)
    return min_sum_decode_segment(graph, llr, n_iters, alpha=alpha)


@partial(jax.jit, static_argnums=(0, 2))
def min_sum_decode_segment(graph: LdpcGraph, llr: jnp.ndarray,
                           n_iters: int = 25, alpha: float = 0.8125):
    """Normalized min-sum BP over flat Tanner-graph edge arrays: check
    updates are two-minimum segment reductions, variable updates segment
    sums."""
    m, n, E = graph.m, graph.n, graph.n_edges
    chk, var = graph.chk, graph.var

    def decode_one(l):
        v2c = l[var]                               # initial messages

        def body(carry, _):
            v2c, = carry
            # check update: two-minimum trick over each check's edges
            mag = jnp.abs(v2c)
            sgn = jnp.where(v2c < 0, -1.0, 1.0)
            # product of signs per check, excluding self: total product /
            # own sign (signs are ±1 so division = multiplication)
            neg = (v2c < 0).astype(jnp.int32)
            tot_neg = jax.ops.segment_sum(neg, chk, num_segments=m)
            par = ((tot_neg[chk] - neg) % 2)
            s_ex = jnp.where(par == 1, -1.0, 1.0)
            big = jnp.float32(1e30)
            min1 = jax.ops.segment_min(mag, chk, num_segments=m)
            is_min1 = mag <= min1[chk] + 0.0
            # second minimum: min over edges with the first-minimum edge
            # masked out (mask only ONE instance — use argmin by index)
            first_idx = jax.ops.segment_min(
                jnp.where(mag <= min1[chk], jnp.arange(E, dtype=jnp.int32),
                          E), chk, num_segments=m)
            masked = jnp.where(jnp.arange(E) == first_idx[chk], big, mag)
            min2 = jax.ops.segment_min(masked, chk, num_segments=m)
            use_min2 = jnp.arange(E) == first_idx[chk]
            c2v = alpha * s_ex * jnp.where(use_min2, min2[chk], min1[chk])
            # variable update: total sum per variable minus own message
            tot = jax.ops.segment_sum(c2v, var, num_segments=n)
            v2c_new = l[var] + tot[var] - c2v
            return (v2c_new,), c2v

        (v2c,), c2v_hist = jax.lax.scan(body, (v2c,), None, length=n_iters)
        c2v = c2v_hist[-1]
        tot = jax.ops.segment_sum(c2v, var, num_segments=n)
        posterior = l + tot
        hard = (posterior < 0).astype(jnp.uint8)
        # syndrome check: parity of hard bits on each check
        syn = jax.ops.segment_sum(hard[var].astype(jnp.int32), chk,
                                  num_segments=m) % 2
        return hard, ~(syn.astype(bool).any())

    return jax.vmap(decode_one)(llr)


def decode_np(H: np.ndarray, llr: np.ndarray, n_iters: int = 25,
              alpha: float = 0.8125) -> tuple[np.ndarray, np.ndarray]:
    """NumPy reference of :func:`min_sum_decode` (same schedule)."""
    H = np.asarray(H, np.uint8)
    m, n = H.shape
    chk, var = np.nonzero(H)
    E = len(chk)
    out_bits = []
    out_ok = []
    for l in np.atleast_2d(np.asarray(llr, np.float64)):
        v2c = l[var]
        c2v = np.zeros(E)
        for _ in range(n_iters):
            mag = np.abs(v2c)
            neg = (v2c < 0).astype(np.int64)
            tot_neg = np.bincount(chk, weights=neg, minlength=m)
            s_ex = np.where((tot_neg[chk] - neg) % 2 == 1, -1.0, 1.0)
            min1 = np.full(m, np.inf)
            np.minimum.at(min1, chk, mag)
            first_idx = np.full(m, E)
            cand = np.where(mag <= min1[chk], np.arange(E), E)
            np.minimum.at(first_idx, chk, cand)
            masked = np.where(np.arange(E) == first_idx[chk], np.inf, mag)
            min2 = np.full(m, np.inf)
            np.minimum.at(min2, chk, masked)
            use2 = np.arange(E) == first_idx[chk]
            c2v = alpha * s_ex * np.where(use2, min2[chk], min1[chk])
            tot = np.bincount(var, weights=c2v, minlength=n)
            v2c = l[var] + tot[var] - c2v
        tot = np.bincount(var, weights=c2v, minlength=n)
        hard = ((l + tot) < 0).astype(np.uint8)
        syn = np.bincount(chk, weights=hard[var], minlength=m) % 2
        out_bits.append(hard)
        out_ok.append(not syn.any())
    return np.stack(out_bits), np.asarray(out_ok)
