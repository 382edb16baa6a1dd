"""Convolutional FEC: encoder + streaming Viterbi decoder.

Beyond the reference's blocklib (GR4 has no FEC) — classic gr-fec capability,
redesigned device-first: the Viterbi add-compare-select recursion runs as a
``lax.scan`` over received symbol pairs with ALL trellis states updated as one
vectorized [n_states] step (gather over precomputed predecessor tables), and
the traceback is a second (backward) scan. Default code: the ubiquitous
K=7, rate-1/2, polynomials 0o171/0o133 (Voyager/CCSDS/802.11).
"""

from __future__ import annotations

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np

from ..core.block import Block, Port
from ..core.registry import register_block
from ..core.settings import Setting


def _tables(k: int, polys: tuple[int, int]):
    """Precompute trellis tables (host NumPy, cached per (k, polys)).

    state = last k-1 input bits (newest at LSB). Input bit b moves
    s -> ((s<<1)|b) & mask; the encoder register is ((s<<1)|b) over k bits.
    Returns (enc_out[state, bit, 2], pred[state, 2], pred_bit_is: the input
    bit on entering ``state`` is state&1).
    """
    ns = 1 << (k - 1)
    mask = ns - 1
    enc_out = np.zeros((ns, 2, 2), np.int32)
    for s in range(ns):
        for b in (0, 1):
            reg = ((s << 1) | b) & ((1 << k) - 1)
            for j, g in enumerate(polys):
                enc_out[s, b, j] = bin(reg & g).count("1") & 1
    # predecessors of next-state t: the two states s with ((s<<1)|b)&mask == t
    pred = np.zeros((ns, 2), np.int32)
    for t in range(ns):
        b = t & 1
        base = t >> 1
        pred[t, 0] = base            # previous MSB was 0
        pred[t, 1] = base | (ns >> 1)  # previous MSB was 1
        # NOTE: both predecessors reach t with the SAME input bit b = t&1
    return enc_out, pred


@register_block("ConvEncoder")
class ConvEncoder(Block):
    """Rate-1/2 convolutional encoder: 1 bit in → 2 coded bits out
    (interleaved y0,y1). State carries the shift register across steps."""

    IN = (Port("in", dtype="int32"),)
    OUT = (Port("out", dtype="int32"),)
    constraint = Setting(default=7, kind="static", limits=(3, 12))
    poly0 = Setting(default=0o171, kind="static")
    poly1 = Setting(default=0o133, kind="static")

    @property
    def ratio(self):
        return Fraction(2, 1)

    def _k(self):
        return int(self.settings.get("constraint"))

    def init_state(self, ctx):
        return jnp.zeros((), jnp.int32)   # shift register (k-1 bits)

    def apply(self, state, ins, ctx):
        bits = ins["in"].astype(jnp.int32)
        k = self._k()
        g0 = int(self.settings.get("poly0"))
        g1 = int(self.settings.get("poly1"))
        enc_out, _ = _tables(k, (g0, g1))
        table = jnp.asarray(enc_out)      # [ns, 2, 2]

        def step(s, b):
            y = table[s, b]               # [2]
            s2 = ((s << 1) | b) & ((1 << (k - 1)) - 1)
            return s2, y

        s_end, pairs = jax.lax.scan(step, state, bits)
        return s_end, {"out": pairs.reshape(-1).astype(jnp.int32)}


@register_block("ViterbiDecoder")
class ViterbiDecoder(Block):
    """Streaming Viterbi decoder for the rate-1/2 code (hard bits or
    soft confidences via ``soft=True``).

    Consumes interleaved coded bits (2 per message bit), emits decoded bits
    with ``traceback`` bits of latency: each step decodes its symbols with a
    truncated traceback into the previous step's tail (path metrics AND the
    last ``traceback`` decision columns are carried state), so the stream is
    seamless across scheduler blocks.
    """

    IN = (Port("in"),)   # int32 hard bits, or float32 soft values in [0,1]
    OUT = (Port("out", dtype="int32"),)
    constraint = Setting(default=7, kind="static", limits=(3, 10))
    poly0 = Setting(default=0o171, kind="static")
    poly1 = Setting(default=0o133, kind="static")
    traceback = Setting(default=64, kind="static", limits=(8, 512))
    soft = Setting(default=False, kind="static",
                   description="input is float32 confidence in [0,1] "
                               "(0=strong 0, 1=strong 1) instead of hard bits")

    @property
    def ratio(self):
        return Fraction(1, 2)

    @property
    def alignment(self):
        return 2

    def _cfg(self):
        return (int(self.settings.get("constraint")),
                (int(self.settings.get("poly0")),
                 int(self.settings.get("poly1"))))

    def init_state(self, ctx):
        k, _ = self._cfg()
        ns = 1 << (k - 1)
        tb = int(self.settings.get("traceback"))
        m0 = jnp.full((ns,), 1e6, jnp.float32).at[0].set(0.0)
        return {"metrics": m0,
                "tail_dec": jnp.zeros((tb, ns), jnp.int32)}

    def apply(self, state, ins, ctx):
        k, polys = self._cfg()
        ns = 1 << (k - 1)
        tb = int(self.settings.get("traceback"))
        enc_out, pred = _tables(k, polys)
        predj = jnp.asarray(pred)                       # [ns, 2]
        # branch outputs for entering state t from predecessor j: the encoder
        # output of (pred[t,j], input bit t&1)
        t_idx = np.arange(ns)
        br = enc_out[pred[:, 0], t_idx & 1], enc_out[pred[:, 1], t_idx & 1]
        br = np.stack(br, axis=1)                       # [ns, 2, 2]
        brj = jnp.asarray(br.astype(np.float32))

        r = ins["in"].astype(jnp.float32).reshape(-1, 2)   # [n, 2] hard bits
        n = r.shape[0]

        def acs(m, rp):
            # branch metric: hamming distance to each entering branch
            bm = jnp.sum(jnp.abs(brj - rp[None, None, :]), axis=-1)  # [ns,2]
            cand = m[predj] + bm                                     # [ns,2]
            dec = jnp.argmin(cand, axis=-1).astype(jnp.int32)
            m2 = jnp.min(cand, axis=-1)
            m2 = m2 - jnp.min(m2)                                    # renorm
            return m2, (dec, m2)

        m_end, (decs, _) = jax.lax.scan(acs, state["metrics"], r)

        # traceback over [tail_dec ; decs] from the best end state
        all_dec = jnp.concatenate([state["tail_dec"], decs], axis=0)  # [tb+n]
        total = tb + n

        def back(s, dec_row):
            j = dec_row[s]
            p = predj[s, j]
            bit = s & 1
            return p, bit

        _, bits_rev = jax.lax.scan(back, jnp.argmin(m_end).astype(jnp.int32),
                                   all_dec, reverse=True)
        bits = bits_rev.astype(jnp.int32)   # one decoded bit per trellis row
        # rows ≥ tb from the end of the traceback are converged: that is
        # exactly the OLDEST n rows — emit them (stream latency = tb bits;
        # the first tb output bits of a fresh stream are startup garbage,
        # like a filter's group-delay transient)
        emit = bits[:n]
        new_tail = jax.lax.dynamic_slice_in_dim(all_dec, total - tb, tb)
        return ({"metrics": m_end, "tail_dec": new_tail},
                {"out": emit})


@register_block("Scrambler")
class Scrambler(Block):
    """Multiplicative (self-synchronizing) LFSR scrambler over bits
    (≈ GNU Radio scrambler_bb): out[n] = in[n] ⊕ parity(mask & reg);
    reg shifts in out[n]. Default CCSDS/V.35-style x^7+x^4+1 (mask 0o221→
    taps at 7,4 ⇒ mask 0x48, length 7)."""

    IN = (Port("in", dtype="int32"),)
    OUT = (Port("out", dtype="int32"),)
    mask = Setting(default=0x48, kind="static",
                   description="feedback tap mask over the register")
    length = Setting(default=7, kind="static", limits=(2, 30))
    seed = Setting(default=0x7F, kind="static")

    _DESCRAMBLE = False

    def init_state(self, ctx):
        return jnp.asarray(int(self.settings.get("seed")), jnp.int32)

    def apply(self, state, ins, ctx):
        bits = ins["in"].astype(jnp.int32)
        mask = int(self.settings.get("mask"))
        length = int(self.settings.get("length"))
        regmask = (1 << length) - 1

        def parity(v):
            # popcount & 1 over <=30 bits, vectorized-friendly
            v = v ^ (v >> 16)
            v = v ^ (v >> 8)
            v = v ^ (v >> 4)
            v = v ^ (v >> 2)
            v = v ^ (v >> 1)
            return v & 1

        descramble = self._DESCRAMBLE

        def step(reg, b):
            fb = parity(reg & mask)
            y = b ^ fb
            shift_in = b if descramble else y   # self-synchronizing property
            reg2 = ((reg << 1) | shift_in) & regmask
            return reg2, y

        reg_end, out = jax.lax.scan(step, state, bits)
        return reg_end, {"out": out.astype(jnp.int32)}


@register_block("Descrambler")
class Descrambler(Scrambler):
    """Inverse of :class:`Scrambler`; self-synchronizes after ``length`` bits
    regardless of seed (≈ GNU Radio descrambler_bb)."""

    _DESCRAMBLE = True


# --------------------------------------------------------- Golay (24,12,8)

def _golay_B() -> np.ndarray:
    """The 12x12 B of G=[I|B] for the extended binary Golay code —
    quadratic-residue construction: b_ij = [(i+j) mod 11 in {0} u QR(11)]
    for i,j < 11, ones border, zero corner.  Symmetric; verified d_min = 8
    by full enumeration in the tests."""
    qr0 = {0, 1, 3, 4, 5, 9}
    B = np.zeros((12, 12), np.uint8)
    for i in range(11):
        for j in range(11):
            B[i, j] = 1 if (i + j) % 11 in qr0 else 0
    B[11, :11] = 1
    B[:11, 11] = 1
    return B


_GOLAY_B = _golay_B()
_GOLAY_G = np.concatenate([np.eye(12, dtype=np.uint8), _GOLAY_B], axis=1)
# G = [I|B], B symmetric => H = [B|I] and syndrome s = r H^T = r1 B + r2
_GOLAY_H = np.concatenate([_GOLAY_B, np.eye(12, dtype=np.uint8)], axis=1)


def _golay_syndrome_table() -> np.ndarray:
    """[4096, 24] coset-leader error patterns for every weight <= 3 error
    (2325 correctable syndromes); uncorrectable syndromes map to zeros —
    the decoder then reports detected-uncorrectable via the recomputed
    syndrome."""
    table = np.zeros((4096, 24), np.uint8)
    filled = np.zeros(4096, bool)
    idx24 = np.arange(24)
    for weight in (1, 2, 3):
        from itertools import combinations
        for pos in combinations(idx24, weight):
            e = np.zeros(24, np.uint8)
            e[list(pos)] = 1
            s = int(((e @ _GOLAY_H.T) % 2 @ (1 << np.arange(12))).sum())
            if not filled[s]:
                filled[s] = True
                table[s] = e
    return table


def golay_encode(msg_bits: np.ndarray) -> np.ndarray:
    """[..., 12k] info bits → [..., 24k] systematic extended-Golay bits."""
    m = np.asarray(msg_bits, np.uint8)
    frames = m.reshape(-1, 12)
    return ((frames @ _GOLAY_G) % 2).astype(np.uint8).reshape(
        m.shape[:-1] + (m.shape[-1] // 12 * 24,))


def golay_decode(code_bits: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """[..., 24k] received bits → ([..., 12k] corrected info bits,
    per-frame corrected-error counts; -1 marks detected-uncorrectable)."""
    table = _golay_syndrome_table()
    r = np.asarray(code_bits, np.uint8).reshape(-1, 24)
    syn = ((r @ _GOLAY_H.T) % 2 @ (1 << np.arange(12))).astype(np.int64)
    err = table[syn]
    fixed = r ^ err
    ok = ((fixed @ _GOLAY_H.T) % 2).sum(axis=1) == 0
    n_err = np.where(ok, err.sum(axis=1), -1).astype(np.int32)
    return fixed[:, :12].reshape(np.asarray(code_bits).shape[:-1] + (-1,)), \
        n_err


@register_block("GolayEncoder")
class GolayEncoder(Block):
    """Extended Golay (24,12,8) encoder: 12 info bits → 24 coded bits per
    frame (systematic; the GF(2) matmul runs on device like LdpcEncoder)."""

    IN = (Port("in", dtype="float32"),)
    OUT = (Port("out", dtype="float32"),)

    @property
    def ratio(self):
        return Fraction(2, 1)

    @property
    def alignment(self):
        return 12

    def apply(self, state, ins, ctx):
        x = ins["in"]
        frames = x.reshape(x.shape[:-1] + (-1, 12))
        g = jnp.asarray(_GOLAY_G, jnp.float32)
        coded = jnp.mod(frames @ g, 2.0)
        return state, {"out": coded.reshape(x.shape[:-1]
                                            + (x.shape[-1] // 12 * 24,))}


@register_block("GolayDecoder")
class GolayDecoder(Block):
    """Extended Golay (24,12,8) bounded-distance decoder, fully on device:
    syndrome = GF(2) matmul, then ONE gather into the precomputed
    [4096, 24] coset-leader table corrects any <= 3-bit error pattern.
    Weight-4 patterns are detected-uncorrectable (emitted as-is; the
    host-side :func:`golay_decode` additionally reports them)."""

    IN = (Port("in", dtype="float32"),)
    OUT = (Port("out", dtype="float32"),)

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._table = _golay_syndrome_table()

    @property
    def ratio(self):
        return Fraction(1, 2)

    @property
    def alignment(self):
        return 24

    def apply(self, state, ins, ctx):
        x = ins["in"]
        r = x.reshape(x.shape[:-1] + (-1, 24))
        h_t = jnp.asarray(_GOLAY_H.T, jnp.float32)
        pow2 = jnp.asarray(1 << np.arange(12), jnp.float32)
        syn = (jnp.mod(r @ h_t, 2.0) @ pow2).astype(jnp.int32)
        err = jnp.asarray(self._table, jnp.float32)[syn]
        fixed = jnp.mod(r + err, 2.0)
        out = fixed[..., :12]
        return state, {"out": out.reshape(x.shape[:-1]
                                          + (x.shape[-1] // 24 * 12,))}


# ------------------------------------------------------- Hamming (2^m-1)

def _hamming_matrices(m: int) -> tuple[np.ndarray, np.ndarray]:
    """Systematic (n=2^m-1, k=n-m) Hamming G=[I|P], H=[P^T|I]; H's columns
    enumerate every nonzero m-bit pattern so the syndrome names the error."""
    n = (1 << m) - 1
    k = n - m
    cols = np.asarray([[(v >> b) & 1 for b in range(m)]
                       for v in range(1, n + 1)], np.uint8)   # [n, m]
    weights = cols.sum(axis=1)
    data_cols = np.flatnonzero(weights >= 2)     # k columns → data positions
    par_cols = np.flatnonzero(weights == 1)      # m unit columns → parity
    P = cols[data_cols]                           # [k, m]
    order = np.concatenate([data_cols, par_cols])
    return P, order                               # order maps sys → H column


def hamming_encode(msg_bits: np.ndarray, m: int = 3) -> np.ndarray:
    """[..., k·f] info bits → [..., n·f] systematic Hamming bits."""
    P, _ = _hamming_matrices(m)
    k = P.shape[0]
    x = np.asarray(msg_bits, np.uint8).reshape(-1, k)
    par = (x @ P) % 2
    out = np.concatenate([x, par], axis=1)
    return out.reshape(np.asarray(msg_bits).shape[:-1] + (-1,))


def hamming_decode(code_bits: np.ndarray, m: int = 3
                   ) -> tuple[np.ndarray, np.ndarray]:
    """[..., n·f] → ([..., k·f] corrected info bits, per-frame flip counts)."""
    P, order = _hamming_matrices(m)
    k = P.shape[0]
    n = (1 << m) - 1
    r = np.asarray(code_bits, np.uint8).reshape(-1, n)
    syn = ((r[:, :k] @ P) + r[:, k:]) % 2
    syn_val = syn @ (1 << np.arange(m))           # H column value of the error
    # map syndrome value v (1..n) back to the systematic position
    colval = np.zeros(n + 1, np.int64)
    for sys_pos, h_col in enumerate(order):
        colval[h_col + 1] = sys_pos
    err_pos = colval[syn_val]
    fixed = r.copy()
    has_err = syn_val > 0
    fixed[np.arange(len(r)), err_pos] ^= has_err.astype(np.uint8)
    return fixed[:, :k].reshape(np.asarray(code_bits).shape[:-1] + (-1,)), \
        has_err.astype(np.int32)


@register_block("HammingEncoder")
class HammingEncoder(Block):
    """Systematic Hamming (2^m−1, 2^m−1−m) encoder on device (GF(2)
    matmul); m=3 → (7,4), m=4 → (15,11)."""

    IN = (Port("in", dtype="float32"),)
    OUT = (Port("out", dtype="float32"),)
    m = Setting(default=3, kind="static")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._P, _ = _hamming_matrices(int(self.settings.get("m")))

    @property
    def ratio(self):
        n = (1 << int(self.settings.get("m"))) - 1
        return Fraction(n, self._P.shape[0])

    @property
    def alignment(self):
        return self._P.shape[0]

    def apply(self, state, ins, ctx):
        x = ins["in"]
        k = self._P.shape[0]
        frames = x.reshape(x.shape[:-1] + (-1, k))
        par = jnp.mod(frames @ jnp.asarray(self._P, jnp.float32), 2.0)
        out = jnp.concatenate([frames, par], axis=-1)
        n = k + self._P.shape[1]
        return state, {"out": out.reshape(x.shape[:-1]
                                          + (x.shape[-1] // k * n,))}


@register_block("HammingDecoder")
class HammingDecoder(Block):
    """Hamming single-error-correcting decoder on device: syndrome matmul +
    one scatterless correction via a one-hot mask (no dynamic shapes)."""

    IN = (Port("in", dtype="float32"),)
    OUT = (Port("out", dtype="float32"),)
    m = Setting(default=3, kind="static")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        m = int(self.settings.get("m"))
        self._P, order = _hamming_matrices(m)
        n = (1 << m) - 1
        colval = np.zeros(n + 1, np.int64)
        for sys_pos, h_col in enumerate(order):
            colval[h_col + 1] = sys_pos
        self._colval = colval
        self._n = n

    @property
    def ratio(self):
        return Fraction(self._P.shape[0], self._n)

    @property
    def alignment(self):
        return self._n

    def apply(self, state, ins, ctx):
        x = ins["in"]
        k, n = self._P.shape[0], self._n
        r = x.reshape(x.shape[:-1] + (-1, n))
        par = jnp.mod(r[..., :k] @ jnp.asarray(self._P, jnp.float32)
                      + r[..., k:], 2.0)
        syn_val = (par @ jnp.asarray(1 << np.arange(self._P.shape[1]),
                                     jnp.float32)).astype(jnp.int32)
        err_pos = jnp.asarray(self._colval, jnp.int32)[syn_val]
        flip = (jax.nn.one_hot(err_pos, n, dtype=x.dtype)
                * (syn_val > 0)[..., None].astype(x.dtype))
        fixed = jnp.mod(r + flip, 2.0)
        return state, {"out": fixed[..., :k].reshape(
            x.shape[:-1] + (x.shape[-1] // n * k,))}
