"""LDPC stream blocks over :mod:`gnuradio4_tpu.ops.ldpc`.

Both halves run ON DEVICE inside the fused flowgraph program: encoding is a
0/1 matmul against the systematic generator (matrix units), decoding is the
normalized min-sum belief propagation vmapped over the frames in each
scheduler step (segment reductions + ``lax.scan`` over iterations). The
code is constructed deterministically from (n, m, wc, seed) so a matched
encoder/decoder pair needs no side channel.
"""

from __future__ import annotations

from fractions import Fraction

import jax.numpy as jnp
import numpy as np

from ..core.block import Block, Port
from ..core.registry import register_block
from ..core.settings import Setting
from ..ops.ldpc import LdpcGraph, encode, make_ldpc, min_sum_decode


def _code(settings):
    return make_ldpc(int(settings.get("n")), int(settings.get("m")),
                     wc=int(settings.get("wc")),
                     seed=int(settings.get("seed")))


@register_block("LdpcEncoder")
class LdpcEncoder(Block):
    """k data bits → n codeword bits per frame (systematic; device matmul)."""

    IN = (Port("in", dtype="float32"),)
    OUT = (Port("out", dtype="float32"),)
    n = Setting(default=256, kind="static")
    m = Setting(default=128, kind="static")
    wc = Setting(default=3, kind="static")
    seed = Setting(default=0, kind="static")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._H, self._G = _code(self.settings)
        self.k = self._G.shape[0]

    @property
    def ratio(self):
        return Fraction(int(self.settings.get("n")), self.k)

    @property
    def alignment(self):
        return self.k

    def apply(self, state, ins, ctx):
        x = ins["in"]
        k, n = self.k, int(self.settings.get("n"))
        frames = x.reshape(x.shape[:-1] + (-1, k))
        g = jnp.asarray(self._G, jnp.float32)
        coded = jnp.mod(frames @ g, 2.0)
        return state, {"out": coded.reshape(x.shape[:-1]
                                            + (x.shape[-1] // k * n,))}


@register_block("LdpcDecoder")
class LdpcDecoder(Block):
    """n soft LLRs (positive = bit 0) → k corrected systematic bits per
    frame; normalized min-sum BP on device, ``n_iters`` fixed (static)."""

    IN = (Port("in", dtype="float32"),)
    OUT = (Port("out", dtype="float32"),)
    n = Setting(default=256, kind="static")
    m = Setting(default=128, kind="static")
    wc = Setting(default=3, kind="static")
    seed = Setting(default=0, kind="static")
    n_iters = Setting(default=25, kind="static")
    alpha = Setting(default=0.8125, kind="static",
                    description="min-sum normalization factor")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._H, self._G = _code(self.settings)
        self.k = self._G.shape[0]
        self._tanner = LdpcGraph(self._H)

    @property
    def ratio(self):
        return Fraction(self.k, int(self.settings.get("n")))

    @property
    def alignment(self):
        return int(self.settings.get("n"))

    def apply(self, state, ins, ctx):
        x = ins["in"]
        n, k = int(self.settings.get("n")), self.k
        lead = x.shape[:-1]
        frames = x.reshape((-1, n))
        bits, _ok = min_sum_decode(self._tanner, frames,
                                   int(self.settings.get("n_iters")),
                                   float(self.settings.get("alpha")))
        out = bits[:, :k].astype(jnp.float32)
        return state, {"out": out.reshape(lead + (x.shape[-1] // n * k,))}
