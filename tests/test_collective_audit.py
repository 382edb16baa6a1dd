"""HLO collective audit invariants (round-4): the sp time-sharding must cost
O(taps·channels) interconnect bytes per step — NEVER O(T) — and the lowered program
must contain the expected collective kinds. This pins the scaling story the
SCALING artifact's model is built on (≈ the reference has no distribution;
this is the accelerator build's value-add, SURVEY §2.6)."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

from audit_collectives import audit_hlo, lower_text  # noqa: E402


def _headline(block_len, mesh):
    from audit_collectives import build_headline
    return build_headline(block_len, mesh)


def _mesh(n):
    import jax
    from jax.sharding import Mesh
    devs = jax.devices("cpu")
    if len(devs) < n:
        pytest.skip(f"needs {n} virtual devices")
    return Mesh(np.asarray(devs[:n]), ("sp",))


class TestHaloInvariance:
    def test_permute_bytes_independent_of_block_len(self):
        mesh = _mesh(4)
        a = audit_hlo(lower_text(_headline(1 << 16, mesh)))
        b = audit_hlo(lower_text(_headline(1 << 18, mesh)))
        pa = a.get("collective-permute", {"bytes": 0})
        pb = b.get("collective-permute", {"bytes": 0})
        assert pa["bytes"] > 0, "sp lowering lost its halo exchange"
        assert pa["bytes"] == pb["bytes"], (
            f"halo traffic scales with T: {pa} vs {pb} — sp lowering must "
            f"exchange only the (taps-1)-sample overlap-save boundary")

    def test_no_full_reshard_collectives(self):
        # the headline chain is frame/time-local end to end: nothing in it
        # may all-gather or all-to-all stream data (those are O(T))
        mesh = _mesh(4)
        T = 1 << 16
        ops = audit_hlo(lower_text(_headline(T, mesh)))
        stream_bytes = T // 4 * 8   # one local complex64 shard
        for kind in ("all-gather", "all-to-all"):
            got = ops.get(kind, {"bytes": 0})["bytes"]
            assert got < stream_bytes / 8, (
                f"{kind} moves {got} B/step — an O(T) re-shard leaked into "
                f"the time-local chain")

    def test_audit_parser_on_known_hlo(self):
        text = """
  %x = f32[16,1024]{1,0} collective-permute(f32[16,1024]{1,0} %a), source_target_pairs={{0,1}}
  %y = (f32[8]{0}, f32[8]{0}) all-reduce-start(f32[8]{0} %b, f32[8]{0} %c), replica_groups={}
  %z = f32[8]{0} all-reduce-done((f32[8]{0}, f32[8]{0}) %y)
  %w = c64[4,256]{1,0} all-to-all(c64[4,256]{1,0} %d), dimensions={1}
"""
        ops = audit_hlo(text)
        assert ops["collective-permute"] == {"count": 1,
                                             "bytes": 16 * 1024 * 4}
        # -start counted once, -done skipped (no double count)
        assert ops["all-reduce"]["count"] == 1
        assert ops["all-to-all"] == {"count": 1, "bytes": 4 * 256 * 8}
