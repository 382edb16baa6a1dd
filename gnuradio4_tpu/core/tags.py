"""Tag (per-sample metadata) sideband.

Reference model: tags are ``{index, property_map}`` records riding a sideband ring
parallel to the sample ring, keyed by absolute sample index (reference:
core/include/gnuradio-4.0/Tag.hpp:98 ``BasicTag``; TagChunkBuffer.hpp). Propagation
policies decide how input tags map to output streams
(reference: core/include/gnuradio-4.0/annotated.hpp:79).

Design: the jitted device program moves only dense sample blocks; tags ride
a **host-side sideband** that advances in lock-step with each scheduler step. This is
semantically faithful: the reference also only applies tag-driven settings at chunk
boundaries (Block.hpp:1986 chunk break at next tag), and per-step host tag work is
O(tags), not O(samples). Index mapping across rate-changing blocks uses the block's
static resampling ratio — the same arithmetic the reference does per work() call.

Blocks that need *device-visible* tag data (e.g. trigger gating) receive a
``TagArrays`` view: fixed-capacity index/valid arrays built once per step.
"""

from __future__ import annotations

import dataclasses
import enum
from fractions import Fraction
from typing import Any, Iterable

import numpy as np


# Default tag dictionary (reference Tag.hpp:238-260).
class Keys:
    SAMPLE_RATE = "sample_rate"
    SIGNAL_NAME = "signal_name"
    NUM_CHANNELS = "num_channels"
    SIGNAL_QUANTITY = "signal_quantity"
    SIGNAL_UNIT = "signal_unit"
    SIGNAL_MIN = "signal_min"
    SIGNAL_MAX = "signal_max"
    N_DROPPED_SAMPLES = "n_dropped_samples"
    FREQUENCY = "frequency"
    RX_OVERFLOW = "rx_overflow"
    TRIGGER_NAME = "trigger_name"
    TRIGGER_TIME = "trigger_time"
    TRIGGER_OFFSET = "trigger_offset"
    TRIGGER_META_INFO = "trigger_meta_info"
    LOCAL_TIME = "local_time"
    CONTEXT = "context"
    CTX_TIME = "ctx_time"
    RESET_DEFAULT = "reset_default"
    STORE_DEFAULT = "store_default"
    END_OF_STREAM = "end_of_stream"


@dataclasses.dataclass(frozen=True, order=True)
class Tag:
    """A tag at an absolute sample index with an arbitrary property map."""

    index: int
    map: dict[str, Any] = dataclasses.field(compare=False, default_factory=dict)

    def shifted(self, delta: int) -> "Tag":
        return Tag(self.index + delta, self.map)

    def rescaled(self, ratio: Fraction) -> "Tag":
        """Map this tag through a rate change of out/in = ratio: the index moves
        to the output grid AND a carried ``sample_rate`` value scales with it
        (a decimated stream runs at the decimated rate)."""
        new_index = int(self.index * ratio.numerator // ratio.denominator)
        m = self.map
        if ratio != 1 and Keys.SAMPLE_RATE in m:
            m = dict(m)
            m[Keys.SAMPLE_RATE] = float(m[Keys.SAMPLE_RATE]) * float(ratio)
        return Tag(new_index, m)


class TagPropagation(enum.Enum):
    """≈ reference tag-propagation policies (annotated.hpp:79, Block.hpp:726-729)."""

    TPP_DONT = "dont"                  # block handles tags itself / drops them
    TPP_ALL_TO_ALL = "all_to_all"      # every input tag forwarded to every output
    TPP_ONE_TO_ONE = "one_to_one"      # i-th input port → i-th output port
    TPP_CUSTOM = "custom"              # block overrides process_tags()


def merge_maps(tags: Iterable[Tag]) -> dict[str, Any]:
    """Merge tag maps at identical indices; later tags win per key."""
    merged: dict[str, Any] = {}
    for t in tags:
        merged.update(t.map)
    return merged


def coalesce(tags: list[Tag]) -> list[Tag]:
    """Sort by index and merge same-index tags (single-writer semantics per step)."""
    if not tags:
        return tags
    by_index: dict[int, dict[str, Any]] = {}
    for t in sorted(tags):
        by_index.setdefault(t.index, {}).update(t.map)
    return [Tag(i, m) for i, m in by_index.items()]


def dedup(tags: list[Tag]) -> list[Tag]:
    """Sort by index, dropping only *exact* duplicates (same index AND equal
    map). Distinct tags at the same index stay distinct, as in the reference
    (Block::inputTags keeps a vector<Tag> — e.g. two different triggers on one
    sample each open their own DataSink window, qa_DataSink.cpp:438-443);
    stable sort keeps arrival order for ties."""
    if not tags:
        return tags
    out: list[Tag] = []
    run_start = 0          # first output tag sharing the current index
    for t in sorted(tags):
        if out and out[-1].index != t.index:
            run_start = len(out)
        # only same-index neighbours can be exact duplicates (sorted input)
        if any(u.map == t.map for u in out[run_start:]):
            continue
        out.append(t)
    return out


@dataclasses.dataclass
class TagArrays:
    """Fixed-capacity device-visible view of a step's tags (indices within the step).

    ``indices``/``valid`` are dense NumPy arrays suitable for feeding a jitted program
    (static capacity ⇒ static shapes). Payloads stay host-side; numeric values for a
    single well-known key can be packed via :meth:`values_for`.
    """

    capacity: int
    indices: np.ndarray  # int32[capacity]
    valid: np.ndarray    # bool[capacity]
    tags: list[Tag]      # backing host tags (len ≤ capacity dense-packed first)

    @classmethod
    def from_tags(cls, tags: list[Tag], capacity: int) -> "TagArrays":
        tags = coalesce(tags)[:capacity]
        idx = np.zeros(capacity, dtype=np.int32)
        val = np.zeros(capacity, dtype=bool)
        for i, t in enumerate(tags):
            idx[i] = t.index
            val[i] = True
        return cls(capacity=capacity, indices=idx, valid=val, tags=tags)

    def values_for(self, key: str, default: float = 0.0) -> np.ndarray:
        out = np.full(self.capacity, default, dtype=np.float32)
        for i, t in enumerate(self.tags):
            if key in t.map:
                out[i] = float(t.map[key])
        return out


def propagate(
    in_tags: dict[str, list[Tag]],
    *,
    policy: TagPropagation,
    out_ports: list[str],
    in_ports: list[str],
    ratio: Fraction = Fraction(1),
) -> dict[str, list[Tag]]:
    """Default host-side tag forwarding (≈ Block::forwardInputTags, Block.hpp:1130)."""
    out: dict[str, list[Tag]] = {p: [] for p in out_ports}
    if policy is TagPropagation.TPP_DONT or not out_ports:
        return out
    if policy is TagPropagation.TPP_ONE_TO_ONE:
        for i, op in enumerate(out_ports):
            if i < len(in_ports):
                out[op] = [t.rescaled(ratio) for t in in_tags.get(in_ports[i], [])]
        return out
    # TPP_ALL_TO_ALL (default); exact-duplicate removal only — distinct tags
    # at the same index are preserved (reference vector<Tag> semantics)
    merged: list[Tag] = []
    for p in in_ports:
        merged.extend(in_tags.get(p, []))
    merged = dedup([t.rescaled(ratio) for t in merged])
    for op in out_ports:
        out[op] = list(merged)
    return out
