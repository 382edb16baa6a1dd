"""gnuradio4_tpu — a device-native stream/signal-processing framework.

Brand-new design with the capabilities of GNU Radio 4 (fair-acc/gnuradio4, the
C++23 reference), rebuilt idiomatically on JAX/XLA:

- blocks are array-level kernels over fixed-shape time blocks ``[channels, T]``;
- the flowgraph is traced into ONE jitted XLA program per scheduler step (XLA fuses
  elementwise chains — the hardware analog of GR4's compile-time BlockMerging);
- GR4's lock-free ring buffers + thread-pool scheduler become a thin host streaming
  pump with double-buffered device dispatch (core/scheduler.py);
- rate changes/stride resolve at compile time via block-size algebra (core/graph.py);
- tags ride a host-side sideband advancing in lock-step (core/tags.py);
- settings are staged/contextual; dynamic ones are runtime args (no recompile);
- multi-chip scaling uses jax.sharding Mesh + shard_map collectives (parallel/).
"""

import os as _os

from .core.block import (Block, BlockCtx, HostCtx, Port, PortRef, SinkBlock,
                         SourceBlock, UICategory)
from .core.compute_domain import ComputeDomain, DomainKind
from .core.compiler import CompiledGraph, compile_graph
from .core.errors import Error, GrError
from .core.graph import Edge, Graph
from .core.lifecycle import State
from .core.messages import Command, Message, MessageBus, Property
from .core.registry import (BlockRegistry, PluginLoader, global_registry,
                            global_scheduler_registry, register_block,
                            register_scheduler)
from .core.runtime import PipeSink, Runtime
from .core.scheduler import Scheduler, SimpleScheduler, BreadthFirstScheduler
from .core.settings import Setting, Settings, SettingsCtx
from .core.stream import StreamSpec
from .core.tags import Keys, Tag, TagPropagation
from .core.dataset import Axis, DataSet, SignalMeta
from .core.datasink import (DataSink, DataSinkQuery, DataSinkRegistry,
                            DataSetPoller, MultiplexedPoller, OverflowPolicy,
                            SnapshotPoller, StreamingPoller, TriggerPoller,
                            global_data_sink_registry)
from .core.merge import merge
from .core.profiler import NullProfiler, Profiler
from .core.trigger import (BasicTriggerNameCtxMatcher, MatchResult,
                           match_trigger)
from .core.yaml_io import load_grc, run_grc, save_grc
from .core.checkpoint import load_checkpoint, save_checkpoint
from .core import pmt

# importing the block library populates the global registry
from . import blocks  # noqa: E402,F401
from . import ops, parallel, utils  # noqa: E402,F401

__version__ = "0.1.0"


def _refuse_renamed_env() -> None:
    """The environment switches (``GR4_FIR_PRECISION``, ``GR4_FIR_TILE``,
    ``GR4_FFT_ENGINE``, ...) once had the prefix ``GR4TPU_``. A switch still
    set under its old name would be ignored without a word, so it is an
    error."""
    old = sorted(k for k in _os.environ if k.startswith("GR4TPU_"))
    if old:
        new = ["GR4_" + k[len("GR4TPU_"):] for k in old]
        raise GrError(f"environment variables {old} are no longer read: "
                      f"set {new} instead")


_refuse_renamed_env()

__all__ = [
    "Block", "BlockCtx", "HostCtx", "Port", "PortRef", "SinkBlock", "SourceBlock",
    "CompiledGraph", "compile_graph", "Error", "GrError", "Edge", "Graph", "State",
    "Command", "Message", "MessageBus", "Property", "BlockRegistry", "PluginLoader",
    "global_registry", "global_scheduler_registry", "register_block",
    "register_scheduler", "Runtime", "PipeSink", "Scheduler", "SimpleScheduler",
    "BreadthFirstScheduler",
    "Setting", "Settings", "SettingsCtx", "StreamSpec", "Keys", "Tag",
    "TagPropagation",
]
