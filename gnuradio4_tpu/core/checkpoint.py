"""Checkpoint / resume.

Reference persistence = settings (`storeDefaults`, SettingsCtx presets) + full
flowgraph YAML round-trip (SURVEY §5 checkpoint/resume); streaming data is not
checkpointed. This build extends this with a **device-state snapshot**: the
carried block states (FIR tails, NCO phases, PRNG keys) are a pytree that can be
saved/restored, so a streaming run resumes bit-exactly mid-stream.

Layout of a checkpoint directory:
    graph.yaml    flowgraph + settings (+ contexts) — load_grc-compatible
    states.npz    flattened per-block state leaves, keyed "block.name/leaf/path"
    meta.json     scheduler counters (step, abs in/out, finished sources, rates)
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import jax
import numpy as np

from .errors import GrError
from .scheduler import Scheduler
from .yaml_io import load_grc, save_grc


def _state_keys(states: dict[str, Any], name_of: dict[str, str]
                ) -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    for uname, state in states.items():
        # synthetic keys (feedback back-edges "__fb__<i>") are position-stable
        # across processes and serialize under their own name
        bname = name_of.get(uname, uname)
        leaves_with_paths = jax.tree_util.tree_flatten_with_path(state)[0]
        for path, leaf in leaves_with_paths:
            key = bname + "".join(str(p) for p in path)
            if _is_prng_key(leaf):
                out[key] = np.asarray(jax.random.key_data(leaf))
            else:
                out[key] = np.asarray(leaf)
    return out


def _is_prng_key(leaf: Any) -> bool:
    try:
        return jax.dtypes.issubdtype(leaf.dtype, jax.dtypes.prng_key)
    except Exception:
        return False


def save_checkpoint(sched: Scheduler, path: str | Path) -> Path:
    """Snapshot a (paused or running) scheduler to ``path`` (a directory).

    Takes the scheduler's step-boundary lock so states and counters are
    captured atomically between steps — a concurrent pump thread can never
    donate the state buffers mid-snapshot."""
    with sched.step_lock:
        return _save_checkpoint_locked(sched, path)


def _save_checkpoint_locked(sched: Scheduler, path: str | Path) -> Path:
    if sched.compiled is None:
        raise GrError("scheduler not initialised; nothing to checkpoint")
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    names = [b.name for b in sched.compiled.order]
    if len(set(names)) != len(names):
        raise GrError(f"checkpoint requires unique block names; duplicates in "
                      f"{sorted(names)}")
    (p / "graph.yaml").write_text(
        save_grc(sched.graph, sample_rate=sched.sample_rate,
                 block_len=sched.block_len))
    name_of = {b.unique_name: b.name for b in sched.compiled.order}
    host_states = jax.device_get(sched._states)
    np.savez(p / "states.npz", **_state_keys(host_states, name_of))
    meta = {
        "step": sched._step,
        "abs_in": {name_of[k]: v for k, v in sched._abs_in.items()
                   if k in name_of},
        "abs_out": {name_of[k]: v for k, v in sched._abs_out.items()
                    if k in name_of},
        "finished_sources": [name_of[k] for k in sched._finished_sources
                             if k in name_of],
        "eos_announced": [name_of[k] for k in sched._eos_announced
                          if k in name_of],
        "sample_rate": sched.sample_rate,
        "block_len": sched.block_len,
    }
    (p / "meta.json").write_text(json.dumps(meta, indent=1))
    return p


def load_checkpoint(path: str | Path, **scheduler_kwargs) -> Scheduler:
    """Rebuild a scheduler from a checkpoint; states/counters are restored so the
    next step continues exactly where the snapshot left off."""
    p = Path(path)
    meta = json.loads((p / "meta.json").read_text())
    graph = load_grc((p / "graph.yaml").read_text())
    kw = dict(scheduler_kwargs)
    kw.setdefault("sample_rate", meta["sample_rate"])
    kw.setdefault("block_len", meta["block_len"])
    sched = Scheduler(graph, **kw)
    sched.init()
    blob = np.load(p / "states.npz")
    name_of = {b.unique_name: b.name for b in sched.compiled.order}
    uname_of = {v: k for k, v in name_of.items()}
    # restore leaves by matching the freshly-initialised structure
    for uname, state in sched._states.items():
        bname = name_of.get(uname, uname)
        paths, treedef = jax.tree_util.tree_flatten_with_path(state)
        leaves = []
        for path, leaf in paths:
            key = bname + "".join(str(pp) for pp in path)
            if key not in blob:
                raise GrError(f"checkpoint missing state leaf {key!r}")
            saved = blob[key]
            if _is_prng_key(leaf):
                saved = jax.random.wrap_key_data(
                    np.asarray(saved, dtype=np.uint32))
            elif getattr(leaf, "shape", None) != saved.shape:
                raise GrError(f"state shape mismatch for {key!r}: "
                              f"{saved.shape} vs {getattr(leaf, 'shape', None)}")
            leaves.append(saved)
        sched._states[uname] = jax.tree_util.tree_unflatten(treedef, leaves)
    sched._step = int(meta["step"])
    sched._abs_in = {uname_of[n]: int(v) for n, v in meta["abs_in"].items()}
    sched._abs_out = {uname_of[n]: int(v) for n, v in meta["abs_out"].items()}
    sched._finished_sources = {uname_of[n] for n in meta["finished_sources"]}
    sched._eos_announced = {uname_of[n] for n in meta["eos_announced"]}
    return sched
