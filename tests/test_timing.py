"""The timing helpers (``gnuradio4_tpu.utils.timing``) on a fake clock: the
numbers they report follow from the wall time they saw and the scheduler's
logical-step count, with no double counting of ``batch_steps``."""

import jax.numpy as jnp
import pytest

from gnuradio4_tpu.utils import timing


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _FakeScheduler:
    """``step_once`` advances the logical-step count by ``batch`` and the
    clock by ``compile_s`` (first dispatch only) plus ``batch * step_s``."""

    def __init__(self, clock, batch, dispatches, compile_s, step_s):
        self.clock, self.batch, self.left = clock, batch, dispatches
        self.compile_s, self.step_s = compile_s, step_s
        self._step = 0
        self._states = jnp.zeros(())

    def step_once(self):
        self.clock.t += (self.compile_s if self._step == 0 else 0.0) \
            + self.batch * self.step_s
        self._step += self.batch
        self.left -= 1
        return self.left > 0


@pytest.mark.parametrize("batch", [1, 8])
def test_scheduler_timing_is_per_logical_step(monkeypatch, batch):
    clock = _Clock()
    monkeypatch.setattr(timing.time, "perf_counter", clock)
    sched = _FakeScheduler(clock, batch, dispatches=3, compile_s=2.0,
                           step_s=0.004)
    rec = timing.run_scheduler_timed(sched)
    assert rec["first_steps"] == batch
    assert rec["timed_steps"] == 2 * batch
    # step_s is the wall time of the timed window over its logical steps
    assert rec["step_s"] == pytest.approx(0.004)
    assert rec["step_s"] == pytest.approx(
        (clock.t - 2.0 - batch * 0.004) / (sched._step - batch))
    # the whole first dispatch (batch logical steps) comes off the compile
    assert rec["compile_s"] == pytest.approx(2.0)


def test_median_call_is_the_median_window(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(timing.time, "perf_counter", clock)
    costs = iter([0.0, 0.0] + [0.5] * 2 + [0.1] * 2 + [0.3] * 2)

    def fn():
        clock.t += next(costs)
        return jnp.zeros(())

    assert timing.median_call_s(fn, reps=3, inner=2) == pytest.approx(0.3)


def test_trace_reduction_busy_is_union_of_intervals(tmp_path):
    """``scripts/trace_mesh.device_summary`` on a trace recorded here: per
    line, busy time (the union of event intervals) never exceeds the window
    and the top events are the line's own."""
    import importlib.util
    import pathlib

    import jax

    path = pathlib.Path(__file__).resolve().parent.parent / "scripts" \
        / "trace_mesh.py"
    spec = importlib.util.spec_from_file_location("trace_mesh", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    f = jax.jit(lambda v: jnp.fft.fft(v * 2.0))
    x = jnp.ones((64, 1024), jnp.complex64)
    jax.block_until_ready(f(x))
    with jax.profiler.trace(str(tmp_path)):
        for _ in range(3):
            y = f(x)
        jax.block_until_ready(y)
    summary = mod.device_summary(tmp_path, plane_prefix="/host:CPU")
    lines = summary["/host:CPU"]
    assert lines
    for s in lines.values():
        assert s["events"] > 0
        assert 0.0 <= s["busy_ms"] <= s["window_ms"] + 1e-9
        assert len(s["top_ms"]) <= 10
