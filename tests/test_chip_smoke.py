"""chip_smoke.py on the CPU: each phase at its tiny size against its float64
reference, the references themselves against direct definitions, and the
script's refusal to report a result without a GPU."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def test_phase_headline_tiny():
    rec = cs.phase_headline(cs.TINY, seed=1)
    assert rec["spec_rel_err"] <= cs.SPEC_REL_TOL
    assert rec["audio_fir_snr_db"] >= cs.FIR_SNR_MIN_DB
    assert set(rec["rung_snr_db"]) == {"default", "high", "highest"}
    assert rec["fir127_demod_xla_ms"] > 0


def test_phase_scheduler_tiny_delivers_every_tag():
    rec = cs.phase_scheduler(cs.TINY, seed=2)
    n = cs.TINY.sched_block * cs.TINY.sched_batch * cs.TINY.sched_supersteps
    assert rec["tags"] == len(range(1000, n, cs.TINY.tag_period))
    assert rec["demod_max_err_rad"] <= cs.PHASE_TOL_RAD


def test_phase_ldpc_tiny():
    rec = cs.phase_ldpc(cs.TINY, seed=3)
    assert rec["frames"] == cs.TINY.ldpc_block * cs.TINY.ldpc_steps // 256


def test_phase_callback_tiny():
    rec = cs.phase_callback(seed=4)
    assert rec["channel_bit_errors"] > 0


def test_phase_multi_tiny_on_virtual_devices():
    rec = cs.phase_multi(cs.TINY, seed=5)
    assert rec["sp4"]["max_abs_diff"] < cs.MESH_TOL
    assert rec["sp2xchan2"]["tags"] == rec["sp4"]["tags"] > 0


def test_check_compile_mode_reports_memory_analysis():
    rec = cs.phase_ldpc(cs.TINY, seed=6, check_compile=True)
    assert "temp_size_in_bytes" in rec["memory_analysis"]


def test_ref_pfb_matches_its_definition(rng):
    m, p = 8, 3
    x = rng.standard_normal(m * 20) + 1j * rng.standard_normal(m * 20)
    h = rng.standard_normal(m * p)
    got = cs.ref_pfb(x, h, m)
    # direct: v[n, q] = Σ_j h[j·m + q]·x[(n − j)·m + q]
    v = np.zeros((20, m), complex)
    for n in range(20):
        for q in range(m):
            for j in range(p):
                if n - j >= 0:
                    v[n, q] += h[j * m + q] * x[(n - j) * m + q]
    want = np.array([[np.sum(v[n] * np.exp(-2j * np.pi * np.arange(m) * k / m))
                      for n in range(20)] for k in range(m)])
    np.testing.assert_allclose(got, want, atol=1e-9)


def test_ref_min_sum_matches_segment_decoder(rng):
    import jax.numpy as jnp
    from gnuradio4_tpu.ops.ldpc import LdpcGraph, make_ldpc, min_sum_decode_segment
    H, _ = make_ldpc(64, 32, wc=3, seed=1)
    llr = (2.0 + 2.5 * rng.standard_normal((16, 64))).astype(np.float32)
    hard, ok = cs.ref_min_sum(H, llr, 10, 0.8125)
    h2, ok2 = min_sum_decode_segment(LdpcGraph(H), jnp.asarray(llr), 10)
    np.testing.assert_array_equal(hard, np.asarray(h2))
    np.testing.assert_array_equal(ok, np.asarray(ok2))


def test_ref_hann_is_the_fft_blocks_window():
    from gnuradio4_tpu.ops.windows import make_window
    np.testing.assert_allclose(cs.ref_hann(4096),
                               make_window("Hann", 4096, dtype=np.float64),
                               atol=1e-12)


def _run(args, cwd):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _ok_lines(stdout):
    return [ln for ln in stdout.splitlines() if ln.startswith('{"ok"')]


def test_no_gpu_exits_nonzero_without_ok_line():
    r = _run([str(ROOT / "chip_smoke.py")], ROOT)
    assert r.returncode != 0
    assert not _ok_lines(r.stdout)
    assert "not a GPU" in r.stderr


def test_tiny_rehearsal_never_prints_ok_line():
    r = _run([str(ROOT / "chip_smoke.py"), "--tiny", "--multi"], ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert not _ok_lines(r.stdout)
    assert r.stdout.count("phase ") == 1


def test_alone_in_a_directory_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run([str(tmp_path / "chip_smoke.py"), "--tiny"], tmp_path)
    assert r.returncode != 0
    assert not _ok_lines(r.stdout)


@pytest.mark.parametrize("make", ["fm_signal", "channelizer_input"])
def test_inputs_are_made_from_the_seed(make):
    def gen(seed):
        if make == "fm_signal":
            return cs.fm_signal(np.random.default_rng(seed), 4096)
        return cs._channelizer_input(cs.TINY, seed, 1)[0]
    np.testing.assert_array_equal(gen(7), gen(7))
    assert not np.array_equal(gen(7), gen(8))
