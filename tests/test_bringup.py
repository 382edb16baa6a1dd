"""What running on a GPU changed, checked on the CPU: each backend-dependent
lowering choice per backend name, the compile-cache helper, complex data
crossing the host/device boundary with no conversion layer, the import
surface without PyYAML, and the native libraries built from source."""

import ctypes
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gnuradio4_tpu as gr
from gnuradio4_tpu.blocks.testing import VectorSink, VectorSource


# -- selectors, per backend name -------------------------------------------------

@pytest.mark.parametrize("backend,ntaps,decim,host_taps,want", [
    ("cpu", 127, 1, True, "conv"),
    ("cpu", 63, 8, True, "conv"),
    ("cpu", 1024, 1, False, "conv"),
    ("gpu", 127, 1, True, "fft"),
    ("gpu", 63, 8, True, "matmul"),
    ("gpu", 63, 8, False, "fft"),
    ("gpu", 1024, 8, True, "fft"),
])
def test_fir_auto_method(backend, ntaps, decim, host_taps, want):
    from gnuradio4_tpu.ops.fir import auto_method
    assert auto_method(ntaps, decim=decim, host_taps=host_taps,
                       backend=backend) == want


def test_fir_auto_method_int8_rung_on_gpu(monkeypatch):
    from gnuradio4_tpu.ops.fir import auto_method
    monkeypatch.setenv("GR4_FIR_PRECISION", "int8")
    assert auto_method(63, decim=8, backend="gpu") == "matmul_int8"
    assert auto_method(63, decim=8, backend="cpu") == "conv"


@pytest.mark.parametrize("backend,t,decim,want", [
    ("cpu", 4096, 2, "interleave"),
    ("gpu", 4096, 2, "matmul"),
    ("gpu", 4095, 2, "interleave"),     # unframable block
])
def test_resample_auto_method(backend, t, decim, want):
    from gnuradio4_tpu.ops.resample import auto_resample_method
    assert auto_resample_method(t, decim, backend) == want


@pytest.mark.parametrize("backend,want", [("cpu", "segment"), ("gpu", "dense")])
def test_ldpc_layout(backend, want):
    from gnuradio4_tpu.ops.ldpc import ldpc_layout
    assert ldpc_layout(backend) == want


# biquad pole sets: complex-conjugate pair, distinct real poles, a repeated
# real pole, and a first-order section
POLES = {
    "conjugate": (1.0, -1.561018075800718, 0.641351538057563),
    "distinct_real": (1.0, -1.1, 0.28),
    "repeated_real": (1.0, -1.2, 0.36),
    "first_order": (1.0, -0.9, 0.0),
}


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
@pytest.mark.parametrize("poles", sorted(POLES))
def test_iir_auto_engine_per_pole_set(backend, poles):
    iir = gr.global_registry.create("IirFilter", b=(0.2, 0.1, 0.05),
                                    a=POLES[poles])
    parallel = backend == "gpu" and poles in ("conjugate", "distinct_real")
    assert iir._engine(backend) == ("parallel" if parallel else "scan")


def test_iir_engine_choices_have_no_kernel_option():
    from gnuradio4_tpu.blocks.filter import IirFilter
    assert IirFilter._settings_spec["engine"].choices == ("auto", "scan",
                                                          "parallel")


def test_ifft_and_svd_auto_take_xla(rng):
    x = (rng.standard_normal(2048) + 1j * rng.standard_normal(2048)
         ).astype(np.complex64)
    g = gr.Graph()
    src = g.add(VectorSource(x))
    ifft = g.emplace("IFFT", fft_size=1024)
    snk = g.add(VectorSink())
    g.connect_chain(src, ifft, snk)
    gr.Scheduler(g, block_len=1024).run_and_wait()
    np.testing.assert_allclose(snk.data(), np.fft.ifft(x.reshape(2, 1024)
                                                       ).reshape(-1), atol=1e-6)
    from gnuradio4_tpu.blocks.misc import SvdDenoiser
    assert "auto = xla" in SvdDenoiser._settings_spec["engine"].description


def test_bf16_einsum_cpu_emulates_bf16_rounding(rng):
    from gnuradio4_tpu.ops.fir import bf16_einsum
    a = rng.standard_normal((3, 16)).astype(np.float32)
    w = rng.standard_normal((16, 5)).astype(np.float32)
    got = np.asarray(bf16_einsum("nj,ji->ni", a, w, backend="cpu"))
    a16 = np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
    w16 = np.asarray(jnp.asarray(w).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_allclose(got, a16.astype(np.float64) @ w16, rtol=1e-5,
                               atol=1e-5)


def test_default_fir_rung_is_float32_exact(monkeypatch):
    from gnuradio4_tpu.ops import fir
    monkeypatch.delenv("GR4_FIR_PRECISION", raising=False)
    assert fir.default_rung() == "highest"


# -- compile cache -----------------------------------------------------------------

def test_compile_cache_follows_env_var(monkeypatch, tmp_path):
    from gnuradio4_tpu.utils.compile_cache import enable_compile_cache
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before   # nothing set


def test_compile_cache_defaults_to_repo_dir(monkeypatch):
    from gnuradio4_tpu.utils.compile_cache import REPO_CACHE, enable_compile_cache
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        assert enable_compile_cache() == str(REPO_CACHE)
        assert jax.config.jax_compilation_cache_dir == str(REPO_CACHE)
        assert REPO_CACHE.parent == REPO_CACHE.parents[0]
        assert (REPO_CACHE.parent / "gnuradio4_tpu").is_dir()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


# -- complex data across the host/device boundary ------------------------------------

@pytest.mark.parametrize("batch_steps", [1, 2])
def test_complex_feed_and_sink_round_trip(rng, batch_steps):
    x = (rng.standard_normal(4096) + 1j * rng.standard_normal(4096)
         ).astype(np.complex64)
    g = gr.Graph()
    src = g.add(VectorSource(x))
    mul = g.emplace("MultiplyConst", value=complex(0.5, -2.0))
    snk = g.add(VectorSink())
    g.connect_chain(src, mul, snk)
    gr.Scheduler(g, block_len=1024, batch_steps=batch_steps).run_and_wait()
    out = snk.data()
    assert out.dtype == np.complex64
    np.testing.assert_allclose(out, x * np.complex64(0.5 - 2j), rtol=1e-6)


def test_complex_state_checkpoint_round_trip(tmp_path, rng):
    from gnuradio4_tpu.core.checkpoint import load_checkpoint, save_checkpoint
    x = (rng.standard_normal(2048) + 1j * rng.standard_normal(2048)
         ).astype(np.complex64)

    def build():
        g = gr.Graph()
        src = g.add(VectorSource(x, name="src"))
        fir = g.emplace("FirFilter", name="fir", taps=(0.5, 0.25, 0.125))
        snk = g.add(VectorSink(name="snk"))
        g.connect_chain(src, fir, snk)
        return g
    s = gr.Scheduler(build(), block_len=512)
    s.run_and_wait(2)
    save_checkpoint(s, tmp_path / "ck")
    states = np.load(tmp_path / "ck" / "states.npz")
    assert any(np.iscomplexobj(states[k]) for k in states.files)
    s2 = load_checkpoint(tmp_path / "ck")
    assert s2._step == s._step


# -- import surface ------------------------------------------------------------------

def test_import_without_pyyaml():
    code = ("import sys; sys.modules['yaml'] = None\n"
            "import gnuradio4_tpu as gr\n"
            "g = gr.Graph()\n"
            "g.connect_chain(g.emplace('ConstantSource', n_samples=8),"
            " g.emplace('NullSink'))\n"
            "gr.Scheduler(g, block_len=8).run_and_wait()\n"
            "try:\n    gr.save_grc(g)\nexcept ImportError:\n    print('lazy')\n")
    r = subprocess.run([sys.executable, "-c", code],
                       env={**os.environ, "JAX_PLATFORMS": "cpu"},
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "lazy"


# -- native libraries from source ------------------------------------------------------

def test_native_library_builds_from_source_into_temp_dir(tmp_path):
    from gnuradio4_tpu.native import convert
    from gnuradio4_tpu.native.build import build_library
    src = convert._HERE / "convert.cpp"
    so = tmp_path / "sub" / "libconvert_test.so"
    assert build_library(src, so)
    lib = ctypes.CDLL(str(so))
    x = np.array([0, 16384, -32768], np.int16)
    y = np.empty(3, np.float32)
    lib.gr4_i16_to_f32.argtypes = [
        np.ctypeslib.ndpointer(np.int16, flags="C"),
        np.ctypeslib.ndpointer(np.float32, flags="C"),
        ctypes.c_size_t, ctypes.c_float]
    lib.gr4_i16_to_f32(x, y, 3, 1.0 / 32768)
    np.testing.assert_allclose(y, [0.0, 0.5, -1.0])
    assert not list(tmp_path.glob("sub/.*.tmp"))


def _k(path):
    fn = ctypes.CDLL(str(path)).gr4_k
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


def test_native_library_rebuilds_when_source_is_newer(tmp_path):
    from gnuradio4_tpu.native.build import build_library
    src = tmp_path / "k.cpp"
    src.write_text('extern "C" int gr4_k() { return 1; }\n')
    so = tmp_path / "libk.so"
    assert build_library(src, so)
    assert _k(so) == 1
    first = so.stat().st_mtime
    time.sleep(0.05)
    src.write_text('extern "C" int gr4_k() { return 2; }\n')
    os.utime(src, (first + 10, first + 10))
    assert build_library(src, so)
    assert so.stat().st_mtime > first
    so2 = tmp_path / "libk2.so"               # dlopen caches by path
    so.rename(so2)
    assert _k(so2) == 2


def test_no_native_binary_is_tracked():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(["git", "ls-files", "*.so"], cwd=root,
                       capture_output=True, text=True)
    if r.returncode != 0:
        pytest.skip("not a git checkout")
    assert r.stdout.strip() == ""


def test_old_env_prefix_is_refused(monkeypatch):
    """A switch set under the package's old ``GR4TPU_`` prefix is an error
    naming its new ``GR4_`` name, not a setting silently ignored."""
    import gnuradio4_tpu
    from gnuradio4_tpu.core.errors import GrError
    gnuradio4_tpu._refuse_renamed_env()
    monkeypatch.setenv("GR4TPU_FIR_PRECISION", "int8")
    with pytest.raises(GrError, match="GR4_FIR_PRECISION"):
        gnuradio4_tpu._refuse_renamed_env()
