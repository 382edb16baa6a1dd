"""Adaptive equalizers (blocks/equalizer.py): block-CMA and block-LMS-DD —
beyond-reference additions matching classic GNU Radio capability."""

import numpy as np
import pytest

import gnuradio4_tpu as gr


def _qpsk(n, seed=0):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 4, n)
    return bits, np.exp(1j * (np.pi / 4 + np.pi / 2 * bits)
                        ).astype(np.complex64)


CHANNEL = np.array([1.0, 0.35 * np.exp(1j * 0.9),
                    0.18 * np.exp(-1j * 1.7)], np.complex64)


def test_cma_opens_the_eye():
    _, syms = _qpsk(32768)
    rx = np.convolve(syms, CHANNEL)[:len(syms)].astype(np.complex64)
    assert np.std(np.abs(rx)) > 0.2                    # ISI closes the eye
    g = gr.Graph()
    src = g.emplace("StreamSource", dtype="complex64")
    cma = g.emplace("CmaEqualizer", num_taps=11, gain=0.01)
    snk = g.emplace("VectorSink")
    g.connect_chain(src, cma, snk)
    src.push(rx)
    src.close()
    gr.Scheduler(g, block_len=8192, sample_rate=1e6).run_and_wait()
    tail = np.asarray(snk.data())[-8192:]
    assert np.std(np.abs(tail)) < 0.08                 # constant modulus again
    assert abs(np.abs(tail).mean() - 1.0) < 0.1


def test_cma_costas_lmsdd_chain_100pct():
    """Equalized receiver: multipath + CFO + noise -> 100% symbols."""
    _, syms = _qpsk(32768)
    rng = np.random.default_rng(0)
    n = len(syms)
    rx = np.convolve(syms, CHANNEL)[:n]
    rx = rx * np.exp(1j * (0.002 * np.arange(n) + 0.5))
    rx = (rx + (rng.standard_normal(n) + 1j * rng.standard_normal(n))
          * np.sqrt(0.005)).astype(np.complex64)
    g = gr.Graph()
    src = g.emplace("StreamSource", dtype="complex64")
    cma = g.emplace("CmaEqualizer", num_taps=11, gain=0.01)
    cst = g.emplace("CostasLoop", order=4, loop_bw=0.05)
    lms = g.emplace("LmsDDEqualizer", num_taps=11, gain=0.02)
    snk = g.emplace("VectorSink")
    g.connect_chain(src, cma, cst, lms, snk)
    src.push(rx)
    src.close()
    gr.Scheduler(g, block_len=8192, sample_rate=1e6).run_and_wait()
    y = np.asarray(snk.data())
    lo = len(y) - 4096
    w = y[lo:lo + 2048]
    best = max((abs(np.vdot(syms[l:l + 2048], w)), l)
               for l in range(lo - 24, lo + 24))
    ref = syms[best[1]:best[1] + 2048]
    rot = np.vdot(ref, w)
    rot /= abs(rot)
    dec = np.round(np.angle(w * np.conj(rot) * np.exp(-1j * np.pi / 4))
                   / (np.pi / 2)) % 4
    sent = np.round(np.angle(ref * np.exp(-1j * np.pi / 4)) / (np.pi / 2)) % 4
    assert np.mean(dec == sent) > 0.999


def test_divergence_guard_and_validation():
    _, syms = _qpsk(16384, seed=1)
    rx = np.convolve(syms, [1.0, 0.5])[:len(syms)].astype(np.complex64)
    g = gr.Graph()
    src = g.emplace("StreamSource", dtype="complex64")
    cma = g.emplace("CmaEqualizer", num_taps=11, gain=0.9)  # absurd step
    snk = g.emplace("VectorSink")
    g.connect_chain(src, cma, snk)
    src.push(rx)
    src.close()
    sch = gr.Scheduler(g, block_len=4096, sample_rate=1e6)
    sch.run_and_wait()
    assert np.all(np.isfinite(np.asarray(snk.data())))
    taps = np.asarray(sch._states[cma.unique_name]["taps"])   # complex D2H
    assert np.linalg.norm(taps) <= 4.001                 # guard held
    with pytest.raises(Exception, match="constellation"):
        gr.Graph().emplace("LmsDDEqualizer", constellation="qam4096")


def test_identity_channel_passthrough():
    """No ISI -> equalizer must not damage a clean stream."""
    _, syms = _qpsk(16384, seed=2)
    g = gr.Graph()
    src = g.emplace("StreamSource", dtype="complex64")
    lms = g.emplace("LmsDDEqualizer", num_taps=11, gain=0.005)
    snk = g.emplace("VectorSink")
    g.connect_chain(src, lms, snk)
    src.push(syms)
    src.close()
    gr.Scheduler(g, block_len=4096, sample_rate=1e6).run_and_wait()
    tail = np.asarray(snk.data())[-4096:]
    ref = syms[-4096 - 5: -5]  # center-tap delay
    best = max(abs(np.vdot(syms[len(syms) - 4096 - d: len(syms) - d], tail))
               for d in range(0, 11))
    rho = best / np.linalg.norm(tail) / np.sqrt(4096)
    assert rho > 0.99
