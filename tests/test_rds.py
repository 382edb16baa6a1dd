"""RDS coding layer + full 57 kHz receiver chain
(blocks/rds.py; IEC 62106 group structure — beyond-reference model family)."""

import numpy as np
import pytest

import gnuradio4_tpu as gr
from gnuradio4_tpu.blocks import rds
from gnuradio4_tpu.ops.filter_design import design_fir


class TestRdsCoding:
    def test_syndrome_of_valid_block_equals_offset(self):
        for data in (0x0000, 0x1234, 0xFFFF, 0xBEEF, 0x52A1):
            for off in (rds.OFFSET_A, rds.OFFSET_B, rds.OFFSET_C,
                        rds.OFFSET_Cp, rds.OFFSET_D):
                blk = rds.encode_block(data, off)
                assert rds.block_syndrome(blk) == off

    def test_single_bit_error_breaks_syndrome(self):
        blk = rds.encode_block(0x1234, rds.OFFSET_A)
        for i in range(26):
            assert rds.block_syndrome(blk ^ (1 << i)) != rds.OFFSET_A

    def test_bit_level_loopback(self):
        groups = (rds.make_0a_groups(0x1234, 5, "GR4-GPU!")
                  + rds.make_2a_groups(0x1234, 5, "HELLO"))
        bits = np.concatenate([np.asarray(g, np.uint8) for g in groups])
        diff = rds.differential_encode(bits)
        data = np.concatenate([[diff[0]], diff[1:] ^ diff[:-1]])
        got = rds.decode_bits(data)
        assert len(got) == len(groups)
        assert all(g[0] == 0x1234 for g in got)

    def test_block_sync_recovers_after_garbage(self):
        groups = rds.make_0a_groups(0x4444, 1, "ABCDEFGH")
        bits = np.concatenate([np.asarray(g, np.uint8) for g in groups])
        rng = np.random.default_rng(0)
        noisy = np.concatenate([rng.integers(0, 2, 57).astype(np.uint8),
                                bits, rng.integers(0, 2, 31).astype(np.uint8)])
        got = rds.decode_bits(noisy)
        assert len(got) >= len(groups) - 1     # garbage may fake ≤0 groups
        assert any(g[0] == 0x4444 for g in got)

    def test_biphase_and_differential(self):
        bits = np.array([1, 0, 1, 1, 0], np.uint8)
        d = rds.differential_encode(bits)
        np.testing.assert_array_equal(d, [1, 1, 0, 1, 1])
        h = rds.biphase_halves(np.array([1, 0], np.uint8))
        np.testing.assert_array_equal(h, [1.0, -1.0, -1.0, 1.0])


def _run_chain(mpx, fs):
    taps = design_fir("lowpass", 241, sample_rate=fs, f_low=2400.0)
    g = gr.Graph()
    src = g.emplace("VectorSource", data=mpx)
    cvt = g.emplace("Convert", to="complex64")
    xlat = g.emplace("FreqXlatingFir", center_freq=57000.0, decim=24,
                     taps=tuple(taps.tolist()))
    costas = g.emplace("CostasLoop", order=2, loop_bw=0.01)
    mm = g.emplace("MMSymbolSync", sps=4, gain=0.05)
    dec = g.emplace("RdsDecoder")
    g.connect_chain(src, cvt, xlat, costas, mm, dec)
    gr.Scheduler(g, block_len=9600, sample_rate=fs).run_and_wait()
    return dec


class TestRdsReceiverChain:
    FS = 228000.0
    PI, PTY, PS, RT = 0x52A1, 9, "GR4-GPU!", "HELLO FROM THE GPU SIDE"

    def _groups(self):
        # PS groups repeated for loop convergence; RT twice so the tail
        # repetition covers symbols still in flight at EOS
        return (rds.make_0a_groups(self.PI, self.PTY, self.PS) * 3
                + rds.make_2a_groups(self.PI, self.PTY, self.RT) * 2)

    def test_full_chain_phase_offset_and_noise(self):
        rng = np.random.default_rng(7)
        mpx = rds.modulate_mpx(self._groups(), fs=self.FS, phase=0.4)
        mpx = mpx + 0.05 * rng.standard_normal(len(mpx)).astype(np.float32)
        dec = _run_chain(mpx, self.FS)
        assert dec.pi == self.PI and dec.pty == self.PTY
        assert dec.ps == self.PS
        assert dec.radiotext == self.RT
        assert len(dec.groups) >= 14

    def test_polarity_inversion_is_transparent(self):
        # 180-degree Costas lock / inverted wiring: differential coding
        # makes the bitstream polarity-invariant
        mpx = rds.modulate_mpx(self._groups(), fs=self.FS, phase=0.0,
                               amplitude=-1.0)
        dec = _run_chain(mpx, self.FS)
        assert dec.pi == self.PI and dec.ps == self.PS


class TestRdsSourceExample:
    def test_rds_source_seamless_cyclic(self):
        """RdsSource loops differentially-seamlessly: every group decodes
        including PS segment 0 (a naive wrap corrupts the seam group on
        every cycle)."""
        from pathlib import Path
        from gnuradio4_tpu.core.yaml_io import run_grc
        src = Path("/root/repo/examples/rds_receiver.yaml").read_text()
        sched = run_grc(src, n_steps=60)
        dec = [b for b in sched.graph.blocks if b.name == "rds"][0]
        dec._process()
        assert dec.pi == 0x52A1
        assert dec.ps == "GR4-GPU!"
        assert dec.radiotext == "HELLO FROM THE GPU SIDE"
        assert len(dec.groups) > 100


class TestVersionBGroups:
    def test_0b_ps_characters_from_block4(self):
        # 0B groups repeat the PI in block 3; PS chars are in block 4
        pi, pty, ps = 0x52A1, 9, "GR4-GPU!"
        groups = []
        for addr in range(4):
            b2 = (0x0 << 12) | (1 << 11) | ((pty & 0x1F) << 5) | addr
            b4 = (ord(ps[2 * addr]) << 8) | ord(ps[2 * addr + 1])
            groups.append(rds.encode_group(pi, b2, pi, b4, version_b=True))
        # twice: differential decoding inherently loses the very first bit
        bits = np.concatenate([np.asarray(g, np.uint8) for g in groups * 2])
        diff = rds.differential_encode(bits)
        halves = rds.biphase_halves(diff)
        dec = rds.RdsDecoder()
        dec._halves = [halves.astype(np.float64)]
        dec._process()
        assert dec.ps == ps
        assert dec.pi == pi
