"""The host side of ``faldoi_tpu_torch/cli/patch_variants.py`` (K12's and
K13's variants on the card), on the CPU: the ptxas report's parse, the
warps an SM holds, the loop structure read off a SASS listing and the
instruction counts built from it, and the fill's inputs.  The kernels
themselves run only on the card (``tests/test_torch_card.py -k
former_form``)."""

import math

import numpy as np
import pytest
import torch

from faldoi_tpu_torch.cli import patch_variants as pv

torch.set_num_threads(1)

REPORT = [
    "ptxas info    : Compiling entry function '_Z6kernAv' for 'sm_90a'",
    "ptxas info    : Function properties for _Z6kernAv",
    "    16 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads",
    "ptxas info    : Used 32 registers, used 1 barriers, 376 bytes cmem[0]",
    "ptxas info    : Compiling entry function '_Z6kernBv' for 'sm_90a'",
    "ptxas info    : Function properties for _Z6kernBv",
    "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
    "ptxas info    : Used 200 registers, used 0 barriers, 376 bytes cmem[0]",
]


def test_ptxas_report_parse():
    got = pv.ptxas_kernels(REPORT)
    assert got == {
        "_Z6kernAv": dict(stack=16, spill_stores=12, spill_loads=8,
                          registers=32),
        "_Z6kernBv": dict(stack=0, spill_stores=0, spill_loads=0,
                          registers=200),
    }


@pytest.mark.parametrize("regs,threads,smem,want", [
    (32, 256, 10944, 64),        # K13's library form: one wave of 8192 warps
    (64, 256, 5824, 32),         # K12's two canvases a block
    (200, 256, 0, 8),            # a canvas a warp, four cells a lane
    (128, 256, 0, 16),
    (74, 256, 10944, 24),
    (32, 256, 120000, 8),        # shared memory bounds it
])
def test_warps_an_sm(regs, threads, smem, want):
    assert pv.warps_an_sm(regs, threads, smem) == want


def _listing(body):
    """A SASS-like listing: (address, instruction) every 0x10."""
    return [(0x10 * k, ins) for k, ins in enumerate(body)]


def test_loops_and_counts():
    # a copy loop with a global load (0x10-0x30), a relaxation loop
    # without one (0x40-0x90) nested in nothing, and a straight tail
    body = ["S2R R0, SR_TID.X", "@P2 LDG.E R1, desc[UR4][R2.64]", "STS [R3], R1",
            "BRA 0x10", "LDS R4, [R3]", "FADD R4, R4, R4", "STS [R3], R4",
            "WARPSYNC 0xffffffff", "ISETP.NE.AND P0, PT, R5, RZ, PT",
            "@P0 BRA 0x40", "EXIT"]
    insts = _listing(body)
    spans = pv.loop_spans(insts)
    assert [(s, e, n, g) for s, e, n, g in spans] == [
        (0x40, 0x90, 6, False), (0x10, 0x30, 3, True)]
    step, per_warp = pv.k13_counts(insts, [11, 6, 3, 2, 1], exact=False,
                                   niter=3, p=11)
    assert step == 6 / 2                       # two colours a relaxation loop
    assert per_warp == len(body) + 2 * 6 + (math.ceil(121 / 32) - 1) * 3
    # K12: the PD loop is the largest loop inside another (the warp loop)
    body12 = ["MOV R0, RZ", "LDS R1, [R2]", "FADD R1, R1, R1", "BAR.SYNC R3, R4",
              "@P0 BRA 0x10", "IADD3 R0, R0, 1, RZ", "@P1 BRA 0x10", "EXIT"]
    pd, per_warp12 = pv.k12_counts(_listing(body12), steps=4)
    assert pd == 4 and per_warp12 == len(body12) + 3 * 4


def test_fill_planes_shapes():
    rng = np.random.default_rng(0)
    (u, v), ph, pw = pv.fill_planes(torch.device("cpu"), rng, 9, 11)
    assert u.shape == v.shape == (9, 11, 11)
    assert ph.tolist()[:4] == [6, 6, 6, 6] and pw.tolist()[:4] == [6, 6, 6, 6]
    assert int(torch.isfinite(u[0]).sum()) == 1      # centre only
    assert bool((ph >= 1).all() and (ph <= 11).all())
