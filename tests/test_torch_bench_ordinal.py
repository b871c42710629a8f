"""The floor report of bench_ordinal.py: its naming of the ordinal kernels'
mangled names, and the readers it shares with bench_onebit.py (ptxas'
register report, the SASS loop that holds the numerics) on small made-up
listings; the inputs it times, built on the CPU; and the coded wrapper's
table cache, which runs on any host."""

import pytest
import torch

from quantized_spectrum_cartography_tpu_torch import bench_onebit
from quantized_spectrum_cartography_tpu_torch import bench_ordinal as bench
from quantized_spectrum_cartography_tpu_torch.ops.kernels import (
    quantized_nll as q,
)

CODED_BWD = ("_ZN46_GLOBAL__N__0c3f1a2b_21quantized_nll_coded_cu_7a1e53d121"
             "qnll_coded_bwd_kernelILi10ELb1ELb0EEEvN12_GLOBAL__N_111Coded"
             "ParamsE")
CODED_FWD = ("_ZN46_GLOBAL__N__0c3f1a2b_21quantized_nll_coded_cu_7a1e53d121"
             "qnll_coded_fwd_kernelILi2ELb0ELb1EEEvN12_GLOBAL__N_111Coded"
             "ParamsE")
BOUNDS_FWD = ("_ZN46_GLOBAL__N__5d2e9c11_16quantized_nll_cu_0d6b2c7f15qnll_"
              "fwd_kernelILi2ELb1ELb0EEEv10QnllParams")
# the build before the coded kernels had a file of their own: the coded
# flag is the first bool
OLD_CODED_FWD = ("_ZN46_GLOBAL__N__5d2e9c11_16quantized_nll_cu_0d6b2c7f15qnll_"
                 "fwd_kernelILi2ELb1ELb1ELb0EEEv10QnllParams")
OLD_BOUNDS_BWD = ("_ZN46_GLOBAL__N__5d2e9c11_16quantized_nll_cu_0d6b2c7f15qnll"
                  "_bwd_kernelILi16ELb0ELb0ELb1EEEv10QnllParams")
# the tile kernels (csrc/ordinal_tile.cuh): one template per direction, the
# observation source first, in its file's anonymous namespace (as nvcc
# names it, and as a host compiler does)
TILE_BOUNDS_FWD = ("_ZN3qsc15qnll_fwd_kernelIN49_GLOBAL__N__083c81a7_16_quan"
                   "tized_nll_cu_74f842d56BoundsELi2ELb1ELb0EEEvNS_6ParamsIT"
                   "_EE")
TILE_BOUNDS_BWD = ("_ZN3qsc15qnll_bwd_kernelIN12_GLOBAL__N_16BoundsELi16ELb0"
                   "ELb1EEEvNS_6ParamsIT_EE")
TILE_CODED_BWD = ("_ZN3qsc15qnll_bwd_kernelIN46_GLOBAL__N__0c3f1a2b_21quant"
                  "ized_nll_coded_cu_7a1e53d15CodesELi10ELb1ELb0EEEvNS_6Par"
                  "amsIT_EE")
TILE_CODED_FWD = ("_ZN3qsc15qnll_fwd_kernelIN12_GLOBAL__N_15CodesELi2ELb0EL"
                  "b1EEEvNS_6ParamsIT_EE")


@pytest.mark.parametrize("mangled,short,coded", [
    (CODED_BWD, "coded_bwd<10,1,0>", True),
    (CODED_FWD, "coded_fwd<2,0,1>", True),
    (BOUNDS_FWD, "fwd<2,1,0>", False),
    (OLD_CODED_FWD, "fwd<2,1,1,0>", True),
    (OLD_BOUNDS_BWD, "bwd<16,0,0,1>", False),
    (TILE_BOUNDS_FWD, "fwd<2,1,0>", False),
    (TILE_BOUNDS_BWD, "bwd<16,0,1>", False),
    (TILE_CODED_BWD, "coded_bwd<10,1,0>", True),
    (TILE_CODED_FWD, "coded_fwd<2,0,1>", True),
])
def test_short_names(mangled, short, coded):
    assert bench.short_name(mangled) == short
    assert bench._coded(short) is coded


def test_ptxas_report_of_the_ordinal_kernels():
    log = "".join(
        f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
        f"    0 bytes stack frame, {spill} bytes spill stores, 0 bytes spill "
        f"loads\nptxas info    : Used {regs} registers\n"
        for name, regs, spill in ((CODED_BWD, 96, 0), (BOUNDS_FWD, 40, 8),
                                  ("_Z19sum_partials_kernelPKfPfiii", 12, 0)))
    assert bench_onebit.ptxas_report(log, match="qnll_",
                                     short=bench.short_name) == {
        "coded_bwd<10,1,0>": (96, 0), "fwd<2,1,0>": (40, 8)}


# a kernel with a loop that holds no MUFU (the compaction) and a larger one
# that runs the numerics; only the latter is the loop the floor reads
SASS = f"""
\t\tFunction : {CODED_FWD}
        /*0000*/                   LDG.E.U8 R2, desc[UR4][R8.64] ;
        /*0010*/                   VOTE.ANY R3, PT, P0 ;
        /*0020*/                   POPC R4, R3 ;
        /*0030*/                   IADD3 R5, R5, 0x1, RZ ;
        /*0040*/                   ISETP.NE.AND P1, PT, R5, 0x10, PT ;
        /*0050*/                   STS [R6], R4 ;
        /*0060*/                   IADD3 R6, R6, 0x4, RZ ;
        /*0070*/                   IADD3 R7, R7, 0x4, RZ ;
        /*0080*/               @P1 BRA 0x0 ;
        /*0090*/                   LDS R2, [R9] ;
        /*00a0*/                   FFMA R3, R2, R4, RZ ;
        /*00b0*/                   MUFU.EX2 R5, R3 ;
        /*00c0*/                   MUFU.LG2 R6, R5 ;
        /*00d0*/                   ISETP.GE.AND P2, PT, R9, R10, PT ;
        /*00e0*/              @!P2 BRA 0x90 ;
        /*00f0*/                   EXIT ;
"""


def test_sass_loop_is_the_one_with_the_numerics(tmp_path, monkeypatch):
    """The loop 0x90..0xe0 (6 instructions, 2 MUFU) is read, not the larger
    compaction loop 0x0..0x80 (9 instructions, no MUFU)."""
    listing = tmp_path / "coded.sass"
    listing.write_text(SASS)
    tool = tmp_path / "cuobjdump"
    tool.write_text('#!/bin/sh\ncat "$2"\n')
    tool.chmod(0o755)
    monkeypatch.setattr(bench_onebit, "_tool", lambda name: str(tool))
    out = tmp_path / "r2.sass"
    assert bench_onebit.sass_loops(
        listing, str(out), match="qnll_", short=bench.short_name,
        keep=lambda s: "<2," in s) == {"coded_fwd<2,0,1>": (6, 6, 2)}
    assert "MUFU.LG2" in out.read_text()


# a tile kernel's two numerics loops: the dense one (0x00..0x40) and the
# one over the list of observed entries, which reads it (0x60..0xb0)
TILE_SASS = f"""
\t\tFunction : {TILE_BOUNDS_FWD}
        /*0000*/                   LDG.E.CONSTANT R2, desc[UR4][R8.64] ;
        /*0010*/                   FFMA R3, R2, R4, RZ ;
        /*0020*/                   MUFU.LG2 R6, R3 ;
        /*0030*/                   ISETP.GE.AND P2, PT, R9, R10, PT ;
        /*0040*/              @!P2 BRA 0x0 ;
        /*0050*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0060*/                   LDS.U16 R5, [R7+0x406] ;
        /*0070*/                   LDG.E.CONSTANT R2, desc[UR4][R8.64] ;
        /*0080*/                   MUFU.EX2 R6, R3 ;
        /*0090*/                   MUFU.LG2 R6, R6 ;
        /*00a0*/                   ISETP.GE.AND P2, PT, R9, R10, PT ;
        /*00b0*/              @!P2 BRA 0x60 ;
        /*00c0*/                   EXIT ;
"""


@pytest.mark.parametrize("classify,want", [
    (None, (6, 6, 2)),
    (bench.loop_kind, {"dense": (5, 5, 1), "list": (6, 6, 2)}),
])
def test_sass_loops_of_a_tile_kernel(tmp_path, monkeypatch, classify, want):
    """Without `classify` the larger numerics loop is read; with
    bench_ordinal's, each of the dense and the list loop."""
    listing = tmp_path / "tile.sass"
    listing.write_text(TILE_SASS)
    tool = tmp_path / "cuobjdump"
    tool.write_text('#!/bin/sh\ncat "$2"\n')
    tool.chmod(0o755)
    monkeypatch.setattr(bench_onebit, "_tool", lambda name: str(tool))
    assert bench_onebit.sass_loops(
        listing, match="qnll_", short=bench.short_name,
        classify=classify) == {"fwd<2,1,0>": want}


def test_table_is_built_once_per_boundary_tuple():
    """The coded wrapper's boundary table: one ctypes array per tuple,
    reused by every later call, and no more than 31 bins."""
    table = (0.0, 0.5, 1.0)
    arr, n = q._table(table)
    assert n == 2 and list(arr) == [0.0, 0.5, 1.0]
    assert q._table(table)[0] is arr
    with pytest.raises(ValueError, match="bins"):
        q._table(tuple(range(34)))


@pytest.mark.parametrize("case", bench.CASES)
def test_bench_inputs_on_the_cpu(monkeypatch, case):
    """The four cases' inputs, built without a card at a small batch: the
    bounds are the codes decoded through the table, entry for entry, so the
    coded pair (the control) sees what the bounds pair (the one measured)
    sees, and the masked cases observe about a tenth of the entries."""
    monkeypatch.setattr(bench, "LOWRANK_B", 3)
    monkeypatch.setattr(bench, "SCORER_N", 5)
    S, C, codes, (W, U), g, table, st = bench._inputs(case, device="cpu")
    B = 5 if case == "scorer" else 1 if case == "gan" else 3
    R = 10 if case == "lowrank_r10_mask" else 2
    P = bench.GRID * bench.GRID
    n_obs = 1 if case in ("gan", "scorer") else B
    assert S.shape == (B, R, P) and g.shape == (B,)
    assert C.shape == (n_obs, bench.K, R)
    assert codes.shape == W.shape == U.shape == (n_obs, bench.K, P)
    assert codes.dtype == torch.int8 and W.dtype == U.dtype == torch.float32
    Wd, Ud = q._bounds_from_codes(codes, table)
    assert torch.equal(W, Wd) and torch.equal(U, Ud)
    observed = (codes.long() < len(table) - 1).float().mean().item()
    if case == "lowrank":
        assert observed == 1.0
    else:
        assert abs(observed - bench.MASK_FRACTION) < 0.01
    assert len(st) == 4 and st[2] == (case not in ("gan", "scorer"))
