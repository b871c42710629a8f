"""The kernel timer bench_kernels.py on the CPU: its naming of the 1-bit
and ordinal kernels' mangled names, its readers of ptxas' register report
and of the SASS loop that holds the numerics, on small made-up listings;
the inputs it times, built on the CPU; the bounds it holds each kernel
against; and the coded wrapper's table cache, which runs on any host."""

import pytest
import torch

from quantized_spectrum_cartography_tpu_torch import bench_kernels as bench
from quantized_spectrum_cartography_tpu_torch.ops.kernels import (
    quantized_nll as q,
)

FWD = ("_ZN46_GLOBAL__N__9eb466fd_13_onebit_nll_cu_d5161ce617onebit_fwd_"
       "kernelILi2EEEvPKfS2_PKaPfiiff")
BWD = ("_ZN46_GLOBAL__N__9eb466fd_13_onebit_nll_cu_d5161ce617onebit_bwd_"
       "kernelILi10EEEvPKfS2_PKaS2_PfS5_iiff")
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
    (FWD, "fwd<2>", False),
    (BWD, "bwd<10>", False),
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


PTXAS_LOG = f"""== onebit_nll.cu
ptxas info    : Compiling entry function '{FWD}' for 'sm_90a'
ptxas info    : Function properties for {FWD}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers, 8 bytes smem
ptxas info    : Compiling entry function '{BWD}' for 'sm_90a'
ptxas info    : Function properties for {BWD}
    16 bytes stack frame, 16 bytes spill stores, 20 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z19sum_partials_kernelPKfPfiii' for 'sm_90a'
ptxas info    : Used 12 registers
"""


def test_ptxas_report_reads_registers_and_spills():
    assert bench.ptxas_report(PTXAS_LOG) == {"fwd<2>": (32, 0),
                                             "bwd<10>": (64, 16)}


def test_ptxas_report_of_the_ordinal_kernels():
    log = "".join(
        f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
        f"    0 bytes stack frame, {spill} bytes spill stores, 0 bytes spill "
        f"loads\nptxas info    : Used {regs} registers\n"
        for name, regs, spill in ((CODED_BWD, 96, 0), (BOUNDS_FWD, 40, 8),
                                  ("_Z19sum_partials_kernelPKfPfiii", 12, 0)))
    assert bench.ptxas_report(log) == {"coded_bwd<10,1,0>": (96, 0),
                                       "fwd<2,1,0>": (40, 8)}


# one band of a 1-bit loop: the tail test against -4 (taken to the direct
# branch), a reciprocal whose slow-path stub is skipped, a divergent-branch
# check that falls through, and the back edge
ONEBIT_SASS = f"""
\tcode for sm_90a
\t\tFunction : {FWD}
\t.headerflags\t@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   LDG.E.U8.CONSTANT R2, desc[UR4][R8.64] ;
        /*0020*/                   FSETP.GTU.AND P0, PT, R4, -4, PT ;
        /*0030*/               @P0 BRA 0x80 ;
        /*0040*/                   MUFU.LG2 R5, R4 ;
        /*0050*/                   FADD R5, R5, R5 ;
        /*0060*/                   FMUL R5, R5, R5 ;
        /*0070*/                   BRA 0xf0 ;
        /*0080*/                   ISETP.GT.U32.AND P1, PT, R6, 0x1ffffff, PT ;
        /*0090*/               @P1 BRA 0xd0 ;
        /*00a0*/                   MOV R0, R6 ;
        /*00b0*/                   CALL.REL.NOINC 0x200 ;
        /*00c0*/                   BRA 0xe0 ;
        /*00d0*/                   MUFU.RCP R7, R6 ;
        /*00e0*/                   NOP ;
        /*00f0*/                   BRA.DIV UR4, 0x300 ;
        /*0100*/                   SHFL.BFLY PT, R5, R5, 0x10, 0x1f ;
        /*0110*/              @!P2 BRA 0x10 ;
        /*0120*/                   EXIT ;
"""


def _cuobjdump(tmp_path, monkeypatch, listing_text):
    """A listing file and a stand-in cuobjdump that prints it."""
    listing = tmp_path / "kernels.sass"
    listing.write_text(listing_text)
    tool = tmp_path / "cuobjdump"
    tool.write_text('#!/bin/sh\ncat "$2"\n')
    tool.chmod(0o755)
    monkeypatch.setattr(bench, "_tool", lambda name: str(tool))
    return listing


def test_sass_loop_static_and_direct_counts(tmp_path, monkeypatch):
    """Static: the 17 instructions of 0x10..0x110 but the NOP (16).  Direct
    path: LDG, FSETP, BRA (taken), ISETP, BRA (taken past the stub), RCP,
    NOP (not counted), BRA.DIV, SHFL, back edge = 9; two MUFU in the loop."""
    listing = _cuobjdump(tmp_path, monkeypatch, ONEBIT_SASS)
    out = tmp_path / "r2.sass"
    assert bench.sass_loops(listing, str(out)) == {"fwd<2>": (16, 9, 2)}
    assert "MUFU.RCP" in out.read_text()


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
    listing = _cuobjdump(tmp_path, monkeypatch, SASS)
    out = tmp_path / "r2.sass"
    assert bench.sass_loops(listing, str(out), keep=lambda s: "<2," in s) \
        == {"coded_fwd<2,0,1>": (6, 6, 2)}
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
    `loop_kind`, each of the dense and the list loop."""
    listing = _cuobjdump(tmp_path, monkeypatch, TILE_SASS)
    assert bench.sass_loops(listing, classify=classify) == {
        "fwd<2,1,0>": want}


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
    """The seven cases' inputs, built without a card at a small batch.  The
    ordinal cases: the bounds are the codes decoded through the table,
    entry for entry, so the coded pair (the control) sees what the bounds
    pair (the one measured) sees.  The 1-bit cases: the codes of the
    low-rank ordinal cases' maps.  The masked cases observe about a tenth
    of the entries.  The QR's Y is the `bench` maps' S times the probe."""
    from quantized_spectrum_cartography_tpu_torch.ops.lowrank import (
        default_probe)

    monkeypatch.setattr(bench, "B", 3)
    monkeypatch.setattr(bench, "SCORER_N", 5)
    got = bench._inputs(case, device="cpu")
    P = bench.GRID * bench.GRID
    if case == "qr":
        (Y,) = got
        S = bench._inputs("bench", device="cpu")[0]
        assert Y.shape == (3, 2, bench.GRID, bench.QR_COLS)
        assert torch.equal(Y, S.reshape(3, 2, bench.GRID, bench.GRID)
                           @ default_probe(bench.GRID, bench.QR_COLS,
                                           device="cpu"))
        return
    R = 10 if "r10" in case else 2
    if case in bench.ONEBIT:
        S, C, codes, g = got
        n_obs, unobserved = 3, 2
        twin = bench._inputs("lowrank" if R == 2 else "lowrank_r10_mask",
                             device="cpu")
        assert torch.equal(codes, twin[2]) and torch.equal(S, twin[0])
    else:
        S, C, codes, W, U, g, table, st = got
        n_obs, unobserved = (1 if case in ("gan", "scorer") else 3,
                             len(table) - 1)
        assert codes.shape == W.shape == U.shape
        assert W.dtype == U.dtype == torch.float32
        Wd, Ud = q._bounds_from_codes(codes, table)
        assert torch.equal(W, Wd) and torch.equal(U, Ud)
        assert len(st) == 4 and st[2] == (case not in ("gan", "scorer"))
    B = 5 if case == "scorer" else 1 if case == "gan" else 3
    assert S.shape == (B, R, P) and g.shape == (B,)
    assert C.shape == (n_obs, bench.K, R)
    assert codes.shape == (n_obs, bench.K, P) and codes.dtype == torch.int8
    observed = (codes.long() < unobserved).float().mean().item()
    if case in ("bench", "lowrank"):
        assert observed == 1.0
    else:
        assert abs(observed - bench.MASK_FRACTION) < 0.01


@pytest.mark.parametrize("name,ms,by", [
    ("onebit_nll_fwd", 0.0144, "bytes"),
    ("onebit_nll_bwd", 0.0223, "operations"),
    ("householder_qr", 0.0011, "bytes"),
])
def test_bound_at_the_bench_shape(name, ms, by):
    """The bound each kernel is held against at the bench shape (B=256,
    K=64, 51x51, R=2; the QR at [256, 2, 51, 18]): the 1-bit forward moves
    its bytes more slowly than it does its operations, the backward the
    other way round, and the QR is bound by its bytes."""
    def meta(*shape, dtype=torch.float32):
        return torch.empty(*shape, dtype=dtype, device="meta")

    P = bench.GRID * bench.GRID
    if name == "householder_qr":
        _, bounds = bench.qr_kernel(meta(256, 2, bench.GRID, bench.QR_COLS))
    else:
        _, bounds = bench.onebit_kernels(
            meta(256, 2, P), meta(256, bench.K, 2),
            meta(256, bench.K, P, dtype=torch.int8), meta(256))
    assert round(bounds[name]["bound_ms"], 4) == ms
    assert bounds[name]["bound_by"] == by
