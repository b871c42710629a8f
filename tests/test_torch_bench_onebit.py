"""The floor report of bench_onebit.py: its reading of ptxas' register
report and of a kernel's SASS band loop, on small made-up listings."""

import pytest

from quantized_spectrum_cartography_tpu_torch import bench_onebit as bench

FWD = ("_ZN46_GLOBAL__N__9eb466fd_13_onebit_nll_cu_d5161ce617onebit_fwd_"
       "kernelILi2EEEvPKfS2_PKaPfiiff")
BWD = ("_ZN46_GLOBAL__N__9eb466fd_13_onebit_nll_cu_d5161ce617onebit_bwd_"
       "kernelILi10EEEvPKfS2_PKaS2_PfS5_iiff")

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

# one band of a loop: the tail test against -4 (taken to the direct
# branch), a reciprocal whose slow-path stub is skipped, a divergent-branch
# check that falls through, and the back edge
SASS = f"""
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


def test_ptxas_report_reads_registers_and_spills():
    assert bench.ptxas_report(PTXAS_LOG) == {"fwd<2>": (32, 0),
                                             "bwd<10>": (64, 16)}


def test_sass_loop_static_and_direct_counts(tmp_path, monkeypatch):
    """Static: the 17 instructions of 0x10..0x110 but the NOP (16).  Direct
    path: LDG, FSETP, BRA (taken), ISETP, BRA (taken past the stub), RCP,
    NOP (not counted), BRA.DIV, SHFL, back edge = 9; two MUFU in the loop."""
    listing = tmp_path / "fwd.sass"
    listing.write_text(SASS)
    tool = tmp_path / "cuobjdump"
    tool.write_text('#!/bin/sh\ncat "$2"\n')
    tool.chmod(0o755)
    monkeypatch.setattr(bench, "_tool", lambda name: str(tool))
    out = tmp_path / "r2.sass"
    assert bench.sass_loops(listing, str(out)) == {"fwd<2>": (16, 9, 2)}
    assert "MUFU.RCP" in out.read_text()


@pytest.mark.parametrize("text,kind", [(FWD, "fwd<2>"), (BWD, "bwd<10>")])
def test_short_names(text, kind):
    assert bench._short(text) == kind
