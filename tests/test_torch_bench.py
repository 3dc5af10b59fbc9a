"""The port's kernel-design tools without a card: the parsers of
``bench/kernel_sass.py`` on sample ptxas and cuobjdump output, the bounds
of ``bench/common.py``, and the source edits of ``bench/kron_variants.py``
against the shipped sources.
"""

import os

import pytest
import torch

from whvi_tpu_torch.bench import common, kernel_sass, kron_variants
from whvi_tpu_torch.ops.fwht_cuda import CSRC

FUSED_12 = "_ZN4whvi17whvi_fused_kernelILi12ELb1ELb0EEEvPKfS2_S2_S2_PfS3_S3_lNS_8GeometryE"
FWHT_14 = "_ZN4whvi11fwht_kernelILi14EEEvPKfPfl"
EMIT_COPY = "_ZN4kron16emit_copy_kernelEPKcPclll"
CUR_14 = "_ZN4kron15kron_cur_kernelILi14EEEvPKfS2_S2_S2_Pfl"
FULL = "_ZN4kron16kron_full_kernelILi4EEEvPKfS2_S2_S2_Pfli"

PTXAS = f"""\
ptxas info    : Compiling entry function '{FUSED_12}' for 'sm_90a'
ptxas info    : Function properties for {FUSED_12}
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 108 registers, used 1 barriers, 8 bytes cumulative stack size
ptxas info    : Compiling entry function '{FWHT_14}' for 'sm_90a'
ptxas info    : Function properties for {FWHT_14}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 56 registers, used 1 barriers
"""

SASS = f"""\
        Function : {FUSED_12}
        /*0080*/                   LDG.E.128 R4, desc[UR4][R2.64] ;
        /*0090*/                   LDG.E.128.CONSTANT R8, desc[UR4][R6.64] ;
        /*00a0*/                   STS [R3], R4 ;
        /*00b0*/                   STS.128 [R3+0x10], R8 ;
        /*00c0*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*00d0*/                   LDS R5, [R7] ;
        /*00e0*/                   LDSM.16.M88.4 R12, [R9] ;
        /*00f0*/                   STG.E.128 desc[UR4][R10.64], R4 ;
        Function : {FWHT_14}
        /*0010*/                   STL [R1], R2 ;
        /*0020*/                   LDL R2, [R1] ;
        /*0030*/                   BAR.SYNC 0x0 ;
        Function : {EMIT_COPY}
        /*03a0*/                   SYNCS.EXCH.64 URZ, [UR8+0x18000], UR4 ;
        /*0450*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*08a0*/                   SYNCS.PHASECHK.TRANS64.TRYWAIT P3, [R2+URZ+0x18000], R9 ;
        /*1120*/              @!P0 SYNCS.ARRIVE.TRANS64.A1T0 RZ, [R2+URZ+0x18020], RZ ;
        /*1910*/                   SYNCS.ARRIVE.TRANS64 RZ, [R6+URZ+0x18000], R5 ;
        /*1a10*/                   UBLKCP.S.G [UR18], [UR16], UR4 ;
        /*1a20*/                   LDS.128 R4, [R3] ;
        /*1a30*/                   STG.E.EF.128 desc[UR4][R10.64], R4 ;
        /*1a40*/                   LDG.E.EF.128 R4, desc[UR4][R2.64] ;
        /*12f0*/                   UBLKCP.G.S [UR16], [UR5], UR4 ;
        Function : {CUR_14}
        /*0200*/                   SHFL.BFLY PT, R5, R4, 0x1, 0x1f ;
        /*0210*/                   SHFL.BFLY PT, R7, R6, 0x2, 0x1f ;
        /*0220*/                   SHFL.IDX PT, R9, R8, RZ, 0x1f ;
        /*0230*/                   STS.64 [R3], R4 ;
        /*0240*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        Function : {FULL}
        /*0400*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], RZ, !UPT ;
        /*0410*/                   HGMMA.64x128x16.F32.BF16 R88, gdesc[UR12], R88, gsb0 ;
        /*0420*/                   WARPGROUP.DEPBAR.LE gsb0, 0x0 ;
        /*0430*/                   BAR.SYNC R3, 0x80 ;
        /*0440*/                   STS [R5], R6 ;
"""


def test_kernel_instances_are_named_from_their_symbols():
    assert kernel_sass._instance(FUSED_12) == {
        "kernel": "whvi_fused", "L": 12, "residuals": True, "bf16": False,
    }
    assert kernel_sass._instance(FWHT_14) == {"kernel": "fwht", "L": 14}
    assert kernel_sass._instance("_ZN4whvi16kron_stage_kernelILi7EEEvPKf") is None


def test_ptxas_report_is_read_per_kernel():
    rows = kernel_sass.ptxas(PTXAS)
    assert rows[FUSED_12] == {"stack": 8, "spill_stores": 4, "spill_loads": 12, "registers": 108}
    assert rows[FWHT_14] == {"stack": 0, "spill_stores": 0, "spill_loads": 0, "registers": 56}


def test_sass_counts_every_form_of_an_op_once():
    counts = kernel_sass.sass_counts(SASS)
    assert dict(counts[FUSED_12]) == {
        "LDG.E.128": 2, "STS": 2, "BAR.SYNC": 1, "LDS": 1, "STG.E.128": 1,
    }
    assert dict(counts[FWHT_14]) == {"STL": 1, "LDL": 1, "BAR.SYNC": 1}
    assert dict(counts[EMIT_COPY]) == {
        "BAR.SYNC": 1, "SYNCS.PHASECHK.TRANS64.TRYWAIT": 1, "SYNCS.ARRIVE.TRANS64": 2,
        "UBLKCP.S.G": 1, "UBLKCP.G.S": 1, "LDS": 1, "STG.E.EF.128": 1, "LDG.E.EF.128": 1,
    }
    assert dict(counts[CUR_14]) == {"SHFL.BFLY": 2, "STS": 1, "BAR.SYNC": 1}
    assert dict(counts[FULL]) == {"HGMMA": 2, "BAR.SYNC": 1, "STS": 1}


@pytest.mark.parametrize("symbol, kernel", [
    ("_ZN4kron11kron_kernelILi0EEEvPKfS2_S2_S2_Pfii", "k_copy"),
    ("_ZN4kron11kron_kernelILi1EEEvPKfS2_S2_S2_Pfii", "k_scale"),
    (FULL, "k_full"),  # k_flat and emit_full launch it too
    (EMIT_COPY, "emit_copy"),
    ("_ZN4kron16kron_full_kernelILi1EEEvPKfS2_S2_S2_Pfli", "k_mm1"),  # one contraction
    ("_ZN4kron16kron_full_kernelILi2EEEvPKfS2_S2_S2_Pfli", "k_mm2"),  # two
    ("_ZN4kron11kron_kernelILi3EEEvPKfS2_S2_S2_Pfii", None),  # not a kernel of the port
    ("_ZN9kron_copy14copy_2d_kernelEPKcPclll", "hbm_copy"),  # copy_2d runs it too
])
def test_large_d_instances_are_named_after_their_wrappers(symbol, kernel):
    want = None if kernel is None else {"kernel": kernel}
    assert kernel_sass._instance(symbol) == want


@pytest.mark.parametrize("n, kernel", [(1, "k_mm1"), (2, "k_mm2")])
def test_whole_group_instances_are_named_after_their_wrappers(n, kernel):
    """kron_whole_kernel<n>, built where its switch is on, is the wgmma
    kernel after n contractions with whole groups a warpgroup."""
    symbol = f"_ZN4kron17kron_whole_kernelILi{n}EEEvPKfS2_Pfli"
    assert kernel_sass._instance(symbol) == {"kernel": kernel, "whole_group": True}


@pytest.mark.parametrize("L", [7, 12, 14])
def test_swap_instances_carry_their_width(L):
    symbol = f"_ZN4kron16kron_swap_kernelILi{L}EEEvPKfS2_S2_S2_Pfl"
    assert kernel_sass._instance(symbol) == {"kernel": "k_swap", "L": L}
    rows = kernel_sass.sass_counts(f"        Function : {symbol}\n"
                                   "        /*0010*/   UBLKCP.S.G [UR8], [UR10], UR4 ;\n")
    assert dict(rows[symbol]) == {"UBLKCP.S.G": 1}


@pytest.mark.parametrize("L", [7, 12, 14])
def test_cur_instances_carry_their_width(L):
    """kron_cur_kernel<L>, which k_onecast launches too, is named k_cur."""
    symbol = f"_ZN4kron15kron_cur_kernelILi{L}EEEvPKfS2_S2_S2_Pfl"
    assert kernel_sass._instance(symbol) == {"kernel": "k_cur", "L": L}
    rows = kernel_sass.sass_counts(f"        Function : {symbol}\n"
                                   "        /*0010*/   SHFL.BFLY PT, R5, R4, 0x10, 0x1f ;\n")
    assert dict(rows[symbol]) == {"SHFL.BFLY": 1}


@pytest.mark.parametrize("name", list(kron_variants.VARIANTS))
def test_kron_variants_edit_the_shipped_sources(name, tmp_path):
    """Every variant's edits match the shipped source exactly once, and
    only the shipped designs (no edits) build it unchanged."""
    path = kron_variants.make_source(name, str(tmp_path))
    with open(path) as f, open(os.path.join(CSRC, os.path.basename(path))) as g:
        edited, shipped = f.read(), g.read()
    assert (edited == shipped) == (
        name in ("k_scale", "emit_copy", "hbm_copy", "k_swap", "k_cur", "k_full", "k_mm1", "k_mm2"))


def test_kron_variants_refuse_an_edit_that_does_not_match():
    with pytest.raises(ValueError, match="occurs 0 times"):
        kron_variants._edit("abc", "xyz", "", "v", "f.cu")
    with pytest.raises(ValueError, match="occurs 2 times"):
        kron_variants._edit("a a", "a", "", "v", "f.cu")
    with pytest.raises(ValueError, match="out of order"):
        kron_variants._edit("[b] [a]", ("[a]", "[b]"), "", "v", "f.cu")
    assert kron_variants._edit("x [a] y [b] z", ("[a]", "[b]"), "-", "v", "f.cu") == "x - z"


def test_unique_bytes_counts_a_broadcast_axis_once():
    x = torch.zeros(256, 64).expand(8, 256, 64)
    assert common.unique_bytes(x) == 256 * 64 * 4
    assert common.unique_bytes(torch.zeros(3, 5, dtype=torch.float64)) == 15 * 8


def test_bound_is_the_larger_of_bytes_and_operations():
    x = torch.zeros(1024, 1024)
    t_bytes = 2 * x.numel() * 4 / (common.H100_HBM_GBPS * 1e9) * 1e3
    ms, by = common.bound_ms((x,), (x,), 1.0, 1e12)
    assert (ms, by) == (pytest.approx(t_bytes), "bytes")
    ms, by = common.bound_ms((x,), (x,), 1e9, 1e12)
    assert (ms, by) == (pytest.approx(1.0), "operations")
