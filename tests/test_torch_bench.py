"""The port's kernel-design tools without a card: the parsers of
``bench/kernel_sass.py`` on sample ptxas and cuobjdump output, and the
bounds of ``bench/common.py``.
"""

import pytest
import torch

from whvi_tpu_torch.bench import common, kernel_sass

FUSED_12 = "_ZN4whvi17whvi_fused_kernelILi12ELb1ELb0EEEvPKfS2_S2_S2_PfS3_S3_lNS_8GeometryE"
FWHT_14 = "_ZN4whvi11fwht_kernelILi14EEEvPKfPfl"

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
