"""The CUDA kernel source, rehearsed on the CPU.

``scripts/emulate_kernels.py`` rewrites ``riccati_kernels.cu`` and
``admm_kernels.cu`` into host C++ (one OS thread per CUDA thread) and holds
every kernel and mode against its plain PyTorch version.  Running one case
of each kernel here (K8 in its eight forms, per-instance K3, both forms of
K2 and the matrix sweep across their blocks, K5 packed with a cone and a
shift and in its rung form past their rings' slots, K4 and K6 on four
rungs across their blocks of 32 scenarios, the last ragged, K7 and K12
across their blocks and past their ring's slots; K1-K3, K7 and K9-K12 at
the mass-spring chain's widths, nx=40, nu=10, in float64; the forms on
bfloat16 stage streams of the matrix sweep, K1 gains only and K11, across
their groups on an odd batch (pairs by cp.async) and on batches of whole
boxes of the copy engine at the quadrotor's and the centroidal model's
widths, N past their staging's stages, and of K7 and K12 across their
blocks on bfloat16 boxes and, on an odd batch, in aligned pairs; the
narrow forms of the split kernels, K4 and K5 packed with the thrust cone
and a shift, K6 on four rungs (its widening warp loading the shared runs and
handing each slot to the folds) and K5's rung form, on bfloat16 boxes of
c; K10 across its blocks on boxes of the copy engine, on a box a 16-byte
phase of rows in segments of one stage, and at nx=40) keeps
the rewrite in step with the kernel source, and catches a wrong index or
a missing barrier in the source where there is no card.
"""

import importlib.util
import shutil
from pathlib import Path

import pytest

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "emulate_kernels.py"


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++ (C++20)")
def test_kernel_source_agrees_with_plain_versions_on_host_threads():
    spec = importlib.util.spec_from_file_location("emulate_kernels", SCRIPT)
    emu = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(emu)
    assert emu.main(emu.QUICK, emu.ADMM_QUICK, emu.LADDER_QUICK,
                    emu.ITER_QUICK, emu.K3_QUICK, emu.SWEEP_QUICK,
                    emu.K2_QUICK, emu.K46_QUICK, emu.K7_QUICK,
                    emu.NARROW_SWEEP_QUICK, emu.NARROW_K7_QUICK,
                    emu.NARROW_ADMM_QUICK, emu.NARROW_LADDER_QUICK,
                    emu.K10_QUICK) == 0
