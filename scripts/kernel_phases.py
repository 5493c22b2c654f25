#!/usr/bin/env python3
"""Where a stage's time goes inside the three sweep kernels, on the card.

    python3 scripts/kernel_phases.py [--batches 1024 4096 16384]

The vendor's profilers do not run everywhere, so the kernels carry an
opt-in diagnostic build (``-DRICCATI_PROFILE``): thread 0 of block 0 sums
the SM cycles (``clock64``) it spends in each marked section of a stage.
This script builds that variant for the serving shape (quadrotor nx=12,
nu=4, nc=16, N=512, B=4096, float32), runs each kernel on the tensors the
main path hands it, and prints cycles per stage per section as JSON, next
to the card's clocks, a device-memory copy rate as a sanity check of the
card's state, and the per-scenario kernels' times at other batch sizes
(the two kernels of the split ADMM iteration included, on random iterates
around the same model's factors).  The matrix sweep is profiled also per
instance, on the tensors its paths hand it (``kernel_bench.sweep_runs``
and ``latency_runs``): K1 on the replicated loop's B=1024, K9 in S=8
segments at B=1024, and K9 in one segment at N=1024, B=128 (the block of
one instance).
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]

N, SIGMA, RHO = 512, 1e-6, 0.01
SECTIONS = {
    "backward_lanes": ["wait+barrier", "stores", "copies",
                       "A: Dr and [P;F][A c B]", "B: fold and B^T[PA Pcp PB]",
                       "C: chol and solves", "D: P+ p+ C", "D: M v F f"],
    # K2 shared: lane 0 of each role's warp (the tail's per stage it took).
    "backward_vectors_lanes": ["producer: wait empty", "producer: copies",
                               "chain: wait full", "chain: Pcp rbar p",
                               "tail: wait ready", "tail: d v stores"],
    "forward_lanes": ["wait", "barrier", "compute", "prefetch"],
}


def smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cuda_ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def library(nc=None, **extra):
    from pdp_lqr_tpu_torch.ops import _build, cuda_riccati as cr
    defines = {**cr.kernel_defines(torch.float32, 12, 4, nc), **extra}
    lib = ctypes.CDLL(str(_build.build(cr.SOURCE, defines)))
    cr.bind_library(lib, with_matrix_sweep=nc is not None)
    return lib


def read_prof(lib, name, stages=N):
    """Cycles a stage of each section: {label: cycles}."""
    out = (ctypes.c_longlong * 8)()
    lib.riccati_read_prof.argtypes = [ctypes.c_void_p]
    status = lib.riccati_read_prof(out)
    if status:
        raise RuntimeError(f"riccati_read_prof: CUDA error {status}")
    return {k: v / stages for k, v in zip(SECTIONS[name], list(out))}


def inputs(B, dev):
    from pdp_lqr_tpu_torch import init_iterates
    from pdp_lqr_tpu_torch.models import quadrotor
    from pdp_lqr_tpu_torch.ops import cuda_riccati as cr
    model, _ = quadrotor(N=N, constrained=True, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(0)
    c = torch.as_tensor((rng.normal(size=(B, N, 12)) * 0.01).astype(np.float32)).to(dev)
    x0 = torch.as_tensor(rng.normal(size=(B, 12)).astype(np.float32) * 0.1).to(dev)
    prep = cr.prepare_shared(dataclasses.replace(model, c=c),
                             init_iterates(model, rho=RHO), x0, SIGMA)
    A, Bm, H, D, rho, PN, c_l, hf_l, pN_l, x0_l, _ = prep
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    k1_in = (A, Bm, z(N, 12, 1), H, z(N, 16, 1), D, rho, z(N, 16, 1), PN, z(12, 1))
    K, _, M, _, P, L = cr.backward_lanes(*k1_in, export_factors=True)
    Pc = cr.fold_Pc(P, c_l)
    d, v = cr.backward_vectors_lanes(A, Bm, c_l, hf_l, P, K, L, pN_l,
                                     shared=True, Pc=Pc)
    return k1_in, (A, Bm, c_l, hf_l, Pc, K, L, pN_l), (M, v, K, d, x0_l)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, nargs="*", default=[1024, 4096, 16384])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_phases: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sm = module("smoke", ROOT / "chip_smoke.py")
    kb = module("bench", ROOT / "scripts" / "kernel_bench.py")
    from pdp_lqr_tpu_torch.ops import cuda_admm as ca, cuda_riccati as cr
    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream
    card = smi("name,power.limit")

    big = torch.empty(1 << 28, dtype=torch.float32, device=dev)      # 1 GiB
    copy_ms = cuda_ms(lambda: big.clone())
    print(json.dumps({
        "card": card, "clocks_under_load": smi("clocks.sm,clocks.mem,power.draw"),
        "copy_1GiB_ms": copy_ms,
        "copy_TB_per_s": 2 * big.numel() * 4 / (copy_ms * 1e-3) / 1e12}), flush=True)
    del big

    def show(name, lib, fn, stages, **shape):
        ms = cuda_ms(fn)
        cycles = read_prof(lib, name, stages)
        print(json.dumps({
            "card": card, "kernel": name, **shape, "ms_profiled_build": ms,
            "cycles_per_stage": cycles,
            "cycles_per_stage_total": sum(cycles.values()),
            "implied_GHz": sum(cycles.values()) * stages / (ms * 1e-3) / 1e9,
            "clocks_now": smi("clocks.sm")}), flush=True)

    k1_in, k2_in, k3_in = inputs(4096, dev)
    prof1 = library(16, RICCATI_PROFILE=1)
    profv = library(None, RICCATI_PROFILE=1)
    show("backward_lanes", prof1, lambda: cr._launch_backward(
        prof1, *k1_in, True, True, stream()), N, N=N, B=1)
    show("backward_vectors_lanes", profv, lambda: cr._launch_backward_vectors(
        profv, *k2_in, True, True, stream()), N, N=N, B=4096)
    show("forward_lanes", profv, lambda: cr._launch_forward(
        profv, *k3_in, True, stream()), N, N=N, B=4096)

    # The matrix sweep per instance, on its paths' tensors.
    runs = kb.sweep_runs(sm, dev)
    _, a, kw, _, _ = runs["backward_lanes[per-instance]"]
    show("backward_lanes", prof1, lambda: cr._launch_backward(
        prof1, *a, False, True, stream()), N, N=N, B=a[0].shape[-1],
        path="replicated")
    _, a, kw, _, _ = runs["backward_pdp_lanes"]
    S = kw["segments"]
    show("backward_lanes", prof1, lambda: cr._launch_backward_pdp(
        prof1, *a, False, S, stream()), N // S, N=N, B=a[0].shape[-1], S=S,
        path="pdp_solve")
    _, a, kw, _, _ = kb.latency_runs(sm, dev)[
        f"backward_pdp_lanes[N={kb.N_LAT},S=1,B={kb.B_LAT[0]}]"]
    show("backward_lanes", prof1, lambda: cr._launch_backward_pdp(
        prof1, *a, False, 1, stream()), kb.N_LAT, N=kb.N_LAT,
        B=a[0].shape[-1], S=1, path="pdp_latency")
    del runs

    lib = library()
    row = {"card": card}
    for B in args.batches:
        k1, k2, k3 = inputs(B, dev)
        row[f"K2_ms_B{B}"] = cuda_ms(lambda: cr._launch_backward_vectors(
            lib, *k2, True, True, stream()))
        row[f"K3_ms_B{B}"] = cuda_ms(lambda: cr._launch_forward(
            lib, *k3, True, stream()))
        # The ADMM pair (wrappers): box rows only, diagonal stage cost.
        K, _, M, _, _, L = cr.backward_lanes(*k1, export_factors=True)
        k4_in, k5_in = sm.random_admm_inputs(
            np.random.default_rng(0), k1[0], k1[1], K, M, L, 16, B, (), True,
            False)
        row[f"K4_ms_B{B}"] = cuda_ms(
            lambda: ca.admm_bwd_vec_prefold_lanes(*k4_in, nu=4))
        row[f"K5_ms_B{B}"] = cuda_ms(lambda: sm.k5_call(ca, k5_in, ()))
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
