#!/usr/bin/env python3
"""Time K8 (``admm_iter_lanes``) in each of its forms and per-instance K3
(``forward_lanes``) at the shapes their paths give them, on the card.

    python3 scripts/kernel_bench.py [--root DIR] [--reps 20] [--profile]

The inputs are synthetic (``chip_smoke.py``'s generators, seed 0) at the
quadrotor's widths, float32: K8 on one model at N=64 and, on cached
factors, N=512 (B=4096; the cached form also with bfloat16 stage data), on
a batched problem at N=64 (B=1024: uncached, cached, cached with bfloat16)
and at N=512 with the thrust cone and a shift (B=1024, the PDP cell's
``solve_fused(auto)``), and at the rocket's widths (N=48, B=512, two
cones); K3 per instance at N=512, B=1024 in one segment and in 8.  Each
form is held against its plain version first.  ``--root DIR`` imports
``pdp_lqr_tpu_torch`` from another checkout (its kernels built from its
own sources into its own ``build/``), so two versions are timed on one
card by running this script once for each, in turns.

Prints one JSON line a form: the median time of ``--reps`` launches by CUDA
events, the bound (the larger of its bytes over 3.35 TB/s and its
operations over 67 TFLOP/s), the error against the plain version, and
the registers and spills ``ptxas`` reported for the library's kernels.
``--profile`` builds K8 with its diagnostic ``-DADMM_PROFILE`` (thread 0
of block 0 sums the SM cycles of each section of a stage) and adds the
cycles a stage of each section to K8's lines; that build's times and
registers are not the kernel's own.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
B_SHARED, B_BATCHED, B_ROCKET = 4096, 1024, 512
ROCKET = (6, 3, 7, ((1, 3, "soc"), (4, 3, "soc")))      # nx, nu, nc, cones
THRUST = ((16, 3, "soc"),)
# K8's sections under -DADMM_PROFILE (phase 1, then phase 2).
SECTIONS = ["p1_wait_barrier", "p1_prefetch", "p1_rho_terms", "p1_fold",
            "p1_sweep", "p2_wait_barrier", "p2_prefetch", "p2_w~", "p2_x+",
            "p2_constraint_rows", "p2_projection", "p2_rows_of_w"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None,
                    help="import pdp_lqr_tpu_torch from this checkout")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--profile", action="store_true",
                    help="K8's diagnostic build: cycles a stage by section")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_bench: needs a CUDA device", file=sys.stderr)
        return 1
    root = Path(args.root).resolve() if args.root else ROOT
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("smoke", ROOT / "chip_smoke.py")
    sm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sm)
    from pdp_lqr_tpu_torch.ops import _build, cuda_admm as ca, cuda_riccati as cr
    if args.profile:
        load = _build.load
        _build.load = lambda source, defines: load(source, {
            **defines, **({"ADMM_PROFILE": 1} if "ITER" in defines else {})})
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    f32 = torch.float32
    NX, NU, NC = sm.NX, sm.NU, sm.NC
    print(json.dumps({"card": card, "root": str(root),
                      "package": str(Path(cr.__file__).parents[1])}), flush=True)

    # Every library, built at once.
    jobs = [(cr.SOURCE, cr.kernel_defines(f32, NX, NU))]
    for nx, nu, nc, cones, shift in ((NX, NU, NC, (), False),
                                     (NX, NU, NC + 3, THRUST, True),
                                     ROCKET + (False,)):
        jobs.append((ca.SOURCE, ca.kernel_defines(
            f32, nx, nu, nc, cones=cones, has_shift=shift, single=True)))
    paths = _build.build_many(jobs)
    regs = sm.registers_by_kernel(
        [(job[1], _build.build_logs.get(p, "")) for job, p in zip(jobs, paths)])
    regs = {k: v for k, v in regs.items()
            if k.startswith(("iter_kernel", "forward_kernel"))}
    print(json.dumps({"ptxas": regs}), flush=True)

    def report(name, call, plain, names, moved, flops, extra=lambda: {}):
        out = call()
        _, rel = sm.rel_err(names, out, plain())
        ms = sm.cuda_ms(call, args.reps)
        bound_ms, by = sm.bound(moved + sm.nbytes(*out), flops)
        print(json.dumps({"kernel": name, "ms": ms, "bound_ms": bound_ms,
                          "bound_by": by, "max_rel_err": max(rel.values()),
                          **extra()}), flush=True)
        sm.require(max(rel.values()) <= sm.TOL[f32], name, rel)

    rng = np.random.default_rng(sm.SEED)
    forms = [
        ("[shared]", 64, B_SHARED, True, False, False, (NX, NU, NC, (), False)),
        ("[shared,cached]", 512, B_SHARED, True, True, False,
         (NX, NU, NC, (), False)),
        ("[shared,cached,bf16]", 512, B_SHARED, True, True, True,
         (NX, NU, NC, (), False)),
        ("[batched]", 64, B_BATCHED, False, False, False, (NX, NU, NC, (), False)),
        ("[batched,cached]", 64, B_BATCHED, False, True, False,
         (NX, NU, NC, (), False)),
        ("[batched,cached,bf16]", 64, B_BATCHED, False, True, True,
         (NX, NU, NC, (), False)),
        ("[batched,cone+shift,N=512]", 512, B_BATCHED, False, False, False,
         (NX, NU, NC + 3, THRUST, True)),
        ("[rocket]", 48, B_ROCKET, False, False, False, ROCKET + (False,)),
    ]

    def sections(N, nx, nu, nc, cones, shift):
        lib = ca._library(f32, nx, nu, nc, cones=cones, has_shift=shift,
                          single=True)
        out = (ctypes.c_longlong * len(SECTIONS))()
        lib.admm_read_prof.argtypes = [ctypes.c_void_p]
        sm.require(lib.admm_read_prof(out) == 0, "admm_read_prof")
        return {"cycles_per_stage": {k: v / N for k, v in zip(SECTIONS, out)}}

    for tag, N, Bt, shared, cached, narrow, (nx, nu, nc, cones, shift) in forms:
        a = sm.random_iter_inputs(rng, N, nx, nu, nc, Bt, cones, shared, shift,
                                  f32, dev)
        factors = sm.iter_factors(a, shared) if cached else None
        if narrow:
            a = sm.narrow_storage(a)
        kw = dict(nu=nu, cones=cones, alpha=sm.ALPHA, sigma=sm.SIGMA,
                  factors=factors)
        moved = sm.nbytes(*(x for i, x in enumerate(a)
                            if not (cached and i == 14)), *(factors or ()))
        report("admm_iter_lanes" + tag,
               lambda: ca.admm_iter_lanes(*a, shared=shared, **kw),
               lambda: ca.admm_iter_lanes_reference(*a, **kw), sm.K8_OUT,
               moved, sm.k8_flops(N, nx, nu, nc, Bt, cached),
               (lambda: sections(N, nx, nu, nc, cones, shift)) if args.profile
               else (lambda: {}))
        del a, factors

    N, Bt = 512, B_BATCHED
    T = lambda *s, scale: torch.as_tensor(rng.normal(size=s) * scale).to(
        device=dev, dtype=f32).contiguous()
    M, K = T(N, NX, NX, Bt, scale=0.1), T(N, NU, NX, Bt, scale=0.3)
    v, d = T(N, NX, Bt, scale=0.3), T(N, NU, Bt, scale=0.3)
    for S in (1, 8):
        x0 = T(S, NX, Bt, scale=0.3) if S > 1 else T(NX, Bt, scale=0.3)
        seg = S if S > 1 else None
        report(f"forward_lanes[per-instance,S={S}]",
               lambda: cr.forward_lanes(M, v, K, d, x0, segments=seg),
               lambda: cr.forward_lanes_reference(M, v, K, d, x0, segments=seg),
               sm.K3_OUT, sm.nbytes(M, v, K, d, x0),
               sm.k3_flops(N, NX, NU, Bt))
    return 0


if __name__ == "__main__":
    sys.exit(main())
