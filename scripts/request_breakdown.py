#!/usr/bin/env python3
"""Where one ``ScenarioServer`` request spends its time, on the card.

    python3 scripts/request_breakdown.py [--admm | --ladder |
                                          --replicated [--cached] |
                                          --single [--cached] [--batched]
                                          [--bf16] |
                                          --pdp [--admm] [--cached]]
                                         [--requests 20]

Serves the smoke run's workload (quadrotor, constrained, float32):
``solve`` requests (N=512, B=4096) or one of the 20-iteration conic ADMM
requests at the smoke run's settings: ``--admm`` the split loop with a
uniform rho (N=512, B=4096), ``--ladder`` the split loop on a four-rung rho
ladder, scenario b starting on rung b mod 4, ``--replicated``
``solve_fused`` on a batched problem (N=512, B=1024, per-instance rho;
``--cached`` with cached factors), ``--single`` the single-kernel
iteration (K8): ``solve_admm``'s default path at N=64, B=4096
(per-scenario rho), with ``--cached`` on cached factors at a uniform rho at
N=512, B=4096 (``--bf16``: the stage data stored as bfloat16, through
``solve_fused(storage_dtype=torch.bfloat16)``), with ``--batched`` on a
batched problem at N=64, B=1024;
``--pdp`` the segment-parallel solve (``parallel.pdp_sharded_fused``, N=512,
B=1024, the horizon in S=8 segments), with ``--admm`` the conic
ADMM loop on it (``parallel.admm_sharded``, the thrust-cone model with a
shift, 20 iterations; ``--cached`` with cached factors).
It prints as JSON lines:

  * the request's time by CUDA events, the host's time to enqueue it (host
    clock around the call, no synchronise) and the host's time with a
    synchronise at the end: where the first is close to the second, the
    host and not the card sets the request time; and what one request
    makes the caching allocator do (retries, device allocations and frees)
    and reads on the host;
  * from ``torch.profiler`` over the same requests: device time by kernel
    name (per request), the device's busy time and its idle share; for an
    ADMM request also the kernels launched per ADMM iteration;
  * for ``--pdp``, the condensed boundary solve's share of a request: its
    host time (the calls of ``ops.condensed``, on the host clock) and its
    device time (CUDA events around each call).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (  # noqa: E402
    ADMM_ITERS, ADMM_SETTINGS, B_PDP, B_REP, LADDER, LADDER_SETTINGS, NC,
    N_SINGLE, REP_SETTINGS, S_PDP, SINGLE_SETTINGS, THRUST_SHIFT, batched,
    profiled, request_probe, zero_state,
)
from pdp_lqr_tpu_torch import ADMMSettings, ScenarioServer, solve_fused  # noqa: E402
from pdp_lqr_tpu_torch.models import quadrotor  # noqa: E402
from pdp_lqr_tpu_torch.solvers import admm  # noqa: E402

N, B, SIGMA, RHO = 512, 4096, 1e-6, 0.01


def time_condensed(psf):
    """Wrap the condensed solve's two functions where the PDP module calls
    them: each call appends (host ms, (start event, end event)) to the
    list returned."""
    calls = []

    def timed(fn):
        def call(*args, **kwargs):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0 = time.perf_counter()
            e0.record()
            out = fn(*args, **kwargs)
            e1.record()
            calls.append(((time.perf_counter() - t0) * 1e3, (e0, e1)))
            return out
        return call

    for name in ("cholesky_backward", "cholesky_forward"):
        setattr(psf.condensed, name, timed(getattr(psf.condensed, name)))
    return calls


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=20)
    kind = ap.add_mutually_exclusive_group()
    ap.add_argument("--admm", action="store_true",
                    help="20-iteration solve_admm requests, uniform rho; "
                         "with --pdp the PDP ADMM loop")
    kind.add_argument("--ladder", action="store_true",
                      help="20-iteration solve_admm requests, four-rung ladder")
    kind.add_argument("--replicated", action="store_true",
                      help="20-iteration solve_fused on a batched problem")
    kind.add_argument("--single", action="store_true",
                      help="20-iteration single-kernel (K8) requests")
    kind.add_argument("--pdp", action="store_true",
                      help="the segment-parallel PDP solve (B=1024); with "
                           "--admm its conic ADMM loop")
    ap.add_argument("--cached", action="store_true",
                    help="with --replicated, --single or --pdp --admm: "
                         "cached factors")
    ap.add_argument("--batched", action="store_true",
                    help="with --single: a batched problem (B=1024, N=64)")
    ap.add_argument("--bf16", action="store_true",
                    help="with --single --cached: bfloat16 stage data")
    args = ap.parse_args()
    if args.admm and (args.ladder or args.replicated or args.single):
        ap.error("--admm combines with --pdp only")
    if args.bf16 and not (args.single and args.cached and not args.batched):
        ap.error("--bf16 combines with --single --cached only")
    iterative = args.admm or args.ladder or args.replicated or args.single
    if not torch.cuda.is_available():
        print("request_breakdown: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()

    n = N_SINGLE if args.single and not (args.cached and not args.batched) \
        else N
    model, cones = quadrotor(N=n, constrained=True, dtype=torch.float32,
                             device=dev, thrust_cone=args.pdp and args.admm)
    server = ScenarioServer(model, rho=RHO, sigma=SIGMA, device=dev)
    rng = np.random.default_rng(0)
    c = torch.as_tensor((rng.normal(size=(B, n, model.nx)) * 0.01)
                        .astype(np.float32)).to(dev)
    if iterative:
        x0 = torch.as_tensor((0.03 + 0.01 * rng.normal(size=(B, model.nx)))
                             .astype(np.float32)).to(dev)
    condensed_ms = None
    if args.pdp:
        from pdp_lqr_tpu_torch import ADMMIterates, init_iterates
        from pdp_lqr_tpu_torch.parallel import (admm_sharded, make_mesh,
                                                pdp_sharded_fused as psf)
        condensed_ms = time_condensed(psf)
        mesh = make_mesh(time=S_PDP, device=dev)
        bp = batched(model, B_PDP, c[:B_PDP])
        if args.admm:
            settings = ADMMSettings(**REP_SETTINGS, cached_factors=args.cached)
            shift = np.zeros((n + 1, model.nc), np.float32)
            shift[:, NC] = THRUST_SHIFT
            request = lambda: admm_sharded.solve(mesh, bp, x0[:B_PDP], cones,
                                                 settings, soc_shift=shift)
            entry = "admm_sharded.solve" + (", cached" if args.cached else "")
        else:
            it = init_iterates(model, rho=RHO)
            it = ADMMIterates(**{k: getattr(it, k)[None].expand(
                (B_PDP,) + getattr(it, k).shape) for k in ("w", "y", "z", "rho")})
            x0 = torch.as_tensor(rng.normal(size=(B, model.nx))
                                 .astype(np.float32) * 0.1).to(dev)
            request = lambda: psf.solve(mesh, bp, it, x0[:B_PDP], SIGMA)
            entry = "pdp_sharded_fused.solve"
        entry += f", S={S_PDP}"
    elif args.admm:
        settings = ADMMSettings(**ADMM_SETTINGS)
        request = lambda: server.solve_admm(x0, (), settings, c=c)
        entry = "solve_admm"
    elif args.ladder:
        settings = ADMMSettings(**LADDER_SETTINGS)
        state = zero_state(B, N, model.nc, torch.float32, dev, torch.tensor(
            [LADDER[b % len(LADDER)] for b in range(B)]))
        request = lambda: server.solve_admm(x0, (), settings, state=state, c=c)
        entry = "solve_admm, rho ladder"
    elif args.replicated:
        settings = ADMMSettings(**REP_SETTINGS, cached_factors=args.cached)
        bp = batched(model, B_REP, c[:B_REP])
        request = lambda: solve_fused(bp, x0[:B_REP], (), settings,
                                      single_kernel=False)
        entry = "solve_fused, batched" + (", cached" if args.cached else "")
    elif args.single:
        settings = ADMMSettings(**SINGLE_SETTINGS, cached_factors=args.cached,
                                uniform_rho=args.cached and not args.batched)
        if args.batched:
            bp = batched(model, B_REP, c[:B_REP])
            request = lambda: solve_fused(bp, x0[:B_REP], (), settings,
                                          single_kernel=True)
        elif args.bf16:
            mc = dataclasses.replace(model, c=c)
            request = lambda: solve_fused(mc, x0, (), settings,
                                          single_kernel=True,
                                          storage_dtype=torch.bfloat16)
        else:
            request = lambda: server.solve_admm(x0, (), settings, c=c,
                                                split=False)
        entry = ("solve_fused, batched" if args.batched else "solve_admm") \
            + ", single kernel" + (", cached" if args.cached else "") \
            + (", bf16 stage data" if args.bf16 else "")
    else:
        entry = "solve"
        x0 = torch.as_tensor(rng.normal(size=(B, model.nx)).astype(np.float32)
                             * 0.1).to(dev)
        request = lambda: server.solve(x0, c)
    for _ in range(3):
        request()
    torch.cuda.synchronize()

    event_ms, enqueue_ms, synced_ms = [], [], []
    for _ in range(args.requests):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        request()
        end.record()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        event_ms.append(start.elapsed_time(end))
        enqueue_ms.append((t1 - t0) * 1e3)
        synced_ms.append((t2 - t0) * 1e3)
    med = lambda xs: float(np.median(xs))
    condensed = {}
    if condensed_ms is not None:
        condensed_ms.clear()
        request()
        torch.cuda.synchronize()
        condensed = {
            "condensed_calls_per_request": len(condensed_ms),
            "condensed_host_ms_per_request": sum(h for h, _ in condensed_ms),
            "condensed_device_ms_per_request": sum(
                e0.elapsed_time(e1) for _, (e0, e1) in condensed_ms)}
    print(json.dumps({
        "card": card, "N": n, **condensed,
        "B": B_REP if args.replicated or args.batched else
        B_PDP if args.pdp else B,
        "requests": args.requests, "entry_point": entry,
        "request_ms_cuda_events": med(event_ms),
        "host_enqueue_ms": med(enqueue_ms),
        "host_with_synchronise_ms": med(synced_ms),
        "one_request": request_probe(request, admm)}), flush=True)

    rows, busy_ms, window_ms = profiled(request, args.requests)
    per_request = sum(r["calls_per_request"] for r in rows)
    extra = {"device_kernels_per_iteration": per_request / ADMM_ITERS} \
        if iterative else {}
    print(json.dumps({
        "card": card, "profiled_requests": args.requests, **extra,
        "window_ms_per_request": window_ms,
        "device_busy_ms_per_request": busy_ms,
        "device_idle_share": 1.0 - busy_ms / window_ms,
        "device_kernels_per_request": per_request,
        "by_kernel": rows[:25]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
