"""Scenario-batch MPC: sampled dynamics, fused solves, consensus control,
on the PyTorch port.

The port's counterpart of ``examples/scenario_mpc.py`` (BASELINE.json
config #4 as a serving workload): B sampled-dynamics quadrotor instances
solved a replan through the batch-fused conic ADMM (``solve_fused`` on a
batched problem: the single-kernel iteration K8 on the card), then a
consensus first control (the mean over scenarios), the failure mask
(``profiling.failure_mask``) and scenario 0's quality (``quality.assess``).
With ``--shared-dynamics`` only the drift c is sampled, so every scenario
shares (A, B), and the operator-mode path (``realtime.
build_batch_operator`` / ``solve_batch``: batched products, no stage
sweeps) is timed against the fused kernels.

float32; B defaults to 1024 on the card and 8 on the CPU.  The last line
is the figures as JSON.

Usage: python examples/torch_scenario_mpc.py [--batch B] [--horizon N]
       [--admm-iters K] [--reps R] [--shared-dynamics] [--device cpu]
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import argparse
import dataclasses
import json
import time

import numpy as np
import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--horizon", type=int, default=64)
    ap.add_argument("--admm-iters", type=int, default=15)
    ap.add_argument("--reps", type=int, default=10,
                    help="timed warm replans (after one untimed)")
    ap.add_argument("--shared-dynamics", action="store_true",
                    help="sample only additive disturbances (c) so all "
                         "scenarios share (A, B) and time the operator-mode "
                         "path (realtime.solve_batch) against the fused "
                         "kernels")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def scenarios(B: int, N: int, shared: bool):
    """The sampled perturbations (numpy, seed 0, float32): dc (B, N, 12)
    and, unless ``shared``, dA (B, 1, 12, 12) and dB (B, 1, 12, 4)."""
    rng = np.random.default_rng(0)
    dc = rng.normal(size=(B, N, 12)).astype(np.float32) * 0.002
    if shared:
        return dc, None, None
    dA = rng.normal(size=(B, 1, 12, 12)).astype(np.float32) * 0.002
    dB = rng.normal(size=(B, 1, 12, 4)).astype(np.float32) * 0.002
    return dc, dA, dB


def run(args) -> dict:
    import pdp_lqr_tpu_torch as plt_
    from pdp_lqr_tpu_torch.models import quadrotor
    from pdp_lqr_tpu_torch.solvers import admm
    from pdp_lqr_tpu_torch.utils import profiling, quality

    dev = torch.device(args.device)
    on_cpu = dev.type == "cpu"
    B = args.batch or (8 if on_cpu else 1024)
    sync = (lambda: None) if on_cpu else torch.cuda.synchronize

    base, _ = quadrotor(N=args.horizon, constrained=True, dtype=torch.float32,
                        device=dev)
    bp = plt_.LQRProblem(**{f.name: getattr(base, f.name).expand(
        (B,) + getattr(base, f.name).shape) for f in dataclasses.fields(base)})
    dc, dA, dB = scenarios(B, args.horizon, args.shared_dynamics)
    t = lambda x: torch.as_tensor(x).to(dev)
    bp = dataclasses.replace(bp, c=bp.c + t(dc))
    if not args.shared_dynamics:
        bp = dataclasses.replace(bp, A=bp.A + t(dA), B=bp.B + t(dB))
    x0s = torch.zeros((B, 12), dtype=torch.float32, device=dev)

    settings = admm.ADMMSettings(
        max_iter=args.admm_iters, rho_update_interval=args.admm_iters,
        adaptive_rho=False, eps_abs=1e-4, eps_rel=1e-4, rho=0.1)
    fused = lambda s: plt_.solve_fused(bp, x0s, (), settings, s)

    ws, state, info = fused(None)
    ws_cold = ws
    n_conv = int(info.converged.sum())
    max_r_prim = float(info.r_prim.max())
    print(f"cold replan: {n_conv}/{B} scenarios converged "
          f"(max r_prim {max_r_prim:.2e})")

    # Warm replans at serving cadence.
    ws, state, info = fused(state)
    sync()
    t0 = time.perf_counter()
    for _ in range(args.reps):
        ws, state, info = fused(state)
    sync()
    dt = (time.perf_counter() - t0) / args.reps
    print(f"warm replan of {B} scenarios: {dt*1e3:.2f} ms "
          f"({dt/B*1e6:.1f} us/scenario, host clock)")

    # Consensus control: mean over scenarios of the first input.
    u0 = ws[:, 0, :4].double().cpu()
    print("consensus u0:", np.array2string(u0.mean(0).numpy(), precision=4),
          "+-", np.array2string(u0.std(0, unbiased=False).numpy(),
                                precision=4))
    failed = int(profiling.failure_mask(ws).sum())
    print("failed scenarios:", failed)
    q = quality.assess(plt_.LQRProblem(**{f.name: getattr(bp, f.name)[0]
                                          for f in dataclasses.fields(bp)}),
                       ws[0])
    print("scenario-0 quality:", q)
    figures = {"B": B, "cold_converged": n_conv, "cold_max_r_prim": max_r_prim,
               "consensus_u0": u0.mean(0).tolist(),
               "consensus_u0_std": u0.std(0, unbiased=False).tolist(),
               "failed": failed,
               "quality0": {f.name: float(getattr(q, f.name))
                            for f in dataclasses.fields(q)},
               "warm_replan_host_ms": dt * 1e3}

    if args.shared_dynamics:
        # Operator-mode serving: one (B, M) by (M, M) product an iteration
        # instead of the stage sweeps.
        from pdp_lqr_tpu_torch.solvers import realtime

        op = realtime.build_batch_operator(base, rho=settings.rho,
                                           settings=settings)
        opfn = lambda s: realtime.solve_batch(bp, x0s, op, (), settings, s)
        ws_o, st_o, _ = opfn(None)
        err = float((ws_o - ws_cold).abs().max())
        ws_o, st_o, _ = opfn(st_o)
        sync()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            ws_o, st_o, _ = opfn(st_o)
        sync()
        dt_o = (time.perf_counter() - t0) / args.reps
        print(f"operator-mode warm replan of {B} scenarios: "
              f"{dt_o*1e3:.2f} ms ({dt_o/B*1e6:.2f} us/scenario, host clock);"
              f" max |op - fused| = {err:.2e}")
        figures.update(operator_vs_fused=err,
                       operator_warm_replan_host_ms=dt_o * 1e3)
    print(json.dumps(figures))
    return figures


def main(argv=None):
    args = parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device; pass --device cpu", file=sys.stderr)
        return 1
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
