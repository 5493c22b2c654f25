"""Replan latency against the 1 kHz MPC budget, on the PyTorch port.

The port's counterpart of ``examples/latency_mpc.py`` (BASELINE.md metric
#2).  Measures the steady-state cost of a receding-horizon replan with the
*delta method*: time K- and 2K-iteration solves and report the marginal
cost of an iteration, which cancels the fixed cost of a call.  Each solve
is timed by CUDA events (the median of 10 calls after a warm-up).

Sections: a single instance on ``admm.solve`` (torch ops, B=1); the dense
realtime operator (``realtime.build_operator``, replans through
``realtime.replan_fn``; skipped where its map would
exceed 12,000 rows, 3.8 GB for the centroidal model at N=1024); the
segment-factored operator (``build_condensed_operator``, S automatic ~
sqrt(M / 2nx) or ``--segments``), also in bfloat16 storage with
``--bf16-op``; each operator's rebuild (one rho change); and the fused
batch (``solve_fused`` on a batched problem: the replicated loop and the
single-kernel iteration).

Usage: python examples/torch_latency_mpc.py [--model quadrotor|centroidal|
       mass_spring] [--horizon N] [--admm-iters K] [--batch B]
       [--segments S] [--bf16-op] [--skip-xla] [--skip-dense-op]
       [--skip-batch] [--device cpu]
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import argparse
import dataclasses

import torch

REPS = 10


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--horizon", type=int, default=64)
    ap.add_argument("--admm-iters", type=int, default=20)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--model", default="quadrotor",
                    choices=["quadrotor", "centroidal", "mass_spring"],
                    help="BASELINE.json config family (config #5 = "
                         "centroidal nx=24 at --horizon 1024)")
    ap.add_argument("--segments", type=int, default=0,
                    help="segments for the condensed realtime operator "
                         "(0 = auto ~ sqrt(M/2nx); must divide N)")
    ap.add_argument("--skip-xla", action="store_true",
                    help="skip the single-instance admm.solve section "
                         "(torch ops, B=1; slow at long horizons)")
    ap.add_argument("--skip-dense-op", action="store_true",
                    help="skip the dense-operator path")
    ap.add_argument("--skip-batch", action="store_true",
                    help="skip the fused-batch section")
    ap.add_argument("--bf16-op", action="store_true",
                    help="also time the bfloat16-storage condensed operator")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (host clock)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device; pass --device cpu", file=sys.stderr)
        return 1

    from pdp_lqr_tpu_torch.solvers import admm, realtime
    from pdp_lqr_tpu_torch.utils import profiling

    dtype = torch.float32
    cones: tuple = ()
    if args.model == "quadrotor":
        from pdp_lqr_tpu_torch.models import quadrotor

        problem, _ = quadrotor(N=args.horizon, constrained=True, dtype=dtype,
                               device=dev)
    elif args.model == "centroidal":
        from pdp_lqr_tpu_torch.models import centroidal

        problem, cone_list = centroidal(N=args.horizon, dtype=dtype,
                                        device=dev)
        cones = tuple(cone_list)
    else:
        from pdp_lqr_tpu_torch.models import mass_spring_chain

        problem = mass_spring_chain(n_masses=20, N=args.horizon, dtype=dtype,
                                    device=dev)
    if dev.type == "cuda":
        print(card_line())
    K = args.admm_iters
    N = args.horizon
    M = (N + 1) * problem.nz
    if M > 12_000 and not args.skip_dense_op:
        print(f"dense operator auto-skipped (M={M}: T would be "
              f"{M * M * 4 / 1e9:.1f} GB)")
        args.skip_dense_op = True

    def ms(fn):
        return profiling.time_fn(fn, iters=REPS, warmup=2, device=dev).p50_ms

    def report(label, t_k, t_2k):
        per_iter = (t_2k - t_k) / K
        replan_ms = per_iter * K
        fixed_ms = max(t_k - replan_ms, 0.0)
        print(f"{label}: {per_iter * 1e3:.1f} us/ADMM-iter -> {K}-iter "
              f"warm replan ~= {replan_ms:.3f} ms marginal "
              f"(+{fixed_ms:.3f} ms fixed) "
              f"({'WITHIN' if replan_ms <= 1.0 else 'OVER'} 1 ms / 1 kHz "
              f"budget)")

    def settings(iters, rho=0.1, eps=1e-4):
        return admm.ADMMSettings(max_iter=iters, rho_update_interval=iters,
                                 rho=rho, adaptive_rho=False, eps_abs=eps,
                                 eps_rel=eps)

    x0 = torch.zeros(problem.nx, dtype=dtype, device=dev)

    # ---- single instance (torch ops, B=1) ------------------------------
    if not args.skip_xla:
        report("single instance (admm.solve)",
               ms(lambda: admm.solve(problem, x0, cones, settings(K))),
               ms(lambda: admm.solve(problem, x0, cones, settings(2 * K))))

    # ---- the realtime operators -----------------------------------------
    # Timed with the early exit disabled (eps = 0): exactly K iterations.
    rt = lambda iters: settings(iters, rho=1.0, eps=0.0)
    state0 = admm.init_state(problem, rt(K))

    def time_operator(op, label):
        # The 1 kHz path: a replan through replan_fn (on the card, one CUDA
        # graph replay and one flag read an iteration).
        replan = {k: realtime.replan_fn(problem, op, cones, rt(k))
                  for k in (K, 2 * K)}
        report(label, ms(lambda: replan[K](x0, state0)),
               ms(lambda: replan[2 * K](x0, state0)))

    def time_rebuild(build, label):
        t = profiling.time_fn(build, iters=3, warmup=1, device=dev).p50_ms
        print(f"{label} rebuild: {t:.3f} ms per rho change (amortized over "
              f"an interval-25 rho cadence: {t / 25 * 1e3:.1f} us/iter)")

    if not args.skip_dense_op:
        build = lambda: realtime.build_operator(problem, 1.0, rt(K), cones)
        time_operator(build(), "realtime operator path")
        time_rebuild(build, "realtime operator")

    S = args.segments
    if S == 0:
        target = max(2, int(round((M / (2 * problem.nx)) ** 0.5)))
        S = max(s for s in range(2, N + 1) if N % s == 0 and s <= target)
    if N % S == 0:
        build = lambda: realtime.build_condensed_operator(
            problem, 1.0, S, rt(K), cones)
        cop = build()
        time_operator(cop, f"condensed operator (S={S}) path")
        if args.bf16_op:
            time_operator(realtime.cast_operator(cop, torch.bfloat16),
                          f"condensed operator (S={S}, bf16) path")
        time_rebuild(build, f"condensed operator (S={S})")

    # ---- fused batch -----------------------------------------------------
    if args.skip_batch:
        return 0
    B = args.batch
    bp = dataclasses.replace(problem, **{
        f.name: getattr(problem, f.name).expand(
            (B,) + tuple(getattr(problem, f.name).shape))
        for f in dataclasses.fields(problem)})
    x0s = torch.zeros((B, problem.nx), dtype=dtype, device=dev)
    for single in (False, True):
        fused = lambda iters: admm.solve_fused(bp, x0s, cones,
                                               settings(iters),
                                               single_kernel=single)
        t_k, t_2k = ms(lambda: fused(K)), ms(lambda: fused(2 * K))
        per_iter = (t_2k - t_k) / K
        label = "single-kernel" if single else "two-kernel"
        print(f"fused batch B={B} ({label}): {per_iter * 1e3:.1f} "
              f"us/ADMM-iter -> {K}-iter replan ~= {per_iter * K:.3f} ms "
              f"total, {per_iter * K / B * 1e3:.1f} us/instance")
    return 0


def card_line():
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


if __name__ == "__main__":
    sys.exit(main())
