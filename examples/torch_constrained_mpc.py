"""Constrained quadrotor MPC with the conic ADMM outer loop, on the
PyTorch port.

The port's counterpart of ``examples/constrained_mpc.py``: box
constraints on states and inputs (and, with ``--thrust-cone``, a thrust
second-order cone) solved by ADMM around the Riccati inner solver
(``admm.solve``), then run closed-loop at a receding horizon with warm
starts (``mpc.simulate``).  float32 unless ``--f64``.

Prints the final position against the hover target [0, 0, 1], the
control range against the box [-0.9916, 2.4084] and the mean ADMM
iterations to converge; the last line is those figures as JSON.

Usage: python examples/torch_constrained_mpc.py [--horizon N] [--steps T]
       [--thrust-cone] [--f64] [--device cpu]
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import argparse
import json
import time

import torch

BOX = (-0.9916, 2.4084)      # the quadrotor's input box (models/quadrotor.py)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--horizon", type=int, default=40)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--thrust-cone", action="store_true")
    ap.add_argument("--f64", action="store_true", help="float64")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def run(args) -> dict:
    from pdp_lqr_tpu_torch import mpc
    from pdp_lqr_tpu_torch.models import quadrotor
    from pdp_lqr_tpu_torch.solvers import admm

    dev = torch.device(args.device)
    dtype = torch.float64 if args.f64 else torch.float32
    problem, cone_specs = quadrotor(N=args.horizon, constrained=True,
                                    thrust_cone=args.thrust_cone,
                                    dtype=dtype, device=dev)
    cones = tuple(cone_specs or [])
    settings = admm.ADMMSettings(max_iter=100, rho_update_interval=25, rho=0.1)

    x0 = torch.zeros(problem.nx, dtype=dtype, device=dev)
    ws, state, info = admm.solve(problem, x0, cones, settings)
    print("cold solve:", info)

    # Closed loop: hover at z=1 from the ground.
    t0 = time.perf_counter()
    xs, us, infos = mpc.simulate(problem, x0, args.steps, cones, settings)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    xs, us = xs.cpu(), us.cpu()
    print(f"closed loop: {args.steps} replans in {wall*1e3:.1f} ms "
          f"({wall/args.steps*1e3:.2f} ms/replan, host clock, {dev.type})")
    print("final position:", xs[-1, :3].numpy(), "(target [0, 0, 1])")
    print("u range: [%.4f, %.4f]  (box [%.4f, %.4f])"
          % (us.min(), us.max(), *BOX))
    mean_iters = float(infos.iter_converged.double().mean())
    print("mean ADMM iterations to converge:", mean_iters)
    figures = {"final_position": xs[-1, :3].tolist(),
               "u_min": float(us.min()), "u_max": float(us.max()),
               "box": list(BOX), "mean_iterations": mean_iters,
               "cold_iterations": int(info.iter_converged),
               "cold_converged": bool(info.converged),
               "converged_replans": int(infos.converged.sum()),
               "steps": args.steps, "max_iter": settings.max_iter}
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
