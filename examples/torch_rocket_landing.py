"""Rocket soft-landing: two-cone conic MPC end to end, on the PyTorch port.

The port's counterpart of ``examples/rocket_landing.py`` (models/rocket.py:
thrust gimbal SOC + glideslope SOC + thrust box), driven three ways:

  1. a single optimal descent (``admm.solve``), with a feasibility report
     (``quality.assess``);
  2. a Monte-Carlo entry dispersion through the fused batch loop
     (``solve_fused``, ``single_kernel="auto"``: the single-kernel
     iteration K8 on the card): the landing footprint and landings/s;
  3. closed-loop MPC under wind (``mpc.simulate``): warm-started replans
     and their iterations to converge.

float32 and B=512 on the card, float64 and B=8 on the CPU (as the JAX
example on its accelerator and on the CPU).  The last line is the
figures as JSON.

Usage: python examples/torch_rocket_landing.py [--horizon N] [--batch B]
       [--steps T] [--iters R] [--device cpu]
"""

from __future__ import annotations

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import argparse
import json
import time

import numpy as np
import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--horizon", type=int, default=48)
    ap.add_argument("--batch", type=int, default=None,
                    help="Monte-Carlo batch (default 512 on the card, 8 CPU)")
    ap.add_argument("--steps", type=int, default=30,
                    help="closed-loop MPC steps")
    ap.add_argument("--iters", type=int, default=5,
                    help="timing repetitions for the batch section")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


SETTINGS = dict(max_iter=150, rho=1.0, rho_update_interval=10,
                eps_abs=1e-4, eps_rel=1e-3)
MPC_SETTINGS = dict(SETTINGS, max_iter=80)
WIND_SCALE = (0, 0, 0, .08, .08, .04)


def wind(steps: int):
    """The closed loop's process noise (numpy, seed 3)."""
    rng = np.random.default_rng(3)
    return rng.normal(size=(steps, 6)) * np.array(WIND_SCALE)


def run(args) -> dict:
    import pdp_lqr_tpu_torch as plt_
    from pdp_lqr_tpu_torch import mpc
    from pdp_lqr_tpu_torch.models import rocket, rocket_x0
    from pdp_lqr_tpu_torch.solvers import admm
    from pdp_lqr_tpu_torch.utils import quality

    dev = torch.device(args.device)
    on_cpu = dev.type == "cpu"
    dtype = torch.float64 if on_cpu else torch.float32
    N = args.horizon
    B = args.batch if args.batch is not None else (8 if on_cpu else 512)
    sync = (lambda: None) if on_cpu else torch.cuda.synchronize

    problem, cones = rocket(N=N, dtype=dtype, device=dev)
    cones = tuple(cones)
    settings = admm.ADMMSettings(**SETTINGS)

    # ---- 1. single instance ---------------------------------------------
    x0 = rocket_x0(dtype=dtype, device=dev)
    ws, _, info = admm.solve(problem, x0, cones, settings)
    q = quality.assess(problem, ws, cones)
    xs = ws[:, 3:].cpu()
    single = {"converged": bool(info.converged),
              "iter_converged": int(info.iter_converged),
              "touchdown_pos_err_m": float(xs[-1, :3].norm()),
              "touchdown_vertical_vel": float(xs[-1, 5]),
              "cone_violation": float(q.cone_violation),
              "box_violation": float(q.box_violation)}
    print(f"single descent: converged={single['converged']} "
          f"in {single['iter_converged']} iters | touchdown pos err "
          f"{single['touchdown_pos_err_m']:.2e} m, vertical vel "
          f"{single['touchdown_vertical_vel']:.3f} m/s | cone violation "
          f"{single['cone_violation']:.2e}, box violation "
          f"{single['box_violation']:.2e}")

    # ---- 2. Monte-Carlo entry dispersion (fused batch) ------------------
    bp = plt_.LQRProblem(**{name: x.expand((B,) + x.shape) for name, x in (
        (f, getattr(problem, f)) for f in problem.__dataclass_fields__)})
    x0s = rocket_x0(batch=B, dtype=dtype, device=dev)
    fused = lambda: plt_.solve_fused(bp, x0s, cones, settings)[0]
    wsb = fused()
    sync()
    if not bool(torch.isfinite(wsb).all()):
        raise RuntimeError("dispersion batch: non-finite trajectory")
    t0 = time.perf_counter()
    for _ in range(args.iters):
        wsb = fused()
    sync()
    dt_s = (time.perf_counter() - t0) / args.iters
    land = wsb[:, -1, 3:].cpu()
    r_err = land[:, :3].norm(dim=1)
    disp = {"B": B, "footprint_p50_m": float(np.median(r_err.numpy())),
            "footprint_max_m": float(r_err.max()),
            "vertical_vel_worst": float(land[:, 5].min()),
            "landings_per_s": B / dt_s}
    print(f"dispersion batch B={B}: footprint p50 {disp['footprint_p50_m']:.2e}"
          f" m, max {disp['footprint_max_m']:.2e} m | vertical vel worst "
          f"{disp['vertical_vel_worst']:.3f} m/s | {disp['landings_per_s']:.0f}"
          f" landings/s ({settings.max_iter} ADMM iters each; host clock)")

    # ---- 3. closed-loop MPC under wind ----------------------------------
    noise = torch.as_tensor(wind(args.steps)).to(device=dev, dtype=dtype)
    xs_cl, _, infos = mpc.simulate(problem, x0, args.steps, cones,
                                   admm.ADMMSettings(**MPC_SETTINGS),
                                   process_noise=noise)
    xs_cl = xs_cl.cpu()
    iters = infos.iter_converged.cpu()
    loop = {"altitude_start": float(xs_cl[0, 2]),
            "altitude_end": float(xs_cl[-1, 2]),
            "lateral_start": float(xs_cl[0, :2].norm()),
            "lateral_end": float(xs_cl[-1, :2].norm()),
            "warm_iters_p50": int(np.median(iters[1:].numpy()))
            if args.steps > 1 else None,
            "cold_iters": int(iters[0])}
    print(f"closed loop ({args.steps} steps, wind): altitude "
          f"{loop['altitude_start']:.1f} -> {loop['altitude_end']:.1f} m, "
          f"lateral {loop['lateral_start']:.1f} -> {loop['lateral_end']:.1f} m"
          f" | warm replans converged in p50 {loop['warm_iters_p50']} iters "
          f"(cold start {loop['cold_iters']})")
    figures = {"dtype": str(dtype).split(".")[-1], "single": single,
               "dispersion": disp, "closed_loop": loop}
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
