"""Quadrotor MPC four-solver cross-check on the PyTorch port.

The port's counterpart of ``examples/lqr_example.py`` (itself a port of the
reference's examples/lqr_example.cpp): build the quadrotor problem (nx=12,
nu=4, N=100), run it through the reference-shaped classes of
``pdp_lqr_tpu_torch`` — the block KKT (``QDLDLSolver``), sequential
Riccati (``LQRSolver``), PDP-parallel (``LQRParallelSolver``, 4 segments)
and associative-scan (``AssociativeScanSolver``) solvers — time each
lifecycle (update_problem_data + backward + forward), and print the first
5 inputs and the final state of each for comparison.

On the card (the default) a solve is timed by CUDA events, on the CPU by
the host clock; float32 unless ``--f64``.

Usage: python examples/torch_lqr_example.py [--horizon N] [--f64]
       [--device cpu]
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import argparse
import json

import numpy as np
import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--horizon", type=int, default=100)
    ap.add_argument("--f64", action="store_true", help="float64")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device; pass --device cpu", file=sys.stderr)
        return 1
    run(args)
    return 0


def run(args) -> dict:
    """Run the four solvers; returns (and prints as the last line, JSON)
    each one's first 5 inputs u[0:5, 0] and final state x[N]."""
    dev = torch.device(args.device)
    import pdp_lqr_tpu_torch as plt_
    from pdp_lqr_tpu_torch.models import quadrotor
    from pdp_lqr_tpu_torch.utils import profiling

    dtype = torch.float64 if args.f64 else torch.float32
    problem, _ = quadrotor(N=args.horizon, dtype=dtype, device=dev)
    it = plt_.init_iterates(problem, rho=0.01)       # lqr_example.cpp:170
    x0 = torch.zeros(problem.nx, dtype=dtype, device=dev)
    sigma = 1e-6                                      # lqr_example.cpp:171
    figures = {}

    def bench(name, solver):
        def lifecycle():
            solver.update_problem_data(it.w, it.y, it.z, it.rho, sigma)
            return solver.backward().forward(x0)

        t = profiling.time_fn(lifecycle, iters=10, device=dev)
        ws = lifecycle().detach().cpu().numpy()
        print(f"=== {name} ===  ({t.p50_ms:.3f} ms/solve, {t.device})")
        print("u[0:5,0] :", np.array2string(ws[:5, 0], precision=6))
        print("x[N]     :", np.array2string(ws[-1, problem.nu:], precision=6))
        figures[name] = {"u0": ws[:5, 0].tolist(),
                         "xN": ws[-1, problem.nu:].tolist()}
        return ws

    ws_kkt = bench("QDLDL-analog block KKT",
                   plt_.QDLDLSolver(problem, rho_dyn=1e-6, device=dev))
    ws_seq = bench("sequential Riccati", plt_.LQRSolver(problem, device=dev))
    ws_pdp = bench("PDP parallel Riccati (4 segments)",
                   plt_.LQRParallelSolver(problem, num_segments=4,
                                          device=dev))
    ws_asc = bench("associative-scan Riccati (log-depth)",
                   plt_.AssociativeScanSolver(problem, device=dev))

    tol = 1e-6 if args.f64 else 1e-3
    for name, ws in [("pdp", ws_pdp), ("assoc", ws_asc)]:
        err = np.abs(ws - ws_seq).max()
        print(f"max |{name} - seq| = {err:.2e}")
        if err >= tol:
            raise RuntimeError(f"{name} disagrees with sequential ({err:.2e})")
    err = np.abs(ws_kkt - ws_seq).max()
    print(f"max |kkt - seq|   = {err:.2e}  (rho_dyn=1e-6 regularization)")
    print(json.dumps(figures))
    return figures


if __name__ == "__main__":
    sys.exit(main())
