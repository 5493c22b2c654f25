"""Speed-of-light report for the per-instance Riccati kernels, on the
PyTorch port.

The port's counterpart of ``examples/roofline_report.py``: times the
headline pair of ``cuda_riccati.solve_lanes`` on the quadrotor batch
(B=2048, N=512, float32) — K1 without closed-loop maps
(``backward_lanes(..., emit_closed_loop=False)``: the gains K, d) and K7
(``forward_rollout_lanes``: the rollout from the raw dynamics) — by CUDA
events, and sets each against its least time on one H100: the larger of
its bytes over the memory rate and its operations over the float32 rate
(``profiling.riccati_roofline`` for K1).  Two memory rates: the data
sheet's 3.35 TB/s (67 TFLOP/s float32 beside it), and the rate of a
device-to-device copy this example times on the card ("achievable").
The JSON it prints (one line) carries the card's name and power limit.

On ``--device cpu`` the kernels' plain versions run and nothing is timed:
the bounds are printed, the device times are "not measured".

Usage: python examples/torch_roofline_report.py [--batch B] [--horizon N]
       [--reps R] [--device cpu]
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import argparse
import dataclasses
import json
import subprocess

import numpy as np
import torch

COPY_BYTES = 1 << 30          # the achievable-rate copy: 1 GiB each way


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--horizon", type=int, default=512)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def quadrotor_batch(batch: int, N: int, device, dtype=torch.float32):
    """The constrained quadrotor, one copy a scenario with its own drift
    (c + 0.01 N(0, 1)), rho 0.01 on the constraint rows, x0 0.1 N(0, 1):
    numpy, seed 0 (the JAX package's bench batch)."""
    import pdp_lqr_tpu_torch as plt_
    from pdp_lqr_tpu_torch.models import quadrotor

    problem, _ = quadrotor(N=N, constrained=True, dtype=dtype, device=device)
    rng = np.random.default_rng(0)
    tile = lambda x: x.expand((batch,) + x.shape)
    bp = plt_.LQRProblem(**{f.name: tile(getattr(problem, f.name))
                            for f in dataclasses.fields(problem)})
    c = bp.c + torch.as_tensor(rng.normal(size=(batch, N, problem.nx)) * 0.01
                               ).to(device=device, dtype=dtype)
    bp = dataclasses.replace(bp, c=c)
    its = plt_.init_iterates(bp, rho=0.01)
    x0 = torch.as_tensor(rng.normal(size=(batch, problem.nx)) * 0.1
                         ).to(device=device, dtype=dtype)
    return bp, its, x0


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def event_ms(fn, reps):
    """Median ms of ``fn`` by CUDA events, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def forward_roofline(N, nx, nu, B, dtype_bytes=4, bytes_per_s=3.35e12,
                     flops_per_s=67e12):
    """K7's bounds: (A, B, c, K, d, x0) in, (ws, xN) out; the matvecs."""
    words = (nx * nx + nx * nu + nx + nu * nx + nu) + (nx + nu)
    bytes_total = words * N * B * dtype_bytes
    flops = 2 * (nx * nx + 2 * nu * nx) * N * B
    return {"bytes_per_batched_solve": bytes_total,
            "flops_per_batched_solve": flops,
            "t_mem_ms": bytes_total / bytes_per_s * 1e3,
            "t_compute_ms": flops / flops_per_s * 1e3}


def run(args) -> dict:
    from pdp_lqr_tpu_torch.ops import cuda_riccati as cr
    from pdp_lqr_tpu_torch.utils import profiling

    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    B, N = args.batch, args.horizon
    problem, its, x0 = quadrotor_batch(B, N, dev)
    nx, nu, nc = problem.nx, problem.nu, problem.nc
    A, Bm, c, H, h, D, rho, rg, PN, pN, x0_l, _ = cr.prepare_lanes(
        problem, its, x0, 1e-6)
    bw = lambda: cr.backward_lanes(A, Bm, c, H, h, D, rho, rg, PN, pN,
                                   emit_closed_loop=False)
    K, d = bw()
    fw = lambda: cr.forward_rollout_lanes(A, Bm, c, K, d, x0_l)
    ws, xN = fw()

    if on_card:
        t_bw, t_fw = event_ms(bw, args.reps), event_ms(fw, args.reps)
        src = torch.empty(COPY_BYTES // 4, dtype=torch.float32, device=dev)
        dst = torch.empty_like(src)
        copy_ms = event_ms(lambda: dst.copy_(src), args.reps)
        achievable = 2 * COPY_BYTES / (copy_ms * 1e-3)       # read + write
        card = card_line()
    else:
        t_bw = t_fw = achievable = None
        card = None

    roof = profiling.riccati_roofline(N, nx, nu, nc, B)
    roof_fw = forward_roofline(N, nx, nu, B)

    def entry(bounds, t_ms):
        spec = max(bounds["t_mem_ms"], bounds["t_compute_ms"])
        out = {"bytes": bounds["bytes_per_batched_solve"],
               "flops": bounds["flops_per_batched_solve"],
               "bound_ms_spec": spec,
               "bound": ("memory" if bounds["t_mem_ms"] >= bounds["t_compute_ms"]
                         else "compute"),
               "measured_ms": t_ms if t_ms is not None else "not measured"}
        if t_ms is not None:
            ach = max(bounds["bytes_per_batched_solve"] / achievable * 1e3,
                      bounds["t_compute_ms"])
            out.update(bound_ms_achievable=ach,
                       utilization_pct_spec=100 * spec / t_ms,
                       utilization_pct_achievable=100 * ach / t_ms,
                       memory_utilization_pct_spec=100 * bounds["t_mem_ms"] / t_ms,
                       compute_utilization_pct=100 * bounds["t_compute_ms"] / t_ms)
        return out

    figures = {
        "shape": f"quadrotor N={N} B={B} float32",
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "card": card,
        "memory_rates_bytes_per_s": {
            "spec": profiling.PEAK_BYTES_PER_S,
            "measured_achievable": achievable if on_card else "not measured"},
        "f32_flops_per_s_spec": profiling.PEAK_F32_FLOPS,
        "backward": entry(roof, t_bw),
        "forward": entry(roof_fw, t_fw),
        "ws_finite": bool(torch.isfinite(ws).all() and torch.isfinite(xN).all()),
    }
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
