"""Profiling / observability helpers (PyTorch port of
``pdp_lqr_tpu/utils/profiling.py``).

Reference status: tracing is vestigial there — a fully commented-out
Tracy client (CMakeLists.txt:24-32,67; lqr_solver_parallel.hpp:10,143)
and example-level wall-clock prints (lqr_example.cpp:178-185).  Here the
same needs are served by ``torch.profiler`` traces, a timing harness on
CUDA events, and a roofline model of the matrix sweep against one H100's
published peaks.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from typing import Callable

import torch

# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory
# rate and the float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


@contextlib.contextmanager
def trace(log_dir: str = "pdp_lqr_trace"):
    """Profile the block with ``torch.profiler`` (host and, where a card is
    present, device activity); yields the profiler (``key_averages()``)
    and writes ``log_dir/trace.json`` (Chrome / Perfetto) on exit."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@dataclass
class Timing:
    compile_s: float
    p50_ms: float
    mean_ms: float
    iters: int
    device: str

    def __repr__(self):
        return (f"Timing(first={self.compile_s:.2f}s, "
                f"p50={self.p50_ms:.3f}ms, mean={self.mean_ms:.3f}ms, "
                f"{self.device})")


def time_fn(fn: Callable, *args, iters: int = 20, warmup: int = 1,
            device="cuda") -> Timing:
    """Time ``fn(*args)``: the first call (kernel builds included) on the
    host clock after a synchronize, then per-call p50 / mean.

    On ``device="cuda"`` each call is timed by CUDA events on the current
    stream (the card's clock; a call that waits on the host shows as the
    card's idle time between the events); ``device="cpu"`` times on the
    host clock.
    """
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t0 = time.perf_counter()
    fn(*args)
    sync()
    compile_s = time.perf_counter() - t0
    for _ in range(max(0, warmup - 1)):
        fn(*args)
    sync()
    samples = []
    for _ in range(iters):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn(*args)
            samples.append((time.perf_counter() - t0) * 1e3)
    samples.sort()
    return Timing(compile_s=compile_s, p50_ms=samples[len(samples) // 2],
                  mean_ms=sum(samples) / len(samples), iters=iters,
                  device=str(dev))


def riccati_roofline(N: int, nx: int, nu: int, nc: int, B: int,
                     dtype_bytes: int = 4,
                     bytes_per_s: float = PEAK_BYTES_PER_S,
                     flops_per_s: float = PEAK_F32_FLOPS,
                     closed_loop: bool = False):
    """Analytic bounds for the batched matrix sweep on one H100.

    Returns dict with bytes/solve, flops/solve, and the memory/compute
    time bounds — how far measured numbers sit from speed-of-light.

    ``closed_loop`` models the (M, v)-emitting sweep; the gains-only
    form emits (K, d) only.
    """
    nz = nx + nu
    words_per_stage = (
        nx * nx + nx * nu + nx          # A, B, c
        + nz * nz + nz                  # H, h
        + nc * nz + 2 * nc              # D, rho, rg
    )
    out_words = nu * nx + nu             # K, d
    if closed_loop:
        out_words += nx * nx + nx        # M, v
    bytes_total = (words_per_stage + out_words) * N * B * dtype_bytes

    fold = nc * nz * (nz + 1)
    # Symmetric products (P+, Huu) are counted triangle-only.
    tri_x = nx * (nx + 1) // 2
    tri_u = nu * (nu + 1) // 2
    matmuls = (
        nx ** 3 + nx * nx * nu          # PA, PB
        + nu * nx * nx                  # G = S + B^T PA
        + tri_x * (nx + nu)             # P+ upper: A^T PA + G^T K
        + tri_u * nx                    # Huu lower: R + B^T PB
    )
    if closed_loop:
        matmuls += nx * nu * nx          # M = A + B K
    chol = nu ** 3 // 3 + (nx + 1) * nu * nu
    vecs = 6 * nx * nx
    flops_total = 2 * (fold + matmuls + chol + vecs) * N * B

    t_mem = bytes_total / bytes_per_s
    t_compute = flops_total / flops_per_s
    return {
        "bytes_per_batched_solve": bytes_total,
        "flops_per_batched_solve": flops_total,
        "t_mem_ms": t_mem * 1e3,
        "t_compute_ms": t_compute * 1e3,
        "bound": "compute" if t_compute > t_mem else "memory",
    }


def failure_mask(ws) -> torch.Tensor:
    """Per-instance non-finite detection (no host read).

    The reference signals numeric failure by a bool return the caller
    ignores (condensed_system.hpp:217-226 vs lqr_solver_parallel.hpp:145)
    or a throw (qdldl_solver.hpp:106-108); here failures surface as NaN
    and are reduced to a (B,) mask the caller batches over.
    """
    return ~torch.isfinite(ws).reshape(ws.shape[0], -1).all(dim=1)
