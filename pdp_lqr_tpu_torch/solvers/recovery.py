"""Non-SPD failure recovery: masked regularization bump-and-retry
(PyTorch port of ``pdp_lqr_tpu/solvers/recovery.py``).

The reference merely *signals* factorization failure — the Cholesky
condensed solver returns false (condensed_system.hpp:217-226) and its
caller ignores it (lqr_solver_parallel.hpp:145); QDLDL throws
(qdldl_solver.hpp:106-108).  Here failures surface per instance as NaNs
(utils.profiling.failure_mask: a negative pivot is NaN in every backend,
the CUDA matrix sweep's reciprocal square root included) and this module
RECOVERS them: one fixed-shape re-solve of the whole batch with a
per-instance regularization bump folded into H, merged back only on
failed lanes.

No host read and no data-dependent shape: the retry always runs the full
batch (a failed lane costs one extra solve of everything, amortized to ~0
when failures are rare), and healthy lanes keep their ORIGINAL results
bit for bit through ``torch.where``.
"""

from __future__ import annotations

import dataclasses

import torch

from pdp_lqr_tpu_torch.utils.profiling import failure_mask


@dataclasses.dataclass(frozen=True)
class RecoveryInfo:
    """failed: (B,) instances that failed the FIRST solve;
    recovered: failed then finite after retries;
    still_failed: non-finite even after all retries;
    bump: (B,) the regularization actually added per instance."""

    failed: torch.Tensor
    recovered: torch.Tensor
    still_failed: torch.Tensor
    bump: torch.Tensor


def solve_with_recovery(solve_batched_fn, problem, it, x0, sigma,
                        *, sigma_bump: float = 1e-4, retries: int = 1):
    """Run a batched inner solve with masked bump-and-retry.

    ``solve_batched_fn(problem, it, x0, sigma) -> ws (B, N+1, nz)`` is any
    batched entry (``sequential.solve_batched(...)[0]``,
    ``dense.solve_batched(...)[0]``, ``cuda_riccati.solve_lanes``).  On
    instances whose output is non-finite, ``sigma_bump`` (escalated x10
    per retry) is folded into that instance's H diagonal and ONE
    fixed-shape re-solve of the whole batch runs; only failed lanes take
    the new result.

    Returns (ws, RecoveryInfo).
    """
    ws = solve_batched_fn(problem, it, x0, sigma)
    failed0 = failure_mask(ws)
    dt, dev = problem.H.dtype, problem.H.device
    Bb = ws.shape[0]
    eye = torch.eye(problem.H.shape[-1], dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    bump_applied = torch.zeros((Bb,), dtype=dt, device=dev)

    bump = float(sigma_bump)
    for _ in range(max(0, retries)):
        fail = failure_mask(ws)
        add = torch.where(fail, torch.full((), bump, dtype=dt, device=dev),
                          zero)
        pb = dataclasses.replace(
            problem, H=problem.H + add[:, None, None, None] * eye)
        ws_retry = solve_batched_fn(pb, it, x0, sigma)
        # Healthy lanes keep their ORIGINAL result bit-identically.
        ws = torch.where(fail[:, None, None], ws_retry, ws)
        bump_applied = torch.where(fail, add, bump_applied)
        bump *= 10.0
    still = failure_mask(ws)
    return ws, RecoveryInfo(
        failed=failed0,
        recovered=failed0 & ~still,
        still_failed=still,
        bump=bump_applied,
    )
