"""Sequential Riccati solver — reference ``LQRSolver`` (lqr_solver.hpp).

Counterpart of ``pdp_lqr_tpu/solvers/sequential.py``: a facade over
``ops.riccati``.  The functions take a single problem or, with one more
leading axis on every tensor, a batch (``solve_batched``).
"""

from __future__ import annotations

from pdp_lqr_tpu_torch.ops import riccati
from pdp_lqr_tpu_torch.problem import (
    ADMMIterates,
    LQRProblem,
    make_stage_params,
)

RiccatiFactors = riccati.RiccatiFactors

update_problem_data = make_stage_params
backward = riccati.backward
backward_without_factorization = riccati.backward_no_refactor
forward = riccati.forward


def solve(problem: LQRProblem, it: ADMMIterates, x0, sigma: float):
    """update_problem_data + backward + forward in one call.

    Returns (ws, factors): ws is the (N+1, nz) trajectory [u_k; x_k].
    """
    params = make_stage_params(problem, it, sigma)
    factors = riccati.backward(problem, params, it.rho)
    ws = riccati.forward(problem, factors, x0)
    return ws, factors


def resolve(problem: LQRProblem, it: ADMMIterates, x0, sigma: float,
            factors: RiccatiFactors):
    """Re-solve with cached factors (rho/sigma unchanged) — the ADMM
    steady-state fast path (lqr_solver.hpp:65-70)."""
    params = make_stage_params(problem, it, sigma)
    factors = riccati.backward_no_refactor(problem, params, it.rho, factors)
    ws = riccati.forward(problem, factors, x0)
    return ws, factors


def solve_batched(problem: LQRProblem, it: ADMMIterates, x0, sigma: float):
    """``solve`` over a leading batch axis on every field of ``problem``
    and ``it`` and on ``x0`` (sigma shared)."""
    if problem.A.ndim != 4:
        raise ValueError("solve_batched takes a batched problem (B, N, ...)")
    return solve(problem, it, x0, sigma)
