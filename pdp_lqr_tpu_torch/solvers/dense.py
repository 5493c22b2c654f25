"""Dense P-form Riccati solver — PyTorch port of ``pdp_lqr_tpu/solvers/dense.py``.

Same math as solvers.sequential (reference lqr_solver.hpp) carried in
P-form with a solve-free rollout; see ops/riccati_dense.py.  The
functions take a single problem or, with one more leading axis on every
tensor, a batch (``solve_batched``).
"""

from __future__ import annotations

from pdp_lqr_tpu_torch.ops import riccati_dense
from pdp_lqr_tpu_torch.problem import ADMMIterates, LQRProblem, make_stage_params

DenseFactors = riccati_dense.DenseFactors

update_problem_data = make_stage_params
backward = riccati_dense.backward
backward_without_factorization = riccati_dense.backward_no_refactor
forward = riccati_dense.forward


def solve(problem: LQRProblem, it: ADMMIterates, x0, sigma: float):
    params = make_stage_params(problem, it, sigma)
    factors = riccati_dense.backward(problem, params, it.rho)
    ws = riccati_dense.forward(problem, factors, x0)
    return ws, factors


def resolve(problem: LQRProblem, it: ADMMIterates, x0, sigma: float,
            factors: DenseFactors):
    params = make_stage_params(problem, it, sigma)
    factors = riccati_dense.backward_no_refactor(problem, params, it.rho,
                                                 factors)
    ws = riccati_dense.forward(problem, factors, x0)
    return ws, factors


def solve_batched(problem: LQRProblem, it: ADMMIterates, x0, sigma: float):
    """``solve`` over a leading batch axis on every field of ``problem``
    and ``it`` and on ``x0`` (sigma shared)."""
    if problem.A.ndim != 4:
        raise ValueError("solve_batched takes a batched problem (B, N, ...)")
    return solve(problem, it, x0, sigma)
