"""PDP parallel Riccati solver — reference ``LQRParallelSolver``; PyTorch
port of ``pdp_lqr_tpu/solvers/pdp.py``.

The segments run as a leading axis of batched torch operations (the
reference forks one OpenMP thread per segment,
lqr_solver_parallel.hpp:156-162); the condensed boundary system is solved
by either of the reference's factorizations (``CondensedSolverType``).

Exactness: the PDP decomposition is algebraically exact — for matching
rho/sigma it returns the same trajectory as the sequential solver up to
roundoff, which the reference checks by printing both
(lqr_example.cpp:206-221).
"""

from __future__ import annotations

import dataclasses

from pdp_lqr_tpu_torch.config import CondensedSolverType
from pdp_lqr_tpu_torch.ops import condensed, riccati_pdp
from pdp_lqr_tpu_torch.problem import ADMMIterates, LQRProblem, make_stage_params

PDPFactors = riccati_pdp.PDPFactors


def backward(problem: LQRProblem, params, rho, num_segments: int,
             solver_type: CondensedSolverType = CondensedSolverType.CHOLESKY,
             ) -> PDPFactors:
    """Segment reduction + condensed backward.

    Reference: LQRParallelSolver::backward (lqr_solver_parallel.hpp:142-146).
    """
    L, lp, G, Fnext, P0, F0, C0, p0, f0, (LxxN, _) = (
        riccati_pdp.segment_reduction(problem, params, rho, num_segments))
    if solver_type == CondensedSolverType.CHOLESKY:
        fac = condensed.cholesky_backward(P0, F0, C0)
    else:
        fac = condensed.lu_backward(P0, F0, C0)
    return PDPFactors(L=L, lp=lp, G=G, Fnext=Fnext, P0=P0, F0=F0, C0=C0,
                      p0=p0, f0=f0, LxxN=LxxN, condensed=fac)


def backward_without_factorization(problem: LQRProblem, params, rho,
                                   factors: PDPFactors) -> PDPFactors:
    """Vector-only backward reusing all cached matrix factors.

    Reference: LQRParallelSolver::backward_without_factorization
    (lqr_solver_parallel.hpp:148-154) — it does NOT re-run the condensed
    matrix factorization, only updates (p, c) per segment (:207-210).
    """
    lp, p0, f0, _ = riccati_pdp.segment_reduction_no_refactor(
        problem, params, rho, factors)
    return dataclasses.replace(factors, lp=lp, p0=p0, f0=f0)


def forward(problem: LQRProblem, factors: PDPFactors, x0):
    """Condensed forward (boundary states/duals) + parallel rollout.

    Reference: LQRParallelSolver::forward (lqr_solver_parallel.hpp:213-238).
    """
    fac = factors.condensed
    if isinstance(fac, condensed.CholeskyCondensedFactors):
        xhat, uhat = condensed.cholesky_forward(fac, factors.p0, factors.f0, x0)
    else:
        xhat, uhat = condensed.lu_forward(fac, factors.p0, factors.f0, x0)
    return riccati_pdp.segment_rollout(problem, factors.L, factors.lp,
                                       factors.G, xhat, uhat)


def solve(problem: LQRProblem, it: ADMMIterates, x0, sigma: float,
          num_segments: int = 4,
          solver_type: CondensedSolverType = CondensedSolverType.CHOLESKY):
    """update_problem_data + backward + forward in one call."""
    params = make_stage_params(problem, it, sigma)
    factors = backward(problem, params, it.rho, num_segments, solver_type)
    return forward(problem, factors, x0), factors


def resolve(problem: LQRProblem, it: ADMMIterates, x0, sigma: float,
            factors: PDPFactors):
    """Re-solve with cached factors (rho/sigma unchanged)."""
    params = make_stage_params(problem, it, sigma)
    factors = backward_without_factorization(problem, params, it.rho, factors)
    return forward(problem, factors, x0), factors


def solve_batched(problem: LQRProblem, it: ADMMIterates, x0, sigma: float,
                  num_segments: int = 4,
                  solver_type: CondensedSolverType = CondensedSolverType.CHOLESKY):
    """``solve`` over a leading batch axis on every field of ``problem``
    and ``it`` and on ``x0`` (sigma, segments and solver type shared)."""
    if problem.A.ndim != 4:
        raise ValueError("solve_batched takes a batched problem (B, N, ...)")
    return solve(problem, it, x0, sigma, num_segments, solver_type)
