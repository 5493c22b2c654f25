"""Block-tridiagonal KKT solver — reference ``QDLDLSolver`` re-designed;
PyTorch port of ``pdp_lqr_tpu/solvers/kkt.py``.

Reference: include/clqr/lqr/qdldl_solver.hpp (general sparse LDL^T via
QDLDL over the assembled kkt.hpp matrix).  Here the same linear system is
solved by a batched block-Thomas factorization over dense stage blocks
(see ops/kkt_block.py): static structure, no symbolic phase.

The reference's update_problem_data -> backward (numeric factor) ->
forward (substitution) lifecycle (qdldl_solver.hpp:80-151) as functions.
``rho_dyn`` is the dynamics-row regularization the reference hardwires to
1e-6 (qdldl_solver.hpp:40); pass 0.0 for an exact (Riccati-equal) solve.
"""

from __future__ import annotations

from pdp_lqr_tpu_torch.ops import kkt_block
from pdp_lqr_tpu_torch.problem import ADMMIterates, LQRProblem, make_stage_params

KKTFactors = kkt_block.KKTFactors

DEFAULT_RHO_DYN = 1e-6  # qdldl_solver.hpp:40


def backward(problem: LQRProblem, params, rho, rho_dyn: float = DEFAULT_RHO_DYN):
    """Assemble + numeric factor (QDLDL_factor analog)."""
    D, E = kkt_block.build_blocks(problem, params, rho, rho_dyn)
    return kkt_block.factorize(D, E)


def forward(problem: LQRProblem, params, rho, factors: KKTFactors, x0):
    """Substitution with cached factors (QDLDL_solve analog)."""
    rhs = kkt_block.build_rhs(problem, params, rho, x0)
    v = kkt_block.solve_cached(factors, rhs)
    return kkt_block.extract_ws(v, problem, x0)


def duals(problem: LQRProblem, it: ADMMIterates, x0, sigma: float,
          rho_dyn: float = DEFAULT_RHO_DYN):
    """Solve and return (ws, lambdas, ys): primal trajectory, dynamics
    duals lambda_1..N, and per-row constraint duals y (the reference KKT
    solution ordering qdldl_solver.hpp:112-140 exposes all three)."""
    params = make_stage_params(problem, it, sigma)
    fac = backward(problem, params, it.rho, rho_dyn)
    rhs = kkt_block.build_rhs(problem, params, it.rho, x0)
    v = kkt_block.solve_cached(fac, rhs)
    ws = kkt_block.extract_ws(v, problem, x0)
    lams = kkt_block.extract_lambdas(v, problem)
    ys = kkt_block.extract_constraint_duals(ws, problem, params, it.rho)
    return ws, lams, ys


def solve(problem: LQRProblem, it: ADMMIterates, x0, sigma: float,
          rho_dyn: float = DEFAULT_RHO_DYN):
    """update_problem_data + factor + solve in one call."""
    params = make_stage_params(problem, it, sigma)
    factors = backward(problem, params, it.rho, rho_dyn)
    return forward(problem, params, it.rho, factors, x0), factors


def resolve(problem: LQRProblem, it: ADMMIterates, x0, sigma: float,
            factors: KKTFactors):
    """Re-solve with cached numeric factors (rho/sigma unchanged): only
    the rhs changes, the fast path the reference reaches by skipping
    QDLDL_factor."""
    params = make_stage_params(problem, it, sigma)
    return forward(problem, params, it.rho, factors, x0), factors


def solve_batched(problem: LQRProblem, it: ADMMIterates, x0, sigma: float,
                  rho_dyn: float = DEFAULT_RHO_DYN):
    """``solve`` over a leading batch axis on every field of ``problem``
    and ``it`` and on ``x0`` (sigma and rho_dyn shared)."""
    if problem.A.ndim != 4:
        raise ValueError("solve_batched takes a batched problem (B, N, ...)")
    return solve(problem, it, x0, sigma, rho_dyn)
