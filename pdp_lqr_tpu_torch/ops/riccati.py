"""Sequential Riccati recursion in plain PyTorch — the port's own witness.

Counterpart of ``pdp_lqr_tpu/ops/riccati.py`` (reference math:
include/clqr/lqr/lqr_kernel.hpp and lqr_solver.hpp).  The scan over
stages is a Python loop; the value function is carried in
Cholesky-factored (square-root) form ``P = Lxx Lxx^T`` exactly like the
reference.  It shares no code with the CUDA kernels of
``ops/cuda_riccati.py`` (which run the dense P-form), so it serves as the
independent check of the kernel path.

Every function takes tensors with any number of leading batch axes (the
JAX package lifts its single-problem functions with ``vmap``; here the
batch is written out), and runs on whatever device the tensors live on.
"""

from __future__ import annotations

import dataclasses

import torch

from pdp_lqr_tpu_torch.config import full_f32_matmul
from pdp_lqr_tpu_torch.ops import linalg
from pdp_lqr_tpu_torch.problem import LQRProblem, StageParams, _TensorRecord


@dataclasses.dataclass(frozen=True)
class RiccatiFactors(_TensorRecord):
    """Cached backward-pass results (the reference's workspace arrays).

    L:    (N, nz, nz)  stage Cholesky factors [Luu 0; Lxu Lxx]
    lp:   (N, nz)      stage vectors [lu; p] (lu already forward-solved,
                       matching lqr_kernel.hpp:145 solveInPlace)
    LxxN: (nx, nx)     terminal Cholesky factor of H~_N
    pN:   (nx,)        terminal linear term
    """

    L: torch.Tensor
    lp: torch.Tensor
    LxxN: torch.Tensor
    pN: torch.Tensor

    @property
    def Lxx_next(self) -> torch.Tensor:
        """Stacked Lxx_{k+1} for k = 0..N-1, shape (N, nx, nx)."""
        nu = self.L.shape[-1] - self.LxxN.shape[-1]
        return torch.cat(
            [self.L[..., 1:, nu:, nu:], self.LxxN[..., None, :, :]], dim=-3
        )

    @property
    def p_next(self) -> torch.Tensor:
        """Stacked p_{k+1} for k = 0..N-1, shape (N, nx)."""
        nu = self.L.shape[-1] - self.LxxN.shape[-1]
        return torch.cat([self.lp[..., 1:, nu:], self.pN[..., None, :]], dim=-2)


def _mv(M, v):
    """Batched matrix-vector product on the trailing axes."""
    return (M @ v[..., None])[..., 0]


def _solve_lower(L, b):
    return torch.linalg.solve_triangular(L, b[..., None], upper=False)[..., 0]


def _solve_lower_T(L, b):
    return torch.linalg.solve_triangular(
        L.transpose(-1, -2), b[..., None], upper=True)[..., 0]


def penalty_fold(H, h, D, rho, g):
    """Fold the ADMM constraint penalty into the stage cost.

    H += D^T diag(rho) D ;  h -= D^T (rho o g)
    Reference: lqr_kernel.hpp:106-112 (and :83-87 for the terminal).
    Padded constraint rows carry rho = 0 and drop out exactly.
    """
    if D.shape[-2] == 0:
        return H, h
    rhoD = rho[..., :, None] * D
    H = H + torch.einsum("...ci,...cj->...ij", D, rhoD)
    h = h - torch.einsum("...ci,...c->...i", D, rho * g)
    return H, h


def penalty_fold_vec(h, D, rho, g):
    """Vector-only penalty fold for the no-factorization fast path.

    Reference: lqr_kernel.hpp:152-155.
    """
    if D.shape[-2] == 0:
        return h
    return h - torch.einsum("...ci,...c->...i", D, rho * g)


def terminal_step_raw(Hxx, hx, Dx, rho_N, g):
    """Terminal backward step on raw terminal blocks.

    Reference: LQRKernel::terminal_step_with_factorization
    (lqr_kernel.hpp:79-91): fold penalty, Lxx = chol(H~), p = h~.
    """
    with full_f32_matmul():
        Hxx, hx = penalty_fold(Hxx, hx, Dx, rho_N, g)
        return linalg.cholesky(Hxx), hx


def terminal_step(params: StageParams, problem: LQRProblem, rho_N):
    """Terminal backward step with factorization (record front-end)."""
    nu = problem.nu
    return terminal_step_raw(
        params.H[..., -1, nu:, nu:], params.h[..., -1, nu:],
        problem.D[..., -1, :, nu:], rho_N, params.g[..., -1, :])


def backward_step(carry, stage):
    """One backward Riccati stage (with factorization).

    Reference: LQRKernel::step_with_factorization (lqr_kernel.hpp:103-147):
      fold penalty -> V = E^T Lxx+ -> M = H + V V^T -> L = chol(M)
      Pb = Lxx+ Lxx+^T c + p+ -> lp = h + E^T Pb
      lu = Luu^{-1} lp_u ;  p = lp_x - Lxu lu
    ``stage`` = (A, B, c, H, h, D, rho, g); returns ((Lxx, p), (L, lp)).
    """
    A, B, c, H, h, D, rho, g = stage
    with full_f32_matmul():
        H, h = penalty_fold(H, h, D, rho, g)
    return backward_step_folded(carry, (A, B, c, H, h))


def backward_step_folded(carry, stage):
    """One backward Riccati stage on penalty-folded data (the JAX
    package's scan body; here a function of batched tensors, any leading
    axes).  ``carry`` = (Lxx_{k+1}, p_{k+1}), ``stage`` = (A, B, c, H, h);
    returns ((Lxx_k, p_k), (L_k, lp_k)).

    Reference math: LQRKernel::step_with_factorization
    (lqr_kernel.hpp:121-146) minus the fold.
    """
    Lxx_next, p_next = carry
    A, B, c, H, h = stage
    nu = B.shape[-1]
    with full_f32_matmul():
        E = torch.cat([B, A], dim=-1)                 # (nx, nz), E = [B A]
        V = E.mT @ Lxx_next                           # (nz, nx)
        L = linalg.cholesky(H + V @ V.mT)
        Pb = _mv(Lxx_next, _mv(Lxx_next.mT, c)) + p_next
        lp = h + _mv(E.mT, Pb)
        lu = linalg.solve_lower(L[..., :nu, :nu], lp[..., :nu])
        p = lp[..., nu:] - _mv(L[..., nu:, :nu], lu)
    return (L[..., nu:, nu:], p), (L, torch.cat([lu, p], dim=-1))


def _vector_step(A, B, c, h, L, Lxx_next, p_next, nu):
    """The vector half of a backward stage (lqr_kernel.hpp:128-146):
    Pb = Lxx+ Lxx+^T c + p+ ; lp = h + E^T Pb ; lu = Luu^{-1} lp_u ;
    p = lp_x - Lxu lu."""
    E = torch.cat([B, A], dim=-1)
    Pb = _mv(Lxx_next, _mv(Lxx_next.transpose(-1, -2), c)) + p_next
    lp = h + _mv(E.transpose(-1, -2), Pb)
    lu = _solve_lower(L[..., :nu, :nu], lp[..., :nu])
    p = lp[..., nu:] - _mv(L[..., nu:, :nu], lu)
    return p, torch.cat([lu, p], dim=-1)


def backward(problem: LQRProblem, params: StageParams, rho) -> RiccatiFactors:
    """Full backward sweep with factorization.

    Reference: LQRSolver::backward (lqr_solver.hpp:58-63) and
    LQRKernel::step_with_factorization (lqr_kernel.hpp:103-147): the
    penalty fold runs once over all stages, then the terminal step and
    the reverse loop V = E^T Lxx+, M = H + V V^T, L = chol(M).
    ``rho`` is the stacked (N+1, nc) penalty vector.  An instance whose
    stage matrix is not positive definite gets NaN from that stage on (as
    the JAX package's Cholesky gives it); nothing raises.
    """
    with full_f32_matmul():
        Hf, hf = penalty_fold(params.H, params.h, problem.D, rho, params.g)
        nu = problem.nu
        LxxN = linalg.cholesky(Hf[..., -1, nu:, nu:])
        pN = hf[..., -1, nu:]
        Lxx, p = LxxN, pN
        Ls, lps = [], []
        for k in range(problem.N - 1, -1, -1):
            A, B = problem.A[..., k, :, :], problem.B[..., k, :, :]
            E = torch.cat([B, A], dim=-1)
            V = E.transpose(-1, -2) @ Lxx
            L = linalg.cholesky(Hf[..., k, :, :] + V @ V.transpose(-1, -2))
            p, lp = _vector_step(A, B, problem.c[..., k, :], hf[..., k, :],
                                 L, Lxx, p, nu)
            Lxx = L[..., nu:, nu:]
            Ls.append(L)
            lps.append(lp)
        return RiccatiFactors(
            L=torch.stack(Ls[::-1], dim=-3), lp=torch.stack(lps[::-1], dim=-2),
            LxxN=LxxN, pN=pN,
        )


def backward_no_refactor(problem: LQRProblem, params: StageParams, rho,
                         factors: RiccatiFactors) -> RiccatiFactors:
    """Backward sweep reusing cached Cholesky factors (vector work only).

    Reference: LQRSolver::backward_without_factorization
    (lqr_solver.hpp:65-70) + LQRKernel::step_without_factorization
    (lqr_kernel.hpp:149-178).  Valid when rho and sigma are unchanged
    since the factoring sweep.
    """
    with full_f32_matmul():
        nu = problem.nu
        hf = penalty_fold_vec(params.h, problem.D, rho, params.g)
        pN = hf[..., -1, nu:]
        Lxx_next = factors.Lxx_next
        p = pN
        lps = []
        for k in range(problem.N - 1, -1, -1):
            p, lp = _vector_step(
                problem.A[..., k, :, :], problem.B[..., k, :, :],
                problem.c[..., k, :], hf[..., k, :], factors.L[..., k, :, :],
                Lxx_next[..., k, :, :], p, nu)
            lps.append(lp)
        return RiccatiFactors(L=factors.L, lp=torch.stack(lps[::-1], dim=-2),
                              LxxN=factors.LxxN, pN=pN)


def forward(problem: LQRProblem, factors: RiccatiFactors, x0) -> torch.Tensor:
    """Forward rollout: u_k = -Luu^{-T}(lu + Lxu^T x_k); x_{k+1} = A x + B u + c.

    Reference: LQRSolver::forward (lqr_solver.hpp:72-77) +
    LQRKernel::forward_step (lqr_kernel.hpp:180-204).

    Returns ws of shape (N+1, nz) with rows [u_k; x_k] (terminal u = 0),
    matching the reference's ws trajectory layout.
    """
    with full_f32_matmul():
        nu = problem.nu
        x = x0
        rows = []
        for k in range(problem.N):
            L, lp = factors.L[..., k, :, :], factors.lp[..., k, :]
            u = -(lp[..., :nu] + _mv(L[..., nu:, :nu].transpose(-1, -2), x))
            u = _solve_lower_T(L[..., :nu, :nu], u)
            rows.append(torch.cat([u, x], dim=-1))
            x = (_mv(problem.A[..., k, :, :], x)
                 + _mv(problem.B[..., k, :, :], u) + problem.c[..., k, :])
        rows.append(torch.cat([torch.zeros_like(rows[0][..., :nu]), x], dim=-1))
        return torch.stack(rows, dim=-2)


def costates(problem: LQRProblem, params: StageParams, rho, ws) -> torch.Tensor:
    """Dynamics multipliers lambda_1..N via the adjoint recursion on the
    *penalized* stage data:

      lambda_N = Hxx~_N x_N + hx~_N
      lambda_k = Hxx~_k x_k + Hxu~_k u_k + hx~_k + A_k^T lambda_{k+1}

    Returns (N, nx): lambda at stages 1..N.
    """
    with full_f32_matmul():
        nu = problem.nu
        H, h = penalty_fold(params.H, params.h, problem.D, rho, params.g)
        lam = _mv(H[..., -1, nu:, nu:], ws[..., -1, nu:]) + h[..., -1, nu:]
        lams = [lam]
        # k = N-1 .. 1; stage 0's x-row has no multiplier (x0 is data).
        for k in range(problem.N - 1, 0, -1):
            grad_x = _mv(H[..., k, nu:, :], ws[..., k, :]) + h[..., k, nu:]
            lam = grad_x + _mv(problem.A[..., k, :, :].transpose(-1, -2), lam)
            lams.append(lam)
        return torch.stack(lams[::-1], dim=-2)
