"""Dense P-form Riccati — PyTorch port of ``pdp_lqr_tpu/ops/riccati_dense.py``.

Same mathematics as ops/riccati.py (reference lqr_kernel.hpp:103-147),
carried as (P, p) instead of the reference's Cholesky square root: the
only per-stage factorization is of the (nu, nu) input Hessian
Huu = R~ + B^T P+ B.  The backward sweep emits the feedback gains (K, d),
so the rollout needs no solves: the closed-loop maps M = A + B K and
offsets v = B d + c are formed for all stages at once, and the rollout is
a bare matvec a stage.  The no-refactor fast path (lqr_solver.hpp:65-70)
is vector work only: with K cached, G^T d collapses to
K^T (r~ + B^T (P+ c + p+)), and d reuses the cached Huu Cholesky.

Recursion (u-first [u; x] blocks R~, S~ (nu, nx), Q~, r~, q~ of the
penalty-folded stage cost):

  G   = S~ + B^T P+ A          Huu = R~ + B^T P+ B
  K   = -Huu^{-1} G            d   = -Huu^{-1} (r~ + B^T (P+ c + p+))
  P   = Q~ + A^T P+ A + G^T K  p   = q~ + A^T (P+ c + p+) + K^T (r~ + B^T(P+ c + p+))

P is re-symmetrized every stage.  The scans over stages are Python loops
of batched tensor operations (any leading batch axes), in full float32.
"""

from __future__ import annotations

import dataclasses

import torch

from pdp_lqr_tpu_torch.config import full_f32_matmul
from pdp_lqr_tpu_torch.ops import linalg, riccati
from pdp_lqr_tpu_torch.problem import LQRProblem, StageParams, _TensorRecord

_mv = riccati._mv


@dataclasses.dataclass(frozen=True)
class DenseFactors(_TensorRecord):
    """Backward-pass cache: feedback law + cost-to-go + Huu factors.

    K: (N, nu, nx)     d: (N, nu)
    P: (N+1, nx, nx)   p: (N+1, nx)
    Lhuu: (N, nu, nu)  lower Cholesky of Huu per stage (for the
                       vector-only fast path).
    """

    K: torch.Tensor
    d: torch.Tensor
    P: torch.Tensor
    p: torch.Tensor
    Lhuu: torch.Tensor


def backward(problem: LQRProblem, params: StageParams, rho) -> DenseFactors:
    """Backward sweep in P-form (one (nu, nu) Cholesky a stage)."""
    nu = problem.nu
    with full_f32_matmul():
        Hf, hf = riccati.penalty_fold(params.H, params.h, problem.D, rho,
                                      params.g)
        P, p = Hf[..., -1, nu:, nu:], hf[..., -1, nu:]
        Ps, ps, Ks, ds, Lhs = [P], [p], [], [], []
        for k in range(problem.N - 1, -1, -1):
            A, B = problem.A[..., k, :, :], problem.B[..., k, :, :]
            c = problem.c[..., k, :]
            H, h = Hf[..., k, :, :], hf[..., k, :]
            BT = B.mT
            PA = P @ A
            Pcp = _mv(P, c) + p
            G = H[..., :nu, nu:] + BT @ PA
            Huu = H[..., :nu, :nu] + BT @ (P @ B)
            Lh = linalg.cholesky_unrolled(Huu)
            rbar = h[..., :nu] + _mv(BT, Pcp)
            sol = linalg.chol_solve(
                Lh, torch.cat([G, rbar[..., None]], dim=-1))
            K, d = -sol[..., :-1], -sol[..., -1]
            P = H[..., nu:, nu:] + A.mT @ PA + G.mT @ K
            P = 0.5 * (P + P.mT)
            p = h[..., nu:] + _mv(A.mT, Pcp) + _mv(K.mT, rbar)
            Ps.append(P)
            ps.append(p)
            Ks.append(K)
            ds.append(d)
            Lhs.append(Lh)
    rev = lambda xs, dim: torch.stack(xs[::-1], dim=dim)
    return DenseFactors(K=rev(Ks, -3), d=rev(ds, -2), P=rev(Ps, -3),
                        p=rev(ps, -2), Lhuu=rev(Lhs, -3))


def backward_no_refactor(problem: LQRProblem, params: StageParams, rho,
                         factors: DenseFactors) -> DenseFactors:
    """Vector-only backward with cached gains (rho/sigma unchanged).

    Reference semantics: lqr_solver.hpp:65-70 / lqr_kernel.hpp:149-178.
    Per stage (K, Lhuu, P cached; only r~, q~ and the p-recursion run):

      Pcp  = P+ c + p+
      rbar = r~ + B^T Pcp
      d    = -(Lhuu Lhuu^T)^{-1} rbar
      p    = q~ + A^T Pcp + K^T rbar
    """
    nu = problem.nu
    with full_f32_matmul():
        hf = riccati.penalty_fold_vec(params.h, problem.D, rho, params.g)
        p = hf[..., -1, nu:]
        ps, ds = [p], []
        for k in range(problem.N - 1, -1, -1):
            A, B = problem.A[..., k, :, :], problem.B[..., k, :, :]
            Pcp = _mv(factors.P[..., k + 1, :, :], problem.c[..., k, :]) + p
            rbar = hf[..., k, :nu] + _mv(B.mT, Pcp)
            d = -linalg.chol_solve(
                factors.Lhuu[..., k, :, :], rbar[..., None])[..., 0]
            p = hf[..., k, nu:] + _mv(A.mT, Pcp) + _mv(
                factors.K[..., k, :, :].mT, rbar)
            ps.append(p)
            ds.append(d)
    return dataclasses.replace(factors, d=torch.stack(ds[::-1], dim=-2),
                               p=torch.stack(ps[::-1], dim=-2))


def forward(problem: LQRProblem, factors: DenseFactors, x0):
    """Rollout with precomputed closed-loop maps (no per-stage solves).

    Returns ws (N+1, nz) rows [u_k; x_k] (terminal u = 0), matching
    every other backend's layout.
    """
    nu = problem.nu
    K, d = factors.K, factors.d
    with full_f32_matmul():
        M = problem.A + problem.B @ K
        v = _mv(problem.B, d) + problem.c
        x, rows = x0, []
        for k in range(problem.N):
            u = _mv(K[..., k, :, :], x) + d[..., k, :]
            rows.append(torch.cat([u, x], dim=-1))
            x = _mv(M[..., k, :, :], x) + v[..., k, :]
    rows.append(torch.cat([torch.zeros_like(rows[0][..., :nu]), x], dim=-1))
    return torch.stack(rows, dim=-2)
