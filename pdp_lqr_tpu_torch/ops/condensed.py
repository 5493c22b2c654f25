"""Condensed inter-segment boundary system — PyTorch port of
``pdp_lqr_tpu/ops/condensed.py`` (its Cholesky variant).

Reference counterpart: include/clqr/lqr/condensed_system.hpp — the
block-tridiagonal system over segment-boundary states produced by the
PDP reduction (condensed_system.hpp:151-299, the Cholesky variant, the
default).  Each segment i contributes (P_i, A_i, C_i, p_i, c_i):

  P_i       cost-to-go Hessian at the segment start,
  A_i = F_i closed-loop transition across segment i,
  C_i       accumulated Gram of the boundary-dual couplings,
  p_i, c_i = f_i   the linear terms,

via update_segment_data (condensed_system.hpp:183-201).

``cholesky_backward`` returns a factor cache, ``cholesky_forward``
consumes it and returns the boundary states ``xhat`` and duals ``uhat``.
The number of segments S is small, so the recursions are Python loops of
batched (..., nx, nx) operations in full float32 (``full_f32_matmul``).

Failure signalling: the reference's Cholesky variant returns false on a
non-SPD pivot (condensed_system.hpp:217-226).  Here, as in the JAX
package, a non-SPD pivot makes that instance's factor NaN, which
propagates to its output without a host read (``cholesky_ex`` reports
per instance; the other instances are untouched).  The LU variant
(condensed.py:141-212 of the JAX package) waits for its callers.
"""

from __future__ import annotations

import dataclasses

import torch

from pdp_lqr_tpu_torch.config import full_f32_matmul


@dataclasses.dataclass(frozen=True)
class CholeskyCondensedFactors:
    """Factor cache of the Cholesky condensed backward pass.

    Pchol[i] = chol(P_i as updated), valid for i >= 1;
    Cchol[i] = chol(C_i + P_{i+1}^{-1}), valid for i <= S-2;
    Pinv[i]  = P_i^{-1}, valid for i >= 1;
    Asolved[i] = C_i^{-1} A_i, valid for 1 <= i <= S-2.
    Slot 0 / unused slots hold identities.
    """

    Pchol: torch.Tensor    # (..., S, nx, nx)
    Cchol: torch.Tensor    # (..., S, nx, nx)
    Pinv: torch.Tensor     # (..., S, nx, nx)
    Asolved: torch.Tensor  # (..., S, nx, nx)
    A: torch.Tensor        # (..., S, nx, nx) original segment transitions


def cholesky(M):
    """Lower Cholesky factor of the symmetric part of M (as
    ``jnp.linalg.cholesky``); a batch instance that is not positive
    definite gets NaN on and below the diagonal, the others are exact."""
    L, info = torch.linalg.cholesky_ex(0.5 * (M + M.mT))
    return torch.where((info == 0)[..., None, None], L,
                       torch.full_like(L, float("nan")).tril())


def chol_solve(L, b):
    """Solve (L L^T) y = b given the Cholesky factor L."""
    y = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def cholesky_backward(P, A, C) -> CholeskyCondensedFactors:
    """Reference: CondensedSystemCholeskySolver::backward
    (condensed_system.hpp:203-250).  P, A, C (..., S, nx, nx).

    Recursion (i = S-2 .. 1):
      Pinv_{i+1} = P_{i+1}^{-1} (via chol)
      C_i += Pinv_{i+1};  chol(C_i)
      P_i += A_i^T (C_i^{-1} A_i)
    plus the i = 0 tail that only folds Pinv_1 into C_0.
    """
    S, nx = P.shape[-3], P.shape[-1]
    Pw = [P[..., i, :, :] for i in range(S)]
    Cw = [C[..., i, :, :] for i in range(S)]
    Aw = [A[..., i, :, :] for i in range(S)]
    eye = torch.zeros_like(Pw[0]) + torch.eye(nx, dtype=P.dtype,
                                              device=P.device)
    Pchol, Cchol, Pinv, Asolved = ([eye] * S for _ in range(4))

    with full_f32_matmul():
        for i in range(S - 2, 0, -1):
            Lp = cholesky(Pw[i + 1])
            Pinv_n = chol_solve(Lp, eye)
            Lc = cholesky(Cw[i] + Pinv_n)
            Asol = chol_solve(Lc, Aw[i])
            Pw[i] = Pw[i] + Aw[i].mT @ Asol
            Pchol[i + 1] = Lp
            Pinv[i + 1] = Pinv_n
            Cchol[i] = Lc
            Asolved[i] = Asol
        # i = 0 tail (condensed_system.hpp:230-248)
        if S >= 2:
            Lp = cholesky(Pw[1])
            Pinv[1] = chol_solve(Lp, eye)
            Pchol[1] = Lp
            Cchol[0] = cholesky(Cw[0] + Pinv[1])

    stack = lambda xs: torch.stack(xs, dim=-3)
    return CholeskyCondensedFactors(
        Pchol=stack(Pchol), Cchol=stack(Cchol), Pinv=stack(Pinv),
        Asolved=stack(Asolved), A=A)


def cholesky_forward(fac: CholeskyCondensedFactors, p, c, x0):
    """Reference: CondensedSystemCholeskySolver::forward
    (condensed_system.hpp:252-290).  p, c (..., S, nx), x0 (..., nx).
    Returns (xhat, uhat), each (..., S, nx); uhat[S-1] is identically zero
    (no boundary beyond the last segment)."""
    S = fac.A.shape[-3]
    pw = [p[..., i, :] for i in range(S)]
    cw = [c[..., i, :] for i in range(S)]
    col = lambda L, v: chol_solve(L, v[..., None])[..., 0]

    with full_f32_matmul():
        for i in range(S - 2, 0, -1):
            pw[i + 1] = col(fac.Pchol[..., i + 1, :, :], pw[i + 1])
            cw[i] = cw[i] + pw[i + 1]
            pw[i] = pw[i] + _mv(fac.Asolved[..., i, :, :].mT, cw[i])
        if S >= 2:
            pw[1] = col(fac.Pchol[..., 1, :, :], pw[1])
            cw[0] = cw[0] + pw[1]

        xhat = [x0] + [None] * (S - 1)
        uhat = [torch.zeros_like(pw[0])] * S
        for i in range(S - 1):
            u = col(fac.Cchol[..., i, :, :],
                    cw[i] + _mv(fac.A[..., i, :, :], xhat[i]))
            uhat[i] = u
            xhat[i + 1] = -pw[i + 1] + _mv(fac.Pinv[..., i + 1, :, :], u)

    return torch.stack(xhat, dim=-2), torch.stack(uhat, dim=-2)
