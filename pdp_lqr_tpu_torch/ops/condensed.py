"""Condensed inter-segment boundary system — PyTorch port of
``pdp_lqr_tpu/ops/condensed.py``.

Reference counterpart: include/clqr/lqr/condensed_system.hpp — the
block-tridiagonal system over segment-boundary states produced by the
PDP reduction, with LU (condensed_system.hpp:32-147) and Cholesky
(:151-299, the default) variants.  Each segment i contributes
(P_i, A_i, C_i, p_i, c_i):

  P_i       cost-to-go Hessian at the segment start,
  A_i = F_i closed-loop transition across segment i,
  C_i       accumulated Gram of the boundary-dual couplings,
  p_i, c_i = f_i   the linear terms,

via update_segment_data (condensed_system.hpp:183-201).

``*_backward`` returns a factor cache, ``*_forward`` consumes it and
returns the boundary states ``xhat`` and duals ``uhat``.
The number of segments S is small, so the recursions are Python loops of
batched (..., nx, nx) operations in full float32 (``full_f32_matmul``).

Failure signalling: the reference's Cholesky variant returns false on a
non-SPD pivot (condensed_system.hpp:217-226).  Here, as in the JAX
package, a non-SPD pivot makes that instance's factor NaN, which
propagates to its output without a host read (``cholesky_ex`` reports
per instance; the other instances are untouched).
"""

from __future__ import annotations

import dataclasses

import torch

from pdp_lqr_tpu_torch.config import full_f32_matmul
from pdp_lqr_tpu_torch.ops.linalg import chol_solve, cholesky


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


@dataclasses.dataclass(frozen=True)
class LUCondensedFactors:
    """Factor cache of the LU condensed backward pass.

    PClu/PCpiv: LU factors of PC_i = C_i P_{i+1} + I (i <= S-2), as
    ``torch.linalg.lu_factor`` returns them; D[i] = PC_i^{-1} A_i;
    Pupd[i] = updated P_i.
    """

    PClu: torch.Tensor     # (..., S, nx, nx)
    PCpiv: torch.Tensor    # (..., S, nx) int32
    D: torch.Tensor        # (..., S, nx, nx)
    Pupd: torch.Tensor     # (..., S, nx, nx)
    A: torch.Tensor        # (..., S, nx, nx)
    C: torch.Tensor        # (..., S, nx, nx)


def lu_backward(P, A, C) -> LUCondensedFactors:
    """Reference: CondensedSystemLUSolver::backward
    (condensed_system.hpp:82-103):
      PC = C_i P_{i+1} + I ; PA = P_{i+1} A_i
      D = PC^{-1} A_i ; P_i += D^T PA
    """
    S, nx = P.shape[-3], P.shape[-1]
    Pw = [P[..., i, :, :] for i in range(S)]
    Aw = [A[..., i, :, :] for i in range(S)]
    Cw = [C[..., i, :, :] for i in range(S)]
    eye = torch.eye(nx, dtype=P.dtype, device=P.device)
    lus = [torch.zeros_like(Pw[0]) + eye] * S
    pivs = [torch.ones(Pw[0].shape[:-1], dtype=torch.int32,
                       device=P.device)] * S
    Ds = [torch.zeros_like(Pw[0])] * S

    with full_f32_matmul():
        for i in range(S - 2, -1, -1):
            PC = Cw[i] @ Pw[i + 1] + eye
            PA = Pw[i + 1] @ Aw[i]
            lu, piv, _ = torch.linalg.lu_factor_ex(PC)
            Di = torch.linalg.lu_solve(lu, piv, Aw[i])
            Pw[i] = Pw[i] + Di.mT @ PA
            lus[i], pivs[i], Ds[i] = lu, piv, Di

    stack = lambda xs, ax=-3: torch.stack(xs, dim=ax)
    return LUCondensedFactors(
        PClu=stack(lus), PCpiv=stack(pivs, -2), D=stack(Ds),
        Pupd=stack(Pw), A=A, C=C)


def lu_forward(fac: LUCondensedFactors, p, c, x0):
    """Reference: CondensedSystemLUSolver::forward
    (condensed_system.hpp:105-138).  Returns (xhat, uhat), each (..., S, nx)."""
    S = fac.A.shape[-3]
    pw = [p[..., i, :] for i in range(S)]
    cw = [c[..., i, :] for i in range(S)]

    with full_f32_matmul():
        for i in range(S - 2, -1, -1):
            c_bar = pw[i + 1] + _mv(fac.Pupd[..., i + 1, :, :], cw[i])
            pw[i] = pw[i] + _mv(fac.D[..., i, :, :].mT, c_bar)

        xhat = [x0] + [None] * (S - 1)
        uhat = [torch.zeros_like(pw[0])] * S
        for i in range(S - 1):
            ci = (cw[i] + _mv(fac.A[..., i, :, :], xhat[i])
                  - _mv(fac.C[..., i, :, :], pw[i + 1]))
            xn = torch.linalg.lu_solve(fac.PClu[..., i, :, :],
                                       fac.PCpiv[..., i, :], ci[..., None])[..., 0]
            xhat[i + 1] = xn
            uhat[i] = pw[i + 1] + _mv(fac.Pupd[..., i + 1, :, :], xn)

    return torch.stack(xhat, dim=-2), torch.stack(uhat, dim=-2)
