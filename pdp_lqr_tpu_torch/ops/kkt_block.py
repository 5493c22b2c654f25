"""Block-tridiagonal KKT factorization — the QDLDL-path analog; PyTorch
port of ``pdp_lqr_tpu/ops/kkt_block.py``.

Reference counterparts: include/clqr/lqr/kkt.hpp (sparse KKT assembly)
and include/clqr/lqr/qdldl_solver.hpp (general sparse LDL^T via QDLDL).
The KKT matrix of an LQ problem is block tridiagonal with a bandwidth set
by (nx, nu), so the sparse LDL^T becomes a block-Thomas factorization
over dense stage blocks:

  stage meta-variable v_k = [lambda_k; x_k; u_k]   (m = 2 nx + nu)

  diagonal block  D_k = [ -rho_dyn I   I      0   ]
                        [  I           Q~_k   S~_k^T ]
                        [  0           S~_k   R~_k ]

  super-diagonal  E_k  couples v_k -> v_{k+1}: x_k/u_k rows carry
                  -A_k^T / -B_k^T into the lambda_{k+1} column.

  (Constraint duals y_k are eliminated exactly first: the Schur
  complement of the -rho^{-1} diagonal block is the penalty fold
  H + D^T rho D, kkt.hpp:198-199 & 124-205.)

  v_0 pads lambda_0/x_0 with identity dummies (x_0 is data and enters
  the right-hand side, kkt.hpp:207-222); v_N pads u_N.

Factor sweep: S_0 = D_0;  S_k = D_k - E_{k-1}^T U_{k-1} with
U_k = S_k^{-1} E_k, each pivot block explicitly inverted (the system is
symmetric quasi-definite thanks to sigma/rho_dyn).  Solve = forward sweep
zhat_k = S_k^{-1}(rhs_k - E_{k-1}^T zhat_{k-1}) + backward sweep
v_k = zhat_k - U_k v_{k+1}.  The cached (S_k^{-1}, U_k) play the role of
QDLDL's numeric factor; ``solve_cached`` re-solves with a new right-hand
side only.  Every function batches over any leading axes; the sweeps are
Python loops over stages of batched operations.
"""

from __future__ import annotations

import dataclasses

import torch

from pdp_lqr_tpu_torch.config import full_f32_matmul
from pdp_lqr_tpu_torch.ops import linalg, riccati
from pdp_lqr_tpu_torch.problem import LQRProblem, StageParams, _TensorRecord

_mv = riccati._mv


@dataclasses.dataclass(frozen=True)
class KKTFactors(_TensorRecord):
    """Numeric factor cache of the block-tridiagonal KKT matrix.

    Sinv: explicit inverses of the pivot blocks S_k, (N+1, m, m), so that
      every resolve is batched matrix products only.
    U: S_k^{-1} E_k for k = 0..N-1, (N, m, m).
    E: the super-diagonal blocks (needed by the forward sweep).
    """

    Sinv: torch.Tensor
    U: torch.Tensor
    E: torch.Tensor


def build_blocks(problem: LQRProblem, params: StageParams, rho,
                 rho_dyn: float):
    """Assemble the dense stage blocks (D, E) of the block-tridiagonal KKT.

    Mirrors KKTSystem::form_KKT_matrix (kkt.hpp:124-205) with the
    constraint duals pre-eliminated (exact Schur complement = penalty fold).
    """
    N, nx, nu = problem.N, problem.nx, problem.nu
    m = 2 * nx + nu
    with full_f32_matmul():
        H, _ = riccati.penalty_fold(params.H, params.h, problem.D, rho,
                                    params.g)
    batch = H.shape[:-3]
    x, u = slice(nx, 2 * nx), slice(2 * nx, m)
    eye_x = torch.eye(nx, dtype=H.dtype, device=H.device)
    D = H.new_zeros(batch + (N + 1, m, m))
    # lambda block: -rho_dyn I (the dynamics-row regularization); identity
    # dummy at stage 0 (no lambda_0 exists).
    D[..., :, :nx, :nx] = -rho_dyn * eye_x
    D[..., 0, :nx, :nx] = eye_x
    # lambda/x coupling +I (the dynamics equation defines x_k); none at 0.
    D[..., 1:, :nx, x] = eye_x
    D[..., 1:, x, :nx] = eye_x
    # x block Q~; identity dummy at stage 0 (x_0 is data).
    D[..., :, x, x] = H[..., nu:, nu:]
    D[..., 0, x, x] = eye_x
    # u block R~; identity dummy at the terminal stage (no u_N).
    D[..., :, u, u] = H[..., :nu, :nu]
    D[..., N, u, u] = torch.eye(nu, dtype=H.dtype, device=H.device)
    # x/u cross S~ (zero at stage 0: x_0's part moves to the rhs; the
    # terminal stage's u-rows of H are 0 already).
    D[..., 1:, u, x] = H[..., 1:, :nu, nu:]
    D[..., 1:, x, u] = H[..., 1:, :nu, nu:].mT
    # Super-diagonal: x_k/u_k rows -> lambda_{k+1} column, -A^T / -B^T
    # (stage 0 keeps only the -B^T entry: x_0 is data).
    E = H.new_zeros(batch + (N, m, m))
    E[..., 1:, x, :nx] = -problem.A[..., 1:, :, :].mT
    E[..., :, u, :nx] = -problem.B.mT
    return D, E


def build_rhs(problem: LQRProblem, params: StageParams, rho, x0):
    """Right-hand side in the stage-block layout (kkt.hpp:224-300 + the x0
    injection :207-222)."""
    N, nx, nu = problem.N, problem.nx, problem.nu
    m = 2 * nx + nu
    with full_f32_matmul():
        H, h = riccati.penalty_fold(params.H, params.h, problem.D, rho,
                                    params.g)
        rhs = h.new_zeros(h.shape[:-2] + (N + 1, m))
        # lambda rows: dynamics residual c_{k-1}; stage 1 also carries A_0 x_0.
        rhs[..., 1:, :nx] = problem.c
        rhs[..., 1, :nx] += _mv(problem.A[..., 0, :, :], x0)
        # x rows: -q~_k; the stage-0 dummy stays 0 (x_0 fixed).
        rhs[..., 1:, nx:2 * nx] = -h[..., 1:, nu:]
        # u rows: -r~_k; stage 0 includes the S~_0 x_0 shift; terminal 0.
        rhs[..., :N, 2 * nx:] = -h[..., :N, :nu]
        rhs[..., 0, 2 * nx:] -= _mv(H[..., 0, :nu, nu:], x0)
    return rhs


def _invert(S):
    eye = torch.eye(S.shape[-1], dtype=S.dtype, device=S.device)
    return linalg.ge_solve_unrolled(S, eye.expand(S.shape))


def factorize(D, E) -> KKTFactors:
    """Block-Thomas factor sweep (the batched LDL^T numeric factor).

    Analog of QDLDL_factor (qdldl_solver.hpp:88-109) on the static
    block-tridiagonal structure, with the pivot-block inverses kept.
    """
    with full_f32_matmul():
        Sinv = _invert(D[..., 0, :, :])
        Sinvs, Us = [Sinv], []
        for k in range(E.shape[-3]):
            Ek = E[..., k, :, :]
            U = Sinv @ Ek
            Sinv = _invert(D[..., k + 1, :, :] - Ek.mT @ U)
            Sinvs.append(Sinv)
            Us.append(U)
    return KKTFactors(Sinv=torch.stack(Sinvs, dim=-3),
                      U=torch.stack(Us, dim=-3), E=E)


def solve_cached(fac: KKTFactors, rhs):
    """Forward + backward substitution with cached factors.

    Analog of QDLDL_solve (qdldl_solver.hpp:111-151): new rhs, no numeric
    refactorization; matrix products only.
    """
    N = fac.E.shape[-3]
    with full_f32_matmul():
        zhat = [_mv(fac.Sinv[..., 0, :, :], rhs[..., 0, :])]
        for k in range(N):
            r = rhs[..., k + 1, :] - _mv(fac.E[..., k, :, :].mT, zhat[-1])
            zhat.append(_mv(fac.Sinv[..., k + 1, :, :], r))
        v = [zhat[N]]
        for k in range(N - 1, -1, -1):
            v.append(zhat[k] - _mv(fac.U[..., k, :, :], v[-1]))
    return torch.stack(v[::-1], dim=-2)


def extract_ws(v, problem: LQRProblem, x0):
    """Stage-block solution -> trajectory ws (N+1, nz) rows [u_k; x_k]."""
    nx = problem.nx
    us = v[..., :-1, 2 * nx:]                       # u_0..u_{N-1}
    xs = torch.cat([x0[..., None, :], v[..., 1:, nx:2 * nx]], dim=-2)
    us = torch.cat([us, torch.zeros_like(us[..., :1, :])], dim=-2)
    return torch.cat([us, xs], dim=-1)


def extract_lambdas(v, problem: LQRProblem):
    """Dynamics duals lambda_1..lambda_N, (N, nx)."""
    return v[..., 1:, :problem.nx]


def extract_constraint_duals(ws, problem: LQRProblem, params: StageParams,
                             rho):
    """Per-row constraint duals y, (N+1, nc) — the variables the block
    elimination removed, recovered exactly from the primal solution
    through the row equations D_k w_k - rho^{-1} y_k = g_k
    (kkt.hpp:198-199):  y_k = rho_k o (D_k w_k - g_k).  Padded rows
    (rho = 0) return 0."""
    with full_f32_matmul():
        Dw = torch.einsum("...kcz,...kz->...kc", problem.D, ws)
    return rho * (Dw - params.g)
