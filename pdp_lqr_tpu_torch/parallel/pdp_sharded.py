"""Segment-parallel PDP solve in torch ops — PyTorch port of
``pdp_lqr_tpu/parallel/pdp_sharded.py``.

The reference's parallel solver (lqr_solver_parallel.hpp) on a
("batch", "time") mesh, written in tensor ops as JAX's is in XLA ops (no
kernel lies on this path; ``pdp_sharded_fused`` is its kernel form):

  OpenMP thread per segment (:157)       -> a segment of N/S stages, all
                                            held segments stepped at once
  update_segment_data handoff (:182-187) -> the (P, F, C, p, f) boundary
                                            factors all-gathered over the
                                            time group (one card: already
                                            side by side)
  serial condensed solve (:145)          -> the condensed solve, Cholesky
                                            or LU, replicated on every
                                            time rank
  implicit omp barrier                   -> the collectives

Every step is batched over the instances and the held segments: the
penalty fold, the backward segment scan
(``riccati_pdp._segment_backward_step``, its carry in Cholesky form as the
reference's), the condensed solve, the local rollout
(lqr_solver_parallel.hpp:217-237) and the terminal state summed from the
last time rank.
"""

from __future__ import annotations

import torch

from pdp_lqr_tpu_torch.config import CondensedSolverType, full_f32_matmul
from pdp_lqr_tpu_torch.ops import condensed, linalg, riccati, riccati_pdp
from pdp_lqr_tpu_torch.parallel.pdp_sharded_fused import check_mesh
from pdp_lqr_tpu_torch.problem import make_stage_params

_mv = riccati._mv


def _segments(x, S):
    """(B, N_held, *own) -> (B, S_held, N_held/S_held, *own)."""
    return x.reshape((x.shape[0], S, x.shape[1] // S) + x.shape[2:])


def _local_solve(ax, nu, A, B, c, H, h, D, rho, g, HN, hN, DN, rhoN, gN, x0,
                 solver_type):
    """The held segments' solve: stage tensors (Bl, N_held, ...), terminal
    ones (Bl, ...), x0 (Bl, nx).  Returns (ws (Bl, N_held, nz), xN (Bl,
    nx) on every time rank)."""
    S = ax.held
    nx, dt, dev = A.shape[-1], A.dtype, A.device
    with full_f32_matmul():
        Hf, hf = riccati.penalty_fold(H, h, D, rho, g)
    # The terminal step on every rank, masked so that only the horizon's
    # last segment starts from it (lqr_kernel_parallel.hpp:51-67).
    LxxN, pN = riccati.terminal_step_raw(HN[:, nu:, nu:], hN[:, nu:],
                                         DN[:, :, nu:], rhoN, gN)
    w = ax.last_mask(dt, dev)[None, :]                    # (1, S)
    Bl = A.shape[0]
    carry = (w[..., None, None] * LxxN[:, None], w[..., None] * pN[:, None],
             torch.eye(nx, dtype=dt, device=dev).expand(Bl, S, nx, nx),
             torch.zeros((Bl, S, nx, nx), dtype=dt, device=dev),
             torch.zeros((Bl, S, nx), dtype=dt, device=dev))
    As, Bs, cs = _segments(A, S), _segments(B, S), _segments(c, S)
    Hs, hs = _segments(Hf, S), _segments(hf, S)
    outs = []
    for j in range(As.shape[2] - 1, -1, -1):
        carry, out = riccati_pdp._segment_backward_step(
            carry, (As[:, :, j], Bs[:, :, j], cs[:, :, j], Hs[:, :, j],
                    hs[:, :, j]))
        outs.append(out)
    Lxx0, p0, F0, C0, f0 = carry
    L, lp, G = (torch.stack([o[i] for o in outs[::-1]], dim=2)
                for i in range(3))
    with full_f32_matmul():
        P0 = Lxx0 @ Lxx0.mT

    # Boundary handoff over the time group; the condensed solve replicated.
    gather = lambda x: ax.gather(x, dim=1)                # (Bl, S_all, ...)
    Pg, Fg, Cg, pg, fg = map(gather, (P0, F0, C0, p0, f0))
    if solver_type == CondensedSolverType.CHOLESKY:
        fac = condensed.cholesky_backward(Pg, Fg, Cg)
        xhat, uhat = condensed.cholesky_forward(fac, pg, fg, x0)
    else:
        fac = condensed.lu_backward(Pg, Fg, Cg)
        xhat, uhat = condensed.lu_forward(fac, pg, fg, x0)
    x, uh = ax.own(xhat, 1), ax.own(uhat, 1)              # (Bl, S, nx)

    # The held segments' rollout (lqr_solver_parallel.hpp:217-237).
    rows = []
    with full_f32_matmul():
        for j in range(L.shape[2]):
            Lj, lpj, Gj = L[:, :, j], lp[:, :, j], G[:, :, j]
            u = -(lpj[..., :nu] + _mv(Lj[..., nu:, :nu].mT, x)) + _mv(Gj, uh)
            u = linalg.solve_lower_T(Lj[..., :nu, :nu], u)
            rows.append(torch.cat([u, x], dim=-1))
            x = _mv(As[:, :, j], x) + _mv(Bs[:, :, j], u) + cs[:, :, j]
    ws = torch.stack(rows, dim=2)                         # (Bl, S, Nl, nz)
    # The terminal state lives on the last time rank; every rank gets it.
    return ws.reshape(Bl, -1, ws.shape[-1]), ax.from_last(x[:, -1])


def solve(mesh, problem, it, x0, sigma: float,
          solver_type: CondensedSolverType = CondensedSolverType.CHOLESKY):
    """Sharded PDP solve of a batch of problems.

    Args:
      mesh: ("batch", "time") mesh; N % time == 0, B % batch == 0.
      problem/it: batched records with leading axis B.
      x0: (B, nx).

    Returns ws (B, N+1, nz) on one card.  On a rank mesh every rank passes
    the whole batch and gets its batch row's rows back, (B/batch, N+1,
    nz), its time group's stage rows joined.
    """
    dev = mesh.device
    Bb, N = problem.h.shape[0], problem.N
    check_mesh(mesh, N, Bb)
    ax = mesh.time_axis()
    problem = mesh.local(problem, Bb, N).to(device=dev)
    it = mesh.local(it, Bb, N).to(device=dev)
    nu = problem.nu
    x0 = torch.as_tensor(x0)[mesh.rows(Bb)].to(device=dev,
                                                dtype=problem.A.dtype)
    params = make_stage_params(problem, it, sigma)
    ws, xN = _local_solve(
        ax, nu, problem.A, problem.B, problem.c,
        params.H[:, :-1], params.h[:, :-1], problem.D[:, :-1],
        it.rho[:, :-1], params.g[:, :-1],
        params.H[:, -1], params.h[:, -1], problem.D[:, -1], it.rho[:, -1],
        params.g[:, -1], x0, solver_type)
    wN = torch.cat([xN.new_zeros(xN.shape[:-1] + (nu,)), xN], dim=-1)
    return torch.cat([ax.gather(ws, dim=1), wN[:, None]], dim=1)
