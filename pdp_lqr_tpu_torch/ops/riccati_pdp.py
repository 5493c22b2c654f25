"""Segmented parallel Riccati (PDP) on torch ops — PyTorch port of
``pdp_lqr_tpu/ops/riccati_pdp.py``.

Reference counterparts:
  include/clqr/lqr/lqr_kernel_parallel.hpp — per-stage coupling math
  include/clqr/lqr/lqr_solver_parallel.hpp — segment orchestration

The reference partitions the horizon into ``num_segments`` contiguous
segments, runs the Riccati reduction of each segment on its own OpenMP
thread, couples the segments through a condensed block-tridiagonal
system over their boundary states, and rolls all segments out in
parallel (lqr_solver_parallel.hpp:142-238).

Here the segments are uniform (N % S == 0) and the JAX package's ``vmap``
over them is a leading segment axis: every stage step runs on all S
segments (and any batch axes before them) at once, a Python loop over
the N/S stages of a segment.  A non-last segment's boundary init (L=0,
lp=0, F=I, C=0, f=0 — lqr_kernel_parallel.hpp:60-66) is just a different
carry: with Lxx_next = 0 the base step reduces exactly to the
reference's zero-initialized boundary node.  (The segment-parallel path
on the card, K9 / K10 in ``parallel.pdp_sharded_fused``, is the same
math in kernels; this module is the reference-shaped backend of
``solvers.pdp``.)
"""

from __future__ import annotations

import dataclasses

import torch

from pdp_lqr_tpu_torch.config import full_f32_matmul
from pdp_lqr_tpu_torch.ops import linalg, riccati
from pdp_lqr_tpu_torch.problem import LQRProblem, StageParams

_mv = riccati._mv


@dataclasses.dataclass(frozen=True)
class PDPFactors:
    """Backward-pass cache for the PDP solver.

    L, lp, G carry a (S, Nseg, ...) segment layout after any batch axes.
    Boundary exports (per segment, at its start — the reference's
    update_segment_data payload, lqr_solver_parallel.hpp:182-187):
      P0 = Lxx_start Lxx_start^T, F0, C0, p0, f0.
    condensed: factor cache of the condensed boundary solve.
    """

    L: torch.Tensor       # (S, Nseg, nz, nz)
    lp: torch.Tensor      # (S, Nseg, nz)
    G: torch.Tensor       # (S, Nseg, nu, nx)
    Fnext: torch.Tensor   # (S, Nseg, nx, nx) incoming F at each stage
    P0: torch.Tensor      # (S, nx, nx)
    F0: torch.Tensor      # (S, nx, nx)
    C0: torch.Tensor      # (S, nx, nx)
    p0: torch.Tensor      # (S, nx)
    f0: torch.Tensor      # (S, nx)
    LxxN: torch.Tensor    # (nx, nx) true terminal Cholesky factor
    condensed: object


def _segment_backward_step(carry, stage):
    """Base Riccati step + segment-coupling propagation (folded data).

    Base step: lqr_kernel.hpp:103-147 (``riccati.backward_step_folded``).
    Coupling (lqr_kernel_parallel.hpp:97-135):
      K = -Luu^{-T} Lxu^T ; d = -Luu^{-T} lu
      G = -Luu^{-1} B^T F+^T
      F = F+ (A + B K) ; f = F+ (c + B d) + f+ ; C = C+ + G^T G
    """
    Lxx_next, p_next, F_next, C_next, f_next = carry
    A, B, c, H, h = stage
    nu = B.shape[-1]
    (Lxx, p), (L, lp) = riccati.backward_step_folded(
        (Lxx_next, p_next), (A, B, c, H, h))
    Luu, Lxu, lu = L[..., :nu, :nu], L[..., nu:, :nu], lp[..., :nu]
    K = linalg.solve_lower_T(Luu, -Lxu.mT)
    d = linalg.solve_lower_T(Luu, -lu)
    G = linalg.solve_lower(Luu, -(B.mT @ F_next.mT))
    F = F_next @ (A + B @ K)
    f = _mv(F_next, c + _mv(B, d)) + f_next
    C = C_next + G.mT @ G
    # F_next is emitted per stage so the no-refactor fast path can redo
    # the f-propagation without the matrix work (lqr_kernel_parallel.hpp:157).
    return (Lxx, p, F, C, f), (L, lp, G, F_next)


def _seg(x, S, vec):
    """(..., N, *own) -> (..., S, N/S, *own): the stage axis in segments."""
    d = x.ndim - (1 if vec else 2) - 1
    return x.reshape(x.shape[:d] + (S, x.shape[d] // S) + x.shape[d + 1:])


def segment_reduction(problem: LQRProblem, params: StageParams, rho,
                      num_segments: int):
    """Run the per-segment backward reductions (all segments at once).

    Reference: LQRParallelSolver::reduction / reduction_per_thread
    (lqr_solver_parallel.hpp:156-188).  Returns stacked per-stage factors
    and per-segment boundary exports.
    """
    S = num_segments
    N, nx, nu = problem.N, problem.nx, problem.nu
    if N % S != 0:
        raise ValueError(f"horizon N={N} must be divisible by num_segments={S}")
    Nseg = N // S
    with full_f32_matmul():
        Hf, hf = riccati.penalty_fold(params.H, params.h, problem.D, rho,
                                      params.g)
        # True terminal step feeds the last segment's init
        # (lqr_solver_parallel.hpp:170-171 with is_last_segment=true).
        LxxN = linalg.cholesky(Hf[..., -1, nu:, nu:])
        pN = hf[..., -1, nu:]
        zm = torch.zeros_like(LxxN).unsqueeze(-3).expand(
            LxxN.shape[:-2] + (S - 1, nx, nx))
        zv = torch.zeros_like(pN).unsqueeze(-2).expand(
            pN.shape[:-1] + (S - 1, nx))
        Lxx = torch.cat([zm, LxxN[..., None, :, :]], dim=-3)
        p = torch.cat([zv, pN[..., None, :]], dim=-2)
        F = torch.eye(nx, dtype=Lxx.dtype, device=Lxx.device).expand(Lxx.shape)
        C = torch.zeros_like(Lxx)
        f = torch.zeros_like(p)
        A, B = _seg(problem.A, S, False), _seg(problem.B, S, False)
        c = _seg(problem.c, S, True)
        H, h = _seg(Hf[..., :-1, :, :], S, False), _seg(hf[..., :-1, :], S, True)
        carry = (Lxx, p, F, C, f)
        outs = []
        for j in range(Nseg - 1, -1, -1):
            mat = lambda x: x[..., j, :, :]
            carry, out = _segment_backward_step(
                carry, (mat(A), mat(B), c[..., j, :], mat(H), h[..., j, :]))
            outs.append(out)
        Lxx0, p0, F0, C0, f0 = carry
        L, lp, G, Fnext = (torch.stack([o[i] for o in outs[::-1]],
                                       dim=-3 if i != 1 else -2)
                           for i in range(4))
        P0 = Lxx0 @ Lxx0.mT
    return L, lp, G, Fnext, P0, F0, C0, p0, f0, (LxxN, pN)


def segment_reduction_no_refactor(problem: LQRProblem, params: StageParams,
                                  rho, factors: PDPFactors):
    """Vector-only per-segment reductions reusing cached factors.

    Reference: LQRParallelSolver::backward_without_factorization /
    reduction_without_factorization (lqr_solver_parallel.hpp:148-211)
    + ParallelLQRKernel::step_without_factorization
    (lqr_kernel_parallel.hpp:139-168):
      base vector step with cached L, plus
      d = -Luu^{-T} lu ;  f = F+ (c + B d) + f+.
    Returns (lp, f0, p0, pN) — the only quantities that change.
    """
    S, Nseg = factors.L.shape[-4], factors.L.shape[-3]
    nx, nu = problem.nx, problem.nu
    with full_f32_matmul():
        hf = riccati.penalty_fold_vec(params.h, problem.D, rho, params.g)
        pN = hf[..., -1, nu:]
        # Cached Lxx_{k+1} per stage: shift within each segment; the
        # boundary entry is 0 for non-last segments (zero-initialized
        # boundary node, lqr_kernel_parallel.hpp:61) and LxxN for the last.
        LxxN = factors.LxxN
        zm = torch.zeros_like(LxxN).unsqueeze(-3).expand(
            LxxN.shape[:-2] + (S - 1, nx, nx))
        bound = torch.cat([zm, LxxN[..., None, :, :]], dim=-3)
        Lxx_next = torch.cat([factors.L[..., :, 1:, nu:, nu:],
                              bound[..., None, :, :]], dim=-3)
        zv = torch.zeros_like(pN).unsqueeze(-2).expand(
            pN.shape[:-1] + (S - 1, nx))
        p = torch.cat([zv, pN[..., None, :]], dim=-2)
        f = torch.zeros_like(p)
        A, B = _seg(problem.A, S, False), _seg(problem.B, S, False)
        c, h = _seg(problem.c, S, True), _seg(hf[..., :-1, :], S, True)
        lps = []
        for j in range(Nseg - 1, -1, -1):
            Ak, Bk, ck, hk = A[..., j, :, :], B[..., j, :, :], c[..., j, :], \
                h[..., j, :]
            L = factors.L[..., j, :, :]
            Lxxn = Lxx_next[..., j, :, :]
            E = torch.cat([Bk, Ak], dim=-1)
            Pb = _mv(Lxxn, _mv(Lxxn.mT, ck)) + p
            lp = hk + _mv(E.mT, Pb)
            lu = linalg.solve_lower(L[..., :nu, :nu], lp[..., :nu])
            p = lp[..., nu:] - _mv(L[..., nu:, :nu], lu)
            d = linalg.solve_lower_T(L[..., :nu, :nu], -lu)
            f = _mv(factors.Fnext[..., j, :, :], ck + _mv(Bk, d)) + f
            lps.append(torch.cat([lu, p], dim=-1))
        lp = torch.stack(lps[::-1], dim=-2)
    return lp, p, f, pN


def segment_rollout(problem: LQRProblem, L, lp, G, xhat, uhat):
    """Parallel forward rollout of all segments.

    Reference: LQRParallelSolver::forward (lqr_solver_parallel.hpp:213-238)
    + ParallelLQRKernel::forward_step (lqr_kernel_parallel.hpp:170-218).
    ``uhat`` must be zero for the last segment, which makes the
    boundary-dual correction term G uhat vanish and the step reduce to
    the plain forward step.

    Returns ws (N+1, nz).
    """
    S, Nseg = L.shape[-4], L.shape[-3]
    nu = problem.nu
    A, B = _seg(problem.A, S, False), _seg(problem.B, S, False)
    c = _seg(problem.c, S, True)
    x, rows = xhat, []
    with full_f32_matmul():
        for j in range(Nseg):
            Lk, lpk, Gk = L[..., j, :, :], lp[..., j, :], G[..., j, :, :]
            u = -(lpk[..., :nu] + _mv(Lk[..., nu:, :nu].mT, x)) + _mv(Gk, uhat)
            u = linalg.solve_lower_T(Lk[..., :nu, :nu], u)
            rows.append(torch.cat([u, x], dim=-1))
            x = _mv(A[..., j, :, :], x) + _mv(B[..., j, :, :], u) + c[..., j, :]
    ws = torch.stack(rows, dim=-2)                        # (..., S, Nseg, nz)
    ws = ws.reshape(ws.shape[:-3] + (S * Nseg, ws.shape[-1]))
    wN = torch.cat([torch.zeros_like(ws[..., -1, :nu]), x[..., -1, :]], dim=-1)
    return torch.cat([ws, wN[..., None, :]], dim=-2)
