"""Segment-parallel PDP solve on one card — PyTorch port of
``pdp_lqr_tpu/parallel/pdp_sharded_fused.py``.

The reference's parallel solver (lqr_solver_parallel.hpp): the horizon is
cut into S segments; each runs the PDP segment reduction from its own
carry (``cuda_riccati.backward_pdp_lanes``, K9: all S segments of all
instances in one launch); the segments' boundary factors (P, F, C, p, f)
form the condensed block-tridiagonal system over the boundary states
(``ops.condensed``, Cholesky variant); its boundary duals fold into the
feedforward (d' = d + Gp uhat, the P-form of lqr_kernel_parallel.hpp:197's
u += G uhat); and the closed-loop rollout of every segment from its
boundary state finishes the solve (``forward_lanes`` in S segments, K3).

JAX runs one segment a device of the mesh's "time" axis inside
``shard_map`` and all-gathers the boundary values.  On one card
(``make_mesh``) the kernels write them as (S, ...) tensors and the
condensed solve runs once: stage tensors are the full horizon, batch-last
(N, ..., B), segment s stages [s N/S, (s+1) N/S).  On a rank mesh
(``multihost.make_pod_mesh``) each rank sweeps its own block of N/S
stages, ``dist.all_gather`` brings the S segments' boundary values to
every rank of its time group, each solves the condensed system, rolls its
own segment out, and the terminal state is summed from the last rank.
The functions keep the JAX names and arguments (``interpret`` is gone: a
CPU tensor runs the kernels' plain versions); their first argument is S
(every segment here) or the mesh's ``TimeAxis``; the per-segment carries
are built here from the folded terminal cost.
"""

from __future__ import annotations

import torch

from pdp_lqr_tpu_torch.config import full_f32_matmul
from pdp_lqr_tpu_torch.ops import condensed, cuda_riccati as cr
from pdp_lqr_tpu_torch.parallel.mesh import time_axis
from pdp_lqr_tpu_torch.problem import make_stage_params


def _holds_last(ax):
    return ax.index is None or ax.index == ax.segments - 1


def _carries(ax, nx, B, dt, dev, PNb, pNb):
    """Initial carries of the held segments, (held, nx[, nx], B): the
    horizon's last segment starts from the folded terminal cost (PNb (B,
    nx, nx), pNb (B, nx); pNb None for zero), the others from P = p = 0;
    every segment from F = I, C = f = 0 (lqr_kernel_parallel.hpp:51-67 in
    P-form)."""
    S = ax.held
    Pi = torch.zeros((S, nx, nx, B), dtype=dt, device=dev)
    pi = torch.zeros((S, nx, B), dtype=dt, device=dev)
    if _holds_last(ax):
        Pi[-1] = PNb.permute(1, 2, 0)
        if pNb is not None:
            pi[-1] = pNb.T
    eye = torch.eye(nx, dtype=dt, device=dev)[None, :, :, None]
    Fi = eye.expand(S, nx, nx, B).contiguous()
    return Pi, pi, Fi, torch.zeros_like(Pi), torch.zeros_like(pi)


def _batch_major(ax, x):
    """The held segments' (held, ..., B) -> every segment's (B, S, ...):
    the condensed system's layout, gathered over the time group."""
    return torch.movedim(ax.gather(x), -1, 0)


def _finish(ax, B_l, K, M, Gp, d, v, xhat, uhat):
    """Boundary-dual correction and the rollout of every held segment from
    its boundary state: d' = d + Gp uhat_s, v' = v + B (Gp uhat_s) (zero
    on the last segment, where uhat is zero).  Returns (ws_l (N_held, nz,
    B), xN (B, nx), the last segment's end state on every rank)."""
    S = ax.held
    N, nu, nx, Bt = Gp.shape
    uh = torch.movedim(ax.own(uhat, 1), 0, -1)           # (S, nx, B)
    xh = torch.movedim(ax.own(xhat, 1), 0, -1).contiguous()
    with full_f32_matmul():
        dd = torch.einsum("stuxb,sxb->stub", Gp.view(S, N // S, nu, nx, Bt),
                          uh).reshape(N, nu, Bt)
        d_adj = d + dd
        v_adj = v + torch.einsum("txub,tub->txb", B_l, dd)
    ws_l, x_end = cr.forward_lanes(M, v_adj.contiguous(), K,
                                   d_adj.contiguous(), xh, segments=S)
    return ws_l, ax.from_last(x_end[-1].T)


def segment_solve_local(S, A_l, B_l, c_l, H_l, h_l, D_l, rho_l, rg_l,
                        PNb, pNb, x0):
    """The fused-PDP inner solve of the held segments.

    ``S``: the segment count (every segment held here) or a TimeAxis.
    Stage tensors batch-last over the held stages (N, ..., B), N divisible
    by the held segments; PNb/pNb (B, nx[, nx]) the already-folded
    terminal cost (the last segment's carry); x0 (B, nx).  Returns (ws_l
    (N, nz, B), xN (B, nx)).  Shared by the one-shot solve below and the
    ADMM loop (parallel/admm_sharded.py).
    """
    ax = time_axis(S)
    nx, Bt = A_l.shape[1], A_l.shape[-1]
    dt, dev = A_l.dtype, A_l.device
    Pi, pi, Fi, Ci, fi = _carries(ax, nx, Bt, dt, dev, PNb, pNb)
    K, d, M, v, Gp, P0, p0, F0, C0, f0 = cr.backward_pdp_lanes(
        A_l, B_l, c_l, H_l, h_l, D_l, rho_l, rg_l, Pi, pi, Fi, Ci, fi,
        segments=ax.held)
    bm = lambda x: _batch_major(ax, x)
    fac = condensed.cholesky_backward(bm(P0), bm(F0), bm(C0))
    xhat, uhat = condensed.cholesky_forward(fac, bm(p0), bm(f0), x0)
    return _finish(ax, B_l, K, M, Gp, d, v, xhat, uhat)


def segment_factors_local(S, A_l, B_l, H_l, D_l, rho_l, PNb):
    """Matrix-only PDP factor build — the cached half of the parallel
    solver's with/without-factorization split
    (lqr_solver_parallel.hpp:148-154).

    Every matrix quantity of the segment reduction (per-stage K, M, Gp,
    P_{k+1}, chol(Huu), F_{k+1}; boundary P0/F0/C0; the condensed
    Cholesky factorization) is iterate-independent while rho is
    unchanged, so it is built once here from zero vector inputs (c, h,
    rho g and every pi zero, the last segment's too) and reused by
    segment_solve_cached until the penalty moves.

    Returns (K, M, Gp, P, L, F, fac).
    """
    ax = time_axis(S)
    N, nx, Bt = A_l.shape[0], A_l.shape[1], A_l.shape[-1]
    nz, nc = H_l.shape[1], D_l.shape[1]
    dt, dev = A_l.dtype, A_l.device
    Pi, pi, Fi, Ci, fi = _carries(ax, nx, Bt, dt, dev, PNb, None)
    zeros = lambda *s: torch.zeros(s + (Bt,), dtype=dt, device=dev)
    (K, _, M, _, Gp, Pst, Lst, Fst,
     P0, _, F0, C0, _) = cr.backward_pdp_lanes(
        A_l, B_l, zeros(N, nx), H_l, zeros(N, nz), D_l, rho_l, zeros(N, nc),
        Pi, pi, Fi, Ci, fi, export_factors=True, segments=ax.held)
    bm = lambda x: _batch_major(ax, x)
    fac = condensed.cholesky_backward(bm(P0), bm(F0), bm(C0))
    return (K, M, Gp, Pst, Lst, Fst, fac)


def segment_solve_cached(S, factors, A_l, B_l, c_l, hf_l, pNb, x0):
    """Cached-factor inner solve: vector-only segment sweep (K10) + cached
    condensed forward + cached-map rollout (lqr_solver_parallel.hpp:190-211
    + :213-238 with reused factors).

    ``hf_l`` (N, nz, B) is the fully iterate-folded linear cost
    h - sigma w - D^T (rho g); ``pNb`` (B, nx) its terminal row.  Same
    contract as segment_solve_local otherwise.
    """
    ax = time_axis(S)
    K, M, Gp, Pst, Lst, Fst, fac = factors
    nx, Bt = A_l.shape[1], A_l.shape[-1]
    pi = torch.zeros((ax.held, nx, Bt), dtype=A_l.dtype, device=A_l.device)
    if _holds_last(ax):
        pi[-1] = pNb.T
    d, v, p0, f0 = cr.backward_pdp_vectors_lanes(
        A_l, B_l, c_l, hf_l, Pst, K, Lst, Fst, pi, segments=ax.held)
    xhat, uhat = condensed.cholesky_forward(fac, _batch_major(ax, p0),
                                            _batch_major(ax, f0), x0)
    return _finish(ax, B_l, K, M, Gp, d, v, xhat, uhat)


def fold_terminal(nu: int, HN, hN, DN, rhoN, gN):
    """Penalty-fold the terminal cost (lqr_kernel_parallel.hpp:51-67,
    P-form): (B, ...) batched tensors -> (PNb, pNb)."""
    PNb = HN[:, nu:, nu:]
    pNb = hN[:, nu:]
    if DN.shape[1] > 0:
        DNx = DN[:, :, nu:]
        with full_f32_matmul():
            PNb = PNb + torch.einsum("bci,bc,bcj->bij", DNx, rhoN, DNx)
            pNb = pNb - torch.einsum("bci,bc->bi", DNx, rhoN * gN)
    return PNb, pNb


def check_mesh(mesh, N: int, B: int):
    """N must split into the mesh's "time" segments, B over its "batch"
    (on a rank mesh, over its batch rows)."""
    S, nb = mesh.shape["time"], mesh.shape["batch"]
    if N % S:
        raise ValueError(f"horizon N={N} is not divisible by time={S}")
    if B % nb:
        raise ValueError(f"batch B={B} is not divisible by batch={nb}")
    return S


def solve(mesh, problem, it, x0, sigma: float):
    """Segment-parallel fused-PDP solve of a batch of problems.

    Same contract as the JAX function: ("batch", "time") mesh, batched
    problem and iterates (a leading batch axis B on every field), x0
    (B, nx); returns ws (B, N+1, nz).  The horizon runs in
    mesh.shape["time"] segments on mesh.device.  On a rank mesh every rank
    passes the whole batch and gets the rows of its batch row back, ws
    (B/batch, N+1, nz), its time group's segments joined.
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
    lanes = lambda x: cr.to_lanes(x).contiguous()
    PNb, pNb = fold_terminal(nu, params.H[:, -1], params.h[:, -1],
                             problem.D[:, -1], it.rho[:, -1],
                             params.g[:, -1])
    ws_l, xN = segment_solve_local(
        ax, lanes(problem.A), lanes(problem.B), lanes(problem.c),
        lanes(params.H[:, :-1]), lanes(params.h[:, :-1]),
        lanes(problem.D[:, :-1]), lanes(it.rho[:, :-1]),
        lanes(it.rho[:, :-1] * params.g[:, :-1]), PNb, pNb, x0)
    return cr._join_terminal(ax.gather(ws_l), xN.T, nu)
