"""The conic ADMM loop on the segment-parallel PDP solve — PyTorch port of
``pdp_lqr_tpu/parallel/admm_sharded.py``.

The ADMM iteration (solvers/admm.py math) around the fused-PDP inner
solve (parallel/pdp_sharded_fused.py), the horizon in mesh.shape["time"]
segments, per-instance rho:

  * the x-update is the segment-parallel solve: K9 (+ the condensed
    system) + K3 in segments every iteration;
  * ``cached_factors`` ports the parallel solver's with/without-
    factorization split (lqr_solver_parallel.hpp:148-154,190-211): each
    rho_update_interval-long chunk factors the segment matrices and the
    condensed system ONCE (segment_factors_local, K9 with its factors
    exported) and runs the vector-only sweep (segment_solve_cached, K10)
    for every iteration of the chunk;
  * ``early_exit`` stops once EVERY instance converges; with cached
    factors the exit granularity is one chunk, as in JAX.

JAX runs the loop on the device (``scan`` / ``while_loop``), the
convergence flag an all-mesh ``pmin``; here it is a Python loop, and
``early_exit`` reads ``all(converged)`` on the host where JAX's loop
tests it (counted in ``solvers.admm.HOST_READS["early_exit"]``).  The
projection, dual update and residuals are tensor code on the iterates'
(N+1, rows, B) lanes layout, the terminal row folded in as the last row
(JAX keeps it replicated beside the stage shards: the same numbers).

On a rank mesh (``multihost.make_pod_mesh``) each rank iterates on its
batch row's scenarios and its segment's stages, the terminal row
replicated on every rank of its time group (each computes the same
terminal update from the all-reduced terminal state, as JAX does); the
per-instance residual maxima are ``all_reduce(MAX)`` over the time group
(JAX's ``pmax``), and the early-exit flag is reduced over the whole
world before any rank leaves the loop (JAX's ``pmin`` over both axes): a
rank that left alone would hang its peers in their next collective.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from pdp_lqr_tpu_torch.config import full_f32_matmul
from pdp_lqr_tpu_torch.ops import projections
from pdp_lqr_tpu_torch.parallel.pdp_sharded_fused import (
    check_mesh,
    segment_factors_local,
    segment_solve_cached,
    segment_solve_local,
)
from pdp_lqr_tpu_torch.solvers import admm
from pdp_lqr_tpu_torch.solvers.admm import ADMMSettings, ADMMState


def solve(
    mesh,
    problem,
    x0,
    cones: Sequence[projections.ConeSpec] = (),
    settings: ADMMSettings = ADMMSettings(),
    state=None,
    soc_shift=None,
):
    """Segment-parallel conic ADMM solve of a batch of problems.

    problem/x0: batched (leading axis B divisible by mesh.shape["batch"];
    horizon N divisible by mesh.shape["time"]).  ``state`` warm-starts
    from a previous solve's returned state.  ``settings.cached_factors``
    enables the with/without-factorization split; ``settings.early_exit``
    stops once every instance converges.  Runs on mesh.device.

    Returns (ws (B, N+1, nz), ADMMState (batched), ADMMInfo (batched)).
    On a rank mesh every rank passes the whole batch (``state`` the whole
    batch's or its own rows', as a call returns them) and gets the rows of
    its batch row back, (B/batch, N+1, ...), its time group's stages
    joined.
    """
    cones = tuple(cones)
    cones3 = projections.normalize_cones(cones)
    dev = mesh.device
    B_all, N_all = problem.h.shape[0], problem.N
    check_mesh(mesh, N_all, B_all)
    ax = mesh.time_axis()
    problem = mesh.local(problem, B_all, N_all).to(device=dev)
    dt = problem.H.dtype
    Bb, N = problem.h.shape[0], problem.N
    nu, nc, nx = problem.nu, problem.nc, problem.nx
    nz = nu + nx
    sigma, alpha = settings.sigma, settings.alpha
    # Per-instance adaptation (JAX's loop has no uniform_rho).
    rule = dataclasses.replace(settings, uniform_rho=False)
    tensor = lambda v: torch.as_tensor(v).to(device=dev, dtype=dt)
    l3 = lambda x: torch.movedim(x, 0, -1).contiguous()
    x0 = tensor(torch.as_tensor(x0)[mesh.rows(B_all)])

    # The row mask and per-row rho scale (mask * eq boost) (N+1, nc, B),
    # the stage streams, H + sigma I and the terminal H_N[x, x] + sigma I.
    mask, rsc, A_l, B_l, c_l, Hs_l, D_l, HNs = admm._batched_lanes(
        problem, cones, settings)
    h_l = l3(problem.h)                                    # (N+1, nz, B)
    DNx = l3(problem.D[:, -1, :, nu:])                     # (nc, nx, B)
    lb_l, ub_l = l3(problem.e_lb), l3(problem.e_ub)
    shift_l = None if soc_shift is None else \
        tensor(mesh.stages(torch.as_tensor(soc_shift), N_all))[..., None]
    # The terminal row has no control: h, w and the sigma term of the dual
    # residual act on its x-block only.
    xrows = torch.ones((N + 1, nz, 1), dtype=dt, device=dev)
    xrows[-1, :nu] = 0.0
    # Batch-major D and H (the terminal H on its x block only) for the
    # residual products: one batched product each.
    D_t = problem.D.transpose(0, 1).contiguous()           # (N+1, B, nc, nz)
    H_t = problem.H.transpose(0, 1).clone()
    H_t[-1, :, :nu] = 0.0
    H_t[-1, :, :, :nu] = 0.0

    def bmv(M_t, v):
        """(N+1, B, r, s) by (N+1, s, B) -> (N+1, r, B)."""
        with full_f32_matmul():
            return torch.matmul(M_t, v.transpose(1, 2)[..., None])[..., 0] \
                .transpose(1, 2)

    Dw = lambda w: bmv(D_t, w)
    Hw = lambda w: bmv(H_t, w)
    DTv = lambda v: bmv(D_t.transpose(-1, -2), v)
    # Per-instance maxima over the stages (-> (B,)), over the time group.
    amax = lambda x: ax.max(x.abs().amax(dim=(0, 1)))
    h_absmax = amax(h_l)

    def penalty(rho):
        rho_vec = rho[None, None, :] * rsc                 # (N+1, nc, B)
        inv_rho = torch.where(rsc > 0, 1.0 / rho_vec.clamp(min=1e-30), 0.0)
        return rho_vec, inv_rho

    def terminal_PN(rho_vec):
        """H_N[x, x] + sigma I + D_x^T diag(rho) D_x, (B, nx, nx)."""
        with full_f32_matmul():
            return (HNs + torch.einsum("cib,cb,cjb->ijb", DNx, rho_vec[-1],
                                       DNx)).permute(2, 0, 1)

    def x_update(w, z, y, rho_vec, inv_rho, factors):
        """Inner KKT solve (the reference's update_problem_data + backward
        + forward) through the segment-parallel path, cached (vector-only)
        when factors are given."""
        rg = rho_vec * (z - inv_rho * y)
        h_t = (h_l - sigma * w) * xrows
        with full_f32_matmul():
            pNb = (h_t[-1, nu:] - torch.einsum("cxb,cb->xb", DNx, rg[-1])).T
        if factors is None:
            ws_l, xN = segment_solve_local(
                ax, A_l, B_l, c_l, Hs_l, h_t[:-1].contiguous(), D_l,
                rho_vec[:-1].contiguous(), rg[:-1].contiguous(),
                terminal_PN(rho_vec), pNb, x0)
        else:
            hf = (h_t - DTv(rg))[:-1].contiguous()
            ws_l, xN = segment_solve_cached(ax, factors, A_l, B_l, c_l, hf,
                                            pNb, x0)
        zero_u = torch.zeros((1, nu, Bb), dtype=dt, device=dev)
        return torch.cat([ws_l, torch.cat([zero_u, xN.T[None]], dim=1)])

    def iteration(carry, factors=None):
        w, z, y, rho, stats = carry
        rho_vec, inv_rho = penalty(rho)
        w_t = x_update(w, z, y, rho_vec, inv_rho, factors)

        z_t = Dw(w_t)
        w_new = alpha * w_t + (1.0 - alpha) * w
        relaxed = alpha * z_t + (1.0 - alpha) * z
        z_new = projections.project_rows(relaxed + inv_rho * y, lb_l, ub_l,
                                         cones3, shift_l, axis=1) * mask
        y_new = y + rho_vec * (relaxed - z_new)

        Dw_new = Dw(w_new)
        r_prim = amax((Dw_new - z_new) * mask)
        dw = w - w_t
        zt_term = rho_vec * ((alpha - 1.0) * (z_t - z) + (z - z_new))
        dvec = (1.0 - alpha) * Hw(dw) + sigma * dw * xrows + DTv(zt_term)
        r_dual = amax(dvec)
        prim_scale = torch.maximum(amax(Dw_new * mask), amax(z_new))
        dual_scale = torch.maximum(
            torch.maximum(amax(Hw(w_new)), amax(DTv(y_new))), h_absmax)
        rho, stats = admm._finish_stats(rule, rho, stats, r_prim, r_dual,
                                        prim_scale, dual_scale)
        return (w_new, z_new, y_new, rho, stats)

    def build_factors(rho):
        """Segment + condensed matrix factorization at the carry's rho."""
        rho_vec, _ = penalty(rho)
        return segment_factors_local(ax, A_l, B_l, Hs_l, D_l,
                                     rho_vec[:-1].contiguous(),
                                     terminal_PN(rho_vec))

    flags = {0: False}         # iterations run -> every instance converged

    def all_converged(carry):
        """JAX's loop flag: every instance of every rank converged at the
        last iteration (one host read an iteration count)."""
        k = carry[4][0]
        if k not in flags:
            admm.HOST_READS["early_exit"] += 1
            flags[k] = mesh.all_true(carry[4][4].all())
        return flags[k]

    if state is None:
        state = admm._batch_state(problem, Bb, settings)
    else:
        state = mesh.local(ADMMState(w=state.w, z=state.z, y=state.y,
                                     rho=torch.as_tensor(state.rho).expand(
                                         state.w.shape[0])), B_all, N_all)
    carry = tuple(torch.movedim(tensor(x), 0, -1)
                  for x in (state.w, state.z, state.y)) + (
        tensor(state.rho).expand(Bb).contiguous(),
        admm._start_stats(Bb, dt, dev))
    max_iter = settings.max_iter
    interval = max(1, settings.rho_update_interval)

    if settings.cached_factors:
        # Chunks on the rho cadence: only a chunk's LAST iteration can move
        # rho, so the factors built at its start serve the whole chunk.
        def run_chunk(carry, n_iters):
            factors = build_factors(carry[3])
            for _ in range(n_iters):
                carry = iteration(carry, factors)
            return carry

        n_chunks = -(-max_iter // interval)
        tail = max_iter - (n_chunks - 1) * interval
        if settings.early_exit:
            while carry[4][0] < (n_chunks - 1) * interval \
                    and not all_converged(carry):
                carry = run_chunk(carry, interval)
            if carry[4][0] < max_iter and not all_converged(carry):
                carry = run_chunk(carry, tail)
        else:
            for _ in range(n_chunks - 1):
                carry = run_chunk(carry, interval)
            carry = run_chunk(carry, tail)
    elif settings.early_exit:
        while carry[4][0] < max_iter and not all_converged(carry):
            carry = iteration(carry)
    else:
        for _ in range(max_iter):
            carry = iteration(carry)

    w, z, y, rho, stats = carry
    # The time group's stage rows joined, the terminal row after them.
    joined = lambda x: torch.movedim(
        torch.cat([ax.gather(x[:-1]), x[-1:]]), -1, 0)
    w_b = joined(w)
    return w_b, ADMMState(w=w_b, z=joined(z), y=joined(y), rho=rho), \
        admm._info(stats, Bb, dev)
