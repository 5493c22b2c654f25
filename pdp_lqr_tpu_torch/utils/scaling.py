"""Ruiz equilibration — OSQP sec. 5 problem scaling for the LQ problem
(PyTorch port of ``pdp_lqr_tpu/utils/scaling.py``).

The reference stores constraint bounds but ships no outer loop
(lqr_model.hpp:22-24 — e_lb/e_ub never read); the loop this package
completes is OSQP-style, and OSQP's robustness on badly-scaled data comes
from modified Ruiz equilibration of the problem plus cost normalization
(OSQP paper sec. 5.1, alg. 2).  This module is that scaling, specialized
to the stage-structured LQ problem:

  scaled variables    w_k = S_k w̄_k          (S diagonal, per stage)
  scaled constraints  rows of D scaled by E   (diagonal, per stage)
  scaled cost         H̄ = c_s S H S, h̄ = c_s S h

The dynamics are not rows of D here (they are solved exactly inside the
Riccati recursion), so variable scaling is pushed through them instead:
Ā_k = S_x,k+1^{-1} A_k S_x,k,  B̄_k = S_x,k+1^{-1} B_k S_u,k,
c̄_k = S_x,k+1^{-1} c_k,  x̄0 = S_x,0^{-1} x0.

Cone safety: a second-order-cone block is invariant under uniform row
scaling only, so E is forced constant within each cone block (the
SCS/OSQP convention for conic rows).

Unscaled-residual termination (OSQP sec. 5.2): with w = S w̄ and
y = c_s^{-1} E ȳ, the unscaled residuals follow from the scaled ones via
r_prim = E^{-1} r̄_prim and r_dual = (c_s S)^{-1} r̄_dual.
``residual_weights`` returns the (1/e, 1/(c_s s)) weight tensors the ADMM
loops apply inside their max-norms.
"""

from __future__ import annotations

import dataclasses

import torch

from pdp_lqr_tpu_torch.ops import projections
from pdp_lqr_tpu_torch.problem import _TensorRecord


@dataclasses.dataclass(frozen=True)
class RuizScaling(_TensorRecord):
    """Diagonal scalings: ``s`` (N+1, nz) per-variable, ``e`` (N+1, nc)
    per-constraint-row, ``cost`` () the scalar cost normalization."""

    s: torch.Tensor
    e: torch.Tensor
    cost: torch.Tensor


_MIN_SCALE = 1e-4
_MAX_SCALE = 1e4


def _safe(x, lo=_MIN_SCALE, hi=_MAX_SCALE):
    return torch.clip(torch.where(x > 0, x, torch.ones_like(x)), lo, hi)


def ruiz_equilibrate(problem, cones=(), iters: int = 10,
                     scale_variables: bool = False) -> RuizScaling:
    """Compute a RuizScaling for ``problem`` (unbatched).

    Default mode (``scale_variables=False``, s = 1): modified Ruiz on the
    CONSTRAINT ROWS (E) plus cost normalization (c) — the two scalings
    that commute with this solver's architecture.  OSQP alg. 2 also
    scales the variables symmetrically, but there the dynamics are
    ordinary constraint rows; here they are ELIMINATED (solved exactly
    inside the Riccati recursion), and pushing a per-stage diagonal S
    through them (A -> S_{x,k+1}^{-1} A S_{x,k}) wrecks the recursion's
    conditioning whenever states appear in the cost / constraints
    unevenly.  Row scaling E and the cost scalar c carry the robustness
    payload at zero dynamics risk.

    ``scale_variables=True`` additionally runs the full KKT-block Ruiz
    [H_k; E_k D_k; Ed_k G_k] with G_k = [B_k A_k | -I] the dynamics rows
    anchoring otherwise-unseen state columns (Ed internal to the
    iteration).  Use only on problems whose states are uniformly
    represented in the cost.

    ``cones`` are (offset, dim[, kind]) specs into the constraint block;
    rows of one cone share a single scale (cone invariance).
    """
    H, D, h = problem.H, problem.D, problem.h
    A, B = problem.A, problem.B
    nper = H.shape[0]
    nz = H.shape[-1]
    nu = B.shape[-1]
    nc = D.shape[-2]
    dt, dev = H.dtype, H.device
    cones3 = projections.normalize_cones(tuple(cones))
    G = torch.cat([B, A], dim=-1)                 # (N, nx, nz)

    s = torch.ones((nper, nz), dtype=dt, device=dev)
    e = torch.ones((nper, nc), dtype=dt, device=dev)
    ed = torch.ones(A.shape[:-1], dtype=dt, device=dev)   # (N, nx)

    def uniform_cones(ev):
        ev = ev.clone()
        for off, dim, _ in cones3:
            blk = ev[:, off:off + dim]
            g = torch.exp(torch.mean(torch.log(_safe(blk)), dim=1,
                                     keepdim=True))
            ev[:, off:off + dim] = g.expand(blk.shape)
        return ev

    for _ in range(iters):
        if scale_variables:
            Hs = s[:, :, None] * H * s[:, None, :]
            cn = Hs.abs().amax(dim=-2)
            if nc:
                Ds = e[:, :, None] * D * s[:, None, :]
                cn = torch.maximum(cn, Ds.abs().amax(dim=-2))
            # Dynamics-row contributions: row k touches [u_k; x_k]
            # through [B A] and x_{k+1} through -I.
            Gs = ed[:, :, None] * G * s[:-1][:, None, :]
            cn = cn.clone()
            cn[:-1] = torch.maximum(cn[:-1], Gs.abs().amax(dim=-2))
            cn[1:, nu:] = torch.maximum(cn[1:, nu:], ed * s[1:, nu:])
            s = s / torch.sqrt(_safe(cn))
        if nc:
            Ds = e[:, :, None] * D * s[:, None, :]
            rn = Ds.abs().amax(dim=-1)
            e = e / torch.sqrt(_safe(rn))
            e = uniform_cones(e)
        if scale_variables:
            Gs = ed[:, :, None] * G * s[:-1][:, None, :]
            rn_d = torch.maximum(Gs.abs().amax(dim=-1), ed * s[1:, nu:])
            ed = ed / torch.sqrt(_safe(rn_d))

    if scale_variables:
        # Factor the UNIFORM component of s out into the scalar cost
        # normalization below: symmetric diagonal scaling multiplies the
        # quadratic term by s^2 but the linear term by s, so a uniform
        # s != 1 distorts the problem's h-to-H balance.  Only the RELATIVE
        # per-column equilibration belongs in s; e absorbs the uniform
        # factor.  Done ONCE after the loop — renormalizing inside it
        # breaks the Ruiz contraction along the dynamics block's
        # scale-invariant direction.
        g = torch.exp(torch.mean(torch.log(_safe(s, 1e-8, 1e8))))
        s = torch.clip(s / g, _MIN_SCALE, _MAX_SCALE)
        e = torch.clip(e * g, _MIN_SCALE, _MAX_SCALE) if nc else e

    # Cost normalization (OSQP 5.1): c_s = 1 / max(mean col norm of the
    # scaled H, inf-norm of the scaled h).
    Hs = s[:, :, None] * H * s[:, None, :]
    col = torch.mean(Hs.abs().amax(dim=-2))
    hn = (s * h).abs().max()
    cost = 1.0 / _safe(torch.maximum(col, hn), 1e-8, 1e8)
    return RuizScaling(s=s, e=e, cost=cost)


def scale_problem(problem, scaling: RuizScaling):
    """Apply the scaling: returns the scaled LQRProblem.  Terminal u-rows
    of s are never read (padded stage).  ``problem.c`` may carry a
    leading batch axis (per-scenario drift)."""
    s, e, c_s = scaling.s, scaling.e, scaling.cost
    nu = problem.nu
    su = s[:-1, :nu]                      # (N, nu)
    sx = s[:, nu:]                        # (N+1, nx)
    sx_next_inv = 1.0 / sx[1:]            # (N, nx)

    A = sx_next_inv[:, :, None] * problem.A * sx[:-1][:, None, :]
    B = sx_next_inv[:, :, None] * problem.B * su[:, None, :]
    cvec = problem.c * sx_next_inv
    H = c_s * s[:, :, None] * problem.H * s[:, None, :]
    h = c_s * s * problem.h
    D = e[:, :, None] * problem.D * s[:, None, :]
    return dataclasses.replace(problem, A=A, B=B, c=cvec, H=H, h=h, D=D,
                               e_lb=e * problem.e_lb, e_ub=e * problem.e_ub)


def scale_x0(x0, scaling: RuizScaling, nu: int):
    """x̄0 = S_x,0^{-1} x0 (x0 may carry a leading batch axis)."""
    return x0 / scaling.s[0, nu:]


def scale_soc_shift(soc_shift, scaling: RuizScaling):
    """Affine cone offsets live in constraint-row space: s̄ = E s."""
    return None if soc_shift is None else scaling.e * soc_shift


def unscale_ws(ws_bar, scaling: RuizScaling):
    """w = S w̄ (ws_bar may carry a leading batch axis)."""
    return ws_bar * scaling.s


def residual_weights(scaling: RuizScaling):
    """(prim_weight (N+1, nc), dual_weight (N+1, nz)) such that the
    UNSCALED residual inf-norms are max |r̄_prim * prim_weight| and
    max |r̄_dual * dual_weight| (OSQP 5.2 termination on unscaled
    residuals)."""
    return 1.0 / scaling.e, 1.0 / (scaling.cost * scaling.s)


def unscale_state(state, scaling: RuizScaling):
    """Map a warm-start ADMMState from scaled to unscaled space
    (w = S w̄, z = E^{-1} z̄, y = c_s^{-1} E ȳ; rho is re-usable as-is only
    approximately — kept unchanged)."""
    return dataclasses.replace(
        state,
        w=state.w * scaling.s,
        z=state.z / scaling.e,
        y=(scaling.e / scaling.cost) * state.y,
    )


def scale_state(state, scaling: RuizScaling):
    """Inverse of unscale_state (warm-starting a scaled solve from an
    unscaled state)."""
    return dataclasses.replace(
        state,
        w=state.w / scaling.s,
        z=state.z * scaling.e,
        y=(scaling.cost / scaling.e) * state.y,
    )
