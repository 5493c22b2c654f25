"""Solution-quality diagnostics: objective, feasibility, KKT residuals
(PyTorch port of ``pdp_lqr_tpu/utils/quality.py``).

The reference's de-facto quality check is printing the first controls
and final state for eyeballing (examples/lqr_example.cpp:185-190).  Here
quality is a computable record of tensors — batched, no host read —
suitable for serving-side monitoring and test assertions.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from pdp_lqr_tpu_torch.ops import projections
from pdp_lqr_tpu_torch.problem import LQRProblem


@dataclasses.dataclass(frozen=True)
class SolveQuality:
    objective: torch.Tensor        # () cost 1/2 w'Hw + h'w summed over stages
    dyn_residual: torch.Tensor     # () max |x+ - Ax - Bu - c|
    box_violation: torch.Tensor    # () max box constraint violation
    cone_violation: torch.Tensor   # () max SOC violation (||v|| - t - shift)

    def __repr__(self):
        return (f"SolveQuality(obj={self.objective:.6g}, "
                f"dyn={self.dyn_residual:.2e}, box={self.box_violation:.2e}, "
                f"cone={self.cone_violation:.2e})")


def assess(
    problem: LQRProblem,
    ws,
    cones: Sequence[projections.ConeSpec] = (),
    soc_shift=None,
) -> SolveQuality:
    """Evaluate a trajectory ws (N+1, nz) against the problem data.

    A batched problem with ws (B, N+1, nz) gives (B,) fields, each
    instance's own maxima (``assess_batched``).
    """
    nu = problem.nu
    amax = lambda x: x.amax(dim=(-2, -1))
    obj = 0.5 * torch.einsum("...kz,...kzw,...kw->...", ws, problem.H, ws) \
        + torch.einsum("...kz,...kz->...", problem.h, ws)

    us = ws[..., :-1, :nu]
    xs = ws[..., nu:]
    x_pred = (
        torch.einsum("...kij,...kj->...ki", problem.A, xs[..., :-1, :])
        + torch.einsum("...kij,...kj->...ki", problem.B, us)
        + problem.c
    )
    dyn = amax((xs[..., 1:, :] - x_pred).abs())

    zero = torch.zeros_like(obj)
    if problem.nc == 0:
        return SolveQuality(objective=obj, dyn_residual=dyn,
                            box_violation=zero, cone_violation=zero)

    vals = torch.einsum("...kcz,...kz->...kc", problem.D, ws)
    mask = torch.any(problem.D != 0, dim=-1)
    cones3 = projections.normalize_cones(cones)
    cone_rows = torch.zeros_like(mask)
    for off, dim, _ in cones3:
        cone_rows[..., off:off + dim] = True
    box_mask = mask & ~cone_rows

    ninf = torch.full_like(vals, float("-inf"))
    lo = torch.where(box_mask, problem.e_lb - vals, ninf)
    hi = torch.where(box_mask, vals - problem.e_ub, ninf)
    box = torch.clamp(torch.maximum(amax(lo), amax(hi)), min=0.0)

    cone = zero
    for off, dim, kind in cones3:
        blk = vals[..., off:off + dim]
        if soc_shift is not None:
            blk = blk + soc_shift[..., off:off + dim]
        if kind == "soc":
            t = blk[..., 0]
            vnorm = torch.sqrt(torch.sum(blk[..., 1:] ** 2, dim=-1))
            viol = vnorm - t
        else:  # rsoc: p, q >= 0 and ||x|| <= sqrt(2 p q)
            p, q = blk[..., 0], blk[..., 1]
            vnorm = torch.sqrt(torch.sum(blk[..., 2:] ** 2, dim=-1))
            cap = torch.sqrt(2.0 * p.clamp(min=0.0) * q.clamp(min=0.0))
            viol = torch.maximum(vnorm - cap, torch.maximum(-p, -q))
        active = torch.any(problem.D[..., off:off + dim, :] != 0,
                           dim=(-2, -1))
        viol = torch.where(active, viol, torch.full_like(viol, float("-inf")))
        cone = torch.maximum(cone, viol.amax(dim=-1))
    cone = torch.clamp(cone, min=0.0)

    return SolveQuality(objective=obj, dyn_residual=dyn,
                        box_violation=box, cone_violation=cone)


# ``assess`` takes a leading batch axis of (problem, ws) as it is.
assess_batched = assess
