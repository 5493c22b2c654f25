"""Projections onto boxes and second-order cones (PyTorch port of
``pdp_lqr_tpu/ops/projections.py``).

Everything is elementwise and branch-free and batches over arbitrary
leading axes (stages, instances).

Cone layout: constraint rows of a stage may be grouped into second-order
cones.  A cone spec ``(offset, dim)`` declares rows [offset, offset+dim)
of every stage's constraint block as one SOC
  { (t, v) in R x R^{dim-1} : ||v||_2 <= t }
with row ``offset`` the t-row.  A 3-tuple ``(offset, dim, kind)`` selects
the cone family: ``"soc"`` (default) or ``"rsoc"`` (rotated SOC
{ (p, q, x) : 2 p q >= ||x||^2, p >= 0, q >= 0 }, rows offset / offset+1
the p/q rows).  Cone specs are static (Python ints).
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

ConeSpec = Union[Tuple[int, int], Tuple[int, int, str]]

_KINDS = ("soc", "rsoc")


def normalize_cones(cones: Sequence[ConeSpec]) -> Tuple[Tuple[int, int, str], ...]:
    """Canonicalize cone specs to (offset, dim, kind) 3-tuples, sorted by
    row; the (offset, dim) 2-tuple form defaults to "soc".  Overlapping
    blocks are rejected: two cones sharing rows would project against
    each other."""
    out = []
    for spec in cones:
        if len(spec) == 2:
            off, dim = spec
            kind = "soc"
        else:
            off, dim, kind = spec
        if kind not in _KINDS:
            raise ValueError(f"unknown cone kind {kind!r}; expected {_KINDS}")
        if kind == "rsoc" and dim < 2:
            raise ValueError("rsoc cone needs dim >= 2 (p and q rows)")
        out.append((int(off), int(dim), kind))
    out.sort(key=lambda s: s[0])
    for (o1, d1, _), (o2, _, _) in zip(out, out[1:]):
        if o1 + d1 > o2:
            raise ValueError(
                f"overlapping cone blocks at rows {o1}..{o1 + d1 - 1} "
                f"and {o2}.."
            )
    return tuple(out)


def project_box(v, lb, ub):
    """Euclidean projection onto [lb, ub] (elementwise clip)."""
    return torch.clamp(v, min=lb, max=ub)


def project_soc(v, axis: int = -1, eps: float = 1e-12):
    """Project [t; x] (t = first entry along ``axis``) onto the SOC.

    Branch-free closed form:
      ||x|| <= t      -> v                      (inside)
      ||x|| <= -t     -> 0                      (polar interior)
      else            -> (t + ||x||)/2 * [1; x/||x||]
    """
    v = torch.movedim(v, axis, -1)
    t = v[..., 0]
    x = v[..., 1:]
    nx = torch.sqrt(torch.sum(x * x, dim=-1))
    scale = 0.5 * (t + nx)

    inside = nx <= t
    polar = nx <= -t

    safe_nx = torch.where(nx > eps, nx, torch.ones_like(nx))
    x_dir = x / safe_nx[..., None]
    zero = torch.zeros_like(t)
    t_proj = torch.where(inside, t, torch.where(polar, zero, scale))
    x_proj = torch.where(
        inside[..., None],
        x,
        torch.where(polar[..., None], torch.zeros_like(x),
                    scale[..., None] * x_dir),
    )
    out = torch.cat([t_proj[..., None], x_proj], dim=-1)
    return torch.movedim(out, -1, axis)


_SQRT_HALF = 0.7071067811865476


def project_rsoc(v, axis: int = -1, eps: float = 1e-12):
    """Project [p; q; x] onto the rotated SOC {2pq >= ||x||^2, p,q >= 0}.

    Exact via the orthogonal change of basis Q (p,q,x) =
    ((p+q)/sqrt2, (p-q)/sqrt2, x), which maps the rotated cone onto the
    standard SOC:  Pi_rsoc = Q^T Pi_soc Q.
    """
    v = torch.movedim(v, axis, -1)
    p = v[..., 0]
    q = v[..., 1]
    t = _SQRT_HALF * (p + q)
    s = _SQRT_HALF * (p - q)
    rot = torch.cat([t[..., None], s[..., None], v[..., 2:]], dim=-1)
    proj = project_soc(rot, axis=-1, eps=eps)
    tp = proj[..., 0]
    sp = proj[..., 1]
    out = torch.cat(
        [
            (_SQRT_HALF * (tp + sp))[..., None],
            (_SQRT_HALF * (tp - sp))[..., None],
            proj[..., 2:],
        ],
        dim=-1,
    )
    return torch.movedim(out, -1, axis)


def project_cone(v, kind: str, axis: int = -1, eps: float = 1e-12):
    """Dispatch a cone-block projection by (static) kind."""
    if kind == "soc":
        return project_soc(v, axis=axis, eps=eps)
    if kind == "rsoc":
        return project_rsoc(v, axis=axis, eps=eps)
    raise ValueError(f"unknown cone kind {kind!r}")


def project_rows(v, lb, ub, cones, shift=None, axis: int = -1):
    """Box clip, then every cone block of ``cones`` (normalized
    3-tuples) projected in place along ``axis``; ``shift`` offsets the
    cone rows: Pi(v) = Pi_cone(v + shift) - shift."""
    out = project_box(v, lb, ub)
    if not cones:
        return out
    out = torch.movedim(out, axis, -1).clone()
    vm = torch.movedim(v, axis, -1)
    sm = None if shift is None else torch.movedim(shift, axis, -1)
    for off, dim, kind in cones:
        blk = vm[..., off:off + dim]
        if sm is not None:
            s = sm[..., off:off + dim]
            blk = project_cone(blk + s, kind, axis=-1) - s
        else:
            blk = project_cone(blk, kind, axis=-1)
        out[..., off:off + dim] = blk
    return torch.movedim(out, -1, axis)


def project_constraints(v, lb, ub, cones: Sequence[ConeSpec] = (), shift=None):
    """Project stage constraint values onto box x (shifted) cones.

    v/lb/ub: (..., nc).  Box rows are clipped; rows covered by a cone
    spec are cone-projected instead (their bounds should be +-inf).

    ``shift`` ((..., nc) or None) gives cones an affine offset: row
    values z with z + shift in the cone, i.e. the projection is
    Pi(v) = Pi_cone(v + shift) - shift.  This expresses cones like
    ||u_xy|| <= t + margin (thrust/friction cones with a constant
    term), which the pure D w in SOC form cannot.
    """
    return project_rows(v, lb, ub, normalize_cones(cones), shift, axis=-1)
