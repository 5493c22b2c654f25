"""The split conic ADMM iteration's two kernels for an NVIDIA card.

Counterpart of the split pair in ``pdp_lqr_tpu/ops/pallas_admm.py``
(named after its route, CUDA C++).  Wrapper names, argument order, the
batch-last ``(N, ..., B)`` layout and the returned tuples are that
module's.  Two kernels live here, written by hand in
``csrc/admm_kernels.cu``:

  admm_bwd_vec_prefold_lanes  kernel A: the cached-factor vector sweep on
                              the packed streams AK = [A; K], BL = [B; L]
                              and the already-folded linear cost ``hf``
  admm_fwd_update_lanes       kernel B: closed-loop rollout fused with the
                              relaxation, the box / cone projection, the
                              dual update, the next iteration's ``hf``
                              and the residual maxima

One model serves B scenarios: the shared streams carry a trailing batch
dimension of size 1 — one copy that every block reads — while the
per-scenario tensors run the full batch.

Beside each kernel stands a plain PyTorch version (``*_reference``): a
Python loop over stages on the same tensors.  A wrapper takes the plain
version only for CPU tensors; a CUDA tensor goes to the kernel or the
call raises.  Each wrapper counts its launches in ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes

import torch

from pdp_lqr_tpu_torch.ops import _build, cuda_riccati, projections
from pdp_lqr_tpu_torch.ops.cuda_riccati import (
    _INT, _PTR, _SCALARS, _check, _check_status, _mtv, _mv, _stream,
)

SOURCE = "admm_kernels.cu"

# Launches of each kernel made by this process (a wrapper adds one
# exactly where it launches its kernel).
LAUNCHES = {"admm_bwd_vec_prefold_lanes": 0, "admm_fwd_update_lanes": 0}

_DOUBLE = ctypes.c_double
_CONE_KINDS = {"soc": 0, "rsoc": 1}
MAX_CONES = 8                   # the kernel source's table holds 8


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def kernel_defines(dtype, nx: int, nu: int, nc: int | None = None, *,
                   cones=(), diag_cost: bool = False,
                   has_shift: bool = False) -> dict:
    """The ``-D`` flags of one specialisation of the kernel source:
    without ``nc`` kernel A (it reads no constraint rows), with it
    kernel B, whose cone list (normalized ``(offset, dim, kind)``), cost
    form and shift presence are compile-time too."""
    if dtype not in _SCALARS:
        raise TypeError(f"the kernels take float32 or float64, got {dtype}")
    defines = {"SCALAR": _SCALARS[dtype], "NX": nx, "NU": nu}
    if nc is None:
        return defines
    if len(cones) > MAX_CONES:
        raise ValueError(f"kernel B takes at most {MAX_CONES} cones, "
                         f"got {len(cones)}")
    defines.update(NC=nc, DIAG_COST=int(diag_cost), HAS_SHIFT=int(has_shift),
                   NCONES=len(cones))
    for q, (off, dim, kind) in enumerate(cones):
        if off < 0 or off + dim > nc or dim >= 1000:
            raise ValueError(f"cone rows {off}..{off + dim - 1} outside "
                             f"the {nc} constraint rows")
        # One integer a cone: a -D value cannot hold a comma.
        defines[f"CONE{q}"] = off * 1000000 + dim * 1000 + _CONE_KINDS[kind]
    return defines


def bind_library(lib, *, forward_update: bool):
    """Declare the C entry point's argument types (pointers and the
    stream as ``c_void_p``: ctypes would cut them to 32 bits otherwise)."""
    if forward_update:
        fn = lib.admm_fwd_update
        fn.argtypes = [_INT, _INT, _DOUBLE, _DOUBLE] + [_PTR] * 14
    else:
        fn = lib.admm_bwd_vec_prefold
        fn.argtypes = [_INT, _INT] + [_PTR] * 8
    fn.restype = _INT
    lib._admm_bound = True


def _library(dtype, nx, nu, nc=None, **modes):
    lib = _build.load(SOURCE, kernel_defines(dtype, nx, nu, nc, **modes))
    if not getattr(lib, "_admm_bound", False):
        bind_library(lib, forward_update=nc is not None)
    return lib


# -------------------------------------------------------------- kernel A

def admm_bwd_vec_prefold_lanes_reference(pN, AK, BL, c, Pc, hf, *, nu):
    """Plain PyTorch version of ``admm_bwd_vec_prefold_lanes``: the
    cached-factor vector recursion of
    ``cuda_riccati.backward_vectors_lanes_reference`` read off the packed
    streams, its two outputs joined to ``dv``."""
    nx = AK.shape[2]
    d, v = cuda_riccati.backward_vectors_lanes_reference(
        AK[:, :nx], BL[:, :nx], c, hf, None, AK[:, nx:], BL[:, nx:], pN,
        Pc=Pc)
    return torch.cat([d, v], dim=1)


def _launch_bwd_vec_prefold(lib, pN, AK, BL, c, Pc, hf, stream):
    """Allocate kernel A's output and launch it (no argument checks)."""
    N, nz = hf.shape[0], hf.shape[1]
    Bt = hf.shape[-1]
    dv = torch.empty((N, nz, Bt), dtype=hf.dtype, device=hf.device)
    status = lib.admm_bwd_vec_prefold(
        N, Bt, stream,
        *(x.data_ptr() for x in (pN, AK, BL, c, Pc, hf, dv)))
    _check_status("admm_bwd_vec_prefold_lanes", status)
    return dv


def admm_bwd_vec_prefold_lanes(pN, AK, BL, c, Pc, hf, *, nu):
    """Split-iteration kernel A on the already-folded linear cost.

    Shared streams, packed on the per-stage row axis: AK = [A; K]
    (N, nz, nx, 1), BL = [B; L] (N, nz, nu, 1).  Per scenario: pN (nx, B)
    the iterate-folded terminal linear cost, c (N, nx, B), Pc (N, nx, B)
    the pre-folded ``P_{k+1} c_k``, hf (N, nz, B) the linear cost
    ``h - sigma w - D^T (rho z - y)`` that kernel B emitted (valid while
    rho is unchanged).  Per stage, backwards from ``p = pN``:

      Pcp  = Pc + p                 rbar = hf[:nu] + B^T Pcp
      d    = -(L L^T)^{-1} rbar     v    = B d + c
      p    = hf[nu:] + A^T Pcp + K^T rbar

    Returns dv (N, nz, B) = [d | v].

    On the card: a block serves 32 scenarios with 4 threads each and
    copies every stage's inputs into a shared-memory ring ahead of their
    use, reading the packed streams as they are; see the kernel source.
    """
    N, nz, nx = AK.shape[0], AK.shape[1], AK.shape[2]
    if nz != nx + nu:
        raise ValueError(f"AK has {nz} rows, expected nx + nu = {nx + nu}")
    Bt = hf.shape[-1]
    dt, dev = hf.dtype, hf.device
    for name, x, shape in (
        ("pN", pN, (nx, Bt)), ("AK", AK, (N, nz, nx, 1)),
        ("BL", BL, (N, nz, nu, 1)), ("c", c, (N, nx, Bt)),
        ("Pc", Pc, (N, nx, Bt)), ("hf", hf, (N, nz, Bt)),
    ):
        _check(name, x, shape, dt, dev)
    if dev.type == "cpu":
        return admm_bwd_vec_prefold_lanes_reference(pN, AK, BL, c, Pc, hf,
                                                    nu=nu)
    if dev.type != "cuda":
        raise ValueError(f"admm_bwd_vec_prefold_lanes: no kernel for device {dev}")
    lib = _library(dt, nx, nu)
    with torch.cuda.device(dev):
        dv = _launch_bwd_vec_prefold(lib, pN, AK, BL, c, Pc, hf, _stream())
    LAUNCHES["admm_bwd_vec_prefold_lanes"] += 1
    return dv


# -------------------------------------------------------------- kernel B

def admm_fwd_update_lanes_reference(rho, x0, MK, Hs, D, bnd, dv, wzy, h, *,
                                    nu, cones, alpha, sigma):
    """Plain PyTorch version of ``admm_fwd_update_lanes`` (packed
    streams, hf-emit): a Python loop over the stages, k = 0 .. N-1.
    ``cones`` are normalized ``(offset, dim, kind)`` 3-tuples."""
    N, nz, nx = MK.shape[0], MK.shape[1], MK.shape[2]
    nc = D.shape[1]
    has_shift = bnd.shape[1] == 4
    diag_cost = Hs.ndim == 3
    rho_b = rho[0]
    x = x0
    acc = torch.zeros((4, wzy.shape[-1]), dtype=wzy.dtype, device=wzy.device)
    amax = lambda t: t.abs().amax(dim=0)
    wzy_rows, hf_rows = [], []
    for k in range(N):
        M, K = MK[k, :nx], MK[k, nx:]
        u = _mv(K, x) + dv[k, :nu]
        w_t = torch.cat([u, x], dim=0)
        x = _mv(M, x) + dv[k, nu:]

        w, z, y = wzy[k, :nz], wzy[k, nz:nz + nc], wzy[k, nz + nc:]
        Dk = D[k]
        lb, ub, m = bnd[k, 0], bnd[k, 1], bnd[k, 2]
        sh = bnd[k, 3] if has_shift else None

        z_t = _mv(Dk, w_t)
        w_new = alpha * w_t + (1.0 - alpha) * w
        rho_m = rho_b[None, :] * m
        active = m > 0
        relaxed = alpha * z_t + (1.0 - alpha) * z
        v = relaxed + torch.where(
            active, y / torch.clamp(rho_m, min=1e-30), torch.zeros_like(y))
        z_new = projections.project_rows(v, lb, ub, cones, sh, axis=0) \
            * active.to(v.dtype)
        y_new = y + rho_m * (relaxed - z_new)
        wzy_rows.append(torch.cat([w_new, z_new, y_new], dim=0))
        # The next iteration's folded linear cost, valid while rho stays.
        rg = rho_m * z_new - y_new
        hf_rows.append(h[k] - sigma * w_new - _mtv(Dk, rg))

        Hmv = (lambda t: Hs[k] * t) if diag_cost else (lambda t: _mv(Hs[k], t))
        Dw_new = _mv(Dk, w_new)
        dw = w - w_t
        zt_term = rho_m * ((alpha - 1.0) * (z_t - z) + (z - z_new))
        dvec = ((1.0 - alpha) * Hmv(dw) + (alpha * sigma) * dw
                + _mtv(Dk, zt_term))
        Hw = Hmv(w_new) - sigma * w_new
        dty = _mtv(Dk, y_new)
        acc = torch.maximum(acc, torch.stack([
            amax(Dw_new - z_new), amax(dvec),
            torch.maximum(amax(Dw_new), amax(z_new)),
            torch.maximum(amax(Hw), amax(dty)),
        ]))
    return torch.stack(wzy_rows), torch.stack(hf_rows), x, acc


def _launch_fwd_update(lib, rho, x0, MK, Hs, D, bnd, dv, wzy, h, alpha,
                       sigma, stream):
    """Allocate kernel B's outputs and launch it (no argument checks)."""
    N, nz, nx = MK.shape[0], MK.shape[1], MK.shape[2]
    Bt = wzy.shape[-1]
    new = lambda *shape: torch.empty(shape, dtype=wzy.dtype, device=wzy.device)
    wzy_new, hf_new = new(*wzy.shape), new(N, nz, Bt)
    xN, res = new(nx, Bt), new(4, Bt)
    status = lib.admm_fwd_update(
        N, Bt, float(alpha), float(sigma), stream,
        *(x.data_ptr() for x in (rho, x0, MK, Hs, D, bnd, h, dv, wzy,
                                 wzy_new, hf_new, xN, res)))
    _check_status("admm_fwd_update_lanes", status)
    return wzy_new, hf_new, xN, res


def admm_fwd_update_lanes(rho, x0, M, K, Hs, D, lb, ub, mask, shift,
                          dv, wzy, *, nu, cones, alpha, sigma,
                          ladder_oh=None, h=None):
    """Split-iteration kernel B: closed-loop rollout + relax / project /
    dual / residual tail, in its packed hf-emit form.

    The argument list is the JAX wrapper's; the form served is the one
    the non-ladder split iteration calls: ``K``, ``ub``, ``mask``,
    ``shift`` and ``ladder_oh`` are None, ``M`` carries MK = [M; K]
    (N, nz, nx, 1), ``lb`` carries bnd = stack(lb, ub, mask[, shift])
    (N, 3+s, nc, 1) (shift presence is read off its row count; the mask
    row carries the per-row rho scale, 0 on padded rows), and ``h``
    (N, nz, 1) is the raw linear cost.  ``Hs`` is the sigma-folded stage
    Hessian (N, nz, nz, 1), or its diagonal (N, nz, 1) for a diagonal
    stage cost (read off its rank).  ``D`` (N, nc, nz, 1).  Per scenario:
    rho (1, B), x0 (nx, B), dv = [d | v] (N, nz, B) from kernel A and the
    packed iterates wzy = [w | z | y] (N, nz + 2 nc, B).  ``cones`` are
    normalized ``(offset, dim, kind)`` 3-tuples.

    Returns (wzy_new, hf_next (N, nz, B), xN (nx, B), res (4, B)) with
    res rows [r_prim, r_dual, prim_scale, dual_scale] maxima over the
    stages; the caller folds the terminal stage.

    The unpacked forms (separate M / K / bounds, R ladder rungs stacked
    on rows) and the form without ``h`` belong to the rho-ladder
    iteration and raise ``NotImplementedError`` until it is ported.

    On the card: a block serves 32 scenarios with 8 threads each, every
    stage's inputs ride a shared-memory ring; see the kernel source.
    """
    if (K is not None or ub is not None or mask is not None
            or shift is not None or ladder_oh is not None or h is None):
        raise NotImplementedError(
            "admm_fwd_update_lanes serves the packed hf-emit form (K, ub, "
            "mask, shift, ladder_oh None; h given); the unpacked R-rung "
            "form and the form without hf-emit wait for the rho-ladder "
            "iteration (ROADMAP M5, with kernel K6)")
    MK, bnd = M, lb
    cones = tuple(cones)
    N, nz, nx = MK.shape[0], MK.shape[1], MK.shape[2]
    if nz != nx + nu:
        raise ValueError(f"MK has {nz} rows, expected nx + nu = {nx + nu}")
    Bt = wzy.shape[-1]
    nc = D.shape[1]
    dt, dev = wzy.dtype, wzy.device
    if bnd.ndim != 4 or bnd.shape[1] not in (3, 4):
        raise ValueError(f"bnd: shape {tuple(bnd.shape)}, expected "
                         f"(N, 3 or 4, nc, 1)")
    if Hs.ndim not in (3, 4):
        raise ValueError(f"Hs: shape {tuple(Hs.shape)}, expected "
                         f"(N, nz, 1) or (N, nz, nz, 1)")
    has_shift = bnd.shape[1] == 4
    diag_cost = Hs.ndim == 3
    for name, x, shape in (
        ("rho", rho, (1, Bt)), ("x0", x0, (nx, Bt)),
        ("MK", MK, (N, nz, nx, 1)),
        ("Hs", Hs, (N, nz, 1) if diag_cost else (N, nz, nz, 1)),
        ("D", D, (N, nc, nz, 1)), ("bnd", bnd, (N, bnd.shape[1], nc, 1)),
        ("h", h, (N, nz, 1)), ("dv", dv, (N, nz, Bt)),
        ("wzy", wzy, (N, nz + 2 * nc, Bt)),
    ):
        _check(name, x, shape, dt, dev)
    if dev.type == "cpu":
        return admm_fwd_update_lanes_reference(
            rho, x0, MK, Hs, D, bnd, dv, wzy, h, nu=nu, cones=cones,
            alpha=alpha, sigma=sigma)
    if dev.type != "cuda":
        raise ValueError(f"admm_fwd_update_lanes: no kernel for device {dev}")
    lib = _library(dt, nx, nu, nc, cones=cones, diag_cost=diag_cost,
                   has_shift=has_shift)
    with torch.cuda.device(dev):
        out = _launch_fwd_update(lib, rho, x0, MK, Hs, D, bnd, dv, wzy, h,
                                 alpha, sigma, _stream())
    LAUNCHES["admm_fwd_update_lanes"] += 1
    return out
