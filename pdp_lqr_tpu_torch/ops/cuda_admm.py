"""The conic ADMM iteration's kernels for an NVIDIA card.

Counterpart of ``pdp_lqr_tpu/ops/pallas_admm.py`` (named after its route,
CUDA C++).  Wrapper names, argument order, the batch-last ``(N, ..., B)``
layout and the returned tuples are that module's.  Four kernels live
here, written by hand in ``csrc/admm_kernels.cu``:

  admm_bwd_vec_prefold_lanes  kernel A (K4): the cached-factor vector
                              sweep on the packed streams AK = [A; K],
                              BL = [B; L] and the already-folded cost ``hf``
  admm_bwd_vec_lanes          kernel A (K6): the same sweep with the
                              iterate fold inside the kernel and R rungs
                              of factors, one picked per scenario
  admm_fwd_update_lanes       kernel B (K5): closed-loop rollout fused with
                              the relaxation, the box / cone projection,
                              the dual update, optionally the next
                              iteration's ``hf``, and the residual maxima
  admm_iter_lanes             K8: the whole iteration in one launch, the
                              backward sweep (matrix, or vector on cached
                              factors) then the rollout and K5's tail

One model serves B scenarios: the shared streams carry a trailing batch
dimension of size 1 — one copy that every block reads — while the
per-scenario tensors run the full batch.  A rho ladder stacks R rungs'
factors on the rows of a shared stream; a scenario's rung is an int32
index (``rung``, (B,)) that the caller keeps beside rho, or the JAX
wrapper's one-hot ``ladder_oh`` (R, B), turned into that index.

Beside each kernel stands a plain PyTorch version (``*_reference``): a
Python loop over stages on the same tensors.  A wrapper takes the plain
version only for CPU tensors; a CUDA tensor goes to the kernel or the
call raises.  Each wrapper counts its launches in ``LAUNCHES``.

Narrow streams (the JAX function's ``storage_dtype`` on the split and
ladder iterations): K4, K5 and K6 also take the JAX package's narrow set
of their streams stored in bfloat16 while everything else, and every
product, stays in the compute type (that of ``hf`` / ``wzy``): K4 AK, BL
and c; K6 A, B, h, D, P, L, K and c; K5 M (or MK), K, Hs, D and h.  Their
narrow forms (``-DSTAGE_BF16``) widen each entry on the card; the plain
versions widen each stream as they load it.  A narrow form's launches
count as ``LAUNCHES["<wrapper>[bf16]"]``.  A narrow set must be narrow
as a whole: a mix of widths, or another storage type, raises.
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
LAUNCHES = {"admm_bwd_vec_prefold_lanes": 0, "admm_bwd_vec_lanes": 0,
            "admm_fwd_update_lanes": 0, "admm_iter_lanes": 0,
            "admm_bwd_vec_prefold_lanes[bf16]": 0,
            "admm_bwd_vec_lanes[bf16]": 0, "admm_fwd_update_lanes[bf16]": 0}

_DOUBLE = ctypes.c_double
_CONE_KINDS = {"soc": 0, "rsoc": 1}
MAX_CONES = 8                   # the kernel source's table holds 8


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def kernel_defines(dtype, nx: int, nu: int, nc: int | None = None, *,
                   cones=(), diag_cost: bool = False,
                   has_shift: bool = False, fold: bool = False,
                   rungs: int = 1, single: bool = False,
                   narrow: bool = False) -> dict:
    """The ``-D`` flags of one specialisation of the kernel source:
    without ``nc`` kernel K4 (it reads no constraint rows); with it and
    ``fold`` kernel K6; with it and ``single`` kernel K8; with it alone
    kernel K5.  K5's and K8's cone list (normalized ``(offset, dim,
    kind)``) and shift presence are compile-time, as is K5's cost form;
    K8's forms (shared or batched, cached or not, the storage type) are
    template switches of one library.  ``rungs`` (K5, K6) is the number
    of ladder rungs the factor streams stack.  ``narrow`` (K4, K5, K6):
    the form on bfloat16 narrow streams (``-DSTAGE_BF16``)."""
    if dtype not in _SCALARS:
        raise TypeError(f"the kernels take float32 or float64, got {dtype}")
    if narrow and single:
        raise ValueError("K8's storage type is a template switch of its "
                         "library: narrow is for K4, K5 and K6")
    defines = {"SCALAR": _SCALARS[dtype], "NX": nx, "NU": nu}
    if narrow:
        defines["STAGE_BF16"] = 1
    if nc is None:
        return defines
    defines["NC"] = nc
    if rungs != 1:
        defines["NRUNG"] = int(rungs)
    if fold:
        defines["FOLD"] = 1
        return defines
    if len(cones) > MAX_CONES:
        raise ValueError(f"kernels B and K8 take at most {MAX_CONES} cones, "
                         f"got {len(cones)}")
    if single:
        defines["ITER"] = 1
    else:
        defines["DIAG_COST"] = int(diag_cost)
    defines.update(HAS_SHIFT=int(has_shift), NCONES=len(cones))
    for q, (off, dim, kind) in enumerate(cones):
        if off < 0 or off + dim > nc or dim >= 1000:
            raise ValueError(f"cone rows {off}..{off + dim - 1} outside "
                             f"the {nc} constraint rows")
        # One integer a cone: a -D value cannot hold a comma.
        defines[f"CONE{q}"] = off * 1000000 + dim * 1000 + _CONE_KINDS[kind]
    return defines


def bind_library(lib, defines: dict):
    """Declare the C entry point's argument types (pointers and the
    stream as ``c_void_p``: ctypes would cut them to 32 bits otherwise);
    which entry the library holds follows from its ``-D`` flags."""
    if "NC" not in defines:
        fn = lib.admm_bwd_vec_prefold
        fn.argtypes = [_INT, _INT] + [_PTR] * 8
    elif "FOLD" in defines:
        fn = lib.admm_bwd_vec
        fn.argtypes = [_INT, _INT, _DOUBLE, _INT] + [_PTR] * 16
    elif "ITER" in defines:
        fn = lib.admm_iter
        fn.argtypes = [_INT, _INT, _DOUBLE, _DOUBLE, _INT, _INT, _INT] \
            + [_PTR] * 27
    else:
        fn = lib.admm_fwd_update
        fn.argtypes = [_INT, _INT, _DOUBLE, _DOUBLE, _INT, _INT, _INT] \
            + [_PTR] * 16
    fn.restype = _INT
    lib._admm_bound = True


def _library(dtype, nx, nu, nc=None, **modes):
    defines = kernel_defines(dtype, nx, nu, nc, **modes)
    lib = _build.load(SOURCE, defines)
    if not getattr(lib, "_admm_bound", False):
        bind_library(lib, defines)
    return lib


def _narrow(name, streams, dt):
    """Whether a kernel's narrow set ``streams`` ((name, tensor or None)
    pairs; None: not read) is stored in bfloat16 (True) or in the compute
    type ``dt`` (False).  A mix of the two, or another type, raises."""
    types = {x.dtype for _, x in streams if x is not None}
    if not types <= {dt, cuda_riccati.NARROW}:
        raise TypeError(
            f"{name}: {', '.join(n for n, _ in streams)} stored as "
            f"{sorted(map(str, types))} under {dt} compute: the kernels "
            f"take the compute type or bfloat16 (storage_dtype="
            f"torch.bfloat16 only)")
    if len(types) > 1:
        raise TypeError(
            f"{name}: {', '.join(n for n, _ in streams)} are one narrow "
            f"set, all in bfloat16 or all in {dt}: got "
            + ", ".join(f"{n} {x.dtype}" for n, x in streams
                        if x is not None))
    return types == {cuda_riccati.NARROW} and dt != cuda_riccati.NARROW


def _wide(dt, *streams):
    """The plain versions' load of narrow streams: widened to ``dt``."""
    return tuple(None if x is None else x.to(dt) for x in streams)


def _rungs(stacked, rows, R, rung, ladder_oh, Bt, device):
    """The per-scenario rung index (int32, (B,)) of R stacked rungs, from
    ``rung`` or from the one-hot ``ladder_oh`` (R, B); None for one rung."""
    if stacked.shape[1] != R * rows:
        raise ValueError(f"a rung stream has {stacked.shape[1]} rows, "
                         f"expected {R} x {rows}")
    if R == 1:
        return None
    if rung is None:
        if ladder_oh is None:
            raise ValueError(f"{R} rungs need `rung` or `ladder_oh`")
        _check("ladder_oh", ladder_oh, (R, Bt), ladder_oh.dtype, device)
        rung = torch.argmax(ladder_oh, dim=0).to(torch.int32)
    _check("rung", rung, (Bt,), torch.int32, device)
    return rung


def _pick(X, rows, rung):
    """Rung ``rung[b]`` of the R rungs stacked on the rows of a shared
    (N, R*rows, cols, 1) stream, per scenario: (N, rows, cols, B); the
    stream itself for one rung."""
    if rung is None:
        return X
    N, _, cols, _ = X.shape
    R = X.shape[1] // rows
    sel = X[..., 0].reshape(N, R, rows, cols)[:, rung.long()]
    return sel.permute(0, 2, 3, 1)


# -------------------------------------------------------------- kernel A

def admm_bwd_vec_prefold_lanes_reference(pN, AK, BL, c, Pc, hf, *, nu):
    """Plain PyTorch version of ``admm_bwd_vec_prefold_lanes``: the
    cached-factor vector recursion of
    ``cuda_riccati.backward_vectors_lanes_reference`` read off the packed
    streams, its two outputs joined to ``dv``; narrow streams widened as
    they load."""
    AK, BL, c = _wide(hf.dtype, AK, BL, c)
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

    Returns dv (N, nz, B) = [d | v].  AK, BL and c may be stored in
    bfloat16 (all three), under the compute type of ``hf``.

    On the card: a block serves 32 scenarios, a lane each, and its warps
    take roles: a producer copies each stage (the packed streams as they
    lie, the scenarios' rows) into a shared-memory ring, one warp carries
    p through the stages, and tail warps compute d and v and store them
    behind it; see the kernel source.  The narrow form widens AK and BL
    into the ring as it copies them and c where the tails read it.
    """
    N, nz, nx = AK.shape[0], AK.shape[1], AK.shape[2]
    if nz != nx + nu:
        raise ValueError(f"AK has {nz} rows, expected nx + nu = {nx + nu}")
    Bt = hf.shape[-1]
    dt, dev = hf.dtype, hf.device
    narrow = _narrow("admm_bwd_vec_prefold_lanes",
                     (("AK", AK), ("BL", BL), ("c", c)), dt)
    st = cuda_riccati.NARROW if narrow else dt
    for name, x, shape, xdt in (
        ("pN", pN, (nx, Bt), dt), ("AK", AK, (N, nz, nx, 1), st),
        ("BL", BL, (N, nz, nu, 1), st), ("c", c, (N, nx, Bt), st),
        ("Pc", Pc, (N, nx, Bt), dt), ("hf", hf, (N, nz, Bt), dt),
    ):
        _check(name, x, shape, xdt, dev)
    if dev.type == "cpu":
        return admm_bwd_vec_prefold_lanes_reference(pN, AK, BL, c, Pc, hf,
                                                    nu=nu)
    if dev.type != "cuda":
        raise ValueError(f"admm_bwd_vec_prefold_lanes: no kernel for device {dev}")
    lib = _library(dt, nx, nu, narrow=narrow)
    with torch.cuda.device(dev):
        dv = _launch_bwd_vec_prefold(lib, pN, AK, BL, c, Pc, hf, _stream())
    LAUNCHES["admm_bwd_vec_prefold_lanes[bf16]" if narrow
             else "admm_bwd_vec_prefold_lanes"] += 1
    return dv


# ------------------------------------------------------------------ K6

def _fold_hf(h, D, mask, rho, wzy, sigma):
    """hf = h - sigma w - D^T (rho m z - y) from the packed iterates
    wzy = [w | z | y] (N, nz + 2 nc, B): the iterate fold of the
    reference's update_problem_data (lqr_solver.hpp:41-56)."""
    nz, nc = D.shape[2], D.shape[1]
    rg = (rho * mask) * wzy[:, nz:nz + nc] - wzy[:, nz + nc:]
    return h - sigma * wzy[:, :nz] - torch.einsum("kczb,kcb->kzb", D, rg)


def admm_bwd_vec_lanes_reference(rho, pN, A, B, h, D, mask, P, L, K, c, wzy,
                                 *, nu, sigma, rung=None, Pc=None):
    """Plain PyTorch version of ``admm_bwd_vec_lanes``: the iterate fold,
    then the cached-factor vector recursion of
    ``cuda_riccati.backward_vectors_lanes_reference`` on each scenario's
    rung (``rung`` (B,) int32, None for one rung); narrow streams widened
    as they load."""
    A, B, h, D, P, L, K, c = _wide(wzy.dtype, A, B, h, D, P, L, K, c)
    nx = A.shape[1]
    hf = _fold_hf(h, D, mask, rho, wzy, sigma)
    d, v = cuda_riccati.backward_vectors_lanes_reference(
        A, B, c, hf, None if Pc is not None else _pick(P, nx, rung),
        _pick(K, nu, rung), _pick(L, nu, rung), pN, Pc=Pc)
    return torch.cat([d, v], dim=1)


def _launch_bwd_vec(lib, rho, pN, A, B, h, D, mask, P, L, K, c, wzy, rung,
                    Pc, sigma, stream):
    """Allocate K6's output and launch it (no argument checks)."""
    N, nz = wzy.shape[0], A.shape[1] + B.shape[2]
    Bt = wzy.shape[-1]
    dv = torch.empty((N, nz, Bt), dtype=wzy.dtype, device=wzy.device)
    ptr = lambda x: None if x is None else x.data_ptr()
    status = lib.admm_bwd_vec(
        N, Bt, float(sigma), int(Pc is not None), stream,
        *(ptr(x) for x in (rho, pN, A, B, h, D, mask, P, L, K, c, Pc, wzy,
                           rung, dv)))
    _check_status("admm_bwd_vec_lanes", status)
    return dv


def admm_bwd_vec_lanes(rho, pN, A, B, h, D, mask, P, L, K, c, wzy, *, nu,
                       sigma, ladder_oh=None, Pc=None, rung=None):
    """Split-iteration kernel A with the in-kernel iterate fold (K6).

    Shared streams (trailing size 1): A (N,nx,nx,1), B (N,nx,nu,1), h
    (N,nz,1) the raw linear cost, D (N,nc,nz,1), mask (N,nc,1) the
    per-row rho scale, and the cached factors of R rungs stacked on rows:
    P (N,R*nx,nx,1), L (N,R*nu,nu,1), K (N,R*nu,nx,1).  Per scenario: rho
    (1,B), pN (nx,B) the iterate-folded terminal linear cost, c (N,nx,B)
    and the packed iterates wzy = [w | z | y] (N, nz+2nc, B).  Per stage,
    backwards from p = pN, on the scenario's own rung:

      rg   = rho m z - y            hf = h - sigma w - D^T rg
      Pcp  = P c + p                rbar = hf[:nu] + B^T Pcp
      d    = -(L L^T)^{-1} rbar     v    = B d + c
      p    = hf[nu:] + A^T Pcp + K^T rbar

    Returns dv (N, nz, B) = [d | v].

    The rung of scenario b is ``rung[b]`` ((B,) int32) or, as in the JAX
    wrapper, the row where the one-hot ``ladder_oh`` (R, B) is 1.  ``Pc``
    ((N,nx,B), one rung only) is the pre-folded ``P_{k+1} c_k``; ``P``
    is then not read (it may be None).  A, B, h, D, P, L, K and c may be
    stored in bfloat16 (all of them), under the compute type of ``wzy``.

    On the card: as ``admm_bwd_vec_prefold_lanes``, with fold warps that
    compute hf (and P c) of whole stages ahead of the warp that carries p;
    the ring's slots hold all R rungs' factors, and a lane reads its
    scenario's rung at an offset in the slot.  See the kernel source.
    In the narrow form a widening warp of its own loads the shared runs 2
    bytes an entry (asked of the L2 a few stages ahead), stores them
    widened into the ring's layout once the slot's copies landed and hands
    the slot to the fold warps on a barrier of its own; the producer warps
    only copy, and c is widened where the fold and tail warps read it.
    """
    N, nx = A.shape[0], A.shape[1]
    nz, nc = nx + nu, D.shape[1]
    Bt = wzy.shape[-1]
    dt, dev = wzy.dtype, wzy.device
    pc_mode = Pc is not None
    R = L.shape[1] // nu
    if pc_mode and (R != 1 or ladder_oh is not None or rung is not None):
        raise ValueError("Pc mode is non-ladder only")
    narrow = _narrow("admm_bwd_vec_lanes", (
        ("A", A), ("B", B), ("h", h), ("D", D),
        ("P", None if pc_mode else P), ("L", L), ("K", K), ("c", c)), dt)
    st = cuda_riccati.NARROW if narrow else dt
    checks = [
        ("rho", rho, (1, Bt), dt), ("pN", pN, (nx, Bt), dt),
        ("A", A, (N, nx, nx, 1), st), ("B", B, (N, nx, nu, 1), st),
        ("h", h, (N, nz, 1), st), ("D", D, (N, nc, nz, 1), st),
        ("mask", mask, (N, nc, 1), dt), ("L", L, (N, R * nu, nu, 1), st),
        ("K", K, (N, R * nu, nx, 1), st), ("c", c, (N, nx, Bt), st),
        ("wzy", wzy, (N, nz + 2 * nc, Bt), dt),
        ("Pc", Pc, (N, nx, Bt), dt) if pc_mode
        else ("P", P, (N, R * nx, nx, 1), st),
    ]
    for name, x, shape, xdt in checks:
        _check(name, x, shape, xdt, dev)
    rung = _rungs(L, nu, R, rung, ladder_oh, Bt, dev)
    if dev.type == "cpu":
        return admm_bwd_vec_lanes_reference(
            rho, pN, A, B, h, D, mask, P, L, K, c, wzy, nu=nu, sigma=sigma,
            rung=rung, Pc=Pc)
    if dev.type != "cuda":
        raise ValueError(f"admm_bwd_vec_lanes: no kernel for device {dev}")
    lib = _library(dt, nx, nu, nc, fold=True, rungs=R, narrow=narrow)
    with torch.cuda.device(dev):
        dv = _launch_bwd_vec(lib, rho, pN, A, B, h, D, mask,
                             None if pc_mode else P, L, K, c, wzy, rung, Pc,
                             sigma, _stream())
    LAUNCHES["admm_bwd_vec_lanes[bf16]" if narrow
             else "admm_bwd_vec_lanes"] += 1
    return dv


# ------------------------------------------------------------- kernel B

def _stage_update(w_t, w, z, y, Dk, Hmv, lb, ub, m, sh, rho_b, *, cones,
                  alpha, sigma):
    """One stage of the iterate update after the rollout, the tail of K5
    and K8: relaxation, projection, dual update, and the stage's four
    residual terms (4, B), maxima over its rows: |D w+ - z+|, the exact
    dual residual, max(|D w+|, |z+|), max(|Hs w+ - sigma w+|, |D^T y+|).
    ``m`` is the per-row rho scale, ``Hmv(t)`` the stage's Hs t.  Returns
    (w_new, z_new, y_new, rho m, terms)."""
    amax = lambda t: t.abs().amax(dim=0)
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
    Dw_new = _mv(Dk, w_new)
    dw = w - w_t
    zt_term = rho_m * ((alpha - 1.0) * (z_t - z) + (z - z_new))
    dvec = ((1.0 - alpha) * Hmv(dw) + (alpha * sigma) * dw
            + _mtv(Dk, zt_term))
    Hw = Hmv(w_new) - sigma * w_new
    dty = _mtv(Dk, y_new)
    terms = torch.stack([
        amax(Dw_new - z_new), amax(dvec),
        torch.maximum(amax(Dw_new), amax(z_new)),
        torch.maximum(amax(Hw), amax(dty)),
    ])
    return w_new, z_new, y_new, rho_m, terms


def admm_fwd_update_lanes_reference(rho, x0, M, K, Hs, D, bnd, dv, wzy, h, *,
                                    nu, cones, alpha, sigma, rung=None):
    """Plain PyTorch version of ``admm_fwd_update_lanes``: a Python loop
    over the stages, k = 0 .. N-1.  ``K`` None: ``M`` is the packed
    MK = [M; K]; else M (N,R*nx,nx,1) and K (N,R*nu,nx,1) stack R rungs,
    picked per scenario by ``rung``.  ``bnd`` = stack(lb, ub, mask[,
    shift]) (N, 3+s, nc, 1); ``h`` None: no hf-emit (three outputs).
    ``cones`` are normalized ``(offset, dim, kind)`` 3-tuples.  Narrow
    streams are widened as they load."""
    M, K, Hs, D, h = _wide(wzy.dtype, M, K, Hs, D, h)
    nx = M.shape[2]
    if K is None:
        M, K = M[:, :nx], M[:, nx:]
    M, K = _pick(M, nx, rung), _pick(K, nu, rung)
    N, nz = M.shape[0], nx + nu
    nc = D.shape[1]
    has_shift = bnd.shape[1] == 4
    diag_cost = Hs.ndim == 3
    rho_b = rho[0]
    x = x0
    acc = torch.zeros((4, wzy.shape[-1]), dtype=wzy.dtype, device=wzy.device)
    wzy_rows, hf_rows = [], []
    for k in range(N):
        u = _mv(K[k], x) + dv[k, :nu]
        w_t = torch.cat([u, x], dim=0)
        x = _mv(M[k], x) + dv[k, nu:]

        Hmv = (lambda t: Hs[k] * t) if diag_cost else (lambda t: _mv(Hs[k], t))
        w_new, z_new, y_new, rho_m, terms = _stage_update(
            w_t, wzy[k, :nz], wzy[k, nz:nz + nc], wzy[k, nz + nc:], D[k], Hmv,
            bnd[k, 0], bnd[k, 1], bnd[k, 2], bnd[k, 3] if has_shift else None,
            rho_b, cones=cones, alpha=alpha, sigma=sigma)
        wzy_rows.append(torch.cat([w_new, z_new, y_new], dim=0))
        if h is not None:
            # The next iteration's folded linear cost, valid while rho stays.
            rg = rho_m * z_new - y_new
            hf_rows.append(h[k] - sigma * w_new - _mtv(D[k], rg))
        acc = torch.maximum(acc, terms)
    if h is None:
        return torch.stack(wzy_rows), x, acc
    return torch.stack(wzy_rows), torch.stack(hf_rows), x, acc


def _launch_fwd_update(lib, rho, x0, M, K, Hs, D, bnd, dv, wzy, h, rung,
                       alpha, sigma, stream):
    """Allocate kernel B's outputs and launch it (no argument checks).
    ``K`` None: ``M`` is the packed MK = [M; K] of one rung."""
    nx = M.shape[2]
    N, nu = wzy.shape[0], dv.shape[1] - nx
    Bt = wzy.shape[-1]
    if K is None:
        # Both streams read off MK: a stage of it is nz x nx words.
        m_stride = k_stride = (nx + nu) * nx
        k_ptr = M.data_ptr() + nx * nx * M.element_size()
    else:
        m_stride, k_stride = M.shape[1] * nx, K.shape[1] * nx
        k_ptr = K.data_ptr()
    new = lambda *shape: torch.empty(shape, dtype=wzy.dtype, device=wzy.device)
    wzy_new = new(*wzy.shape)
    hf_new = None if h is None else new(N, nx + nu, Bt)
    xN, res = new(nx, Bt), new(4, Bt)
    ptr = lambda x: None if x is None else x.data_ptr()
    status = lib.admm_fwd_update(
        N, Bt, float(alpha), float(sigma), m_stride, k_stride,
        int(h is not None), stream,
        *(ptr(x) for x in (rho, x0, M)), k_ptr,
        *(ptr(x) for x in (Hs, D, bnd, h, rung, dv, wzy, wzy_new, hf_new,
                           xN, res)))
    _check_status("admm_fwd_update_lanes", status)
    if h is None:
        return wzy_new, xN, res
    return wzy_new, hf_new, xN, res


def stack_bounds(lb, ub, mask, shift=None):
    """Kernel B's packed bound stream bnd = stack(lb, ub, mask[, shift])
    (N, 3+s, nc, 1) from the four (N, nc, 1) streams: loop-invariant, so
    a caller stacks it once per solve."""
    parts = [lb, ub, mask] + ([] if shift is None else [shift])
    return torch.stack(parts, dim=1).contiguous()


def admm_fwd_update_lanes(rho, x0, M, K, Hs, D, lb, ub, mask, shift,
                          dv, wzy, *, nu, cones, alpha, sigma,
                          ladder_oh=None, h=None, rung=None):
    """Split-iteration kernel B (K5): closed-loop rollout + relax /
    project / dual / residual tail.

    The argument list is the JAX wrapper's, every form of it:

    * packed (``K`` None, one rung): ``M`` carries MK = [M; K]
      (N, nz, nx, 1) and ``lb`` carries bnd = stack(lb, ub, mask[, shift])
      (N, 3+s, nc, 1) (shift presence is read off its row count; the mask
      row carries the per-row rho scale, 0 on padded rows); ``ub``,
      ``mask``, ``shift`` and ``ladder_oh`` None;
    * unpacked: M (N, R*nx, nx, 1) and K (N, R*nu, nx, 1) stack R rungs'
      closed-loop maps and gains on rows, picked per scenario by ``rung``
      ((B,) int32) or the one-hot ``ladder_oh`` (R, B); lb, ub, mask
      (the rho scale) and shift (or None) (N, nc, 1).  The port also
      takes the packed bnd in ``lb`` here (``ub``, ``mask``, ``shift``
      None), which a loop stacks once per solve (``stack_bounds``)
      instead of once a call.

    ``h`` (N, nz, 1), the raw linear cost, turns on hf-emit: the kernel
    also writes the next iteration's folded cost.  ``Hs`` is the
    sigma-folded stage Hessian (N, nz, nz, 1), or its diagonal (N, nz, 1)
    for a diagonal stage cost (read off its rank).  D (N, nc, nz, 1).
    Per scenario: rho (1, B), x0 (nx, B), dv = [d | v] (N, nz, B) from
    kernel A and the packed iterates wzy = [w | z | y] (N, nz + 2 nc, B).
    ``cones`` are normalized ``(offset, dim, kind)`` 3-tuples.

    Returns (wzy_new, [hf_next (N, nz, B),] xN (nx, B), res (4, B)) with
    res rows [r_prim, r_dual, prim_scale, dual_scale] maxima over the
    stages; the caller folds the terminal stage.  M (or MK), K, Hs, D and
    h may be stored in bfloat16 (all of them), under the compute type of
    ``wzy``; the bounds, the mask and the shift stay in the compute type.

    On the card: a block serves 32 scenarios, a lane each, with warps in
    roles: a producer copies every stage's inputs (all R rungs of M and K)
    into a shared-memory ring, a chain warp runs x+ = M x + v, and tail
    warps take whole stages behind it (the projection, the dual update,
    the stores and the maxima); a lane reads its scenario's rung at an
    offset in the slot.  See the kernel source.  In the narrow form a
    widening warp of its own loads the shared runs and stores them widened
    into the ring; the producer only copies.
    """
    cones = tuple(cones)
    nx = M.shape[2]
    nz = nx + nu
    N, Bt = wzy.shape[0], wzy.shape[-1]
    nc = D.shape[1]
    dt, dev = wzy.dtype, wzy.device
    narrow = _narrow("admm_fwd_update_lanes", (
        ("MK" if K is None else "M", M), ("K", K), ("Hs", Hs), ("D", D),
        ("h", h)), dt)
    st = cuda_riccati.NARROW if narrow else dt
    packed_bnd = ub is None
    if K is None:
        if not packed_bnd or mask is not None or shift is not None \
                or ladder_oh is not None or rung is not None:
            raise ValueError("packed mode (K=None) takes bnd via lb "
                             "and is non-ladder only")
        R = 1
        _check("MK", M, (N, nz, nx, 1), st, dev)
    else:
        R = K.shape[1] // nu
        _check("M", M, (N, R * nx, nx, 1), st, dev)
        _check("K", K, (N, R * nu, nx, 1), st, dev)
    if packed_bnd:
        if mask is not None or shift is not None:
            raise ValueError("a packed bnd in lb takes ub, mask and shift "
                             "None")
        bnd = lb
        if bnd.ndim != 4 or bnd.shape[1] not in (3, 4):
            raise ValueError(f"bnd: shape {tuple(bnd.shape)}, expected "
                             f"(N, 3 or 4, nc, 1)")
    else:
        for name, x in (("lb", lb), ("ub", ub), ("mask", mask),
                        ("shift", shift)):
            if x is not None or name != "shift":
                _check(name, x, (N, nc, 1), dt, dev)
        bnd = stack_bounds(lb, ub, mask, shift)
    if Hs.ndim not in (3, 4):
        raise ValueError(f"Hs: shape {tuple(Hs.shape)}, expected "
                         f"(N, nz, 1) or (N, nz, nz, 1)")
    has_shift = bnd.shape[1] == 4
    diag_cost = Hs.ndim == 3
    checks = [
        ("rho", rho, (1, Bt), dt), ("x0", x0, (nx, Bt), dt),
        ("Hs", Hs, (N, nz, 1) if diag_cost else (N, nz, nz, 1), st),
        ("D", D, (N, nc, nz, 1), st),
        ("bnd", bnd, (N, bnd.shape[1], nc, 1), dt),
        ("dv", dv, (N, nz, Bt), dt), ("wzy", wzy, (N, nz + 2 * nc, Bt), dt),
    ]
    if h is not None:
        checks.append(("h", h, (N, nz, 1), st))
    for name, x, shape, xdt in checks:
        _check(name, x, shape, xdt, dev)
    rung = None if K is None else _rungs(K, nu, R, rung, ladder_oh, Bt, dev)
    if dev.type == "cpu":
        return admm_fwd_update_lanes_reference(
            rho, x0, M, K, Hs, D, bnd, dv, wzy, h, nu=nu, cones=cones,
            alpha=alpha, sigma=sigma, rung=rung)
    if dev.type != "cuda":
        raise ValueError(f"admm_fwd_update_lanes: no kernel for device {dev}")
    lib = _library(dt, nx, nu, nc, cones=cones, diag_cost=diag_cost,
                   has_shift=has_shift, rungs=R, narrow=narrow)
    with torch.cuda.device(dev):
        out = _launch_fwd_update(lib, rho, x0, M, K, Hs, D, bnd, dv, wzy, h,
                                 rung, alpha, sigma, _stream())
    LAUNCHES["admm_fwd_update_lanes[bf16]" if narrow
             else "admm_fwd_update_lanes"] += 1
    return out


# ------------------------------------------------------------------ K8

def admm_iter_lanes_reference(A, B, c, Hs, h, D, lb, ub, mask, shift, w, z,
                              y, rho, PN, pN, x0, *, nu, cones, alpha, sigma,
                              factors=None):
    """Plain PyTorch version of ``admm_iter_lanes``: K1's matrix sweep on
    the iterate-folded stage data (or, on cached factors, K2's vector
    sweep), K7's rollout from the raw dynamics, then K5's tail a stage at
    a time.  Stage data stored narrower is upcast first; tensors of
    trailing size 1 broadcast over the batch."""
    dt = w.dtype
    A, B, c, Hs, h, D = (x.to(dt) for x in (A, B, c, Hs, h, D))
    rho_b = rho[0]
    rho_m = rho_b * mask                                     # (N, nc, B)
    rg = rho_m * z - y
    h_t = h - sigma * w
    if factors is None:
        K, d = cuda_riccati.backward_lanes_reference(
            A, B, c, Hs, h_t, D, rho_m, rg, PN, pN, emit_closed_loop=False)
    else:
        P, L, K = factors
        hf = h_t - torch.einsum("kcb,kczb->kzb", rg, D)
        d, _ = cuda_riccati.backward_vectors_lanes_reference(
            A, B, c, hf, P, K, L, pN)
    ws, xN = cuda_riccati.forward_rollout_lanes_reference(A, B, c, K, d, x0)
    rows, res = [], None
    for k in range(A.shape[0]):
        out = _stage_update(
            ws[k], w[k], z[k], y[k], D[k], lambda t, k=k: _mv(Hs[k], t),
            lb[k], ub[k], mask[k], None if shift is None else shift[k],
            rho_b, cones=cones, alpha=alpha, sigma=sigma)
        rows.append(out[:3])
        res = out[4] if res is None else torch.maximum(res, out[4])
    w_new, z_new, y_new = (torch.stack(x) for x in zip(*rows))
    return w_new, z_new, y_new, xN, res


def _launch_iter(lib, A, B, c, Hs, h, D, lb, ub, mask, shift, w, z, y, rho,
                 PN, pN, x0, factors, shared, alpha, sigma, stream):
    """Allocate K8's outputs and its gain spill and launch it (no argument
    checks).  The spill holds each scenario's gains contiguously: K and d
    of every stage, or d alone on cached factors."""
    N, nx, nu = A.shape[0], A.shape[1], B.shape[2]
    nz, nc, Bt = nx + nu, D.shape[1], w.shape[-1]
    cached = factors is not None
    new = lambda *shape: torch.empty(shape, dtype=w.dtype, device=w.device)
    spill = new(Bt, N, nu if cached else nu * (nx + 1))
    out = (new(N, nz, Bt), new(N, nc, Bt), new(N, nc, Bt), new(nx, Bt),
           new(4, Bt))
    P, L, K = factors if cached else (None, None, None)
    ptr = lambda x: None if x is None else x.data_ptr()
    status = lib.admm_iter(
        N, Bt, float(alpha), float(sigma), int(shared), int(cached),
        int(A.dtype == torch.bfloat16), stream,
        *(ptr(x) for x in (rho, PN, pN, x0, A, B, c, Hs, h, D, lb, ub, mask,
                           shift, P, L, K, w, z, y, spill) + out))
    _check_status("admm_iter_lanes", status)
    return out


def admm_iter_lanes(A, B, c, Hs, h, D, lb, ub, mask, shift, w, z, y, rho,
                    PN, pN, x0, *, nu, cones, alpha, sigma, factors=None,
                    shared=False):
    """One whole conic ADMM iteration over stages 0..N-1 in one launch (K8).

    The JAX wrapper's arguments and layout.  Stage tensors: A (N,nx,nx,·),
    B (N,nx,nu,·), c (N,nx,B), Hs (N,nz,nz,·) the sigma-folded H, h
    (N,nz,·) the raw linear cost, D (N,nc,nz,·); lb, ub (N,nc,·), mask
    (N,nc,·) the per-row RHO SCALE (0 on padded rows, the equality boost
    on equality rows, 1 elsewhere; the projection mask is m > 0), shift
    (N,nc,·) or None.  Per scenario: the iterates w (N,nz,B), z, y
    (N,nc,B), rho (1,B), PN (nx,nx,B) / pN (nx,B) the iterate-folded
    terminal cost-to-go, x0 (nx,B).  ``cones`` are normalized
    ``(offset, dim, kind)`` 3-tuples.

    ``·`` is B, or 1 with ``shared=True``: one model serving B scenarios
    (its streams, and the factors, one copy; c stays per scenario).  A,
    B, c, Hs, h and D may be stored in bfloat16 under a wider compute
    type: they are upcast at load, and everything else keeps the compute
    type (that of w).  ``factors`` (P (N,nx,nx,·), L (N,nu,nu,·), K
    (N,nu,nx,·) from ``backward_lanes(export_factors=True)``) turns phase
    1 into the vector sweep on them; valid while rho and the problem are
    unchanged since the export; ``PN`` is then not read (it may be None).

    Returns (w_new, z_new, y_new, xN, res) with res (4, B) rows [r_prim,
    r_dual, prim_scale, dual_scale], maxima over stages 0..N-1 (the
    caller folds in the terminal stage).

    On the card: one warp a scenario, its carry and products in the
    warp's slice of shared memory; a block of warps (8 on one model, 4
    on a batched problem) stages each stage's data once into a ring of
    shared-memory slots with asynchronous copies (a shared model's streams
    one copy, per-scenario streams as rows of the block's scenarios), and
    the gains make a round trip through a scratch buffer in device memory.
    bfloat16 stage data is copied in aligned pairs, so its tensors must
    start at a 4-byte boundary.  See the kernel source.
    """
    cones = tuple(cones)
    N, nx = A.shape[0], A.shape[1]
    nz, nc = nx + nu, D.shape[1]
    Bt = w.shape[-1]
    if nc == 0:
        raise ValueError("single-kernel ADMM iteration requires nc > 0")
    dt, dev, st = w.dtype, w.device, A.dtype
    if st not in (dt, torch.bfloat16):
        raise TypeError(f"stage data stored as {st}: the kernel takes the "
                        f"compute type {dt} or bfloat16")
    mb = 1 if shared else Bt
    for name, x, shape in (
        ("A", A, (N, nx, nx, mb)), ("B", B, (N, nx, nu, mb)),
        ("c", c, (N, nx, Bt)), ("Hs", Hs, (N, nz, nz, mb)),
        ("h", h, (N, nz, mb)), ("D", D, (N, nc, nz, mb)),
    ):
        _check(name, x, shape, st, dev)
    checks = [
        ("lb", lb, (N, nc, mb)), ("ub", ub, (N, nc, mb)),
        ("mask", mask, (N, nc, mb)), ("w", w, (N, nz, Bt)),
        ("z", z, (N, nc, Bt)), ("y", y, (N, nc, Bt)), ("rho", rho, (1, Bt)),
        ("pN", pN, (nx, Bt)), ("x0", x0, (nx, Bt)),
    ]
    if factors is None or PN is not None:
        checks.append(("PN", PN, (nx, nx, Bt)))
    if shift is not None:
        checks.append(("shift", shift, (N, nc, mb)))
    if factors is not None:
        P, L, K = factors
        checks += [("P", P, (N, nx, nx, mb)), ("L", L, (N, nu, nu, mb)),
                   ("K", K, (N, nu, nx, mb))]
    for name, x, shape in checks:
        _check(name, x, shape, dt, dev)
    if dev.type == "cpu":
        return admm_iter_lanes_reference(
            A, B, c, Hs, h, D, lb, ub, mask, shift, w, z, y, rho, PN, pN, x0,
            nu=nu, cones=cones, alpha=alpha, sigma=sigma, factors=factors)
    if dev.type != "cuda":
        raise ValueError(f"admm_iter_lanes: no kernel for device {dev}")
    if st == torch.bfloat16:
        for name, x in (("A", A), ("B", B), ("c", c), ("Hs", Hs), ("h", h),
                        ("D", D)):
            if x.data_ptr() % 4:
                raise ValueError(f"{name}: bfloat16 stage data must start at "
                                 f"a 4-byte boundary (the kernel copies "
                                 f"pairs)")
    lib = _library(dt, nx, nu, nc, cones=cones, has_shift=shift is not None,
                   single=True)
    with torch.cuda.device(dev):
        out = _launch_iter(lib, A, B, c, Hs, h, D, lb, ub, mask, shift, w, z,
                           y, rho, PN, pN, x0, factors, shared, alpha, sigma,
                           _stream())
    LAUNCHES["admm_iter_lanes"] += 1
    return out
