"""Fused Riccati sweep kernels for an NVIDIA card — batch-last layout.

Counterpart of ``pdp_lqr_tpu/ops/pallas_riccati.py`` (the module is named
after its route, CUDA C++, not after Pallas).  Function names, argument
order, the batch-last ``(N, ..., B)`` layout and the returned tuples are
that module's, so the two can be held against each other.  Eight kernels
live here, written by hand in ``csrc/riccati_kernels.cu``:

  backward_lanes          the matrix sweep with the in-kernel penalty fold
  backward_vectors_lanes  the cached-factor vector sweep
  forward_lanes           the closed-loop rollout (per instance also in
                          S horizon segments)
  forward_rollout_lanes   the rollout from the raw dynamics (per instance)
  backward_pdp_lanes      the segment reduction of the parallel solver: the
                          matrix sweep of S horizon segments at once, with
                          each segment's coupling (Gp, F, C, f) and boundary
  backward_pdp_vectors_lanes
                          its cached-factor vector sweep
  backward_packed         the matrix sweep, gains only, on row-packed streams
  forward_packed          the rollout from the raw dynamics on packed streams

Beside each kernel stands a plain PyTorch version (``*_reference``): a
Python loop over stages on the same batch-last tensors.  A wrapper takes
the plain version only for CPU tensors; a CUDA tensor goes to the kernel
or the call raises.  Each wrapper counts its launches in ``LAUNCHES``.

Narrow stage streams (``storage_dtype=torch.bfloat16`` on ``prepare_lanes``
/ ``prepare_packed``): the per-scenario stage data A, B, c, H, h, D, rho,
rho g stored in bfloat16 while the recursion runs in the compute type (the
dtype of PN, K or G).  K1 (gains only), K7, K11 and K12 have forms that read
the 2-byte streams and widen them on the card (their launches counted as
``<name>[bf16]``); the plain versions widen each stage as they load it.  A
narrow stream that reaches a form without such a kernel raises.

Shared (broadcast) mode: one model serves B scenarios.  The shared matrix
tensors carry a trailing batch dimension of size 1 — one copy that every
thread reads — while the per-scenario vectors run the full batch.  The
wrappers accept a trailing size of 1 or B on every matrix argument.

Per-instance mode: every tensor has trailing size B, one model a
scenario (``prepare_lanes`` / ``solve_lanes``, the replicated ADMM loop).

The glue between the kernels (``prepare_shared``, ``prepare_lanes``, the
fold ``Pc = P_{k+1} c_k``, the final transpose) is ordinary tensor code;
its matrix products must run in full float32 (see
``config.full_f32_matmul``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from pdp_lqr_tpu_torch.config import full_f32_matmul
from pdp_lqr_tpu_torch.ops import _build, linalg
from pdp_lqr_tpu_torch.problem import guarded_inverse, make_stage_params

SOURCE = "riccati_kernels.cu"

# Launches of each kernel made by this process (plain integers; a wrapper
# adds one exactly where it launches its kernel).
LAUNCHES = {"backward_lanes": 0, "backward_vectors_lanes": 0,
            "forward_lanes": 0, "forward_rollout_lanes": 0,
            "backward_pdp_lanes": 0, "backward_pdp_vectors_lanes": 0,
            "backward_packed": 0, "forward_packed": 0,
            "backward_lanes[bf16]": 0, "forward_rollout_lanes[bf16]": 0,
            "backward_packed[bf16]": 0, "forward_packed[bf16]": 0}

# The one narrow storage type of the stage streams (the JAX package's
# ``storage_dtype``; its kernels take any, the ports' forms bfloat16).
NARROW = torch.bfloat16

_SCALARS = {torch.float32: "float", torch.float64: "double"}
_PTR = ctypes.c_void_p
_INT = ctypes.c_int


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def kernel_defines(dtype, nx: int, nu: int, nc: int | None = None, *,
                   narrow: bool = False) -> dict:
    """The ``-D`` flags of one specialisation of the kernel source: with
    ``nc`` the matrix sweeps (K1, K9, K11), without it the per-scenario
    kernels (K2, K3, K7, K10, K12), which read no constraint rows.
    ``narrow``: the forms on bfloat16 stage streams (K1 gains only and K11
    with ``nc``, K7 and K12 without), and nothing else."""
    if dtype not in _SCALARS:
        raise TypeError(f"the kernels take float32 or float64, got {dtype}")
    defines = {"SCALAR": _SCALARS[dtype], "NX": nx, "NU": nu}
    if nc is not None:
        defines["NC"] = nc
    if narrow:
        defines["STAGE_BF16"] = 1
    return defines


def _library(dtype, nx, nu, nc=None, narrow=False):
    lib = _build.load(SOURCE, kernel_defines(dtype, nx, nu, nc, narrow=narrow))
    if not getattr(lib, "_riccati_bound", False):
        bind_library(lib, with_matrix_sweep=nc is not None, narrow=narrow)
    return lib


def bind_library(lib, *, with_matrix_sweep: bool, narrow: bool = False):
    """Declare the C entry points' argument types (pointers and the stream
    as ``c_void_p``: ctypes would cut them to 32 bits otherwise).  A
    ``narrow`` library holds only the forms on bfloat16 stage streams."""
    if with_matrix_sweep:
        entries = {"riccati_backward": [_INT] * 4 + [_PTR] * 17,
                   "riccati_backward_packed": [_INT] * 2 + [_PTR] * 6}
        if not narrow:
            entries["riccati_backward_pdp"] = [_INT] * 4 + [_PTR] * 27
    else:
        entries = {
            "riccati_forward_rollout": [_INT] * 2 + [_PTR] * 9,
            "riccati_forward_packed": [_INT] * 2 + [_PTR] * 6,
        }
        if not narrow:
            entries.update({
                "riccati_backward_vectors": [_INT] * 3 + [_PTR] * 11,
                "riccati_backward_vectors_shared": [_INT] * 3 + [_PTR] * 8,
                "riccati_forward": [_INT] * 4 + [_PTR] * 8,
                "riccati_backward_pdp_vectors": [_INT] * 3 + [_PTR] * 14,
            })
    for name, argtypes in entries.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _INT
    lib._riccati_bound = True


def sweep_group(dtype, nx: int, nu: int, nc: int, pairs: int, *,
                emit_closed_loop=True, export_factors=False, pdp=False,
                narrow=False) -> int:
    """The instances a block of the matrix sweep serves on ``pairs``
    (segment, instance) pairs (K1, or K9 with ``pdp``; K11 is K1 with
    neither output; ``narrow``: their forms on bfloat16 stage streams): G
    of its batch form, the kernel's own compile-time choice from the widths
    and the dtype, or 0 where each instance takes a block of its own.
    Builds the library (on a machine with ``nvcc``)."""
    lib = _library(dtype, nx, nu, nc, narrow)
    lib.riccati_sweep_group.argtypes = [_INT] * 3 + [ctypes.c_longlong]
    lib.riccati_sweep_group.restype = _INT
    return lib.riccati_sweep_group(int(emit_closed_loop), int(export_factors),
                                   int(pdp), pairs)


def _check(name, x, shape, dtype, device):
    """A kernel argument must be a contiguous tensor of the expected
    shape and dtype on the expected device."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x).__name__}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)} != {tuple(shape)}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype} != {dtype}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _storage(name, stream, dt):
    """The storage type of a kernel's stage streams (its first one's;
    ``_check`` holds the others to it): the compute type ``dt`` or
    bfloat16."""
    if stream.dtype not in (dt, NARROW):
        raise TypeError(
            f"{name}: stage streams stored as {stream.dtype} under "
            f"{dt} compute: the kernels take the compute type or bfloat16 "
            f"(storage_dtype=torch.bfloat16 only)")
    return stream.dtype


def _check_aligned(name, streams):
    """bfloat16 stage streams are copied by the copy engine or, where its
    boxes do not take them, in 4-byte pairs: each must start on a 4-byte
    boundary."""
    for sname, x in streams:
        if x.data_ptr() % 4:
            raise ValueError(f"{name}: {sname}: bfloat16 stage data must "
                             f"start at a 4-byte boundary (the kernel "
                             f"copies pairs)")


def _check_status(name, status):
    if status != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {status}")


def _stream():
    return torch.cuda.current_stream().cuda_stream


# ----------------------------------------------------------- layout helpers

def to_lanes(x):
    """(B, N, ...) -> (N, ..., B): stage-major, batch-last."""
    return torch.movedim(x, 0, -1)


def from_lanes(x):
    """(N, ..., B) -> (B, N, ...)."""
    return torch.movedim(x, -1, 0)


def _mv(X, v):
    """(m, n, B) @ (n, B) -> (m, B), batch-last."""
    return torch.einsum("mnb,nb->mb", X, v)


def _mtv(X, v):
    """X^T v: (n, m, B), (n, B) -> (m, B), batch-last."""
    return torch.einsum("nmb,nb->mb", X, v)


def _chol_solve_lanes(L, rhs):
    """Solve (L L^T) X = rhs, batch-last: L (n, n, B), rhs (n, k, B)."""
    Lb = torch.movedim(L, -1, 0)
    sol = torch.cholesky_solve(torch.movedim(rhs, -1, 0), Lb)
    return torch.movedim(sol, 0, -1)


# ------------------------------------------------------------------- K1

def _sym(X):
    """The symmetric matrix of X's upper triangle, batch-last (n, n, B):
    what the kernels compute (upper triangle, mirrored)."""
    X = torch.movedim(X, -1, 0)
    return torch.movedim(X.triu() + X.triu(1).transpose(-1, -2), 0, -1)


def _fold_penalty(Hk, hk, Dk, rhok, rgk):
    """H += sum_c rho_c D_c D_c^T ; h -= sum_c (rho g)_c D_c (one stage)."""
    if Dk.shape[0] == 0:
        return Hk, hk
    return (Hk + torch.einsum("crb,cb,csb->rsb", Dk, rhok, Dk),
            hk - torch.einsum("cb,crb->rb", rgk, Dk))


def _sweep_stage(P, p, Ak, Bk, ck, Hk, hk, extra=None):
    """One stage of the P-form matrix sweep on the carry (P, p) = (P_{k+1},
    p_{k+1}) and the folded stage cost: returns (K, d, L, X, P, p), with X
    = -Huu^{-1} ``extra`` (nu, m, B) solved beside [K d] (None without)."""
    nx, nu = Ak.shape[0], Bk.shape[1]
    R, S, Q = Hk[:nu, :nu], Hk[:nu, nu:], Hk[nu:, nu:]
    r, q = hk[:nu], hk[nu:]
    PA = torch.einsum("ijb,jkb->ikb", P, Ak)
    PB = torch.einsum("ijb,jkb->ikb", P, Bk)
    Pcp = _mv(P, ck) + p
    G = S + torch.einsum("tib,tjb->ijb", Bk, PA)
    rbar = r + _mtv(Bk, Pcp)
    Huu = R + torch.einsum("tib,tjb->ijb", Bk, PB)
    # Only the lower triangle of Huu is read, as in the kernel; an
    # instance whose Huu is not positive definite gets NaN, as the
    # kernel's reciprocal square root of a negative pivot gives it.
    L = torch.movedim(
        linalg.cholesky_unrolled(torch.movedim(Huu, -1, 0).tril()), 0, -1)
    rhs = [G] + ([] if extra is None else [extra]) + [rbar[:, None, :]]
    sol = -_chol_solve_lanes(L, torch.cat(rhs, dim=1))
    K, d = sol[:, :nx], sol[:, -1]
    X = None if extra is None else sol[:, nx:-1]
    Pn = _sym(Q + torch.einsum("tib,tjb->ijb", Ak, PA)
              + torch.einsum("tib,tjb->ijb", G, K))
    pn = q + _mtv(Ak, Pcp) + _mtv(K, rbar)
    return K, d, L, X, Pn, pn


def _closed_loop(Ak, Bk, ck, K, d):
    """M = A + B K, v = B d + c."""
    return Ak + torch.einsum("itb,tjb->ijb", Bk, K), _mv(Bk, d) + ck


def backward_lanes_reference(A, B, c, H, h, D, rho, rg, PN, pN, *,
                             export_factors=False, emit_closed_loop=True):
    """Plain PyTorch version of ``backward_lanes`` (same arguments, same
    returns): a Python loop over the stages, k = N-1 .. 0, each stage's
    data widened to the compute type (PN's) as it is loaded."""
    N = A.shape[0]
    P, p = PN, pN
    up = lambda x: x.to(PN.dtype)
    Ks, ds, Ms, vs, Ps, Ls = [], [], [], [], [], []
    for k in range(N - 1, -1, -1):
        Ak, Bk, ck = up(A[k]), up(B[k]), up(c[k])
        Hk, hk = _fold_penalty(up(H[k]), up(h[k]), up(D[k]), up(rho[k]),
                               up(rg[k]))
        K, d, L, _, Pn, pn = _sweep_stage(P, p, Ak, Bk, ck, Hk, hk)
        Ks.append(K)
        ds.append(d)
        if emit_closed_loop:
            M, v = _closed_loop(Ak, Bk, ck, K, d)
            Ms.append(M)
            vs.append(v)
        if export_factors:
            Ps.append(P)
            Ls.append(L)
        P, p = Pn, pn

    stack = lambda xs: torch.stack(xs[::-1], dim=0)
    out = (stack(Ks), stack(ds))
    if emit_closed_loop:
        out = out + (stack(Ms), stack(vs))
    if export_factors:
        out = out + (stack(Ps), stack(Ls))
    return out


def _launch_backward(lib, A, B, c, H, h, D, rho, rg, PN, pN,
                     export_factors, emit_closed_loop, stream):
    """Allocate K1's outputs and launch it (no argument checks)."""
    N, nx, _, Bt = A.shape
    nu = B.shape[2]
    new = lambda *shape: torch.empty(shape, dtype=PN.dtype, device=A.device)
    K, d = new(N, nu, nx, Bt), new(N, nu, Bt)
    M = v = P = L = None
    if emit_closed_loop:
        M, v = new(N, nx, nx, Bt), new(N, nx, Bt)
    if export_factors:
        P, L = new(N, nx, nx, Bt), new(N, nu, nu, Bt)
    ptr = lambda x: None if x is None else x.data_ptr()
    status = lib.riccati_backward(
        N, Bt, int(emit_closed_loop), int(export_factors), stream,
        *(ptr(x) for x in (A, B, c, H, h, D, rho, rg, PN, pN, K, d, M, v, P, L)),
    )
    _check_status("backward_lanes", status)
    out = (K, d)
    if emit_closed_loop:
        out = out + (M, v)
    if export_factors:
        out = out + (P, L)
    return out


def backward_lanes(A, B, c, H, h, D, rho, rg, PN, pN, *,
                   export_factors=False, emit_closed_loop=True):
    """Fused backward sweep; all tensors batch-last.

    A (N,nx,nx,B), B (N,nx,nu,B), c (N,nx,B), H (N,nz,nz,B),
    h (N,nz,B), D (N,nc,nz,B), rho/rg (N,nc,B), PN (nx,nx,B), pN (nx,B)
    — H/h/D/rho/rg are the non-terminal stage rows (rg = rho * g);
    PN/pN is the already-folded terminal cost-to-go.  ``nc`` may be 0.

    Returns (K, d, M, v): gains and closed-loop maps per stage; with
    ``export_factors`` additionally (P, L) — the per-stage cost-to-go
    P_{k+1} and chol(Huu) (zeros above the diagonal) consumed by
    backward_vectors_lanes while rho is unchanged.
    ``emit_closed_loop=False`` returns only (K, d)[, P, L].

    The compute type is PN's (float32 or float64); the eight stage streams
    A .. rg may be stored in bfloat16 (``prepare_lanes(storage_dtype=)``),
    in the gains-only form (``emit_closed_loop=False``, no export).

    On the card: a warp an instance, a block of several consecutive
    instances that stage their data together (where the instances do not
    outnumber the SMs: a block each); see the note in the kernel source.
    bfloat16 streams land a stage ahead in boxes of the copy engine, 8
    instances a row (where B is a multiple of 8; 4-byte pairs otherwise),
    and the block widens each stage into its slot at the end of the one
    before.
    """
    N, nx, _, Bt = A.shape
    nu = B.shape[2]
    nz = nx + nu
    nc = D.shape[1]
    dt, dev = PN.dtype, A.device
    st = _storage("backward_lanes", A, dt)
    streams = (("A", A, (N, nx, nx, Bt)), ("B", B, (N, nx, nu, Bt)),
               ("c", c, (N, nx, Bt)), ("H", H, (N, nz, nz, Bt)),
               ("h", h, (N, nz, Bt)), ("D", D, (N, nc, nz, Bt)),
               ("rho", rho, (N, nc, Bt)), ("rg", rg, (N, nc, Bt)))
    for name, x, shape in streams:
        _check(name, x, shape, st, dev)
    _check("PN", PN, (nx, nx, Bt), dt, dev)
    _check("pN", pN, (nx, Bt), dt, dev)
    narrow = st != dt
    if narrow and (emit_closed_loop or export_factors):
        raise NotImplementedError(
            "backward_lanes: bfloat16 stage streams run the gains-only form "
            "(emit_closed_loop=False, export_factors=False) that solve_lanes "
            "takes; the closed-loop maps and the factor export read the "
            "compute type (no path streams narrow data there: the split "
            "and ladder iterations build their factors at full width, as "
            "JAX's do)")
    if dev.type == "cpu":
        return backward_lanes_reference(
            A, B, c, H, h, D, rho, rg, PN, pN,
            export_factors=export_factors, emit_closed_loop=emit_closed_loop)
    if dev.type != "cuda":
        raise ValueError(f"backward_lanes: no kernel for device {dev}")
    if narrow:
        _check_aligned("backward_lanes", [(n, x) for n, x, _ in streams])
    lib = _library(dt, nx, nu, nc, narrow)
    with torch.cuda.device(dev):
        out = _launch_backward(lib, A, B, c, H, h, D, rho, rg, PN, pN,
                               export_factors, emit_closed_loop, _stream())
    LAUNCHES["backward_lanes[bf16]" if narrow else "backward_lanes"] += 1
    return out


# ------------------------------------------------------------------- K2

def _vector_sweep(A, B, c, hf, P, K, L, pN, Pc=None):
    """K2's recursion over the stages, k = N-1 .. 0: returns (d, v) and
    the carry p after stage 0."""
    N = A.shape[0]
    nu = B.shape[2]
    p = pN
    ds, vs = [], []
    for k in range(N - 1, -1, -1):
        Pcp = (Pc[k] if Pc is not None else _mv(P[k], c[k])) + p
        rbar = hf[k, :nu] + _mtv(B[k], Pcp)
        Lk = L[k].expand(nu, nu, rbar.shape[-1])
        d = -_chol_solve_lanes(Lk, rbar[:, None, :])[:, 0]
        ds.append(d)
        vs.append(_mv(B[k], d) + c[k])
        p = hf[k, nu:] + _mtv(A[k], Pcp) + _mtv(K[k], rbar)
    return torch.stack(ds[::-1], dim=0), torch.stack(vs[::-1], dim=0), p


def backward_vectors_lanes_reference(A, B, c, hf, P, K, L, pN, *, Pc=None):
    """Plain PyTorch version of ``backward_vectors_lanes``.  The matrix
    tensors broadcast over the batch when their trailing size is 1."""
    return _vector_sweep(A, B, c, hf, P, K, L, pN, Pc)[:2]


def _pack_shared_matrices(A, B, K, L, P):
    """One contiguous run per stage for the shared-mode kernel, laid out
    for its reads: A^T, B^T, B, K^T, L, then P (plain-P mode; None in Pc
    mode) — (N, words)."""
    N = A.shape[0]
    T = lambda x: x[..., 0].transpose(1, 2)
    parts = [T(A), T(B), B[..., 0], T(K), L[..., 0]]
    if P is not None:
        parts.append(P[..., 0])
    return torch.cat([x.reshape(N, -1) for x in parts], dim=1)


def _launch_backward_vectors(lib, A, B, c, hf, P, K, L, pN, shared,
                             pc_mode, stream):
    """Allocate K2's outputs and launch it (no argument checks); ``P``
    is the pre-folded ``Pc`` when ``pc_mode``."""
    N, nx = A.shape[0], A.shape[1]
    nu = B.shape[2]
    Bt = c.shape[-1]
    d = torch.empty((N, nu, Bt), dtype=c.dtype, device=c.device)
    v = torch.empty((N, nx, Bt), dtype=c.dtype, device=c.device)
    if shared:
        pack = _pack_shared_matrices(A, B, K, L, None if pc_mode else P)
        status = lib.riccati_backward_vectors_shared(
            N, Bt, int(pc_mode), stream, pack.data_ptr(), c.data_ptr(),
            hf.data_ptr(), P.data_ptr() if pc_mode else None, pN.data_ptr(),
            d.data_ptr(), v.data_ptr(),
        )
    else:
        status = lib.riccati_backward_vectors(
            N, Bt, int(pc_mode), stream,
            *(x.data_ptr() for x in (A, B, c, hf, P, K, L, pN, d, v)),
        )
    _check_status("backward_vectors_lanes", status)
    return d, v


def backward_vectors_lanes(A, B, c, hf, P, K, L, pN, *, shared=False,
                           Pc=None):
    """Cached-factor vector sweep; returns (d, v) for forward_lanes.

    A (N,nx,nx,·), B (N,nx,nu,·), c (N,nx,B), hf (N,nz,B) the fully
    iterate-folded linear cost, (P, K, L) from
    backward_lanes(export_factors=True), pN (nx,B) the iterate-folded
    terminal linear cost.  Valid while rho (and the problem matrices)
    are unchanged since the factors were exported.

      Pcp  = P_{k+1} c + p          rbar = hf[:nu] + B^T Pcp
      d    = -(L L^T)^{-1} rbar     v    = B d + c
      p    = hf[nu:] + A^T Pcp + K^T rbar      (carry)

    ``shared=True``: the matrix tensors (A, B, P, K, L) carry trailing
    size 1 — one model, B scenarios.  ``shared=False``: trailing size B,
    one matrix set per scenario.  ``Pc`` (N,nx,B), when given, is the
    pre-folded per-scenario ``P_{k+1} c_k`` and ``P`` is then not read
    (it may be None).

    On the card the warps of a block take roles: a producer warp copies
    the stages into a ring of shared-memory slots, and the carry's chain
    runs apart from d, v and their stores.  Shared mode: 32 scenarios a
    block, a lane each; a chain warp carries p and tail warps form d and
    v behind it.  Per-instance mode: 8 scenarios a block, 4 lanes each in
    one compute warp that gathers Pcp by shuffles.  See the notes in the
    kernel source.
    """
    N, nx = A.shape[0], A.shape[1]
    nu = B.shape[2]
    nz = nx + nu
    Bt = c.shape[-1]
    mb = 1 if shared else Bt
    dt, dev = c.dtype, c.device
    pc_mode = Pc is not None
    checks = [
        ("A", A, (N, nx, nx, mb)), ("B", B, (N, nx, nu, mb)),
        ("c", c, (N, nx, Bt)), ("hf", hf, (N, nz, Bt)),
        ("K", K, (N, nu, nx, mb)), ("L", L, (N, nu, nu, mb)),
        ("pN", pN, (nx, Bt)),
        ("Pc", Pc, (N, nx, Bt)) if pc_mode else ("P", P, (N, nx, nx, mb)),
    ]
    for name, x, shape in checks:
        _check(name, x, shape, dt, dev)
    if dev.type == "cpu":
        return backward_vectors_lanes_reference(A, B, c, hf, P, K, L, pN,
                                                Pc=Pc)
    if dev.type != "cuda":
        raise ValueError(f"backward_vectors_lanes: no kernel for device {dev}")
    lib = _library(dt, nx, nu)
    with torch.cuda.device(dev):
        out = _launch_backward_vectors(
            lib, A, B, c, hf, Pc if pc_mode else P, K, L, pN, shared,
            pc_mode, _stream())
    LAUNCHES["backward_vectors_lanes"] += 1
    return out


# ------------------------------------------------------------------- K3

def _rollout(M, v, K, d, x0):
    x = x0
    rows = []
    for k in range(M.shape[0]):
        u = _mv(K[k], x) + d[k]
        rows.append(torch.cat([u, x], dim=0))
        x = _mv(M[k], x) + v[k]
    return torch.stack(rows, dim=0), x


def _segments(N, S):
    """The stage slices of S equal segments of an N-stage horizon."""
    if S < 1 or N % S:
        raise ValueError(f"{S} segments do not divide a horizon of {N} stages")
    Nl = N // S
    return [slice(s * Nl, (s + 1) * Nl) for s in range(S)]


def forward_lanes_reference(M, v, K, d, x0, *, segments=None):
    """Plain PyTorch version of ``forward_lanes``.  M and K broadcast over
    the batch when their trailing size is 1."""
    if segments is None:
        return _rollout(M, v, K, d, x0)
    outs = [_rollout(M[sl], v[sl], K[sl], d[sl], x0[s])
            for s, sl in enumerate(_segments(M.shape[0], segments))]
    return (torch.cat([w for w, _ in outs], dim=0),
            torch.stack([x for _, x in outs], dim=0))


def _launch_forward(lib, M, v, K, d, x0, shared, stream, segments=None):
    """Allocate K3's outputs and launch it (no argument checks)."""
    N, nx = M.shape[0], M.shape[1]
    nu = K.shape[1]
    Bt = v.shape[-1]
    ws = torch.empty((N, nx + nu, Bt), dtype=v.dtype, device=v.device)
    xN = torch.empty(x0.shape, dtype=v.dtype, device=v.device)
    status = lib.riccati_forward(
        N, Bt, int(shared), segments or 1, stream,
        *(x.data_ptr() for x in (M, v, K, d, x0, ws, xN)),
    )
    _check_status("forward_lanes", status)
    return ws, xN


def forward_lanes(M, v, K, d, x0, *, shared=False, segments=None):
    """Closed-loop rollout u = K x + d, x+ = M x + v; returns
    (ws (N, nz, B) with rows [u; x], xN (nx, B)).

    ``shared=True``: M (N,nx,nx,1) and K (N,nu,nx,1) are one model's
    maps, read by every scenario; ``shared=False``: trailing size B.
    The per-scenario vectors v (N,nx,B), d (N,nu,B), x0 (nx,B) run the
    full batch.

    ``segments=S`` (per instance only): the horizon is S segments of N/S
    stages, each rolled out from its own start state, x0 (S,nx,B); xN
    (S,nx,B) holds each segment's end state.  ``None``: one segment, x0
    and xN (nx,B).

    On the card: the shared mode is laid out as in
    backward_vectors_lanes; per instance, a scenario has 4 threads and a
    block 8 scenarios, whose stage data the block copies a few stages
    ahead into a ring of shared-memory slots.  See the notes in the
    kernel source.  The segments of the per-instance kernel run side by
    side in one launch.
    """
    N, nx = M.shape[0], M.shape[1]
    nu = K.shape[1]
    Bt = v.shape[-1]
    mb = 1 if shared else Bt
    dt, dev = v.dtype, v.device
    if segments is not None:
        if shared:
            raise ValueError("forward_lanes: segments run per instance only")
        _segments(N, segments)
    x0_shape = (nx, Bt) if segments is None else (segments, nx, Bt)
    for name, x, shape in (
        ("M", M, (N, nx, nx, mb)), ("v", v, (N, nx, Bt)),
        ("K", K, (N, nu, nx, mb)), ("d", d, (N, nu, Bt)),
        ("x0", x0, x0_shape),
    ):
        _check(name, x, shape, dt, dev)
    if dev.type == "cpu":
        return forward_lanes_reference(M, v, K, d, x0, segments=segments)
    if dev.type != "cuda":
        raise ValueError(f"forward_lanes: no kernel for device {dev}")
    lib = _library(dt, nx, nu)
    with torch.cuda.device(dev):
        out = _launch_forward(lib, M, v, K, d, x0, shared, _stream(), segments)
    LAUNCHES["forward_lanes"] += 1
    return out


# ------------------------------------------------------------------- K7

def forward_rollout_lanes_reference(A, B, c, K, d, x0):
    """Plain PyTorch version of ``forward_rollout_lanes`` (A, B, c widened
    to the compute type, K's, as each stage is loaded)."""
    N = A.shape[0]
    up = lambda x: x.to(K.dtype)
    x = x0
    rows = []
    for k in range(N):
        u = _mv(K[k], x) + d[k]
        rows.append(torch.cat([u, x], dim=0))
        x = _mv(up(A[k]), x) + _mv(up(B[k]), u) + up(c[k])
    return torch.stack(rows, dim=0), x


def _launch_forward_rollout(lib, A, B, c, K, d, x0, stream):
    """Allocate K7's outputs and launch it (no argument checks)."""
    N, nx, _, Bt = A.shape
    nu = K.shape[1]
    ws = torch.empty((N, nx + nu, Bt), dtype=K.dtype, device=A.device)
    xN = torch.empty((nx, Bt), dtype=K.dtype, device=A.device)
    status = lib.riccati_forward_rollout(
        N, Bt, stream, *(x.data_ptr() for x in (A, B, c, K, d, x0, ws, xN)))
    _check_status("forward_rollout_lanes", status)
    return ws, xN


def forward_rollout_lanes(A, B, c, K, d, x0):
    """Closed-loop rollout from the raw dynamics: u = K x + d,
    x+ = A x + B u + c, one model a scenario; returns (ws (N, nz, B) with
    rows [u; x], xN (nx, B)).

    A (N,nx,nx,B), B (N,nx,nu,B), c (N,nx,B), K (N,nu,nx,B), d (N,nu,B),
    x0 (nx,B): the same result as forward_lanes on (M, v) = (A + B K,
    B d + c), without forming them (backward_lanes(emit_closed_loop=
    False) skips computing and writing them).  The compute type is K's;
    A, B, c may be stored in bfloat16.

    On the card: a block's warps take roles on 32 scenarios (producers
    staging whole stages through a ring of shared-memory slots, a chain
    lane a scenario, a store warp); see the note in the kernel source.
    bfloat16 streams stay 2 bytes an entry in the slots, widened where the
    chain reads them.
    """
    N, nx, _, Bt = A.shape
    nu = K.shape[1]
    dt, dev = K.dtype, A.device
    st = _storage("forward_rollout_lanes", A, dt)
    streams = (("A", A, (N, nx, nx, Bt)), ("B", B, (N, nx, nu, Bt)),
               ("c", c, (N, nx, Bt)))
    for name, x, shape in streams:
        _check(name, x, shape, st, dev)
    for name, x, shape in (("K", K, (N, nu, nx, Bt)), ("d", d, (N, nu, Bt)),
                           ("x0", x0, (nx, Bt))):
        _check(name, x, shape, dt, dev)
    if dev.type == "cpu":
        return forward_rollout_lanes_reference(A, B, c, K, d, x0)
    if dev.type != "cuda":
        raise ValueError(f"forward_rollout_lanes: no kernel for device {dev}")
    narrow = st != dt
    if narrow:
        _check_aligned("forward_rollout_lanes", [(n, x) for n, x, _ in streams])
    lib = _library(dt, nx, nu, narrow=narrow)
    with torch.cuda.device(dev):
        out = _launch_forward_rollout(lib, A, B, c, K, d, x0, _stream())
    LAUNCHES["forward_rollout_lanes[bf16]" if narrow
             else "forward_rollout_lanes"] += 1
    return out


# ------------------------------------------------------------- K9, K10

def _pdp_segment_reference(A, B, c, H, h, D, rho, rg, P, p, F, C, f,
                           export_factors):
    """K9 on one segment: the stage loop from the segment's carry."""
    nx = A.shape[1]
    cols = {name: [] for name in ("K", "d", "M", "v", "Gp", "P", "L", "F")}
    for k in range(A.shape[0] - 1, -1, -1):
        Hk, hk = _fold_penalty(H[k], h[k], D[k], rho[k], rg[k])
        FB = torch.einsum("ijb,jkb->ikb", F, B[k])
        K, d, L, Gp, Pn, pn = _sweep_stage(P, p, A[k], B[k], c[k], Hk, hk,
                                           extra=FB.transpose(0, 1))
        M, v = _closed_loop(A[k], B[k], c[k], K, d)
        for name, x in (("K", K), ("d", d), ("M", M), ("v", v), ("Gp", Gp),
                        ("P", P), ("L", L), ("F", F)):
            cols[name].append(x)
        # F = F+ M, f = F+ v + f+, C = C+ - (F+ B) Gp (upper triangle,
        # mirrored, as the kernel).
        F, f = (torch.einsum("ijb,jkb->ikb", F, M), _mv(F, v) + f)
        C = _sym(C - torch.einsum("itb,tjb->ijb", FB, Gp))
        P, p = Pn, pn
    names = ("K", "d", "M", "v", "Gp") + (("P", "L", "F") if export_factors
                                          else ())
    stages = tuple(torch.stack(cols[n][::-1], dim=0) for n in names)
    return stages, (P, p, F, C, f)


def backward_pdp_lanes_reference(A, B, c, H, h, D, rho, rg, Pi, pi, Fi, Ci,
                                 fi, *, export_factors=False, segments=None):
    """Plain PyTorch version of ``backward_pdp_lanes`` (same arguments,
    same returns): each segment's stage loop in turn."""
    if segments is None:
        stages, bnd = _pdp_segment_reference(
            A, B, c, H, h, D, rho, rg, Pi, pi, Fi, Ci, fi, export_factors)
        return stages + bnd
    parts = [_pdp_segment_reference(
        A[sl], B[sl], c[sl], H[sl], h[sl], D[sl], rho[sl], rg[sl], Pi[s],
        pi[s], Fi[s], Ci[s], fi[s], export_factors)
        for s, sl in enumerate(_segments(A.shape[0], segments))]
    stages = tuple(torch.cat(xs, dim=0) for xs in zip(*(q[0] for q in parts)))
    return stages + tuple(torch.stack(xs, dim=0)
                          for xs in zip(*(q[1] for q in parts)))


def _launch_backward_pdp(lib, A, B, c, H, h, D, rho, rg, Pi, pi, Fi, Ci, fi,
                         export_factors, segments, stream):
    """Allocate K9's outputs and launch it (no argument checks)."""
    N, nx, _, Bt = A.shape
    nu = B.shape[2]
    new = lambda *shape: torch.empty(shape, dtype=A.dtype, device=A.device)
    K, d, M, v, Gp = (new(N, nu, nx, Bt), new(N, nu, Bt), new(N, nx, nx, Bt),
                      new(N, nx, Bt), new(N, nu, nx, Bt))
    P = L = F = None
    if export_factors:
        P, L, F = new(N, nx, nx, Bt), new(N, nu, nu, Bt), new(N, nx, nx, Bt)
    bnd = tuple(new(*x.shape) for x in (Pi, pi, Fi, Ci, fi))
    ptr = lambda x: None if x is None else x.data_ptr()
    status = lib.riccati_backward_pdp(
        N, Bt, segments or 1, int(export_factors), stream,
        *(ptr(x) for x in (A, B, c, H, h, D, rho, rg, Pi, pi, Fi, Ci, fi, K, d,
                           M, v, Gp, P, L, F) + bnd))
    _check_status("backward_pdp_lanes", status)
    out = (K, d, M, v, Gp)
    if export_factors:
        out = out + (P, L, F)
    return out + bnd


def backward_pdp_lanes(A, B, c, H, h, D, rho, rg, Pi, pi, Fi, Ci, fi, *,
                       export_factors=False, segments=None):
    """Fused PDP segment reduction; all tensors batch-last.

    Stage tensors as in ``backward_lanes``, one model an instance
    (trailing size B).  (Pi, pi, Fi, Ci, fi) are the initial carries: the
    last segment's are the folded terminal cost-to-go with F = I, C = f =
    0; the others' P = p = 0, F = I, C = f = 0
    (lqr_kernel_parallel.hpp:51-67 in P-form).

    Returns (K, d, M, v, Gp, P0, p0, F0, C0, f0); with ``export_factors``
    (K, d, M, v, Gp, P, L, F, P0, p0, F0, C0, f0), where (P, L, F) are the
    per-stage P_{k+1}, chol(Huu), F_{k+1} that backward_pdp_vectors_lanes
    reads while rho is unchanged, and (P0, p0, F0, C0, f0) the carry
    after the segment's first stage, which goes to the condensed system.

    ``segments=S``: the N stages are S segments of N/S, swept at once
    from their own carries; the carries and boundary values carry a
    leading segment axis, (S,nx,nx,B) / (S,nx,B).  ``None``: one segment,
    carries (nx,nx,B) / (nx,B), the JAX function's layout.

    On the card: a warp a (segment, instance), a block of several
    instances of one segment (where the pairs do not outnumber the SMs: a
    block each); see the note at K1 in the kernel source.
    """
    N, nx, _, Bt = A.shape
    nu = B.shape[2]
    nz = nx + nu
    nc = D.shape[1]
    dt, dev = A.dtype, A.device
    lead = () if segments is None else (segments,)
    if segments is not None:
        _segments(N, segments)
    for name, x, shape in (
        ("A", A, (N, nx, nx, Bt)), ("B", B, (N, nx, nu, Bt)),
        ("c", c, (N, nx, Bt)), ("H", H, (N, nz, nz, Bt)),
        ("h", h, (N, nz, Bt)), ("D", D, (N, nc, nz, Bt)),
        ("rho", rho, (N, nc, Bt)), ("rg", rg, (N, nc, Bt)),
        ("Pi", Pi, lead + (nx, nx, Bt)), ("pi", pi, lead + (nx, Bt)),
        ("Fi", Fi, lead + (nx, nx, Bt)), ("Ci", Ci, lead + (nx, nx, Bt)),
        ("fi", fi, lead + (nx, Bt)),
    ):
        _check(name, x, shape, dt, dev)
    if dev.type == "cpu":
        return backward_pdp_lanes_reference(
            A, B, c, H, h, D, rho, rg, Pi, pi, Fi, Ci, fi,
            export_factors=export_factors, segments=segments)
    if dev.type != "cuda":
        raise ValueError(f"backward_pdp_lanes: no kernel for device {dev}")
    lib = _library(dt, nx, nu, nc)
    with torch.cuda.device(dev):
        out = _launch_backward_pdp(lib, A, B, c, H, h, D, rho, rg, Pi, pi, Fi,
                                   Ci, fi, export_factors, segments, _stream())
    LAUNCHES["backward_pdp_lanes"] += 1
    return out


def backward_pdp_vectors_lanes_reference(A, B, c, hf, P, K, L, F, pi, *,
                                         segments=None):
    """Plain PyTorch version of ``backward_pdp_vectors_lanes``: K2's
    recursion on each segment from its pi, and f0 = sum_k F_{k+1} v_k."""
    def segment(sl, p):
        d, v, p0 = _vector_sweep(A[sl], B[sl], c[sl], hf[sl], P[sl], K[sl],
                                 L[sl], p)
        return d, v, p0, torch.einsum("kijb,kjb->ib", F[sl], v)

    if segments is None:
        return segment(slice(None), pi)
    parts = [segment(sl, pi[s])
             for s, sl in enumerate(_segments(A.shape[0], segments))]
    d, v, p0, f0 = zip(*parts)
    return (torch.cat(d, dim=0), torch.cat(v, dim=0), torch.stack(p0, dim=0),
            torch.stack(f0, dim=0))


def _launch_backward_pdp_vectors(lib, A, B, c, hf, P, K, L, F, pi, segments,
                                 stream):
    """Allocate K10's outputs and launch it (no argument checks)."""
    N, nx = A.shape[0], A.shape[1]
    nu = B.shape[2]
    Bt = c.shape[-1]
    d = torch.empty((N, nu, Bt), dtype=c.dtype, device=c.device)
    v = torch.empty((N, nx, Bt), dtype=c.dtype, device=c.device)
    p0 = torch.empty(pi.shape, dtype=c.dtype, device=c.device)
    f0 = torch.empty(pi.shape, dtype=c.dtype, device=c.device)
    status = lib.riccati_backward_pdp_vectors(
        N, Bt, segments or 1, stream,
        *(x.data_ptr() for x in (A, B, c, hf, P, K, L, F, pi, d, v, p0, f0)))
    _check_status("backward_pdp_vectors_lanes", status)
    return d, v, p0, f0


def backward_pdp_vectors_lanes(A, B, c, hf, P, K, L, F, pi, *, segments=None):
    """Cached-factor PDP segment vector sweep.

    (P, K, L, F) from backward_pdp_lanes(export_factors=True); hf (N,nz,B)
    the fully iterate-folded linear cost (h - sigma w - D^T rho g); pi the
    iterate-folded terminal linear cost on the last segment, zeros on the
    others.  Per stage, from p = pi and f = 0:

      Pcp  = P c + p            rbar = hf[:nu] + B^T Pcp
      d    = -(L L^T)^{-1} rbar v    = B d + c
      p    = hf[nu:] + A^T Pcp + K^T rbar      f = F v + f

    Returns (d (N,nu,B), v (N,nx,B), p0, f0): the vector half of each
    segment's boundary, (nx,B), or (S,nx,B) with ``segments=S`` (pi then
    (S,nx,B) too).

    On the card: a block serves W consecutive scenarios of one segment, a
    lane each, with warps in roles: producers copy every stage into a
    shared-memory ring (boxes of the copy engine where the batch's rows
    are whole 16-byte pieces, word copies otherwise), a chain warp carries
    p, a tail warp carries f and stores d and v; see the kernel source.
    """
    N, nx = A.shape[0], A.shape[1]
    nu = B.shape[2]
    nz = nx + nu
    Bt = c.shape[-1]
    dt, dev = c.dtype, c.device
    lead = () if segments is None else (segments,)
    if segments is not None:
        _segments(N, segments)
    for name, x, shape in (
        ("A", A, (N, nx, nx, Bt)), ("B", B, (N, nx, nu, Bt)),
        ("c", c, (N, nx, Bt)), ("hf", hf, (N, nz, Bt)),
        ("P", P, (N, nx, nx, Bt)), ("K", K, (N, nu, nx, Bt)),
        ("L", L, (N, nu, nu, Bt)), ("F", F, (N, nx, nx, Bt)),
        ("pi", pi, lead + (nx, Bt)),
    ):
        _check(name, x, shape, dt, dev)
    if dev.type == "cpu":
        return backward_pdp_vectors_lanes_reference(A, B, c, hf, P, K, L, F,
                                                    pi, segments=segments)
    if dev.type != "cuda":
        raise ValueError(
            f"backward_pdp_vectors_lanes: no kernel for device {dev}")
    lib = _library(dt, nx, nu)
    with torch.cuda.device(dev):
        out = _launch_backward_pdp_vectors(lib, A, B, c, hf, P, K, L, F, pi,
                                           segments, _stream())
    LAUNCHES["backward_pdp_vectors_lanes"] += 1
    return out


# --------------------------------------------------- per-instance (lanes)

def _join_terminal(ws, xN, nu):
    """(N, nz, B) stage rows and the final state (nx, B) -> ws
    (B, N+1, nz), the terminal stage's controls zero."""
    ws = from_lanes(ws)                          # (B, N, nz)
    xN = xN.T                                    # (B, nx)
    wN = torch.cat([xN.new_zeros(xN.shape[:-1] + (nu,)), xN], dim=-1)
    return torch.cat([ws, wN[:, None, :]], dim=1)


def _stage_sources(problem, it, sigma, storage_dtype):
    """The eight stage streams of a batched problem (leading batch axis),
    at full width: (A, B, c, H~, h~, D, rho, rho g) of the non-terminal
    stages; the terminal fold (PN, pN) batch-last, at full width from the
    unrounded data; and the storage type (the compute type, or bfloat16).
    rho g is the full-width product (rounded after it, as JAX rounds it)."""
    dt = problem.A.dtype
    st = dt if storage_dtype is None else storage_dtype
    if st not in (dt, NARROW):
        raise TypeError(
            f"storage_dtype {storage_dtype}: the stage streams are stored in "
            f"the compute type {dt} or bfloat16 (torch.bfloat16 only)")
    nu = problem.nu
    params = make_stage_params(problem, it, sigma)
    with full_f32_matmul():
        HN = params.H[:, -1, nu:, nu:]
        hN = params.h[:, -1, nu:]
        if problem.nc > 0:
            DN, rhoN, gN = problem.D[:, -1, :, nu:], it.rho[:, -1], params.g[:, -1]
            HN = HN + torch.einsum("bci,bc,bcj->bij", DN, rhoN, DN)
            hN = hN - torch.einsum("bci,bc->bi", DN, rhoN * gN)
    sources = (problem.A, problem.B, problem.c, params.H[:, :-1],
               params.h[:, :-1], problem.D[:, :-1], it.rho[:, :-1],
               it.rho[:, :-1] * params.g[:, :-1])
    return sources, to_lanes(HN).contiguous(), to_lanes(hN).contiguous(), st


def _lanes_into(out, src):
    """``out`` (batch-last, its storage type) := the batch-leading ``src``:
    one copy that transposes and rounds together, so a narrow stream makes
    no full-width transient (rounding first and transposing after would
    hold the stream twice; transposing first, at full width)."""
    return out.copy_(to_lanes(src))


def _x0_lanes(problem, x0):
    x0 = torch.as_tensor(x0).to(device=problem.A.device, dtype=problem.A.dtype)
    return x0.T.contiguous()


def prepare_lanes(problem, it, x0, sigma: float, storage_dtype=None):
    """Transpose a batched problem (leading batch axis B on every field)
    and its iterates into the lanes layout: the argument tuple of
    ``solve_prepared``,
    (A, B, c, H, h, D, rho, rg, PN, pN, x0, nu), every tensor batch-last
    and contiguous.  The stage matrices are penalty-free: K1 folds
    rho D D^T itself; the terminal stage is folded here.

    ``storage_dtype=torch.bfloat16`` stores the eight stage streams A, B,
    c, H~, h~, D, rho, rho g narrow (each rounded from its full-width
    value: half the device memory and traffic of the streams); PN, pN and
    x0 stay in the compute type, which the kernels keep.  None, or the
    compute type: full width.
    """
    sources, PN, pN, st = _stage_sources(problem, it, sigma, storage_dtype)
    lanes = lambda x: _lanes_into(torch.empty(
        x.shape[1:] + x.shape[:1], dtype=st, device=x.device), x)
    return (*(lanes(x) for x in sources), PN, pN, _x0_lanes(problem, x0),
            problem.nu)


def solve_prepared(prep):
    """Run the per-instance kernels on prepared lanes data -> ws
    (B, N+1, nz): K1 for the gains only (no closed-loop maps), then K7
    on the raw dynamics."""
    A, B, c, H, h, D, rho, rg, PN, pN, x0_l, nu = prep
    K, d = backward_lanes(A, B, c, H, h, D, rho, rg, PN, pN,
                          emit_closed_loop=False)
    ws, xN = forward_rollout_lanes(A, B, c, K, d, x0_l)
    return _join_terminal(ws, xN, nu)


def solve_lanes(problem, it, x0, sigma: float, *, storage_dtype=None):
    """Batched solve, one model a scenario: ``problem`` and ``it`` carry a
    leading batch axis B, x0 (B, nx).  Returns ws (B, N+1, nz) in the
    compute type.  ``storage_dtype``: see prepare_lanes (bfloat16 stage
    streams through the narrow forms of K1 and K7)."""
    return solve_prepared(prepare_lanes(problem, it, x0, sigma,
                                        storage_dtype))


# --------------------------------------------- packed streams (K11, K12)

def _packed_nx(rows, nu):
    """nx from the rows of a packed Sd: nx (nx + nu + 1) = rows."""
    nx = (-(nu + 1) + math.isqrt((nu + 1) ** 2 + 4 * rows)) // 2
    if nx * (nx + nu + 1) != rows:
        raise ValueError(f"Sd rows {rows} are not nx (nx + nu + 1) for nu={nu}")
    return nx


def _unpack_dynamics(Sd, nu):
    """Views A (N,nx,nx,B), B (N,nx,nu,B), c (N,nx,B) of Sd = (A | B | c)."""
    N, rows, Bt = Sd.shape
    nx = _packed_nx(rows, nu)
    return (Sd[:, :nx * nx].reshape(N, nx, nx, Bt),
            Sd[:, nx * nx:nx * (nx + nu)].reshape(N, nx, nu, Bt),
            Sd[:, nx * (nx + nu):])


def _unpack_cost(Sc, nz, nc):
    """Views H, h, D, rho, rg of Sc = (H | h | D | rho | rho g)."""
    N, _, Bt = Sc.shape
    o = nz * nz + nz
    return (Sc[:, :nz * nz].reshape(N, nz, nz, Bt), Sc[:, nz * nz:o],
            Sc[:, o:o + nc * nz].reshape(N, nc, nz, Bt),
            Sc[:, o + nc * nz:o + nc * nz + nc], Sc[:, o + nc * nz + nc:])


def backward_packed_reference(Sd, Sc, PN, pN, nu, nc):
    """Plain PyTorch version of ``backward_packed``: K1's (gains only) on
    the unpacked views."""
    A, B, c = _unpack_dynamics(Sd, nu)
    H, h, D, rho, rg = _unpack_cost(Sc, A.shape[1] + nu, nc)
    K, d = backward_lanes_reference(A, B, c, H, h, D, rho, rg, PN, pN,
                                    emit_closed_loop=False)
    return torch.cat([K.flatten(1, 2), d], dim=1)


def backward_packed(Sd, Sc, PN, pN, nu, nc):
    """Packed-stream (K, d)-only backward sweep: the same math as
    backward_lanes(emit_closed_loop=False) on one model an instance.

    ``Sd`` (N, nx*nx + nx*nu + nx, B) the row-packed (A | B | c)
    dynamics; ``Sc`` (N, nz*nz + nz + nc*nz + 2nc, B) the row-packed
    (H~ | h~ | D | rho | rho*g) cost (nz*nz + nz rows when nc = 0);
    PN/pN the folded terminal cost-to-go.  Returns the packed gains
    G (N, nu*nx + nu, B).

    The compute type (G's) is PN's; Sd and Sc may be stored in bfloat16.

    On the card: K1's kernel reading the packed strides (on the TPU the
    packing saved DMA windows; here it changes only the addresses)."""
    N, rows, Bt = Sd.shape
    nx = _packed_nx(rows, nu)
    nz = nx + nu
    dt, dev = PN.dtype, PN.device
    st = _storage("backward_packed", Sd, dt)
    streams = (("Sd", Sd, (N, nx * (nx + nu + 1), Bt)),
               ("Sc", Sc, (N, nz * nz + nz + nc * nz + 2 * nc, Bt)))
    for name, x, shape in streams:
        _check(name, x, shape, st, dev)
    _check("PN", PN, (nx, nx, Bt), dt, dev)
    _check("pN", pN, (nx, Bt), dt, dev)
    if dev.type == "cpu":
        return backward_packed_reference(Sd, Sc, PN, pN, nu, nc)
    if dev.type != "cuda":
        raise ValueError(f"backward_packed: no kernel for device {dev}")
    narrow = st != dt
    if narrow:
        _check_aligned("backward_packed", [(n, x) for n, x, _ in streams])
    lib = _library(dt, nx, nu, nc, narrow)
    with torch.cuda.device(dev):
        G = _launch_backward_packed(lib, Sd, Sc, PN, pN, nu, _stream())
    LAUNCHES["backward_packed[bf16]" if narrow else "backward_packed"] += 1
    return G


def _launch_backward_packed(lib, Sd, Sc, PN, pN, nu, stream):
    """Allocate K11's output and launch it (no argument checks)."""
    N, rows, Bt = Sd.shape
    nx = _packed_nx(rows, nu)
    G = torch.empty((N, nu * nx + nu, Bt), dtype=PN.dtype, device=PN.device)
    status = lib.riccati_backward_packed(
        N, Bt, stream, *(x.data_ptr() for x in (Sd, Sc, PN, pN, G)))
    _check_status("backward_packed", status)
    return G


def forward_packed_reference(Sd, G, x0, nu):
    """Plain PyTorch version of ``forward_packed``: K7's on the unpacked
    views."""
    A, B, c = _unpack_dynamics(Sd, nu)
    N, nx, Bt = A.shape[0], A.shape[1], G.shape[-1]
    return forward_rollout_lanes_reference(
        A, B, c, G[:, :nu * nx].reshape(N, nu, nx, Bt), G[:, nu * nx:], x0)


def forward_packed(Sd, G, x0, nu):
    """Packed-stream rollout from the raw dynamics: ``Sd`` as in
    backward_packed, ``G`` its packed gains, x0 (nx, B).  Returns
    (ws (N, nz, B), xN (nx, B)) in G's type, the compute type; Sd may be
    stored in bfloat16 (the JAX function's ``storage_dtype``).

    On the card: K7's kernel reading the packed strides."""
    N, rows, Bt = Sd.shape
    nx = _packed_nx(rows, nu)
    dt, dev = G.dtype, G.device
    st = _storage("forward_packed", Sd, dt)
    _check("Sd", Sd, (N, nx * (nx + nu + 1), Bt), st, dev)
    _check("G", G, (N, nu * nx + nu, Bt), dt, dev)
    _check("x0", x0, (nx, Bt), dt, dev)
    if dev.type == "cpu":
        return forward_packed_reference(Sd, G, x0, nu)
    if dev.type != "cuda":
        raise ValueError(f"forward_packed: no kernel for device {dev}")
    narrow = st != dt
    if narrow:
        _check_aligned("forward_packed", [("Sd", Sd)])
    lib = _library(dt, nx, nu, narrow=narrow)
    with torch.cuda.device(dev):
        out = _launch_forward_packed(lib, Sd, G, x0, _stream())
    LAUNCHES["forward_packed[bf16]" if narrow else "forward_packed"] += 1
    return out


def _launch_forward_packed(lib, Sd, G, x0, stream):
    """Allocate K12's outputs and launch it (no argument checks)."""
    N, Bt = Sd.shape[0], Sd.shape[-1]
    nx = x0.shape[0]
    nz = nx + (G.shape[1] // (nx + 1))
    ws = torch.empty((N, nz, Bt), dtype=G.dtype, device=G.device)
    xN = torch.empty((nx, Bt), dtype=G.dtype, device=G.device)
    status = lib.riccati_forward_packed(
        N, Bt, stream, *(x.data_ptr() for x in (Sd, G, x0, ws, xN)))
    _check_status("forward_packed", status)
    return ws, xN


def prepare_packed(problem, it, x0, sigma: float, storage_dtype=None):
    """Packed-stream preparation: the prepare_lanes layout with the stage
    streams row-concatenated into Sd = (A | B | c) and Sc = (H~ | h~ | D |
    rho | rho*g).  Returns the argument tuple for solve_packed_prepared,
    (Sd, Sc, PN, pN, x0, nu, nc).  ``storage_dtype``: see prepare_lanes
    (Sd and Sc narrow).  Each stream is copied into its rows of Sd or Sc
    directly (no separate stream tensors)."""
    sources, PN, pN, st = _stage_sources(problem, it, sigma, storage_dtype)
    N, nx, Bt = problem.N, problem.nx, problem.A.shape[0]
    nu, nc = problem.nu, problem.nc
    nz = nx + nu
    new = lambda rows: torch.empty((N, rows, Bt), dtype=st,
                                   device=problem.A.device)
    Sd = new(nx * (nx + nu + 1))
    Sc = new(nz * nz + nz + nc * nz + 2 * nc)
    for out, src in zip(_unpack_dynamics(Sd, nu) + _unpack_cost(Sc, nz, nc),
                        sources):
        _lanes_into(out, src)
    return (Sd, Sc, PN, pN, _x0_lanes(problem, x0), nu, nc)


def solve_packed_prepared(prep):
    """Run the packed-stream kernel pair -> ws (B, N+1, nz)."""
    Sd, Sc, PN, pN, x0_l, nu, nc = prep
    G = backward_packed(Sd, Sc, PN, pN, nu, nc)
    ws, xN = forward_packed(Sd, G, x0_l, nu)
    return _join_terminal(ws, xN, nu)


def solve_packed(problem, it, x0, sigma: float, *, storage_dtype=None):
    """Batched solve through the packed-stream kernels: the contract of
    solve_lanes (the same function, the streams packed)."""
    return solve_packed_prepared(prepare_packed(problem, it, x0, sigma,
                                                storage_dtype))


# ------------------------------------------------- shared-stage (broadcast)

def prepare_shared(problem, it, x0, sigma: float):
    """Broadcast-mode preparation: ONE shared model, B scenarios.

      * ``problem`` is UNBATCHED — except ``c``, which may carry a
        leading batch axis (B, N, nx) for per-scenario drift;
      * ``it.rho`` must be UNBATCHED (N+1, nc): the penalty-folded
        matrices are shared only while rho is; w/y/z may be unbatched
        or batched (B, N+1, ...);
      * ``x0`` (B, nx) sets the scenario batch size.

    The stage matrices (A, B, H~, D, rho) get a trailing batch axis of
    size 1: the card holds one copy, whatever B is.  Returns the
    argument tuple for ``solve_shared_prepared``:
    (A, B, H, D, rho, PN, c, hf, pN, x0, nu), vectors batch-last.
    """
    nu, nx, nc = problem.nu, problem.nx, problem.nc
    nz = nu + nx
    N = problem.N
    dt, dev = problem.H.dtype, problem.H.device
    if problem.A.ndim != 3:
        raise ValueError(
            "prepare_shared takes an UNBATCHED problem (one shared "
            "model); per-instance models are not ported yet"
        )
    rho = it.rho
    if rho.ndim != 2:
        raise ValueError(
            "prepare_shared needs a shared (unbatched) rho (N+1, nc): "
            "the folded stage matrices are shared only while the "
            "penalty is"
        )
    x0 = torch.as_tensor(x0).to(device=dev, dtype=dt)
    Bt = x0.shape[0]

    one = lambda x: x[..., None].contiguous()
    eye_z = torch.eye(nz, dtype=dt, device=dev)
    A_sh = one(problem.A)
    B_sh = one(problem.B)
    H_sh = one(problem.H[:-1] + sigma * eye_z)
    D_sh = one(problem.D[:-1])
    rho_sh = one(rho[:-1])

    with full_f32_matmul():
        # Terminal matrix fold (shared): P_N = Hxx + sigma I + Dx^T rho Dx.
        PN = problem.H[-1, nu:, nu:] + sigma * torch.eye(nx, dtype=dt, device=dev)
        if nc > 0:
            DNx = problem.D[-1, :, nu:]
            PN = PN + torch.einsum("ci,c,cj->ij", DNx, rho[-1], DNx)
        PN_sh = one(PN)

        # Per-scenario vector pieces: the fully iterate-folded linear cost
        # hf = h - sigma w - D^T (rho g) (update_problem_data semantics,
        # lqr_solver.hpp:41-56, with the penalty fold pre-applied — the
        # matrix sweep runs on zero vectors, so the vector sweep carries
        # the whole linear recursion).  Batched iterates broadcast a
        # leading B into hf; unbatched ones leave it (N+1, nz).
        hf = problem.h - sigma * it.w
        if nc > 0:
            g = it.z - guarded_inverse(rho) * it.y
            hf = hf - torch.einsum("kcz,...kc->...kz", problem.D, rho * g)

    def lanes(x, tail):
        """Batch-last, contiguous: a batched (B, ...) tensor is transposed,
        an unbatched one is written out B times (no batched arithmetic)."""
        if x.ndim == len(tail) + 1:
            return torch.movedim(x, 0, -1).contiguous()
        return x[..., None].expand(tail + (Bt,)).contiguous()

    c_l = lanes(problem.c.to(dt), (N, nx))
    hf_l = lanes(hf[..., :-1, :], (N, nz))
    pN_l = lanes(hf[..., -1, nu:], (nx,))
    x0_l = x0.T.contiguous()

    return (A_sh, B_sh, H_sh, D_sh, rho_sh, PN_sh,
            c_l, hf_l, pN_l, x0_l, nu)


def fold_Pc(P, c_l):
    """``Pc[k] = P_{k+1} c_k`` for every scenario: (N,nx,nx,1) by
    (N,nx,B) -> (N,nx,B).  P enters the vector recursion only through
    this product, so it is folded once per solve by one batched library
    matmul (full float32)."""
    with full_f32_matmul():
        return torch.matmul(P[..., 0], c_l)


def shared_factors(prep):
    """Run ONLY the matrix sweep of the shared pipeline and return the
    cached factors (K, M, P, L), each with trailing size 1 — the
    reference's factorization state that
    ``backward_without_factorization`` reuses (lqr_kernel.hpp:93-101).
    Valid while the model matrices and rho are unchanged."""
    (A_sh, B_sh, H_sh, D_sh, rho_sh, PN_sh,
     _c, _hf, _pN, _x0, nu) = prep
    N, nx = A_sh.shape[0], A_sh.shape[1]
    nz = H_sh.shape[1]
    nc = D_sh.shape[1]
    zeros = lambda *shape: torch.zeros(shape, dtype=A_sh.dtype,
                                       device=A_sh.device)
    K, _, M, _, P, L = backward_lanes(
        A_sh, B_sh, zeros(N, nx, 1), H_sh, zeros(N, nz, 1), D_sh, rho_sh,
        zeros(N, nc, 1), PN_sh, zeros(nx, 1), export_factors=True,
    )
    return (K, M, P, L)


def solve_shared_cached(prep, factors):
    """Shared solve on pre-built factors: the ``Pc`` fold, the vector
    sweep and the rollout only.  ``factors`` from shared_factors(prep) —
    rebuild them whenever the model matrices or rho change.
    Returns ws (B, N+1, nz)."""
    (A_sh, B_sh, _H, _D, _rho, _PN,
     c_l, hf_l, pN_l, x0_l, nu) = prep
    K, M, P, L = factors
    Pc = fold_Pc(P, c_l)
    d, v = backward_vectors_lanes(
        A_sh, B_sh, c_l, hf_l, P, K, L, pN_l, shared=True, Pc=Pc,
    )
    ws, xN = forward_lanes(M, v, K, d, x0_l, shared=True)
    return _join_terminal(ws, xN, nu)


def solve_shared_prepared(prep):
    """Run the shared-stage pipeline -> ws (B, N+1, nz).

    Three kernels: (1) the matrix sweep — backward_lanes with factor
    export on the ONE shared model (the whole rho-dependent Riccati
    matrix recursion, done once, not per scenario); (2) the per-scenario
    vector sweep on those factors (backward_vectors_lanes(shared=True));
    (3) the shared-map closed-loop rollout (forward_lanes(shared=True)).
    """
    return solve_shared_cached(prep, shared_factors(prep))


def solve_shared(problem, it, x0, sigma: float):
    """Shared-model batched solve (see prepare_shared for the contract).
    Returns ws (B, N+1, nz)."""
    return solve_shared_prepared(prepare_shared(problem, it, x0, sigma))
