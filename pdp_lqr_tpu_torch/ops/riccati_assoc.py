"""Log-depth Riccati by associative scans — PyTorch port of
``pdp_lqr_tpu/ops/riccati_assoc.py``.

No reference counterpart: the reference parallelizes the backward sweep
only across coarse OpenMP segments (lqr_solver_parallel.hpp:142-162).
Here the whole backward pass is a parallel suffix reduction over
conditional value-function elements (Sarkka & Garcia-Fernandez,
"Temporal Parallelization of Dynamic Programming and Linear Quadratic
Control", public algorithm), of O(log N) depth.

Element e = (A, b, C, eta, J) represents the conditional value function
between two stages:

  V_e(x, z) = sup_l { l^T (z - A x - b) - 1/2 l^T C l }
              + 1/2 x^T J x - eta^T x      (+ const, not tracked)

Composition over the shared intermediate state is associative with the
closed-form rule

  T   = (I + C1 J2)^{-1}            (eigenvalues >= 1: C1, J2 are PSD)
  A3  = A2 T A1
  b3  = A2 T (b1 + C1 eta2) + b2
  C3  = A2 T C1 A2^T + C2
  eta3 = A1^T T^T (eta2 - J2 b1) + eta1
  J3  = A1^T T^T J2 A1 + J1

using (I + J2 C1)^{-1} = (I + C1 J2)^{-T}.  The suffix-combined element at
stage k has J = P_k, eta = -p_k; the stage factors (L, lp) are then
recovered for all stages at once in the layout of ``riccati.RiccatiFactors``,
and ``forward`` is a log-depth rollout as a prefix scan over affine maps.

PyTorch has no associative scan: ``associative_scan`` below is the
odd-even recursion of ``jax.lax.associative_scan`` (combine adjacent
pairs, scan the half, fix up the other half: 2 log2 N levels of batched
combines), so both packages combine the same elements in the same tree.
The stage axis is the first of an element's own axes (after any leading
batch axes): -3 for a matrix, -2 for a vector.
"""

from __future__ import annotations

import torch

from pdp_lqr_tpu_torch.config import full_f32_matmul
from pdp_lqr_tpu_torch.ops import linalg, riccati
from pdp_lqr_tpu_torch.problem import LQRProblem, StageParams

_mv = riccati._mv


def _to_front(elems):
    """Move every element's stage axis to the front: the scans index dim 0.
    Vectors are the elements of the lowest rank."""
    nd = min(e.ndim for e in elems)
    return tuple(torch.movedim(e, -2 if e.ndim == nd else -3, 0)
                 for e in elems), nd


def _to_back(elems, nd):
    return tuple(torch.movedim(e, 0, -2 if e.ndim == nd else -3)
                 for e in elems)


def _interleave(a, b):
    """Rows a0, b0, a1, b1, ... along dim 0 (len(a) - len(b) in {0, 1})."""
    n = a.shape[0] + b.shape[0]
    out = a.new_empty((n,) + a.shape[1:])
    out[0::2] = a
    out[1::2] = b
    return out


def _scan_front(fn, elems):
    """Inclusive scan along dim 0 of every element (the odd-even
    recursion of ``jax.lax.associative_scan``)."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = fn(tuple(e[0:-1:2] for e in elems), tuple(e[1::2] for e in elems))
    odd = _scan_front(fn, reduced)
    if n % 2 == 0:
        even = fn(tuple(o[:-1] for o in odd), tuple(e[2::2] for e in elems))
    else:
        even = fn(odd, tuple(e[2::2] for e in elems))
    even = tuple(torch.cat([e[:1], r], dim=0) for e, r in zip(elems, even))
    return tuple(_interleave(e, o) for e, o in zip(even, odd))


def associative_scan(fn, elems, reverse: bool = False):
    """Inclusive scan of ``fn(earlier, later)`` over the stage axis of a
    tuple of elements (vectors (..., N, n), matrices (..., N, n, m)), as
    ``jax.lax.associative_scan(fn, elems, axis=0, reverse=reverse)`` on a
    single problem: with ``reverse`` the elements are scanned from the
    last stage and ``fn`` still receives (earlier in the scan, later)."""
    front, nd = _to_front(elems)
    if reverse:
        front = tuple(torch.flip(e, dims=(0,)) for e in front)
    out = _scan_front(fn, front)
    if reverse:
        out = tuple(torch.flip(e, dims=(0,)) for e in out)
    return _to_back(out, nd)


def leaf_elements(problem: LQRProblem, params: StageParams, rho):
    """Per-stage value elements from penalty-folded stage data.

    Stage k < N (cost blocks R~, S~, Q~, r~, q~ of the penalized H~, h~;
    dynamics x+ = A x + B u + c), eliminating u:

      A_k  = A - B R~^{-1} S~        b_k = c - B R~^{-1} r~
      C_k  = B R~^{-1} B^T
      J_k  = Q~ - S~^T R~^{-1} S~    eta_k = -(q~ - S~^T R~^{-1} r~)

    Terminal: A = 0, b = 0, C = 0, J = Q~_N, eta = -q~_N.

    Returns a 5-tuple of (N+1, ...) stacked tensors.
    """
    nu, nx = problem.nu, problem.nx
    H, h = riccati.penalty_fold(params.H, params.h, problem.D, rho, params.g)
    R = H[..., :-1, :nu, :nu]
    S = H[..., :-1, :nu, nu:]
    Q = H[..., :-1, nu:, nu:]
    r = h[..., :-1, :nu]
    q = h[..., :-1, nu:]

    # R~^{-1} applied to [S | r | B^T] through one batched Cholesky.
    LR = linalg.cholesky_unrolled(R)
    rhs = torch.cat([S, r[..., None], problem.B.mT], dim=-1)
    sol = linalg.chol_solve(LR, rhs)     # (N, nu, nx + 1 + nx)
    RiS, Rir, RiBT = sol[..., :nx], sol[..., nx], sol[..., nx + 1:]

    Ae = problem.A - problem.B @ RiS
    be = problem.c - _mv(problem.B, Rir)
    Ce = problem.B @ RiBT
    Je = Q - S.mT @ RiS
    ee = -(q - _mv(S.mT, Rir))

    zm = torch.zeros_like(Ae[..., :1, :, :])
    zv = torch.zeros_like(be[..., :1, :])
    cat = lambda a, b, dim: torch.cat([a, b], dim=dim)
    return (cat(Ae, zm, -3), cat(be, zv, -2), cat(Ce, zm, -3),
            cat(ee, -h[..., -1:, nu:], -2), cat(Je, H[..., -1:, nu:, nu:], -3))


def combine(e_early, e_late, solve=linalg.ge_solve_unrolled):
    """Associative composition of value elements (earlier, later);
    ``solve`` solves with (I + C1 J2) and its transpose (the JAX package
    picks a batched LU or its unrolled elimination; both are the batched
    LU here)."""
    A1, b1, C1, n1, J1 = e_early
    A2, b2, C2, n2, J2 = e_late
    nx = A1.shape[-1]
    eye = torch.eye(nx, dtype=A1.dtype, device=A1.device)

    IpCJ = eye + C1 @ J2
    # T X for X in [A1 | C1 | b1 + C1 eta2]; T = (I + C1 J2)^{-1}.
    rhs = torch.cat([A1, C1, (b1 + _mv(C1, n2))[..., None]], dim=-1)
    TX = solve(IpCJ, rhs)
    TA1, TC1, Tb = TX[..., :nx], TX[..., nx:2 * nx], TX[..., 2 * nx]

    # T^T Y for Y in [J2 A1 | eta2 - J2 b1]; T^T = (I + J2 C1)^{-1}.
    rhsT = torch.cat([J2 @ A1, (n2 - _mv(J2, b1))[..., None]], dim=-1)
    TTY = solve(IpCJ.mT, rhsT)
    TJ2A1, Tn = TTY[..., :nx], TTY[..., nx]

    A1T = A1.mT
    A3 = A2 @ TA1
    b3 = _mv(A2, Tb) + b2
    C3 = A2 @ TC1 @ A2.mT + C2
    n3 = _mv(A1T, Tn) + n1
    J3 = A1T @ TJ2A1 + J1
    # Symmetrize: C and J are symmetric by construction; the solves
    # break it at roundoff and the error compounds over log N levels.
    C3 = 0.5 * (C3 + C3.mT)
    J3 = 0.5 * (J3 + J3.mT)
    return A3, b3, C3, n3, J3


def _identity_elements(shape, nx: int, like):
    """Copies of the combine identity (A=I, b=0, C=0, eta=0, J=0) over the
    leading ``shape``."""
    eye = torch.eye(nx, dtype=like.dtype, device=like.device).expand(
        tuple(shape) + (nx, nx))
    zm = like.new_zeros(tuple(shape) + (nx, nx))
    zv = like.new_zeros(tuple(shape) + (nx,))
    return eye, zv, zm, zv, zm


# In-block length of the blocked suffix scan (the JAX package's value).
SCAN_BLOCK = 16

# Largest nx that takes the blocked scan (the JAX package's rule: past it
# the plain associative scan); kept so both packages combine the same
# elements in the same order.
UNROLL_NX_MAX = 20


def _suffix_scan_blocked(elems, block: int = SCAN_BLOCK):
    """Inclusive suffix combine of value elements in three phases:

      1. in-block suffix scan, ``block`` sequential steps batched across
         the N/block blocks;
      2. the associative scan over the N/block block aggregates;
      3. one batched fix-up combining every in-block suffix with the
         aggregate of all later blocks.

    Depth ~ block + 2 log2(N/block).
    """
    rev_combine = lambda a, b: combine(b, a)
    N1, nx = elems[0].shape[-3], elems[0].shape[-1]
    if N1 <= block or nx > UNROLL_NX_MAX:
        return associative_scan(rev_combine, elems, reverse=True)
    front, nd = _to_front(elems)
    batch = front[0].shape[1:-2]
    nb = -(-N1 // block)
    pad = nb * block - N1
    if pad:
        ident = _identity_elements((pad,) + tuple(batch), nx, front[0])
        front = tuple(torch.cat([e, i], dim=0) for e, i in zip(front, ident))
    # (nb, block, ...): block position on dim 1.
    blocked = tuple(e.reshape((nb, block) + e.shape[1:]) for e in front)

    # Phase 1: suffix within each block (carry = suffix of the later
    # stages in the block).
    carry = _identity_elements((nb,) + tuple(batch), nx, front[0])
    suffixes = [None] * block
    for j in range(block - 1, -1, -1):
        carry = combine(tuple(e[:, j] for e in blocked), carry,
                        solve=linalg.ge_solve_unrolled)
        suffixes[j] = carry
    suffixes = tuple(torch.stack([s[i] for s in suffixes], dim=1)
                     for i in range(5))                # (nb, block, ...)

    # Phase 2: aggregates = in-block suffix at position 0; exclusive
    # suffix over blocks (aggregate of strictly later blocks).
    aggs = _to_back(tuple(s[:, 0] for s in suffixes), nd)
    agg_suf, _ = _to_front(associative_scan(rev_combine, aggs, reverse=True))
    right = tuple(torch.cat([a[1:], i], dim=0) for a, i in zip(
        agg_suf, _identity_elements((1,) + tuple(batch), nx, front[0])))

    # Phase 3: one batched fix-up across all (nb, block) positions.
    right_b = tuple(r[:, None].expand(s.shape) for r, s in zip(right, suffixes))
    full = combine(suffixes, right_b, solve=linalg.ge_solve_unrolled)
    out = tuple(f.reshape((nb * block,) + f.shape[2:])[:N1] for f in full)
    return _to_back(out, nd)


def cost_to_go(problem: LQRProblem, params: StageParams, rho):
    """All cost-to-go pairs (P_k, p_k), k = 0..N, in near-log depth."""
    with full_f32_matmul():
        elems = leaf_elements(problem, params, rho)
        _, _, _, eta, J = _suffix_scan_blocked(elems)
    return J, -eta


def backward(problem: LQRProblem, params: StageParams, rho) -> riccati.RiccatiFactors:
    """Log-depth backward pass producing sequential-layout factors.

    The scan yields (P_{k+1}, p_{k+1}) for every k at once; the stage
    factors of lqr_kernel.hpp:103-147 are then recovered with one batched
    Cholesky over all stages:

      M_k  = H~_k + E_k^T P_{k+1} E_k,  L_k = chol(M_k)
      lp_k = h~_k + E_k^T (P_{k+1} c_k + p_{k+1});  lu forward-solved.
    """
    nu = problem.nu
    P, p = cost_to_go(problem, params, rho)
    P_next, p_next = P[..., 1:, :, :], p[..., 1:, :]
    with full_f32_matmul():
        H, h = riccati.penalty_fold(params.H, params.h, problem.D, rho,
                                    params.g)
        E = torch.cat([problem.B, problem.A], dim=-1)
        ET = E.mT
        L = linalg.cholesky_unrolled(H[..., :-1, :, :] + ET @ P_next @ E)
        Pb = _mv(P_next, problem.c) + p_next
        lp = h[..., :-1, :] + _mv(ET, Pb)
        lu = linalg.solve_lower(L[..., :nu, :nu],
                                         lp[..., :nu, None])[..., 0]
        pv = lp[..., nu:] - _mv(L[..., nu:, :nu], lu)
        LxxN = linalg.cholesky_unrolled(H[..., -1, nu:, nu:])
    return riccati.RiccatiFactors(L=L, lp=torch.cat([lu, pv], dim=-1),
                                  LxxN=LxxN, pN=h[..., -1, nu:])


def forward(problem: LQRProblem, factors: riccati.RiccatiFactors, x0):
    """Log-depth forward rollout as a prefix scan over affine maps.

    From the cached factors: u_k = K_k x_k + d_k with
    K = -Luu^{-T} Lxu^T, d = -Luu^{-T} lu, so
    x_{k+1} = (A + B K) x_k + (B d + c), composed by an associative prefix
    scan, then u recovered for all stages at once.  Same output layout as
    ``riccati.forward`` (ws rows [u_k; x_k], terminal u = 0).
    """
    nu = problem.nu
    L, lp = factors.L, factors.lp
    Luu, Lxu, lu = L[..., :nu, :nu], L[..., nu:, :nu], lp[..., :nu]
    with full_f32_matmul():
        K = linalg.solve_lower_T(Luu, -Lxu.mT)
        d = linalg.solve_lower_T(Luu, -lu[..., None])[..., 0]
        M = problem.A + problem.B @ K
        v = _mv(problem.B, d) + problem.c

        def comp(a, b):
            M1, v1 = a
            M2, v2 = b
            return M2 @ M1, _mv(M2, v1) + v2

        Mc, vc = associative_scan(comp, (M, v))
        xs_next = _mv(Mc, x0[..., None, :]) + vc               # x_1..x_N
        xs = torch.cat([x0[..., None, :], xs_next[..., :-1, :]], dim=-2)
        us = _mv(K, xs) + d
    ws = torch.cat([us, xs], dim=-1)
    wN = torch.cat([torch.zeros_like(us[..., -1, :]), xs_next[..., -1, :]],
                   dim=-1)
    return torch.cat([ws, wN[..., None, :]], dim=-2)


def backward_no_refactor(problem: LQRProblem, params: StageParams, rho,
                         factors: riccati.RiccatiFactors) -> riccati.RiccatiFactors:
    """Log-depth vector-only backward with cached factors.

    The p-recursion p_k = (A + B K_k)^T p_{k+1} + w_k is affine with
    per-stage coefficients computable from the cached L for all stages
    at once, so a suffix associative scan over (M, v) = ((A+BK)^T, w)
    redoes only O(nx^2) work a combine — the log-depth analog of
    lqr_solver.hpp:65-70 (K = -Luu^{-T} Lxu^T, P_{k+1} = Lxx_{k+1}
    Lxx_{k+1}^T).
    """
    nu = problem.nu
    L = factors.L
    Luu, Lxu = L[..., :nu, :nu], L[..., nu:, :nu]
    with full_f32_matmul():
        h = riccati.penalty_fold_vec(params.h, problem.D, rho, params.g)
        Lxx_next = factors.Lxx_next
        Pc = _mv(Lxx_next, _mv(Lxx_next.mT, problem.c))
        K = linalg.solve_lower_T(Luu, -Lxu.mT)
        ET = torch.cat([problem.B, problem.A], dim=-1).mT
        # Stationary parts of lp given p_{k+1} = 0:
        lp0 = h[..., :-1, :] + _mv(ET, Pc)
        lu0 = linalg.solve_lower(Luu, lp0[..., :nu, None])[..., 0]
        w = lp0[..., nu:] - _mv(Lxu, lu0)
        MT = (problem.A + problem.B @ K).mT

        def comp(a, b):
            # Suffix composition p_k = MT_k p_{k+1} + w_k: (earlier, later)
            # composes as p = MT1 (MT2 p + w2) + w1.
            M1, v1 = a
            M2, v2 = b
            return M1 @ M2, _mv(M1, v2) + v1

        pN = h[..., -1, nu:]
        Mc, vc = associative_scan(lambda a, b: comp(b, a), (MT, w),
                                  reverse=True)
        p = _mv(Mc, pN[..., None, :]) + vc          # p_k for k = 0..N-1

        # Recover lp with the true p_{k+1}.
        p_next = torch.cat([p[..., 1:, :], pN[..., None, :]], dim=-2)
        lp = h[..., :-1, :] + _mv(ET, Pc + p_next)
        lu = linalg.solve_lower(Luu, lp[..., :nu, None])[..., 0]
        pv = lp[..., nu:] - _mv(Lxu, lu)
    return riccati.RiccatiFactors(L=L, lp=torch.cat([lu, pv], dim=-1),
                                  LxxN=factors.LxxN, pN=pN)
