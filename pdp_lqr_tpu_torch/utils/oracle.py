"""CPU oracles for parity testing (NumPy / SciPy, float64) — a copy of
``pdp_lqr_tpu/utils/oracle.py`` for the port.

The port's problems hold tensors (on the card or the CPU); every array the
oracles read goes through ``_np``, which copies a tensor to a float64 numpy
array, so the functions take the port's dataclasses as they are.

Two independent witnesses:

1. ``riccati_numpy`` — a plain-NumPy transcription of the reference's
   stage equations (lqr_kernel.hpp:79-212, lqr_solver.hpp:41-77),
   verifying the solvers stage-for-stage.

2. ``solve_kkt_dense`` — assembles the full-horizon equality-constrained
   QP KKT system densely and solves it with numpy.linalg.solve.  This
   mirrors what the reference's QDLDL path computes
   (kkt.hpp:124-300, qdldl_solver.hpp:88-151) but shares *no* structure
   with the Riccati recursion, making agreement a genuine cross-check
   (the reference uses its example binary the same way,
   lqr_example.cpp:174-221).
"""

from __future__ import annotations

import numpy as np


def _np(x):
    """A tensor (any device) or array as a float64 numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _penalized(problem, it, sigma):
    """sigma-regularized, penalty-folded stage data as NumPy arrays.

    Implements update_problem_data (lqr_solver.hpp:41-56) + the penalty
    fold (lqr_kernel.hpp:106-112) in one place.
    Returns (Ht, ht) lists over stages 0..N (terminal entry uses only
    the x-block), where Ht = H + sigma I + D^T rho D and
    ht = h - sigma w - D^T (rho o g), g = z - y/rho.
    """
    A = _np(problem.A)
    N, nx = A.shape[0], A.shape[-1]
    nu = problem.B.shape[-1]
    H = _np(problem.H).copy()
    h = _np(problem.h).copy()
    D = _np(problem.D)
    w = _np(it.w)
    y = _np(it.y)
    z = _np(it.z)
    rho = _np(it.rho)

    Hts, hts = [], []
    for k in range(N + 1):
        Hk = H[k] + sigma * np.eye(H.shape[-1])
        hk = h[k] - sigma * w[k]
        if k == N:
            hk = hk.copy()
            hk[:nu] = 0.0
            Hk = Hk.copy()
        if D.shape[1] > 0:
            rk = rho[k]
            inv_r = np.where(rk > 0, 1.0 / np.where(rk > 0, rk, 1.0), 0.0)
            gk = z[k] - inv_r * y[k]
            Hk = Hk + D[k].T @ (rk[:, None] * D[k])
            hk = hk - D[k].T @ (rk * gk)
        Hts.append(Hk)
        hts.append(hk)
    return Hts, hts


def riccati_numpy(problem, it, sigma, x0):
    """Sequential Riccati backward + forward, straight NumPy.

    Equations follow lqr_kernel.hpp:103-147 (backward step, with the
    value function in Cholesky-factored form) and :180-204 (forward).
    Returns ws (N+1, nz).
    """
    import scipy.linalg as sla

    A = _np(problem.A)
    B = _np(problem.B)
    c = _np(problem.c)
    N, nx = A.shape[0], A.shape[-1]
    nu = B.shape[-1]
    Hts, hts = _penalized(problem, it, sigma)

    Ls = [None] * N
    lps = [None] * N
    Lxx = np.linalg.cholesky(Hts[N][nu:, nu:])
    p = hts[N][nu:]
    for k in range(N - 1, -1, -1):
        E = np.concatenate([B[k], A[k]], axis=1)
        V = E.T @ Lxx
        M = Hts[k] + V @ V.T
        L = np.linalg.cholesky(M)
        Pb = Lxx @ (Lxx.T @ c[k]) + p
        lp = hts[k] + E.T @ Pb
        lu = sla.solve_triangular(L[:nu, :nu], lp[:nu], lower=True)
        p = lp[nu:] - L[nu:, :nu] @ lu
        Ls[k] = L
        lps[k] = np.concatenate([lu, p])
        Lxx = L[nu:, nu:]

    ws = np.zeros((N + 1, nu + nx))
    x = _np(x0)
    for k in range(N):
        L = Ls[k]
        u = -(lps[k][:nu] + L[nu:, :nu].T @ x)
        u = sla.solve_triangular(L[:nu, :nu].T, u, lower=False)
        ws[k] = np.concatenate([u, x])
        x = A[k] @ x + B[k] @ u + c[k]
    ws[N, nu:] = x
    return ws


def solve_constrained_qp(problem, x0, cones=(), tol=1e-10, maxiter=3000,
                         soc_shift=None):
    """Constrained conic LQ oracle via scipy trust-constr (independent
    witness for the ADMM outer loop — the reference has no counterpart,
    its outer loop being unreleased, README.md:8).

    Single-shooting parameterization: decision variables are the
    stacked controls; states are eliminated through the rollout, so
    dynamics are exact by construction.  Box rows become a
    LinearConstraint, cone specs (offset, dim) become nonlinear
    constraints t - ||v|| >= 0.  Suitable for small N only.

    Returns ws (N+1, nz).
    """
    import scipy.optimize as sopt

    A = _np(problem.A)
    B = _np(problem.B)
    c = _np(problem.c)
    H = _np(problem.H)
    h = _np(problem.h)
    D = _np(problem.D)
    e_lb = _np(problem.e_lb)
    e_ub = _np(problem.e_ub)
    N, nx = A.shape[0], A.shape[-1]
    nu = B.shape[-1]
    nz = nx + nu
    nU = N * nu
    x0 = _np(x0)

    # x_k = phi[k] + Gam[k] @ U  (affine in stacked controls U).
    phi = np.zeros((N + 1, nx))
    Gam = np.zeros((N + 1, nx, nU))
    phi[0] = x0
    for k in range(N):
        phi[k + 1] = A[k] @ phi[k] + c[k]
        Gam[k + 1] = A[k] @ Gam[k]
        Gam[k + 1][:, k * nu : (k + 1) * nu] += B[k]

    # w_k = [u_k; x_k] = wb[k] + Wm[k] @ U.
    wb = np.zeros((N + 1, nz))
    Wm = np.zeros((N + 1, nz, nU))
    for k in range(N + 1):
        wb[k, nu:] = phi[k]
        Wm[k, nu:, :] = Gam[k]
        if k < N:
            Wm[k, :nu, k * nu : (k + 1) * nu] = np.eye(nu)

    # Quadratic cost in U: 1/2 U^T P U + q^T U (+ const).
    P = np.zeros((nU, nU))
    qv = np.zeros(nU)
    for k in range(N + 1):
        HW = H[k] @ Wm[k]
        P += Wm[k].T @ HW
        qv += Wm[k].T @ (H[k] @ wb[k] + h[k])
    P = 0.5 * (P + P.T)

    fun = lambda U: 0.5 * U @ P @ U + qv @ U
    jac = lambda U: P @ U + qv

    from pdp_lqr_tpu_torch.ops.projections import normalize_cones

    constraints = []
    nc = D.shape[1]
    cones3 = normalize_cones(cones)
    cone_rows = set()
    for off, dim, _ in cones3:
        cone_rows.update(range(off, off + dim))
    if nc > 0:
        # Stack all finite box rows as one LinearConstraint.
        rows, lbs, ubs = [], [], []
        for k in range(N + 1):
            for i in range(nc):
                if i in cone_rows:
                    continue
                if not np.any(D[k, i] != 0):
                    continue
                rows.append(D[k, i] @ Wm[k])
                lbs.append(e_lb[k, i] - D[k, i] @ wb[k])
                ubs.append(e_ub[k, i] - D[k, i] @ wb[k])
        if rows:
            constraints.append(sopt.LinearConstraint(
                np.stack(rows), np.array(lbs), np.array(ubs)
            ))
        shift = (np.zeros((N + 1, nc)) if soc_shift is None
                 else _np(soc_shift))
        for off, dim, kind in cones3:
            for k in range(N + 1):
                if not np.any(D[k, off : off + dim] != 0):
                    continue
                Dk = D[k, off : off + dim]
                bk = Dk @ wb[k] + shift[k, off : off + dim]
                Mk = Dk @ Wm[k]

                if kind == "soc":
                    # Smooth squared form t^2 - ||v||^2 >= 0 with the
                    # linear half-space t >= 0 (equivalent feasible
                    # set): t - ||v|| is nondifferentiable at the cone
                    # vertex, exactly where grazing solutions land
                    # (e.g. rocket touchdown at the glideslope apex),
                    # and trust-constr stalls on it.
                    def cone_fun(U, Mk=Mk, bk=bk):
                        v = Mk @ U + bk
                        return v[0] * v[0] - v[1:] @ v[1:]

                    def cone_jac(U, Mk=Mk, bk=bk):
                        v = Mk @ U + bk
                        g = np.concatenate(([2.0 * v[0]], -2.0 * v[1:]))
                        return (g @ Mk)[None, :]

                    constraints.append(sopt.NonlinearConstraint(
                        cone_fun, 0.0, np.inf, jac=cone_jac
                    ))
                    constraints.append(sopt.LinearConstraint(
                        Mk[0][None, :], -bk[0], np.inf
                    ))
                else:  # rsoc: 2 p q >= ||x||^2, p >= 0, q >= 0
                    def rsoc_fun(U, Mk=Mk, bk=bk):
                        v = Mk @ U + bk
                        return np.array([
                            2.0 * v[0] * v[1] - v[2:] @ v[2:], v[0], v[1],
                        ])

                    constraints.append(sopt.NonlinearConstraint(
                        rsoc_fun, 0.0, np.inf
                    ))

    res = sopt.minimize(
        fun, np.zeros(nU), jac=jac, method="trust-constr",
        constraints=constraints,
        options={"gtol": tol, "xtol": tol, "maxiter": maxiter},
    )
    U = res.x
    ws = wb + np.einsum("kzu,u->kz", Wm, U)
    ws[N, :nu] = 0.0
    return ws


def solve_kkt_dense(problem, it, sigma, x0, rho_dyn: float = 0.0):
    """Dense full-horizon KKT solve (independent witness).

    Variables: [u0, x1, u1, ..., x_{N-1}, u_{N-1}, xN] (x0 is data),
    the reference's primal ordering (qdldl_solver.hpp:129-140).
    Dynamics equalities carry optional -rho_dyn regularization matching
    the reference's QDLDL KKT (kkt.hpp:198-199; default 0 = exact).
    Returns ws (N+1, nz).
    """
    A = _np(problem.A)
    B = _np(problem.B)
    c = _np(problem.c)
    N, nx = A.shape[0], A.shape[-1]
    nu = B.shape[-1]
    nz = nx + nu
    Hts, hts = _penalized(problem, it, sigma)

    nw = nu + (N - 1) * nz + nx  # primal vars
    nd = N * nx                  # dynamics duals
    x0 = _np(x0)

    def u_off(k):
        return 0 if k == 0 else nu + (k - 1) * nz + nx

    def x_off(k):
        assert k >= 1
        return nu + (k - 1) * nz

    Hbig = np.zeros((nw, nw))
    hbig = np.zeros(nw)
    # Stage 0: [u0; x0] with x0 fixed.
    Hbig[:nu, :nu] = Hts[0][:nu, :nu]
    hbig[:nu] = hts[0][:nu] + Hts[0][:nu, nu:] @ x0
    for k in range(1, N):
        iu, ix = u_off(k), x_off(k)
        Hbig[iu : iu + nu, iu : iu + nu] = Hts[k][:nu, :nu]
        Hbig[ix : ix + nx, ix : ix + nx] = Hts[k][nu:, nu:]
        Hbig[iu : iu + nu, ix : ix + nx] = Hts[k][:nu, nu:]
        Hbig[ix : ix + nx, iu : iu + nu] = Hts[k][nu:, :nu]
        hbig[iu : iu + nu] = hts[k][:nu]
        hbig[ix : ix + nx] = hts[k][nu:]
    ixN = nu + (N - 1) * nz
    Hbig[ixN:, ixN:] = Hts[N][nu:, nu:]
    hbig[ixN:] = hts[N][nu:]

    G = np.zeros((nd, nw))
    rd = np.zeros(nd)
    for k in range(N):
        rows = slice(k * nx, (k + 1) * nx)
        # x_{k+1} - A x_k - B u_k = c_k
        if k == N - 1:
            G[rows, ixN:] = np.eye(nx)
        else:
            G[rows, x_off(k + 1) : x_off(k + 1) + nx] = np.eye(nx)
        iu = u_off(k)
        G[rows, iu : iu + nu] = -B[k]
        if k >= 1:
            ix = x_off(k)
            G[rows, ix : ix + nx] = -A[k]
            rd[rows] = c[k]
        else:
            rd[rows] = c[0] + A[0] @ x0

    K = np.block([
        [Hbig, G.T],
        [G, -rho_dyn * np.eye(nd)],
    ])
    rhs = np.concatenate([-hbig, rd])
    sol = np.linalg.solve(K, rhs)

    ws = np.zeros((N + 1, nz))
    ws[0, :nu] = sol[:nu]
    ws[0, nu:] = x0
    for k in range(1, N):
        ws[k, nu:] = sol[x_off(k) : x_off(k) + nx]
        ws[k, :nu] = sol[u_off(k) : u_off(k) + nu]
    ws[N, nu:] = sol[ixN : ixN + nx]
    return ws
