"""Real-time single-instance conic MPC — the 1 kHz replan path (PyTorch
port of ``pdp_lqr_tpu/solvers/realtime.py``).

The reference's steady-state fast path re-solves with cached factors
every ADMM iteration (``backward_without_factorization``,
lqr_solver.hpp:65-70): with (H~, rho) fixed, only *vector* work runs.
With the factorization fixed, the inner KKT solve is a *fixed affine map*
of the iteration-varying folded cost vector hf and the initial state:

    w~  =  hf_flat @ T  +  x0 @ J  +  r          (all dense)

so (T, J, r) are materialized ONCE per factorization by pushing basis
vectors through the cached-factor vector solve (``ops.riccati_dense``,
one call with the basis on a leading batch axis against one shared factor
cache), and every ADMM iteration is ONE dense (M, M) matvec
(M = (N+1) nz, 1040 for the quadrotor at N = 64) plus elementwise
projection / dual work.  The replan loop is a host loop with the JAX
``while_loop``'s exit test: it reads the convergence flag back once an
iteration (counted in ``admm.HOST_READS["early_exit"]``) and runs exactly
the JAX function's iteration count.

Forms: the dense map (``ResolveOperator``); the segment-factored map of
the paper's decomposition for long horizons (``CondensedOperator``); the
map of a shared-structure scenario batch (``BatchResolveOperator``,
``solve_batch``: exactly ``max_iter`` iterations, no host read); a stack
of maps at a rho grid (``OperatorLadder``) for adaptive rho between
ticks; ``cast_operator`` narrows a map's storage (bfloat16 serving mode).

Every product here runs in full float32 (``config.full_f32_matmul``): a
TF32 matmul would move the fixed point by about 1e-3.

Memory: T is M^2 floats — 4.3 MB (f32) at N = 64, 69 MB at N = 256, 3.8
GB for the centroidal model at N = 1024 (use the condensed form there).

Accuracy: T is the exact linear map of the cached-factor solve evaluated
on basis vectors, so the iteration math is identical to ``admm.solve``
with ``rho_update_interval >= max_iter`` up to matmul reassociation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from pdp_lqr_tpu_torch.config import full_f32_matmul
from pdp_lqr_tpu_torch.ops import linalg, projections, riccati_dense
from pdp_lqr_tpu_torch.problem import LQRProblem, StageParams, _TensorRecord
from pdp_lqr_tpu_torch.solvers import admm
from pdp_lqr_tpu_torch.solvers.admm import (
    ADMMInfo,
    ADMMSettings,
    ADMMState,
    _con_mask,
    init_state,
)


def _mm(a, W):
    """a @ W with W's storage widened to a's dtype where it is narrower
    (a bfloat16-stored map: float32 accumulation on a float32 copy, made
    for this product)."""
    return a @ (W if W.dtype == a.dtype else W.to(a.dtype))


@dataclasses.dataclass(frozen=True)
class ResolveOperator(_TensorRecord):
    """Materialized affine inner-solve: w~ = hf @ T + x0 @ J + r.

    T: (M, M) with M = (N+1) nz — linear response to the folded cost
       vector (rows index hf entries, columns index w entries).
    J: (nx, M) — response to the initial state.
    r: (M,)   — constant part (the drift c's contribution).
    rho: ()   — scalar penalty the factorization was built at (for
       caller-side staleness checks; the map itself embeds it).
    """

    T: torch.Tensor
    J: torch.Tensor
    r: torch.Tensor
    rho: torch.Tensor

    # Operator protocol (shared with CondensedOperator): prepare(x0)
    # once per replan, apply_flat(hf_flat, prepared) per ADMM iteration.
    def prepare(self, x0):
        return _mm(x0, self.J) + self.r

    def apply_flat(self, hf_flat, prepared):
        return _mm(hf_flat, self.T) + prepared


def _factor(problem: LQRProblem, rho, settings: ADMMSettings, cones):
    """The factor cache every map is built on: one P-form backward at
    (H + sigma I, rho on the active rows).  Returns (params, rho_vec,
    factors)."""
    dt, dev = problem.H.dtype, problem.H.device
    mask = _con_mask(problem, tuple(cones)).to(dt)
    rho_vec = torch.as_tensor(rho, dtype=dt, device=dev) * mask
    eye_z = torch.eye(problem.nz, dtype=dt, device=dev)
    params = StageParams(H=problem.H + settings.sigma * eye_z,
                         h=torch.zeros_like(problem.h),
                         g=torch.zeros_like(problem.e_lb))
    return params, rho_vec, riccati_dense.backward(problem, params, rho_vec)


def _push(problem, params, rho_vec, factors, h, x0, c):
    """The cached-factor solve on a leading batch axis of inputs: h
    (Bp, N+1, nz), x0 (Bp, nx), c (Bp, N, nx) against the one factor
    cache.  Returns ws (Bp, N+1, nz)."""
    prob = dataclasses.replace(problem, c=c)
    prm = StageParams(H=params.H, h=h, g=params.g)
    f2 = riccati_dense.backward_no_refactor(prob, prm, rho_vec, factors)
    return riccati_dense.forward(prob, f2, x0)


def _eye_rows(n, shape, dt, dev):
    """The n basis vectors, each reshaped to ``shape``: (n, *shape)."""
    return torch.eye(n, dtype=dt, device=dev).reshape((n,) + tuple(shape))


def build_operator(
    problem: LQRProblem,
    rho: float,
    settings: ADMMSettings = ADMMSettings(),
    cones: Sequence[projections.ConeSpec] = (),
) -> ResolveOperator:
    """Factor once, then materialize the affine solve map.

    One P-form backward (riccati_dense.backward) builds the factor cache;
    M + nx + 1 cached-factor vector solves — one batched call — evaluate
    the map on the hf basis, the x0 basis, and zero (with the problem's
    drift).  Rebuild whenever rho (or the problem matrices) change;
    between rebuilds every replan and every ADMM iteration reuses
    (T, J, r).
    """
    dt, dev = problem.H.dtype, problem.H.device
    N, nz, nx = problem.N, problem.nz, problem.nx
    M = (N + 1) * nz
    with full_f32_matmul():
        params, rho_vec, factors = _factor(problem, rho, settings, cones)
        # Rows: the hf basis (M), the x0 basis (nx), then the zero input
        # with the problem's c.  The basis rows run at c = 0, so their
        # outputs ARE the linear columns.
        h = torch.cat([_eye_rows(M, (N + 1, nz), dt, dev),
                       torch.zeros((nx + 1, N + 1, nz), dtype=dt, device=dev)])
        x0 = torch.zeros((M + nx + 1, nx), dtype=dt, device=dev)
        x0[M:M + nx] = torch.eye(nx, dtype=dt, device=dev)
        c = torch.zeros((M + nx + 1, N, nx), dtype=dt, device=dev)
        c[-1] = problem.c
        ws = _push(problem, params, rho_vec, factors, h, x0, c)
    return ResolveOperator(
        T=ws[:M].reshape(M, M), J=ws[M:M + nx].reshape(nx, M),
        r=ws[-1].reshape(M), rho=torch.as_tensor(rho, dtype=dt, device=dev))


@dataclasses.dataclass(frozen=True)
class CondensedOperator(_TensorRecord):
    """PDP-factored affine inner-solve — the long-horizon 1 kHz form.

    The dense (M, M) map T costs O(M^2) memory and bandwidth.  This
    operator factors T through the paper's segment decomposition (the
    reference's LQRParallelSolver structure, lqr_solver_parallel.hpp:
    142-238, recast as an OPERATOR): split the horizon into S segments of
    Ns stages.  Given the global Riccati cache, the solution inside
    segment s is affine in ONLY (hf^(s), x_start_s, p_end_s) — the
    segment-local folded cost rows, the state entering the segment, and
    the cost-to-go *vector* at its end boundary.  The 2 S nx boundary
    values are themselves affine in (hf, x0), composed at build time from
    per-segment chain maps.  Memory and bandwidth drop from M^2 to
    ~M^2/S + 2 M S nx (minimized at S ~ sqrt(M / 2nx)).

    Blocks (Ms = Ns*nz, out = Ms + nx; segment outputs are the segment's
    w rows plus its exit state, whose last instance is x_N):
      U (S, Ms, out)   response to segment-local hf rows
      X (S, nx, out)   response to the segment entry state
      Z (S, nx, out)   response to the boundary cost-to-go vector
      r (S, out)       drift (c) constant
      E_x, E_p (S, M, nx)  boundary responses to the full hf
      Jx (S, nx, nx)       boundary response to x0
      cx, cp (S, nx)       boundary constants
    """

    U: torch.Tensor
    X: torch.Tensor
    Z: torch.Tensor
    r: torch.Tensor
    E_x: torch.Tensor
    E_p: torch.Tensor
    Jx: torch.Tensor
    cx: torch.Tensor
    cp: torch.Tensor
    rho: torch.Tensor

    def prepare(self, x0):
        """Per-replan constants: x0's boundary contribution."""
        return _mm(x0, self.Jx) + self.cx

    def apply_flat(self, hf_flat, prepared):
        S, Ms, _ = self.U.shape
        nx = self.X.shape[1]
        seg_h = hf_flat[:S * Ms].reshape(S, 1, Ms)
        x_start = _mm(hf_flat, self.E_x) + prepared          # (S, nx)
        p_end = _mm(hf_flat, self.E_p) + self.cp
        seg_out = (_mm(seg_h, self.U)[:, 0]
                   + _mm(x_start[:, None], self.X)[:, 0]
                   + _mm(p_end[:, None], self.Z)[:, 0]
                   + self.r)
        w_stages = seg_out[:, :Ms].reshape(-1)
        xN = seg_out[-1, Ms:]
        nu = hf_flat.shape[0] - S * Ms - nx  # terminal row = [0_u; xN]
        return torch.cat([w_stages, w_stages.new_zeros(nu), xN])


def build_condensed_operator(
    problem: LQRProblem,
    rho: float,
    num_segments: int,
    settings: ADMMSettings = ADMMSettings(),
    cones: Sequence[projections.ConeSpec] = (),
) -> CondensedOperator:
    """Factor once, materialize the SEGMENT-FACTORED solve map.

    One global P-form backward builds the factor cache; per-segment basis
    pushes of length Ns — every segment and basis vector in one batched
    sweep — materialize the local maps, and a composition over the
    segments (a Python loop, as in JAX) produces the boundary responses.
    Exactly the same affine map as ``build_operator`` up to float
    reassociation.
    """
    dt, dev = problem.H.dtype, problem.H.device
    N, nz, nx, nu = problem.N, problem.nz, problem.nx, problem.nu
    S = int(num_segments)
    if S <= 0 or N % S != 0:
        raise ValueError(f"num_segments {S} must divide N {N}")
    Ns = N // S
    Ms = Ns * nz
    M = (N + 1) * nz
    zeros = lambda *s: torch.zeros(s, dtype=dt, device=dev)
    eye = lambda n: torch.eye(n, dtype=dt, device=dev)
    with full_f32_matmul():
        _, _, factors = _factor(problem, rho, settings, cones)
        # Segment-stacked stage data / cached factors: (S, Ns, ...).
        seg = lambda x: x.reshape((S, Ns) + tuple(x.shape[1:]))
        A_s, B_s, c_s = seg(problem.A), seg(problem.B), seg(problem.c)
        K_s, Lh_s = seg(factors.K), seg(factors.Lhuu)
        Pn_s = seg(factors.P[1:])           # P_{k+1} per stage

        # One batch of nb inputs a segment: the Ms hf rows (U), the nx
        # boundary cost-to-go vectors (Z), the nx entry states (X), and
        # the zero input with the segment's drift (r).  Only the last row
        # sees c, so the basis rows' outputs ARE the linear responses.
        nb = Ms + 2 * nx + 1
        h = torch.cat([_eye_rows(Ms, (Ns, nz), dt, dev),
                       zeros(2 * nx + 1, Ns, nz)])          # (nb, Ns, nz)
        p = zeros(nb, nx)
        p[Ms:Ms + nx] = eye(nx)
        x = zeros(nb, nx)
        x[Ms + nx:Ms + 2 * nx] = eye(nx)
        cflag = zeros(nb, 1)
        cflag[-1] = 1.0
        p, x = p.expand(S, nb, nx), x.expand(S, nb, nx)

        # Products as (S, nb, n) @ (S, n, m): one batched product a
        # segment, the matrices never expanded over the basis.
        # Backward, the boundary vector as the carry seed:
        #   Pcp = P+ c + p+,  rbar = r + B^T Pcp,  d = -Huu^{-1} rbar,
        #   p = q + A^T Pcp + K^T rbar.
        ds = [None] * Ns
        for j in range(Ns - 1, -1, -1):
            c = c_s[:, j, None, :] * cflag                  # (S, nb, nx)
            Pcp = c @ Pn_s[:, j].mT + p
            rbar = h[:, j, :nu] + Pcp @ B_s[:, j]
            ds[j] = -linalg.chol_solve(Lh_s[:, j], rbar.mT).mT
            p = h[:, j, nu:] + Pcp @ A_s[:, j] + rbar @ K_s[:, j]
        p_start = p
        rows = []
        for j in range(Ns):
            u = x @ K_s[:, j].mT + ds[j]
            rows.append(torch.cat([u, x], dim=-1))
            x = x @ A_s[:, j].mT + u @ B_s[:, j].mT + c_s[:, j, None, :] * cflag
        wrows = torch.stack(rows, dim=2)                    # (S, nb, Ns, nz)
        x_end = x
        del rows

        Z_, X_, R_ = Ms, Ms + nx, Ms + 2 * nx
        Ux, Up = x_end[:, :Ms], p_start[:, :Ms]            # (S, Ms, nx)
        Zx, Gp = x_end[:, Z_:X_], p_start[:, Z_:X_]        # (S, nx, nx)
        Xx = x_end[:, X_:R_]
        rx, rp = x_end[:, R_], p_start[:, R_]              # (S, nx)
        U = torch.cat([wrows[:, :Ms].reshape(S, Ms, Ms), Ux], dim=-1)
        Z = torch.cat([wrows[:, Z_:X_].reshape(S, nx, Ms), Zx], dim=-1)
        X = torch.cat([wrows[:, X_:R_].reshape(S, nx, Ms), Xx], dim=-1)
        r_op = torch.cat([wrows[:, R_].reshape(S, Ms), rx], dim=-1)
        del wrows

        # ---- boundary chains (S is a Python int) ----
        # p_end_{S-1} = hf_N x-rows (the iterate-folded terminal pN).
        Pe, ce = [None] * S, [None] * S
        Pe[S - 1] = zeros(M, nx)
        Pe[S - 1][N * nz + nu:N * nz + nz] = eye(nx)
        ce[S - 1] = zeros(nx)
        for s in range(S - 1, 0, -1):
            # p_end_{s-1} = p_start_s = hf^(s) Up_s + p_end_s Gp_s + rp_s
            prev = Pe[s] @ Gp[s]
            prev[s * Ms:(s + 1) * Ms] += Up[s]
            Pe[s - 1] = prev
            ce[s - 1] = ce[s] @ Gp[s] + rp[s]

        Xs, Jx, cx = [None] * S, [None] * S, [None] * S
        Xs[0], Jx[0], cx[0] = zeros(M, nx), eye(nx), zeros(nx)
        for s in range(S - 1):
            # x_start_{s+1} = x_end_s
            #   = hf^(s) Ux_s + x_start_s Xx_s + p_end_s Zx_s + rx_s
            nxt = Xs[s] @ Xx[s] + Pe[s] @ Zx[s]
            nxt[s * Ms:(s + 1) * Ms] += Ux[s]
            Xs[s + 1] = nxt
            Jx[s + 1] = Jx[s] @ Xx[s]
            cx[s + 1] = cx[s] @ Xx[s] + ce[s] @ Zx[s] + rx[s]

    return CondensedOperator(
        U=U, X=X, Z=Z, r=r_op,
        E_x=torch.stack(Xs), E_p=torch.stack(Pe),
        Jx=torch.stack(Jx), cx=torch.stack(cx), cp=torch.stack(ce),
        rho=torch.as_tensor(rho, dtype=dt, device=dev),
    )


def _uterm(N, nz, nu, dt, dev):
    """(N+1, nz) ones with the terminal u-entries 0 (make_stage_params'
    masking of h~)."""
    u = torch.ones((N + 1, nz), dtype=dt, device=dev)
    u[-1, :nu] = 0.0
    return u


def _step(problem: LQRProblem, operator, cones, settings: ADMMSettings,
          soc_shift):
    """One ADMM iteration of a replan on ``operator``, as a function
    (w, z, y, base) -> (w, z, y, converged, r_prim, r_dual) of tensors
    only (``base = operator.prepare(x0)``): no host read, nothing made on
    the host, so a CUDA graph can hold it.  Returns (step, rho)."""
    dt, dev = problem.H.dtype, problem.H.device
    N, nz, nu = problem.N, problem.nz, problem.nu
    M = (N + 1) * nz
    sigma, alpha = settings.sigma, settings.alpha
    mask = _con_mask(problem, cones).to(dt)
    rho = torch.as_tensor(operator.rho, dtype=dt, device=dev)
    rho_vec = rho * mask
    inv_rho = torch.where(mask > 0, 1.0 / rho, torch.zeros_like(mask))
    uterm = _uterm(N, nz, nu, dt, dev)
    h_masked = problem.h * uterm
    D, H = problem.D, problem.H
    Dw = lambda w: torch.einsum("kcz,kz->kc", D, w)
    DTv = lambda v: torch.einsum("kcz,kc->kz", D, v)
    Hw = lambda w: torch.einsum("kij,kj->ki", H, w)
    h_scale = problem.h.abs().max()
    amax = lambda t: t.abs().max()

    def step(w, z, y, base):
        g = z - inv_rho * y
        hf = (h_masked - sigma * w - DTv(rho_vec * g)) * uterm
        w_t = operator.apply_flat(hf.reshape(M), base).reshape(N + 1, nz)
        z_t = Dw(w_t)

        w_new = alpha * w_t + (1.0 - alpha) * w
        relaxed = alpha * z_t + (1.0 - alpha) * z
        z_new = projections.project_constraints(
            relaxed + inv_rho * y, problem.e_lb, problem.e_ub, cones,
            soc_shift) * mask
        y_new = y + rho_vec * (relaxed - z_new)

        Dw_new = Dw(w_new)
        r_prim = amax((Dw_new - z_new) * mask)
        dw = w - w_t
        dvec = ((1.0 - alpha) * Hw(dw) + sigma * dw
                + DTv(rho_vec * ((alpha - 1.0) * (z_t - z) + (z - z_new))))
        r_dual = amax(dvec)
        prim_scale = torch.maximum(amax(Dw_new * mask), amax(z_new))
        dual_scale = torch.maximum(
            amax(Hw(w_new)), torch.maximum(amax(DTv(y_new)), h_scale))
        conv = (r_prim <= settings.eps_abs + settings.eps_rel * prim_scale) \
            & (r_dual <= settings.eps_abs + settings.eps_rel * dual_scale)
        return w_new, z_new, y_new, conv, r_prim, r_dual

    return step, rho


def _run(settings: ADMMSettings, iterate):
    """The replan loop: ``iterate()`` runs one iteration and returns its
    convergence flag (a tensor); stop after the first iteration that
    converged or at ``max_iter`` (the JAX ``while_loop``'s exit test),
    reading the flag back once an iteration that may not be the last.
    Returns the iteration count."""
    k = 0
    while k < settings.max_iter:
        conv = iterate()
        k += 1
        if k < settings.max_iter:
            admm.HOST_READS["early_exit"] += 1
            if bool(conv):
                break
    return k


def _finish(k, w, z, y, rho, conv, r_prim, r_dual):
    iters = torch.full((), k, dtype=torch.int64, device=w.device)
    info = ADMMInfo(iterations=iters, r_prim=r_prim, r_dual=r_dual,
                    converged=conv, iter_converged=iters)
    return w, ADMMState(w=w, z=z, y=y, rho=rho), info


def solve(
    problem: LQRProblem,
    x0,
    operator,
    cones: Sequence[projections.ConeSpec] = (),
    settings: ADMMSettings = ADMMSettings(),
    state: Optional[ADMMState] = None,
    soc_shift=None,
) -> Tuple[torch.Tensor, ADMMState, ADMMInfo]:
    """One warm replan: ADMM with early exit, matvec inner solves.

    rho is FIXED at operator.rho for the whole replan (a rho change
    invalidates the map — rebuild with build_operator between replans, or
    use an OperatorLadder).  Exact OSQP 3.4 residuals drive the exit: the
    loop stops after the first iteration that meets the tolerances, or at
    ``max_iter``; the flag is read back once an iteration that may not be
    the last.  ``state.factors`` is never read (the operator is the
    factorization) and the returned state carries none.

    Returns (ws (N+1, nz), warm state, info).
    """
    dt, dev = problem.H.dtype, problem.H.device
    if state is None:
        state = init_state(problem, settings)
    with full_f32_matmul():
        step, rho = _step(problem, operator, tuple(cones), settings,
                          soc_shift)
        base = operator.prepare(torch.as_tensor(x0, dtype=dt, device=dev))
        inf = torch.full((), float("inf"), dtype=dt, device=dev)
        it = [state.w, state.z, state.y,
              torch.zeros((), dtype=torch.bool, device=dev), inf, inf]

        def iterate():
            it[:] = step(*it[:3], base)
            return it[3]

        k = _run(settings, iterate)
    return _finish(k, *it[:3], rho, *it[3:])


class _CapturedReplan:
    """A replan on the card whose iteration is one CUDA graph.

    The first call captures ``_step`` on static tensors (the iterates, the
    per-replan constant) with the new iterates copied back over the old at
    its end; each iteration is then one graph replay and one read of the
    flag, so the loop runs exactly ``solve``'s iterations with the same
    kernels in the same order.  Valid for the problem, operator, settings
    and shift it was made with (every replan of an MPC loop)."""

    def __init__(self, problem, operator, cones, settings, soc_shift):
        self.problem, self.operator = problem, operator
        self.settings = settings
        self.step, self.rho = _step(problem, operator, cones, settings,
                                    soc_shift)
        self.graph = None

    def _capture(self, state, base):
        self.w, self.z, self.y = (x.detach().clone()
                                  for x in (state.w, state.z, state.y))
        self.base = base.detach().clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):      # warm-up outside the capture
            self.step(self.w, self.z, self.y, self.base)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            w, z, y, self.conv, self.r_prim, self.r_dual = self.step(
                self.w, self.z, self.y, self.base)
            self.w.copy_(w)
            self.z.copy_(z)
            self.y.copy_(y)

    def __call__(self, x0, state=None):
        problem, st = self.problem, self.settings
        dt, dev = problem.H.dtype, problem.H.device
        if state is None:
            state = init_state(problem, st)
        with full_f32_matmul():
            base = self.operator.prepare(
                torch.as_tensor(x0, dtype=dt, device=dev))
            if self.graph is None:
                self._capture(state, base)
            for dst, src in ((self.w, state.w), (self.z, state.z),
                             (self.y, state.y), (self.base, base)):
                dst.copy_(src)

            def iterate():
                self.graph.replay()
                return self.conv

            k = _run(st, iterate)
        if k == 0:       # max_iter = 0: nothing ran
            inf = torch.full((), float("inf"), dtype=dt, device=dev)
            return _finish(0, state.w, state.z, state.y, self.rho,
                           torch.zeros((), dtype=torch.bool, device=dev),
                           inf, inf)
        return _finish(k, *(x.clone() for x in (
            self.w, self.z, self.y)), self.rho,
            *(x.clone() for x in (self.conv, self.r_prim, self.r_dual)))


@dataclasses.dataclass(frozen=True)
class BatchResolveOperator(_TensorRecord):
    """Affine inner-solve map for a SHARED-STRUCTURE scenario batch.

    Instances share (A, B, H, D, rho) — the factorization — while
    (c, x0, bounds, warm state) vary per instance:

        w~_b = hf_b @ T + c_b @ Tc + x0_b @ J

    T  (M, M):      response to the folded cost vector (M = (N+1) nz)
    Tc (N nx, M):   response to the stacked drift c
    J  (nx, M):     response to the initial state
    rho ():         scalar penalty baked into the factorization
    """

    T: torch.Tensor
    Tc: torch.Tensor
    J: torch.Tensor
    rho: torch.Tensor


def build_batch_operator(
    problem: LQRProblem,
    rho: float,
    settings: ADMMSettings = ADMMSettings(),
    cones: Sequence[projections.ConeSpec] = (),
) -> BatchResolveOperator:
    """Materialize (T, Tc, J) from ONE unbatched problem instance.

    ``problem`` supplies the shared structure; its ``c`` is ignored
    (drift enters per instance through Tc).  M + N nx + nx cached-factor
    vector solves in one batched call.
    """
    dt, dev = problem.H.dtype, problem.H.device
    N, nz, nx = problem.N, problem.nz, problem.nx
    M = (N + 1) * nz
    n_c = N * nx
    with full_f32_matmul():
        params, rho_vec, factors = _factor(problem, rho, settings, cones)
        zeros = lambda *s: torch.zeros(s, dtype=dt, device=dev)
        h = torch.cat([_eye_rows(M, (N + 1, nz), dt, dev),
                       zeros(n_c + nx, N + 1, nz)])
        c = torch.cat([zeros(M, N, nx), _eye_rows(n_c, (N, nx), dt, dev),
                       zeros(nx, N, nx)])
        x0 = zeros(M + n_c + nx, nx)
        x0[M + n_c:] = torch.eye(nx, dtype=dt, device=dev)
        ws = _push(problem, params, rho_vec, factors, h, x0, c)
    return BatchResolveOperator(
        T=ws[:M].reshape(M, M), Tc=ws[M:M + n_c].reshape(n_c, M),
        J=ws[M + n_c:].reshape(nx, M),
        rho=torch.as_tensor(rho, dtype=dt, device=dev))


def _shared(x):
    """One instance of a batch-leading tensor whose instances are one
    tensor broadcast (stride 0 on the batch axis): the same values
    without the batch copies.  Anything else is returned as it is."""
    return x[0] if x.ndim > 0 and x.shape[0] > 1 and x.stride(0) == 0 else x


def solve_batch(
    problem: LQRProblem,
    x0,
    operator: BatchResolveOperator,
    cones: Sequence[projections.ConeSpec] = (),
    settings: ADMMSettings = ADMMSettings(),
    state: Optional[ADMMState] = None,
    soc_shift=None,
):
    """Operator-mode batched conic ADMM — matmuls, no stage sweeps.

    ``problem`` is BATCHED (leading axis B); every instance must share the
    operator's (A, B, H, D) and rho — c, x0, bounds, and warm state vary
    freely (the scenario-MPC serving shape).  Per iteration the whole
    batch solves with one (B, M) @ (M, M) product; projections and duals
    are batched elementwise; runs exactly ``max_iter`` iterations (SIMD
    batch semantics, like admm.solve_fused) with per-instance convergence
    tracked in the returned info.  Nothing is read back to the host.

    Returns (ws (B, N+1, nz), ADMMState (batched), ADMMInfo (batched)).
    """
    cones = tuple(cones)
    dt, dev = problem.H.dtype, problem.H.device
    Bb = problem.h.shape[0]
    N, nz, nu, nx = problem.N, problem.nz, problem.nu, problem.nx
    M = (N + 1) * nz
    sigma, alpha = settings.sigma, settings.alpha
    with full_f32_matmul():
        mask = _con_mask(problem, cones).to(dt)          # (B, N+1, nc)
        rho = torch.as_tensor(operator.rho, dtype=dt, device=dev)
        rho_vec = rho * mask
        inv_rho = torch.where(mask > 0, 1.0 / rho, torch.zeros_like(mask))
        if state is None:
            state = ADMMState(
                w=torch.zeros(problem.h.shape, dtype=dt, device=dev),
                z=torch.zeros(problem.e_lb.shape, dtype=dt, device=dev),
                y=torch.zeros(problem.e_lb.shape, dtype=dt, device=dev),
                rho=torch.full((Bb,), float(rho), dtype=dt, device=dev))
        uterm = _uterm(N, nz, nu, dt, dev)
        h_masked = problem.h * uterm
        x0 = torch.as_tensor(x0, dtype=dt, device=dev)
        base = _mm(x0, operator.J) + _mm(problem.c.reshape(Bb, N * nx),
                                         operator.Tc)    # (B, M)
        D, H = _shared(problem.D), _shared(problem.H)
        Dw = lambda w: torch.einsum("...kcz,...kz->...kc", D, w)
        DTv = lambda v: torch.einsum("...kcz,...kc->...kz", D, v)
        Hw = lambda w: torch.einsum("...kij,...kj->...ki", H, w)
        amax = lambda x: x.abs().amax(dim=(1, 2))
        h_scale = amax(problem.h)
        shift = None if soc_shift is None \
            else torch.as_tensor(soc_shift, dtype=dt, device=dev)

        w, z, y = state.w, state.z, state.y
        inf = torch.full((Bb,), float("inf"), dtype=dt, device=dev)
        iter_conv = torch.full((Bb,), -1, dtype=torch.int64, device=dev)
        r_prim = r_dual = inf
        conv = torch.zeros((Bb,), dtype=torch.bool, device=dev)
        for k in range(1, settings.max_iter + 1):
            g = z - inv_rho * y
            hf = (h_masked - sigma * w - DTv(rho_vec * g)) * uterm
            w_t = (_mm(hf.reshape(Bb, M), operator.T) + base).reshape(
                Bb, N + 1, nz)
            z_t = Dw(w_t)

            w_new = alpha * w_t + (1.0 - alpha) * w
            relaxed = alpha * z_t + (1.0 - alpha) * z
            z_new = projections.project_constraints(
                relaxed + inv_rho * y, problem.e_lb, problem.e_ub, cones,
                shift) * mask
            y_new = y + rho_vec * (relaxed - z_new)

            Dw_new = Dw(w_new)
            r_prim = amax((Dw_new - z_new) * mask)
            dw = w - w_t
            dvec = ((1.0 - alpha) * Hw(dw) + sigma * dw
                    + DTv(rho_vec * ((alpha - 1.0) * (z_t - z)
                                     + (z - z_new))))
            r_dual = amax(dvec)
            prim_scale = torch.maximum(amax(Dw_new * mask), amax(z_new))
            dual_scale = torch.maximum(
                amax(Hw(w_new)), torch.maximum(amax(DTv(y_new)), h_scale))
            conv = (r_prim <= settings.eps_abs
                    + settings.eps_rel * prim_scale) \
                & (r_dual <= settings.eps_abs + settings.eps_rel * dual_scale)
            iter_conv = torch.where(conv & (iter_conv < 0), k, iter_conv)
            w, z, y = w_new, z_new, y_new
    k_it = settings.max_iter
    iters = torch.full((Bb,), k_it, dtype=torch.int64, device=dev)
    info = ADMMInfo(iterations=iters, r_prim=r_prim, r_dual=r_dual,
                    converged=conv,
                    iter_converged=torch.where(iter_conv < 0, iters, iter_conv))
    st = ADMMState(w=w, z=z, y=y,
                   rho=torch.full((Bb,), float(rho), dtype=dt, device=dev))
    return w, st, info


def _map_fields(obj, fn):
    """A dataclass of tensors (nested ones too) with ``fn`` applied to
    every tensor."""
    def leaf(v):
        return _map_fields(v, fn) if dataclasses.is_dataclass(v) else fn(v)

    return dataclasses.replace(obj, **{
        f.name: leaf(getattr(obj, f.name)) for f in dataclasses.fields(obj)})


def cast_operator(op, dtype):
    """Narrow the materialized map's storage (bfloat16 serving mode).

    The replan iteration streams the operator blocks (U / E_x / E_p for
    the condensed form, T for the dense form); every tensor of two or more
    axes is stored in ``dtype``, the vectors and rho stay as they are.
    The inner solve becomes a CONSISTENT perturbed linear map (~1e-3
    relative — the iteration still contracts, the fixed point moves
    O(1e-3)); use at MPC serving tolerances, not for tight-eps solves.

    The products keep float32 accumulation: each one widens the narrow
    map to the iterate's dtype for that product (``_mm``), so an
    iteration reads the map at its narrow width, writes and reads it once
    at float32 — more traffic than the float32 map, not less; PERF.md
    has its time.
    """
    return _map_fields(op, lambda x: x.to(dtype) if x.ndim >= 2 else x)


@dataclasses.dataclass(frozen=True)
class OperatorLadder:
    """Pre-factored operators at a static rho grid — adaptive rho for the
    realtime loop.

    A rho change invalidates the materialized map (the cost of the
    reference's full refactorization, lqr_kernel.hpp:93-101), which the
    1 kHz loop cannot afford inline.  Instead, factor ONCE at R rho rungs,
    keep the stack on the device, and let each replan (a) solve on its
    current rung (a view of the stack) and (b) emit the OSQP 5.2
    residual-imbalance suggestion for the NEXT replan's rung.  rho then
    adapts between ticks at zero rebuild cost.

    ops: an operator (ResolveOperator / CondensedOperator /
    BatchResolveOperator) whose tensors carry a leading rung axis.
    """

    rhos: torch.Tensor     # (R,) ascending rho rungs
    ops: object            # stacked operator, leading axis R

    def select(self, idx):
        i = int(idx)
        return _map_fields(self.ops, lambda x: x[i])


def build_ladder(
    problem: LQRProblem,
    rhos,
    settings: ADMMSettings = ADMMSettings(),
    cones: Sequence[projections.ConeSpec] = (),
    num_segments: Optional[int] = None,
) -> OperatorLadder:
    """Operators at each rho rung (condensed when ``num_segments`` is
    given, dense otherwise), built one rung after the other and stacked
    on a leading rung axis."""
    cones = tuple(cones)
    dt, dev = problem.H.dtype, problem.H.device
    rhos = torch.sort(torch.as_tensor(rhos, dtype=dt, device=dev)).values
    if num_segments is not None:
        build = lambda r: build_condensed_operator(
            problem, r, num_segments, settings, cones)
    else:
        build = lambda r: build_operator(problem, r, settings, cones)
    ops = [build(rhos[i]) for i in range(rhos.shape[0])]
    stacked = dataclasses.replace(ops[0], **{
        f.name: torch.stack([getattr(o, f.name) for o in ops])
        for f in dataclasses.fields(ops[0])})
    return OperatorLadder(rhos=rhos, ops=stacked)


def replan_ladder_fn(
    problem: LQRProblem,
    ladder: OperatorLadder,
    cones: Sequence[projections.ConeSpec] = (),
    settings: ADMMSettings = ADMMSettings(),
    soc_shift=None,
):
    """(x0, state, idx) -> (ws, state, info, idx_next).

    Solves on rung ``idx`` and suggests the next replan's rung from the
    final scale-normalized residual imbalance (OSQP 5.2, the rule the
    batch paths apply inline): move only on a >5x imbalance, to the rung
    nearest rho * sqrt(rel_prim / rel_dual) in log space.  y/z warm states
    carry over unchanged (they are unscaled duals/slacks); the returned
    state's rho is the next rung's.  ``idx_next`` is a Python int: the
    rung is read back once a tick (``admm.HOST_READS["refactor"]``), since
    the next tick's operator is a view chosen on the host.  Each rung's
    replan is a ``replan_fn`` of its operator, made at its first tick.
    """
    cones = tuple(cones)
    dt = problem.H.dtype
    mask = _con_mask(problem, cones).to(dt)
    h_scale = problem.h.abs().max()
    tiny = 1e-12
    log_rhos = ladder.rhos.log()
    replans = {}

    def fn(x0, state, idx):
        idx = int(idx)
        if idx not in replans:
            replans[idx] = replan_fn(problem, ladder.select(idx), cones,
                                     settings, soc_shift)
        state = dataclasses.replace(state, rho=ladder.rhos[idx], factors=None)
        ws, st, info = replans[idx](x0, state)
        with full_f32_matmul():
            # Post-hoc residual scales from the final iterate (the same
            # quantities solve() used for its exit test).
            Dw = torch.einsum("kcz,kz->kc", problem.D, st.w) * mask
            prim_scale = torch.maximum(Dw.abs().max(), st.z.abs().max())
            Hw = torch.einsum("kij,kj->ki", problem.H, st.w)
            DTy = torch.einsum("kcz,kc->kz", problem.D, st.y)
            dual_scale = torch.maximum(
                Hw.abs().max(), torch.maximum(DTy.abs().max(), h_scale))
        rp_rel = info.r_prim / prim_scale.clamp(min=tiny)
        rd_rel = info.r_dual / dual_scale.clamp(min=tiny)
        ratio = torch.sqrt(rp_rel.clamp(min=tiny) / rd_rel.clamp(min=tiny))
        rho_t = (ladder.rhos[idx] * ratio).clamp(settings.rho_min,
                                                 settings.rho_max)
        nearest = torch.argmin((log_rhos - rho_t.log()).abs())
        upd = (ratio > 5.0) | (ratio < 0.2)
        admm.HOST_READS["refactor"] += 1
        idx_next = int(torch.where(upd, nearest, idx))
        st = dataclasses.replace(st, rho=ladder.rhos[idx_next])
        return ws, st, info, idx_next

    return fn


def replan_fn(
    problem: LQRProblem,
    operator,
    cones: Sequence[projections.ConeSpec] = (),
    settings: ADMMSettings = ADMMSettings(),
    soc_shift=None,
):
    """(x0, state) -> (ws, state, info) callable for the MPC loop: x0 and
    the state are the only inputs that move between replan ticks.

    On the card the iteration is captured once as a CUDA graph
    (``_CapturedReplan``: one replay and one flag read an iteration); on
    the CPU each call is ``solve``.  Both run the same iterations with the
    same arithmetic."""
    cones = tuple(cones)
    if problem.H.device.type == "cuda":
        return _CapturedReplan(problem, operator, cones, settings, soc_shift)
    return lambda x0, state: solve(problem, x0, operator, cones, settings,
                                   state, soc_shift)
