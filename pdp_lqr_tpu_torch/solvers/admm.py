"""Conic ADMM (OSQP-style) outer loop — PyTorch port of
``pdp_lqr_tpu/solvers/admm.py``.

  x-update   inner LQ solve with the iterates folded into the stage data
             (update_problem_data semantics, lqr_solver.hpp:41-56);
             dynamics are inside the solve, so they hold exactly at every
             iterate.
  z-update   projection of the relaxed constraint values onto
             box x second-order cones.
  y-update   scaled dual ascent.
  rho        adaptive penalty with the OSQP residual-balancing rule; a rho
             change triggers matrix refactorization, otherwise iterations
             ride the cached factors (the reference's
             ``backward_without_factorization``, lqr_solver.hpp:65-70).

Ported: the data classes, ``suggest_rho_ladder`` and ``solve_fused`` in
four modes, one function each, sharing ``_finish_stats`` (and, all but the
replicated one, ``_terminal_pN`` / ``_terminal_tail``):

  _solve_shared_split   ONE unbatched model serving B scenarios,
                        ``cached_factors`` with a batch-uniform rho: K4 +
                        K5 an iteration, K1 at each factor build;
                        ``storage_dtype`` streams the stage data and the
                        factors narrower (the narrow forms of K4, K5);
  _solve_shared_ladder  the same model with a ``rho_ladder``: per-scenario
                        rho snapped to R rungs whose factors are built
                        once a solve (one K1 launch over R instances);
                        K6 + K5 (rung form) an iteration; ``storage_dtype``
                        as in the split one (the narrow forms of K6, K5);
  _solve_single_kernel  the single-kernel iteration, on either model: K8
                        an iteration (the whole sweep, rollout and tail),
                        per-instance rho, or cached factors rebuilt by K1
                        when rho changes; ``storage_dtype`` streams the
                        stage data narrower;
  _solve_replicated     a batched problem (one model a scenario),
                        per-instance rho: K1 (or K2 on cached factors) +
                        K3 an iteration, the projection and residuals in
                        tensor code.

On the split and ladder iterations ``storage_dtype`` (bfloat16) rounds the
stage streams A, B, c, H + sigma I (its diagonal under ``diag_cost``), h and
D, and the factors K, M, P, L after K1 builds them at full width; the
rho-scale mask, the bounds, the shift, the terminal stage and the iterates
stay in the compute type, as in JAX.  ``solve`` / ``solve_batched`` run the
loop on the torch-ops backends; ``solve_equilibrated`` wraps ``solve`` in
Ruiz scaling (utils/scaling).

PyTorch runs eagerly, so what the JAX loop decides on the device
(``lax.cond`` on a changed rho, the ``while_loop`` of ``early_exit``)
is a host read here.  The loop reads only where the answer can differ:
rho can move only on iterations that are a multiple of
``rho_update_interval``; ``early_exit`` reads ``all(converged)`` once an
iteration.  ``HOST_READS`` counts them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from pdp_lqr_tpu_torch.config import full_f32_matmul
from pdp_lqr_tpu_torch.ops import cuda_admm, cuda_riccati, projections
from pdp_lqr_tpu_torch.problem import ADMMIterates, LQRProblem

# Device-to-host reads made by ``solve_fused`` in this process, by reason
# (each one waits for the card to drain its queue).
HOST_READS = {"diag_cost": 0, "refactor": 0, "early_exit": 0}


def reset_host_reads():
    for name in HOST_READS:
        HOST_READS[name] = 0


@dataclasses.dataclass(frozen=True)
class ADMMSettings:
    """Static outer-loop knobs (hashable).

    sigma/rho defaults follow the reference example (lqr_example.cpp:170-171);
    alpha/adaptive-rho bounds follow OSQP defaults.
    """

    sigma: float = 1e-6
    rho: float = 0.1
    alpha: float = 1.6
    max_iter: int = 250
    rho_update_interval: int = 25
    adaptive_rho: bool = True
    rho_min: float = 1e-6
    rho_max: float = 1e6
    eps_abs: float = 1e-6
    eps_rel: float = 1e-6
    exact_dual: bool = True       # OSQP 3.4 dual residual vs cheap proxy
    rho_eq_boost: float = 1e3     # per-row rho: equality rows
    #   (e_lb == e_ub, finite) run at rho * boost (OSQP 5.2's rho_eq)
    #   — the rho_vecs interface the reference's inner step takes
    #   (lqr_solver.hpp:15-22).  1.0 disables.
    uniform_rho: bool = False     # solve_fused: adapt ONE shared rho
    #   for the whole batch from the max-over-batch residual imbalance
    #   instead of per-instance rho.  Trades per-instance adaptivity
    #   for batch-shared factors: required for cached_factors in the
    #   shared-stage mode.
    cached_factors: bool = False  # solve_fused: reuse the per-stage
    #   (P, chol(Huu), K, M) factors across iterations while rho is
    #   unchanged and run the vector-only backward sweep — refactors
    #   automatically when rho moves.
    rho_ladder: tuple = ()        # solve_fused split mode: static rho
    #   rung grid; per-instance adaptive rho on batch-shared factor
    #   streams.  Implies uniform_rho=False.
    diag_cost: bool = False       # solve_fused split mode: assert the
    #   stage costs H are diagonal (true for the quadrotor / centroidal
    #   / mass-spring models and most LQ trackers).  The residual
    #   H-terms then read the nz-entry diagonal instead of the (nz, nz)
    #   blocks.  Verified against the problem on every call.
    early_exit: bool = False      # solve_fused: stop when EVERY batch
    #   instance converges.  Big win for warm-started serving batches;
    #   keep False for fixed-cost real-time ticks.
    backend: str = "seq"          # seq | assoc | pdp | kkt
    num_segments: int = 4         # pdp backend only
    rho_dyn: float = 1e-6         # kkt backend only


@dataclasses.dataclass(frozen=True)
class ADMMState:
    """Warm-startable iterate state (the reference's ws/ys/zs vectors).

    ``factors`` (solve_fused with cached_factors only) carries, in the
    shared split mode, the row-packed streams the split kernels consume
    — ([A;K], [B;L], [M;K], Pc, rho-at-factor) — and in the replicated
    and single-kernel modes (K, M, P, L, rho-at-factor), per instance or,
    on one model, one copy, so a warm-started solve
    skips even its FIRST refactorization while rho and the problem data
    are unchanged: the reference's steady-state MPC pattern
    (update_problem_data + backward_without_factorization + forward
    across replans).  Opaque: valid only for the same problem/batch it
    came from.
    """

    w: torch.Tensor       # (N+1, nz) primal trajectory [u; x]
    z: torch.Tensor       # (N+1, nc) slack
    y: torch.Tensor       # (N+1, nc) dual
    rho: torch.Tensor     # () scalar penalty (scaled by the row mask)
    factors: object = None

    def to(self, device=None, dtype=None):
        move = lambda x: x.to(device=device, dtype=dtype)
        return ADMMState(
            w=move(self.w), z=move(self.z), y=move(self.y),
            rho=move(self.rho),
            factors=None if self.factors is None
            else tuple(move(x) for x in self.factors))


@dataclasses.dataclass(frozen=True)
class ADMMInfo:
    iterations: torch.Tensor      # () iterations run
    r_prim: torch.Tensor          # () final primal residual (inf-norm)
    r_dual: torch.Tensor          # () final dual residual (inf-norm)
    converged: torch.Tensor       # () bool
    iter_converged: torch.Tensor  # () first iteration meeting tolerance

    def __repr__(self):  # readable in example scripts
        return (
            f"ADMMInfo(iters={self.iterations}, r_prim={self.r_prim:.3e}, "
            f"r_dual={self.r_dual:.3e}, converged={self.converged})"
        )


def _con_mask(problem: LQRProblem, cones: Sequence = ()):
    """(N+1, nc) rows that actually constrain.

    A row is active when its D row is nonzero, or when it belongs to a
    cone whose block has any nonzero row at that stage (a cone's t-row
    may legitimately be all-zero D with the bound carried by
    ``soc_shift``, e.g. a plain control-norm ball ||u|| <= margin).
    """
    mask = torch.any(problem.D != 0, dim=-1)
    for off, dim, _ in projections.normalize_cones(cones):
        blk = torch.any(mask[..., off:off + dim], dim=-1, keepdim=True)
        mask[..., off:off + dim] = blk
    return mask


def init_state(problem: LQRProblem, settings: ADMMSettings) -> ADMMState:
    """Zero iterates at ``settings.rho`` (one rho an instance of a batched
    problem)."""
    return ADMMState(
        w=torch.zeros_like(problem.h),
        z=torch.zeros_like(problem.e_lb),
        y=torch.zeros_like(problem.e_lb),
        rho=torch.full(problem.A.shape[:-3], settings.rho,
                       dtype=problem.H.dtype, device=problem.H.device),
    )


def _backend(settings: ADMMSettings):
    """(solve, resolve) of the inner solver ``settings.backend`` names:
    seq | assoc | dense | kkt | pdp, the torch-ops backends of
    ``solvers``.  Each takes a problem with any leading batch axes."""
    name = settings.backend
    if name == "seq":
        from pdp_lqr_tpu_torch.solvers import sequential as be
        return be.solve, be.resolve
    if name == "assoc":
        from pdp_lqr_tpu_torch.solvers import assoc as be
        return be.solve, be.resolve
    if name == "dense":
        from pdp_lqr_tpu_torch.solvers import dense as be
        return be.solve, be.resolve
    if name == "kkt":
        from pdp_lqr_tpu_torch.solvers import kkt as be

        def solve(problem, it, x0, sigma):
            return be.solve(problem, it, x0, sigma, settings.rho_dyn)

        return solve, be.resolve
    if name == "pdp":
        from pdp_lqr_tpu_torch.config import CondensedSolverType
        from pdp_lqr_tpu_torch.solvers import pdp as be

        def solve(problem, it, x0, sigma):
            return be.solve(problem, it, x0, sigma, settings.num_segments,
                            CondensedSolverType.CHOLESKY)

        return solve, be.resolve
    raise ValueError(f"unknown backend {name!r}")


def solve(
    problem: LQRProblem,
    x0,
    cones: Sequence[projections.ConeSpec] = (),
    settings: ADMMSettings = ADMMSettings(),
    state: Optional[ADMMState] = None,
    soc_shift=None,
    residual_weights=None,
):
    """Solve the constrained conic LQ problem on the inner solver
    ``settings.backend`` (torch ops, no hand-written kernel).

    Returns (ws, state, info): ws is the (N+1, nz) trajectory (dynamics
    exactly feasible; constraint feasibility to tolerance), state warm-
    starts the next solve (receding-horizon MPC), info carries residuals.
    A problem with leading batch axes on every field (and ``x0``, and
    ``state``) solves each instance on its own: every residual maximum
    and every rho update is per instance, so a batch equals a loop over
    its instances to rounding (``solve_batched``).

    ``cones`` is a static sequence of (row_offset, dim) SOC specs into
    the per-stage constraint block; remaining rows are boxes.
    ``soc_shift`` ((N+1, nc) or None) adds an affine offset to cone rows:
    D_k w_k + shift_k in SOC (see projections.project_constraints).
    ``residual_weights`` ((N+1, nc) prim, (N+1, nz) dual) reweight the
    residual inf-norms (termination on the unscaled residuals of an
    equilibrated problem, OSQP 5.2).

    The loop runs exactly ``max_iter`` iterations (no early exit), in
    chunks of ``rho_update_interval``: each chunk one refactoring inner
    solve (rho may have changed) then cached-factor ones, the adaptive rho
    rule between chunks — the JAX function's fixed cadence, with nothing
    read back to the host.
    """
    cones = tuple(cones)
    dt, dev = problem.H.dtype, problem.H.device
    x0 = torch.as_tensor(x0).to(device=dev, dtype=dt)
    be_solve, be_resolve = _backend(settings)
    if problem.nc == 0:
        zc = torch.zeros_like(problem.e_lb)
        it = ADMMIterates(w=torch.zeros_like(problem.h), y=zc, z=zc, rho=zc)
        ws, _ = be_solve(problem, it, x0, settings.sigma)
        batch = problem.A.shape[:-3]
        zero = torch.zeros(batch, dtype=dt, device=dev)
        one = torch.ones(batch, dtype=torch.int64, device=dev)
        info = ADMMInfo(iterations=one, r_prim=zero, r_dual=zero,
                        converged=torch.ones(batch, dtype=torch.bool,
                                             device=dev),
                        iter_converged=one)
        return ws, state or init_state(problem, settings), info

    sigma, alpha = settings.sigma, settings.alpha
    mask = _con_mask(problem, cones).to(dt)
    # Per-row rho (the reference's rho_vecs interface,
    # lqr_solver.hpp:15-22): equality rows run at rho * rho_eq_boost.
    eq = torch.isfinite(problem.e_lb) & (problem.e_lb == problem.e_ub)
    rscale = mask * torch.where(eq, settings.rho_eq_boost, 1.0).to(dt)
    pw, dwt = (None, None) if residual_weights is None else residual_weights
    wp_ = (lambda x: x * pw) if pw is not None else (lambda x: x)
    wd_ = (lambda x: x * dwt) if dwt is not None else (lambda x: x)
    if state is None:
        state = init_state(problem, settings)
    amax = lambda t: t.abs().amax(dim=(-2, -1))          # per instance
    per_row = lambda r: r[..., None, None]

    with full_f32_matmul():
        Dw = lambda w: torch.einsum("...kcz,...kz->...kc", problem.D, w)
        DTv = lambda v: torch.einsum("...kcz,...kc->...kz", problem.D, v)
        Hv = lambda v: torch.einsum("...kij,...kj->...ki", problem.H, v)

        def iteration(carry, factors):
            w, z, y, rho, stats = carry
            rho_vec = per_row(rho) * rscale
            it = ADMMIterates(w=w, y=y, z=z, rho=rho_vec)
            if factors is None:
                w_t, factors = be_solve(problem, it, x0, sigma)
            else:
                w_t, factors = be_resolve(problem, it, x0, sigma, factors)
            z_t = Dw(w_t)
            w_new = alpha * w_t + (1.0 - alpha) * w
            inv_rho = torch.where(rscale > 0, 1.0 / rho_vec.clamp(min=1e-30),
                                  torch.zeros_like(rho_vec))
            relaxed = alpha * z_t + (1.0 - alpha) * z
            z_new = projections.project_constraints(
                relaxed + inv_rho * y, problem.e_lb, problem.e_ub, cones,
                soc_shift) * mask    # inactive (padded) rows stay zero
            y_new = y + rho_vec * (relaxed - z_new)

            # Residuals (OSQP sec. 3.4): primal on the updated pair.
            Dw_new = Dw(w_new)
            r_prim = amax(wp_((Dw_new - z_new) * mask))
            if settings.exact_dual:
                # The exact dual residual at the inner solve's dynamics
                # dual, through the x-update's stationarity (the JAX
                # function's derivation):
                #   r_d = (1-a) H (w - w~) + s (w - w~)
                #         + D^T rho [ (a-1)(z~ - z) + (z - z+) ]
                dw = w - w_t
                zt_term = rho_vec * ((alpha - 1.0) * (z_t - z) + (z - z_new))
                dvec = (1.0 - alpha) * Hv(dw) + sigma * dw + DTv(zt_term)
                r_dual = amax(wd_(dvec))
                dual_scale = torch.maximum(
                    amax(wd_(Hv(w_new))),
                    torch.maximum(amax(wd_(DTv(y_new))), amax(wd_(problem.h))))
            else:
                r_dual = rho * amax(wd_(DTv((z_new - z) * mask)))
                dual_scale = amax(wd_(DTv(y_new)))
            prim_scale = torch.maximum(amax(wp_(Dw_new * mask)),
                                       amax(wp_(z_new)))
            conv = (r_prim <= settings.eps_abs + settings.eps_rel * prim_scale) \
                & (r_dual <= settings.eps_abs + settings.eps_rel * dual_scale)
            # Scale-normalized residuals drive the adaptive-rho rule
            # (OSQP 5.2 uses relative, not absolute, imbalance).
            rp_rel = r_prim / prim_scale.clamp(min=1e-20)
            rd_rel = r_dual / dual_scale.clamp(min=1e-20)
            k, iter_conv = stats[0] + 1, stats[1]
            iter_conv = torch.where(conv & (iter_conv < 0), k, iter_conv)
            stats = (k, iter_conv, r_prim, r_dual, conv, rp_rel, rd_rel)
            return (w_new, z_new, y_new, rho, stats), factors

        def update_rho(carry):
            """OSQP 5.2: rho <- rho sqrt(rel_prim / rel_dual), applied
            only on a >5x relative (scale-normalized) imbalance."""
            w, z, y, rho, stats = carry
            rp_rel, rd_rel = stats[5], stats[6]
            ratio = torch.sqrt(rp_rel.clamp(min=1e-12) / rd_rel.clamp(min=1e-12))
            rho_new = (rho * ratio).clamp(settings.rho_min, settings.rho_max)
            update = (ratio > 5.0) | (ratio < 0.2)
            return (w, z, y, torch.where(update, rho_new, rho), stats)

        batch = problem.A.shape[:-3]
        inf = torch.full(batch, float("inf"), dtype=dt, device=dev)
        stats = (0, torch.full(batch, -1, dtype=torch.int64, device=dev),
                 inf, inf, torch.zeros(batch, dtype=torch.bool, device=dev),
                 inf, inf)
        rho0 = torch.as_tensor(state.rho).to(device=dev, dtype=dt)
        carry = (state.w, state.z, state.y, rho0.expand(batch).clone(), stats)
        interval = max(1, settings.rho_update_interval)
        n_chunks = -(-settings.max_iter // interval)
        for chunk in range(n_chunks):
            if chunk > 0 and settings.adaptive_rho:
                carry = update_rho(carry)
            n_iter = min(interval, settings.max_iter - chunk * interval)
            # One refactoring iteration (rho may have changed since the
            # factors were built), then the cached-factor iterations.
            carry, factors = iteration(carry, None)
            for _ in range(n_iter - 1):
                carry, factors = iteration(carry, factors)

    w, z, y, rho, stats = carry
    k, iter_conv, r_prim, r_dual, conv = stats[:5]
    iters = torch.full(batch, k, dtype=torch.int64, device=dev)
    info = ADMMInfo(iterations=iters, r_prim=r_prim, r_dual=r_dual,
                    converged=conv,
                    iter_converged=torch.where(iter_conv < 0, iters, iter_conv))
    return w, ADMMState(w=w, z=z, y=y, rho=rho), info


def solve_batched(problem: LQRProblem, x0, cones=(), settings=ADMMSettings(),
                  state=None, soc_shift=None):
    """``solve`` over a leading batch axis of (problem, x0[, state]): each
    instance's own residuals and rho, as the JAX package's ``vmap``.
    ``soc_shift`` is unbatched (shared across instances) when given."""
    if problem.A.ndim != 4:
        raise ValueError("solve_batched takes a batched problem (B, N, ...)")
    return solve(problem, x0, cones, settings, state, soc_shift)


def _batch_state(problem, Bb, settings) -> ADMMState:
    """Zero iterates for B scenarios of one unbatched model."""
    dt, dev = problem.H.dtype, problem.H.device
    zeros = lambda x: torch.zeros((Bb,) + tuple(x.shape[-2:]), dtype=dt,
                                  device=dev)
    return ADMMState(
        w=zeros(problem.h), z=zeros(problem.e_lb), y=zeros(problem.e_lb),
        rho=torch.full((Bb,), settings.rho, dtype=dt, device=dev),
    )




def _snap(rungs, rho):
    """Index of the rung nearest ``rho`` in log space (the first of a
    tie), per instance: the ladder's rule (OperatorLadder's, batched)."""
    return torch.argmin((rungs.log()[:, None] - rho.log()[None, :]).abs(),
                        dim=0)


def _finish_stats(settings, rho, stats, r_prim, r_dual, prim_scale,
                  dual_scale, ladder=None):
    """Shared convergence / adaptive-rho tail (per instance).
    ``stats`` = (k, iter_converged, r_prim, r_dual, converged) with ``k``
    a Python int; ``ladder`` (the sorted rungs, a tensor) snaps an
    adapted rho to its nearest rung.  Returns (rho_new, stats_new)."""
    k_it, iter_conv = stats[0], stats[1]
    conv = (r_prim <= settings.eps_abs + settings.eps_rel * prim_scale) \
        & (r_dual <= settings.eps_abs + settings.eps_rel * dual_scale)
    k_next = k_it + 1
    iter_conv = torch.where(conv & (iter_conv < 0), k_next, iter_conv)
    interval = max(1, settings.rho_update_interval)
    # rho can move only on the cadence: off it, nothing is computed.
    if settings.adaptive_rho and k_next % interval == 0:
        tiny = 1e-12
        rp_rel = r_prim / prim_scale.clamp(min=tiny)
        rd_rel = r_dual / dual_scale.clamp(min=tiny)
        if settings.uniform_rho:
            # ONE shared rho for the whole batch: adapt on the
            # worst-case imbalance so the factors stay batch-shared.
            rp_rel = rp_rel.max()
            rd_rel = rd_rel.max()
        ratio = torch.sqrt(rp_rel.clamp(min=tiny) / rd_rel.clamp(min=tiny))
        upd = (ratio > 5.0) | (ratio < 0.2)
        target = (rho * ratio).clamp(settings.rho_min, settings.rho_max)
        if ladder is not None:
            target = ladder[_snap(ladder, target)]
        rho = torch.where(upd, target, rho)
    return rho, (k_next, iter_conv, r_prim, r_dual, conv)


@dataclasses.dataclass(frozen=True)
class _Terminal:
    """The terminal stage's data (no control).  On one model it is shared
    over the batch: the matrices are 2-D and the vectors carry a trailing
    size 1 that broadcasts over B; on a batched problem each scenario has
    its own, with a trailing size B on every field."""

    HN: torch.Tensor      # (nx, nx[, B]) H_N[x, x], the original cost
    DNx: torch.Tensor     # (nc, nx[, B]) x-columns of D_N
    DN: torch.Tensor      # (nc, nz[, B])
    hN: torch.Tensor      # (nz, 1 | B)
    lb: torch.Tensor      # (nc, 1 | B)
    ub: torch.Tensor      # (nc, 1 | B)
    mask: torch.Tensor    # (nc, 1 | B) 0/1
    scale: torch.Tensor   # (nc, 1 | B) per-row rho scale (mask * eq boost)
    active: torch.Tensor  # (nc, 1 | B) bool, scale > 0
    shift: Optional[torch.Tensor]   # (nc, 1) or None
    h_absmax: torch.Tensor          # () or (B,) max |h| over the horizon
    zero_u: torch.Tensor            # (nu, B) the terminal stage's controls


# The terminal stage runs once an iteration on (rows, B) tensors, in tensor
# code: what it costs is the host's time to launch its operations, so the
# two functions below spend as few as they can (fused multiply-adds, one
# product per matrix, one reduction per residual).

def _tmv(M, v):
    """M v, v (s, B): M (r, s) shared over the batch, or (r, s, B)."""
    return M @ v if M.ndim == 2 else torch.einsum("rsb,sb->rb", M, v)


def _taddmv(base, M, v, alpha=1.0):
    """base + alpha M v (one fused product on a shared M)."""
    if M.ndim == 2:
        return torch.addmm(base, M, v, alpha=alpha)
    return torch.add(base, _tmv(M, v), alpha=alpha)


def _terminal_pN(term: _Terminal, nu, sigma, wN, zN, yN, rhoN_m):
    """The iterate-folded terminal linear cost
    ``h_x - sigma w_x - D_x^T (rho m z - y)``, (nx, B)."""
    rgN = rhoN_m * zN - yN
    with full_f32_matmul():
        return _taddmv(torch.add(term.hN[nu:], wN[nu:], alpha=-sigma),
                       term.DNx.transpose(0, 1), rgN, alpha=-1.0)


def _terminal_fold(term: _Terminal, HNx):
    """What the terminal penalty fold reads, once a solve: the products
    DD[c, i*nx + j] = D_x[c, i] D_x[c, j] of each row and HNx = H_N[x, x]
    + sigma I, flattened alike (a trailing B on a batched problem)."""
    DNx = term.DNx
    return (DNx[:, :, None] * DNx[:, None, :]).flatten(1, 2), HNx.flatten(0, 1)


def _terminal_PN(fold, rhoN_m):
    """The penalty-folded terminal cost-to-go ``HNx + D_x^T diag(rho m)
    D_x`` of every scenario, (nx, nx, B), from ``_terminal_fold``'s
    products: one product on one model."""
    DD, HNx = fold
    nx = HNx.shape[0] ** 0.5
    with full_f32_matmul():
        if DD.ndim == 2:
            PN = torch.addmm(HNx[:, None], DD.T, rhoN_m)
        else:
            PN = torch.add(HNx, (DD * rhoN_m[:, None, :]).sum(0))
    return PN.view(int(nx), int(nx), -1)


def _terminal_tail(settings, term: _Terminal, cones3, nu, wN, zN, yN, rho,
                   rhoN_m, stats, xN, res, ladder=None):
    """Terminal stage (no control): relax / project / dual + residual
    merge + convergence / adaptive rho.  The kernels cover stages
    0..N-1 and hand over ``xN`` and their residual maxima ``res``
    (4, B); ``rhoN_m`` is rho times the terminal rows' scale.  Returns
    (w_newN, z_newN, y_newN, rho_new, stats_new)."""
    alpha, sigma = settings.alpha, settings.sigma
    rowmax = lambda x: torch.linalg.vector_norm(x, float("inf"), dim=0)
    with full_f32_matmul():
        w_tN = torch.cat([term.zero_u, xN], dim=0)
        z_tN = _tmv(term.DNx, xN)
        # lerp(a, b, alpha) = alpha b + (1 - alpha) a: the relaxation.
        w_newN = torch.lerp(wN, w_tN, alpha)
        relaxed = torch.lerp(zN, z_tN, alpha)
        vN = relaxed + torch.where(
            term.active, yN / rhoN_m.clamp(min=1e-30), 0.0)
        z_newN = projections.project_rows(
            vN, term.lb, term.ub, cones3, term.shift, axis=0) * term.mask
        y_newN = torch.addcmul(yN, rhoN_m, relaxed - z_newN)

        DwN = _tmv(term.DN, w_newN)
        dwN = wN - w_tN
        zt_termN = rhoN_m * torch.add(zN - z_newN, z_tN - zN,
                                      alpha=alpha - 1.0)
        # (1-a) H dw + sigma dw + D^T zt, H acting on the x rows only.
        DNt = term.DN.transpose(0, 1)
        dvecN = _taddmv(sigma * dwN, DNt, zt_termN)
        if term.HN.ndim == 2:
            dvecN[nu:].addmm_(term.HN, dwN[nu:], alpha=1.0 - alpha)
        else:
            dvecN[nu:] += (1.0 - alpha) * _tmv(term.HN, dwN[nu:])
        dtyN = _tmv(DNt, y_newN)
        HwnN = _tmv(term.HN, w_newN[nu:])
    r_prim = torch.maximum(res[0], rowmax(DwN - z_newN))
    r_dual = torch.maximum(res[1], rowmax(dvecN))
    prim_scale = torch.maximum(res[2], rowmax(torch.cat([DwN, z_newN])))
    dual_scale = torch.maximum(
        res[3], rowmax(torch.cat([HwnN, dtyN])).clamp(min=term.h_absmax))
    rho_n, stats_n = _finish_stats(settings, rho, stats, r_prim, r_dual,
                                   prim_scale, dual_scale, ladder)
    return w_newN, z_newN, y_newN, rho_n, stats_n


def _start_stats(Bb, dt, dev):
    return (
        0,
        torch.full((Bb,), -1, dtype=torch.int32, device=dev),
        torch.full((Bb,), float("inf"), dtype=dt, device=dev),
        torch.full((Bb,), float("inf"), dtype=dt, device=dev),
        torch.zeros((Bb,), dtype=torch.bool, device=dev),
    )


def _info(stats, Bb, dev):
    k_it, iter_conv, r_prim, r_dual, conv = stats
    return ADMMInfo(
        iterations=torch.full((Bb,), k_it, dtype=torch.int32, device=dev),
        r_prim=r_prim, r_dual=r_dual, converged=conv,
        iter_converged=torch.where(iter_conv < 0,
                                   torch.full_like(iter_conv, k_it),
                                   iter_conv),
    )


def solve_fused(
    problem,
    x0,
    cones: Sequence[projections.ConeSpec] = (),
    settings: ADMMSettings = ADMMSettings(),
    state: Optional[ADMMState] = None,
    soc_shift=None,
    *,
    single_kernel="auto",
    storage_dtype=None,
    residual_weights=None,
):
    """Batch-fused conic ADMM over B scenarios: the serving path.

    The arguments are the JAX function's (there is no ``interpret``: a
    problem on the CPU runs the kernels' plain versions).  Four modes:

    * a ``problem`` WITHOUT a leading batch axis (``problem.A.ndim == 3``;
      ``c`` may still be batched (B, N, nx) for per-scenario drift) with
      ``cached_factors`` and ``uniform_rho``: the shared split iteration,
      the kernel pair K4 + K5 an iteration and one factor build of
      ``cuda_riccati.backward_lanes`` per rho change;
    * the same with a ``rho_ladder``: per-scenario rho on the rungs, K6 +
      K5 an iteration on R rungs' factors built once;
      on both, ``storage_dtype`` (bfloat16) stores the stage streams A, B,
      c, H + sigma I (its diagonal under ``diag_cost``), h and D narrow,
      and the factors K, M, P, L, built at full width, rounded to it; the
      narrow forms of K4-K6 widen them on the card (the refactor fold of
      hf and the pre-folded P c read the full-width h, D and c, and the
      rounded P widened); ``state.factors`` then carries (AK, BL, MK) in
      bfloat16 and (Pc, rho) in the compute type;
    * ``single_kernel=True``, on either kind of problem: K8 an iteration
      (per-instance rho; or ``cached_factors``, on a shared model with a
      batch-uniform rho, rebuilt by K1 when rho changes);
      ``storage_dtype`` (bfloat16) streams the stage data A, B, c, H +
      sigma I, h and D at that width (the kernel upcasts at load);
    * a batched problem (every field with a leading axis B) with
      ``single_kernel=False``: the replicated two-kernel iteration,
      per-instance rho, with or without ``cached_factors``;
      ``residual_weights`` (the unscaled-residual termination of
      ``solve_equilibrated``) runs only here, as in JAX.

    ``x0`` (B, nx) sets the batch.  ``single_kernel="auto"`` is the port's
    own rule (JAX's asks whether the iteration fits the TPU's on-chip
    memory, which means nothing on the card): on a shared model, the split
    pair whenever the settings give batch-shared factors (a ladder, or
    cached factors with a uniform rho), with or without ``storage_dtype``
    (the split request in bfloat16 took 39 ms against K8's cached one's
    114 at the quadrotor's N=512, B=4096; one H100, PERF.md), K8
    otherwise; on a batched problem K8, unless ``residual_weights`` asks
    for the replicated iteration: K8 took 0.6-0.75 of the replicated
    loop's time at B=1024, N=64 and N=512, with and without cached factors
    (quadrotor, one H100; PERF.md).  Both packages' single-kernel and
    replicated iterations compute the same function, except the dual
    residual under ``exact_dual=False``, which K8 ignores (as JAX's does).

    Returns (ws (B, N+1, nz), ADMMState (batched), ADMMInfo (batched)),
    on the problem's device; the trajectories are batch-leading views of
    batch-last storage.
    """
    cones = tuple(cones)
    shared_mode = problem.A.ndim == 3
    ladder = tuple(sorted(float(r) for r in settings.rho_ladder))
    if shared_mode and settings.cached_factors \
            and not settings.uniform_rho and not ladder:
        raise ValueError(
            "shared-stage cached_factors needs uniform_rho=True (or a "
            "rho_ladder): per-instance rho would make the cached "
            "factors per-instance, defeating the shared factor streams"
        )
    if ladder and settings.uniform_rho:
        raise ValueError("rho_ladder IS the per-instance alternative "
                         "to uniform_rho — set one, not both")

    dt, dev = problem.H.dtype, problem.H.device
    x0 = torch.as_tensor(x0).to(device=dev, dtype=dt)
    if problem.nc == 0:
        Bb = x0.shape[0]
        zc = torch.zeros_like(problem.e_lb)
        it = ADMMIterates(w=torch.zeros_like(problem.h), y=zc, z=zc, rho=zc)
        solve = (cuda_riccati.solve_shared if shared_mode
                 else cuda_riccati.solve_lanes)
        ws = solve(problem, it, x0, settings.sigma)
        zero = torch.zeros((Bb,), dtype=dt, device=dev)
        ones = torch.ones((Bb,), dtype=torch.int32, device=dev)
        info = ADMMInfo(iterations=ones, r_prim=zero, r_dual=zero,
                        converged=ones.bool(), iter_converged=ones)
        return ws, state or _batch_state(problem, Bb, settings), info

    if single_kernel == "auto":
        if shared_mode:
            single_kernel = not (ladder or (
                settings.cached_factors and settings.uniform_rho))
        else:
            single_kernel = residual_weights is None
    split_mode = shared_mode and not single_kernel
    if split_mode:
        if not settings.cached_factors and not ladder:
            raise ValueError(
                "shared-stage two-kernel (split) iteration requires "
                "cached_factors=True (or a rho_ladder): its backward "
                "kernel is the cached vector sweep on shared "
                "(P, L, K) streams"
            )
    elif ladder:
        raise ValueError("rho_ladder requires the shared split "
                         "iteration (unbatched problem, "
                         "single_kernel=False)")
    if residual_weights is not None and single_kernel:
        raise ValueError(
            "residual_weights (unscaled-residual termination) needs "
            "the two-kernel path — the single-kernel iteration "
            "accumulates residual maxima in-kernel without weights; "
            "pass single_kernel=False"
        )
    if residual_weights is not None and split_mode:
        raise ValueError(
            "residual_weights (unscaled-residual termination) runs on "
            "the replicated two-kernel iteration: pass a batched problem")
    if storage_dtype is not None and not (single_kernel or split_mode):
        raise ValueError("storage_dtype requires single_kernel=True "
                         "or the shared split iteration")
    if storage_dtype not in (None, dt, torch.bfloat16):
        raise NotImplementedError(
            f"storage_dtype {storage_dtype}: the kernels (K4-K6, K8) stream "
            f"the stage data in the compute type or bfloat16 only")
    if storage_dtype == dt:
        storage_dtype = None                     # the compute type: a no-op

    if single_kernel:
        return _solve_single_kernel(problem, x0, cones, settings, state,
                                    soc_shift, storage_dtype)
    if not shared_mode:
        return _solve_replicated(problem, x0, cones, settings, state,
                                 soc_shift, residual_weights)
    if ladder:
        return _solve_shared_ladder(problem, x0, cones, settings, state,
                                    soc_shift, ladder, storage_dtype)
    return _solve_shared_split(problem, x0, cones, settings, state,
                               soc_shift, storage_dtype)


@dataclasses.dataclass(frozen=True)
class _SharedStreams:
    """The shared split iterations' stage streams: ONE copy of the model
    whatever B is (trailing size 1), the per-scenario drift c and the
    terminal stage; and the streams the split kernels read, stored as
    ``storage_dtype`` (the ``*_k`` fields: the full-width ones themselves
    without it)."""

    A: torch.Tensor       # (N, nx, nx, 1)
    B: torch.Tensor       # (N, nx, nu, 1)
    c: torch.Tensor       # (N, nx, B)
    H: torch.Tensor       # (N, nz, nz, 1) H + sigma I
    Hs: torch.Tensor      # H, or its diagonal (N, nz, 1) under diag_cost
    D: torch.Tensor       # (N, nc, nz, 1)
    h: torch.Tensor       # (N, nz, 1)
    mask: torch.Tensor    # (N, nc, 1) the per-row rho scale
    bnd: torch.Tensor     # (N, 3+s, nc, 1) [lb | ub | rho scale (| shift)]
    HNx: torch.Tensor     # (nx, nx) terminal H[x, x] + sigma I
    term: _Terminal
    A_k: torch.Tensor
    B_k: torch.Tensor
    c_k: torch.Tensor
    Hs_k: torch.Tensor
    D_k: torch.Tensor
    h_k: torch.Tensor
    narrow: object        # rounds a stream to the storage type (or keeps it)


def _shared_streams(problem, Bb, cones, settings, soc_shift,
                    storage_dtype=None):
    sigma = settings.sigma
    dt, dev = problem.H.dtype, problem.H.device
    N, nu, nx, nc = problem.N, problem.nu, problem.nx, problem.nc
    nz = nu + nx
    one = lambda x: x[..., None].contiguous()       # shared: trailing 1
    mask1 = _con_mask(problem, cones).to(dt)                   # (N+1, nc)
    eq1 = torch.isfinite(problem.e_lb) & (problem.e_lb == problem.e_ub)
    scale1 = torch.where(eq1, mask1 * settings.rho_eq_boost, mask1)
    shift = None if soc_shift is None else torch.as_tensor(soc_shift).to(
        device=dev, dtype=dt)
    # c in its lanes layout, and cast there straight to the storage type
    # (one copy, not a narrow copy of the full-width one).
    if problem.c.ndim == 3:
        c_src = cuda_riccati.to_lanes(problem.c.to(dt))
    else:
        c_src = problem.c.to(dt)[..., None].expand(N, nx, Bb)
    c_l = c_src.contiguous()
    narrow = (lambda x: x) if storage_dtype is None else (
        lambda x: x.to(storage_dtype, memory_format=torch.contiguous_format))
    eye_z = torch.eye(nz, dtype=dt, device=dev)
    H_l = one(problem.H[:-1] + sigma * eye_z)
    Hs_l = H_l
    if settings.diag_cost:
        offdiag = (problem.H[:-1] * (1.0 - eye_z)).abs().max()
        HOST_READS["diag_cost"] += 1
        if float(offdiag) > 0:
            raise ValueError(
                "diag_cost=True but problem.H has off-diagonal "
                f"entries (max {float(offdiag):.2e})")
        Hs_l = one(torch.diagonal(problem.H[:-1], dim1=-2, dim2=-1) + sigma)
    # [lb | ub | rho-scale mask (| shift)] stacked for kernel B.
    bnd_parts = [problem.e_lb[:-1], problem.e_ub[:-1], scale1[:-1]]
    if shift is not None:
        bnd_parts.append(shift[:-1].expand(N, nc))
    term = _Terminal(
        HN=problem.H[-1, nu:, nu:], DNx=problem.D[-1, :, nu:], DN=problem.D[-1],
        hN=problem.h[-1][:, None],
        lb=problem.e_lb[-1][:, None], ub=problem.e_ub[-1][:, None],
        mask=mask1[-1][:, None], scale=scale1[-1][:, None],
        active=scale1[-1][:, None] > 0,
        shift=None if shift is None else shift[-1].expand(nc)[:, None],
        h_absmax=problem.h.abs().max(),
        zero_u=torch.zeros((nu, Bb), dtype=dt, device=dev),
    )
    A_l, B_l = one(problem.A), one(problem.B)
    D_l, h_l = one(problem.D[:-1]), one(problem.h[:-1])
    return _SharedStreams(
        A=A_l, B=B_l, c=c_l, H=H_l, Hs=Hs_l, D=D_l, h=h_l,
        mask=one(scale1[:-1]),                 # carries the per-row rho scale
        bnd=one(torch.stack(bnd_parts, dim=1)),                # (N, 3+s, nc, 1)
        HNx=problem.H[-1, nu:, nu:] + sigma * torch.eye(nx, dtype=dt,
                                                        device=dev),
        term=term, A_k=narrow(A_l), B_k=narrow(B_l),
        c_k=c_l if storage_dtype is None else narrow(c_src),
        Hs_k=narrow(Hs_l), D_k=narrow(D_l), h_k=narrow(h_l), narrow=narrow)


def _shared_factors(S: _SharedStreams, rho_u):
    """Matrix sweep + factor export of the one model at each rho of
    ``rho_u`` (R,): ONE K1 launch over R instances (its per-instance
    mode), the matrix half of the iteration never paying B.  Returns
    (K, M, P, L) with trailing size R."""
    N, nx, nu = S.A.shape[0], S.A.shape[1], S.B.shape[2]
    nz, nc = nx + nu, S.D.shape[1]
    R = rho_u.shape[0]
    wide = lambda x: x.expand(x.shape[:-1] + (R,)).contiguous()
    zeros = lambda *shape: torch.zeros(shape + (R,), dtype=S.A.dtype,
                                       device=S.A.device)
    DNx = S.term.DNx
    with full_f32_matmul():
        PN = S.HNx[..., None] + torch.einsum(
            "ci,cr,cj->ijr", DNx, S.term.scale * rho_u[None, :], DNx)
    K, _, M, _, P, L = cuda_riccati.backward_lanes(
        wide(S.A), wide(S.B), zeros(N, nx), wide(S.H), zeros(N, nz),
        wide(S.D), (S.mask * rho_u).contiguous(), zeros(N, nc),
        PN.contiguous(), zeros(nx), export_factors=True)
    return K, M, P, L


def _packed_iterates(state, tensor):
    """The warm state in the split loops' carry: stage rows packed
    [w | z | y] (N, nz + 2nc, B) and the terminal rows apart."""
    l3 = lambda x: torch.movedim(tensor(x), 0, -1)
    w_l, z_l, y_l = l3(state.w), l3(state.z), l3(state.y)
    wzy = torch.cat([w_l[:-1], z_l[:-1], y_l[:-1]], dim=1)
    return (wzy,) + tuple(x[-1].contiguous() for x in (w_l, z_l, y_l))


def _unpacked_state(wzy, wN, zN, yN, nz, nc, rho, factors):
    rows = lambda a, b, last: torch.movedim(
        torch.cat([wzy[:, a:b], last[None]], dim=0), -1, 0)
    w_b = rows(0, nz, wN)
    return w_b, ADMMState(
        w=w_b, z=rows(nz, nz + nc, zN), y=rows(nz + nc, nz + 2 * nc, yN),
        rho=rho, factors=factors)


def _solve_shared_split(problem, x0, cones, settings, state, soc_shift,
                        storage_dtype):
    """``solve_fused`` in shared split mode with cached factors and a
    batch-uniform rho (the non-ladder ``iteration_split`` of the JAX
    function); ``storage_dtype``: the kernels' streams and the factors
    stored narrower."""
    sigma, alpha = settings.sigma, settings.alpha
    dt, dev = problem.H.dtype, problem.H.device
    Bb = x0.shape[0]
    nu, nx, nc = problem.nu, problem.nx, problem.nc
    nz = nu + nx
    cones3 = projections.normalize_cones(cones)
    tensor = lambda v: torch.as_tensor(v).to(device=dev, dtype=dt)
    S = _shared_streams(problem, Bb, cones, settings, soc_shift,
                        storage_dtype)
    term = S.term

    def build_split_factors(rho):
        """Factor build (rho is uniform over the batch) at full width, the
        factors then rounded to the storage type, + the per-scenario fold
        Pc = P_{k+1} c (the rounded P widened, the full-width c) — only on
        refactor iterations.  The carry rides packed on the per-stage row
        axis: AK = [A; K], BL = [B; L] for kernel A, MK = [M; K] for
        kernel B."""
        K, M, P, L = (S.narrow(x) for x in _shared_factors(S, rho[:1]))
        return (torch.cat([S.A_k, K], dim=1), torch.cat([S.B_k, L], dim=1),
                torch.cat([M, K], dim=1),
                cuda_riccati.fold_Pc(P.to(dt), S.c), rho)

    def fold_hf(wzy, rho):
        """hf = h - sigma w - D^T (rho m z - y) from the packed iterates:
        the fold in tensor code, used at entry and on refactor
        iterations (kernel B emits hf in steady state)."""
        rg = (rho[None, None, :] * S.mask * wzy[:, nz:nz + nc]
              - wzy[:, nz + nc:])
        with full_f32_matmul():
            return (S.h - sigma * wzy[:, :nz]
                    - S.D[..., 0].transpose(1, 2) @ rg)

    if state is None:
        state = _batch_state(problem, Bb, settings)
    # The factor build reads rho[0] and the max-based adaptation only
    # PRESERVES uniformity: a warm start carrying per-instance rho is
    # collapsed to the batch max (the conservative OSQP choice).
    rho = tensor(state.rho).expand(Bb).max().expand(Bb).contiguous()
    wzy, wN, zN, yN = _packed_iterates(state, tensor)
    hf = fold_hf(wzy, rho)
    stats = _start_stats(Bb, dt, dev)
    # A warm state's factors: (AK, BL, MK) in the storage type, as JAX
    # casts them; (Pc, rho) in the compute type.
    fac = None if state.factors is None else tuple(
        S.narrow(tensor(x)) if i < 3 else tensor(x)
        for i, x in enumerate(state.factors))
    x0_l = x0.T.contiguous()
    interval = max(1, settings.rho_update_interval)
    # Whether rho may differ from the rho the factors were built at: at
    # entry, and after an iteration on the adaptation cadence.
    rho_may_differ = True

    while stats[0] < settings.max_iter:
        if settings.early_exit and stats[0] > 0:
            HOST_READS["early_exit"] += 1
            if bool(stats[4].all()):
                break
        rhoN_m = rho[None, :] * term.scale
        pN = _terminal_pN(term, nu, sigma, wN, zN, yN, rhoN_m)

        refactor = fac is None
        if not refactor and rho_may_differ:
            HOST_READS["refactor"] += 1
            refactor = bool((rho != fac[4]).any())
        if refactor:
            # The carried hf embeds the PREVIOUS rho: fold it again.
            fac = build_split_factors(rho)
            hf = fold_hf(wzy, rho)
        AK, BL, MK, Pc, _ = fac

        dv = cuda_admm.admm_bwd_vec_prefold_lanes(pN, AK, BL, S.c_k, Pc,
                                                  hf, nu=nu)
        wzy, hf, xN, res = cuda_admm.admm_fwd_update_lanes(
            rho[None, :], x0_l, MK, None, S.Hs_k, S.D_k, S.bnd, None, None,
            None, dv, wzy, nu=nu, cones=cones3, alpha=alpha, sigma=sigma,
            h=S.h_k)
        wN, zN, yN, rho, stats = _terminal_tail(
            settings, term, cones3, nu, wN, zN, yN, rho, rhoN_m, stats, xN,
            res)
        rho_may_differ = settings.adaptive_rho and stats[0] % interval == 0

    w_b, out = _unpacked_state(wzy, wN, zN, yN, nz, nc, rho, fac)
    return w_b, out, _info(stats, Bb, dev)


def _solve_shared_ladder(problem, x0, cones, settings, state, soc_shift,
                         ladder, storage_dtype):
    """``solve_fused`` in shared split mode with a rho ladder (the ladder
    ``iteration_split`` of the JAX function): per-scenario rho, always on
    a rung; the R rungs' factors are built once a solve (at full width,
    then rounded to ``storage_dtype``), so there is no refactor and no
    factor carry (``state.factors`` is None on return)."""
    sigma, alpha = settings.sigma, settings.alpha
    dt, dev = problem.H.dtype, problem.H.device
    Bb, N = x0.shape[0], problem.N
    nu, nx, nc = problem.nu, problem.nx, problem.nc
    nz = nu + nx
    cones3 = projections.normalize_cones(cones)
    tensor = lambda v: torch.as_tensor(v).to(device=dev, dtype=dt)
    S = _shared_streams(problem, Bb, cones, settings, soc_shift,
                        storage_dtype)
    term = S.term

    rungs = torch.tensor(ladder, dtype=dt, device=dev)
    R = len(ladder)
    # R rungs' factors stacked on rows, rung r at rows r*n .. (r+1)*n.
    stack = lambda X: X.permute(0, 3, 1, 2).reshape(
        N, R * X.shape[1], X.shape[2], 1).contiguous()
    K_r, M_r, P_r, L_r = (stack(S.narrow(X))
                          for X in _shared_factors(S, rungs))

    if state is None:
        state = _batch_state(problem, Bb, settings)
    # Snap the warm / initial rho onto the rungs (per instance); each
    # scenario's rung index rides beside its rho into the kernels.
    rung = _snap(rungs, tensor(state.rho).expand(Bb).clamp(min=1e-30))
    rho = rungs[rung]
    rung = rung.to(torch.int32)
    wzy, wN, zN, yN = _packed_iterates(state, tensor)
    stats = _start_stats(Bb, dt, dev)
    x0_l = x0.T.contiguous()
    interval = max(1, settings.rho_update_interval)

    while stats[0] < settings.max_iter:
        if settings.early_exit and stats[0] > 0:
            HOST_READS["early_exit"] += 1
            if bool(stats[4].all()):
                break
        rho_row = rho[None, :]
        rhoN_m = rho_row * term.scale
        pN = _terminal_pN(term, nu, sigma, wN, zN, yN, rhoN_m)
        dv = cuda_admm.admm_bwd_vec_lanes(
            rho_row, pN, S.A_k, S.B_k, S.h_k, S.D_k, S.mask, P_r, L_r, K_r,
            S.c_k, wzy, nu=nu, sigma=sigma, rung=rung)
        wzy, xN, res = cuda_admm.admm_fwd_update_lanes(
            rho_row, x0_l, M_r, K_r, S.Hs_k, S.D_k, S.bnd, None, None, None,
            dv, wzy, nu=nu, cones=cones3, alpha=alpha, sigma=sigma,
            rung=rung)
        wN, zN, yN, rho, stats = _terminal_tail(
            settings, term, cones3, nu, wN, zN, yN, rho, rhoN_m, stats, xN,
            res, ladder=rungs)
        if settings.adaptive_rho and stats[0] % interval == 0:
            rung = _snap(rungs, rho).to(torch.int32)

    w_b, out = _unpacked_state(wzy, wN, zN, yN, nz, nc, rho, None)
    return w_b, out, _info(stats, Bb, dev)


def _batched_lanes(problem, cones, settings):
    """A batched problem's streams in the lanes layout (batch last,
    contiguous), as both per-instance iterations read them: the 0/1 row
    mask and the per-row rho scale (mask * eq boost) (N+1, nc, B), A, B,
    c, H + sigma I (N, nz, nz, B), D (N, nc, nz, B) and the terminal
    H_N[x, x] + sigma I (nx, nx, B)."""
    dt, dev, sigma = problem.H.dtype, problem.H.device, settings.sigma
    nu, nx = problem.nu, problem.nx
    l3 = lambda x: torch.movedim(x, 0, -1).contiguous()
    eye = lambda n: torch.eye(n, dtype=dt, device=dev)
    mask = l3(_con_mask(problem, cones).to(dt))
    eq = l3(torch.isfinite(problem.e_lb) & (problem.e_lb == problem.e_ub))
    return (mask, torch.where(eq, mask * settings.rho_eq_boost, mask),
            l3(problem.A), l3(problem.B), l3(problem.c),
            l3(problem.H[:, :-1] + sigma * eye(nu + nx)),
            l3(problem.D[:, :-1]),
            l3(problem.H[:, -1, nu:, nu:] + sigma * eye(nx)))


def _solve_single_kernel(problem, x0, cones, settings, state, soc_shift,
                         storage_dtype):
    """``solve_fused``'s single-kernel iteration (``iteration_1k`` of the
    JAX function): K8 an iteration, on one model serving B scenarios (its
    streams one copy) or on a batched problem.  Per-instance rho; with
    ``cached_factors`` K8 runs its vector sweep on factors that K1
    rebuilds when rho changes (on one model one instance at the
    batch-uniform rho, on a batched problem every instance).  The
    terminal stage, convergence and adaptive rho are tensor code, shared
    with the split iterations."""
    sigma, alpha = settings.sigma, settings.alpha
    dt, dev = problem.H.dtype, problem.H.device
    shared = problem.A.ndim == 3
    Bb, N = x0.shape[0], problem.N
    nu, nx, nc = problem.nu, problem.nx, problem.nc
    nz = nu + nx
    cones3 = projections.normalize_cones(cones)
    tensor = lambda v: torch.as_tensor(v).to(device=dev, dtype=dt)
    cached = settings.cached_factors
    if shared:
        # The split loops' streams (diag_cost means nothing here).
        S = _shared_streams(problem, Bb, cones,
                            dataclasses.replace(settings, diag_cost=False),
                            soc_shift)
        A_l, B_l, c_l, H_l, h_l, D_l, mask_st = (
            S.A, S.B, S.c, S.H, S.h, S.D, S.mask)
        lb_st, ub_st = S.bnd[:, 0].contiguous(), S.bnd[:, 1].contiguous()
        shift_st = S.bnd[:, 3].contiguous() if soc_shift is not None else None
        HNx, term = S.HNx, S.term
    else:
        l3 = lambda x: torch.movedim(x, 0, -1).contiguous()   # -> lanes
        mask, rsc, A_l, B_l, c_l, H_l, D_l, HNx = _batched_lanes(
            problem, cones, settings)
        h_l = l3(problem.h[:, :-1])
        lb_st, ub_st = l3(problem.e_lb[:, :-1]), l3(problem.e_ub[:, :-1])
        mask_st = rsc[:-1].contiguous()          # carries the rho scale
        shift = None if soc_shift is None else tensor(soc_shift)
        shift_st = None if shift is None else \
            shift[:-1, :, None].expand(N, nc, Bb).contiguous()
        term = _Terminal(
            HN=l3(problem.H[:, -1, nu:, nu:]), DNx=l3(problem.D[:, -1, :, nu:]),
            DN=l3(problem.D[:, -1]), hN=l3(problem.h[:, -1]),
            lb=l3(problem.e_lb[:, -1]), ub=l3(problem.e_ub[:, -1]),
            mask=mask[-1], scale=rsc[-1], active=rsc[-1] > 0,
            shift=None if shift is None else shift[-1][:, None],
            h_absmax=problem.h.abs().amax(dim=(1, 2)),
            zero_u=torch.zeros((nu, Bb), dtype=dt, device=dev))
    # The stage data K8 streams, narrower with storage_dtype (H + sigma I
    # rounded after the sum, as in JAX); the factor builds read it whole.
    narrow = (lambda x: x) if storage_dtype is None else (
        lambda x: x.to(storage_dtype))
    A_k, B_k, c_k, H_k, h_k, D_k = (narrow(x) for x in
                                    (A_l, B_l, c_l, H_l, h_l, D_l))
    fold = _terminal_fold(term, HNx)

    def build_factors(rho, rhoN_m):
        """The exported factors (K, M, P, L) at rho: one K1 instance at
        the uniform rho on one model, every instance on a batched one."""
        if shared:
            return _shared_factors(S, rho[:1])
        zeros = lambda *s: torch.zeros(s + (Bb,), dtype=dt, device=dev)
        K, _, M, _, P, L = cuda_riccati.backward_lanes(
            A_l, B_l, c_l, H_l, zeros(N, nz), D_l,
            (rho[None, None, :] * mask_st).contiguous(), zeros(N, nc),
            _terminal_PN(fold, rhoN_m), zeros(nx), export_factors=True)
        return K, M, P, L

    if state is None:
        state = _batch_state(problem, Bb, settings)
    rho = tensor(state.rho).expand(Bb).contiguous()
    if shared and cached:
        # The factor build reads rho[0] and the max-based adaptation only
        # PRESERVES uniformity: a warm start carrying per-instance rho is
        # collapsed to the batch max (the conservative OSQP choice).
        rho = rho.max().expand(Bb).contiguous()
    w_l, z_l, y_l = (torch.movedim(tensor(x), 0, -1) for x in
                     (state.w, state.z, state.y))
    w, z, y = (x[:-1].contiguous() for x in (w_l, z_l, y_l))
    wN, zN, yN = (x[-1].contiguous() for x in (w_l, z_l, y_l))
    stats = _start_stats(Bb, dt, dev)
    fac = None if (state.factors is None or not cached) else tuple(
        tensor(x) for x in state.factors)
    x0_l = x0.T.contiguous()
    interval = max(1, settings.rho_update_interval)
    rho_may_differ = True

    while stats[0] < settings.max_iter:
        if settings.early_exit and stats[0] > 0:
            HOST_READS["early_exit"] += 1
            if bool(stats[4].all()):
                break
        rhoN_m = rho[None, :] * term.scale
        pN = _terminal_pN(term, nu, sigma, wN, zN, yN, rhoN_m)
        PN = factors = None
        if cached:
            refactor = fac is None
            if not refactor and rho_may_differ:
                HOST_READS["refactor"] += 1
                refactor = bool((rho != fac[4]).any())
            if refactor:
                fac = build_factors(rho, rhoN_m) + (rho,)
            factors = (fac[2], fac[3], fac[0])
        else:
            PN = _terminal_PN(fold, rhoN_m)
        w, z, y, xN, res = cuda_admm.admm_iter_lanes(
            A_k, B_k, c_k, H_k, h_k, D_k, lb_st, ub_st, mask_st, shift_st,
            w, z, y, rho[None, :], PN, pN, x0_l, nu=nu, cones=cones3,
            alpha=alpha, sigma=sigma, factors=factors, shared=shared)
        wN, zN, yN, rho, stats = _terminal_tail(
            settings, term, cones3, nu, wN, zN, yN, rho, rhoN_m, stats, xN,
            res)
        rho_may_differ = settings.adaptive_rho and stats[0] % interval == 0

    rows = lambda s_, last: torch.movedim(torch.cat([s_, last[None]]), -1, 0)
    w_b = rows(w, wN)
    return w_b, ADMMState(w=w_b, z=rows(z, zN), y=rows(y, yN), rho=rho,
                          factors=fac), _info(stats, Bb, dev)


def _solve_replicated(problem, x0, cones, settings, state, soc_shift,
                      residual_weights):
    """``solve_fused`` on a batched problem: the replicated two-kernel
    iteration (``iteration`` of the JAX function), per-instance rho.

    Per iteration: the matrix sweep K1 on every instance (a warp an
    instance), or, with ``cached_factors`` while rho is unchanged, the
    per-instance vector sweep K2 on the exported factors; then the
    per-instance rollout K3.  The relaxation, projection, dual update and
    residuals are tensor code on (N+1, rows, B) tensors, as in JAX; their
    matrix products run on batch-major copies of D and H made once a
    solve ((N+1, B, rows, cols): one batched product each)."""
    sigma, alpha = settings.sigma, settings.alpha
    dt, dev = problem.H.dtype, problem.H.device
    Bb, N = problem.h.shape[0], problem.N
    nu, nx, nc = problem.nu, problem.nx, problem.nc
    nz = nu + nx
    cones3 = projections.normalize_cones(cones)
    tensor = lambda v: torch.as_tensor(v).to(device=dev, dtype=dt)
    l3 = lambda x: torch.movedim(x, 0, -1).contiguous()   # (B, ...) -> lanes

    mask, rsc, A_l, B_l, c_l, H_l, Dst_l, HN_l = _batched_lanes(
        problem, cones, settings)
    DN_l = l3(problem.D[:, -1, :, nu:])                        # (nc, nx, B)
    h_base = l3(problem.h)                                     # (N+1, nz, B)
    uterm = torch.ones((N + 1, nz, 1), dtype=dt, device=dev)
    uterm[-1, :nu] = 0.0
    lb_l, ub_l = l3(problem.e_lb), l3(problem.e_ub)
    shift_l = None if soc_shift is None else tensor(soc_shift)[..., None]
    # Batch-major D and H (the terminal H on its x block only, as JAX
    # reads it) for the residual products.
    D_t = problem.D.transpose(0, 1).contiguous()               # (N+1, B, nc, nz)
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
    DTy = lambda y: bmv(D_t.transpose(-1, -2), y)
    if residual_weights is not None:
        pwt = tensor(residual_weights[0])[..., None]           # (N+1, nc, 1)
        dwt = tensor(residual_weights[1])[..., None]           # (N+1, nz, 1)
        wp = lambda x: x * pwt
        wd = lambda x: x * dwt
    else:
        wp = wd = lambda x: x
    amax = lambda x: x.abs().amax(dim=(0, 1))                 # -> (B,)
    h_absmax = amax(wd(h_base))

    if state is None:
        state = _batch_state(problem, Bb, settings)
    rho = tensor(state.rho).expand(Bb).contiguous()
    w, z, y = (torch.movedim(tensor(x), 0, -1) for x in
               (state.w, state.z, state.y))
    stats = _start_stats(Bb, dt, dev)
    cached = settings.cached_factors
    fac = None if (state.factors is None or not cached) else tuple(
        tensor(x) for x in state.factors)
    x0_l = x0.T.contiguous()
    zero_u = torch.zeros((1, nu, Bb), dtype=dt, device=dev)
    interval = max(1, settings.rho_update_interval)
    rho_may_differ = True

    while stats[0] < settings.max_iter:
        if settings.early_exit and stats[0] > 0:
            HOST_READS["early_exit"] += 1
            if bool(stats[4].all()):
                break
        rho_vec = rho[None, None, :] * rsc                     # (N+1, nc, B)
        inv_rho = torch.where(rsc > 0, 1.0 / rho_vec.clamp(min=1e-30), 0.0)
        g = z - inv_rho * y
        h_t = (h_base - sigma * w) * uterm
        rg = rho_vec * g
        with full_f32_matmul():
            # Terminal linear fold (vector part, every iteration).
            pN = h_t[-1, nu:] - torch.einsum("cxb,cb->xb", DN_l, rg[-1])

        def full():
            # Terminal matrix fold, then the matrix sweep on every
            # instance (exporting the factors when they are cached).
            with full_f32_matmul():
                PN = HN_l + torch.einsum("cib,cb,cjb->ijb", DN_l,
                                         rho_vec[-1], DN_l)
            return cuda_riccati.backward_lanes(
                A_l, B_l, c_l, H_l, h_t[:-1], Dst_l, rho_vec[:-1], rg[:-1],
                PN.contiguous(), pN, export_factors=cached)

        if cached:
            refactor = fac is None
            if not refactor and rho_may_differ:
                HOST_READS["refactor"] += 1
                refactor = bool((rho != fac[4]).any())
            if refactor:
                K, d, M, v, P, L = full()
                fac = (K, M, P, L, rho)
            else:
                K, M, P, L, _ = fac
                hf = (h_t - DTy(rg))[:-1].contiguous()
                d, v = cuda_riccati.backward_vectors_lanes(
                    A_l, B_l, c_l, hf, P, K, L, pN)
        else:
            K, d, M, v = full()
        ws_l, xN = cuda_riccati.forward_lanes(M, v, K, d, x0_l)
        w_t = torch.cat([ws_l, torch.cat([zero_u, xN[None]], dim=1)], dim=0)

        z_t = Dw(w_t)
        w_new = alpha * w_t + (1.0 - alpha) * w
        v_z = alpha * z_t + (1.0 - alpha) * z + inv_rho * y
        z_new = projections.project_rows(v_z, lb_l, ub_l, cones3, shift_l,
                                         axis=1) * mask
        y_new = y + rho_vec * (alpha * z_t + (1.0 - alpha) * z - z_new)

        Dw_new = Dw(w_new)
        r_prim = amax(wp((Dw_new - z_new) * mask))
        if settings.exact_dual:
            dw = w - w_t
            zt_term = rho_vec * ((alpha - 1.0) * (z_t - z) + (z - z_new))
            dvec = (1.0 - alpha) * Hw(dw) + sigma * dw + DTy(zt_term)
            r_dual = amax(wd(dvec))
            dual_scale = torch.maximum(
                amax(wd(Hw(w_new))),
                torch.maximum(amax(wd(DTy(y_new))), h_absmax))
        else:
            r_dual = rho * amax(wd(DTy((z_new - z) * mask)))
            dual_scale = amax(wd(DTy(y_new)))
        prim_scale = torch.maximum(amax(wp(Dw_new * mask)),
                                   amax(wp(z_new)))
        w, z, y = w_new, z_new, y_new
        rho, stats = _finish_stats(settings, rho, stats, r_prim, r_dual,
                                   prim_scale, dual_scale)
        rho_may_differ = settings.adaptive_rho and stats[0] % interval == 0

    w_b = torch.movedim(w, -1, 0)
    return w_b, ADMMState(
        w=w_b, z=torch.movedim(z, -1, 0), y=torch.movedim(y, -1, 0),
        rho=rho, factors=fac), _info(stats, Bb, dev)


def suggest_rho_ladder(problem, x0, cones: Sequence = (),
                       settings: ADMMSettings = ADMMSettings(), *,
                       rungs: int = 4, probe_batch: int = 128,
                       probe_iters: Optional[int] = None, soc_shift=None):
    """Pick ``rho_ladder`` rungs from the problem's own adaptive-rho
    footprint (the JAX function's rule).

    Runs a short PER-INSTANCE adaptive-rho probe on a strided subsample
    of ``probe_batch`` scenarios through the replicated loop (the path
    with unrestricted per-instance rho), then places up to ``rungs``
    rungs at the log-space quantiles of the probe's final rho; rungs
    closer than 10 % in log space are merged (the lower one kept).  A
    shared model (``problem.A.ndim == 3``; only ``c`` may carry a batch
    axis) is replicated over the subsample, a batched problem subsampled.
    Returns a sorted tuple of 1..``rungs`` values, each rounded to four
    significant digits.  The probe is set-up time, not the hot loop: its
    one read of rho is the answer.
    """
    B = int(x0.shape[0])
    idx = np.unique(np.linspace(0, B - 1,
                                min(int(probe_batch), B)).astype(int))
    dev = problem.H.device
    sel = torch.as_tensor(idx, device=dev)
    x0p = torch.as_tensor(x0).to(dev)[sel]
    fields = [f.name for f in dataclasses.fields(problem)]
    if problem.A.ndim == 3:
        c_batched = problem.c.ndim == 3
        pp = LQRProblem(**{
            f: getattr(problem, f).expand(
                (len(idx),) + getattr(problem, f).shape)
            for f in fields if not (f == "c" and c_batched)},
            **({"c": problem.c[sel]} if c_batched else {}))
    else:
        pp = LQRProblem(**{f: getattr(problem, f)[sel] for f in fields})
    ps = dataclasses.replace(
        settings, adaptive_rho=True, cached_factors=False,
        uniform_rho=False, rho_ladder=(),
        max_iter=int(probe_iters if probe_iters is not None
                     else settings.max_iter))
    _, st, _ = solve_fused(pp, x0p, tuple(cones), ps, soc_shift=soc_shift)
    rho = st.rho.detach().double().cpu().numpy().ravel()
    rho = rho[np.isfinite(rho) & (rho > 0.0)]
    if rho.size == 0:  # degenerate probe: fall back to the start rho
        return (float(settings.rho),)
    logs = np.log(rho)
    R = max(1, int(rungs))
    picks = np.exp(np.quantile(logs, (np.arange(R) + 0.5) / R))
    out = []
    for r in picks:
        if not out or np.log(r) - np.log(out[-1]) > 0.1:
            out.append(float(r))
    return tuple(float(f"{r:.4g}") for r in out)


def solve_equilibrated(
    problem: LQRProblem,
    x0,
    cones: Sequence[projections.ConeSpec] = (),
    settings: ADMMSettings = ADMMSettings(),
    state: Optional[ADMMState] = None,
    soc_shift=None,
    *,
    ruiz_iters: int = 10,
):
    """Ruiz-equilibrated solve (OSQP sec. 5) of an UNBATCHED problem.

    Scales (H, h, D, bounds) by modified Ruiz equilibration + cost
    normalization (utils/scaling), pushes the variable scaling through
    the dynamics, solves the scaled problem with ``solve`` terminating on
    the UNSCALED residuals (``residual_weights``), and returns unscaled
    (ws, state, info).  A problem whose rows span orders of magnitude
    converges in roughly the iterations of its well-scaled equivalent.

    ``state`` is in UNSCALED space (as returned by this function).
    """
    from pdp_lqr_tpu_torch.utils import scaling as sc

    cones = tuple(cones)
    x0 = torch.as_tensor(x0, dtype=problem.H.dtype, device=problem.H.device)
    scal = sc.ruiz_equilibrate(problem, cones, ruiz_iters)
    sp = sc.scale_problem(problem, scal)
    sx0 = sc.scale_x0(x0, scal, problem.nu)
    ssh = sc.scale_soc_shift(soc_shift, scal)
    weights = sc.residual_weights(scal)
    sstate = None if state is None else sc.scale_state(state, scal)
    ws, st, info = solve(sp, sx0, cones, settings, sstate, ssh,
                         residual_weights=weights)
    return sc.unscale_ws(ws, scal), sc.unscale_state(st, scal), info
