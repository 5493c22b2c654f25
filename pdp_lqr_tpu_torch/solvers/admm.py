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

Ported so far: the data classes and ``solve_fused`` in its shared split
mode — ONE unbatched model serving B scenarios, ``cached_factors`` with a
batch-uniform rho — on the kernel pair of ``ops/cuda_admm.py`` plus the
factor build of ``ops/cuda_riccati.py``.  The other modes of
``solve_fused`` raise ``NotImplementedError`` naming the ROADMAP item
they wait for; they are to land as functions of their own beside
``_solve_shared_split`` and share ``_finish_stats`` and
``_terminal_tail`` with it.

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
    — ([A;K], [B;L], [M;K], Pc, rho-at-factor) — so a warm-started solve
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
    return ADMMState(
        w=torch.zeros_like(problem.h),
        z=torch.zeros_like(problem.e_lb),
        y=torch.zeros_like(problem.e_lb),
        rho=torch.tensor(settings.rho, dtype=problem.H.dtype,
                         device=problem.H.device),
    )


def _batch_state(problem, Bb, settings) -> ADMMState:
    """Zero iterates for B scenarios of one unbatched model."""
    dt, dev = problem.H.dtype, problem.H.device
    zeros = lambda x: torch.zeros((Bb,) + tuple(x.shape[-2:]), dtype=dt,
                                  device=dev)
    return ADMMState(
        w=zeros(problem.h), z=zeros(problem.e_lb), y=zeros(problem.e_lb),
        rho=torch.full((Bb,), settings.rho, dtype=dt, device=dev),
    )


def _finish_stats(settings, rho, stats, r_prim, r_dual, prim_scale,
                  dual_scale):
    """Shared convergence / adaptive-rho tail (per instance).
    ``stats`` = (k, iter_converged, r_prim, r_dual, converged) with ``k``
    a Python int.  Returns (rho_new, stats_new)."""
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
        rho = torch.where(upd, target, rho)
    return rho, (k_next, iter_conv, r_prim, r_dual, conv)


@dataclasses.dataclass(frozen=True)
class _Terminal:
    """The terminal stage's data (no control), shared over the batch:
    the vectors carry a trailing size 1 that broadcasts over B."""

    HN: torch.Tensor      # (nx, nx) H_N[x, x], the original cost
    DNx: torch.Tensor     # (nc, nx) x-columns of D_N
    DN: torch.Tensor      # (nc, nz)
    hN: torch.Tensor      # (nz, 1)
    lb: torch.Tensor      # (nc, 1)
    ub: torch.Tensor      # (nc, 1)
    mask: torch.Tensor    # (nc, 1) 0/1
    scale: torch.Tensor   # (nc, 1) per-row rho scale (mask * eq boost)
    active: torch.Tensor  # (nc, 1) bool, scale > 0
    shift: Optional[torch.Tensor]   # (nc, 1) or None
    h_absmax: torch.Tensor          # () max |h| over the horizon
    zero_u: torch.Tensor            # (nu, B) the terminal stage's controls


# The terminal stage runs once an iteration on (rows, B) tensors, in tensor
# code: what it costs is the host's time to launch its operations, so the
# two functions below spend as few as they can (fused multiply-adds, one
# product per matrix, one reduction per residual).

def _terminal_pN(term: _Terminal, nu, sigma, wN, zN, yN, rhoN_m):
    """The iterate-folded terminal linear cost
    ``h_x - sigma w_x - D_x^T (rho m z - y)``, (nx, B)."""
    rgN = rhoN_m * zN - yN
    with full_f32_matmul():
        return torch.addmm(torch.add(term.hN[nu:], wN[nu:], alpha=-sigma),
                           term.DNx.T, rgN, alpha=-1.0)


def _terminal_tail(settings, term: _Terminal, cones3, nu, wN, zN, yN, rho,
                   rhoN_m, stats, xN, res):
    """Terminal stage (no control): relax / project / dual + residual
    merge + convergence / adaptive rho.  The kernels cover stages
    0..N-1 and hand over ``xN`` and their residual maxima ``res``
    (4, B); ``rhoN_m`` is rho times the terminal rows' scale.  Returns
    (w_newN, z_newN, y_newN, rho_new, stats_new)."""
    alpha, sigma = settings.alpha, settings.sigma
    rowmax = lambda x: torch.linalg.vector_norm(x, float("inf"), dim=0)
    with full_f32_matmul():
        w_tN = torch.cat([term.zero_u, xN], dim=0)
        z_tN = term.DNx @ xN
        # lerp(a, b, alpha) = alpha b + (1 - alpha) a: the relaxation.
        w_newN = torch.lerp(wN, w_tN, alpha)
        relaxed = torch.lerp(zN, z_tN, alpha)
        vN = relaxed + torch.where(
            term.active, yN / rhoN_m.clamp(min=1e-30), 0.0)
        z_newN = projections.project_rows(
            vN, term.lb, term.ub, cones3, term.shift, axis=0) * term.mask
        y_newN = torch.addcmul(yN, rhoN_m, relaxed - z_newN)

        DwN = term.DN @ w_newN
        dwN = wN - w_tN
        zt_termN = rhoN_m * torch.add(zN - z_newN, z_tN - zN,
                                      alpha=alpha - 1.0)
        # (1-a) H dw + sigma dw + D^T zt, H acting on the x rows only.
        dvecN = torch.addmm(sigma * dwN, term.DN.T, zt_termN)
        dvecN[nu:].addmm_(term.HN, dwN[nu:], alpha=1.0 - alpha)
        dtyN = term.DN.T @ y_newN
        HwnN = term.HN @ w_newN[nu:]
    r_prim = torch.maximum(res[0], rowmax(DwN - z_newN))
    r_dual = torch.maximum(res[1], rowmax(dvecN))
    prim_scale = torch.maximum(res[2], rowmax(torch.cat([DwN, z_newN])))
    dual_scale = torch.maximum(
        res[3], rowmax(torch.cat([HwnN, dtyN])).clamp(min=term.h_absmax))
    rho_n, stats_n = _finish_stats(settings, rho, stats, r_prim, r_dual,
                                   prim_scale, dual_scale)
    return w_newN, z_newN, y_newN, rho_n, stats_n


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
    problem on the CPU runs the kernels' plain versions).  Served is the
    shared split mode: a ``problem`` WITHOUT a leading batch axis
    (``problem.A.ndim == 3``; ``c`` may still be batched (B, N, nx) for
    per-scenario drift) with ``cached_factors`` and ``uniform_rho``, run
    as the kernel pair of ``ops/cuda_admm.py`` an iteration and one
    factor build of ``cuda_riccati.backward_lanes`` per rho change.
    ``x0`` (B, nx) sets the batch.  ``single_kernel="auto"`` resolves to
    that split iteration whenever the settings allow it.

    Not ported yet, each raising ``NotImplementedError``: a batched
    (per-instance) problem and ``single_kernel=True`` (ROADMAP M6),
    ``rho_ladder`` (M5), ``storage_dtype`` and ``residual_weights`` (M6).

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
        if not shared_mode:
            raise NotImplementedError(
                "solve_fused on a batched (per-instance) problem waits "
                "for the replicated path (ROADMAP M6, solve_lanes)")
        Bb = x0.shape[0]
        zc = torch.zeros_like(problem.e_lb)
        it = ADMMIterates(w=torch.zeros_like(problem.h), y=zc, z=zc, rho=zc)
        ws = cuda_riccati.solve_shared(problem, it, x0, settings.sigma)
        zero = torch.zeros((Bb,), dtype=dt, device=dev)
        ones = torch.ones((Bb,), dtype=torch.int32, device=dev)
        info = ADMMInfo(iterations=ones, r_prim=zero, r_dual=zero,
                        converged=ones.bool(), iter_converged=ones)
        return ws, state or _batch_state(problem, Bb, settings), info

    if single_kernel == "auto":
        # The port has no on-chip memory to fit: the split pair serves
        # whenever the settings give it batch-shared factors.
        single_kernel = not (shared_mode and (
            ladder or (settings.cached_factors and settings.uniform_rho)))
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
    if storage_dtype is not None and not (single_kernel or split_mode):
        raise ValueError("storage_dtype requires single_kernel=True "
                         "or the shared split iteration")

    if not shared_mode:
        raise NotImplementedError(
            "solve_fused on a batched (per-instance) problem waits for "
            "the replicated two-kernel iteration (ROADMAP M6)")
    if single_kernel:
        raise NotImplementedError(
            "the single-kernel iteration waits for kernel K8 "
            "(admm_iter_lanes, ROADMAP M6); use cached_factors + "
            "uniform_rho with single_kernel=False or \"auto\"")
    if ladder:
        raise NotImplementedError(
            "rho_ladder waits for kernel K6 (admm_bwd_vec_lanes) and the "
            "R-rung form of admm_fwd_update_lanes (ROADMAP M5)")
    if storage_dtype is not None:
        raise NotImplementedError(
            "storage_dtype (narrow stage streams) is not ported yet "
            "(ROADMAP M6)")
    if residual_weights is not None:
        raise NotImplementedError(
            "residual_weights is not ported yet (ROADMAP M6)")
    return _solve_shared_split(problem, x0, cones, settings, state,
                               soc_shift)


def _solve_shared_split(problem, x0, cones, settings, state, soc_shift):
    """``solve_fused`` in shared split mode with cached factors and a
    batch-uniform rho (the non-ladder ``iteration_split`` of the JAX
    function)."""
    sigma, alpha = settings.sigma, settings.alpha
    dt, dev = problem.H.dtype, problem.H.device
    Bb, N = x0.shape[0], problem.N
    nu, nx, nc = problem.nu, problem.nx, problem.nc
    nz = nu + nx
    cones3 = projections.normalize_cones(cones)
    tensor = lambda v: torch.as_tensor(v).to(device=dev, dtype=dt)
    one = lambda x: x[..., None].contiguous()       # shared: trailing 1

    # ---- the shared stage streams: ONE copy, whatever B is.
    mask1 = _con_mask(problem, cones).to(dt)                   # (N+1, nc)
    eq1 = torch.isfinite(problem.e_lb) & (problem.e_lb == problem.e_ub)
    scale1 = torch.where(eq1, mask1 * settings.rho_eq_boost, mask1)
    shift = None if soc_shift is None else tensor(soc_shift)
    A_l, B_l = one(problem.A), one(problem.B)
    if problem.c.ndim == 3:
        c_l = cuda_riccati.to_lanes(problem.c.to(dt)).contiguous()
    else:
        c_l = problem.c.to(dt)[..., None].expand(N, nx, Bb).contiguous()
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
    D_l = one(problem.D[:-1])
    h_l = one(problem.h[:-1])
    mask_st = one(scale1[:-1])            # carries the per-row rho scale
    # [lb | ub | rho-scale mask (| shift)] stacked for kernel B.
    bnd_parts = [problem.e_lb[:-1], problem.e_ub[:-1], scale1[:-1]]
    if shift is not None:
        bnd_parts.append(shift[:-1].expand(N, nc))
    bnd_st = one(torch.stack(bnd_parts, dim=1))             # (N, 3+s, nc, 1)
    HNx = problem.H[-1, nu:, nu:] + sigma * torch.eye(nx, dtype=dt, device=dev)
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
    zeros = lambda *shape: torch.zeros(shape, dtype=dt, device=dev)

    def build_shared_factors(rho):
        """Matrix sweep + factor export on the one model (rho is uniform
        over the batch): the matrix half of the iteration never pays B."""
        rho_u = rho[0]
        with full_f32_matmul():
            PN = HNx + term.DNx.T @ ((rho_u * term.scale) * term.DNx)
        K, _, M, _, P, L = cuda_riccati.backward_lanes(
            A_l, B_l, zeros(N, nx, 1), H_l, zeros(N, nz, 1), D_l,
            rho_u * mask_st, zeros(N, nc, 1), one(PN), zeros(nx, 1),
            export_factors=True)
        return K, M, P, L

    def build_split_factors(rho):
        """Factor build + the per-scenario fold Pc = P_{k+1} c — only on
        refactor iterations.  The carry rides packed on the per-stage
        row axis: AK = [A; K], BL = [B; L] for kernel A, MK = [M; K] for
        kernel B."""
        K, M, P, L = build_shared_factors(rho)
        return (torch.cat([A_l, K], dim=1), torch.cat([B_l, L], dim=1),
                torch.cat([M, K], dim=1), cuda_riccati.fold_Pc(P, c_l), rho)

    def fold_hf(wzy, rho):
        """hf = h - sigma w - D^T (rho m z - y) from the packed iterates:
        the fold in tensor code, used at entry and on refactor
        iterations (kernel B emits hf in steady state)."""
        rg = (rho[None, None, :] * mask_st * wzy[:, nz:nz + nc]
              - wzy[:, nz + nc:])
        with full_f32_matmul():
            return (h_l - sigma * wzy[:, :nz]
                    - D_l[..., 0].transpose(1, 2) @ rg)

    if state is None:
        state = _batch_state(problem, Bb, settings)
    # The factor build reads rho[0] and the max-based adaptation only
    # PRESERVES uniformity: a warm start carrying per-instance rho is
    # collapsed to the batch max (the conservative OSQP choice).
    rho = tensor(state.rho).expand(Bb).max().expand(Bb).contiguous()
    l3 = lambda x: torch.movedim(tensor(x), 0, -1)
    w_l, z_l, y_l = l3(state.w), l3(state.z), l3(state.y)
    wzy = torch.cat([w_l[:-1], z_l[:-1], y_l[:-1]], dim=1)
    wN, zN, yN = (x[-1].contiguous() for x in (w_l, z_l, y_l))
    hf = fold_hf(wzy, rho)
    stats = (
        0,
        torch.full((Bb,), -1, dtype=torch.int32, device=dev),
        torch.full((Bb,), float("inf"), dtype=dt, device=dev),
        torch.full((Bb,), float("inf"), dtype=dt, device=dev),
        torch.zeros((Bb,), dtype=torch.bool, device=dev),
    )
    fac = None if state.factors is None else tuple(
        tensor(x) for x in state.factors)
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

        dv = cuda_admm.admm_bwd_vec_prefold_lanes(pN, AK, BL, c_l, Pc, hf,
                                                  nu=nu)
        wzy, hf, xN, res = cuda_admm.admm_fwd_update_lanes(
            rho[None, :], x0_l, MK, None, Hs_l, D_l, bnd_st, None, None,
            None, dv, wzy, nu=nu, cones=cones3, alpha=alpha, sigma=sigma,
            h=h_l)
        wN, zN, yN, rho, stats = _terminal_tail(
            settings, term, cones3, nu, wN, zN, yN, rho, rhoN_m, stats, xN,
            res)
        rho_may_differ = settings.adaptive_rho and stats[0] % interval == 0

    k_it, iter_conv, r_prim, r_dual, conv = stats
    rows = lambda a, b, last: torch.movedim(
        torch.cat([wzy[:, a:b], last[None]], dim=0), -1, 0)
    w_b = rows(0, nz, wN)
    info = ADMMInfo(
        iterations=torch.full((Bb,), k_it, dtype=torch.int32, device=dev),
        r_prim=r_prim, r_dual=r_dual, converged=conv,
        iter_converged=torch.where(iter_conv < 0,
                                   torch.full_like(iter_conv, k_it),
                                   iter_conv),
    )
    return w_b, ADMMState(
        w=w_b, z=rows(nz, nz + nc, zN), y=rows(nz + nc, nz + 2 * nc, yN),
        rho=rho, factors=fac,
    ), info
