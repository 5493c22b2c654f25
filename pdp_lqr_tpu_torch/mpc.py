"""Receding-horizon MPC harness with warm starts (PyTorch port of
``pdp_lqr_tpu/mpc.py``).

The reference has no MPC loop; its enabling feature is the factorization
cache across ADMM iterations (the ``*_without_factorization`` API,
lqr_solver.hpp:65-70), which this harness extends across *replan steps*:
the ADMM state (w, z, y, rho) of one solve warm-starts the next after a
one-stage shift, so steady-state replans converge in a handful of
iterations.

Everything is a function of (problem, x_measured, carry-state).  The JAX
package runs a closed loop as one ``lax.scan``; here the loop over ticks
runs on the host, and the plant state, controls and warm state stay on
the problem's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from pdp_lqr_tpu_torch.ops import projections
from pdp_lqr_tpu_torch.problem import LQRProblem
from pdp_lqr_tpu_torch.solvers import admm


def shift_state(state: admm.ADMMState, problem: LQRProblem) -> admm.ADMMState:
    """Shift ADMM iterates one stage forward (standard MPC warm start).

    The last stage is duplicated (steady-state extrapolation); rho is
    kept so cached-cadence refactors stay valid across replans.

    Works on per-instance states (w (N+1, nz)) and batch-leading
    batched states (w (B, N+1, nz)): the time axis is always -2.
    """
    shift = lambda a: torch.cat([a[..., 1:, :], a[..., -1:, :]], dim=-2)
    return admm.ADMMState(
        w=shift(state.w), z=shift(state.z), y=shift(state.y),
        rho=state.rho,
        # Factors depend only on (problem, rho) — both unchanged by the
        # shift — so warm replans keep skipping refactorization.
        factors=state.factors,
    )


def replan(
    problem: LQRProblem,
    x_measured,
    state: Optional[admm.ADMMState],
    cones: Sequence[projections.ConeSpec] = (),
    settings: admm.ADMMSettings = admm.ADMMSettings(),
):
    """One MPC replan: warm-started ``admm.solve`` from the measured
    state.  Returns (u0, ws, new_state, info)."""
    ws, new_state, info = admm.solve(
        problem, x_measured, cones=cones, settings=settings, state=state)
    u0 = ws[0, : problem.nu]
    return u0, ws, new_state, info


def replan_realtime(
    problem: LQRProblem,
    x_measured,
    state: Optional[admm.ADMMState],
    operator,
    cones: Sequence[projections.ConeSpec] = (),
    settings: admm.ADMMSettings = admm.ADMMSettings(),
):
    """One 1 kHz-class replan through the operator path.

    ``operator`` comes from solvers.realtime.build_operator (rebuild on
    rho / problem changes).  Early-exits on convergence, so steady-state
    replans cost a few iterations.  Returns (u0, ws, state, info).
    """
    from pdp_lqr_tpu_torch.solvers import realtime

    ws, new_state, info = realtime.solve(
        problem, x_measured, operator, cones, settings, state)
    u0 = ws[0, : problem.nu]
    return u0, ws, new_state, info


def _closed_loop(problem, x0, n_steps, settings, process_noise, replan_tick):
    """Replan -> apply u0 -> step the stage-0 plant, ``n_steps`` times;
    ``replan_tick(x, state) -> (ws, state, info)``.
    Returns (xs (n_steps+1, nx), us (n_steps, nu), infos stacked)."""
    dt, dev = problem.A.dtype, problem.A.device
    A0, B0, c0 = problem.A[0], problem.B[0], problem.c[0]
    if process_noise is None:
        process_noise = torch.zeros((n_steps, problem.nx), dtype=dt,
                                    device=dev)
    x = torch.as_tensor(x0, dtype=dt, device=dev)
    st = admm.init_state(problem, settings)
    xs, us, infos = [], [], []
    for t in range(n_steps):
        ws, st_new, info = replan_tick(x, st)
        u0 = ws[0, :problem.nu]
        xs.append(x)
        us.append(u0)
        infos.append(info)
        x = A0 @ x + B0 @ u0 + c0 + process_noise[t]
        st = shift_state(st_new, problem)
    xs.append(x)
    stacked = admm.ADMMInfo(**{
        f.name: torch.stack([getattr(i, f.name) for i in infos])
        for f in dataclasses.fields(admm.ADMMInfo)})
    return torch.stack(xs), torch.stack(us), stacked


def simulate_realtime(
    problem: LQRProblem,
    x0,
    n_steps: int,
    cones: Sequence[projections.ConeSpec] = (),
    settings: admm.ADMMSettings = admm.ADMMSettings(),
    process_noise: Optional[torch.Tensor] = None,
):
    """Closed-loop rollout on the real-time operator path.

    Same contract as ``simulate`` but every replan is the early-exit
    operator solve — the shape of a production 1 kHz loop.  The operator
    is built once before the loop (rho fixed), and the replans go through
    one ``realtime.replan_fn`` (on the card, its iteration is a CUDA
    graph).
    """
    from pdp_lqr_tpu_torch.solvers import realtime

    cones = tuple(cones)
    op = realtime.build_operator(problem, settings.rho, settings, cones)
    return _closed_loop(problem, x0, n_steps, settings, process_noise,
                        realtime.replan_fn(problem, op, cones, settings))


def simulate(
    problem: LQRProblem,
    x0,
    n_steps: int,
    cones: Sequence[projections.ConeSpec] = (),
    settings: admm.ADMMSettings = admm.ADMMSettings(),
    process_noise: Optional[torch.Tensor] = None,
):
    """Closed-loop rollout: replan -> apply u0 -> step true dynamics.

    The plant model is the problem's stage-0 dynamics (time-invariant
    assumption for the closed-loop plant; the *predictions* may still be
    time-varying).  ``process_noise`` is an optional (n_steps, nx)
    additive disturbance.

    Returns (xs (n_steps+1, nx), us (n_steps, nu), infos) — ``infos`` is
    an ADMMInfo whose fields are stacked over the ticks.
    """
    cones = tuple(cones)
    return _closed_loop(
        problem, x0, n_steps, settings, process_noise,
        lambda x, st: replan(problem, x, st, cones, settings)[1:])
