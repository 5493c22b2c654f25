"""Receding-horizon MPC helpers (PyTorch port of ``pdp_lqr_tpu/mpc.py``).

Ported so far: ``shift_state``, the one-stage shift of the ADMM state
that warm-starts the next replan.  The replan and simulation loops
follow with the realtime operators.
"""

from __future__ import annotations

import torch

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
