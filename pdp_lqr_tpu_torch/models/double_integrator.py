"""Double-integrator LQR (nx=2, nu=1).

PyTorch port of ``pdp_lqr_tpu/models/double_integrator.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from pdp_lqr_tpu_torch.problem import LQRProblem, build_problem


def double_integrator(
    N: int = 100,
    dt: float = 0.1,
    constrained: bool = False,
    u_max: float = 1.0,
    dtype=torch.float64,
    device="cuda",
) -> LQRProblem:
    A = np.array([[1.0, dt], [0.0, 1.0]])
    B = np.array([[0.5 * dt * dt], [dt]])
    Q = np.diag([1.0, 0.1])
    R = np.array([[0.01]])
    q = np.array([-1.0, 0.0])  # track position 1
    kwargs = {}
    if constrained:
        # |u| <= u_max at every non-terminal stage.
        kwargs = dict(
            D=np.array([[1.0, 0.0, 0.0]]),
            e_lb=np.array([-u_max]),
            e_ub=np.array([u_max]),
        )
    return build_problem(
        A=A, B=B, c=np.zeros(2), Q=Q, R=R, q=q, r=np.zeros(1),
        N=N, dtype=dtype, device=device, **kwargs,
    )
