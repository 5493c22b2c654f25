"""Centroidal MPC with friction-cone contacts — BASELINE.json config #5.

PyTorch port of ``pdp_lqr_tpu/models/centroidal.py``; same data, same
return value, plus an explicit ``device=``.

Simplified centroidal dynamics: state = [com position, com velocity,
angular momentum] (nx = 9, padded to 24 with integrator chains for the
baseline shape), controls = contact forces at n_feet contact points
(nu = 3 * n_feet).  Each contact force f = (fx, fy, fz) must satisfy the
friction cone ||(fx, fy)|| <= mu * fz, expressed as one second-order
cone of 3 rows per foot per stage.
"""

from __future__ import annotations

import numpy as np
import torch

from pdp_lqr_tpu_torch.problem import build_problem


def centroidal(
    N: int = 1024,
    n_feet: int = 2,
    dt: float = 0.02,
    mass: float = 30.0,
    mu: float = 0.7,
    nx_pad: int = 24,
    dtype=torch.float64,
    device="cuda",
):
    """Returns (problem, cone_specs) with one friction cone per foot."""
    nx0 = 9
    nu = 3 * n_feet
    nx = max(nx_pad, nx0)
    nz = nx + nu
    g = 9.81

    A = np.eye(nx)
    # com position integrates velocity
    A[0:3, 3:6] = dt * np.eye(3)
    # pad dims form a slow decaying chain so A stays stable
    for i in range(nx0, nx):
        A[i, i] = 0.95
    B = np.zeros((nx, nu))
    feet = [np.array([0.2 * (1 if i % 2 == 0 else -1),
                      0.1 * (1 if i < 2 else -1), 0.0])
            for i in range(n_feet)]
    for i, p in enumerate(feet):
        # com velocity: sum of forces / m
        B[3:6, 3 * i:3 * i + 3] = dt / mass * np.eye(3)
        # angular momentum: r x f
        rx = np.array([
            [0.0, -p[2], p[1]],
            [p[2], 0.0, -p[0]],
            [-p[1], p[0], 0.0],
        ])
        B[6:9, 3 * i:3 * i + 3] = dt * rx
    c = np.zeros(nx)
    c[5] = -dt * g  # gravity on vertical com velocity

    Q = np.diag([50.0] * 3 + [1.0] * 3 + [1.0] * 3 + [0.01] * (nx - nx0))
    R = 1e-4 * np.eye(nu)
    x_ref = np.zeros(nx)
    x_ref[2] = 0.55  # target com height
    q = -Q @ x_ref
    r = np.zeros(nu)
    # bias controls toward supporting weight
    for i in range(n_feet):
        r[3 * i + 2] = -1e-4 * mass * g / n_feet

    # Friction cones: per foot, rows [mu * fz; fx; fy] with t-row first.
    D = np.zeros((3 * n_feet, nz))
    for i in range(n_feet):
        D[3 * i + 0, 3 * i + 2] = mu   # t = mu * fz
        D[3 * i + 1, 3 * i + 0] = 1.0  # fx
        D[3 * i + 2, 3 * i + 1] = 1.0  # fy
    inf = np.inf
    e_lb = np.full(3 * n_feet, -inf)
    e_ub = np.full(3 * n_feet, inf)

    problem = build_problem(
        A=A, B=B, c=c, Q=Q, R=R, q=q, r=r, N=N, dtype=dtype, device=device,
        D=D, e_lb=e_lb, e_ub=e_ub,
    )
    cone_specs = [(3 * i, 3) for i in range(n_feet)]
    return problem, cone_specs
