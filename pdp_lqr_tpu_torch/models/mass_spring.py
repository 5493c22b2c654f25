"""Mass-spring-damper chain LQR — BASELINE.json config #2 (nx=40, nu=10).

PyTorch port of ``pdp_lqr_tpu/models/mass_spring.py``; same data, plus an
explicit ``device=``.
"""

from __future__ import annotations

import numpy as np
import torch

from pdp_lqr_tpu_torch.problem import LQRProblem, build_problem


def mass_spring_chain(
    n_masses: int = 20,
    n_actuated: int = 10,
    N: int = 200,
    dt: float = 0.05,
    k_spring: float = 1.0,
    c_damp: float = 0.1,
    dtype=torch.float64,
    device="cuda",
) -> LQRProblem:
    """Chain of masses with springs/dampers between neighbors.

    State = [positions; velocities] (nx = 2*n_masses); the first
    ``n_actuated`` masses are force-actuated.  Discretized with
    forward Euler (stable at the default dt for these parameters).
    """
    n = n_masses
    nx, nu = 2 * n, n_actuated
    K = np.zeros((n, n))
    for i in range(n):
        K[i, i] = -2.0 * k_spring
        if i > 0:
            K[i, i - 1] = k_spring
        if i + 1 < n:
            K[i, i + 1] = k_spring
    Ac = np.block([
        [np.zeros((n, n)), np.eye(n)],
        [K, -c_damp * np.eye(n)],
    ])
    Bc = np.zeros((nx, nu))
    Bc[n:n + nu, :nu] = np.eye(nu)
    A = np.eye(nx) + dt * Ac
    B = dt * Bc
    Q = np.eye(nx)
    R = 0.1 * np.eye(nu)
    q = np.zeros(nx)
    q[:n] = -1.0  # drive all positions toward 1
    return build_problem(
        A=A, B=B, c=np.zeros(nx), Q=Q, R=R, q=q, r=np.zeros(nu),
        N=N, dtype=dtype, device=device,
    )
