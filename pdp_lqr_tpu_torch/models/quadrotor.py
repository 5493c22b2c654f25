"""Quadrotor hover MPC (nx=12, nu=4) — the reference's example problem.

PyTorch port of ``pdp_lqr_tpu/models/quadrotor.py``; same data, same
return value, plus an explicit ``device=``.

The dynamics/cost data are the public OSQP MPC example
(https://osqp.org/docs/release-0.6.3/examples/mpc.html), which the
reference example program also uses (examples/lqr_example.cpp:50-120).
With ``constrained=True`` the stage box constraints of that example are
attached; ``thrust_cone=True`` additionally adds a second-order-cone
constraint on the thrust vector — the "conic"
capability the reference's released code leaves to its missing outer
loop.
"""

from __future__ import annotations

import numpy as np
import torch

from pdp_lqr_tpu_torch.problem import build_problem

_INF = np.inf

QUADROTOR_X0 = np.zeros(12)
QUADROTOR_XREF = np.array([0.0, 0.0, 1.0] + [0.0] * 9)

_A = np.array([
    [1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.1, 0.0, 0.0, 0.0, 0.0, 0.0],
    [0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.1, 0.0, 0.0, 0.0, 0.0],
    [0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.1, 0.0, 0.0, 0.0],
    [0.0488, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0016, 0.0, 0.0, 0.0992, 0.0, 0.0],
    [0.0, -0.0488, 0.0, 0.0, 1.0, 0.0, 0.0, -0.0016, 0.0, 0.0, 0.0992, 0.0],
    [0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0992],
    [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0],
    [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0],
    [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0],
    [0.9734, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0488, 0.0, 0.0, 0.9846, 0.0, 0.0],
    [0.0, -0.9734, 0.0, 0.0, 0.0, 0.0, 0.0, -0.0488, 0.0, 0.0, 0.9846, 0.0],
    [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.9846],
])

_B = np.array([
    [0.0, -0.0726, 0.0, 0.0726],
    [-0.0726, 0.0, 0.0726, 0.0],
    [-0.0152, 0.0152, -0.0152, 0.0152],
    [-0.0, -0.0006, -0.0, 0.0006],
    [0.0006, 0.0, -0.0006, 0.0],
    [0.0106, 0.0106, 0.0106, 0.0106],
    [0.0, -1.4512, 0.0, 1.4512],
    [-1.4512, 0.0, 1.4512, 0.0],
    [-0.3049, 0.3049, -0.3049, 0.3049],
    [-0.0, -0.0236, 0.0, 0.0236],
    [0.0236, 0.0, -0.0236, 0.0],
    [0.2107, 0.2107, 0.2107, 0.2107],
])

_X_MIN = np.array([-0.52359878, -0.52359878, -_INF, -_INF, -_INF, -1.0,
                   -_INF, -_INF, -_INF, -_INF, -_INF, -_INF])
_X_MAX = np.array([0.52359878, 0.52359878, _INF, _INF, _INF, _INF,
                   _INF, _INF, 2.5, _INF, _INF, _INF])
_U_MIN = np.array([-0.9916] * 4)
_U_MAX = np.array([2.4084] * 4)


def quadrotor(
    N: int = 100,
    constrained: bool = False,
    thrust_cone: bool = False,
    dtype=torch.float64,
    device="cuda",
):
    """Build the quadrotor MPC problem.

    Returns (problem, cone_specs) where cone_specs is the per-row cone
    description consumed by the ADMM projection (None when no cones).
    """
    nx, nu = 12, 4
    Q = np.zeros((nx, nx))
    np.fill_diagonal(Q, [0.0, 0.0, 10.0, 10.0, 10.0, 10.0,
                         0.0, 0.0, 0.0, 5.0, 5.0, 5.0])
    R = np.diag([0.1] * 4)
    q = -Q @ QUADROTOR_XREF
    r = np.zeros(nu)

    kwargs = {}
    if constrained or thrust_cone:
        nz = nx + nu
        rows = []
        lb, ub = [], []
        if constrained:
            # u box + x box (the reference example's intended stage
            # constraints, lqr_example.cpp:142-154).
            Du = np.zeros((nu, nz)); Du[:, :nu] = np.eye(nu)
            Dx = np.zeros((nx, nz)); Dx[:, nu:] = np.eye(nx)
            rows += [Du, Dx]
            lb += [_U_MIN, _X_MIN]
            ub += [_U_MAX, _X_MAX]
        if thrust_cone:
            # ||(u1 - u3, u2 - u4)|| <= beta * (u_total + 4*hover):
            # 3 rows [t; v] forming one second-order cone per stage.
            beta = 2.0
            Dc = np.zeros((3, nz))
            Dc[0, :nu] = beta * np.ones(nu)  # t row
            Dc[1, 0], Dc[1, 2] = 1.0, -1.0
            Dc[2, 1], Dc[2, 3] = 1.0, -1.0
            rows.append(Dc)
            lb.append(np.full(3, -_INF))
            ub.append(np.full(3, _INF))
        D = np.concatenate(rows, axis=0)
        kwargs = dict(
            D=D,
            e_lb=np.concatenate(lb),
            e_ub=np.concatenate(ub),
        )

    problem = build_problem(
        A=_A, B=_B, c=np.zeros(nx), Q=Q, R=R, q=q, r=r,
        QN=Q, qN=q, N=N, dtype=dtype, device=device, **kwargs,
    )

    cone_specs = None
    if thrust_cone:
        offset = (nu + nx) if constrained else 0
        cone_specs = [(offset, 3)]
    return problem, cone_specs
