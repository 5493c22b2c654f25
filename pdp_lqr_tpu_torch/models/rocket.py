"""Rocket soft-landing MPC (nx=6, nu=3): the conic showcase problem.

PyTorch port of ``pdp_lqr_tpu/models/rocket.py``; same data, same return
values, plus an explicit ``device=``.

A 3-DoF point-mass powered-descent model in the style of the classical
convex powered-landing formulation (Acikmese & Ploen, JGCD 2007; the
"lossless convexification" landing problem), reduced to the LQ-tracking
+ row-wise-conic form this framework consumes:

  * dynamics: discrete double integrator with gravity drift
      r+ = r + dt v + dt^2/(2m) T - dt^2/2 g e3
      v+ = v + dt/m T - dt g e3
  * thrust gimbal cone (SOC, 3 rows per stage):
      ||(Tx, Ty)|| <= tan(gimbal) * Tz
  * glideslope cone (SOC, 3 rows per stage):
      ||(rx, ry)|| <= tan(glideslope) * rz
  * thrust box: t_min <= Tz <= t_max (a one-sided row at t_min = 0)
  * cost: quadratic tracking of the pad (origin, zero velocity) plus
    a linear fuel term on Tz.
"""

from __future__ import annotations

import numpy as np
import torch

from pdp_lqr_tpu_torch.problem import build_problem

_INF = np.inf


def rocket(
    N: int = 64,
    dt: float = 0.5,
    mass: float = 10.0,
    g: float = 3.71,                 # Mars landing, the classical setting
    t_max: float = 80.0,
    t_min: float = 0.0,
    gimbal_deg: float = 20.0,
    glideslope_deg: float = 45.0,
    fuel_weight: float = 0.05,
    dtype=torch.float64,
    device="cuda",
):
    """Build the landing problem.

    Returns (problem, cone_specs): cone_specs has the gimbal SOC and
    the glideslope SOC (offsets into the per-stage constraint rows).
    """
    nx, nu = 6, 3
    nz = nu + nx

    A = np.eye(nx)
    A[:3, 3:] = dt * np.eye(3)
    B = np.zeros((nx, nu))
    B[:3, :] = (dt * dt / (2.0 * mass)) * np.eye(3)
    B[3:, :] = (dt / mass) * np.eye(3)
    c = np.zeros(nx)
    c[2] = -0.5 * g * dt * dt
    c[5] = -g * dt

    # Track the pad; the linear Tz cost stands in for burned impulse.
    Q = np.diag([1.0, 1.0, 1.0, 2.0, 2.0, 2.0])
    R = np.diag([0.02, 0.02, 0.02])
    q = np.zeros(nx)
    r = np.array([0.0, 0.0, fuel_weight])
    QN = np.diag([50.0, 50.0, 50.0, 100.0, 100.0, 100.0])
    qN = np.zeros(nx)

    tan_gim = np.tan(np.deg2rad(gimbal_deg))
    tan_gs = np.tan(np.deg2rad(glideslope_deg))

    # Rows (order = [u; x] columns):
    #   0     : Tz box               t_min <= Tz <= t_max
    #   1..3  : gimbal SOC           [tan_gim*Tz; Tx; Ty]
    #   4..6  : glideslope SOC       [tan_gs*rz; rx; ry]
    D = np.zeros((7, nz))
    D[0, 2] = 1.0
    D[1, 2] = tan_gim
    D[2, 0] = 1.0
    D[3, 1] = 1.0
    D[4, nu + 2] = tan_gs
    D[5, nu + 0] = 1.0
    D[6, nu + 1] = 1.0
    lb = np.array([t_min] + [-_INF] * 6)
    ub = np.array([t_max] + [_INF] * 6)

    # Terminal stage: the glideslope only, in x-only row form (the pad,
    # rz = 0, is the cone's vertex); rows 0..3 are zero there.
    DN = np.zeros((7, nx))
    DN[4:, :] = D[4:, nu:]
    lbN = np.full(7, -_INF)
    ubN = np.full(7, _INF)

    problem = build_problem(
        A=A, B=B, c=c, Q=Q, R=R, q=q, r=r, QN=QN, qN=qN,
        D=D, e_lb=lb, e_ub=ub, DN=DN, e_lbN=lbN, e_ubN=ubN,
        N=N, dtype=dtype, device=device,
    )
    cone_specs = [(1, 3), (4, 3)]
    return problem, cone_specs


def rocket_x0(batch: int | None = None, seed: int = 0, dtype=torch.float64,
              device="cuda"):
    """Dispersed entry states: offset, high, descending toward the pad.

    Single (nx,) state when ``batch`` is None, else (batch, nx) with
    randomized lateral offset and descent rate (Monte-Carlo dispersion
    of the guidance entry point), drawn with numpy from ``seed``.
    """
    base = np.array([40.0, 30.0, 90.0, -1.0, -0.5, -8.0])
    if batch is None:
        return torch.as_tensor(base).to(device=device, dtype=dtype)
    rng = np.random.default_rng(seed)
    disp = np.zeros((batch, 6))
    disp[:, :2] = rng.normal(size=(batch, 2)) * 8.0
    disp[:, 2] = rng.normal(size=batch) * 5.0
    disp[:, 3:] = rng.normal(size=(batch, 3)) * 0.8
    return torch.as_tensor(base[None, :] + disp).to(device=device, dtype=dtype)
