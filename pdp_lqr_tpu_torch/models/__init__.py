"""Benchmark / example problem families (PyTorch port).

Ported so far: the quadrotor MPC (the serving workload), the rocket
soft landing (two second-order cones a stage), the double integrator and
random LQ instances (small models for parity tests).
"""

from pdp_lqr_tpu_torch.models.double_integrator import double_integrator
from pdp_lqr_tpu_torch.models.quadrotor import quadrotor, QUADROTOR_X0
from pdp_lqr_tpu_torch.models.random_lq import random_lq
from pdp_lqr_tpu_torch.models.rocket import rocket, rocket_x0

__all__ = [
    "double_integrator",
    "quadrotor",
    "QUADROTOR_X0",
    "random_lq",
    "rocket",
    "rocket_x0",
]
