"""Benchmark / example problem families (PyTorch port).

The quadrotor MPC (the serving workload), the mass-spring-damper chain
(nx=40, nu=10, the widest state), the centroidal MPC (one friction cone a
foot), the rocket soft landing (two second-order cones a stage), the
double integrator and random LQ instances (small models for parity
tests): every family of the JAX package.
"""

from pdp_lqr_tpu_torch.models.double_integrator import double_integrator
from pdp_lqr_tpu_torch.models.quadrotor import quadrotor, QUADROTOR_X0
from pdp_lqr_tpu_torch.models.mass_spring import mass_spring_chain
from pdp_lqr_tpu_torch.models.random_lq import random_lq
from pdp_lqr_tpu_torch.models.centroidal import centroidal
from pdp_lqr_tpu_torch.models.rocket import rocket, rocket_x0

__all__ = [
    "double_integrator",
    "quadrotor",
    "QUADROTOR_X0",
    "mass_spring_chain",
    "random_lq",
    "centroidal",
    "rocket",
    "rocket_x0",
]
