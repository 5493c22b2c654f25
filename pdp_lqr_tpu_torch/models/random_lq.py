"""Random well-conditioned LQ instances for randomized parity testing.

PyTorch port of ``pdp_lqr_tpu/models/random_lq.py``: the numbers come
from the same numpy generator, so a seed gives the same instance in both
packages.
"""

from __future__ import annotations

import numpy as np
import torch

from pdp_lqr_tpu_torch.problem import LQRProblem


def random_lq(
    nx: int,
    nu: int,
    N: int,
    nc: int = 0,
    seed: int = 0,
    dtype=torch.float64,
    device="cuda",
) -> LQRProblem:
    """Time-varying random LQ problem with SPD-ish stage costs.

    Dynamics are scaled to spectral radius ~<= 1 so horizons stay well
    conditioned; costs are H = G G^T + eps*I (SPSD + regularizable),
    mirroring what the ADMM fold guarantees the solvers see.
    """
    rng = np.random.default_rng(seed)
    nz = nx + nu

    A = rng.normal(size=(N, nx, nx))
    A /= np.abs(np.linalg.eigvals(A)).max(axis=-1)[:, None, None] * 1.1
    B = rng.normal(size=(N, nx, nu)) * 0.5
    c = rng.normal(size=(N, nx)) * 0.1

    G = rng.normal(size=(N + 1, nz, nz)) * 0.3
    H = G @ np.swapaxes(G, -1, -2) + 0.5 * np.eye(nz)
    H[N, :nu, :] = 0.0
    H[N, :, :nu] = 0.0
    H[N, nu:, nu:] += 0.5 * np.eye(nx)
    h = rng.normal(size=(N + 1, nz)) * 0.3
    h[N, :nu] = 0.0

    D = np.zeros((N + 1, nc, nz))
    e_lb = np.zeros((N + 1, nc))
    e_ub = np.zeros((N + 1, nc))
    if nc > 0:
        D = rng.normal(size=(N + 1, nc, nz)) * 0.5
        D[N, :, :nu] = 0.0  # terminal constraints act on x only
        mid = rng.normal(size=(N + 1, nc))
        width = rng.uniform(0.1, 1.0, size=(N + 1, nc))
        e_lb = mid - width
        e_ub = mid + width

    cast = lambda x: torch.as_tensor(x).to(device=device, dtype=dtype)
    return LQRProblem(
        A=cast(A), B=cast(B), c=cast(c), H=cast(H), h=cast(h),
        D=cast(D), e_lb=cast(e_lb), e_ub=cast(e_ub),
    )
