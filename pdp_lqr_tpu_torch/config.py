"""Solver configuration and numeric constants (PyTorch port).

Counterpart of ``pdp_lqr_tpu/config.py``.  The constants and
``SolverConfig`` are the same; ``f32_matmul_precision`` becomes
``full_f32_matmul``: on an NVIDIA card the hazard is TF32 (about three
decimal digits in a float32 matrix product), which corrupts the Riccati
recursion the way a narrow default precision does on other accelerators.
PyTorch keeps TF32 off for matmuls by default; the helper refuses to run
solver math when a caller has switched it on.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum

import torch

# Matches clqr::LQR_INFTY / clqr::DIVISION_TOL (typedefs.hpp:23-24).
LQR_INFTY = float("inf")
DIVISION_TOL = 1e-20


@contextlib.contextmanager
def full_f32_matmul():
    """Scope for solver matmuls that must run in full float32.

    Raises if ``torch.backends.cuda.matmul.allow_tf32`` is on: the value
    recursion amplifies a truncated mantissa over the horizon, so a
    library matmul of the port (the ``Pc`` fold, the terminal folds) must
    never silently run in TF32.  Nothing global is changed.
    """
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True: the Riccati "
            "folds need full float32 matmuls; set it to False"
        )
    yield


class CondensedSolverType(enum.Enum):
    """Which factorization solves the inter-segment condensed system.

    Reference: CondensedSystemSolverType{LU, CHOLESKY}
    (lqr_solver_parallel.hpp:14-17).
    """

    LU = "lu"
    CHOLESKY = "cholesky"


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static solver knobs (hashable).

    Attributes:
      dtype: compute dtype for the solver math.
      num_segments: horizon segments for the PDP parallel solver.
      condensed_solver: factorization for the condensed boundary system.
      sigma: ADMM proximal regularization added to every H diagonal
        (reference example value 1e-6, lqr_example.cpp:171).
      rho_dyn: regularization on dynamics-dual rows of the KKT backend.
      alpha_relax: ADMM over-relaxation.
      rho: default penalty for constraint rows (example value 0.01).
    """

    dtype: torch.dtype = torch.float32
    num_segments: int = 4
    condensed_solver: CondensedSolverType = CondensedSolverType.CHOLESKY
    sigma: float = 1e-6
    rho_dyn: float = 1e-6
    alpha_relax: float = 1.6
    rho: float = 0.01
