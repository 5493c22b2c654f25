"""Carry problem data across from the JAX package, by way of numpy.

The port imports nothing of ``pdp_lqr_tpu``.  Its data crosses over as
plain dicts / tuples of numpy arrays (``dataclasses.asdict`` of a JAX
pytree, mapped through ``numpy.asarray``), and becomes the port's frozen
dataclasses here.  The parity tests use these functions so that both
packages compute on identical numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from pdp_lqr_tpu_torch.problem import ADMMIterates, LQRProblem


def _tensor(x, device, dtype):
    # torch.tensor copies: the result never aliases a (maybe read-only)
    # array that another framework owns.
    return torch.tensor(np.asarray(x)).to(device=device, dtype=dtype)


def problem_from_numpy(fields, *, device="cuda", dtype=None) -> LQRProblem:
    """``fields``: mapping with keys A, B, c, H, h, D, e_lb, e_ub.
    ``dtype=None`` keeps each array's own dtype."""
    return LQRProblem(**{
        k: _tensor(fields[k], device, dtype)
        for k in ("A", "B", "c", "H", "h", "D", "e_lb", "e_ub")
    })


def iterates_from_numpy(fields, *, device="cuda", dtype=None) -> ADMMIterates:
    """``fields``: mapping with keys w, y, z, rho."""
    return ADMMIterates(**{
        k: _tensor(fields[k], device, dtype) for k in ("w", "y", "z", "rho")
    })


def factors_from_numpy(factors, *, device="cuda", dtype=None):
    """Shared factors ``(K, M, P, L)`` of the JAX package's
    ``shared_factors`` -> the port's.  The JAX tensors carry the one
    model replicated over their trailing axis; the port keeps a single
    copy, so only index 0 of that axis crosses over (trailing size 1)."""
    return tuple(
        _tensor(np.asarray(x)[..., :1], device, dtype).contiguous()
        for x in factors
    )
