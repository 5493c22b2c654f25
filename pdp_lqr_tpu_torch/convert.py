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
from pdp_lqr_tpu_torch.solvers.admm import ADMMState


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


def state_from_numpy(fields, *, device="cuda", dtype=None) -> ADMMState:
    """A JAX ``ADMMState`` as a mapping with keys w, z, y, rho and
    (optionally) factors -> the port's, so that one package's state can
    warm-start the other.  ``w, z, y, rho`` cross whole.  Split-mode
    factors ``(AK, BL, MK, Pc, rho_f)`` cross like the shared factors
    above: index 0 of the trailing axis of the three shared streams,
    ``Pc`` and ``rho_f`` (per scenario) whole."""
    factors = fields.get("factors")
    if factors is not None:
        AK, BL, MK, Pc, rho_f = factors
        factors = factors_from_numpy((AK, BL, MK), device=device,
                                     dtype=dtype) + (
            _tensor(Pc, device, dtype), _tensor(rho_f, device, dtype))
    return ADMMState(
        **{k: _tensor(fields[k], device, dtype) for k in ("w", "z", "y", "rho")},
        factors=factors)


def state_to_numpy(state: ADMMState) -> dict:
    """The port's ``ADMMState`` as a mapping of numpy arrays (keys w, z,
    y, rho, factors).  The shared factor streams keep their trailing
    size 1: a consumer that wants them W lanes wide repeats them."""
    out = lambda x: x.detach().cpu().numpy()
    return {
        "w": out(state.w), "z": out(state.z), "y": out(state.y),
        "rho": out(state.rho),
        "factors": None if state.factors is None
        else tuple(out(x) for x in state.factors),
    }
