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

from pdp_lqr_tpu_torch.ops.condensed import CholeskyCondensedFactors
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


def pdp_factors_from_numpy(factors, *, device="cuda", dtype=None):
    """The segment-parallel solver's cached factors ``(K, M, Gp, P, L, F,
    fac)`` -> the port's (``parallel.pdp_sharded_fused``'s
    ``segment_solve_cached`` takes them).  The six stage tensors cross
    whole, batch-last over the full horizon (N, ..., B) — the JAX
    package's per-device shards joined along the "time" axis; ``fac``, the
    condensed Cholesky factors, is a mapping with keys Pchol, Cchol, Pinv,
    Asolved and A, each (B, S, nx, nx)."""
    *stages, fac = factors
    return tuple(_tensor(x, device, dtype).contiguous() for x in stages) + (
        CholeskyCondensedFactors(**{
            k: _tensor(fac[k], device, dtype)
            for k in ("Pchol", "Cchol", "Pinv", "Asolved", "A")}),)


def state_from_numpy(fields, *, device="cuda", dtype=None) -> ADMMState:
    """A JAX ``ADMMState`` as a mapping with keys w, z, y, rho and
    (optionally) factors -> the port's, so that one package's state can
    warm-start the other.  ``w, z, y, rho`` cross whole, and so does
    ``rho_f``, the last factor.  The shared factor streams cross like the
    shared factors above, index 0 of their trailing axis: the split mode's
    ``(AK, BL, MK, Pc, rho_f)`` (``Pc`` is per scenario and crosses whole)
    and the single-kernel mode's ``(K, M, P, L, rho_f)`` on one model (told
    apart by the fourth factor: ``Pc`` has three axes, ``L`` four).  A
    batched problem's factors are per scenario and do not cross: they are
    refused."""
    factors = fields.get("factors")
    if factors is not None:
        *streams, rho_f = factors
        n_shared = 3 if np.ndim(streams[3]) == 3 else 4
        for x in streams[:n_shared]:
            if np.ptp(np.asarray(x), axis=-1).max() > 0:
                raise ValueError("factors that differ by scenario (a batched "
                                 "problem's) do not cross; pass none")
        factors = factors_from_numpy(streams[:n_shared], device=device,
                                     dtype=dtype) + tuple(
            _tensor(x, device, dtype) for x in streams[n_shared:]) + (
            _tensor(rho_f, device, dtype),)
    return ADMMState(
        **{k: _tensor(fields[k], device, dtype) for k in ("w", "z", "y", "rho")},
        factors=factors)


def state_to_numpy(state: ADMMState) -> dict:
    """The port's ``ADMMState`` as a mapping of numpy arrays (keys w, z,
    y, rho, factors).  The shared factor streams (trailing size 1) are
    broadcast over the batch, the width the JAX package's iterations take
    them at (a read-only view, no copy)."""
    out = lambda x: x.detach().cpu().numpy()
    Bb = state.rho.shape[-1]
    wide = lambda x: np.broadcast_to(x, x.shape[:-1] + (Bb,)) \
        if x.ndim == 4 and x.shape[-1] == 1 else x
    return {
        "w": out(state.w), "z": out(state.z), "y": out(state.y),
        "rho": out(state.rho),
        "factors": None if state.factors is None
        else tuple(wide(out(x)) for x in state.factors),
    }
