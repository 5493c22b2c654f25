"""Data-parallel fused solves: the batch over every rank — PyTorch port of
``pdp_lqr_tpu/parallel/fused_dp.py``.

The serving configuration at scale: problem instances split over every
rank of the mesh (pure data parallelism, no collective), each rank
running the port's kernels on its own scenarios.  JAX passes global
arrays that ``shard_map`` splits; here every rank passes the whole batch
(the same on every rank, as a JAX caller passes a global array) and gets
its own rows back: rank r of a world of n holds rows [r B/n, (r+1) B/n),
JAX's ``P(("batch", "time"))`` order.  A warm ``state`` may be the whole
batch's or this rank's rows (what a call returns).  On a one-card mesh
(``make_mesh``) a call is the unsharded call.

For horizon sharding (a "time" axis) use ``admm_sharded.solve``, which
exchanges segment boundary factors every iteration (the single-kernel
iteration cannot: its backward and forward sweeps are one launch).
"""

from __future__ import annotations

import dataclasses

import torch

from pdp_lqr_tpu_torch.ops import cuda_riccati as cr


def _rows(mesh, B: int) -> slice:
    n = mesh.size if mesh.ranked else 1
    if B % n:
        raise ValueError(f"batch B={B} is not divisible by the mesh's {n} ranks")
    return mesh.rows(B, over="all")


def _take(x, rows, B):
    """This rank's rows of a batched tensor (the whole batch's, or already
    this rank's)."""
    x = torch.as_tensor(x)
    if x.shape[0] == B:
        return x[rows]
    if x.shape[0] != rows.stop - rows.start:
        raise ValueError(f"leading size {x.shape[0]} is neither the batch {B} "
                         f"nor this rank's {rows.stop - rows.start}")
    return x


def solve(mesh, problem, it, x0, sigma: float):
    """Batched inner solve, the batch split over every rank.

    problem/it: batched records (leading axis B, divisible by the mesh's
    rank count); x0 (B, nx).  Each rank runs ``cuda_riccati.solve_lanes``
    (K1 without closed-loop maps, then K7) on its rows on mesh.device and
    returns their ws (B/n, N+1, nz).
    """
    B = problem.h.shape[0]
    rows = _rows(mesh, B)
    take = lambda rec: type(rec)(**{f.name: _take(getattr(rec, f.name), rows, B)
                                    for f in dataclasses.fields(rec)})
    dev = mesh.device
    return cr.solve_lanes(take(problem).to(device=dev), take(it).to(device=dev),
                          _take(x0, rows, B).to(device=dev), sigma)


def solve_fused_dp(mesh, problem, x0, cones=(), settings=None, state=None,
                   soc_shift=None, *, single_kernel="auto",
                   storage_dtype=None):
    """The full conic ADMM loop (``solvers.admm.solve_fused``), the batch
    split over every rank: no collective, the projections, duals,
    residuals and per-instance rho being instance-local.

    ``problem`` batched (every field with a leading B), or one model
    (unbatched, serving the B scenarios of x0; a per-scenario drift c
    (B, N, nx) is split too): on one model ``single_kernel=False`` runs
    the shared split pair (K1, K4, K5) on each rank, on a batched problem
    the replicated loop; ``single_kernel=True`` (or "auto") K8;
    ``storage_dtype`` as ``solve_fused``.  ``x0`` (B, nx), ``state`` (if
    given) batched; ``soc_shift`` replicated.

    Returns (ws, ADMMState, ADMMInfo) of this rank's rows.
    """
    from pdp_lqr_tpu_torch.solvers import admm

    if settings is None:
        settings = admm.ADMMSettings()
    x0 = torch.as_tensor(x0)
    B = x0.shape[0]
    rows = _rows(mesh, B)
    dev = mesh.device

    if problem.A.ndim == 4:
        local = type(problem)(**{f.name: _take(getattr(problem, f.name), rows, B)
                                 for f in dataclasses.fields(problem)})
    else:   # one model: only a per-scenario drift is batched
        local = dataclasses.replace(
            problem, c=_take(problem.c, rows, B) if problem.c.ndim == 3
            else problem.c)
    if state is not None and state.w.shape[0] != rows.stop - rows.start:
        # The whole batch's state: this rank's rows of it.  Its factors
        # (an earlier call's, per rank) cannot be split here.
        if state.factors is not None:
            raise ValueError("a warm state with factors must be this rank's "
                             "own (as its call returned it)")
        rho = torch.as_tensor(state.rho)
        state = dataclasses.replace(
            state, w=_take(state.w, rows, B), z=_take(state.z, rows, B),
            y=_take(state.y, rows, B),
            rho=_take(rho, rows, B) if rho.ndim else rho)
    return admm.solve_fused(
        local.to(device=dev), _take(x0, rows, B).to(device=dev), tuple(cones),
        settings, state, soc_shift, single_kernel=single_kernel,
        storage_dtype=storage_dtype)
