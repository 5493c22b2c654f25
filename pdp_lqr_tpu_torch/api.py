"""Serving API of the port: ``ScenarioServer``.

Counterpart of ``pdp_lqr_tpu/api.py``.  Ported so far: the
one-model-many-scenarios server with its inner LQ solve (``solve``) and
the conic ADMM loop over the scenario batch (``solve_admm``: the split
iteration, its rho-ladder form, or the single-kernel iteration, the
default when the settings give no batch-shared factors).  The
reference-shaped solver classes follow in later slices.
"""

from __future__ import annotations

import dataclasses

import torch

from pdp_lqr_tpu_torch.ops import cuda_riccati
from pdp_lqr_tpu_torch.problem import LQRProblem, init_iterates
from pdp_lqr_tpu_torch.solvers import admm


class ScenarioServer:
    """One-model-many-scenarios serving on the shared-stage kernels.

    The reference's process shape — a single ``LQRModel`` behind all
    solvers (lqr_model.hpp:66-89) — as a serving API: the card holds ONE
    copy of the stage matrices while scenario batches (per-scenario x0,
    optional per-scenario drift c) run at full batch width.

        server = ScenarioServer(model)               # on the card
        ws = server.solve(x0s)                       # inner LQ solves
        ws, state, info = server.solve_admm(x0s, cones, settings)

    ``model`` is UNBATCHED.  It is moved to ``device`` (default: the
    card; with no card that raises).  ``device="cpu"`` runs the kernels'
    plain PyTorch versions.
    """

    def __init__(self, model: LQRProblem, rho: float = 0.01,
                 sigma: float = 1e-6, device="cuda"):
        if model.A.ndim != 3:
            raise ValueError("ScenarioServer takes an UNBATCHED model")
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.sigma = float(sigma)
        self._it = init_iterates(self.model, rho=rho)

    def _tensor(self, x):
        return torch.as_tensor(x).to(device=self.device,
                                     dtype=self.model.c.dtype)

    def solve(self, x0s, c=None):
        """Batched inner solves: x0s (B, nx), optional per-scenario
        drift c (B, N, nx); arrays or tensors.  Returns ws (B, N+1, nz)
        on the server's device."""
        m = self.model if c is None else dataclasses.replace(
            self.model, c=self._tensor(c))
        return cuda_riccati.solve_shared(m, self._it, self._tensor(x0s),
                                         self.sigma)

    def solve_admm(self, x0s, cones=(), settings=None, state=None,
                   soc_shift=None, c=None, split: bool | None = None):
        """Full conic ADMM over the scenario batch (``solve_fused`` in
        shared mode: one copy of the problem streams on the card).
        Returns (ws, state, info) — ``state`` warm-starts the next tick.

        ``split`` selects the iteration: True = the split kernel pair
        (the long-horizon serving path; requires cached_factors or a
        rho_ladder in ``settings``), False = the single-kernel fused
        iteration (K8, per-scenario rho unless the settings cache
        factors), None (default) = split whenever the settings allow it
        (cached_factors + uniform_rho, or a rho_ladder), else the single
        kernel: the default ``ADMMSettings()`` run K8."""
        if settings is None:
            settings = admm.ADMMSettings()
        if split is None:
            split = bool(settings.rho_ladder) or (
                settings.cached_factors and settings.uniform_rho)
        m = self.model if c is None else dataclasses.replace(
            self.model, c=self._tensor(c))
        if state is not None:
            state = state.to(device=self.device)
        return admm.solve_fused(
            m, self._tensor(x0s), tuple(cones or ()), settings,
            state=state, soc_shift=soc_shift, single_kernel=not split)
