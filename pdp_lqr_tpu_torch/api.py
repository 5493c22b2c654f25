"""Reference-shaped class API and the serving API of the port.

Counterpart of ``pdp_lqr_tpu/api.py``.  The reference exposes stateful
solver objects with a four-call lifecycle
(include/clqr/lqr/lqr_solver.hpp:9-28):

    LQRSolver solver(model);
    solver.update_problem_data(ws, ys, zs, rho_vecs, inv_rho_vecs, sigma);
    solver.backward();                      // or backward_without_factorization
    solver.forward(x0, ws);

``LQRSolver``, ``LQRParallelSolver``, ``QDLDLSolver`` and
``AssociativeScanSolver`` keep that call sequence on the torch-ops
backends of ``solvers``, so a reference user can port call sites
mechanically.  Differences from the reference, by design (the JAX
package's):

  * ``forward`` returns the trajectory instead of mutating ``ws``.
  * ``inv_rho_vecs`` is derived, not passed (ADMMIterates.inv_rho).
  * Everything works batched: construct with a batched model (a leading
    batch axis on every field) and every method runs over that axis.

The JAX package caches one jitted callable per lifecycle step; PyTorch
runs eagerly, so there is nothing to cache here.

``ScenarioServer`` is the one-model-many-scenarios server on the kernels:
its inner LQ solve (``solve``) and the conic ADMM loop over the scenario
batch (``solve_admm``: the split iteration, its rho-ladder form, or the
single-kernel iteration, the default when the settings give no
batch-shared factors).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pdp_lqr_tpu_torch.config import CondensedSolverType
from pdp_lqr_tpu_torch.ops import cuda_riccati, riccati, riccati_assoc
from pdp_lqr_tpu_torch.problem import (
    ADMMIterates,
    LQRProblem,
    init_iterates,
    make_stage_params,
)
from pdp_lqr_tpu_torch.solvers import admm, kkt, pdp


class _SolverBase:
    """Shared lifecycle plumbing; subclasses bind a backend's three steps
    (``_bw``, ``_bw_cached``, ``_fw``).

    The model (one problem, or a batch with a leading axis on every field)
    is moved to ``device`` (default: the card; ``device="cpu"`` runs on the
    CPU).  The lifecycle's vectors are moved there too."""

    def __init__(self, model: LQRProblem, device="cuda"):
        self.device = torch.device(device)
        self.model = model.to(device=self.device)
        self._params = None
        self._rho = None
        self._factors = None

    def _tensor(self, x):
        if not isinstance(x, torch.Tensor):
            x = torch.tensor(np.asarray(x))    # a copy: arrays may be read-only
        return x.to(device=self.device, dtype=self.model.H.dtype)

    # -- reference: update_problem_data (lqr_solver.hpp:41-56) ----------
    def update_problem_data(self, ws, ys, zs, rho_vecs, sigma: float):
        it = ADMMIterates(w=self._tensor(ws), y=self._tensor(ys),
                          z=self._tensor(zs), rho=self._tensor(rho_vecs))
        self._params = make_stage_params(self.model, it, float(sigma))
        self._rho = it.rho
        return self

    def _require_params(self):
        if self._params is None:
            raise RuntimeError("call update_problem_data first")

    # -- reference: backward / backward_without_factorization -----------
    def backward(self):
        self._require_params()
        self._factors = self._bw(self.model, self._params, self._rho)
        return self

    def backward_without_factorization(self):
        self._require_params()
        if self._factors is None:
            raise RuntimeError("no cached factorization; call backward first")
        self._factors = self._bw_cached(self.model, self._params, self._rho,
                                        self._factors)
        return self

    # -- reference: forward (lqr_solver.hpp:72-77) -----------------------
    def forward(self, x0):
        if self._factors is None:
            raise RuntimeError("call backward first")
        return self._fw(self.model, self._factors, self._tensor(x0))

    def clear_workspace(self):
        """Reference: LQRSolver::clear_workspace (lqr_solver.hpp:26)."""
        self._params = None
        self._rho = None
        self._factors = None
        return self


class LQRSolver(_SolverBase):
    """Sequential Riccati — reference ``clqr::LQRSolver``."""

    _bw = staticmethod(riccati.backward)
    _bw_cached = staticmethod(riccati.backward_no_refactor)
    _fw = staticmethod(riccati.forward)


class LQRParallelSolver(_SolverBase):
    """Segmented parallel Riccati — reference ``clqr::LQRParallelSolver``.

    ``num_segments`` as in the reference ctor
    (lqr_solver_parallel.hpp:22); ``load_balancing`` is accepted for
    signature compatibility and ignored (uniform segments: every segment
    runs the same batched code, see ops/riccati_pdp.py); ``solver_type``
    picks the condensed factorization (LU or CHOLESKY).
    """

    def __init__(self, model: LQRProblem, num_segments: int = 4,
                 load_balancing: bool = False,
                 solver_type: CondensedSolverType = CondensedSolverType.CHOLESKY,
                 device="cuda"):
        super().__init__(model, device)
        del load_balancing
        self.num_segments = num_segments
        self.solver_type = solver_type

    def _bw(self, model, params, rho):
        return pdp.backward(model, params, rho, self.num_segments,
                            self.solver_type)

    _bw_cached = staticmethod(pdp.backward_without_factorization)
    _fw = staticmethod(pdp.forward)


class QDLDLSolver(_SolverBase):
    """Full-horizon KKT factorization — reference ``clqr::QDLDLSolver``.

    ``rho_dyn`` regularization defaults to the reference's hardwired 1e-6
    (qdldl_solver.hpp:40-41).  The symbolic phase of QDLDL has no analog:
    the block-tridiagonal structure is static.
    """

    def __init__(self, model: LQRProblem, rho_dyn: float = 1e-6,
                 device="cuda"):
        super().__init__(model, device)
        self.rho_dyn = rho_dyn

    def _bw(self, model, params, rho):
        return kkt.backward(model, params, rho, self.rho_dyn)

    def backward_without_factorization(self):
        # Numeric factor reuse == not refactoring at all (only the rhs
        # changes); the factors pass through untouched.
        self._require_params()
        if self._factors is None:
            raise RuntimeError("no cached factorization; call backward first")
        return self

    def forward(self, x0):
        if self._factors is None:
            raise RuntimeError("call backward first")
        return kkt.forward(self.model, self._params, self._rho, self._factors,
                           self._tensor(x0))


class AssociativeScanSolver(_SolverBase):
    """Log-depth associative-scan Riccati (no reference counterpart; the
    same lifecycle for interchangeability)."""

    _bw = staticmethod(riccati_assoc.backward)
    _bw_cached = staticmethod(riccati_assoc.backward_no_refactor)
    _fw = staticmethod(riccati_assoc.forward)


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
