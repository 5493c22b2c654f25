"""pdp_lqr_tpu_torch — the PyTorch / CUDA port of ``pdp_lqr_tpu``.

A second package beside the JAX one, with the same sub-package layout
and the same public names, written for one NVIDIA H100.  Plain tensor
code is PyTorch; the fused sweep kernels are CUDA C++ built with ``nvcc``
at first use (``ops/_build.py``).  It imports neither ``jax`` nor
``pdp_lqr_tpu``.

Ported (everything the JAX package does):

- ``config``, ``problem``, ``convert`` — constants, the stage-stacked
  problem model, and the numpy hand-over from the JAX package.
- ``models`` — quadrotor, mass-spring chain, centroidal, rocket, double
  integrator, random LQ.
- ``ops.riccati`` / ``solvers.sequential`` — plain-torch sequential
  Riccati, the port's independent witness; ``ops.linalg`` — the small
  factorizations and triangular solves of the torch-ops backends.
- the torch-ops backends of ``admm.solve``: ``solvers.dense`` (P-form
  Riccati, ``ops.riccati_dense``), ``solvers.assoc`` (log-depth
  associative scans, ``ops.riccati_assoc``), ``solvers.pdp`` (segmented
  parallel Riccati, ``ops.riccati_pdp``, either condensed factorization)
  and ``solvers.kkt`` (block-tridiagonal KKT, ``ops.kkt_block``).
- ``ops.cuda_riccati`` — the inner solve on four kernels (matrix sweep,
  cached-factor vector sweep, closed-loop rollout, rollout from the raw
  dynamics): one shared model (``solve_shared``) or one model a scenario
  (``solve_lanes``, and ``solve_packed`` on row-packed streams); and the
  segment reduction of the parallel solver and its cached vector sweep.
- ``ops.condensed`` — the condensed boundary system (Cholesky and LU).
- ``parallel`` — the segment-parallel PDP solve (``pdp_sharded_fused``
  on the kernels, ``pdp_sharded`` in torch ops) and the conic ADMM loop on
  it (``admm_sharded``), the horizon in S segments on one card or one
  segment a rank of a ``torch.distributed`` world (``multihost``:
  ``initialize``, ``make_pod_mesh``, ``launch``); ``fused_dp``, the batch
  split over every rank.
- ``ops.projections`` — box / SOC / rotated-SOC projections.
- ``ops.cuda_admm`` — the split conic ADMM iteration on three kernels
  (prefold vector sweep; vector sweep with the iterate fold on R ladder
  rungs; rollout + projection + dual + residuals).
- ``solvers.admm`` — ``ADMMSettings`` / ``ADMMState`` / ``ADMMInfo``,
  ``solve`` / ``solve_batched`` (the conic loop on one of the five
  torch-ops backends, ``settings.backend``), ``suggest_rho_ladder`` and
  ``solve_fused`` in shared split mode (cached factors with a uniform rho,
  or a rho ladder) and on batched problems (the replicated per-instance
  loop).
- ``solvers.realtime`` — the 1 kHz replan path: the cached-factor inner
  solve materialized as a dense map (``build_operator``) or its
  segment-factored form (``build_condensed_operator``), early-exit
  replans (``solve``, ``replan_fn``), the scenario-batch map
  (``build_batch_operator``, ``solve_batch``), bfloat16 storage
  (``cast_operator``) and a rho ladder of maps (``build_ladder``,
  ``replan_ladder_fn``); ``solvers.recovery`` — bump-and-retry of failed
  lanes over any batched solve; ``admm.solve_equilibrated`` — the Ruiz-
  scaled solve (``utils.scaling``).
- ``mpc`` — ``shift_state``, ``replan`` / ``simulate`` on ``admm.solve``
  and ``replan_realtime`` / ``simulate_realtime`` on the operator path.
- ``utils`` — ``profiling`` (CUDA-event timing, traces, the H100
  roofline, ``failure_mask``), ``scaling``, ``quality``, ``checkpoint``,
  ``oracle`` (numpy witnesses), ``native`` (the C++ witness, built with
  g++).
- ``api`` — the reference-shaped classes ``LQRSolver``,
  ``LQRParallelSolver``, ``QDLDLSolver`` and ``AssociativeScanSolver``
  (update_problem_data / backward / backward_without_factorization /
  forward), and ``ScenarioServer``: one model serving B scenarios,
  ``solve`` (inner LQ solves) and ``solve_admm`` (the conic ADMM loop).

Entry points default to ``device="cuda"``; pass ``device="cpu"`` to run
the kernels' plain PyTorch versions.
"""

from pdp_lqr_tpu_torch.config import SolverConfig, LQR_INFTY, DIVISION_TOL
from pdp_lqr_tpu_torch.problem import (
    LQRProblem,
    build_problem,
    ADMMIterates,
    StageParams,
    init_iterates,
    make_stage_params,
)
from pdp_lqr_tpu_torch.solvers.admm import (
    ADMMSettings,
    ADMMState,
    ADMMInfo,
    solve,
    solve_batched,
    solve_fused,
    solve_equilibrated,
    init_state,
)
from pdp_lqr_tpu_torch.api import (
    LQRSolver,
    LQRParallelSolver,
    QDLDLSolver,
    AssociativeScanSolver,
    ScenarioServer,
)
from pdp_lqr_tpu_torch import mpc
from pdp_lqr_tpu_torch.solvers import realtime, recovery

__all__ = [
    "SolverConfig",
    "LQR_INFTY",
    "DIVISION_TOL",
    "LQRProblem",
    "build_problem",
    "ADMMIterates",
    "StageParams",
    "init_iterates",
    "make_stage_params",
    "ADMMSettings",
    "ADMMState",
    "ADMMInfo",
    "solve",
    "solve_batched",
    "solve_fused",
    "solve_equilibrated",
    "init_state",
    "LQRSolver",
    "LQRParallelSolver",
    "QDLDLSolver",
    "AssociativeScanSolver",
    "ScenarioServer",
    "mpc",
    "realtime",
    "recovery",
]

__version__ = "0.1.0"
