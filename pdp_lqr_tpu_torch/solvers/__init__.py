"""Solver backends of the port.

  sequential — plain-torch Riccati recursion (reference LQRSolver), the
               port's independent witness
  dense      — P-form Riccati with a solve-free rollout
  assoc      — log-depth associative-scan Riccati
  pdp        — segmented parallel Riccati (reference LQRParallelSolver)
  kkt        — block-tridiagonal KKT factorization (reference QDLDLSolver)
  admm       — the conic ADMM outer loop: ``solve`` on one of the five
               backends above (torch ops), ``solve_equilibrated`` (Ruiz
               scaling around it); ``solve_fused`` in shared split mode on
               the kernels of ops.cuda_admm, and on batched problems on the
               per-instance kernels of ops.cuda_riccati
  realtime   — the 1 kHz replan path: the cached-factor inner solve
               materialized as one dense map (or its segment-factored
               form), early-exit replans; the scenario-batch operator, the
               rho ladder of maps
  recovery   — masked regularization bump-and-retry over any batched solve
  (cuda)     — ops.cuda_riccati: the kernels behind
               ``ScenarioServer.solve`` and ``solve_lanes``
"""

from pdp_lqr_tpu_torch.solvers import realtime, recovery

__all__ = ["realtime", "recovery"]
