"""Solver backends of the port.

  sequential — plain-torch Riccati recursion (reference LQRSolver), the
               port's independent witness
  admm       — the conic ADMM outer loop; ``solve_fused`` in shared split
               mode on the kernel pair of ops.cuda_admm
  (cuda)     — ops.cuda_riccati: the shared-model kernels behind
               ``ScenarioServer.solve``
"""
