"""Solver backends of the port.

  sequential — plain-torch Riccati recursion (reference LQRSolver), the
               port's independent witness
  (cuda)     — ops.cuda_riccati: the shared-model kernels behind
               ``ScenarioServer.solve``
"""
