"""Segment- and data-parallel execution — PyTorch port of
``pdp_lqr_tpu/parallel``.

The reference's concurrency is one OpenMP thread per horizon segment
(lqr_solver_parallel.hpp:102-112,156-188); the JAX package puts the
segments on the devices of a "time" mesh axis and the scenarios on a
"batch" axis.  Here a mesh is either one card, where the S segments are
swept side by side in one kernel launch (``make_mesh``), or the ranks of
a ``torch.distributed`` world, one segment a rank, the boundary values
all-gathered over its time group (``multihost.make_pod_mesh``).

Modules: ``mesh``, ``multihost`` (process groups, the mesh over ranks, a
local world for the tests and the smoke run), ``fused_dp`` (the batch
over every rank, no collective), ``pdp_sharded`` (the PDP solve in torch
ops), ``pdp_sharded_fused`` (its kernel form: K9 / K10, the condensed
system, K3) and ``admm_sharded`` (the conic ADMM loop on it).
"""

from pdp_lqr_tpu_torch.parallel import (
    admm_sharded,
    fused_dp,
    multihost,
    pdp_sharded,
    pdp_sharded_fused,
)
from pdp_lqr_tpu_torch.parallel.mesh import Mesh, make_mesh

__all__ = ["Mesh", "make_mesh", "multihost", "fused_dp", "pdp_sharded",
           "pdp_sharded_fused", "admm_sharded"]
