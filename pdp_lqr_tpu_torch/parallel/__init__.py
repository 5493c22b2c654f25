"""Segment-parallel execution — PyTorch port of ``pdp_lqr_tpu/parallel``.

The reference's concurrency is one OpenMP thread per horizon segment
(lqr_solver_parallel.hpp:102-112,156-188); the JAX package puts the
segments on the devices of a "time" mesh axis.  On one card the same
decomposition is S segments swept side by side in one kernel launch
(``ops.cuda_riccati.backward_pdp_lanes``), the boundary values written as
(S, ...) tensors instead of all-gathered, and the condensed boundary
system solved once in tensor code.  Ported: ``mesh``,
``pdp_sharded_fused`` and ``admm_sharded``.  Spreading the segments over
several cards (``torch.distributed``), ``pdp_sharded``, ``fused_dp`` and
``multihost`` are not ported.
"""

from pdp_lqr_tpu_torch.parallel.mesh import Mesh, make_mesh

__all__ = ["Mesh", "make_mesh"]
