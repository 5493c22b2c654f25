"""Host-side utilities of the port: profiling (timing on CUDA events,
``torch.profiler`` traces, the H100 roofline, the failure mask), Ruiz
scaling, solution quality, checkpoints, and the numpy oracles."""

from pdp_lqr_tpu_torch.utils import (
    checkpoint,
    oracle,
    profiling,
    quality,
    scaling,
)

__all__ = ["checkpoint", "oracle", "profiling", "quality", "scaling"]
