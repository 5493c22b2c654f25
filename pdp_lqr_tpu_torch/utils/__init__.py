"""Host-side utilities of the port: profiling (timing on CUDA events,
``torch.profiler`` traces, the H100 roofline, the failure mask), Ruiz
scaling, solution quality, checkpoints, the numpy oracles and the native
C++ witness (``native``, built with g++ at first use)."""

from pdp_lqr_tpu_torch.utils import (
    checkpoint,
    native,
    oracle,
    profiling,
    quality,
    scaling,
)

__all__ = ["checkpoint", "native", "oracle", "profiling", "quality", "scaling"]
