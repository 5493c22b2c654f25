"""The ("batch", "time") mesh of the segment-parallel solvers, on one card.

Counterpart of ``pdp_lqr_tpu/parallel/mesh.py``.  There the mesh places
devices: "time" carries horizon segments, "batch" independent problem
instances.  Here one card runs every segment and instance: ``time`` is
the number of segments S a solve cuts the horizon into (swept side by
side in one launch), and ``batch`` must divide the batch but changes no
number, so that code written for the JAX mesh carries over unchanged.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``shape`` {"batch": b, "time": S}; ``device`` where the solves run."""

    shape: dict
    device: torch.device


def make_mesh(batch: int = 1, time: int = 1, device="cuda") -> Mesh:
    """A ("batch", "time") mesh of ``time`` horizon segments on one
    device (the card unless ``device="cpu"``)."""
    for name, n in (("batch", batch), ("time", time)):
        if not (isinstance(n, int) and n >= 1):
            raise ValueError(f"mesh axis {name} must be a positive int, got {n!r}")
    return Mesh(shape={"batch": batch, "time": time},
                device=torch.device(device))
