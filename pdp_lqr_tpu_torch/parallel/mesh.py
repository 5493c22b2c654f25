"""The ("batch", "time") mesh of the segment-parallel solvers.

Counterpart of ``pdp_lqr_tpu/parallel/mesh.py``.  There the mesh places
devices: "time" carries horizon segments, "batch" independent problem
instances.  The port has two kinds of mesh with one interface:

* one card (``make_mesh``): one process runs every segment and
  instance; ``time`` is the number of segments S a solve cuts the
  horizon into (swept side by side in one launch), and ``batch`` must
  divide the batch but changes no number, so that code written for the
  JAX mesh carries over unchanged;
* ranks (``multihost.make_pod_mesh``): one process a mesh position of a
  ``torch.distributed`` world, ``batch`` rows of ``time`` consecutive
  ranks.  Each rank holds the scenarios of its row and one contiguous
  block of N/time stages, as JAX places one segment on a device; the
  boundary values are all-gathered over the rank's time group.

Both meshes give the same numbers at the same S.  ``TimeAxis`` is what a
segment solve needs of either: how many segments there are, which of
them this process holds, and the collectives over the time group (no-ops
on one card, where every segment is already here).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class TimeAxis:
    """The horizon's segments as one process sees them.

    ``segments`` S in all; ``index`` the one segment this rank holds, or
    None when every segment is held here (one card); ``group`` the time
    group's process group on a rank mesh.
    """

    segments: int
    index: Optional[int] = None
    group: object = None

    @property
    def held(self) -> int:
        """Segments held by this process."""
        return self.segments if self.index is None else 1

    def last_mask(self, dtype, device):
        """(held,) 1.0 where a held segment is the horizon's last."""
        if self.index is None:
            mask = torch.zeros(self.segments, dtype=dtype, device=device)
            mask[-1] = 1.0
            return mask
        return torch.full((1,), float(self.index == self.segments - 1),
                          dtype=dtype, device=device)

    def gather(self, x, dim: int = 0):
        """The held segments' values (``x`` with ``held`` entries along
        ``dim``) -> every segment's (S entries), in segment order."""
        if self.index is None:
            return x
        import torch.distributed as dist

        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.segments)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim=dim)

    def own(self, x, dim: int):
        """The held segments' entries of an all-segment tensor."""
        return x if self.index is None else x.narrow(dim, self.index, 1)

    def from_last(self, x):
        """The last segment's ``x`` on every process (``x`` is this
        process's last held segment's): JAX's ``psum`` of the value masked
        to the last device."""
        if self.index is None:
            return x
        import torch.distributed as dist

        out = x if self.index == self.segments - 1 else torch.zeros_like(x)
        out = out.contiguous()
        dist.all_reduce(out, group=self.group)
        return out

    def max(self, x):
        """Elementwise maximum over the time group (JAX's ``pmax``)."""
        if self.index is None:
            return x
        import torch.distributed as dist

        out = x.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        return out


def time_axis(S) -> TimeAxis:
    """``S`` as a TimeAxis: an int is S segments all held here."""
    return S if isinstance(S, TimeAxis) else TimeAxis(int(S))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``shape`` {"batch": b, "time": S}; ``device`` where the solves run.

    On a rank mesh also this process's ``rank``, its ``coords`` (batch row,
    time column) and the process groups of its row (``time_group``) and
    its column (``batch_group``); all None on one card.
    """

    shape: dict
    device: torch.device
    rank: Optional[int] = None
    coords: Optional[tuple] = None
    time_group: object = None
    batch_group: object = None

    @property
    def ranked(self) -> bool:
        return self.rank is not None

    @property
    def size(self) -> int:
        return self.shape["batch"] * self.shape["time"]

    def time_axis(self) -> TimeAxis:
        S = self.shape["time"]
        if not self.ranked:
            return TimeAxis(S)
        return TimeAxis(S, self.coords[1], self.time_group)

    def rows(self, B: int, over: str = "batch") -> slice:
        """This process's scenarios of a global batch of B: the rows of
        its batch row (``over="batch"``), or of its rank when the batch is
        split over every rank jointly (``over="all"``, JAX's
        ``P(("batch", "time"))``).  Every row on one card."""
        if not self.ranked:
            return slice(0, B)
        parts, part = ((self.shape["batch"], self.coords[0]) if over == "batch"
                       else (self.size, self.rank))
        n = B // parts
        return slice(part * n, (part + 1) * n)

    def stages(self, x, N: int, dim: int = 0):
        """The stages of this rank's segment of a stage tensor (N or N+1
        entries along ``dim``; the terminal entry N kept after them); all
        of them on one card."""
        if not self.ranked:
            return x
        Nl = N // self.shape["time"]
        own = x.narrow(dim, self.coords[1] * Nl, Nl)
        if x.shape[dim] == N:
            return own
        return torch.cat([own, x.narrow(dim, N, 1)], dim=dim)

    def local(self, x, B: int, N: int):
        """This process's block of a batched tensor or record of tensors
        (leading axis: the global batch B or already this process's rows;
        stage axis 1 where a tensor has more than one axis): its rows and
        its segment's stages."""
        if dataclasses.is_dataclass(x):
            return type(x)(**{f.name: None if getattr(x, f.name) is None
                              else self.local(getattr(x, f.name), B, N)
                              for f in dataclasses.fields(x)})
        rows = self.rows(B)
        if x.shape[0] == B:
            x = x[rows]
        elif x.shape[0] != rows.stop - rows.start:
            raise ValueError(f"leading size {x.shape[0]} is neither the batch "
                             f"{B} nor this rank's {rows.stop - rows.start}")
        return self.stages(x, N, 1) if x.ndim > 1 else x

    def all_true(self, flag) -> bool:
        """``flag`` (a bool tensor) true on every rank of the world: JAX's
        ``pmin`` over both mesh axes.  One host read."""
        flag = bool(flag)
        if not self.ranked:
            return flag
        import torch.distributed as dist

        dev = self.device if dist.get_backend() == "nccl" else "cpu"
        t = torch.tensor([int(flag)], dtype=torch.int32, device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MIN)
        return bool(t.item())


def make_mesh(batch: int = 1, time: int = 1, device="cuda") -> Mesh:
    """A ("batch", "time") mesh of ``time`` horizon segments on one
    device (the card unless ``device="cpu"``)."""
    for name, n in (("batch", batch), ("time", time)):
        if not (isinstance(n, int) and n >= 1):
            raise ValueError(f"mesh axis {name} must be a positive int, got {n!r}")
    return Mesh(shape={"batch": batch, "time": time},
                device=torch.device(device))
