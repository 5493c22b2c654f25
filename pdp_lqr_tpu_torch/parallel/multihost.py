"""Process-group initialization and the mesh over ranks — PyTorch port of
``pdp_lqr_tpu/parallel/multihost.py``.

JAX connects hosts with ``jax.distributed.initialize``, after which
``jax.devices()`` spans the slice and the ("batch", "time") mesh code
works unchanged.  Here every mesh position is one process of a
``torch.distributed`` world: ``initialize`` joins it, ``make_pod_mesh``
lays the ranks out as ``batch`` rows of ``time`` consecutive ranks and
makes each row's and each column's process group.  The horizon's
boundary values are all-gathered over a row (keep it within one host:
the PDP exchange runs every solve), the batch rows never communicate.

``launch`` runs a list of calls on a fresh local world (one host, one
process a rank, started with a timeout that kills them all): how the
tests run the multi-rank paths on the CPU over gloo and how
``chip_smoke.py`` runs them on the card.
"""

from __future__ import annotations

import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time as _time
from pathlib import Path
from typing import Optional

import torch

from pdp_lqr_tpu_torch.parallel.mesh import Mesh

_REPO_ROOT = Path(__file__).resolve().parents[2]


def initialize(backend: Optional[str] = None, init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None) -> None:
    """Join this process to its ``torch.distributed`` world.

    ``backend`` defaults to ``nccl`` where the ranks run on the card
    (CUDA is available) and ``gloo`` on the CPU; a backend that fails is
    an error, never swapped for another.  ``init_method``, ``world_size``
    and ``rank`` default to the environment's (``env://``: ``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``).  With CUDA, each
    rank's device is ``cuda:(local_rank % device_count)``, ``LOCAL_RANK``
    the local rank (else the rank).  No-op if the group already exists.
    """
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {}
    if world_size is not None:
        kwargs["world_size"] = world_size
    if rank is not None:
        kwargs["rank"] = rank
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK",
                                   rank if rank is not None
                                   else os.environ.get("RANK", 0)))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, **kwargs)


def make_pod_mesh(time: int = 1, device="cuda") -> Mesh:
    """("batch", "time") mesh over every rank of the world.

    ``time`` consecutive ranks a row, so that a row stays on one host
    (``LOCAL_WORLD_SIZE`` ranks a host, the world when unset) whenever
    time <= local world size.  Every rank makes every row's and column's
    group, in the same order (``dist.new_group`` is collective).
    ``device``: the card (this rank's current CUDA device) unless
    ``"cpu"``.
    """
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("no process group: call multihost.initialize first")
    n = dist.get_world_size()
    if n % time != 0:
        raise ValueError(f"rank count {n} not divisible by time={time}")
    local = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    if time > local:
        raise ValueError(
            f"time={time} spans hosts (local={local}); keep the horizon "
            "axis within one host")
    rank = dist.get_rank()
    b, t = divmod(rank, time)
    rows, cols = n // time, time
    time_group = batch_group = None
    for r in range(rows):
        g = dist.new_group(list(range(r * cols, (r + 1) * cols)))
        if r == b:
            time_group = g
    for c in range(cols):
        g = dist.new_group(list(range(c, n, cols)))
        if c == t:
            batch_group = g
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(shape={"batch": rows, "time": time}, device=device, rank=rank,
                coords=(b, t), time_group=time_group, batch_group=batch_group)


# ------------------------------------------------------- a local world

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _resolve(path: str):
    """"package.module:function" -> the function."""
    import importlib

    module, name = path.split(":")
    return getattr(importlib.import_module(module), name)


def _to_host(x):
    """A call's result with every tensor on the CPU and a mesh described
    (process groups do not leave their process)."""
    import dataclasses

    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, Mesh):
        import torch.distributed as dist
        return {"shape": dict(x.shape), "rank": x.rank, "coords": x.coords,
                "device": str(x.device),
                "time_ranks": dist.get_process_group_ranks(x.time_group),
                "batch_ranks": dist.get_process_group_ranks(x.batch_group)}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return type(x)(**{f.name: _to_host(getattr(x, f.name))
                          for f in dataclasses.fields(x)})
    if isinstance(x, (tuple, list)):
        return type(x)(_to_host(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    return x


def _launch_counts():
    from pdp_lqr_tpu_torch.ops import cuda_admm, cuda_riccati
    return {**cuda_riccati.LAUNCHES, **cuda_admm.LAUNCHES}


def _reset_launch_counts():
    from pdp_lqr_tpu_torch.ops import cuda_admm, cuda_riccati
    cuda_riccati.reset_launch_counts()
    cuda_admm.reset_launch_counts()


def _run_job(job, meshes, device):
    """One call of a rank: its result, error, launches and time."""
    import torch.distributed as dist

    fn = _resolve(job["fn"])
    args, kwargs = job.get("args", ()), job.get("kwargs", {})
    if job.get("time") is not None:
        t = job["time"]
        if t not in meshes:
            meshes[t] = make_pod_mesh(t, device=device)
        args = (meshes[t],) + tuple(args)
    saved = {k: os.environ.get(k) for k in job.get("env", {})}
    os.environ.update(job.get("env", {}))
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" \
        else (lambda: None)
    result = {"name": job.get("name", job["fn"]), "error": None, "out": None,
              "launches": {}, "ms": None}
    try:
        _reset_launch_counts()
        out = fn(*args, **kwargs)
        sync()
        result["launches"] = {k: v for k, v in _launch_counts().items() if v}
        result["out"] = _to_host(out)
        times = []
        for _ in range(job.get("reps", 0)):
            dist.barrier()
            sync()
            t0 = _time.perf_counter()
            fn(*args, **kwargs)
            sync()
            dist.barrier()
            times.append((_time.perf_counter() - t0) * 1e3)
        if times:
            result["ms"] = statistics.median(times)
    except Exception as e:  # recorded for the caller, who raises
        result["error"] = f"{type(e).__name__}: {e}"
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return result


def _rank_main(job_file, rank, world, init_method, backend, device, out_file):
    """Body of one rank process started by ``launch``."""
    import torch.distributed as dist

    rank, world = int(rank), int(world)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    jobs = torch.load(job_file, weights_only=False)
    initialize(backend=backend or None, init_method=init_method,
               world_size=world, rank=rank)
    meshes, results = {}, []
    try:
        for job in jobs:
            results.append(_run_job(job, meshes, device))
        torch.save({"rank": rank, "backend": dist.get_backend(),
                    "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
                    "packages": sorted({m.split(".")[0] for m in sys.modules}),
                    "results": results}, out_file)
    finally:
        dist.destroy_process_group()


_CHILD = ("import sys; from pdp_lqr_tpu_torch.parallel import multihost; "
          "multihost._rank_main(*sys.argv[1:])")


def launch(jobs, world_size: int, *, device="cuda", backend=None,
           timeout: float = 180.0):
    """Run ``jobs`` on a fresh local world of ``world_size`` processes.

    Each job is a dict: ``fn`` ("module:function"), ``args``, ``kwargs``;
    ``time`` (if given, the call gets ``make_pod_mesh(time)`` as its
    first argument); ``env`` (set around the call); ``reps`` (time that
    many more calls, each between barriers: the world's time); ``name``.
    The jobs are saved with ``torch.save`` and loaded by every rank (keep
    them small: an expanded tensor saves only its storage).  Ranks start
    with ``initialize`` (``backend`` by its rule, gloo for
    ``device="cpu"``); each runs every job in order and records its
    result, error, kernel launches and time.

    Every rank is killed when ``timeout`` seconds pass, or when one rank
    fails and the others do not end within seconds (a collective that one
    rank skips hangs the rest).  Returns one dict a rank, in rank order
    (its backend, whether TF32 matmuls were allowed, the top-level
    packages it loaded, its ``results``); raises if a rank failed or the
    world timed out.
    """
    if torch.device(device).type == "cpu" and backend is None:
        backend = "gloo"
    with tempfile.TemporaryDirectory(prefix="pdp_lqr_world_") as tmp:
        job_file = os.path.join(tmp, "jobs.pt")
        torch.save(list(jobs), job_file)
        init = f"tcp://127.0.0.1:{_free_port()}"
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(_REPO_ROOT)] + [p for p in env.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        env["LOCAL_WORLD_SIZE"] = str(world_size)
        procs, logs = [], []
        try:
            for r in range(world_size):
                log = open(os.path.join(tmp, f"rank{r}.log"), "w")
                logs.append(log)
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", _CHILD, job_file, str(r),
                     str(world_size), init, backend or "", str(device),
                     os.path.join(tmp, f"rank{r}.pt")],
                    env={**env, "LOCAL_RANK": str(r)}, cwd=str(_REPO_ROOT),
                    stdout=log, stderr=subprocess.STDOUT))
            deadline = _time.monotonic() + timeout
            failed_at = None
            while any(p.poll() is None for p in procs):
                now = _time.monotonic()
                if failed_at is None and any(p.poll() not in (None, 0)
                                             for p in procs):
                    failed_at = now
                if now > deadline or (failed_at is not None
                                      and now > failed_at + 10.0):
                    break
                _time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
            for log in logs:
                log.close()
        codes = [p.returncode for p in procs]
        if any(codes):
            tails = "\n".join(
                f"--- rank {r} (exit {c}) ---\n"
                + Path(tmp, f"rank{r}.log").read_text()[-4000:]
                for r, c in enumerate(codes) if c)
            raise RuntimeError(f"a rank of the local world failed or was "
                               f"killed (exit codes {codes}):\n{tails}")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world_size)]
