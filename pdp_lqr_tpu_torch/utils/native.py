"""ctypes binding of the native C++ batch engine (native/clqr_native.cpp)
— the port's own copy of ``pdp_lqr_tpu/utils/native.py``.

The shared object is compiled from source with g++ (no dependencies, a
few seconds) into the port's build directory (``build/``, beside the
kernels' libraries), named by a hash of the source, so a checkout never
ships or loads a prebuilt binary and an edited source rebuilds.

A witness only: an independent host implementation of the inner solve
(sigma-regularized, penalty-folded sequential Riccati, one thread an
instance) to hold the port's solves against.  Nothing on a main path
calls it and nothing falls back to it.  ``available()`` is False where
no compiler is found.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from pdp_lqr_tpu_torch.ops import _build

_SRC = Path(__file__).resolve().parents[2] / "native" / "clqr_native.cpp"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lib: Optional[ctypes.CDLL] = None


def _build_library() -> Optional[Path]:
    """Compile the engine unless its library exists; None without g++."""
    if not _SRC.exists() or shutil.which("g++") is None:
        return None
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so = _build.build_dir() / f"libclqr_native-{digest}.so"
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)   # atomic: concurrent builds race safely
    return so


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is None:
        so = _build_library()
        if so is None:
            return None
        lib = ctypes.CDLL(str(so))
        dp = ctypes.POINTER(ctypes.c_double)
        lib.clqr_solve_batch.restype = ctypes.c_int
        lib.clqr_solve_batch.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, dp, dp, dp, dp, dp, dp, dp, dp, dp,
            ctypes.c_double, ctypes.c_int, dp,
        ]
        _lib = lib
    return _lib


def available() -> bool:
    """True where the engine builds (g++ on the PATH)."""
    return _load() is not None


def solve_batch(problem, it, x0, sigma: float, n_threads: int = 0):
    """Batched inner solve on the host engine, in float64.

    problem/it: the port's batched records (leading axis B); x0 (B, nx).
    Returns ws (B, N+1, nz) float64 on the problem's device (computed on
    the host).  The engine takes h already shifted by the proximal term
    (h - sigma w, the reference's update_problem_data,
    lqr_solver.hpp:41-56) and g = z - y / rho; both are made here.
    ``n_threads`` 0: the host's cores.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native engine unavailable (no g++?)")

    arr = lambda x: np.ascontiguousarray(
        torch.as_tensor(x).detach().to("cpu", torch.float64).numpy())
    A = arr(problem.A)
    B, N, nx, _ = A.shape
    Bm = arr(problem.B)
    nu = Bm.shape[-1]
    c, H, D = arr(problem.c), arr(problem.H), arr(problem.D)
    nc = D.shape[-2]
    h = arr(problem.h) - sigma * arr(it.w)
    h[:, -1, :nu] = 0.0                    # the terminal stage has no controls
    rho = arr(it.rho)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_rho = np.where(rho > 0, 1.0 / np.where(rho > 0, rho, 1.0), 0.0)
    g = np.ascontiguousarray(arr(it.z) - inv_rho * arr(it.y))
    h = np.ascontiguousarray(h)
    x0_ = arr(x0)

    ws = np.zeros((B, N + 1, nx + nu))
    dp = ctypes.POINTER(ctypes.c_double)
    ptr = lambda a: a.ctypes.data_as(dp)
    rc = lib.clqr_solve_batch(
        B, N, nx, nu, nc, ptr(A), ptr(Bm), ptr(c), ptr(H), ptr(h), ptr(D),
        ptr(rho), ptr(g), ptr(x0_), ctypes.c_double(sigma), int(n_threads),
        ptr(ws))
    if rc != 0:
        raise RuntimeError(f"clqr_solve_batch failed with code {rc}")
    return torch.from_numpy(ws).to(problem.A.device)
