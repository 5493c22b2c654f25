"""Build the CUDA sources of ``ops/csrc`` with ``nvcc`` at first use.

Each source becomes a shared library with a plain C interface, loaded
with ``ctypes`` (no PyTorch headers: such a file compiles in seconds).
A library is one specialisation of one source, named by a hash of the
source text and its ``-D`` flags, and lands in
``build/pdp_lqr_tpu_torch/`` beside the package.  Nothing is built when a module is
imported; a failed build raises with the compiler's output and nothing
falls back.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
# Loaded libraries by (source, -D flags): a wrapper's hot path is one
# dictionary lookup, the source is hashed only on the first use.
_libs: dict[tuple, ctypes.CDLL] = {}
# Compiler output of every build made by this process (``-Xptxas -v``:
# registers, shared memory and spills per kernel), keyed by library path.
build_logs: dict[Path, str] = {}


def build_dir() -> Path:
    return Path(__file__).resolve().parents[2] / "build" / "pdp_lqr_tpu_torch"


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and under $CUDA_HOME, "
        "/usr/local/cuda): the CUDA kernels cannot be built here"
    )


def _defines(defines: dict) -> list[str]:
    return [f"-D{k}={v}" for k, v in sorted(defines.items())]


def _source_text(source: str) -> bytes:
    """The source and the headers of ``csrc`` it includes: what a
    library's name is hashed from."""
    text = (CSRC / source).read_bytes()
    for header in re.findall(rb'^#include "([^"]+)"', text, re.M):
        text += (CSRC / header.decode()).read_bytes()
    return text


def library_path(source: str, defines: dict) -> Path:
    text = _source_text(source)
    tag = hashlib.sha256(
        text + " ".join(NVCC_FLAGS + tuple(_defines(defines))).encode()
    ).hexdigest()[:16]
    return build_dir() / f"{Path(source).stem}_{tag}.so"


def build(source: str, defines: dict) -> Path:
    """Compile ``csrc/<source>`` with the given ``-D`` flags unless its
    library exists already; returns the library's path."""
    out = library_path(source, defines)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, *_defines(defines),
           "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    build_logs[out] = proc.stderr
    return out


def load(source: str, defines: dict) -> ctypes.CDLL:
    """The loaded library of one specialisation (built on demand)."""
    key = (source, tuple(sorted(defines.items())))
    lib = _libs.get(key)
    if lib is None:
        with _lock:
            lib = _libs.get(key)
            if lib is None:
                lib = ctypes.CDLL(str(build(source, defines)))
                _libs[key] = lib
    return lib


def build_many(jobs) -> list[Path]:
    """Build several ``(source, defines)`` specialisations at once, one
    ``nvcc`` process each, all started together."""
    jobs = list(jobs)
    with concurrent.futures.ThreadPoolExecutor(max(1, len(jobs))) as pool:
        return list(pool.map(lambda job: build(*job), jobs))
