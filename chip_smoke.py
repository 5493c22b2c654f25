#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``pdp_lqr_tpu_torch/ops/csrc`` with
``nvcc`` (into ``build/``), holds each kernel against its plain PyTorch
version on the card, then drives the port's two main paths through their
public entry points, ``ScenarioServer(quadrotor N=512)`` for B=4096
scenarios in float32: ``solve`` (the inner LQ solve, checked against the
port's own sequential Riccati solver in float64) and ``solve_admm`` (the
conic ADMM loop in split mode: a 20-iteration request checked against the
port's plain path in float64, a small adapting run whose rho changes force
refactorizations, and a cold solve followed by a warm receding-horizon
tick), and times the paths and their kernels with CUDA events.  Each phase
prints one JSON line; any failed check raises, so the exit code is
non-zero and no result line appears.  It needs one CUDA device and imports
nothing of JAX.

Last three lines of the output: the card's name and power limit, one
JSON object describing every kernel, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
SIGMA = 1e-6
RHO = 0.01
NX, NU, NC = 12, 4, 16          # quadrotor, constrained=True
N_MAIN, B_MAIN = 512, 4096      # the serving workload
N_SMALL, B_SMALL = 64, 256      # kernel-vs-plain comparison shape
B_RAGGED = 250                  # not a multiple of a block's 32 scenarios
REQUESTS = 3                    # requests of the counted main-path run
TIMED_REQUESTS = 20
ADMM_TIMED_REQUESTS = 10
ALPHA = 1.6                     # ADMMSettings' relaxation

# The conic ADMM request: the JAX package's bench settings for its split
# iteration (20 iterations, no adaptation inside them, tolerances 1e-4).
ADMM_ITERS = 20
ADMM_SETTINGS = dict(max_iter=ADMM_ITERS, rho_update_interval=25, rho=0.1,
                     eps_abs=1e-4, eps_rel=1e-4, cached_factors=True,
                     uniform_rho=True, diag_cost=True)
NC_CONE = NC + 3                # with the thrust cone's three rows
THRUST_CONE = ((NC, 3, "soc"),)
THRUST_SHIFT = 8.0              # on the cone's t-row
# Kernel B's modes held against the plain version: (name, nc, cones,
# diagonal stage cost, shift).
K5_MODES = (
    ("box,diag", NC, (), True, False),
    ("box,full-Hs", NC, (), False, False),
    ("soc+shift", NC_CONE, THRUST_CONE, True, True),
    ("rsoc", NC, ((4, 5, "rsoc"),), True, False),
)

# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory
# rate and the float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# Kernel (CUDA) against plain version (PyTorch ops), same inputs, each
# output relative to its own largest magnitude.  float64: both are exact
# to rounding.
# float32: the two sum in different orders and the recursion carries the
# difference across the stages, so a few hundred ulps are allowed.
TOL = {torch.float64: 1e-9, torch.float32: 2e-4}
# Main path (float32 kernels) against the sequential solver in float64,
# first 8 scenarios, absolute: 10x the 4.2e-6 measured on an H100 (see
# PERF.md), well under the 1e-3 a float32 solve at N=512 is held to.
MAIN_PATH_ATOL = 5e-5
# The 20-iteration ADMM request (float32 kernels) against the same
# solve_fused on the kernels' plain versions in float64 on the CPU, first
# 8 scenarios, absolute, on ws / w / z / y and the residuals: 10x the
# 6.8e-6 measured on an H100 (see PERF.md).
ADMM_PATH_ATOL = 7e-5
# The adapting run (float32 kernels) against the plain path in float32 on
# the CPU, whole batch, same quantities: 10x the 4.2e-5 measured.
ADMM_REFACTOR_ATOL = 5e-4


def require(ok, *what):
    """A failed check ends the run (also under ``python -O``)."""
    if not ok:
        raise RuntimeError("chip_smoke check failed: " + " ".join(map(str, what)))


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, warmup=2):
    """Median time of ``fn`` in milliseconds, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# Names of the kernels' outputs, in the order the wrappers return them.
K1_ALL = ("K", "d", "M", "v", "P", "L")
K1_GAINS = ("K", "d")
K1_CLOSED = ("K", "d", "M", "v")
K2_OUT = ("d", "v")
K3_OUT = ("ws", "xN")
K4_OUT = ("dv",)
K5_OUT = ("wzy", "hf", "xN", "res")


def rel_err(names, outs, refs):
    """Largest |out - ref| of every output, relative to that output's own
    largest reference magnitude (an output whose reference is all zero
    must be zero too).  Returns the largest absolute error and
    {name: relative error}."""
    require(len(names) == len(outs) == len(refs), (names, len(outs), len(refs)))
    abs_err, rel = 0.0, {}
    for name, out, ref in zip(names, outs, refs):
        require(out.shape == ref.shape, (name, out.shape, ref.shape))
        require(bool(torch.isfinite(out).all()), f"{name}: output not finite")
        err = float((out - ref).abs().max())
        scale = float(ref.abs().max())
        abs_err = max(abs_err, err)
        rel[name] = err / scale if scale > 0 else (0.0 if err == 0 else float("inf"))
    return abs_err, rel


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def random_stage_data(rng, N, nx, nu, nc, Bt, dtype, device):
    """Well-posed random inputs of the matrix sweep, batch-last."""
    nz = nx + nu
    A = rng.normal(size=(Bt, N, nx, nx))
    A /= np.abs(np.linalg.eigvals(A)).max(axis=-1)[..., None, None] * 1.1
    Bm = rng.normal(size=(Bt, N, nx, nu)) * 0.5
    c = rng.normal(size=(Bt, N, nx)) * 0.1
    G = rng.normal(size=(Bt, N, nz, nz)) * 0.3
    H = G @ np.swapaxes(G, -1, -2) + 0.5 * np.eye(nz)
    h = rng.normal(size=(Bt, N, nz)) * 0.3
    D = rng.normal(size=(Bt, N, nc, nz)) * 0.5
    rho = rng.uniform(0.0, 1.0, size=(Bt, N, nc))
    rg = rho * rng.normal(size=(Bt, N, nc))
    GN = rng.normal(size=(Bt, nx, nx)) * 0.3
    PN = GN @ np.swapaxes(GN, -1, -2) + np.eye(nx)
    pN = rng.normal(size=(Bt, nx)) * 0.3
    lanes = lambda x: torch.as_tensor(np.moveaxis(x, 0, -1)).to(
        device=device, dtype=dtype).contiguous()
    return tuple(lanes(x) for x in (A, Bm, c, H, h, D, rho, rg, PN, pN))


def registers_by_kernel(logs):
    """``-Xptxas -v`` output -> {kernel: {registers, spill bytes}}."""
    found = {}
    pat = re.compile(
        r"Compiling entry function '(\S+?)' for 'sm_90a'.*?"
        r"(\d+) bytes spill stores, (\d+) bytes spill loads.*?"
        r"Used (\d+) registers", re.S)
    for log in logs:
        scalar = "f64" if log[0]["SCALAR"] == "double" else "f32"
        for name, st, ld, regs in pat.findall(log[1]):
            m = re.search(r"\d+(backward_vectors_shared_kernel|"
                          r"forward_shared_kernel|backward_vectors_kernel|"
                          r"backward_kernel|forward_kernel|"
                          r"bwd_vec_prefold_kernel|fwd_update_kernel)"
                          r"(?:I((?:Lb[01]E)+)E)?", name)
            if not m:
                continue
            flags = ",".join(re.findall(r"Lb([01])E", m.group(2) or ""))
            key = f"{m.group(1)}<{flags}>/{scalar}/nc={log[0].get('NC', '-')}"
            if "DIAG_COST" in log[0]:
                key += (f",diag={log[0]['DIAG_COST']},shift={log[0]['HAS_SHIFT']}"
                        f",cones={log[0]['NCONES']}")
            found[key] = {"registers": int(regs), "spill_store_bytes": int(st),
                          "spill_load_bytes": int(ld)}
    return found


def k1_flops(N, nx, nu, nc, Bt):
    nz = nx + nu
    per_stage = (
        3 * nz * nz * nc + 2 * nz * nc                  # penalty fold
        + 2 * nx ** 3 + 2 * nx * nx * nu + 2 * nx * nx  # PA PB Pcp
        + 2 * nu * nx * nx + 2 * nu * nx + nx * nu * (nu + 1)  # G rbar Huu
        + nu ** 3 // 3 + 2 * nu * nu * (nx + 1)         # chol, solve
        + nx * (nx + 1) * (nx + nu) + 2 * nx * (nx + nu)    # P+ p+
        + 2 * nx * nx * nu + 2 * nx * nu                # M v
    )
    return N * Bt * per_stage


def k2_flops(N, nx, nu, Bt):
    return N * Bt * (2 * nx * nx + 6 * nx * nu + 2 * nu * nu + nx)


def k3_flops(N, nx, nu, Bt):
    return N * Bt * (2 * nu * nx + 2 * nx * nx)


def k5_flops(N, nx, nu, nc, Bt, diag_cost):
    nz = nx + nu
    per_stage = (
        2 * nu * nx + 2 * nx * nx              # u, x+
        + 4 * nc * nz                          # D w~, D w+
        + 6 * nc * nz                          # hf+, D^T zt, D^T y+
        + (4 * nz if diag_cost else 4 * nz * nz)   # Hs dw, Hs w+
        + 10 * nz + 20 * nc                    # relax, project, dual, maxima
    )
    return N * Bt * per_stage


def random_admm_inputs(rng, A, Bm, K, M, L, nc, Bt, cones, diag_cost,
                       has_shift):
    """Random inputs of the split iteration's two kernels around one
    shared model's matrices (trailing size 1): the argument tuples of
    ``admm_bwd_vec_prefold_lanes`` and of ``admm_fwd_update_lanes`` in its
    packed form (rho, x0, MK, Hs, D, bnd, dv, wzy, h)."""
    N, nx, nu = A.shape[0], A.shape[1], Bm.shape[2]
    nz = nx + nu
    dt, dev = A.dtype, A.device
    T = lambda *s, scale=0.3: torch.as_tensor(
        rng.normal(size=s) * scale).to(device=dev, dtype=dt).contiguous()
    AK, BL, MK = (torch.cat(pair, dim=1) for pair in ((A, K), (Bm, L), (M, K)))
    k4_in = (T(nx, Bt), AK, BL, T(N, nx, Bt, scale=0.1), T(N, nx, Bt),
             T(N, nz, Bt))
    Hs = T(N, nz, 1).abs() + 0.1 if diag_cost else T(N, nz, nz, 1)
    D = T(N, nc, nz, 1, scale=0.5)
    lb, ub = -T(N, nc, 1).abs(), T(N, nc, 1).abs()
    lb[:, ::3] = -float("inf")                 # one-sided and free rows
    ub[:, 1::4] = float("inf")
    # The per-row rho scale: a padded row (0), an equality boost, ones.
    mask = torch.ones((N, nc, 1), dtype=dt, device=dev)
    mask[:, nc - 1 if not cones else 0] = 0.0
    mask[N // 2:, nc // 2] = 1e3
    for off, dim, _ in cones:                  # a cone's rows share their mask
        mask[:, off:off + dim] = 1.0
    parts = [lb, ub, mask] + ([T(N, nc, 1)] if has_shift else [])
    bnd = torch.stack(parts, dim=1).contiguous()
    rho = torch.as_tensor(rng.uniform(0.05, 2.0, size=(1, Bt))).to(
        device=dev, dtype=dt)
    k5_in = (rho, T(nx, Bt), MK, Hs, D, bnd, T(N, nz, Bt),
             T(N, nz + 2 * nc, Bt), T(N, nz, 1))
    return k4_in, k5_in


def k5_call(ca, k5_in, cones):
    """Kernel B's wrapper on the packed argument tuple."""
    rho, x0, MK, Hs, D, bnd, dv, wzy, h = k5_in
    return ca.admm_fwd_update_lanes(
        rho, x0, MK, None, Hs, D, bnd, None, None, None, dv, wzy, nu=NU,
        cones=cones, alpha=ALPHA, sigma=SIGMA, h=h)


def k5_plain(ca, k5_in, cones):
    """Kernel B's plain version on the packed argument tuple."""
    rho, x0, MK, Hs, D, bnd, dv, wzy, h = k5_in
    return ca.admm_fwd_update_lanes_reference(
        rho, x0, MK, Hs, D, bnd, dv, wzy, h, nu=NU, cones=cones, alpha=ALPHA,
        sigma=SIGMA)


@contextlib.contextmanager
def recorded_calls(module, names):
    """While active, ``module.<name>`` also keeps the arguments of its
    last call: how the timing phase gets at the very tensors a path hands
    its kernels."""
    last, originals = {}, {name: getattr(module, name) for name in names}

    def recorder(name):
        def call(*args, **kwargs):
            last[name] = (args, kwargs)
            return originals[name](*args, **kwargs)
        return call

    for name in names:
        setattr(module, name, recorder(name))
    try:
        yield last
    finally:
        for name, fn in originals.items():
            setattr(module, name, fn)


def admm_outputs(ws, state, info, n=None):
    """What the ADMM paths are compared on (of the first ``n`` scenarios),
    by name, as float64 on the CPU."""
    return {name: x[:n].detach().double().cpu() for name, x in (
        ("ws", ws), ("w", state.w), ("z", state.z), ("y", state.y),
        ("r_prim", info.r_prim), ("r_dual", info.r_dual))}


def admm_errors(got, ref):
    errs = {}
    for name in ref:
        require(got[name].shape == ref[name].shape, name, got[name].shape)
        require(bool(torch.isfinite(got[name]).all()), f"{name}: not finite")
        errs[name] = float((got[name] - ref[name]).abs().max())
    return errs


def bound(bytes_moved, flops):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1

    import pdp_lqr_tpu_torch as plt_
    from pdp_lqr_tpu_torch import mpc
    from pdp_lqr_tpu_torch.models import quadrotor
    from pdp_lqr_tpu_torch.ops import _build, cuda_admm as ca, cuda_riccati as cr
    from pdp_lqr_tpu_torch.solvers import admm, sequential

    require("jax" not in sys.modules and "pdp_lqr_tpu" not in sys.modules)
    require(torch.backends.cuda.matmul.allow_tf32 is False)
    dev = torch.device("cuda")

    # ------------------------------------------------------------ 1: env
    card = card_line()
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True).stdout
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    emit("env", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=[l for l in nvcc.splitlines() if "release" in l][0].strip(),
         triton=triton_version, python=sys.version.split()[0])

    # ---------------------------------------------------------- 2: build
    t0 = time.time()
    jobs = []
    for dt in (torch.float32, torch.float64):
        for nc in (NC, 0, None):
            jobs.append((cr.SOURCE, cr.kernel_defines(dt, NX, NU, nc)))
        jobs.append((ca.SOURCE, ca.kernel_defines(dt, NX, NU)))
        for _, nc, cones, diag, shift in K5_MODES:
            jobs.append((ca.SOURCE, ca.kernel_defines(
                dt, NX, NU, nc, cones=cones, diag_cost=diag, has_shift=shift)))
    paths = _build.build_many(jobs)
    regs = registers_by_kernel(
        [(job[1], _build.build_logs.get(path, "")) for job, path in zip(jobs, paths)])
    emit("build", card=card, seconds=round(time.time() - t0, 2),
         libraries=[p.name for p in paths], ptxas=regs)

    # -------------------------------------------------------- 3: kernels
    # Each kernel against its plain version on the same CUDA tensors, at
    # the quadrotor width, N=64, B=256, float64 and float32.
    cases = []
    for dt in (torch.float64, torch.float32):
        rng = np.random.default_rng(SEED)
        before = dict(cr.LAUNCHES)

        def compare(name, names, outs, refs):
            abs_err, rel = rel_err(names, outs, refs)
            cases.append({"kernel": name, "dtype": str(dt).split(".")[-1],
                          "max_abs_err": abs_err, "rel_err": rel,
                          "tol_rel": TOL[dt]})
            require(max(rel.values()) <= TOL[dt], (name, dt, abs_err, rel))

        # K1 on the one shared model (trailing batch 1), all outputs.
        one = random_stage_data(rng, N_SMALL, NX, NU, NC, 1, dt, dev)
        fac = cr.backward_lanes(*one, export_factors=True)
        compare("backward_lanes[batch=1,export]", K1_ALL, fac,
                cr.backward_lanes_reference(*one, export_factors=True))
        # K1 per instance (one block each), gains only.
        few = random_stage_data(rng, N_SMALL, NX, NU, NC, 5, dt, dev)
        compare("backward_lanes[batch=5,gains]", K1_GAINS,
                cr.backward_lanes(*few, emit_closed_loop=False),
                cr.backward_lanes_reference(*few, emit_closed_loop=False))
        # K1 without constraint rows.
        free = random_stage_data(rng, N_SMALL, NX, NU, 0, 2, dt, dev)
        compare("backward_lanes[nc=0]", K1_CLOSED, cr.backward_lanes(*free),
                cr.backward_lanes_reference(*free))

        # K2 / K3, shared model: factors of `one`, B scenarios.
        A, Bm = one[0], one[1]
        K, _, M, _, P, L = fac
        vec = lambda *s: torch.as_tensor(rng.normal(size=s) * 0.3).to(
            device=dev, dtype=dt)
        c = vec(N_SMALL, NX, B_SMALL)
        hf = vec(N_SMALL, NX + NU, B_SMALL)
        pN, x0 = vec(NX, B_SMALL), vec(NX, B_SMALL)
        Pc = cr.fold_Pc(P, c)
        dv = cr.backward_vectors_lanes(A, Bm, c, hf, P, K, L, pN,
                                       shared=True, Pc=Pc)
        compare("backward_vectors_lanes[shared,Pc]", K2_OUT, dv,
                cr.backward_vectors_lanes_reference(A, Bm, c, hf, P, K, L, pN, Pc=Pc))
        compare("backward_vectors_lanes[shared,P]", K2_OUT,
                cr.backward_vectors_lanes(A, Bm, c, hf, P, K, L, pN, shared=True),
                cr.backward_vectors_lanes_reference(A, Bm, c, hf, P, K, L, pN))
        d, v = dv
        compare("forward_lanes[shared]", K3_OUT,
                cr.forward_lanes(M, v, K, d, x0, shared=True),
                cr.forward_lanes_reference(M, v, K, d, x0))
        # The same on a ragged batch: a last block with idle lanes.
        cut = lambda x: x[..., :B_RAGGED].contiguous()
        c_r, hf_r, pN_r, x0_r, Pc_r = (cut(x) for x in (c, hf, pN, x0, Pc))
        dv_r = cr.backward_vectors_lanes(A, Bm, c_r, hf_r, P, K, L, pN_r,
                                         shared=True, Pc=Pc_r)
        compare(f"backward_vectors_lanes[shared,Pc,B={B_RAGGED}]", K2_OUT, dv_r,
                cr.backward_vectors_lanes_reference(
                    A, Bm, c_r, hf_r, P, K, L, pN_r, Pc=Pc_r))
        compare(f"forward_lanes[shared,B={B_RAGGED}]", K3_OUT,
                cr.forward_lanes(M, dv_r[1], K, dv_r[0], x0_r, shared=True),
                cr.forward_lanes_reference(M, dv_r[1], K, dv_r[0], x0_r))

        # K2 / K3, one matrix set per scenario (trailing batch = B).
        wide = lambda x: x.expand(x.shape[:-1] + (B_SMALL,)).contiguous()
        Aw, Bw, Kw, Mw, Pw, Lw = (wide(x) for x in (A, Bm, K, M, P, L))
        compare("backward_vectors_lanes[per-instance,P]", K2_OUT,
                cr.backward_vectors_lanes(Aw, Bw, c, hf, Pw, Kw, Lw, pN),
                cr.backward_vectors_lanes_reference(Aw, Bw, c, hf, Pw, Kw, Lw, pN))
        compare("forward_lanes[per-instance]", K3_OUT,
                cr.forward_lanes(Mw, v, Kw, d, x0),
                cr.forward_lanes_reference(Mw, v, Kw, d, x0))

        # The split ADMM iteration's pair around the same shared model:
        # kernel A once per batch size, kernel B in each of its modes.
        before_admm = dict(ca.LAUNCHES)
        for Bt in (B_SMALL, B_RAGGED):
            for mode, nc, cones, diag, shift in K5_MODES:
                k4_in, k5_in = random_admm_inputs(
                    rng, A, Bm, K, M, L, nc, Bt, cones, diag, shift)
                if mode == K5_MODES[0][0]:
                    compare(f"admm_bwd_vec_prefold_lanes[B={Bt}]", K4_OUT,
                            [ca.admm_bwd_vec_prefold_lanes(*k4_in, nu=NU)],
                            [ca.admm_bwd_vec_prefold_lanes_reference(*k4_in, nu=NU)])
                compare(f"admm_fwd_update_lanes[{mode},B={Bt}]", K5_OUT,
                        k5_call(ca, k5_in, cones), k5_plain(ca, k5_in, cones))
        torch.cuda.synchronize()
        launched = {k: cr.LAUNCHES[k] - before[k] for k in cr.LAUNCHES}
        require(launched == {"backward_lanes": 3, "backward_vectors_lanes": 4,
                             "forward_lanes": 3}, launched)
        launched = {k: ca.LAUNCHES[k] - before_admm[k] for k in ca.LAUNCHES}
        require(launched == {"admm_bwd_vec_prefold_lanes": 2,
                             "admm_fwd_update_lanes": 2 * len(K5_MODES)}, launched)
    emit("kernels", card=card, shape={"N": N_SMALL, "B": B_SMALL, "nx": NX,
                                      "nu": NU, "nc": NC}, cases=cases)

    # ------------------------------------------------------ 4: main path
    model, _ = quadrotor(N=N_MAIN, constrained=True, dtype=torch.float32,
                         device=dev)
    require((model.nx, model.nu, model.nc) == (NX, NU, NC))
    server = plt_.ScenarioServer(model, rho=RHO, sigma=SIGMA, device=dev)
    rng = np.random.default_rng(SEED)
    c_b = (rng.normal(size=(B_MAIN, N_MAIN, NX)) * 0.01).astype(np.float32)
    x0s = rng.normal(size=(B_MAIN, NX)).astype(np.float32) * 0.1
    c_t = torch.as_tensor(c_b).to(dev)
    x0_t = torch.as_tensor(x0s).to(dev)
    server.solve(x0_t, c_t)                      # builds nothing new; warms up
    torch.cuda.synchronize()

    cr.reset_launch_counts()
    for _ in range(REQUESTS):
        ws = server.solve(x0_t, c_t)
    torch.cuda.synchronize()
    launches = dict(cr.LAUNCHES)
    require(launches == {k: REQUESTS for k in launches}, launches)
    require(ws.shape == (B_MAIN, N_MAIN + 1, NX + NU), ws.shape)
    require(ws.dtype == torch.float32 and ws.device.type == "cuda")
    require(bool(torch.isfinite(ws).all()), "main path: non-finite output")

    # The port's own witness: sequential square-root Riccati, float64, on
    # the card, for the first 8 scenarios.
    n_ref = 8
    m64 = model.to(dtype=torch.float64)
    it64 = plt_.init_iterates(m64, rho=RHO)
    tile = lambda x: x.expand((n_ref,) + x.shape)
    bm = plt_.LQRProblem(**{f.name: tile(getattr(m64, f.name))
                            for f in dataclasses.fields(m64)})
    bm = dataclasses.replace(bm, c=c_t[:n_ref].double())
    bit = plt_.ADMMIterates(**{f.name: tile(getattr(it64, f.name))
                               for f in dataclasses.fields(it64)})
    ws_ref, _ = sequential.solve_batched(bm, bit, x0_t[:n_ref].double(), SIGMA)
    main_err = float((ws[:n_ref].double() - ws_ref).abs().max())
    main_scale = float(ws_ref.abs().max())
    require(main_err <= MAIN_PATH_ATOL, main_err)
    emit("main_path", card=card, model="quadrotor constrained", N=N_MAIN,
         B=B_MAIN, dtype="float32", requests=REQUESTS, launches=launches,
         out_shape=list(ws.shape), max_abs_err_vs_sequential_f64=main_err,
         ref_max_magnitude=main_scale, atol=MAIN_PATH_ATOL)

    # ------------------------------------------- 5: the conic ADMM request
    # ScenarioServer.solve_admm at full width: 20 split iterations from
    # zero iterates, per-scenario start state and drift.
    settings = admm.ADMMSettings(**ADMM_SETTINGS)
    rng = np.random.default_rng(SEED)
    c_a = (rng.normal(size=(B_MAIN, N_MAIN, NX)) * 0.01).astype(np.float32)
    x0_a = (0.03 + 0.01 * rng.normal(size=(B_MAIN, NX))).astype(np.float32)
    ca_t = torch.as_tensor(c_a).to(dev)
    x0a_t = torch.as_tensor(x0_a).to(dev)
    admm_request = lambda: server.solve_admm(x0a_t, (), settings, c=ca_t)
    admm_request()                               # builds nothing new; warms up
    torch.cuda.synchronize()

    def reset_counts():
        cr.reset_launch_counts()
        ca.reset_launch_counts()
        admm.reset_host_reads()

    reset_counts()
    with recorded_calls(ca, list(ca.LAUNCHES)) as admm_args:
        ws_a, state_a, info_a = admm_request()
    torch.cuda.synchronize()
    admm_launches = {**cr.LAUNCHES, **ca.LAUNCHES}
    host_reads = dict(admm.HOST_READS)
    require(admm_launches == {
        "backward_lanes": 1, "backward_vectors_lanes": 0, "forward_lanes": 0,
        "admm_bwd_vec_prefold_lanes": ADMM_ITERS,
        "admm_fwd_update_lanes": ADMM_ITERS}, admm_launches)
    require(ws_a.shape == (B_MAIN, N_MAIN + 1, NX + NU), ws_a.shape)
    require(state_a.z.shape == state_a.y.shape == (B_MAIN, N_MAIN + 1, NC))
    require(state_a.rho.shape == (B_MAIN,) and state_a.factors is not None)
    for x in (ws_a, state_a.z, state_a.y, state_a.rho, info_a.r_prim):
        require(x.dtype == torch.float32 and x.device.type == "cuda")
    require(bool((info_a.iterations == ADMM_ITERS).all()))

    # The port's own plain path: the same solve_fused on the kernels'
    # plain versions, float64, on the CPU, for the first 8 scenarios.  (No
    # adaptation happens inside 20 iterations, so a subset follows the
    # same uniform rho as the whole batch.)
    cpu_model = model.to(device="cpu", dtype=torch.float64)
    cpu_server = plt_.ScenarioServer(cpu_model, rho=RHO, sigma=SIGMA, device="cpu")
    ref = admm_outputs(*cpu_server.solve_admm(
        x0_a[:n_ref].astype(np.float64), (), settings,
        c=c_a[:n_ref].astype(np.float64)))
    errs = admm_errors(admm_outputs(ws_a, state_a, info_a, n_ref), ref)
    require(max(errs.values()) <= ADMM_PATH_ATOL, errs)
    emit("admm_path", card=card, model="quadrotor constrained", N=N_MAIN,
         B=B_MAIN, dtype="float32", settings=ADMM_SETTINGS,
         launches=admm_launches, host_reads=host_reads,
         out_shape=list(ws_a.shape), max_abs_err_vs_plain_f64=errs,
         ref_max_magnitude={k: float(v.abs().max()) for k, v in ref.items()},
         atol=ADMM_PATH_ATOL,
         r_prim_max=float(info_a.r_prim.max()), r_dual_max=float(info_a.r_dual.max()))

    # ------------------------------------- 6: adaptation and refactorization
    # A small adapting run (thrust cone with a shift; rho starts far from
    # balance, so the update on every 10th iteration fires): the kernel path
    # against the plain path on the whole batch, float32 both.
    model_s, cones_s = quadrotor(N=N_SMALL, constrained=True, thrust_cone=True,
                                 dtype=torch.float32, device=dev)
    require(model_s.nc == NC_CONE and tuple(cones_s) == ((NC, 3),))
    shift_s = np.zeros((N_SMALL + 1, NC_CONE), np.float32)
    shift_s[:, NC] = THRUST_SHIFT
    st_r = admm.ADMMSettings(**{**ADMM_SETTINGS, "max_iter": 60,
                                "rho_update_interval": 10, "rho": 1e-3})
    rng = np.random.default_rng(SEED + 1)
    x0_s = (rng.normal(size=(B_SMALL, NX)) * 0.05).astype(np.float32)
    c_s = (rng.normal(size=(B_SMALL, N_SMALL, NX)) * 0.01).astype(np.float32)
    small = plt_.ScenarioServer(model_s, device=dev)
    reset_counts()
    out_r = small.solve_admm(x0_s, cones_s, st_r, soc_shift=shift_s, c=c_s)
    torch.cuda.synchronize()
    refactor_launches = {**cr.LAUNCHES, **ca.LAUNCHES}
    refactor_reads = dict(admm.HOST_READS)
    require(refactor_launches["backward_lanes"] > 1, refactor_launches)
    require(refactor_launches["admm_fwd_update_lanes"] == 60, refactor_launches)
    ref_r = plt_.ScenarioServer(model_s.to(device="cpu"), device="cpu").solve_admm(
        x0_s, cones_s, st_r, soc_shift=shift_s, c=c_s)
    require(bool((out_r[2].iterations.cpu() == ref_r[2].iterations).all()))
    errs_r = admm_errors(admm_outputs(*out_r), admm_outputs(*ref_r))
    rho_r, rho_ref = float(out_r[1].rho[0]), float(ref_r[1].rho[0])
    require(rho_r != st_r.rho and abs(rho_r - rho_ref) <= 1e-3 * rho_ref,
            rho_r, rho_ref)
    require(max(errs_r.values()) <= ADMM_REFACTOR_ATOL, errs_r)
    emit("admm_refactor", card=card, model="quadrotor constrained + thrust cone",
         N=N_SMALL, B=B_SMALL, dtype="float32", iterations=60,
         rho_update_interval=10, rho_start=st_r.rho, rho_end=rho_r,
         rho_end_plain=rho_ref, launches=refactor_launches,
         host_reads=refactor_reads, max_abs_err_vs_plain_f32=errs_r,
         atol=ADMM_REFACTOR_ATOL)

    # ------------------------------------------------ 7: cold solve, warm tick
    # Receding-horizon serving at full width: solve cold to convergence,
    # advance every scenario's state through the solved dynamics plus a
    # small disturbance, shift the state one stage, and solve the next tick
    # warm on the factors the state carries.
    st_cold = dataclasses.replace(settings, early_exit=True, max_iter=300)
    st_warm = dataclasses.replace(settings, early_exit=True)
    reset_counts()
    ws_c, state_c, info_c = server.solve_admm(x0a_t, (), st_cold)
    torch.cuda.synchronize()
    cold_launches = {**cr.LAUNCHES, **ca.LAUNCHES}
    u0 = ws_c[:, 0, :NU]
    x_next = (x0a_t @ model.A[0].T + u0 @ model.B[0].T + model.c[0]
              + torch.as_tensor(rng.normal(size=x0_a.shape) * 1e-4).to(
                  device=dev, dtype=torch.float32))
    state_s = mpc.shift_state(state_c, model)
    warm_tick = lambda: server.solve_admm(x_next, (), st_warm, state=state_s)
    reset_counts()
    ws_w, state_w, info_w = warm_tick()
    torch.cuda.synchronize()
    warm_launches = {**cr.LAUNCHES, **ca.LAUNCHES}
    warm_reads = dict(admm.HOST_READS)
    require(warm_launches["backward_lanes"] == 0, warm_launches)
    require(bool(torch.isfinite(ws_w).all()), "warm tick: non-finite output")
    cold_iters, warm_iters = int(info_c.iterations[0]), int(info_w.iterations[0])
    require(bool(info_c.converged.all()), "cold solve: not all converged", cold_iters)
    require(bool(info_w.converged.all()), "warm tick: not all converged", warm_iters)
    emit("admm_warm", card=card, N=N_MAIN, B=B_MAIN, dtype="float32",
         cold_iterations=cold_iters, warm_iterations=warm_iters,
         cold_launches=cold_launches, warm_launches=warm_launches,
         warm_host_reads=warm_reads, rho_after_cold=float(state_c.rho[0]),
         warm_iter_converged_max=int(info_w.iter_converged.max()))

    # ---------------------------------------------------------- 8: timing
    # Peak device memory of a path: the largest allocation while its
    # requests are timed, the tensors that earlier phases still hold included.
    torch.cuda.reset_peak_memory_stats()
    solve_ms = cuda_ms(lambda: server.solve(x0_t, c_t), TIMED_REQUESTS)
    solve_peak = torch.cuda.max_memory_allocated()

    # The kernels alone, on the tensors the main path hands them.
    it32 = plt_.init_iterates(model, rho=RHO)
    prep = cr.prepare_shared(dataclasses.replace(model, c=c_t), it32, x0_t, SIGMA)
    A_sh, B_sh, H_sh, D_sh, rho_sh, PN_sh, c_l, hf_l, pN_l, x0_l, _ = prep
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    k1_in = (A_sh, B_sh, zeros(N_MAIN, NX, 1), H_sh, zeros(N_MAIN, NX + NU, 1),
             D_sh, rho_sh, zeros(N_MAIN, NC, 1), PN_sh, zeros(NX, 1))
    k1_out = cr.backward_lanes(*k1_in, export_factors=True)
    K, _, M, _, P, L = k1_out
    Pc = cr.fold_Pc(P, c_l)
    k2_in = (A_sh, B_sh, c_l, hf_l, P, K, L, pN_l)
    k2_out = cr.backward_vectors_lanes(*k2_in, shared=True, Pc=Pc)
    d, v = k2_out
    k3_in = (M, v, K, d, x0_l)
    k3_out = cr.forward_lanes(*k3_in, shared=True)

    # The ADMM pair on the tensors of the counted request's last iteration.
    K4, K5 = "admm_bwd_vec_prefold_lanes", "admm_fwd_update_lanes"
    k4_args, k4_kw = admm_args[K4]
    a5, k5_kw = admm_args[K5]
    k5_in = (a5[0], a5[1], a5[2], a5[4], a5[5], a5[6], a5[10], a5[11], k5_kw["h"])
    require(k5_kw["alpha"] == ALPHA and k5_kw["sigma"] == SIGMA
            and k5_kw["cones"] == ())
    k4_out = [ca.admm_bwd_vec_prefold_lanes(*k4_args, **k4_kw)]
    k5_out = k5_call(ca, k5_in, ())

    plain = {
        "backward_lanes": lambda: cr.backward_lanes_reference(
            *k1_in, export_factors=True),
        "backward_vectors_lanes": lambda: cr.backward_vectors_lanes_reference(
            *k2_in, Pc=Pc),
        "forward_lanes": lambda: cr.forward_lanes_reference(*k3_in),
        K4: lambda: [ca.admm_bwd_vec_prefold_lanes_reference(*k4_args, **k4_kw)],
        K5: lambda: k5_plain(ca, k5_in, ()),
    }
    kernel = {
        "backward_lanes": lambda: cr.backward_lanes(*k1_in, export_factors=True),
        "backward_vectors_lanes": lambda: cr.backward_vectors_lanes(
            *k2_in, shared=True, Pc=Pc),
        "forward_lanes": lambda: cr.forward_lanes(*k3_in, shared=True),
        K4: lambda: [ca.admm_bwd_vec_prefold_lanes(*k4_args, **k4_kw)],
        K5: lambda: k5_call(ca, k5_in, ()),
    }
    outputs = {"backward_lanes": k1_out, "backward_vectors_lanes": k2_out,
               "forward_lanes": k3_out, K4: k4_out, K5: k5_out}
    out_names = {"backward_lanes": K1_ALL, "backward_vectors_lanes": K2_OUT,
                 "forward_lanes": K3_OUT, K4: K4_OUT, K5: K5_OUT}
    moved = {
        "backward_lanes": nbytes(*k1_in, *k1_out),
        # P itself is not read in Pc mode.
        "backward_vectors_lanes": nbytes(A_sh, B_sh, c_l, hf_l, Pc, K, L,
                                         pN_l, *k2_out),
        "forward_lanes": nbytes(*k3_in, *k3_out),
        K4: nbytes(*k4_args, *k4_out),
        K5: nbytes(*k5_in, *k5_out),
    }
    flops = {
        "backward_lanes": k1_flops(N_MAIN, NX, NU, NC, 1),
        "backward_vectors_lanes": k2_flops(N_MAIN, NX, NU, B_MAIN),
        "forward_lanes": k3_flops(N_MAIN, NX, NU, B_MAIN),
        K4: k2_flops(N_MAIN, NX, NU, B_MAIN),        # K2's recursion
        K5: k5_flops(N_MAIN, NX, NU, NC, B_MAIN, ADMM_SETTINGS["diag_cost"]),
    }
    replaces = {
        "backward_lanes": "pdp_lqr_tpu/ops/pallas_riccati.py:778",
        "backward_vectors_lanes": "pdp_lqr_tpu/ops/pallas_riccati.py:1023",
        "forward_lanes": "pdp_lqr_tpu/ops/pallas_riccati.py:1201",
        K4: "pdp_lqr_tpu/ops/pallas_admm.py:526",
        K5: "pdp_lqr_tpu/ops/pallas_admm.py:867",
    }
    # Launches of the two main paths, each counted from zero: REQUESTS
    # requests of `solve`, one 20-iteration request of `solve_admm`.
    by_path = {name: {"solve": launches.get(name, 0),
                      "solve_admm": admm_launches[name]} for name in admm_launches}
    kernels = []
    for name in ("backward_lanes", "backward_vectors_lanes", "forward_lanes",
                 K4, K5):
        ms = cuda_ms(kernel[name], TIMED_REQUESTS)
        plain_ms = cuda_ms(plain[name], 2, warmup=1)
        abs_err, rel = rel_err(out_names[name], outputs[name], plain[name]())
        require(max(rel.values()) <= TOL[torch.float32], (name, abs_err, rel))
        bound_ms, bound_by = bound(moved[name], flops[name])
        kernels.append({
            "name": name, "route": "cuda",
            "source": "pdp_lqr_tpu_torch/ops/csrc/" + (
                ca.SOURCE if name in ca.LAUNCHES else cr.SOURCE),
            "replaces": replaces[name], "launches": sum(by_path[name].values()),
            "launches_by_path": by_path[name],
            "max_abs_err": abs_err, "rel_err": rel, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            # No single PyTorch call computes a stage recurrence.
            "library_ms": None,
            "bytes": moved[name], "flops": flops[name],
        })
    fold_ms = cuda_ms(lambda: cr.fold_Pc(P, c_l), TIMED_REQUESTS)
    prep_ms = cuda_ms(lambda: cr.prepare_shared(
        dataclasses.replace(model, c=c_t), it32, x0_t, SIGMA), TIMED_REQUESTS)
    # The ADMM request and the warm tick, whole; what an iteration costs
    # beside its two kernels (the terminal stage, the statistics, the
    # host's launches, and a 20th of the request's set-up and factor build).
    torch.cuda.reset_peak_memory_stats()
    admm_ms = cuda_ms(admm_request, ADMM_TIMED_REQUESTS)
    admm_peak = torch.cuda.max_memory_allocated()
    warm_ms = cuda_ms(warm_tick, ADMM_TIMED_REQUESTS)
    kernel_ms = {k["name"]: k["ms"] for k in kernels}
    emit("timing", card=card, N=N_MAIN, B=B_MAIN, dtype="float32",
         requests=TIMED_REQUESTS, solve_ms=solve_ms,
         solves_per_s=B_MAIN / (solve_ms * 1e-3),
         kernel_ms=kernel_ms,
         glue_ms={"Pc_fold": fold_ms, "prepare_shared": prep_ms},
         peak_memory_bytes=solve_peak,
         admm={"requests": ADMM_TIMED_REQUESTS, "iterations": ADMM_ITERS,
               "request_ms": admm_ms,
               "solves_per_s": B_MAIN / (admm_ms * 1e-3),
               "iterations_per_s": ADMM_ITERS / (admm_ms * 1e-3),
               "ms_per_iteration_beside_kernels":
                   (admm_ms - kernel_ms["backward_lanes"]) / ADMM_ITERS
                   - kernel_ms[K4] - kernel_ms[K5],
               "host_reads_per_request": host_reads,
               "warm_tick_ms": warm_ms, "warm_iterations": warm_iters,
               "warm_ticks_per_s": 1e3 / warm_ms,
               "warm_solves_per_s": B_MAIN / (warm_ms * 1e-3),
               "warm_host_reads_per_tick": warm_reads,
               "peak_memory_bytes": admm_peak})

    # ------------------------------------------------------------ 9: end
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
