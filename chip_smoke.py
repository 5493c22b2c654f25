#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``pdp_lqr_tpu_torch/ops/csrc`` with
``nvcc`` (into ``build/``), holds each kernel against its plain PyTorch
version on the card, then drives the port's main path through its public
entry point — ``ScenarioServer(quadrotor N=512).solve`` for B=4096
scenarios in float32 — checks the answer against the port's own
sequential Riccati solver in float64, and times the path and its
kernels with CUDA events.  Each phase prints one JSON line; any failed
check raises, so the exit code is non-zero and no result line appears.
It needs one CUDA device and imports nothing of JAX.

Last three lines of the output: the card's name and power limit, one
JSON object describing every kernel, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
                          r"backward_kernel|forward_kernel)"
                          r"(?:I((?:Lb[01]E)+)E)?", name)
            if not m:
                continue
            flags = ",".join(re.findall(r"Lb([01])E", m.group(2) or ""))
            key = f"{m.group(1)}<{flags}>/{scalar}/nc={log[0].get('NC', '-')}"
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
    from pdp_lqr_tpu_torch.models import quadrotor
    from pdp_lqr_tpu_torch.ops import _build, cuda_riccati as cr
    from pdp_lqr_tpu_torch.solvers import sequential

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
        torch.cuda.synchronize()
        launched = {k: cr.LAUNCHES[k] - before[k] for k in cr.LAUNCHES}
        require(launched == {"backward_lanes": 3, "backward_vectors_lanes": 4,
                             "forward_lanes": 3}, launched)
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

    # ---------------------------------------------------------- 5: timing
    solve_ms = cuda_ms(lambda: server.solve(x0_t, c_t), TIMED_REQUESTS)

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

    plain = {
        "backward_lanes": lambda: cr.backward_lanes_reference(
            *k1_in, export_factors=True),
        "backward_vectors_lanes": lambda: cr.backward_vectors_lanes_reference(
            *k2_in, Pc=Pc),
        "forward_lanes": lambda: cr.forward_lanes_reference(*k3_in),
    }
    kernel = {
        "backward_lanes": lambda: cr.backward_lanes(*k1_in, export_factors=True),
        "backward_vectors_lanes": lambda: cr.backward_vectors_lanes(
            *k2_in, shared=True, Pc=Pc),
        "forward_lanes": lambda: cr.forward_lanes(*k3_in, shared=True),
    }
    outputs = {"backward_lanes": k1_out, "backward_vectors_lanes": k2_out,
               "forward_lanes": k3_out}
    out_names = {"backward_lanes": K1_ALL, "backward_vectors_lanes": K2_OUT,
                 "forward_lanes": K3_OUT}
    moved = {
        "backward_lanes": nbytes(*k1_in, *k1_out),
        # P itself is not read in Pc mode.
        "backward_vectors_lanes": nbytes(A_sh, B_sh, c_l, hf_l, Pc, K, L,
                                         pN_l, *k2_out),
        "forward_lanes": nbytes(*k3_in, *k3_out),
    }
    flops = {
        "backward_lanes": k1_flops(N_MAIN, NX, NU, NC, 1),
        "backward_vectors_lanes": k2_flops(N_MAIN, NX, NU, B_MAIN),
        "forward_lanes": k3_flops(N_MAIN, NX, NU, B_MAIN),
    }
    replaces = {
        "backward_lanes": "pdp_lqr_tpu/ops/pallas_riccati.py:778",
        "backward_vectors_lanes": "pdp_lqr_tpu/ops/pallas_riccati.py:1023",
        "forward_lanes": "pdp_lqr_tpu/ops/pallas_riccati.py:1201",
    }
    kernels = []
    for name in ("backward_lanes", "backward_vectors_lanes", "forward_lanes"):
        ms = cuda_ms(kernel[name], TIMED_REQUESTS)
        plain_ms = cuda_ms(plain[name], 2, warmup=1)
        abs_err, rel = rel_err(out_names[name], outputs[name], plain[name]())
        require(max(rel.values()) <= TOL[torch.float32], (name, abs_err, rel))
        bound_ms, bound_by = bound(moved[name], flops[name])
        kernels.append({
            "name": name, "route": "cuda",
            "source": "pdp_lqr_tpu_torch/ops/csrc/riccati_kernels.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": abs_err, "rel_err": rel, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            # No single PyTorch call computes a stage recurrence.
            "library_ms": None,
            "bytes": moved[name], "flops": flops[name],
        })
    fold_ms = cuda_ms(lambda: cr.fold_Pc(P, c_l), TIMED_REQUESTS)
    prep_ms = cuda_ms(lambda: cr.prepare_shared(
        dataclasses.replace(model, c=c_t), it32, x0_t, SIGMA), TIMED_REQUESTS)
    emit("timing", card=card, N=N_MAIN, B=B_MAIN, dtype="float32",
         requests=TIMED_REQUESTS, solve_ms=solve_ms,
         solves_per_s=B_MAIN / (solve_ms * 1e-3),
         kernel_ms={k["name"]: k["ms"] for k in kernels},
         glue_ms={"Pc_fold": fold_ms, "prepare_shared": prep_ms},
         peak_memory_bytes=torch.cuda.max_memory_allocated())

    # ------------------------------------------------------------ 6: end
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
