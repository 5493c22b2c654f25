#!/usr/bin/env python3
"""Time the matrix sweep (K1, K9, K11), K8 in each of its forms,
per-instance K3, K2, K5, K4, K6, K7 and K12 at the shapes their paths give
them, and K1-K5 and K8 at the widest models' requests, on the card.

    python3 scripts/kernel_bench.py [--root DIR] [--reps 20]
                                    [--kernels sweep latency k8 k3 k2 k5
                                               k4 k6 k7 k10 wide]
                                    [--profile] [--bf16]
                                    [--batches B ...] [--match S ...]
                                    [--define NAME=VALUE ...]

The matrix sweep runs on the tensors its paths hand it (each path run
once with the kernels' calls recorded, as ``chip_smoke.py`` does; the
quadrotor at N=512, float32): K1 on the one shared model (``solve``,
Bt=1), K1 per instance with the closed-loop maps (the
replicated loop, B=1024) and gains only (``solve_lanes``, B=4096), K9 in
S=8 segments (``pdp_sharded_fused.solve``, B=1024) and exporting its
factors (the cached ``admm_sharded`` loop, thrust cone, B=1024), and K11
(``solve_packed``, B=4096).  ``latency``, the block of one instance and
where it gives way to groups: K1 on the shared model (as in ``sweep``),
and K9 in one segment at N=1024 on B = 128, 160, 256 and 512 instances
(``pdp_sharded_fused.solve``: the long-horizon case of ``chip_smoke.py``'s
``pdp_latency``, then batches past the card's 132 SMs).  K9's F0 there,
the product of 1,024 closed-loop maps, is about 1e-63 and underflows in
float32: its error is taken against the scale of the carry it starts
from (the identity), not against its own.  K8's and K3's inputs are synthetic
(``chip_smoke.py``'s generators, seed 0) at the quadrotor's widths,
float32: K8 on one model at N=64 and, on cached factors, N=512 (B=4096;
the cached form also with bfloat16 stage data), on a batched problem at
N=64 (B=1024: uncached, cached, cached with bfloat16) and at N=512 with
the thrust cone and a shift (B=1024, the PDP cell's
``solve_fused(auto)``), and at the rocket's widths (N=48, B=512, two
cones); K3 per instance at N=512, B=1024 in one segment and in 8.  ``k2``
and ``k5`` take the tensors their paths hand them (each path run once with
the calls recorded): K2 on the shared model in both modes (``solve``,
B=4096) and per instance (the replicated cached loop, B=1024); K5 packed
with and without hf-emit (``solve_admm``, B=4096) and its rung form (the
four-rung ladder).  ``k4`` and ``k6``: kernel A on the tensors of the
last iteration of the 20-iteration ``solve_admm`` request (K4) and of the
four-rung ladder request (K6, R=4), B=4096.  ``k7``: the rollout from
the raw dynamics on the tensors ``solve_lanes`` hands K7 and
``solve_packed`` hands K12 (B=4096; ``--batches`` others, e.g. 4094 and 4095,
whose rows no copy-engine box takes).  ``k10``: the cached PDP vector
sweep on the tensors the cached ``pdp_admm`` request hands it
(``admm_sharded.solve`` with cached factors: the thrust-cone quadrotor
with a shift, N=512, S=8, B=1024, float32; the same in float64; and its
first 1023, 1022 and 1021 scenarios, batches whose rows no copy-engine box
takes, in float32, and 1023 in float64), then
at ``kernels_wide``'s shapes (the mass-spring chain and the centroidal
model, N=64, S=4, B=256, random stage data and the plain K9's exported
factors, float32 and float64).  ``wide``: K1-K5 and K8 on the
tensors the four requests of the two widest models hand them (each run
once with the calls recorded, as ``chip_smoke.py``'s phases
``mass_spring_solve``, ``centroidal_solve``, ``centroidal_admm_split`` and
``centroidal_admm_single`` run them: float32, mass-spring N=512, B=2048;
centroidal N=1024, B=4096 and, in the ADMM loop, B=2048); a tree without
those models cannot run it.  ``--bf16`` adds the forms on bfloat16 stage
streams to ``sweep`` (K1 gains only and K11, on the tensors
``solve_lanes`` and ``solve_packed`` hand them with
``storage_dtype=torch.bfloat16``, B=4096; then K1 gains only in both forms
at the centroidal model's N=1024, B=4096, ``centroidal_lanes_bf16``'s
request), to ``k7`` (K7 and K12 on
theirs) and to ``k4``, ``k5`` and ``k6`` (the narrow forms of K4 and K5
packed on the tensors of the split request with
``storage_dtype=torch.bfloat16``, of K6 and K5's rung form on the
ladder's; ``k5`` also times K5 packed, full and narrow, at
``kernels_wide``'s shapes, N=64, B=256, at both wide widths, float32 and
float64); a tree
without them cannot run it.  Each form is held against its
plain version first.  ``--root DIR`` imports
``pdp_lqr_tpu_torch`` from another checkout (its kernels built from its
own sources into its own ``build/``), so two versions are timed on one
card by running this script once for each, in turns.  ``--define NAME=VALUE``
builds every library with a further preprocessor define (a design's
compile-time switch, timed beside the tree's own form).  ``--match`` times
only the matrix sweep's forms whose names hold one of the given strings
(``--match bf16 gains,B= centroidal``: the narrow forms beside the full
ones they are compared with).

Prints one JSON line a form: the median time of ``--reps`` launches by CUDA
events, the bound (the larger of its bytes over 3.35 TB/s and its
operations over 67 TFLOP/s), the error against the plain version, and
the registers and spills ``ptxas`` reported for the library's kernels.
``--profile`` builds K8, K5, K4 and K6 with their diagnostic
``-DADMM_PROFILE`` and K2, K7, K12 and K10 (with ``sweep`` also the matrix
sweep, K1, K9 and K11) with ``-DRICCATI_PROFILE`` (thread 0 of block 0,
or lane 0 of each role's first warp, sums the SM cycles of each section of
a stage; a fold or tail warp's per stage it took) and adds the cycles a
stage of each section to their lines (where the tree's kernel has them);
that build's times and registers are not the kernel's own.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
B_SHARED, B_BATCHED, B_ROCKET = 4096, 1024, 512
ROCKET = (6, 3, 7, ((1, 3, "soc"), (4, 3, "soc")))      # nx, nu, nc, cones
THRUST = ((16, 3, "soc"),)
# K8's sections under -DADMM_PROFILE (phase 1, then phase 2).
SECTIONS = ["p1_wait_barrier", "p1_prefetch", "p1_rho_terms", "p1_fold",
            "p1_sweep", "p2_wait_barrier", "p2_prefetch", "p2_w~", "p2_x+",
            "p2_constraint_rows", "p2_projection", "p2_rows_of_w"]

# K9's long-horizon shapes (``latency``): N, and the batches in one segment.
N_LAT, B_LAT = 1024, (128, 160, 256, 512)
# K2's and K5's sections under -DRICCATI_PROFILE / -DADMM_PROFILE (lane 0
# of each role's warp in block 0; a tail warp's per stage it took).
K2_SECTIONS = {
    "per-instance": ["compute: wait full", "compute: Pcp rbar p (chain)",
                     "compute: next Pc", "compute: d v stores",
                     "producer: wait empty", "producer: copies"],
    "shared": ["producer: wait empty", "producer: copies",
               "chain: wait full", "chain: Pcp rbar p",
               "tail: wait ready", "tail: d v stores"],
}
K5_SECTIONS = ["producer: wait empty", "producer: copies",
               "chain: wait full", "chain: x+", "tail: wait ready",
               "tail: u w~ w+ cone values", "tail: constraint rows",
               "tail: rows of w"]
# K4's and K6's (kernel A; K4 has no fold warps).
KA_SECTIONS = ["producer: wait empty", "producer: copies",
               "fold: wait full", "fold: rg hf Pc", "chain: wait",
               "chain: Pcp rbar p", "tail: wait ready", "tail: d v stores",
               "widen: wait full", "widen: widen"]
# K7's and K12's (producer 0 of 2, the chain, the store warp).
K7_SECTIONS = ["producer: wait empty", "producer: copies",
               "chain: wait full", "chain: u x+", "chain: wait out slot",
               "chain: out rows", "store: wait full", "store: ws rows"]
# K10's (producer 0 of 4, the chain, the tail; a cycles a stage of the
# segment's sweep, block 0: segment 0's first scenarios).
K10_SECTIONS = ["producer: wait empty", "producer: copies",
                "chain: wait full", "chain: Pcp rbar p", "tail: wait ready",
                "tail: d v f stores"]
# The narrow K5's widening warp (after K5_SECTIONS; this tree's narrow
# form only).
K5_WIDEN_SECTIONS = ["widen: wait empty", "widen: stores"]
# The matrix sweep's under -DRICCATI_PROFILE: thread 0 of block 0 (lane 0
# of instance 0's warp; a block of one instance: its thread 0).  "wait":
# for the stage's copies and the block's barrier (the narrow forms: also
# the block's widening of the next stage at the end of the stage before);
# "copies": issuing them (narrow: the staging's boxes or pairs).
SWEEP_SECTIONS = ["wait: stage n", "stores", "copies (narrow: staging)",
                  "A: Dr and [P;F][A c B]", "B: fold and B^T[PA Pcp PB]",
                  "C: chol and solves", "D: P+ p+ C", "D: M v F f"]


def sweep_runs(sm, dev, shared_only=False, bf16=False, batches=None):
    """Run each path of the matrix sweep once at its serving shape with
    the kernels' calls recorded: name -> (launcher, args, kwargs, output
    names, operations).  ``bf16``: also solve_lanes' and solve_packed's
    on bfloat16 stage streams.  ``batches`` (at most 4096): solve_lanes'
    K1, full width and (``bf16``) narrow, also at these."""
    import dataclasses
    import pdp_lqr_tpu_torch as plt_
    from pdp_lqr_tpu_torch.models import quadrotor
    from pdp_lqr_tpu_torch.ops import cuda_riccati as cr
    from pdp_lqr_tpu_torch.parallel import admm_sharded, make_mesh
    from pdp_lqr_tpu_torch.parallel import pdp_sharded_fused as psf
    from pdp_lqr_tpu_torch.solvers import admm

    N, NX, NU, NC, f32 = sm.N_MAIN, sm.NX, sm.NU, sm.NC, torch.float32
    model, _ = quadrotor(N=N, constrained=True, dtype=f32, device=dev)
    it = plt_.init_iterates(model, rho=sm.RHO)
    rng = np.random.default_rng(sm.SEED)
    c = torch.as_tensor(rng.normal(size=(sm.B_MAIN, N, NX)) * 0.01).to(
        device=dev, dtype=f32)
    x0 = torch.as_tensor(0.03 + 0.01 * rng.normal(size=(sm.B_MAIN, NX))).to(
        device=dev, dtype=f32)
    wide = lambda n, x: x[None].expand((n,) + x.shape)
    it_b = lambda n: plt_.ADMMIterates(**{
        f.name: wide(n, getattr(it, f.name)) for f in dataclasses.fields(it)})
    one_step = admm.ADMMSettings(**{**sm.REP_SETTINGS, "max_iter": 1})
    runs = {}

    def record(name, counter, call, names, flops):
        with sm.recorded_calls(cr, [counter]) as rec:
            call()
        torch.cuda.synchronize()
        runs[name] = (getattr(cr, counter), *rec[counter], names, flops)

    prep = cr.prepare_shared(dataclasses.replace(model, c=c), it, x0, sm.SIGMA)
    record("backward_lanes[shared]", "backward_lanes",
           lambda: cr.shared_factors(prep), sm.K1_ALL,
           sm.k1_flops(N, NX, NU, NC, 1))
    if shared_only:
        return runs
    B = sm.B_REP
    record("backward_lanes[per-instance]", "backward_lanes",
           lambda: plt_.solve_fused(sm.batched(model, B, c[:B]), x0[:B], (),
                                    one_step, single_kernel=False),
           sm.K1_CLOSED, sm.k1_flops(N, NX, NU, NC, B))
    lanes = sm.batched(model, sm.B_MAIN, c)
    record("backward_lanes[per-instance,gains]", "backward_lanes",
           lambda: cr.solve_lanes(lanes, it_b(sm.B_MAIN), x0, sm.SIGMA),
           sm.K1_GAINS, sm.k1_flops(N, NX, NU, NC, sm.B_MAIN))
    B = sm.B_PDP
    record("backward_pdp_lanes", "backward_pdp_lanes",
           lambda: psf.solve(make_mesh(time=sm.S_PDP, device=dev),
                             sm.batched(model, B, c[:B]), it_b(B), x0[:B],
                             sm.SIGMA),
           sm.K9_OUT, sm.k9_flops(N, NX, NU, NC, B))
    cone, cones = quadrotor(N=N, constrained=True, thrust_cone=True,
                            dtype=f32, device=dev)
    shift = np.zeros((N + 1, sm.NC_CONE), np.float32)
    shift[:, NC] = sm.THRUST_SHIFT
    record("backward_pdp_lanes[export]", "backward_pdp_lanes",
           lambda: admm_sharded.solve(
               make_mesh(time=sm.S_PDP, device=dev),
               sm.batched(cone, B, c[:B]), x0[:B], cones,
               dataclasses.replace(one_step, cached_factors=True),
               soc_shift=shift),
           sm.K9_ALL, sm.k9_flops(N, NX, NU, sm.NC_CONE, B))
    record("backward_packed", "backward_packed",
           lambda: cr.solve_packed(lanes, it_b(sm.B_MAIN), x0, sm.SIGMA),
           ("G",), sm.k1_flops(N, NX, NU, NC, sm.B_MAIN))
    if bf16:
        narrow = dict(storage_dtype=torch.bfloat16)
        record("backward_lanes[per-instance,gains,bf16]", "backward_lanes",
               lambda: cr.solve_lanes(lanes, it_b(sm.B_MAIN), x0, sm.SIGMA,
                                      **narrow),
               sm.K1_GAINS, sm.k1_flops(N, NX, NU, NC, sm.B_MAIN))
        record("backward_packed[bf16]", "backward_packed",
               lambda: cr.solve_packed(lanes, it_b(sm.B_MAIN), x0, sm.SIGMA,
                                       **narrow),
               ("G",), sm.k1_flops(N, NX, NU, NC, sm.B_MAIN))
    for B in batches or ():
        if B == sm.B_MAIN:
            continue
        lanes_b = sm.batched(model, B, c[:B].contiguous())
        for tag, kw in (("", {}),) + ((("bf16,", dict(
                storage_dtype=torch.bfloat16)),) if bf16 else ()):
            record(f"backward_lanes[per-instance,gains,{tag}B={B}]",
                   "backward_lanes",
                   lambda kw=kw: cr.solve_lanes(lanes_b, it_b(B), x0[:B],
                                                sm.SIGMA, **kw),
                   sm.K1_GAINS, sm.k1_flops(N, NX, NU, NC, B))
    return runs


def centroidal_sweep_runs(sm, dev):
    """K1 gains only on the tensors ``solve_lanes`` hands it at the
    centroidal model's widths (nx=24, nu=6, N=1024, B=4096: the request of
    ``chip_smoke.py``'s ``centroidal_lanes_bf16``), in float32 and on
    bfloat16 stage streams, as ``sweep_runs``."""
    import dataclasses
    import pdp_lqr_tpu_torch as plt_
    from pdp_lqr_tpu_torch.models import centroidal
    from pdp_lqr_tpu_torch.ops import cuda_riccati as cr

    f32, N, B = torch.float32, sm.N_CEN, sm.B_CEN
    model, _ = centroidal(N=N, dtype=f32, device=dev)
    rng = np.random.default_rng(sm.SEED)
    c = model.c[None] + torch.as_tensor(
        rng.normal(size=(B,) + tuple(model.c.shape)) * sm.C_SCALE_WIDE,
        dtype=f32).to(dev)
    x0 = torch.as_tensor(rng.normal(size=(B, model.nx)) * 0.1,
                         dtype=f32).to(dev)
    it = plt_.init_iterates(model, rho=sm.RHO)
    its = plt_.ADMMIterates(**{f.name: getattr(it, f.name)[None].expand(
        (B,) + getattr(it, f.name).shape) for f in dataclasses.fields(it)})
    lanes = sm.batched(model, B, c)
    flops = sm.k1_flops(N, model.nx, model.nu, model.nc, B)
    runs = {}
    for tag, kw in (("", {}), (",bf16", dict(storage_dtype=torch.bfloat16))):
        with sm.recorded_calls(cr, ["backward_lanes"]) as rec:
            cr.solve_lanes(lanes, its, x0, sm.SIGMA, **kw)
        torch.cuda.synchronize()
        runs[f"backward_lanes[per-instance,gains,centroidal{tag}]"] = (
            cr.backward_lanes, *rec["backward_lanes"], sm.K1_GAINS, flops)
    return runs


def sweep_library_of(fn, a, kw):
    """The library (dtype, nx, nu, nc, narrow) and the stages a block of
    the sweep runs for a recorded call of K1, K9 or K11."""
    if fn.__name__ == "backward_packed":
        Sd, Sc, PN, pN, nu, nc = a[:6]
        return (PN.dtype, PN.shape[0], nu, nc,
                Sd.dtype == torch.bfloat16), Sd.shape[0]
    A, Bm, PN = a[0], a[1], a[8]
    stages = A.shape[0] // kw.get("segments", 1)
    return (PN.dtype, A.shape[1], Bm.shape[2], a[5].shape[1],
            A.dtype == torch.bfloat16), stages


def latency_runs(sm, dev):
    """K1 on the shared model, and K9 in one segment on few long
    horizons, as ``sweep_runs``."""
    import dataclasses
    import pdp_lqr_tpu_torch as plt_
    from pdp_lqr_tpu_torch.models import quadrotor
    from pdp_lqr_tpu_torch.ops import cuda_riccati as cr
    from pdp_lqr_tpu_torch.parallel import make_mesh
    from pdp_lqr_tpu_torch.parallel import pdp_sharded_fused as psf

    NX, NU, NC, f32 = sm.NX, sm.NU, sm.NC, torch.float32
    model, _ = quadrotor(N=N_LAT, constrained=True, dtype=f32, device=dev)
    it = plt_.init_iterates(model, rho=sm.RHO)
    rng = np.random.default_rng(sm.SEED + 2)
    runs = {"backward_lanes[shared]": sweep_runs(sm, dev, shared_only=True)[
        "backward_lanes[shared]"]}
    for B in B_LAT:
        c = torch.as_tensor(rng.normal(size=(B, N_LAT, NX)) * 0.01).to(
            device=dev, dtype=f32)
        x0 = torch.as_tensor(rng.normal(size=(B, NX)) * 0.1).to(
            device=dev, dtype=f32)
        it_b = plt_.ADMMIterates(**{f.name: getattr(it, f.name)[None].expand(
            (B,) + getattr(it, f.name).shape) for f in dataclasses.fields(it)})
        with sm.recorded_calls(cr, ["backward_pdp_lanes"]) as rec:
            psf.solve(make_mesh(time=1, device=dev),
                      sm.batched(model, B, c), it_b, x0, sm.SIGMA)
        torch.cuda.synchronize()
        runs[f"backward_pdp_lanes[N={N_LAT},S=1,B={B}]"] = (
            cr.backward_pdp_lanes, *rec["backward_pdp_lanes"], sm.K9_OUT,
            sm.k9_flops(N_LAT, NX, NU, NC, B))
    return runs


def k2_k5_runs(sm, dev, bf16=False):
    """K2 (shared, both modes; per instance) and K5 (packed with and
    without hf-emit; the rung form; with ``bf16`` also both on the narrow
    requests' tensors) on the tensors their paths hand them, each path run
    once with the kernels' calls recorded: name -> (kernel call, plain
    call, output names, bytes read, operations, profile sections)."""
    import pdp_lqr_tpu_torch as plt_
    from pdp_lqr_tpu_torch.models import quadrotor
    from pdp_lqr_tpu_torch.ops import cuda_admm as ca, cuda_riccati as cr
    from pdp_lqr_tpu_torch.solvers import admm

    N, NX, NU, NC, f32 = sm.N_MAIN, sm.NX, sm.NU, sm.NC, torch.float32
    model, _ = quadrotor(N=N, constrained=True, dtype=f32, device=dev)
    server = plt_.ScenarioServer(model, rho=sm.RHO, sigma=sm.SIGMA, device=dev)
    rng = np.random.default_rng(sm.SEED)
    c = torch.as_tensor(rng.normal(size=(sm.B_MAIN, N, NX)) * 0.01).to(
        device=dev, dtype=f32)
    x0 = torch.as_tensor(0.03 + 0.01 * rng.normal(size=(sm.B_MAIN, NX))).to(
        device=dev, dtype=f32)
    runs = {}
    with sm.recorded_calls(cr, ["backward_vectors_lanes"]) as rec:
        server.solve(x0, c)
    a, kw = rec["backward_vectors_lanes"]
    flops = sm.k2_flops(N, NX, NU, sm.B_MAIN)
    Pc = kw["Pc"]
    runs["backward_vectors_lanes[shared,Pc]"] = (
        lambda: cr.backward_vectors_lanes(*a, shared=True, Pc=Pc),
        lambda: cr.backward_vectors_lanes_reference(*a, Pc=Pc), sm.K2_OUT,
        sm.nbytes(*a[:4], Pc, *a[5:]), flops, K2_SECTIONS["shared"])
    runs["backward_vectors_lanes[shared,P]"] = (
        lambda: cr.backward_vectors_lanes(*a, shared=True),
        lambda: cr.backward_vectors_lanes_reference(*a), sm.K2_OUT,
        sm.nbytes(*a), flops + sm.N_MAIN * sm.B_MAIN * 2 * NX * NX,
        K2_SECTIONS["shared"])
    B = sm.B_REP
    st = admm.ADMMSettings(**sm.REP_SETTINGS, cached_factors=True)
    with sm.recorded_calls(cr, ["backward_vectors_lanes"]) as rec:
        plt_.solve_fused(sm.batched(model, B, c[:B]), x0[:B], (), st,
                         single_kernel=False)
    r2, _ = rec["backward_vectors_lanes"]
    runs["backward_vectors_lanes[per-instance]"] = (
        lambda: cr.backward_vectors_lanes(*r2),
        lambda: cr.backward_vectors_lanes_reference(*r2), sm.K2_OUT,
        sm.nbytes(*r2), sm.k2_flops(N, NX, NU, B) + N * B * 2 * NX * NX,
        K2_SECTIONS["per-instance"])
    with sm.recorded_calls(ca, ["admm_fwd_update_lanes"]) as rec:
        server.solve_admm(x0, (), admm.ADMMSettings(**sm.ADMM_SETTINGS), c=c)
    a5, kw5 = rec["admm_fwd_update_lanes"]
    k5_in = (a5[0], a5[1], a5[2], a5[4], a5[5], a5[6], a5[10], a5[11],
             kw5["h"])
    for tag, inp in (("[packed]", k5_in), ("[packed,no hf]", k5_in[:8] + (None,))):
        runs["admm_fwd_update_lanes" + tag] = (
            lambda inp=inp: sm.k5_call(ca, inp, ()),
            lambda inp=inp: sm.k5_plain(ca, inp, ()),
            sm.K5_OUT if inp[8] is not None else sm.K5_RUNG_OUT,
            sm.nbytes(*(x for x in inp if x is not None)),
            sm.k5_flops(N, NX, NU, NC, sm.B_MAIN, True,
                        emit_hf=inp[8] is not None), K5_SECTIONS)
    rung0 = torch.tensor([sm.LADDER[b % len(sm.LADDER)]
                          for b in range(sm.B_MAIN)], dtype=torch.float64)
    state = sm.zero_state(sm.B_MAIN, N, NC, f32, dev, rung0)
    with sm.recorded_calls(ca, ["admm_fwd_update_lanes"]) as rec:
        server.solve_admm(x0, (), admm.ADMMSettings(**sm.LADDER_SETTINGS),
                          state=state, c=c)
    l5, lkw = rec["admm_fwd_update_lanes"]
    k5r = (l5[0], l5[1], l5[2], l5[4], l5[5], l5[6], l5[10], l5[11], None)
    K5r, rung = l5[3], lkw["rung"]
    runs["admm_fwd_update_lanes[rung,R=4]"] = (
        lambda: sm.k5_call(ca, k5r, (), K=K5r, rung=rung),
        lambda: sm.k5_plain(ca, k5r, (), K=K5r, rung=rung), sm.K5_RUNG_OUT,
        sm.nbytes(*k5r[:8], K5r, rung),
        sm.k5_flops(N, NX, NU, NC, sm.B_MAIN, True, emit_hf=False),
        K5_SECTIONS)
    if bf16:
        # The same two requests with storage_dtype=bfloat16.
        for tag, st, state_ in (
                ("[packed,bf16]", sm.ADMM_SETTINGS, None),
                ("[rung,R=4,bf16]", sm.LADDER_SETTINGS, state)):
            with sm.recorded_calls(ca, ["admm_fwd_update_lanes"]) as rec:
                narrow_request(sm, model, c, x0, st, state_)
            a, kw = rec["admm_fwd_update_lanes"]
            inp = (a[0], a[1], a[2], a[4], a[5], a[6], a[10], a[11],
                   kw.get("h"))
            Kn, rn = a[3], kw.get("rung")
            runs["admm_fwd_update_lanes" + tag] = (
                lambda inp=inp, Kn=Kn, rn=rn: sm.k5_call(ca, inp, (), K=Kn,
                                                         rung=rn),
                lambda inp=inp, Kn=Kn, rn=rn: sm.k5_plain(ca, inp, (), K=Kn,
                                                          rung=rn),
                sm.K5_OUT if inp[8] is not None else sm.K5_RUNG_OUT,
                sm.nbytes(*(x for x in inp + (Kn, rn) if x is not None)),
                sm.k5_flops(N, NX, NU, NC, sm.B_MAIN, True,
                            emit_hf=inp[8] is not None), K5_SECTIONS)
    torch.cuda.synchronize()
    return runs


def k5_wide_runs(sm, dev):
    """K5 packed with hf-emit, full width and narrow, at ``kernels_wide``'s
    shapes (the mass-spring chain's rows and the centroidal model's two
    cones, a diagonal cost, N=64, B=256, float32 and float64; the same
    random inputs as that phase): name -> (kernel call, plain call, output
    names, bytes read, operations, the library's (dtype, nx, nu, nc,
    cones))."""
    from pdp_lqr_tpu_torch.ops import cuda_admm as ca, cuda_riccati as cr

    N, Bt = sm.N_SMALL, sm.B_SMALL
    runs = {}
    for (width, (nx, nu, nc, cones, nca)), dt in (
            (w, dt) for w in sm.WIDE.items()
            for dt in (torch.float32, torch.float64)):
        rng = np.random.default_rng(sm.SEED)
        one = sm.random_stage_data(rng, N, nx, nu, nc, 1, dt, dev)
        K, _, M, _, _, L = cr.backward_lanes_reference(*one,
                                                       export_factors=True)
        _, k5 = sm.random_admm_inputs(rng, one[0], one[1], K, M, L, nca, Bt,
                                      cones, True, False)
        f64 = ",f64" if dt == torch.float64 else ""
        for tag, inp in (("", k5), (",bf16", sm.narrow_args(k5, sm.K5_NARROW))):
            runs[f"admm_fwd_update_lanes[{width},N={N},B={Bt}{f64}{tag}]"] = (
                lambda inp=inp, cones=cones, nu=nu: sm.k5_call(ca, inp, cones,
                                                               nu=nu),
                lambda inp=inp, cones=cones, nu=nu: sm.k5_plain(ca, inp, cones,
                                                                nu=nu),
                sm.K5_OUT, sm.nbytes(*inp),
                sm.k5_flops(N, nx, nu, nca, Bt, True), (dt, nx, nu, nca, cones))
    torch.cuda.synchronize()
    return runs


def narrow_request(sm, model, c, x0, settings, state):
    """The split (``state`` None) or ladder request of ``solve_admm`` on
    the quadrotor with ``storage_dtype=torch.bfloat16``."""
    import dataclasses

    import pdp_lqr_tpu_torch as plt_
    from pdp_lqr_tpu_torch.solvers import admm
    return plt_.solve_fused(dataclasses.replace(model, c=c), x0, (),
                            admm.ADMMSettings(**settings), state=state,
                            single_kernel=False, storage_dtype=torch.bfloat16)


def k4_k6_runs(sm, dev, bf16=False):
    """K4 and K6 (R=4) on the tensors of the last iteration of
    ``solve_admm``'s and the ladder's 20-iteration requests (B=4096; with
    ``bf16`` also their narrow forms on the same requests' with
    ``storage_dtype=torch.bfloat16``): name -> (kernel call, plain call,
    output names, bytes read, operations, the library's (dtype, nx, nu, nc,
    modes))."""
    import pdp_lqr_tpu_torch as plt_
    from pdp_lqr_tpu_torch.models import quadrotor
    from pdp_lqr_tpu_torch.ops import cuda_admm as ca
    from pdp_lqr_tpu_torch.solvers import admm

    N, NX, NU, NC, f32 = sm.N_MAIN, sm.NX, sm.NU, sm.NC, torch.float32
    model, _ = quadrotor(N=N, constrained=True, dtype=f32, device=dev)
    server = plt_.ScenarioServer(model, rho=sm.RHO, sigma=sm.SIGMA, device=dev)
    rng = np.random.default_rng(sm.SEED)
    c = torch.as_tensor(rng.normal(size=(sm.B_MAIN, N, NX)) * 0.01).to(
        device=dev, dtype=f32)
    x0 = torch.as_tensor(0.03 + 0.01 * rng.normal(size=(sm.B_MAIN, NX))).to(
        device=dev, dtype=f32)
    K4, K6 = "admm_bwd_vec_prefold_lanes", "admm_bwd_vec_lanes"
    with sm.recorded_calls(ca, [K4]) as rec:
        server.solve_admm(x0, (), admm.ADMMSettings(**sm.ADMM_SETTINGS), c=c)
    a4, kw4 = rec[K4]
    rung0 = torch.tensor([sm.LADDER[b % len(sm.LADDER)]
                          for b in range(sm.B_MAIN)], dtype=torch.float64)
    state = sm.zero_state(sm.B_MAIN, N, NC, f32, dev, rung0)
    with sm.recorded_calls(ca, [K6]) as rec:
        server.solve_admm(x0, (), admm.ADMMSettings(**sm.LADDER_SETTINGS),
                          state=state, c=c)
    a6, kw6 = rec[K6]
    recs = {"": ((a4, kw4), (a6, kw6))}
    if bf16:
        with sm.recorded_calls(ca, [K4]) as r4:
            narrow_request(sm, model, c, x0, sm.ADMM_SETTINGS, None)
        with sm.recorded_calls(ca, [K6]) as r6:
            narrow_request(sm, model, c, x0, sm.LADDER_SETTINGS, state)
        recs[",bf16"] = (r4[K4], r6[K6])
    torch.cuda.synchronize()
    runs = {}
    for tag, ((a4, kw4), (a6, kw6)) in recs.items():
        narrow = {"narrow": True} if tag else {}
        runs[K4 + (f"[{tag[1:]}]" if tag else "")] = (
            lambda a4=a4, kw4=kw4: [ca.admm_bwd_vec_prefold_lanes(*a4, **kw4)],
            lambda a4=a4, kw4=kw4: [ca.admm_bwd_vec_prefold_lanes_reference(
                *a4, **kw4)],
            sm.K4_OUT, sm.nbytes(*a4), sm.k2_flops(N, NX, NU, sm.B_MAIN),
            (f32, NX, NU, None, narrow))
        runs[K6 + f"[R=4{tag}]"] = (
            lambda a6=a6, kw6=kw6: [ca.admm_bwd_vec_lanes(*a6, **kw6)],
            lambda a6=a6, kw6=kw6: [ca.admm_bwd_vec_lanes_reference(
                *a6, **kw6)],
            sm.K6_OUT, sm.nbytes(*a6, kw6.get("rung")),
            sm.k6_flops(N, NX, NU, NC, sm.B_MAIN),
            (f32, NX, NU, NC, {"fold": True, "rungs": 4, **narrow}))
    return runs


def k7_runs(sm, dev, bf16=False, batches=None):
    """K7 and K12 on the tensors ``solve_lanes`` and ``solve_packed`` hand
    them (quadrotor, N=512, B=4096 or each of ``batches``, float32;
    ``bf16``: also on bfloat16 stage streams), each path run once with the
    kernels' calls recorded: name -> (kernel call, plain call, output
    names, bytes read, operations)."""
    import dataclasses
    import pdp_lqr_tpu_torch as plt_
    from pdp_lqr_tpu_torch.models import quadrotor
    from pdp_lqr_tpu_torch.ops import cuda_riccati as cr

    N, NX, NU, f32 = sm.N_MAIN, sm.NX, sm.NU, torch.float32
    batches = batches or [sm.B_MAIN]
    model, _ = quadrotor(N=N, constrained=True, dtype=f32, device=dev)
    it = plt_.init_iterates(model, rho=sm.RHO)
    rng = np.random.default_rng(sm.SEED)
    Bmax = max(batches)
    c = torch.as_tensor(rng.normal(size=(Bmax, N, NX)) * 0.01).to(
        device=dev, dtype=f32)
    x0 = torch.as_tensor(0.03 + 0.01 * rng.normal(size=(Bmax, NX))).to(
        device=dev, dtype=f32)
    K7, K12 = "forward_rollout_lanes", "forward_packed"
    runs = {}
    for B in batches:
        it_b = plt_.ADMMIterates(**{f.name: getattr(it, f.name)[None].expand(
            (B,) + getattr(it, f.name).shape) for f in dataclasses.fields(it)})
        lanes = sm.batched(model, B, c[:B].contiguous())
        xb = x0[:B].contiguous()
        flops = sm.k7_flops(N, NX, NU, B)
        at = "" if B == sm.B_MAIN else f"[B={B}]"
        for tag, kw in (("", {}),) + ((("[bf16]", dict(
                storage_dtype=torch.bfloat16)),) if bf16 else ()):
            with sm.recorded_calls(cr, [K7, K12]) as rec:
                cr.solve_lanes(lanes, it_b, xb, sm.SIGMA, **kw)
                cr.solve_packed(lanes, it_b, xb, sm.SIGMA, **kw)
            torch.cuda.synchronize()
            a7, a12 = rec[K7][0], rec[K12][0]
            runs[K7 + tag + at] = (
                lambda a7=a7: cr.forward_rollout_lanes(*a7),
                lambda a7=a7: cr.forward_rollout_lanes_reference(*a7),
                sm.K3_OUT, sm.nbytes(*a7), flops)
            runs[K12 + tag + at] = (
                lambda a12=a12: cr.forward_packed(*a12),
                lambda a12=a12: cr.forward_packed_reference(*a12),
                sm.K3_OUT, sm.nbytes(*a12[:3]), flops)
    return runs


def k10_runs(sm, dev):
    """K10 on the tensors the cached PDP ADMM loop hands it and at
    ``kernels_wide``'s shapes (see the module's note): name -> (kernel
    call, plain call, output names, bytes read, operations, the library's
    (dtype, nx, nu), stages a segment)."""
    import dataclasses
    from pdp_lqr_tpu_torch.models import quadrotor
    from pdp_lqr_tpu_torch.ops import cuda_riccati as cr
    from pdp_lqr_tpu_torch.parallel import admm_sharded, make_mesh
    from pdp_lqr_tpu_torch.solvers import admm

    N, NX, NU, f32 = sm.N_MAIN, sm.NX, sm.NU, torch.float32
    K10 = "backward_pdp_vectors_lanes"
    cone, cones = quadrotor(N=N, constrained=True, thrust_cone=True,
                            dtype=f32, device=dev)
    rng = np.random.default_rng(sm.SEED + 3)
    B = sm.B_PDP
    c = torch.as_tensor(rng.normal(size=(B, N, NX)) * 0.01).to(
        device=dev, dtype=f32)
    x0 = torch.as_tensor(rng.normal(size=(B, NX)) * 0.05).to(
        device=dev, dtype=f32)
    shift = np.zeros((N + 1, sm.NC_CONE), np.float32)
    shift[:, sm.NC] = sm.THRUST_SHIFT
    st = admm.ADMMSettings(**{**sm.REP_SETTINGS, "max_iter": 1},
                           cached_factors=True)
    with sm.recorded_calls(cr, [K10]) as rec:
        admm_sharded.solve(make_mesh(time=sm.S_PDP, device=dev),
                           sm.batched(cone, B, c), x0, cones, st,
                           soc_shift=shift)
    torch.cuda.synchronize()
    a, kw = rec[K10]
    S = kw["segments"]
    runs = {}

    def add(name, args, lib):
        Bt, nx, nu = args[2].shape[-1], args[0].shape[1], args[1].shape[2]
        n, seg = args[0].shape[0], args[-1].shape[0]
        runs[name] = (
            lambda: cr.backward_pdp_vectors_lanes(*args, segments=seg),
            lambda: cr.backward_pdp_vectors_lanes_reference(*args,
                                                            segments=seg),
            sm.K10_OUT, sm.nbytes(*args), sm.k10_flops(n, nx, nu, Bt), lib,
            n // seg)

    add(f"{K10}[pdp_admm,S={S},B={B}]", a, (f32, NX, NU))
    add(f"{K10}[pdp_admm,S={S},B={B},f64]",
        tuple(x.double().contiguous() for x in a),
        (torch.float64, NX, NU))
    for Bp in (B - 1, B - 2, B - 3):
        add(f"{K10}[pdp_admm,S={S},B={Bp}]",
            tuple(x[..., :Bp].contiguous() for x in a), (f32, NX, NU))
    add(f"{K10}[pdp_admm,S={S},B={B - 1},f64]",
        tuple(x[..., :B - 1].double().contiguous() for x in a),
        (torch.float64, NX, NU))
    del a
    S = sm.S_SMALL
    for width, (nx, nu, nc, _, _) in sm.WIDE.items():
        for dt in (f32, torch.float64):
            rng = np.random.default_rng(sm.SEED)
            T = sm._normal(rng, dt, dev)
            Nw, Bt = sm.N_SMALL, sm.B_SMALL
            data = sm.random_stage_data(rng, Nw, nx, nu, nc, Bt, dt, dev)
            k9 = data[:8] + sm.random_carries(rng, S, nx, Bt, dt, dev)
            K9f, _, _, _, _, P9, L9, F9 = cr.backward_pdp_lanes_reference(
                *k9, export_factors=True, segments=S)[:8]
            args = (data[0], data[1], data[2], T(Nw, nx + nu, Bt), P9, K9f,
                    L9, F9, T(S, nx, Bt))
            add(f"{K10}[{width},N={Nw},S={S},B={Bt}"
                + (",f64]" if dt == torch.float64 else "]"), args,
                (dt, nx, nu))
            del data, k9
    torch.cuda.synchronize()
    return runs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None,
                    help="import pdp_lqr_tpu_torch from this checkout")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--kernels", nargs="*",
                    choices=("sweep", "latency", "k8", "k3", "k2", "k5",
                             "k4", "k6", "k7", "k10", "wide"),
                    default=["sweep", "k8", "k3"])
    ap.add_argument("--profile", action="store_true",
                    help="K8's, K2's, K5's, K4's, K6's, K7's, K12's and "
                         "K10's diagnostic builds: cycles a stage by section")
    ap.add_argument("--bf16", action="store_true",
                    help="sweep, k7, k4, k5, k6: also the forms on "
                         "bfloat16 streams")
    ap.add_argument("--batches", type=int, nargs="*", default=None,
                    help="k7: the batches to run (default 4096); sweep: "
                         "solve_lanes' K1 also at these (at most 4096); "
                         "a batch no multiple of 8 takes the word copies")
    ap.add_argument("--define", nargs="*", default=[], metavar="NAME=VALUE",
                    help="more preprocessor defines for every library "
                         "built (a design's compile-time switch)")
    ap.add_argument("--match", nargs="*", default=None,
                    help="sweep: only the forms whose names hold one of "
                         "these strings")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_bench: needs a CUDA device", file=sys.stderr)
        return 1
    root = Path(args.root).resolve() if args.root else ROOT
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("smoke", ROOT / "chip_smoke.py")
    sm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sm)
    from pdp_lqr_tpu_torch.ops import _build, cuda_admm as ca, cuda_riccati as cr
    more = dict(d.split("=", 1) for d in args.define)

    def profiled(source, defines):
        extra = dict(more)
        if not args.profile:
            pass
        elif source == ca.SOURCE:
            extra["ADMM_PROFILE"] = 1            # K8, K5, K4, K6
        elif source == cr.SOURCE and ("NC" not in defines
                                      or "sweep" in args.kernels):
            extra["RICCATI_PROFILE"] = 1         # K2, K7, K12 (K3, K10);
                                                 # the sweep (K1, K9, K11)
        return {**defines, **extra}
    if args.profile or more:
        load = _build.load
        _build.load = lambda source, defines: load(source,
                                                   profiled(source, defines))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    f32 = torch.float32
    NX, NU, NC = sm.NX, sm.NU, sm.NC
    print(json.dumps({"card": card, "root": str(root),
                      "package": str(Path(cr.__file__).parents[1])}), flush=True)

    # Every library, built at once.
    jobs = [(cr.SOURCE, cr.kernel_defines(f32, NX, NU))]
    if "sweep" in args.kernels:
        jobs += [(cr.SOURCE, cr.kernel_defines(f32, NX, NU, nc))
                 for nc in (NC, sm.NC_CONE)]
    elif "latency" in args.kernels:
        jobs.append((cr.SOURCE, cr.kernel_defines(f32, NX, NU, NC)))
    for nx, nu, nc, cones, shift in ((NX, NU, NC, (), False),
                                     (NX, NU, NC + 3, THRUST, True),
                                     ROCKET + (False,)) * ("k8" in args.kernels):
        jobs.append((ca.SOURCE, ca.kernel_defines(
            f32, nx, nu, nc, cones=cones, has_shift=shift, single=True)))
    if {"k5", "k4", "k6"} & set(args.kernels):
        jobs += [(ca.SOURCE, ca.kernel_defines(f32, NX, NU, NC, diag_cost=True,
                                               rungs=R)) for R in (1, 4)]
        jobs.append((ca.SOURCE, ca.kernel_defines(f32, NX, NU)))     # K4
        jobs += [(ca.SOURCE, ca.kernel_defines(f32, NX, NU, NC, fold=True,
                                               rungs=4))]            # K6
    if {"k2", "k5", "k4", "k6", "k7"} & set(args.kernels):
        jobs.append((cr.SOURCE, cr.kernel_defines(f32, NX, NU, NC)))   # K1
    if "k10" in args.kernels:
        jobs += [(cr.SOURCE, cr.kernel_defines(torch.float64, NX, NU)),
                 (cr.SOURCE, cr.kernel_defines(f32, NX, NU, sm.NC_CONE))]
        jobs += [(cr.SOURCE, cr.kernel_defines(dt, nx, nu))
                 for nx, nu, *_ in sm.WIDE.values()
                 for dt in (f32, torch.float64)]
    if "wide" in args.kernels:
        jobs += sm.wide_build_jobs(ca, cr, dtypes=(f32,))
    if args.bf16 and "sweep" in args.kernels:
        jobs.append((cr.SOURCE, cr.kernel_defines(f32, NX, NU, NC,
                                                  narrow=True)))
        jobs += [(cr.SOURCE, cr.kernel_defines(f32, *sm.WIDE["centroidal"][:3],
                                               narrow=n)) for n in (False, True)]
    if args.bf16 and "k7" in args.kernels:
        jobs.append((cr.SOURCE, cr.kernel_defines(f32, NX, NU, narrow=True)))
    if args.bf16 and "k5" in args.kernels:      # K5 at the wide widths
        jobs += [(ca.SOURCE, ca.kernel_defines(dt, nx, nu, nca, cones=cones,
                                               diag_cost=True, narrow=n))
                 for nx, nu, _, cones, nca in sm.WIDE.values()
                 for n in (False, True) for dt in (f32, torch.float64)]
    if args.bf16 and {"k5", "k4", "k6"} & set(args.kernels):
        jobs += [(ca.SOURCE, ca.kernel_defines(f32, NX, NU, NC, diag_cost=True,
                                               rungs=R, narrow=True))
                 for R in (1, 4)]
        jobs += [(ca.SOURCE, ca.kernel_defines(f32, NX, NU, narrow=True)),
                 (ca.SOURCE, ca.kernel_defines(f32, NX, NU, NC, fold=True,
                                               rungs=4, narrow=True))]
    jobs = [(src, profiled(src, d)) for src, d in jobs]
    paths = _build.build_many(jobs)
    regs = {}
    for job, p in zip(jobs, paths):
        regs.update(sm.registers_by_kernel(
            [(job[1], _build.build_logs.get(p, ""))]))
    regs = {k: v for k, v in regs.items()
            if k.startswith(("iter_kernel", "forward_kernel", "backward_kernel",
                             "backward_vectors", "backward_pdp_vectors",
                             "fwd_update_kernel", "bwd_vec",
                             "forward_rollout"))}
    print(json.dumps({"ptxas": regs}), flush=True)

    def report(name, call, plain, names, moved, flops, extra=lambda: {},
               tol=sm.TOL[f32]):
        out = call()
        ref = plain()
        _, rel = sm.rel_err(names, out, ref)
        if "N=1024" in name:             # F0 against its carry's scale, 1
            i = names.index("F0")
            rel["F0"] = float((out[i] - ref[i]).abs().max()) / max(
                1.0, float(ref[i].abs().max()))
        ms = sm.cuda_ms(call, args.reps)
        bound_ms, by = sm.bound(moved + sm.nbytes(*out), flops)
        print(json.dumps({"kernel": name, "ms": ms, "bound_ms": bound_ms,
                          "bound_by": by, "max_rel_err": max(rel.values()),
                          **extra()}), flush=True)
        sm.require(max(rel.values()) <= tol, name, rel)

    plain_of = {cr.backward_lanes: cr.backward_lanes_reference,
                cr.backward_pdp_lanes: cr.backward_pdp_lanes_reference,
                cr.backward_packed: cr.backward_packed_reference}

    def sweep_sections(fn, a, kw):
        (dt, nx, nu, nc, narrow), stages = sweep_library_of(fn, a, kw)
        lib = cr._library(dt, nx, nu, nc, narrow)
        out = (ctypes.c_longlong * 16)()     # an older tree's copies 8
        lib.riccati_read_prof.argtypes = [ctypes.c_void_p]
        sm.require(lib.riccati_read_prof(out) == 0, "riccati_read_prof")
        return {"cycles_per_stage": {k: v / stages for k, v in
                                     zip(SWEEP_SECTIONS, out) if v}}

    sweeps = [("sweep", lambda: sweep_runs(sm, dev, bf16=args.bf16,
                                           batches=args.batches)),
              ("latency", lambda: latency_runs(sm, dev))]
    if args.bf16:            # the narrow and full forms at nz=30
        sweeps.insert(1, ("sweep", lambda: centroidal_sweep_runs(sm, dev)))
    for mode, make in sweeps:
        if mode not in args.kernels:
            continue
        runs = make()
        for name, (fn, a, kw, names, flops) in runs.items():
            if args.match and not any(m in name for m in args.match):
                continue
            packed = name.startswith("backward_packed")
            listed = (lambda r: [r]) if packed else tuple
            extra = ((lambda fn=fn, a=a, kw=kw: sweep_sections(fn, a, kw))
                     if args.profile else (lambda: {}))
            # (nz=30 in float32: the wide widths' tolerance, as the
            # requests that run there are held to.)
            report(name, lambda: listed(fn(*a, **kw)),
                   lambda: listed(plain_of[fn](*a, **kw)), names,
                   sm.nbytes(*(a[:4] if packed else a)), flops, extra,
                   tol=(sm.WIDE_KERNEL_RTOL if "centroidal" in name
                        else sm.TOL[f32]))
        del runs

    rng = np.random.default_rng(sm.SEED)
    forms = [
        ("[shared]", 64, B_SHARED, True, False, False, (NX, NU, NC, (), False)),
        ("[shared,cached]", 512, B_SHARED, True, True, False,
         (NX, NU, NC, (), False)),
        ("[shared,cached,bf16]", 512, B_SHARED, True, True, True,
         (NX, NU, NC, (), False)),
        ("[batched]", 64, B_BATCHED, False, False, False, (NX, NU, NC, (), False)),
        ("[batched,cached]", 64, B_BATCHED, False, True, False,
         (NX, NU, NC, (), False)),
        ("[batched,cached,bf16]", 64, B_BATCHED, False, True, True,
         (NX, NU, NC, (), False)),
        ("[batched,cone+shift,N=512]", 512, B_BATCHED, False, False, False,
         (NX, NU, NC + 3, THRUST, True)),
        ("[rocket]", 48, B_ROCKET, False, False, False, ROCKET + (False,)),
    ]

    def sections(N, nx, nu, nc, cones, shift):
        lib = ca._library(f32, nx, nu, nc, cones=cones, has_shift=shift,
                          single=True)
        out = (ctypes.c_longlong * len(SECTIONS))()
        lib.admm_read_prof.argtypes = [ctypes.c_void_p]
        sm.require(lib.admm_read_prof(out) == 0, "admm_read_prof")
        return {"cycles_per_stage": {k: v / N for k, v in zip(SECTIONS, out)}}

    for tag, N, Bt, shared, cached, narrow, (nx, nu, nc, cones, shift) in (
            forms if "k8" in args.kernels else ()):
        a = sm.random_iter_inputs(rng, N, nx, nu, nc, Bt, cones, shared, shift,
                                  f32, dev)
        factors = sm.iter_factors(a, shared) if cached else None
        if narrow:
            a = sm.narrow_storage(a)
        kw = dict(nu=nu, cones=cones, alpha=sm.ALPHA, sigma=sm.SIGMA,
                  factors=factors)
        moved = sm.nbytes(*(x for i, x in enumerate(a)
                            if not (cached and i == 14)), *(factors or ()))
        report("admm_iter_lanes" + tag,
               lambda: ca.admm_iter_lanes(*a, shared=shared, **kw),
               lambda: ca.admm_iter_lanes_reference(*a, **kw), sm.K8_OUT,
               moved, sm.k8_flops(N, nx, nu, nc, Bt, cached),
               (lambda: sections(N, nx, nu, nc, cones, shift)) if args.profile
               else (lambda: {}))
        del a, factors

    def read_sections(lib, entry, names, N):
        out = (ctypes.c_longlong * 16)()     # K6 narrow's ten; others eight
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p]
        sm.require(fn(out) == 0, entry)
        return {"cycles_per_stage": {k: v / N for k, v in zip(names, out)
                                     if v}}

    if "k2" in args.kernels or "k5" in args.kernels:
        runs = k2_k5_runs(sm, dev, bf16=args.bf16)
        for name, (call, plain, names, moved, flops, sec) in runs.items():
            k5 = name.startswith("admm_fwd_update_lanes")
            if ("k5" if k5 else "k2") not in args.kernels:
                continue
            if args.profile:
                call()
                torch.cuda.synchronize()
                lib = ca._library(f32, NX, NU, NC, diag_cost=True,
                                  rungs=4 if "rung" in name else 1,
                                  narrow="bf16" in name) if k5 \
                    else cr._library(f32, NX, NU)
                entry = "admm_read_prof" if k5 else "riccati_read_prof"
                if k5 and "bf16" in name:
                    sec = sec + K5_WIDEN_SECTIONS
                extra = (lambda lib=lib, entry=entry, sec=sec:
                         read_sections(lib, entry, sec, sm.N_MAIN))
            else:
                extra = lambda: {}
            report(name, lambda call=call: tuple(call()),
                   lambda plain=plain: tuple(plain()), names, moved, flops, extra)
        del runs

    if "k5" in args.kernels and args.bf16:
        runs = k5_wide_runs(sm, dev)
        for name, (call, plain, names, moved, flops, (dt, nx, nu, nc,
                                                      cones)) in runs.items():
            extra = lambda: {}
            if args.profile:
                call()
                torch.cuda.synchronize()
                narrow = "bf16" in name
                lib = ca._library(dt, nx, nu, nc, cones=cones,
                                  diag_cost=True, narrow=narrow)
                sec = K5_SECTIONS + (K5_WIDEN_SECTIONS if narrow else [])
                extra = (lambda lib=lib, sec=sec: read_sections(
                    lib, "admm_read_prof", sec, sm.N_SMALL))
            report(name, lambda call=call: tuple(call()),
                   lambda plain=plain: tuple(plain()), names, moved, flops,
                   extra, tol=sm.WIDE_KERNEL_RTOL)
        del runs

    if {"k4", "k6"} & set(args.kernels):
        runs = k4_k6_runs(sm, dev, bf16=args.bf16)
        for name, (call, plain, names, moved, flops, lib_of) in runs.items():
            if ("k6" if "[R=4" in name else "k4") not in args.kernels:
                continue
            extra = lambda: {}
            if args.profile:
                call()
                torch.cuda.synchronize()
                dt, nx, nu, nc, modes = lib_of
                lib = ca._library(dt, nx, nu, nc, **modes)
                if hasattr(lib, "admm_read_prof"):
                    extra = (lambda lib=lib: read_sections(
                        lib, "admm_read_prof", KA_SECTIONS, sm.N_MAIN))
            report(name, lambda call=call: tuple(call()),
                   lambda plain=plain: tuple(plain()), names, moved, flops, extra)
        del runs

    if "k7" in args.kernels:
        runs = k7_runs(sm, dev, bf16=args.bf16, batches=args.batches)
        lib = cr._library(f32, NX, NU)

        def rollout_sections():
            # An older tree's K7 and K12 mark no sections: all zeros.
            got = read_sections(lib, "riccati_read_prof", K7_SECTIONS,
                                sm.N_MAIN)
            return got if any(got["cycles_per_stage"].values()) else {}

        for name, (call, plain, names, moved, flops) in runs.items():
            # (A narrow form's sections are in its own library's: none.)
            report(name, lambda call=call: tuple(call()),
                   lambda plain=plain: tuple(plain()), names, moved, flops,
                   rollout_sections if args.profile and "bf16" not in name
                   else (lambda: {}))
        del runs

    if "k10" in args.kernels:
        runs = k10_runs(sm, dev)
        for name, (call, plain, names, moved, flops, lib_of,
                   stages) in runs.items():
            extra = lambda: {}
            if args.profile:
                call()
                torch.cuda.synchronize()
                lib = cr._library(*lib_of)

                def extra(lib=lib, stages=stages):
                    # An older tree's K10 marks no sections: all zeros.
                    got = read_sections(lib, "riccati_read_prof",
                                        K10_SECTIONS, stages)
                    return got if any(got["cycles_per_stage"].values()) else {}
            report(name, lambda call=call: tuple(call()),
                   lambda plain=plain: tuple(plain()), names, moved, flops,
                   extra, tol=sm.TOL[lib_of[0]])
        del runs

    if "wide" in args.kernels:
        import pdp_lqr_tpu_torch as plt_
        from pdp_lqr_tpu_torch.solvers import admm, sequential
        requests = sm.wide_requests(plt_, admm, sequential, ca, cr, dev, card,
                                    check=False)
        for name, (_, phase, call, plain, names, flops, inputs,
                   _) in sm.wide_kernel_specs(ca, cr, requests).items():
            report(name, lambda call=call: tuple(call()),
                   lambda plain=plain: tuple(plain()), names,
                   sm.nbytes(*(x for x in inputs
                               if isinstance(x, torch.Tensor))), flops,
                   lambda phase=phase: {"path": phase},
                   tol=sm.WIDE_KERNEL_RTOL)
        del requests

    if "k3" not in args.kernels:
        return 0
    N, Bt = 512, B_BATCHED
    T = lambda *s, scale: torch.as_tensor(rng.normal(size=s) * scale).to(
        device=dev, dtype=f32).contiguous()
    M, K = T(N, NX, NX, Bt, scale=0.1), T(N, NU, NX, Bt, scale=0.3)
    v, d = T(N, NX, Bt, scale=0.3), T(N, NU, Bt, scale=0.3)
    for S in (1, 8):
        x0 = T(S, NX, Bt, scale=0.3) if S > 1 else T(NX, Bt, scale=0.3)
        seg = S if S > 1 else None
        report(f"forward_lanes[per-instance,S={S}]",
               lambda: cr.forward_lanes(M, v, K, d, x0, segments=seg),
               lambda: cr.forward_lanes_reference(M, v, K, d, x0, segments=seg),
               sm.K3_OUT, sm.nbytes(M, v, K, d, x0),
               sm.k3_flops(N, NX, NU, Bt))
    return 0


if __name__ == "__main__":
    sys.exit(main())
