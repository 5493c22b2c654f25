#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``pdp_lqr_tpu_torch/ops/csrc`` with
``nvcc`` (into ``build/``), holds each kernel against its plain PyTorch
version on the card, then drives the port's paths through their public
entry points on the quadrotor (N=512, float32): ``ScenarioServer.solve``
for B=4096 scenarios (the inner LQ solve, checked against the port's own
sequential Riccati solver in float64); ``ScenarioServer.solve_admm`` in
split mode (a 20-iteration request checked against the port's plain path
in float64, a small adapting run whose rho changes force
refactorizations, a cold solve followed by a warm receding-horizon tick);
the same with a four-rung rho ladder (per-scenario rho: a 20-iteration
request and a 60-iteration adapting run), checked at N=64 in float64
against the replicated loop; ``solve_fused`` on a batched problem of
B=1024 (the replicated per-instance loop, with and without cached
factors); ``suggest_rho_ladder``; and ``solve_lanes`` (the per-instance
inner solve); the single-kernel iteration (K8): ``solve_admm``'s default
path at N=64 (per-scenario rho), cached factors at N=512 (float32 and
bfloat16 stage data) checked at N=64 in float64 against the split pair, a
batched problem of B=1024 at N=64 (uncached, cached, cached with bfloat16)
checked against the replicated loop, and the rocket soft-landing
dispersion (B=512, N=48, two cones, ``single_kernel="auto"``); the split
and ladder requests with bfloat16 stage and factor streams (phases
``admm_split_bf16`` and ``admm_ladder_bf16``: the narrow forms of K4, K5
and K6, checked in float64 against the plain versions, beside the float32
requests' answers, times and peak memory, and beside K8's cached bfloat16
request); bfloat16 stage streams on the per-scenario inner solve (``solve_lanes`` and
``solve_packed`` with ``storage_dtype``: phases ``lanes_bf16`` and
``packed_bf16`` at B=4096, N=512, and ``centroidal_lanes_bf16`` at N=1024,
B=4096, each beside its float32 request's answer, time and peak memory);
the
segment-parallel PDP solve (``parallel.pdp_sharded_fused.solve``, K9 + K3
in S segments, B=1024, S=8 and a sweep of S, checked against
``solve_lanes`` and the f64 sequential solver), the paper's long-horizon
case (N=1024, B=128, S=1 and 32), the conic ADMM loop on it
(``parallel.admm_sharded.solve``, uncached and cached, thrust cone with a
shift, checked at N=64 in float64 against the replicated loop) and
``solve_packed`` (K11 + K12, against ``solve_lanes``); every kernel at the
mass-spring and centroidal widths and those models' requests; the
reference-shaped solvers on torch ops; the realtime operators (the
quadrotor's dense map at N=64: a cold replan and warm ticks of a closed
loop against the 1 ms budget, eager and as a CUDA graph an iteration,
checked against float64, ``admm.solve`` and the condensed map; the
centroidal model's condensed map at N=1024 in float32 and bfloat16 and a
four-rung ladder; ``solve_batch`` on a scenario batch of B=4096, checked
against ``solve_fused``), the MPC loops (``simulate_realtime`` over 200
ticks, against ``simulate``), ``solve_with_recovery`` over ``solve_lanes``
with indefinite instances, and ``solve_equilibrated`` on rows scaled
across 1e6; the segment-parallel solve in torch ops
(``parallel.pdp_sharded``, both condensed variants, against float64), the
g++ witness (``utils.native``, against ``solve_lanes`` in float64), the
mesh over ranks (phase ``multirank``: two ranks sharing the card over
gloo run ``fused_dp``, ``solve_fused_dp``, ``pdp_sharded_fused`` and
``admm_sharded``, each against the same call in one process, their
kernels counted on every rank; then a world of one rank on NCCL), and the
six examples (``examples/torch_*.py``) at their card defaults (five run
beside the ``kernels`` phase, which times nothing, and are finished
before anything is timed; the roofline report then runs alone).  It
times the paths and their kernels with CUDA events.
Each phase prints one JSON line; any failed check raises, so the exit
code is non-zero and no result line appears.  It needs one CUDA device
and imports nothing of JAX.

Last three lines of the output: the card's name and power limit, one
JSON object describing every kernel, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import math
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
B_ODD = 249                     # odd: K8's bfloat16 rows at odd offsets
REQUESTS = 3                    # requests of the counted main-path run
TIMED_REQUESTS = 10
ADMM_TIMED_REQUESTS = 5
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
# The rho ladder (``bench.py --admm 20 --split --ladder``): four rungs, the
# start state puts scenario b on rung b mod 4, so every rung is live.
LADDER = (0.01, 0.1, 1.0, 10.0)
LADDER_SETTINGS = dict(max_iter=ADMM_ITERS, rho_update_interval=25,
                       eps_abs=1e-4, eps_rel=1e-4, diag_cost=True,
                       rho_ladder=LADDER)
LADDER_ADAPT_ITERS = 60         # adaptation after iterations 25 and 50
# The replicated per-instance loop (``bench.py --admm 20``: B=1024, a
# batched problem, per-instance adaptive rho), and its --cached variant.
B_REP = 1024
REP_SETTINGS = dict(max_iter=ADMM_ITERS, rho_update_interval=25, rho=0.1,
                    eps_abs=1e-4, eps_rel=1e-4)
PROBE_BATCH, PROBE_ITERS = 128, 50   # suggest_rho_ladder's probe
# The single-kernel iteration (K8): ``bench.py --admm 20 --batch 4096
# --horizon 64 --single-kernel`` (per-scenario adaptive rho, no cached
# factors), its cached-factor form at N=512, and a batched problem.
N_SINGLE = 64
SINGLE_SETTINGS = dict(max_iter=ADMM_ITERS, rho_update_interval=25, rho=0.1,
                       eps_abs=1e-4, eps_rel=1e-4)
# A run whose rho adapts (every 10th iteration from a start far from
# balance), for the float64 cross-checks of K8 against the split pair and
# the replicated loop: the same functions.
CROSS_SETTINGS = dict(max_iter=30, rho_update_interval=10, rho=1e-3,
                      eps_abs=1e-4, eps_rel=1e-4)
# The rocket soft-landing Monte-Carlo dispersion
# (examples/rocket_landing.py): B=512 entry states, N=48, 150 iterations.
N_ROCKET, B_ROCKET = 48, 512
ROCKET_SETTINGS = dict(max_iter=150, rho=1.0, rho_update_interval=10,
                       eps_abs=1e-4, eps_rel=1e-3)
# The segment-parallel PDP path: the main model written out once a
# scenario (B=1024), its horizon in S=8 segments of 64 stages; the solve
# timed once at each of PDP_SEGMENTS too.  The paper's own case: a few
# long-horizon instances (N=1024, B=128) in 1 and in 32 segments.  The
# kernels phase and the float64 cross-check of the ADMM loop cut N=64 into
# S_SMALL segments.
B_PDP, S_PDP = 1024, 8
PDP_SEGMENTS = (1, 4, 16, 32)
N_LAT, B_LAT, S_LAT = 1024, 128, 32
S_SMALL = 4
# K8's modes held against its plain version: name -> (nc, cones, shift).
K8_MODES = {"box": (NC, (), False), "cone+shift": (NC_CONE, THRUST_CONE, True)}
# K8 at odd widths on an odd batch (a bfloat16 stage block of odd length,
# and on an odd batch a row of scenarios, starts at an odd element, which
# the kernel's aligned pair copies must cover): nx, nu, nc, cones, shift.
K8_ODD = (3, 2, 5, ((1, 3, "soc"),), True)
# Kernel B's modes held against the plain version: (name, nc, cones,
# diagonal stage cost, shift).
K5_MODES = (
    ("box,diag", NC, (), True, False),
    ("box,full-Hs", NC, (), False, False),
    ("soc+shift", NC_CONE, THRUST_CONE, True, True),
    ("rsoc", NC, ((4, 5, "rsoc"),), True, False),
)

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
# The ladder request and the replicated requests (float32 kernels) against
# the same solve_fused on the plain versions in float64 on the CPU, first 8
# scenarios (no quantity is a max over the batch, so a subset is a valid
# witness), absolute, on ws / w / z / y and the residuals: 10x the 2.72e-5
# (ladder, on y: rho up to 10 scales the duals) and 6.67e-6 (replicated)
# measured on an H100 (see PERF.md).
LADDER_ATOL = 3e-4
REPLICATED_ATOL = 7e-5
# The ladder against the replicated loop with the same per-instance rho
# (N=64, B=256, float64, both on the card's kernels): the same function.
LADDER_VS_REPLICATED_ATOL = 1e-9
# solve_lanes against the shared solve on the same data (both float32
# kernels; 10x the 4.72e-6 measured), and against the f64 sequential solver
# (as MAIN_PATH_ATOL).
LANES_VS_SHARED_ATOL = 5e-5
# The single-kernel requests (float32 kernels) against the same solve_fused
# on the plain versions in float64 on the CPU, first 8 scenarios, absolute,
# on ws / w / z / y and the residuals; with bfloat16 stage data the plain
# path gets the same bfloat16 data (the same function): 10x the 7.34e-6
# measured on an H100 (see PERF.md).
SINGLE_ATOL = 7e-5
# The rocket dispersion (float32, 150 iterations, rho adapting every 10th)
# against the plain path in float64 on the CPU, first 8 scenarios, each
# quantity against its own largest magnitude where that exceeds 1 (states
# run to 100 m, duals to 170): 10x the 2.0e-5 measured on an H100 (see
# PERF.md).
ROCKET_RTOL = 2e-4
# K8 against the split pair and against the replicated loop, float64, both
# on the card: the same function.
SINGLE_CROSS_ATOL = 1e-9
# The PDP solve (float32 kernels) against solve_lanes on the same data
# (K1 + K7, float32 kernels: the same function by another algorithm), all
# scenarios, absolute, at every S and in the long-horizon case: 10x the
# 7.39e-6 measured on an H100 (see PERF.md); against the f64 sequential
# solver as MAIN_PATH_ATOL (4.4e-6 measured).
PDP_VS_LANES_ATOL = 7.4e-5
# The PDP ADMM loop against the replicated loop (N=64, B=256, float64, both
# on the card's kernels, rho adapting every 10th iteration): the same
# function; 10x the 2.8e-13 measured on an H100.
PDP_ADMM_CROSS_ATOL = 3e-12
# solve_packed against solve_lanes: the same kernels' arithmetic through
# other strides (float32 at full size, float64 at N=64); measured equal.
PACKED_ATOL = {torch.float32: 1e-12, torch.float64: 1e-12}

# The two widest models of the JAX package (BASELINE.md configs #2 and #5),
# their widths, constraint rows and cones: name -> (nx, nu, nc, cones,
# rows of the ADMM kernels).  The mass-spring chain has no constraint rows;
# the ADMM kernels (K4-K6, K8), which need rows, take a box on each of its
# 10 forces.  Every kernel is held against its plain version at both (N=64,
# B=256 and an odd B, whose rows are no 16-byte pieces: the word-copy
# paths), in float64 and float32.
WIDE = {"mass_spring": (40, 10, 0, (), 10),
        "centroidal": (24, 6, 6, ((0, 3, "soc"), (3, 3, "soc")), 6)}
B_WIDE = (B_SMALL, B_ODD)
# The stages of the narrow batch form's cases at these widths (some 530
# scenarios: the host's generation of their data is what costs; 8 stages
# turn the form's ring of two slots four times).
N_GROUP_WIDE = 8
# The JAX bench's requests at these widths (bench.py:575-612: float32,
# drift c = c_model + 0.001 N(0,1), x0 = 0.1 N(0,1), seed 0):
# ``ScenarioServer.solve`` on mass_spring_chain(n_masses=20, N=512) at
# B=2048 and on centroidal(N=1024) at B=4096; ``solve_admm`` on
# centroidal(N=1024) with its friction cones at B=2048, 20 iterations, in
# the split settings (ADMM_SETTINGS: K1 + K4 + K5) and in the default
# iteration (SINGLE_SETTINGS: K8, per-scenario rho, no cached factors).
N_MS, B_MS = 512, 2048
N_CEN, B_CEN, B_CEN_ADMM = 1024, 4096, 2048
C_SCALE_WIDE = 1e-3
WIDE_TIMED_REQUESTS = 5
# The wide requests against their float64 witnesses on 8 scenarios:
# ``solve`` against the sequential solver on the card, the ADMM requests
# against the same solve_admm on the plain versions on the CPU; each
# quantity's largest error against its own largest magnitude where that
# exceeds 1 (the centroidal model's contact forces run to about 500 N, and
# its float32 recursion, with R = 1e-4 I against forces of hundreds of
# newtons, carries far more rounding than the quadrotor's).  Each limit is
# 10x what was measured on an H100 (PERF.md): mass-spring 1.58e-6,
# centroidal 5.34e-5; the ADMM requests a limit a quantity, 10x the larger
# of the split and single-kernel requests' measurements (ws 2.23e-4, z
# 2.35e-4, y 3.54e-5, r_prim 5.88e-3 of its 3.75, r_dual 1.03e-3 absolute).
WIDE_RTOL = {"mass_spring_solve": 1.6e-5, "centroidal_solve": 5.4e-4}
WIDE_ADMM_RTOL = {"ws": 2.3e-3, "w": 2.3e-3, "z": 2.4e-3, "y": 3.6e-4,
                  "r_prim": 5.9e-2, "r_dual": 1.1e-2}
# The ``kernels`` line's entries at the wide requests' own tensors, kernel
# against plain version in float32: 10x the largest measured, K2 on the
# centroidal solve's tensors (2.50e-4 relative; every other entry at most
# 3.8e-5).  At N=64 (phase kernels_wide) every kernel stays within TOL.
WIDE_KERNEL_RTOL = 2.5e-3
# The reference-shaped solvers on the card: the quadrotor with the thrust
# cone, N=512, float64, a batched model of B=64 (S_API segments for the
# parallel solver).  The classes against the sequential witness (the KKT
# class is regularized by its rho_dyn = 1e-6 on the dynamics rows, so it
# is held to that, not to rounding); ``admm.solve_batched`` on each
# backend against the same call on the CPU.  Each limit is 10x what was
# measured on an H100 (PERF.md).
N_API, B_API, S_API = 256, 64, 8
# Measured: the classes against the sequential solver 1.32e-14, the KKT
# class 2.86e-4, solve_batched against the CPU 3.11e-14.
API_ATOL = 1.4e-13
API_KKT_ATOL = 2.9e-3
API_ADMM_ATOL = 3.2e-13
API_ADMM_SETTINGS = dict(max_iter=10, rho_update_interval=5, rho=0.1,
                         num_segments=S_API)

# The realtime operators and the MPC loops (solvers/realtime.py, mpc.py):
# torch ops, no hand-written kernel (the JAX package computes them outside
# any Pallas kernel too).  The quadrotor's dense map at N=64, float32
# (examples/latency_mpc.py's horizon and tolerances, rho = 1): a cold
# replan, then RT_TICKS warm ticks of a closed loop on the stage-0 plant,
# each tick timed by CUDA events against the 1 ms replan budget; the
# marginal cost of an iteration by latency_mpc's delta method (K and 2K
# iterations, no early exit).  The centroidal model (config #5, N=1024) on
# its segment-factored map at latency_mpc's automatic S (16), float32 and
# bfloat16 storage, and a four-rung ladder over RT_TICKS ticks.
RT_N = 64
RT_TICKS = 50
RT_DELTA_K = 20
RT_BUDGET_MS = 1.0
RT_SETTINGS = dict(rho=1.0, max_iter=200, rho_update_interval=200,
                   adaptive_rho=False, eps_abs=1e-4, eps_rel=1e-4)
RT_X0 = 0.05                    # every state of the quadrotor's start
RT_S_CHECK = 4                  # condensed against dense, float64
CEN_LADDER = (0.01, 0.1, 1.0, 10.0)
# bfloat16 against float32 storage at the JAX suite's serving tolerances
# (tests/test_realtime.py:274): converged replans of the quadrotor's dense
# map within 2e-2 relative (measured 3.8e-3 on an H100).  The bound does
# not carry over to the centroidal model's condensed map at N=1024: there
# the bfloat16 map is off by 0.22 on a random hf and the converged replan
# by 3.8 (relative; the JAX package's cast_operator gives the same
# semantics, PERF.md), so that phase records both and holds the mechanism
# instead: the bfloat16 map's products equal float32 products of its
# rounded entries (float32 accumulation), and the replan converges (on the
# rho = 0.01 rung, where both storages do).
BF16_SETTINGS = dict(RT_SETTINGS, eps_abs=1e-3, eps_rel=1e-3)
BF16_RTOL = 2e-2
CEN_BF16_SETTINGS = dict(RT_SETTINGS, rho=CEN_LADDER[0], max_iter=400,
                         rho_update_interval=400)
CEN_BF16_SEMANTICS_RTOL = 1e-6
# Checks, each a largest error relative to the reference's largest
# magnitude unless named: the float32 replan against the same replan in
# float64 (the same iterations; a TF32 product would move it by ~1e-3);
# the float64 replan against admm.solve (sequential inner solver, rho
# fixed: the same iteration count, absolute); the condensed map against the
# dense one in float64 (a map, then a whole replan, absolute).
# Measured on an H100 (PERF.md): 7.05e-6 and 3.88e-5 (float32 against
# float64), 3.1e-14, 2.6e-16 and 1.6e-14; the float32 limits are 10x.
RT_F32_RTOL = 7.1e-5
# The replan through ``replan_fn`` (a CUDA graph an iteration) against
# ``realtime.solve`` (eager): the same kernels in the same order.
RT_GRAPH_RTOL = 1e-6
CEN_F32_RTOL = 3.9e-4
RT_ADMM_ATOL = 1e-9
RT_COND_RTOL = 1e-9
RT_COND_SOLVE_ATOL = 1e-7
# The scenario batch: realtime.solve_batch on the quadrotor, N=64, B=4096,
# 15 iterations (examples/scenario_mpc.py's defaults: rho = 0.1, no
# adaptation, drift c + 0.002 N(0,1) a scenario), x0 = 0.1 N(0,1); held in
# float64 at N=16, B=64 against solve_fused on the same batched problem
# (K8, a uniform rho: the JAX suite's check, rho = 0.5, 25 iterations).
B_SB = 4096
SB_SETTINGS = dict(max_iter=15, rho_update_interval=15, adaptive_rho=False,
                   eps_abs=1e-4, eps_rel=1e-4, rho=0.1)
N_SB_CHECK, B_SB_CHECK = 16, 64
SB_CHECK_SETTINGS = dict(rho=0.5, max_iter=25, rho_update_interval=25,
                         adaptive_rho=False, eps_abs=1e-5, eps_rel=1e-4)
SB_ATOL = 1e-9
# The closed loops: simulate_realtime over MPC_TICKS ticks (float32), and
# the two loops against each other in float64 over MPC_TRACK_TICKS ticks
# (simulate runs admm.solve a tick: launch-bound), the JAX suite's
# settings and bound (tests/test_mpc.py:58).
MPC_TICKS = 200
MPC_TRACK_TICKS = 3
MPC_TRACK_SETTINGS = dict(rho=1.0, max_iter=60, rho_update_interval=60,
                          adaptive_rho=False, eps_abs=1e-6, eps_rel=1e-5)
MPC_TRACK_ATOL = 2e-3
# Recovery over solve_lanes (K1 + K7) on the main path's batch, with
# RECOVERY_SICK instances made indefinite (R - 5 I: K1's reciprocal square
# root of a negative pivot is NaN), one retry with a bump of 10.
RECOVERY_SICK = 8
RECOVERY_BUMP = 10.0
# The Ruiz-equilibrated solve on the quadrotor (N=64, float64) with its
# rows scaled across 1e6 and its cost by 1e4 (tests/test_scaling.py), on
# the torch-ops backend EQ_BACKEND: within 3x the well-scaled run's
# iterations, the same solution to 2e-3.
EQ_N = 64
EQ_BACKEND = "assoc"
EQ_SETTINGS = dict(max_iter=400, eps_abs=1e-4, eps_rel=1e-4)
EQ_ATOL = 2e-3


def require(ok, *what):
    """A failed check ends the run (also under ``python -O``)."""
    if not ok:
        raise RuntimeError("chip_smoke check failed: " + " ".join(map(str, what)))


T_START = time.time()


def emit(phase, **fields):
    """One JSON line a phase; ``t_s``: seconds since the script started."""
    print(json.dumps({"phase": phase, **fields,
                      "t_s": round(time.time() - T_START, 1)}), flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
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
K5_RUNG_OUT = ("wzy", "xN", "res")
K6_OUT = ("dv",)
K1_EXPORT = ("K", "d", "P", "L")
K8_OUT = ("w", "z", "y", "xN", "res")
K9_OUT = ("K", "d", "M", "v", "Gp", "P0", "p0", "F0", "C0", "f0")
K9_ALL = ("K", "d", "M", "v", "Gp", "P", "L", "F", "P0", "p0", "F0", "C0",
          "f0")
K10_OUT = ("d", "v", "p0", "f0")


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


def spectral_radius(A):
    """max |eigenvalue| of each square matrix of A (..., n, n), the stack
    cut over the host's cores (each matrix's eigenvalues as in one call)."""
    flat = A.reshape((-1,) + A.shape[-2:])
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        parts = pool.map(lambda a: np.abs(np.linalg.eigvals(a)).max(axis=-1),
                         np.array_split(flat, 8))
        return np.concatenate(list(parts)).reshape(A.shape[:-2])


def random_stage_data(rng, N, nx, nu, nc, Bt, dtype, device):
    """Well-posed random inputs of the matrix sweep, batch-last."""
    nz = nx + nu
    A = rng.normal(size=(Bt, N, nx, nx))
    A /= spectral_radius(A)[..., None, None] * 1.1
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


def random_carries(rng, S, nx, Bt, dtype, device):
    """Random per-segment carries (P, p, F, C, f) of K9, (S, nx[, nx], Bt):
    P and C symmetric positive definite, F near the identity."""
    spd = lambda: (lambda G: G @ np.swapaxes(G, -1, -2) + np.eye(nx))(
        rng.normal(size=(Bt, S, nx, nx)) * 0.3)
    F = np.eye(nx) + rng.normal(size=(Bt, S, nx, nx)) * 0.2
    lanes = lambda x: torch.as_tensor(np.moveaxis(x, 0, -1)).to(
        device=device, dtype=dtype).contiguous()
    return tuple(lanes(x) for x in (spd(), rng.normal(size=(Bt, S, nx)) * 0.3,
                                    F, spd() * 0.5,
                                    rng.normal(size=(Bt, S, nx)) * 0.3))


def pack_streams(A, B, c, H, h, D, rho, rg):
    """K11/K12's row-packed streams Sd = (A | B | c), Sc = (H | h | D | rho
    | rho g) of per-instance stage tensors."""
    flat = lambda x: x.flatten(1, 2)
    return (torch.cat([flat(A), flat(B), c], dim=1).contiguous(),
            torch.cat([flat(H), h, flat(D), rho, rg], dim=1).contiguous())


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
                          r"backward_pdp_vectors_kernel|"
                          r"forward_shared_kernel|backward_vectors_kernel|"
                          r"forward_rollout_kernel|backward_kernel|"
                          r"forward_kernel|bwd_vec_prefold_kernel|"
                          r"bwd_vec_kernel|fwd_update_kernel|iter_kernel)"
                          r"(?:I(d|f|13__nv_bfloat16)?((?:L[bi]n?\d+E)+)E)?",
                          name)
            if not m:
                continue
            flags = ",".join(f.replace("n", "-") for f in
                             re.findall(r"L[bi](n?\d+)E", m.group(3) or ""))
            if m.group(2) == "13__nv_bfloat16":
                flags = "bf16," + flags
            key = f"{m.group(1)}<{flags}>/{scalar}/nc={log[0].get('NC', '-')}"
            if "STAGE_BF16" in log[0]:          # a narrow library's form
                key += ",bf16"
            if "NRUNG" in log[0]:
                key += f",rungs={log[0]['NRUNG']}"
            if "DIAG_COST" in log[0]:
                key += f",diag={log[0]['DIAG_COST']}"
            if "NCONES" in log[0]:
                key += (f",shift={log[0]['HAS_SHIFT']},cones={log[0]['NCONES']}"
                        f",nx={log[0]['NX']}")
            elif int(log[0]["NX"]) != NX:       # a wide width's library
                key += f",nx={log[0]['NX']}"
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


def k9_flops(N, nx, nu, nc, Bt):
    """K1 with closed-loop maps, plus F+ A, F+ B, F+ c, the nx extra
    right-hand sides, F = F+ A + (F+ B) K, C's triangle and f."""
    return k1_flops(N, nx, nu, nc, Bt) + N * Bt * (
        2 * nx ** 3 + 2 * nx * nx * nu + 2 * nx * nx        # FA FB Fc
        + 2 * nu * nu * nx                                  # Gp columns
        + 2 * nx * nx * nu + nx * (nx + 1) * nu             # F, C
        + 2 * nx * nu + 2 * nx)                             # f


def k10_flops(N, nx, nu, Bt):
    """K2's recursion on the P stream, plus f = F v + f."""
    return k2_flops(N, nx, nu, Bt) + N * Bt * (2 * nx * nx + 2 * nx * nx)


def k3_flops(N, nx, nu, Bt):
    return N * Bt * (2 * nu * nx + 2 * nx * nx)


def k5_flops(N, nx, nu, nc, Bt, diag_cost, emit_hf=True):
    nz = nx + nu
    per_stage = (
        2 * nu * nx + 2 * nx * nx              # u, x+
        + 4 * nc * nz                          # D w~, D w+
        + (6 if emit_hf else 4) * nc * nz      # [hf+,] D^T zt, D^T y+
        + (4 * nz if diag_cost else 4 * nz * nz)   # Hs dw, Hs w+
        + 10 * nz + 20 * nc                    # relax, project, dual, maxima
    )
    return N * Bt * per_stage


def k6_flops(N, nx, nu, nc, Bt):
    nz = nx + nu
    fold = 3 * nc + nz * (2 + 2 * nc)          # rg, hf = h - sigma w - D^T rg
    return N * Bt * fold + k2_flops(N, nx, nu, Bt)   # P c, then K2's recursion


def k7_flops(N, nx, nu, Bt):
    return N * Bt * (2 * nu * nx + 2 * nx * nx + 2 * nx * nu + nx)


def k8_flops(N, nx, nu, nc, Bt, cached):
    """K8: phase 1 is K6's fold and K2's recursion (cached) or the
    iterate fold and K1's sweep without its closed-loop maps; phase 2
    K7's rollout and K5's tail on the full Hs without hf-emit."""
    nz = nx + nu
    if cached:
        phase1 = k6_flops(N, nx, nu, nc, Bt)
    else:
        phase1 = (k1_flops(N, nx, nu, nc, Bt)
                  + N * Bt * (2 * nz + 3 * nc - 2 * nx * nx * nu - 2 * nx * nu))
    tail = (k5_flops(N, nx, nu, nc, Bt, False, emit_hf=False)
            - N * Bt * (2 * nu * nx + 2 * nx * nx))
    return phase1 + k7_flops(N, nx, nu, Bt) + tail


def _stage_bounds(T, N, nz, nc, cones, diag_cost, has_shift, dt, dev):
    """Random shared stage data of kernel B: Hs, D and the packed bound
    stream bnd = stack(lb, ub, rho-scale mask[, shift])."""
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
    return Hs, D, torch.stack(parts, dim=1).contiguous()


def _normal(rng, dt, dev):
    return lambda *s, scale=0.3: torch.as_tensor(
        rng.normal(size=s) * scale).to(device=dev, dtype=dt).contiguous()


def random_admm_inputs(rng, A, Bm, K, M, L, nc, Bt, cones, diag_cost,
                       has_shift):
    """Random inputs of the split iteration's two kernels around one
    shared model's matrices (trailing size 1): the argument tuples of
    ``admm_bwd_vec_prefold_lanes`` and of ``admm_fwd_update_lanes`` in its
    packed form (rho, x0, MK, Hs, D, bnd, dv, wzy, h)."""
    N, nx, nu = A.shape[0], A.shape[1], Bm.shape[2]
    nz = nx + nu
    dt, dev = A.dtype, A.device
    T = _normal(rng, dt, dev)
    AK, BL, MK = (torch.cat(pair, dim=1) for pair in ((A, K), (Bm, L), (M, K)))
    k4_in = (T(nx, Bt), AK, BL, T(N, nx, Bt, scale=0.1), T(N, nx, Bt),
             T(N, nz, Bt))
    Hs, D, bnd = _stage_bounds(T, N, nz, nc, cones, diag_cost, has_shift, dt,
                               dev)
    rho = torch.as_tensor(rng.uniform(0.05, 2.0, size=(1, Bt))).to(
        device=dev, dtype=dt)
    k5_in = (rho, T(nx, Bt), MK, Hs, D, bnd, T(N, nz, Bt),
             T(N, nz + 2 * nc, Bt), T(N, nz, 1))
    return k4_in, k5_in


def random_ladder_inputs(rng, A, Bm, R, nc, Bt, cones, diag_cost,
                         has_shift):
    """Random inputs of K6 and of K5's rung form around one shared
    model's dynamics (trailing size 1) with R rungs of factors stacked on
    rows.  Returns (K6's positional arguments (rho, pN, A, B, h, D, mask,
    P, L, K, c, wzy), K5's as ``k5_call`` takes them (rho, x0, M, Hs, D,
    bnd, dv, wzy, h; its K is K6's), the rung of each scenario ((B,)
    int32, scenario b on rung b mod R), and a pre-folded Pc for K6's
    one-rung Pc form)."""
    N, nx, nu = A.shape[0], A.shape[1], Bm.shape[2]
    nz = nx + nu
    dt, dev = A.dtype, A.device
    T = _normal(rng, dt, dev)
    L = torch.tril(T(N, R, nu, nu, scale=0.2)) + torch.diag_embed(
        1.0 + T(N, R, nu).abs())
    L = L.reshape(N, R * nu, nu, 1).contiguous()
    P, K, M = T(N, R * nx, nx, 1), T(N, R * nu, nx, 1), T(N, R * nx, nx, 1,
                                                          scale=0.25)
    Hs, D, bnd = _stage_bounds(T, N, nz, nc, cones, diag_cost, has_shift, dt,
                               dev)
    rho = torch.as_tensor(rng.uniform(0.05, 2.0, size=(1, Bt))).to(
        device=dev, dtype=dt)
    wzy, h = T(N, nz + 2 * nc, Bt), T(N, nz, 1)
    k6_in = (rho, T(nx, Bt), A, Bm, h, D, bnd[:, 2].contiguous(), P, L, K,
             T(N, nx, Bt, scale=0.1), wzy)
    k5_in = (rho, T(nx, Bt), M, Hs, D, bnd, T(N, nz, Bt), wzy, h)
    rung = torch.as_tensor(np.arange(Bt) % R, dtype=torch.int32, device=dev)
    return k6_in, k5_in, rung, T(N, nx, Bt)


def random_iter_inputs(rng, N, nx, nu, nc, Bt, cones, shared, has_shift,
                       dtype, device):
    """Random inputs of K8 (``admm_iter_lanes``' positional arguments, in
    the compute type) around a stable random model: its streams and
    bounds have trailing size 1 with ``shared``, else one copy a scenario
    (each its own).  A padded row, an equality boost, one-sided and free
    rows, as in K5's check."""
    nz, mb = nx + nu, 1 if shared else Bt
    A, Bm, _, H, h, D, _, _, _, _ = random_stage_data(
        rng, N, nx, nu, nc, mb, dtype, device)
    T = _normal(rng, dtype, device)
    lb, ub = -T(N, nc, mb).abs(), T(N, nc, mb).abs()
    lb[:, ::3] = -float("inf")
    ub[:, 1::4] = float("inf")
    mask = torch.ones((N, nc, mb), dtype=dtype, device=device)
    if nc:
        mask[:, nc - 1 if not cones else 0] = 0.0
        mask[N // 2:, nc // 2] = 1e3
    for off, dim, _ in cones:
        mask[:, off:off + dim] = 1.0
    rho = torch.as_tensor(rng.uniform(0.05, 2.0, size=(1, Bt))).to(
        device=device, dtype=dtype)
    GN = T(Bt, nx, nx)
    PN = (GN @ GN.transpose(1, 2) + torch.eye(nx, dtype=dtype, device=device)
          ).permute(1, 2, 0).contiguous()
    return (A, Bm, T(N, nx, Bt, scale=0.1), H, h, D, lb, ub, mask,
            T(N, nc, mb) if has_shift else None, T(N, nz, Bt), T(N, nc, Bt),
            T(N, nc, Bt), rho, PN, T(nx, Bt), T(nx, Bt))


def iter_factors(args, shared):
    """K8's cached factors (P, L, K) for its inputs ``args``: K1's plain
    version with export at scenario 0's rho on a shared model (one copy),
    per scenario on a batched one."""
    from pdp_lqr_tpu_torch.ops import cuda_riccati as cr
    A, Bm, c, H, _, D, _, _, mask, _, _, _, _, rho, PN, _, _ = args
    N, nx, nu, nc, mb = A.shape[0], A.shape[1], Bm.shape[2], D.shape[1], A.shape[-1]
    zeros = lambda *s: torch.zeros(s + (mb,), dtype=A.dtype, device=A.device)
    K, _, P, L = cr.backward_lanes_reference(
        A, Bm, c[..., :mb], H, zeros(N, nx + nu), D,
        (rho[0, :mb] * mask).contiguous(), zeros(N, nc), PN[..., :mb],
        zeros(nx), export_factors=True, emit_closed_loop=False)
    return P, L, K


def narrow_storage(args):
    """K8's inputs with the stage data A, B, c, Hs, h, D stored as bfloat16."""
    return tuple(x.to(torch.bfloat16) if i < 6 else x for i, x in enumerate(args))


def narrow_streams(streams):
    """Stage streams stored as bfloat16 (contiguous, freshly allocated:
    4-byte aligned, as the narrow forms' pair copies need)."""
    return tuple(x.to(torch.bfloat16).contiguous() for x in streams)


# The narrow sets of the split kernels' argument tuples (positions): K4's
# AK, BL, c; K5's (k5_call's tuple) M or MK, Hs, D, h; K6's A, B, h, D, P,
# L, K, c.  K5's rung form adds its K, passed apart.
K4_NARROW, K5_NARROW, K6_NARROW = (1, 2, 3), (2, 3, 4, 8), (2, 3, 4, 5, 7,
                                                            8, 9, 10)


def narrow_args(args, positions):
    """An argument tuple with the tensors at ``positions`` stored as
    bfloat16 (contiguous; None stays None)."""
    return tuple(x.to(torch.bfloat16).contiguous()
                 if i in positions and x is not None else x
                 for i, x in enumerate(args))


# The narrow split kernels' forms held in ``kernels``: K5 packed with
# hf-emit in two modes (name, nc, cones, diagonal cost, shift), K6 and K5's
# rung form on R rungs.
NARROW_K5_MODES = (("box,diag", NC, (), True, False),
                   ("soc+shift,full-Hs", NC_CONE, THRUST_CONE, False, True))
NARROW_RUNGS = (2, len(LADDER))


def narrow_split_defines(ca, dt):
    """The ``-D`` flags of the narrow split kernels' libraries that
    ``kernels`` and the two narrow phases use, compute type ``dt``."""
    out = [ca.kernel_defines(dt, NX, NU, narrow=True)]
    out += [ca.kernel_defines(dt, NX, NU, nc, cones=cones, diag_cost=diag,
                              has_shift=shift, narrow=True)
            for _, nc, cones, diag, shift in NARROW_K5_MODES]
    for R in NARROW_RUNGS:
        out += [ca.kernel_defines(dt, NX, NU, NC, fold=True, rungs=R,
                                  narrow=True),
                ca.kernel_defines(dt, NX, NU, NC, diag_cost=True, rungs=R,
                                  narrow=True)]
    return out


def narrow_split_cases(ca, compare, rng, A, Bm, K, M, L, Bt):
    """The narrow split kernels against their plain versions on one shared
    model's factors (A, Bm, K, M, L; trailing size 1) and ``Bt`` scenarios:
    K4, K5 packed with hf-emit in NARROW_K5_MODES, K6 and K5's rung form
    (no hf, the ladder's) on NARROW_RUNGS rungs; the narrow sets bfloat16."""
    for i, (mode, nc, cones, diag, shift) in enumerate(NARROW_K5_MODES):
        k4_in, k5_in = random_admm_inputs(rng, A, Bm, K, M, L, nc, Bt, cones,
                                          diag, shift)
        k4_in, k5_in = narrow_args(k4_in, K4_NARROW), narrow_args(k5_in,
                                                                  K5_NARROW)
        if i == 0:
            compare(f"admm_bwd_vec_prefold_lanes[bf16,B={Bt}]", K4_OUT,
                    [ca.admm_bwd_vec_prefold_lanes(*k4_in, nu=NU)],
                    [ca.admm_bwd_vec_prefold_lanes_reference(*k4_in, nu=NU)])
        compare(f"admm_fwd_update_lanes[bf16,{mode},B={Bt}]", K5_OUT,
                k5_call(ca, k5_in, cones), k5_plain(ca, k5_in, cones))
    for R in NARROW_RUNGS:
        k6_in, k5_in, rung, _ = random_ladder_inputs(rng, A, Bm, R, NC, Bt,
                                                     (), True, False)
        k6_in = narrow_args(k6_in, K6_NARROW)
        k5_in = narrow_args(k5_in[:8] + (None,), K5_NARROW)
        tag = f"R={R},B={Bt}"
        compare(f"admm_bwd_vec_lanes[bf16,{tag}]", K6_OUT,
                [ca.admm_bwd_vec_lanes(*k6_in, nu=NU, sigma=SIGMA, rung=rung)],
                [ca.admm_bwd_vec_lanes_reference(*k6_in, nu=NU, sigma=SIGMA,
                                                 rung=rung)])
        compare(f"admm_fwd_update_lanes[bf16,rung,{tag},hf=0]", K5_RUNG_OUT,
                k5_call(ca, k5_in, (), K=k6_in[9], rung=rung),
                k5_plain(ca, k5_in, (), K=k6_in[9], rung=rung))


def narrow_group_batches(cr, dt, nx, nu, nc):
    """Two batches that reach the batch form of K1 / K11 on bfloat16 stage
    streams (G instances a block, the library's own G): the first multiple
    of G and of 8 past the pairs where groups take over (the stages land in
    boxes of the copy engine, 8 instances a row), and G + 1 past it (4-byte
    pairs by cp.async, at odd offsets every other entry where G is even,
    and a ragged last group)."""
    group = lambda Bt: cr.sweep_group(dt, nx, nu, nc, Bt,
                                      emit_closed_loop=False, narrow=True)
    G = group(1 << 30)
    step = G * 8 // math.gcd(G, 8)
    past = step
    while group(past) == 0:
        past += step
    return past, past + G + 1


def narrow_cases(cr, compare, data, x0, nu, nc, tag):
    """The four narrow forms (K1 gains only, K11, K7, K12) against their
    plain versions on ``data`` (random_stage_data's ten tensors; its eight
    stage streams made bfloat16) in its compute type, each case named with
    ``tag`` (the batch or width)."""
    st = narrow_streams(data[:8])
    PN, pN = data[8:]
    k1 = st + (PN, pN)
    compare(f"backward_lanes[bf16,{tag}]", K1_GAINS,
            cr.backward_lanes(*k1, emit_closed_loop=False),
            cr.backward_lanes_reference(*k1, emit_closed_loop=False))
    Sd, Sc = pack_streams(*st)
    k11 = (Sd, Sc, PN, pN, nu, nc)
    compare(f"backward_packed[bf16,{tag}]", ("G",), [cr.backward_packed(*k11)],
            [cr.backward_packed_reference(*k11)])
    K, d = cr.backward_lanes_reference(*k1, emit_closed_loop=False)
    k7 = (st[0], st[1], st[2], K, d, x0)
    compare(f"forward_rollout_lanes[bf16,{tag}]", K3_OUT,
            cr.forward_rollout_lanes(*k7), cr.forward_rollout_lanes_reference(*k7))
    G = cr.backward_packed_reference(*k11)
    k12 = (Sd, G, x0, nu)
    compare(f"forward_packed[bf16,{tag}]", K3_OUT, cr.forward_packed(*k12),
            cr.forward_packed_reference(*k12))


def k5_call(ca, k5_in, cones, K=None, rung=None, nu=NU):
    """Kernel B's wrapper on the packed argument tuple (``K`` None) or on
    the rung form's (M, K, ...) with the packed bound stream."""
    rho, x0, M, Hs, D, bnd, dv, wzy, h = k5_in
    return ca.admm_fwd_update_lanes(
        rho, x0, M, K, Hs, D, bnd, None, None, None, dv, wzy, nu=nu,
        cones=cones, alpha=ALPHA, sigma=SIGMA, h=h, rung=rung)


def k5_plain(ca, k5_in, cones, K=None, rung=None, nu=NU):
    """Kernel B's plain version on the same arguments."""
    rho, x0, M, Hs, D, bnd, dv, wzy, h = k5_in
    return ca.admm_fwd_update_lanes_reference(
        rho, x0, M, K, Hs, D, bnd, dv, wzy, h, nu=nu, cones=cones, alpha=ALPHA,
        sigma=SIGMA, rung=rung)


def zero_state(n, N, nc, dt, device, rho):
    """Zero iterates of ``n`` scenarios with the given per-scenario rho."""
    from pdp_lqr_tpu_torch.solvers.admm import ADMMState
    zeros = lambda *s: torch.zeros((n,) + s, dtype=dt, device=device)
    return ADMMState(
        w=zeros(N + 1, NX + NU), z=zeros(N + 1, nc), y=zeros(N + 1, nc),
        rho=torch.as_tensor(rho).to(device=device, dtype=dt))


def batched(model, n, c):
    """The model written out once a scenario (a leading batch axis on
    every field; views, no copies), with per-scenario drift ``c``."""
    import pdp_lqr_tpu_torch as plt_
    return plt_.LQRProblem(**{
        f.name: c if f.name == "c" else getattr(model, f.name)[None].expand(
            (n,) + getattr(model, f.name).shape)
        for f in dataclasses.fields(model)})


def zero_counts():
    from pdp_lqr_tpu_torch.ops import cuda_admm as ca, cuda_riccati as cr
    return {k: 0 for k in (*cr.LAUNCHES, *ca.LAUNCHES)}


@contextlib.contextmanager
def recorded_calls(module, names):
    """While active, ``module.<name>`` also keeps the arguments of its
    last call: how the timing phase gets at the very tensors a path hands
    its kernels.  A name that is no function of the module (a narrow
    form's launch counter) is skipped: its wrapper's name records it."""
    last = {}
    originals = {name: getattr(module, name) for name in names
                 if callable(getattr(module, name, None))}

    def recorder(name):
        def call(*args, **kwargs):
            last[name] = (args, kwargs)
            return originals[name](*args, **kwargs)
        return call

    for name in originals:
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


def profiled(request, reps):
    """``torch.profiler`` over ``reps`` requests: (device time by kernel
    name per request, sorted; device busy ms per request; the window's
    host ms per request)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            request()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3 / reps
    rows = []
    for ev in prof.key_averages():
        # Device-side rows only: an operator's row repeats its kernels' time.
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if ev.self_device_time_total > 0:
            rows.append({"name": ev.key[:90], "calls_per_request": ev.count / reps,
                         "device_ms_per_request":
                             ev.self_device_time_total / 1e3 / reps})
    rows.sort(key=lambda r: -r["device_ms_per_request"])
    return rows, sum(r["device_ms_per_request"] for r in rows), window_ms


def timed(request, reps, batch):
    """A request's median time by CUDA events, solves/s, and the peak
    device memory while it ran (tensors that earlier phases hold included)."""
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(request, reps)
    return {"request_ms": ms, "solves_per_s": batch / (ms * 1e-3),
            "peak_memory_bytes": torch.cuda.max_memory_allocated()}


ALLOC_STATS = ("num_alloc_retries", "num_device_alloc", "num_device_free")


def request_probe(request, admm):
    """What one request does beside its kernels: the caching allocator's
    events (``torch.cuda.memory_stats`` deltas: retries after a failed
    ``cudaMalloc``, device allocations and frees), the host reads, and the
    allocator's reserved and allocated bytes after it."""
    torch.cuda.synchronize()
    admm.reset_host_reads()
    before = torch.cuda.memory_stats()
    request()
    torch.cuda.synchronize()
    after = torch.cuda.memory_stats()
    return {**{k: after.get(k, 0) - before.get(k, 0) for k in ALLOC_STATS},
            "host_reads": dict(admm.HOST_READS),
            "reserved_bytes": torch.cuda.memory_reserved(),
            "allocated_bytes": torch.cuda.memory_allocated()}


def in_turns(requests, reps):
    """Median ms of each named request, timed in turns (a, b, b, a)."""
    times = {name: [] for name in requests}
    for name in list(requests) + list(requests)[::-1]:
        times[name].append(cuda_ms(requests[name], reps, warmup=1))
    return {name: float(np.median(t)) for name, t in times.items()}


def bound(bytes_moved, flops):
    """The least time of a call, ms: bytes over the card's memory rate or
    operations over its float32 rate (utils.profiling: one H100 SXM's
    published peaks), the larger, and which of the two it is."""
    from pdp_lqr_tpu_torch.utils.profiling import (
        PEAK_BYTES_PER_S, PEAK_F32_FLOPS)
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def wide_build_jobs(ca, cr, dtypes=(torch.float32, torch.float64)):
    """The specialisations of every kernel at the two wide widths, in
    ``dtypes``: the matrix sweeps (K1, K9, K11), the per-scenario kernels
    (K2, K3, K7, K10, K12), their narrow forms (bfloat16 stage streams),
    K4, K5 (the cones, diagonal cost), K6 (one rung), the narrow forms of
    those three, and K8 (the cones)."""
    jobs = []
    for dt in dtypes:
        for nx, nu, nc, cones, nca in WIDE.values():
            jobs += [
                (cr.SOURCE, cr.kernel_defines(dt, nx, nu, nc)),
                (cr.SOURCE, cr.kernel_defines(dt, nx, nu)),
                (cr.SOURCE, cr.kernel_defines(dt, nx, nu, nc, narrow=True)),
                (cr.SOURCE, cr.kernel_defines(dt, nx, nu, narrow=True)),
                (ca.SOURCE, ca.kernel_defines(dt, nx, nu)),
                (ca.SOURCE, ca.kernel_defines(dt, nx, nu, nca, cones=cones,
                                              diag_cost=True)),
                (ca.SOURCE, ca.kernel_defines(dt, nx, nu, nca, fold=True)),
                (ca.SOURCE, ca.kernel_defines(dt, nx, nu, nca, cones=cones,
                                              single=True)),
                (ca.SOURCE, ca.kernel_defines(dt, nx, nu, narrow=True)),
                (ca.SOURCE, ca.kernel_defines(dt, nx, nu, nca, cones=cones,
                                              diag_cost=True, narrow=True)),
                (ca.SOURCE, ca.kernel_defines(dt, nx, nu, nca, fold=True,
                                              narrow=True)),
            ]
    return jobs


def kernels_wide(ca, cr, dev):
    """Every kernel against its plain version at the two wide widths
    (WIDE), float64 and float32, N=64, B in B_WIDE.  On the float32 B=256
    tensors each kernel is also timed (and its plain version, once) for
    the ``kernels`` line.  Returns (the cases, {width: {kernel: entry}},
    an entry a dict of the line's fields)."""
    N, S = N_SMALL, S_SMALL
    cases, timing = [], {}
    for width, (nx, nu, nc, cones, nca) in WIDE.items():
        nz = nx + nu
        for dt in (torch.float64, torch.float32):
            rng = np.random.default_rng(SEED)
            T = _normal(rng, dt, dev)

            def compare(name, names, outs, refs):
                abs_err, rel = rel_err(names, outs, refs)
                cases.append({"kernel": name, "dtype": str(dt).split(".")[-1],
                              "max_abs_err": abs_err, "rel_err": rel,
                              "tol_rel": TOL[dt]})
                require(max(rel.values()) <= TOL[dt], (name, dt, abs_err, rel))

            def one_batch(Bt):
                # A function a batch: the calls kept for the timing hold
                # this batch's tensors.
                tag = f"{width},B={Bt}"
                spec = {}

                def check(name, counter, names, call, plain, flops, inputs,
                          replaces):
                    out = call()
                    ref, plain_ms = event_ms(plain)
                    compare(f"{name}[{tag}]", names, out, ref)
                    if dt != torch.float32 or Bt != B_SMALL:
                        return
                    abs_err, rel = rel_err(names, out, ref)
                    moved = nbytes(*(x for x in inputs
                                     if isinstance(x, torch.Tensor)), *out)
                    spec[name] = {
                        "counter": counter, "replaces": replaces,
                        "max_abs_err": abs_err, "rel_err": rel,
                        "ms": cuda_ms(call, WIDE_TIMED_REQUESTS),
                        "plain_ms": plain_ms, "bytes": moved, "flops": flops}

                data = random_stage_data(rng, N, nx, nu, nc, Bt, dt, dev)
                one = tuple(x[..., :1].contiguous() for x in data)
                # K1: one shared model and per instance, every output.
                check("backward_lanes[shared]", "backward_lanes", K1_ALL,
                      lambda: cr.backward_lanes(*one, export_factors=True),
                      lambda: cr.backward_lanes_reference(
                          *one, export_factors=True),
                      k1_flops(N, nx, nu, nc, 1), one, "pallas_riccati.py:778")
                check("backward_lanes[per-instance]", "backward_lanes", K1_ALL,
                      lambda: cr.backward_lanes(*data, export_factors=True),
                      lambda: cr.backward_lanes_reference(
                          *data, export_factors=True),
                      k1_flops(N, nx, nu, nc, Bt), data, "pallas_riccati.py:778")
                K, d, M, v, P, L = cr.backward_lanes_reference(
                    *one, export_factors=True)
                Kp, dp, Mp, vp, Pp, Lp = cr.backward_lanes_reference(
                    *data, export_factors=True)
                A1, B1 = one[0], one[1]
                A, Bm = data[0], data[1]
                c, hf = T(N, nx, Bt, scale=0.1), T(N, nz, Bt)
                pN, x0 = T(nx, Bt), T(nx, Bt)
                # K2 and K3 on the shared model's factors, B scenarios.
                Pc = cr.fold_Pc(P, c).contiguous()
                k2s = (A1, B1, c, hf, P, K, L, pN)
                check("backward_vectors_lanes[shared,Pc]",
                      "backward_vectors_lanes", K2_OUT,
                      lambda: cr.backward_vectors_lanes(*k2s, shared=True,
                                                        Pc=Pc),
                      lambda: cr.backward_vectors_lanes_reference(*k2s, Pc=Pc),
                      k2_flops(N, nx, nu, Bt), k2s[:4] + (Pc, K, L, pN),
                      "pallas_riccati.py:1023")
                compare(f"backward_vectors_lanes[shared,P][{tag}]", K2_OUT,
                        cr.backward_vectors_lanes(*k2s, shared=True),
                        cr.backward_vectors_lanes_reference(*k2s))
                d2, v2 = cr.backward_vectors_lanes_reference(*k2s, Pc=Pc)
                k3s = (M, v2, K, d2, x0)
                check("forward_lanes[shared]", "forward_lanes", K3_OUT,
                      lambda: cr.forward_lanes(*k3s, shared=True),
                      lambda: cr.forward_lanes_reference(*k3s),
                      k3_flops(N, nx, nu, Bt), k3s, "pallas_riccati.py:1201")
                # K2, K3 and K7 per instance, on the per-instance factors.
                Pcp = torch.einsum("kijb,kjb->kib", Pp, c).contiguous()
                k2p = (A, Bm, c, hf, Pp, Kp, Lp, pN)
                check("backward_vectors_lanes[per-instance]",
                      "backward_vectors_lanes", K2_OUT,
                      lambda: cr.backward_vectors_lanes(*k2p),
                      lambda: cr.backward_vectors_lanes_reference(*k2p),
                      k2_flops(N, nx, nu, Bt), k2p, "pallas_riccati.py:1023")
                compare(f"backward_vectors_lanes[per-instance,Pc][{tag}]",
                        K2_OUT, cr.backward_vectors_lanes(*k2p, Pc=Pcp),
                        cr.backward_vectors_lanes_reference(*k2p, Pc=Pcp))
                k3p = (Mp, vp, Kp, dp, x0)
                check("forward_lanes[per-instance]", "forward_lanes", K3_OUT,
                      lambda: cr.forward_lanes(*k3p),
                      lambda: cr.forward_lanes_reference(*k3p),
                      k3_flops(N, nx, nu, Bt), k3p, "pallas_riccati.py:1201")
                k7 = (A, Bm, data[2], Kp, dp, x0)
                check("forward_rollout_lanes", "forward_rollout_lanes", K3_OUT,
                      lambda: cr.forward_rollout_lanes(*k7),
                      lambda: cr.forward_rollout_lanes_reference(*k7),
                      k7_flops(N, nx, nu, Bt), k7, "pallas_riccati.py:1319")
                # K9 (both forms) in S segments, K10 on its factors, K3 in
                # the same segments; K11 and K12 on the packed streams.
                k9 = data[:8] + random_carries(rng, S, nx, Bt, dt, dev)
                check("backward_pdp_lanes", "backward_pdp_lanes", K9_OUT,
                      lambda: cr.backward_pdp_lanes(*k9, segments=S),
                      lambda: cr.backward_pdp_lanes_reference(*k9,
                                                              segments=S),
                      k9_flops(N, nx, nu, nc, Bt), k9, "pallas_riccati.py:481")
                compare(f"backward_pdp_lanes[export][{tag}]", K9_ALL,
                        cr.backward_pdp_lanes(*k9, export_factors=True,
                                              segments=S),
                        cr.backward_pdp_lanes_reference(
                            *k9, export_factors=True, segments=S))
                K9f, d9, M9, v9, _, P9, L9, F9 = \
                    cr.backward_pdp_lanes_reference(
                        *k9, export_factors=True, segments=S)[:8]
                k10 = (A, Bm, data[2], hf, P9, K9f, L9, F9, T(S, nx, Bt))
                check("backward_pdp_vectors_lanes",
                      "backward_pdp_vectors_lanes", K10_OUT,
                      lambda: cr.backward_pdp_vectors_lanes(*k10, segments=S),
                      lambda: cr.backward_pdp_vectors_lanes_reference(
                          *k10, segments=S),
                      k10_flops(N, nx, nu, Bt), k10, "pallas_riccati.py:644")
                k3g = (M9, v9, K9f, d9, T(S, nx, Bt))
                check("forward_lanes[segments]", "forward_lanes", K3_OUT,
                      lambda: cr.forward_lanes(*k3g, segments=S),
                      lambda: cr.forward_lanes_reference(*k3g, segments=S),
                      k3_flops(N, nx, nu, Bt), k3g, "pallas_riccati.py:1201")
                Sd, Sc = pack_streams(*data[:8])
                k11 = (Sd, Sc, data[8], data[9], nu, nc)
                check("backward_packed", "backward_packed", ("G",),
                      lambda: [cr.backward_packed(*k11)],
                      lambda: [cr.backward_packed_reference(*k11)],
                      k1_flops(N, nx, nu, nc, Bt), k11[:4],
                      "pallas_riccati.py:1485")
                G = cr.backward_packed_reference(*k11)
                k12 = (Sd, G, x0, nu)
                check("forward_packed", "forward_packed", K3_OUT,
                      lambda: cr.forward_packed(*k12),
                      lambda: cr.forward_packed_reference(*k12),
                      k7_flops(N, nx, nu, Bt), k12[:3],
                      "pallas_riccati.py:1543")
                # The split pair around the shared model's factors: K4, K5
                # (the model's cones, diagonal cost) with and without
                # hf-emit; K6 on one rung, both forms.
                k4, k5 = random_admm_inputs(rng, A1, B1, K, M, L, nca, Bt,
                                            cones, True, False)
                check("admm_bwd_vec_prefold_lanes",
                      "admm_bwd_vec_prefold_lanes", K4_OUT,
                      lambda: [ca.admm_bwd_vec_prefold_lanes(*k4, nu=nu)],
                      lambda: [ca.admm_bwd_vec_prefold_lanes_reference(
                          *k4, nu=nu)],
                      k2_flops(N, nx, nu, Bt), k4, "pallas_admm.py:526")
                check("admm_fwd_update_lanes", "admm_fwd_update_lanes", K5_OUT,
                      lambda: k5_call(ca, k5, cones, nu=nu),
                      lambda: k5_plain(ca, k5, cones, nu=nu),
                      k5_flops(N, nx, nu, nca, Bt, True), k5,
                      "pallas_admm.py:867")
                k5n = k5[:8] + (None,)
                compare(f"admm_fwd_update_lanes[hf=0][{tag}]", K5_RUNG_OUT,
                        k5_call(ca, k5n, cones, nu=nu),
                        k5_plain(ca, k5n, cones, nu=nu))
                k6, _, _, Pc6 = random_ladder_inputs(rng, A1, B1, 1, nca, Bt,
                                                     cones, True, False)
                check("admm_bwd_vec_lanes", "admm_bwd_vec_lanes", K6_OUT,
                      lambda: [ca.admm_bwd_vec_lanes(*k6, nu=nu, sigma=SIGMA)],
                      lambda: [ca.admm_bwd_vec_lanes_reference(
                          *k6, nu=nu, sigma=SIGMA)],
                      k6_flops(N, nx, nu, nca, Bt), k6, "pallas_admm.py:766")
                pc6 = k6[:7] + (None,) + k6[8:]
                compare(f"admm_bwd_vec_lanes[Pc][{tag}]", K6_OUT,
                        [ca.admm_bwd_vec_lanes(*pc6, nu=nu, sigma=SIGMA,
                                               Pc=Pc6)],
                        [ca.admm_bwd_vec_lanes_reference(*pc6, nu=nu,
                                                         sigma=SIGMA, Pc=Pc6)])
                # Their narrow forms: the narrow sets of the same inputs
                # stored as bfloat16.
                k4n, k5n, k6n = (narrow_args(k4, K4_NARROW),
                                 narrow_args(k5, K5_NARROW),
                                 narrow_args(k6, K6_NARROW))
                check("admm_bwd_vec_prefold_lanes[bf16]",
                      "admm_bwd_vec_prefold_lanes[bf16]", K4_OUT,
                      lambda: [ca.admm_bwd_vec_prefold_lanes(*k4n, nu=nu)],
                      lambda: [ca.admm_bwd_vec_prefold_lanes_reference(
                          *k4n, nu=nu)],
                      k2_flops(N, nx, nu, Bt), k4n, "pallas_admm.py:526")
                check("admm_fwd_update_lanes[bf16]",
                      "admm_fwd_update_lanes[bf16]", K5_OUT,
                      lambda: k5_call(ca, k5n, cones, nu=nu),
                      lambda: k5_plain(ca, k5n, cones, nu=nu),
                      k5_flops(N, nx, nu, nca, Bt, True), k5n,
                      "pallas_admm.py:867")
                check("admm_bwd_vec_lanes[bf16]", "admm_bwd_vec_lanes[bf16]",
                      K6_OUT,
                      lambda: [ca.admm_bwd_vec_lanes(*k6n, nu=nu,
                                                     sigma=SIGMA)],
                      lambda: [ca.admm_bwd_vec_lanes_reference(
                          *k6n, nu=nu, sigma=SIGMA)],
                      k6_flops(N, nx, nu, nca, Bt), k6n, "pallas_admm.py:766")
                # K8 in its eight forms: shared or batched, cached or not,
                # the stage data in the compute type or bfloat16.
                for shared in (True, False):
                    args = random_iter_inputs(rng, N, nx, nu, nca, Bt, cones,
                                              shared, False, dt, dev)
                    for factors in (None, iter_factors(args, shared)):
                        for narrow in (False, True):
                            a = narrow_storage(args) if narrow else args
                            kw = dict(nu=nu, cones=cones, alpha=ALPHA,
                                      sigma=SIGMA, factors=factors)
                            form = ("shared" if shared else "batched") \
                                + (",cached" if factors else "") \
                                + (",bf16" if narrow else "")
                            check(f"admm_iter_lanes[{form}]", "admm_iter_lanes",
                                  K8_OUT,
                                  lambda a=a, kw=kw, sh=shared:
                                      ca.admm_iter_lanes(*a, shared=sh, **kw),
                                  lambda a=a, kw=kw:
                                      ca.admm_iter_lanes_reference(*a, **kw),
                                  k8_flops(N, nx, nu, nca, Bt,
                                           factors is not None),
                                  tuple(x for i, x in enumerate(a)
                                        if not (factors and i == 14))
                                  + tuple(factors or ()),
                                  "pallas_admm.py:1069")
                # The narrow forms: the stage streams of `data` stored as
                # bfloat16 (K1 gains only, K11, K7, K12).
                st = narrow_streams(data[:8])
                k1n = st + data[8:]
                check("backward_lanes[bf16]", "backward_lanes[bf16]",
                      K1_GAINS,
                      lambda: cr.backward_lanes(*k1n, emit_closed_loop=False),
                      lambda: cr.backward_lanes_reference(
                          *k1n, emit_closed_loop=False),
                      k1_flops(N, nx, nu, nc, Bt), k1n, "pallas_riccati.py:778")
                Sdn, Scn = pack_streams(*st)
                k11n = (Sdn, Scn, data[8], data[9], nu, nc)
                check("backward_packed[bf16]", "backward_packed[bf16]", ("G",),
                      lambda: [cr.backward_packed(*k11n)],
                      lambda: [cr.backward_packed_reference(*k11n)],
                      k1_flops(N, nx, nu, nc, Bt), k11n[:4],
                      "pallas_riccati.py:1485")
                Kn, dn = cr.backward_lanes_reference(*k1n,
                                                     emit_closed_loop=False)
                k7n = (st[0], st[1], st[2], Kn, dn, x0)
                check("forward_rollout_lanes[bf16]",
                      "forward_rollout_lanes[bf16]", K3_OUT,
                      lambda: cr.forward_rollout_lanes(*k7n),
                      lambda: cr.forward_rollout_lanes_reference(*k7n),
                      k7_flops(N, nx, nu, Bt), k7n, "pallas_riccati.py:1319")
                k12n = (Sdn, cr.backward_packed_reference(*k11n), x0, nu)
                check("forward_packed[bf16]", "forward_packed[bf16]", K3_OUT,
                      lambda: cr.forward_packed(*k12n),
                      lambda: cr.forward_packed_reference(*k12n),
                      k7_flops(N, nx, nu, Bt), k12n[:3],
                      "pallas_riccati.py:1543")
                return spec

            for Bt in B_WIDE:
                spec = one_batch(Bt)
                if dt == torch.float32 and Bt == B_SMALL:
                    timing[width] = spec
            # The batch form of the narrow K1 and K11 (B_WIDE's batches
            # take a block an instance).
            for Bt in narrow_group_batches(cr, dt, nx, nu, nc):
                data = random_stage_data(rng, N_GROUP_WIDE, nx, nu, nc, Bt,
                                         dt, dev)
                st = narrow_streams(data[:8])
                k1n = st + data[8:]
                tag = f"{width},group,N={N_GROUP_WIDE},B={Bt}"
                compare(f"backward_lanes[bf16][{tag}]", K1_GAINS,
                        cr.backward_lanes(*k1n, emit_closed_loop=False),
                        cr.backward_lanes_reference(*k1n,
                                                    emit_closed_loop=False))
                k11n = pack_streams(*st) + (data[8], data[9], nu, nc)
                compare(f"backward_packed[bf16][{tag}]", ("G",),
                        [cr.backward_packed(*k11n)],
                        [cr.backward_packed_reference(*k11n)])
    return cases, timing


@contextlib.contextmanager
def cpu_threads(n):
    """torch's CPU ops on ``n`` threads inside (restored after)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def wide_requests(plt_, admm, sequential, ca, cr, dev, card, check=True):
    """The four requests of the two wide models (see N_MS, N_CEN): each
    warmed up, counted once with the tensors it hands its kernels
    recorded, held against its float64 witness on 8 scenarios, timed.
    Emits a phase a request; returns {phase: (launches, recorded calls,
    (N, nx, nu, nc, B), cones)}.  ``check=False`` only runs and records
    them (``scripts/kernel_bench.py --kernels wide``)."""
    from pdp_lqr_tpu_torch.models import centroidal, mass_spring_chain
    n_ref, out = 8, {}

    def data(model, Bb):
        rng = np.random.default_rng(SEED)
        c = model.c.cpu().numpy()[None] + rng.normal(
            size=(Bb,) + tuple(model.c.shape)) * C_SCALE_WIDE
        x0 = rng.normal(size=(Bb, model.nx)) * 0.1
        return c.astype(np.float32), x0.astype(np.float32)

    def counted(request):
        cr.reset_launch_counts()
        ca.reset_launch_counts()
        admm.reset_host_reads()
        with recorded_calls(cr, list(cr.LAUNCHES)) as rc, \
                recorded_calls(ca, list(ca.LAUNCHES)) as ra:
            result = request()
        torch.cuda.synchronize()
        return result, {**cr.LAUNCHES, **ca.LAUNCHES}, {**rc, **ra}

    def solve_phase(name, model, Bb, label):
        server = plt_.ScenarioServer(model, rho=RHO, sigma=SIGMA, device=dev)
        c, x0 = data(model, Bb)
        c_t, x0_t = (torch.as_tensor(x).to(dev) for x in (c, x0))
        request = lambda: server.solve(x0_t, c_t)
        request()                                # builds nothing new; warms up
        torch.cuda.synchronize()
        ws, launches, args = counted(request)
        require(launches == {**zero_counts(), "backward_lanes": 1,
                             "backward_vectors_lanes": 1, "forward_lanes": 1},
                name, launches)
        out[name] = (launches, args, (model.N, model.nx, model.nu, model.nc,
                                      Bb), ())
        if not check:
            return
        require(ws.shape == (Bb, model.N + 1, model.nz), ws.shape)
        require(ws.dtype == torch.float32 and ws.device.type == "cuda")
        require(bool(torch.isfinite(ws).all()), f"{name}: non-finite output")
        # The sequential square-root Riccati solver, float64, on the card.
        m64 = model.to(dtype=torch.float64)
        it64 = plt_.init_iterates(m64, rho=RHO)
        tile = lambda x: x.expand((n_ref,) + x.shape)
        bm = plt_.LQRProblem(**{f.name: tile(getattr(m64, f.name))
                                for f in dataclasses.fields(m64)})
        bm = dataclasses.replace(bm, c=c_t[:n_ref].double())
        bit = plt_.ADMMIterates(**{f.name: tile(getattr(it64, f.name))
                                   for f in dataclasses.fields(it64)})
        ws_ref, _ = sequential.solve_batched(bm, bit, x0_t[:n_ref].double(),
                                             SIGMA)
        err = float((ws[:n_ref].double() - ws_ref).abs().max())
        scale = float(ws_ref.abs().max())
        rel = err / max(1.0, scale)
        t = timed(request, WIDE_TIMED_REQUESTS, Bb)
        emit(name, card=card, model=label, N=model.N, B=Bb, dtype="float32",
             launches=launches, out_shape=list(ws.shape),
             max_abs_err_vs_sequential_f64=err, ref_max_magnitude=scale,
             rel_err=rel, rtol=WIDE_RTOL[name], **t)
        require(rel <= WIDE_RTOL[name], name, rel)

    def admm_phase(name, settings, expect):
        model, cones = centroidal(N=N_CEN, dtype=torch.float32, device=dev)
        cones = tuple(cones)
        server = plt_.ScenarioServer(model, rho=RHO, sigma=SIGMA, device=dev)
        c, x0 = data(model, B_CEN_ADMM)
        c_t, x0_t = (torch.as_tensor(x).to(dev) for x in (c, x0))
        st = admm.ADMMSettings(**settings)
        request = lambda: server.solve_admm(x0_t, cones, st, c=c_t)
        request()
        torch.cuda.synchronize()
        (ws, state, info), launches, args = counted(request)
        reads = dict(admm.HOST_READS)
        require(launches == {**zero_counts(), **expect}, name, launches)
        out[name] = (launches, args, (N_CEN, model.nx, model.nu, model.nc,
                                      B_CEN_ADMM), cones)
        if not check:
            return
        require(ws.shape == (B_CEN_ADMM, N_CEN + 1, model.nz), ws.shape)
        for x in (ws, state.z, state.y, state.rho, info.r_prim):
            require(x.dtype == torch.float32 and x.device.type == "cuda")
        require(bool((info.iterations == ADMM_ITERS).all()))
        # The same request on the kernels' plain versions, float64, CPU.
        cpu = plt_.ScenarioServer(model.to(device="cpu", dtype=torch.float64),
                                  rho=RHO, sigma=SIGMA, device="cpu")
        ref = admm_outputs(*cpu.solve_admm(
            x0[:n_ref].astype(np.float64), cones, st,
            c=c[:n_ref].astype(np.float64)))
        errs = admm_errors(admm_outputs(ws, state, info, n_ref), ref)
        scale = {k: float(v.abs().max()) for k, v in ref.items()}
        rel = {k: e / max(1.0, scale[k]) for k, e in errs.items()}
        t = timed(request, WIDE_TIMED_REQUESTS, B_CEN_ADMM)
        emit(name, card=card, model="centroidal, friction cones", N=N_CEN,
             B=B_CEN_ADMM, dtype="float32", settings=settings,
             launches=launches, host_reads=reads, max_abs_err_vs_plain_f64=errs,
             ref_max_magnitude=scale, rel_err=rel,
             rtol=WIDE_ADMM_RTOL, iterations=ADMM_ITERS,
             iterations_per_s=ADMM_ITERS / (t["request_ms"] * 1e-3),
             r_prim_max=float(info.r_prim.max()),
             r_dual_max=float(info.r_dual.max()), **t)
        require(all(rel[k] <= WIDE_ADMM_RTOL[k] for k in rel), name, rel)

    model = mass_spring_chain(n_masses=20, N=N_MS, dtype=torch.float32,
                              device=dev)
    require((model.nx, model.nu, model.nc) == (40, 10, 0))
    solve_phase("mass_spring_solve", model, B_MS, "mass_spring_chain")
    model, _ = centroidal(N=N_CEN, dtype=torch.float32, device=dev)
    require((model.nx, model.nu, model.nc) == (24, 6, 6))
    solve_phase("centroidal_solve", model, B_CEN, "centroidal")
    admm_phase("centroidal_admm_split", ADMM_SETTINGS,
               {"backward_lanes": 1, "admm_bwd_vec_prefold_lanes": ADMM_ITERS,
                "admm_fwd_update_lanes": ADMM_ITERS})
    admm_phase("centroidal_admm_single", SINGLE_SETTINGS,
               {"admm_iter_lanes": ADMM_ITERS})
    return out


def wide_kernel_specs(ca, cr, requests):
    """The ``kernels`` line's entries of the wide requests' kernels, on the
    tensors of each request's counted run: name -> (counter, phase, call,
    plain, output names, flops, inputs, TPU kernel)."""
    spec = {}
    for phase, (_, args, (N, nx, nu, nc, Bb), cones) in requests.items():
        tag = {"mass_spring_solve": "mass_spring",
               "centroidal_solve": "centroidal",
               "centroidal_admm_split": "centroidal,split",
               "centroidal_admm_single": "centroidal,single"}[phase]
        if "backward_lanes" in args:
            a, kw = args["backward_lanes"]
            spec[f"backward_lanes[{tag}]"] = (
                "backward_lanes", phase,
                lambda a=a, kw=kw: cr.backward_lanes(*a, **kw),
                lambda a=a, kw=kw: cr.backward_lanes_reference(*a, **kw),
                K1_ALL if kw.get("export_factors") else K1_CLOSED,
                k1_flops(N, nx, nu, nc, 1), a, "pallas_riccati.py:778")
        if "backward_vectors_lanes" in args:
            a, kw = args["backward_vectors_lanes"]
            plain_kw = {k: v for k, v in kw.items() if k != "shared"}
            spec[f"backward_vectors_lanes[{tag}]"] = (
                "backward_vectors_lanes", phase,
                lambda a=a, kw=kw: cr.backward_vectors_lanes(*a, **kw),
                lambda a=a, kw=plain_kw: cr.backward_vectors_lanes_reference(
                    *a, **kw),
                K2_OUT, k2_flops(N, nx, nu, Bb),
                a[:4] + (kw["Pc"],) + a[5:],     # P is not read in Pc mode
                "pallas_riccati.py:1023")
        if "forward_lanes" in args:
            a, kw = args["forward_lanes"]
            plain_kw = {k: v for k, v in kw.items() if k != "shared"}
            spec[f"forward_lanes[{tag}]"] = (
                "forward_lanes", phase,
                lambda a=a, kw=kw: cr.forward_lanes(*a, **kw),
                lambda a=a, kw=plain_kw: cr.forward_lanes_reference(*a, **kw),
                K3_OUT, k3_flops(N, nx, nu, Bb), a, "pallas_riccati.py:1201")
        if "admm_bwd_vec_prefold_lanes" in args:
            a, kw = args["admm_bwd_vec_prefold_lanes"]
            spec[f"admm_bwd_vec_prefold_lanes[{tag}]"] = (
                "admm_bwd_vec_prefold_lanes", phase,
                lambda a=a, kw=kw: [ca.admm_bwd_vec_prefold_lanes(*a, **kw)],
                lambda a=a, kw=kw: [ca.admm_bwd_vec_prefold_lanes_reference(
                    *a, **kw)],
                K4_OUT, k2_flops(N, nx, nu, Bb), a, "pallas_admm.py:526")
        if "admm_fwd_update_lanes" in args:
            a, kw = args["admm_fwd_update_lanes"]
            require(kw["alpha"] == ALPHA and kw["sigma"] == SIGMA
                    and len(kw["cones"]) == len(cones))
            k5 = (a[0], a[1], a[2], a[4], a[5], a[6], a[10], a[11], kw["h"])
            spec[f"admm_fwd_update_lanes[{tag}]"] = (
                "admm_fwd_update_lanes", phase,
                lambda k5=k5, c=kw["cones"]: k5_call(ca, k5, c, nu=nu),
                lambda k5=k5, c=kw["cones"]: k5_plain(ca, k5, c, nu=nu),
                K5_OUT,
                k5_flops(N, nx, nu, nc, Bb, ADMM_SETTINGS["diag_cost"]), k5,
                "pallas_admm.py:867")
        if "admm_iter_lanes" in args:
            a, kw = args["admm_iter_lanes"]
            plain_kw = {k: v for k, v in kw.items() if k != "shared"}
            cached = kw["factors"] is not None
            spec[f"admm_iter_lanes[{tag}]"] = (
                "admm_iter_lanes", phase,
                lambda a=a, kw=kw: ca.admm_iter_lanes(*a, **kw),
                lambda a=a, kw=plain_kw: ca.admm_iter_lanes_reference(*a, **kw),
                K8_OUT, k8_flops(N, nx, nu, nc, Bb, cached),
                tuple(x for i, x in enumerate(a) if not (cached and i == 14))
                + tuple(kw["factors"] or ()), "pallas_admm.py:1069")
    return spec


def peak_of(request):
    """A request's peak device memory: the most allocated while it ran,
    and that less what was allocated before it (the tensors earlier phases
    hold)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    request()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return {"peak_memory_bytes": peak, "request_peak_bytes": peak - base}


def narrow_entry(mod, name, counter, phase, launches, call, plain, names,
                 flops, inputs, replaces, reps, tol):
    """A ``kernels`` line entry of a narrow form of a kernel of ``mod``
    (cuda_riccati or cuda_admm), on the tensors of its phase's counted run,
    measured now (the phase frees them after)."""
    out = call()
    ref, plain_ms = event_ms(plain)              # the plain version, once
    abs_err, rel = rel_err(names, out, ref)
    require(max(rel.values()) <= tol, (name, abs_err, rel))
    moved = nbytes(*(x for x in inputs if isinstance(x, torch.Tensor)), *out)
    bound_ms, bound_by = bound(moved, flops)
    return {"name": name, "route": "cuda",
            "source": "pdp_lqr_tpu_torch/ops/csrc/" + mod.SOURCE,
            "replaces": "pdp_lqr_tpu/ops/" + replaces,
            "launches": launches[counter],
            "launches_by_path": {phase: launches[counter]},
            "max_abs_err": abs_err, "rel_err": rel,
            "ms": cuda_ms(call, reps), "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "bytes": moved, "flops": flops}


def small_narrow_check(plt_, cr, model_fn, dev, packed):
    """The float64 narrow solve on the card's kernels against the same on
    the plain versions (CPU): N=64, B=B_SMALL (the model's own data: drift
    0.01 N(0,1), x0 0.1 N(0,1), the iterates' start), each output against
    its largest magnitude."""
    rng = np.random.default_rng(SEED + 4)
    model = model_fn(torch.float64, "cpu")
    c = model.c[None] + torch.as_tensor(
        rng.normal(size=(B_SMALL,) + tuple(model.c.shape)) * 0.01)
    x0 = torch.as_tensor(rng.normal(size=(B_SMALL, model.nx)) * 0.1)
    it = plt_.init_iterates(model, rho=RHO)
    it_b = plt_.ADMMIterates(**{f.name: getattr(it, f.name)[None].expand(
        (B_SMALL,) + getattr(it, f.name).shape) for f in dataclasses.fields(it)})
    solve = cr.solve_packed if packed else cr.solve_lanes
    ref = solve(batched(model, B_SMALL, c), it_b, x0, SIGMA,
                storage_dtype=torch.bfloat16)
    on = lambda t: t.to(dev)
    got = solve(batched(model.to(device=dev), B_SMALL, on(c)),
                plt_.ADMMIterates(**{f.name: on(getattr(it_b, f.name))
                                     for f in dataclasses.fields(it_b)}),
                on(x0), SIGMA, storage_dtype=torch.bfloat16)
    require(got.dtype == torch.float64 and got.device.type == "cuda")
    return float((got.cpu() - ref).abs().max() / ref.abs().max())


# Requests a turn when a narrow request is timed beside its float32 one
# (float32, bfloat16, bfloat16, float32).
NARROW_TURN_REPS = 5
NARROW_REPLACES = {"backward_lanes": "pallas_riccati.py:778",
                   "forward_rollout_lanes": "pallas_riccati.py:1319",
                   "backward_packed": "pallas_riccati.py:1485",
                   "forward_packed": "pallas_riccati.py:1543"}


def narrow_counted(phase, ca, cr, packed, request, dims, reps, tol, label,
                   entries=True):
    """A narrow request counted from zero with the tensors it hands its two
    kernels recorded: (its answer, its launches, and with ``entries`` the
    kernels line's entries of its two kernels on those tensors, measured
    now).  ``dims``: the problem's (N, nx, nu, nc, B)."""
    forms = (("backward_packed", "forward_packed") if packed
             else ("backward_lanes", "forward_rollout_lanes"))
    request()                                    # builds nothing new; warms up
    torch.cuda.synchronize()
    cr.reset_launch_counts()
    ca.reset_launch_counts()
    with recorded_calls(cr, list(forms)) as args:
        ws = request()
    torch.cuda.synchronize()
    launches = {**cr.LAUNCHES, **ca.LAUNCHES}
    require(launches == {**zero_counts(), forms[0] + "[bf16]": 1,
                         forms[1] + "[bf16]": 1}, phase, launches)
    require(ws.dtype == torch.float32 and ws.device.type == "cuda", phase)
    require(bool(torch.isfinite(ws).all()), phase, "non-finite output")
    N, nx, nu, nc, Bb = dims
    out = []
    for form in forms * entries:
        a, kw = args[form]
        gains = form.startswith("backward")
        if form == "backward_packed":
            call = lambda a=a: [cr.backward_packed(*a)]
            plain = lambda a=a: [cr.backward_packed_reference(*a)]
            inputs, names = a[:4], ("G",)
        else:
            call = lambda a=a, kw=kw, f=getattr(cr, form): f(*a, **kw)
            plain = lambda a=a, kw=kw, f=getattr(cr, form + "_reference"): \
                f(*a, **kw)
            inputs = a[:3] if form == "forward_packed" else a
            names = K1_GAINS if gains else K3_OUT
        flops = (k1_flops(N, nx, nu, nc, Bb) if gains
                 else k7_flops(N, nx, nu, Bb))
        out.append(narrow_entry(
            cr, f"{form}[bf16{label}]", form + "[bf16]", phase, launches,
            call, plain, names, flops, inputs, NARROW_REPLACES[form], reps,
            tol))
    return ws, launches, out


def narrow_phase(phase, plt_, ca, cr, card, packed, problem, it, x0, ws_full,
                 model_fn, dev, reps, tol, label, counted=True):
    """A request on bfloat16 stage streams through solve_lanes (K1 gains
    only + K7) or solve_packed (K11 + K12), float32 compute: counted from
    zero (``counted``: with its kernels' ``kernels`` line entries), its
    prepared streams' types, against the full-width request's answer
    (JAX's 2e-2 on the data's quantization), the float64 narrow solve
    against the plain versions, both requests' peak memory and times in
    turns.  Returns (the narrow answer, the entries)."""
    bf16 = torch.bfloat16
    solve = cr.solve_packed if packed else cr.solve_lanes
    prepare = cr.prepare_packed if packed else cr.prepare_lanes
    request = lambda: solve(problem, it, x0, SIGMA, storage_dtype=bf16)
    full_request = lambda: solve(problem, it, x0, SIGMA)
    ws, launches, entries = narrow_counted(
        phase, ca, cr, packed, request,
        (problem.N, problem.nx, problem.nu, problem.nc, x0.shape[0]), reps,
        tol, label, entries=counted)
    require(ws.shape == ws_full.shape, phase, ws.shape)
    # What the kernels were handed: bfloat16 stage streams; the terminal
    # fold and x0 in the compute type.
    n = 2 if packed else 8
    prep = prepare(problem, it, x0, SIGMA, storage_dtype=bf16)
    types = [str(x.dtype).split(".")[-1] for x in prep[:n + 3]]
    require(types == ["bfloat16"] * n + ["float32"] * 3, phase, types)
    stream_bytes = nbytes(*prep[:n])
    del prep
    quant = float((ws - ws_full).abs().max() / ws_full.abs().max())
    require(quant <= BF16_RTOL, phase, quant)
    f64_err = small_narrow_check(plt_, cr, model_fn, dev, packed)
    require(f64_err <= TOL[torch.float64], phase, f64_err)
    mem = {"float32": peak_of(full_request), "bfloat16": peak_of(request)}
    saved = (mem["float32"]["request_peak_bytes"]
             - mem["bfloat16"]["request_peak_bytes"])
    require(saved >= 0.4 * 2 * stream_bytes, phase, saved, stream_bytes)
    t = in_turns({"float32": full_request, "bfloat16": request},
                 NARROW_TURN_REPS)
    Bb = x0.shape[0]
    emit(phase, card=card, model=label.lstrip(",") or "quadrotor constrained",
         N=problem.N, B=Bb, dtype="float32", storage_dtype="bfloat16",
         launches=launches, stream_dtypes=types,
         stream_bytes={"bfloat16": stream_bytes, "float32": 2 * stream_bytes},
         request_ms=t, solves_per_s={k: Bb / (v * 1e-3) for k, v in t.items()},
         kernel_ms={e["name"]: e["ms"] for e in entries},
         kernel_bound_ms={e["name"]: e["bound_ms"] for e in entries},
         memory=mem, memory_saved_bytes=saved,
         memory_saved_share_of_f32_streams=saved / (2 * stream_bytes),
         rel_err_vs_full_width=quant, rtol_vs_full_width=BF16_RTOL,
         f64_rel_err_vs_plain=f64_err, tol_f64=TOL[torch.float64])
    return ws, entries


def centroidal_lanes_bf16(plt_, ca, cr, dev, card):
    """The JAX docstring's configuration for narrow streams: the centroidal
    model at N=1024, B=4096 (bench.py:575-612's data), float32 compute,
    bfloat16 stage streams through solve_lanes (the JAX package's float32
    request runs out of a TPU's memory there): counted, its kernels'
    entries, its peak memory and time beside the float32 request's (or that
    the float32 one ran out of the card's memory); then float32 beside
    bfloat16 at B=2048, the checks of narrow_phase.  Returns the kernels
    line's entries."""
    from pdp_lqr_tpu_torch.models import centroidal
    model, _ = centroidal(N=N_CEN, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(SEED)
    c = model.c[None] + torch.as_tensor(
        rng.normal(size=(B_CEN,) + tuple(model.c.shape)) * C_SCALE_WIDE,
        dtype=torch.float32).to(dev)
    x0 = torch.as_tensor(rng.normal(size=(B_CEN, model.nx)) * 0.1,
                         dtype=torch.float32).to(dev)
    it = plt_.init_iterates(model, rho=RHO)
    its = lambda n: plt_.ADMMIterates(**{
        f.name: getattr(it, f.name)[None].expand(
            (n,) + getattr(it, f.name).shape) for f in dataclasses.fields(it)})
    bf16 = torch.bfloat16
    big = (batched(model, B_CEN, c), its(B_CEN), x0)
    request = lambda: cr.solve_lanes(*big, SIGMA, storage_dtype=bf16)
    ws, launches, entries = narrow_counted(
        "centroidal_lanes_bf16", ca, cr, False, request,
        (N_CEN, model.nx, model.nu, model.nc, B_CEN), WIDE_TIMED_REQUESTS,
        WIDE_KERNEL_RTOL, ",centroidal")
    require(ws.shape == (B_CEN, N_CEN + 1, model.nz), ws.shape)
    del ws
    mem = {"bfloat16": peak_of(request)}
    ms = {"bfloat16": cuda_ms(request, WIDE_TIMED_REQUESTS, warmup=1)}
    full_request = lambda: cr.solve_lanes(*big, SIGMA)
    k1_full_ms = None
    try:
        mem["float32"] = peak_of(full_request)
        ms["float32"] = cuda_ms(full_request, WIDE_TIMED_REQUESTS, warmup=1)
        # K1's full-width form on the float32 request's own tensors, beside
        # its narrow form's entry: the two forms at one shape in one call.
        with recorded_calls(cr, ["backward_lanes"]) as rec:
            full_request()
        a, kw = rec["backward_lanes"]
        k1_full_ms = cuda_ms(lambda: cr.backward_lanes(*a, **kw),
                             WIDE_TIMED_REQUESTS)
        del a, kw, rec
    except torch.cuda.OutOfMemoryError:
        mem["float32"] = ms["float32"] = "out of memory"
        torch.cuda.empty_cache()
    # The eight stage streams' bytes in float32, and what bfloat16 saved of
    # them (at least 40 %, as narrow_phase holds, where float32 fits).
    nx, nu, nc, nz = model.nx, model.nu, model.nc, model.nz
    f32_streams = 4 * N_CEN * B_CEN * (nx * nx + nx * nu + nx + nz * nz + nz
                                       + nc * nz + 2 * nc)
    saved = None
    if isinstance(mem["float32"], dict):
        saved = (mem["float32"]["request_peak_bytes"]
                 - mem["bfloat16"]["request_peak_bytes"])
        require(saved >= 0.4 * f32_streams, "centroidal_lanes_bf16", saved,
                f32_streams)
    emit("centroidal_lanes_bf16", card=card, model="centroidal", N=N_CEN,
         B=B_CEN, dtype="float32", storage_dtype="bfloat16", launches=launches,
         request_ms=ms, solves_per_s=B_CEN / (ms["bfloat16"] * 1e-3),
         kernel_ms={e["name"]: e["ms"] for e in entries},
         kernel_bound_ms={e["name"]: e["bound_ms"] for e in entries},
         kernel_ms_full_width={"backward_lanes": k1_full_ms},
         memory=mem, card_memory_bytes=torch.cuda.get_device_properties(
             0).total_memory, stream_bytes={"float32": f32_streams,
                                            "bfloat16": f32_streams // 2},
         memory_saved_bytes=saved)
    del request, full_request, big
    Bh = B_CEN_ADMM
    half = (batched(model, Bh, c[:Bh].contiguous()), its(Bh),
            x0[:Bh].contiguous())
    ws_full = cr.solve_lanes(*half, SIGMA)
    cen = lambda dt, device: centroidal(N=N_SMALL, dtype=dt, device=device)[0]
    narrow_phase("centroidal_lanes_bf16_B2048", plt_, ca, cr, card, False,
                 *half, ws_full, cen, dev, WIDE_TIMED_REQUESTS,
                 WIDE_KERNEL_RTOL, ",centroidal", counted=False)
    return entries


def wrapper_dtypes(args):
    """The floating dtypes of the tensors each recorded wrapper call was
    handed, by wrapper name."""
    return {name: sorted({str(x.dtype).split(".")[-1]
                          for x in list(a) + list(kw.values())
                          if isinstance(x, torch.Tensor)
                          and x.is_floating_point()})
            for name, (a, kw) in args.items()}


def factor_steps(got, ref):
    """How two sets of bfloat16 factors (AK, BL, MK) differ: the share of
    entries that differ and the largest difference over each stream's
    largest magnitude."""
    out = {}
    for name, a, b in zip(("AK", "BL", "MK"), got, ref):
        a, b = a.float().cpu(), b.float().cpu()
        out[name] = {"share_differing": float((a != b).float().mean()),
                     "max_rel": float((a - b).abs().max() / b.abs().max())}
    return out


def admm_bf16_phases(plt_, admm, ca, cr, card, model, c_t, x0_t, c_np, x0_np,
                     n_ref, settings, st_lad, ladder_state, full_requests,
                     k8_bf16):
    """``admm_split_bf16`` and ``admm_ladder_bf16``: admm_path's and
    admm_ladder's requests (quadrotor N=512, B=4096, float32 compute) with
    ``storage_dtype=bfloat16`` through the narrow forms of K4, K5 and K6,
    each counted from zero with the tensors it hands its kernels recorded,
    those tensors' types, its kernels' entries of the ``kernels`` line,
    held against the plain versions in float64, and beside its float32
    request: the difference (reported, not gated), peak memory and times
    in turns; the split one also beside K8's cached bfloat16 request (the
    ``auto`` rule).  Returns the entries."""
    bf16 = torch.bfloat16
    model_c = dataclasses.replace(model, c=c_t)
    cpu = model.to(device="cpu", dtype=torch.float64)
    cpu_c = dataclasses.replace(cpu, c=torch.as_tensor(c_np[:n_ref]).double())
    x0_ref = x0_np[:n_ref].astype(np.float64)
    Bb = x0_t.shape[0]
    K4, K5, K6 = ("admm_bwd_vec_prefold_lanes", "admm_fwd_update_lanes",
                  "admm_bwd_vec_lanes")
    # The ladder's start state made once, as its float32 request's is.
    lad_state = ladder_state(Bb, torch.float32, x0_t.device)
    requests = {
        "admm_split_bf16": lambda: plt_.solve_fused(
            model_c, x0_t, (), settings, single_kernel=False,
            storage_dtype=bf16),
        "admm_ladder_bf16": lambda: plt_.solve_fused(
            model_c, x0_t, (), st_lad, state=lad_state, single_kernel=False,
            storage_dtype=bf16)}
    entries = []
    for phase, request in requests.items():
        split = phase == "admm_split_bf16"
        forms = (K4, K5) if split else (K6, K5)
        request()                                # builds nothing new; warms up
        torch.cuda.synchronize()
        cr.reset_launch_counts()
        ca.reset_launch_counts()
        admm.reset_host_reads()
        with recorded_calls(ca, list(forms)) as args:
            out = request()
        torch.cuda.synchronize()
        launches = {**cr.LAUNCHES, **ca.LAUNCHES}
        host_reads = dict(admm.HOST_READS)
        require(launches == {**zero_counts(), "backward_lanes": 1,
                             forms[0] + "[bf16]": ADMM_ITERS,
                             forms[1] + "[bf16]": ADMM_ITERS}, phase, launches)
        ws, state, info = out
        require(ws.shape == (Bb, N_MAIN + 1, NX + NU), phase, ws.shape)
        for x in (ws, state.w, state.z, state.y, state.rho, info.r_prim):
            require(x.dtype == torch.float32 and x.device.type == "cuda", phase)
        require(bool(torch.isfinite(ws).all()), phase, "non-finite output")
        # What reached the kernels: the narrow sets in bfloat16, the rest
        # (iterates, bounds, rho, the pre-folded P c) in float32.
        types = wrapper_dtypes(args)
        require(all(t == ["bfloat16", "float32"] for t in types.values()),
                phase, types)
        # (K5's M or MK, K, Hs, D; its h by keyword.)
        narrow_pos = {K4: K4_NARROW, K6: K6_NARROW, K5: (2, 3, 4, 5)}
        for form in forms:
            a, kw = args[form]
            for i in narrow_pos[form]:
                require(a[i] is None or a[i].dtype == bf16, phase, form, i)
            require(kw.get("h") is None or kw["h"].dtype == bf16, phase)
        # Against the plain versions in float64.  The split request: on the
        # first scenarios from zero iterates and its own bfloat16 factors
        # (no refactor within 20 iterations), so both read the same
        # rounded factors: admm_path's limit.  The ladder has no factor
        # state: the same narrow request in float64 on the card's kernels,
        # first scenarios, against the plain versions (both build the
        # factors in float64: the same rounded factors).
        if split:
            f = state.factors
            require([x.dtype for x in f] == [bf16] * 3 + [torch.float32] * 2,
                    phase, [x.dtype for x in f])
            rho_f = f[4][:n_ref].double().cpu()
            own = admm.ADMMState(**{
                k: torch.zeros((n_ref,) + tuple(getattr(state, k).shape[1:]),
                               dtype=torch.float64) for k in ("w", "z", "y")},
                rho=rho_f.clone(), factors=(
                    f[0].cpu(), f[1].cpu(), f[2].cpu(),
                    f[3][..., :n_ref].double().cpu(), rho_f))
            ref = admm_outputs(*plt_.solve_fused(
                cpu_c, x0_ref, (), settings, state=own, single_kernel=False,
                storage_dtype=bf16))
            errs = admm_errors(admm_outputs(ws, state, info, n_ref), ref)
            atol = ADMM_PATH_ATOL
            cold = plt_.solve_fused(cpu_c, x0_ref, (), settings,
                                    single_kernel=False, storage_dtype=bf16)
            cold_f32_f64 = {
                "max_abs_err": admm_errors(admm_outputs(ws, state, info,
                                                        n_ref),
                                           admm_outputs(*cold)),
                "factors_vs_f64_build": factor_steps(f, cold[1].factors)}
        else:
            dev = x0_t.device
            got = plt_.solve_fused(
                cpu_c.to(device=dev), torch.as_tensor(x0_ref).to(dev), (),
                st_lad, state=ladder_state(n_ref, torch.float64, dev),
                single_kernel=False, storage_dtype=bf16)
            ref = admm_outputs(*plt_.solve_fused(
                cpu_c, x0_ref, (), st_lad,
                state=ladder_state(n_ref, torch.float64, "cpu"),
                single_kernel=False, storage_dtype=bf16))
            errs = admm_errors(admm_outputs(*got), ref)
            atol = SINGLE_CROSS_ATOL
            cold_f32_f64 = {"max_abs_err": admm_errors(
                admm_outputs(ws, state, info, n_ref), ref)}
        require(max(errs.values()) <= atol, phase, errs)
        # Beside the float32 request: the rounding's effect (reported),
        # peak memory, times in turns.
        full = admm_outputs(*full_requests[phase]())
        narrow = admm_outputs(ws, state, info)
        vs_full = {k: float((narrow[k] - full[k]).abs().max()
                            / max(1e-30, float(full[k].abs().max())))
                   for k in full}
        del out, ws, state, info, narrow, full
        mem = {"float32": peak_of(full_requests[phase]),
               "bfloat16": peak_of(request)}
        turns = {"float32": full_requests[phase], "bfloat16": request}
        if split:
            turns["k8_cached_bfloat16"] = k8_bf16
        t = in_turns(turns, NARROW_TURN_REPS)
        # The kernels line's entries, on the counted run's tensors.
        ph = []
        for form in forms:
            a, kw = args[form]
            if form == K5:
                k5_in = (a[0], a[1], a[2], a[4], a[5], a[6], a[10], a[11],
                         kw.get("h"))
                call = lambda a=a, kw=kw: ca.admm_fwd_update_lanes(*a, **kw)
                plain = lambda k5_in=k5_in, a=a, kw=kw: k5_plain(
                    ca, k5_in, kw["cones"], K=a[3], rung=kw.get("rung"))
                names = K5_OUT if split else K5_RUNG_OUT
                flops = k5_flops(N_MAIN, NX, NU, NC, Bb, True, emit_hf=split)
                inputs = k5_in + (a[3], kw.get("rung"))
                name = f"{K5}[bf16]" if split else f"{K5}[bf16,rung]"
                replaces = "pallas_admm.py:867"
            else:
                fn, ref_fn = getattr(ca, form), getattr(ca, form + "_reference")
                call = lambda a=a, kw=kw, fn=fn: [fn(*a, **kw)]
                plain = lambda a=a, kw=kw, fn=ref_fn: [fn(*a, **kw)]
                names = K4_OUT
                flops = (k2_flops(N_MAIN, NX, NU, Bb) if split
                         else k6_flops(N_MAIN, NX, NU, NC, Bb))
                inputs = a + ((kw.get("rung"),) if not split else ())
                name = f"{form}[bf16]"
                replaces = "pallas_admm.py:526" if split else "pallas_admm.py:766"
            ph.append(narrow_entry(ca, name, form + "[bf16]", phase, launches,
                                   call, plain, names, flops, inputs,
                                   replaces, TIMED_REQUESTS,
                                   TOL[torch.float32]))
        entries += ph
        emit(phase, card=card, model="quadrotor constrained", N=N_MAIN, B=Bb,
             dtype="float32", storage_dtype="bfloat16",
             settings=ADMM_SETTINGS if split else LADDER_SETTINGS,
             launches=launches, host_reads=host_reads, wrapper_dtypes=types,
             max_abs_err_vs_plain_f64=errs, atol=atol,
             f64_reference=("the request's first scenarios from its own "
                            "bfloat16 factors" if split else
                            "the float64 request on the card's kernels, "
                            "first scenarios"),
             f32_request_vs_cold_plain_f64=cold_f32_f64,
             rel_diff_vs_float32_request=vs_full,
             request_ms=t, solves_per_s={k: Bb / (v * 1e-3)
                                         for k, v in t.items()},
             kernel_ms={e["name"]: e["ms"] for e in ph},
             kernel_bound_ms={e["name"]: e["bound_ms"] for e in ph},
             memory=mem, memory_added_bytes=(
                 mem["bfloat16"]["request_peak_bytes"]
                 - mem["float32"]["request_peak_bytes"]))
        del args
    return entries


def reference_api(plt_, admm, sequential, dev, card):
    """The reference-shaped solvers on the card (quadrotor N=N_API, float64,
    a batched model of B=64): the four classes through the lifecycle, held
    against each other and the sequential witness, each step timed; then
    ``admm.solve_batched`` on each of the five backends with the thrust
    cone and its shift, against the same call on the CPU."""
    from pdp_lqr_tpu_torch.models import quadrotor
    dt = torch.float64
    model, cones = quadrotor(N=N_API, constrained=True, thrust_cone=True,
                             dtype=dt, device=dev)
    cones = tuple(cones)
    rng = np.random.default_rng(SEED)
    c = torch.as_tensor(rng.normal(size=(B_API, N_API, NX)) * 0.01).to(dev, dt)
    bp = batched(model, B_API, c)
    it = plt_.init_iterates(model, rho=RHO)
    tile = lambda x: x.expand((B_API,) + x.shape)
    w2 = torch.as_tensor(rng.normal(size=(B_API,) + tuple(it.w.shape))
                         * 0.1).to(dev, dt)
    vecs = (tile(it.w), tile(it.y), tile(it.z), tile(it.rho))
    vecs2 = (w2,) + vecs[1:]
    x0 = torch.as_tensor(0.03 + 0.01 * rng.normal(size=(B_API, NX))).to(dev, dt)

    # The witness: the sequential solver's functions on the same data.
    ref1, _ = sequential.solve_batched(bp, plt_.ADMMIterates(*vecs), x0, SIGMA)
    ref2, _ = sequential.solve_batched(bp, plt_.ADMMIterates(*vecs2), x0,
                                       SIGMA)
    classes = {
        "LQRSolver": lambda: plt_.LQRSolver(bp, device=dev),
        "LQRParallelSolver": lambda: plt_.LQRParallelSolver(
            bp, num_segments=S_API, device=dev),
        "QDLDLSolver": lambda: plt_.QDLDLSolver(bp, device=dev),
        "AssociativeScanSolver": lambda: plt_.AssociativeScanSolver(
            bp, device=dev),
    }
    lifecycle, outs = {}, {}
    for name, make in classes.items():
        s = make()
        steps = {
            "update_problem_data": lambda: s.update_problem_data(*vecs, SIGMA),
            "backward": s.backward,
            "forward": lambda: s.forward(x0),
            "update_problem_data_2": lambda: s.update_problem_data(*vecs2,
                                                                   SIGMA),
            "backward_without_factorization": s.backward_without_factorization,
            "forward_2": lambda: s.forward(x0),
        }
        times, got = {}, {}
        for step, call in steps.items():
            got[step] = call()
            times[step + "_ms"] = cuda_ms(call, 3, warmup=1)
        ws1, ws2 = got["forward"], got["forward_2"]
        require(ws1.shape == (B_API, N_API + 1, NX + NU) and ws1.device.type
                == "cuda" and bool(torch.isfinite(ws2).all()), name)
        s.clear_workspace()
        try:
            s.forward(x0)
            require(False, name, "forward ran on a cleared workspace")
        except RuntimeError:
            pass
        errs = {"vs_sequential": max(float((ws1 - ref1).abs().max()),
                                     float((ws2 - ref2).abs().max()))}
        outs[name] = (ws1, ws2)
        lifecycle[name] = {**times, **errs}
    for name, (ws1, ws2) in outs.items():
        lifecycle[name]["vs_classes"] = max(
            max(float((ws1 - o1).abs().max()), float((ws2 - o2).abs().max()))
            for other, (o1, o2) in outs.items()
            if other != name and other != "QDLDLSolver")
    for name, row in lifecycle.items():
        lim = API_KKT_ATOL if name == "QDLDLSolver" else API_ATOL
        require(row["vs_sequential"] <= lim, name, row)

    # admm.solve_batched on each backend, card against CPU.
    shift = torch.zeros((N_API + 1, NC_CONE), dtype=dt, device=dev)
    shift[:, NC] = THRUST_SHIFT
    cpu = lambda x: x.to(device="cpu")
    bp_cpu = plt_.LQRProblem(**{f.name: cpu(getattr(bp, f.name))
                                for f in dataclasses.fields(bp)})
    solves = {}
    for backend in ("seq", "assoc", "dense", "kkt", "pdp"):
        st = admm.ADMMSettings(**API_ADMM_SETTINGS, backend=backend)
        call = lambda st=st: admm.solve_batched(bp, x0, cones, st,
                                                soc_shift=shift)
        got = admm_outputs(*call())
        ms = cuda_ms(call, 1, warmup=0)
        ref = admm_outputs(*admm.solve_batched(bp_cpu, cpu(x0), cones, st,
                                               soc_shift=cpu(shift)))
        errs = admm_errors(got, ref)
        solves[backend] = {"request_ms": ms, "max_abs_err_vs_cpu": errs,
                           "r_prim_max": float(got["r_prim"].max())}
        require(max(errs.values()) <= API_ADMM_ATOL, backend, errs)
    emit("reference_api", card=card, model="quadrotor constrained + thrust "
         "cone, batched", N=N_API, B=B_API, dtype="float64",
         segments=S_API, lifecycle=lifecycle,
         atol={"classes": API_ATOL, "kkt": API_KKT_ATOL,
               "admm_vs_cpu": API_ADMM_ATOL},
         admm_settings=API_ADMM_SETTINGS, admm_solve_batched=solves)


def event_ms(fn):
    """(fn(), its time in ms by CUDA events on the current stream)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def no_kernel_launches():
    """Kernel launch counts since the last reset: every one must be 0 on
    the torch-ops paths (the realtime operators, the MPC loops)."""
    from pdp_lqr_tpu_torch.ops import cuda_admm as ca, cuda_riccati as cr
    counts = {**cr.LAUNCHES, **ca.LAUNCHES}
    require(not any(counts.values()), counts)
    return counts


def reset_kernel_counts():
    from pdp_lqr_tpu_torch.ops import cuda_admm as ca, cuda_riccati as cr
    cr.reset_launch_counts()
    ca.reset_launch_counts()


def tick_stats(times, iters, reads):
    t = np.asarray(times)
    return {"ticks": len(times), "p50_ms": float(np.percentile(t, 50)),
            "p99_ms": float(np.percentile(t, 99)), "mean_ms": float(t.mean()),
            "max_ms": float(t.max()),
            "within_budget_share": float((t <= RT_BUDGET_MS).mean()),
            "iterations_p50": float(np.median(iters)),
            "iterations_max": int(max(iters)),
            "host_reads_per_tick_p50": float(np.median(reads))}


def warm_ticks(tick, problem, x, ws, state, n, admm, mpc):
    """``n`` ticks of a closed loop on the stage-0 plant after a replan
    (ws, state) at x: apply u0, step, shift the warm state, replan.
    ``tick(x, state) -> (ws, state, info, ...)``.  Each tick timed by CUDA
    events; returns (stats, per-tick extras, last x)."""
    A0, B0, c0 = problem.A[0], problem.B[0], problem.c[0]
    times, iters, reads, extras = [], [], [], []
    for _ in range(n):
        x = A0 @ x + B0 @ ws[0, :problem.nu] + c0
        state = mpc.shift_state(state, problem)
        admm.reset_host_reads()
        out, ms = event_ms(lambda: tick(x, state))
        ws, state, info = out[:3]
        times.append(ms)
        iters.append(int(info.iterations))
        reads.append(sum(admm.HOST_READS.values()))
        extras.append(out[3:])
    require(bool(torch.isfinite(ws).all()), "closed loop: non-finite")
    return tick_stats(times, iters, reads), extras, x


def per_iteration(admm, realtime, problem, x, op, cones):
    """latency_mpc's delta method on both forms of a replan: medians of
    RT_DELTA_K- and 2 RT_DELTA_K-iteration replans (no early exit) by
    ``realtime.solve`` (eager: every operation a launch) and by
    ``realtime.replan_fn`` (a CUDA graph an iteration).  Returns
    {form: {"us_per_iteration", "fixed_ms"}}."""
    out = {}
    for form in ("eager", "graph"):
        t = {}
        for k in (RT_DELTA_K, 2 * RT_DELTA_K):
            st = fixed_settings(admm, RT_SETTINGS, k)
            if form == "eager":
                call = lambda st=st: realtime.solve(problem, x, op, cones, st)
            else:
                call = lambda fn=realtime.replan_fn(problem, op, cones, st): \
                    fn(x, None)
            t[k] = cuda_ms(call, 5)
        per = (t[2 * RT_DELTA_K] - t[RT_DELTA_K]) / RT_DELTA_K
        out[form] = {"us_per_iteration": per * 1e3,
                     "fixed_ms": t[RT_DELTA_K] - per * RT_DELTA_K}
    return out


def fixed_settings(admm, base, iters):
    """``base`` with no early exit: exactly ``iters`` iterations."""
    return admm.ADMMSettings(**{**base, "eps_abs": 0.0, "eps_rel": 0.0,
                                "max_iter": iters,
                                "rho_update_interval": iters})


def rel_diff(a, ref):
    return float((a.double() - ref.double()).abs().max()) / float(
        ref.double().abs().max())


def realtime_dense(admm, mpc, realtime, dev, card):
    """The 1 kHz replan path on the quadrotor's dense map (N=RT_N)."""
    from pdp_lqr_tpu_torch.models import quadrotor
    f32, f64 = torch.float32, torch.float64
    st = admm.ADMMSettings(**RT_SETTINGS)
    model, _ = quadrotor(N=RT_N, constrained=True, dtype=f32, device=dev)
    m64 = model.to(dtype=f64)
    M = (RT_N + 1) * (NX + NU)
    reset_kernel_counts()
    op = realtime.build_operator(model, st.rho, st)
    require(op.T.shape == (M, M) and op.T.dtype == f32, op.T.shape)
    build_ms = cuda_ms(lambda: realtime.build_operator(model, st.rho, st), 3,
                       warmup=0)
    fn = realtime.replan_fn(model, op, (), st)
    x = torch.full((NX,), RT_X0, dtype=f32, device=dev)
    t0 = time.perf_counter()
    fn(x, admm.init_state(model, st))           # captures the graph
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    admm.reset_host_reads()
    (ws, state, info), cold_ms = event_ms(
        lambda: fn(x, admm.init_state(model, st)))
    cold = {"ms": cold_ms, "iterations": int(info.iterations),
            "host_reads": sum(admm.HOST_READS.values()),
            "converged": bool(info.converged), "first_call_s": capture_s}
    require(cold["converged"], "realtime_dense: cold replan", cold)
    # The graph replays the eager iteration: the same count and iterates.
    ws_e, _, info_e = realtime.solve(model, x, op, (), st)
    graph_err = rel_diff(ws, ws_e)
    require(int(info_e.iterations) == cold["iterations"]
            and graph_err <= RT_GRAPH_RTOL, "realtime_dense graph",
            graph_err, int(info_e.iterations))
    ticks, _, _ = warm_ticks(fn, model, x, ws, state, RT_TICKS, admm, mpc)
    delta = per_iteration(admm, realtime, model, x, op, ())
    op_bytes = nbytes(op.T)
    launches = no_kernel_launches()

    # float32 against float64: the cold replan's iterations, both maps.
    op64 = realtime.build_operator(m64, st.rho, st)
    x64 = x.double()
    ws64, _, _ = realtime.solve(m64, x64, op64, (), fixed_settings(
        admm, RT_SETTINGS, cold["iterations"]))
    f32_err = rel_diff(ws, ws64)
    # float64 against admm.solve (sequential inner solver, one chunk: rho
    # fixed): it converges on the same iteration with the same iterates.
    ws64c, st64c, info64c = realtime.solve(m64, x64, op64, (), st)
    k64 = int(info64c.iterations)
    wsA, stA, infoA = admm.solve(m64, x64, (), admm.ADMMSettings(**{
        **RT_SETTINGS, "max_iter": k64, "rho_update_interval": k64,
        "backend": "seq"}))
    admm_err = max(float((wsA - ws64c).abs().max()),
                   float((stA.y - st64c.y).abs().max()))
    counts = {"realtime": k64, "admm_solve_iter_converged":
              int(infoA.iter_converged)}
    # The condensed map (S = RT_S_CHECK) against the dense one, float64.
    cop64 = realtime.build_condensed_operator(m64, st.rho, RT_S_CHECK, st)
    rng = np.random.default_rng(SEED)
    hf = torch.as_tensor(rng.normal(size=M) * 0.3, device=dev)
    xr = torch.as_tensor(rng.normal(size=NX) * 0.2, device=dev)
    cond_err = rel_diff(cop64.apply_flat(hf, cop64.prepare(xr)),
                        op64.apply_flat(hf, op64.prepare(xr)))
    wsC, _, infoC = realtime.solve(m64, x64, cop64, (), st)
    cond_solve_err = float((wsC - ws64c).abs().max())
    # bfloat16 storage against float32: the JAX suite's case (the
    # quadrotor's map, converged replans at serving tolerances).
    sb = admm.ADMMSettings(**BF16_SETTINGS)
    ws_a, _, info_a = realtime.solve(model, x, op, (), sb)
    ws_b, _, info_b = realtime.solve(
        model, x, realtime.cast_operator(op, torch.bfloat16), (), sb)
    bf16_err = rel_diff(ws_b, ws_a)
    checks = {"graph_vs_eager_rel": graph_err,
              "f32_vs_f64_rel": f32_err, "f64_vs_admm_solve": admm_err,
              "iterations": counts, "condensed_vs_dense_map_rel": cond_err,
              "condensed_vs_dense_replan": cond_solve_err,
              "condensed_iterations": int(infoC.iterations),
              "bf16_vs_f32_replan_rel": bf16_err,
              "bf16_iterations": [int(info_a.iterations),
                                  int(info_b.iterations)]}
    require(f32_err <= RT_F32_RTOL, "realtime_dense f32", checks)
    require(bool(info64c.converged) and bool(infoA.converged)
            and counts["admm_solve_iter_converged"] == k64
            and admm_err <= RT_ADMM_ATOL, "realtime_dense vs admm", checks)
    require(cond_err <= RT_COND_RTOL and cond_solve_err <= RT_COND_SOLVE_ATOL
            and int(infoC.iterations) == k64, "realtime_dense condensed",
            checks)
    require(bool(info_a.converged) and bool(info_b.converged)
            and bf16_err <= BF16_RTOL, "realtime_dense bf16", checks)
    emit("realtime_dense", card=card, model="quadrotor constrained", N=RT_N,
         B=1, dtype="float32", M=M, settings=RT_SETTINGS, x0=RT_X0,
         operator_bytes=op_bytes, build_ms=build_ms, cold_replan=cold,
         warm_ticks=ticks, budget_ms=RT_BUDGET_MS,
         delta={"K": RT_DELTA_K, **delta,
                "bound_us_per_iteration": bound(op_bytes, 0)[0] * 1e3},
         checks=checks, tolerances={
             "graph_vs_eager_rel": RT_GRAPH_RTOL,
             "f32_vs_f64_rel": RT_F32_RTOL, "f64_vs_admm_solve": RT_ADMM_ATOL,
             "condensed_map_rel": RT_COND_RTOL,
             "condensed_replan": RT_COND_SOLVE_ATOL,
             "bf16_vs_f32_replan_rel": BF16_RTOL},
         launches=launches)


def latency_segments(problem):
    """examples/latency_mpc.py's automatic S: the largest divisor of N
    (from 2) at most sqrt(M / 2 nx)."""
    N = problem.N
    M = (N + 1) * problem.nz
    target = max(2, int(round((M / (2 * problem.nx)) ** 0.5)))
    return max(s for s in range(2, N + 1) if N % s == 0 and s <= target)


def realtime_condensed(admm, mpc, realtime, dev, card):
    """The long-horizon replan on the centroidal model's condensed map:
    float32, bfloat16 storage, a four-rung ladder."""
    from pdp_lqr_tpu_torch.models import centroidal
    f32 = torch.float32
    st = admm.ADMMSettings(**RT_SETTINGS)
    model, cones = centroidal(N=N_CEN, dtype=f32, device=dev)
    cones = tuple(cones)
    S = latency_segments(model)
    build = lambda m, rho: realtime.build_condensed_operator(m, rho, S, st,
                                                            cones)
    reset_kernel_counts()
    t0 = time.perf_counter()
    op = build(model, st.rho)
    torch.cuda.synchronize()
    first_build_s = time.perf_counter() - t0
    build_ms = cuda_ms(lambda: build(model, st.rho), 1, warmup=0)
    op_bytes = {f.name: nbytes(getattr(op, f.name))
                for f in dataclasses.fields(op)}
    op16 = realtime.cast_operator(op, torch.bfloat16)
    x = torch.zeros(model.nx, dtype=f32, device=dev)   # latency_mpc's
    delta = {}
    for name, o in (("float32", op), ("bfloat16", op16)):
        streamed = sum(nbytes(getattr(o, f)) for f in ("U", "X", "Z", "E_x",
                                                       "E_p"))
        delta[name] = {**per_iteration(admm, realtime, model, x, o, cones),
                       "streamed_bytes": streamed,
                       "bound_us_per_iteration": bound(streamed, 0)[0] * 1e3}
    # float32 against float64 of the same operator: RT_DELTA_K iterations.
    m64 = model.to(dtype=torch.float64)
    op64 = build(m64, st.rho)
    fixed = fixed_settings(admm, RT_SETTINGS, RT_DELTA_K)
    ws32, _, _ = realtime.solve(model, x, op, cones, fixed)
    ws64, _, _ = realtime.solve(m64, x.double(), op64, cones, fixed)
    f32_err = rel_diff(ws32, ws64)
    del op64
    # The ladder: R rungs built one after the other, then RT_TICKS ticks
    # of a closed loop from the rung at rho = 1.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ladder = realtime.build_ladder(model, CEN_LADDER, st, cones,
                                   num_segments=S)
    torch.cuda.synchronize()
    ladder_build_s = time.perf_counter() - t0
    fn = realtime.replan_ladder_fn(model, ladder, cones, st)
    idx0 = CEN_LADDER.index(st.rho)
    admm.reset_host_reads()
    (ws, state, info, idx), cold_ms = event_ms(
        lambda: fn(x, admm.init_state(model, st), idx0))
    picks, idx_ = [idx], [idx]

    def tick(x_, s_):
        out = fn(x_, s_, idx_[0])
        idx_[0] = out[3]
        picks.append(out[3])
        return out

    ticks, _, _ = warm_ticks(tick, model, x, ws, state, RT_TICKS, admm, mpc)
    # bfloat16 against float32 storage on the lowest rung's map (where
    # this model's replan converges): the map on a random hf, then
    # converged replans.
    lo = ladder.select(0)
    lo16 = realtime.cast_operator(lo, torch.bfloat16)
    rng = np.random.default_rng(SEED)
    hf = torch.as_tensor(rng.normal(size=(N_CEN + 1) * model.nz) * 0.3,
                         dtype=f32, device=dev)
    w16 = lo16.apply_flat(hf, lo16.prepare(x))
    # The bfloat16 map's products are float32 products of the rounded map
    # (the JAX package's semantics): the same as on its float32 copy.
    wide = realtime.cast_operator(lo16, f32)
    semantics_err = rel_diff(w16, wide.apply_flat(hf, wide.prepare(x)))
    map_err = rel_diff(w16, lo.apply_flat(hf, lo.prepare(x)))
    sb = admm.ADMMSettings(**CEN_BF16_SETTINGS)
    ws_a, _, info_a = realtime.solve(model, x, lo, cones, sb)
    ws_b, _, info_b = realtime.solve(model, x, lo16, cones, sb)
    bf16_err = rel_diff(ws_b, ws_a)
    launches = no_kernel_launches()
    checks = {"f32_vs_f64_rel": f32_err,
              "bf16_vs_widened_copy_rel": semantics_err,
              "bf16_vs_f32_map_rel": map_err,
              "bf16_vs_f32_replan_rel": bf16_err,
              "converged_f32_bf16": [bool(info_a.converged),
                                     bool(info_b.converged)],
              "iterations_f32_bf16": [int(info_a.iterations),
                                      int(info_b.iterations)]}
    require(f32_err <= CEN_F32_RTOL, "realtime_condensed f32", checks)
    require(semantics_err <= CEN_BF16_SEMANTICS_RTOL
            and bool(info_a.converged) and bool(info_b.converged)
            and bool(torch.isfinite(ws_b).all()),
            "realtime_condensed bf16", checks)
    emit("realtime_condensed", card=card, model="centroidal (config #5), "
         "two friction cones", N=N_CEN, nx=model.nx, nu=model.nu, S=S, B=1,
         settings=RT_SETTINGS, operator_bytes=op_bytes,
         first_build_s=first_build_s, build_ms=build_ms, delta=delta,
         checks=checks, bf16_settings=CEN_BF16_SETTINGS,
         tolerances={"f32_vs_f64_rel": CEN_F32_RTOL,
                     "bf16_vs_widened_copy_rel": CEN_BF16_SEMANTICS_RTOL},
         ladder={"rhos": CEN_LADDER, "build_s": ladder_build_s,
                 "build_ms_per_rung": ladder_build_s * 1e3 / len(CEN_LADDER),
                 "cold_tick_ms": cold_ms, "warm_ticks": ticks,
                 "rung_picked": picks},
         budget_ms=RT_BUDGET_MS, launches=launches)


def scenario_batch(admm, realtime, dev, card):
    """Operator-mode scenario batch: one (B, M) @ (M, M) product an
    iteration for B_SB scenarios of the quadrotor sharing (A, B, H, D)."""
    from pdp_lqr_tpu_torch.models import quadrotor
    f32, f64 = torch.float32, torch.float64
    st = admm.ADMMSettings(**SB_SETTINGS)
    model, _ = quadrotor(N=RT_N, constrained=True, dtype=f32, device=dev)
    rng = np.random.default_rng(SEED)
    c = model.c[None] + torch.as_tensor(
        rng.normal(size=(B_SB, RT_N, NX)) * 0.002, dtype=f32, device=dev)
    x0 = torch.as_tensor(rng.normal(size=(B_SB, NX)) * 0.1, dtype=f32,
                         device=dev)
    bp = batched(model, B_SB, c)
    reset_kernel_counts()
    op = realtime.build_batch_operator(model, st.rho, st)
    build_ms = cuda_ms(lambda: realtime.build_batch_operator(
        model, st.rho, st), 3, warmup=0)
    request = lambda: realtime.solve_batch(bp, x0, op, (), st)
    ws, state, info = request()
    require(ws.shape == (B_SB, RT_N + 1, NX + NU)
            and bool(torch.isfinite(ws).all()), "scenario_batch output")
    t = timed(request, 5, B_SB)
    launches = no_kernel_launches()
    # float64 at N=16 against solve_fused (K8) on the same batch.
    m16, _ = quadrotor(N=N_SB_CHECK, constrained=True, dtype=f64, device=dev)
    sc = admm.ADMMSettings(**SB_CHECK_SETTINGS)
    c16 = m16.c[None] + torch.as_tensor(
        rng.normal(size=(B_SB_CHECK, N_SB_CHECK, NX)) * 0.02, device=dev)
    x16 = torch.as_tensor(rng.normal(size=(B_SB_CHECK, NX)) * 0.05,
                          device=dev)
    bp16 = batched(m16, B_SB_CHECK, c16)
    op16 = realtime.build_batch_operator(m16, sc.rho, sc)
    ws_o, st_o, info_o = realtime.solve_batch(bp16, x16, op16, (), sc)
    from pdp_lqr_tpu_torch.ops import cuda_admm as ca, cuda_riccati as cr
    reset_kernel_counts()
    ws_f, st_f, info_f = admm.solve_fused(bp16, x16, (), sc)
    check_launches = {k: v for k, v in {**cr.LAUNCHES, **ca.LAUNCHES}.items()
                      if v}
    errs = {"ws": float((ws_o - ws_f).abs().max()),
            "y": float((st_o.y - st_f.y).abs().max()),
            "r_prim_rel": rel_diff(info_o.r_prim, info_f.r_prim)}
    require(max(errs.values()) <= SB_ATOL, "scenario_batch vs solve_fused",
            errs)
    emit("scenario_batch", card=card, model="quadrotor constrained, shared "
         "(A, B, H, D), a c and x0 a scenario", N=RT_N, B=B_SB,
         dtype="float32", iterations=SB_SETTINGS["max_iter"],
         settings=SB_SETTINGS, build_ms=build_ms, **t,
         converged_share=float(info.converged.float().mean()),
         operator_bytes=nbytes(op.T, op.Tc, op.J),
         # The product of an iteration: T, the batch's hf in, w~ out.
         product_bound_ms=bound(nbytes(op.T) + 2 * nbytes(ws),
                                2.0 * B_SB * op.T.numel()),
         check={"N": N_SB_CHECK, "B": B_SB_CHECK, "dtype": "float64",
                "settings": SB_CHECK_SETTINGS, "vs_solve_fused": errs,
                "atol": SB_ATOL, "solve_fused_launches": check_launches},
         launches=launches)


def mpc_loop(admm, mpc, realtime, dev, card):
    """The closed loops: simulate_realtime over MPC_TICKS ticks (each
    replan timed by CUDA events), and simulate (admm.solve a tick) against
    it in float64."""
    from pdp_lqr_tpu_torch.models import quadrotor
    st = admm.ADMMSettings(**RT_SETTINGS)
    model, _ = quadrotor(N=RT_N, constrained=True, dtype=torch.float32,
                         device=dev)
    x0 = torch.full((NX,), RT_X0, dtype=torch.float32, device=dev)
    replan_fn, times = realtime.replan_fn, []

    def timed_replan_fn(*args, **kwargs):
        fn = replan_fn(*args, **kwargs)

        def tick(x, state):
            out, ms = event_ms(lambda: fn(x, state))
            times.append(ms)
            return out

        return tick

    reset_kernel_counts()
    admm.reset_host_reads()
    t0 = time.perf_counter()
    realtime.replan_fn = timed_replan_fn     # each tick timed on the card
    try:
        xs, us, infos = mpc.simulate_realtime(model, x0, MPC_TICKS, (), st)
    finally:
        realtime.replan_fn = replan_fn
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    reads = admm.HOST_READS["early_exit"]
    launches = no_kernel_launches()
    require(xs.shape == (MPC_TICKS + 1, NX) and bool(torch.isfinite(xs).all())
            and bool(torch.isfinite(us).all()), "simulate_realtime output")
    iters = infos.iterations.cpu().numpy()
    warm = tick_stats(times[1:], iters[1:], [0])
    warm.pop("host_reads_per_tick_p50")
    # The two loops against each other, float64 (the JAX suite's check).
    m64 = model.to(dtype=torch.float64)
    s64 = admm.ADMMSettings(**MPC_TRACK_SETTINGS)
    x64 = torch.full((NX,), 0.08, dtype=torch.float64, device=dev)
    t0 = time.perf_counter()
    xs_rt, _, _ = mpc.simulate_realtime(m64, x64, MPC_TRACK_TICKS, (), s64)
    torch.cuda.synchronize()
    rt_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    xs_a, us_a, infos_a = mpc.simulate(m64, x64, MPC_TRACK_TICKS, (), s64)
    torch.cuda.synchronize()
    sim_s = time.perf_counter() - t0
    track = float((xs_rt - xs_a).abs().max())
    require(track <= MPC_TRACK_ATOL and bool(torch.isfinite(us_a).all()),
            "simulate_realtime vs simulate", track)
    emit("mpc_loop", card=card, model="quadrotor constrained", N=RT_N,
         dtype="float32", settings=RT_SETTINGS, x0=RT_X0,
         simulate_realtime={"ticks": MPC_TICKS, "loop_s": loop_s,
                            "cold_tick_ms": times[0],
                            "warm_ticks": warm,
                            "host_reads_per_tick": reads / MPC_TICKS,
                            "x_final": xs[-1].tolist()},
         budget_ms=RT_BUDGET_MS,
         track={"dtype": "float64", "ticks": MPC_TRACK_TICKS,
                "settings": MPC_TRACK_SETTINGS,
                "simulate_realtime_s_per_tick": rt_s / MPC_TRACK_TICKS,
                "simulate_s_per_tick": sim_s / MPC_TRACK_TICKS,
                "simulate_iterations": infos_a.iterations.tolist(),
                "max_abs_x_difference": track, "atol": MPC_TRACK_ATOL},
         launches=launches)


def recovery_phase(plt_, recovery, sequential, ca, cr, model, c_t, x0_t,
                   it32, dev, card):
    """solve_with_recovery over solve_lanes (K1 + K7) on the main path's
    batch with RECOVERY_SICK instances made indefinite.  Returns the
    launches of the counted recovered request."""
    from pdp_lqr_tpu_torch.utils.profiling import failure_mask
    rng = np.random.default_rng(SEED)
    sick = torch.as_tensor(np.sort(rng.choice(B_MAIN, RECOVERY_SICK,
                                              replace=False)), device=dev)
    H = model.H.expand((B_MAIN,) + tuple(model.H.shape)).clone()
    H[sick, :, :NU, :NU] -= 5.0 * torch.eye(NU, dtype=H.dtype, device=dev)
    bp = dataclasses.replace(batched(model, B_MAIN, c_t), H=H)
    it_b = plt_.ADMMIterates(**{f.name: getattr(it32, f.name)[None].expand(
        (B_MAIN,) + getattr(it32, f.name).shape)
        for f in dataclasses.fields(it32)})
    plain_request = lambda: cr.solve_lanes(bp, it_b, x0_t, SIGMA)
    request = lambda: recovery.solve_with_recovery(
        cr.solve_lanes, bp, it_b, x0_t, SIGMA, sigma_bump=RECOVERY_BUMP,
        retries=1)
    plain = plain_request()
    want = torch.zeros(B_MAIN, dtype=torch.bool, device=dev)
    want[sick] = True
    # The negative pivot shows as NaN on exactly the sick lanes.
    require(torch.equal(failure_mask(plain), want), "recovery: plain mask")
    request()
    torch.cuda.synchronize()
    reset_kernel_counts()
    ws, info = request()
    torch.cuda.synchronize()
    launches = {**cr.LAUNCHES, **ca.LAUNCHES}
    require(launches["backward_lanes"] == 2
            and launches["forward_rollout_lanes"] == 2, launches)
    healthy = ~want
    checks = {"failed_equals_sick": torch.equal(info.failed, want),
              "recovered_equals_sick": torch.equal(info.recovered, want),
              "still_failed": int(info.still_failed.sum()),
              "healthy_bit_identical": torch.equal(ws[healthy], plain[healthy]),
              "sick_finite": bool(torch.isfinite(ws[sick]).all())}
    # The recovered lanes against the sequential solver in float64 on the
    # bumped instances.
    m64 = lambda x: x[sick].double()
    bump = RECOVERY_BUMP * torch.eye(NX + NU, dtype=torch.float64, device=dev)
    p64 = plt_.LQRProblem(**{f.name: m64(getattr(bp, f.name))
                             for f in dataclasses.fields(bp)})
    p64 = dataclasses.replace(p64, H=p64.H + bump)
    it64 = plt_.ADMMIterates(**{f.name: m64(getattr(it_b, f.name))
                                for f in dataclasses.fields(it_b)})
    ref, _ = sequential.solve_batched(p64, it64, m64(x0_t), SIGMA)
    checks["sick_vs_sequential_f64"] = float((ws[sick].double() - ref).abs()
                                             .max())
    require(checks["failed_equals_sick"] and checks["recovered_equals_sick"]
            and checks["still_failed"] == 0 and checks["healthy_bit_identical"]
            and checks["sick_finite"]
            and checks["sick_vs_sequential_f64"] <= MAIN_PATH_ATOL,
            "recovery", checks)
    ms = cuda_ms(request, 3, warmup=1)
    plain_ms = cuda_ms(plain_request, 3, warmup=1)
    emit("recovery", card=card, model="quadrotor constrained, batched",
         N=N_MAIN, B=B_MAIN, dtype="float32", sick=sick.tolist(),
         sigma_bump=RECOVERY_BUMP, checks=checks,
         atol_vs_sequential=MAIN_PATH_ATOL, launches=launches,
         recovered_request_ms=ms, solve_lanes_ms=plain_ms)
    return launches


def badly_scaled(problem, row_span=1e6, cost_scale=1e4):
    """The same feasible set and argmin, constraint row i scaled by
    row_span^(i/(nc-1) - 1/2) (bounds too), the cost by cost_scale
    (tests/test_scaling.py's construction)."""
    nc = problem.nc
    rs = torch.as_tensor(row_span ** (np.arange(nc) / max(nc - 1, 1) - 0.5),
                         dtype=problem.D.dtype, device=problem.D.device)
    return dataclasses.replace(
        problem, D=problem.D * rs[None, :, None], e_lb=problem.e_lb * rs,
        e_ub=problem.e_ub * rs, H=problem.H * cost_scale,
        h=problem.h * cost_scale)


def equilibrated(admm, dev, card):
    """solve_equilibrated on the badly scaled quadrotor against the
    well-scaled solve (float64, torch ops, EQ_BACKEND)."""
    from pdp_lqr_tpu_torch.models import quadrotor
    model, _ = quadrotor(N=EQ_N, constrained=True, dtype=torch.float64,
                         device=dev)
    st = admm.ADMMSettings(**EQ_SETTINGS, backend=EQ_BACKEND)
    x0 = torch.full((NX,), 0.05, dtype=torch.float64, device=dev)
    reset_kernel_counts()
    t0 = time.perf_counter()
    ws_well, _, info_well = admm.solve(model, x0, (), st)
    torch.cuda.synchronize()
    well_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ws_eq, _, info_eq = admm.solve_equilibrated(badly_scaled(model), x0, (),
                                                st)
    torch.cuda.synchronize()
    eq_s = time.perf_counter() - t0
    launches = no_kernel_launches()
    it_well, it_eq = int(info_well.iter_converged), int(info_eq.iter_converged)
    err = float((ws_eq - ws_well).abs().max())
    checks = {"well_converged": bool(info_well.converged),
              "equilibrated_converged": bool(info_eq.converged),
              "iterations_well": it_well, "iterations_equilibrated": it_eq,
              "max_abs_ws_difference": err}
    require(checks["well_converged"] and checks["equilibrated_converged"]
            and it_eq <= 3 * max(it_well, 10) and err <= EQ_ATOL,
            "equilibrated", checks)
    emit("equilibrated", card=card, model="quadrotor constrained, rows "
         "scaled across 1e6, cost by 1e4", N=EQ_N, dtype="float64",
         backend=EQ_BACKEND, settings=EQ_SETTINGS, checks=checks,
         atol=EQ_ATOL, well_scaled_s=well_s, equilibrated_s=eq_s,
         launches=launches)


# ------------------------------------------------- the tenth slice's phases
# pdp_sharded (torch ops): the segment-parallel solve at B_PDP, S_PDP, both
# condensed variants, against the float64 sequential solver.
PS_N_REF = 8
# native: the g++ witness against the port's solve_lanes (float64).
NATIVE_N, NATIVE_B, NATIVE_ATOL = 512, 64, 1e-9
# multirank: two ranks sharing the one card over gloo, each call beside the
# same call in one process; then a world of one rank on NCCL.
MR_WORLD, MR_TIMEOUT_S, MR_REPS = 2, 600, 3
# One solve: 1e-6 (float32); a 20-iteration ADMM loop in float32 carries
# the rounding of products whose shapes differ on a rank (cuBLAS picks other
# reduction orders for N/2 stages or B/2 rows): 3.5e-6 measured on
# admm_sharded (one H100), held to ten times that.  float64: 1e-12.
MR_RTOL = {torch.float32: 1e-6, torch.float64: 1e-12}
MR_LOOP_RTOL = {torch.float32: 3.5e-5, torch.float64: 1e-12}
MR_B_PDP, MR_TIME = 1024, 2
MR_EARLY = dict(REP_SETTINGS, early_exit=True, max_iter=60)
# examples: the six examples at their card defaults; five at once beside
# phases that time nothing, then the roofline report (it times K1 and K7)
# alone.
# Those that launch no kernel start before the build (it takes 350-500 s).
EXAMPLES_EARLY = ("torch_lqr_example", "torch_constrained_mpc")
EXAMPLES = ("torch_latency_mpc", "torch_rocket_landing", "torch_scenario_mpc")
ROOFLINE = "torch_roofline_report"
EXAMPLES_EARLY_TIMEOUT_S = 900
EXAMPLES_TIMEOUT_S = 300
ROOFLINE_TIMEOUT_S = 120
BOX = (-0.9916, 2.4084)
EX_POSITION_ATOL = 1e-2        # the closed loop's final position vs [0, 0, 1]
EX_BOX_ATOL = 1e-3             # the ADMM tolerance on the input box


def pdp_sharded_phase(plt_, sequential, dev, card):
    """parallel.pdp_sharded.solve (torch ops, no kernel) at full width:
    the quadrotor written out once a scenario, B_PDP scenarios, S_PDP
    segments, Cholesky and LU condensed solves, float32, against the
    float64 sequential solver on the first scenarios."""
    from pdp_lqr_tpu_torch.config import CondensedSolverType
    from pdp_lqr_tpu_torch.models import quadrotor
    from pdp_lqr_tpu_torch.parallel import make_mesh, pdp_sharded

    model, _ = quadrotor(N=N_MAIN, constrained=True, dtype=torch.float32,
                         device=dev)
    rng = np.random.default_rng(SEED + 5)
    c = torch.as_tensor(rng.normal(size=(B_PDP, N_MAIN, NX)) * 0.01).to(
        device=dev, dtype=torch.float32)
    x0 = torch.as_tensor(rng.normal(size=(B_PDP, NX)) * 0.1).to(
        device=dev, dtype=torch.float32)
    bp = batched(model, B_PDP, c)
    it = plt_.init_iterates(bp, rho=RHO)
    bp64 = bp.to(dtype=torch.float64)
    ref, _ = sequential.solve_batched(
        plt_.LQRProblem(**{f.name: getattr(bp64, f.name)[:PS_N_REF]
                           for f in dataclasses.fields(bp64)}),
        plt_.ADMMIterates(**{f.name: getattr(it, f.name)[:PS_N_REF].double()
                             for f in dataclasses.fields(it)}),
        x0[:PS_N_REF].double(), SIGMA)
    mesh = make_mesh(time=S_PDP, device=dev)
    out = {}
    for st in CondensedSolverType:
        request = lambda st=st: pdp_sharded.solve(mesh, bp, it, x0, SIGMA, st)
        reset_kernel_counts()
        ws = request()
        torch.cuda.synchronize()
        launches = no_kernel_launches()
        require(ws.shape == (B_PDP, N_MAIN + 1, NX + NU) and
                ws.dtype == torch.float32 and ws.device.type == "cuda")
        require(bool(torch.isfinite(ws).all()), "pdp_sharded: not finite")
        err = float((ws[:PS_N_REF].double() - ref).abs().max())
        require(err <= MAIN_PATH_ATOL, st, err)
        out[st.value] = {"max_abs_err_vs_sequential_f64": err,
                         "request_ms": cuda_ms(request, 3, warmup=1),
                         "launches": launches}
    emit("pdp_sharded", card=card, model="quadrotor constrained, batched",
         N=N_MAIN, B=B_PDP, S=S_PDP, dtype="float32",
         atol=MAIN_PATH_ATOL, **out)


def native_phase(plt_, cr, dev, card):
    """utils.native (the g++ witness, on the host) against the port's
    solve_lanes (K1 + K7, float64) on the quadrotor."""
    from pdp_lqr_tpu_torch.models import quadrotor
    from pdp_lqr_tpu_torch.utils import native

    require(native.available(), "native: g++ did not build the engine")
    model, _ = quadrotor(N=NATIVE_N, constrained=True, dtype=torch.float64,
                         device=dev)
    rng = np.random.default_rng(SEED + 6)
    c = torch.as_tensor(rng.normal(size=(NATIVE_B, NATIVE_N, NX)) * 0.01).to(dev)
    x0 = torch.as_tensor(rng.normal(size=(NATIVE_B, NX)) * 0.1).to(dev)
    bp = batched(model, NATIVE_B, c)
    it = plt_.init_iterates(bp, rho=RHO)
    reset_kernel_counts()
    ws = cr.solve_lanes(bp, it, x0, SIGMA)
    torch.cuda.synchronize()
    launches = {k: v for k, v in {**zero_counts(), **cr.LAUNCHES}.items() if v}
    require(launches == {"backward_lanes": 1, "forward_rollout_lanes": 1},
            launches)
    t0 = time.perf_counter()
    ws_native = native.solve_batch(bp, it, x0, SIGMA)
    native_s = time.perf_counter() - t0
    require(ws_native.device == ws.device and ws_native.dtype == torch.float64)
    err = float((ws_native - ws).abs().max())
    require(err <= NATIVE_ATOL, "native vs solve_lanes", err)
    emit("native", card=card, model="quadrotor constrained, batched",
         N=NATIVE_N, B=NATIVE_B, dtype="float64", launches=launches,
         max_abs_err_vs_solve_lanes=err, atol=NATIVE_ATOL,
         native_host_s=native_s)


def multirank_inputs(plt_, admm, dt, N, B, B_pdp, dev):
    """The multi-rank calls' inputs on the card (views where the model is
    written out once a scenario) and their one-process counterparts."""
    from pdp_lqr_tpu_torch.models import quadrotor
    from pdp_lqr_tpu_torch.ops import cuda_riccati as cr
    from pdp_lqr_tpu_torch.parallel import (admm_sharded, make_mesh,
                                            pdp_sharded_fused)
    model, _ = quadrotor(N=N, constrained=True, dtype=dt, device=dev)
    model_c, cones = quadrotor(N=N, constrained=True, thrust_cone=True,
                               dtype=dt, device=dev)
    rng = np.random.default_rng(SEED + 7)
    t = lambda x: torch.as_tensor(x).to(device=dev, dtype=dt)
    c = t(rng.normal(size=(B, N, NX)) * 0.01)
    x0 = t(rng.normal(size=(B, NX)) * 0.1)
    x0a = t(0.03 + 0.01 * rng.normal(size=(B, NX)))
    shift = np.zeros((N + 1, NC_CONE))
    shift[:, NC] = THRUST_SHIFT
    shift = t(shift)
    bp = batched(model, B, c)
    it = plt_.init_iterates(bp, rho=RHO)
    head = lambda r: type(r)(**{f.name: getattr(r, f.name)[:B_pdp]
                                for f in dataclasses.fields(r)})
    bp_pdp, it_pdp = head(bp), head(it)
    bp_c = batched(model_c, B_pdp, c[:B_pdp])
    shared = dataclasses.replace(model, c=c)
    split = admm.ADMMSettings(**ADMM_SETTINGS)
    P = "pdp_lqr_tpu_torch.parallel."
    calls = {
        "fused_dp.solve": (P + "fused_dp:solve", 1, (bp, it, x0, SIGMA), {},
                           lambda: cr.solve_lanes(bp, it, x0, SIGMA)),
        "fused_dp.solve_fused_dp[split]": (
            P + "fused_dp:solve_fused_dp", 1, (shared, x0a, (), split),
            {"single_kernel": False},
            lambda: admm.solve_fused(shared, x0a, (), split,
                                     single_kernel=False)),
        "pdp_sharded_fused.solve": (
            P + "pdp_sharded_fused:solve", MR_TIME,
            (bp_pdp, it_pdp, x0[:B_pdp], SIGMA), {},
            lambda: pdp_sharded_fused.solve(make_mesh(time=MR_TIME, device=dev),
                                            bp_pdp, it_pdp, x0[:B_pdp], SIGMA)),
    }
    for cached in (False, True):
        st = admm.ADMMSettings(**REP_SETTINGS, cached_factors=cached)
        calls[f"admm_sharded.solve[{'cached' if cached else 'uncached'}]"] = (
            P + "admm_sharded:solve", MR_TIME,
            (bp_c, x0a[:B_pdp], cones, st), {"soc_shift": shift},
            lambda st=st: admm_sharded.solve(
                make_mesh(time=MR_TIME, device=dev), bp_c, x0a[:B_pdp], cones,
                st, soc_shift=shift))
    return calls


MR_LAUNCHES = {
    "fused_dp.solve": {"backward_lanes": 1, "forward_rollout_lanes": 1},
    "fused_dp.solve_fused_dp[split]": {
        "backward_lanes": 1, "admm_bwd_vec_prefold_lanes": ADMM_ITERS,
        "admm_fwd_update_lanes": ADMM_ITERS},
    "pdp_sharded_fused.solve": {"backward_pdp_lanes": 1, "forward_lanes": 1},
    "admm_sharded.solve[uncached]": {"backward_pdp_lanes": ADMM_ITERS,
                                     "forward_lanes": ADMM_ITERS},
    "admm_sharded.solve[cached]": {"backward_pdp_lanes": 1,
                                   "backward_pdp_vectors_lanes": ADMM_ITERS,
                                   "forward_lanes": ADMM_ITERS},
}


def _first(out):
    return out[0] if isinstance(out, tuple) else out


def _rank_rows(name, rank, B):
    """The rows of the global batch a rank's result holds (fused_dp splits
    the batch over the ranks; the time meshes give every rank all rows)."""
    if name.startswith("fused_dp"):
        n = B // MR_WORLD
        return slice(rank * n, (rank + 1) * n)
    return slice(0, B)


def multirank_phase(plt_, admm, dev, card):
    """The mesh over ranks on the card: a world of MR_WORLD ranks sharing
    the one card over gloo (``multihost.launch``), each call of
    ``fused_dp``, ``pdp_sharded_fused`` and ``admm_sharded`` held against
    the same call in this process (float32 at full width, float64 at
    N_SMALL, B_SMALL) and its kernels counted on every rank; then a world
    of one rank on NCCL.  Times are two ranks sharing one card (gloo) or
    one rank (NCCL): not a scaling figure."""
    from pdp_lqr_tpu_torch.parallel import admm_sharded, make_mesh, multihost
    from pdp_lqr_tpu_torch.parallel import pdp_sharded_fused as psf

    cases = {torch.float32: multirank_inputs(plt_, admm, torch.float32,
                                             N_MAIN, B_MAIN, MR_B_PDP, dev),
             torch.float64: multirank_inputs(plt_, admm, torch.float64,
                                             N_SMALL, B_SMALL, B_SMALL, dev)}
    jobs, plain = [], {}
    for dt, calls in cases.items():
        for name, (fn, t, args, kwargs, one) in calls.items():
            key = f"{name}[{str(dt).split('.')[-1]}]"
            jobs.append(dict(name=key, fn=fn, time=t, args=args, kwargs=kwargs,
                             reps=MR_REPS if dt == torch.float32 else 0))
            reset_kernel_counts()
            plain[key] = one()
            torch.cuda.synchronize()
            plain[key + "/ms"] = (cuda_ms(one, MR_REPS, warmup=0)
                                  if dt == torch.float32 else None)
    t0 = time.time()
    ranks = multihost.launch(jobs, MR_WORLD, device="cuda", backend="gloo",
                             timeout=MR_TIMEOUT_S)
    world_s = time.time() - t0
    results = {}
    for dt, calls in cases.items():
        B = B_MAIN if dt == torch.float32 else B_SMALL
        for name in calls:
            key = f"{name}[{str(dt).split('.')[-1]}]"
            ref, errs, launches, ms = plain[key], [], [], []
            for rank in ranks:
                res = next(r for r in rank["results"] if r["name"] == key)
                require(res["error"] is None, key, rank["rank"], res["error"])
                rows = _rank_rows(name, rank["rank"], B)
                err = rel_diff(_first(res["out"]), _first(ref)[rows].cpu())
                if isinstance(ref, tuple):
                    err = max(err, rel_diff(res["out"][1].rho,
                                            ref[1].rho[rows].cpu()))
                    require(bool((res["out"][2].iterations
                                  == ref[2].iterations[rows].cpu()).all()), key)
                tol = (MR_LOOP_RTOL if isinstance(ref, tuple) else MR_RTOL)[dt]
                require(err <= tol, key, rank["rank"], err)
                require(res["launches"] == MR_LAUNCHES[name], key,
                        rank["rank"], res["launches"])
                errs.append(err)
                launches.append(res["launches"])
                ms.append(res["ms"])
            results[key] = {"max_rel_err_vs_one_process": max(errs),
                            "launches_by_rank": launches,
                            "two_ranks_ms_by_rank": ms,
                            "one_process_ms": plain[key + "/ms"]}
    for rank in ranks:
        require(rank["backend"] == "gloo" and rank["allow_tf32"] is False)
        require(not {"jax", "jaxlib", "pdp_lqr_tpu"} & set(rank["packages"]),
                rank["packages"])

    # A world of one rank on NCCL: the collectives of pdp_sharded_fused and
    # of admm_sharded's early exit through NCCL.
    calls = cases[torch.float32]
    _, _, args, _, _ = calls["pdp_sharded_fused.solve"]
    bp_c, x0a, cones, _ = calls["admm_sharded.solve[uncached]"][2]
    shift = calls["admm_sharded.solve[uncached]"][3]["soc_shift"]
    early = admm.ADMMSettings(**MR_EARLY)
    nccl_jobs = [
        dict(name="pdp_sharded_fused", fn="pdp_lqr_tpu_torch.parallel."
             "pdp_sharded_fused:solve", time=1, args=args, reps=MR_REPS),
        dict(name="admm_sharded_early_exit", fn="pdp_lqr_tpu_torch.parallel."
             "admm_sharded:solve", time=1, args=(bp_c, x0a, cones, early),
             kwargs={"soc_shift": shift}, reps=MR_REPS)]
    one = {"pdp_sharded_fused": lambda: psf.solve(make_mesh(device=dev), *args),
           "admm_sharded_early_exit": lambda: admm_sharded.solve(
               make_mesh(device=dev), bp_c, x0a, cones, early,
               soc_shift=shift)}
    t0 = time.time()
    nccl = multihost.launch(nccl_jobs, 1, device="cuda", backend="nccl",
                            timeout=MR_TIMEOUT_S)[0]
    nccl_s = time.time() - t0
    require(nccl["backend"] == "nccl")
    nccl_out = {}
    for res in nccl["results"]:
        require(res["error"] is None, res["name"], res["error"])
        ref = one[res["name"]]()
        err = rel_diff(_first(res["out"]), _first(ref).cpu())
        tol = (MR_LOOP_RTOL if isinstance(ref, tuple) else MR_RTOL)
        require(err <= tol[torch.float32], res["name"], err)
        nccl_out[res["name"]] = {"max_rel_err_vs_one_process": err,
                                 "launches": res["launches"],
                                 "one_rank_ms": res["ms"]}
        if isinstance(ref, tuple):
            its = int(res["out"][2].iterations[0])
            require(its == int(ref[2].iterations[0].cpu()), res["name"])
            nccl_out[res["name"]]["iterations"] = its
    emit("multirank", card=card, model="quadrotor constrained (+ thrust cone "
         "with a shift for admm_sharded)", world=MR_WORLD, backend="gloo",
         device="two ranks sharing one card", N={"float32": N_MAIN,
                                                 "float64": N_SMALL},
         B={"float32": B_MAIN, "float64": B_SMALL}, B_time_mesh=MR_B_PDP,
         time=MR_TIME, rtol={"solve": {str(k).split(".")[-1]: v
                                       for k, v in MR_RTOL.items()},
                             "admm_loop": {str(k).split(".")[-1]: v
                                           for k, v in MR_LOOP_RTOL.items()}},
         calls=results, world_s=world_s,
         nccl={"world": 1, "device": "one rank on the card", "s": nccl_s,
               **nccl_out})


def example_path(name):
    import pathlib
    return str(pathlib.Path(__file__).resolve().parent / "examples"
               / f"{name}.py")


class ExampleRuns:
    """Examples (``examples/torch_*.py``) at their card defaults, started
    together as subprocesses; ``finish`` waits for them (each killed
    ``timeout`` seconds after the start) and returns their exit codes and
    output.  Every child is killed when the script exits, whatever its
    exit."""

    def __init__(self, names, timeout):
        import atexit
        import tempfile

        self.t0 = time.time()
        self.deadline = self.t0 + timeout
        self.procs, self.logs = {}, {}
        atexit.register(self.kill)
        for name in names:
            self.logs[name] = tempfile.TemporaryFile("w+")
            self.procs[name] = subprocess.Popen(
                [sys.executable, example_path(name)],
                stdout=self.logs[name], stderr=subprocess.STDOUT)

    def kill(self):
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()

    def finish(self):
        for p in self.procs.values():
            try:
                p.wait(timeout=max(1.0, self.deadline - time.time()))
            except subprocess.TimeoutExpired:
                pass
        self.kill()
        outs = {}
        for name, log in self.logs.items():
            log.seek(0)
            outs[name] = log.read()
            log.close()
        return {n: p.returncode for n, p in self.procs.items()}, outs


def examples_phase(runs, card):
    """The examples' exit codes and the figures they print, held to what
    the JAX examples print as expectations; then the roofline report alone
    on the card."""
    codes, outs = {}, {}
    for group in runs:
        c, o = group.finish()
        codes.update(c)
        outs.update(o)
    t_roof = time.time()
    roof = subprocess.run([sys.executable, example_path(ROOFLINE)],
                          capture_output=True, text=True,
                          timeout=ROOFLINE_TIMEOUT_S)
    codes[ROOFLINE], outs[ROOFLINE] = roof.returncode, roof.stdout + roof.stderr
    roof_s = time.time() - t_roof
    for name, code in codes.items():
        require(code == 0, name, code, outs[name][-3000:])

    def last_json(name):
        """The figures an example prints as its last line."""
        return json.loads(outs[name].strip().splitlines()[-1])

    figs = {}
    lqr = last_json("torch_lqr_example")
    require(len(lqr) == 4 and all(abs(f["xN"][2] - 1.0) <= EX_POSITION_ATOL
                                  for f in lqr.values()), lqr)
    figs["torch_lqr_example"] = {k: v["xN"][2] for k, v in lqr.items()}
    cm = last_json("torch_constrained_mpc")
    require(max(abs(a - b) for a, b in zip(cm["final_position"],
                                           (0.0, 0.0, 1.0)))
            <= EX_POSITION_ATOL, cm)
    require(cm["u_min"] >= BOX[0] - EX_BOX_ATOL
            and cm["u_max"] <= BOX[1] + EX_BOX_ATOL, cm)
    require(cm["mean_iterations"] <= cm["max_iter"], cm)
    figs["torch_constrained_mpc"] = cm
    rk = last_json("torch_rocket_landing")
    require(rk["single"]["converged"] and rk["dtype"] == "float32", rk)
    require(rk["closed_loop"]["altitude_end"] < rk["closed_loop"][
        "altitude_start"], rk)
    figs["torch_rocket_landing"] = rk
    sc = last_json("torch_scenario_mpc")
    require(sc["B"] == 1024 and sc["failed"] == 0, sc)
    figs["torch_scenario_mpc"] = sc
    rf = json.loads(roof.stdout.strip().splitlines()[-1])
    require(rf["card"] == card and rf["ws_finite"], rf)
    for k in ("backward", "forward"):
        require(0.0 < rf[k]["utilization_pct_spec"] <= 100.0, k, rf[k])
    figs["torch_roofline_report"] = rf
    lat = [l for l in outs["torch_latency_mpc"].splitlines()
           if "us/ADMM-iter" in l]
    require(len(lat) >= 3, outs["torch_latency_mpc"][-2000:])
    figs["torch_latency_mpc"] = lat
    emit("examples", card=card,
         seconds_since_start={"early": time.time() - runs[0].t0,
                              "after_build": time.time() - runs[1].t0},
         roofline_alone_s=roof_s, exit_codes=codes,
         figures=figs, expect={"final_position": [0, 0, 1],
                               "position_atol": EX_POSITION_ATOL,
                               "box": BOX, "box_atol": EX_BOX_ATOL})


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1

    t_start = time.time()
    import pdp_lqr_tpu_torch as plt_
    from pdp_lqr_tpu_torch import mpc
    from pdp_lqr_tpu_torch.models import quadrotor, rocket, rocket_x0
    from pdp_lqr_tpu_torch.ops import _build, cuda_admm as ca, cuda_riccati as cr
    from pdp_lqr_tpu_torch.solvers import admm, realtime, recovery, sequential

    require("jax" not in sys.modules and "pdp_lqr_tpu" not in sys.modules)
    require(torch.backends.cuda.matmul.allow_tf32 is False)
    dev = torch.device("cuda")
    # The float64 references on the CPU step the tensors of a few scenarios:
    # more threads only contend (reference_api's B=64 takes them all).
    cpu_cores = torch.get_num_threads()
    torch.set_num_threads(1)

    # ------------------------------------------------------------ 1: env
    card = card_line()
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    emit("env", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=[l for l in nvcc.splitlines() if "release" in l][0].strip(),
         triton=triton_version, python=sys.version.split()[0])

    # ---------------------------------------------------------- 2: build
    # The examples that launch no kernel run beside the build.
    early_examples = ExampleRuns(EXAMPLES_EARLY, EXAMPLES_EARLY_TIMEOUT_S)
    t0 = time.time()
    jobs = []
    for dt in (torch.float32, torch.float64):
        for nc in (NC, NC_CONE, 0, None):
            jobs.append((cr.SOURCE, cr.kernel_defines(dt, NX, NU, nc)))
        jobs.append((ca.SOURCE, ca.kernel_defines(dt, NX, NU)))
        for _, nc, cones, diag, shift in K5_MODES:
            jobs.append((ca.SOURCE, ca.kernel_defines(
                dt, NX, NU, nc, cones=cones, diag_cost=diag, has_shift=shift)))
        # The ladder's pair: K6 on 1, 3, 4 rungs; K5's rung form on 4.
        for R in (1, 3, len(LADDER)):
            jobs.append((ca.SOURCE, ca.kernel_defines(dt, NX, NU, NC, fold=True,
                                                      rungs=R)))
        jobs.append((ca.SOURCE, ca.kernel_defines(
            dt, NX, NU, NC_CONE, fold=True, rungs=len(LADDER))))
        for nc, cones, shift in ((NC, (), False), (NC_CONE, THRUST_CONE, True)):
            jobs.append((ca.SOURCE, ca.kernel_defines(
                dt, NX, NU, nc, cones=cones, diag_cost=True, has_shift=shift,
                rungs=len(LADDER))))
        # K8 (its eight forms are templates of one library a mode).
        for nc, cones, shift in K8_MODES.values():
            jobs.append((ca.SOURCE, ca.kernel_defines(
                dt, NX, NU, nc, cones=cones, has_shift=shift, single=True)))
        jobs.append((ca.SOURCE, ca.kernel_defines(
            dt, *K8_ODD[:3], cones=K8_ODD[3], has_shift=K8_ODD[4],
            single=True)))
    # K8 at the rocket's widths (two cones), float32.
    jobs.append((ca.SOURCE, ca.kernel_defines(
        torch.float32, 6, 3, 7, cones=((1, 3, "soc"), (4, 3, "soc")),
        single=True)))
    # The narrow forms (bfloat16 stage streams: K1 gains only and K11, K7
    # and K12) at the quadrotor's widths, both compute types; and of the
    # split kernels (bfloat16 narrow sets): K4, K5 packed (the split path's
    # box rows with a diagonal cost; the thrust cone with a shift and a full
    # cost), K6 and K5's rung form on the ladder's rungs and on two.
    for dt in (torch.float32, torch.float64):
        for nc in (NC, None):
            jobs.append((cr.SOURCE, cr.kernel_defines(dt, NX, NU, nc,
                                                      narrow=True)))
        jobs += [(ca.SOURCE, d) for d in narrow_split_defines(ca, dt)]
    # Every kernel at the two wide widths (mass-spring, centroidal).
    jobs += wide_build_jobs(ca, cr)
    paths = _build.build_many(jobs)
    regs = registers_by_kernel(
        [(job[1], _build.build_logs.get(path, "")) for job, path in zip(jobs, paths)])
    emit("build", card=card, seconds=round(time.time() - t0, 2),
         libraries=[p.name for p in paths], ptxas=regs)
    # The other three examples run beside the next phase (it times nothing).
    example_runs = (early_examples, ExampleRuns(EXAMPLES, EXAMPLES_TIMEOUT_S))

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
        # K1 per instance, gains only.
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
        compare(f"backward_vectors_lanes[shared,P,B={B_RAGGED}]", K2_OUT,
                cr.backward_vectors_lanes(A, Bm, c_r, hf_r, P, K, L, pN_r,
                                          shared=True),
                cr.backward_vectors_lanes_reference(A, Bm, c_r, hf_r, P, K, L,
                                                    pN_r))

        # K2 / K3, one matrix set per scenario (trailing batch = B).
        wide = lambda x: x.expand(x.shape[:-1] + (B_SMALL,)).contiguous()
        Aw, Bw, Kw, Mw, Pw, Lw = (wide(x) for x in (A, Bm, K, M, P, L))
        compare("backward_vectors_lanes[per-instance,P]", K2_OUT,
                cr.backward_vectors_lanes(Aw, Bw, c, hf, Pw, Kw, Lw, pN),
                cr.backward_vectors_lanes_reference(Aw, Bw, c, hf, Pw, Kw, Lw, pN))
        # Per-instance K2 on a matrix set a scenario (the shared one
        # perturbed, L below its diagonal), both modes, on a full and a
        # ragged batch (blocks of 8 scenarios, the last one partly idle);
        # its own generator, so the cases after it see the same data.
        rng_k2 = np.random.default_rng(SEED + 2)
        jit = lambda x, keep=None: (x + 0.01 * torch.as_tensor(
            rng_k2.normal(size=x.shape)).to(device=dev, dtype=dt)
            * (1 if keep is None else keep)).contiguous()
        low = torch.tril(torch.ones(NU, NU, dtype=dt, device=dev),
                         diagonal=-1)[None, :, :, None]
        k2_sets = (jit(Aw), jit(Bw), jit(Pw), jit(Kw), jit(Lw, low))
        for Bt in (B_SMALL, B_RAGGED):
            Ai, Bi, Pi, Ki, Li = (x[..., :Bt].contiguous() for x in k2_sets)
            ci, hfi, pNi = (x[..., :Bt].contiguous() for x in (c, hf, pN))
            Pci = torch.einsum("kijb,kjb->kib", Pi, ci).contiguous()
            for pc in (None, Pci):
                compare(f"backward_vectors_lanes[per-instance,"
                        f"{'P' if pc is None else 'Pc'},B={Bt},sets]", K2_OUT,
                        cr.backward_vectors_lanes(Ai, Bi, ci, hfi, Pi, Ki, Li,
                                                  pNi, Pc=pc),
                        cr.backward_vectors_lanes_reference(
                            Ai, Bi, ci, hfi, Pi, Ki, Li, pNi, Pc=pc))
        compare("forward_lanes[per-instance]", K3_OUT,
                cr.forward_lanes(Mw, v, Kw, d, x0),
                cr.forward_lanes_reference(Mw, v, Kw, d, x0))
        k3_r = tuple(cut(x) for x in (Mw, v, Kw, d, x0))
        compare(f"forward_lanes[per-instance,B={B_RAGGED}]", K3_OUT,
                cr.forward_lanes(*k3_r), cr.forward_lanes_reference(*k3_r))

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
                no_hf = k5_in[:8] + (None,)      # packed, without hf-emit
                compare(f"admm_fwd_update_lanes[{mode},B={Bt},hf=0]",
                        K5_RUNG_OUT, k5_call(ca, no_hf, cones),
                        k5_plain(ca, no_hf, cones))

        # The rho ladder's pair: K6 on 1, 3 and 4 rungs (and its Pc form),
        # K5's rung form on 4 rungs with and without hf-emit, box rows and
        # the thrust cone with a shift; a ragged batch on 4 rungs.
        for R, nc, cones, shift, Bt in ((1, NC, (), False, B_SMALL),
                                        (3, NC, (), False, B_SMALL),
                                        (4, NC, (), False, B_SMALL),
                                        (4, NC_CONE, THRUST_CONE, True, B_SMALL),
                                        (4, NC, (), False, B_RAGGED)):
            k6_in, k5_in, rung, Pc6 = random_ladder_inputs(
                rng, A, Bm, R, nc, Bt, cones, True, shift)
            rung = rung if R > 1 else None
            tag = f"R={R},nc={nc},B={Bt}"
            compare(f"admm_bwd_vec_lanes[{tag}]", K6_OUT,
                    [ca.admm_bwd_vec_lanes(*k6_in, nu=NU, sigma=SIGMA, rung=rung)],
                    [ca.admm_bwd_vec_lanes_reference(*k6_in, nu=NU, sigma=SIGMA,
                                                     rung=rung)])
            if R == 1:
                pc_in = k6_in[:7] + (None,) + k6_in[8:]
                compare(f"admm_bwd_vec_lanes[Pc,{tag}]", K6_OUT,
                        [ca.admm_bwd_vec_lanes(*pc_in, nu=NU, sigma=SIGMA, Pc=Pc6)],
                        [ca.admm_bwd_vec_lanes_reference(*pc_in, nu=NU,
                                                         sigma=SIGMA, Pc=Pc6)])
            if R < 4:
                continue
            for hf_emit in ((False, True) if Bt == B_SMALL else (False,)):
                k5r = k5_in[:8] + (k5_in[8] if hf_emit else None,)
                compare(f"admm_fwd_update_lanes[rung,{tag},hf={int(hf_emit)}]",
                        K5_OUT if hf_emit else K5_RUNG_OUT,
                        k5_call(ca, k5r, cones, K=k6_in[9], rung=rung),
                        k5_plain(ca, k5r, cones, K=k6_in[9], rung=rung))

        # K7 and the per-instance K1 with closed-loop
        # maps and factor export, and with export alone.
        k7_in = (Aw, Bw, c, Kw, d, x0)
        compare("forward_rollout_lanes", K3_OUT, cr.forward_rollout_lanes(*k7_in),
                cr.forward_rollout_lanes_reference(*k7_in))
        k7_r = tuple(cut(x) for x in k7_in)
        compare(f"forward_rollout_lanes[B={B_RAGGED}]", K3_OUT,
                cr.forward_rollout_lanes(*k7_r),
                cr.forward_rollout_lanes_reference(*k7_r))
        compare("backward_lanes[batch=5,export]", K1_ALL,
                cr.backward_lanes(*few, export_factors=True),
                cr.backward_lanes_reference(*few, export_factors=True))
        compare("backward_lanes[batch=5,export,gains]", K1_EXPORT,
                cr.backward_lanes(*few, export_factors=True, emit_closed_loop=False),
                cr.backward_lanes_reference(*few, export_factors=True,
                                            emit_closed_loop=False))

        # K8 in each form: shared or batched, cached or not, the stage data
        # in the compute type or bfloat16; box rows, and the thrust cone
        # with a shift; a full and a ragged batch (the cached factors: K1's
        # plain version with export, launching nothing).
        k8_cases = 0
        for Bt in (B_SMALL, B_RAGGED):
            for mode, (nc, cones, shift) in K8_MODES.items():
                for shared in (False, True):
                    args = random_iter_inputs(rng, N_SMALL, NX, NU, nc, Bt,
                                              cones, shared, shift, dt, dev)
                    for factors in (None, iter_factors(args, shared)):
                        for narrow in (False, True):
                            a = narrow_storage(args) if narrow else args
                            kw = dict(nu=NU, cones=cones, alpha=ALPHA,
                                      sigma=SIGMA, factors=factors)
                            form = (("shared" if shared else "batched")
                                    + (",cached" if factors else "")
                                    + (",bf16" if narrow else ""))
                            compare(f"admm_iter_lanes[{form},{mode},B={Bt}]",
                                    K8_OUT,
                                    ca.admm_iter_lanes(*a, shared=shared, **kw),
                                    ca.admm_iter_lanes_reference(*a, **kw))
                            k8_cases += 1
        # Every form at odd widths on an odd batch.
        nx_o, nu_o, nc_o, cones_o, shift_o = K8_ODD
        for shared in (False, True):
            args = random_iter_inputs(rng, N_SMALL, nx_o, nu_o, nc_o, B_ODD,
                                      cones_o, shared, shift_o, dt, dev)
            for factors in (None, iter_factors(args, shared)):
                for narrow in (False, True):
                    a = narrow_storage(args) if narrow else args
                    kw = dict(nu=nu_o, cones=cones_o, alpha=ALPHA, sigma=SIGMA,
                              factors=factors)
                    form = (("shared" if shared else "batched")
                            + (",cached" if factors else "")
                            + (",bf16" if narrow else ""))
                    compare(f"admm_iter_lanes[{form},nx={nx_o},nu={nu_o},"
                            f"B={B_ODD}]", K8_OUT,
                            ca.admm_iter_lanes(*a, shared=shared, **kw),
                            ca.admm_iter_lanes_reference(*a, **kw))
                    k8_cases += 1

        # K9 (both forms) in S_SMALL segments from random carries, K10 on
        # its factors, K3 in the same segments, on a full, a ragged and an
        # odd batch (K10's boxes of a 16-byte phase of rows: two, four in
        # float32); K11 and K12 on the packed streams of the same stage data.
        pdp_data = random_stage_data(rng, N_SMALL, NX, NU, NC, B_SMALL, dt, dev)
        pdp_batches = (B_SMALL, B_RAGGED, B_ODD)
        for Bt in pdp_batches:
            stages = tuple(x[..., :Bt].contiguous() for x in pdp_data[:8])
            k9_in = stages + random_carries(rng, S_SMALL, NX, Bt, dt, dev)
            for export in (False, True):
                compare(f"backward_pdp_lanes[S={S_SMALL},B={Bt}"
                        + (",export]" if export else "]"),
                        K9_ALL if export else K9_OUT,
                        cr.backward_pdp_lanes(*k9_in, export_factors=export,
                                              segments=S_SMALL),
                        cr.backward_pdp_lanes_reference(
                            *k9_in, export_factors=export, segments=S_SMALL))
            K9f, d9, M9, v9, _, P9, L9, F9 = cr.backward_pdp_lanes_reference(
                *k9_in, export_factors=True, segments=S_SMALL)[:8]
            k10_in = (stages[0], stages[1], stages[2], vec(N_SMALL, NX + NU, Bt),
                      P9, K9f, L9, F9, vec(S_SMALL, NX, Bt))
            compare(f"backward_pdp_vectors_lanes[S={S_SMALL},B={Bt}]", K10_OUT,
                    cr.backward_pdp_vectors_lanes(*k10_in, segments=S_SMALL),
                    cr.backward_pdp_vectors_lanes_reference(
                        *k10_in, segments=S_SMALL))
            k3s_in = (M9, v9, K9f, d9, vec(S_SMALL, NX, Bt))
            compare(f"forward_lanes[S={S_SMALL},B={Bt}]", K3_OUT,
                    cr.forward_lanes(*k3s_in, segments=S_SMALL),
                    cr.forward_lanes_reference(*k3s_in, segments=S_SMALL))
            Sd, Sc = pack_streams(*stages)
            PN_p, pN_p = (x[..., :Bt].contiguous() for x in pdp_data[8:])
            compare(f"backward_packed[B={Bt}]", ("G",),
                    [cr.backward_packed(Sd, Sc, PN_p, pN_p, NU, NC)],
                    [cr.backward_packed_reference(Sd, Sc, PN_p, pN_p, NU, NC)])
            G_p = cr.backward_packed_reference(Sd, Sc, PN_p, pN_p, NU, NC)
            x0_p = vec(NX, Bt)
            compare(f"forward_packed[B={Bt}]", K3_OUT,
                    cr.forward_packed(Sd, G_p, x0_p, NU),
                    cr.forward_packed_reference(Sd, G_p, x0_p, NU))

        # The matrix sweep, K1 with every output and K9 exporting its
        # factors: at Bt = 1, G-1 and G+1 (few (segment, instance) pairs: a
        # block an instance), then across its groups of G instances a block,
        # past the pairs where groups take over, with a ragged last group:
        # Bt = 3 mod G (stores a word at a time) and VW mod G (16-byte
        # stores: the batch a multiple of the 16-byte width VW).
        # G, and the pairs where groups take over, are the library's own
        # (riccati_sweep_group), for each kernel.
        VW = 16 // (4 if dt == torch.float32 else 8)

        def sweep_batches(S, pdp):
            group = lambda Bt: cr.sweep_group(dt, NX, NU, NC, S * Bt,
                                              export_factors=True, pdp=pdp)
            G = group(1 << 30)
            past = G
            while group(past) == 0:
                past += G
            return (1, G - 1, G + 1, past + 3, past + VW)

        for Bt, Bt9 in zip(sweep_batches(1, False), sweep_batches(S_SMALL, True)):
            k1_in = random_stage_data(rng, N_SMALL, NX, NU, NC, Bt, dt, dev)
            compare(f"backward_lanes[group,B={Bt},export]", K1_ALL,
                    cr.backward_lanes(*k1_in, export_factors=True),
                    cr.backward_lanes_reference(*k1_in, export_factors=True))
            if Bt9 != Bt:
                k1_in = random_stage_data(rng, N_SMALL, NX, NU, NC, Bt9, dt, dev)
            k9_in = k1_in[:8] + random_carries(rng, S_SMALL, NX, Bt9, dt, dev)
            compare(f"backward_pdp_lanes[group,S={S_SMALL},B={Bt9},export]",
                    K9_ALL, cr.backward_pdp_lanes(*k9_in, export_factors=True,
                                                  segments=S_SMALL),
                    cr.backward_pdp_lanes_reference(
                        *k9_in, export_factors=True, segments=S_SMALL))

        # The narrow forms on bfloat16 stage streams (K1 gains only, K11,
        # K7, K12) on a full batch, an odd one (pairs at odd offsets; rows
        # no copy-engine box takes) and a ragged one (even, no multiple of
        # 8); their own generator, so the cases above see the same data.
        rng_n = np.random.default_rng(SEED + 3)
        for Bt in (B_SMALL, B_ODD, B_RAGGED):
            data = random_stage_data(rng_n, N_SMALL, NX, NU, NC, Bt, dt, dev)
            x0_n = torch.as_tensor(rng_n.normal(size=(NX, Bt)) * 0.3).to(
                device=dev, dtype=dt)
            narrow_cases(cr, compare, data, x0_n, NU, NC, f"B={Bt}")
        # ... and on two batches of K1's / K11's batch form (the ones
        # above take a block an instance).
        for Bt in narrow_group_batches(cr, dt, NX, NU, NC):
            data = random_stage_data(rng_n, N_SMALL, NX, NU, NC, Bt, dt, dev)
            x0_n = torch.as_tensor(rng_n.normal(size=(NX, Bt)) * 0.3).to(
                device=dev, dtype=dt)
            narrow_cases(cr, compare, data, x0_n, NU, NC, f"group,B={Bt}")
        # The narrow split kernels (K4, K5 both forms, K6) around the shared
        # model's factors, on a full batch (c by boxes), an odd one and a
        # ragged even one (2-byte loads); their own generator.
        rng_s = np.random.default_rng(SEED + 5)
        for Bt in (B_SMALL, B_ODD, B_RAGGED):
            narrow_split_cases(ca, compare, rng_s, A, Bm, K, M, L, Bt)

        torch.cuda.synchronize()
        launched = {k: cr.LAUNCHES[k] - before[k] for k in cr.LAUNCHES}
        n_p = len(pdp_batches)
        require(launched == {"backward_lanes": 10, "backward_vectors_lanes": 9,
                             "forward_lanes": 4 + n_p,
                             "forward_rollout_lanes": 2,
                             "backward_pdp_lanes": 5 + 2 * n_p,
                             "backward_pdp_vectors_lanes": n_p,
                             "backward_packed": n_p, "forward_packed": n_p,
                             "backward_lanes[bf16]": 5,
                             "forward_rollout_lanes[bf16]": 5,
                             "backward_packed[bf16]": 5,
                             "forward_packed[bf16]": 5},
                launched)
        launched = {k: ca.LAUNCHES[k] - before_admm[k] for k in ca.LAUNCHES}
        n_b = 3                                  # the narrow cases' batches
        require(launched == {"admm_bwd_vec_prefold_lanes": 2,
                             "admm_bwd_vec_lanes": 6,
                             "admm_fwd_update_lanes": 4 * len(K5_MODES) + 5,
                             "admm_iter_lanes": k8_cases,
                             "admm_bwd_vec_prefold_lanes[bf16]": n_b,
                             "admm_bwd_vec_lanes[bf16]":
                                 n_b * len(NARROW_RUNGS),
                             "admm_fwd_update_lanes[bf16]":
                                 n_b * (len(NARROW_K5_MODES)
                                        + len(NARROW_RUNGS))},
                launched)
    emit("kernels", card=card, shape={"N": N_SMALL, "B": B_SMALL, "nx": NX,
                                      "nu": NU, "nc": NC}, cases=cases)

    # ------------------ 3a: the examples, finished before anything is timed
    examples_phase(example_runs, card)

    # --------------------------------------------------- 3b: kernels_wide
    # Every kernel against its plain version at the mass-spring and
    # centroidal widths, float64 and float32, N=64, B=256 and 249.
    t0 = time.time()
    before = zero_counts() | {**cr.LAUNCHES, **ca.LAUNCHES}
    wide_cases, wide_timing = kernels_wide(ca, cr, dev)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in {**cr.LAUNCHES, **ca.LAUNCHES}.items()}
    require(all(n > 0 for n in launched.values()), launched)
    worst = {}
    for case in wide_cases:
        key = f"{case['kernel'].split('[')[0]}/{case['dtype']}"
        worst[key] = max(worst.get(key, 0.0), max(case["rel_err"].values()))
    emit("kernels_wide", card=card, widths={k: v[:4] for k, v in WIDE.items()},
         N=N_SMALL, B=list(B_WIDE), n_cases=len(wide_cases),
         worst_rel_err=worst, tol_rel={"float64": TOL[torch.float64],
                                       "float32": TOL[torch.float32]},
         launches=launched, seconds=round(time.time() - t0, 1))

    # ------------------------------- 3c: centroidal_lanes_bf16 (early: the
    # B=4096 request needs some 35 GB, before later phases hold theirs)
    narrow_entries = centroidal_lanes_bf16(plt_, ca, cr, dev, card)

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
    require(launches == {**{k: 0 for k in cr.LAUNCHES},
                         "backward_lanes": REQUESTS,
                         "backward_vectors_lanes": REQUESTS,
                         "forward_lanes": REQUESTS}, launches)
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
        **zero_counts(), "backward_lanes": 1,
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

    it32 = plt_.init_iterates(model, rho=RHO)

    # ------------------------------------------------ 8: the rho ladder
    # solve_admm with a four-rung ladder at full width, the admm_path
    # phase's data; the start state puts scenario b on rung b mod 4.
    st_lad = admm.ADMMSettings(**LADDER_SETTINGS)
    rung0 = torch.tensor([LADDER[b % len(LADDER)] for b in range(B_MAIN)],
                         dtype=torch.float64)
    ladder_state = lambda n, dt, device: zero_state(n, N_MAIN, NC, dt, device,
                                                    rung0[:n])
    lad_state = ladder_state(B_MAIN, torch.float32, dev)
    ladder_request = lambda: server.solve_admm(x0a_t, (), st_lad,
                                               state=lad_state, c=ca_t)
    ladder_request()                             # builds K6, K5's rung form
    torch.cuda.synchronize()
    reset_counts()
    with recorded_calls(ca, list(ca.LAUNCHES)) as lad_args:
        ws_l, state_l, info_l = ladder_request()
    torch.cuda.synchronize()
    ladder_launches = {**cr.LAUNCHES, **ca.LAUNCHES}
    ladder_reads = dict(admm.HOST_READS)
    require(ladder_launches == {**zero_counts(), "backward_lanes": 1,
                                "admm_bwd_vec_lanes": ADMM_ITERS,
                                "admm_fwd_update_lanes": ADMM_ITERS},
            ladder_launches)
    require(ws_l.shape == (B_MAIN, N_MAIN + 1, NX + NU) and state_l.factors is None)
    # No adaptation inside 20 iterations: every scenario keeps its rung.
    require(torch.equal(state_l.rho.cpu(), rung0.float()))
    ref_l = admm_outputs(*cpu_server.solve_admm(
        x0_a[:n_ref].astype(np.float64), (), st_lad,
        state=ladder_state(n_ref, torch.float64, "cpu"),
        c=c_a[:n_ref].astype(np.float64)))
    errs_l = admm_errors(admm_outputs(ws_l, state_l, info_l, n_ref), ref_l)
    require(max(errs_l.values()) <= LADDER_ATOL, errs_l)
    # The adapting run: the update after iterations 25 and 50 snaps each
    # scenario's rho to its nearest rung.
    reset_counts()
    out_la = server.solve_admm(
        x0a_t, (), dataclasses.replace(st_lad, max_iter=LADDER_ADAPT_ITERS),
        state=lad_state, c=ca_t)
    torch.cuda.synchronize()
    adapt_launches = {**cr.LAUNCHES, **ca.LAUNCHES}
    require(adapt_launches == {**zero_counts(), "backward_lanes": 1,
                               "admm_bwd_vec_lanes": LADDER_ADAPT_ITERS,
                               "admm_fwd_update_lanes": LADDER_ADAPT_ITERS},
            adapt_launches)
    rho_la = out_la[1].rho.cpu()
    rungs32 = torch.tensor(LADDER, dtype=torch.float32)
    require(bool(torch.isin(rho_la, rungs32).all()), "a rho off the rungs")
    require(bool(torch.isfinite(out_la[0]).all()), "adapting ladder: not finite")
    emit("admm_ladder", card=card, model="quadrotor constrained", N=N_MAIN,
         B=B_MAIN, dtype="float32", settings=LADDER_SETTINGS,
         launches=ladder_launches, host_reads=ladder_reads,
         max_abs_err_vs_plain_f64=errs_l,
         ref_max_magnitude={k: float(v.abs().max()) for k, v in ref_l.items()},
         atol=LADDER_ATOL, r_prim_max=float(info_l.r_prim.max()),
         adapting={"iterations": LADDER_ADAPT_ITERS, "launches": adapt_launches,
                   "rung_occupancy": {str(r): int((rho_la == r).sum())
                                      for r in rungs32.tolist()},
                   "scenarios_moved": int((rho_la != rung0.float()).sum()),
                   "converged": int(out_la[2].converged.sum())})

    # ------------------------------- 9: the ladder is the replicated loop
    # Per-instance rung rho, adaptation off, N=64, B=256, float64, both on
    # the card's kernels: the same function.
    m64, _ = quadrotor(N=N_SMALL, constrained=True, dtype=torch.float64,
                       device=dev)
    rng = np.random.default_rng(SEED + 2)
    x0_v = torch.as_tensor(0.03 + 0.01 * rng.normal(size=(B_SMALL, NX))).to(dev)
    c_v = torch.as_tensor(rng.normal(size=(B_SMALL, N_SMALL, NX)) * 0.01).to(dev)
    st_v = zero_state(B_SMALL, N_SMALL, NC, torch.float64, dev, rung0[:B_SMALL])
    st_fix = admm.ADMMSettings(**{**LADDER_SETTINGS, "adaptive_rho": False})
    reset_counts()
    out_v = plt_.solve_fused(dataclasses.replace(m64, c=c_v), x0_v, (), st_fix,
                             state=st_v)
    rep_v = plt_.solve_fused(batched(m64, B_SMALL, c_v), x0_v, (),
                             dataclasses.replace(st_fix, rho_ladder=()),
                             state=st_v, single_kernel=False)
    torch.cuda.synchronize()
    vs_launches = {**cr.LAUNCHES, **ca.LAUNCHES}
    require(vs_launches["admm_bwd_vec_lanes"] == ADMM_ITERS
            and vs_launches["forward_lanes"] == ADMM_ITERS, vs_launches)
    errs_v = admm_errors(admm_outputs(*out_v), admm_outputs(*rep_v))
    require(max(errs_v.values()) <= LADDER_VS_REPLICATED_ATOL, errs_v)
    emit("ladder_vs_replicated", card=card, N=N_SMALL, B=B_SMALL,
         dtype="float64", iterations=ADMM_ITERS, launches=vs_launches,
         max_abs_err=errs_v, atol=LADDER_VS_REPLICATED_ATOL)

    # ---------------------------- 10: the replicated per-instance loop
    # solve_fused on a batched problem (one model a scenario, the model
    # written out B_REP times, per-scenario drift): per-instance adaptive
    # rho, without and with cached factors.  First 8 scenarios against the
    # plain path in float64 on the CPU.
    bp_main = batched(model, B_REP, ca_t[:B_REP])
    x0_rep = x0a_t[:B_REP]
    bp_ref = batched(cpu_model, n_ref, torch.as_tensor(c_a[:n_ref]).double())
    rep = {}
    for cached in (False, True):
        st = admm.ADMMSettings(**REP_SETTINGS, cached_factors=cached)
        request = (lambda st=st: plt_.solve_fused(bp_main, x0_rep, (), st,
                                                  single_kernel=False))
        request()
        torch.cuda.synchronize()
        reset_counts()
        with recorded_calls(cr, list(cr.LAUNCHES)) as rec:
            out = request()
        torch.cuda.synchronize()
        counts = {**cr.LAUNCHES, **ca.LAUNCHES}
        want = ({"backward_lanes": 1, "backward_vectors_lanes": ADMM_ITERS - 1}
                if cached else {"backward_lanes": ADMM_ITERS})
        require(counts == {**zero_counts(), **want,
                           "forward_lanes": ADMM_ITERS}, counts)
        ref = admm_outputs(*plt_.solve_fused(
            bp_ref, x0_a[:n_ref].astype(np.float64), (), st,
            single_kernel=False))
        errs = admm_errors(admm_outputs(*out, n_ref), ref)
        require(max(errs.values()) <= REPLICATED_ATOL, errs)
        rep[cached] = {"request": request, "launches": counts, "args": dict(rec),
                       "host_reads": dict(admm.HOST_READS), "errs": errs,
                       "ref_max_magnitude": {k: float(v.abs().max())
                                             for k, v in ref.items()}}
    emit("admm_replicated", card=card, model="quadrotor constrained, batched",
         N=N_MAIN, B=B_REP, dtype="float32", settings=REP_SETTINGS,
         **{("cached" if c else "uncached"): {
             k: v for k, v in r.items() if k not in ("request", "args")}
            for c, r in rep.items()}, atol=REPLICATED_ATOL)

    # --------------------------------------------- 11: suggest_rho_ladder
    # The probe: 128 strided scenarios of the 4096 through the replicated
    # loop, 50 iterations (adaptation after 25 and 50).
    reset_counts()
    t0 = time.time()
    suggested = admm.suggest_rho_ladder(
        dataclasses.replace(model, c=ca_t), x0a_t, (),
        admm.ADMMSettings(**REP_SETTINGS), rungs=len(LADDER),
        probe_batch=PROBE_BATCH, probe_iters=PROBE_ITERS)
    probe_s = time.time() - t0
    probe_launches = {**cr.LAUNCHES, **ca.LAUNCHES}
    require(1 <= len(suggested) <= len(LADDER) and list(suggested) == sorted(suggested)
            and all(np.isfinite(r) and r > 0 for r in suggested), suggested)
    # The probe is solve_fused on a batched problem, single_kernel="auto":
    # K8.
    require(probe_launches["admm_iter_lanes"] == PROBE_ITERS, probe_launches)
    emit("suggest_rho_ladder", card=card, N=N_MAIN, B=B_MAIN,
         probe_batch=PROBE_BATCH, probe_iters=PROBE_ITERS, rungs=suggested,
         seconds=probe_s, launches=probe_launches)

    # ------------------------------------------------- 12: solve_lanes
    # The per-instance inner solve (K1 without closed-loop maps, then K7)
    # on the main path's data written out once a scenario: the same
    # answers as the shared solve, and the f64 sequential solver's.
    bl = batched(model, B_MAIN, c_t)
    it_b = plt_.ADMMIterates(**{f.name: getattr(it32, f.name)[None].expand(
        (B_MAIN,) + getattr(it32, f.name).shape) for f in dataclasses.fields(it32)})
    lanes_request = lambda: cr.solve_lanes(bl, it_b, x0_t, SIGMA)
    lanes_request()
    torch.cuda.synchronize()
    reset_counts()
    with recorded_calls(cr, list(cr.LAUNCHES)) as lanes_args:
        ws_lanes = lanes_request()
    torch.cuda.synchronize()
    lanes_launches = {**cr.LAUNCHES, **ca.LAUNCHES}
    require(lanes_launches == {**zero_counts(), "backward_lanes": 1,
                               "forward_rollout_lanes": 1}, lanes_launches)
    lanes_vs_shared = float((ws_lanes - ws).abs().max())
    lanes_vs_seq = float((ws_lanes[:n_ref].double() - ws_ref).abs().max())
    require(lanes_vs_shared <= LANES_VS_SHARED_ATOL, lanes_vs_shared)
    require(lanes_vs_seq <= MAIN_PATH_ATOL, lanes_vs_seq)
    emit("lanes_solve", card=card, N=N_MAIN, B=B_MAIN, dtype="float32",
         launches=lanes_launches, max_abs_err_vs_shared_solve=lanes_vs_shared,
         max_abs_err_vs_sequential_f64=lanes_vs_seq,
         atol={"vs_shared": LANES_VS_SHARED_ATOL, "vs_sequential": MAIN_PATH_ATOL})

    # ---------------------------- 13: the single-kernel iteration, one model
    # ScenarioServer.solve_admm's default path (settings without cached
    # factors): K8 an iteration, per-scenario adaptive rho, N=64, B=4096.
    model_k, _ = quadrotor(N=N_SINGLE, constrained=True, dtype=torch.float32,
                           device=dev)
    server_k = plt_.ScenarioServer(model_k, rho=RHO, sigma=SIGMA, device=dev)
    rng = np.random.default_rng(SEED)
    c_k = (rng.normal(size=(B_MAIN, N_SINGLE, NX)) * 0.01).astype(np.float32)
    x0_k = (0.03 + 0.01 * rng.normal(size=(B_MAIN, NX))).astype(np.float32)
    ck_t, x0k_t = (torch.as_tensor(x).to(dev) for x in (c_k, x0_k))
    st_single = admm.ADMMSettings(**SINGLE_SETTINGS)
    single_request = lambda: server_k.solve_admm(x0k_t, (), st_single, c=ck_t)
    single_request()                             # builds nothing new; warms up
    torch.cuda.synchronize()
    reset_counts()
    with recorded_calls(ca, ["admm_iter_lanes"]) as single_args:
        ws_k, state_k, info_k = single_request()
    torch.cuda.synchronize()
    single_launches = {**cr.LAUNCHES, **ca.LAUNCHES}
    single_reads = dict(admm.HOST_READS)
    require(single_launches == {**zero_counts(), "admm_iter_lanes": ADMM_ITERS},
            single_launches)
    require(ws_k.shape == (B_MAIN, N_SINGLE + 1, NX + NU) and state_k.factors is None)
    for x in (ws_k, state_k.z, state_k.rho, info_k.r_dual):
        require(x.dtype == torch.float32 and x.device.type == "cuda")
    cpu_k = plt_.ScenarioServer(model_k.to(device="cpu", dtype=torch.float64),
                                rho=RHO, sigma=SIGMA, device="cpu")
    ref_k = admm_outputs(*cpu_k.solve_admm(
        x0_k[:n_ref].astype(np.float64), (), st_single,
        c=c_k[:n_ref].astype(np.float64)))
    errs_k = admm_errors(admm_outputs(ws_k, state_k, info_k, n_ref), ref_k)
    require(max(errs_k.values()) <= SINGLE_ATOL, errs_k)
    single_t = timed(single_request, ADMM_TIMED_REQUESTS, B_MAIN)
    rows_k, busy_k, window_k = profiled(single_request, 5)
    emit("admm_single_shared", card=card, model="quadrotor constrained",
         N=N_SINGLE, B=B_MAIN, dtype="float32", settings=SINGLE_SETTINGS,
         launches=single_launches, host_reads=single_reads,
         max_abs_err_vs_plain_f64=errs_k,
         ref_max_magnitude={k: float(v.abs().max()) for k, v in ref_k.items()},
         atol=SINGLE_ATOL, **single_t,
         device_busy_ms_per_request=busy_k, window_ms_per_request=window_k,
         device_idle_share=1.0 - busy_k / window_k, by_kernel=rows_k[:6])

    # ------------------- 14: the single-kernel iteration on cached factors
    # The admm_path phase's workload (N=512, B=4096) on K8 with cached
    # factors at a uniform rho (split=False): K1 once, K8 an iteration; the
    # stage data as float32 and as bfloat16.
    st_sc = admm.ADMMSettings(**SINGLE_SETTINGS, cached_factors=True,
                              uniform_rho=True)
    model_c = dataclasses.replace(model, c=ca_t)
    cached_requests = {
        "float32": lambda: server.solve_admm(x0a_t, (), st_sc, c=ca_t,
                                             split=False),
        "bfloat16": lambda model_c=model_c: plt_.solve_fused(
            model_c, x0a_t, (), st_sc, single_kernel=True,
            storage_dtype=torch.bfloat16)}
    cpu_c = dataclasses.replace(cpu_model, c=torch.as_tensor(
        c_a[:n_ref]).double())
    sc = {}
    for name, request in cached_requests.items():
        request()
        torch.cuda.synchronize()
        reset_counts()
        with recorded_calls(ca, ["admm_iter_lanes"]) as rec:
            out = request()
        torch.cuda.synchronize()
        counts = {**cr.LAUNCHES, **ca.LAUNCHES}
        require(counts == {**zero_counts(), "backward_lanes": 1,
                           "admm_iter_lanes": ADMM_ITERS}, counts)
        require(out[1].factors[0].shape == (N_MAIN, NU, NX, 1))
        # The plain path on the same data (bfloat16-rounded alike).
        ref = admm_outputs(*plt_.solve_fused(
            cpu_c, x0_a[:n_ref].astype(np.float64), (), st_sc,
            single_kernel=True, storage_dtype=None if name == "float32"
            else torch.bfloat16))
        errs = admm_errors(admm_outputs(*out, n_ref), ref)
        require(max(errs.values()) <= SINGLE_ATOL, name, errs)
        sc[name] = {"request": request, "out": out, "args": dict(rec),
                    "launches": counts, "host_reads": dict(admm.HOST_READS),
                    "errs": errs}
    # What the bfloat16 rounding of the data moves, the whole batch.
    rounding = admm_errors(admm_outputs(*sc["bfloat16"]["out"]),
                           admm_outputs(*sc["float32"]["out"]))
    # Both requests timed here in turns, before the PDP phases fill the
    # card, with what one request of each makes the allocator do and reads
    # on the host.
    sc_early = {"turns_ms": in_turns({n: r["request"] for n, r in sc.items()},
                                     3),
                **{n: request_probe(r["request"], admm) for n, r in sc.items()}}
    # Cross-check: K8 on cached factors against the split pair (full Hs),
    # N=64, B=256, float64, rho adapting: the same function.
    m64c = dataclasses.replace(m64, c=c_v)
    st_x = admm.ADMMSettings(**CROSS_SETTINGS, cached_factors=True,
                             uniform_rho=True)
    reset_counts()
    x_k8 = plt_.solve_fused(m64c, x0_v, (), st_x, single_kernel=True)
    x_split = plt_.solve_fused(m64c, x0_v, (), st_x, single_kernel=False)
    torch.cuda.synchronize()
    x_launches = {**cr.LAUNCHES, **ca.LAUNCHES}
    require(x_launches["admm_iter_lanes"] == x_launches["admm_fwd_update_lanes"]
            == CROSS_SETTINGS["max_iter"], x_launches)
    errs_x = admm_errors(admm_outputs(*x_k8), admm_outputs(*x_split))
    require(max(errs_x.values()) <= SINGLE_CROSS_ATOL, errs_x)
    emit("admm_single_cached", card=card, model="quadrotor constrained",
         N=N_MAIN, B=B_MAIN, dtype="float32", settings=SINGLE_SETTINGS,
         **{name: {k: v for k, v in r.items()
                   if k not in ("request", "out", "args")}
            for name, r in sc.items()},
         atol=SINGLE_ATOL, bf16_vs_f32_storage=rounding, early=sc_early,
         vs_split_f64={"N": N_SMALL, "B": B_SMALL, "settings": CROSS_SETTINGS,
                       "launches": x_launches, "rho_end": float(x_k8[1].rho[0]),
                       "max_abs_err": errs_x, "atol": SINGLE_CROSS_ATOL})

    # --------------------- 14b: admm_split_bf16 and admm_ladder_bf16
    narrow_entries += admm_bf16_phases(
        plt_, admm, ca, cr, card, model, ca_t, x0a_t, c_a, x0_a, n_ref,
        settings, st_lad, ladder_state,
        {"admm_split_bf16": admm_request, "admm_ladder_bf16": ladder_request},
        sc["bfloat16"]["request"])

    # ----------------- 15: the single-kernel iteration on a batched problem
    # The N=64 model written out once a scenario (B=1024, per-scenario
    # drift): K8 uncached, on cached factors (K1 once, per instance), and on
    # cached factors with bfloat16 stage data.
    bp_k = batched(model_k, B_REP, ck_t[:B_REP])
    x0_rk = x0k_t[:B_REP]
    cpu_bk = batched(model_k.to(device="cpu", dtype=torch.float64), n_ref,
                     torch.as_tensor(c_k[:n_ref]).double())
    batched_variants = {"uncached": (False, None), "cached": (True, None),
                        "cached_bf16": (True, torch.bfloat16)}
    sb = {}
    for name, (cached, storage) in batched_variants.items():
        st = admm.ADMMSettings(**SINGLE_SETTINGS, cached_factors=cached)
        request = (lambda st=st, storage=storage: plt_.solve_fused(
            bp_k, x0_rk, (), st, single_kernel=True, storage_dtype=storage))
        request()
        torch.cuda.synchronize()
        reset_counts()
        with recorded_calls(ca, ["admm_iter_lanes"]) as rec:
            out = request()
        torch.cuda.synchronize()
        counts = {**cr.LAUNCHES, **ca.LAUNCHES}
        require(counts == {**zero_counts(), "backward_lanes": int(cached),
                           "admm_iter_lanes": ADMM_ITERS}, name, counts)
        ref = admm_outputs(*plt_.solve_fused(
            cpu_bk, x0_k[:n_ref].astype(np.float64), (), st,
            single_kernel=True, storage_dtype=storage))
        errs = admm_errors(admm_outputs(*out, n_ref), ref)
        require(max(errs.values()) <= SINGLE_ATOL, name, errs)
        sb[name] = {"request": request, "args": dict(rec), "launches": counts,
                    "host_reads": dict(admm.HOST_READS), "errs": errs}
    # Cross-check against the replicated loop (exact dual residual), N=64,
    # B=256, float64, rho adapting per scenario: the same function.
    bp_v = batched(m64, B_SMALL, c_v)
    cross_rep = {}
    for cached in (False, True):
        st = admm.ADMMSettings(**CROSS_SETTINGS, cached_factors=cached)
        reset_counts()
        a_k8 = plt_.solve_fused(bp_v, x0_v, (), st, single_kernel=True)
        a_rep = plt_.solve_fused(bp_v, x0_v, (), st, single_kernel=False)
        torch.cuda.synchronize()
        counts = {**cr.LAUNCHES, **ca.LAUNCHES}
        require(counts["admm_iter_lanes"] == counts["forward_lanes"]
                == CROSS_SETTINGS["max_iter"], counts)
        errs = admm_errors(admm_outputs(*a_k8), admm_outputs(*a_rep))
        require(max(errs.values()) <= SINGLE_CROSS_ATOL, cached, errs)
        cross_rep["cached" if cached else "uncached"] = {
            "launches": counts, "max_abs_err": errs,
            "rho_moved": int((a_k8[1].rho != CROSS_SETTINGS["rho"]).sum())}
    emit("admm_single_batched", card=card, model="quadrotor constrained, batched",
         N=N_SINGLE, B=B_REP, dtype="float32", settings=SINGLE_SETTINGS,
         **{name: {k: v for k, v in r.items() if k not in ("request", "args")}
            for name, r in sb.items()}, atol=SINGLE_ATOL,
         vs_replicated_f64={"N": N_SMALL, "B": B_SMALL, "settings": CROSS_SETTINGS,
                            "atol": SINGLE_CROSS_ATOL, **cross_rep})

    # --------------------------------------- 16: the rocket landing dispersion
    # examples/rocket_landing.py's Monte-Carlo section: B=512 dispersed entry
    # states, N=48, two second-order cones a stage, 150 iterations, rho
    # adapting per scenario every 10th; single_kernel="auto" resolves to K8.
    rk, rk_cones = rocket(N=N_ROCKET, dtype=torch.float32, device=dev)
    rk_cones = tuple(rk_cones)
    x0_rkt = rocket_x0(batch=B_ROCKET, dtype=torch.float32, device=dev)
    bp_rk = batched(rk, B_ROCKET, rk.c[None].expand((B_ROCKET,) + rk.c.shape))
    st_rk = admm.ADMMSettings(**ROCKET_SETTINGS)
    rocket_request = lambda: plt_.solve_fused(bp_rk, x0_rkt, rk_cones, st_rk)
    rocket_request()
    torch.cuda.synchronize()
    reset_counts()
    with recorded_calls(ca, ["admm_iter_lanes"]) as rocket_args:
        ws_rk, state_rk, info_rk = rocket_request()
    torch.cuda.synchronize()
    rocket_launches = {**cr.LAUNCHES, **ca.LAUNCHES}
    require(rocket_launches == {**zero_counts(), "admm_iter_lanes":
                                ROCKET_SETTINGS["max_iter"]}, rocket_launches)
    require(bool(torch.isfinite(ws_rk).all()), "rocket: not finite")
    rk64, _ = rocket(N=N_ROCKET, device="cpu")
    ref_rk = admm_outputs(*plt_.solve_fused(
        batched(rk64, n_ref, rk64.c[None].expand((n_ref,) + rk64.c.shape)),
        rocket_x0(batch=B_ROCKET, device="cpu")[:n_ref], rk_cones, st_rk))
    errs_rk = admm_errors(admm_outputs(ws_rk, state_rk, info_rk, n_ref), ref_rk)
    rel_rk = {k: v / max(1.0, float(ref_rk[k].abs().max()))
              for k, v in errs_rk.items()}
    require(max(rel_rk.values()) <= ROCKET_RTOL, rel_rk)
    touchdown = ws_rk[:, -1, 3:6].norm(dim=1)          # |r_N|, metres
    rocket_t = timed(rocket_request, 3, B_ROCKET)
    emit("rocket_dispersion", card=card, model="rocket soft landing",
         N=N_ROCKET, B=B_ROCKET, dtype="float32", settings=ROCKET_SETTINGS,
         cones=rk_cones, launches=rocket_launches,
         max_abs_err_vs_plain_f64=errs_rk, rel_err_vs_plain_f64=rel_rk,
         ref_max_magnitude={k: float(v.abs().max()) for k, v in ref_rk.items()},
         rtol=ROCKET_RTOL, request_ms=rocket_t["request_ms"],
         landings_per_s=rocket_t["solves_per_s"],
         converged_fraction=float(info_rk.converged.float().mean()),
         touchdown_m_p50=float(touchdown.median()),
         touchdown_m_max=float(touchdown.max()),
         vertical_velocity_worst=float(ws_rk[:, -1, 8].min()))

    # ------------------------------- 17: the segment-parallel PDP solve
    # parallel.pdp_sharded_fused.solve at full width: the main path's model
    # and data written out once a scenario (B=1024), rho 0.01 on the
    # constraint rows, the horizon in S=8 segments (K9 and K3 in segments
    # once a request, the condensed system in between).  Against
    # solve_lanes on the same data (the lanes phase's first 1024
    # scenarios) and against the f64 sequential solver (main path's).
    from pdp_lqr_tpu_torch.parallel import admm_sharded, make_mesh
    from pdp_lqr_tpu_torch.parallel import pdp_sharded_fused as psf
    PDP_KERNELS = ["backward_pdp_lanes", "backward_pdp_vectors_lanes",
                   "forward_lanes"]
    bp_pdp = batched(model, B_PDP, c_t[:B_PDP])
    it_pdp = plt_.ADMMIterates(**{f.name: getattr(it32, f.name)[None].expand(
        (B_PDP,) + getattr(it32, f.name).shape) for f in dataclasses.fields(it32)})
    x0_pdp = x0_t[:B_PDP]
    pdp_request = lambda S=S_PDP: psf.solve(make_mesh(time=S, device=dev),
                                            bp_pdp, it_pdp, x0_pdp, SIGMA)
    pdp_request()
    torch.cuda.synchronize()
    reset_counts()
    with recorded_calls(cr, PDP_KERNELS) as pdp_args:
        ws_pdp = pdp_request()
    torch.cuda.synchronize()
    pdp_launches = {**cr.LAUNCHES, **ca.LAUNCHES}
    require(pdp_launches == {**zero_counts(), "backward_pdp_lanes": 1,
                             "forward_lanes": 1}, pdp_launches)
    require(ws_pdp.shape == (B_PDP, N_MAIN + 1, NX + NU), ws_pdp.shape)
    require(ws_pdp.dtype == torch.float32 and ws_pdp.device.type == "cuda")
    require(bool(torch.isfinite(ws_pdp).all()), "pdp_solve: non-finite output")
    pdp_vs_lanes = float((ws_pdp - ws_lanes[:B_PDP]).abs().max())
    pdp_vs_seq = float((ws_pdp[:n_ref].double() - ws_ref).abs().max())
    require(pdp_vs_lanes <= PDP_VS_LANES_ATOL, pdp_vs_lanes)
    require(pdp_vs_seq <= MAIN_PATH_ATOL, pdp_vs_seq)
    pdp_by_S = {}
    for S in PDP_SEGMENTS:
        reset_counts()
        ws_S = pdp_request(S)
        torch.cuda.synchronize()
        require(cr.LAUNCHES["backward_pdp_lanes"] == 1, S, dict(cr.LAUNCHES))
        pdp_by_S[S] = {
            "max_abs_err_vs_lanes": float((ws_S - ws_lanes[:B_PDP]).abs().max()),
            "max_abs_err_vs_sequential_f64":
                float((ws_S[:n_ref].double() - ws_ref).abs().max())}
        require(pdp_by_S[S]["max_abs_err_vs_lanes"] <= PDP_VS_LANES_ATOL, S,
                pdp_by_S[S])
        require(pdp_by_S[S]["max_abs_err_vs_sequential_f64"] <= MAIN_PATH_ATOL,
                S, pdp_by_S[S])
    emit("pdp_solve", card=card, model="quadrotor constrained, batched",
         N=N_MAIN, B=B_PDP, S=S_PDP, dtype="float32", launches=pdp_launches,
         max_abs_err_vs_solve_lanes=pdp_vs_lanes,
         max_abs_err_vs_sequential_f64=pdp_vs_seq, by_segments=pdp_by_S,
         atol={"vs_lanes": PDP_VS_LANES_ATOL, "vs_sequential": MAIN_PATH_ATOL})

    # ----------------------------------- 18: the paper's long-horizon case
    # A few long-horizon instances (N=1024, B=128): one segment against 32,
    # and solve_lanes on the same data.
    model_lat, _ = quadrotor(N=N_LAT, constrained=True, dtype=torch.float32,
                             device=dev)
    rng = np.random.default_rng(SEED + 2)
    c_lat = torch.as_tensor(rng.normal(size=(B_LAT, N_LAT, NX)) * 0.01).to(
        device=dev, dtype=torch.float32)
    x0_lat = torch.as_tensor(rng.normal(size=(B_LAT, NX)) * 0.1).to(
        device=dev, dtype=torch.float32)
    bp_lat = batched(model_lat, B_LAT, c_lat)
    it_l = plt_.init_iterates(model_lat, rho=RHO)
    it_lat = plt_.ADMMIterates(**{f.name: getattr(it_l, f.name)[None].expand(
        (B_LAT,) + getattr(it_l, f.name).shape) for f in dataclasses.fields(it_l)})
    lat_lanes = lambda: cr.solve_lanes(bp_lat, it_lat, x0_lat, SIGMA)
    lat_request = {S: (lambda S=S: psf.solve(make_mesh(time=S, device=dev),
                                             bp_lat, it_lat, x0_lat, SIGMA))
                   for S in (1, S_LAT)}
    ws_lat_lanes = lat_lanes()
    lat = {}
    for S, request in lat_request.items():
        request()
        torch.cuda.synchronize()
        reset_counts()
        ws_S = request()
        torch.cuda.synchronize()
        counts = {**cr.LAUNCHES, **ca.LAUNCHES}
        require(counts == {**zero_counts(), "backward_pdp_lanes": 1,
                           "forward_lanes": 1}, S, counts)
        err = float((ws_S - ws_lat_lanes).abs().max())
        require(bool(torch.isfinite(ws_S).all()) and err <= PDP_VS_LANES_ATOL,
                S, err)
        lat[S] = {"launches": counts, "max_abs_err_vs_solve_lanes": err}
    emit("pdp_latency", card=card, model="quadrotor constrained, batched",
         N=N_LAT, B=B_LAT, dtype="float32", by_segments=lat,
         atol=PDP_VS_LANES_ATOL)

    # ------------------------------ 19: the conic ADMM loop on the PDP solve
    # parallel.admm_sharded.solve at full width: the thrust-cone quadrotor
    # with a shift (B=1024, N=512, S=8), the replicated loop's settings (20
    # iterations, rho 0.1, per-instance adaptation every 25th: none inside
    # 20), uncached (K9 + K3 every iteration) and cached (K9 once, K10 +
    # K3 every iteration); solve_fused's "auto" (K8) on the same data.
    # Then the same loop against the replicated loop in float64 on the
    # card (N=64, B=256, S=4, rho adapting every 10th iteration).
    model_cone, cones_c = quadrotor(N=N_MAIN, constrained=True,
                                    thrust_cone=True, dtype=torch.float32,
                                    device=dev)
    shift_c = np.zeros((N_MAIN + 1, NC_CONE), np.float32)
    shift_c[:, NC] = THRUST_SHIFT
    rng = np.random.default_rng(SEED + 3)
    c_pa = torch.as_tensor(rng.normal(size=(B_PDP, N_MAIN, NX)) * 0.01).to(
        device=dev, dtype=torch.float32)
    x0_pa = torch.as_tensor(rng.normal(size=(B_PDP, NX)) * 0.05).to(
        device=dev, dtype=torch.float32)
    bp_pa = batched(model_cone, B_PDP, c_pa)
    mesh_pa = make_mesh(time=S_PDP, device=dev)
    pa = {}
    for cached in (False, True):
        st = admm.ADMMSettings(**REP_SETTINGS, cached_factors=cached)
        request = (lambda st=st: admm_sharded.solve(
            mesh_pa, bp_pa, x0_pa, cones_c, st, soc_shift=shift_c))
        request()
        torch.cuda.synchronize()
        reset_counts()
        with recorded_calls(cr, PDP_KERNELS) as rec:
            out = request()
        torch.cuda.synchronize()
        counts = {**cr.LAUNCHES, **ca.LAUNCHES}
        want = ({"backward_pdp_lanes": 1,
                 "backward_pdp_vectors_lanes": ADMM_ITERS} if cached
                else {"backward_pdp_lanes": ADMM_ITERS})
        require(counts == {**zero_counts(), **want,
                           "forward_lanes": ADMM_ITERS}, cached, counts)
        require(out[0].shape == (B_PDP, N_MAIN + 1, NX + NU))
        for x in (out[0], out[1].z, out[1].y, out[1].rho, out[2].r_prim):
            require(x.dtype == torch.float32 and x.device.type == "cuda")
            require(bool(torch.isfinite(x).all()), "pdp_admm: not finite")
        require(bool((out[2].iterations == ADMM_ITERS).all()))
        pa[cached] = {"request": request, "args": dict(rec), "out": out,
                      "launches": counts, "host_reads": dict(admm.HOST_READS)}
    auto_pa = lambda: plt_.solve_fused(bp_pa, x0_pa, cones_c,
                                       admm.ADMMSettings(**REP_SETTINGS),
                                       soc_shift=shift_c)
    reset_counts()
    out_auto = auto_pa()
    torch.cuda.synchronize()
    require(ca.LAUNCHES["admm_iter_lanes"] == ADMM_ITERS, dict(ca.LAUNCHES))
    # float32 at N=512: the cached loop and K8's iteration against the
    # uncached loop (the same function three ways), reported.
    ref_pa = admm_outputs(*pa[False]["out"])
    pa_vs = {"cached": admm_errors(admm_outputs(*pa[True]["out"]), ref_pa),
             "single_kernel_auto": admm_errors(admm_outputs(*out_auto), ref_pa)}
    # float64 cross-check against the replicated loop on the card.
    m64c_s, _ = quadrotor(N=N_SMALL, constrained=True, thrust_cone=True,
                          dtype=torch.float64, device=dev)
    rng = np.random.default_rng(SEED + 4)
    c_x = torch.as_tensor(rng.normal(size=(B_SMALL, N_SMALL, NX)) * 0.01).to(dev)
    x0_x = torch.as_tensor(rng.normal(size=(B_SMALL, NX)) * 0.05).to(dev)
    bp_x = batched(m64c_s, B_SMALL, c_x)
    shift_x = shift_s.astype(np.float64)
    cross_pa = {}
    for cached in (False, True):
        st = admm.ADMMSettings(**CROSS_SETTINGS, cached_factors=cached)
        reset_counts()
        a_pdp = admm_sharded.solve(make_mesh(time=S_SMALL, device=dev), bp_x,
                                   x0_x, cones_c, st, soc_shift=shift_x)
        a_rep = plt_.solve_fused(bp_x, x0_x, cones_c, st, soc_shift=shift_x,
                                 single_kernel=False)
        torch.cuda.synchronize()
        counts = {**cr.LAUNCHES, **ca.LAUNCHES}
        require(counts["forward_lanes"] == 2 * CROSS_SETTINGS["max_iter"], counts)
        errs = admm_errors(admm_outputs(*a_pdp), admm_outputs(*a_rep))
        require(max(errs.values()) <= PDP_ADMM_CROSS_ATOL, cached, errs)
        cross_pa["cached" if cached else "uncached"] = {
            "launches": counts, "max_abs_err": errs,
            "rho_moved": int((a_pdp[1].rho != CROSS_SETTINGS["rho"]).sum())}
    emit("pdp_admm", card=card, model="quadrotor constrained + thrust cone, "
         "batched", N=N_MAIN, B=B_PDP, S=S_PDP, dtype="float32",
         settings=REP_SETTINGS, shift=THRUST_SHIFT,
         **{("cached" if c else "uncached"): {
             k: v for k, v in r.items() if k in ("launches", "host_reads")}
            for c, r in pa.items()},
         max_abs_err_vs_uncached_f32=pa_vs,
         r_prim_max=float(pa[False]["out"][2].r_prim.max()),
         vs_replicated_f64={"N": N_SMALL, "B": B_SMALL, "S": S_SMALL,
                            "settings": CROSS_SETTINGS,
                            "atol": PDP_ADMM_CROSS_ATOL, **cross_pa})

    # --------------------------------------------------- 20: solve_packed
    # The packed-stream pair (K11 + K12) on solve_lanes' workload (B=4096,
    # N=512, float32) against solve_lanes; and in float64 at N=64, B=256.
    packed_request = lambda: cr.solve_packed(bl, it_b, x0_t, SIGMA)
    packed_request()
    torch.cuda.synchronize()
    reset_counts()
    with recorded_calls(cr, ["backward_packed", "forward_packed"]) as pk_args:
        ws_pk = packed_request()
    torch.cuda.synchronize()
    packed_launches = {**cr.LAUNCHES, **ca.LAUNCHES}
    require(packed_launches == {**zero_counts(), "backward_packed": 1,
                                "forward_packed": 1}, packed_launches)
    packed_err = {"float32": float((ws_pk - ws_lanes).abs().max())}
    bp64 = batched(m64, B_SMALL, c_v)                 # N=64, float64
    it_s = plt_.init_iterates(m64, rho=RHO)
    it64b = plt_.ADMMIterates(**{f.name: getattr(it_s, f.name)[None].expand(
        (B_SMALL,) + getattr(it_s, f.name).shape) for f in dataclasses.fields(it_s)})
    packed_err["float64"] = float((cr.solve_packed(bp64, it64b, x0_v, SIGMA)
                                   - cr.solve_lanes(bp64, it64b, x0_v, SIGMA))
                                  .abs().max())
    for dt_name, dt_ in (("float32", torch.float32), ("float64", torch.float64)):
        require(packed_err[dt_name] <= PACKED_ATOL[dt_], dt_name, packed_err)
    emit("packed", card=card, N=N_MAIN, B=B_MAIN, dtype="float32",
         launches=packed_launches, max_abs_err_vs_solve_lanes=packed_err,
         atol={k: PACKED_ATOL[v] for k, v in (("float32", torch.float32),
                                              ("float64", torch.float64))})

    # -------------------------------- 20a: lanes_bf16 and packed_bf16
    # solve_lanes' and solve_packed's workload (``bench.py --bf16``: B=4096,
    # N=512, float32 compute) on bfloat16 stage streams, each beside its
    # full-width request; the two narrow pairs agree as the full ones do.
    quad = lambda dt, device: quadrotor(N=N_SMALL, constrained=True, dtype=dt,
                                        device=device)[0]
    ws_lb, entries = narrow_phase(
        "lanes_bf16", plt_, ca, cr, card, False, bl, it_b, x0_t, ws_lanes,
        quad, dev, TIMED_REQUESTS, TOL[torch.float32], "")
    narrow_entries += entries
    ws_pb, entries = narrow_phase(
        "packed_bf16", plt_, ca, cr, card, True, bl, it_b, x0_t, ws_pk,
        quad, dev, TIMED_REQUESTS, TOL[torch.float32], "")
    narrow_entries += entries
    # (Reported on the timing line.)
    narrow_pair_err = float((ws_pb - ws_lb).abs().max())
    require(narrow_pair_err <= PACKED_ATOL[torch.float32], narrow_pair_err)
    del ws_lb, ws_pb

    # ---------------------- 20b: the mass-spring and centroidal requests
    wide_req = wide_requests(plt_, admm, sequential, ca, cr, dev, card)

    # ------------------------------------- 20c: the reference-shaped API
    with cpu_threads(cpu_cores):
        reference_api(plt_, admm, sequential, dev, card)

    # ------------- 20d: the realtime operators, MPC loops, recovery, scaling
    realtime_dense(admm, mpc, realtime, dev, card)
    realtime_condensed(admm, mpc, realtime, dev, card)
    scenario_batch(admm, realtime, dev, card)
    mpc_loop(admm, mpc, realtime, dev, card)
    recovery_launches = recovery_phase(plt_, recovery, sequential, ca, cr,
                                       model, c_t, x0_t, it32, dev, card)
    equilibrated(admm, dev, card)

    # ------- 20e: the segments in torch ops, the g++ witness and the mesh
    # over ranks (two ranks sharing the card over gloo; NCCL at a world of
    # one)
    pdp_sharded_phase(plt_, sequential, dev, card)
    native_phase(plt_, cr, dev, card)
    multirank_phase(plt_, admm, dev, card)

    # ---------------------------------------------------------- 21: timing
    # Peak device memory of a path: the largest allocation while its
    # requests are timed, the tensors that earlier phases still hold included.
    torch.cuda.reset_peak_memory_stats()
    solve_ms = cuda_ms(lambda: server.solve(x0_t, c_t), TIMED_REQUESTS)
    solve_peak = torch.cuda.max_memory_allocated()

    # The kernels alone, on the tensors the main path hands them.
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

    # The rho ladder's pair, the replicated loop's per-instance K1 / K2 /
    # K3 and solve_lanes' K1 / K7, on the tensors of their counted runs.
    K6, K7 = "admm_bwd_vec_lanes", "forward_rollout_lanes"
    k6_args, k6_kw = lad_args[K6]
    l5, l5_kw = lad_args[K5]
    k5r_in = (l5[0], l5[1], l5[2], l5[4], l5[5], l5[6], l5[10], l5[11], None)
    rung_l = l5_kw["rung"]
    r1_args, r1_kw = rep[False]["args"]["backward_lanes"]
    r3_args, _ = rep[False]["args"]["forward_lanes"]
    r2_args, _ = rep[True]["args"]["backward_vectors_lanes"]
    g1_args, g1_kw = lanes_args["backward_lanes"]
    k7_args, _ = lanes_args[K7]
    # K8 on the tensors of the last iteration of each of its counted runs:
    # entry -> (path, recorded (args, kwargs)).
    K8 = "admm_iter_lanes"
    k8_runs = {
        "[shared]": ("admm_single_shared", single_args[K8]),
        "[shared,cached]": ("admm_single_cached", sc["float32"]["args"][K8]),
        "[shared,cached,bf16]": ("admm_single_cached_bf16",
                                 sc["bfloat16"]["args"][K8]),
        "[batched]": ("admm_single_batched", sb["uncached"]["args"][K8]),
        "[batched,cached]": ("admm_single_batched_cached",
                             sb["cached"]["args"][K8]),
        "[batched,cached,bf16]": ("admm_single_batched_cached_bf16",
                                  sb["cached_bf16"]["args"][K8]),
        "[rocket]": ("rocket_dispersion", rocket_args[K8]),
    }

    # name: (launch counter, paths, kernel, plain version, output names,
    # operations, TPU kernel it replaces).
    spec = {
        "backward_lanes": (
            "backward_lanes", ("solve", "solve_admm", "admm_ladder",
                               "admm_single_cached", "admm_single_cached_bf16"),
            lambda: cr.backward_lanes(*k1_in, export_factors=True),
            lambda: cr.backward_lanes_reference(*k1_in, export_factors=True),
            K1_ALL, k1_flops(N_MAIN, NX, NU, NC, 1), "pallas_riccati.py:778"),
        "backward_vectors_lanes": (
            "backward_vectors_lanes", ("solve",),
            lambda: cr.backward_vectors_lanes(*k2_in, shared=True, Pc=Pc),
            lambda: cr.backward_vectors_lanes_reference(*k2_in, Pc=Pc),
            K2_OUT, k2_flops(N_MAIN, NX, NU, B_MAIN), "pallas_riccati.py:1023"),
        "forward_lanes": (
            "forward_lanes", ("solve",),
            lambda: cr.forward_lanes(*k3_in, shared=True),
            lambda: cr.forward_lanes_reference(*k3_in),
            K3_OUT, k3_flops(N_MAIN, NX, NU, B_MAIN), "pallas_riccati.py:1201"),
        K4: (K4, ("solve_admm",),
             lambda: [ca.admm_bwd_vec_prefold_lanes(*k4_args, **k4_kw)],
             lambda: [ca.admm_bwd_vec_prefold_lanes_reference(*k4_args, **k4_kw)],
             K4_OUT, k2_flops(N_MAIN, NX, NU, B_MAIN),   # K2's recursion
             "pallas_admm.py:526"),
        K5: (K5, ("solve_admm",), lambda: k5_call(ca, k5_in, ()),
             lambda: k5_plain(ca, k5_in, ()), K5_OUT,
             k5_flops(N_MAIN, NX, NU, NC, B_MAIN, ADMM_SETTINGS["diag_cost"]),
             "pallas_admm.py:867"),
        K6: (K6, ("admm_ladder",),
             lambda: [ca.admm_bwd_vec_lanes(*k6_args, **k6_kw)],
             lambda: [ca.admm_bwd_vec_lanes_reference(*k6_args, **k6_kw)],
             K6_OUT, k6_flops(N_MAIN, NX, NU, NC, B_MAIN), "pallas_admm.py:766"),
        K5 + "[rung]": (
            K5, ("admm_ladder",),
            lambda: k5_call(ca, k5r_in, (), K=l5[3], rung=rung_l),
            lambda: k5_plain(ca, k5r_in, (), K=l5[3], rung=rung_l),
            K5_RUNG_OUT,
            k5_flops(N_MAIN, NX, NU, NC, B_MAIN, True, emit_hf=False),
            "pallas_admm.py:867"),
        K7: (K7, ("lanes_solve", "recovery"),
             lambda: cr.forward_rollout_lanes(*k7_args),
             lambda: cr.forward_rollout_lanes_reference(*k7_args), K3_OUT,
             k7_flops(N_MAIN, NX, NU, B_MAIN), "pallas_riccati.py:1319"),
        "backward_lanes[per-instance]": (
            "backward_lanes", ("admm_replicated", "admm_replicated_cached",
                               "admm_single_batched_cached",
                               "admm_single_batched_cached_bf16"),
            lambda: cr.backward_lanes(*r1_args, **r1_kw),
            lambda: cr.backward_lanes_reference(*r1_args, **r1_kw),
            K1_CLOSED, k1_flops(N_MAIN, NX, NU, NC, B_REP),
            "pallas_riccati.py:778"),
        "backward_lanes[per-instance,gains]": (
            "backward_lanes", ("lanes_solve", "recovery"),
            lambda: cr.backward_lanes(*g1_args, **g1_kw),
            lambda: cr.backward_lanes_reference(*g1_args, **g1_kw),
            K1_GAINS, k1_flops(N_MAIN, NX, NU, NC, B_MAIN),
            "pallas_riccati.py:778"),
        "backward_vectors_lanes[per-instance]": (
            "backward_vectors_lanes", ("admm_replicated_cached",),
            lambda: cr.backward_vectors_lanes(*r2_args),
            lambda: cr.backward_vectors_lanes_reference(*r2_args), K2_OUT,
            k2_flops(N_MAIN, NX, NU, B_REP), "pallas_riccati.py:1023"),
        "forward_lanes[per-instance]": (
            "forward_lanes", ("admm_replicated", "admm_replicated_cached"),
            lambda: cr.forward_lanes(*r3_args),
            lambda: cr.forward_lanes_reference(*r3_args), K3_OUT,
            k3_flops(N_MAIN, NX, NU, B_REP), "pallas_riccati.py:1201"),
    }
    # The PDP paths' kernels and the packed pair, on the tensors of their
    # counted runs (K9 of the S=8 solve and of the cached loop's factor
    # build, K10 of the cached loop, K3 in segments of the solve).
    K9, K10 = "backward_pdp_lanes", "backward_pdp_vectors_lanes"
    k9_args, k9_kw = pdp_args[K9]
    k3s_args, k3s_kw = pdp_args["forward_lanes"]
    k9e_args, k9e_kw = pa[True]["args"][K9]
    k10_args, k10_kw = pa[True]["args"][K10]
    k11_args, _ = pk_args["backward_packed"]
    k12_args, _ = pk_args["forward_packed"]
    spec.update({
        K9: (K9, ("pdp_solve", "pdp_admm"),
             lambda: cr.backward_pdp_lanes(*k9_args, **k9_kw),
             lambda: cr.backward_pdp_lanes_reference(*k9_args, **k9_kw),
             K9_OUT, k9_flops(N_MAIN, NX, NU, NC, B_PDP),
             "pallas_riccati.py:481"),
        K9 + "[export]": (
            K9, ("pdp_admm_cached",),
            lambda: cr.backward_pdp_lanes(*k9e_args, **k9e_kw),
            lambda: cr.backward_pdp_lanes_reference(*k9e_args, **k9e_kw),
            K9_ALL, k9_flops(N_MAIN, NX, NU, NC_CONE, B_PDP),
            "pallas_riccati.py:481"),
        K10: (K10, ("pdp_admm_cached",),
              lambda: cr.backward_pdp_vectors_lanes(*k10_args, **k10_kw),
              lambda: cr.backward_pdp_vectors_lanes_reference(*k10_args,
                                                              **k10_kw),
              K10_OUT, k10_flops(N_MAIN, NX, NU, B_PDP),
              "pallas_riccati.py:644"),
        "forward_lanes[segments]": (
            "forward_lanes", ("pdp_solve", "pdp_admm", "pdp_admm_cached"),
            lambda: cr.forward_lanes(*k3s_args, **k3s_kw),
            lambda: cr.forward_lanes_reference(*k3s_args, **k3s_kw), K3_OUT,
            k3_flops(N_MAIN, NX, NU, B_PDP), "pallas_riccati.py:1201"),
        "backward_packed": (
            "backward_packed", ("packed_solve",),
            lambda: [cr.backward_packed(*k11_args)],
            lambda: [cr.backward_packed_reference(*k11_args)], ("G",),
            k1_flops(N_MAIN, NX, NU, NC, B_MAIN), "pallas_riccati.py:1485"),
        "forward_packed": (
            "forward_packed", ("packed_solve",),
            lambda: cr.forward_packed(*k12_args),
            lambda: cr.forward_packed_reference(*k12_args), K3_OUT,
            k7_flops(N_MAIN, NX, NU, B_MAIN), "pallas_riccati.py:1543"),
    })
    # What each kernel reads (each input once; its outputs are added below).
    args_of = {"backward_lanes": k1_in, "backward_vectors_lanes": (
                   A_sh, B_sh, c_l, hf_l, Pc, K, L, pN_l),   # P is not read
               "forward_lanes": k3_in, K4: k4_args, K5: k5_in,
               K6: k6_args + (rung_l,), K5 + "[rung]": k5r_in + (l5[3], rung_l),
               K7: k7_args, "backward_lanes[per-instance]": r1_args,
               "backward_lanes[per-instance,gains]": g1_args,
               "backward_vectors_lanes[per-instance]": r2_args,
               "forward_lanes[per-instance]": r3_args,
               K9: k9_args, K9 + "[export]": k9e_args, K10: k10_args,
               "forward_lanes[segments]": k3s_args,
               "backward_packed": k11_args[:4], "forward_packed": k12_args[:3]}
    for tag, (path, (a8, kw8)) in k8_runs.items():
        plain_kw = {k: v for k, v in kw8.items() if k != "shared"}
        cached8 = kw8["factors"] is not None
        spec[K8 + tag] = (
            K8, (path,), lambda a8=a8, kw8=kw8: ca.admm_iter_lanes(*a8, **kw8),
            lambda a8=a8, kw=plain_kw: ca.admm_iter_lanes_reference(*a8, **kw),
            K8_OUT, k8_flops(a8[0].shape[0], a8[0].shape[1], kw8["nu"],
                             a8[5].shape[1], a8[10].shape[-1], cached8),
            "pallas_admm.py:1069")
        # PN is not read on cached factors.
        args_of[K8 + tag] = tuple(x for i, x in enumerate(a8)
                                  if not (cached8 and i == 14)) \
            + tuple(kw8["factors"] or ())
    # Each path counted from zero: REQUESTS requests of `solve`, one
    # 20-iteration request of `solve_admm`, of the ladder, of each
    # replicated and single-kernel variant, one `solve_lanes`, one rocket
    # dispersion.
    path_launches = {"solve": launches, "solve_admm": admm_launches,
                     "admm_ladder": ladder_launches,
                     "admm_replicated": rep[False]["launches"],
                     "admm_replicated_cached": rep[True]["launches"],
                     "lanes_solve": lanes_launches,
                     "recovery": recovery_launches,
                     "admm_single_shared": single_launches,
                     "admm_single_cached": sc["float32"]["launches"],
                     "admm_single_cached_bf16": sc["bfloat16"]["launches"],
                     "admm_single_batched": sb["uncached"]["launches"],
                     "admm_single_batched_cached": sb["cached"]["launches"],
                     "admm_single_batched_cached_bf16":
                         sb["cached_bf16"]["launches"],
                     "rocket_dispersion": rocket_launches,
                     "pdp_solve": pdp_launches,
                     "pdp_admm": pa[False]["launches"],
                     "pdp_admm_cached": pa[True]["launches"],
                     "packed_solve": packed_launches}
    kernels = []
    for name, (counter, paths, kernel, plain, names, flops, replaces) in spec.items():
        out = kernel()
        ms = cuda_ms(kernel, TIMED_REQUESTS)
        ref, plain_ms = event_ms(plain)          # the plain version, once
        abs_err, rel = rel_err(names, out, ref)
        require(max(rel.values()) <= TOL[torch.float32], (name, abs_err, rel))
        moved = nbytes(*args_of[name], *out)
        bound_ms, bound_by = bound(moved, flops)
        by_path = {p: path_launches[p][counter] for p in paths}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "pdp_lqr_tpu_torch/ops/csrc/" + (
                ca.SOURCE if counter in ca.LAUNCHES else cr.SOURCE),
            "replaces": "pdp_lqr_tpu/ops/" + replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": abs_err, "rel_err": rel, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            # No single PyTorch call computes a stage recurrence.
            "library_ms": None,
            "bytes": moved, "flops": flops,
        })
    # The wide models' kernels: on the tensors of the four wide requests
    # (launches from each request's counted run), then every kernel at
    # both widths on the kernels_wide phase's float32 tensors (N=64,
    # B=256, timed in that phase; on no path of the wide requests:
    # launched no time there).
    wide_spec = {name: (counter, (phase,), call, plain, names, flops, inputs,
                        replaces)
                 for name, (counter, phase, call, plain, names, flops, inputs,
                            replaces) in wide_kernel_specs(
                     ca, cr, wide_req).items()}
    for width, wspec in wide_timing.items():
        for name, e in wspec.items():
            bound_ms, bound_by = bound(e["bytes"], e["flops"])
            kernels.append({
                "name": f"{name}[{width},N={N_SMALL},B={B_SMALL}]",
                "route": "cuda", "source": "pdp_lqr_tpu_torch/ops/csrc/" + (
                    ca.SOURCE if e["counter"] in ca.LAUNCHES else cr.SOURCE),
                "replaces": "pdp_lqr_tpu/ops/" + e["replaces"],
                "launches": 0, "launches_by_path": {},
                "max_abs_err": e["max_abs_err"], "rel_err": e["rel_err"],
                "ms": e["ms"], "plain_ms": e["plain_ms"], "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None, "bytes": e["bytes"],
                "flops": e["flops"]})
    for name, (counter, phases, kernel, plain, names, flops, inputs,
               replaces) in wide_spec.items():
        out = kernel()
        ms = cuda_ms(kernel, WIDE_TIMED_REQUESTS)
        ref, plain_ms = event_ms(plain)
        abs_err, rel = rel_err(names, out, ref)
        require(max(rel.values()) <= WIDE_KERNEL_RTOL, (name, abs_err, rel))
        moved = nbytes(*(x for x in inputs if isinstance(x, torch.Tensor)),
                       *out)
        bound_ms, bound_by = bound(moved, flops)
        by_path = {p: wide_req[p][0][counter] for p in phases}
        if phases:
            require(sum(by_path.values()) > 0, name, by_path)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "pdp_lqr_tpu_torch/ops/csrc/" + (
                ca.SOURCE if counter in ca.LAUNCHES else cr.SOURCE),
            "replaces": "pdp_lqr_tpu/ops/" + replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": abs_err, "rel_err": rel, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "bytes": moved, "flops": flops,
        })
    # The narrow forms: timed in their phases, on those phases' tensors.
    kernels += narrow_entries
    fold_ms = cuda_ms(lambda: cr.fold_Pc(P, c_l), TIMED_REQUESTS)
    prep_ms = cuda_ms(lambda: cr.prepare_shared(
        dataclasses.replace(model, c=c_t), it32, x0_t, SIGMA), TIMED_REQUESTS)
    # The requests, whole; for the split loops what an iteration costs
    # beside its two kernels (the terminal stage, the statistics, the
    # host's launches, and a 20th of the request's set-up and factor build).
    kernel_ms = {k["name"]: k["ms"] for k in kernels}

    admm_t = timed(admm_request, ADMM_TIMED_REQUESTS, B_MAIN)
    warm_ms = cuda_ms(warm_tick, ADMM_TIMED_REQUESTS)
    ladder_t = timed(ladder_request, ADMM_TIMED_REQUESTS, B_MAIN)
    rep_t = {c: timed(rep[c]["request"], ADMM_TIMED_REQUESTS, B_REP)
             for c in (False, True)}
    lanes_t = timed(lanes_request, TIMED_REQUESTS, B_MAIN)
    sc_t = {name: timed(r["request"], ADMM_TIMED_REQUESTS, B_MAIN)
            for name, r in sc.items()}
    # The requests timed here must be the ones counted in their own phase:
    # a later phase that rebound a name a request reads would time another
    # problem.
    shapes = lambda call: [tuple(x.shape) for x in call[0] if x is not None]
    for name, r in sc.items():
        with recorded_calls(ca, [K8]) as rec:
            r["request"]()
        require(shapes(rec[K8]) == shapes(r["args"][K8]), name, "changed")
    sb_t = {name: timed(r["request"], ADMM_TIMED_REQUESTS, B_REP)
            for name, r in sb.items()}
    # single_kernel="auto" on a batched problem: K8 against the replicated
    # loop at B=1024, N=64 and N=512, uncached and cached (the settings of
    # both are SINGLE_SETTINGS; two of the eight are timed above).
    auto_ms = {}
    for n_, bp_, x0_ in ((N_SINGLE, bp_k, x0_rk), (N_MAIN, bp_main, x0_rep)):
        for cached in (False, True):
            st = admm.ADMMSettings(**SINGLE_SETTINGS, cached_factors=cached)
            for single in (True, False):
                key = (f"N={n_},{'cached' if cached else 'uncached'},"
                       f"{'K8' if single else 'replicated'}")
                if n_ == N_SINGLE and single:
                    auto_ms[key] = sb_t["cached" if cached else "uncached"][
                        "request_ms"]
                elif n_ == N_MAIN and not single:
                    auto_ms[key] = rep_t[cached]["request_ms"]
                else:
                    auto_ms[key] = cuda_ms(
                        lambda: plt_.solve_fused(bp_, x0_, (), st,
                                                 single_kernel=single), 5,
                        warmup=1)
    # The PDP paths: the solve at S=8 (and once at each S of the sweep),
    # the condensed system of its boundaries alone (device time and the
    # host's time to enqueue it), the long-horizon case, the ADMM loop
    # beside K8's at the same data, and the packed pair.
    from pdp_lqr_tpu_torch.ops import condensed
    pdp_t = timed(pdp_request, TIMED_REQUESTS, B_PDP)
    pdp_S_ms = {S: cuda_ms(lambda S=S: pdp_request(S), 3, warmup=1)
                for S in PDP_SEGMENTS}
    _, _, _, _, _, P0_, p0_, F0_, C0_, f0_ = cr.backward_pdp_lanes(*k9_args,
                                                                   **k9_kw)
    bm = lambda x: torch.movedim(x, -1, 0)

    def condensed_solve():
        fac_ = condensed.cholesky_backward(bm(P0_), bm(F0_), bm(C0_))
        return condensed.cholesky_forward(fac_, bm(p0_), bm(f0_), x0_pdp)

    condensed_ms = cuda_ms(condensed_solve, TIMED_REQUESTS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_REQUESTS):
        condensed_solve()
    condensed_enqueue_ms = (time.perf_counter() - t0) * 1e3 / TIMED_REQUESTS
    torch.cuda.synchronize()
    lat_t = {S: timed(r, 5, B_LAT) for S, r in lat_request.items()}
    lat_lanes_t = timed(lat_lanes, 5, B_LAT)
    pa_t = {c: timed(pa[c]["request"], ADMM_TIMED_REQUESTS, B_PDP)
            for c in (False, True)}
    pa_auto_t = timed(auto_pa, ADMM_TIMED_REQUESTS, B_PDP)
    packed_t = timed(packed_request, TIMED_REQUESTS, B_MAIN)
    beside = lambda t, kA, kB, fac: (t["request_ms"] - fac) / ADMM_ITERS \
        - kernel_ms[kA] - kernel_ms.get(kB, 0.0)
    emit("timing", card=card, N=N_MAIN, B=B_MAIN, dtype="float32",
         requests=TIMED_REQUESTS, solve_ms=solve_ms,
         solves_per_s=B_MAIN / (solve_ms * 1e-3),
         kernel_ms=kernel_ms,
         glue_ms={"Pc_fold": fold_ms, "prepare_shared": prep_ms},
         peak_memory_bytes=solve_peak,
         admm={"requests": ADMM_TIMED_REQUESTS, "iterations": ADMM_ITERS,
               **admm_t,
               "iterations_per_s": ADMM_ITERS / (admm_t["request_ms"] * 1e-3),
               "ms_per_iteration_beside_kernels": beside(
                   admm_t, K4, K5, kernel_ms["backward_lanes"]),
               "host_reads_per_request": host_reads,
               "warm_tick_ms": warm_ms, "warm_iterations": warm_iters,
               "warm_ticks_per_s": 1e3 / warm_ms,
               "warm_solves_per_s": B_MAIN / (warm_ms * 1e-3),
               "warm_host_reads_per_tick": warm_reads},
         admm_ladder={"requests": ADMM_TIMED_REQUESTS, "iterations": ADMM_ITERS,
                      "rungs": len(LADDER), **ladder_t,
                      "ms_per_iteration_beside_kernels": beside(
                          ladder_t, K6, K5 + "[rung]",
                          kernel_ms["backward_lanes"]),
                      "host_reads_per_request": ladder_reads},
         admm_replicated={"B": B_REP, "iterations": ADMM_ITERS,
                          "uncached": {**rep_t[False], "host_reads_per_request":
                                       rep[False]["host_reads"]},
                          "cached": {**rep_t[True], "host_reads_per_request":
                                     rep[True]["host_reads"]}},
         lanes_solve=lanes_t, suggest_rho_ladder_s=probe_s,
         admm_single_shared={"N": N_SINGLE, "iterations": ADMM_ITERS,
                             **single_t,
                             "ms_per_iteration_beside_kernel": beside(
                                 single_t, K8 + "[shared]", None, 0.0),
                             "host_reads_per_request": single_reads,
                             "device_idle_share": 1.0 - busy_k / window_k},
         admm_single_cached={"N": N_MAIN, "iterations": ADMM_ITERS, **{
             name: {**t, "ms_per_iteration_beside_kernel": beside(
                 t, K8 + ("[shared,cached]" if name == "float32"
                          else "[shared,cached,bf16]"), None,
                 kernel_ms["backward_lanes"]),
                 "host_reads_per_request": sc[name]["host_reads"]}
             for name, t in sc_t.items()}},
         admm_single_batched={"N": N_SINGLE, "B": B_REP,
                              "iterations": ADMM_ITERS, **{
             name: {**t, "host_reads_per_request": sb[name]["host_reads"]}
             for name, t in sb_t.items()}},
         auto_rule={"B": B_REP, "request_ms": auto_ms},
         rocket_dispersion={"N": N_ROCKET, "B": B_ROCKET, **rocket_t,
                            "landings_per_s": rocket_t["solves_per_s"]},
         pdp_solve={"B": B_PDP, "S": S_PDP, **pdp_t,
                    "request_ms_by_segments": pdp_S_ms,
                    "condensed_ms": condensed_ms,
                    "condensed_enqueue_ms": condensed_enqueue_ms,
                    "solve_lanes_ms_B4096": lanes_t["request_ms"]},
         pdp_latency={"N": N_LAT, "B": B_LAT,
                      **{f"S={S}": t for S, t in lat_t.items()},
                      "solve_lanes": lat_lanes_t},
         pdp_admm={"B": B_PDP, "S": S_PDP, "iterations": ADMM_ITERS,
                   "uncached": pa_t[False], "cached": pa_t[True],
                   "single_kernel_auto": pa_auto_t},
         packed={"B": B_MAIN, **packed_t, "solve_lanes": lanes_t},
         lanes_vs_packed_bf16_max_abs_err=narrow_pair_err,
         elapsed_s=time.time() - t_start)

    # ------------------------------------------------------------ 22: end
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
