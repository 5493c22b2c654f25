"""The port's six examples (``examples/torch_*.py``) on the CPU.

Each example runs in this process on ``--device cpu`` at tiny arguments
(its ``run`` returns the figures it prints), and the figures, not its
times, are held against the same JAX library calls at the same
arguments: float64 to 1e-9 where the example takes the dtype, float32 to
1e-4 relative (of the figure's own magnitude, or 1).  The JAX calls run
once each, in a thread pool (JAX releases the interpreter while it
computes).  ``torch_latency_mpc.py`` prints only times: it must run to
its end.  No test needs CUDA; the examples' card defaults run in
``chip_smoke.py``'s ``examples`` phase.
"""

import concurrent.futures
import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdp_lqr_tpu import init_iterates as jinit_iterates
from pdp_lqr_tpu import mpc as jmpc
from pdp_lqr_tpu.models import quadrotor as jquadrotor
from pdp_lqr_tpu.models import rocket as jrocket
from pdp_lqr_tpu.models import rocket_x0 as jrocket_x0
from pdp_lqr_tpu.solvers import admm as jadmm
from pdp_lqr_tpu.solvers import realtime as jrealtime
from pdp_lqr_tpu.solvers import sequential as jsequential
from pdp_lqr_tpu.utils import oracle as joracle
from pdp_lqr_tpu.utils import profiling as jprofiling
from pdp_lqr_tpu.utils import quality as jquality

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
F64_ATOL = 1e-9
F32_RTOL = 1e-4

# Each example's tiny arguments.
ARGS = {
    "torch_lqr_example": ["--horizon", "20", "--f64"],
    "torch_constrained_mpc": ["--horizon", "8", "--steps", "3"],
    "torch_constrained_mpc_f64": ["--horizon", "8", "--steps", "3", "--f64"],
    "torch_constrained_mpc_cone": ["--horizon", "8", "--steps", "3",
                                   "--thrust-cone", "--f64"],
    "torch_rocket_landing": ["--horizon", "8", "--batch", "2", "--steps", "2",
                             "--iters", "1"],
    "torch_scenario_mpc": ["--horizon", "8", "--batch", "2", "--reps", "1"],
    "torch_scenario_mpc_shared": ["--horizon", "8", "--batch", "2", "--reps",
                                  "1", "--shared-dynamics"],
    "torch_roofline_report": ["--batch", "4", "--horizon", "8"],
    "torch_latency_mpc": ["--horizon", "8", "--admm-iters", "2", "--batch",
                          "2"],
}


def _stem(name):
    """The example file of a case."""
    for tag in ("_cone", "_shared", "_f64"):
        name = name.split(tag)[0]
    return name


def _module(name):
    stem = _stem(name)
    spec = importlib.util.spec_from_file_location(stem, EXAMPLES / f"{stem}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def port():
    """Every example's figures (run in this process, one torch thread: the
    tensors are tiny)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        for name, argv in ARGS.items():
            mod = _module(name)
            argv = argv + ["--device", "cpu"]
            if name == "torch_latency_mpc":
                out[name] = mod.main(argv)
            else:
                out[name] = mod.run(mod.parse_args(argv))
        return out
    finally:
        torch.set_num_threads(threads)


def _tile(p, B):
    return jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), p)


def _jax_lqr():
    p, _ = jquadrotor(N=20)
    it = jinit_iterates(p, rho=0.01)
    x0 = jnp.zeros(12)
    ws, _ = jax.jit(jsequential.solve, static_argnums=3)(p, it, x0, 1e-6)
    ws_kkt = joracle.solve_kkt_dense(p, it, 1e-6, np.zeros(12), rho_dyn=1e-6)
    return {"seq": np.asarray(ws), "kkt": np.asarray(ws_kkt), "nu": p.nu}


def _jax_constrained(thrust_cone, dtype):
    p, specs = jquadrotor(N=8, constrained=True, thrust_cone=thrust_cone,
                          dtype=dtype)
    cones = tuple(specs or [])
    st = jadmm.ADMMSettings(max_iter=100, rho_update_interval=25, rho=0.1)
    x0 = jnp.zeros(p.nx, dtype)
    _, _, info = jax.jit(lambda p, x: jadmm.solve(p, x, cones, st))(p, x0)
    xs, us, infos = jax.jit(
        lambda p, x: jmpc.simulate(p, x, 3, cones, st))(p, x0)
    us = np.asarray(us)
    return {"final_position": np.asarray(xs)[-1, :3], "u_min": us.min(),
            "u_max": us.max(),
            "mean_iterations": np.asarray(infos.iter_converged).mean(),
            "cold_iterations": int(info.iter_converged),
            "converged_replans": int(np.asarray(infos.converged).sum())}


def _jax_rocket():
    ex = _module("torch_rocket_landing")
    SETTINGS, MPC_SETTINGS, wind = ex.SETTINGS, ex.MPC_SETTINGS, ex.wind
    p, cones = jrocket(N=8, dtype=jnp.float64)
    cones = tuple(cones)
    st = jadmm.ADMMSettings(**SETTINGS)
    x0 = jrocket_x0(dtype=jnp.float64)
    ws, _, info = jax.jit(lambda p, x: jadmm.solve(p, x, cones, st))(p, x0)
    q = jquality.assess(p, ws, cones)
    wsb = jax.jit(lambda p, x: jadmm.solve_fused(p, x, cones, st,
                                                 interpret=True)[0])(
        _tile(p, 2), jrocket_x0(batch=2, dtype=jnp.float64))
    xs_cl, _, infos = jax.jit(lambda p, x, w: jmpc.simulate(
        p, x, 2, cones, jadmm.ADMMSettings(**MPC_SETTINGS), process_noise=w))(
        p, x0, jnp.asarray(wind(2)))
    xs, land = np.asarray(ws)[:, 3:], np.asarray(wsb)[:, -1, 3:]
    r_err = np.linalg.norm(land[:, :3], axis=1)
    xs_cl, iters = np.asarray(xs_cl), np.asarray(infos.iter_converged)
    return {
        "single": {"converged": bool(info.converged),
                   "iter_converged": int(info.iter_converged),
                   "touchdown_pos_err_m": np.linalg.norm(xs[-1, :3]),
                   "touchdown_vertical_vel": xs[-1, 5],
                   "cone_violation": float(q.cone_violation),
                   "box_violation": float(q.box_violation)},
        "dispersion": {"footprint_p50_m": np.median(r_err),
                       "footprint_max_m": r_err.max(),
                       "vertical_vel_worst": land[:, 5].min()},
        "closed_loop": {"altitude_end": xs_cl[-1, 2],
                        "lateral_end": np.linalg.norm(xs_cl[-1, :2]),
                        "warm_iters_p50": int(np.median(iters[1:])),
                        "cold_iters": int(iters[0])}}


SCENARIO_SETTINGS = dict(max_iter=15, rho_update_interval=15,
                         adaptive_rho=False, eps_abs=1e-4, eps_rel=1e-4,
                         rho=0.1)


def _jax_scenarios():
    """Both scenario runs on one jitted solve_fused (the same shapes: one
    compilation a form, cold and warm)."""
    st = jadmm.ADMMSettings(**SCENARIO_SETTINGS)
    fused = jax.jit(lambda p, x, s: jadmm.solve_fused(p, x, (), st, s,
                                                      interpret=True))
    return {f"torch_scenario_mpc{'_shared' if shared else ''}":
            _jax_scenario(fused, st, shared) for shared in (False, True)}


def _jax_scenario(fused, st, shared):
    scenarios = _module("torch_scenario_mpc").scenarios
    B, N = 2, 8
    base, _ = jquadrotor(N=N, constrained=True, dtype=jnp.float32)
    bp = _tile(base, B)
    dc, dA, dB = scenarios(B, N, shared)
    bp = dataclasses.replace(bp, c=bp.c + jnp.asarray(dc))
    if not shared:
        bp = dataclasses.replace(bp, A=bp.A + jnp.asarray(dA),
                                 B=bp.B + jnp.asarray(dB))
    x0s = jnp.zeros((B, 12), jnp.float32)
    ws, state, info = fused(bp, x0s, None)
    ws_cold = ws
    out = {"cold_converged": int(np.asarray(info.converged).sum()),
           "cold_max_r_prim": float(np.asarray(info.r_prim).max())}
    for _ in range(2):                      # the untimed and one timed replan
        ws, state, info = fused(bp, x0s, state)
    u0 = np.asarray(ws[:, 0, :4], np.float64)
    q = jquality.assess(jax.tree.map(lambda x: x[0], bp), ws[0])
    out.update(consensus_u0=u0.mean(0), consensus_u0_std=u0.std(0),
               failed=int(np.asarray(jprofiling.failure_mask(ws)).sum()),
               quality0={f.name: float(getattr(q, f.name))
                         for f in dataclasses.fields(q)})
    if shared:
        op = jrealtime.build_batch_operator(base, rho=st.rho, settings=st)
        ws_o, _, _ = jax.jit(lambda p, x: jrealtime.solve_batch(
            p, x, op, (), st, None))(bp, x0s)
        out["operator_vs_fused"] = float(jnp.max(jnp.abs(ws_o - ws_cold)))
    return out


def _jax_roofline():
    return jprofiling.riccati_roofline(8, 12, 4, 16, 4)


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's figures at the examples' arguments."""
    calls = {"torch_lqr_example": _jax_lqr,
             "torch_constrained_mpc":
                 lambda: _jax_constrained(False, jnp.float32),
             "torch_constrained_mpc_f64":
                 lambda: _jax_constrained(False, jnp.float64),
             "torch_constrained_mpc_cone":
                 lambda: _jax_constrained(True, jnp.float64),
             "torch_rocket_landing": _jax_rocket,
             "scenarios": _jax_scenarios,
             "torch_roofline_report": _jax_roofline}
    with concurrent.futures.ThreadPoolExecutor(len(calls)) as pool:
        futures = {k: pool.submit(f) for k, f in calls.items()}
        out = {k: f.result() for k, f in futures.items()}
    out.update(out.pop("scenarios"))
    return out


def _close32(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=0, atol=F32_RTOL * scale)


def test_lqr_example_matches_jax(port, jax_ref):
    figs, ref = port["torch_lqr_example"], jax_ref["torch_lqr_example"]
    nu = ref["nu"]
    for name, fig in figs.items():
        ws = ref["kkt"] if "KKT" in name else ref["seq"]
        np.testing.assert_allclose(fig["u0"], ws[:5, 0], rtol=0, atol=F64_ATOL)
        np.testing.assert_allclose(fig["xN"], ws[-1, nu:], rtol=0,
                                   atol=F64_ATOL)
    assert len(figs) == 4


def test_constrained_mpc_matches_jax_f32(port, jax_ref):
    """float32, the example's default: the trajectory's figures.  Its
    iteration counts are not held: the convergence test sits at the
    float32 residuals' rounding there, and JAX's own float32 and float64
    runs converge 6 iterations apart on a replan of this case."""
    figs, ref = port["torch_constrained_mpc"], jax_ref["torch_constrained_mpc"]
    for key in ("final_position", "u_min", "u_max"):
        _close32(figs[key], ref[key])
    assert figs["box"] == [-0.9916, 2.4084]


@pytest.mark.parametrize("name", ["torch_constrained_mpc_f64",
                                  "torch_constrained_mpc_cone"])
def test_constrained_mpc_matches_jax_f64(port, jax_ref, name):
    figs, ref = port[name], jax_ref[name]
    for key in ("final_position", "u_min", "u_max", "mean_iterations"):
        np.testing.assert_allclose(figs[key], ref[key], rtol=0, atol=F64_ATOL)
    assert figs["cold_iterations"] == ref["cold_iterations"]
    assert figs["converged_replans"] == ref["converged_replans"]


def test_rocket_landing_matches_jax(port, jax_ref):
    figs, ref = port["torch_rocket_landing"], jax_ref["torch_rocket_landing"]
    assert figs["dtype"] == "float64" and figs["dispersion"]["B"] == 2
    for part, fields in ref.items():
        for key, val in fields.items():
            got = figs[part][key]
            if isinstance(val, (bool, int)):
                assert got == val, (part, key, got, val)
            else:
                np.testing.assert_allclose(got, val, rtol=0, atol=F64_ATOL,
                                           err_msg=f"{part}.{key}")


@pytest.mark.parametrize("name", ["torch_scenario_mpc",
                                  "torch_scenario_mpc_shared"])
def test_scenario_mpc_matches_jax(port, jax_ref, name):
    figs, ref = port[name], jax_ref[name]
    assert figs["B"] == 2
    assert figs["cold_converged"] == ref["cold_converged"]
    assert figs["failed"] == ref["failed"] == 0
    _close32(figs["cold_max_r_prim"], ref["cold_max_r_prim"])
    _close32(figs["consensus_u0"], ref["consensus_u0"])
    _close32(figs["consensus_u0_std"], ref["consensus_u0_std"])
    for key, val in ref["quality0"].items():
        _close32(figs["quality0"][key], val)
    if "operator_vs_fused" in ref:
        _close32(figs["operator_vs_fused"], ref["operator_vs_fused"])


def test_roofline_report_matches_jax(port, jax_ref):
    figs, ref = port["torch_roofline_report"], jax_ref["torch_roofline_report"]
    assert figs["backward"]["bytes"] == ref["bytes_per_batched_solve"]
    assert figs["backward"]["flops"] == ref["flops_per_batched_solve"]
    assert figs["ws_finite"] and figs["card"] is None
    assert figs["backward"]["measured_ms"] == "not measured"


def test_latency_mpc_runs(port):
    assert port["torch_latency_mpc"] == 0


@pytest.mark.parametrize("name", sorted({_stem(n) for n in ARGS}))
def test_example_refuses_a_missing_card(name, monkeypatch, capsys):
    """``--device cuda`` (the default) with no card exits non-zero."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _module(name).main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err
