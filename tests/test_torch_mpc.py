"""The port's receding-horizon loops against the JAX package, on the CPU.

``simulate`` (a warm-started ``admm.solve`` a tick) and
``simulate_realtime`` (the early-exit operator replan a tick) on the
double integrator (``constrained=True``, |u| <= 0.3, N=10, float64, six
ticks), each JAX loop traced once under ``jax.jit``: the states,
controls and per-tick iteration counts against the JAX package's (1e-9;
counts equal).  Then the port's own loops: the two closed loops track each
other on the quadrotor (as the JAX suite holds them, 2e-3), and a warm
replan converges in fewer iterations than a cold one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdp_lqr_tpu import mpc as jmpc
from pdp_lqr_tpu.models import double_integrator as jdouble_integrator
from pdp_lqr_tpu.solvers import admm as jadmm
from pdp_lqr_tpu_torch import convert, mpc
from pdp_lqr_tpu_torch.models import double_integrator, quadrotor
from pdp_lqr_tpu_torch.solvers import admm

ATOL = 1e-9
STEPS = 6
SETTINGS = dict(rho=1.0, max_iter=60, rho_update_interval=60,
                adaptive_rho=False, eps_abs=1e-6, eps_rel=1e-5)


@pytest.fixture(scope="module")
def loops():
    jp = jdouble_integrator(N=10, constrained=True, u_max=0.3)
    tp = convert.problem_from_numpy(
        {k: np.asarray(getattr(jp, k))
         for k in ("A", "B", "c", "H", "h", "D", "e_lb", "e_ub")},
        device="cpu")
    js = jadmm.ADMMSettings(**SETTINGS)
    x0 = np.array([0.0, 0.0])
    noise = np.random.default_rng(2).normal(size=(STEPS, 2)) * 1e-3
    out = {}
    for name, jfn, tfn in (("simulate", jmpc.simulate, mpc.simulate),
                           ("simulate_realtime", jmpc.simulate_realtime,
                            mpc.simulate_realtime)):
        run = jax.jit(lambda p, x, w, f=jfn: f(p, x, STEPS, (), js,
                                                process_noise=w))
        out[name] = (
            tfn(tp, torch.tensor(x0), STEPS, (), admm.ADMMSettings(**SETTINGS),
                process_noise=torch.tensor(noise)),
            run(jp, jnp.asarray(x0), jnp.asarray(noise)))
    return out


@pytest.mark.parametrize("loop", ["simulate", "simulate_realtime"])
def test_loop_matches_jax(loops, loop):
    (xs, us, infos), (jxs, jus, jinfos) = loops[loop]
    assert xs.shape == (STEPS + 1, 2) and us.shape == (STEPS, 1)
    np.testing.assert_allclose(xs.numpy(), np.asarray(jxs), rtol=0, atol=ATOL)
    np.testing.assert_allclose(us.numpy(), np.asarray(jus), rtol=0, atol=ATOL)
    for f in ("iterations", "converged", "iter_converged"):
        np.testing.assert_array_equal(getattr(infos, f).numpy(),
                                      np.asarray(getattr(jinfos, f)),
                                      err_msg=f)
    # |u| <= 0.3 binds on the way to the target.
    assert float(us.abs().max()) == pytest.approx(0.3, abs=1e-4)


def test_realtime_tracks_simulate():
    """The operator-path closed loop lands where the admm.solve loop does
    (same tolerances, same warm-start shifts): the JAX suite's check."""
    problem, _ = quadrotor(N=8, constrained=True, device="cpu")
    settings = admm.ADMMSettings(**SETTINGS)
    x0 = torch.full((12,), 0.08, dtype=torch.float64)
    xs_rt, us_rt, _ = mpc.simulate_realtime(problem, x0, STEPS,
                                            settings=settings)
    xs, _, _ = mpc.simulate(problem, x0, STEPS, settings=settings)
    np.testing.assert_allclose(xs_rt.numpy(), xs.numpy(), atol=2e-3)
    assert bool(torch.isfinite(us_rt).all())


def test_warm_start_cuts_iterations():
    """A replan warm-started from the shifted state of the last one
    converges sooner, on both paths."""
    from pdp_lqr_tpu_torch.solvers import realtime

    problem = double_integrator(N=16, constrained=True, u_max=0.3,
                                device="cpu")
    settings = admm.ADMMSettings(max_iter=200, rho_update_interval=50,
                                 adaptive_rho=False)
    x = torch.zeros(2, dtype=torch.float64)
    u0, _, state, info_cold = mpc.replan(problem, x, None, (), settings)
    assert bool(info_cold.converged)
    x2 = problem.A[0] @ x + problem.B[0] @ u0 + problem.c[0]
    _, _, _, info_warm = mpc.replan(problem, x2,
                                    mpc.shift_state(state, problem), (),
                                    settings)
    assert int(info_warm.iter_converged) < int(info_cold.iter_converged)

    op = realtime.build_operator(problem, settings.rho, settings)
    u0, _, state, rt_cold = mpc.replan_realtime(problem, x, None, op, (),
                                                settings)
    _, _, _, rt_warm = mpc.replan_realtime(
        problem, x2, mpc.shift_state(state, problem), op, (), settings)
    assert int(rt_cold.iterations) == int(info_cold.iter_converged)
    assert int(rt_warm.iterations) < int(rt_cold.iterations)
