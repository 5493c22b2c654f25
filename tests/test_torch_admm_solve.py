"""The port's ``admm.solve`` / ``solve_batched`` against the JAX package's,
on the CPU.

The small model of ``tests/test_torch_admm.py`` (nx=3, nu=2: boxes, an
equality row, a second-order cone with a shift, a terminal row), float64,
30 iterations with rho adapting every 10th from a start far from balance
(so the rho rule fires and every chunk refactors), on each of the five
inner solvers; one settings object a backend (each is a fresh JAX trace).
``solve_batched`` at B=3 against JAX's (its ``vmap``) and against a loop
of the port's own ``solve`` over the instances; the ``nc == 0`` short
path on a problem without constraint rows.  Limit: 1e-9 absolute on the
trajectory, the iterates and the residuals, 1e-9 relative on rho (the JAX
suite's own tolerance for a whole solve).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdp_lqr_tpu.models import random_lq as jrandom_lq
from pdp_lqr_tpu.solvers import admm as jadmm
from pdp_lqr_tpu_torch import convert
from pdp_lqr_tpu_torch.solvers import admm

from test_torch_admm import CONES, N, NC, NX, _asdict_np, _model

ATOL = 1e-9
BATCH = 3


def _settings(backend):
    return dict(max_iter=30, rho_update_interval=10, rho=1e-3,
                adaptive_rho=True, backend=backend, num_segments=2)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(3)
    jp = _model()
    shift = np.zeros((N + 1, NC))
    shift[:, 3] = 0.4
    return {"jax": jp,
            "torch": convert.problem_from_numpy(_asdict_np(jp), device="cpu"),
            "x0": rng.normal(size=(BATCH, NX)) * 0.2, "shift": shift}


def _compare(got, want, batch=False):
    ws, state, info = got
    jws, jstate, jinfo = want
    np.testing.assert_allclose(ws.numpy(), np.asarray(jws), rtol=0, atol=ATOL)
    for f in ("w", "z", "y"):
        np.testing.assert_allclose(getattr(state, f).numpy(),
                                   np.asarray(getattr(jstate, f)), rtol=0,
                                   atol=ATOL, err_msg=f)
    np.testing.assert_allclose(state.rho.numpy(), np.asarray(jstate.rho),
                               rtol=ATOL, atol=0)
    for f in ("r_prim", "r_dual"):
        np.testing.assert_allclose(getattr(info, f).numpy(),
                                   np.asarray(getattr(jinfo, f)), rtol=0,
                                   atol=ATOL, err_msg=f)
    for f in ("iterations", "converged", "iter_converged"):
        np.testing.assert_array_equal(getattr(info, f).numpy(),
                                      np.asarray(getattr(jinfo, f)), err_msg=f)


@pytest.mark.parametrize("backend", ["seq", "dense", "assoc", "kkt", "pdp"])
def test_solve_against_jax(setup, backend):
    st = _settings(backend)
    x0, shift = setup["x0"][0], setup["shift"]
    want = jadmm.solve(setup["jax"], jnp.asarray(x0), CONES,
                       jadmm.ADMMSettings(**st), soc_shift=jnp.asarray(shift))
    got = admm.solve(setup["torch"], torch.tensor(x0), CONES,
                     admm.ADMMSettings(**st), soc_shift=torch.tensor(shift))
    # The run adapted rho and ended away from its start.
    assert float(got[1].rho) != st["rho"]
    _compare(got, want)


def test_solve_batched_against_jax_and_a_loop(setup):
    """B=3 instances of the model, the second and third with their drift
    changed, through ``solve_batched``: JAX's vmap, and the port's own
    ``solve`` instance by instance."""
    rng = np.random.default_rng(4)
    st = _settings("seq")
    jp = setup["jax"]
    fields = _asdict_np(jp)
    bf = {k: np.broadcast_to(v, (BATCH,) + v.shape).copy()
          for k, v in fields.items()}
    bf["c"][1:] += rng.normal(size=bf["c"][1:].shape) * 0.05
    jbp = type(jp)(**{k: jnp.asarray(v) for k, v in bf.items()})
    tbp = convert.problem_from_numpy(bf, device="cpu")
    x0, shift = setup["x0"], setup["shift"]
    want = jadmm.solve_batched(jbp, jnp.asarray(x0), CONES,
                               jadmm.ADMMSettings(**st),
                               soc_shift=jnp.asarray(shift))
    got = admm.solve_batched(tbp, torch.tensor(x0), CONES,
                             admm.ADMMSettings(**st),
                             soc_shift=torch.tensor(shift))
    assert got[0].shape == (BATCH, N + 1, 5) and got[1].rho.shape == (BATCH,)
    _compare(got, want, batch=True)
    # Every residual and rho update is per instance: the batch is a loop.
    for b in range(BATCH):
        one = convert.problem_from_numpy({k: v[b] for k, v in bf.items()},
                                         device="cpu")
        ws, state, info = admm.solve(one, torch.tensor(x0[b]), CONES,
                                     admm.ADMMSettings(**st),
                                     soc_shift=torch.tensor(shift))
        np.testing.assert_allclose(got[0][b].numpy(), ws.numpy(), rtol=0,
                                   atol=1e-12)
        assert float(got[1].rho[b]) == pytest.approx(float(state.rho),
                                                     rel=1e-12)
        assert int(got[2].iter_converged[b]) == int(info.iter_converged)
    # The instances differ (their drifts do): not one solve copied.
    assert float((got[0][1] - got[0][0]).abs().max()) > 1e-4


def test_solve_without_constraint_rows():
    """``nc == 0``: one inner solve, zero residuals, the state returned."""
    jp = jrandom_lq(4, 2, 8, nc=0, seed=5)
    tp = convert.problem_from_numpy(_asdict_np(jp), device="cpu")
    x0 = np.random.default_rng(6).normal(size=4) * 0.3
    st = dict(backend="dense")
    jws, _, jinfo = jadmm.solve(jp, jnp.asarray(x0), (),
                                jadmm.ADMMSettings(**st))
    ws, state, info = admm.solve(tp, torch.tensor(x0), (),
                                 admm.ADMMSettings(**st))
    np.testing.assert_allclose(ws.numpy(), np.asarray(jws), rtol=0, atol=ATOL)
    assert int(info.iterations) == int(jinfo.iterations) == 1
    assert bool(info.converged) and float(info.r_prim) == 0.0
    assert state.w.shape == (9, 6) and state.z.shape == (9, 0)
