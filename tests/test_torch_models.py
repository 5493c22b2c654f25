"""The port's mass-spring chain and centroidal models against the JAX
package's, on the CPU.

* The builders' arrays and cone lists equal the JAX builders' (float64,
  1e-15: both are numpy assembled into the same stage layout).
* ``ScenarioServer.solve(device="cpu")`` (the kernels' plain versions) at
  N=8 on three scenarios with per-scenario drift, against JAX's
  sequential solver on the same batch, at 1e-9.
* The centroidal model's conic loop (its two friction cones) through
  ``solve_fused`` in both its shared forms, the split pair (cached factors
  at a uniform rho) and the single-kernel iteration, 6 iterations without
  rho adaptation, against JAX's ``admm.solve_batched`` on the same batch,
  at 1e-9 on the trajectory and the iterates.  JAX's suite holds its
  ``solve_fused`` equal to ``admm.solve`` per instance when rho does not
  adapt (tests/test_admm.py); the JAX ``solve_fused`` itself is not run
  here: in interpret mode at nz=30 one call takes about 105 s on the CPU
  (its first and its second call alike: execution, not compilation).
  Nothing at nz=50 goes through JAX's interpret mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdp_lqr_tpu import init_iterates as jinit
from pdp_lqr_tpu.models import centroidal as jcentroidal
from pdp_lqr_tpu.models import mass_spring_chain as jmass_spring_chain
from pdp_lqr_tpu.solvers import admm as jadmm, sequential as jseq
import pdp_lqr_tpu_torch as plt_
from pdp_lqr_tpu_torch.models import centroidal, mass_spring_chain
from pdp_lqr_tpu_torch.solvers import admm

N, B = 8, 3
SIGMA, RHO = 1e-6, 0.01
ATOL = 1e-9


def _np(tree):
    return {f.name: np.asarray(getattr(tree, f.name))
            for f in dataclasses.fields(tree)}


def _models():
    jcp, jcones = jcentroidal(N=N)
    tcp, tcones = centroidal(N=N, device="cpu")
    return {"mass_spring": (jmass_spring_chain(N=N), None,
                            mass_spring_chain(N=N, device="cpu"), None),
            "centroidal": (jcp, jcones, tcp, tcones)}


@pytest.fixture(scope="module")
def models():
    return _models()


@pytest.mark.parametrize("name", ["mass_spring", "centroidal"])
def test_builders_equal_jax(models, name):
    jp, jcones, tp, tcones = models[name]
    for f, want in _np(jp).items():
        got = getattr(tp, f)
        assert got.dtype == torch.float64 and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-15,
                                   err_msg=f)
    assert tcones == jcones
    # The defaults build the widths the kernels are specialised for.
    assert (tp.nx, tp.nu, tp.nc) == {"mass_spring": (40, 10, 0),
                                     "centroidal": (24, 6, 6)}[name]


def test_builder_options_equal_jax():
    """Non-default arguments reach the same arrays (and float32)."""
    jp = jmass_spring_chain(n_masses=6, n_actuated=3, N=5, dt=0.02,
                            k_spring=2.0, c_damp=0.3)
    tp = mass_spring_chain(n_masses=6, n_actuated=3, N=5, dt=0.02,
                           k_spring=2.0, c_damp=0.3, device="cpu")
    jc, jcones = jcentroidal(N=5, n_feet=4, mass=40.0, mu=0.5, nx_pad=12)
    tc, tcones = centroidal(N=5, n_feet=4, mass=40.0, mu=0.5, nx_pad=12,
                            dtype=torch.float32, device="cpu")
    assert tcones == jcones and tc.A.dtype == torch.float32
    for j, t, tol in ((jp, tp, 1e-15), (jc, tc, 1e-7)):
        for f, want in _np(j).items():
            np.testing.assert_allclose(getattr(t, f).double().numpy(), want,
                                       rtol=tol, atol=tol, err_msg=f)


@pytest.mark.parametrize("name", ["mass_spring", "centroidal"])
def test_scenario_server_solve_against_jax(models, name):
    jp, _, tp, _ = models[name]
    rng = np.random.default_rng(2)
    c = np.asarray(jp.c)[None] + rng.normal(size=(B,) + jp.c.shape) * 1e-3
    x0 = rng.normal(size=(B, jp.nx)) * 0.1
    ws = plt_.ScenarioServer(tp, rho=RHO, sigma=SIGMA, device="cpu").solve(
        x0, c)
    bp = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), jp)
    bp = dataclasses.replace(bp, c=jnp.asarray(c))
    its = jax.vmap(lambda p: jinit(p, rho=RHO))(bp)
    jws, _ = jseq.solve_batched(bp, its, jnp.asarray(x0), SIGMA)
    assert ws.shape == (B, N + 1, tp.nz)
    np.testing.assert_allclose(ws.numpy(), np.asarray(jws), rtol=0, atol=ATOL)


# The bench's split settings (cached factors at a uniform rho, diagonal
# cost) and the default iteration (K8's), with rho fixed: both are then
# the per-instance loop of admm.solve.
FUSED = {
    "split": (dict(max_iter=6, rho=0.1, adaptive_rho=False,
                   cached_factors=True, uniform_rho=True, diag_cost=True),
              False),
    "single_kernel": (dict(max_iter=6, rho=0.1, adaptive_rho=False), True),
}


@pytest.fixture(scope="module")
def centroidal_reference(models):
    """JAX's admm.solve_batched on the centroidal batch (one trace)."""
    jp, jcones, _, _ = models["centroidal"]
    rng = np.random.default_rng(3)
    c = np.asarray(jp.c)[None] + rng.normal(size=(B,) + jp.c.shape) * 1e-3
    x0 = rng.normal(size=(B, jp.nx)) * 0.05
    bp = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), jp)
    bp = dataclasses.replace(bp, c=jnp.asarray(c))
    st = jadmm.ADMMSettings(max_iter=6, rho=0.1, adaptive_rho=False)
    ws, state, _ = jadmm.solve_batched(bp, jnp.asarray(x0), tuple(jcones), st)
    return c, x0, {"ws": np.asarray(ws), "z": np.asarray(state.z),
                   "y": np.asarray(state.y)}


@pytest.mark.parametrize("form", sorted(FUSED))
def test_centroidal_solve_fused_against_jax(models, centroidal_reference,
                                            form):
    _, _, tp, tcones = models["centroidal"]
    c, x0, want = centroidal_reference
    settings, single = FUSED[form]
    ws, state, info = admm.solve_fused(
        dataclasses.replace(tp, c=torch.tensor(c)), torch.tensor(x0),
        tuple(tcones), admm.ADMMSettings(**settings), single_kernel=single)
    assert int(info.iterations.max()) == 6
    for name, got in (("ws", ws), ("z", state.z), ("y", state.y)):
        np.testing.assert_allclose(got.numpy(), want[name], rtol=0,
                                   atol=ATOL, err_msg=name)
    # The cone rows carry the contact forces (the slack is not all zero).
    assert float(state.z.abs().max()) > 1.0
