"""The port's replicated two-kernel ADMM loop, ``solve_lanes`` and kernel
K7 against the JAX package, on the CPU.

The small model of ``tests/test_torch_admm.py`` (nx=3, nu=2, six
constraint rows with a shifted cone, N=8, B=6, float64, Pallas in
interpret mode) made a batched problem: one model a scenario, each with
its own drift, cost and bounds.  Module-scoped fixtures run each JAX solve
ONCE (``solve_fused`` on the batched problem, ``single_kernel=False``):
fixed rho with the cheap dual residual; adaptive rho on every third
iteration with cached factors and ``residual_weights``; ``early_exit`` to
convergence at a fixed rho and a warm restart from its state (one trace
for both).  The
port runs on ``device="cpu"`` through its kernels' plain PyTorch
versions, with and without ``cached_factors`` against each (the two are
the same function), ``single_kernel=False`` as on the JAX side.  Limits: 1e-10 for one kernel launch, 1e-9 absolute
for a whole solve, equality for what is counted.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdp_lqr_tpu import init_iterates as jinit_iterates
from pdp_lqr_tpu.ops import pallas_riccati as jpr
from pdp_lqr_tpu.solvers import admm as jadmm
import pdp_lqr_tpu_torch as plt_
from pdp_lqr_tpu_torch import convert
from pdp_lqr_tpu_torch.ops import cuda_riccati as cr
from pdp_lqr_tpu_torch.solvers import admm
from test_torch_admm import (
    B, CONES, KERNEL_ATOL, N, NC, NU, NX, NZ, SOLVE_ATOL, _asdict_np,
    _model, _result_np,
)

FIXED = dict(rho=0.1, max_iter=8, adaptive_rho=False, exact_dual=False)
ADAPT = dict(rho=1e-3, max_iter=12, adaptive_rho=True, rho_update_interval=3,
             cached_factors=True)
# To convergence (about 130 iterations) at a fixed rho: per-instance
# adaptation over hundreds of iterations turns the two packages' rounding
# into rho itself (1e-8 apart after 100 iterations), and the adaptive
# cases above cover it.
EARLY = dict(rho=3.0, max_iter=400, adaptive_rho=False, early_exit=True,
             eps_abs=1e-4, eps_rel=1e-4)


def _batched_np(jp, rng):
    """The model once a scenario, each perturbed: drift, linear cost,
    a bound."""
    f = {k: np.repeat(v[None], B, axis=0) for k, v in _asdict_np(jp).items()}
    f["c"] = rng.normal(size=(B, N, NX)) * 0.01
    f["h"] = f["h"] + rng.normal(size=f["h"].shape) * 0.05
    f["h"][:, -1, :NU] = 0.0                 # the terminal stage has no u
    f["e_ub"][:, :-1, 1] = rng.uniform(0.5, 1.0, size=(B, 1))
    return f


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(3)
    jp = _model()
    fields = _batched_np(jp, rng)
    shift = np.zeros((N + 1, NC))
    shift[:, 3] = 0.4
    weights = (rng.uniform(0.5, 2.0, size=(N + 1, NC)),
               rng.uniform(0.5, 2.0, size=(N + 1, NZ)))
    return {"x0": rng.normal(size=(B, NX)) * 0.2, "shift": shift,
            "weights": weights,
            "jax": type(jp)(**{k: jnp.asarray(v) for k, v in fields.items()}),
            "torch": convert.problem_from_numpy(fields, device="cpu")}


def _jax_solve(setup, settings, state=None, weights=False):
    return jadmm.solve_fused(
        setup["jax"], jnp.asarray(setup["x0"]), CONES,
        jadmm.ADMMSettings(**settings), state=state,
        soc_shift=jnp.asarray(setup["shift"]), interpret=True,
        single_kernel=False,
        residual_weights=tuple(jnp.asarray(w) for w in setup["weights"])
        if weights else None)


def _port(setup, settings, state=None, weights=False, single_kernel=False):
    return plt_.solve_fused(
        setup["torch"], setup["x0"], CONES, admm.ADMMSettings(**settings),
        state=state, soc_shift=setup["shift"],
        residual_weights=setup["weights"] if weights else None,
        single_kernel=single_kernel)


@pytest.fixture(scope="module")
def jax_solves(setup):
    return {"fixed": _result_np(*_jax_solve(setup, FIXED)),
            "adapt": _result_np(*_jax_solve(setup, ADAPT, weights=True))}


def _assert_same(got, ref):
    ws, state, info = got
    for name, g, r in (
        ("ws", ws, ref["ws"]), ("w", state.w, ref["state"]["w"]),
        ("z", state.z, ref["state"]["z"]), ("y", state.y, ref["state"]["y"]),
        ("r_prim", info.r_prim, ref["info"]["r_prim"]),
        ("r_dual", info.r_dual, ref["info"]["r_dual"]),
    ):
        assert tuple(g.shape) == r.shape, name
        np.testing.assert_allclose(g.numpy(), r, atol=SOLVE_ATOL, rtol=0,
                                   err_msg=name)
    np.testing.assert_allclose(state.rho.numpy(), ref["state"]["rho"],
                               rtol=1e-12, atol=0)
    for name in ("iterations", "converged", "iter_converged"):
        np.testing.assert_array_equal(getattr(info, name).numpy(),
                                      ref["info"][name], err_msg=name)


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("name", ["fixed", "adapt"])
def test_replicated_matches_jax(setup, jax_solves, name, cached):
    settings = dict(FIXED if name == "fixed" else ADAPT,
                    cached_factors=cached)
    admm.reset_host_reads()
    got = _port(setup, settings, weights=name == "adapt")
    _assert_same(got, jax_solves[name])
    rho = got[1].rho.numpy()
    if name == "adapt":                    # per-instance rho really moved
        assert np.all(rho != ADAPT["rho"]) and len(set(rho.tolist())) > 1
    # The refactor test is read on the adaptation cadence only: after
    # iterations 3, 6 and 9 (the first build needs no read, the rho of
    # iteration 12 no factors).
    reads = 3 if cached and name == "adapt" else 0
    assert admm.HOST_READS == {"diag_cost": 0, "refactor": reads,
                               "early_exit": 0}
    assert (got[1].factors is not None) == cached
    if cached:
        K, M, P, L, rho_f = got[1].factors
        assert K.shape == (N, NU, NX, B) and P.shape == (N, NX, NX, B)


def test_replicated_runs_the_kernels_it_should(setup, monkeypatch):
    """Uncached: K1 and K3 every iteration; cached at fixed rho: K1 once,
    then K2 + K3."""
    for cached, want in ((False, {"backward_lanes": 8, "forward_lanes": 8,
                                  "backward_vectors_lanes": 0}),
                         (True, {"backward_lanes": 1, "forward_lanes": 8,
                                 "backward_vectors_lanes": 7})):
        calls = {k: 0 for k in want}
        for k in want:
            fn = getattr(cr, k)
            monkeypatch.setattr(cr, k, lambda *a, _f=fn, _k=k, **kw: (
                calls.__setitem__(_k, calls[_k] + 1), _f(*a, **kw))[1])
        _port(setup, dict(FIXED, cached_factors=cached))
        monkeypatch.undo()
        assert calls == want


@pytest.fixture(scope="module")
def jax_early(setup):
    """Early exit to convergence, then a restart from the returned state:
    one jitted function serves both (no factors in the state)."""
    run = jax.jit(lambda state: _jax_solve(setup, EARLY, state=state))
    zeros = lambda *s: jnp.zeros((B,) + s)
    start = jadmm.ADMMState(w=zeros(N + 1, NZ), z=zeros(N + 1, NC),
                            y=zeros(N + 1, NC),
                            rho=jnp.full((B,), EARLY["rho"]))
    cold = run(start)
    return {"cold": _result_np(*cold), "warm": _result_np(*run(cold[1]))}


def test_early_exit_then_warm_restart_matches_jax(setup, jax_early):
    cold = _port(setup, EARLY)
    _assert_same(cold, jax_early["cold"])
    assert bool(cold[2].converged.all())
    assert int(cold[2].iterations[0]) < EARLY["max_iter"]
    admm.reset_host_reads()
    warm = _port(setup, EARLY, state=cold[1])
    _assert_same(warm, jax_early["warm"])
    assert int(warm[2].iterations[0]) < int(cold[2].iterations[0])
    # One early-exit read an iteration after the first, no refactor read.
    assert admm.HOST_READS == {"diag_cost": 0, "refactor": 0,
                               "early_exit": int(warm[2].iterations[0])}


def test_auto_resolves_to_the_replicated_iteration(setup, jax_solves):
    """With residual_weights (only the replicated loop takes them); without,
    "auto" picks K8 on a batched problem (tests/test_torch_single_kernel.py)."""
    _assert_same(_port(setup, ADAPT, weights=True, single_kernel="auto"),
                 jax_solves["adapt"])


# --------------------------------------------------- solve_lanes and K7

def _jax_iterates(setup, rng):
    it = jinit_iterates(jax.tree.map(lambda x: x[0], setup["jax"]), rho=0.3)
    it = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), it)
    return dataclasses.replace(
        it, w=jnp.asarray(rng.normal(size=(B, N + 1, NZ)) * 0.1),
        z=jnp.asarray(rng.normal(size=(B, N + 1, NC)) * 0.1),
        y=jnp.asarray(rng.normal(size=(B, N + 1, NC)) * 0.1))


def test_solve_lanes_matches_jax(setup):
    rng = np.random.default_rng(5)
    jit_ = _jax_iterates(setup, rng)
    ref = jpr.solve_lanes(setup["jax"], jit_, jnp.asarray(setup["x0"]), 1e-6,
                          interpret=True)
    it = convert.iterates_from_numpy(_asdict_np(jit_), device="cpu")
    prep = cr.prepare_lanes(setup["torch"], it, setup["x0"], 1e-6)
    jprep = jpr.prepare_lanes(setup["jax"], jit_, jnp.asarray(setup["x0"]),
                              1e-6)
    for g, r in zip(prep[:-1], jprep[:-1]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-12,
                                   rtol=0)
    got = cr.solve_prepared(prep)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=SOLVE_ATOL,
                               rtol=0)
    assert torch.equal(cr.solve_lanes(setup["torch"], it, setup["x0"], 1e-6),
                       got)


def test_forward_rollout_plain_version_matches_pallas():
    rng = np.random.default_rng(6)
    r = lambda *s: rng.normal(size=s) * 0.3
    args = (r(N, NX, NX, B), r(N, NX, NU, B), r(N, NX, B), r(N, NU, NX, B),
            r(N, NU, B), r(NX, B))
    ref = jpr.forward_rollout_lanes(*(jnp.asarray(a) for a in args),
                                    interpret=True)
    got = cr.forward_rollout_lanes(*(torch.as_tensor(a) for a in args))
    for g, rr in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(rr),
                                   atol=KERNEL_ATOL, rtol=0)
    # The same as the closed-loop rollout on (A + B K, B d + c).
    A, Bm, c, K, d, x0 = (torch.as_tensor(a) for a in args)
    M = A + torch.einsum("kitb,ktjb->kijb", Bm, K)
    v = c + torch.einsum("kitb,ktb->kib", Bm, d)
    for g, g2 in zip(got, cr.forward_lanes(M, v, K, d, x0)):
        np.testing.assert_allclose(g.numpy(), g2.numpy(), atol=1e-13, rtol=0)


def test_no_constraint_rows_batched_is_solve_lanes(setup):
    tp = setup["torch"]
    free = dataclasses.replace(tp, D=tp.D[..., :0, :], e_lb=tp.e_lb[..., :0],
                               e_ub=tp.e_ub[..., :0])
    ws, state, info = plt_.solve_fused(free, setup["x0"])
    zero = lambda x: torch.zeros_like(x)
    it = plt_.ADMMIterates(w=zero(free.h), y=zero(free.e_lb),
                           z=zero(free.e_lb), rho=zero(free.e_lb))
    assert torch.equal(ws, cr.solve_lanes(free, it, setup["x0"], 1e-6))
    assert state.rho.shape == (B,) and bool(info.converged.all())
