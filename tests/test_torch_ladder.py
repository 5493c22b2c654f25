"""The port's rho-ladder split loop and its kernels against the JAX package,
on the CPU.

The small model and the helpers of ``tests/test_torch_admm.py`` (nx=3,
nu=2, six constraint rows with a shifted cone, N=8, B=6, float64, Pallas in
interpret mode).  Module-scoped fixtures run each JAX solve ONCE (every
distinct setting is a fresh trace): the ladder with fixed per-scenario
rungs, the ladder adapting on every third iteration, and
``suggest_rho_ladder``.  The port runs on ``device="cpu"`` through its
kernels' plain PyTorch versions.  Limits: 1e-10 for one kernel launch,
1e-9 absolute for a whole solve, equality for rho (it lives on the rungs)
and for what is counted.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdp_lqr_tpu.ops import pallas_admm as jpa
from pdp_lqr_tpu.solvers import admm as jadmm
import pdp_lqr_tpu_torch as plt_
from pdp_lqr_tpu_torch import convert
from pdp_lqr_tpu_torch.ops import cuda_admm as ca
from pdp_lqr_tpu_torch.solvers import admm
from test_torch_admm import (
    B, CONES, KERNEL_ATOL, N, NC, NU, NX, NZ, SOLVE_ATOL, _asdict_np,
    _model, _result_np, _wide,
)

RUNGS = (0.03, 0.1, 0.4)
FIXED = dict(max_iter=8, adaptive_rho=False, rho_ladder=RUNGS)
# The start rho lies off the rungs and far from balance: the update on
# every third iteration fires and snaps.
ADAPT = dict(max_iter=9, adaptive_rho=True, rho_update_interval=3,
             rho_ladder=RUNGS)
PROBE = dict(rho=1e-3, max_iter=20, rho_update_interval=5)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    jp = _model()
    shift = np.zeros((N + 1, NC))
    shift[:, 3] = 0.4
    # Scenario b starts on rung b mod 3, a little off it (the snap).
    rho_pi = np.array([RUNGS[b % 3] * (1.2 if b < 3 else 0.9)
                       for b in range(B)])
    zeros = lambda *s: np.zeros((B,) + s)
    return {"x0": rng.normal(size=(B, NX)) * 0.2,
            "c": rng.normal(size=(B, N, NX)) * 0.01, "shift": shift,
            "state": {"w": zeros(N + 1, NZ), "z": zeros(N + 1, NC),
                      "y": zeros(N + 1, NC), "rho": rho_pi},
            "jax": jp,
            "torch": convert.problem_from_numpy(_asdict_np(jp), device="cpu")}


def _jax_ladder(setup, settings, state):
    jp = dataclasses.replace(setup["jax"], c=jnp.asarray(setup["c"]))
    st = None if state is None else jadmm.ADMMState(
        **{k: jnp.asarray(v) for k, v in state.items()})
    return jadmm.solve_fused(
        jp, jnp.asarray(setup["x0"]), CONES, jadmm.ADMMSettings(**settings),
        state=st, soc_shift=jnp.asarray(setup["shift"]), interpret=True,
        single_kernel=False)


def _port(setup, settings, state, batched=False):
    tp = dataclasses.replace(setup["torch"], c=torch.as_tensor(setup["c"]))
    if batched:
        tp = plt_.LQRProblem(**{
            f.name: getattr(tp, f.name) if f.name == "c"
            else getattr(tp, f.name)[None].expand(
                (B,) + getattr(tp, f.name).shape)
            for f in dataclasses.fields(tp)})
    st = None if state is None else convert.state_from_numpy(state,
                                                             device="cpu")
    return plt_.solve_fused(tp, setup["x0"], CONES,
                            admm.ADMMSettings(**settings), state=st,
                            soc_shift=setup["shift"])


@pytest.fixture(scope="module")
def jax_ladder(setup):
    return {"fixed": _result_np(*_jax_ladder(setup, FIXED, setup["state"])),
            "adapt": _result_np(*_jax_ladder(setup, ADAPT, None))}


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
    np.testing.assert_array_equal(state.rho.numpy(), ref["state"]["rho"])
    for name in ("iterations", "converged", "iter_converged"):
        np.testing.assert_array_equal(getattr(info, name).numpy(),
                                      ref["info"][name], err_msg=name)
    assert state.factors is None and ref["state"]["factors"] is None


@pytest.mark.parametrize("name", ["fixed", "adapt"])
def test_ladder_matches_jax(setup, jax_ladder, name):
    settings, state = (FIXED, setup["state"]) if name == "fixed" \
        else (ADAPT, None)
    admm.reset_host_reads()
    got = _port(setup, settings, state)
    _assert_same(got, jax_ladder[name])
    rho = got[1].rho.numpy()
    assert set(rho.tolist()) <= set(RUNGS)
    if name == "adapt":                   # the snap moved some scenarios
        assert len(set(rho.tolist())) > 1
    # No factor carry, so nothing to read back but nothing was asked.
    assert admm.HOST_READS == {"diag_cost": 0, "refactor": 0,
                               "early_exit": 0}


def test_ladder_equals_replicated_loop(setup):
    """Each scenario on its own rung == the replicated per-instance loop
    with the same rho (the ladder's point: per-instance rho on factor
    streams shared by the batch)."""
    on_rungs = dict(setup["state"], rho=np.array(
        [RUNGS[b % 3] for b in range(B)]))
    lad = _port(setup, FIXED, on_rungs)
    rep = _port(setup, dict(FIXED, rho_ladder=()), on_rungs, batched=True)
    for a, b in ((lad[0], rep[0]), (lad[1].z, rep[1].z),
                 (lad[2].r_dual, rep[2].r_dual)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=SOLVE_ATOL,
                                   rtol=0)


def test_one_rung_is_the_uniform_split_loop(setup):
    one = _port(setup, dict(FIXED, rho_ladder=(0.1,)), None)
    uni = _port(setup, dict(max_iter=8, adaptive_rho=False, rho=0.1,
                            cached_factors=True, uniform_rho=True), None)
    np.testing.assert_allclose(one[0].numpy(), uni[0].numpy(), atol=1e-12,
                               rtol=0)


def test_server_serves_the_ladder(setup):
    server = plt_.ScenarioServer(setup["torch"], device="cpu")
    ws, state, info = server.solve_admm(
        setup["x0"], CONES, admm.ADMMSettings(**FIXED),
        state=convert.state_from_numpy(setup["state"], device="cpu"),
        soc_shift=setup["shift"], c=setup["c"])
    direct = _port(setup, FIXED, setup["state"])
    assert torch.equal(ws, direct[0]) and state.factors is None
    assert bool((info.iterations == FIXED["max_iter"]).all())


def test_suggest_rho_ladder_matches_jax(setup):
    jp = dataclasses.replace(setup["jax"], c=jnp.asarray(setup["c"]))
    ref = jadmm.suggest_rho_ladder(
        jp, jnp.asarray(setup["x0"]), CONES, jadmm.ADMMSettings(**PROBE),
        rungs=3, probe_batch=4, soc_shift=jnp.asarray(setup["shift"]),
        interpret=True)
    tp = dataclasses.replace(setup["torch"], c=torch.as_tensor(setup["c"]))
    got = admm.suggest_rho_ladder(
        tp, setup["x0"], CONES, admm.ADMMSettings(**PROBE), rungs=3,
        probe_batch=4, soc_shift=setup["shift"])
    assert got == ref and len(got) >= 1


# ------------------------------------------------- one launch of each kernel

def _rand(seed):
    rng = np.random.default_rng(seed)
    return rng, (lambda *s, scale=0.3: rng.normal(size=s) * scale)


def _onehot(rung, R):
    return (np.arange(R)[:, None] == rung[None, :]).astype(float)


@pytest.mark.parametrize("pc_form", [False, True])
def test_bwd_vec_plain_version_matches_pallas(pc_form):
    rng, r = _rand(21)
    R = 1 if pc_form else 3
    L = np.concatenate([np.tril(r(N, NU, NU)) + np.eye(NU) * 1.5
                        for _ in range(R)], axis=1)[..., None]
    mask = np.ones((N, NC, 1))
    mask[:, NC - 1] = 0.0
    mask[N // 2:, 2] = 1e3
    a = dict(rho=rng.uniform(0.05, 2.0, size=(1, B)), pN=r(NX, B),
             A=r(N, NX, NX, 1), B=r(N, NX, NU, 1), h=r(N, NZ, 1),
             D=r(N, NC, NZ, 1, scale=0.5), mask=mask,
             P=None if pc_form else r(N, R * NX, NX, 1), L=L,
             K=r(N, R * NU, NX, 1), c=r(N, NX, B, scale=0.1),
             wzy=r(N, NZ + 2 * NC, B))
    rung = np.array([b % R for b in range(B)])
    Pc = r(N, NX, B) if pc_form else None
    shared = ("A", "B", "h", "D", "mask", "P", "L", "K")
    ref = jpa.admm_bwd_vec_lanes(
        *(None if v is None else _wide(v) if k in shared else jnp.asarray(v)
          for k, v in a.items()), nu=NU, sigma=1e-6,
        ladder_oh=None if pc_form else jnp.asarray(_onehot(rung, R)),
        Pc=None if Pc is None else jnp.asarray(Pc), interpret=True)
    t = {k: None if v is None else torch.as_tensor(np.ascontiguousarray(v))
         for k, v in a.items()}
    extra = dict(Pc=torch.as_tensor(Pc)) if pc_form else dict(
        ladder_oh=torch.as_tensor(_onehot(rung, R)))
    got = ca.admm_bwd_vec_lanes(*t.values(), nu=NU, sigma=1e-6, **extra)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=KERNEL_ATOL, rtol=0)
    if not pc_form:                      # the int32 index is the same rung
        by_index = ca.admm_bwd_vec_lanes(
            *t.values(), nu=NU, sigma=1e-6,
            rung=torch.as_tensor(rung, dtype=torch.int32))
        assert torch.equal(by_index, got)


# (cones, diagonal cost, shift, hf-emit): K5's rung form at R = 3.
RUNG_MODES = {
    "box_diag": ((), True, False, False),
    "soc_shift_full_Hs_emit": (((3, 3, "soc"),), False, True, True),
}


@pytest.mark.parametrize("mode", list(RUNG_MODES))
def test_fwd_update_rung_form_matches_pallas(mode):
    cones, diag, shift, emit = RUNG_MODES[mode]
    rng, r = _rand(22)
    R = 3
    lb, ub = -np.abs(r(N, NC, 1)), np.abs(r(N, NC, 1))
    lb[:, ::3], ub[:, 1::4] = -np.inf, np.inf
    mask = np.ones((N, NC, 1))
    mask[:, 0 if cones else NC - 1] = 0.0
    mask[N // 2:, NC // 2] = 1e3
    for off, dim, _ in cones:
        mask[:, off:off + dim] = 1.0
    a = dict(rho=rng.uniform(0.05, 2.0, size=(1, B)), x0=r(NX, B),
             M=r(N, R * NX, NX, 1), K=r(N, R * NU, NX, 1),
             Hs=np.abs(r(N, NZ, 1)) + 0.1 if diag else r(N, NZ, NZ, 1),
             D=r(N, NC, NZ, 1, scale=0.5), lb=lb, ub=ub, mask=mask,
             shift=r(N, NC, 1) if shift else None, dv=r(N, NZ, B),
             wzy=r(N, NZ + 2 * NC, B))
    h = r(N, NZ, 1) if emit else None
    rung = np.array([(b + 1) % R for b in range(B)])
    per_scenario = ("rho", "x0", "dv", "wzy")
    ref = jpa.admm_fwd_update_lanes(
        *(None if v is None else jnp.asarray(v) if k in per_scenario
          else _wide(v) for k, v in a.items()), nu=NU, cones=cones,
        alpha=1.6, sigma=1e-6, ladder_oh=jnp.asarray(_onehot(rung, R)),
        h=None if h is None else _wide(h), interpret=True)
    t = {k: None if v is None else torch.as_tensor(v) for k, v in a.items()}
    kw = dict(nu=NU, cones=cones, alpha=1.6, sigma=1e-6,
              h=None if h is None else torch.as_tensor(h))
    got = ca.admm_fwd_update_lanes(
        *t.values(), ladder_oh=torch.as_tensor(_onehot(rung, R)), **kw)
    names = ("wzy", "hf", "xN", "res") if emit else ("wzy", "xN", "res")
    assert len(got) == len(ref) == len(names)
    for name, g, rr in zip(names, got, ref):
        rr = np.asarray(rr)
        scale = max(1.0, np.abs(rr).max())     # the boosted rows run to 1e3
        np.testing.assert_allclose(g.numpy() / scale, rr / scale,
                                   atol=KERNEL_ATOL, rtol=0, err_msg=name)
    # The packed bound stream and the int32 rung give the same launch.
    bnd = ca.stack_bounds(t["lb"], t["ub"], t["mask"], t["shift"])
    again = ca.admm_fwd_update_lanes(
        t["rho"], t["x0"], t["M"], t["K"], t["Hs"], t["D"], bnd, None, None,
        None, t["dv"], t["wzy"], rung=torch.as_tensor(rung, dtype=torch.int32),
        **kw)
    for g, g2 in zip(got, again):
        assert torch.equal(g, g2)


def test_fwd_update_packed_form_without_hf_emit():
    """The packed form without ``h`` (a form of the JAX wrapper no path
    takes) is the hf-emit form minus its hf output."""
    rng, r = _rand(23)
    mask = np.ones((N, NC, 1))
    bnd = np.stack([-np.ones((N, NC, 1)), np.ones((N, NC, 1)), mask], axis=1)
    t = [torch.as_tensor(x) for x in (
        rng.uniform(0.1, 1.0, size=(1, B)), r(NX, B), r(N, NZ, NX, 1),
        np.abs(r(N, NZ, 1)) + 0.1, r(N, NC, NZ, 1), bnd, r(N, NZ, B),
        r(N, NZ + 2 * NC, B), r(N, NZ, 1))]
    rho, x0, MK, Hs, D, bnd, dv, wzy, h = t
    call = lambda h: ca.admm_fwd_update_lanes(
        rho, x0, MK, None, Hs, D, bnd, None, None, None, dv, wzy, nu=NU,
        cones=(), alpha=1.6, sigma=1e-6, h=h)
    with_h, without = call(h), call(None)
    assert len(without) == 3
    for a, b in zip((with_h[0],) + tuple(with_h[2:]), without):
        assert torch.equal(a, b)


def test_rung_wrappers_check_their_arguments():
    rng, r = _rand(24)
    T = lambda *s: torch.as_tensor(r(*s))
    args = (T(1, B), T(NX, B), T(N, NX, NX, 1), T(N, NX, NU, 1), T(N, NZ, 1),
            T(N, NC, NZ, 1), T(N, NC, 1), T(N, 2 * NX, NX, 1),
            T(N, 2 * NU, NU, 1), T(N, 2 * NU, NX, 1), T(N, NX, B),
            T(N, NZ + 2 * NC, B))
    with pytest.raises(ValueError, match="rung"):
        ca.admm_bwd_vec_lanes(*args, nu=NU, sigma=1e-6)       # no rung given
    with pytest.raises(TypeError, match="int32"):
        ca.admm_bwd_vec_lanes(*args, nu=NU, sigma=1e-6,
                              rung=torch.zeros(B, dtype=torch.int64))
    with pytest.raises(ValueError, match="Pc mode"):
        ca.admm_bwd_vec_lanes(*args, nu=NU, sigma=1e-6, Pc=T(N, NX, B))
    assert ca.kernel_defines(torch.float32, 12, 4, 16, fold=True, rungs=4) \
        == {"SCALAR": "float", "NX": 12, "NU": 4, "NC": 16, "NRUNG": 4,
            "FOLD": 1}
