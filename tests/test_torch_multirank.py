"""The port's mesh over ranks against its one-card mesh and the JAX package.

One module-scoped fixture starts a local world of 4 gloo ranks on the CPU
(``parallel.multihost.launch``: fresh processes, a free localhost port, a
timeout that kills them all) and runs every case below in it once; the
tests read the saved outputs.  A rank process imports torch and the port
only (each reports the top-level packages it loaded).  All cases are
float64 on small problems:

  * ``pdp_sharded.solve`` (torch ops) on rank meshes (2, 2) and (1, 4)
    with the Cholesky condensed solve and (1, 4) with LU, on
    ``random_lq(6, 3, 32, nc=2)`` x 8 (tests/test_sharded.py's data),
    against JAX's ``pdp_sharded.solve`` on the suite's virtual devices at
    the same mesh shapes (1e-9) and the port's one-card mesh at the same
    S (1e-12);
  * ``pdp_sharded_fused.solve`` on (2, 2), and ``admm_sharded.solve``
    uncached and with cached factors, both with ``early_exit``, on (2, 2)
    (the quadrotor, N=16, a thrust cone with a shift), against the port's
    one-card runs at the same S: ws to 1e-12, rho exactly, and the same
    iteration count on every rank;
  * ``fused_dp.solve`` and ``solve_fused_dp`` (the replicated split loop,
    and ``single_kernel=True``) on (4, 1), at tests/test_fused_dp.py's
    sizes (quadrotor N=8 and N=6, B=8), against JAX's ``fused_dp`` (one
    call each, interpret mode, 1e-9) and the one-process port (1e-12);
  * ``multihost.initialize`` is idempotent, ``make_pod_mesh`` lays out
    (4, 1), (2, 2), (1, 4) with the right groups and refuses a ``time``
    that does not divide the world or spans hosts.
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdp_lqr_tpu import init_iterates as jinit_iterates
from pdp_lqr_tpu.config import CondensedSolverType as JSolverType
from pdp_lqr_tpu.models import quadrotor as jquadrotor
from pdp_lqr_tpu.models import random_lq as jrandom_lq
from pdp_lqr_tpu.parallel import fused_dp as jfused_dp
from pdp_lqr_tpu.parallel import make_mesh as jmake_mesh
from pdp_lqr_tpu.parallel import pdp_sharded as jpdp_sharded
from pdp_lqr_tpu.solvers import admm as jadmm
from pdp_lqr_tpu_torch import convert
from pdp_lqr_tpu_torch.config import CondensedSolverType
from pdp_lqr_tpu_torch.ops import cuda_riccati as cr
from pdp_lqr_tpu_torch.parallel import (
    admm_sharded,
    fused_dp,
    make_mesh,
    multihost,
    pdp_sharded,
    pdp_sharded_fused,
)
from pdp_lqr_tpu_torch.solvers import admm

WORLD = 4
TIMEOUT_S = 180
SIGMA = 1e-6
JAX_ATOL = 1e-9
PORT_ATOL = 1e-12
PKG = "pdp_lqr_tpu_torch.parallel."

# name -> (mesh (batch, time), condensed solver)
PDP_CASES = {"pdp_2x2": ((2, 2), "cholesky"), "pdp_1x4": ((1, 4), "cholesky"),
             "pdp_1x4_lu": ((1, 4), "lu")}
ADMM_MESH = (2, 2)
ADMM_SETTINGS = dict(max_iter=100, rho=1.0, rho_update_interval=10,
                     early_exit=True, eps_abs=1e-2, eps_rel=1e-2)
ADMM_CASES = {"admm_uncached": False, "admm_cached": True}
DP_MESH = (4, 1)
FUSED_SETTINGS = dict(max_iter=40, rho=0.1, rho_update_interval=25)
DP_CASES = ("dp_solve", "dp_split", "dp_single")


def _np(tree):
    return {f.name: np.asarray(getattr(tree, f.name))
            for f in dataclasses.fields(tree)}


def _batched(problem, B):
    return jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), problem)


def _solver(name):
    return {"cholesky": CondensedSolverType.CHOLESKY,
            "lu": CondensedSolverType.LU}[name]


@pytest.fixture(scope="module")
def data():
    """Every case's inputs, made with numpy from seeds, in both packages
    (the JAX records and the port's CPU tensors)."""
    out = {}
    # pdp_sharded: tests/test_sharded.py's random instances.
    B, N = 8, 32
    jp = jax.tree.map(lambda *xs: jnp.stack(xs),
                      *[jrandom_lq(6, 3, N, nc=2, seed=s) for s in range(B)])
    jit = jax.vmap(lambda p: jinit_iterates(p, rho=0.01))(jp)
    x0 = np.random.default_rng(5).normal(size=(B, 6)) * 0.1
    out["pdp"] = {"jax": (jp, jit, jnp.asarray(x0)), "x0": torch.tensor(x0),
                  "problem": convert.problem_from_numpy(_np(jp), device="cpu"),
                  "it": convert.iterates_from_numpy(_np(jit), device="cpu")}
    # admm_sharded: the quadrotor with a shifted thrust cone, B=4, drift.
    rng = np.random.default_rng(7)
    q, cones = jquadrotor(N=16, constrained=True, thrust_cone=True)
    qb = _batched(q, 4)
    qb = dataclasses.replace(
        qb, c=qb.c + jnp.asarray(rng.normal(size=qb.c.shape) * 0.01))
    shift = np.zeros((17, q.nc))
    shift[:, cones[0][0]] = 8.0
    out["admm"] = {"problem": convert.problem_from_numpy(_np(qb), device="cpu"),
                   "x0": torch.tensor(rng.normal(size=(4, 12)) * 0.03),
                   "cones": tuple(cones), "shift": torch.tensor(shift)}
    # fused_dp: tests/test_fused_dp.py's two problems.
    rng = np.random.default_rng(0)
    q8 = _batched(jquadrotor(N=8, constrained=True)[0], 8)
    q8 = dataclasses.replace(
        q8, c=q8.c + jnp.asarray(rng.normal(size=q8.c.shape) * 0.01))
    it8 = jax.vmap(lambda p: jinit_iterates(p, rho=0.01))(q8)
    x8 = rng.normal(size=(8, 12)) * 0.1
    rng = np.random.default_rng(5)
    q6 = _batched(jquadrotor(N=6, constrained=True)[0], 8)
    q6 = dataclasses.replace(
        q6, c=q6.c + jnp.asarray(rng.normal(size=q6.c.shape) * 0.005))
    x6 = rng.normal(size=(8, 12)) * 0.05
    out["dp"] = {"jax8": (q8, it8, jnp.asarray(x8)), "jax6": (q6, jnp.asarray(x6)),
                 "p8": convert.problem_from_numpy(_np(q8), device="cpu"),
                 "it8": convert.iterates_from_numpy(_np(it8), device="cpu"),
                 "x8": torch.tensor(x8),
                 "p6": convert.problem_from_numpy(_np(q6), device="cpu"),
                 "x6": torch.tensor(x6)}
    return out


def _jobs(data):
    """The calls every rank makes, in order."""
    pdp, adm, dp = data["pdp"], data["admm"], data["dp"]
    jobs = [dict(name="initialize_again", fn=PKG + "multihost:initialize")]
    for t in (1, 2, 4):
        jobs.append(dict(name=f"mesh_time{t}", fn=PKG + "multihost:make_pod_mesh",
                         kwargs=dict(time=t, device="cpu")))
    jobs += [dict(name="refuse_time3", fn=PKG + "multihost:make_pod_mesh",
                  kwargs=dict(time=3, device="cpu")),
             dict(name="refuse_spans_hosts", fn=PKG + "multihost:make_pod_mesh",
                  kwargs=dict(time=4, device="cpu"),
                  env={"LOCAL_WORLD_SIZE": "2"})]
    for name, ((_, t), solver) in PDP_CASES.items():
        jobs.append(dict(name=name, fn=PKG + "pdp_sharded:solve", time=t,
                         args=(pdp["problem"], pdp["it"], pdp["x0"], SIGMA,
                               _solver(solver))))
    jobs.append(dict(name="pdp_fused_2x2", fn=PKG + "pdp_sharded_fused:solve",
                     time=2, args=(pdp["problem"], pdp["it"], pdp["x0"], SIGMA)))
    for name, cached in ADMM_CASES.items():
        st = admm.ADMMSettings(**ADMM_SETTINGS, cached_factors=cached)
        jobs.append(dict(name=name, fn=PKG + "admm_sharded:solve",
                         time=ADMM_MESH[1],
                         args=(adm["problem"], adm["x0"], adm["cones"], st),
                         kwargs=dict(soc_shift=adm["shift"])))
    jobs.append(dict(name="dp_solve", fn=PKG + "fused_dp:solve", time=1,
                     args=(dp["p8"], dp["it8"], dp["x8"], SIGMA)))
    for name, single in (("dp_split", False), ("dp_single", True)):
        jobs.append(dict(name=name, fn=PKG + "fused_dp:solve_fused_dp", time=1,
                         args=(dp["p6"], dp["x6"], (),
                               admm.ADMMSettings(**FUSED_SETTINGS)),
                         kwargs=dict(single_kernel=single)))
    return jobs


@pytest.fixture(scope="module")
def world(data):
    """Every rank's result of every job: {name: [rank 0's, ..., rank 3's]}."""
    ranks = multihost.launch(_jobs(data), WORLD, device="cpu",
                             timeout=TIMEOUT_S)
    by_name = {}
    for r, rank in enumerate(ranks):
        assert rank["rank"] == r and rank["backend"] == "gloo"
        for res in rank["results"]:
            by_name.setdefault(res["name"], []).append(res)
    by_name["_ranks"] = ranks
    return by_name


def _ok(world, name):
    """The outputs of every rank, none of them failed."""
    for r, res in enumerate(world[name]):
        assert res["error"] is None, (name, r, res["error"])
    return [res["out"] for res in world[name]]


@pytest.fixture(scope="module")
def one_card(data):
    """The port's one-card runs of the same cases (one process, CPU)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)      # small tensors: threads only contend
    try:
        return _one_card(data)
    finally:
        torch.set_num_threads(threads)


def _one_card(data):
    pdp, adm, dp = data["pdp"], data["admm"], data["dp"]
    out = {}
    for name, ((b, t), solver) in PDP_CASES.items():
        out[name] = pdp_sharded.solve(make_mesh(b, t, device="cpu"),
                                      pdp["problem"], pdp["it"], pdp["x0"],
                                      SIGMA, _solver(solver))
    out["pdp_fused_2x2"] = pdp_sharded_fused.solve(
        make_mesh(2, 2, device="cpu"), pdp["problem"], pdp["it"], pdp["x0"],
        SIGMA)
    for name, cached in ADMM_CASES.items():
        out[name] = admm_sharded.solve(
            make_mesh(*ADMM_MESH, device="cpu"), adm["problem"], adm["x0"],
            adm["cones"], admm.ADMMSettings(**ADMM_SETTINGS,
                                            cached_factors=cached),
            soc_shift=adm["shift"])
    out["dp_solve"] = cr.solve_lanes(dp["p8"], dp["it8"], dp["x8"], SIGMA)
    for name, single in (("dp_split", False), ("dp_single", True)):
        out[name] = admm.solve_fused(dp["p6"], dp["x6"], (),
                                     admm.ADMMSettings(**FUSED_SETTINGS),
                                     single_kernel=single)
    return out


def _jax_pdp(data):
    jp, jit, jx0 = data["pdp"]["jax"]
    out = {}
    for name, ((b, t), solver) in PDP_CASES.items():
        st = JSolverType.CHOLESKY if solver == "cholesky" else JSolverType.LU
        out[name] = np.asarray(jpdp_sharded.solve(jmake_mesh(batch=b, time=t),
                                                  jp, jit, jx0, SIGMA, st))
    return out


def _jax_dp(data, name):
    mesh = jmake_mesh(batch=DP_MESH[0], time=DP_MESH[1])
    if name == "dp_solve":
        return np.asarray(jfused_dp.solve(mesh, *data["dp"]["jax8"], SIGMA,
                                          interpret=True))
    ws, state, info = jfused_dp.solve_fused_dp(
        mesh, *data["dp"]["jax6"], (), jadmm.ADMMSettings(**FUSED_SETTINGS),
        interpret=True, single_kernel=name == "dp_single")
    return {"ws": np.asarray(ws), "rho": np.asarray(state.rho),
            "r_prim": np.asarray(info.r_prim)}


@pytest.fixture(scope="module")
def jax_ref(data):
    """JAX's CPU-mesh results (the suite's 8 virtual devices), one call
    each, in a thread pool (the calls are mostly compilation, which JAX
    runs outside the interpreter lock)."""
    with concurrent.futures.ThreadPoolExecutor(1 + len(DP_CASES)) as pool:
        pdp = pool.submit(_jax_pdp, data)
        dp = {name: pool.submit(_jax_dp, data, name) for name in DP_CASES}
        return {**pdp.result(), **{k: f.result() for k, f in dp.items()}}


def _rows(name, rank, B):
    """The global rows a rank's result holds."""
    if name.startswith("dp_"):
        n = B // WORLD
        return slice(rank * n, (rank + 1) * n)
    mesh = ADMM_MESH if name.startswith("admm") else (
        (2, 2) if name == "pdp_fused_2x2" else PDP_CASES[name][0])
    n = B // mesh[0]
    b = rank // mesh[1]
    return slice(b * n, (b + 1) * n)


# ---------------------------------------------------------------- the world

def test_ranks_import_no_jax(world):
    for rank in world["_ranks"]:
        loaded = set(rank["packages"])
        assert "torch" in loaded and "pdp_lqr_tpu_torch" in loaded
        assert not loaded & {"jax", "jaxlib", "pdp_lqr_tpu"}, sorted(loaded)
        assert rank["allow_tf32"] is False


def test_initialize_is_idempotent(world):
    assert _ok(world, "initialize_again") == [None] * WORLD


@pytest.mark.parametrize("t", [1, 2, 4])
def test_make_pod_mesh_shapes(world, t):
    for r, m in enumerate(_ok(world, f"mesh_time{t}")):
        b, c = divmod(r, t)
        assert m["shape"] == {"batch": WORLD // t, "time": t}
        assert m["rank"] == r and m["coords"] == (b, c)
        assert m["device"] == "cpu"
        # Contiguous time groups (a row stays on one host), columns apart.
        assert m["time_ranks"] == list(range(b * t, (b + 1) * t))
        assert m["batch_ranks"] == list(range(c, WORLD, t))


@pytest.mark.parametrize("name,match", [("refuse_time3", "not divisible"),
                                        ("refuse_spans_hosts", "spans hosts")])
def test_make_pod_mesh_refuses(world, name, match):
    for res in world[name]:
        assert res["error"] is not None and res["error"].startswith("ValueError")
        assert match in res["error"]


# ----------------------------------------------------------- pdp_sharded

@pytest.mark.parametrize("name", list(PDP_CASES))
def test_pdp_sharded_matches_jax(world, jax_ref, name):
    ref = jax_ref[name]
    for r, ws in enumerate(_ok(world, name)):
        np.testing.assert_allclose(ws.numpy(), ref[_rows(name, r, 8)], rtol=0,
                                   atol=JAX_ATOL)


@pytest.mark.parametrize("name", list(PDP_CASES) + ["pdp_fused_2x2"])
def test_pdp_sharded_matches_one_card(world, one_card, name):
    ref = one_card[name]
    for r, ws in enumerate(_ok(world, name)):
        sl = _rows(name, r, 8)
        assert ws.shape == ref[sl].shape
        np.testing.assert_allclose(ws.numpy(), ref[sl].numpy(), rtol=0,
                                   atol=PORT_ATOL)


def test_pdp_sharded_one_card_matches_jax(one_card, jax_ref):
    """The one-card torch-ops path against JAX (pdp_sharded has no test of
    its own elsewhere)."""
    for name in PDP_CASES:
        np.testing.assert_allclose(one_card[name].numpy(), jax_ref[name],
                                   rtol=0, atol=JAX_ATOL)


# ---------------------------------------------------------- admm_sharded

@pytest.mark.parametrize("name", list(ADMM_CASES))
def test_admm_sharded_matches_one_card(world, one_card, name):
    ws_ref, st_ref, info_ref = one_card[name]
    iters = int(info_ref.iterations[0])
    # The early exit fired, at a chunk boundary when factors are cached.
    assert iters < ADMM_SETTINGS["max_iter"]
    for r, (ws, st, info) in enumerate(_ok(world, name)):
        sl = _rows(name, r, 4)
        np.testing.assert_allclose(ws.numpy(), ws_ref[sl].numpy(), rtol=0,
                                   atol=PORT_ATOL)
        for f in ("w", "z", "y"):
            np.testing.assert_allclose(getattr(st, f).numpy(),
                                       getattr(st_ref, f)[sl].numpy(), rtol=0,
                                       atol=PORT_ATOL)
        assert torch.equal(st.rho, st_ref.rho[sl])
        assert (info.iterations == iters).all(), (r, info.iterations, iters)
        assert torch.equal(info.converged, info_ref.converged[sl])


# -------------------------------------------------------------- fused_dp

def _dp_ws(out):
    return out if isinstance(out, torch.Tensor) else out[0]


@pytest.mark.parametrize("name", DP_CASES)
def test_fused_dp_matches_jax(world, jax_ref, name):
    ref = jax_ref[name]
    for r, out in enumerate(_ok(world, name)):
        sl = _rows(name, r, 8)
        if name == "dp_solve":
            np.testing.assert_allclose(out.numpy(), ref[sl], rtol=0,
                                       atol=JAX_ATOL)
            continue
        ws, st, info = out
        np.testing.assert_allclose(ws.numpy(), ref["ws"][sl], rtol=0,
                                   atol=JAX_ATOL)
        np.testing.assert_allclose(st.rho.numpy(), ref["rho"][sl], rtol=1e-12)
        np.testing.assert_allclose(info.r_prim.numpy(), ref["r_prim"][sl],
                                   rtol=1e-9, atol=1e-15)


@pytest.mark.parametrize("name", DP_CASES)
def test_fused_dp_matches_one_process(world, one_card, name):
    ref = one_card[name]
    for r, out in enumerate(_ok(world, name)):
        sl = _rows(name, r, 8)
        np.testing.assert_allclose(_dp_ws(out).numpy(), _dp_ws(ref)[sl].numpy(),
                                   rtol=0, atol=PORT_ATOL)
        if name != "dp_solve":
            assert torch.equal(out[1].rho, ref[1].rho[sl])


def test_fused_dp_warm_state(data, one_card):
    """A returned state warm-starts the next call: on a one-card mesh the
    call is the unsharded ``solve_fused`` with that state."""
    dp = data["dp"]
    st = admm.ADMMSettings(**FUSED_SETTINGS)
    _, state, _ = one_card["dp_split"]
    ws_ref, _, _ = admm.solve_fused(dp["p6"], dp["x6"], (), st, state,
                                    single_kernel=False)
    mesh = make_mesh(*DP_MESH, device="cpu")
    ws, _, _ = fused_dp.solve_fused_dp(mesh, dp["p6"], dp["x6"], (), st,
                                       state=state, single_kernel=False)
    assert torch.equal(ws, ws_ref)
