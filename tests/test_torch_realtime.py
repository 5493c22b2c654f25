"""The port's realtime operators against the JAX package, on the CPU.

The quadrotor (``constrained=True``: nx=12, nu=4, 16 box rows) at N=8,
float64, inputs made with numpy from a seed.  Module-scoped fixtures call
each JAX function once, under ``jax.jit`` where it has one trace (an eager
build of the dense map costs about 8 s, a jitted one about 1.5 s), and
keep the results as numpy; the port runs on ``device="cpu"``.  Limits:
1e-10 on a materialized map (T, J, r, the condensed blocks, the batch
map), 1e-9 on a whole replan (the JAX suite's own tolerance for a solve),
equality for every iteration count and rung pick, and the JAX suite's
2e-2 (relative) for the bfloat16-stored map against the float64 one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdp_lqr_tpu.models import quadrotor as jquadrotor
from pdp_lqr_tpu.solvers import admm as jadmm
from pdp_lqr_tpu.solvers import realtime as jrt
from pdp_lqr_tpu_torch import convert
from pdp_lqr_tpu_torch.problem import ADMMIterates
from pdp_lqr_tpu_torch.solvers import admm, realtime, sequential

N = 8
SIGMA = 1e-6
MAP_ATOL = 1e-10
SOLVE_ATOL = 1e-9
SETTINGS = dict(sigma=SIGMA, rho=1.0, max_iter=200, rho_update_interval=200,
                adaptive_rho=False, eps_abs=1e-5, eps_rel=1e-4)
RHOS = (1e-4, 1e-2, 1.0, 1e2)


def _np(tree):
    return {f.name: np.asarray(getattr(tree, f.name))
            for f in dataclasses.fields(tree)}


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module")
def quad():
    jp, _ = jquadrotor(N=N, constrained=True)
    rng = np.random.default_rng(0)
    return {"jax": jp, "torch": convert.problem_from_numpy(_np(jp), device="cpu"),
            "js": jadmm.ADMMSettings(**SETTINGS),
            "ts": admm.ADMMSettings(**SETTINGS),
            "x0": np.full(12, 0.05), "x0b": np.full(12, 0.05) + 1e-3,
            "hf": rng.normal(size=(N + 1) * 16) * 0.3,
            "xr": rng.normal(size=12) * 0.2}


@pytest.fixture(scope="module")
def dense(quad):
    """The dense map on both sides, and a cold and a warm replan."""
    jp, js, ts = quad["jax"], quad["js"], quad["ts"]
    jop = jax.jit(jrt.build_operator, static_argnums=(2, 3))(jp, 1.0, js)
    jw, jst, ji = jrt.solve(jp, jnp.asarray(quad["x0"]), jop, (), js)
    jw2, jst2, ji2 = jrt.solve(jp, jnp.asarray(quad["x0b"]), jop, (), js, jst)
    top = realtime.build_operator(quad["torch"], 1.0, ts)
    return {"jop": jop, "top": top,
            "jax": [(jw, jst, ji), (jw2, jst2, ji2)]}


def _compare_solve(got, want):
    ws, st, info = got
    jws, jst, jinfo = want
    np.testing.assert_allclose(ws.numpy(), np.asarray(jws), rtol=0,
                               atol=SOLVE_ATOL)
    for f in ("z", "y"):
        np.testing.assert_allclose(getattr(st, f).numpy(),
                                   np.asarray(getattr(jst, f)), rtol=0,
                                   atol=SOLVE_ATOL, err_msg=f)
    for f in ("r_prim", "r_dual"):
        np.testing.assert_allclose(float(getattr(info, f)),
                                   float(getattr(jinfo, f)), rtol=0,
                                   atol=SOLVE_ATOL, err_msg=f)
    assert int(info.iterations) == int(jinfo.iterations)
    assert bool(info.converged) == bool(jinfo.converged)


@pytest.mark.parametrize("field", ["T", "J", "r"])
def test_dense_operator_matches_jax(dense, field):
    np.testing.assert_allclose(getattr(dense["top"], field).numpy(),
                               np.asarray(getattr(dense["jop"], field)),
                               rtol=0, atol=MAP_ATOL)


def test_dense_operator_matches_sequential(quad, dense):
    """T/J/r reproduce the sequential solver on arbitrary iterates."""
    tp, top = quad["torch"], dense["top"]
    rng = np.random.default_rng(1)
    mask = admm._con_mask(tp).double()
    it = ADMMIterates(
        w=_t(rng.normal(size=(N + 1, 16)) * 0.1),
        y=_t(rng.normal(size=(N + 1, 16)) * 0.1) * mask,
        z=_t(rng.normal(size=(N + 1, 16)) * 0.1) * mask, rho=mask)
    x0 = _t(rng.normal(size=12) * 0.1)
    ws_ref, _ = sequential.solve(tp, it, x0, SIGMA)
    uterm = torch.ones(N + 1, 16, dtype=torch.float64)
    uterm[-1, :4] = 0.0
    g = it.z - it.inv_rho * it.y
    hf = (tp.h * uterm - SIGMA * it.w
          - torch.einsum("kcz,kc->kz", tp.D, it.rho * g)) * uterm
    ws_op = top.apply_flat(hf.reshape(-1), top.prepare(x0)).reshape(N + 1, 16)
    np.testing.assert_allclose(ws_op.numpy(), ws_ref.numpy(), rtol=0,
                               atol=SOLVE_ATOL)


@pytest.mark.parametrize("tick", ["cold", "warm"])
def test_solve_matches_jax(quad, dense, tick):
    """The same iteration count (early exit) and iterates; the warm tick
    starts from the cold one's state and exits sooner."""
    admm.reset_host_reads()
    got = realtime.solve(quad["torch"], _t(quad["x0"]), dense["top"], (),
                         quad["ts"])
    reads = admm.HOST_READS["early_exit"]
    if tick == "warm":
        got = realtime.solve(quad["torch"], _t(quad["x0b"]), dense["top"], (),
                             quad["ts"], got[1])
        assert int(got[2].iterations) < int(dense["jax"][0][2].iterations)
    _compare_solve(got, dense["jax"][tick == "warm"])
    assert bool(got[2].converged)
    # One read of the exit flag an iteration that is not the last allowed.
    assert reads == int(dense["jax"][0][2].iterations)


def test_solve_matches_admm_solve(quad, dense):
    """Neither path exits early: the iterates of admm.solve (sequential
    inner solver, rho fixed) to rounding."""
    st = admm.ADMMSettings(**{**SETTINGS, "eps_abs": 0.0, "eps_rel": 0.0,
                              "max_iter": 30, "rho_update_interval": 30})
    x0 = _t(quad["x0"])
    ws_rt, st_rt, info_rt = realtime.solve(quad["torch"], x0, dense["top"],
                                           (), st)
    ws_b, st_b, _ = admm.solve(quad["torch"], x0, (), st)
    assert int(info_rt.iterations) == 30
    np.testing.assert_allclose(ws_rt.numpy(), ws_b.numpy(), rtol=0,
                               atol=SOLVE_ATOL)
    np.testing.assert_allclose(st_rt.y.numpy(), st_b.y.numpy(), rtol=0,
                               atol=SOLVE_ATOL)


@pytest.fixture(scope="module")
def condensed(quad):
    js = quad["js"]
    build = jax.jit(jrt.build_condensed_operator, static_argnums=(2, 3, 4))
    return {"jop": build(quad["jax"], 1.0, 4, js),
            "top": {S: realtime.build_condensed_operator(
                quad["torch"], 1.0, S, quad["ts"]) for S in (2, 4, 8)}}


def test_condensed_operator_matches_jax(condensed):
    top, jop = condensed["top"][4], condensed["jop"]
    for f in dataclasses.fields(top):
        np.testing.assert_allclose(getattr(top, f.name).numpy(),
                                   np.asarray(getattr(jop, f.name)), rtol=0,
                                   atol=MAP_ATOL, err_msg=f.name)


@pytest.mark.parametrize("S", [2, 4, 8])
def test_condensed_operator_matches_dense(quad, dense, condensed, S):
    """The segment-factored map is the dense map (same affine function)."""
    hf, x0 = _t(quad["hf"]), _t(quad["xr"])
    top, cop = dense["top"], condensed["top"][S]
    np.testing.assert_allclose(
        cop.apply_flat(hf, cop.prepare(x0)).numpy(),
        top.apply_flat(hf, top.prepare(x0)).numpy(), rtol=0, atol=MAP_ATOL)


def test_condensed_full_solve(quad, dense, condensed):
    """realtime.solve runs unchanged on the factored operator."""
    x0 = _t(quad["x0"])
    ws_d, _, info_d = realtime.solve(quad["torch"], x0, dense["top"], (),
                                     quad["ts"])
    ws_c, _, info_c = realtime.solve(quad["torch"], x0, condensed["top"][4],
                                     (), quad["ts"])
    assert bool(info_c.converged)
    assert int(info_c.iterations) == int(info_d.iterations)
    np.testing.assert_allclose(ws_c.numpy(), ws_d.numpy(), rtol=0,
                               atol=SOLVE_ATOL)


def test_condensed_segment_validation(quad):
    with pytest.raises(ValueError):
        realtime.build_condensed_operator(quad["torch"], 1.0, 3, quad["ts"])


@pytest.fixture(scope="module")
def batch(quad):
    """A shared-structure batch of B=3 (c and x0 per instance), 25
    iterations at rho = 0.5."""
    B = 3
    st = dict(SETTINGS, rho=0.5, max_iter=25, rho_update_interval=25)
    rng = np.random.default_rng(4)
    jp = quad["jax"]
    c = np.asarray(jp.c)[None] + rng.normal(size=(B,) + jp.c.shape) * 0.02
    x0s = rng.normal(size=(B, 12)) * 0.05
    bp = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), jp)
    bp = dataclasses.replace(bp, c=jnp.asarray(c))
    js = jadmm.ADMMSettings(**st)
    jop = jax.jit(jrt.build_batch_operator, static_argnums=(2, 3))(jp, 0.5, js)
    jout = jax.jit(jrt.solve_batch, static_argnums=(3, 4))(
        bp, jnp.asarray(x0s), jop, (), js)
    tp = quad["torch"]
    tbp = convert.problem_from_numpy(
        {**{f: np.broadcast_to(np.asarray(getattr(jp, f)),
                               (B,) + getattr(jp, f).shape)
            for f in ("A", "B", "H", "h", "D", "e_lb", "e_ub")}, "c": c},
        device="cpu")
    ts = admm.ADMMSettings(**st)
    top = realtime.build_batch_operator(tp, 0.5, ts)
    return {"jop": jop, "jout": jout, "top": top, "bp": tbp, "x0s": x0s,
            "ts": ts}


@pytest.mark.parametrize("field", ["T", "Tc", "J"])
def test_batch_operator_matches_jax(batch, field):
    np.testing.assert_allclose(getattr(batch["top"], field).numpy(),
                               np.asarray(getattr(batch["jop"], field)),
                               rtol=0, atol=MAP_ATOL)


def test_solve_batch_matches_jax(batch):
    ws, st, info = realtime.solve_batch(batch["bp"], _t(batch["x0s"]),
                                        batch["top"], (), batch["ts"])
    jws, jst, jinfo = batch["jout"]
    np.testing.assert_allclose(ws.numpy(), np.asarray(jws), rtol=0,
                               atol=SOLVE_ATOL)
    np.testing.assert_allclose(st.y.numpy(), np.asarray(jst.y), rtol=0,
                               atol=SOLVE_ATOL)
    np.testing.assert_allclose(info.r_prim.numpy(), np.asarray(jinfo.r_prim),
                               rtol=0, atol=SOLVE_ATOL)
    for f in ("iterations", "converged", "iter_converged"):
        np.testing.assert_array_equal(getattr(info, f).numpy(),
                                      np.asarray(getattr(jinfo, f)), err_msg=f)


def test_solve_batch_matches_solve_fused(batch):
    """Operator-mode batch == the per-instance loop of solve_fused on the
    same batch (uniform rho, no adaptation)."""
    x0s = _t(batch["x0s"])
    ws, st, info = realtime.solve_batch(batch["bp"], x0s, batch["top"], (),
                                        batch["ts"])
    ws_f, st_f, info_f = admm.solve_fused(batch["bp"], x0s, (), batch["ts"],
                                          single_kernel=False)
    np.testing.assert_allclose(ws.numpy(), ws_f.numpy(), rtol=0,
                               atol=SOLVE_ATOL)
    np.testing.assert_allclose(st.y.numpy(), st_f.y.numpy(), rtol=0,
                               atol=SOLVE_ATOL)


def test_cast_operator_bf16(quad, dense):
    """bfloat16 storage of the ≥2-D blocks (rho exact): the replan still
    converges and tracks the float64 map within the JAX suite's 2e-2
    (relative), and agrees with JAX's bfloat16 replan."""
    st = dict(SETTINGS, eps_abs=1e-3, eps_rel=1e-3)
    op16 = realtime.cast_operator(dense["top"], torch.bfloat16)
    assert op16.T.dtype == op16.J.dtype == torch.bfloat16
    assert op16.r.dtype == op16.rho.dtype == torch.float64
    x0 = np.full(12, 0.02)
    ws, _, info = realtime.solve(quad["torch"], _t(x0), dense["top"], (),
                                 admm.ADMMSettings(**st))
    ws16, _, info16 = realtime.solve(quad["torch"], _t(x0), op16, (),
                                     admm.ADMMSettings(**st))
    assert bool(info16.converged)
    rel = float((ws16 - ws).abs().max()) / float(ws.abs().max())
    assert rel < 2e-2, rel
    jop16 = jrt.cast_operator(dense["jop"], jnp.bfloat16)
    jws16, _, jinfo16 = jrt.solve(quad["jax"], jnp.asarray(x0), jop16, (),
                                  jadmm.ADMMSettings(**st))
    assert int(info16.iterations) == int(jinfo16.iterations)
    np.testing.assert_allclose(ws16.numpy(), np.asarray(jws16), rtol=0,
                               atol=SOLVE_ATOL)


@pytest.fixture(scope="module")
def ladder(quad):
    """Four rungs, four ticks from rung 0 on both sides (tight tolerances,
    so the rung moves)."""
    st = dict(SETTINGS, max_iter=50, rho_update_interval=50, eps_abs=1e-9,
              eps_rel=1e-9)
    js, ts = jadmm.ADMMSettings(**st), admm.ADMMSettings(**st)
    jp, tp = quad["jax"], quad["torch"]
    jlad = jax.jit(jrt.build_ladder, static_argnums=(2, 3))(
        jp, jnp.asarray(RHOS), js)
    jfn = jrt.replan_ladder_fn(jp, jlad, (), js)
    tlad = realtime.build_ladder(tp, RHOS, ts)
    tfn = realtime.replan_ladder_fn(tp, tlad, (), ts)
    x0 = np.full(12, 0.05)
    jstate, tstate = jadmm.init_state(jp, js), admm.init_state(tp, ts)
    jidx, tidx = jnp.asarray(0, jnp.int32), 0
    ticks = []
    for _ in range(4):
        jws, jstate, jinfo, jidx = jfn(jnp.asarray(x0), jstate, jidx)
        tws, tstate, tinfo, tidx = tfn(_t(x0), tstate, tidx)
        ticks.append(((tws, tstate, tinfo, tidx),
                      (jws, jstate, jinfo, int(jidx))))
    return {"ticks": ticks, "tlad": tlad, "jlad": jlad, "ts": ts}


def test_ladder_matches_jax(ladder):
    """Each rung's map, then the rung picks and iterates of four ticks."""
    tlad, jlad = ladder["tlad"], ladder["jlad"]
    np.testing.assert_array_equal(tlad.rhos.numpy(), np.asarray(jlad.rhos))
    for f in ("T", "J", "r"):
        np.testing.assert_allclose(getattr(tlad.ops, f).numpy(),
                                   np.asarray(getattr(jlad.ops, f)), rtol=0,
                                   atol=MAP_ATOL, err_msg=f)
    picks = [(t[3], j[3]) for t, j in ladder["ticks"]]
    assert [p[0] for p in picks] == [p[1] for p in picks], picks
    assert picks[0][0] > 0                  # rho = 1e-4 moves up the ladder
    for (tws, tst, tinfo, tidx), (jws, jst, jinfo, _) in ladder["ticks"]:
        np.testing.assert_allclose(tws.numpy(), np.asarray(jws), rtol=0,
                                   atol=SOLVE_ATOL)
        assert int(tinfo.iterations) == int(jinfo.iterations)
        assert float(tst.rho) == float(np.asarray(jst.rho))


def test_ladder_condensed_rungs(quad, ladder):
    """A ladder of condensed maps holds the dense rungs' maps."""
    lad_c = realtime.build_ladder(quad["torch"], RHOS[1:3], ladder["ts"],
                                  num_segments=4)
    hf, x0 = _t(quad["hf"]), _t(quad["xr"])
    for i in range(2):
        od = ladder["tlad"].select(i + 1)
        oc = lad_c.select(i)
        np.testing.assert_allclose(oc.apply_flat(hf, oc.prepare(x0)).numpy(),
                                   od.apply_flat(hf, od.prepare(x0)).numpy(),
                                   rtol=0, atol=MAP_ATOL)


def test_replan_fn(quad, dense):
    """The replan closure: x0 and the state move, nothing else."""
    fn = realtime.replan_fn(quad["torch"], dense["top"], (), quad["ts"])
    state = admm.init_state(quad["torch"], quad["ts"])
    ws, state, info = fn(torch.zeros(12, dtype=torch.float64), state)
    ws2, state2, info2 = fn(_t(np.full(12, 0.01)), state)
    assert ws2.shape == ws.shape == (N + 1, 16)
    assert state2.factors is None and bool(info2.converged)
