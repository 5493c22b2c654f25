"""The port's utilities, equilibrated solve and recovery against the JAX
package, on the CPU (float64, inputs from numpy with a seed).

- ``utils.scaling``: ``ruiz_equilibrate`` (both modes) and the scaled
  problem on the quadrotor with its rows scaled across 1e6 (1e-12), and
  ``admm.solve_equilibrated`` on it (1e-9; iteration counts equal).
- ``solvers.recovery``: one indefinite instance in a batch of four, over
  ``sequential.solve_batched`` (against JAX's recovery over its own
  sequential solver: masks and bumps equal, trajectories 1e-10) and over
  ``cuda_riccati.solve_lanes`` on its plain versions (mask equal, healthy
  lanes bit-identical to a plain solve, the sick lane finite).
- ``utils.quality.assess`` (1e-12), ``utils.checkpoint`` (round trip; a
  mismatch raises ValueError), ``utils.profiling`` (the roofline against
  JAX's at the H100's constants, ``failure_mask``, ``time_fn``), and the
  copied ``utils.oracle`` (equal to JAX's on the same problem).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdp_lqr_tpu import init_iterates as jinit_iterates
from pdp_lqr_tpu.models import quadrotor as jquadrotor
from pdp_lqr_tpu.solvers import admm as jadmm
from pdp_lqr_tpu.solvers import recovery as jrecovery
from pdp_lqr_tpu.solvers import sequential as jsequential
from pdp_lqr_tpu.utils import oracle as joracle
from pdp_lqr_tpu.utils import profiling as jprofiling
from pdp_lqr_tpu.utils import quality as jquality
from pdp_lqr_tpu.utils import scaling as jscaling
from pdp_lqr_tpu_torch import convert
from pdp_lqr_tpu_torch.models import double_integrator
from pdp_lqr_tpu_torch.ops import cuda_riccati
from pdp_lqr_tpu_torch.ops.riccati_dense import DenseFactors
from pdp_lqr_tpu_torch.problem import ADMMIterates
from pdp_lqr_tpu_torch.solvers import admm, recovery, sequential
from pdp_lqr_tpu_torch.utils import (
    checkpoint, oracle, profiling, quality, scaling)

N = 8
SIGMA = 1e-6
SCALE_ATOL = 1e-12
SOLVE_ATOL = 1e-9
FIELDS = ("A", "B", "c", "H", "h", "D", "e_lb", "e_ub")


def _np(tree, fields=FIELDS):
    return {f: np.asarray(getattr(tree, f)) for f in fields}


def _t(x):
    return torch.tensor(np.asarray(x))


def _badly_scale(fields, row_span=1e6, cost_scale=1e4):
    """Same feasible set / same argmin, horribly scaled: constraint row i
    multiplied by row_span^(i/nc - 1/2) (bounds too), cost by cost_scale
    (the JAX suite's construction)."""
    nc = fields["D"].shape[-2]
    rs = row_span ** (np.arange(nc) / max(nc - 1, 1) - 0.5)
    return {**fields, "D": fields["D"] * rs[None, :, None],
            "e_lb": fields["e_lb"] * rs[None, :],
            "e_ub": fields["e_ub"] * rs[None, :],
            "H": fields["H"] * cost_scale, "h": fields["h"] * cost_scale}


def _jproblem(fields):
    jp, _ = jquadrotor(N=N, constrained=True, thrust_cone=True)
    return dataclasses.replace(jp, **{k: jnp.asarray(v)
                                      for k, v in fields.items()})


@pytest.fixture(scope="module")
def bad():
    jp, cones = jquadrotor(N=N, constrained=True, thrust_cone=True)
    fields = _badly_scale(_np(jp))
    return {"jax": _jproblem(fields),
            "torch": convert.problem_from_numpy(fields, device="cpu"),
            "cones": tuple(cones), "x0": np.full(12, 0.05)}


@pytest.mark.parametrize("scale_variables", [False, True])
def test_ruiz_equilibrate_matches_jax(bad, scale_variables):
    js = jax.jit(jscaling.ruiz_equilibrate, static_argnums=(1, 2, 3))(
        bad["jax"], bad["cones"], 10, scale_variables)
    ts = scaling.ruiz_equilibrate(bad["torch"], bad["cones"],
                                  scale_variables=scale_variables)
    for f in ("s", "e", "cost"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=SCALE_ATOL,
                                   atol=0, err_msg=f)
    jsp = _np(jscaling.scale_problem(bad["jax"], js))
    tsp = scaling.scale_problem(bad["torch"], ts)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(tsp, f).numpy(), jsp[f],
                                   rtol=SCALE_ATOL, atol=0, err_msg=f)
    # The scaled rows and columns have ~unit inf-norms on active rows.
    active = (bad["torch"].D != 0).any(dim=-1)
    Drow = tsp.D.abs().amax(dim=-1)[active]
    assert float(Drow.min()) > 0.05 and float(Drow.max()) < 20.0


def test_scale_maps_invert(bad):
    """scale_state / unscale_state and the x0 and shift maps against the
    JAX package's, and the state maps invert each other."""
    ts = scaling.ruiz_equilibrate(bad["torch"], bad["cones"])
    js = jscaling.ruiz_equilibrate(bad["jax"], bad["cones"])
    rng = np.random.default_rng(5)
    w, z, y = (rng.normal(size=s) for s in ((N + 1, 16), (N + 1, 19),
                                             (N + 1, 19)))
    st = admm.ADMMState(w=_t(w), z=_t(z), y=_t(y), rho=_t(0.1))
    jst = jadmm.ADMMState(w=jnp.asarray(w), z=jnp.asarray(z),
                          y=jnp.asarray(y), rho=jnp.asarray(0.1))
    got = scaling.scale_state(st, ts)
    want = jscaling.scale_state(jst, js)
    for f in ("w", "z", "y"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=SCALE_ATOL, atol=0, err_msg=f)
    back = scaling.unscale_state(got, ts)
    for f in ("w", "z", "y"):
        np.testing.assert_allclose(getattr(back, f).numpy(), locals()[f],
                                   rtol=SCALE_ATOL, atol=0, err_msg=f)
    np.testing.assert_allclose(
        scaling.scale_x0(_t(bad["x0"]), ts, 4).numpy(),
        np.asarray(jscaling.scale_x0(jnp.asarray(bad["x0"]), js, 4)),
        rtol=SCALE_ATOL)
    shift = rng.normal(size=(N + 1, 19))
    np.testing.assert_allclose(
        scaling.scale_soc_shift(_t(shift), ts).numpy(),
        np.asarray(jscaling.scale_soc_shift(jnp.asarray(shift), js)),
        rtol=SCALE_ATOL)
    for a, b in zip(scaling.residual_weights(ts),
                    jscaling.residual_weights(js)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=SCALE_ATOL)


def test_solve_equilibrated_matches_jax(bad):
    """The Ruiz-scaled solve of the badly scaled quadrotor (thrust cone
    with its shift), 60 iterations, rho adapting every 20th."""
    st = dict(max_iter=60, rho_update_interval=20, eps_abs=1e-4,
              eps_rel=1e-4)
    shift = np.zeros((N + 1, 19))
    shift[:, 16] = 8.0
    jws, jstate, jinfo = jadmm.solve_equilibrated(
        bad["jax"], jnp.asarray(bad["x0"]), bad["cones"],
        jadmm.ADMMSettings(**st), soc_shift=jnp.asarray(shift))
    ws, state, info = admm.solve_equilibrated(
        bad["torch"], _t(bad["x0"]), bad["cones"], admm.ADMMSettings(**st),
        soc_shift=_t(shift))
    np.testing.assert_allclose(ws.numpy(), np.asarray(jws), rtol=0,
                               atol=SOLVE_ATOL)
    for f in ("w", "z"):
        np.testing.assert_allclose(getattr(state, f).numpy(),
                                   np.asarray(getattr(jstate, f)), rtol=0,
                                   atol=SOLVE_ATOL, err_msg=f)
    # y is scaled by e / cost (up to about 1e4 here): relative.
    np.testing.assert_allclose(state.y.numpy(), np.asarray(jstate.y),
                               rtol=SOLVE_ATOL, atol=SOLVE_ATOL)
    np.testing.assert_allclose(float(state.rho), float(jstate.rho),
                               rtol=SOLVE_ATOL)
    for f in ("r_prim", "r_dual"):
        np.testing.assert_allclose(float(getattr(info, f)),
                                   float(getattr(jinfo, f)), rtol=SOLVE_ATOL,
                                   atol=0, err_msg=f)
    for f in ("converged", "iter_converged"):
        assert int(getattr(info, f)) == int(getattr(jinfo, f)), f


def _mixed_batch(B=4, sick=1):
    """Healthy quadrotor batch with instance ``sick`` made indefinite
    (R block - 5 I: chol(Huu) fails at tiny sigma), as numpy fields."""
    jp, _ = jquadrotor(N=N, constrained=True)
    rng = np.random.default_rng(0)
    fields = {k: np.broadcast_to(v, (B,) + v.shape).copy()
              for k, v in _np(jp).items()}
    fields["c"] = fields["c"] + rng.normal(size=fields["c"].shape) * 0.01
    fields["H"][sick, :, :4, :4] -= 5.0 * np.eye(4)
    x0 = rng.normal(size=(B, 12)) * 0.1
    return fields, x0


@pytest.fixture(scope="module")
def mixed():
    fields, x0 = _mixed_batch()
    jp, _ = jquadrotor(N=N, constrained=True)
    jbp = dataclasses.replace(jp, **{k: jnp.asarray(v)
                                     for k, v in fields.items()})
    jits = jax.vmap(lambda p: jinit_iterates(p, rho=0.01))(jbp)
    jfn = lambda p, i, x, s: jsequential.solve_batched(p, i, x, s)[0]
    run = jax.jit(lambda p, i, x: jrecovery.solve_with_recovery(
        jfn, p, i, x, SIGMA, sigma_bump=10.0, retries=1))
    tbp = convert.problem_from_numpy(fields, device="cpu")
    its = convert.iterates_from_numpy(
        {k: np.asarray(getattr(jits, k)) for k in ("w", "y", "z", "rho")},
        device="cpu")
    return {"jax": run(jbp, jits, jnp.asarray(x0)), "problem": tbp,
            "it": its, "x0": _t(x0)}


def _seq(p, i, x, s):
    return sequential.solve_batched(p, i, x, s)[0]


@pytest.mark.parametrize("backend", ["sequential", "solve_lanes"])
def test_recovery_mixed_batch(mixed, backend):
    fn = _seq if backend == "sequential" else cuda_riccati.solve_lanes
    p, it, x0 = mixed["problem"], mixed["it"], mixed["x0"]
    plain = fn(p, it, x0, SIGMA)
    ws, info = recovery.solve_with_recovery(fn, p, it, x0, SIGMA,
                                            sigma_bump=10.0, retries=1)
    jws, jinfo = mixed["jax"]
    for f in ("failed", "recovered", "still_failed"):
        np.testing.assert_array_equal(getattr(info, f).numpy(),
                                      np.asarray(getattr(jinfo, f)), err_msg=f)
    assert info.failed.tolist() == [False, True, False, False]
    np.testing.assert_array_equal(info.bump.numpy(), np.asarray(jinfo.bump))
    assert bool(torch.isfinite(ws).all())
    for b in (0, 2, 3):        # healthy lanes: the plain solve, bit for bit
        assert torch.equal(ws[b], plain[b])
    np.testing.assert_allclose(ws.numpy(), np.asarray(jws), rtol=0,
                               atol=1e-10)


def test_recovery_escalation(mixed):
    """A first bump too small -> the second retry (x10) recovers."""
    ws, info = recovery.solve_with_recovery(
        _seq, mixed["problem"], mixed["it"], mixed["x0"], SIGMA,
        sigma_bump=1.0, retries=2)
    assert not bool(info.still_failed.any())
    assert float(info.bump[1]) == 10.0


def test_recovery_no_failures_is_identity(mixed):
    p = dataclasses.replace(mixed["problem"],
                            H=mixed["problem"].H[[0, 2, 3]])
    p = convert.problem_from_numpy(
        {f: getattr(p, f) if f == "H" else getattr(p, f)[[0, 2, 3]]
         for f in FIELDS}, device="cpu")
    it = ADMMIterates(*(getattr(mixed["it"], f)[[0, 2, 3]]
                        for f in ("w", "y", "z", "rho")))
    x0 = mixed["x0"][[0, 2, 3]]
    ws, info = recovery.solve_with_recovery(_seq, p, it, x0, SIGMA)
    assert not bool(info.failed.any())
    assert torch.equal(ws, _seq(p, it, x0, SIGMA))


@pytest.mark.parametrize("case", ["boxes", "cone+shift"])
def test_assess_matches_jax(case):
    jp, cones = jquadrotor(N=N, constrained=True,
                           thrust_cone=case == "cone+shift")
    cones = tuple(cones or ())
    rng = np.random.default_rng(7)
    ws = rng.normal(size=(N + 1, 16))
    ws[-1, :4] = 0.0
    shift = None
    if cones:
        shift = np.zeros((N + 1, 19))
        shift[:, 16] = 8.0
    want = jquality.assess(jp, jnp.asarray(ws), cones,
                           None if shift is None else jnp.asarray(shift))
    tp = convert.problem_from_numpy(_np(jp), device="cpu")
    got = quality.assess(tp, _t(ws), cones,
                         None if shift is None else _t(shift))
    for f in dataclasses.fields(got):
        np.testing.assert_allclose(float(getattr(got, f.name)),
                                   float(getattr(want, f.name)),
                                   rtol=1e-12, atol=1e-12, err_msg=f.name)
    assert float(got.box_violation) > 0 and "SolveQuality(" in repr(got)


def test_assess_batched_and_solution():
    """On a converged solve: dynamics exact, box to tolerance, objective
    by direct computation; the batched form equals a loop."""
    problem = double_integrator(N=15, constrained=True, u_max=0.3,
                                device="cpu")
    ws, _, info = admm.solve(problem, torch.zeros(2, dtype=torch.float64),
                             settings=admm.ADMMSettings(max_iter=120))
    q = quality.assess(problem, ws)
    assert bool(info.converged)
    assert float(q.dyn_residual) < 1e-10 and float(q.box_violation) < 1e-5
    assert float(q.cone_violation) == 0.0
    obj = 0.5 * torch.einsum("kz,kzw,kw->", ws, problem.H, ws) \
        + torch.einsum("kz,kz->", problem.h, ws)
    np.testing.assert_allclose(float(q.objective), float(obj), rtol=1e-12)
    B = 3
    bp = dataclasses.replace(problem, **{
        f: getattr(problem, f).expand((B,) + getattr(problem, f).shape)
        for f in FIELDS})
    wsb = torch.stack([ws, ws * 1.01, ws * 0.5])
    qb = quality.assess_batched(bp, wsb)
    for b in range(B):
        qi = quality.assess(problem, wsb[b])
        for f in dataclasses.fields(qi):
            np.testing.assert_allclose(float(getattr(qb, f.name)[b]),
                                       float(getattr(qi, f.name)),
                                       rtol=1e-12, atol=1e-15)


def _state():
    problem = double_integrator(N=10, constrained=True, device="cpu")
    settings = admm.ADMMSettings(max_iter=20)
    _, state, _ = admm.solve(problem, torch.tensor([0.5, 0.0],
                                                   dtype=torch.float64),
                             settings=settings)
    return state, settings


def test_checkpoint_roundtrip(tmp_path):
    """An ADMMState with nested factors (a DenseFactors, a bfloat16
    tensor) survives save / load bit for bit."""
    state, settings = _state()
    rng = np.random.default_rng(3)
    fac = DenseFactors(*(_t(rng.normal(size=s)) for s in
                         ((10, 1, 2), (10, 1), (11, 2, 2), (11, 2),
                          (10, 1, 1))))
    state = dataclasses.replace(
        state, factors=(fac, _t(rng.normal(size=4)).to(torch.bfloat16)))
    path = tmp_path / "state.npz"
    checkpoint.save_pytree(path, state)
    fresh = dataclasses.replace(
        state, w=torch.zeros_like(state.w), factors=(
            DenseFactors(*(torch.zeros_like(getattr(fac, f.name))
                           for f in dataclasses.fields(fac))),
            torch.zeros(4, dtype=torch.bfloat16)))
    restored = checkpoint.load_pytree(path, fresh)
    assert isinstance(restored.factors[0], DenseFactors)
    leaves = lambda s: [s.w, s.z, s.y, s.rho, *(
        getattr(s.factors[0], f.name) for f in dataclasses.fields(fac)),
        s.factors[1]]
    for a, b in zip(leaves(state), leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("mismatch", ["shape", "structure"])
def test_checkpoint_mismatch_raises(tmp_path, mismatch):
    state, settings = _state()
    path = tmp_path / "state.npz"
    checkpoint.save_pytree(path, state)
    if mismatch == "shape":
        other = admm.init_state(
            double_integrator(N=12, constrained=True, device="cpu"), settings)
    else:
        other = dataclasses.replace(state, factors=(state.w,))
    with pytest.raises(ValueError):
        checkpoint.load_pytree(path, other)


def test_profiling():
    """The roofline against JAX's at the H100's constants; the failure
    mask; the timer on the host clock."""
    got = profiling.riccati_roofline(N=512, nx=12, nu=4, nc=16, B=512)
    want = jprofiling.riccati_roofline(
        N=512, nx=12, nu=4, nc=16, B=512,
        hbm_gbps=profiling.PEAK_BYTES_PER_S / 1e9,
        vpu_flops=profiling.PEAK_F32_FLOPS)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k] == pytest.approx(want[k], rel=1e-12) \
            if k != "bound" else got[k] == want[k], k
    ws = torch.ones(3, 5, 4)
    ws[1, 2, 0] = float("nan")
    assert profiling.failure_mask(ws).tolist() == [False, True, False]
    t = profiling.time_fn(lambda x: x * 2.0, torch.ones(16), iters=3,
                          device="cpu")
    assert t.p50_ms >= 0.0 and t.compile_s >= 0.0 and t.device == "cpu"


def test_oracle_matches_jax():
    """The port's copy of the numpy witnesses gives the JAX package's
    answers on the same problem (the port's tensors in, numpy out)."""
    jp, _ = jquadrotor(N=N, constrained=True)
    tp = convert.problem_from_numpy(_np(jp), device="cpu")
    jit_ = jinit_iterates(jp, rho=0.01)
    tit = convert.iterates_from_numpy(_np(jit_, ("w", "y", "z", "rho")),
                                      device="cpu")
    x0 = np.full(12, 0.05)
    for name in ("riccati_numpy", "solve_kkt_dense"):
        got = getattr(oracle, name)(tp, tit, SIGMA, _t(x0))
        want = getattr(joracle, name)(jp, jit_, SIGMA, x0)
        np.testing.assert_array_equal(got, want, err_msg=name)
