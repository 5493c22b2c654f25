"""The port's problem model, model functions and sequential solver against the
JAX package, on the CPU in float64.

Inputs are made with numpy from a seed and handed to both packages.  The
model functions assemble their blocks with numpy in both, so their fields must
be equal exactly; derived quantities agree to rounding.
"""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

import pdp_lqr_tpu_torch as plt_
from pdp_lqr_tpu_torch import config as tconfig
from pdp_lqr_tpu_torch import convert
from pdp_lqr_tpu_torch import models as tmodels
from pdp_lqr_tpu_torch.ops import riccati as triccati
from pdp_lqr_tpu_torch.solvers import sequential as tsequential

SIGMA = 1e-6
RHO = 0.01
FIELDS = ("A", "B", "c", "H", "h", "D", "e_lb", "e_ub")


def _np(tree):
    return {f.name: np.asarray(getattr(tree, f.name))
            for f in dataclasses.fields(tree)}


def _first(x):
    """quadrotor returns (problem, cone_specs); the others a problem."""
    return x if isinstance(x, tuple) else (x, None)


MODELS = {
    "quadrotor": ("quadrotor", dict(N=6)),
    "quadrotor-box": ("quadrotor", dict(N=6, constrained=True)),
    "quadrotor-cone": ("quadrotor", dict(N=5, thrust_cone=True)),
    "quadrotor-box-cone": ("quadrotor", dict(N=5, constrained=True,
                                             thrust_cone=True)),
    "double-integrator": ("double_integrator", dict(N=7)),
    "double-integrator-box": ("double_integrator",
                              dict(N=7, constrained=True, u_max=0.5)),
    "random-lq": ("random_lq", dict(nx=4, nu=2, N=9, seed=3)),
    "random-lq-constrained": ("random_lq", dict(nx=5, nu=2, N=8, nc=3, seed=4)),
}


def _both(case, dtype64=True):
    import jax.numpy as jnp
    from pdp_lqr_tpu import models as jmodels

    name, kwargs = MODELS[case]
    jp, jcones = _first(getattr(jmodels, name)(
        **kwargs, dtype=jnp.float64 if dtype64 else jnp.float32))
    tp, tcones = _first(getattr(tmodels, name)(
        **kwargs, dtype=torch.float64 if dtype64 else torch.float32,
        device="cpu"))
    return jp, tp, jcones, tcones


@pytest.mark.parametrize("case", sorted(MODELS))
def test_models_equal_jax(case):
    jp, tp, jcones, tcones = _both(case)
    assert jcones == tcones
    ref = _np(jp)
    for name in FIELDS:
        got = getattr(tp, name)
        assert got.dtype == torch.float64
        np.testing.assert_array_equal(got.numpy(), ref[name], err_msg=name)
    assert (tp.N, tp.nx, tp.nu, tp.nz, tp.nc) == (jp.N, jp.nx, jp.nu, jp.nz, jp.nc)
    np.testing.assert_array_equal(tp.E.numpy(), np.asarray(jp.E))


def test_model_float32_matches_jax():
    jp, tp, _, _ = _both("quadrotor-box", dtype64=False)
    assert tp.H.dtype == torch.float32
    np.testing.assert_array_equal(tp.H.numpy(), np.asarray(jp.H))
    np.testing.assert_array_equal(tp.e_ub.numpy(), np.asarray(jp.e_ub))


def _stage_constraint_kwargs():
    rng = np.random.default_rng(11)
    nx, nu, N = 3, 2, 4
    A = rng.normal(size=(N, nx, nx)) * 0.4
    entries = [
        (rng.normal(size=(2, nx + nu)), -1.0, 1.0),
        None,
        (rng.normal(size=(1, nx + nu)), np.array([-0.5]), np.array([2.0])),
        (rng.normal(size=(3, nx + nu)), -np.ones(3), np.ones(3)),
        (rng.normal(size=(2, nx)), -np.ones(2), np.ones(2)),   # terminal, x only
    ]
    return dict(
        A=A, B=rng.normal(size=(nx, nu)), c=None, Q=np.eye(nx), R=np.eye(nu),
        q=rng.normal(size=(N, nx)), r=None, S=rng.normal(size=(nu, nx)) * 0.1,
        QN=2.0 * np.eye(nx), qN=np.ones(nx), stage_constraints=entries,
    )


def test_build_problem_stage_constraints_equal_jax():
    from pdp_lqr_tpu import build_problem as jbuild

    kwargs = _stage_constraint_kwargs()
    jp = jbuild(**kwargs)
    tp = plt_.build_problem(**kwargs, device="cpu")
    assert tp.nc == 3
    for name, ref in _np(jp).items():
        np.testing.assert_array_equal(getattr(tp, name).numpy(), ref,
                                      err_msg=name)


def test_build_problem_terminal_block_equal_jax():
    from pdp_lqr_tpu import build_problem as jbuild

    rng = np.random.default_rng(5)
    nx, nu = 3, 1
    kwargs = dict(
        A=rng.normal(size=(nx, nx)), B=rng.normal(size=(nx, nu)),
        c=np.zeros(nx), Q=np.eye(nx), R=np.eye(nu), q=np.zeros(nx),
        r=np.zeros(nu), N=5, D=rng.normal(size=(2, nx + nu)),
        e_lb=-np.ones(2), e_ub=np.ones(2), DN=rng.normal(size=(3, nx)),
        e_lbN=-np.ones(3), e_ubN=2 * np.ones(3),
    )
    jp = jbuild(**kwargs)
    tp = plt_.build_problem(**kwargs, device="cpu")
    for name, ref in _np(jp).items():
        np.testing.assert_array_equal(getattr(tp, name).numpy(), ref,
                                      err_msg=name)


@pytest.mark.parametrize("bad", ["no-N", "A-shape", "B-rows", "Q-shape",
                                 "D-cols", "both-forms", "entries"])
def test_build_problem_refuses_what_jax_refuses(bad):
    kwargs = dict(A=np.eye(2), B=np.ones((2, 1)), c=None, Q=np.eye(2),
                  R=np.eye(1), q=np.zeros(2), r=None, N=3)
    if bad == "no-N":
        kwargs.pop("N")
    elif bad == "A-shape":
        kwargs["A"] = np.ones((3, 2, 3))
    elif bad == "B-rows":
        kwargs["B"] = np.ones((3, 1))
    elif bad == "Q-shape":
        kwargs["Q"] = np.eye(3)
    elif bad == "D-cols":
        kwargs.update(D=np.ones((1, 2)), e_lb=-1.0, e_ub=1.0)
    elif bad == "both-forms":
        kwargs.update(D=np.ones((1, 3)), e_lb=-1.0, e_ub=1.0,
                      stage_constraints=[None] * 3)
    else:
        kwargs["stage_constraints"] = [None] * 2
    with pytest.raises(ValueError):
        plt_.build_problem(**kwargs, device="cpu")


def _random_iterates(jp, seed, batch=()):
    rng = np.random.default_rng(seed)
    shape_w = batch + (jp.N + 1, jp.nz)
    shape_c = batch + (jp.N + 1, jp.nc)
    rho = np.where(rng.uniform(size=(jp.N + 1, jp.nc)) < 0.2, 0.0, RHO)
    return dict(w=rng.normal(size=shape_w) * 0.1, y=rng.normal(size=shape_c) * 0.1,
                z=rng.normal(size=shape_c) * 0.1, rho=rho)


@pytest.mark.parametrize("case", ["quadrotor-box", "double-integrator-box",
                                  "random-lq-constrained", "random-lq"])
def test_init_iterates_and_stage_params_equal_jax(case):
    import jax.numpy as jnp
    from pdp_lqr_tpu import ADMMIterates as JIterates
    from pdp_lqr_tpu import init_iterates as jinit
    from pdp_lqr_tpu import make_stage_params as jparams

    jp, tp, _, _ = _both(case)
    jit0, tit0 = jinit(jp, rho=RHO), plt_.init_iterates(tp, rho=RHO)
    for name, ref in _np(jit0).items():
        np.testing.assert_array_equal(getattr(tit0, name).numpy(), ref,
                                      err_msg=name)

    fields = _random_iterates(jp, seed=1)       # some rho rows are 0 (padded)
    jit = JIterates(**{k: jnp.asarray(v) for k, v in fields.items()})
    tit = convert.iterates_from_numpy(fields, device="cpu")
    np.testing.assert_allclose(tit.inv_rho.numpy(), np.asarray(jit.inv_rho),
                               atol=1e-15, rtol=0)
    jprm, tprm = jparams(jp, jit, SIGMA), plt_.make_stage_params(tp, tit, SIGMA)
    for name, ref in _np(jprm).items():
        np.testing.assert_allclose(getattr(tprm, name).numpy(), ref,
                                   atol=1e-15, rtol=0, err_msg=name)


def test_init_iterates_con_mask():
    _, tp, _, _ = _both("double-integrator-box")
    mask = torch.zeros(tp.e_lb.shape, dtype=torch.bool)
    mask[2] = True
    it = plt_.init_iterates(tp, rho=0.3, con_mask=mask)
    assert float(it.rho.sum()) == pytest.approx(0.3)
    assert it.w.shape == tp.h.shape and not it.y.any() and not it.z.any()


SOLVE_CASES = {
    "double-integrator-box": ("double_integrator", dict(N=10, constrained=True)),
    "random-lq": ("random_lq", dict(nx=4, nu=2, N=10, seed=1)),
    "random-lq-constrained": ("random_lq", dict(nx=4, nu=2, N=10, nc=3, seed=2)),
}


@pytest.fixture(scope="module", params=sorted(SOLVE_CASES))
def solved(request):
    """One problem solved by both packages' sequential solvers (the JAX
    side once per case; every test below reads it)."""
    import jax.numpy as jnp
    from pdp_lqr_tpu import ADMMIterates as JIterates
    from pdp_lqr_tpu import make_stage_params as jparams
    from pdp_lqr_tpu import models as jmodels
    from pdp_lqr_tpu.ops import riccati as jriccati
    from pdp_lqr_tpu.solvers import sequential as jsequential

    name, kwargs = SOLVE_CASES[request.param]
    jp = getattr(jmodels, name)(**kwargs)
    tp = getattr(tmodels, name)(**kwargs, device="cpu")
    fields = _random_iterates(jp, seed=21)
    fields2 = dict(_random_iterates(jp, seed=22), rho=fields["rho"])
    x0 = np.random.default_rng(23).normal(size=jp.nx) * 0.1
    jit = JIterates(**{k: jnp.asarray(v) for k, v in fields.items()})
    jit2 = JIterates(**{k: jnp.asarray(v) for k, v in fields2.items()})
    jws, jfac = jsequential.solve(jp, jit, jnp.asarray(x0), SIGMA)
    jws2, jfac2 = jsequential.resolve(jp, jit2, jnp.asarray(x0), SIGMA, jfac)
    jlam = jriccati.costates(jp, jparams(jp, jit, SIGMA), jit.rho, jws)
    return dict(
        tp=tp, x0=torch.as_tensor(x0),
        it=convert.iterates_from_numpy(fields, device="cpu"),
        it2=convert.iterates_from_numpy(fields2, device="cpu"),
        jws=np.asarray(jws), jfac=_np(jfac), jws2=np.asarray(jws2),
        jfac2=_np(jfac2), jlam=np.asarray(jlam),
    )


def test_sequential_solve_matches_jax(solved):
    ws, fac = tsequential.solve(solved["tp"], solved["it"], solved["x0"], SIGMA)
    np.testing.assert_allclose(ws.numpy(), solved["jws"], atol=1e-10, rtol=0)
    for name, ref in solved["jfac"].items():
        np.testing.assert_allclose(getattr(fac, name).numpy(), ref,
                                   atol=1e-10, rtol=0, err_msg=name)
    np.testing.assert_array_equal(fac.Lxx_next[:-1].numpy(),
                                  fac.L[1:, solved["tp"].nu:, solved["tp"].nu:].numpy())
    np.testing.assert_array_equal(fac.p_next[-1].numpy(), fac.pN.numpy())


def test_sequential_resolve_matches_jax(solved):
    """Cached factors, new iterates: the vector-only backward sweep."""
    _, fac = tsequential.solve(solved["tp"], solved["it"], solved["x0"], SIGMA)
    ws2, fac2 = tsequential.resolve(solved["tp"], solved["it2"], solved["x0"],
                                    SIGMA, fac)
    np.testing.assert_allclose(ws2.numpy(), solved["jws2"], atol=1e-10, rtol=0)
    np.testing.assert_allclose(fac2.lp.numpy(), solved["jfac2"]["lp"],
                               atol=1e-10, rtol=0)
    # ... and equals a fresh solve on the new iterates.
    ws3, _ = tsequential.solve(solved["tp"], solved["it2"], solved["x0"], SIGMA)
    np.testing.assert_allclose(ws2.numpy(), ws3.numpy(), atol=1e-10, rtol=0)


def test_costates_match_jax(solved):
    tp, it = solved["tp"], solved["it"]
    ws, _ = tsequential.solve(tp, it, solved["x0"], SIGMA)
    lam = triccati.costates(tp, plt_.make_stage_params(tp, it, SIGMA), it.rho, ws)
    np.testing.assert_allclose(lam.numpy(), solved["jlam"], atol=1e-10, rtol=0)


def test_solve_batched_equals_per_instance_solves(solved):
    tp, it = solved["tp"], solved["it"]
    rng = np.random.default_rng(31)
    nb = 3
    tile = lambda x: x.expand((nb,) + x.shape)
    bp = plt_.LQRProblem(**{f.name: tile(getattr(tp, f.name))
                            for f in dataclasses.fields(tp)})
    bp = dataclasses.replace(
        bp, c=bp.c + torch.as_tensor(rng.normal(size=bp.c.shape) * 0.05))
    bit = plt_.ADMMIterates(**{f.name: tile(getattr(it, f.name))
                               for f in dataclasses.fields(it)})
    x0 = torch.as_tensor(rng.normal(size=(nb, tp.nx)) * 0.1)
    wsb, _ = tsequential.solve_batched(bp, bit, x0, SIGMA)
    for b in range(nb):
        ws, _ = tsequential.solve(dataclasses.replace(tp, c=bp.c[b]), it,
                                  x0[b], SIGMA)
        np.testing.assert_allclose(wsb[b].numpy(), ws.numpy(), atol=1e-12,
                                   rtol=0)
    with pytest.raises(ValueError):
        tsequential.solve_batched(tp, it, x0[0], SIGMA)


def test_quadrotor_hovers_at_one_metre():
    """The reference example's known answer (unconstrained, N=100)."""
    problem, _ = tmodels.quadrotor(N=100, device="cpu")
    it = plt_.init_iterates(problem, rho=RHO)
    ws, _ = tsequential.solve(problem, it, torch.zeros(12, dtype=torch.float64),
                              SIGMA)
    np.testing.assert_allclose(ws[-1, 4:].numpy(),
                               [0, 0, 1] + [0] * 9, atol=1e-6)
    np.testing.assert_allclose(ws[0, :4].numpy(),
                               [-2.898, 2.898, -2.898, 2.898], atol=1e-3)


# ----------------------------------------------------- containers, config

def test_records_move_and_cast():
    problem = tmodels.double_integrator(N=3, constrained=True, device="cpu")
    p32 = problem.to(dtype=torch.float32)
    assert all(getattr(p32, n).dtype == torch.float32 for n in FIELDS)
    assert p32.to("cpu", torch.float64).A.dtype == torch.float64
    with pytest.raises(dataclasses.FrozenInstanceError):
        problem.A = problem.A
    it = plt_.init_iterates(p32)
    assert it.rho.dtype == torch.float32 and it.to(dtype=torch.float64).w.dtype == torch.float64


def test_convert_copies_and_casts():
    src = {k: np.ones((2, 2)) for k in FIELDS}
    for v in src.values():
        v.setflags(write=False)             # as arrays from JAX are
    p = convert.problem_from_numpy(src, device="cpu", dtype=torch.float32)
    assert p.A.dtype == torch.float32
    q = convert.problem_from_numpy(src, device="cpu")
    assert q.A.dtype == torch.float64
    q.A[0, 0] = 5.0                         # a copy: the source is untouched
    assert src["A"][0, 0] == 1.0
    fac = convert.factors_from_numpy(
        tuple(np.arange(24.0).reshape(2, 3, 4) for _ in range(4)), device="cpu")
    assert all(f.shape == (2, 3, 1) and f.is_contiguous() for f in fac)
    assert fac[0][1, 2, 0] == 20.0


def test_config_constants_and_tf32_guard():
    import pdp_lqr_tpu.config as jconfig

    assert tconfig.LQR_INFTY == jconfig.LQR_INFTY
    assert tconfig.DIVISION_TOL == jconfig.DIVISION_TOL
    assert [e.value for e in tconfig.CondensedSolverType] == [
        e.value for e in jconfig.CondensedSolverType]
    tc, jc = tconfig.SolverConfig(), jconfig.SolverConfig()
    for f in dataclasses.fields(tc):
        if f.name not in ("dtype", "condensed_solver"):
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert tc.dtype == torch.float32 and hash(tc) == hash(tconfig.SolverConfig())

    assert torch.backends.cuda.matmul.allow_tf32 is False
    with tconfig.full_f32_matmul():
        pass
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            with tconfig.full_f32_matmul():
                pass
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def test_scenario_server_contract():
    model = tmodels.double_integrator(N=4, constrained=True, device="cpu")
    server = plt_.ScenarioServer(model, device="cpu")
    ws = server.solve(np.zeros((3, 2)))
    assert ws.shape == (3, 5, 3) and ws.device.type == "cpu"
    # Default settings give no batch-shared factors: that is the
    # single-kernel iteration (K8), per-scenario rho, no factors kept.
    ws, state, info = server.solve_admm(np.zeros((3, 2)))
    assert ws.shape == (3, 5, 3) and state.factors is None
    assert info.iterations.tolist() == [250, 250, 250]
    ws, state, info = server.solve_admm(
        np.zeros((3, 2)), settings=plt_.ADMMSettings(
            max_iter=5, cached_factors=True, uniform_rho=True))
    assert ws.shape == (3, 5, 3) and state.z.shape == (3, 5, 1)
    assert info.iterations.tolist() == [5, 5, 5]
    batched = dataclasses.replace(model, A=model.A[None])
    with pytest.raises(ValueError, match="UNBATCHED"):
        plt_.ScenarioServer(batched, device="cpu")


def test_default_device_is_the_card():
    """Entry points default to CUDA; with no card that raises instead of
    quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        tmodels.double_integrator(N=3)
    model = tmodels.double_integrator(N=3, device="cpu")
    with pytest.raises((RuntimeError, AssertionError)):
        plt_.ScenarioServer(model)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, pdp_lqr_tpu_torch, pdp_lqr_tpu_torch.models, "
        "pdp_lqr_tpu_torch.convert, pdp_lqr_tpu_torch.solvers.sequential, "
        "pdp_lqr_tpu_torch.ops.cuda_riccati, pdp_lqr_tpu_torch.ops.cuda_admm, "
        "pdp_lqr_tpu_torch.ops.projections, pdp_lqr_tpu_torch.solvers.admm, "
        "pdp_lqr_tpu_torch.mpc\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'pdp_lqr_tpu' or m.startswith('pdp_lqr_tpu.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
