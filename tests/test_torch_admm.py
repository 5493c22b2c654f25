"""The port's split conic ADMM loop against the JAX package, on the CPU.

Module-scoped fixtures run the JAX side ONCE per case (float64, Pallas in
interpret mode, ``single_kernel=False`` on an unbatched model, N=8, B=6)
on inputs made with numpy from a seed, and keep the results as numpy.  The
model is a small one (nx=3, nu=2, six constraint rows: boxes, an equality
row, a second-order cone with a shift, a terminal row) so that a trace of
the JAX loop costs seconds, and the cases share as few distinct settings as
cover them: each is a fresh trace.  The port runs on ``device="cpu"``
through its kernels' plain PyTorch versions.  Limits: 1e-10 for one kernel
launch, 1e-9 absolute for a whole solve (the JAX suite's own tolerance for
this path: summation order is the only difference), and equality for
everything counted.  The CUDA kernels themselves are held against the plain
versions on the card by ``chip_smoke.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdp_lqr_tpu import build_problem as jbuild_problem
from pdp_lqr_tpu.ops import pallas_admm as jpa
from pdp_lqr_tpu.solvers import admm as jadmm
import pdp_lqr_tpu_torch as plt_
from pdp_lqr_tpu_torch import convert
from pdp_lqr_tpu_torch.ops import cuda_admm as ca
from pdp_lqr_tpu_torch.ops import cuda_riccati as cr
from pdp_lqr_tpu_torch.ops import projections as proj
from pdp_lqr_tpu_torch.solvers import admm

N, B = 8, 6
NX, NU, NC = 3, 2, 6
NZ = NX + NU
CONES = ((3, 3),)               # rows 3..5: ||u|| <= (u0 + u1) / 2 + shift
KERNEL_ATOL = 1e-10
SOLVE_ATOL = 1e-9
BASE = dict(rho=0.1, cached_factors=True, uniform_rho=True)
FIXED = dict(BASE, max_iter=8, adaptive_rho=False)

# name -> (cone + shift?, per-scenario drift?, settings): between them
# fixed and adaptive rho (the start rho is far from balance, so the update
# on every third iteration fires twice within 18 iterations and the factors
# are rebuilt), diag_cost on and off, box rows only, the shifted cone,
# per-scenario drift.
SOLVES = {
    "fixed_rho_box_only_drift": (False, True, FIXED),
    "adaptive_rho_cone_diag": (True, False, dict(
        BASE, rho=1e-3, max_iter=18, adaptive_rho=True, rho_update_interval=3,
        diag_cost=True)),
}
# To convergence (about 290 iterations: the cone is active), rho adapting
# on every 25th.
EARLY = dict(BASE, max_iter=400, adaptive_rho=True, rho_update_interval=25,
             early_exit=True, eps_abs=1e-4, eps_rel=1e-4)


def _asdict_np(tree):
    return {f.name: np.asarray(getattr(tree, f.name))
            for f in dataclasses.fields(tree)}


def _state_np(state):
    out = {k: np.asarray(getattr(state, k)) for k in ("w", "z", "y", "rho")}
    out["factors"] = None if state.factors is None else tuple(
        np.asarray(x) for x in state.factors)
    return out


def _result_np(ws, state, info):
    return {"ws": np.asarray(ws), "state": _state_np(state),
            "info": _asdict_np(info)}


def _model():
    """The test model (diagonal stage cost), built by the JAX package."""
    rng = np.random.default_rng(1)
    A = np.eye(NX) + 0.1 * np.diag(np.ones(NX - 1), 1)
    D = np.zeros((NC, NZ))
    D[0, 0] = D[1, 2] = 1.0                  # boxes on u0 and x0
    D[2, 0], D[2, 1] = 1.0, -1.0             # equality row: u0 = u1
    D[3, :NU] = 0.5                          # cone: t = (u0 + u1) / 2 + shift
    D[4, 0] = D[5, 1] = 1.0                  # ... x = u
    inf = np.inf
    return jbuild_problem(
        A=A, B=rng.normal(size=(NX, NU)) * 0.3, c=np.zeros(NX),
        Q=np.diag([1.0, 2.0, 0.5]), R=np.diag([0.1, 0.2]), q=-np.ones(NX),
        r=np.zeros(NU), D=D, e_lb=np.array([-1.0, -1.0, 0.0, -inf, -inf, -inf]),
        e_ub=np.array([1.0, 1.0, 0.0, inf, inf, inf]),
        DN=np.array([[1.0, 0.0, 0.0]]), e_lbN=np.array([-0.2]),
        e_ubN=np.array([0.4]), N=N, dtype=jnp.float64)


@pytest.fixture(scope="module")
def setup():
    """The model and inputs of both packages, as numpy where they cross."""
    rng = np.random.default_rng(0)
    jp = _model()
    shift = np.zeros((N + 1, NC))
    shift[:, 3] = 0.4
    return {"x0": rng.normal(size=(B, NX)) * 0.2,
            "c": rng.normal(size=(B, N, NX)) * 0.01, "shift": shift,
            "jax": jp,
            "torch": convert.problem_from_numpy(_asdict_np(jp), device="cpu")}


def _jax_solve(setup, cone, drift, settings, state=None):
    jp = setup["jax"]
    if drift:
        jp = dataclasses.replace(jp, c=jnp.asarray(setup["c"]))
    return jadmm.solve_fused(
        jp, jnp.asarray(setup["x0"]), CONES if cone else (),
        jadmm.ADMMSettings(**settings), state=state,
        soc_shift=jnp.asarray(setup["shift"]) if cone else None,
        interpret=True, single_kernel=False)


def _port_solve(setup, cone, drift, settings, state=None):
    server = plt_.ScenarioServer(setup["torch"], device="cpu")
    return server.solve_admm(
        setup["x0"], CONES if cone else (), admm.ADMMSettings(**settings),
        state=state, soc_shift=setup["shift"] if cone else None,
        c=setup["c"] if drift else None)


@pytest.fixture(scope="module")
def jax_solves(setup):
    return {name: _result_np(*_jax_solve(setup, cone, drift, settings))
            for name, (cone, drift, settings) in SOLVES.items()}


def _assert_same(got, ref, *, factors=True):
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
    if factors:
        # ([A;K], [B;L], [M;K], Pc, rho_f): the JAX streams hold the one
        # model replicated over their trailing axis, the port one copy.
        for i, (g, r) in enumerate(zip(state.factors, ref["state"]["factors"])):
            r = r[..., :1] if i < 3 else r
            np.testing.assert_allclose(g.numpy(), r, atol=SOLVE_ATOL, rtol=0)


@pytest.mark.parametrize("name", list(SOLVES))
def test_solve_admm_matches_jax(setup, jax_solves, name):
    cone, drift, settings = SOLVES[name]
    got = _port_solve(setup, cone, drift, settings)
    _assert_same(got, jax_solves[name])
    assert got[0].dtype == torch.float64 and got[0].device.type == "cpu"
    if settings["adaptive_rho"]:          # the refactor branch really ran
        assert np.all(jax_solves[name]["state"]["rho"] != settings["rho"])


def test_diag_cost_changes_nothing_on_a_diagonal_cost(setup):
    plain = _port_solve(setup, True, True, FIXED)
    diag = _port_solve(setup, True, True, dict(FIXED, diag_cost=True))
    for a, b in ((plain[0], diag[0]), (plain[2].r_dual, diag[2].r_dual)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-13, rtol=0)


@pytest.fixture(scope="module")
def jax_early(setup):
    """Early exit to convergence, then two restarts from the returned
    state (one trace serves both): as it is, and with a per-instance rho."""
    cold = _jax_solve(setup, True, False, EARLY)
    restart = jax.jit(lambda state: _jax_solve(setup, True, False, EARLY,
                                               state=state))
    rho_pi = np.asarray(cold[1].rho) * np.linspace(0.5, 1.0, B)
    mixed = dataclasses.replace(cold[1], rho=jnp.asarray(rho_pi))
    return {"cold": _result_np(*cold), "warm": _result_np(*restart(cold[1])),
            "rho_pi": rho_pi, "warm_mixed": _result_np(*restart(mixed))}


def test_early_exit_then_warm_restart_matches_jax(setup, jax_early):
    cold = _port_solve(setup, True, False, EARLY)
    _assert_same(cold, jax_early["cold"])
    assert bool(cold[2].converged.all())
    assert int(cold[2].iterations[0]) < EARLY["max_iter"]
    admm.reset_host_reads()
    warm = _port_solve(setup, True, False, EARLY, state=cold[1])
    _assert_same(warm, jax_early["warm"])
    assert int(warm[2].iterations.max()) <= 3
    assert warm[1].factors[0] is cold[1].factors[0]   # no refactorization
    # One read for the carried factors' rho, one an iteration after the first.
    assert admm.HOST_READS == {"diag_cost": 0, "refactor": 1,
                               "early_exit": int(warm[2].iterations[0])}


def test_jax_state_warm_starts_the_port(setup, jax_early):
    state = convert.state_from_numpy(jax_early["cold"]["state"], device="cpu")
    assert [tuple(x.shape) for x in state.factors] == [
        (N, NZ, NX, 1), (N, NZ, NU, 1), (N, NZ, NX, 1), (N, NX, B), (B,)]
    warm = _port_solve(setup, True, False, EARLY, state=state)
    _assert_same(warm, jax_early["warm"])
    assert warm[1].factors[0] is state.factors[0]


def test_per_instance_rho_collapses_to_the_batch_max(setup, jax_early):
    fields = dict(jax_early["cold"]["state"], rho=jax_early["rho_pi"])
    warm = _port_solve(setup, True, False, EARLY,
                       state=convert.state_from_numpy(fields, device="cpu"))
    _assert_same(warm, jax_early["warm_mixed"])
    assert np.all(warm[1].rho.numpy() == warm[1].rho.numpy()[0])


def test_state_round_trips_through_numpy(setup):
    _, state, _ = _port_solve(setup, False, False, FIXED)
    back = convert.state_from_numpy(convert.state_to_numpy(state), device="cpu")
    for a, b in zip((state.w, state.z, state.y, state.rho) + state.factors,
                    (back.w, back.z, back.y, back.rho) + back.factors):
        assert a.shape == b.shape and torch.equal(a, b)
    moved = state.to(dtype=torch.float32)
    assert moved.w.dtype == moved.factors[3].dtype == torch.float32


def test_no_constraint_rows_is_the_inner_solve(setup):
    jp = setup["jax"]
    free = dataclasses.replace(jp, D=jp.D[:, :0], e_lb=jp.e_lb[:, :0],
                               e_ub=jp.e_ub[:, :0])
    ref = _result_np(*jadmm.solve_fused(
        free, jnp.asarray(setup["x0"]), (), jadmm.ADMMSettings(),
        interpret=True))
    tp = convert.problem_from_numpy(_asdict_np(free), device="cpu")
    got = plt_.solve_fused(tp, setup["x0"], (), admm.ADMMSettings())
    _assert_same(got, ref, factors=False)
    assert got[1].factors is None and got[2].converged.dtype == torch.bool


# ------------------------------------------------- one launch of each kernel

# name -> (cones, diagonal cost, shift): the modes chip_smoke.py holds on
# the card, at this file's widths.
KERNEL_MODES = {
    "box_diag": ((), True, False),
    "box_full_Hs": ((), False, False),
    "soc_shift": (((3, 3, "soc"),), True, True),
    "rsoc": (((1, 4, "rsoc"),), False, False),
}


def _kernel_inputs(cones, diag, shift):
    """Kernel B's packed arguments (numpy) on random data; the shared
    streams carry a trailing size 1."""
    rng = np.random.default_rng(11)
    r = lambda *s, scale=0.3: rng.normal(size=s) * scale
    lb, ub = -np.abs(r(N, NC, 1)), np.abs(r(N, NC, 1))
    lb[:, ::3], ub[:, 1::4] = -np.inf, np.inf
    mask = np.ones((N, NC, 1))
    mask[:, 0 if cones else NC - 1] = 0.0          # a padded row
    mask[N // 2:, NC // 2] = 1e3                   # an equality boost
    for off, dim, _ in cones:
        mask[:, off:off + dim] = 1.0
    bnd = np.stack([lb, ub, mask] + ([r(N, NC, 1)] if shift else []), axis=1)
    return dict(
        rho=rng.uniform(0.05, 2.0, size=(1, B)), x0=r(NX, B),
        MK=r(N, NZ, NX, 1), Hs=np.abs(r(N, NZ, 1)) + 0.1 if diag
        else r(N, NZ, NZ, 1), D=r(N, NC, NZ, 1, scale=0.5), bnd=bnd,
        dv=r(N, NZ, B), wzy=r(N, NZ + 2 * NC, B), h=r(N, NZ, 1))


def _wide(x):
    """The Pallas wrappers want a shared stream as wide as their lane
    chunk (here the batch); the port keeps trailing size 1."""
    return jnp.asarray(np.broadcast_to(x, x.shape[:-1] + (B,)))


@pytest.mark.parametrize("mode", list(KERNEL_MODES))
def test_fwd_update_plain_version_matches_pallas(mode):
    cones, diag, shift = KERNEL_MODES[mode]
    a = _kernel_inputs(cones, diag, shift)
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    got = ca.admm_fwd_update_lanes(
        t["rho"], t["x0"], t["MK"], None, t["Hs"], t["D"], t["bnd"], None,
        None, None, t["dv"], t["wzy"], nu=NU, cones=cones, alpha=1.6,
        sigma=1e-6, h=t["h"])
    ref = jpa.admm_fwd_update_lanes(
        jnp.asarray(a["rho"]), jnp.asarray(a["x0"]), _wide(a["MK"]), None,
        _wide(a["Hs"]), _wide(a["D"]), _wide(a["bnd"]), None, None, None,
        jnp.asarray(a["dv"]), jnp.asarray(a["wzy"]), nu=NU, cones=cones,
        alpha=1.6, sigma=1e-6, h=_wide(a["h"]), interpret=True)
    assert len(got) == len(ref) == 4
    for name, g, r in zip(("wzy", "hf", "xN", "res"), got, ref):
        r = np.asarray(r)
        scale = max(1.0, np.abs(r).max())      # the boosted rows run to 1e3
        np.testing.assert_allclose(g.numpy() / scale, r / scale,
                                   atol=KERNEL_ATOL, rtol=0, err_msg=name)


def test_bwd_vec_prefold_plain_version_matches_pallas():
    rng = np.random.default_rng(12)
    r = lambda *s, scale=0.3: rng.normal(size=s) * scale
    L = np.tril(r(N, NU, NU)) + np.eye(NU) * (1.0 + np.abs(r(N, NU, 1)))
    AK = np.concatenate([r(N, NX, NX), r(N, NU, NX)], axis=1)[..., None]
    BL = np.concatenate([r(N, NX, NU), L], axis=1)[..., None]
    pN, c, Pc, hf = r(NX, B), r(N, NX, B), r(N, NX, B), r(N, NZ, B)
    got = ca.admm_bwd_vec_prefold_lanes(
        *(torch.as_tensor(np.ascontiguousarray(x))
          for x in (pN, AK, BL, c, Pc, hf)), nu=NU)
    ref = jpa.admm_bwd_vec_prefold_lanes(
        jnp.asarray(pN), _wide(AK), _wide(BL), jnp.asarray(c), jnp.asarray(Pc),
        jnp.asarray(hf), nu=NU, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=KERNEL_ATOL,
                               rtol=0)


def test_wrappers_check_their_arguments():
    a = _kernel_inputs((), True, False)
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    call = lambda **kw: ca.admm_fwd_update_lanes(**{**dict(
        rho=t["rho"], x0=t["x0"], M=t["MK"], K=None, Hs=t["Hs"], D=t["D"],
        lb=t["bnd"], ub=None, mask=None, shift=None, dv=t["dv"], wzy=t["wzy"],
        nu=NU, cones=(), alpha=1.6, sigma=1e-6, h=t["h"]), **kw})
    with pytest.raises(TypeError, match="dtype"):
        call(dv=t["dv"].float())
    with pytest.raises(ValueError, match="contiguous"):
        call(wzy=t["wzy"].transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match="shape"):
        call(rho=t["rho"][0])
    # Every form of the JAX wrapper runs; a mix of forms is refused.
    with pytest.raises(ValueError, match="shape"):
        call(K=t["MK"])                     # rung form: MK is not M
    with pytest.raises(ValueError, match="packed mode"):
        call(ub=t["bnd"])                   # MK packed, bounds unpacked
    with pytest.raises(ValueError, match="non-ladder"):
        call(ladder_oh=t["rho"])
    assert len(call(h=None)) == 3           # no hf-emit: no hf output
    with pytest.raises(ValueError, match="cone rows"):
        ca.kernel_defines(torch.float32, 12, 4, 16, cones=((15, 3, "soc"),))
    with pytest.raises(ValueError, match="at most"):
        ca.kernel_defines(torch.float32, 12, 4, 40,
                          cones=tuple((3 * i, 3, "soc") for i in range(9)))
    defines = ca.kernel_defines(torch.float64, 12, 4, 19,
                                cones=proj.normalize_cones([(16, 3)]),
                                diag_cost=True, has_shift=True)
    assert defines == {"SCALAR": "double", "NX": 12, "NU": 4, "NC": 19,
                       "DIAG_COST": 1, "HAS_SHIFT": 1, "NCONES": 1,
                       "CONE0": 16003000}


# --------------------------------------------------- what solve_fused refuses

def _refused(setup, settings=FIXED, batched=False, **kwargs):
    tp = setup["torch"]
    if batched:
        tp = plt_.LQRProblem(**{
            f.name: getattr(tp, f.name)[None].expand(
                (B,) + getattr(tp, f.name).shape)
            for f in dataclasses.fields(tp)})
    return plt_.solve_fused(tp, setup["x0"], CONES,
                            admm.ADMMSettings(**settings),
                            soc_shift=setup["shift"], **kwargs)


@pytest.mark.parametrize("settings,kwargs,match", [
    (dict(cached_factors=True), {}, "needs uniform_rho"),
    (dict(rho_ladder=(0.1,), uniform_rho=True), {}, "one, not both"),
    (dict(max_iter=4), dict(single_kernel=False), "requires cached_factors"),
    (dict(rho_ladder=(0.1,)), dict(single_kernel=True), "shared split"),
    (FIXED, dict(single_kernel=True, residual_weights=(None, None)),
     "residual_weights"),
    (FIXED, dict(residual_weights=(None, None)), "batched problem"),
])
def test_solve_fused_keeps_the_jax_value_errors(setup, settings, kwargs, match):
    with pytest.raises(ValueError, match=match):
        _refused(setup, settings, **kwargs)


def test_batched_ladder_is_a_value_error_as_in_jax(setup):
    with pytest.raises(ValueError, match="shared split"):
        _refused(setup, dict(rho_ladder=(0.1,)), batched=True,
                 single_kernel=False)
    with pytest.raises(ValueError, match="storage_dtype requires"):
        _refused(setup, dict(max_iter=4), batched=True, single_kernel=False,
                 storage_dtype=torch.bfloat16)


BF16 = dict(storage_dtype=torch.bfloat16)


# storage_dtype runs on K8, on the per-scenario inner solve (K1 gains
# only + K7, K11 + K12: solve_lanes and solve_packed) and on the split and
# ladder pairs (the narrow forms of K4-K6; tests/test_torch_narrow_split.py
# holds them against JAX); only another storage type is refused.
@pytest.mark.parametrize("settings,batched,kwargs,match", [
    (FIXED, False, dict(single_kernel=False, **BF16), None),
    (dict(rho_ladder=(0.1, 1.0)), False, BF16, None),
    (dict(rho_ladder=(0.1,)), False, dict(single_kernel=False, **BF16),
     None),
    (None, True, BF16, "storage_dtype"),     # the inner solve's narrow streams
    (FIXED, False, dict(single_kernel=True, storage_dtype=torch.float32),
     "bfloat16 only"),
    (dict(max_iter=4), True, dict(storage_dtype=torch.float32),
     "bfloat16 only"),
])
def test_solve_fused_names_what_is_not_ported(setup, settings, batched, kwargs,
                                              match):
    if settings is None:
        # Ported: solve_lanes on bfloat16 streams equals solve_packed on
        # them bit for bit, and tracks the full-width solve within JAX's
        # bound (tests/test_pallas.py:120); tests/test_torch_narrow_lanes.py
        # holds both against JAX.
        tp = setup["torch"]
        it = plt_.init_iterates(tp)
        batch = lambda x: x[None].expand((B,) + x.shape)
        args = (plt_.LQRProblem(**{f.name: batch(getattr(tp, f.name))
                                   for f in dataclasses.fields(tp)}),
                plt_.ADMMIterates(**{f.name: batch(getattr(it, f.name))
                                     for f in dataclasses.fields(it)}),
                setup["x0"], 1e-6)
        ws = cr.solve_lanes(*args, **kwargs)
        full = cr.solve_lanes(*args)
        assert ws.dtype == full.dtype == torch.float64
        assert torch.equal(ws, cr.solve_packed(*args, **kwargs))
        assert float((ws - full).abs().max() / full.abs().max()) <= 2e-2
        return
    if match is None:
        # Ported: the split and ladder iterations on bfloat16 streams
        # return the compute type, the split one its factors (AK, BL, MK)
        # in bfloat16.
        ws, state, _ = _refused(setup, settings, batched=batched, **kwargs)
        assert ws.dtype == state.w.dtype == state.rho.dtype == torch.float64
        if "rho_ladder" in settings:
            assert state.factors is None
        else:
            assert [f.dtype for f in state.factors] == [torch.bfloat16] * 3 \
                + [torch.float64] * 2
        return
    with pytest.raises(NotImplementedError, match=match):
        _refused(setup, settings, batched=batched, **kwargs)


def test_server_split_false_runs_the_single_kernel(setup, monkeypatch):
    calls = []
    k8 = ca.admm_iter_lanes
    monkeypatch.setattr(ca, "admm_iter_lanes",
                        lambda *a, **kw: (calls.append(1), k8(*a, **kw))[1])
    server = plt_.ScenarioServer(setup["torch"], device="cpu")
    got = server.solve_admm(setup["x0"], CONES, admm.ADMMSettings(**FIXED),
                            soc_shift=setup["shift"], split=False)
    assert len(calls) == FIXED["max_iter"]
    # Cached factors at the uniform rho: (K, M, P, L, rho_f), one copy.
    assert got[1].factors[0].shape == (N, NU, NX, 1)
    ref = plt_.solve_fused(setup["torch"], setup["x0"], CONES,
                           admm.ADMMSettings(**FIXED), soc_shift=setup["shift"],
                           single_kernel=True)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1].y, ref[1].y)


def test_diag_cost_rejects_an_off_diagonal_cost(setup):
    tp = setup["torch"]
    H = tp.H.clone()
    H[:, 0, 1] = 0.5
    with pytest.raises(ValueError, match="off-diagonal"):
        plt_.solve_fused(dataclasses.replace(tp, H=H), setup["x0"], (),
                         admm.ADMMSettings(**dict(FIXED, diag_cost=True)))


def test_public_names():
    for name in ("ADMMSettings", "ADMMState", "ADMMInfo", "solve_fused",
                 "init_state", "mpc"):
        assert name in plt_.__all__ and hasattr(plt_, name)
    assert plt_.mpc.shift_state is not None
    assert jax.config.jax_enable_x64       # the JAX side ran in float64
