"""The port's single-kernel ADMM iteration (K8) against the JAX package, on
the CPU.

The small model of ``tests/test_torch_admm.py`` (nx=3, nu=2, six
constraint rows: boxes, an equality row ``u0 = u1`` that runs at the
boosted rho, a second-order cone with a shift, a terminal row), float64,
Pallas in interpret mode.  One launch of K8 in each of its forms (shared or
batched, cached or not; with and without a shift; bfloat16 stage data
under float64 compute) is held at 1e-10; whole solves at 1e-9:
``ScenarioServer.solve_admm`` with default settings (per-scenario adaptive
rho on one model), cached factors at a uniform rho with bfloat16 storage,
a batched problem with and without cached factors, and ``early_exit``
followed by a warm restart from the JAX package's own state.  Module-scoped
fixtures run each JAX solve once (five traces in all).  The port runs on
``device="cpu"`` through the kernels' plain PyTorch versions; the CUDA
kernel is held against its plain version on the card by ``chip_smoke.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pdp_lqr_tpu as jplt
from pdp_lqr_tpu.models import rocket as jrocket, rocket_x0 as jrocket_x0
from pdp_lqr_tpu.ops import pallas_admm as jpa
from pdp_lqr_tpu.solvers import admm as jadmm
import pdp_lqr_tpu_torch as plt_
from pdp_lqr_tpu_torch import convert
from pdp_lqr_tpu_torch.models import rocket, rocket_x0
from pdp_lqr_tpu_torch.ops import cuda_admm as ca
from pdp_lqr_tpu_torch.ops import cuda_riccati as cr
from pdp_lqr_tpu_torch.solvers import admm
from test_torch_admm import (
    B, CONES, KERNEL_ATOL, N, NC, NU, NX, NZ, SOLVE_ATOL, _asdict_np, _model,
    _result_np,
)

ADAPT = dict(rho=1e-3, max_iter=12, adaptive_rho=True, rho_update_interval=3)
CACHED = dict(ADAPT, cached_factors=True, uniform_rho=True)
FIXED = dict(rho=0.1, max_iter=8, adaptive_rho=False)
# To convergence (the cone is active), rho adapting on every 25th.
EARLY = dict(rho=0.1, max_iter=400, adaptive_rho=True, rho_update_interval=25,
             early_exit=True, eps_abs=1e-4, eps_rel=1e-4, cached_factors=True,
             uniform_rho=True)


def _bf16_exact(x):
    """x rounded to bfloat16 and back: data both packages store alike."""
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float64))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(7)
    jp = _model()
    fields = _asdict_np(jp)
    # The model once a scenario, each perturbed: drift, linear cost, a bound.
    bf = {k: np.repeat(v[None], B, axis=0) for k, v in fields.items()}
    bf["c"] = rng.normal(size=(B, N, NX)) * 0.01
    bf["h"] = bf["h"] + rng.normal(size=bf["h"].shape) * 0.05
    bf["h"][:, -1, :NU] = 0.0
    bf["e_ub"][:, :-1, 1] = rng.uniform(0.5, 1.0, size=(B, 1))
    shift = np.zeros((N + 1, NC))
    shift[:, 3] = 0.4
    return {"x0": rng.normal(size=(B, NX)) * 0.2,
            "c": rng.normal(size=(B, N, NX)) * 0.01, "shift": shift,
            "jax": jp, "torch": convert.problem_from_numpy(fields, device="cpu"),
            "jax_b": type(jp)(**{k: jnp.asarray(v) for k, v in bf.items()}),
            "torch_b": convert.problem_from_numpy(bf, device="cpu")}


def _jax(setup, batched, settings, state=None, **kw):
    jp = setup["jax_b"] if batched else dataclasses.replace(
        setup["jax"], c=jnp.asarray(setup["c"]))
    return jadmm.solve_fused(
        jp, jnp.asarray(setup["x0"]), CONES, jadmm.ADMMSettings(**settings),
        state=state, soc_shift=jnp.asarray(setup["shift"]), interpret=True,
        single_kernel=True, **kw)


def _port(setup, batched, settings, state=None, **kw):
    tp = setup["torch_b"] if batched else dataclasses.replace(
        setup["torch"], c=torch.as_tensor(setup["c"]))
    return plt_.solve_fused(tp, setup["x0"], CONES, admm.ADMMSettings(**settings),
                            state=state, soc_shift=setup["shift"], **kw)


def _assert_same(got, ref, *, rho_rtol=1e-12, factors=True):
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
                               rtol=rho_rtol, atol=0)
    for name in ("iterations", "converged", "iter_converged"):
        np.testing.assert_array_equal(getattr(info, name).numpy(),
                                      ref["info"][name], err_msg=name)
    if factors and ref["state"]["factors"] is not None:
        # (K, M, P, L, rho_f): on one model JAX holds them W lanes wide.
        # Each against its own largest magnitude (P runs to about 35).
        shared = state.factors[0].shape[-1] == 1
        for i, (g, r) in enumerate(zip(state.factors, ref["state"]["factors"])):
            r = r[..., :1] if shared and i < 4 else r
            np.testing.assert_allclose(
                g.numpy(), r, atol=SOLVE_ATOL * max(1.0, np.abs(r).max()),
                rtol=0)


# ---------------------------------------------- one launch of K8, each form

KN = 4                                   # stages of a kernel case
FORMS = [(shared, cached) for shared in (False, True)
         for cached in (False, True)]


def _iter_inputs(shared, cached, shift, seed):
    """K8's arguments (numpy) on random data around a stable model: the
    model's streams have trailing size 1 with ``shared``; a padded row
    (0), the equality row at the boost (1e3); factors from K1's plain
    version with export when ``cached``."""
    rng = np.random.default_rng(seed)
    r = lambda *s, scale=0.3: rng.normal(size=s) * scale
    mb = 1 if shared else B
    A = np.eye(NX)[None, :, :, None] + r(KN, NX, NX, mb, scale=0.1)
    G = r(KN, NZ, NZ, mb)
    Hs = np.einsum("kijb,kljb->kilb", G, G) + 0.5 * np.eye(NZ)[None, :, :, None]
    lb, ub = -np.abs(r(KN, NC, mb)), np.abs(r(KN, NC, mb))
    lb[:, 0], ub[:, 1] = -np.inf, np.inf
    mask = np.ones((KN, NC, mb))
    mask[:, 0], mask[:, 2] = 0.0, 1e3
    GN = r(NX, NX, B)
    args = dict(
        A=A, B=r(KN, NX, NU, mb), c=r(KN, NX, B, scale=0.1), Hs=Hs,
        h=r(KN, NZ, mb), D=r(KN, NC, NZ, mb, scale=0.5), lb=lb, ub=ub,
        mask=mask, shift=r(KN, NC, mb) if shift else None, w=r(KN, NZ, B),
        z=r(KN, NC, B), y=r(KN, NC, B), rho=rng.uniform(0.05, 2.0, (1, B)),
        PN=np.einsum("ijb,ljb->ilb", GN, GN) + np.eye(NX)[:, :, None],
        pN=r(NX, B), x0=r(NX, B))
    factors = None
    if cached:
        t = {k: torch.as_tensor(v) for k, v in args.items() if v is not None}
        zeros = lambda *s: torch.zeros(s + (mb,), dtype=torch.float64)
        K, _, P, L = cr.backward_lanes_reference(
            t["A"], t["B"], t["c"][..., :mb], t["Hs"], zeros(KN, NZ), t["D"],
            t["rho"][0, :mb] * t["mask"], zeros(KN, NC), t["PN"][..., :mb],
            zeros(NX), export_factors=True, emit_closed_loop=False)
        factors = tuple(x.numpy() for x in (P, L, K))
    return args, factors


@pytest.mark.parametrize("storage", ["no_shift", "shift", "bf16_shift"])
@pytest.mark.parametrize("shared,cached", FORMS)
def test_iter_plain_version_matches_pallas(shared, cached, storage):
    args, factors = _iter_inputs(shared, cached, storage != "no_shift",
                                 seed=20 + 2 * shared + cached)
    names = list(args)
    narrow = storage.startswith("bf16")
    if narrow:
        for k in names[:6]:                       # A, B, c, Hs, h, D
            args[k] = _bf16_exact(args[k])
    stream = ("A", "B", "Hs", "h", "D", "lb", "ub", "mask", "shift")
    wide = lambda k, x: np.broadcast_to(x, x.shape[:-1] + (B,)) \
        if shared and k in stream else x
    jargs = [None if v is None else jnp.asarray(wide(k, v))
             for k, v in args.items()]
    targs = [None if v is None else torch.as_tensor(np.ascontiguousarray(v))
             for v in args.values()]
    if narrow:
        jargs[:6] = [x.astype(jnp.bfloat16) for x in jargs[:6]]
        targs[:6] = [x.to(torch.bfloat16) for x in targs[:6]]
    cones = ((3, 3, "soc"),)
    ref = jpa.admm_iter_lanes(
        *jargs, nu=NU, cones=cones, alpha=1.6, sigma=1e-6,
        factors=None if factors is None else tuple(
            jnp.asarray(np.broadcast_to(f, f.shape[:-1] + (B,))) for f in factors),
        shared=shared, interpret=True)
    got = ca.admm_iter_lanes(
        *targs, nu=NU, cones=cones, alpha=1.6, sigma=1e-6,
        factors=None if factors is None else tuple(
            torch.as_tensor(f) for f in factors), shared=shared)
    assert len(got) == len(ref) == 5
    for name, g, r in zip(("w", "z", "y", "xN", "res"), got, ref):
        r = np.asarray(r)
        assert g.dtype == torch.float64 and tuple(g.shape) == r.shape
        scale = max(1.0, np.abs(r).max())      # the boosted row runs to 1e3
        np.testing.assert_allclose(g.numpy() / scale, r / scale,
                                   atol=KERNEL_ATOL, rtol=0, err_msg=name)


def test_iter_wrapper_checks_its_arguments():
    args, factors = _iter_inputs(True, True, False, seed=1)
    t = {k: None if v is None else torch.as_tensor(np.ascontiguousarray(v))
         for k, v in args.items()}
    fac = tuple(torch.as_tensor(f) for f in factors)
    call = lambda **kw: ca.admm_iter_lanes(**{**t, **dict(
        nu=NU, cones=(), alpha=1.6, sigma=1e-6, factors=fac, shared=True),
        **kw})
    assert len(call(PN=None)) == 5          # cached: PN is not read
    with pytest.raises(ValueError, match="shape"):
        call(shared=False)                  # one copy, not one a scenario
    with pytest.raises(TypeError, match="bfloat16"):
        call(A=t["A"].float())
    with pytest.raises(TypeError, match="dtype"):
        call(B=t["B"].to(torch.bfloat16))   # the six stage streams alike
    with pytest.raises(ValueError, match="nc > 0"):
        call(D=t["D"][:, :0], lb=t["lb"][:, :0], ub=t["ub"][:, :0],
             mask=t["mask"][:, :0], z=t["z"][:, :0], y=t["y"][:, :0])
    assert ca.kernel_defines(torch.float32, 6, 3, 7, single=True,
                             cones=((1, 3, "soc"), (4, 3, "soc"))) == {
        "SCALAR": "float", "NX": 6, "NU": 3, "NC": 7, "ITER": 1,
        "HAS_SHIFT": 0, "NCONES": 2, "CONE0": 1003000, "CONE1": 4003000}


# ------------------------------------------------------------ whole solves

@pytest.fixture(scope="module")
def jax_solves(setup):
    rng = np.random.default_rng(8)
    x0 = rng.normal(size=(B, NX)) * 0.2
    c = rng.normal(size=(B, N, NX)) * 0.01
    server = jplt.ScenarioServer(setup["jax"], interpret=True)
    return {
        # ScenarioServer.solve_admm with default settings: per-scenario
        # adaptive rho on one model, 250 iterations (box and equality rows:
        # converged by iteration 71, so adaptation stays on the answer).
        "server": (x0, c, _result_np(*server.solve_admm(
            jnp.asarray(x0), (), c=jnp.asarray(c)))),
        "cached_bf16": _result_np(*_jax(setup, False, CACHED,
                                        storage_dtype=jnp.bfloat16)),
        "batched": _result_np(*_jax(setup, True, FIXED)),
        "batched_cached": _result_np(*_jax(setup, True, dict(
            ADAPT, cached_factors=True))),
    }


def test_server_default_settings_match_jax(setup, jax_solves, monkeypatch):
    x0, c, ref = jax_solves["server"]
    calls = []
    k8 = ca.admm_iter_lanes
    monkeypatch.setattr(ca, "admm_iter_lanes",
                        lambda *a, **kw: (calls.append(kw), k8(*a, **kw))[1])
    admm.reset_host_reads()
    got = plt_.ScenarioServer(setup["torch"], device="cpu").solve_admm(x0, c=c)
    # 250 iterations with rho moving every 25th: rounding reaches rho itself.
    _assert_same(got, ref, rho_rtol=SOLVE_ATOL)
    assert len(calls) == 250 and calls[0]["shared"] and calls[0]["factors"] is None
    assert got[1].factors is None and len(set(got[1].rho.tolist())) == B
    assert admm.HOST_READS == {"diag_cost": 0, "refactor": 0, "early_exit": 0}


@pytest.mark.parametrize("name", ["cached_bf16", "batched", "batched_cached"])
def test_single_kernel_solve_matches_jax(setup, jax_solves, name):
    batched = name.startswith("batched")
    settings = {"cached_bf16": CACHED, "batched": FIXED,
                "batched_cached": dict(ADAPT, cached_factors=True)}[name]
    kw = dict(storage_dtype=torch.bfloat16) if name == "cached_bf16" else {}
    admm.reset_host_reads()
    got = _port(setup, batched, settings, single_kernel=True, **kw)
    _assert_same(got, jax_solves[name])
    if settings["adaptive_rho"]:               # the refactor branch ran
        assert np.all(got[1].rho.numpy() != settings["rho"])
        # The refactor test is read after iterations 3, 6 and 9.
        assert admm.HOST_READS["refactor"] == 3
    if name == "batched_cached":               # per-instance factors
        assert got[1].factors[0].shape == (N, NU, NX, B)
        assert len(set(got[1].rho.tolist())) > 1
        with pytest.raises(ValueError, match="do not cross"):
            convert.state_from_numpy(jax_solves[name]["state"], device="cpu")


@pytest.fixture(scope="module")
def jax_early(setup):
    """Early exit to convergence, then a restart from the returned state:
    one jitted function serves both (the cold start is JAX's own zero
    state, factors at the -1 sentinel, passed explicitly)."""
    run = jax.jit(lambda state: _jax(setup, False, EARLY, state=state))
    zeros = lambda *s: jnp.zeros(s)
    start = jadmm.ADMMState(
        w=zeros(B, N + 1, NZ), z=zeros(B, N + 1, NC), y=zeros(B, N + 1, NC),
        rho=jnp.full((B,), EARLY["rho"]),
        factors=(zeros(N, NU, NX, B), zeros(N, NX, NX, B),
                 zeros(N, NX, NX, B), zeros(N, NU, NU, B), jnp.full((B,), -1.0)))
    cold = run(start)
    return {"cold": _result_np(*cold), "warm": _result_np(*run(cold[1]))}


def test_early_exit_then_warm_restart_from_the_jax_state(setup, jax_early):
    cold = _port(setup, False, EARLY, single_kernel=True)
    # Hundreds of iterations, rho moving every 25th: rounding reaches rho.
    _assert_same(cold, jax_early["cold"], rho_rtol=SOLVE_ATOL)
    assert bool(cold[2].converged.all())
    assert int(cold[2].iterations[0]) < EARLY["max_iter"]
    state = convert.state_from_numpy(jax_early["cold"]["state"], device="cpu")
    assert [tuple(x.shape) for x in state.factors] == [
        (N, NU, NX, 1), (N, NX, NX, 1), (N, NX, NX, 1), (N, NU, NU, 1), (B,)]
    admm.reset_host_reads()
    warm = _port(setup, False, EARLY, state=state, single_kernel=True)
    _assert_same(warm, jax_early["warm"], rho_rtol=SOLVE_ATOL)
    assert warm[1].factors[0] is state.factors[0]      # no refactorization
    assert admm.HOST_READS == {"diag_cost": 0, "refactor": 1,
                               "early_exit": int(warm[2].iterations[0])}
    # Out again: the one copy broadcast over the batch, as JAX holds it.
    out = convert.state_to_numpy(warm[1])
    assert [x.shape for x in out["factors"]] == [
        (N, NU, NX, B), (N, NX, NX, B), (N, NX, NX, B), (N, NU, NU, B), (B,)]
    back = convert.state_from_numpy(out, device="cpu")
    for a, b in zip(warm[1].factors, back.factors):
        assert torch.equal(a, b)


# ----------------------------------------------- the port's "auto" rule

def _auto_route(setup, batched, settings, monkeypatch, **kw):
    """Which iteration ``single_kernel="auto"`` runs, by the first kernel
    wrapper it calls."""
    seen = []
    for mod, name in ((ca, "admm_iter_lanes"), (ca, "admm_bwd_vec_prefold_lanes"),
                      (ca, "admm_bwd_vec_lanes"), (cr, "forward_lanes")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **k: (
            seen.append(_n), _f(*a, **k))[1])
    _port(setup, batched, dict(settings, max_iter=1), **kw)
    monkeypatch.undo()
    return seen[0]


@pytest.mark.parametrize("batched,settings,kw,route", [
    (False, {}, {}, "admm_iter_lanes"),                       # no shared factors
    (False, dict(cached_factors=True, uniform_rho=True), {},
     "admm_bwd_vec_prefold_lanes"),                           # the split pair
    (False, dict(rho_ladder=(0.1, 1.0)), {}, "admm_bwd_vec_lanes"),
    (False, dict(cached_factors=True, uniform_rho=True),
     dict(storage_dtype=torch.bfloat16), "admm_bwd_vec_prefold_lanes"),
    (True, {}, {}, "admm_iter_lanes"),                        # measured faster
    (True, {}, dict(storage_dtype=torch.bfloat16), "admm_iter_lanes"),
    (True, {}, dict(residual_weights=(np.ones((N + 1, NC)),
                                      np.ones((N + 1, NZ)))), "forward_lanes"),
])
def test_auto_rule_choices(setup, monkeypatch, batched, settings, kw, route):
    assert _auto_route(setup, batched, settings, monkeypatch, **kw) == route


# ------------------------------------------------------------ the rocket

def test_rocket_arrays_equal_the_jax_models():
    for N_r in (48, 5):
        jp, jcones = jrocket(N=N_r)
        tp, tcones = rocket(N=N_r, device="cpu")
        assert tcones == jcones == [(1, 3), (4, 3)]
        for k, v in _asdict_np(jp).items():
            np.testing.assert_array_equal(getattr(tp, k).numpy(), v, err_msg=k)
    for batch in (None, 7):
        x_j = np.asarray(jrocket_x0(batch=batch, seed=3))
        x_t = rocket_x0(batch=batch, seed=3, device="cpu")
        assert x_t.dtype == torch.float64
        np.testing.assert_array_equal(x_t.numpy(), x_j)
    p32, _ = rocket(N=4, dtype=torch.float32, device="cpu")
    assert p32.A.dtype == torch.float32 and p32.nc == 7
