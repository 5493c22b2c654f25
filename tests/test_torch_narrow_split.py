"""bfloat16 stage and factor streams on the split and ladder iterations,
against the JAX package, on the CPU.

``solve_fused(..., single_kernel=False, storage_dtype=bfloat16)`` on one
shared model stores the stage streams A, B, c, H + sigma I (its diagonal
under ``diag_cost``), h and D in bfloat16 and rounds the factors K, M, P,
L after K1 builds them at full width; K4, K5 and K6 read the narrow
streams and widen them.  The JAX suite has no test of this path: this
file is its only check.  The small model and inputs of
``tests/test_torch_admm.py`` (nx=3, nu=2, six rows with a shifted cone,
N=8, B=6, per-scenario drift, float64).  Module-scoped fixtures make
exactly two JAX calls (interpret mode, about 20 s and 30 s): the adapting
split run (rho from 1e-3, adapting on every third of 18 iterations, so
the factors are rebuilt) and the two-rung ladder (8 iterations, snapping
on every third).  Limits: 1e-9 absolute for a whole solve (the suite's
solve tolerance: summation order is the only difference, both packages
widening the same rounded values), the bfloat16 factors bit for bit;
float32 compute against float64 within 3e-2 relative (a factor entry
rounds to the neighbouring bfloat16 value where the two builds straddle a
rounding boundary: f32's build error of about 1e-6 against bf16's spacing
of 3.9e-3, about one entry in 2,000); narrow against full width at fixed
rho within JAX's own 3e-2 for narrow ADMM storage
(tests/test_pallas_admm.py:300-304).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdp_lqr_tpu.solvers import admm as jadmm
import pdp_lqr_tpu_torch as plt_
from pdp_lqr_tpu_torch import convert
from pdp_lqr_tpu_torch.ops import cuda_admm as ca
from pdp_lqr_tpu_torch.solvers import admm
from test_torch_admm import (
    B, BASE, CONES, FIXED, N, NC, NU, NX, NZ, SOLVE_ATOL, _asdict_np, _model,
    _result_np,
)

BF16 = torch.bfloat16
SPLIT = dict(BASE, rho=1e-3, max_iter=18, adaptive_rho=True,
             rho_update_interval=3, diag_cost=True)
RUNGS = (0.03, 0.3)
LADDER = dict(max_iter=8, adaptive_rho=True, rho_update_interval=3,
              rho_ladder=RUNGS)
F32_REL = 3e-2
QUANT_REL = 3e-2
WRAPPERS = ("admm_bwd_vec_prefold_lanes", "admm_bwd_vec_lanes",
            "admm_fwd_update_lanes")


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    jp = _model()
    shift = np.zeros((N + 1, NC))
    shift[:, 3] = 0.4
    zeros = lambda *s: np.zeros((B,) + s)
    return {"x0": rng.normal(size=(B, NX)) * 0.2,
            "c": rng.normal(size=(B, N, NX)) * 0.01, "shift": shift,
            # The ladder's start: scenario b on rung b mod 2.
            "state": {"w": zeros(N + 1, NZ), "z": zeros(N + 1, NC),
                      "y": zeros(N + 1, NC),
                      "rho": np.array([RUNGS[b % 2] for b in range(B)])},
            "jax": jp,
            "torch": convert.problem_from_numpy(_asdict_np(jp), device="cpu")}


def _jax(setup, settings, ladder):
    jp = dataclasses.replace(setup["jax"], c=jnp.asarray(setup["c"]))
    state = jadmm.ADMMState(**{k: jnp.asarray(v) for k, v in
                               setup["state"].items()}) if ladder else None
    return _result_np(*jadmm.solve_fused(
        jp, jnp.asarray(setup["x0"]), CONES, jadmm.ADMMSettings(**settings),
        state=state, soc_shift=jnp.asarray(setup["shift"]), interpret=True,
        single_kernel=False, storage_dtype=jnp.bfloat16))


@pytest.fixture(scope="module")
def jax_runs(setup):
    return {"split": _jax(setup, SPLIT, False),
            "ladder": _jax(setup, LADDER, True)}


def _port(setup, settings, ladder, storage_dtype=BF16, dtype=torch.float64):
    tp = dataclasses.replace(setup["torch"], c=torch.as_tensor(setup["c"]))
    tp = tp.to(dtype=dtype)
    state = convert.state_from_numpy(setup["state"], device="cpu") \
        if ladder else None
    if state is not None:
        state = dataclasses.replace(state, **{
            f.name: getattr(state, f.name).to(dtype)
            for f in dataclasses.fields(state) if f.name != "factors"})
    return plt_.solve_fused(tp, setup["x0"], CONES,
                            admm.ADMMSettings(**settings), state=state,
                            soc_shift=setup["shift"], single_kernel=False,
                            storage_dtype=storage_dtype)


def _recorded(monkeypatch):
    """The dtypes of every tensor each split wrapper is handed, by name."""
    seen = {}
    for name in WRAPPERS:
        fn = getattr(ca, name)

        def call(*a, _f=fn, _n=name, **kw):
            seen.setdefault(_n, set()).update(
                str(x.dtype) for x in list(a) + list(kw.values())
                if isinstance(x, torch.Tensor) and x.is_floating_point())
            return _f(*a, **kw)
        monkeypatch.setattr(ca, name, call)
    return seen


def _bits(x):
    """The 16-bit patterns of a bfloat16 array or tensor."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _assert_same(got, ref):
    ws, state, info = got
    for name, g, r in (
        ("ws", ws, ref["ws"]), ("w", state.w, ref["state"]["w"]),
        ("z", state.z, ref["state"]["z"]), ("y", state.y, ref["state"]["y"]),
        ("r_prim", info.r_prim, ref["info"]["r_prim"]),
        ("r_dual", info.r_dual, ref["info"]["r_dual"]),
    ):
        assert g.dtype == torch.float64, name
        assert tuple(g.shape) == r.shape, name
        np.testing.assert_allclose(g.numpy(), r, atol=SOLVE_ATOL, rtol=0,
                                   err_msg=name)
    np.testing.assert_allclose(state.rho.numpy(), ref["state"]["rho"],
                               rtol=1e-12, atol=0)
    for name in ("iterations", "converged", "iter_converged"):
        np.testing.assert_array_equal(getattr(info, name).numpy(),
                                      ref["info"][name], err_msg=name)


def _rel(a, ref):
    return float((a.double() - ref.double()).abs().max()
                 / ref.double().abs().max())


def test_split_matches_jax(setup, jax_runs, monkeypatch):
    seen = _recorded(monkeypatch)
    got = _port(setup, SPLIT, False)
    monkeypatch.undo()
    ref = jax_runs["split"]
    _assert_same(got, ref)
    assert np.all(ref["state"]["rho"] != SPLIT["rho"])     # refactored
    # (AK, BL, MK) in bfloat16, JAX's bit for bit (its streams hold the one
    # model on every trailing lane, the port's one copy); (Pc, rho) in the
    # compute type.
    fac, jfac = got[1].factors, ref["state"]["factors"]
    for i, name in enumerate(("AK", "BL", "MK")):
        assert fac[i].dtype == BF16, name
        np.testing.assert_array_equal(_bits(fac[i]), _bits(jfac[i][..., :1]),
                                      err_msg=name)
    assert fac[3].dtype == fac[4].dtype == torch.float64
    np.testing.assert_allclose(fac[3].numpy(), jfac[3], atol=SOLVE_ATOL,
                               rtol=0)
    np.testing.assert_allclose(fac[4].numpy(), jfac[4], rtol=1e-12, atol=0)
    # The kernels were handed narrow streams: no wrapper saw only the
    # compute type.
    assert set(seen) == {"admm_bwd_vec_prefold_lanes",
                         "admm_fwd_update_lanes"}
    assert all(s == {"torch.bfloat16", "torch.float64"} for s in seen.values())


def test_ladder_matches_jax(setup, jax_runs, monkeypatch):
    seen = _recorded(monkeypatch)
    got = _port(setup, LADDER, True)
    monkeypatch.undo()
    ref = jax_runs["ladder"]
    _assert_same(got, ref)
    assert got[1].factors is None and ref["state"]["factors"] is None
    # Scenarios moved between the two rungs.
    assert np.any(ref["state"]["rho"] != setup["state"]["rho"])
    assert set(seen) == {"admm_bwd_vec_lanes", "admm_fwd_update_lanes"}
    assert all(s == {"torch.bfloat16", "torch.float64"} for s in seen.values())


@pytest.mark.parametrize("settings,ladder", [(SPLIT, False), (LADDER, True)])
def test_float32_compute_tracks_float64(setup, settings, ladder):
    ws64, st64, _ = _port(setup, settings, ladder)
    ws32, st32, _ = _port(setup, settings, ladder, dtype=torch.float32)
    assert ws32.dtype == torch.float32
    if not ladder:
        assert [f.dtype for f in st32.factors] == [BF16] * 3 \
            + [torch.float32] * 2
    for a, ref in ((ws32, ws64), (st32.y, st64.y)):
        assert _rel(a, ref) <= F32_REL


@pytest.mark.parametrize("settings,ladder", [
    (FIXED, False), (dict(LADDER, adaptive_rho=False), True)])
def test_narrow_tracks_full_width_at_fixed_rho(setup, settings, ladder):
    narrow = _port(setup, settings, ladder)
    full = _port(setup, settings, ladder, storage_dtype=None)
    assert narrow[0].dtype == full[0].dtype == torch.float64
    assert torch.equal(narrow[1].rho, full[1].rho)
    assert 0 < _rel(narrow[0], full[0]) <= QUANT_REL
    # The compute type as storage type is no storage type at all.
    same = _port(setup, settings, ladder, storage_dtype=torch.float64)
    assert torch.equal(same[0], full[0])


def _kernel_inputs():
    """Small random inputs of K4, K5 (packed) and K6 (two rungs), float64."""
    rng = np.random.default_rng(5)
    T = lambda *s: torch.as_tensor(rng.normal(size=s) * 0.3)
    Nk, R = 3, 2
    L = (torch.tril(T(Nk, R, NU, NU))
         + 2.0 * torch.eye(NU, dtype=torch.float64)).reshape(
        Nk, R * NU, NU, 1)
    ones = lambda *s: torch.ones(s, dtype=torch.float64)
    mask = ones(Nk, NC, 1)
    k4 = dict(pN=T(NX, B), AK=T(Nk, NZ, NX, 1), BL=T(Nk, NZ, NU, 1),
              c=T(Nk, NX, B), Pc=T(Nk, NX, B), hf=T(Nk, NZ, B))
    k6 = dict(rho=T(1, B).abs() + 0.1, pN=T(NX, B), A=T(Nk, NX, NX, 1),
              B=T(Nk, NX, NU, 1), h=T(Nk, NZ, 1), D=T(Nk, NC, NZ, 1),
              mask=mask, P=T(Nk, R * NX, NX, 1), L=L.contiguous(),
              K=T(Nk, R * NU, NX, 1), c=T(Nk, NX, B),
              wzy=T(Nk, NZ + 2 * NC, B))
    bnd = torch.stack([-ones(Nk, NC, 1), ones(Nk, NC, 1), mask], dim=1)
    k5 = dict(rho=T(1, B).abs() + 0.1, x0=T(NX, B), M=T(Nk, NZ, NX, 1),
              K=None, Hs=T(Nk, NZ, 1).abs() + 0.1, D=T(Nk, NC, NZ, 1),
              lb=bnd, ub=None, mask=None, shift=None, dv=T(Nk, NZ, B),
              wzy=T(Nk, NZ + 2 * NC, B))
    rung = torch.as_tensor(np.arange(B) % R, dtype=torch.int32)
    calls = {
        "admm_bwd_vec_prefold_lanes": (
            ("AK", "BL", "c"), k4,
            lambda a: ca.admm_bwd_vec_prefold_lanes(**a, nu=NU)),
        "admm_bwd_vec_lanes": (
            ("A", "B", "h", "D", "P", "L", "K", "c"), k6,
            lambda a: ca.admm_bwd_vec_lanes(**a, nu=NU, sigma=1e-6,
                                            rung=rung)),
        "admm_fwd_update_lanes": (
            ("M", "Hs", "D", "h"), dict(k5, h=T(Nk, NZ, 1)),
            lambda a: ca.admm_fwd_update_lanes(
                **a, nu=NU, cones=(), alpha=1.6, sigma=1e-6)),
    }
    return calls


@pytest.mark.parametrize("name", WRAPPERS)
def test_narrow_wrappers_take_the_whole_set_or_refuse(name):
    narrow_set, args, call = _kernel_inputs()[name]
    full = call(args)
    narrow = {k: v.to(BF16) if k in narrow_set else v for k, v in args.items()}
    widened = {k: v.to(torch.float64) if k in narrow_set else v
               for k, v in narrow.items()}
    before = dict(ca.LAUNCHES)
    # The plain version of a narrow call is the full-width one on the
    # widened streams; on the CPU nothing is launched.
    for a, b in zip(call(narrow), call(widened)):
        assert torch.equal(a, b)
    assert ca.LAUNCHES == before
    assert any(not torch.equal(a, b) for a, b in zip(full, call(widened)))
    first = narrow_set[0]
    with pytest.raises(TypeError, match="one narrow set"):
        call(dict(narrow, **{first: args[first]}))     # one stream full width
    with pytest.raises(TypeError, match="bfloat16 only"):
        call(dict(args, **{k: args[k].to(torch.float16) for k in narrow_set}))
    # The compute-type streams stay in the compute type.
    compute = next(k for k in args if k not in narrow_set
                   and isinstance(args[k], torch.Tensor))
    with pytest.raises(TypeError, match="dtype"):
        call(dict(narrow, **{compute: args[compute].to(BF16)}))
