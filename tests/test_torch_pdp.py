"""The port's segment-parallel PDP path against the JAX package, on the CPU.

JAX runs on the CPU (float64, Pallas in interpret mode) on inputs made
with numpy from a seed; its multi-device paths run on the suite's eight
virtual CPU devices (``tests/conftest.py``).  The port runs its kernels'
plain PyTorch versions on ``device="cpu"``.  Four JAX traces cover the
file, each a module-scoped fixture run once:

  * K9 (``backward_pdp_lanes``, factors exported) and K10
    (``backward_pdp_vectors_lanes`` on K9's factors) in one jit, on random
    stage data and random SPD carries (nx=3, nu=2, nc=2, N=6, B=3);
  * in one jit, ``pdp_sharded_fused.solve`` on a (batch=4, time=2) mesh
    and a ``shard_map`` on a (batch=2, time=4) mesh that runs the JAX
    module's own ``segment_solve_local`` (what its ``solve`` runs) and
    ``segment_factors_local``, so that the port's ``segment_solve_cached``
    can run on JAX's factors;
  * ``admm_sharded.solve`` uncached, and with ``cached_factors`` +
    ``early_exit``, on the small model of ``tests/test_torch_admm.py``
    (time=2).

Limits: 1e-10 for a kernel's plain version, 1e-9 absolute for a solve,
rho to 1e-9 relative (summation order is the only difference).  The CUDA
kernels themselves are held against the plain versions on the card by
``chip_smoke.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from pdp_lqr_tpu import init_iterates as jinit_iterates
from pdp_lqr_tpu.ops import condensed as jcondensed
from pdp_lqr_tpu.ops import pallas_riccati as jpr
from pdp_lqr_tpu.parallel import admm_sharded as jadmm_sharded
from pdp_lqr_tpu.parallel import mesh as jmesh
from pdp_lqr_tpu.parallel import pdp_sharded_fused as jpsf
from pdp_lqr_tpu.problem import make_stage_params as jmake_stage_params
from pdp_lqr_tpu.solvers import admm as jadmm
import pdp_lqr_tpu_torch as plt_
from pdp_lqr_tpu_torch import convert
from pdp_lqr_tpu_torch.ops import condensed, cuda_riccati as cr
from pdp_lqr_tpu_torch.parallel import admm_sharded, make_mesh
from pdp_lqr_tpu_torch.parallel import pdp_sharded_fused as psf
from pdp_lqr_tpu_torch.solvers import admm, sequential

from test_torch_admm import CONES, _model

KERNEL_ATOL = 1e-10
SOLVE_ATOL = 1e-9
SIGMA = 1e-6

# The kernels' test shape.
KN, KB, KNX, KNU, KNC = 6, 3, 3, 2, 2
K9_NAMES = ("K", "d", "M", "v", "Gp", "P", "L", "F", "P0", "p0", "F0", "C0",
            "f0")
K9_PLAIN = K9_NAMES[:5] + K9_NAMES[8:]
K10_NAMES = ("d", "v", "p0", "f0")

# The solves' shape: the small model (N=8), B=4 scenarios.
SB = 4
ADMM_SOLVES = {
    "uncached": dict(max_iter=18, rho=1e-3, rho_update_interval=3),
    # Converges in every scenario and stops at a chunk boundary (50 of 100
    # iterations), rho adapting every 10th (three scenarios move).
    "cached_early_exit": dict(max_iter=100, rho=1.0, rho_update_interval=10,
                              cached_factors=True, early_exit=True,
                              eps_abs=1e-2, eps_rel=1e-2),
}


def _t(x):
    return torch.as_tensor(np.ascontiguousarray(x))


def _asdict_np(tree):
    return {f.name: np.asarray(getattr(tree, f.name))
            for f in dataclasses.fields(tree)}


def _spd(rng, *shape, n):
    G = rng.normal(size=shape + (n, n)) * 0.3
    return G @ np.swapaxes(G, -1, -2) + np.eye(n)


def _lanes(x):
    """(B, ...) -> batch-last."""
    return np.ascontiguousarray(np.moveaxis(x, 0, -1))


# ------------------------------------------------------------- K9, K10

@pytest.fixture(scope="module")
def kernel_case():
    """Random stage data and carries, and JAX's K9 + K10 on them."""
    rng = np.random.default_rng(3)
    N, B, nx, nu, nc = KN, KB, KNX, KNU, KNC
    nz = nx + nu
    A = np.eye(nx) + rng.normal(size=(B, N, nx, nx)) * 0.2
    inp = {
        "A": A, "B": rng.normal(size=(B, N, nx, nu)) * 0.5,
        "c": rng.normal(size=(B, N, nx)) * 0.1,
        "H": _spd(rng, B, N, n=nz), "h": rng.normal(size=(B, N, nz)) * 0.3,
        "D": rng.normal(size=(B, N, nc, nz)) * 0.5,
        "rho": rng.uniform(0.1, 1.0, size=(B, N, nc)),
        "rg": rng.normal(size=(B, N, nc)) * 0.3,
        "Pi": _spd(rng, B, n=nx), "pi": rng.normal(size=(B, nx)) * 0.3,
        "Fi": np.eye(nx) + rng.normal(size=(B, nx, nx)) * 0.2,
        "Ci": _spd(rng, B, n=nx), "fi": rng.normal(size=(B, nx)) * 0.3,
    }
    inp = {k: _lanes(v) for k, v in inp.items()}
    vec = {"hf": _lanes(rng.normal(size=(B, N, nz)) * 0.3),
           "pi10": _lanes(rng.normal(size=(B, nx)) * 0.3)}

    @jax.jit
    def run(a, hf, pi10):
        k9 = jpr.backward_pdp_lanes(*a, interpret=True, export_factors=True)
        K, P, L, F = k9[0], k9[5], k9[6], k9[7]
        k10 = jpr.backward_pdp_vectors_lanes(a[0], a[1], a[2], hf, P, K, L, F,
                                             pi10, interpret=True)
        return k9, k10

    k9, k10 = run(tuple(jnp.asarray(v) for v in inp.values()),
                  jnp.asarray(vec["hf"]), jnp.asarray(vec["pi10"]))
    return {"in": {k: _t(v) for k, v in inp.items()},
            "hf": _t(vec["hf"]), "pi10": _t(vec["pi10"]),
            "k9": dict(zip(K9_NAMES, map(np.asarray, k9))),
            "k10": dict(zip(K10_NAMES, map(np.asarray, k10)))}


@pytest.fixture(scope="module")
def port_k9(kernel_case):
    args = tuple(kernel_case["in"].values())
    return {export: dict(zip(K9_NAMES if export else K9_PLAIN,
                             cr.backward_pdp_lanes(*args,
                                                   export_factors=export)))
            for export in (False, True)}


@pytest.mark.parametrize("export,name", [(False, n) for n in K9_PLAIN]
                         + [(True, n) for n in K9_NAMES])
def test_backward_pdp_lanes_matches_jax(kernel_case, port_k9, export, name):
    """Both forms against JAX's export form (the plain form's outputs are
    the same quantities)."""
    np.testing.assert_allclose(port_k9[export][name].numpy(),
                               kernel_case["k9"][name], rtol=0,
                               atol=KERNEL_ATOL)


def test_backward_pdp_lanes_C_exactly_symmetric(port_k9):
    C0 = port_k9[True]["C0"]
    assert torch.equal(C0, C0.transpose(0, 1))


@pytest.mark.parametrize("name", K10_NAMES)
def test_backward_pdp_vectors_lanes_matches_jax(kernel_case, port_k9, name):
    k9 = port_k9[True]
    a = kernel_case["in"]
    got = cr.backward_pdp_vectors_lanes(a["A"], a["B"], a["c"],
                                        kernel_case["hf"], k9["P"], k9["K"],
                                        k9["L"], k9["F"], kernel_case["pi10"])
    np.testing.assert_allclose(got[K10_NAMES.index(name)].numpy(),
                               kernel_case["k10"][name], rtol=0,
                               atol=KERNEL_ATOL)


def _split(x, S):
    """(N, ..., B) stage tensor -> the S segments' tensors."""
    return torch.chunk(x, S, dim=0)


def test_segments_are_independent_sweeps(kernel_case):
    """segments=S: each segment is the one-segment sweep from its own
    carry (K9 and K10, both forms), the stage outputs joined, the
    boundaries stacked."""
    a = kernel_case["in"]
    S = 2
    stages = [a[k] for k in ("A", "B", "c", "H", "h", "D", "rho", "rg")]
    carries = [torch.stack([a["Pi"], 2.0 * a["Pi"]]),
               torch.stack([a["pi"], -a["pi"]]),
               torch.stack([a["Fi"], a["Fi"].transpose(0, 1)]),
               torch.stack([a["Ci"], 2.0 * a["Ci"]]),
               torch.stack([a["fi"], -a["fi"]])]
    for export in (False, True):
        whole = cr.backward_pdp_lanes(*stages, *carries, export_factors=export,
                                      segments=S)
        parts = [cr.backward_pdp_lanes(*(_split(x, S)[s] for x in stages),
                                       *(c[s] for c in carries),
                                       export_factors=export)
                 for s in range(S)]
        n_stage = 8 if export else 5
        for i, x in enumerate(whole):
            ref = (torch.cat([p[i] for p in parts]) if i < n_stage
                   else torch.stack([p[i] for p in parts]))
            assert torch.equal(x, ref), i
    K, P, L, F = whole[0], whole[5], whole[6], whole[7]
    pi = torch.stack([kernel_case["pi10"], 0 * kernel_case["pi10"]])
    v_whole = cr.backward_pdp_vectors_lanes(a["A"], a["B"], a["c"],
                                            kernel_case["hf"], P, K, L, F, pi,
                                            segments=S)
    for s in range(S):
        sl = lambda x: _split(x, S)[s]
        one = cr.backward_pdp_vectors_lanes(
            sl(a["A"]), sl(a["B"]), sl(a["c"]), sl(kernel_case["hf"]), sl(P),
            sl(K), sl(L), sl(F), pi[s])
        for i in range(4):
            ref = sl(v_whole[i]) if i < 2 else v_whole[i][s]
            assert torch.equal(one[i], ref), (s, i)


def test_forward_lanes_segments_match_per_segment_rollouts(port_k9):
    k9 = port_k9[False]
    S = 3
    rng = np.random.default_rng(5)
    x0 = _t(rng.normal(size=(S, KNX, KB)))
    ws, xN = cr.forward_lanes(k9["M"], k9["v"], k9["K"], k9["d"], x0,
                              segments=S)
    assert ws.shape == (KN, KNX + KNU, KB) and xN.shape == (S, KNX, KB)
    for s in range(S):
        sl = lambda x: _split(x, S)[s]
        ws_s, x_s = cr.forward_lanes_reference(sl(k9["M"]), sl(k9["v"]),
                                               sl(k9["K"]), sl(k9["d"]), x0[s])
        assert torch.equal(sl(ws), ws_s) and torch.equal(xN[s], x_s)
    # One segment of the segment form is the whole-horizon rollout.
    ws1, xN1 = cr.forward_lanes(k9["M"], k9["v"], k9["K"], k9["d"], x0[:1],
                                segments=1)
    ws0, xN0 = cr.forward_lanes(k9["M"], k9["v"], k9["K"], k9["d"], x0[0])
    assert torch.equal(ws1, ws0) and torch.equal(xN1[0], xN0)


@pytest.mark.parametrize("fault,error", [
    ("segments", ValueError), ("carry_shape", ValueError),
    ("dtype", TypeError), ("shared_segments", ValueError)])
def test_pdp_wrappers_refuse_bad_arguments(kernel_case, port_k9, fault, error):
    a = dict(kernel_case["in"])
    k9 = port_k9[False]
    with pytest.raises(error):
        if fault == "segments":         # 4 segments do not divide N=6
            cr.backward_pdp_lanes(*a.values(), segments=4)
        elif fault == "carry_shape":    # segments=2 wants (2, ...) carries
            cr.backward_pdp_lanes(*a.values(), segments=2)
        elif fault == "dtype":
            a["fi"] = a["fi"].float()
            cr.backward_pdp_lanes(*a.values())
        else:
            cr.forward_lanes(k9["M"][..., :1], k9["v"], k9["K"][..., :1],
                             k9["d"], k9["v"][:2, :, :], shared=True,
                             segments=2)


# ------------------------------------------------------------ condensed

def test_condensed_cholesky_matches_jax_and_isolates_a_failure():
    """cholesky_backward / cholesky_forward against JAX's, (B, S, nx, nx)
    with B=3, S=4; instance 1 gets a boundary P that is not positive
    definite: NaN there in both packages, the others equal."""
    rng = np.random.default_rng(6)
    Bc, S, nx = 3, 4, 3
    P = _spd(rng, Bc, S, n=nx)
    P[1, 2] = -P[1, 2]
    C = _spd(rng, Bc, S, n=nx) * 0.5
    A = np.eye(nx) + rng.normal(size=(Bc, S, nx, nx)) * 0.2
    p, c = rng.normal(size=(Bc, S, nx)), rng.normal(size=(Bc, S, nx))
    x0 = rng.normal(size=(Bc, nx))
    jfac = jcondensed.cholesky_backward(*map(jnp.asarray, (P, A, C)))
    jx, ju = jcondensed.cholesky_forward(jfac, *map(jnp.asarray, (p, c, x0)))
    fac = condensed.cholesky_backward(*map(_t, (P, A, C)))
    x, u = condensed.cholesky_forward(fac, *map(_t, (p, c, x0)))
    for got, ref in ((x, jx), (u, ju), (fac.Pchol, jfac.Pchol),
                     (fac.Cchol, jfac.Cchol), (fac.Pinv, jfac.Pinv),
                     (fac.Asolved, jfac.Asolved)):
        ref = np.asarray(ref)
        np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(ref))
        ok = [0, 2]
        np.testing.assert_allclose(got.numpy()[ok], ref[ok], rtol=0,
                                   atol=KERNEL_ATOL)
    assert np.isnan(x.numpy()[1]).any() and np.isfinite(x.numpy()[[0, 2]]).all()


# ---------------------------------------------------------------- solves

@pytest.fixture(scope="module")
def solve_case():
    """The small model batched B=4 times, per-scenario drift, random
    iterates, in both packages."""
    rng = np.random.default_rng(7)
    jp = _model()
    bp = jax.tree.map(lambda x: jnp.broadcast_to(x, (SB,) + x.shape), jp)
    bp = dataclasses.replace(
        bp, c=bp.c + jnp.asarray(rng.normal(size=bp.c.shape) * 0.01))
    its = jax.vmap(lambda p: jinit_iterates(p, rho=0.1))(bp)
    noise = lambda x: x + jnp.asarray(rng.normal(size=x.shape) * 0.05)
    its = dataclasses.replace(its, w=noise(its.w), z=noise(its.z),
                              y=noise(its.y))
    x0 = rng.normal(size=(SB, jp.nx)) * 0.2
    return {"jax": (bp, its, jnp.asarray(x0)), "x0": x0,
            "problem": convert.problem_from_numpy(_asdict_np(bp), device="cpu"),
            "it": convert.iterates_from_numpy(_asdict_np(its), device="cpu")}


@pytest.fixture(scope="module")
def jax_pdp(solve_case):
    """One jit: ``pdp_sharded_fused.solve`` on (batch=4, time=2), and one
    shard_map on (batch=2, time=4) of the JAX module's segment_solve_local
    (its ``solve``'s body) and segment_factors_local, the factors gathered
    over the mesh."""
    bp, its, x0 = solve_case["jax"]
    S, nu = 4, bp.nu
    mesh2 = jmesh.make_mesh(batch=8 // 2, time=2)
    mesh4 = jmesh.make_mesh(batch=8 // S, time=S)

    def body(A, B, c, H, h, D, rho, g, HN, hN, DN, rhoN, gN, x0):
        l3 = lambda x: jnp.transpose(x, (1, 2, 3, 0))
        l2 = lambda x: jnp.transpose(x, (1, 2, 0))
        PNb, pNb = jpsf.fold_terminal(nu, HN, hN, DN, rhoN, gN)
        ws_l, xN = jpsf.segment_solve_local(
            S, True, l3(A), l3(B), l2(c), l3(H), l2(h), l3(D), l2(rho),
            l2(rho * g), PNb, pNb, x0)
        fac = jpsf.segment_factors_local(S, True, l3(A), l3(B), l3(H), l3(D),
                                         l2(rho), PNb)
        return jnp.transpose(ws_l, (2, 0, 1)), xN, fac

    stage, term = JP("batch", "time"), JP("batch")
    lanes_spec = JP("time", None, None, "batch")
    s4 = jax.shard_map(
        body, mesh=mesh4, in_specs=(stage,) * 8 + (term,) * 6,
        out_specs=(stage, term, (lanes_spec,) * 6 + (term,)),
        check_vma=False)

    @jax.jit
    def run(bp, its, x0):
        params = jax.vmap(lambda p, i: jmake_stage_params(p, i, SIGMA))(bp,
                                                                        its)
        return jpsf.solve(mesh2, bp, its, x0, SIGMA, interpret=True), s4(
            bp.A, bp.B, bp.c, params.H[:, :-1], params.h[:, :-1],
            bp.D[:, :-1], its.rho[:, :-1], params.g[:, :-1], params.H[:, -1],
            params.h[:, -1], bp.D[:, -1], its.rho[:, -1], params.g[:, -1], x0)

    ws2, (ws, xN, fac) = run(bp, its, x0)
    *stages, cf = fac
    return {"ws2": np.asarray(ws2), "ws": np.asarray(ws), "xN": np.asarray(xN),
            "factors": tuple(np.asarray(x) for x in stages)
            + (_asdict_np(cf),)}


@pytest.mark.parametrize("S", [2, 4])
def test_pdp_sharded_fused_solve_matches_jax(solve_case, jax_pdp, S):
    ws = psf.solve(make_mesh(batch=8 // S, time=S, device="cpu"),
                   solve_case["problem"], solve_case["it"], solve_case["x0"],
                   SIGMA)
    nu = solve_case["problem"].nu
    ref = jax_pdp["ws2"] if S == 2 else np.concatenate(
        [jax_pdp["ws"], np.concatenate([np.zeros((SB, 1, nu)),
                                        jax_pdp["xN"][:, None]], axis=-1)],
        axis=1)
    assert ws.shape == ref.shape
    np.testing.assert_allclose(ws.numpy(), ref, rtol=0, atol=SOLVE_ATOL)


@pytest.mark.parametrize("S", [1, 2, 4])
def test_pdp_sharded_fused_solve_matches_sequential(solve_case, S):
    """Against the port's own sequential Riccati solver (the witness):
    the segment split changes nothing but rounding."""
    p, it, x0 = solve_case["problem"], solve_case["it"], solve_case["x0"]
    ws = psf.solve(make_mesh(time=S, device="cpu"), p, it, x0, SIGMA)
    ws_seq, _ = sequential.solve_batched(p, it, _t(x0), SIGMA)
    np.testing.assert_allclose(ws.numpy(), ws_seq.numpy(), rtol=0,
                               atol=SOLVE_ATOL)


def _port_lanes(solve_case):
    """The port's stage streams, the folded terminal and the iterate-folded
    linear cost of the solve case."""
    p, it = solve_case["problem"], solve_case["it"]
    nu = p.nu
    params = plt_.make_stage_params(p, it, SIGMA)
    l = lambda x: cr.to_lanes(x).contiguous()
    rg = it.rho[:, :-1] * params.g[:, :-1]
    hf = l(params.h[:, :-1] - torch.einsum("bkcz,bkc->bkz", p.D[:, :-1], rg))
    PNb, pNb = psf.fold_terminal(nu, params.H[:, -1], params.h[:, -1],
                                 p.D[:, -1], it.rho[:, -1], params.g[:, -1])
    return l(p.A), l(p.B), l(p.c), hf, PNb, pNb


def test_segment_solve_cached_on_jax_factors(solve_case, jax_pdp):
    """JAX's factors (carried over by pdp_factors_from_numpy) and the
    port's vector sweep give JAX's uncached solve."""
    factors = convert.pdp_factors_from_numpy(jax_pdp["factors"], device="cpu")
    A_l, B_l, c_l, hf, PNb, pNb = _port_lanes(solve_case)
    ws_l, xN = psf.segment_solve_cached(4, factors, A_l, B_l, c_l, hf, pNb,
                                        _t(solve_case["x0"]))
    np.testing.assert_allclose(cr.from_lanes(ws_l).numpy(), jax_pdp["ws"],
                               rtol=0, atol=SOLVE_ATOL)
    np.testing.assert_allclose(xN.numpy(), jax_pdp["xN"], rtol=0,
                               atol=SOLVE_ATOL)


def test_port_factors_match_jax_factors(solve_case, jax_pdp):
    p, it = solve_case["problem"], solve_case["it"]
    params = plt_.make_stage_params(p, it, SIGMA)
    l = lambda x: cr.to_lanes(x).contiguous()
    PNb, _ = psf.fold_terminal(p.nu, params.H[:, -1], params.h[:, -1],
                               p.D[:, -1], it.rho[:, -1], params.g[:, -1])
    *stages, fac = psf.segment_factors_local(
        4, l(p.A), l(p.B), l(params.H[:, :-1]), l(p.D[:, :-1]),
        l(it.rho[:, :-1]), PNb)
    *ref_stages, ref_fac = jax_pdp["factors"]
    for got, ref in zip(stages, ref_stages):
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=KERNEL_ATOL)
    for name, ref in ref_fac.items():
        np.testing.assert_allclose(getattr(fac, name).numpy(), ref, rtol=0,
                                   atol=KERNEL_ATOL)


# ------------------------------------------------------- the ADMM loop

@pytest.fixture(scope="module")
def admm_case():
    rng = np.random.default_rng(0)
    jp = _model()
    N, nx = jp.N, jp.nx
    x0 = rng.normal(size=(SB, nx)) * 0.2
    c = rng.normal(size=(SB, N, nx)) * 0.01
    shift = np.zeros((N + 1, jp.nc))
    shift[:, 3] = 0.4
    bp = jax.tree.map(lambda x: jnp.broadcast_to(x, (SB,) + x.shape), jp)
    bp = dataclasses.replace(bp, c=jnp.asarray(c))
    return {"jax": bp, "x0": x0, "shift": shift,
            "torch": convert.problem_from_numpy(_asdict_np(bp), device="cpu")}


@pytest.fixture(scope="module")
def jax_admm(admm_case):
    mesh = jmesh.make_mesh(batch=8 // 2, time=2)
    out = {}
    for name, kw in ADMM_SOLVES.items():
        ws, state, info = jadmm_sharded.solve(
            mesh, admm_case["jax"], jnp.asarray(admm_case["x0"]), CONES,
            jadmm.ADMMSettings(**kw), soc_shift=jnp.asarray(admm_case["shift"]),
            interpret=True)
        out[name] = {"ws": np.asarray(ws), "info": _asdict_np(info),
                     **{k: np.asarray(getattr(state, k))
                        for k in ("w", "z", "y", "rho")}}
    return out


@pytest.mark.parametrize("name", list(ADMM_SOLVES))
def test_admm_sharded_matches_jax(admm_case, jax_admm, name):
    admm.reset_host_reads()
    ws, state, info = admm_sharded.solve(
        make_mesh(batch=8 // 2, time=2, device="cpu"), admm_case["torch"],
        admm_case["x0"], CONES, admm.ADMMSettings(**ADMM_SOLVES[name]),
        soc_shift=admm_case["shift"])
    ref = jax_admm[name]
    for key, got in (("ws", ws), ("w", state.w), ("z", state.z),
                     ("y", state.y)):
        np.testing.assert_allclose(got.numpy(), ref[key], rtol=0,
                                   atol=SOLVE_ATOL, err_msg=key)
    np.testing.assert_allclose(state.rho.numpy(), ref["rho"], rtol=1e-9)
    for key in ("iterations", "converged", "iter_converged"):
        np.testing.assert_array_equal(getattr(info, key).numpy(),
                                      ref["info"][key], err_msg=key)
    if name == "cached_early_exit":
        # Stopped at a chunk boundary with every instance converged; one
        # host read at each chunk boundary passed.
        k = int(info.iterations[0])
        assert k < ADMM_SOLVES[name]["max_iter"] and k % 10 == 0
        assert bool(info.converged.all())
        assert admm.HOST_READS["early_exit"] == k // 10


def test_admm_sharded_launches_no_kernel_on_the_cpu(admm_case):
    cr.reset_launch_counts()
    admm_sharded.solve(make_mesh(time=2, device="cpu"), admm_case["torch"],
                       admm_case["x0"], CONES,
                       admm.ADMMSettings(max_iter=2, cached_factors=True),
                       soc_shift=admm_case["shift"])
    assert set(cr.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("batch,time", [(3, 1), (1, 3)])
def test_mesh_must_divide_batch_and_horizon(admm_case, batch, time):
    with pytest.raises(ValueError, match="divisible"):
        admm_sharded.solve(make_mesh(batch=batch, time=time, device="cpu"),
                           admm_case["torch"], admm_case["x0"])


def test_make_mesh():
    m = make_mesh(batch=2, time=4, device="cpu")
    assert m.shape == {"batch": 2, "time": 4} and m.device.type == "cpu"
    with pytest.raises(ValueError):
        make_mesh(time=0)
