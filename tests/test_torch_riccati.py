"""The port's shared inner solve against the JAX package, on the CPU.

One module-scoped fixture runs the JAX pipeline ONCE (float64, Pallas in
interpret mode) on inputs made with numpy from a seed — quadrotor with
box constraints, N=8, B=5, per-scenario drift ``c`` and batched non-zero
ADMM iterates ``w, y, z`` — and keeps every intermediate as numpy.  The
tests hold the port's plain PyTorch versions (CPU, float64) against
those arrays at ``atol=1e-10``: summation order is the only difference.
The CUDA kernels themselves are held against these plain versions on
the card by ``chip_smoke.py``.
"""

import ctypes
import dataclasses
import types

import numpy as np
import pytest
import torch

import pdp_lqr_tpu_torch as plt_
from pdp_lqr_tpu_torch import convert
from pdp_lqr_tpu_torch.ops import cuda_riccati as cr

SEED = 7
SIGMA = 1e-6
RHO = 0.01
N, B = 8, 5
ATOL = 1e-10

PREP_NAMES = ("A", "B", "H", "D", "rho", "PN", "c", "hf", "pN", "x0")
K1_NAMES = ("K", "d", "M", "v", "P", "L")


def _asdict_np(tree):
    return {f.name: np.asarray(getattr(tree, f.name))
            for f in dataclasses.fields(tree)}


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's shared pipeline, step by step, as numpy."""
    import jax
    import jax.numpy as jnp

    from pdp_lqr_tpu import init_iterates
    from pdp_lqr_tpu.models import quadrotor
    from pdp_lqr_tpu.ops import pallas_riccati as pr

    rng = np.random.default_rng(SEED)
    problem, _ = quadrotor(N=N, constrained=True)
    it0 = init_iterates(problem, rho=RHO)
    noise = lambda x, s: jnp.asarray(rng.normal(size=(B,) + x.shape) * s)
    it = dataclasses.replace(it0, w=noise(it0.w, 0.01), y=noise(it0.y, 0.01),
                             z=noise(it0.z, 0.01))
    x0 = jnp.asarray(rng.normal(size=(B, problem.nx)) * 0.1)
    sp = dataclasses.replace(problem, c=problem.c[None] + noise(problem.c, 0.01))

    prep = pr.prepare_shared(sp, it, x0, SIGMA)
    (A_sh, B_sh, H_sh, D_sh, rho_sh, PN_sh, c_l, hf_l, pN_l, x0_l, nu) = prep
    W = A_sh.shape[-1]
    nx, nz, nc = problem.nx, problem.nz, problem.nc
    zeros = lambda *s: jnp.zeros(s, A_sh.dtype)
    k1 = pr.backward_lanes(
        A_sh, B_sh, zeros(N, nx, W), H_sh, zeros(N, nz, W), D_sh, rho_sh,
        zeros(N, nc, W), PN_sh, zeros(nx, W), interpret=True,
        export_factors=True)
    K, _, M, _, P, L = k1
    Pc = jnp.einsum("kij,kjb->kib", P[..., 0], c_l,
                    precision=jax.lax.Precision.HIGHEST)
    d, v = pr.backward_vectors_lanes(
        A_sh, B_sh, c_l, hf_l, P, K, L, pN_l, interpret=True, shared=True,
        interleave=True, Pc=Pc)
    ws_l, xN = pr.forward_lanes(M, v, K, d, x0_l, interpret=True,
                                shared=True, interleave=True)
    wN = jnp.concatenate([jnp.zeros((B, nu)), xN.T], axis=-1)
    ws = jnp.concatenate([pr.from_lanes(ws_l), wN[:, None, :]], axis=1)

    # The server's request (zero iterates) on the same cached factors:
    # the matrix sweep does not depend on the iterates.
    prep0 = pr.prepare_shared(sp, it0, x0, SIGMA)
    ws0 = pr.solve_shared_cached(prep0, (K, M, P, L), interpret=True)

    out = {
        "problem": _asdict_np(sp), "model": _asdict_np(problem),
        "it": _asdict_np(it), "x0": np.asarray(x0),
        "prep": dict(zip(PREP_NAMES, map(np.asarray, prep[:-1]))), "nu": nu,
        "k1": dict(zip(K1_NAMES, map(np.asarray, k1))),
        "Pc": np.asarray(Pc), "d": np.asarray(d), "v": np.asarray(v),
        "ws_l": np.asarray(ws_l), "xN": np.asarray(xN),
        "ws": np.asarray(ws), "ws0": np.asarray(ws0),
    }
    return out


def _t(x):
    return torch.as_tensor(np.ascontiguousarray(x))


def _lane0(x):
    """The one model out of a JAX tensor that replicates it over its
    trailing axis (the port keeps trailing size 1)."""
    return _t(np.asarray(x)[..., :1])


@pytest.fixture(scope="module")
def port_inputs(jax_run):
    problem = convert.problem_from_numpy(jax_run["problem"], device="cpu")
    it = convert.iterates_from_numpy(jax_run["it"], device="cpu")
    return problem, it, _t(jax_run["x0"])


@pytest.fixture(scope="module")
def port_prep(port_inputs):
    return cr.prepare_shared(*port_inputs, SIGMA)


@pytest.mark.parametrize("name", PREP_NAMES)
def test_prepare_shared_matches_jax(jax_run, port_prep, name):
    ref = jax_run["prep"][name]
    got = port_prep[PREP_NAMES.index(name)]
    if name in ("A", "B", "H", "D", "rho", "PN"):
        # JAX replicates the one model over W lanes; the port keeps one.
        assert got.shape[-1] == 1
        assert np.all(ref == ref[..., :1])
        ref = ref[..., :1]
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    assert port_prep[-1] == jax_run["nu"]


@pytest.fixture(scope="module")
def port_k1(port_prep):
    """K1's plain version on the port's own prepared inputs."""
    (A, Bm, H, D, rho, PN, *_rest) = port_prep
    n, nx = A.shape[0], A.shape[1]
    z = lambda *s: torch.zeros(s, dtype=A.dtype)
    return cr.backward_lanes(A, Bm, z(n, nx, 1), H, z(n, H.shape[1], 1), D,
                             rho, z(n, D.shape[1], 1), PN, z(nx, 1),
                             export_factors=True)


@pytest.mark.parametrize("name", K1_NAMES)
def test_backward_lanes_matches_jax(jax_run, port_k1, name):
    got = port_k1[K1_NAMES.index(name)]
    ref = jax_run["k1"][name]
    assert got.shape == ref.shape[:-1] + (1,)
    np.testing.assert_allclose(got.numpy(), ref[..., :1], atol=ATOL, rtol=0)


def test_backward_lanes_exports_symmetric_P_and_lower_L(port_k1):
    P, L = port_k1[4][..., 0], port_k1[5][..., 0]
    assert torch.equal(P, P.transpose(-1, -2))
    assert torch.equal(L, L.tril())


def test_shared_factors_from_numpy_matches_port(jax_run, port_prep, port_k1):
    """The JAX factors, carried over, equal the port's own."""
    k1 = jax_run["k1"]
    carried = convert.factors_from_numpy(
        (k1["K"], k1["M"], k1["P"], k1["L"]), device="cpu")
    own = cr.shared_factors(port_prep)
    K, _, M, _, P, L = port_k1
    for a, b, c_ in zip(carried, own, (K, M, P, L)):
        assert a.shape == b.shape and a.is_contiguous()
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, rtol=0)
        assert torch.equal(b, c_)


def _jax_factors(jax_run):
    k1 = jax_run["k1"]
    return {n: _lane0(k1[n]) for n in K1_NAMES}


def test_fold_Pc_matches_jax(jax_run):
    f = _jax_factors(jax_run)
    Pc = cr.fold_Pc(f["P"], _t(jax_run["prep"]["c"]))
    np.testing.assert_allclose(Pc.numpy(), jax_run["Pc"], atol=ATOL, rtol=0)


@pytest.mark.parametrize("pc_mode", [True, False], ids=["Pc", "P"])
@pytest.mark.parametrize("out", ["d", "v"])
def test_backward_vectors_lanes_matches_jax(jax_run, out, pc_mode):
    """K2 on the JAX side's own inputs (so an error in K1 cannot hide
    here); the plain-P mode must give what the Pc mode gives."""
    f = _jax_factors(jax_run)
    p = jax_run["prep"]
    d, v = cr.backward_vectors_lanes(
        _lane0(p["A"]), _lane0(p["B"]), _t(p["c"]), _t(p["hf"]), f["P"],
        f["K"], f["L"], _t(p["pN"]), shared=True,
        Pc=_t(jax_run["Pc"]) if pc_mode else None)
    got = {"d": d, "v": v}[out]
    np.testing.assert_allclose(got.numpy(), jax_run[out], atol=ATOL, rtol=0)


@pytest.mark.parametrize("out", ["ws_l", "xN"])
def test_forward_lanes_matches_jax(jax_run, out):
    f = _jax_factors(jax_run)
    ws_l, xN = cr.forward_lanes(
        f["M"], _t(jax_run["v"]), f["K"], _t(jax_run["d"]),
        _t(jax_run["prep"]["x0"]), shared=True)
    got = {"ws_l": ws_l, "xN": xN}[out]
    np.testing.assert_allclose(got.numpy(), jax_run[out], atol=ATOL, rtol=0)


def test_per_instance_mode_equals_shared_mode(jax_run):
    """Trailing size B on the matrices (one set per scenario) computes
    what trailing size 1 (one shared model) computes."""
    f = _jax_factors(jax_run)
    p = jax_run["prep"]
    wide = lambda x: x.expand(x.shape[:-1] + (B,)).contiguous()
    A, Bm = _lane0(p["A"]), _lane0(p["B"])
    c, hf, pN, x0 = _t(p["c"]), _t(p["hf"]), _t(p["pN"]), _t(p["x0"])
    d, v = cr.backward_vectors_lanes(A, Bm, c, hf, f["P"], f["K"], f["L"],
                                     pN, shared=True)
    dw, vw = cr.backward_vectors_lanes(
        wide(A), wide(Bm), c, hf, wide(f["P"]), wide(f["K"]), wide(f["L"]), pN)
    np.testing.assert_allclose(dw.numpy(), d.numpy(), atol=1e-13, rtol=0)
    np.testing.assert_allclose(vw.numpy(), v.numpy(), atol=1e-13, rtol=0)
    ws, xN = cr.forward_lanes(f["M"], v, f["K"], d, x0, shared=True)
    wsw, xNw = cr.forward_lanes(wide(f["M"]), v, wide(f["K"]), d, x0)
    np.testing.assert_allclose(wsw.numpy(), ws.numpy(), atol=1e-13, rtol=0)
    np.testing.assert_allclose(xNw.numpy(), xN.numpy(), atol=1e-13, rtol=0)


def test_solve_shared_matches_jax(jax_run, port_inputs):
    """The slice as a whole, with batched non-zero iterates."""
    ws = cr.solve_shared(*port_inputs, SIGMA)
    assert ws.shape == (B, N + 1, 16)
    np.testing.assert_allclose(ws.numpy(), jax_run["ws"], atol=ATOL, rtol=0)


def test_solve_shared_cached_matches_jax(jax_run, port_prep):
    ws = cr.solve_shared_cached(port_prep, cr.shared_factors(port_prep))
    np.testing.assert_allclose(ws.numpy(), jax_run["ws"], atol=ATOL, rtol=0)


def _server_request(jax_run, dtype):
    model = convert.problem_from_numpy(jax_run["model"], device="cpu",
                                       dtype=dtype)
    server = plt_.ScenarioServer(model, rho=RHO, sigma=SIGMA, device="cpu")
    return server.solve(jax_run["x0"], c=jax_run["problem"]["c"])


def test_scenario_server_solve_matches_jax(jax_run):
    ws = _server_request(jax_run, torch.float64)
    assert ws.dtype == torch.float64
    np.testing.assert_allclose(ws.numpy(), jax_run["ws0"], atol=ATOL, rtol=0)


def test_scenario_server_solve_float32(jax_run):
    """The whole slice in float32 against the float64 JAX answer:
    rounding of a float32 solve over 8 stages."""
    ws = _server_request(jax_run, torch.float32)
    assert ws.dtype == torch.float32
    np.testing.assert_allclose(ws.numpy(), jax_run["ws0"], rtol=1e-4,
                               atol=1e-4)


def test_scenario_server_matches_port_sequential(jax_run):
    """Kernel path (dense P-form) against the port's own sequential
    square-root Riccati: two derivations, one answer."""
    from pdp_lqr_tpu_torch.solvers import sequential

    model = convert.problem_from_numpy(jax_run["model"], device="cpu")
    it = plt_.init_iterates(model, rho=RHO)
    ws = _server_request(jax_run, torch.float64)
    c = _t(jax_run["problem"]["c"])
    x0 = _t(jax_run["x0"])
    tile = lambda x: x.expand((B,) + x.shape)
    bm = plt_.LQRProblem(**{f.name: tile(getattr(model, f.name))
                            for f in dataclasses.fields(model)})
    bit = plt_.ADMMIterates(**{f.name: tile(getattr(it, f.name))
                               for f in dataclasses.fields(it)})
    ref, _ = sequential.solve_batched(dataclasses.replace(bm, c=c), bit, x0,
                                      SIGMA)
    np.testing.assert_allclose(ws.numpy(), ref.numpy(), atol=1e-9, rtol=0)


# ------------------------------------------------- the wrappers themselves

def _small_k1_inputs(nc=3, Bt=2, n=4, nx=3, nu=2, seed=0):
    rng = np.random.default_rng(seed)
    nz = nx + nu
    r = lambda *s: torch.as_tensor(rng.normal(size=s))
    G = r(n, nz, nz, Bt) * 0.3
    H = torch.einsum("kijb,kljb->kilb", G, G) + 0.5 * torch.eye(nz)[None, :, :, None]
    GN = r(nx, nx, Bt)
    PN = torch.einsum("ijb,ljb->ilb", GN, GN) + torch.eye(nx)[:, :, None]
    return (r(n, nx, nx, Bt) * 0.3, r(n, nx, nu, Bt) * 0.5, r(n, nx, Bt) * 0.1,
            H.contiguous(), r(n, nz, Bt) * 0.3, r(n, nc, nz, Bt) * 0.5,
            torch.as_tensor(rng.uniform(0, 1, size=(n, nc, Bt))),
            r(n, nc, Bt), PN.contiguous(), r(nx, Bt))


@pytest.mark.parametrize("export", [False, True])
@pytest.mark.parametrize("closed_loop", [False, True])
@pytest.mark.parametrize("nc", [0, 3])
def test_backward_lanes_flags_and_nc(export, closed_loop, nc):
    """Every flag combination returns the matching slice of the full
    output tuple; nc = 0 (no constraint rows) works."""
    args = _small_k1_inputs(nc=nc)
    full = cr.backward_lanes(*args, export_factors=True)
    out = cr.backward_lanes(*args, export_factors=export,
                            emit_closed_loop=closed_loop)
    keep = [0, 1] + ([2, 3] if closed_loop else []) + ([4, 5] if export else [])
    assert len(out) == len(keep)
    for got, i in zip(out, keep):
        assert torch.equal(got, full[i])


def test_backward_lanes_satisfies_riccati_equation():
    """An independent check of K1's plain version: its exported P obeys
    P_k = Q~ + A^T P+ A - G^T Huu^{-1} G with the folded cost, per
    instance, computed here with dense linear algebra."""
    args = _small_k1_inputs(nc=3, Bt=2)
    A, Bm, c, H, h, D, rho, rg, PN, pN = args
    K, d, M, v, P, L = cr.backward_lanes(*args, export_factors=True)
    nu = Bm.shape[2]
    for b in range(A.shape[-1]):
        for k in range(A.shape[0]):
            Pn = P[k, :, :, b]
            Hf = H[k, :, :, b] + D[k, :, :, b].T @ torch.diag(rho[k, :, b]) @ D[k, :, :, b]
            Ak, Bk = A[k, :, :, b], Bm[k, :, :, b]
            Huu = Hf[:nu, :nu] + Bk.T @ Pn @ Bk
            G = Hf[:nu, nu:] + Bk.T @ Pn @ Ak
            Kk = -torch.linalg.solve(Huu, G)
            np.testing.assert_allclose(K[k, :, :, b], Kk, atol=1e-11)
            np.testing.assert_allclose(L[k, :, :, b] @ L[k, :, :, b].T, Huu,
                                       atol=1e-11)
            np.testing.assert_allclose(M[k, :, :, b], Ak + Bk @ Kk, atol=1e-11)
            if k > 0:
                Pk = Hf[nu:, nu:] + Ak.T @ Pn @ Ak + G.T @ Kk
                np.testing.assert_allclose(P[k - 1, :, :, b], Pk, atol=1e-11)


@pytest.mark.parametrize("fault,error", [
    ("shape", ValueError), ("dtype", TypeError), ("contiguous", ValueError),
    ("type", TypeError),
])
def test_wrappers_refuse_bad_arguments(fault, error):
    args = list(_small_k1_inputs())
    if fault == "shape":
        args[2] = args[2][:, :-1].contiguous()
    elif fault == "dtype":
        args[4] = args[4].float()
    elif fault == "contiguous":
        args[0] = args[0].transpose(1, 2)
    else:
        args[9] = args[9].numpy()
    with pytest.raises(error):
        cr.backward_lanes(*args)


def test_prepare_shared_refuses_batched_model_and_rho(port_inputs):
    problem, it, x0 = port_inputs
    tile = lambda x: x.expand((B,) + x.shape)
    with pytest.raises(ValueError, match="UNBATCHED"):
        cr.prepare_shared(dataclasses.replace(problem, A=tile(problem.A)),
                          it, x0, SIGMA)
    with pytest.raises(ValueError, match="rho"):
        cr.prepare_shared(problem, dataclasses.replace(it, rho=tile(it.rho)),
                          x0, SIGMA)


def test_lanes_layout_round_trip():
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert cr.to_lanes(x).shape == (3, 4, 2)
    assert torch.equal(cr.from_lanes(cr.to_lanes(x)), x)


def test_cpu_path_launches_no_kernel(port_prep):
    from pdp_lqr_tpu_torch.ops import cuda_admm as ca
    cr.reset_launch_counts()
    ca.reset_launch_counts()
    cr.solve_shared_prepared(port_prep)
    # K8 on CPU tensors (one model, nx=2, nu=1, one row): its plain version.
    rng = np.random.default_rng(0)
    t = lambda *s: torch.as_tensor(rng.normal(size=s) * 0.3)
    one = lambda *s: torch.ones(s, dtype=torch.float64)
    eye = lambda n, *s: torch.eye(n, dtype=torch.float64).reshape(
        (n, n) + (1,) * len(s)).expand((n, n) + s).contiguous()
    ca.admm_iter_lanes(
        eye(2, 4, 1).permute(2, 0, 1, 3).contiguous(), t(4, 2, 1, 1),
        t(4, 2, 5), eye(3, 4, 1).permute(2, 0, 1, 3).contiguous(), t(4, 3, 1),
        t(4, 1, 3, 1), -one(4, 1, 1), one(4, 1, 1), one(4, 1, 1), None,
        t(4, 3, 5), t(4, 1, 5), t(4, 1, 5), one(1, 5), eye(2, 5), t(2, 5),
        t(2, 5), nu=1, cones=(), alpha=1.6, sigma=1e-6, shared=True)
    assert cr.LAUNCHES == {"backward_lanes": 0, "backward_vectors_lanes": 0,
                           "forward_lanes": 0, "forward_rollout_lanes": 0,
                           "backward_pdp_lanes": 0,
                           "backward_pdp_vectors_lanes": 0,
                           "backward_packed": 0, "forward_packed": 0,
                           "backward_lanes[bf16]": 0,
                           "forward_rollout_lanes[bf16]": 0,
                           "backward_packed[bf16]": 0,
                           "forward_packed[bf16]": 0}
    assert ca.LAUNCHES == {"admm_bwd_vec_prefold_lanes": 0,
                           "admm_bwd_vec_lanes": 0,
                           "admm_fwd_update_lanes": 0, "admm_iter_lanes": 0,
                           "admm_bwd_vec_prefold_lanes[bf16]": 0,
                           "admm_bwd_vec_lanes[bf16]": 0,
                           "admm_fwd_update_lanes[bf16]": 0}


def test_kernel_defines_and_block_sizes():
    assert cr.kernel_defines(torch.float32, 12, 4, 16) == {
        "SCALAR": "float", "NX": 12, "NU": 4, "NC": 16}
    assert cr.kernel_defines(torch.float64, 12, 4) == {
        "SCALAR": "double", "NX": 12, "NU": 4}
    with pytest.raises(TypeError):
        cr.kernel_defines(torch.float16, 12, 4)
    # The matrix sweep's block is the kernel's own (compile-time, from the
    # widths and the dtype): its entry points take the sizes and the
    # switches as ints, and no thread count.
    lib = types.SimpleNamespace(**{name: types.SimpleNamespace() for name in (
        "riccati_backward", "riccati_backward_pdp", "riccati_backward_packed")})
    cr.bind_library(lib, with_matrix_sweep=True)
    ints = lambda fn: [t for t in fn.argtypes if t is ctypes.c_int]
    assert len(ints(lib.riccati_backward)) == 4      # N, Bt, emit_mv, export
    assert len(ints(lib.riccati_backward_pdp)) == 4  # N, Bt, S, export
    assert len(ints(lib.riccati_backward_packed)) == 2


# ------------------------------------------------- packed streams (K11, K12)
# As tests/test_pallas.py:139 does for the JAX package: quadrotor N=10, B=3,
# constrained and not, one model a scenario.  One jit runs JAX's packed
# pipeline step by step for both.

PACKED_N, PACKED_B = 10, 3
PACKED_NAMES = ("Sd", "Sc", "PN", "pN", "x0", "G", "ws_l", "xN", "ws")


@pytest.fixture(scope="module")
def jax_packed():
    import jax
    import jax.numpy as jnp

    from pdp_lqr_tpu import init_iterates
    from pdp_lqr_tpu.models import quadrotor
    from pdp_lqr_tpu.ops import pallas_riccati as pr

    cases = {}
    for constrained in (False, True):
        rng = np.random.default_rng(0)
        problem, _ = quadrotor(N=PACKED_N, constrained=constrained)
        bp = jax.tree.map(
            lambda x: jnp.broadcast_to(x, (PACKED_B,) + x.shape), problem)
        bp = dataclasses.replace(
            bp, c=bp.c + jnp.asarray(rng.normal(size=bp.c.shape) * 0.01))
        its = jax.vmap(lambda p: init_iterates(p, rho=0.01))(bp)
        x0 = jnp.asarray(rng.normal(size=(PACKED_B, problem.nx)) * 0.1)
        cases[constrained] = (bp, its, x0)

    @jax.jit
    def run(cases):
        out = {}
        for constrained, (bp, its, x0) in cases.items():
            Sd, Sc, PN, pN, x0_l, nu, nc = pr.prepare_packed(bp, its, x0,
                                                             SIGMA)
            G = pr.backward_packed(Sd, Sc, PN, pN, nu, nc, interpret=True)
            ws_l, xN = pr.forward_packed(Sd, G, x0_l, nu, interpret=True)
            wN = jnp.concatenate([jnp.zeros((PACKED_B, nu)), xN.T], axis=-1)
            ws = jnp.concatenate([pr.from_lanes(ws_l), wN[:, None]], axis=1)
            out[constrained] = (Sd, Sc, PN, pN, x0_l, G, ws_l, xN, ws)
        return out

    out = run({False: cases[False], True: cases[True]})
    return {c: {"inputs": tuple(_asdict_np(x) for x in cases[c][:2])
                + (np.asarray(cases[c][2]),),
                **dict(zip(PACKED_NAMES, map(np.asarray, out[c])))}
            for c in (False, True)}


def _packed_widths(jax_packed, constrained):
    """(nu, nc) of the case's problem."""
    prob = jax_packed[constrained]["inputs"][0]
    return prob["B"].shape[-1], prob["D"].shape[-2]


def _packed_inputs(jax_packed, constrained):
    prob, it, x0 = jax_packed[constrained]["inputs"]
    return (convert.problem_from_numpy(prob, device="cpu"),
            convert.iterates_from_numpy(it, device="cpu"), _t(x0))


@pytest.mark.parametrize("constrained", [False, True])
def test_prepare_packed_matches_jax(jax_packed, constrained):
    prep = cr.prepare_packed(*_packed_inputs(jax_packed, constrained), SIGMA)
    for name, got in zip(PACKED_NAMES[:5], prep[:5]):
        np.testing.assert_allclose(got.numpy(), jax_packed[constrained][name],
                                   atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("constrained", [False, True])
def test_backward_packed_plain_version_matches_jax(jax_packed, constrained):
    ref = jax_packed[constrained]
    G = cr.backward_packed(_t(ref["Sd"]), _t(ref["Sc"]), _t(ref["PN"]),
                           _t(ref["pN"]), *_packed_widths(jax_packed,
                                                          constrained))
    np.testing.assert_allclose(G.numpy(), ref["G"], atol=ATOL, rtol=0)


@pytest.mark.parametrize("constrained", [False, True])
@pytest.mark.parametrize("out", ["ws_l", "xN"])
def test_forward_packed_plain_version_matches_jax(jax_packed, constrained,
                                                  out):
    ref = jax_packed[constrained]
    nu, _ = _packed_widths(jax_packed, constrained)
    got = cr.forward_packed(_t(ref["Sd"]), _t(ref["G"]), _t(ref["x0"]), nu)
    np.testing.assert_allclose(got[("ws_l", "xN").index(out)].numpy(),
                               ref[out], atol=ATOL, rtol=0)


@pytest.mark.parametrize("constrained", [False, True])
def test_solve_packed_matches_jax_and_solve_lanes(jax_packed, constrained):
    args = _packed_inputs(jax_packed, constrained)
    ws = cr.solve_packed(*args, SIGMA)
    np.testing.assert_allclose(ws.numpy(), jax_packed[constrained]["ws"],
                               atol=1e-12, rtol=0)
    np.testing.assert_allclose(ws.numpy(), cr.solve_lanes(*args, SIGMA).numpy(),
                               atol=1e-12, rtol=0)


def test_packed_refuses_narrow_streams(jax_packed):
    # Narrow streams are bfloat16 only (tests/test_torch_narrow_lanes.py
    # holds those against JAX): float32 streams under float64 gains, and
    # any other storage_dtype, are refused by name.
    ref = jax_packed[True]
    Sd, G, x0 = _t(ref["Sd"]), _t(ref["G"]), _t(ref["x0"])
    with pytest.raises(TypeError, match="storage_dtype=torch.bfloat16 only"):
        cr.forward_packed(Sd.float(), G, x0, 4)
    with pytest.raises(TypeError, match="torch.bfloat16 only"):
        cr.solve_packed(*_packed_inputs(jax_packed, True), SIGMA,
                        storage_dtype=torch.float16)
    with pytest.raises(ValueError, match="not nx"):
        cr.forward_packed(Sd[:, :-1], G, x0, 4)
