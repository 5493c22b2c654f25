"""bfloat16 stage streams on the per-scenario inner solve, against the JAX
package, on the CPU.

``prepare_lanes`` / ``prepare_packed(storage_dtype=bfloat16)`` store the
eight stage streams (A, B, c, H~, h~, D, rho, rho g) narrow and keep the
terminal fold, x0 and the compute in the problem's type; ``solve_lanes``
and ``solve_packed`` then run K1 (gains only) + K7 and K11 + K12 on them.
Inputs are made with numpy from a seed (the quadrotor with its box rows,
N=6, B=3, drift ``c``, non-zero iterates, a rho a scenario and row) and
handed to both packages.  JAX's prepared streams are plain XLA (cheap);
its kernels in interpret mode are called ONCE (``solve_lanes``, float64,
about 40 s): its ``solve_packed`` is the same function bit for bit.  The
port's plain versions widen each stage as they load it, so in float64
they agree with JAX to summation order.  The CUDA forms themselves are held
against these plain versions on the card by ``chip_smoke.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pdp_lqr_tpu_torch import convert
from pdp_lqr_tpu_torch.ops import cuda_riccati as cr

SEED = 3
SIGMA = 1e-6
N, B = 6, 3
REL = 1e-10            # float64 port against float64 JAX, relative
F32_REL = 1e-4         # the port's float32 compute against its float64
QUANT_REL = 2e-2       # narrow against full width (tests/test_pallas.py:120)
STREAMS = ("A", "B", "c", "H", "h", "D", "rho", "rg")


def _np(tree):
    return {f.name: np.asarray(getattr(tree, f.name))
            for f in dataclasses.fields(tree)}


def _bits(x):
    """The 16-bit patterns of a bfloat16 array or tensor."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _rel(got, ref):
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.abs(np.asarray(got, dtype=np.float64) - ref).max()
                 / np.abs(ref).max())


@pytest.fixture(scope="module")
def case():
    """The inputs (JAX pytrees and numpy) and JAX's prepared streams."""
    import jax
    import jax.numpy as jnp

    from pdp_lqr_tpu import init_iterates
    from pdp_lqr_tpu.models import quadrotor
    from pdp_lqr_tpu.ops import pallas_riccati as pr

    rng = np.random.default_rng(SEED)
    problem, _ = quadrotor(N=N, constrained=True)
    bp = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), problem)
    bp = dataclasses.replace(
        bp, c=bp.c + jnp.asarray(rng.normal(size=bp.c.shape) * 0.01))
    its = jax.vmap(lambda p: init_iterates(p, rho=0.01))(bp)
    noise = lambda x, s: x + jnp.asarray(rng.normal(size=x.shape) * s)
    its = dataclasses.replace(
        its, w=noise(its.w, 0.01), y=noise(its.y, 0.01), z=noise(its.z, 0.01),
        rho=its.rho * jnp.asarray(rng.uniform(0.5, 3.0, size=its.rho.shape)))
    x0 = jnp.asarray(rng.normal(size=(B, problem.nx)) * 0.1)
    bf16 = jnp.bfloat16
    return {"jax": (bp, its, x0), "np": (_np(bp), _np(its), np.asarray(x0)),
            "lanes": [np.asarray(x) for x in pr.prepare_lanes(
                bp, its, x0, SIGMA, storage_dtype=bf16)[:11]],
            "packed": [np.asarray(x) for x in pr.prepare_packed(
                bp, its, x0, SIGMA, storage_dtype=bf16)[:5]]}


@pytest.fixture(scope="module")
def jax_ws(case):
    """JAX's narrow solve: its kernels in interpret mode, float64."""
    import jax.numpy as jnp

    from pdp_lqr_tpu.ops import pallas_riccati as pr
    return np.asarray(pr.solve_lanes(*case["jax"], SIGMA,
                                     storage_dtype=jnp.bfloat16,
                                     interpret=True))


def _port(case, dtype=torch.float64):
    prob, it, x0 = case["np"]
    return (convert.problem_from_numpy(prob, device="cpu", dtype=dtype),
            convert.iterates_from_numpy(it, device="cpu", dtype=dtype),
            torch.as_tensor(x0, dtype=dtype))


@pytest.fixture(scope="module")
def port_ws(case):
    """The port's solves: narrow through both pairs in float64 and float32,
    full width in float64."""
    narrow = dict(storage_dtype=torch.bfloat16)
    return {"lanes": cr.solve_lanes(*_port(case), SIGMA, **narrow),
            "packed": cr.solve_packed(*_port(case), SIGMA, **narrow),
            "lanes_f32": cr.solve_lanes(*_port(case, torch.float32), SIGMA,
                                        **narrow),
            "packed_f32": cr.solve_packed(*_port(case, torch.float32), SIGMA,
                                          **narrow),
            "full": cr.solve_lanes(*_port(case), SIGMA)}


@pytest.mark.parametrize("name", STREAMS)
def test_prepare_lanes_narrow_streams_equal_jax_bit_for_bit(case, name):
    prep = cr.prepare_lanes(*_port(case), SIGMA, storage_dtype=torch.bfloat16)
    got, ref = prep[STREAMS.index(name)], case["lanes"][STREAMS.index(name)]
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(_bits(got), _bits(ref))


def test_prepare_lanes_keeps_terminal_fold_and_x0_full_width(case):
    prep = cr.prepare_lanes(*_port(case), SIGMA, storage_dtype=torch.bfloat16)
    for got, ref in zip(prep[8:11], case["lanes"][8:11]):
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-12, rtol=0)
    assert prep[11] == 4


@pytest.mark.parametrize("name", ["Sd", "Sc"])
def test_prepare_packed_narrow_streams_equal_jax_bit_for_bit(case, name):
    prep = cr.prepare_packed(*_port(case), SIGMA, storage_dtype=torch.bfloat16)
    got, ref = prep[("Sd", "Sc").index(name)], case["packed"][("Sd", "Sc").index(name)]
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    for got, ref in zip(prep[2:5], case["packed"][2:5]):
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-12, rtol=0)


@pytest.mark.parametrize("path", ["lanes", "packed"])
def test_narrow_solve_matches_jax_interpret(jax_ws, port_ws, path):
    ws = port_ws[path]
    assert ws.dtype == torch.float64 and tuple(ws.shape) == jax_ws.shape
    assert _rel(ws.numpy(), jax_ws) <= REL


def test_narrow_solve_lanes_and_packed_agree_bit_for_bit(port_ws):
    assert torch.equal(port_ws["lanes"], port_ws["packed"])
    assert torch.equal(port_ws["lanes_f32"], port_ws["packed_f32"])


@pytest.mark.parametrize("path", ["lanes", "packed"])
def test_narrow_float32_compute_tracks_float64(port_ws, path):
    ws = port_ws[path + "_f32"]
    assert ws.dtype == torch.float32
    assert _rel(ws.numpy(), port_ws[path].numpy()) <= F32_REL


@pytest.mark.parametrize("path", ["lanes", "lanes_f32", "packed_f32"])
def test_narrow_solve_tracks_full_width(port_ws, path):
    """bfloat16 quantizes the problem's data (about 3 digits): JAX's own
    bound on the solution, relative to its largest entry."""
    err = _rel(port_ws[path].numpy(), port_ws["full"].numpy())
    assert 0 < err <= QUANT_REL


def test_narrow_wrappers_refuse_what_has_no_narrow_form(case):
    A, B_, c, H, h, D, rho, rg, PN, pN, x0, nu = cr.prepare_lanes(
        *_port(case), SIGMA, storage_dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="gains-only"):
        cr.backward_lanes(A, B_, c, H, h, D, rho, rg, PN, pN)
    with pytest.raises(NotImplementedError, match="gains-only"):
        cr.backward_lanes(A, B_, c, H, h, D, rho, rg, PN, pN,
                          export_factors=True, emit_closed_loop=False)
    # Every stream in one storage type: a full-width one among narrow ones
    # is refused, as is any narrow type but bfloat16.
    with pytest.raises(TypeError, match="dtype"):
        cr.backward_lanes(A, B_, c.double(), H, h, D, rho, rg, PN, pN,
                          emit_closed_loop=False)
    with pytest.raises(TypeError, match="bfloat16 only"):
        cr.prepare_lanes(*_port(case), SIGMA, storage_dtype=torch.float16)
    with pytest.raises(TypeError, match="bfloat16 only"):
        cr.forward_rollout_lanes(A.half(), B_.half(), c.half(),
                                 *cr.backward_lanes(A, B_, c, H, h, D, rho, rg,
                                                    PN, pN,
                                                    emit_closed_loop=False),
                                 x0)


def test_narrow_cpu_path_launches_no_kernel(case):
    cr.reset_launch_counts()
    prep = cr.prepare_packed(*_port(case), SIGMA, storage_dtype=torch.bfloat16)
    cr.solve_packed_prepared(prep)
    cr.solve_prepared(cr.prepare_lanes(*_port(case), SIGMA,
                                       storage_dtype=torch.bfloat16))
    assert set(cr.LAUNCHES.values()) == {0}
