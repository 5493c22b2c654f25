"""The port's binding of the native C++ witness (``utils.native``) on the CPU.

``pdp_lqr_tpu_torch.utils.native.solve_batch`` builds
``native/clqr_native.cpp`` with g++ into the port's build directory and
runs it on the port's batched records.  Held against the JAX package's
binding of the same engine (the same numbers: 1e-12) and the port's
sequential Riccati solver (float64, 1e-9), on the constrained quadrotor
(N=32, B=6, per-scenario drift, random iterates) and on random LQ
instances without constraint rows.  Skips only where no g++ is found.
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdp_lqr_tpu import init_iterates as jinit_iterates
from pdp_lqr_tpu.models import quadrotor as jquadrotor
from pdp_lqr_tpu.models import random_lq as jrandom_lq
from pdp_lqr_tpu.utils import native as jnative
from pdp_lqr_tpu_torch import convert
from pdp_lqr_tpu_torch.solvers import sequential
from pdp_lqr_tpu_torch.utils import native

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="needs g++ to build the native engine")

SIGMA = 1e-6


def _np(tree):
    return {f.name: np.asarray(getattr(tree, f.name))
            for f in dataclasses.fields(tree)}


def _quadrotor_case():
    rng = np.random.default_rng(11)
    B = 6
    p, _ = jquadrotor(N=32, constrained=True)
    bp = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), p)
    bp = dataclasses.replace(
        bp, c=bp.c + jnp.asarray(rng.normal(size=bp.c.shape) * 0.01))
    its = jax.vmap(lambda q: jinit_iterates(q, rho=0.1))(bp)
    noise = lambda x: x + jnp.asarray(rng.normal(size=x.shape) * 0.05)
    its = dataclasses.replace(its, w=noise(its.w), z=noise(its.z),
                              y=noise(its.y))
    return bp, its, rng.normal(size=(B, 12)) * 0.1


def _random_case():
    problems = [jrandom_lq(5, 2, 16, nc=0, seed=20 + s) for s in range(3)]
    bp = jax.tree.map(lambda *xs: jnp.stack(xs), *problems)
    its = jax.vmap(lambda q: jinit_iterates(q, rho=0.01))(bp)
    return bp, its, np.random.default_rng(3).normal(size=(3, 5)) * 0.2


@pytest.fixture(scope="module", params=["quadrotor", "random_lq_nc0"])
def case(request):
    bp, its, x0 = (_quadrotor_case if request.param == "quadrotor"
                   else _random_case)()
    return {"jax": (bp, its, x0),
            "problem": convert.problem_from_numpy(_np(bp), device="cpu"),
            "it": convert.iterates_from_numpy(_np(its), device="cpu"),
            "x0": torch.tensor(x0)}


def test_available():
    assert native.available()


def test_matches_jax_binding(case):
    ws = native.solve_batch(case["problem"], case["it"], case["x0"], SIGMA)
    ref = jnative.solve_batch(*case["jax"], SIGMA)
    assert ws.dtype == torch.float64 and ws.device.type == "cpu"
    assert ws.shape == ref.shape
    np.testing.assert_allclose(ws.numpy(), ref, rtol=0, atol=1e-12)


def test_matches_sequential(case):
    ws = native.solve_batch(case["problem"], case["it"], case["x0"], SIGMA,
                            n_threads=2)
    ref, _ = sequential.solve_batched(case["problem"], case["it"], case["x0"],
                                      SIGMA)
    np.testing.assert_allclose(ws.numpy(), ref.numpy(), rtol=0, atol=1e-9)


def test_float32_inputs_are_widened(case):
    """The engine computes in float64 whatever the problem's type."""
    p32 = case["problem"].to(dtype=torch.float32)
    it32 = case["it"].to(dtype=torch.float32)
    ws = native.solve_batch(p32, it32, case["x0"].float(), SIGMA)
    ref = native.solve_batch(p32.to(dtype=torch.float64),
                             it32.to(dtype=torch.float64),
                             case["x0"].float().double(), SIGMA)
    assert ws.dtype == torch.float64
    assert torch.equal(ws, ref)
