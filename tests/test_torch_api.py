"""The port's reference-shaped solver classes against the JAX package's,
on the CPU: the counterparts of ``tests/test_api.py``'s lifecycle tests.

The four classes run the reference lifecycle (update_problem_data,
backward, backward_without_factorization, forward, clear_workspace) in
float64 on ``device="cpu"``; each result is held against the same call
sequence on the JAX package's class at 1e-10 (the JAX suite's tolerance
for these backends), and the three-way agreement against the sequential
witness as ``test_api.py`` holds it (1e-8).  Every test uses one random
constrained model (nx=5, nu=2, three constraint rows, N=20) and one
configuration a class, so the JAX classes trace each lifecycle step once
in the module (the quadrotor's KKT blocks, m = 28, make JAX's unrolled
inverse compile for tens of seconds).  JAX's ``_jitted``
cache exists for its trace cache only and has no counterpart here, so its
recompilation test is not ported.
"""

import dataclasses

import numpy as np
import pytest

from pdp_lqr_tpu import api as japi, init_iterates as jinit
from pdp_lqr_tpu.models import random_lq as jrandom_lq
import pdp_lqr_tpu_torch as plt_
from pdp_lqr_tpu_torch import convert

SIGMA = 1e-6
ATOL = 1e-10


def _np(tree):
    return {f.name: np.asarray(getattr(tree, f.name))
            for f in dataclasses.fields(tree)}


def _vectors(problem, rho=0.01):
    it = jinit(problem, rho=rho)
    return tuple(np.asarray(x) for x in (it.w, it.y, it.z, it.rho))


CLASSES = [
    ("seq", japi.LQRSolver, plt_.LQRSolver, {}),
    ("pdp", japi.LQRParallelSolver, plt_.LQRParallelSolver,
     {"num_segments": 4}),
    ("kkt", japi.QDLDLSolver, plt_.QDLDLSolver, {"rho_dyn": 0.0}),
    ("assoc", japi.AssociativeScanSolver, plt_.AssociativeScanSolver, {}),
]


@pytest.fixture(scope="module")
def model():
    jp = jrandom_lq(5, 2, 20, nc=3, seed=2)
    return jp, convert.problem_from_numpy(_np(jp), device="cpu")


def test_reference_lifecycle_three_way(model):
    """The reference example through the four classes: each against its
    JAX class, and all against the sequential solver."""
    jp, tp = model
    vecs = _vectors(jp)
    x0 = np.random.default_rng(1).normal(size=5) * 0.1
    out = {}
    for name, jcls, tcls, kw in CLASSES:
        js = jcls(jp, **kw).update_problem_data(*vecs, SIGMA).backward()
        ts = tcls(tp, **kw, device="cpu").update_problem_data(*vecs, SIGMA)
        assert ts.backward() is ts
        out[name] = ts.forward(x0).numpy()
        np.testing.assert_allclose(out[name], np.asarray(js.forward(x0)),
                                   rtol=0, atol=ATOL, err_msg=name)
    for name, w in out.items():
        np.testing.assert_allclose(w, out["seq"], rtol=0, atol=1e-8,
                                   err_msg=name)


@pytest.mark.parametrize("name", [c[0] for c in CLASSES])
def test_without_factorization_lifecycle(model, name):
    _, jcls, tcls, kw = next(c for c in CLASSES if c[0] == name)
    jp, tp = model
    ws, ys, zs, rho = _vectors(jp, rho=0.1)
    x0 = np.random.default_rng(2).normal(size=5) * 0.1
    ws2 = np.random.default_rng(3).normal(size=ws.shape) * 0.1

    js, ts = jcls(jp, **kw), tcls(tp, **kw, device="cpu")
    for s in (js, ts):
        s.update_problem_data(ws, ys, zs, rho, SIGMA).backward()
    w1 = ts.forward(x0).numpy()
    np.testing.assert_allclose(w1, np.asarray(js.forward(x0)), rtol=0,
                               atol=ATOL)
    # New linear data, same rho: the cached-factor path.
    for s in (js, ts):
        s.update_problem_data(ws2, ys, zs, rho, SIGMA)
        s.backward_without_factorization()
    w_fast = ts.forward(x0).numpy()
    np.testing.assert_allclose(w_fast, np.asarray(js.forward(x0)), rtol=0,
                               atol=ATOL)
    ts.backward()
    w_full = ts.forward(x0).numpy()
    if name == "kkt":
        # The KKT factor does not depend on the linear data: reusing it IS
        # the fresh solve.
        np.testing.assert_allclose(w_fast, w_full, rtol=0, atol=1e-12)
    else:
        np.testing.assert_allclose(w_fast, w_full, rtol=0, atol=1e-10)
    assert not np.allclose(w1, w_fast)


def test_batched_construction(model):
    """A model with a leading batch axis runs batched: each class on B=3
    instances (their x0 and iterates differ), against the JAX class on
    each instance, and instance 0 against the port's single solve."""
    jp, tp = model
    B = 3
    rng = np.random.default_rng(7)
    tbp = type(tp)(**{f.name: getattr(tp, f.name).expand(
        (B,) + getattr(tp, f.name).shape) for f in dataclasses.fields(tp)})
    ws, ys, zs, rho = _vectors(jp)
    vecs = (ws + rng.normal(size=(B,) + ws.shape) * 0.1,
            np.broadcast_to(ys, (B,) + ys.shape),
            np.broadcast_to(zs, (B,) + zs.shape),
            np.broadcast_to(rho, (B,) + rho.shape))
    x0s = rng.normal(size=(B, 5)) * 0.1
    for _, jcls, tcls, kw in CLASSES:
        ts = tcls(tbp, **kw, device="cpu").update_problem_data(*vecs, SIGMA)
        ws_b = ts.backward().forward(x0s)
        assert ws_b.shape == (B, 21, 7)
        for b in range(B):
            js = jcls(jp, **kw).update_problem_data(
                *(v[b] for v in vecs), SIGMA).backward()
            np.testing.assert_allclose(ws_b[b].numpy(),
                                       np.asarray(js.forward(x0s[b])),
                                       rtol=0, atol=ATOL)
    single = plt_.AssociativeScanSolver(tp, device="cpu").update_problem_data(
        *(v[0] for v in vecs), SIGMA)
    np.testing.assert_allclose(
        ws_b[0].numpy(), single.backward().forward(x0s[0]).numpy(), atol=1e-12)


def test_lifecycle_errors():
    jp = jrandom_lq(3, 1, 5, seed=0)
    tp = convert.problem_from_numpy(_np(jp), device="cpu")
    for _, _, tcls, kw in CLASSES:
        kw = {"num_segments": 5} if tcls is plt_.LQRParallelSolver else kw
        solver = tcls(tp, **kw, device="cpu")
        with pytest.raises(RuntimeError):
            solver.backward()
        solver.update_problem_data(*_vectors(jp), SIGMA)
        with pytest.raises(RuntimeError):
            solver.forward(np.zeros(3))
        with pytest.raises(RuntimeError):
            solver.backward_without_factorization()
        solver.backward()
        solver.clear_workspace()
        with pytest.raises(RuntimeError):
            solver.backward()
