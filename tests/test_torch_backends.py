"""The port's torch-ops inner solvers against the JAX package, on the CPU.

Every backend of ``admm.solve`` (dense, assoc, kkt, pdp in 2 and 4
segments with either condensed factorization, and the sequential solver's
cached ``resolve``) runs its three steps on the same inputs in both
packages: ``backward`` at one set of random ADMM iterates, the cached
backward (``backward_without_factorization``) at a second set with the
same rho, and ``forward`` on its factors.  The inputs are made with numpy
from a seed on two models at N=16: ``double_integrator(constrained=True)``
and ``random_lq(4, 2, nc=3)``.  The JAX side of a case is one ``jax.jit``
of its three steps (one trace a case).  Limits: 1e-10 (float64; assoc
1e-9, whose scans combine in another order than a sequential sweep), the
JAX suite's own for these backends.  Beside them: the stage steps
``terminal_step_raw`` and ``backward_step_folded`` and the LU condensed
pair.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdp_lqr_tpu import ADMMIterates as JIterates, make_stage_params as jmsp
from pdp_lqr_tpu.config import CondensedSolverType as JCT
from pdp_lqr_tpu.models import double_integrator as jdi, random_lq as jrlq
from pdp_lqr_tpu.ops import condensed as jcond, riccati as jric
from pdp_lqr_tpu.solvers import (
    assoc as jassoc, dense as jdense, kkt as jkkt, pdp as jpdp,
    sequential as jseq,
)
from pdp_lqr_tpu_torch import convert, make_stage_params
from pdp_lqr_tpu_torch.config import CondensedSolverType as CT
from pdp_lqr_tpu_torch.ops import condensed, riccati
from pdp_lqr_tpu_torch.solvers import assoc, dense, kkt, pdp, sequential

N = 16
SIGMA = 1e-6
ATOL = 1e-10
ATOL_ASSOC = 1e-9


def _np(tree):
    return {f.name: np.asarray(getattr(tree, f.name))
            for f in dataclasses.fields(tree)}


def _leaves(x):
    """The arrays of a factor record (nested records and tuples too)."""
    if dataclasses.is_dataclass(x):
        return [a for f in dataclasses.fields(x)
                for a in _leaves(getattr(x, f.name))]
    if isinstance(x, (tuple, list)):
        return [a for v in x for a in _leaves(v)]
    return [np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)]


MODELS = {
    "double_integrator": lambda: jdi(N=N, constrained=True),
    "random_lq": lambda: jrlq(4, 2, N, nc=3, seed=2),
}

# name -> (JAX module, port module, backward's extra positional arguments
# in JAX's and in the port's terms, tolerance).  The kkt forward takes the
# stage data; the pdp factors carry the condensed solver's pivots, which
# the two packages store differently (0- and 1-based): compared through
# the trajectory only.
BACKENDS = {
    "seq_resolve": (jseq, sequential, (), (), ATOL),
    "dense": (jdense, dense, (), (), ATOL),
    "assoc": (jassoc, assoc, (), (), ATOL_ASSOC),
    "kkt": (jkkt, kkt, (0.0,), (0.0,), ATOL),
}
for _S in (2, 4):
    for _j, _t in ((JCT.CHOLESKY, CT.CHOLESKY), (JCT.LU, CT.LU)):
        BACKENDS[f"pdp_S{_S}_{_t.value}"] = (jpdp, pdp, (_S, _j), (_S, _t),
                                             ATOL)


@pytest.fixture(scope="module")
def inputs():
    """Per model: the JAX problem, the port's, two iterate sets with the
    same rho, x0 (numpy)."""
    out = {}
    for name, build in MODELS.items():
        jp = build()
        rng = np.random.default_rng(11)
        nz, nc = jp.nz, jp.nc
        rho = rng.uniform(0.05, 1.0, size=(N + 1, nc))
        its = [{"w": rng.normal(size=(N + 1, nz)) * 0.1,
                "y": rng.normal(size=(N + 1, nc)) * 0.1,
                "z": rng.normal(size=(N + 1, nc)) * 0.1, "rho": rho}
               for _ in range(2)]
        out[name] = (jp, convert.problem_from_numpy(_np(jp), device="cpu"),
                     its, rng.normal(size=jp.nx) * 0.2)
    return out


def _jax_case(jmod, extra, jp, its, x0):
    """backward, cached backward, forward of one JAX backend, one trace."""
    def run(p, it1, it2, x0):
        prm1, prm2 = jmsp(p, it1, SIGMA), jmsp(p, it2, SIGMA)
        fac = jmod.backward(p, prm1, it1.rho, *extra)
        if jmod is jkkt:
            return fac, fac, jmod.forward(p, prm2, it2.rho, fac, x0)
        fac2 = jmod.backward_without_factorization(p, prm2, it2.rho, fac)
        return fac, fac2, jmod.forward(p, fac2, x0)
    jit = lambda d: JIterates(**{k: jnp.asarray(v) for k, v in d.items()})
    return jax.tree.map(np.asarray, jax.jit(run)(
        jp, jit(its[0]), jit(its[1]), jnp.asarray(x0)))


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_backend_against_jax(inputs, backend, model):
    jmod, tmod, jextra, textra, atol = BACKENDS[backend]
    jp, tp, its, x0 = inputs[model]
    jfac, jfac2, jws = _jax_case(jmod, jextra, jp, its, x0)

    it1, it2 = (convert.iterates_from_numpy(d, device="cpu") for d in its)
    prm1, prm2 = (make_stage_params(tp, it, SIGMA) for it in (it1, it2))
    fac = tmod.backward(tp, prm1, it1.rho, *textra)
    if tmod is kkt:
        fac2 = fac
        ws = tmod.forward(tp, prm2, it2.rho, fac, torch.tensor(x0))
    else:
        fac2 = tmod.backward_without_factorization(tp, prm2, it2.rho, fac)
        ws = tmod.forward(tp, fac2, torch.tensor(x0))
    np.testing.assert_allclose(ws.numpy(), jws, rtol=0, atol=atol)
    if tmod is not pdp:
        for got, want in ((fac, jfac), (fac2, jfac2)):
            for a, b in zip(_leaves(got), _leaves(want), strict=True):
                np.testing.assert_allclose(a, b, rtol=0, atol=atol)
    else:
        # The segment factors and boundary exports (not the pivots).
        for got, want in ((fac, jfac), (fac2, jfac2)):
            for f in ("L", "lp", "G", "Fnext", "P0", "F0", "C0", "p0", "f0",
                      "LxxN"):
                np.testing.assert_allclose(
                    getattr(got, f).numpy(), getattr(want, f), rtol=0,
                    atol=atol, err_msg=f)


def test_stage_steps_against_jax(inputs):
    """``terminal_step_raw`` and one ``backward_step_folded`` (through
    ``backward_step``) on the random model's last stages."""
    jp, tp, its, _ = inputs["random_lq"]
    it = convert.iterates_from_numpy(its[0], device="cpu")
    prm = make_stage_params(tp, it, SIGMA)
    jprm = jmsp(jp, JIterates(**{k: jnp.asarray(v) for k, v in its[0].items()}),
                SIGMA)
    nu = tp.nu
    LN, pN = riccati.terminal_step(prm, tp, it.rho[-1])
    jLN, jpN = jric.terminal_step(jprm, jp, jnp.asarray(its[0]["rho"][-1]))
    np.testing.assert_allclose(LN.numpy(), np.asarray(jLN), rtol=0, atol=ATOL)
    np.testing.assert_allclose(pN.numpy(), np.asarray(jpN), rtol=0, atol=ATOL)
    k = N - 1
    stage = lambda p, q, r: (p.A[k], p.B[k], p.c[k], q.H[k], q.h[k], p.D[k],
                             r[k], q.g[k])
    (Lxx, p), (L, lp) = riccati.backward_step((LN, pN),
                                              stage(tp, prm, it.rho))
    (jLxx, jp_), (jL, jlp) = jric.backward_step(
        (jLN, jpN), stage(jp, jprm, jnp.asarray(its[0]["rho"])))
    for a, b in ((Lxx, jLxx), (p, jp_), (L, jL), (lp, jlp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=ATOL)
    # The folded form on a batch of two stages at once (leading axes).
    Hf, hf = riccati.penalty_fold(prm.H, prm.h, tp.D, it.rho, prm.g)
    two = slice(N - 2, N)
    carry = (LN.expand(2, -1, -1), pN.expand(2, -1))
    (_, _), (L2, lp2) = riccati.backward_step_folded(
        carry, (tp.A[two], tp.B[two], tp.c[two], Hf[two], hf[two]))
    jHf, jhf = jric.penalty_fold(jprm.H, jprm.h, jp.D,
                                 jnp.asarray(its[0]["rho"]), jprm.g)
    for i, kk in enumerate((N - 2, N - 1)):
        (_, _), (jL2, jlp2) = jric.backward_step_folded(
            (jLN, jpN), (jp.A[kk], jp.B[kk], jp.c[kk], jHf[kk], jhf[kk]))
        np.testing.assert_allclose(L2[i].numpy(), np.asarray(jL2), rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(lp2[i].numpy(), np.asarray(jlp2), rtol=0,
                                   atol=ATOL)
    assert nu == 2


def test_lu_condensed_pair_against_jax():
    """``lu_backward`` / ``lu_forward`` on random segment data (S=4, a
    batch of 3), against the JAX pair, and against the Cholesky pair."""
    rng = np.random.default_rng(5)
    S, nx, Bb = 4, 3, 3
    spd = lambda: (lambda G: G @ np.swapaxes(G, -1, -2) + np.eye(nx))(
        rng.normal(size=(Bb, S, nx, nx)) * 0.4)
    P, C = spd(), spd() * 0.3
    A = np.eye(nx) + rng.normal(size=(Bb, S, nx, nx)) * 0.2
    p, c, x0 = (rng.normal(size=(Bb, S, nx)), rng.normal(size=(Bb, S, nx)),
                rng.normal(size=(Bb, nx)))
    T = lambda x: torch.tensor(x)
    fac = condensed.lu_backward(T(P), T(A), T(C))
    xhat, uhat = condensed.lu_forward(fac, T(p), T(c), T(x0))
    jx, ju = jax.vmap(lambda P, A, C, p, c, x0: jcond.lu_forward(
        jcond.lu_backward(P, A, C), p, c, x0))(P, A, C, p, c, x0)
    np.testing.assert_allclose(xhat.numpy(), np.asarray(jx), rtol=0, atol=ATOL)
    np.testing.assert_allclose(uhat.numpy(), np.asarray(ju), rtol=0, atol=ATOL)
    np.testing.assert_allclose(fac.Pupd.numpy(), np.asarray(jax.vmap(
        lambda P, A, C: jcond.lu_backward(P, A, C).Pupd)(P, A, C)),
        rtol=0, atol=ATOL)
    cx, cu = condensed.cholesky_forward(
        condensed.cholesky_backward(T(P), T(A), T(C)), T(p), T(c), T(x0))
    np.testing.assert_allclose(xhat.numpy(), cx.numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(uhat.numpy(), cu.numpy(), rtol=0, atol=1e-9)
