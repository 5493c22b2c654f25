"""The port's projections, constraint mask and state helpers against the
JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages in
float64; the projections are closed forms evaluated in the same order, so
they agree to 1e-12.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdp_lqr_tpu import mpc as jmpc
from pdp_lqr_tpu.models import quadrotor as jquadrotor
from pdp_lqr_tpu.ops import projections as jproj
from pdp_lqr_tpu.solvers import admm as jadmm
from pdp_lqr_tpu_torch import convert, mpc
from pdp_lqr_tpu_torch.ops import projections as proj
from pdp_lqr_tpu_torch.solvers import admm

ATOL = 1e-12


def _close(got, ref):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def _cone_blocks(dim):
    """(40 + 4, dim) blocks [t; x] covering every branch of the SOC
    projection: random ones (inside, polar and boundary cases all occur),
    then x = 0 with t > 0, t < 0 and t = 0, and a point on the cone."""
    rng = np.random.default_rng(3)
    v = rng.normal(size=(40, dim))
    v[:10, 0] = np.abs(v[:10, 0]) * 4.0            # inside
    v[10:20, 0] = -np.abs(v[10:20, 0]) * 4.0       # polar cone
    special = np.zeros((4, dim))
    special[0, 0], special[1, 0] = 2.0, -2.0
    special[3] = 1.0 / np.sqrt(max(dim - 1, 1))
    special[3, 0] = 1.0
    return np.concatenate([v, special])


def test_project_box_matches_jax():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(5, 7)) * 3
    lb, ub = -np.abs(rng.normal(size=7)), np.abs(rng.normal(size=7))
    lb[0], ub[1] = -np.inf, np.inf
    _close(proj.project_box(*map(torch.as_tensor, (v, lb, ub))),
           jproj.project_box(*map(jnp.asarray, (v, lb, ub))))


@pytest.mark.parametrize("dim", [1, 2, 3, 6])
def test_project_soc_matches_jax_on_every_branch(dim):
    v = _cone_blocks(dim)
    ref = np.asarray(jproj.project_soc(jnp.asarray(v)))
    _close(proj.project_soc(torch.as_tensor(v)), ref)
    if dim > 1:
        nx, t = np.linalg.norm(v[:, 1:], axis=1), v[:, 0]
        assert (nx <= t).any() and (nx <= -t).any() and \
            ((nx > t) & (nx > -t)).any()
        assert np.all(np.linalg.norm(ref[:, 1:], axis=1) <= ref[:, 0] + 1e-12)


@pytest.mark.parametrize("dim", [2, 3, 5])
def test_project_rsoc_matches_jax(dim):
    v = _cone_blocks(dim)
    _close(proj.project_rsoc(torch.as_tensor(v)),
           jproj.project_rsoc(jnp.asarray(v)))


@pytest.mark.parametrize("kind", ["soc", "rsoc"])
@pytest.mark.parametrize("axis", [0, -2])
def test_project_cone_along_an_axis_matches_jax(kind, axis):
    v = np.random.default_rng(1).normal(size=(4, 5, 3))
    _close(proj.project_cone(torch.as_tensor(v), kind, axis=axis),
           jproj.project_cone(jnp.asarray(v), kind, axis=axis))


def test_project_cone_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown cone kind"):
        proj.project_cone(torch.zeros(3), "psd")


@pytest.mark.parametrize("cones,shifted", [
    ((), False),
    (((2, 3),), False),
    (((2, 3),), True),
    (((6, 4, "rsoc"), (0, 3, "soc")), True),
])
def test_project_constraints_matches_jax(cones, shifted):
    rng = np.random.default_rng(2)
    v = rng.normal(size=(6, 9, 10)) * 2
    lb = -np.abs(rng.normal(size=(9, 10)))
    ub = np.abs(rng.normal(size=(9, 10)))
    lb[:, 5], ub[:, 5] = -np.inf, np.inf
    shift = rng.normal(size=(9, 10)) if shifted else None
    ref = jproj.project_constraints(
        jnp.asarray(v), jnp.asarray(lb), jnp.asarray(ub), cones,
        None if shift is None else jnp.asarray(shift))
    got = proj.project_constraints(
        torch.as_tensor(v), torch.as_tensor(lb), torch.as_tensor(ub), cones,
        None if shift is None else torch.as_tensor(shift))
    _close(got, ref)


def test_project_rows_along_the_row_axis_is_project_constraints():
    """The batch-last form the kernels' plain versions use (rows on axis
    0) is the same projection as the row-last one."""
    rng = np.random.default_rng(4)
    v = rng.normal(size=(7, 11))
    lb, ub, sh = (rng.normal(size=(7, 1)) - 2, rng.normal(size=(7, 1)) + 2,
                  rng.normal(size=(7, 1)))
    cones = ((1, 3, "soc"), (4, 3, "rsoc"))
    t = torch.as_tensor
    got = proj.project_rows(t(v), t(lb), t(ub), cones, t(sh), axis=0)
    ref = proj.project_constraints(t(v.T), t(lb.T), t(ub.T), cones, t(sh.T))
    np.testing.assert_allclose(got.numpy(), ref.numpy().T, atol=ATOL, rtol=0)


def test_normalize_cones_matches_jax():
    specs = [(5, 3), (0, 2, "rsoc"), (2, 3, "soc")]
    assert proj.normalize_cones(specs) == jproj.normalize_cones(specs)
    assert proj.normalize_cones(()) == ()


@pytest.mark.parametrize("specs,match", [
    ([(0, 3, "psd")], "unknown cone kind"),
    ([(0, 1, "rsoc")], "dim >= 2"),
    ([(0, 3), (2, 3)], "overlapping"),
])
def test_normalize_cones_rejects_what_jax_rejects(specs, match):
    with pytest.raises(ValueError, match=match):
        jproj.normalize_cones(specs)
    with pytest.raises(ValueError, match=match):
        proj.normalize_cones(specs)


# --------------------------------------------- mask, init_state, shift_state

def _asdict_np(tree):
    return {f.name: np.asarray(getattr(tree, f.name))
            for f in dataclasses.fields(tree)}


@pytest.fixture(scope="module")
def cone_problem():
    """Quadrotor with box rows and the thrust cone, in both packages."""
    jp, cones = jquadrotor(N=5, constrained=True, thrust_cone=True,
                           dtype=jnp.float64)
    return jp, convert.problem_from_numpy(_asdict_np(jp), device="cpu"), \
        tuple(cones)


def test_con_mask_matches_jax(cone_problem):
    jp, tp, cones = cone_problem
    # A cone whose t-row has an all-zero D row stays active as a block.
    D = np.asarray(jp.D).copy()
    D[:, 16] = 0.0
    D[2, 16:19] = 0.0                 # ... unless the whole block is zero
    jp2 = dataclasses.replace(jp, D=jnp.asarray(D))
    tp2 = dataclasses.replace(tp, D=torch.as_tensor(D))
    for args in ((jp, tp, ()), (jp2, tp2, ()), (jp2, tp2, cones)):
        ref = np.asarray(jadmm._con_mask(args[0], args[2]))
        got = admm._con_mask(args[1], args[2])
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), ref)
    assert not admm._con_mask(tp2, ())[0, 16] and admm._con_mask(tp2, cones)[0, 16]
    assert not admm._con_mask(tp2, cones)[2, 16:19].any()


def test_init_state_matches_jax(cone_problem):
    jp, tp, _ = cone_problem
    ref = jadmm.init_state(jp, jadmm.ADMMSettings(rho=0.3))
    got = admm.init_state(tp, admm.ADMMSettings(rho=0.3))
    for name in ("w", "z", "y", "rho"):
        g, r = getattr(got, name), np.asarray(getattr(ref, name))
        assert tuple(g.shape) == r.shape and g.dtype == torch.float64
        np.testing.assert_array_equal(g.numpy(), r)
    assert got.factors is None


@pytest.mark.parametrize("batched", [False, True])
def test_shift_state_matches_jax(cone_problem, batched):
    jp, tp, _ = cone_problem
    rng = np.random.default_rng(5)
    lead = (3,) if batched else ()
    fields = {"w": rng.normal(size=lead + (6, 16)),
              "z": rng.normal(size=lead + (6, 19)),
              "y": rng.normal(size=lead + (6, 19)),
              "rho": np.full(lead, 0.2)}
    marker = (torch.zeros(1),)
    ref = jmpc.shift_state(
        jadmm.ADMMState(**{k: jnp.asarray(v) for k, v in fields.items()}), jp)
    got = mpc.shift_state(dataclasses.replace(
        convert.state_from_numpy(fields, device="cpu"), factors=marker), tp)
    for name in ("w", "z", "y", "rho"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    assert got.factors is marker          # the factors ride along untouched


def test_settings_are_frozen_hashable_and_default_alike():
    ours, theirs = admm.ADMMSettings(), jadmm.ADMMSettings()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert hash(ours) == hash(admm.ADMMSettings())
    with pytest.raises(dataclasses.FrozenInstanceError):
        ours.rho = 1.0


def test_info_repr_reads_like_the_jax_one():
    info = admm.ADMMInfo(
        iterations=torch.tensor(7), r_prim=torch.tensor(1.5e-3),
        r_dual=torch.tensor(2.5e-4), converged=torch.tensor(True),
        iter_converged=torch.tensor(7))
    assert repr(info) == ("ADMMInfo(iters=7, r_prim=1.500e-03, "
                          "r_dual=2.500e-04, converged=True)")
