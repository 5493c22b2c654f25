"""Small dense linear-algebra primitives of the solver backends (PyTorch
port of ``pdp_lqr_tpu/ops/linalg.py``).

The reference leans on Eigen's LLT and triangular solves
(lqr_kernel.hpp:89,126,145,199; condensed_system.hpp LLT/PartialPivLU).
Here they are thin wrappers over ``torch.linalg`` so that every call site
reads like the math.  All functions work on the *trailing* two axes and
batch over any leading axes.

A right-hand side ``b`` is a vector when it has one axis fewer than the
matrix (``(..., n)`` against ``(..., n, n)``), else a matrix ``(..., n, k)``.

The JAX package's ``*_unrolled`` variants spell the same factorizations
out entry by entry, because XLA's TPU lowering of small batched
factorizations is a sequential loop.  On a GPU the batched library calls
are the fast form (an entry-by-entry Python unroll would launch thousands
of tiny kernels), so the unrolled triangular and Cholesky solves are the
plain ones here; the two variants whose semantics differ keep their
names: ``cholesky_unrolled`` (the lower triangle as given, no
symmetrization) and ``ge_solve_unrolled`` (a general solve with partial
pivoting).

Failure signalling follows ``jnp.linalg.cholesky``: a batch instance that
is not positive definite gets NaN on and below the diagonal, the others
are exact; nothing raises, so a NaN reaches the caller's per-instance
checks without a host read.
"""

from __future__ import annotations

import torch


def _is_vector(L, b):
    return b.ndim == L.ndim - 1


def _lower_cholesky(M):
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where((info == 0)[..., None, None], L,
                       torch.full_like(L, float("nan")).tril())


def cholesky(M):
    """Lower Cholesky factor of the symmetric part of M, L @ L.T = M (as
    ``jnp.linalg.cholesky``, which symmetrizes its input).

    Reference: Eigen ``M.llt().matrixL()`` (lqr_kernel.hpp:89,126).
    """
    return _lower_cholesky(0.5 * (M + M.mT))


def solve_lower(L, b):
    """Solve L y = b with L lower triangular (forward substitution).

    Reference: ``L.triangularView<Lower>().solveInPlace`` (lqr_kernel.hpp:145).
    """
    if _is_vector(L, b):
        return solve_lower(L, b[..., None])[..., 0]
    return torch.linalg.solve_triangular(L, b, upper=False)


def solve_lower_T(L, b):
    """Solve L^T y = b with L lower triangular (back substitution).

    Reference: ``L.triangularView<Lower>().transpose().solveInPlace``
    (lqr_kernel.hpp:199, lqr_kernel_parallel.hpp:107-108).
    """
    if _is_vector(L, b):
        return solve_lower_T(L, b[..., None])[..., 0]
    return torch.linalg.solve_triangular(L.mT, b, upper=True)


def chol_solve(L, b):
    """Solve (L L^T) y = b given the Cholesky factor L.

    Reference: Eigen ``LLT::solveInPlace`` (condensed_system.hpp:220,227).
    """
    return solve_lower_T(L, solve_lower(L, b))


def cholesky_unrolled(M):
    """Lower Cholesky of a small SPD matrix from its lower triangle (no
    symmetrization), NaN where an instance is not positive definite."""
    return _lower_cholesky(M)


def ge_solve_unrolled(A, Bmat):
    """Solve A X = B for small general A with partial pivoting: A
    (..., n, n), Bmat (..., n, k) -> (..., n, k)."""
    return torch.linalg.solve_ex(A, Bmat)[0]
