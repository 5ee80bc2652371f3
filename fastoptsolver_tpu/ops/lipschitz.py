"""Lipschitz-constant estimation via power iteration, as a compiled fixed-point.

A compiled redesign of the reference's ``estimate_lipschitz``
(``/root/reference/iterative_solvers.py:45-60``): same recurrence
(``w = AᵀAv; L = ||w||; v = w/L``, 100 iterations, tol 1e-6 on |L−prev|) but

- the start vector is driven by an explicit PRNG key (the reference uses an
  *unseeded* ``np.random.randn`` — nondeterministic; SURVEY.md §7 item 9 marks
  this as a must-fix),
- the loop is a ``lax.while_loop`` so it jits, vmaps over instance batches,
  and runs on-device with no host round trips,
- it accepts either an operator form (A) or a Gram form (Q = AᵀA).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import Array


class _PowerState(NamedTuple):
    v: Array
    L: Array
    prev: Array
    k: Array


def _power_iteration(matvec, v0: Array, n_iter: int, tol: float) -> Array:
    nrm = jnp.linalg.norm(v0)
    v0 = v0 / jnp.maximum(nrm, jnp.finfo(v0.dtype).tiny)

    def cond(s: _PowerState):
        return (s.k < n_iter) & (jnp.abs(s.L - s.prev) >= tol)

    def body(s: _PowerState):
        w = matvec(s.v)
        L = jnp.linalg.norm(w)
        v = w / jnp.maximum(L, jnp.finfo(w.dtype).tiny)
        return _PowerState(v=v, L=L, prev=s.L, k=s.k + 1)

    init = _PowerState(
        v=v0,
        L=jnp.asarray(0.0, v0.dtype),
        prev=jnp.asarray(jnp.inf, v0.dtype),
        k=jnp.asarray(0, jnp.int32),
    )
    return jax.lax.while_loop(cond, body, init).L


def estimate_lipschitz(
    A: Array,
    key: Array | None = None,
    n_iter: int = 100,
    tol: float = 1e-6,
) -> Array:
    """λ_max(AᵀA) via power iteration on the two-matvec operator."""
    if key is None:
        key = jax.random.PRNGKey(0)
    n = A.shape[-1]
    v0 = jax.random.normal(key, (n,), dtype=A.dtype)
    return _power_iteration(lambda v: A.T @ (A @ v), v0, n_iter, tol)


def estimate_lipschitz_gram(
    Q: Array,
    key: Array | None = None,
    n_iter: int = 100,
    tol: float = 1e-6,
) -> Array:
    """λ_max(Q) for symmetric PSD Q (= AᵀA), one matvec per iteration."""
    if key is None:
        key = jax.random.PRNGKey(0)
    n = Q.shape[-1]
    v0 = jax.random.normal(key, (n,), dtype=Q.dtype)
    return _power_iteration(lambda v: Q @ v, v0, n_iter, tol)


def lipschitz_for(problem, key: Array | None = None, n_iter: int = 100, tol: float = 1e-6) -> Array:
    """Smooth-part Lipschitz constant for a least-squares problem:
    λ_max(AᵀA) + α₂ (the reference's choice, iterative_solvers.py:155-157;
    the +α₂ is applied whenever α₂ > 0)."""
    if hasattr(problem, "normal_matvec"):
        # Distributed problems supply their own sharded AᵀA operator.
        if key is None:
            key = jax.random.PRNGKey(0)
        v0 = jax.random.normal(key, (problem.dim,), dtype=problem.A.dtype)
        L = _power_iteration(problem.normal_matvec, v0, n_iter, tol)
    elif hasattr(problem, "Q"):
        L = estimate_lipschitz_gram(problem.Q, key, n_iter, tol)
    else:
        L = estimate_lipschitz(problem.A, key, n_iter, tol)
    if getattr(problem, "ridge_in_smooth", True):
        L = L + getattr(problem, "alpha2", 0.0)
    return L
