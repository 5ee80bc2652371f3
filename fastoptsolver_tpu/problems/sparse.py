"""Sparse design matrices: the same problem protocol over a BCOO ``A``.

Capability addition (the reference is dense-NumPy only). For very sparse,
very large design matrices the dense matvec wastes bandwidth on zeros;
``SparseLeastSquares`` stores ``A`` in JAX's batched-COO format
(``jax.experimental.sparse.BCOO``) and runs the exact same solvers — the
problem protocol (problems/base.py) is the only contract, so ISTA / FISTA /
FISTA-Δ / OWL-QN / ADMM-via-Gram work unchanged.

Accelerator notes:

- BCOO matvecs lower to gather/scatter (segment sums), which do not use the
  matrix units; they win over dense once density drops well below the ratio
  of gather to FMA throughput (≈ a few %). For mid-density matrices prefer
  the dense path — it is bound by memory bandwidth (bench/large_lasso.py).
  How XLA:GPU lowers the BCOO matvec is not measured yet.
- ``to_gram()`` densifies the (n × n) Gram product: for n up to a few
  thousand that is exactly the fast path (iterations become dense n² work
  and never touch the sparse structure again) — the sparse
  structure only pays for the one-time O(nnz·n) precompute.
- The Lipschitz constant comes from the operator-form power iteration
  (ops/lipschitz.py works on closures, no dense A needed).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from jax import Array
from jax.experimental import sparse as jsparse

from ..ops.lipschitz import _power_iteration
from ..ops.prox import soft_threshold
from .base import fold_alphas
from .least_squares import GramLeastSquares


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SparseLeastSquares:
    """``g(x) = ½‖Ax−b‖² + ½α₂‖x‖²``, ``h = α₁‖x‖₁``, with BCOO ``A``."""

    A: jsparse.BCOO  # (m, n)
    b: Array  # (m,)
    alpha1: Array
    alpha2: Array

    @classmethod
    def create(
        cls,
        A,
        b,
        reg_type: str = "lasso",
        alpha1: float = 0.0,
        alpha2: float = 0.0,
        dtype=jnp.float32,
    ) -> "SparseLeastSquares":
        """``A`` may be a dense array (converted), a ``scipy.sparse`` matrix,
        or a BCOO."""
        a1, a2, _ = fold_alphas(reg_type, alpha1, alpha2)
        if isinstance(A, jsparse.BCOO):
            A = A.astype(dtype) if A.dtype != dtype else A
        elif hasattr(A, "tocoo"):  # scipy.sparse
            coo = A.tocoo()
            indices = jnp.stack(
                [jnp.asarray(coo.row), jnp.asarray(coo.col)], axis=1
            )
            A = jsparse.BCOO(
                (jnp.asarray(coo.data, dtype), indices), shape=coo.shape
            )
        else:
            A = jsparse.BCOO.fromdense(jnp.asarray(A, dtype))
        return cls(
            A=A,
            b=jnp.asarray(b, dtype),
            alpha1=jnp.asarray(a1, dtype),
            alpha2=jnp.asarray(a2, dtype),
        )

    @property
    def dim(self) -> int:
        return self.A.shape[-1]

    @property
    def density(self) -> float:
        return self.A.nse / (self.A.shape[0] * self.A.shape[1])

    @property
    def ridge_in_smooth(self) -> bool:
        return True

    def residual(self, x: Array) -> Array:
        return self.A @ x - self.b

    def smooth_value(self, x: Array) -> Array:
        r = self.residual(x)
        return 0.5 * (r @ r) + 0.5 * self.alpha2 * (x @ x)

    def smooth_grad(self, x: Array) -> Array:
        return self.A.T @ self.residual(x) + self.alpha2 * x

    def smooth_value_and_grad(self, x: Array) -> tuple[Array, Array]:
        r = self.residual(x)
        val = 0.5 * (r @ r) + 0.5 * self.alpha2 * (x @ x)
        grad = self.A.T @ r + self.alpha2 * x
        return val, grad

    def prox(self, v: Array, tau: Array) -> Array:
        return soft_threshold(v, tau * self.alpha1)

    def nonsmooth_value(self, x: Array) -> Array:
        return self.alpha1 * jnp.sum(jnp.abs(x))

    def objective(self, x: Array) -> Array:
        return self.smooth_value(x) + self.nonsmooth_value(x)

    def x0(self) -> Array:
        return jnp.zeros(self.dim, dtype=self.b.dtype)

    def lipschitz(self, key: Array | None = None, n_iter: int = 100,
                  tol: float = 1e-6) -> Array:
        """λ_max(AᵀA) + α₂ by operator power iteration — never densifies A."""
        if key is None:
            key = jax.random.PRNGKey(0)
        v0 = jax.random.normal(key, (self.dim,), dtype=self.b.dtype)
        L = _power_iteration(
            lambda v: self.A.T @ (self.A @ v), v0, n_iter, tol
        )
        return L + self.alpha2

    def to_gram(self) -> GramLeastSquares:
        """Gram precompute via the sparse-sparse product ``AᵀA`` (O(nnz·n),
        A is never densified), then dense O(n²) iterations. The right trade
        whenever n² fits comfortably on-chip."""
        Q = (self.A.T @ self.A).todense()
        return GramLeastSquares(
            Q=Q,
            c=self.A.T @ self.b,
            btb=self.b @ self.b,
            alpha1=self.alpha1,
            alpha2=self.alpha2,
        )
