"""Regularized least-squares problems, in dense and Gram form.

Covers the reference's whole problem class — ``f(x) = ½||Ax−b||² +
½·α₂||x||² + α₁||x||₁`` with lasso / ridge / elastic-net alpha folding
(objective_functions.py:3-30) — as immutable pytrees.

Two representations, same protocol:

- :class:`LeastSquares` holds ``(A, b)`` directly. Gradient costs two matvecs
  (``Aᵀ(Ax−b)``), exactly the reference inner loop
  (iterative_solvers.py:173-175). This is the form to use for *large* design
  matrices (sharded across chips — each matvec is a local matmul + psum).

- :class:`GramLeastSquares` holds the normal-equation precompute
  ``Q = AᵀA, c = Aᵀb, btb = bᵀb``: gradient is ``Qx − c`` — O(n²) per
  iteration instead of O(mn). Mathematically identical (``AᵀAx − Aᵀb =
  Aᵀ(Ax−b)``), and the key to the batched-instances throughput target: for
  thousands of small (m×n, n≈5..64) instances the iteration state is a few
  bytes per instance and never touches A again. No analogue in the reference (which
  recomputes both matvecs every iteration).

Both forms fold the ridge term into the smooth part and use plain soft
thresholding as the prox — matching the reference solvers, which never call
``prox_elastic_net`` (iterative_solvers.py:166-167, :201).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from jax import Array

from ..ops.prox import prox_elastic_net, soft_threshold
from .base import fold_alphas


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LeastSquares:
    """``g(x) = ½||Ax−b||² + ½·α₂||x||²``, ``h(x) = α₁||x||₁``.

    With ``en_prox=True`` the ridge term moves into the *nonsmooth* part and
    the prox becomes the elastic-net prox (``prox_operators.py:10-16``):
    ``g = ½||Ax−b||²``, ``h = α₁||x||₁ + ½α₂||x||²``. The reference defines
    this operator but its solvers never use it (SURVEY.md §7 item 5) — both
    paths are exposed here; they converge to the same minimizer.
    """

    A: Array  # (m, n)
    b: Array  # (m,)
    alpha1: Array  # scalar (effective L1 weight; 0 disables prox/h)
    alpha2: Array  # scalar (effective ridge weight)
    en_prox: bool = dataclasses.field(default=False, metadata=dict(static=True))

    @classmethod
    def create(
        cls,
        A,
        b,
        reg_type: str = "lasso",
        alpha1: float = 0.0,
        alpha2: float = 0.0,
        dtype=jnp.float32,
        en_prox: bool = False,
    ) -> "LeastSquares":
        a1, a2, _ = fold_alphas(reg_type, alpha1, alpha2)
        A = jnp.asarray(A, dtype)
        b = jnp.asarray(b, dtype)
        return cls(
            A=A,
            b=b,
            alpha1=jnp.asarray(a1, dtype),
            alpha2=jnp.asarray(a2, dtype),
            en_prox=en_prox,
        )

    @property
    def dim(self) -> int:
        return self.A.shape[-1]

    @property
    def ridge_in_smooth(self) -> bool:
        """Whether α₂ contributes to the smooth part's Lipschitz constant."""
        return not self.en_prox

    def residual(self, x: Array) -> Array:
        return self.A @ x - self.b

    def _smooth_a2(self):
        # en_prox is static, so this branch resolves at trace time
        return 0.0 if self.en_prox else self.alpha2

    def smooth_value(self, x: Array) -> Array:
        r = self.residual(x)
        return 0.5 * (r @ r) + 0.5 * self._smooth_a2() * (x @ x)

    def smooth_grad(self, x: Array) -> Array:
        return self.A.T @ self.residual(x) + self._smooth_a2() * x

    def smooth_value_and_grad(self, x: Array) -> tuple[Array, Array]:
        r = self.residual(x)
        val = 0.5 * (r @ r) + 0.5 * self._smooth_a2() * (x @ x)
        grad = self.A.T @ r + self._smooth_a2() * x
        return val, grad

    def prox(self, v: Array, tau: Array) -> Array:
        if self.en_prox:
            return prox_elastic_net(v, tau, self.alpha1, self.alpha2)
        return soft_threshold(v, tau * self.alpha1)

    def nonsmooth_value(self, x: Array) -> Array:
        h = self.alpha1 * jnp.sum(jnp.abs(x))
        if self.en_prox:
            h = h + 0.5 * self.alpha2 * (x @ x)
        return h

    def objective(self, x: Array) -> Array:
        return self.smooth_value(x) + self.nonsmooth_value(x)

    def x0(self) -> Array:
        """Reference starting point: zeros (iterative_solvers.py:150)."""
        return jnp.zeros(self.dim, dtype=self.A.dtype)

    def to_gram(self) -> "GramLeastSquares":
        """Precompute the normal-equation form. One (n×m)@(m×n) matmul,
        done once outside the solver loop."""
        if self.en_prox:
            raise NotImplementedError(
                "Gram form folds the ridge term into the smooth part; use "
                "en_prox=False (same minimizer)"
            )
        Q = self.A.T @ self.A
        c = self.A.T @ self.b
        return GramLeastSquares(
            Q=Q,
            c=c,
            btb=self.b @ self.b,
            alpha1=self.alpha1,
            alpha2=self.alpha2,
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GramLeastSquares:
    """Normal-equation form: ``g(x) = ½ xᵀQx − cᵀx + ½ btb + ½·α₂||x||²``."""

    Q: Array  # (n, n) = AᵀA
    c: Array  # (n,)   = Aᵀb
    btb: Array  # scalar = bᵀb
    alpha1: Array
    alpha2: Array

    @classmethod
    def create(
        cls, A, b, reg_type: str = "lasso", alpha1: float = 0.0, alpha2: float = 0.0,
        dtype=jnp.float32,
    ) -> "GramLeastSquares":
        return LeastSquares.create(A, b, reg_type, alpha1, alpha2, dtype).to_gram()

    @property
    def dim(self) -> int:
        return self.Q.shape[-1]

    def smooth_value(self, x: Array) -> Array:
        return 0.5 * (x @ (self.Q @ x)) - self.c @ x + 0.5 * self.btb + 0.5 * self.alpha2 * (x @ x)

    def smooth_grad(self, x: Array) -> Array:
        return self.Q @ x - self.c + self.alpha2 * x

    def smooth_value_and_grad(self, x: Array) -> tuple[Array, Array]:
        Qx = self.Q @ x
        val = 0.5 * (x @ Qx) - self.c @ x + 0.5 * self.btb + 0.5 * self.alpha2 * (x @ x)
        grad = Qx - self.c + self.alpha2 * x
        return val, grad

    def prox(self, v: Array, tau: Array) -> Array:
        return soft_threshold(v, tau * self.alpha1)

    def nonsmooth_value(self, x: Array) -> Array:
        return self.alpha1 * jnp.sum(jnp.abs(x))

    def objective(self, x: Array) -> Array:
        return self.smooth_value(x) + self.nonsmooth_value(x)

    def x0(self) -> Array:
        return jnp.zeros(self.dim, dtype=self.Q.dtype)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LogisticRegression:
    """Smooth L2-regularized logistic regression — the 'smooth objectives'
    member of the problem class (BASELINE.json config: 'L-BFGS on smooth
    ridge/logistic objectives'). Labels in {−1, +1}.

    ``g(x) = Σᵢ log(1 + exp(−yᵢ·aᵢᵀx)) + ½·α₂||x||²``; optional L1 via prox.
    """

    A: Array  # (m, n)
    y: Array  # (m,) labels in {-1, +1}
    alpha1: Array
    alpha2: Array

    @classmethod
    def create(cls, A, y, alpha1: float = 0.0, alpha2: float = 0.0, dtype=jnp.float32):
        return cls(
            A=jnp.asarray(A, dtype),
            y=jnp.asarray(y, dtype),
            alpha1=jnp.asarray(alpha1, dtype),
            alpha2=jnp.asarray(alpha2, dtype),
        )

    @property
    def dim(self) -> int:
        return self.A.shape[-1]

    def smooth_value(self, x: Array) -> Array:
        margins = self.y * (self.A @ x)
        # log(1+exp(-m)) computed stably as softplus(-m)
        return jnp.sum(jax.nn.softplus(-margins)) + 0.5 * self.alpha2 * (x @ x)

    def smooth_grad(self, x: Array) -> Array:
        margins = self.y * (self.A @ x)
        w = -self.y * jax.nn.sigmoid(-margins)
        return self.A.T @ w + self.alpha2 * x

    def smooth_value_and_grad(self, x: Array) -> tuple[Array, Array]:
        margins = self.y * (self.A @ x)
        val = jnp.sum(jax.nn.softplus(-margins)) + 0.5 * self.alpha2 * (x @ x)
        w = -self.y * jax.nn.sigmoid(-margins)
        grad = self.A.T @ w + self.alpha2 * x
        return val, grad

    def prox(self, v: Array, tau: Array) -> Array:
        return soft_threshold(v, tau * self.alpha1)

    def nonsmooth_value(self, x: Array) -> Array:
        return self.alpha1 * jnp.sum(jnp.abs(x))

    def objective(self, x: Array) -> Array:
        return self.smooth_value(x) + self.nonsmooth_value(x)

    def x0(self) -> Array:
        return jnp.zeros(self.dim, dtype=self.A.dtype)
