"""Problem-definition protocol.

The reference exposes two incompatible solver APIs: a generic injectable-closure
ISTA (``/root/reference/iterative_solvers.py:65-77`` — caller supplies ``g``,
``grad_g``, ``prox_h``, ``L``) and concrete ``(A, b, reg_type, alpha1, alpha2)``
FISTA/FISTA-Δ signatures (``iterative_solvers.py:132-147``). This framework
unifies both behind one *problem object* protocol: every problem is a JAX
pytree (so it can be jitted over, vmapped over, and sharded) exposing

  - ``smooth_value(x)``        g(x), the differentiable part
  - ``smooth_grad(x)``         ∇g(x)
  - ``smooth_value_and_grad(x)``  both, sharing the matvec
  - ``prox(v, tau)``           prox_{tau*h}(v) for the nonsmooth part h
  - ``nonsmooth_value(x)``     h(x)
  - ``objective(x)``           g(x) + h(x)
  - ``dim``                    number of optimization variables

Solvers are generic over this protocol; regularization type folding (lasso /
ridge / elasticnet → effective alphas) happens at problem construction, once,
outside the compiled region.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
from jax import Array

# Regularization types accepted by the reference
# (objective_functions.py:17-28, lbfgs.py:11-35).
REG_TYPES = ("lasso", "ridge", "elasticnet")


def fold_alphas(
    reg_type: str, alpha1: float, alpha2: float, eps: float = 0.0
) -> tuple[float, float, str]:
    """Normalize ``(reg_type, alpha1, alpha2)`` into effective coefficients.

    Mirrors the reference's semantics: lasso zeroes alpha2, ridge zeroes
    alpha1, elasticnet keeps both; unknown types raise ``ValueError``
    (objective_functions.py:27-28). With ``eps > 0`` this also applies the
    L-BFGS tiny-α reclassification (lbfgs.py:19-33): elastic-net with
    ``alpha1 < eps`` → ridge, ``alpha2 < eps`` → lasso.

    Returns ``(alpha1_eff, alpha2_eff, reg_type_eff)``.
    """
    if reg_type == "lasso":
        return alpha1, 0.0, "lasso"
    if reg_type == "ridge":
        return 0.0, alpha2, "ridge"
    if reg_type == "elasticnet":
        if eps > 0.0 and alpha1 < eps:
            return 0.0, alpha2, "ridge"
        if eps > 0.0 and alpha2 < eps:
            return alpha1, 0.0, "lasso"
        return alpha1, alpha2, "elasticnet"
    raise ValueError(f"Unsupported reg_type='{reg_type}'")


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CustomProblem:
    """Fully generic problem from user-supplied closures — the compiled
    equivalent of the reference ISTA's injectable-callable API
    (iterative_solvers.py:65-70). The callables are static pytree metadata, so
    a ``CustomProblem`` still jits/vmaps over its array leaves (captured inside
    the closures or passed via ``params``).
    """

    params: dict = dataclasses.field(default_factory=dict)
    smooth_value_fn: Callable = dataclasses.field(
        default=None, metadata=dict(static=True)
    )
    smooth_grad_fn: Callable = dataclasses.field(default=None, metadata=dict(static=True))
    prox_fn: Callable = dataclasses.field(default=None, metadata=dict(static=True))
    nonsmooth_value_fn: Callable = dataclasses.field(
        default=None, metadata=dict(static=True)
    )
    n_dim: int = dataclasses.field(default=0, metadata=dict(static=True))

    @property
    def dim(self) -> int:
        return self.n_dim

    def smooth_value(self, x: Array) -> Array:
        return self.smooth_value_fn(x, **self.params)

    def smooth_grad(self, x: Array) -> Array:
        if self.smooth_grad_fn is None:
            return jax.grad(lambda z: self.smooth_value_fn(z, **self.params))(x)
        return self.smooth_grad_fn(x, **self.params)

    def smooth_value_and_grad(self, x: Array) -> tuple[Array, Array]:
        return self.smooth_value(x), self.smooth_grad(x)

    def prox(self, v: Array, tau: Array) -> Array:
        if self.prox_fn is None:
            return v
        return self.prox_fn(v, tau, **self.params)

    def nonsmooth_value(self, x: Array) -> Array:
        if self.nonsmooth_value_fn is None:
            return jnp.zeros((), dtype=x.dtype)
        return self.nonsmooth_value_fn(x, **self.params)

    def objective(self, x: Array) -> Array:
        return self.smooth_value(x) + self.nonsmooth_value(x)
