"""Duality gap for L1/elastic-net regularized least squares.

The reference has no optimality certificate at all — its figures plot
suboptimality against the best objective seen across solvers (SURVEY.md §6).
A duality gap gives a *per-instance, on-device* certificate, which is what the
batched solver uses to count an instance as "solved to 1e-6 relative gap"
(BASELINE.json north star) without host round-trips.

For ``f(x) = ½‖Ax−b‖² + ½α₂‖x‖² + α₁‖x‖₁`` a dual-feasible scaling of the
residual gives the certificate. With ``r = Ax − b`` and smooth gradient
``u = Aᵀr + α₂x``, the dual constraint is ``‖u‖∞ ≤ α₁``; scaling
``s = min(1, α₁/‖u‖∞)`` makes ``(s·r, s·x)`` dual feasible and

    gap(x) = f(x) + ½‖s·r‖² + s·rᵀb + ½α₂‖s·x‖²    (α₂ ≥ 0)

is an upper bound on ``f(x) − f*``. Everything is computable in Gram form
(``‖r‖² = xᵀQx − 2cᵀx + bᵀb``, ``rᵀb = cᵀx − bᵀb``), so the batched Gram
solver never needs A or b.
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import Array


def _gap_from_parts(rr: Array, rb: Array, xx: Array, u_inf: Array, uu: Array,
                    l1: Array, alpha1: Array, alpha2: Array) -> Array:
    """Common gap assembly from scalar pieces.

    rr = ‖r‖², rb = rᵀb, xx = ‖x‖², u = ∇g(x) (u_inf/uu its ∞-norm / sq-norm),
    l1 = ‖x‖₁.
    """
    f = 0.5 * rr + 0.5 * alpha2 * xx + alpha1 * l1
    # L1 dual-feasibility scaling of the residual certificate.
    s = jnp.where(u_inf > alpha1, alpha1 / jnp.maximum(u_inf, 1e-38), 1.0)
    dual_neg = 0.5 * (s * s) * rr + s * rb + 0.5 * alpha2 * (s * s) * xx
    l1_gap = jnp.maximum(f + dual_neg, 0.0)
    # Smooth strongly-convex bound for alpha1 == 0: f − f* ≤ ‖∇g‖²/(2·α₂)
    # (α₂ is a strong-convexity constant; degenerate to ‖∇g‖² when α₂ = 0 —
    # then this is only a stationarity measure, not a suboptimality bound).
    smooth_gap = uu / jnp.where(alpha2 > 0, 2.0 * alpha2, 1.0)
    return jnp.where(alpha1 > 0, l1_gap, smooth_gap)


def lasso_duality_gap(problem, x: Array) -> Array:
    """Suboptimality certificate ``≥ f(x) − f*`` for a (dense or Gram form)
    least-squares problem. For ``alpha1 > 0`` this is the L1 duality gap; for
    ``alpha1 == 0, alpha2 > 0`` the strong-convexity gradient bound
    ``‖∇g‖²/(2α₂)``; for a pure unregularized problem it degrades to ``‖∇g‖²``
    (stationarity measure only)."""
    a1, a2 = problem.alpha1, problem.alpha2
    if hasattr(problem, "Q"):
        Qx = problem.Q @ x
        rr = x @ Qx - 2.0 * (problem.c @ x) + problem.btb
        rb = problem.c @ x - problem.btb
        u = Qx - problem.c + a2 * x
    else:
        r = problem.A @ x - problem.b
        rr = r @ r
        rb = r @ problem.b
        u = problem.A.T @ r + a2 * x
    return _gap_from_parts(
        rr, rb, x @ x, jnp.max(jnp.abs(u)), u @ u, jnp.sum(jnp.abs(x)), a1, a2
    )


def relative_gap(problem, x: Array, floor: float = 1.0) -> Array:
    """gap / max(f(x), floor) — the 'relative gap' of the performance target."""
    gap = lasso_duality_gap(problem, x)
    return gap / jnp.maximum(problem.objective(x), floor)
