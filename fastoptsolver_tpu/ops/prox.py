"""Proximal operators.

Compiled equivalents of the reference's prox operators
(``/root/reference/prox_operators.py:3-16``), written as pure ``jnp``
functions: elementwise, fully fusable by XLA, and trivially vmappable over
stacked instance batches (the value *and* the threshold may both be batched).

Extra operators beyond the reference (group lasso, box, non-negativity) round
out the composite-optimization problem class.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import Array


def soft_threshold(v: Array, tau: Array) -> Array:
    """L1 prox (soft thresholding): ``sign(v) * max(|v| - tau, 0)``.

    Parity: reference ``prox_l1`` (prox_operators.py:3-8).
    """
    return jnp.sign(v) * jnp.maximum(jnp.abs(v) - tau, 0.0)


# Reference-compatible alias.
prox_l1 = soft_threshold


def prox_elastic_net(v: Array, tau: Array, alpha1: Array, alpha2: Array) -> Array:
    """Prox of ``h(x) = alpha1*||x||_1 + 0.5*alpha2*||x||_2^2``.

    ``prox = soft_threshold(v, tau*alpha1) / (1 + tau*alpha2)``.
    Parity: reference ``prox_elastic_net`` (prox_operators.py:10-16) — note the
    reference's solvers never call this (they fold the ridge term into the
    smooth part and use plain L1 prox); we expose both paths the same way.
    """
    return soft_threshold(v, tau * alpha1) / (1.0 + tau * alpha2)


def prox_group_lasso(v: Array, tau: Array, axis: int = -1, eps: float = 1e-12) -> Array:
    """Block soft thresholding: shrink each group (slice along ``axis``) by its
    L2 norm: ``v * max(1 - tau/||v||_2, 0)`` per group.

    Not in the reference; standard composite-optimization extension.
    """
    norms = jnp.linalg.norm(v, axis=axis, keepdims=True)
    scale = jnp.maximum(1.0 - tau / jnp.maximum(norms, eps), 0.0)
    return v * scale


def prox_nonneg(v: Array, tau: Array = 0.0) -> Array:
    """Projection onto the non-negative orthant (prox of the indicator)."""
    del tau
    return jnp.maximum(v, 0.0)


def prox_box(v: Array, tau: Array = 0.0, lower: Array = -1.0, upper: Array = 1.0) -> Array:
    """Projection onto the box ``[lower, upper]`` (prox of the indicator)."""
    del tau
    return jnp.clip(v, lower, upper)


def prox_zero(v: Array, tau: Array = 0.0) -> Array:
    """Prox of ``h = 0`` (identity) — used for pure smooth problems (ridge)."""
    del tau
    return v


def isotonic_regression(w: Array, increasing: bool = True) -> Array:
    """Euclidean projection of ``w`` (1-D) onto the monotone cone.

    Array formulation: instead of the sequential pool-adjacent-violators
    stack (data-dependent control flow — hostile to XLA), this evaluates the
    classic minimax characterization of the isotonic fit,

        z_i = max_{j<=i} min_{k>=i} mean(w[j..k])        (non-decreasing)

    as three dense O(n²) array ops (prefix-sum outer difference, cumulative
    max, reversed cumulative min) — no data-dependent shapes, vmappable,
    all elementwise and scan work. O(n²) memory: intended for the n ≤ a-few-thousand
    coefficient vectors of this problem class, not megapoint curves.

    Not in the reference; foundation for the SLOPE prox (``prox_slope``).
    """
    if not increasing:
        return -isotonic_regression(-w, increasing=True)
    n = w.shape[-1]
    dtype = w.dtype
    P = jnp.concatenate([jnp.zeros((1,), dtype), jnp.cumsum(w)])  # (n+1,)
    j = jnp.arange(n)[:, None]
    k = jnp.arange(n)[None, :]
    length = (k + 1 - j).astype(dtype)
    # mean(w[j..k]) for j <= k; lower triangle (j > k) masked to -inf so the
    # running max over j ignores it.
    means = (P[k + 1] - P[j]) / jnp.where(length > 0, length, 1.0)
    neg_inf = jnp.asarray(-jnp.inf, dtype)
    means = jnp.where(j <= k, means, neg_inf)
    # C[i, k] = max_{j<=i} mean(w[j..k])
    C = jax.lax.cummax(means, axis=0)
    # z_i = min_{k>=i} C[i, k]
    R = jnp.flip(jax.lax.cummin(jnp.flip(C, axis=1), axis=1), axis=1)
    return jnp.diagonal(R)


def prox_slope(v: Array, lam: Array) -> Array:
    """Prox of the sorted-L1 (SLOPE / OWL) norm ``h(x) = Σ_i λ_i |x|_(i)``
    with ``λ_1 ≥ … ≥ λ_n ≥ 0`` and ``|x|_(1) ≥ … ≥ |x|_(n)`` the magnitudes
    in decreasing order.

    Algorithm (Bogdan et al. 2015, "SLOPE — Adaptive variable selection via
    convex optimization", FastProxSL1): sort ``|v|`` decreasing, subtract the
    λ ladder, project onto the non-increasing cone, clip at zero, undo the
    sort and signs. The isotonic projection uses the dense minimax form
    (``isotonic_regression``) so the whole prox is one fused XLA program.

    ``lam`` may be pre-scaled by the step size (pass ``tau * lam``); a scalar
    ``lam`` broadcasts to a constant ladder, recovering ``soft_threshold``.
    """
    lam = jnp.broadcast_to(jnp.asarray(lam, v.dtype), v.shape)
    u = jnp.abs(v)
    order = jnp.argsort(-u)
    z = isotonic_regression(u[order] - lam, increasing=False)
    z = jnp.maximum(z, 0.0)
    inv = jnp.argsort(order)
    return jnp.sign(v) * z[inv]


def slope_norm(x: Array, lam: Array) -> Array:
    """The sorted-L1 norm value ``Σ_i λ_i |x|_(i)`` (λ non-increasing)."""
    lam = jnp.broadcast_to(jnp.asarray(lam, x.dtype), x.shape)
    return jnp.sum(lam * jnp.sort(jnp.abs(x))[::-1])
