"""Generalized lasso — ADMM on ``½‖Ax − b‖² + ½α₂‖x‖² + α₁‖W·Dx‖₁``.

Capability addition with no analogue in the reference (its nonsmooth terms
are separable — L1/elastic-net only, /root/reference/prox_operators.py:3-16);
a structured penalty ``‖Dx‖₁`` through an arbitrary linear operator D covers
the classic family in one solver:

- **fused lasso**            D = [first differences; identity]
- **1D total variation**     A = I, D = first differences (signal denoising)
- **ℓ1 trend filtering**     A = I, D = k-th order differences
- any user D (graph incidence matrices, wavelet frames, …)

Splitting ``z = Dx`` (Boyd et al., Distributed Optimization §6.4):

    x⁺ = (AᵀA + α₂I + ρDᵀD)⁻¹ (Aᵀb + ρDᵀ(z − u))
    ẑ  = γ·Dx⁺ + (1 − γ)·z                       # over-relaxation
    z⁺ = soft_threshold(ẑ + u, α₁·w/ρ)           # per-row weights w
    u⁺ = u + ẑ − z⁺

Design (same rationale as solvers/admm.py):

- The x-update system matrix ``M = AᵀA + α₂I + ρDᵀD`` is fixed (ρ is kept
  constant — adaptive ρ would change M *non-uniformly* through the ρDᵀD
  term, forcing an O(n³) refactorization per rebalance), so one symmetric
  eigendecomposition ``M = VΛVᵀ`` up front turns every iteration into pure
  matmuls + a diagonal scale: no triangular solves, no pivoting,
  no data-dependent control flow.
- The loop is a ``lax.while_loop`` over an immutable state pytree — one XLA
  program per solve, `jax.vmap`-batchable over stacked (A, b, D) instances.
- Boyd §3.3 stopping on the z=Dx splitting: primal residual ``r = Dx − z``
  against ``√p·εabs + εrel·max(‖Dx‖, ‖z‖)`` and dual residual
  ``s = ρ·Dᵀ(z⁺ − z)`` against ``√n·εabs + εrel·‖ρDᵀu‖`` — plain on-device
  scalars, no host sync.

The reported solution is the quadratic-solve iterate ``x`` (feasibility
lives in z-space here, so unlike solvers/admm.py there is no "exactly
sparse x" to prefer); ``z`` carries the exactly-sparse transform ``≈ Dx``
(exact zeros → exactly-piecewise-constant TV segments when thresholded
through it).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from ..ops.prox import soft_threshold


@dataclasses.dataclass(frozen=True)
class GenLassoConfig:
    rho: float = 1.0
    max_iter: int = 2000
    abstol: float = 1e-7
    reltol: float = 1e-6
    over_relaxation: float = 1.6  # γ ∈ [1, 1.8]


class GenLassoState(NamedTuple):
    x: Array
    z: Array
    u: Array  # scaled dual
    k: Array
    r_norm: Array
    s_norm: Array
    converged: Array


class GenLassoResult(NamedTuple):
    x: Array  # primal solution
    z: Array  # ≈ Dx, exactly sparse where the penalty bites
    u: Array
    n_iters: Array
    r_norm: Array
    s_norm: Array
    converged: Array

    def objective(self, A, b, D, alpha1, alpha2=0.0, weights=None):
        """``½‖Ax−b‖² + ½α₂‖x‖² + α₁·Σᵢ wᵢ|(Dx)ᵢ|``. Pass the same
        ``weights`` used in the solve (e.g. :func:`fused_lasso` folds its two
        penalties into per-row weights with ``alpha1=1.0``) or the reported
        penalty term is wrong."""
        r = A @ self.x - b
        Dx = D @ self.x
        pen = jnp.abs(Dx) if weights is None else weights * jnp.abs(Dx)
        return (
            0.5 * r @ r
            + 0.5 * alpha2 * self.x @ self.x
            + alpha1 * jnp.sum(pen)
        )


def difference_matrix(n: int, order: int = 1, dtype=np.float32) -> np.ndarray:
    """k-th order discrete difference operator, shape ``(n − order, n)``.

    order=1 rows are ``x[i+1] − x[i]`` (TV / fused lasso); order=2 gives the
    second difference (ℓ1 trend filtering); higher orders iterate.
    """
    if not 0 < order < n:
        raise ValueError(f"need 0 < order < n, got order={order}, n={n}")
    D = np.eye(n, dtype=np.float64)
    for _ in range(order):
        D = D[1:] - D[:-1]
    return D.astype(dtype)


def gen_lasso(
    A,
    b,
    D,
    alpha1: float = 1.0,
    alpha2: float = 0.0,
    weights=None,
    config: GenLassoConfig = GenLassoConfig(),
    dtype=jnp.float32,
) -> GenLassoResult:
    """Solve ``min_x ½‖Ax − b‖² + ½α₂‖x‖² + α₁·Σᵢ wᵢ|(Dx)ᵢ|``.

    ``weights`` (optional, shape ``(p,)``) scales the penalty per row of D —
    this is how :func:`fused_lasso` folds two penalties into one D. The whole
    solve is one jitted XLA program; vmap over leading axes for batches.
    """
    A = jnp.asarray(A, dtype)
    b = jnp.asarray(b, dtype)
    D = jnp.asarray(D, dtype)
    w = (
        jnp.ones(D.shape[0], dtype)
        if weights is None
        else jnp.asarray(weights, dtype)
    )
    return _gen_lasso_jit(A, b, D, jnp.asarray(alpha1, dtype),
                          jnp.asarray(alpha2, dtype), w, config)


@functools.partial(jax.jit, static_argnames=("config",))
def _gen_lasso_jit(A, b, D, alpha1, alpha2, w, config: GenLassoConfig):
    n = A.shape[1]
    p = D.shape[0]
    dtype = A.dtype
    rho = jnp.asarray(config.rho, dtype)
    gamma = jnp.asarray(config.over_relaxation, dtype)

    Q = A.T @ A + alpha2 * jnp.eye(n, dtype=dtype)
    c = A.T @ b
    M = Q + rho * (D.T @ D)
    lam, V = jnp.linalg.eigh(M)  # once; iterations are matmuls only
    # M is singular when α₂=0 and null(AᵀA) ∩ null(DᵀD) ≠ {0} (e.g. a
    # rank-deficient A with a difference D that also annihilates the same
    # direction). Floor the spectrum so solve_M stays finite — the floored
    # components act as a tiny ridge on the unobservable subspace instead of
    # silently producing Inf/NaN iterates.
    lam = jnp.maximum(lam, jnp.asarray(1e-7, dtype) * jnp.maximum(lam[-1], 1.0))
    thresh = alpha1 * w / rho

    sqrt_p = jnp.sqrt(jnp.asarray(p, dtype))
    sqrt_n = jnp.sqrt(jnp.asarray(n, dtype))
    abstol = jnp.asarray(config.abstol, dtype)
    reltol = jnp.asarray(config.reltol, dtype)

    def solve_M(rhs):
        return V @ ((V.T @ rhs) / lam)

    def step(state: GenLassoState) -> GenLassoState:
        x = solve_M(c + rho * (D.T @ (state.z - state.u)))
        Dx = D @ x
        z_hat = gamma * Dx + (1.0 - gamma) * state.z
        z = soft_threshold(z_hat + state.u, thresh)
        u = state.u + z_hat - z

        r = Dx - z
        s = rho * (D.T @ (z - state.z))
        r_norm = jnp.linalg.norm(r)
        s_norm = jnp.linalg.norm(s)
        eps_pri = sqrt_p * abstol + reltol * jnp.maximum(
            jnp.linalg.norm(Dx), jnp.linalg.norm(z)
        )
        eps_dual = sqrt_n * abstol + reltol * rho * jnp.linalg.norm(D.T @ u)
        done = (r_norm <= eps_pri) & (s_norm <= eps_dual)
        return GenLassoState(x, z, u, state.k + 1, r_norm, s_norm, done)

    inf = jnp.asarray(jnp.inf, dtype)
    state0 = GenLassoState(
        x=jnp.zeros(n, dtype),
        z=jnp.zeros(p, dtype),
        u=jnp.zeros(p, dtype),
        k=jnp.zeros((), jnp.int32),
        r_norm=inf,
        s_norm=inf,
        converged=jnp.asarray(False),
    )
    final = jax.lax.while_loop(
        lambda s: (~s.converged) & (s.k < config.max_iter), step, state0
    )
    return GenLassoResult(
        x=final.x,
        z=final.z,
        u=final.u,
        n_iters=final.k,
        r_norm=final.r_norm,
        s_norm=final.s_norm,
        converged=final.converged,
    )


def fused_lasso(
    A,
    b,
    alpha_fuse: float,
    alpha_sparse: float = 0.0,
    config: GenLassoConfig = GenLassoConfig(),
    dtype=jnp.float32,
) -> GenLassoResult:
    """Fused lasso: ``½‖Ax − b‖² + α_fuse·Σ|xᵢ₊₁ − xᵢ| + α_sparse·‖x‖₁``.

    Both penalties ride one generalized-lasso solve by stacking
    ``D = [Δ₁; I]`` with per-row weights ``[α_fuse…, α_sparse…]``.
    """
    A = np.asarray(A)
    n = A.shape[1]
    Delta = difference_matrix(n, 1, dtype=np.float64)
    if alpha_sparse > 0.0:
        D = np.vstack([Delta, np.eye(n)])
        w = np.concatenate([np.full(n - 1, alpha_fuse), np.full(n, alpha_sparse)])
    else:
        D, w = Delta, np.full(n - 1, alpha_fuse)
    return gen_lasso(A, b, D, alpha1=1.0, weights=w, config=config, dtype=dtype)


def tv_denoise(
    y,
    lam: float,
    config: GenLassoConfig = GenLassoConfig(max_iter=5000),
    dtype=jnp.float32,
) -> GenLassoResult:
    """1D total-variation denoising: ``½‖x − y‖² + λ·Σ|xᵢ₊₁ − xᵢ|``."""
    y = np.asarray(y)
    n = y.shape[0]
    return gen_lasso(
        np.eye(n), y, difference_matrix(n, 1, np.float64),
        alpha1=lam, config=config, dtype=dtype,
    )


def trend_filter(
    y,
    lam: float,
    order: int = 2,
    config: GenLassoConfig = GenLassoConfig(max_iter=5000),
    dtype=jnp.float32,
) -> GenLassoResult:
    """ℓ1 trend filtering (Kim–Koh–Boyd–Gorinevsky): piecewise-polynomial
    fit of degree ``order − 1`` via ``½‖x − y‖² + λ‖Δ^order x‖₁``."""
    y = np.asarray(y)
    n = y.shape[0]
    return gen_lasso(
        np.eye(n), y, difference_matrix(n, order, np.float64),
        alpha1=lam, config=config, dtype=dtype,
    )
