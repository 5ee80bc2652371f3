"""Synthetic problem generators.

Two tiers:

1. :func:`generate_boston_like` — host-side NumPy generator reproducing the
   reference's scenario data *bitwise* (same ``np.random.default_rng(seed)``
   draw sequence as ``/root/reference/easy_boston_data.py:7-45``): two
   correlated feature blocks (rooms/crime at ρ₁, tax/age at ρ₂), an
   independent distance feature, ``x_true = [5.0, 0.0, −0.02, −0.05, 1.5]``,
   Gaussian response noise. Used for parity tests and the 80-scenario sweep.

2. :func:`generate_scenario_batch` — pure-JAX, key-driven, fully on-device
   batch generator: builds B instances at once (B×m×n design tensors) for the
   vmapped/sharded solve paths. Statistically matches tier 1 but uses JAX's
   threefry streams, so it is reproducible across hosts/devices — the
   "data loader" of this framework.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import Array

# True coefficients shared by both generators (easy_boston_data.py:40).
X_TRUE = (5.0, 0.0, -0.02, -0.05, 1.5)

# Feature-block parameters (easy_boston_data.py:26-34).
BLOCK1_MEAN = (6.0, 0.2)       # rooms, crime
BLOCK1_SCALE = 0.25
BLOCK2_MEAN = (300.0, 60.0)    # tax, age
BLOCK2_SCALE = 100.0
DIST_MEAN, DIST_STD = 4.0, 1.0  # independent distance feature

# The reference benchmark's scenario grid (SURVEY.md §3.5, figures/ filenames).
SCENARIO_SEEDS = (0, 1, 2, 3, 4)
SCENARIO_NOISE = (0.5, 1.0, 2.0, 5.0)
SCENARIO_RHO1 = (0.5, 0.8)
SCENARIO_RHO2 = (0.7, 0.9)


def scenario_grid():
    """All 80 (seed, noise_std, rho1, rho2) combinations of the reference sweep."""
    return [
        (s, n, r1, r2)
        for s in SCENARIO_SEEDS
        for n in SCENARIO_NOISE
        for r1 in SCENARIO_RHO1
        for r2 in SCENARIO_RHO2
    ]


def generate_boston_like(
    m: int = 1000,
    seed: int = 42,
    noise_std: float = 2.0,
    rho1: float = 0.8,
    rho2: float = 0.9,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Bitwise-parity NumPy generator (same RNG draw order as the reference).

    Returns ``(A, b, x_true)`` with ``A`` of shape (m, 5).
    """
    rng = np.random.default_rng(seed)
    cov1 = np.array([[1.0, rho1], [rho1, 1.0]]) * BLOCK1_SCALE
    block1 = rng.multivariate_normal(list(BLOCK1_MEAN), cov1, size=m)
    cov2 = np.array([[1.0, rho2], [rho2, 1.0]]) * BLOCK2_SCALE
    block2 = rng.multivariate_normal(list(BLOCK2_MEAN), cov2, size=m)
    distance = rng.normal(DIST_MEAN, DIST_STD, size=(m, 1))
    A = np.hstack([block1, block2, distance])
    x_true = np.array(X_TRUE)
    b = A @ x_true + rng.normal(0, noise_std, size=m)
    return A, b, x_true


def _corr_block(key: Array, mean, rho: Array, scale: float, m: int, dtype) -> Array:
    """Sample an (m, 2) correlated Gaussian block via the 2×2 Cholesky factor
    of ``scale * [[1, ρ], [ρ, 1]]`` — closed form, no linalg call."""
    z = jax.random.normal(key, (m, 2), dtype=dtype)
    s = jnp.sqrt(jnp.asarray(scale, dtype))
    rho = jnp.asarray(rho, dtype)
    # Cholesky of [[1, ρ], [ρ, 1]] = [[1, 0], [ρ, sqrt(1-ρ²)]]
    c0 = z[:, 0]
    c1 = rho * z[:, 0] + jnp.sqrt(1.0 - rho * rho) * z[:, 1]
    mean = jnp.asarray(mean, dtype)
    return jnp.stack([c0, c1], axis=-1) * s + mean


def generate_scenario(
    key: Array,
    m: int = 1000,
    noise_std=2.0,
    rho1=0.8,
    rho2=0.9,
    dtype=jnp.float32,
) -> tuple[Array, Array, Array]:
    """Pure-JAX single-scenario generator. jit/vmap-friendly: ``noise_std``,
    ``rho1``, ``rho2`` may be traced scalars (vmap over them to build
    hyperparameter sweeps on device)."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    block1 = _corr_block(k1, BLOCK1_MEAN, rho1, BLOCK1_SCALE, m, dtype)
    block2 = _corr_block(k2, BLOCK2_MEAN, rho2, BLOCK2_SCALE, m, dtype)
    distance = DIST_MEAN + DIST_STD * jax.random.normal(k3, (m, 1), dtype=dtype)
    A = jnp.concatenate([block1, block2, distance], axis=-1)
    x_true = jnp.asarray(X_TRUE, dtype)
    noise = jnp.asarray(noise_std, dtype) * jax.random.normal(k4, (m,), dtype=dtype)
    b = A @ x_true + noise
    return A, b, x_true


def generate_scenario_batch(
    key: Array,
    batch: int,
    m: int = 1000,
    noise_std=2.0,
    rho1=0.8,
    rho2=0.9,
    dtype=jnp.float32,
) -> tuple[Array, Array, Array]:
    """Generate ``batch`` independent instances on device in one compiled call.

    Scalar hyperparameters may be scalars (shared) or (batch,)-arrays (per
    instance). Returns ``(A, b, x_true)`` with shapes (batch, m, 5),
    (batch, m), (5,).

    Sampled directly in batched form (four big normal draws + closed-form
    2×2 Cholesky mixing) rather than vmapping the single-scenario generator —
    a ``batch``-way vmap of per-instance key splits compiled for ~30 s at
    batch=16k; this path is milliseconds.
    """
    k1, k2, k3, k4 = jax.random.split(key, 4)
    bc = lambda v: jnp.broadcast_to(jnp.asarray(v, dtype), (batch,))[:, None]

    def block(k, mean, rho, scale):
        z = jax.random.normal(k, (batch, m, 2), dtype)
        rho = bc(rho)
        c0 = z[..., 0]
        c1 = rho * z[..., 0] + jnp.sqrt(1.0 - rho * rho) * z[..., 1]
        s = jnp.sqrt(jnp.asarray(scale, dtype))
        return jnp.stack([c0, c1], axis=-1) * s + jnp.asarray(mean, dtype)

    block1 = block(k1, BLOCK1_MEAN, rho1, BLOCK1_SCALE)
    block2 = block(k2, BLOCK2_MEAN, rho2, BLOCK2_SCALE)
    distance = DIST_MEAN + DIST_STD * jax.random.normal(k3, (batch, m, 1), dtype)
    A = jnp.concatenate([block1, block2, distance], axis=-1)
    x_true = jnp.asarray(X_TRUE, dtype)
    noise = bc(noise_std) * jax.random.normal(k4, (batch, m), dtype)
    b = A @ x_true + noise
    return A, b, x_true


def generate_scenario_batch_fm(
    key: Array,
    batch: int,
    m: int = 1000,
    noise_std=2.0,
    rho1=0.8,
    rho2=0.9,
    dtype=jnp.float32,
) -> tuple[Array, Array, Array]:
    """Feature-leading variant of :func:`generate_scenario_batch`: returns
    ``(A, b, x_true)`` with ``A`` of shape (5, m, batch) and ``b`` (m, batch)
    — the framework's feature-major layout (batch/fista_gram.py), written
    directly at generation time.

    Same distribution as the batch-major generator (and the reference's
    easy_boston_data.py:23-45 recipe); the draw ORDER differs, so per-seed
    values don't match generate_scenario_batch bitwise — distributional
    parity only.
    """
    k1, k2, k3, k4 = jax.random.split(key, 4)
    bc = lambda v: jnp.broadcast_to(jnp.asarray(v, dtype), (batch,))[None, :]

    def block(k, mean, rho, scale):
        z = jax.random.normal(k, (2, m, batch), dtype)
        rho = bc(rho)  # (1, batch), broadcasts over (m, batch)
        c0 = z[0]
        c1 = rho * z[0] + jnp.sqrt(1.0 - rho * rho) * z[1]
        s = jnp.sqrt(jnp.asarray(scale, dtype))
        mean = jnp.asarray(mean, dtype)
        return jnp.stack([c0, c1]) * s + mean[:, None, None]

    block1 = block(k1, BLOCK1_MEAN, rho1, BLOCK1_SCALE)
    block2 = block(k2, BLOCK2_MEAN, rho2, BLOCK2_SCALE)
    distance = DIST_MEAN + DIST_STD * jax.random.normal(k3, (1, m, batch), dtype)
    A = jnp.concatenate([block1, block2, distance], axis=0)  # (5, m, batch)
    x_true = jnp.asarray(X_TRUE, dtype)
    noise = bc(noise_std) * jax.random.normal(k4, (m, batch), dtype)
    b = jnp.einsum("nmb,n->mb", A, x_true) + noise
    return A, b, x_true
