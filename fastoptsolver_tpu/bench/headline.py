"""The headline deployment: many small lasso regressions solved at once.

One definition shared by bench.py and chip_smoke.py, so both measure the
same problems: B = 262,144 Boston-like instances (the reference's
easy_boston_data.py recipe, 5 features) of m = 1000 rows each, generated on
the device in the feature-major layout ``A (n, m, B), b (m, B)``, with
standardized columns and α₁ = 0.1·‖Aᵀb‖∞ per instance, certified to a
1e-6 relative duality gap.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..batch.fista_gram import BatchFISTAConfig
from ..problems import generate_scenario_batch_fm

BATCH = 262144
M = 1000
CFG = BatchFISTAConfig(max_iter=1000, check_every=25, rel_gap_tol=1e-6)


@functools.partial(jax.jit, static_argnames=("batch", "m"))
def build_problems(key, batch: int, m: int):
    """``(A (5, m, batch), b (m, batch), alpha1 (batch,))``: per-instance
    noise and correlations spanning the reference's scenario grid. One
    compiled program, so generation never runs op by op."""
    knoise, kr1, kr2, kgen = jax.random.split(key, 4)
    noise = jax.random.choice(knoise, jnp.asarray([0.5, 1.0, 2.0, 5.0]), (batch,))
    rho1 = jax.random.choice(kr1, jnp.asarray([0.5, 0.8]), (batch,))
    rho2 = jax.random.choice(kr2, jnp.asarray([0.7, 0.9]), (batch,))
    A, b, _ = generate_scenario_batch_fm(
        kgen, batch, m=m, noise_std=noise, rho1=rho1, rho2=rho2, dtype=jnp.float32
    )
    # standardize features per instance (benchmark-standard lasso setup)
    mu = A.mean(axis=1, keepdims=True)
    sd = A.std(axis=1, keepdims=True)
    A = (A - mu) / sd
    alpha1 = 0.1 * jnp.max(jnp.abs(jnp.einsum("nmb,mb->nb", A, b)), axis=0)
    return A, b, alpha1
