"""Regularization paths: one problem, a ladder of α₁ values, one device call.

The classic lasso-path workload (the reference's benchmark sweeps
regularization *types* but not paths; this is the natural extension the
batched architecture gives for free): each α on the ladder becomes one
instance of a :class:`GramBatch` sharing the same Gram tensor, so the whole
path solves in a single certified batched call. For a batch of *problems* ×
a shared ladder, instances are the (problem, α) cross product.

``warm_start=True`` additionally runs a quick sequential pass: αs sorted
descending, each solve initialized from the previous solution (the textbook
homotopy schedule). The batched mode is usually faster on an accelerator
(everything in one call beats k dependent calls, each a dispatch and a sync); warm-start mode
exists for very long ladders / very tight tolerances.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import Array

from .fista_gram import (
    BatchFISTAConfig,
    BatchResult,
    GramBatch,
    fista_gram_batch,
    init_batch_state,
)


def alpha_ladder(alpha_max: float, n_alphas: int = 50, eps: float = 1e-3) -> Array:
    """Geometric ladder from α_max down to eps·α_max (sklearn's convention)."""
    return jnp.asarray(
        np.geomspace(alpha_max, alpha_max * eps, n_alphas), jnp.float32
    )


def alpha_max_for(c: Array) -> Array:
    """Smallest α₁ with an all-zero solution: ‖Aᵀb‖∞ (= ‖c‖∞ in Gram form)."""
    return jnp.max(jnp.abs(c), axis=0)


def path_gram_batch(Q: Array, c: Array, btb: Array, L: Array, alphas: Array,
                    alpha2: float = 0.0) -> GramBatch:
    """Cross a single Gram-form problem with an α ladder: (n, n) Q →
    (n, n, K) batch sharing the data, one lane per α."""
    K = alphas.shape[0]
    tile = lambda x: jnp.broadcast_to(x[..., None], x.shape + (K,))
    return GramBatch(
        Q=tile(Q),
        c=tile(c),
        btb=jnp.broadcast_to(btb, (K,)),
        alpha1=alphas.astype(Q.dtype),
        alpha2=jnp.full((K,), alpha2, Q.dtype),
        L=jnp.broadcast_to(L + alpha2, (K,)),
    )


def lasso_path(
    problem,
    alphas: Array | None = None,
    n_alphas: int = 50,
    eps: float = 1e-3,
    cfg: BatchFISTAConfig = BatchFISTAConfig(max_iter=2000, check_every=25),
    warm_start: bool = False,
) -> tuple[Array, BatchResult]:
    """Solve the L1 path of a (dense or Gram form) least-squares problem.

    Returns ``(alphas, BatchResult)`` with ``result.x`` of shape
    (n_alphas, n) ordered from α_max down.
    """
    gram = problem if hasattr(problem, "Q") else problem.to_gram()
    from ..ops.lipschitz import estimate_lipschitz_gram

    L = estimate_lipschitz_gram(gram.Q)
    if alphas is None:
        amax = jnp.max(jnp.abs(gram.c))
        alphas = alpha_ladder(float(amax), n_alphas, eps)
    alphas = jnp.sort(jnp.asarray(alphas))[::-1]  # descending, homotopy order
    gb = path_gram_batch(gram.Q, gram.c, gram.btb, L, alphas, float(gram.alpha2))

    if not warm_start:
        return alphas, fista_gram_batch(gb, cfg)

    # sequential homotopy: each α warm-started from the previous solution
    n, K = gb.c.shape
    state = init_batch_state(gb)
    X = jnp.zeros((n, K), gb.c.dtype)
    xs, gaps, iters, conv = [], [], [], []
    x_prev = jnp.zeros((n,), gb.c.dtype)
    one_cfg = cfg
    for k in range(K):
        sub = GramBatch(
            Q=gb.Q[:, :, k : k + 1],
            c=gb.c[:, k : k + 1],
            btb=gb.btb[k : k + 1],
            alpha1=gb.alpha1[k : k + 1],
            alpha2=gb.alpha2[k : k + 1],
            L=gb.L[k : k + 1],
        )
        st = init_batch_state(sub)._replace(
            X=x_prev[:, None], Y=x_prev[:, None]
        )
        res = fista_gram_batch(sub, one_cfg, state0=st)
        x_prev = res.x[0]
        xs.append(res.x[0])
        gaps.append(res.rel_gap[0])
        iters.append(res.iters[0])
        conv.append(res.converged[0])
    result = BatchResult(
        x=jnp.stack(xs),
        iters=jnp.stack(iters),
        rel_gap=jnp.stack(gaps),
        n_iters_total=jnp.sum(jnp.stack(iters)),
        converged=jnp.stack(conv),
        failed=None,
    )
    return alphas, result
