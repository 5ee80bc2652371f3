"""K-fold cross-validated lasso — the whole CV grid in ONE device call.

Model selection is the missing top of the reference's workflow: its notebook
sweeps scenarios and plots convergence (SURVEY.md §3.5) but never selects a
regularization strength. Here the full (folds × α-ladder) grid — plus the
full-data refit path — solves as a single certified batched FISTA call
(batch/fista_gram.py), so cross-validating 5 folds × 50 αs costs one device
program, not 250 solver runs.

Design:

- **Gram subtraction**: each fold's *training* Gram is
  ``Q_train_j = AᵀA − A_jᵀA_j`` (and likewise for ``c``, ``bᵀb``) — one full
  Gram plus one batched fold-Gram einsum, instead of k rebuilds over
  (k−1)/k of the rows. O(mn²) total work independent of k.
- Folds follow sklearn's KFold: contiguous blocks with the m mod k remainder
  spread one row each across the first folds. Ragged folds are handled by a
  padded gather against a sentinel zero row (zero rows contribute nothing to
  fold Grams or validation sums), so the solve stays static-shaped.
- **Per-fold penalty scaling**: sklearn's objective is per-sample
  (``1/(2·m)``), so a fold fit over m−|fold j| training rows must carry
  ``(m−|fold j|)/m`` of the full-data internal penalty. Fold instances'
  (α₁, α₂) are scaled accordingly; the full-data refit keeps full scale.
- The (k+1)·K instances (k fold-train problems + 1 full-data problem, each
  crossed with the α ladder) ride the feature-major ``GramBatch`` layout, so
  the best-α refit and the full coefficient path come out of the same call.
- Validation MSE is two einsums; α selection is an argmin on device. The
  optional "one-standard-error rule" picks the sparsest α within one SE of
  the minimum (the classic Hastie/Tibshirani recommendation).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import Array

from ..ops.lipschitz import estimate_lipschitz_gram
from .fista_gram import BatchFISTAConfig, GramBatch, fista_gram_batch


class CVResult(NamedTuple):
    alphas: Array  # (K,) descending
    mse_path: Array  # (k_folds, K) per-fold validation MSE
    mse_mean: Array  # (K,)
    mse_se: Array  # (K,) standard error across folds
    best_alpha: Array  # argmin of mse_mean (or 1-SE rule)
    best_idx: Array
    coef: Array  # (n,) full-data solution at best_alpha
    coef_path: Array  # (K, n) full-data path
    coef_folds: Array  # (k_folds, K, n) per-fold training solutions
    converged: Array  # bool: every instance certified
    intercept: Array  # scalar (0 unless fit_intercept)
    rel_gap: Array  # (k_folds+1, K) per-instance certified relative gap
    converged_grid: Array  # (k_folds+1, K) per-instance certification
    iters: Array  # (k_folds+1, K) per-instance iteration counts


def _ladder(amax: Array, n_alphas: int, eps: float, dtype) -> Array:
    """Geometric ladder α_max → eps·α_max, computed on device (jit-safe)."""
    t = jnp.arange(n_alphas, dtype=dtype) / max(n_alphas - 1, 1)
    return amax * (eps**t)


@functools.partial(
    jax.jit,
    static_argnames=("k_folds", "n_alphas", "cfg", "one_se_rule", "l1_ratio"),
)
def _cv_core(
    A: Array,
    b: Array,
    alphas_in,
    k_folds: int,
    n_alphas: int,
    eps: float,
    alpha2,
    cfg: BatchFISTAConfig,
    one_se_rule: bool,
    l1_ratio: float = 1.0,
) -> CVResult:
    m, n = A.shape
    dtype = A.dtype

    # sklearn KFold semantics: contiguous folds, remainder rows spread one
    # each across the first (m % k) folds. Ragged sizes are static (m,
    # k_folds are shape-level constants), handled by a padded gather against
    # a sentinel zero row at index m.
    f_lo, r = divmod(m, k_folds)
    f_hi = f_lo + (1 if r else 0)
    sizes = jnp.asarray(
        [f_lo + (1 if j < r else 0) for j in range(k_folds)], jnp.int32
    )
    starts = jnp.concatenate([jnp.zeros((1,), jnp.int32), jnp.cumsum(sizes)])[
        :k_folds
    ]
    pos = jnp.arange(f_hi, dtype=jnp.int32)
    valid = pos[None, :] < sizes[:, None]  # (k, f_hi)
    idx = jnp.where(valid, starts[:, None] + pos[None, :], m)
    A_pad = jnp.concatenate([A, jnp.zeros((1, n), dtype)], axis=0)
    b_pad = jnp.concatenate([b, jnp.zeros((1,), dtype)])
    A_folds = A_pad[idx]  # (k, f_hi, n) — sentinel rows are all-zero
    b_folds = b_pad[idx]  # (k, f_hi)

    # Full-data Gram and per-fold Grams, once each.
    Q_full = A.T @ A
    c_full = A.T @ b
    btb_full = b @ b
    Qf = jnp.einsum("kfi,kfj->kij", A_folds, A_folds)
    cf = jnp.einsum("kfi,kf->ki", A_folds, b_folds)
    btbf = jnp.einsum("kf,kf->k", b_folds, b_folds)

    # Gram subtraction: training set of fold j = everything except fold j.
    Q_train = Q_full[None] - Qf  # (k, n, n)
    c_train = c_full[None] - cf  # (k, n)
    btb_train = btb_full - btbf  # (k,)

    if alphas_in is None:
        amax = jnp.max(jnp.abs(c_full))
        alphas = _ladder(amax, n_alphas, eps, dtype)
    else:
        alphas = jnp.sort(jnp.asarray(alphas_in, dtype))[::-1]
    K = alphas.shape[0]

    # Stack the k fold-train problems + the full-data problem; cross with αs.
    Q_all = jnp.concatenate([Q_train, Q_full[None]], axis=0)  # (k+1, n, n)
    c_all = jnp.concatenate([c_train, c_full[None]], axis=0)
    btb_all = jnp.concatenate([btb_train, btb_full[None]], axis=0)
    L_all = jax.vmap(estimate_lipschitz_gram)(Q_all)

    B = (k_folds + 1) * K
    # Elastic-net ladders tie α₂ to the L1 ladder through l1_ratio (sklearn's
    # ElasticNetCV semantics: α₁ = α·l1_ratio, α₂ = α·(1−l1_ratio), both
    # scaled by the same ladder); α₂ then varies per instance, which the
    # per-instance GramBatch fields carry for free.
    #
    # Per-fold penalty scaling (sklearn parity): `alphas`/`alpha2` arrive at
    # full-data internal scale (m × per-sample α). sklearn's per-sample
    # objective means fold j's fit over its m − |fold j| training rows must
    # use (m − |fold j|)/m of that — otherwise fold models are over-penalized
    # by k/(k−1) and mse_path_ drifts from sklearn's.
    train_frac = jnp.concatenate(
        [(m - sizes).astype(dtype) / m, jnp.ones((1,), dtype)]
    )  # (k+1,): fold-train fractions, then 1.0 for the full-data refit
    scale_rep = jnp.repeat(train_frac, K)  # (B,) — group-major, matches Q_all
    a1_grid = jnp.tile(alphas, k_folds + 1) * scale_rep
    ratio = (1.0 - l1_ratio) / l1_ratio
    a2_grid = (
        jnp.asarray(alpha2, dtype) * scale_rep
        + a1_grid * jnp.asarray(ratio, dtype)
    )
    gb = GramBatch(
        Q=jnp.repeat(Q_all, K, axis=0).transpose(1, 2, 0),  # (n, n, B)
        c=jnp.repeat(c_all, K, axis=0).T,  # (n, B)
        btb=jnp.repeat(btb_all, K),
        alpha1=a1_grid,
        alpha2=a2_grid,
        L=jnp.repeat(L_all, K) + a2_grid,
    )
    res = fista_gram_batch(gb, cfg)

    X = res.x.reshape(k_folds + 1, K, n)
    X_folds, X_full = X[:k_folds], X[k_folds]

    # Validation: fold j's models predict fold j's held-out rows. Sentinel
    # rows contribute zero residual but must not enter the denominator.
    preds = jnp.einsum("kfi,kKi->kKf", A_folds, X_folds)
    sq = (preds - b_folds[:, None, :]) ** 2 * valid[:, None, :].astype(dtype)
    mse_path = jnp.sum(sq, axis=-1) / sizes.astype(dtype)[:, None]  # (k, K)
    mse_mean = jnp.mean(mse_path, axis=0)
    mse_se = jnp.std(mse_path, axis=0, ddof=1) / jnp.sqrt(
        jnp.asarray(k_folds, dtype)
    )

    i_min = jnp.argmin(mse_mean)
    if one_se_rule:
        # Largest α (most regularization → sparsest model) whose mean MSE is
        # within one standard error of the minimum. αs are descending, so
        # that's the smallest qualifying index.
        ok = mse_mean <= mse_mean[i_min] + mse_se[i_min]
        best_idx = jnp.argmax(ok)  # first True
    else:
        best_idx = i_min

    return CVResult(
        alphas=alphas,
        mse_path=mse_path,
        mse_mean=mse_mean,
        mse_se=mse_se,
        best_alpha=alphas[best_idx],
        best_idx=best_idx,
        coef=X_full[best_idx],
        coef_path=X_full,
        coef_folds=X_folds,
        converged=jnp.all(res.converged),
        intercept=jnp.zeros((), dtype),
        rel_gap=res.rel_gap.reshape(k_folds + 1, K),
        converged_grid=res.converged.reshape(k_folds + 1, K),
        iters=res.iters.reshape(k_folds + 1, K),
    )


def cv_lasso(
    A,
    b,
    k_folds: int = 5,
    alphas=None,
    n_alphas: int = 50,
    eps: float = 1e-3,
    alpha2: float = 0.0,
    key: Array | None = None,
    cfg: BatchFISTAConfig = BatchFISTAConfig(max_iter=2000, check_every=25),
    one_se_rule: bool = False,
    fit_intercept: bool = False,
    dtype=jnp.float32,
    l1_ratio: float = 1.0,
) -> CVResult:
    """Cross-validated lasso (elastic-net with ``alpha2 > 0`` for a fixed
    extra ridge, or ``l1_ratio < 1`` for a ladder-tied elastic-net grid —
    ``alphas`` then ladder the L1 strength α₁ and each instance carries
    α₂ = α₁·(1−l1_ratio)/l1_ratio on top of ``alpha2``).

    ``key`` shuffles rows before folding (recommended for ordered data);
    folds are contiguous row blocks after the shuffle. ``one_se_rule=True``
    applies the one-standard-error selection. ``fit_intercept=True`` centers
    ``A``'s columns and ``b`` first (the standard unpenalized-intercept
    treatment) and reports the intercept for the refit coefficients.
    One compiled program per (shape, config); re-calls with fresh data are
    dispatch-only.
    """
    A = jnp.asarray(A, dtype)
    b = jnp.asarray(b, dtype)
    if key is not None:
        perm = jax.random.permutation(key, A.shape[0])
        A, b = A[perm], b[perm]
    mu_A = mu_b = None
    if fit_intercept:
        mu_A = A.mean(axis=0)
        mu_b = b.mean()
        A = A - mu_A
        b = b - mu_b
    if alphas is not None:
        n_alphas = len(alphas)
    if not 0.0 < l1_ratio <= 1.0:
        raise ValueError(f"l1_ratio must be in (0, 1], got {l1_ratio}")
    res = _cv_core(
        A, b, alphas, k_folds, n_alphas, eps, alpha2, cfg, one_se_rule,
        l1_ratio=float(l1_ratio),
    )
    if fit_intercept:
        res = res._replace(intercept=mu_b - mu_A @ res.coef)
    return res
