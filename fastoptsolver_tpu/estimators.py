"""sklearn-style estimator façade: fit / predict / score over the solver stack.

The reference exposes one sklearn-ish class (``LBFGSSolver`` with ``fit`` —
/root/reference/lbfgs.py:7-73, mirrored in compat.py). This module rounds
that out into the estimator surface a scikit-learn user expects when
switching over: ``Lasso``, ``ElasticNet``, ``Ridge`` and the cross-validated
``LassoCV``, all running on the framework's jitted solvers (and, for CV, the
one-device-call grid of batch/cv.py).

Conventions follow scikit-learn, with the mapping documented here once:
sklearn minimizes ``1/(2·n_samples)·‖y − Xw‖² + α·l1_ratio·‖w‖₁ +
½·α·(1−l1_ratio)·‖w‖²``; this framework minimizes ``½‖Ax−b‖² + α₁‖x‖₁ +
½·α₂‖x‖²``. So ``α₁ = n_samples·α·l1_ratio`` and
``α₂ = n_samples·α·(1−l1_ratio)``. Intercepts are handled the standard way
(center X's columns and y, never penalize the intercept).
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .api import solve
from .batch.cv import cv_lasso
from .batch.fista_gram import BatchFISTAConfig


class _BaseRegressor:
    """Shared fit/predict/score plumbing (NumPy in, NumPy out)."""

    def __init__(self, alpha=1.0, l1_ratio=1.0, fit_intercept=True,
                 max_iter=2000, tol=0.0, method="fista", dtype=jnp.float32,
                 positive=False, warm_start=False):
        self.alpha = float(alpha)
        self.l1_ratio = float(l1_ratio)
        self.fit_intercept = bool(fit_intercept)
        self.max_iter = int(max_iter)
        self.tol = float(tol)
        self.method = method
        self.dtype = dtype
        self.positive = bool(positive)
        self.warm_start = bool(warm_start)

    def _reg(self, n_samples: int) -> tuple[str, float, float]:
        a1 = n_samples * self.alpha * self.l1_ratio
        a2 = n_samples * self.alpha * (1.0 - self.l1_ratio)
        if a1 == 0.0:
            return "ridge", 0.0, a2
        if a2 == 0.0:
            return "lasso", a1, 0.0
        return "elasticnet", a1, a2

    def fit(self, X, y, sample_weight=None):
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        if sample_weight is not None:
            # sklearn semantics: weights are rescaled to sum to n_samples;
            # centering uses the weighted means; the solve runs on rows
            # scaled by √wᵢ (exactly the weighted least-squares objective —
            # the explicit-weights problem type, problems/extensions.py
            # WeightedLeastSquares, is the same math kept unscaled).
            w = np.asarray(sample_weight, np.float64)
            if w.shape != (X.shape[0],):
                raise ValueError(
                    f"sample_weight has shape {w.shape}, expected ({X.shape[0]},)"
                )
            if np.any(w < 0):
                raise ValueError("sample_weight must be nonnegative")
            w = w * (X.shape[0] / w.sum())
        else:
            w = None
        if self.fit_intercept:
            if w is None:
                self._x_mean = X.mean(axis=0)
                self._y_mean = y.mean()
            else:
                self._x_mean = np.average(X, axis=0, weights=w)
                self._y_mean = float(np.average(y, weights=w))
            Xc, yc = X - self._x_mean, y - self._y_mean
        else:
            self._x_mean = np.zeros(X.shape[1])
            self._y_mean = 0.0
            Xc, yc = X, y
        if w is not None:
            sw = np.sqrt(w)
            Xc = Xc * sw[:, None]
            yc = yc * sw
        reg, a1, a2 = self._reg(X.shape[0])
        if self.positive:
            # sklearn's positive=True: coefficients constrained ≥ 0. The
            # constraint is just another problem type — the positively-
            # constrained elastic net runs on the unchanged FISTA. Other
            # methods cannot honor the constraint; reject rather than
            # silently switching algorithms under the user.
            if self.method not in ("fista", "ista"):
                raise ValueError(
                    f"positive=True requires a proximal method (fista/ista); "
                    f"got method={self.method!r}"
                )
            from .problems import NonNegativeLeastSquares
            from .solvers import FISTAConfig, ISTAConfig, fista, ista

            prob = NonNegativeLeastSquares.create(
                Xc, yc, alpha1=a1, alpha2=a2, dtype=self.dtype
            )
            x0 = (
                jnp.asarray(np.maximum(self.coef_, 0.0), self.dtype)
                if self.warm_start and hasattr(self, "coef_")
                else None
            )
            if self.method == "ista":
                res = ista(prob, ISTAConfig(max_iter=self.max_iter, tol=self.tol),
                           x0=x0)
            else:
                res = fista(prob, FISTAConfig(max_iter=self.max_iter, tol=self.tol),
                            x0=x0)
        else:
            kwargs = dict(max_iter=self.max_iter)
            if self.method in ("fista", "ista", "lbfgs", "owlqn"):
                kwargs["tol"] = self.tol
            # sklearn warm_start semantics: reuse the previous fit's
            # coefficients as the starting point (the solvers all accept x0)
            x0 = (
                jnp.asarray(self.coef_, self.dtype)
                if self.warm_start and hasattr(self, "coef_")
                else None
            )
            res = solve(Xc, yc, reg, alpha1=a1, alpha2=a2, method=self.method,
                        dtype=self.dtype, x0=x0, **kwargs)
        self.coef_ = np.asarray(res.x, np.float64)
        self.intercept_ = float(self._y_mean - self._x_mean @ self.coef_)
        self.n_iter_ = int(res.n_iters)
        return self

    def predict(self, X):
        return np.asarray(X, np.float64) @ self.coef_ + self.intercept_

    def score(self, X, y):
        """R² (coefficient of determination), sklearn semantics."""
        y = np.asarray(y, np.float64)
        r = y - self.predict(X)
        ss_res = float(r @ r)
        d = y - y.mean()
        ss_tot = float(d @ d)
        return 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0


class Lasso(_BaseRegressor):
    """L1-regularized least squares (sklearn.linear_model.Lasso-compatible
    hyperparameter semantics)."""

    def __init__(self, alpha=1.0, fit_intercept=True, max_iter=2000, tol=0.0,
                 method="fista", dtype=jnp.float32, positive=False,
                 warm_start=False):
        super().__init__(alpha=alpha, l1_ratio=1.0, fit_intercept=fit_intercept,
                         max_iter=max_iter, tol=tol, method=method, dtype=dtype,
                         positive=positive, warm_start=warm_start)


class ElasticNet(_BaseRegressor):
    """Elastic-net (sklearn alpha/l1_ratio semantics)."""

    def __init__(self, alpha=1.0, l1_ratio=0.5, fit_intercept=True,
                 max_iter=2000, tol=0.0, method="fista", dtype=jnp.float32,
                 positive=False, warm_start=False):
        super().__init__(alpha=alpha, l1_ratio=l1_ratio,
                         fit_intercept=fit_intercept, max_iter=max_iter,
                         tol=tol, method=method, dtype=dtype,
                         positive=positive, warm_start=warm_start)


class Ridge(_BaseRegressor):
    """L2-regularized least squares. Note sklearn's Ridge does NOT scale α by
    n_samples — matched here (α₂ = α directly)."""

    def __init__(self, alpha=1.0, fit_intercept=True, max_iter=500,
                 tol=1e-9, method="lbfgs", dtype=jnp.float32):
        super().__init__(alpha=alpha, l1_ratio=0.0, fit_intercept=fit_intercept,
                         max_iter=max_iter, tol=tol, method=method, dtype=dtype)

    def _reg(self, n_samples):
        return "ridge", 0.0, self.alpha


class MultiTaskLasso:
    """Joint-sparsity multi-task lasso (sklearn.linear_model.MultiTaskLasso
    semantics): minimizes ``1/(2·n_samples)·‖Y − XW‖_F² + α·Σ_j ‖W_{j,:}‖₂``
    over W ∈ R^{n_features × n_tasks}; all tasks share one support. Runs the
    matrix-iterate FISTA on problems/extensions.py:MultiTaskLeastSquares
    (internal α₁ = n_samples·α). ``coef_`` follows sklearn's
    (n_tasks, n_features) orientation; ``intercept_`` is (n_tasks,)."""

    def __init__(self, alpha=1.0, fit_intercept=True, max_iter=2000,
                 tol=0.0, dtype=jnp.float32):
        self.alpha = float(alpha)
        self.fit_intercept = bool(fit_intercept)
        self.max_iter = int(max_iter)
        self.tol = float(tol)
        self.dtype = dtype

    def fit(self, X, Y):
        from .problems import MultiTaskLeastSquares
        from .solvers import FISTAConfig, fista

        X = np.asarray(X, np.float64)
        Y = np.asarray(Y, np.float64)
        if self.fit_intercept:
            self._x_mean = X.mean(axis=0)
            self._y_mean = Y.mean(axis=0)
            Xc, Yc = X - self._x_mean, Y - self._y_mean
        else:
            self._x_mean = np.zeros(X.shape[1])
            self._y_mean = np.zeros(Y.shape[1])
            Xc, Yc = X, Y
        problem = MultiTaskLeastSquares.create(
            Xc, Yc, alpha1=X.shape[0] * self.alpha, dtype=self.dtype
        )
        res = fista(
            problem,
            FISTAConfig(max_iter=self.max_iter, tol=self.tol),
            key=jax.random.PRNGKey(0),
        )
        W = np.asarray(res.x, np.float64)            # (n_features, n_tasks)
        self.coef_ = W.T                             # sklearn orientation
        self.intercept_ = self._y_mean - self._x_mean @ W
        self.n_iter_ = int(res.n_iters)
        return self

    def predict(self, X):
        return np.asarray(X, np.float64) @ self.coef_.T + self.intercept_

    def score(self, X, Y):
        """Mean R² across tasks (sklearn's multioutput='uniform_average')."""
        Y = np.asarray(Y, np.float64)
        R = Y - self.predict(X)
        ss_res = np.sum(R * R, axis=0)
        D = Y - Y.mean(axis=0)
        ss_tot = np.sum(D * D, axis=0)
        return float(np.mean(1.0 - ss_res / np.where(ss_tot > 0, ss_tot, 1.0)))


class ElasticNetCV(_BaseRegressor):
    """K-fold cross-validated elastic-net
    (sklearn.linear_model.ElasticNetCV semantics): the α ladder carries both
    penalties (α₁ = m·α·l1_ratio, α₂ = m·α·(1−l1_ratio)) and, per l1_ratio,
    the whole (folds × ladder) grid plus the refit path solves as ONE device
    call. ``l1_ratio`` may be a float or a list — with a list the best
    (l1_ratio, α) pair is chosen by mean validation MSE, sklearn-style.
    After ``fit``: ``alpha_``, ``l1_ratio_``, ``alphas_``, ``mse_path_``
    ((n_alphas, cv), or (n_l1_ratio, n_alphas, cv) for a ratio list),
    ``coef_``, ``intercept_``, ``coef_path_``, ``n_iter_``."""

    def __init__(self, l1_ratio=0.5, alphas=None, n_alphas=100, eps=1e-3,
                 cv=5, fit_intercept=True, max_iter=2000, one_se_rule=False,
                 shuffle_seed=0, dtype=jnp.float32):
        ratios = (
            [float(r) for r in l1_ratio]
            if isinstance(l1_ratio, (list, tuple, np.ndarray))
            else [float(l1_ratio)]
        )
        super().__init__(alpha=1.0, l1_ratio=ratios[0],
                         fit_intercept=fit_intercept, max_iter=max_iter,
                         dtype=dtype)
        self._l1_ratios = ratios
        self._ratio_is_list = isinstance(l1_ratio, (list, tuple, np.ndarray))
        self.alphas = alphas
        self.n_alphas = int(n_alphas)
        self.eps = float(eps)
        self.cv = int(cv)
        self.one_se_rule = bool(one_se_rule)
        self.shuffle_seed = shuffle_seed

    def _fit_one_ratio(self, X, y, l1_ratio, key):
        m = X.shape[0]
        scale = m * l1_ratio  # sklearn per-sample α → internal α₁
        alphas = self.alphas
        if alphas is not None:
            alphas = np.asarray(alphas, np.float64) * scale
        res = cv_lasso(
            X, y,
            k_folds=self.cv,
            alphas=alphas,
            n_alphas=self.n_alphas,
            eps=self.eps,
            key=key,
            cfg=BatchFISTAConfig(max_iter=self.max_iter, check_every=25,
                                 rel_gap_tol=1e-7),
            one_se_rule=self.one_se_rule,
            fit_intercept=self.fit_intercept,
            dtype=self.dtype,
            l1_ratio=l1_ratio,
        )
        return res, scale

    def fit(self, X, y):
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        key = (
            jax.random.PRNGKey(self.shuffle_seed)
            if self.shuffle_seed is not None
            else None
        )
        runs = [self._fit_one_ratio(X, y, r, key) for r in self._l1_ratios]
        # Best (l1_ratio, α) pair by mean validation MSE across folds.
        best_r = int(np.argmin(
            [float(res.mse_mean[res.best_idx]) for res, _ in runs]
        ))
        res, scale = runs[best_r]
        self.l1_ratio_ = self._l1_ratios[best_r]
        self.l1_ratio = self.l1_ratio_  # refit semantics for _BaseRegressor
        if self._ratio_is_list:
            self.alphas_ = np.stack(
                [np.asarray(r.alphas, np.float64) / s for r, s in runs]
            )
            self.mse_path_ = np.stack(
                [np.asarray(r.mse_path, np.float64).T for r, _ in runs]
            )
        else:
            self.alphas_ = np.asarray(res.alphas, np.float64) / scale
            self.mse_path_ = np.asarray(res.mse_path, np.float64).T
        self.alpha_ = float(res.best_alpha) / scale
        self.coef_ = np.asarray(res.coef, np.float64)
        self.coef_path_ = np.asarray(res.coef_path, np.float64)
        self.intercept_ = float(res.intercept)
        self.converged_ = bool(res.converged)
        self.n_iter_ = int(res.iters[-1, int(res.best_idx)])  # refit instance
        return self


class LassoCV(_BaseRegressor):
    """K-fold cross-validated lasso over an α ladder — the whole
    (folds × ladder) grid plus the refit path solves as ONE device call
    (batch/cv.py). After ``fit``: ``alpha_``, ``alphas_``, ``mse_path_``
    (shape (n_alphas, cv) — sklearn's orientation), ``coef_``,
    ``intercept_``, ``coef_path_``."""

    def __init__(self, alphas=None, n_alphas=100, eps=1e-3, cv=5,
                 fit_intercept=True, max_iter=2000, one_se_rule=False,
                 shuffle_seed=0, dtype=jnp.float32):
        super().__init__(alpha=1.0, l1_ratio=1.0, fit_intercept=fit_intercept,
                         max_iter=max_iter, dtype=dtype)
        self.alphas = alphas
        self.n_alphas = int(n_alphas)
        self.eps = float(eps)
        self.cv = int(cv)
        self.one_se_rule = bool(one_se_rule)
        self.shuffle_seed = shuffle_seed

    def fit(self, X, y):
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        n_samples = X.shape[0]
        alphas = self.alphas
        if alphas is not None:
            # sklearn-per-sample α → internal α₁
            alphas = np.asarray(alphas, np.float64) * n_samples
        key = (
            jax.random.PRNGKey(self.shuffle_seed)
            if self.shuffle_seed is not None
            else None
        )
        res = cv_lasso(
            X, y,
            k_folds=self.cv,
            alphas=alphas,
            n_alphas=self.n_alphas,
            eps=self.eps,
            key=key,
            cfg=BatchFISTAConfig(max_iter=self.max_iter, check_every=25,
                                 rel_gap_tol=1e-7),
            one_se_rule=self.one_se_rule,
            fit_intercept=self.fit_intercept,
            dtype=self.dtype,
        )
        self.alphas_ = np.asarray(res.alphas, np.float64) / n_samples
        self.alpha_ = float(res.best_alpha) / n_samples
        self.mse_path_ = np.asarray(res.mse_path, np.float64).T  # (n_alphas, cv)
        self.coef_ = np.asarray(res.coef, np.float64)
        self.coef_path_ = np.asarray(res.coef_path, np.float64)
        self.intercept_ = float(res.intercept)
        self.converged_ = bool(res.converged)
        self.n_iter_ = int(res.iters[-1, int(res.best_idx)])
        return self
