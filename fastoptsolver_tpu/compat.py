"""Drop-in compatibility layer exposing the reference's exact API surface.

A user of the reference (ElBaldo1/FastOptSolver) can ``from
fastoptsolver_tpu.compat import fista, ista, fista_delta, LBFGSSolver,
prox_l1, prox_elastic_net, compute_objective, estimate_lipschitz,
generate_correlated_boston_like_data, reset_metrics, get_metrics`` and keep
their notebook code unchanged — every function keeps the reference's
signature, defaults, history format, and documented quirks
(SURVEY.md §7 behavioral contract), while executing as compiled JAX
underneath (on the GPU when one is available).

Differences, all deliberate and documented:

- The power-iteration start vector is seeded (``seed=`` kwarg, default 0)
  instead of the reference's nondeterministic unseeded draw
  (iterative_solvers.py:50; SURVEY.md §7 item 9).
- ``get_metrics`` reports call *counts* exactly; the per-call wall times of
  the reference's global timing lists (iterative_solvers.py:16-40) are
  meaningless under XLA fusion, so total solve wall time is reported instead
  and the mean is derived from it.
- ``LBFGSSolver`` is the from-scratch JAX L-BFGS (solvers/lbfgs.py), not
  SciPy's Fortran code; final objectives match (tests/test_lbfgs.py), exact
  iterate trajectories do not.
"""
from __future__ import annotations

import time

import numpy as np

import jax
import jax.numpy as jnp

from .ops import compute_objective as _compute_objective_jax
from .ops.lipschitz import estimate_lipschitz as _estimate_lipschitz_jax
from .ops.prox import prox_elastic_net as _prox_en, prox_l1 as _prox_l1
from .problems import CustomProblem, LeastSquares, fold_alphas
from .problems.generators import generate_boston_like as generate_correlated_boston_like_data
from .solvers import FISTAConfig, ISTAConfig
from .solvers.fista import fista_delta_config, fista_with_history as _fista_hist, fista as _fista
from .solvers.ista import ista_with_history as _ista_hist, ista as _ista
from .solvers.lbfgs import LBFGSConfig, lbfgs_with_history as _lbfgs_hist

__all__ = [
    "C",
    "reset_metrics",
    "get_metrics",
    "estimate_lipschitz",
    "ista",
    "fista",
    "fista_delta",
    "LBFGSSolver",
    "prox_l1",
    "prox_elastic_net",
    "compute_objective",
    "generate_correlated_boston_like_data",
]


def _ref_dtype():
    """float64 when x64 is enabled (exact reference precision), else float32.

    Avoids the silent-truncation UserWarning in default-f32 JAX processes;
    enable ``jax.config.update("jax_enable_x64", True)`` for bitwise-level
    parity with the reference's NumPy float64 arithmetic."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32

# Reference module constant (iterative_solvers.py:11).
C: float = 1e-2

# ---------------------------------------------------------------------------
# Metrics shim: same reset/get interface, functional counters underneath.
# ---------------------------------------------------------------------------

_last_metrics: dict = {}


def reset_metrics() -> None:
    """Clear recorded solver metrics (reference iterative_solvers.py:20-24)."""
    _last_metrics.clear()


def _record(metrics, wall_s: float) -> None:
    n_grad = int(metrics.n_grad_evals)
    n_ls = int(metrics.n_ls_calls)
    _last_metrics.update(
        grad_num_calls=n_grad,
        grad_time_total=wall_s,  # whole-solve wall time (XLA fuses the steps)
        grad_time_mean=wall_s / n_grad if n_grad else 0.0,
        ls_num_calls=n_ls,
        ls_time_total=0.0,
        ls_time_mean=0.0,
        ls_iters_total=int(metrics.ls_iters_total),
    )


def get_metrics():
    """Counters for the last solve (reference iterative_solvers.py:26-40).
    Times are whole-solve wall clock, not per-call (see module docstring)."""
    return dict(_last_metrics) if _last_metrics else {
        "grad_num_calls": 0,
        "grad_time_total": 0.0,
        "grad_time_mean": 0.0,
        "ls_num_calls": 0,
        "ls_time_total": 0.0,
        "ls_time_mean": 0.0,
        "ls_iters_total": 0,
    }


# ---------------------------------------------------------------------------
# Functional pieces
# ---------------------------------------------------------------------------


def prox_l1(v, tau):
    """Soft thresholding (reference prox_operators.py:3-8)."""
    return np.asarray(_prox_l1(jnp.asarray(v), tau))


def prox_elastic_net(v, tau, alpha1, alpha2):
    """Elastic-net prox (reference prox_operators.py:10-16)."""
    return np.asarray(_prox_en(jnp.asarray(v), tau, alpha1, alpha2))


def compute_objective(x, A, b, reg_type, alpha1, alpha2):
    """f(x) = g(x) + h(x) (reference objective_functions.py:3-30)."""
    return float(
        _compute_objective_jax(
            jnp.asarray(x, _ref_dtype()),
            jnp.asarray(A, _ref_dtype()),
            jnp.asarray(b, _ref_dtype()),
            reg_type,
            alpha1,
            alpha2,
        )
    )


def estimate_lipschitz(A, n_iter: int = 100, tol: float = 1e-6, seed: int = 0) -> float:
    """λ_max(AᵀA) via power iteration (reference iterative_solvers.py:45-60),
    with a seeded start vector instead of the reference's unseeded draw."""
    return float(
        _estimate_lipschitz_jax(
            jnp.asarray(A), jax.random.PRNGKey(seed), n_iter=n_iter, tol=tol
        )
    )


# ---------------------------------------------------------------------------
# Solvers
# ---------------------------------------------------------------------------


def ista(
    x0,
    g,
    grad_g,
    prox_h,
    L,
    backtracking: bool = False,
    eta: float = 0.5,
    t_init_factor: float = 1.0,
    max_iter: int = 500,
    tol: float = 0.0,
    return_history: bool = False,
):
    """Generic-callable ISTA (reference iterative_solvers.py:65-125).

    ``g``/``grad_g``/``prox_h`` are arbitrary closures (NumPy or JAX); history
    is the reference's ``{"x", "t", "delta"}`` dict with ``x`` including x₀.
    """
    reset_metrics()
    x0 = jnp.asarray(x0)
    problem = CustomProblem(
        smooth_value_fn=lambda x: jnp.asarray(g(x)),
        smooth_grad_fn=lambda x: jnp.asarray(grad_g(x)),
        prox_fn=lambda v, tau: jnp.asarray(prox_h(v, tau)),
        n_dim=int(x0.shape[0]),
    )
    cfg = ISTAConfig(
        backtracking=backtracking,
        eta=eta,
        t_init_factor=t_init_factor,
        max_iter=max_iter,
        tol=tol,
    )
    t0 = time.perf_counter()
    if return_history:
        res = _ista_hist(problem, cfg, x0=x0, L=jnp.asarray(L, x0.dtype))
        _record(res.metrics, time.perf_counter() - t0)
        k = int(res.n_iters)
        xs = np.asarray(res.history.x)[:k]
        log = {
            "x": [np.asarray(x0)] + [xs[i] for i in range(k)],
            "t": [float(t_init_factor / L)] + [float(v) for v in np.asarray(res.history.tau)[:k]],
            "delta": [float(v) for v in np.asarray(res.history.step_norm)[:k]],
        }
        return np.asarray(res.x), log
    res = _ista(problem, cfg, x0=x0, L=jnp.asarray(L, x0.dtype))
    _record(res.metrics, time.perf_counter() - t0)
    return np.asarray(res.x)


def _run_fista(A, b, reg_type, alpha1, alpha2, cfg, return_history, seed):
    reset_metrics()
    problem = LeastSquares.create(A, b, reg_type, alpha1, alpha2, dtype=_ref_dtype())
    key = jax.random.PRNGKey(seed)
    t0 = time.perf_counter()
    if return_history:
        res = _fista_hist(problem, cfg, key=key)
        _record(res.metrics, time.perf_counter() - t0)
        return res
    res = _fista(problem, cfg, key=key)
    _record(res.metrics, time.perf_counter() - t0)
    return res


def fista(
    A,
    b,
    reg_type,
    alpha1,
    alpha2,
    backtracking: bool = False,
    eta: float = 0.5,
    t_init_factor: float = 1.0,
    max_iter: int = 500,
    tol: float = 0.0,
    tol_ratio: float = 0.0,
    adaptive_restart: bool = False,
    restart_threshold: float = 1.0,
    return_history: bool = False,
    seed: int = 0,
):
    """FISTA (reference iterative_solvers.py:132-245). History is the
    reference's ``{"x", "obj"}`` with ``x`` including x₀."""
    fold_alphas(reg_type, alpha1, alpha2)  # validate reg_type like the reference
    cfg = FISTAConfig(
        backtracking=backtracking,
        eta=eta,
        t_init_factor=t_init_factor,
        max_iter=max_iter,
        tol=tol,
        tol_ratio=tol_ratio,
        adaptive_restart=adaptive_restart,
        restart_threshold=restart_threshold,
    )
    res = _run_fista(A, b, reg_type, alpha1, alpha2, cfg, return_history, seed)
    if not return_history:
        return np.asarray(res.x)
    valid = np.asarray(res.history.valid)
    xs = np.asarray(res.history.x)[valid]
    objs = np.asarray(res.history.obj)[valid]
    history = {
        "x": [np.zeros(np.asarray(res.x).shape)] + [xi for xi in xs],
        "obj": [float(o) for o in objs],
    }
    return np.asarray(res.x), history


def fista_delta(
    A,
    b,
    reg_type,
    alpha1,
    alpha2,
    delta,
    backtracking: bool = False,
    eta: float = 0.5,
    t_init_factor: float = 1.0,
    max_iter: int = 500,
    tol: float = 0.0,
    tol_ratio: float = 0.0,
    return_history: bool = False,
    seed: int = 0,
):
    """FISTA-Δ with fixed momentum θ_k = k/(k+1+δ), δ > 2 enforced (reference
    iterative_solvers.py:251-344). History ``x`` does NOT include x₀
    (reference :279, unlike fista's :160)."""
    fold_alphas(reg_type, alpha1, alpha2)
    assert delta > 2, "In FISTA-Δ, delta must be > 2 for convergence"
    cfg = fista_delta_config(
        delta,
        backtracking=backtracking,
        eta=eta,
        t_init_factor=t_init_factor,
        max_iter=max_iter,
        tol=tol,
        tol_ratio=tol_ratio,
    )
    res = _run_fista(A, b, reg_type, alpha1, alpha2, cfg, return_history, seed)
    if not return_history:
        return np.asarray(res.x)
    valid = np.asarray(res.history.valid)
    xs = np.asarray(res.history.x)[valid]
    objs = np.asarray(res.history.obj)[valid]
    history = {"x": [xi for xi in xs], "obj": [float(o) for o in objs]}
    return np.asarray(res.x), history


class LBFGSSolver:
    """sklearn-style L-BFGS driver (reference lbfgs.py:7-73) on the
    from-scratch JAX L-BFGS.

    Reproduces the reference's semantics: tiny-α elastic-net reclassification
    with ε (lbfgs.py:19-33); in lasso mode the *optimized* objective omits the
    L1 term entirely while ``history_`` records the full objective
    (lbfgs.py:43-61)."""

    def __init__(self, reg_type, alpha1, alpha2, max_iter=500, tol=1e-6, eps=1e-8):
        a1, a2, eff = fold_alphas(reg_type, alpha1, alpha2, eps=eps)
        self.reg_type = eff
        self.alpha1 = a1
        self.alpha2 = a2
        self.max_iter = max_iter
        self.tol = tol
        self.history_ = []

    def fit(self, A, b):
        reset_metrics()
        problem = LeastSquares.create(
            A, b, self.reg_type, self.alpha1, self.alpha2, dtype=_ref_dtype()
        )
        cfg = LBFGSConfig(max_iter=self.max_iter, tol=self.tol)
        t0 = time.perf_counter()
        res = _lbfgs_hist(problem, cfg)
        _record(res.metrics, time.perf_counter() - t0)
        k = int(res.n_iters)
        self.history_ = [float(o) for o in np.asarray(res.history.obj)[:k]]
        self.x_ = np.asarray(res.x)
        # reference final_obj_ is the minimized (smooth-only in lasso mode)
        # objective value returned by fmin_l_bfgs_b (lbfgs.py:72)
        self.final_obj_ = float(problem.smooth_value(res.x))
        return self
