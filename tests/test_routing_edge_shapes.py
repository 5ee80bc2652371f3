"""Edge-shape sweep over ``solve_lasso_batch``.

Deliberately awkward shapes — single instances, single features, tiny row
counts, and off-by-one non-multiples of the old lane and sublane tiles —
solve through the public surface, then each instance's float64 objective is
checked against the float64 NumPy oracle (tests/oracle_np.py) run to
convergence: the certificate's contract, whatever the trajectory.
"""
from __future__ import annotations

import numpy as np

import jax.numpy as jnp
import pytest

from fastoptsolver_tpu.batch import solve_lasso_batch
from fastoptsolver_tpu.batch.fista_gram import BatchFISTAConfig
from oracle_np import fista_np, objective_np

CASES = [
    # (B, m, n) — awkward on purpose
    (1, 40, 5),      # single instance
    (2, 16, 1),      # single feature
    (129, 33, 5),    # one past a lane tile; ragged rows
    (127, 9, 8),     # one below a lane tile; m barely above sublane
    (5, 250, 7),     # n at the old fused-tile boundary
    (3, 100, 9),     # n just past a sublane
    (130, 77, 12),   # everything ragged
]


def _inputs(B, m, n, seed, k):
    rng = np.random.default_rng(seed)
    A = jnp.asarray(rng.normal(size=(B, m, n)) / np.sqrt(n), jnp.float32)
    xt = np.zeros((B, n), np.float32)
    xt[:, :k] = rng.normal(size=(B, k))
    b = jnp.einsum("bmn,bn->bm", A, jnp.asarray(xt))
    a1 = 0.1 * jnp.max(jnp.abs(jnp.einsum("bmi,bm->bi", A, b)), axis=1)
    return A, b, jnp.maximum(a1, 1e-3)


def _oracle_rel_obj(A, b, a1, x, lanes):
    """Relative f64 objective excess of ``x`` over the oracle's optimum on
    ``lanes`` (f64 FISTA run well past convergence)."""
    out = []
    for i in lanes:
        Ai = np.asarray(A[i], np.float64)
        bi = np.asarray(b[i], np.float64)
        ai = float(a1[i])
        L = float(np.linalg.eigvalsh(Ai.T @ Ai)[-1])
        x_star, _ = fista_np(Ai, bi, ai, 0.0, L, max_iter=3000)
        f_star = objective_np(x_star, Ai, bi, ai, 0.0)
        f = objective_np(np.asarray(x[i], np.float64), Ai, bi, ai, 0.0)
        out.append((f - f_star) / max(f_star, 1.0))
    return np.asarray(out)


@pytest.mark.parametrize("B,m,n", CASES)
def test_routed_edge_shapes_agree_with_driver(B, m, n):
    A, b, a1 = _inputs(B, m, n, B * 1000 + m * 10 + n, max(n // 2, 1))
    cfg = BatchFISTAConfig(max_iter=500, check_every=25, rel_gap_tol=1e-5)
    res = solve_lasso_batch(A, b, a1, cfg=cfg)
    assert res.x.shape == (B, n)
    assert bool(np.asarray(res.converged).all()), (B, m, n)
    lanes = sorted({0, B // 2, B - 1})
    rel = _oracle_rel_obj(A, b, a1, res.x, lanes)
    # certified at 1e-5 relative gap, which bounds the objective excess
    assert rel.max() <= 2e-5, (B, m, n, rel.max())
    assert rel.min() >= -1e-6, (B, m, n, rel.min())  # never below optimal


@pytest.mark.parametrize("kw", [
    dict(adaptive_restart=True),
    dict(momentum="greedy"),
    dict(backtracking=True, rel_gap_tol=1e-3),
])
def test_routed_edge_shapes_config_variants(kw):
    """The awkwardest shape × each per-lane-state config family."""
    B, m, n = 130, 77, 12
    A, b, a1 = _inputs(B, m, n, 7, 6)
    kw = dict(kw)
    tol = kw.pop("rel_gap_tol", 1e-5)
    cfg = BatchFISTAConfig(max_iter=500, check_every=25, rel_gap_tol=tol,
                           **kw)
    res = solve_lasso_batch(A, b, a1, cfg=cfg)
    assert res.x.shape == (B, n)
    assert np.isfinite(np.asarray(res.rel_gap)).all()
    conv = np.asarray(res.converged)
    if "backtracking" not in kw:
        assert bool(conv.all())
    lanes = [i for i in (0, 64, B - 1) if conv[i]]
    rel = _oracle_rel_obj(A, b, a1, res.x, lanes)
    assert rel.size == 0 or rel.max() <= 2 * tol, rel
