"""Streaming Gram reduction + dense certified FISTA (problems/streaming.py,
solvers/gram_dense.py) — the path for designs larger than device memory, the
1e6×1e4-scale A (SURVEY.md §5 problem-size scaling)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fastoptsolver_tpu.problems import (
    LeastSquares,
    chunk_rows,
    generator_chunks,
    stream_gram,
)
from fastoptsolver_tpu.solvers import (
    DenseGramConfig,
    FISTAConfig,
    fista,
    fista_gram_dense,
)


def _data(m=3000, n=24, seed=0, noise=0.1):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n)).astype(np.float32) / np.sqrt(n)
    x_true = np.zeros(n, np.float32)
    x_true[: n // 4] = rng.normal(size=n // 4) * 3.0
    b = (A @ x_true + noise * rng.normal(size=m)).astype(np.float32)
    return A, b


def test_stream_gram_matches_direct():
    A, b = _data()
    g = stream_gram(chunk_rows(A, b, rows=700), n=A.shape[1])  # uneven tail
    A64 = A.astype(np.float64)
    np.testing.assert_allclose(np.asarray(g.Q), A64.T @ A64, rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(g.c), A64.T @ b.astype(np.float64), rtol=2e-4, atol=1e-4
    )
    np.testing.assert_allclose(float(g.btb), float(b @ b), rtol=1e-5)
    assert int(g.m) == A.shape[0]


def test_stream_gram_from_memmap(tmp_path):
    """Out-of-core source: A lives on disk, never fully in RAM."""
    A, b = _data(m=2048, n=16)
    path = tmp_path / "A.dat"
    mm = np.memmap(path, dtype=np.float32, mode="w+", shape=A.shape)
    mm[:] = A
    mm.flush()
    ro = np.memmap(path, dtype=np.float32, mode="r", shape=A.shape)
    g = stream_gram(chunk_rows(ro, b, rows=512), n=16)
    g0 = stream_gram(chunk_rows(A, b, rows=512), n=16)
    np.testing.assert_array_equal(np.asarray(g.Q), np.asarray(g0.Q))


def test_stream_gram_generator_chunks():
    """Chunks produced on demand: the full A never exists anywhere."""
    n, rows, k = 12, 256, 5

    def make(i):
        rng = np.random.default_rng(100 + i)
        A_i = rng.normal(size=(rows, n)).astype(np.float32)
        return A_i, rng.normal(size=rows).astype(np.float32)

    g = stream_gram(generator_chunks(make, k), n=n)
    blocks = [make(i) for i in range(k)]
    A = np.concatenate([x[0] for x in blocks]).astype(np.float64)
    b = np.concatenate([x[1] for x in blocks]).astype(np.float64)
    np.testing.assert_allclose(np.asarray(g.Q), A.T @ A, rtol=2e-4, atol=2e-4)
    assert int(g.m) == rows * k


def test_stream_gram_rejects_feature_mismatch():
    A, b = _data(m=64, n=8)
    with pytest.raises(ValueError):
        stream_gram(chunk_rows(A, b, rows=32), n=9)


def test_dense_solve_matches_full_fista():
    """Streamed Gram + fista_gram_dense == direct FISTA on the full A."""
    A, b = _data()
    a1 = 0.1 * float(np.max(np.abs(A.T @ b)))
    g = stream_gram(chunk_rows(A, b, rows=512), n=A.shape[1])
    res = fista_gram_dense(
        g, a1, 0.0, DenseGramConfig(max_iter=3000, check_every=50, rel_gap_tol=1e-6)
    )
    assert bool(res.converged)
    assert float(res.rel_gap) <= 1e-6
    prob = LeastSquares.create(A, b, "lasso", a1, 0.0)
    ref = fista(prob, FISTAConfig(max_iter=3000))
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x), rtol=1e-4, atol=1e-5)


def test_dense_solve_elastic_net_and_restart():
    A, b = _data(m=2000, n=16, seed=3)
    a1 = 0.05 * float(np.max(np.abs(A.T @ b)))
    a2 = 0.3
    g = stream_gram(chunk_rows(A, b, rows=512), n=16)
    cfg = DenseGramConfig(
        max_iter=3000, check_every=50, rel_gap_tol=1e-6, adaptive_restart=True
    )
    res = fista_gram_dense(g, a1, a2, cfg)
    assert bool(res.converged)
    prob = LeastSquares.create(A, b, "elasticnet", a1, a2)
    ref = fista(prob, FISTAConfig(max_iter=3000, adaptive_restart=True))
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x), rtol=1e-4, atol=1e-5)


def test_dense_solve_large_m_certifies_below_f32_floor():
    """The float64 gap evaluation stays truthful even when bᵀb ≫ ‖Ax−b‖²
    (the Gram-form cancellation regime of large m); certification succeeds
    at the f32 iterate floor (~1e-6)."""
    A, b = _data(m=60000, n=16, seed=7, noise=0.01)
    a1 = 0.01 * float(np.max(np.abs(A.T @ b)))
    g = stream_gram(chunk_rows(A, b, rows=8192), n=16)
    res = fista_gram_dense(
        g, a1, 0.0, DenseGramConfig(max_iter=5000, check_every=100, rel_gap_tol=2e-6)
    )
    assert bool(res.converged), float(res.rel_gap)


def test_dense_solve_float64_deep_certification():
    """With f64 inputs the whole solve runs f64 and certifies to 1e-10 —
    the f32 runs' ~1e-6 plateau is iterate precision, not a solver defect."""
    A, b = _data(m=4000, n=16, seed=5)
    A64, b64 = A.astype(np.float64), b.astype(np.float64)
    a1 = 0.05 * float(np.max(np.abs(A64.T @ b64)))
    g = stream_gram(chunk_rows(A64, b64, rows=1024), n=16, dtype=jnp.float64)
    res = fista_gram_dense(
        g, a1, 0.0,
        DenseGramConfig(max_iter=20000, check_every=100, rel_gap_tol=1e-10),
    )
    assert bool(res.converged), float(res.rel_gap)
    assert res.x.dtype == jnp.float64
