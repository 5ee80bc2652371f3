"""Bring-up smoke test: the system's main paths on one NVIDIA GPU, at real
sizes, each checked against a reference that shares no code with it.

    python chip_smoke.py               # one card: every single-card phase
    python chip_smoke.py --four-cards  # four cards: only the mesh phases

Prints, in order: the ``nvidia-smi`` name and power limit of each card (read
in a subprocess before JAX touches a card), the JAX version, device kind and
compile-cache directory, then one JSON line per phase — compile seconds,
run seconds (host clock around ``block_until_ready``), the process's peak
device bytes so far, the largest error against the reference, and the
tolerance with its reason. The last line is exactly

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

and is printed only when every phase passed. The script exits non-zero,
without that line, when JAX finds no GPU or any phase fails. Everything runs
in this one process: a second JAX process could not reserve the card.

Each phase is a function of its sizes; ``main()`` calls them at real sizes
and tests/test_chip_smoke.py calls the same functions at tiny sizes on CPU.
``compile_s`` is the first call's time minus the second's: the first call of
a shape compiles, the second only runs.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np


class PhaseFailed(RuntimeError):
    """A phase's result is outside its tolerance."""


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _timed(fn):
    """``(out, compile_s, run_s)``: one cold call, then the faster of two
    warm calls, each ended by ``block_until_ready``."""
    from fastoptsolver_tpu.utils.profiling import timed

    t0 = time.perf_counter()
    timed(fn, repeats=1, warmup=0)
    first = time.perf_counter() - t0
    out, stats = timed(fn, repeats=2, warmup=0)
    return out, max(first - stats["min_s"], 0.0), stats["min_s"]


def _peak_bytes(devices=None) -> list | None:
    """``peak_bytes_in_use`` of each device (None where the backend keeps no
    statistics, as the CPU does)."""
    import jax

    stats = [d.memory_stats() for d in (devices or jax.devices()[:1])]
    if any(s is None for s in stats):
        return None
    return [s["peak_bytes_in_use"] for s in stats]


def _bytes_in_use(devices) -> list | None:
    """``bytes_in_use`` of each device (None where the backend keeps no
    statistics)."""
    stats = [d.memory_stats() for d in devices]
    if any(s is None for s in stats):
        return None
    return [s["bytes_in_use"] for s in stats]


def _record(phase, compile_s, run_s, max_err, tol, tol_reason, devices=None,
            **extra) -> dict:
    rec = {"phase": phase, "compile_s": compile_s, "run_s": run_s,
           "peak_bytes": _peak_bytes(devices), "max_err": float(max_err),
           "tol": tol, "tol_reason": tol_reason}
    rec.update(extra)
    return rec


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise PhaseFailed(msg)


def lasso_gap64(A, b, alpha, x) -> tuple[float, float]:
    """``(relative duality gap, primal)`` of ``½‖Ax−b‖² + α‖x‖₁`` at ``x``,
    in float64 on the host from the raw data. The dual point is the residual
    scaled into ``‖Aᵀu‖∞ ≤ α``; the gap is normalized by ``max(primal, 1)``,
    the library's convention."""
    A = np.asarray(A, np.float64)
    b = np.asarray(b, np.float64)
    x = np.asarray(x, np.float64)
    r = A @ x - b
    s = max(1.0, float(np.max(np.abs(A.T @ r))) / alpha)
    primal = 0.5 * r @ r + alpha * np.abs(x).sum()
    dual = -0.5 * (r @ r) / s**2 - (r @ b) / s
    return (primal - dual) / max(primal, 1.0), primal


def lasso_gap64_gram(Q, c, btb, alpha, x) -> tuple[float, float]:
    """:func:`lasso_gap64` from the Gram triple ``(AᵀA, Aᵀb, bᵀb)``."""
    Q = np.asarray(Q, np.float64)
    c = np.asarray(c, np.float64)
    x = np.asarray(x, np.float64)
    Qx = Q @ x
    rr = max(x @ Qx - 2.0 * c @ x + float(btb), 0.0)
    rb = c @ x - float(btb)
    s = max(1.0, float(np.max(np.abs(Qx - c))) / alpha)
    primal = 0.5 * rr + alpha * np.abs(x).sum()
    dual = -0.5 * rr / s**2 - rb / s
    return (primal - dual) / max(primal, 1.0), primal


def fista64(A, b, alpha, tol=1e-13, max_iter=200_000):
    """Plain float64 FISTA on one lasso instance, stopped by
    :func:`lasso_gap64_gram` ≤ ``tol``: the oracle the batched solutions
    are compared with."""
    A = np.asarray(A, np.float64)
    b = np.asarray(b, np.float64)
    Q, c, btb = A.T @ A, A.T @ b, b @ b
    L = np.linalg.eigvalsh(Q)[-1]
    x = y = np.zeros(A.shape[1])
    t = 1.0
    for k in range(max_iter):
        v = y - (Q @ y - c) / L
        x_new = np.sign(v) * np.maximum(np.abs(v) - alpha / L, 0.0)
        t_new = 0.5 * (1.0 + np.sqrt(1.0 + 4.0 * t * t))
        y = x_new + ((t - 1.0) / t_new) * (x_new - x)
        x, t = x_new, t_new
        if k % 50 == 49 and lasso_gap64_gram(Q, c, btb, alpha, x)[0] <= tol:
            break
    return x


def x_distance_ratio(A, b, alpha, x1, x2) -> float:
    """``‖x1 − x2‖`` over the distance the two points' certificates allow.
    The lasso ``½‖Ax−b‖² + α‖x‖₁`` is μ-strongly convex with
    μ = λ_min(AᵀA), so a point with f64 relative gap g and primal f lies
    within ``√(2·g·max(f, 1)/μ)`` of the optimum; two points, within the
    sum. A ratio ≤ 1 says both are as close to x* as they claim."""
    A = np.asarray(A, np.float64)
    b = np.asarray(b, np.float64)
    mu = np.linalg.eigvalsh(A.T @ A)[0]
    bound = 0.0
    for z in (x1, x2):
        g, f = lasso_gap64(A, b, alpha, z)
        bound += np.sqrt(2.0 * max(g, 0.0) * max(f, 1.0) / mu)
    diff = np.linalg.norm(np.asarray(x1, np.float64) - np.asarray(x2, np.float64))
    if bound == 0.0:
        return 0.0 if diff == 0.0 else float("inf")
    return float(diff / bound)


def gram_scale(A, b, x) -> float:
    """``bᵀb + ‖Ax‖² + 2|bᵀAx|``: the size of the terms the Gram-form
    residual ``xᵀQx − 2cᵀx + bᵀb`` is formed from."""
    A = np.asarray(A, np.float64)
    b = np.asarray(b, np.float64)
    Ax = A @ np.asarray(x, np.float64)
    return b @ b + Ax @ Ax + 2.0 * abs(b @ Ax)


def f32_gap_margin(scale: float, primal: float) -> float:
    """Float32 evaluation error of the Gram-form gap the solver certifies
    with, as a relative-gap margin: each term of ``scale`` (from
    :func:`gram_scale`, over the rows the Gram was summed from) carries a
    few f32 roundings, so the certificate itself is known only to
    ``8·2⁻²⁴·scale/max(primal, 1)``. Calibrated on the CPU: the f64 gap
    exceeded the f32 one by at most 2.9 of these units (CV grid, m=4000)."""
    return 8.0 * 2.0**-24 * scale / max(primal, 1.0)


def _sampled_gaps(A_fm, b_fm, alpha, x, idx, tol):
    """f64 gaps of instances ``idx`` of a feature-major batch against the
    certificate ``tol`` plus each instance's f32 margin; returns
    ``(gaps, limits)`` as host arrays."""
    A_s = np.asarray(A_fm[:, :, idx], np.float64)
    b_s = np.asarray(b_fm[:, idx], np.float64)
    a_s = np.asarray(alpha[idx], np.float64)
    x_s = np.asarray(x[idx], np.float64)
    gaps, limits = [], []
    for j in range(len(idx)):
        Aj = A_s[:, :, j].T
        gap, primal = lasso_gap64(Aj, b_s[:, j], a_s[j], x_s[j])
        gaps.append(gap)
        limits.append(tol + f32_gap_margin(
            gram_scale(Aj, b_s[:, j], x_s[j]), primal))
    return np.asarray(gaps), np.asarray(limits)


GAP_REASON = ("f64 gap recomputed on the host from (A, b, alpha, x) must be "
              "<= rel_gap_tol plus the f32 evaluation margin of the "
              "solver's Gram-form certificate (f32_gap_margin)")


# ---------------------------------------------------------------------------
# one-card phases
# ---------------------------------------------------------------------------


def phase_precision(size: int, seed: int = 0) -> list[dict]:
    """An f32 matmul with no explicit precision, after the library import:
    it must run at full f32 (the import pins ``jax_default_matmul_precision``
    to "highest"); a TF32 default would show ~1e-3 relative error."""
    import jax
    import jax.numpy as jnp

    import fastoptsolver_tpu  # noqa: F401 — the import sets the default

    _check(jax.config.jax_default_matmul_precision == "highest",
           f"default precision is {jax.config.jax_default_matmul_precision}")
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((size, size)).astype(np.float32)
    Y = rng.standard_normal((size, size)).astype(np.float32)
    mm = jax.jit(lambda X, Y: jnp.einsum("ij,jk->ik", X, Y))
    Xd, Yd = jnp.asarray(X), jnp.asarray(Y)
    C, comp, run = _timed(lambda: mm(Xd, Yd))
    ref = X.astype(np.float64) @ Y.astype(np.float64)
    err = np.linalg.norm(np.asarray(C, np.float64) - ref) / np.linalg.norm(ref)
    tol = 1e-5
    _check(err <= tol, f"matmul relative error {err:.3e} > {tol}")
    return [_record("precision", comp, run, err, tol,
                    "relative Frobenius error vs NumPy f64: f32 sits near "
                    "1e-7, TF32 near 1e-3")]


def phase_df32(size: int, seed: int = 7) -> list[dict]:
    """The error-free transforms of ops/df32.py compiled for the device. The
    GPU compiler contracts ``a*b+c`` into FMA, which the transforms are
    built to survive; each must be exact against float64."""
    import jax
    import jax.numpy as jnp

    from fastoptsolver_tpu.ops import df32

    rng = np.random.default_rng(seed)
    u64 = rng.normal(size=size) * 1e4
    u64[size // 2:] = -u64[: size - size // 2][::-1] * (1 + 1e-9)
    u = jnp.asarray(u64.astype(np.float32))
    v = jnp.asarray(rng.normal(size=size).astype(np.float32))
    f64 = lambda a: np.asarray(a, np.float64)

    two_sum = jax.jit(df32.two_sum)
    (s, e), comp, run = _timed(lambda: two_sum(u, v))
    sum_err = np.max(np.abs(f64(s) + f64(e) - (f64(u) + f64(v))))
    terms = jax.jit(df32.exact_mul_terms)(u, v)
    prod = f64(u) * f64(v)
    mul_err = np.max(np.abs(sum(f64(t) for t in terms) - prod))
    hi, lo = jax.jit(df32.dot2)(u, v)
    dot_err = abs(float(f64(hi) + f64(lo)) - float(f64(u) @ f64(v)))
    dot_tol = 1e-13 * float(np.abs(prod).sum())
    _check(sum_err == 0.0, f"two_sum not exact: {sum_err:.3e}")
    _check(mul_err == 0.0, f"exact_mul_terms not exact: {mul_err:.3e}")
    _check(dot_err <= dot_tol, f"dot2 error {dot_err:.3e} > {dot_tol:.3e}")
    return [_record("df32", comp, run, max(sum_err, mul_err, dot_err), dot_tol,
                    "two_sum and exact_mul_terms must be exact (error 0); "
                    "dot2 within 1e-13 * sum|u*v| (double-word accuracy)",
                    two_sum_err=float(sum_err), mul_err=float(mul_err),
                    dot2_err=dot_err)]


def phase_headline_batch(batch: int, m: int, n_sample: int, n_oracle: int,
                         seed: int = 0) -> list[dict]:
    """The main path at the repo's headline shape: raw feature-major
    (A, b, alpha) through ``solve_lasso_batch`` to certified x. Every
    instance must converge; sampled instances are re-certified in f64 and
    the first ``n_oracle`` of them are solved again by a float64 FISTA."""
    import jax
    import jax.numpy as jnp

    from fastoptsolver_tpu.batch import solve_lasso_batch
    from fastoptsolver_tpu.bench import headline

    cfg = headline.CFG
    A, b, a1 = jax.block_until_ready(
        headline.build_problems(jax.random.PRNGKey(seed), batch, m)
    )
    res, comp, run = _timed(lambda: solve_lasso_batch(
        A, b, a1, 0.0, cfg=cfg, feature_major=True))
    n_conv = int(jnp.sum(res.converged))
    _check(n_conv == batch, f"{batch - n_conv} of {batch} did not converge")

    idx = np.sort(np.random.default_rng(seed).choice(
        batch, min(n_sample, batch), replace=False))
    gaps, limits = _sampled_gaps(A, b, a1, res.x, idx, cfg.rel_gap_tol)
    _check(bool(np.all(gaps <= limits)),
           f"f64 gap {gaps.max():.3e} above its limit on "
           f"{int(np.sum(gaps > limits))} sampled instances")

    # float64 oracle, held to the strong-convexity bound
    ratio = 0.0
    x_err = 0.0
    for i in idx[:n_oracle]:
        Ai = np.asarray(A[:, :, i], np.float64).T
        bi = np.asarray(b[:, i], np.float64)
        ai = float(a1[i])
        xi = np.asarray(res.x[i], np.float64)
        x_star = fista64(Ai, bi, ai)
        x_err = max(x_err, float(np.linalg.norm(xi - x_star)))
        ratio = max(ratio, x_distance_ratio(Ai, bi, ai, xi, x_star))
    _check(ratio <= 1.0, f"x off the f64 oracle by {ratio:.3f}x its bound")
    return [_record(
        "headline_batch", comp, run, gaps.max(), float(limits.min()),
        GAP_REASON, gap_over_limit=float(np.max(gaps / limits)),
        batch=batch, m=m, n=int(A.shape[0]), converged=n_conv,
        certified_per_s=n_conv / run, lockstep_iters=int(res.n_iters_total),
        sampled=len(idx), oracle_x_err=x_err, oracle_err_over_bound=ratio,
        oracle_tol_reason="||x - x*|| <= sqrt(2 gap/lambda_min) for each "
                          "of x and the f64 FISTA x* (strong convexity)",
    )]


def phase_wide_n_batch(n: int, q_bytes: float, n_sample: int,
                       seed: int = 0) -> list[dict]:
    """``solve_lasso_batch`` at wide n (m = 2n) with the batch sized so the
    Gram tensor Q takes about ``q_bytes``.

    Certified at 1e-5, not 1e-6: at n=128 the f32 Gram-form gap floors
    between 1e-6 and 2.3e-6 on about 13% of these instances (measured on the
    CPU: the same instances stay above 1e-6 with 4× the iterations)."""
    import jax
    import jax.numpy as jnp

    from fastoptsolver_tpu.batch import solve_lasso_batch
    from fastoptsolver_tpu.bench import headline
    from fastoptsolver_tpu.bench.wide_n import _build_problems

    cfg = dataclasses.replace(headline.CFG, rel_gap_tol=1e-5)
    m = 2 * n
    B = max(int(q_bytes / (n * n * 4)), 1)
    A, b, a1 = jax.block_until_ready(
        _build_problems(jax.random.PRNGKey(seed), B, m, n))
    res, comp, run = _timed(lambda: solve_lasso_batch(A, b, a1, 0.0,
                                                            cfg=cfg))
    n_conv = int(jnp.sum(res.converged))
    _check(n_conv == B, f"{B - n_conv} of {B} did not converge")
    idx = np.sort(np.random.default_rng(seed).choice(
        B, min(n_sample, B), replace=False))
    A_fm = jnp.transpose(A[idx], (2, 1, 0))
    b_fm = jnp.transpose(b[idx], (1, 0))
    gaps, limits = _sampled_gaps(A_fm, b_fm, a1[idx], res.x[idx],
                                 np.arange(len(idx)), cfg.rel_gap_tol)
    _check(bool(np.all(gaps <= limits)),
           f"f64 gap {gaps.max():.3e} above its limit")
    return [_record("wide_n_batch", comp, run, gaps.max(),
                    float(limits.min()), GAP_REASON,
                    gap_over_limit=float(np.max(gaps / limits)),
                    rel_gap_tol=cfg.rel_gap_tol, batch=B, m=m, n=n,
                    q_bytes=B * n * n * 4, converged=n_conv,
                    certified_per_s=n_conv / run,
                    lockstep_iters=int(res.n_iters_total), sampled=len(idx))]


def phase_cv_grid(m: int, n: int, n_sample: int, k_folds: int = 5,
                  n_alphas: int = 100, seed: int = 0) -> list[dict]:
    """K-fold cross-validated lasso through batch/cv.py at sklearn's LassoCV
    defaults (cv=5, n_alphas=100, eps=1e-3): the whole (folds+1) × α grid
    in one certified batch. Sampled grid instances are re-certified in f64
    from their own training rows and fold-scaled penalty.

    The grid is certified at 1e-5, not 1e-6: at m in the thousands the
    f32 Gram-form gap (``xᵀQx − 2cᵀx + bᵀb``, with fold Grams formed by
    subtraction) floors between 1e-6 and 1e-5 at the small end of the α
    ladder, so a 1e-6 certificate spins to ``max_iter`` on part of the grid
    (measured on the CPU at m=4000, n=200: 147 of 600 instances)."""
    import jax.numpy as jnp

    from fastoptsolver_tpu.batch import cv_lasso
    from fastoptsolver_tpu.batch.fista_gram import BatchFISTAConfig

    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)).astype(np.float32)
    x_true = np.where(rng.random(n) < 0.1, rng.standard_normal(n), 0.0)
    b = (A @ x_true + rng.standard_normal(m)).astype(np.float32)
    cfg = BatchFISTAConfig(max_iter=2000, check_every=25, rel_gap_tol=1e-5)
    Ad, bd = jnp.asarray(A), jnp.asarray(b)
    res, comp, run = _timed(lambda: cv_lasso(
        Ad, bd, k_folds=k_folds, n_alphas=n_alphas, eps=1e-3, cfg=cfg))
    conv = np.asarray(res.converged_grid)
    _check(bool(conv.all()), f"{int((~conv).sum())} grid instances did not "
                             "converge")

    # sklearn KFold: contiguous folds, the remainder one row each up front
    f_lo, r = divmod(m, k_folds)
    sizes = [f_lo + (1 if j < r else 0) for j in range(k_folds)]
    starts = np.concatenate([[0], np.cumsum(sizes)])
    alphas = np.asarray(res.alphas, np.float64)
    coefs = np.concatenate([np.asarray(res.coef_folds),
                            np.asarray(res.coef_path)[None]], axis=0)
    picks = rng.choice((k_folds + 1) * n_alphas, min(n_sample,
                       (k_folds + 1) * n_alphas), replace=False)
    gaps, limits = [], []
    for p in picks:
        j, k = divmod(int(p), n_alphas)
        if j < k_folds:
            keep = np.ones(m, bool)
            keep[starts[j]:starts[j + 1]] = False
            alpha = alphas[k] * (m - sizes[j]) / m
        else:
            keep = np.ones(m, bool)
            alpha = alphas[k]
        gap, primal = lasso_gap64(A[keep], b[keep], alpha, coefs[j, k])
        gaps.append(gap)
        # fold Grams are full-data Grams minus fold Grams: their rounding
        # follows the full data's scale
        limits.append(cfg.rel_gap_tol + f32_gap_margin(
            gram_scale(A, b, coefs[j, k]), primal))
    gaps, limits = np.asarray(gaps), np.asarray(limits)
    _check(bool(np.all(gaps <= limits)),
           f"f64 gap {gaps.max():.3e} above its limit")
    return [_record("cv_grid", comp, run, gaps.max(), float(limits.min()),
                    GAP_REASON, gap_over_limit=float(np.max(gaps / limits)),
                    rel_gap_tol=cfg.rel_gap_tol, m=m, n=n, k_folds=k_folds,
                    n_alphas=n_alphas,
                    grid_instances=int(conv.size), sampled=len(picks))]


def phase_dense_and_stream(dense_m: int, dense_n: int, dense_iters: int,
                           stream_m: int, stream_n: int, chunk_rows: int,
                           seed: int = 0) -> list[dict]:
    """One large dense lasso through ``fista`` on a ``LeastSquares``, then a
    design streamed through the device once (``stream_gram``) and solved in
    Gram form (``fista_gram_dense``). Both re-certified in f64 on the host;
    the first chunk's (Q, c, bᵀb) is checked against NumPy f64."""
    import jax
    import jax.numpy as jnp

    from fastoptsolver_tpu.bench.streaming_lasso import host_chunks
    from fastoptsolver_tpu.problems import LeastSquares, stream_gram
    from fastoptsolver_tpu.solvers import (
        DenseGramConfig,
        FISTAConfig,
        fista,
        fista_gram_dense,
    )

    records = []
    # --- dense: A read twice per iteration ---------------------------------
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(seed), 4)

    @jax.jit
    def build():
        A = jax.random.normal(k1, (dense_m, dense_n), jnp.float32)
        A = A / np.sqrt(dense_n)
        x_true = jnp.where(jax.random.uniform(k2, (dense_n,)) < 0.05,
                           3.0 * jax.random.normal(k3, (dense_n,)), 0.0)
        b = A @ x_true + 0.1 * jax.random.normal(k4, (dense_m,))
        return A, b, 0.1 * jnp.max(jnp.abs(A.T @ b))

    A, b, a1 = jax.block_until_ready(build())
    problem = LeastSquares(A=A, b=b, alpha1=a1, alpha2=jnp.float32(0.0))
    solve = jax.jit(lambda p: fista(p, FISTAConfig(max_iter=dense_iters)).x)
    x, comp, run = _timed(lambda: solve(problem))
    gap, _ = lasso_gap64(np.asarray(A), np.asarray(b), float(a1), x)
    tol = 1e-5
    _check(gap <= tol, f"dense f64 gap {gap:.3e} > {tol}")
    records.append(_record(
        "dense_and_stream/dense", comp, run, gap, tol,
        "f64 gap of the f32 iterate after a fixed iteration count (the dense "
        "solver has no certified stop); kappa(AtA) < 2 at m >> n, so "
        f"{dense_iters} iterations reach the f32 floor",
        m=dense_m, n=dense_n, iters=dense_iters))
    del A, b, problem

    # --- streamed Gram: A crosses the host link once ------------------------
    chunks = host_chunks(stream_m, stream_n, chunk_rows, seed)
    first, _, _ = _timed(lambda: stream_gram(chunks[:1], n=stream_n))
    A0 = chunks[0][0].astype(np.float64)
    b0 = chunks[0][1].astype(np.float64)
    Q0 = A0.T @ A0
    chunk_err = max(
        np.linalg.norm(np.asarray(first.Q, np.float64) - Q0) / np.linalg.norm(Q0),
        np.linalg.norm(np.asarray(first.c, np.float64) - A0.T @ b0)
        / np.linalg.norm(A0.T @ b0),
        abs(float(first.btb) - b0 @ b0) / (b0 @ b0),
    )
    chunk_tol = 5e-5
    _check(chunk_err <= chunk_tol,
           f"first chunk Gram error {chunk_err:.3e} > {chunk_tol}")
    gram, s_comp, s_run = _timed(lambda: stream_gram(iter(chunks),
                                                           n=stream_n))
    a1s = 0.1 * float(jnp.max(jnp.abs(gram.c)))
    dcfg = DenseGramConfig(max_iter=3000, check_every=100, rel_gap_tol=1e-6)
    res, comp, run = _timed(lambda: fista_gram_dense(gram, a1s, 0.0,
                                                           dcfg))
    _check(bool(res.converged), f"streamed solve did not certify "
                                f"(gap {float(res.rel_gap):.3e})")
    gap, _ = lasso_gap64_gram(gram.Q, gram.c, gram.btb, a1s, res.x)
    tol = 2e-6
    _check(gap <= tol, f"streamed f64 gap {gap:.3e} > {tol}")
    records.append(_record(
        "dense_and_stream/stream", comp, run, gap, tol,
        "f64 gap from the streamed (Q, c, btb) must be <= rel_gap_tol 1e-6 "
        "plus 1e-6: the solver certifies with df32 arithmetic (ops/df32.py) "
        "on the same f32-stored triple",
        m=stream_m, n=stream_n, a_bytes=stream_m * stream_n * 4,
        stream_s=s_run, stream_compile_s=s_comp,
        stream_gbps=stream_m * stream_n * 4 / s_run / 1e9,
        first_chunk_gram_err=float(chunk_err), first_chunk_tol=chunk_tol,
        first_chunk_tol_reason="relative error vs NumPy f64 of one chunk's "
                               "(Q, c, btb): f32 sums over the chunk's rows; "
                               "TF32 would give ~1e-3",
        iters=int(res.iters)))
    return records


def phase_resume(batch: int, m: int, cut_iter: int = 50,
                 seed: int = 1) -> list[dict]:
    """``solve_lasso_batch(..., return_state=True)`` stopped at ``cut_iter``
    and resumed from its state, against the straight run."""
    import jax
    import jax.numpy as jnp

    from fastoptsolver_tpu.batch import solve_lasso_batch
    from fastoptsolver_tpu.bench import headline

    full = headline.CFG
    cut = dataclasses.replace(full, max_iter=cut_iter)
    A, b, a1 = jax.block_until_ready(
        headline.build_problems(jax.random.PRNGKey(seed), batch, m))
    solve = lambda cfg, **kw: solve_lasso_batch(A, b, a1, 0.0, cfg=cfg,
                                                feature_major=True, **kw)
    straight, comp, run = _timed(lambda: solve(full))
    _, mid = solve(cut, return_state=True)
    _check(int(mid.k) == cut_iter and not bool(jnp.all(mid.done)),
           "the cut run finished before the cut: nothing to resume")
    resumed = jax.block_until_ready(solve(full, state0=mid))
    bit_exact = bool(np.array_equal(np.asarray(resumed.x),
                                    np.asarray(straight.x))
                     and np.array_equal(np.asarray(resumed.iters),
                                        np.asarray(straight.iters)))
    err = float(jnp.max(jnp.abs(resumed.x - straight.x)))
    scale = float(jnp.max(jnp.abs(straight.x)))
    tol = 1e-5 * scale
    _check(err <= tol, f"resumed x off the straight run by {err:.3e}")
    return [_record("resume", comp, run, err, tol,
                    "the resumed run rebuilds the Gram with the same "
                    "program and continues the same loop, so it should be "
                    "bit-exact; allclose (1e-5 of max|x|) is the floor",
                    batch=batch, cut_iter=cut_iter, bit_exact=bit_exact)]


# ---------------------------------------------------------------------------
# four-card phases (instance-parallel, sharded dense, consensus, mesh resume)
# ---------------------------------------------------------------------------


def _shards(fn, devices, key):
    """Per-device arrays of ``fn(fold_in(key, d))``, each made on its own
    device: nothing is funnelled through one card."""
    import jax

    out = []
    for d, dev in enumerate(devices):
        with jax.default_device(dev):
            out.append(jax.block_until_ready(fn(jax.random.fold_in(key, d))))
    return out


def _assemble(parts, mesh, spec, axis_dim):
    import jax
    from jax.sharding import NamedSharding

    shape = list(parts[0].shape)
    shape[axis_dim] *= len(parts)
    return jax.make_array_from_single_device_arrays(
        tuple(shape), NamedSharding(mesh, spec), parts)


def phase_mesh_batch(per_card: int, m: int, devices, n_sample: int,
                     seed: int = 0) -> list[dict]:
    """``solve_lasso_batch(mesh=make_mesh(batch=N))`` over N × ``per_card``
    instances, each card generating its own shard, against the same shards
    solved one at a time without a mesh; then a mesh checkpoint cut halfway
    and resumed over the mesh, against the straight mesh run.

    The per-shard solves draw their own power-iteration start vectors, so
    their L, and their iterates, differ from the mesh run's in the last
    bits: sampled instances are held to the strong-convexity bound
    (:func:`x_distance_ratio`). ``bytes_before`` and ``mesh_solve_peak_bytes``
    read each card before and after the first mesh call, which compiles."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from fastoptsolver_tpu.batch import solve_lasso_batch
    from fastoptsolver_tpu.bench import headline
    from fastoptsolver_tpu.parallel import BATCH_AXIS, make_mesh

    cfg = headline.CFG
    mesh = make_mesh(batch=len(devices), model=1, devices=devices)
    parts = _shards(lambda k: headline.build_problems(k, per_card, m),
                    devices, jax.random.PRNGKey(seed))
    A = _assemble([p[0] for p in parts], mesh, P(None, None, BATCH_AXIS), 2)
    b = _assemble([p[1] for p in parts], mesh, P(None, BATCH_AXIS), 1)
    a1 = _assemble([p[2] for p in parts], mesh, P(BATCH_AXIS), 0)
    B = A.shape[-1]
    solve = lambda cfg, **kw: solve_lasso_batch(
        A, b, a1, 0.0, cfg=cfg, feature_major=True, mesh=mesh, **kw)
    before = _bytes_in_use(devices)
    res, comp, run = _timed(lambda: solve(cfg))
    n_conv = int(jnp.sum(res.converged))
    _check(n_conv == B, f"{B - n_conv} of {B} did not converge on the mesh")
    peaks = _peak_bytes(devices)

    x_mesh = np.asarray(res.x)
    refs = []
    for d, (Ad, bd, ad) in enumerate(parts):
        ref = solve_lasso_batch(Ad, bd, ad, 0.0, cfg=cfg, feature_major=True)
        _check(bool(np.all(np.asarray(ref.converged))),
               f"shard {d} did not converge alone")
        refs.append(np.asarray(ref.x))
    x_ref = np.concatenate(refs)
    bit_exact = bool(np.array_equal(x_mesh, x_ref))
    rel = float(np.max(np.abs(x_mesh - x_ref)) / np.max(np.abs(x_ref)))
    idx = np.sort(np.random.default_rng(seed).choice(B, n_sample,
                                                     replace=False))
    gaps, limits = _sampled_gaps(A, b, a1, res.x, idx, cfg.rel_gap_tol)
    _check(bool(np.all(gaps <= limits)),
           f"mesh f64 gap {gaps.max():.3e} above its limit")
    A_s = np.asarray(A[:, :, idx], np.float64)
    b_s = np.asarray(b[:, idx], np.float64)
    a_s = np.asarray(a1[idx], np.float64)
    ratio = max(x_distance_ratio(A_s[:, :, j].T, b_s[:, j], a_s[j],
                                 x_mesh[i], x_ref[i])
                for j, i in enumerate(idx))
    _check(ratio <= 1.0, f"mesh x off the per-shard solves by {ratio:.3f}x "
                         "the strong-convexity bound")
    records = [_record(
        "mesh_instance_parallel", comp, run, ratio, 1.0,
        "||x_mesh - x_shard|| over sqrt(2 gap/lambda_min) summed for both "
        "points (strong convexity), f64 on each sampled instance: both are "
        "certified, neither is the other's reference",
        devices=devices, batch=B, per_card=per_card, converged=n_conv,
        certified_per_s=n_conv / run, bit_exact_vs_shards=bit_exact,
        max_rel_diff_vs_shards=rel, sampled=len(idx),
        sampled_f64_gap_max=float(gaps.max()), bytes_before=before,
        mesh_solve_peak_bytes=peaks)]

    # mesh checkpoint: cut halfway, resume over the mesh
    cut = dataclasses.replace(cfg, max_iter=50)
    _, mid = solve(cut, return_state=True)
    _check(not bool(jnp.all(mid.done)), "nothing live at the cut")
    resumed, r_comp, r_run = _timed(lambda: solve(cfg, state0=mid))
    r_exact = bool(np.array_equal(np.asarray(resumed.x), x_mesh))
    r_err = float(np.max(np.abs(np.asarray(resumed.x) - x_mesh))
                  / np.max(np.abs(x_mesh)))
    _check(r_err <= 1e-5, f"mesh resume off the straight run by {r_err:.3e}")
    records.append(_record(
        "mesh_resume", r_comp, r_run, r_err, 1e-5,
        "same shards, same per-shard program: expected bit-exact; 1e-5 of "
        "max|x| is the floor", devices=devices, bit_exact=r_exact,
        cut_iter=50))
    return records


def phase_mesh_dense(rows_per_card: int, n: int, iters: int, devices,
                     admm_iters: int, seed: int = 0) -> list[dict]:
    """One dense lasso with A row-sharded (one psum per iteration over the
    cards), then column-sharded, through ``DistributedLeastSquares`` and
    ``fista``, against the single-device ``LeastSquares`` solve with the
    same L; then ``consensus_admm`` row-sharded against its single-device
    result."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from fastoptsolver_tpu.parallel import (
        MODEL_AXIS,
        DistributedLeastSquares,
        consensus_admm,
        make_mesh,
    )
    from fastoptsolver_tpu.problems import LeastSquares
    from fastoptsolver_tpu.solvers import ADMMConfig, FISTAConfig, fista

    mesh = make_mesh(batch=1, model=len(devices), devices=devices)
    x_true = np.where(np.random.default_rng(seed).random(n) < 0.05, 3.0, 0.0)
    xt = np.asarray(x_true, np.float32)

    def block(k):
        ka, kn = jax.random.split(k)
        A = jax.random.normal(ka, (rows_per_card, n), jnp.float32) / np.sqrt(n)
        return A, A @ xt + 0.1 * jax.random.normal(kn, (rows_per_card,))

    parts = _shards(block, devices, jax.random.PRNGKey(seed))
    A = _assemble([p[0] for p in parts], mesh, P(MODEL_AXIS, None), 0)
    b = _assemble([p[1] for p in parts], mesh, P(MODEL_AXIS), 0)
    a1 = 0.1 * float(jnp.max(jnp.abs(A.T @ b)))

    dev0 = devices[0]
    A1, b1 = jax.device_put(A, dev0), jax.device_put(b, dev0)
    single = LeastSquares(A=A1, b=b1, alpha1=jnp.float32(a1),
                          alpha2=jnp.float32(0.0))
    from fastoptsolver_tpu.ops import estimate_lipschitz

    L = float(estimate_lipschitz(A1, jax.random.PRNGKey(seed)))
    cfg = FISTAConfig(max_iter=iters)
    solve = jax.jit(lambda p: fista(p, cfg, L=L).x)
    x_ref = np.asarray(solve(single))
    scale = np.max(np.abs(x_ref))
    records = []
    for layout in ("row", "col"):
        dist = DistributedLeastSquares.create(A, b, mesh, "lasso", a1, 0.0,
                                              layout=layout)
        x, comp, run = _timed(lambda: solve(dist))
        err = float(np.max(np.abs(np.asarray(x) - x_ref)) / scale)
        tol = 1e-4
        _check(err <= tol, f"{layout}-sharded x off by {err:.3e}")
        records.append(_record(
            f"mesh_{layout}_sharded", comp, run, err, tol,
            "max|x_dist - x_single| / max|x_single| with the same L and "
            "iteration count: only the psum's summation order differs",
            devices=devices, m=int(A.shape[0]), n=n, iters=iters))

    acfg = ADMMConfig(max_iter=admm_iters)
    mesh1 = make_mesh(batch=1, model=1, devices=[dev0])
    ref = consensus_admm(A1, b1, mesh1, "lasso", a1, 0.0, config=acfg)
    res, comp, run = _timed(lambda: consensus_admm(
        A, b, mesh, "lasso", a1, 0.0, config=acfg))
    _check(bool(res.converged) and bool(ref.converged),
           "consensus ADMM did not meet its residual tolerances")
    x1 = np.asarray(ref.x)
    err = float(np.max(np.abs(np.asarray(res.x) - x1)) / np.max(np.abs(x1)))
    tol = 1e-3
    _check(err <= tol, f"consensus x off the single-device ADMM by {err:.3e}")
    records.append(_record(
        "mesh_consensus_admm", comp, run, err, tol,
        "max|x_N - x_1| / max|x_1|: both stop at ADMM residual tolerances "
        "(abstol 1e-7, reltol 1e-6), not at a common iterate",
        devices=devices, iters=int(res.n_iters), iters_single=int(ref.n_iters)))
    return records


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

ONE_CARD = "one_card"
FOUR_CARDS = "four_cards"


def phases(mode: str, devices) -> list:
    """``(name, thunk)`` for each phase ``mode`` runs, at real sizes."""
    if mode == FOUR_CARDS:
        return [
            ("mesh_batch", lambda: phase_mesh_batch(
                262144, 1000, devices, n_sample=256)),
            ("mesh_dense", lambda: phase_mesh_dense(
                131072, 2048, 300, devices, admm_iters=500)),
        ]
    return [
        ("precision", lambda: phase_precision(4096)),
        ("df32", lambda: phase_df32(65537)),
        ("resume", lambda: phase_resume(65536, 1000)),
        ("headline_batch", lambda: phase_headline_batch(
            262144, 1000, n_sample=256, n_oracle=8)),
        ("wide_n_batch", lambda: phase_wide_n_batch(128, 2e9, n_sample=64)),
        ("cv_grid", lambda: phase_cv_grid(4000, 200, n_sample=60)),
        ("dense_and_stream", lambda: phase_dense_and_stream(
            131072, 2048, 300, 2**21, 1280, 65536)),
    ]


def last_line(device: dict) -> str:
    return json.dumps({"ok": True, "device": device})


def main(argv=None, smi_query=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the paths that span four cards")
    args = ap.parse_args(argv)
    mode = FOUR_CARDS if args.four_cards else ONE_CARD

    from fastoptsolver_tpu.bench.device import (
        parse_nvidia_smi,
        query_nvidia_smi,
        require_gpu,
    )

    # the card, named before JAX touches it
    smi = (smi_query or query_nvidia_smi)()
    parse_nvidia_smi(smi)
    print(smi, flush=True)

    import jax

    from fastoptsolver_tpu.utils.compile_cache import configure_compile_cache

    device = require_gpu(jax.devices())
    want = 4 if mode == FOUR_CARDS else 1
    if device["count"] < want:
        raise RuntimeError(f"{mode} needs {want} GPUs, found {device['count']}")
    devices = jax.devices()[:want]
    print(f"jax {jax.__version__}; device_kind {device['kind']}; "
          f"compile cache {configure_compile_cache()}", flush=True)
    for _, thunk in phases(mode, devices):
        for rec in thunk():
            print(json.dumps(rec, default=str), flush=True)
    print(last_line(device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
