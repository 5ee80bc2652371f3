"""The batched Gram-form driver (batch/fista_gram.py) against the float64
NumPy oracle of the reference recurrences (tests/oracle_np.py).

Step for step over every momentum mode × Armijo on/off × feature counts from
the headline's n=5 to past the old wide-n window (n=200), with a batch that
is not a multiple of 128; then NaN-lane quarantine, checkpoint/resume per
momentum mode, and the two Armijo findings: the recurrence is chaotic
outside the decisive regime, and it stalls outright on the wide-n scenarios.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

import jax
import jax.numpy as jnp
import pytest

from fastoptsolver_tpu.batch.fista_gram import (
    BatchFISTAConfig,
    fista_gram_batch,
    make_gram_batch,
)
from oracle_np import fista_np

MOMENTA = {
    "nesterov": {},
    "delta": {"momentum": "delta", "delta": 3.0},
    "restart": {"adaptive_restart": True},
    "greedy": {"momentum": "greedy"},
}
# greedy momentum controls τ itself, so it has no Armijo variant
CASES = [(mom, armijo, n) for mom in MOMENTA for armijo in (False, True)
         for n in (5, 20, 96, 128, 200) if not (armijo and mom == "greedy")]
B = 130  # one past a multiple of 128
LANES = (0, 64, B - 1)
ITERS = 12
# Armijo's first trial at 4/L fails on every lane, so the search shrinks τ
# with wide margins (the decisive regime). Near the optimum the reference's
# C·gradᵀΔ test fails on rounding alone and collapses τ (the stall pinned
# below), where decisions flip between any two implementations; the Armijo
# cases therefore stop after ARMIJO_ITERS steps, before that regime.
ARMIJO_T0 = 4.0
ARMIJO_ITERS = 5


def _problem(n: int, seed: int):
    rng = np.random.default_rng(seed)
    m = n + 40
    A = rng.normal(size=(B, m, n)) / np.sqrt(n)
    xt = np.zeros((B, n))
    xt[:, : max(1, n // 8)] = 3.0 * rng.normal(size=(B, max(1, n // 8)))
    b = np.einsum("bmn,bn->bm", A, xt) + 0.1 * rng.normal(size=(B, m))
    a1 = 0.1 * np.abs(np.einsum("bmn,bm->bn", A, b)).max(axis=1)
    L = np.array([np.linalg.eigvalsh(Ai.T @ Ai)[-1] for Ai in A])
    return A, b, a1, L


@functools.partial(jax.jit, static_argnames="cfg")
def _driver(A, b, a1, L, cfg, state0=None):
    gb = dataclasses.replace(make_gram_batch(A, b, a1, 0.0), L=L)
    return fista_gram_batch(gb, cfg, state0=state0, return_state=True)


def _oracle(A, b, a1, L, i, iters, mom, armijo):
    kw = {k: v for k, v in MOMENTA[mom].items() if k != "momentum"}
    return fista_np(A[i], b[i], a1[i], 0.0, L[i], max_iter=iters,
                    backtracking=armijo,
                    t_init_factor=ARMIJO_T0 if armijo else 1.0,
                    greedy=mom == "greedy", **kw)[0]


def _cfg(mom, armijo, iters):
    # max_backtracks as the oracle's search (oracle_np._armijo)
    return BatchFISTAConfig(max_iter=iters, check_every=0,
                            backtracking=armijo, max_backtracks=60,
                            t_init_factor=ARMIJO_T0 if armijo else 1.0,
                            **MOMENTA[mom])


@pytest.mark.parametrize("mom,armijo,n", CASES)
def test_driver_matches_f64_oracle(mom, armijo, n):
    A, b, a1, L = _problem(n, seed=n)
    iters = ARMIJO_ITERS if armijo else ITERS
    res, fin = _driver(A, b, a1, L, _cfg(mom, armijo, iters))
    assert res.x.shape == (B, n)
    for i in LANES:
        np.testing.assert_allclose(
            np.asarray(res.x[i]), _oracle(A, b, a1, L, i, iters, mom, armijo),
            rtol=1e-9, atol=1e-11, err_msg=f"lane {i}")
    if armijo:  # the search fired: most lanes shrank their 4/L start
        assert np.mean(np.asarray(fin.tau) < ARMIJO_T0 / L) > 0.5


@pytest.mark.parametrize("mom", list(MOMENTA))
def test_driver_resume_matches_straight_and_oracle(mom):
    """A run cut at 5 iterations and resumed from its BatchState to 12 is
    the straight 12-iteration run, and both are the oracle's trajectory:
    every per-lane row (t, τ, ‖Δx‖, ‖x₁ − x₀‖) survives the cut."""
    A, b, a1, L = _problem(20, seed=7)
    straight, _ = _driver(A, b, a1, L, _cfg(mom, False, ITERS))
    _, mid = _driver(A, b, a1, L, _cfg(mom, False, 5))
    assert int(mid.k) == 5
    resumed, fin = _driver(A, b, a1, L, _cfg(mom, False, ITERS), state0=mid)
    assert int(fin.k) == ITERS
    np.testing.assert_allclose(np.asarray(resumed.x), np.asarray(straight.x),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(
        np.asarray(resumed.x[3]), _oracle(A, b, a1, L, 3, ITERS, mom, False),
        rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("field", ["Q", "c"])
def test_driver_quarantines_nan_lane(field):
    """An instance with corrupt data (NaN) is flagged failed and does not
    hold the batch until max_iter; the healthy instances still certify."""
    A, b, a1, _ = _problem(5, seed=3)
    gb = make_gram_batch(jnp.asarray(A, jnp.float32),
                         jnp.asarray(b, jnp.float32), a1, 0.0)
    bad = 17
    if field == "Q":
        gb = dataclasses.replace(gb, Q=gb.Q.at[0, 0, bad].set(jnp.nan))
    else:
        gb = dataclasses.replace(gb, c=gb.c.at[1, bad].set(jnp.nan))
    cfg = BatchFISTAConfig(max_iter=4000, check_every=20, rel_gap_tol=1e-5)
    res = fista_gram_batch(gb, cfg)
    failed = np.asarray(res.failed)
    conv = np.asarray(res.converged)
    healthy = np.arange(B) != bad
    assert failed[bad] and not conv[bad]
    assert conv[healthy].all() and not failed[healthy].any()
    assert int(res.n_iters_total) < 4000  # quarantine prevented a full spin


def _f32_problem(seed=0, B=256, m=150, n=5, alpha=0.5):
    rng = np.random.default_rng(seed)
    A = jnp.asarray(rng.normal(size=(B, m, n)), jnp.float32)
    xt = np.zeros((B, n), np.float32)
    xt[:, :2] = rng.normal(size=(B, 2))
    b = jnp.einsum("bmn,bn->bm", A, jnp.asarray(xt))
    return A, b, make_gram_batch(A, b, alpha, 0.0)


def test_armijo_chaos_is_intrinsic_not_kernel_error():
    """Outside the decisive regime the Armijo recurrence amplifies
    rounding-level differences into trajectory divergence (τ never grows:
    one flipped borderline accept halves a lane's step for good). Pin that
    this is a property of the recurrence: the f32 driver under a 1e-7
    relative perturbation of c deviates from itself by at least the scale
    it deviates from the f64 oracle, while fixed-step FISTA (same
    perturbation, no search) stays tight."""
    A, b, gb = _f32_problem()
    gb_pert = dataclasses.replace(gb, c=gb.c * (1.0 + 1e-7))
    cfg = BatchFISTAConfig(max_iter=60, check_every=0, backtracking=True)
    ref = np.asarray(fista_gram_batch(gb, cfg).x)
    pert = np.asarray(fista_gram_batch(gb_pert, cfg).x)
    A64 = np.asarray(A, np.float64)
    b64 = np.asarray(b, np.float64)
    L = np.asarray(gb.L, np.float64)
    lanes = range(0, 256, 16)
    oracle = np.stack([
        fista_np(A64[i], b64[i], 0.5, 0.0, L[i], backtracking=True,
                 max_iter=60)[0] for i in lanes])
    d_oracle = np.abs(ref[list(lanes)] - oracle).max()
    d_self = np.abs(pert - ref).max()
    assert d_oracle <= 10.0 * max(d_self, 1e-6)
    # fixed-step control: no search, no chaos
    cfg_f = BatchFISTAConfig(max_iter=60, check_every=0)
    d_fixed = np.abs(
        np.asarray(fista_gram_batch(gb_pert, cfg_f).x)
        - np.asarray(fista_gram_batch(gb, cfg_f).x)
    ).max()
    assert d_fixed < 1e-5


def test_wide_n_armijo_stall_matches_reference_oracle():
    """On the wide-n bench scenarios (bench/wide_n.py) the reference's
    Armijo recurrence stalls outright — its C·gradᵀΔ accept test collapses
    the never-growing per-lane τ — while fixed-step FISTA converges on the
    same instances. Pinned against the f64 oracle of the reference
    recurrence, with directional assertions (the trajectory is chaotic at
    accept/reject boundaries, so exact thresholds would pin one seed's
    rounding, not the behaviour)."""
    from fastoptsolver_tpu.bench.wide_n import _build_problems

    Bw, m, n, iters = 8, 256, 128, 400
    A, b, a1 = _build_problems(jax.random.PRNGKey(0), Bw, m, n)

    def relgap64(Ai, bi, alpha, x):
        r = Ai @ x - bi
        s = max(1.0, np.max(np.abs(Ai.T @ r)) / alpha)
        primal = 0.5 * r @ r + alpha * np.sum(np.abs(x))
        dual = -0.5 * (r @ r) / s**2 - (r @ bi) / s
        return (primal - dual) / max(1.0, abs(primal))

    # oracle, one instance, f64: Armijo ends orders of magnitude further
    # from optimal than fixed-step on the same instance
    Ai = np.asarray(A[0], np.float64)
    bi = np.asarray(b[0], np.float64)
    alpha = float(a1[0])
    L = float(np.linalg.eigvalsh(Ai.T @ Ai)[-1])
    x_bt, _ = fista_np(Ai, bi, alpha, 0.0, L, backtracking=True,
                       max_iter=iters)
    x_fx, _ = fista_np(Ai, bi, alpha, 0.0, L, backtracking=False,
                       max_iter=iters)
    g_bt = relgap64(Ai, bi, alpha, x_bt)
    g_fx = relgap64(Ai, bi, alpha, x_fx)
    assert g_bt > 100.0 * g_fx, (g_bt, g_fx)

    # the driver reproduces the split on the batch: most Armijo lanes stall
    # above the tolerance, most fixed-step lanes certify
    gb = make_gram_batch(A, b, a1, 0.0)
    cfg = BatchFISTAConfig(max_iter=iters, check_every=50,
                           rel_gap_tol=1e-4, backtracking=True)
    res = fista_gram_batch(gb, cfg)
    res_fx = fista_gram_batch(gb, dataclasses.replace(cfg, backtracking=False))
    assert int(jnp.sum(res.converged)) < Bw // 2
    assert int(jnp.sum(res_fx.converged)) > Bw // 2
    assert float(jnp.median(res.rel_gap)) > 10.0 * float(
        jnp.median(res_fx.rel_gap))
