"""Batched-vs-single equivalence (SURVEY.md §4: 'vmapped solve of N instances
must tolerance-match N serial solves') and the Gram-form batched fast path."""
import numpy as np
import jax
import jax.numpy as jnp

from fastoptsolver_tpu.batch import (
    stack_problems,
    solve_batch,
    batch_lipschitz,
    make_gram_batch,
    fista_gram_batch,
)
from fastoptsolver_tpu.batch.fista_gram import BatchFISTAConfig
from fastoptsolver_tpu.ops import lasso_duality_gap, relative_gap
from fastoptsolver_tpu.problems import LeastSquares, generate_boston_like
from fastoptsolver_tpu.solvers import FISTAConfig, ISTAConfig, fista
from oracle_np import fista_np, power_L, objective_np


def _problems(n_inst=5, reg="lasso", a1=0.5, a2=0.0):
    out = []
    for s in range(n_inst):
        A, b, _ = generate_boston_like(m=120, seed=s, noise_std=1.0, rho1=0.5, rho2=0.7)
        A = (A - A.mean(0)) / A.std(0)
        out.append(LeastSquares.create(A, b, reg, a1, a2, dtype=jnp.float64))
    return out


def test_vmapped_fista_matches_serial():
    probs = _problems(5)
    batchp = stack_problems(probs)
    Ls = batch_lipschitz(batchp)
    cfg = FISTAConfig(max_iter=80)
    res = solve_batch(batchp, "fista", cfg, L=Ls)
    for i, p in enumerate(probs):
        single = fista(p, cfg, L=Ls[i])
        np.testing.assert_allclose(
            np.asarray(res.x[i]), np.asarray(single.x), rtol=1e-10, atol=1e-12
        )
        assert int(res.n_iters[i]) == int(single.n_iters)


def test_vmapped_per_instance_stopping():
    # different noise ⇒ different convergence speed; per-instance tol stopping
    # must match each instance's serial run exactly
    probs = []
    for i, noise in enumerate([0.1, 1.0, 5.0, 10.0]):
        A, b, _ = generate_boston_like(m=120, seed=i, noise_std=noise, rho1=0.5, rho2=0.7)
        A = (A - A.mean(0)) / A.std(0)
        probs.append(LeastSquares.create(A, b, "lasso", 0.5, 0.0, dtype=jnp.float64))
    batchp = stack_problems(probs)
    Ls = batch_lipschitz(batchp)
    cfg = FISTAConfig(max_iter=400, tol=1e-6)
    res = solve_batch(batchp, "fista", cfg, L=Ls)
    iters = [int(v) for v in res.n_iters]
    assert len(set(iters)) > 1  # genuinely different stopping points
    for i, p in enumerate(probs):
        single = fista(p, cfg, L=Ls[i])
        assert iters[i] == int(single.n_iters)
        np.testing.assert_allclose(
            np.asarray(res.x[i]), np.asarray(single.x), rtol=1e-9, atol=1e-12
        )


def test_vmapped_ista_and_history():
    probs = _problems(3)
    batchp = stack_problems(probs)
    Ls = batch_lipschitz(batchp)
    cfg = ISTAConfig(max_iter=40)
    res = solve_batch(batchp, "ista", cfg, history=True, L=Ls)
    assert res.history.obj.shape == (3, 40)
    # objectives decrease for every instance
    objs = np.asarray(res.history.obj)
    assert np.all(np.diff(objs, axis=1) <= 1e-9)


def test_duality_gap_certifies_suboptimality():
    p = _problems(1)[0]
    L = power_L(np.asarray(p.A), np.ones(5))
    # crude iterate: gap must upper-bound true suboptimality
    mid = fista(p, FISTAConfig(max_iter=5), L=jnp.asarray(L))
    far = fista(p, FISTAConfig(max_iter=2000), L=jnp.asarray(L))
    f_star = float(p.objective(far.x))
    for it in (mid, far):
        gap = float(lasso_duality_gap(p, it.x))
        subopt = float(p.objective(it.x)) - f_star
        assert gap >= subopt - 1e-9
    # gap shrinks to ~0 at convergence
    assert float(lasso_duality_gap(p, far.x)) < 1e-8 * float(p.objective(far.x))
    # gram-form gap agrees with dense-form gap
    g_dense = float(lasso_duality_gap(p, mid.x))
    g_gram = float(lasso_duality_gap(p.to_gram(), mid.x))
    np.testing.assert_allclose(g_gram, g_dense, rtol=1e-6)


def test_gap_ridge_strong_convexity_bound():
    p = _problems(1, reg="ridge", a1=0.0, a2=2.0)[0]
    A, b = np.asarray(p.A), np.asarray(p.b)
    x_star = np.linalg.solve(A.T @ A + 2.0 * np.eye(5), A.T @ b)
    f_star = objective_np(x_star, A, b, 0.0, 2.0)
    x = jnp.asarray(x_star + 0.1 * np.ones(5))
    gap = float(lasso_duality_gap(p, x))
    subopt = float(p.objective(x)) - f_star
    assert gap >= subopt - 1e-10


def test_gram_batch_solver_matches_oracle():
    n_inst = 6
    As, bs = [], []
    for s in range(n_inst):
        A, b, _ = generate_boston_like(m=120, seed=s, noise_std=1.0, rho1=0.5, rho2=0.7)
        A = (A - A.mean(0)) / A.std(0)
        As.append(A)
        bs.append(b)
    A3 = jnp.asarray(np.stack(As))
    b2 = jnp.asarray(np.stack(bs))
    gb = make_gram_batch(A3, b2, alpha1=0.5, alpha2=0.0, dtype=jnp.float64)
    res = fista_gram_batch(gb, BatchFISTAConfig(max_iter=400, check_every=0))
    for i in range(n_inst):
        L_i = float(gb.L[i])
        x_ref, _ = fista_np(As[i], bs[i], 0.5, 0.0, L_i, max_iter=400)
        np.testing.assert_allclose(np.asarray(res.x[i]), x_ref, rtol=1e-6, atol=1e-9)


def test_gram_batch_convergence_counting():
    n_inst = 8
    As, bs = [], []
    for s in range(n_inst):
        A, b, _ = generate_boston_like(m=120, seed=s, noise_std=1.0, rho1=0.5, rho2=0.7)
        A = (A - A.mean(0)) / A.std(0)
        As.append(A)
        bs.append(b)
    gb = make_gram_batch(
        jnp.asarray(np.stack(As)), jnp.asarray(np.stack(bs)),
        alpha1=0.5, alpha2=0.0, dtype=jnp.float64,
    )
    cfg = BatchFISTAConfig(max_iter=2000, check_every=10, rel_gap_tol=1e-6)
    res = fista_gram_batch(gb, cfg)
    assert bool(res.converged.all())
    assert np.all(np.asarray(res.rel_gap) <= 1e-6)
    # iteration counts are multiples of nothing in particular but bounded
    assert np.all(np.asarray(res.iters) <= int(res.n_iters_total))
    # certified: true suboptimality vs a long run is within the claimed gap
    for i in range(0, n_inst, 3):
        p = LeastSquares.create(As[i], bs[i], "lasso", 0.5, 0.0, dtype=jnp.float64)
        ref = fista(p, FISTAConfig(max_iter=5000), L=gb.L[i])
        f_star = float(p.objective(ref.x))
        f_got = float(p.objective(jnp.asarray(res.x[i])))
        assert (f_got - f_star) / max(f_star, 1.0) <= 1.1e-6


def test_gram_batch_per_instance_alphas():
    A, b, _ = generate_boston_like(m=120, seed=0, noise_std=1.0, rho1=0.5, rho2=0.7)
    A = (A - A.mean(0)) / A.std(0)
    alphas = np.array([0.1, 1.0, 10.0])
    A3 = jnp.asarray(np.stack([A] * 3))
    b2 = jnp.asarray(np.stack([b] * 3))
    gb = make_gram_batch(A3, b2, alpha1=jnp.asarray(alphas), alpha2=0.0, dtype=jnp.float64)
    res = fista_gram_batch(gb, BatchFISTAConfig(max_iter=600, check_every=0))
    # larger alpha ⇒ sparser/smaller-norm solution
    norms = np.abs(np.asarray(res.x)).sum(axis=1)
    assert norms[0] > norms[1] > norms[2]
    # each matches its own oracle run
    for i, a1 in enumerate(alphas):
        x_ref, _ = fista_np(A, b, a1, 0.0, float(gb.L[i]), max_iter=600)
        np.testing.assert_allclose(np.asarray(res.x[i]), x_ref, rtol=1e-6, atol=1e-9)


def test_float32_gap_certification_is_trustworthy():
    """bench.py certifies 1e-6 relative gap in float32 — validate that the
    f32 certificate implies true (float64-measured) suboptimality at the
    claimed level on the bench problem distribution."""
    n_inst = 32
    As, bs = [], []
    for s in range(n_inst):
        A, b, _ = generate_boston_like(
            m=1000, seed=s, noise_std=[0.5, 1.0, 2.0, 5.0][s % 4], rho1=0.5, rho2=0.9
        )
        A = (A - A.mean(0)) / A.std(0)
        As.append(A)
        bs.append(b)
    A3 = np.stack(As)
    b2 = np.stack(bs)
    a1 = 0.1 * np.abs(np.einsum("bmi,bm->bi", A3, b2)).max(axis=1)

    gb32 = make_gram_batch(
        jnp.asarray(A3, jnp.float32), jnp.asarray(b2, jnp.float32),
        alpha1=jnp.asarray(a1, jnp.float32), alpha2=0.0,
    )
    res = fista_gram_batch(
        gb32, BatchFISTAConfig(max_iter=1000, check_every=25, rel_gap_tol=1e-6)
    )
    assert bool(res.converged.all())

    # float64 ground truth per instance
    for i in range(n_inst):
        p = LeastSquares.create(A3[i], b2[i], "lasso", float(a1[i]), 0.0, dtype=jnp.float64)
        ref = fista(p, FISTAConfig(max_iter=4000), L=jnp.asarray(float(gb32.L[i])))
        f_star = float(p.objective(ref.x))
        f_got = float(p.objective(jnp.asarray(np.asarray(res.x[i], np.float64))))
        rel = (f_got - f_star) / max(f_star, 1.0)
        assert rel <= 3e-6, (i, rel)


def test_greedy_fista_certifies_and_matches_nesterov():
    """Greedy FISTA (arXiv:1811.01430) must certify every lane at the same
    tolerance and land on the same solutions as plain Nesterov FISTA."""
    rng = np.random.default_rng(3)
    B, m, n = 64, 300, 8
    A = jnp.asarray(rng.normal(size=(B, m, n)), jnp.float32)
    xt = np.zeros((B, n), np.float32)
    xt[:, :3] = rng.normal(size=(B, 3))
    b = jnp.einsum("bmn,bn->bm", A, jnp.asarray(xt)) + 0.1 * jnp.asarray(
        rng.normal(size=(B, m)), jnp.float32
    )
    a1 = 0.1 * jnp.max(jnp.abs(jnp.einsum("bmi,bm->bi", A, b)), axis=1)
    gb = make_gram_batch(A, b, alpha1=a1, alpha2=0.0)
    r_nes = fista_gram_batch(
        gb, BatchFISTAConfig(max_iter=2000, check_every=25, rel_gap_tol=1e-6)
    )
    r_grd = fista_gram_batch(
        gb,
        BatchFISTAConfig(
            max_iter=2000, check_every=25, rel_gap_tol=1e-6, momentum="greedy"
        ),
    )
    assert bool(r_grd.converged.all())
    np.testing.assert_allclose(
        np.asarray(r_grd.x), np.asarray(r_nes.x), atol=2e-3
    )


def test_greedy_safeguard_recovers_stuck_lanes():
    """A lane whose overshot step limit-cycles must be rescued by the
    gap-based tau decay (it certifies instead of spinning to max_iter)."""
    rng = np.random.default_rng(0)
    # highly correlated design: the regime where the xi/L overshoot cycles
    B, m, n = 16, 200, 12
    z = rng.normal(size=(B, m, 1))
    A = jnp.asarray(z + 0.05 * rng.normal(size=(B, m, n)), jnp.float32)
    b = jnp.asarray(rng.normal(size=(B, m)), jnp.float32)
    a1 = 0.2 * jnp.max(jnp.abs(jnp.einsum("bmi,bm->bi", A, b)), axis=1)
    gb = make_gram_batch(A, b, alpha1=a1, alpha2=0.0)
    res = fista_gram_batch(
        gb,
        BatchFISTAConfig(
            max_iter=3000, check_every=25, rel_gap_tol=1e-5, momentum="greedy"
        ),
    )
    assert bool(res.converged.all()), np.asarray(res.rel_gap)


def test_greedy_config_validation():
    import pytest

    with pytest.raises(ValueError):
        BatchFISTAConfig(momentum="greedy", greedy_xi=2.5)
    with pytest.raises(ValueError):
        BatchFISTAConfig(momentum="bogus")


def test_gram_batch_backtracking_matches_vmapped_fista():
    """Masked per-lane Armijo in fista_gram_batch reproduces the reference
    backtracking semantics (solvers/fista.py via solve_batch) step-for-step:
    same Armijo constant/shrink, per-lane persistent never-growing tau."""
    import dataclasses as _dc

    from fastoptsolver_tpu.batch import make_gram_batch, solve_batch, stack_problems
    from fastoptsolver_tpu.batch.fista_gram import BatchFISTAConfig, fista_gram_batch
    from fastoptsolver_tpu.problems import LeastSquares, generate_boston_like
    from fastoptsolver_tpu.solvers import FISTAConfig

    As, bs, probs = [], [], []
    for s in range(6):
        A, b, _ = generate_boston_like(m=150, seed=s, noise_std=1.0, rho1=0.5, rho2=0.7)
        A = (A - A.mean(0)) / A.std(0)
        As.append(A.astype(np.float64))
        bs.append(b.astype(np.float64))
        probs.append(LeastSquares.create(A, b, "lasso", 0.5, 0.0, dtype=jnp.float64))
    # exact per-instance L so both paths start from identical tau
    L = jnp.asarray([
        float(np.linalg.eigvalsh(A.T @ A)[-1]) for A in As
    ], jnp.float64)
    tf = 2.0  # t_init 2/L: the Armijo search must actually shrink
    gb = make_gram_batch(
        jnp.asarray(np.stack(As)), jnp.asarray(np.stack(bs)),
        alpha1=0.5, alpha2=0.0, dtype=jnp.float64,
    )
    gb = _dc.replace(gb, L=L)

    def both(K):
        ref = solve_batch(
            stack_problems(probs), "fista",
            FISTAConfig(max_iter=K, backtracking=True, t_init_factor=tf), L=L,
        )
        got = fista_gram_batch(
            gb, BatchFISTAConfig(max_iter=K, check_every=0, backtracking=True,
                                 t_init_factor=tf),
        )
        return ref, got

    # Step-for-step while τ is sane. (Near convergence the reference's
    # never-growing τ collapses toward 0 — rounding makes the Armijo test
    # fail repeatedly once g(x⁺)−g(y) is at the f64 floor — and accept/reject
    # flips make late iterates chaotic at the ~1e-6 level in BOTH
    # implementations; that regime is pinned loosely below.)
    ref, got = both(15)
    np.testing.assert_allclose(np.asarray(got.x), np.asarray(ref.x),
                               rtol=1e-9, atol=1e-11)
    # the search engaged on some lanes (shrunk below the 2/L trial start)
    # while others accepted first-try — both branches exercised
    shrunk = np.asarray(ref.final_tau) < 0.99 * tf / np.asarray(L)
    assert shrunk.any() and not shrunk.all()
    # chaotic-τ tail: same optimum, loose tolerance
    ref, got = both(60)
    np.testing.assert_allclose(np.asarray(got.x), np.asarray(ref.x),
                               rtol=1e-4, atol=1e-6)


def test_gram_batch_backtracking_rejects_greedy():
    import pytest

    from fastoptsolver_tpu.batch.fista_gram import BatchFISTAConfig

    with pytest.raises(ValueError):
        BatchFISTAConfig(backtracking=True, momentum="greedy")


# ---------------------------------------------------------------------------
# solve_lasso_batch — the routed one-call surface (batch/api.py)
# ---------------------------------------------------------------------------


def _routed_inputs(B=192, m=256, n=5, seed=11):
    rng = np.random.default_rng(seed)
    A = jnp.asarray(rng.normal(size=(B, m, n)), jnp.float32)
    xt = np.zeros((B, n), np.float32)
    xt[:, : max(1, n // 3)] = rng.normal(size=(B, max(1, n // 3)))
    b = jnp.einsum("bmn,bn->bm", A, jnp.asarray(xt))
    a1 = 0.1 * jnp.max(jnp.abs(jnp.einsum("bmn,bm->bn", A, b)), axis=1)
    return A, b, a1


def test_solve_lasso_batch_xla_and_kernel_agree():
    """The one-call surface is exactly the Gram precompute plus the driver
    (the XLA path is the only execution path), and every instance
    certifies."""
    from fastoptsolver_tpu.batch import solve_lasso_batch
    from fastoptsolver_tpu.batch.fista_gram import BatchFISTAConfig

    A, b, a1 = _routed_inputs()
    # 5e-6, not 1e-6: a handful of random instances at this scale sit at
    # the f32 Gram-form gap-evaluation floor (~1.1e-6) — converged but not
    # certifiable tighter in f32 (the df32/f64 gap path exists for that)
    cfg = BatchFISTAConfig(max_iter=2000, check_every=25, rel_gap_tol=5e-6)
    res = solve_lasso_batch(A, b, a1, cfg=cfg)
    ref = fista_gram_batch(make_gram_batch(A, b, a1, 0.0), cfg)
    assert bool(np.asarray(res.converged).all())
    np.testing.assert_array_equal(np.asarray(res.x), np.asarray(ref.x))
    np.testing.assert_array_equal(np.asarray(res.iters), np.asarray(ref.iters))


def test_solve_lasso_batch_feature_major_matches_instance_major():
    from fastoptsolver_tpu.batch import solve_lasso_batch
    from fastoptsolver_tpu.batch.fista_gram import BatchFISTAConfig

    A, b, a1 = _routed_inputs()
    cfg = BatchFISTAConfig(max_iter=600, check_every=25, rel_gap_tol=5e-6)
    res_im = solve_lasso_batch(A, b, a1, cfg=cfg)
    res_fm = solve_lasso_batch(jnp.transpose(A, (2, 1, 0)),
                               jnp.transpose(b, (1, 0)), a1, cfg=cfg,
                               feature_major=True)
    np.testing.assert_allclose(np.asarray(res_fm.x), np.asarray(res_im.x),
                               rtol=1e-5, atol=1e-6)


def test_solve_lasso_batch_routing_guards():
    """Every configuration runs on the one driver path: Armijo backtracking
    and FISTA-Δ with adaptive restart both go through; the removed engine
    options fail loudly as unknown keywords instead of being ignored; a
    state of the wrong type is refused."""
    import pytest

    from fastoptsolver_tpu.batch import solve_lasso_batch
    from fastoptsolver_tpu.batch.fista_gram import BatchFISTAConfig

    A, b, a1 = _routed_inputs(B=64, m=256, n=5)
    # reference Armijo semantics (smooth-only test, never-growing τ) stall
    # on many scenarios, so only finiteness is asserted — pinned as the
    # reference's own behaviour by tests/test_batch_oracle_grid.py
    btcfg = BatchFISTAConfig(max_iter=200, check_every=25, rel_gap_tol=5e-6,
                             backtracking=True)
    res = solve_lasso_batch(A, b, a1, cfg=btcfg)
    assert np.isfinite(np.asarray(res.rel_gap)).all()
    assert int(res.n_iters_total) > 0
    rng = np.random.default_rng(0)
    Aw = jnp.asarray(rng.normal(size=(8, 16, 256)), jnp.float32)
    bw = jnp.asarray(rng.normal(size=(8, 16)), jnp.float32)
    res_w = solve_lasso_batch(Aw, bw, 0.5, cfg=btcfg)  # n > m, wide
    assert res_w.x.shape == (8, 256)
    assert np.isfinite(np.asarray(res_w.rel_gap)).all()
    for removed in ({"backend": "kernel"}, {"interpret": True}):
        with pytest.raises(TypeError):
            solve_lasso_batch(A, b, a1, **removed)
    with pytest.raises(TypeError, match="BatchState"):
        solve_lasso_batch(A, b, a1, state0=object())
    dcfg = BatchFISTAConfig(max_iter=600, check_every=25, rel_gap_tol=5e-6,
                            momentum="delta", delta=3.0,
                            adaptive_restart=True)
    res_d = solve_lasso_batch(A, b, a1, cfg=dcfg)
    assert np.isfinite(np.asarray(res_d.rel_gap)).all()


def test_solve_gram_batch_resume_routes_by_state_type():
    """Checkpoint/resume through the Gram surface: straight == split +
    resume; a state cut by ``solve_lasso_batch`` resumes here too (one
    state type for every path); anything else is refused."""
    import pytest

    from fastoptsolver_tpu.batch import (
        make_gram_batch,
        solve_gram_batch,
        solve_lasso_batch,
    )
    from fastoptsolver_tpu.batch.fista_gram import BatchFISTAConfig

    rng = np.random.default_rng(5)
    A = jnp.asarray(rng.normal(size=(8, 96, 5)), jnp.float32)
    b = jnp.einsum("bmn,n->bm", A, jnp.asarray([1.0, 0, -0.5, 0, 2.0],
                                               jnp.float32))
    a1 = 0.1 * jnp.max(jnp.abs(jnp.einsum("bmn,bm->bn", A, b)), axis=1)
    gb = make_gram_batch(A, b, a1, 0.0)
    half = BatchFISTAConfig(max_iter=40, check_every=0)
    full = BatchFISTAConfig(max_iter=100, check_every=0)

    straight = solve_gram_batch(gb, full)
    _, mid = solve_gram_batch(gb, half, return_state=True)
    res = solve_gram_batch(gb, full, state0=mid)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(straight.x),
                               rtol=1e-12, atol=1e-14)

    _, mid_l = solve_lasso_batch(A, b, a1, cfg=half, return_state=True)
    res_l = solve_gram_batch(gb, full, state0=mid_l)
    np.testing.assert_allclose(np.asarray(res_l.x), np.asarray(straight.x),
                               rtol=1e-12, atol=1e-14)

    with pytest.raises(TypeError, match="state0"):
        solve_gram_batch(gb, full, state0=object())
