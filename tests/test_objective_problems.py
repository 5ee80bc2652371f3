import numpy as np
import pytest
import jax
import jax.numpy as jnp

from fastoptsolver_tpu.ops import compute_objective
from fastoptsolver_tpu.problems import (
    LeastSquares,
    GramLeastSquares,
    LogisticRegression,
    CustomProblem,
    fold_alphas,
    generate_boston_like,
)
from oracle_np import objective_np


def _data(rng, m=50, n=7):
    A = rng.normal(size=(m, n))
    x = rng.normal(size=n)
    b = A @ rng.normal(size=n) + 0.1 * rng.normal(size=m)
    return A, b, x


@pytest.mark.parametrize(
    "reg,a1,a2",
    [("lasso", 0.3, 0.9), ("ridge", 0.3, 0.9), ("elasticnet", 0.3, 0.9)],
)
def test_compute_objective_matches_reference_semantics(rng, reg, a1, a2):
    A, b, x = _data(rng)
    got = float(compute_objective(jnp.asarray(x), jnp.asarray(A), jnp.asarray(b), reg, a1, a2))
    ea1, ea2, _ = fold_alphas(reg, a1, a2)
    want = objective_np(x, A, b, ea1, ea2)
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_compute_objective_rejects_unknown_reg(rng):
    A, b, x = _data(rng)
    with pytest.raises(ValueError):
        compute_objective(x, A, b, "huber", 0.1, 0.1)


def test_fold_alphas_lbfgs_reclassification():
    # tiny-alpha elastic-net reclassification with eps (lbfgs.py:19-33)
    assert fold_alphas("elasticnet", 1e-12, 0.5, eps=1e-8) == (0.0, 0.5, "ridge")
    assert fold_alphas("elasticnet", 0.5, 1e-12, eps=1e-8) == (0.5, 0.0, "lasso")
    assert fold_alphas("elasticnet", 0.5, 0.5, eps=1e-8) == (0.5, 0.5, "elasticnet")
    # without eps, no reclassification
    assert fold_alphas("elasticnet", 1e-12, 0.5) == (1e-12, 0.5, "elasticnet")


def test_least_squares_value_and_grad(rng):
    A, b, x = _data(rng)
    p = LeastSquares.create(A, b, "elasticnet", 0.2, 0.7, dtype=jnp.float64)
    xj = jnp.asarray(x)
    val, grad = p.smooth_value_and_grad(xj)
    np.testing.assert_allclose(float(val), float(p.smooth_value(xj)), rtol=1e-12)
    auto = jax.grad(p.smooth_value)(xj)
    np.testing.assert_allclose(np.asarray(grad), np.asarray(auto), rtol=1e-9)
    np.testing.assert_allclose(
        float(p.objective(xj)), objective_np(x, A, b, 0.2, 0.7), rtol=1e-10
    )


def test_gram_form_matches_dense(rng):
    A, b, x = _data(rng)
    dense = LeastSquares.create(A, b, "elasticnet", 0.2, 0.7, dtype=jnp.float64)
    gram = dense.to_gram()
    xj = jnp.asarray(x)
    np.testing.assert_allclose(
        float(gram.smooth_value(xj)), float(dense.smooth_value(xj)), rtol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(gram.smooth_grad(xj)), np.asarray(dense.smooth_grad(xj)), rtol=1e-8
    )
    np.testing.assert_allclose(
        float(gram.objective(xj)), float(dense.objective(xj)), rtol=1e-9
    )


def test_logistic_grad_matches_autodiff(rng):
    m, n = 40, 5
    A = rng.normal(size=(m, n))
    y = np.sign(rng.normal(size=m))
    p = LogisticRegression.create(A, y, alpha1=0.1, alpha2=0.3, dtype=jnp.float64)
    x = jnp.asarray(rng.normal(size=n))
    val, grad = p.smooth_value_and_grad(x)
    auto_v, auto_g = jax.value_and_grad(p.smooth_value)(x)
    np.testing.assert_allclose(float(val), float(auto_v), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(grad), np.asarray(auto_g), rtol=1e-8)


def test_custom_problem_closures(rng):
    # quadratic with custom prox: CustomProblem covers the reference ISTA's
    # injectable-closure API
    Q = jnp.asarray(np.diag([1.0, 2.0, 3.0]))
    c = jnp.asarray([1.0, -1.0, 0.5])
    p = CustomProblem(
        params={"Q": Q, "c": c},
        smooth_value_fn=lambda x, Q, c: 0.5 * x @ Q @ x - c @ x,
        smooth_grad_fn=lambda x, Q, c: Q @ x - c,
        prox_fn=lambda v, tau, Q, c: jnp.maximum(v, 0.0),
        n_dim=3,
    )
    x = jnp.asarray([0.5, 0.5, 0.5])
    # 0.5 * (0.25 + 0.5 + 0.75) - (0.5 - 0.5 + 0.25) = 0.75 - 0.25
    np.testing.assert_allclose(float(p.smooth_value(x)), 0.5)
    np.testing.assert_allclose(np.asarray(p.prox(jnp.asarray([-1.0, 2.0, 0.0]), 0.1)), [0.0, 2.0, 0.0])
    # autodiff fallback when grad_fn omitted
    p2 = CustomProblem(
        params={"Q": Q, "c": c},
        smooth_value_fn=lambda x, Q, c: 0.5 * x @ Q @ x - c @ x,
        n_dim=3,
    )
    np.testing.assert_allclose(
        np.asarray(p2.smooth_grad(x)), np.asarray(p.smooth_grad(x)), rtol=1e-12
    )


def test_boston_generator_matches_reference_shapes_and_stats():
    A, b, x_true = generate_boston_like(m=1000, seed=0, noise_std=1.0, rho1=0.5, rho2=0.7)
    assert A.shape == (1000, 5) and b.shape == (1000,)
    np.testing.assert_allclose(x_true, [5.0, 0.0, -0.02, -0.05, 1.5])
    # column means near the block means
    np.testing.assert_allclose(A[:, 0].mean(), 6.0, atol=0.1)
    np.testing.assert_allclose(A[:, 2].mean(), 300.0, atol=2.0)
    np.testing.assert_allclose(A[:, 4].mean(), 4.0, atol=0.2)
    # deterministic across calls
    A2, b2, _ = generate_boston_like(m=1000, seed=0, noise_std=1.0, rho1=0.5, rho2=0.7)
    np.testing.assert_array_equal(A, A2)
    np.testing.assert_array_equal(b, b2)


def test_jax_scenario_batch_statistics():
    from fastoptsolver_tpu.problems import generate_scenario_batch

    A, b, x_true = generate_scenario_batch(
        jax.random.PRNGKey(0), batch=16, m=500, noise_std=1.0, rho1=0.8, rho2=0.9
    )
    assert A.shape == (16, 500, 5) and b.shape == (16, 500)
    A_np = np.asarray(A).reshape(-1, 5)
    np.testing.assert_allclose(A_np[:, 0].mean(), 6.0, atol=0.05)
    np.testing.assert_allclose(A_np[:, 1].mean(), 0.2, atol=0.05)
    # correlation of block1 near rho1
    corr = np.corrcoef(A_np[:, 0], A_np[:, 1])[0, 1]
    np.testing.assert_allclose(corr, 0.8, atol=0.05)


def test_feature_major_generator_distribution_parity():
    import jax
    from fastoptsolver_tpu.problems import (
        generate_scenario_batch,
        generate_scenario_batch_fm,
    )

    key = jax.random.PRNGKey(0)
    B, m = 512, 400
    A1, b1, xt1 = generate_scenario_batch(key, B, m=m, noise_std=1.0, rho1=0.5, rho2=0.7)
    A2, b2, xt2 = generate_scenario_batch_fm(key, B, m=m, noise_std=1.0, rho1=0.5, rho2=0.7)
    assert A2.shape == (5, m, B) and b2.shape == (m, B)
    np.testing.assert_array_equal(np.asarray(xt1), np.asarray(xt2))
    # distributional parity: feature means/stds and within-block correlation
    m1 = np.asarray(A1).reshape(-1, 5).mean(0)
    m2 = np.asarray(A2).transpose(1, 2, 0).reshape(-1, 5).mean(0)
    np.testing.assert_allclose(m1, m2, rtol=0.02, atol=0.05)
    s1 = np.asarray(A1).reshape(-1, 5).std(0)
    s2 = np.asarray(A2).transpose(1, 2, 0).reshape(-1, 5).std(0)
    np.testing.assert_allclose(s1, s2, rtol=0.05)
    flat1 = np.asarray(A1).reshape(-1, 5)
    flat2 = np.asarray(A2).transpose(1, 2, 0).reshape(-1, 5)
    c1 = np.corrcoef(flat1[:, 0], flat1[:, 1])[0, 1]
    c2 = np.corrcoef(flat2[:, 0], flat2[:, 1])[0, 1]
    np.testing.assert_allclose(c1, c2, atol=0.05)
    # b = A @ x_true + noise in both layouts
    r2 = np.asarray(b2) - np.einsum("nmb,n->mb", np.asarray(A2), np.asarray(xt2))
    assert abs(r2.std() - 1.0) < 0.05


def test_en_prox_variant_same_minimizer():
    """en_prox=True (ridge in nonsmooth part + elastic-net prox) and the
    default folded form converge to the same minimizer."""
    from fastoptsolver_tpu.solvers import FISTAConfig, fista

    A, b, _ = generate_boston_like(m=200, seed=0, noise_std=1.0, rho1=0.5, rho2=0.7)
    A = (A - A.mean(0)) / A.std(0)
    folded = LeastSquares.create(A, b, "elasticnet", 0.5, 2.0, dtype=jnp.float64)
    enp = LeastSquares.create(A, b, "elasticnet", 0.5, 2.0, dtype=jnp.float64, en_prox=True)
    import jax as _jax

    key = _jax.random.PRNGKey(0)
    xf = fista(folded, FISTAConfig(max_iter=2000), key=key).x
    xe = fista(enp, FISTAConfig(max_iter=2000), key=key).x
    np.testing.assert_allclose(np.asarray(xe), np.asarray(xf), rtol=1e-6, atol=1e-9)
    # objectives agree (h-split differs, total is identical)
    np.testing.assert_allclose(float(enp.objective(xe)), float(folded.objective(xf)), rtol=1e-10)
    with pytest.raises(NotImplementedError):
        enp.to_gram()


def test_solve_api():
    from fastoptsolver_tpu import solve

    A, b, _ = generate_boston_like(m=200, seed=0, noise_std=1.0, rho1=0.5, rho2=0.7)
    A = (A - A.mean(0)) / A.std(0)
    r1 = solve(A, b, "lasso", alpha1=0.5, max_iter=300, dtype=jnp.float64)
    r2 = solve(A, b, "lasso", alpha1=0.5, method="cd", dtype=jnp.float64)
    np.testing.assert_allclose(np.asarray(r1.x), np.asarray(r2.x), rtol=1e-4, atol=1e-7)
    r3 = solve(A, b, "ridge", alpha2=1.0, method="lbfgs", tol=1e-10, dtype=jnp.float64)
    x_star = np.linalg.solve(A.T @ A + np.eye(5), A.T @ b)
    np.testing.assert_allclose(np.asarray(r3.x), x_star, rtol=1e-4)
    rh = solve(A, b, "lasso", alpha1=0.5, method="fista_delta", history=True,
               max_iter=50, dtype=jnp.float64)
    assert rh.history.obj.shape == (50,)
    with pytest.raises(ValueError):
        solve(A, b, method="adam")
    with pytest.raises(TypeError):
        solve(A, b, "lasso", alpha1=0.5, bogus_option=1)


def test_boston_506x13():
    from fastoptsolver_tpu.problems import synthetic_boston
    from fastoptsolver_tpu import solve

    A, b, x_true = synthetic_boston(seed=0)
    assert A.shape == (506, 13) and b.shape == (506,)
    res = solve(A, b, "lasso", alpha1=10.0, max_iter=2000, dtype=jnp.float64)
    x = np.asarray(res.x)
    # sparse recovery: the four true-support columns dominate
    support = np.argsort(-np.abs(x))[:4]
    assert set(support) == set(np.nonzero(x_true)[0])
