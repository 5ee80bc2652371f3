"""Mesh-routed solve_lasso_batch: the single-device driver per shard.

``solve_lasso_batch(..., mesh=)`` runs the same Gram precompute and
certified driver inside ``shard_map`` over the instance axis, so a
multi-device user gets the single-device semantics — including
checkpoint/resume, whose ``BatchState`` has the single-device layout and
moves freely between a mesh and one device.
"""
from __future__ import annotations

import dataclasses

import numpy as np

import jax
import jax.numpy as jnp
import pytest

from fastoptsolver_tpu.batch import solve_lasso_batch
from fastoptsolver_tpu.batch.fista_gram import BatchFISTAConfig, BatchState
from fastoptsolver_tpu.parallel import make_mesh


def _problem(seed=0, B=500, m=150, n=5):
    # B=500: not a multiple of 8 devices → exercises the padding path
    rng = np.random.default_rng(seed)
    Afm = jnp.asarray(rng.normal(size=(n, m, B)), jnp.float32)
    xt = np.zeros((n, B), np.float32)
    xt[:2] = rng.normal(size=(2, B))
    bfm = jnp.einsum("nmb,nb->mb", Afm, jnp.asarray(xt))
    a1 = 0.1 * jnp.max(jnp.abs(jnp.einsum("nmb,mb->nb", Afm, bfm)), axis=0)
    return Afm, bfm, a1


def _wide(n, seed, m=200, B=256):
    rng = np.random.default_rng(seed)
    Afm = jnp.asarray(rng.normal(size=(n, m, B)) / np.sqrt(n), jnp.float32)
    xt = np.zeros((n, B), np.float32)
    xt[: n // 8] = rng.normal(size=(n // 8, B))
    bfm = jnp.einsum("nmb,nb->mb", Afm, jnp.asarray(xt))
    a1 = 0.1 * jnp.max(jnp.abs(jnp.einsum("nmb,mb->nb", Afm, bfm)), axis=0)
    return Afm, bfm, a1


def test_mesh_routed_matches_single_device_kernel_path():
    """Sharded-vs-single parity on the 8-device CPU mesh: per-lane math is
    lane-local and each shard gets the single-device start vectors of its
    lanes, so the shard split (and the padding of the last shard) cannot
    change a lane's trajectory."""
    Afm, bfm, a1 = _problem()
    cfg = BatchFISTAConfig(max_iter=1000, check_every=25, rel_gap_tol=5e-6)
    mesh = make_mesh(batch=8, model=1)
    res = solve_lasso_batch(Afm, bfm, a1, cfg=cfg, feature_major=True,
                            mesh=mesh)
    ref = solve_lasso_batch(Afm, bfm, a1, cfg=cfg, feature_major=True)
    assert res.x.shape == (500, 5)
    assert bool(np.asarray(res.converged).all())
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(res.iters), np.asarray(ref.iters))
    assert int(res.n_iters_total) == int(np.asarray(res.iters).max())


def test_mesh_routed_driver_backend_and_guards():
    """Each shard's solve lives on its own device (the result is laid out
    over the mesh, not gathered on one device); a resume state for another
    batch, or of another type, is refused before any device work."""
    Afm, bfm, a1 = _problem(seed=1, B=256)
    cfg = BatchFISTAConfig(max_iter=800, check_every=25, rel_gap_tol=5e-6)
    mesh = make_mesh(batch=8, model=1)
    res, fin = solve_lasso_batch(Afm, bfm, a1, cfg=cfg, feature_major=True,
                                 mesh=mesh, return_state=True)
    ref = solve_lasso_batch(Afm, bfm, a1, cfg=cfg, feature_major=True)
    assert bool(np.asarray(res.converged).all())
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               rtol=1e-5, atol=1e-6)
    assert len(res.x.sharding.device_set) == 8
    assert fin.X.shape == (5, 256) and fin.k.shape == ()
    other = _problem(seed=1, B=128)
    with pytest.raises(ValueError, match="state0 holds"):
        solve_lasso_batch(*other, cfg=cfg, feature_major=True, mesh=mesh,
                          state0=fin)
    with pytest.raises(TypeError, match="BatchState"):
        solve_lasso_batch(Afm, bfm, a1, cfg=cfg, feature_major=True,
                          mesh=mesh, state0=object())


def test_mesh_routed_resume_round_trip():
    """Checkpoint/resume through the mesh surface: cut + resume over the
    mesh equals the straight mesh run bit for bit, and the mesh checkpoint
    also resumes on the single-device surface (the state has the
    single-device layout; its k is the count every live lane has run)."""
    Afm, bfm, a1 = _problem(seed=5, B=512)
    mesh = make_mesh(batch=8, model=1)
    full = BatchFISTAConfig(max_iter=200, check_every=25, rel_gap_tol=1e-6)
    half = dataclasses.replace(full, max_iter=75)
    straight = solve_lasso_batch(Afm, bfm, a1, cfg=full, feature_major=True,
                                 mesh=mesh)
    _, mid = solve_lasso_batch(Afm, bfm, a1, cfg=half, feature_major=True,
                               mesh=mesh, return_state=True)
    assert isinstance(mid, BatchState) and int(mid.k) == 75
    assert not bool(jnp.all(mid.done))
    resumed = solve_lasso_batch(Afm, bfm, a1, cfg=full, feature_major=True,
                                mesh=mesh, state0=mid)
    np.testing.assert_array_equal(np.asarray(resumed.x),
                                  np.asarray(straight.x))
    np.testing.assert_array_equal(np.asarray(resumed.iters),
                                  np.asarray(straight.iters))
    single = solve_lasso_batch(Afm, bfm, a1, cfg=full, feature_major=True,
                               state0=mid)
    np.testing.assert_array_equal(np.asarray(single.x), np.asarray(straight.x))


def test_mesh_routed_armijo_and_instance_major():
    """Armijo backtracking composes with the mesh, and instance-major
    inputs are transposed once up front.

    The Armijo recurrence is chaotic on these instances (see
    test_batch_oracle_grid.py): a rounding-level difference flips a
    borderline accept and halves a lane's τ for good. The shard width
    alone makes one: XLA:CPU contracts the first trial's ``|τc| − τα``
    into an FMA at one batch width and not at another. So the mesh run is
    held to the single-device run's own sensitivity: its distance from
    the single-device result stays well under what a 1e-7 relative change
    of b does to that result, and lane for lane it starts from the same
    Gram and L (its fixed-step run agrees to rounding)."""
    Afm, bfm, a1 = _problem(seed=2, B=256)
    cfg = BatchFISTAConfig(max_iter=100, check_every=25, rel_gap_tol=1e-4,
                           backtracking=True)
    mesh = make_mesh(batch=8, model=1)
    res = solve_lasso_batch(Afm, bfm, a1, cfg=cfg, feature_major=True,
                            mesh=mesh)
    ref = solve_lasso_batch(Afm, bfm, a1, cfg=cfg, feature_major=True)
    pert = solve_lasso_batch(Afm, bfm * (1.0 + 1e-7), a1, cfg=cfg,
                             feature_major=True)
    d_mesh = np.abs(np.asarray(res.x) - np.asarray(ref.x)).max()
    d_self = np.abs(np.asarray(pert.x) - np.asarray(ref.x)).max()
    assert d_mesh <= 0.1 * d_self, (d_mesh, d_self)
    fixed = dataclasses.replace(cfg, backtracking=False)
    np.testing.assert_allclose(
        np.asarray(solve_lasso_batch(Afm, bfm, a1, cfg=fixed,
                                     feature_major=True, mesh=mesh).x),
        np.asarray(solve_lasso_batch(Afm, bfm, a1, cfg=fixed,
                                     feature_major=True).x),
        rtol=1e-5, atol=1e-6)
    # instance-major layout through the same mesh entry
    A_im = jnp.transpose(Afm, (2, 1, 0))
    b_im = jnp.transpose(bfm, (1, 0))
    cfg2 = BatchFISTAConfig(max_iter=800, check_every=25, rel_gap_tol=5e-6)
    res_im = solve_lasso_batch(A_im, b_im, a1, cfg=cfg2, mesh=mesh)
    ref_im = solve_lasso_batch(Afm, bfm, a1, cfg=cfg2, feature_major=True)
    np.testing.assert_allclose(np.asarray(res_im.x), np.asarray(ref_im.x),
                               rtol=1e-5, atol=1e-6)


def test_mesh_routed_wide_n_engines_per_shard():
    """Wide n through the mesh surface (the window the old resident engine
    served, and past it) matches the single-device driver."""
    mesh = make_mesh(batch=8, model=1)
    cfg = BatchFISTAConfig(max_iter=600, check_every=25, rel_gap_tol=5e-6)
    for n in (144, 200):
        Afm, bfm, a1 = _wide(n, seed=n)
        res = solve_lasso_batch(Afm, bfm, a1, cfg=cfg, feature_major=True,
                                mesh=mesh)
        ref = solve_lasso_batch(Afm, bfm, a1, cfg=cfg, feature_major=True)
        assert bool(np.asarray(res.converged).all()), n
        np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                                   rtol=1e-4, atol=5e-6, err_msg=str(n))


def test_mesh_resume_rejects_checkpoint_cut_under_other_grouping():
    """A checkpoint is tied to its instances, not to a layout. One cut for
    another batch is refused; one cut on a single device — whose instances
    stopped at different iterations — resumes over a 2-device mesh exactly
    as it resumes on the single device."""
    rng = np.random.default_rng(9)
    n, m, B = 5, 96, 3072
    Afm = jnp.asarray(rng.normal(size=(n, m, B)), jnp.float32)
    xt = np.zeros((n, B), np.float32)
    xt[:2] = rng.normal(size=(2, B))
    bfm = jnp.einsum("nmb,nb->mb", Afm, jnp.asarray(xt))
    amax = jnp.max(jnp.abs(jnp.einsum("nmb,mb->nb", Afm, bfm)), axis=0)
    # the middle third hard, the outer thirds trivial
    hard = (jnp.arange(B) >= 1024) & (jnp.arange(B) < 2048)
    a1 = jnp.where(hard, 0.1 * amax, 10.0 * amax)
    cut = BatchFISTAConfig(max_iter=150, check_every=25, rel_gap_tol=1e-6)
    _, mid = solve_lasso_batch(Afm, bfm, a1, cfg=cut, feature_major=True,
                               return_state=True)
    iters = np.asarray(mid.iters)
    assert len(set(iters.tolist())) > 1  # lanes genuinely stopped apart
    mesh = make_mesh(batch=2, model=1, devices=jax.devices()[:2])
    full = BatchFISTAConfig(max_iter=300, check_every=25, rel_gap_tol=1e-6)
    on_mesh = solve_lasso_batch(Afm, bfm, a1, cfg=full, feature_major=True,
                                mesh=mesh, state0=mid)
    single = solve_lasso_batch(Afm, bfm, a1, cfg=full, feature_major=True,
                               state0=mid)
    np.testing.assert_array_equal(np.asarray(on_mesh.x), np.asarray(single.x))
    np.testing.assert_array_equal(np.asarray(on_mesh.iters),
                                  np.asarray(single.iters))
    with pytest.raises(ValueError, match="state0 holds"):
        solve_lasso_batch(Afm[..., :1024], bfm[..., :1024], a1[:1024],
                          cfg=full, feature_major=True, mesh=mesh,
                          state0=mid)


def test_mesh_routed_resume_wide_n_resident():
    """Mesh checkpoint/resume at wide n (the window the old resident engine
    served, and past it): cut + resume over the mesh equals the straight
    mesh run."""
    mesh = make_mesh(batch=8, model=1)
    full = BatchFISTAConfig(max_iter=300, check_every=25, rel_gap_tol=5e-6)
    half = dataclasses.replace(full, max_iter=75)
    for n in (144, 200):
        Afm, bfm, a1 = _wide(n, seed=13 + n, B=256)
        straight = solve_lasso_batch(Afm, bfm, a1, cfg=full,
                                     feature_major=True, mesh=mesh)
        _, mid = solve_lasso_batch(Afm, bfm, a1, cfg=half, feature_major=True,
                                   mesh=mesh, return_state=True)
        resumed = solve_lasso_batch(Afm, bfm, a1, cfg=full,
                                    feature_major=True, mesh=mesh, state0=mid)
        np.testing.assert_array_equal(np.asarray(resumed.x),
                                      np.asarray(straight.x), err_msg=str(n))
