"""Checkpoint/resume and profiling utilities."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from fastoptsolver_tpu.batch import make_gram_batch
from fastoptsolver_tpu.batch.fista_gram import (
    BatchFISTAConfig,
    fista_gram_batch,
    init_batch_state,
)
from fastoptsolver_tpu.problems import LeastSquares, generate_boston_like
from fastoptsolver_tpu.solvers import FISTAConfig, fista
from fastoptsolver_tpu.utils import save_pytree, restore_pytree, timed, solver_stats


def _gb(n_inst=6):
    As, bs = [], []
    for s in range(n_inst):
        A, b, _ = generate_boston_like(m=150, seed=s, noise_std=1.0, rho1=0.5, rho2=0.7)
        A = (A - A.mean(0)) / A.std(0)
        As.append(A)
        bs.append(b)
    return make_gram_batch(
        jnp.asarray(np.stack(As)), jnp.asarray(np.stack(bs)),
        alpha1=0.5, alpha2=0.0, dtype=jnp.float64,
    )


def test_save_restore_roundtrip(tmp_path):
    gb = _gb()
    path = save_pytree(str(tmp_path / "gb"), gb)
    back = restore_pytree(path, gb)
    for a, b in zip(jax.tree.leaves(gb), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_restore_validates_structure(tmp_path):
    gb = _gb()
    path = save_pytree(str(tmp_path / "gb"), gb)
    with pytest.raises(ValueError):
        restore_pytree(path, (gb.Q, gb.c))  # wrong leaf count
    with pytest.raises(ValueError):
        bad = jax.tree.map(lambda x: x, gb)
        bad = bad.__class__(**{**bad.__dict__, "Q": gb.Q[:, :, :2]})
        restore_pytree(path, bad)  # wrong shape


def test_checkpoint_resume_is_exact(tmp_path):
    """Run 100 iterations straight vs 40 + checkpoint + resume 60: identical."""
    gb = _gb()
    straight = fista_gram_batch(gb, BatchFISTAConfig(max_iter=100, check_every=0))

    _, mid = fista_gram_batch(
        gb, BatchFISTAConfig(max_iter=40, check_every=0), return_state=True
    )
    path = save_pytree(str(tmp_path / "state"), mid)
    restored = restore_pytree(path, init_batch_state(gb))
    assert int(restored.k) == 40
    resumed = fista_gram_batch(
        gb, BatchFISTAConfig(max_iter=100, check_every=0), state0=restored
    )
    np.testing.assert_allclose(
        np.asarray(resumed.x), np.asarray(straight.x), rtol=1e-12, atol=1e-14
    )
    assert int(resumed.n_iters_total) == 100


def test_timed_and_solver_stats():
    A, b, _ = generate_boston_like(m=100, seed=0, noise_std=1.0, rho1=0.5, rho2=0.7)
    A = (A - A.mean(0)) / A.std(0)
    p = LeastSquares.create(A, b, "lasso", 0.5, 0.0, dtype=jnp.float64)
    cfg = FISTAConfig(max_iter=30, backtracking=True)
    L = jnp.asarray(100.0)
    res, stats = timed(lambda: fista(p, cfg, L=L), repeats=2)
    assert stats["mean_s"] > 0 and stats["repeats"] == 2
    s = solver_stats(res)
    assert s["n_iters"] == 30
    assert s["grad_num_calls"] == 30
    assert s["ls_num_calls"] == 30
    assert s["backtracks_per_ls"] >= 0


# ---------------------------------------------------------------------------
# process environment: the compile-cache rule and a backend-free import
# ---------------------------------------------------------------------------

import os as _os
import subprocess as _sp
import sys as _sys
from pathlib import Path as _Path

import pytest as _pytest

_ROOT = _Path(__file__).resolve().parents[1]


def _fresh_python(code: str, **env) -> str:
    """Run ``code`` in a new CPU-only interpreter (configuring the cache or
    initializing a backend here would leak into the rest of this worker)."""
    full = {k: v for k, v in _os.environ.items()
            if k != "JAX_COMPILATION_CACHE_DIR"}
    full.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(_ROOT), **env)
    out = _sp.run([_sys.executable, "-c", code], env=full, cwd=_ROOT,
                  capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip()


@_pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_rule(env_dir, tmp_path):
    """JAX_COMPILATION_CACHE_DIR, when set, is the directory used and no
    other is set; unset, the cache goes to the checkout's .jax_cache/,
    which .gitignore lists — never a temporary path."""
    env = {}
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    used, configured = _fresh_python(
        "import jax\n"
        "from fastoptsolver_tpu.utils.compile_cache import "
        "configure_compile_cache\n"
        "print(configure_compile_cache())\n"
        "print(jax.config.jax_compilation_cache_dir)\n", **env
    ).splitlines()
    want = str(tmp_path / env_dir) if env_dir else str(_ROOT / ".jax_cache")
    assert used == configured == want
    if not env_dir:
        assert ".jax_cache/" in (_ROOT / ".gitignore").read_text().split()


def test_import_leaves_backends_uninitialized():
    """Importing the package must not open a device: a parent process that
    imports it and then spawns one child per card (bench/scaling.py) would
    otherwise hold a card itself."""
    out = _fresh_python(
        "import fastoptsolver_tpu, fastoptsolver_tpu.bench.scaling\n"
        "from jax._src import xla_bridge\n"
        "print(len(xla_bridge._backends))\n"
    )
    assert out == "0"
