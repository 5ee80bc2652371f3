"""Large dense-matrix lasso benchmark (one device): matvec-bound FISTA.

The complement of bench.py's many-small-instances path: ONE large design
matrix (default 131072×2048, 1 GB f32), solved by dense FISTA — each
iteration is the reference's two matvecs ``A@y`` and ``Aᵀr``
(iterative_solvers.py:173), each streaming A from device memory. Reports
iterations/s plus achieved FLOP/s and bytes/s under the model that A is
read twice per iteration (a prox-gradient step is bound by memory
bandwidth).

The same problem sharded over a mesh is ``bench/scaling.py --mode model``
and chip_smoke.py's ``--four-cards`` row/column-sharded phase.

CLI:  python -m fastoptsolver_tpu.bench.large_lasso [--m 131072] [--n 2048]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

import jax
import jax.numpy as jnp


def run(m: int, n: int, iters: int, alpha1_scale: float = 0.1, seed: int = 0):
    from ..problems import LeastSquares
    from ..solvers import FISTAConfig, fista

    key = jax.random.PRNGKey(seed)
    k1, k2, k3 = jax.random.split(key, 3)

    @jax.jit
    def build():
        A = jax.random.normal(k1, (m, n), jnp.float32) / np.sqrt(n)
        x_true = jnp.where(
            jax.random.uniform(k2, (n,)) < 0.05,
            jax.random.normal(k3, (n,), jnp.float32) * 3.0,
            0.0,
        )
        b = A @ x_true + 0.1 * jax.random.normal(key, (m,), jnp.float32)
        alpha1 = alpha1_scale * jnp.max(jnp.abs(A.T @ b))
        return A, b, alpha1

    A, b, alpha1 = jax.block_until_ready(build())
    problem = LeastSquares(A=A, b=b, alpha1=alpha1, alpha2=jnp.float32(0.0))
    cfg = FISTAConfig(max_iter=iters)
    # rows/n normalization puts λ_max(AᵀA) ≈ (√m+√n)²/n — power-iterate anyway
    solve = jax.jit(lambda p, k: fista(p, cfg, key=k).x)

    x = jax.block_until_ready(solve(problem, key))  # compile + L estimation
    best = np.inf
    for _ in range(3):
        t0 = time.perf_counter()
        x = jax.block_until_ready(solve(problem, key))
        best = min(best, time.perf_counter() - t0)
    dt = best

    # L estimation (≤100 power iters, 2 matvecs each) is included in dt;
    # count it toward the matvec totals.
    total_iters = iters
    matvecs = 2 * (total_iters + 100)
    flops = matvecs * 2.0 * m * n
    bytes_streamed = matvecs * (m * n * 4.0)
    return {
        "m": m,
        "n": n,
        "iters": iters,
        "seconds": dt,
        "iters_per_s": iters / dt,
        "achieved_tflops": flops / dt / 1e12,
        "achieved_gbps": bytes_streamed / dt / 1e9,
        "nnz_frac": float(jnp.mean(jnp.abs(x) > 0)),
        "device": {"platform": jax.devices()[0].platform,
                   "device_kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
    }


def main(argv=None):
    from ..utils.compile_cache import configure_compile_cache

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--m", type=int, default=131072)
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args(argv)
    configure_compile_cache()
    print(json.dumps(run(args.m, args.n, args.iters)))


if __name__ == "__main__":
    main()
