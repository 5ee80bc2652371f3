"""Wide-n batched lasso throughput of the XLA driver (batch/fista_gram.py).

Measures, per feature count, in one process:

- the XLA pure-read rate of the (n, n, B) Gram tensor (``jnp.sum(Q)``) —
  the in-process ceiling for anything that must stream Q once per
  iteration;
- one bare batched matvec ``einsum("ijb,jb->ib")``, the driver's
  per-iteration operation;
- the driver's certified solve: instances/s and effective Q-stream GB/s
  (iterations × n²·B·4 bytes), as a percentage of that read rate;
- the Gram build (einsum precompute + power iteration) cost, separately —
  at wide n the 100-step power iteration re-reads Q every step;
- the public path end to end from raw (A, b) through ``solve_lasso_batch``.

B is sized to a device-memory budget for Q (default 2 GB). One JSON line
per n.

``--backtracking`` runs every arm with the reference's armijo search
(iterative_solvers.py:183-197 semantics). The reference recurrence stalls
on these scenarios (tests/test_batch_oracle_grid.py pins it against the
f64 oracle), so compare armijo arms on wall-clock, not converged/s.

Usage:
  python -m fastoptsolver_tpu.bench.wide_n --n 96 128 256 512
  python -m fastoptsolver_tpu.bench.wide_n --n 128 256 --backtracking
"""
from __future__ import annotations

import argparse
import functools
import json

import numpy as np

import jax
import jax.numpy as jnp

from ..utils.profiling import timed


@functools.partial(jax.jit, static_argnames=("B", "m", "n"))
def _build_problems(key, B: int, m: int, n: int):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    A = jax.random.normal(k1, (B, m, n), jnp.float32) / np.sqrt(n)
    x_true = jnp.where(
        jax.random.uniform(k2, (B, n)) < 0.1,
        3.0 * jax.random.normal(k3, (B, n), jnp.float32),
        0.0,
    )
    b = jnp.einsum("bmn,bn->bm", A, x_true)
    b = b + 0.1 * jax.random.normal(k4, (B, m), jnp.float32)
    alpha1 = 0.1 * jnp.max(jnp.abs(jnp.einsum("bmi,bm->bi", A, b)), axis=1)
    return A, b, alpha1


def _timed(fn, reps: int):
    """Best host-clock seconds over ``reps`` warm calls, and the output."""
    out, stats = timed(fn, repeats=reps)
    return stats["min_s"], out


def run_one(n: int, q_gb: float, max_iter: int, check_every: int,
            tol: float, reps: int, seed: int = 0,
            backtracking: bool = False) -> dict:
    from ..batch.fista_gram import (
        BatchFISTAConfig,
        fista_gram_batch,
        make_gram_batch,
    )

    m = 2 * n
    B = max(int(q_gb * 1e9 / (n * n * 4)), 1)
    key = jax.random.PRNGKey(seed)
    A, b, alpha1 = _build_problems(key, B, m, n)
    A.block_until_ready()

    cfg = BatchFISTAConfig(max_iter=max_iter, check_every=check_every,
                           rel_gap_tol=tol, backtracking=backtracking)

    # --- Gram build (einsum + 100-step power iteration), timed alone ------
    build = jax.jit(lambda A, b, a1: make_gram_batch(A, b, a1, 0.0))
    dt_build, gb = _timed(lambda: build(A, b, alpha1), reps)

    # --- in-process XLA read ceiling of this exact Q tensor ---------------
    read = jax.jit(lambda Q: jnp.sum(Q))
    dt_read, _ = _timed(lambda: read(gb.Q), reps)
    read_gbps = gb.Q.size * 4 / dt_read / 1e9

    # --- one bare einsum matvec (the driver's per-iteration op) ------------
    mv = jax.jit(lambda Q, Y: jnp.einsum(
        "ijb,jb->ib", Q, Y, precision=jax.lax.Precision.HIGHEST
    ))
    Y0 = jnp.ones((n, B), jnp.float32)
    dt_mv, _ = _timed(lambda: mv(gb.Q, Y0), reps)
    mv_gbps = gb.Q.size * 4 / dt_mv / 1e9

    # --- driver certified solve -------------------------------------------
    solve_d = jax.jit(lambda g: fista_gram_batch(g, cfg))
    dt_d, res_d = _timed(lambda: solve_d(gb), reps)
    conv_d = int(jnp.sum(res_d.converged))
    iters_total = int(res_d.n_iters_total)
    checks = -(-iters_total // check_every)
    q_bytes = (iters_total + checks) * gb.Q.size * 4.0
    out = {
        "n": n,
        "m": m,
        "B": B,
        "backtracking": backtracking,
        "q_gb": gb.Q.size * 4 / 1e9,
        "build_s": dt_build,
        "xla_q_read_gbps": read_gbps,
        "xla_matvec_gbps": mv_gbps,
        "driver": {
            "solve_s": dt_d,
            "converged": conv_d,
            "inst_per_s": conv_d / dt_d,
            "iters_total": iters_total,
            "median_iters": int(np.median(np.asarray(res_d.iters))),
            # Under armijo these two are LOWER bounds: every trial round
            # adds one Q matvec that iters_total does not count.
            "eff_q_stream_gbps": q_bytes / dt_d / 1e9,
            "pct_of_xla_read": 100.0 * q_bytes / dt_d / 1e9 / read_gbps,
        },
        "device": {"platform": jax.devices()[0].platform,
                   "device_kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
    }

    # --- the public path end to end from raw (A, b): build + solve ------
    from ..batch import solve_lasso_batch

    dt_r, res_r = _timed(
        lambda: solve_lasso_batch(A, b, alpha1, 0.0, cfg=cfg), reps
    )
    conv_r = int(jnp.sum(res_r.converged))
    out["end_to_end"] = {
        "total_s": dt_r,
        "converged": conv_r,
        "inst_per_s": conv_r / dt_r,
    }
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, nargs="+", default=[96, 128, 256, 512])
    ap.add_argument("--q-gb", type=float, default=2.0,
                    help="device-memory budget for the Gram tensor (sizes B "
                         "per n)")
    ap.add_argument("--max-iter", type=int, default=1000)
    ap.add_argument("--check-every", type=int, default=25)
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--backtracking", action="store_true",
                    help="reference-semantics armijo on every arm")
    args = ap.parse_args(argv)
    from ..utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    for n in args.n:
        print(json.dumps(run_one(
            n, args.q_gb, args.max_iter, args.check_every, args.tol,
            args.reps, backtracking=args.backtracking,
        )))


if __name__ == "__main__":
    main()
