"""Headline benchmark: batched lasso instances certified to a 1e-6 relative
duality gap per second, on one GPU.

Generates the headline batch of Boston-like lasso scenarios on the device
(fastoptsolver_tpu/bench/headline.py), then times the public path from raw (A, b, α) to
certified solutions — Gram precompute, Lipschitz estimate, certified FISTA —
through ``solve_lasso_batch``. Data generation is excluded. In the same
process it times a plain copy of A and b, the achievable read+write rate of
those bytes on this card, next to the published HBM peak.

Prints exactly one JSON line:
  {"metric": ..., "value": N, "unit": "instances/s", "vs_baseline": N/1e4,
   "detail": {..., "device": {platform, device_kind, count, nvidia_smi}}}
and exits non-zero when JAX finds no GPU or the card has no peaks row.

Usage: python bench.py   (BENCH_BATCH overrides the batch, default 262144)
"""
from __future__ import annotations

import json
import os

import numpy as np

import jax
import jax.numpy as jnp


def main():
    from fastoptsolver_tpu.batch import solve_lasso_batch
    from fastoptsolver_tpu.bench import headline
    from fastoptsolver_tpu.bench.device import (
        parse_nvidia_smi,
        peaks_for,
        query_nvidia_smi,
        require_gpu,
    )
    from fastoptsolver_tpu.utils.compile_cache import configure_compile_cache
    from fastoptsolver_tpu.utils.profiling import timed

    smi = parse_nvidia_smi(query_nvidia_smi())
    device = require_gpu(jax.devices())
    peaks = peaks_for(device["kind"])
    configure_compile_cache()

    batch = int(os.environ.get("BENCH_BATCH", headline.BATCH))
    m, cfg = headline.M, headline.CFG

    A, b, alpha1 = jax.block_until_ready(
        headline.build_problems(jax.random.PRNGKey(0), batch, m)
    )
    solve = lambda: solve_lasso_batch(A, b, alpha1, 0.0, cfg=cfg,
                                      feature_major=True)
    # negation: a real elementwise pass that XLA cannot fold or forward
    copy = jax.jit(lambda A, b: (-A, -b))

    res, solve_s = timed(solve, repeats=10)  # the warm-up call compiles
    _, copy_s = timed(copy, A, b, repeats=10)

    dt = solve_s["median_s"]
    n_conv = int(jnp.sum(res.converged))
    value = n_conv / dt
    in_bytes = (A.size + b.size) * A.dtype.itemsize
    print(
        json.dumps(
            {
                "metric": "batched_lasso_instances_solved_to_1e-6_rel_gap_per_s",
                "value": value,
                "unit": "instances/s",
                "vs_baseline": value / 1e4,
                "detail": {
                    "batch": batch,
                    "m": m,
                    "n": int(A.shape[0]),
                    "converged": n_conv,
                    "lockstep_iters": int(res.n_iters_total),
                    "median_iters": int(np.median(np.asarray(res.iters))),
                    "solve_s_median": dt,
                    "solve_s_min": solve_s["min_s"],
                    "solve_s_reps": solve_s["times_s"],
                    "input_bytes": in_bytes,
                    # a plain copy reads and writes A+b once each
                    "copy_a_b_gbps": 2 * in_bytes / copy_s["min_s"] / 1e9,
                    "peak_hbm_gbps": peaks["hbm_bytes_per_s"] / 1e9,
                    "peaks_source": peaks["source"],
                    "device": {
                        "platform": device["platform"],
                        "device_kind": device["kind"],
                        "count": device["count"],
                        "nvidia_smi": smi,
                    },
                },
            }
        )
    )


if __name__ == "__main__":
    main()
