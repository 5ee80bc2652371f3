"""Streamed-Gram lasso benchmark: one-pass streamed Gram + on-device solve.

Host-generated row chunks stream through the device exactly once, reduced
to Q = AᵀA / c = Aᵀb (problems/streaming.py), then the certified FISTA runs
entirely on the device at O(n²)/iteration (solvers/gram_dense.py). A is
never resident on the device — the peak is Q + ``prefetch`` chunks, so m is
bounded by host memory, not device memory. Reports the streamed volume,
whether A would have fit in the device's memory, the effective host→device
rate of the pass, and solve iterations/s.

Re-streaming A every iteration (a chunked matvec) would pay the host link
once per iteration; the one-pass reduction pays it once.

Default: m=2²¹, n=1280 → A = 10.7 GB streamed, Q = 6.6 MB solved.

CLI: python -m fastoptsolver_tpu.bench.streaming_lasso [--m M] [--n N]
     [--chunk-rows R] [--tol 1e-6]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

import jax
import jax.numpy as jnp


def host_chunks(m: int, n: int, chunk_rows: int, seed: int = 0,
                workers: int = 8) -> list[tuple[np.ndarray, np.ndarray]]:
    """Row chunks ``(A_i (rows, n), b_i (rows,))`` of a sparse-truth lasso
    problem, generated in host memory by ``workers`` threads. Chunk ``i``
    depends only on ``(seed, i)``, so any chunk can be regenerated alone."""
    from concurrent.futures import ThreadPoolExecutor

    n_chunks = -(-m // chunk_rows)
    x_true = np.zeros(n, np.float32)
    rng0 = np.random.default_rng(seed)
    idx = rng0.choice(n, size=max(1, n // 20), replace=False)
    x_true[idx] = (rng0.normal(size=idx.size) * 3.0).astype(np.float32)
    scale = np.float32(1.0 / np.sqrt(n))

    def make_chunk(i: int):
        rows = min(chunk_rows, m - i * chunk_rows)
        # SFC64: fastest numpy bit generator; chunk-seeded → reproducible
        rng = np.random.Generator(np.random.SFC64(seed * 1_000_003 + i))
        A_i = rng.standard_normal((rows, n), dtype=np.float32)
        A_i *= scale
        b_i = A_i @ x_true + 0.1 * rng.standard_normal(rows, dtype=np.float32)
        return A_i, b_i

    with ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(make_chunk, range(n_chunks)))


def run(m: int, n: int, chunk_rows_n: int, tol: float, seed: int = 0) -> dict:
    from ..problems import stream_gram
    from ..solvers import DenseGramConfig, fista_gram_dense

    # Generated into host memory untimed, like bench.py's data generation;
    # a deployment reads A from storage.
    chunks = host_chunks(m, n, chunk_rows_n, seed)

    # warm the accumulate program (compile outside the timed pass)
    jax.block_until_ready(stream_gram(chunks[:1], n=n))

    t0 = time.perf_counter()
    gram = jax.block_until_ready(stream_gram(iter(chunks), n=n))
    stream_s = time.perf_counter() - t0

    a1 = 0.1 * float(jnp.max(jnp.abs(gram.c)))
    cfg = DenseGramConfig(max_iter=3000, check_every=100, rel_gap_tol=tol)
    res = jax.block_until_ready(fista_gram_dense(gram, a1, 0.0, cfg))  # compile
    t0 = time.perf_counter()
    res = jax.block_until_ready(fista_gram_dense(gram, a1, 0.0, cfg))
    solve_s = time.perf_counter() - t0

    dev = jax.devices()[0]
    a_bytes = m * n * 4.0
    return {
        "m": m,
        "n": n,
        "a_gb": a_bytes / 1e9,
        "exceeds_device_memory": a_bytes > dev.memory_stats()["bytes_limit"],
        "chunks": len(chunks),
        "stream_s": stream_s,
        "stream_gbps": a_bytes / stream_s / 1e9,
        "solve_s": solve_s,
        "solve_iters": int(res.iters),
        "iters_per_s": int(res.iters) / solve_s,
        "rel_gap": float(res.rel_gap),
        "converged": bool(res.converged),
        "nnz_frac": float(jnp.mean(jnp.abs(res.x) > 0)),
        "device": {"platform": dev.platform, "device_kind": dev.device_kind,
                   "count": len(jax.devices())},
    }


def main(argv=None):
    from ..utils.compile_cache import configure_compile_cache

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--m", type=int, default=2**21)
    ap.add_argument("--n", type=int, default=1280)
    ap.add_argument("--chunk-rows", type=int, default=65536)
    ap.add_argument("--tol", type=float, default=1e-6)
    args = ap.parse_args(argv)
    configure_compile_cache()
    print(json.dumps(run(args.m, args.n, args.chunk_rows, args.tol)))


if __name__ == "__main__":
    main()
