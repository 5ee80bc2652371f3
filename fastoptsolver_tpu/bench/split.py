"""Where the headline solve's time goes on one card: a timing split and a
trace reduction.

Each row is the median (and minimum) of ``--reps`` calls, each ended by
``block_until_ready``, after one warm-up call: the public eager
``solve_lasso_batch``; the same call under one ``jax.jit``; a mesh of one
device (the compiled per-shard program of the mesh path); the layout
transposes; the Gram build with its power iteration (eager); the Gram
einsums alone; the power iteration alone; the FISTA driver (eager); one
batched matvec. The first row also reads the card's ``bytes_in_use`` before
the first call and its peak after it (that call compiles).

With ``--trace-dir`` one more eager solve is traced with ``jax.profiler``
and reduced to the first device plane's busy time, span, idle share and
busiest kernels (:func:`reduce_trace`).

CLI:  python -m fastoptsolver_tpu.bench.split [--batch 262144] [--m 1000]
          [--reps 5] [--trace-dir chiprun_out/trace_split]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import statistics
import time

import jax
import jax.numpy as jnp


def _median_time(fn, reps: int) -> dict:
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return {"median_s": statistics.median(ts), "min_s": min(ts)}


def _memory(key: str):
    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats[key]


def run(batch: int, m: int, reps: int = 5, seed: int = 0) -> list[dict]:
    """The timing split at ``(batch, m)``; one dict per row."""
    from ..batch import fista_gram_batch, make_gram_batch, solve_lasso_batch
    from ..batch.fista_gram import _batched_power_L
    from ..parallel import make_mesh
    from . import headline

    cfg = headline.CFG
    A, b, a1 = jax.block_until_ready(
        headline.build_problems(jax.random.PRNGKey(seed), batch, m))
    hi = jax.lax.Precision.HIGHEST
    eager = lambda: solve_lasso_batch(A, b, a1, 0.0, cfg=cfg,
                                      feature_major=True)
    rows = []
    before = _memory("bytes_in_use")
    t0 = time.perf_counter()
    jax.block_until_ready(eager())
    rows.append({"what": "first eager solve (compiles)",
                 "seconds": time.perf_counter() - t0,
                 "bytes_in_use_before": before,
                 "peak_bytes_after": _memory("peak_bytes_in_use")})

    jitted = jax.jit(lambda A, b, a1: solve_lasso_batch(
        A, b, a1, 0.0, cfg=cfg, feature_major=True))
    mesh1 = make_mesh(batch=1, model=1, devices=jax.devices()[:1])
    transpose = jax.jit(lambda A, b: (jnp.transpose(A, (2, 1, 0)),
                                      jnp.transpose(b, (1, 0))))
    A_im, b_im = transpose(A, b)
    gb = make_gram_batch(A_im, b_im, a1, 0.0)
    gram = jax.jit(lambda A, b: (
        jnp.einsum("bmi,bmj->ijb", A, A, precision=hi),
        jnp.einsum("bmi,bm->ib", A, b, precision=hi)))
    v0 = jax.random.normal(jax.random.PRNGKey(0), gb.c.shape, gb.c.dtype)
    power = jax.jit(lambda Q, v: _batched_power_L(Q, v, 100, 1e-6))
    matvec = jax.jit(lambda Q, Y: jnp.einsum("ijb,jb->ib", Q, Y,
                                             precision=hi))
    cases = [
        ("eager solve_lasso_batch (the public path)", eager),
        ("jax.jit(solve_lasso_batch)", lambda: jitted(A, b, a1)),
        ("mesh of one device", lambda: solve_lasso_batch(
            A, b, a1, 0.0, cfg=cfg, feature_major=True, mesh=mesh1)),
        ("transposes of A and b (jit)", lambda: transpose(A, b)),
        ("make_gram_batch, eager, incl. power iteration",
         lambda: make_gram_batch(A_im, b_im, a1, 0.0)),
        ("Gram einsums alone (jit)", lambda: gram(A_im, b_im)),
        ("power iteration alone (jit)", lambda: power(gb.Q, v0)),
        ("fista_gram_batch, eager", lambda: fista_gram_batch(gb, cfg)),
        ("one batched matvec ijb,jb->ib", lambda: matvec(gb.Q, gb.c)),
    ]
    for what, fn in cases:
        rows.append({"what": what, **_median_time(fn, reps)})
    return rows


def busy_ns(intervals) -> int:
    """Total length of the union of ``(start, end)`` intervals."""
    busy, cur = 0, None
    for s, e in sorted(intervals):
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy


def reduce_trace(trace_dir: str, top: int = 12) -> dict:
    """Busy time, span, idle share and the ``top`` kernels (total ms) of
    the first ``/device:`` plane in the newest trace under ``trace_dir``."""
    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no trace under {trace_dir}")
    data = ProfileData.from_file(paths[-1])
    planes = [p for p in data.planes if p.name.startswith("/device:")]
    if not planes:
        raise ValueError(f"no device plane in {paths[-1]}")
    plane = planes[0]
    intervals, by_name = [], {}
    for line in plane.lines:
        for ev in line.events:
            intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.duration_ns
    if not intervals:
        raise ValueError(f"{plane.name} holds no events: nothing ran there")
    span = max(e for _, e in intervals) - min(s for s, _ in intervals)
    busy = busy_ns(intervals)
    heavy = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"plane": plane.name, "events": len(intervals),
            "busy_ms": busy / 1e6, "span_ms": span / 1e6,
            "idle_share": 1.0 - busy / span if span else None,
            "top_ms": [[name[:80], ns / 1e6] for name, ns in heavy]}


def trace_eager_solve(batch: int, m: int, trace_dir: str,
                      seed: int = 0) -> dict:
    """Trace one warm eager headline solve into ``trace_dir`` and reduce it."""
    from ..batch import solve_lasso_batch
    from . import headline

    A, b, a1 = jax.block_until_ready(
        headline.build_problems(jax.random.PRNGKey(seed), batch, m))
    solve = lambda: solve_lasso_batch(A, b, a1, 0.0, cfg=headline.CFG,
                                      feature_major=True)
    jax.block_until_ready(solve())
    with jax.profiler.trace(trace_dir):
        jax.block_until_ready(solve())
    return reduce_trace(trace_dir)


def main(argv=None) -> int:
    from ..utils.compile_cache import configure_compile_cache
    from .device import query_nvidia_smi, require_gpu
    from .headline import BATCH, M

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--m", type=int, default=M)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--trace-dir", default=None)
    args = ap.parse_args(argv)
    print(query_nvidia_smi(), flush=True)
    device = require_gpu(jax.devices())
    configure_compile_cache()
    for row in run(args.batch, args.m, args.reps):
        print(json.dumps(row), flush=True)
    if args.trace_dir:
        print(json.dumps(trace_eager_solve(args.batch, args.m,
                                           args.trace_dir)), flush=True)
    print(json.dumps({"device": device}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
