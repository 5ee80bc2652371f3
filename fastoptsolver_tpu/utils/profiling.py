"""Profiling / observability utilities.

The reference's only observability is module-global wall-time lists around
individual NumPy calls (``/root/reference/iterative_solvers.py:16-40``) —
meaningless under XLA, where the whole solve is one fused program and any
host-side timer forces a device sync. The compiled-world replacements:

- :func:`trace` — ``jax.profiler`` trace context; open the dump in
  TensorBoard/XProf for per-op device timelines (the real per-kernel story).
- :func:`timed` — wall-clock timing with proper ``block_until_ready``
  semantics and warmup (compile) separation.
- :func:`solver_stats` — per-solve counters from the functional ``Metrics``
  carried in solver state (grad evals, line-search calls/backtracks), i.e.
  the reference's ``get_metrics`` numbers, but vmappable and race-free.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Callable

import numpy as np

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace("traces/solve"): solve(...)`` → profile dump for
    TensorBoard / XProf."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def timed(fn: Callable[..., Any], *args, repeats: int = 3, warmup: int = 1):
    """Run ``fn(*args)`` with warmup (compile) excluded; returns
    ``(last_output, stats_dict)`` with mean/median/min/max wall seconds and
    every repeat's time, each ended by ``block_until_ready``."""
    out = None
    for _ in range(max(warmup, 0)):
        out = jax.block_until_ready(fn(*args))
    times = []
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return out, {
        "mean_s": float(np.mean(times)),
        "median_s": float(np.median(times)),
        "min_s": float(np.min(times)),
        "max_s": float(np.max(times)),
        "repeats": len(times),
        "times_s": times,
    }


def solver_stats(result) -> dict:
    """Counters for a ``SolveResult`` (or a vmapped batch of them) — the
    functional equivalent of the reference's ``get_metrics``
    (iterative_solvers.py:26-40)."""
    m = result.metrics

    def tot(x):
        return int(np.sum(np.asarray(x)))

    n_iters = tot(result.n_iters)
    return {
        "n_iters": n_iters,
        "grad_num_calls": tot(m.n_grad_evals),
        "ls_num_calls": tot(m.n_ls_calls),
        "ls_iters_total": tot(m.ls_iters_total),
        "backtracks_per_ls": (
            tot(m.ls_iters_total) / tot(m.n_ls_calls) if tot(m.n_ls_calls) else 0.0
        ),
    }
