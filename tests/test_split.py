"""bench/split.py: the timing split at a tiny size on CPU, and the trace
reduction's interval arithmetic."""
from __future__ import annotations

from pathlib import Path

import pytest

from fastoptsolver_tpu.bench import split


@pytest.mark.parametrize("intervals,expect", [
    ([], 0),
    ([(0, 10)], 10),
    ([(0, 10), (20, 25)], 15),
    ([(0, 10), (5, 12)], 12),          # overlap
    ([(5, 12), (0, 10), (11, 30)], 30),  # unsorted, chained
    ([(0, 10), (2, 4)], 10),           # nested
])
def test_busy_ns_is_the_union_length(intervals, expect):
    assert split.busy_ns(intervals) == expect


def test_split_rows_at_tiny_size():
    rows = split.run(64, 50, reps=1)
    assert rows[0]["what"] == "first eager solve (compiles)"
    assert rows[0]["seconds"] > 0.0
    assert [r["what"] for r in rows[1:3]] == [
        "eager solve_lasso_batch (the public path)",
        "jax.jit(solve_lasso_batch)"]
    assert len(rows) == 10
    assert all(r["median_s"] >= r["min_s"] > 0.0 for r in rows[1:])


def test_reduce_trace_without_a_trace_raises():
    with pytest.raises(FileNotFoundError, match="no trace"):
        split.reduce_trace(str(Path(__file__).parent / "no_trace_here"))
