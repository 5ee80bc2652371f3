"""Design matrices larger than device memory: one-pass streaming Gram.

SURVEY.md §5: problem-size scaling is this domain's long-context
equivalent. The obvious answer would chunk the per-iteration matvec
``Aᵀ(Ay − b)`` (reference ``iterative_solvers.py:173``) and re-stream A from
the host every iteration — paying PCIe bandwidth × iterations. This module
streams A exactly ONCE: the composite objective only ever touches A
through ``Q = AᵀA`` (n×n), ``c = Aᵀb`` and ``bᵀb``, so a single chunked pass
accumulates those on device (matmuls at HIGHEST precision, double-buffered
host→device transfers), and the certified FISTA then runs entirely on-device
at O(n²)/iteration, independent of m. For n = 1e4, Q is 400 MB — 100× smaller
than A; m is unbounded by device memory (chunks may come from RAM, np.memmap,
or a generator).

Solving happens in :mod:`fastoptsolver_tpu.solvers.gram_dense`
(``fista_gram_dense``) or, for stacks of such instances, the existing batched
Gram machinery.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

import numpy as np

import jax
import jax.numpy as jnp
from jax import Array


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DenseGram:
    """Gram form of one (possibly enormous) least-squares instance."""

    Q: Array  # (n, n) — AᵀA
    c: Array  # (n,)   — Aᵀb
    btb: Array  # ()   — bᵀb
    m: Array  # ()     — total rows reduced (informational)

    @property
    def dim(self) -> int:
        return self.Q.shape[0]


def _kahan(acc, comp, delta):
    """One compensated accumulation step: acc += delta with the running
    rounding error carried in comp — the stored sum stays within ~one f32
    rounding of the true sum regardless of chunk count (vs O(#chunks)
    roundings plain; matters because the duality-gap certification,
    solvers/gram_dense.py, is only as honest as the stored triple)."""
    # optimization_barrier: XLA's algebraic simplifier would rewrite
    # (acc + y) - acc → y and erase the compensation (see ops/df32.py)
    y = delta - comp
    t = jax.lax.optimization_barrier(acc + y)
    comp = jax.lax.optimization_barrier(t - acc) - y
    return t, comp


def _accum(Q, Qc, c, cc, btb, bc, m, A_i, b_i):
    """One chunk's contribution. Donated accumulators — Q is updated in
    place on device (one Q ever resident, not 2Q); in-flight prefetched
    chunks add to the envelope (see ``stream_gram``)."""
    hi = jax.lax.Precision.HIGHEST  # a TF32 default would lose ~1e-3
    Q, Qc = _kahan(Q, Qc, jnp.matmul(A_i.T, A_i, precision=hi))
    c, cc = _kahan(c, cc, jnp.matmul(A_i.T, b_i, precision=hi))
    btb, bc = _kahan(btb, bc, jnp.vdot(b_i, b_i))
    return Q, Qc, c, cc, btb, bc, m + A_i.shape[0]


_accum = jax.jit(_accum, donate_argnums=(0, 1, 2, 3, 4, 5, 6))


def stream_gram(
    chunks: Iterable[tuple[np.ndarray, np.ndarray]],
    n: int,
    dtype=jnp.float32,
    prefetch: int = 2,
) -> DenseGram:
    """Reduce an iterable of host ``(A_chunk (mᵢ, n), b_chunk (mᵢ,))`` pairs
    to the on-device Gram form in one streaming pass.

    Transfers are double-buffered: up to ``prefetch`` chunks are enqueued with
    ``jax.device_put`` (asynchronous) while the device reduces the current one,
    so the pass runs at min(link bandwidth, matmul throughput). Peak HBM is
    Q + ``prefetch`` chunks. Chunks may have different row counts (each
    distinct mᵢ compiles once — keep chunk sizes uniform apart from the
    tail).
    """
    Q = jnp.zeros((n, n), dtype)
    Qc = jnp.zeros((n, n), dtype)  # Kahan compensation (one extra Q of HBM)
    c = jnp.zeros((n,), dtype)
    cc = jnp.zeros((n,), dtype)
    btb = jnp.zeros((), dtype)
    bc = jnp.zeros((), dtype)
    m = jnp.zeros((), jnp.int64 if jax.config.jax_enable_x64 else jnp.int32)

    it = iter(chunks)
    buf: list[tuple[Array, Array]] = []

    def put(pair):
        A_i, b_i = pair
        if A_i.shape[1] != n:
            raise ValueError(f"chunk has {A_i.shape[1]} features, expected {n}")
        return (
            jax.device_put(jnp.asarray(A_i, dtype)),
            jax.device_put(jnp.asarray(b_i, dtype)),
        )

    for pair in it:
        buf.append(put(pair))
        if len(buf) < prefetch:
            continue
        A_i, b_i = buf.pop(0)
        Q, Qc, c, cc, btb, bc, m = _accum(Q, Qc, c, cc, btb, bc, m, A_i, b_i)
    while buf:
        A_i, b_i = buf.pop(0)
        Q, Qc, c, cc, btb, bc, m = _accum(Q, Qc, c, cc, btb, bc, m, A_i, b_i)
    return DenseGram(Q=Q, c=c, btb=btb, m=m)


def chunk_rows(
    A, b, rows: int
) -> Iterable[tuple[np.ndarray, np.ndarray]]:
    """Row-chunk views over array-likes supporting 2-D slicing — NumPy
    arrays, ``np.memmap`` (out-of-core from disk), h5py datasets, …
    Views, not copies: the host array is never duplicated."""
    m = A.shape[0]
    for lo in range(0, m, rows):
        hi = min(lo + rows, m)
        yield A[lo:hi], b[lo:hi]


def generator_chunks(
    make_chunk: Callable[[int], tuple[np.ndarray, np.ndarray]], n_chunks: int
) -> Iterable[tuple[np.ndarray, np.ndarray]]:
    """Chunks produced on demand (seeded generators): the full A never exists
    anywhere — not in HBM, not in host RAM."""
    for i in range(n_chunks):
        yield make_chunk(i)


def merge_grams(local: DenseGram, mesh, axis: str | tuple = "host") -> DenseGram:
    """Row-distributed Gram reduction: each host/device streams ONLY ITS OWN
    rows of A through :func:`stream_gram`, then the partial (Q, c, bᵀb) are
    summed with one ``psum``-shaped collective — the complete multi-host
    answer to the north star's 1e6×1e4 A: 40 GB of rows split across hosts,
    each streamed once locally, merged by a single (n², n, 1)-sized
    all-reduce across hosts. The merged Gram is replicated, so the subsequent
    O(n²)/iter solve (solvers/gram_dense.py) runs identically everywhere
    with zero further communication.

    ``local`` holds this process's partial reduction. Works on a real
    multi-host slice and on a single-process mesh alike: each participant's
    partial is placed on the mesh and summed under jit (XLA lowers the sum of
    per-host shards to the cross-host collective).
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    if jax.process_count() > 1:
        # every process contributes its local partial; stack globally then sum
        stacked_Q = jax.make_array_from_process_local_data(
            NamedSharding(mesh, P(axes)), np.asarray(local.Q)[None]
        )
        stacked_c = jax.make_array_from_process_local_data(
            NamedSharding(mesh, P(axes)), np.asarray(local.c)[None]
        )
        stacked_b = jax.make_array_from_process_local_data(
            NamedSharding(mesh, P(axes)), np.asarray(local.btb)[None]
        )
        stacked_m = jax.make_array_from_process_local_data(
            NamedSharding(mesh, P(axes)), np.asarray(local.m)[None]
        )
        red = jax.jit(
            lambda q, c, b, m: (q.sum(0), c.sum(0), b.sum(0), m.sum(0)),
            out_shardings=NamedSharding(mesh, P()),
        )
        Q, c, btb, m = red(stacked_Q, stacked_c, stacked_b, stacked_m)
        return DenseGram(Q=Q, c=c, btb=btb, m=m)
    # single process: nothing to merge across, just replicate
    return local
