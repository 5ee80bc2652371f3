"""Subprocess worker for tests/test_multihost.py — one simulated host.

Run as ``python tests/multihost_worker.py <process_id> <num_processes> <port>``
with ``XLA_FLAGS=--xla_force_host_platform_device_count=K``. Two of these
processes form a 2-host × K-chip mesh over the gloo-backed CPU distributed
runtime: psums over the "host" axis cross a real process boundary (the
simulated cross-host path), psums over "chip" stay in-process (the simulated
in-host interconnect). The reference has no analogue (single-process NumPy,
/root/reference/iterative_solvers.py:1-6); this pins SURVEY.md §4's
"distributed without a cluster" strategy for the multi-host half.

Every check compares against a purely local single-device solve of the same
problem (deterministic seeds → every process can reconstruct the full data).
Prints MULTIHOST_OK and exits 0 on success.
"""
import sys

import jax

# CPU only, whatever accelerator is visible (as tests/conftest.py), and the
# compile cache where the one rule puts it.
jax.config.update("jax_platforms", "cpu")

from fastoptsolver_tpu.utils.compile_cache import configure_compile_cache

configure_compile_cache()

import numpy as np


def main(pid: int, nproc: int, port: int) -> None:
    from fastoptsolver_tpu.parallel import multihost

    multihost.initialize(
        coordinator_address=f"127.0.0.1:{port}", num_processes=nproc, process_id=pid
    )
    assert jax.process_count() == nproc, jax.process_count()

    import jax.numpy as jnp

    from fastoptsolver_tpu.batch import make_gram_batch
    from fastoptsolver_tpu.batch.fista_gram import BatchFISTAConfig, fista_gram_batch
    from fastoptsolver_tpu.parallel import DistributedLeastSquares, consensus_admm
    from fastoptsolver_tpu.problems import LeastSquares
    from fastoptsolver_tpu.solvers import ADMMConfig, FISTAConfig, fista

    mesh = multihost.make_host_chip_mesh()
    assert mesh.shape[multihost.HOST_AXIS] == nproc
    chips = mesh.shape[multihost.CHIP_AXIS]

    # Shared problem, reconstructible on every host.
    rng = np.random.default_rng(0)
    m, n = 8 * nproc * chips, 6
    A = rng.normal(size=(m, n))
    x_true = np.array([1.5, 0.0, -2.0, 0.0, 0.5, 0.0])
    b = A @ x_true + 0.1 * rng.normal(size=m)
    cfg = FISTAConfig(max_iter=200)
    local_ref = np.asarray(
        jax.jit(lambda: fista(LeastSquares.create(A, b, "lasso", 0.5, 0.0), cfg).x)()
    )

    # 1) Row-sharded FISTA with A split over (host, chip) jointly: the fused
    #    gradient's psum reduces over both axes in one collective.
    dist = DistributedLeastSquares.create(
        A, b, mesh, "lasso", 0.5, 0.0,
        axis=(multihost.HOST_AXIS, multihost.CHIP_AXIS), layout="row",
    )
    x_dist = np.asarray(jax.jit(lambda p: fista(p, cfg).x)(dist))
    np.testing.assert_allclose(x_dist, local_ref, rtol=1e-5, atol=1e-6)

    # 2) Consensus ADMM with row blocks owned per-host (one n-vector psum per
    #    iteration crossing the process boundary).
    res = consensus_admm(
        A, b, mesh, "lasso", 0.5, 0.0,
        config=ADMMConfig(max_iter=600), axis=multihost.HOST_AXIS,
    )
    np.testing.assert_allclose(np.asarray(res.x), local_ref, rtol=1e-3, atol=1e-4)

    # 3) Host-sharded instance batch assembled from process-LOCAL data: each
    #    host precomputes the Gram form of only its own instances.
    B_local = 4
    lrng = np.random.default_rng(100 + pid)
    A_loc = lrng.normal(size=(B_local, 24, 5)).astype(np.float32)
    b_loc = lrng.normal(size=(B_local, 24)).astype(np.float32)
    local_gb = make_gram_batch(A_loc, b_loc, alpha1=0.2, alpha2=0.1)
    gb = multihost.gram_batch_from_local(local_gb, mesh, axis=multihost.HOST_AXIS)
    bcfg = BatchFISTAConfig(max_iter=150, check_every=0)
    out = jax.jit(lambda g: fista_gram_batch(g, bcfg).x)(gb)
    x_all = multihost.allgather(out)  # (nproc*B_local, n) — result.x is batch-major
    # Oracle: every process reconstructs all hosts' instances and solves locally.
    for other in range(nproc):
        orng = np.random.default_rng(100 + other)
        A_o = orng.normal(size=(B_local, 24, 5)).astype(np.float32)
        b_o = orng.normal(size=(B_local, 24)).astype(np.float32)
        ref = np.asarray(
            jax.jit(
                lambda g: fista_gram_batch(g, bcfg).x
            )(make_gram_batch(A_o, b_o, alpha1=0.2, alpha2=0.1))
        )
        got = x_all[other * B_local : (other + 1) * B_local, :]
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)

    # 4) Multi-host streaming Gram (north-star 1e6×1e4 story): each host
    #    streams only ITS OWN rows; one psum-shaped all-reduce of the n²
    #    partials across processes yields the replicated Gram, and the dense
    #    certified solve then runs with zero further communication.
    from fastoptsolver_tpu.problems import chunk_rows, merge_grams, stream_gram
    from fastoptsolver_tpu.solvers import DenseGramConfig, fista_gram_dense

    ms, ns = 512, 10
    grng = np.random.default_rng(7)
    A_all = grng.normal(size=(nproc * ms, ns)).astype(np.float32)
    xs = np.zeros(ns, np.float32)
    xs[:3] = [2.0, -1.0, 0.5]
    b_all = (A_all @ xs + 0.05 * grng.normal(size=nproc * ms)).astype(np.float32)
    mine = slice(pid * ms, (pid + 1) * ms)  # this host's rows only
    local = stream_gram(chunk_rows(A_all[mine], b_all[mine], rows=128), n=ns)
    gram = merge_grams(local, mesh, axis=multihost.HOST_AXIS)
    assert int(gram.m) == nproc * ms, int(gram.m)
    a1s = 0.02 * float(np.max(np.abs(A_all.T @ b_all)))
    dres = fista_gram_dense(
        gram, a1s, 0.0,
        DenseGramConfig(max_iter=2000, check_every=50, rel_gap_tol=1e-6),
    )
    assert bool(dres.converged), float(dres.rel_gap)
    # oracle: single-host full-data Gram solve
    g_ref = stream_gram(chunk_rows(A_all, b_all, rows=256), n=ns)
    ref = fista_gram_dense(
        g_ref, a1s, 0.0,
        DenseGramConfig(max_iter=2000, check_every=50, rel_gap_tol=1e-6),
    )
    np.testing.assert_allclose(
        np.asarray(dres.x), np.asarray(ref.x), rtol=1e-4, atol=1e-5
    )

    print(f"MULTIHOST_OK pid={pid}", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))
