"""Multi-host distribution: bootstrap, hybrid meshes, and
process-local data assembly.

The reference is single-process (SURVEY.md §2 "Parallelism: none" —
`/root/reference/iterative_solvers.py:1-6` imports nothing but numpy/scipy).
This module is the framework's cross-host layer, in place of an NCCL/MPI
bootstrap: `jax.distributed.initialize` wires processes into one JAX
runtime, after which XLA owns the transport — collectives ride the in-host
interconnect (NVLink between a host's GPUs) within a host and the network
across hosts, chosen by how the mesh is laid out.

Design rules (jax-ml.github.io/scaling-book):

- The **host axis is the network** — put the low-traffic parallelism there. For this
  framework that is instance parallelism (independent problem batches; the
  only cross-host traffic is the convergence all-reduce of one scalar) or
  consensus ADMM (one n-vector psum per iteration).
- The **chip axis is the in-host interconnect** — put the per-iteration
  matvec psums
  (parallel/matvec.py) there.

Everything below works identically on a real multi-host cluster and on a
multi-process CPU simulation (two processes with
``--xla_force_host_platform_device_count=K`` each — SURVEY.md §4
"distributed without a cluster"); tests/test_multihost.py runs the latter.
"""
from __future__ import annotations

import os

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

HOST_AXIS = "host"
CHIP_AXIS = "chip"

_ENV_COORD = "FASTOPT_COORDINATOR"
_ENV_NPROC = "FASTOPT_NUM_PROCESSES"
_ENV_PID = "FASTOPT_PROCESS_ID"


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    **kwargs,
) -> None:
    """Join this process to the multi-host JAX runtime (idempotent).

    Arguments fall back to ``FASTOPT_COORDINATOR`` / ``FASTOPT_NUM_PROCESSES``
    / ``FASTOPT_PROCESS_ID`` env vars, and from there to JAX's own automatic
    cluster detection (SLURM, …). A process that is not
    part of any cluster (no args, no env) is left alone — single-process JAX
    keeps working, so library code can call this unconditionally.
    """
    from jax._src import distributed as _dist

    if _dist.global_state.client is not None:
        return  # already initialized (jax.process_count() would init a backend)
    coordinator_address = coordinator_address or os.environ.get(_ENV_COORD)
    if num_processes is None and _ENV_NPROC in os.environ:
        num_processes = int(os.environ[_ENV_NPROC])
    if process_id is None and _ENV_PID in os.environ:
        process_id = int(os.environ[_ENV_PID])
    if coordinator_address is None and num_processes is None:
        return  # standalone process; nothing to join
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        **kwargs,
    )


def make_host_chip_mesh(
    hosts: int | None = None,
    chips_per_host: int | None = None,
    devices=None,
    host_axis: str = HOST_AXIS,
    chip_axis: str = CHIP_AXIS,
) -> Mesh:
    """Build a ``(host, chip)`` mesh whose leading axis crosses process
    boundaries (the network) and whose trailing axis stays within a process
    (the in-host interconnect).

    Multi-process: devices are grouped by ``process_index`` so each mesh row
    is exactly one host's devices — a psum over ``host_axis`` crosses the
    network, a psum over ``chip_axis`` stays within the host. Single-process
    (CPU simulation, a virtual mesh, or one host's cards): the device list is
    split into
    ``hosts`` equal groups so the same two-axis programs run unchanged.
    """
    devices = list(jax.devices()) if devices is None else list(devices)
    n_proc = jax.process_count()
    if n_proc > 1:
        by_proc: dict[int, list] = {}
        for d in devices:
            by_proc.setdefault(d.process_index, []).append(d)
        counts = {len(v) for v in by_proc.values()}
        if len(counts) != 1:
            raise ValueError(f"uneven devices per process: { {k: len(v) for k, v in by_proc.items()} }")
        local = counts.pop()
        if hosts is None:
            hosts = len(by_proc)
        if chips_per_host is None:
            chips_per_host = local
        if hosts != len(by_proc) or chips_per_host != local:
            raise ValueError(
                f"requested {hosts}x{chips_per_host} mesh but topology is "
                f"{len(by_proc)} processes x {local} devices"
            )
        rows = [sorted(by_proc[p], key=lambda d: d.id) for p in sorted(by_proc)]
        arr = np.asarray(rows)
    else:
        n = len(devices)
        if hosts is None:
            hosts = 1 if chips_per_host is None else n // chips_per_host
        if chips_per_host is None:
            chips_per_host = n // hosts
        if hosts * chips_per_host != n:
            raise ValueError(f"mesh {hosts}x{chips_per_host} != {n} devices")
        arr = np.asarray(devices).reshape(hosts, chips_per_host)
    return Mesh(arr, (host_axis, chip_axis))


def host_sharded(mesh: Mesh, axis: str = HOST_AXIS) -> NamedSharding:
    """Leading-dim sharding over the host (cross-process) axis."""
    return NamedSharding(mesh, P(axis))


def from_process_local(local_data, mesh: Mesh, spec: P):
    """Assemble a global sharded array from each process's local block.

    This is the multi-host data plane: no host ever materializes the global
    array — each contributes the rows/instances it generated or loaded, and
    ``jax.make_array_from_process_local_data`` stitches the addressable
    shards into one logical array laid out by ``spec``.
    """
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_process_local_data(sharding, np.asarray(local_data))


def gram_batch_from_local(local_gb, mesh: Mesh, axis: str = HOST_AXIS):
    """Build a host-sharded GramBatch from per-process local instance blocks.

    Each process precomputes the Gram form of its OWN instances
    (batch/api.py:make_gram_batch on local data); the global batch is the
    concatenation along the trailing instance axis, sharded over ``axis``.
    Cross-host traffic during the solve is then a single scalar all-reduce
    per convergence check.
    """
    from ..batch.fista_gram import GramBatch

    return GramBatch(
        Q=from_process_local(local_gb.Q, mesh, P(None, None, axis)),
        c=from_process_local(local_gb.c, mesh, P(None, axis)),
        btb=from_process_local(local_gb.btb, mesh, P(axis)),
        alpha1=from_process_local(local_gb.alpha1, mesh, P(axis)),
        alpha2=from_process_local(local_gb.alpha2, mesh, P(axis)),
        L=from_process_local(local_gb.L, mesh, P(axis)),
    )


def allgather(x):
    """Gather a (possibly non-addressable) global array onto every host as a
    NumPy value — the cross-host analogue of ``np.asarray(device_array)``."""
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))
