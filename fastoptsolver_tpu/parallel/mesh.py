"""Device-mesh helpers.

The reference has no distribution at all (SURVEY.md §2 'Parallelism: none').
This framework scales along two axes:

- ``"batch"`` — instance parallelism: independent problem instances sharded
  across chips (zero communication except the convergence all-reduce);
- ``"model"`` — problem parallelism: one large design matrix row- or
  column-sharded across chips, with psum-reduced distributed matvecs
  (parallel/matvec.py). On hardware, keep this axis within one host's
  NVLink-connected cards.

Mesh creation is the one place device topology enters; everything else takes
``(mesh, axis_name)`` and works identically on a CPU-simulated mesh
(``--xla_force_host_platform_device_count``) and real GPUs.
"""
from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BATCH_AXIS = "batch"
MODEL_AXIS = "model"


def make_mesh(
    batch: int | None = None,
    model: int | None = None,
    devices=None,
) -> Mesh:
    """Build a (batch × model) mesh. With only one size given, the other takes
    all remaining devices; with neither, everything goes to ``batch``."""
    devices = list(jax.devices()) if devices is None else list(devices)
    n = len(devices)
    if batch is None and model is None:
        batch, model = n, 1
    elif batch is None:
        batch = n // model
    elif model is None:
        model = n // batch
    if batch * model != n:
        raise ValueError(f"mesh {batch}x{model} != {n} devices")
    arr = np.asarray(devices).reshape(batch, model)
    return Mesh(arr, (BATCH_AXIS, MODEL_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def row_sharding(mesh: Mesh, axis: str = MODEL_AXIS) -> NamedSharding:
    """(m, n) matrix sharded along rows."""
    return NamedSharding(mesh, P(axis, None))


def col_sharding(mesh: Mesh, axis: str = MODEL_AXIS) -> NamedSharding:
    """(m, n) matrix sharded along columns."""
    return NamedSharding(mesh, P(None, axis))


def vec_sharding(mesh: Mesh, axis: str = MODEL_AXIS) -> NamedSharding:
    return NamedSharding(mesh, P(axis))
