"""Test harness configuration.

Runs the whole suite on CPU with 8 virtual XLA devices (SURVEY.md §4
"Distributed without a cluster"): sharded-matvec / psum paths execute with
no accelerator; identical code runs unmodified on a GPU mesh. Must set the
environment before the first ``import jax`` anywhere in the test process.
"""
import os

# Force CPU even where a GPU is visible: tests must not open (or reserve the
# memory of) a card. The config update covers a jax imported before this
# file; XLA backends initialize lazily, so it still wins before the first
# jax.devices() call.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

# float64 available for tight oracle comparisons (explicit dtypes only).
jax.config.update("jax_enable_x64", True)

# Persistent compile cache: OPT-IN via FOS_COMPILE_CACHE=1, at the one
# directory fastoptsolver_tpu.utils.compile_cache picks. Off by default:
# cached XLA:CPU executables are tied to the CPU features of the machine
# that compiled them, and one moved to a machine with other features was
# seen to crash on deserialization, so a test run must not depend on it.
if os.environ.get("FOS_COMPILE_CACHE"):
    from fastoptsolver_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


FRONT = {"test_sweep.py": 0, "test_routed_mesh.py": 1}


def pytest_collection_modifyitems(session, config, items):
    """Run the compile-heaviest modules first.

    Background: an XLA:CPU build was once seen to segfault inside
    ``backend_compile_and_load`` after ~265 compiles in one process. The
    suite runs under xdist workers (pyproject addopts) so no process
    approaches that count, and the compile-heaviest modules are fronted so
    their programs compile while each worker's count is still low; fronting
    the slow modules also helps xdist's scheduling. Modules are matched by
    exact file name, so a new file whose name merely contains one of these
    does not join the fronted group.
    """
    items.sort(key=lambda it: FRONT.get(it.path.name, len(FRONT)))
