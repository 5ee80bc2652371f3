"""The package must pin f32 matmul precision at import.

XLA's default f32 matmul precision on an accelerator may run in reduced
precision — TF32 on a GPU's tensor cores, ~1e-3 relative error — which
floors the achievable duality gap far above a 1e-6 certificate once a
contraction is wide enough to go to the matrix units. A certification
library cannot run on that default, so fastoptsolver_tpu's __init__ sets
jax_default_matmul_precision="highest" (overridable via
FOS_MATMUL_PRECISION). The CPU cannot reproduce the numerical failure — this
pins the configuration; chip_smoke.py's ``precision`` phase checks it on the
GPU (an f32 4096² matmul at f32 accuracy, not TF32's).
"""
import os

import jax

import fastoptsolver_tpu  # noqa: F401 — import must set the default


def test_default_matmul_precision_pinned():
    assert os.environ.get("FOS_MATMUL_PRECISION", "highest") == "highest", (
        "test environment overrode FOS_MATMUL_PRECISION; this test assumes "
        "the default"
    )
    assert jax.config.jax_default_matmul_precision == "highest"


def test_hot_loop_einsums_pin_precision_explicitly():
    # The driver's correctness-defining einsums do not rely on the global
    # (a user's jax.default_matmul_precision context must not weaken them).
    import inspect

    from fastoptsolver_tpu.batch import fista_gram

    src = inspect.getsource(fista_gram)
    assert src.count("precision=_HI") >= 4
