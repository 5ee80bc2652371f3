"""fastoptsolver_tpu — a first-order composite-optimization framework in JAX.

A from-scratch JAX / XLA framework covering the problem class of the
reference ElBaldo1/FastOptSolver (L1 / ridge / elastic-net regularized least
squares and smooth objectives; ISTA, FISTA with Nesterov momentum + adaptive
restart, FISTA-Δ fixed momentum, Armijo backtracking, L-BFGS), redesigned
for an accelerator (it runs on an NVIDIA GPU, and on the CPU for tests):

- solvers are ``lax.while_loop`` / ``lax.scan`` fixed-points over immutable
  state pytrees — one XLA program per solve;
- thousands of problem instances vmap into a single compiled batch
  (``fastoptsolver_tpu.batch``);
- large design matrices shard row/column-wise over a ``jax.sharding.Mesh``
  with psum-reduced distributed matvecs (``fastoptsolver_tpu.parallel``);
- L-BFGS is implemented from scratch (two-loop recursion over a curvature-pair
  ring buffer, Wolfe line search) in pure JAX — no SciPy/Fortran.
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# XLA's default f32 matmul precision on an accelerator may run the products
# in reduced precision: TF32 on a GPU's tensor cores (~1e-3 relative error),
# bf16 passes elsewhere. For a library whose contract is *certified* solves
# (duality gap ≤ 1e-6) that default is wrong everywhere: once a contraction
# is wide enough to go to the matrix units, the gradient Q·x loses most of
# its mantissa and the achievable gap floors far above the tolerance. Hot
# paths also annotate their einsums with Precision.HIGHEST explicitly; this
# global sets the correct default for everything else (problem-protocol
# matvecs, gap checks, user code built on the library). chip_smoke.py's
# `precision` phase checks it on the card. Opt out / override with
# FOS_MATMUL_PRECISION=default|tensorfloat32|bfloat16|…
_prec = _os.environ.get("FOS_MATMUL_PRECISION", "highest")
if _prec != "default" and _jax.config.jax_default_matmul_precision is None:
    # Respect an explicit user choice made before this import (the config
    # default is None): only fill in the library default when nothing was
    # configured — import order must not silently override user settings
    # (README "numerics contract" section documents this interaction).
    _jax.config.update("jax_default_matmul_precision", _prec)

from . import batch, ops, parallel, problems, runtime, solvers, utils
from .api import solve
from .estimators import (
    Lasso,
    ElasticNet,
    Ridge,
    LassoCV,
    ElasticNetCV,
    MultiTaskLasso,
)
from .ops import (
    soft_threshold,
    prox_l1,
    prox_elastic_net,
    compute_objective,
    estimate_lipschitz,
)
from .problems import (
    LeastSquares,
    GramLeastSquares,
    LogisticRegression,
    CustomProblem,
    generate_boston_like,
    generate_scenario_batch,
)
from .solvers import (
    ISTAConfig,
    FISTAConfig,
    ista,
    fista,
    fista_with_history,
    fista_delta_config,
)
