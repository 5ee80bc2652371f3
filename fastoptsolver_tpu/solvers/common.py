"""Shared solver infrastructure: functional metrics, results, Armijo search.

Design notes (vs. the reference):

- The reference tracks per-call timings in *module-global lists* shared across
  solver modules (``/root/reference/iterative_solvers.py:16-40``,
  ``lbfgs.py:5``) — process-global mutable state that cannot be jitted,
  vmapped, or run concurrently. Here metrics are **counters carried in the
  solver state pytree**: every instance of a vmapped batch gets its own
  metrics, and wall-clock attribution comes from ``jax.profiler`` traces
  around the compiled solve instead of ``time.perf_counter`` pairs around
  individual NumPy calls (which would force a host sync every iteration).

- The Armijo backtracking line search (reference ``iterative_solvers.py:92-108``,
  ``:183-197``) is an inner ``lax.while_loop``: sufficient-decrease test
  ``g(x⁺) ≤ g(y) + C·⟨∇g(y), x⁺−y⟩`` with C = 1e-2 and geometric shrink
  η = 0.5; the accepted step persists to the next outer iteration and never
  grows back (contract item 2 in SURVEY.md §7). The loop is bounded by
  ``max_backtracks`` (float32 τ underflows after ~150 halvings; the
  reference's unbounded ``while True`` is not jittable and can hang).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import Array

# Armijo sufficient-decrease constant, matching the reference's module-level
# ``C`` (iterative_solvers.py:11).
ARMIJO_C = 1e-2


class Metrics(NamedTuple):
    """Per-solve counters (each leaf is a scalar; batches carry one per
    instance). Functional replacement for the reference's global lists."""

    n_grad_evals: Array
    n_ls_calls: Array
    ls_iters_total: Array

    @classmethod
    def zero(cls) -> "Metrics":
        z = jnp.zeros((), jnp.int32)
        return cls(n_grad_evals=z, n_ls_calls=z, ls_iters_total=z)


class History(NamedTuple):
    """Fixed-length per-iteration trace (padded to ``max_iter``; entries with
    ``valid == False`` repeat the last real iterate). The jit-friendly
    equivalent of the reference's Python-list histories
    (iterative_solvers.py:83, :160, :279)."""

    x: Array  # (max_iter, n)
    obj: Array  # (max_iter,)
    step_norm: Array  # (max_iter,)
    valid: Array  # (max_iter,) bool
    tau: Array | None = None  # (max_iter,) step size used at each iteration


class SolveResult(NamedTuple):
    x: Array
    n_iters: Array
    L: Array  # Lipschitz estimate used (0 where not applicable)
    final_tau: Array  # last accepted step size
    metrics: Metrics
    history: History | None = None


def tree_where(pred: Array, on_true, on_false):
    """Elementwise ``where`` over matching pytrees (scalar or broadcastable
    predicate). Used to freeze converged lanes inside batched loops."""
    return jax.tree.map(lambda a, b: jnp.where(pred, a, b), on_true, on_false)


@dataclasses.dataclass(frozen=True)
class LineSearchConfig:
    backtracking: bool = False
    eta: float = 0.5
    armijo_c: float = ARMIJO_C
    max_backtracks: int = 60


class _BTState(NamedTuple):
    t: Array
    x_new: Array
    accepted: Array
    steps: Array


def armijo_prox_search(
    problem,
    y: Array,
    g_y: Array,
    grad: Array,
    tau0: Array,
    ls: LineSearchConfig,
) -> tuple[Array, Array, Array]:
    """Backtracking prox line search from trial step ``tau0``.

    Returns ``(x_new, tau_accepted, n_backtracks)`` where ``x_new =
    prox(y − τ·grad, τ)`` for the first τ in {tau0·ηᵏ} satisfying the Armijo
    sufficient-decrease condition. One smooth-value evaluation per trial.
    """

    def trial(t: Array) -> tuple[Array, Array]:
        x_new = problem.prox(y - t * grad, t)
        diff = x_new - y
        ok = problem.smooth_value(x_new) <= g_y + ls.armijo_c * jnp.vdot(grad, diff)
        return x_new, ok

    x_first, ok_first = trial(tau0)

    def cond(s: _BTState):
        return (~s.accepted) & (s.steps < ls.max_backtracks)

    def body(s: _BTState):
        t = s.t * ls.eta
        x_new, ok = trial(t)
        return _BTState(t=t, x_new=x_new, accepted=ok, steps=s.steps + 1)

    init = _BTState(
        t=tau0, x_new=x_first, accepted=ok_first, steps=jnp.zeros((), jnp.int32)
    )
    final = jax.lax.while_loop(cond, body, init)
    return final.x_new, final.t, final.steps
