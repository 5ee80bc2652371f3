"""ISTA: proximal gradient descent as a compiled fixed-point.

A compiled redesign of the reference's generic-callable ISTA
(``/root/reference/iterative_solvers.py:65-125``). The injectable-closure API
(``g`` / ``grad_g`` / ``prox_h`` + precomputed ``L``) is subsumed by the
problem protocol: pass any problem pytree (including
:class:`~fastoptsolver_tpu.problems.base.CustomProblem` built from arbitrary
closures) and a static :class:`ISTAConfig`.

Contract preserved: step ``t = t_init_factor / L``; Armijo sufficient decrease
``g(x⁺) ≤ g(x) + C·⟨∇g(x), x⁺−x⟩`` with C=1e-2, η=0.5, accepted step persists
(``:92-108``); stop on ``‖x⁺−x‖ < tol`` when ``tol > 0`` (``:114-123``),
otherwise exactly ``max_iter`` iterations.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import Array

from ..ops.lipschitz import lipschitz_for
from .common import (
    ARMIJO_C,
    History,
    LineSearchConfig,
    Metrics,
    SolveResult,
    armijo_prox_search,
    tree_where,
)


@dataclasses.dataclass(frozen=True)
class ISTAConfig:
    backtracking: bool = False
    eta: float = 0.5
    t_init_factor: float = 1.0
    max_iter: int = 500
    tol: float = 0.0
    armijo_c: float = ARMIJO_C
    max_backtracks: int = 60
    lipschitz_iters: int = 100
    lipschitz_tol: float = 1e-6

    @property
    def line_search(self) -> LineSearchConfig:
        return LineSearchConfig(
            backtracking=self.backtracking,
            eta=self.eta,
            armijo_c=self.armijo_c,
            max_backtracks=self.max_backtracks,
        )


class ISTAState(NamedTuple):
    x: Array
    tau: Array
    k: Array
    last_step: Array
    done: Array


class _Carry(NamedTuple):
    state: ISTAState
    metrics: Metrics


def ista_step(
    problem, config: ISTAConfig, state: ISTAState, metrics: Metrics
) -> tuple[ISTAState, Metrics]:
    x = state.x
    if config.backtracking:
        g_x, grad = problem.smooth_value_and_grad(x)
    else:
        grad = problem.smooth_grad(x)
    metrics = metrics._replace(n_grad_evals=metrics.n_grad_evals + 1)

    if config.backtracking:
        x_new, tau, bt_steps = armijo_prox_search(
            problem, x, g_x, grad, state.tau, config.line_search
        )
        metrics = metrics._replace(
            n_ls_calls=metrics.n_ls_calls + 1,
            ls_iters_total=metrics.ls_iters_total + bt_steps,
        )
    else:
        tau = state.tau
        x_new = problem.prox(x - tau * grad, tau)

    delta = jnp.linalg.norm(x_new - x)
    done = jnp.zeros((), bool)
    if config.tol > 0.0:
        done = delta < config.tol

    return (
        ISTAState(x=x_new, tau=tau, k=state.k + 1, last_step=delta, done=done),
        metrics,
    )


def _prepare(problem, config: ISTAConfig, x0, L, key):
    if L is None:
        L = lipschitz_for(
            problem, key, n_iter=config.lipschitz_iters, tol=config.lipschitz_tol
        )
    L = jnp.asarray(L)
    x = problem.x0() if x0 is None else x0
    state = ISTAState(
        x=x,
        tau=jnp.asarray(config.t_init_factor / L, x.dtype),
        k=jnp.zeros((), jnp.int32),
        last_step=jnp.zeros((), x.dtype),
        done=jnp.zeros((), bool),
    )
    return state, L


def ista(
    problem,
    config: ISTAConfig = ISTAConfig(),
    x0: Array | None = None,
    L: Array | None = None,
    key: Array | None = None,
) -> SolveResult:
    state0, L = _prepare(problem, config, x0, L, key)

    def cond(c: _Carry):
        return (c.state.k < config.max_iter) & ~c.state.done

    def body(c: _Carry):
        return _Carry(*ista_step(problem, config, c.state, c.metrics))

    final = jax.lax.while_loop(cond, body, _Carry(state0, Metrics.zero()))
    return SolveResult(
        x=final.state.x,
        n_iters=final.state.k,
        L=L,
        final_tau=final.state.tau,
        metrics=final.metrics,
    )


def ista_with_history(
    problem,
    config: ISTAConfig = ISTAConfig(),
    x0: Array | None = None,
    L: Array | None = None,
    key: Array | None = None,
) -> SolveResult:
    """Fixed-length scan recording iterates / objectives / step norms
    (reference ``return_history=True`` log: x, t, delta per iteration,
    iterative_solvers.py:83, :117-120)."""
    state0, L = _prepare(problem, config, x0, L, key)

    def step(c: _Carry, _):
        active = (c.state.k < config.max_iter) & ~c.state.done
        new_c = _Carry(*ista_step(problem, config, c.state, c.metrics))
        new_c = tree_where(active, new_c, c)
        obj = problem.objective(new_c.state.x)
        return new_c, (new_c.state.x, obj, new_c.state.last_step, active, new_c.state.tau)

    final, (xs, objs, steps, valid, taus) = jax.lax.scan(
        step, _Carry(state0, Metrics.zero()), None, length=config.max_iter
    )
    return SolveResult(
        x=final.state.x,
        n_iters=final.state.k,
        L=L,
        final_tau=final.state.tau,
        metrics=final.metrics,
        history=History(x=xs, obj=objs, step_norm=steps, valid=valid, tau=taus),
    )
