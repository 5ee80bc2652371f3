"""FISTA / FISTA-Δ: accelerated proximal gradient as a compiled fixed-point.

A compiled redesign of the reference solvers
(``/root/reference/iterative_solvers.py:132-245`` (FISTA) and ``:251-344``
(FISTA-Δ)): one immutable :class:`FISTAState` pytree advanced by a
``lax.while_loop`` (or a fixed-length ``lax.scan`` when an iteration history
is requested), so a solve is a single XLA program — jittable, vmappable over
stacked instance batches, and shardable over device meshes.

Behavioral contract preserved (SURVEY.md §7):

1. step size ``τ = t_init_factor / (λ_max(AᵀA) + α₂)`` (reference :155-158);
2. Armijo backtracking with C=1e-2, η=0.5, accepted τ persists and never
   grows (``:183-197``);
3. adaptive restart when ``‖x_{k+1}−x_k‖ / ‖x_k−x_{k−1}‖ > threshold``
   (ratio = ∞ on a zero previous step), resetting t=1, y=x (``:206-213``);
4. FISTA-Δ momentum θ_k = k/(k+1+δ) with k counted from 1 and δ > 2 enforced
   (``:268``, ``:330``);
5. stopping rules in reference order: grad-norm *before* the proximal update
   (``:179``), step-norm after (``:238``), step-ratio last (``:242``); all
   disabled by default (tol = 0 → exactly ``max_iter`` iterations).

Momentum selection (nesterov vs Δ) and restart are *static* config, so XLA
compiles only the branch in use; convergence tests are on-device scalars
(psum'd under sharding) with no host round-trip.
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
class FISTAConfig:
    """Static solver configuration (hashable; safe as a jit static arg)."""

    backtracking: bool = False
    eta: float = 0.5
    t_init_factor: float = 1.0
    max_iter: int = 500
    tol: float = 0.0
    tol_ratio: float = 0.0
    adaptive_restart: bool = False
    restart_threshold: float = 1.0
    momentum: str = "nesterov"  # "nesterov" | "delta"
    delta: float = 3.0
    armijo_c: float = ARMIJO_C
    max_backtracks: int = 60
    lipschitz_iters: int = 100
    lipschitz_tol: float = 1e-6

    def __post_init__(self):
        if self.momentum not in ("nesterov", "delta"):
            raise ValueError(f"Unknown momentum '{self.momentum}'")
        if self.momentum == "delta" and not self.delta > 2:
            # Reference convergence guard (iterative_solvers.py:268).
            raise ValueError("FISTA-Δ requires delta > 2 for convergence")

    @property
    def line_search(self) -> LineSearchConfig:
        return LineSearchConfig(
            backtracking=self.backtracking,
            eta=self.eta,
            armijo_c=self.armijo_c,
            max_backtracks=self.max_backtracks,
        )


class FISTAState(NamedTuple):
    x: Array  # current iterate x_k
    y: Array  # extrapolated point y_k
    t: Array  # Nesterov momentum scalar t_k (unused under Δ-momentum)
    tau: Array  # current (possibly backtracked) step size
    k: Array  # completed proximal updates (int32)
    prev_step: Array  # ‖x_k − x_{k−1}‖
    done: Array  # bool: a stopping rule fired


def init_state(problem, config: FISTAConfig, x0: Array | None, tau0: Array) -> FISTAState:
    x = problem.x0() if x0 is None else x0
    return FISTAState(
        x=x,
        y=x,
        t=jnp.ones((), x.dtype),
        tau=jnp.asarray(tau0, x.dtype),
        k=jnp.zeros((), jnp.int32),
        prev_step=jnp.zeros((), x.dtype),
        done=jnp.zeros((), bool),
    )


def fista_step(
    problem, config: FISTAConfig, state: FISTAState, metrics: Metrics
) -> tuple[FISTAState, Metrics, Array, Array]:
    """One FISTA iteration. Returns ``(new_state, new_metrics, x_next,
    update_applied)`` — ``update_applied`` is False when the grad-norm rule
    stopped the iteration *before* the proximal update (reference :179)."""
    x_k, y_k = state.x, state.y

    if config.backtracking:
        g_y, grad = problem.smooth_value_and_grad(y_k)
    else:
        grad = problem.smooth_grad(y_k)
        g_y = None
    metrics = metrics._replace(n_grad_evals=metrics.n_grad_evals + 1)

    # Stopping rule 1: gradient norm, checked before the update.
    if config.tol > 0.0:
        grad_stop = jnp.linalg.norm(grad) < config.tol
    else:
        grad_stop = jnp.zeros((), bool)

    # Proximal update, optionally with Armijo backtracking.
    if config.backtracking:
        x_next, tau, bt_steps = armijo_prox_search(
            problem, y_k, g_y, grad, state.tau, config.line_search
        )
        metrics = metrics._replace(
            n_ls_calls=metrics.n_ls_calls + 1,
            ls_iters_total=metrics.ls_iters_total + bt_steps,
        )
    else:
        tau = state.tau
        x_next = problem.prox(y_k - tau * grad, tau)

    this_step = jnp.linalg.norm(x_next - x_k)
    ratio = jnp.where(
        state.prev_step > 0.0, this_step / jnp.maximum(state.prev_step, 1e-38), jnp.inf
    )

    # Momentum update.
    if config.momentum == "delta":
        # Reference counts k from 1 (iterative_solvers.py:289, :330).
        k_ref = (state.k + 1).astype(x_k.dtype)
        theta = k_ref / (k_ref + 1.0 + config.delta)
        y_next = x_next + theta * (x_next - x_k)
        t_curr = state.t
    else:
        t_curr = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * state.t**2))
        beta = (state.t - 1.0) / t_curr
        y_next = x_next + beta * (x_next - x_k)
        if config.adaptive_restart:
            restart = ratio > config.restart_threshold
            t_curr = jnp.where(restart, 1.0, t_curr)
            y_next = jnp.where(restart, x_next, y_next)

    # Stopping rules 2 and 3 (post-update).
    done = jnp.zeros((), bool)
    if config.tol > 0.0:
        done = done | (this_step < config.tol)
    if config.tol_ratio > 0.0:
        done = done | (ratio < config.tol_ratio)

    updated = FISTAState(
        x=x_next,
        y=y_next,
        t=t_curr,
        tau=tau,
        k=state.k + 1,
        prev_step=this_step,
        done=done,
    )
    # Grad-norm stop freezes the state entirely (no update counted).
    new_state = tree_where(grad_stop, state._replace(done=jnp.ones((), bool)), updated)
    return new_state, metrics, x_next, ~grad_stop


class _Carry(NamedTuple):
    state: FISTAState
    metrics: Metrics


def _prepare(problem, config: FISTAConfig, x0, L, key):
    if L is None:
        L = lipschitz_for(
            problem, key, n_iter=config.lipschitz_iters, tol=config.lipschitz_tol
        )
    L = jnp.asarray(L)
    tau0 = config.t_init_factor / L
    return init_state(problem, config, x0, tau0), L


def fista(
    problem,
    config: FISTAConfig = FISTAConfig(),
    x0: Array | None = None,
    L: Array | None = None,
    key: Array | None = None,
) -> SolveResult:
    """Solve to convergence / ``max_iter`` with a ``lax.while_loop`` (no
    per-iteration outputs — minimal memory, fastest path)."""
    state0, L = _prepare(problem, config, x0, L, key)

    def cond(c: _Carry):
        return (c.state.k < config.max_iter) & ~c.state.done

    def body(c: _Carry):
        new_state, metrics, _, _ = fista_step(problem, config, c.state, c.metrics)
        return _Carry(new_state, metrics)

    final = jax.lax.while_loop(cond, body, _Carry(state0, Metrics.zero()))
    return SolveResult(
        x=final.state.x,
        n_iters=final.state.k,
        L=L,
        final_tau=final.state.tau,
        metrics=final.metrics,
    )


def fista_with_history(
    problem,
    config: FISTAConfig = FISTAConfig(),
    x0: Array | None = None,
    L: Array | None = None,
    key: Array | None = None,
) -> SolveResult:
    """Fixed-length ``lax.scan`` variant recording per-iteration iterates,
    objectives, and step norms (the reference's ``return_history=True``,
    iterative_solvers.py:160, :224-232). Padded entries repeat the final
    iterate with ``valid=False``."""
    state0, L = _prepare(problem, config, x0, L, key)

    def step(c: _Carry, _):
        active = (c.state.k < config.max_iter) & ~c.state.done
        new_state, metrics, _, applied = fista_step(problem, config, c.state, c.metrics)
        new_c = tree_where(active, _Carry(new_state, metrics), c)
        valid = active & applied
        obj = problem.objective(new_c.state.x)
        out = (new_c.state.x, obj, new_c.state.prev_step, valid, new_c.state.tau)
        return new_c, out

    final, (xs, objs, steps, valid, taus) = jax.lax.scan(
        step, _Carry(state0, Metrics.zero()), None, length=config.max_iter
    )
    hist = History(x=xs, obj=objs, step_norm=steps, valid=valid, tau=taus)
    return SolveResult(
        x=final.state.x,
        n_iters=final.state.k,
        L=L,
        final_tau=final.state.tau,
        metrics=final.metrics,
        history=hist,
    )


def fista_delta_config(delta: float, **kw) -> FISTAConfig:
    """Convenience constructor for the Δ-momentum variant
    (reference ``fista_delta``, iterative_solvers.py:251)."""
    return FISTAConfig(momentum="delta", delta=delta, **kw)
