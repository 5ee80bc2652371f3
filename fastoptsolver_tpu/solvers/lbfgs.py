"""L-BFGS, from scratch, in pure JAX — no SciPy, no Fortran.

The reference wraps SciPy's Fortran L-BFGS-B behind a Python⇄Fortran boundary
(``/root/reference/lbfgs.py:64-70``), which cannot run on a GPU, jit, vmap, or
shard. This is a ground-up reimplementation as a single compiled fixed-point:

- **two-loop recursion** over a fixed-size curvature-pair ring buffer — the
  ``(s, y)`` histories live in stacked ``(memory, n)`` arrays addressed with
  modular indices inside ``lax.fori_loop`` (unfilled slots are zero and
  masked, so they contribute nothing);
- **strong-Wolfe line search** (sufficient decrease c1 = 1e-4, curvature
  c2 = 0.9) as a bounded bracket-then-zoom state machine in one
  ``lax.while_loop``, one value-and-grad evaluation per trial point;
- **stopping** with SciPy-compatible semantics: ``pgtol`` on the gradient
  ∞-norm (the projected gradient equals the gradient in the unconstrained
  setting the reference uses) and ``factr``-style relative objective decrease;
- **cautious updates**: a curvature pair is skipped when ``sᵀy`` is not
  sufficiently positive, keeping the inverse-Hessian estimate PSD.

Minimizes ``problem.smooth_value`` only. This deliberately reproduces the
reference's lasso quirk (SURVEY.md §7 item 7): for L1 problems the reference's
``fg`` omits the ``α₁‖x‖₁`` term entirely (lbfgs.py:43-54) while the recorded
history uses the *full* objective (lbfgs.py:56-61) — here the solver likewise
optimizes the smooth part while ``lbfgs_with_history`` records
``problem.objective``.

Parity target vs. SciPy is the final objective, not the iterate trajectory
(different line-search implementations take different paths; SURVEY.md §7
"Hard parts").
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import Array

from .common import History, Metrics, SolveResult, tree_where


@dataclasses.dataclass(frozen=True)
class LBFGSConfig:
    memory: int = 10
    max_iter: int = 500
    tol: float = 1e-6  # pgtol: stop when ||g||_inf <= tol (scipy fmin_l_bfgs_b pgtol)
    ftol: float = 1e7 * float(jnp.finfo(jnp.float64).eps)  # scipy factr=1e7 default
    c1: float = 1e-4
    c2: float = 0.9
    max_ls_steps: int = 30
    step_max: float = 1e8
    gamma_init: float = 1.0
    curvature_eps: float = 1e-10


# ---------------------------------------------------------------------------
# Two-loop recursion over the ring buffer
# ---------------------------------------------------------------------------


def two_loop_direction(
    g: Array,
    S: Array,
    Y: Array,
    rho: Array,
    count: Array,
    head: Array,
    gamma: Array,
) -> Array:
    """Search direction ``d = -H_k g`` via the classic two-loop recursion.

    ``S``/``Y`` are (memory, n) ring buffers; ``head`` is the next write slot;
    ``count`` the number of valid pairs. Slot ``(head-1) % memory`` is the most
    recent pair. Unfilled slots hold zeros and are additionally masked.
    """
    mem = S.shape[0]

    def backward(i, carry):
        q, alphas = carry
        idx = (head - 1 - i) % mem
        valid = i < count
        a = jnp.where(valid, rho[idx] * (S[idx] @ q), 0.0)
        return q - a * Y[idx], alphas.at[idx].set(a)

    q, alphas = jax.lax.fori_loop(
        0, mem, backward, (g, jnp.zeros((mem,), g.dtype))
    )
    r = gamma * q

    def forward(i, r):
        idx = (head - count + i) % mem
        valid = i < count
        b = rho[idx] * (Y[idx] @ r)
        return r + jnp.where(valid, S[idx] * (alphas[idx] - b), 0.0)

    r = jax.lax.fori_loop(0, mem, forward, r)
    return -r


# ---------------------------------------------------------------------------
# Strong-Wolfe line search (bracket + zoom), one eval per loop trip
# ---------------------------------------------------------------------------

_BRACKETING, _ZOOM, _ACCEPTED, _FAILED = 0, 1, 2, 3


class _LSState(NamedTuple):
    mode: Array
    a: Array  # current trial step
    a_prev: Array
    phi_prev: Array
    dphi_prev: Array
    a_lo: Array
    phi_lo: Array
    dphi_lo: Array
    g_lo: Array
    a_hi: Array
    phi_hi: Array
    i: Array
    a_star: Array
    phi_star: Array
    g_star: Array
    n_evals: Array


def wolfe_line_search(problem, x: Array, f0: Array, g0: Array, d: Array, cfg: LBFGSConfig):
    """Find ``a`` satisfying the strong Wolfe conditions along ``d``.

    Returns ``(a, f(x+ad), ∇f(x+ad), n_evals, ok)``. On failure (no Wolfe point
    within the evaluation budget) falls back to the best sufficient-decrease
    point seen; ``ok`` is False only if not even sufficient decrease was found.
    """
    dphi0 = g0 @ d
    dtype = f0.dtype

    def body(s: _LSState) -> _LSState:
        a = s.a
        phi, g = problem.smooth_value_and_grad(x + a * d)
        dphi = g @ d
        n_evals = s.n_evals + 1
        armijo_ok = phi <= f0 + cfg.c1 * a * dphi0
        curv_ok = jnp.abs(dphi) <= -cfg.c2 * dphi0

        def do_bracket(s: _LSState) -> _LSState:
            hit_hi = (~armijo_ok) | ((s.i > 0) & (phi >= s.phi_prev))

            def to_zoom_hi(s):
                # bracket is (a_prev, a): lo = prev point, hi = current
                return s._replace(
                    mode=jnp.asarray(_ZOOM, jnp.int32),
                    a_lo=s.a_prev, phi_lo=s.phi_prev, dphi_lo=s.dphi_prev,
                    a_hi=a, phi_hi=phi,
                    a=0.5 * (s.a_prev + a),
                )

            def not_hi(s):
                def accept(s):
                    return s._replace(mode=jnp.asarray(_ACCEPTED, jnp.int32), a_star=a, phi_star=phi, g_star=g)

                def check_sign(s):
                    def to_zoom_lo(s):
                        # derivative turned positive: bracket is (a, a_prev)
                        return s._replace(
                            mode=jnp.asarray(_ZOOM, jnp.int32),
                            a_lo=a, phi_lo=phi, dphi_lo=dphi, g_lo=g,
                            a_hi=s.a_prev, phi_hi=s.phi_prev,
                            a=0.5 * (a + s.a_prev),
                        )

                    def expand(s):
                        return s._replace(
                            a_prev=a, phi_prev=phi, dphi_prev=dphi,
                            a=jnp.minimum(2.0 * a, cfg.step_max),
                        )

                    return jax.lax.cond(dphi >= 0, to_zoom_lo, expand, s)

                return jax.lax.cond(curv_ok, accept, check_sign, s)

            out = jax.lax.cond(hit_hi, to_zoom_hi, not_hi, s)
            # Track the latest sufficient-decrease point as the fallback.
            fb = armijo_ok & (phi < out.phi_star)
            return out._replace(
                i=out.i + 1,
                n_evals=n_evals,
                a_star=jnp.where(out.mode == _ACCEPTED, out.a_star, jnp.where(fb, a, out.a_star)),
                phi_star=jnp.where(out.mode == _ACCEPTED, out.phi_star, jnp.where(fb, phi, out.phi_star)),
                g_star=tree_where(out.mode == _ACCEPTED, out.g_star, tree_where(fb, g, out.g_star)),
            )

        def do_zoom(s: _LSState) -> _LSState:
            def shrink_hi(s):
                return s._replace(a_hi=a, phi_hi=phi)

            def move_lo(s):
                def accept(s):
                    return s._replace(mode=jnp.asarray(_ACCEPTED, jnp.int32), a_star=a, phi_star=phi, g_star=g)

                def update(s):
                    flip = dphi * (s.a_hi - s.a_lo) >= 0
                    return s._replace(
                        a_hi=jnp.where(flip, s.a_lo, s.a_hi),
                        phi_hi=jnp.where(flip, s.phi_lo, s.phi_hi),
                        a_lo=a, phi_lo=phi, dphi_lo=dphi, g_lo=g,
                    )

                return jax.lax.cond(curv_ok, accept, update, s)

            hit_hi = (~armijo_ok) | (phi >= s.phi_lo)
            out = jax.lax.cond(hit_hi, shrink_hi, move_lo, s)
            interval = jnp.abs(out.a_hi - out.a_lo)
            return out._replace(
                i=out.i + 1,
                n_evals=n_evals,
                a=jnp.where(out.mode == _ACCEPTED, out.a, 0.5 * (out.a_lo + out.a_hi)),
                # Degenerate interval: give up on Wolfe, keep the lo point.
                mode=jnp.where(
                    (out.mode == _ZOOM) & (interval < 1e-14 * jnp.maximum(out.a_hi, 1.0)),
                    _FAILED,
                    out.mode,
                ),
            )

        return jax.lax.cond(s.mode == _BRACKETING, do_bracket, do_zoom, s)

    def cond(s: _LSState):
        return (s.mode < _ACCEPTED) & (s.i < cfg.max_ls_steps)

    zero = jnp.zeros((), dtype)
    init = _LSState(
        mode=jnp.asarray(_BRACKETING, jnp.int32),
        a=jnp.ones((), dtype),
        a_prev=zero, phi_prev=f0, dphi_prev=dphi0,
        a_lo=zero, phi_lo=f0, dphi_lo=dphi0, g_lo=g0,
        a_hi=zero, phi_hi=f0,
        i=jnp.zeros((), jnp.int32),
        a_star=zero, phi_star=f0, g_star=g0,
        n_evals=jnp.zeros((), jnp.int32),
    )
    s = jax.lax.while_loop(cond, body, init)

    accepted = s.mode == _ACCEPTED
    # Zoom's a_lo always satisfies sufficient decrease once set; prefer it over
    # the bracketing fallback when no Wolfe point was reached.
    use_lo = (~accepted) & (s.a_lo > 0.0) & (s.phi_lo <= s.phi_star)
    a = jnp.where(accepted, s.a_star, jnp.where(use_lo, s.a_lo, s.a_star))
    f = jnp.where(accepted, s.phi_star, jnp.where(use_lo, s.phi_lo, s.phi_star))
    g = tree_where(accepted, s.g_star, tree_where(use_lo, s.g_lo, s.g_star))
    ok = accepted | (a > 0.0)
    return a, f, g, s.n_evals, ok


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


class LBFGSState(NamedTuple):
    x: Array
    f: Array
    g: Array
    S: Array  # (memory, n)
    Y: Array  # (memory, n)
    rho: Array  # (memory,)
    count: Array
    head: Array
    gamma: Array
    k: Array
    done: Array
    ls_failed: Array


class _Carry(NamedTuple):
    state: LBFGSState
    metrics: Metrics


def _init(problem, config: LBFGSConfig, x0):
    x = problem.x0() if x0 is None else x0
    f, g = problem.smooth_value_and_grad(x)
    mem = config.memory
    n = x.shape[0]
    return LBFGSState(
        x=x, f=f, g=g,
        S=jnp.zeros((mem, n), x.dtype),
        Y=jnp.zeros((mem, n), x.dtype),
        rho=jnp.zeros((mem,), x.dtype),
        count=jnp.zeros((), jnp.int32),
        head=jnp.zeros((), jnp.int32),
        gamma=jnp.asarray(config.gamma_init, x.dtype),
        k=jnp.zeros((), jnp.int32),
        done=jnp.max(jnp.abs(g)) <= config.tol,
        ls_failed=jnp.zeros((), bool),
    )


def lbfgs_step(problem, config: LBFGSConfig, state: LBFGSState, metrics: Metrics):
    d = two_loop_direction(
        state.g, state.S, state.Y, state.rho, state.count, state.head, state.gamma
    )
    # Safeguard: fall back to steepest descent on a non-descent direction.
    descent = (state.g @ d) < 0
    d = jnp.where(descent, d, -state.g)

    a, f_new, g_new, n_evals, ok = wolfe_line_search(
        problem, state.x, state.f, state.g, d, config
    )
    metrics = metrics._replace(
        n_grad_evals=metrics.n_grad_evals + n_evals,
        n_ls_calls=metrics.n_ls_calls + 1,
        ls_iters_total=metrics.ls_iters_total + n_evals,
    )
    x_new = state.x + a * d

    s_vec = x_new - state.x
    y_vec = g_new - state.g
    sy = s_vec @ y_vec
    keep = sy > config.curvature_eps * jnp.linalg.norm(s_vec) * jnp.linalg.norm(y_vec)

    head, mem = state.head, config.memory
    S = jnp.where(keep, state.S.at[head].set(s_vec), state.S)
    Y = jnp.where(keep, state.Y.at[head].set(y_vec), state.Y)
    rho = jnp.where(keep, state.rho.at[head].set(1.0 / jnp.where(keep, sy, 1.0)), state.rho)
    head = jnp.where(keep, (head + 1) % mem, head)
    count = jnp.where(keep, jnp.minimum(state.count + 1, mem), state.count)
    gamma = jnp.where(keep, sy / jnp.maximum(y_vec @ y_vec, 1e-38), state.gamma)

    # Stopping: pgtol on gradient inf-norm; factr-style relative f decrease;
    # line-search failure.
    pg_small = jnp.max(jnp.abs(g_new)) <= config.tol
    f_flat = (state.f - f_new) <= config.ftol * jnp.maximum(
        jnp.maximum(jnp.abs(state.f), jnp.abs(f_new)), 1.0
    )
    done = pg_small | f_flat | ~ok

    new_state = LBFGSState(
        x=x_new, f=f_new, g=g_new,
        S=S, Y=Y, rho=rho, count=count, head=head, gamma=gamma,
        k=state.k + 1, done=done, ls_failed=~ok,
    )
    return new_state, metrics


def lbfgs(
    problem,
    config: LBFGSConfig = LBFGSConfig(),
    x0: Array | None = None,
) -> SolveResult:
    state0 = _init(problem, config, x0)
    metrics0 = Metrics.zero()._replace(n_grad_evals=jnp.ones((), jnp.int32))

    def cond(c: _Carry):
        return (c.state.k < config.max_iter) & ~c.state.done

    def body(c: _Carry):
        return _Carry(*lbfgs_step(problem, config, c.state, c.metrics))

    final = jax.lax.while_loop(cond, body, _Carry(state0, metrics0))
    return SolveResult(
        x=final.state.x,
        n_iters=final.state.k,
        L=jnp.zeros((), final.state.f.dtype),
        final_tau=jnp.zeros((), final.state.f.dtype),
        metrics=final.metrics,
    )


def lbfgs_with_history(
    problem,
    config: LBFGSConfig = LBFGSConfig(),
    x0: Array | None = None,
) -> SolveResult:
    """Fixed-length scan recording the *full* composite objective per
    iteration — reproducing the reference's callback history
    (lbfgs.py:56-61), including the lasso quirk where the optimized function
    omits the L1 term but the history includes it."""
    state0 = _init(problem, config, x0)
    metrics0 = Metrics.zero()._replace(n_grad_evals=jnp.ones((), jnp.int32))

    def step(c: _Carry, _):
        active = (c.state.k < config.max_iter) & ~c.state.done
        new_c = _Carry(*lbfgs_step(problem, config, c.state, c.metrics))
        new_c = tree_where(active, new_c, c)
        obj = problem.objective(new_c.state.x)
        step_norm = jnp.linalg.norm(new_c.state.x - c.state.x)
        return new_c, (new_c.state.x, obj, step_norm, active)

    final, (xs, objs, steps, valid) = jax.lax.scan(
        step, _Carry(state0, metrics0), None, length=config.max_iter
    )
    return SolveResult(
        x=final.state.x,
        n_iters=final.state.k,
        L=jnp.zeros((), final.state.f.dtype),
        final_tau=jnp.zeros((), final.state.f.dtype),
        metrics=final.metrics,
        history=History(x=xs, obj=objs, step_norm=steps, valid=valid),
    )
