"""Certified FISTA on the dense Gram form of ONE large instance.

Companion to :mod:`fastoptsolver_tpu.problems.streaming`: once an
arbitrarily-tall A has been reduced to ``Q = AᵀA (n, n), c = Aᵀb, bᵀb`` in a
single streaming pass, the solve never touches A again — each iteration is
one (n, n) matvec plus elementwise shrinkage, with the duality-gap certification
(ops/gap.py math, Gram-form) every ``check_every`` iterations inside one
``lax.while_loop`` — a single device program, no host round-trips.

This is the single-instance sibling of batch/fista_gram.py (whose
feature-major (n, n, B) layout is wrong for B=1: a unit minor dimension turns
every matvec into n² scalar products instead of one matrix-vector product). Recurrence parity:
the fixed-step FISTA of ``/root/reference/iterative_solvers.py:170-221``
with Nesterov momentum and optional adaptive restart (``:209-217``).

f32 certification floor: the Gram-form residual ``xᵀQx − 2cᵀx + bᵀb``
cancels catastrophically when ‖Ax−b‖² ≪ bᵀb, so the gap is evaluated with
df32 compensated arithmetic (ops/df32.py — ~48 effective mantissa bits from
plain f32 ops, no dependence on the process-global x64 flag; cheap:
O(n²) once per ``check_every`` iterations) — without this, rel_gap_tol below
~1e-5 is unreachable at large m.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import Array

from ..ops.prox import soft_threshold
from ..problems.streaming import DenseGram


@dataclasses.dataclass(frozen=True)
class DenseGramConfig:
    max_iter: int = 2000
    check_every: int = 50
    rel_gap_tol: float = 1e-6
    t_init_factor: float = 1.0
    adaptive_restart: bool = False
    restart_threshold: float = 1.0
    power_iters: int = 100
    power_tol: float = 1e-6
    l_safety: float = 1.0


class DenseResult(NamedTuple):
    x: Array  # (n,)
    iters: Array  # () iterations run
    rel_gap: Array  # ()
    converged: Array  # () bool
    L: Array  # () Lipschitz estimate used


def _power_L(Q: Array, key: Array, n_iter: int, tol: float) -> Array:
    """λ_max(Q) by power iteration (reference iterative_solvers.py:45-60
    recurrence, PRNG-keyed start per SURVEY §7 item 9)."""
    v0 = jax.random.normal(key, (Q.shape[0],), Q.dtype)
    v0 = v0 / jnp.maximum(jnp.linalg.norm(v0), 1e-30)

    def cond(s):
        v, L, prev, k = s
        return (k < n_iter) & (jnp.abs(L - prev) >= tol)

    def body(s):
        v, L, prev, k = s
        w = Q @ v
        Ln = jnp.linalg.norm(w)
        return w / jnp.maximum(Ln, 1e-30), Ln, L, k + 1

    _, L, _, _ = jax.lax.while_loop(
        cond, body, (v0, jnp.zeros((), Q.dtype), jnp.inf, jnp.zeros((), jnp.int32))
    )
    return L


def _rel_gap_dense(Q, c, btb, alpha1, alpha2, X) -> Array:
    """Scalar-instance relative duality gap — same derivation as
    ops/gap.py / batch.fista_gram._rel_gap, evaluated with df32 compensated
    arithmetic (ops/df32.py) so it certifies below the plain-f32 cancellation
    floor regardless of the process-global ``jax_enable_x64`` flag (the old
    behavior silently degraded to f32 whenever x64 was off — every production
    path; ADVICE r2).

    Two cancellation regimes are handled:
    - ``rr = xᵀQx − 2cᵀx + bᵀb`` (≈ ‖Ax−b‖² ≪ bᵀb at large m): df32 matvec
      + compensated dots keep ~48 mantissa bits through the cancellation.
    - near the optimum the dual scaling ``s`` saturates at 1 and the gap
      algebraically reduces to ``xᵀu + α₁‖x‖₁`` with every term O(f) — that
      branch is used whenever ``u_inf ≤ α₁``, so the certified quantity never
      involves an O(bᵀb)-sized cancellation at all.

    Remaining floor: the f32 *representation* rounding of the stored
    (Q, c, bᵀb) triple itself (~2⁻²⁴ of accumulated magnitudes) — see
    ops/df32.py; stream_gram's compensated accumulation keeps that to one
    rounding."""
    from ..ops import df32

    dtype = Q.dtype
    a1 = jnp.asarray(alpha1, dtype)
    a2 = jnp.asarray(alpha2, dtype)
    if dtype == jnp.float64:
        # f64 inputs (x64-enabled runs): plain arithmetic already has ~2⁻⁵³
        QX = Q @ X
        xQx = X @ QX
        cx = c @ X
        xx = X @ X
        l1 = jnp.sum(jnp.abs(X))
        rr = jnp.maximum(xQx - 2.0 * cx + btb, 0.0)
        rb = cx - btb
        u = QX - c + a2 * X
        u_inf = jnp.max(jnp.abs(u))
        uu = u @ u
        f = 0.5 * rr + 0.5 * a2 * xx + a1 * l1
        s = jnp.where(u_inf > a1, a1 / jnp.maximum(u_inf, 1e-30), 1.0)
        dual_neg = 0.5 * (s * s) * rr + s * rb + 0.5 * a2 * (s * s) * xx
        l1_gap = jnp.maximum(f + dual_neg, 0.0)
        smooth_gap = uu / jnp.where(a2 > 0, 2.0 * a2, 1.0)
        gap = jnp.where(a1 > 0, l1_gap, smooth_gap)
        return gap / jnp.maximum(f, 1.0)
    wh, wl = df32.matvec2(Q, X)  # df32 QX
    xQx = df32.dot2_df(X, wh, wl)
    cx = df32.dot2(c, X)
    xx = jnp.sum(X * X)
    l1 = jnp.sum(jnp.abs(X))
    rr_df = df32.df_add(
        df32.df_add(xQx, df32.df_scale(cx, -2.0)), (btb, jnp.zeros_like(btb))
    )
    rr = jnp.maximum(df32.df_value(rr_df), 0.0)
    rb = df32.df_value(df32.df_add(cx, (-btb, jnp.zeros_like(btb))))
    # dual vector u = Qx − c + α₂x, df-resolved so u_inf/uu/xᵀu carry the
    # cancellation already absorbed into (uh, ul)
    ph, pl = df32.df_vec_prod(a2, X)
    uh, ul = df32.df_vec_add(wh, wl, -c, jnp.zeros_like(c))
    uh, ul = df32.df_vec_add(uh, ul, ph, pl)
    u = uh + ul
    u_inf = jnp.max(jnp.abs(u))
    uu = u @ u
    xu = df32.df_value(df32.dot2_df(X, uh, ul))

    f = 0.5 * rr + 0.5 * a2 * xx + a1 * l1
    # general branch (early iterations, s < 1): gap is large, f32 combination
    # of the df-backed scalars is plenty
    s = a1 / jnp.maximum(u_inf, 1e-30)
    dual_neg = 0.5 * (s * s) * rr + s * rb + 0.5 * a2 * (s * s) * xx
    gap_general = jnp.maximum(f + dual_neg, 0.0)
    # saturated branch (s = 1): f + dual_neg == xᵀu + α₁‖x‖₁ exactly — every
    # term O(f), no O(bᵀb) cancellation
    gap_s1 = jnp.maximum(xu + a1 * l1, 0.0)
    l1_gap = jnp.where(u_inf > a1, gap_general, gap_s1)
    smooth_gap = uu / jnp.where(a2 > 0, 2.0 * a2, 1.0)
    gap = jnp.where(a1 > 0, l1_gap, smooth_gap)
    return (gap / jnp.maximum(f, 1.0)).astype(dtype)


class _State(NamedTuple):
    x: Array
    y: Array
    t: Array
    prev_step: Array
    k: Array
    gap: Array
    done: Array


def fista_gram_dense(
    gram: DenseGram,
    alpha1,
    alpha2=0.0,
    config: DenseGramConfig = DenseGramConfig(),
    key: Array | None = None,
) -> DenseResult:
    """Certified lasso/elastic-net solve of one Gram-form instance."""
    if key is None:
        key = jax.random.PRNGKey(0)
    return _solve(gram, jnp.asarray(alpha1, gram.Q.dtype),
                  jnp.asarray(alpha2, gram.Q.dtype), key, cfg=config)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _solve(gram, alpha1, alpha2, key, *, cfg: DenseGramConfig) -> DenseResult:
    Q, c, btb = gram.Q, gram.c, gram.btb
    n = Q.shape[0]
    dtype = Q.dtype
    L = cfg.l_safety * _power_L(Q, key, cfg.power_iters, cfg.power_tol) + alpha2
    L = jnp.where(L > 0.0, L, 1.0)
    tau = jnp.asarray(cfg.t_init_factor, dtype) / L
    thr = tau * alpha1

    def one_iter(_, s: _State) -> _State:
        grad = Q @ s.y + alpha2 * s.y - c
        x_next = soft_threshold(s.y - tau * grad, thr)
        this_step = jnp.linalg.norm(x_next - s.x)
        t_next = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * s.t**2))
        beta = (s.t - 1.0) / t_next
        y_next = x_next + beta * (x_next - s.x)
        if cfg.adaptive_restart:
            ratio = jnp.where(
                s.prev_step > 0.0,
                this_step / jnp.maximum(s.prev_step, 1e-30),
                jnp.inf,
            )
            restart = ratio > cfg.restart_threshold
            t_next = jnp.where(restart, 1.0, t_next)
            y_next = jnp.where(restart, x_next, y_next)
        return _State(x_next, y_next, t_next, this_step, s.k + 1, s.gap, s.done)

    def cond(s: _State):
        return (s.k < cfg.max_iter) & ~s.done

    chunk = cfg.check_every if cfg.check_every > 0 else cfg.max_iter

    def body(s: _State):
        s = jax.lax.fori_loop(0, chunk, one_iter, s)
        gap = _rel_gap_dense(Q, c, btb, alpha1, alpha2, s.x)
        bad = ~jnp.all(jnp.isfinite(s.x)) | jnp.isnan(gap)
        gap = jnp.where(bad, jnp.inf, gap)
        return s._replace(gap=gap, done=(gap <= cfg.rel_gap_tol) | bad)

    init = _State(
        x=jnp.zeros((n,), dtype),
        y=jnp.zeros((n,), dtype),
        t=jnp.ones((), dtype),
        prev_step=jnp.zeros((), dtype),
        k=jnp.zeros((), jnp.int32),
        gap=jnp.full((), jnp.inf, dtype),
        done=jnp.zeros((), bool),
    )
    final = jax.lax.while_loop(cond, body, init)
    ok = jnp.all(jnp.isfinite(final.x)) & (final.gap <= cfg.rel_gap_tol)
    return DenseResult(
        x=final.x, iters=final.k, rel_gap=final.gap, converged=ok, L=L
    )
