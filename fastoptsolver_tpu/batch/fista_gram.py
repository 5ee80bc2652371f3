"""Hand-batched Gram-form FISTA: thousands of lasso instances per compiled step.

This is the throughput path behind ``solve_lasso_batch`` (batch/api.py):
many small lasso instances, each certified to a relative duality gap.
Design, in order of importance:

1. **Gram precompute.** Each instance's gradient is ``Qx − c`` with
   ``Q = AᵀA (n×n), c = Aᵀb`` — O(n²) per iteration instead of the
   reference's two O(mn) matvecs (iterative_solvers.py:173). The precompute
   itself is one big batched contraction; iterations never touch A again.

2. **Feature-major layout.** State is stored ``(n, B)`` and Q ``(n, n, B)``
   with the instance axis last, so one FISTA iteration for the whole batch
   is n² elementwise multiply-adds of (B,)-wide vectors — no tiny
   per-instance matmuls, no layout changes between iterations.

3. **Lockstep iterations, masked convergence.** All instances advance
   together; every ``check_every`` iterations a duality-gap check
   (ops/gap.py) marks converged instances, whose lanes freeze. The outer
   ``lax.while_loop`` exits when every instance is certified or ``max_iter``
   is hit. Per-instance iteration counts are recorded for instances/s
   accounting.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import Array

from ..ops.prox import soft_threshold

# Every Q·x in the iteration/certification path must be true f32: a reduced-
# precision matmul default (bf16 passes, or TF32 on a GPU's tensor cores,
# ~1e-3 relative error) floors the achievable duality gap far above a 1e-6
# certificate. The package __init__ sets the global default, but these
# einsums define the solver's correctness, so they pin it explicitly.
_HI = jax.lax.Precision.HIGHEST


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GramBatch:
    """A batch of Gram-form instances in feature-major layout."""

    Q: Array  # (n, n, B)
    c: Array  # (n, B)
    btb: Array  # (B,)
    alpha1: Array  # (B,)
    alpha2: Array  # (B,)
    L: Array  # (B,) — λ_max(AᵀA) + α₂ per instance

    @property
    def batch(self) -> int:
        return self.Q.shape[-1]

    @property
    def dim(self) -> int:
        return self.Q.shape[0]


def _batched_power_L(Q: Array, v0: Array, n_iter: int, tol: float,
                     axis_name: str | tuple[str, ...] | None = None) -> Array:
    """Per-lane power iteration on (n, n, B) Gram tensors: λ_max(Q) per
    instance, all instances in lockstep until the last one settles.

    ``axis_name``: called per shard inside ``shard_map`` over the instance
    axis, the exit test spans every shard, so each lane takes as many
    steps — and gets the same L — as it does on one device."""

    def norm(v):
        return jnp.sqrt(jnp.sum(v * v, axis=0))

    v = v0 / jnp.maximum(norm(v0), 1e-30)

    class S(NamedTuple):
        v: Array
        L: Array
        prev: Array
        k: Array

    def cond(s: S):
        moving = jnp.any(jnp.abs(s.L - s.prev) >= tol)
        if axis_name is not None:
            moving = jax.lax.psum(moving.astype(jnp.int32), axis_name) > 0
        return (s.k < n_iter) & moving

    def body(s: S):
        w = jnp.einsum("ijb,jb->ib", Q, s.v, precision=_HI)
        L = norm(w)
        v = w / jnp.maximum(L, 1e-30)
        return S(v=v, L=L, prev=s.L, k=s.k + 1)

    init = S(
        v=v,
        L=jnp.zeros(Q.shape[-1], Q.dtype),
        prev=jnp.full(Q.shape[-1], jnp.inf, Q.dtype),
        k=jnp.zeros((), jnp.int32),
    )
    return jax.lax.while_loop(cond, body, init).L


def make_gram_batch(
    A: Array,  # (B, m, n)
    b: Array,  # (B, m)
    alpha1,
    alpha2,
    key: Array | None = None,
    power_iters: int = 100,
    power_tol: float = 1e-6,
    dtype=None,
    v0: Array | None = None,
    axis_name: str | tuple[str, ...] | None = None,
) -> GramBatch:
    """Batched Gram precompute + per-instance Lipschitz estimation.

    ``alpha1``/``alpha2`` may be scalars or (B,) arrays (per-instance
    regularization sweeps vmap naturally). ``v0`` (n, B): the power
    iteration's start vectors; by default drawn from ``key``.
    ``axis_name``: see :func:`_batched_power_L`.
    """
    if dtype is not None:
        A = A.astype(dtype)
        b = b.astype(dtype)
    B = A.shape[0]
    # HIGHEST precision: a reduced-precision matmul default (bf16 passes,
    # TF32) leaves ~1e-3 relative error on Gram entries. The Gram is built
    # once and then defines the problem every iteration certifies against,
    # so it must be true f32.
    hi = jax.lax.Precision.HIGHEST
    Q = jnp.einsum("bmi,bmj->ijb", A, A, precision=hi)
    c = jnp.einsum("bmi,bm->ib", A, b, precision=hi)
    btb = jnp.einsum("bm,bm->b", b, b, precision=hi)
    a1 = jnp.broadcast_to(jnp.asarray(alpha1, A.dtype), (B,))
    a2 = jnp.broadcast_to(jnp.asarray(alpha2, A.dtype), (B,))
    if v0 is None:
        key = jax.random.PRNGKey(0) if key is None else key
        v0 = jax.random.normal(key, (A.shape[2], B), A.dtype)
    L = _batched_power_L(Q, v0, power_iters, power_tol, axis_name) + a2
    return GramBatch(Q=Q, c=c, btb=btb, alpha1=a1, alpha2=a2, L=L)


@dataclasses.dataclass(frozen=True)
class BatchFISTAConfig:
    max_iter: int = 500
    check_every: int = 10  # duality-gap check cadence (0 = never, run max_iter)
    rel_gap_tol: float = 1e-6
    t_init_factor: float = 1.0
    momentum: str = "nesterov"  # "nesterov" | "delta" | "greedy"
    delta: float = 3.0
    adaptive_restart: bool = False
    restart_threshold: float = 1.0
    # Armijo backtracking, reference semantics (iterative_solvers.py:183-197:
    # sufficient decrease with C=1e-2, shrink η=0.5, per-lane τ persists and
    # never grows). Masked lockstep search: one Gram matvec per trial round,
    # all lanes; lanes accept independently.
    backtracking: bool = False
    ls_eta: float = 0.5
    armijo_c: float = 1e-2
    max_backtracks: int = 20
    # "greedy" mode (Liang & Schönlieb 2018, arXiv:1811.01430 — PAPERS.md):
    # overshoot the step to ξ/L with unit momentum, restart on the gradient-
    # mapping angle test, and shrink τ back toward 1/L when steps grow.
    greedy_xi: float = 1.3  # initial step τ = ξ/L, ξ ∈ (1, 2)
    greedy_S: float = 1.02  # safeguard: shrink when ‖Δx_k‖ > S·‖Δx_1‖
    greedy_shrink: float = 0.96

    def __post_init__(self):
        if self.momentum == "delta" and not self.delta > 2:
            raise ValueError("FISTA-Δ requires delta > 2")
        if self.momentum not in ("nesterov", "delta", "greedy"):
            raise ValueError(f"Unknown momentum '{self.momentum}'")
        if self.momentum == "greedy" and not 1.0 <= self.greedy_xi < 2.0:
            raise ValueError("greedy FISTA requires 1 <= greedy_xi < 2")
        if self.backtracking and self.momentum == "greedy":
            raise ValueError(
                "backtracking and greedy momentum both control τ; pick one"
            )


class BatchState(NamedTuple):
    X: Array  # (n, B)
    Y: Array  # (n, B)
    t: Array  # (B,)
    prev_step: Array  # (B,)
    done: Array  # (B,) bool
    iters: Array  # (B,) int32 — iteration count at convergence
    gap: Array  # (B,) last measured relative gap
    k: Array  # scalar int32
    tau: Array  # (B,) per-lane step (greedy mode shrinks it; 0 = fill from L)
    first_step: Array  # (B,) ‖x_1 − x_0‖, the greedy safeguard reference


class BatchResult(NamedTuple):
    x: Array  # (B, n)
    iters: Array  # (B,)
    rel_gap: Array  # (B,)
    n_iters_total: Array  # scalar: lockstep iterations actually run
    converged: Array  # (B,) bool
    failed: Array | None = None  # (B,) bool: non-finite iterate/gap detected


def _rel_gap(gb: GramBatch, X: Array) -> Array:
    """Batched relative duality gap (see ops/gap.py for the derivation),
    feature-major. One extra Gram matvec per check."""
    QX = jnp.einsum("ijb,jb->ib", gb.Q, X, precision=_HI)
    xQx = jnp.sum(X * QX, axis=0)
    cx = jnp.sum(gb.c * X, axis=0)
    xx = jnp.sum(X * X, axis=0)
    l1 = jnp.sum(jnp.abs(X), axis=0)
    rr = jnp.maximum(xQx - 2.0 * cx + gb.btb, 0.0)
    rb = cx - gb.btb
    u = QX - gb.c + gb.alpha2 * X
    u_inf = jnp.max(jnp.abs(u), axis=0)
    uu = jnp.sum(u * u, axis=0)

    f = 0.5 * rr + 0.5 * gb.alpha2 * xx + gb.alpha1 * l1
    s = jnp.where(u_inf > gb.alpha1, gb.alpha1 / jnp.maximum(u_inf, 1e-30), 1.0)
    dual_neg = 0.5 * (s * s) * rr + s * rb + 0.5 * gb.alpha2 * (s * s) * xx
    l1_gap = jnp.maximum(f + dual_neg, 0.0)
    smooth_gap = uu / jnp.where(gb.alpha2 > 0, 2.0 * gb.alpha2, 1.0)
    gap = jnp.where(gb.alpha1 > 0, l1_gap, smooth_gap)
    return gap / jnp.maximum(f, 1.0)


def _iterate_block(gb: GramBatch, cfg: BatchFISTAConfig, state: BatchState,
                   n_steps: int) -> BatchState:
    """Run ``n_steps`` lockstep FISTA iterations; converged lanes frozen."""
    tau_min = (1.0 / gb.L).astype(gb.c.dtype)  # greedy shrink floor

    def one(_, s: BatchState) -> BatchState:
        QY = jnp.einsum("ijb,jb->ib", gb.Q, s.Y, precision=_HI)
        grad = QY - gb.c + gb.alpha2 * s.Y
        if cfg.backtracking:
            # masked per-lane Armijo (reference iterative_solvers.py:183-197;
            # mirrors solvers/common.py:armijo_prox_search): accept when
            # g(x⁺) ≤ g(y) + C⟨∇g(y), x⁺−y⟩, shrink τ ← η·τ otherwise; a
            # lane's accepted τ persists across iterations and never grows.
            g_y = (
                0.5 * jnp.sum(s.Y * QY, axis=0)
                - jnp.sum(gb.c * s.Y, axis=0)
                + 0.5 * gb.btb
                + 0.5 * gb.alpha2 * jnp.sum(s.Y * s.Y, axis=0)
            )

            def trial(tau):
                Xc = soft_threshold(s.Y - tau * grad, tau * gb.alpha1)
                QX = jnp.einsum("ijb,jb->ib", gb.Q, Xc, precision=_HI)
                g_x = (
                    0.5 * jnp.sum(Xc * QX, axis=0)
                    - jnp.sum(gb.c * Xc, axis=0)
                    + 0.5 * gb.btb
                    + 0.5 * gb.alpha2 * jnp.sum(Xc * Xc, axis=0)
                )
                ok = g_x <= g_y + cfg.armijo_c * jnp.sum(grad * (Xc - s.Y), axis=0)
                return Xc, ok

            X0, ok0 = trial(s.tau)

            def bt_cond(c):
                tau, X, acc, k = c
                return jnp.any(~acc) & (k < cfg.max_backtracks)

            def bt_body(c):
                tau, X, acc, k = c
                tau_n = jnp.where(acc, tau, cfg.ls_eta * tau)
                Xc, ok = trial(tau_n)
                return tau_n, jnp.where(acc[None, :], X, Xc), acc | ok, k + 1

            tau_bt, X_next, _, _ = jax.lax.while_loop(
                bt_cond, bt_body, (s.tau, X0, ok0, jnp.zeros((), jnp.int32))
            )
        else:
            tau_bt = s.tau
            X_next = soft_threshold(s.Y - s.tau * grad, s.tau * gb.alpha1)
        this_step = jnp.sqrt(jnp.sum((X_next - s.X) ** 2, axis=0))
        tau_next = tau_bt
        first_step = s.first_step

        if cfg.momentum == "delta":
            k_ref = (s.k + 1).astype(X_next.dtype)
            theta = k_ref / (k_ref + 1.0 + cfg.delta)
            Y_next = X_next + theta * (X_next - s.X)
            t_next = s.t
        elif cfg.momentum == "greedy":
            # Unit momentum with a gradient-mapping restart: reset y to x
            # when ⟨y_k − x_{k+1}, x_{k+1} − x_k⟩ ≥ 0 (the step turned
            # against the previous movement direction).
            Y_next = X_next + (X_next - s.X)
            restart = jnp.sum((s.Y - X_next) * (X_next - s.X), axis=0) >= 0.0
            Y_next = jnp.where(restart[None, :], X_next, Y_next)
            t_next = s.t
            # Safeguard: the overshot step ξ/L is only locally safe; once
            # steps grow past S·‖Δx_1‖, shrink τ toward the safe 1/L.
            first_step = jnp.where(s.first_step == 0.0, this_step, s.first_step)
            grow = this_step > cfg.greedy_S * first_step
            # Shrink on growth AND on restarts: a lane that keeps restarting
            # is oscillating from the overshoot — decay its τ toward the safe
            # 1/L so the tail lanes degrade gracefully into plain FISTA
            # instead of jittering above the certification tolerance forever.
            tau_next = jnp.where(
                grow | restart,
                jnp.maximum(cfg.greedy_shrink * s.tau, tau_min),
                s.tau,
            )
        else:
            t_next = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * s.t**2))
            beta = (s.t - 1.0) / t_next
            Y_next = X_next + beta * (X_next - s.X)
            if cfg.adaptive_restart:
                ratio = jnp.where(
                    s.prev_step > 0.0,
                    this_step / jnp.maximum(s.prev_step, 1e-30),
                    jnp.inf,
                )
                restart = ratio > cfg.restart_threshold
                t_next = jnp.where(restart, 1.0, t_next)
                Y_next = jnp.where(restart[None, :], X_next, Y_next)

        live = ~s.done
        return BatchState(
            X=jnp.where(live[None, :], X_next, s.X),
            Y=jnp.where(live[None, :], Y_next, s.Y),
            t=jnp.where(live, t_next, s.t),
            prev_step=jnp.where(live, this_step, s.prev_step),
            done=s.done,
            iters=s.iters + live.astype(jnp.int32),
            gap=s.gap,
            k=s.k + 1,
            tau=jnp.where(live, tau_next, s.tau),
            first_step=jnp.where(live, first_step, s.first_step),
        )

    return jax.lax.fori_loop(0, n_steps, one, state)


def init_batch_state(gb: GramBatch) -> BatchState:
    n, B = gb.c.shape
    return BatchState(
        X=jnp.zeros((n, B), gb.c.dtype),
        Y=jnp.zeros((n, B), gb.c.dtype),
        t=jnp.ones((B,), gb.c.dtype),
        prev_step=jnp.zeros((B,), gb.c.dtype),
        done=jnp.zeros((B,), bool),
        iters=jnp.zeros((B,), jnp.int32),
        gap=jnp.full((B,), jnp.inf, gb.c.dtype),
        k=jnp.zeros((), jnp.int32),
        # tau=0 is a sentinel: fista_gram_batch fills it from (cfg, L) — so
        # states built here resume correctly under any momentum mode.
        tau=jnp.zeros((B,), gb.c.dtype),
        first_step=jnp.zeros((B,), gb.c.dtype),
    )


def fista_gram_batch(
    gb: GramBatch,
    cfg: BatchFISTAConfig = BatchFISTAConfig(),
    state0: BatchState | None = None,
    return_state: bool = False,
):
    """Solve the whole batch; exits as soon as every instance is certified at
    ``rel_gap_tol`` (or at ``max_iter``).

    ``state0`` resumes a previous run exactly (see utils/checkpoint.py —
    ``BatchState`` is a plain pytree; ``max_iter`` counts total iterations
    including the resumed ones). With ``return_state`` the final state is
    returned alongside the result for checkpointing.
    """
    xi = cfg.greedy_xi if cfg.momentum == "greedy" else cfg.t_init_factor
    tau0 = (xi / gb.L).astype(gb.c.dtype)
    if state0 is None:
        state0 = init_batch_state(gb)
    # Fill the tau sentinel (fresh or init_batch_state-built resume states).
    state0 = state0._replace(tau=jnp.where(state0.tau > 0.0, state0.tau, tau0))

    if cfg.check_every <= 0:
        # max_iter counts total iterations including any resumed-from state
        remaining = jnp.maximum(cfg.max_iter - state0.k, 0)
        final = _iterate_block(gb, cfg, state0, remaining)
        gap = _rel_gap(gb, final.X)
        failed = ~jnp.all(jnp.isfinite(final.X), axis=0) | jnp.isnan(gap)
        final = final._replace(gap=gap, done=(gap <= cfg.rel_gap_tol) & ~failed)
        result = BatchResult(
            x=final.X.T,
            iters=final.iters,
            rel_gap=gap,
            n_iters_total=final.k,
            converged=final.done,
            failed=failed,
        )
        return (result, final) if return_state else result

    def cond(s: BatchState):
        return (s.k < cfg.max_iter) & jnp.any(~s.done)

    def body(s: BatchState):
        gap_before = s.gap
        s = _iterate_block(gb, cfg, s, cfg.check_every)
        gap = _rel_gap(gb, s.X)
        # Failure detection: a lane whose iterate went non-finite (bad data,
        # underestimated Lipschitz ⇒ divergence) is quarantined — marked done
        # with gap=inf so the healthy lanes don't spin until max_iter.
        failed = ~jnp.all(jnp.isfinite(s.X), axis=0) | jnp.isnan(gap)
        newly_done = (~s.done) & ((gap <= cfg.rel_gap_tol) | failed)
        if cfg.momentum == "greedy":
            # Outer safeguard: the ξ/L overshoot can limit-cycle without ever
            # triggering the restart test. A live lane whose certified gap
            # did not improve over a whole check window gets its τ halved
            # toward 1/L — stuck lanes provably degrade into plain FISTA.
            stuck = (~s.done) & (gap > 0.9 * gap_before)
            tau = jnp.where(
                stuck,
                jnp.maximum(0.5 * s.tau, (1.0 / gb.L).astype(s.tau.dtype)),
                s.tau,
            )
            s = s._replace(tau=tau)
        return s._replace(
            done=s.done | newly_done,
            gap=jnp.where(s.done, s.gap, jnp.where(failed, jnp.inf, gap)),
        )

    final = jax.lax.while_loop(cond, body, state0)
    failed = ~jnp.all(jnp.isfinite(final.X), axis=0)
    result = BatchResult(
        x=final.X.T,
        iters=final.iters,
        rel_gap=final.gap,
        n_iters_total=final.k,
        converged=(final.done | (final.gap <= cfg.rel_gap_tol)) & ~failed,
        failed=failed,
    )
    return (result, final) if return_state else result
