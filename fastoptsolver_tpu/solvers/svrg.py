"""Prox-SVRG: stochastic variance-reduced proximal gradient (Xiao & Zhang
2014). Capability addition for the tall-data regime (m ≫ n) the reference's
full-gradient methods don't scale to: each inner step touches a minibatch of
rows instead of all m, while variance reduction keeps the linear convergence
of the full-gradient method.

    epoch s:  μ = ∇g(x̃)                      (one full pass, 2 matvecs)
    inner t:  v = ∇g_B(x) − ∇g_B(x̃) + μ      (minibatch B, 4 small matvecs)
              x ← prox_{ηh}(x − ηv)

Design (vs. the textbook sampled-index loop):

- **Permuted-minibatch epochs**: indices are one `jax.random.permutation`
  per epoch reshaped to (steps, batch) — every inner step is a *static-shape*
  row gather + (batch × n) matmul; no per-step host RNG, no
  dynamic shapes.
- The whole optimization is ONE compiled program: `lax.scan` over epochs,
  `lax.scan` over the minibatches inside, PRNG key threaded through the
  carry. vmap over stacked problems batches everything.
- Early exit via a converged flag (objective-flat or gradient-map tolerance)
  that freezes the carry — epochs after convergence are cheap no-ops, the
  standard fixed-length-scan trick used across this framework.

Reference citation: the reference has no stochastic solver; its closest
machinery is the full-gradient ISTA loop (/root/reference/
iterative_solvers.py:85-123) of which one inner prox-SVRG step is the
minibatch analogue.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import Array

from .common import Metrics, SolveResult, tree_where


@dataclasses.dataclass(frozen=True)
class SVRGConfig:
    epochs: int = 50
    batch: int = 128  # minibatch rows per inner step
    steps_per_epoch: int = 0  # 0 → one full pass: m // batch
    step_factor: float = 0.1  # η = step_factor / L  (L = λmax(AᵀA) + α₂)
    tol: float = 1e-10  # stop when epoch objective decrease < tol·max(|f|,1)
    patience: int = 5  # ...for this many consecutive epochs (single flat
    # epochs happen transiently — stochastic steps can wander within an epoch)
    gradmap_tol: float = 0.0  # optional: ‖x − prox(x−∇g(x))‖/η tolerance


class SVRGState(NamedTuple):
    x: Array
    x_snap: Array
    mu: Array  # full gradient at the snapshot
    f: Array
    key: Array
    epoch: Array
    flat_count: Array  # consecutive epochs with sub-tol objective decrease
    done: Array


def prox_svrg(
    problem,
    L: Array,
    config: SVRGConfig = SVRGConfig(),
    x0: Array | None = None,
    key: Array | None = None,
) -> SolveResult:
    """Minimize ``½‖Ax−b‖² (+ ½α₂‖x‖²) + h(x)`` for a row-separable smooth
    part. ``problem`` must expose ``A``, ``b``, ``prox`` (every least-squares
    family problem does); ``L`` is the smooth Lipschitz constant
    (ops/lipschitz.py)."""
    A, b = problem.A, problem.b
    m, n = A.shape
    dtype = A.dtype
    a2 = getattr(problem, "alpha2", None)
    if a2 is None or not getattr(problem, "ridge_in_smooth", True):
        a2 = jnp.zeros((), A.dtype)
    key = jax.random.PRNGKey(0) if key is None else key
    x_init = problem.x0() if x0 is None else x0

    batch = min(config.batch, m)
    steps = config.steps_per_epoch or max(m // batch, 1)
    eta = jnp.asarray(config.step_factor, dtype) / L
    scale = jnp.asarray(m / batch, dtype)

    def full_grad(x: Array) -> Array:
        return A.T @ (A @ x - b) + a2 * x

    def epoch(state: SVRGState, _) -> tuple[SVRGState, None]:
        def run(state: SVRGState) -> SVRGState:
            key, sub = jax.random.split(state.key)
            # one permuted pass: (steps, batch) static-shape row blocks
            perm = jax.random.permutation(sub, m)[: steps * batch]
            idx = perm.reshape(steps, batch)

            mu = full_grad(state.x)  # snapshot gradient at current x
            x_snap = state.x

            def inner(x: Array, ids: Array) -> tuple[Array, None]:
                Ab = A[ids]  # (batch, n) gather — static shape, matmuls
                r_x = Ab @ x - b[ids]
                r_s = Ab @ x_snap - b[ids]
                v = scale * (Ab.T @ (r_x - r_s)) + mu + a2 * (x - x_snap)
                return problem.prox(x - eta * v, eta), None

            x_new, _ = jax.lax.scan(inner, state.x, idx)
            f_new = problem.objective(x_new)
            flat = (state.f - f_new) <= config.tol * jnp.maximum(
                jnp.abs(state.f), 1.0
            )
            flat_count = jnp.where(flat, state.flat_count + 1, 0)
            done = flat_count >= config.patience
            if config.gradmap_tol > 0.0:
                gm = x_new - problem.prox(x_new - eta * full_grad(x_new), eta)
                done = done | (jnp.linalg.norm(gm) / eta <= config.gradmap_tol)
            return SVRGState(
                x=x_new, x_snap=x_snap, mu=mu, f=f_new, key=key,
                epoch=state.epoch + 1, flat_count=flat_count, done=done,
            )

        new = run(state)
        new = tree_where(state.done, state, new)  # freeze once converged
        return new, None

    state0 = SVRGState(
        x=x_init,
        x_snap=x_init,
        mu=jnp.zeros(n, dtype),
        f=problem.objective(x_init),
        key=key,
        epoch=jnp.zeros((), jnp.int32),
        flat_count=jnp.zeros((), jnp.int32),
        done=jnp.zeros((), bool),
    )
    final, _ = jax.lax.scan(epoch, state0, None, length=config.epochs)
    grad_evals = final.epoch * (1 + 2 * steps)  # full pass + 2 minibatch evals/step
    return SolveResult(
        x=final.x,
        n_iters=final.epoch,
        L=L,
        final_tau=eta,
        metrics=Metrics.zero()._replace(n_grad_evals=grad_evals),
    )
