"""Prox-SAGA: incremental variance-reduced proximal gradient (Defazio,
Bach & Lacoste-Julien 2014). Complements prox-SVRG (solvers/svrg.py) in the
tall-data regime: no snapshot pass — instead a per-row gradient *table* keeps
the variance correction always current, giving the same linear rate with a
single sweep structure.

For row-separable least squares the per-row gradient is rank-1
(∇fᵢ(x) = aᵢ(aᵢᵀx − bᵢ)), so the table is just the **m scalar residuals**
φᵢ = aᵢᵀx_old − bᵢ — O(m) memory, not the textbook O(mn) — with the table
mean maintained incrementally as s = Aᵀφ (one (batch×n) matvec per step).

Average form: ĝ(x) = (1/m)Σ ½(aᵢᵀx−bᵢ)² + ½(α₂/m)‖x‖², step on
prox_{η·h/m}. Minibatch update (ids B):

    v   = (1/|B|)·A_Bᵀ(r_B − φ_B) + s/m + (α₂/m)·x
    x   ← prox(x − ηv, η/m)
    s   ← s + A_Bᵀ(r_B − φ_B);   φ_B ← r_B

The design mirrors svrg.py: permuted-minibatch epochs (static-shape
row gathers → matmuls), the whole run one compiled program
(`lax.scan` over epochs and steps), early exit by freezing the carry.

Reference citation: no stochastic solver exists in the reference; the
full-gradient ISTA loop (/root/reference/iterative_solvers.py:85-123) is the
m-row analogue of one SAGA step.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import Array

from .common import Metrics, SolveResult, tree_where


@dataclasses.dataclass(frozen=True)
class SAGAConfig:
    epochs: int = 50
    batch: int = 128  # minibatch rows per step
    steps_per_epoch: int = 0  # 0 → one full pass: m // batch
    step_factor: float = 1.0 / 3.0  # η = step_factor / max_i(‖aᵢ‖² + α₂/m)
    tol: float = 1e-10  # stop when epoch objective decrease < tol·max(|f|,1)
    patience: int = 5  # ...for this many consecutive epochs


class SAGAState(NamedTuple):
    x: Array
    phi: Array  # (m,) residual table aᵢᵀx_old − bᵢ
    s: Array    # (n,) Aᵀphi, the table-mean numerator
    f: Array
    key: Array
    epoch: Array
    flat_count: Array
    done: Array


def prox_saga(
    problem,
    config: SAGAConfig = SAGAConfig(),
    x0: Array | None = None,
    key: Array | None = None,
) -> SolveResult:
    """Minimize ``½‖Ax−b‖² (+ ½α₂‖x‖²) + h(x)`` for a row-separable smooth
    part. ``problem`` must expose ``A``, ``b``, ``prox`` (every least-squares
    family problem does). The step size is set from the max row norm
    (per-piece Lipschitz constant) — no power iteration needed."""
    A, b = problem.A, problem.b
    m, n = A.shape
    dtype = A.dtype
    a2 = getattr(problem, "alpha2", None)
    if a2 is None or not getattr(problem, "ridge_in_smooth", True):
        a2 = jnp.zeros((), dtype)
    key = jax.random.PRNGKey(0) if key is None else key
    x_init = problem.x0() if x0 is None else x0

    batch = min(config.batch, m)
    steps = config.steps_per_epoch or max(m // batch, 1)
    m_f = jnp.asarray(float(m), dtype)
    L_max = jnp.max(jnp.sum(A * A, axis=1)) + a2 / m_f
    eta = jnp.asarray(config.step_factor, dtype) / L_max
    inv_batch = jnp.asarray(1.0 / batch, dtype)

    def epoch(state: SAGAState, _) -> tuple[SAGAState, None]:
        def run(state: SAGAState) -> SAGAState:
            key, sub = jax.random.split(state.key)
            idx = jax.random.permutation(sub, m)[: steps * batch].reshape(
                steps, batch
            )

            def inner(carry, ids):
                x, phi, s = carry
                Ab = A[ids]  # (batch, n) static-shape gather
                r = Ab @ x - b[ids]
                gdiff = Ab.T @ (r - phi[ids])
                v = inv_batch * gdiff + s / m_f + (a2 / m_f) * x
                x_new = problem.prox(x - eta * v, eta / m_f)
                return (x_new, phi.at[ids].set(r), s + gdiff), None

            (x_new, phi_new, s_new), _ = jax.lax.scan(
                inner, (state.x, state.phi, state.s), idx
            )
            f_new = problem.objective(x_new)
            flat = (state.f - f_new) <= config.tol * jnp.maximum(
                jnp.abs(state.f), 1.0
            )
            flat_count = jnp.where(flat, state.flat_count + 1, 0)
            return SAGAState(
                x=x_new, phi=phi_new, s=s_new, f=f_new, key=key,
                epoch=state.epoch + 1, flat_count=flat_count,
                done=flat_count >= config.patience,
            )

        new = run(state)
        return tree_where(state.done, state, new), None

    phi0 = A @ x_init - b
    state0 = SAGAState(
        x=x_init,
        phi=phi0,
        s=A.T @ phi0,
        f=problem.objective(x_init),
        key=key,
        epoch=jnp.zeros((), jnp.int32),
        flat_count=jnp.zeros((), jnp.int32),
        done=jnp.zeros((), bool),
    )
    final, _ = jax.lax.scan(epoch, state0, None, length=config.epochs)
    return SolveResult(
        x=final.x,
        n_iters=final.epoch,
        L=L_max,
        final_tau=eta,
        metrics=Metrics.zero()._replace(n_grad_evals=final.epoch * steps),
    )
