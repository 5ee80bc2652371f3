"""Global-consensus ADMM over a row-sharded design matrix.

Capability addition (the reference has no distribution at all — SURVEY.md §2
"Parallelism: none"). Where parallel/matvec.py distributes *one* FISTA
iteration's matvecs (two psums of m- and n-vectors per iteration), consensus
ADMM restructures the optimization itself around the device mesh:

    minimize  Σᵢ ½‖Aᵢxᵢ − bᵢ‖² + ½(α₂/N)‖xᵢ‖²  +  h(z)
    subject to xᵢ = z,  i = 1..N devices

Each device owns a row block ``(Aᵢ, bᵢ)`` and a private ``xᵢ``; the only
communication is ONE psum of an n-vector per iteration (the consensus
average) — strictly less traffic than the distributed-FISTA path, and the
local x-update is an n×n matmul pair that never touches the interconnect.
This is the classic "splitting across examples" consensus form (Boyd et al.
2011, §8.2), mapped onto a ``jax.sharding.Mesh`` axis with ``shard_map``; XLA
lowers the psum to an all-reduce over the cards' interconnect (NVLink).

Iteration (scaled-dual form; all steps device-local except the psum):

    xᵢ⁺ = (AᵢᵀAᵢ + (α₂/N)I + ρI)⁻¹ (Aᵢᵀbᵢ + ρ(z − uᵢ))
    z⁺  = prox_{h/(Nρ)}( meanᵢ(xᵢ⁺ + uᵢ) )          ← the one psum
    uᵢ⁺ = uᵢ + xᵢ⁺ − z⁺

The per-device linear system is solved via a one-time local eigendecomposition
(see solvers/admm.py for why: adaptive ρ becomes free), computed inside the
shard_map region so each device factorizes only its own Gram block.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import Array
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.prox import soft_threshold
from ..problems.base import fold_alphas
from ..solvers.admm import ADMMConfig, ADMMResult, ADMMState
from .mesh import MODEL_AXIS


def consensus_admm(
    A,
    b,
    mesh: Mesh,
    reg_type: str = "lasso",
    alpha1: float = 0.0,
    alpha2: float = 0.0,
    config: ADMMConfig = ADMMConfig(),
    axis: str = MODEL_AXIS,
    dtype=jnp.float32,
) -> ADMMResult:
    """Solve ``½‖Ax−b‖² + ½α₂‖x‖² + α₁‖x‖₁`` with A row-sharded over
    ``mesh[axis]``. Rows are zero-padded to a multiple of the axis size
    (zero rows change neither the Gram matrix nor Aᵀb)."""
    a1, a2, _ = fold_alphas(reg_type, alpha1, alpha2)
    A = jnp.asarray(A, dtype)
    b = jnp.asarray(b, dtype)
    m, n = A.shape
    n_dev = mesh.shape[axis]
    pad = (-m) % n_dev
    if pad:
        A = jnp.concatenate([A, jnp.zeros((pad, n), dtype)], axis=0)
        b = jnp.concatenate([b, jnp.zeros((pad,), dtype)], axis=0)

    a1 = jnp.asarray(a1, dtype)
    a2_local = jnp.asarray(a2 / n_dev, dtype)
    gamma = config.over_relaxation
    sqrt_n = jnp.sqrt(jnp.asarray(n, dtype))
    sqrt_N = jnp.sqrt(jnp.asarray(n_dev, dtype))

    def local_solve(A_blk: Array, b_blk: Array) -> ADMMResult:
        # One-time local factorization: each device diagonalizes only its own
        # Gram block; ρ changes afterwards cost nothing.
        Q = A_blk.T @ A_blk + a2_local * jnp.eye(n, dtype=dtype)
        c = A_blk.T @ b_blk
        lam, V = jnp.linalg.eigh(Q)

        def x_update(rhs: Array, rho: Array) -> Array:
            return V @ ((V.T @ rhs) / (lam + rho))

        def cond(s: ADMMState) -> Array:
            return (~s.converged) & (s.k < config.max_iter)

        def body(s: ADMMState) -> ADMMState:
            x = x_update(c + s.rho * (s.z - s.u), s.rho)
            x_hat = gamma * x + (1.0 - gamma) * s.z
            # THE collective: consensus mean of (x̂ᵢ + uᵢ) — one n-vector psum.
            zbar = jax.lax.psum(x_hat + s.u, axis) / n_dev
            z = soft_threshold(zbar, a1 / (n_dev * s.rho))
            u = s.u + x_hat - z

            # Residuals follow Boyd §7.1.1 / §8.2: primal r² = Σᵢ‖xᵢ−z‖²
            # (psum'd), dual s = ρ√N‖z−z_prev‖ (replicated, no comm).
            r_norm = jnp.sqrt(jax.lax.psum(jnp.sum((x - z) ** 2), axis))
            s_norm = s.rho * sqrt_N * jnp.linalg.norm(z - s.z)
            x_norm = jnp.sqrt(jax.lax.psum(jnp.sum(x * x), axis))
            u_norm = jnp.sqrt(jax.lax.psum(jnp.sum(u * u), axis))
            eps_pri = sqrt_n * sqrt_N * config.abstol + config.reltol * jnp.maximum(
                x_norm, sqrt_N * jnp.linalg.norm(z)
            )
            eps_dual = sqrt_n * sqrt_N * config.abstol + config.reltol * s.rho * u_norm
            converged = (r_norm <= eps_pri) & (s_norm <= eps_dual)

            rho, u_scaled = s.rho, u
            if config.adaptive_rho:
                grow = r_norm > config.rho_mu * s_norm
                shrink = s_norm > config.rho_mu * r_norm
                factor = jnp.where(
                    grow, config.rho_tau, jnp.where(shrink, 1.0 / config.rho_tau, 1.0)
                ).astype(dtype)
                rho_new = jnp.clip(s.rho * factor, 1.0 / config.rho_cap, config.rho_cap)
                u_scaled = u * (s.rho / rho_new)
                rho = rho_new

            return ADMMState(
                x=x, z=z, u=u_scaled, rho=rho, k=s.k + 1,
                r_norm=r_norm, s_norm=s_norm, converged=converged,
            )

        z0 = jnp.zeros(n, dtype)
        # x and u are device-local (varying over the mesh axis) in the loop
        # body; mark the zero initials accordingly for shard_map's
        # varying-manual-axes check.
        local0 = jax.lax.pcast(z0, (axis,), to="varying")
        init = ADMMState(
            x=local0,
            z=z0,
            u=local0,
            rho=jnp.asarray(config.rho, dtype),
            k=jnp.zeros((), jnp.int32),
            r_norm=jnp.asarray(jnp.inf, dtype),
            s_norm=jnp.asarray(jnp.inf, dtype),
            converged=jnp.zeros((), bool),
        )
        final = jax.lax.while_loop(cond, body, init)
        # z / scalars are replicated (psum-derived); xᵢ, uᵢ stay device-local.
        return ADMMResult(
            x=final.z,
            x_smooth=final.x,
            u=final.u,
            rho=final.rho,
            n_iters=final.k,
            r_norm=final.r_norm,
            s_norm=final.s_norm,
            converged=final.converged,
        )

    out_specs = ADMMResult(
        x=P(),
        x_smooth=P(axis),  # per-device local iterates, stacked
        u=P(axis),
        rho=P(),
        n_iters=P(),
        r_norm=P(),
        s_norm=P(),
        converged=P(),
    )

    def local(A_blk, b_blk):
        res = local_solve(A_blk, b_blk)
        # Expose the device-local vectors with a leading shard axis so the
        # stacked global views are (N, n).
        return res._replace(
            x_smooth=res.x_smooth[None, :], u=res.u[None, :]
        )

    return jax.shard_map(
        local, mesh=mesh, in_specs=(P(axis, None), P(axis)), out_specs=out_specs
    )(A, b)
