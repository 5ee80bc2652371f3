"""Distributed matvecs over a sharded design matrix (shard_map + XLA
collectives).

The sharding recipe (SURVEY.md §2 table, §7 'Hard parts'):

- **Row sharding** ``A ~ P(model, None)``, x replicated. ``A @ x`` is purely
  local (each chip holds full rows); the adjoint ``Aᵀ y`` with row-sharded y
  is a local matvec followed by one ``psum`` over the model axis. The fused
  normal-equation gradient ``Aᵀ(Ax − b)`` therefore costs exactly **one
  collective per iteration** — the same layout serves both matvecs, and Aᵀ is
  never materialized.

- **Column sharding** ``A ~ P(None, model)``, x sharded. ``A @ x`` needs the
  psum; ``Aᵀ r`` is local. Preferable when n ≫ m or when x itself must be
  sharded to fit.

Collectives are expressed inside ``shard_map`` so the communication pattern
is explicit and testable; XLA lowers the psum to an all-reduce over the
cards' interconnect (NVLink between GPUs).
"""
from __future__ import annotations

import jax
from jax.sharding import Mesh, PartitionSpec as P

from .mesh import MODEL_AXIS


def row_sharded_matvec(mesh: Mesh, A, x, axis: str = MODEL_AXIS):
    """y = A @ x with A row-sharded, x replicated → y row-sharded. No comm."""

    def local(A_blk, x_full):
        return A_blk @ x_full

    return jax.shard_map(
        local, mesh=mesh, in_specs=(P(axis, None), P()), out_specs=P(axis)
    )(A, x)


def row_sharded_rmatvec(mesh: Mesh, A, y, axis: str = MODEL_AXIS):
    """z = Aᵀ @ y with A and y row-sharded → z replicated. One psum."""

    def local(A_blk, y_blk):
        return jax.lax.psum(A_blk.T @ y_blk, axis)

    return jax.shard_map(
        local, mesh=mesh, in_specs=(P(axis, None), P(axis)), out_specs=P()
    )(A, y)


def row_sharded_normal_grad(mesh: Mesh, A, b, x, axis: str = MODEL_AXIS):
    """∇(½‖Ax−b‖²) = Aᵀ(Ax−b), fused: local matvec + local residual + local
    adjoint, then a single psum."""

    def local(A_blk, b_blk, x_full):
        r_blk = A_blk @ x_full - b_blk
        return jax.lax.psum(A_blk.T @ r_blk, axis)

    return jax.shard_map(
        local, mesh=mesh, in_specs=(P(axis, None), P(axis), P()), out_specs=P()
    )(A, b, x)


def row_sharded_value_and_grad(mesh: Mesh, A, b, x, axis: str = MODEL_AXIS):
    """(½‖Ax−b‖², Aᵀ(Ax−b)): both psum'd in one shard_map region so XLA can
    fuse the two all-reduces into one fused collective pair per iteration."""

    def local(A_blk, b_blk, x_full):
        r_blk = A_blk @ x_full - b_blk
        val = jax.lax.psum(0.5 * (r_blk @ r_blk), axis)
        grad = jax.lax.psum(A_blk.T @ r_blk, axis)
        return val, grad

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis), P()),
        out_specs=(P(), P()),
    )(A, b, x)


def col_sharded_matvec(mesh: Mesh, A, x, axis: str = MODEL_AXIS):
    """y = A @ x with A column-sharded and x sharded → y replicated. One psum."""

    def local(A_blk, x_blk):
        return jax.lax.psum(A_blk @ x_blk, axis)

    return jax.shard_map(
        local, mesh=mesh, in_specs=(P(None, axis), P(axis)), out_specs=P()
    )(A, x)


def col_sharded_rmatvec(mesh: Mesh, A, y, axis: str = MODEL_AXIS):
    """z = Aᵀ @ y with A column-sharded, y replicated → z sharded. No comm."""

    def local(A_blk, y_full):
        return A_blk.T @ y_full

    return jax.shard_map(
        local, mesh=mesh, in_specs=(P(None, axis), P()), out_specs=P(axis)
    )(A, y)


def col_sharded_normal_grad(mesh: Mesh, A, b, x, axis: str = MODEL_AXIS):
    """Aᵀ(Ax−b) with column sharding: one psum for Ax, adjoint local,
    gradient stays sharded like x."""

    def local(A_blk, b_full, x_blk):
        r = jax.lax.psum(A_blk @ x_blk, axis) - b_full
        return A_blk.T @ r

    return jax.shard_map(
        local, mesh=mesh, in_specs=(P(None, axis), P(), P(axis)), out_specs=P(axis)
    )(A, b, x)
