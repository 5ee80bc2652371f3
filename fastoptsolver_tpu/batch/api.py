"""Instance-batched solving: the whole solver vmapped over stacked problems.

The reference benchmark runs its 80 scenarios in a serial Python for-loop
around single-instance NumPy solvers (SURVEY.md §3.5). Here the *entire
solve* — Lipschitz power iteration, the full FISTA/ISTA/L-BFGS while-loop,
metrics — is ``jax.vmap``-ed over a stacked problem pytree and compiled once:
one XLA program advances every instance in lockstep, with converged instances
frozen by the batching rule's predicate masking, so per-instance stopping
semantics match N independent solves exactly (tested in
tests/test_batch.py).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..ops.lipschitz import lipschitz_for
from ..solvers.fista import FISTAConfig, fista, fista_with_history
from ..solvers.ista import ISTAConfig, ista, ista_with_history
from ..solvers.lbfgs import LBFGSConfig, lbfgs, lbfgs_with_history
from .fista_gram import (
    BatchFISTAConfig,
    BatchResult,
    BatchState,
    fista_gram_batch,
    make_gram_batch,
)

_SOLVERS = {
    "fista": (fista, fista_with_history),
    "ista": (ista, ista_with_history),
    "lbfgs": (lbfgs, lbfgs_with_history),
}


def stack_problems(problems):
    """Stack a list of structurally identical problem pytrees into one batched
    pytree (leading batch axis on every leaf)."""
    return jax.tree.map(lambda *leaves: jnp.stack(leaves), *problems)


def batch_lipschitz(problem_batch, key=None, n_iter: int = 100, tol: float = 1e-6):
    """Per-instance Lipschitz constants, vmapped power iteration."""
    batch = jax.tree.leaves(problem_batch)[0].shape[0]
    if key is None:
        key = jax.random.PRNGKey(0)
    keys = jax.random.split(key, batch)
    return jax.vmap(lambda p, k: lipschitz_for(p, k, n_iter=n_iter, tol=tol))(
        problem_batch, keys
    )


DEFAULT_CFG = BatchFISTAConfig(max_iter=1000, check_every=25, rel_gap_tol=1e-6)


def _check_state(state0) -> None:
    if not isinstance(state0, BatchState):
        raise TypeError(
            f"state0 must be a BatchState, got {type(state0).__name__}"
        )


def solve_gram_batch(gb, cfg=None, state0=None, return_state: bool = False):
    """Solve a prebuilt ``GramBatch`` with the certified batched FISTA driver
    (``fista_gram_batch``).

    ``state0``/``return_state`` give checkpoint/resume: ``state0`` is the
    ``BatchState`` a previous call returned, and the resumed run continues
    its trajectory exactly (``max_iter`` counts the resumed iterations)."""
    if cfg is None:
        cfg = DEFAULT_CFG
    if state0 is not None:
        _check_state(state0)
    return fista_gram_batch(gb, cfg, state0=state0, return_state=return_state)


def solve_lasso_batch(
    A,
    b,
    alpha1,
    alpha2=0.0,
    cfg=None,
    feature_major: bool = False,
    key=None,
    state0=None,
    return_state: bool = False,
    mesh=None,
    mesh_axis: str | None = None,
):
    """One call from raw ``(A, b, α)`` to certified batched lasso solutions.

    The batched Gram precompute (``make_gram_batch``: Q = AᵀA, c = Aᵀb, bᵀb
    and a per-instance power-iteration Lipschitz estimate, all at
    ``Precision.HIGHEST``) feeds the lockstep FISTA driver
    (``fista_gram_batch``), which stops once every instance's duality gap is
    ≤ ``cfg.rel_gap_tol`` or ``cfg.max_iter`` is reached. bench.py and
    chip_smoke.py call exactly this function.

    ``feature_major``: inputs are ``A (n, m, B), b (m, B)``; otherwise
    ``A (B, m, n), b (B, m)``. Returns a ``BatchResult`` (or
    ``(result, state)`` with ``return_state``).

    ``state0``/``return_state``: checkpoint/resume. ``state0`` is the
    ``BatchState`` of an earlier call on the same ``(A, b, α)``; the Gram is
    rebuilt deterministically from the inputs, so only the solver rows
    round-trip. A checkpoint cut on a mesh resumes on one device and vice
    versa (see ``_solve_lasso_batch_sharded``).

    ``mesh``: run the same solve per shard of a ``jax.sharding.Mesh`` over
    the instance axis (``mesh_axis``, default the framework's batch axis) —
    data parallelism via ``shard_map``; the only communication is one
    scalar all-reduce per step of the Lipschitz power iteration.
    """
    if cfg is None:
        cfg = DEFAULT_CFG
    if state0 is not None:
        _check_state(state0)
    if mesh is not None:
        return _solve_lasso_batch_sharded(
            A, b, alpha1, alpha2, cfg, feature_major, key, mesh, mesh_axis,
            state0, return_state,
        )
    gb = _build_gram(A, b, alpha1, alpha2, feature_major, key)
    return fista_gram_batch(gb, cfg, state0=state0, return_state=return_state)


def _solve_lasso_batch_sharded(A, b, alpha1, alpha2, cfg, feature_major, key,
                               mesh, mesh_axis, state0, return_state):
    """Mesh-routed :func:`solve_lasso_batch`: the single-device solve runs
    per shard inside ``shard_map``. Each device owns complete instances, so
    the only cross-device work is the input layout. Instances are padded to
    a multiple of the shard count with copies of the last instance (a real
    problem that certifies like its original); the copies are sliced off.

    The power iteration's start vectors are the single-device ones, drawn
    once for the whole batch and sharded with it, and its exit test spans
    the shards (one scalar all-reduce per power step, the solve's only
    communication), so every lane's L — and with it its trajectory — is the
    one it has on one device.

    Checkpoint/resume: each shard runs its own certification loop and stops
    at its own iteration count ``k``. A shard that stops early has every
    lane done, and every shard that still holds a live lane stops at the
    same ``k`` (the first ``check_every`` multiple ≥ ``max_iter``). So the
    largest per-shard ``k`` is exactly the count every live lane has run,
    and the returned ``BatchState`` carries that one scalar: it has the
    single-device layout and resumes on any mesh or on one device."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..parallel.mesh import BATCH_AXIS

    axis = BATCH_AXIS if mesh_axis is None else mesh_axis
    A_fm = A if feature_major else jnp.transpose(A, (2, 1, 0))
    b_fm = b if feature_major else jnp.transpose(b, (1, 0))
    n, _, B = A_fm.shape
    pB = (-B) % mesh.shape[axis]
    dtype = A_fm.dtype
    a1 = jnp.broadcast_to(jnp.asarray(alpha1, dtype), (B,))
    a2 = jnp.broadcast_to(jnp.asarray(alpha2, dtype), (B,))

    pad_lanes = functools.partial(_pad_lanes, pad=pB)
    lane, plane = P(axis), P(None, axis)
    state_spec = BatchState(X=plane, Y=plane, t=lane, prev_step=lane,
                            done=lane, iters=lane, gap=lane, k=P(), tau=lane,
                            first_step=lane)
    result_spec = BatchResult(x=lane, iters=lane, rel_gap=lane,
                              n_iters_total=lane, converged=lane,
                              failed=lane)
    key = jax.random.PRNGKey(0) if key is None else key
    args = [pad_lanes(A_fm), pad_lanes(b_fm), pad_lanes(a1), pad_lanes(a2)]
    specs = [P(None, None, axis), plane, lane, lane]
    if state0 is not None:
        if state0.X.shape != (n, B):
            raise ValueError(
                f"state0 holds iterates of shape {state0.X.shape}; this call "
                f"solves {(n, B)}"
            )
        padded = jax.tree.map(pad_lanes, state0._replace(k=None))
        args.append(padded._replace(k=jnp.max(state0.k)))
        specs.append(state_spec)

    put = lambda x, s: jax.device_put(x, NamedSharding(mesh, s))
    placed = tuple(
        jax.tree.map(put, x, s, is_leaf=lambda v: isinstance(v, P))
        for x, s in zip(args, specs)
    )
    res, fin = _solve_shards(
        placed, key, mesh=mesh, specs=tuple(specs), cfg=cfg,
        out_specs=(result_spec, state_spec._replace(k=lane)), lanes=B,
    )
    result = BatchResult(
        x=res.x[:B], iters=res.iters[:B], rel_gap=res.rel_gap[:B],
        n_iters_total=jnp.max(res.n_iters_total), converged=res.converged[:B],
        failed=res.failed[:B],
    )
    if not return_state:
        return result
    fin = jax.tree.map(lambda x: x[..., :B], fin._replace(k=None))._replace(k=jnp.max(fin.k))
    return result, fin


def _pad_lanes(x, pad):
    """``x`` with its last (instance) axis padded by ``pad`` copies of the
    last instance."""
    if not pad:
        return x
    return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)], mode="edge")


@functools.partial(jax.jit, static_argnames=("mesh", "specs", "cfg",
                                             "out_specs", "lanes"))
def _solve_shards(args, key, *, mesh, specs, cfg, out_specs, lanes):
    """The per-shard solve of :func:`_solve_lasso_batch_sharded` as one
    compiled program per (shapes, mesh, config): an un-jitted ``shard_map``
    would dispatch its body op by op on every call. The (n, ``lanes``)
    start vectors drawn from ``key`` enter the shards padded and sharded
    like the instances."""
    A = args[0]
    v0 = jax.random.normal(key, (A.shape[0], lanes), A.dtype)
    args = args[:4] + (_pad_lanes(v0, A.shape[-1] - lanes),) + args[4:]
    specs = specs[:4] + (specs[1],) + specs[4:]

    def local(A_blk, b_blk, a1_blk, a2_blk, v0_blk, st=None):
        gb = _build_gram(A_blk, b_blk, a1_blk, a2_blk, True, None, v0_blk,
                         axis_name=mesh.axis_names)
        res, fin = fista_gram_batch(gb, cfg, state0=st, return_state=True)
        # each shard's loop count leaves as a (1,) leaf; reduced by the caller
        return (res._replace(n_iters_total=res.n_iters_total[None]),
                fin._replace(k=fin.k[None]))

    return jax.shard_map(
        local, mesh=mesh, in_specs=specs, out_specs=out_specs,
        # no collectives; the loop carries start replicated and turn
        # device-varying, which the varying-axes check would reject
        check_vma=False,
    )(*args)


def _build_gram(A, b, alpha1, alpha2, feature_major, key, v0=None,
                axis_name=None):
    """The Gram-precompute stage of :func:`solve_lasso_batch`, shared by the
    fresh, resumed and per-shard solves so that a resumed run rebuilds the
    bit-identical Gram. Feature-major inputs are transposed to the
    instance-major layout ``make_gram_batch`` contracts."""
    A_im = jnp.transpose(A, (2, 1, 0)) if feature_major else A
    b_im = jnp.transpose(b, (1, 0)) if feature_major else b
    return make_gram_batch(A_im, b_im, alpha1, alpha2, key=key, v0=v0,
                           axis_name=axis_name)

def solve_batch(
    problem_batch,
    method: str = "fista",
    config=None,
    history: bool = False,
    L=None,
    key=None,
):
    """Solve a stacked batch of problems with one compiled vmapped program.

    ``method`` ∈ {"fista", "ista", "lbfgs"}; ``config`` is the matching static
    config dataclass. ``L`` may be precomputed per-instance Lipschitz constants
    (ignored by lbfgs). Returns a batched ``SolveResult``.
    """
    if method not in _SOLVERS:
        raise ValueError(f"Unknown method '{method}' (want one of {list(_SOLVERS)})")
    solve, solve_hist = _SOLVERS[method]
    fn = solve_hist if history else solve
    if config is None:
        config = {
            "fista": FISTAConfig,
            "ista": ISTAConfig,
            "lbfgs": LBFGSConfig,
        }[method]()

    if method == "lbfgs":
        return jax.vmap(lambda p: fn(p, config))(problem_batch)

    if L is None:
        L = batch_lipschitz(problem_batch, key)
    L = jnp.asarray(L)
    return jax.vmap(lambda p, l: fn(p, config, L=l))(problem_batch, L)
