"""Double-word float32 ("df32") compensated arithmetic.

Why this exists: the Gram-form residual ``rr = xᵀQx − 2cᵀx + bᵀb`` cancels
catastrophically when ‖Ax−b‖² ≪ bᵀb (the large-m lasso regime the streaming
path targets — problems/streaming.py). In plain f32 the duality-gap
evaluation (solvers/gram_dense.py) then floors around ``2⁻²⁴·bᵀb/f`` relative
gap and can spuriously certify (the negative-cancellation clamp) or never
certify. ``jax_enable_x64`` is a process-global flag production code cannot
assume, and f64 runs at a small fraction of the f32 rate on the GPU.

df32 carries (value, error) pairs through the critical reductions, giving
≈48 effective mantissa bits from plain f32 elementwise ops. The reductions are
blocked (lane-wide carries, tree-combined tails) so the scans stay short: a
length-n dot runs ⌈n/128⌉ sequential steps, the (n, n) matvec ⌈n/8⌉ steps of
(n,)-wide vector work.

Design constraint — compiler-proof error-free transforms. The classic
Dekker/Veltkamp two-product assumes ``p = fl(a·b)`` is what downstream adds
consume; inside a fused loop LLVM contracts ``s + a·b`` into ``fma(a, b, s)``
and that assumption silently dies (found bit-by-bit on the CPU backend: a
tie-breaking add 1 ulp off its stored-operand rounding, compensation
describing a product that was never computed; ``reduce_precision`` (8, 23)
and f32↔i32 bitcast round-trips are identities the compiler folds away, so
they cannot pin it). This module therefore never relies on the rounding of
a product: operands are split by *mantissa masking* (an integer AND — not
an identity, so it survives every compiler) into 12-bit halves whose
pairwise products are EXACT in f32. FMA contraction of an exact product
changes nothing, and the remaining arithmetic is adds/subtracts only, where
Knuth's two-sum is valid for any round-to-nearest result —
``optimization_barrier`` keeps XLA's algebraic simplifier from folding the
``(a + b) − a`` extraction patterns at the HLO level (Dekker 1971; Ogita,
Rump & Oishi 2005, "Accurate sum and dot product").

Validated against NumPy float64 in tests/test_df32.py, including the
adversarial rr-cancellation regime, and compiled for the GPU by
chip_smoke.py's ``df32`` phase (the GPU compiler contracts ``a*b+c`` into FMA).

Remaining floor (documented, not hidden): the *stored* (Q, c, bᵀb) triple is
itself f32-rounded, so it is only consistent with a genuine Gram to one
rounding; df32 removes the arithmetic error, leaving that representation
error (~2⁻²⁴ of the accumulated magnitudes). stream_gram's compensated
accumulation keeps it to one rounding rather than one per chunk.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import Array

_MASK = jnp.uint32(0xFFFFF000)  # keep sign+exponent+11 explicit mantissa bits


def _ob(x: Array) -> Array:
    """HLO-level pin: stops XLA's algebraic simplifier from rewriting
    ``(a + b) − a`` → ``b`` and erasing the error extraction. (LLVM-level
    hazards are handled structurally — see module docstring — so a plain
    barrier suffices here.)"""
    return jax.lax.optimization_barrier(x)


def two_sum(a: Array, b: Array) -> tuple[Array, Array]:
    """s + e == a + b exactly, s = fl(a + b) (Knuth). Valid for any
    round-to-nearest fl — including either tie-break side."""
    s = _ob(a + b)
    bb = _ob(s - a)
    e = (a - _ob(s - bb)) + (b - bb)
    return s, e


def split(a: Array) -> tuple[Array, Array]:
    """a == hi + lo exactly, hi on ≤12 significant bits (mantissa masking —
    integer op, immune to float-expression rewrites), lo on ≤12 bits
    (the difference is Sterbenz-exact)."""
    bits = jax.lax.bitcast_convert_type(a, jnp.uint32)
    hi = jax.lax.bitcast_convert_type(bits & _MASK, jnp.float32)
    return hi, a - hi


def exact_mul_terms(a: Array, b: Array) -> tuple[Array, Array, Array, Array]:
    """a·b as four addends, each an EXACT f32 product (12-bit × 12-bit
    mantissas ≤ 24 bits). Feed these to compensated accumulation instead of
    a rounded product — FMA contraction cannot change an exact product."""
    ah, al = split(a)
    bh, bl = split(b)
    return ah * bh, ah * bl, al * bh, al * bl


def two_prod(a: Array, b: Array) -> tuple[Array, Array]:
    """p + e ≈ a·b to ~2⁻³⁵ relative (the cross-term fold ``p2 + p3`` rounds
    once at the 12-bit-half scale). Prefer ``exact_mul_terms`` in compensated
    accumulations — those stay at ~2⁻⁴⁸; this pair form exists for df
    consumers where 2⁻³⁵ is ample (e.g. the α₂x term of the dual vector)."""
    p1, p2, p3, p4 = exact_mul_terms(a, b)
    s, e1 = two_sum(p1, p2 + p3)  # p2+p3 rounds at eps²·|ab| — second order
    s, e2 = two_sum(s, p4)
    return s, e1 + e2


def df_add(a: tuple[Array, Array], b: tuple[Array, Array]) -> tuple[Array, Array]:
    """(hi, lo) + (hi, lo), renormalized."""
    s, e = two_sum(a[0], b[0])
    e = e + (a[1] + b[1])
    return two_sum(s, e)


def df_neg(a: tuple[Array, Array]) -> tuple[Array, Array]:
    return -a[0], -a[1]


def df_scale(a: tuple[Array, Array], k: float) -> tuple[Array, Array]:
    """Multiply by a small exact constant (e.g. 2.0, 0.5)."""
    return a[0] * k, a[1] * k


def df_value(a: tuple[Array, Array]) -> Array:
    return a[0] + a[1]


def _tree_combine(s: Array, lo: Array) -> tuple[Array, Array]:
    """df-reduce a (k,) vector of (value, error) pairs to scalars."""
    while s.shape[0] > 1:
        k = s.shape[0]
        if k % 2:  # pad with exact zero
            s = jnp.concatenate([s, jnp.zeros((1,), s.dtype)])
            lo = jnp.concatenate([lo, jnp.zeros((1,), lo.dtype)])
            k += 1
        h = k // 2
        s, e = two_sum(s[:h], s[h:])
        lo = lo[:h] + lo[h:] + e
    return s[0], lo[0]


def _pad_to(v: Array, mult: int) -> Array:
    n = v.shape[0]
    r = (-n) % mult
    return jnp.pad(v, (0, r)) if r else v


def sum2(v: Array, block: int = 128) -> tuple[Array, Array]:
    """Compensated sum of a 1-D vector: returns (hi, lo) with
    hi + lo ≈ Σvᵢ to ~2⁻⁴⁸ relative (Ogita-Rump-Oishi Sum2, blocked)."""
    v = _pad_to(v, block).reshape(-1, block)

    def step(carry, vi):
        s, lo = carry
        s, e = two_sum(s, vi)
        return (s, lo + e), None

    zero = jnp.zeros((block,), v.dtype)
    (s, lo), _ = jax.lax.scan(step, (zero, zero), v)
    return _tree_combine(s, lo)


def dot2(u: Array, v: Array, block: int = 128) -> tuple[Array, Array]:
    """Compensated dot product of 1-D vectors: (hi, lo) ≈ uᵀv to ~2⁻⁴⁸
    relative of Σ|uᵢvᵢ| (blocked; exact split products, see module
    docstring)."""
    u = _pad_to(u, block).reshape(-1, block)
    v = _pad_to(v, block).reshape(-1, block)

    def step(carry, uv):
        s, lo = carry
        ui, vi = uv
        for p in exact_mul_terms(ui, vi):
            s, e = two_sum(s, p)
            lo = lo + e
        return (s, lo), None

    zero = jnp.zeros((u.shape[1],), u.dtype)
    (s, lo), _ = jax.lax.scan(step, (zero, zero), (u, v))
    return _tree_combine(s, lo)


def dot2_df(u: Array, vh: Array, vl: Array, block: int = 128) -> tuple[Array, Array]:
    """Compensated dot of a plain vector with a df vector (vh, vl):
    (hi, lo) ≈ uᵀ(vh + vl). The u·vl products are second-order — plain f32
    accumulation of them suffices."""
    u = _pad_to(u, block).reshape(-1, block)
    vh = _pad_to(vh, block).reshape(-1, block)
    vl = _pad_to(vl, block).reshape(-1, block)

    def step(carry, uvv):
        s, lo = carry
        ui, vhi, vli = uvv
        for p in exact_mul_terms(ui, vhi):
            s, e = two_sum(s, p)
            lo = lo + e
        return (s, lo + ui * vli), None

    zero = jnp.zeros((u.shape[1],), u.dtype)
    (s, lo), _ = jax.lax.scan(step, (zero, zero), (u, vh, vl))
    return _tree_combine(s, lo)


def matvec2(Q: Array, x: Array, block: int = 8) -> tuple[Array, Array]:
    """Compensated matrix-vector product: (wh, wl) ≈ Qx with per-component
    error ~2⁻⁴⁸·Σⱼ|Qᵢⱼxⱼ|. Scans column blocks with (n,)-wide carries, so
    sequential depth is ⌈n/block⌉ while each step is full-width vector work."""
    n = Q.shape[0]
    ncols = Q.shape[1]
    r = (-ncols) % block
    if r:
        Q = jnp.pad(Q, ((0, 0), (0, r)))
        x = jnp.pad(x, (0, r))
    QT = jnp.swapaxes(Q, 0, 1).reshape(-1, block, n)  # (k, block, n) column groups
    xb = x.reshape(-1, block)

    def step(carry, Qx):
        s, lo = carry
        Qcols, xj = Qx
        for j in range(block):
            for p in exact_mul_terms(Qcols[j], xj[j]):
                s, e = two_sum(s, p)
                lo = lo + e
        return (s, lo), None

    zero = jnp.zeros((n,), Q.dtype)
    (s, lo), _ = jax.lax.scan(step, (zero, zero), (QT, xb))
    return s, lo


def df_vec_add(
    ah: Array, al: Array, bh: Array, bl: Array
) -> tuple[Array, Array]:
    """Elementwise df + df for vectors (renormalized)."""
    s, e = two_sum(ah, bh)
    return two_sum(s, e + (al + bl))


def df_vec_prod(a: Array, b: Array) -> tuple[Array, Array]:
    """Elementwise product of two plain vectors as a df vector (error only
    second-order — exact split products, compensated fold)."""
    return two_prod(a, b)
