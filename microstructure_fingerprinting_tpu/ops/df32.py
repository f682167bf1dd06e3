"""Error-free float32 transforms (double-float building blocks).

Matmuls and elementwise arithmetic round at 2^-24; the exhaustive-NNLS
residual algebra cancels catastrophically (res = O(1) - O(1) with true value
~1e-9), so plain f32 scans rank near-optimal candidates by noise. These
helpers implement the classic error-free transformations (Dekker/Knuth/
Neumaier) used by the compensated scan (ops/dfscan.py):

  * two_sum(a, b)        -> (s, e) with s + e == a + b exactly
  * split(a)             -> (ah, al), a == ah + al, 12/12-bit halves
  * two_prod_presplit    -> (p, e) with p + e == a * b exactly
  * df values are (hi, lo) pairs with |lo| <= ulp(hi)

All functions are branchless jnp expressions (safe inside jit and scan).
They rely on IEEE-correct f32 add/mul; XLA does not reassociate floating
point. GPU and CPU compilers do contract a product and a following add
into one fused multiply-add: every product in these transforms is either
exact (halves of at most 12 bits) or passed through ``_rounded`` before
its rounding error is taken, so contraction cannot change their results.
"""

import jax.numpy as jnp
from jax import lax


def two_sum(a, b):
    """Knuth two-sum: exact (s, e) with s = fl(a+b), s + e = a + b."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """Dekker two-sum, valid when |a| >= |b|."""
    s = a + b
    e = b - (s - a)
    return s, e


def split(a):
    """Split a == ah + al into halves of at most 12 significant bits each.

    ah keeps the sign, exponent and top 11 stored mantissa bits of a (an
    integer mask, so no rounded product is involved); al = a - ah is
    exact. Products of two such halves are exact in f32."""
    bits = lax.bitcast_convert_type(a, jnp.uint32) & jnp.uint32(0xFFFFF000)
    ah = lax.bitcast_convert_type(bits, jnp.float32)
    return ah, a - ah


def _rounded(x):
    """``x`` unchanged, as a value no later add can fuse with.

    A compiler may contract ``x*y + z`` into one fused multiply-add,
    which skips the rounding of ``x*y``. Where the error of that rounding
    is then computed (two_prod, two_sum), the select stops the product
    from being fused into its consumers."""
    return jnp.where(jnp.isnan(x), jnp.float32(jnp.nan), x)


def two_prod(a, b):
    """Exact product: (p, e) with p = fl(a*b), p + e = a * b."""
    ah, al = split(a)
    bh, bl = split(b)
    return two_prod_presplit(a, ah, al, b, bh, bl)


def two_prod_presplit(a, ah, al, b, bh, bl):
    """two_prod with both operands pre-split (the split of per-row /
    per-column factors is hoisted out of the candidate grid)."""
    p = _rounded(a * b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def df_from_sum(*vals):
    """Exact (hi, lo) sum of a few f32 values via a two_sum cascade."""
    hi = vals[0]
    lo = jnp.zeros_like(hi) if hasattr(hi, "shape") else jnp.float32(0)
    for v in vals[1:]:
        hi, e = two_sum(hi, v)
        lo = lo + e
    return hi, lo


def df_add(x, y):
    """(hi, lo) + (hi, lo) -> (hi, lo) (Dekker add, ~1 ulp^2 error)."""
    s, e = two_sum(x[0], y[0])
    e = e + (x[1] + y[1])
    return fast_two_sum(s, e)


def df_neg(x):
    return (-x[0], -x[1])


def df_mul(x, y):
    """(hi, lo) * (hi, lo) -> (hi, lo), dropping the lo*lo term."""
    p, e = two_prod(x[0], y[0])
    e = e + (x[0] * y[1] + x[1] * y[0])
    return fast_two_sum(p, e)


def presplit(x):
    """df (hi, lo) -> (hi, lo, hi_h, hi_l) with the hi half split.

    Splitting is hoisted to per-row/per-column factors so the per-grid-point
    products (mul_ps) cost ~12 flops instead of ~28.
    """
    hh, hl = split(x[0])
    return (x[0], x[1], hh, hl)


def mul_ps(x, y):
    """Product of two presplit df values -> (main, err) partial pair."""
    p = _rounded(x[0] * y[0])
    e = ((x[2] * y[2] - p) + x[2] * y[3] + x[3] * y[2]) + x[3] * y[3]
    e = e + (x[0] * y[1] + x[1] * y[0])
    return p, e


def compensated_dot_pairs(pairs):
    """Compensated sum of exact products.

    pairs: list of (x, y) f32 arrays. Returns (hi, lo) ~= sum x_i * y_i with
    the main terms accumulated by a two_sum cascade and all error terms in a
    plain-f32 side sum (their magnitudes are ~ulp of the mains, so their own
    rounding is ~ulp^2 — negligible).
    """
    hi = None
    lo = None
    for x, y in pairs:
        p, e = two_prod(x, y)
        if hi is None:
            hi, lo = p, e
        else:
            hi, s = two_sum(hi, p)
            lo = lo + (s + e)
    return hi, lo
