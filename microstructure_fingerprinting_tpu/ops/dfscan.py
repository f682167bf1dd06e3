"""Compensated (double-float) exhaustive candidate scan.

Exact-selection rework of the f32 row scans: the algebraic NNLS residual
1 - w'b cancels catastrophically (true gaps ~1e-9 * ||y||^2 vs ~1e-7 f32
noise), so this module evaluates every candidate's residual through two
exact mechanisms:

1. **Exact Gram via int8 matmuls** (``quantize2`` / ``df_gram``): each
   operand is decomposed as X = s1*Q1 + s2*Q2 + R with int8 Q's (exact int32
   accumulation, values < 2^24 so even the int32->f32 cast is exact) and a
   tiny f32 remainder R (|R| <= 2^-15); the Q x Q terms are EXACT and the
   A'R cross matmuls carry only a *relative* f32 error on O(1e-4)-magnitude
   values. The result is a (hi, lo) double-float Gram accurate to ~1e-10.

2. **Compensated bordered determinants**: for a support S, the LS residual
   satisfies res * det(G_S) = det([[G_S, b_S], [b_S', y'y]]). The bordered
   determinant is a polynomial in the Gram entries; it is evaluated with
   error-free products + compensated summation (ops/df32), hoisting all
   per-row (i1) / per-column (i2) factors out of the grid. The division by
   det(G_S) only adds *relative* error — harmless for ranking values near
   zero. Support-selection BOOLEANS (Cramer sign tests, reference
   mf_utils.py:548-593) stay in plain f32: a flipped sign near the boundary
   switches between supports whose residuals agree to second order.

Result: candidate residuals resolved to ~1e-10 * ||y||^2 on f32 hardware —
the scan itself reproduces float64 selection (reference mf_utils.py Numba
kernels) instead of delegating near-ties to downstream re-scoring.
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from . import df32
from . import nnls as mfn

_HP = dict(preferred_element_type=jnp.float32,
           precision=lax.Precision.HIGHEST)
_S1 = jnp.float32(2.0 ** -7)
_S2 = jnp.float32(2.0 ** -15)
_S3 = jnp.float32(2.0 ** -23)
_TOL = jnp.float32(100 * 1.1920929e-07)  # 100 eps_f32 (cf. mf_utils:480)
# Conditioning floor for DOUBLE-FLOAT-evaluated determinants (normalized
# Gram entries, O(1)): the df polynomials resolve cancellation down to the
# ~1e-14 absolute noise of their lo-channels, so supports are only rejected
# when the reference's float64 Cramer solve would itself be garbage. The
# f32-grade _TOL guard (above) rejected real optima: dictionaries with
# highly correlated atoms (duplicated or near-duplicate fingerprints, the
# realistic MC regime) produce valid all-positive solutions at
# det(G) ~ 1e-6..1e-5, which the reference resolves exactly in float64
# (mf_utils.py:554-573 divides by D with no conditioning guard at all).
_TOL_DET = jnp.float32(1e-12)



def quantize2(X):
    """Two-level int8 decomposition X = s1*Q1 + s2*Q2 + R (exact).

    X: f32 array with |X| <= ~1 (normalized columns / signal).
    Returns (Q1 int8, Q2 int8, R f32, a f32) with a = s1*Q1 + s2*Q2 exact
    and R = X - a exact (|R| <= ~2^-15; entries at +-1 saturate the int8
    levels and degrade gracefully to |R| <= ~2^-8 — still exact, only the
    f32 cross-matmul error grows with ||R||).
    """
    X = X.astype(jnp.float32)
    Q1 = jnp.clip(jnp.round(X / _S1), -127, 127).astype(jnp.int8)
    A1 = Q1.astype(jnp.float32) * _S1
    R1 = X - A1
    Q2 = jnp.clip(jnp.round(R1 / _S2), -127, 127).astype(jnp.int8)
    a = A1 + Q2.astype(jnp.float32) * _S2
    R = X - a
    return Q1, Q2, R, a


def quantize3(X):
    """Three-level int8 decomposition X = s1*Q1 + s2*Q2 + s3*Q3 + R
    (exact; |R| <= ~2^-24).

    Extends quantize2 (the first two levels are shared, so XLA CSEs the
    work when both run on one array). The three partial sums are exact in
    f32 — each level k sum is an integer multiple of s_k with magnitude
    <= ~1, i.e. <= 2^23 multiples at s3 = 2^-23 — which level 4 would
    break (2^31 multiples), so three levels is the exactness limit.
    Consumer: the row pass's hoisted Grams (ops/f32scan._gram3_hi), where
    the third level leaves only bf16 corrections on the ~2^-24 residuals.
    """
    Q1, Q2, R2, a2 = quantize2(X)
    Q3 = jnp.clip(jnp.round(R2 / _S3), -127, 127).astype(jnp.int8)
    a = a2 + Q3.astype(jnp.float32) * _S3
    R = X.astype(jnp.float32) - a
    return Q1, Q2, Q3, R, a


def df_gram(qa, qb, contract):
    """Double-float Gram block from two quantized operands.

    qa, qb: (Q1, Q2, R, a) tuples; ``contract`` is an einsum spec
    contracting the sequence axis, e.g. "bst,bsn->btn" or "bsn,bs->bn".
    Returns (hi, lo).
    """
    Q1a, Q2a, Ra, aa = qa
    Q1b, Q2b, Rb, ab = qb
    ei = lambda x, y: jnp.einsum(contract, x, y,
                                 preferred_element_type=jnp.int32)
    ef = lambda x, y: jnp.einsum(contract, x, y, **_HP)
    t11 = ei(Q1a, Q1b)
    t12 = ei(Q1a, Q2b) + ei(Q2a, Q1b)
    t22 = ei(Q2a, Q2b)
    v_a = t11.astype(jnp.float32) * jnp.float32(2.0 ** -14)
    v_b = t12.astype(jnp.float32) * jnp.float32(2.0 ** -22)
    v_c = t22.astype(jnp.float32) * jnp.float32(2.0 ** -30)
    # exact identity: A'B = a'b + A'R_b + R_a'b  (A = a + R_a, B = b + R_b)
    c1 = ef(aa + Ra, Rb)
    c2 = ef(Ra, ab)
    return df32.df_from_sum(v_a, v_b, v_c, c1, c2)


def df_gram_tile(qa_t, qb, n2):
    """Specialized double-float Gram for one (B, S, T) x (B, S, N2p) tile.

    The four int8 x int8 products are fused into ONE integer matmul on
    concatenated operands (one large product instead of four skinny
    ones). The small A'R cross terms (values ~1e-4) run in full f32
    (Precision.HIGHEST): a TF32 product keeps ~11 bits, which would
    leave ~1e-7 absolute error against the ~1e-10 Gram budget.
    qa_t: quantized tile (Q1 (B,S,T), Q2, R, a); qb: quantized full block.
    Returns (hi, lo) of shape (B, T, N2p).
    """
    Q1a, Q2a, Ra, aa = qa_t
    Q1b, Q2b, Rb, ab = qb
    T = Q1a.shape[2]
    Qa = jnp.concatenate([Q1a, Q2a], axis=2)            # (B, S, 2T)
    Qb = jnp.concatenate([Q1b, Q2b], axis=2)            # (B, S, 2N2)
    P = jnp.einsum("bst,bsn->btn", Qa, Qb,
                   preferred_element_type=jnp.int32)
    t11 = P[:, :T, :n2]
    t12 = P[:, :T, n2:] + P[:, T:, :n2]
    t22 = P[:, T:, n2:]
    v_a = t11.astype(jnp.float32) * jnp.float32(2.0 ** -14)
    v_b = t12.astype(jnp.float32) * jnp.float32(2.0 ** -22)
    v_c = t22.astype(jnp.float32) * jnp.float32(2.0 ** -30)
    c1 = jnp.einsum("bst,bsn->btn", aa + Ra, Rb, **_HP)
    c2 = jnp.einsum("bst,bsn->btn", Ra, ab, **_HP)
    return df32.df_from_sum(v_a, v_b, v_c, c1, c2)


def _df(hi, lo=None):
    if lo is None:
        lo = jnp.zeros_like(hi)
    return (hi, lo)


def _mul(x, y):
    return df32.df_mul(x, y)


def _add(*xs):
    out = xs[0]
    for x in xs[1:]:
        out = df32.df_add(out, x)
    return out


def _neg(x):
    return df32.df_neg(x)


def _scale(x, k):
    return (x[0] * k, x[1] * k)  # k a power of two (exact)


def _val(x):
    return x[0] + x[1]


def _bcast(x, expand):
    return (expand(x[0]), expand(x[1]))


def _accumulate(terms):
    """Compensated sum of df terms: two_sum cascade on the his, plain sum
    of the los (magnitudes ~ulp of the mains)."""
    hi = terms[0][0]
    lo = terms[0][1]
    for t in terms[1:]:
        hi, e = df32.two_sum(hi, t[0])
        lo = lo + (e + t[1])
    return hi + lo


@partial(jax.jit, static_argnames=("M", "tile"))
def df3_candidates(A1, A2, a3, y, M=8, tile=256):
    """Top-M candidates for [N1, N2, 1] with double-float selection.

    A1 (B, S, N1), A2 (B, S, N2), a3 (B, S, 1), y (B, S). Returns
    (cand (B, M, 2) int32 [i1, i2], res (B, M) residuals of the NORMALIZED
    problem, y_sq (B,) raw ||y||^2). Reference decision logic
    (mf_utils.py:548-593) with compensated residual values.
    """
    B, S, N1 = A1.shape
    N2 = A2.shape[2]
    A1p, _N1 = mfn._pad_cols(A1, tile)
    A1h, an1 = mfn._normalize_block(A1p)
    A2h, an2 = mfn._normalize_block(A2)
    A3h, an3 = mfn._normalize_block(a3)
    yh, yn, yn_safe = mfn._normalize_y(y)
    tile = min(tile, A1h.shape[2])
    N1p = A1h.shape[2]
    n_tiles = N1p // tile

    qA1 = quantize2(A1h)
    qA2 = quantize2(A2h)
    qA3 = quantize2(A3h)
    qy = quantize2(yh)

    vec = "bsn,bs->bn"
    diag = "bsn,bsn->bn"
    d1 = df_gram(qA1, qA1, diag)                   # (B, N1p) df
    d2 = df_gram(qA2, qA2, diag)
    d3v = df_gram(qA3, qA3, diag)                  # (B, 1)
    p_ = df_gram(qA1, qy, vec)                     # Y1 (B, N1p)
    q_ = df_gram(qA2, qy, vec)                     # Y2 (B, N2)
    r3 = df_gram(qA3, qy, vec)                     # Y3 (B, 1)
    b_ = df_gram(qA1, qA3, "bsn,bsm->bn")          # g13 (B, N1p)
    c_ = df_gram(qA2, qA3, "bsn,bsm->bn")          # g23 (B, N2)
    w_ = df_gram(qy, qy, "bs,bs->b")               # y'y (B,)
    w_ = (w_[0][:, None], w_[1][:, None])
    d3 = d3v
    r_ = r3

    # ---- voxel scalars ----
    C2v = _add(_mul(r_, r_), _neg(_mul(d3, w_)))       # r^2 - d3 w
    d3w_r2 = _neg(C2v)                                 # d3 w - r^2

    # ---- per-row (i1) df factors ----
    Rb2 = _mul(b_, b_)
    Rbp = _mul(b_, p_)
    Rp2 = _mul(p_, p_)
    # support {1}: res1 = (d1 w - p^2) / d1
    r1_num = _add(_mul(d1, w_), _neg(Rp2))
    res1_row = _val(r1_num) / _val(d1)
    # support {1,3}: bordered det / det2
    det13 = _add(_mul(d1, d3), _neg(_mul(b_, b_)))
    num13 = _accumulate([
        _mul(_mul(d1, d3), w_), _neg(_mul(_mul(d1, r_), r_)),
        _neg(_mul(Rb2, w_)), _scale(_mul(_mul(b_, p_), r_), 2.0),
        _neg(_mul(d3, Rp2))])
    res13_row = num13 / _val(det13)
    # {1,3} feasibility (2-var case logic, f32)
    # 2-var case numerators df-accurate (near-duplicate atoms cancel
    # these to ~1e-6; see _TOL_DET)
    w1D_13 = _accumulate([_mul(d3, p_), _neg(_mul(b_, r_))])
    w2D_13 = _accumulate([_mul(d1, r_), _neg(_mul(b_, p_))])
    res13_row, feas13 = _two_var_cases(
        res13_row, w1D_13, w2D_13, _val(p_), _val(r_),
        res1_row, (_val(w_) - _val(r_) ** 2 / _val(d3)), _val(w_))

    # ---- per-column (i2) df factors ----
    Cq2 = _mul(q_, q_)
    Cc2 = _mul(c_, c_)
    Ccq = _mul(c_, q_)
    U1 = _add(Cq2, _neg(_mul(d2, w_)))                 # q^2 - d2 w
    U2 = _scale(_add(_mul(d2, r_), _neg(Ccq)), 2.0)    # 2 (d2 r - c q)
    U3 = _add(_mul(d2, d3w_r2), _neg(_mul(d3, Cq2)),
              _scale(_mul(Ccq, r_), 2.0), _neg(_mul(Cc2, w_)))
    U4 = _add(Cc2, _neg(_mul(d2, d3)))                 # c^2 - d2 d3
    V1 = _scale(_add(_mul(c_, w_), _neg(_mul(q_, r_))), 2.0)
    V2 = _scale(_add(_mul(d3, q_), _neg(_mul(c_, r_))), 2.0)
    # {2}: res2 = (d2 w - q^2)/d2 ; {2,3} analogous to {1,3}
    r2_num = _add(_mul(d2, w_), _neg(Cq2))
    res2_col = _val(r2_num) / _val(d2)
    det23 = _add(_mul(d2, d3), _neg(Cc2))
    num23 = _accumulate([
        _mul(_mul(d2, d3), w_), _neg(_mul(_mul(d2, r_), r_)),
        _neg(_mul(Cc2, w_)), _scale(_mul(Ccq, r_), 2.0),
        _neg(_mul(d3, Cq2))])
    res23_col = num23 / _val(det23)
    w1D_23 = _accumulate([_mul(d3, q_), _neg(_mul(c_, r_))])
    w2D_23 = _accumulate([_mul(d2, r_), _neg(_mul(c_, q_))])
    res23_col, feas23 = _two_var_cases(
        res23_col, w1D_23, w2D_23, _val(q_), _val(r_),
        res2_col, (_val(w_) - _val(r_) ** 2 / _val(d3)), _val(w_))

    # {1,2} constant pieces: const = d1 (d2 w - q^2) - p^2 d2
    # per-row split: d1 * [col] + p^2 * [col]
    d2w_q2 = r2_num

    # f32 broadcast scalars for decision booleans
    rf, wf = _val(r_)[:, :, None], _val(w_)[:, :, None]

    def rowd(x):
        return (x[0][:, :, None], x[1][:, :, None])

    def cold(x):
        return (x[0][:, None, :], x[1][:, None, :])

    def body(carry, t):
        st = t * tile
        sl = lambda v: lax.dynamic_slice(v, (0, st), (B, tile))
        sld = lambda v: (sl(v[0]), sl(v[1]))
        qa1_t = tuple(lax.dynamic_slice(x, (0, 0, st), (B, S, tile))
                      for x in qA1)
        a12 = df_gram_tile(qa1_t, qA2, N2)              # (B, tile, N2) df

        # df per-row slices, broadcast (B, tile, 1)
        d1t, bt, pt = rowd(sld(d1)), rowd(sld(b_)), rowd(sld(p_))
        Rb2t, Rbpt, Rp2t = rowd(sld(Rb2)), rowd(sld(Rbp)), rowd(sld(Rp2))
        d2c, cc, qc = cold(d2), cold(c_), cold(q_)
        U1c, U2c, U3c, U4c = cold(U1), cold(U2), cold(U3), cold(U4)
        V1c, V2c = cold(V1), cold(V2)
        wv = (w_[0][:, :, None], w_[1][:, :, None])
        rv = (r_[0][:, :, None], r_[1][:, :, None])
        d3vv = (d3[0][:, :, None], d3[1][:, :, None])
        C2vv = (C2v[0][:, :, None], C2v[1][:, :, None])

        # ---- support {1,2,3}: bordered 4x4 det, compensated ----
        aa = a12
        qaa = _mul(aa, aa)
        det4 = _accumulate([
            _mul(Rb2t, U1c), _mul(Rbpt, U2c), _mul(d1t, U3c),
            _mul(Rp2t, U4c),
            _mul(aa, _add(_mul(bt, V1c), _mul(pt, V2c))),
            _mul(qaa, C2vv)])
        # detG3 and the Cramer numerators in DOUBLE-FLOAT: the O(1)
        # normalized-Gram terms cancel to ~1e-6 for highly correlated
        # atoms (the realistic MC-dictionary regime), which plain f32
        # cannot resolve — the old f32 guard rejected genuinely optimal
        # supports the reference solves exactly in float64
        # (mf_utils.py:554-573). det23/det13 are the hoisted column/row
        # cofactors d2 d3 - c^2 and d1 d3 - b^2 computed above.
        btcc = _mul(bt, cc)
        Zac = _add(_mul(aa, d3vv), _neg(btcc))       # a d3 - b c
        Wac = _add(_mul(aa, cc), _neg(_mul(d2c, bt)))  # a c - d2 b
        Vg = _add(_mul(d1t, cc), _neg(_mul(bt, aa)))   # d1 c - b a
        det23c = cold(det23)
        det13r = rowd(sld(det13))
        detG3a = _accumulate([
            _mul(d1t, det23c), _neg(_mul(qaa, d3vv)),
            _scale(_mul(aa, btcc), 2.0), _neg(_mul(Rb2t, d2c))])
        ok3 = detG3a > _TOL_DET
        res123 = jnp.where(ok3, det4 / jnp.where(ok3, detG3a, 1.0),
                           jnp.inf)

        # full-support feasibility: Cramer numerator signs, df-accurate
        D1 = _accumulate([_mul(pt, det23c), _neg(_mul(qc, Zac)),
                          _mul(rv, Wac)])
        D2 = _accumulate([_neg(_mul(pt, Zac)), _mul(qc, det13r),
                          _neg(_mul(rv, Vg))])
        D3 = _accumulate([_mul(pt, Wac), _neg(_mul(qc, Vg)),
                          _mul(rv, _add(_mul(d1t, d2c), _neg(qaa)))])
        full = (D1 >= -_TOL_DET) & (D2 >= -_TOL_DET) & (D3 >= -_TOL_DET)

        af = _val(aa)
        d1tf, ptf = _val(d1t), _val(pt)
        d2cf, qcf = _val(d2c), _val(qc)

        # ---- support {1,2}: bordered 3x3 det, compensated ----
        num12 = _accumulate([
            _mul(d1t, _add(_mul(d2c, wv), _neg(_mul(qc, qc)))),
            _neg(_mul(Rp2t, d2c)),
            _scale(_mul(aa, _mul(pt, qc)), 2.0),
            _neg(_mul(_mul(aa, aa), wv))])
        det12 = _accumulate([_mul(d1t, d2c), _neg(qaa)])
        res12 = num12 / det12
        w1D_12 = _accumulate([_mul(d2c, pt), _neg(_mul(aa, qc))])
        w2D_12 = _accumulate([_mul(d1t, qc), _neg(_mul(aa, pt))])
        res1_t = sl(res1_row)[:, :, None]
        res12, _ = _two_var_cases(res12, w1D_12, w2D_12, ptf, qcf,
                                  res1_t, res2_col[:, None, :],
                                  wf)

        # fallback chain (reference priority: 12, then 13, then 23)
        res13_t = sl(res13_row)[:, :, None]
        fb = res12
        fb = jnp.where(jnp.broadcast_to(res13_t, fb.shape) < fb,
                       jnp.broadcast_to(res13_t, fb.shape), fb)
        r23c = jnp.broadcast_to(res23_col[:, None, :], fb.shape)
        fb = jnp.where(r23c < fb, r23c, fb)

        res = jnp.where(full, _sanit(res123), fb)
        i1 = jnp.int32(st) + lax.broadcasted_iota(jnp.int32, (tile, N2),
                                                  0)
        res = jnp.where((i1 < N1)[None], res, jnp.inf)
        gflat = jnp.broadcast_to(
            (i1 * N2 + lax.broadcasted_iota(jnp.int32, (tile, N2),
                                            1)).reshape(1, -1),
            (B, tile * N2))
        vals, flats = carry
        tv, tf = mfn._tile_topm(res.reshape(B, -1), gflat, M)
        return mfn._merge_topm(vals, flats, tv, tf, M), None

    init = (jnp.full((B, M), jnp.inf, jnp.float32),
            jnp.zeros((B, M), jnp.int32))
    (vals, flats), _ = lax.scan(body, init, jnp.arange(n_tiles))
    cand = jnp.stack([flats // N2, flats % N2], axis=2).astype(jnp.int32)
    return cand, vals, yn * yn


@partial(jax.jit, static_argnames=("M", "tile"))
def df2_candidates(A1, A2, y, M=8, tile=256):
    """Top-M candidates for [N1, N2] with double-float selection.

    Same machinery as df3_candidates restricted to supports {1}, {2},
    {1,2} and the empty support (reference mf_utils.py:329-380 case
    analysis). Returns (cand (B, M, 2) int32, res (B, M), y_sq (B,))."""
    B, S, N1 = A1.shape
    N2 = A2.shape[2]
    A1p, _ = mfn._pad_cols(A1, tile)
    A1h, _an1 = mfn._normalize_block(A1p)
    A2h, _an2 = mfn._normalize_block(A2)
    yh, yn, _ys = mfn._normalize_y(y)
    tile = min(tile, A1h.shape[2])
    N1p = A1h.shape[2]
    n_tiles = N1p // tile

    qA1 = quantize2(A1h)
    qA2 = quantize2(A2h)
    qy = quantize2(yh)
    vec = "bsn,bs->bn"
    diag = "bsn,bsn->bn"
    d1 = df_gram(qA1, qA1, diag)
    d2 = df_gram(qA2, qA2, diag)
    p_ = df_gram(qA1, qy, vec)
    q_ = df_gram(qA2, qy, vec)
    w_ = df_gram(qy, qy, "bs,bs->b")
    w_ = (w_[0][:, None], w_[1][:, None])

    Rp2 = _mul(p_, p_)
    res1_row = _val(_add(_mul(d1, w_), _neg(Rp2))) / _val(d1)
    Cq2 = _mul(q_, q_)
    res2_col = _val(_add(_mul(d2, w_), _neg(Cq2))) / _val(d2)
    d2w_q2 = _add(_mul(d2, w_), _neg(Cq2))
    wf = _val(w_)[:, :, None]

    def rowd(x):
        return (x[0][:, :, None], x[1][:, :, None])

    def cold(x):
        return (x[0][:, None, :], x[1][:, None, :])

    def body(carry, t):
        st = t * tile
        sl = lambda v: lax.dynamic_slice(v, (0, st), (B, tile))
        sld = lambda v: (sl(v[0]), sl(v[1]))
        qa1_t = tuple(lax.dynamic_slice(x, (0, 0, st), (B, S, tile))
                      for x in qA1)
        aa = df_gram_tile(qa1_t, qA2, N2)
        d1t, pt = rowd(sld(d1)), rowd(sld(p_))
        Rp2t = rowd(sld(Rp2))
        d2c, qc = cold(d2), cold(q_)
        wv = (w_[0][:, :, None], w_[1][:, :, None])
        num12 = _accumulate([
            _mul(d1t, _add(_mul(d2c, wv), _neg(_mul(qc, qc)))),
            _neg(_mul(Rp2t, d2c)),
            _scale(_mul(aa, _mul(pt, qc)), 2.0),
            _neg(_mul(_mul(aa, aa), wv))])
        af = _val(aa)
        d1tf, ptf = _val(d1t), _val(pt)
        d2cf, qcf = _val(d2c), _val(qc)
        det12 = d1tf * d2cf - af * af
        res12 = num12 / det12
        w1D = d2cf * ptf - af * qcf
        w2D = d1tf * qcf - af * ptf
        res1_t = sl(res1_row)[:, :, None]
        res, _ = _two_var_cases(res12, w1D, w2D, ptf, qcf,
                                res1_t, res2_col[:, None, :], wf)
        i1 = jnp.int32(st) + lax.broadcasted_iota(
            jnp.int32, (tile, N2), 0)
        res = jnp.where((i1 < N1)[None], res, jnp.inf)
        gflat = jnp.broadcast_to(
            (i1 * N2 + lax.broadcasted_iota(jnp.int32, (tile, N2),
                                            1)).reshape(1, -1),
            (B, tile * N2))
        vals, flats = carry
        tv, tf = mfn._tile_topm(res.reshape(B, -1), gflat, M)
        return mfn._merge_topm(vals, flats, tv, tf, M), None

    init = (jnp.full((B, M), jnp.inf, jnp.float32),
            jnp.zeros((B, M), jnp.int32))
    (vals, flats), _ = lax.scan(body, init, jnp.arange(n_tiles))
    cand = jnp.stack([flats // N2, flats % N2], axis=2).astype(jnp.int32)
    return cand, vals, yn * yn


def _sanit(x):
    return jnp.where(jnp.isnan(x), jnp.inf, x)


# ---------------------------------------------------------------------------
# 4-block configuration (2 fascicles + CSF + EAR), compensated
# ---------------------------------------------------------------------------
#
# Unlike the K<=3 scans (which reproduce the reference Numba kernels'
# fallback-chain semantics), the reference solves the 4-block problem with
# scipy.optimize.nnls per combination (mf_utils.py:612-657), so the device
# scan uses the clean support-enumeration identity: NNLS(res) = min over
# non-empty supports S of the unconstrained LS residual on S restricted to
# all-nonnegative solutions. Residual VALUES are compensated bordered
# determinants over double-float Gram entries; feasibility BOOLEANS (the
# unconstrained weights' signs) are plain f32.

def _dfm(*dfs):
    out = dfs[0]
    for d in dfs[1:]:
        out = _mul(out, d)
    return out


def _sub1_df(d, p, w):
    """Support {a}: res = (d*w - p^2)/d, feasible iff p >= 0."""
    num = _val(_add(_mul(d, w), _neg(_mul(p, p))))
    res = num / _val(d)
    return jnp.where(_val(p) >= 0, res, jnp.inf)


def _sub2_df(dA, dB, g, pA, pB, w):
    """Support {a, b}: bordered 3x3 det / det2, df-accurate determinant
    and weight-sign numerators (near-duplicate atoms cancel det2 and the
    n's to ~1e-6, unresolvable in plain f32; see _TOL_DET)."""
    det2 = _val(_add(_mul(dA, dB), _neg(_mul(g, g))))
    num = _accumulate([
        _dfm(dA, dB, w), _neg(_dfm(g, g, w)),
        _scale(_dfm(g, pA, pB), 2.0),
        _neg(_dfm(dA, pB, pB)), _neg(_dfm(dB, pA, pA))])
    n1 = _accumulate([_mul(dB, pA), _neg(_mul(g, pB))])
    n2 = _accumulate([_mul(dA, pB), _neg(_mul(g, pA))])
    # _TOL-relative guard: consistent with the 4-block interval row
    # pass's three-zone pivot classes and the LDL pivot guards (the
    # df4 family's documented conditioning floor; the K<=3 path is the
    # one that is exact down to _TOL_DET)
    feas = ((det2 > _TOL * _val(dA) * _val(dB))
            & (n1 >= 0) & (n2 >= 0))
    return jnp.where(feas, num / jnp.where(feas, det2, 1.0), jnp.inf)


def _sub3_df(dA, dB, dC, gAB, gAC, gBC, pA, pB, pC, w):
    """Support {a, b, c}: bordered 4x4 det / det3 via the quadratic-in-gAB
    expansion (reusing the df3 coefficient structure), unconstrained-sign
    feasibility in f32."""
    # C0 + C1*gAB + C2*gAB^2 with (row=(dA,gAC,pA), col=(dB,gBC,pB),
    # voxel=(dC,pC,w)) — same polynomial as df3_candidates
    U1 = _add(_mul(pB, pB), _neg(_mul(dB, w)))
    U2 = _scale(_add(_mul(dB, pC), _neg(_mul(gBC, pB))), 2.0)
    U3 = _add(_mul(dB, _add(_mul(dC, w), _neg(_mul(pC, pC)))),
              _neg(_mul(dC, _mul(pB, pB))),
              _scale(_dfm(gBC, pB, pC), 2.0),
              _neg(_mul(_mul(gBC, gBC), w)))
    U4 = _add(_mul(gBC, gBC), _neg(_mul(dB, dC)))
    V1 = _scale(_add(_mul(gBC, w), _neg(_mul(pB, pC))), 2.0)
    V2 = _scale(_add(_mul(dC, pB), _neg(_mul(gBC, pC))), 2.0)
    C2 = _add(_mul(pC, pC), _neg(_mul(dC, w)))
    det4 = _accumulate([
        _dfm(gAC, gAC, U1), _dfm(gAC, pA, U2), _mul(dA, U3),
        _dfm(pA, pA, U4),
        _mul(gAB, _add(_mul(gAC, V1), _mul(pA, V2))),
        _mul(_mul(gAB, gAB), C2)])
    det3, D1, D2, D3 = _det3_cramer_df(gAB, dA, dB, dC, gAC, gBC,
                                       pA, pB, pC)
    feas = ((det3 > _TOL * _val(dA) * _val(dB) * _val(dC))
            & (D1 >= 0) & (D2 >= 0) & (D3 >= 0))
    return jnp.where(feas, det4 / jnp.where(feas, det3, 1.0), jnp.inf)


def _det3_cramer_df(gAB, dA, dB, dC, gAC, gBC, pA, pB, pC):
    """3x3 Gram determinant + the three Cramer numerators, df-accurate.

    The O(1) normalized-Gram products cancel to ~1e-6 for highly
    correlated atom pairs (the realistic MC-dictionary regime); plain f32
    evaluation is then pure noise, which used to reject genuinely optimal
    supports the reference resolves in float64 (mf_utils.py:554-573).
    All inputs are df tuples; returns collapsed f32 values whose RELATIVE
    error is ~eps_f32 even under full cancellation (compensated sums).
    """
    X = _add(_mul(dB, dC), _neg(_mul(gBC, gBC)))    # dB dC - gBC^2
    Z = _add(_mul(gAB, dC), _neg(_mul(gBC, gAC)))   # a dC - gBC gAC
    W = _add(_mul(gAB, gBC), _neg(_mul(dB, gAC)))   # a gBC - dB gAC
    Y = _add(_mul(dA, dC), _neg(_mul(gAC, gAC)))    # dA dC - gAC^2
    V = _add(_mul(dA, gBC), _neg(_mul(gAC, gAB)))   # dA gBC - gAC a
    T = _add(_mul(dA, dB), _neg(_mul(gAB, gAB)))    # dA dB - a^2
    det3 = _accumulate([_mul(dA, X), _neg(_mul(gAB, Z)), _mul(gAC, W)])
    D1 = _accumulate([_mul(pA, X), _neg(_mul(pB, Z)), _mul(pC, W)])
    D2 = _accumulate([_neg(_mul(pA, Z)), _mul(pB, Y), _neg(_mul(pC, V))])
    D3 = _accumulate([_mul(pA, W), _neg(_mul(pB, V)), _mul(pC, T)])
    return det3, D1, D2, D3


def _df_div(x, y):
    """Double-float division (one Newton correction)."""
    q0 = x[0] / y[0]
    # r = x - q0*y, evaluated exactly-ish
    p, e = df32.two_prod(q0, y[0])
    r_hi = (x[0] - p) - e + x[1] - q0 * y[1]
    q1 = r_hi / y[0]
    return df32.fast_two_sum(q0, q1)


@partial(jax.jit, static_argnames=("M", "tile"))
def df4_candidates(A1, A2, a3, a4, y, M=8, tile=256):
    """Top-M candidates for [N1, N2, N3, N4] (2 fascicles + CSF + EAR)
    with double-float selection.

    The small trailing blocks (N3 * N4 sweeps, typically 1 x 10) are
    handled per sweep: the {1,2,3,4} support is evaluated by a guarded LDL'
    elimination in the order (csf, ear, fasc1, fasc2) with all row/column
    factors hoisted (stable for the near-collinear (csf, ear) pairs of real
    dictionaries), the {1,2,4} support by the quadratic-in-g12 bordered
    determinant; supports not containing both grid variables are hoisted.
    Tiles and sweeps run as lax.scan loops. Candidate rank follows
    itertools.product order
    ((i1, i2, i3, i4) lexicographic, reference mf_utils.py:637).
    Returns (cand (B, M, 4) int32, res (B, M) normalized residuals,
    y_sq (B,) raw)."""
    B, S, N1 = A1.shape
    N2, N3, N4 = A2.shape[2], a3.shape[2], a4.shape[2]
    NS = N3 * N4
    A1p, _ = mfn._pad_cols(A1, tile)
    A1h, _ = mfn._normalize_block(A1p)
    A2h, _ = mfn._normalize_block(A2)
    A3h, _ = mfn._normalize_block(a3)
    A4h, _ = mfn._normalize_block(a4)
    yh, yn, _ys = mfn._normalize_y(y)
    tile = min(tile, A1h.shape[2])
    N1p = A1h.shape[2]
    n_tiles = N1p // tile

    qA1 = quantize2(A1h)
    qA2 = quantize2(A2h)
    qA3 = quantize2(A3h)
    qA4 = quantize2(A4h)
    qy = quantize2(yh)

    diag = "bsn,bsn->bn"
    vec = "bsn,bs->bn"
    cross = "bsn,bsm->bnm"
    d1 = df_gram(qA1, qA1, diag)                  # (B, N1p)
    d2 = df_gram(qA2, qA2, diag)
    d3 = df_gram(qA3, qA3, diag)                  # (B, N3)
    d4 = df_gram(qA4, qA4, diag)                  # (B, N4)
    p_ = df_gram(qA1, qy, vec)
    q_ = df_gram(qA2, qy, vec)
    r3 = df_gram(qA3, qy, vec)                    # (B, N3)
    r4 = df_gram(qA4, qy, vec)                    # (B, N4)
    b3 = df_gram(qA1, qA3, cross)                 # (B, N1p, N3)
    b4 = df_gram(qA1, qA4, cross)                 # (B, N1p, N4)
    c3 = df_gram(qA2, qA3, cross)                 # (B, N2, N3)
    c4 = df_gram(qA2, qA4, cross)                 # (B, N2, N4)
    g34 = df_gram(qA3, qA4, cross)                # (B, N3, N4)
    w_ = df_gram(qy, qy, "bs,bs->b")
    w_ = (w_[0][:, None], w_[1][:, None])

    # ---- LDL' elimination hoists for the 4-support, axes (B,.,N3,N4) ----
    # The {1,2,3,4} residual is evaluated by symmetric LDL' elimination in
    # the order (csf, ear, fasc1, fasc2): every division is by a pivot
    # guarded relative to ITS OWN diagonal, so the ubiquitous near-collinear
    # (csf, ear) pairs of real dictionaries never amplify the double-float
    # error. (A Schur reduction by det(G_{34}) — dividing O(1) quantities by
    # a near-vanishing block determinant — was measured to corrupt support
    # residuals to ~1e-6 * ||y||^2 on fingerprint-like columns.) A pivot
    # below its guard marks the support infeasible; collinearity then
    # guarantees a sub-support that IS evaluated approaches the same
    # residual, so the scan's minimum is unaffected beyond ~1e-9.
    ax = lambda x, sh: (x[0].reshape(sh), x[1].reshape(sh))
    d3e = ax(d3, (B, 1, N3, 1))
    d4e = ax(d4, (B, 1, 1, N4))
    r3e = ax(r3, (B, 1, N3, 1))
    r4e = ax(r4, (B, 1, 1, N4))
    ge = ax(g34, (B, 1, N3, N4))
    w4 = ax(w_, (B, 1, 1, 1))

    one_df = lambda x: (jnp.ones_like(x[0]), jnp.zeros_like(x[0]))
    df_where = lambda c, x, y: (jnp.where(c, x[0], y[0]),
                                jnp.where(c, x[1], y[1]))
    safe_recip = lambda x, ok: _df_div(
        one_df(x), df_where(ok, x, one_df(x)))

    invd3 = _df_div(one_df(d3e), d3e)                      # (B,1,N3,1)
    L43 = _mul(ge, invd3)                                  # (B,1,N3,N4)
    D4h = _add(d4e, _neg(_mul(ge, L43)))                   # ear pivot
    ok34 = _val(D4h) > _TOL * _val(d4e)                    # (B,1,N3,N4)
    invD4h = safe_recip(D4h, ok34)
    t4 = _add(r4e, _neg(_mul(L43, r3e)))                   # (B,1,N3,N4)
    rho34 = _add(w4, _neg(_mul(_mul(r3e, r3e), invd3)),
                 _neg(_mul(_mul(t4, t4), invD4h)))         # y after (3,4)

    d1e = ax(d1, (B, N1p, 1, 1))
    p1e = ax(p_, (B, N1p, 1, 1))
    b3e = ax(b3, (B, N1p, N3, 1))
    b4e = (b4[0][:, :, None, :], b4[1][:, :, None, :])
    d2e = ax(d2, (B, N2, 1, 1))
    q2e = ax(q_, (B, N2, 1, 1))
    c3e = ax(c3, (B, N2, N3, 1))
    c4e = (c4[0][:, :, None, :], c4[1][:, :, None, :])

    # fasc1 (row) elimination pieces, (B, N1p, N3, N4)
    L13 = _mul(b3e, invd3)
    e4r = _add(b4e, _neg(_mul(L43, b3e)))
    L14 = _mul(e4r, invD4h)
    D1h = _add(d1e, _neg(_mul(b3e, L13)), _neg(_mul(e4r, L14)))
    rowok = _val(D1h) > _TOL * _val(d1e)
    invD1h = safe_recip(D1h, rowok)
    pi1 = _add(p1e, _neg(_mul(L13, r3e)), _neg(_mul(L14, t4)))
    kap1 = _mul(pi1, invD1h)
    rho1 = _add(rho34, _neg(_mul(pi1, kap1)))

    # fasc2 (column) elimination pieces, (B, N2, N3, N4)
    L23 = _mul(c3e, invd3)
    e4c = _add(c4e, _neg(_mul(L43, c3e)))
    L24 = _mul(e4c, invD4h)
    d2r = _add(d2e, _neg(_mul(c3e, L23)), _neg(_mul(e4c, L24)))
    q2r = _add(q2e, _neg(_mul(L23, r3e)), _neg(_mul(L24, t4)))

    # f32 pieces for the feasibility back-substitution
    bc = lambda x, inner: jnp.broadcast_to(x, (B, inner, N3, N4))
    bc_df = lambda x, inner: (bc(x[0], inner), bc(x[1], inner))
    u3f = bc(_val(_mul(r3e, invd3)), 1)                    # (B,1,N3,N4)
    u4f = _val(_mul(t4, invD4h))
    L43f = _val(L43)
    L13f = bc(_val(L13), N1p)                              # (B,N1p,N3,N4)
    L14f = _val(L14)
    b3x = bc_df(b3e, N1p)                                  # (B,N1p,N3,N4)

    # hoisted supports not containing both grid variables
    r_fix = jnp.minimum(_sub1_df(d3e, r3e, w4), _sub1_df(d4e, r4e, w4))
    r_fix = jnp.minimum(r_fix, _sub2_df(d3e, d4e, ge, r3e, r4e, w4))
    r_row = jnp.minimum(_sub2_df(d1e, d3e, b3e, p1e, r3e, w4),
                        _sub2_df(d1e, d4e, b4e, p1e, r4e, w4))
    r_row = jnp.minimum(r_row, _sub3_df(
        d1e, d3e, d4e, b3e, b4e, ge, p1e, r3e, r4e, w4))
    r_col = jnp.minimum(_sub2_df(d2e, d3e, c3e, q2e, r3e, w4),
                        _sub2_df(d2e, d4e, c4e, q2e, r4e, w4))
    r_col = jnp.minimum(r_col, _sub3_df(
        d2e, d3e, d4e, c3e, c4e, ge, q2e, r3e, r4e, w4))
    res1_row = _sub1_df(d1, p_, w_)                        # (B, N1p)
    res2_col = _sub1_df(d2, q_, w_)                        # (B, N2)

    # stack per-sweep data with a leading NS axis for the in-body scan
    def sweep_first(x, inner):
        # (B, inner, N3, N4) -> (NS, B, inner)
        return jnp.moveaxis(x.reshape(B, inner, NS), 2, 0)

    def sweep_df(x, inner):
        return (sweep_first(x[0], inner), sweep_first(x[1], inner))

    xs_sweep = dict(
        # LDL' pieces for the {1,2,3,4} support
        b3sw=sweep_df(b3x, N1p), e4r=sweep_df(e4r, N1p),
        kap1=sweep_df(kap1, N1p), invD1h=sweep_df(invD1h, N1p),
        rho1=sweep_df(rho1, N1p),
        rowok=sweep_first(rowok, N1p), L13f=sweep_first(L13f, N1p),
        L14f=sweep_first(L14f, N1p),
        L23=sweep_df(bc_df(L23, N2), N2), L24=sweep_df(L24, N2),
        d2r=sweep_df(d2r, N2), q2r=sweep_df(q2r, N2),
        ok34=sweep_first(ok34, 1), u3f=sweep_first(u3f, 1),
        u4f=sweep_first(u4f, 1), L43f=sweep_first(L43f, 1),
        # hoisted fixed/row/col sub-support minima
        r_row=sweep_first(r_row, N1p), r_col=sweep_first(r_col, N2),
        r_fix=sweep_first(r_fix, 1),
        # {1,2,4} support operands
        d4s=sweep_df(bc_df(d4e, 1), 1),
        r4s=sweep_df(bc_df(r4e, 1), 1),
        b4s=sweep_df(bc_df(b4e, N1p), N1p),
        c4s=sweep_df(bc_df(c4e, N2), N2),
        s_idx=jnp.arange(NS, dtype=jnp.int32),
    )

    def rowd(x, sl):
        return (sl(x[0])[:, :, None], sl(x[1])[:, :, None])

    def cold(x):
        return (x[0][:, None, :], x[1][:, None, :])

    def body(carry, t):
        st = t * tile
        sl = lambda v: lax.dynamic_slice(v, (0, st), (B, tile))
        qa1_t = tuple(lax.dynamic_slice(x, (0, 0, st), (B, S, tile))
                      for x in qA1)
        aa = df_gram_tile(qa1_t, qA2, N2)          # g12 (B, tile, N2) df

        d1t, pt = rowd(d1, sl), rowd(p_, sl)
        d2c, qc = cold(d2), cold(q_)
        wv = (w_[0][:, :, None], w_[1][:, :, None])

        # sweep-independent supports
        r12 = _sub2_point(aa, d1t, d2c, pt, qc, wv)
        base = jnp.minimum(r12, sl(res1_row)[:, :, None])
        base = jnp.minimum(base, res2_col[:, None, :])
        base = jnp.minimum(base, _val(wv))
        # {1,2,3} per i3 (N3 is tiny and static; almost always 1)
        r123_all = []
        for i3 in range(N3):
            ev3 = lambda x: (x[0][:, i3][:, None, None],
                             x[1][:, i3][:, None, None])
            b3t = rowd((b3[0][:, :, i3], b3[1][:, :, i3]), sl)
            c3c = cold((c3[0][:, :, i3], c3[1][:, :, i3]))
            r123_all.append(_sanit(_sub3_point(
                aa, d1t, d2c, ev3(d3), b3t, c3c, pt, qc, ev3(r3), wv)))
        r123_st = jnp.stack(r123_all, axis=0)      # (N3, B, tile, N2)

        best = jnp.full((B, tile, N2), jnp.inf, jnp.float32)
        best_s = jnp.zeros((B, tile, N2), jnp.int32)

        def sweep_eval(carry_s, sw):
            best, best_s = carry_s
            tsl = lambda x: (sl(x[0])[:, :, None], sl(x[1])[:, :, None])
            csl = lambda x: (x[0][:, None, :], x[1][:, None, :])
            esl = lambda x: (x[0][:, :, None], x[1][:, :, None])
            # support {1,2,4}
            r124 = _sub3_point(aa, d1t, d2c, esl(sw["d4s"]),
                               tsl(sw["b4s"]), csl(sw["c4s"]),
                               pt, qc, esl(sw["r4s"]), wv)

            i3 = sw["s_idx"] // N4
            # support {1,2,3,4}: finish the hoisted LDL' elimination at the
            # (i1, i2) grid point — NUM is the reduced g12 cross term, D2h
            # the final (fasc2) pivot, pi2 the reduced correlation
            b3s, e4rs = tsl(sw["b3sw"]), tsl(sw["e4r"])
            kap1s = tsl(sw["kap1"])
            invD1s = tsl(sw["invD1h"])
            rho1s = tsl(sw["rho1"])
            L23s, L24s = csl(sw["L23"]), csl(sw["L24"])
            NUM = _add(aa, _neg(_mul(b3s, L23s)), _neg(_mul(e4rs, L24s)))
            D2h = _add(csl(sw["d2r"]), _neg(_mul(_mul(NUM, NUM), invD1s)))
            pi2 = _add(csl(sw["q2r"]), _neg(_mul(NUM, kap1s)))
            pointok = _val(D2h) > _TOL * _val(d2c)
            D2h_safe = (jnp.where(pointok, D2h[0], 1.0),
                        jnp.where(pointok, D2h[1], 0.0))
            res1234 = _val(_add(
                rho1s, _neg(_df_div(_mul(pi2, pi2), D2h_safe))))
            # feasibility: back-substitute the four weights in f32
            pi2f = _val(pi2)
            w_b2 = pi2f / _val(D2h_safe)
            L21f = _val(NUM) * _val(invD1s)
            w_b1 = _val(kap1s) - L21f * w_b2
            L14fs = sl(sw["L14f"])[:, :, None]
            L24f = _val(L24s)
            w_e4 = sw["u4f"][:, :, None] - L14fs * w_b1 - L24f * w_b2
            L13fs = sl(sw["L13f"])[:, :, None]
            L23f = _val(L23s)
            w_e3 = (sw["u3f"][:, :, None] - sw["L43f"][:, :, None] * w_e4
                    - L13fs * w_b1 - L23f * w_b2)
            feas = (sw["ok34"][:, :, None] & sl(sw["rowok"])[:, :, None]
                    & pointok & (pi2f >= 0) & (w_b1 >= 0)
                    & (w_e4 >= 0) & (w_e3 >= 0))
            r1234 = jnp.where(feas, res1234, jnp.inf)

            res_s = jnp.minimum(base, jnp.take(r123_st, i3, axis=0))
            res_s = jnp.minimum(res_s, _sanit(r124))
            res_s = jnp.minimum(res_s, _sanit(r1234))
            res_s = jnp.minimum(res_s, sl(sw["r_row"])[:, :, None])
            res_s = jnp.minimum(res_s, sw["r_col"][:, None, :])
            res_s = jnp.minimum(res_s, sw["r_fix"][:, :, None])
            res_s = _sanit(res_s)
            upd = res_s < best
            return (jnp.where(upd, res_s, best),
                    jnp.where(upd, sw["s_idx"], best_s))

        def sweep_scan(carry_s, sw):
            return sweep_eval(carry_s, sw), None
        (best, best_s), _ = lax.scan(sweep_scan, (best, best_s), xs_sweep)

        i1 = (jnp.int32(st)
              + lax.broadcasted_iota(jnp.int32, (tile, N2), 0))
        i2 = lax.broadcasted_iota(jnp.int32, (tile, N2), 1)
        best = jnp.where((i1 < N1)[None], best, jnp.inf)
        flat = ((i1 * N2 + i2)[None] * NS + best_s).astype(jnp.int32)
        vals, flats = carry
        tv, tf = mfn._tile_topm(best.reshape(B, -1),
                                flat.reshape(B, -1), M)
        return mfn._merge_topm(vals, flats, tv, tf, M)

    init = (jnp.full((B, M), jnp.inf, jnp.float32),
            jnp.zeros((B, M), jnp.int32))
    (vals, flats), _ = lax.scan(
        lambda c, t: (body(c, t), None), init, jnp.arange(n_tiles))
    s = flats % NS
    pt_ = flats // NS
    cand = jnp.stack([pt_ // N2, pt_ % N2, s // N4, s % N4],
                     axis=2).astype(jnp.int32)
    return cand, vals, yn * yn


def _sub2_point(aa, d1t, d2c, pt, qc, wv):
    """Per-point support {1,2}: compensated bordered 3x3 / det2 with
    unconstrained-sign feasibility."""
    num = _accumulate([
        _dfm(d1t, d2c, wv), _neg(_dfm(aa, aa, wv)),
        _scale(_dfm(aa, pt, qc), 2.0),
        _neg(_dfm(d1t, qc, qc)), _neg(_dfm(d2c, pt, pt))])
    # determinant and weight-sign numerators df-accurate (see _TOL_DET)
    det2 = _accumulate([_mul(d1t, d2c), _neg(_mul(aa, aa))])
    n1 = _accumulate([_mul(d2c, pt), _neg(_mul(aa, qc))])
    n2 = _accumulate([_mul(d1t, qc), _neg(_mul(aa, pt))])
    feas = ((det2 > _TOL * _val(d1t) * _val(d2c))
            & (n1 >= 0) & (n2 >= 0))
    return jnp.where(feas, num / jnp.where(feas, det2, 1.0), jnp.inf)


def _sub3_point(aa, d1t, d2c, dCe, bt, cc, pt, qc, rCe, wv):
    """Per-point support {1,2,C}: the quadratic-in-g12 compensated
    bordered 4x4 / det3 (C the fixed third column of this sweep)."""
    U1 = _add(_mul(qc, qc), _neg(_mul(d2c, wv)))
    U2 = _scale(_add(_mul(d2c, rCe), _neg(_mul(cc, qc))), 2.0)
    U3 = _add(_mul(d2c, _add(_mul(dCe, wv), _neg(_mul(rCe, rCe)))),
              _neg(_mul(dCe, _mul(qc, qc))),
              _scale(_dfm(cc, qc, rCe), 2.0),
              _neg(_mul(_mul(cc, cc), wv)))
    U4 = _add(_mul(cc, cc), _neg(_mul(d2c, dCe)))
    V1 = _scale(_add(_mul(cc, wv), _neg(_mul(qc, rCe))), 2.0)
    V2 = _scale(_add(_mul(dCe, qc), _neg(_mul(cc, rCe))), 2.0)
    C2 = _add(_mul(rCe, rCe), _neg(_mul(dCe, wv)))
    det4 = _accumulate([
        _dfm(bt, bt, U1), _dfm(bt, pt, U2), _mul(d1t, U3),
        _dfm(pt, pt, U4),
        _mul(aa, _add(_mul(bt, V1), _mul(pt, V2))),
        _mul(_mul(aa, aa), C2)])
    det3, D1, D2, D3 = _det3_cramer_df(aa, d1t, d2c, dCe, bt, cc,
                                       pt, qc, rCe)
    feas = ((det3 > _TOL * _val(d1t) * _val(d2c) * _val(dCe))
            & (D1 >= 0) & (D2 >= 0) & (D3 >= 0))
    return jnp.where(feas, det4 / jnp.where(feas, det3, 1.0), jnp.inf)


def _two_var_cases(res_full, w1D, w2D, Y1, Y2, res1, res2, y_sq):
    """Reference 2-variable NNLS case selection with externally-supplied
    (compensated) residual VALUES (decision booleans in f32; cf.
    ops/nnls.lsqnonneg_2var). All args broadcastable."""
    case1 = (w1D > 0) & (w2D > 0)
    case2 = ~case1 & (w1D >= 0) & (w2D <= 0)
    case3 = ~case1 & ~case2 & (w1D <= 0) & (w2D >= 0)
    case4 = ~case1 & ~case2 & ~case3 & (w1D < 0) & (w2D < 0)
    take1 = (case2 & (Y1 >= 0)) | (case4 & (Y1 > 0))
    take2 = (case3 & (Y2 >= 0)) | (case4 & (Y1 <= 0) & (Y2 > 0))
    res = jnp.where(case1, _sanit(res_full),
                    jnp.where(take1, res1,
                              jnp.where(take2, res2, y_sq)))
    return res, case1


# ---------------------------------------------------------------------------
# Exact small NNLS over gathered columns (the device finalize step)
# ---------------------------------------------------------------------------
#
# MFModel.fit's fast path selects each voxel's winning atom combination with
# the double-float scans above; what remains is the winner's weights and
# quality metrics. These helpers re-solve the C<=4-column NNLS exactly on
# device (double-float Grams via quantize2, closed-form solves with
# double-float values and f32 decision booleans), replacing the float64
# host re-solve of models/refine.py (reference mf.py:430-450) without a
# host round-trip. Decision semantics mirror ops/nnls.lsqnonneg_{2,3,4}var.
# Support-enumeration robustness: residuals are evaluated with the full
# quadratic form y'y - 2w'Y + w'Gw, which can only OVERestimate the true
# NNLS objective at inexact weights — an ill-conditioned support can lose
# a tie it should win only by ~(df error * condition), never win one.


def _df_det2(dA, dB, g):
    return _add(_mul(dA, dB), _neg(_mul(g, g)))


def _df_det3(m):
    """df determinant of a 3x3 nested df tuple list."""
    t1 = _mul(m[0][0], _add(_mul(m[1][1], m[2][2]),
                            _neg(_mul(m[1][2], m[2][1]))))
    t2 = _mul(m[0][1], _add(_mul(m[1][0], m[2][2]),
                            _neg(_mul(m[1][2], m[2][0]))))
    t3 = _mul(m[0][2], _add(_mul(m[1][0], m[2][1]),
                            _neg(_mul(m[1][1], m[2][0]))))
    return _add(t1, _neg(t2), t3)


def _df_det4(m):
    """df determinant of a 4x4 nested df tuple list (cofactor row 0)."""
    out = None
    for c in range(4):
        minor = [[m[r][cc] for cc in range(4) if cc != c]
                 for r in range(1, 4)]
        term = _mul(m[0][c], _df_det3(minor))
        if c % 2 == 1:
            term = _neg(term)
        out = term if out is None else _add(out, term)
    return out


def _df_cramer(G_S, Y_S):
    """df Cramer solve of a k x k symmetric system (k <= 4).

    G_S: nested tuple of df scalars; Y_S: tuple of df. Returns (w list of
    df, det df). Division is unguarded like the reference
    (ops/nnls._solve_posdef_cramer) — callers reject non-finite weights.
    """
    k = len(Y_S)
    if k == 1:
        return [_df_div(Y_S[0], G_S[0][0])], G_S[0][0]
    if k == 2:
        det = _df_det2(G_S[0][0], G_S[1][1], G_S[0][1])
        n1 = _add(_mul(Y_S[0], G_S[1][1]), _neg(_mul(G_S[0][1], Y_S[1])))
        n2 = _add(_mul(G_S[0][0], Y_S[1]), _neg(_mul(Y_S[0], G_S[0][1])))
        return [_df_div(n1, det), _df_div(n2, det)], det
    detf = _df_det3 if k == 3 else _df_det4
    det = detf(G_S)
    ws = []
    for j in range(k):
        mj = [[(Y_S[r] if c == j else G_S[r][c]) for c in range(k)]
              for r in range(k)]
        ws.append(_df_div(detf(mj), det))
    return ws, det


def _df_quadres(w_y, G_S, Y_S, w_S):
    """Full quadratic-form residual y'y - 2 w'Y + w'G w in df (returns df).

    Evaluated at any w this upper-bounds the support's true LS residual, so
    inexact weights can never make a support spuriously win."""
    terms = [w_y]
    k = len(Y_S)
    for a in range(k):
        terms.append(_scale(_mul(w_S[a], Y_S[a]), -2.0))
        terms.append(_mul(_mul(w_S[a], w_S[a]), G_S[a][a]))
        for b in range(a + 1, k):
            terms.append(_scale(_mul(_mul(w_S[a], w_S[b]), G_S[a][b]), 2.0))
    out = terms[0]
    for t in terms[1:]:
        out = _add(out, t)
    return out


def _df_nnls2(w_y, dA, dB, g, pA, pB):
    """df mirror of ops/nnls.lsqnonneg_2var: same case priority, df values.
    Returns (w1 df, w2 df, res df)."""
    zero = (jnp.zeros_like(w_y[0]), jnp.zeros_like(w_y[1]))
    w1D = _add(_mul(dB, pA), _neg(_mul(g, pB)))
    w2D = _add(_mul(dA, pB), _neg(_mul(g, pA)))
    det = _df_det2(dA, dB, g)
    w1f = _df_div(w1D, det)
    w2f = _df_div(w2D, det)
    res_f = _df_quadres(w_y, ((dA, g), (g, dB)), (pA, pB), (w1f, w2f))
    w1o = _df_div(pA, dA)
    res1 = _df_quadres(w_y, ((dA,),), (pA,), (w1o,))
    w2o = _df_div(pB, dB)
    res2 = _df_quadres(w_y, ((dB,),), (pB,), (w2o,))

    c1 = (_val(w1D) > 0) & (_val(w2D) > 0)
    c2 = ~c1 & (_val(w1D) >= 0) & (_val(w2D) <= 0)
    c3 = ~c1 & ~c2 & (_val(w1D) <= 0) & (_val(w2D) >= 0)
    c4 = ~c1 & ~c2 & ~c3 & (_val(w1D) < 0) & (_val(w2D) < 0)
    t1 = (c2 & (_val(pA) >= 0)) | (c4 & (_val(pA) > 0))
    t2 = (c3 & (_val(pB) >= 0)) | (c4 & (_val(pA) <= 0) & (_val(pB) > 0))

    dfw = lambda c, x, y: (jnp.where(c, x[0], y[0]),
                           jnp.where(c, x[1], y[1]))
    nan2inf = lambda x: (jnp.where(jnp.isnan(x[0]), jnp.inf, x[0]),
                         jnp.where(jnp.isnan(x[0]), 0.0, x[1]))
    w1 = dfw(c1, w1f, dfw(t1, w1o, zero))
    w2 = dfw(c1, w2f, dfw(t2, w2o, zero))
    res = dfw(c1, nan2inf(res_f), dfw(t1, res1, dfw(t2, res2, w_y)))
    return w1, w2, res


def _df_where_list(c, xs, ys):
    return [(jnp.where(c, x[0], y[0]), jnp.where(c, x[1], y[1]))
            for x, y in zip(xs, ys)]


def _df_lt(a, b):
    """Lexicographic a < b on df pairs: an f32 sum hi + lo rounds the
    compensation term away (lo < 0.5 ulp(hi)), collapsing near-ties to
    f32-ulp resolution; comparing (hi, then lo) keeps the full double-float
    resolution, matching the strict float64 '<' of the mirrored host
    enumerations (models/refine, ops/nnls.lsqnonneg_4var)."""
    return (a[0] < b[0]) | ((a[0] == b[0]) & (a[1] < b[1]))


def _df_nnls3(w_y, G, p):
    """df mirror of ops/nnls.lsqnonneg_3var (Cramer sign test + 2-subset
    fallback chain with first-strictly-better priority).
    G: 3x3 nested df, p: list of 3 df. Returns (w list of 3 df, res df)."""
    zero = (jnp.zeros_like(w_y[0]), jnp.zeros_like(w_y[1]))
    det = _df_det3(G)
    # Cramer numerators (values df-accurate, decisions f32)
    nums = []
    for j in range(3):
        mj = [[(p[r] if c == j else G[r][c]) for c in range(3)]
              for r in range(3)]
        nums.append(_df_det3(mj))
    D1, D2, D3 = nums
    w1f = _df_div(D1, det)
    w2f = _df_div(D2, det)
    w3f = _df_div(D3, det)
    tol3 = mfn._TOL3
    full = ((_val(D1) >= -tol3) & (_val(D2) >= -tol3)
            & (_val(D3) >= -tol3))
    res_f = _df_quadres(w_y, G, p, (w1f, w2f, w3f))
    res_f = (jnp.where(jnp.isnan(res_f[0]), jnp.inf, res_f[0]),
             jnp.where(jnp.isnan(res_f[0]), 0.0, res_f[1]))

    a12, b12, r12 = _df_nnls2(w_y, G[0][0], G[1][1], G[0][1], p[0], p[1])
    a13, b13, r13 = _df_nnls2(w_y, G[0][0], G[2][2], G[0][2], p[0], p[2])
    a23, b23, r23 = _df_nnls2(w_y, G[1][1], G[2][2], G[1][2], p[1], p[2])

    fb_w, fb_r = [a12, b12, zero], r12
    take13 = _df_lt(r13, fb_r)
    fb_w = _df_where_list(take13, [a13, zero, b13], fb_w)
    fb_r = (jnp.where(take13, r13[0], fb_r[0]),
            jnp.where(take13, r13[1], fb_r[1]))
    take23 = _df_lt(r23, fb_r)
    fb_w = _df_where_list(take23, [zero, a23, b23], fb_w)
    fb_r = (jnp.where(take23, r23[0], fb_r[0]),
            jnp.where(take23, r23[1], fb_r[1]))

    w = _df_where_list(full, [w1f, w2f, w3f], fb_w)
    res = (jnp.where(full, res_f[0], fb_r[0]),
           jnp.where(full, res_f[1], fb_r[1]))
    return w, res


def _df_nnls4(w_y, G, p):
    """df mirror of ops/nnls.lsqnonneg_4var: exhaustive support enumeration
    (ascending mask order, strict-improvement updates).
    G: 4x4 nested df, p: list of 4 df. Returns (w list of 4 df, res df)."""
    zero = (jnp.zeros_like(w_y[0]), jnp.zeros_like(w_y[1]))
    best_w = [zero, zero, zero, zero]
    best_r = w_y
    for mask in range(1, 16):
        S = [i for i in range(4) if mask >> i & 1]
        G_S = tuple(tuple(G[r][c] for c in S) for r in S)
        Y_S = tuple(p[i] for i in S)
        w_S, _det = _df_cramer(G_S, Y_S)
        feas = jnp.ones_like(w_y[0], dtype=bool)
        for wa in w_S:
            va = _val(wa)
            feas = feas & (va >= 0) & jnp.isfinite(va)
        res = _df_quadres(w_y, G_S, Y_S, w_S)
        rv = jnp.where(feas & ~jnp.isnan(res[0]), res[0], jnp.inf)
        res = (rv, jnp.where(jnp.isfinite(rv), res[1], 0.0))
        better = _df_lt(res, best_r)
        new_w = [zero] * 4
        for wi, i in zip(w_S, S):
            new_w[i] = wi
        best_w = _df_where_list(better, new_w, best_w)
        best_r = (jnp.where(better, res[0], best_r[0]),
                  jnp.where(better, res[1], best_r[1]))
    return best_w, best_r


def df_nnls_cols(cols, y):
    """Exact small NNLS across gathered columns, on device.

    cols (B, S, C) f32 raw-scale columns (C <= 4); y (B, S) raw.
    Returns (w (B, C) f32 raw-scale weights, (res_hi, res_lo)) with the raw
    residual as a double-float pair res_hi + res_lo (B,) each.
    Columns and signal are scaled by per-column powers of two (exact in
    f32), Grams are computed exactly (quantize2 + df_gram), and the
    closed-form solvers run with double-float values — selections and
    values match the float64 host solvers (ops/nnls.lsqnonneg_*, xp=numpy)
    to ~1e-11 relative.
    """
    B, S, C = cols.shape
    assert 1 <= C <= 4
    if cols.dtype == jnp.float64:
        # x64 runtime (CPU tests / reference-parity mode): plain float64
        # Grams + the float64 closed-form solvers ARE exact — no emulation
        return _nnls_cols_f64(cols, y)
    cols = cols.astype(jnp.float32)
    y = y.astype(jnp.float32)
    # scale into (0.25, 0.5]: entries near 1 would saturate quantize2's
    # int8 levels, and the larger remainder costs the Gram ~1e-9 accuracy
    pow2 = lambda m: 2 * jnp.exp2(jnp.ceil(jnp.log2(jnp.maximum(m,
                                                                 1e-30))))
    sc = pow2(jnp.max(jnp.abs(cols), axis=1))               # (B, C)
    sy = pow2(jnp.max(jnp.abs(y), axis=1))                  # (B,)
    cs = cols / sc[:, None, :]
    ys = y / sy[:, None]
    # ONE packed df Gram of [cols | y] yields G, A'y and y'y together
    # (each df_gram costs 5 einsums; packing cuts 15 to 5 — the tiny
    # per-voxel contractions here are launch-bound, not flop-bound)
    z = jnp.concatenate([cs, ys[:, :, None]], axis=2)       # (B, S, C+1)
    qz = quantize2(z)
    Mh, Ml = df_gram(qz, qz, "bsi,bsj->bij")
    G = [[(Mh[:, i, j], Ml[:, i, j]) for j in range(C)] for i in range(C)]
    p = [(Mh[:, i, C], Ml[:, i, C]) for i in range(C)]
    w_y = (Mh[:, C, C], Ml[:, C, C])

    if C == 1:
        w0 = _df_div(p[0], G[0][0])
        pos = _val(p[0]) >= 0
        res = _df_quadres(w_y, ((G[0][0],),), (p[0],), (w0,))
        w_list = [(jnp.where(pos, w0[0], 0.0), jnp.where(pos, w0[1], 0.0))]
        res = (jnp.where(pos, res[0], w_y[0]),
               jnp.where(pos, res[1], w_y[1]))
    elif C == 2:
        w1, w2, res = _df_nnls2(w_y, G[0][0], G[1][1], G[0][1], p[0], p[1])
        w_list = [w1, w2]
    elif C == 3:
        w_list, res = _df_nnls3(w_y, G, p)
    else:
        w_list, res = _df_nnls4(w_y, G, p)

    # undo the power-of-two scalings (exact)
    w = jnp.stack([_val(wi) for wi in w_list], axis=1)
    w = w * (sy[:, None] / sc)
    return w, _scale(res, sy * sy)


def _nnls_cols_f64(cols, y):
    """float64 path of df_nnls_cols (x64 runtimes): same closed-form
    solvers as the float64 host re-scorer (models/refine._solve_support)."""
    C = cols.shape[2]
    hp = dict(precision=lax.Precision.HIGHEST)
    y_sq = jnp.einsum("bs,bs->b", y, y, **hp)
    G = [[jnp.einsum("bs,bs->b", cols[:, :, i], cols[:, :, j], **hp)
          for j in range(C)] for i in range(C)]
    Y = [jnp.einsum("bs,bs->b", cols[:, :, i], y, **hp) for i in range(C)]
    if C == 1:
        w0, res = mfn.lsqnonneg_1var(y_sq, G[0][0], Y[0])
        return w0[:, None], _df(res)
    if C == 2:
        w1, w2, res = mfn.lsqnonneg_2var(y_sq, G[0][0], G[0][1], G[1][1],
                                         Y[0], Y[1])
        return jnp.stack([w1, w2], axis=1), _df(res)
    if C == 3:
        w1, w2, w3, res = mfn.lsqnonneg_3var(
            y_sq, G[0][0], G[1][1], G[2][2], G[0][1], G[0][2], G[1][2],
            Y[0], Y[1], Y[2])
        return jnp.stack([w1, w2, w3], axis=1), _df(res)
    ws = mfn.lsqnonneg_4var(
        y_sq, tuple(tuple(G[i][j] for j in range(4)) for i in range(4)),
        tuple(Y))
    return jnp.stack(ws[:4], axis=1), _df(ws[4])
