"""Two-pass exact candidate scan: f32 interval row pass + df re-scan,
for the [N1, N2, 1] (2-fascicle + CSF) configuration.

The one-pass double-float scans (ops/dfscan) evaluate every candidate of
the N1 x N2 grid with compensated arithmetic (~400 flops per
point) to resolve residual near-ties to ~1e-10 * ||y||^2. Exactness is
only ever *needed* near the optimum, so this module splits the scan:

  pass 1  f32 row scan (~70 flops/point): per-row (i1) INTERVALS
          [lo, up] of min_{i2} residual over the supports CONTAINING
          block 1, plus a per-voxel floor interval for the block-1-free
          supports. Residuals are evaluated in *progressive elimination*
          form — ``rho_next = rho - t^2 / pivot`` chains whose f32 error
          scales with the weight magnitudes instead of 1 / det like the
          Cramer form (measured to lose 4 digits on highly-correlated
          fingerprint columns). Every candidate carries an error radius
          err = KERR * eps * (1 + sum_i |w_i|); where a pivot is too
          small to divide by, the candidate degrades to the sound
          interval [-err, +inf).
  select  rows whose lower bound can still beat the global upper bound
          U = min(min_rows up, up_floor), always including row 0 (the
          reference first-minimum when the floor wins), index-sorted so
          local tie-breaking matches global reference order. Capped at R
          rows; `ok` is False when more than R - 1 rows qualify.
  pass 2  the existing double-float scan (dfscan.df3_candidates) on
          the R gathered rows only — ~R/N1 of the one-pass df cost, with
          unchanged (reference) selection semantics.

Feasibility semantics MIRROR the one-pass scan: the K=3 case logic
keeps the reference's unguarded {1,2} Cramer branch and its relaxed
full-support test (mf_utils.py:548-593, expressed in weight space as
w_i >= -tol / detG3) for the lower bounds. Borderline boolean disagreements switch between supports whose residuals
agree to second order; the KERR radius absorbs them (validated against
float64 oracles and the one-pass scans in tests/test_f32scan.py,
including adversarially correlated and sign-indefinite data).

Soundness argument: true candidate residuals lie inside the stage-1
intervals, so the winner's row satisfies lo_row <= true_min <= U; if
more than R - 1 rows do, the per-voxel `ok` flag sends the voxel to a
full-grid device re-scan (models/fit.run_bucket_fast) — exact
selection is then unconditional.
"""

import math
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from . import df32
from . import dfscan
from . import nnls as mfn

_HP = dict(preferred_element_type=jnp.float32,
           precision=lax.Precision.HIGHEST)
_TOL = float(100 * 1.1920929e-07)
_EPS = float(1.1920929e-07)
#: per-candidate f32 error radius = KERR * (1 + sum |w_i|).
#: With EXACT Grams (int8 quantize2 + error-free combination, rounded
#: once to f32) the progressive chains' measured worst error is ~1.2 eps
#: on production fingerprint data (f64-prep decomposition: the f32 Gram
#: einsums contributed ~19 of the previous 20 eps) — 8 eps keeps a ~6x
#: margin. A Python float (weak-typed): f32 compute is preserved.
KERR = float(8 * 1.1920929e-07)
_INF = float(np.inf)


def _sanit(x):
    return jnp.where(jnp.isnan(x), jnp.inf, x)


def _interval(feas, stab, res, ws):
    """(lo, up) for one support: feasible -> res +- KERR*(1+ws);
    numerically unstable (pivot too small to divide) -> sound fallback
    [-KERR, +inf); infeasible -> no contribution."""
    err = KERR * (1.0 + ws)
    res = _sanit(res)
    lo = jnp.where(feas, res - err, jnp.where(stab, _INF, -KERR))
    up = jnp.where(feas, res + err, _INF)
    return lo, up


def _sub1(d, p, w):
    """Support {a} (diagonal ~1 after normalization): interval."""
    wa = p / d
    return _interval(wa >= 0, True, w - p * wa, jnp.abs(wa))


def _sub2(dA, dB, g, pA, pB, w):
    """Support {a, b}, eliminating a (diag ~1) then b, without a
    determinant guard (the reference's unguarded 2-variable Cramer
    branch)."""
    invA = 1.0 / dA
    piv = dB - g * g * invA
    stab = piv > _EPS * dB
    invP = jnp.where(stab, 1.0 / jnp.where(stab, piv, 1.0), 0.0)
    t = pB - g * pA * invA
    wb = t * invP
    wa = (pA - g * wb) * invA
    feas = stab & (wa >= 0) & (wb >= 0)
    res = w - pA * pA * invA - t * wb
    return _interval(feas, stab, res, jnp.abs(wa) + jnp.abs(wb))


def _fold(lo, up, lo2, up2):
    return jnp.minimum(lo, lo2), jnp.minimum(up, up2)


def _gram3_hi(qa, qb, contract):
    """Exact-rounded f32 Gram from two quantize3 decompositions, for the
    row/column/voxel hoists: the 9 int8 level products (grouped by scale,
    each group's int32 sum < 2^25 so the f32 casts are ~2^-55-absolute
    exact) are combined error-free with the two bf16 corrections on the
    ~2^-24 quantization residuals (bf16 operands and f32 accumulation:
    bf16's 2^-9 relative error lands at ~0.5 eps_f32 absolute, inside the
    8 eps row-pass radius; the products of bf16 values are exact, and
    HIGHEST keeps their f32 accumulation out of TF32)."""
    Q1a, Q2a, Q3a, Ra, aa = qa
    Q1b, Q2b, Q3b, Rb, ab = qb
    ei = lambda x, y: jnp.einsum(contract, x, y,
                                 preferred_element_type=jnp.int32)
    bf = jnp.bfloat16
    eb = lambda x, y: jnp.einsum(contract, x.astype(bf), y.astype(bf),
                                 preferred_element_type=jnp.float32,
                                 precision=lax.Precision.HIGHEST)
    t11 = ei(Q1a, Q1b)
    t12 = ei(Q1a, Q2b) + ei(Q2a, Q1b)
    t22 = ei(Q2a, Q2b) + ei(Q1a, Q3b) + ei(Q3a, Q1b)
    t23 = ei(Q2a, Q3b) + ei(Q3a, Q2b)
    t33 = ei(Q3a, Q3b)
    c1 = eb(aa + Ra, Rb)
    c2 = eb(Ra, ab)
    f = jnp.float32
    return df32.df_from_sum(
        t11.astype(f) * f(2.0 ** -14), t12.astype(f) * f(2.0 ** -22),
        t22.astype(f) * f(2.0 ** -30), c1, c2,
        t23.astype(f) * f(2.0 ** -38), t33.astype(f) * f(2.0 ** -46))[0]


@partial(jax.jit, static_argnames=("tile", "colmin"))
def rowmin_3(A1, A2, a3, y, tile=256, colmin=False):
    """f32 per-row residual intervals for the [N1, N2, 1] configuration.

    A1 (B, S, N1), A2 (B, S, N2), a3 (B, S, 1), y (B, S).
    Returns (lo (B, N1), up (B, N1), up_floor (B,)): per-row interval
    bounds of min_{i2} over supports CONTAINING block 1, plus the
    per-voxel upper bound of the block-1-free supports (normalized
    problem). The full row minimum is min(row interval, floor).
    ``colmin=True`` additionally
    returns the per-COLUMN lower bounds lo_col (B, N2) (per-point lo
    reduced over rows, folded with the {2}, {2,3} column supports) for
    column-band pruning (df3_twopass).
    """
    B, S, N1 = A1.shape
    N2 = A2.shape[2]
    # EXACT Grams rounded once to f32 everywhere below (the f32 einsum
    # Grams were the dominant error source of the whole pass — measured
    # 20 eps worst vs ~1 eps exact — and set the err radius, hence the
    # band width and the overflow rate).
    A1h, _ = mfn._normalize_block(A1)
    A2h, _ = mfn._normalize_block(A2)
    A3h, _ = mfn._normalize_block(a3)
    yh, _yn, _ys = mfn._normalize_y(y)
    A1h = A1h.astype(jnp.float32)
    A2h = A2h.astype(jnp.float32)
    A3h = A3h.astype(jnp.float32)
    yh = yh.astype(jnp.float32)
    q3A1, q3A2, q3A3, q3y = (dfscan.quantize3(x)
                             for x in (A1h, A2h, A3h, yh))
    g = _gram3_hi
    d1 = g(q3A1, q3A1, "bsn,bsn->bn")                 # ~1
    d2 = g(q3A2, q3A2, "bsn,bsn->bn")
    d3 = g(q3A3, q3A3, "bsn,bsn->bn")[:, 0]           # (B,)
    p_ = g(q3A1, q3y, "bsn,bs->bn")
    q_ = g(q3A2, q3y, "bsn,bs->bn")
    r_ = g(q3A3, q3y, "bsn,bs->bn")[:, 0]
    b_ = g(q3A1, q3A3, "bsn,bsm->bn")
    c_ = g(q3A2, q3A3, "bsn,bsm->bn")
    w_ = g(q3y, q3y, "bs,bs->b")

    e1 = lambda x: x[:, None]                              # (B, 1)
    d3e, re, we = e1(d3), e1(r_), e1(w_)

    # per-row intervals from block-1 supports {1}, {1,3} (K=3 case-logic
    # semantics: no det guard on 2-var branches)
    lo_row, up_row = _sub1(d1, p_, we)
    lo_row, up_row = _fold(lo_row, up_row,
                           *_sub2(d1, d3e, b_, p_, re, we))
    # block-1-free floor: supports {2}, {2,3}, {3}, {}
    lo3, up3 = _sub1(d3e, re, we)
    upf = jnp.minimum(up3[:, 0], w_ + KERR)
    loc_, upc_ = _sub1(d2, q_, we)
    loc2, upc2 = _sub2(d2, d3e, c_, q_, re, we)
    upf = jnp.minimum(upf, jnp.min(jnp.minimum(upc_, upc2), axis=1))
    lo_c_sup = jnp.minimum(loc_, loc2)                     # (B, N2)

    # hoists for the per-point progressive chains
    invd1 = 1.0 / d1                                       # (B, N1) ~1
    kap_p = p_ * invd1
    rho1 = we - p_ * kap_p                                 # {1} LS residual
    # eliminate-csf stage (d3 ~ 1, always well conditioned)
    invd3 = 1.0 / d3e
    kap_b = b_ * invd3                                     # row
    d1p = d1 - b_ * kap_b
    stab1 = d1p > _EPS * d1
    invd1p = jnp.where(stab1, 1.0 / jnp.where(stab1, d1p, 1.0), 0.0)
    p1p = p_ - kap_b * re
    kap_pp = p1p * invd1p
    rho13 = (we - re * re * invd3) - p1p * kap_pp          # {1,3} residual
    u3 = re * invd3                                        # (B, 1)
    d2p = d2 - c_ * c_ * invd3                             # col
    q2p = q_ - c_ * (re * invd3)
    kap_c = c_ * invd3

    n_tiles = int(math.ceil(N1 / tile))
    N1p = n_tiles * tile
    if N1p > N1:
        A1h = jnp.pad(A1h, ((0, 0), (0, 0), (0, N1p - N1)))
    padr = lambda x: (jnp.pad(x, ((0, 0), (0, N1p - N1)))
                      if N1p > N1 else x)
    rowv = [padr(x) for x in (d1, invd1, kap_p, rho1, kap_b, d1p,
                              invd1p, kap_pp, rho13, lo_row, up_row)]
    stab1p = padr(stab1)

    cc_ = lambda x: x[:, None, :]
    d2c, qc, cc = cc_(d2), cc_(q_), cc_(c_)
    d2pc, q2pc, kapcc = cc_(d2p), cc_(q2p), cc_(kap_c)
    invd3e = invd3[:, :, None]                             # (B, 1, 1)
    # per-tile Grams: two-level df_gram_tile, rounded once to f32
    qA1p = dfscan.quantize2(A1h)                           # padded
    qA2 = dfscan.quantize2(A2h)

    def body(t):
        st = t * tile
        qa1_t = tuple(lax.dynamic_slice(x, (0, 0, st), (B, S, tile))
                      for x in qA1p)
        a = dfscan.df_gram_tile(qa1_t, qA2, A2.shape[2])[0]
        sl = lambda x: lax.dynamic_slice(x, (0, st),
                                         (B, tile))[:, :, None]
        (d1t, invd1t, kap_pt, rho1t, kap_bt, d1pt, invd1pt, kap_ppt,
         rho13t, lo_rt, up_rt) = (sl(x) for x in rowv)
        stab1t = lax.dynamic_slice(stab1p, (0, st), (B, tile))[:, :, None]

        # support {1,2}: reference case1 — strict positive weights, NO
        # det guard (mf_utils.py:344-358); stability-guarded division
        pivA = d2c - a * a * invd1t
        stabA = pivA > _EPS * d2c
        invA = jnp.where(stabA, 1.0 / jnp.where(stabA, pivA, 1.0), 0.0)
        tA = qc - a * kap_pt
        w2 = tA * invA
        w1 = kap_pt - a * invd1t * w2
        feas12 = stabA & (w1 > 0) & (w2 > 0)
        ws12 = jnp.abs(w1) + jnp.abs(w2)
        lo, up = _interval(feas12, stabA, rho1t - tA * w2,
                           ws12 + ws12 * ws12)

        # support {1,2,3}: eliminate 3 (hoisted) -> 1 -> 2. Mirrors the
        # reference full-support test detG3 > tol * d1*d2*d3 and
        # D_i >= -tol, i.e. w_i >= -tol / detG3 with
        # detG3 = d3 * d1' * pivB.
        ap = a - kap_bt * cc
        pivB = d2pc - ap * ap * invd1pt
        stabB = stab1t & (pivB > _EPS * d2c)
        invB = jnp.where(stabB, 1.0 / jnp.where(stabB, pivB, 1.0), 0.0)
        tB = q2pc - ap * kap_ppt
        w2f = tB * invB
        w1f = kap_ppt - ap * invd1pt * w2f
        w3f = u3[:, None, :] - kap_bt * w1f - kapcc * w2f
        # the mirrored one-pass scan now resolves detG3 in double-float
        # down to ~1e-12 (dfscan._TOL_DET) — far below what this f32 pass
        # can check — so no det gate here: stability-guarded evaluation
        # with the weight-scaled interval width is the sound bound
        tolw = _TOL * invd3e * invd1pt * invB
        feas123 = (stabB & (w1f >= -tolw) & (w2f >= -tolw)
                   & (w3f >= -tolw))
        ws123 = jnp.abs(w1f) + jnp.abs(w2f) + jnp.abs(w3f)
        lo2, up2 = _interval(
            feas123, stabB, rho13t - tB * w2f, ws123 + ws123 * ws123)
        # the relaxed test admits slightly negative weights, whose LS
        # residual can undercut the NNLS optimum: such a support lowers
        # the lower bound only
        nonneg = (w1f >= 0) & (w2f >= 0) & (w3f >= 0)
        lo, up = _fold(lo, up, lo2, jnp.where(nonneg, up2, jnp.inf))

        rowi = st + lax.broadcasted_iota(jnp.int32, (1, tile, 1), 1)
        lo_c = jnp.min(jnp.where(rowi < N1, lo, jnp.inf), axis=1)
        lo = jnp.min(lo, axis=2)                           # (B, tile)
        up = jnp.min(up, axis=2)
        lo = jnp.minimum(lo, lo_rt[:, :, 0])
        up = jnp.minimum(up, up_rt[:, :, 0])
        return lo, up, lo_c

    lo, up, lo_col = _scan_tiles(body, n_tiles, lo_c_sup)
    row = lax.broadcasted_iota(jnp.int32, (B, N1p), 1)
    lo = jnp.where(row < N1, lo, jnp.inf)[:, :N1]
    up = jnp.where(row < N1, up, jnp.inf)[:, :N1]
    if not colmin:
        return lo, up, upf
    return lo, up, upf, lo_col


def _scan_tiles(body, n_tiles, lo_col):
    """Run ``body(t) -> (lo (B, tile), up (B, tile), lo_c (B, N2))`` over
    the row tiles as one lax.scan, so that only one tile's (B, tile, N2)
    temporaries are live at a time and the tile body compiles once.
    Returns (lo (B, n_tiles * tile), up, min of lo_col and every lo_c)."""
    def step(lo_col, t):
        lo, up, lo_c = body(t)
        return jnp.minimum(lo_col, lo_c), (lo, up)

    lo_col, (los, ups) = lax.scan(step, lo_col, jnp.arange(n_tiles))
    flat = lambda x: jnp.moveaxis(x, 0, 1).reshape(x.shape[1], -1)
    return flat(los), flat(ups), lo_col


@partial(jax.jit, static_argnames=("R",))
def _select_rows(lo, up, up_floor, R):
    """Interval row selection.

    Rows whose block-1 lower bound can still beat the global upper bound
    U = min(min_rows up, up_floor) are candidates. Row 0 is always
    included: when the block-1-free floor wins, every grid point ties at
    the floor and the reference first-minimum lands in row 0. The
    returned rows are sorted by INDEX so the df re-scan's local
    first-minimum tie-breaking coincides with the global reference order.
    Returns (rows (B, R) int32 ascending, ok (B,) bool: False when more
    than R - 1 rows qualify)."""
    U = jnp.minimum(jnp.min(up, axis=1), up_floor)[:, None]
    return _select_in_band(lo, U, R)


def _select_in_band(lo, U, R):
    """Shared selection core: indices whose interval lower bound can
    still beat the global upper bound U (B, 1), index-ascending, index 0
    forced (owner of the index-free tied supports). ok is False when
    more than R - 1 indices qualify.

    A per-index rank (in-band ascending, then out-of-band ascending as
    filler — the permutation a top_k over those keys would produce, at a
    fraction of its cost) is computed with two cumsums, and each index
    is scattered to its rank's slot (ranks are a permutation of 0..N-1,
    so the first R slots are all filled). Requires N >= R (callers gate
    the two-pass on N > 2R).
    Returns (sel (B, R) int32, ok (B,))."""
    in_band = lo <= U
    n_cand = jnp.sum(in_band, axis=1)
    ok = n_cand <= R - 1
    ibf = in_band.astype(jnp.float32)
    ibf = ibf.at[:, 0].set(1.0)                            # force index 0
    c_in = jnp.cumsum(ibf, axis=1)       # inclusive in-band count (exact
    c_oob = jnp.cumsum(1.0 - ibf, axis=1)   # f32 integers below 2^24)
    n_in = c_in[:, -1:]
    rank = jnp.where(ibf > 0, c_in - 1.0, n_in + c_oob - 1.0)
    rank = rank.astype(jnp.int32)
    vox = lax.broadcasted_iota(jnp.int32, rank.shape, 0)
    idx = lax.broadcasted_iota(jnp.int32, rank.shape, 1)
    sel = jnp.zeros((lo.shape[0], R), jnp.int32).at[vox, rank].set(
        idx, mode="drop", unique_indices=True)
    return sel, ok


def _gather_cols(A, idx):
    """Gather columns A[b, :, idx[b]] -> (B, S, R): an exact copy."""
    return jnp.take_along_axis(A, idx[:, None, :], axis=2)


@partial(jax.jit, static_argnames=("M", "R"))
def df3_twopass(A1, A2, a3, y, M=1, R=128):
    """Two-pass exact top-M for [N1, N2, 1]: f32 interval row scan -> df
    re-scan of the top-R rows. Returns (cand (B, M, 2), res (B, M),
    y_sq (B,), ok (B,) bool). Where ``ok`` is False the caller must
    re-solve the voxel over the full grid (the selection guarantee only
    covers in-budget voxels)."""
    B, S, N1 = A1.shape
    N2 = A2.shape[2]
    prune_cols = N2 > R
    if prune_cols:
        lo, up, up_floor, lo_col = rowmin_3(A1, A2, a3, y, colmin=True)
    else:
        lo, up, up_floor = rowmin_3(A1, A2, a3, y)
    rows, ok = _select_rows(lo, up, up_floor, R)
    A1_sel = _gather_cols(A1, rows)
    if prune_cols:
        # column-band pruning: the winner point's column also satisfies
        # lo_col <= U; supports that pin neither index resolve to the
        # forced index 0, and index-ascending subsets preserve the
        # first-minimum tie order
        U = jnp.minimum(jnp.min(up, axis=1), up_floor)[:, None]
        cols, ok_c = _select_in_band(lo_col, U, R)
        ok = ok & ok_c
        A2_sel = _gather_cols(A2, cols)
    else:
        A2_sel = A2
    cand, vals, y_sq = dfscan.df3_candidates(A1_sel, A2_sel, a3, y, M=M)
    # +inf pool entries may carry padded local rows -> clamp before gather
    loc = jnp.clip(cand[:, :, 0], 0, R - 1)
    i1 = jnp.take_along_axis(rows, loc, axis=1)
    i2 = cand[:, :, 1]
    if prune_cols:
        i2 = jnp.take_along_axis(cols, jnp.clip(i2, 0, R - 1), axis=1)
    cand = jnp.stack([i1, i2], axis=2)
    return cand, vals, y_sq, ok
