"""Double-float candidate scan tests (ops/dfscan, ops/df32).

The compensated scan must (a) agree with a float64 scipy oracle on ordinary
problems, and (b) resolve residual gaps far below the plain-f32 noise floor
(~1e-7 * ||y||^2) — the property that makes default-mode atom selection
match the reference's float64 Numba kernels (mf_utils.py:284-607).
"""

import itertools

import numpy as np
import pytest
import scipy.optimize

import jax.numpy as jnp

from microstructure_fingerprinting_tpu.ops import dfscan
from microstructure_fingerprinting_tpu.ops import df32


def _oracle3(A1, A2, a3, y):
    """f64 exhaustive argmin over (i1, i2) for blocks [N1, N2, 1]."""
    best = (None, np.sum(y.astype(np.float64) ** 2))
    for i, j in itertools.product(range(A1.shape[1]), range(A2.shape[1])):
        A = np.stack([A1[:, i], A2[:, j], a3[:, 0]],
                     axis=1).astype(np.float64)
        w, rn = scipy.optimize.nnls(A, y.astype(np.float64))
        if rn * rn < best[1]:
            best = ((i, j), rn * rn)
    return best


def test_df32_error_free_transforms(rng):
    a = np.float32(rng.randn(64) * 100)
    b = np.float32(rng.randn(64))
    s, e = df32.two_sum(jnp.asarray(a), jnp.asarray(b))
    s64 = np.asarray(s, np.float64) + np.asarray(e, np.float64)
    assert np.array_equal(s64, a.astype(np.float64) + b.astype(np.float64))
    p, e = df32.two_prod(jnp.asarray(a), jnp.asarray(b))
    p64 = np.asarray(p, np.float64) + np.asarray(e, np.float64)
    assert np.array_equal(p64, a.astype(np.float64) * b.astype(np.float64))


def _df32_case(name, a, b):
    """The (hi, lo) pair one df32 transform makes of a and b."""
    import jax.numpy as jnp
    if name == "two_sum":
        return df32.two_sum(a, b)
    if name == "split":
        return df32.split(a)
    if name == "two_prod":
        return df32.two_prod(a, b)
    if name == "mul_ps":
        z = jnp.zeros_like(a)
        return df32.mul_ps(df32.presplit((a, z)), df32.presplit((b, z)))
    p, _e = df32.two_prod(a, b)
    return df32.two_sum(p, b)


@pytest.mark.parametrize("name", ["two_sum", "split", "two_prod", "mul_ps",
                                  "two_sum_of_product"])
def test_df32_exact_inside_scan(rng, name):
    """The error-free transforms stay exact inside a jitted lax.scan body,
    where the CPU and GPU compilers contract a product and a following
    add into one fused multiply-add (two_sum_of_product feeds two_prod's
    rounded product straight into two_sum)."""
    import jax
    import jax.numpy as jnp
    n = 1 << 14
    a = np.float32(rng.randn(n) * np.exp(rng.uniform(-8, 8, n)))
    b = np.float32(rng.randn(n) * np.exp(rng.uniform(-8, 8, n)))
    step = lambda c, x: (c, _df32_case(name, *x))
    hi, lo = jax.jit(lambda a, b: jax.lax.scan(
        step, 0.0, (a.reshape(64, -1), b.reshape(64, -1)))[1])(
            jnp.asarray(a), jnp.asarray(b))
    hi = np.asarray(hi, np.float64).ravel()
    lo = np.asarray(lo, np.float64).ravel()
    A, B = a.astype(np.float64), b.astype(np.float64)
    want = {"two_sum": A + B, "split": A, "two_prod": A * B,
            "mul_ps": A * B,
            "two_sum_of_product": (a * b).astype(np.float64) + B}[name]
    assert np.array_equal(hi + lo, want)
    if name == "split":
        # both halves fit in 12 significant bits
        assert not np.any(np.float32(hi).view(np.uint32) & 0xFFF)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["two_sum", "split", "two_prod", "mul_ps",
                                  "two_sum_of_product"])
def test_df32_exact_inside_scan_on_gpu(gpu, rng, name):
    """The same identities as compiled for the card."""
    test_df32_exact_inside_scan(rng, name)


def test_quantize2_exact_decomposition(rng):
    # |X| <= ~0.99: int8 levels unclipped (entries at +-1 degrade R
    # gracefully to ~2^-8 but stay exact; normalized columns sit far below)
    X = np.float32((rng.rand(40, 30) * 2 - 1) * 0.99)
    Q1, Q2, R, a = dfscan.quantize2(jnp.asarray(X))
    rec = (np.asarray(Q1, np.float64) * 2.0 ** -7
           + np.asarray(Q2, np.float64) * 2.0 ** -15
           + np.asarray(R, np.float64))
    assert np.array_equal(rec.astype(np.float32), X)
    # the identity a + R == X must hold exactly in f32
    assert np.array_equal(np.asarray(a) + np.asarray(R), X)
    # |R1| can reach s1/2 = 128*s2, clipping Q2 at 127 -> |R| <= ~2^-15
    assert np.max(np.abs(np.asarray(R))) <= 2.0 ** -15 + 2.0 ** -27


def test_df_gram_accuracy(rng):
    B, S, N = 2, 60, 32
    A = np.float32(rng.randn(B, S, N) / np.sqrt(S))
    Bm = np.float32(rng.randn(B, S, N) / np.sqrt(S))
    qa = dfscan.quantize2(jnp.asarray(A))
    qb = dfscan.quantize2(jnp.asarray(Bm))
    hi, lo = dfscan.df_gram(qa, qb, "bst,bsn->btn")
    got = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
    want = np.einsum("bst,bsn->btn", A.astype(np.float64),
                     Bm.astype(np.float64))
    assert np.max(np.abs(got - want)) < 1e-10
    hi2, lo2 = dfscan.df_gram_tile(qa, qb, N)
    got2 = np.asarray(hi2, np.float64) + np.asarray(lo2, np.float64)
    assert np.max(np.abs(got2 - want)) < 1e-9


@pytest.mark.parametrize("csf", [True, False])
def test_dfscan_matches_oracle(rng, csf):
    B, S, N1, N2 = 3, 40, 22, 18
    A1 = np.float32(rng.randn(B, S, N1))
    A2 = np.float32(rng.randn(B, S, N2))
    a3 = np.float32(np.abs(rng.randn(B, S, 1)) + 0.05)
    y = np.float32(rng.randn(B, S))
    if csf:
        cand, vals, ysq = dfscan.df3_candidates(
            jnp.asarray(A1), jnp.asarray(A2), jnp.asarray(a3),
            jnp.asarray(y), M=4)
    else:
        cand, vals, ysq = dfscan.df2_candidates(
            jnp.asarray(A1), jnp.asarray(A2), jnp.asarray(y), M=4)
    cand = np.asarray(cand)
    for b in range(B):
        if csf:
            (ij, obj) = _oracle3(A1[b], A2[b], a3[b], y[b])
        else:
            best = (None, np.sum(y[b].astype(np.float64) ** 2))
            for i, j in itertools.product(range(N1), range(N2)):
                A = np.stack([A1[b, :, i], A2[b, :, j]],
                             axis=1).astype(np.float64)
                w, rn = scipy.optimize.nnls(A, y[b].astype(np.float64))
                if rn * rn < best[1]:
                    best = ((i, j), rn * rn)
            ij, obj = best
        if ij is None:
            continue
        assert tuple(cand[b, 0]) == ij, \
            "voxel %d: %s vs oracle %s" % (b, tuple(cand[b, 0]), ij)


def test_dfscan_resolves_sub_f32_gaps(rng):
    """Two atom pairs whose residuals differ by ~1e-9 * ||y||^2 — far below
    the plain f32 scan's ~1e-7 resolution — must be ranked correctly."""
    S = 64
    base = rng.randn(S)
    base /= np.linalg.norm(base)
    orth = rng.randn(S)
    orth -= base * (base @ orth)
    orth /= np.linalg.norm(orth)
    # winner leaves residual sqrt(1e-10); decoy leaves sqrt(3e-10)
    win = base + 1e-5 * orth
    dec = base + np.sqrt(3.0) * 1e-5 * orth
    filler = rng.randn(S, 6) * 0.3 + base[:, None]
    A1 = np.stack([dec] + [win] + list(filler.T), axis=1).astype(np.float32)
    A2 = (rng.randn(S, 5) * 0.2 + 0.7 * base[:, None]).astype(np.float32)
    a3 = np.abs(rng.randn(S, 1)).astype(np.float32) + 0.1
    y = (base * 100).astype(np.float32)
    cand, vals, ysq = dfscan.df3_candidates(
        jnp.asarray(A1[None]), jnp.asarray(A2[None]),
        jnp.asarray(a3[None]), jnp.asarray(y[None]), M=4)
    cand = np.asarray(cand)
    # the winner/decoy residual gap is ~1e-10 * ||y||^2 (1e-10 vs 3e-10):
    # far below the ~1e-7 plain-f32 floor. The compensated scan must pick
    # the winner atom; its selected combination must be optimal to the
    # scan's design resolution (~1e-10 relative).
    assert cand[0, 0, 0] == 1, "decoy atom chosen over the true winner"
    ij, obj = _oracle3(A1, A2, a3, y)
    i, j = cand[0, 0]
    A = np.stack([A1[:, i], A2[:, j], a3[:, 0]], axis=1).astype(np.float64)
    _w, rn = scipy.optimize.nnls(A, y.astype(np.float64))
    ysq64 = float(y.astype(np.float64) @ y.astype(np.float64))
    assert rn * rn <= obj + 2e-10 * ysq64


def _oracle4_grid(A1, A2, a3, A4, y):
    """f64 full-grid NNLS argmin over (i1, i2, i4) with a CSF block."""
    best = (np.sum(y.astype(np.float64) ** 2), None)
    for i in range(A1.shape[1]):
        for j in range(A2.shape[1]):
            for e in range(A4.shape[1]):
                A = np.stack([A1[:, i], A2[:, j], a3[:, 0], A4[:, e]],
                             axis=1).astype(np.float64)
                w, rn = scipy.optimize.nnls(A, y.astype(np.float64))
                if rn * rn < best[0] - 1e-15:
                    best = (rn * rn, (i, j, 0, e))
    return best


def test_df4_matches_oracle_correlated_ear(rng):
    """4-block scan vs a full-grid f64 oracle on fingerprint-like data.

    The CSF and EAR columns are decaying exponentials of nearby rates —
    nearly collinear pairs, exactly the real-dictionary regime. Regression
    for two historical failure modes: (a) the Schur reduction of the
    (csf, ear) block dividing by its near-vanishing determinant (residuals
    corrupted to ~1e-6 * ||y||^2 -> wrong EAR atoms), and (b) the compiler
    contracting a rounded product into a following add (fused multiply-
    add) inside the lax.scan sweep bodies, which broke the error-free
    products (constant ~1e-5 offsets -> wrong (i1, i2) pairs). The
    4-support runs a guarded LDL' elimination eliminating the
    well-conditioned blocks first, and ops/df32 keeps every error-free
    transform exact under contraction.
    """
    B, S, N, E = 3, 60, 14, 4
    t = np.linspace(0, 1.0, S)
    mk = lambda rates: np.exp(-t[:, None] * rates[None, :])
    A1 = np.float32(mk(rng.uniform(0.5, 6.0, N)) + 0.02 * rng.randn(S, N))
    A2 = np.float32(mk(rng.uniform(0.5, 6.0, N)) + 0.02 * rng.randn(S, N))
    a3 = np.float32(mk(np.array([2.2])))
    A4 = np.float32(mk(np.linspace(1.9, 2.8, E)))   # near-collinear w/ csf
    A1b = np.broadcast_to(A1[None], (B, S, N))
    A2b = np.broadcast_to(A2[None], (B, S, N))
    ys = []
    for b in range(B):
        w = np.abs(rng.randn(4)) + 0.2
        ys.append(w[0] * A1[:, rng.randint(N)] + w[1] * A2[:, rng.randint(N)]
                  + w[2] * a3[:, 0] + w[3] * A4[:, rng.randint(E)]
                  + 1e-4 * rng.randn(S))
    y = np.float32(np.stack(ys) * 300)
    cand, vals, ysq = dfscan.df4_candidates(
        jnp.asarray(A1b), jnp.asarray(A2b),
        jnp.asarray(np.broadcast_to(a3[None], (B, S, 1))),
        jnp.asarray(np.broadcast_to(A4[None], (B, S, E))),
        jnp.asarray(y), M=4)
    cand = np.asarray(cand)
    vals = np.asarray(vals)
    for b in range(B):
        yb32 = y[b].astype(np.float64)
        yn = yb32 / np.linalg.norm(yb32)
        nrm = lambda X: X.astype(np.float64) / np.linalg.norm(
            X.astype(np.float64), axis=0, keepdims=True)
        obj, idx = _oracle4_grid(nrm(A1), nrm(A2), nrm(a3), nrm(A4), yn)
        got = tuple(int(c) for c in cand[b, 0])
        # exact index parity, or an equal-residual tie at scan resolution
        assert got == idx or abs(vals[b, 0] - obj) < 3e-9, \
            "voxel %d: scan %s (%.3e) vs oracle %s (%.3e)" % (
                b, got, vals[b, 0], idx, obj)
        assert vals[b, 0] > obj - 3e-9  # never below the true optimum


def test_df3_multitile_matches_oracle(rng):
    """Multi-tile (N1 > tile) df3 scan vs oracle — regression for the
    lax.scan tile-loop mis-evaluation (multiply-add contraction of the
    error-free products)."""
    B, S, N1, N2 = 2, 40, 40, 12
    A1 = np.float32(rng.randn(B, S, N1))
    A2 = np.float32(rng.randn(B, S, N2))
    a3 = np.float32(np.abs(rng.randn(B, S, 1)) + 0.05)
    y = np.float32(rng.randn(B, S) * 50)
    cand, vals, ysq = dfscan.df3_candidates(
        jnp.asarray(A1), jnp.asarray(A2), jnp.asarray(a3),
        jnp.asarray(y), M=4, tile=16)          # forces 3 row tiles
    cand = np.asarray(cand)
    for b in range(B):
        ij, obj = _oracle3(A1[b], A2[b], a3[b], y[b])
        if ij is None:
            continue
        assert tuple(cand[b, 0]) == ij


def test_df_nnls_cols_matches_f64_host(rng):
    """Device small-NNLS finalize (df_nnls_cols) == float64 host solvers
    on raw-scale correlated columns, for C = 1..4."""
    from microstructure_fingerprinting_tpu.ops import nnls as mfn
    B, S = 48, 70
    t = np.linspace(0, 1, S)
    base = np.exp(-3 * t)
    for C in (1, 2, 3, 4):
        cols = np.float32(
            300 * (base[None, :, None]
                   * np.exp(-rng.rand(B, 1, C) * 3 * t[None, :, None])
                   + 0.01 * rng.randn(B, S, C)))
        wtrue = np.abs(rng.randn(B, C)) * (rng.rand(B, C) < 0.7)
        y = np.float32(np.einsum("bsc,bc->bs", cols, wtrue)
                       + 20 * rng.randn(B, S))
        w_d, res_d = dfscan.df_nnls_cols(
            jnp.asarray(cols, jnp.float32), jnp.asarray(y, jnp.float32))
        w_d = np.asarray(w_d)
        res_d = (np.asarray(res_d[0], np.float64)
                 + np.asarray(res_d[1], np.float64))
        c64, y64 = cols.astype(np.float64), y.astype(np.float64)
        ysq = np.sum(y64 * y64, axis=1)
        G = [[np.einsum("bs,bs->b", c64[:, :, i], c64[:, :, j])
              for j in range(C)] for i in range(C)]
        Y = [np.einsum("bs,bs->b", c64[:, :, i], y64) for i in range(C)]
        if C == 1:
            w0, r0 = mfn.lsqnonneg_1var(ysq, G[0][0], Y[0], xp=np)
            wo, ro = w0[:, None], r0
        elif C == 2:
            a, b_, r0 = mfn.lsqnonneg_2var(ysq, G[0][0], G[0][1], G[1][1],
                                           Y[0], Y[1], xp=np)
            wo, ro = np.stack([a, b_], 1), r0
        elif C == 3:
            a, b_, c_, r0 = mfn.lsqnonneg_3var(
                ysq, G[0][0], G[1][1], G[2][2], G[0][1], G[0][2], G[1][2],
                Y[0], Y[1], Y[2], xp=np)
            wo, ro = np.stack([a, b_, c_], 1), r0
        else:
            ws = mfn.lsqnonneg_4var(
                ysq, tuple(tuple(G[i][j] for j in range(4))
                           for i in range(4)), tuple(Y), xp=np)
            wo, ro = np.stack(ws[:4], 1), ws[4]
        assert np.max(np.abs(w_d - wo)) <= 3e-7 * max(np.max(np.abs(wo)),
                                                      1.0)
        assert np.max(np.abs(res_d - ro) / ysq) < 1e-7


def test_df3_ill_conditioned_optimum(rng):
    """Near-duplicate atom pairs produce valid all-positive optima at
    normalized-Gram determinants ~1e-6 — below 100*eps_f32, where the old
    f32 conditioning guard marked them infeasible and the scan missed the
    true optimum entirely (round-5 regression: caught by differential
    testing vs the reference, which solves these in float64 with no det
    guard at all, mf_utils.py:554-573)."""
    import scipy.optimize
    import jax.numpy as jnp
    from microstructure_fingerprinting_tpu.ops import dfscan
    B, S = 1, 60
    # two nearly-parallel fascicle columns + a correlated third column:
    # the 3-var optimum needs all three with large-ish weights
    base = np.abs(rng.randn(S)) + 0.3
    c1 = base + 1e-3 * np.abs(rng.randn(S))
    c2 = base + 1e-3 * np.abs(rng.randn(S))
    c3 = np.abs(rng.randn(S)) + 0.3
    y = 50 * c1 - 49 * (c2 / np.linalg.norm(c2) * np.linalg.norm(c1)) \
        + 3.0 * c3 + 0.0 * base
    y = np.abs(y) + 0.05
    A1 = np.stack([c1, np.abs(rng.randn(S)) + 0.3], axis=1)
    A2 = np.stack([c2, np.abs(rng.randn(S)) + 0.3], axis=1)
    # brute-force f64 oracle over the 2x2x1 grid
    best = (np.inf, None)
    for i1 in range(2):
        for i2 in range(2):
            cols = np.stack([A1[:, i1], A2[:, i2], c3], axis=1)
            w, rn = scipy.optimize.nnls(cols, y)
            if rn * rn < best[0]:
                best = (rn * rn, (i1, i2))
    cand, vals, ysq = dfscan.df3_candidates(
        jnp.asarray(A1[None]), jnp.asarray(A2[None]),
        jnp.asarray(c3[None, :, None]), jnp.asarray(y[None]), M=1)
    assert tuple(np.asarray(cand)[0, 0]) == best[1], \
        "scan missed the ill-conditioned optimum"
    got = float(np.asarray(vals)[0, 0]) * float(np.asarray(ysq)[0])
    assert abs(got - best[0]) < 1e-6 * float(np.asarray(ysq)[0])
