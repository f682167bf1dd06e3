"""Two-pass exact scan (ops/f32scan): f32 interval row pass + df re-scan.

Validates (a) interval soundness — the float64 row minima lie inside the
f32 [lo, up] bounds, on random, adversarially correlated, and
sign-indefinite data; (b) two-pass selection == one-pass df selection;
(c) the overflow flag fires when more ties exist than the row budget."""

import numpy as np
import pytest

import jax.numpy as jnp

from microstructure_fingerprinting_tpu.ops import dfscan
from microstructure_fingerprinting_tpu.ops import f32scan
from microstructure_fingerprinting_tpu.ops import nnls as mfn


@pytest.fixture
def rng():
    return np.random.RandomState(141414)


def _rand_problem(rng, B=3, S=40, N1=70, N2=60, corr=0.0, positive=False):
    A1 = rng.randn(B, S, N1)
    A2 = rng.randn(B, S, N2)
    if positive:
        A1, A2 = np.abs(A1) + 0.05, np.abs(A2) + 0.05
    if corr > 0:  # fingerprint-like: highly correlated columns
        base = np.abs(rng.randn(B, S, 1)) if positive else rng.randn(B, S,
                                                                     1)
        A1 = corr * base + (1 - corr) * A1
        A2 = corr * base + (1 - corr) * A2
    a3 = np.abs(rng.randn(B, S, 1)) + 0.05
    y = rng.randn(B, S)
    if positive:
        y = np.abs(y)
    f = np.float32
    return f(A1), f(A2), f(a3), f(y)


def _f64_rowmin3(A1, A2, a3, y):
    """Float64 oracle of the per-row NNLS minimum (reference case logic)."""
    B, S, N1 = A1.shape
    N2 = A2.shape[2]
    out = np.zeros((B, N1))
    for b in range(B):
        D1 = A1[b].astype(np.float64)
        D2 = A2[b].astype(np.float64)
        n1 = np.linalg.norm(D1, axis=0, keepdims=True)
        n2 = np.linalg.norm(D2, axis=0, keepdims=True)
        D1, D2 = D1 / n1, D2 / n2
        d3c = a3[b, :, 0].astype(np.float64)
        d3c = d3c / np.linalg.norm(d3c)
        yv = y[b].astype(np.float64)
        yv = yv / np.linalg.norm(yv)
        y_sq = yv @ yv
        _w1, _w2, _w3, res = mfn.lsqnonneg_3var(
            y_sq, np.einsum("si,si->i", D1, D1)[:, None],
            np.einsum("si,si->i", D2, D2)[None, :], d3c @ d3c,
            D1.T @ D2, (D1.T @ d3c)[:, None], (D2.T @ d3c)[None, :],
            (D1.T @ yv)[:, None], (D2.T @ yv)[None, :], d3c @ yv, xp=np)
        out[b] = np.min(res, axis=1)
    return out


@pytest.mark.parametrize("corr,positive", [
    (0.0, False), (0.9, False), (0.99, False),
    (0.9, True), (0.999, True)])
def test_interval_sound(rng, corr, positive):
    """f64 row minima respect the f32 upper bounds; bands stay tight."""
    A1, A2, a3, y = _rand_problem(rng, B=3, S=48, N1=90, N2=80,
                                  corr=corr, positive=positive)
    lo, up, upf = f32scan.rowmin_3(jnp.asarray(A1), jnp.asarray(A2),
                                   jnp.asarray(a3), jnp.asarray(y))
    lo, up, upf = np.asarray(lo), np.asarray(up), np.asarray(upf)
    rm64 = _f64_rowmin3(A1, A2, a3, y)
    # upper-bound soundness: the true full row minimum (any support) never
    # exceeds either upper bound (lo soundness is exercised end-to-end by
    # the twopass-vs-onepass equivalence tests below)
    up_full = np.minimum(up, upf[:, None])
    assert np.all(rm64 <= up_full + 1e-7), \
        "up violated by %g" % np.max(rm64 - up_full)
    # intervals must be tight enough to be useful (few rows in band) on
    # realistic correlation levels. At uniform corr 0.999 EVERY atom pair
    # is ill-conditioned and the true row minima tie within the sound
    # radius — flooding the band is then correct (the two-pass degrades
    # to a full scan; overflow tiers handle it upstream), not loose.
    U = np.minimum(np.min(up, axis=1), upf)[:, None]
    n_band = np.sum(lo <= U, axis=1)
    if corr <= 0.99:
        assert np.all(n_band <= 64), \
            "loose intervals: %s rows in band" % n_band


def test_twopass3_matches_onepass(rng):
    """Selection parity on every voxel within the row budget; adversarial
    sign-indefinite near-collinear data may overflow (handled upstream by
    the full-grid fallback) but must never silently mis-select."""
    any_ok = 0
    for corr, positive in ((0.0, False), (0.95, True), (0.99, False),
                           (0.999, True)):
        A1, A2, a3, y = _rand_problem(rng, B=4, S=40, N1=150, N2=60,
                                      corr=corr, positive=positive)
        cand, vals, ysq, ok = f32scan.df3_twopass(
            jnp.asarray(A1), jnp.asarray(A2), jnp.asarray(a3),
            jnp.asarray(y), M=1, R=64)
        cand0, vals0, _ = dfscan.df3_candidates(
            jnp.asarray(A1), jnp.asarray(A2), jnp.asarray(a3),
            jnp.asarray(y), M=1)
        ok = np.asarray(ok)
        if corr == 0.0:
            assert ok.all(), \
                "unexpected overflow on %d voxels" % (~ok).sum()
        any_ok += int(ok.sum())
        assert np.all(np.asarray(cand)[ok, 0] == np.asarray(cand0)[ok, 0])
        np.testing.assert_allclose(np.asarray(vals)[ok, 0],
                                   np.asarray(vals0)[ok, 0],
                                   rtol=1e-5, atol=1e-7)
    assert any_ok >= 12


def test_overflow_flag(rng):
    """With R smaller than the number of exact ties, ok must be False."""
    B, S, N2 = 2, 30, 20
    A_one = np.abs(rng.randn(S, 8)) + 0.1
    A1 = np.tile(A_one, (1, 8))[None].repeat(B, axis=0)  # 64 duplicate cols
    A1 = np.float32(A1)
    A2 = np.float32(np.abs(rng.randn(B, S, N2)) + 0.1)
    a3 = np.float32(np.abs(rng.randn(B, S, 1)) + 0.05)
    y = np.float32(A_one[:, 0] + 0.3 * A2[0, :, 3])[None].repeat(B, axis=0)
    _c, _v, _ysq, ok = f32scan.df3_twopass(
        jnp.asarray(A1), jnp.asarray(A2), jnp.asarray(a3), jnp.asarray(y),
        M=1, R=4)
    assert not np.asarray(ok).any()


def test_twopass_recovers_planted_atom(rng):
    """Noiseless synthesis: the two-pass winner is the planted pair."""
    B, S, N1, N2 = 4, 60, 200, 180
    A1 = np.float32(np.abs(rng.randn(B, S, N1))) + 0.05
    A2 = np.float32(np.abs(rng.randn(B, S, N2))) + 0.05
    a3 = np.float32(np.abs(rng.randn(B, S, 1)) + 0.05)
    i1s = rng.randint(0, N1, B)
    i2s = rng.randint(0, N2, B)
    y = np.stack([0.7 * A1[b, :, i1s[b]] + 0.25 * A2[b, :, i2s[b]]
                  + 0.05 * a3[b, :, 0] for b in range(B)])
    cand, _v, _ysq, ok = f32scan.df3_twopass(
        jnp.asarray(A1), jnp.asarray(A2), jnp.asarray(a3),
        jnp.asarray(y.astype(np.float32)), M=1, R=32)
    assert np.asarray(ok).all()
    cand = np.asarray(cand)
    assert np.all(cand[:, 0, 0] == i1s)
    assert np.all(cand[:, 0, 1] == i2s)


def test_twopass3_col_pruning_matches_onepass(rng):
    """df3 column pruning active (N2 > R): selection parity with the
    one-pass oracle on correlated fingerprint-like data."""
    B, S, N1, N2 = 4, 48, 150, 220
    base = np.abs(rng.randn(B, S, 1))
    mk = lambda n: np.float32(
        0.9 * base + 0.1 * (np.abs(rng.randn(B, S, n)) + 0.05))
    A1, A2 = mk(N1), mk(N2)
    a3 = np.float32(np.abs(rng.randn(B, S, 1)) + 0.05)
    y = np.float32(np.abs(rng.randn(B, S)))
    args = tuple(jnp.asarray(x) for x in (A1, A2, a3, y))
    cand, vals, ysq, ok = f32scan.df3_twopass(*args, M=1, R=64)
    cand0, vals0, _ = dfscan.df3_candidates(*args, M=1)
    ok = np.asarray(ok)
    assert ok.all()
    assert np.array_equal(np.asarray(cand)[:, 0], np.asarray(cand0)[:, 0])
    np.testing.assert_allclose(np.asarray(vals)[:, 0],
                               np.asarray(vals0)[:, 0],
                               rtol=1e-5, atol=1e-7)
