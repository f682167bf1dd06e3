"""Smoke test of the fingerprinting fit on one NVIDIA GPU.

Drives the production path once at full width (552 sequences x 782 atoms,
10 EAR diffusivities) and checks it against the float64 host oracle
(ops/nnls.solve_exhaustive_posweights):

  0. device: platform, kind, count, JAX version, card name and power limit;
  1. numerics: the ops/df32 error-free transforms bit-exact against float64
     under jit and inside a lax.scan body, quantize3 exactness, and the
     error of the exact Grams against a float64 Gram;
  2. kernels on one 512-voxel chunk of noisy voxels: every row-pass
     interval holds its float64 row minimum, the column gather is an exact
     copy, the two-pass chunk step and the EAR chunk (one-pass df4 scan)
     select the oracle's atoms, with each program's memory analysis and a
     profiler trace of one call;
  3. end to end: a .mat dictionary and NIfTI volumes written from --seed
     (--voxels voxels in a whole-brain bucket mix, Rician noise at SNR 30
     on b0) fitted through MFModel.fit and write_nifti, each bucket's
     sample checked against the oracle (runs before phase 2, so that its
     cold fit compiles every program itself);
  4. only with --four: MFModel.fit(parallel=True) of a 2-fascicle + CSF
     volume on 4 cards with meshes (4, 1) and (2, 2) against the 1-card
     fit of the same volume (--voxels 4096 keeps it short).

Tolerances against the oracle: identical atoms unless the oracle's own
objective at the device's choice is within 2e-9 ||y||^2 of its optimum,
objective within 2e-9 ||y||^2, fractions and R^2 within 1e-5.

Exits non-zero on any failed check, and before any result when JAX finds
no GPU. The last line of its output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Run:  python chip_smoke.py [--seed N] [--voxels N] [--four]
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

OBJ_TOL = 2e-9      # objective and atom-gap tolerance, relative to ||y||^2
FRAC_TOL = 1e-5     # fractions, weights (relative to M0) and R^2
# whole-brain bucket mix, (K, csf, ear): share (examples/whole_brain.py)
MIX = (((2, 1, 0), 0.62), ((2, 1, 1), 0.10), ((1, 1, 0), 0.16),
       ((2, 0, 0), 0.07), ((0, 1, 0), 0.05))
NUM_ATOM, NUM_EAR, CHUNK = 782, 10, 512
T0 = time.time()


def log(*args):
    print("[%7.1f s]" % (time.time() - T0), *args, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def dictionary(seed):
    """Full-width synthetic dictionary dict (MFModel's .mat contract)."""
    from microstructure_fingerprinting_tpu import testing as mft
    sch = mft.make_dense_scheme(n_shells=8, dirs_per_shell=64, n_b0=40)
    sig, d_par, d_perp = mft.make_dictionary(sch, num_atom=NUM_ATOM,
                                             seed=seed)
    return {"dictionary": sig, "sch_mat": sch,
            "orientation": np.array([0.0, 0.0, 1.0]),
            "num_atom": NUM_ATOM, "num_ear": NUM_EAR,
            "fasc_propnames": ["d_par", "d_perp"],
            "d_par": d_par, "d_perp": d_perp,
            "T2_csf": 2.0, "DIFF_csf": 3.0e-9, "T2_ear": 0.8,
            "DIFF_ear": np.linspace(0.8e-9, 2.6e-9, NUM_EAR)}


def compartments(dic):
    """CSF (S,) and EAR (S, E) fingerprints (reference mf.py formulas)."""
    from microstructure_fingerprinting_tpu.utils.scheme import b_values
    sch = dic["sch_mat"]
    TE, b = sch[:, 6], b_values(sch)
    csf = np.exp(-TE / dic["T2_csf"]) * np.exp(-b * dic["DIFF_csf"])
    ear = (np.exp(-TE / dic["T2_ear"])[:, None]
           * np.exp(-b[:, None] * dic["DIFF_ear"][None, :]))
    return csf, ear


def oracle(cols, y, choice):
    """float64 exhaustive NNLS over the blocks ``cols`` (list of (S, n_k))
    for signal y. Returns (objective at the optimum, indices, weights,
    objective at the device's ``choice`` of one index per block)."""
    import scipy.optimize
    from microstructure_fingerprinting_tpu.ops import nnls
    A = np.concatenate(cols, axis=1)
    sizes = np.array([c.shape[1] for c in cols])
    w, ind, _tot, obj, _rec = nnls.solve_exhaustive_posweights(A, y, sizes)
    picked = np.stack([c[:, i] for c, i in zip(cols, choice)], axis=1)
    _w, rn = scipy.optimize.nnls(picked, y)
    return obj, np.asarray(ind), np.asarray(w), rn * rn


def compare(tag, y, obj_or, ind_or, w_or, obj_choice, ind, obj, frac, r2,
            r2_or, stats):
    """One voxel against the oracle; tallies into ``stats``."""
    ysq = float(y @ y)
    same = np.array_equal(np.asarray(ind), ind_or)
    check(same or obj_choice - obj_or <= OBJ_TOL * ysq,
          "%s: atoms %s vs oracle %s, gap %.3g ||y||^2"
          % (tag, list(ind), list(ind_or), (obj_choice - obj_or) / ysq))
    check(abs(obj - obj_or) <= OBJ_TOL * ysq,
          "%s: objective %.9g vs oracle %.9g" % (tag, obj, obj_or))
    if same:
        m0 = float(np.sum(w_or))
        f_or = w_or / m0 if m0 > 0 else w_or
        check(np.max(np.abs(frac - f_or)) <= FRAC_TOL,
              "%s: fractions %s vs oracle %s" % (tag, frac, f_or))
    check(abs(r2 - r2_or) <= FRAC_TOL, "%s: R2 %.8f vs oracle %.8f"
          % (tag, r2, r2_or))
    stats["voxels"] += 1
    stats["ties"] += int(not same)
    stats["max_obj_gap"] = max(stats["max_obj_gap"],
                               abs(obj - obj_or) / ysq)


def r_squared(y, y_rec):
    yc, rc = y - y.mean(), y_rec - y_rec.mean()
    den = np.sqrt((yc @ yc) * (rc @ rc))
    return float((yc @ rc) / den) ** 2 if den > 0 else 0.0


# ---------------------------------------------------------------- phases

def phase_device():
    import jax
    dev = jax.devices()[0]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    log("phase 0: device %s (%s), %d device(s), jax %s"
        % (dev.device_kind, dev.platform, len(jax.devices()),
           jax.__version__))
    print(smi.splitlines()[0], flush=True)


def phase_numerics(seed):
    import jax
    import jax.numpy as jnp
    from jax import lax
    from microstructure_fingerprinting_tpu.ops import df32, dfscan, f32scan
    rng = np.random.default_rng(seed)
    n = 1 << 20
    a = (rng.standard_normal(n) * np.exp(rng.uniform(-8, 8, n))
         ).astype(np.float32)
    b = (rng.standard_normal(n) * np.exp(rng.uniform(-8, 8, n))
         ).astype(np.float32)
    A, B = a.astype(np.float64), b.astype(np.float64)

    def transforms(a, b):
        s, e = df32.two_sum(a, b)
        ah, al = df32.split(a)
        p, pe = df32.two_prod(a, b)
        z = jnp.zeros_like(a)
        mp, me = df32.mul_ps(df32.presplit((a, z)), df32.presplit((b, z)))
        return s, e, ah, al, p, pe, mp, me

    scanned = jax.jit(lambda a, b: lax.scan(
        lambda c, x: (c, transforms(*x)), 0.0,
        (a.reshape(256, -1), b.reshape(256, -1)))[1])
    for how, fn in (("jit", jax.jit(transforms)), ("scan", scanned)):
        out = [np.asarray(o).reshape(-1) for o in fn(a, b)]
        s, e, ah, al, p, pe, mp, me = (o.astype(np.float64) for o in out)
        low12 = out[2].view(np.uint32) & np.uint32(0xFFF)
        for name, ok in (("two_sum", s + e == A + B),
                         ("split", (ah + al == A) & (low12 == 0)),
                         ("two_prod", p + pe == A * B),
                         ("mul_ps", mp + me == A * B)):
            check(ok.all(), "%s under %s: %d of %d pairs not exact"
                  % (name, how, int((~ok).sum()), n))
    log("phase 1: two_sum, split, two_prod, mul_ps exact on %d pairs "
        "(jit and scan)" % n)

    X = rng.uniform(-0.99, 0.99, (4, 552, NUM_ATOM)).astype(np.float32)
    Q1, Q2, Q3, R, a3 = (np.asarray(o) for o in
                         jax.jit(dfscan.quantize3)(jnp.asarray(X)))
    lv = (Q1.astype(np.float64) * 2.0 ** -7 + Q2.astype(np.float64) * 2.0 ** -15
          + Q3.astype(np.float64) * 2.0 ** -23)
    check(np.array_equal(lv, a3.astype(np.float64))
          and np.array_equal(a3.astype(np.float64) + R, X.astype(np.float64)),
          "quantize3 decomposition not exact")
    log("phase 1: quantize3 exact on %d values" % X.size)

    An = X / np.linalg.norm(X.astype(np.float64), axis=1, keepdims=True)
    An = An.astype(np.float32)
    G64 = np.einsum("bsn,bsm->bnm", An.astype(np.float64),
                    An.astype(np.float64))
    qa = dfscan.quantize2(jnp.asarray(An))
    hi, lo = jax.jit(lambda q: dfscan.df_gram(q, q, "bsn,bsm->bnm"))(qa)
    err_df = np.max(np.abs(np.asarray(hi, np.float64)
                           + np.asarray(lo, np.float64) - G64))
    q3 = dfscan.quantize3(jnp.asarray(An))
    g3 = jax.jit(lambda q: f32scan._gram3_hi(q, q, "bsn,bsm->bnm"))(q3)
    err_g3 = np.max(np.abs(np.asarray(g3, np.float64) - G64))
    log("phase 1: Gram error vs float64 at 552 sequences: df_gram %.3g, "
        "_gram3_hi %.3g" % (err_df, err_g3))
    check(err_df <= 1e-10, "df_gram error %.3g above 1e-10" % err_df)
    check(err_g3 <= 2 * 1.1920929e-07, "_gram3_hi error %.3g above 2 eps"
          % err_g3)


def row_minima(cols_n, yn):
    """float64 per-row minima (over i2 and the CSF block) of the
    normalized [N1, N2, 1] problem, and the block-1-free floor."""
    from microstructure_fingerprinting_tpu.ops import nnls
    A1, A2, a3 = cols_n
    Y1, Y2, Y3 = A1.T @ yn, A2.T @ yn, float(a3[:, 0] @ yn)
    g13, g23 = A1.T @ a3[:, 0], A2.T @ a3[:, 0]
    res = nnls.lsqnonneg_3var(
        1.0, 1.0, 1.0, 1.0, A1.T @ A2, g13[:, None], g23[None, :],
        Y1[:, None], Y2[None, :], Y3, xp=np)[3]
    floor = np.min(nnls.lsqnonneg_2var(1.0, 1.0, g23, 1.0, Y2, Y3,
                                       xp=np)[2])
    return np.min(nnls._sanitize(res, np), axis=1), floor


def trace_step(name, comp, args):
    """One call of a compiled chunk step under the profiler: device busy
    time, idle share and the ops that take most of it."""
    import glob
    import jax
    from microstructure_fingerprinting_tpu.utils import profiling
    with tempfile.TemporaryDirectory() as d:
        with profiling.device_trace(d):
            jax.block_until_ready(comp(*args))
        totals, busy, window = profiling.device_op_times(d)
        if not totals:
            data = jax.profiler.ProfileData.from_file(
                glob.glob(os.path.join(d, "**", "*.xplane.pb"),
                          recursive=True)[0])
            log("phase 2: %s trace has no GPU ops; planes: %s" % (name, [
                (p.name, [ln.name for ln in p.lines]) for p in data.planes]))
            return
    tot = sum(totals.values())
    log("phase 2: %s trace: device busy %.3f ms of a %.3f ms window "
        "(idle share %.3f)" % (name, busy / 1e6, window / 1e6,
                               1 - busy / window))
    for op, ns in sorted(totals.items(), key=lambda kv: -kv[1])[:8]:
        log("phase 2:    %8.3f ms %5.1f%%  %s" % (ns / 1e6, 100 * ns / tot,
                                                 op[:80]))


def phase_kernels(seed, dic):
    import jax
    import jax.numpy as jnp
    from functools import partial
    from microstructure_fingerprinting_tpu import config
    from microstructure_fingerprinting_tpu.ops import interp as mfi
    from microstructure_fingerprinting_tpu.ops import dfscan, f32scan
    from microstructure_fingerprinting_tpu.models import fit as fit_mod
    rng = np.random.default_rng(seed + 1)
    sch = dic["sch_mat"]
    S = sch.shape[0]
    ms = mfi.init_PGSE_multishell_interp(dic["dictionary"], sch,
                                         dic["orientation"])
    plan = mfi.plan_target_scheme(ms, sch)
    _xs, ys_t, _cnt = ms.device_tables()
    rot, perm = mfi.make_grouped_rotation_paired(ms, plan)
    dirs = rng.standard_normal((CHUNK, 2, 3))
    dirs /= np.linalg.norm(dirs, axis=2, keepdims=True)
    D = rot(ys_t, jnp.asarray(dirs, jnp.float32))
    D64 = np.asarray(D, np.float64)
    csf, ear = compartments(dic)
    csf, ear = csf[perm], ear[perm]
    ids = rng.integers(0, NUM_ATOM, (CHUNK, 2))
    eids = rng.integers(0, NUM_EAR, CHUNK)
    nu = rng.dirichlet(np.ones(4), CHUNK)
    v = np.arange(CHUNK)
    y0 = 400 * (nu[:, :1] * D64[v, 0, :, ids[:, 0]]
                + nu[:, 1:2] * D64[v, 1, :, ids[:, 1]]
                + nu[:, 2:3] * csf[None] + nu[:, 3:] * ear[:, eids].T)
    sigma = 400 / 30
    y_np = np.sqrt((y0 + sigma * rng.standard_normal(y0.shape)) ** 2
                   + (sigma * rng.standard_normal(y0.shape)) ** 2)
    y_np = y_np.astype(np.float32)
    y = jnp.asarray(y_np)
    csf_d = jnp.asarray(csf.astype(np.float32))
    ear_d = jnp.asarray(ear.astype(np.float32))
    csf_blk = jnp.broadcast_to(csf_d[None, :, None], (CHUNK, S, 1))
    csf32 = np.asarray(csf_d, np.float64)
    ear32 = np.asarray(ear_d, np.float64)

    # row-pass intervals against float64 row minima
    lo, up, upf = (np.asarray(o, np.float64) for o in
                   f32scan.rowmin_3(D[:, 0], D[:, 1], csf_blk, y))
    n_chk = 16
    nrm = lambda M: M / np.linalg.norm(M, axis=0, keepdims=True)
    for b in range(n_chk):
        yb = y_np[b].astype(np.float64)
        rows, floor = row_minima(
            [nrm(D64[b, 0]), nrm(D64[b, 1]), nrm(csf32[:, None])],
            yb / np.linalg.norm(yb))
        low = np.minimum(lo[b], floor)
        high = np.minimum(up[b], upf[b])
        bad = (rows < low - 1e-12) | (rows > high + 1e-12)
        check(not bad.any(), "rowmin_3 voxel %d: %d row intervals miss the "
              "float64 row minimum" % (b, int(bad.sum())))
    log("phase 2: rowmin_3 intervals hold the float64 row minima on %d "
        "voxels x %d rows" % (n_chk, NUM_ATOM))

    idx = jnp.asarray(rng.integers(0, NUM_ATOM, (CHUNK, 128)), jnp.int32)
    got = np.asarray(jax.jit(f32scan._gather_cols)(D[:, 0], idx))
    want = np.take_along_axis(np.asarray(D[:, 0]),
                              np.asarray(idx)[:, None, :], axis=2)
    check(np.array_equal(got, want), "_gather_cols is not an exact copy")
    log("phase 2: _gather_cols bit-exact")

    R = config.DEFAULTS["solver"].twopass_rows

    @jax.jit
    def ear_chunk(D, csf_d, ear_d, y):
        """The EAR bucket's chunk, as run_bucket_fast runs it: one-pass
        df4 scan + device finalize."""
        cand, _v, _q = dfscan.df4_candidates(
            D[:, 0], D[:, 1],
            jnp.broadcast_to(csf_d[None, :, None], (CHUNK, S, 1)),
            jnp.broadcast_to(ear_d[None], (CHUNK, S, NUM_EAR)), y, M=1)
        w, obj, r2 = fit_mod._finalize_top1(D, csf_d, ear_d, y, cand[:, 0],
                                            csf_on=True, ear_on=True, K=2)
        return cand[:, 0], w, obj, r2, jnp.ones(y.shape[0], bool)

    for name, step, args, n_chk in (
            ("_twopass_step3", partial(fit_mod._twopass_step3, R=R),
             (D, csf_d, y), 32),
            ("EAR chunk (df4_candidates + _finalize_top1)", ear_chunk,
             (D, csf_d, ear_d, y), 8)):
        ear_on = name.startswith("EAR")
        t0 = time.time()
        comp = jax.jit(step).lower(*args).compile()
        log("phase 2: %s compiled in %.1f s; memory_analysis: %s"
            % (name, time.time() - t0, comp.memory_analysis()))
        cand, w, obj, r2, ok = (np.asarray(o) for o in comp(*args))
        trace_step(name, comp, args)
        stats = {"voxels": 0, "ties": 0, "max_obj_gap": 0.0}
        checked = 0
        for b in range(CHUNK):
            if checked == n_chk:
                break
            if not ok[b]:
                continue
            yb = y_np[b].astype(np.float64)
            cols = [D64[b, 0], D64[b, 1], csf32[:, None]]
            choice = [cand[b, 0], cand[b, 1], 0]
            if ear_on:
                cols.append(ear32)
                choice.append(cand[b, -1])
            o_or, i_or, w_or, o_ch = oracle(cols, yb, choice)
            y_rec = np.concatenate(cols, axis=1)[
                :, np.cumsum([0] + [c.shape[1] for c in cols[:-1]])
                + i_or] @ w_or
            wd = w[b].astype(np.float64)
            compare("%s voxel %d" % (name, b), yb, o_or, i_or, w_or, o_ch,
                    choice, float(np.sum(obj[b], dtype=np.float64)),
                    wd / np.sum(wd), float(r2[b]),
                    r_squared(yb, y_rec), stats)
            checked += 1
        check(checked == n_chk, "%s: fewer than %d in-budget voxels"
              % (name, n_chk))
        log("phase 2: %s winners match the oracle on %d voxels (%d exact "
            "ties), overflow %d/%d" % (name, stats["voxels"], stats["ties"],
                                       int((~ok).sum()), CHUNK))


def write_inputs(dic, seed, n_vox, out, mix=MIX):
    """Dictionary .mat, scheme text and NIfTI volumes of ``n_vox`` voxels
    in the ``mix`` proportions, signals with Rician noise at SNR 30 on
    b0."""
    import jax.numpy as jnp
    from microstructure_fingerprinting_tpu.ops import interp as mfi
    from microstructure_fingerprinting_tpu.utils import io as mfio
    from microstructure_fingerprinting_tpu.utils import nifti
    from microstructure_fingerprinting_tpu.ops.noise import gen_SoS_MRI
    rng = np.random.default_rng(seed + 2)
    sch = dic["sch_mat"]
    S = sch.shape[0]
    counts = [int(round(share * n_vox)) for _c, share in mix]
    counts[0] += n_vox - sum(counts)
    cfg = np.repeat(np.arange(len(mix)), counts)
    rng.shuffle(cfg)
    K = np.array([c[0] for c, _s in mix])[cfg]
    csf_m = np.array([c[1] for c, _s in mix])[cfg]
    ear_m = np.array([c[2] for c, _s in mix])[cfg]
    dirs = rng.standard_normal((n_vox, 2, 3))
    dirs /= np.linalg.norm(dirs, axis=2, keepdims=True)
    ids = rng.integers(0, NUM_ATOM, (n_vox, 2))
    eids = rng.integers(0, NUM_EAR, n_vox)
    nu = rng.dirichlet(np.ones(4), n_vox)
    nu *= np.stack([K >= 1, K >= 2, csf_m > 0, ear_m > 0], axis=1)
    nu /= nu.sum(axis=1, keepdims=True)
    ms = mfi.init_PGSE_multishell_interp(dic["dictionary"], sch,
                                         dic["orientation"])
    plan = mfi.plan_target_scheme(ms, sch)
    xs, ys_t, cnt = ms.device_tables()
    csf, ear = compartments(dic)
    y0 = np.zeros((n_vox, S))
    for st in range(0, n_vox, 1024):
        sl = slice(st, min(st + 1024, n_vox))
        D = mfi.eval_rotation_batch(
            xs, ys_t, cnt, jnp.asarray(plan.gdir, xs.dtype),
            jnp.asarray(plan.shell_lo), jnp.asarray(plan.shell_hi),
            jnp.asarray(plan.wG, xs.dtype), jnp.asarray(dirs[sl], xs.dtype))
        cols = np.asarray(jnp.take_along_axis(
            D, jnp.asarray(ids[sl])[:, :, None, None], axis=3)[..., 0])
        y0[sl] = (np.einsum("vk,vks->vs", nu[sl, :2], cols)
                  + nu[sl, 2:3] * csf[None] + nu[sl, 3:] * ear[:, eids[sl]].T)
    np.random.seed(seed)
    y = gen_SoS_MRI(400 * y0, sigma_g=400 / 30, N=1)
    side = round(n_vox ** (1 / 3))
    shape = (side, side, n_vox // side ** 2) if side ** 3 == n_vox \
        else (n_vox, 1, 1)
    aff = np.diag([2.0, 2.0, 2.0, 1.0])
    peaks = np.where((np.arange(2)[None, :, None] < K[:, None, None]),
                     dirs, 0.0).reshape(n_vox, 6)
    vols = {"dwi": y.astype(np.float32).reshape(shape + (S,)),
            "mask": np.ones(shape),
            "numfasc": K.reshape(shape).astype(np.float64),
            "peaks": peaks.reshape(shape + (6,)),
            "csf_mask": csf_m.reshape(shape).astype(np.float64),
            "ear_mask": ear_m.reshape(shape).astype(np.float64)}
    paths = {}
    for name, vol in vols.items():
        paths[name] = os.path.join(out, name + ".nii")
        nifti.save(nifti.Nifti1Image(vol, aff), paths[name])
    paths["dic"] = os.path.join(out, "dic.mat")
    mfio.savemat(paths["dic"], dic)
    paths["scheme"] = os.path.join(out, "scheme.txt")
    np.savetxt(paths["scheme"], sch, header="VERSION: 1", comments="")
    return paths, {"K": K, "csf": csf_m, "ear": ear_m,
                   "y": y.astype(np.float32), "dirs": peaks}


def fit_volume(paths, model=None, **kw):
    from microstructure_fingerprinting_tpu import MFModel
    model = model or MFModel(paths["dic"])
    fit = model.fit(paths["dwi"], paths["mask"], paths["numfasc"],
                    peaks=paths["peaks"], pgse_scheme=paths["scheme"],
                    csf_mask=paths["csf_mask"], ear_mask=paths["ear_mask"],
                    verbose=0, **kw)
    return model, fit


def fitted_indices(fit, dic, truth):
    """Per-voxel (i1, i2, i_ear) recovered from the property maps (the
    dictionary's (d_par, d_perp) pairs are unique), -1 where unused."""
    key = {(p, q): i for i, (p, q) in enumerate(zip(dic["d_par"],
                                                    dic["d_perp"]))}
    n = truth["K"].size
    out = np.full((n, 3), -1)
    for k in range(2):
        par = getattr(fit, "d_par_f%d" % k).reshape(n)
        per = getattr(fit, "d_perp_f%d" % k).reshape(n)
        frac = getattr(fit, "frac_f%d" % k).reshape(n)
        for v in np.flatnonzero(frac > 0):
            out[v, k] = key[(par[v], per[v])]
    if "D_ear" in fit.param_names:
        d_ear = fit.D_ear.reshape(n)
        for v in np.flatnonzero(fit.frac_ear.reshape(n) > 0):
            out[v, 2] = int(np.argmin(np.abs(dic["DIFF_ear"] - d_ear[v])))
    return out


def phase_end_to_end(seed, n_vox, dic, out):
    import jax
    import jax.numpy as jnp
    from microstructure_fingerprinting_tpu.ops import interp as mfi
    from microstructure_fingerprinting_tpu.utils import nifti
    t0 = time.time()
    paths, truth = write_inputs(dic, seed, n_vox, out)
    log("phase 3: wrote %d-voxel inputs in %.1f s" % (n_vox, time.time() - t0))
    t0 = time.time()
    model, fit = fit_volume(paths)
    cold = time.time() - t0
    t0 = time.time()
    model, fit = fit_volume(paths, model)
    warm = time.time() - t0
    files = fit.write_nifti(os.path.join(out, "maps", "mf.nii"))
    check(len(files) == len(fit.param_names), "write_nifti wrote %d of %d "
          "maps" % (len(files), len(fit.param_names)))
    back = nifti.load(files[-1]).get_fdata()
    check(np.array_equal(back, fit.R2), "R2 map does not reload exactly")
    active = (truth["K"] + truth["csf"] + truth["ear"]) > 0
    log("phase 3: cold fit (compile included) %.1f s, warm fit %.1f s: "
        "%.0f voxels/s (smoke figure, one card)"
        % (cold, warm, active.sum() / warm))
    log("phase 3: peak_bytes_in_use %d"
        % jax.devices()[0].memory_stats()["peak_bytes_in_use"])
    for cfg, info in sorted(fit.buckets.items()):
        log("phase 3: bucket %s: %s" % (cfg, info))

    # oracle on each bucket's sample, with the columns the device used
    sch = dic["sch_mat"]
    S = sch.shape[0]
    rot, perm = model._grouped_rotator(
        mfi.plan_target_scheme(model.ms_interpolator, sch), sch)
    _xs, ys_t, _cnt = model.ms_interpolator.device_tables()
    csf, ear = compartments(dic)
    csf32 = csf[perm].astype(np.float32).astype(np.float64)
    ear32 = ear[perm].astype(np.float32).astype(np.float64)
    got = fitted_indices(fit, dic, truth)
    n = n_vox
    maps = {name: getattr(fit, name).reshape(n) for name in fit.param_names
            if getattr(fit, name).ndim == 3}
    for cfg, _share in MIX:
        K, c_on, e_on = cfg
        sel = np.flatnonzero((truth["K"] == K) & (truth["csf"] == c_on)
                             & (truth["ear"] == e_on))
        sel = sel[:8 if e_on else 32]
        if K:
            # rotate at the fit's chunk size: the same compiled program,
            # so the oracle sees exactly the columns the device scanned
            dirs = np.zeros((CHUNK, K, 3))
            dirs[:] = truth["dirs"][sel[0]].reshape(2, 3)[:K]
            D = []
            for st in range(0, sel.size, CHUNK):
                part = sel[st:st + CHUNK]
                dirs[:part.size] = truth["dirs"][part].reshape(-1, 2, 3)[:, :K]
                D.append(np.asarray(rot(ys_t, jnp.asarray(
                    dirs, jnp.float32)), np.float64)[:part.size])
            D = np.concatenate(D)
        stats = {"voxels": 0, "ties": 0, "max_obj_gap": 0.0}
        for j, v in enumerate(sel):
            yb = truth["y"][v][perm].astype(np.float64)
            cols = [D[j, k] for k in range(K)]
            choice = [max(got[v, k], 0) for k in range(K)]
            if c_on:
                cols.append(csf32[:, None])
                choice.append(0)
            if e_on:
                cols.append(ear32)
                choice.append(max(got[v, 2], 0))
            o_or, i_or, w_or, o_ch = oracle(cols, yb, choice)
            frac = [maps["frac_f%d" % k][v] for k in range(K)]
            if c_on:
                frac.append(maps["frac_csf"][v])
            if e_on:
                frac.append(maps["frac_ear"][v])
            # an unused block's atom is arbitrary: compare used ones only
            i_cmp = np.where(w_or > 0, i_or, np.asarray(choice))
            starts = np.cumsum([0] + [c.shape[1] for c in cols[:-1]])
            y_rec = np.concatenate(cols, axis=1)[:, starts + i_or] @ w_or
            compare("bucket %s voxel %d" % (cfg, v), yb, o_or, i_cmp, w_or,
                    o_ch, choice, maps["MSE"][v] * S, np.asarray(frac),
                    maps["R2"][v], r_squared(yb, y_rec), stats)
        log("phase 3: bucket %s matches the oracle on %d voxels (%d exact "
            "ties, max |objective gap| %.3g ||y||^2)"
            % (cfg, stats["voxels"], stats["ties"], stats["max_obj_gap"]))


def phase_four(seed, n_vox, dic, out):
    """The 2-fascicle + CSF bucket, the one with mesh-specific routes: the
    two-pass step in a data-parallel shard_map on mesh (4, 1), the
    atom-sharded one-pass scan on mesh (2, 2)."""
    import jax
    check(len(jax.devices()) >= 4, "--four needs 4 devices, found %d"
          % len(jax.devices()))
    paths, truth = write_inputs(dic, seed, n_vox, out,
                                mix=(((2, 1, 0), 1.0),))
    n = n_vox
    fits = {}
    for name, kw in (("1 card", {}),
                     ("mesh (4, 1)", {"parallel": True}),
                     ("mesh (2, 2)", {"parallel": True,
                                      "mesh_shape": (2, 2)})):
        t0 = time.time()
        _model, fits[name] = fit_volume(paths, batch_size=CHUNK, **kw)
        log("phase 4: %s fit in %.1f s, scans %s" % (
            name, time.time() - t0,
            {c: i.get("scan", i["route"])
             for c, i in sorted(fits[name].buckets.items())}))
    ref = fits["1 card"]
    ind_ref = fitted_indices(ref, dic, truth)
    obj_ref = ref.MSE.reshape(n)
    for name in ("mesh (4, 1)", "mesh (2, 2)"):
        ind = fitted_indices(fits[name], dic, truth)
        obj = fits[name].MSE.reshape(n)
        check(np.array_equal(ind, ind_ref), "%s: atom indices differ on %d "
              "voxels" % (name, int(np.any(ind != ind_ref, axis=1).sum())))
        rel = np.abs(obj - obj_ref) / np.maximum(np.abs(obj_ref), 1e-30)
        check(np.max(rel) <= 1e-6, "%s: objective differs by %.3g relative"
              % (name, np.max(rel)))
        log("phase 4: %s == 1 card on %d voxels (max relative objective "
            "difference %.3g)" % (name, n, np.max(rel)))
    for d in jax.devices():
        log("phase 4: %s peak_bytes_in_use %d"
            % (d, d.memory_stats()["peak_bytes_in_use"]))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--voxels", type=int, default=32768,
                    help="voxels of the end-to-end volume")
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card mesh comparison")
    args = ap.parse_args()
    import jax
    if jax.devices()[0].platform != "gpu":
        sys.exit("chip_smoke: JAX found no GPU (platform %r)"
                 % jax.devices()[0].platform)
    phase_device()
    dic = dictionary(args.seed)
    with tempfile.TemporaryDirectory() as out:
        if args.four:
            phase_four(args.seed, args.voxels, dic, out)
        else:
            phase_numerics(args.seed)
            phase_end_to_end(args.seed, args.voxels, dic, out)
            phase_kernels(args.seed, dic)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
