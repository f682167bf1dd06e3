"""Measured selection exactness of the production fit path.

Plants noiseless atom mixtures from a UKBB-scale correlated dictionary
(986 zeppelin atoms — the atom count of the reference's UK-Biobank subject
fixture, tests/integration/fixtures/1000521_dictionary_hcp_deltas.mat) and
checks that the GPU production path (double-float candidate scan + on-device
double-float finalize, models/fit.run_bucket_fast) recovers them:

* 2 fascicles + CSF:  both fascicle atom IDs must match the planted ones
  exactly (the planted combination is the unique optimum).
* 2 fascicles + CSF + EAR (10 diffusivities): fascicle IDs must match
  exactly; the CSF/EAR split is genuinely ambiguous for nearly-collinear
  isotropic columns, so the check is optimality — the fitted combination's
  float64 residual must not exceed the planted combination's by more than
  1e-9 * ||y||^2 (the scan's design resolution).

Run:  python examples/exactness_check.py  [n_voxels]
"""

import os
import sys
import time

import numpy as np

# allow running from a source checkout without installation
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from microstructure_fingerprinting_tpu import testing as mft
from microstructure_fingerprinting_tpu.models.fit import run_bucket_fast
from microstructure_fingerprinting_tpu.ops.interp import (
    init_PGSE_multishell_interp, interp_PGSE_from_multishell)
from microstructure_fingerprinting_tpu.utils.scheme import b_values


def main(n_vox=128, num_atom=986, seed=11):
    import microstructure_fingerprinting_tpu as mf
    mf.enable_compile_cache()
    rng = np.random.RandomState(seed)
    sch = mft.make_dense_scheme(n_shells=8, dirs_per_shell=64, n_b0=40)
    sig, dpar, dperp = mft.make_dictionary(sch, num_atom=num_atom)
    ms = init_PGSE_multishell_interp(sig, sch, np.array([0.0, 0.0, 1.0]))
    from microstructure_fingerprinting_tpu.ops.interp import (
        plan_target_scheme)
    plan = plan_target_scheme(ms, sch)
    _xs, ys_t, _cnt = ms.device_tables()

    TE, b = sch[:, 6], b_values(sch)
    sig_csf = np.exp(-TE / 2.0) * np.exp(-b * 3.0e-9)
    Dear = np.linspace(0.8e-9, 2.6e-9, 10)
    sig_ear = np.exp(-TE / 0.8)[:, None] * np.exp(-b[:, None] * Dear[None])

    peaks = np.zeros((n_vox, 6))
    y = np.zeros((n_vox, sch.shape[0]))
    planted = []
    for v in range(n_vox):
        d1 = rng.randn(3); d1 /= np.linalg.norm(d1)
        d2 = rng.randn(3); d2 /= np.linalg.norm(d2)
        while abs(d1 @ d2) > 0.9:
            d2 = rng.randn(3); d2 /= np.linalg.norm(d2)
        a1, a2 = rng.randint(num_atom), rng.randint(num_atom)
        e = rng.randint(len(Dear))
        c1 = np.asarray(interp_PGSE_from_multishell(
            sch, d1, msinterp=ms))[:, a1]
        c2 = np.asarray(interp_PGSE_from_multishell(
            sch, d2, msinterp=ms))[:, a2]
        nu = np.array([0.4, 0.3, 0.15, 0.15])
        y[v] = 300.0 * (nu[0] * c1 + nu[1] * c2 + nu[2] * sig_csf
                        + nu[3] * sig_ear[:, e])
        peaks[v] = np.concatenate([d1, d2])
        planted.append((a1, a2, e))

    for ear_on in (False, True):
        kw = dict(sig_ear=sig_ear, ear_on=True) if ear_on else {}
        yy = y if ear_on else y - 300.0 * 0.15 * np.stack(
            [sig_ear[:, e] for (_a, _b, e) in planted])
        t0 = time.time()
        w_b, ind, obj, mse, r2 = run_bucket_fast(
            ms, plan, ys_t, peaks, yy, sig_csf, 2, True, batch=128, **kw)
        dt = time.time() - t0
        ysq = np.sum(yy.astype(np.float64) ** 2, axis=1)
        n_id = sum(int(ind[v, 0] == planted[v][0]
                       and ind[v, 1] == planted[v][1])
                   for v in range(n_vox))
        worst = float(np.max(obj / ysq))
        name = "2fasc+CSF+EAR" if ear_on else "2fasc+CSF"
        print("%-14s fascicle IDs exact %d/%d   max res/||y||^2 %.2e   "
              "(%.1f s incl. compile)" % (name, n_id, n_vox, worst, dt))
        assert n_id == n_vox, "fascicle atom recovery failed"
        assert worst < 1e-9, "fitted residual above scan resolution"
        if ear_on:
            n_e = sum(int(ind[v, 3] == planted[v][2])
                      for v in range(n_vox))
            print("%-14s EAR atom agreement %d/%d (ties below 1e-9 "
                  "resolution may pick an equally-optimal atom)"
                  % ("", n_e, n_vox))


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
