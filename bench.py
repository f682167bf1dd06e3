"""Benchmark: exhaustive-NNLS fingerprinting fit throughput (voxels/s/chip).

Workload: the reference's flagship configuration — 2 rotated fascicle
sub-dictionaries + CSF on a 552-sequence dense multi-shell protocol with 782
atoms per fascicle (dicsizes [782, 782, 1]; reference mf_utils.py:462-465) —
run through the fused rotation + Gram + candidate-scan device step. The EAR
bucket (dicsizes [782, 782, 1, 10]; the UK-Biobank configuration of
reference mf.py:922-934) is reported as a secondary key.

Baseline: an optimized CPU implementation of the reference algorithm
(BLAS Gram + fully vectorized closed-form candidate evaluation in NumPy
float64 — strictly faster than the reference's scalar Numba loops on this
machine, so `vs_baseline` is conservative). Measured on a few voxels and
extrapolated.

Runs on one GPU and refuses any other backend. Prints the result as ONE
JSON line {"metric", "value", "unit", "vs_baseline", ...}, twice on a full
run: once right after the main-bucket measurement and once merged with the
EAR measurement. Progress goes to stderr. The EAR measurement is skipped
when the `MF_BENCH_BUDGET` wall-clock budget (default 480 s) is nearly
exhausted.
"""

import json
import os
import sys
import time

import numpy as np

T0 = time.time()

NUM_ATOM = 782
N_VOX_BATCH = 2048
N_BATCHES = 5
CHUNK = 512
BUDGET_S = float(os.environ.get("MF_BENCH_BUDGET", 480))


def _log(msg):
    print("[bench %6.1fs] %s" % (time.time() - T0, msg), file=sys.stderr,
          flush=True)


def _emit(vox_per_s, base, ear_vox_per_s=None):
    rec = {
        "metric": "fit_throughput_2fasc_csf_552seq_782atoms",
        "value": round(vox_per_s, 2),
        "unit": "voxels/sec/chip",
        "vs_baseline": round(vox_per_s / base, 2),
        "selection": "exact-f64-grade (double-float scan)",
    }
    if ear_vox_per_s is not None:
        rec["ear_bucket_value"] = round(ear_vox_per_s, 2)
    print(json.dumps(rec), flush=True)


def _make_ear(wl):
    from microstructure_fingerprinting_tpu.utils.scheme import b_values
    sch = wl["sch_mat"]
    TE, b = sch[:, 6], b_values(sch)
    Dear = np.linspace(0.8e-9, 2.6e-9, 10)
    sig_ear = np.exp(-TE / 0.8)[:, None] * np.exp(-b[:, None] * Dear[None])
    # full-size EAR bucket: production UKBB buckets hold thousands of
    # voxels, so the (rare) overflow-tier re-solves amortize across chunks
    y_ear = wl["y"] + 35 * sig_ear[:, 4][None, :]
    return sig_ear, y_ear


def _measure_main(wl, rotator):
    """Throughput of the production fit path: grouped-matmul rotation +
    double-float candidate scan (exact f64-grade selection) on the
    2-fascicle + CSF bucket (models/fit.run_bucket_fast — what
    MFModel.fit uses on the GPU)."""
    from microstructure_fingerprinting_tpu.models.fit import run_bucket_fast
    ms, plan = wl["msinterp"], wl["plan"]
    _xs, ys_t, _cnt = ms.device_tables()
    peaks = wl["peaks"].reshape(N_VOX_BATCH, 6)

    def step(defer=False):
        return run_bucket_fast(ms, plan, ys_t, peaks, wl["y"],
                               wl["sig_csf"], 2, True, batch=CHUNK,
                               topm=16, rotator=rotator, defer=defer)

    step()  # compile + warm
    _log("main bucket warm; measuring")

    # cross-bucket pipelining, as MFModel.fit runs it: all buckets'
    # host->device pushes and device work are dispatched up front
    # (deferred), then pulled in order — bucket N+1's push/compute
    # overlaps bucket N's pull. Timed over the whole pipelined run.
    def one_pass():
        t0 = time.time()
        pend = [step(defer=True) for _ in range(N_BATCHES)]
        for fin in pend:
            fin()
        return N_BATCHES * N_VOX_BATCH / (time.time() - t0)

    return float(np.median([one_pass() for _ in range(3)]))


def _measure_ear(wl, rotator, sig_ear, y_ear):
    """EAR bucket (2 fascicles + CSF + EAR, dicsizes [N, N, 1, 10])."""
    from microstructure_fingerprinting_tpu.models.fit import run_bucket_fast
    ms, plan = wl["msinterp"], wl["plan"]
    _xs, ys_t, _cnt = ms.device_tables()
    n_ear = y_ear.shape[0]
    peaks = wl["peaks"].reshape(N_VOX_BATCH, 6)[:n_ear]

    def step_ear(defer=False):
        return run_bucket_fast(ms, plan, ys_t, peaks, y_ear,
                               wl["sig_csf"], 2, True, batch=CHUNK,
                               topm=16, rotator=rotator,
                               sig_ear=sig_ear, ear_on=True, defer=defer)

    step_ear()  # compile + warm
    _log("EAR bucket warm; measuring")
    n_rep = max(N_BATCHES - 2, 2)

    def one_pass():
        t0 = time.time()
        pend = [step_ear(defer=True) for _ in range(n_rep)]
        for fin in pend:
            fin()
        return n_rep * n_ear / (time.time() - t0)

    return float(np.median([one_pass() for _ in range(3)]))


def _cpu_reference_throughput(wl, n_probe=3):
    """Reference-algorithm CPU baseline (vectorized float64)."""
    from microstructure_fingerprinting_tpu.ops.interp import (
        interp_PGSE_from_multishell)
    ms = wl["msinterp"]
    sch = wl["sch_mat"]
    sig_csf = wl["sig_csf"]
    times = []
    for v in range(n_probe):
        y = wl["y"][v]
        t0 = time.time()
        # per-voxel dictionary rotation (the reference does this per voxel,
        # mf.py:391-397)
        D1 = interp_PGSE_from_multishell(sch, wl["peaks"][v, 0], msinterp=ms)
        D2 = interp_PGSE_from_multishell(sch, wl["peaks"][v, 1], msinterp=ms)
        D1 = np.asarray(D1, dtype=np.float64)
        D2 = np.asarray(D2, dtype=np.float64)
        # Gram via BLAS
        a11 = np.einsum("si,si->i", D1, D1)
        a22 = np.einsum("si,si->i", D2, D2)
        a33 = float(sig_csf @ sig_csf)
        A13 = D1.T @ sig_csf
        A23 = D2.T @ sig_csf
        Y1 = D1.T @ y
        Y2 = D2.T @ y
        Y3 = float(sig_csf @ y)
        y_sq = float(y @ y)
        # vectorized 3-var Cramer over the full N1 x N2 grid (i3 fixed)
        A11 = a11[:, None]
        A22 = a22[None, :]
        A12 = D1.T @ D2
        A13_ = A13[:, None]
        A23_ = A23[None, :]
        Y1_ = Y1[:, None]
        Y2_ = Y2[None, :]
        D1c = (Y1_ * (A22 * a33 - A23_ ** 2) - Y2_ * (A12 * a33 - A23_ * A13_)
               + Y3 * (A12 * A23_ - A22 * A13_))
        D2c = (-Y1_ * (A12 * a33 - A13_ * A23_)
               + Y2_ * (A11 * a33 - A13_ ** 2)
               - Y3 * (A11 * A23_ - A12 * A13_))
        D3c = (Y1_ * (A12 * A23_ - A13_ * A22) - Y2_ * (A11 * A23_
               - A12 * A13_) + Y3 * (A11 * A22 - A12 ** 2))
        Dd = (A11 * (A22 * a33 - A23_ ** 2) - A12 * (A12 * a33 - A23_ * A13_)
              + A13_ * (A12 * A23_ - A22 * A13_))
        with np.errstate(all="ignore"):
            w1, w2, w3 = D1c / Dd, D2c / Dd, D3c / Dd
            res = (y_sq + w1 * w1 * A11 + w2 * w2 * A22 + w3 * w3 * a33
                   + 2 * (w1 * w2 * A12 + w1 * w3 * A13_ + w2 * w3 * A23_
                          - w1 * Y1_ - w2 * Y2_ - w3 * Y3))
        ok = (D1c >= 0) & (D2c >= 0) & (D3c >= 0)
        res = np.where(ok & np.isfinite(res), res, np.inf)
        int(np.argmin(res))  # selection
        times.append(time.time() - t0)
    # fastest probe = the baseline machine's true capability (host-side
    # scheduling noise only ever slows a probe); conservative for
    # vs_baseline, and far stabler run-to-run than the median
    return 1.0 / float(np.min(times))


def main():
    import jax
    if jax.devices()[0].platform != "gpu":
        sys.exit("bench.py measures the GPU; JAX found %r"
                 % jax.devices()[0].platform)
    import microstructure_fingerprinting_tpu as mf
    from microstructure_fingerprinting_tpu import testing as mft
    from microstructure_fingerprinting_tpu.ops import interp as mfi
    mf.enable_compile_cache()
    _log("synthesizing workload")
    wl = mft.make_fit_workload(num_atom=NUM_ATOM, n_vox=N_VOX_BATCH)
    sig_ear, y_ear = _make_ear(wl)
    _log("CPU reference baseline")
    base = _cpu_reference_throughput(wl)
    _log("baseline %.1f vox/s" % base)

    ms, plan = wl["msinterp"], wl["plan"]
    rotator = mfi.make_grouped_rotation_paired(ms, plan)
    vox_per_s = _measure_main(wl, rotator)
    _emit(vox_per_s, base)          # headline lands before any EAR work
    _log("main %.1f vox/s" % vox_per_s)

    if time.time() - T0 > BUDGET_S - 60:
        _log("budget nearly exhausted; skipping the EAR measurement")
        return
    ear_vox_per_s = _measure_ear(wl, rotator, sig_ear, y_ear)
    _log("ear %.1f vox/s" % ear_vox_per_s)
    _emit(vox_per_s, base, ear_vox_per_s)


if __name__ == "__main__":
    main()
