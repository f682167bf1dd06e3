"""Per-stage device timings of the fast fit path on one GPU.

Measures, at full width (552 sequences x 782 atoms, 512-voxel chunks, 10
EAR atoms): the rotation; the 2-fascicle+CSF two-pass stages (f32
interval row pass, row/column selection, gathers, double-float re-scan of
the R x R sub-grid, finalize) and the whole chunk step; the EAR bucket's
chunk (one-pass df4 scan + finalize); the row pass
with TF32 cross terms (what HIGHEST costs); the column gather as
take_along_axis vs a one-hot matmul at HIGHEST. Timings are medians of
``reps`` calls after a compiling first call, synchronized with
block_until_ready; the first call's time is printed as "compile+1".
With ``--trace DIR`` one main-bucket and one EAR chunk step run under the
profiler and the ops taking most device time are listed.

Run:  python examples/profile_stages.py [--trace DIR]
"""

import argparse
import os
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

# allow running from a source checkout without installation
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def timed(name, fn, reps):
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    t = float(np.median(ts))
    print("%-34s %9.2f ms   (compile+1 %6.1f s)" % (name, t * 1e3, first),
          flush=True)
    return t, out


def top_ops(log_dir, n=12):
    from microstructure_fingerprinting_tpu.utils.profiling import (
        device_op_times)
    totals, busy, window = device_op_times(log_dir)
    tot = sum(totals.values())
    print("trace: %d ops, %.2f ms op time, busy %.2f ms of a %.2f ms "
          "window (idle share %.3f)" % (len(totals), tot / 1e6, busy / 1e6,
                                        window / 1e6,
                                        1 - busy / max(window, 1)))
    for name, ns in sorted(totals.items(), key=lambda kv: -kv[1])[:n]:
        print("   %8.3f ms  %5.1f%%  %s" % (ns / 1e6, 100 * ns / tot,
                                          name[:90]))


def main(num_atom=782, chunk=512, reps=5, trace=None):
    if jax.devices()[0].platform != "gpu":
        sys.exit("profile_stages measures the GPU; no GPU found")
    from microstructure_fingerprinting_tpu import testing as mft
    from microstructure_fingerprinting_tpu.ops import interp as mfi
    from microstructure_fingerprinting_tpu.ops import dfscan, f32scan
    from microstructure_fingerprinting_tpu.models import fit as fit_mod
    from microstructure_fingerprinting_tpu.utils.scheme import b_values
    import microstructure_fingerprinting_tpu as mf
    mf.enable_compile_cache()
    dev = jax.devices()[0]
    print("device: %s (%s)" % (dev.device_kind, dev.platform))

    wl = mft.make_fit_workload(num_atom=num_atom, n_vox=chunk)
    ms, plan = wl["msinterp"], wl["plan"]
    _xs, ys_t, _cnt = ms.device_tables()
    dt = ys_t.dtype
    rot, perm = mfi.make_grouped_rotation_paired(ms, plan)
    pk = jnp.asarray(wl["peaks"].astype(dt))
    y = jnp.asarray(np.asarray(wl["y"])[:, perm].astype(dt))
    csf_d = jnp.asarray(np.asarray(wl["sig_csf"])[perm].astype(dt))
    S = y.shape[1]
    sch = wl["sch_mat"]
    TE, b = sch[:, 6][perm], b_values(sch)[perm]
    Dear = np.linspace(0.8e-9, 2.6e-9, 10)
    ear_d = jnp.asarray((np.exp(-TE / 0.8)[:, None]
                         * np.exp(-b[:, None] * Dear[None])).astype(dt))
    R = fit_mod.config.DEFAULTS["solver"].twopass_rows

    _t, D = timed("rotation", lambda: rot(ys_t, pk), reps)
    A1, A2 = D[:, 0], D[:, 1]
    csf_blk = jnp.broadcast_to(csf_d[None, :, None], (chunk, S, 1))

    # ---- 2-fascicle + CSF ----
    _t, (lo, up, upf, lo_col) = timed(
        "main: row pass (rowmin_3)",
        lambda: f32scan.rowmin_3(A1, A2, csf_blk, y, colmin=True), reps)
    sel = jax.jit(lambda lo, up, upf, lo_col: (
        f32scan._select_rows(lo, up, upf, R),
        f32scan._select_in_band(
            lo_col, jnp.minimum(jnp.min(up, axis=1), upf)[:, None], R)))
    _t, ((rows, ok), (cols, ok_c)) = timed(
        "main: row/column selection", lambda: sel(lo, up, upf, lo_col),
        reps)
    print("main: overflow %d/%d" % (int(np.sum(~np.asarray(ok & ok_c))),
                                     chunk))
    gat = jax.jit(f32scan._gather_cols)
    _t, A1s = timed("main: gather take_along_axis",
                    lambda: gat(A1, rows), reps)
    oh_gat = jax.jit(lambda A, idx: jnp.einsum(
        "bsn,bnr->bsr", A, (jnp.arange(A.shape[2])[None, :, None]
                            == idx[:, None, :]).astype(A.dtype),
        precision=lax.Precision.HIGHEST))
    _t, A1o = timed("main: gather one-hot HIGHEST",
                    lambda: oh_gat(A1, rows), reps)
    print("main: gathers equal: %s" % bool(np.array_equal(
        np.asarray(A1s), np.asarray(A1o))))
    A2s = gat(A2, cols)
    timed("main: df3 re-scan (R x R)",
          lambda: dfscan.df3_candidates(A1s, A2s, csf_blk, y, M=1), reps)
    _t, (c3, _v, _q, _ok) = timed(
        "main: df3_twopass total",
        lambda: f32scan.df3_twopass(A1, A2, csf_blk, y, M=1, R=R), reps)
    timed("main: finalize",
          lambda: fit_mod._finalize_top1(D, csf_d, None, y, c3[:, 0],
                                         csf_on=True, ear_on=False, K=2),
          reps)
    t3, _o = timed("main: chunk step (_twopass_step3)",
                   lambda: fit_mod._twopass_step3(D, csf_d, y, R=R), reps)
    print("main: %.0f voxels/s for scan + finalize (rotation excluded)"
          % (chunk / t3))
    cost = fit_mod._twopass_step3.lower(D, csf_d, y, R=R).compile()
    ca = cost.cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    print("main: step3 cost analysis: %.3g flop, %.3g bytes accessed"
          % (ca.get("flops", float("nan")),
             ca.get("bytes accessed", float("nan"))))

    # the row pass with TF32 A'R cross terms: what HIGHEST costs
    hp = dfscan._HP
    dfscan._HP = dict(hp, precision=lax.Precision.DEFAULT)
    try:
        tf32 = jax.jit(lambda A1, A2, a3, y: f32scan.rowmin_3.__wrapped__(
            A1, A2, a3, y, colmin=True))
        timed("main: row pass, TF32 cross terms",
              lambda: tf32(A1, A2, csf_blk, y), reps)
    finally:
        dfscan._HP = hp

    # ---- 2-fascicle + CSF + EAR: the one-pass df4 scan ----
    @jax.jit
    def ear_chunk(D, csf_d, ear_d, y):
        cand, _v, _q = dfscan.df4_candidates(
            D[:, 0], D[:, 1],
            jnp.broadcast_to(csf_d[None, :, None], (chunk, S, 1)),
            jnp.broadcast_to(ear_d[None], (chunk, S, 10)), y, M=1)
        return (cand[:, 0],) + fit_mod._finalize_top1(
            D, csf_d, ear_d, y, cand[:, 0], csf_on=True, ear_on=True, K=2)
    t1, _o = timed("EAR: df4 scan + finalize",
                   lambda: ear_chunk(D, csf_d, ear_d, y), reps)
    print("EAR: %.0f voxels/s for scan + finalize (rotation excluded)"
          % (chunk / t1))

    if trace:
        from microstructure_fingerprinting_tpu.utils.profiling import (
            device_trace)
        for name, fn in (
                ("main", lambda: fit_mod._twopass_step3(D, csf_d, y, R=R)),
                ("ear", lambda: ear_chunk(D, csf_d, ear_d, y))):
            d = os.path.join(trace, name)
            with device_trace(d):
                jax.block_until_ready(fn())
            print("-- trace of one %s chunk step" % name)
            top_ops(d)
    print("peak_bytes_in_use %d" % dev.memory_stats()["peak_bytes_in_use"])


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--num-atom", type=int, default=782)
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--trace", help="directory for profiler traces")
    a = ap.parse_args()
    main(a.num_atom, a.chunk, a.reps, a.trace)
