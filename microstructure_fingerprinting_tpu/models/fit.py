"""Batched device fit step: rotation -> dictionary assembly -> exhaustive
NNLS -> quality metrics, for one voxel-configuration bucket.

Replaces the reference's per-voxel worker ``_fit_voxel`` (mf.py:338-461).
Where the reference builds the voxel dictionary column-block by column-block
in a preallocated host array and calls a Numba scalar solver, this step:

  * rotates all K fascicle sub-dictionaries for a whole voxel batch in one
    gather/lerp kernel (ops/interp.eval_rotation_batch),
  * appends the subject-specific CSF column / EAR block (broadcast, no copy
    per voxel),
  * runs the tiled exhaustive scan (ops/nnls.exhaustive_nnls_blocks),
  * reconstructs y_hat from the selected atoms and computes MSE and R^2 on
    device (reference mf.py:446-450).

Voxels are grouped by configuration (K, csf, ear) on the host so that every
bucket compiles to one static-shape program; the per-voxel heterogeneity of
the reference (variable `dicsize`, mf.py:371-373) becomes a handful of
specialized XLA programs instead of data-dependent branches.
"""

import math
from functools import partial, lru_cache as _lru_cache

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from .. import backend, config
from ..ops import interp as mfi
from ..ops import nnls as mfn


def _r_squared(y, y_rec):
    """Pearson correlation squared between measured and predicted signal,
    with the reference's guards (num_seq > 1, non-zero stds; mf.py:449-450).
    """
    n = y.shape[-1]
    yc = y - jnp.mean(y, axis=-1, keepdims=True)
    rc = y_rec - jnp.mean(y_rec, axis=-1, keepdims=True)
    num = jnp.sum(yc * rc, axis=-1)
    den = jnp.sqrt(jnp.sum(yc * yc, axis=-1) * jnp.sum(rc * rc, axis=-1))
    ok = (den > 0) & (n > 1)
    r = jnp.where(ok, num / jnp.where(ok, den, 1.0), 0.0)
    return r * r


@partial(jax.jit, static_argnames=("K", "csf_on", "ear_on"))
def fit_step(xs, ys, cnt, gdir, shell_lo, shell_hi, wG,
             peaks, y, sig_csf, sig_ear, *, K, csf_on, ear_on):
    """One fused fit step for a (K, csf_on, ear_on) voxel bucket.

    Args:
      xs, ys, cnt: dictionary knot tables (replicated).
      gdir, shell_lo, shell_hi, wG: target-scheme plan arrays (replicated).
      peaks: (B, K, 3) fascicle directions (zero-size K axis allowed).
      y: (B, S) measured DWI signals.
      sig_csf: (S,) CSF fingerprint; sig_ear: (S, E) EAR fingerprints
        (pass zeros when the compartment is off — statically ignored).
      K, csf_on, ear_on: static bucket configuration.

    Returns dict with w (B, C), ind (B, C), min_obj (B,), mse (B,), r2 (B,)
    where C = K + csf_on + ear_on is the number of compartments.
    """
    S = y.shape[1]
    blocks = _build_blocks(xs, ys, cnt, gdir, shell_lo, shell_hi, wG,
                           peaks, y, sig_csf, sig_ear, K, csf_on, ear_on)

    w, ind, min_obj = mfn.exhaustive_nnls_blocks(tuple(blocks), y)

    # y_hat = sum_k w_k * block_k[:, :, ind_k]
    y_rec = jnp.zeros_like(y)
    for j, blk in enumerate(blocks):
        col = jnp.take_along_axis(
            blk, ind[:, j][:, None, None].astype(jnp.int32), axis=2)[:, :, 0]
        y_rec = y_rec + w[:, j][:, None] * col

    mse = min_obj / S
    r2 = _r_squared(y, y_rec)
    return {"w": w, "ind": ind, "min_obj": min_obj, "mse": mse, "r2": r2}


def _build_blocks(xs, ys, cnt, gdir, shell_lo, shell_hi, wG,
                  peaks, y, sig_csf, sig_ear, K, csf_on, ear_on):
    B, S = y.shape
    blocks = []
    if K > 0:
        D = mfi.eval_rotation_batch(xs, ys, cnt, gdir, shell_lo, shell_hi,
                                    wG, peaks)
        blocks.extend(D[:, k] for k in range(K))
    if csf_on:
        blocks.append(jnp.broadcast_to(sig_csf[None, :, None], (B, S, 1)))
    if ear_on:
        E = sig_ear.shape[1]
        blocks.append(jnp.broadcast_to(sig_ear[None, :, :], (B, S, E)))
    if not blocks:
        raise ValueError("Empty configuration: no compartments to fit.")
    return blocks


@partial(jax.jit, static_argnames=("K", "csf_on", "ear_on", "M"))
def fit_step_candidates(xs, ys, cnt, gdir, shell_lo, shell_hi, wG,
                        peaks, y, sig_csf, sig_ear, *,
                        K, csf_on, ear_on, M=8):
    """Top-M candidate indices per voxel for float64 host re-scoring
    (see models/refine.py). Returns (B, M, C) int32."""
    blocks = _build_blocks(xs, ys, cnt, gdir, shell_lo, shell_hi, wG,
                           peaks, y, sig_csf, sig_ear, K, csf_on, ear_on)
    return mfn.exhaustive_candidates_blocks(tuple(blocks), y, M=M)


@partial(jax.jit, static_argnames=("csf_on", "ear_on", "K"))
def _finalize_top1(D, sig_csf, sig_ear, y, cand, csf_on=False,
                   ear_on=False, K=2):
    """Device finalize of the double-float scan winner.

    The compensated candidate scan (ops/dfscan) already selects the exact
    (float64-grade) winning support, so the only remaining work is the
    winner's weights and quality metrics. This computes them on device with
    the double-float small solver (ops/dfscan.df_nnls_cols: exact Grams +
    closed-form solves with df values) — replacing the reference's float64
    host re-solve (mf.py:430-450) without a host round-trip per bucket
    chunk, at matching (~1e-11 relative) accuracy.

    Args:
      D (B, K, S, N) rotated fascicle blocks (raw scale); sig_csf (S,),
      sig_ear (S, E) (unused unless the flag is set); y (B, S) raw;
      cand (B, C') int32 winner, fascicle indices first, the EAR atom
      (when present) last.
    Returns (w (B, C), obj (B, 2), r2 (B,)) with C = K + csf_on + ear_on
    and the objective as a double-float pair obj[:, 0] + obj[:, 1]: the
    host sums the two in float64, so the reported objective keeps its
    double-float accuracy.
    """
    from ..ops import dfscan
    B, S = y.shape
    cols = [jnp.take_along_axis(D[:, k], cand[:, None, k:k + 1], axis=2)
            for k in range(K)]
    if csf_on:
        cols.append(jnp.broadcast_to(sig_csf[None, :, None], (B, S, 1)))
    if ear_on:
        cols.append(jnp.take_along_axis(
            jnp.broadcast_to(sig_ear[None], (B,) + sig_ear.shape),
            cand[:, None, -1:], axis=2))
    cols = jnp.concatenate(cols, axis=2)                     # (B, S, C)
    w, res = dfscan.df_nnls_cols(cols, y)
    y_rec = jnp.einsum("bsc,bc->bs", cols, w,
                       precision=jax.lax.Precision.HIGHEST)
    r2 = _r_squared(y, y_rec)
    return w, jnp.stack(res, axis=1), r2


@partial(jax.jit, static_argnames=("R",))
def _twopass_step3(D, csf_d, y, R):
    """One fused chunk step of the 2-fascicle+CSF two-pass production
    path: interval row scan -> row selection -> df re-scan -> winner
    finalize, in a single compiled program (the stages are tiny-op heavy;
    one jit removes the dispatch boundaries between them)."""
    from ..ops import f32scan as f32
    B, S = y.shape
    csf_blk = jnp.broadcast_to(csf_d[None, :, None], (B, S, 1))
    cand, _vals, _ysq, ok = f32.df3_twopass(D[:, 0], D[:, 1], csf_blk, y,
                                            M=1, R=R)
    w, obj, r2 = _finalize_top1(D, csf_d, None, y, cand[:, 0],
                                csf_on=True, ear_on=False, K=2)
    return cand[:, 0], w, obj, r2, ok


@_lru_cache(maxsize=32)
def _twopass_sharded(mesh, R):
    """Mesh-wrapped two-pass step: data-parallel shard_map around the fused
    chunk step, so ``fit(parallel=True)`` compiles the same programs as
    the serial path.

    Voxels are independent, so the wrapper shards the voxel axis over the
    mesh's 'data' axis and runs the unmodified step per device shard — no
    collectives. On a 2D mesh the 'atoms' axis is left unreferenced
    (replicated compute); the atoms-axis tensor parallelism remains the
    dedicated one-pass scan (parallel/mesh.sharded_df3_candidates).
    Cached per (mesh, R) so every chunk of a fit shares one jitted
    callable (and therefore one compiled executable).
    """
    from jax.sharding import PartitionSpec as P

    def inner(D, csf_d, y):
        return _twopass_step3(D, csf_d, y, R=R)
    in_specs = (P("data", None, None, None), P(None), P("data", None))
    out_specs = (P("data"), P("data", None), P("data", None), P("data"),
                 P("data"))
    return jax.jit(jax.shard_map(inner, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def fast_covers(cfg, num_ear):
    """Whether run_bucket_fast handles a (K, csf_on, ear_on) bucket:
    1- and 2-fascicle configurations (K=1 needs a CSF block to form the
    second scan axis); EAR additionally needs a CSF block and a small
    enough EAR block for its per-sweep scans."""
    K, csf_on, ear_on = cfg
    if K not in (1, 2) or (K == 1 and not csf_on):
        return False
    return not ear_on or (csf_on and num_ear <= 16)


def fast_scan(K, csf_on, ear_on, n_atom, device_finalize):
    """Name of the candidate scan run_bucket_fast runs for a bucket.

    'twopass3': f32 interval row pass + double-float re-scan of the
    selected rows and columns + device finalize, for 2-fascicle + CSF
    dictionaries large enough for row selection to pay (n_atom > 2 R);
    it needs the device finalize (only the scan winner is kept).
    Otherwise the one-pass double-float scans over the whole grid: 'df2'
    ([N1, N2] or [N, csf]), 'df3' ([N1, N2, csf] or [N, ear, csf]) and
    'df4' ([N1, N2, csf, ear])."""
    if K == 1:
        return "df3" if ear_on else "df2"
    if not csf_on:
        return "df2"
    if ear_on:
        return "df4"
    rows_R = config.DEFAULTS["solver"].twopass_rows
    twopass = device_finalize and n_atom > 2 * rows_R
    return "twopass3" if twopass else "df3"


def bucket_route(cfg, n_atom, num_ear, engine="auto", refine=True):
    """How MFModel.fit solves a (K, csf_on, ear_on) bucket: 'host' (the
    closed-form fascicle-free solve), 'general' (run_bucket, the tiled
    scan for any configuration) or the fast_scan name of run_bucket_fast.

    engine='auto' takes the fast path on the GPU for float32 runs; off
    the GPU (the CPU's float64 runs) the general scan with float64 host
    re-scoring keeps bit-level reference parity."""
    K, csf_on, ear_on = cfg
    if K == 0:
        return "host"
    fast = engine == "fast" or (engine == "auto" and refine
                                and backend.on_gpu())
    if not (fast and fast_covers(cfg, num_ear)):
        return "general"
    return fast_scan(K, csf_on, ear_on, n_atom, backend.on_gpu())


def run_bucket_fast(ms_host, plan_host, tables_ys, peaks, y, sig_csf,
                    K, csf_on, batch=128, topm=16, rotator=None,
                    sig_ear=None, ear_on=False, mesh=None,
                    device_finalize=None, defer=False, stats=None):
    """Fast path for the 1- and 2-fascicle (+CSF, +CSF+EAR) configurations.

    Grouped-matmul rotation (ops/interp.make_grouped_rotation) feeds the
    double-float candidate scans (ops/dfscan.df{2,3,4}_candidates — exact
    int8 Gram + compensated bordered determinants), whose top-1 already
    matches float64 selection. With ``mesh`` set, every chunk's voxel axis
    is sharded over the mesh's 'data' axis (SPMD data parallelism; voxels
    are independent, so no collective beyond the output gather is needed).
    Returns NumPy (w, ind, min_obj, mse, r2) like run_bucket.

    ``device_finalize`` (default: on for the GPU backend) computes the
    winner's weights/objective/R^2 on device (_finalize_top1) and pulls
    one small result set per bucket; off, the top-``topm`` pool is
    re-scored in float64 on the host (models/refine.py — bit-level
    reference parity, used for the x64 CPU test path).

    Which scan a bucket runs is fast_scan's choice. On large dictionaries
    the 2-fascicle + CSF scan runs as a TWO-PASS exact scan
    (ops/f32scan): an f32 interval row pass selects the rows that can
    contain the winner, the df scan re-ranks only those, and overflowing
    voxels are re-solved at a doubled row budget, then over the full grid
    — same selection, a fraction of the compute.

    ``stats``, a dict when given, receives the scan name ('scan') and,
    with the device finalize, how many voxels each overflow tier
    re-solved ('tier_2R', 'tier_full'). ``defer=True`` returns a zero-arg
    closure performing the pull/assembly instead of the results, letting
    MFModel.fit dispatch all buckets before syncing any.
    """
    from ..ops import interp as interp_mod
    from ..ops import dfscan
    from ..ops import f32scan as f32
    from ..parallel import mesh as pmesh
    from . import refine as refine_mod
    if device_finalize is None:
        device_finalize = backend.on_gpu()
    rows_R = config.DEFAULTS["solver"].twopass_rows
    assert K in (1, 2), "fast path covers 1- and 2-fascicle configurations"
    assert K == 2 or csf_on, \
        "the 1-fascicle fast path needs a CSF block (else run_bucket)"
    assert not ear_on or csf_on, \
        "the EAR fast path assumes a CSF block (reference configuration)"
    scan = fast_scan(K, csf_on, ear_on, tables_ys.shape[2],
                     device_finalize)
    n_at_ax = dict(mesh.shape).get("atoms", 1) if mesh is not None else 1
    if (scan in ("df3", "twopass3") and n_at_ax > 1
            and tables_ys.shape[2] % n_at_ax == 0):
        # atoms-axis tensor parallelism: the second fascicle block is
        # resharded over 'atoms' and each device scans its N1 x
        # (N2 / n_atoms) sub-grid; the global first-minimum is
        # reconstructed with an offset-corrected re-rank
        # (parallel/mesh.sharded_df3_candidates)
        scan = "df3_atoms"
    if stats is not None:
        stats["scan"] = scan
    # ``rotator`` may be a plain evaluator (make_grouped_rotation) or a
    # (evaluator, perm) pair (make_grouped_rotation_paired): the paired
    # variant emits the rotated dictionary in permuted sequence order —
    # the measured signal and fixed compartment columns get the same
    # permutation below, and every downstream quantity (residuals,
    # weights, R^2, atom ids) is permutation-invariant. The float64 host
    # path works in the original order throughout.
    rot_perm = None
    if isinstance(rotator, tuple):
        rotator, rot_perm = rotator
    if rotator is None:
        rotator, rot_perm = interp_mod.make_grouped_rotation_paired(
            ms_host, plan_host)
    n, S = y.shape
    dt = tables_ys.dtype
    C = K + int(csf_on) + int(ear_on)
    sig_csf64 = (np.asarray(sig_csf, dtype=np.float64)
                 if csf_on else None)
    sig_ear64 = (np.asarray(sig_ear, dtype=np.float64) if ear_on else None)
    sig_csf_dev = np.asarray(sig_csf)[rot_perm] \
        if (csf_on and rot_perm is not None) else sig_csf
    sig_ear_dev = np.asarray(sig_ear)[rot_perm] \
        if (ear_on and rot_perm is not None) else sig_ear
    csf_d = (jnp.asarray(sig_csf_dev, dtype=dt) if csf_on else None)
    ear_d = (jnp.asarray(sig_ear_dev, dtype=dt) if ear_on else None)
    if mesh is not None:
        # commit the read-only blocks once per bucket with an explicit
        # replicated sharding (instead of an implicit broadcast per chunk)
        tables_ys = pmesh.replicate(mesh, tables_ys)
        if csf_d is not None:
            csf_d = pmesh.replicate(mesh, csf_d)
        if ear_d is not None:
            ear_d = pmesh.replicate(mesh, ear_d)
    E = sig_ear.shape[1] if ear_on else 0

    # One host->device push for the whole bucket, chunked on device, and
    # device results pulled back in ONE transfer per bucket. Staging
    # buffers are built in the device dtype (a host-side cast instead of
    # shipping float64 bytes to cast on device).
    n_pad = int(math.ceil(n / batch) * batch)
    # float64 peaks feed the host refine (bit-level reference parity of the
    # re-scoring path); the device push uses a device-dtype staging copy
    pk64 = np.zeros((n_pad, K, 3), dtype=np.float64)
    pk64[:n] = peaks.reshape(n, K, 3)
    y_all = np.zeros((n_pad, S), dtype=dt)
    y_all[:n] = y if rot_perm is None else np.asarray(y)[:, rot_perm]
    if n_pad > n:
        pk64[n:] = pk64[0]
        y_all[n:] = y_all[0]
    pk_d = jnp.asarray(pk64.astype(dt))
    y_d = jnp.asarray(y_all)

    # dispatch ALL device work up front (async); results are pulled in
    # chunk groups so the host's float64 refinement overlaps with device
    # compute of later groups
    cands_d, vals_d, fin_d = [], [], []
    # the device finalize consumes only the scan winner: a 1-deep pool
    # skips the top-M extraction work
    pool = 1 if device_finalize else topm
    for st in range(0, n_pad, batch):
        pk_c = lax.dynamic_slice_in_dim(pk_d, st, batch, axis=0)
        yy_c = lax.dynamic_slice_in_dim(y_d, st, batch, axis=0)
        if mesh is not None:
            pk_c = pmesh.shard_batch(mesh, pk_c)
            yy_c = pmesh.shard_batch(mesh, yy_c)
        D = rotator(tables_ys, pk_c)
        if scan == "twopass3":
            # two-pass exact scan: cheap f32 row minima select the top-R
            # candidate rows, the double-float scan re-ranks only those;
            # `ok` flags (rare) voxels whose in-band row count overflowed
            # R — they are re-solved after the pull. Scan + finalize run
            # as ONE compiled step; under a mesh the same step runs inside
            # a data-parallel shard_map (_twopass_sharded).
            if mesh is None:
                fin_d.append(_twopass_step3(D, csf_d, yy_c, R=rows_R))
            else:
                fin_d.append(_twopass_sharded(mesh, rows_R)(D, csf_d, yy_c))
            continue
        csf_blk = jnp.broadcast_to(csf_d[None, :, None], (batch, S, 1)) \
            if csf_on else None
        ear_blk = jnp.broadcast_to(ear_d[None, :, :], (batch, S, E)) \
            if ear_on else None
        if scan == "df3_atoms":
            cand2, res2, _ysq = pmesh.sharded_df3_candidates(
                mesh, D[:, 0], pmesh.shard_atoms(mesh, D[:, 1]), csf_blk,
                yy_c, M=pool)
        elif scan == "df4":
            cand2, res2, _ysq = dfscan.df4_candidates(
                D[:, 0], D[:, 1], csf_blk, ear_blk, yy_c, M=pool)
        elif K == 1:
            # [N, 1] / [N, E, 1] blocks: the CSF column is the scan's
            # second axis; with EAR its atoms become the second axis and
            # CSF the fixed third block ((i1, e) lexicographic order — the
            # same tie order as the reference's (i1, csf, e) product,
            # the CSF index being constant)
            if ear_on:
                cand2, res2, _ysq = dfscan.df3_candidates(
                    D[:, 0], ear_blk, csf_blk, yy_c, M=pool)
            else:
                cand2, res2, _ysq = dfscan.df2_candidates(
                    D[:, 0], csf_blk, yy_c, M=pool)
        elif scan == "df3":
            cand2, res2, _ysq = dfscan.df3_candidates(
                D[:, 0], D[:, 1], csf_blk, yy_c, M=pool)
        else:
            cand2, res2, _ysq = dfscan.df2_candidates(
                D[:, 0], D[:, 1], yy_c, M=pool)
        if device_finalize:
            w_c, obj_c, r2_c = _finalize_top1(
                D, csf_d, ear_d, yy_c, cand2[:, 0],
                csf_on=bool(csf_on), ear_on=bool(ear_on), K=K)
            fin_d.append((cand2[:, 0], w_c, obj_c, r2_c,
                          jnp.ones(cand2.shape[0], dtype=bool)))
        else:
            cands_d.append(cand2)
            vals_d.append(res2)

    def _finish():
        """Pull + assemble this bucket's results (the expensive
        device->host sync). With ``defer=True`` the caller runs all
        buckets' dispatch phases first, so bucket N+1's device work
        overlaps bucket N's pull/refine (cross-bucket pipelining)."""
        if device_finalize:
            # ONE device->host pull of the per-voxel results for the whole
            # bucket: every chunk's (cand, w, obj hi/lo, r2, ok) is packed
            # into a single f32 row, one transfer per bucket. Indices
            # survive the f32 round-trip exactly (< 2^24); the objective's
            # two halves are summed in float64 on the host.
            n_cand = fin_d[0][0].shape[1]
            C_w = fin_d[0][1].shape[1]
            i_obj = n_cand + C_w

            def _pack(cand, w, obj, r2, ok=None):
                parts = [cand.astype(jnp.float32), w.astype(jnp.float32),
                         obj.astype(jnp.float32),
                         r2[:, None].astype(jnp.float32)]
                if ok is not None:
                    parts.append(ok[:, None].astype(jnp.float32))
                return jnp.concatenate(parts, axis=1)

            pk_np = np.asarray(jnp.concatenate([_pack(*f) for f in fin_d]))
            pk_np = pk_np[:n].astype(np.float64)
            ind2 = pk_np[:, :n_cand].astype(np.int32)
            w_b = pk_np[:, n_cand:i_obj]
            obj_b = pk_np[:, i_obj] + pk_np[:, i_obj + 1]
            r2_b = pk_np[:, i_obj + 2]
            ok_b = pk_np[:, i_obj + 3] > 0.5
            if stats is not None:
                stats.update(tier_2R=0, tier_full=0)
            if not ok_b.all():
                # two-pass row-budget overflow (heavily tied voxels): re-run
                # just those voxels at a DOUBLED row budget first (covers
                # bands up to 2R - 1 rows at a fraction of the full-grid
                # cost), then at the full row budget for any voxel still
                # overflowing — exact selection is then unconditional.
                bad = np.flatnonzero(~ok_b)
                w_b = np.array(w_b)
                obj_b = np.array(obj_b)
                r2_b = np.array(r2_b)
                # overflow is rare (percent-level), so re-solves run
                # unsharded at a small fixed batch — one cheap extra compile
                # instead of a full-size chunk per bucket
                fb = min(batch, 64)

                def _resolve(sel, R):
                    """Two-pass re-solve of the voxels ``sel`` (at most fb)
                    at row budget R; ONE device->host transfer. Returns
                    (packed rows, ok per voxel)."""
                    m = sel.size
                    pk_f = np.zeros((fb, K, 3), dtype=dt)
                    y_f = np.zeros((fb, S), dtype=dt)
                    pk_f[:m] = pk64[sel]
                    y_f[:m] = y_all[sel]
                    if m < fb:
                        pk_f[m:] = pk_f[0]
                        y_f[m:] = y_f[0]
                    y_fd = jnp.asarray(y_f)
                    D_f = rotator(tables_ys, jnp.asarray(pk_f))
                    csf_f = jnp.broadcast_to(csf_d[None, :, None],
                                             (fb, S, 1))
                    cand_f, _v, _q, ok_f = f32.df3_twopass(
                        D_f[:, 0], D_f[:, 1], csf_f, y_fd, M=1, R=R)
                    w_f, obj_f, r2_f = _finalize_top1(
                        D_f, csf_d, None, y_fd, cand_f[:, 0],
                        csf_on=True, ear_on=False, K=K)
                    pk_f = np.asarray(_pack(cand_f[:, 0], w_f, obj_f, r2_f,
                                            ok_f))[:m].astype(np.float64)
                    return pk_f, pk_f[:, -1] > 0.5

                def _store(sel, pk_f):
                    ind2[sel] = pk_f[:, :n_cand].astype(np.int32)
                    w_b[sel] = pk_f[:, n_cand:i_obj]
                    obj_b[sel] = pk_f[:, i_obj] + pk_f[:, i_obj + 1]
                    r2_b[sel] = pk_f[:, i_obj + 2]

                # tier 1 at 2R rows, tier 2 at the FULL row budget (R =
                # N1): the row pass then keeps every row, the df re-scan
                # covers the whole candidate grid, and the overflow flag
                # cannot fire. Tier 2 compiles lazily — only fits that
                # still overflow after the 2R tier pay it.
                R2b = 2 * rows_R
                R_full = int(tables_ys.shape[2])
                tiers = [(R2b, "tier_2R")] if R2b < R_full else []
                tiers.append((R_full, "tier_full"))
                for R, name in tiers:
                    if stats is not None:
                        stats[name] = int(bad.size)
                    still = []
                    for st in range(0, bad.size, fb):
                        sel = bad[st:st + fb]
                        pk_f, ok_f = _resolve(sel, R)
                        ok_f = ok_f | (R == R_full)
                        _store(sel[ok_f], pk_f[ok_f])
                        still.extend(sel[~ok_f])
                    bad = np.asarray(still, dtype=np.int64)
                    if not bad.size:
                        break
            # the df quadratic form can round a noiseless voxel's residual a few
            # ulp below zero; a reported objective is never negative
            obj_b = np.maximum(obj_b, 0.0)
            n_atom = tables_ys.shape[2]
            # clip fascicle columns to the atom range and the EAR column (when
            # present) to its own range — a blanket clip would corrupt valid
            # ear indices in [n_atom, E) for dictionaries with num_ear > num_atom
            n_fasc_cols = ind2.shape[1] - int(ear_on)
            ind2[:, :n_fasc_cols] = np.clip(ind2[:, :n_fasc_cols], 0,
                                            n_atom - 1)
            if ear_on:
                ind2[:, -1] = np.clip(ind2[:, -1], 0, E - 1)
                # an unused EAR block leaves the residual independent of the
                # ear atom: report the first index like the reference's
                # first-minimum enumeration (mf_utils.py:637 product order)
                ind2[w_b[:, C - 1] <= 0, -1] = 0
            # canonical (fasc..., csf, ear) index layout
            if K == 1 and ear_on:     # [i1, ie] -> [i1, csf=0, ie]
                ind2 = np.concatenate(
                    [ind2[:, :1], np.zeros((n, 1), np.int32), ind2[:, 1:]],
                    axis=1)
            elif K == 2 and csf_on and not ear_on:   # [i1, i2] -> + csf=0
                ind2 = np.concatenate(
                    [ind2, np.zeros((n, 1), np.int32)], axis=1)
            return (w_b.astype(np.float64), ind2.astype(np.int32),
                    obj_b.astype(np.float64), obj_b.astype(np.float64) / S,
                    r2_b.astype(np.float64))

        noise = config.DEFAULTS["solver"].direct_noise
        y64 = y.astype(np.float64)
        w_b = np.zeros((n, C))
        ind_b = np.zeros((n, C), np.int32)
        obj_b = np.zeros(n)
        r2_b = np.zeros(n)

        # chunks pulled + refined together: each pull pays the device->host
        # latency once, so scale the group with the bucket while keeping a
        # few groups for refine/compute overlap
        group = max(4, len(cands_d) // 4)
        for g0 in range(0, len(cands_d), group):
            g1 = min(g0 + group, len(cands_d))
            g_st = g0 * batch
            g_en = min(g1 * batch, n)
            if g_st >= n:
                break
            m = g_en - g_st
            cand = np.array(jnp.concatenate(cands_d[g0:g1], axis=0)[:m])
            vals = np.asarray(jnp.concatenate(vals_d[g0:g1], axis=0))[:m]
            # +inf candidates (padded rows of tiny dictionaries reaching the
            # top-M pool) carry padded i1 indices — clamp them into range; their
            # residuals keep them from winning the f64 re-score. Fascicle and
            # EAR columns clip to their own ranges.
            n_atom = tables_ys.shape[2]
            n_fasc_cols = cand.shape[2] - int(ear_on)
            cand[:, :, :n_fasc_cols] = np.clip(cand[:, :, :n_fasc_cols], 0,
                                               n_atom - 1)
            if ear_on:
                cand[:, :, -1] = np.clip(cand[:, :, -1], 0, E - 1)

            # adaptive refinement depth: only candidates within the device
            # selection's (normalized-residual) noise band of the champion can
            # be exactly-optimal. Group voxels by their own tie depth so an
            # isolated highly-degenerate voxel doesn't force deep re-scoring
            # for the whole group.
            k_vox = np.clip(np.sum(vals <= vals[:, :1] + noise, axis=1),
                            1, topm)
            lo_k = 1
            for hi_k in (1, 2, 4, 8, topm):
                sel = np.where((k_vox >= lo_k) & (k_vox <= hi_k))[0]
                lo_k = hi_k + 1
                if sel.size == 0:
                    continue
                gsel = g_st + sel
                cand_g = cand[sel, :hi_k]
                # expand scan candidate layouts to the canonical
                # (fasc..., csf, ear) index layout refine_candidates expects
                if K == 1 and ear_on:       # [i1, ie] -> [i1, csf=0, ie]
                    cand_g = np.concatenate(
                        [cand_g[:, :, :1],
                         np.zeros((sel.size, hi_k, 1), np.int32),
                         cand_g[:, :, 1:]], axis=2)
                elif K == 2 and csf_on and not ear_on:
                    cand_g = np.concatenate(
                        [cand_g, np.zeros((sel.size, hi_k, 1), np.int32)],
                        axis=2)
                w_g, ind_g, obj_g, y_rec = refine_mod.refine_candidates(
                    ms_host, plan_host, pk64[gsel], y64[gsel],
                    sig_csf64, sig_ear64, cand_g, K, bool(csf_on),
                    bool(ear_on))
                w_b[gsel] = w_g
                ind_b[gsel] = ind_g
                obj_b[gsel] = obj_g
                r2_b[gsel] = _r2_np(y64[gsel], y_rec)
        # float64 quadratic-form residuals can round a hair below zero on
        # noiseless voxels; a reported objective is never negative
        obj_b = np.maximum(obj_b, 0.0)
        return w_b, ind_b, obj_b, obj_b / S, r2_b



    return _finish if defer else _finish()

def run_bucket_trivial(y, sig_csf, sig_ear, csf_on, ear_on):
    """Closed-form host solve for fascicle-free (K=0) buckets.

    A voxel with no fascicle compartments has at most 1 + num_ear
    candidate columns (the CSF column and/or the EAR block; reference
    mf.py:401-408), so the exhaustive NNLS degenerates to a tiny dense
    subproblem: the vectorized 1-variable form the reference itself
    documents (mf_utils.py:234-241), or a 1 x num_ear 2-variable Cramer
    grid. Solving it in float64 NumPy on the host matches the reference
    bit-for-bit and avoids compiling a device program for microseconds
    of work (the generic bucket's XLA program took minutes to
    first-compile for what is a closed-form matvec).

    Returns NumPy (w, ind, min_obj, mse, r2) like run_bucket, with
    C = csf_on + ear_on compartment columns.
    """
    from ..ops import nnls as nnls_mod
    y64 = np.asarray(y, dtype=np.float64)
    n, S = y64.shape
    y_sq = np.einsum("ns,ns->n", y64, y64)
    if not (csf_on or ear_on):
        raise ValueError("Empty configuration: no compartments to fit.")
    # vectorized over voxels with the SAME closed-form case analysis the
    # exhaustive host solver uses (lsqnonneg_1var / lsqnonneg_2var with
    # xp=numpy), so per-voxel results are bit-identical to a
    # solve_exhaustive_posweights loop; argmin keeps the first minimum,
    # matching the reference's strict-improvement product order
    if csf_on:
        csf64 = np.asarray(sig_csf, dtype=np.float64)
    if ear_on:
        ear64 = np.asarray(sig_ear, dtype=np.float64)
        E = ear64.shape[1]
    if csf_on and ear_on:
        A11 = float(csf64 @ csf64)
        A22 = np.einsum("se,se->e", ear64, ear64)          # (E,)
        A12 = csf64 @ ear64                                # (E,)
        Y1 = y64 @ csf64                                   # (n,)
        Y2 = y64 @ ear64                                   # (n, E)
        w1, w2, res = nnls_mod.lsqnonneg_2var(
            y_sq[:, None], A11, A12[None, :], A22[None, :],
            Y1[:, None], Y2, xp=np)                        # (n, E)
        ie = np.argmin(res, axis=1)
        rows = np.arange(n)
        w_b = np.stack([w1[rows, ie], w2[rows, ie]], axis=1)
        ind_b = np.stack([np.zeros(n, np.int32), ie.astype(np.int32)],
                         axis=1)
        obj_b = res[rows, ie]
        y_rec = w_b[:, :1] * csf64[None, :] + w_b[:, 1:] * ear64[:, ie].T
    elif csf_on:
        w, res = nnls_mod.lsqnonneg_1var(
            y_sq, float(csf64 @ csf64), y64 @ csf64, xp=np)
        w_b = w[:, None]
        ind_b = np.zeros((n, 1), np.int32)
        obj_b = res
        y_rec = w_b * csf64[None, :]
    else:  # EAR only
        a_sq = np.einsum("se,se->e", ear64, ear64)
        w, res = nnls_mod.lsqnonneg_1var(y_sq[:, None], a_sq[None, :],
                                         y64 @ ear64, xp=np)     # (n, E)
        ie = np.argmin(res, axis=1)
        rows = np.arange(n)
        w_b = w[rows, ie][:, None]
        ind_b = ie.astype(np.int32)[:, None]
        obj_b = res[rows, ie]
        y_rec = w_b * ear64[:, ie].T
    obj_b = np.maximum(obj_b, 0.0)
    return w_b, ind_b, obj_b, obj_b / S, _r2_np(y64, y_rec)


def _r2_np(y, y_rec):
    n = y.shape[-1]
    yc = y - y.mean(axis=-1, keepdims=True)
    rc = y_rec - y_rec.mean(axis=-1, keepdims=True)
    num = np.sum(yc * rc, axis=-1)
    den = np.sqrt(np.sum(yc * yc, axis=-1) * np.sum(rc * rc, axis=-1))
    ok = (den > 0) & (n > 1)
    r = np.where(ok, num / np.where(ok, den, 1.0), 0.0)
    return r * r


def run_bucket(tables, plan, peaks, y, sig_csf, sig_ear,
               K, csf_on, ear_on, batch=128, dtype=None, mesh=None,
               refine=False, ms_host=None, plan_host=None, topm=8):
    """Run the fit step over a bucket of voxels in fixed-size chunks.

    ``peaks`` (n, 3*K) and ``y`` (n, S) are NumPy arrays for one bucket;
    chunking to a fixed ``batch`` keeps the number of compiled programs at
    one per configuration. With ``mesh`` set, each chunk's voxel axis is
    sharded over the mesh's 'data' axis (SPMD data parallelism over voxels —
    the replacement for the reference's multiprocessing pool,
    mf.py:978-1009) with the dictionary tables replicated.
    Returns NumPy (w, ind, min_obj, mse, r2).
    """
    from ..parallel import mesh as pmesh
    xs, ys, cnt = tables
    if dtype is None:
        dtype = xs.dtype
    n = y.shape[0]
    S = y.shape[1]
    sig_csf_d = jnp.asarray(sig_csf if csf_on else np.zeros(S), dtype=dtype)
    sig_ear_d = jnp.asarray(sig_ear if ear_on else np.zeros((S, 1)),
                            dtype=dtype)
    gdir, lo, hi, wG = plan

    # One host->device push for the whole bucket, one pull of the stacked
    # chunk results: host<->device round-trip latency is paid per bucket,
    # not per chunk.
    n_pad = int(math.ceil(n / batch) * batch)
    # float64 peaks for the host refine; device staging in the device dtype
    # (a host-side cast instead of shipping f64 bytes to cast on device)
    pk64 = np.zeros((n_pad, max(K, 1), 3), dtype=np.float64)
    y_all = np.zeros((n_pad, S), dtype=dtype)
    if K > 0:
        pk64[:n] = peaks.reshape(n, K, 3)
    y_all[:n] = y
    if n_pad > n:  # pad rows replicate voxel 0 to keep kernels NaN-free
        pk64[n:] = pk64[0]
        y_all[n:] = y_all[0]
    pk_all = pk64.astype(dtype)
    pk_d_all = jnp.asarray(pk_all[:, :K] if K > 0 else pk_all[:, :0])
    y_d_all = jnp.asarray(y_all)

    chunks = []
    for st in range(0, n_pad, batch):
        pk_d = lax.dynamic_slice_in_dim(pk_d_all, st, batch, axis=0)
        yy_d = lax.dynamic_slice_in_dim(y_d_all, st, batch, axis=0)
        if mesh is not None:
            pk_d = pmesh.shard_batch(mesh, pk_d)
            yy_d = pmesh.shard_batch(mesh, yy_d)
        if refine:
            chunks.append(fit_step_candidates(
                xs, ys, cnt, gdir, lo, hi, wG, pk_d, yy_d,
                sig_csf_d, sig_ear_d,
                K=K, csf_on=bool(csf_on), ear_on=bool(ear_on), M=topm))
        else:
            chunks.append(fit_step(
                xs, ys, cnt, gdir, lo, hi, wG, pk_d, yy_d,
                sig_csf_d, sig_ear_d,
                K=K, csf_on=bool(csf_on), ear_on=bool(ear_on)))

    if refine:
        # f32 device scan -> top-M candidates -> exact f64 host re-score
        from . import refine as refine_mod
        cand = np.asarray(jnp.concatenate(chunks, axis=0))[:n]
        y64 = y.astype(np.float64)
        w_b, ind_b, obj_b, y_rec = refine_mod.refine_candidates(
            ms_host, plan_host,
            pk64[:n, :K] if K > 0 else pk64[:n, :0], y64,
            np.asarray(sig_csf, dtype=np.float64) if csf_on else None,
            np.asarray(sig_ear, dtype=np.float64) if ear_on else None,
            cand, K, bool(csf_on), bool(ear_on))
        obj_b = np.maximum(obj_b, 0.0)   # never report a negative residual
        return w_b, ind_b, obj_b, obj_b / S, _r2_np(y64, y_rec)

    stacked = {k: np.asarray(jnp.concatenate([c[k] for c in chunks],
                                             axis=0))[:n]
               for k in ("w", "ind", "min_obj", "mse", "r2")}
    obj = np.maximum(stacked["min_obj"], 0.0)
    return (stacked["w"], stacked["ind"], obj,
            np.maximum(stacked["mse"], 0.0), stacked["r2"])
