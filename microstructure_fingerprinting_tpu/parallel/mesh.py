"""Mesh construction and sharded execution of the fingerprinting fit.

The reference parallelizes over voxels with a multiprocessing.Pool
(mf.py:978-1009), pickling per-voxel dicts across process pipes. Here
voxels are a batch axis sharded across the device mesh with ``jax.sharding`` / ``shard_map``; the dictionary tables are
replicated in HBM (read-only, identical for all voxels); the only collective
is the implicit output gather — voxels are embarrassingly parallel.

Two parallel axes are exposed:
  * ``data``  — voxel batch (pure DP; no cross-device communication)
  * ``atoms`` — the second sub-dictionary's atom axis in the candidate scan
    (model parallelism; sharded_df3_candidates). Each device scans its atom
    shard and the global first-minimum is reconstructed with an all-gather +
    offset-corrected re-rank, preserving the reference's tie-breaking.
    models/fit.run_bucket_fast routes the 2-fascicle+CSF scan through it
    whenever the mesh's 'atoms' axis is larger than 1.
"""


import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, local_device_ids=None):
    """Wire up multi-host execution (jax.distributed) for volume fits.

    The reference's only parallelism is single-host multiprocessing
    (reference mf.py:978-1009). Multi-host here: every host runs the same
    fit script, this initializer connects them into one jax runtime, and
    ``build_mesh`` then spans the GLOBAL device set — voxel batches shard
    across all devices of all hosts with no further code changes (voxels
    are independent; SURVEY.md section 5 comm-backend plan).

    All arguments are jax.distributed.initialize passthroughs; pass the
    coordinator address, process count and process id explicitly.
    """
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_device_ids)


def gather_to_host(x, tiled=True):
    """Gather a (possibly multi-host-sharded) array to every host as NumPy.

    Used by multi-host fits to assemble the full parameter maps on host 0
    for NIfTI writing (SURVEY.md section 5: "final parameter maps
    all-gathered to host 0"); jax's process_allgather delivers the same
    bytes on every host, so host 0 simply writes and the others discard.
    ``tiled=True`` concatenates per-process shards along axis 0 (the voxel
    axis); with ``tiled=False`` a new leading process axis is added.
    """
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(x, tiled=tiled))


def host_local_to_global(mesh, pspec, x):
    """Promote per-process local shards to one global sharded array.

    Every process passes its own slice of the voxel batch (equal sizes);
    the result is a global jax.Array laid out per ``pspec`` on ``mesh``
    and usable directly by the jitted fit step.
    """
    from jax.experimental import multihost_utils
    return multihost_utils.host_local_array_to_global_array(x, mesh, pspec)


def build_mesh(n_data=None, n_atoms=1, devices=None):
    """Create a (data, atoms) mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
    n_dev = len(devices)
    if n_data is None:
        n_data = n_dev // n_atoms
    assert n_data * n_atoms == n_dev, (
        "mesh shape %dx%d does not match %d devices"
        % (n_data, n_atoms, n_dev))
    dev_grid = np.asarray(devices).reshape(n_data, n_atoms)
    return Mesh(dev_grid, ("data", "atoms"))


def shard_batch(mesh, x):
    """Shard axis 0 of ``x`` over the 'data' mesh axis."""
    spec = P("data") if x.ndim == 1 else P("data", *([None] * (x.ndim - 1)))
    return jax.device_put(x, NamedSharding(mesh, spec))


def replicate(mesh, x):
    """Replicate ``x`` across the mesh (read-only dictionary tables)."""
    return jax.device_put(x, NamedSharding(mesh, P()))


def sharded_df3_candidates(mesh, A1, A2, a3, y, M=1, tile=256):
    """Atom-axis tensor-parallel double-float candidate scan, [N1, N2, 1].

    The PRODUCTION exact-selection scan (ops/dfscan.df3_candidates) with
    the second sub-dictionary's atom axis sharded over the mesh's 'atoms'
    axis: each device scans the N1 x (N2 / n_atoms) candidate sub-grid,
    then the global top-M is reconstructed with an all-gather of each
    shard's champions and a (value, flat-rank) re-rank — the flat rank
    ``i1 * N2 + i2_global`` preserves the reference's first-minimum tie
    order over the full grid (mf_utils.py:382). Useful when the rotated
    A2 block of a very large dictionary should not live on one device.

    A1 (B, S, N1) / a3 (B, S, 1) / y (B, S) sharded over 'data' only;
    A2 (B, S, N2) over ('data', None, 'atoms'). Residual values are
    comparable across shards because the scan normalizes per COLUMN and
    per voxel (shard-invariant). Returns (cand (B, M, 2) int32, res
    (B, M), y_sq (B,)) exactly like the single-device scan.
    """
    from ..ops import dfscan
    N2 = A2.shape[2]
    n_at = mesh.shape["atoms"]
    assert N2 % n_at == 0, "atom axis must divide evenly across devices"
    n2_loc = N2 // n_at

    def local(A1_l, A2_l, a3_l, y_l):
        cand, vals, ysq = dfscan.df3_candidates(A1_l, A2_l, a3_l, y_l,
                                                M=M, tile=tile)
        shard = jax.lax.axis_index("atoms")
        flat = cand[:, :, 0] * N2 + shard * n2_loc + cand[:, :, 1]
        vals_g = jax.lax.all_gather(vals, "atoms", axis=1)   # (b, n_at, M)
        flats_g = jax.lax.all_gather(flat, "atoms", axis=1)
        B_l = vals.shape[0]
        vals_f = vals_g.reshape(B_l, -1)
        flats_f = flats_g.reshape(B_l, -1)
        # global top-M by (value, flat rank): index-sort, then a stable
        # value sort — equal residuals resolve to the earliest candidate
        order = jnp.argsort(flats_f, axis=1)
        v_o = jnp.take_along_axis(vals_f, order, axis=1)
        f_o = jnp.take_along_axis(flats_f, order, axis=1)
        rank = jnp.argsort(v_o, axis=1, stable=True)[:, :M]
        v_m = jnp.take_along_axis(v_o, rank, axis=1)
        f_m = jnp.take_along_axis(f_o, rank, axis=1)
        cand_m = jnp.stack([f_m // N2, f_m % N2], axis=2).astype(jnp.int32)
        return cand_m, v_m, ysq

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P("data", None, None),
                             P("data", None, "atoms"),
                             P("data", None, None), P("data", None)),
                   out_specs=(P("data", None, None), P("data", None),
                              P("data")),
                   check_vma=False)
    return fn(A1, A2, a3, y)


def shard_atoms(mesh, x):
    """Shard the last (atom) axis of ``x`` over the 'atoms' mesh axis,
    keeping axis 0 on 'data'."""
    spec = P("data", *([None] * (x.ndim - 2)), "atoms")
    return jax.device_put(x, NamedSharding(mesh, spec))
