"""Whole-brain-scale validation: a >=100k-voxel mixed-configuration volume
through MFModel.fit end to end on one GPU, with the measured bucket mix
and wall-clock against the <60 s whole-brain north star (BASELINE.md).

Configuration mix modeled on a real UKBB-style fit: most white-matter
voxels are 2-fascicle+CSF, a band gets the EAR compartment, plus
single-fascicle and CSF-only fringes.

Run:  python examples/whole_brain.py [n_voxels]
"""

import os
import sys
import time

import numpy as np
import jax.numpy as jnp

# allow running from a source checkout without installation
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from microstructure_fingerprinting_tpu import MFModel  # noqa: E402
from microstructure_fingerprinting_tpu import testing as mft
from microstructure_fingerprinting_tpu.ops import interp as mfi
from microstructure_fingerprinting_tpu.utils.scheme import b_values

N_VOX = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
NUM_ATOM = 782
MIX = [  # (K, csf, ear, share)
    ((2, 1, 0), 0.62),
    ((2, 1, 1), 0.10),
    ((1, 1, 0), 0.16),
    ((2, 0, 0), 0.07),
    ((0, 1, 0), 0.05),
]


def main():
    rng = np.random.RandomState(7)
    sch = mft.make_dense_scheme(n_shells=8, dirs_per_shell=64, n_b0=40)
    sig, dpar, dperp = mft.make_dictionary(sch, num_atom=NUM_ATOM)
    S = sch.shape[0]
    TE, b = sch[:, 6], b_values(sch)
    Dear = np.linspace(0.8e-9, 2.6e-9, 10)
    dic = {
        "dictionary": sig, "sch_mat": sch,
        "orientation": np.array([0.0, 0.0, 1.0]),
        "num_atom": NUM_ATOM, "num_ear": 10,
        "fasc_propnames": ["d_par", "d_perp"],
        "d_par": dpar, "d_perp": dperp,
        "T2_csf": 2.0, "DIFF_csf": 3.0e-9,
        "T2_ear": 0.8, "DIFF_ear": Dear,
    }
    print("Synthesizing %d voxels (%d seqs, %d atoms)..." %
          (N_VOX, S, NUM_ATOM))
    t0 = time.time()
    model = MFModel(dic)
    ms = model.ms_interpolator
    plan = mfi.plan_target_scheme(ms, sch)
    xs, ys_t, cnt = ms.device_tables()
    sig_csf = np.exp(-TE / 2.0) * np.exp(-b * 3.0e-9)
    sig_ear = np.exp(-TE / 0.8)[:, None] * np.exp(-b[:, None] * Dear[None])

    # voxel configuration assignment
    cfgs = np.concatenate([
        np.full(int(round(share * N_VOX)), i)
        for i, (_c, share) in enumerate(MIX)])[:N_VOX]
    cfgs = np.pad(cfgs, (0, N_VOX - cfgs.size), constant_values=0)
    rng.shuffle(cfgs)
    K = np.array([MIX[i][0][0] for i in cfgs])
    csf = np.array([MIX[i][0][1] for i in cfgs])
    ear = np.array([MIX[i][0][2] for i in cfgs])

    peaks = np.zeros((N_VOX, 6))
    dirs = rng.randn(N_VOX, 2, 3)
    dirs /= np.linalg.norm(dirs, axis=2, keepdims=True)
    ids = rng.randint(0, NUM_ATOM, (N_VOX, 2))
    eids = rng.randint(0, 10, N_VOX)
    nus = rng.rand(N_VOX, 4) + 0.3
    Y = np.zeros((N_VOX, S))

    # synthesize signals in device chunks via the rotation kernel
    # (the rotated block is B x 2 x S x N — keep it well under device memory)
    chunk = 256
    gdir_d = jnp.asarray(plan.gdir, dtype=xs.dtype)
    lo_d, hi_d = jnp.asarray(plan.shell_lo), jnp.asarray(plan.shell_hi)
    wG_d = jnp.asarray(plan.wG, dtype=xs.dtype)
    kk = np.arange(2)[None, :]
    w_f = nus[:, :2] * (kk < K[:, None])          # fascicle weights
    w_c = np.take_along_axis(nus, K[:, None], 1)[:, 0] * csf
    w_e = np.take_along_axis(nus, (K + csf)[:, None], 1)[:, 0] * ear
    peaks[:, :3] = np.where((K >= 1)[:, None], dirs[:, 0], 0.0)
    peaks[:, 3:] = np.where((K >= 2)[:, None], dirs[:, 1], 0.0)
    for st in range(0, N_VOX, chunk):
        en = min(st + chunk, N_VOX)
        D = mfi.eval_rotation_batch(
            xs, ys_t, cnt, gdir_d, lo_d, hi_d, wG_d,
            jnp.asarray(dirs[st:en], dtype=xs.dtype))
        cols = np.asarray(jnp.take_along_axis(
            D, jnp.asarray(ids[st:en])[:, :, None, None], axis=3)
            [..., 0])
        acc = np.einsum("vk,vks->vs", w_f[st:en], cols)
        acc += w_c[st:en, None] * sig_csf[None]
        acc += w_e[st:en, None] * sig_ear[:, eids[st:en]].T
        Y[st:en] = 400 * acc
    t_synth = time.time() - t0
    print("synthesis: %.1f s" % t_synth)

    shape = (N_VOX, 1, 1)
    data = Y.reshape(shape + (S,))
    mask = np.ones(shape)
    t0 = time.time()
    f = model.fit(data, mask, K.reshape(shape), peaks=peaks.reshape(
        shape + (6,)), pgse_scheme=sch, csf_mask=csf.reshape(shape),
        ear_mask=ear.reshape(shape), verbose=2)
    wall = time.time() - t0

    from collections import Counter
    mix_measured = Counter(zip(K.tolist(), csf.tolist(), ear.tolist()))
    act = N_VOX - mix_measured.get((0, 0, 0), 0)
    print("bucket mix:", dict(mix_measured))
    print("fit wall-clock: %.1f s  (%d voxels -> %.0f vox/s)  "
          "[north star: < 60 s whole brain, BASELINE.md]"
          % (wall, act, act / wall))

    in_m = mask > 0
    r2 = f.R2[in_m]
    solved = (K + csf + ear) > 0
    multi = solved & ((K + csf + ear) > 1)
    print("R2 median %.6f | min %.4f (multi-compartment voxels)"
          % (np.median(r2[solved]), np.min(r2[multi])))
    # noiseless synthesis: exact recovery check on the fascicle atoms
    two = (K == 2)
    d_par_f0 = f.d_par_f0[in_m]
    hit = np.isclose(d_par_f0[two], dic["d_par"][ids[two, 0]])
    print("exact d_par_f0 recovery on 2-fascicle voxels: %.2f%%"
          % (100.0 * np.mean(hit)))
    return f


if __name__ == "__main__":
    main()
