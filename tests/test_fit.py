"""End-to-end MFModel.fit tests.

Mirrors the reference's fingerprint-recovery strategy (noiseless signals
synthesized from the dictionary must be recovered exactly;
test_exhaustive_fingerprinting.py:163-249) driven through the full user API:
dictionary -> model init -> fit -> MFModelFit maps -> write_nifti, including
CSF/EAR compartments, mixed per-voxel configurations, and the sharded
device-parallel path (new coverage: the reference never tests parallel=True).
"""

import numpy as np
import pytest

from conftest import fixture_path, has_fixture

import jax

from microstructure_fingerprinting_tpu.utils import io as mfio
from microstructure_fingerprinting_tpu.utils import nifti
from microstructure_fingerprinting_tpu.ops import interp as mfi
from microstructure_fingerprinting_tpu.models.mf import (
    MFModel, cleanup_2fascicles)

UKBB_OK = has_fixture("ukbb_90_dirs_dictionary_hcp_deltas.mat")
HCP_OK = has_fixture("MC_dictionary_hcp.mat") and \
    has_fixture("hcp_mgh_1003.scheme1")


def _make_dictionary(n_atoms=48):
    """MFModel-ready dictionary dict built from the UKBB fixture."""
    raw = mfio.loadmat(fixture_path("ukbb_90_dirs_dictionary_hcp_deltas.mat"))
    sel = np.linspace(0, raw["dictionary"].shape[1] - 1, n_atoms).astype(int)
    dic = {
        "dictionary": np.asarray(raw["dictionary"])[:, sel],
        "sch_mat": np.asarray(raw["sch_mat"], dtype=np.float64),
        "orientation": np.asarray(raw["orientation"], dtype=np.float64),
        "num_atom": n_atoms,
        "num_ear": int(raw["Near"]),
        "fasc_propnames": ["rad", "fin"],
        "rad": np.asarray(raw["rad"])[sel],
        "fin": np.asarray(raw["fin"])[sel],
        "T2_csf": float(raw["T2_csf"]),
        "DIFF_csf": float(raw["CSF_DIFF"]),
        "T2_ear": float(raw["T2_ear"]),
        "DIFF_ear": np.asarray(raw["Dear"], dtype=np.float64),
    }
    return dic


def _synthetic_dictionary(n_atoms=48):
    """MFModel-ready dictionary dict from the self-contained generators of
    ``testing`` (no fixture needed): a 40-sequence dense scheme and
    zeppelin fingerprints, with CSF and EAR compartments."""
    from microstructure_fingerprinting_tpu import testing as mft
    sch = mft.make_dense_scheme(n_shells=3, dirs_per_shell=12, n_b0=4)
    sig, d_par, d_perp = mft.make_dictionary(sch, num_atom=n_atoms)
    return {
        "dictionary": sig,
        "sch_mat": sch,
        "orientation": np.array([0.0, 0.0, 1.0]),
        "num_atom": n_atoms,
        "num_ear": 6,
        "fasc_propnames": ["d_par", "d_perp"],
        "d_par": d_par,
        "d_perp": d_perp,
        "T2_csf": 2.0,
        "DIFF_csf": 3.0e-9,
        "T2_ear": 0.8,
        "DIFF_ear": np.linspace(0.8e-9, 2.6e-9, 6),
    }


def _synth_volume(dic, rng):
    """Synthesize a small noiseless volume with mixed configurations.

    Returns (data, mask, numfasc, peaks, csf_mask, ear_mask, gt dict).
    """
    sch = dic["sch_mat"]
    num_seq = sch.shape[0]
    shape = (3, 3, 1)
    nvox = int(np.prod(shape))
    ms = mfi.init_PGSE_multishell_interp(dic["dictionary"], sch,
                                         dic["orientation"])
    TE = sch[:, 6]
    from microstructure_fingerprinting_tpu.utils.scheme import b_values
    b = b_values(sch)
    sig_csf = np.exp(-TE / dic["T2_csf"]) * np.exp(-b * dic["DIFF_csf"])
    sig_ear = (np.exp(-TE / dic["T2_ear"])[:, None]
               * np.exp(-b[:, None] * dic["DIFF_ear"][None, :]))

    data = np.zeros(shape + (num_seq,))
    mask = np.ones(shape)
    numfasc = np.zeros(shape)
    peaks = np.zeros(shape + (6,))
    csf_mask = np.zeros(shape)
    ear_mask = np.zeros(shape)
    gt = {"ID": np.zeros((nvox, 2), dtype=int),
          "nu": np.zeros((nvox, 4)),
          "ear_id": np.zeros(nvox, dtype=int),
          "cfg": []}

    # voxel configurations: (K, csf, ear)
    cfgs = [(1, 0, 0), (2, 0, 0), (2, 1, 0), (1, 1, 0), (2, 0, 1),
            (1, 1, 1), (2, 1, 1), (0, 1, 0), (0, 0, 0)]
    M0 = 400.0
    for v, (K, c, e) in enumerate(cfgs):
        ijk = np.unravel_index(v, shape)
        numfasc[ijk] = K
        csf_mask[ijk] = c
        ear_mask[ijk] = e
        gt["cfg"].append((K, c, e))
        y = np.zeros(num_seq)
        nus = rng.rand(K + c + e) + 0.25
        nus /= nus.sum() if nus.size else 1.0
        comp = 0
        for k in range(K):
            d = rng.randn(3)
            d /= np.linalg.norm(d)
            peaks[ijk][3 * k:3 * k + 3] = d
            a = rng.randint(dic["num_atom"])
            gt["ID"][v, k] = a
            D = mfi.interp_PGSE_from_multishell(sch, d, msinterp=ms)
            y += M0 * nus[comp] * D[:, a]
            gt["nu"][v, comp] = nus[comp]
            comp += 1
        if c:
            y += M0 * nus[comp] * sig_csf
            gt["nu"][v, comp] = nus[comp]
            comp += 1
        if e:
            # skip Dear[0], which equals DIFF_csf in this fixture (the EAR
            # and CSF columns would be identical -> ambiguous split)
            eid = 3 + rng.randint(dic["num_ear"] - 3)
            gt["ear_id"][v] = eid
            y += M0 * nus[comp] * sig_ear[:, eid]
            gt["nu"][v, comp] = nus[comp]
            comp += 1
        data[ijk] = y
    return data, mask, numfasc, peaks, csf_mask, ear_mask, gt


@pytest.mark.skipif(not UKBB_OK, reason="UKBB fixture unavailable")
def test_fit_end_to_end_recovery(rng, tmp_path):
    dic = _make_dictionary()
    data, mask, numfasc, peaks, csf_mask, ear_mask, gt = _synth_volume(
        dic, rng)
    model = MFModel(dic)
    f = model.fit(data, mask, numfasc, peaks=peaks,
                  pgse_scheme=dic["sch_mat"], csf_mask=csf_mask,
                  ear_mask=ear_mask, verbose=0, batch_size=8)

    shape = mask.shape
    for v, (K, c, e) in enumerate(gt["cfg"]):
        ijk = np.unravel_index(v, shape)
        comp = 0
        for k in range(K):
            nu_k = getattr(f, "frac_f%d" % k)[ijk]
            assert np.isclose(nu_k, gt["nu"][v, comp], atol=1e-6), \
                "vox %d frac_f%d" % (v, k)
            # property maps identify the exact fingerprint
            assert np.isclose(getattr(f, "rad_f%d" % k)[ijk],
                              dic["rad"][gt["ID"][v, k]]), \
                "vox %d rad_f%d" % (v, k)
            comp += 1
        if c:
            assert np.isclose(f.frac_csf[ijk], gt["nu"][v, comp], atol=1e-6)
            comp += 1
        if e:
            assert np.isclose(f.frac_ear[ijk], gt["nu"][v, comp], atol=1e-6)
            assert np.isclose(f.D_ear[ijk],
                              dic["DIFF_ear"][gt["ear_id"][v]])
            comp += 1
        if K + c + e > 0:
            # algebraic residual leaves O(eps * ||y||^2 / S) noise
            assert f.MSE[ijk] < 1e-7
            if K + c + e > 1 or K > 0:
                assert f.R2[ijk] > 1 - 1e-6
        else:
            assert f.M0[ijk] == 0 and f.MSE[ijk] == 0

    # rad_tot is the nu-weighted sum of the per-fascicle radii
    v2 = 1  # config (2, 0, 0)
    ijk = np.unravel_index(v2, shape)
    want = (gt["nu"][v2, 0] * dic["rad"][gt["ID"][v2, 0]]
            + gt["nu"][v2, 1] * dic["rad"][gt["ID"][v2, 1]])
    assert np.isclose(f.rad_tot[ijk], want)

    # NIfTI export round-trip
    files = f.write_nifti(str(tmp_path / "mf_out.nii.gz"),
                          affine=np.eye(4))
    assert len(files) == len(f.param_names)
    img = nifti.load(str(tmp_path / "mf_out_MSE.nii.gz"))
    assert np.allclose(img.get_fdata(), f.MSE)
    img = nifti.load(str(tmp_path / "mf_out_peak_f0.nii.gz"))
    assert img.shape == shape + (3,)


@pytest.mark.skipif(not UKBB_OK, reason="UKBB fixture unavailable")
def test_fit_parallel_matches_serial(rng):
    """Sharded (8 virtual devices) fit == single-device fit."""
    assert len(jax.devices()) == 8, "conftest should provide 8 cpu devices"
    dic = _make_dictionary(n_atoms=48)
    data, mask, numfasc, peaks, csf_mask, ear_mask, gt = _synth_volume(
        dic, rng)
    model = MFModel(dic)
    kw = dict(peaks=peaks, pgse_scheme=dic["sch_mat"], csf_mask=csf_mask,
              ear_mask=ear_mask, verbose=0, batch_size=8)
    f1 = model.fit(data, mask, numfasc, **kw)
    f2 = model.fit(data, mask, numfasc, parallel=True, **kw)
    for p in f1.param_names:
        # SPMD partitioning reorders reductions; near-zero residual maps
        # (MSE) may differ in the last bits
        np.testing.assert_allclose(getattr(f2, p), getattr(f1, p),
                                   rtol=1e-9, atol=1e-8, err_msg=p)


@pytest.mark.skipif(not HCP_OK, reason="HCP fixture unavailable")
def test_hcp_dict_recovery(rng):
    """Noiseless 2-fascicle + CSF recovery on the real HCP MC dictionary
    (reference test_exhaustive_fingerprinting.py:163-249)."""
    from microstructure_fingerprinting_tpu.ops import nnls as mfn
    from microstructure_fingerprinting_tpu.utils import scheme as schm

    ld = mfio.loadmat(fixture_path("MC_dictionary_hcp.mat"))
    dic_mgh = ld["dic_fascicle_refdir"]
    refdir = np.array([0.0, 0.0, 1.0])
    Natoms = dic_mgh.shape[1]
    WM_DIFF = ld["WM_DIFF"]
    S0_fasc = ld["S0_fascicle"]
    sig_CSF = ld["sig_csf"]

    sch_mat = schm.import_PGSE_scheme(fixture_path("hcp_mgh_1003.scheme1"))
    num_B0 = 40
    sch_mat_b0 = np.vstack((np.zeros((num_B0, sch_mat.shape[1])), sch_mat))
    sch_mat_b0[:num_B0, 4:] = sch_mat[0, 4:]
    num_mri = sch_mat_b0.shape[0]

    Nfasc = 2
    i_gt = 86
    fascdirs = rng.randn(3, Nfasc)
    fascdirs /= np.sqrt(np.sum(fascdirs ** 2, axis=0, keepdims=True))
    nu_gt = rng.rand(Nfasc + 1)
    nu_gt /= nu_gt.sum()
    M0_gt = 500.0

    y_gt = np.zeros(num_mri)
    dictionary = np.zeros((num_mri, Nfasc * Natoms + 1))
    for ifasc in range(Nfasc):
        rot = mfi.rotate_atom(dic_mgh, sch_mat_b0, refdir,
                              fascdirs[:, ifasc], WM_DIFF, S0_fasc,
                              warnings=False)
        dictionary[:, ifasc * Natoms:(ifasc + 1) * Natoms] = rot
        y_gt += M0_gt * nu_gt[ifasc] * rot[:, i_gt]
    dictionary[:, -1] = sig_CSF
    y_gt += M0_gt * nu_gt[-1] * sig_CSF

    (w_nnz, ind_subdic, ind_totdic, min_obj,
     y_rec) = mfn.solve_exhaustive_posweights(
        dictionary, y_gt, np.array([Natoms, Natoms, 1]))
    nu = w_nnz / np.sum(w_nnz)
    assert all(ind_subdic[i] == i_gt for i in range(Nfasc)), \
        "fingerprint IDs not recovered"
    assert np.allclose(nu, nu_gt), "fractions not recovered"


def test_cleanup_2fascicles():
    mask = np.ones((5, 1))
    # voxels: [strong pair] [close pair -> merge] [small f0 -> transfer]
    #         [tiny both -> none] [small f1 absolute -> drop]
    frac1 = np.array([[0.5], [0.4], [0.05], [0.04], [0.6]])
    frac2 = np.array([[0.4], [0.4], [0.5], [0.05], [0.05]])
    mu1 = np.zeros((5, 1, 3))
    mu2 = np.zeros((5, 1, 3))
    mu1[..., 0] = 1.0                      # x-axis
    mu2[..., 2] = 1.0                      # z-axis
    th = np.deg2rad(10)
    mu2[1, 0] = [np.cos(th), np.sin(th), 0]  # 10 deg from mu1 -> merge
    peaks, nfasc = cleanup_2fascicles(frac1, frac2, 'peaks', mu1, mu2, mask)
    assert peaks.shape == (5, 1, 6)
    assert nfasc[0, 0] == 2
    assert nfasc[1, 0] == 1                 # merged
    # merged direction bisects the two unit vectors
    merged = peaks[1, 0, :3]
    assert np.isclose(np.linalg.norm(merged), 1)
    assert abs(merged @ np.array([np.cos(th / 2), np.sin(th / 2), 0])) > \
        1 - 1e-6
    assert nfasc[2, 0] == 1                 # f0 small: f1 transferred
    assert np.allclose(peaks[2, 0, :3], [0, 0, 1])
    assert nfasc[3, 0] == 0                 # both below w_small
    assert np.allclose(peaks[3, 0], 0)
    assert nfasc[4, 0] == 1                 # f1 dropped
    assert np.allclose(peaks[4, 0, 3:], 0)


def test_nifti_roundtrip(tmp_path, rng):
    data = rng.rand(4, 5, 6).astype(np.float64)
    aff = np.array([[2.0, 0, 0, -10], [0, 2.0, 0, -20],
                    [0, 0, 2.0, -30], [0, 0, 0, 1]])
    p = str(tmp_path / "x.nii.gz")
    nifti.save(nifti.Nifti1Image(data, aff), p)
    img = nifti.load(p)
    assert np.allclose(img.get_fdata(), data)
    assert np.allclose(img.affine, aff)
    # uncompressed too
    p2 = str(tmp_path / "y.nii")
    nifti.save(nifti.Nifti1Image(data.astype(np.float32), aff), p2)
    img2 = nifti.load(p2)
    assert np.allclose(img2.get_fdata(), data, atol=1e-6)


@pytest.mark.skipif(
    not has_fixture("C001_dwi_small.nii.gz"),
    reason="C001 fixtures unavailable")
def test_nifti_reads_real_fixtures():
    """Our pure-NumPy NIfTI reader handles nibabel-written fixtures."""
    img = nifti.load(fixture_path("C001_dwi_small.nii.gz"))
    assert img.shape[-1] == 149  # 149 DWI volumes (SURVEY.md fixture notes)
    assert img.affine.shape == (4, 4)
    data = img.get_fdata()
    assert np.isfinite(data).all()
    mask = nifti.load(fixture_path("C001_mask_small.nii.gz")).get_fdata()
    assert mask.shape == img.shape[:-1]
    assert mask.max() > 0


@pytest.mark.skipif(not UKBB_OK, reason="UKBB fixture unavailable")
def test_refined_fit_matches_exact(rng):
    """refine=True (f32 scan + f64 host re-score) == refine=False (f64 scan):
    the precision path used on the GPU reproduces exact float64
    selection."""
    dic = _make_dictionary(n_atoms=48)
    data, mask, numfasc, peaks, csf_mask, ear_mask, gt = _synth_volume(
        dic, rng)
    model = MFModel(dic)
    kw = dict(peaks=peaks, pgse_scheme=dic["sch_mat"], csf_mask=csf_mask,
              ear_mask=ear_mask, verbose=0, batch_size=8)
    f_exact = model.fit(data, mask, numfasc, refine=False, **kw)
    f_ref = model.fit(data, mask, numfasc, refine=True, **kw)
    for p in f_exact.param_names:
        # atol floor: near-zero noiseless residuals (MSE) are cancellation
        # noise on both computation paths
        np.testing.assert_allclose(getattr(f_ref, p), getattr(f_exact, p),
                                   rtol=1e-6, atol=1e-7, err_msg=p)


def test_candidates_contain_optimum(rng):
    """Device top-M candidate sets contain the exact optimum (f64 scan)."""
    from microstructure_fingerprinting_tpu.ops import nnls as mfn
    B, S, N1, N2, N3 = 4, 40, 50, 45, 3
    A1, A2, A3 = rng.randn(B, S, N1), rng.randn(B, S, N2), rng.randn(B, S, N3)
    y = rng.randn(B, S)
    w, ind, obj = mfn.exhaustive_3_batched(A1, A2, A3, y)
    cand = np.asarray(mfn.exhaustive_candidates_blocks(
        (A1, A2, A3), y, M=8))
    ind = np.asarray(ind)
    for b in range(B):
        found = np.any(np.all(cand[b] == ind[b][None, :], axis=1))
        assert found, "optimum missing from candidate set (voxel %d)" % b
    # K=2 as well
    w2, ind2, _ = mfn.exhaustive_2_batched(A1, A2, y)
    cand2 = np.asarray(mfn.exhaustive_candidates_blocks((A1, A2), y, M=8))
    ind2 = np.asarray(ind2)
    for b in range(B):
        assert np.any(np.all(cand2[b] == ind2[b][None, :], axis=1))


@pytest.mark.skipif(not UKBB_OK, reason="UKBB fixture unavailable")
def test_pallas_engine_matches_default(rng):
    """engine='fast' (the double-float fast path) == the general XLA
    path for the 2-fascicle + CSF configuration."""
    dic = _make_dictionary(n_atoms=48)
    sch = dic["sch_mat"]
    shape = (2, 2, 1)
    ms = mfi.init_PGSE_multishell_interp(dic["dictionary"], sch,
                                         dic["orientation"])
    from microstructure_fingerprinting_tpu.utils.scheme import b_values
    TE, b = sch[:, 6], b_values(sch)
    sig_csf = np.exp(-TE / dic["T2_csf"]) * np.exp(-b * dic["DIFF_csf"])
    data = np.zeros(shape + (sch.shape[0],))
    peaks = np.zeros(shape + (6,))
    for v in range(4):
        ijk = np.unravel_index(v, shape)
        d1, d2 = rng.randn(3), rng.randn(3)
        d1 /= np.linalg.norm(d1)
        d2 /= np.linalg.norm(d2)
        peaks[ijk][:3], peaks[ijk][3:] = d1, d2
        a1, a2 = rng.randint(48), rng.randint(48)
        D1 = mfi.interp_PGSE_from_multishell(sch, d1, msinterp=ms)
        D2 = mfi.interp_PGSE_from_multishell(sch, d2, msinterp=ms)
        data[ijk] = (100 * D1[:, a1] + 150 * D2[:, a2] + 80 * sig_csf)
    model = MFModel(dic)
    # batch_size matches test_pallas_engine_ear_matches_xla so the two
    # engine tests share every compiled chunk program within the module
    kw = dict(peaks=peaks, pgse_scheme=sch, csf_mask=1, verbose=0,
              batch_size=8, refine=True, topm=8)
    f_x = model.fit(data, np.ones(shape), 2, engine="xla", **kw)
    f_p = model.fit(data, np.ones(shape), 2, engine="fast", **kw)
    # both engines refine exactly in f64, but the fast pool resolves
    # residual gaps only down to the f32 scan noise (~1e-7 * ||y||^2); on
    # noiseless degenerate data a voxel may resolve to a physically
    # equivalent near-tie. Require equal solution QUALITY at that resolution
    # and near-identical maps.
    scale = float(np.mean(data ** 2))
    assert np.all(f_p.MSE <= f_x.MSE + 1e-6 * scale)
    np.testing.assert_allclose(f_p.R2, f_x.R2, atol=1e-6)
    # discrete property maps are only comparable where both engines resolved
    # to the same candidate (near-tie voxels legitimately differ)
    same = np.abs(f_p.MSE - f_x.MSE) <= 1e-10 * scale
    assert same.sum() >= 3  # most voxels resolve identically
    for p in f_x.param_names:
        a, b_ = getattr(f_p, p), getattr(f_x, p)
        np.testing.assert_allclose(a[same], b_[same], rtol=1e-6, atol=1e-9,
                                   err_msg=p)


@pytest.mark.skipif(not UKBB_OK, reason="UKBB fixture unavailable")
@pytest.mark.nightly
def test_pallas_engine_ear_matches_xla(rng):
    """engine='fast' == engine='xla' on the full mixed-config volume
    including the 2-fascicle + CSF + EAR bucket (df4 scan path).

    nightly: the df4 engine comparison compiles the largest XLA:CPU
    programs in the suite; the same code paths are covered per-kernel by
    test_twopass_production_graph (EAR two-pass + df4 scan) and
    test_k1_fast_path_matches_general (EAR finalize)."""
    dic = _make_dictionary(n_atoms=48)
    data, mask, numfasc, peaks, csf_mask, ear_mask, gt = _synth_volume(
        dic, rng)
    model = MFModel(dic)
    kw = dict(peaks=peaks, pgse_scheme=dic["sch_mat"], csf_mask=csf_mask,
              ear_mask=ear_mask, verbose=0, batch_size=8, refine=True,
              topm=8)
    f_x = model.fit(data, mask, numfasc, engine="xla", **kw)
    f_p = model.fit(data, mask, numfasc, engine="fast", **kw)
    scale = float(np.mean(data ** 2))
    assert np.all(f_p.MSE <= f_x.MSE + 1e-6 * scale)
    same = np.abs(f_p.MSE - f_x.MSE) <= 1e-10 * scale
    assert same.sum() >= same.size - 1
    for p in f_x.param_names:
        a, b_ = getattr(f_p, p), getattr(f_x, p)
        np.testing.assert_allclose(a[same], b_[same], rtol=1e-6, atol=1e-9,
                                   err_msg=p)


def test_dfscan_matches_exhaustive_batched(rng):
    """Double-float candidate scans find the same optimum as the tiled XLA
    exhaustive scans, K=2, K=3 (size-1 third block) and the 4-block case."""
    from microstructure_fingerprinting_tpu.ops import nnls as mfn
    from microstructure_fingerprinting_tpu.ops import dfscan
    B, S, N1, N2 = 3, 40, 70, 60
    A1 = rng.randn(B, S, N1).astype(np.float32)
    A2 = rng.randn(B, S, N2).astype(np.float32)
    a3 = rng.randn(B, S, 1).astype(np.float32)
    y = rng.randn(B, S).astype(np.float32)
    cand, _vals, _ = dfscan.df2_candidates(
        jnp_asarray(A1), jnp_asarray(A2), jnp_asarray(y), M=4)
    _w0, ind0, _obj0 = mfn.exhaustive_2_batched(A1, A2, y)
    assert np.all(np.asarray(cand)[:, 0] == np.asarray(ind0))
    cand, _vals, _ = dfscan.df3_candidates(
        jnp_asarray(A1), jnp_asarray(A2), jnp_asarray(a3), jnp_asarray(y),
        M=4)
    _w0, ind0, _obj0 = mfn.exhaustive_3_batched(A1, A2, a3, y)
    assert np.all(np.asarray(cand)[:, 0] == np.asarray(ind0)[:, :2])
    # K=4 (2 fascicles + CSF + EAR shape)
    a4 = rng.randn(B, S, 5).astype(np.float32)
    cand, _vals, _ = dfscan.df4_candidates(
        jnp_asarray(A1), jnp_asarray(A2), jnp_asarray(a3), jnp_asarray(a4),
        jnp_asarray(y), M=4)
    _w0, ind0, _obj0 = mfn.exhaustive_4_batched(A1, A2, a3, a4, y)
    assert np.all(np.asarray(cand)[:, 0, :] == np.asarray(ind0))


def jnp_asarray(x):
    import jax.numpy as jnp
    return jnp.asarray(x)


def test_grouped_rotation_matches_gather(rng):
    from microstructure_fingerprinting_tpu import testing as mft
    sch = mft.make_dense_scheme(n_shells=3, dirs_per_shell=16, n_b0=4)
    sig, _, _ = mft.make_dictionary(sch, num_atom=30)
    ms = mfi.init_PGSE_multishell_interp(sig, sch, np.array([0.0, 0, 1.0]))
    plan = mfi.plan_target_scheme(ms, sch)
    xs, ys, cnt = ms.device_tables()
    import jax.numpy as jnp
    nd = rng.randn(5, 2, 3)
    nd /= np.linalg.norm(nd, axis=2, keepdims=True)
    rot = mfi.make_grouped_rotation(ms, plan)
    D_new = np.asarray(rot(ys, jnp.asarray(nd)))
    D_old = np.asarray(mfi.eval_rotation_batch(
        xs, ys, cnt, jnp.asarray(plan.gdir), jnp.asarray(plan.shell_lo),
        jnp.asarray(plan.shell_hi), jnp.asarray(plan.wG), jnp.asarray(nd)))
    assert np.max(np.abs(D_new - D_old)) < 1e-10


@pytest.mark.skipif(not UKBB_OK, reason="UKBB fixture unavailable")
@pytest.mark.nightly
def test_parallel_with_refine(rng):
    """Sharded fit with float64 refinement == serial refined fit (the GPU
    default combination when parallel=True)."""
    dic = _make_dictionary(n_atoms=48)
    data, mask, numfasc, peaks, csf_mask, ear_mask, gt = _synth_volume(
        dic, rng)
    model = MFModel(dic)
    kw = dict(peaks=peaks, pgse_scheme=dic["sch_mat"], csf_mask=csf_mask,
              ear_mask=ear_mask, verbose=0, batch_size=8, refine=True)
    f1 = model.fit(data, mask, numfasc, **kw)
    f2 = model.fit(data, mask, numfasc, parallel=True, **kw)
    for p in f1.param_names:
        np.testing.assert_allclose(getattr(f2, p), getattr(f1, p),
                                   rtol=1e-9, atol=1e-8, err_msg=p)


def test_fit_csf_ear_only_volume(rng):
    """maxfasc=0 volume (CSF-only and EAR-only voxels) fits exactly."""
    from microstructure_fingerprinting_tpu import testing as mft
    from microstructure_fingerprinting_tpu.utils.scheme import b_values
    sch = mft.make_dense_scheme(n_shells=3, dirs_per_shell=12, n_b0=4)
    sig, dpar, _ = mft.make_dictionary(sch, num_atom=16)
    dic = {"dictionary": sig, "sch_mat": sch,
           "orientation": np.array([0., 0., 1.]), "num_atom": 16,
           "num_ear": 2, "fasc_propnames": ["dpar"], "dpar": dpar,
           "T2_csf": 2.0, "DIFF_csf": 3e-9, "T2_ear": 1.5,
           "DIFF_ear": np.array([1.0e-9, 0.5e-9])}
    model = MFModel(dic)
    TE, b = sch[:, 6], b_values(sch)
    shape = (2, 1, 1)
    data = np.zeros(shape + (sch.shape[0],))
    data[0, 0, 0] = 120 * np.exp(-TE / 2.0) * np.exp(-b * 3e-9)
    data[1, 0, 0] = 80 * np.exp(-TE / 1.5) * np.exp(-b * 0.5e-9)
    fit = model.fit(data, np.ones(shape), 0, peaks=np.zeros(shape + (0,)),
                    pgse_scheme=sch, csf_mask=np.array([[[1]], [[0]]]),
                    ear_mask=np.array([[[0]], [[1]]]), verbose=0,
                    batch_size=2)
    assert np.isclose(fit.frac_csf[0, 0, 0], 1.0)
    assert np.isclose(fit.M0[0, 0, 0], 120.0)
    assert np.isclose(fit.frac_ear[1, 0, 0], 1.0)
    assert np.isclose(fit.D_ear[1, 0, 0], 0.5e-9)
    assert fit.MSE.max() < 1e-10


def test_trivial_bucket_matches_generic(rng):
    """run_bucket_trivial (closed-form host K=0 path) == run_bucket's
    generic compiled step for every fascicle-free configuration."""
    from microstructure_fingerprinting_tpu import testing as mft
    from microstructure_fingerprinting_tpu.models import fit as fit_mod
    from microstructure_fingerprinting_tpu.ops import interp as mfi
    from microstructure_fingerprinting_tpu.utils.scheme import b_values
    sch = mft.make_dense_scheme(n_shells=3, dirs_per_shell=8, n_b0=4)
    sig, _, _ = mft.make_dictionary(sch, num_atom=8)
    ms = mfi.init_PGSE_multishell_interp(sig, sch,
                                         np.array([0.0, 0.0, 1.0]))
    plan = mfi.plan_target_scheme(ms, sch)
    tables = ms.device_tables()
    TE, b = sch[:, 6], b_values(sch)
    sig_csf = np.exp(-TE / 2.0) * np.exp(-b * 3.0e-9)
    Dear = np.array([1.5e-9, 0.7e-9, 2.2e-9])
    sig_ear = np.exp(-TE / 1.2)[:, None] * np.exp(-b[:, None] * Dear[None])
    n = 6
    mixw = rng.rand(n, 2) + 0.1
    y = (mixw[:, :1] * 90 * sig_csf[None]
         + mixw[:, 1:] * 70 * sig_ear[:, 1][None]
         + 0.5 * rng.randn(n, sch.shape[0]))
    peaks0 = np.zeros((n, 0))
    for csf_on, ear_on in ((True, False), (False, True), (True, True)):
        triv = fit_mod.run_bucket_trivial(y, sig_csf, sig_ear,
                                          csf_on, ear_on)
        import jax.numpy as jnp
        xs = tables[0]
        plan_t = (jnp.asarray(plan.gdir, xs.dtype),
                  jnp.asarray(plan.shell_lo), jnp.asarray(plan.shell_hi),
                  jnp.asarray(plan.wG, xs.dtype))
        gen = fit_mod.run_bucket(tables, plan_t, peaks0, y, sig_csf,
                                 sig_ear, 0, csf_on, ear_on, batch=n)
        np.testing.assert_array_equal(triv[1], gen[1])      # indices
        np.testing.assert_allclose(triv[0], gen[0], rtol=1e-5, atol=1e-8)
        np.testing.assert_allclose(triv[2], gen[2], rtol=1e-5, atol=1e-8)
        np.testing.assert_allclose(triv[4], gen[4], rtol=1e-4, atol=1e-6)


def test_device_finalize_matches_host_refine(rng):
    """run_bucket_fast with device finalize (the GPU production path:
    scan winner + ops/dfscan.df_nnls_cols weights/metrics on device, one
    pull per bucket) == the float64 host re-scoring path."""
    from microstructure_fingerprinting_tpu import testing as mft
    from microstructure_fingerprinting_tpu.models.fit import run_bucket_fast
    from microstructure_fingerprinting_tpu.utils.scheme import b_values
    wl = mft.make_fit_workload(num_atom=48, n_vox=24, n_shells=3,
                               dirs_per_shell=12, n_b0=4)
    ms, plan = wl["msinterp"], wl["plan"]
    _xs, ys_t, _cnt = ms.device_tables()
    peaks = wl["peaks"].reshape(24, 6)
    y, csf = wl["y"], wl["sig_csf"]
    ysq = np.sum(y.astype(np.float64) ** 2, axis=1)
    sch = wl["sch_mat"]
    TE, b = sch[:, 6], b_values(sch)
    Dear = np.linspace(0.8e-9, 2.6e-9, 4)
    sig_ear = (np.exp(-TE / 0.8)[:, None]
               * np.exp(-b[:, None] * Dear[None]))
    for kw in ({}, {"sig_ear": sig_ear, "ear_on": True}):
        host = run_bucket_fast(ms, plan, ys_t, peaks, y, csf, 2, True,
                               batch=8, device_finalize=False, **kw)
        dev = run_bucket_fast(ms, plan, ys_t, peaks, y, csf, 2, True,
                              batch=8, device_finalize=True, **kw)
        w_h, i_h, o_h, m_h, r_h = host
        w_d, i_d, o_d, m_d, r_d = dev
        # fascicle/CSF selections identical; the EAR slot may differ only
        # on exact ties (same objective)
        assert np.array_equal(i_h[:, :2], i_d[:, :2])
        np.testing.assert_allclose(o_d, o_h, atol=2e-9 * ysq.max())
        assert np.max(np.abs(w_d - w_h)) <= 1e-6 * np.max(np.abs(w_h))
        np.testing.assert_allclose(r_d, r_h, atol=1e-6)


def test_fit_noisy_invariant(rng):
    """Reference noisy-data invariant at the MFModel.fit level: the fitted
    objective is strictly better than the planted ground truth's residual
    (= ||added noise||^2), per voxel, through the production fast path
    (reference test_exhaustive_fingerprinting.py:141-153 lifts the same
    invariant at the solver level)."""
    from microstructure_fingerprinting_tpu import MFModel
    from microstructure_fingerprinting_tpu.ops.noise import gen_SoS_MRI
    dic = _synthetic_dictionary(n_atoms=48)
    data, mask, numfasc, peaks, csf_mask, ear_mask, _gt = _synth_volume(
        dic, rng)
    np.random.seed(4242)
    sigma = 0.01 * float(data.max())
    noisy = gen_SoS_MRI(data, sigma_g=sigma, N=1)
    noise_sq = np.sum((noisy - data) ** 2, axis=-1)
    model = MFModel(dic)
    fit = model.fit(noisy, mask, numfasc, peaks=peaks,
                    pgse_scheme=dic["sch_mat"], csf_mask=csf_mask,
                    ear_mask=ear_mask, verbose=0)
    num_seq = dic["sch_mat"].shape[0]
    obj = fit.MSE * num_seq
    active = (numfasc + csf_mask + ear_mask) > 0
    # the exhaustive fit can always do at least as well as the planted
    # ground truth, whose residual is exactly the added noise
    assert np.all(obj[active] <= noise_sq[active] * (1 + 1e-10)), \
        "fit objective exceeds the planted ground truth residual"
    assert np.all(fit.R2[active] > 0.9)


def test_twopass_production_graph(rng, monkeypatch):
    """The GPU production graph — two-pass exact scan (f32 row pass +
    df re-scan, ops/f32scan) + device finalize — on a dictionary large
    enough to trigger it, and the EAR bucket's one-pass df4 scan with the
    device finalize, vs the float64 host re-scoring path."""
    import dataclasses
    from microstructure_fingerprinting_tpu import config as cfg
    from microstructure_fingerprinting_tpu import testing as mft
    from microstructure_fingerprinting_tpu.models.fit import run_bucket_fast
    from microstructure_fingerprinting_tpu.utils.scheme import b_values
    monkeypatch.setitem(cfg.DEFAULTS, "solver", dataclasses.replace(
        cfg.DEFAULTS["solver"], twopass_rows=16))
    wl = mft.make_fit_workload(num_atom=72, n_vox=8, n_shells=3,
                               dirs_per_shell=12, n_b0=4)
    ms, plan = wl["msinterp"], wl["plan"]
    _xs, ys_t, _cnt = ms.device_tables()
    peaks = wl["peaks"].reshape(8, 6)
    y, csf = wl["y"], wl["sig_csf"]
    ysq = np.sum(y.astype(np.float64) ** 2, axis=1)
    sch = wl["sch_mat"]
    TE, b = sch[:, 6], b_values(sch)
    Dear = np.linspace(0.8e-9, 2.6e-9, 4)
    sig_ear = (np.exp(-TE / 0.8)[:, None]
               * np.exp(-b[:, None] * Dear[None]))
    # the EAR bucket runs the one-pass df4 scan with the same finalize
    for kw in ({}, {"sig_ear": sig_ear, "ear_on": True}):
        host = run_bucket_fast(ms, plan, ys_t, peaks, y, csf, 2, True,
                               batch=8, device_finalize=False, **kw)
        dev = run_bucket_fast(ms, plan, ys_t, peaks, y, csf, 2, True,
                              batch=8, device_finalize=True, **kw)
        assert np.array_equal(host[1][:, :2], dev[1][:, :2])
        np.testing.assert_allclose(dev[2], host[2], atol=2e-9 * ysq.max())
        np.testing.assert_allclose(dev[4], host[4], atol=1e-6)


def test_twopass_overflow_fallback(rng, monkeypatch):
    """With the row budget squeezed below the tie count (duplicate atoms),
    the overflow host fallback must still return the exact objective."""
    import dataclasses
    from microstructure_fingerprinting_tpu import config as cfg
    from microstructure_fingerprinting_tpu import testing as mft
    from microstructure_fingerprinting_tpu.models.fit import run_bucket_fast
    from microstructure_fingerprinting_tpu.ops import interp as mfi
    sch = mft.make_dense_scheme(n_shells=3, dirs_per_shell=12, n_b0=4)
    sig, _, _ = mft.make_dictionary(sch, num_atom=6)
    sig = np.tile(sig, (1, 12))                       # 72 cols, 12x each
    ms = mfi.init_PGSE_multishell_interp(sig, sch,
                                         np.array([0.0, 0.0, 1.0]))
    plan = mfi.plan_target_scheme(ms, sch)
    _xs, ys_t, _cnt = ms.device_tables()
    n = 6
    peaks = rng.randn(n, 2, 3)
    peaks /= np.linalg.norm(peaks, axis=2, keepdims=True)
    TE = sch[:, 6]
    from microstructure_fingerprinting_tpu.utils.scheme import b_values
    csf = np.exp(-TE / 2.0) * np.exp(-b_values(sch) * 3.0e-9)
    y = 300 * (0.6 * sig[:, 2][None] + 0.4 * csf[None]
               + 0 * peaks[:, 0, :1])
    y = np.broadcast_to(y, (n, sch.shape[0])).copy()
    monkeypatch.setitem(cfg.DEFAULTS, "solver", dataclasses.replace(
        cfg.DEFAULTS["solver"], twopass_rows=8))
    host = run_bucket_fast(ms, plan, ys_t, peaks.reshape(n, 6), y, csf,
                           2, True, batch=2, device_finalize=False)
    dev = run_bucket_fast(ms, plan, ys_t, peaks.reshape(n, 6), y, csf,
                          2, True, batch=2, device_finalize=True)
    ysq = np.sum(y.astype(np.float64) ** 2, axis=1)
    np.testing.assert_allclose(dev[2], host[2], atol=2e-9 * ysq.max())
    np.testing.assert_allclose(dev[4], host[4], atol=1e-6)


def test_k1_fast_path_matches_general(rng):
    """1-fascicle (+CSF, +CSF+EAR) through run_bucket_fast == the general
    engine, modulo sub-1e-7 ties of the f32-cast problem (the scans
    quantize f32 columns; x64 users route to the general float64 path)."""
    from microstructure_fingerprinting_tpu import testing as mft
    from microstructure_fingerprinting_tpu.models.fit import (
        run_bucket, run_bucket_fast)
    from microstructure_fingerprinting_tpu.ops import interp as mfi
    from microstructure_fingerprinting_tpu.utils.scheme import b_values
    import jax.numpy as jnp
    wl = mft.make_fit_workload(num_atom=48, n_vox=24, n_shells=3,
                               dirs_per_shell=12, n_b0=4)
    ms, plan = wl["msinterp"], wl["plan"]
    xs, ys_t, cnt = ms.device_tables()
    peaks1 = wl["peaks"].reshape(24, 6)[:, :3]
    csf = wl["sig_csf"]
    sch = wl["sch_mat"]
    TE, b = sch[:, 6], b_values(sch)
    Dear = np.linspace(0.8e-9, 2.6e-9, 4)
    sig_ear = (np.exp(-TE / 0.8)[:, None]
               * np.exp(-b[:, None] * Dear[None]))
    D = np.asarray(mfi.eval_rotation_batch(
        xs, ys_t, cnt, jnp.asarray(plan.gdir, xs.dtype),
        jnp.asarray(plan.shell_lo), jnp.asarray(plan.shell_hi),
        jnp.asarray(plan.wG, xs.dtype),
        jnp.asarray(peaks1.reshape(24, 1, 3), xs.dtype)))
    ids = rng.randint(0, 48, 24)
    eids = rng.randint(0, 4, 24)
    y1 = np.stack([200 * (0.5 * D[v, 0, :, ids[v]] + 0.3 * csf)
                   for v in range(24)])
    y1e = np.stack([200 * (0.45 * D[v, 0, :, ids[v]] + 0.25 * csf
                           + 0.2 * sig_ear[:, eids[v]])
                    for v in range(24)])
    plan_t = (jnp.asarray(plan.gdir, xs.dtype),
              jnp.asarray(plan.shell_lo), jnp.asarray(plan.shell_hi),
              jnp.asarray(plan.wG, xs.dtype))
    for yy, ear in ((y1, False), (y1e, True)):
        kw = dict(sig_ear=sig_ear, ear_on=True) if ear else {}
        ref = run_bucket((xs, ys_t, cnt), plan_t, peaks1, yy, csf,
                         sig_ear if ear else None, 1, True, ear, batch=8,
                         refine=True, ms_host=ms, plan_host=plan, topm=8)
        ysq = np.sum(yy.astype(np.float64) ** 2, axis=1)
        host = run_bucket_fast(ms, plan, ys_t, peaks1, yy, csf, 1, True,
                               batch=8, device_finalize=False, **kw)
        dev = run_bucket_fast(ms, plan, ys_t, peaks1, yy, csf, 1, True,
                              batch=8, device_finalize=True, **kw)
        # the two fast-path modes agree with each other on selection
        assert np.array_equal(host[1][:, 0], dev[1][:, 0])
        np.testing.assert_allclose(dev[2], host[2], atol=2e-9 * ysq.max())
        # and with the general engine up to f32-cast ties
        assert np.max(np.abs(host[2] - ref[2]) / ysq) < 1e-6
        same = np.mean(host[1][:, 0] == ref[1][:, 0])
        assert same > 0.85, "more than tie-level selection divergence"
        # planted-fascicle recovery (noiseless synthesis)
        assert np.mean(host[1][:, 0] == ids) > 0.85
