"""End-to-end demo on synthetic data (runs on CPU or GPU, no fixtures).

Builds a dense multi-shell protocol and a smooth fingerprint dictionary,
synthesizes a small noisy volume of 2-fascicle + CSF voxels, fits it with
MFModel, and reports recovery quality.

    python examples/demo_synthetic.py
"""

import os
import sys

import numpy as np

# allow running from a source checkout without installation
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import microstructure_fingerprinting_tpu as mf  # noqa: E402
from microstructure_fingerprinting_tpu import testing as mft
from microstructure_fingerprinting_tpu.ops.noise import gen_SoS_MRI
from microstructure_fingerprinting_tpu.utils.scheme import b_values


def main():
    rng = np.random.RandomState(0)

    # 1) protocol + dictionary (in practice: loadmat('your_dictionary.mat'))
    sch = mft.make_dense_scheme(n_shells=4, dirs_per_shell=32, n_b0=8)
    sig, d_par, d_perp = mft.make_dictionary(sch, num_atom=128)
    dic = {
        "dictionary": sig, "sch_mat": sch,
        "orientation": np.array([0.0, 0.0, 1.0]),
        "num_atom": 128, "num_ear": 0,
        "fasc_propnames": ["d_par", "d_perp"],
        "d_par": d_par, "d_perp": d_perp,
        "T2_csf": 2.0, "DIFF_csf": 3.0e-9,
        "T2_ear": 2.0, "DIFF_ear": np.array([1.0e-9]),
    }

    # 2) synthetic ground-truth volume (4 x 4 x 2, 2 fascicles + CSF)
    shape = (4, 4, 2)
    n = int(np.prod(shape))
    model = mf.MFModel(dic)
    ms = model.ms_interpolator
    from microstructure_fingerprinting_tpu.ops.interp import (
        interp_PGSE_from_multishell)
    TE = sch[:, 6]
    b = b_values(sch)
    sig_csf = np.exp(-TE / dic["T2_csf"]) * np.exp(-b * dic["DIFF_csf"])
    data = np.zeros(shape + (sch.shape[0],))
    peaks = np.zeros(shape + (6,))
    gt_ids = np.zeros((n, 2), int)
    for v in range(n):
        ijk = np.unravel_index(v, shape)
        d1, d2 = rng.randn(3), rng.randn(3)
        d1 /= np.linalg.norm(d1)
        d2 /= np.linalg.norm(d2)
        peaks[ijk][:3], peaks[ijk][3:] = d1, d2
        a1, a2 = rng.randint(128, size=2)
        gt_ids[v] = a1, a2
        D1 = interp_PGSE_from_multishell(sch, d1, msinterp=ms)
        D2 = interp_PGSE_from_multishell(sch, d2, msinterp=ms)
        clean = 300 * (0.4 * D1[:, a1] + 0.35 * D2[:, a2] + 0.25 * sig_csf)
        data[ijk] = gen_SoS_MRI(clean, sigma_g=1.0, N=1)  # Rician noise

    # 3) fit
    fit = model.fit(data, np.ones(shape), 2, peaks=peaks, pgse_scheme=sch,
                    csf_mask=1, verbose=1)

    # 4) report
    dpar_err = []
    for v in range(n):
        ijk = np.unravel_index(v, shape)
        dpar_err.append(abs(fit.d_par_f0[ijk] - dic["d_par"][gt_ids[v, 0]]))
    print("median |d_par_f0 error|: %.3g m^2/s" % np.median(dpar_err))
    print("median R^2: %.5f" % np.median(fit.R2[np.ones(shape) > 0]))
    print("parameter maps:", ", ".join(fit.param_names))
    out = fit.write_nifti("demo_out/mf.nii.gz", affine=np.eye(4))
    print("wrote %d NIfTI maps under demo_out/" % len(out))


if __name__ == "__main__":
    main()
