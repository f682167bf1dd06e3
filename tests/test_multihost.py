"""Multi-host (multi-process) fit-step test over jax.distributed.

Two localhost processes, 2 virtual CPU devices each, form one 4-device
global 'data' mesh (the across-hosts model from SURVEY.md section 5);
the sharded fused fit step must reproduce the single-process result
exactly, and the gathered maps land on process 0 (the NIfTI-writing host).

No multi-host hardware claim is made — this validates the wiring
(parallel/mesh.init_distributed, host_local_to_global, gather_to_host)
that a multi-host GPU deployment uses unchanged.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest


_HERE = os.path.dirname(os.path.abspath(__file__))


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_fit_matches_single(tmp_path):
    out = str(tmp_path / "mh.npz")
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(_HERE, "_multihost_worker.py"),
         str(pid), "2", str(port), out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(2)]
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-process worker timed out")
        logs.append(stdout.decode(errors="replace"))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, "worker failed:\n%s" % log
    assert os.path.isfile(out), "process 0 wrote no output:\n%s" % logs[0]
    got = np.load(out)

    # single-process reference on the identical deterministic workload
    import jax
    import jax.numpy as jnp
    from microstructure_fingerprinting_tpu.models.fit import fit_step
    from microstructure_fingerprinting_tpu import testing as mft
    wl = mft.make_fit_workload(num_atom=16, n_vox=8, n_shells=3,
                               dirs_per_shell=8, n_b0=4)
    ms, plan = wl["msinterp"], wl["plan"]
    xs, ys, cnt = ms.device_tables()
    dt = xs.dtype
    ref = fit_step(xs, ys, cnt,
                   jnp.asarray(plan.gdir, dtype=dt),
                   jnp.asarray(plan.shell_lo), jnp.asarray(plan.shell_hi),
                   jnp.asarray(plan.wG, dtype=dt),
                   jnp.asarray(wl["peaks"], dtype=dt),
                   jnp.asarray(wl["y"], dtype=dt),
                   jnp.asarray(wl["sig_csf"], dtype=dt),
                   jnp.zeros((wl["y"].shape[1], 1), dtype=dt),
                   K=2, csf_on=True, ear_on=False)
    del jax
    assert np.array_equal(got["ind"], np.asarray(ref["ind"]))
    np.testing.assert_allclose(got["w"], np.asarray(ref["w"]),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got["mse"], np.asarray(ref["mse"]),
                               rtol=1e-9, atol=1e-12)
