"""The GPU fit path, checked on the CPU: bucket routing, matmul precision
of the lowered programs, the column gather, the compile-cache directory,
and chip_smoke.py's refusal to run without a GPU."""

import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from microstructure_fingerprinting_tpu import backend
from microstructure_fingerprinting_tpu.models import fit as fit_mod
from microstructure_fingerprinting_tpu.ops import dfscan, f32scan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("cfg,n_atom,num_ear,engine,gpu,route", [
    ((2, True, False), 782, 10, "auto", True, "twopass3"),
    ((2, True, True), 782, 10, "auto", True, "df4"),
    ((1, True, False), 782, 10, "auto", True, "df2"),
    ((1, True, True), 782, 10, "auto", True, "df3"),
    ((2, False, False), 782, 10, "auto", True, "df2"),
    ((0, True, False), 782, 10, "auto", True, "host"),
    ((0, True, True), 782, 10, "auto", True, "host"),
    ((1, False, False), 782, 10, "auto", True, "general"),
    ((2, False, True), 782, 10, "auto", True, "general"),
    ((2, True, True), 782, 20, "auto", True, "general"),
    ((2, True, False), 200, 10, "auto", True, "df3"),
    ((2, True, True), 200, 10, "fast", False, "df4"),
    ((2, True, False), 782, 10, "xla", True, "general"),
    ((2, True, False), 782, 10, "auto", False, "general"),
    ((2, True, False), 782, 10, "fast", False, "df3"),
])
def test_bucket_route(monkeypatch, cfg, n_atom, num_ear, engine, gpu, route):
    """The route MFModel.fit takes per (K, csf, ear) bucket: on the GPU
    the fast path with the two-pass scans for large dictionaries; off
    the GPU the general scan unless engine='fast' asks for the fast path
    (then with float64 host re-scoring, so without the two-pass)."""
    monkeypatch.setattr(backend, "on_gpu", lambda: gpu)
    assert fit_mod.bucket_route(cfg, n_atom, num_ear, engine) == route


def _lowered_for_gpu(name):
    """StableHLO text of one fit-path program as lowered for the GPU
    (jax.export for the 'cuda' platform; no card needed), with float32
    inputs at a small width."""
    from jax import export
    B, S, N, E = 4, 24, 40, 3
    f = jax.ShapeDtypeStruct
    f32 = jnp.float32
    fn, args, kw = {
        "_twopass_step3": (fit_mod._twopass_step3, (
            f((B, 2, S, N), f32), f((S,), f32), f((B, S), f32)),
            dict(R=8)),
        "df4_candidates": (dfscan.df4_candidates, (
            f((B, S, N), f32), f((B, S, N), f32), f((B, S, 1), f32),
            f((B, S, E), f32), f((B, S), f32)), dict(M=1)),
        "_finalize_top1": (fit_mod._finalize_top1, (
            f((B, 2, S, N), f32), f((S,), f32), f((S, E), f32),
            f((B, S), f32), f((B, 4), jnp.int32)),
            dict(csf_on=True, ear_on=True, K=2)),
        "df3_candidates": (dfscan.df3_candidates, (
            f((B, S, N), f32), f((B, S, N), f32), f((B, S, 1), f32),
            f((B, S), f32)), dict(M=1)),
    }[name]
    return export.export(fn, platforms=["cuda"])(*args, **kw).mlir_module()


@pytest.mark.parametrize("name", ["_twopass_step3", "_finalize_top1",
                                  "df3_candidates", "df4_candidates"])
def test_f32_matmuls_at_highest(name):
    """Every float32 dot_general of the fit path runs at HIGHEST: on the
    GPU a lower precision means TF32, ~11 bits. Integer and bf16 products
    are exact by construction and may run at any precision."""
    text = _lowered_for_gpu(name)
    dots = [ln for ln in text.splitlines() if "stablehlo.dot_general" in ln]
    assert dots, "no dot_general lowered"
    f32_dots = [ln for ln in dots
                if re.search(r": \(tensor<[0-9x]*xf32>", ln)]
    assert f32_dots, "no float32 dot_general lowered"
    low = [ln.strip() for ln in f32_dots
           if "precision = [HIGHEST, HIGHEST]" not in ln]
    assert not low, "float32 dot_general below HIGHEST:\n" + "\n".join(low)


@pytest.mark.parametrize("B,S,N,R", [(3, 7, 50, 16), (2, 33, 9, 9)])
def test_gather_cols_is_an_exact_copy(rng, B, S, N, R):
    A = rng.randn(B, S, N).astype(np.float32)
    idx = rng.randint(0, N, (B, R)).astype(np.int32)
    got = np.asarray(jax.jit(f32scan._gather_cols)(jnp.asarray(A),
                                                   jnp.asarray(idx)))
    want = np.stack([A[b][:, idx[b]] for b in range(B)])
    assert got.dtype == np.float32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("env", [None, "custom"])
def test_compile_cache_dir(monkeypatch, tmp_path, env):
    """JAX_COMPILATION_CACHE_DIR when set, else one fixed directory at
    the root of the checkout."""
    import microstructure_fingerprinting_tpu as mf
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert mf.compile_cache_dir() == os.path.join(REPO, ".jax_cache")
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert mf.compile_cache_dir() == str(tmp_path)


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_without_gpu(tmp_path, where):
    """chip_smoke.py exits non-zero and prints no result line on the CPU,
    from the checkout and as a lone copy of the script."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        shutil.copy(script, tmp_path)
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_device_op_times_without_gpu(tmp_path):
    """A trace with no GPU plane reduces to no ops and no busy time."""
    from microstructure_fingerprinting_tpu.utils import profiling
    with profiling.device_trace(str(tmp_path)):
        jax.block_until_ready(jnp.ones(8) * 2)
    assert profiling.device_op_times(str(tmp_path)) == ({}, 0, 0)
