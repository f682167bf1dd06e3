"""Microstructure Fingerprinting on an accelerator (JAX / XLA).

A from-scratch JAX framework with the capabilities of
rensonnetg/microstructure_fingerprinting: estimation of white-matter
microstructure from DW-MRI by exhaustive combinatorial NNLS against a
dictionary of Monte-Carlo-simulated fingerprints.

Public surface (mirrors the reference package __init__.py:19-21):

    import microstructure_fingerprinting_tpu as mf
    model = mf.MFModel(dictionary)
    fit = model.fit(data, mask, numfasc, peaks=..., pgse_scheme=...)
    fit.write_nifti('out.nii.gz')
    mf.cleanup_2fascicles(...)
    mf.mf_utils  # flat compatibility namespace with the reference's utilities
    mf.mcf       # analytic matrix-formalism simulators
"""

import os as _os

import jax as _jax

#: the persistent compilation cache's directory when
#: JAX_COMPILATION_CACHE_DIR is not set: one fixed path inside the checkout
_CHECKOUT_CACHE = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")


def compile_cache_dir():
    """Directory of the persistent XLA compilation cache:
    JAX_COMPILATION_CACHE_DIR when it is set, else ``.jax_cache`` at the
    root of the checkout."""
    return _os.environ.get("JAX_COMPILATION_CACHE_DIR") or _CHECKOUT_CACHE


def enable_compile_cache():
    """Persistent XLA compilation cache (cold-start amortization).

    A fit compiles one set of programs per voxel configuration; caching
    the executables on disk makes every later process start warm. Called
    on each MFModel construction, for accelerator backends only (XLA:CPU
    executables are machine-feature sensitive). JAX itself reads
    JAX_COMPILATION_CACHE_DIR; a directory already configured that way,
    or by the caller, is left as it is.
    """
    if _jax.default_backend() == "cpu":
        return
    if not _jax.config.jax_compilation_cache_dir:
        _jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    # cache everything, including fast-compiling programs
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    _jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


from . import ops, utils  # noqa: F401,E402
from .models.mf import MFModel, MFModelFit, cleanup_2fascicles  # noqa: F401
from . import mf_utils  # noqa: F401
from .models import mcf  # noqa: F401
from . import parallel, viz, testing  # noqa: F401
from .tripwire import TripWire, TripWireError, is_tripwire  # noqa: F401

__version__ = "0.1.0"
