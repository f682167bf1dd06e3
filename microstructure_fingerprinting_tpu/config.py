"""Framework configuration (frozen dataclasses).

The reference has no config system — every knob is a hard-coded constant
(MAX_FASC=2 mf.py:467; cleanup thresholds mf.py:89-94; solver tolerances
mf_utils.py:480-482; Gtol=1e-3 mf.py:837; M<=60 mcf.py:326). Those defaults
are preserved here verbatim, collected into immutable dataclasses so
deployments can override them explicitly instead of monkey-patching.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class CleanupConfig:
    """Spurious-peak cleanup thresholds (reference mf.py:89-94)."""
    ratio: float = 2.5       # big/small fraction ratio that discards small
    w_keep: float = 0.20     # relative weight that always survives
    w_small: float = 0.075   # absolute weight below which a peak is dropped
    ang_min_deg: float = 15  # merge angle


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Exhaustive-NNLS solver knobs."""
    tol3_eps_mult: float = 100     # Cramer sign tolerance (mf_utils:480-482)
    tile_n1: int = 128             # candidate-grid tile (atoms)
    refine_noise: float = 4e-6     # f32 scan normalized-residual resolution
    topm: int = 16                 # refinement candidate budget
    rescore_pool: int = 128        # pool size for direct-residual re-ranking
    direct_noise: float = 4e-9     # direct-residual normalized resolution
    # two-pass scan row budget (ops/f32scan): the f32 interval row pass
    # bounds hold the winner's row inside the top-R in-band rows; R covers
    # the measured band tails (exact-Gram radii) with <1% overflow for the
    # 2-fascicle+CSF grid
    twopass_rows: int = 128

@dataclasses.dataclass(frozen=True)
class FitConfig:
    """MFModel.fit defaults (reference mf.py:467-469, 837)."""
    max_fasc: int = 2              # max fascicles per voxel
    max_prog_lines: int = 100      # progress-print budget
    dft_disp_itvl: int = 5         # default progress interval
    gtol: float = 1e-3             # bval->G snapping tolerance [T/m]
    batch: int = 128               # voxel batch per compiled step


@dataclasses.dataclass(frozen=True)
class MCFConfig:
    """Matrix-formalism simulator knobs (reference mcf.py:326)."""
    max_modes: int = 60            # Laplace eigenbasis truncation


DEFAULTS = {
    "cleanup": CleanupConfig(),
    "solver": SolverConfig(),
    "fit": FitConfig(),
    "mcf": MCFConfig(),
}
