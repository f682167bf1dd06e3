"""DW-MRI synthesis from stored Monte-Carlo spin phases.

Parity targets:
  - ``monte_carlo_average``  reference mf_utils.py:2758-2810 (Numba kernel)
  - ``get_PGSE_from_phases`` reference mf_utils.py:2813-3015

The reference's scalar (seq, spin, dim) Numba triple loop becomes one fused
device expression: per sequence, gather the mapped reference phase block,
contract the gradient-scaling over dims, and reduce cos() over spins —
S_i = mean_l cos(Dscaling * sum_n gscaling[i,n] * phi[l, map(i), n]).
On the device this is a (n_seq x n_spin) elementwise cos + row reduction fed by one
gather; spins stream through in chunks so arbitrarily large simulations fit
in memory.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp

from ..utils.scheme import import_PGSE_scheme

_PHASE_NAMES = ["x", "y", "z"]
_MAXDIM = 3


@jax.jit
def _mc_average_kernel(phases, delta_mapping, gscaling, Dscaling):
    """phases (n_ref, n_spin_chunk, dim), delta_mapping (n_seq,),
    gscaling (n_seq, dim) -> partial sums (n_seq,)."""
    ph = phases[delta_mapping]                      # (n_seq, chunk, dim)
    acc = jnp.einsum("scd,sd->sc", ph, gscaling)    # (n_seq, chunk)
    return jnp.sum(jnp.cos(Dscaling * acc), axis=1)


def monte_carlo_average(sim_phases, delta_mapping, gscaling, Dscaling,
                        num_spins, chunk=16384):
    """Monte-Carlo signal as the average of the spins' dephasing cosines.

    Args match the reference kernel: ``sim_phases`` (n_ref*num_spins, dim)
    stacked per reference sequence, ``delta_mapping`` (n_seq,) reference row
    per new sequence, ``gscaling`` (n_seq, dim) gradient ratios, ``Dscaling``
    = sqrt(D/D_ref). Returns (n_seq,).
    """
    sim_phases = np.asarray(sim_phases)
    n_entries, dim = sim_phases.shape
    n_ref = n_entries // num_spins
    phases = sim_phases.reshape(n_ref, num_spins, dim)
    delta_mapping = jnp.asarray(delta_mapping, dtype=jnp.int32)
    gscaling_d = jnp.asarray(gscaling)
    total = np.zeros(delta_mapping.shape[0])
    for st in range(0, num_spins, chunk):
        en = min(st + chunk, num_spins)
        part = _mc_average_kernel(jnp.asarray(phases[:, st:en, :]),
                                  delta_mapping, gscaling_d,
                                  float(Dscaling))
        total += np.asarray(part, dtype=np.float64)
    return total / num_spins


def get_PGSE_from_phases(phasefile, sch_mat_sim, sch_mat, dim=None,
                         D_sim=None, D=None):
    """Compute a PGSE signal for a new protocol from stored spin phases.

    ``phasefile`` points at one of the sibling ``*_phase_{x,y,z}.<ext>``
    binary files; the extension encodes endianness ('b'/'l' prefix) and
    precision ('single'/'float'/'double'). Each new sequence is mapped to the
    reference (Delta, delta) row it was simulated with; gradients are scaled
    by the intensity ratio and diffusivity rescaling enters as
    sqrt(D/D_sim) (phase ~ displacement ~ sqrt(D)).
    """
    D_ratio_sqrt = 1.0
    if D is not None:
        if D_sim is None:
            raise NameError("Simulation diffusivity should be specified if"
                            " new signal diffusivity is set.")
        D_ratio_sqrt = float(np.sqrt(D / D_sim))
    if dim is None:
        dim = _MAXDIM
    elif dim > _MAXDIM:
        raise ValueError("dim should be less than or equal to %d." % _MAXDIM)

    sch_mat_sim = import_PGSE_scheme(sch_mat_sim)
    sch_mat = import_PGSE_scheme(sch_mat)

    if np.any(sch_mat[:, dim:_MAXDIM] != 0):
        print("WARNING get_PGSE_from_phases: detected non-zero entries in"
              " gradient components after dimension %d.\nThose components"
              " will be ignored but make sure the right acquisition protocol"
              " was provided.\n" % dim)
    num_seq = sch_mat.shape[0]
    num_ref = sch_mat_sim.shape[0]

    sim_g = sch_mat_sim[:, :3] * sch_mat_sim[:, 3][:, np.newaxis]
    new_g = sch_mat[:, :3] * sch_mat[:, 3][:, np.newaxis]

    # (Delta, delta) row mapping new -> simulated
    delta_mapping = np.zeros(num_seq, dtype=np.int64) - 1
    for i in range(num_ref):
        match = np.all(sch_mat[:, 4:6] == sch_mat_sim[i, 4:6], axis=1)
        delta_mapping[match] = i
    num_unidentified = int(np.sum(delta_mapping < 0))
    if num_unidentified > 0:
        bad_seq = np.where(delta_mapping < 0)[0]
        seq_list = '\n'.join('\t%4d -- %5g -- %5g' %
                             (bad_seq[i],
                              sch_mat[bad_seq[i], 4] * 1e3,
                              sch_mat[bad_seq[i], 5] * 1e3)
                             for i in range(bad_seq.shape[0]))
        raise ValueError('Acquisition protocol contains %d (Delta,delta)'
                         ' pair(s) (out of %d) not used to simulate the'
                         ' directional phases in the Monte Carlo '
                         'simulation. List of unmatched sequences:\nSequ.'
                         ' no. -- Delta [ms] -- delta [ms]\n%s'
                         % (num_unidentified, num_seq, seq_list))

    gscaling = new_g[:, :dim] / sim_g[delta_mapping, :dim]

    if not os.path.isfile(phasefile):
        raise RuntimeError("File %s does not exist." % phasefile)
    phasesize = os.path.getsize(phasefile)

    (path, tail) = os.path.split(phasefile)
    (basename, ext) = os.path.splitext(tail)
    if not ext:
        raise ValueError("Phase file extension not found.\nAborting as"
                         " there is no way to tell which level of precision"
                         " was used to store the phase values (e.g., float,"
                         " double, ...).")
    if ext[1].lower() == 'b':
        endian = '>'
    elif ext[1].lower() == 'l':
        endian = '<'
    else:
        raise ValueError("Phase file extension (after the dot) should "
                         "start with a b for big endian or with a l for "
                         "little endian. Detected: \"%s\"." % ext[1])
    if ext[2:] in ('single', 'float'):
        dtype, prec = 'f4', 4
    elif ext[2:] == 'double':
        dtype, prec = 'f8', 8
    else:
        raise ValueError("Data type of phase file specified in file"
                         " extension (\"%s\") not supported." % ext[2:])

    if phasesize % (num_ref * prec) != 0:
        raise RuntimeError("Phase file %s is either corrupted or "
                           "inconsistently named. Storage precision of items"
                           " (%d bytes) times number of reference simulation"
                           " sequences (%d) does not divide total size "
                           "(%d bytes)." %
                           (phasefile, prec, num_ref, phasesize))
    num_entries = phasesize // prec
    num_spins = num_entries // num_ref

    sim_phases = np.zeros((num_entries, dim))
    for i in range(dim):
        ph_name = _PHASE_NAMES[i]
        basename_i = basename[:-len(ph_name)] + ph_name
        ph_file_i = os.path.join(path, basename_i + ext)
        if not os.path.isfile(ph_file_i):
            raise RuntimeError("Phase file %s not found." % ph_file_i)
        sim_phases[:, i] = np.fromfile(ph_file_i, dtype=endian + dtype,
                                       count=num_entries, sep="")

    return monte_carlo_average(sim_phases, delta_mapping, gscaling,
                               D_ratio_sqrt, num_spins)
