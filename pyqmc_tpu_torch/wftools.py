"""Wavefunction factories (counterpart of pyqmc_tpu/wftools.py:17-133).

    wf, params, to_opt = generate_wf(mol, mf)   # Slater x two-body Jastrow, GPU

`to_opt` freezes the Slater part (determinant and orbital coefficients)
and the Jastrow's electron-electron cusp row, as in the JAX package: the
common workflow optimizes the Jastrow first.
"""

from __future__ import annotations

import numpy as np

from .models import func3d
from .models.jastrow import JastrowSpin
from .models.multiply import MultiplyWF
from .models.slater import Slater


def default_jastrow_basis(mol, na=4, nb=3, rcut=None):
    """(a_basis, b_basis) of the two-body Jastrow: na polypade e-ion
    functions; a cusp function and nb polypade e-e functions. rcut defaults
    to half the smallest cell height for a periodic system (so the rounding
    minimal image is exact), else 7.5 bohr."""
    if rcut is None:
        if getattr(mol, "lattice", None) is not None:
            heights = 1.0 / np.linalg.norm(np.linalg.inv(mol.lattice), axis=0)
            rcut = 0.5 * float(np.min(heights))
        else:
            rcut = 7.5
    a_basis = tuple(func3d.BasisFn("polypade", 0.2 * 3.0**k, rcut) for k in range(na))
    b_basis = (func3d.BasisFn("cutoffcusp", 24.0, rcut),) + tuple(
        func3d.BasisFn("polypade", 0.2 * 3.0**k, rcut) for k in range(nb))
    return a_basis, b_basis


def generate_slater(mol, mf, mc=None):
    """The Slater part from an SCF: the single determinant of the lowest
    orbitals, or with mc = (DeterminantExpansion, det_coeff) a
    multi-determinant expansion over the orbitals it occupies."""
    if mc is None:
        return Slater.from_mean_field(mf)
    if not (isinstance(mc, tuple) and len(mc) == 2):
        raise NotImplementedError(
            "a CI object other than an (expansion, det_coeff) pair needs interpret_ci "
            "(ROADMAP queue 1 item 8), which is not ported")
    exp, coeff = mc
    norb_up = int(exp.occ_up.max()) + 1 if exp.occ_up.size else 0
    norb_dn = int(exp.occ_dn.max()) + 1 if exp.occ_dn.size else 0
    ca = np.asarray(mf.mo_coeff[0])[:, :norb_up]
    cb = np.asarray(mf.mo_coeff[1])[:, :norb_dn]
    return Slater(mol, None, exp, (ca, cb), det_coeff=np.asarray(coeff))


def generate_jastrow(mol, na=4, nb=3, rcut=None):
    """Two-body Jastrow of default_jastrow_basis; returns (jastrow, to_opt)
    with the cusp row of bcoeff frozen."""
    a_basis, b_basis = default_jastrow_basis(mol, na, nb, rcut)
    jas = JastrowSpin(mol, a_basis=a_basis, b_basis=b_basis)
    bmask = np.ones((len(b_basis), 3), dtype=bool)
    bmask[0] = False
    return jas, {"acoeff": True, "bcoeff": bmask}


def generate_wf(mol, mf, jastrow=True, jastrow3=False, jastrow_kws=None, mc=None, device=None,
                dtype=None):
    """Slater x two-body Jastrow; returns (wf, params, to_opt), params on
    the GPU unless `device` says otherwise (as make_params). jastrow=False
    gives the Slater alone."""
    if callable(jastrow) or isinstance(jastrow, (list, tuple)) or jastrow3:
        raise NotImplementedError(
            "Jastrow factories and the three-body Jastrow (ROADMAP queue 1 item 5) are not "
            "ported")
    slater = generate_slater(mol, mf, mc=mc)
    sl_opt = {"det_coeff": False, "mo_coeff_alpha": False, "mo_coeff_beta": False}
    if not jastrow:
        return slater, slater.make_params(device, dtype), sl_opt
    jas, j_opt = generate_jastrow(mol, **(jastrow_kws or {}))
    wf = MultiplyWF(slater, jas)
    return wf, wf.make_params(device, dtype), {"wf0": sl_opt, "wf1": j_opt}
