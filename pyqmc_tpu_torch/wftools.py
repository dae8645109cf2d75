"""Wavefunction factory helpers (counterpart of the default Jastrow basis of
pyqmc_tpu/wftools.py:41-55)."""

from __future__ import annotations

import numpy as np

from .models import func3d


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
