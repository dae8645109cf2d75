"""Molecular orbital evaluator (counterpart of `MolecularOrbitals` in
pyqmc_tpu/models/orbitals.py): mo = ao @ C per spin. K-point orbitals come
with the periodic slice."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops.gto import GTOSpec, eval_gto


class MolecularOrbitals:
    """Open-boundary orbitals; owns the mo_coeff parameter layout
    {"mo_coeff_alpha": (nao, norb_up), "mo_coeff_beta": (nao, norb_dn)}."""

    def __init__(self, mol, mo_coeff: Tuple[np.ndarray, np.ndarray]):
        self.spec = GTOSpec.from_molecule(mol)
        self._ca = np.asarray(mo_coeff[0])
        self._cb = np.asarray(mo_coeff[1])
        self.norb = (self._ca.shape[1], self._cb.shape[1])

    def make_params(self, device="cpu", dtype=torch.float64):
        return {
            "mo_coeff_alpha": torch.as_tensor(self._ca, dtype=dtype, device=device),
            "mo_coeff_beta": torch.as_tensor(self._cb, dtype=dtype, device=device),
        }

    def eval(self, params, X, mode: int):
        """X (..., 3) -> per-spin MOs.

        mode 0: (mo_up, mo_dn); mode 1 adds (gmo_up, gmo_dn) with a 3-axis
        before the orbital axis; mode 2 adds the laplacian MOs.
        """
        ca, cb = params["mo_coeff_alpha"], params["mo_coeff_beta"]
        if mode == 0:
            ao = eval_gto(self.spec, X, 0)
            return ao @ ca, ao @ cb
        if mode == 1:
            ao, aog = eval_gto(self.spec, X, 1)
            return ao @ ca, ao @ cb, aog @ ca, aog @ cb
        ao, aog, aol = eval_gto(self.spec, X, 2)
        return ao @ ca, ao @ cb, aog @ ca, aog @ cb, aol @ ca, aol @ cb
