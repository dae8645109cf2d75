"""Energy accumulator (counterpart of `EnergyAccumulator` in
pyqmc_tpu/observables/accumulators.py): open-boundary Coulomb, or Ewald
sums for a periodic cell.

Protocol: acc(wf, params, state, positions, rot, u_sel=None) -> dict of
per-walker tensors; acc.avg(...) -> dict of walker means (0-d tensors,
still on the device). `rot` (nelec, nconf, 3, 3) are the step's ECP
quadrature rotations and `u_sel` (nelec, nconf) its downselection uniforms
(used where the ECP evaluates a subset of its quadrature points).
"""

import torch

from .ecp import ECPAccumulator
from .energy import OpenCoulomb, kinetic_energy
from .ewald import Ewald


class EnergyAccumulator:
    """{ke, ee, ei, ii, ecp, grad2, total} local-energy accumulator."""

    def __init__(self, mol, ecp_acc=None):
        """ecp_acc: an ECPAccumulator, None to build one when mol carries an
        ECP, or False to leave the ECP term out."""
        self.mol = mol
        self.periodic = getattr(mol, "lattice", None) is not None
        self.coulomb = Ewald(mol) if self.periodic else OpenCoulomb(mol)
        if ecp_acc is None and mol.ecp:
            ecp_acc = ECPAccumulator(mol)
        self.ecp_acc = ecp_acc or None

    def __call__(self, wf, params, state, positions, rot=None, u_sel=None):
        ke, grad2 = kinetic_energy(wf, params, state, positions)
        ee, ei, ii = self.coulomb.energy(positions)
        out = {"ke": ke, "ee": ee, "ei": ei, "ii": ii, "grad2": grad2}
        if self.ecp_acc is not None:
            if rot is None:
                raise ValueError("the ECP energy needs the step's quadrature rotations")
            out["ecp"] = self.ecp_acc(wf, params, state, positions, rot, u_sel)
        else:
            out["ecp"] = torch.zeros_like(ke)
        out["total"] = ke + ee + ei + ii + out["ecp"]
        return out

    def avg(self, wf, params, state, positions, rot=None, u_sel=None):
        return {k: torch.mean(v, dim=0)
                for k, v in self(wf, params, state, positions, rot, u_sel).items()}
