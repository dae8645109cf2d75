"""Symmetry-operator expectation < Psi(O R) / Psi(R) > (counterpart of
pyqmc_tpu/observables/symmetry.py): per walker, the wavefunction recomputed
at the walker transformed by each point-group operation O (a 3 x 3
orthogonal matrix about `origin`), folded back into the cell where there
is a lattice; the real part of the ratio.
"""

import numpy as np
import torch

from ..ops.pbc import enforce_pbc
from ..utils.constants import DeviceConstants


class SymmetryAccumulator:
    def __init__(self, mol, operations, origin=None, names=None):
        """operations: (3, 3) matrices acting about `origin` (default the
        coordinate origin); names: their output keys (default op0, op1, ...)."""
        self.ops = [np.asarray(o, dtype=np.float64) for o in operations]
        self.origin = np.zeros(3) if origin is None else np.asarray(origin, dtype=np.float64)
        self.names = list(names) if names else [f"op{i}" for i in range(len(self.ops))]
        lattice = getattr(mol, "lattice", None)
        self.lattice = None if lattice is None else np.asarray(lattice, dtype=np.float64)
        consts = {"origin": self.origin, "ops_t": np.stack([o.T for o in self.ops])}
        if self.lattice is not None:
            consts.update(lat=self.lattice, lat_inv=np.linalg.inv(self.lattice))
        self._const = DeviceConstants(**consts)

    def __call__(self, wf, params, state, positions, rot=None, u_sel=None):
        c = self._const.get(positions.device, positions.dtype)
        ph0, la0 = wf.value(params, state)
        out = {}
        for i, name in enumerate(self.names):
            newpos = (positions - c["origin"]) @ c["ops_t"][i] + c["origin"]
            if self.lattice is not None:
                newpos = enforce_pbc(c["lat"], c["lat_inv"], newpos)[0]
            ph, la = wf.value(params, wf.recompute(params, newpos))
            out[name] = ((ph / ph0) * torch.exp(la - la0)).real
        return out

    def avg(self, wf, params, state, positions, rot=None, u_sel=None):
        return {k: torch.mean(v, dim=0)
                for k, v in self(wf, params, state, positions, rot, u_sel).items()}

    def keys(self):
        return set(self.names)

    def shapes(self):
        return {n: () for n in self.names}
