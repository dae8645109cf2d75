"""Static structure factor and spin structure factor (counterpart of
pyqmc_tpu/observables/sq.py):

  S(q)      = < |sum_j e^{i q.r_j}|^2 > / N
  S_spin(q) = < |sum_j s_j e^{i q.r_j}|^2 > / N,  s_j = +1 up, -1 down.
"""

import numpy as np
import torch

from ..utils.constants import DeviceConstants


class SqAccumulator:
    def __init__(self, cell=None, qlist=None, nq=4):
        """qlist (nq, 3) cartesian, or None for every reciprocal vector
        n1 b1 + n2 b2 + n3 b3 of the cell with |n_i| <= nq but the origin."""
        if qlist is None:
            recip = 2.0 * np.pi * np.linalg.inv(np.asarray(cell.lattice, dtype=np.float64)).T
            rng = np.arange(-nq, nq + 1)
            pts = np.array(np.meshgrid(rng, rng, rng, indexing="ij")).reshape(3, -1).T
            pts = pts[np.any(pts != 0, axis=1)]
            qlist = pts @ recip
        self.qlist = np.asarray(qlist, dtype=np.float64)
        self.nup = None if cell is None else cell.nelec[0]
        self._const = DeviceConstants(qt=self.qlist.T)

    def __call__(self, wf, params, state, positions, rot=None, u_sel=None):
        nelec = positions.shape[1]
        phase = positions @ self._const.get(positions.device, positions.dtype)["qt"]  # (c, e, q)
        cos, sin = torch.cos(phase), torch.sin(phase)
        re, im = torch.sum(cos, dim=1), torch.sum(sin, dim=1)
        nup = nelec if self.nup is None else self.nup
        s = torch.where(torch.arange(nelec, device=positions.device) < nup, 1.0, -1.0).to(
            positions.dtype)[None, :, None]
        re_s, im_s = torch.sum(s * cos, dim=1), torch.sum(s * sin, dim=1)
        return {"Sq": (re * re + im * im) / nelec, "spinSq": (re_s * re_s + im_s * im_s) / nelec}

    def avg(self, wf, params, state, positions, rot=None, u_sel=None):
        return {k: torch.mean(v, dim=0)
                for k, v in self(wf, params, state, positions, rot, u_sel).items()}

    def keys(self):
        return {"Sq", "spinSq"}

    def shapes(self):
        return {"Sq": (len(self.qlist),), "spinSq": (len(self.qlist),)}
