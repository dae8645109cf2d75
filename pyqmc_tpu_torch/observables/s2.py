"""<S^2> (counterpart of pyqmc_tpu/observables/s2.py):

  <S^2> = Sz (Sz + 1) + Ndn - sum_{i up, j down} <P_ij>,

P_ij the spatial exchange ratio Psi(..., r_i <-> r_j, ...) / Psi, taken as
two single-electron replacements on a scratch state (testvalue, a forced
updateinternals, testvalue); the real part of their product, as in the
JAX package. On the GPU each testvalue's float32 orbitals run on K3.
"""

import torch


class S2Accumulator:
    def __init__(self, mol):
        self.nup, self.ndn = mol.nelec

    def __call__(self, wf, params, state, positions, rot=None, u_sel=None):
        nconf = positions.shape[0]
        nup, ndn = self.nup, self.ndn
        sz = 0.5 * (nup - ndn)
        base = sz * (sz + 1.0) + ndn
        if ndn == 0 or nup == 0:
            return {"S2": torch.full((nconf,), base, dtype=positions.dtype,
                                     device=positions.device)}
        ones = torch.ones(nconf, dtype=torch.bool, device=positions.device)
        swap = torch.zeros(nconf, dtype=positions.dtype, device=positions.device)
        for i in range(nup):
            for j in range(nup, nup + ndn):
                ri, rj = positions[:, i, :], positions[:, j, :]
                r1, saved1 = wf.testvalue(params, state, i, rj)
                st1 = wf.updateinternals(params, state, i, rj, ones, saved1)
                r2, _ = wf.testvalue(params, st1, j, ri)
                swap = swap + (r1 * r2).real
        return {"S2": base - swap}

    def avg(self, wf, params, state, positions, rot=None, u_sel=None):
        return {k: torch.mean(v, dim=0)
                for k, v in self(wf, params, state, positions, rot, u_sel).items()}

    def keys(self):
        return {"S2"}

    def shapes(self):
        return {"S2": ()}
