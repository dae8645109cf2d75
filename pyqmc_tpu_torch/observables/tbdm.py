"""Two-body density matrix (counterpart of pyqmc_tpu/observables/tbdm.py,
the estimator of DOI:10.1063/1.4793531 Eq. 10):

  rho2_ijkl^{s1 s2} = < sum_{e1 in s1, e2 in s2, e1 != e2}
        phi_i*(r1') phi_j*(r2') phi_k(r_e1) phi_l(r_e2)
        Psi(e1 -> r1', e2 -> r2') / Psi / (q(r1') q(r2')) >

Two auxiliary points per walker from the mixture of observables/obdm.py.
The two-electron ratio factorizes into electron e1's ratio at r1' and,
on a scratch state where e1 has moved there (a forced updateinternals),
every electron's ratio at r2'. The e1 loop is a Python loop; each e1's
term is contracted as the JAX package's pair route does it
(tbdm.py:169-198): P_cik = conj(phi1)_i phi(r_e1)_k and
Q_cjl = sum_e2 w_e2 conj(phi2)_j phi(r_e2)_l, and the sum over e1 of their
outer products is one batched product over the walkers, so no (nconf, ne,
n, n, n, n) intermediate is ever made.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.constants import index_tensor
from .obdm import (GaussianMixture, OrbitalSet, PeriodicGaussianMixture, _Aux, _like,
                   slater_params, spin_slice)


def _pair_terms(wf, params, state, positions, r1, r2, s1, s2, phi1, phi2, phie1, phie2):
    """(P, Q): P (ne1, nconf, n1, n1) and Q (ne1, nconf, n2, n2), one row per
    electron e1 of spin s1, so that rho2[c, i, j, k, l] = sum_e1
    P[e1, c, i, k] Q[e1, c, j, l]. phie1 (nconf, ne1, n1) and phie2 (nconf,
    ne2, n2) are the orbitals at the electrons of spins s1 and s2."""
    (lo1, hi1), (lo2, hi2) = s1, s2
    nconf = positions.shape[0]
    ones = torch.ones(nconf, dtype=torch.bool, device=positions.device)
    P, Q = [], []
    for i, e1 in enumerate(range(lo1, hi1)):
        ratio1, saved1 = wf.testvalue(params, state, e1, r1)
        st1 = wf.updateinternals(params, state, e1, r1, ones, saved1)
        ratios2 = wf.testvalue_many(params, st1, r2)[:, lo2:hi2]
        notself = torch.ones(hi2 - lo2, dtype=ratios2.real.dtype, device=positions.device)
        if lo2 <= e1 < hi2:
            notself[e1 - lo2] = 0.0
        w = ratio1[:, None] * ratios2 * notself
        P.append(_like(phi1, w).conj()[:, :, None] * _like(phie1[:, i], w)[:, None, :])
        f = torch.einsum("ce,cel->cl", w, _like(phie2, w))
        Q.append(_like(phi2, w).conj()[:, :, None] * f[:, None, :])
    return torch.stack(P), torch.stack(Q)


def _contract(P, Q, ijkl):
    """sum_e1 P[e1, c, i, k] Q[e1, c, j, l] -> (nconf, n1, n2, n1, n2), or
    (nconf, nsel) at the selected ijkl rows."""
    ne, nconf, n1, _ = P.shape
    n2 = Q.shape[2]
    if ijkl is not None:
        ii, jj, kk, ll = (ijkl[:, c] for c in range(4))
        return torch.sum(P[:, :, ii, kk] * Q[:, :, jj, ll], dim=0)
    A = P.permute(1, 2, 3, 0).reshape(nconf, n1 * n1, ne)
    B = Q.permute(1, 0, 2, 3).reshape(nconf, ne, n2 * n2)
    return (A @ B).reshape(nconf, n1, n1, n2, n2).permute(0, 1, 3, 2, 4)


class TBDMAccumulator(_Aux):
    """rho2 in the basis of `orb_coeff` columns for spins (s1, s2):
    {"value": (nconf, n, n, n, n)}, or (nconf, nsel) at the rows of `ijkl`
    (nsel, 4) only (the JAX package's bound on the n^4 output)."""

    naux = 2

    def __init__(self, mol, orb_coeff, spin=(0, 1), aux_sigma=1.5, ijkl=None):
        self.orbitals = OrbitalSet(mol, orb_coeff)
        self.nup, self.ndn = mol.nelec
        self.spin = spin
        self.mixture = GaussianMixture(mol.atom_coords, aux_sigma)
        self.ijkl = None if ijkl is None else np.asarray(ijkl, dtype=np.int64)

    def __call__(self, wf, params, state, positions, rot=None, u_sel=None, draws=None):
        d = self._draws(draws)
        r1, r2 = d["r1"], d["r2"]
        q = self.mixture.density(r1) * self.mixture.density(r2)
        s1 = spin_slice(self.nup, self.ndn, self.spin[0])
        s2 = spin_slice(self.nup, self.ndn, self.spin[1])
        phi1, phi2 = self.orbitals(r1), self.orbitals(r2)
        phie = self.orbitals(positions)
        P, Q = _pair_terms(wf, params, state, positions, r1, r2, s1, s2, phi1, phi2,
                           phie[:, s1[0]:s1[1]], phie[:, s2[0]:s2[1]])
        ijkl = None if self.ijkl is None else index_tensor(self.ijkl.ravel(), positions.device
                                                           ).reshape(-1, 4)
        out = _contract(P, Q, ijkl)
        return {"value": out / q.reshape((-1,) + (1,) * (out.ndim - 1))}

    def keys(self):
        return {"value"}

    def shapes(self):
        if self.ijkl is not None:
            return {"value": (len(self.ijkl),)}
        n = self.orbitals.norb
        return {"value": (n, n, n, n)}


class KTBDMAccumulator(_Aux):
    """Two-body density matrix of a periodic cell in the k-point orbitals,
    spins (s1, s2), the complex route of the JAX package's
    KTBDMAccumulator: {"value_re", "value_im": (nconf, n1, n2, n1, n2)}.
    `orbitals` is the wavefunction's KPointOrbitals, read with the
    wavefunction's parameters (slater_params)."""

    naux = 2

    def __init__(self, cell, orbitals, spin=(0, 1), aux_sigma=1.5):
        self.orbitals = orbitals
        self.nup, self.ndn = cell.nelec
        self.spin = spin
        self.mixture = PeriodicGaussianMixture(cell, aux_sigma)
        self.norb = (orbitals.norb[spin[0]], orbitals.norb[spin[1]])

    def __call__(self, wf, params, state, positions, rot=None, u_sel=None, draws=None):
        d = self._draws(draws)
        r1, r2 = d["r1"], d["r2"]
        qinv = 1.0 / (self.mixture.density(r1) * self.mixture.density(r2))
        s1 = spin_slice(self.nup, self.ndn, self.spin[0])
        s2 = spin_slice(self.nup, self.ndn, self.spin[1])
        oparams = slater_params(params)
        phi1 = self.orbitals.eval(oparams, r1, 0)[self.spin[0]]
        phi2 = self.orbitals.eval(oparams, r2, 0)[self.spin[1]]
        phie1 = self.orbitals.eval(oparams, positions[:, s1[0]:s1[1]], 0)[self.spin[0]]
        phie2 = self.orbitals.eval(oparams, positions[:, s2[0]:s2[1]], 0)[self.spin[1]]
        P, Q = _pair_terms(wf, params, state, positions, r1, r2, s1, s2, phi1, phi2, phie1,
                           phie2)
        out = _contract(P, Q, None) * qinv[:, None, None, None, None]
        im = out.imag if out.is_complex() else torch.zeros_like(out)
        return {"value_re": out.real, "value_im": im}

    def keys(self):
        return {"value_re", "value_im"}

    def shapes(self):
        n1, n2 = self.norb
        return {"value_re": (n1, n2, n1, n2), "value_im": (n1, n2, n1, n2)}
