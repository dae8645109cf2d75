"""Two-body spin-dependent Jastrow (counterpart of `JastrowSpin` in
pyqmc_tpu/models/jastrow.py), open or periodic.

    U = sum_{i,I,k} acoeff[I,k,s_i] a_k(r_iI)
      + sum_{i<j,k} bcoeff[k, ch(i,j)] b_k(r_ij)

channels ch: 0 = up-up, 1 = up-down, 2 = down-down; electrons are ordered
[0..nup) up, [nup..nelec) down. The state carries the positions and the
scalar U; a one-electron move touches only the pair terms of that electron.
Periodic systems take minimal-image displacements from the Geometry; every
basis function vanishes beyond its cutoff, so rounding in fractional
coordinates serves when the largest cutoff fits the rounding cell
(Geometry.minimal_image_for).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..configs import Geometry
from ..utils.constants import DeviceConstants, index_tensor
from ..utils.dtypes import real_dtype, resolve_device
from . import func3d


class JastrowState(NamedTuple):
    positions: torch.Tensor  # (nconf, nelec, 3)
    u: torch.Tensor  # (nconf,)


class JastrowSpin:
    def __init__(self, mol, a_basis=None, b_basis=None, geometry=None):
        self.nup, self.ndn = mol.nelec
        self.nelec = self.nup + self.ndn
        self.atom_coords = np.asarray(mol.atom_coords)
        self.natom = len(self.atom_coords)
        self.a_basis = tuple(a_basis or func3d.default_ei_basis())
        self.b_basis = tuple(b_basis or func3d.default_ee_basis())
        self.geometry = geometry or Geometry(getattr(mol, "lattice", None))
        self._mi = self.geometry.minimal_image_for(max(b.rcut for b in self.a_basis + self.b_basis))
        self._spin = np.concatenate([np.zeros(self.nup, dtype=np.int64),
                                     np.ones(self.ndn, dtype=np.int64)])
        self._const = DeviceConstants(atoms=self.atom_coords, spin=self._spin)

    def make_params(self, device=None, dtype=None):
        """acoeff (natom, na, 2) zeros; bcoeff (nb, 3) with the e-e cusp
        (0.25, 0.5, 0.25) on the leading cutoffcusp function."""
        device = resolve_device(device)
        dtype = dtype or real_dtype(device)
        na, nb = len(self.a_basis), len(self.b_basis)
        acoeff = torch.zeros((self.natom, na, 2), dtype=dtype, device=device)
        bcoeff = torch.zeros((nb, 3), dtype=dtype, device=device)
        if self.b_basis[0].kind == "cutoffcusp":
            bcoeff[0] = torch.tensor([0.25, 0.5, 0.25], dtype=dtype, device=device)
        return {"acoeff": acoeff, "bcoeff": bcoeff}

    def _consts(self, like):
        """(atom coords (natom, 3), spins (nelec,)) on like's device."""
        c = self._const.get(like.device, like.dtype)
        return c["atoms"], c["spin"]

    def _u_total(self, params, positions):
        atoms, spin = self._consts(positions)
        d_ei = self._mi(positions[:, :, None, :] - atoms[None, None])
        r_ei = torch.sqrt(torch.sum(d_ei * d_ei, dim=-1))  # (nconf, nelec, natom)
        a_vals = func3d.eval_basis_value(self.a_basis, r_ei)
        acoeff = params["acoeff"][:, :, spin]  # (natom, na, nelec)
        u_a = torch.einsum("ceIk,Ike->c", a_vals, acoeff)
        d_ee = self._mi(positions[:, None, :, :] - positions[:, :, None, :])
        r_ee = torch.sqrt(torch.sum(d_ee * d_ee, dim=-1))
        b_vals = func3d.eval_basis_value(self.b_basis, r_ee)  # (c, i, j, nb)
        chan = spin[:, None] + spin[None, :]
        bc = params["bcoeff"][:, chan]  # (nb, nelec, nelec)
        iu = torch.triu_indices(self.nelec, self.nelec, offset=1, device=positions.device)
        u_b = torch.einsum("cpk,kp->c", b_vals[:, iu[0], iu[1], :], bc[:, iu[0], iu[1]])
        return u_a + u_b

    def _delta_terms(self, params, positions, e, epos, want_derivs):
        """U terms involving electron e with e at epos (nconf, [A,] 3).

        Returns (u, grad, lap) at epos; grad and lap are None unless
        want_derivs.
        """
        aux = epos.ndim == 3
        ep = epos if aux else epos[:, None, :]  # (nconf, A, 3)
        atoms, spin = self._consts(ep)
        d_ei = self._mi(ep[:, :, None, :] - atoms[None, None])
        r_ei = torch.sqrt(torch.sum(d_ei * d_ei, dim=-1))  # (nconf, A, natom)
        spin_e = int(e >= self.nup)
        ac = params["acoeff"][:, :, spin_e]  # (natom, na)
        d_ee = self._mi(ep[:, :, None, :] - positions[:, None, :, :])  # (nconf, A, nelec, 3)
        r_ee = torch.sqrt(torch.sum(d_ee * d_ee, dim=-1))
        bc = params["bcoeff"][:, spin_e + spin]  # (nb, nelec)
        notself = torch.ones(self.nelec, dtype=ep.dtype, device=ep.device)
        notself[e] = 0.0
        bcm = bc * notself
        if not want_derivs:
            u = (torch.einsum("caIk,Ik->ca", func3d.eval_basis_value(self.a_basis, r_ei), ac)
                 + torch.einsum("cajk,kj->ca", func3d.eval_basis_value(self.b_basis, r_ee), bcm))
            return (u if aux else u[:, 0]), None, None
        a_v, a_fr, a_lp = func3d.eval_basis_all(self.a_basis, r_ei)
        b_v, b_fr, b_lp = func3d.eval_basis_all(self.b_basis, r_ee)
        u = torch.einsum("caIk,Ik->ca", a_v, ac) + torch.einsum("cajk,kj->ca", b_v, bcm)
        g = (torch.einsum("caIk,Ik,caIx->cax", a_fr, ac, d_ei)
             + torch.einsum("cajk,kj,cajx->cax", b_fr, bcm, d_ee))
        lap = torch.einsum("caIk,Ik->ca", a_lp, ac) + torch.einsum("cajk,kj->ca", b_lp, bcm)
        if aux:
            return u, g, lap
        return u[:, 0], g[:, 0], lap[:, 0]

    # --- protocol ----------------------------------------------------------
    def recompute(self, params, positions):
        return JastrowState(positions=positions, u=self._u_total(params, positions))

    def value(self, params, state):
        return torch.ones_like(state.u), state.u

    def testvalue(self, params, state, e, epos):
        u_new, _, _ = self._delta_terms(params, state.positions, e, epos, False)
        u_old, _, _ = self._delta_terms(params, state.positions, e, state.positions[:, e, :], False)
        du = u_new - (u_old[:, None] if u_new.ndim == 2 else u_old)
        return torch.exp(du), {"du": du, "epos": epos}

    def testvalue_aux_all(self, params, state, aux, es=None):
        """Ratios (ne, nconf, naux) for moving electron es[i] to each of its
        points aux[i] (ne, nconf, naux, 3), es a static sequence of electron
        indices (None: all in order): testvalue of every electron in one
        batched evaluation, as the JAX package vmaps it."""
        es = tuple(range(aux.shape[0])) if es is None else tuple(int(e) for e in es)
        positions = state.positions
        atoms, spin = self._consts(aux)
        es_t = index_tensor(es, aux.device)
        spin_e = spin[es_t]  # (k,)
        ac = params["acoeff"][:, :, spin_e]  # (I, na, k)
        notself = (es_t[:, None] != torch.arange(self.nelec, device=aux.device)[None, :])
        bcm = params["bcoeff"][:, spin_e[:, None] + spin[None, :]] * notself.to(aux.dtype)

        def u_at(p):  # (k, nconf, A, 3) -> (k, nconf, A)
            d_ei = self._mi(p[..., None, :] - atoms)
            d_ee = self._mi(p[..., None, :] - positions[None, :, None, :, :])
            a_v = func3d.eval_basis_value(self.a_basis, torch.sqrt(torch.sum(d_ei * d_ei, dim=-1)))
            b_v = func3d.eval_basis_value(self.b_basis, torch.sqrt(torch.sum(d_ee * d_ee, dim=-1)))
            return (torch.einsum("kcAIm,Imk->kcA", a_v, ac)
                    + torch.einsum("kcAjm,mkj->kcA", b_v, bcm))

        cur = positions[:, list(es)].transpose(0, 1)[:, :, None, :]  # (k, nconf, 1, 3)
        return torch.exp(u_at(aux) - u_at(cur))

    def gradient_value(self, params, state, e, epos):
        u_new, g, _ = self._delta_terms(params, state.positions, e, epos, True)
        u_old, _, _ = self._delta_terms(params, state.positions, e, state.positions[:, e, :], False)
        du = u_new - u_old
        return g, torch.exp(du), {"du": du, "epos": epos}

    def move_begin(self, params, state, e, epos):
        """One delta-terms pass at the current position gives the drift
        gradient and u_old, which move_finish reuses."""
        u_old, g, _ = self._delta_terms(params, state.positions, e, epos, True)
        return g, u_old

    def move_finish(self, params, state, e, epos, aux):
        u_new, g, _ = self._delta_terms(params, state.positions, e, epos, True)
        du = u_new - aux
        return g, torch.exp(du), {"du": du, "epos": epos}

    def gradient_laplacian(self, params, state, e, epos):
        _, g, lap = self._delta_terms(params, state.positions, e, epos, True)
        return g, lap + torch.sum(g * g, dim=-1)

    def gradient_laplacian_many(self, params, state, es, epos):
        """gradient_laplacian of each electron es[i] at epos[:, i]: epos
        (nconf, k, 3) -> (grad (nconf, k, 3), lap (nconf, k)), all k
        electrons in one batched evaluation."""
        positions = state.positions
        atoms, spin = self._consts(epos)
        es_t = index_tensor(es, epos.device)
        spin_e = spin[es_t]  # (k,)
        d_ei = self._mi(epos[:, :, None, :] - atoms[None, None])  # (c, k, I, 3)
        r_ei = torch.sqrt(torch.sum(d_ei * d_ei, dim=-1))
        ac = params["acoeff"][:, :, spin_e]  # (I, na, k)
        d_ee = self._mi(epos[:, :, None, :] - positions[:, None, :, :])  # (c, k, n, 3)
        r_ee = torch.sqrt(torch.sum(d_ee * d_ee, dim=-1))
        notself = (es_t[:, None] != torch.arange(self.nelec, device=epos.device)[None, :])
        bcm = params["bcoeff"][:, spin_e[:, None] + spin[None, :]] * notself.to(epos.dtype)
        a_v, a_fr, a_lp = func3d.eval_basis_all(self.a_basis, r_ei)
        b_v, b_fr, b_lp = func3d.eval_basis_all(self.b_basis, r_ee)
        g = (torch.einsum("caIm,Ima,caIx->cax", a_fr, ac, d_ei)
             + torch.einsum("cajm,maj,cajx->cax", b_fr, bcm, d_ee))
        lap = torch.einsum("caIm,Ima->ca", a_lp, ac) + torch.einsum("cajm,maj->ca", b_lp, bcm)
        return g, lap + torch.sum(g * g, dim=-1)

    def updateinternals(self, params, state, e, epos, mask, saved):
        newpos = state.positions.clone()
        newpos[:, e, :] = torch.where(mask[:, None], epos, state.positions[:, e, :])
        return JastrowState(positions=newpos, u=torch.where(mask, state.u + saved["du"], state.u))
