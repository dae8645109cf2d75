"""Three-body (electron-electron-ion) Jastrow (counterpart of
pyqmc_tpu/models/jastrow3.py).

    U = 1/2 sum_{I, i != j, klm} C[I,k,l,m,ch(i,j)] a_k(r_iI) a_l(r_jI) b_m(r_ij)

C enters symmetrized in (k, l); electrons are ordered [up, down] and the
channel is ch = s_i + s_j in {0, 1, 2}. The state is (positions, U), as in
the JAX package; a move of electron e recomputes the terms that hold e:

    u_e(x) = sum_{j != e, I, k, m} a_k(|x - R_I|) b_m(|x - r_j|) T[e, j, I, k, m],
    T[e, j, I, k, m] = sum_l C[I,k,l,m, s_e + s_j] a_l(r_jI),

with T of the other electrons fixed. Every method evaluates a batch of
electrons at once (`_terms`: electrons es, each at its own points), so the
ECP quadrature, the kinetic energy and testvalue_many are one evaluation
each. The self pair j = e sits at r = 0; the table T is zero there before
it multiplies any basis value, and every basis function of func3d is finite
at r = 0 (the cutoffcusp's f'/r is large, not infinite), so no 0 x inf
arises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..configs import Geometry
from ..utils.constants import DeviceConstants, index_tensor
from ..utils.dtypes import real_dtype, resolve_device
from . import func3d


class Jastrow3State(NamedTuple):
    positions: torch.Tensor  # (nconf, nelec, 3)
    u: torch.Tensor  # (nconf,)


class ThreeBodyJastrow:
    def __init__(self, mol, a_basis=None, b_basis=None, geometry=None):
        self.nup, self.ndn = mol.nelec
        self.nelec = self.nup + self.ndn
        self.atom_coords = np.asarray(mol.atom_coords)
        self.natom = len(self.atom_coords)
        self.a_basis = tuple(a_basis or func3d.default_ei_basis(3))
        self.b_basis = tuple(b_basis or func3d.default_ei_basis(3))
        self.geometry = geometry or Geometry(getattr(mol, "lattice", None))
        self._mi = self.geometry.minimal_image_for(max(b.rcut for b in self.a_basis + self.b_basis))
        self._spin = np.concatenate([np.zeros(self.nup, dtype=np.int64),
                                     np.ones(self.ndn, dtype=np.int64)])
        chan = self._spin[:, None] + self._spin[None, :]
        # one-hot pair channels with the diagonal dropped: (nelec, nelec, 3)
        pairs = (chan[:, :, None] == np.arange(3)).astype(np.float64)
        pairs *= (1.0 - np.eye(self.nelec))[:, :, None]
        self._const = DeviceConstants(
            atoms=self.atom_coords, spin=self._spin, pairs=pairs,
            chans=np.arange(2)[:, None] + self._spin[None, :])  # (2, nelec): s_e + s_j

    def make_params(self, device=None, dtype=None):
        """ccoeff (natom, na, na, nb, 3) zeros, on the GPU unless `device`
        says otherwise."""
        device = resolve_device(device)
        dtype = dtype or real_dtype(device)
        na, nb = len(self.a_basis), len(self.b_basis)
        return {"ccoeff": torch.zeros((self.natom, na, na, nb, 3), dtype=dtype, device=device)}

    @staticmethod
    def _sym(c):
        return 0.5 * (c + c.transpose(1, 2))

    def _basis(self, which, r, derivs):
        """Values (..., nk), or (value, f'/r, lap) with derivs, of the a or b
        basis at distances r (...)."""
        basis = self.a_basis if which == "a" else self.b_basis
        if derivs:
            return func3d.eval_basis_all(basis, r)
        return func3d.eval_basis_value(basis, r)

    def _a_values(self, positions):
        """a_l(r_jI) of every electron: (nconf, nelec, natom, na)."""
        atoms = self._const.get(positions.device, positions.dtype)["atoms"]
        d = self._mi(positions[:, :, None, :] - atoms)
        return self._basis("a", torch.sqrt(torch.sum(d * d, dim=-1)), False)

    def _table(self, params, positions, es):
        """T of electrons es (a static sequence), zero at j = e:
        (K, nconf, nelec, natom, na, nb)."""
        c = self._const.get(positions.device, positions.dtype)
        csym = self._sym(params["ccoeff"])[:, :, :, :, c["chans"]]  # (I, k, l, m, 2, n)
        t = torch.einsum("cjIl,Iklmsj->scjIkm", self._a_values(positions), csym)
        es_t = index_tensor(es, positions.device)
        notself = (es_t[:, None] != torch.arange(self.nelec, device=positions.device)).to(
            positions.dtype)
        return t[c["spin"][es_t]] * notself[:, None, :, None, None, None]

    def _terms(self, table, positions, ep, derivs):
        """u_e at the points ep (K, nconf, A, 3) of each electron of the
        table; with derivs also grad (K, nconf, A, 3) and the laplacian of
        u_e (K, nconf, A)."""
        atoms = self._const.get(ep.device, ep.dtype)["atoms"]
        d_eI = self._mi(ep[..., None, :] - atoms)  # (K, c, A, I, 3)
        d_ej = self._mi(ep[..., None, :] - positions[None, :, None, :, :])  # (K, c, A, n, 3)
        r_eI = torch.sqrt(torch.sum(d_eI * d_eI, dim=-1))
        r_ej = torch.sqrt(torch.sum(d_ej * d_ej, dim=-1))
        if not derivs:
            m = torch.einsum("KcAjm,KcjIkm->KcAIk", self._basis("b", r_ej, False), table)
            return torch.sum(self._basis("a", r_eI, False) * m, dim=(-2, -1))
        a_v, a_fr, a_lp = self._basis("a", r_eI, True)
        b_v, b_fr, b_lp = self._basis("b", r_ej, True)
        m = torch.einsum("KcAjm,KcjIkm->KcAIk", b_v, table)
        q = torch.einsum("KcAIk,KcjIkm->KcAjm", a_v, table)
        y = torch.einsum("KcAjm,KcjIkm->KcAjIk", b_fr, table)
        u = torch.sum(a_v * m, dim=(-2, -1))
        g = (torch.einsum("KcAI,KcAIx->KcAx", torch.sum(a_fr * m, dim=-1), d_eI)
             + torch.einsum("KcAj,KcAjx->KcAx", torch.sum(b_fr * q, dim=-1), d_ej))
        w = torch.sum(a_fr[:, :, :, None, :, :] * y, dim=-1)  # (K, c, A, j, I)
        dot = torch.einsum("KcAIx,KcAjx->KcAjI", d_eI, d_ej)
        lap = (torch.sum(a_lp * m, dim=(-2, -1)) + torch.sum(b_lp * q, dim=(-2, -1))
               + 2.0 * torch.sum(w * dot, dim=(-2, -1)))
        return u, g, lap

    def _one(self, params, state, e, epos, derivs, with_current):
        """_terms of electron e at epos (nconf, [A,] 3), the current
        position prepended on the point axis when with_current."""
        pos = state.positions
        ep = epos[:, None, :] if epos.ndim == 2 else epos
        if with_current:
            ep = torch.cat([pos[:, e, None, :], ep], dim=1)
        return self._terms(self._table(params, pos, (e,)), pos, ep[None], derivs)

    def _pair_sums(self, positions):
        """G[c, I, k, l, m, h] = 1/2 sum_{i != j, ch(i, j) = h} a_k(r_iI)
        a_l(r_jI) b_m(r_ij), symmetric in (k, l): U = <sym(C), G>."""
        a = self._a_values(positions)
        d = self._mi(positions[:, None, :, :] - positions[:, :, None, :])
        b = self._basis("b", torch.sqrt(torch.sum(d * d, dim=-1)), False)  # (c, i, j, m)
        pairs = self._const.get(positions.device, positions.dtype)["pairs"]
        bw = b[..., None] * pairs[None, :, :, None, :]  # (c, i, j, m, h)
        z = torch.einsum("cjIl,cijmh->ciIlmh", a, bw)
        g = 0.5 * torch.einsum("ciIk,ciIlmh->cIklmh", a, z)
        return 0.5 * (g + g.transpose(2, 3))

    # --- protocol ----------------------------------------------------------
    def recompute(self, params, positions):
        u = torch.einsum("cIklmh,Iklmh->c", self._pair_sums(positions), self._sym(params["ccoeff"]))
        return Jastrow3State(positions=positions, u=u)

    def value(self, params, state):
        return torch.ones_like(state.u), state.u

    def testvalue(self, params, state, e, epos):
        u = self._one(params, state, e, epos, False, True)[0]
        du = u[:, 1:] - u[:, :1]
        du = du if epos.ndim == 3 else du[:, 0]
        return torch.exp(du), {"du": du}

    def testvalue_aux_all(self, params, state, aux, es=None):
        """Ratios (K, nconf, naux) for moving electron es[i] to each of its
        points aux[i] (K, nconf, naux, 3), es a static sequence (None: all
        electrons in order), in one evaluation."""
        es = tuple(range(aux.shape[0])) if es is None else tuple(int(e) for e in es)
        pos = state.positions
        cur = pos[:, list(es)].transpose(0, 1)[:, :, None, :]
        u = self._terms(self._table(params, pos, es), pos, torch.cat([cur, aux], dim=2), False)
        return torch.exp(u[..., 1:] - u[..., :1])

    def testvalue_many(self, params, state, epos):
        """exp(dU_e) for each electron e moved to epos (nconf, 3), one at a
        time: (nconf, nelec)."""
        pos = state.positions
        es = tuple(range(self.nelec))
        ep = torch.stack([pos.transpose(0, 1), epos[None].expand(self.nelec, -1, -1)], dim=2)
        u = self._terms(self._table(params, pos, es), pos, ep, False)
        return torch.exp(u[..., 1] - u[..., 0]).transpose(0, 1)

    def gradient_value(self, params, state, e, epos):
        u, g, _ = self._one(params, state, e, epos, True, True)
        du = u[0, :, 1] - u[0, :, 0]
        return g[0, :, 1], torch.exp(du), {"du": du}

    def gradient(self, params, state, e, epos):
        return self._one(params, state, e, epos, True, False)[1][0, :, 0]

    def gradient_value_pair(self, params, state, e, epos_old, epos_new):
        u, g, _ = self._one(params, state, e, torch.stack([epos_old, epos_new], dim=1), True, False)
        du = u[0, :, 1] - u[0, :, 0]
        return g[0, :, 0], g[0, :, 1], torch.exp(du), {"du": du}

    def move_begin(self, params, state, e, epos):
        """One pass at the current position: the drift gradient, and for
        move_finish u_old and electron e's table T."""
        table = self._table(params, state.positions, (e,))
        u, g, _ = self._terms(table, state.positions, epos[None, :, None, :], True)
        return g[0, :, 0], (u[0, :, 0], table)

    def move_finish(self, params, state, e, epos, aux):
        u_old, table = aux
        u, g, _ = self._terms(table, state.positions, epos[None, :, None, :], True)
        du = u[0, :, 0] - u_old
        return g[0, :, 0], torch.exp(du), {"du": du}

    def gradient_laplacian(self, params, state, e, epos):
        _, g, lap = self._one(params, state, e, epos, True, False)
        g, lap = g[0, :, 0], lap[0, :, 0]
        return g, lap + torch.sum(g * g, dim=-1)

    def gradient_laplacian_many(self, params, state, es, epos):
        """gradient_laplacian of each electron es[i] at epos[:, i]: epos
        (nconf, k, 3) -> (grad (nconf, k, 3), lap (nconf, k))."""
        es = tuple(int(e) for e in es)
        pos = state.positions
        _, g, lap = self._terms(self._table(params, pos, es), pos,
                                epos.transpose(0, 1)[:, :, None, :], True)
        g, lap = g[:, :, 0].transpose(0, 1), lap[:, :, 0].transpose(0, 1)
        return g, lap + torch.sum(g * g, dim=-1)

    def updateinternals(self, params, state, e, epos, mask, saved):
        newpos = state.positions.clone()
        newpos[:, e, :] = torch.where(mask[:, None], epos, state.positions[:, e, :])
        return Jastrow3State(positions=newpos, u=torch.where(mask, state.u + saved["du"], state.u))

    def pgradient(self, params, positions):
        """dU/dccoeff per walker (nconf, natom, na, na, nb, 3): U is linear
        in the symmetrized C, so the gradient with respect to the raw
        coefficients is the (k, l)-symmetric pair sum G; the antisymmetric
        directions get zero, as autodiff through the symmetrization gives
        in the JAX package."""
        return {"ccoeff": self._pair_sums(positions)}
