"""Plain reference of a periodic Slater-Jastrow wavefunction: a supercell
of a primitive crystal at time-reversal-invariant k-points, Ewald sums and
a downselected semilocal ECP. It extends the molecular reference
(`molecule_sj`) with what periodicity changes, and imports nothing of the
program:

- the supercell: the primitive cell's atoms translated by every primitive
  lattice point inside it, translation-major;
- Bloch orbitals: a point folded into the primitive cell (its fold phase
  e^{ik.wA}, +-1 at these k), primitive AOs summed over every (lattice
  image, shell) pair whose shell reaches the home cell (within
  sqrt(-ln(img_tol) / its least exponent) of a 6^3 sample of the cell, plus
  the sample's margin) with the Bloch phases e^{ik.L}, each orbital rotated
  to a real vector (by exp(-i arg(v.v) / 2));
- the Jastrow and the ECP on minimal-image displacements (the shortest of
  the 27 neighbouring images), electrons folded into the supercell;
- Ewald's electron-electron, electron-ion and ion-ion energies from a
  pair-by-pair sum;
- the ECP's points downselected per electron: the half with the largest
  |T| kept, the rest by a systematic scan of the others' |T| with the
  step's uniform, importance-weighted.
"""

from __future__ import annotations

import itertools
import json
import math

import numpy as np
import torch
from scipy.special import erfc

from . import molecule_sj as mol


def load_crystal(path, S, nocc, img_tol):
    """The supercell system of a primitive-cell .npz: as
    molecule_sj.load_system gives a molecule's, plus the lattice, the
    primitive cell and its k-point orbitals (the first `nocc` of each k)."""
    with np.load(path, allow_pickle=False) as z:
        d = {k: z[k] for k in z.files}
    symbols = [mol._text(s) for s in d["atom_symbols"]]
    basis = json.loads(mol._text(d["basis_json"]))
    ecp = json.loads(mol._text(d["ecp_json"])) or {}
    prim = np.asarray(d["atom_coords"], dtype=np.float64)
    lat = np.asarray(d["lattice"], dtype=np.float64)
    S = np.asarray(S, dtype=int)
    n = int(round(abs(np.linalg.det(S))))
    pts = np.array(list(itertools.product(*[range(-b, b + 1) for b in np.abs(S).sum(axis=0)])))
    frac = pts @ np.linalg.inv(S)
    trans = pts[np.all((frac > -1e-9) & (frac < 1 - 1e-9), axis=1)]
    if len(trans) != n:
        raise ValueError(f"{len(trans)} translations for a supercell of {n} cells")
    coords = np.array([c + t @ lat for t in trans for c in prim])
    sup_symbols = [s for _ in trans for s in symbols]
    charges = np.array([mol.ATOMIC_NUMBER[s] - (ecp[s][0] if s in ecp else 0)
                        for s in sup_symbols], dtype=np.float64)
    nelec = int(charges.sum())
    spin = int(d["spin"]) * n
    prim_shells = []  # pyscf's form: contraction coefficients of unnormalised primitives
    for ia, s in enumerate(symbols):
        for entry in basis[s]:
            p = np.asarray(entry[1:], dtype=np.float64)
            l = int(entry[0])
            prim_shells.append((ia, l, p[:, 0], normalised(l, p[:, 0], p[:, 1])))
    return {"symbols": sup_symbols, "coords": coords, "charges": charges,
            "nelec": ((nelec + spin) // 2, (nelec - spin) // 2),
            "ecp": {s: ecp[s] for s in set(symbols) if s in ecp},
            "lattice": S @ lat, "prim_lattice": lat, "prim_coords": prim,
            "prim_shells": prim_shells, "kpts": np.asarray(d["kpts"], dtype=np.float64),
            "mo_coeff": [np.asarray(d["mo_coeff"][k])[:, :nocc] for k in range(len(d["kpts"]))],
            "img_tol": img_tol}


def normalised(l, exps, coeffs):
    """Coefficients of a shell's primitives r^l exp(-a r^2) such that each
    primitive and the contraction have unit radial norm."""
    g = math.gamma(l + 1.5)
    c = coeffs * np.sqrt(2.0 * (2.0 * exps) ** (l + 1.5) / g)
    norm2 = g / 2.0 * np.sum(c[:, None] * c[None, :] / (exps[:, None] + exps[None, :]) ** (l + 1.5))
    return c / math.sqrt(norm2)


def real_orbitals(c):
    """Each column v of c rotated by exp(-i arg(v.v) / 2), its real part."""
    cols = [(c[:, j] * np.exp(-0.5j * np.angle(np.sum(c[:, j] * c[:, j])))).real
            for j in range(c.shape[1])]
    return np.stack(cols, axis=1)


def kept_images(lat, coords, shells, tol, ngrid=6):
    """[(image L, shell index)] of every shell whose shifted centre lies
    within sqrt(-ln(tol) / its least exponent) plus the margin of an
    ngrid^3 sample of the primitive cell."""
    fr = (np.arange(ngrid) + 0.5) / ngrid
    grid = np.array(list(itertools.product(fr, fr, fr))) @ lat
    margin = 0.5 * np.linalg.norm(lat.sum(axis=0)) / ngrid
    heights = 1.0 / np.linalg.norm(np.linalg.inv(lat), axis=0)
    reach = max(math.sqrt(-math.log(tol) / float(np.min(s[2]))) for s in shells) + margin
    nimg = np.ceil((reach + np.linalg.norm(lat.sum(axis=0))) / heights).astype(int)
    out = []
    for n in itertools.product(*[range(-m, m + 1) for m in nimg]):
        L = np.asarray(n) @ lat
        for i, (atom, _, exps, _) in enumerate(shells):
            dist = np.min(np.linalg.norm(grid - (coords[atom] + L), axis=1))
            if dist <= math.sqrt(-math.log(tol) / float(np.min(exps))) + margin:
                out.append((L, i))
    return out


def replicated_shells(system, pairs=None):
    """([(centre index, l, exps, coeffs)] one per kept (image, shell) pair,
    their centres (n, 3))."""
    shells, coords = system["prim_shells"], system["prim_coords"]
    if pairs is None:
        pairs = kept_images(system["prim_lattice"], coords, shells, system["img_tol"])
    repl = [(k, shells[i][1], shells[i][2], shells[i][3]) for k, (_, i) in enumerate(pairs)]
    return repl, np.array([coords[shells[i][0]] + L for L, i in pairs])


def ewald_parts(lat, alpha=None, tol=1e-16):
    """(alpha, images, G vectors, their weights w_G, xi) of the Ewald sum
    with w_G = 2 (4 pi / V) exp(-G^2 / 4 alpha^2) / G^2 over half of G
    space, alpha = 5 / the least cell height."""
    inv = np.linalg.inv(lat)
    heights = 1.0 / np.linalg.norm(inv, axis=0)
    alpha = alpha or 5.0 / float(np.min(heights))
    vol = abs(np.linalg.det(lat))
    # real-space images: every L within erfc's reach of a minimal-image r
    rcut = math.sqrt(-math.log(tol)) / alpha + 0.5 * np.linalg.norm(lat.sum(axis=0))
    nimg = np.ceil(rcut / heights).astype(int)
    images = np.array(list(itertools.product(*[range(-m, m + 1) for m in nimg]))) @ lat
    images = images[np.linalg.norm(images, axis=1) <= rcut]
    recip = 2 * np.pi * inv.T
    bheights = 1.0 / np.linalg.norm(np.linalg.inv(recip), axis=0)
    gmax = 2 * alpha * math.sqrt(-math.log(tol))
    nG = np.ceil(gmax / bheights).astype(int)
    half = [n for n in itertools.product(*[range(-m, m + 1) for m in nG])
            if n[0] > 0 or (n[0] == 0 and (n[1] > 0 or (n[1] == 0 and n[2] > 0)))]
    G = np.array(half) @ recip
    G2 = np.sum(G * G, axis=1)
    w = 2 * (4 * np.pi / vol) * np.exp(-G2 / (4 * alpha ** 2)) / G2
    keep = w > tol
    L = np.linalg.norm(images, axis=1)
    nz = L > 1e-12
    xi = (float(np.sum(erfc(alpha * L[nz]) / L[nz])) + float(np.sum(w[keep]))
          - np.pi / (vol * alpha ** 2) - 2 * alpha / math.sqrt(np.pi))
    return alpha, images, G[keep], w[keep], xi, vol


def downselect(T, nselect, u):
    """(indices (..., nselect), weights): the nselect // 2 points of
    largest |T| (the lowest index first among equals) with weight 1, then
    nselect - nselect // 2 by a systematic scan, with the one uniform u, of
    the normalised cumulative |T| of the others, weight 1 / (count x their
    probability)."""
    nq = T.shape[-1]
    ndet, nst = nselect // 2, nselect - nselect // 2
    a = torch.abs(T)
    order = torch.sort(a, dim=-1, descending=True, stable=True).indices[..., :ndet]
    rest = a.scatter(-1, order, torch.zeros_like(order, dtype=a.dtype))
    total = torch.sum(rest, dim=-1, keepdim=True)
    p = rest / torch.where(total == 0, torch.ones_like(total), total)
    cum = torch.cumsum(p, dim=-1)
    cum = cum / torch.clamp(cum[..., -1:], min=1e-30)
    teeth = (u[..., None] + torch.arange(nst, dtype=T.dtype, device=T.device)) / nst
    pick = torch.clamp(torch.sum(cum[..., None, :] <= teeth[..., :, None], dim=-1), 0, nq - 1)
    pp = torch.gather(p, -1, pick)
    w = torch.where(pp > 0, (total > 0).to(T.dtype) / (nst * torch.clamp(pp, min=1e-30)),
                    torch.zeros_like(pp))
    return torch.cat([order, pick], dim=-1), torch.cat([torch.ones_like(order, dtype=T.dtype), w],
                                                       dim=-1)


class CrystalSJ(mol.SlaterJastrow):
    """psi = det_up det_dn exp(U) of a supercell; `params` the Jastrow's
    acoeff (natom, na, 2) and bcoeff (nb, 3) on the bases of `bases`;
    `nselect` the ECP points evaluated per electron."""

    def __init__(self, system, params, device, dtype=torch.float64, bases=None, rmax=10.0,
                 nselect=None):
        self.device, self.dtype = device, dtype
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
        self.lattice, self.lattice_inv = t(system["lattice"]), t(np.linalg.inv(system["lattice"]))
        self.prim, self.prim_inv = (t(system["prim_lattice"]),
                                    t(np.linalg.inv(system["prim_lattice"])))
        self.neighbours = t(np.array(list(itertools.product((-1, 0, 1), repeat=3)))
                            @ system["lattice"])
        self.nselect = nselect
        super().__init__(system, params, device, dtype, bases, rmax)
        alpha, images, G, w, xi, vol = ewald_parts(system["lattice"])
        self.alpha, self.images, self.G, self.gw = alpha, t(images), t(G), t(w)
        self.xi, self.vol = xi, vol
        self.e_ii = self._ion_ion(system)

    def _setup_orbitals(self, system):
        shells = system["prim_shells"]
        pairs = kept_images(system["prim_lattice"], system["prim_coords"], shells,
                            system["img_tol"])
        repl, centers = replicated_shells(system, pairs)
        self.ao = mol.AtomicOrbitals(repl, centers, self.device, self.dtype)
        starts = np.cumsum([0] + [2 * s[1] + 1 for s in shells])
        ao_of = np.concatenate([np.arange(starts[i], starts[i] + 2 * shells[i][1] + 1)
                                for _, i in pairs])
        L_of = np.concatenate([np.repeat(L[None], 2 * shells[i][1] + 1, axis=0) for L, i in pairs])
        kpts = system["kpts"]
        blocks = [real_orbitals(c) for c in system["mo_coeff"]]
        cols = [np.cos(L_of @ k)[:, None] * b[ao_of] for k, b in zip(kpts, blocks)]
        R = np.concatenate(cols, axis=1)  # (nao_repl, norb)
        korb = np.concatenate([np.full(b.shape[1], i) for i, b in enumerate(blocks)])
        t = lambda a: torch.as_tensor(a, dtype=self.dtype, device=self.device)
        self.mo = (t(R), t(R))
        self.kpts_of_orb = t(kpts[korb])  # (norb, 3)

    # --- geometry ---
    def displacement(self, d):
        """The shortest of the 27 neighbouring images of d after rounding."""
        f = d @ self.lattice_inv
        d = (f - torch.round(f)) @ self.lattice
        cand = d[..., None, :] + self.neighbours
        i = torch.argmin(torch.sum(cand * cand, dim=-1), dim=-1)
        return torch.gather(cand, -2, i[..., None, None].expand(*i.shape, 1, 3))[..., 0, :]

    def fold(self, x):
        f = x @ self.lattice_inv
        return (f - torch.floor(f)) @ self.lattice

    def orbitals(self, x, s):
        f = x @ self.prim_inv
        w = torch.floor(f)
        xf = (f - w) @ self.prim
        phase = torch.cos((w @ self.prim) @ self.kpts_of_orb.T)  # +-1 at these k
        return torch.matmul(self.ao(xf), self.mo[s]) * torch.sign(phase)

    # --- energies ---
    def _real_space(self, r):
        """sum over images of erfc(alpha |r + L|) / |r + L| at minimal-image r."""
        d = self.displacement(r)[..., None, :] + self.images
        dist = torch.linalg.norm(d, dim=-1)
        return torch.sum(torch.special.erfc(self.alpha * dist) / dist, dim=-1)

    def _structure(self, x):
        """(cos, sin) sums over the points x (B, n, 3): (B, nG) each."""
        ph = x @ self.G.T
        return torch.sum(torch.cos(ph), dim=1), torch.sum(torch.sin(ph), dim=1)

    def _ion_ion(self, system):
        """Ion-ion energy: the pairs' real-space and reciprocal sums, the
        background and the self term."""
        c = torch.as_tensor(system["coords"], dtype=self.dtype, device=self.device)
        q = torch.as_tensor(system["charges"], dtype=self.dtype, device=self.device)
        n = len(q)
        iu = torch.triu_indices(n, n, offset=1, device=self.device)
        real = torch.sum(q[iu[0]] * q[iu[1]] * self._real_space(c[iu[0]] - c[iu[1]]))
        ph = c @ self.G.T
        sc, ss = torch.sum(q[:, None] * torch.cos(ph), 0), torch.sum(q[:, None] * torch.sin(ph), 0)
        rec = 0.5 * torch.sum(self.gw * (sc * sc + ss * ss - torch.sum(q * q)))
        back = math.pi / (self.vol * self.alpha ** 2)
        pairs = (float(torch.sum(q)) ** 2 - float(torch.sum(q * q))) / 2
        return float(real + rec) - pairs * back + 0.5 * float(torch.sum(q * q)) * self.xi

    def coulomb(self, R):
        back = math.pi / (self.vol * self.alpha ** 2)
        ne = self.nelec
        iu = torch.triu_indices(ne, ne, offset=1, device=self.device)
        sc, ss = self._structure(R)
        ee = (torch.sum(self._real_space(R[:, iu[0]] - R[:, iu[1]]), dim=-1)
              + 0.5 * torch.sum(self.gw * (sc * sc + ss * ss - ne), dim=-1)
              - ne * (ne - 1) / 2 * back + 0.5 * ne * self.xi)
        ph = self.atoms @ self.G.T
        ic = torch.sum(self.charges[:, None] * torch.cos(ph), 0)
        isn = torch.sum(self.charges[:, None] * torch.sin(ph), 0)
        ei = (-torch.sum(self.charges * self._real_space(R[:, :, None] - self.atoms), dim=(1, 2))
              - torch.sum(self.gw * (sc * ic + ss * isn), dim=-1)
              + ne * float(torch.sum(self.charges)) * back)
        return ee, ei, torch.full_like(ee, self.e_ii)

    def select(self, aux, T, u):
        """Where an electron has more points than `nselect`, those of the
        downselection on its uniform u (B,), weighted."""
        if self.nselect is None or self.nselect >= T.shape[1]:
            return aux, T
        idx, wts = downselect(T, self.nselect, u)
        return (torch.gather(aux, 1, idx[..., None].expand(*idx.shape, 3)),
                torch.gather(T, 1, idx) * wts)
