"""Plain reference of a Slater-Jastrow wavefunction with a semilocal ECP in
open boundaries: the yardstick that judges the program's VMC and DMC blocks.

It reads the same system file as the program (an .npz of atoms, basis and
ECP in pyscf's JSON form and SCF orbitals), takes the same Jastrow
coefficients and the same random streams, and works everything else out
again in plain PyTorch, in float64 unless told otherwise:

- atomic orbitals as contracted Gaussians times real solid harmonics
  (pyscf's order and normalisation), molecular orbitals by a matmul;
- each spin's determinant by `torch.linalg.slogdet` of the whole matrix
  after every move, no Sherman-Morrison update;
- the two-body Jastrow (electron-ion and electron-electron terms on
  polynomial-Pade and cusp functions) summed pair by pair;
- every derivative (drift, kinetic energy) by autograd of log|psi| in the
  moved electron's coordinates;
- the nonlocal ECP on a rotated spherical quadrature, its ratios by the same
  whole-determinant recompute, and Casula's T-moves on it.

It imports nothing of the program. `Walkers` carries one sample of walkers
through a block: the sweeps, T-moves and energies follow the method's
formulas step by step on the streams the program drew.
"""

from __future__ import annotations

import json
import math

import numpy as np
import torch

# effective charge = atomic number - ECP core electrons
ATOMIC_NUMBER = {"H": 1, "He": 2, "Li": 3, "Be": 4, "B": 5, "C": 6, "N": 7, "O": 8, "F": 9,
                 "Ne": 10, "Na": 11, "Mg": 12, "Al": 13, "Si": 14, "P": 15, "S": 16, "Cl": 17,
                 "Ar": 18}


def _text(v):
    v = v.item() if isinstance(v, np.ndarray) else v
    return v.decode() if isinstance(v, bytes) else str(v)


def load_system(path):
    """The system of an .npz written for the program: a dict of numpy
    arrays and plain lists, nothing derived beyond parsing."""
    with np.load(path, allow_pickle=False) as z:
        d = {k: z[k] for k in z.files}
    symbols = [_text(s) for s in d["atom_symbols"]]
    basis = json.loads(_text(d["basis_json"]))
    ecp = json.loads(_text(d["ecp_json"])) or {}
    coords = np.asarray(d["atom_coords"], dtype=np.float64)
    ncore = [ecp[s][0] if s in ecp else 0 for s in symbols]
    charges = np.array([ATOMIC_NUMBER[s] - n for s, n in zip(symbols, ncore)], dtype=np.float64)
    nelec = int(charges.sum()) - int(d.get("charge", 0))
    spin = int(d["spin"])
    shells = []  # (atom, l, exps, coeffs) in the AO order: atoms, then their shells
    for ia, s in enumerate(symbols):
        for entry in basis[s]:
            prims = np.asarray(entry[1:], dtype=np.float64)
            shells.append((ia, int(entry[0]), prims[:, 0], prims[:, 1]))
    return {"symbols": symbols, "coords": coords, "charges": charges,
            "nelec": ((nelec + spin) // 2, (nelec - spin) // 2), "shells": shells,
            "ecp": {s: ecp[s] for s in set(symbols) if s in ecp},
            "mo_coeff": (np.asarray(d["mo_coeff_alpha"]), np.asarray(d["mo_coeff_beta"]))}


# --- atomic orbitals ---------------------------------------------------------

def solid_harmonics(d, l):
    """Sphere-normalised real solid harmonics of degree l at displacements d
    (..., 3), pyscf's order: l = 1 as (x, y, z); l = 2 as m = -2..2."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    if l == 0:
        return (torch.ones_like(x) * math.sqrt(1.0 / (4 * math.pi)))[..., None]
    if l == 1:
        return d * math.sqrt(3.0 / (4 * math.pi))
    if l == 2:
        c = math.sqrt(15.0 / (4 * math.pi))
        return torch.stack([c * x * y, c * y * z,
                            math.sqrt(5.0 / (16 * math.pi)) * (2 * z * z - x * x - y * y),
                            c * x * z, math.sqrt(15.0 / (16 * math.pi)) * (x * x - y * y)], dim=-1)
    raise ValueError(f"solid harmonics of l={l} are not in the reference")


class AtomicOrbitals:
    """ao(points (..., 3)) -> (..., nao) in the system's AO order."""

    def __init__(self, shells, coords, device, dtype):
        self.groups = []
        order = []
        offset = 0
        starts = []
        for _, l, _, _ in shells:
            starts.append(offset)
            offset += 2 * l + 1
        self.nao = offset
        for l in sorted({s[1] for s in shells}):
            idx = [i for i, s in enumerate(shells) if s[1] == l]
            pmax = max(len(shells[i][2]) for i in idx)
            alpha = np.ones((len(idx), pmax))
            coef = np.zeros((len(idx), pmax))
            for k, i in enumerate(idx):
                alpha[k, :len(shells[i][2])] = shells[i][2]
                coef[k, :len(shells[i][3])] = shells[i][3]
            centers = coords[[shells[i][0] for i in idx]]
            t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
            self.groups.append((l, t(centers), t(alpha), t(coef)))
            order += [starts[i] + m for i in idx for m in range(2 * l + 1)]
        self.perm = torch.as_tensor(np.argsort(order), device=device)

    def __call__(self, x):
        out = []
        for l, centers, alpha, coef in self.groups:
            d = x[..., None, :] - centers  # (..., S, 3)
            r2 = torch.sum(d * d, dim=-1)
            radial = torch.sum(coef * torch.exp(-alpha * r2[..., None]), dim=-1)  # (..., S)
            vals = solid_harmonics(d, l) * radial[..., None]  # (..., S, 2l+1)
            out.append(vals.reshape(*vals.shape[:-2], -1))
        return torch.cat(out, dim=-1)[..., self.perm]


# --- Jastrow -------------------------------------------------------------------

def polypade(r, beta, rcut):
    """(1 - z) / (1 + beta z), z = x^2 (6 - 8x + 3x^2), x = r / rcut <= 1."""
    x = torch.clamp(r / rcut, max=1.0)
    z = x * x * (6.0 - 8.0 * x + 3.0 * x * x)
    return (1.0 - z) / (1.0 + beta * z)


def cutoffcusp(r, gamma, rcut):
    """rcut (p / (1 + gamma p) - c0), p = y - y^2 + y^3 / 3, y = r / rcut <= 1."""
    y = torch.clamp(r / rcut, max=1.0)
    p = y - y * y + y ** 3 / 3.0
    return rcut * (p / (1.0 + gamma * p) - (1.0 / 3.0) / (1.0 + gamma / 3.0))


def basis_values(spec, r):
    """(..., nk) of a list of (kind, parameter, rcut)."""
    f = {"polypade": polypade, "cutoffcusp": cutoffcusp}
    return torch.stack([f[kind](r, p, rcut) for kind, p, rcut in spec], dim=-1)


# --- ECP ---------------------------------------------------------------------------

def quadrature_grid(naip):
    """(points, weights) of the 6-point octahedron or the 12-point
    icosahedron on the unit sphere."""
    if naip == 6:
        pts = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
                       dtype=np.float64)
        return pts, np.full(6, 1.0 / 6.0)
    if naip == 12:
        phi = (1.0 + math.sqrt(5.0)) / 2.0
        pts = []
        for a in (-1.0, 1.0):
            for b in (-phi, phi):
                pts += [[0, a, b], [a, b, 0], [b, 0, a]]
        pts = np.asarray(pts)
        return pts / np.linalg.norm(pts, axis=1, keepdims=True), np.full(12, 1.0 / 12.0)
    raise ValueError(f"a {naip}-point quadrature is not in the reference")


def legendre(l, x):
    return [lambda t: torch.ones_like(t), lambda t: t, lambda t: 0.5 * (3 * t * t - 1),
            lambda t: 0.5 * (5 * t ** 3 - 3 * t)][l](x)


def radial(terms, r):
    """sum of c r^(n-2) exp(-e r^2) over (c, e, n)."""
    out = torch.zeros_like(r)
    for c, e, n in terms:
        out = out + c * r ** (n - 2) * torch.exp(-e * r * r)
    return out


def parse_channels(channels):
    """{l: [(coeff, exponent, power)]} of one element's pyscf ECP."""
    out = {}
    for l, slots in channels:
        out[l] = [(c, e, power) for power, terms in enumerate(slots) for e, c in terms]
    return out


def rotations(q):
    """Rotation matrices (..., 3, 3) of quaternions q (..., 4), normalised here."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        dim=-1).reshape(*q.shape[:-1], 3, 3)


# --- the wavefunction ----------------------------------------------------------

class SlaterJastrow:
    """psi = det_up det_dn exp(U) of a molecule; `params` the numpy
    Jastrow coefficients acoeff (natom, na, 2) and bcoeff (nb, 3) on the
    bases {"ei_basis", "ee_basis"}: lists of (kind, parameter, rcut)."""

    def __init__(self, system, params, device, dtype=torch.float64, bases=None, rmax=10.0):
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
        self.device, self.dtype = device, dtype
        self.nup, self.ndn = system["nelec"]
        self.nelec = self.nup + self.ndn
        self.atoms = t(system["coords"])
        self.charges = t(system["charges"])
        self._setup_orbitals(system)
        self.acoeff, self.bcoeff = t(params["acoeff"]), t(params["bcoeff"])
        self.spin = [0] * self.nup + [1] * self.ndn
        self.ei_basis = [tuple(b) for b in bases["ei_basis"]]
        self.ee_basis = [tuple(b) for b in bases["ee_basis"]]
        self.rmax = rmax
        self._setup_ecp(system)
        q = system["charges"]
        r = system["coords"]
        self.e_ii = sum(q[i] * q[j] / np.linalg.norm(r[i] - r[j])
                        for i in range(len(q)) for j in range(i + 1, len(q)))

    def _setup_orbitals(self, system):
        self.ao = AtomicOrbitals(system["shells"], system["coords"], self.device, self.dtype)
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=self.dtype, device=self.device)
        ca, cb = system["mo_coeff"]
        self.mo = (t(ca[:, :self.nup]), t(cb[:, :self.ndn]))

    def _setup_ecp(self, system):
        self.local_terms, self.nl_terms = [], []
        for ia, s in enumerate(system["symbols"]):
            if s not in system["ecp"]:
                continue
            ch = parse_channels(system["ecp"][s][1])
            if -1 in ch:
                self.local_terms.append((ia, ch[-1]))
            nl = {l: v for l, v in ch.items() if l >= 0}
            if nl:
                pts, w = quadrature_grid(12 if len(nl) > 1 else 6)
                self.nl_terms.append((ia, nl, torch.as_tensor(pts, dtype=self.dtype,
                                                              device=self.device),
                                      torch.as_tensor(w, dtype=self.dtype, device=self.device)))

    # geometry hooks, the identity in open boundaries
    def displacement(self, d):
        return d

    def fold(self, x):
        return x

    # --- pieces of log psi ---
    def orbitals(self, x, s):
        """MO values (..., n_s) of spin s at points x (..., 3)."""
        return torch.matmul(self.ao(x), self.mo[s])

    def jastrow_terms(self, R, e, x):
        """The terms of U that hold electron e, with e at x (B, ..., 3); R
        (B, nelec, 3) gives the other electrons."""
        s = self.spin[e]
        lead = x.shape[1:-1]
        xe = x.reshape(x.shape[0], -1, 3)  # (B, K, 3)
        r_ei = torch.linalg.norm(self.displacement(xe[:, :, None, :] - self.atoms), dim=-1)
        u = torch.einsum("bkIn,In->bk", basis_values(self.ei_basis, r_ei), self.acoeff[:, :, s])
        others = [j for j in range(self.nelec) if j != e]
        d = self.displacement(xe[:, :, None, :] - R[:, None, others, :])
        r_ee = torch.linalg.norm(d, dim=-1)  # (B, K, nelec-1)
        chan = torch.as_tensor([s + self.spin[j] for j in others], device=self.device)
        bvals = basis_values(self.ee_basis, r_ee)  # (B, K, nelec-1, nb)
        u = u + torch.sum(bvals * self.bcoeff[:, chan].T, dim=(-2, -1))
        return u.reshape(x.shape[0], *lead)

    def spin_block(self, e):
        return (0, self.nup) if e < self.nup else (self.nup, self.nelec)

    def log_psi_moved(self, R, mats, e, x):
        """(sign, log|psi| up to the terms that hold no electron e's
        coordinates) with electron e at x (B, ..., 3): its spin's orbital
        matrix with row e recomputed, and the Jastrow terms of e."""
        s = self.spin[e]
        lo, _ = self.spin_block(e)
        lead = x.shape[1:-1]
        row = self.orbitals(x, s)  # (B, ..., n)
        m = mats[s].reshape(mats[s].shape[0], *(1,) * len(lead), *mats[s].shape[1:])
        m = m.expand(m.shape[0], *lead, *mats[s].shape[1:])
        onehot = torch.zeros(m.shape[-2], device=self.device, dtype=self.dtype)
        onehot[e - lo] = 1.0
        m = m * (1 - onehot)[:, None] + onehot[:, None] * row[..., None, :]
        sign, logdet = torch.linalg.slogdet(m)
        return sign, logdet + self.jastrow_terms(R, e, x)

    def matrices(self, R):
        """The orbital matrices (up (B, nup, nup), dn (B, ndn, ndn))."""
        return (self.orbitals(R[:, :self.nup], 0), self.orbitals(R[:, self.nup:], 1))

    def grad_log(self, R, mats, e, x):
        """(sign, log|psi| part, grad_x log|psi| (B, 3)) at x (B, 3)."""
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            sign, logv = self.log_psi_moved(R, mats, e, x)
            g, = torch.autograd.grad(logv.sum(), x)
        return sign.detach(), logv.detach(), g

    def grad_lap(self, R, mats, e):
        """(grad (B, 3), laplacian (B,)) of log|psi| in electron e's coordinates."""
        with torch.enable_grad():
            x = R[:, e].detach().requires_grad_(True)
            _, logv = self.log_psi_moved(R, mats, e, x)
            g, = torch.autograd.grad(logv.sum(), x, create_graph=True)
            lap = sum(torch.autograd.grad(g[:, k].sum(), x, retain_graph=k < 2)[0][:, k]
                      for k in range(3))
        return g.detach(), lap.detach()

    def ratios(self, R, mats, e, x):
        """psi(e at x) / psi (B, K) at points x (B, K, 3)."""
        s0, l0 = self.log_psi_moved(R, mats, e, R[:, e])
        s1, l1 = self.log_psi_moved(R, mats, e, x)
        return s1 * s0[:, None] * torch.exp(l1 - l0[:, None])

    # --- energies ---
    def quadrature(self, epos, rot):
        """Points (B, nq, 3) and weights T (B, nq) of electrons at epos (B,
        3) on rotations rot (B, 3, 3), every nonlocal atom's in turn."""
        auxs, Ts = [], []
        for ia, nl, pts, w in self.nl_terms:
            d = self.displacement(epos - self.atoms[ia])  # (B, 3)
            r = torch.linalg.norm(d, dim=-1)
            dirs = torch.einsum("bxy,qy->bqx", rot, pts)
            auxs.append((epos - d)[:, None, :] + r[:, None, None] * dirs)
            cos = torch.einsum("bqx,bx->bq", dirs, d / r[:, None])
            T = torch.zeros_like(cos)
            for l, terms in nl.items():
                T = T + ((2 * l + 1) * radial(terms, r) * (r < self.rmax))[:, None] * legendre(l, cos)
            Ts.append(T * w)
        return self.fold(torch.cat(auxs, dim=1)), torch.cat(Ts, dim=1)

    def select(self, aux, T, u):
        """The points an electron's nonlocal energy evaluates: all of them."""
        return aux, T

    def coulomb(self, R):
        iu = torch.triu_indices(self.nelec, self.nelec, offset=1, device=self.device)
        ee = torch.sum(1.0 / torch.linalg.norm(R[:, iu[0]] - R[:, iu[1]], dim=-1), dim=-1)
        ei = -torch.sum(self.charges / torch.linalg.norm(R[:, :, None] - self.atoms, dim=-1),
                        dim=(1, 2))
        return ee, ei, torch.full_like(ee, self.e_ii)

    def ecp_local(self, R):
        out = torch.zeros(R.shape[0], dtype=self.dtype, device=self.device)
        for ia, terms in self.local_terms:
            r = torch.linalg.norm(self.displacement(R - self.atoms[ia]), dim=-1)
            out = out + torch.sum(radial(terms, r), dim=1)
        return out

    def energy(self, R, mats, rot, u_sel=None):
        """{ke, grad2, ee, ei, ii, ecp, total} (B,) each; rot (nelec, B, 3, 3);
        u_sel the downselection uniforms, which a dense quadrature has not."""
        ke = torch.zeros(R.shape[0], dtype=self.dtype, device=self.device)
        grad2 = torch.zeros_like(ke)
        nonlocal_e = torch.zeros_like(ke)
        for e in range(self.nelec):
            g, lap = self.grad_lap(R, mats, e)
            g2 = torch.sum(g * g, dim=-1)
            ke = ke - 0.5 * (lap + g2)
            grad2 = grad2 + g2
            if self.nl_terms:
                aux, T = self.select(*self.quadrature(R[:, e], rot[e]),
                                     None if u_sel is None else u_sel[e])
                nonlocal_e = nonlocal_e + torch.sum(T * self.ratios(R, mats, e, aux), dim=-1)
        ee, ei, ii = self.coulomb(R)
        ecp = self.ecp_local(R) + nonlocal_e
        return {"ke": ke, "grad2": grad2, "ee": ee, "ei": ei, "ii": ii, "ecp": ecp,
                "total": ke + ee + ei + ii + ecp}


# --- the methods ----------------------------------------------------------------

def limdrift(g, cutoff=1.0):
    norm = torch.linalg.norm(g, dim=-1, keepdim=True)
    return torch.where(norm > cutoff, g * (cutoff / norm), g)


def limdrift_umrigar(g, tau):
    v2 = torch.clamp(torch.sum(g * g, dim=-1, keepdim=True) * tau, min=1e-12)
    return g * ((torch.sqrt(1.0 + 2.0 * v2) - 1.0) / v2)


class Walkers:
    """A sample of walkers under `wf`: positions R (B, nelec, 3) and their
    orbital matrices, moved by the method's sweeps."""

    def __init__(self, wf, R):
        self.wf = wf
        self.R = R.clone()
        self.mats = wf.matrices(self.R)

    def _set(self, e, accept, newpos):
        self.R[:, e] = torch.where(accept[:, None], newpos, self.R[:, e])
        s = self.wf.spin[e]
        lo, _ = self.wf.spin_block(e)
        m = self.mats[s].clone()
        m[:, e - lo] = torch.where(accept[:, None], self.wf.orbitals(self.R[:, e], s),
                                   m[:, e - lo])
        self.mats = (m, self.mats[1]) if s == 0 else (self.mats[0], m)

    def sweep(self, gauss, unif, tstep, dmc):
        """One sweep over all electrons on gauss (nelec, B, 3), already
        scaled by sqrt(tstep), and unif (nelec, B); returns (accepted
        share summed over electrons, r2 proposed (B,), r2 accepted (B,))."""
        wf = self.wf
        acc, r2p, r2a = 0.0, 0.0, 0.0
        for e in range(wf.nelec):
            s0, l0, g0 = wf.grad_log(self.R, self.mats, e, self.R[:, e])
            d0 = limdrift_umrigar(g0, tstep) if dmc else limdrift(g0)
            newpos = wf.fold(self.R[:, e] + gauss[e] + tstep * d0)
            s1, l1, g1 = wf.grad_log(self.R, self.mats, e, newpos)
            d1 = limdrift_umrigar(g1, tstep) if dmc else limdrift(g1)
            ratio = s0 * s1 * torch.exp(l1 - l0)
            fwd = torch.sum(gauss[e] ** 2, dim=-1)
            bwd = torch.sum((gauss[e] + tstep * (d0 + d1)) ** 2, dim=-1)
            prob = ratio ** 2 * torch.exp((fwd - bwd) / (2.0 * tstep))
            if dmc:
                prob = torch.where(ratio <= 0, torch.zeros_like(prob), prob)
            accept = prob > unif[e]
            self._set(e, accept, newpos)
            acc = acc + torch.mean(accept.to(wf.dtype))
            r2 = torch.sum((gauss[e] + tstep * d0) ** 2, dim=-1)
            r2p = r2p + r2
            r2a = r2a + torch.where(accept, r2, torch.zeros_like(r2))
        return acc, r2p, r2a

    def tmoves(self, rot, u_sel, u_acc, tau):
        """Casula's size-consistent T-move sweep over all electrons: heat-bath
        choice among staying and the quadrature points with amplitudes
        max(0, -tau T_q r_q), accepted with the ratio of the forward and
        backward norms."""
        wf = self.wf
        for e in range(wf.nelec):
            aux, T = wf.quadrature(self.R[:, e], rot[e])
            r = wf.ratios(self.R, self.mats, e, aux)
            w = -tau * T
            amp = torch.clamp(w * r, min=0.0)
            norm = 1.0 + torch.sum(amp, dim=1)
            cum = torch.cumsum(torch.cat([1.0 / norm[:, None], amp / norm[:, None]], dim=1), dim=1)
            choice = torch.sum(u_sel[e][:, None] > cum, dim=1)
            move = choice > 0
            q = torch.clamp(choice - 1, 0, T.shape[1] - 1)
            r_m = torch.gather(r, 1, q[:, None])[:, 0]
            w_m = torch.gather(w, 1, q[:, None])[:, 0]
            ok = move & (torch.abs(r_m) > 1e-30)
            inv = torch.where(ok, 1.0 / r_m, torch.zeros_like(r_m))
            back = torch.clamp(w * r * inv[:, None], min=0.0)
            is_m = torch.arange(T.shape[1], device=wf.device)[None, :] == q[:, None]
            back = torch.where(is_m, torch.clamp(w_m * inv, min=0.0)[:, None], back)
            prob = torch.where(move, norm / (1.0 + torch.sum(back, dim=1)), torch.zeros_like(norm))
            accept = prob > u_acc[e]
            newpos = torch.gather(aux, 1, q[:, None, None].expand(-1, 1, 3))[:, 0]
            self._set(e, accept, newpos)

    def energy(self, rot, u_sel=None):
        return self.wf.energy(self.R, self.mats, rot, u_sel)


def branching_exponent(e_trial, e_est, esigma, eloc, grad2, tstep, nelec):
    """The DMC branching exponent: E_T - E_est plus E_est - E_L clipped at
    esigma sqrt(2 / tau), damped by sqrt(1 + (v^2 tau / nelec)^2)."""
    cut = esigma * math.sqrt(2.0 / tstep)
    return e_trial - e_est + torch.clamp(e_est - eloc, -cut, cut) / torch.sqrt(
        1.0 + (grad2 * tstep / nelec) ** 2)


def _step(streams, key, step):
    return streams[key][step] if key in streams else None


def vmc_block(wf, R, streams, tstep):
    """Follow a VMC block: per step a Metropolis sweep with capped drift.
    Returns the per-step positions."""
    walkers = Walkers(wf, R)
    positions = []
    for step in range(streams["gauss"].shape[0]):
        walkers.sweep(streams["gauss"][step], streams["unif"][step], tstep, dmc=False)
        positions.append(walkers.R.clone())
    return positions


def energies_at(wf, positions, streams, steps):
    """The local energies at each step's given positions (B, nelec, 3) on
    that step's rotations (and selection uniforms), at the steps in
    `steps`; None at the others."""
    return [Walkers(wf, R).energy(streams["rot"][k], _step(streams, "u_sel", k))
            if k in steps else None for k, R in enumerate(positions)]


def dmc_block(wf, R, weights, streams, tstep, e_trial, e_est, esigma, tmoves=True):
    """Follow a DMC block: the first local energy, then per step the
    T-move sweep, the drift-diffusion sweep with fixed-node rejection, the
    local energy and the weight update with the effective time step
    r2_accepted / r2_proposed. Returns (per-step positions, per-step
    energies, weights at the end)."""
    walkers = Walkers(wf, R)
    e0 = walkers.energy(streams["erot0"], streams.get("esel0"))
    s_old = branching_exponent(e_trial, e_est, esigma, e0["total"], e0["grad2"], tstep, wf.nelec)
    positions, energies = [], [e0]
    for step in range(streams["gauss"].shape[0]):
        if tmoves:
            walkers.tmoves(streams["tqrot"][step], streams["u_sel"][step], streams["u_acc"][step],
                           tstep)
        _, r2p, r2a = walkers.sweep(streams["gauss"][step], streams["unif"][step], tstep, dmc=True)
        edat = walkers.energy(streams["erot"][step], _step(streams, "esel", step))
        s_new = branching_exponent(e_trial, e_est, esigma, edat["total"], edat["grad2"], tstep,
                                   wf.nelec)
        weights = weights * torch.exp(tstep * (r2a / torch.clamp(r2p, min=1e-30)) * 0.5
                                      * (s_new + s_old))
        s_old = s_new
        positions.append(walkers.R.clone())
        energies.append(edat)
    return positions, energies, weights
