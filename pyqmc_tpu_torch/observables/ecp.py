"""Effective-core-potential evaluation, dense quadrature (counterpart of
pyqmc_tpu/observables/ecp.py).

Semi-local pseudopotentials in pyscf format,
{el: [ncore, [[l, [slots r^0..r^6]], ...]]}, each slot a list of
[exponent, coefficient] with radial term coeff * r^(power-2) * exp(-exp r^2);
l = -1 is the local channel. The nonlocal part is integrated on a spherical
quadrature around every atom that has nonlocal channels, with one random
rotation per (walker, electron) shared by that electron's atoms.

Rotations come in as tensors (nelec, nconf, 3, 3): the VMC block draws them
from a torch.Generator (`rotations_from_quaternions`), and the parity tests
pass the JAX package's own draws. The downselected and flat paths of the
JAX package are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from ..utils.constants import DeviceConstants


# --- quadrature grids ------------------------------------------------------

def _octa_classes():
    verts = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
                     dtype=np.float64)
    edges = []
    for i in (-1.0, 1.0):
        for j in (-1.0, 1.0):
            edges += [[i, j, 0], [i, 0, j], [0, i, j]]
    edges = np.asarray(edges) / np.sqrt(2.0)
    faces = np.asarray([[i, j, k] for i in (-1.0, 1.0) for j in (-1.0, 1.0)
                        for k in (-1.0, 1.0)]) / np.sqrt(3.0)
    return verts, edges, faces


def _ico_classes():
    from itertools import combinations

    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = []
    for a in (-1.0, 1.0):
        for b in (-phi, phi):
            verts += [[0, a, b], [a, b, 0], [b, 0, a]]
    verts = np.asarray(verts)
    verts = verts / np.linalg.norm(verts, axis=1, keepdims=True)
    nn = verts @ verts.T > 0.4
    faces = []
    for i, j, k in combinations(range(12), 3):
        if nn[i, j] and nn[j, k] and nn[i, k]:
            c = verts[i] + verts[j] + verts[k]
            c = c / np.linalg.norm(c)
            if not any(np.allclose(c, f, atol=1e-9) for f in faces):
                faces.append(c)
    return verts, np.asarray(faces)


def ecp_quadrature_grid(naip: int):
    """(points (naip, 3), weights (naip,)) for naip in {6, 12, 18, 26, 32,
    50}, exact through degree 3/5/5/7/9/11."""
    verts, edges, faces = _octa_classes()
    if naip == 6:
        return verts, np.full(6, 1.0 / 6.0)
    if naip == 18:
        return (np.concatenate([verts, edges]),
                np.concatenate([np.full(6, 1.0 / 30.0), np.full(12, 1.0 / 15.0)]))
    if naip == 26:
        return (np.concatenate([verts, edges, faces]),
                np.concatenate([np.full(6, 40.0 / 840.0), np.full(12, 32.0 / 840.0),
                                np.full(8, 27.0 / 840.0)]))
    if naip == 50:
        p, q = 1.0 / np.sqrt(11.0), 3.0 / np.sqrt(11.0)
        cls4 = np.asarray([v for s1 in (-1.0, 1.0) for s2 in (-1.0, 1.0) for s3 in (-1.0, 1.0)
                           for v in ([s1 * p, s2 * p, s3 * q], [s1 * p, s2 * q, s3 * p],
                                     [s1 * q, s2 * p, s3 * p])])
        return (np.concatenate([verts, edges, faces, cls4]),
                np.concatenate([np.full(6, 4.0 / 315.0), np.full(12, 64.0 / 2835.0),
                                np.full(8, 27.0 / 1280.0), np.full(24, 14641.0 / 725760.0)]))
    iverts, ifaces = _ico_classes()
    if naip == 12:
        return iverts, np.full(12, 1.0 / 12.0)
    if naip == 32:
        return (np.concatenate([iverts, ifaces]),
                np.concatenate([np.full(12, 25.0 / 840.0), np.full(20, 27.0 / 840.0)]))
    raise ValueError(f"naip must be one of 6/12/18/26/32/50, got {naip}")


def rotations_from_quaternions(q):
    """Uniform random rotations (..., 3, 3) from normal quaternions q (..., 4)
    (the algebra of the JAX package's random_rotations)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return R.reshape(q.shape[:-1] + (3, 3))


def legendre(l, x):
    """P_l(x) for l <= 6."""
    if l == 0:
        return torch.ones_like(x)
    if l == 1:
        return x
    if l == 2:
        return 0.5 * (3 * x * x - 1)
    if l == 3:
        return 0.5 * (5 * x**3 - 3 * x)
    if l == 4:
        return 0.125 * (35 * x**4 - 30 * x**2 + 3)
    if l == 5:
        return 0.125 * (63 * x**5 - 70 * x**3 + 15 * x)
    if l == 6:
        return 0.0625 * (231 * x**6 - 315 * x**4 + 105 * x**2 - 5)
    raise ValueError(f"l={l} not supported")


# --- radial channels --------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Channel:
    l: int  # -1 = local
    coeffs: Tuple[float, ...]
    exps: Tuple[float, ...]
    powers: Tuple[int, ...]  # r^(power-2)

    def evaluate(self, r):
        out = torch.zeros_like(r)
        for c, e, n in zip(self.coeffs, self.exps, self.powers):
            out = out + c * r ** (n - 2) * torch.exp(-e * r * r)
        return out


@dataclasses.dataclass(frozen=True)
class AtomECP:
    atom: int
    local: Channel
    nonlocal_channels: Tuple[Channel, ...]


def parse_ecp(mol) -> List[AtomECP]:
    out = []
    for ia, sym in enumerate(mol.atom_symbols):
        if sym not in mol.ecp:
            continue
        _, channels = mol.ecp[sym]
        local, nl = None, []
        for l, slots in channels:
            coeffs, exps, powers = [], [], []
            for power, terms in enumerate(slots):
                for e, c in terms:
                    coeffs.append(c)
                    exps.append(e)
                    powers.append(power)
            ch = Channel(l, tuple(coeffs), tuple(exps), tuple(powers))
            if l == -1:
                local = ch
            else:
                nl.append(ch)
        out.append(AtomECP(ia, local, tuple(sorted(nl, key=lambda c: c.l))))
    return out


class ECPAccumulator:
    """ecp(wf, params, state, positions, rot) -> per-walker ECP energy.

    fused=True binds the hand-written CUDA kernel (ops/ecp_energy.py) for
    the nonlocal part when the wavefunction passes its gate; the kernel's
    wrapper runs the plain chain for CPU tensors. fused=False always runs
    the plain chain.
    """

    def __init__(self, mol, rmax: float = 10.0, fused: bool = True):
        self.atoms = parse_ecp(mol)
        # quadrature only on atoms with nonlocal channels; per-atom grid
        # size 12 for a multi-channel ECP, 6 for a single channel (the JAX
        # package's default; its naip override is not ported)
        self.nl_atoms = [a for a in self.atoms if a.nonlocal_channels]
        atom_naip = [12 if len(a.nonlocal_channels) > 1 else 6 for a in self.nl_atoms]
        self.atom_coords = np.asarray(mol.atom_coords)
        self.atom_naip = atom_naip
        grids = {n: ecp_quadrature_grid(n) for n in set(atom_naip)}
        self.atom_quad = [grids[n] for n in atom_naip]
        self.nq_total = sum(atom_naip)
        self.nelec = sum(mol.nelec)
        self.rmax = rmax
        self.fused = fused
        self._nonlocal_cache = {}
        self._build_quadrature_groups()

    def _build_quadrature_groups(self):
        """Per-naip atom groups (sorted by naip) with padded radial tables:
        (channel ls, constants coords/pts/w and c{l}/e{l}/n{l} (A, nterm))."""
        groups = []
        for n in sorted(set(self.atom_naip)):
            atoms = [self.nl_atoms[i] for i, m in enumerate(self.atom_naip) if m == n]
            coords = np.asarray([self.atom_coords[a.atom] for a in atoms])
            ls = sorted({ch.l for a in atoms for ch in a.nonlocal_channels})
            ntm = max((len(ch.coeffs) for a in atoms for ch in a.nonlocal_channels), default=1)
            tables = {}
            for l in ls:
                c_t = np.zeros((len(atoms), ntm))
                e_t = np.ones((len(atoms), ntm))
                n_t = np.full((len(atoms), ntm), 2)
                for ai, a in enumerate(atoms):
                    for ch in a.nonlocal_channels:
                        if ch.l == l:
                            m = len(ch.coeffs)
                            c_t[ai, :m] = ch.coeffs
                            e_t[ai, :m] = ch.exps
                            n_t[ai, :m] = ch.powers
                tables[l] = (c_t, e_t, n_t)
            pts, w = ecp_quadrature_grid(n)
            groups.append((sorted(tables), DeviceConstants(
                coords=coords, pts=pts, w=w,
                **{f"{name}{l}": t for l, tab in tables.items()
                   for name, t in zip("cen", (tab[0], tab[1], tab[2].astype(np.float64)))})))
        self._qgroups = groups
        self._local_coords = DeviceConstants(
            coords=np.asarray([self.atom_coords[a.atom] for a in self.atoms]).reshape(-1, 3))

    def _quadrature_geometry(self, positions, e, rot_e):
        """Aux points (c, nq, 3) and weights T (c, nq) of electron e, with
        T_q = sum_l (2l+1) v_l(r_I) P_l(cos theta_q) w_q; rot_e (c, 3, 3)."""
        nconf = positions.shape[0]
        epos = positions[:, e, :]
        auxs, Ts = [], []
        for ls, const in self._qgroups:
            c = const.get(positions.device, positions.dtype)
            dirs = torch.einsum("cxy,qy->cqx", rot_e, c["pts"])  # (c, q, 3)
            d = epos[:, None, :] - c["coords"][None]  # (c, A, 3)
            r = torch.linalg.norm(d, dim=-1)  # (c, A)
            aux = (epos[:, None, :] - d)[:, :, None, :] + r[:, :, None, None] * dirs[:, None]
            rsafe = torch.clamp(r, min=1e-12)
            costh = torch.einsum("cqx,cax->caq", dirs, d / rsafe[..., None])
            inside = (r < self.rmax).to(positions.dtype)
            T = torch.zeros_like(costh)
            for l in ls:
                rr = rsafe[..., None]
                v = torch.sum(c[f"c{l}"] * rr ** (c[f"n{l}"] - 2.0)
                              * torch.exp(-c[f"e{l}"] * rr * rr), dim=-1)
                T = T + ((2 * l + 1) * v * inside)[..., None] * legendre(l, costh)
            auxs.append(aux.reshape(nconf, -1, 3))
            Ts.append((T * c["w"][None, None, :]).reshape(nconf, -1))
        return torch.cat(auxs, dim=1), torch.cat(Ts, dim=1)

    def local(self, positions):
        """Local-channel energy summed over electrons and ECP atoms (nconf,)."""
        out = torch.zeros(positions.shape[0], dtype=positions.dtype, device=positions.device)
        coords = self._local_coords.get(positions.device, positions.dtype)["coords"]
        for i, a in enumerate(self.atoms):
            r = torch.linalg.norm(positions - coords[i][None, None, :], dim=-1)
            out = out + torch.sum(a.local.evaluate(r), dim=1)
        return out

    def nonlocal_fn(self, wf):
        """The nonlocal-energy function bound to `wf`: the CUDA kernel's
        wrapper when `fused` and the gate passes, else the plain chain.
        Called as fn(params, positions, state, rot) -> (nconf,)."""
        if id(wf) not in self._nonlocal_cache:
            from ..ops.ecp_energy import build_fused_ecp_energy, ecp_nonlocal_plain

            fn = build_fused_ecp_energy(wf, self) if self.fused else None
            if fn is None:
                def fn(params, positions, state, rot):
                    return ecp_nonlocal_plain(self, wf, params, positions, state, rot)
            self._nonlocal_cache[id(wf)] = fn
        return self._nonlocal_cache[id(wf)]

    def __call__(self, wf, params, state, positions, rot):
        local = self.local(positions)
        if not self.nl_atoms:
            return local
        return local + self.nonlocal_fn(wf)(params, positions, state, rot)
