"""Effective-core-potential evaluation, dense quadrature (counterpart of
pyqmc_tpu/observables/ecp.py).

Semi-local pseudopotentials in pyscf format,
{el: [ncore, [[l, [slots r^0..r^6]], ...]]}, each slot a list of
[exponent, coefficient] with radial term coeff * r^(power-2) * exp(-exp r^2);
l = -1 is the local channel. The nonlocal part is integrated on a spherical
quadrature around every atom that has nonlocal channels, with one random
rotation per (walker, electron) shared by that electron's atoms.

Rotations come in as tensors (nelec, nconf, 3, 3): the VMC and DMC blocks
draw them from a torch.Generator (`rotations_from_quaternions`), and the
parity tests pass the JAX package's own draws. `tmove_quadrature` gives the
DMC T-move sweep one electron's points, weights and ratios.

Periodic cells take minimal-image electron-atom displacements. Where an
electron has more quadrature points than `nselect` (a solid: "auto" caps
them at 4 atoms' worth), `systematic_downselect` keeps the |T|-largest half
and samples the rest with one stratified uniform per (electron, walker),
`u_sel` (nelec, nconf); the selected points' ratios then go through one
flat `testvalue_aux_all` call per static chunk of electrons
(ops/ecp_energy.py:ecp_nonlocal_plain).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from ..ops import distances as _dist
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


QUADRATURE_SIZES = (6, 12, 18, 26, 32, 50)


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


def systematic_downselect(T, nselect, u):
    """Pick nselect of the nq points of each row of T (..., nq): the
    nselect // 2 largest |T| deterministically, the rest by a systematic
    scan of the normalised CDF of the remaining |T| with one uniform u (...)
    per row, importance-weighted (observables/ecp.py:217-276, with the CDF
    normalised by its own last value and zero weight for a pick of zero
    probability). Returns (idx (..., nselect) int64, wts (..., nselect))."""
    nq = T.shape[-1]
    ndet = nselect // 2
    nstoch = nselect - ndet
    absT = torch.abs(T)
    # a stable sort keeps the lowest index first among equal |T|, as
    # lax.top_k does
    topv, topi = torch.sort(absT, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :ndet], topi[..., :ndet]
    rest = absT.scatter(-1, topi, torch.zeros_like(topv))
    norm = torch.sum(rest, dim=-1, keepdim=True)
    p = rest / torch.where(norm == 0, torch.ones_like(norm), norm)
    cum = torch.cumsum(p, dim=-1)
    cum = cum / torch.clamp(cum[..., -1:], min=1e-30)
    targets = (u[..., None] + torch.arange(nstoch, dtype=T.dtype, device=T.device)) / nstoch
    sidx = torch.sum(cum[..., None, :] <= targets[..., :, None], dim=-1)
    sidx = torch.clamp(sidx, 0, nq - 1)
    pw = torch.gather(p, -1, sidx)
    any_rest = (norm > 0).to(T.dtype)
    wstoch = torch.where(pw > 0, any_rest / (nstoch * torch.clamp(pw, min=1e-30)),
                         torch.zeros_like(pw))
    return torch.cat([topi, sidx], dim=-1), torch.cat([torch.ones_like(topv), wstoch], dim=-1)


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
    """ecp(wf, params, state, positions, rot, u_sel=None) -> per-walker ECP
    energy.

    fused=True binds the hand-written CUDA kernel (ops/ecp_energy.py) for
    the nonlocal part when the wavefunction passes its gate; the kernel's
    wrapper runs the plain chain for CPU tensors. fused=False always runs
    the plain chain.

    The arguments come in the JAX package's order, (mol, naip, rmax,
    nselect, echunk, fused). naip: the angular quadrature size of every
    atom, one of 6, 12, 18, 26, 32 or 50; None picks 12 for an atom with
    more than one nonlocal channel and 6 for one with a single channel.
    nselect: quadrature points evaluated per electron; None evaluates all;
    "auto" caps them at 4 atoms' worth where an electron has more
    (observables/ecp.py:350-353). echunk: electrons per flat ratio call;
    "auto" bounds a call at 262,144 points (:660-749).
    """

    def __init__(self, mol, naip=None, rmax: float = 10.0, nselect="auto", echunk="auto",
                 fused: bool = True):
        self.atoms = parse_ecp(mol)
        # quadrature only on atoms with nonlocal channels
        self.nl_atoms = [a for a in self.atoms if a.nonlocal_channels]
        if naip is None:
            atom_naip = [12 if len(a.nonlocal_channels) > 1 else 6 for a in self.nl_atoms]
        elif naip in QUADRATURE_SIZES:
            atom_naip = [naip] * len(self.nl_atoms)
        else:
            raise ValueError(f"naip must be one of {QUADRATURE_SIZES}, got {naip!r}")
        self.atom_coords = np.asarray(mol.atom_coords)
        lattice = getattr(mol, "lattice", None)
        self._lattice = None if lattice is None else np.asarray(lattice, dtype=np.float64)
        self._mic_mode = _dist.classify_lattice(self._lattice)
        self.atom_naip = atom_naip
        self.naip = max(atom_naip, default=0)
        grids = {n: ecp_quadrature_grid(n) for n in set(atom_naip)}
        self.atom_quad = [grids[n] for n in atom_naip]
        self.nq_total = sum(atom_naip)
        self.nelec = sum(mol.nelec)
        self.rmax = rmax
        if nselect == "auto":
            cap = 4 * max(atom_naip, default=0)
            nselect = None if self.nq_total <= cap else cap
        self.nselect = nselect
        self.echunk = echunk
        self.fused = fused
        self._nonlocal_cache = {}
        self._build_quadrature_groups()
        self._build_mic()

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

    def _build_mic(self):
        """The minimal image of electron-atom displacements. On a general
        lattice rounding in fractional coordinates replaces the 27-image
        search when every ECP channel is below 1e-8 from the rounding
        cell's inradius out to rmax (observables/ecp.py:428-458)."""
        self._mic_fast = False
        self._mic_const = None
        if self._lattice is None:
            return
        inv = np.linalg.inv(self._lattice)
        self._mic_const = DeviceConstants(lat=self._lattice, lat_inv=inv,
                                          shifts=_dist._image_shifts(self._lattice))
        if self._mic_mode == _dist.MODE_GENERAL:
            r_in = 0.5 * float(np.min(1.0 / np.linalg.norm(inv, axis=0)))
            rs = np.linspace(r_in, max(self.rmax, r_in + 1e-9), 256)
            vmax = 0.0
            for a in self.atoms:
                chans = list(a.nonlocal_channels) + ([a.local] if a.local is not None else [])
                for ch in chans:
                    v = sum(c * rs ** (n - 2) * np.exp(-e * rs * rs)
                            for c, e, n in zip(ch.coeffs, ch.exps, ch.powers))
                    vmax = max(vmax, float(np.max(np.abs(v))))
            self._mic_fast = vmax < 1e-8

    def _mic(self, d):
        """Minimal-image displacement (identity for open boundaries)."""
        if self._lattice is None:
            return d
        c = self._mic_const.get(d.device, d.dtype)
        mode = _dist.MODE_ORTHORHOMBIC if self._mic_fast else self._mic_mode
        return _dist.minimal_image(d, c["lat"], c["lat_inv"], mode, c["shifts"])

    def _quadrature_geometry(self, positions, e, rot_e):
        """Aux points (c, nq, 3) and weights T (c, nq) of electron e, with
        T_q = sum_l (2l+1) v_l(r_I) P_l(cos theta_q) w_q; rot_e (c, 3, 3)."""
        return self.quadrature_geometry(positions[:, e, :], rot_e)

    def quadrature_geometry(self, epos, rot):
        """Aux points (..., nq, 3) and weights T (..., nq) of electrons at
        epos (..., 3) with their rotations rot (..., 3, 3), each sphere
        centred on the nearest image of its atom."""
        lead = epos.shape[:-1]
        auxs, Ts = [], []
        for ls, const in self._qgroups:
            c = const.get(epos.device, epos.dtype)
            dirs = torch.einsum("...xy,qy->...qx", rot, c["pts"])  # (..., q, 3)
            d = self._mic(epos[..., None, :] - c["coords"])  # (..., A, 3)
            r = torch.linalg.norm(d, dim=-1)  # (..., A)
            aux = (epos[..., None, :] - d)[..., None, :] + r[..., None, None] * dirs[..., None, :, :]
            rsafe = torch.clamp(r, min=1e-12)
            costh = torch.einsum("...qx,...ax->...aq", dirs, d / rsafe[..., None])
            inside = (r < self.rmax).to(epos.dtype)
            T = torch.zeros_like(costh)
            for l in ls:
                rr = rsafe[..., None]
                v = torch.sum(c[f"c{l}"] * rr ** (c[f"n{l}"] - 2.0)
                              * torch.exp(-c[f"e{l}"] * rr * rr), dim=-1)
                T = T + ((2 * l + 1) * v * inside)[..., None] * legendre(l, costh)
            auxs.append(aux.reshape(*lead, -1, 3))
            Ts.append((T * c["w"]).reshape(*lead, -1))
        return torch.cat(auxs, dim=-2), torch.cat(Ts, dim=-1)

    @property
    def active(self):
        """True when nonlocal channels exist: the gate of the DMC T-moves
        (a purely local ECP has no off-diagonal moves)."""
        return len(self.nl_atoms) > 0

    def _electron_quadrature(self, wf, params, state, positions, e, rot_e):
        """Dense quadrature of electron e with the wavefunction ratio at
        every point: (aux (c, nq, 3), T (c, nq), ratio (c, nq))."""
        aux, T = self._quadrature_geometry(positions, e, rot_e)
        ratio, _ = wf.testvalue(params, state, e, aux)
        return aux, T, ratio

    def tmove_quadrature(self, wf, params, state, positions, e, rot_e, tau):
        """T-move quadrature of electron e (Casula's size-consistent form):
        (aux (c, nq, 3), w (c, nq), r (c, nq)), the points, the signed
        matrix-element weights w_q = -tau T_q and the wavefunction ratios
        r_q (their real parts for a complex wavefunction), on the electron's
        rotations rot_e (c, 3, 3). Forward
        amplitudes are max(0, w_q r_q); after a move to point m the
        backward ones are max(0, w_q r_q / r_m)."""
        aux, T, ratio = self._electron_quadrature(wf, params, state, positions, e, rot_e)
        if ratio.is_complex():  # observables/ecp.py:598-611
            ratio = ratio.real
        return aux, -tau * T, ratio

    def local(self, positions):
        """Local-channel energy summed over electrons and ECP atoms (nconf,)."""
        out = torch.zeros(positions.shape[0], dtype=positions.dtype, device=positions.device)
        coords = self._local_coords.get(positions.device, positions.dtype)["coords"]
        for i, a in enumerate(self.atoms):
            r = torch.linalg.norm(self._mic(positions - coords[i][None, None, :]), dim=-1)
            out = out + torch.sum(a.local.evaluate(r), dim=1)
        return out

    def nonlocal_fn(self, wf):
        """The nonlocal-energy function bound to `wf`: the CUDA kernel's
        wrapper when `fused` and the gate passes, else the plain chain.
        Called as fn(params, positions, state, rot, u_sel=None) -> (nconf,)."""
        if id(wf) not in self._nonlocal_cache:
            from ..ops.ecp_energy import build_fused_ecp_energy, ecp_nonlocal_plain

            fn = build_fused_ecp_energy(wf, self) if self.fused else None
            if fn is None:
                def fn(params, positions, state, rot, u_sel=None):
                    return ecp_nonlocal_plain(self, wf, params, positions, state, rot, u_sel)
            self._nonlocal_cache[id(wf)] = fn
        return self._nonlocal_cache[id(wf)]

    def __call__(self, wf, params, state, positions, rot, u_sel=None, with_imag=False):
        """Per-walker ECP energy, real for any wavefunction (a complex one's
        ratios enter as Re); with_imag: (that, the imaginary part of the
        nonlocal energy), as the JAX package's with_imag."""
        local = self.local(positions)
        if not self.nl_atoms:
            return (local, torch.zeros_like(local)) if with_imag else local
        fn = self.nonlocal_fn(wf)
        if not with_imag:
            return local + fn(params, positions, state, rot, u_sel)
        from ..ops.ecp_energy import FusedECPEnergy, ecp_nonlocal_plain

        if isinstance(fn, FusedECPEnergy):  # inside K2's gate: a real wavefunction
            nl = fn(params, positions, state, rot, u_sel)
            return local + nl, torch.zeros_like(nl)
        nl, nl_im = ecp_nonlocal_plain(self, wf, params, positions, state, rot, u_sel,
                                       with_imag=True)
        return local + nl, nl_im
