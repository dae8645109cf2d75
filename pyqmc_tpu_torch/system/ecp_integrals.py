"""Numerical ECP matrix elements for the SCF front end (counterpart of
pyqmc_tpu/system/ecp_integrals.py).

    V[mu,nu] = <chi_mu | V_loc + sum_l v_l(r) sum_m |Y_lm><Y_lm| | chi_nu>

on an atom-centred product grid: Gauss-Legendre radial x Gauss-Legendre
(cos theta) x uniform phi angular. Accuracy ~1e-8 Ha for standard ccECP
gaussian-type channels. Host work in float64: the grid's AOs come from the
port's ops/gto.eval_gto on CPU tensors and the channels from its
observables/ecp.parse_ecp, so it never looks for a GPU.
"""

import numpy as np
import torch
from numpy.polynomial.legendre import leggauss

from ..observables.ecp import parse_ecp
from ..ops.gto import GTOSpec, eval_gto
from ..ops.harmonics import cart2sph_matrix, cart_components


def _real_sph(l, unit):
    """Real spherical harmonics Y_lm at unit vectors (n, 3) -> (n, 2l+1)."""
    mono = np.stack([unit[:, 0] ** i * unit[:, 1] ** j * unit[:, 2] ** k
                     for (i, j, k) in cart_components(l)], axis=-1)
    return mono @ cart2sph_matrix(l)


def _angular_grid(ntheta=20, nphi=40):
    x, wx = leggauss(ntheta)  # cos(theta) nodes
    phi = (np.arange(nphi) + 0.5) * (2 * np.pi / nphi)
    wphi = 2 * np.pi / nphi
    ct, ph = np.meshgrid(x, phi, indexing="ij")
    st = np.sqrt(1 - ct**2)
    pts = np.stack([st * np.cos(ph), st * np.sin(ph), ct], axis=-1).reshape(-1, 3)
    w = (wx[:, None] * wphi * np.ones(nphi)[None, :]).reshape(-1)
    return pts, w  # integrates to 4 pi


def _channel(ch, r):
    return ch.evaluate(torch.as_tensor(r, dtype=torch.float64)).numpy()


def ecp_matrix(mol, nrad=80, rmax=10.0, ntheta=20, nphi=40):
    """(nao, nao) ECP potential matrix over spherical AOs."""
    spec = GTOSpec.from_molecule(mol)
    atoms = parse_ecp(mol)
    nao = mol.nao
    V = np.zeros((nao, nao))
    if not atoms:
        return V

    # radial grid: Gauss-Legendre in t over [0,1] mapped r = rmax * t^2 —
    # clusters points near the origin where ccECP channels (r^-1 e^{-a r^2})
    # concentrate; a uniform grid loses ~0.04 Ha on Li.
    xt, wt = leggauss(nrad)
    t = 0.5 * (xt + 1.0)
    r = rmax * t * t
    wr = 0.5 * wt * 2.0 * rmax * t
    ang, wang = _angular_grid(ntheta, nphi)  # (nang, 3), (nang,)
    nang = len(wang)

    for aecp in atoms:
        R = mol.atom_coords[aecp.atom]
        pts = R[None, None, :] + r[:, None, None] * ang[None, :, :]  # (nrad, nang, 3)
        ao = eval_gto(spec, torch.as_tensor(pts.reshape(-1, 3), dtype=torch.float64),
                      mode=0).numpy().reshape(nrad, nang, nao)
        # local part: integral chi_mu V_loc chi_nu over the full grid
        wfull = (wr * _channel(aecp.local, r) * r * r)[:, None] * wang[None, :]
        V += np.einsum("rga,rg,rgb->ab", ao, wfull, ao, optimize=True)
        # nonlocal: A_lm,mu(r) = int dOmega Y_lm chi_mu
        for ch in aecp.nonlocal_channels:
            Y = _real_sph(ch.l, ang)  # (nang, 2l+1)
            A = np.einsum("gm,g,rga->rma", Y, wang, ao, optimize=True)
            V += np.einsum("r,rma,rmb->ab", wr * _channel(ch, r) * r * r, A, A, optimize=True)
    return 0.5 * (V + V.T)
