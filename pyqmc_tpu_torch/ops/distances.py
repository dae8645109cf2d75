"""Minimal-image displacements (counterpart of pyqmc_tpu/ops/distances.py).

The strategy is picked on the host from the numpy lattice, as the JAX
package does: a diagonal lattice rounds per cartesian axis, an orthogonal
(rotated) one rounds in fractional coordinates, a general one folds by
rounding and then searches the 27 neighbouring images.
"""

import numpy as np
import torch

MODE_OPEN = "open"
MODE_DIAGONAL = "diagonal"
MODE_ORTHORHOMBIC = "orthorhombic"
MODE_GENERAL = "general"


def classify_lattice(lattice) -> str:
    """The cheapest correct minimal-image strategy for a lattice."""
    if lattice is None:
        return MODE_OPEN
    lattice = np.asarray(lattice)
    if np.allclose(lattice, np.diag(np.diagonal(lattice))):
        return MODE_DIAGONAL
    ortho = lattice @ lattice.T
    if np.allclose(ortho, np.diag(np.diagonal(ortho))):
        return MODE_ORTHORHOMBIC
    return MODE_GENERAL


def _image_shifts(lattice) -> np.ndarray:
    """(27, 3) cartesian translations of the 3x3x3 image block."""
    span = np.array([-1.0, 0.0, 1.0])
    pts = np.array(np.meshgrid(span, span, span, indexing="ij")).reshape(3, -1).T
    return pts @ np.asarray(lattice)


def minimal_image(d, lattice, lattice_inv, mode: str, shifts=None):
    """Map displacements d (..., 3) to their minimal image; lattice,
    lattice_inv (and shifts (27, 3) in the general mode, made from the
    lattice when None) are tensors on d's device and dtype."""
    if mode == MODE_OPEN:
        return d
    frac = d @ lattice_inv
    base = (frac - torch.round(frac)) @ lattice
    if mode in (MODE_DIAGONAL, MODE_ORTHORHOMBIC):
        return base
    if shifts is None:
        shifts = torch.as_tensor(_image_shifts(lattice.detach().cpu().numpy()),
                                 dtype=d.dtype, device=d.device)
    cand = base[..., None, :] + shifts  # (..., 27, 3)
    idx = torch.argmin(torch.sum(cand * cand, dim=-1), dim=-1)
    return torch.take_along_dim(cand, idx[..., None, None], dim=-2)[..., 0, :]


def pair_displacements(pos_a, pos_b, lattice=None, lattice_inv=None, mode=MODE_OPEN,
                       shifts=None):
    """Minimal-image displacements pos_b - pos_a of broadcastable (..., 3)
    tensors."""
    return minimal_image(pos_b - pos_a, lattice, lattice_inv, mode, shifts)


def dist_matrix(positions, lattice=None, lattice_inv=None, mode=MODE_OPEN, shifts=None):
    """All-pairs minimal-image displacements r_j - r_i (..., n, n, 3) of
    positions (..., n, 3), dense with a zero diagonal."""
    d = positions[..., None, :, :] - positions[..., :, None, :]
    return minimal_image(d, lattice, lattice_inv, mode, shifts)


def dist_i(positions, epos, lattice=None, lattice_inv=None, mode=MODE_OPEN, shifts=None):
    """Minimal-image displacements epos - r_j (..., n, 3) from every row of
    positions (..., n, 3) to epos (..., 3)."""
    return minimal_image(epos[..., None, :] - positions, lattice, lattice_inv, mode, shifts)
