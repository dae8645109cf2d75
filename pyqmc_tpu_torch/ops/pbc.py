"""Periodic wrap (counterpart of pyqmc_tpu/ops/pbc.py:13-28)."""

import torch


def enforce_pbc(lattice, lattice_inv, epos):
    """Fold epos (..., 3) into the cell spanned by the rows of `lattice`.

    Returns (wrapped, wrap): wrap (..., 3) int32 is the number of cell
    translations removed along each lattice vector."""
    frac = epos @ lattice_inv
    wrap = torch.floor(frac)
    return (frac - wrap) @ lattice, wrap.to(torch.int32)
