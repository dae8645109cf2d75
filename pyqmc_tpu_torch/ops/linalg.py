"""Determinant linear algebra (counterpart of pyqmc_tpu/ops/linalg.py).

The JAX package carries a hand-written batched Gauss-Jordan
(`_lu_slogdet_inv`) only because XLA:TPU's LU is slow for tiny blocks and
lacks complex support; `torch.linalg` has neither problem, so the port calls
it directly.
"""

import torch


def slogdet_inv(a):
    """(phase, logabsdet, inverse) of batched square matrices a (..., n, n),
    real or complex: the phase is +-1 or of unit modulus, log|det| real."""
    n = a.shape[-1]
    if n == 0:
        shape = a.shape[:-2]
        return (torch.ones(shape, dtype=a.dtype, device=a.device),
                torch.zeros(shape, dtype=a.abs().dtype, device=a.device), torch.zeros_like(a))
    phase, logabs = torch.linalg.slogdet(a)
    # inv_ex: no error check, so no device-to-host sync on the GPU
    return phase, logabs, torch.linalg.inv_ex(a)[0]


def sherman_morrison_row(inv, new_row, row_idx: int):
    """Rank-1 update of an inverse after replacing row `row_idx` of A.

    inv (..., n, n) with inv @ A = I; new_row (..., n). Returns
    (ratio = det(A_new)/det(A) (...,), new_inv).
    """
    t = torch.einsum("...k,...kj->...j", new_row, inv)
    ratio = t[..., row_idx]
    col = inv[..., :, row_idx]
    inv_new = inv - torch.einsum("...i,...j->...ij", col, t) / ratio[..., None, None]
    inv_new[..., :, row_idx] = col / ratio[..., None]
    return ratio, inv_new
