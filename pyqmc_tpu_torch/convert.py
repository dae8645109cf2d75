"""Parameters and states carried across from the JAX package.

The JAX side hands over numpy: `jax.device_get(tree)` or `np.asarray` on
each leaf. Layouts are the JAX package's at every function here, so a
MultiplyWF(Slater, JastrowSpin) parameter tree
{"wf0": {det_coeff, mo_coeff_alpha, mo_coeff_beta}, "wf1": {acoeff
(natom, na, 2), bcoeff (nb, 3)}} keeps its keys and shapes.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.jastrow import JastrowState
from .models.slater import SlaterState


def _t(x, device, dtype):
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def params_from_numpy(tree, device="cpu", dtype=torch.float64):
    """Nested dict of arrays -> the same nesting of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    return _t(tree, device, dtype)


def params_to_numpy(tree):
    """Inverse of params_from_numpy."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def slater_state_from_numpy(st, device="cpu", dtype=torch.float64) -> SlaterState:
    """A JAX SlaterState (fields as numpy arrays) -> the port's SlaterState."""
    return SlaterState(*(_t(getattr(st, f), device, dtype) for f in SlaterState._fields))


def jastrow_state_from_numpy(st, device="cpu", dtype=torch.float64) -> JastrowState:
    return JastrowState(*(_t(getattr(st, f), device, dtype) for f in JastrowState._fields))
