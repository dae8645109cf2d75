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
from .utils.dtypes import real_dtype, resolve_device


def _t(x, device, dtype):
    device = resolve_device(device)
    return torch.tensor(np.asarray(x), dtype=dtype or real_dtype(device), device=device)


def params_from_numpy(tree, device=None, dtype=None):
    """Nested dicts, lists and tuples of arrays (the k-point orbitals keep a
    list over k) -> the same nesting of tensors, on the GPU unless `device`
    says otherwise (utils/dtypes.resolve_device)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device, dtype) for v in tree)
    return _t(tree, device, dtype)


def params_to_numpy(tree):
    """Inverse of params_from_numpy."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v) for v in tree)
    return tree.detach().cpu().numpy()


def slater_state_from_numpy(st, device=None, dtype=None) -> SlaterState:
    """A JAX SlaterState (fields as numpy arrays) -> the port's SlaterState;
    the same fields serve molecular and periodic (k-point) orbitals."""
    return SlaterState(*(_t(getattr(st, f), device, dtype) for f in SlaterState._fields))


def jastrow_state_from_numpy(st, device=None, dtype=None) -> JastrowState:
    return JastrowState(*(_t(getattr(st, f), device, dtype) for f in JastrowState._fields))


def wrap_from_numpy(wrap, device=None) -> torch.Tensor:
    """Integer wrap counts (nconf, nelec, 3) of periodic walkers, as int32."""
    return torch.tensor(np.asarray(wrap), dtype=torch.int32, device=resolve_device(device))


def dmc_streams_from_numpy(streams, device=None, dtype=None):
    """One DMC block's random streams (method/dmc.py: gauss, unif, erot,
    erot0, tqrot, u_sel, u_acc, and u_branch for the comb) from numpy
    arrays, so that the port consumes the numbers another implementation
    drew."""
    return {k: _t(v, device, dtype) for k, v in streams.items()}
