"""Parameters and states carried across from the JAX package.

The JAX side hands over numpy: `jax.device_get(tree)` or `np.asarray` on
each leaf. Layouts are the JAX package's at every function here, so a
MultiplyWF(Slater, JastrowSpin) parameter tree
{"wf0": {det_coeff (ndet,), mo_coeff_alpha (nao, norb_up), mo_coeff_beta},
"wf1": {acoeff (natom, na, 2), bcoeff (nb, 3)}} keeps its keys and shapes,
for any determinant expansion: the CASCI(8e,8o) H2O expansion's det_coeff
is (1098,) and its state's inv_up (nconf, 70, 4, 4). The other factors'
leaves, the same on both sides:

  ThreeBodyJastrow  {"ccoeff": (natom, na, na, nb, 3)}, C[I, k, l, m, ch]
                    before its (k, l) symmetrization
  GeminalJastrow    {"gcoeff": (nao, nao)} (the primitive cell's AOs on a
                    cell), before its symmetrization
  GPSJastrow        {"alpha": (s,), "f": 0-d, "Xsupport": (s, 2, 3)}
  AddWF             {"coeff": (nwf,), "wf0": .., "wf1": ..}, each wfN its
                    component's tree

so generate_wf(mol, mf, jastrow3=True)'s tree is {"wf0": Slater's, "wf1":
JastrowSpin's, "wf2": {"ccoeff"}}.

Complex leaves (the k-point mo_coeff lists of a general twist, complex
molecular coefficients, a complex det_coeff) and complex state fields (a
complex Slater's inverses and phases) become complex tensors of the
requested precision: complex64 beside float32, complex128 beside float64.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.slater import SlaterState
from .utils.dtypes import complex_dtype, real_dtype, resolve_device


def _t(x, device, dtype):
    """x as a tensor: `dtype` (default real_dtype(device)), or its complex
    counterpart for a complex array."""
    device = resolve_device(device)
    x = np.asarray(x)
    dtype = dtype or real_dtype(device)
    if np.iscomplexobj(x):
        dtype = complex_dtype(dtype)
    return torch.tensor(x, dtype=dtype, device=device)


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
    """A JAX SlaterState (fields as numpy arrays) -> the port's SlaterState,
    every unique spin-determinant's inverse, phase and log|det| included;
    the same fields serve molecular and periodic (k-point) orbitals."""
    return SlaterState(*(_t(getattr(st, f), device, dtype) for f in SlaterState._fields))


def state_from_numpy(cls, st, device=None, dtype=None):
    """A JAX factor's state (a NamedTuple whose fields are numpy arrays) ->
    the port's state class `cls` with the same fields: JastrowState,
    Jastrow3State (positions, u) or GenericJastrowState (positions, u, phi,
    ssum) of a geminal or GPS Jastrow."""
    return cls(*(_t(getattr(st, f), device, dtype) for f in cls._fields))


def wrap_from_numpy(wrap, device=None) -> torch.Tensor:
    """Integer wrap counts (nconf, nelec, 3) of periodic walkers, as int32."""
    return torch.tensor(np.asarray(wrap), dtype=torch.int32, device=resolve_device(device))


def dmc_streams_from_numpy(streams, device=None, dtype=None):
    """One DMC block's random streams (method/dmc.py: gauss, unif, erot,
    erot0, tqrot, u_sel, u_acc, esel and esel0 where the ECP downselects,
    and u_branch for the comb) from numpy
    arrays, so that the port consumes the numbers another implementation
    drew."""
    return {k: _t(v, device, dtype) for k, v in streams.items()}
