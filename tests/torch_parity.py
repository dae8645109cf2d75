"""Shared set-up of the parity tests between pyqmc_tpu (JAX, the reference)
and pyqmc_tpu_torch (the PyTorch port).

Both sides get the same inputs, made with numpy from a seed: the JAX side
runs in float64 (tests/conftest.py enables x64), the port in torch.float64.
Data crosses between them only as numpy arrays.
"""

from __future__ import annotations

import functools
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import torch

from pyqmc_tpu.models.jastrow import JastrowSpin as JJastrow
from pyqmc_tpu.models.multiply import MultiplyWF as JMultiply
from pyqmc_tpu.models.slater import Slater as JSlater
from pyqmc_tpu.observables.ecp import random_rotations
from pyqmc_tpu.system.io import load_system

from pyqmc_tpu_torch.convert import params_from_numpy
from pyqmc_tpu_torch.models.jastrow import JastrowSpin as TJastrow
from pyqmc_tpu_torch.models.multiply import MultiplyWF as TMultiply
from pyqmc_tpu_torch.models.slater import Slater as TSlater
from pyqmc_tpu_torch.system.io import load_npz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H2O_HDF5 = os.path.join(ROOT, "benchmarks", "h2o_ccecp-ccpvdz_ccecp_scf.hdf5")
F64 = torch.float64


@functools.lru_cache(maxsize=None)
def h2o_pair():
    """((jax mol, jax mf), (port mol, port mf)) of the ccECP/cc-pVDZ H2O
    checkpoint: the JAX side from the HDF5, the port from its npz."""
    with h5py.File(H2O_HDF5, "r") as f:
        jm = load_system(f)
    return jm, load_npz()


def to_np(tree):
    """Leaves of a JAX or torch tree as numpy arrays (flattened list)."""
    if isinstance(tree, torch.Tensor):
        return [tree.detach().cpu().numpy()]
    if isinstance(tree, (tuple, list)):
        return [a for t in tree for a in to_np(t)]
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in to_np(tree[k])]
    return [np.asarray(tree)]


def assert_trees_close(a, b, atol, rtol=0.0):
    la, lb = to_np(a), to_np(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_allclose(x, y, atol=atol, rtol=rtol)


@functools.lru_cache(maxsize=None)
def h2o_wf_objects():
    """The main-path wavefunction MultiplyWF(Slater.from_mean_field,
    JastrowSpin) on both sides: (jax wf, port wf). Built once per process,
    so jitted JAX functions of it compile once."""
    (jmol, jmf), (tmol, tmf) = h2o_pair()
    return (JMultiply(JSlater.from_mean_field(jmf), JJastrow(jmol)),
            TMultiply(TSlater.from_mean_field(tmf), TJastrow(tmol)))


def h2o_params(rng, random_jastrow=True):
    """Identical parameters on both sides: (jax params, port params). The
    default Jastrow has acoeff = 0; random_jastrow perturbs acoeff and
    bcoeff so the e-ion terms are exercised (as
    tests/unit/test_move_pallas.py does)."""
    jwf, _ = h2o_wf_objects()
    jparams = jwf.make_params()
    if random_jastrow:
        jparams["wf1"]["acoeff"] = jnp.asarray(
            rng.normal(scale=0.1, size=jparams["wf1"]["acoeff"].shape))
        jparams["wf1"]["bcoeff"] = jparams["wf1"]["bcoeff"] + jnp.asarray(
            rng.normal(scale=0.05, size=jparams["wf1"]["bcoeff"].shape))
    return jparams, params_from_numpy(jax.device_get(jparams), dtype=F64)


def walkers(rng, nconf, nelec=8, scale=1.5):
    """Walker positions near the origin (the molecule's frame), as numpy."""
    return rng.normal(scale=scale, size=(nconf, nelec, 3))


def jax_rotations(key, nelec, nconf):
    """(nelec, nconf, 3, 3) numpy: the rotations the JAX ECPAccumulator
    draws from `key` (one per electron from fold_in(key, 1000 + e))."""
    return np.stack([np.asarray(random_rotations(jax.random.fold_in(key, 1000 + e), (nconf,)))
                     for e in range(nelec)])
