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

# The parity tests run tiny tensors beside several other test processes:
# one thread each keeps them from crowding the machine's cores.
torch.set_num_threads(1)

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
    return jparams, params_from_numpy(jax.device_get(jparams), device="cpu", dtype=F64)


def walkers(rng, nconf, nelec=8, scale=1.5):
    """Walker positions near the origin (the molecule's frame), as numpy."""
    return rng.normal(scale=scale, size=(nconf, nelec, 3))


def jax_rotations(key, nelec, nconf):
    """(nelec, nconf, 3, 3) numpy: the rotations the JAX ECPAccumulator
    draws from `key` (one per electron from fold_in(key, 1000 + e))."""
    return np.stack([np.asarray(random_rotations(jax.random.fold_in(key, 1000 + e), (nconf,)))
                     for e in range(nelec)])


def port_molecule(jmol):
    """The port's Molecule of a JAX-side molecule: its basis and ECP carried
    over as plain Python data (shells as the JAX shell table holds them)."""
    from pyqmc_tpu_torch.system.mole import Molecule, Shell

    basis = {sym: [Shell(l=int(sh.l), exps=tuple(float(x) for x in sh.exps),
                         coeffs=tuple(float(c) for c in sh.coeffs)) for sh in jmol.basis[sym]]
             for sym in set(jmol.atom_symbols)}
    return Molecule(list(zip(jmol.atom_symbols, np.asarray(jmol.atom_coords))), basis=basis,
                    ecp=jmol.ecp, charge=jmol.charge, spin=jmol.spin)


@functools.lru_cache(maxsize=None)
def bc_pair():
    """The heterogeneous-naip ECP system of tests/unit/test_move_pallas.py:
    B (tpu1, two nonlocal channels, 12 points) + C (ccECP, one channel, 6
    points), so the quadrature's group order (by grid size: C first)
    differs from the atom order (B first). Slater-Jastrow with random MO
    coefficients and e-ion Jastrow coefficients, identical on both sides:
    (jax mol, jax wf, jax params, port mol, port wf, port params)."""
    from pyqmc_tpu.models.slater import DeterminantExpansion
    from pyqmc_tpu.system.basis import get_basis, get_ecp
    from pyqmc_tpu.system.mole import Molecule as JMolecule
    from pyqmc_tpu_torch.models.slater import DeterminantExpansion as TExpansion

    rng = np.random.default_rng(5)
    bas = {**get_basis("tpu1dz", ["B"]), **get_basis("ccecpccpvdz", ["C"])}
    ecp = {**get_ecp("tpu1", ["B"]), **get_ecp("ccecp", ["C"])}
    jmol = JMolecule([("B", (0, 0, 0)), ("C", (0, 0, 2.8))], basis=bas, ecp=ecp, spin=1)
    nup, ndn = jmol.nelec
    ca, cb = rng.normal(size=(jmol.nao, nup)), rng.normal(size=(jmol.nao, ndn))
    jwf = JMultiply(JSlater(jmol, None, DeterminantExpansion.single(nup, ndn), (ca, cb)),
                    JJastrow(jmol))
    jparams = jwf.make_params()
    jparams["wf1"]["acoeff"] = jnp.asarray(
        rng.normal(scale=0.1, size=jparams["wf1"]["acoeff"].shape))
    tmol = port_molecule(jmol)
    twf = TMultiply(TSlater(tmol, None, TExpansion.single(nup, ndn), (ca, cb)), TJastrow(tmol))
    tparams = params_from_numpy(jax.device_get(jparams), device="cpu", dtype=F64)
    return jmol, jwf, jparams, tmol, twf, tparams


@functools.lru_cache(maxsize=None)
def diamond_cells():
    """The diamond-C primitive cell on both sides: (jax cell, fixture
    arrays, port cell), the JAX side from tests/files, the port from its
    own copy of the file."""
    from .fixtures_pbc import load_cell

    from pyqmc_tpu_torch.system.io import load_cell_npz

    jcell, d = load_cell("diamond_primitive")
    return jcell, d, load_cell_npz()[0]


def kpoint_orbitals(nk):
    """KPointOrbitals on both sides: gamma only (nk=1) or the 8 TRIM
    k-points of the fixture, 4 occupied orbitals each per spin."""
    from pyqmc_tpu.models.orbitals import KPointOrbitals as JKOrb

    from pyqmc_tpu_torch.models.orbitals import KPointOrbitals as TKOrb

    jcell, d, tcell = diamond_cells()
    kpts = np.asarray(d["kpts"])[:nk]
    blocks = [np.asarray(d["mo_coeff"][k])[:, :4] for k in range(nk)]
    return (JKOrb(jcell, kpts, (blocks, blocks), img_tol=1e-4),
            TKOrb(tcell, kpts, (blocks, blocks), img_tol=1e-4))


@functools.lru_cache(maxsize=None)
def gamma_wf_objects():
    """Slater-Jastrow of the gamma-point primitive cell (8 electrons, 489
    replicated-shell AOs, default periodic Jastrow basis) on both sides:
    (jax wf, port wf)."""
    from pyqmc_tpu.models.slater import DeterminantExpansion
    from pyqmc_tpu.wftools import default_jastrow_basis as j_basis

    from pyqmc_tpu_torch.models.slater import DeterminantExpansion as TExpansion
    from pyqmc_tpu_torch.wftools import default_jastrow_basis

    jcell, _, tcell = diamond_cells()
    jorb, torb = kpoint_orbitals(1)
    ja, jb = j_basis(jcell)
    ta, tb = default_jastrow_basis(tcell)
    jwf = JMultiply(JSlater(jcell, jorb, DeterminantExpansion.single(4, 4)),
                    JJastrow(jcell, a_basis=ja, b_basis=jb))
    twf = TMultiply(TSlater(tcell, orbitals=torb, expansion=TExpansion.single(4, 4)),
                    TJastrow(tcell, a_basis=ta, b_basis=tb))
    return jwf, twf


@functools.lru_cache(maxsize=None)
def gamma_jax_recompute():
    """jit of the JAX gamma wavefunction's recompute, shared by the tests
    (one compile per walker count)."""
    return jax.jit(gamma_wf_objects()[0].recompute)


def gamma_params(rng):
    """Identical parameters of gamma_wf_objects() with perturbed Jastrow
    coefficients: (jax params, port params)."""
    jwf, _ = gamma_wf_objects()
    jparams = jwf.make_params()
    jparams["wf1"]["acoeff"] = jnp.asarray(rng.normal(scale=0.1, size=jparams["wf1"]["acoeff"].shape))
    jparams["wf1"]["bcoeff"] = jparams["wf1"]["bcoeff"] + jnp.asarray(
        rng.normal(scale=0.05, size=jparams["wf1"]["bcoeff"].shape))
    return jparams, params_from_numpy(jax.device_get(jparams), device="cpu", dtype=F64)


def compile_quick(jitted, *args):
    """A jitted JAX function lowered for `args` and compiled with XLA's
    backend optimisation off: the same program, compiled in less time, for
    a test that runs it once. Call the result with the same args."""
    return jitted.lower(*args).compile(compiler_options={"xla_backend_optimization_level": 0})


def cell_walkers(rng, lattice, nconf, nelec=8, lo=-0.3, hi=1.3):
    """Positions (nconf, nelec, 3) at fractional coordinates in [lo, hi),
    so some lie outside the cell and exercise the folds."""
    return rng.uniform(lo, hi, size=(nconf, nelec, 3)) @ np.asarray(lattice)


def jax_ecp_streams(key, nelec, nconf):
    """The ECP draws of the JAX ECPAccumulator from `key`, as numpy:
    rotations (nelec, nconf, 3, 3) from fold_in(key, 1000 + e) and the
    downselection uniforms (nelec, nconf) from fold_in(fold_in(key, 1000 +
    e), 777)."""
    rot, u = jax_ecp_draws(key, nelec, nconf)
    return np.array(rot), np.array(u)


@functools.partial(jax.jit, static_argnums=(1, 2))
def jax_ecp_draws(key, nelec, nconf):
    keys = jax.vmap(lambda e: jax.random.fold_in(key, 1000 + e))(jnp.arange(nelec))
    rot = jax.vmap(lambda k: random_rotations(k, (nconf,)))(keys)
    u = jax.vmap(lambda k: jax.random.uniform(jax.random.fold_in(k, 777), (nconf, 1),
                                              jnp.float64)[:, 0])(keys)
    return rot, u


_COMPILED = {}


def jrun(tag, fn, *args):
    """The JAX side's fn(*args), traced and compiled once per tag with the
    backend optimisation off (compile_quick): a JAX function called eagerly
    compiles each of its operations apart, which takes ten times as long.
    Each tag is called with arguments of one structure and shape."""
    if tag not in _COMPILED:
        _COMPILED[tag] = compile_quick(jax.jit(fn), *args)
    return _COMPILED[tag](*args)
