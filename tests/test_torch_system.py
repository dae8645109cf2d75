"""The port's system record, package boundary and parameter bridge.

- The committed `.npz` reproduces the HDF5 checkpoint it was converted from
  (exactly: the conversion copies the arrays), and `convert_hdf5_to_npz`
  rebuilds it.
- `import pyqmc_tpu_torch`, `from pyqmc_tpu_torch.api import ...` and all
  its modules leave jax out of sys.modules (checked in a fresh
  interpreter).
- params_from_numpy / params_to_numpy round-trip the JAX parameter tree.
"""

import os
import subprocess
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import torch

from pyqmc_tpu.ops.gto import GTOSpec as JSpec
from pyqmc_tpu.system.io import load_system

from pyqmc_tpu_torch.convert import (params_from_numpy, params_to_numpy,
                                     slater_state_from_numpy, state_from_numpy)
from pyqmc_tpu_torch.models.jastrow import JastrowState
from pyqmc_tpu_torch.ops.gto import GTOSpec as TSpec
from pyqmc_tpu_torch.system.io import H2O_CCECP, convert_hdf5_to_npz, load_npz

from .torch_parity import H2O_HDF5, ROOT, h2o_pair, h2o_wf_objects


def test_npz_reproduces_hdf5_checkpoint():
    (jmol, jmf), (tmol, tmf) = h2o_pair()
    assert tmol.nao == jmol.nao == 23
    assert tmol.nelec == jmol.nelec == (4, 4)
    assert tmol.atom_symbols == jmol.atom_symbols
    np.testing.assert_array_equal(tmol.atom_coords, jmol.atom_coords)
    np.testing.assert_array_equal(tmol.atom_charges, jmol.atom_charges)
    assert len(tmol.shells) == len(jmol.shells)
    for ts, js in zip(tmol.shells, jmol.shells):
        assert (ts.atom, ts.l, ts.ao_offset) == (js.atom, js.l, js.ao_offset)
        np.testing.assert_array_equal(ts.exps, js.exps)
        np.testing.assert_array_equal(ts.coeffs, js.coeffs)
    np.testing.assert_array_equal(TSpec.from_molecule(tmol).perm, JSpec.from_molecule(jmol).perm)
    assert tmol.ecp == jmol.ecp
    for s in range(2):
        np.testing.assert_array_equal(tmf.mo_coeff[s], jmf.mo_coeff[s])
    assert tmf.e_tot == jmf.e_tot
    assert tmol.nuclear_repulsion() == jmol.nuclear_repulsion()


def test_converter_rebuilds_npz(tmp_path):
    out = str(tmp_path / "h2o.npz")
    convert_hdf5_to_npz(H2O_HDF5, out)
    with np.load(out, allow_pickle=False) as a, np.load(H2O_CCECP, allow_pickle=False) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    mol, mf = load_npz(out)
    assert mol.nao == 23 and mf.mo_coeff[0].shape == (23, 23)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import pyqmc_tpu_torch\n"
        "from pyqmc_tpu_torch.api import Molecule, run_scf, OPTIMIZE, VMC, DMC\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'pyqmc_tpu.')))\n"
        "assert not bad, bad\n"
        "for m in pkgutil.walk_packages(pyqmc_tpu_torch.__path__, 'pyqmc_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'pyqmc_tpu.')))\n"
        "assert not bad, bad\n"
        "for m in ('method.dmc', 'method.extrapolate', 'reblock', 'ops.tmove_sweep',\n"
        "          'ops.move_sweep_pbc', 'ops.gto_kernels', 'ops.distances', 'ops.pbc',\n"
        "          'observables.ewald', 'system.supercell', 'wftools', 'method.twist_average',\n"
        "          'api', 'recipes', 'system.elements', 'system.basis', 'system.tpu1_library',\n"
        "          'system.integrals', 'system.ecp_integrals', 'system.scf', 'system.casci',\n"
        "          'system.ci_import', 'system.chkfile', 'system.pyscf_adapter',\n"
        "          'method.hdftools', 'utils.profiling', 'parallel.mesh',\n"
        "          'observables.ewald2d', 'system.basis_fit', 'system.ecp_generate'):\n"
        "    assert 'pyqmc_tpu_torch.' + m in sys.modules, m\n"
        "assert 'h5py' not in sys.modules\n"
        "print(len([k for k in sys.modules if k.startswith('pyqmc_tpu_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20  # every module was imported


def test_params_round_trip():
    jwf, twf = h2o_wf_objects()
    jp = jax.device_get(jwf.make_params())
    tp = params_from_numpy(jp, device="cpu", dtype=torch.float64)
    assert set(tp) == {"wf0", "wf1"}
    assert set(tp["wf0"]) == {"det_coeff", "mo_coeff_alpha", "mo_coeff_beta"}
    assert tp["wf1"]["acoeff"].shape == (3, 4, 2) and tp["wf1"]["bcoeff"].shape == (4, 3)
    back = params_to_numpy(tp)
    for k in jp:
        for kk in jp[k]:
            np.testing.assert_array_equal(back[k][kk], np.asarray(jp[k][kk]))
    # the port's own defaults equal the JAX package's
    own = params_to_numpy(twf.make_params(device="cpu"))
    for k in jp:
        for kk in jp[k]:
            np.testing.assert_array_equal(own[k][kk], np.asarray(jp[k][kk]))


def test_states_from_jax():
    """A JAX-computed Slater and Jastrow state, carried across, equals the
    port's own recompute (1e-10, absolute and relative: float64 both
    sides, inverse entries up to O(100))."""
    jwf, twf = h2o_wf_objects()
    jp = jwf.make_params()
    pos = np.random.default_rng(81).normal(scale=1.5, size=(4, 8, 3))
    js = jax.device_get(jax.jit(jwf.recompute)(jp, jnp.asarray(pos)))
    carried = (slater_state_from_numpy(js[0], device="cpu"),
               state_from_numpy(JastrowState, js[1], device="cpu"))
    own = twf.recompute(twf.make_params(device="cpu"), torch.as_tensor(pos, dtype=torch.float64))
    for a, b in zip(carried[0] + carried[1], own[0] + own[1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-10, rtol=1e-10)
