"""How K2's wrapper hands its inputs to csrc/ecp_energy.cu, checked on the
CPU (the kernel itself runs only on the card: tests/test_torch_kernels_cuda.py
and chip_smoke.py hold it against its plain version there).

- `FusedECPEnergy.pack` passes positions, both inverses and the rotations
  where they lie, with their strides: no copy, also for the walker rows
  that the sweep kernels leave behind (views into one packed buffer);
- its arguments match the `extern "C"` entry point in count and kind;
- the Python mirror of the kernel's shared-memory layout (`block_shared`)
  keeps the source's constants and fits a block for ccECP H2O and for the
  6 + 4 electron system of the NMAX = 16 instance, in both dtypes.
"""

import functools
import os
import re

import numpy as np
import pytest
import torch

from pyqmc_tpu_torch.entry import h2o_setup
from pyqmc_tpu_torch.ops import _build, ecp_energy

F64 = torch.float64
CSRC = os.path.join(os.path.dirname(ecp_energy.__file__), "..", "csrc")


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


@functools.lru_cache(maxsize=None)
def _h2o(nconf):
    _, wf, params, configs, acc = h2o_setup(nconf, device="cpu", dtype=F64, seed=3)
    fn = ecp_energy.build_fused_ecp_energy(wf, acc["energy"].ecp_acc)
    assert isinstance(fn, ecp_energy.FusedECPEnergy)
    return fn, wf, params, configs.positions


@functools.lru_cache(maxsize=None)
def _nmax16():
    """H2O with two more electrons (6 up, 4 down), the card-only file's
    NMAX = 16 system."""
    from pyqmc_tpu_torch.models.jastrow import JastrowSpin
    from pyqmc_tpu_torch.models.multiply import MultiplyWF
    from pyqmc_tpu_torch.models.slater import DeterminantExpansion, Slater
    from pyqmc_tpu_torch.observables.ecp import ECPAccumulator
    from pyqmc_tpu_torch.system.io import load_npz
    from pyqmc_tpu_torch.system.mole import Molecule

    mol, mf = load_npz()
    mol = Molecule(mol.atom_symbols, mol.atom_coords, mol.basis, ecp=mol.ecp, charge=-2, spin=2)
    wf = MultiplyWF(Slater(mol, None, DeterminantExpansion.single(6, 4),
                           (mf.mo_coeff[0][:, :6], mf.mo_coeff[1][:, :4])), JastrowSpin(mol))
    fn = ecp_energy.build_fused_ecp_energy(wf, ECPAccumulator(mol))
    assert fn is not None
    return fn


def _rot(nelec, nconf):
    rng = np.random.default_rng(7)
    q, _ = np.linalg.qr(rng.normal(size=(nelec, nconf, 3, 3)))
    return torch.as_tensor(q, dtype=F64)


def test_pack_passes_inputs_where_they_lie():
    """The caller's tensors themselves (equal data_ptr), their strides in
    the arguments: dense positions and rotations, the inverses as
    `recompute` leaves them, then every walker input as a row view of one
    packed buffer, as the sweep kernels' unpack leaves them."""
    nconf = 5
    fn, wf, params, pos = _h2o(nconf)
    state = wf.recompute(params, pos)
    rot = _rot(8, nconf)
    sl = state[0]
    name, out, held, args = fn.pack(params, pos, state, rot)
    assert name == "pq_ecp_energy" and out.shape == (nconf,)
    for t, src in zip(held[:4], (pos, sl.inv_up, sl.inv_dn, rot)):
        assert t.data_ptr() == src.data_ptr()
    assert args[:2] == (pos.data_ptr(), 24)
    assert args[2:6] == (sl.inv_up.data_ptr(), sl.inv_up.stride(0), *sl.inv_up.stride()[2:])

    buf = torch.cat([pos.reshape(nconf, -1), sl.inv_up.reshape(nconf, -1),
                     sl.inv_dn.reshape(nconf, -1), torch.zeros(nconf, 3, dtype=F64)], dim=1)
    rows = buf.shape[1]
    pos_v = buf[:, :24].reshape(nconf, 8, 3)
    inv_v = [buf[:, 24 + 16 * s: 40 + 16 * s].reshape(nconf, 1, 4, 4) for s in (0, 1)]
    state_v = (sl._replace(inv_up=inv_v[0], inv_dn=inv_v[1]), state[1])
    assert not pos_v.is_contiguous() and not inv_v[0].is_contiguous()
    _, _, held, args = fn.pack(params, pos_v, state_v, rot)
    for t, src in zip(held[:3], (pos_v, *inv_v)):
        assert t.data_ptr() == src.data_ptr()
    assert args[1] == rows and args[3:6] == (rows, 4, 1) and args[7:10] == (rows, 4, 1)


def test_pack_arguments_match_the_c_entry():
    """len(args) + the stream = the parameters of pq_ecp_energy_f32 and
    _f64, each a pointer where the C entry takes one and an int where it
    takes an int, as _build's argtypes say."""
    fn, wf, params, pos = _h2o(3)
    _, _, _, args = fn.pack(params, pos, wf.recompute(params, pos), _rot(8, 3))
    src = _source("ecp_energy.cu")
    argtypes = _build._KERNELS["pq_ecp_energy"][1]
    for suffix in ("_f32", "_f64"):
        sig = re.search(r"int pq_ecp_energy%s\(([^)]*)\)" % suffix, src).group(1)
        params_c = [p.strip() for p in sig.split(",")]
        assert len(params_c) == len(args) + 1 == len(argtypes)
        for p, t in zip(params_c, argtypes):
            assert t is (_build._P if "*" in p else _build._I), p
    assert all(isinstance(a, int) for a in args)


def test_layout_mirror_keeps_the_source_constants():
    src = _source("ecp_energy.cu")
    assert int(re.search(r"constexpr int LANES = (\d+);", src).group(1)) == ecp_energy.LANES
    lg = _source("lane_group.cuh")
    assert int(re.search(r"constexpr int THREADS = (\d+);", lg).group(1)) == ecp_energy.THREADS
    assert "227 * 1024" in lg


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("system", ["h2o", "nmax16"])
def test_shared_memory_fits_a_block(system, dtype):
    """Every walker of a full block (128 / LANES) fits the 227 KB a block
    may hold, so no shape of the main path or the NMAX = 16 check raises."""
    fn = _h2o(3)[0] if system == "h2o" else _nmax16()
    itemsize = torch.empty((), dtype=dtype).element_size()
    walkers, nbytes = ecp_energy.block_shared(fn.tables, itemsize)
    assert walkers == ecp_energy.THREADS // ecp_energy.LANES
    assert nbytes <= ecp_energy.MAX_BLOCK_SHARED
