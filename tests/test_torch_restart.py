"""Checkpoint and restart of the port's VMC, DMC and optimizer (the counterparts of JAX
tests/integration/test_restart.py and tests/unit/test_guards.py:87-168), on
He/STO-3G, float64, CPU:

- VMC continued on its file numbers its blocks on: [0..5];
- DMC resumed from its checkpoint runs blocks 0..7, e_trial carried on
  from the saved one (the window's e_est seeded with it);
- a line minimization stopped after 2 iterations and resumed to 4 runs
  iterations [2, 3] only, and its parameter vectors and energies equal the
  uninterrupted run's (each iteration's generator is folded from the seed
  and the iteration);
- the guards: a wrong walker count, a VMC output or an optimization file
  given to DMC raise; an empty file starts afresh; VMC's continue_from
  refuses to overwrite; a file of another wavefunction's parameters
  raises;
- across the packages: a DMC checkpoint written by the JAX package
  (tests/files/torch_io/dmc.h5) is resumed by the port from exactly its
  walkers, weights, e_trial, e_est and esigma;
- the same restart from the contents in a dict (`checkpoint=`), as on a
  machine without h5py.
"""

import functools
import os
import shutil

import h5py
import numpy as np
import pytest
import torch

from pyqmc_tpu_torch.configs import initial_guess
from pyqmc_tpu_torch.method.dmc import make_dmc_block, read_checkpoint, rundmc
from pyqmc_tpu_torch.method.linemin import line_minimization
from pyqmc_tpu_torch.method.vmc import fold_generator, vmc
from pyqmc_tpu_torch.models.jastrow import JastrowSpin
from pyqmc_tpu_torch.models.multiply import MultiplyWF
from pyqmc_tpu_torch.models.slater import Slater
from pyqmc_tpu_torch.observables.accumulators import EnergyAccumulator
from pyqmc_tpu_torch.observables.transform import LinearTransform
from pyqmc_tpu_torch.system.mole import Molecule
from pyqmc_tpu_torch.system.scf import run_scf

from .torch_parity import ROOT

FIXTURES = os.path.join(ROOT, "tests", "files", "torch_io")


@functools.lru_cache(maxsize=None)
def he():
    mol = Molecule("He 0 0 0", basis="sto-3g")
    wf = Slater.from_mean_field(run_scf(mol))
    return mol, wf, wf.make_params("cpu"), EnergyAccumulator(mol)


def configs(nconf, seed):
    return initial_guess(he()[0], nconf, generator=torch.Generator().manual_seed(seed),
                         device="cpu")


def gen(seed):
    return torch.Generator().manual_seed(seed)


def test_vmc_continue(tmp_path):
    mol, wf, params, energy = he()
    f = str(tmp_path / "vmc.h5")
    kw = dict(nblocks=3, nsteps_per_block=5, accumulators={"energy": energy}, hdf_file=f)
    vmc(wf, params, configs(60, 0), generator=gen(1), **kw)
    data, _ = vmc(wf, params, configs(60, 0), generator=gen(1), **kw)
    assert [d["block"] for d in data] == [3, 4, 5]
    with h5py.File(f, "r") as h:
        assert list(np.asarray(h["block"])) == [0, 1, 2, 3, 4, 5]


def _dmc(cfg, seed, **kw):
    mol, wf, params, energy = he()
    return rundmc(wf, params, cfg, nsteps_per_block=5, tstep=0.02, energy_acc=energy,
                  generator=gen(seed), warmup_vmc_blocks=2, **kw)


def _carried_on(first, resumed):
    """The resumed run's first block continues the first run's last: its
    window starts from the saved e_est, so e_est = (saved + E) / 2, and
    e_trial = e_est - log(mean weight)."""
    b = resumed[0]
    assert b["block"] == first[-1]["block"] + 1
    e_est = 0.5 * (first[-1]["e_est"] + b["energytotal"])
    np.testing.assert_allclose(b["e_est"], e_est, rtol=1e-12)
    np.testing.assert_allclose(b["e_trial"], e_est - np.log(b["weight"]), rtol=1e-12)


def test_dmc_restart(tmp_path):
    f = str(tmp_path / "dmc.h5")
    d1, _, _ = _dmc(configs(80, 2), 3, nblocks=4, hdf_file=f)
    d2, _, _ = _dmc(configs(80, 2), 3, nblocks=4, hdf_file=f)
    with h5py.File(f, "r") as h:
        assert list(np.asarray(h["block"])) == list(range(8))
        et = np.asarray(h["e_trial"])
        assert np.all(np.isfinite(et)) and len(et) == 8
    assert np.all(np.isfinite([d["energytotal"] for d in d2]))
    _carried_on(d1, d2)


def test_dmc_restart_from_dict():
    """checkpoint=: the same restart from contents held in a dict, the
    walkers and weights those of the first run's end."""
    ckpt = {}
    d1, c1, w1 = _dmc(configs(40, 2), 3, nblocks=2, checkpoint=ckpt)
    assert ckpt["block"] == 1 and torch.equal(ckpt["weights"], w1)
    assert torch.equal(ckpt["configs"].positions, c1.positions)
    d2, _, _ = _dmc(configs(40, 2), 3, nblocks=2, checkpoint=ckpt)
    assert [d["block"] for d in d2] == [2, 3] and ckpt["block"] == 3
    _carried_on(d1, d2)


def _he_sj():
    mol, slater, _, energy = he()
    wf = MultiplyWF(slater, JastrowSpin(mol))
    params = wf.make_params("cpu")
    return wf, params, LinearTransform(params, {"wf0": False, "wf1": True}), energy


def test_linemin_restart(tmp_path):
    """A run stopped after 2 iterations and resumed to 4 executes
    iterations 2 and 3 only, on the trajectory of the uninterrupted run."""
    wf, params, lt, energy = _he_sj()
    f1, f2 = str(tmp_path / "split.h5"), str(tmp_path / "full.h5")
    kws = dict(vmc_blocks=4, vmc_steps_per_block=5)
    line_minimization(wf, params, configs(100, 4), lt, energy, generator=gen(5),
                      max_iterations=2, hdf_file=f1, **kws)
    _, _, rec = line_minimization(wf, params, configs(100, 4), lt, energy, generator=gen(5),
                                  max_iterations=4, hdf_file=f1, **kws)
    assert [r["iteration"] for r in rec] == [2, 3]
    _, _, rec_full = line_minimization(wf, params, configs(100, 4), lt, energy,
                                       generator=gen(5), max_iterations=4, hdf_file=f2, **kws)
    with h5py.File(f1, "r") as a, h5py.File(f2, "r") as b:
        assert len(a["energy"]) == len(b["energy"]) == 4
        np.testing.assert_allclose(np.asarray(a["x"]), np.asarray(b["x"]), rtol=1e-10,
                                   atol=1e-12)
        np.testing.assert_allclose(np.asarray(a["energy"]), np.asarray(b["energy"]),
                                   rtol=1e-10)
    np.testing.assert_allclose([r["energy"] for r in rec], [r["energy"] for r in rec_full[2:]],
                               rtol=1e-10)
    # the same from a dict
    ckpt = {}
    line_minimization(wf, params, configs(100, 4), lt, energy, generator=gen(5),
                      max_iterations=2, checkpoint=ckpt, **kws)
    p, _, rec = line_minimization(wf, params, configs(100, 4), lt, energy, generator=gen(5),
                                  max_iterations=4, checkpoint=ckpt, **kws)
    assert [r["iteration"] for r in rec] == [2, 3] and ckpt["iterations"] == 4
    with h5py.File(f2, "r") as b:
        np.testing.assert_allclose(lt.serialize(p).numpy(), b["x"][-1], rtol=1e-10, atol=1e-12)
    # a file of another wavefunction's parameters
    with h5py.File(str(tmp_path / "other.h5"), "w") as h:
        h.create_dataset("x", data=np.zeros((1, lt.nparams + 1)))
    with pytest.raises(ValueError, match="different wavefunction"):
        line_minimization(wf, params, configs(100, 4), lt, energy, generator=gen(5),
                          max_iterations=2, hdf_file=str(tmp_path / "other.h5"), **kws)


@pytest.fixture(scope="module")
def vmc_file(tmp_path_factory):
    mol, wf, params, energy = he()
    f = str(tmp_path_factory.mktemp("ckpt") / "vmc.h5")
    vmc(wf, params, configs(64, 0), nblocks=2, nsteps_per_block=3,
        accumulators={"energy": energy}, generator=gen(1), hdf_file=f)
    return f


def test_vmc_resume_wrong_nconfig_raises(vmc_file):
    mol, wf, params, energy = he()
    with pytest.raises(ValueError, match="walker shape"):
        vmc(wf, params, configs(48, 2), nblocks=1, nsteps_per_block=3,
            accumulators={"energy": energy}, generator=gen(3), hdf_file=vmc_file)


def test_vmc_continue_from_forks(vmc_file, tmp_path):
    """continue_from takes another run's walkers, numbers blocks from 0
    and refuses to overwrite an existing output."""
    mol, wf, params, energy = he()
    out = str(tmp_path / "fork.h5")
    kw = dict(nsteps_per_block=3, accumulators={"energy": energy}, hdf_file=out,
              continue_from=vmc_file)
    vmc(wf, params, configs(64, 4), nblocks=2, generator=gen(5), **kw)
    with h5py.File(out, "r") as h:
        assert list(np.asarray(h["block"])) == [0, 1]
    with pytest.raises(ValueError, match="refusing to overwrite"):
        vmc(wf, params, configs(64, 4), nblocks=1, generator=gen(5), **kw)


def test_dmc_restart_wrong_nconfig_raises(tmp_path):
    f = str(tmp_path / "dmc.h5")
    _dmc(configs(64, 6), 7, nblocks=2, hdf_file=f)
    with pytest.raises(ValueError, match="walker shape"):
        _dmc(configs(48, 8), 9, nblocks=1, hdf_file=f)


def test_dmc_restart_on_vmc_file_raises(vmc_file):
    with pytest.raises(ValueError, match="not a DMC checkpoint"):
        _dmc(configs(64, 10), 11, nblocks=1, hdf_file=vmc_file)


def test_dmc_restart_on_opt_file_raises(tmp_path):
    f = str(tmp_path / "opt.h5")
    with h5py.File(f, "w") as h:
        h.create_dataset("x", data=np.zeros((3, 7)))
        h.create_dataset("energy", data=np.zeros(3))
    with pytest.raises(ValueError, match="not a DMC checkpoint"):
        _dmc(configs(64, 12), 13, nblocks=1, hdf_file=f)


def test_dmc_restart_empty_file_starts_fresh(tmp_path):
    f = str(tmp_path / "empty.h5")
    with h5py.File(f, "w"):
        pass
    data, _, _ = _dmc(configs(64, 14), 15, nblocks=1, hdf_file=f)
    assert np.isfinite(data[0]["energytotal"]) and data[0]["block"] == 0
    with h5py.File(f, "r") as h:
        assert "weights" in h and "configs" in h and h.attrs["esigma"] > 0


def test_dmc_resumes_a_jax_checkpoint(tmp_path):
    """The JAX package's DMC checkpoint resumed by the port: the first
    block is the block that its walkers, weights, e_trial, e_est and
    esigma give, drawn from the generator folded at block 3."""
    mol, wf, params, energy = he()
    f = str(tmp_path / "dmc.h5")
    shutil.copy(os.path.join(FIXTURES, "dmc.h5"), f)
    saved = read_checkpoint(f)
    data, _, _ = _dmc(configs(8, 0), 16, nblocks=1, hdf_file=f)
    assert data[0]["block"] == saved["block"] + 1 == 3
    block, _ = make_dmc_block(wf, energy, configs(8, 0).geometry, 0.02, 5)
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float64)
    pos, wrap, weights, avg = block(params, t(saved["configs"]["positions"]),
                                    torch.as_tensor(saved["configs"]["wrap"], dtype=torch.int32),
                                    t(saved["weights"]), fold_generator(gen(16), 3),
                                    t(saved["e_trial"]), t(saved["e_est"]), t(saved["esigma"]))
    for k in ("energytotal", "weight", "acceptance"):
        assert data[0][k] == float(avg[k]), k
    np.testing.assert_allclose(data[0]["e_est"], 0.5 * (saved["e_est"] + float(avg["energytotal"])),
                               rtol=1e-12)
