"""The port's files against the JAX package's: every file kind that either
package writes is read by the other, with the same dataset names, shapes,
kinds and attributes, and values equal to 1e-12 (float64, CPU).

- system checkpoints (system/io.py save_system, load_system): a molecule
  with its SCF and a periodic cell, both directions;
- wavefunction parameters (wftools.py save_wf_params, read_wf_params),
  real and complex, both directions;
- the methods' outputs: a VMC output with an array-valued observable
  (S(q)), a DMC checkpoint, a line minimization's file and an ensemble
  optimization's file. The JAX package's files are its methods' own output
  (tests/files/torch_io, written by tools/torch_io_jax_fixtures.py); the
  port's are written here on the same systems and schedules and read with
  the JAX package's readers (Configs.from_hdf, read_mc_output, read_opt);
- read_mc_output on weighted DMC output and array-valued observables
  (JAX tests/unit/test_observables.py's two cases), against the JAX
  package's;
- the package without h5py: it imports and runs a VMC block, and asking
  for a file raises an ImportError naming h5py.
"""

import functools
import os
import shutil
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

from pyqmc_tpu import recipes as jrecipes
from pyqmc_tpu import wftools as jwftools
from pyqmc_tpu.configs import Configs as JConfigs
from pyqmc_tpu.system import io as jio

from pyqmc_tpu_torch import recipes
from pyqmc_tpu_torch import wftools
from pyqmc_tpu_torch.configs import Configs, initial_guess
from pyqmc_tpu_torch.method import dmc, ensemble, linemin
from pyqmc_tpu_torch.method.vmc import vmc
from pyqmc_tpu_torch.models.jastrow import JastrowSpin
from pyqmc_tpu_torch.models.multiply import MultiplyWF
from pyqmc_tpu_torch.models.slater import DeterminantExpansion, Slater
from pyqmc_tpu_torch.observables.accumulators import EnergyAccumulator
from pyqmc_tpu_torch.observables.sq import SqAccumulator
from pyqmc_tpu_torch.observables.transform import LinearTransform
from pyqmc_tpu_torch.system import io
from pyqmc_tpu_torch.system.mole import Molecule
from pyqmc_tpu_torch.system.scf import run_scf

from .torch_parity import F64, ROOT, diamond_cells, h2o_pair, h2o_params, to_np

FIXTURES = os.path.join(ROOT, "tests", "files", "torch_io")
NCONF = 8  # the fixtures' walkers
SQ_QLIST = np.array([[1.0, 0.0, 0.0], [0.0, 2.0, 0.0]])


def layout(path):
    """{dataset path: (shape, dtype kind)} and the root's attribute names."""
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, (obj.shape, obj.dtype.kind))
                     if isinstance(obj, h5py.Dataset) else None)
        return out, sorted(f.attrs)


def assert_same_layout(port_path, jax_path):
    assert layout(port_path) == layout(jax_path)


def assert_summaries_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-12, atol=1e-12, err_msg=k)


@functools.lru_cache(maxsize=None)
def he():
    """The port's He/STO-3G: (mol, Slater)."""
    mol = Molecule("He 0 0 0", basis="sto-3g")
    return mol, Slater.from_mean_field(run_scf(mol))


def he_configs(seed=0):
    return initial_guess(he()[0], NCONF, generator=torch.Generator().manual_seed(seed),
                         device="cpu")


# --- system checkpoints -----------------------------------------------------------

def _same_system(a, b):
    assert list(a.atom_symbols) == list(b.atom_symbols)
    np.testing.assert_allclose(a.atom_coords, b.atom_coords, rtol=0, atol=1e-12)
    assert (a.charge, a.spin, tuple(a.nelec), a.nao) == (b.charge, b.spin, tuple(b.nelec), b.nao)
    assert json_ecp(a.ecp) == json_ecp(b.ecp)
    for el in a.basis:
        assert len(a.basis[el]) == len(b.basis[el])
        for s, t in zip(a.basis[el], b.basis[el]):
            assert s.l == t.l
            np.testing.assert_allclose(s.exps, t.exps, rtol=1e-12)
            np.testing.assert_allclose(s.coeffs, t.coeffs, rtol=1e-12)
    if a.lattice is None:
        assert b.lattice is None
    else:
        np.testing.assert_allclose(a.lattice, b.lattice, rtol=0, atol=1e-12)


def json_ecp(ecp):
    import json

    return json.loads(json.dumps(ecp or {}))


def _same_mf(a, b):
    for name in ("mo_coeff", "mo_energy", "mo_occ"):
        for x, y in zip(getattr(a, name), getattr(b, name)):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-12)
    assert abs(a.e_tot - b.e_tot) < 1e-12 and a.restricted == b.restricted


@pytest.mark.parametrize("kind", ["molecule", "cell"])
def test_system_files(kind, tmp_path):
    """save_system of each package read by the other's load_system: the same
    Molecule or Cell (atoms, basis, ECP, charge, spin, lattice) and
    MeanField, and the same file layout."""
    if kind == "molecule":
        (jmol, jmf), (tmol, tmf) = h2o_pair()
    else:
        jmol, _, tmol = diamond_cells()
        jmf = tmf = None
    jpath, tpath = str(tmp_path / "jax.h5"), str(tmp_path / "port.h5")
    with h5py.File(jpath, "w") as f:
        jio.save_system(f, jmol, jmf)
    with h5py.File(tpath, "w") as f:
        io.save_system(f, tmol, tmf)
    assert_same_layout(tpath, jpath)
    with h5py.File(jpath, "r") as f:
        pmol, pmf = io.load_system(f)
    with h5py.File(tpath, "r") as f:
        qmol, qmf = jio.load_system(f)
    assert type(pmol).__name__ == type(tmol).__name__ and type(qmol).__name__ == type(
        jmol).__name__
    for a, b in ((pmol, tmol), (qmol, jmol), (pmol, jmol)):
        _same_system(a, b)
    if jmf is None:
        assert pmf is None and qmf is None
    else:
        _same_mf(pmf, jmf)
        _same_mf(qmf, tmf)


# --- wavefunction parameters -------------------------------------------------------

@pytest.mark.parametrize("kind", ["real", "complex"])
def test_wf_params_files(kind, tmp_path):
    """save_wf_params of each package read by the other's read_wf_params
    (the H2O Slater x Jastrow; complex: mo_coeff times i plus noise), the
    same datasets; the port's reader casts to its template's precision."""
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    jparams, tparams = h2o_params(rng)
    if kind == "complex":
        for name in ("mo_coeff_alpha", "mo_coeff_beta"):
            c = np.asarray(jparams["wf0"][name])
            c = c * 1j + rng.uniform(-0.1, 0.1, size=c.shape)
            jparams["wf0"][name] = jnp.asarray(c)
            tparams["wf0"][name] = torch.as_tensor(c)
    jpath, tpath = str(tmp_path / "jax.h5"), str(tmp_path / "port.h5")
    with h5py.File(jpath, "w") as f:
        jwftools.save_wf_params(f.require_group("wf"), jparams)
    with h5py.File(tpath, "w") as f:
        wftools.save_wf_params(f.require_group("wf"), tparams)
    assert_same_layout(tpath, jpath)
    with h5py.File(jpath, "r") as f:
        got = wftools.read_wf_params(f["wf"], tparams)
        # a real float32 template: complex leaves where the file's are complex
        got32 = wftools.read_wf_params(f["wf"], {g: {k: v.real.float() for k, v in d.items()}
                                                 for g, d in tparams.items()})
    with h5py.File(tpath, "r") as f:
        back = jwftools.read_wf_params(f["wf"], jparams)
    for a, b in zip(to_np(got), to_np(jparams)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(to_np(back), to_np(tparams)):
        np.testing.assert_array_equal(a, b)
    expect = torch.complex64 if kind == "complex" else torch.float32
    assert got32["wf0"]["mo_coeff_alpha"].dtype == expect
    assert got32["wf1"]["acoeff"].dtype == torch.float32


# --- the methods' outputs ---------------------------------------------------------------

def test_vmc_output(tmp_path):
    """The JAX package's VMC output (energy and S(q) per block, walkers)
    read by the port, and the port's, written on the same schedule, read by
    the JAX package: the same layout, walkers and reblocked summaries."""
    jpath = os.path.join(FIXTURES, "vmc.h5")
    with h5py.File(jpath, "r") as f:
        cfg = Configs.from_hdf(f["configs"], device="cpu")
        np.testing.assert_array_equal(cfg.positions.numpy(), np.asarray(f["configs/positions"]))
        assert cfg.positions.dtype == F64 and cfg.wrap.dtype == torch.int32
        assert not cfg.geometry.periodic
    assert_summaries_equal(recipes.read_mc_output(jpath, warmup=0, reblocks=2),
                           jrecipes.read_mc_output(jpath, warmup=0, reblocks=2))

    mol, wf = he()
    sq = SqAccumulator(qlist=SQ_QLIST)
    sq.nup = mol.nelec[0]
    tpath = str(tmp_path / "vmc.h5")
    data, final = vmc(wf, wf.make_params("cpu"), he_configs(), nblocks=2, nsteps_per_block=2,
                      accumulators={"energy": EnergyAccumulator(mol), "sq": sq},
                      generator=torch.Generator().manual_seed(1), hdf_file=tpath)
    assert_same_layout(tpath, jpath)
    with h5py.File(tpath, "r") as f:
        jcfg = JConfigs.from_hdf(f["configs"])
        np.testing.assert_array_equal(np.asarray(jcfg.positions), final.positions.numpy())
        for k in ("energytotal", "sqSq", "acceptance"):
            np.testing.assert_array_equal(np.asarray(f[k]), np.stack([d[k] for d in data]))
    assert_summaries_equal(recipes.read_mc_output(tpath, warmup=0, reblocks=2),
                           jrecipes.read_mc_output(tpath, warmup=0, reblocks=2))


def test_dmc_checkpoint(tmp_path):
    """The JAX package's DMC checkpoint read by the port (read_checkpoint:
    walkers, weights, the last e_trial, e_est, block and esigma), and the
    port's, written on the same schedule, read by the JAX package's
    readers: the same layout and attributes."""
    jpath = os.path.join(FIXTURES, "dmc.h5")
    got = dmc.read_checkpoint(jpath)
    with h5py.File(jpath, "r") as f:
        np.testing.assert_array_equal(got["configs"]["positions"], f["configs/positions"][...])
        np.testing.assert_array_equal(got["weights"], f["weights"][...])
        assert got["e_trial"] == f["e_trial"][-1] and got["e_est"] == f["e_est"][-1]
        assert got["block"] == f["block"][-1] == 2 and got["esigma"] == f.attrs["esigma"]
    mol, wf = he()
    tpath = str(tmp_path / "dmc.h5")
    data, final, weights = dmc.rundmc(
        wf, wf.make_params("cpu"), he_configs(), nblocks=3, nsteps_per_block=2,
        energy_acc=EnergyAccumulator(mol), generator=torch.Generator().manual_seed(2),
        warmup_vmc_blocks=1, hdf_file=tpath)
    assert_same_layout(tpath, jpath)
    with h5py.File(tpath, "r") as f:
        np.testing.assert_array_equal(np.asarray(JConfigs.from_hdf(f["configs"]).positions),
                                      final.positions.numpy())
        np.testing.assert_array_equal(f["weights"][...], weights.numpy())
        np.testing.assert_array_equal(f["e_trial"][...], [d["e_trial"] for d in data])
    assert_summaries_equal(recipes.read_mc_output(tpath, warmup=0, reblocks=2),
                           jrecipes.read_mc_output(tpath, warmup=0, reblocks=2))


def he_sj():
    mol, slater = he()
    wf = MultiplyWF(slater, JastrowSpin(mol))
    params = wf.make_params("cpu")
    return mol, wf, params, LinearTransform(params, {"wf0": False, "wf1": True})


def test_linemin_file(tmp_path):
    """The JAX package's optimization file read by the port (read_opt,
    read_checkpoint) and the port's, written on the same schedule, read by
    the JAX package's read_opt: the same layout and rows."""
    jpath = os.path.join(FIXTURES, "opt.h5")
    assert_summaries_equal(recipes.read_opt(jpath), jrecipes.read_opt(jpath))
    got = linemin.read_checkpoint(jpath)
    with h5py.File(jpath, "r") as f:
        assert got["iterations"] == 2
        np.testing.assert_array_equal(got["x"], f["x"][-1])
        np.testing.assert_array_equal(got["configs"]["positions"], f["configs/positions"][...])
    mol, wf, params, lt = he_sj()
    tpath = str(tmp_path / "opt.h5")
    p, _, records = linemin.line_minimization(
        wf, params, he_configs(), lt, EnergyAccumulator(mol),
        generator=torch.Generator().manual_seed(3), max_iterations=2, vmc_blocks=2,
        vmc_steps_per_block=2, hdf_file=tpath)
    assert_same_layout(tpath, jpath)
    summary = jrecipes.read_opt(tpath)
    assert_summaries_equal(recipes.read_opt(tpath), summary)
    np.testing.assert_array_equal(summary["energy"], [r["energy"] for r in records])
    with h5py.File(tpath, "r") as f:
        np.testing.assert_array_equal(f["x"][-1], lt.serialize(p).numpy())


def h2_states():
    """The port's H2/cc-pVDZ ground state and the superposition of the
    ground and excited determinants (tools/torch_io_jax_fixtures.py)."""
    mf = run_scf(Molecule("H 0 0 0; H 0 0 1.4", basis="ccpvdz"))
    ca = np.asarray(mf.mo_coeff[0])[:, :2]
    mix = DeterminantExpansion(occ_up=np.array([[0], [1]]), occ_dn=np.array([[0]]),
                               map_up=np.array([0, 1]), map_dn=np.array([0, 0]))
    wfs = [Slater(mf.mol, None, DeterminantExpansion.single(1, 1), (ca[:, :1], ca[:, :1])),
           Slater(mf.mol, None, mix, (ca, ca), det_coeff=np.array([0.5, 0.8]))]
    plist = [w.make_params("cpu") for w in wfs]
    lt = LinearTransform(plist[1], {"det_coeff": True, "mo_coeff_alpha": False,
                                    "mo_coeff_beta": False})
    return mf.mol, wfs, plist, [None, lt]


def test_ensemble_file(tmp_path):
    """The JAX package's ensemble file resumed by the port (its x1 and
    walkers; no iteration left to run), and the port's, written on the
    same schedule, with the same layout."""
    mol, wfs, plist, transforms = h2_states()
    configs = initial_guess(mol, NCONF, generator=torch.Generator().manual_seed(4), device="cpu")
    jpath = os.path.join(FIXTURES, "ensemble.h5")
    resumed = str(tmp_path / "resumed.h5")
    shutil.copy(jpath, resumed)
    kws = dict(energy_acc=EnergyAccumulator(mol), penalty=4.0, tau=0.3, nblocks=1, nsteps=2)
    out, records = ensemble.optimize_ensemble(wfs, plist, transforms, configs,
                                              generator=torch.Generator().manual_seed(5),
                                              max_iterations=2, hdf_file=resumed, **kws)
    assert records == []
    with h5py.File(jpath, "r") as f:
        np.testing.assert_array_equal(out[1]["det_coeff"].numpy(), f["x1"][-1])
    tpath = str(tmp_path / "ensemble.h5")
    out, records = ensemble.optimize_ensemble(wfs, plist, transforms, configs,
                                              generator=torch.Generator().manual_seed(5),
                                              max_iterations=2, hdf_file=tpath, **kws)
    assert [r["iteration"] for r in records] == [0, 1]
    assert_same_layout(tpath, jpath)
    with h5py.File(tpath, "r") as f:
        np.testing.assert_array_equal(f["x1"][-1], out[1]["det_coeff"].numpy())
        np.testing.assert_array_equal(np.asarray(JConfigs.from_hdf(f["configs"]).positions),
                                      f["configs/positions"][...])


@pytest.mark.parametrize("weights", ["auto", "none", "array"])
def test_read_mc_output_matches_jax(weights, tmp_path):
    """read_mc_output of a DMC-style file (an energy correlated with the
    block weights, an array-valued observable) equals the JAX package's,
    weighted by the weight stream ("auto"), unweighted, or by given
    weights; the weighted mean is the weights' (JAX
    tests/unit/test_observables.py)."""
    rng = np.random.default_rng(12)
    nb = 40
    w = rng.uniform(0.5, 2.0, size=nb)
    e = -10.0 + (w - w.mean())
    path = str(tmp_path / "dmc.h5")
    with h5py.File(path, "w") as f:
        f["energytotal"] = e
        f["weight"] = w
        f["obdm"] = rng.normal(size=(nb, 3, 2))
        f["block"] = np.arange(nb)
    arg = {"auto": "auto", "none": None, "array": rng.uniform(0.2, 1.0, size=nb)}[weights]
    for warmup in (0, 4):
        out = recipes.read_mc_output(path, warmup=warmup, reblocks=8, weights=arg)
        assert_summaries_equal(out, jrecipes.read_mc_output(path, warmup=warmup, reblocks=8,
                                                            weights=arg))
        assert out["obdm"].shape == (3, 2) and out["obdm_err"].shape == (3, 2)
    # 40 blocks in 8 equal groups: the weighted mean is the weights'
    out = recipes.read_mc_output(path, warmup=0, reblocks=8, weights=arg)
    ww = {"auto": w, "none": np.ones(nb), "array": arg}[weights]
    np.testing.assert_allclose(out["energytotal"], np.sum(e * ww) / np.sum(ww), rtol=1e-12)


NO_H5PY = """
import sys
sys.modules["h5py"] = None
sys.modules["jax"] = None
import torch
import pyqmc_tpu_torch.api
from pyqmc_tpu_torch.entry import h2o_setup
from pyqmc_tpu_torch.method.vmc import vmc
mol, wf, params, configs, acc = h2o_setup(4, device="cpu")
data, _ = vmc(wf, params, configs, nblocks=1, nsteps_per_block=1, accumulators=acc,
              generator=torch.Generator().manual_seed(0))
assert data[0]["energytotal"] == data[0]["energytotal"]
try:
    vmc(wf, params, configs, nblocks=1, nsteps_per_block=1, hdf_file="never.h5")
except ImportError as err:
    assert "h5py" in str(err), err
else:
    raise AssertionError("a file was asked for without h5py and nothing raised")
print("ok")
"""


def test_without_h5py():
    """With h5py (and jax) blocked, the package imports and runs a VMC
    block; asking for a file raises an ImportError that names h5py."""
    out = subprocess.run([sys.executable, "-c", NO_H5PY], capture_output=True, text=True,
                         cwd=ROOT, timeout=120)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-2000:]
