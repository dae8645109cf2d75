"""The port's recipes (pyqmc_tpu_torch/recipes.py) against the JAX
package's pyqmc_tpu/recipes.py: the set-up from a Molecule on H2/STO-3G
(SCF, wavefunction parameters, local energies on shared walkers, float64),
generate_accumulators' flags, OPTIMIZE -> VMC(params=) -> DMC end to end on
device="cpu" with the JAX recipes' record and block keys, the HDF5 paths
(output=, load_parameters=, a chkfile path, ci_checkfile=, read_mc_output,
read_opt), and the walker mesh's guard.

No JAX VMC or DMC block is compiled here: the JAX side's recipes are
compared through their set-up and one local-energy evaluation.
"""

import h5py
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pyqmc_tpu import recipes as jrecipes
from pyqmc_tpu.system.mole import Molecule as JMolecule

from pyqmc_tpu_torch import recipes
from pyqmc_tpu_torch.parallel.mesh import WalkerMesh
from pyqmc_tpu_torch.system.mole import Molecule

from .torch_parity import F64, jrun, to_np, walkers

H2 = "H 0 0 0; H 0 0 1.4"
# the JAX recipes' outputs (pyqmc_tpu/method/linemin.py:249-258,
# method/vmc.py:158-179 and :359-361, method/dmc.py:284-294 and :551-611)
JAX_RECORD_KEYS = {"iteration", "energy", "energy_err", "gnorm", "tau", "stalled",
                   "line_energies"}
JAX_VMC_KEYS = {"acceptance", "block", "block time", "energytotal", "energyke", "energyee",
                "energyei", "energyii", "energyecp", "energygrad2"}
JAX_DMC_KEYS = JAX_VMC_KEYS | {"weight", "e_trial", "e_est"}


def test_setup_matches_jax():
    """recipes._setup on H2/STO-3G: the same SCF (1e-10), the same
    wavefunction parameters and to_opt, the same walkers' shape, and the
    same local energies on shared walkers (1e-10)."""
    jm, tm = JMolecule(H2, basis="sto-3g"), Molecule(H2, basis="sto-3g")
    jmol, jmf, jwf, jparams, jto_opt, jconfigs, jenergy = jrecipes._setup(jm, nconfig=8)
    tmol, tmf, twf, tparams, tto_opt, tconfigs, tenergy = recipes._setup(tm, nconfig=8,
                                                                         device="cpu")
    assert abs(tmf.e_tot - jmf.e_tot) <= 1e-10
    assert tconfigs.positions.shape == jconfigs.positions.shape
    assert tconfigs.positions.dtype == F64
    for a, b in zip(to_np(tparams), to_np(jparams)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)
    for a, b in zip(to_np(tto_opt), to_np(jto_opt)):
        np.testing.assert_array_equal(a, b)
    assert tenergy.ecp_acc is None and jenergy.ecp_acc is None
    pos = walkers(np.random.default_rng(2), 6, nelec=2, scale=1.2)

    def jfn(params, x):
        return jenergy(jwf, params, jwf.recompute(params, x), x)

    je = jrun("recipes_h2_energy", jfn, jparams, jnp.asarray(pos))
    x = torch.as_tensor(pos, dtype=F64)
    te = tenergy(twf, tparams, twf.recompute(tparams, x), x)
    for k in ("total", "ke", "ee", "ei", "ii", "grad2"):
        np.testing.assert_allclose(te[k].numpy(), np.asarray(je[k]), rtol=0, atol=1e-10)


def test_generate_accumulators_flags():
    """The JAX package's test_generate_accumulators_flags on the port; a
    molecule with an ECP gets its ECP accumulator."""
    from pyqmc_tpu_torch.system.scf import run_scf

    mol = Molecule(H2, basis="sto-3g")
    mf = run_scf(mol)
    acc = recipes.generate_accumulators(mol, mf, energy=True, rdm1=True)
    assert set(acc) == {"energy", "rdm1_up", "rdm1_down"}
    with pytest.raises(ValueError, match="sq_qlist"):
        recipes.generate_accumulators(mol, mf, sq=True)
    with pytest.raises(ValueError, match="extra_accumulators"):
        recipes.generate_accumulators(mol, mf, energy=True,
                                      extra_accumulators={"energy": acc["energy"]})
    sq = recipes.generate_accumulators(mol, mf, energy=False, sq=True,
                                       sq_qlist=np.array([[1.0, 0, 0]]))
    assert set(sq) == {"sq"}
    o = Molecule("O 0 0 0", basis="ccecp-ccpvdz", ecp="ccecp", spin=2)
    assert recipes.generate_accumulators(o, None)["energy"].ecp_acc is not None
    assert recipes._resolve_accumulators(mol, mf, None, {"rdm1": True}).keys() == {
        "rdm1_up", "rdm1_down"}


def test_optimize_vmc_dmc_on_cpu():
    """OPTIMIZE -> VMC(params=) -> DMC(params=) on H2/STO-3G at 32 walkers
    and two iterations, device="cpu" (float64): the JAX recipes' record and
    block keys, finite energies, OPTIMIZE's parameters in VMC and DMC, the
    same seed the same chain; the H atom's empty down-spin channel runs."""
    mol = Molecule(H2, basis="sto-3g")
    small = dict(vmc_blocks=2, vmc_steps_per_block=3)
    wf, params, records = recipes.OPTIMIZE(mol, nconfig=32, max_iterations=2, device="cpu",
                                           **small)
    assert len(records) == 2 and all(set(r) >= JAX_RECORD_KEYS for r in records)
    assert all(np.isfinite(r["energy"]) for r in records)
    assert params["wf1"]["bcoeff"].dtype == F64
    data, configs = recipes.VMC(mol, params=params, nconfig=32, nblocks=2, nsteps_per_block=3,
                                device="cpu", seed=5)
    assert len(data) == 2 and all(set(d) == JAX_VMC_KEYS for d in data)
    assert configs.positions.shape == (32, 2, 3) and configs.positions.device.type == "cpu"
    again, _ = recipes.VMC(mol, params=params, nconfig=32, nblocks=2, nsteps_per_block=3,
                           device="cpu", seed=5)
    assert [d["energytotal"] for d in again] == [d["energytotal"] for d in data]
    default, _ = recipes.VMC(mol, nconfig=32, nblocks=1, nsteps_per_block=3, device="cpu",
                             seed=5)
    assert default[0]["energytotal"] != data[0]["energytotal"]
    blocks, dconfigs, weights = recipes.DMC(mol, params=params, nconfig=32, nblocks=2,
                                            nsteps_per_block=2, warmup_vmc_blocks=1,
                                            device="cpu", accumulators={"rdm1": True})
    assert len(blocks) == 2 and all(set(b) >= JAX_DMC_KEYS for b in blocks)
    assert all(np.isfinite(b["energytotal"]) for b in blocks)
    assert blocks[0]["rdm1_upvalue"].shape == (2, 2)
    assert bool(torch.all(weights > 0))
    hblocks, _, _ = recipes.DMC(Molecule("H 0 0 0", basis="ccpvdz", spin=1), nconfig=16,
                                nblocks=2, nsteps_per_block=2, warmup_vmc_blocks=1,
                                device="cpu")
    assert all(np.isfinite(b["energytotal"]) for b in hblocks)


def test_recipes_default_to_the_gpu():
    from pyqmc_tpu_torch.utils.dtypes import NoCudaDeviceError

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(NoCudaDeviceError):
        recipes.VMC(Molecule(H2, basis="sto-3g"), nconfig=4, nblocks=1)


_MESH3 = WalkerMesh(group=None, rank=0, size=3, device=torch.device("cpu"), backend="gloo")


@pytest.mark.parametrize("call", [
    lambda mol: recipes.VMC(mol, nconfig=4, mesh=_MESH3, device="cpu"),
    lambda mol: recipes.DMC(mol, nconfig=4, mesh=_MESH3, device="cpu"),
], ids=["vmc-mesh", "dmc-mesh"])
def test_unported_paths_raise(call):
    """VMC and DMC pass the walker mesh on (tests/test_torch_mesh.py runs
    it): walkers that do not divide over its ranks raise ValueError, with
    the JAX package's "must divide evenly", before the first block."""
    with pytest.raises(ValueError, match="must divide evenly"):
        call(Molecule(H2, basis="sto-3g"))


def _opt_file(path):
    """OPTIMIZE(output=) on H2/STO-3G, 8 walkers, one iteration of 2 x 2 SR
    steps; returns its parameters."""
    _, params, records = recipes.OPTIMIZE(Molecule(H2, basis="sto-3g"), output=path, nconfig=8,
                                          max_iterations=1, vmc_blocks=2, vmc_steps_per_block=2,
                                          device="cpu")
    assert len(records) == 1
    return params


def _h2_chkfiles(tmp_path):
    """A pyscf-layout SCF chkfile of H2/STO-3G and a CAS(2e,2o) checkfile
    (JAX tests/unit/test_chkfile.py's writers)."""
    from pyqmc_tpu.system.scf import run_scf as jrun_scf

    from .unit.test_chkfile import _mol_json, _write_chk

    mol = JMolecule(H2, basis="sto-3g")
    mf = jrun_scf(mol)
    chk, ci = str(tmp_path / "scf.chk"), str(tmp_path / "ci.chk")
    text = _mol_json(mol.atom_symbols, mol.atom_coords, "sto-3g")
    _write_chk(chk, text, scf={"e_tot": mf.e_tot, "mo_energy": np.asarray(mf.mo_energy[0]),
                               "mo_coeff": np.asarray(mf.mo_coeff[0]),
                               "mo_occ": 2.0 * np.asarray(mf.mo_occ[0])})
    _write_chk(ci, text, ci_group="mcscf", ci_dict={
        "ci": np.array([[0.95, 0.0], [0.0, -np.sqrt(1 - 0.95**2)]]), "ncas": 2,
        "nelecas": np.array([1, 1]), "ncore": 0, "mo_coeff": np.asarray(mf.mo_coeff[0])})
    return chk, ci


def _same_blocks(a, b):
    assert [d["energytotal"] for d in a] == [d["energytotal"] for d in b]


def _case(name, tmp_path):
    mol = Molecule(H2, basis="sto-3g")
    small = dict(nconfig=8, nblocks=2, nsteps_per_block=2, device="cpu", seed=3)
    opt = str(tmp_path / "opt.h5")
    if name == "optimize-output":
        params = _opt_file(opt)
        with h5py.File(opt, "r") as f:
            assert {"energy", "energy_err", "gnorm", "tau", "x", "configs", "wf"} <= set(f)
            np.testing.assert_array_equal(f["wf/wf1/acoeff"][...], params["wf1"]["acoeff"])
    elif name in ("vmc-output", "read-mc-output"):
        out = str(tmp_path / "vmc.h5")
        data, _ = recipes.VMC(mol, output=out, **small)
        again, _ = recipes.VMC(mol, output=out, **small)  # continues the file
        assert [d["block"] for d in again] == [2, 3]
        summary = recipes.read_mc_output(out, warmup=0, reblocks=2)
        expect = jrecipes.read_mc_output(out, warmup=0, reblocks=2)
        assert set(summary) == set(expect)
        for k in summary:
            np.testing.assert_allclose(summary[k], expect[k], rtol=1e-12)
    elif name in ("vmc-load", "dmc-load"):
        params = _opt_file(opt)
        run = recipes.VMC if name == "vmc-load" else recipes.DMC
        kw = {} if name == "vmc-load" else {"warmup_vmc_blocks": 1}
        _same_blocks(run(mol, load_parameters=opt, **small, **kw)[0],
                     run(mol, params=params, **small, **kw)[0])
    elif name == "read-opt":
        _opt_file(opt)
        got, expect = recipes.read_opt(opt), jrecipes.read_opt(opt)
        assert set(got) == set(expect) == {"energy", "energy_err", "gnorm", "tau"}
        for k in got:
            np.testing.assert_array_equal(got[k], expect[k])
    elif name == "chkfile":
        chk, _ = _h2_chkfiles(tmp_path)
        tmol, tmf, _ = recipes._resolve_system(chk)
        jmol, jmf, _ = jrecipes._resolve_system(chk)
        np.testing.assert_allclose(tmf.mo_coeff[0], jmf.mo_coeff[0], rtol=0, atol=1e-12)
        data, _ = recipes.VMC(chk, **small)
        assert all(np.isfinite(d["energytotal"]) for d in data)
    else:  # ci-checkfile
        chk, ci = _h2_chkfiles(tmp_path)
        _, _, wf, _, _, _, _ = recipes._setup(mol, ci_checkfile=ci, nconfig=8, device="cpu")
        assert wf.wfs[0].expansion.map_up.shape == (2,)
        blocks, _, _ = recipes.DMC(chk, ci_checkfile=ci, warmup_vmc_blocks=1, **small)
        assert all(np.isfinite(b["energytotal"]) for b in blocks)


@pytest.mark.parametrize("name", ["optimize-output", "vmc-output", "vmc-load", "dmc-load",
                                  "chkfile", "ci-checkfile", "read-mc-output", "read-opt"])
def test_hdf5_paths(name, tmp_path):
    """The recipes' file paths on the CPU: OPTIMIZE(output=) writes the
    line minimization's rows and the parameters, VMC(output=) writes and
    continues its file, load_parameters= gives the chain of params= with
    the same parameters, a chkfile path (and ci_checkfile=) builds the
    system the JAX package's _resolve_system builds, and read_mc_output and
    read_opt equal the JAX package's on the port's files."""
    _case(name, tmp_path)


def test_empty_spin_channel_matches_jax():
    """The H atom's empty down-spin channel (phase 33's DMC anchor) through
    the multi-determinant paths of Slater: two up determinants (the SCF's
    MOs 0 and 1) and no down electron, with a Jastrow; values and local
    energies on shared walkers against the JAX package's to 1e-10."""
    from pyqmc_tpu.models.jastrow import JastrowSpin as JJastrow
    from pyqmc_tpu.models.multiply import MultiplyWF as JMultiply
    from pyqmc_tpu.models.slater import DeterminantExpansion as JExpansion
    from pyqmc_tpu.models.slater import Slater as JSlater
    from pyqmc_tpu.observables.accumulators import EnergyAccumulator as JEnergy
    from pyqmc_tpu.system.scf import run_scf as jrun_scf

    from pyqmc_tpu_torch.convert import params_from_numpy
    from pyqmc_tpu_torch.models.jastrow import JastrowSpin
    from pyqmc_tpu_torch.models.multiply import MultiplyWF
    from pyqmc_tpu_torch.models.slater import DeterminantExpansion, Slater
    from pyqmc_tpu_torch.observables.accumulators import EnergyAccumulator
    from pyqmc_tpu_torch.system.scf import run_scf

    kw = dict(basis="ccpvdz", spin=1)
    jm, tm = JMolecule("H 0 0 0", **kw), Molecule("H 0 0 0", **kw)
    jmf, tmf = jrun_scf(jm), run_scf(tm)
    assert tm.nelec == (1, 0)
    occ = dict(occ_up=np.array([[0], [1]]), occ_dn=np.zeros((1, 0), dtype=np.int64),
               map_up=np.array([0, 1]), map_dn=np.array([0, 0]))
    coeff = np.array([0.9, 0.3])
    ca, cb = tmf.mo_coeff[0][:, :2], tmf.mo_coeff[1][:, :0]
    jwf = JMultiply(JSlater(jm, None, JExpansion(**occ), (ca, cb), det_coeff=coeff), JJastrow(jm))
    twf = MultiplyWF(Slater(tm, None, DeterminantExpansion(**occ), (ca, cb), det_coeff=coeff),
                     JastrowSpin(tm))
    rng = np.random.default_rng(4)
    jparams = jwf.make_params()
    jparams["wf1"]["acoeff"] = jnp.asarray(rng.normal(scale=0.1,
                                                      size=jparams["wf1"]["acoeff"].shape))
    tparams = params_from_numpy({k: {kk: np.asarray(v) for kk, v in p.items()}
                                 for k, p in jparams.items()}, device="cpu", dtype=F64)
    pos = walkers(rng, 5, nelec=1, scale=1.0)
    jenergy, tenergy = JEnergy(jm), EnergyAccumulator(tm)

    def jfn(params, x):
        state = jwf.recompute(params, x)
        return jwf.value(params, state), jenergy(jwf, params, state, x)

    (jphase, jlog), je = jrun("recipes_h_empty_spin", jfn, jparams, jnp.asarray(pos))
    x = torch.as_tensor(pos, dtype=F64)
    state = twf.recompute(tparams, x)
    tphase, tlog = twf.value(tparams, state)
    te = tenergy(twf, tparams, state, x)
    np.testing.assert_allclose(tphase.numpy(), np.asarray(jphase), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0, atol=1e-10)
    for k in ("total", "ke", "grad2"):
        np.testing.assert_allclose(te[k].numpy(), np.asarray(je[k]), rtol=0, atol=1e-10)
