"""The pyscf front door without pyscf: the port's system/pyscf_adapter.py and
system/chkfile.py against the JAX package's (float64, CPU).

- the duck-typed pyscf objects of JAX tests/unit/test_pyscf_adapter.py (RHF,
  ROHF, UHF, a Cell, a gamma-point KRHF, a CASCI) through both adapters give
  the same systems, mean fields, orbitals and expansions (1e-12);
- the h5py-built chkfiles of JAX tests/unit/test_chkfile.py (RHF, UHF with
  labelled atoms, an ECP atom, a CASCI checkfile, a cell) through both
  recover_pyscf give the same result; a k-point SCF group and a chkfile
  without one raise as in the JAX package;
- a realify= that asks for the JAX package's real-pair route raises.
"""

import types

import h5py
import numpy as np
import pytest
import torch

from pyqmc_tpu.system import chkfile as jchk
from pyqmc_tpu.system import pyscf_adapter as jpa
from pyqmc_tpu.system.mole import Molecule as JMolecule
from pyqmc_tpu.system.scf import run_scf as jrun_scf

from pyqmc_tpu_torch.system import chkfile, pyscf_adapter as pa

from .torch_parity import F64
from .unit.test_chkfile import _mol_json, _write_chk
from .unit.test_pyscf_adapter import _H_STO3G, FakeCell, FakeMole, FakeSCF


def same_system(t, j):
    assert type(t).__name__ == type(j).__name__
    assert list(t.atom_symbols) == list(j.atom_symbols)
    np.testing.assert_allclose(t.atom_coords, j.atom_coords, rtol=0, atol=1e-12)
    assert (t.charge, t.spin, tuple(t.nelec), t.nao) == (j.charge, j.spin, tuple(j.nelec), j.nao)
    assert sorted(t.ecp) == sorted(j.ecp)
    for el in j.basis:
        for s, r in zip(t.basis[el], j.basis[el]):
            assert s.l == r.l
            np.testing.assert_allclose(s.exps, r.exps, rtol=1e-12)
            np.testing.assert_allclose(s.coeffs, r.coeffs, rtol=1e-12)
    if j.lattice is not None:
        np.testing.assert_allclose(t.lattice, j.lattice, rtol=1e-12)


def same_mf(t, j):
    for name in ("mo_coeff", "mo_energy", "mo_occ"):
        for a, b in zip(getattr(t, name), getattr(j, name)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    assert t.e_tot == j.e_tot and t.restricted == j.restricted


def same_expansion(t, j):
    for k in ("occ_up", "occ_dn", "map_up", "map_dn"):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k))


def _h2():
    mol = JMolecule("H 0 0 0; H 0 0 1.4", basis={"H": _H_STO3G})
    return mol, jrun_scf(mol)


def _adapter_case(name):
    """(the port's adapter function, the JAX one, the fake object)."""
    rng = np.random.default_rng(3)
    if name in ("rhf", "casci"):
        mol, mf = _h2()
        atoms = [("H", mol.atom_coords[0]), ("H", mol.atom_coords[1])]
        occ = np.zeros(mf.mo_coeff[0].shape[1])
        occ[: mol.nelec[0]] = 2.0
        fake = FakeSCF(FakeMole(atoms, {"H": _H_STO3G}), np.asarray(mf.mo_coeff[0]),
                       np.asarray(mf.mo_energy[0]), occ, mf.e_tot)
        if name == "rhf":
            return pa.from_pyscf_mf, jpa.from_pyscf_mf, fake
        cas = types.SimpleNamespace(_scf=fake, ncas=2, ncore=0, nelecas=(1, 1),
                                    mo_coeff=np.asarray(mf.mo_coeff[0]),
                                    ci=np.array([[0.98, 0.0], [0.0, -0.199]]))
        return (lambda o: pa.from_pyscf_mc(o, tol=1e-3),
                lambda o: jpa.from_pyscf_mc(o, tol=1e-3), cas)
    li = FakeMole([("Li", (0.0, 0.0, 0.0))], {"Li": _H_STO3G}, spin=1)
    if name == "rohf":
        fake = FakeSCF(li, rng.normal(size=(4, 4)), np.arange(4.0),
                       np.array([2.0, 1.0, 0.0, 0.0]), -7.3)
        return pa.from_pyscf_mf, jpa.from_pyscf_mf, fake
    if name == "uhf":
        mo = np.stack([rng.normal(size=(3, 3)) for _ in range(2)])
        fake = FakeSCF(li, mo, (np.arange(3.0), np.arange(3.0)),
                       (np.array([1.0, 1.0, 0.0]), np.array([1.0, 0.0, 0.0])), -7.4)
        return pa.from_pyscf_mf, jpa.from_pyscf_mf, fake
    if name == "cell":
        fake = FakeCell([("H", (0.0, 0.0, 0.0)), ("H", (2.0, 0.0, 0.0))], {"H": _H_STO3G},
                        4.0 * np.eye(3))
        return pa.from_pyscf_mol, jpa.from_pyscf_mol, fake
    cell = FakeCell([("H", (0.0, 0.0, 0.0)), ("H", (3.0, 0.0, 0.0))], {"H": _H_STO3G},
                    6.0 * np.eye(3))
    kmf = types.SimpleNamespace(cell=cell, kpts=np.zeros((1, 3)), mo_coeff=[np.eye(2)],
                                mo_occ=[np.array([2.0, 0.0])])
    return pa.from_pyscf_kmf, jpa.from_pyscf_kmf, kmf


@pytest.mark.parametrize("name", ["rhf", "rohf", "uhf", "cell", "kmf", "casci"])
def test_adapter_matches_jax(name):
    port_fn, jax_fn, obj = _adapter_case(name)
    t, j = port_fn(obj), jax_fn(obj)
    if name == "cell":
        same_system(t, j)
        return
    same_system(t[0], j[0])
    if name == "kmf":
        torb, jorb = t[1], j[1]
        assert torb.norb == jorb.norb == (1, 1) and torb.real_mode == jorb.real_mode
        X = np.random.default_rng(5).uniform(-1.0, 4.0, size=(6, 3))
        tmo = torb.eval(torb.make_params("cpu", F64), torch.as_tensor(X, dtype=F64), 0)
        jmo = jorb.eval(jorb.make_params(), X, 0)
        for a, b in zip(tmo, jmo):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-12)
        return
    same_mf(t[1], j[1])
    if name == "casci":
        same_expansion(t[2], j[2])
        np.testing.assert_array_equal(t[3], j[3])


def test_adapter_refuses_the_pair_route():
    _, _, kmf = _adapter_case("kmf")
    with pytest.raises(ValueError, match="item 7"):
        pa.from_pyscf_kmf(kmf, realify="pair")
    with pytest.raises(TypeError, match="_basis"):
        pa.from_pyscf_mol(object())


def _scf_group(mf, uhf=False):
    if uhf:
        return {"e_tot": mf.e_tot, "mo_energy": np.stack(mf.mo_energy),
                "mo_coeff": np.stack(mf.mo_coeff), "mo_occ": np.stack(mf.mo_occ)}
    return {"e_tot": mf.e_tot, "mo_energy": np.asarray(mf.mo_energy[0]),
            "mo_coeff": np.asarray(mf.mo_coeff[0]),
            "mo_occ": np.asarray(mf.mo_occ[0]) + np.asarray(mf.mo_occ[1])}


@pytest.mark.parametrize("name", ["rhf", "uhf_labelled", "ecp", "casci", "cell"])
def test_chkfile_matches_jax(name, tmp_path):
    chk, ci = str(tmp_path / "scf.chk"), None
    if name in ("rhf", "casci"):
        mol = JMolecule("Li 0 0 0; H 0 0 3.015", basis="sto-3g")
        mf = jrun_scf(mol)
        _write_chk(chk, _mol_json(mol.atom_symbols, mol.atom_coords, "sto-3g"),
                   scf=_scf_group(mf))
        if name == "casci":
            ci = str(tmp_path / "casci.chk")
            _write_chk(ci, _mol_json(mol.atom_symbols, mol.atom_coords, "sto-3g"),
                       ci_group="mcscf",
                       ci_dict={"ci": np.array([[0.95, 0.0], [0.0, -np.sqrt(1 - 0.95**2)]]),
                                "ncas": 2, "nelecas": np.array([1, 1]), "ncore": 1,
                                "mo_coeff": np.asarray(mf.mo_coeff[0]), "e_tot": -7.9})
    elif name == "uhf_labelled":
        mol = JMolecule("H 0 0 0; H 0 0 1.4", basis="sto-3g", spin=2)
        mf = jrun_scf(mol)
        _write_chk(chk, _mol_json(["H1", "H2"], mol.atom_coords, "sto-3g", spin=2),
                   scf=_scf_group(mf, uhf=True))
    elif name == "ecp":
        mol = JMolecule("C 0 0 0", basis="ccecpccpvdz", ecp="ccecp", spin=2)
        mf = jrun_scf(mol)
        _write_chk(chk, _mol_json(["C"], mol.atom_coords, "ccecpccpvdz", ecp="ccecp", spin=2),
                   scf=_scf_group(mf))
    else:
        mol = JMolecule("H 0 0 0", basis="sto-3g", spin=1)
        _write_chk(chk, _mol_json(["H"], mol.atom_coords, "sto-3g", spin=1,
                                  a="2.0 0 0\n0 2.0 0\n0 0 2.0", unit="angstrom"))
        same_system(chkfile.read_mol(chk), jchk.read_mol(chk))
        with h5py.File(chk, "a") as f:
            g = f.create_group("scf")
            g.create_group("mo_coeff__from_list__")["0"] = np.eye(2)
            g["mo_occ"], g["mo_energy"], g["e_tot"] = np.array([1.0]), np.array([0.0]), -0.5
        for recover in (chkfile.recover_pyscf, jchk.recover_pyscf):
            with pytest.raises(NotImplementedError):
                recover(chk)
        assert chkfile.load(chk, "scf")["mo_coeff"][0].shape == (2, 2)
        return
    t, j = chkfile.recover_pyscf(chk, ci_checkfile=ci), jchk.recover_pyscf(chk, ci_checkfile=ci)
    same_system(t[0], j[0])
    same_mf(t[1], j[1])
    if name == "casci":
        from pyqmc_tpu.system.ci_import import interpret_ci as j_interpret

        from pyqmc_tpu_torch.system.ci_import import interpret_ci

        assert (t[2].ncas, t[2].nelecas, t[2].ncore) == (j[2].ncas, j[2].nelecas, j[2].ncore)
        (te, tc), (je, jc) = interpret_ci(t[2], 1e-6), j_interpret(j[2], 1e-6)
        same_expansion(te, je)
        np.testing.assert_array_equal(tc, jc)


def test_chkfile_without_scf_raises(tmp_path):
    chk = str(tmp_path / "empty.chk")
    mol = JMolecule("H 0 0 0", basis="sto-3g", spin=1)
    _write_chk(chk, _mol_json(["H"], mol.atom_coords, "sto-3g", spin=1))
    with pytest.raises(ValueError, match="not a pyscf SCF checkpoint"):
        chkfile.recover_pyscf(chk)
    assert chkfile.load(chk, "ci") is None
