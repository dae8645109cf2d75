"""The port's molecular front end against the JAX package's, float64 numpy
on both sides: the basis and ECP libraries, Molecule and Cell, the
integrals, the ECP matrix, the SCF, and CASCI, HCI and the CI import.

The port's modules are carried copies (basis, integrals, SCF, CI) or a
port (ecp_matrix: the port's eval_gto on CPU tensors and its parse_ecp),
so the same inputs give the same numbers to rounding; each test states its
tolerance.
"""

import types

import numpy as np
import pytest

from pyqmc_tpu.system import basis as jbasis
from pyqmc_tpu.system import casci as jcasci
from pyqmc_tpu.system import ci_import as jci
from pyqmc_tpu.system import ecp_integrals as jecp
from pyqmc_tpu.system import integrals as jint
from pyqmc_tpu.system.mole import Cell as JCell
from pyqmc_tpu.system.mole import Molecule as JMolecule
from pyqmc_tpu.system.scf import run_scf as jrun_scf

from pyqmc_tpu_torch.system import basis, casci, ci_import, ecp_integrals, integrals
from pyqmc_tpu_torch.system.mole import Cell, Molecule
from pyqmc_tpu_torch.system.scf import run_scf

H2O = "O 0 0 0.2217; H 0 1.4309 -0.8867; H 0 -1.4309 -0.8867"
# the SCF energies as the package's documentation rounds them
ROUNDED_PINS = {"he": -2.80778, "h2": -1.116714, "h2o": -74.963027, "h_uhf": -0.499278}
SCF_SYSTEMS = {"he": ("He 0 0 0", {}), "h2": ("H 0 0 0; H 0 0 1.4", {}),
               "h2o": (H2O, {}), "h_uhf": ("H 0 0 0", dict(basis="ccpvdz", spin=1))}


def same_shells(a, b, rtol=1e-14):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.l == y.l
        np.testing.assert_allclose(np.asarray(x.exps), np.asarray(y.exps), rtol=rtol, atol=0)
        np.testing.assert_allclose(np.asarray(x.coeffs), np.asarray(y.coeffs), rtol=rtol, atol=0)


def same_tree(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            same_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same_tree(x, y)
    else:
        assert a == b


def test_libraries_match_jax():
    """Every built-in basis for every element it holds, and both ECP
    libraries, equal the JAX tables (shells to 1e-14 relative, the ECP
    terms exactly)."""
    assert set(basis._BUILTIN) == set(jbasis._BUILTIN) >= {
        "sto-3g", "6-31g", "ccpvdz", "ccecpccpvdz", "tpu1dz"}
    for name, table in jbasis._BUILTIN.items():
        assert set(basis._BUILTIN[name]) == set(table)
        for el in table:
            same_shells(basis.get_basis(name, [el])[el], jbasis.get_basis(name, [el])[el])
    assert set(basis.ECP_LIBRARY) == set(jbasis.ECP_LIBRARY) == {"ccecp", "tpu1"}
    same_tree(basis.ECP_LIBRARY, jbasis.ECP_LIBRARY)
    assert basis.get_ecp("ccecp", ["O", "H"]) == jbasis.get_ecp("ccecp", ["O", "H"])
    mixed = {"B": "tpu1", "C": "ccecp"}
    same_tree(basis.get_ecp(mixed, ["B", "C"]), jbasis.get_ecp(mixed, ["B", "C"]))
    even = basis.even_tempered_basis(2)
    same_shells(even, jbasis.even_tempered_basis(2))
    with pytest.raises(KeyError):
        basis.get_basis("no-such-basis", ["H"])


@pytest.mark.parametrize("atom,kw", [
    (H2O, dict(basis="ccecp-ccpvdz", ecp="ccecp")),
    (H2O, dict(basis="sto-3g", charge=1, spin=1)),
    ([("B", (0, 0, 0)), ("C", (0, 0, 1.5))],
     dict(basis={"B": jbasis._BUILTIN["tpu1dz"]["B"], "C": jbasis._BUILTIN["ccecpccpvdz"]["C"]},
          ecp={"B": "tpu1", "C": "ccecp"}, spin=1, unit="angstrom")),
    ("H 0 0 0\nLi 0 0 3.015", dict(basis="sto-3g")),
], ids=["h2o-ccecp", "h2o-cation", "bc-angstrom", "lih-newline"])
def test_molecule_matches_jax(atom, kw):
    """Shell tables (atom, l, AO offset, exponents, coefficients), nao,
    nelec, atom charges, coordinates (1e-14) and the ECP equal the JAX
    Molecule's."""
    t, j = Molecule(atom, **kw), JMolecule(atom, **kw)
    assert t.atom_symbols == j.atom_symbols and t.nao == j.nao and t.nelec == j.nelec
    np.testing.assert_array_equal(t.atom_charges, j.atom_charges)
    np.testing.assert_allclose(t.atom_coords, j.atom_coords, rtol=1e-14, atol=0)
    assert [(s.atom, s.l, s.ao_offset) for s in t.shells] == [
        (s.atom, s.l, s.ao_offset) for s in j.shells]
    same_shells(t.shells, j.shells)
    same_tree(t.ecp, j.ecp)
    assert t.nuclear_repulsion() == pytest.approx(j.nuclear_repulsion(), rel=1e-14)


def test_cell_matches_jax():
    lattice = 3.37 * (np.ones((3, 3)) - np.eye(3))
    kw = dict(basis="ccecp-ccpvdz", ecp="ccecp")
    t = Cell("C 0 0 0; C 1.685 1.685 1.685", lattice, **kw)
    j = JCell("C 0 0 0; C 1.685 1.685 1.685", lattice, **kw)
    assert t.nao == j.nao and t.nelec == j.nelec
    np.testing.assert_array_equal(t.atom_charges, j.atom_charges)
    np.testing.assert_array_equal(t.lattice, j.lattice)
    same_shells(t.shells, j.shells)
    assert t.volume == pytest.approx(j.volume, rel=1e-14)
    np.testing.assert_allclose(t.reciprocal(), j.reciprocal(), rtol=1e-14)
    # the primitive k-points of the 2x2x2 supercell's twists
    from pyqmc_tpu.system.supercell import get_supercell as jget_supercell
    from pyqmc_tpu.system.supercell import get_supercell_kpts as jget_supercell_kpts

    from pyqmc_tpu_torch.system.supercell import get_supercell, get_supercell_kpts

    S = 2 * np.eye(3, dtype=int)
    ts, js = get_supercell(t, S), jget_supercell(j, S)
    frac = np.array([[a, b, c] for a in (0, 0.5) for b in (0, 0.5) for c in (0, 0.5)])
    kpts = frac @ t.reciprocal()
    for twist in (None, [0.5, 0.0, 0.0], [0.25, 0.0, 0.0]):
        ti, tc = get_supercell_kpts(ts, kpts, twist)
        ji, jc = jget_supercell_kpts(js, kpts, twist)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-14)
    assert len(get_supercell_kpts(ts, kpts)[0]) == 8


@pytest.fixture(scope="module")
def o_atom():
    """A small system with d shells and an ECP: the O atom in ccECP
    cc-pVDZ (13 AOs), on both sides."""
    kw = dict(basis="ccecp-ccpvdz", ecp="ccecp", spin=2)
    return JMolecule("O 0 0 0.1", **kw), Molecule("O 0 0 0.1", **kw)


@pytest.mark.parametrize("system", ["h2o-sto3g", "o-ccecp"])
def test_integrals_match_jax(system, o_atom):
    """Overlap, kinetic, nuclear and ERI to 1e-12."""
    if system == "o-ccecp":
        jm, tm = o_atom
    else:
        jm, tm = JMolecule(H2O), Molecule(H2O)
    for t, j in zip(integrals.overlap_kinetic(tm), jint.overlap_kinetic(jm)):
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(integrals.nuclear(tm), jint.nuclear(jm), rtol=0, atol=1e-12)
    np.testing.assert_allclose(integrals.eri(tm), jint.eri(jm), rtol=0, atol=1e-12)
    x = np.linspace(0.0, 40.0, 7)
    np.testing.assert_allclose(integrals.boys(4, x), jint.boys(4, x), rtol=0, atol=1e-15)


def test_ecp_matrix_matches_jax(o_atom):
    """ecp_matrix through the port's eval_gto and parse_ecp against the
    JAX package's, to 1e-10, on a coarser grid than the default (the same
    grid on both sides); a molecule without an ECP gives zeros."""
    jm, tm = o_atom
    grid = dict(nrad=40, rmax=10.0, ntheta=12, nphi=24)
    v = ecp_integrals.ecp_matrix(tm, **grid)
    np.testing.assert_allclose(v, jecp.ecp_matrix(jm, **grid), rtol=0, atol=1e-10)
    assert np.abs(v).max() > 0.1
    assert not np.any(ecp_integrals.ecp_matrix(Molecule("He 0 0 0")))


@pytest.mark.parametrize("name", list(SCF_SYSTEMS))
def test_scf_matches_jax(name):
    """run_scf against a fresh JAX SCF: e_tot to 1e-9, mo_energy to 1e-8,
    the occupied mo_coeff columns up to sign to 1e-8; e_tot within 1e-5 of
    its rounded pin."""
    atom, kw = SCF_SYSTEMS[name]
    t, j = run_scf(Molecule(atom, **kw)), jrun_scf(JMolecule(atom, **kw))
    assert t.converged and t.restricted == j.restricted and t.nelec == j.nelec
    assert abs(t.e_tot - j.e_tot) <= 1e-9
    assert abs(t.e_tot - ROUNDED_PINS[name]) <= 1e-5
    for s in range(2):
        np.testing.assert_allclose(t.mo_energy[s], j.mo_energy[s], rtol=0, atol=1e-8)
        np.testing.assert_array_equal(t.mo_occ[s], j.mo_occ[s])
        nocc = t.nelec[s]
        ct, cj = t.mo_coeff[s][:, :nocc], j.mo_coeff[s][:, :nocc]
        sign = np.sign(np.sum(ct * cj, axis=0))
        np.testing.assert_allclose(ct * sign, cj, rtol=0, atol=1e-8)


def _dense_ci(exp, coeff, ncas, nelecas):
    """A CASCI root as the dense CI array of pyscf's string order (the
    input interpret_ci reads from a pyscf CASCI object)."""
    sa = ci_import._pyscf_strings(ncas, nelecas[0])
    sb = ci_import._pyscf_strings(ncas, nelecas[1])
    ci = np.zeros((len(sa), len(sb)))
    for u, d, c in zip(exp.map_up, exp.map_dn, coeff):
        ci[sa.index(tuple(exp.occ_up[u])), sb.index(tuple(exp.occ_dn[d]))] = c
    return ci


def _determinants(exp, coeff):
    return {(tuple(exp.occ_up[u]), tuple(exp.occ_dn[d])): c
            for u, d, c in zip(exp.map_up, exp.map_dn, coeff)}


def _same_expansion(t, j):
    """The same determinants, coefficients up to one global sign (1e-10)."""
    dt, dj = _determinants(*t), _determinants(*j)
    assert dt.keys() == dj.keys()
    ct = np.array([dt[k] for k in dj])
    cj = np.array([dj[k] for k in dj])
    sign = np.sign(np.dot(ct, cj))
    np.testing.assert_allclose(sign * ct, cj, rtol=0, atol=1e-10)


@pytest.mark.parametrize("r", [1.4, 5.0], ids=["equilibrium", "stretched"])
def test_casci_hci_interpret_ci_match_jax(r):
    """H2/STO-3G, as the JAX package's tests/integration/test_casci.py:
    run_casci (3 roots) and run_hci energies to 1e-10, the same
    determinants and coefficients up to a global sign; interpret_ci of the
    CASCI root as a pyscf-style dense CI object, an HCI object (`_strs`)
    and bitstring tuples, on both sides; and generate_slater(mc=) of that
    object (tol) builds the expansion of the CASCI root."""
    from pyqmc_tpu_torch.wftools import generate_slater

    atom = f"H 0 0 0; H 0 0 {r}"
    tmf, jmf = run_scf(Molecule(atom)), jrun_scf(JMolecule(atom))
    te, troots = casci.run_casci(tmf, 2, (1, 1), nroots=3)
    je, jroots = jcasci.run_casci(jmf, 2, (1, 1), nroots=3)
    np.testing.assert_allclose(te, je, rtol=0, atol=1e-10)
    _same_expansion(troots[0], jroots[0])
    he, hroots = casci.run_hci(tmf, 2, (1, 1), eps1=1e-6)
    jhe, jhroots = jcasci.run_hci(jmf, 2, (1, 1), eps1=1e-6)
    np.testing.assert_allclose(he, jhe, rtol=0, atol=1e-10)
    assert abs(he[0] - te[0]) < 1e-8
    _same_expansion(hroots[0], jhroots[0])
    if r == 5.0:
        c = np.abs(troots[0][1]) / np.linalg.norm(troots[0][1])
        assert np.sum(c > 0.3) >= 2

    exp, coeff = troots[0]
    mc = types.SimpleNamespace(ci=_dense_ci(exp, coeff, 2, (1, 1)), ncas=2, nelecas=(1, 1),
                               ncore=0)
    tx, jx = ci_import.interpret_ci(mc, tol=1e-9), jci.interpret_ci(mc, tol=1e-9)
    _same_expansion(tx, jx)
    _same_expansion(tx, (exp, coeff))
    # an HCI-style object: up|dn bit words per determinant and its coefficients
    words = [[int("".join("1" if o in exp.occ_up[u] else "0" for o in (1, 0)), 2),
              int("".join("1" if o in exp.occ_dn[d] else "0" for o in (1, 0)), 2)]
             for u, d in zip(exp.map_up, exp.map_dn)]
    hci = types.SimpleNamespace(ci=np.asarray(coeff), _strs=np.asarray(words), ncore=0)
    _same_expansion(ci_import.interpret_ci(hci), jci.interpret_ci(hci))
    _same_expansion(ci_import.interpret_ci(hci), (exp, coeff))
    bits = [(0.6, "01", "10"), (-0.8, "10", "01"), (1e-12, "01", "01")]
    t = ci_import.expansion_from_determinants(ci_import.determinants_from_bitstrings(
        bits, ncore=1, tol=1e-9))
    j = jci.expansion_from_determinants(jci.determinants_from_bitstrings(bits, ncore=1, tol=1e-9))
    for a, b in zip((t[0].occ_up, t[0].occ_dn, t[0].map_up, t[0].map_dn, t[1]),
                    (j[0].occ_up, j[0].occ_dn, j[0].map_up, j[0].map_dn, j[1])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    slater = generate_slater(Molecule(atom), tmf, mc=mc, tol=1e-9)
    _same_expansion((slater.expansion, slater._det_coeff0), (exp, coeff))
