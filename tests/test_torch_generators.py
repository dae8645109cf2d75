"""The port's last host modules against the JAX package, float64 on the
CPU: the basis and ECP generators (system/basis_fit.py,
system/ecp_generate.py), replicate_jastrow_params (system/supercell.py) on
the diamond's primitive and supercell Jastrows, int_dtype
(utils/dtypes.py), and vmc(profile_phases=True) with
utils/profiling.median_time and measure_phase_split."""

import numpy as np
import pytest
import torch

from pyqmc_tpu.system import basis_fit as jfit
from pyqmc_tpu.system import ecp_generate as jgen
from pyqmc_tpu.system.supercell import get_supercell as j_get_supercell
from pyqmc_tpu.system.supercell import replicate_jastrow_params as j_replicate
from pyqmc_tpu.utils.dtypes import int_dtype as j_int_dtype
from pyqmc_tpu.wftools import generate_jastrow as j_jastrow
from pyqmc_tpu.wftools import generate_jastrow3 as j_jastrow3

from pyqmc_tpu_torch.entry import h2o_setup
from pyqmc_tpu_torch.method.vmc import vmc
from pyqmc_tpu_torch.system import basis_fit, ecp_generate
from pyqmc_tpu_torch.system.basis import parse_nwchem_ecp
from pyqmc_tpu_torch.system.supercell import get_supercell, replicate_jastrow_params
from pyqmc_tpu_torch.utils.dtypes import int_dtype
from pyqmc_tpu_torch.utils.profiling import measure_phase_split, median_time
from pyqmc_tpu_torch.wftools import generate_jastrow, generate_jastrow3

from .torch_parity import diamond_cells

# the all-electron H atom in a small even-tempered s sea: an SCF in
# milliseconds that runs every step of the generators
H_SEA = dict(alpha0=0.1, beta=3.0, n=6)


def test_core_counts_and_spins():
    for ncore in (0, 2, 10, 18):
        assert ecp_generate.core_counts(ncore) == jgen.core_counts(ncore)
    assert ecp_generate.GROUND_SPIN == jgen.GROUND_SPIN
    assert [ecp_generate.cation_spin(z) for z in range(2, 31)] == [
        jgen.cation_spin(z) for z in range(2, 31)]


def test_assemble_form_constraints():
    """The local channel's published-table constraints (n=1 coefficient
    Zeff, n=3 Zeff * alpha1), the nonlocal channels single r^0 gaussians,
    and the same entry as the JAX package's, gamma term included."""
    entry = ecp_generate._assemble_ecp(2, 3.0, 4.5, {0: (2.0, 10.0), 1: (1.5, 5.0)})
    ncore, blocks = entry
    assert ncore == 2
    local = dict(blocks)[-1]
    assert local[1] == [[4.5, 3.0]] and local[3] == [[4.5, 3.0 * 4.5]] and local[2] == []
    assert dict(blocks)[0][2] == [[2.0, 10.0]]
    assert entry == jgen._assemble_ecp(2, 3.0, 4.5, {0: (2.0, 10.0), 1: (1.5, 5.0)})
    args = (10, 6.0, 3.2, {0: (2.2, 14.0)}, 2.7, -1.5)
    assert ecp_generate._assemble_ecp(*args) == jgen._assemble_ecp(*args)


def test_nwchem_round_trip():
    """to_nwchem's text parses back (the port's parse_nwchem_ecp) to the
    entry, and is the JAX package's text."""
    entry = ecp_generate._assemble_ecp(10, 6.0, 3.2, {0: (2.2, 14.0), 1: (1.9, 7.5)})
    text = ecp_generate.to_nwchem("S", entry)
    assert text == jgen.to_nwchem("S", entry)
    ncore, blocks = parse_nwchem_ecp("ECP\n" + text + "\nEND")["S"]
    assert ncore == 10
    bd = dict(blocks)
    np.testing.assert_allclose(bd[-1][1], [[3.2, 6.0]])
    np.testing.assert_allclose(bd[-1][3], [[3.2, 19.2]])
    np.testing.assert_allclose(bd[0][2], [[2.2, 14.0]])
    np.testing.assert_allclose(bd[1][2], [[1.9, 7.5]])


def test_pseudo_atom_levels_match_jax():
    """The H atom's 1s level (eigenvalue and <r>, from the port's eval_gto
    on the radial grid) and energy against the JAX package, 1e-9."""
    sea = basis_fit.even_tempered_sea([0], **H_SEA)
    assert sea == jfit.even_tempered_sea([0], **H_SEA)
    got, e = ecp_generate.pseudo_atom_levels("H", None, 0, 1, sea=sea)
    want, je = jgen.pseudo_atom_levels("H", None, 0, 1, sea=sea)
    assert set(got) == set(want) == {0}
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]), atol=1e-9)
    assert abs(e - je) < 1e-9
    assert abs(got[0][0][1] - 1.5) < 0.05  # <r> of the hydrogen 1s: 1.5 bohr


def test_basis_fit_matches_jax():
    """fit_atomic_valence_basis on the H atom (the 1s contraction, its
    second zeta, a free p): the same contracted basis and diagnostics as
    the JAX package's, 1e-9."""
    kw = dict(ecp=None, spin=1, occ_l=(0,), free_exps={1: [0.8]}, sea_kwargs=H_SEA)
    basis, info = basis_fit.fit_atomic_valence_basis("H", **kw)
    jbasis, jinfo = jfit.fit_atomic_valence_basis("H", **kw)
    assert [sh[0] for sh in basis] == [sh[0] for sh in jbasis] == [0, 0, 1]
    for sh, jsh in zip(basis, jbasis):
        np.testing.assert_allclose(np.asarray(sh[1:]), np.asarray(jsh[1:]), atol=1e-9)
    for k in info:
        assert info[k] == pytest.approx(jinfo[k], abs=1e-9), k
    assert info["basis_error"] >= -1e-9


def test_replicate_jastrow_params_on_diamond():
    """The primitive cell's two- and three-body Jastrow coefficients tiled
    over the 2x2x2 supercell's 16 atoms, translation-major, as the JAX
    package tiles them."""
    jcell, _, tcell = diamond_cells()
    S = 2 * np.eye(3, dtype=int)
    jsup, tsup = j_get_supercell(jcell, S), get_supercell(tcell, S)
    rng = np.random.default_rng(9)
    for tmake, jmake in ((generate_jastrow, j_jastrow), (generate_jastrow3, j_jastrow3)):
        tprim, tsuper = tmake(tcell)[0], tmake(tsup)[0]
        jprim, jsuper = jmake(jcell)[0], jmake(jsup)[0]
        assert (tprim.natom, tsuper.natom) == (2, 16)
        tparams = tprim.make_params(device="cpu", dtype=torch.float64)
        tparams = {k: torch.as_tensor(rng.normal(size=v.shape)) for k, v in tparams.items()}
        got = replicate_jastrow_params(tprim, tsuper, tparams)
        want = j_replicate(jprim, jsuper, {k: v.numpy() for k, v in tparams.items()})
        assert set(got) == set(want)
        for k in got:
            assert got[k].shape == tsuper.make_params(device="cpu")[k].shape
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        key = "acoeff" if "acoeff" in got else "ccoeff"
        for rep in range(8):  # replica rep of atom I is atom 2 rep + I
            np.testing.assert_array_equal(got[key][2 * rep:2 * rep + 2].numpy(),
                                          tparams[key].numpy())


def test_int_dtype():
    """int32 beside float32 (and on a CUDA device), int64 beside float64,
    as the JAX package's int_dtype under x64 gives int64."""
    assert int_dtype(torch.float32) == int_dtype(torch.complex64) == torch.int32
    assert int_dtype(torch.float64) == int_dtype(torch.complex128) == torch.int64
    assert int_dtype("cpu") == torch.int64
    assert int_dtype(torch.device("cuda")) == torch.int32
    assert str(int_dtype(torch.float64)).split(".")[-1] == np.dtype(j_int_dtype()).name


def test_profile_phases():
    """vmc(profile_phases=True) attaches the move and accumulate times to
    every block, non-negative, with "block time"; median_time and
    measure_phase_split on their own."""
    mol, wf, params, configs, acc = h2o_setup(4, device="cpu")
    data, _ = vmc(wf, params, configs, nblocks=2, nsteps_per_block=2, accumulators=acc,
                  generator=torch.Generator().manual_seed(5), profile_phases=True)
    for d in data:
        for k in ("move time", "accumulate time", "block time"):
            assert k in d and d[k] >= 0.0, k
    assert data[0]["move time"] == data[1]["move time"]
    calls = []
    assert median_time(lambda x: calls.append(x), 1, nrep=3) >= 0.0 and len(calls) == 4
    split = measure_phase_split(lambda: sum(range(20000)), lambda: None, ())
    assert split["move time"] <= split["block time"]
    assert split["accumulate time"] == pytest.approx(split["block time"] - split["move time"])
