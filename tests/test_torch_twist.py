"""The port's complex (general-twist) path and twist averaging against the
JAX package, float64, on shared numpy inputs.

Systems: the Li 2x2x2 supercell (16 Li, 16 electrons, 268 replicated-shell
AOs) at the shifted twist of tests/integration/test_pair_slater.py, two
orbitals per k-point, with that file's 3-determinant expansion; the
complex molecular H2 of tests/unit/test_complex_slater.py; the diamond-C
union mesh of BASELINE config 5 for the twist grouping.

- complex KPointOrbitals, modes 0, 1, 2 and eval_mo_t, against the JAX
  package's complex `eval` and its real-pair `eval_pair` (1e-10), and the
  Bloch phase across a lattice translation;
- the complex Slater (the twist expansion and the molecular H2): state,
  value, ratios, gradients, laplacians, testvalue_many, updateinternals and
  the holomorphic pgradient (1e-10, relative for the large entries), then
  testwf.run_all;
- the complex local kinetic energy (ke, grad2, ke_im) and ECP energy (its
  real and imaginary parts, downselected) on shared rotations (1e-10);
- a 2-step VMC block of the twist Slater-Jastrow and a 1-step DMC block
  with T-moves of the twist Slater, both with Ewald and the downselected
  ECP, against the JAX blocks on the same streams (1e-9; the acceptance
  exactly as a mean of the same accepted moves);
- create_supercell_twists and build_twist_wf against the JAX package on
  the diamond union mesh (two twists; real mode only at the TRIM one), and
  twist_average_vmc's averaging rule on the Li primitive cell's 8 twists.

JAX functions run once each are compiled with XLA's backend optimisation
off (torch_parity.jrun / compile_quick).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyqmc_tpu.configs import Geometry as JGeometry
from pyqmc_tpu.method import dmc as jdmc
from pyqmc_tpu.method.vmc import make_vmc_block as j_make_vmc_block
from pyqmc_tpu.models.jastrow import JastrowSpin as JJastrow
from pyqmc_tpu.models.multiply import MultiplyWF as JMultiply
from pyqmc_tpu.models.orbitals import KPointOrbitals as JKOrb
from pyqmc_tpu.models.slater import DeterminantExpansion as JExpansion
from pyqmc_tpu.models.slater import Slater as JSlater
from pyqmc_tpu.observables.accumulators import EnergyAccumulator as JEnergy
from pyqmc_tpu.observables.ecp import ECPAccumulator as JECP
from pyqmc_tpu.observables.ecp import random_rotations
from pyqmc_tpu.observables.energy import kinetic_energy as j_kinetic
from pyqmc_tpu.system.supercell import get_supercell as j_get_supercell
from pyqmc_tpu.wftools import default_jastrow_basis as j_jastrow_basis

from pyqmc_tpu_torch.configs import Geometry, initial_guess
from pyqmc_tpu_torch.convert import dmc_streams_from_numpy, params_from_numpy
from pyqmc_tpu_torch.method import dmc as tdmc
from pyqmc_tpu_torch.method.vmc import make_vmc_block
from pyqmc_tpu_torch.models import testwf
from pyqmc_tpu_torch.models.jastrow import JastrowSpin
from pyqmc_tpu_torch.models.multiply import MultiplyWF
from pyqmc_tpu_torch.models.orbitals import KPointOrbitals
from pyqmc_tpu_torch.models.slater import DeterminantExpansion, Slater
from pyqmc_tpu_torch.observables.accumulators import EnergyAccumulator
from pyqmc_tpu_torch.observables.ecp import ECPAccumulator
from pyqmc_tpu_torch.observables.energy import kinetic_energy
from pyqmc_tpu_torch.system.io import load_cell_npz
from pyqmc_tpu_torch.system.supercell import get_supercell
from pyqmc_tpu_torch.wftools import default_jastrow_basis

from .fixtures_pbc import FILES, load_cell
from .torch_parity import (F64, assert_trees_close, jax_ecp_draws, jax_ecp_streams, jrun,
                           port_molecule)

LI_TWIST = np.array([0.027, -0.011, 0.019])  # tests/integration/test_pair_slater.py:22
NCONF = 4


def t64(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def to_port(tree):
    return params_from_numpy(jax.device_get(tree), device="cpu", dtype=F64)


@functools.lru_cache(maxsize=None)
def li_twist():
    """The Li supercell at the shifted twist on both sides: (jax supercell,
    jax orbitals, port supercell, port orbitals, expansion arrays)."""
    jcell, d = load_cell("li_cubic_ccecp")
    tcell, _ = load_cell_npz(os.path.join(FILES, "li_cubic_ccecp.npz"))
    kpts = np.asarray(d["kpts"]) + LI_TWIST
    blocks = [np.asarray(d["mo_coeff"][k])[:, :2] for k in range(8)]
    S = 2 * np.eye(3, dtype=int)
    jorb = JKOrb(jcell, kpts, (blocks, blocks), realify=False)
    torb = KPointOrbitals(tcell, kpts, (blocks, blocks), realify=False)
    ground = np.arange(0, 16, 2)
    exc = ground.copy()
    exc[0] = 1
    occ = np.stack([ground, exc])
    exp = {"occ_up": occ, "occ_dn": occ, "map_up": np.array([0, 1, 0]),
           "map_dn": np.array([0, 0, 1])}
    return j_get_supercell(jcell, S), jorb, get_supercell(tcell, S), torb, exp


@functools.lru_cache(maxsize=None)
def li_slaters():
    """The 3-determinant twist Slater on both sides (det_coeff 0.9, 0.3,
    -0.2): (jax Slater, jax params, port Slater, port params)."""
    jsup, jorb, tsup, torb, exp = li_twist()
    coeff = np.array([0.9, 0.3, -0.2])
    jsl = JSlater(jsup, jorb, JExpansion(**exp), det_coeff=coeff)
    tsl = Slater(tsup, torb, DeterminantExpansion(**exp), det_coeff=coeff)
    jp = jsl.make_params()
    return jsl, jp, tsl, to_port(jp)


@functools.lru_cache(maxsize=None)
def li_sj():
    """The single determinant at the twist (the first orbital of every
    k-point, as build_twist_wf occupies them) times the default periodic
    Jastrow (seeded nonzero coefficients) on both sides: (jax wf, jax
    params, port wf, port params)."""
    jsup, jorb, tsup, torb, _ = li_twist()
    jcell, d = load_cell("li_cubic_ccecp")
    blocks = [np.asarray(d["mo_coeff"][k])[:, :1] for k in range(8)]
    jsl = JSlater(jsup, JKOrb(jcell, jorb.kpts, (blocks, blocks), realify=False),
                  JExpansion.single(8, 8))
    tsl = Slater(tsup, KPointOrbitals(tsup.original_cell, torb.kpts, (blocks, blocks),
                                      realify=False), DeterminantExpansion.single(8, 8))
    ja, jb = j_jastrow_basis(jsup)
    ta, tb = default_jastrow_basis(tsup)
    jwf = JMultiply(jsl, JJastrow(jsup, a_basis=ja, b_basis=jb))
    twf = MultiplyWF(tsl, JastrowSpin(tsup, a_basis=ta, b_basis=tb))
    jp = jwf.make_params()
    rng = np.random.default_rng(11)
    jp["wf1"]["acoeff"] = jnp.asarray(rng.normal(scale=0.1, size=jp["wf1"]["acoeff"].shape))
    jp["wf1"]["bcoeff"] = jp["wf1"]["bcoeff"] + jnp.asarray(
        rng.normal(scale=0.05, size=jp["wf1"]["bcoeff"].shape))
    return jwf, jp, twf, to_port(jp)


def li_walkers(seed, nconf=NCONF):
    """Each electron near its own Li atom (within about 1 bohr), where the
    nonlocal ECP is felt."""
    rng = np.random.default_rng(seed)
    atoms = np.asarray(li_twist()[0].atom_coords)
    return atoms[rng.permutation(16)] + rng.normal(scale=0.6, size=(nconf, 16, 3))


def test_complex_kpoint_orbitals():
    """Modes 0, 1, 2 and eval_mo_t at 24 points spread over the supercell
    against the JAX package's complex eval and its real pairs."""
    jsup, jorb, _, torb, _ = li_twist()
    assert not torb.real_mode and not jorb.real_mode and torb.is_complex
    assert torb._repl_spec.nao == jorb._repl_spec.nao == 268
    np.testing.assert_allclose(torb._repl_phase, jorb._repl_phase_c, atol=1e-14)
    X = np.random.default_rng(5).uniform(-0.2, 2.2, size=(24, 3)) @ jorb.lattice
    jp, jpair = jorb.make_params(), jorb.make_pair_params()
    tp = to_port(jp)
    assert tp["mo_coeff_alpha"][0].dtype == torch.complex128

    def jax_side(p, pp, x):
        return ([jorb.eval(p, x, m) for m in (0, 1, 2)], jorb.eval_pair(pp, x, 2))

    out_j, pair_j = jrun("twist_orbitals", jax_side, jp, jpair, jnp.asarray(X))
    out_t = [torb.eval(tp, t64(X), m) for m in (0, 1, 2)]
    assert all(m.dtype == torch.complex128 for m in out_t[2])
    assert_trees_close(out_t, out_j, atol=1e-10)
    # the pair path: (re, im) of each spin per slot, from [Re R | Im R]
    pair_t = [f(m) for m in out_t[2] for f in (torch.real, torch.imag)]
    assert_trees_close(pair_t, pair_j, atol=1e-10)
    mo_t = torb.eval_mo_t(tp, t64(X))
    np.testing.assert_allclose(mo_t.numpy(), np.concatenate(
        [np.asarray(out_j[0][0]), np.asarray(out_j[0][1])], axis=-1).T, atol=1e-10)
    # Bloch continuity across the cell (tests/integration/test_pbc.py:141):
    # psi_k(r + L) = e^{i k.L} psi_k(r), so the wrap phase and the image
    # phases agree in sign
    L = jorb.lattice[0] + 2 * jorb.lattice[2]
    phases = np.exp(1j * torb.kpts @ L)[torb._korb[:torb.norb[0]]]
    np.testing.assert_allclose(torb.eval(tp, t64(X + L), 0)[0].numpy(),
                               out_t[0][0].numpy() * phases[None, :], rtol=1e-8, atol=1e-10)


def _slater_checks(jsl, jp, tsl, tp, pos, es, tag):
    """state, value, testvalue, gradient_value, gradient_laplacian,
    testvalue_many (electrons es, each at its own displaced point),
    updateinternals (es[0] moved on every other walker) and pgradient of one
    Slater against the JAX package's, whose side is one compiled function."""
    rng = np.random.default_rng(7)
    epos = [pos[:, e] + rng.normal(scale=0.5, size=pos[:, e].shape) for e in es]
    upos = pos[:, es[0]] + rng.normal(scale=0.3, size=pos[:, es[0]].shape)
    mask = np.arange(pos.shape[0]) % 2 == 0

    def jax_side(p, x, ex, ux, m):
        s = jsl.recompute(p, x)
        ratios = [(jsl.testvalue(p, s, e, y)[0], jsl.gradient_value(p, s, e, y)[:2],
                   jsl.gradient_laplacian(p, s, e, y), jsl.testvalue_many(p, s, y))
                  for e, y in zip(es, ex)]
        _, _, saved = jsl.gradient_value(p, s, es[0], ux)
        return (s, jsl.value(p, s), ratios, jsl.updateinternals(p, s, es[0], ux, m, saved),
                jsl.pgradient(p, x))

    js, val_j, ratios_j, us_j, g_j = jrun(tag, jax_side, jp, jnp.asarray(pos),
                                          [jnp.asarray(y) for y in epos], jnp.asarray(upos),
                                          jnp.asarray(mask))
    ts = tsl.recompute(tp, t64(pos))
    assert ts.inv_up.dtype == torch.complex128 and ts.logdet_up.dtype == F64
    assert_trees_close(ts, js, atol=1e-9, rtol=1e-9)
    assert_trees_close(tsl.value(tp, ts), val_j, atol=1e-10)
    for e, y, out_j in zip(es, epos, ratios_j):
        y = t64(y)
        out_t = (tsl.testvalue(tp, ts, e, y)[0], tsl.gradient_value(tp, ts, e, y)[:2],
                 tsl.gradient_laplacian(tp, ts, e, y), tsl.testvalue_many(tp, ts, y))
        assert_trees_close(out_t, out_j, atol=1e-10, rtol=1e-10)
        assert float(torch.max(torch.abs(out_t[0].imag))) > 1e-4
    _, _, saved = tsl.gradient_value(tp, ts, es[0], t64(upos))
    us_t = tsl.updateinternals(tp, ts, es[0], t64(upos), torch.as_tensor(mask), saved)
    assert_trees_close(us_t, us_j, atol=1e-9, rtol=1e-9)
    g_t = tsl.pgradient(tp, t64(pos))
    assert g_t["det_coeff"].dtype == torch.complex128
    assert_trees_close(g_t, g_j, atol=1e-10, rtol=1e-10)


def test_twist_multidet_slater_matches_jax():
    """The 3-determinant expansion at the twist (test_pair_slater.py:17-40)
    against the JAX package's complex Slater, then testwf.run_all."""
    jsl, jp, tsl, tp = li_slaters()
    assert tsl.is_complex and not tsl._first_n
    _slater_checks(jsl, jp, tsl, tp, li_walkers(3), (0, 15), "li")
    tsup = li_twist()[2]
    configs = initial_guess(tsup, 3, generator=torch.Generator().manual_seed(4), device="cpu",
                            dtype=F64)
    testwf.run_all(tsl, tp, configs, torch.Generator().manual_seed(5))


@functools.lru_cache(maxsize=None)
def h2_complex():
    """tests/unit/test_complex_slater.py's H2: SCF coefficients rotated into
    the complex plane with seeded noise; (jax Slater, jax params, port
    molecule, port Slater, port params)."""
    from pyqmc_tpu.system.mole import Molecule
    from pyqmc_tpu.system.scf import run_scf

    jmol = Molecule("H 0 0 0; H 0 0 1.4", basis="sto-3g")
    mf = run_scf(jmol)
    rng = np.random.default_rng(3)
    nup, ndn = jmol.nelec
    ca = np.asarray(mf.mo_coeff[0][:, :nup])
    cb = np.asarray(mf.mo_coeff[1][:, :ndn])
    ca = ca * np.exp(0.3j) + (rng.random(ca.shape) - 0.5) * 0.2j
    cb = cb * np.exp(-0.2j) + (rng.random(cb.shape) - 0.5) * 0.2j
    jsl = JSlater(jmol, None, JExpansion.single(nup, ndn), mo_coeff=(ca, cb))
    tmol = port_molecule(jmol)
    tsl = Slater(tmol, None, DeterminantExpansion.single(nup, ndn), mo_coeff=(ca, cb))
    jp = jsl.make_params()
    return jsl, jp, tmol, tsl, to_port(jp)


def test_complex_molecular_slater_matches_jax():
    """The complex molecular H2: the same checks, run_all, and K1's gate
    (the molecular kernels are real) rejects it. convert.py carries complex
    leaves across: the coefficients, a complex det_coeff, and a complex
    state (inverses and phases complex, log|det| real)."""
    from pyqmc_tpu_torch.convert import slater_state_from_numpy
    from pyqmc_tpu_torch.ops.move_sweep import _match_sj

    jsl, jp, tmol, tsl, tp = h2_complex()
    assert tsl.is_complex and tp["mo_coeff_alpha"].dtype == torch.complex128
    assert _match_sj(tsl, Geometry(None)) is None
    pos = np.random.default_rng(9).normal(scale=1.0, size=(6, 2, 3))
    _slater_checks(jsl, jp, tsl, tp, pos, (0, 1), "h2")
    # a complex det_coeff, and the JAX state converted
    jp2 = dict(jp, det_coeff=jnp.asarray([0.6 - 0.8j]))
    tp2 = to_port(jp2)
    assert tp2["det_coeff"].dtype == torch.complex128
    js, val_j = jrun("h2_value", lambda p, x: (jsl.recompute(p, x), jsl.value(p, jsl.recompute(
        p, x))), jp2, jnp.asarray(pos))
    ts = slater_state_from_numpy(jax.device_get(js), device="cpu", dtype=F64)
    assert ts.inv_up.dtype == torch.complex128 and ts.logdet_up.dtype == F64
    assert_trees_close(ts, tsl.recompute(tp2, t64(pos)), atol=1e-10, rtol=1e-10)
    assert_trees_close(tsl.value(tp2, ts), val_j, atol=1e-10)
    configs = initial_guess(tmol, 8, generator=torch.Generator().manual_seed(0), device="cpu",
                            dtype=F64)
    testwf.run_all(tsl, tp, configs, torch.Generator().manual_seed(1))


def test_complex_energies_match_jax():
    """The kinetic energy (ke, grad2, ke_im) and the downselected ECP
    energy with its imaginary part, of the twist Slater-Jastrow at shared
    rotations and selection uniforms."""
    jwf, jp, twf, tp = li_sj()
    jsup, _, tsup, _, _ = li_twist()
    pos = li_walkers(13)
    jecp, jdense = JECP(jsup), JECP(jsup, nselect=None)
    tecp, tdense = ECPAccumulator(tsup), ECPAccumulator(tsup, nselect=None)
    assert tecp.nselect == jecp.nselect == 24 and tecp.nq_total == 96
    key = jax.random.PRNGKey(14)

    def jax_side(p, x):
        s = jwf.recompute(p, x)
        return (j_kinetic(jwf, p, s, x, with_imag=True), jecp(jwf, p, s, x, key, with_imag=True),
                jdense(jwf, p, s, x, key, with_imag=True))

    ke_j, ecp_j, dense_j = jrun("li_energies", jax_side, jp, jnp.asarray(pos))
    ts = twf.recompute(tp, t64(pos))
    ke_t = kinetic_energy(twf, tp, ts, t64(pos), with_imag=True)
    rot, u = jax_ecp_streams(key, 16, NCONF)
    ecp_t = tecp(twf, tp, ts, t64(pos), t64(rot), t64(u), with_imag=True)
    dense_t = tdense(twf, tp, ts, t64(pos), t64(rot), with_imag=True)
    assert all(x.dtype == F64 for x in ke_t + ecp_t + dense_t)
    assert_trees_close((ke_t, ecp_t, dense_t), (ke_j, ecp_j, dense_j), atol=1e-10, rtol=1e-10)
    assert float(torch.min(torch.abs(ke_t[2]))) > 1e-6 and float(torch.max(torch.abs(ecp_t[1]))) > 1e-6
    # the accumulator: total_im only when asked, the real energy the same
    acc = EnergyAccumulator(tsup, ecp_acc=tecp)
    d = acc(twf, tp, ts, t64(pos), t64(rot), t64(u), with_imag=True)
    np.testing.assert_allclose(d["total_im"].numpy(), (ke_t[2] + ecp_t[1]).numpy(), atol=1e-12)
    assert "total_im" not in acc(twf, tp, ts, t64(pos), t64(rot), t64(u))


NSTEPS_VMC, NSTEPS_DMC, TSTEP_VMC, TSTEP_DMC = 2, 1, 0.5, 0.02


def test_twist_vmc_block_matches_jax():
    """A 2-step VMC block of the twist Slater-Jastrow (plain complex sweep,
    Ewald, downselected ECP) against make_vmc_block(fused=False) on the
    JAX block's own draws."""
    jwf, jp, twf, tp = li_sj()
    jsup, _, tsup, _, _ = li_twist()
    pos = li_walkers(21)
    key = jax.random.PRNGKey(22)
    zeros = np.zeros((NCONF, 16, 3), np.int32)
    block = j_make_vmc_block(jwf, {"energy": JEnergy(jsup)}, JGeometry(jsup.lattice),
                             tstep=TSTEP_VMC, nsteps=NSTEPS_VMC, fused=False)

    def draws(k):
        """The block's draws (method/vmc.py: gauss, unif, then per step the
        ECP's rotations and selection uniforms)."""
        kg, ku, ka = jax.random.split(k, 3)
        rot, u = jax.vmap(lambda kk: jax_ecp_draws(kk, 16, NCONF))(
            jax.random.split(ka, NSTEPS_VMC))
        return {"gauss": jax.random.normal(kg, (NSTEPS_VMC, 16, NCONF, 3), jnp.float64)
                * jnp.sqrt(TSTEP_VMC),
                "unif": jax.random.uniform(ku, (NSTEPS_VMC, 16, NCONF), jnp.float64),
                "rot": rot, "u_sel": u}

    (p_j, w_j, avg_j), streams = jrun(
        "li_vmc_block", lambda p, x, w, k: (block(p, x, w, k), draws(k)), jp, jnp.asarray(pos),
        jnp.asarray(zeros), key)
    tblock = make_vmc_block(twf, {"energy": EnergyAccumulator(tsup)}, Geometry(tsup.lattice),
                            tstep=TSTEP_VMC, nsteps=NSTEPS_VMC)
    p_t, w_t, avg_t = tblock(tp, t64(pos), torch.as_tensor(zeros), None,
                             {k: t64(v) for k, v in streams.items()})
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=1e-9)
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))
    assert set(avg_t) == set(avg_j)
    for k in avg_j:
        np.testing.assert_allclose(float(avg_t[k]), float(avg_j[k]), atol=1e-9, rtol=1e-9,
                                   err_msg=k)
    assert float(avg_t["acceptance"]) == float(avg_j["acceptance"])
    assert 0.1 < float(avg_t["acceptance"]) < 1.0


def _jax_dmc_draws(key, nsteps, nelec, nconf):
    """The draws of method/dmc.py's block with a downselecting ECP (as
    tests/test_torch_pbc_dmc.py:_jax_pbc_dmc_draws)."""
    kg, ku, kt, ke, _ = jax.random.split(key, 5)
    ekeys = jax.random.split(ke, nsteps)
    kt1, kt2, kt3 = jax.random.split(kt, 3)
    tqkeys = jax.random.split(kt1, nsteps * nelec).reshape((nsteps, nelec) + kt1.shape)
    erot0, esel0 = jax_ecp_draws(jax.random.fold_in(key, 999), nelec, nconf)
    erot, esel = jax.vmap(lambda k: jax_ecp_draws(k, nelec, nconf))(ekeys)
    return {
        "gauss": jax.random.normal(kg, (nsteps, nelec, nconf, 3), jnp.float64) * jnp.sqrt(TSTEP_DMC),
        "unif": jax.random.uniform(ku, (nsteps, nelec, nconf), jnp.float64),
        "erot": erot, "esel": esel, "erot0": erot0, "esel0": esel0,
        "tqrot": jax.vmap(jax.vmap(lambda k: random_rotations(k, (nconf,))))(tqkeys),
        "u_sel": jax.random.uniform(kt2, (nsteps, nelec, nconf), jnp.float64),
        "u_acc": jax.random.uniform(kt3, (nsteps, nelec, nconf), jnp.float64),
    }


def test_twist_dmc_block_matches_jax():
    """A 1-step DMC block with T-moves of the twist Slater (weights from
    Re(ratio), no node rejection for a complex ratio, drift from Re(g))
    against the JAX block on its own draws; the VMC block holds the product
    with the Jastrow."""
    jwf, jp, twf, tp = li_sj()
    jwf, jp, twf, tp = jwf.wfs[0], jp["wf0"], twf.wfs[0], tp["wf0"]
    jsup, _, tsup, _, _ = li_twist()
    pos = li_walkers(31)
    weights = np.random.default_rng(32).uniform(0.8, 1.2, size=NCONF)
    e_trial, e_est, esigma = -3.0, -2.9, 0.5
    key = jax.random.PRNGKey(33)
    zeros = np.zeros((NCONF, 16, 3), np.int32)
    block, _ = jdmc.make_dmc_block(jwf, JEnergy(jsup), JGeometry(jsup.lattice), TSTEP_DMC,
                                   NSTEPS_DMC, tmoves=True, fused=False)
    jargs = (jp, jnp.asarray(pos), jnp.asarray(zeros), jnp.asarray(weights), key,
             jnp.float64(e_trial), jnp.float64(e_est), jnp.float64(esigma))
    (p_j, w_j, wt_j, avg_j), draws = jrun(
        "li_dmc_block", lambda *a: (block(*a), _jax_dmc_draws(a[4], NSTEPS_DMC, 16, NCONF)),
        *jargs)
    streams = dmc_streams_from_numpy({k: np.asarray(v) for k, v in draws.items()}, device="cpu",
                                     dtype=F64)
    tblock, _ = tdmc.make_dmc_block(twf, EnergyAccumulator(tsup), Geometry(tsup.lattice),
                                    TSTEP_DMC, NSTEPS_DMC)
    p_t, w_t, wt_t, avg_t = tblock(tp, t64(pos), torch.as_tensor(zeros), t64(weights), None,
                                   t64(e_trial), t64(e_est), t64(esigma), streams=streams)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=1e-9)
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))
    np.testing.assert_allclose(wt_t.numpy(), np.asarray(wt_j), rtol=1e-9)
    assert set(avg_t) == set(avg_j)
    for k in avg_j:
        np.testing.assert_allclose(float(avg_t[k]), float(avg_j[k]), atol=1e-9, rtol=1e-9,
                                   err_msg=k)
    assert float(avg_t["acceptance"]) == float(avg_j["acceptance"])
    assert abs(float(avg_t["energyecp"])) > 1e-2 and float(avg_t["acceptance"]) < 1.0
    # some T-move was taken: without the T-move sweep the chain differs
    p_n = tdmc.make_dmc_block(twf, EnergyAccumulator(tsup), Geometry(tsup.lattice), TSTEP_DMC,
                              NSTEPS_DMC, tmoves=False)[0](
        tp, t64(pos), torch.as_tensor(zeros), t64(weights), None, t64(e_trial), t64(e_est),
        t64(esigma), streams=streams)[0]
    assert bool(torch.any(torch.abs(p_n - p_t) > 1e-3))


def test_supercell_twists_and_twist_wf_match_jax():
    """create_supercell_twists on the diamond union mesh (two twists) and
    on the Li primitive mesh (eight), and build_twist_wf's k-points,
    occupations and real_mode flags against the JAX package's."""
    from pyqmc_tpu.method.twist_average import build_twist_wf as j_build
    from pyqmc_tpu.system.supercell import create_supercell_twists as j_twists

    from pyqmc_tpu_torch.entry import TWIST, diamond_twist_average_setup
    from pyqmc_tpu_torch.method.twist_average import build_twist_wf
    from pyqmc_tpu_torch.system.supercell import create_supercell_twists

    sup, args = diamond_twist_average_setup(2, device="cpu")
    jcell, d = load_cell("diamond_primitive")
    jsup = j_get_supercell(jcell, 2 * np.eye(3, dtype=int))
    mesh = np.concatenate([d["kpts"], d["kpts"] + TWIST])
    np.testing.assert_array_equal(args["kpts"], mesh)
    tw_t, tw_j = create_supercell_twists(sup, mesh), j_twists(jsup, mesh)
    assert len(tw_t) == 2 and list(tw_t) == list(tw_j)
    for key in tw_j:
        np.testing.assert_array_equal(tw_t[key], tw_j[key])
        jw = j_build(jcell, jsup, mesh, args["mo_coeff"], args["mo_occ"], tw_j[key])
        tw = build_twist_wf(args["cell"], sup, mesh, args["mo_coeff"], args["mo_occ"], tw_t[key])
        assert tw.orbitals.real_mode == jw.orbitals.real_mode == (key == (0.0, 0.0, 0.0))
        np.testing.assert_allclose(tw.orbitals.kpts, jw.orbitals.kpts, atol=0)
        assert tw.orbitals.norb == jw.orbitals.norb == (32, 32)
    lcell, ld = load_cell("li_cubic_ccecp")
    lsup = get_supercell(li_twist()[2].original_cell, np.eye(3, dtype=int))
    lt = create_supercell_twists(lsup, ld["kpts"])
    lj = j_twists(j_get_supercell(lcell, np.eye(3, dtype=int)), ld["kpts"])
    assert len(lt) == 8 and {k: v.tolist() for k, v in lt.items()} == \
        {k: v.tolist() for k, v in lj.items()}


def test_twist_average_vmc_rule():
    """twist_average_vmc on the Li primitive cell's 8 TRIM twists (every
    twist in real mode), 4 walkers, 4 blocks of 2 steps: one record per
    twist in sorted order, and each average the equal-weight mean over the
    twists of their blocks after the first (max(1, 4 // 4))."""
    from pyqmc_tpu_torch.method.twist_average import twist_average_vmc

    _, _, tsup, _, _ = li_twist()
    cell = tsup.original_cell
    sup = get_supercell(cell, np.eye(3, dtype=int))
    _, d = load_cell("li_cubic_ccecp")
    mo = ([np.asarray(d["mo_coeff"][k]) for k in range(8)],) * 2
    occ = ([np.asarray(d["mo_occ"][k]) / 2.0 for k in range(8)],) * 2
    records, avg = twist_average_vmc(
        cell, sup, d["kpts"], mo, occ,
        lambda ti: initial_guess(sup, 4, generator=torch.Generator().manual_seed(100 + ti),
                                 device="cpu", dtype=F64),
        generator=torch.Generator().manual_seed(0),
        accumulators_factory=lambda: {"energy": EnergyAccumulator(sup)}, device="cpu",
        nblocks=4, nsteps_per_block=2, tstep=1.0)
    assert len(records) == 8 and all(r["real_mode"] for r in records)
    assert [r["twist"] for r in records] == sorted(r["twist"] for r in records)
    expect = np.mean([np.mean([b["energytotal"] for b in r["data"][1:]]) for r in records])
    assert np.isfinite(avg["energytotal"])
    assert avg["energytotal"] == pytest.approx(expect, rel=1e-12)
    per_twist = [np.mean([b["energytotal"] for b in r["data"][1:]]) for r in records]
    assert np.std(per_twist) > 1e-4
