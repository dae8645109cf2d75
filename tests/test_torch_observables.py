"""The observables of pyqmc_tpu_torch against the JAX package, float64 on the
CPU, on the same numpy inputs: the one- and two-body density matrices
(molecular and k-point), S^2, S(q) and the symmetry accumulator, a VMC
block with an OBDM and accumulate_every, and a DMC block's further
accumulators on their own streams.

The JAX accumulators draw their auxiliary points from a key; each JAX side
here returns the points it drew, and the port takes them as its draws.
Each JAX side is one compiled function (torch_parity.jrun).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pyqmc_tpu.configs import Geometry as JGeometry
from pyqmc_tpu.method.vmc import make_vmc_block as j_make_vmc_block
from pyqmc_tpu.observables import obdm as jobdm
from pyqmc_tpu.observables import tbdm as jtbdm
from pyqmc_tpu.observables.s2 import S2Accumulator as JS2
from pyqmc_tpu.observables.sq import SqAccumulator as JSq
from pyqmc_tpu.observables.symmetry import SymmetryAccumulator as JSym
from pyqmc_tpu.system.mole import Molecule as JMolecule
from pyqmc_tpu.system.scf import run_scf

from pyqmc_tpu_torch.configs import Geometry, initial_guess
from pyqmc_tpu_torch.method import dmc as tdmc
from pyqmc_tpu_torch.method.vmc import make_vmc_block, vmc
from pyqmc_tpu_torch.models.slater import DeterminantExpansion, Slater
from pyqmc_tpu_torch.observables import obdm, tbdm
from pyqmc_tpu_torch.observables.accumulators import EnergyAccumulator
from pyqmc_tpu_torch.observables.s2 import S2Accumulator
from pyqmc_tpu_torch.observables.sq import SqAccumulator
from pyqmc_tpu_torch.observables.symmetry import SymmetryAccumulator

from .test_torch_twist import li_slaters, li_twist, li_walkers
from .torch_parity import (F64, h2o_pair, h2o_params, h2o_wf_objects, jrun, port_molecule,
                           walkers)

NCONF = 5
NCAS = 5  # the two-body matrices' orbitals in the parity checks
IJKL = np.array([[0, 0, 0, 0], [1, 2, 1, 2], [0, 3, 4, 1], [4, 4, 2, 2]])
SYM = [np.diag([-1.0, -1.0, 1.0]), np.diag([1.0, -1.0, 1.0]), np.diag([-1.0, 1.0, 1.0])]
QLIST = np.array([[0.7, 0.0, 0.0], [0.3, -0.4, 1.1], [2.0, 1.0, -0.5]])


def t64(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def close(t, j, tol=1e-9, msg=""):
    """t against j to tol, relative to the larger of 1 and j's largest entry
    (the density matrices' entries span four orders of magnitude, through
    1 / q)."""
    j = np.asarray(j)
    scale = max(1.0, float(np.max(np.abs(j)))) if j.size else 1.0
    np.testing.assert_allclose(np.asarray(t), j, rtol=0, atol=tol * scale, err_msg=msg)


def random_rotation(seed):
    q, r = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    return q * np.sign(np.diag(r))


@functools.lru_cache(maxsize=None)
def h2o_accumulators():
    """{name: (jax accumulator, port accumulator)} on H2O."""
    (jmol, jmf), (tmol, tmf) = h2o_pair()
    mo = np.asarray(jmf.mo_coeff[0])
    ops = [SYM[0], random_rotation(3)]
    origin = np.array([0.1, -0.2, 0.3])
    return {
        "obdm": (jobdm.OBDMAccumulator(jmol, mo), obdm.OBDMAccumulator(tmol, mo)),
        "obdm0": (jobdm.OBDMAccumulator(jmol, mo, spin=0),
                  obdm.OBDMAccumulator(tmol, mo, spin=0)),
        "obdm1": (jobdm.OBDMAccumulator(jmol, mo, spin=1),
                  obdm.OBDMAccumulator(tmol, mo, spin=1)),
        "tbdm01": (jtbdm.TBDMAccumulator(jmol, mo[:, :NCAS], spin=(0, 1)),
                   tbdm.TBDMAccumulator(tmol, mo[:, :NCAS], spin=(0, 1))),
        "tbdm00": (jtbdm.TBDMAccumulator(jmol, mo[:, :NCAS], spin=(0, 0), ijkl=IJKL),
                   tbdm.TBDMAccumulator(tmol, mo[:, :NCAS], spin=(0, 0), ijkl=IJKL)),
        "s2": (JS2(jmol), S2Accumulator(tmol)),
        "sq": (JSq(qlist=QLIST), SqAccumulator(qlist=QLIST)),
        "sym": (JSym(jmol, ops, origin=origin, names=["c2z", "rot"]),
                SymmetryAccumulator(tmol, ops, origin=origin, names=["c2z", "rot"])),
    }


def jax_points(acc, key, nconf):
    """The auxiliary points a JAX density-matrix accumulator draws from key."""
    if isinstance(acc, (jtbdm.TBDMAccumulator, jtbdm.KTBDMAccumulator)):
        k1, k2 = jax.random.split(key)
        return {"r1": acc.mixture.sample(k1, nconf, jnp.float64),
                "r2": acc.mixture.sample(k2, nconf, jnp.float64)}
    return {"raux": acc.mixture.sample(key, nconf, jnp.float64)}


def _periodic_points(acc, key, nconf):
    pts = jax_points(acc, key, nconf)
    return {k: v[0] for k, v in pts.items()}


def test_molecular_accumulators_match_jax():
    """One call of each accumulator (the OBDM of spin None, 0 and 1) on the
    same walkers and auxiliary points: every output to 1e-9."""
    rng = np.random.default_rng(21)
    jwf, twf = h2o_wf_objects()
    jp, tp = h2o_params(rng)
    pos = walkers(rng, NCONF)
    accs = h2o_accumulators()

    def jax_side(p, x, key):
        st = jwf.recompute(p, x)
        keys = jax.random.split(key, len(accs))
        out, pts = {}, {}
        for i, (name, (ja, _)) in enumerate(accs.items()):
            out[name] = ja(jwf, p, st, x, keys[i])
            if hasattr(ja, "mixture"):
                pts[name] = jax_points(ja, keys[i], NCONF)
        return out, pts

    out_j, pts_j = jrun("observables_h2o", jax_side, jp, jnp.asarray(pos), jax.random.PRNGKey(4))
    x = t64(pos)
    st = twf.recompute(tp, x)
    for name, (_, ta) in accs.items():
        kw = {"draws": {k: t64(v) for k, v in pts_j[name].items()}} if name in pts_j else {}
        out_t = ta(twf, tp, st, x, **kw)
        assert set(out_t) == set(out_j[name]), name
        for k in out_t:
            close(out_t[k].numpy(), out_j[name][k], msg=f"{name} {k}")


def test_kpoint_density_matrices_match_jax():
    """KOBDM (spin down) and KTBDM (same spins, e1 = e2 left out) of the
    3-determinant Li twist Slater, complex route, against the JAX
    package's complex path to 1e-9."""
    jsl, jp, tsl, tp = li_slaters()
    pos = li_walkers(31, nconf=3)
    jsup, _, tsup, _, _ = li_twist()
    accs = {"kobdm1": (jobdm.KOBDMAccumulator(jsup, jsl.orbitals, spin=1),
                       obdm.KOBDMAccumulator(tsup, tsl.orbitals, spin=1)),
            "ktbdm00": (jtbdm.KTBDMAccumulator(jsup, jsl.orbitals, spin=(0, 0)),
                        tbdm.KTBDMAccumulator(tsup, tsl.orbitals, spin=(0, 0)))}

    def jax_side(p, x, key):
        st = jsl.recompute(p, x)
        keys = jax.random.split(key, len(accs))
        return ({n: ja(jsl, p, st, x, keys[i]) for i, (n, (ja, _)) in enumerate(accs.items())},
                {n: _periodic_points(ja, keys[i], x.shape[0])
                 for i, (n, (ja, _)) in enumerate(accs.items())})

    out_j, pts_j = jrun("observables_li", jax_side, jp, jnp.asarray(pos), jax.random.PRNGKey(8))
    x = t64(pos)
    st = tsl.recompute(tp, x)
    for name, (_, ta) in accs.items():
        out_t = ta(tsl, tp, st, x, draws={k: t64(v) for k, v in pts_j[name].items()})
        assert set(out_t) == set(out_j[name]), name
        for k in out_t:
            close(out_t[k].numpy(), out_j[name][k], msg=f"{name} {k}")
    assert np.max(np.abs(np.asarray(out_j["kobdm1"]["value_im"]))) > 1e-6


def test_vmc_block_accumulate_every_matches_jax():
    """A 3-step VMC block with a spin-up OBDM, accumulated on steps 0 and 2
    (accumulate_every=2), on the JAX block's streams: positions and every
    average to 1e-9."""
    rng = np.random.default_rng(41)
    (jmol, jmf), (tmol, _) = h2o_pair()
    jwf, twf = h2o_wf_objects()
    jp, tp = h2o_params(rng)
    pos = walkers(rng, 4)
    mo = np.asarray(jmf.mo_coeff[0])
    nsteps, tstep = 3, 0.5
    jacc = jobdm.OBDMAccumulator(jmol, mo, spin=0)
    jblock = j_make_vmc_block(jwf, {"obdm": jacc}, JGeometry(None), tstep=tstep, nsteps=nsteps,
                              fused=False, accumulate_every=2)
    wrap = jnp.zeros((4, 8, 3), jnp.int32)
    key = jax.random.PRNGKey(9)

    def jax_side(p, x, w, k):
        kg, ku, ka = jax.random.split(k, 3)
        akeys = jax.random.split(ka, nsteps).reshape((nsteps, 1) + ka.shape)
        streams = {"gauss": jax.random.normal(kg, (nsteps, 8, 4, 3)) * jnp.sqrt(tstep),
                   "unif": jax.random.uniform(ku, (nsteps, 8, 4)),
                   "raux": jnp.stack([jacc.mixture.sample(akeys[s, 0], 4, jnp.float64)
                                      for s in range(nsteps)])}
        return jblock(p, x, w, k), streams

    (p_j, _, avg_j), s = jrun("observables_vmc", jax_side, jp, jnp.asarray(pos), wrap, key)
    streams = {"gauss": t64(s["gauss"]), "unif": t64(s["unif"]),
               "draws": {"obdm": {"raux": t64(s["raux"])}}}
    block = make_vmc_block(twf, {"obdm": obdm.OBDMAccumulator(tmol, mo, spin=0)}, Geometry(),
                           tstep=tstep, nsteps=nsteps, accumulate_every=2)
    p_t, _, avg_t = block(tp, t64(pos), torch.zeros((4, 8, 3), dtype=torch.int32), None, streams)
    close(p_t.numpy(), p_j, msg="positions")
    assert set(avg_t) == set(avg_j)
    for k in avg_j:
        close(avg_t[k].numpy(), avg_j[k], msg=k)


def test_dmc_further_accumulators_draw_their_own_streams():
    """A DMC block with an OBDM and a second energy accumulator: the streams
    of a block without them are drawn as before, each further accumulator
    gets its own (not the energy's rotations), and their averages are the
    weight-averaged per-walker outputs on those streams."""
    (_, _), (tmol, tmf) = h2o_pair()
    _, twf = h2o_wf_objects()
    _, tp = h2o_params(np.random.default_rng(51))
    pos = t64(walkers(np.random.default_rng(52), 4))
    further = {"obdm": obdm.OBDMAccumulator(tmol, tmf.mo_coeff[0], spin=0),
               "energy2": EnergyAccumulator(tmol)}

    def draw(accs):
        return tdmc.draw_dmc_streams(torch.Generator().manual_seed(3), 1, 8, 4, 0.02, "cpu", F64,
                                     accumulators=accs)

    plain, own = draw(None), draw(further)
    assert set(own) == set(plain) | {"draws"}
    for k in plain:
        assert torch.equal(own[k], plain[k]), k
    assert set(own["draws"]) == {"obdm", "energy2"}
    assert set(own["draws"]["obdm"]) == {"raux"}
    assert not torch.allclose(own["draws"]["energy2"]["rot"], own["erot"])
    energy = EnergyAccumulator(tmol)
    block, _ = tdmc.make_dmc_block(twf, energy, Geometry(), 0.02, 1, accumulators=further)
    e = torch.tensor(-17.0, dtype=F64)
    p, _, w, avg = block(tp, pos, torch.zeros((4, 8, 3), dtype=torch.int32),
                         torch.ones(4, dtype=F64), None, e, e, torch.tensor(0.5, dtype=F64), own)
    st = twf.recompute(tp, p)
    d = own["draws"]
    ob = further["obdm"](twf, tp, st, p, draws={"raux": d["obdm"]["raux"][0]})
    en = energy(twf, tp, st, p, d["energy2"]["rot"][0])
    mine = energy(twf, tp, st, p, own["erot"][0])
    for k, v in ob.items():
        close(avg[f"obdm{k}"].numpy(), torch.einsum("c,c...->...", w, v).numpy() / w.sum().item(),
              msg=k)
    for k in ("total", "ecp"):
        close(avg[f"energy2{k}"].item(), (torch.sum(w * en[k]) / w.sum()).item(), msg=k)
        close(avg[f"energy{k}"].item(), (torch.sum(w * mine[k]) / w.sum()).item(), msg=k)
    assert abs(avg["energy2ecp"].item() - avg["energyecp"].item()) > 1e-8


@functools.lru_cache(maxsize=None)
def he_3s():
    """He in an uncontracted 3s basis (tests/unit/test_observables.py):
    (port molecule, the RHF orbitals)."""
    jmol = JMolecule("He 0 0 0",
                     basis={"He": [[0, [6.0, 1.0]], [0, [1.2, 1.0]], [0, [0.3, 1.0]]]})
    mf = run_scf(jmol)
    return port_molecule(jmol), np.asarray(mf.mo_coeff[0])


def test_bare_slater_limits():
    """Bare RHF He (the JAX package's test_observables): the OBDM's
    occupied diagonal is 2 and its virtual one 0 in a VMC average; per
    walker the occupied entries are exactly |phi(r')|^2 / q(r') (the ratios
    reproduce the occupied orbitals), and S^2 is exactly 0 (the exchange
    ratio of a closed-shell pair is 1)."""
    mol, mo = he_3s()
    wf = Slater(mol, None, DeterminantExpansion.single(1, 1), (mo[:, :1], mo[:, :1]))
    params = wf.make_params("cpu")
    configs = initial_guess(mol, 2000, generator=torch.Generator().manual_seed(0), device="cpu")
    acc = obdm.OBDMAccumulator(mol, mo[:, :2])
    data, configs = vmc(wf, params, configs, nblocks=12, nsteps_per_block=5,
                        accumulators={"obdm": acc}, generator=torch.Generator().manual_seed(1))
    rho = np.mean([d["obdmvalue"] for d in data[2:]], axis=0)
    assert abs(rho[0, 0] - 2.0) < 0.15, rho
    assert abs(rho[1, 1]) < 0.1, rho
    assert abs(rho[0, 1]) < 0.1 and abs(rho[1, 0]) < 0.1, rho
    x = configs.positions[:50]
    st = wf.recompute(params, x)
    raux = acc.mixture.sample(torch.Generator().manual_seed(2), (50,), "cpu", F64)
    one = acc(wf, params, st, x, draws={"raux": raux})
    np.testing.assert_allclose(one["value"][:, 0, 0].numpy(), 2 * one["norm"][:, 0].numpy(),
                               rtol=1e-10, atol=1e-10)
    s2 = S2Accumulator(mol)(wf, params, st, x)["S2"]
    np.testing.assert_allclose(s2.numpy(), 0.0, atol=1e-10)


def test_symmetry_exact_limits():
    """The JAX package's test_symmetry_extrapolate: the H2 sigma_g ground
    state is even under inversion and sigma_h for every walker, a single
    p_z electron odd under sigma_h, to 1e-10."""
    jmol = JMolecule("H 0 0 -0.7; H 0 0 0.7", basis="sto-3g")
    mf = run_scf(jmol)
    mol = port_molecule(jmol)
    mo = np.asarray(mf.mo_coeff[0])
    wf = Slater(mol, None, DeterminantExpansion.single(1, 1), (mo[:, :1], mo[:, :1]))
    params = wf.make_params("cpu")
    x = initial_guess(mol, 50, generator=torch.Generator().manual_seed(0), device="cpu").positions
    acc = SymmetryAccumulator(mol, [-np.eye(3), np.diag([1.0, 1.0, -1.0])],
                              names=["inversion", "sigma_h"])
    out = acc(wf, params, wf.recompute(params, x), x)
    for k in ("inversion", "sigma_h"):
        np.testing.assert_allclose(out[k].numpy(), 1.0, atol=1e-10)
    pmol = port_molecule(JMolecule("H 0 0 0", basis={"H": [[1, [0.8, 1.0]]]}, spin=1))
    C = np.zeros((3, 1))
    C[2, 0] = 1.0
    wf = Slater(pmol, None, DeterminantExpansion.single(1, 0), (C, np.zeros((3, 0))))
    params = wf.make_params("cpu")
    x = initial_guess(pmol, 20, generator=torch.Generator().manual_seed(1), device="cpu").positions
    out = SymmetryAccumulator(pmol, [np.diag([1.0, 1.0, -1.0])], names=["sz"])(
        wf, params, wf.recompute(params, x), x)
    np.testing.assert_allclose(out["sz"].numpy(), -1.0, atol=1e-10)


def test_sq_limits():
    """Uncorrelated positions: S(q) and S_spin(q) -> 1 at large q; at q -> 0
    S(q) = N and S_spin(q) = 0 for equal spin populations (the JAX
    package's test_spin_sq_limits)."""

    class Cell:
        nelec = (3, 3)
        lattice = 10.0 * np.eye(3)

    acc = SqAccumulator(Cell(), qlist=np.array([[20.0, 0, 0], [1e-8, 0, 0]]))
    pos = t64(np.random.default_rng(9).uniform(0, 10, size=(4000, 6, 3)))
    out = acc.avg(None, None, None, pos)
    np.testing.assert_allclose(out["Sq"][0].item(), 1.0, atol=0.1)
    np.testing.assert_allclose(out["spinSq"][0].item(), 1.0, atol=0.1)
    np.testing.assert_allclose(out["Sq"][1].item(), 6.0, atol=1e-6)
    np.testing.assert_allclose(out["spinSq"][1].item(), 0.0, atol=1e-6)
    assert len(SqAccumulator(Cell()).qlist) == 9**3 - 1
