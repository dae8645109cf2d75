"""Overlap sampling and the ensemble (excited-state) optimization of
pyqmc_tpu_torch against the JAX package, float64 on the CPU: the
all-electron H2 cc-pVDZ states of the JAX package's
tests/integration/test_ensemble.py (the RHF ground state, the up electron
moved from sigma to sigma*, and their superposition with det_coeff (0.5,
0.8)).

The overlap block runs on the JAX block's streams; the state gradient on
the same walkers. Each JAX side is one compiled function.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyqmc_tpu.configs import Geometry as JGeometry
from pyqmc_tpu.method import ensemble as jens
from pyqmc_tpu.method.sample_many import make_overlap_block as j_make_overlap_block
from pyqmc_tpu.models.slater import DeterminantExpansion as JExpansion
from pyqmc_tpu.models.slater import Slater as JSlater
from pyqmc_tpu.observables.accumulators import EnergyAccumulator as JEnergy
from pyqmc_tpu.observables.s2 import S2Accumulator as JS2
from pyqmc_tpu.observables.transform import LinearTransform as JTransform
from pyqmc_tpu.system.mole import Molecule as JMolecule
from pyqmc_tpu.system.scf import run_scf

from pyqmc_tpu_torch.configs import Geometry
from pyqmc_tpu_torch.entry import h2o_excited_setup
from pyqmc_tpu_torch.method import ensemble
from pyqmc_tpu_torch.method.sample_many import make_overlap_block, sample_overlap
from pyqmc_tpu_torch.models.slater import DeterminantExpansion, Slater
from pyqmc_tpu_torch.observables.accumulators import EnergyAccumulator
from pyqmc_tpu_torch.observables.s2 import S2Accumulator
from pyqmc_tpu_torch.observables.transform import LinearTransform
from pyqmc_tpu_torch.parallel.mesh import WalkerMesh

from .torch_parity import F64, jrun, port_molecule, to_np

NCONF, NSTEPS, TSTEP = 4, 2, 0.5
DET_ONLY = {"det_coeff": True, "mo_coeff_alpha": False, "mo_coeff_beta": False}


def t64(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def close(t, j, tol=1e-9, msg=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=tol, atol=tol, err_msg=msg)


def _expansions(exp):
    ex = exp(occ_up=np.array([[1]]), occ_dn=np.array([[0]]),
             map_up=np.zeros(1, dtype=np.int64), map_dn=np.zeros(1, dtype=np.int64))
    mix = exp(occ_up=np.array([[0], [1]]), occ_dn=np.array([[0]]), map_up=np.array([0, 1]),
              map_dn=np.array([0, 0]))
    return ex, mix


@functools.lru_cache(maxsize=None)
def h2_states():
    """(jax mol, [ground, excited, superposition] JAX Slaters, port mol, the
    same port Slaters)."""
    jmf = run_scf(JMolecule("H 0 0 0; H 0 0 1.4", basis="ccpvdz"))
    jmol = jmf.mol
    tmol = port_molecule(jmol)
    ca = np.asarray(jmf.mo_coeff[0])[:, :2]
    out = []
    for mol, slater, exp in ((jmol, JSlater, JExpansion), (tmol, Slater, DeterminantExpansion)):
        ex, mix = _expansions(exp)
        out.append([slater(mol, None, exp.single(1, 1), (ca[:, :1], ca[:, :1])),
                    slater(mol, None, ex, (ca, ca)),
                    slater(mol, None, mix, (ca, ca), det_coeff=np.array([0.5, 0.8]))])
    return jmol, out[0], tmol, out[1]


def test_overlap_block_matches_jax():
    """A 2-step overlap block of the ground and excited H2 states with the
    energy and an adapted S^2, on the JAX block's streams: positions,
    overlap, acceptance, energies and S^2 to 1e-9."""
    jmol, (jgs, jex, _), tmol, (tgs, tex, _) = h2_states()
    pos = np.random.default_rng(3).normal(scale=1.0, size=(NCONF, 2, 3)) + np.array([0, 0, 0.7])
    jblock = j_make_overlap_block((jgs, jex), JGeometry(None), tstep=TSTEP, nsteps=NSTEPS,
                                  energy_acc=JEnergy(jmol), accumulators={"s2": JS2(jmol)})
    jps = (jgs.make_params(), jex.make_params())
    key = jax.random.PRNGKey(5)

    def jax_side(ps, x, w, k):
        kg, ku, _ = jax.random.split(k, 3)
        return jblock(ps, x, w, k), {
            "gauss": jax.random.normal(kg, (NSTEPS, 2, NCONF, 3)) * jnp.sqrt(TSTEP),
            "unif": jax.random.uniform(ku, (NSTEPS, 2, NCONF))}

    (p_j, _, avg_j), s = jrun("overlap_block", jax_side, jps, jnp.asarray(pos),
                              jnp.zeros((NCONF, 2, 3), jnp.int32), key)
    block = make_overlap_block((tgs, tex), Geometry(), tstep=TSTEP, nsteps=NSTEPS,
                               energy_acc=EnergyAccumulator(tmol),
                               accumulators={"s2": S2Accumulator(tmol)})
    tps = (tgs.make_params("cpu"), tex.make_params("cpu"))
    p_t, _, avg_t = block(tps, t64(pos), torch.zeros((NCONF, 2, 3), dtype=torch.int32), None,
                          {k: t64(v) for k, v in s.items()})
    close(p_t.numpy(), p_j, msg="positions")
    assert set(avg_t) == set(avg_j)
    for k in avg_j:
        close(avg_t[k].numpy(), avg_j[k], msg=k)
    assert 0.0 < float(avg_t["acceptance"]) < 1.0


def test_state_gradient_and_step_match_jax():
    """make_state_gradient_fn of the superposition (state 1, det_coeff free)
    against the ground state, and delta_p_state's step, against the JAX
    package on the same walkers to 1e-9."""
    jmol, (jgs, _, jmix), tmol, (tgs, _, tmix) = h2_states()
    pos = np.random.default_rng(4).normal(scale=1.0, size=(6, 2, 3)) + np.array([0, 0, 0.7])
    jps = (jgs.make_params(), jmix.make_params())
    jt = JTransform(jps[1], DET_ONLY)
    jfn = jens.make_state_gradient_fn((jgs, jmix), 1, jt, JEnergy(jmol))
    est_j = jrun("state_gradient", lambda ps, x, k: jfn(ps, x, k), jps, jnp.asarray(pos),
                 jax.random.PRNGKey(0))
    tps = (tgs.make_params("cpu"), tmix.make_params("cpu"))
    tfn = ensemble.make_state_gradient_fn((tgs, tmix), 1, LinearTransform(tps[1], DET_ONLY),
                                          EnergyAccumulator(tmol))
    est_t = tfn(tps, t64(pos))
    assert set(est_t) == set(est_j)
    for k in est_j:
        close(est_t[k].numpy(), est_j[k], msg=k)
    est = {k: np.asarray(v) for k, v in est_j.items()}
    est["njj_0"] = 0.4
    steps_j, e_j = jens.delta_p_state(1, dict(est), [0.1, 0.3], 4.0)
    steps_t, e_t = ensemble.delta_p_state(1, dict(est), [0.1, 0.3], 4.0)
    close(e_t, e_j)
    close(np.stack(steps_t), np.stack(steps_j))
    assert np.max(np.abs(steps_t[1])) > 1e-4


def test_excited_setup_and_ensemble_on_cpu():
    """h2o_excited_setup on the CPU: the states' parameters and the
    superposition's transform; sample_overlap's keys and a finite
    optimize_ensemble iteration that moves det_coeff; a walker mesh whose
    ranks do not divide the walkers raises before any work (the meshed
    runs are held in tests/test_torch_mesh.py, hdf_file= in
    tests/test_torch_io.py)."""
    mol, wfs, params_list, configs, acc, ens = h2o_excited_setup(4, device="cpu")
    assert ens["transforms"][0] is None and ens["transforms"][1].nparams == 2
    assert tuple(ens["params_list"][1]["wf0"]["det_coeff"].tolist()) == (0.5, 0.8)
    gen = torch.Generator().manual_seed(0)
    data, configs = sample_overlap(wfs, params_list, configs, gen, nblocks=1, nsteps=1,
                                   energy_acc=acc["energy"])
    assert {"overlap", "energy0_num", "energy1_den", "acceptance"} <= set(data[0])
    assert data[0]["overlap"].shape == (2, 2)
    plist, records = ensemble.optimize_ensemble(**ens, configs=configs, energy_acc=acc["energy"],
                                                generator=gen, max_iterations=1, nblocks=1,
                                                nsteps=1)
    assert np.isfinite(records[0]["energy1"])
    assert not np.allclose(to_np(plist[1]["wf0"]["det_coeff"]), [0.5, 0.8])
    mesh3 = WalkerMesh(group=None, rank=0, size=3, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="must divide evenly"):
        ensemble.optimize_ensemble(**ens, configs=configs, energy_acc=acc["energy"],
                                   generator=gen, max_iterations=1, nblocks=1, nsteps=1,
                                   mesh=mesh3)
