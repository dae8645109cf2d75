"""Write the HDF5 files of the JAX package's VMC, DMC, line minimization
and ensemble optimization that tests/test_torch_io.py and
tests/test_torch_restart.py read with the port: their own output, on the
CPU in float64, at tiny sizes.

    python tools/torch_io_jax_fixtures.py [outdir]

outdir defaults to tests/files/torch_io. The files:

vmc.h5       vmc(hdf_file=) of the He/STO-3G Slater determinant, 8 walkers,
             2 blocks of 2 steps, with the energy and an S(q) accumulator
             at two q vectors (an array-valued observable);
dmc.h5       rundmc(hdf_file=) of the same, 8 walkers, 1 VMC warm-up
             block, 3 blocks of 2 steps at tstep 0.02: a DMC checkpoint;
opt.h5       line_minimization(hdf_file=) of the He Slater x JastrowSpin
             (the Jastrow optimized), 8 walkers, 2 iterations of 2 x 2 SR
             steps;
ensemble.h5  optimize_ensemble(hdf_file=) of H2/cc-pVDZ's ground state
             (frozen) and the superposition of the ground and excited
             determinants (det_coeff (0.5, 0.8) optimized), 8 walkers, 2
             iterations of 1 x 2 overlap steps, penalty 4, tau 0.3.

The JAX package does not change, so the files stay what it writes; rerun
this script to remake them.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np

NCONF = 8
SQ_QLIST = np.array([[1.0, 0.0, 0.0], [0.0, 2.0, 0.0]])


def he():
    from pyqmc_tpu.models.slater import Slater
    from pyqmc_tpu.system.mole import Molecule
    from pyqmc_tpu.system.scf import run_scf

    mol = Molecule("He 0 0 0", basis="sto-3g")
    return mol, Slater.from_mean_field(run_scf(mol))


def h2_states():
    """(mol, [ground, superposition] Slaters) of H2/cc-pVDZ at 1.4 bohr."""
    from pyqmc_tpu.models.slater import DeterminantExpansion, Slater
    from pyqmc_tpu.system.mole import Molecule
    from pyqmc_tpu.system.scf import run_scf

    mf = run_scf(Molecule("H 0 0 0; H 0 0 1.4", basis="ccpvdz"))
    ca = np.asarray(mf.mo_coeff[0])[:, :2]
    mix = DeterminantExpansion(occ_up=np.array([[0], [1]]), occ_dn=np.array([[0]]),
                               map_up=np.array([0, 1]), map_dn=np.array([0, 0]))
    return mf.mol, [Slater(mf.mol, None, DeterminantExpansion.single(1, 1),
                           (ca[:, :1], ca[:, :1])),
                    Slater(mf.mol, None, mix, (ca, ca), det_coeff=np.array([0.5, 0.8]))]


def main(outdir=os.path.join(ROOT, "tests", "files", "torch_io")):
    from pyqmc_tpu.configs import initial_guess
    from pyqmc_tpu.method.dmc import rundmc
    from pyqmc_tpu.method.ensemble import optimize_ensemble
    from pyqmc_tpu.method.linemin import line_minimization
    from pyqmc_tpu.method.vmc import vmc
    from pyqmc_tpu.models.jastrow import JastrowSpin
    from pyqmc_tpu.models.multiply import MultiplyWF
    from pyqmc_tpu.observables.accumulators import EnergyAccumulator
    from pyqmc_tpu.observables.sq import SqAccumulator
    from pyqmc_tpu.observables.transform import LinearTransform

    os.makedirs(outdir, exist_ok=True)
    for name in ("vmc.h5", "dmc.h5", "opt.h5", "ensemble.h5"):
        path = os.path.join(outdir, name)
        if os.path.exists(path):
            os.remove(path)
    t0 = time.perf_counter()
    mol, wf = he()
    params = wf.make_params()
    energy = EnergyAccumulator(mol)
    sq = SqAccumulator(qlist=SQ_QLIST)
    sq.nup = mol.nelec[0]
    configs = initial_guess(mol, NCONF, key=jax.random.PRNGKey(0))
    vmc(wf, params, configs, nblocks=2, nsteps_per_block=2,
        accumulators={"energy": energy, "sq": sq}, key=jax.random.PRNGKey(1),
        hdf_file=os.path.join(outdir, "vmc.h5"))
    rundmc(wf, params, configs, nblocks=3, nsteps_per_block=2, tstep=0.02, energy_acc=energy,
           key=jax.random.PRNGKey(2), hdf_file=os.path.join(outdir, "dmc.h5"),
           warmup_vmc_blocks=1)
    sj = MultiplyWF(wf, JastrowSpin(mol))
    sjp = sj.make_params()
    line_minimization(sj, sjp, configs, LinearTransform(sjp, {"wf0": False, "wf1": True}),
                      energy, key=jax.random.PRNGKey(3), max_iterations=2, vmc_blocks=2,
                      vmc_steps_per_block=2, hdf_file=os.path.join(outdir, "opt.h5"))
    hmol, (ground, mix) = h2_states()
    plist = [ground.make_params(), mix.make_params()]
    lt = LinearTransform(plist[1], {"det_coeff": True, "mo_coeff_alpha": False,
                                    "mo_coeff_beta": False})
    optimize_ensemble([ground, mix], plist, [None, lt],
                      initial_guess(hmol, NCONF, key=jax.random.PRNGKey(4)),
                      EnergyAccumulator(hmol), key=jax.random.PRNGKey(5), max_iterations=2,
                      penalty=4.0, tau=0.3, nblocks=1, nsteps=2,
                      hdf_file=os.path.join(outdir, "ensemble.h5"))
    print(f"wrote {sorted(os.listdir(outdir))} in {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:])
