"""Reference runs of the observables and of the excited-state sampling from
the JAX package (pyqmc_tpu), on the CPU in float64 with the plain XLA paths.

    python tools/observables_jax_reference.py h2o [nconfig] [nruns] [seed]
    python tools/observables_jax_reference.py diamond [nconfig] [nruns] [seed]
    python tools/observables_jax_reference.py excited [nconfig] [nruns] [seed]

h2o: chip_smoke.py phase 27's schedule. The ccECP/cc-pVDZ H2O
Slater-Jastrow of the committed checkpoint (default Jastrow), walkers from
initial_guess, 3 VMC blocks of 20 steps at tstep 0.5 with accumulate_every
2: the energy, the OBDM of each spin in all 23 MOs, the TBDM of spins (0, 1)
and (0, 0) in the 8 lowest MOs, S^2 and the symmetry operations C2z,
sigma(xz), sigma(yz) about the origin. Kept: the blocks after the first.

diamond: phase 29's schedule. The TRIM 2x2x2 diamond-C supercell
Slater-Jastrow (the configuration of tools/diamond_jax_reference.py and of
the port's entry.diamond_setup), 4 equilibration blocks of 10 steps with
the energy, then 3 blocks of 10 steps with the energy, the KOBDM of each
spin in the Slater's 32 orbitals per spin and SqAccumulator(cell) at its
default nq; all three kept.

excited: phase 30's schedule. State 0 the H2O Slater-Jastrow; state 1 the
Slater of the up electron moved from MO 3 to MO 4 times the same Jastrow.
sample_overlap of the two states, 4 blocks of 10 steps at tstep 0.5 with
the energy and an adapted S2Accumulator (the blocks after the first
kept); then optimize_ensemble of (state 0 frozen, the two-determinant
superposition of the ground and excited determinants with det_coeff (0.5,
0.8) times the Jastrow, its det_coeff optimized): penalty 4.0, tau 0.3, 4
iterations of 2 blocks of 10 steps, each run from new walkers. Recorded per
iteration: |O01| (normalized) and E1; after the last, the ground
determinant's share |c0| / |c|.

Each run starts from its own walkers and keys. Each mode prints its blocks
or iterations, then one JSON line: every quantity's mean over the runs, its
standard error over the runs' means, the walker counts and the wall time.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import h5py
import numpy as np

H2O = os.path.join(ROOT, "benchmarks", "h2o_ccecp-ccpvdz_ccecp_scf.hdf5")

H2O_BLOCKS, H2O_STEPS, H2O_EVERY, H2O_NSKIP = 3, 20, 2, 1  # phase 27
NOCC = 4  # occupied orbitals per spin of H2O's 8 valence electrons
NCAS = 8  # the TBDM's orbitals: the CASCI(8e,8o) active space
SYM_OPS = {"c2z": np.diag([-1.0, -1.0, 1.0]), "sxz": np.diag([1.0, -1.0, 1.0]),
           "syz": np.diag([-1.0, 1.0, 1.0])}
DIAMOND_WARM, DIAMOND_BLOCKS, DIAMOND_STEPS = 4, 3, 10  # phase 29
OVERLAP_BLOCKS, OVERLAP_NSKIP = 4, 1  # phase 30's sample_overlap, 10-step blocks
ENS_ITERATIONS, ENS_BLOCKS, ENS_PENALTY, ENS_TAU = 4, 2, 4.0, 0.3  # phase 30's optimize_ensemble
DET_COEFF = (0.5, 0.8)


def summary(per_run):
    """{name: (mean over runs, standard error over the runs' means)} of a
    list (one per run) of {name: value or array}."""
    out = {}
    for k in per_run[0]:
        x = np.array([r[k] for r in per_run], dtype=np.float64)
        sem = np.std(x, axis=0, ddof=1) / np.sqrt(len(x)) if len(x) > 1 else np.zeros_like(x[0])
        out[k] = {"mean": np.mean(x, axis=0).tolist(), "sem": np.asarray(sem).tolist()}
    return out


def load():
    from pyqmc_tpu.system.io import load_system

    with h5py.File(H2O, "r") as f:
        return load_system(f)


def h2o(nconfig=256, nruns=4, seed=81):
    from pyqmc_tpu.configs import initial_guess
    from pyqmc_tpu.method.vmc import make_vmc_block
    from pyqmc_tpu.models.jastrow import JastrowSpin
    from pyqmc_tpu.models.multiply import MultiplyWF
    from pyqmc_tpu.models.slater import Slater
    from pyqmc_tpu.observables.accumulators import EnergyAccumulator
    from pyqmc_tpu.observables.obdm import OBDMAccumulator
    from pyqmc_tpu.observables.s2 import S2Accumulator
    from pyqmc_tpu.observables.symmetry import SymmetryAccumulator
    from pyqmc_tpu.observables.tbdm import TBDMAccumulator

    mol, mf = load()
    wf = MultiplyWF(Slater.from_mean_field(mf), JastrowSpin(mol))
    params = wf.make_params()
    mo = np.asarray(mf.mo_coeff[0])
    accs = {"energy": EnergyAccumulator(mol),
            "obdm0": OBDMAccumulator(mol, mo, spin=0), "obdm1": OBDMAccumulator(mol, mo, spin=1),
            "tbdm01": TBDMAccumulator(mol, mo[:, :NCAS], spin=(0, 1)),
            "tbdm00": TBDMAccumulator(mol, mo[:, :NCAS], spin=(0, 0)),
            "s2": S2Accumulator(mol),
            "sym": SymmetryAccumulator(mol, list(SYM_OPS.values()), names=list(SYM_OPS))}
    t0 = time.perf_counter()
    per_run = []
    for run in range(nruns):
        configs = initial_guess(mol, nconfig, key=jax.random.PRNGKey(seed + 2 * run))
        if run == 0:
            block = make_vmc_block(wf, accs, configs.geometry, tstep=0.5, nsteps=H2O_STEPS,
                                   accumulate_every=H2O_EVERY, fused=False)
        pos, wrap = configs.positions, configs.wrap
        key = jax.random.PRNGKey(seed + 2 * run + 1)
        rows = []
        for b in range(H2O_BLOCKS):
            key, bk = jax.random.split(key)
            pos, wrap, avg = block(params, pos, wrap, bk)
            avg = jax.device_get(avg)
            t = np.asarray(avg["tbdm01value"])
            rows.append({
                "energy": float(avg["energytotal"]), "acceptance": float(avg["acceptance"]),
                "obdm0_diag": np.diag(avg["obdm0value"])[:NOCC],
                "obdm1_diag": np.diag(avg["obdm1value"])[:NOCC],
                "obdm0_trace": float(np.trace(avg["obdm0value"])),
                "obdm1_trace": float(np.trace(avg["obdm1value"])),
                "s2": float(avg["s2S2"]),
                "tbdm01_occ": float(sum(t[i, j, i, j] for i in range(NOCC) for j in range(NOCC))),
                **{f"sym_{k}": float(avg[f"sym{k}"]) for k in SYM_OPS}})
            print(f"run {run} block {b}: E {rows[-1]['energy']:.6f} S2 {rows[-1]['s2']:.5f} "
                  f"obdm0 diag {np.round(rows[-1]['obdm0_diag'], 4).tolist()} tbdm01 occ "
                  f"{rows[-1]['tbdm01_occ']:.4f} ({time.perf_counter() - t0:.1f} s)", flush=True)
        kept = rows[H2O_NSKIP:]
        per_run.append({k: np.mean([r[k] for r in kept], axis=0) for k in kept[0]})
    print(json.dumps({"mode": "h2o", "nconfig": nconfig, "nruns": nruns, "seed": seed,
                      "schedule": [H2O_BLOCKS, H2O_STEPS, H2O_EVERY, H2O_NSKIP],
                      "summary": summary(per_run), "seconds": time.perf_counter() - t0}),
          flush=True)


class _SlaterOrbitals:
    """The Slater factor's orbitals of a MultiplyWF, read with the product's
    parameters (the JAX KOBDMAccumulator evaluates its orbitals with the
    parameters the block hands the wavefunction)."""

    def __init__(self, orbitals):
        self.orbitals = orbitals
        self.norb = orbitals.norb

    def eval(self, params, X, mode):
        return self.orbitals.eval(params["wf0"], X, mode)


def diamond(nconfig=64, nruns=4, seed=91):
    from pyqmc_tpu.configs import initial_guess
    from pyqmc_tpu.method.vmc import make_vmc_block
    from pyqmc_tpu.models.jastrow import JastrowSpin
    from pyqmc_tpu.models.multiply import MultiplyWF
    from pyqmc_tpu.models.orbitals import KPointOrbitals
    from pyqmc_tpu.models.slater import DeterminantExpansion, Slater
    from pyqmc_tpu.observables.accumulators import EnergyAccumulator
    from pyqmc_tpu.observables.obdm import KOBDMAccumulator, normalize_obdm
    from pyqmc_tpu.observables.sq import SqAccumulator
    from pyqmc_tpu.system.supercell import get_supercell
    from pyqmc_tpu.wftools import default_jastrow_basis
    from tests.fixtures_pbc import load_cell

    cell, d = load_cell("diamond_primitive")
    sup = get_supercell(cell, 2 * np.eye(3, dtype=int))
    kpts = np.asarray(d["kpts"])
    blocks = [np.asarray(d["mo_coeff"][k])[:, :4] for k in range(len(kpts))]
    orb = KPointOrbitals(cell, kpts, (blocks, blocks), img_tol=1e-4)
    a_b, b_b = default_jastrow_basis(sup)
    wf = MultiplyWF(Slater(sup, orb, DeterminantExpansion.single(32, 32)),
                    JastrowSpin(sup, a_basis=a_b, b_basis=b_b))
    params = wf.make_params()
    energy = EnergyAccumulator(sup)
    sq = SqAccumulator(sup)
    qn = np.linalg.norm(sq.qlist, axis=1)
    outer = qn > qn.max() * (1 - 1e-9) - 1e-9
    slater_orb = _SlaterOrbitals(orb)
    accs = {"energy": energy, "kobdm0": KOBDMAccumulator(sup, slater_orb, spin=0),
            "kobdm1": KOBDMAccumulator(sup, slater_orb, spin=1), "sq": sq}
    t0 = time.perf_counter()
    per_run = []
    for run in range(nruns):
        configs = initial_guess(sup, nconfig, key=jax.random.PRNGKey(seed + 2 * run))
        if run == 0:
            warm = make_vmc_block(wf, {"energy": energy}, configs.geometry, tstep=0.5,
                                  nsteps=DIAMOND_STEPS, fused=False)
            block = make_vmc_block(wf, accs, configs.geometry, tstep=0.5, nsteps=DIAMOND_STEPS,
                                   fused=False)
        pos, wrap = configs.positions, configs.wrap
        key = jax.random.PRNGKey(seed + 2 * run + 1)
        for b in range(DIAMOND_WARM):
            key, bk = jax.random.split(key)
            pos, wrap, avg = warm(params, pos, wrap, bk)
            print(f"run {run} warm-up block {b}: E/cell {float(avg['energytotal']) / 8:.6f} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
        rows = []
        for b in range(DIAMOND_BLOCKS):
            key, bk = jax.random.split(key)
            pos, wrap, avg = block(params, pos, wrap, bk)
            avg = jax.device_get(avg)
            row = {"e_cell": float(avg["energytotal"]) / 8,
                   "sq_outer": float(np.mean(np.asarray(avg["sqSq"])[outer]))}
            for s in (0, 1):
                row[f"kobdm{s}_value_diag"] = np.diag(avg[f"kobdm{s}value_re"])
                row[f"kobdm{s}_norm"] = np.asarray(avg[f"kobdm{s}norm"])
            rows.append(row)
            print(f"run {run} block {b}: E/cell {row['e_cell']:.6f} S(q) outer shell "
                  f"{row['sq_outer']:.4f} ({time.perf_counter() - t0:.1f} s)", flush=True)
        mean = {k: np.mean([r[k] for r in rows], axis=0) for k in rows[0]}
        for s in (0, 1):
            n = mean.pop(f"kobdm{s}_norm")
            v = mean.pop(f"kobdm{s}_value_diag")
            mean[f"kobdm{s}_normalized_diag"] = np.diag(normalize_obdm(np.diag(v), n))
        per_run.append(mean)
    print(json.dumps({"mode": "diamond", "nconfig": nconfig, "nruns": nruns, "seed": seed,
                      "schedule": [DIAMOND_WARM, DIAMOND_BLOCKS, DIAMOND_STEPS],
                      "nq": int(len(sq.qlist)), "nq_outer": int(np.sum(outer)),
                      "summary": summary(per_run), "seconds": time.perf_counter() - t0}),
          flush=True)


def excited_states(mol, mf):
    """(state 0, state 1, the superposition) of H2O, each times its own
    JastrowSpin of the same (default) coefficients."""
    from pyqmc_tpu.models.jastrow import JastrowSpin
    from pyqmc_tpu.models.multiply import MultiplyWF
    from pyqmc_tpu.models.slater import DeterminantExpansion, Slater

    nup, ndn = mol.nelec
    ca = np.asarray(mf.mo_coeff[0])[:, :nup + 1]
    ground = list(range(nup))
    excited = ground[:-1] + [nup]
    one = np.zeros(1, dtype=np.int64)
    s0 = MultiplyWF(Slater.from_mean_field(mf), JastrowSpin(mol))
    s1 = MultiplyWF(Slater(mol, None, DeterminantExpansion(
        occ_up=np.array([excited]), occ_dn=np.array([ground]), map_up=one, map_dn=one),
        (ca, ca)), JastrowSpin(mol))
    mix = MultiplyWF(Slater(mol, None, DeterminantExpansion(
        occ_up=np.array([ground, excited]), occ_dn=np.array([ground]),
        map_up=np.array([0, 1]), map_dn=np.array([0, 0])), (ca, ca),
        det_coeff=np.array(DET_COEFF)), JastrowSpin(mol))
    return s0, s1, mix


def excited(nconfig=512, nruns=4, seed=101):
    from pyqmc_tpu.configs import initial_guess
    from pyqmc_tpu.method.ensemble import optimize_ensemble
    from pyqmc_tpu.method.sample_many import make_overlap_block, sample_overlap
    from pyqmc_tpu.observables.accumulators import EnergyAccumulator
    from pyqmc_tpu.observables.s2 import S2Accumulator
    from pyqmc_tpu.observables.transform import LinearTransform

    mol, mf = load()
    s0, s1, mix = excited_states(mol, mf)
    p0, p1, pm = s0.make_params(), s1.make_params(), mix.make_params()
    energy = EnergyAccumulator(mol)
    to_opt = {"wf0": {"det_coeff": True, "mo_coeff_alpha": False, "mo_coeff_beta": False},
              "wf1": {"acoeff": False, "bcoeff": False}}
    t1 = LinearTransform(pm, to_opt)
    t0 = time.perf_counter()
    per_run = []
    block = None
    for run in range(nruns):
        configs = initial_guess(mol, nconfig, key=jax.random.PRNGKey(seed + 3 * run))
        if block is None:
            block = make_overlap_block((s0, s1), configs.geometry, tstep=0.5, nsteps=10,
                                       energy_acc=energy, accumulators={"s2": S2Accumulator(mol)})
        data, _ = sample_overlap((s0, s1), (p0, p1), configs,
                                 jax.random.PRNGKey(seed + 3 * run + 1),
                                 nblocks=OVERLAP_BLOCKS, block_fn=block)
        rows = []
        for b, dd in enumerate(data):
            N = np.asarray(dd["overlap"])
            rows.append({"e0": dd["energy0_num"] / dd["energy0_den"],
                         "e1": dd["energy1_num"] / dd["energy1_den"],
                         "s2_0": dd["s20_S2_num"] / dd["state0_den"],
                         "s2_1": dd["s21_S2_num"] / dd["state1_den"],
                         "o01": abs(N[0, 1]) / np.sqrt(abs(N[0, 0] * N[1, 1])),
                         "acceptance": float(dd["acceptance"])})
            print(f"run {run} overlap block {b}: " + json.dumps(
                {k: round(float(v), 6) for k, v in rows[-1].items()})
                + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
        kept = rows[OVERLAP_NSKIP:]
        res = {k: float(np.mean([r[k] for r in kept])) for k in kept[0]}
        configs = initial_guess(mol, nconfig, key=jax.random.PRNGKey(seed + 3 * run + 2))
        params_list, records = optimize_ensemble(
            (s0, mix), (p0, pm), (None, t1), configs, energy,
            key=jax.random.PRNGKey(seed + 3 * run + 3), max_iterations=ENS_ITERATIONS,
            penalty=ENS_PENALTY, tau=ENS_TAU, nblocks=ENS_BLOCKS, nsteps=10)
        traj = {"ens_o01": [], "ens_e1": [], "ens_frac0": []}
        for r in records:
            N = np.asarray(r["overlap"])
            traj["ens_o01"].append(abs(N[0, 1]) / np.sqrt(abs(N[0, 0] * N[1, 1])))
            traj["ens_e1"].append(float(r["energy1"]))
        # optimize_ensemble returns the final parameters only: the share
        # after the last iteration
        c = np.asarray(params_list[1]["wf0"]["det_coeff"])
        traj["ens_frac0"] = [float(abs(c[0]) / np.linalg.norm(c))]
        print(f"run {run} ensemble: " + json.dumps(
            {k: np.round(v, 6).tolist() for k, v in traj.items()})
            + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
        res.update({k: np.asarray(v) for k, v in traj.items()})
        per_run.append(res)
    print(json.dumps({"mode": "excited", "nconfig": nconfig, "nruns": nruns, "seed": seed,
                      "schedule": [OVERLAP_BLOCKS, OVERLAP_NSKIP, ENS_ITERATIONS, ENS_BLOCKS],
                      "summary": summary(per_run), "seconds": time.perf_counter() - t0}),
          flush=True)


if __name__ == "__main__":
    mode, args = sys.argv[1], [int(a) for a in sys.argv[2:]]
    {"h2o": h2o, "diamond": diamond, "excited": excited}[mode](*args)
