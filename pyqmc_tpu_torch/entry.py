"""The port's paths, set up as a user would.

`h2o_setup` (counterpart of `__graft_entry__._h2o_setup`): ccECP/cc-pVDZ
H2O, 8 valence electrons and 23 AOs, Slater-Jastrow, with the energy
accumulator and its dense nonlocal ECP quadrature.

    mol, wf, params, configs, acc = h2o_setup(nconf=2048)   # the GPU, float32
    blocks, configs = vmc(wf, params, configs, nblocks=4,
                          nsteps_per_block=50, accumulators=acc)

`h2o_casci_setup`: the same H2O with the full-valence CASCI(8e,8o)
expansion (1,098 determinants over the first 8 MOs, the committed
`data/h2o_ccecp_cas88.npz`) in place of the single determinant,
MultiplyWF(Slater(mol, None, expansion, (ca, ca), det_coeff), JastrowSpin);
outside the gates of K1, K2, K4 and K5, so its sweeps, T-moves and ECP
energy are the plain versions, whose float32 orbital values run on K3.

    mol, wf, params, configs, acc = h2o_casci_setup(nconf=2048)

`h2o_casci_j3_setup`: BASELINE config 3 on the same H2O, the CASCI
expansion times the two- and three-body Jastrow of
generate_wf(mol, mf, mc=..., jastrow3=True), the Jastrow coefficients read
from the committed `data/h2o_j3_params.npz`; outside the same gates, its
float32 orbital values run on K3.

    mol, wf, params, configs, acc = h2o_casci_j3_setup(nconf=2048)

`h2o_excited_setup`: two states of the same H2O for method/sample_many.py
and method/ensemble.py: state 0 h2o_setup's Slater-Jastrow, state 1 the
Slater of the up electron moved from the HOMO (MO 3) to the LUMO (MO 4)
times the same Jastrow; and, for optimize_ensemble, state 0 with the
two-determinant superposition of the ground and excited determinants
(det_coeff (0.5, 0.8)) times the Jastrow, of which only det_coeff is
optimized (the construction of the JAX package's tests/integration/
test_ensemble.py). The excited determinant is outside the gates of K1 and
K2, so its ECP energy is the flat chain, its orbital values on K3.

    mol, wfs, params_list, configs, acc, ens = h2o_excited_setup(nconf=2048)
    data, configs = sample_overlap(wfs, params_list, configs, energy_acc=acc["energy"])
    params_list, records = optimize_ensemble(**ens, configs=configs,
                                             energy_acc=acc["energy"])

`diamond_setup` (counterpart of benchmarks/c_solid_benchmark.py:123-154,
the TRIM branch): the 2x2x2 supercell of ccECP diamond-C, 16 atoms and 64
valence electrons, k-point Slater (8 TRIM k-points x 4 occupied orbitals
per spin, realified) times the default periodic Jastrow, Ewald energies and
the downselected nonlocal ECP.

    sup, wf, params, configs, acc = diamond_setup(nconf=500)
    blocks, configs = vmc(wf, params, configs, nblocks=4,
                          nsteps_per_block=10, accumulators=acc)

`diamond_twist_setup` (BASELINE config 5; benchmarks/c_solid_benchmark.py:
130-135, general_twist=True): the same supercell and wavefunction at the
general twist, the 8 k-points shifted by TWIST, KPointOrbitals(realify=
False): complex orbitals, phases, inverses and ratios, so the sweeps are
the plain versions; the float32 orbital values run on K3 over [Re R | Im
R], the kinetic energy's AOs on K6.

    sup, wf, params, configs, acc = diamond_twist_setup(nconf=500)

`diamond_twist_average_setup`: the arguments of
method/twist_average.twist_average_vmc over the union of the 8 TRIM
k-points and the same 8 shifted by TWIST, which it groups into two
supercell twists (the TRIM one in real mode on K7, the shifted one as
diamond_twist_setup), each twist's Slater times the default Jastrow.

    sup, args = diamond_twist_average_setup(nconf=500)
    records, avg = twist_average_vmc(**args, nblocks=4, nsteps_per_block=10)

`dryrun_multichip` (counterpart of `__graft_entry__.dryrun_multichip`):
spawns n ranks in a process group on a FileStore and runs one H2O VMC
block of 2 steps on 2n walkers under the walker mesh (parallel/mesh.py),
one rank per card over NCCL, or on the CPU over gloo.

    dryrun_multichip(2, device="cpu")
"""

from __future__ import annotations

import os
import tempfile

import torch

import numpy as np

from .configs import initial_guess
from .models.jastrow import JastrowSpin
from .models.multiply import MultiplyWF
from .models.orbitals import KPointOrbitals
from .models.slater import DeterminantExpansion, Slater
from .observables.accumulators import EnergyAccumulator
from .system.io import (DIAMOND_PRIMITIVE, H2O_CAS88, H2O_CCECP, H2O_J3_PARAMS, load_cell_npz,
                        load_expansion_npz, load_npz)
from .system.supercell import get_supercell
from .utils.dtypes import real_dtype, resolve_device
from .wftools import default_jastrow_basis, generate_wf


def h2o_setup(nconf, device=None, dtype=None, seed=0, path=H2O_CCECP):
    """(mol, wf, params, configs, accumulators) of the headline system, read
    from the committed SCF checkpoint, on the GPU unless `device` says
    otherwise: without one the default raises NoCudaDeviceError, and the CPU
    is taken only on device="cpu". dtype defaults to float32 on a CUDA
    device and float64 elsewhere; walkers come from `seed`."""
    device = resolve_device(device)
    dtype = dtype or real_dtype(device)
    mol, mf = load_npz(path)
    wf = MultiplyWF(Slater.from_mean_field(mf), JastrowSpin(mol))
    params = wf.make_params(device, dtype)
    configs = initial_guess(mol, nconf, generator=torch.Generator().manual_seed(seed),
                            device=device, dtype=dtype)
    acc = {"energy": EnergyAccumulator(mol)}
    return mol, wf, params, configs, acc


def h2o_casci_setup(nconf, device=None, dtype=None, seed=0, jastrow=True):
    """(mol, wf, params, configs, accumulators) of ccECP H2O with its
    CASCI(8e,8o) expansion over the first ncas orbitals of the SCF, times
    JastrowSpin (jastrow=False: the bare multi-determinant
    Slater, whose VMC energy is the CASCI energy). Device, dtype and
    walkers as in h2o_setup; the energy accumulator is h2o_setup's, dense
    nonlocal ECP every step."""
    device = resolve_device(device)
    dtype = dtype or real_dtype(device)
    mol, mf = load_npz(H2O_CCECP)
    d = load_expansion_npz(H2O_CAS88)
    exp = DeterminantExpansion(occ_up=d["occ_up"], occ_dn=d["occ_dn"], map_up=d["map_up"],
                               map_dn=d["map_dn"])
    ca = mf.mo_coeff[0][:, :d["ncas"]]
    wf = Slater(mol, None, exp, (ca, ca), det_coeff=d["det_coeff"])
    if jastrow:
        wf = MultiplyWF(wf, JastrowSpin(mol))
    params = wf.make_params(device, dtype)
    configs = initial_guess(mol, nconf, generator=torch.Generator().manual_seed(seed),
                            device=device, dtype=dtype)
    return mol, wf, params, configs, {"energy": EnergyAccumulator(mol)}


def h2o_casci_j3_setup(nconf, device=None, dtype=None, seed=0, params_path=H2O_J3_PARAMS):
    """(mol, wf, params, configs, accumulators) of BASELINE config 3 on
    ccECP H2O: MultiplyWF(Slater of the CASCI(8e,8o) expansion, JastrowSpin,
    ThreeBodyJastrow) from generate_wf(mol, mf, mc=(expansion, det_coeff),
    jastrow3=True), with acoeff, bcoeff and ccoeff read from params_path.
    Device, dtype and walkers as in h2o_setup; the energy accumulator is
    h2o_setup's, dense nonlocal ECP every step."""
    device = resolve_device(device)
    dtype = dtype or real_dtype(device)
    mol, mf = load_npz(H2O_CCECP)
    d = load_expansion_npz(H2O_CAS88)
    exp = DeterminantExpansion(occ_up=d["occ_up"], occ_dn=d["occ_dn"], map_up=d["map_up"],
                               map_dn=d["map_dn"])
    wf, params, _ = generate_wf(mol, mf, mc=(exp, d["det_coeff"]), jastrow3=True, device=device,
                                dtype=dtype)
    with np.load(params_path) as z:
        for leaf, key in (("wf1", "acoeff"), ("wf1", "bcoeff"), ("wf2", "ccoeff")):
            if tuple(z[key].shape) != tuple(params[leaf][key].shape):
                raise ValueError(f"{params_path}: {key} has shape {z[key].shape}, the "
                                 f"wavefunction's is {tuple(params[leaf][key].shape)}")
            params[leaf][key] = torch.as_tensor(z[key], dtype=dtype, device=device)
    configs = initial_guess(mol, nconf, generator=torch.Generator().manual_seed(seed),
                            device=device, dtype=dtype)
    return mol, wf, params, configs, {"energy": EnergyAccumulator(mol)}


EXCITED_DET_COEFF = (0.5, 0.8)  # the superposition's (ground, excited) coefficients


def h2o_excited_setup(nconf, device=None, dtype=None, seed=0, path=H2O_CCECP):
    """(mol, (wf0, wf1), (params0, params1), configs, accumulators,
    ensemble) of the two H2O states (module docstring), ensemble being the
    keyword arguments wfs, params_list and transforms of optimize_ensemble
    (state 0 frozen, the superposition's det_coeff optimized). Device,
    dtype and walkers as in h2o_setup."""
    from .observables.transform import LinearTransform

    device = resolve_device(device)
    dtype = dtype or real_dtype(device)
    mol, mf = load_npz(path)
    nup, ndn = mol.nelec
    ca = mf.mo_coeff[0][:, :nup + 1]
    ground, one = list(range(nup)), np.zeros(1, dtype=np.int64)
    excited = ground[:-1] + [nup]
    wf0 = MultiplyWF(Slater.from_mean_field(mf), JastrowSpin(mol))
    wf1 = MultiplyWF(Slater(mol, None, DeterminantExpansion(
        occ_up=np.array([excited]), occ_dn=np.array([ground]), map_up=one, map_dn=one),
        (ca, ca)), JastrowSpin(mol))
    mix = MultiplyWF(Slater(mol, None, DeterminantExpansion(
        occ_up=np.array([ground, excited]), occ_dn=np.array([ground]),
        map_up=np.array([0, 1]), map_dn=np.array([0, 0])), (ca, ca),
        det_coeff=np.array(EXCITED_DET_COEFF)), JastrowSpin(mol))
    p0, p1, pmix = (w.make_params(device, dtype) for w in (wf0, wf1, mix))
    to_opt = {"wf0": {"det_coeff": True, "mo_coeff_alpha": False, "mo_coeff_beta": False},
              "wf1": {"acoeff": False, "bcoeff": False}}
    ensemble = {"wfs": (wf0, mix), "params_list": (p0, pmix),
                "transforms": (None, LinearTransform(pmix, to_opt))}
    configs = initial_guess(mol, nconf, generator=torch.Generator().manual_seed(seed),
                            device=device, dtype=dtype)
    return mol, (wf0, wf1), (p0, p1), configs, {"energy": EnergyAccumulator(mol)}, ensemble


def diamond_setup(nconf, device=None, dtype=None, seed=0, path=DIAMOND_PRIMITIVE):
    """(supercell, wf, params, configs, accumulators) of the periodic
    diamond-C configuration: the 2 x 2 x 2 supercell of the committed
    primitive cell, KPointOrbitals(cell, kpts, (blocks, blocks),
    img_tol=1e-4) with the first 4 orbitals (the occupied ones) of every
    k-point, Slater(sup, orbitals, single(32, 32)), JastrowSpin(sup, default
    periodic basis) and EnergyAccumulator(sup). Device and dtype as in
    h2o_setup; walkers from `seed`."""
    return _diamond(nconf, device, dtype, seed, path, twist=None)


# the general twist of benchmarks/c_solid_benchmark.py:130, added to the
# fixture's k-points (cartesian, 1/bohr)
TWIST = np.array([0.023, -0.017, 0.011])
DIAMOND_IMG_TOL = 1e-4


def _diamond_jastrow(sup):
    a_basis, b_basis = default_jastrow_basis(sup)
    return JastrowSpin(sup, a_basis=a_basis, b_basis=b_basis)


def _diamond(nconf, device, dtype, seed, path, twist):
    device = resolve_device(device)
    dtype = dtype or real_dtype(device)
    cell, data = load_cell_npz(path)
    sup = get_supercell(cell, 2 * np.eye(3, dtype=int))
    kpts = np.asarray(data["kpts"])
    blocks = [np.asarray(data["mo_coeff"][k])[:, :4] for k in range(len(kpts))]
    if twist is None:
        orb = KPointOrbitals(cell, kpts, (blocks, blocks), img_tol=DIAMOND_IMG_TOL)
    else:
        orb = KPointOrbitals(cell, kpts + twist, (blocks, blocks), img_tol=DIAMOND_IMG_TOL,
                             realify=False)
    norb = 4 * len(kpts)
    slater = Slater(sup, orbitals=orb, expansion=DeterminantExpansion.single(norb, norb))
    wf = MultiplyWF(slater, _diamond_jastrow(sup))
    params = wf.make_params(device, dtype)
    configs = initial_guess(sup, nconf, generator=torch.Generator().manual_seed(seed),
                            device=device, dtype=dtype)
    return sup, wf, params, configs, {"energy": EnergyAccumulator(sup)}


def diamond_twist_setup(nconf, device=None, dtype=None, seed=0, path=DIAMOND_PRIMITIVE):
    """(supercell, wf, params, configs, accumulators) of BASELINE config 5's
    general twist: diamond_setup's configuration with the k-points shifted
    by TWIST and KPointOrbitals(..., realify=False, img_tol=1e-4), whose
    mo_coeff parameters are complex (complex64 beside float32). Device,
    dtype and walkers as in diamond_setup."""
    return _diamond(nconf, device, dtype, seed, path, twist=TWIST)


def diamond_twist_average_setup(nconf, device=None, dtype=None, seed=0, path=DIAMOND_PRIMITIVE):
    """(supercell, the keyword arguments of twist_average_vmc but its
    schedule) of the two-twist average: the union mesh of the fixture's 8
    TRIM k-points and the same 8 shifted by TWIST, every k-point's
    orbitals and occupations (the first 4 occupied), each twist's Slater
    (img_tol 1e-4) times the default periodic Jastrow, a fresh
    EnergyAccumulator per twist, and walkers from `seed` + the twist's
    index."""
    device = resolve_device(device)
    dtype = dtype or real_dtype(device)
    cell, data = load_cell_npz(path)
    sup = get_supercell(cell, 2 * np.eye(3, dtype=int))
    kpts = np.asarray(data["kpts"])
    nk = len(kpts)
    mesh = np.concatenate([kpts, kpts + TWIST])
    coeff = [np.asarray(data["mo_coeff"][k % nk]) for k in range(2 * nk)]
    occ = [np.asarray(data["mo_occ"][k % nk]) / 2.0 for k in range(2 * nk)]

    def configs_factory(ti):
        return initial_guess(sup, nconf, generator=torch.Generator().manual_seed(seed + ti),
                             device=device, dtype=dtype)

    return sup, {"cell": cell, "supercell": sup, "kpts": mesh, "mo_coeff": (coeff, coeff),
                 "mo_occ": (occ, occ), "configs_factory": configs_factory,
                 "accumulators_factory": lambda: {"energy": EnergyAccumulator(sup)},
                 "wf_factory": lambda slater: MultiplyWF(slater, _diamond_jastrow(sup)),
                 "orbital_kws": {"img_tol": DIAMOND_IMG_TOL}, "device": device, "dtype": dtype}


def _dryrun_rank(rank, n, store_path, device, backend):
    """One rank of dryrun_multichip."""
    import torch.distributed as dist

    from .method.vmc import vmc
    from .parallel.mesh import walker_mesh

    dist.init_process_group(backend, store=dist.FileStore(store_path, n), rank=rank,
                            world_size=n)
    try:
        mesh = walker_mesh(n, device=None if device.type == "cuda" else device)
        mol, wf, params, configs, acc = h2o_setup(2 * n, device=mesh.device)
        data, configs = vmc(wf, params, configs, nblocks=1, nsteps_per_block=2,
                            accumulators=acc, mesh=mesh,
                            generator=torch.Generator(device=mesh.device).manual_seed(2))
        etot = data[0]["energytotal"]
        if not np.isfinite(etot) or configs.positions.shape[0] != 2 * n:
            raise RuntimeError(f"rank {rank}: E={etot}, {configs.positions.shape[0]} walkers")
        if rank == 0:
            print(f"dryrun_multichip({n}): {backend} on {mesh.device}, E={etot:.6f} OK",
                  flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n, device=None, backend=None):
    """Spawn `n` ranks and run one H2O VMC block (2 steps, 2n walkers, the
    energy accumulator) under the walker mesh; raises where a rank fails.
    On the GPU unless device="cpu": one rank per card over NCCL (ValueError
    where there are fewer cards than ranks); backend="gloo" lets ranks
    share the cards. On the CPU, gloo."""
    import torch.multiprocessing as mp

    device = resolve_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and torch.cuda.device_count() < n:
        raise ValueError(f"NCCL needs a card per rank: {n} ranks, "
                         f"{torch.cuda.device_count()} cards (backend='gloo' shares them)")
    with tempfile.TemporaryDirectory(prefix="dryrun_multichip_") as tmp:
        mp.spawn(_dryrun_rank, args=(n, os.path.join(tmp, "store"), device, backend), nprocs=n,
                 join=True)
