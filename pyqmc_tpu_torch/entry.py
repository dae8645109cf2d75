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

`diamond_setup` (counterpart of benchmarks/c_solid_benchmark.py:123-154,
the TRIM branch): the 2x2x2 supercell of ccECP diamond-C, 16 atoms and 64
valence electrons, k-point Slater (8 TRIM k-points x 4 occupied orbitals
per spin, realified) times the default periodic Jastrow, Ewald energies and
the downselected nonlocal ECP.

    sup, wf, params, configs, acc = diamond_setup(nconf=500)
    blocks, configs = vmc(wf, params, configs, nblocks=4,
                          nsteps_per_block=10, accumulators=acc)
"""

from __future__ import annotations

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


def diamond_setup(nconf, device=None, dtype=None, seed=0, path=DIAMOND_PRIMITIVE):
    """(supercell, wf, params, configs, accumulators) of the periodic
    diamond-C configuration: the 2 x 2 x 2 supercell of the committed
    primitive cell, KPointOrbitals(cell, kpts, (blocks, blocks),
    img_tol=1e-4) with the first 4 orbitals (the occupied ones) of every
    k-point, Slater(sup, orbitals, single(32, 32)), JastrowSpin(sup, default
    periodic basis) and EnergyAccumulator(sup). Device and dtype as in
    h2o_setup; walkers from `seed`."""
    device = resolve_device(device)
    dtype = dtype or real_dtype(device)
    cell, data = load_cell_npz(path)
    sup = get_supercell(cell, 2 * np.eye(3, dtype=int))
    kpts = np.asarray(data["kpts"])
    blocks = [np.asarray(data["mo_coeff"][k])[:, :4] for k in range(len(kpts))]
    orb = KPointOrbitals(cell, kpts, (blocks, blocks), img_tol=1e-4)
    norb = 4 * len(kpts)
    slater = Slater(sup, orbitals=orb, expansion=DeterminantExpansion.single(norb, norb))
    a_basis, b_basis = default_jastrow_basis(sup)
    wf = MultiplyWF(slater, JastrowSpin(sup, a_basis=a_basis, b_basis=b_basis))
    params = wf.make_params(device, dtype)
    configs = initial_guess(sup, nconf, generator=torch.Generator().manual_seed(seed),
                            device=device, dtype=dtype)
    return sup, wf, params, configs, {"energy": EnergyAccumulator(sup)}
