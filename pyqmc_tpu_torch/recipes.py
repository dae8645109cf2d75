"""One-call workflows (counterpart of pyqmc_tpu/recipes.py:80-240).

    mol = Molecule("O 0 0 0.2217; H 0 1.4309 -0.8867; H 0 -1.4309 -0.8867", basis="sto-3g")
    wf, params, records = OPTIMIZE(mol, nconfig=1000)
    data, configs = VMC(mol, params=params, nconfig=2000, nblocks=100)
    data, configs, weights = DMC(mol, params=params, nconfig=2000)

Each recipe starts from a Molecule or Cell (and a MeanField, else it runs
run_scf), builds the Slater x Jastrow of generate_wf and the energy
accumulator, and runs on the GPU unless `device` says otherwise (float32
there, float64 on device="cpu"). `params=` carries OPTIMIZE's parameters
into VMC and DMC without a file. Random numbers come from torch.Generators
seeded from `seed`: the walkers of initial_guess from `seed` (drawn on the
CPU, so a seed gives the same walkers on every device), OPTIMIZE's
equilibration from seed + 1 and its line minimization from seed + 2, VMC
from seed + 3 and DMC from seed + 4, on the walkers' device.

The HDF5 paths (output=, load_parameters=, a chkfile path as `mol`,
ci_checkfile=, read_mc_output, read_opt) need h5py, which the GPU machine
has not got (ROADMAP queue 1 item 4); the walker mesh (mesh=) is ROADMAP
queue 1 item 8. Both raise NotImplementedError.
"""

from __future__ import annotations

from typing import Optional

import torch

from .configs import initial_guess
from .method.dmc import rundmc
from .method.linemin import line_minimization
from .method.vmc import vmc
from .observables.accumulators import EnergyAccumulator
from .observables.ecp import ECPAccumulator
from .observables.transform import LinearTransform
from .system.scf import run_scf
from .utils.dtypes import real_dtype, resolve_device
from .wftools import generate_wf

_HDF5 = ("needs h5py, which the port does not use yet (ROADMAP queue 1 item 4: the HDF5 output "
         "and restart)")


def _hdf5(what):
    raise NotImplementedError(f"{what} {_HDF5}")


def _no_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError("the walker mesh (mesh=) is not ported (ROADMAP queue 1 "
                                  "item 8)")


def _generator(seed, device):
    return torch.Generator(device=device).manual_seed(int(seed))


def _resolve_system(mol, mf=None, ci_checkfile=None):
    """(mol, mf, mc) as the JAX package's _resolve_system, for a Molecule or
    Cell; a pyscf chkfile path and ci_checkfile need h5py."""
    if isinstance(mol, str):
        _hdf5("a chkfile path as `mol`")
    if ci_checkfile is not None:
        _hdf5("ci_checkfile=")
    return mol, mf, None


def _setup(mol, mf=None, nconfig=500, jastrow3=False, jastrow_kws=None, seed=0, naip=None,
           ci_checkfile=None, device=None):
    mol, mf, mc = _resolve_system(mol, mf, ci_checkfile)
    device = resolve_device(device)
    dtype = real_dtype(device)
    if mf is None:
        mf = run_scf(mol)
    wf, params, to_opt = generate_wf(mol, mf, jastrow3=jastrow3, jastrow_kws=jastrow_kws,
                                     mc=mc, device=device, dtype=dtype)
    configs = initial_guess(mol, nconfig, generator=torch.Generator().manual_seed(int(seed)),
                            device=device, dtype=dtype)
    ecp_acc = ECPAccumulator(mol, naip=naip) if getattr(mol, "ecp", None) else None
    energy = EnergyAccumulator(mol, ecp_acc=ecp_acc)
    return mol, mf, wf, params, to_opt, configs, energy


def _slater_orbitals(wf):
    """The orbital evaluator of the Slater factor of a recipe wavefunction."""
    base = wf.wfs[0] if hasattr(wf, "wfs") else wf
    return base.orbitals


def generate_accumulators(mol, mf, wf=None, energy=True, rdm1=False, sq=False,
                          extra_accumulators=None, naip=None, sq_qlist=None, aux_sigma=1.5):
    """Observable accumulators by flag (the JAX package's
    generate_accumulators): `energy` the local energy (its ECP when mol has
    one), `rdm1` the one-body density matrix per spin (molecular: in the
    SCF's MOs; periodic: in the k-point orbitals of `wf`, which it then
    needs), `sq` the structure factors (a cell's reciprocal grid; a molecule
    needs `sq_qlist`). `extra_accumulators` are merged in; a name both
    there and asked for by a flag raises."""
    from .observables.obdm import KOBDMAccumulator, OBDMAccumulator
    from .observables.sq import SqAccumulator

    acc = {} if extra_accumulators is None else dict(extra_accumulators)
    periodic = getattr(mol, "lattice", None) is not None

    def _claim(name):
        if name in acc:
            raise ValueError(f"accumulator name '{name}' appears in extra_accumulators and is "
                             "also requested by flag")

    if energy:
        _claim("energy")
        ecp_acc = ECPAccumulator(mol, naip=naip) if getattr(mol, "ecp", None) else None
        acc["energy"] = EnergyAccumulator(mol, ecp_acc=ecp_acc)
    if rdm1:
        _claim("rdm1_up")
        _claim("rdm1_down")
        if periodic:
            if wf is None:
                raise ValueError("periodic rdm1 needs `wf` to reuse its twist-resolved k-point "
                                 "orbital evaluator")
            orb = _slater_orbitals(wf)
            acc["rdm1_up"] = KOBDMAccumulator(mol, orb, spin=0, aux_sigma=aux_sigma)
            acc["rdm1_down"] = KOBDMAccumulator(mol, orb, spin=1, aux_sigma=aux_sigma)
        else:
            ca, cb = mf.mo_coeff
            acc["rdm1_up"] = OBDMAccumulator(mol, ca, spin=0, aux_sigma=aux_sigma)
            acc["rdm1_down"] = OBDMAccumulator(mol, cb, spin=1, aux_sigma=aux_sigma)
    if sq:
        _claim("sq")
        if periodic:
            acc["sq"] = SqAccumulator(mol)
        elif sq_qlist is not None:
            acc["sq"] = SqAccumulator(qlist=sq_qlist)
        else:
            raise ValueError("sq=True on an open system needs an explicit sq_qlist")
    return acc


def _resolve_accumulators(mol, mf, wf, accumulators, naip=None):
    """VMC/DMC `accumulators`: a dict of accumulator objects, or a dict of
    generate_accumulators keywords (such as {"rdm1": True})."""
    if not accumulators:
        return {}
    if all(hasattr(v, "avg") for v in accumulators.values()):
        return dict(accumulators)
    return generate_accumulators(mol, mf, wf=wf, energy=False, naip=naip, **accumulators)


def OPTIMIZE(mol, output: Optional[str] = None, mf=None, nconfig=500, max_iterations=15,
             jastrow3=False, jastrow_kws=None, naip=None, seed=0, verbose=False,
             ci_checkfile=None, device=None, **linemin_kws):
    """Optimize the Slater-Jastrow's Jastrow; returns (wf, params, records):
    4 x 10 VMC steps of equilibration, then line_minimization
    (`linemin_kws` are its keywords)."""
    if output is not None:
        _hdf5("output=")
    mol, mf, wf, params, to_opt, configs, energy = _setup(
        mol, mf, nconfig, jastrow3, jastrow_kws, seed, naip, ci_checkfile, device)
    device = configs.positions.device
    lt = LinearTransform(params, to_opt)
    _, configs = vmc(wf, params, configs, nblocks=4, nsteps_per_block=10,
                     generator=_generator(seed + 1, device))
    params, configs, records = line_minimization(
        wf, params, configs, lt, energy, generator=_generator(seed + 2, device),
        max_iterations=max_iterations, verbose=verbose, **linemin_kws)
    return wf, params, records


def VMC(mol, output: Optional[str] = None, mf=None, params=None, nconfig=500, nblocks=50,
        nsteps_per_block=10, tstep=0.5, accumulators=None, load_parameters: Optional[str] = None,
        jastrow3=False, jastrow_kws=None, naip=None, seed=0, mesh=None, verbose=False,
        ci_checkfile=None, device=None):
    """Run VMC from new walkers; returns (block data, configs).

    params: OPTIMIZE's parameters (jastrow3 and jastrow_kws as in that
    call), else the defaults of generate_wf. accumulators: accumulator
    objects or generate_accumulators keywords, merged with the energy."""
    if output is not None:
        _hdf5("output=")
    if load_parameters is not None:
        _hdf5("load_parameters=")
    _no_mesh(mesh)
    mol, mf, wf, params0, to_opt, configs, energy = _setup(
        mol, mf, nconfig, jastrow3, jastrow_kws, seed, naip, ci_checkfile, device)
    params = params0 if params is None else params
    accs = {"energy": energy}
    accs.update(_resolve_accumulators(mol, mf, wf, accumulators, naip=naip))
    return vmc(wf, params, configs, nblocks=nblocks, nsteps_per_block=nsteps_per_block,
               tstep=tstep, accumulators=accs,
               generator=_generator(seed + 3, configs.positions.device), verbose=verbose)


def DMC(mol, output: Optional[str] = None, mf=None, params=None, nconfig=500, nblocks=100,
        nsteps_per_block=10, tstep=0.02, accumulators=None, load_parameters: Optional[str] = None,
        jastrow3=False, jastrow_kws=None, naip=None, seed=0, mesh=None, verbose=False,
        ci_checkfile=None, device=None, **dmc_kws):
    """Run DMC with T-moves from new walkers (rundmc's VMC warm-up first;
    `dmc_kws` are rundmc's keywords); returns (block data, configs,
    weights). params and accumulators as in VMC."""
    if output is not None:
        _hdf5("output=")
    if load_parameters is not None:
        _hdf5("load_parameters=")
    _no_mesh(mesh)
    mol, mf, wf, params0, to_opt, configs, energy = _setup(
        mol, mf, nconfig, jastrow3, jastrow_kws, seed, naip, ci_checkfile, device)
    params = params0 if params is None else params
    extra = _resolve_accumulators(mol, mf, wf, accumulators, naip=naip)
    if extra:
        dmc_kws["accumulators"] = {**dmc_kws.get("accumulators", {}), **extra}
    return rundmc(wf, params, configs, nblocks=nblocks, nsteps_per_block=nsteps_per_block,
                  tstep=tstep, energy_acc=energy,
                  generator=_generator(seed + 4, configs.positions.device), verbose=verbose,
                  **dmc_kws)


def read_mc_output(filename, warmup=5, reblocks=16, weights="auto"):
    """Summarize a VMC/DMC HDF5 output: needs h5py (ROADMAP queue 1 item 4)."""
    _hdf5("read_mc_output")


def read_opt(filename):
    """Summarize an optimization HDF5 output: needs h5py (ROADMAP queue 1 item 4)."""
    _hdf5("read_opt")
