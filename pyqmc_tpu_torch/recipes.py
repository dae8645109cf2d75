"""One-call workflows (counterpart of pyqmc_tpu/recipes.py).

    mol = Molecule("O 0 0 0.2217; H 0 1.4309 -0.8867; H 0 -1.4309 -0.8867", basis="sto-3g")
    OPTIMIZE(mol, output="opt.h5")
    VMC(mol, output="vmc.h5", load_parameters="opt.h5")
    DMC(mol, output="dmc.h5", load_parameters="opt.h5")
    read_mc_output("dmc.h5")

Each recipe starts from a Molecule or Cell (and a MeanField, else it runs
run_scf), or from a pyscf chkfile path (system/chkfile.recover_pyscf;
`ci_checkfile=` adds a CASCI/HCI expansion), builds the Slater x Jastrow
of generate_wf and the energy accumulator, and runs on the GPU unless
`device` says otherwise (float32 there, float64 on device="cpu").
`output=` writes the method's HDF5 file (OPTIMIZE: the line
minimization's rows and the parameters under "wf"; VMC and DMC: a row per
block, and a second call on the file continues the run);
`load_parameters=` reads OPTIMIZE's parameters. These need h5py; `params=`
carries OPTIMIZE's parameters into VMC and DMC without a file. Random
numbers come from torch.Generators seeded from `seed`: the walkers of
initial_guess from `seed` (drawn on the CPU, so a seed gives the same
walkers on every device), OPTIMIZE's equilibration from seed + 1 and its
line minimization from seed + 2, VMC from seed + 3 and DMC from seed + 4,
on the walkers' device. VMC and DMC take a walker mesh (`mesh=`,
parallel/mesh.py): every rank builds the same walkers from the seed and
sweeps its slice; `device` should then be the mesh's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import reblock as rb

from .configs import initial_guess
from .method.dmc import rundmc
from .method.linemin import line_minimization
from .method.vmc import vmc
from .observables.accumulators import EnergyAccumulator
from .observables.ecp import ECPAccumulator
from .observables.transform import LinearTransform
from .system.scf import run_scf
from .utils.dtypes import real_dtype, resolve_device
from .method.hdftools import open_hdf
from .wftools import generate_wf, read_wf_params, save_wf_params


def _generator(seed, device):
    return torch.Generator(device=device).manual_seed(int(seed))


def _resolve_system(mol, mf=None, ci_checkfile=None):
    """(mol, mf, mc) from a Molecule or Cell (and an optional MeanField) or a
    pyscf chkfile path; mc a CASCI/HCI namespace from `ci_checkfile` for
    generate_wf(mc=), else None."""
    mc = None
    if isinstance(mol, str):
        from .system.chkfile import recover_pyscf

        if mf is not None:
            raise ValueError("pass either a chkfile path or an explicit MeanField, not both")
        out = recover_pyscf(mol, ci_checkfile=ci_checkfile)
        mol, mf = out[0], out[1]
        if len(out) > 2:
            mc = out[2]
    elif ci_checkfile is not None:
        from .system.chkfile import _mc_shim, load

        casdict = load(ci_checkfile, "ci") or load(ci_checkfile, "mcscf")
        if casdict is None:
            raise ValueError(f"{ci_checkfile}: neither 'ci' nor 'mcscf' group present")
        mc = _mc_shim(casdict)
    return mol, mf, mc


def _load_parameters(path, params0):
    with open_hdf(path, "r") as f:
        return read_wf_params(f["wf"], params0)


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
    (`linemin_kws` are its keywords). output: its HDF5 file (resumed where
    it holds iterations), the parameters then written under "wf"."""
    mol, mf, wf, params, to_opt, configs, energy = _setup(
        mol, mf, nconfig, jastrow3, jastrow_kws, seed, naip, ci_checkfile, device)
    device = configs.positions.device
    lt = LinearTransform(params, to_opt)
    _, configs = vmc(wf, params, configs, nblocks=4, nsteps_per_block=10,
                     generator=_generator(seed + 1, device))
    params, configs, records = line_minimization(
        wf, params, configs, lt, energy, generator=_generator(seed + 2, device),
        max_iterations=max_iterations, hdf_file=output, verbose=verbose, **linemin_kws)
    if output is not None:
        with open_hdf(output, "a") as f:
            save_wf_params(f.require_group("wf"), params)
    return wf, params, records


def VMC(mol, output: Optional[str] = None, mf=None, params=None, nconfig=500, nblocks=50,
        nsteps_per_block=10, tstep=0.5, accumulators=None, load_parameters: Optional[str] = None,
        jastrow3=False, jastrow_kws=None, naip=None, seed=0, mesh=None, verbose=False,
        ci_checkfile=None, device=None):
    """Run VMC from new walkers; returns (block data, configs).

    params: OPTIMIZE's parameters (jastrow3 and jastrow_kws as in that
    call), else the defaults of generate_wf; load_parameters: the same read
    from OPTIMIZE's output file. accumulators: accumulator objects or
    generate_accumulators keywords, merged with the energy. output: the HDF5
    file of vmc(hdf_file=). mesh: vmc's walker mesh."""
    mol, mf, wf, params0, to_opt, configs, energy = _setup(
        mol, mf, nconfig, jastrow3, jastrow_kws, seed, naip, ci_checkfile, device)
    params = params0 if params is None else params
    if load_parameters is not None:
        params = _load_parameters(load_parameters, params0)
    accs = {"energy": energy}
    accs.update(_resolve_accumulators(mol, mf, wf, accumulators, naip=naip))
    return vmc(wf, params, configs, nblocks=nblocks, nsteps_per_block=nsteps_per_block,
               tstep=tstep, accumulators=accs,
               generator=_generator(seed + 3, configs.positions.device), verbose=verbose,
               hdf_file=output, mesh=mesh)


def DMC(mol, output: Optional[str] = None, mf=None, params=None, nconfig=500, nblocks=100,
        nsteps_per_block=10, tstep=0.02, accumulators=None, load_parameters: Optional[str] = None,
        jastrow3=False, jastrow_kws=None, naip=None, seed=0, mesh=None, verbose=False,
        ci_checkfile=None, device=None, **dmc_kws):
    """Run DMC with T-moves from new walkers (rundmc's VMC warm-up first;
    `dmc_kws` are rundmc's keywords); returns (block data, configs,
    weights). params, load_parameters and accumulators as in VMC. output:
    the HDF5 file of rundmc(hdf_file=), resumed where it holds a DMC
    checkpoint. mesh: rundmc's walker mesh."""
    mol, mf, wf, params0, to_opt, configs, energy = _setup(
        mol, mf, nconfig, jastrow3, jastrow_kws, seed, naip, ci_checkfile, device)
    params = params0 if params is None else params
    if load_parameters is not None:
        params = _load_parameters(load_parameters, params0)
    extra = _resolve_accumulators(mol, mf, wf, accumulators, naip=naip)
    if extra:
        dmc_kws["accumulators"] = {**dmc_kws.get("accumulators", {}), **extra}
    return rundmc(wf, params, configs, nblocks=nblocks, nsteps_per_block=nsteps_per_block,
                  tstep=tstep, energy_acc=energy,
                  generator=_generator(seed + 4, configs.positions.device), verbose=verbose,
                  hdf_file=output, mesh=mesh, **dmc_kws)


def read_mc_output(filename, warmup=5, reblocks=16, weights="auto"):
    """Summarize a VMC or DMC HDF5 output: per dataset after `warmup` blocks
    its mean and "<key>_err" (reblock_summary over min(reblocks, n / 2)
    groups; array-valued observables elementwise). weights: "auto" weights
    a DMC output's blocks by their mean walker weight (the "weight"
    dataset), None the unweighted analysis, or an (nblocks,) array."""
    out = {}
    with open_hdf(filename, "r") as f:
        w = None
        if isinstance(weights, str) and weights == "auto":
            if "weight" in f:
                w = np.asarray(f["weight"])[warmup:]
        elif weights is not None:
            w = np.asarray(weights)[warmup:]
        for k in f.keys():
            if k in ("configs", "wf", "weights"):
                continue
            data = np.asarray(f[k])[warmup:]
            if np.issubdtype(data.dtype, np.number) and len(data) >= 2:
                # the weight stream itself (and the block index) unweighted
                wk = None if k in ("weight", "block") else w
                s = rb.reblock_summary(data, min(reblocks, max(2, len(data) // 2)), weights=wk)
                out[k] = s["mean"]
                out[k + "_err"] = s["standard error"]
    return out


def read_opt(filename):
    """The energy, energy_err, gnorm and tau rows of an optimization's HDF5
    output."""
    with open_hdf(filename, "r") as f:
        return {k: np.asarray(f[k]) for k in ("energy", "energy_err", "gnorm", "tau") if k in f}
