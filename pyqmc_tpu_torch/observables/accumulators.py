"""Energy accumulator (counterpart of `EnergyAccumulator` in
pyqmc_tpu/observables/accumulators.py): open-boundary Coulomb, or Ewald
sums for a periodic cell.

Protocol: acc(wf, params, state, positions, rot, u_sel=None) -> dict of
per-walker tensors; acc.avg(...) -> dict of walker means (0-d tensors, or
arrays for an array-valued output, still on the device). `rot` (nelec,
nconf, 3, 3) are the step's ECP quadrature rotations and `u_sel` (nelec,
nconf) its downselection uniforms (used where the ECP evaluates a subset of
its quadrature points).

An accumulator that needs random numbers of its own (the JAX accumulators
draw them from their key: the auxiliary points of the density matrices)
says so with a method draw(generator, nsteps, nconf, device, dtype) ->
{key: tensor (nsteps, ...)}, the numbers of every step of a block, and
takes one step's slice as the keyword `draws`: acc(wf, params, state,
positions, rot=None, u_sel=None, draws=...). The blocks (method/vmc.py,
method/dmc.py, method/sample_many.py) draw them once per block, after
their own streams, and accept them in a `streams` dict, so a test can feed
the JAX package's numbers.
"""

import torch

from .ecp import ECPAccumulator
from .energy import OpenCoulomb, kinetic_energy
from .ewald import Ewald


class EnergyAccumulator:
    """{ke, ee, ei, ii, ecp, grad2, total} local-energy accumulator."""

    def __init__(self, mol, ecp_acc=None, ewald=None):
        """ecp_acc: an ECPAccumulator, None to build one when mol carries an
        ECP, or False to leave the ECP term out. ewald: the Ewald sums of a
        periodic cell, None to build them with their defaults."""
        self.mol = mol
        self.periodic = getattr(mol, "lattice", None) is not None
        if self.periodic:
            self.coulomb = ewald if ewald is not None else Ewald(mol)
        else:
            self.coulomb = OpenCoulomb(mol)
        if ecp_acc is None and mol.ecp:
            ecp_acc = ECPAccumulator(mol)
        self.ecp_acc = ecp_acc or None

    def __call__(self, wf, params, state, positions, rot=None, u_sel=None, with_imag=False):
        """Per-walker components, real for any wavefunction; with_imag adds
        "total_im", the imaginary part of a complex wavefunction's local
        energy (kinetic and ECP; zero in expectation)."""
        ke, grad2, *ke_im = kinetic_energy(wf, params, state, positions, with_imag=with_imag)
        ee, ei, ii = self.coulomb.energy(positions)
        out = {"ke": ke, "ee": ee, "ei": ei, "ii": ii, "grad2": grad2}
        ecp_im = 0.0
        if self.ecp_acc is not None:
            if rot is None:
                raise ValueError("the ECP energy needs the step's quadrature rotations")
            out["ecp"] = self.ecp_acc(wf, params, state, positions, rot, u_sel,
                                      with_imag=with_imag)
            if with_imag:
                out["ecp"], ecp_im = out["ecp"]
        else:
            out["ecp"] = torch.zeros_like(ke)
        out["total"] = ke + ee + ei + ii + out["ecp"]
        if with_imag:
            out["total_im"] = ke_im[0] + ecp_im
        return out

    def avg(self, wf, params, state, positions, rot=None, u_sel=None):
        return {k: torch.mean(v, dim=0)
                for k, v in self(wf, params, state, positions, rot, u_sel).items()}


def gradient_generator(mol, wf, params, to_opt=None, naip=None, eps=1e-3, nodal_cutoff=1e-3,
                       **ewald_kws):
    """The SR accumulator of a wavefunction optimization: an
    EnergyAccumulator (the ECP with `naip` where mol carries one; for a
    periodic cell, Ewald sums built with ewald_kws when any are given) and
    a LinearTransform of the optimized subset `to_opt` of params, wired
    into a StochasticReconfiguration."""
    from .sr import StochasticReconfiguration
    from .transform import LinearTransform

    ecp_acc = ECPAccumulator(mol, naip=naip) if mol.ecp else None
    ewald = None
    if getattr(mol, "lattice", None) is not None and ewald_kws:
        ewald = Ewald(mol, **ewald_kws)
    energy = EnergyAccumulator(mol, ecp_acc=ecp_acc, ewald=ewald)
    return StochasticReconfiguration(energy, LinearTransform(params, to_opt), eps=eps,
                                     nodal_cutoff=nodal_cutoff)
