"""Twist-averaged boundary conditions (counterpart of
pyqmc_tpu/method/twist_average.py:20-77).

Group a primitive k-mesh by supercell twist, build one k-point Slater per
twist (real mode at a time-reversal-invariant twist, complex otherwise),
run VMC per twist and average the twists with equal weights.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.orbitals import KPointOrbitals
from ..models.slater import DeterminantExpansion, Slater
from ..system.supercell import create_supercell_twists
from ..utils.dtypes import real_dtype, resolve_device
from .vmc import vmc as vmc_run


def build_twist_wf(cell, supercell, kpts, mo_coeff, mo_occ, twist_indices, **orbital_kws):
    """The Slater wavefunction of one twist.

    mo_coeff: per spin a list over ALL primitive k of (nao, nmo) arrays;
    mo_occ likewise, occupation numbers (an orbital is occupied above 0.5).
    twist_indices selects the twist's k-points; orbital_kws go to
    KPointOrbitals (img_tol, realify)."""
    blocks_a, blocks_b, na, nb = [], [], 0, 0
    for k in twist_indices:
        occ_a = np.asarray(mo_occ[0][k]) > 0.5
        occ_b = np.asarray(mo_occ[1][k]) > 0.5
        blocks_a.append(np.asarray(mo_coeff[0][k])[:, occ_a])
        blocks_b.append(np.asarray(mo_coeff[1][k])[:, occ_b])
        na += int(occ_a.sum())
        nb += int(occ_b.sum())
    if (na, nb) != tuple(supercell.nelec):
        raise ValueError(f"twist occupations {(na, nb)} != supercell nelec {supercell.nelec}")
    orb = KPointOrbitals(cell, np.asarray(kpts)[list(twist_indices)], (blocks_a, blocks_b),
                         **orbital_kws)
    return Slater(supercell, orbitals=orb, expansion=DeterminantExpansion.single(na, nb))


def twist_average_vmc(cell, supercell, kpts, mo_coeff, mo_occ, configs_factory, generator=None,
                      accumulators_factory=None, wf_factory=None, orbital_kws=None, device=None,
                      dtype=None, **vmc_kwargs):
    """VMC at every twist of the k-mesh `kpts`; returns (per-twist records,
    averages).

    configs_factory(twist_index) -> the twist's initial Configs;
    accumulators_factory() -> a fresh accumulator dict per twist;
    wf_factory(slater) -> the wavefunction of a twist's Slater (default: the
    Slater alone), e.g. a MultiplyWF with a Jastrow. Twists run in sorted
    order, each with wf.make_params(device, dtype), its VMC drawing from the
    one torch `generator` in turn. A record holds the twist, its k-point
    indices, whether its orbitals run in real mode, and its block data. The
    averages are, for every block quantity, the equal-weight mean over twists
    of each twist's mean over its blocks after the first max(1, nblocks // 4)
    (the JAX package's rule)."""
    device = resolve_device(device)
    dtype = dtype or real_dtype(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    records = []
    twists = create_supercell_twists(supercell, kpts)
    for ti, (tkey, idx) in enumerate(sorted(twists.items())):
        slater = build_twist_wf(cell, supercell, kpts, mo_coeff, mo_occ, idx,
                                **(orbital_kws or {}))
        wf = wf_factory(slater) if wf_factory else slater
        accs = accumulators_factory() if accumulators_factory else None
        data, _ = vmc_run(wf, wf.make_params(device, dtype), configs_factory(ti),
                          accumulators=accs, generator=generator, **vmc_kwargs)
        records.append({"twist": tkey, "kpt_indices": idx, "real_mode": slater.orbitals.real_mode,
                        "data": data})
    avg = {}
    warm = max(1, len(records[0]["data"]) // 4)
    for k in records[0]["data"][0]:
        if k in ("block", "block time"):  # bookkeeping, not an observable
            continue
        avg[k] = np.mean([np.mean([blk[k] for blk in r["data"][warm:]], axis=0) for r in records],
                         axis=0)
    return records, avg
