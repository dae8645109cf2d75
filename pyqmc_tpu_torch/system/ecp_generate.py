"""Generate ccECP-form pseudopotentials from scratch, the "tpu1" set
(counterpart of pyqmc_tpu/system/ecp_generate.py; host numpy and scipy,
float64, on the port's system/scf.py, ops/gto.eval_gto on float64 CPU
tensors and system/ecp_integrals._angular_grid).

The pseudopotentials are fitted so the pseudo-atom reproduces this
package's own all-electron UHF valence physics:

  targets per occupied valence channel l:
    - the valence orbital eigenvalue eps_l (energy consistency), and
    - the valence orbital radial moment <r>_l (shape/norm consistency
      outside the core),
  computed with the same SCF engine in large even-tempered seas, so
  systematic basis errors largely cancel between the two sides.

Functional form (identical to ccECP / the pyscf "rnExp" convention used by
observables/ecp.py and system/ecp_integrals.py):

  V_loc(r) = -Zeff/r [1 - e^{-a1 r^2}] + Zeff a1 r e^{-a1 r^2}
  V_l(r)   = c_l e^{-b_l r^2}   (projector on l, for each l < l_local)

i.e. local entries [(1, a1, Zeff), (3, a1, Zeff*a1)]: the n=1 coefficient
equals Zeff and the n=3 coefficient equals Zeff*a1, as in the published
tables. The core-turnover scale a1 is set from the all-electron core
radius; the projector parameters (b_l, c_l) are fitted by least squares.
They are not the published ccECP parameters: the library key is "tpu1"
(system/tpu1_library.py holds the tables these generators made).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .elements import atomic_number


# Hund ground-state spin (2S) for neutral atoms, valence shells
GROUND_SPIN = {
    1: 1, 2: 0, 3: 1, 4: 0, 5: 1, 6: 2, 7: 3, 8: 2, 9: 1, 10: 0,
    11: 1, 12: 0, 13: 1, 14: 2, 15: 3, 16: 2, 17: 1, 18: 0,
    19: 1, 20: 0, 21: 1, 22: 2, 23: 3, 24: 6, 25: 5, 26: 4, 27: 3,
    28: 2, 29: 1, 30: 0,
}

# 2S of the +1 cation where it differs from the Z-1 NEUTRAL atom's ground
# state. p-block cations are isoelectronic AND isoconfigurational with the
# Z-1 atom, so GROUND_SPIN[Z-1] is right there; 3d cations are not — the
# 4s electron leaves and the d shell holds (Ti+ d2s1 4F, Cu+ d10 1S),
# unlike the isoelectronic neutral (Sc d1s2 2D, Ni d8s2 3F).
CATION_SPIN = {22: 3, 26: 5, 29: 0}


def cation_spin(Z: int) -> int:
    return CATION_SPIN.get(Z, GROUND_SPIN.get(Z - 1, 0))


def _atom_scf(symbol, basis, ecp, spin, cache=None, charge=0, init_C=None,
              e_ref=None, e_tol=0.1):
    """Atomic UHF robust against excited-state SCF minima: atomic cations
    (and weak trial ECPs) can converge to aufbau-violating solutions (e.g.
    B+ landing on 1s2 2p2 — the hydrogenic core guess leaves 2s/2p
    degenerate). Runs a plain start, a level-shifted start, and optionally
    an orbital-guess start (the converged neutral's MOs), keeping the
    lowest converged energy."""
    from .mole import Molecule
    from .scf import run_scf

    mol = Molecule(
        f"{symbol} 0 0 0", basis={symbol: basis},
        ecp=None if ecp is None else {symbol: ecp}, spin=spin, charge=charge,
    )
    if init_C is not None:
        # warm start (previous fit iterate's MOs): when it converges, skip
        # the robustness ladder entirely — the ECP generator's fit loop
        # runs hundreds of SCFs whose solutions move by tiny parameter
        # steps, and re-running the cold plain + level-shift attempts each
        # time cost minutes per residual evaluation for 3d-metal seas.
        # Convergence alone is NOT acceptance: a warm start can converge
        # into a DIFFERENT (excited) SCF basin, which would be re-cached
        # and silently poison every later residual for this (spin, charge)
        # — so the shortcut also requires the energy to sit within e_tol
        # of the previous iterate's (e_ref); a suspicious jump falls
        # through to the ladder, which keeps the lowest converged energy.
        try:
            mf = run_scf(mol, integrals_cache=cache, conv_tol=1e-9,
                         init_C=init_C)
            if (np.isfinite(mf.e_tot) and mf.converged
                    and (e_ref is None or mf.e_tot < e_ref + e_tol)):
                return mol, mf
        except Exception:
            pass
    attempts = [{}, {"level_shift": 0.5}]
    if init_C is not None:
        attempts.insert(0, {"init_C": init_C})
    best = None
    for kws in attempts:
        try:
            mf = run_scf(mol, integrals_cache=cache, conv_tol=1e-9, **kws)
        except Exception:
            continue
        if np.isfinite(mf.e_tot) and (best is None or mf.e_tot < best.e_tot - 1e-9):
            best = mf
    if best is None:
        raise RuntimeError(f"atomic SCF failed for {symbol} charge={charge}")
    return mol, best


def _mo_l_character(mol, mf, ncols=None):
    """Per-MO dominant angular momentum and purity (alpha spin).

    Returns (l_of_mo, purity) arrays over the first `ncols` alpha MOs
    (default: the occupied ones). Atomic MOs are symmetry-pure, so
    purity ~1."""
    nocc = mol.nelec[0] if ncols is None else ncols
    C = np.asarray(mf.mo_coeff[0])[:, :nocc]
    lmax = max(sh.l for sh in mol.shells)
    weights = np.zeros((lmax + 1, nocc))
    for sh in mol.shells:
        for m in range(2 * sh.l + 1):
            weights[sh.l] += C[sh.ao_offset + m] ** 2
    weights /= np.maximum(weights.sum(axis=0), 1e-300)
    return np.argmax(weights, axis=0), np.max(weights, axis=0)


def _radial_moment(mol, mf, col, nrad=400, rmax=40.0):
    """<r> of occupied alpha MO `col`, by numerical quadrature.

    Atomic MOs factor as R(r)Y_lm; integrate |MO|^2 r over a radial grid
    times a coarse angular average (exact for a single Y_lm since |Y|^2
    integrates to 1/(4pi) per point average)."""
    import torch

    from ..ops.gto import GTOSpec, eval_gto
    from .ecp_integrals import _angular_grid

    spec = GTOSpec.from_molecule(mol)
    C = np.asarray(mf.mo_coeff[0])[:, col]
    # log-spaced radial grid with trapezoid weights
    r = np.geomspace(1e-4, rmax, nrad)
    wr = np.gradient(r)
    pts, wang = _angular_grid(ntheta=12, nphi=12)  # integrates to 4pi
    xyz = (r[:, None, None] * pts[None, :, :]).reshape(-1, 3)
    ao = eval_gto(spec, torch.as_tensor(xyz, dtype=torch.float64), 0).numpy()  # (nrad*nang, nao)
    mo = (ao @ C).reshape(nrad, len(wang))
    dens_r = (mo**2 @ wang) * r**2  # 4pi r^2 |R Y|^2 angular-integrated
    norm = float(np.sum(dens_r * wr))
    return float(np.sum(dens_r * r * wr) / norm)


def core_counts(ncore):
    """Per-l number of CORE orbitals for a noble-gas core size."""
    return {
        0: {},
        2: {0: 1},               # [He]
        10: {0: 2, 1: 1},        # [Ne]
        18: {0: 3, 1: 2},        # [Ar]
    }[ncore]


def _channel_levels(mol, mf, lmax_val, ncore_l=None):
    """{l: [(eps, <r>), ...]} valence levels per channel (innermost first)
    plus the core radius.

    Occupied alpha MOs are classified by dominant l; per channel the first
    ncore_l[l]*(2l+1) columns — ALL m-components of every core shell — are
    dropped and their <r> folded into the returned core radius. A channel
    l <= lmax_val left with NO occupied valence column falls back to the
    LOWEST VIRTUAL level of that l (e.g. 3p for Na/Mg, 3s/3p for the bare
    Na+ pseudo-ion): the alpha-Fock virtual eigenvalue is the
    electron-attachment level of the same mean-field potential on both the
    all-electron and pseudo sides, so matching it pins that channel's
    scattering in the bonding energy range instead of leaving the channel
    entirely to the local potential."""
    nocc = mol.nelec[0]
    nmo = np.asarray(mf.mo_coeff[0]).shape[1]
    l_of, _ = _mo_l_character(mol, mf, ncols=nmo)
    eps = np.asarray(mf.mo_energy[0])
    ncore_l = ncore_l or {}
    targets, core_r = {}, 0.0
    for l in range(lmax_val + 1):
        occ = sorted((c for c in range(nocc) if l_of[c] == l),
                     key=lambda c: eps[c])
        ncl = ncore_l.get(l, 0) * (2 * l + 1)
        for c in occ[:ncl]:
            core_r = max(core_r, _radial_moment(mol, mf, c))
        val = occ[ncl:]
        if not val:
            # bound virtuals only: an unbound (eps >~ 0) lowest virtual is
            # a finite-basis continuum artifact whose eigenvalue tracks the
            # most diffuse exponent, not the potential — matching it across
            # the different AE/valence seas would bias the channel. Bound
            # attachment levels (Na+ 3s/3p, Mg+ 3p, Al+ 3p, Cu+ 4s)
            # converge with basis and are exactly the one-electron levels a
            # semilocal ECP should reproduce.
            virt = sorted((c for c in range(nocc, nmo)
                           if l_of[c] == l and eps[c] < -0.02),
                          key=lambda c: eps[c])
            val = virt[:1]
        if val:
            targets[l] = [
                (float(eps[c]), _radial_moment(mol, mf, c)) for c in val
            ]
    return targets, core_r


def all_electron_targets(symbol, ncore, lmax_val=1, sea=None, spin=None,
                         charge=0, init_C=None, cache=None):
    """All-electron UHF valence targets {l: [(eps, <r>), ...]} (every
    occupied valence level of each l, semicore included, innermost first;
    lowest-virtual fallback for channels with no occupied valence level)
    plus the core radius (largest <r> among core orbitals, used to set the
    local-channel turnover scale)."""
    Z = atomic_number(symbol)
    if spin is None:
        spin = GROUND_SPIN[Z]
    if sea is None:
        # exponents must cover the core cusp (~Z^2*30) down to the valence
        # tail (~0.03)
        hi = 30.0 * Z**2
        n = int(np.ceil(np.log(hi / 0.025) / np.log(2.4))) + 1
        sea = [
            [l, [0.025 * 2.4**k, 1.0]]
            for l in range(lmax_val + 1)
            for k in range(n)
        ]
    mol, mf = _atom_scf(symbol, sea, None, spin, charge=charge,
                        init_C=init_C, cache=cache)
    targets, core_r = _channel_levels(mol, mf, lmax_val, core_counts(ncore))
    return {
        "targets": targets,
        "core_radius": core_r,
        "e_tot": float(mf.e_tot),
        "spin": spin,
        "mo_coeff": mf.mo_coeff,
    }


def _local_entries(zeff, a1, a3=None, gamma=0.0):
    # pyscf rnExp convention: powers r^{n-2}; the -Zeff/r Coulomb tail is
    # implicit. Constraints: n=1 coeff = Zeff, n=3 coeff = Zeff*a1 (the
    # published-table transcription checks); the optional n=2 gamma
    # gaussian is the extra local shape DOF every ccECP entry carries.
    n2 = [] if gamma == 0.0 else [[a3 if a3 is not None else a1, gamma]]
    return [
        [-1, [[], [[a1, zeff]], n2, [[a1, zeff * a1]], [], [], []]],
    ]


def _assemble_ecp(ncore, zeff, a1, channels, a3=None, gamma=0.0):
    """pyscf-format [ncore, [[l, coeff-by-power blocks]...]] entry."""
    entry = list(_local_entries(zeff, a1, a3, gamma))
    for l, (b, c) in sorted(channels.items()):
        blocks = [[], [], [[b, c]], [], [], [], []]  # n=2 -> r^0 gaussian
        entry.append([l, blocks])
    return [ncore, entry]


def _valence_sea(lmax, alpha0=0.03, beta=2.4, n=12, extra_l=()):
    ls = list(range(lmax + 1)) + list(extra_l)
    return [[l, [alpha0 * beta**k, 1.0]] for l in ls for k in range(n)]


def pseudo_atom_levels(symbol, ecp_entry, lmax_val, spin, sea=None,
                       cache=None):
    """{l: [(eps, <r>), ...]} of the pseudo-atom with a trial ECP
    (all occupied levels per l, innermost first)."""
    if sea is None:
        sea = _valence_sea(lmax_val)
    mol, mf = _atom_scf(symbol, sea, ecp_entry, spin, cache=cache)
    out, _ = _channel_levels(mol, mf, lmax_val)
    return out, float(mf.e_tot)


def generate_ecp(symbol, ncore, lmax_val=1, verbose=False, maxiter=40):
    """Fit a tpu1 pseudopotential; returns (pyscf entry, info dict).

    Free parameters: the local shape (a1 with the two form-constrained
    coefficients, plus a gamma gaussian at its own exponent a3 — the same
    DOFs every published ccECP local channel has) and one (exponent,
    coefficient) gaussian projector per l with occupied valence levels.
    Targets: every NEUTRAL valence level's eigenvalue per l + the outermost
    level's <r> (shape), plus energy consistency against the CATION — the
    all-electron first ionization energy and the cation's valence
    eigenvalues, all from this package's own UHF. Channels without
    occupied levels (e.g. p for Na/Mg) fall back to the local channel."""
    import scipy.optimize

    Z = atomic_number(symbol)
    zeff = Z - ncore
    ae_cache = {}  # S/T/V/ERI of the AE sea, shared neutral<->cation
    ae = all_electron_targets(symbol, ncore, lmax_val=lmax_val,
                              cache=ae_cache)
    spin = ae["spin"]
    ion_spin = cation_spin(Z)
    ae_ion = all_electron_targets(symbol, ncore, lmax_val=lmax_val,
                                  spin=ion_spin, charge=1,
                                  init_C=ae["mo_coeff"], cache=ae_cache)
    ip_ae = ae_ion["e_tot"] - ae["e_tot"]
    rc = max(ae["core_radius"], 0.05)
    tl = sorted(ae["targets"])
    tl_ion = sorted(ae_ion["targets"])
    # one projector per channel constrained by EITHER side: e.g. Na/Mg have
    # no occupied/bound-virtual neutral p level, but the cation's bound 3p
    # attachment level pins a p projector
    cl = sorted(set(tl) | set(tl_ion))
    sea = _valence_sea(lmax_val)
    cache = {}  # one-electron/ERI integrals of the fixed sea, reused

    def unpack(x):
        a1 = float(np.exp(x[0]))
        a3 = float(np.exp(x[1]))
        gamma = float(x[2])
        ch = {}
        for i, l in enumerate(cl):
            # exponent in log space (positive); coefficient SIGNED — a
            # channel with no core orbitals of that l (e.g. p for a
            # [He]-core atom) needs an attractive or near-zero projector,
            # which an exp() parameterization cannot reach (the optimizer
            # then parks the exponent at ~1e3 to neutralize the term and
            # the channel can never be fit).
            ch[l] = (float(np.exp(x[3 + 2 * i])), float(x[4 + 2 * i]))
        return a1, a3, gamma, ch

    warm = {}  # (spin, charge) -> (last successful MOs, e_tot): warm-starts
    # the fit loop's SCFs (tiny parameter steps between residual
    # evaluations); e_tot gates acceptance of the warm-start shortcut

    def levels_for(entry, sp, charge, init_C=None):
        cached = warm.get((sp, charge))
        ic = init_C if init_C is not None else (
            cached[0] if cached is not None else None
        )
        e_ref = cached[1] if cached is not None else None
        mol, mf = _atom_scf(symbol, sea, entry, sp, cache=cache,
                            charge=charge, init_C=ic, e_ref=e_ref)
        warm[(sp, charge)] = (mf.mo_coeff, float(mf.e_tot))
        out, _ = _channel_levels(mol, mf, lmax_val)
        return out, float(mf.e_tot), mf.mo_coeff

    def residual(x):
        a1, a3, gamma, ch = unpack(x)
        entry = _assemble_ecp(ncore, zeff, a1, ch, a3, gamma)
        out = []
        try:
            levels, e0, c0 = levels_for(entry, spin, 0)
            levels_ion, e1, _ = levels_for(entry, ion_spin, 1, init_C=c0)
        except Exception:
            nres = (sum(len(v) for v in ae["targets"].values())
                    + len(tl) + 1 + len(tl_ion))
            return np.full(nres, 10.0)
        for l in tl:
            want = ae["targets"][l]
            got = levels.get(l, [])
            for j, (e_ae, r_ae) in enumerate(want):
                if j < len(got):
                    e_ps, r_ps = got[j]
                    out.append(e_ps - e_ae)
                    if j == len(want) - 1:
                        out.append(0.5 * (r_ps - r_ae) / r_ae)
                else:
                    out.append(10.0)
                    if j == len(want) - 1:
                        out.append(10.0)
        # energy consistency: ionization energy (weight 2) + cation levels
        out.append(2.0 * ((e1 - e0) - ip_ae))
        for l in tl_ion:
            e_ae_i, _ = ae_ion["targets"][l][-1]
            got = levels_ion.get(l, [])
            out.append(got[-1][0] - e_ae_i if got else 10.0)
        if verbose:
            print(f"  {symbol} resid {np.abs(np.asarray(out)).max():.5f}",
                  flush=True)
        return np.asarray(out)

    ncore_l = core_counts(ncore)
    x0 = [np.log(2.0 / rc**2), np.log(2.0 / rc**2), 0.0]
    lo = [np.log(0.05), np.log(0.05), -60.0]
    hi = [np.log(200.0), np.log(200.0), 60.0]
    for l in cl:
        # repulsive start only where there are core orbitals to screen.
        # A coreless d channel starts ATTRACTIVE: early 3d metals bind the
        # 3d level only weakly (Ti eps_3d ~ -0.44), and a repulsive trial
        # projector unbinds it entirely — every d residual then sits on the
        # flat missing-level penalty and the optimizer gets no gradient
        # toward binding it (observed: Ti stuck at resid 10.0).
        if ncore_l.get(l, 0):
            c0 = float(max(zeff, 2.0))
        else:
            c0 = -2.0 if l >= 2 else 1.0
        x0.extend([np.log(1.5 / rc**2), c0])
        lo.extend([np.log(0.05), -80.0])
        hi.extend([np.log(80.0), 200.0])
    x0 = np.asarray(x0)
    # seed the warm-start cache from a zero-projector (local-only) atom:
    # the bare -Zeff/r local potential binds the full valence configuration
    # (d electrons included), and DIIS from those MOs keeps subsequent
    # trial-ECP SCFs in the ground-configuration basin
    try:
        zero_ch = {l: (1.5 / rc**2, 0.0) for l in cl}
        a1_0 = float(np.exp(x0[0]))
        a3_0 = float(np.exp(x0[1]))
        levels_for(_assemble_ecp(ncore, zeff, a1_0, zero_ch, a3_0, 0.0),
                   spin, 0)
        levels_for(_assemble_ecp(ncore, zeff, a1_0, zero_ch, a3_0, 0.0),
                   ion_spin, 1)
    except Exception:
        pass
    # diff_step well above SCF convergence noise: each residual entry is
    # itself the output of an iterative solve converged to ~1e-9, so the
    # default sqrt(eps) finite-difference step yields a noise jacobian.
    # tolerances sized to stop the flat converged tail (observed: ~half of
    # a default-tolerance run's SCF evals sit on a <0.1 mHa plateau)
    # without cutting the productive descent short
    res = scipy.optimize.least_squares(
        residual, x0, method="trf", bounds=(np.asarray(lo), np.asarray(hi)),
        diff_step=1e-3, xtol=3e-5, ftol=3e-6, gtol=1e-12,
        max_nfev=maxiter * max(len(x0), 1),
    )
    a1, a3, gamma, ch = unpack(res.x)
    entry = _assemble_ecp(ncore, zeff, a1, ch, a3, gamma)
    levels, e_ps = pseudo_atom_levels(symbol, entry, lmax_val, spin, sea,
                                      cache=cache)
    info = {
        "ae_targets": ae["targets"],
        "ae_ion_targets": ae_ion["targets"],
        "pseudo_levels": levels,
        "a1": a1,
        "zeff": zeff,
        "spin": spin,
        "ip_ae": ip_ae,
        "max_resid": float(np.abs(res.fun).max()),
        "e_pseudo": e_ps,
    }
    return entry, info


def to_nwchem(symbol, entry) -> str:
    """Render a pyscf-format entry as NWChem exchange-format text (the
    format system/basis.py parses and transcription-tests)."""
    ncore, blocks = entry
    lines = [f"{symbol} nelec {ncore}"]
    letters = "SPDFGHI"
    for l, powers in blocks:
        tag = "ul" if l == -1 else letters[l]
        lines.append(f"{symbol} {tag}")
        for n, terms in enumerate(powers):
            for alpha, c in terms:
                # 12 significant digits: the ccECP local-form identity
                # c(r^1) = Zeff * alpha must survive rendering to rtol 1e-10
                # even for Zeff*alpha ~ O(10) (8 fixed decimals did not)
                lines.append(f"{n} {alpha:.12g} {c:.12g}")
    return "\n".join(lines)
