"""GTO basis sets (a copy of pyqmc_tpu/system/basis.py, numpy only).

Carried into the port because importing anything under `pyqmc_tpu` imports
jax; contraction normalisation goes through the port's ops/harmonics.py.
`Shell` lives here alone: system/io.py's explicit bases and the library's
bases are the same type.

Self-contained replacement for the slice of PySCF the reference leans on for
basis handling (the reference calls mol.eval_gto / carries mol._basis;
cf. pyqmc/wf/orbitals.py:46-51). Since this framework is standalone, we:

  * represent a basis as {element: [Shell(l, exps, coeffs), ...]} with
    pyscf-compatible normalization (see ops/harmonics.normalize_contraction),
  * ship a small library of built-in sets (STO-3G, 6-31G, cc-pVDZ H,
    ccECP-ccpVDZ Li/C) adequate for tests and benchmarks,
  * provide an even-tempered-basis generator (the reference's own JAX examples
    use ETB bases for accelerator friendliness, examples/jax/01_slater.py),
  * parse pyscf-format nested lists so pyscf-derived data interoperates.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from ..ops.harmonics import normalize_contraction


@dataclasses.dataclass(frozen=True)
class Shell:
    l: int
    exps: tuple  # primitive exponents
    coeffs: tuple  # normalized contraction coefficients (radial norm included)

    @property
    def nprim(self):
        return len(self.exps)

    @property
    def nsph(self):
        return 2 * self.l + 1


def make_shell(l: int, exps: Sequence[float], raw_coeffs: Sequence[float]) -> Shell:
    c = normalize_contraction(l, np.asarray(exps), np.asarray(raw_coeffs))
    return Shell(l=l, exps=tuple(float(e) for e in exps), coeffs=tuple(float(x) for x in c))


def parse_pyscf_basis(data) -> List[Shell]:
    """Parse one element's basis in pyscf nested-list format.

    Format: [[l, [e1, c1, c1b, ...], [e2, c2, c2b, ...], ...], ...]; general
    contractions (multiple coefficient columns) are expanded to segmented
    shells.
    """
    shells = []
    for entry in data:
        l = int(entry[0])
        prims = np.asarray(entry[1:], dtype=np.float64)
        exps = prims[:, 0]
        for col in range(1, prims.shape[1]):
            coeffs = prims[:, col]
            keep = coeffs != 0.0
            if not np.any(keep):
                continue
            shells.append(make_shell(l, exps[keep], coeffs[keep]))
    return shells


_SHELL_LETTERS = {"S": 0, "P": 1, "D": 2, "F": 3, "G": 4, "H": 5, "I": 6}


def parse_nwchem_basis(text: str) -> Dict[str, list]:
    """Parse NWChem/BSE-format basis text into pyscf-format nested lists.

    Accepts the standard exchange format so published tables can be pasted
    verbatim (transcription-checked against the source) instead of re-keyed
    into nested Python lists:

        BASIS "ao basis" SPHERICAL
        H S
          23.843185  0.00411490
          ...
        H P
          0.627000   1.00000000
        END

    Multi-column contractions (general contractions) are kept as extra
    coefficient columns; `parse_pyscf_basis` expands them to segmented
    shells. `SP` blocks split into an S and a P shell sharing exponents.
    Lines starting with `#` and the BASIS/END sentinels are ignored.
    """
    out: Dict[str, list] = {}
    cur = None  # list of [l, [e, c...], ...] rows being filled
    for rawline in text.splitlines():
        line = rawline.split("#", 1)[0].strip()
        if not line:
            continue
        up = line.upper()
        if up.startswith("BASIS") or up == "END":
            cur = None
            continue
        parts = line.split()
        if parts[0][0].isalpha():
            if len(parts) != 2:
                raise ValueError(f"bad basis header line: {rawline!r}")
            el, shell = parts[0], parts[1].upper()
            if shell == "SP":
                ls = [0, 1]
            elif shell in _SHELL_LETTERS:
                ls = [_SHELL_LETTERS[shell]]
            else:
                raise ValueError(f"unknown shell {shell!r} in {rawline!r}")
            out.setdefault(el, [])
            cur = []
            for l in ls:
                row = [l]
                out[el].append(row)
                cur.append(row)
        else:
            if cur is None:
                raise ValueError(f"primitive line outside a shell: {rawline!r}")
            nums = [float(x.replace("D", "E").replace("d", "e")) for x in parts]
            exp, coeffs = nums[0], nums[1:]
            if len(cur) > 1:  # SP block: one coefficient column per channel
                if len(coeffs) != len(cur):
                    raise ValueError(f"SP line needs {len(cur)} coeffs: {rawline!r}")
                for row, c in zip(cur, coeffs):
                    row.append([exp, c])
            else:
                cur[0].append([exp] + coeffs)
    return out


def parse_nwchem_ecp(text: str) -> Dict[str, list]:
    """Parse NWChem-format ECP text into the pyscf _ecp structure.

    Format (one `nelec` line then channel blocks; `ul` is the local channel):

        O nelec 2
        O ul
        1 12.30997  6.00000
        3 14.76962 73.85984
        2 13.71419 -47.87600
        O S
        2 13.65512 85.86406

    Each numeric line is `n exponent coefficient` for a radial term
    coeff * r^(n-2) * exp(-exponent * r^2). Returns
    {el: [ncore, [[l, [slots r^0..r^6 of [exp, coeff] lists]], ...]]}
    with l = -1 for the local (`ul`) channel, matching pyscf's mol._ecp
    (as pyscf builds it).
    """
    out: Dict[str, list] = {}
    channels: Dict[str, dict] = {}
    cur = None
    for rawline in text.splitlines():
        line = rawline.split("#", 1)[0].strip()
        if not line:
            continue
        up = line.upper()
        if up.startswith("ECP") or up == "END":
            cur = None
            continue
        parts = line.split()
        if parts[0][0].isalpha():
            el = parts[0]
            if len(parts) == 3 and parts[1].lower() == "nelec":
                out[el] = [int(parts[2]), []]
                channels[el] = {}
                continue
            if len(parts) != 2:
                raise ValueError(f"bad ECP header line: {rawline!r}")
            tag = parts[1]
            l = -1 if tag.lower() == "ul" else _SHELL_LETTERS[tag.upper()]
            slots = [[] for _ in range(7)]
            channels[el][l] = slots
            out[el][1].append([l, slots])
            cur = slots
        else:
            if cur is None:
                raise ValueError(f"ECP term outside a channel: {rawline!r}")
            n = int(parts[0])
            exp = float(parts[1].replace("D", "E"))
            coef = float(parts[2].replace("D", "E"))
            cur[n].append([exp, coef])
    return out


def even_tempered_basis(
    lmax: int, alpha0=0.1, beta=2.5, n_per_l=(8, 6, 3, 1)
) -> List[Shell]:
    """Uncontracted even-tempered basis: exps = alpha0 * beta^k per channel."""
    shells = []
    for l in range(lmax + 1):
        n = n_per_l[l] if l < len(n_per_l) else 1
        for k in range(n):
            shells.append(make_shell(l, [alpha0 * beta**k], [1.0]))
    return shells


# --------------------------------------------------------------------------
# Built-in basis library (raw pyscf-format data; public basis-set constants).
# --------------------------------------------------------------------------

def _sto3g(core_exps, valence_exps=None):
    s_coef = [0.15432897, 0.53532814, 0.44463454]
    sp_scoef = [-0.09996723, 0.39951283, 0.70011547]
    sp_pcoef = [0.15591627, 0.60768372, 0.39195739]
    shells = [[0] + [[e, c] for e, c in zip(core_exps, s_coef)]]
    if valence_exps is not None:
        shells.append([0] + [[e, c] for e, c in zip(valence_exps, sp_scoef)])
        shells.append([1] + [[e, c] for e, c in zip(valence_exps, sp_pcoef)])
    return shells


_BUILTIN = {
    "sto-3g": {
        "H": _sto3g([3.42525091, 0.62391373, 0.1688554]),
        "He": _sto3g([6.36242139, 1.15892300, 0.31364979]),
        "Li": _sto3g(
            [16.119575, 2.9362007, 0.7946505], [0.6362897, 0.1478601, 0.0480887]
        ),
        "C": _sto3g(
            [71.616837, 13.045096, 3.5305122], [2.9412494, 0.6834831, 0.2222899]
        ),
        "N": _sto3g(
            [99.106169, 18.052312, 4.8856602], [3.7804559, 0.8784966, 0.2857144]
        ),
        "O": _sto3g(
            [130.70932, 23.808861, 6.4436083], [5.0331513, 1.1695961, 0.38038896]
        ),
    },
    "6-31g": {
        "H": [
            [0, [18.731137, 0.03349460], [2.8253937, 0.23472695], [0.6401217, 0.81375733]],
            [0, [0.1612778, 1.0]],
        ],
        "O": [
            [
                0,
                [5484.6717, 0.0018311],
                [825.23495, 0.0139501],
                [188.04696, 0.0684451],
                [52.964500, 0.2327143],
                [16.897570, 0.4701930],
                [5.7996353, 0.3585209],
            ],
            [
                0,
                [15.539616, -0.1107775],
                [3.5999336, -0.1480263],
                [1.0137618, 1.1307670],
            ],
            [
                1,
                [15.539616, 0.0708743],
                [3.5999336, 0.3397528],
                [1.0137618, 0.7271586],
            ],
            [0, [0.2700058, 1.0]],
            [1, [0.2700058, 1.0]],
        ],
    },
    "ccpvdz": {
        "H": [
            [0, [13.01, 0.019685], [1.962, 0.137977], [0.4446, 0.478148]],
            [0, [0.122, 1.0]],
            [1, [0.727, 1.0]],
        ],
    },
    # ccECP valence-only cc-pVDZ (published ccECP constants; identical to the
    # reference test fixtures' mol._basis).
    "ccecpccpvdz": {
        "Li": [
            [
                0,
                [16.001258, 4.34e-05],
                [7.583113, -0.0007531],
                [3.593693, -0.0002519],
                [1.703077, 0.0169674],
                [0.807101, -0.0909921],
                [0.382491, -0.0893155],
                [0.181265, 0.0294155],
            ],
            [0, [0.103721, 1.0]],
            # diffuse valence tail: the pyscf PBC fixtures drop primitives
            # below exp_to_discard and the molecular set needs it (without
            # it the Li pseudo-atom UHF is 0.039 Ha above the exact radial
            # solve; with it: -0.19670 vs exact -0.19685). Exponent chosen
            # variationally for the atom.
            [0, [0.036, 1.0]],
            [
                1,
                [7.004881, -0.0005306],
                [3.451199, 0.0012949],
                [1.700353, 0.0070115],
                [0.837738, 0.0171604],
                [0.412741, 0.036724],
                [0.203351, 0.0965042],
                [0.100188, 0.2211013],
            ],
            [2, [0.11072, 1.0]],
        ],
        "C": [
            [
                0,
                [13.073594, 0.0051583],
                [6.541187, 0.0603424],
                [4.573411, -0.1978471],
                [1.637494, -0.081034],
                [0.819297, 0.2321726],
                [0.409924, 0.2914643],
            ],
            [
                1,
                [9.934169, 0.0209076],
                [3.886955, 0.0572698],
                [1.871016, 0.1122682],
                [0.935757, 0.2130082],
                [0.468003, 0.2835815],
            ],
            [2, [0.56116, 1.0]],
            # published ccECP cc-pVDZ diffuse tails (removed from the PBC
            # fixture by exp_to_discard=0.3; without them the C pseudo-atom
            # UHF sits 1.6 Ha too high; with them: -5.2978 vs published
            # ~ -5.31)
            [0, [0.187387, 1.0]],
            [1, [0.126772, 1.0]],
        ],
        # N: published digits unavailable offline — contractions fitted from
        # scratch with system.basis_fit against the (published-digit) ccECP
        # N pseudopotential, same recipe as the O entry below: the
        # pseudo-atom's own UHF radials in an even-tempered sea, split
        # valence, d polarization 0.85 (interpolating C 0.56116 / O 1.2).
        # Quality: N-atom UHF -9.91024 vs -9.91490 uncontracted sea
        # (4.7 mHa contraction error). Regenerate: tools/fit scripts /
        # basis_fit.fit_atomic_valence_basis("N", ecp="ccecp",
        # occ_l=(0, 1), free_exps={2: [0.85]}).
        "N": [
            [
                0,
                [0.045, 0.0015232], [0.09, 0.0161267], [0.18, 0.2076286],
                [0.36, 0.414364], [0.72, 0.3941699], [1.44, 0.1207583],
                [2.88, -0.0426754], [5.76, -0.165426], [11.52, -0.0068691],
                [23.04, 0.0192015], [46.08, -0.0070153], [92.16, 0.0028039],
                [184.32, -0.0011719], [368.64, 0.0004631],
                [737.28, -0.000151],
            ],
            [0, [0.18, 1.0]],
            [
                1,
                [0.045, 0.0023371], [0.09, 0.0438384], [0.18, 0.1579924],
                [0.36, 0.2508084], [0.72, 0.2552181], [1.44, 0.1917067],
                [2.88, 0.1114367], [5.76, 0.0543583], [11.52, 0.0157192],
                [23.04, 0.0007916],
            ],
            [1, [0.18, 1.0]],
            [2, [0.85, 1.0]],
        ],
    },
}

# ccECP cc-pVDZ-quality orbital bases for H and O, NWChem exchange format.
# Provenance:
#   H — transcribed from the published ccECP cc-pVDZ table (the 8-primitive
#       cuspless s contraction is distinctive). Pseudo-atom UHF with it:
#       -0.4999996 vs the exact radial 1s level -0.50045 (0.5 mHa basis
#       error) — consistent with a published DZ.
#   O — published digits are unavailable offline, so the contractions are
#       fitted from scratch with system.basis_fit (ANO-style: the
#       pseudo-atom's own UHF radial functions in a 9-exponent even-tempered
#       sea; single-function exponents chosen variationally on H2O).
#       Quality: O-atom UHF -15.69234 vs -15.69193 for the uncontracted
#       sea and -15.69255 for a 16-exponent sea (sub-mHa from the HF
#       limit); H2O RHF -16.92653. Tested in tests/unit/test_scf.py.
_NWCHEM_CCECP_CCPVDZ = """
BASIS
H S
  23.843185  0.00411490
  10.212443  0.01046440
   4.374164  0.02801110
   1.873529  0.07588620
   0.802465  0.18210620
   0.343709  0.34852140
   0.147217  0.37823130
   0.063055  0.11642410
H S
   0.091791  1.00000000
H P
   0.627000  1.00000000
O S
     0.090000  0.0049174
     0.225000  0.2573033
     0.562500  0.5656959
     1.406250  0.3431052
     3.515625 -0.0925311
     8.789062 -0.1380685
    21.972656  0.0262431
    54.931641 -0.0038407
   137.329102  0.0006332
O S
     0.260000  1.0000000
O P
     0.090000 -0.0289337
     0.225000 -0.1942421
     0.562500 -0.3248258
     1.406250 -0.2800483
     3.515625 -0.1434182
     8.789062 -0.0516922
    21.972656 -0.0114610
    54.931641  0.0002880
   137.329102 -0.0000796
O P
     0.210000  1.0000000
O D
     1.200000  1.0000000
END
"""

for _el, _data in parse_nwchem_basis(_NWCHEM_CCECP_CCPVDZ).items():
    _BUILTIN["ccecpccpvdz"][_el] = _data
del _el, _data

# ccECP pseudopotentials, stored in the standard NWChem exchange format so
# published tables can be transcription-checked line by line.
#
# Provenance per element:
#   Li, C — digit-exact: verified against the reference test fixtures'
#           mol._ecp JSON (li_cubic_ccecp.hdf5 / diamond_primitive.hdf5,
#           written by pyscf from its ccECP tables).
#   H, O  — published ccECP values. Cross-checks: the ccECP local-channel
#           form constraint holds (n=1 coefficient = Zeff; n=3 coefficient
#           = Zeff * alpha1, e.g. 73.85984 = 6 * 12.30997 for O), and an
#           exact radial solve of the H local channel gives E(1s) =
#           -0.5004 Ha (the published design target; the previously shipped
#           entry with the n=2/n=3 exponents crossed gave -0.5067).
#   N     — published ccECP values at lower transcription confidence
#           (form constraint 46.17505034 = 5 * 9.23501007 holds); the
#           pseudo-atom level is sanity-checked in tests.
_NWCHEM_CCECP = """
ECP
H nelec 0
H ul
1 21.24359508259891  1.00000000000000
3 21.24359508259891 21.24359508259891
2 21.77696655044365 -10.85192405303825
Li nelec 2
Li ul
1 15.00000000000000  1.00000000000000
3 15.04799714221270 15.00000000000000
2  1.80605426846072 -1.24272969818004
Li S
2  1.33024777689591  6.75286789026804
C nelec 2
C ul
1 14.43502  4.00000
3  8.39889 57.74008
2  7.38188 -25.81955
C S
2  7.76079 52.13345
N nelec 2
N ul
1  9.23501007  5.00000000
3  8.60092947 46.17505034
2  7.66830008 -30.18893534
N S
2 11.11997980 77.74203565
O nelec 2
O ul
1 12.30997  6.00000
3 14.76962 73.85984
2 13.71419 -47.87600
O S
2 13.65512 85.86406
END
"""

ECP_LIBRARY = {"ccecp": parse_nwchem_ecp(_NWCHEM_CCECP)}

# Generated "tpu1" library: ccECP-form pseudopotentials + DZ bases fitted
# from scratch against this package's own all-electron UHF atoms
# (system/ecp_generate.py / system/basis_fit.py; regenerate via
# tools/generate_ecp_library.py + tools/assemble_tpu1.py). Gives every
# fitted element an offline ECP where published digits are unavailable.
try:
    from .tpu1_library import TPU1_BASIS, TPU1_ECP_NWCHEM

    ECP_LIBRARY["tpu1"] = parse_nwchem_ecp(TPU1_ECP_NWCHEM)
    _BUILTIN["tpu1dz"] = dict(TPU1_BASIS)
except ImportError:  # library not generated yet
    pass


def get_ecp(name, elements):
    """ECP lookup: name is a library key or a dict {el: pyscf-format ecp}."""
    if isinstance(name, dict):
        lib_mixed = {}
        for el, v in name.items():
            if isinstance(v, str):
                lib_mixed[el] = ECP_LIBRARY[v.lower()][el]
            else:
                lib_mixed[el] = v
        return lib_mixed
    lib = ECP_LIBRARY[name.lower()]
    return {el: lib[el] for el in elements if el in lib}


def get_basis(name, elements) -> Dict[str, List[Shell]]:
    """Look up a built-in basis for the given elements.

    `name` may also be a dict {element: pyscf-format list} or
    {element: list[Shell]} for custom bases.
    """
    if isinstance(name, dict):
        out = {}
        for el, data in name.items():
            if data and isinstance(data[0], Shell):
                out[el] = list(data)
            else:
                out[el] = parse_pyscf_basis(data)
        return out
    key = name.lower().replace("_", "-").replace(" ", "")
    key = {"sto3g": "sto-3g", "631g": "6-31g", "ccpvdz": "ccpvdz",
           "ccecpccpvdz": "ccecpccpvdz",
           "tpu1dz": "tpu1dz"}.get(key.replace("-", ""), key)
    if key not in _BUILTIN:
        raise KeyError(f"unknown built-in basis {name!r}; pass explicit data")
    table = _BUILTIN[key]
    out = {}
    for el in elements:
        if el not in table:
            raise KeyError(f"basis {name!r} has no data for element {el}")
        out[el] = parse_pyscf_basis(table[el])
    return out
