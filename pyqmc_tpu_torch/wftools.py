"""Wavefunction factories and parameter files (counterpart of
pyqmc_tpu/wftools.py).

    wf, params, to_opt = generate_wf(mol, mf)   # Slater x two-body Jastrow, GPU
    wf, params, to_opt = generate_wf(mol, mf, jastrow3=True)   # x three-body Jastrow
    wf, params, to_opt = generate_wf(mol, mf, jastrow=[generate_gps_jastrow])

`save_wf_params` and `read_wf_params` write and read a parameter tree under
an h5py group, one dataset per leaf named by its path ("wf1/acoeff"), the
JAX package's layout; `read_superposition` builds an AddWF of such files.
h5py is imported only where a file is opened.

`to_opt` freezes the Slater part (determinant and orbital coefficients)
and the Jastrow's electron-electron cusp row, as in the JAX package: the
common workflow optimizes the Jastrow first. The layout of a product is
{"wf0": Slater's, "wf1": .., "wf2": ..} in the order of the factors.
"""

from __future__ import annotations

import numpy as np
import torch

from .models import func3d
from .models.jastrow import JastrowSpin
from .models.jastrow3 import ThreeBodyJastrow
from .models.multiply import MultiplyWF
from .models.slater import Slater
from .observables.transform import tree_paths, tree_unflatten
from .utils.dtypes import complex_dtype


def default_jastrow_basis(mol, na=4, nb=3, rcut=None):
    """(a_basis, b_basis) of the two-body Jastrow: na polypade e-ion
    functions; a cusp function and nb polypade e-e functions. rcut defaults
    to half the smallest cell height for a periodic system (so the rounding
    minimal image is exact), else 7.5 bohr."""
    if rcut is None:
        if getattr(mol, "lattice", None) is not None:
            heights = 1.0 / np.linalg.norm(np.linalg.inv(mol.lattice), axis=0)
            rcut = 0.5 * float(np.min(heights))
        else:
            rcut = 7.5
    a_basis = tuple(func3d.BasisFn("polypade", 0.2 * 3.0**k, rcut) for k in range(na))
    b_basis = (func3d.BasisFn("cutoffcusp", 24.0, rcut),) + tuple(
        func3d.BasisFn("polypade", 0.2 * 3.0**k, rcut) for k in range(nb))
    return a_basis, b_basis


def generate_slater(mol, mf, mc=None, tol: float = 1e-8):
    """The Slater part from an SCF: the single determinant of the lowest
    orbitals, or a multi-determinant expansion over the orbitals it
    occupies. mc: a (DeterminantExpansion, det_coeff) pair (such as a root
    of system/casci.run_casci or run_hci), or any CASCI/HCI/SCI-style object
    that system/ci_import.interpret_ci accepts, its determinants cut at
    |c| <= tol."""
    if mc is None:
        return Slater.from_mean_field(mf)
    if isinstance(mc, tuple) and len(mc) == 2:
        exp, coeff = mc
    else:
        from .system.ci_import import interpret_ci

        exp, coeff = interpret_ci(mc, tol)
    norb_up = int(exp.occ_up.max()) + 1 if exp.occ_up.size else 0
    norb_dn = int(exp.occ_dn.max()) + 1 if exp.occ_dn.size else 0
    ca = np.asarray(mf.mo_coeff[0])[:, :norb_up]
    cb = np.asarray(mf.mo_coeff[1])[:, :norb_dn]
    return Slater(mol, None, exp, (ca, cb), det_coeff=np.asarray(coeff))


def generate_jastrow(mol, na=4, nb=3, rcut=None):
    """Two-body Jastrow of default_jastrow_basis; returns (jastrow, to_opt)
    with the cusp row of bcoeff frozen."""
    a_basis, b_basis = default_jastrow_basis(mol, na, nb, rcut)
    jas = JastrowSpin(mol, a_basis=a_basis, b_basis=b_basis)
    bmask = np.ones((len(b_basis), 3), dtype=bool)
    bmask[0] = False
    return jas, {"acoeff": True, "bcoeff": bmask}


def generate_jastrow3(mol, na=3, nb=3, rcut=None):
    """Three-body Jastrow on default_jastrow_basis without the cusp
    function; returns (jastrow, to_opt) with every ccoeff free."""
    a_basis, b_basis = default_jastrow_basis(mol, na, nb, rcut)
    return ThreeBodyJastrow(mol, a_basis=a_basis, b_basis=b_basis[1:]), {"ccoeff": True}


def generate_gps_jastrow(mol, n_support=4, init_spread=1.0, seed=0, optimize_Xsupport=True):
    """Gaussian-process-state pair Jastrow; returns (wf, to_opt)."""
    from .models.generic_jastrow import GPSJastrow

    wf = GPSJastrow(mol, n_support=n_support, init_spread=init_spread, seed=seed)
    return wf, {"alpha": True, "f": True, "Xsupport": bool(optimize_Xsupport)}


def generate_geminal_jastrow(mol):
    """Geminal (AO-pair) Jastrow; returns (wf, to_opt)."""
    from .models.generic_jastrow import GeminalJastrow

    return GeminalJastrow(mol), {"gcoeff": True}


def generate_wf(mol, mf, jastrow=True, jastrow3=False, jastrow_kws=None, mc=None, device=None,
                dtype=None):
    """Slater x Jastrow factors; returns (wf, params, to_opt), params on the
    GPU unless `device` says otherwise (as make_params).

    jastrow: True, the two-body Jastrow of generate_jastrow (jastrow_kws its
    keywords); False, none; or a factory f(mol, **kws) -> (wf, to_opt), such
    as generate_gps_jastrow or generate_geminal_jastrow, or a list of them
    (jastrow_kws then a list of keyword dicts, one per factory).
    jastrow3=True appends the three-body Jastrow of generate_jastrow3. With
    no Jastrow the Slater is returned alone; mc as in generate_slater."""
    wfs = [generate_slater(mol, mf, mc=mc)]
    to_opts = [{"det_coeff": False, "mo_coeff_alpha": False, "mo_coeff_beta": False}]
    if callable(jastrow) or isinstance(jastrow, (list, tuple)):
        factories = list(jastrow) if isinstance(jastrow, (list, tuple)) else [jastrow]
        kws = jastrow_kws or [{}] * len(factories)
        kws = kws if isinstance(kws, (list, tuple)) else [kws]
        if len(kws) != len(factories):
            raise ValueError(f"{len(factories)} Jastrow factories but {len(kws)} keyword dicts")
        made = [fac(mol, **kw) for fac, kw in zip(factories, kws)]
    elif jastrow:
        made = [generate_jastrow(mol, **(jastrow_kws or {}))]
    else:
        made = []
    if jastrow3:
        made.append(generate_jastrow3(mol))
    wfs += [w for w, _ in made]
    to_opts += [t for _, t in made]
    if len(wfs) == 1:
        return wfs[0], wfs[0].make_params(device, dtype), to_opts[0]
    wf = MultiplyWF(*wfs)
    return wf, wf.make_params(device, dtype), {f"wf{i}": t for i, t in enumerate(to_opts)}


def read_superposition(mol, mf, wf_files, coeffs, **wf_kws):
    """The superposition sum_i c_i Psi_i of wavefunctions optimized apart,
    each generate_wf(mol, mf, **wf_kws) with the parameters of the "wf"
    group of its HDF5 file; returns (AddWF, params, to_opt), the
    coefficients frozen."""
    from .method.hdftools import open_hdf
    from .models.addwf import AddWF

    wfs, param_list, to_opt = [], [], {}
    for iwf, fname in enumerate(wf_files):
        wf_i, params_i, to_opt_i = generate_wf(mol, mf, **wf_kws)
        with open_hdf(fname, "r") as f:
            if "wf" not in f:
                raise ValueError(f"no 'wf' group in {fname}")
            params_i = read_wf_params(f["wf"], params_i)
        wfs.append(wf_i)
        param_list.append(params_i)
        to_opt[f"wf{iwf}"] = to_opt_i
    wf = AddWF(*wfs)
    ref = tree_paths(param_list[0])[0][1]
    params = {f"wf{i}": p for i, p in enumerate(param_list)}
    params["coeff"] = torch.as_tensor(np.asarray(coeffs, dtype=np.float64), device=ref.device,
                                      dtype=ref.real.dtype)
    to_opt["coeff"] = False
    return wf, params, to_opt


def _path_key(path):
    return "/".join(str(p) for p in path)


def save_wf_params(hdf_grp, params):
    """Write a parameter tree under an h5py group, one dataset per leaf at
    its path ("wf0/mo_coeff_alpha", "wf1/acoeff"), overwriting earlier
    values."""
    for path, leaf in tree_paths(params):
        key = _path_key(path)
        data = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        if key in hdf_grp:
            hdf_grp[key][...] = data
        else:
            hdf_grp.create_dataset(key, data=data)


def read_wf_params(hdf_grp, params_template, strict=True):
    """Parameters written by save_wf_params (of either package) in the
    template's tree, each leaf on the template's device in its precision
    (complex where the file's is). strict: raise where the file holds
    datasets the template has not got (a file of a wavefunction with more
    factors would otherwise lose them silently)."""
    leaves, consumed = [], set()
    for path, leaf in tree_paths(params_template):
        key = _path_key(path)
        arr = np.asarray(hdf_grp[key])
        if arr.shape != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {tuple(leaf.shape)}")
        consumed.add(key)
        dtype = complex_dtype(leaf.dtype) if np.iscomplexobj(arr) else leaf.dtype
        leaves.append(torch.as_tensor(arr).to(device=leaf.device, dtype=dtype))
    if strict:
        stored = []
        hdf_grp.visit(lambda name: stored.append(name) if hasattr(hdf_grp[name], "shape")
                      else None)
        extra = sorted(set(stored) - consumed)
        if extra:
            raise ValueError(
                f"parameter file holds groups the wavefunction does not: {extra} — rebuild the "
                "wf with the flags (jastrow3, jastrow_kws, ...) used when it was saved, or pass "
                "strict=False to drop them")
    return tree_unflatten(params_template, leaves)
