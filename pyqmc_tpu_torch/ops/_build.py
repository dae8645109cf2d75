"""Build and load the hand-written CUDA kernels.

Each source in `pyqmc_tpu_torch/csrc/*.cu` is compiled at first use with
nvcc into a shared library of its own with a plain C interface, loaded with
ctypes; the compilers of all missing libraries run side by side:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o lib<source>_<hash>.so csrc/<source>.cu

The libraries land in `build/pyqmc_tpu_torch/` beside the package and are
named by a hash of the source and every header, so an edit rebuilds. Each
build log, with ptxas' register and spill counts, is kept next to its
library. Nothing is compiled when a module is imported.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "pyqmc_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
# C entry points (csrc/*.cu, extern "C"): their source and argument types
_KERNELS = {
    # state_in, state_out, gauss, unif, sums, tab, ntab, meta, nmeta, plan,
    # nplan, nconf, nrows, nelec, nao, nprim, nmax, tstep, drift_cutoff,
    # stream
    "pq_vmc_sweep": ("vmc_sweep.cu", [_P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I,
                                      _I, _I, _D, _D, _P]),
    # as pq_vmc_sweep without drift_cutoff
    "pq_dmc_sweep": ("dmc_sweep.cu", [_P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I,
                                      _I, _I, _D, _P]),
    # pos, invu, invd, rot, wvec, partial, out, tab, ntab, meta, nmeta,
    # nelec, nconf, stream
    "pq_ecp_energy": ("ecp_energy.cu", [_P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _P]),
    # state_in, state_out, rot, u_sel, u_acc, tab, ntab, meta, nmeta, plan,
    # nplan, nconf, nrows, nelec, nao, nprim, nq, nmax, tau, stream
    "pq_tmove_sweep": ("tmove_sweep.cu", [_P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _I, _I, _I, _I,
                                          _I, _I, _I, _I, _D, _P]),
    # X, C, out, tab, ntab, meta, nmeta, M, norb, nao, stream
    "pq_value_mo": ("value_mo.cu", [_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _P]),
    # X, ao, grad, lap, tab, ntab, meta, nmeta, M, stream
    "pq_gto_eval": ("gto_eval.cu", [_P, _P, _P, _P, _P, _I, _P, _I, _I, _P]),
    # state_in, state_out, gauss, unif, wrapd, nacc, R, tab, ntab, meta, nmeta,
    # nconf, nrows, nao, ntot, nelec, tstep, drift_cutoff, stream
    "pq_pbc_sweep": ("pbc_sweep.cu", [_P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I,
                                      _I, _D, _D, _P]),
    # as pq_pbc_sweep without drift_cutoff; sums holds nacc, r2p, r2a
    "pq_pbc_dmc_sweep": ("pbc_sweep.cu", [_P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I,
                                          _I, _I, _D, _P]),
}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


class LaunchCount:
    """Number of times a wrapper launched its kernel."""

    def __init__(self):
        self.n = 0

    def add(self):
        self.n += 1

    def reset(self):
        self.n = 0


_libs = None


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")) + glob.glob(os.path.join(CSRC, "*.cuh")))


def library_path(cu):
    """The library of source file `cu` (a name in csrc/), named by a hash of
    the flags, the source and every header."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC, cu)] + [p for p in sources() if p.endswith(".cuh")]:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{cu[:-3]}_{h.hexdigest()[:16]}.so")


def _nvcc():
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise KernelBuildError("nvcc not found (looked on PATH and in /usr/local/cuda/bin)")
    return nvcc


def build() -> dict:
    """Compile every kernel whose library for the current sources is
    missing, all compilers started together; returns {source: library path}."""
    paths = {cu: library_path(cu) for cu, _ in _KERNELS.values()}
    missing = [cu for cu, so in paths.items() if not os.path.exists(so)]
    if not missing:
        return paths
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    running = []
    for cu in missing:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, cu)]
        running.append((cu, tmp, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                       stderr=subprocess.PIPE, text=True)))
    failed = []
    for cu, tmp, cmd, proc in running:
        out, err = proc.communicate()
        with open(paths[cu][:-3] + ".log", "w") as f:
            f.write(" ".join(cmd) + "\n" + out + err)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{cu}: nvcc failed ({proc.returncode}):\n{err[-4000:]}")
        else:
            os.replace(tmp, paths[cu])
    if failed:
        raise KernelBuildError("\n".join(failed))
    return paths


def library():
    """{C entry name: its loaded library} (built on first call)."""
    global _libs
    if _libs is None:
        paths = build()
        loaded = {cu: ctypes.CDLL(so) for cu, so in paths.items()}
        libs = {}
        for name, (cu, argtypes) in _KERNELS.items():
            for suffix in ("_f32", "_f64"):
                fn = getattr(loaded[cu], name + suffix)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            libs[name] = loaded[cu]
        _libs = libs
    return _libs


def launch(name: str, dtype, *args):
    """Call C entry `name` for dtype (float32/float64) on the current CUDA
    stream; raise KernelLaunchError if it reports a CUDA error."""
    suffix = {torch.float32: "_f32", torch.float64: "_f64"}[dtype]
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library()[name], name + suffix)(*args, stream)
    if err != 0:
        raise KernelLaunchError(f"{name}{suffix}: CUDA error {err}")
