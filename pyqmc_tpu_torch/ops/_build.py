"""Build and load the hand-written CUDA kernels.

The sources in `pyqmc_tpu_torch/csrc/` are compiled at first use with nvcc
into one shared library with a plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o libpq_kernels_<hash>.so csrc/*.cu

The library lands in `build/pyqmc_tpu_torch/` beside the package and is
named by a hash of every source and header, so an edit rebuilds. The build
log, with ptxas' register and spill counts, is kept next to it. Nothing is
compiled when a module is imported.
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
# C entry points and their argument types (csrc/*.cu, extern "C")
_SIGNATURES = {
    # state_in, state_out, gauss, unif, nacc, tab, ntab, meta, nmeta, nconf,
    # nrows, nmax, tstep, drift_cutoff, stream
    "pq_vmc_sweep": [_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _D, _D, _P],
    # pos, invu, invd, rot, wvec, partial, out, tab, ntab, meta, nmeta,
    # nelec, nconf, stream
    "pq_ecp_energy": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _P],
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


_lib = None


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")) + glob.glob(os.path.join(CSRC, "*.cuh")))


def library_path():
    """The library's path, named by a hash of the sources and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libpq_kernels_{h.hexdigest()[:16]}.so")


def _nvcc():
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise KernelBuildError("nvcc not found (looked on PATH and in /usr/local/cuda/bin)")
    return nvcc


def build() -> str:
    """Compile the kernels if the library for the current sources is missing;
    returns its path."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    cu = [p for p in sources() if p.endswith(".cu")]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    with open(so[:-3] + ".log", "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise KernelBuildError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, so)
    return so


def library():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            for suffix in ("_f32", "_f64"):
                fn = getattr(lib, name + suffix)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(name: str, dtype, *args):
    """Call C entry `name` for dtype (float32/float64) on the current CUDA
    stream; raise KernelLaunchError if it reports a CUDA error."""
    suffix = {torch.float32: "_f32", torch.float64: "_f64"}[dtype]
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library(), name + suffix)(*args, stream)
    if err != 0:
        raise KernelLaunchError(f"{name}{suffix}: CUDA error {err}")
