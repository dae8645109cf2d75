"""HDF5 block output (a numpy-only copy of pyqmc_tpu/method/hdftools.py).

Growable datasets, one per key, with one row appended per block or
iteration. `f` is an open h5py File or Group: the callers import h5py only
when a file is asked for, so the port runs where h5py is absent.
"""

import numpy as np


def setup_hdf(f, data, attr=None):
    for k, v in data.items():
        v = np.asarray(v)
        f.create_dataset(k, (0,) + v.shape, maxshape=(None,) + v.shape, dtype=v.dtype)
    for k, v in (attr or {}).items():
        f.attrs[k] = v


def append_hdf(f, data):
    for k, v in data.items():
        v = np.asarray(v)
        if k not in f:
            f.create_dataset(k, (0,) + v.shape, maxshape=(None,) + v.shape, dtype=v.dtype)
        ds = f[k]
        n = ds.shape[0]
        ds.resize((n + 1,) + v.shape)
        ds[n] = v


def open_hdf(path, mode):
    """h5py.File(path, mode); an ImportError naming h5py where it is not
    installed."""
    try:
        import h5py
    except ImportError as err:
        raise ImportError(f"reading or writing the HDF5 file {path} needs h5py, which is not "
                          "installed") from err
    return h5py.File(path, mode)
