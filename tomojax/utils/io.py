"""Dataset IO — the reference drivers' dataset layout, as ``.npz`` or HDF5.

The reference's alignment driver reads an HDF5 file with datasets
``data/projections``, ``data/alpha``, ``data/beta``, ``data/xyz``,
``data/phi``, ``data/phantom`` (``examples/align_rigid.py:10-17``); its MPI
driver saves the final volume with ``np.save`` (``mpi_reconstruct.py:70-71``).

The same ``data/*`` layout is written and read two ways, chosen by the
file suffix:

- ``.npz`` (default for any other suffix): keys ``data/projections`` ...,
  numpy only;
- ``.h5``/``.hdf5``: the reference's HDF5 file, interchangeable with its
  drivers; needs ``h5py``, and says so where it is not installed.
"""

from __future__ import annotations

import os

import numpy as np

from tomojax.core.geometry import Views

_H5_SUFFIXES = (".h5", ".hdf5")


def _is_h5(path) -> bool:
    return os.fspath(path).lower().endswith(_H5_SUFFIXES)


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise RuntimeError(
            "reading or writing an .h5 dataset needs h5py, which is not "
            "installed; use a .npz path (same data/* layout)") from e
    return h5py


def save_dataset(path, *, projections, phi, alpha, beta, xyz, phantom=None,
                 extra=None):
    """Write the reference layout (``align_rigid.py:10-17``) to ``path``:
    HDF5 for ``.h5``/``.hdf5``, otherwise ``.npz``."""
    fields = {"projections": projections, "phi": phi, "alpha": alpha,
              "beta": beta, "xyz": xyz}
    if phantom is not None:
        fields["phantom"] = phantom
    fields.update(extra or {})
    if _is_h5(path):
        with _h5py().File(path, "w") as f:
            g = f.create_group("data")
            for k, v in fields.items():
                g.create_dataset(k, data=np.asarray(v))
        return
    with open(path, "wb") as f:   # np.savez would append .npz to the name
        np.savez(f, **{f"data/{k}": np.asarray(v)
                       for k, v in fields.items()})


def load_dataset(path):
    """Read the reference layout → dict of numpy arrays."""
    if _is_h5(path):
        with _h5py().File(path, "r") as f:
            g = f["data"]
            return {k: g[k][()] for k in g.keys()}
    with np.load(path) as z:
        return {k.partition("/")[2]: z[k] for k in z.files
                if k.startswith("data/")}


def views_from_dataset(d) -> Views:
    """Build a Views pytree from a loaded dataset dict."""
    n = len(d["phi"])
    return Views.create(n, phi=d["phi"], alpha=d["alpha"], beta=d["beta"],
                        t=d["xyz"])


def save_views(path, views: Views):
    """Per-view parameters (``phi, alpha, beta, t, cor``) to ``.npz``."""
    with open(path, "wb") as f:
        np.savez(f, **{k: np.asarray(getattr(views, k))
                       for k in ("phi", "alpha", "beta", "t", "cor")})


def load_views(path) -> Views:
    with np.load(path) as z:
        return Views.create(len(z["phi"]), phi=z["phi"], alpha=z["alpha"],
                            beta=z["beta"], t=z["t"], cor=z["cor"])


def save_volume(path, volume):
    """np.save of the volume (reference ``mpi_reconstruct.py:70-71``)."""
    np.save(path, np.asarray(volume))


def load_volume(path):
    return np.load(path)
