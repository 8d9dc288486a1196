"""Reader for TCHINT ``tcfactors`` HDF5 grids (reference API:
``pymes/util/tcfactors.py:14``): basis size, grid size, quadrature weights,
MO values on the grid and the y-Coulomb factors.

A host-numpy copy of ``pymes_tpu/util/tcfactors.py``; h5py is optional and
imported only when an HDF5 file is read."""

import numpy as np

from pymes_tpu_torch.log import print_logging_info


def read(file_name="tcfactors.h5"):
    if file_name.endswith((".h5", ".hdf5")):
        print_logging_info("Reading tcfactors in hdf5 format...")
        return _read_h5(file_name)
    raise NameError("Reading txt format not implemented!")


def _read_h5(file_name):
    import h5py

    with h5py.File(file_name, "r") as f:
        n_orb = int(np.asarray(f["nBasis"]).reshape(-1)[0])
        n_grid = int(np.asarray(f["nGrid"]).reshape(-1)[0])
        weights = np.asarray(f["weights"])
        assert len(weights) == n_grid
        mo_vals = np.asarray(f["mo_vals"])
        ycoulomb = np.asarray(f["ycoulomb"])
    return n_orb, n_grid, weights, mo_vals, ycoulomb
