"""CC4S text-tensor interchange (reference API:
``pymes/util/cc4s_interface.py:4``).

A host-numpy copy of ``pymes_tpu/util/cc4s_interface.py``; a tensor
argument is taken to the host first.  ``tests/test_torch_io.py`` holds the
written files equal to the original's."""

from string import ascii_lowercase

import numpy as np

from pymes_tpu_torch.config import to_host


def write_2_cc4s_tensor(tensor, dim, fileName, dtype="r"):
    """Dump a dense tensor in the CC4S text format: a header line with the
    name and dimensions, an index-letter line, then the flattened data."""
    tensor = to_host(tensor)
    with open(fileName + ".dat", "w") as f:
        f.write(fileName + " " + "".join(" " + str(i) for i in dim) + "\n")
        f.write(ascii_lowercase[8:8 + dim[0]] + " \n")
    with open(fileName + ".dat", "a") as f:
        flat = tensor.flatten("C")
        if dtype == "c":
            np.savetxt(f, flat, fmt="(%.18e,%.18e)")
        else:
            np.savetxt(f, flat, fmt="%.18e")


def read_cc4s_tensor(fileName):
    """Inverse of :func:`write_2_cc4s_tensor` for real tensors; returns
    (name, dims, flat_data)."""
    with open(fileName) as f:
        header = f.readline().split()
        name = header[0]
        dims = [int(x) for x in header[1:]]
        f.readline()  # index letters
        data = np.loadtxt(f)
    return name, dims, data


def dump_ftod(ftod, fileName="FTODDUMP"):
    """Dump the Fourier-transformed overlap (pair) density Γ^p_q(G)
    (nb × nb × nG) in CC4S text format (completes the reference stub at
    ``cc4s_interface.py:31``)."""
    ftod = to_host(ftod)
    write_2_cc4s_tensor(ftod, list(ftod.shape), fileName)
