"""FCIDUMP reader and writers (host numpy).

A copy of ``pymes_tpu/util/fcidump.py``: a Fortran-namelist
header (NORB/NELEC/...) followed by integral lines ``value p r q s``
(chemists' file order), stored in physicists' order
``V[p,q,r,s] = <pq|rs>``.  Hermitian dumps restore the 4 real-orbital
symmetry images; transcorrelated dumps (``is_tc=True``) only the
particle-exchange pair ``pqrs ↔ qpsr`` (TC Hamiltonians are
non-Hermitian).  :func:`read_blocks` streams a dump into named occ/vir
blocks on a device without the dense nb⁴ tensor; :func:`write` writes the
text format byte for byte as the JAX writer does (it formats numpy
values), :func:`write_h5`/:func:`read_h5` the HDF5 form (h5py is optional
and imported only there).  The port carries its own copy because importing
the JAX package imports jax; ``tests/test_torch_ccsd_io.py`` and
``tests/test_torch_io.py`` hold the two equal.  The three readers share
one parse of the records (:func:`_records`), so each puts a TC record, and
a one-body record, last at its own place as :func:`read` does; the JAX
package's block and HDF5 readers keep the partner's value instead where a
TC dump lists ``pqrs`` and ``qpsr`` with different values (the H2 TC dump
of ``tests/data``).  The records are parsed by the port's native parser
(:mod:`pymes_tpu_torch._native`, C++ built at first use), bit for bit as
the numpy parse that stays as its fallback.
"""

import os

import numpy as np
import torch

from pymes_tpu_torch import _native
from pymes_tpu_torch.config import DTYPE, resolve_device, to_host
from pymes_tpu_torch.log import print_logging_info


def _parse_header(reader):
    line = reader.readline().strip()
    while not ("/" in line or "end" in line.lower()):
        line += reader.readline().strip()
    header = {"norb": 0, "nelec": 0, "ms2": 0}
    for attr in line.replace("&FCI", "").split(","):
        if "=" not in attr:
            continue
        key, _, val = attr.partition("=")
        key = key.strip().lower()
        val = val.strip().rstrip(",")
        if key in header and val.lstrip("-").isdigit():
            header[key] = int(val)
    return header


def _numpy_parse(body):
    rows = np.array(body.replace("D", "E").replace("d", "e").split(),
                    dtype=object).reshape(-1, 5)
    return rows[:, 0].astype(np.float64), rows[:, 1:].astype(np.int64)


def _parse_body(body):
    """(values, indices (n, 4)) of the records ``value p r q s``: the
    native parser, else the numpy parse (:func:`_native.parse`)."""
    return _native.parse(body, 4, _numpy_parse)


def _records(vals, idx, n_orb, is_tc):
    """Split the dump's records ``value p r q s`` into ``e_core`` (the last
    core record, else 0), ``epsilon_p``, ``h_pq`` and the two-body images
    ``(P, Q, R, S, v)`` of :func:`_symmetry_images` (0-based, physicists'
    order).  A one-body record lands at ``(r, p)`` and then at its own
    place ``(p, r)``; values below 1e-19 are dropped."""
    p, r, q, s = idx[:, 0], idx[:, 1], idx[:, 2], idx[:, 3]
    keep = np.abs(vals) >= 1e-19

    two_body = keep & (p != 0) & (q != 0) & (r != 0) & (s != 0)
    images = _symmetry_images(p[two_body] - 1, q[two_body] - 1,
                              r[two_body] - 1, s[two_body] - 1,
                              vals[two_body], is_tc)

    e_core = 0.0
    core = (p == 0) & (q == 0) & (r == 0) & (s == 0)
    if np.any(core):
        e_core = float(vals[core][-1])

    epsilon_p = np.zeros(n_orb)
    orb_e = (p != 0) & (q == 0) & (r == 0) & (s == 0)
    epsilon_p[p[orb_e] - 1] = vals[orb_e]

    h_pq = np.zeros([n_orb, n_orb])
    one_body = keep & (p != 0) & (r != 0) & (q == 0) & (s == 0)
    h_pq[r[one_body] - 1, p[one_body] - 1] = vals[one_body]
    h_pq[p[one_body] - 1, r[one_body] - 1] = vals[one_body]
    return e_core, epsilon_p, h_pq, images


def _symmetry_images(pi, qi, ri, si, v, is_tc):
    """All index images implied by the dump's symmetry class: the 4
    real-orbital images of a Hermitian dump, the particle-exchange pair
    ``qpsr ↔ pqrs`` of a TC dump, each record's own place last (where a
    TC dump lists both ``pqrs`` and ``qpsr`` with different values, each
    keeps its own)."""
    if is_tc:
        images = [(qi, pi, si, ri), (pi, qi, ri, si)]
    else:
        images = [(pi, qi, ri, si), (ri, qi, pi, si),
                  (ri, si, pi, qi), (pi, si, ri, qi)]
    P = np.concatenate([im[0] for im in images])
    Q = np.concatenate([im[1] for im in images])
    R = np.concatenate([im[2] for im in images])
    S = np.concatenate([im[3] for im in images])
    return P, Q, R, S, np.tile(v, len(images))


def _read_text(fcidump_file, is_tc):
    """(n_elec, n_orb, e_core, epsilon_p, h_pq, images) of a text dump."""
    if not os.path.exists(fcidump_file):
        raise FileNotFoundError(fcidump_file)
    with open(fcidump_file) as reader:
        header = _parse_header(reader)
        n_elec, n_orb = header["nelec"], header["norb"]
        body = reader.read()
    vals, idx = _parse_body(body)
    return (n_elec, n_orb) + _records(vals, idx, n_orb, is_tc)


def read(fcidump_file="FCIDUMP", is_tc=False):
    """Read integrals from an FCIDUMP file.

    Returns ``(n_elec, n_orb, e_core, epsilon_p, h_pq, V_pqrs)`` (numpy,
    f64) with ``V_pqrs`` in physicists' notation."""
    print_logging_info("Reading " + fcidump_file + "...", level=1)
    print_logging_info("Using TC integrals: ", is_tc, level=2)
    n_elec, n_orb, e_core, epsilon_p, h_pq, (P, Q, R, S, v) = _read_text(
        fcidump_file, is_tc)
    V_pqrs = np.zeros([n_orb, n_orb, n_orb, n_orb])
    V_pqrs[P, Q, R, S] = v
    return n_elec, n_orb, e_core, epsilon_p, h_pq, V_pqrs


def read_blocks(fcidump_file, no, names=("klij", "ijab", "abij", "iajb",
                                         "iabj", "abcd"),
                is_tc=False, *, device=None):
    """Stream an FCIDUMP straight into named occ/vir blocks.

    Returns ``(n_elec, n_orb, e_core, epsilon_p, h_pq, dict_of_blocks)``
    with the blocks as f64 tensors on ``device`` (None: the card; the rest
    numpy), without
    the dense nb⁴ ``V_pqrs``: peak host memory is the nonzero list plus
    one block.  Block names use the reference's convention: letters i–l
    map to the occupied range ``[0, no)``, a–d to the virtual range
    ``[no, n_orb)``, on the physicists'-order ``V[p,q,r,s]`` axes."""
    dev = resolve_device(device)
    n_elec, n_orb, e_core, epsilon_p, h_pq, (P, Q, R, S, v) = _read_text(
        fcidump_file, is_tc)

    no = int(no)
    nv = n_orb - no
    blocks = {}
    for name in names:
        occ = [c in "ijkl" for c in name]
        shape = [no if o else nv for o in occ]
        block = np.zeros(shape)
        mask = np.ones(len(v), dtype=bool)
        for ind, o in zip((P, Q, R, S), occ):
            mask &= (ind < no) if o else (ind >= no)
        sel = [ind[mask] - (0 if o else no)
               for ind, o in zip((P, Q, R, S), occ)]
        block[tuple(sel)] = v[mask]
        blocks[name] = torch.as_tensor(block, dtype=DTYPE, device=dev)
    return n_elec, n_orb, e_core, epsilon_p, h_pq, blocks


def write(integrals, h, no, e_nuc=0.0, ms2=1, orbsym=1, isym=1, dtype="r",
          file="FCIDUMP"):
    """Write integrals (physicists' ``V[p,q,r,s]``, a tensor or an array)
    and ``h`` to an FCIDUMP text file.  Values are formatted as numpy
    floats on the host, so the text equals the JAX writer's byte for
    byte."""
    integrals, h = to_host(integrals), to_host(h)
    n_p = integrals.shape[0]
    with open(file, "w") as f:
        f.write("&FCI\n")
        f.write(" NORB=%i,\n" % n_p)
        f.write(" NELEC=%i,\n" % (no * 2))
        f.write(" MS2=%i,\n" % ms2)
        f.write(" ORBSYM=" + str([orbsym] * n_p).strip("[]") + ",\n")
        f.write(" ISYM=%i,\n" % isym)
        f.write("/\n")

        pi, qi, ri, si = np.nonzero(integrals)
        v = integrals[pi, qi, ri, si]
        for n in range(len(v)):
            f.write("  " + str(v[n]) + "  " + str(pi[n] + 1) + "  "
                    + str(ri[n] + 1) + "  " + str(qi[n] + 1) + "  "
                    + str(si[n] + 1) + "\n")

        hi, hj = np.nonzero(np.abs(h) > 1e-10)
        for n in range(len(hi)):
            f.write("  " + str(h[hi[n], hj[n]]) + "  " + str(hi[n] + 1)
                    + "  " + str(hj[n] + 1) + "  0  0\n")
        f.write(str(e_nuc) + " 0  0  0  0")


def write_h5(file, integrals, h, no, e_nuc=0.0, ms2=1):
    """Binary FCIDUMP: the nonzero records of :func:`write` as HDF5
    datasets (vals float64, idx int64 in file order ``p r q s``)."""
    import h5py

    integrals, h = to_host(integrals), to_host(h)
    n_p = integrals.shape[0]
    pi, qi, ri, si = np.nonzero(integrals)
    v2 = integrals[pi, qi, ri, si]
    idx2 = np.stack([pi + 1, ri + 1, qi + 1, si + 1], axis=1)
    hi, hj = np.nonzero(np.abs(h) > 1e-10)
    v1 = h[hi, hj]
    idx1 = np.stack([hi + 1, hj + 1], axis=1)
    with h5py.File(file, "w") as f:
        f.attrs["norb"] = n_p
        f.attrs["nelec"] = no * 2
        f.attrs["ms2"] = ms2
        f.attrs["e_core"] = float(e_nuc)
        f.create_dataset("vals2", data=np.asarray(v2, dtype=np.float64))
        f.create_dataset("idx2", data=idx2.astype(np.int64))
        f.create_dataset("vals1", data=np.asarray(v1, dtype=np.float64))
        f.create_dataset("idx1", data=idx1.astype(np.int64))


def read_h5(file, is_tc=False):
    """Read an HDF5 FCIDUMP written by :func:`write_h5`; returns the same
    tuple as :func:`read`."""
    import h5py

    with h5py.File(file, "r") as f:
        n_orb = int(f.attrs["norb"])
        n_elec = int(f.attrs["nelec"])
        e_core = float(f.attrs["e_core"])
        vals2 = f["vals2"][...]
        idx2 = f["idx2"][...]
        vals1 = f["vals1"][...]
        idx1 = f["idx1"][...]
    # the one-body records are the text's ``value p r 0 0``
    vals = np.concatenate([vals2, vals1])
    idx = np.concatenate([idx2, np.pad(idx1, ((0, 0), (0, 2)))])
    _, epsilon_p, h_pq, (P, Q, R, S, v) = _records(vals, idx, n_orb, is_tc)
    V_pqrs = np.zeros([n_orb] * 4)
    V_pqrs[P, Q, R, S] = v
    return n_elec, n_orb, e_core, epsilon_p, h_pq, V_pqrs
