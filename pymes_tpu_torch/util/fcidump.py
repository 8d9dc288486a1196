"""FCIDUMP reader (host numpy).

A copy of ``read`` from ``pymes_tpu/util/fcidump.py``: a Fortran-namelist
header (NORB/NELEC/...) followed by integral lines ``value p r q s``
(chemists' file order), stored in physicists' order
``V[p,q,r,s] = <pq|rs>``.  Hermitian dumps restore the 4 real-orbital
symmetry images; transcorrelated dumps (``is_tc=True``) only the
particle-exchange pair ``pqrs ↔ qpsr`` (TC Hamiltonians are
non-Hermitian).  The port carries its own copy because importing the JAX
package imports jax; ``tests/test_torch_ccsd_io.py`` holds the two equal.
The optional native parser of the JAX package is not carried: the numpy
parse gives the same values.
"""

import os

import numpy as np

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


def read(fcidump_file="FCIDUMP", is_tc=False):
    """Read integrals from an FCIDUMP file.

    Returns ``(n_elec, n_orb, e_core, epsilon_p, h_pq, V_pqrs)`` (numpy,
    f64) with ``V_pqrs`` in physicists' notation."""
    if not os.path.exists(fcidump_file):
        raise FileNotFoundError(fcidump_file)

    print_logging_info("Reading " + fcidump_file + "...", level=1)
    print_logging_info("Using TC integrals: ", is_tc, level=2)

    with open(fcidump_file) as reader:
        header = _parse_header(reader)
        n_elec, n_orb = header["nelec"], header["norb"]
        body = reader.read()

    rows = np.array(body.replace("D", "E").replace("d", "e").split(),
                    dtype=object).reshape(-1, 5)
    vals = rows[:, 0].astype(np.float64)
    idx = rows[:, 1:].astype(np.int64)

    e_core = 0.0
    epsilon_p = np.zeros(n_orb)
    h_pq = np.zeros([n_orb, n_orb])
    V_pqrs = np.zeros([n_orb, n_orb, n_orb, n_orb])

    p, r, q, s = idx[:, 0], idx[:, 1], idx[:, 2], idx[:, 3]
    keep = np.abs(vals) >= 1e-19

    two_body = keep & (p != 0) & (q != 0) & (r != 0) & (s != 0)
    pi, qi, ri, si = (p[two_body] - 1, q[two_body] - 1, r[two_body] - 1,
                      s[two_body] - 1)
    v = vals[two_body]
    if not is_tc:
        V_pqrs[pi, qi, ri, si] = v
        V_pqrs[ri, qi, pi, si] = v
        V_pqrs[ri, si, pi, qi] = v
        V_pqrs[pi, si, ri, qi] = v
    else:
        V_pqrs[qi, pi, si, ri] = v
        V_pqrs[pi, qi, ri, si] = v

    core = (p == 0) & (q == 0) & (r == 0) & (s == 0)
    if np.any(core):
        e_core = float(vals[core][-1])

    orb_e = (p != 0) & (q == 0) & (r == 0) & (s == 0)
    epsilon_p[p[orb_e] - 1] = vals[orb_e]

    one_body = keep & (p != 0) & (r != 0) & (q == 0) & (s == 0)
    h_pq[r[one_body] - 1, p[one_body] - 1] = vals[one_body]
    h_pq[p[one_body] - 1, r[one_body] - 1] = vals[one_body]

    return n_elec, n_orb, e_core, epsilon_p, h_pq, V_pqrs
