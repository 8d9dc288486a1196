"""Irreducible k-point (twist) sampling for twist-averaged UEG runs.

A host-numpy copy of ``pymes_tpu/util/kpoints.py``: a uniform
Monkhorst-Pack mesh reduced to its irreducible wedge with multiplicity
weights.  The cubic case (identity lattice, one atom: the only one the
reference uses) runs natively: the 48 O_h operations are the signed
permutation matrices, and orbits come from applying all of them modulo the
mesh.  General lattices need spglib, which is imported only when
``gen_ir_ks`` runs (never at import) and, as in the JAX package, takes
over every case when it is importable.  ``tests/test_torch_kpoints_sf.py``
holds the copy equal to the original.
"""

import itertools

import numpy as np

from pymes_tpu_torch.log import print_logging_info


def _spglib():
    try:
        import spglib
    except ImportError:
        return None
    return spglib


def _signed_permutations():
    """The 48 O_h operations as integer matrices."""
    ops = []
    for perm in itertools.permutations(range(3)):
        for signs in itertools.product([1, -1], repeat=3):
            m = np.zeros((3, 3), dtype=int)
            for row, (col, s) in enumerate(zip(perm, signs)):
                m[row, col] = s
            ops.append(m)
    return ops


def _cubic_ir_mesh(mesh):
    """Irreducible wedge of an unshifted mesh under O_h, orbit-by-orbit."""
    mesh = np.asarray(mesh, dtype=int)
    nx, ny, nz = mesh
    if not (nx == ny == nz):
        raise ValueError("native cubic reduction needs an isotropic mesh")
    ops = _signed_permutations()

    # grid in spglib order (x fastest), reduced coords in (-n/2, n/2]
    idx = np.arange(nx * ny * nz)
    gx = idx % nx
    gy = (idx // nx) % ny
    gz = idx // (nx * ny)
    grid = np.stack([gx, gy, gz], axis=1)
    reduced = np.where(grid > mesh // 2, grid - mesh, grid)

    mapping = -np.ones(len(idx), dtype=int)
    for i in range(len(idx)):
        if mapping[i] >= 0:
            continue
        orbit = set()
        for op in ops:
            img = (op @ reduced[i]) % mesh
            orbit.add(int(img[0] + nx * (img[1] + ny * img[2])))
        rep = min(orbit)
        for j in orbit:
            mapping[j] = rep
    return mapping, reduced


def gen_ir_ks(mesh=None, lattice=None, positions=None, number=None):
    """Irreducible k-points and weights of a uniform mesh.

    Returns ``(frac_grid, weight)``: fractional coordinates of the
    irreducible points and their multiplicities / total mesh size."""
    if mesh is None:
        mesh = [3] * 3
    if isinstance(mesh, (int, np.integer)):
        mesh = [int(mesh)] * 3
    mesh = list(mesh)

    spg = _spglib()
    is_cubic_default = (lattice is None and positions is None
                        and number is None)
    if is_cubic_default and (spg is None):
        mapping, reduced = _cubic_ir_mesh(mesh)
        grid = reduced
    elif spg is not None:
        if number is None:
            number = [1]
        if positions is None:
            positions = [[0.0, 0.0, 0.0]]
        if lattice is None:
            lattice = np.eye(3)
        cell = (lattice, positions, number)
        mapping, grid = spg.get_ir_reciprocal_mesh(mesh, cell,
                                                   is_shift=[0, 0, 0])
    else:
        raise ImportError(
            "gen_ir_ks for non-cubic lattices requires spglib, which is not "
            "available in this environment")

    unique_inds = np.unique(mapping)
    total = int(np.prod(mesh))
    weight = np.array([np.sum(mapping == u) for u in unique_inds])
    assert weight.sum() == total
    weight = weight / total

    frac_grid = np.asarray(grid)[unique_inds] / np.array(mesh, dtype=float)
    print_logging_info("Number of ir-kpoints: %d" % len(unique_inds),
                       level=2)
    return frac_grid, weight
