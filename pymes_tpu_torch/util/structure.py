"""Crystal structure (POSCAR) handling and force-driven geometry relaxation.

Capability parity with ``pymes/util/structure.py:12,175``: POSCAR-format
read/write with structure history, direct↔cartesian conversion, a
minimum-image nearest-neighbour distance table, and a gradient-descent
``Optimizer`` that reads HF/MP2 forces from files and updates positions.

spglib-dependent extras (space-group detection, primitive-cell reduction,
force symmetrization under the site symmetry) are gated: they work when
spglib is importable and raise ``ImportError`` otherwise.

A host-numpy copy of ``pymes_tpu/util/structure.py``.  spglib is imported
only where one of those extras runs, never at import.
"""

import sys

import numpy as np

from pymes_tpu_torch.log import print_logging_info

eps = sys.float_info.epsilon * 10


def _spglib():
    try:
        import spglib
    except ImportError:
        return None
    return spglib


class Structure:
    """POSCAR-backed crystal structure (scaled coordinates; multiply by
    ``latticeConstant`` for physical distances)."""

    def __init__(self, fileName=None):
        self.cellVecs = np.eye(3)
        self.latticeConstant = 1.0
        self.numAtom = 1
        self.posAtom = np.zeros((self.numAtom, 3))
        self.fileName = fileName
        self.fileHeader = "header\n"
        self.typeCor = "D"
        self.atomSpec = "H"
        self.spaceGroup = None
        self.spgCell = None
        if fileName is not None:
            self.readFromFile(fileName)
        self.spgCell = self.convert2SpgCell()

    # --- conversions -----------------------------------------------------
    def convert2SpgCell(self):
        self.spgCell = (self.cellVecs.T * self.latticeConstant,
                        self.posAtom, np.ones(self.numAtom))
        return self.spgCell

    def getSpacegroup(self, symprec=0.01):
        spg = _spglib()
        if spg is None:
            raise ImportError("space-group detection requires spglib")
        self.spaceGroup = spg.get_spacegroup(self.spgCell, symprec=symprec)
        return self.spaceGroup

    def getPrimitiveCell(self, symprec=0.01):
        spg = _spglib()
        if spg is None:
            raise ImportError("primitive-cell reduction requires spglib")
        return spg.find_primitive(self.spgCell, symprec=symprec)

    def direct2Cart(self, coor):
        return (self.cellVecs @ np.atleast_2d(coor).T).T.reshape(
            np.shape(coor))

    def cart2Direct(self, coor):
        return (np.linalg.inv(self.cellVecs)
                @ np.atleast_2d(coor).T).T.reshape(np.shape(coor))

    def getDistance(self, posI, posJ):
        return np.linalg.norm(np.asarray(posI) - np.asarray(posJ)) \
            * self.latticeConstant

    def findNNTable(self):
        """Minimum-image pair distances over the 27 neighbouring cells."""
        if self.typeCor.lower().startswith("d"):
            cart = self.direct2Cart(self.posAtom)
        else:
            cart = self.posAtom
        shifts = np.array([s1 * self.cellVecs.T[0] + s2 * self.cellVecs.T[1]
                           + s3 * self.cellVecs.T[2]
                           for s1 in (-1, 0, 1) for s2 in (-1, 0, 1)
                           for s3 in (-1, 0, 1)])
        diff = cart[:, None, None, :] - (cart[None, :, None, :]
                                         + shifts[None, None, :, :])
        dists = np.linalg.norm(diff, axis=-1).min(axis=-1) \
            * self.latticeConstant
        np.fill_diagonal(dists, 0.0)
        return dists

    # --- I/O -------------------------------------------------------------
    def readFromFile(self, fileName=None):
        with open(fileName) as f:
            self.fileHeader = next(f)
            self.latticeConstant = float(next(f))
            for c in range(3):
                self.cellVecs[:, c] = np.array(next(f).split(), dtype=float)
            spec = next(f)
            skiprows = 6
            try:
                self.numAtom = int(spec)
                self.atomSpec = "H"
            except ValueError:
                self.atomSpec = spec.strip().split()[0]
                self.numAtom = int(next(f).split()[0])
                skiprows += 1
            self.typeCor = next(f).strip()[0]
            skiprows += 1
        self.posAtom = np.loadtxt(fileName, skiprows=skiprows,
                                  max_rows=self.numAtom).reshape(-1, 3)
        self.convert2SpgCell()

    def write2File(self, fileName=None):
        """Append to StructureHistory.dat; optionally write a POSCAR."""
        def _dump(path, mode="a"):
            with open(path, mode) as f:
                f.write(self.fileHeader)
                f.write(str(self.latticeConstant) + "\n")
                np.savetxt(f, self.cellVecs.T)
                f.write(str(self.atomSpec) + "\n")
                f.write(str(self.numAtom) + "\n")
                f.write(str(self.typeCor) + "\n")
                np.savetxt(f, self.posAtom)

        _dump("StructureHistory.dat", "a")
        if fileName is not None:
            _dump(fileName, "w")


class Optimizer:
    """Gradient-descent geometry relaxation driven by force files
    (reference API: ``structure.py:175``)."""

    def __init__(self, structure, threshhold=1e-3, symprec=0.01,
                 timestep=0.01):
        self.structure = structure
        self.numAtom = structure.numAtom
        self.HFForces = np.zeros((self.numAtom, 3))
        self.MP2Forces = np.zeros((self.numAtom, 3))
        self.totalForces = np.zeros((self.numAtom, 3))
        self.timeStep = timestep
        self.threshhold = threshhold
        self.symprec = symprec
        self.structureUpdated = 0

    def readForces(self, hf_file=None, mp2_file=None):
        """Read per-atom cartesian forces from whitespace tables."""
        if hf_file is not None:
            self.HFForces = np.loadtxt(hf_file).reshape(-1, 3)
        if mp2_file is not None:
            self.MP2Forces = np.loadtxt(mp2_file).reshape(-1, 3)
        self.totalForces = self.HFForces + self.MP2Forces
        return self.totalForces

    def symmetrizeForces(self, forces=None):
        """Project forces onto the symmetry-allowed subspace.

        With spglib available the site symmetry operations are applied;
        natively, the rigid-body constraint (zero net force) is enforced —
        the component every point group removes.
        """
        if forces is None:
            forces = self.totalForces
        forces = np.asarray(forces, dtype=float)
        forces = forces - forces.mean(axis=0, keepdims=True)
        spg = _spglib()
        if spg is not None:
            cell = self.structure.convert2SpgCell()
            sym = spg.get_symmetry(cell, symprec=self.symprec)
            rot = sym["rotations"]
            # average of all symmetry images of the force field
            acc = np.zeros_like(forces)
            cart = self.structure.cellVecs.T * self.structure.latticeConstant
            inv = np.linalg.inv(cart)
            for r in rot:
                r_cart = cart.T @ r @ inv.T
                acc += forces @ r_cart.T
            forces = acc / len(rot)
        self.totalForces = forces
        return forces

    def isConverged(self, forces=None):
        if forces is None:
            forces = self.totalForces
        return bool(np.abs(forces).max() < self.threshhold)

    def updatePositions(self):
        """One steepest-descent step x ← x + dt·F (forces in cartesian,
        positions updated in the structure's coordinate type)."""
        s = self.structure
        delta_cart = self.timeStep * self.totalForces
        if s.typeCor.lower().startswith("d"):
            delta = s.cart2Direct(delta_cart / s.latticeConstant)
        else:
            delta = delta_cart
        s.posAtom = s.posAtom + delta
        s.convert2SpgCell()
        self.structureUpdated += 1
        print_logging_info(
            "Optimizer step %d: max|F| = %.3e" %
            (self.structureUpdated, np.abs(self.totalForces).max()), level=2)
        return s.posAtom

    def run_step(self, hf_file=None, mp2_file=None, write_history=True):
        """Read forces → symmetrize → convergence check → update → dump."""
        self.readForces(hf_file, mp2_file)
        self.symmetrizeForces()
        if self.isConverged():
            return True
        self.updatePositions()
        if write_history:
            self.structure.write2File()
        return False

    def project2PrimitiveCell(self, forces, map2pc=None,
                              map_file="ionIndices.dat"):
        """Select the supercell force rows belonging to the primitive-cell
        atoms (reference API: ``structure.py:309-319``).

        ``map2pc`` is the (n_pc, 2) ion-index table (1-based in the file,
        column 1 holding the supercell row of each primitive atom) or a
        plain 1-D 0-based row list.
        """
        if map2pc is None:
            map2pc = np.loadtxt(map_file).astype(int) - 1
        map2pc = np.asarray(map2pc, dtype=int)
        rows = map2pc[:, 1] if map2pc.ndim == 2 else map2pc
        return np.asarray(forces)[rows, :]


def relax_primitive_from_supercell(pc, sc, forces, map2pc,
                                   threshhold=5e-2, symprec=0.01,
                                   timestep=0.01):
    """Production relaxation workflow: supercell forces drive the
    primitive-cell geometry (the reference's ``main()``,
    ``pymes/util/structure.py:395-440``).

    Forces are symmetrized under the *supercell* symmetries, projected
    onto the primitive-cell atoms (``map2pc``), re-symmetrized under the
    *primitive-cell* symmetries, and — unless converged — one
    gradient-descent step updates ``pc`` in place.

    Returns ``(pc, transform, updated)`` with ``transform`` the integer
    supercell matrix ``cell_sc = transform · cell_pc``.
    """
    opt_sc = Optimizer(sc, threshhold, symprec, timestep)
    opt_pc = Optimizer(pc, threshhold, symprec, timestep)

    f = opt_sc.symmetrizeForces(np.asarray(forces, dtype=float))
    f = opt_sc.project2PrimitiveCell(f, map2pc)
    opt_pc.totalForces = opt_pc.symmetrizeForces(f)

    cart_sc = sc.cellVecs.T * sc.latticeConstant
    cart_pc = pc.cellVecs.T * pc.latticeConstant
    transform = cart_sc.dot(np.linalg.inv(cart_pc))
    transform[np.abs(transform) < eps] = 0.0
    transform = np.rint(transform)

    updated = not opt_pc.isConverged()
    if updated:
        opt_pc.updatePositions()
    return pc, transform, updated
