"""Sharding helpers for embarrassingly parallel fan-outs.

Counterpart of ``pymes_tpu/parallel/sharding.py``, in the single-controller
style of :mod:`pymes_tpu_torch.parallel.mesh`: one process drives every
device of a :class:`~pymes_tpu_torch.parallel.mesh.Mesh`, and a sharded
tensor is a :class:`~pymes_tpu_torch.parallel.mesh.Sharded` tuple of
per-device pieces.  ``shard_over_nodes`` cuts the *leading* axis of a batch
of independent work items (FEAST quadrature nodes, twist-average k-shifts,
trial vectors) over the mesh, so each device solves its own items with no
communication: the device-mesh counterpart of the reference's joblib
fan-out over contour nodes (``pymes/solver/feast_eom_rccsd.py:90-108``).
Its user is ``FEAST_EOM_CCSD(node_mesh=...)``.
"""

import torch
from torch.utils import _pytree

from pymes_tpu_torch.parallel import mesh as _mesh


def shard_over_nodes(tree, mesh, axis="a"):
    """Every tensor leaf of ``tree`` (tensors, numpy arrays and numbers,
    in nested dicts, lists and tuples) cut on its leading axis over
    ``mesh``'s devices as a :class:`Sharded`; a leaf whose leading
    dimension does not divide ``mesh.shape[axis]``, and a scalar, is
    replicated."""
    n_dev = mesh.shape[axis]

    def put(x):
        x = torch.as_tensor(x)
        if x.ndim >= 1 and x.shape[0] % n_dev == 0:
            return _mesh.shard_tensor(mesh, x, 0)
        return _mesh.replicated(mesh, x)

    return _pytree.tree_map(put, tree)


def replicate(tree, mesh):
    """Every tensor leaf of ``tree`` on each device of ``mesh`` (a
    replicated :class:`Sharded`; one copy per distinct device, so on a
    repeated device every piece is the same tensor).  Leaves that are not
    tensors (plan sizes, names) pass through unchanged."""
    def put(x):
        if isinstance(x, torch.Tensor):
            return _mesh.replicated(mesh, x)
        return x

    return _pytree.tree_map(put, tree)


def node_mesh(n_devices=None, axis="n", *, device=None, devices=None):
    """A 1-D mesh for the node fan-out over the first ``n_devices`` of the
    visible devices of ``device`` (None: the cards; ``n_devices`` None: all
    of them), through
    :func:`~pymes_tpu_torch.parallel.mesh.make_mesh` and its rules: it
    raises when fewer are visible, and a device repeats only where
    ``devices`` lists it so (``devices=["cuda:0"] * 2``)."""
    return _mesh.make_mesh(n_devices, (axis,), devices=devices,
                           device=device)
