"""Device meshes for the explicit-collective multi-device paths.

Counterpart of ``pymes_tpu/parallel/mesh.py:24-99``.  The JAX package is
single-controller: one process drives every device of a ``jax.sharding.
Mesh``, and a ``ppermute`` is a device-to-device copy.  The port keeps that
design: a :class:`Mesh` is an explicit tuple of ``torch.device``s under one
axis name ("a") or two ("a", "b"), laid out row-major, and a sharded tensor
is a :class:`Sharded` tuple of per-device pieces in the same order.  The
ring ladder (:mod:`pymes_tpu_torch.parallel.ring_ladder`) moves its shards
with device-to-device copies; the tensor-parallel CCD/CCSD iteration
(:mod:`pymes_tpu_torch.parallel.tensor_parallel`) contracts each piece on
its device.

A device may repeat in the tuple only when the caller lists it so
(``devices=["cuda:0"] * 4``, or ``["cpu"] * 4``): the counterpart of the
JAX package's virtual devices (``--xla_force_host_platform_device_count``),
on which every shard, step and copy of a path runs at full width on one
card.  :func:`make_mesh` never folds shards onto one card by itself and
never moves them to the CPU.  Multi-process (``torch.distributed``) meshes
are not ported.
"""

import math
from typing import NamedTuple

import torch

from pymes_tpu_torch.config import resolve_device


def _indexed(device):
    """``device`` with its card index ("cuda" → "cuda:<current>"), so that
    it compares equal to the device of a tensor on it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _near_square(n):
    """The near-square 2-D factorisation ``(f, n // f)`` of
    ``pymes_tpu/parallel/mesh.py:36-41``: f the largest divisor of n not
    above √n."""
    f = math.isqrt(n)
    while n % f:
        f -= 1
    return f, n // f


class Mesh:
    """A device mesh of one axis or two: ``devices`` (tuple of
    torch.device, row-major over the axes), ``axis_names``, ``grid`` (the
    number of devices along each axis) and ``shape`` ({axis name: count}).
    Without ``shape`` a 2-D mesh takes the near-square factorisation of
    the JAX package."""

    def __init__(self, devices, axis_names=("a",), shape=None):
        self.devices = tuple(_indexed(d) for d in devices)
        self.axis_names = tuple(axis_names)
        n = len(self.devices)
        if len(self.axis_names) not in (1, 2):
            raise ValueError("a mesh has one axis or two; got "
                             f"{self.axis_names}")
        if shape is None:
            shape = (n,) if len(self.axis_names) == 1 else _near_square(n)
        self.grid = tuple(int(s) for s in shape)
        if len(self.grid) != len(self.axis_names) or math.prod(self.grid) != n:
            raise ValueError(f"mesh shape {self.grid} over axes "
                             f"{self.axis_names} does not hold {n} devices")
        self.shape = dict(zip(self.axis_names, self.grid))


def make_mesh(n_devices, device, axis_names=("a",), shape=None,
              devices=None):
    """A :class:`Mesh` over ``n_devices`` devices.

    Without ``devices`` it takes the first ``n_devices`` cards of
    ``device="cuda"`` and raises when fewer are visible (``device="cpu"``
    has one device).  ``devices`` lists the devices explicitly; a device
    may repeat there (one card standing in for several).  ``axis_names=
    ("a", "b")`` makes a 2-D mesh of ``shape`` (default near-square)."""
    n_devices = int(n_devices)
    if devices is None:
        dev = resolve_device(device)
        if dev.type == "cuda":
            n_vis = torch.cuda.device_count()
            devices = [torch.device("cuda", i) for i in range(n_vis)]
        else:
            devices = [dev]
    devices = [resolve_device(d) for d in devices]
    if len(devices) < n_devices:
        raise RuntimeError(
            f"a mesh of {n_devices} devices asked for, {len(devices)} "
            "available; list a repeated device explicitly (devices=[...]) "
            "to stand one device in for several")
    return Mesh(devices[:n_devices], axis_names, shape)


def largest_dividing_mesh(dim, max_devices):
    """Largest device count ≤ max_devices that divides ``dim``."""
    for d in range(min(dim, max_devices), 0, -1):
        if dim % d == 0:
            return d
    return 1


def _position(p, grid):
    """Index p of a row-major grid as one index along each axis."""
    pos = []
    for n in reversed(grid):
        pos.append(p % n)
        p //= n
    return tuple(reversed(pos))


class Sharded(NamedTuple):
    """A tensor cut over a mesh: ``shards[p]`` lies on ``mesh.devices[p]``.

    On a 1-D mesh (``grid`` None) ``axis`` is the tensor axis cut into
    equal slices, the p-th slice on device p (None: every device holds the
    whole tensor).  On a 2-D mesh ``grid`` is the mesh's shape and
    ``axis`` a pair: the tensor axis cut over each mesh axis (None:
    replicated over it); the pieces run row-major over the grid."""

    shards: tuple
    axis: object = None
    grid: tuple = None

    @property
    def axes(self):
        """The tensor axis cut over each mesh axis (None: replicated)."""
        return self.axis if self.grid is not None else (self.axis,)

    @property
    def mesh_grid(self):
        return self.grid if self.grid is not None else (len(self.shards),)

    def position(self, p):
        """Piece p's index along each mesh axis (row-major)."""
        return _position(p, self.mesh_grid)

    def is_replica(self, p):
        """True when piece p repeats a piece earlier in the grid (it lies
        past index 0 along a mesh axis the tensor is replicated over)."""
        return any(i and ax is None
                   for i, ax in zip(self.position(p), self.axes))

    def cuts(self, p):
        """{tensor axis: slice of the whole tensor} that piece p holds."""
        piece = self.shards[p]
        return {ax: slice(i * piece.shape[ax], (i + 1) * piece.shape[ax])
                for i, ax in zip(self.position(p), self.axes)
                if ax is not None}

    def gather(self, device):
        """The whole tensor on ``device``: along each mesh axis, from the
        last to the first, the pieces are concatenated on their cut axis
        (or the first taken where the tensor is replicated)."""
        dev = torch.device(device)
        pieces = list(self.shards)
        for n, ax in zip(reversed(self.mesh_grid), reversed(self.axes)):
            runs = [pieces[i:i + n] for i in range(0, len(pieces), n)]
            pieces = [r[0].to(dev) if ax is None else
                      torch.cat([s.to(dev) for s in r], dim=ax)
                      for r in runs]
        return pieces[0]


def shard_tensor(mesh, x, axis):
    """Cut ``x`` over the mesh: on a 1-D mesh into equal slices along
    ``axis`` (None: replicate), on a 2-D mesh along the pair ``axis`` (one
    tensor axis or None for each mesh axis).  A slice that already lies on
    its device stays a view of ``x``; a replica is copied once per distinct
    device.  A cut axis that does not divide its mesh axis raises."""
    grid = mesh.grid
    axes = (axis,) if len(grid) == 1 else tuple(axis)
    if len(axes) != len(grid):
        raise ValueError(f"{len(axes)} cut axes for a mesh of shape {grid}")
    cut = [ax for ax in axes if ax is not None]
    if len(set(cut)) != len(cut):
        raise ValueError(f"axis {axes} cuts one tensor axis twice")
    for ax, n in zip(axes, grid):
        if ax is not None and x.shape[ax] % n:
            raise ValueError(f"axis {ax} of length {x.shape[ax]} does not "
                             f"divide a mesh axis of {n} devices")
    copies = {}
    pieces = []
    for p, dev in enumerate(mesh.devices):
        pos = _position(p, grid)
        key = (tuple(i for i, ax in zip(pos, axes) if ax is not None), dev)
        if key not in copies:
            s = x
            for i, ax, n in zip(pos, axes, grid):
                if ax is not None:
                    size = x.shape[ax] // n
                    s = s.narrow(ax, i * size, size)
            copies[key] = s.to(dev)
        pieces.append(copies[key])
    if len(grid) == 1:
        return Sharded(tuple(pieces), axis)
    return Sharded(tuple(pieces), axes, grid)


def vblock_axes(name, mesh_axes=("a",)):
    """The mesh axis each axis of a named V block is cut over: its first
    virtual slot (letters a..d; i..l are occupied) over ``mesh_axes[0]``,
    its second over ``mesh_axes[1]`` on a 2-D mesh, every other slot
    uncut (None) — ``pymes_tpu/parallel/mesh.py:57-71`` ``vblock_pspec``
    as a tuple."""
    free = list(mesh_axes)
    return tuple(free.pop(0) if c in "abcd" and free else None
                 for c in name)


def vblock_axis(name):
    """The axis of a named V block cut over a 1-D mesh: its first virtual
    slot, None when it has none (the 1-D case of :func:`vblock_axes`)."""
    spec = vblock_axes(name)
    return spec.index("a") if "a" in spec else None


def _tensor_axes(spec, mesh):
    """The :func:`shard_tensor` ``axis`` of a per-tensor-axis spec (mesh
    axis name or None for each tensor axis)."""
    axes = tuple(spec.index(a) if a in spec else None
                 for a in mesh.axis_names)
    return axes[0] if len(axes) == 1 else axes


def shard_blocks(mesh, dict_t_V, mesh_axes=None):
    """Every named V block cut over the mesh by :func:`vblock_axes`
    (occupied-only blocks replicated); returns a dict of
    :class:`Sharded`."""
    if mesh_axes is None:
        mesh_axes = mesh.axis_names
    return {name: shard_tensor(mesh, x,
                               _tensor_axes(vblock_axes(name, mesh_axes),
                                            mesh))
            for name, x in dict_t_V.items()}


def shard_amplitudes(mesh, T1, T2, mesh_axes=None):
    """T1 (a, i) cut on its first axis over the first mesh axis; T2
    (a, b, i, j) on its first axis, and on a 2-D mesh on its second over
    the second mesh axis."""
    if mesh_axes is None:
        mesh_axes = mesh.axis_names
    t1 = (mesh_axes[0], None)
    t2 = tuple(mesh_axes[:2]) + (None,) * (4 - len(mesh_axes[:2]))
    return (shard_tensor(mesh, T1, _tensor_axes(t1, mesh)),
            shard_tensor(mesh, T2, _tensor_axes(t2, mesh)))


def replicated(mesh, x):
    return shard_tensor(mesh, x, None if len(mesh.grid) == 1
                        else (None,) * len(mesh.grid))
