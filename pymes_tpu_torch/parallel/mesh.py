"""Device meshes for the explicit-collective multi-device paths.

Counterpart of ``pymes_tpu/parallel/mesh.py:24-99``.  The JAX package is
single-controller: one process drives every device of a ``jax.sharding.
Mesh``, and a ``ppermute`` is a device-to-device copy.  The port keeps that
design: a :class:`Mesh` is an explicit tuple of ``torch.device``s with one
axis name, a sharded tensor is a :class:`Sharded` tuple of per-device
pieces, and the ring ladder (:mod:`pymes_tpu_torch.parallel.ring_ladder`)
moves its shards with device-to-device copies.

A device may repeat in the tuple only when the caller lists it so
(``devices=["cuda:0"] * 4``, or ``["cpu"] * 4``): the counterpart of the
JAX package's virtual devices (``--xla_force_host_platform_device_count``),
on which every shard, step and copy of a path runs at full width on one
card.  :func:`make_mesh` never folds shards onto one card by itself and
never moves them to the CPU.

Only the 1-D mesh is ported: the 2-D ("a", "b") mesh serves the GSPMD
steps of the JAX package (XLA partitions every einsum of an unchanged
solver), which wait for a later slice together with multi-process
(``torch.distributed``/NCCL) meshes.
"""

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


class Mesh:
    """A 1-D device mesh: ``devices`` (tuple of torch.device) under one
    axis name; ``shape[axis]`` is the number of devices."""

    def __init__(self, devices, axis_names=("a",)):
        if len(axis_names) != 1:
            raise ValueError("only the 1-D mesh is ported; got axes "
                             f"{tuple(axis_names)}")
        self.devices = tuple(_indexed(d) for d in devices)
        self.axis_names = tuple(axis_names)
        self.shape = {self.axis_names[0]: len(self.devices)}


def make_mesh(n_devices, device, axis_names=("a",), devices=None):
    """A :class:`Mesh` over ``n_devices`` devices.

    Without ``devices`` it takes the first ``n_devices`` cards of
    ``device="cuda"`` and raises when fewer are visible (``device="cpu"``
    has one device).  ``devices`` lists the devices explicitly; a device
    may repeat there (one card standing in for several)."""
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
    return Mesh(devices[:n_devices], axis_names)


def largest_dividing_mesh(dim, max_devices):
    """Largest device count ≤ max_devices that divides ``dim``."""
    for d in range(min(dim, max_devices), 0, -1):
        if dim % d == 0:
            return d
    return 1


class Sharded(NamedTuple):
    """A tensor cut over a mesh: ``shards[p]`` lies on ``mesh.devices[p]``
    and holds the p-th equal slice along ``axis`` (``axis=None``: every
    device holds the whole tensor)."""

    shards: tuple
    axis: object = None

    def gather(self, device):
        """The whole tensor on ``device``."""
        dev = torch.device(device)
        if self.axis is None:
            return self.shards[0].to(dev)
        return torch.cat([s.to(dev) for s in self.shards], dim=self.axis)


def shard_tensor(mesh, x, axis):
    """Cut ``x`` into equal slices along ``axis`` (None: replicate), one
    per mesh device.  A slice that already lies on its device stays a view
    of ``x``; a replica is copied once per distinct device."""
    n = len(mesh.devices)
    if axis is None:
        # one copy per distinct device: a repeated device holds one tensor
        copies = {}
        for d in mesh.devices:
            if d not in copies:
                copies[d] = x.to(d)
        return Sharded(tuple(copies[d] for d in mesh.devices), None)
    if x.shape[axis] % n:
        raise ValueError(f"axis {axis} of length {x.shape[axis]} does not "
                         f"divide a mesh of {n} devices")
    return Sharded(tuple(s.to(d) for s, d in
                         zip(torch.chunk(x, n, dim=axis), mesh.devices)),
                   axis)


def vblock_axis(name):
    """The axis of a named V block cut over a 1-D mesh: its first virtual
    slot (letters a..d; i..l are occupied), None when it has none — the
    1-D case of ``pymes_tpu/parallel/mesh.py:57-71`` ``vblock_pspec``."""
    for pos, c in enumerate(name):
        if c in "abcd":
            return pos
    return None


def shard_blocks(mesh, dict_t_V):
    """Every named V block cut on its first virtual axis over the mesh
    (occupied-only blocks replicated); returns a dict of :class:`Sharded`."""
    return {name: shard_tensor(mesh, x, vblock_axis(name))
            for name, x in dict_t_V.items()}


def shard_amplitudes(mesh, T1, T2):
    """T1 (a, i) and T2 (a, b, i, j) cut on their first axis."""
    return shard_tensor(mesh, T1, 0), shard_tensor(mesh, T2, 0)


def replicated(mesh, x):
    return shard_tensor(mesh, x, None)
