"""Ring-accumulated particle-particle ladder over a device mesh.

Counterpart of ``pymes_tpu/parallel/ring_ladder.py:26-123``.  The dense
ladder ``R = Σ_cd V_abcd T_cdij`` with V row-sharded on the output axis a
and T sharded on the contraction axis c: each shard contracts the T shard
it holds with the matching c-panel of its local V block, then passes the
shard to its ring neighbour, so P steps see every shard and no shard ever
holds all of T.

Per shard ``me``, step ``k`` contracts the held shard, which started on
shard ``src = (me − k) mod P``, with V's c-panel ``src``
(``ring_ladder.py:82-84``), adds the product into R (the JAX package's
summation order), then sends the held shard to ``(me + 1) mod P``
(``:98``).  The step's product is kernel K9
(:mod:`pymes_tpu_torch.kernels.ring_step`), which reads the panel in place
and accumulates into R in place.

The schedule runs in order on every device: each send is a ``.to`` of the
held shard onto the neighbour's device (a peer copy across cards, nothing
on a repeated device), which PyTorch orders after the step's K9 launches.
After the ring the a-shards of R are concatenated on ``mesh.devices[0]``,
the device that carries the solver loop.  ``n_slices`` (the Ozaki path) is
not ported.
"""

import torch

from pymes_tpu_torch.kernels.ring_step import ring_step
from pymes_tpu_torch.parallel.mesh import Sharded, shard_tensor


def _v_shards(V_abcd, mesh, n_dev):
    """The per-device V blocks (a_loc, nv, nv, nv), contiguous: from a
    :class:`Sharded` cut on axis 0 (``mesh.shard_blocks``), a list of
    shards, or a whole tensor (cut here)."""
    if isinstance(V_abcd, torch.Tensor):
        V_abcd = shard_tensor(mesh, V_abcd, 0)
    if isinstance(V_abcd, Sharded):
        if V_abcd.axis != 0:
            raise ValueError("V_abcd must be cut on its first axis")
        V_abcd = V_abcd.shards
    if len(V_abcd) != n_dev:
        raise ValueError(f"{len(V_abcd)} V shards for a mesh of {n_dev}")
    out = []
    for v, dev in zip(V_abcd, mesh.devices):
        if v.device != dev:
            raise ValueError(f"a V shard lies on {v.device}, its mesh "
                             f"device is {dev}")
        out.append(v.contiguous())
    return out


def _ring(mesh, V_loc, held, R2d, T2d, csz, twin):
    """Run the P ring steps: ``R2d(me)`` and ``T2d(buffer)`` give the 2-D
    (M, N) / (M, K) views of shard me's result and of a T buffer;
    ``held[me]`` is shard me's own T shard."""
    devs = mesh.devices
    P = len(devs)
    nv = V_loc[0].shape[1]
    Vm = [v.view(v.shape[0] * nv, nv * nv) for v in V_loc]
    R = [R2d(me) for me in range(P)]
    for k in range(P):
        for me in range(P):
            src = (me - k) % P
            ring_step(R[me], T2d(held[me]), Vm[me], src * csz * nv,
                      twin=twin)
        held = [held[(me - 1) % P].to(devs[me]) for me in range(P)]


def _split(n_dev, nv):
    if nv % n_dev:
        raise ValueError(f"nv={nv} must divide the mesh axis ({n_dev})")
    return nv // n_dev


def ring_ladder_inside_ij(V_abcd, T_ijcd, mesh, axis="a", twin=False):
    """Occupied-leading ring ladder ``R_ijab = Σ_cd V_abcd T_ijcd``: V cut
    on axis 0 over the mesh (see :func:`_v_shards`), ``T_ijcd`` whole on
    ``mesh.devices[0]`` and cut on its c axis here; returns ``R_ijab`` on
    ``mesh.devices[0]``.  ``twin=True`` runs K9's plain twin on the card."""
    devs = mesh.devices
    n_dev = mesh.shape[axis]
    no_i, no_j, nv = T_ijcd.shape[0], T_ijcd.shape[1], T_ijcd.shape[2]
    csz = _split(n_dev, nv)
    V_loc = _v_shards(V_abcd, mesh, n_dev)
    held = [T_ijcd[:, :, p * csz:(p + 1) * csz, :].to(devs[p]).contiguous()
            for p in range(n_dev)]
    R_loc = [torch.zeros((no_i, no_j, v.shape[0], nv), dtype=T_ijcd.dtype,
                         device=d) for v, d in zip(V_loc, devs)]
    M = no_i * no_j
    _ring(mesh, V_loc, held, lambda me: R_loc[me].view(M, -1),
          lambda t: t.view(M, -1), csz, twin)
    return torch.cat([r.to(devs[0]) for r in R_loc], dim=2)


def ring_ladder_inside(V_abcd, T_cdij, mesh, axis="a", twin=False):
    """abij ring ladder ``R_abij = Σ_cd V_abcd T_cdij``: V cut on axis 0,
    ``T_cdij`` whole on ``mesh.devices[0]`` or a :class:`Sharded` cut on
    axis 0; returns ``R_abij`` on ``mesh.devices[0]``.  K9 reads the
    cd-major T shards and writes R through transposed views (no copy)."""
    devs = mesh.devices
    n_dev = mesh.shape[axis]
    if not isinstance(T_cdij, Sharded):
        _split(n_dev, T_cdij.shape[0])
        T_cdij = shard_tensor(mesh, T_cdij, 0)
    if T_cdij.axis != 0:
        raise ValueError("T_cdij must be cut on its first axis")
    held = [t.to(d).contiguous() for t, d in zip(T_cdij.shards, devs)]
    nv = held[0].shape[1]
    csz = _split(n_dev, nv)
    V_loc = _v_shards(V_abcd, mesh, n_dev)
    no_i, no_j = held[0].shape[2], held[0].shape[3]
    M = no_i * no_j
    R_loc = [torch.zeros((v.shape[0], nv, no_i, no_j), dtype=v.dtype,
                         device=d) for v, d in zip(V_loc, devs)]
    _ring(mesh, V_loc, held, lambda me: R_loc[me].view(-1, M).t(),
          lambda t: t.view(-1, M).t(), csz, twin)
    return torch.cat([r.to(devs[0]) for r in R_loc], dim=0)


def ring_ladder(V_abcd, T_cdij, mesh, axis="a", twin=False):
    """Standalone form: cut both operands on axis 0 over the mesh, then
    ring-contract (:func:`ring_ladder_inside`)."""
    return ring_ladder_inside(shard_tensor(mesh, V_abcd, 0),
                              shard_tensor(mesh, T_cdij, 0), mesh, axis,
                              twin=twin)
