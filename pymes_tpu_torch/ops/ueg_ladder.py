"""Matrix-free particle-particle ladder for the UEG: the momentum-sector plan.

Counterpart of the ``BlockLadder`` part of ``pymes_tpu/ops/ueg_ladder.py``.
``V[p,q,c,d] = w(k_c − k_p) δ(k_p+k_q = k_c+k_d)`` is block-diagonal in the
total momentum K = k_p+k_q, so the ladder ``R_ijpq = Σ_cd V_pqcd T_ijcd`` is
a set of small dense sector GEMMs and no nv⁴ tensor exists.  The plan is
built on the host (numpy, as in the JAX package) and lives on ``device``;
:func:`block_ladder_apply_ij` runs kernel K1
(:mod:`pymes_tpu_torch.kernels.block_ladder`) on a CUDA tensor and its
plain twin on a CPU tensor.

The matrix-free CCSD adds the OVVV gather plans (:class:`OVVVPlan`, built
on the host like the ladder plan) with :func:`ovvv_t1_apply_j` running
kernel K4 (:mod:`pymes_tpu_torch.kernels.ovvv_gather`), and the T1-dressed
ladder :func:`dressed_ladder_apply_ij` on the all-bra plan.

The EOM sigma works in the ``abij`` layout over a batch of trial vectors:
:func:`block_ladder_apply` / :func:`ladder_apply` /
:func:`dressed_ladder_apply` take ``[..., c, d, i, j]`` amplitudes and run
K1 once on the batch flattened cd-major to (nv², batch·no²);
:func:`ovvv_t1_apply` gathers a batch of T1 columns through K4 at once, and
:func:`ovvv_t1_trace` traces a gather over its occupied axis in K4's
diagonal entry.

A plan built with ``pad_sectors=P`` splits over a P-device mesh
(:func:`shard_block_ladder`, ``pymes_tpu/ops/ueg_ladder.py:578-596``): each
shard holds its slice of every bucket's sector axis with its own K1 pack
on its device; the apply entries take the :class:`ShardedBlockLadder`
unchanged and make one K1 launch per shard, each writing only its own bra
rows, which are copied into the output on the amplitudes' device.

Weight classes (``correlator`` and the integral flags of
``UEG.eval_2b_integrals``): the transfer-only classes (Coulomb, RPA-approx,
hermitian TC) in every plan, and in :func:`build_block_ladder` also the
non-hermitian TC classes (``is_only_2b``, ``is_only_non_hermi_2b``), whose
(c,d)-dependent term −(kp_c−kp_d)·q·u(q²)/Ω is a plain function of the
(bra, ket-pair) element within a sector and so lands in the sector blocks at
build time: K1 runs them unchanged.  The OVVV plans take the transfer-only
classes and raise for the others, as the JAX package does.

Not ported: the Ozaki presliced form (``preslice``; the H100 has native f64
GEMMs) and the gather-scan ``UEGLadder`` (no path of the package runs it).
"""

from typing import NamedTuple

import numpy as np
import torch

from pymes_tpu_torch.config import check_f64, resolve_device
from pymes_tpu_torch.kernels import block_ladder as _k1
from pymes_tpu_torch.kernels import ovvv_gather as _k4
from pymes_tpu_torch.models.ueg import _call_correlator


class BlockGroup(NamedTuple):
    """One padded-size bucket of total-momentum sectors."""

    blocks: torch.Tensor      # (nS, mB, mK) — V values, 0 on padding
    perm_ket: torch.Tensor    # (nS, mK) int32 — ket-pair flat ids (pad→0)
    bra_of_row: torch.Tensor  # (nS, mB) int32 — bra-pair id of each row
    #                           (−1 on padding rows); inverse of inv_bra


class BlockLadder(NamedTuple):
    """Momentum-block-diagonal ladder plan (see the module docstring).

    ``inv_bra`` gathers the twin's concatenated sector columns (+ a trailing
    zero column for bra pairs whose K has no ket pair) back to bra order;
    the kernel writes each row to its bra pair through ``bra_of_row``
    instead.  ``packed`` holds the kernel's flat view of the groups."""

    groups: tuple          # of BlockGroup
    inv_bra: torch.Tensor  # (n_bra²,) int64 into concat-R columns
    n_bra: int
    nv: int
    w0: float              # zero-transfer weight w(q=0)
    packed: _k1.LadderPack


def _pad_to(m):
    """Bucket size for a sector dimension (the JAX package's "fine"
    schedule): multiples of 8 up to 64, of 16 up to 128, of 32 up to 256,
    of 64 above."""
    if m <= 8:
        return 8
    step = 8 if m <= 64 else 16 if m <= 128 else 32 if m <= 256 else 64
    return -(-m // step) * step


def _transfer_weights(ueg_model, q_vecs, correlator=None, **integral_flags):
    """w(q) for the transfer-only integral classes (Coulomb, RPA-approx,
    hermitian-TC) on integer transfer vectors ``q_vecs`` (n, 3)
    (``pymes_tpu/ops/ueg_ladder.py:39-68``)."""
    qp = q_vecs * 2.0 * np.pi / ueg_model.L
    q2 = np.einsum("nx,nx->n", qp, qp)
    with np.errstate(divide="ignore"):
        coul = np.where(q2 > 0, 4.0 * np.pi / np.where(q2 > 0, q2, 1.0),
                        0.0)
    if correlator is None and not integral_flags:
        return coul / ueg_model.Omega
    if integral_flags.get("is_rpa_approx"):
        u = _call_correlator(correlator, q2, scalar_path=True)
        return np.where(
            q2 > 0, -ueg_model.n_ele * q2 * u ** 2 / ueg_model.Omega ** 2,
            0.0)
    if integral_flags.get("is_only_hermi_2b"):
        # Coulomb + Σ∇u·∇u convolution + q²u(q²): all transfer-only
        u = _call_correlator(correlator, q2, scalar_path=True)
        ueg_model.correlator = correlator
        u_mat = ueg_model._sum_nabla_u_squared(
            q_vecs.reshape(-1, 1, 3), None).reshape(-1)
        return np.where(q2 > 0, (coul + u_mat + q2 * u) / ueg_model.Omega,
                        u_mat / ueg_model.Omega)
    raise NotImplementedError(
        "gather plans support the Coulomb, RPA-approx and hermitian-TC "
        "integral classes (transfer-only weights); for the non-hermitian "
        "classes use build_block_ladder, whose sector blocks carry the "
        "(c,d)-dependent term")


def _nh_flags(integral_flags):
    """Split the integral flags of a NON-HERMITIAN class into the
    transfer-only base class + a marker to add the −(kp_c−kp_d)·q·u(q²)/Ω
    sector term (reference ``pymes/model/ueg.py:441-470``).  Returns
    (base_flags | None, needs_nh)."""
    f = dict(integral_flags)
    if f.pop("is_only_2b", False):
        # hermitian base (coul + Σ∇u·∇u + q²u) + the nh term
        f["is_only_hermi_2b"] = True
        return f, True
    if f.pop("is_only_non_hermi_2b", False):
        # coulomb base + the nh term (matches eval_2b_integrals: at q=0
        # the class value is 0)
        return (f or None), True
    return integral_flags, False


def _sector_nh(ueg_model, tvec_int, kcd_int, correlator):
    """Non-hermitian sector term ``nh[i,j] = −(kp_c−kp_d)·q·u(q²)/Ω`` with
    q = tvec (the transfer k_c − k_p of the (bra_i, ket_j) element) and
    (kp_c − kp_d) of ket pair j.  Twist shifts cancel in both differences,
    so integer k arithmetic is exact."""
    two_pi_L = 2.0 * np.pi / ueg_model.L
    qv = tvec_int * two_pi_L                        # (mB_, mK_, 3)
    q2 = np.einsum("ijx,ijx->ij", qv, qv)
    u = _call_correlator(correlator, q2, scalar_path=True)
    cd = kcd_int * two_pi_L                          # (mK_, 3)
    return -np.einsum("jx,ijx->ij", cd, qv) * u / ueg_model.Omega


def bra_of_row_from_inv_bra(shapes, inv_bra):
    """Invert the bra permutation: for groups of ``shapes`` [(nS, mB), ...]
    in concat order, the bra-pair id that each padded row holds (−1 on
    padding rows).  Columns at or past the total are the zero column."""
    inv_bra = np.asarray(inv_bra, dtype=np.int64)
    total = sum(nS * mB for nS, mB in shapes)
    flat = np.full(total, -1, np.int32)
    live = inv_bra < total
    flat[inv_bra[live]] = np.nonzero(live)[0]
    out, off = [], 0
    for nS, mB in shapes:
        out.append(flat[off:off + nS * mB].reshape(nS, mB))
        off += nS * mB
    return out


def plan_from_arrays(group_arrays, inv_bra, n_bra, nv, w0, device):
    """Assemble a :class:`BlockLadder` on ``device`` from host arrays
    ``[(blocks (nS,mB,mK), perm_ket (nS,mK)), ...]`` in concat order and the
    bra permutation ``inv_bra`` (n_bra²,)."""
    dev = resolve_device(device)
    bra = bra_of_row_from_inv_bra(
        [np.shape(b)[:2] for b, _ in group_arrays], inv_bra)
    packed, views = _k1.pack_groups(
        [(b, p, r) for (b, p), r in zip(group_arrays, bra)], dev,
        n_rows=len(inv_bra))
    groups = tuple(BlockGroup(blocks=b, perm_ket=p, bra_of_row=r)
                   for b, p, r in views)
    return BlockLadder(
        groups=groups,
        inv_bra=torch.as_tensor(np.asarray(inv_bra, np.int64), device=dev),
        n_bra=int(n_bra), nv=int(nv), w0=float(w0), packed=packed)


def build_block_ladder(ueg_model, correlator=None, dtype=np.float64,
                       bra="virtual", preslice=9, pad_sectors=1, pad="fine",
                       *, device=None, **integral_flags):
    """Build a :class:`BlockLadder` on ``device`` (None: the card; host
    numpy build, the algorithm of
    ``pymes_tpu.ops.ueg_ladder.build_block_ladder`` with ``preslice=None``;
    its leaves are held identical by the tests).  ``preslice`` (the JAX
    package's Ozaki slices, exact f64) is accepted and ignored; ``dtype``
    other than f64 and ``pad`` other than "fine" (K1's sector padding)
    raise ValueError.

    ``correlator`` and ``integral_flags`` select the integral class as in
    ``UEG.eval_2b_integrals``: every transfer-only class, plus the
    non-hermitian ``is_only_2b`` / ``is_only_non_hermi_2b``, whose
    (c,d)-dependent term is added to the sector blocks here.

    ``bra="virtual"`` spans virtual bra pairs (the CCD ladder); ``"all"``
    spans all orbitals on the bra side.  ``pad_sectors`` rounds every
    bucket's sector count up to a multiple (zero blocks, all-(−1)
    ``bra_of_row``), so the sector axis divides a mesh of that size
    (:func:`shard_block_ladder`)."""
    check_f64(dtype, "build_block_ladder")
    if pad != "fine":
        raise ValueError(f"pad={pad!r}: K1 takes sectors padded to a "
                         "multiple of 8 ket pairs, the 'fine' padding only")
    no = ueg_model.n_ele // 2
    n_p = ueg_model.n_spatial
    nv = n_p - no
    k_int = np.asarray(ueg_model.basis.k_int)
    k_ket = k_int[no:]
    k_bra = k_int if bra == "all" else k_int[no:]
    n_bra = len(k_bra)

    # total-momentum keys of every bra / ket pair
    span = 2 * int(np.abs(k_int).max()) + 1

    def enc(K):
        off = K + (span // 2) * 2  # guard: K in [-2 kmax, 2 kmax]
        return (off[..., 0] * (2 * span) + off[..., 1]) * (2 * span) \
            + off[..., 2]

    K_ket = enc((k_ket[:, None, :] + k_ket[None, :, :]).reshape(-1, 3))
    K_bra = enc((k_bra[:, None, :] + k_bra[None, :, :]).reshape(-1, 3))

    # weight table over the transfer cube t = k_c − k_p.  Non-hermitian TC
    # classes split into a transfer-only base + the (c,d)-dependent sector
    # term added below; with a Coulomb base the correlator is dropped.
    base_flags, needs_nh = _nh_flags(integral_flags)
    tmax = int(np.abs(k_ket[:, None, :] - k_bra[None, :, :]).max())
    grid = np.arange(-tmax, tmax + 1)
    T3 = np.stack(np.meshgrid(grid, grid, grid, indexing="ij"),
                  axis=-1).reshape(-1, 3)
    wtab = _transfer_weights(ueg_model, T3,
                             None if (needs_nh and not base_flags)
                             else correlator,
                             **(base_flags or {})).reshape(
        2 * tmax + 1, 2 * tmax + 1, 2 * tmax + 1)

    def w_of(tvec):
        i = tvec + tmax
        return wtab[i[..., 0], i[..., 1], i[..., 2]]

    # sector membership
    order_k = np.argsort(K_ket, kind="stable")
    keys_k, starts_k = np.unique(K_ket[order_k], return_index=True)
    order_b = np.argsort(K_bra, kind="stable")
    keys_b, starts_b = np.unique(K_bra[order_b], return_index=True)
    ends_k = np.append(starts_k[1:], len(order_k))
    ends_b = np.append(starts_b[1:], len(order_b))
    pos_b = {k: i for i, k in enumerate(keys_b)}

    buckets = {}
    for si, key in enumerate(keys_k):
        ket_ids = order_k[starts_k[si]:ends_k[si]]
        bi = pos_b[key]  # ket pairs ⊆ bra pairs for both bra modes
        bra_ids = order_b[starts_b[bi]:ends_b[bi]]
        mB, mK = _pad_to(len(bra_ids)), _pad_to(len(ket_ids))
        buckets.setdefault((mB, mK), []).append((bra_ids, ket_ids))

    # assemble groups + global output-column offsets
    group_arrays = []
    col0 = 0
    inv_bra = np.full(n_bra * n_bra, -1, np.int64)
    for (mB, mK), secs in sorted(buckets.items()):
        nS = -(-len(secs) // int(pad_sectors)) * int(pad_sectors)
        blocks = np.zeros((nS, mB, mK), np.float64)
        perm_ket = np.zeros((nS, mK), np.int32)
        for t, (bra_ids, ket_ids) in enumerate(secs):
            nb_, nk_ = len(bra_ids), len(ket_ids)
            tvec = (k_ket[ket_ids // nv][None, :, :]
                    - k_bra[bra_ids // n_bra][:, None, :])
            blocks[t, :nb_, :nk_] = w_of(tvec)
            if needs_nh:
                kcd = k_ket[ket_ids // nv] - k_ket[ket_ids % nv]
                blocks[t, :nb_, :nk_] += _sector_nh(ueg_model, tvec, kcd,
                                                    correlator)
            perm_ket[t, :nk_] = ket_ids
            inv_bra[bra_ids] = col0 + t * mB + np.arange(nb_)
        group_arrays.append((blocks, perm_ket))
        col0 += nS * mB
    inv_bra[inv_bra < 0] = col0  # zero column: bra K with no ket pair
    return plan_from_arrays(group_arrays, inv_bra, n_bra, nv,
                            wtab[tmax, tmax, tmax], device)


class ShardedBlockLadder(NamedTuple):
    """A :class:`BlockLadder` split over a mesh on its sector axis.

    ``shards[p]`` lies on ``mesh.devices[p]`` and holds the p-th slice of
    every bucket's sectors; its ``bra_of_row`` numbers the shard's live rows
    0, 1, … in its concat order, its ``inv_bra`` gives their concat columns
    (for the twin), and ``rows[p]`` their bra-pair ids in the whole
    output."""

    shards: tuple   # of BlockLadder
    rows: tuple     # of int64 tensors, one per shard
    n_bra: int
    nv: int
    w0: float


def shard_block_ladder(plan: BlockLadder, mesh, axis="a"):
    """Distribute the plan's sector axis over ``mesh[axis]``
    (``pymes_tpu/ops/ueg_ladder.py:578-596``): the sectors are independent,
    so the shards share nothing until the output rows are gathered.  Build
    the plan with ``pad_sectors`` a multiple of the mesh size so every
    bucket divides it."""
    n = mesh.shape[axis]
    host = [(g.blocks.cpu().numpy(), g.perm_ket.cpu().numpy(),
             g.bra_of_row.cpu().numpy()) for g in plan.groups]
    for b, _, _ in host:
        if b.shape[0] % n:
            raise ValueError(f"a bucket of {b.shape[0]} sectors does not "
                             f"divide a mesh of {n}; build the plan with "
                             f"pad_sectors={n}")
    shards, rows = [], []
    for p, dev in enumerate(mesh.devices):
        parts = []
        for b, k, r in host:
            m = b.shape[0] // n
            parts.append((b[p * m:(p + 1) * m], k[p * m:(p + 1) * m],
                          r[p * m:(p + 1) * m]))
        flat = np.concatenate([r.ravel() for _, _, r in parts])
        live = np.nonzero(flat >= 0)[0]
        local = np.full(flat.shape, -1, np.int32)
        local[live] = np.arange(len(live), dtype=np.int32)
        bra, off = [], 0
        for _, _, r in parts:
            bra.append(local[off:off + r.size].reshape(r.shape))
            off += r.size
        packed, views = _k1.pack_groups(
            [(b, k, r) for (b, k, _), r in zip(parts, bra)], dev,
            n_rows=len(live))
        shards.append(BlockLadder(
            groups=tuple(BlockGroup(blocks=b, perm_ket=k, bra_of_row=r)
                         for b, k, r in views),
            inv_bra=torch.as_tensor(live, dtype=torch.int64, device=dev),
            n_bra=plan.n_bra, nv=plan.nv, w0=plan.w0, packed=packed))
        rows.append(torch.as_tensor(flat[live], dtype=torch.int64,
                                    device=dev))
    return ShardedBlockLadder(shards=tuple(shards), rows=tuple(rows),
                              n_bra=plan.n_bra, nv=plan.nv, w0=plan.w0)


def cast_plan(plan, dtype):
    """``plan`` (whole or sharded) with its sector blocks in ``dtype``, for
    K1's f32 instantiation (the f32 operator of the FEAST/RT mixed-precision
    engine, ``_cast_f32`` at ``pymes_tpu/solver/feast_eom_ccsd.py:250``):
    one cast of the packed blocks, each group's blocks the same view into
    it as in the plan; the index arrays are shared."""
    if isinstance(plan, ShardedBlockLadder):
        return plan._replace(shards=tuple(cast_plan(s, dtype)
                                          for s in plan.shards))
    pk = plan.packed
    blocks = pk.blocks.to(dtype)
    base = pk.blocks.storage_offset()
    groups = tuple(g._replace(blocks=blocks.as_strided(
        g.blocks.shape, g.blocks.stride(), g.blocks.storage_offset() - base))
        for g in plan.groups)
    return plan._replace(groups=groups, packed=pk._replace(blocks=blocks))


def _ladder_cd(plan, Tt, twin):
    """(n_bra², n) = V·Tt on a cd-major operand (nv², n): one K1 launch (or
    twin) on a plan, one per shard on a sharded plan, whose rows are copied
    into the output on ``Tt``'s device."""
    if not isinstance(plan, ShardedBlockLadder):
        return _k1.block_ladder_cd(plan, Tt, twin=twin)
    Tt = Tt.contiguous()
    out = Tt.new_zeros((plan.n_bra * plan.n_bra, Tt.shape[1]))
    for shard, rows in zip(plan.shards, plan.rows):
        part = _k1.block_ladder_cd(shard, Tt.to(rows.device), twin=twin)
        out.index_copy_(0, rows.to(out.device), part.to(out.device))
    return out


def _ladder_ij(plan, T2, twin):
    """(no², n_bra²) = T2·Vᵀ on ijab amplitudes (no², nv²)."""
    if not isinstance(plan, ShardedBlockLadder):
        return _k1.block_ladder(plan, T2, twin=twin)
    return _ladder_cd(plan, T2.t(), twin).t()


def block_ladder_apply_ij(plan: BlockLadder, T_ijab, *, twin=False):
    """``R_ijpq = Σ_cd V_pqcd T_ijcd`` with T carried ``[i,j,c,d]``.

    K1 on a CUDA tensor (``twin=True`` forces the plain twin, for the
    on-card comparisons), the twin on a CPU tensor.  Returns
    (no, no, n_bra, n_bra); from the kernel it is a strided view of the
    bra-major output."""
    no_i, no_j, nv = T_ijab.shape[0], T_ijab.shape[1], T_ijab.shape[-1]
    R = _ladder_ij(plan, T_ijab.reshape(no_i * no_j, nv * nv), twin)
    return R.reshape(no_i, no_j, plan.n_bra, plan.n_bra)


def block_ladder_apply(plan: BlockLadder, T_abij, *, twin=False):
    """abij-layout variant: ``R_pqij = Σ_cd V_pqcd T_cdij`` with T carried
    ``[..., c, d, i, j]`` (any leading batch axes).  The batch goes to K1
    as ONE cd-major operand (nv², batch·no²) — no copy without a batch, one
    permute copy with it — and the bra-major output comes back as a view
    ``[..., p, q, i, j]`` of shape (..., n_bra, n_bra, no, no)."""
    lead = tuple(T_abij.shape[:-4])
    nv, _, no_i, no_j = T_abij.shape[-4:]
    nb = int(np.prod(lead, dtype=np.int64))
    Tt = T_abij.reshape((nb, nv * nv, no_i * no_j)).transpose(0, 1)
    Tt = Tt.reshape(nv * nv, nb * no_i * no_j)
    R = _ladder_cd(plan, Tt, twin)                        # (n_bra², nb·no²)
    R = R.reshape(plan.n_bra, plan.n_bra, nb, no_i, no_j).permute(
        2, 0, 1, 3, 4)
    return R.reshape(lead + (plan.n_bra, plan.n_bra, no_i, no_j))


def ladder_apply(plan, T_abij, chunk=1, *, twin=False):
    """abij-layout dispatch on the plan type (only :class:`BlockLadder` is
    ported, whole or sharded).  ``chunk`` (the gather-scan ladder's batch
    split, which the port does not have) is accepted and ignored."""
    if not isinstance(plan, (BlockLadder, ShardedBlockLadder)):
        raise TypeError(f"unsupported ladder plan {type(plan).__name__}")
    return block_ladder_apply(plan, T_abij, twin=twin)


def ladder_apply_ij(plan, T_ijab, chunk=1, *, twin=False):
    """Occupied-leading dispatch on the plan type (only
    :class:`BlockLadder` is ported, whole or sharded); ``chunk`` as in
    :func:`ladder_apply`."""
    if not isinstance(plan, (BlockLadder, ShardedBlockLadder)):
        raise TypeError(f"unsupported ladder plan {type(plan).__name__}")
    return block_ladder_apply_ij(plan, T_ijab, twin=twin)


class OVVVPlan(NamedTuple):
    """Gather plan for ``out[j,p,q,r] = Σ_s V[p,q,r,s] T1[s,j]`` on a
    momentum-structured block whose LAST axis is virtual:
    ``V[p,q,r,s] = w(k_r − k_p) δ(k_p+k_q = k_r+k_s)`` fixes s given
    (p,q,r).  With it no nv³·no-sized ovvv block exists on the device."""

    S: torch.Tensor   # (n0, n1, n2) int32 — virtual index of k_p+k_q−k_r
    #                   (−1 = outside the basis)
    W: torch.Tensor   # (n0, n2) f64 — w(k_r − k_p)


def build_ovvv_t1_plan(ueg_model, ranges, correlator=None, dtype=np.float64,
                       *, device=None, **integral_flags):
    """Build an :class:`OVVVPlan` on ``device`` (None: the card; ``dtype``
    other than f64 raises ValueError) for leading-axis orbital
    ``ranges`` (3-char string of 'o'/'v'/'a'; the contracted 4th axis is
    virtual).  Host numpy, the algorithm of
    ``pymes_tpu.ops.ueg_ladder.build_ovvv_t1_plan``; the weights take the
    transfer-only classes (:func:`_transfer_weights`, which raises
    ``NotImplementedError`` for the non-hermitian ones)."""
    check_f64(dtype, "build_ovvv_t1_plan")
    dev = resolve_device(device)
    no = ueg_model.n_ele // 2
    k_int = ueg_model.basis.k_int
    sel = {"o": k_int[:no], "v": k_int[no:], "a": k_int}
    k0, k1, k2 = (sel[c] for c in ranges)

    ksum = (k0[:, None, None, :] + k1[None, :, None, :]
            - k2[None, None, :, :])
    S = ueg_model._lookup_flat(ksum)
    S = np.where(S >= no, S - no, -1)

    d = (k2[None, :, :] - k0[:, None, :]).reshape(-1, 3)
    q_vecs, inv = np.unique(d, axis=0, return_inverse=True)
    w = _transfer_weights(ueg_model, q_vecs, correlator, **integral_flags)
    W = w[inv.reshape(-1)].reshape(len(k0), len(k2))
    return OVVVPlan(
        S=torch.as_tensor(S.astype(np.int32), device=dev),
        W=torch.as_tensor(W, dtype=torch.float64, device=dev))


def build_ovvv_plans(ueg_model, correlator=None, dtype=np.float64, *,
                     device=None, **integral_flags):
    """The three ovvv gather plans the matrix-free CCSD dressing needs
    (leading-range patterns vvo/ovv/vov) on ``device`` (None: the card),
    keyed for ``dict_t_V["_ovvv_plans"]``."""
    return {pat: build_ovvv_t1_plan(ueg_model, pat, correlator, dtype,
                                    device=device, **integral_flags)
            for pat in ("vvo", "ovv", "vov")}


def ovvv_t1_apply_j(plan: OVVVPlan, T1, *, twin=False):
    """``out[j,p,q,r] = Σ_s V[p,q,r,s] T1[s,j]`` through the gather plan:
    K4 on a CUDA tensor (``twin=True`` forces the plain twin), the twin on a
    CPU tensor.  ``T1`` is (nv, no); returns (no, n0, n1, n2)."""
    return _k4.ovvv_gather(plan.S, plan.W, T1, twin=twin)


def ovvv_t1_apply(plan: OVVVPlan, T1, *, twin=False):
    """``out[..., p,q,r,j] = Σ_s V[p,q,r,s] T1[..., s,j]`` (the JAX
    package's ``[p,q,r,j]`` layout, any leading batch axes of T1): one K4
    launch on the batch as batch·no columns, T1 read in place through its
    strides.  Returns a view of K4's j-leading output, (..., n0, n1, n2,
    no)."""
    lead = tuple(T1.shape[:-2])
    nv, no = T1.shape[-2:]
    out = _k4.ovvv_gather(plan.S, plan.W, T1.reshape(-1, nv, no), twin=twin)
    return out.reshape(lead + (no,) + tuple(plan.S.shape)).movedim(-4, -1)


def ovvv_t1_trace(plan: OVVVPlan, T1, axis, *, twin=False):
    """The (j′ = j) trace of :func:`ovvv_t1_apply_j` over the plan's
    occupied axis ``axis`` (1: ``einsum("jajb->ab")`` on the vov plan; 0:
    ``einsum("jjab->ab")`` on ovv), without the full gather: K4's diagonal
    entry on a CUDA tensor, the twin on a CPU tensor.  ``T1`` (nv, no);
    returns (nv, nv)."""
    return _k4.ovvv_gather_diag(plan.S, plan.W, T1, axis, twin=twin)


def dressed_ladder_apply(ladder_all, T_ai, T_abij, no, W=None, *,
                         twin=False):
    """T1-dressed ladder ``R_abij = Σ_cd V̄_abcd T_cdij`` in the abij layout
    (any leading batch axes): with the all-bra ``W[..., p,q,i,j]``

    ``R = W_vv − T1·W_ov − W_vo·T1 + T1·W_oo·T1``

    (``pymes_tpu/ops/ueg_ladder.py:643``).  ``W`` may come precomputed (the
    EOM sigma shares it with the singles); otherwise K1 computes it on
    the all-bra plan ``ladder_all``."""
    if W is None:
        W = ladder_apply(ladder_all, T_abij, twin=twin)
    W_vv = W[..., no:, no:, :, :]
    W_ov = W[..., :no, no:, :, :]
    W_vo = W[..., no:, :no, :, :]
    W_oo = W[..., :no, :no, :, :]
    R = W_vv
    R = R - torch.einsum("ak,...kbij->...abij", T_ai, W_ov)
    R = R - torch.einsum("bl,...alij->...abij", T_ai, W_vo)
    R = R + torch.einsum("ak,bl,...klij->...abij", T_ai, T_ai, W_oo)
    return R


def dressed_ladder_apply_ij(ladder_all, T_ai, T_ijab, no, W=None, *,
                            twin=False):
    """T1-dressed ladder ``R_ijab = Σ_cd V̄_abcd T_ijcd`` without V̄_abcd:
    the bra dressing is rank-1, so with the all-bra
    ``W[i,j,p,q] = Σ_cd V_pqcd T_ijcd``

    ``R = W_vv − T1·W_ov − W_vo·T1 + T1·W_oo·T1``.

    ``W`` may come precomputed (the CCSD iteration shares it with the
    singles residual); otherwise K1 computes it on the all-bra plan
    ``ladder_all``."""
    if W is None:
        W = ladder_apply_ij(ladder_all, T_ijab, twin=twin)
    W_vv = W[:, :, no:, no:]
    W_ov = W[:, :, :no, no:]
    W_vo = W[:, :, no:, :no]
    W_oo = W[:, :, :no, :no]
    R = W_vv
    R = R - torch.einsum("ak,ijkb->ijab", T_ai, W_ov)
    R = R - torch.einsum("bl,ijal->ijab", T_ai, W_vo)
    R = R + torch.einsum("ak,bl,ijkl->ijab", T_ai, T_ai, W_oo)
    return R
