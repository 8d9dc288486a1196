"""Tensor-parallel dense CCD/CCSD iteration over a device mesh.

The JAX package has no such module.  There a user cuts every V block and
the amplitudes over the virtual axes (``mesh.shard_blocks``,
``shard_amplitudes``) and calls the unchanged solver; XLA GSPMD partitions
every einsum and writes the collectives (``__graft_entry__.py:64-205``,
``dryrun_multichip`` stages 1 and 4).  The port writes that partitioning
out: this module holds the per-piece contractions the dense CCD/CCSD loop
makes on blocks cut by :func:`pymes_tpu_torch.parallel.mesh.shard_blocks`
(1-D ("a",) or 2-D ("a", "b") mesh), and the collectives they need.

The design is single-controller, as the rest of
:mod:`pymes_tpu_torch.parallel`: one process drives every device of the
mesh, a device may repeat in it, and the loop (T2, the DIIS rings, the
blocks with at most two virtual slots and the per-iteration kernels) runs
on the home device, the device of the first piece.  A block with three or
four virtual slots stays cut: each piece is contracted on its own device,
and only o²v²-sized results (or smaller) travel to the home device.  No
``abcd`` (v⁴), nor its T1-dressed image, is ever put together.

The collectives are :func:`gather`, :func:`all_gather`, :func:`reduce_sum`
and :func:`concat`: device-to-device copies and local sums, written as
functions of their own so that a multi-process mesh can give them
process-group bodies.
"""

import torch

from pymes_tpu_torch.parallel.mesh import Sharded


# ---- the collectives --------------------------------------------------------

def gather(x, device):
    """The whole tensor of the :class:`Sharded` ``x`` on ``device``."""
    return x.gather(device)


def all_gather(x, devices):
    """``x`` whole on each distinct device of ``devices``: {device:
    tensor}.  ``x`` is a :class:`Sharded` or a tensor."""
    out = {}
    for d in devices:
        if d not in out:
            out[d] = gather(x, d) if isinstance(x, Sharded) else x.to(d)
    return out


def reduce_sum(parts, device):
    """The sum of the per-piece partial results ``parts`` on ``device``, in
    the order given."""
    total = parts[0].to(device)
    for part in parts[1:]:
        total = total + part.to(device)
    return total


def concat(parts, dim, device):
    """The per-piece output slices ``parts`` put together along ``dim`` on
    ``device``."""
    return torch.cat([part.to(device) for part in parts], dim=dim)


# ---- per-piece contractions ---------------------------------------------------

def is_cut_block(name, x):
    """True for a :class:`Sharded` V block with three or four virtual
    slots: the blocks a tensor-parallel solve keeps cut."""
    return isinstance(x, Sharded) and sum(c in "abcd" for c in name) >= 3


def _take(t, letters, cut):
    """``t`` (axes named by ``letters``) sliced to the ranges ``cut``
    ({letter: slice}) of a piece."""
    return t[tuple(cut.get(c, slice(None)) for c in letters)]


def map_pieces(x, letters, fn, out_letters, device):
    """Contract every piece of ``x`` (axes named by ``letters``) on its own
    device and put the result together on ``device``.

    ``fn(piece, cut)`` gets a piece and its ranges ``cut`` ({letter: slice
    of the whole axis}) and returns the piece's contribution, with axes
    ``out_letters``.  Along a mesh axis whose cut letter is kept in
    ``out_letters`` the contributions are output slices (:func:`concat`);
    along one whose letter is summed they are partial sums
    (:func:`reduce_sum`).  Replicas are contracted once."""
    grid = x.mesh_grid
    kept = [k for k, ax in enumerate(x.axes)
            if ax is not None and letters[ax] in out_letters]
    groups = {}
    for p, piece in enumerate(x.shards):
        if x.is_replica(p):
            continue
        cut = {letters[ax]: s for ax, s in x.cuts(p).items()}
        pos = x.position(p)
        groups.setdefault(tuple(pos[k] for k in kept), []).append(
            fn(piece, cut))
    parts = {key: reduce_sum(group, device) for key, group in groups.items()}
    # put the kept mesh axes together, the last first
    for level in reversed(range(len(kept))):
        k = kept[level]
        dim = out_letters.index(letters[x.axes[k]])
        parts = {key: concat([parts[key + (i,)] for i in range(grid[k])],
                             dim, device)
                 for key in dict.fromkeys(key[:level] for key in parts)}
    return parts[()]


def einsum(spec, *operands):
    """``torch.einsum(spec, *operands)`` where one operand may be a
    :class:`Sharded`: then each of its pieces is contracted on its device
    with the other operands sliced to the piece's ranges, and the result
    put together on the device of the first tensor operand."""
    cut_at = [i for i, op in enumerate(operands) if isinstance(op, Sharded)]
    if not cut_at:
        return torch.einsum(spec, *operands)
    s = cut_at[0]
    names, out = spec.replace(" ", "").split("->")
    names = names.split(",")
    device = next(op.device for op in operands
                  if isinstance(op, torch.Tensor))

    def local(piece, cut):
        ops = [piece if i == s else _take(op, n, cut).to(piece.device)
               for i, (op, n) in enumerate(zip(operands, names))]
        return torch.einsum(spec, *ops)

    return map_pieces(operands[s], names[s], local, out, device)


def ladder(T_ijcd, V_abcd):
    """The particle-particle ladder ``R_ijab = Σ_cd T_ijcd V_abcd`` on the
    device of ``T_ijcd``, with ``V_abcd`` a :class:`Sharded` (cut on a over
    a 1-D mesh, on a and b over a 2-D one).  Each piece reads the whole T
    and gives its tile of R, one f64 product (cuBLAS on the card) that
    reads the piece in place: a (a_p, b_q, cd) batch of rows against T."""
    no_i, no_j = T_ijcd.shape[:2]

    def local(piece, cut):
        a, b = piece.shape[:2]
        Tt = _take(T_ijcd, "ijcd", cut).reshape(no_i * no_j, -1).to(
            piece.device).t()
        out = torch.bmm(piece.reshape(a, b, -1), Tt.expand(a, *Tt.shape))
        return out.view(a, b, no_i, no_j).permute(2, 3, 0, 1)

    return map_pieces(V_abcd, "abcd", local, "ijab", T_ijcd.device)


def dressing_operands(dict_t_V):
    """What the T1 dressing of a cut ``abcd`` reads besides it: ``iabc``
    and ``aibc`` whole on each distinct device of its mesh
    (:func:`all_gather`, made once per solve by the solver's set-up; built
    here when the dict lacks them) and ``ijab``."""
    pre = dict_t_V.get("_abcd_dressing")
    if pre is not None:
        return pre
    missing = [k for k in ("iabc", "aibc", "ijab") if k not in dict_t_V]
    if missing:
        raise KeyError(f"the dressing of a cut abcd reads {missing}")
    devices = [s.device for s in dict_t_V["abcd"].shards]
    return (all_gather(dict_t_V["iabc"], devices),
            all_gather(dict_t_V["aibc"], devices), dict_t_V["ijab"])


def dressed_abcd(dict_t_V, t_T_ai):
    """The T1-dressed ``abcd`` of the bra rules of
    :func:`pymes_tpu_torch.solver.ccsd.dressed_block`, ``abcd − T1·iabc −
    T1·aibc + T1T1·ijab``, cut as the bare block: each piece's dressed
    tile is a new tensor on its device (never written into the bare
    piece, which on a repeated device is a view of one tensor)."""
    V = dict_t_V["abcd"]
    iabc, aibc, ijab = dressing_operands(dict_t_V)
    no = t_T_ai.shape[1]
    made = {}
    pieces = []
    for p, piece in enumerate(V.shards):
        cut = V.cuts(p)
        if set(cut) - {0, 1}:
            raise ValueError("the dressing takes abcd cut on its a and b "
                             "axes only")
        dev = piece.device
        key = (tuple(sorted((ax, s.start) for ax, s in cut.items())), dev)
        if key not in made:
            sa, sb = cut.get(0, slice(None)), cut.get(1, slice(None))
            T = t_T_ai.to(dev)
            Ta, Tb = T[sa], T[sb]
            a, b = piece.shape[:2]
            tile = piece.clone(memory_format=torch.contiguous_format)
            # − Σ_w T_aw V_wbcd
            tile.view(a, -1).addmm_(Ta, iabc[dev][:, sb].reshape(no, -1),
                                    alpha=-1.0)
            # − Σ_x T_bx V_axcd
            tile.view(a, b, -1).baddbmm_(
                Tb.expand(a, b, no), aibc[dev][sa].reshape(a, no, -1),
                alpha=-1.0)
            # + Σ_wx T_aw T_bx V_wxcd
            X = torch.einsum("aw,bx->abwx", Ta, Tb).reshape(a * b, no * no)
            tile.view(a * b, -1).addmm_(X, ijab.to(dev).reshape(no * no, -1))
            made[key] = tile
        pieces.append(made[key])
    return V._replace(shards=tuple(pieces))


def check_home(x, device):
    """Raise unless ``device`` is the home device of the cut ``abcd`` ``x``
    (the device of its first piece), where the solver's loop runs."""
    if x.shards[0].device != torch.device(device):
        raise ValueError(f"the loop runs on {device}, the cut abcd's home "
                         f"device is {x.shards[0].device}")
