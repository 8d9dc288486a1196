"""CCD / DCD / drCCD (+ Brueckner) ground-state solver, occupied-leading
layout.

Counterpart of ``pymes_tpu/solver/ccd.py`` for the ``ijab`` loop layout:
``CCDBlocks``/``CCDBlocksIJ``/``blocks_ij_from``, ``doubles_residual_ij``
with the dense-``abcd`` and matrix-free-ladder branches and the
``is_dcd``/``is_bruekner`` flags, ``ccd_energy_ij``, the fixed point
:func:`ccd_solve` (the ``ccd_solve_jit`` body as a Python loop) and the
:class:`CCD` API.  With ``is_dr_ccd`` the residual is the direct-ring one
of :mod:`pymes_tpu_torch.solver.drccd` (which needs no ladder) and the
energy its direct part.

The ring and exchange contractions are plain f64 products (``torch.einsum``,
cuBLAS DGEMM on the card).  The particle-particle ladder runs through
kernel K1 (a ladder plan), through the ring-accumulated ladder over a
device mesh with kernel K9 (``ring_mesh``, the dense ``abcd`` cut over the
mesh by :func:`pymes_tpu_torch.parallel.mesh.shard_blocks`), tensor-parallel
on the pieces of a cut ``abcd`` without ``ring_mesh`` (one product per
piece on its device, :func:`pymes_tpu_torch.parallel.tensor_parallel.
ladder`, 1-D or 2-D mesh) or as one ``torch.einsum`` on the dense
``abcd``.  The P(ab,ij) symmetrisation
``R + Ex + P(Ex)`` runs through K5 and the per-iteration Jacobi + DIIS +
energy tail through K2/K3 (:mod:`pymes_tpu_torch.kernels`) on a CUDA
tensor; on a CPU tensor all of them run their plain twins.

The T1-dressing hooks that CCSD (:mod:`pymes_tpu_torch.solver.ccsd`) feeds
through the same residual are here too: ``t_T_ai`` (the dressed ladder on
the all-bra plan), ``ladder_W`` (its precomputed all-bra image), ``ex_half``
(the half-symmetric dressing of ``abij``, added before the P(ab,ij)
symmetrisation) and ``abij_t=None``.

With ``ring_mesh`` the JAX package's default loop is the abij layout
(``pymes_tpu/solver/ccd.py:617-621``); the port keeps its ijab loop, whose
math is identical (``tests/test_ccd_layout.py``).

``CCD.solve(mixed_precision=True)`` is the JAX package's mixed schedule
(``pymes_tpu/solver/ccd.py:639-656``): the bulk of the fixed point runs in
f32 on the f32 copy of the Fock, the blocks (the ladder plan's sector
blocks, a cut ``abcd`` piece by piece) and T to |dE| < max(1e-5,
``delta_e``), its GEMMs at full f32 (TF32 off) and its kernels in their
f32 instantiations (K1, K2/K3, K5), and the f64 solve polishes from the
f32 amplitudes.  Like the JAX f32 pass it takes no ``ring_mesh``: a cut
``abcd`` runs its f32 pass tensor-parallel, and with ``ring_mesh`` any
other ``abcd`` (a whole tensor or a list of shards, which the ring alone
takes) raises.  ``ccd_solve`` and the DIIS take the amplitudes' type
throughout.

Not ported: the ``abij`` loop layout and the Ozaki/sliced contraction
modes.
"""

from typing import NamedTuple

import numpy as np
import torch

from pymes_tpu_torch.config import DTYPE, resolve_device
from pymes_tpu_torch.kernels import ccd_tail, pair_sym
from pymes_tpu_torch.log import print_logging_info
from pymes_tpu_torch.mixer import diis
from pymes_tpu_torch.ops.ueg_ladder import (dressed_ladder_apply_ij,
                                            ladder_apply_ij)
from pymes_tpu_torch.parallel import tensor_parallel
from pymes_tpu_torch.parallel.mesh import Sharded
from pymes_tpu_torch.parallel.ring_ladder import ring_ladder_inside_ij
from pymes_tpu_torch.solver import drccd, mp2
from pymes_tpu_torch.util.precision import cast_f32, full_f32_matmul


class CCDBlocks(NamedTuple):
    """The integral blocks entering the doubles amplitude equation;
    ``ladder`` (a :class:`~pymes_tpu_torch.ops.ueg_ladder.BlockLadder`) may
    replace the dense ``abcd`` (set ``abcd=None`` then)."""

    klij: torch.Tensor
    ijab: torch.Tensor
    abij: torch.Tensor
    iajb: torch.Tensor
    iabj: torch.Tensor
    abcd: torch.Tensor    # or a Sharded (the ring and tensor-parallel
    #                       paths)
    ladder: object = None


def blocks_from_full(no, t_V_pqrs):
    o, v = slice(None, no), slice(no, None)
    return CCDBlocks(klij=t_V_pqrs[o, o, o, o], ijab=t_V_pqrs[o, o, v, v],
                     abij=t_V_pqrs[v, v, o, o], iajb=t_V_pqrs[o, v, o, v],
                     iabj=t_V_pqrs[o, v, v, o], abcd=t_V_pqrs[v, v, v, v])


def blocks_from_dict(dict_t_V):
    return CCDBlocks(klij=dict_t_V["klij"], ijab=dict_t_V["ijab"],
                     abij=dict_t_V["abij"], iajb=dict_t_V["iajb"],
                     iabj=dict_t_V["iabj"], abcd=dict_t_V.get("abcd"),
                     ladder=dict_t_V.get("ladder"))


class CCDBlocksIJ(NamedTuple):
    """Loop-invariant blocks pre-permuted (contiguous) for the
    occupied-leading layout; built once per solve by
    :func:`blocks_ij_from`."""

    klij: torch.Tensor    # V[k,l,i,j]
    ijab: torch.Tensor    # V[i,j,a,b]
    ijab_x: torch.Tensor  # V[i,j,b,a] (exchange image, for the energy)
    abij_t: torch.Tensor  # V[a,b,i,j] -> [i,j,a,b] (may be None)
    ikac: torch.Tensor    # V_iajb[k,a,i,c] -> [i,k,a,c]
    kjcb: torch.Tensor    # V_iabj[k,b,c,j] -> [k,j,c,b]
    abcd: torch.Tensor    # dense ladder block (None with a ladder plan)
    ladder: object = None
    ladder_W: object = None  # precomputed all-bra W[i,j,p,q] (CCSD)
    ex_half: object = None   # extra Ex term, added BEFORE the P(ab,ij)
    #   symmetrisation: the half-symmetric T1 dressing S of abij with
    #   S + P(S) = full dressing (ccsd.dressed_block(half_symmetric=True))


def blocks_ij_from(blocks: CCDBlocks):
    return CCDBlocksIJ(
        klij=blocks.klij.contiguous(),
        ijab=blocks.ijab.contiguous(),
        ijab_x=blocks.ijab.permute(0, 1, 3, 2).contiguous(),
        abij_t=blocks.abij.permute(2, 3, 0, 1).contiguous(),
        ikac=blocks.iajb.permute(2, 0, 1, 3).contiguous(),
        kjcb=blocks.iabj.permute(0, 3, 2, 1).contiguous(),
        abcd=blocks.abcd,
        ladder=blocks.ladder,
    )


def doubles_residual_ij(t_fock_ab, t_fock_ij, t_T_ijab, V: CCDBlocksIJ,
                        is_dcd=False, is_bruekner=False, t_T_ai=None,
                        contract_mode="xla", abcd_presliced=None,
                        ring_mesh=None, ring_axis="a", *, twin=False):
    """CCD/DCD doubles residual R_ijab in the occupied-leading layout (the
    diagrams of ``pymes_tpu.solver.ccd.doubles_residual_ij``).  With
    ``t_T_ai`` (CCSD) the ladder is T1-dressed on the all-bra plan; with
    ``ring_mesh`` (and no plan) it is the ring-accumulated ladder over the
    mesh on the cut ``V.abcd`` (``pymes_tpu/solver/ccd.py:305-313``);
    without, a cut ``V.abcd`` gives the ladder piece by piece, each tile
    put together on the device of ``t_T_ijab`` before K5.
    ``twin`` routes the ladder (K1, K9) and the symmetrisation (K5) through
    their plain twins on the card.  ``contract_mode`` and
    ``abcd_presliced`` (the JAX package's Ozaki contraction modes, exact
    f64) are accepted and ignored."""
    es = torch.einsum
    t = t_T_ijab
    tilde = 2.0 * t - t.transpose(2, 3)  # 2T - T^(a<->b)

    I_klij = V.klij
    if not is_dcd:
        I_klij = I_klij + es("klcd,ijcd->klij", V.ijab, t)

    R = es("klij,klab->ijab", I_klij, t)
    if V.abij_t is not None:
        R = R + V.abij_t

    # particle-particle ladder: R_ij,ab += T_ij,cd V_ab,cd
    if V.ladder is not None and t_T_ai is not None:
        R = R + dressed_ladder_apply_ij(V.ladder, t_T_ai, t, t.shape[0],
                                        W=V.ladder_W, twin=twin)
    elif V.ladder is not None:
        W = ladder_apply_ij(V.ladder, t, twin=twin)
        if W.shape[-1] != t.shape[-1]:  # all-bra plan: take the vv corner
            no_ = t.shape[0]
            W = W[:, :, no_:, no_:]
        R = R + W
    elif ring_mesh is not None:
        R = R + ring_ladder_inside_ij(V.abcd, t, ring_mesh, ring_axis,
                                      twin=twin)
    elif isinstance(V.abcd, Sharded):
        R = R + tensor_parallel.ladder(t, V.abcd)
    else:
        R = R + es("ijcd,abcd->ijab", t, V.abcd)

    if not is_dcd:
        X_ljac = es("klcd,kjad->ljac", V.ijab, t)
        R = R + es("ljac,ilcb->ijab", X_ljac, t)

    # quadratic ring with spin-adapted amplitudes
    X_kjcb = es("klcd,ljdb->kjcb", V.ijab, tilde)
    R = R + es("ikac,kjcb->ijab", tilde, X_kjcb)

    # dressed one-particle intermediates (net factor 1 for CCD, 1/2 for
    # DCD, 0 for Brueckner; see the JAX package)
    coeff = (0.0 if is_bruekner else 0.5) + (0.0 if is_dcd else 0.5)
    X_ac = t_fock_ab - coeff * es("klad,lkdc->ac", tilde, V.ijab)
    X_ki = t_fock_ij + coeff * es("ilcd,lkdc->ki", tilde, V.ijab)

    Ex = es("ac,ijcb->ijab", X_ac, t)
    Ex = Ex - es("ki,kjab->ijab", X_ki, t)
    Ex = Ex - es("ikac,kjcb->ijab", V.ikac, t)
    Ex = Ex - es("ikbc,kjac->ijab", V.ikac, t)
    Ex = Ex + es("ikac,kjcb->ijab", tilde, V.kjcb)

    if not is_dcd:
        X_lica = es("klcd,kida->lica", V.ijab, t)
        Ex = Ex - es("lica,ljcb->ijab", X_lica, t)
        Ex = Ex + es("lica,ljbc->ijab", X_lica, t)

    if V.ex_half is not None:  # half-symmetric T1 dressing of abij
        Ex = Ex + V.ex_half
    return pair_sym.pair_symmetrize(Ex, R, twin=twin)  # R + Ex + P(Ex)


def ccd_energy_ij(t_T_ijab, t_V_ijab, t_V_ijab_x):
    """(direct, exchange) energy in the occupied-leading layout."""
    e_dir = 2.0 * torch.sum(t_T_ijab * t_V_ijab)
    e_exc = -1.0 * torch.sum(t_T_ijab * t_V_ijab_x)
    return e_dir, e_exc


def ccd_solve(t_fock_pq, blocks: CCDBlocks, no, t_T0_abij,
              level_shift=0.0, delta_e=1e-8, max_iter=50, is_dcd=False,
              is_diis=True, is_bruekner=False, dim_space=6, twin=False,
              ring_mesh=None, ring_axis="a", is_dr_ccd=False,
              log_iterations=False):
    """CCD fixed point, Jacobi + DIIS, T2 carried ``[i,j,a,b]``.

    Loop semantics of ``pymes_tpu.solver.ccd.ccd_solve_jit``: iterate while
    ``|dE| > delta_e and it <= max_iter`` (so up to ``max_iter + 1``
    iterations), ``e_hist[min(it, max_iter)] = e``.  With ``delta_e >= 0``
    the loop reads dE on the host once per iteration; with ``delta_e < 0``
    it runs to the cap without any host sync inside the loop.  The DIIS
    solve's ``info`` is checked once, after the loop.  ``twin=True`` runs
    the ladder and the tail through the plain twins (on-card comparison).
    ``ring_mesh`` runs the ladder as the ring over the mesh on
    ``blocks.abcd`` cut on axis 0 (``pymes_tpu/solver/ccd.py:405-410``); the
    loop runs on ``ring_mesh.devices[0]``.  Without ``ring_mesh`` a cut
    ``blocks.abcd`` runs the tensor-parallel ladder; the loop runs on its
    home device, the device of its first piece.  ``is_dr_ccd`` runs the drCCD
    residual (no ladder: a plan or ``ring_mesh`` with it raises) and takes
    the direct energy alone (``pymes_tpu/solver/ccd.py:543-549``).
    ``log_iterations`` prints E and dE each iteration (a host read of
    both).

    Returns ``(e_corr, T_abij, eps_i, eps_a, dE, n_iter, e_hist)`` with
    device tensors and ``n_iter`` a Python int.
    """
    no = int(no)
    eps_i0 = torch.diagonal(t_fock_pq)[:no].contiguous()
    eps_a0 = torch.diagonal(t_fock_pq)[no:].contiguous()
    f_ab = t_fock_pq[no:, no:]
    f_ij = t_fock_pq[:no, :no]
    if is_dr_ccd and (blocks.ladder is not None or ring_mesh is not None):
        raise ValueError("drCCD has no ladder: pass neither a ladder plan "
                         "nor ring_mesh")
    if not is_dr_ccd and blocks.abcd is None and blocks.ladder is None:
        raise ValueError("need the dense abcd block or a ladder plan")
    if ring_mesh is not None and (blocks.ladder is not None
                                  or blocks.abcd is None):
        raise ValueError("the ring path takes the dense abcd block cut over "
                         "the mesh, and no ladder plan")
    if ring_mesh is not None and ring_mesh.devices[0] != t_fock_pq.device:
        raise ValueError(f"the loop runs on {t_fock_pq.device}, the ring "
                         f"returns R on {ring_mesh.devices[0]}")
    if ring_mesh is None and isinstance(blocks.abcd, Sharded):
        tensor_parallel.check_home(blocks.abcd, t_fock_pq.device)

    V_ij = blocks_ij_from(blocks)
    T = t_T0_abij.permute(2, 3, 0, 1).contiguous()
    e0_dir, e0_exc = ccd_energy_ij(T, V_ij.ijab, V_ij.ijab_x)
    e_last = e0_dir + e0_exc
    dE = torch.abs(e_last) + 1.0

    # without DIIS the ring has one slot and the coefficient 1: the tail
    # then writes T + dT (exactly) through the same two passes
    m = dim_space if is_diis else 1
    state = diis.init_state(m, T.numel(), T.dtype, device=T.device)
    ones = torch.ones(1, dtype=T.dtype, device=T.device)
    info = torch.zeros((), dtype=torch.int32, device=T.device)
    e_hist = torch.full((max_iter + 1,), float("nan"), dtype=T.dtype,
                        device=T.device)
    eps_i, eps_a = eps_i0, eps_a0
    it = 0
    while it <= max_iter:
        if delta_e >= 0 and not float(torch.abs(dE)) > delta_e:
            break
        if is_dr_ccd:
            R = drccd.residual(eps_i, eps_a, T, blocks.abij, blocks.iabj,
                               blocks.ijab)
        else:
            R = doubles_residual_ij(f_ab, f_ij, T, V_ij, is_dcd=is_dcd,
                                    is_bruekner=is_bruekner, twin=twin,
                                    ring_mesh=ring_mesh, ring_axis=ring_axis)
        if is_bruekner:
            # quasi-particle energies from the CURRENT amplitudes on top of
            # the canonical ε₀ (as the JAX package; the reference compounds
            # the correction and diverges)
            tilde = 2.0 * T - T.transpose(2, 3)
            eps_i = eps_i0 + 0.5 * torch.einsum("ilcd,ilcd->i",
                                                V_ij.ijab, tilde)
            eps_a = eps_a0 - 0.5 * torch.einsum("klad,klad->a",
                                                V_ij.ijab, tilde)

        slot = state.count % m
        n_valid = min(state.count + 1, m)
        row = ccd_tail.jacobi_diis_insert(R, T, eps_i, eps_a, level_shift,
                                          state.errs, state.amps, slot,
                                          n_valid, twin=twin)
        if is_diis:
            B, coeff, info_it = diis.coefficients(state.B, row, slot,
                                                  n_valid)
            info = torch.maximum(info, info_it.abs())
        else:
            B, coeff = state.B, ones
        state = diis.DIISState(amps=state.amps, errs=state.errs,
                               count=state.count + 1, B=B)
        e_dir, e_exc = ccd_tail.diis_mix_energy(
            state.amps, coeff, n_valid, T, V_ij.ijab, V_ij.ijab_x, twin=twin)
        # drCCD/dRPA energy is the direct ring alone
        e = e_dir if is_dr_ccd else e_dir + e_exc
        dE = e - e_last
        e_last = e
        e_hist[min(it, max_iter)] = e
        it += 1
        if log_iterations:
            print(f"    CCD it {it}: E = {float(e):.12f}  "
                  f"dE = {float(dE):.3e}")

    if int(info) != 0:
        raise RuntimeError("DIIS bordered system singular during the solve")
    return (e_last, T.permute(2, 3, 0, 1), eps_i, eps_a, dE, it, e_hist)


class CCD:
    """Reference-API CCD/DCD solver on ``device`` (keyword-only; None: the
    card).

    ``solve(t_fock_pq, t_V_pqrs, level_shift=0, sp=0, amps=None,
    mixed_precision=False, contract_mode=None, ring_mesh=None,
    ring_axis="a", layout=None, **kwargs)``, the JAX package's signature,
    returns ``{"ccd e", "t2 amp" (abij), "hole e", "particle e", "dE",
    "e history"}``; ``sp`` (the reference's sparse-tensor flag),
    ``contract_mode`` (the Ozaki modes, exact f64) and ``layout`` (the loop
    runs in ijab, which gives the abij loop's numbers) are accepted and
    ignored.  Host arrays are moved onto ``device``.  ``t_V_pqrs`` is the full
    tensor, a dict of named blocks (optionally with ``"ladder"``; blocks
    may come as :class:`~pymes_tpu_torch.parallel.mesh.Sharded`, e.g. from
    ``mesh.shard_blocks`` on a 1-D or 2-D mesh) or :class:`CCDBlocks`.  A
    cut ``abcd`` stays cut: with ``ring_mesh`` the ladder runs as the ring
    over the mesh on its shards, without it tensor-parallel on its pieces
    (:mod:`pymes_tpu_torch.parallel.tensor_parallel`); ``device`` is then
    its home device, the device of its first piece.  Every other cut
    block (at most two virtual slots, O(o²v²)) is gathered onto
    ``device`` once per solve."""

    def __init__(self, no, delta_e=1e-8, is_dcd=False, is_diis=True,
                 is_dr_ccd=False, is_bruekner=False, *, device=None):
        self.no = int(no)
        self.device = resolve_device(device)
        self.delta_e = delta_e
        self.is_dcd = is_dcd
        self.is_diis = is_diis
        self.is_dr_ccd = is_dr_ccd
        self.is_bruekner = is_bruekner
        self.max_iter = 50
        self.dim_space = 6
        self.log_iterations = False

    def _on_device(self, x):
        if isinstance(x, Sharded):
            return tensor_parallel.gather(x, self.device)
        if x is None or not isinstance(x, (torch.Tensor, np.ndarray)):
            return x
        return torch.as_tensor(x, dtype=DTYPE, device=self.device)

    def solve(self, t_fock_pq, t_V_pqrs, level_shift=0.0, sp=0, amps=None,
              mixed_precision=False, contract_mode=None, ring_mesh=None,
              ring_axis="a", layout=None, **kwargs):
        max_iter = int(kwargs.get("max_iter", self.max_iter))
        delta_e = float(kwargs.get("delta_e", self.delta_e))
        no = self.no
        t_fock_pq = self._on_device(t_fock_pq)
        if isinstance(t_V_pqrs, dict):
            blocks = blocks_from_dict(t_V_pqrs)
        elif isinstance(t_V_pqrs, CCDBlocks):
            blocks = t_V_pqrs
        else:
            blocks = blocks_from_full(no, self._on_device(t_V_pqrs))
        if (mixed_precision and ring_mesh is not None
                and not isinstance(blocks.abcd, Sharded)):
            # the f32 pass runs without the ring: only a cut abcd keeps it
            # off one card (tensor-parallel)
            raise ValueError("mixed_precision with ring_mesh takes abcd cut "
                             "by mesh.shard_blocks")
        fields = ("klij", "ijab", "abij", "iajb", "iabj")
        if ring_mesh is None and not isinstance(blocks.abcd, Sharded):
            fields += ("abcd",)
        blocks = blocks._replace(**{
            f: self._on_device(getattr(blocks, f)) for f in fields})

        eps_i = torch.diagonal(t_fock_pq)[:no]
        eps_a = torch.diagonal(t_fock_pq)[no:]
        print_logging_info("ccd.solve")
        print_logging_info("Using DCD: ", self.is_dcd, level=1)
        print_logging_info("Using dr-CCD: ", self.is_dr_ccd, level=1)
        print_logging_info("Using DIIS mixer: ", self.is_diis, level=1)
        print_logging_info("Using Brueckner: ", self.is_bruekner, level=1)

        e_mp2, t_T_abij = mp2.solve(eps_i, eps_a, blocks.ijab, blocks.abij,
                                    level_shift)
        print_logging_info("MP2 energy = {:.12f}".format(float(e_mp2)),
                           level=1)
        if amps is not None:
            t_T_abij = self._on_device(amps)
        if mixed_precision and t_T_abij.dtype == torch.float64:
            f32 = cast_f32((t_fock_pq, blocks, t_T_abij))
            with full_f32_matmul():
                _, T32, _, _, _, it32, _ = ccd_solve(
                    *f32[:2], no, f32[2], level_shift=level_shift,
                    delta_e=max(1e-5, delta_e), max_iter=max_iter,
                    is_dcd=self.is_dcd, is_diis=self.is_diis,
                    is_bruekner=self.is_bruekner, dim_space=self.dim_space,
                    is_dr_ccd=self.is_dr_ccd)
            print_logging_info(
                "mixed precision: {} f32 iterations".format(it32), level=1)
            self.n_iterations_f32 = it32
            t_T_abij = T32.double()

        e, T, eps_i, eps_a, dE, n_iter, e_hist = ccd_solve(
            t_fock_pq, blocks, no, t_T_abij, level_shift=level_shift,
            delta_e=delta_e, max_iter=max_iter, is_dcd=self.is_dcd,
            is_diis=self.is_diis, is_bruekner=self.is_bruekner,
            dim_space=self.dim_space, ring_mesh=ring_mesh,
            ring_axis=ring_axis, is_dr_ccd=self.is_dr_ccd,
            log_iterations=self.log_iterations)
        if n_iter > max_iter:
            print_logging_info("A converged solution is not found!", level=1)
        print_logging_info(
            "CCD correlation energy = {:.12f} ({} iterations)".format(
                float(e), n_iter), level=1)
        return {"ccd e": float(e), "t2 amp": T, "hole e": eps_i,
                "particle e": eps_a, "dE": float(dE),
                "e history": e_hist[:n_iter].cpu().numpy()}

    # the pure residual and energy with the reference's method signatures
    # (T2 and R abij-ordered), through the ijab path
    def get_residual(self, t_fock_pq, t_T_abij, t_V_klij, t_V_ijab,
                     t_V_abij, t_V_iajb, t_V_iabj, t_V_abcd):
        no = self.no
        f, T, *V = (self._on_device(x) for x in (
            t_fock_pq, t_T_abij, t_V_klij, t_V_ijab, t_V_abij, t_V_iajb,
            t_V_iabj, t_V_abcd))
        V_ij = blocks_ij_from(CCDBlocks(*V))
        R = doubles_residual_ij(f[no:, no:], f[:no, :no],
                                T.permute(2, 3, 0, 1), V_ij,
                                is_dcd=self.is_dcd,
                                is_bruekner=self.is_bruekner)
        return R.permute(2, 3, 0, 1)

    def get_energy(self, t_T_abij, t_V_ijab):
        """(direct, exchange) energy pieces."""
        T, V = self._on_device(t_T_abij), self._on_device(t_V_ijab)
        return ccd_energy_ij(T.permute(2, 3, 0, 1), V,
                             V.permute(0, 1, 3, 2))
