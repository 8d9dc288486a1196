"""CCSD / DCSD in the T1-dressed formalism, occupied-leading layout.

Counterpart of ``pymes_tpu/solver/ccsd.py`` for ``layout="ijab"``: the T1
amplitudes dress the Fock matrix and the Coulomb blocks (Λ_bra = I − T̂ on
every bra index, Λ_ket = I + T̂ on every ket index), after which the doubles
equation is the CCD residual of :mod:`pymes_tpu_torch.solver.ccd` on dressed
inputs.  :func:`dressed_block` expands that rank-1 structure block-wise into
pairwise ``torch.einsum`` chains (cuBLAS on the card).

Three kinds of input run through :class:`CCSD`: dense molecular integrals
(FCIDUMP), transcorrelated ones (FCIDUMP ``.tc`` + TCDUMP corrections;
non-Hermitian V, the (ov) dressing keeps the reference's pairing), and the
matrix-free UEG — an all-bra ladder plan plus the OVVV gather plans under
``dict_t_V["_ovvv_plans"]``, with no ``abcd`` and no ovvv-class block on the
device.  On a CUDA tensor the matrix-free path runs kernels K1 (ladder over
T2 stacked with T1⊗T1) and K4 (ovvv gathers), and every path runs the tail
K2′/K3′ (:mod:`pymes_tpu_torch.kernels`); on a CPU tensor all of them run
their plain twins.

``solve(mixed_precision=True)`` is the JAX package's mixed schedule
(``pymes_tpu/solver/ccsd.py:755-816``), an f32 computation corrected in
f64: the bulk of the fixed point runs in f32 on the f32 copy of the V dict
(its f64 tensors, the OVVV plans' weights, the ladder plan through
``cast_plan``) and of T1/T2 to |dE| < max(1e-5, ``delta_e``), GEMMs at
full f32 and the kernels in their f32 instantiations (K1, K4 and its
fused trace, K2′/K3′, K5); the f64 solve polishes from there.  Two
departures from the JAX code, both faults there: it casts every dict
value (``:805``, which fails on the matrix-free dict, whose plans are a
dict) and hands its f32 pass the f64 ladder plan (``:806-810``, which
promotes the ladder to f64); the port casts the f64 leaves only and passes
the f32 plan, as the JAX CCD does.

``solve(dress_precision=...)`` takes None or "f64" (the f64 dressing) and
raises on "f32": the JAX package's f32 dressing carriers (``:518-566``,
``:681-713``) serve its Ozaki contraction modes, which alone choose them
(``:818-820``), and are not ported with them.

Not ported: the ``abij`` loop layout (``singles_residual``,
``ccsd_energy``), the contraction modes and Ozaki slicing, and with them
the f32 dressing carriers (``dress_precision="f32"``).
"""

import itertools
import string

import torch

from pymes_tpu_torch.config import on_one_device
from pymes_tpu_torch.integral.partition import (BLOCK_NAMES, OCC_LETTERS,
                                                part_2_body_int)
from pymes_tpu_torch.kernels import ccsd_tail
from pymes_tpu_torch.log import print_logging_info
from pymes_tpu_torch.mixer import diis
from pymes_tpu_torch.ops import ueg_ladder
from pymes_tpu_torch.parallel import tensor_parallel
from pymes_tpu_torch.parallel.mesh import Sharded
from pymes_tpu_torch.solver import ccd as ccd_mod
from pymes_tpu_torch.solver import mp2
from pymes_tpu_torch.util.observability import span, traced
from pymes_tpu_torch.util.precision import cast_f32, full_f32_matmul

# blocks the doubles residual needs in dressed form
DOUBLES_DRESSED = ("abij", "klij", "ijab", "iajb", "iabj", "abcd")
# additional dressed blocks needed by the EOM-CCSD sigma builds
EOM_DRESSED = DOUBLES_DRESSED + ("ijka", "ijak", "iabc", "abic", "iajk")


def _pattern_key(pattern):
    """Canonical block name for an o/v pattern, e.g. 'ovvo' -> 'iabj'."""
    if pattern == "oooo":
        return "klij"  # the all-occupied block is named klij in the dict
    occ_letters = iter("ijkl")
    vir_letters = iter("abcd")
    return "".join(next(occ_letters) if c == "o" else next(vir_letters)
                   for c in pattern)


def _apply_chain(cur, cur_letters, chain, t1, target_letters):
    """Apply the T1 factors ``chain`` pairwise to ``cur`` (axes named by
    ``cur_letters``), ``t1(factor)`` giving each factor's operand; the
    LAST factor emits ``target_letters`` directly."""
    for pos_tf, tf in enumerate(chain):
        dummy = tf[0] if tf[0] in "wxyz" else tf[1]
        target = tf[1] if tf[0] == dummy else tf[0]
        new_letters = cur_letters.replace(dummy, target)
        if pos_tf == len(chain) - 1 and set(new_letters) == set(
                target_letters):
            new_letters = target_letters
        cur = torch.einsum(f"{cur_letters},{tf}->{new_letters}", cur,
                           t1(tf))
        cur_letters = new_letters
    if cur_letters != target_letters:
        cur = torch.einsum(f"{cur_letters}->{target_letters}", cur)
    return cur


def _cut_term(cur, lookup, cur_letters, chain, t_T_ai, target_letters):
    """One dressing term sourced from a cut block: the term of the ``abcd``
    source with both kets dressed is the ladder on T1⊗T1 (read in place,
    tensor_parallel.ladder); any other runs its chain piece by piece with
    T1 sliced to the piece's ranges."""
    if (lookup == "abcd" and len(chain) == 2
            and cur_letters[2:] == chain[0][0] + chain[1][0]):
        k0, k1 = chain
        X = torch.einsum(f"{k0},{k1}->{k0[1]}{k1[1]}{k0[0]}{k1[0]}",
                         t_T_ai, t_T_ai)
        R = tensor_parallel.ladder(X, cur)
        return _apply_chain(R, k0[1] + k1[1] + cur_letters[:2], [], None,
                            target_letters)

    def local(piece, cut):
        T = t_T_ai.to(piece.device)
        return _apply_chain(
            piece, cur_letters, chain,
            lambda tf: T[cut[tf[0]]] if tf[0] in cut else T, target_letters)

    return tensor_parallel.map_pieces(cur, cur_letters, local,
                                      target_letters, t_T_ai.device)


def dressed_block(name, dict_t_V, t_T_ai, skip_sources=(), contract_mode="xla",
                  out_perm=None, skip_identity=False, half_symmetric=False,
                  *, twin=False):
    """T1-dress one named block by expanding the bra/ket rank-1 transforms.

    bra slots (0,1): virtual target ← {virtual source (id), occupied source
    (−T1)}; occupied target ← occupied source.  ket slots (2,3): occupied
    target ← {occupied source (id), virtual source (+T1)}; virtual target ←
    virtual source.  Options as in ``pymes_tpu.solver.ccsd.dressed_block``:

    * ``skip_sources`` drops the terms sourced from the named blocks (the
      matrix-free path replaces the ``abcd``-sourced term of ``abij`` by a
      ladder on T1⊗T1);
    * ``out_perm`` emits the block with its axes permuted, relabelled
      inside the last contraction;
    * ``skip_identity`` drops the T1-free term (the bare block);
    * ``half_symmetric`` emits ``S`` with ``S + P(S)`` = the full dressing
      (P swaps bra0↔bra1 and ket0↔ket1): one term per mirror pair, the
      self-mirror terms at weight ½.  Correct only where the caller adds
      ``P`` itself (``ex_half`` enters ``Ex`` before ``Ex + P(Ex)``).

    A source block missing from ``dict_t_V`` is read through its
    particle-exchange partner <pq|rs> = <qp|sr>.  With
    ``dict_t_V["_ovvv_plans"]`` the first virtual-ket T1 contraction of an
    ovvv-class source runs as a momentum gather (K4), so that block never
    exists.  Each term is a chain of PAIRWISE contractions, ket factors
    (which shrink a virtual axis to an occupied one) before bra factors,
    so no temporary outgrows the source block.  ``twin`` routes K4 through
    its plain twin on the card.

    Blocks cut over a mesh (:class:`~pymes_tpu_torch.parallel.mesh.
    Sharded`) are read piece by piece (:mod:`pymes_tpu_torch.parallel.
    tensor_parallel`): a cut ``abcd`` dresses into a cut ``abcd`` (no
    option applies there), and a term sourced from a cut block is put
    together on the device of ``t_T_ai``.
    """
    if name == "abcd" and isinstance(dict_t_V.get("abcd"), Sharded):
        if (skip_sources or out_perm is not None or skip_identity
                or half_symmetric):
            raise ValueError("a cut abcd dresses with no options")
        return tensor_parallel.dressed_abcd(dict_t_V, t_T_ai)
    slots = []
    for pos, c in enumerate(name):
        kind = "o" if c in OCC_LETTERS else "v"
        if pos < 2:  # bra
            if kind == "v":
                slots.append((("v", None), ("o", -1.0)))
            else:
                slots.append((("o", None),))
        else:  # ket
            if kind == "o":
                slots.append((("o", None), ("v", 1.0)))
            else:
                slots.append((("v", None),))

    if half_symmetric:
        kinds = ["o" if c in OCC_LETTERS else "v" for c in name]
        if kinds[0] != kinds[1] or kinds[2] != kinds[3]:
            raise ValueError(
                "half_symmetric needs a pair-swap-symmetric pattern "
                f"(vvoo/oooo/...), got {name}")

    out_letters = string.ascii_lowercase[:4]
    target_letters = out_letters if out_perm is None else "".join(
        out_letters[p] for p in out_perm)
    total = None
    plans = dict_t_V.get("_ovvv_plans")
    for sig in itertools.product(*(range(len(s)) for s in slots)):
        combo = tuple(slots[p][sig[p]] for p in range(4))
        src_pattern = "".join(k for k, _ in combo)
        if _pattern_key(src_pattern) in skip_sources:
            continue
        if skip_identity and all(sign is None for _, sign in combo):
            continue
        coeff = 1.0
        if half_symmetric:
            mirror = (sig[1], sig[0], sig[3], sig[2])
            if sig > mirror:
                continue        # its P-image is emitted by the partner
            if sig == mirror:
                coeff = 0.5     # self-mirror: P doubles it back
        # einsum letters: source letters; dressed slots contract through T1
        src_letters = []
        t_factors = []
        next_dummy = iter("wxyz")
        for pos, (kind, sign) in enumerate(combo):
            if sign is None:
                src_letters.append(out_letters[pos])
            else:
                d = next(next_dummy)
                src_letters.append(d)
                coeff *= sign
                if pos < 2:  # bra: occupied source d, virtual target
                    t_factors.append(out_letters[pos] + d)
                else:        # ket: virtual source d, occupied target
                    t_factors.append(d + out_letters[pos])
        spec0 = "".join(src_letters)
        kets = [tf for tf in t_factors if tf[0] in "wxyz"]
        bras = [tf for tf in t_factors if tf[0] not in "wxyz"]

        has_vket3 = combo[3][1] is not None and combo[3][0] == "v"
        has_vket2 = combo[2][1] is not None and combo[2][0] == "v"
        if (plans is not None and src_pattern.count("v") == 3
                and (has_vket3 or has_vket2)):
            # matrix-free ovvv: the first virtual-ket T1 contraction is a
            # momentum gather; the contracted axis moves to slot 3 via
            # <pq|rs> = <qp|sr>
            pat, letters = src_pattern, spec0
            if not has_vket3:
                pat = pat[1] + pat[0] + pat[3] + pat[2]
                letters = (letters[1] + letters[0]
                           + letters[3] + letters[2])
            tf0 = next(t for t in kets if t[0] == letters[3])
            cur = ueg_ladder.ovvv_t1_apply_j(plans[pat[:3]], t_T_ai,
                                             twin=twin)
            cur_letters = tf0[1] + letters[:3]
            chain = [t for t in kets if t is not tf0] + bras
        else:
            lookup = _pattern_key(src_pattern)
            cur_letters = spec0
            if lookup not in dict_t_V:
                # particle-exchange partner <pq|rs> = <qp|sr>
                lookup = _pattern_key(src_pattern[1] + src_pattern[0]
                                      + src_pattern[3] + src_pattern[2])
                cur_letters = spec0[1] + spec0[0] + spec0[3] + spec0[2]
            cur = dict_t_V[lookup]
            chain = kets + bras
        # pairwise T1 application, ket factors first
        if isinstance(cur, Sharded):
            cur = _cut_term(cur, lookup, cur_letters, chain, t_T_ai,
                            target_letters)
        else:
            cur = _apply_chain(cur, cur_letters, chain, lambda tf: t_T_ai,
                               target_letters)
        term = coeff * cur
        total = term if total is None else total + term
    return total


def get_T1_dressed_V(t_T_ai, dict_t_V, keys=None, contract_mode="xla", *,
                     twin=False, device=None):
    """Dress the requested blocks (default: every named block of the dict;
    ``"_ovvv_plans"`` and other non-block keys are skipped); returns a new
    dict.  Host arrays go to the device of the first tensor argument, else
    to ``device`` (None: the card); ``contract_mode`` (the JAX package's
    Ozaki modes, exact f64) is accepted and ignored."""
    t_T_ai, dict_t_V = on_one_device(t_T_ai, dict_t_V, device=device)
    if keys is None:
        keys = tuple(k for k in dict_t_V if k in BLOCK_NAMES)
    return {k: dressed_block(k, dict_t_V, t_T_ai, twin=twin) for k in keys}


def get_T1_dressed_fock(t_fock_pq, t_T_ai, dict_t_V, no=None,
                        contract_mode="xla", *, twin=False, device=None):
    """Dressed Fock matrix ``f̄ = Λ_bra (f + G) Λ_ket`` with the dressing
    mean field ``G_pq = Σ_bj T_bj (2 V_pjqb − V_pjbq)``; the (ov) block
    keeps the reference's non-Hermitian index pairing
    (``pymes_tpu/solver/ccsd.py:279-281``).  Without ``aibc`` in the dict,
    G_vv comes from K4's diagonal entry (the traced gathers) on the
    vov/ovv plans.  Host arrays and ``contract_mode`` as in
    :func:`get_T1_dressed_V`."""
    t_fock_pq, t_T_ai, dict_t_V = on_one_device(t_fock_pq, t_T_ai, dict_t_V,
                                                device=device)
    es = torch.einsum
    if no is None:
        no = dict_t_V["ijab"].shape[0]
    T = t_T_ai
    f_oo = t_fock_pq[:no, :no]
    f_ov = t_fock_pq[:no, no:]
    f_vo = t_fock_pq[no:, :no]
    f_vv = t_fock_pq[no:, no:]

    G_oo = (2.0 * es("ck,ikjc->ij", T, dict_t_V["ijka"])
            - es("ck,ikcj->ij", T, dict_t_V["ijak"]))
    if "aibc" in dict_t_V:  # the block, whole or cut
        tp = tensor_parallel.einsum
        G_vv = (2.0 * tp("cj,ajbc->ab", T, dict_t_V["aibc"])
                - tp("cj,ajcb->ab", T, dict_t_V["aibc"]))
    else:
        plans = dict_t_V["_ovvv_plans"]
        # the j' = j traces of [j',a,j,b] = Σ_c V_ajbc T_cj' and
        # [j',j,a,b] = Σ_c V_jabc T_cj', fused into K4's diagonal entry
        G_vv = (2.0 * ueg_ladder.ovvv_t1_trace(plans["vov"], T, 1, twin=twin)
                - ueg_ladder.ovvv_t1_trace(plans["ovv"], T, 0, twin=twin))
    G_vo = (2.0 * es("bj,ajib->ai", T, dict_t_V["aijb"])
            - es("bj,ajbi->ai", T, dict_t_V["aibj"]))
    G_ov_std = (2.0 * es("ck,ikbc->ib", T, dict_t_V["ijab"])
                - es("ck,ikcb->ib", T, dict_t_V["ijab"]))
    # (ov) block of f̄ itself: the reference's pairing
    G_ov_ref = (2.0 * es("bj,jabi->ia", T, dict_t_V["iabj"])
                - es("bj,jiab->ia", T, dict_t_V["ijab"]))

    h_oo = f_oo + G_oo
    h_ov = f_ov + G_ov_std
    h_vo = f_vo + G_vo
    h_vv = f_vv + G_vv

    fd_oo = h_oo + h_ov @ T
    fd_ov = f_ov + G_ov_ref
    fd_vv = h_vv - T @ h_ov
    fd_vo = h_vo + h_vv @ T - T @ h_oo - T @ h_ov @ T
    return torch.cat([torch.cat([fd_oo, fd_ov], dim=1),
                      torch.cat([fd_vo, fd_vv], dim=1)], dim=0)


def singles_residual_ij(t_fock_dressed_pq, t_T_ai, t_T_ijab, dict_t_V,
                        contract_mode="xla", ladder_W=None):
    """Singles residual R_ai with T2 carried ``[i,j,a,b]``; uses the
    dressed Fock and the bare V blocks.  Without ``aibc`` in the dict the
    ovvv term comes from the (v,o) corner of the all-bra ladder
    ``ladder_W`` (W[i,j,p,q] = Σ_cd V_pqcd T_ijcd).  ``contract_mode`` is
    accepted and ignored, as in :func:`get_T1_dressed_V`."""
    es = torch.einsum
    no = t_T_ai.shape[1]
    t = t_T_ijab
    tilde = 2.0 * t - t.transpose(0, 1)  # 2T - T^(i<->j)
    f_ov = t_fock_dressed_pq[:no, no:]
    R = t_fock_dressed_pq[no:, :no]
    R = R + es("jb,ijab->ai", f_ov, tilde)
    if "aibc" in dict_t_V:  # the block, whole or cut
        R = R + tensor_parallel.einsum("ajbc,ijbc->ai", dict_t_V["aibc"],
                                       tilde)
    else:
        W_vo = ladder_W[:, :, no:, :no]
        R = R + 2.0 * es("ijaj->ai", W_vo) - es("jiaj->ai", W_vo)
    X_ki = es("kjbc,ijbc->ki", dict_t_V["ijab"], tilde)
    R = R - es("ki,ak->ai", X_ki, t_T_ai)
    R = R - es("jkib,jkab->ai", dict_t_V["ijka"], tilde)
    X_ca = es("jkcb,jkab->ca", dict_t_V["ijab"], tilde)
    R = R - es("ca,ci->ai", X_ca, t_T_ai)
    return R


def ccsd_energy_ij(t_fock_ia, t_T_ai, t_T_ijab, t_V_ijab):
    """(one-body, direct, exchange) CCSD energy pieces, T2 ``[i,j,a,b]``.
    The plain version; in the loop K3′ computes them while it mixes."""
    T1t = t_T_ai.t()  # (no, nv)
    T_eff = t_T_ijab + T1t[:, None, :, None] * T1t[None, :, None, :]
    e_dir = 2.0 * torch.sum(T_eff * t_V_ijab)
    e_exc = -1.0 * torch.sum(T_eff * t_V_ijab.transpose(2, 3))
    e_1b = 2.0 * torch.sum(t_fock_ia * T1t)
    return e_1b, e_dir, e_exc


def ccsd_residuals(t_fock_pq, dict_t_V, no, T1, T2, is_dcsd=False,
                   ladder_all=None, twin=False):
    """(R1 (nv, no), R2 (no, no, nv, nv)) of one CCSD iteration: dress →
    singles and doubles residuals (``pymes_tpu/solver/ccsd.py:450-614``).

    ``ladder_all`` (an all-bra :class:`~pymes_tpu_torch.ops.ueg_ladder.
    BlockLadder`) selects the matrix-free branch: one K1 pass over T2
    stacked with X = T1⊗T1 as a (2·no², nv²) operand gives the all-bra W
    (dressed ladder and singles ovvv term) and the ladder image of X (the
    ``abcd``-sourced term of the dressed ``abij``); the remaining T1
    corrections of ``abij`` go in half-symmetric through ``ex_half``.  That
    branch reads the bare ``abij`` in the ``ijab`` order from
    ``dict_t_V["abij_t"]``, which :func:`ccsd_solve` hoists out of the
    loop."""
    es = torch.einsum
    fd = get_T1_dressed_fock(t_fock_pq, T1, dict_t_V, no=no, twin=twin)
    ladder_W = W_X = None
    if ladder_all is not None:
        nv = T1.shape[0]
        no2 = no * no
        X = es("ci,dj->ijcd", T1, T1)
        TX = torch.stack([T2.reshape(no2, -1), X.reshape(no2, -1)]).reshape(
            2, no2, nv, nv)
        WB = ueg_ladder.ladder_apply_ij(ladder_all, TX, twin=twin)
        n_bra = WB.shape[-1]
        ladder_W = WB[0].reshape(no, no, n_bra, n_bra)
        W_X = WB[1].reshape(no, no, n_bra, n_bra)
    R1 = singles_residual_ij(fd, T1, T2, dict_t_V, ladder_W=ladder_W)

    if ladder_all is None:
        Vd = get_T1_dressed_V(T1, dict_t_V, keys=DOUBLES_DRESSED, twin=twin)
        V_ij = ccd_mod.blocks_ij_from(ccd_mod.blocks_from_dict(Vd))
        R2 = ccd_mod.doubles_residual_ij(fd[no:, no:], fd[:no, :no], T2,
                                         V_ij, is_dcd=is_dcsd, twin=twin)
        return R1, R2

    keys = tuple(k for k in DOUBLES_DRESSED if k not in ("abcd", "abij"))
    Vd = {k: dressed_block(k, dict_t_V, T1, twin=twin) for k in keys}
    # dressed abij in the ijab order: the bare block (hoisted transpose)
    # plus the ladder image of T1⊗T1, both P-symmetric, stay in R; the
    # other T1 corrections enter Ex half-symmetric
    ex_half = dressed_block("abij", dict_t_V, T1, skip_sources=("abcd",),
                            out_perm=(2, 3, 0, 1), skip_identity=True,
                            half_symmetric=True, twin=twin)
    V_ij = ccd_mod.CCDBlocksIJ(
        klij=Vd["klij"], ijab=Vd["ijab"], ijab_x=None,
        abij_t=dict_t_V["abij_t"] + W_X[:, :, no:, no:],
        ikac=Vd["iajb"].permute(2, 0, 1, 3),
        kjcb=Vd["iabj"].permute(0, 3, 2, 1),
        abcd=None, ladder=ladder_all, ladder_W=ladder_W, ex_half=ex_half)
    R2 = ccd_mod.doubles_residual_ij(fd[no:, no:], fd[:no, :no], T2, V_ij,
                                     is_dcd=is_dcsd, t_T_ai=T1, twin=twin)
    return R1, R2


def energy_blocks(t_fock_pq, dict_t_V, no):
    """The loop-invariant operands of K3′: ``f_ovᵀ`` (nv, no), V_ijab and
    its exchange image V_ijba, contiguous."""
    V = dict_t_V["ijab"].contiguous()
    return (t_fock_pq[:no, no:].t().contiguous(), V,
            V.transpose(2, 3).contiguous())


def ccsd_iteration(t_fock_pq, dict_t_V, no, T1, T2, eps_i, eps_a,
                   level_shift, diis_state, e_last, is_dcsd=False,
                   is_diis=True, ladder_all=None, *, e_blocks=None,
                   twin=False):
    """One CCSD iteration: dress → residuals → Jacobi → DIIS → energy
    (``pymes_tpu/solver/ccsd.py:414``, ``layout="ijab"``).

    The Jacobi denominators are built inside K2′ from ``eps_i``, ``eps_a``
    and ``level_shift`` (no D tensors).  ``T1`` (nv, no) and ``T2``
    (no, no, nv, nv) are updated IN PLACE, and so are the rings of
    ``diis_state`` (its ``count`` is a host int).  Without DIIS the ring has
    one slot and the coefficient 1, so the tail writes T + dT exactly.
    ``e_blocks`` are :func:`energy_blocks` (computed when None).  With
    ``ladder_all`` the dict carries ``"abij_t"`` (:func:`ccsd_residuals`).

    Returns ``(diis_state, e, dE, info)``: ``info`` is the bordered DIIS
    solve's, checked by the caller (0 when ``is_diis`` is False)."""
    with span("cc.residual"):
        R1, R2 = ccsd_residuals(t_fock_pq, dict_t_V, no, T1, T2,
                                is_dcsd=is_dcsd, ladder_all=ladder_all,
                                twin=twin)
    with span("cc.tail"):
        if e_blocks is None:
            e_blocks = energy_blocks(t_fock_pq, dict_t_V, no)
        m = diis_state.amps.shape[0]
        slot = diis_state.count % m
        n_valid = min(diis_state.count + 1, m)
        row = ccsd_tail.jacobi_diis_insert(
            R1, T1, R2, T2, eps_i, eps_a, level_shift, diis_state.errs,
            diis_state.amps, slot, n_valid, twin=twin)
        if is_diis:
            B, coeff, info = diis.coefficients(diis_state.B, row, slot,
                                               n_valid)
        else:
            B = diis_state.B
            coeff = torch.ones(1, dtype=T2.dtype, device=T2.device)
            info = torch.zeros((), dtype=torch.int32, device=T2.device)
        diis_state = diis.DIISState(amps=diis_state.amps,
                                    errs=diis_state.errs,
                                    count=diis_state.count + 1, B=B)
        e1, ed, ex = ccsd_tail.diis_mix_energy(diis_state.amps, coeff,
                                               n_valid, T1, T2, *e_blocks,
                                               twin=twin)
        e = e1 + ed + ex
    return diis_state, e, e - e_last, info


def ccsd_solve(t_fock_pq, dict_t_V, no, t_T1_0, t_T2_0, level_shift=0.0,
               delta_e=1e-8, max_iter=50, is_dcsd=False, is_diis=True,
               dim_space=6, ladder_all=None, twin=False,
               log_iterations=False):
    """CCSD fixed point, Jacobi + DIIS, T2 carried ``[i,j,a,b]``.

    Loop semantics of ``pymes_tpu.solver.ccsd.ccsd_solve_jit``: iterate
    while ``|dE| > delta_e and it <= max_iter`` (so up to ``max_iter + 1``
    iterations), ``e_hist[min(it, max_iter)] = e``.  With ``delta_e >= 0``
    the loop reads dE on the host once per iteration; with ``delta_e < 0``
    it runs to the cap with no host sync inside the loop.  The DIIS solve's
    ``info`` is checked once, after the loop.  ``twin=True`` runs K1, K4
    and the tail through their plain twins (on-card comparison).
    ``log_iterations`` prints E and dE each iteration (a host read of
    both).  The whole loop takes the amplitudes' type: f32 inputs run it
    in f32.

    ``t_T2_0`` is ``abij``-ordered.  Returns ``(e, T1, T2_abij, dE, n_iter,
    e_hist)`` with device tensors and ``n_iter`` a Python int.
    """
    no = int(no)
    if isinstance(dict_t_V.get("abcd"), Sharded):
        tensor_parallel.check_home(dict_t_V["abcd"], t_fock_pq.device)
    eps_i = torch.diagonal(t_fock_pq)[:no].contiguous()
    eps_a = torch.diagonal(t_fock_pq)[no:].contiguous()
    nv = eps_a.shape[0]
    T1 = t_T1_0.clone().contiguous()
    T2 = t_T2_0.permute(2, 3, 0, 1).contiguous()
    if ladder_all is not None:
        # the matrix-free branch's loop-invariant transpose, hoisted
        dict_t_V = {**dict_t_V,
                    "abij_t": dict_t_V["abij"].permute(2, 3, 0, 1)
                    .contiguous()}
    e_blocks = energy_blocks(t_fock_pq, dict_t_V, no)
    e_last = sum(ccsd_energy_ij(t_fock_pq[:no, no:], T1, T2,
                                dict_t_V["ijab"]))
    dE = torch.abs(e_last) + 1.0

    m = dim_space if is_diis else 1
    state = diis.init_state(m, nv * no + T2.numel(), T2.dtype,
                            device=T2.device)
    info = torch.zeros((), dtype=torch.int32, device=T2.device)
    e_hist = torch.full((max_iter + 1,), float("nan"), dtype=T2.dtype,
                        device=T2.device)
    it = 0
    while it <= max_iter:
        if delta_e >= 0:
            with span("cc.wait"):
                done = not float(torch.abs(dE)) > delta_e
            if done:
                break
        with span("cc.iter"):
            state, e, dE, info_it = ccsd_iteration(
                t_fock_pq, dict_t_V, no, T1, T2, eps_i, eps_a, level_shift,
                state, e_last, is_dcsd=is_dcsd, is_diis=is_diis,
                ladder_all=ladder_all, e_blocks=e_blocks, twin=twin)
            info = torch.maximum(info, info_it.abs())
            e_last = e
            e_hist[min(it, max_iter)] = e
            it += 1
            if log_iterations:
                print(f"    CCSD it {it}: E = {float(e):.14f}  "
                      f"dE = {float(dE):.3e}")

    if int(info) != 0:
        raise RuntimeError("DIIS bordered system singular during the solve")
    return e_last, T1, T2.permute(2, 3, 0, 1), dE, it, e_hist


class CCSD(ccd_mod.CCD):
    """Reference-API CCSD/DCSD solver on ``device`` (keyword-only; None:
    the card; ``pymes_tpu/solver/ccsd.py:738``, ``layout="ijab"``).
    ``is_non_canonical`` is accepted and ignored, as the JAX package does
    (the T1-dressed equations hold for any Fock matrix).

    ``solve(t_fock_pq, t_V_pqrs, level_shift=0, amps=None, sp=0,
    ladder=None, mixed_precision=False, contract_mode=None, layout=None,
    dress_precision=None, **kwargs)``, the JAX package's signature, returns
    ``{"ccsd e", "t1", "t2" (abij), "hole e", "particle e", "dE",
    "e history"}``; the precision modes are the module docstring's
    (``dress_precision`` None or "f64"; "f32" raises); ``sp``,
    ``contract_mode`` and ``layout`` are accepted and ignored, as in
    :meth:`CCD.solve <pymes_tpu_torch.solver.ccd.CCD.solve>`.
    ``t_V_pqrs`` is the full tensor or a dict of named blocks (optionally
    with ``"_ovvv_plans"``); ``ladder`` an all-bra BlockLadder for the
    matrix-free path; ``amps`` a pair (T1, T2 abij) to start from, whole
    or cut (``mesh.shard_amplitudes``).

    Blocks cut by ``mesh.shard_blocks`` (1-D or 2-D mesh) run the
    tensor-parallel iteration (:mod:`pymes_tpu_torch.parallel.
    tensor_parallel`): the blocks with three or four virtual slots stay
    cut and are contracted piece by piece (``abcd`` is dressed into new
    per-piece tiles; ``iabc`` and ``aibc``, which the dressing reads
    across the cut, are gathered once per solve onto each distinct device
    of the mesh); the others are gathered onto ``device``, which must be
    the home device of a cut ``abcd`` (its first piece's)."""

    def __init__(self, no, is_diis=True, delta_e=1e-8,
                 is_non_canonical=False, is_dcsd=False, *, device=None):
        super().__init__(no, delta_e=delta_e, is_dcd=is_dcsd,
                         is_diis=is_diis, device=device)

    def _dict_on_device(self, t_V_pqrs):
        if not isinstance(t_V_pqrs, dict):
            return part_2_body_int(self.no, self._on_device(t_V_pqrs))
        d = {k: (v if k.startswith("_") or tensor_parallel.is_cut_block(k, v)
                 else self._on_device(v)) for k, v in t_V_pqrs.items()}
        if isinstance(d.get("abcd"), Sharded):
            d["_abcd_dressing"] = tensor_parallel.dressing_operands(d)
        return d

    @traced("cc.solve")
    def solve(self, t_fock_pq, t_V_pqrs, level_shift=0.0, amps=None, sp=0,
              ladder=None, mixed_precision=False, contract_mode=None,
              layout=None, dress_precision=None, **kwargs):
        max_iter = int(kwargs.get("max_iter", self.max_iter))
        delta_e = float(kwargs.get("delta_e", self.delta_e))
        if dress_precision not in (None, "f64"):
            raise ValueError(f"dress_precision {dress_precision!r}: the port "
                             f"has the f64 dressing only (None or 'f64')")
        no = self.no
        t_fock_pq = self._on_device(t_fock_pq)
        dict_t_V = self._dict_on_device(t_V_pqrs)

        eps_i = torch.diagonal(t_fock_pq)[:no]
        eps_a = torch.diagonal(t_fock_pq)[no:]
        print_logging_info("ccsd.solve")
        print_logging_info("Using DCSD: ", self.is_dcd, level=1)
        print_logging_info("Using DIIS mixer: ", self.is_diis, level=1)

        with span("cc.guess"):
            e_mp2, t_T2 = mp2.solve(eps_i, eps_a, dict_t_V["ijab"],
                                    dict_t_V["abij"], level_shift)
        print_logging_info("MP2 energy = {:.12f}".format(float(e_mp2)),
                           level=1)
        t_T1 = torch.zeros((eps_a.shape[0], no), dtype=t_T2.dtype,
                           device=t_T2.device)
        if amps is not None:
            t_T1, t_T2 = (self._on_device(a) for a in amps)
        if mixed_precision and t_T2.dtype == torch.float64:
            f32 = cast_f32((t_fock_pq, dict_t_V, t_T1, t_T2, ladder))
            with full_f32_matmul():
                _, T1_32, T2_32, _, it32, _ = ccsd_solve(
                    *f32[:2], no, *f32[2:4], level_shift=level_shift,
                    delta_e=max(1e-5, delta_e), max_iter=max_iter,
                    is_dcsd=self.is_dcd, is_diis=self.is_diis,
                    dim_space=self.dim_space, ladder_all=f32[4])
            print_logging_info(
                "mixed precision: {} f32 iterations".format(it32), level=1)
            self.n_iterations_f32 = it32
            t_T1, t_T2 = T1_32.double(), T2_32.double()

        e, T1, T2, dE, n_iter, e_hist = ccsd_solve(
            t_fock_pq, dict_t_V, no, t_T1, t_T2, level_shift=level_shift,
            delta_e=delta_e, max_iter=max_iter, is_dcsd=self.is_dcd,
            is_diis=self.is_diis, dim_space=self.dim_space,
            ladder_all=ladder, log_iterations=self.log_iterations)
        if n_iter > max_iter:
            print_logging_info("A converged solution is not found!", level=1)
        print_logging_info(
            "CCSD correlation energy = {:.12f} ({} iterations)".format(
                float(e), n_iter), level=1)
        return {"ccsd e": float(e), "t1": T1, "t2": T2, "hole e": eps_i,
                "particle e": eps_a, "dE": float(dE),
                "e history": e_hist[:n_iter].cpu().numpy()}

    # reference-signature helpers (T2 abij-ordered, as in the JAX package)
    def get_T1_dressed_fock(self, t_fock_pq, t_T_ai, dict_t_V):
        return get_T1_dressed_fock(self._on_device(t_fock_pq),
                                   self._on_device(t_T_ai), dict_t_V,
                                   no=self.no, device=self.device)

    def get_T1_dressed_V(self, t_T_ai, dict_t_V, dict_t_V_dressed=None):
        keys = tuple(dict_t_V_dressed) if dict_t_V_dressed else None
        return get_T1_dressed_V(self._on_device(t_T_ai), dict_t_V, keys=keys,
                                device=self.device)

    def get_singles_residual(self, t_fock_pq, t_T_ai, t_T_abij, dict_t_V):
        return singles_residual_ij(t_fock_pq, t_T_ai,
                                   t_T_abij.permute(2, 3, 0, 1), dict_t_V)

    def get_doubles_residual(self, t_fock_pq, t_T_abij, dict_t_V_dressed):
        no = self.no
        V_ij = ccd_mod.blocks_ij_from(
            ccd_mod.blocks_from_dict(dict_t_V_dressed))
        R = ccd_mod.doubles_residual_ij(
            t_fock_pq[no:, no:], t_fock_pq[:no, :no],
            t_T_abij.permute(2, 3, 0, 1), V_ij, is_dcd=self.is_dcd)
        return R.permute(2, 3, 0, 1)

    def get_energy(self, t_fock_ia, t_T_ai, t_T_abij, t_V_ijab):
        return list(ccsd_energy_ij(t_fock_ia, t_T_ai,
                                   t_T_abij.permute(2, 3, 0, 1), t_V_ijab))
