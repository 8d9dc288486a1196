"""EOM-CCSD excited states (Davidson, non-Hermitian aware), abij layout.

Counterpart of ``pymes_tpu/solver/eom_ccsd.py``: the sigma builds (H̄·u
products) act on the T1-dressed Fock/integral blocks and the ground-state
T2 amplitudes in the closed-shell singlet formalism, through the
T2-dependent intermediates of :class:`HbarIntermediates` (built once per
solve).  Three kinds of operator run through the same functions: dense
blocks (``iabc``/``abic``/``abcd`` present), the matrix-free T1-dressed
ladder (``abcd_t1`` with an all-bra ``abcd_ladder``) and the matrix-free
"no-ovvv" UEG operator (no ``abcd`` and no ovvv-class block on the device:
the all-bra ladder plan and the OVVV gather plans under ``"_ovvv_plans"``,
optionally T1-dressed with ``abcd_t1`` and the bare blocks ``"_bare"``).
The port has this one sigma: the reference's term lists (``sigma_singles``,
``sigma_doubles``) are not carried, and the reference-name wrappers
``EOM_CCSD.update_singles`` / ``update_doubles`` build the intermediates
and call the factorised sigma on one trial vector.

The sigma of a batch of k trial vectors is one call
(:func:`_sigma_batched_hbar`): the GEMMs carry a leading batch axis (cuBLAS
DGEMMs on the card), the ladder on the trial doubles is ONE launch of
kernel K1 on the stacked operand, the three ovvv gathers of the trial
singles are one K4 launch each, and the P(ab,ij) symmetrisation is kernel
K5.  The fixed-shape Davidson keeps U and W = H̄U in (max_dim, N) device
buffers written in place; one step (:func:`_davidson_fused_step`) takes one
upload and one download, and its preconditioned residual pass is kernel K6.
The m×m eigenproblem, the QR of the Ritz rotation and the maximum-overlap
(MOM) matching stay in host numpy, exactly as in the JAX package.  On a
CPU tensor every kernel runs its plain twin.

``precision`` takes the JAX package's two pipelines
(``pymes_tpu/solver/eom_ccsd.py:803-810``, ``:962-1013``).  "f64" is the
JAX package's f64 path with ``root_tracking="guess"`` (MOM), which is what
its own f64 polish runs.  "mixed" first runs an f32 seed phase: a plain
solver on the f32 copy of f, the operator and T2 (``cast_f32``: the f64
leaves, the ladder plan through ``cast_plan``, the OVVV weights), MOM
tracking, at most 100 iterations to max(1e-4, ``e_epsilon``), its GEMMs at
full f32 (TF32 off) and its kernels in their f32 instantiations (K1, K4, K5
in the sigma, K6 in the residual pass); dead rows there are those below
``_F32_DEAD`` (3e-6), the f32 rounding floor.  Its Ritz vectors then seed
the f64 polish (``_seed``: U's first rows are the Q of their QR, and MOM
starts from R's columns), which converges to ``e_epsilon`` as the f64 path
does.  The mixed pipeline runs, as in the JAX package, only in the
fixed-shape solver, from no seed, on an f64 Fock, with the built-in
``_batched_sigma``; the tiny spaces of ``_solve_dynamic`` stay f64.  The
port's default stays "f64" (the JAX package's is "mixed"): which is faster
on the H100 is for the card's times to decide, as for the FEAST/RT engine,
whose f32 step cost 0.68-0.87 of the f64 one there.

Not ported: the contraction modes and Ozaki slices (``sliced``,
``preslice_sigma_hbar``), and the power-of-two padding of the trial batch
(it limited XLA compiles).
"""

import time
from typing import NamedTuple

import numpy as np
import torch

from pymes_tpu_torch.config import DTYPE, resolve_device
from pymes_tpu_torch.kernels import davidson, pair_sym
from pymes_tpu_torch.log import print_logging_info, print_title
from pymes_tpu_torch.ops import ueg_ladder
from pymes_tpu_torch.ops.ueg_ladder import BlockLadder
from pymes_tpu_torch.util.precision import cast_f32, full_f32_matmul

# dead-direction threshold of an orthogonalised residual row: f64, and f32
# (the f32 phase of the mixed pipeline: a residual orthogonalised down to
# the f32 rounding floor is noise, and normalising it poisons the subspace;
# pymes_tpu/solver/eom_ccsd.py:671-676)
_DEAD = 1e-10
_F32_DEAD = 3e-6
PRECISIONS = ("f64", "mixed")


def _dead(dtype):
    return _DEAD if dtype == torch.float64 else _F32_DEAD


class HbarIntermediates(NamedTuple):
    """T2-dependent pieces of H̄, contracted once per solve
    (``pymes_tpu/solver/eom_ccsd.py:42``).  Ring tensors are indexed
    ``X[l, d, a, i] = Σ_kc V T``."""

    A1: torch.Tensor      # (no, nv, nv, no): coefficient of u_dblj
    A2: torch.Tensor      # (no, nv, nv, no): coefficient of u_bdlj
    I3: torch.Tensor      # (no, nv, nv, no): coefficient of u_dbjl
    I4: torch.Tensor      # (no, nv, nv, no): coefficient of u_dbil (as ldaj)
    B_da: torch.Tensor    # (nv, nv)
    C_li: torch.Tensor    # (no, no)
    W_klij: torch.Tensor  # (no, no, no, no): T2-renormalised oooo block
    S_ca: torch.Tensor    # (nv, nv): singles u_ci dressing
    S_ki: torch.Tensor    # (no, no): singles u_ak dressing
    W_laji: torch.Tensor = None  # (no, nv, no, no): Σ_cd <la|cd> T_cdji,
    #   the (o,v) corner of the all-bra ladder on T2 (no-ovvv mode only)
    Y_libj: torch.Tensor = None   # the three ooov·T2 rings multiplying u1_al
    Y7_liaj: torch.Tensor = None  # V_klid·T_adkj (multiplies u1_bl)
    klij_sum: torch.Tensor = None  # V_klij + W_klij


def _no_ovvv(V):
    return V.get("iabc") is None


def _check_all_bra(W, no, nv):
    if W.shape[-4] != no + nv:
        raise ValueError("no-ovvv EOM mode needs an ALL-BRA ladder plan "
                         "(bra='all')")


def build_hbar(t_fock_pq, dict_t_V, t_T_abij, contract_mode="xla", *,
               twin=False):
    """Precompute the T2-dependent H̄ intermediates (once per solve).  In the
    no-ovvv mode ``W_laji`` comes from K1 on T2 (all-bra plan).
    ``contract_mode`` (the JAX package's Ozaki modes, exact f64) is
    accepted and ignored."""
    es = torch.einsum
    V = dict_t_V["ijab"]
    T = t_T_abij
    I1 = es("klcd,caki->ldai", V, T)
    I2 = es("klcd,acki->ldai", V, T)
    I3 = es("kldc,caki->ldai", V, T)
    I4 = es("kldc,acki->ldai", V, T)
    A1 = 4.0 * I1 - 2.0 * I2 - 2.0 * I3 + I4
    A2 = -2.0 * I1 + I2
    B_da = (-2.0 * es("klcd,cakl->da", V, T) + es("klcd,ackl->da", V, T))
    C_li = (-2.0 * es("klcd,cdki->li", V, T) + es("kldc,cdki->li", V, T))
    S_ca = (-2.0 * es("jkbc,bajk->ca", V, T) + es("jkbc,abjk->ca", V, T))
    S_ki = (-2.0 * es("jkbc,bcji->ki", V, T) + es("jkcb,bcji->ki", V, T))
    W_klij = es("klcd,cdij->klij", V, T)
    # ooov·T2 rings multiplying u1 in the doubles sigma (solve-invariant)
    Y2 = es("klci,cbkj->libj", dict_t_V["ijak"], T)
    Y6 = es("klic,cbkj->libj", dict_t_V["ijka"], T)
    Y8 = es("kldi,bdkj->libj", dict_t_V["ijak"], T)
    Y_libj = -2.0 * Y2 + Y6 + Y8
    Y7_liaj = es("klid,adkj->liaj", dict_t_V["ijka"], T)
    W_laji = None
    if _no_ovvv(dict_t_V) and dict_t_V.get("abcd_ladder") is not None:
        no, nv = T.shape[-1], T.shape[0]
        WT = ueg_ladder.ladder_apply(dict_t_V["abcd_ladder"], T, twin=twin)
        _check_all_bra(WT, no, nv)
        W_laji = WT[:no, no:].contiguous()
    return HbarIntermediates(A1=A1, A2=A2, I3=I3, I4=I4, B_da=B_da,
                             C_li=C_li, W_klij=W_klij, S_ca=S_ca,
                             S_ki=S_ki, W_laji=W_laji, Y_libj=Y_libj,
                             Y7_liaj=Y7_liaj,
                             klij_sum=dict_t_V["klij"] + W_klij)


def _ladders(dict_t_V, u1, u2, twin=False, doubles=True):
    """The ladder images one sigma needs, from ONE K1 launch on the batch
    (n, nv, nv, no, no): ``Wu`` of the trial doubles (the singles' corners
    in the no-ovvv mode and the doubles' ladder without ``abcd``) and, in
    the T1-dressed no-ovvv mode, ``WX`` of T1⊗u1 stacked under it.
    Returns (Wu, WX), each (n, n_bra, n_bra, no, no) or None."""
    V = dict_t_V
    plan = V.get("abcd_ladder")
    need_u = _no_ovvv(V) or (doubles and V.get("abcd") is None)
    if plan is None or not need_u:
        return None, None
    n = u2.shape[0]
    ops = [u2]
    with_x = doubles and _no_ovvv(V) and V.get("abcd_t1") is not None
    if with_x:
        ops.append(torch.einsum("ei,ncj->necij", V["abcd_t1"], u1))
    WB = ueg_ladder.ladder_apply(plan, torch.cat(ops) if with_x else u2,
                                 twin=twin)
    return WB[:n], (WB[n:] if with_x else None)


def _batch(u1, u2):
    single = u1.dim() == 2
    return (u1[None], u2[None], True) if single else (u1, u2, False)


def sigma_singles_hbar(t_fock_pq, dict_t_V, hbar, t_u_ai, t_u_abij,
                       t_T_abij, contract_mode="xla", *, Wu=None,
                       twin=False):
    """Singles block of H̄·u through the intermediates
    (``pymes_tpu/solver/eom_ccsd.py:120``).  ``t_u_ai`` (nv, no) and
    ``t_u_abij`` (nv, nv, no, no), or a batch of each with a leading axis;
    ``Wu`` is the batched all-bra ladder image of the trial doubles from
    :func:`_ladders` (computed here when the no-ovvv mode needs it and it
    is not given).  ``contract_mode`` as in :func:`build_hbar`."""
    es = torch.einsum
    u1, u2, single = _batch(t_u_ai, t_u_abij)
    no = u1.shape[-1]
    f = t_fock_pq
    V = dict_t_V
    T = t_T_abij
    f_ov = f[:no, no:]

    w = 2.0 * es("jb,nbaji->nai", f_ov, u2)
    w = w - es("ji,naj->nai", f[:no, :no], u1)
    w = w - es("jb,nabji->nai", f_ov, u2)
    w = w + es("ab,nbi->nai", f[no:, no:], u1)
    w = w + 2.0 * es("jabi,nbj->nai", V["iabj"], u1)
    w = w - es("jaib,nbj->nai", V["iajb"], u1)
    w = w - 2.0 * es("jkib,nabjk->nai", V["ijka"], u2)
    w = w + es("jkib,nbajk->nai", V["ijka"], u2)
    if not _no_ovvv(V):
        w = w + 2.0 * es("jabc,nbcji->nai", V["iabc"], u2)
        w = w - es("jacb,nbcji->nai", V["iabc"], u2)
    else:
        # <ja|bc> u_bcji = Wu[j,a,j,i]; <ja|cb> u_bcji = Wu[a,j,j,i]
        if Wu is None:
            Wu, _ = _ladders(V, u1, u2, twin=twin, doubles=False)
        _check_all_bra(Wu, no, u1.shape[1])
        w = w + 2.0 * es("njaji->nai", Wu[:, :no, no:])
        w = w - es("najji->nai", Wu[:, no:, :no])
        if V.get("abcd_t1") is not None:
            # T1-dressed: V̄_iabc = V_iabc − T1·V_oovv
            T1d = V["abcd_t1"]
            Y1 = es("jlbc,nbcji->nli", V["ijab"], u2)
            Y2 = es("jlcb,nbcji->nli", V["ijab"], u2)
            w = w - 2.0 * es("al,nli->nai", T1d, Y1)
            w = w + es("al,nli->nai", T1d, Y2)

    X_jb = (2.0 * es("jkbc,nck->njb", V["ijab"], u1)
            - es("jkcb,nck->njb", V["ijab"], u1))
    w = w + es("njb,baji->nai", X_jb, 2.0 * T)
    w = w - es("njb,abji->nai", X_jb, T)
    w = w + es("ca,nci->nai", hbar.S_ca, u1)
    w = w + es("ki,nak->nai", hbar.S_ki, u1)
    return w[0] if single else w


def sigma_doubles_hbar(t_fock_pq, dict_t_V, hbar, t_u_ai, t_u_abij,
                       t_T_abij, contract_mode="xla", sliced=None, *,
                       Wu=None, WX=None, twin=False):
    """Doubles block of H̄·u through the intermediates
    (``pymes_tpu/solver/eom_ccsd.py:180``), single or batched as
    :func:`sigma_singles_hbar`.  ``Wu``/``WX`` are the ladder images of
    :func:`_ladders` (computed here when needed and not given).  The
    P(ab,ij) symmetrisation runs through K5.  ``contract_mode`` and
    ``sliced`` (the JAX package's Ozaki modes and their preslices, exact
    f64) are accepted and ignored."""
    es = torch.einsum
    u1, u2, single = _batch(t_u_ai, t_u_abij)
    no = u1.shape[-1]
    nv = u1.shape[1]
    f = t_fock_pq
    V = dict_t_V
    T = t_T_abij
    Voovv = V["ijab"]
    if V.get("abcd") is None and Wu is None:
        Wu, WX = _ladders(V, u1, u2, twin=twin)

    # ---- terms linear in u1 (u1 contracted first) ----
    X1_ki = es("klid,ndl->nki", V["ijka"], u1)
    d = -2.0 * es("nki,abkj->nabij", X1_ki, T)
    Zf_ki = es("kd,ndi->nki", f[:no, no:], u1)
    d = d - es("nki,abkj->nabij", Zf_ki, T)
    Xf_ac = es("nal,lc->nac", u1, f[:no, no:])
    d = d - es("nac,cbij->nabij", Xf_ac, T)
    Q_klij = es("klid,ndj->nklij", V["ijka"], u1)
    d = d + es("nklij,abkl->nabij", Q_klij, T)
    d = d + es("libj,nal->nabij", hbar.Y_libj, u1)
    d = d + es("liaj,nbl->nabij", hbar.Y7_liaj, u1)
    d = d - es("nak,kbij->nabij", u1, V["iajk"])
    X9_ki = es("kldi,ndl->nki", V["ijak"], u1)
    d = d + es("nki,abkj->nabij", X9_ki, T)
    if not _no_ovvv(V):
        iabc = V["iabc"]
        A10 = es("kacd,ndi->nkaci", iabc, u1)
        d = d + 2.0 * es("nkaci,cbkj->nabij", A10, T)
        A11_ac = es("ladc,ndl->nac", iabc, u1)
        d = d + 2.0 * es("nac,cbij->nabij", A11_ac, T)
        d = d - es("nkaci,bckj->nabij", A10, T)
        A13 = es("kadc,ndi->nkaci", iabc, u1)
        d = d - es("nkaci,cbkj->nabij", A13, T)
        A14 = es("kadc,ndj->nkacj", iabc, u1)
        d = d - es("nkacj,bcki->nabij", A14, T)
        Y15 = es("lacd,cdji->laji", iabc, T)
        d = d - es("laji,nbl->nabij", Y15, u1)
        A16_ac = es("lacd,ndl->nac", iabc, u1)
        d = d - es("nac,cbij->nabij", A16_ac, T)
        d = d + es("abic,ncj->nabij", V["abic"], u1)
    else:
        # no-ovvv: every <ov|vv>/<vv|ov> term contracts its last virtual
        # index with u1 first, as a momentum gather (K4, one launch per
        # plan for the whole batch); the T2-coupled term is hbar.W_laji
        plans = V["_ovvv_plans"]
        X_ovv = ueg_ladder.ovvv_t1_apply(plans["ovv"], u1, twin=twin)
        X_vov = ueg_ladder.ovvv_t1_apply(plans["vov"], u1, twin=twin)
        X_vvo = ueg_ladder.ovvv_t1_apply(plans["vvo"], u1, twin=twin)
        d = d + 2.0 * es("nkaci,cbkj->nabij", X_ovv, T)
        d = d + 2.0 * es("nac,cbij->nabij", es("nalcl->nac", X_vov), T)
        d = d - es("nkaci,bckj->nabij", X_ovv, T)
        d = d - es("nakci,cbkj->nabij", X_vov, T)
        d = d - es("nakcj,bcki->nabij", X_vov, T)
        d = d - es("laji,nbl->nabij", hbar.W_laji, u1)
        d = d - es("nac,cbij->nabij", es("nlacl->nac", X_ovv), T)
        d = d + X_vvo
        if V.get("abcd_t1") is not None:
            # T1-dressed: the dressing-expansion corrections of every
            # ovvv-class term (7 cross terms through the bare small blocks
            # and the all-bra ladder of T1⊗u1, WX)
            T1d = V["abcd_t1"]
            Bb = V["_bare"]
            A1u = es("klcd,ndi->nklci", Voovv, u1)
            A2u = es("kldc,ndi->nklci", Voovv, u1)
            P1 = es("nklci,cbkj->nlibj", A1u, T)
            P2 = es("nklci,bckj->nlibj", A1u, T)
            P3 = es("nklci,cbkj->nlibj", A2u, T)
            P4 = es("nklcj,bcki->nljbi", A2u, T)
            d = d - 2.0 * es("al,nlibj->nabij", T1d, P1)
            d = d + es("al,nlibj->nabij", T1d, P2)
            d = d + es("al,nlibj->nabij", T1d, P3)
            d = d + es("al,nljbi->nabij", T1d, P4)
            s1 = es("lmdc,ndl->nmc", Voovv, u1)
            s2 = es("lmcd,ndl->nmc", Voovv, u1)
            d = d - 2.0 * es("nac,cbij->nabij",
                             es("am,nmc->nac", T1d, s1), T)
            d = d + es("nac,cbij->nabij", es("am,nmc->nac", T1d, s2), T)
            Q = es("am,lmji->alji", T1d, hbar.W_klij)
            d = d + es("alji,nbl->nabij", Q, u1)
            d = d - es("ak,nkbij->nabij", T1d,
                       es("kbic,ncj->nkbij", Bb["iajb"], u1))
            d = d - es("bl,nlaij->nabij", T1d,
                       es("laci,ncj->nlaij", Bb["iabj"], u1))
            d = d + WX[:, no:, no:]
            d = d + es("ak,bl,nklij->nabij", T1d, T1d,
                       es("klic,ncj->nklij", Bb["ijka"], u1))
            H1 = es("ei,nkbej->nkbij", T1d, X_ovv)
            d = d - es("ak,nkbij->nabij", T1d, H1)
            H2 = es("ei,nalej->nalij", T1d, X_vov)
            d = d - es("bl,nalij->nabij", T1d, H2)
            M8 = es("klec,ncj->nklej", Voovv, u1)
            d = d + es("ak,bl,ei,nklej->nabij", T1d, T1d, T1d, M8)

    # ---- terms linear in u2 through the intermediates ----
    d = d + es("ldai,ndblj->nabij", hbar.A1, u2)
    d = d + es("ldai,nbdlj->nabij", hbar.A2, u2)
    d = d + es("ldai,ndbjl->nabij", hbar.I3, u2)
    d = d + es("ldaj,ndbil->nabij", hbar.I4, u2)
    d = d + es("da,ndbij->nabij", hbar.B_da, u2)
    d = d + es("li,nablj->nabij", hbar.C_li, u2)
    Zc = (-2.0 * es("kldc,ndcil->nki", Voovv, u2)
          + es("kldc,ndcli->nki", Voovv, u2))
    d = d + es("nki,abkj->nabij", Zc, T)
    Pc = (-2.0 * es("lkcd,nadlk->nca", Voovv, u2)
          + es("lkcd,ndalk->nca", Voovv, u2))
    d = d + es("nca,cbij->nabij", Pc, T)
    d = d + 2.0 * es("kaci,ncbkj->nabij", V["iabj"], u2)
    d = d - es("ki,nabkj->nabij", f[:no, :no], u2)
    d = d + es("ac,ncbij->nabij", f[no:, no:], u2)
    d = d - es("kaic,ncbkj->nabij", V["iajb"], u2)
    d = d - es("kbic,nackj->nabij", V["iajb"], u2)
    d = d - es("kaci,nbckj->nabij", V["iabj"], u2)

    # P(ijab, jiba) symmetrisation: d + P(d), kernel K5
    d = pair_sym.pair_symmetrize(d, twin=twin)

    # ---- non-symmetrised terms ----
    d = d + es("klij,nabkl->nabij", hbar.klij_sum, u2)
    d = d + es("nklij,abkl->nabij",
               es("kldc,ndcij->nklij", Voovv, u2), T)
    if V.get("abcd") is not None:
        d = d + es("abcd,ncdij->nabij", V["abcd"], u2)
    elif V.get("abcd_t1") is not None:
        d = d + ueg_ladder.dressed_ladder_apply(V["abcd_ladder"],
                                                V["abcd_t1"], u2, no, W=Wu,
                                                twin=twin)
    else:
        W = Wu
        if W.shape[1] != nv:
            W = W[:, -nv:, -nv:]
        d = d + W
    return d[0] if single else d


def get_diag_singles(t_fock_pq, dict_t_V, t_T_abij):
    """Diagonal of the singles block of H̄ (``eom_ccsd.py:495``)."""
    es = torch.einsum
    no = t_T_abij.shape[-1]
    f = t_fock_pq
    V = dict_t_V
    T = t_T_abij
    d = (-f[:no, :no].diagonal()[None, :] + f[no:, no:].diagonal()[:, None])
    d = d + 2.0 * es("iaai->ai", V["iabj"])
    d = d - es("iaia->ai", V["iajb"])
    d = d + 4.0 * es("jiba,baji->ai", V["ijab"], T)
    d = d + -2.0 * es("jkba,abjk->a", V["ijab"], T)[:, None]
    d = d + -2.0 * es("jicb,bcji->i", V["ijab"], T)[None, :]
    d = d + -2.0 * es("jiba,abji->ai", V["ijab"], T)
    d = d + -2.0 * es("jiab,baji->ai", V["ijab"], T)
    d = d + es("jkab,abjk->a", V["ijab"], T)[:, None]
    d = d + es("jicb,bcji->i", V["ijab"], T)[None, :]
    d = d + es("jiab,abji->ai", V["ijab"], T)
    return d


def get_diag_doubles(t_fock_pq, dict_t_V, t_T_abij):
    """Diagonal of the doubles block of H̄ (``eom_ccsd.py:517``), with the
    zero-transfer weight ``w0`` of a matrix-free ladder plan."""
    es = torch.einsum
    no = t_T_abij.shape[-1]
    f = t_fock_pq
    V = dict_t_V
    T = t_T_abij
    Voovv = V["ijab"]

    ai = 4.0 * es("kica,caki->ai", Voovv, T)
    ai = ai - 2.0 * es("kica,caki->ai", Voovv, T)
    ai = ai + 2.0 * es("iaai->ai", V["iabj"])
    ai = ai - 2.0 * es("kica,acki->ai", Voovv, T)
    ai = ai - 2.0 * es("kiac,caki->ai", Voovv, T)
    ai = ai - es("iaia->ai", V["iajb"])
    ai = ai - es("ibib->bi", V["iajb"])
    ai = ai + es("kicb,acki->ai", Voovv, T)
    ai = ai - es("iaai->ai", V["iabj"])
    ai = ai + es("kiac,acki->ai", Voovv, T)

    a_only = -2.0 * es("klca,cakl->a", Voovv, T)
    a_only = a_only + es("klca,ackl->a", Voovv, T)
    i_only = -2.0 * es("kicd,cdki->i", Voovv, T)
    i_only = i_only + es("kidc,cdki->i", Voovv, T)

    d = ai[:, None, :, None]
    d = d + a_only[:, None, None, None] + i_only[None, None, :, None]
    d = d + (-f[:no, :no].diagonal()[None, None, :, None]
             + f[no:, no:].diagonal()[:, None, None, None])
    d = d - 2.0 * es("kjab,abkj->abj", Voovv, T)[:, :, None, :]
    d = d - 2.0 * es("ijcb,cbij->ij", Voovv, T)[None, None, :, :]
    d = d + es("kiab,abkj->abij", Voovv, T)
    d = d + es("kjac,caki->aij", Voovv, T)[:, None, :, :]
    d = d + es("kjac,ackj->aj", Voovv, T)[:, None, None, :]
    d = d + es("ijca,cbij->abij", Voovv, T)

    d = d + es("abij->baji", d)

    d = d + es("ijij->ij", V["klij"])[None, None, :, :]
    d = d + es("klab,abkl->ab", Voovv, T)[:, :, None, None]
    d = d + es("ijcd,cdij->ij", Voovv, T)[None, None, :, :]
    if V.get("abcd") is not None:
        d = d + es("abab->ab", V["abcd"])[:, :, None, None]
    elif V.get("abcd_ladder") is not None:
        # V_abab = w(q=0), the zero-transfer weight of the plan
        lad = V["abcd_ladder"]
        if not isinstance(lad, BlockLadder):
            raise TypeError(f"unsupported ladder plan {type(lad).__name__}")
        d = d + lad.w0
    return d


def _sigma_batched_hbar(f, V, hb, U1, U2, T, twin=False):
    """H̄·u for a batch of k trials ``U1`` (k, nv, no), ``U2`` (k, nv, nv,
    no, no) — B5 of the JAX package (``eom_ccsd.py:604``, a ``vmap``
    there): the ladder on the trial doubles (and T1⊗u1) is ONE K1 launch
    on the stacked operand, shared by the singles and the doubles."""
    Wu, WX = _ladders(V, U1, U2, twin=twin)
    return (sigma_singles_hbar(f, V, hb, U1, U2, T, Wu=Wu, twin=twin),
            sigma_doubles_hbar(f, V, hb, U1, U2, T, Wu=Wu, WX=WX,
                               twin=twin))


def _orthonormalize(U):
    """Modified Gram-Schmidt, two passes, on the rows of U (m, N); a row
    left with norm ≤ 1e-14 stays unnormalised (``eom_ccsd.py:617``)."""
    U = U.clone()
    for i in range(U.shape[0]):
        row = U[i]
        for _ in range(2):
            for j in range(i):
                row = row - torch.dot(U[j], row) * U[j]
        norm = torch.sqrt(torch.dot(row, row))
        U[i] = torch.where(norm > 1e-14, row / norm, row)
    return U


def _subspace_matrix(U, W):
    """B[j, l] = <u_j, w_l> (``eom_ccsd.py:639``)."""
    return U @ W.t()


def _rotate(U, v):
    """Linear combinations Σ_l U[l] v[l, n] → (n_out, N)
    (``eom_ccsd.py:648``)."""
    return v.t() @ U


def _orth_append(U, R):
    """Orthonormalise the k candidate rows R against all rows of U (its
    invalid rows are zero) by CGS2, then among themselves by an unrolled
    MGS; rows whose remaining norm is at most the dead-row threshold of
    U's type (1e-10, f32 3e-6) are zeroed.  Returns (R_orth, norms)
    (``eom_ccsd.py:657``)."""
    tiny = _dead(U.dtype)
    for _ in range(2):
        R = R - (R @ U.t()) @ U
    rows = []
    for i in range(R.shape[0]):
        row = R[i]
        for j in range(i):
            row = row - torch.dot(rows[j], row) * rows[j]
        norm = torch.sqrt(torch.dot(row, row))
        rows.append(torch.where(norm > tiny, row / norm,
                                torch.zeros_like(row)))
    R = torch.stack(rows)
    return R, torch.sqrt((R * R).sum(dim=1))


def _residual_precond(U, W, v_pad, e_new, diag_vec, m, twin=False):
    """Preconditioned residuals R_n = (W − e_n U)v_n / (e_n − H̄_ii) of the
    selected Ritz pairs from the first ``m`` rows of U and W: kernel K6
    (``eom_ccsd.py:697``)."""
    return davidson.davidson_residual(U, W, v_pad, e_new, diag_vec, m,
                                      twin=twin)


def _collapse_rotate(U, W, q_pad):
    """Restart in place: rotate U and W onto the orthonormalised Ritz span
    (``q_pad`` (max_dim, k), the host-QR'd rotation) and zero the other
    rows; W stays the sigma of U by linearity (``eom_ccsd.py:710``)."""
    k = q_pad.shape[1]
    Uc, Wc = _rotate(U, q_pad), _rotate(W, q_pad)
    U[:k], W[:k] = Uc, Wc
    U[k:], W[k:] = 0.0, 0.0


def _gather_append(U, rows, idx, m):
    """Write ``rows[idx]`` into U from row m on, in place
    (``eom_ccsd.py:724``)."""
    U[m:m + idx.shape[0]] = rows[idx]


def _davidson_fused_step(sigma, U, W, host_pack, diag_vec, m_res, m,
                         collapse=False, twin=False):
    """One Davidson iteration on the device (``eom_ccsd.py:732``):
    preconditioned residuals (K6) of the ``m_res`` valid rows → [the
    max_dim restart as a rotation] → CGS2 + MGS orthonormalisation →
    good-row compaction (stable argsort on the validity mask, no host
    round-trip) → ``sigma(rows, W, m)`` writes the new sigma rows into W →
    the projected matrix.  U and W are updated in place.

    ``host_pack`` is (2·max_dim + 1, k), rows ``[v_pad; e_new; q_pad]``,
    the one upload of the iteration; the return ``[norms_padded; B]``
    (max_dim + 1, max_dim) is its one download."""
    max_dim = U.shape[0]
    R = _residual_precond(U, W, host_pack[:max_dim], host_pack[max_dim],
                          diag_vec, m_res, twin=twin)
    if collapse:
        _collapse_rotate(U, W, host_pack[max_dim + 1:])
    R_orth, norms = _orth_append(U, R)
    if m + R.shape[0] > max_dim:
        raise ValueError("Davidson append past max_dim")
    idx = torch.argsort((norms <= _dead(U.dtype)).to(torch.int32),
                        stable=True)
    _gather_append(U, R_orth, idx, m)
    sigma(U[m:m + idx.shape[0]], W, m)
    out = U.new_zeros((max_dim + 1, max_dim))
    out[0, :norms.shape[0]] = norms
    out[1:] = _subspace_matrix(U, W)
    return out


class EOM_CCSD:
    """Davidson solver for the ``n_excit`` lowest excitation energies on
    ``device`` (``pymes_tpu/solver/eom_ccsd.py:778``).

    ``solve(t_fock_dressed_pq, dict_t_V_dressed, t_T_abij)`` returns the
    roots (numpy); the Ritz vectors land in ``u_singles``/``u_doubles``.
    ``root_tracking="guess"`` (the default) selects the Ritz pairs by
    maximum overlap with the previous iteration's (MOM); ``None`` selects
    the lowest real parts.  ``precision``: "f64" (the default) or "mixed"
    (an f32 seed phase, then the f64 polish; the module docstring), whose
    f32 phase leaves its iterations in ``n_iterations_f32``.
    ``twin=True`` runs K1, K4, K5 and K6 through their plain twins
    (on-card comparison)."""

    def __init__(self, no, n_excit=3, *, device=None):
        self.algo_name = "EOM-CCSD"
        self.no = int(no)
        self.device = resolve_device(device)
        self.n_excit = n_excit
        self.u_singles = []
        self.u_doubles = []
        self.e_excit = np.zeros(n_excit)
        # retained-subspace cap: the reference's 4·n_excit with a floor of
        # 16 — near-degenerate UEG pairs stall an 8-row subspace that
        # restarts every (max_dim − n_excit) iterations
        self.max_dim = max(n_excit * 4, 16)
        self.e_epsilon = 1e-8
        self.max_iter = 500
        self.root_tracking = "guess"
        self.precision = "f64"
        self.twin = False

    # --- packing helpers --------------------------------------------------
    @staticmethod
    def _pack(u1, u2):
        return np.concatenate([np.ravel(u1), np.ravel(u2)])

    def _unpack(self, vec, nv):
        no = self.no
        return (vec[: nv * no].reshape(nv, no),
                vec[nv * no:].reshape(nv, nv, no, no))

    def QR(self, u_singles, u_doubles):
        """Orthonormalise the packed subspace (host numpy)."""
        m = len(u_singles)
        nv = u_singles[0].shape[0]
        A = np.stack([self._pack(_np(u_singles[i]), _np(u_doubles[i]))
                      for i in range(m)], axis=1)
        Q, _ = np.linalg.qr(A)
        outs, outd = [], []
        for i in range(m):
            s, d = self._unpack(Q[:, i], nv)
            outs.append(s)
            outd.append(d)
        return outs, outd

    # --- reference-name sigma wrappers -----------------------------------
    def update_singles(self, t_fock_pq, dict_t_V, t_u_ai, t_u_abij,
                       t_T_abij):
        """Singles block of H̄·u for one trial vector, the reference class's
        API (``pymes_tpu/solver/eom_ccsd.py:844``) over the factorised
        sigma, on any operator form it takes (dense ``abcd``, ``abcd_t1``
        on the all-bra plan, the bare plan, no-ovvv).  Each call builds
        H̄'s intermediates anew (a K1 launch on a no-ovvv operator): no
        solver calls it, they all go through :meth:`_batched_sigma`."""
        hbar = build_hbar(t_fock_pq, dict_t_V, t_T_abij, twin=self.twin)
        return sigma_singles_hbar(t_fock_pq, dict_t_V, hbar, t_u_ai,
                                  t_u_abij, t_T_abij, twin=self.twin)

    def update_doubles(self, t_fock_pq, dict_t_V, t_u_ai, t_u_abij,
                       t_T_abij):
        """Doubles block of H̄·u for one trial vector, as
        :meth:`update_singles` (``pymes_tpu/solver/eom_ccsd.py:848``)."""
        hbar = build_hbar(t_fock_pq, dict_t_V, t_T_abij, twin=self.twin)
        return sigma_doubles_hbar(t_fock_pq, dict_t_V, hbar, t_u_ai,
                                  t_u_abij, t_T_abij, twin=self.twin)

    def get_diag_singles(self, t_fock_pq, dict_t_V, t_T_abij):
        return get_diag_singles(t_fock_pq, dict_t_V, t_T_abij)

    def get_diag_doubles(self, t_fock_pq, dict_t_V, t_T_abij):
        return get_diag_doubles(t_fock_pq, dict_t_V, t_T_abij)

    def _batched_sigma(self, f, dict_t_V, U1, U2, T2):
        """Batched H̄·u over trial vectors (k, nv, no) / (k, nv, nv, no,
        no); overridable (e.g. matrix-backed fake Hamiltonians in tests),
        and may then return numpy.  The intermediates are built once per
        (f, V, T2)."""
        hbar = self._hbar_of(f, dict_t_V, T2)
        return _sigma_batched_hbar(f, dict_t_V, hbar, U1, U2, T2,
                                   twin=self.twin)

    def _hbar_of(self, f, dict_t_V, T2):
        """H̄'s intermediates of the current operator, built at the first
        call after ``_hbar`` was reset (one K1 launch on the matrix-free
        UEG operator)."""
        if getattr(self, "_hbar", None) is None:
            self._hbar = build_hbar(f, dict_t_V, T2, twin=self.twin)
        return self._hbar

    # --- inputs -----------------------------------------------------------
    def _on_device(self, x, dtype=DTYPE):
        """``x`` (a tensor or numpy array) on the solver's device in
        ``dtype``: f64 for the inputs of :meth:`solve`, the operator's type
        for what the Davidson makes of it (f32 in the mixed pipeline's
        seed phase)."""
        if x is None or not isinstance(x, (torch.Tensor, np.ndarray)):
            return x
        if isinstance(x, np.ndarray) and not x.flags.writeable:
            x = np.array(x)
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def _operator_on_device(self, dict_t_V):
        out = {}
        for k, v in dict_t_V.items():
            if k == "_bare":
                out[k] = {kk: self._on_device(vv) for kk, vv in v.items()}
            else:
                out[k] = self._on_device(v)
        return out

    def _diag(self, f, dict_t_V, T2):
        return torch.cat([
            self._on_device(self.get_diag_singles(f, dict_t_V, T2),
                            f.dtype).ravel(),
            self._on_device(self.get_diag_doubles(f, dict_t_V, T2),
                            f.dtype).ravel()])

    # --- Davidson ---------------------------------------------------------
    @staticmethod
    def _realify_ritz(ev, vec, order):
        """Real basis of the selected Ritz space: a complex-conjugate pair
        contributes (Re v, Im v) — np.real alone would yield two identical
        columns (non-Hermitian TC H̄)."""
        v = np.real(vec[:, order]).copy()
        paired = set()
        for ii in range(len(order)):
            lam = ev[order[ii]]
            if abs(lam.imag) < 1e-12 or ii in paired:
                continue
            for jj in range(ii + 1, len(order)):
                if jj in paired:
                    continue
                if abs(ev[order[jj]] - np.conj(lam)) < 1e-10 * max(
                        1.0, abs(lam)):
                    v[:, jj] = np.imag(vec[:, order[ii]])
                    paired.update((ii, jj))
                    break
        return v

    def _guess_indices(self, eps_i, eps_a):
        """Unit-vector guesses at the lowest ε_a − ε_i gaps, spilling into
        the doubles block when n_excit exceeds the singles space."""
        nv, no = eps_a.shape[0], eps_i.shape[0]
        D_flat = (eps_a[:, None] - eps_i[None, :]).ravel()
        guess_inds = np.argsort(D_flat)[: self.n_excit]
        if len(guess_inds) < self.n_excit:
            D2 = (eps_a[:, None, None, None] + eps_a[None, :, None, None]
                  - eps_i[None, None, :, None]
                  - eps_i[None, None, None, :]).ravel()
            extra = np.argsort(D2)[: self.n_excit - len(guess_inds)]
            guess_inds = np.concatenate([guess_inds, nv * no + extra])
        return guess_inds

    def solve(self, t_fock_dressed_pq, dict_t_V_dressed, t_T_abij):
        """Davidson iteration with batched sigma builds: the fixed-shape
        solver, or the variable-shape loop for tiny spaces
        (N < max_dim + n_excit, e.g. H₂/STO-6G)."""
        if self.precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, not "
                             f"{self.precision!r}")
        f = self._on_device(t_fock_dressed_pq)
        V = self._operator_on_device(dict_t_V_dressed)
        T2 = self._on_device(t_T_abij).contiguous()
        no = self.no
        nv = T2.shape[0]
        N = nv * no + nv * nv * no * no
        if N < self.max_dim + self.n_excit:
            return self._solve_dynamic(f, V, T2)
        return self._solve_fixed(f, V, T2)

    def _sigma_rows(self, f, dict_t_V, rows, T2, W, at):
        """σ of the packed rows (k, N), written into W from row ``at``."""
        k = rows.shape[0]
        no, nv = self.no, T2.shape[0]
        n1 = nv * no
        W1, W2 = self._batched_sigma(f, dict_t_V, rows[:, :n1].reshape(
            k, nv, no), rows[:, n1:].reshape(k, nv, nv, no, no), T2)
        W[at:at + k, :n1] = self._on_device(W1, W.dtype).reshape(k, n1)
        W[at:at + k, n1:] = self._on_device(W2, W.dtype).reshape(k, -1)

    def _finish(self, U, v, nv, e, e_imag, converged, time_init):
        n1 = nv * self.no
        # the Ritz vectors in f64 from a basis of either type (the f32
        # phase's seeds are exact combinations of its f32 rows, as the
        # JAX package's f64 rotation of them promotes, eom_ccsd.py:1204)
        ritz = _rotate(U[: v.shape[0]].to(DTYPE), self._on_device(v))
        self.u_singles = [ritz[n, :n1].reshape(nv, self.no)
                          for n in range(ritz.shape[0])]
        self.u_doubles = [ritz[n, n1:].reshape(nv, nv, self.no, self.no)
                          for n in range(ritz.shape[0])]
        for r in range(self.n_excit):
            print_logging_info(
                "Excited state {:d} energy = {:.12f}".format(r, e[r]),
                level=2)
        print_logging_info("Excited states energies imaginary part = ",
                           e_imag, level=2)
        print_logging_info("EOM-CCSD finished in {:.3f} seconds".format(
            time.time() - time_init), level=1)
        if not converged:
            print_logging_info("EOM-CCSD did NOT converge!", level=1)
        return self.e_excit

    def _mixed(self, f, dict_t_V, T2):
        """The mixed pipeline (``eom_ccsd.py:973-1013``): the f32 seed
        phase on a plain solver, then the f64 polish seeded with its Ritz
        vectors, tracked from them."""
        pre = EOM_CCSD(self.no, device=self.device, n_excit=self.n_excit)
        pre.max_dim = self.max_dim
        # the f32 phase only supplies seeds: its tolerance sits above the
        # f32 Ritz-value noise floor and its iterations are capped (past
        # its rounding floor it wanders instead of converging)
        pre.max_iter = min(self.max_iter, 100)
        pre.e_epsilon = max(1e-4, self.e_epsilon)
        pre.root_tracking = "guess"
        pre.twin = self.twin
        with full_f32_matmul():
            pre._solve_fixed(*cast_f32((f, dict_t_V, T2)))
        self.n_iterations_f32 = pre.n_iterations
        seed = np.stack([np.concatenate([_np(s).ravel(), _np(d).ravel()])
                         for s, d in zip(pre.u_singles, pre.u_doubles)]
                        ).astype(np.float64)
        # the polish stays in the basin the tracked f32 phase found
        old_tracking = self.root_tracking
        self.root_tracking = old_tracking or "guess"
        try:
            return self._solve_fixed(f, dict_t_V, T2, _seed=seed)
        finally:
            self.root_tracking = old_tracking

    def _solve_fixed(self, f, dict_t_V, T2, _seed=None):
        """Fixed-shape incremental Davidson (``eom_ccsd.py:962``): U and
        W = H̄U in (max_dim, N) device buffers of the operator's type with
        a host-side valid-row count; sigma runs only on the newly appended
        rows; the max_dim restart rotates both buffers through the
        host-QR'd Ritz rotation.  ``_seed``: (n_excit, N) packed f64 start
        vectors (the mixed pipeline's polish); without it, with
        ``precision="mixed"``, an f64 Fock and the built-in sigma, the
        solve is the mixed pipeline."""
        if (self.precision == "mixed" and _seed is None
                and f.dtype == torch.float64
                and type(self)._batched_sigma is EOM_CCSD._batched_sigma):
            return self._mixed(f, dict_t_V, T2)
        print_title("EOM-CCSD Solver")
        time_init = time.time()
        no, n_excit, max_dim = self.no, self.n_excit, self.max_dim
        self._hbar = None
        diag_np = f.diagonal().cpu().numpy()
        eps_i, eps_a = diag_np[:no], diag_np[no:]
        nv = eps_a.shape[0]
        N = nv * no + nv * nv * no * no
        diag_vec = self._diag(f, dict_t_V, T2)

        U = torch.zeros((max_dim, N), dtype=diag_vec.dtype,
                        device=self.device)
        # maximum-overlap tracking (MOM): the Davidson basis only ever
        # appends orthonormal rows, so ⟨y_new, y_old⟩ = vec_newᴴ[:m_old]·
        # vec_old on the host, from subspace coordinates alone
        track = self.root_tracking == "guess"
        prev_ritz = None
        if _seed is not None:
            q, r_coef = np.linalg.qr(np.asarray(_seed, np.float64).T)
            U[:q.shape[1]] = self._on_device(q.T, U.dtype)
            if track:
                # seed_j = Σ_i q[:, i]·r[i, j]: its coordinates are r[:, j]
                prev_ritz = (r_coef[:, :n_excit]
                             / np.linalg.norm(r_coef[:, :n_excit], axis=0))
        else:
            guess_inds = self._guess_indices(eps_i, eps_a)
            U[torch.arange(n_excit), torch.as_tensor(guess_inds)] = 1.0
            if track:
                prev_ritz = np.eye(n_excit)
        m = n_excit
        W = torch.zeros_like(U)
        self._sigma_rows(f, dict_t_V, U[:n_excit], T2, W, 0)

        # every sigma goes through the _batched_sigma hook: without jit
        # there is no fused production step to select (the JAX package's
        # `type(self)._batched_sigma is EOM_CCSD._batched_sigma` test)
        def sigma(rows, W, at):
            self._sigma_rows(f, dict_t_V, rows, T2, W, at)

        self.e_excit = np.zeros(n_excit)
        e = np.zeros(n_excit)
        e_imag = np.zeros(n_excit)
        v_pad = np.zeros((max_dim, n_excit))
        B_full = _subspace_matrix(U, W).cpu().numpy()
        converged = False
        for it in range(self.max_iter):
            ev, vec = np.linalg.eig(B_full[:m, :m])
            if track:
                # greedy one-to-one matching of the subspace eigvecs with
                # the previous tracked Ritz vectors (zero-padded)
                mp = prev_ritz.shape[0]
                O = np.abs(vec[:mp].conj().T @ prev_ritz) ** 2
                O = O / np.maximum((np.abs(vec) ** 2).sum(axis=0),
                                   1e-300)[:, None]
                sel = np.empty(n_excit, dtype=int)
                for _ in range(n_excit):
                    k, j = np.unravel_index(np.argmax(O), O.shape)
                    sel[j] = k
                    O[k, :] = -1.0
                    O[:, j] = -1.0
                order = sel[np.argsort(ev[sel])]
                prev_ritz = vec[:, order]
            else:
                order = np.argsort(ev)[: n_excit]
            e_new = np.real(ev[order])
            e_imag = np.imag(ev[order])
            v = self._realify_ritz(ev, vec, order)
            v_pad = np.zeros((max_dim, n_excit))
            v_pad[:m] = v

            diff_e_norm = np.linalg.norm(self.e_excit - e_new)
            self.e_excit = e_new
            e = e_new
            if it > 0 and diff_e_norm < self.e_epsilon:
                print_logging_info("Iterative solver converged.", level=1)
                converged = True
                break

            collapse = m + n_excit > max_dim
            host_pack = np.zeros((2 * max_dim + 1, n_excit))
            host_pack[:max_dim] = v_pad
            host_pack[max_dim] = e_new
            m_res = m
            if collapse:
                q = np.linalg.qr(v)[0]
                host_pack[max_dim + 1: max_dim + 1 + m] = q
                if track:
                    # tracked states live in span(v) = span(q)
                    prev_ritz = q.T @ prev_ritz
                m = n_excit
            out = _davidson_fused_step(
                sigma, U, W, self._on_device(host_pack, U.dtype), diag_vec,
                m_res, m, collapse=collapse, twin=self.twin)
            out_np = out.cpu().numpy()
            if collapse:
                # the Ritz rotation addresses the restarted subspace:
                # x_n = Σ_j (qᵀv)[j,n] U_new[j]
                v_pad = np.zeros((max_dim, n_excit))
                v_pad[:n_excit] = q.T @ v
            k_good = int((out_np[0, :n_excit] > _dead(U.dtype)).sum())
            if k_good == 0:
                print_logging_info("Residuals exhausted — converged.",
                                   level=1)
                converged = True
                break
            m += k_good
            B_full = out_np[1: 1 + max_dim]
            print_logging_info("Iteration = ", it, level=1)
            print_logging_info("Norm of energy difference = ", diff_e_norm,
                               level=2)

        self.n_iterations = it + 1
        return self._finish(U, v_pad, nv, e, e_imag, converged, time_init)

    def _solve_dynamic(self, f, dict_t_V, T2):
        """Variable-shape Davidson loop for tiny excitation spaces
        (``eom_ccsd.py:1235``)."""
        print_title("EOM-CCSD Solver")
        time_init = time.time()
        no, n_excit = self.no, self.n_excit
        self._hbar = None
        diag_np = f.diagonal().cpu().numpy()
        eps_i, eps_a = diag_np[:no], diag_np[no:]
        nv = eps_a.shape[0]
        guess_inds = self._guess_indices(eps_i, eps_a)
        diag_vec = self._diag(f, dict_t_V, T2)

        n1 = nv * no
        N = n1 + nv * nv * no * no
        U = torch.zeros((n_excit, N), dtype=DTYPE, device=self.device)
        U[torch.arange(n_excit), torch.as_tensor(guess_inds)] = 1.0

        e = np.zeros(n_excit)
        e_imag = np.zeros(n_excit)
        v = np.eye(n_excit)
        # the subspace never exceeds the space dimension (past it the
        # orthonormalisation yields null rows with zero Ritz values)
        max_dim = min(self.max_dim, N)
        converged = False
        for it in range(self.max_iter):
            U = _orthonormalize(U)
            # drop null rows (an exactly converged trial's zero residual)
            row_norms = (U * U).sum(dim=1).cpu().numpy()
            if (row_norms < 1e-20).any():
                U = U[torch.as_tensor(np.nonzero(row_norms >= 1e-20)[0])]
            if U.shape[0] < n_excit:
                # top the space back up to n_excit rows with random
                # orthogonalised directions
                rng = np.random.default_rng(it)
                extra = rng.standard_normal((n_excit - U.shape[0], N))
                extra /= np.linalg.norm(extra, axis=1, keepdims=True)
                U = _orthonormalize(torch.cat([U, self._on_device(extra)]))
            m = U.shape[0]
            W = torch.empty_like(U)
            self._sigma_rows(f, dict_t_V, U, T2, W, 0)
            B = _subspace_matrix(U, W).cpu().numpy()

            ev, vec = np.linalg.eig(B)
            order = np.argsort(ev)[: n_excit]
            e_new = np.real(ev[order])
            e_imag = np.imag(ev[order])
            v = self._realify_ritz(ev, vec, order)

            if m >= max_dim:
                # collapse to the current Ritz vectors
                U = _rotate(U, self._on_device(v))
                v = np.eye(n_excit)
                if m >= N:
                    # the subspace spans the full excitation space: the
                    # projected values are exact
                    self.e_excit = e_new
                    e = e_new
                    print_logging_info("Full space spanned — exact.",
                                       level=1)
                    converged = True
                    break
                continue

            # residuals with the per-component H̄-diagonal preconditioner
            diff_e_norm = np.linalg.norm(self.e_excit - e_new)
            R = _residual_precond(U, W, self._on_device(v),
                                  self._on_device(e_new), diag_vec, m,
                                  twin=self.twin)
            n_add = min(n_excit, max_dim - m)
            U = torch.cat([U, R[:n_add]])
            self.e_excit = e_new
            e = e_new
            if diff_e_norm < self.e_epsilon:
                print_logging_info("Iterative solver converged.", level=1)
                converged = True
                break
            print_logging_info("Iteration = ", it, level=1)
            print_logging_info("Norm of energy difference = ", diff_e_norm,
                               level=2)

        self.n_iterations = it + 1
        return self._finish(U, v, nv, e, e_imag, converged, time_init)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class PackedSigma:
    """H̄ of one (f, V, T2) on ``solver``'s device as a matvec over packed
    host vectors ``[u1 | u2]``: how the generic FEAST kernel
    (:mod:`pymes_tpu_torch.solver.feast_kernel`) reaches the card.

    A real vector is one row and a complex one its (Re, Im) pair of rows
    (H̄ is real): one upload, ONE batched sigma through ``solver``'s
    ``_batched_sigma`` hook (on the no-ovvv UEG operator: K1 once, K4 three
    times and K5 once), one download.  The H̄ intermediates are built at the
    first sigma (one more K1 on that operator).  It also has the PySCF EOM
    interface shape (``vector_size``/``get_diag``/``make_imds``/``matvec``)
    that the adapters of :mod:`pymes_tpu_torch.solver.feast_eom_rccsd`
    drive."""

    def __init__(self, solver, t_fock_pq, dict_t_V, t_T_abij):
        self.solver = solver
        self.f = solver._on_device(t_fock_pq)
        self.V = solver._operator_on_device(dict_t_V)
        self.T2 = solver._on_device(t_T_abij).contiguous()
        solver._hbar = None
        self.nv, self.no = self.T2.shape[0], self.T2.shape[-1]
        self.diag = _np(solver._diag(self.f, self.V, self.T2))

    def matvec(self, x, imds=None):
        """H̄·x of one packed host vector (real or complex); ``imds`` is
        PySCF's argument, unused."""
        x = np.asarray(x)
        rows = np.stack([x.real, x.imag]) if np.iscomplexobj(x) else x[None]
        s, nv, no = self.solver, self.nv, self.no
        R = s._on_device(rows)
        k, n1 = R.shape[0], nv * no
        W1, W2 = s._batched_sigma(
            self.f, self.V, R[:, :n1].reshape(k, nv, no),
            R[:, n1:].reshape(k, nv, nv, no, no), self.T2)
        W = _np(torch.cat([s._on_device(W1).reshape(k, n1),
                           s._on_device(W2).reshape(k, -1)], dim=1))
        return W[0] + 1j * W[1] if k == 2 else W[0]

    def vector_size(self):
        return self.diag.shape[0]

    def get_diag(self):
        return self.diag, None

    def make_imds(self):
        return None
