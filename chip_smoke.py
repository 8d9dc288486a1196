#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pymes_tpu_torch``) on one GPU.

Drives the port's main paths through its own kernels:

* set-up — the UEG integral lists of nP=57 and nP=219 scattered into the
  named o/v blocks on the card through K10, counted as a path of its own;
* CCD — UEG 14 electrons, rs = 0.5: integrals → named o/v blocks on the
  card → HF orbital energies → momentum-sector ladder plan → MP2 guess →
  matrix-free CCD to |dE| < 1e-8, at cutoff 5 (nP=57) and cutoff 14
  (nP=219);
* dense CCSD — LiH/3-21G, H₂/STO-6G, and the transcorrelated TC-LiH and
  TC-H₂ (FCIDUMP ``.tc`` + TCDUMP through the port's readers and
  contractions), each against its oracle;
* matrix-free CCSD at nP=219 — all-bra ladder plan + OVVV gather plans, no
  ``abcd`` and no ovvv-class block on the card: the canonical Fock (T1 ≡ 0,
  so E equals the CCD energy) and the seeded non-canonical Fock (T1 ≠ 0,
  against the JAX package's energy for the same system);
* EOM-CCSD — the matrix-free no-ovvv operator (all-bra ladder, OVVV plans,
  no ``abcd``/ovvv block), n_excit=2, max_dim=16, f64 with MOM root
  tracking from unit-vector guesses: nP=57 and nP=219 on the CCD
  amplitudes of phase 3/4, nP=219 on the canonical CCSD amplitudes of
  phase 7, each against the JAX package's roots and iteration count; and
  LiH/3-21G on the dressed CCSD operator against its oracle;
* FEAST-EOM-CCSD — the nP=57 window of ``probe_r5_feast57b`` (16 nodes ×
  4 trials as 64 lanes of f64 GMRES(120)) on the no-ovvv operator and the
  CCD amplitudes, against the JAX Davidson level; LiH/3-21G against its
  oracle;
* RT-EOM-CCSD — nP=123 (cutoff 10): the port's Davidson, then 3 CIF steps
  (32 nodes as lanes of GMRES(20)) seeded with its Ritz vector, each
  step's phase energy against the root;
* ring CCD — the dense ``abcd`` scattered on the card and cut on its a axis
  over a mesh that lists the one card P times (``make_mesh(P,
  devices=["cuda:0"] * P)``, the counterpart of the JAX package's virtual
  devices): the ring-accumulated ladder at nP=57 (5 shards) and nP=219
  (4 shards, 16.2 GB of ``abcd``), every shard, step and copy at full
  width;
* sector-sharded matrix-free CCD and CCSD at nP=219 — the virtual and the
  all-bra plans built with ``pad_sectors=4`` and cut over 4 shards of the
  card (one K1 launch per shard), CCD and the seeded non-canonical CCSD;
* the transcorrelated UEG at nP=219 (gaskell correlator) — non-hermitian
  (``is_only_2b``) matrix-free CCD on the virtual plan, whose sector blocks
  carry the non-hermitian term, and hermitian-TC (``is_only_hermi_2b``)
  matrix-free CCSD on the all-bra plan and TC OVVV plans with the seeded
  non-canonical Fock, each against the JAX package's energy;
* drCCD — nP=57 on the dense blocks, against the JAX package's energy;
* the utilities — solvers built through ``configs`` (on the card by
  default), a checkpointed and resumed mf-CCSD, the twist-averaged mf-CCD
  over the irreducible twists of the 3³ mesh, the structure factor, the
  roofline line, the three examples and the observability helpers;
* the generic FEAST kernel — ``solver/feast_kernel.py`` (host GCROT
  solves) over the card's sigma through ``eom_ccsd.PackedSigma`` (one
  batched sigma a matvec) in the nP=57 window, one CIF step, and the
  PySCF-shaped adapters of ``solver/feast_eom_rccsd.py`` over LiH;
* the FEAST node fan-out — the nP=57 window with its contour nodes over
  ``node_mesh(P, devices=["cuda:0"] * P)``, P = 2 and 4;
* the native FCIDUMP/TCDUMP record parser (C++, ``_native.py``);
* tensor-parallel dense CCD and CCSD — every block scattered on the card
  and cut by ``mesh.shard_blocks`` over 4 shards and 2 x 2 of the card
  (``abcd`` and the ov³ blocks stay cut, no v⁴ block is gathered): CCD
  and the seeded non-canonical CCSD at nP=219, LiH CCSD on 3 and 3 x 3;
* the FEAST/RT mixed-precision engine (``ls_precision="mixed"``, the JAX
  package's default): FEAST nP=57 and RT nP=123 with f32 Krylov solves
  (the f32 kernels) inside f64 iterative refinement;
* the ground-state and Davidson precision modes: the mixed-precision EOM
  Davidson (``precision="mixed"``, the JAX package's default: an f32 seed
  phase, then the f64 polish) at nP=57, nP=219 and on LiH, the mixed CCD
  (``mixed_precision=True``) at nP=57 and nP=219, the mixed CCSD on LiH
  and the nP=219 non-canonical mf-CCSD.

Kernels: K1 ``block_ladder`` (CUDA C++ on the f64 tensor cores, built with
nvcc for sm_90a at first use), K4 ``ovvv_gather`` and its fused trace
``ovvv_gather_diag``, K5 ``pair_symmetrize``, K7 ``arnoldi_cgs2`` (the
CGS2 projection and the fused Krylov combine), K9 ``ring_step``, and the
tail passes K2 ``ccd_jacobi_diis``, K3 ``ccd_mix_energy``, K2′
``ccsd_jacobi_diis`` and K3′ ``ccsd_mix_energy`` (one source,
``csrc/cc_tail.cu``: CCD is its case without a T1 segment) (CUDA C++,
built with K1); K6 ``davidson_residual`` and K8 ``shifted_precond``
(Triton); and the f32 kernels ``block_ladder_f32`` (CUDA C++, pipelined
FFMA on the CUDA cores), ``ovvv_gather_f32`` (CUDA C++, its own gather),
``pair_symmetrize_f32``,
``arnoldi_cgs2_f32`` (CUDA C++) and ``shifted_precond_f32`` (Triton) of
the mixed-precision engine, and those of the precision modes:
``davidson_residual_f32`` in Triton, ``ccd_jacobi_diis_f32``,
``ccd_mix_energy_f32``, ``ccsd_jacobi_diis_f32``, ``ccsd_mix_energy_f32``
and ``ovvv_gather_diag_f32`` in CUDA C++; and K10 ``block_scatter``
(CUDA C++), the set-up scatter of a sparse integral list into the named
blocks.

Phases: (0) card and versions; (1) kernel builds, then the set-up path
(the nP=57 and nP=219 blocks, K10 launched in its counted window); (2)
each kernel against
its plain twin on the card at the main paths' shapes (K2′/K3′ at nP=219
and at each molecule's; K5 at the CCD and the EOM shapes, K6 and the
batched K1/K4 entries at the nP=219 EOM shapes), seeded inputs, bound
max|kernel − twin| ≤ 1e-12·max|twin| (both f64, only the summation order
differs; K4's gather is one multiply an element and K5 sums in the twin's
order: both must equal their twins bit for bit); (3, 4) the converged CCD
solves; (6) the dense molecular CCSD
solves; (7) the matrix-free CCSD solves; (9) the EOM solves (the LiH
ground state they dress is solved before) — for each path the launch
counts are reset just before and read just after, and each EOM solve's
launches must match its count of sigma calls exactly; (5, 8, 10)
timing: kernel vs twin per call, ms/iteration of fixed-61-iteration CCD and
CCSD solves (min of 5) and of 8 Davidson iterations at nP=219, through the
kernels and through the twins, K5 beside one ``torch.add`` of X and its
strided partner, K1 also at the mf-CCSD stacked and EOM batch widths
(N = 2 no²) and the FEAST nP=57 lane batch (N = 128 no²), each held to
its twin first and timed with its bound (K5 is held bit for bit at the
FEAST sigma's 2·64-lane operand too), and K1 and K5 also on the card alone (``torch.profiler``: their
per-call time can be the host's); K4 bit for bit and per call (also on
the card alone) at the widths its callers give it: the CCSD dressing (7
columns) and the EOM batch (14) at nP=219, and the FEAST nP=57 (896) and
RT nP=123 (448) lane batches of phase 11, its fused trace at nP=219; the
tails K2/K3 and K2′/K3′, f64 and f32, on the card alone at nP=219 (every
device operation of a call, the per-call times of phases 5, 8 and 25
beside them); the
set-up scatter of the nP=219 blocks (B8): K10 bit for bit against its
twin, both per call (twin, kernel, kernel, twin), the upload alone
(int16-packed and pinned, as K10 reads it, and the int64 list as given),
the zero fills + K10 and K10 alone on the card, its bound; then one block
past 2³¹ elements, ``sparse_to_dense`` at nP=219 (18.40 GB) read back
entry by entry with its nonzero count matched, per call beside one
``index_put_``; (11) K7/K8 against their twins
(K7's projection and fused combine also rerun bit for bit) and per call at
the FEAST nP=57 and RT nP=123 lane shapes, the fused combine beside one
batched ``torch.baddbmm``; (12) FEAST nP=57,
(13) RT nP=123 (its CCD and Davidson run before the counted window) and
(14) FEAST LiH, each window's launches held exactly to what its solves
did; then ms per Arnoldi step of one GMRES cycle over all lanes (kernels
and twins) and the walls per FEAST iteration and RT step; (15) K9
against its twin at the nP=57 (5 shards) and nP=219 (4 shards) ring
shapes, every panel offset and an odd (unaligned) one, ijab and abij
forms, and at edge shapes (M, N, K off the tiles, odd offsets and row
strides, one split and several, reruns bit-equal), then per call beside
its twin and ``torch.addmm`` at both ring shapes; (16) ring CCD at nP=57
and nP=219 to |dE| < 1e-8 against the JAX package (and the oracle), in
the matrix-free iteration count, K9 launched exactly P² times per
residual, the peak device memory,
then ms per iteration of the fixed-61-iteration ring CCD at nP=219
(kernels and twins, min of 5); (17) the sector-sharded K1 bit-equal to K1
on the padded and the unpadded plans, the sharded apply per call beside K1
on the whole plan, then sector-sharded matrix-free CCD and non-canonical
CCSD at nP=219 against the JAX package, K1 launched 4 times per
iteration; (18) the TC UEG at nP=219: host set-up in one thread pool,
K1 against its twin on the non-hermitian virtual and the hermitian all-bra
TC plans, K4 bit for bit on the TC OVVV plans, the non-hermitian mf-CCD
(one K1, K2, K3 and K5 launch an iteration) within 1e-9 of the JAX
package, the 16.2 GB TC ``abcd`` scattered for 6 dense iterations whose
energies must lie within 1e-10 of the matrix-free ones, the hermitian-TC
mf-CCSD (4 K4 gathers and 2 traces an iteration) and drCCD at nP=57 (one
K2 and one K3 an iteration) within 1e-9 of the JAX package, then ms per
iteration of the fixed-61-iteration TC mf-CCD (kernels and twins) and K1
and K4 per call on the TC plans; (19) the utilities slice: the nP=219 model
and CCD solver built through ``configs`` (the solver with no device
argument, so on the card) and its mf-CCD within 1e-9 of the JAX package
(one K1, K2, K3 and K5 launch an iteration), the seeded non-canonical
mf-CCSD stopped after 3 iterations, checkpointed, loaded (T1, T2
bit-equal) and resumed to |dE| < 1e-10 within 1e-9 of the JAX package (4
K4 gathers, 2 traces and one K1, K2', K3' and K5 an iteration), the mf-CCD
at the four irreducible twists of the 3³ mesh (each within 1e-9 of
``tools/pin_twist_jax.py``'s JAX energy in its iteration count, the
weighted mean within 1e-9), S(q) and g(r) of the Γ T2 on the card against
the CPU (1e-12 relative), the achieved f64 TFLOP/s of phase 5's wall of
the fixed-61-iteration mf-CCD (``util/flops.py``, ``util/roofline.py``),
the three examples against the JAX package's, and last, after every timed
wall, a ``RunRecord`` line per solve of the phase read back and a
``profile`` of three fixed CCD iterations whose trace must hold card
kernels.  Phases 20-22 run after phase 14's timing: (20) the port's
Davidson at nP=57 with 6 roots (its in-window level and the roots beside
the window) and on LiH, outside the counted window; then ``feast_kernel.
feast`` over the nP=57 card sigma (capped cycles and GCROT iterations,
``GENERIC57``): each in-window root within 1e-6 of the Davidson roots in
the window and of phase 12's FEAST roots; one ``rt_step`` from the
Davidson vector (phase energy within 1e-6 of the root, norm within 1e-8
of 1); ``FEAST_EOMEESinglet`` and ``CIFRT_EOMEESinglet`` over the LiH card
sigma against the Davidson roots (1e-6); the window's launches exactly K1
= nP=57 matvecs + 1, K4 = 3 × those, K5 = all matvecs; the matvec count,
wall and ms per matvec of each; (21) phase 12's FEAST rerun with its
nodes over 2 and 4 shares of the card: roots within 1e-10 of phase 12's
in its iterations, 64 / P lanes a chunk, K7/K8 exactly as the chunks
imply, walls per iteration and peak memory beside phase 12's; (22) the
native parser ran for every dump read, bit-equal to the numpy parse on
every dump of ``tests/data`` and on 1 M records with ``D`` exponents,
both parse times.  Phase 23 runs after phase 17: (23) the nP=219
``abcd`` scattered (16.16 GB) and the dense CCD through the gathering
path (``Sharded.gather``, then the dense solve) and on 4 shards and 2 x 2
(|dE| < 1e-8 within 1e-9 of the JAX package in the matrix-free CCD's
iterations, one K2, K3 and K5 an iteration, the cut solves' peak memory
above the phase's start below ``abcd`` + 25 %), the non-canonical dense
CCSD on both (|dE| < 1e-10 within 1e-9 of the JAX package, one K2′, K3′
and K5 an iteration; the unsharded dense CCSD where it fits, else a line
that says so) and LiH CCSD on 3 and 3 x 3 (1e-8 of the oracle, 1e-10 of
phase 6), with ms per iteration and peak memory of each solve.  Phase 24
runs after phase 14's timing, before phase 20: (24) the f32 kernels
against their f32 twins at the FEAST nP=57 and RT nP=123 lane shapes
(max relative error ≤ 1e-5; K4 and K5 bit for bit) and per call beside
their twins, their f32 bounds, ``torch.add`` (K5) and ``torch.baddbmm``
(K7's combine) in f32 (f32 K7 with the L2 flushed before each call); f32
K7's projection of all lanes at each m of K7_F32_SWEEP against its twin
and per call with the L2 flushed beside its three-pass floor and
once-read bound, and one call with the lanes at uneven m on both sides of
16 against the twin and rerun bit for bit; then phase 12's window and phase 13's three steps
with ``ls_precision="mixed"`` (up to MIXED_REFINE_MAX refinement passes
a chunk) in one counted window: the in-window roots within 1e-7 of the
JAX level and of phase 12's, the phase energies within 1e-7 of the root
and of phase 13's at unit norm, every honest residual at ``ls_conv_tol``
(1e-10), the matmul settings inside the engine ("highest", TF32 off) and
after it, the refinement passes per chunk, walls beside phase 12/13's,
the Krylov bytes a lane and the peak memory; the launches exactly as the
solves imply (f32 K1, K5 and K8 apply one per f32 sigma, f32 K4 three,
f32 K7 per Arnoldi step and cycle end, f32 K8 Mb and f64 sigma + K8
residual per refinement pass); then ms per Arnoldi step of the f32
solves (kernels and twins) beside phase 12/13's f64.  Phase 25 runs
right after phase 24: (25) the f32 kernels of the precision modes (K6,
K2/K3, K2′/K3′, K4's fused trace) against their f32 twins at the nP=219
shapes (max relative error ≤ F32_REL) and per call beside their twins
with their bounds; f32 K1 at N = no² (the nP=219 virtual plan) and
2 no² (all-bra) and f32 K4 at 7 and 14 columns against their f32 twins
(K1 within F32_REL and a rerun bit for bit, K4 bit for bit), then per
call and on the card alone beside the f64 kernels at the same widths,
each with its bound and its share of it; the converged EOM roots at nP=57
and nP=219 (the f64 Davidson to |dE| < 1e-12, within 1e-9 of the JAX
package's converged roots: the JAX pins, stopped at |dE| < 1e-8, lie up
to a few 1e-8 from them); then three counted windows:
the mixed EOM at nP=57 and nP=219 on the CCD amplitudes (roots within
1e-8 of the converged ones and of the JAX package's converged roots, and
of its pin within 1e-8 plus the pin's own distance from the converged
roots, itself at most 5e-8) and on LiH (1e-7 of the oracle), each
solve's sigmas
counted by type through the wrapped ``_sigma_batched_hbar`` (each must run
an f32 phase; launches exactly as :func:`check_eom_launches` per phase),
the f32-phase and polish iterations beside ``tools/pin_mixed_jax.py``'s
JAX run at nP=57; the mixed CCD at nP=57 and nP=219 (1e-8 of the JAX
package's f64 energy, nP=57 also of the oracle; one f32 K1, K2, K3 and K5
an f32 iteration); the mixed CCSD on LiH (1e-8 of the oracle) and the
mixed non-canonical mf-CCSD at nP=219 (|dE| < 1e-10, 1e-8 of the JAX
package's f64 energy; 4 K4 gathers, 2 traces and one K1, K2′, K3′, K5 an
iteration, in f32 in the f32 pass); each solve's wall beside its f64
solve's of phases 3/4, 7 and 9.  Phase 26 runs last, after phase 19:
(26) the JAX package's own ``examples/*.py``, read as text with
``pymes_tpu`` replaced by ``pymes_tpu_torch`` in their import lines and
nothing else changed, each ``main`` run with no device argument (so on
the card) in a temporary working directory (the molecular example on
``tests/data/FCIDUMP.LiH.321g``, RT for 3 steps, the TC twist average
on the 3³ mesh; its ``/tmp`` checkpoint redirected into that directory
and read back), in one path window (K2′, K3′, K5, K6, K7 and K8 must
launch); every tensor that the port's calls return to them on the card;
the LiH CCSD energy within 1e-10 of phase 19's JAX pin and 1e-8 of the
oracle, the HF energy within 1e-8, the EOM roots within 1e-8, c(t)
within 1e-7, each twist's HF and TC-MP2 energies and the twist-averaged
TC-MP2 within 1e-12 relative; then the reference's ``ladder_apply(plan,
T, 1)`` (``chunk`` spelled out) on the nP=57 plan: exactly one K1 launch,
bit-equal to ``ladder_apply(plan, T)``.  Every bound comes
from the helpers of ``pymes_tpu_torch/util/roofline.py``.
Prints a JSON line of the kernels
(launches, errors, the TC and drCCD runs as sub-entries,
times, bounds at the H100's HBM and FP64 peaks, the library call where one
computes the same function), the nvidia-smi line, and as the
last line ``{"ok": true, "device": {...}}``.
Any failed check raises and the script exits nonzero; without CUDA it
exits nonzero at once.

Run from the repository root: ``python3 chip_smoke.py``.
"""

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from pymes_tpu_torch.util import roofline
from pymes_tpu_torch.util.roofline import (bound, diag_bound, gather_bound,
                                           krylov_bounds, ladder_bound,
                                           ring_bound)

NO = 7
NEED = ("klij", "ijab", "abij", "iajb", "iabj", "aibj", "aijb", "ijka",
        "ijak", "iajk")
# converged CCD energies of the JAX package (f64, CPU) and the reference
# oracle (BASELINE.md)
E_JAX = {5: -0.5120153543911, 14: -0.5767206765319}
ORACLE_NP57 = -0.5120153512190824
# matrix-free CCSD of the JAX package (f64, CPU) at nP=219 with the seeded
# non-canonical Fock of setup_ccsd (level shift -1, |dE| < 1e-10): 11
# iterations, |T1|max = 0.01188
E_JAX_CCSD_NONCANONICAL = -0.664928068966791
N_IT_JAX_CCSD_NONCANONICAL = 11
# EOM-CCSD of the JAX package on a CPU: its f64 path (precision="f64",
# root_tracking="guess", contract_mode="xla", n_excit=2, max_dim=16,
# unit-vector guesses) on the matrix-free no-ovvv operator and the mf-CCD
# amplitudes of benchmarks/_setup.build_ueg_mf(cutoff, contract_mode="xla")
# (and at nP=219 also on its canonical mf-CCSD amplitudes): sorted roots
# and iteration counts
EOM_JAX = {5: ((5.2429519002247345, 5.2429519002247424), 10),
           14: ((5.239661269908714, 5.239701177870126), 9)}
EOM_JAX_CCSD_AMPS_NP219 = ((5.239661269908716, 5.239701177870117), 9)
EOM_RECORDED_NP219 = (5.2396613, 5.2397012)   # benchmarks/RESULTS.md:491
LIH_EOM_ORACLE = (0.1180867117168979, 0.154376205595602)   # BASELINE.md
EOM_KEYS = ("klij", "ijab", "abij", "iajb", "iabj", "ijka", "ijak", "iajk")
DATA = Path(__file__).resolve().parent / "tests" / "data"
# dense molecular CCSD: (FCIDUMP, TCDUMP or None, oracle correlation
# energy, oracle HF energy or None, tolerance) — BASELINE.md and
# tests/test_tc_ccsd.py
MOLECULES = {
    "LiH": ("FCIDUMP.LiH.321g", None, -0.01908832712812761,
            -7.92958534362757, 1e-8),
    "H2": ("FCIDUMP.H2.sto6g", None, -0.1012250926230937, None, 1e-8),
    "TC-LiH": ("FCIDUMP.LiH.tc", "TCDUMP.LiH_FNO", -0.010563160683828635,
               -8.044059106879612, 1e-7),
    "TC-H2": ("FCIDUMP.H2.tc", "TCDUMP.H2.tc", -0.005914233662984753,
              -1.166009516046628, 1e-7),
}
REL_TOL = 1e-12
# K4's fused trace: (plan, traced axis of S) of the dressing's G_vv
DIAG_PLANS = (("vov", 1), ("ovv", 0))
KERNELS = {
    "block_ladder": ("cuda", "pymes_tpu_torch/csrc/block_ladder.cu",
                     "pymes_tpu/ops/ueg_ladder.py:450"),
    "ccd_jacobi_diis": ("cuda", "pymes_tpu_torch/csrc/cc_tail.cu",
                        "pymes_tpu/solver/ccd.py:525"),
    "ccd_mix_energy": ("cuda", "pymes_tpu_torch/csrc/cc_tail.cu",
                       "pymes_tpu/mixer/diis.py:107"),
    "ovvv_gather": ("cuda", "pymes_tpu_torch/csrc/ovvv_gather.cu",
                    "pymes_tpu/ops/ueg_ladder.py:150"),
    "ovvv_gather_diag": ("cuda", "pymes_tpu_torch/csrc/ovvv_gather.cu",
                         "pymes_tpu/solver/ccsd.py:271"),
    "ccsd_jacobi_diis": ("cuda", "pymes_tpu_torch/csrc/cc_tail.cu",
                         "pymes_tpu/solver/ccsd.py:615"),
    "ccsd_mix_energy": ("cuda", "pymes_tpu_torch/csrc/cc_tail.cu",
                        "pymes_tpu/solver/ccsd.py:393"),
    "pair_symmetrize": ("cuda", "pymes_tpu_torch/csrc/pair_sym.cu",
                        "pymes_tpu/solver/ccd.py:349"),
    "davidson_residual": ("triton", "pymes_tpu_torch/kernels/davidson.py",
                          "pymes_tpu/solver/eom_ccsd.py:697"),
    "arnoldi_cgs2": ("cuda", "pymes_tpu_torch/csrc/arnoldi.cu",
                     "pymes_tpu/ops/gmres.py:87"),
    "shifted_precond": ("triton", "pymes_tpu_torch/kernels/shifted.py",
                        "pymes_tpu/solver/feast_eom_ccsd.py:67"),
    "ring_step": ("cuda", "pymes_tpu_torch/csrc/ring_step.cu",
                  "pymes_tpu/parallel/ring_ladder.py:69"),
    "block_scatter": ("cuda", "pymes_tpu_torch/csrc/block_scatter.cu",
                      "pymes_tpu/models/ueg.py:688"),
}
# the f32 instantiations of the mixed-precision engine and of the
# ground-state and Davidson precision modes: the same sources
KERNELS.update({name + "_f32": KERNELS[name] for name in (
    "block_ladder", "ovvv_gather", "pair_symmetrize", "arnoldi_cgs2",
    "shifted_precond", "davidson_residual", "ccd_jacobi_diis",
    "ccd_mix_energy", "ccsd_jacobi_diis", "ccsd_mix_energy",
    "ovvv_gather_diag")})
CCD_KERNELS = ("block_ladder", "ccd_jacobi_diis", "ccd_mix_energy",
               "pair_symmetrize")
DENSE_CCSD_KERNELS = ("ccsd_jacobi_diis", "ccsd_mix_energy",
                      "pair_symmetrize")
MF_CCSD_KERNELS = ("block_ladder", "ovvv_gather", "ovvv_gather_diag",
                   "ccsd_jacobi_diis", "ccsd_mix_energy", "pair_symmetrize")
EOM_KERNELS = ("block_ladder", "ovvv_gather", "pair_symmetrize",
               "davidson_residual")
KRYLOV_KERNELS = ("block_ladder", "ovvv_gather", "pair_symmetrize",
                  "arnoldi_cgs2", "shifted_precond")
RING_KERNELS = ("ring_step", "ccd_jacobi_diis", "ccd_mix_energy",
                "pair_symmetrize")
# shards of the sector-sharded BlockLadder at nP=219 (pad_sectors)
SECTOR_SHARDS = 4
# phase 18, the transcorrelated UEG (tc_model: gaskell, k_cutoff as
# tests/test_ueg.py:114) at cutoff 14 (nP=219): the JAX package's energies
# and iteration counts, f64 on a CPU (tools/pin_tc_jax.py): "ccd" the
# non-hermitian (is_only_2b) CCD on the virtual block plan, DIIS, shift -1,
# |dE| < 1e-8; "ccsd" the hermitian-TC (is_only_hermi_2b) matrix-free CCSD
# with the seeded non-canonical Fock, |dE| < 1e-10 (|T1|max 0.01502).  The
# cutoff-5 (nP=57) values serve a rehearsal of the phase on the CPU.
TC_RS = 0.5
TC_CUTOFF = 14
TC_JAX = {14: {"ccd": (13.46038059699951, 12),
               "ccsd": (-7.463341985936916, 18)},
          5: {"ccd": (10.048218675665616, 10),
              "ccsd": (-5.597053463172118, 18)}}
# iterations of the dense-abcd TC CCD held to the matrix-free solve's
TC_DENSE_ITERS = 6
# Coulomb drCCD at nP=57 on the dense blocks (tools/pin_tc_jax.py): DIIS,
# shift -1, |dE| < 1e-8
E_JAX_DRCCD_NP57 = -0.7314109497312941
N_IT_JAX_DRCCD_NP57 = 6
# phase 19, the utilities slice: the JAX package's numbers, f64 on a CPU
# (tools/pin_twist_jax.py).  The mf-CCD of UEG 14e, rs 0.5, cutoff 14 at
# each irreducible twist of the 3³ mesh (virtual plan, DIIS, shift -1,
# |dE| < 1e-8): (twist, nP, energy, iterations), and the weighted mean
TWIST_JAX = (((0.0, 0.0, 0.0), 219, -0.5767206765319415, 6),
             ((1 / 3, 0.0, 0.0), 220, -0.5448115310820241, 6),
             ((1 / 3, 1 / 3, 0.0), 223, -0.49275406858894916, 6),
             ((1 / 3, 1 / 3, 1 / 3), 211, -0.41972932531408763, 5))
TWIST_MEAN_JAX = -0.48579530698533985
# the JAX package's examples: molecular_ccsd_eom on LiH/3-21G (CCSD to
# |dE| < 1e-10; the two EOM roots of its default mixed-precision Davidson,
# held to the 1e-8 Davidson threshold), rt_autocorrelation's first 3 steps
# (c(t), held to 1e-7: both stop each node's GMRES at ls_conv_tol 1e-4,
# the port in the real (Re, Im) embedding) and ueg_tc_twist_average at
# mesh 3 ((HF, 3-body, MP2) at each twist, held to 1e-12 relative)
EX_JAX = {
    "ccsd e": -0.01908832710835842,
    "roots": (0.11808671357228674, 0.15437620547278597),
    "c(t)": ((0.9984662675277396, 0.055363459151542234),
             (0.9938697775153073, 0.11055706825741096),
             (0.9862246256770839, 0.16541157065965978)),
    "tc": ((7.599236309977181, 1.3342935612415587, 0.8966527705433868),
           (11.528177814967234, 1.0299809946426066, 0.07784744410953198),
           (10.863082707418116, 1.1470242894883573, 0.18601607912696577),
           (8.37787707517413, 1.2640675843341083, 0.05989899796060645)),
}
# FEAST at nP=57: the window of benchmarks/probe_r5_feast57b.py (e_c at the
# 3-fold level of EOM_JAX[5], e_r excluding 5.2652816 and 5.2789029), f64
# GMRES(120) x 6 on all 16 nodes x 4 trials as lanes.  GMRES stops on the
# preconditioned residual M(b - Ax), M = 1/(z - diag + 0.01): at
# ls_conv_tol 1e-8 (the probe's) the honest residual |b - (z - H)x|/|b|
# reached 8.9e-7 on an H100, so 1e-10 holds it <= 1e-7
FEAST57 = dict(e_c=5.2429519002247, e_r=0.018, n_trial=4, n_quad=16,
               ls_conv_tol=1e-10, seed=7, n_excit=4, max_iter=4, tol=1e-10)
FEAST57_GMRES = (120, 6)                 # ls_restart, ls_max_iter
# RT at nP=123 (cutoff 10): benchmarks/probe_r4_rt123.py's contour, seeded
# with the port's Davidson Ritz vector; the recorded root is
# benchmarks/RESULTS.md:555
RT123 = dict(cutoff=10, n_quad=32, dt=0.1, e_r=0.5, steps=3, ls_restart=20,
             ls_conv_tol=1e-10)
RT_RECORDED_NP123 = 5.24025234
# lanes of one chunk of the FEAST nP=57 and RT nP=123 solves (one chunk an
# iteration or step): each sigma of a chunk's first Arnoldi step gathers
# 2·lanes trials through K4, 2·lanes·no columns
K4_LANES = {"FEAST": FEAST57["n_quad"] * FEAST57["n_trial"],
            "RT": RT123["n_quad"]}
# FEAST on LiH/3-21G (tests/test_feast_rt.py:183-201), against the oracle
LIH_FEAST = dict(e_c=0.12, e_r=0.025, n_trial=2, max_iter=60, tol=1e-11,
                 seed=7)
# phase 20, the generic FEAST kernel over the card's sigma: the nP=57
# window of phase 12 (e_c at the degenerate level of EOM_JAX[5]; the
# Davidson that straddles it sees the level twice and 5.2652816 /
# 5.2789029 outside).  Capped at 3 cycles of 8 nodes x 3 trials, each
# node solve at most 4 outer GCROT(20, 20) iterations (41 matvecs each;
# rtol 1e-4 took 110-131 matvecs on an H100): ~6500 matvecs.  2 cycles
# with 2 outer iterations left a Ritz value 7.6e-4 off the level.  One CIF
# step from the Davidson vector at 32 nodes; the adapters on LiH (a window
# holding both oracle roots)
GENERIC57 = dict(e_c=5.2429519002247, e_r=0.018, nroots=3, ngl_pts=8,
                 max_cycle=3, conv_tol=1e-9, ls_max_iter=4,
                 ls_conv_tol=1e-4, seed=3, verbose=False)
GENERIC57_N_EXCIT = 6
GENERIC57_RT = dict(dt=0.1, e_r=0.5, ngl_pts=32, ls_conv_tol=1e-10,
                    ls_max_iter=100)
LIH_ADAPTER = {"feast": dict(nroots=3, e_c=0.136, e_r=0.03, ngl_pts=8),
               "max_cycle": 20, "ls_max_iter": 20}
# phase 21: the nodes of phase 12 over P shares of one card
NODE_MESHES = (2, 4)
# phase 24, the FEAST/RT mixed-precision engine (ls_precision="mixed", the
# JAX package's default): phase 12's window and phase 13's steps with f32
# Krylov inside f64 refinement, and the f32 kernels against their f32
# twins at both lane shapes (max relative error F32_REL).  Refinement may
# take up to MIXED_REFINE_MAX passes a chunk (the JAX default is 4): the
# near-axis nodes of the nP=57 window may need more to reach ls_conv_tol
F32_KERNELS = ("block_ladder_f32", "ovvv_gather_f32", "pair_symmetrize_f32",
               "arnoldi_cgs2_f32", "shifted_precond_f32")
F32_REL = 1e-5
MIXED_REFINE_MAX = 8
# f32 K7's projection sweep of phase 24 by lane shape, per call after a
# write of FLUSH_BYTES that evicts the 50 MB L2 (in the solver a sigma
# runs between two projections)
K7_F32_SWEEP = {"FEAST": (8, 16, 30, 60, 90, 120), "RT": (4, 10, 16, 20)}
FLUSH_BYTES = 256 << 20
# phase 25, the ground-state and Davidson precision modes (EOM
# precision="mixed", CCD/CCSD mixed_precision): their f32 kernels against
# their f32 twins at the nP=219 shapes (max relative error F32_REL), and
# the JAX package's numbers on a CPU (tools/pin_mixed_jax.py): the EOM
# nP=57 mixed roots with the f32 phase's and the polish's iterations, the
# EOM roots converged to |dE| < 1e-12 at nP=57 and nP=219 (``--parts
# eom_tight --cutoff 14``: 16 iterations), the CCD nP=57 mixed energy with
# its f32 and f64 iterations, the LiH/3-21G CCSD mixed energy likewise;
# the distance of EOM_JAX's nP=219 pin (stopped at |dE| < 1e-8) from the
# port's converged roots is capped
PREC_KERNELS = ("davidson_residual_f32", "ccd_jacobi_diis_f32",
                "ccd_mix_energy_f32", "ccsd_jacobi_diis_f32",
                "ccsd_mix_energy_f32", "ovvv_gather_diag_f32")
EOM_JAX_MIXED_NP57 = ((5.242951899266315, 5.242951901247843), 7, 9)
EOM_JAX_TIGHT = {57: (5.242951902209979, 5.2429519022099935),
                 219: (5.239661296835245, 5.23970120475561)}
EOM_PIN_CAP = 5e-8
CCD_JAX_MIXED_NP57 = (-0.5120153549861027, 4, 2)
LIH_JAX_CCSD_MIXED = (-0.019088328657353434, 5, 8)
# phase 23, the tensor-parallel dense CCD/CCSD: (devices, 2-D shape or
# None) of the meshes over one card at nP=219 (nv = 212) and for LiH (nv =
# 9); the peak of the cut CCD stays below abcd + 25 %
TP_MESHES = ((4, None), (4, (2, 2)))
LIH_TP_MESHES = ((3, None), (9, (3, 3)))
TP_PEAK_HEADROOM = 0.25


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def setup(cutoff, device, u=None):
    """The matrix-free CCD inputs of UEG 14e, rs 0.5 at ``cutoff`` (or of
    the model ``u``): the named blocks, the diagonal HF Fock, the virtual
    ladder plan and the MP2 guess on the card."""
    import torch

    from pymes_tpu_torch.mean_field import hf
    from pymes_tpu_torch.models import ueg
    from pymes_tpu_torch.ops.ueg_ladder import build_block_ladder
    from pymes_tpu_torch.solver import ccd, mp2

    t0 = time.time()
    if u is None:
        u = ueg.UEG(14, 7, 7, 0.5)
        u.init_single_basis(cutoff)
    idx, vals = u.eval_2b_integrals(sp=2)
    n_p = u.n_spatial
    d = ueg.sparse_to_blocks(idx, vals, n_p, NO, device=device, names=NEED)
    kin = u.kinetic_energies()
    eps_i = hf.calcOccupiedOrbE(kin, d["klij"], NO)
    eps_a = hf.calcVirtualOrbE(kin, d["aibj"], d["aijb"], NO, n_p - NO)
    fock = torch.diag(torch.cat([eps_i, eps_a]))
    plan = build_block_ladder(u, device=device)
    blocks = ccd.CCDBlocks(klij=d["klij"], ijab=d["ijab"], abij=d["abij"],
                           iajb=d["iajb"], iabj=d["iabj"], abcd=None,
                           ladder=plan)
    _, T0 = mp2.solve(eps_i, eps_a, blocks.ijab, blocks.abij, -1.0)
    torch.cuda.synchronize()
    buckets = ", ".join("{}x{}x{}".format(*g.blocks.shape)
                        for g in plan.groups)
    print(f"setup cutoff {cutoff}: nP={n_p} nnz={len(vals)} "
          f"buckets [{buckets}] ({time.time() - t0:.2f} s)", flush=True)
    return {"cutoff": cutoff, "nP": n_p, "nv": n_p - NO, "fock": fock,
            "blocks": blocks, "T0": T0, "eps_i": eps_i, "eps_a": eps_a,
            "ueg": u, "dict": d, "sparse": (idx, vals)}


def kept_entries(idx, n_p, no, names):
    """How many entries of the list ``idx`` land in the blocks ``names``
    (the rest the scatter drops): what K10's bound counts."""
    from pymes_tpu_torch.kernels import block_scatter as k10

    pl = k10.plan(n_p, no, names)
    cls = (idx < no).astype(np.int64) @ np.array([8, 4, 2, 1])
    return int(np.isin(cls, [c for c, k in enumerate(pl.slot)
                             if k >= 0]).sum())


def time_scatter(p):
    """B8, the set-up scatter of the nP=219 sparse integrals into the
    ``NEED`` blocks (``models/ueg.py`` ``sparse_to_blocks``), through K10
    and through its twin (host masks, copies and one ``index_put_`` a
    block): K10 held to the twin bit for bit, then the wall of one call of
    each (host clock, synchronised; twin, kernel, kernel, twin, min of 3
    each), the upload alone (host clock, min of 5: the int16-packed list
    K10 reads, and the int64 list as ``eval_2b_integrals`` gives it,
    pageable), the card time of the scatter from the uploaded list (zero
    fills + K10) and of K10 alone (profiler), and K10's bound
    (:func:`roofline.scatter_bound`)."""
    import torch

    from pymes_tpu_torch.kernels import block_scatter as k10

    idx, vals = p["sparse"]
    n_p, dev = p["nP"], p["fock"].device

    def run(twin):
        return k10.block_scatter(idx, vals, n_p, NO, NEED, dev, twin=twin)

    got, want = run(False), run(True)
    torch.cuda.synchronize()
    err = max(float((got[k] - want[k]).abs().max()) for k in NEED)
    check(all(torch.equal(got[k], want[k]) for k in NEED),
          f"block_scatter: K10 differs from its twin at nP={n_p} ({err:.3e})")
    check(all(bool(got[k].any()) for k in NEED),
          "block_scatter: a compared block is all zero")
    del got, want

    def wall(fn, n=3):
        ms = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return min(ms)

    walls = {True: [], False: []}
    for twin in (True, False, False, True):
        walls[twin].append(wall(lambda: run(twin)))
    up = k10.upload(idx, vals, dev)

    def scatter():
        return k10.scatter(*up, n_p, NO, NEED, dev)

    pl = k10.plan(n_p, NO, NEED)
    out = {"wall": min(walls[False]), "twin_wall": min(walls[True]),
           "upload": wall(lambda: k10.upload(idx, vals, dev), 5),
           "upload_int64": wall(lambda: (torch.as_tensor(idx).to(dev),
                                         torch.as_tensor(vals).to(dev)), 5),
           "device": card_ms(scatter, "", n=5, warmup=1),
           "kernel": card_ms(scatter, "block_scatter", n=5, warmup=1),
           "bound": roofline.scatter_bound(len(vals),
                                           kept_entries(idx, n_p, NO, NEED),
                                           pl.sizes),
           "nnz": len(vals), "err": err}
    return out


def dense_past_2_31(p):
    """K10 on one block past 2³¹ elements: ``sparse_to_dense`` of the
    nP=219 list (18.40 GB) on the card, every entry of the list read back
    from it and its nonzero count matched to the list's (so every other
    element is zero), instead of a twin's second copy; then the wall of
    one call (min of 3), the card time of K10 alone, the bound and one
    ``index_put_`` of the list's flat indices on the card."""
    import torch

    from pymes_tpu_torch.kernels import block_scatter as k10
    from pymes_tpu_torch.models import ueg

    idx, vals = p["sparse"]
    n_p, dev = p["nP"], p["fock"].device
    torch.cuda.empty_cache()
    V = ueg.sparse_to_dense(idx, vals, n_p, device=dev).view(-1)
    check(V.numel() >= 2 ** 31, f"dense nP={n_p}: {V.numel()} elements")
    ii = torch.as_tensor(idx, device=dev)
    flat = ((ii[:, 0] * n_p + ii[:, 1]) * n_p + ii[:, 2]) * n_p + ii[:, 3]
    del ii
    vd = torch.as_tensor(vals, device=dev)
    n_nz = int(torch.count_nonzero(V))
    check(torch.equal(V[flat], vd) and n_nz == int(torch.count_nonzero(vd)),
          f"dense nP={n_p}: K10's tensor does not hold the list")
    check(int(flat.max()) >= 2 ** 31, "dense: no offset past 2^31")
    lib = cuda_ms(lambda: V.index_put_((flat,), vd), n=5, warmup=1)
    del V
    torch.cuda.empty_cache()
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ueg.sparse_to_dense(idx, vals, n_p, device=dev)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    up = k10.upload(idx, vals, dev)
    kernel = card_ms(lambda: k10.scatter(*up, n_p, 0, ("abcd",), dev),
                     "block_scatter", n=3, warmup=1)
    torch.cuda.empty_cache()
    return {"wall": min(ms), "kernel": kernel, "library": lib,
            "bound": roofline.scatter_bound(len(vals), len(vals),
                                            (n_p ** 4,)),
            "elements": n_p ** 4, "max_offset": int(flat.max()),
            "nonzero": n_nz}


def setup_ccsd(p, device):
    """The matrix-free CCSD inputs on top of a CCD set-up: the all-bra
    ladder plan, the OVVV gather plans, the V dict (no abcd, no ovvv-class
    block), the canonical Fock and the seeded non-canonical one (noise
    rng(5)·0.02, symmetrised), and the MP2 guess of each."""
    import torch

    from pymes_tpu_torch.ops import ueg_ladder
    from pymes_tpu_torch.solver import mp2

    t0 = time.time()
    u, n_p = p["ueg"], p["nP"]
    d = dict(p["dict"])
    d["_ovvv_plans"] = ueg_ladder.build_ovvv_plans(u, device=device)
    plan = ueg_ladder.build_block_ladder(u, device=device, bra="all")
    eps = torch.cat([p["eps_i"], p["eps_a"]]).cpu().numpy()
    noise = np.random.default_rng(5).standard_normal((n_p, n_p)) * 0.02
    focks = {"canonical": p["fock"],
             "non-canonical": torch.as_tensor(
                 np.diag(eps) + noise + noise.T, device=p["fock"].device)}
    T0 = {}
    for kind, f in focks.items():
        diag = torch.diagonal(f)
        T0[kind] = mp2.solve(diag[:NO], diag[NO:], d["ijab"], d["abij"],
                             -1.0)[1]
    torch.cuda.synchronize()
    print(f"setup CCSD nP={n_p}: all-bra plan n_bra={plan.n_bra}, OVVV "
          f"plans {sorted(d['_ovvv_plans'])} "
          f"({time.time() - t0:.2f} s)", flush=True)
    return {**p, "plan_all": plan, "mf_dict": d, "focks": focks,
            "T2_0": T0}


def inputs(p, seed):
    """Seeded amplitudes/residual, DIIS rings and coefficients at the
    shapes the main path gives the kernels."""
    import torch

    rng = np.random.default_rng(seed)
    nv, dev = p["nv"], p["fock"].device
    shape = (NO, NO, nv, nv)

    def t(x):
        return torch.as_tensor(x, dtype=torch.float64, device=dev)

    n = NO * NO * nv * nv
    return {"T": t(rng.standard_normal(shape) * 0.01),
            "R": t(rng.standard_normal(shape) * 0.01),
            "errs": t(rng.standard_normal((6, n)) * 0.01),
            "amps": t(rng.standard_normal((6, n)) * 0.01),
            "coeff": t(rng.standard_normal(6))}


def rel_err(got, want, what, tol=REL_TOL):
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    # a zero reference would pass any kernel: every compared output must
    # carry signal
    check(scale > 0, f"{what}: the twin's output is all zero")
    check(err <= tol * scale,
          f"{what}: max|kernel - twin| = {err:.3e} > {tol} * {scale:.3e}")
    return err


def bit_equal(got, want, what):
    """A kernel that computes each element in the twin's order (K4's
    gather, K5's sum, the ring rows of K2/K2′): the bits must agree.
    Returns the max abs error (0)."""
    import torch

    check(float(want.abs().max()) > 0, f"{what}: the twin's output is all "
          "zero")
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(torch.equal(got, want), f"{what}: kernel and twin differ by "
          f"{err:.3e}")
    return err


def compare_kernels(p, seed):
    """Each kernel vs its twin on the card; returns max abs errors."""
    from pymes_tpu_torch.kernels import ccd_tail
    from pymes_tpu_torch.ops.ueg_ladder import block_ladder_apply_ij

    x = inputs(p, seed)
    plan, V = p["blocks"].ladder, p["blocks"].ijab.contiguous()
    Vx = V.transpose(2, 3).contiguous()
    errs = {}
    got = block_ladder_apply_ij(plan, x["T"])
    want = block_ladder_apply_ij(plan, x["T"], twin=True)
    errs["block_ladder"] = rel_err(got, want, "block_ladder")

    e_k2 = 0.0
    for slot, n_valid in ((0, 1), (2, 6)):   # first insertion; full ring
        rings = [(x["errs"].clone(), x["amps"].clone()) for _ in range(2)]
        rows = [ccd_tail.jacobi_diis_insert(
            x["R"], x["T"], p["eps_i"], p["eps_a"], -1.0, e, a, slot,
            n_valid, twin=tw) for (e, a), tw in zip(rings, (False, True))]
        e_k2 = max(e_k2, rel_err(rows[0], rows[1], "K2 Gram row"),
                   bit_equal(rings[0][0], rings[1][0], "K2 error ring"),
                   bit_equal(rings[0][1], rings[1][1],
                             "K2 amplitude ring"))
    errs["ccd_jacobi_diis"] = e_k2

    e_k3 = 0.0
    for n_valid in (1, 6):
        Ts = [x["T"].clone() for _ in range(2)]
        es = [ccd_tail.diis_mix_energy(x["amps"], x["coeff"], n_valid, T,
                                       V, Vx, twin=tw)
              for T, tw in zip(Ts, (False, True))]
        e_k3 = max(e_k3, rel_err(Ts[0], Ts[1], "K3 mixed amplitudes"),
                   *(rel_err(a, b, "K3 energy") for a, b in zip(*es)))
    errs["ccd_mix_energy"] = e_k3
    print(f"kernel vs twin, nP={p['nP']}: " + ", ".join(
        f"{k} max_abs_err={v:.3e}" for k, v in errs.items()), flush=True)
    return errs


def cuda_ms(fn, n=20, warmup=3):
    """Mean device time of ``fn`` over ``n`` calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def flushed_ms(fn, flush, n=10, warmup=2):
    """Mean device time of ``fn`` over ``n`` calls (CUDA events around each
    call), each after a write of ``flush`` that evicts the L2."""
    import torch

    for _ in range(warmup):
        flush.add_(1)
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    for start, end in ev:
        flush.add_(1)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in ev) / n


def card_ms(fn, name, n=20, warmup=3):
    """Mean time on the card of the kernels whose name holds ``name`` in
    one call of ``fn``: ``n`` calls under ``torch.profiler`` (CUDA
    activity), their device time summed over the calls.  Unlike
    :func:`cuda_ms` it leaves out the host time between launches, which a
    call whose kernels take less time than its Python wrapper shows.  A
    session whose trace holds no such kernel is run again, up to three
    sessions; when all three lose the CUDA activity (seen on an H100, in
    one session and in three running), the time is :func:`queued_ms`'s,
    and a line says so."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        # self_device_time_total, self_cuda_time_total before torch 2.4; a
        # 0 is a time, not a missing field
        us = sum(e.self_cuda_time_total
                 if getattr(e, "self_device_time_total", None) is None
                 else e.self_device_time_total
                 for e in prof.key_averages() if name in e.key)
        if us > 0:
            return us / 1e3 / n
    ms = queued_ms(fn, n)
    print(f"the profiler saw no kernel named {name!r} in 3 sessions: "
          f"{ms:.4f} ms is every device op of a call, by CUDA events behind "
          "a queued spin", flush=True)
    return ms


def queued_ms(fn, n=20):
    """Mean device time of ``fn`` over ``n`` calls, every device op of a
    call, by CUDA events with the calls queued behind a spin on the card
    (``torch.cuda._sleep``) that outlasts their launches, so that the card
    runs them back to back and no host time between launches is counted.
    The spin is sized from one synchronised call's host time."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    # cycles at the H100's 1.98 GHz boost clock; 2x the host time of the n
    # launches, at least 5 ms, at most 2 s
    torch.cuda._sleep(int(min(max(2 * n * host_s, 5e-3), 2.0) * 1.98e9))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def time_kernels(p, seed):
    """ms per call of each kernel and of its twin, at the main path's
    shapes (plain, kernel, kernel, plain; the mean of each pair)."""
    from pymes_tpu_torch.kernels import ccd_tail
    from pymes_tpu_torch.ops.ueg_ladder import block_ladder_apply_ij

    x = inputs(p, seed)
    plan, V = p["blocks"].ladder, p["blocks"].ijab.contiguous()
    Vx = V.transpose(2, 3).contiguous()
    calls = {
        "block_ladder": lambda tw: block_ladder_apply_ij(plan, x["T"],
                                                         twin=tw),
        "ccd_jacobi_diis": lambda tw: ccd_tail.jacobi_diis_insert(
            x["R"], x["T"], p["eps_i"], p["eps_a"], -1.0, x["errs"],
            x["amps"], 2, 6, twin=tw),
        "ccd_mix_energy": lambda tw: ccd_tail.diis_mix_energy(
            x["amps"], x["coeff"], 6, x["R"], V, Vx, twin=tw),
    }
    out = {}
    for name, fn in calls.items():
        t = [cuda_ms(lambda: fn(tw)) for tw in (True, False, False, True)]
        out[name] = ((t[1] + t[2]) / 2, (t[0] + t[3]) / 2)
    return out


def tail_inputs(no, V, seed):
    """Seeded T1/T2/residuals, the CCSD DIIS rings over [T1 | T2],
    coefficients and a one-body operand F1 = f_ovᵀ at the shapes of one
    CCSD path: ``no`` occupied orbitals, ``V`` its V_ijab block.  F1 is
    seeded too, since a canonical Fock has f_ov = 0 and would leave K3′'s
    one-body energy unchecked."""
    import torch

    rng = np.random.default_rng(seed)
    nv, dev = V.shape[2], V.device
    n = nv * no + no * no * nv * nv

    def t(shape, scale=0.01):
        return torch.as_tensor(rng.standard_normal(shape) * scale,
                               dtype=torch.float64, device=dev)

    V = V.contiguous()
    return {"T1": t((nv, no)), "R1": t((nv, no)),
            "T2": t((no, no, nv, nv)), "R2": t((no, no, nv, nv)),
            "errs": t((6, n)), "amps": t((6, n)), "coeff": t(6, 1.0),
            "F1": t((nv, no), 0.1), "V": V,
            "Vx": V.transpose(2, 3).contiguous()}


def compare_ccsd_tail(x, eps_i, eps_a, label):
    """K2′ and K3′ vs their twins on the inputs of :func:`tail_inputs`:
    slot 0 with n_valid 1 (first insertion) and slot 2 with n_valid 6
    (full ring); returns their max abs errors."""
    from pymes_tpu_torch.kernels import ccsd_tail

    e_k2 = 0.0
    for slot, n_valid in ((0, 1), (2, 6)):
        rings = [(x["errs"].clone(), x["amps"].clone()) for _ in range(2)]
        rows = [ccsd_tail.jacobi_diis_insert(
            x["R1"], x["T1"], x["R2"], x["T2"], eps_i, eps_a, -1.0, e, a,
            slot, n_valid, twin=tw)
            for (e, a), tw in zip(rings, (False, True))]
        e_k2 = max(e_k2,
                   rel_err(rows[0], rows[1], f"K2' Gram row, {label}"),
                   bit_equal(rings[0][0], rings[1][0],
                             f"K2' error ring, {label}"),
                   bit_equal(rings[0][1], rings[1][1],
                             f"K2' amplitude ring, {label}"))

    e_k3 = 0.0
    for n_valid in (1, 6):
        Ts = [(x["T1"].clone(), x["T2"].clone()) for _ in range(2)]
        es = [ccsd_tail.diis_mix_energy(x["amps"], x["coeff"], n_valid, T1,
                                        T2, x["F1"], x["V"], x["Vx"],
                                        twin=tw)
              for (T1, T2), tw in zip(Ts, (False, True))]
        e_k3 = max(e_k3, rel_err(Ts[0][0], Ts[1][0], f"K3' mixed T1, {label}"),
                   rel_err(Ts[0][1], Ts[1][1], f"K3' mixed T2, {label}"),
                   *(rel_err(a, b, f"K3' energy {piece}, {label}")
                     for piece, a, b in zip(("e_1b", "e_dir", "e_exc"),
                                            *es)))
    return e_k2, e_k3


def compare_ccsd_kernels(q, seed):
    """K4 (bit for bit) and its fused trace, K2′/K3′ and K1 with the
    stacked CCSD operand vs their twins on the card at nP=219; returns max
    abs errors."""
    import torch

    from pymes_tpu_torch.ops import ueg_ladder

    x = tail_inputs(NO, q["dict"]["ijab"], seed)
    plans = q["mf_dict"]["_ovvv_plans"]
    errs = {"ovvv_gather": max(
        bit_equal(ueg_ladder.ovvv_t1_apply_j(plan, x["T1"]),
                  ueg_ladder.ovvv_t1_apply_j(plan, x["T1"], twin=True),
                  f"K4 {pat}, 7 columns") for pat, plan in plans.items())}
    errs["ovvv_gather_diag"] = max(
        rel_err(ueg_ladder.ovvv_t1_trace(plans[pat], x["T1"], axis),
                ueg_ladder.ovvv_t1_trace(plans[pat], x["T1"], axis,
                                         twin=True), f"K4 trace {pat}")
        for pat, axis in DIAG_PLANS)
    errs["ccsd_jacobi_diis"], errs["ccsd_mix_energy"] = compare_ccsd_tail(
        x, q["eps_i"], q["eps_a"], f"nP={q['nP']}")

    X = torch.einsum("ci,dj->ijcd", x["T1"], x["T1"])
    TX = torch.stack([x["T2"].reshape(NO * NO, q["nv"], q["nv"]),
                      X.reshape(NO * NO, q["nv"], q["nv"])])
    errs["block_ladder"] = rel_err(
        ueg_ladder.block_ladder_apply_ij(q["plan_all"], TX),
        ueg_ladder.block_ladder_apply_ij(q["plan_all"], TX, twin=True),
        "K1 stacked (2 no^2, nv^2) operand, all-bra plan")
    print(f"kernel vs twin, CCSD nP={q['nP']}: " + ", ".join(
        f"{k} max_abs_err={v:.3e}" for k, v in errs.items()), flush=True)
    return errs


def time_ccsd_kernels(q, seed):
    """ms per call of K4 at the dressing's 7 columns (:func:`time_k4`) and
    of its fused trace (mean over the vov and ovv plans), K2′ and K3′ and
    of their twins at nP=219 (plain, kernel, kernel, plain).  No profiler
    runs here: the fixed-iteration walls that follow are timed as before
    any profiler session, and :func:`ccsd_k4_alone` takes the times on
    the card alone after them."""
    from pymes_tpu_torch.kernels import ccsd_tail
    from pymes_tpu_torch.ops import ueg_ladder

    x = tail_inputs(NO, q["dict"]["ijab"], seed)
    plans = q["mf_dict"]["_ovvv_plans"]
    out = {"ovvv_gather": time_k4(plans, x["T1"], "7 columns", alone=False)}
    diag = [(plans[pat], axis) for pat, axis in DIAG_PLANS]
    calls = {
        "ovvv_gather_diag": lambda tw: [ueg_ladder.ovvv_t1_trace(
            plan, x["T1"], axis, twin=tw) for plan, axis in diag],
        "ccsd_jacobi_diis": lambda tw: ccsd_tail.jacobi_diis_insert(
            x["R1"], x["T1"], x["R2"], x["T2"], q["eps_i"], q["eps_a"],
            -1.0, x["errs"], x["amps"], 2, 6, twin=tw),
        "ccsd_mix_energy": lambda tw: ccsd_tail.diis_mix_energy(
            x["amps"], x["coeff"], 6, x["R1"], x["R2"], x["F1"], x["V"],
            x["Vx"], twin=tw),
    }
    for name, fn in calls.items():
        t = [cuda_ms(lambda: fn(tw)) for tw in (True, False, False, True)]
        per = len(diag) if name == "ovvv_gather_diag" else 1
        out[name] = ((t[1] + t[2]) / 2 / per, (t[0] + t[3]) / 2 / per)
    return out


def ccsd_k4_alone(q, seed):
    """K4 at the dressing's 7 columns and its fused trace on the card
    alone (profiler), per launch, on :func:`time_ccsd_kernels`' inputs."""
    from pymes_tpu_torch.ops import ueg_ladder

    T1 = tail_inputs(NO, q["dict"]["ijab"], seed)["T1"]
    plans = q["mf_dict"]["_ovvv_plans"]
    gather = card_ms(lambda: [ueg_ladder.ovvv_t1_apply_j(plan, T1)
                              for plan in plans.values()], "ovvv_gather")
    trace = card_ms(lambda: [ueg_ladder.ovvv_t1_trace(plans[pat], T1, axis)
                             for pat, axis in DIAG_PLANS], "ovvv_diag")
    return gather / len(plans), trace / len(DIAG_PLANS)


def tail_calls(p, q, seed, dtype):
    """The four tail passes at nP=219 as calls of no argument, on seeded
    inputs of type ``dtype`` made as :func:`time_kernels` (K2/K3) and
    :func:`time_ccsd_kernels` (K2′/K3′) make theirs: slot 2 of a 6-slot
    ring, all slots valid."""
    from pymes_tpu_torch.kernels import ccd_tail, ccsd_tail

    x = {k: v.to(dtype) for k, v in inputs(p, seed).items()}
    y = {k: v.to(dtype) for k, v in tail_inputs(NO, q["dict"]["ijab"],
                                                seed).items()}
    eps_i, eps_a = q["eps_i"].to(dtype), q["eps_a"].to(dtype)
    return {
        "ccd_jacobi_diis": lambda: ccd_tail.jacobi_diis_insert(
            x["R"], x["T"], eps_i, eps_a, -1.0, x["errs"], x["amps"], 2, 6),
        "ccd_mix_energy": lambda: ccd_tail.diis_mix_energy(
            x["amps"], x["coeff"], 6, x["R"], y["V"], y["Vx"]),
        "ccsd_jacobi_diis": lambda: ccsd_tail.jacobi_diis_insert(
            y["R1"], y["T1"], y["R2"], y["T2"], eps_i, eps_a, -1.0,
            y["errs"], y["amps"], 2, 6),
        "ccsd_mix_energy": lambda: ccsd_tail.diis_mix_energy(
            y["amps"], y["coeff"], 6, y["R1"], y["R2"], y["F1"], y["V"],
            y["Vx"])}


def tails_alone(p, q, seed):
    """K2/K3 and K2′/K3′, f64 and f32, on the card alone (profiler: every
    device operation of a wrapper call, the ticket reset included), ms per
    call at nP=219 on :func:`tail_calls`."""
    import torch

    out = {}
    for sfx, dtype in (("", torch.float64), ("_f32", torch.float32)):
        for name, fn in tail_calls(p, q, seed, dtype).items():
            out[name + sfx] = card_ms(fn, "")
        torch.cuda.empty_cache()
    return out


def print_k4(card, label, t):
    ms, plain, dev, b, err = t
    print(f"[{card}] ovvv_gather {label}: kernel {ms:.4f} ms per call "
          f"({dev:.4f} ms on the card alone), twin {plain:.4f} ms; bound "
          f"{b[0]:.4f} ms ({b[1]}), the kernel alone at {b[0] / dev:.3f} of "
          f"it; max_abs_err {err:.1e}", flush=True)


def time_k4(plans, T, label, alone=True):
    """K4 at one width, the entry its caller uses (``ovvv_t1_apply_j`` on
    the dressing's (nv, no) T1, ``ovvv_t1_apply`` on a (k, nv, no) trial
    batch): bit for bit against its twin on every plan, then ms per call
    (mean over the plans; plain, kernel, kernel, plain) and, with
    ``alone``, on the card alone.  Returns (ms, plain_ms, device_ms or
    None, bound, max abs error)."""
    from pymes_tpu_torch.ops import ueg_ladder

    apply = (ueg_ladder.ovvv_t1_apply if T.dim() == 3
             else ueg_ladder.ovvv_t1_apply_j)
    err = max(bit_equal(apply(plan, T), apply(plan, T, twin=True),
                        f"K4 {label}, {pat}") for pat, plan in plans.items())

    def fn(tw):
        return [apply(plan, T, twin=tw) for plan in plans.values()]

    k = len(plans)
    t = [cuda_ms(lambda: fn(tw)) for tw in (True, False, False, True)]
    dev = card_ms(lambda: fn(False), "ovvv_gather") / k if alone else None
    ncol = T.shape[-1] * (T.shape[0] if T.dim() == 3 else 1)
    b = [gather_bound(plan, T.shape[-2], ncol, elem=T.element_size())
         for plan in plans.values()]
    return ((t[1] + t[2]) / 2 / k, (t[0] + t[3]) / 2 / k, dev,
            (float(np.mean([x[0] for x in b])), b[0][1]), err)


def k4_lanes(V, nv, k, seed, label):
    """K4 at a FEAST/RT sigma's width: ``k`` trials (2 per lane) as the
    lane-batched GMRES hands them over, a (k, nv, no) view of (k, N)
    Krylov rows, on the operator ``V``'s plans (:func:`time_k4`)."""
    import torch

    dev = V["ijab"].device
    N = nv * NO + nv * nv * NO * NO
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = torch.randn((k, N), generator=g, dtype=torch.float64, device=dev)
    T = rows[:, :nv * NO].reshape(k, nv, NO)
    return time_k4(V["_ovvv_plans"], T, f"{label}, {k * NO} columns")


def solve_ccsd_fixed(q, twin, max_iter=60):
    """ms/iteration of ``max_iter + 1`` matrix-free CCSD iterations with the
    non-canonical Fock (host clock, synchronised)."""
    import torch

    from pymes_tpu_torch.solver import ccsd

    fock = q["focks"]["non-canonical"]
    T1 = torch.zeros((q["nv"], NO), dtype=torch.float64, device=fock.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ccsd.ccsd_solve(fock, q["mf_dict"], NO, T1,
                          q["T2_0"]["non-canonical"], level_shift=-1.0,
                          delta_e=-1.0, max_iter=max_iter,
                          ladder_all=q["plan_all"], twin=twin)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / out[4], out[4]


def load_molecule(name, device):
    """(no, Fock, V, HF energy, solve options) of one molecule of
    ``MOLECULES`` through the port's own FCIDUMP and TCDUMP readers and
    3-body contractions, on ``device``."""
    import torch

    from pymes_tpu_torch.integral import contraction
    from pymes_tpu_torch.mean_field import hf
    from pymes_tpu_torch.util import fcidump, tcdump

    fdump, tdump = MOLECULES[name][:2]
    n_elec, _, e_core, _, h, V = fcidump.read(str(DATA / fdump),
                                              is_tc=tdump is not None)
    no = n_elec // 2
    h = torch.as_tensor(h, device=device)
    Vt = torch.as_tensor(V, device=device)
    hf_e = float(hf.calc_hf_e(no, e_core, h, Vt))
    fock = hf.construct_hf_matrix(no, h, Vt)
    kw = {}
    if tdump is not None:
        L = tcdump.read(str(DATA / tdump))
        hf_e += contraction.get_triple_contraction(no, L)
        fock = fock + torch.as_tensor(
            contraction.get_double_contraction(no, L), device=device)
        Vt = Vt + torch.as_tensor(
            contraction.get_single_contraction(no, L), device=device)
        kw["delta_e"] = 1e-11
    return {"no": no, "fock": fock, "V": Vt, "hf_e": hf_e, "kw": kw}


def compare_molecular_kernels(mols, seed):
    """K2′/K3′ vs their twins at each molecule's shapes (e.g. LiH/3-21G
    no=2, nv=9; H₂/STO-6G no=1, nv=1, so one program holds both segments),
    with the molecule's orbital energies and V_ijab; returns max abs
    errors."""
    e_k2 = e_k3 = 0.0
    for name, m in mols.items():
        no = m["no"]
        eps = m["fock"].diagonal()
        x = tail_inputs(no, m["V"][:no, :no, no:, no:], seed)
        k2, k3 = compare_ccsd_tail(x, eps[:no].contiguous(),
                                   eps[no:].contiguous(), name)
        print(f"kernel vs twin, {name} (no={no}, nv={x['T1'].shape[0]}): "
              f"ccsd_jacobi_diis max_abs_err={k2:.3e}, ccsd_mix_energy "
              f"max_abs_err={k3:.3e}", flush=True)
        e_k2, e_k3 = max(e_k2, k2), max(e_k3, k3)
    return {"ccsd_jacobi_diis": e_k2, "ccsd_mix_energy": e_k3}


def molecular_ccsd(mols, device):
    """Dense CCSD on the four molecules of :func:`load_molecule`, each
    against its oracle; returns each energy by name."""
    import torch

    from pymes_tpu_torch.solver import ccsd

    out = {}
    for name, m in mols.items():
        e_ref, hf_ref, tol = MOLECULES[name][2:]
        t0 = time.time()
        no, fock, hf_e = m["no"], m["fock"], m["hf_e"]
        if hf_ref is not None:
            check(abs(hf_e - hf_ref) <= 1e-8,
                  f"{name}: HF {hf_e} vs oracle {hf_ref}")
        res = ccsd.CCSD(no, device=device).solve(fock, m["V"], **m["kw"])
        e = out[name] = res["ccsd e"]
        check(bool(torch.isfinite(res["t2"]).all())
              and res["t1"].shape == (fock.shape[0] - no, no),
              f"{name}: amplitudes not finite or of the wrong shape")
        check(abs(e - e_ref) <= tol,
              f"{name}: CCSD E={e} vs oracle {e_ref} (tol {tol})")
        print(f"CCSD {name}: E={e:.13f} in {len(res['e history'])} "
              f"iterations, |E - oracle|={abs(e - e_ref):.2e} (tol {tol})"
              + (f", HF |E - oracle|={abs(hf_e - hf_ref):.2e}"
                 if hf_ref is not None else "")
              + f", {time.time() - t0:.2f} s", flush=True)
    return out


def mf_ccsd(q, device):
    """Matrix-free CCSD at nP=219: canonical (T1 ≡ 0, E = the CCD energy)
    and the seeded non-canonical Fock (against the JAX package), each
    solve's K4 launches held to its n iterations: 4n gathers and 2n fused
    traces (the dressing's G_vv); returns each solve's result by kind."""
    import torch

    from pymes_tpu_torch import kernels
    from pymes_tpu_torch.solver import ccsd

    out = {}
    for kind, fock in q["focks"].items():
        t0 = time.time()
        before = dict(kernels.LAUNCHES)
        res = out[kind] = ccsd.CCSD(NO, device=device).solve(
            fock, q["mf_dict"], level_shift=-1.0, ladder=q["plan_all"],
            delta_e=1e-10 if kind == "non-canonical" else 1e-8,
            max_iter=100)
        res["wall"] = time.time() - t0
        e, n_it = res["ccsd e"], len(res["e history"])
        k4 = {k: kernels.LAUNCHES[k] - before[k]
              for k in ("ovvv_gather", "ovvv_gather_diag")}
        check(k4 == {"ovvv_gather": 4 * n_it, "ovvv_gather_diag": 2 * n_it},
              f"mf-CCSD {kind}: K4 launches {k4} for {n_it} iterations")
        t1max = float(res["t1"].abs().max())
        check(res["t2"].shape == (q["nv"], q["nv"], NO, NO)
              and bool(torch.isfinite(res["t2"]).all())
              and bool(torch.isfinite(res["t1"]).all()),
              f"mf-CCSD {kind}: amplitudes not finite or of the wrong shape")
        if kind == "canonical":
            ref = E_JAX[q["cutoff"]]
            check(t1max <= 1e-12, f"canonical |T1|max = {t1max:.3e}")
        else:
            ref = E_JAX_CCSD_NONCANONICAL
            check(t1max > 1e-4, f"non-canonical |T1|max = {t1max:.3e}")
            check(n_it == N_IT_JAX_CCSD_NONCANONICAL,
                  f"non-canonical took {n_it} iterations, the JAX package "
                  f"{N_IT_JAX_CCSD_NONCANONICAL}")
        check(abs(e - ref) <= 1e-9,
              f"mf-CCSD {kind} nP={q['nP']}: E={e:.13f} vs {ref}")
        print(f"mf-CCSD {kind} nP={q['nP']}: E={e:.13f} in {n_it} "
              f"iterations, |E - ref|={abs(e - ref):.2e}, |T1|max="
              f"{t1max:.3e}, {time.time() - t0:.2f} s", flush=True)
    return out


def eom_operator(p, device, plan_all=None, plans=None):
    """The matrix-free no-ovvv EOM operator of one UEG set-up: the small
    blocks, no ``abcd``, the all-bra ladder plan and the OVVV plans."""
    from pymes_tpu_torch.ops import ueg_ladder

    V = {k: p["dict"][k] for k in EOM_KEYS}
    V["abcd"] = None
    V["abcd_ladder"] = plan_all or ueg_ladder.build_block_ladder(
        p["ueg"], device=device, bra="all")
    V["_ovvv_plans"] = plans or ueg_ladder.build_ovvv_plans(
        p["ueg"], device=device)
    return V


def eom_inputs(V, nv, seed):
    """Seeded K5/K6 operands and a trial batch at the EOM shapes of one
    set-up (n_excit = 2, max_dim = 16): X, Y (2, nv, nv, no, no), the
    Davidson buffers U, W (16, N) with v (16, 2), e (2,) and diag (N,)
    (three denominators inside the clamp), U1 (2, nv, no) the singles view
    of U's first two rows (the sigma's trial batch, read in place)."""
    import torch

    rng = np.random.default_rng(seed)
    dev = V["ijab"].device
    N = nv * NO + nv * nv * NO * NO

    def t(shape, scale=1.0):
        return torch.as_tensor(rng.standard_normal(shape) * scale,
                               dtype=torch.float64, device=dev)

    e = t(2) + 5.0
    diag = t(N) + 5.0
    diag[:3] = e[0] + torch.tensor([0.0, 3e-6, -4e-6], dtype=torch.float64,
                                   device=dev)
    U = t((16, N))
    return {"X": t((2, nv, nv, NO, NO), 0.01), "Y": t((2, nv, nv, NO, NO),
                                                      0.01),
            "U": U, "W": t((16, N)), "v": t((16, 2)), "e": e,
            "diag": diag, "U1": U[:2, :nv * NO].reshape(2, nv, NO)}


def compare_eom_kernels(q, V, seed):
    """K5 at the CCD (ijab, with Y) and the EOM (abij batch of 2, with and
    without Y) shapes, K6 at the EOM buffer shapes (all 16 rows and 9), and
    the batched cd-major K1 and batched K4 (bit for bit) entries, against
    their twins at nP=219; returns max abs errors."""
    from pymes_tpu_torch.kernels import davidson, pair_sym
    from pymes_tpu_torch.ops import ueg_ladder

    x = eom_inputs(V, q["nv"], seed)
    ij = inputs(q, seed)
    e5 = max(bit_equal(pair_sym.pair_symmetrize(ij["T"], ij["R"]),
                       pair_sym.pair_symmetrize(ij["T"], ij["R"], twin=True),
                       "K5 ijab with Y"),
             *(bit_equal(pair_sym.pair_symmetrize(X, Y),
                         pair_sym.pair_symmetrize(X, Y, twin=True),
                         f"K5 abij batch of {X.shape[0]}, Y={Y is not None}")
               for X in (x["X"], x["X"][:1]) for Y in (None, X + 1.0)))
    e6 = 0.0
    for m in (16, 9):
        U, W = x["U"].clone(), x["W"].clone()
        U[m:], W[m:] = 0.0, 0.0
        v = x["v"].clone()
        v[m:] = 0.0
        args = (U, W, v, x["e"], x["diag"], m)
        got = davidson.davidson_residual(*args)
        want = davidson.davidson_residual(*args, twin=True)
        # the three clamped columns are ~1e5 larger than the rest: each
        # part is held to 1e-12 of its own scale
        e6 = max(e6, rel_err(got[:, :3], want[:, :3],
                             f"K6 m={m}, clamped columns"),
                 rel_err(got[:, 3:], want[:, 3:], f"K6 m={m}, the rest"))
    e1 = rel_err(ueg_ladder.ladder_apply(V["abcd_ladder"], x["X"]),
                 ueg_ladder.ladder_apply(V["abcd_ladder"], x["X"],
                                         twin=True),
                 "K1 cd-major batch (nv^2, 2 no^2)")
    e4 = max(bit_equal(ueg_ladder.ovvv_t1_apply(plan, x["U1"]),
                       ueg_ladder.ovvv_t1_apply(plan, x["U1"], twin=True),
                       f"K4 EOM batch of 2, {pat}")
             for pat, plan in V["_ovvv_plans"].items())
    errs = {"pair_symmetrize": e5, "davidson_residual": e6,
            "block_ladder": e1, "ovvv_gather": e4}
    print(f"kernel vs twin, EOM nP={q['nP']}: " + ", ".join(
        f"{k} max_abs_err={v:.3e}" for k, v in errs.items()), flush=True)
    return errs


def time_eom_kernels(q, V, seed):
    """ms per call of K5 (abij batch of 2, the EOM sigma's operand; and
    ijab with Y, the CCD/CCSD residual's) and K6 (16 valid rows, k = 2)
    and of their twins at nP=219 (plain, kernel, kernel, plain); of K5's
    library yardstick, one ``torch.add`` of X and its strided partner view
    (the twin without Y); and K4 on the sigma's batch of 2 trials
    (:func:`time_k4`)."""
    import torch

    from pymes_tpu_torch.kernels import davidson, pair_sym

    x = eom_inputs(V, q["nv"], seed)
    ij = inputs(q, seed)
    calls = {
        "pair_symmetrize": lambda tw: pair_sym.pair_symmetrize(x["X"],
                                                               twin=tw),
        "pair_symmetrize ijab+Y": lambda tw: pair_sym.pair_symmetrize(
            ij["T"], ij["R"], twin=tw),
        "davidson_residual": lambda tw: davidson.davidson_residual(
            x["U"], x["W"], x["v"], x["e"], x["diag"], 16, twin=tw),
    }
    out = {}
    for name, fn in calls.items():
        t = [cuda_ms(lambda: fn(tw)) for tw in (True, False, False, True)]
        out[name] = ((t[1] + t[2]) / 2, (t[0] + t[3]) / 2)
    X = x["X"]

    def lib():
        return torch.add(X, X.transpose(-4, -3).transpose(-2, -1))

    out["pair_symmetrize library"] = cuda_ms(lib)
    # the kernels alone, without the host time between launches
    out["pair_symmetrize device"] = card_ms(
        lambda: calls["pair_symmetrize"](False), "pair_sym")
    out["pair_symmetrize ijab+Y device"] = card_ms(
        lambda: calls["pair_symmetrize ijab+Y"](False), "pair_sym")
    out["pair_symmetrize library device"] = card_ms(lib, "elementwise")
    out["ovvv_gather EOM batch"] = time_k4(V["_ovvv_plans"], x["U1"],
                                           "EOM batch of 2, 14 columns")
    return out


def time_ladder(p14, q, plan57, seed):
    """K1 per call beside its twin (plain, kernel, kernel, plain) at the
    widths its callers give it: the cd-major kernel alone at the CCD
    path's N = no² (with the even row stride of the ijab entry's copy),
    the mf-CCSD stacked operand through the ijab entry (N = 2 no²,
    all-bra plan), the EOM sigma's batch of 2 on the cd-major entry
    (N = 2 no²) and the FEAST nP=57 sigma on 2·64 lanes (N = 128 no²,
    the nP=57 all-bra plan), each held to its twin first; and K5 bit for
    bit at the FEAST sigma's (2·64, nv, nv, no, no) operand.  Returns
    ({label: (ms, plain_ms, bound, device_ms)}, max abs errors)."""
    import torch

    from pymes_tpu_torch.kernels import block_ladder as k1
    from pymes_tpu_torch.kernels import pair_sym
    from pymes_tpu_torch.ops import ueg_ladder

    rng = np.random.default_rng(seed)
    dev = p14["fock"].device

    def operand(plan, n, ld):
        nv2 = plan.nv ** 2
        return torch.as_tensor(rng.standard_normal((nv2, ld)) * 0.01,
                               device=dev)[:, :n]

    virt, full = p14["blocks"].ladder, q["plan_all"]
    n2 = NO * NO
    T49, T98 = operand(virt, n2, n2 + 1), operand(full, 2 * n2, 2 * n2)
    T6272 = operand(plan57, 128 * n2, 128 * n2)
    TX = torch.as_tensor(rng.standard_normal((2, n2, q["nv"], q["nv"]))
                         * 0.01, device=dev)
    cases = {
        "cd-major, N = no^2": (
            lambda tw: k1.block_ladder_cd(virt, T49, twin=tw),
            ladder_bound(virt, n2)),
        "mf-CCSD stacked operand (ijab entry), N = 2 no^2": (
            lambda tw: ueg_ladder.block_ladder_apply_ij(full, TX, twin=tw),
            ladder_bound(full, 2 * n2)),
        "EOM batch of 2 (cd-major), N = 2 no^2": (
            lambda tw: k1.block_ladder_cd(full, T98, twin=tw),
            ladder_bound(full, 2 * n2)),
        "FEAST nP=57 lanes (cd-major), N = 128 no^2": (
            lambda tw: k1.block_ladder_cd(plan57, T6272, twin=tw),
            ladder_bound(plan57, 128 * n2)),
    }
    out, e1 = {}, 0.0
    for label, (fn, b) in cases.items():
        e1 = max(e1, rel_err(fn(False), fn(True), f"K1 {label}"))
        t = [cuda_ms(lambda: fn(tw)) for tw in (True, False, False, True)]
        out[label] = ((t[1] + t[2]) / 2, (t[0] + t[3]) / 2, b,
                      card_ms(lambda: fn(False), "block_ladder"))
    x = inputs(p14, seed)
    out["ijab entry, N = no^2 (the CCD path), K1 alone"] = card_ms(
        lambda: ueg_ladder.block_ladder_apply_ij(virt, x["T"]),
        "block_ladder")
    X = torch.as_tensor(rng.standard_normal(
        (128, plan57.nv, plan57.nv, NO, NO)) * 0.01, device=dev)
    e5 = bit_equal(pair_sym.pair_symmetrize(X),
                   pair_sym.pair_symmetrize(X, twin=True),
                   "K5 FEAST nP=57 sigma batch of 2·64 lanes")
    errs = {"block_ladder": e1, "pair_symmetrize": e5}
    print("kernel vs twin at the time_ladder shapes: " + ", ".join(
        f"{k} max_abs_err={v:.3e}" for k, v in errs.items()), flush=True)
    return out, errs


def time_sharded(q, plans, seed):
    """The sector-sharded K1 apply at N = no² (4 launches plus the row
    copies home) beside K1 on the whole plan and the sharded twin
    (whole, sharded, sharded, whole; the twin alone); ms per call."""
    import torch

    from pymes_tpu_torch.ops import ueg_ladder

    T = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (NO, NO, q["nv"], q["nv"])) * 0.01, device=q["fock"].device)
    sh, whole = plans["virtual"], q["blocks"].ladder
    t = [cuda_ms(lambda: ueg_ladder.block_ladder_apply_ij(p, T))
         for p in (whole, sh, sh, whole)]
    twin = cuda_ms(lambda: ueg_ladder.block_ladder_apply_ij(sh, T,
                                                            twin=True))
    return (t[1] + t[2]) / 2, (t[0] + t[3]) / 2, twin


def eom_solver(no, device):
    """An EOM_CCSD (n_excit = 2, the defaults: max_dim 16, f64, MOM) that
    counts in ``n_sigma`` the calls of the ``_batched_sigma`` hook, which
    every sigma of a solve goes through."""
    from pymes_tpu_torch.solver import eom_ccsd

    class Counted(eom_ccsd.EOM_CCSD):
        n_sigma = 0

        def _batched_sigma(self, *args):
            self.n_sigma += 1
            return super()._batched_sigma(*args)

    return Counted(no, device=device, n_excit=2)


def eom_solve(fock, V, T2, device, max_iter=300, twin=False, eps=None,
              no=NO):
    """EOM-CCSD through :func:`eom_solver`; returns the solver and its
    sorted real roots."""
    solver = eom_solver(no, device)
    solver.max_iter = max_iter
    solver.twin = twin
    if eps is not None:
        solver.e_epsilon = eps
    roots = np.sort(np.real(solver.solve(fock, V, T2)))
    return solver, roots


def lih_dressed(m, device):
    """The LiH EOM input: converged CCSD (|dE| < 1e-12), then the
    T1-dressed Fock and operator; returns (Fock, V, T2)."""
    from pymes_tpu_torch.integral.partition import part_2_body_int
    from pymes_tpu_torch.solver import ccsd

    cc = ccsd.CCSD(m["no"], device=device)
    res = cc.solve(m["fock"], m["V"], delta_e=1e-12, max_iter=200)
    dV = part_2_body_int(m["no"], m["V"])
    return (cc.get_T1_dressed_fock(m["fock"], res["t1"], dV),
            cc.get_T1_dressed_V(res["t1"], dV,
                                {k: None for k in ccsd.EOM_DRESSED}),
            res["t2"])


def check_eom_launches(label, before, solver, ladder):
    """The launches of one EOM solve against its count n of sigma calls:
    K5 once per sigma; K6 n − 1 times (each Davidson step ends in one
    sigma, and the solve's first sigma precedes every step); on the
    matrix-free operator (``ladder``) K1 once per sigma plus once for
    H̄'s W_laji, and K4 three times per sigma (ovv, vov, vvo); never K4's
    fused trace, which only the CCSD dressing runs."""
    from pymes_tpu_torch import kernels

    n = solver.n_sigma
    got = {k: kernels.LAUNCHES[k] - before[k]
           for k in EOM_KERNELS + ("ovvv_gather_diag",)}
    want = {"block_ladder": n + 1 if ladder else 0,
            "ovvv_gather": 3 * n if ladder else 0, "ovvv_gather_diag": 0,
            "pair_symmetrize": n, "davidson_residual": n - 1}
    check(n > 1 and got == want,
          f"EOM {label}: launches {got}, expected {want} for {n} sigma calls")


def eom_runs(cases, lih, device, walls=None):
    """The EOM path: each UEG case (label, fock, operator, T2, JAX roots,
    JAX iterations) against the JAX package, then LiH on the dressed CCSD
    operator ``lih`` = (Fock, V, T2) against its oracle; each solve's
    launches against its sigma calls.  Returns the roots by label; each
    solve's wall (s) goes into ``walls`` by label ("LiH" for LiH)."""
    walls = {} if walls is None else walls
    import torch

    from pymes_tpu_torch import kernels

    out = {}
    for label, fock, V, T2, ref, n_ref in cases:
        t0 = time.time()
        before = dict(kernels.LAUNCHES)
        solver, roots = eom_solve(fock, V, T2, device)
        check_eom_launches(label, before, solver, ladder=True)
        nv = T2.shape[0]
        check(all(bool(torch.isfinite(u).all()) for u in
                  solver.u_singles + solver.u_doubles)
              and solver.u_singles[0].shape == (nv, NO)
              and solver.u_doubles[0].shape == (nv, nv, NO, NO),
              f"EOM {label}: Ritz vectors not finite or of the wrong shape")
        err = float(np.abs(roots - np.asarray(ref)).max())
        n_it = solver.n_iterations
        check(err <= 1e-8, f"EOM {label}: roots {roots} vs JAX {ref}")
        check(abs(n_it - n_ref) <= 1,
              f"EOM {label}: {n_it} iterations, the JAX package {n_ref}")
        walls[label] = time.time() - t0
        print(f"EOM {label}: roots {roots[0]:.13f} {roots[1]:.13f} in {n_it} "
              f"iterations (JAX {n_ref}), |roots - JAX|={err:.2e}, "
              f"{walls[label]:.2f} s", flush=True)
        out[label] = roots

    t0 = time.time()
    fd, Vd, t2 = lih
    before = dict(kernels.LAUNCHES)
    solver, roots = eom_solve(fd, Vd, t2, device, max_iter=1000,
                              no=t2.shape[-1])
    check_eom_launches("LiH", before, solver, ladder=False)
    err = float(np.abs(roots - np.asarray(LIH_EOM_ORACLE)).max())
    check(err <= 1e-7, f"EOM LiH: roots {roots} vs oracle {LIH_EOM_ORACLE}")
    walls["LiH"] = time.time() - t0
    print(f"EOM LiH/3-21G: roots {roots[0]:.13f} {roots[1]:.13f} in "
          f"{solver.n_iterations} iterations, |roots - oracle|={err:.2e}, "
          f"{walls['LiH']:.2f} s", flush=True)
    return out


def eom_ms_per_iter(fock, V, T2, device, twin, n=8):
    """ms per Davidson iteration at one set-up: the host wall (synchronised)
    of a solve of 2 + n iterations minus that of a solve of 2 (the set-up
    cancels), over n; with no stopping test (``e_epsilon`` < 0), so a
    restart at max_dim falls inside the n."""
    import torch

    walls = []
    for n_iter in (2, 2 + n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eom_solve(fock, V, T2, device, max_iter=n_iter, twin=twin, eps=-1.0)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return (walls[1] - walls[0]) * 1e3 / n


def path_launches(label, run, expect):
    """Run one main path with the launch counts reset just before and read
    just after; every kernel in ``expect`` must have launched."""
    from pymes_tpu_torch import kernels

    kernels.reset_launches()
    run()
    launches = dict(kernels.LAUNCHES)
    print(f"launches on the {label} path: {launches}", flush=True)
    for name in expect:
        check(launches[name] > 0,
              f"kernel {name} never launched on the {label} path")
    return launches


def solve_fixed(p, twin, max_iter=60, blocks=None, ring_mesh=None):
    """ms/iteration of ``max_iter + 1`` CCD iterations (host clock,
    synchronised), on ``p``'s blocks or on ``blocks`` (the ring path with
    ``ring_mesh``).  Returns (ms/iteration, iterations, final energy)."""
    import torch

    from pymes_tpu_torch.solver import ccd

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ccd.ccd_solve(p["fock"], blocks or p["blocks"], NO, p["T0"],
                        level_shift=-1.0, delta_e=-1.0, max_iter=max_iter,
                        twin=twin, ring_mesh=ring_mesh)
    torch.cuda.synchronize()
    return ((time.perf_counter() - t0) * 1e3 / out[5], out[5],
            float(out[0]))


def kernel_bounds(p14, q, krylov, ring):
    """Bytes and flops of each kernel's timed call (the shapes of the
    ``ms`` column of the JSON line), from this run's inputs, through the
    helpers of ``util/roofline.py``: K1-K6 at nP=219, K7/K8 at the FEAST
    nP=57 lane shape of ``krylov`` (La lanes, m valid rows, rows of n), K9
    at the nP=219 ring step of ``ring`` (M, N, K).  The kernels other than
    K1 and K9 run on the CUDA cores: their operations count at the FMA
    rate."""
    nv = p14["nv"]
    n = NO * NO * nv * nv                      # one T2
    nc = nv * NO + n                            # the CCSD carry [T1 | T2]
    plans = q["mf_dict"]["_ovvv_plans"]
    gathers = [gather_bound(p, nv, NO) for p in plans.values()]
    traces = [diag_bound(plans[pat], nv, NO) for pat, _ in DIAG_PLANS]
    La, m, n2 = krylov["La"], krylov["m"], krylov["n"]
    fma = roofline.FP64_FMA_FLOPS_S
    return {
        # T read, R written, the plan's blocks and index arrays read once
        "block_ladder": ladder_bound(p14["blocks"].ladder, NO * NO),
        # R, T and the 5 other valid error rows read; 2 ring rows written
        "ccd_jacobi_diis": bound(8 * 9 * n, 17 * n, fma),
        # 6 ring rows, V and Vx read; T written
        "ccd_mix_energy": bound(8 * 9 * n, 16 * n, fma),
        # the mean over the OVVV plans at the dressing's NO columns
        "ovvv_gather": (float(np.mean([b[0] for b in gathers])),
                        gathers[0][1]),
        # the mean over the traced plans
        "ovvv_gather_diag": (float(np.mean([b[0] for b in traces])),
                             traces[0][1]),
        "ccsd_jacobi_diis": bound(8 * 9 * nc, 17 * nc, fma),
        "ccsd_mix_energy": bound(8 * 9 * nc, 16 * nc, fma),
        # EOM sigma operand (2, nv, nv, no, no): X read, out written
        "pair_symmetrize": bound(8 * 2 * 2 * n, 2 * n, fma),
        # the CCD/CCSD residual (no, no, nv, nv): X and Y read, out written
        "pair_symmetrize ijab+Y": bound(8 * 3 * n, 2 * n, fma),
        # 16 valid rows of U and W, diag read; k = 2 rows written
        "davidson_residual": bound(8 * (2 * 16 * nc + nc + 2 * nc),
                                   2 * nc * (4 * 16 + 4), fma),
        # the m valid basis rows and w read, row m written (CGS2 itself
        # must read V three times: krylov_bounds' floor_ms)
        "arnoldi_cgs2": krylov_bounds(La, m, n2)["bound"],
        # H (2La, N), x (La, 2N), diag read; the pair (La, 2N) written
        "shifted_precond": bound(8 * (3 * La * n2 + n2 // 2), 20 * La * n2,
                                 fma),
        "ring_step": ring_bound(ring),
    }


def ring_mesh(nv, device):
    """The ring's mesh for ``nv`` virtual orbitals: the largest count ≤ 8
    that divides nv (the JAX tests' choice), all on one card."""
    from pymes_tpu_torch.parallel import mesh

    P = mesh.largest_dividing_mesh(nv, 8)
    return mesh.make_mesh(P, device=device, devices=[device] * P)


def ring_inputs(nv, P, seed, device):
    """Seeded K9 operands at one ring shape: shard 0's V block (nv/P, nv,
    nv, nv) and the held T shard and R of both layouts, (T, R) ijab
    (no, no, nv/P, nv) and abij (nv/P, nv, no, no)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    csz = nv // P

    def r(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64,
                           device=device)

    return {"V": r(csz, nv, nv, nv), "P": P,
            "ijab": (r(NO, NO, csz, nv), r(NO, NO, csz, nv)),
            "abij": (r(csz, nv, NO, NO), r(csz, nv, NO, NO))}


def ring_views(layout, T, R):
    """K9's (M, K) and (M, N) views: row-major for ijab, the transposed
    views of the cd-major abij tensors (no copy)."""
    if layout == "ijab":
        return T.view(NO * NO, -1), R.view(NO * NO, -1)
    return T.view(-1, NO * NO).t(), R.view(-1, NO * NO).t()


def compare_ring_step(x, label):
    """K9 vs its twin at every panel offset src of shard 0 and at the odd
    (not 16-byte aligned) offset 1, both layouts, accumulating into the
    seeded R: the products (R − R0) compared."""
    from pymes_tpu_torch.kernels import ring_step

    V, P = x["V"], x["P"]
    csz, nv = V.shape[:2]
    Vm = V.view(csz * nv, nv * nv)
    err = 0.0
    for layout in ("ijab", "abij"):
        T, R0 = x[layout]
        for c0 in [src * csz * nv for src in range(P)] + [1]:
            prods = []
            for twin in (False, True):
                R = R0.clone()
                Tv, Rv = ring_views(layout, T, R)
                ring_step.ring_step(Rv, Tv, Vm, c0, twin=twin)
                prods.append(R - R0)
            err = max(err, rel_err(*prods, f"K9 {layout} c0={c0}, {label}"))
    print(f"kernel vs twin, {label} ({P} shards, M={NO * NO}, N=K="
          f"{csz * nv}): ring_step max_abs_err={err:.3e}", flush=True)
    return err


# K9 edge shapes: (M, N, K, row length L of V, panel offset c0, layout);
# M off the 16-row DMMA tile, N and K off the 128/32 column and 32-deep
# stage tiles, odd offsets and odd row strides (8-byte copies), one split
# and several (the planner's choice for the shape)
RING_EDGES = ((9, 100, 37, 101, 3, "ijab"), (9, 100, 37, 101, 3, "abij"),
              (57, 300, 129, 400, 7, "ijab"), (113, 1000, 999, 2001, 1,
                                              "abij"),
              (49, 2000, 3001, 3002, 1, "ijab"), (49, 4000, 4000, 8000, 2,
                                                  "abij"))


def compare_ring_edges(seed, device):
    """K9 vs its twin at the RING_EDGES shapes on seeded operands (R of
    the abij form through a transposed view), each kernel result also
    bit-equal to a second launch; returns the max relative error."""
    import torch

    from pymes_tpu_torch.kernels import ring_step

    g = torch.Generator(device=device).manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64,
                           device=device)

    err, plans = 0.0, set()
    for M, N, K, L, c0, layout in RING_EDGES:
        V = r(N, L)
        T = r(M, K) if layout == "ijab" else r(K, M).t()
        R0 = r(M, N) if layout == "ijab" else r(N, M).t()
        got = [R0.clone() for _ in range(2)]
        for R in got:
            ring_step.ring_step(R, T, V, c0)
        want = ring_step.ring_step(R0.clone(), T, V, c0, twin=True)
        torch.cuda.synchronize()
        what = f"K9 edge M={M} N={N} K={K} L={L} c0={c0} {layout}"
        check(torch.equal(got[0], got[1]), f"{what}: a rerun changed the "
              "bits")
        err = max(err, rel_err(got[0] - R0, want - R0, what))
        plans.add(ring_step.plan(M, N, K, torch.cuda.get_device_properties(
            device).multi_processor_count))
    check(any(s == 1 for _, s in plans) and any(s > 1 for _, s in plans),
          f"K9 edge shapes ran the split plans {plans}: one split and "
          "several expected")
    print(f"kernel vs twin, K9 edge shapes ({len(RING_EDGES)}; plans "
          f"{sorted(plans)}): max_abs_err={err:.3e}, reruns bit-equal",
          flush=True)
    return err


def time_ring_step(x):
    """ms per call of K9 and of its twin (plain, kernel, kernel, plain) and
    of ``torch.addmm``, the one PyTorch call of the same function, at the
    ijab step on panel src = 1."""
    import torch

    from pymes_tpu_torch.kernels import ring_step

    V = x["V"]
    csz, nv = V.shape[:2]
    Vm = V.view(csz * nv, nv * nv)
    T, R = x["ijab"]
    Tv, Rv = ring_views("ijab", T, R.clone())
    c0, K = csz * nv, Tv.shape[1]
    t = [cuda_ms(lambda: ring_step.ring_step(Rv, Tv, Vm, c0, twin=tw))
         for tw in (True, False, False, True)]
    lib = cuda_ms(lambda: torch.addmm(Rv, Tv, Vm[:, c0:c0 + K].t()))
    return (t[1] + t[2]) / 2, (t[0] + t[3]) / 2, lib, {
        "M": Tv.shape[0], "N": Rv.shape[1], "K": K}


def ring_setup(p, device):
    """The dense ``abcd`` of one set-up scattered on the card and cut over
    its ring mesh; returns (mesh, CCD blocks with the cut abcd)."""
    import torch

    from pymes_tpu_torch.models import ueg
    from pymes_tpu_torch.parallel import mesh as pmesh

    t0 = time.time()
    m = ring_mesh(p["nv"], device)
    abcd = ueg.sparse_to_blocks(*p["sparse"], p["nP"], NO, device=device,
                                names=("abcd",))["abcd"]
    blocks = p["blocks"]._replace(
        abcd=pmesh.shard_blocks(m, {"abcd": abcd})["abcd"], ladder=None)
    torch.cuda.synchronize()
    P = m.shape["a"]
    print(f"ring set-up nP={p['nP']}: dense abcd {abcd.numel() * 8 / 1e9:.2f}"
          f" GB on the card, {P} shards of {abcd.shape[0] // P} rows "
          f"({time.time() - t0:.2f} s)", flush=True)
    return m, blocks


def ring_ccd(p, m, blocks, n_ref, device):
    """Phase 16 at one set-up: CCD with the ring ladder to |dE| < 1e-8;
    E within 1e-9 of the JAX package (nP=57 also within 1e-8 of the
    oracle), the matrix-free solve's iteration count, and the launches
    held exactly: K9 P² per residual, K2/K3/K5 one per iteration, K1
    none.  Returns the peak device memory of the solve."""
    import torch

    from pymes_tpu_torch import kernels
    from pymes_tpu_torch.solver import ccd

    t0 = time.time()
    c, P = p["cutoff"], m.shape["a"]
    torch.cuda.reset_peak_memory_stats()
    before = dict(kernels.LAUNCHES)
    res = ccd.CCD(NO, device=device).solve(p["fock"], blocks, level_shift=-1.0,
                                           max_iter=60, ring_mesh=m)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    n_it, e, T = len(res["e history"]), res["ccd e"], res["t2 amp"]
    got = {k: kernels.LAUNCHES[k] - before[k]
           for k in RING_KERNELS + ("block_ladder",)}
    want = {"ring_step": P * P * n_it, "ccd_jacobi_diis": n_it,
            "ccd_mix_energy": n_it, "pair_symmetrize": n_it,
            "block_ladder": 0}
    check(got == want, f"ring CCD nP={p['nP']}: launches {got}, expected "
          f"{want} for {n_it} iterations on {P} shards")
    check(T.shape == (p["nv"], p["nv"], NO, NO)
          and bool(torch.isfinite(T).all()),
          f"ring CCD nP={p['nP']}: amplitudes not finite or of the wrong "
          "shape")
    check(abs(e - E_JAX[c]) <= 1e-9,
          f"ring CCD nP={p['nP']}: E={e:.13f} vs JAX {E_JAX[c]}")
    check(n_it == n_ref, f"ring CCD nP={p['nP']}: {n_it} iterations, the "
          f"matrix-free solve {n_ref}")
    if c == 5:
        check(abs(e - ORACLE_NP57) <= 1e-8,
              f"ring CCD nP=57: E={e} vs oracle {ORACLE_NP57}")
    print(f"ring CCD nP={p['nP']} ({P} shards of one card): E={e:.13f} in "
          f"{n_it} iterations (matrix-free {n_ref}), |E - E_jax|="
          f"{abs(e - E_JAX[c]):.2e}, launches {got}, peak device memory "
          f"{peak / 1e9:.3f} GB, {time.time() - t0:.2f} s", flush=True)
    return peak


def sharded_plans(q, device, seed):
    """Phase 17 set-up: the nP=219 virtual and all-bra plans built with
    ``pad_sectors=SECTOR_SHARDS`` and cut over that many shards of one
    card; K1 on each sharded plan must equal K1 on the padded and on the
    unpadded plan bit for bit (T2 and the CCSD's stacked operand).
    Returns the sharded plans by bra kind."""
    import torch

    from pymes_tpu_torch.ops import ueg_ladder
    from pymes_tpu_torch.parallel import mesh

    t0 = time.time()
    m = mesh.make_mesh(SECTOR_SHARDS, device=device,
                       devices=[device] * SECTOR_SHARDS)
    rng = np.random.default_rng(seed)
    nv = q["nv"]
    ops = [torch.as_tensor(rng.standard_normal(shape) * 0.01, device=device)
           for shape in ((NO, NO, nv, nv), (2, NO * NO, nv, nv))]
    out = {}
    for bra, whole in (("virtual", q["blocks"].ladder),
                       ("all", q["plan_all"])):
        padded = ueg_ladder.build_block_ladder(q["ueg"], device=device,
                                               bra=bra,
                                               pad_sectors=SECTOR_SHARDS)
        sh = out[bra] = ueg_ladder.shard_block_ladder(padded, m)
        for X in ops:
            got = ueg_ladder.block_ladder_apply_ij(sh, X)
            check(float(got.abs().max()) > 0, "sharded K1 output all zero")
            for ref, what in ((padded, "padded"), (whole, "unpadded")):
                want = ueg_ladder.block_ladder_apply_ij(ref, X)
                torch.cuda.synchronize()
                check(torch.equal(got, want),
                      f"sector-sharded K1 ({bra}, operand {tuple(X.shape)})"
                      f" differs from K1 on the {what} plan by "
                      f"{float((got - want).abs().max()):.3e}")
    print(f"sector-sharded plans nP={q['nP']} ({SECTOR_SHARDS} shards of one"
          " card): K1 bit-equal to K1 on the padded and the unpadded plans "
          f"(virtual and all-bra; T2 and the stacked CCSD operand), "
          f"{time.time() - t0:.2f} s", flush=True)
    return out


def sharded_mf(q, plans, device, results):
    """Phase 17: matrix-free CCD (within 1e-9 of the JAX package) and the
    seeded non-canonical matrix-free CCSD (within 1e-9, in the JAX
    package's 11 iterations) on the sector-sharded plans, each solve's
    launches held exactly: K1 SECTOR_SHARDS per ladder apply (one apply
    per iteration), K4 four per CCSD iteration and its fused trace two
    (the dressing's G_vv), the tail and K5 one."""
    import torch

    from pymes_tpu_torch import kernels
    from pymes_tpu_torch.solver import ccd, ccsd

    names = ("block_ladder", "ovvv_gather", "ovvv_gather_diag", "ring_step",
             "ccd_jacobi_diis", "ccd_mix_energy", "ccsd_jacobi_diis",
             "ccsd_mix_energy", "pair_symmetrize")
    for kind in ("CCD", "CCSD"):
        t0 = time.time()
        before = dict(kernels.LAUNCHES)
        if kind == "CCD":
            res = ccd.CCD(NO, device=device).solve(
                q["fock"], q["blocks"]._replace(ladder=plans["virtual"]),
                level_shift=-1.0, max_iter=60)
            e, ref, T = res["ccd e"], E_JAX[q["cutoff"]], res["t2 amp"]
        else:
            res = ccsd.CCSD(NO, device=device).solve(
                q["focks"]["non-canonical"], q["mf_dict"], level_shift=-1.0,
                ladder=plans["all"], delta_e=1e-10, max_iter=100)
            e, ref, T = res["ccsd e"], E_JAX_CCSD_NONCANONICAL, res["t2"]
            t1max = float(res["t1"].abs().max())
            check(t1max > 1e-4, f"sharded CCSD |T1|max = {t1max:.3e}")
        n = len(res["e history"])
        got = {k: kernels.LAUNCHES[k] - before[k] for k in names}
        tail = "ccd" if kind == "CCD" else "ccsd"
        want = dict.fromkeys(names, 0)
        want.update({"block_ladder": SECTOR_SHARDS * n,
                     f"{tail}_jacobi_diis": n, f"{tail}_mix_energy": n,
                     "pair_symmetrize": n,
                     "ovvv_gather": 4 * n if kind == "CCSD" else 0,
                     "ovvv_gather_diag": 2 * n if kind == "CCSD" else 0})
        check(got == want, f"sector-sharded {kind}: launches {got}, expected "
              f"{want} for {n} iterations")
        check(T.shape == (q["nv"], q["nv"], NO, NO)
              and bool(torch.isfinite(T).all()),
              f"sector-sharded {kind}: amplitudes not finite or misshapen")
        check(abs(e - ref) <= 1e-9,
              f"sector-sharded {kind} nP={q['nP']}: E={e:.13f} vs {ref}")
        if kind == "CCSD":
            check(n == N_IT_JAX_CCSD_NONCANONICAL,
                  f"sector-sharded CCSD took {n} iterations, the JAX package "
                  f"{N_IT_JAX_CCSD_NONCANONICAL}")
        print(f"sector-sharded mf-{kind} nP={q['nP']} ({SECTOR_SHARDS} "
              f"shards): E={e:.13f} in {n} iterations, |E - ref|="
              f"{abs(e - ref):.2e}, launches {got}, "
              f"{time.time() - t0:.2f} s", flush=True)
        results[kind] = e


def counted(cls, *args, **kw):
    """An instance of the solver class ``cls`` that counts in ``n_sigma``
    the calls of the ``_batched_sigma`` hook, which every sigma goes
    through."""
    class Counted(cls):
        n_sigma = 0

        def _batched_sigma(self, *a):
            self.n_sigma += 1
            return super()._batched_sigma(*a)

    return Counted(*args, **kw)


def add_stats(total, st):
    for k in ("chunks", "calls", "cycle_ends", "projections"):
        total[k] = total.get(k, 0) + st[k]
    for k in ("steps", "passes"):
        total[k] = total.get(k, []) + list(st[k])
    return total


def check_krylov_launches(label, before, n_sigma, st, ladder):
    """The launches of a FEAST/RT window against what its solves did.
    Per chunk of lanes the lane-batched GMRES makes one K8 pass for Mb,
    then per Arnoldi step one sigma, one K8 (apply) and one K7 (CGS2), per
    cycle end one fused K7 combine (x and r), and the honest residual
    makes one sigma and one K8 (residual mode); each FEAST iteration's
    projected H̄ is one more sigma without K8.  So K8 = sigma calls −
    projections + chunks, K7 = Arnoldi steps + cycle ends, K5 = sigma
    calls, and on
    the matrix-free operator K1 = sigma calls + 1 (H̄'s W_laji, built once
    per operator) and K4 = 3·sigma calls (its fused trace never)."""
    from pymes_tpu_torch import kernels

    got = {k: kernels.LAUNCHES[k] - before[k]
           for k in KRYLOV_KERNELS + ("ovvv_gather_diag",)}
    want = {"block_ladder": n_sigma + 1 if ladder else 0,
            "ovvv_gather": 3 * n_sigma if ladder else 0,
            "ovvv_gather_diag": 0,
            "pair_symmetrize": n_sigma,
            "arnoldi_cgs2": st["calls"] + st["cycle_ends"],
            "shifted_precond": n_sigma - st["projections"] + st["chunks"]}
    check(st["calls"] > 0 and got == want,
          f"{label}: launches {got}, expected {want} for {n_sigma} sigma "
          f"calls and {st}")


def krylov_inputs(La, R1, n, N1, seed, device, dtype=None):
    """Seeded K7/K8 operands at one lane shape, in ``dtype`` (float64 by
    default): a Krylov basis V (La, R1, n) of random rows (a torch
    generator on the card: 15 GB at nP=57 in f64), w and x pairs (La, n),
    sigma parts H1 (2La, N1), H2 (2La, n/2 − N1), shifts near the window,
    a diagonal and the two rows of combine coefficients C (La, 2, R1)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=g, dtype=dtype or torch.float64,
                           device=device)

    N = n // 2
    V = r(La, R1, n)
    V /= float(np.sqrt(n))
    return {"V": V, "w": r(La, n), "X": r(La, n), "B": r(La, n),
            "H1": r(2 * La, N1), "H2": r(2 * La, N - N1),
            "zr": r(La) * 0.01 + 5.24, "zi": r(La).abs() * 0.01 + 1e-3,
            "diag": r(N) + 5.0, "C": r(La, 2, R1),
            "lanes": torch.arange(La, device=device)}


def compare_krylov_kernels(x, label, ms):
    """K7 (projection at each m of ``ms`` for all lanes; the single
    combine at m + 1 with and without x0, and the fused two-output
    combine) and K8 (FEAST, RT and residual modes, preconditioner) against
    their twins on ``x``; the twin of K7 reads the rows below m that the
    kernel left untouched, and writes row m again.  K7's projection and
    fused combine are run twice and must repeat their bits.  Returns the
    max abs errors."""
    import torch

    from pymes_tpu_torch.kernels import arnoldi, shifted

    V, lanes = x["V"], x["lanes"]
    e7 = 0.0
    for m in ms:
        mt = torch.full_like(lanes, m)
        # a fresh w per m: the row that an earlier m wrote lies in the span
        # of w, and projecting w on it again leaves only rounding noise
        g = torch.Generator(device=V.device).manual_seed(1000 + m)
        w = torch.randn(x["w"].shape, generator=g, dtype=V.dtype,
                        device=V.device)
        hk = arnoldi.arnoldi_cgs2(V, w.clone(), lanes, mt)
        row_k = V[lanes, mt].clone()
        hk2 = arnoldi.arnoldi_cgs2(V, w.clone(), lanes, mt)
        torch.cuda.synchronize()
        check(torch.equal(hk, hk2) and torch.equal(row_k, V[lanes, mt]),
              f"K7 projection m={m}, {label}: a rerun changed the bits")
        ht = arnoldi.arnoldi_cgs2(V, w, lanes, mt, twin=True)
        # the projections h[:m] and the norm h[m] each at their own scale
        e7 = max(e7, rel_err(hk[:, :m], ht[:, :m], f"K7 h, m={m}, {label}"),
                 rel_err(hk[:, m], ht[:, m], f"K7 norm, m={m}, {label}"),
                 rel_err(row_k, V[lanes, mt], f"K7 row m={m}, {label}"))
        m1 = torch.full_like(lanes, min(m + 1, V.shape[1]))
        C0 = x["C"][:, 0].contiguous()
        for x0 in (None, x["X"]):
            e7 = max(e7, rel_err(
                arnoldi.krylov_combine(V, C0, m1, lanes, x0=x0),
                arnoldi.krylov_combine(V, C0, m1, lanes, x0=x0, twin=True),
                f"K7 combine m={m + 1}, x0={x0 is not None}, {label}"))
            got = arnoldi.krylov_combine_xr(V, x["C"], m1, lanes, x0=x0)
            again = arnoldi.krylov_combine_xr(V, x["C"], m1, lanes, x0=x0)
            want = arnoldi.krylov_combine_xr(V, x["C"], m1, lanes, x0=x0,
                                             twin=True)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"K7 fused combine m={m + 1}, {label}: a rerun changed "
                  "the bits")
            for out, a, b in zip("xr", got, want):
                e7 = max(e7, rel_err(a, b, f"K7 fused combine {out}, m="
                                     f"{m + 1}, x0={x0 is not None}, "
                                     f"{label}"))
    e8 = 0.0
    args = (x["H1"], x["H2"], x["X"], x["zr"], x["zi"], x["diag"])
    for mode, rt in (("apply", False), ("apply", True), ("residual", False),
                     ("residual", True), ("precond", False)):
        kw = dict(dt=0.1, rt=rt, mode=mode, B=x["B"])
        got = shifted.shifted_precond(*args, **kw)
        want = shifted.shifted_precond(*args, twin=True, **kw)
        if mode != "residual":
            got, want = (got,), (want,)
        for a, b in zip(got, want):
            e8 = max(e8, rel_err(a, b, f"K8 {mode} rt={rt}, {label}"))
    print(f"kernel vs twin, {label}: arnoldi_cgs2 max_abs_err={e7:.3e}, "
          f"shifted_precond max_abs_err={e8:.3e}", flush=True)
    return {"arnoldi_cgs2": e7, "shifted_precond": e8}


def time_krylov_kernels(x, m):
    """ms per call of K7 (all lanes at m valid rows: the projection and
    the fused combine, the latter also beside ``torch.baddbmm`` with a
    (La, 2, m) coefficient batch, the one PyTorch call of the same
    function) and K8 (FEAST apply) and of their twins."""
    import torch

    from pymes_tpu_torch.kernels import arnoldi, shifted

    V, lanes = x["V"], x["lanes"]
    mt = torch.full_like(lanes, m)
    w = x["w"].clone()
    args = (x["H1"], x["H2"], x["X"], x["zr"], x["zi"], x["diag"])
    calls = {
        "arnoldi_cgs2": lambda tw: arnoldi.arnoldi_cgs2(V, w, lanes, mt,
                                                        twin=tw),
        "krylov_combine": lambda tw: arnoldi.krylov_combine_xr(
            V, x["C"], mt, lanes, x0=x["X"], twin=tw),
        "shifted_precond": lambda tw: shifted.shifted_precond(*args,
                                                              twin=tw),
    }
    out = {}
    for name, fn in calls.items():
        t = [cuda_ms(lambda: fn(tw), n=10) for tw in (True, False, False,
                                                      True)]
        out[name] = ((t[1] + t[2]) / 2, (t[0] + t[3]) / 2)
    X0 = torch.stack([x["X"], torch.zeros_like(x["X"])], dim=1)
    out["krylov_combine library"] = cuda_ms(
        lambda: torch.baddbmm(X0, x["C"][:, :, :m], V[:, :m]), n=10)
    return out


def krylov_phase(label, shape, device):
    """Phase 11 at one lane shape (La lanes, R1 basis rows, pair length n,
    singles length N1, the valid-row counts ms): compare and time K7/K8;
    returns (max errors, per-call times)."""
    import torch

    La, R1, n, N1, ms = shape
    t0 = time.time()
    x = krylov_inputs(La, R1, n, N1, 11 + La, device)
    errs = compare_krylov_kernels(x, label, ms)
    times = time_krylov_kernels(x, ms[len(ms) // 2])
    del x
    torch.cuda.empty_cache()
    print(f"K7/K8 at {label} ({La} lanes, {R1} basis rows, 2N={n}): "
          f"{time.time() - t0:.2f} s", flush=True)
    return errs, times


def feast_run(fock, V, T2, device, cfg, gmres_cfg, no=NO):
    """FEAST through :func:`counted`; returns the solver and its roots."""
    from pymes_tpu_torch.solver import feast_eom_ccsd

    s = counted(feast_eom_ccsd.FEAST_EOM_CCSD, no, device=device, **cfg)
    s.ls_restart, s.ls_max_iter = gmres_cfg
    roots = np.sort_complex(np.asarray(s.solve(fock, V, T2)))
    return s, roots


def feast57(p5, V, T2, device, out):
    """Phase 12: the nP=57 window on the no-ovvv operator and the CCD
    amplitudes; every returned root inside the window must lie within
    1e-7 of the JAX Davidson level EOM_JAX[5], and the largest honest
    residual must be ≤ 1e-7."""
    from pymes_tpu_torch import kernels

    import torch

    t0 = time.time()
    before = dict(kernels.LAUNCHES)
    torch.cuda.reset_peak_memory_stats()
    s, roots = feast_run(p5["fock"], V, T2, device, FEAST57, FEAST57_GMRES)
    peak = torch.cuda.max_memory_allocated()
    st = s.ls_stats
    check_krylov_launches("FEAST nP=57", before, s.n_sigma, st, ladder=True)
    # one chunk of lanes per FEAST iteration, the first of all 16 x 4: its
    # first sigma gathers 2·64 trials, K4's 896 columns
    lanes = [len(np.atleast_1d(a)) for a in st["steps"]]
    check(st["chunks"] == s.n_iterations and lanes[0] == K4_LANES["FEAST"],
          f"FEAST nP=57: lanes per chunk {lanes} over {s.n_iterations} "
          "iterations")
    e_c, e_r = FEAST57["e_c"], FEAST57["e_r"]
    inside = roots[np.abs(roots.real - e_c) < e_r]
    outside = roots[np.abs(roots.real - e_c) >= e_r]
    level = EOM_JAX[5][0][0]
    dev = float(np.abs(inside - level).max()) if len(inside) else np.inf
    res = float(np.max(s.last_ls_residuals))
    check(len(inside) >= 1 and dev <= 1e-7,
          f"FEAST nP=57: roots {roots} vs the JAX level {level}")
    check(res <= 1e-7, f"FEAST nP=57: largest honest ls residual {res:.3e}")
    steps = np.concatenate([np.atleast_1d(a) for a in st["steps"]])
    print(f"FEAST nP=57: {len(inside)} roots in the window, max |root - "
          f"JAX level| = {dev:.2e}, outside the window {outside}, "
          f"{s.n_iterations} FEAST iterations, largest honest ls residual "
          f"{res:.2e}, Arnoldi steps per lane and FEAST iteration: mean "
          f"{steps.mean():.1f}, max {steps.max()}, lanes per chunk (one "
          f"chunk an iteration) {lanes}, walls per iteration "
          f"{[round(w, 3) for w in s.iter_walls]} s, peak device memory "
          f"{peak / 1e9:.3f} GB, {time.time() - t0:.2f} s", flush=True)
    out.update(solver=s, roots=roots, peak=peak)


def rt123_seed(device):
    """Phase 13 set-up, outside the counted window: nP=123 CCD, its
    no-ovvv operator and the port's Davidson (n_excit=2)."""
    from pymes_tpu_torch.solver import ccd

    t0 = time.time()
    p = setup(RT123["cutoff"], device)
    res = ccd.CCD(NO, device=device).solve(p["fock"], p["blocks"],
                                           level_shift=-1.0,
                                           max_iter=60)
    V = eom_operator(p, device)
    solver, roots = eom_solve(p["fock"], V, res["t2 amp"], device, eps=1e-10)
    err = abs(roots[0] - RT_RECORDED_NP123)
    check(err <= 1e-6, f"Davidson nP={p['nP']}: root {roots[0]} vs recorded "
          f"{RT_RECORDED_NP123}")
    print(f"Davidson nP={p['nP']}: roots {roots[0]:.13f} {roots[1]:.13f} in "
          f"{solver.n_iterations} iterations (recorded {RT_RECORDED_NP123}, "
          f"|diff|={err:.2e}), CCD E={res['ccd e']:.10f}, "
          f"{time.time() - t0:.2f} s", flush=True)
    u = (solver.u_singles[0].cpu().numpy(), solver.u_doubles[0].cpu().numpy())
    return p, V, res["t2 amp"], float(roots[0]), u


def rt123(p, V, T2, root, u0, device, out):
    """Phase 13: three CIF steps seeded with the Ritz vector; each step's
    phase energy angle(c_t/c_{t−1})/dt within 1e-7 of the root and unit
    norm to 1e-10."""
    from pymes_tpu_torch import kernels
    from pymes_tpu_torch.solver import rt_eom_ccsd

    dt = RT123["dt"]
    before = dict(kernels.LAUNCHES)
    s = counted(rt_eom_ccsd.RT_EOM_CCSD, NO, device=device, e_c=root,
                e_r=RT123["e_r"], n_quad=RT123["n_quad"],
                ls_conv_tol=RT123["ls_conv_tol"])
    s.ls_restart = RT123["ls_restart"]
    q = (u0[0].astype(complex), u0[1].astype(complex))
    c_prev, st, walls, energies = 1.0, {}, [], []
    for k in range(RT123["steps"]):
        t0 = time.time()
        q = s.solve(p["fock"], V, T2, dt=dt, u_singles=q[0], u_doubles=q[1])
        walls.append(time.time() - t0)
        add_stats(st, s.ls_stats)
        norm = float(np.vdot(q[0], q[0]).real + np.vdot(q[1], q[1]).real)
        c_t = (np.tensordot(u0[0], q[0], axes=2)
               + np.tensordot(u0[1], q[1], axes=4))
        e_step = float(np.angle(c_t / c_prev) / dt)
        res = float(np.max(s.last_ls_residuals))
        check(abs(norm - 1.0) <= 1e-10, f"RT step {k}: norm {norm}")
        check(abs(e_step - root) <= 1e-7,
              f"RT step {k}: phase energy {e_step} vs root {root}")
        energies.append(e_step)
        steps = np.concatenate([np.atleast_1d(a) for a in s.ls_stats["steps"]])
        print(f"RT nP={p['nP']} step {k}: phase energy {e_step:.13f}, "
              f"|E - root|={abs(e_step - root):.2e}, |norm - 1|="
              f"{abs(norm - 1):.1e}, |c_t|={abs(c_t):.12f}, largest honest "
              f"ls residual {res:.2e}, Arnoldi steps per lane mean "
              f"{steps.mean():.1f} max {steps.max()}, {walls[-1]:.2f} s",
              flush=True)
        c_prev = c_t
    check_krylov_launches(f"RT nP={p['nP']}", before, s.n_sigma, st,
                          ladder=True)
    # one chunk of all 32 node lanes a step: 2·32 trials, K4's 448 columns
    lanes = [len(np.atleast_1d(a)) for a in st["steps"]]
    check(lanes == [K4_LANES["RT"]] * RT123["steps"],
          f"RT nP={p['nP']}: lanes per chunk {lanes}")
    out.update(solver=s, walls=walls, q=q, energies=energies)


def lih_feast(lih, device, out):
    """Phase 14: FEAST on LiH/3-21G, a root within 1e-6 of the oracle."""
    from pymes_tpu_torch import kernels

    t0 = time.time()
    fd, Vd, t2 = lih
    before = dict(kernels.LAUNCHES)
    s, roots = feast_run(fd, Vd, t2, device, LIH_FEAST, (120, 60),
                         no=t2.shape[-1])
    check_krylov_launches("FEAST LiH", before, s.n_sigma, s.ls_stats,
                          ladder=False)
    err = float(np.min(np.abs(roots.real - LIH_EOM_ORACLE[0])))
    check(err <= 1e-6, f"FEAST LiH: roots {roots} vs {LIH_EOM_ORACLE[0]}")
    print(f"FEAST LiH/3-21G: roots {roots}, |root - oracle|={err:.2e}, "
          f"{s.n_iterations} iterations, {time.time() - t0:.2f} s",
          flush=True)
    out.update(solver=s)


def arnoldi_step_ms(s, B, zr, zi, restart, rt=False, dt=0.0, f32=False):
    """ms per Arnoldi step (sigma + K8 + K7 + host) of one GMRES(restart)
    cycle over all lanes of ``B`` on the operator of solver ``s`` (with
    ``f32``: its f32 copy, the f32 lanes and kernels of the mixed engine,
    f32 GEMMs at full f32): no early exit (tol 0), so every lane takes
    ``restart`` steps; the wall includes the Mb pass and the cycle end,
    amortised over the steps.  Kernels and twins in turns (twin, kernel,
    kernel, twin); also the sigma, K8 and K7's projection (at the
    cycle's middle row count) alone per call."""
    import contextlib

    import torch

    from pymes_tpu_torch.kernels import arnoldi
    from pymes_tpu_torch.ops import gmres
    from pymes_tpu_torch.solver.feast_eom_ccsd import (_NodeOps,
                                                       full_f32_matmul)

    op = s._operator32(s._op) if f32 else s._op
    if f32:
        B, zr, zi = B.float(), zr.float(), zi.float()
    out = {True: [], False: []}
    with full_f32_matmul() if f32 else contextlib.nullcontext():
        for twin in (True, False, False, True):
            s.twin = twin
            node = _NodeOps(s, op, zr, zi, rt, dt)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gmres.gmres_lanes(node.apply, B, node.precond, tol=0.0,
                              restart=restart, max_outer=1, twin=twin)
            torch.cuda.synchronize()
            out[twin].append((time.perf_counter() - t0) * 1e3 / restart)
        s.twin = False
        node = _NodeOps(s, op, zr, zi, rt, dt)
        lanes = torch.arange(B.shape[0], device=B.device)
        H1, H2 = node.sigma(B)
        V = torch.zeros((B.shape[0], restart + 1, B.shape[1]),
                        dtype=B.dtype, device=B.device)
        V[:, :restart // 2] = B[:, None] / float(np.sqrt(B.shape[1]))
        mid = torch.full_like(lanes, restart // 2)
        parts = {"sigma": cuda_ms(lambda: node.sigma(B), n=5),
                 "K8": cuda_ms(lambda: node._k8(H1, H2, B, lanes, "apply"),
                               n=5),
                 "K7": cuda_ms(lambda: arnoldi.arnoldi_cgs2(
                     V, B.clone(), lanes, mid), n=5)}
        del V
    return np.mean(out[False]), np.mean(out[True]), parts


def feast57_lanes(s, device, seed=3):
    """The lanes of one FEAST nP=57 iteration: 16 nodes x 4 orthonormal
    seeded trials, as (B, zr, zi)."""
    import torch

    nv = s._op[2].shape[0]
    N = nv * NO + nv * nv * NO * NO
    m, nq = FEAST57["n_trial"], FEAST57["n_quad"]
    x, _ = np.polynomial.legendre.leggauss(nq)
    z = FEAST57["e_c"] + FEAST57["e_r"] * np.exp(-1j * np.pi / 2 * (x - 1))
    trials = np.linalg.qr(np.random.default_rng(seed).standard_normal(
        (N, m)))[0].T
    B = torch.zeros((nq * m, 2 * N), dtype=torch.float64, device=device)
    B[:, :N] = torch.as_tensor(np.tile(trials, (nq, 1)), device=device)
    return (B, torch.as_tensor(np.repeat(z.real, m), device=device),
            torch.as_tensor(np.repeat(z.imag, m), device=device))


def rt123_lanes(s, u0, root, device):
    """The 32 node lanes of one RT nP=123 step from the Ritz vector."""
    import torch

    nq, dt, e_r = RT123["n_quad"], RT123["dt"], RT123["e_r"]
    x, _ = np.polynomial.legendre.leggauss(nq)
    z = (root * 1j + e_r * np.exp(-1j * np.pi * x)) * dt
    b = np.concatenate([u0[0].ravel(), u0[1].ravel()])
    ph = np.exp(z)
    B = torch.as_tensor(np.concatenate([np.outer(ph.real, b),
                                        np.outer(ph.imag, b)], 1),
                        device=device)
    return (B, torch.as_tensor(z.real, device=device),
            torch.as_tensor(z.imag, device=device))


def f32_inputs(label, plan, plans, shape, seed, device):
    """Phase 24's f32 operands at one lane shape (La lanes, R1 basis rows,
    pair length n, singles length N1): the K7/K8 operands of
    :func:`krylov_inputs` in f32, the operator's all-bra plan and OVVV
    plans cast to f32, the cd-major K1 operand (nv², 2·La·no²), the K5
    operand (2·La, nv, nv, no, no) and the K4 trial batch, a (2·La, nv,
    no) view of (2·La, N) rows, as the sigma of one Arnoldi step over all
    lanes takes them."""
    import torch

    from pymes_tpu_torch.ops import ueg_ladder

    La, R1, n, N1, _ = shape
    f32 = torch.float32
    x = krylov_inputs(La, R1, n, N1, seed, device, dtype=f32)
    x["C"] = x["C"].double()
    g = torch.Generator(device=device).manual_seed(seed + 1)
    nv = plan.nv
    rows = torch.randn((2 * La, n // 2), generator=g, dtype=f32,
                       device=device)
    x.update(label=label, nv=nv, plan=ueg_ladder.cast_plan(plan, f32),
             plans={k: p._replace(W=p.W.float())
                    for k, p in plans.items()},
             T=torch.randn((nv * nv, 2 * La * NO * NO), generator=g,
                           dtype=f32, device=device) * 0.01,
             X5=torch.randn((2 * La, nv, nv, NO, NO), generator=g, dtype=f32,
                            device=device) * 0.01,
             T1=rows[:, :nv * NO].reshape(2 * La, nv, NO))
    return x


def f32_calls(x, m, w=None):
    """Each f32 kernel's call at the lane shape of ``x`` as a function of
    ``twin``: K7's projection at m rows of ``w`` (by default ``x["w"]``)
    and its fused combine at m + 1, K8 in each mode, K1 on the cd-major
    operand, K4 on each plan, K5 on the sigma's batch."""
    import torch

    from pymes_tpu_torch.kernels import arnoldi, block_ladder, ovvv_gather
    from pymes_tpu_torch.kernels import pair_sym, shifted

    V, lanes = x["V"], x["lanes"]
    mt = torch.full_like(lanes, m)
    m1 = torch.full_like(lanes, min(m + 1, V.shape[1]))
    args = (x["H1"], x["H2"], x["X"], x["zr"], x["zi"], x["diag"])
    return {
        "arnoldi_cgs2_f32": lambda tw: arnoldi.arnoldi_cgs2(
            V, (x["w"] if w is None else w).clone(), lanes, mt, twin=tw),
        "krylov_combine_f32": lambda tw: arnoldi.krylov_combine_xr(
            V, x["C"], m1, lanes, x0=x["X"], twin=tw),
        "shifted_precond_f32": lambda tw: shifted.shifted_precond(
            *args, twin=tw),
        "shifted_precond_f32 RT": lambda tw: shifted.shifted_precond(
            *args, dt=0.1, rt=True, twin=tw),
        "shifted_precond_f32 residual": lambda tw: shifted.shifted_precond(
            *args, mode="residual", B=x["B"], twin=tw),
        "shifted_precond_f32 precond": lambda tw: shifted.shifted_precond(
            *args, mode="precond", twin=tw),
        "block_ladder_f32": lambda tw: block_ladder.block_ladder_cd(
            x["plan"], x["T"], twin=tw),
        **{f"ovvv_gather_f32 {k}": (
            lambda tw, p=p: ovvv_gather.ovvv_gather(p.S, p.W, x["T1"],
                                                    twin=tw))
           for k, p in x["plans"].items()},
        "pair_symmetrize_f32": lambda tw: pair_sym.pair_symmetrize(
            x["X5"], twin=tw)}


def compare_f32_kernels(x, ms):
    """Phase 24: each f32 kernel against its f32 twin on the card at the
    lane shape of ``x``, max relative error ≤ F32_REL (K7's projection at
    each m of ``ms``, with the Hessenberg column, whose h and norm carry
    their own scales, and the written row); K4 and K5, whose twins take
    the same operations in the same order, bit for bit.  Returns the max
    abs errors by kernel and the max relative errors."""
    import torch

    from pymes_tpu_torch import kernels

    errs = {k: 0.0 for k in F32_KERNELS}
    rel = dict(errs)
    V, lanes = x["V"], x["lanes"]

    def note(name, got, want, what):
        e = rel_err(got, want, f"{what}, {x['label']}", tol=F32_REL)
        errs[name] = max(errs[name], e)
        rel[name] = max(rel[name], e / float(want.abs().max()))

    for m in ms:
        # a fresh w per m: the row that an earlier m wrote lies in the span
        # of w, and projecting w on it again leaves only rounding noise
        g = torch.Generator(device=V.device).manual_seed(1000 + m)
        calls = f32_calls(x, m, torch.randn(x["w"].shape, generator=g,
                                            dtype=V.dtype, device=V.device))
        mt = torch.full_like(lanes, m)
        hk = calls["arnoldi_cgs2_f32"](False)
        row_k = V[lanes, mt].clone()
        ht = calls["arnoldi_cgs2_f32"](True)
        check(hk.dtype == torch.float64 and row_k.dtype == torch.float32,
              "K7 f32: Hessenberg column f64, row f32")
        note("arnoldi_cgs2_f32", hk[:, :m], ht[:, :m], f"K7 f32 h, m={m}")
        note("arnoldi_cgs2_f32", hk[:, m], ht[:, m], f"K7 f32 norm, m={m}")
        note("arnoldi_cgs2_f32", row_k, V[lanes, mt], f"K7 f32 row, m={m}")
        for a, b, o in zip(calls["krylov_combine_f32"](False),
                           calls["krylov_combine_f32"](True), "xr"):
            note("arnoldi_cgs2_f32", a, b, f"K7 f32 fused combine {o}, "
                 f"m={m + 1}")
    for name, fn in calls.items():
        if name.startswith(("arnoldi", "krylov")):
            continue
        got, want = fn(False), fn(True)
        kernel = name.split()[0]
        if isinstance(got, tuple):          # K8 residual: r, ‖r‖, ‖b‖
            for a, b in zip(got, want):
                check(a.dtype == torch.float32, f"{name}: not f32")
                note(kernel, a, b, name)
        elif kernel in ("ovvv_gather_f32", "pair_symmetrize_f32"):
            check(got.dtype == torch.float32, f"{name}: not f32")
            errs[kernel] = max(errs[kernel], bit_equal(
                got, want, f"{name}, {x['label']}"))
        else:
            check(got.dtype == torch.float32, f"{name}: not f32")
            note(kernel, got, want, name)
    torch.cuda.synchronize()
    print(f"f32 kernel vs f32 twin, {x['label']}: " + ", ".join(
        f"{k} max_abs_err={errs[k]:.3e} (max rel {rel[k]:.2e})"
        for k in F32_KERNELS), flush=True)
    return errs, rel


def time_f32_kernels(x, m):
    """ms per call of each f32 kernel and its twin at the lane shape of
    ``x`` (twin, kernel, kernel, twin), K7 at m rows; K4 the mean over the
    three plans; the library call beside K5 (``torch.add`` of X and its
    partner) and K7's combine (``torch.baddbmm`` with an f32 (La, 2, m)
    coefficient batch), and each kernel's f32 bound."""
    import torch

    from pymes_tpu_torch.util.roofline import FP32_FMA_FLOPS_S

    calls = f32_calls(x, m)
    out = {}
    flush = torch.zeros(FLUSH_BYTES // 4, dtype=torch.float32,
                        device=x["V"].device)
    for name in ("arnoldi_cgs2_f32", "krylov_combine_f32",
                 "shifted_precond_f32", "block_ladder_f32",
                 "pair_symmetrize_f32", *(k for k in calls
                                          if k.startswith("ovvv"))):
        if name in ("arnoldi_cgs2_f32", "krylov_combine_f32"):
            t = [flushed_ms(lambda: calls[name](tw), flush, n=5)
                 for tw in (True, False, False, True)]
        else:
            t = [cuda_ms(lambda: calls[name](tw), n=10)
                 for tw in (True, False, False, True)]
        out[name] = ((t[1] + t[2]) / 2, (t[0] + t[3]) / 2)
    del flush
    k4 = [out.pop(k) for k in list(out) if k.startswith("ovvv")]
    out["ovvv_gather_f32"] = tuple(float(np.mean(v)) for v in zip(*k4))
    X5 = x["X5"]
    out["pair_symmetrize_f32 library"] = cuda_ms(
        lambda: torch.add(X5, X5.transpose(-4, -3).transpose(-2, -1)), n=10)
    X0 = torch.stack([x["X"], torch.zeros_like(x["X"])], dim=1)
    C = x["C"][:, :, :m].float()
    V = x["V"]
    out["krylov_combine_f32 library"] = cuda_ms(
        lambda: torch.baddbmm(X0, C, V[:, :m]), n=10)
    La, R1, n = V.shape
    nv, ncol = x["nv"], x["T1"].shape[0] * NO
    gathers = [gather_bound(p, nv, ncol, elem=4) for p in x["plans"].values()]
    kb = krylov_bounds(La, m, n, elem=4)
    b = {"block_ladder_f32": ladder_bound(x["plan"], x["T"].shape[1], elem=4,
                                          flops_s=FP32_FMA_FLOPS_S),
         "ovvv_gather_f32": (float(np.mean([g[0] for g in gathers])),
                             gathers[0][1]),
         # X read, out written; one add an element
         "pair_symmetrize_f32": bound(4 * 2 * X5.numel(), X5.numel(),
                                      FP32_FMA_FLOPS_S),
         "arnoldi_cgs2_f32": kb["bound"],
         # H (2La, N), x (La, 2N), diag read; the pair (La, 2N) written
         "shifted_precond_f32": bound(4 * (3 * La * n + n // 2),
                                      20 * La * n, FP32_FMA_FLOPS_S)}
    return out, b, kb


def k7_f32_sweep(x, sweep, card):
    """Phase 24: f32 K7's projection of all lanes of ``x`` at each m of
    ``sweep`` against its twin (F32_REL; h, the norm and the row) and per
    call with the L2 flushed before each call, beside its three-pass floor
    and once-read bound; then one call with the lanes at uneven m on both
    sides of 16 (the register and the tile paths in one launch), against
    the twin and rerun bit for bit.  Returns the max abs error and the
    times by m."""
    import torch

    from pymes_tpu_torch.kernels import arnoldi

    V, lanes = x["V"], x["lanes"]
    La, R1, n = V.shape
    flush = torch.zeros(FLUSH_BYTES // 4, dtype=torch.float32,
                        device=V.device)
    err, out = 0.0, {}
    for m in sweep:
        g = torch.Generator(device=V.device).manual_seed(2000 + m)
        w = torch.randn((La, n), generator=g, dtype=V.dtype, device=V.device)
        mt = torch.full_like(lanes, m)
        hk = arnoldi.arnoldi_cgs2(V, w.clone(), lanes, mt)
        row = V[lanes, mt].clone()
        ht = arnoldi.arnoldi_cgs2(V, w.clone(), lanes, mt, twin=True)
        what = f"K7 f32 sweep m={m}, {x['label']}"
        err = max(err, rel_err(hk[:, :m], ht[:, :m], what + " h", F32_REL),
                  rel_err(hk[:, m], ht[:, m], what + " norm", F32_REL),
                  rel_err(row, V[lanes, mt], what + " row", F32_REL))
        ws = [w.clone() for _ in range(7)]
        ms = flushed_ms(lambda: arnoldi.arnoldi_cgs2(V, ws.pop(), lanes, mt),
                        flush, n=5)
        kb = krylov_bounds(La, m, n, elem=4)
        out[m] = (ms, kb["floor_ms"], kb["bound"][0])
        print(f"[{card}] {x['label']} K7 f32 projection m={m}, L2 flushed: "
              f"{ms:.4f} ms, three-pass floor {kb['floor_ms']:.4f} ms "
              f"({kb['floor_ms'] / ms:.3f} of it), once-read bound "
              f"{kb['bound'][0]:.4f} ms ({kb['bound'][0] / ms:.3f})",
              flush=True)
        del ws, w
    ms = [(8 + 3 * a) % (R1 - 1) + 1 for a in range(La)]
    check(min(ms) <= 16 < max(ms), "uneven lanes straddle 16")
    mt = torch.as_tensor(ms, device=V.device)
    g = torch.Generator(device=V.device).manual_seed(2999)
    w = torch.randn((La, n), generator=g, dtype=V.dtype, device=V.device)
    hk = arnoldi.arnoldi_cgs2(V, w.clone(), lanes, mt)
    row = V[lanes, mt].clone()
    hk2 = arnoldi.arnoldi_cgs2(V, w.clone(), lanes, mt)
    torch.cuda.synchronize()
    check(torch.equal(hk, hk2) and torch.equal(row, V[lanes, mt]),
          f"K7 f32 uneven m, {x['label']}: a rerun changed the bits")
    ht = arnoldi.arnoldi_cgs2(V, w, lanes, mt, twin=True)
    for a, m in enumerate(ms):
        what = f"K7 f32 uneven m, lane {a} (m={m}), {x['label']}"
        err = max(err, rel_err(hk[a, :m], ht[a, :m], what + " h", F32_REL),
                  rel_err(hk[a, m:], ht[a, m:], what + " norm", F32_REL),
                  rel_err(row[a], V[a, m], what + " row", F32_REL))
    del flush
    print(f"[{card}] {x['label']} K7 f32 uneven m {min(ms)}..{max(ms)}: "
          f"within {F32_REL} of the twin, rerun bit for bit; max abs err "
          f"{err:.3e}", flush=True)
    return err, out


def f32_phase(label, plan, plans, shape, seed, device, card):
    """Phase 24 at one lane shape: compare and time the f32 kernels, and
    sweep f32 K7's projection over m."""
    import torch

    t0 = time.time()
    x = f32_inputs(label, plan, plans, shape, seed, device)
    ms = shape[4]
    errs, rel = compare_f32_kernels(x, ms)
    t, b, kb = time_f32_kernels(x, ms[len(ms) // 2])
    e7, sweep = k7_f32_sweep(x, K7_F32_SWEEP[label.split()[0]], card)
    errs["arnoldi_cgs2_f32"] = max(errs["arnoldi_cgs2_f32"], e7)
    kb["sweep"] = sweep
    del x
    torch.cuda.empty_cache()
    for name in F32_KERNELS:
        print(f"[{card}] {label} {name}: kernel {t[name][0]:.4f} ms, twin "
              f"{t[name][1]:.4f} ms per call; f32 bound {b[name][0]:.4f} ms "
              f"({b[name][1]}), the kernel at {b[name][0] / t[name][0]:.3f} "
              "of it", flush=True)
    kc = t["krylov_combine_f32"]
    print(f"[{card}] {label} K7 f32 fused combine {kc[0]:.4f} ms (twin "
          f"{kc[1]:.4f}), torch.baddbmm f32 "
          f"{t['krylov_combine_f32 library']:.4f} ms, bound "
          f"{kb['combine'][0]:.4f} ms; projection's three-pass floor "
          f"{kb['floor_ms']:.4f} ms; K5 f32 torch.add (library) "
          f"{t['pair_symmetrize_f32 library']:.4f} ms; {time.time() - t0:.2f}"
          " s", flush=True)
    return errs, t, b, kb


def mixed_launches(n_sigma, st, ladder):
    """The launches of a mixed-engine window from what its solves did:
    each Arnoldi step of an f32 Krylov solve is one f32 sigma (K1 f32, K4
    f32 three times, K5 f32), one f32 K8 (apply) and one f32 K7; each
    cycle end one f32 K7 combine; each refinement pass of a chunk one f32
    K8 for Mb and one f64 sigma and f64 K8 for the honest residual; each
    FEAST iteration's projected H̄ one f64 sigma; and H̄'s W_laji one f64
    K1 per operator."""
    calls, passes = st["calls"], sum(st["passes"])
    n64 = n_sigma - calls
    check(n64 == passes + st["projections"],
          f"{n64} f64 sigmas for {passes} passes and {st['projections']} "
          "projections")
    want = {"pair_symmetrize": n64, "shifted_precond": passes,
            "pair_symmetrize_f32": calls,
            "arnoldi_cgs2_f32": calls + st["cycle_ends"],
            "shifted_precond_f32": calls + passes}
    if ladder:
        want.update(block_ladder=n64 + 1, ovvv_gather=3 * n64,
                    block_ladder_f32=calls, ovvv_gather_f32=3 * calls)
    return want


def feast57_mixed(p5, V, T2, device, ref, card):
    """Phase 24: phase 12's window with ``ls_precision="mixed"`` and
    MIXED_REFINE_MAX passes: the roots inside the window within 1e-7 of
    the JAX level and of phase 12's roots, every honest residual ≤
    ls_conv_tol; prints the passes per chunk, the walls per iteration
    beside phase 12's, the Krylov bytes per lane and the peak memory, and
    the matmul settings seen inside the engine.  Returns the solver and
    the launches its solve implies."""
    import torch

    from pymes_tpu_torch.solver import feast_eom_ccsd

    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    cfg = dict(FEAST57, ls_precision="mixed")
    s = counted(feast_eom_ccsd.FEAST_EOM_CCSD, NO, device=device, **cfg)
    s.ls_restart, s.ls_max_iter = FEAST57_GMRES
    s.ls_refine_max = MIXED_REFINE_MAX
    roots = np.sort_complex(np.asarray(s.solve(p5["fock"], V, T2)))
    peak = torch.cuda.max_memory_allocated()
    st = s.ls_stats
    e_c, e_r = FEAST57["e_c"], FEAST57["e_r"]
    inside = roots[np.abs(roots.real - e_c) < e_r]
    ref_in = ref["roots"][np.abs(ref["roots"].real - e_c) < e_r]
    level = EOM_JAX[5][0][0]
    dev = float(np.abs(inside - level).max()) if len(inside) else np.inf
    gap = (float(np.abs(np.sort(inside.real)[:, None]
                        - np.sort(ref_in.real)[None]).min(axis=1).max())
           if len(inside) and len(ref_in) else np.inf)
    res = float(np.max(s.last_ls_residuals))
    check(len(inside) >= 1 and dev <= 1e-7,
          f"mixed FEAST nP=57: roots {roots} vs the JAX level {level}")
    check(gap <= 1e-7, f"mixed FEAST nP=57: roots {inside} vs phase 12's "
          f"{ref_in}")
    check(res <= FEAST57["ls_conv_tol"],
          f"mixed FEAST nP=57: largest honest ls residual {res:.3e} > "
          f"{FEAST57['ls_conv_tol']}")
    check(st["matmul"] == ("highest", False, False),
          f"mixed FEAST nP=57: matmul settings {st['matmul']} in the engine")
    N2 = 2 * (p5["nv"] * NO + p5["nv"] ** 2 * NO * NO)
    lane = (FEAST57_GMRES[0] + 1) * N2
    print(f"mixed FEAST nP=57 (ls_refine_max {s.ls_refine_max}): "
          f"{len(inside)} roots in the window, max |root - JAX level| = "
          f"{dev:.2e}, max |root - phase 12| = {gap:.2e}, "
          f"{s.n_iterations} FEAST iterations (phase 12: "
          f"{ref['solver'].n_iterations}), largest honest ls residual "
          f"{res:.2e}, refinement passes per chunk {st['passes']}, f32 "
          f"Arnoldi steps per pass and lane: mean "
          f"{np.concatenate(st['steps']).mean():.1f}, max "
          f"{np.concatenate(st['steps']).max()}; matmul inside the engine "
          f"(precision, cuda allow_tf32, cudnn allow_tf32) {st['matmul']}, "
          f"after it ({torch.get_float32_matmul_precision()}, "
          f"{torch.backends.cuda.matmul.allow_tf32}, "
          f"{torch.backends.cudnn.allow_tf32}); {time.time() - t0:.2f} s",
          flush=True)
    print(f"[{card}] mixed FEAST nP=57: wall per iteration "
          f"{[round(w, 3) for w in s.iter_walls]} s (phase 12, f64: "
          f"{[round(w, 3) for w in ref['solver'].iter_walls]} s); Krylov "
          f"basis {lane * 4 / 1e6:.1f} MB a lane (f64 {lane * 8 / 1e6:.1f}),"
          f" {s.krylov_mem_budget_bytes} budget; peak device memory "
          f"{peak / 1e9:.3f} GB (phase 12 {ref['peak'] / 1e9:.3f} GB)",
          flush=True)
    return s, mixed_launches(s.n_sigma, st, ladder=True)


def rt123_mixed(p, V, T2, root, u0, ref, device, card):
    """Phase 24: phase 13's three CIF steps with ``ls_precision="mixed"``:
    each step's phase energy within 1e-7 of the root and of phase 13's,
    unit norm to 1e-10, every honest residual ≤ ls_conv_tol.  Returns the
    solver and the launches its steps imply."""
    from pymes_tpu_torch.solver import rt_eom_ccsd

    dt = RT123["dt"]
    s = counted(rt_eom_ccsd.RT_EOM_CCSD, NO, device=device, e_c=root,
                e_r=RT123["e_r"], n_quad=RT123["n_quad"],
                ls_conv_tol=RT123["ls_conv_tol"], ls_precision="mixed")
    s.ls_restart = RT123["ls_restart"]
    s.ls_refine_max = MIXED_REFINE_MAX
    q = (u0[0].astype(complex), u0[1].astype(complex))
    c_prev, st, walls = 1.0, {}, []
    for k in range(RT123["steps"]):
        t0 = time.time()
        q = s.solve(p["fock"], V, T2, dt=dt, u_singles=q[0], u_doubles=q[1])
        walls.append(time.time() - t0)
        add_stats(st, s.ls_stats)
        norm = float(np.vdot(q[0], q[0]).real + np.vdot(q[1], q[1]).real)
        c_t = (np.tensordot(u0[0], q[0], axes=2)
               + np.tensordot(u0[1], q[1], axes=4))
        e_step = float(np.angle(c_t / c_prev) / dt)
        res = float(np.max(s.last_ls_residuals))
        e13 = ref["energies"][k]
        check(abs(norm - 1.0) <= 1e-10, f"mixed RT step {k}: norm {norm}")
        check(abs(e_step - root) <= 1e-7 and abs(e_step - e13) <= 1e-7,
              f"mixed RT step {k}: phase energy {e_step} vs root {root} "
              f"and phase 13's {e13}")
        check(res <= RT123["ls_conv_tol"],
              f"mixed RT step {k}: largest honest ls residual {res:.3e}")
        print(f"mixed RT nP={p['nP']} step {k}: phase energy "
              f"{e_step:.13f}, |E - root|={abs(e_step - root):.2e}, "
              f"|E - phase 13|={abs(e_step - e13):.2e}, |norm - 1|="
              f"{abs(norm - 1):.1e}, largest honest ls residual {res:.2e}, "
              f"refinement passes {s.ls_stats['passes']}, {walls[-1]:.2f} s "
              f"(phase 13 {ref['walls'][k]:.2f} s)", flush=True)
        c_prev = c_t
    print(f"[{card}] mixed RT nP={p['nP']}: wall per step "
          f"{[round(w, 3) for w in walls]} s (phase 13, f64: "
          f"{[round(w, 3) for w in ref['walls']]} s)", flush=True)
    return s, mixed_launches(s.n_sigma, st, ladder=True)


def prec_inputs(q, V, seed):
    """Phase 25's f32 operands at the nP=219 shapes: the CCSD tail's of
    :func:`tail_inputs` in f32 (and the CCD tail's, its T2 segment), the
    K6 buffers of :func:`eom_inputs` (16 rows, k = 2) in f32, the f32 OVVV
    plans (weights cast) and orbital energies."""
    import torch

    x64 = tail_inputs(NO, q["dict"]["ijab"], seed)
    x = {k: v.float() for k, v in x64.items()}
    n1 = NO * q["nv"]
    x["ccd_errs"] = x["errs"][:, n1:].contiguous()
    x["ccd_amps"] = x["amps"][:, n1:].contiguous()
    e = eom_inputs(V, q["nv"], seed + 1)
    x.update({"k6_" + k: e[k].float() for k in ("U", "W", "v", "e",
                                                 "diag")})
    x["plans"] = {pat: q["mf_dict"]["_ovvv_plans"][pat]._replace(
        W=q["mf_dict"]["_ovvv_plans"][pat].W.float())
        for pat, _ in DIAG_PLANS}
    x["eps_i"], x["eps_a"] = q["eps_i"].float(), q["eps_a"].float()
    del e, x64
    torch.cuda.empty_cache()
    return x


def prec_calls(x, q):
    """Each phase-25 kernel's call on :func:`prec_inputs` as a function of
    ``twin`` (fresh rings where the call writes them)."""
    from pymes_tpu_torch.kernels import ccd_tail, ccsd_tail, davidson
    from pymes_tpu_torch.ops import ueg_ladder

    return {
        "davidson_residual_f32": lambda tw: davidson.davidson_residual(
            x["k6_U"], x["k6_W"], x["k6_v"], x["k6_e"], x["k6_diag"], 16,
            twin=tw),
        "ccd_jacobi_diis_f32": lambda tw: ccd_tail.jacobi_diis_insert(
            x["R2"], x["T2"], x["eps_i"], x["eps_a"], -1.0, x["ccd_errs"],
            x["ccd_amps"], 2, 6, twin=tw),
        "ccd_mix_energy_f32": lambda tw: ccd_tail.diis_mix_energy(
            x["ccd_amps"], x["coeff"], 6, x["R2"], x["V"], x["Vx"],
            twin=tw),
        "ccsd_jacobi_diis_f32": lambda tw: ccsd_tail.jacobi_diis_insert(
            x["R1"], x["T1"], x["R2"], x["T2"], x["eps_i"], x["eps_a"],
            -1.0, x["errs"], x["amps"], 2, 6, twin=tw),
        "ccsd_mix_energy_f32": lambda tw: ccsd_tail.diis_mix_energy(
            x["amps"], x["coeff"], 6, x["R1"], x["R2"], x["F1"], x["V"],
            x["Vx"], twin=tw),
        "ovvv_gather_diag_f32": lambda tw: [ueg_ladder.ovvv_t1_trace(
            x["plans"][pat], x["T1"], axis, twin=tw)
            for pat, axis in DIAG_PLANS]}


def compare_prec_kernels(x, q):
    """Phase 25: each f32 kernel of the precision modes against its f32
    twin at the nP=219 shapes, max relative error ≤ F32_REL: K6 at 16 and
    9 valid rows (the three clamped columns and the rest each to its own
    scale), K2/K3 and K2′/K3′ (first insertion and full ring; their ring
    rows bit for bit), K4's fused trace on both plans.  Returns the max abs
    errors and the max relative errors by kernel."""
    import torch

    from pymes_tpu_torch.kernels import ccd_tail, ccsd_tail, davidson
    from pymes_tpu_torch.ops import ueg_ladder

    errs = {k: 0.0 for k in PREC_KERNELS}
    rel = dict(errs)

    def note(name, got, want, what):
        e = rel_err(got, want, f"{what}, nP={q['nP']}", F32_REL)
        errs[name] = max(errs[name], e)
        rel[name] = max(rel[name], e / float(want.abs().max()))

    for m in (16, 9):
        U, W = x["k6_U"].clone(), x["k6_W"].clone()
        U[m:], W[m:] = 0.0, 0.0
        v = x["k6_v"].clone()
        v[m:] = 0.0
        args = (U, W, v, x["k6_e"], x["k6_diag"], m)
        got = davidson.davidson_residual(*args)
        want = davidson.davidson_residual(*args, twin=True)
        check(got.dtype == torch.float32, "K6 f32: not f32")
        note("davidson_residual_f32", got[:, :3], want[:, :3],
             f"K6 f32 m={m}, clamped columns")
        note("davidson_residual_f32", got[:, 3:], want[:, 3:],
             f"K6 f32 m={m}, the rest")
    for slot, n_valid in ((0, 1), (2, 6)):
        for name, fn in (
                ("ccd_jacobi_diis_f32", lambda e, a, tw:
                 ccd_tail.jacobi_diis_insert(
                     x["R2"], x["T2"], x["eps_i"], x["eps_a"], -1.0, e, a,
                     slot, n_valid, twin=tw)),
                ("ccsd_jacobi_diis_f32", lambda e, a, tw:
                 ccsd_tail.jacobi_diis_insert(
                     x["R1"], x["T1"], x["R2"], x["T2"], x["eps_i"],
                     x["eps_a"], -1.0, e, a, slot, n_valid, twin=tw))):
            e0, a0 = ((x["ccd_errs"], x["ccd_amps"])
                      if name == "ccd_jacobi_diis_f32"
                      else (x["errs"], x["amps"]))
            rings = [(e0.clone(), a0.clone()) for _ in range(2)]
            rows = [fn(e, a, tw) for (e, a), tw in zip(rings, (False, True))]
            check(rows[0].dtype == torch.float32
                  and rings[0][0].dtype == torch.float32,
                  f"{name}: Gram row or error ring not f32")
            what = f"{name} slot {slot}"
            note(name, rows[0], rows[1], f"{what} Gram row")
            for k, ring in enumerate(("error", "amplitude")):
                e = bit_equal(rings[0][k], rings[1][k],
                              f"{what} {ring} ring, nP={q['nP']}")
                errs[name] = max(errs[name], e)
    for n_valid in (1, 6):
        Ts = [x["T2"].clone() for _ in range(2)]
        es = [ccd_tail.diis_mix_energy(x["ccd_amps"], x["coeff"], n_valid, T,
                                       x["V"], x["Vx"], twin=tw)
              for T, tw in zip(Ts, (False, True))]
        note("ccd_mix_energy_f32", Ts[0], Ts[1], "K3 f32 mixed T")
        for piece, a, b in zip(("e_dir", "e_exc"), *es):
            note("ccd_mix_energy_f32", a, b, f"K3 f32 {piece}")
        Ts = [(x["T1"].clone(), x["T2"].clone()) for _ in range(2)]
        es = [ccsd_tail.diis_mix_energy(x["amps"], x["coeff"], n_valid, T1,
                                        T2, x["F1"], x["V"], x["Vx"],
                                        twin=tw)
              for (T1, T2), tw in zip(Ts, (False, True))]
        note("ccsd_mix_energy_f32", Ts[0][0], Ts[1][0], "K3' f32 mixed T1")
        note("ccsd_mix_energy_f32", Ts[0][1], Ts[1][1], "K3' f32 mixed T2")
        for piece, a, b in zip(("e_1b", "e_dir", "e_exc"), *es):
            note("ccsd_mix_energy_f32", a, b, f"K3' f32 {piece}")
    for pat, axis in DIAG_PLANS:
        plan = x["plans"][pat]
        got = ueg_ladder.ovvv_t1_trace(plan, x["T1"], axis)
        check(got.dtype == torch.float32, "K4 trace f32: not f32")
        note("ovvv_gather_diag_f32", got, ueg_ladder.ovvv_t1_trace(
            plan, x["T1"], axis, twin=True), f"K4 f32 trace {pat}")
    torch.cuda.synchronize()
    print(f"f32 kernel vs f32 twin, precision modes nP={q['nP']}: "
          + ", ".join(f"{k} max_abs_err={errs[k]:.3e} (max rel "
                      f"{rel[k]:.2e})" for k in PREC_KERNELS), flush=True)
    return errs, rel


def prec_bounds(q):
    """Phase 25's kernels' bounds at the timed calls' nP=219 shapes, from
    this run's sizes: the f32 kernels as their f64 twins' rows of
    :func:`kernel_bounds` at 4 bytes an element and the FP32 FMA rate."""
    nv = q["nv"]
    n = NO * NO * nv * nv
    nc = nv * NO + n
    f32 = roofline.FP32_FMA_FLOPS_S
    traces = [diag_bound(q["mf_dict"]["_ovvv_plans"][pat], nv, NO, elem=4)
              for pat, _ in DIAG_PLANS]
    return {
        "davidson_residual_f32": bound(4 * (2 * 16 * nc + nc + 2 * nc),
                                       2 * nc * (4 * 16 + 4), f32),
        "ccd_jacobi_diis_f32": bound(4 * 9 * n, 17 * n, f32),
        "ccd_mix_energy_f32": bound(4 * 9 * n, 16 * n, f32),
        "ccsd_jacobi_diis_f32": bound(4 * 9 * nc, 17 * nc, f32),
        "ccsd_mix_energy_f32": bound(4 * 9 * nc, 16 * nc, f32),
        "ovvv_gather_diag_f32": (float(np.mean([b[0] for b in traces])),
                                 traces[0][1])}


def time_prec_kernels(x, q):
    """ms per call of each phase-25 kernel and its twin at nP=219 (twin,
    kernel, kernel, twin; the fused trace per launch, the mean over the
    two plans)."""
    calls = prec_calls(x, q)
    out = {}
    for name, fn in calls.items():
        t = [cuda_ms(lambda: fn(tw)) for tw in (True, False, False, True)]
        per = len(DIAG_PLANS) if name == "ovvv_gather_diag_f32" else 1
        out[name] = ((t[1] + t[2]) / 2 / per, (t[0] + t[3]) / 2 / per)
    return out


def prec_ladder_gather(p14, q, seed, card):
    """Phase 25: f32 K1 at the nP=219 widths of the precision modes (N =
    no² on the virtual plan: the mixed CCD's f32 bulk; N = 2 no² on the
    all-bra plan: an EOM batch of two in the mixed Davidson's seed phase)
    and f32 K4 at the dressing's 7 and the EOM batch's 14 columns, each
    against its f32 twin (K1 within F32_REL and a rerun bit for bit, K4
    bit for bit on every plan), then per call and on the card alone beside
    the f64 kernel at the same width, each with its bound and its share of
    it.  Returns the max abs errors and the kernels line's sub-entries."""
    import torch

    from pymes_tpu_torch.kernels import block_ladder as k1
    from pymes_tpu_torch.ops import ueg_ladder
    from pymes_tpu_torch.util.roofline import FP32_FMA_FLOPS_S

    rng = np.random.default_rng(seed)
    dev = p14["fock"].device
    n2 = NO * NO
    errs = {"block_ladder_f32": 0.0, "ovvv_gather_f32": 0.0}
    sub = {"block_ladder_f32": {}, "ovvv_gather_f32": {}}
    for label, plan, N in (
            (f"nP={q['nP']} virtual plan, N = no^2 (mixed CCD)",
             p14["blocks"].ladder, n2),
            (f"nP={q['nP']} all-bra plan, N = 2 no^2 (EOM batch of 2)",
             q["plan_all"], 2 * n2)):
        T = torch.as_tensor(rng.standard_normal((plan.nv ** 2, N)) * 0.01,
                            device=dev)
        p32, T32 = ueg_ladder.cast_plan(plan, torch.float32), T.float()
        got = k1.block_ladder_cd(p32, T32)
        again = k1.block_ladder_cd(p32, T32)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"K1 f32 {label}: a rerun differs")
        errs["block_ladder_f32"] = max(errs["block_ladder_f32"], rel_err(
            got, k1.block_ladder_cd(p32, T32, twin=True), f"K1 f32 {label}",
            tol=F32_REL))
        row = {}
        for tag, P, X, kw in (("f32", p32, T32, dict(
                elem=4, flops_s=FP32_FMA_FLOPS_S)), ("f64", plan, T, {})):
            def fn(tw, P=P, X=X):
                return k1.block_ladder_cd(P, X, twin=tw)

            t = [cuda_ms(lambda: fn(tw)) for tw in (True, False, False,
                                                    True)]
            row[tag] = ((t[1] + t[2]) / 2, (t[0] + t[3]) / 2,
                        ladder_bound(plan, N, **kw),
                        card_ms(lambda: fn(False), "block_ladder"))
        sub["block_ladder_f32"][label] = precision_entry(row)
        print_f32_row(card, f"block_ladder {label}", row)
    plans = q["mf_dict"]["_ovvv_plans"]
    p32 = {pat: p._replace(W=p.W.float()) for pat, p in plans.items()}
    nv = q["nv"]
    rows = torch.as_tensor(rng.standard_normal((2, nv * NO + nv * nv * n2)),
                           device=dev)
    for label, T in (
            (f"nP={q['nP']} CCSD dressing, 7 columns",
             torch.as_tensor(rng.standard_normal((nv, NO)), device=dev)),
            (f"nP={q['nP']} EOM batch of 2, 14 columns",
             rows[:, :nv * NO].reshape(2, nv, NO))):
        T32 = (T.float() if T.dim() == 2
               else rows.float()[:, :nv * NO].reshape(2, nv, NO))
        r32 = time_k4(p32, T32, f"f32 {label}")
        r64 = time_k4(plans, T, label)
        errs["ovvv_gather_f32"] = max(errs["ovvv_gather_f32"], r32[4])
        row = {"f32": (r32[0], r32[1], r32[3], r32[2]),
               "f64": (r64[0], r64[1], r64[3], r64[2])}
        sub["ovvv_gather_f32"][label] = precision_entry(row)
        print_f32_row(card, f"ovvv_gather {label}", row)
    torch.cuda.empty_cache()
    return errs, sub


def precision_entry(row):
    """A kernels-line sub-entry of an f32 kernel timed beside its f64
    kernel: ``row`` holds (ms, plain_ms, bound, device_ms) of each."""
    (ms, plain, b, dev), (ms64, _, b64, dev64) = row["f32"], row["f64"]
    return {"ms": ms, "plain_ms": plain, "bound_ms": b[0], "bound_by": b[1],
            "library_ms": None, "device_ms": dev, "f64_ms": ms64,
            "f64_device_ms": dev64, "f64_bound_ms": b64[0]}


def print_f32_row(card, label, row):
    (ms, plain, b, dev), (ms64, _, b64, dev64) = row["f32"], row["f64"]
    print(f"[{card}] {label}: f32 kernel {ms:.4f} ms per call ({dev:.4f} "
          f"on the card alone), twin {plain:.4f} ms; f32 bound {b[0]:.4f} "
          f"ms ({b[1]}), the kernel alone at {b[0] / dev:.3f} of it; f64 "
          f"kernel {ms64:.4f} ms per call ({dev64:.4f} alone), bound "
          f"{b64[0]:.4f} ms", flush=True)


@contextlib.contextmanager
def sigma_calls():
    """Counts the EOM sigmas by the trial batch's type: the module
    function every sigma of the built-in ``_batched_sigma`` runs, wrapped
    (a subclass that overrides ``_batched_sigma`` would take the f64
    path)."""
    import torch

    from pymes_tpu_torch.solver import eom_ccsd

    real = eom_ccsd._sigma_batched_hbar
    n = {torch.float32: 0, torch.float64: 0}

    def counting(f, V, hb, U1, *args, **kw):
        n[U1.dtype] += 1
        return real(f, V, hb, U1, *args, **kw)

    eom_ccsd._sigma_batched_hbar = counting
    try:
        yield n
    finally:
        eom_ccsd._sigma_batched_hbar = real


def eom_sigma_launches(n32, n64, ladder):
    """The launches of one mixed EOM solve of ``n32`` f32 and ``n64`` f64
    sigmas (:func:`check_eom_launches` for each phase): K5 a sigma, K6 a
    sigma less one, and on the matrix-free operator K1 a sigma plus one
    (the phase's W_laji) and K4 three a sigma."""
    want = {"pair_symmetrize_f32": n32, "pair_symmetrize": n64,
            "davidson_residual_f32": n32 - 1, "davidson_residual": n64 - 1}
    if ladder:
        want.update(block_ladder_f32=n32 + 1, block_ladder=n64 + 1,
                    ovvv_gather_f32=3 * n32, ovvv_gather=3 * n64)
    return want


def eom_tight(cases, device):
    """Phase 25 set-up, outside the counted windows: the converged roots of
    each UEG case, the f64 Davidson (MOM) to |dE| < 1e-12.  The JAX
    package's pins stop at |dE| < 1e-8, which leaves them up to a few 1e-8
    from these (2.69e-8 at nP=219 on an H100): a mixed solve, whose f64
    polish stops by the same test from other seeds, is held to these, and
    to the pins within their own distance from these plus 1e-8."""
    from pymes_tpu_torch.solver import eom_ccsd

    out = {}
    for label, fock, V, T2, ref, _ in cases:
        s = eom_ccsd.EOM_CCSD(NO, device=device, n_excit=2)
        s.e_epsilon, s.max_iter = 1e-12, 300
        roots = out[label] = np.sort(np.real(s.solve(fock, V, T2)))
        jt = EOM_JAX_TIGHT[int(label.split()[0][3:])]
        both = float(np.abs(roots - np.asarray(jt)).max())
        check(both <= 1e-9, f"EOM {label} to |dE| < 1e-12: roots {roots} "
              f"vs the JAX package's {jt}")
        print(f"EOM {label}, f64 to |dE| < 1e-12: roots {roots[0]:.13f} "
              f"{roots[1]:.13f} in {s.n_iterations} iterations, |roots - "
              f"JAX (|dE| < 1e-8)| = "
              f"{float(np.abs(roots - np.asarray(ref)).max()):.2e}, |roots "
              f"- JAX converged| = {both:.2e}", flush=True)
    return out


def eom_mixed(cases, tight, lih, walls, device, card):
    """Phase 25, EOM: ``precision="mixed"`` on the UEG ``cases`` (label,
    fock, operator, T2, JAX roots) and LiH: the roots within 1e-8 of the
    converged ones of :func:`eom_tight` and of the JAX package's converged
    roots (``EOM_JAX_TIGHT``), and within 1e-8 plus the pin's own distance
    from the converged ones of the JAX package's pin, that distance at
    most ``EOM_PIN_CAP`` (LiH 1e-7 of the oracle); the
    f32 phase's and the polish's iterations (at nP=57 beside the JAX
    package's mixed run), the wall beside phase 9's f64 solve; each solve
    must run an f32 phase.  Returns the launches the solves imply."""
    import torch

    from pymes_tpu_torch.solver import eom_ccsd

    want = {}
    runs = [(label, fock, V, T2, ref, True)
            for label, fock, V, T2, ref, _ in cases]
    runs.append(("LiH", *lih, LIH_EOM_ORACLE, False))
    for label, fock, V, T2, ref, ladder in runs:
        no = T2.shape[-1]
        s = eom_ccsd.EOM_CCSD(no, device=device, n_excit=2)
        s.precision = "mixed"
        s.max_iter = 300 if ladder else 1000
        t0 = time.time()
        with sigma_calls() as n:
            roots = np.sort(np.real(s.solve(fock, V, T2)))
        wall = time.time() - t0
        n32, n64 = n[torch.float32], n[torch.float64]
        err = float(np.abs(roots - np.asarray(ref)).max())
        check(n32 > 1 and s.n_iterations_f32 >= 1 and n64 >= 1,
              f"mixed EOM {label}: {n32} f32 and {n64} f64 sigmas")
        if ladder:
            conv = float(np.abs(roots - tight[label]).max())
            pin = float(np.abs(tight[label] - np.asarray(ref)).max())
            check(conv <= 1e-8 and pin <= EOM_PIN_CAP
                  and err <= pin + 1e-8,
                  f"mixed EOM {label}: roots {roots} vs converged "
                  f"{tight[label]} and JAX {ref}")
            jax = f", |roots - converged| = {conv:.2e}"
            tight_jax = EOM_JAX_TIGHT[int(label.split()[0][3:])]
            jt = float(np.abs(roots - np.asarray(tight_jax)).max())
            check(jt <= 1e-8, f"mixed EOM {label}: roots {roots} vs JAX "
                  f"converged {tight_jax}")
            jax += f", |roots - JAX converged| = {jt:.2e}"
        else:
            check(err <= 1e-7, f"mixed EOM {label}: roots {roots} vs {ref}")
            jax = ""
        if label.startswith("nP=57"):
            jr, j32, j64 = EOM_JAX_MIXED_NP57
            jax += (f" (JAX mixed {j32} + {j64}, |roots - JAX mixed| = "
                    f"{float(np.abs(roots - np.asarray(jr)).max()):.2e})")
        print(f"[{card}] mixed EOM {label}: roots {roots[0]:.13f} "
              f"{roots[1]:.13f}, |roots - "
              f"{'JAX f64' if ladder else 'oracle'}| = {err:.2e}, "
              f"{s.n_iterations_f32} f32 + {s.n_iterations} f64 iterations"
              f"{jax}; {n32} f32 + {n64} f64 sigmas; wall {wall:.2f} s "
              f"(phase 9, f64: {walls[label]:.2f} s)", flush=True)
        for k, v in eom_sigma_launches(n32, n64, ladder).items():
            want[k] = want.get(k, 0) + v
    return want


def ccd_mixed(problems, results, device, card):
    """Phase 25, CCD: ``mixed_precision=True`` at nP=57 and nP=219 within
    1e-8 of the JAX package's f64 energy (nP=57 also of the oracle), the
    f32 and f64 iterations (nP=57 beside the JAX package's mixed run), the
    wall beside phase 3/4's f64 solve.  Returns the launches: one f32 K1,
    K2, K3 and K5 an f32 iteration, one f64 each an f64 one."""
    from pymes_tpu_torch.solver import ccd

    want = {}
    for c, p in problems.items():
        t0 = time.time()
        s = ccd.CCD(NO, device=device)
        res = s.solve(p["fock"], p["blocks"], level_shift=-1.0, max_iter=60,
                      mixed_precision=True)
        wall = time.time() - t0
        e, n32, n64 = res["ccd e"], s.n_iterations_f32, len(res["e history"])
        check(n32 >= 1 and res["t2 amp"].dtype == p["fock"].dtype,
              f"mixed CCD nP={p['nP']}: {n32} f32 iterations")
        check(abs(e - E_JAX[c]) <= 1e-8,
              f"mixed CCD nP={p['nP']}: E={e:.13f} vs JAX {E_JAX[c]}")
        jax = ""
        if c == 5:
            check(abs(e - ORACLE_NP57) <= 1e-8,
                  f"mixed CCD nP=57: E={e} vs oracle {ORACLE_NP57}")
            je, j32, j64 = CCD_JAX_MIXED_NP57
            jax = (f" (JAX mixed {j32} + {j64}, |E - JAX mixed| = "
                   f"{abs(e - je):.2e}; |E - oracle| = "
                   f"{abs(e - ORACLE_NP57):.2e})")
        print(f"[{card}] mixed CCD nP={p['nP']}: E={e:.13f}, |E - E_jax| = "
              f"{abs(e - E_JAX[c]):.2e}, {n32} f32 + {n64} f64 iterations"
              f"{jax}; wall {wall:.2f} s (phase 3/4, f64: "
              f"{results[c][3]:.2f} s in {results[c][1]} iterations)",
              flush=True)
        for k in CCD_KERNELS:
            want[k + "_f32"] = want.get(k + "_f32", 0) + n32
            want[k] = want.get(k, 0) + n64
    return want


def ccsd_prec(q, mol, mf_walls, device, card):
    """Phase 25, CCSD: ``mixed_precision=True`` on LiH/3-21G (an f64 solve
    beside it) within 1e-8 of the oracle; the seeded non-canonical
    mf-CCSD at nP=219 with ``mixed_precision=True`` (|dE| < 1e-10) within
    1e-8 of the JAX package's f64 energy, the wall beside phase 7's.
    Returns the launches: per iteration, dense one K2′, K3′, K5;
    matrix-free one K1, K2′, K3′, K5, 4 K4 gathers and 2 fused traces, in
    f32 in the f32 pass."""
    from pymes_tpu_torch.solver import ccsd

    e_ref, _, tol = MOLECULES["LiH"][2:]
    out = {}
    for mixed in (False, True):
        t0 = time.time()
        s = ccsd.CCSD(mol["no"], device=device)
        res = s.solve(mol["fock"], mol["V"], mixed_precision=mixed)
        out[mixed] = (res["ccsd e"], len(res["e history"]),
                      s.n_iterations_f32 if mixed else 0, time.time() - t0)
    e, n64, n32, wall = out[True]
    check(n32 >= 1 and abs(e - e_ref) <= tol,
          f"mixed CCSD LiH: E={e} vs oracle {e_ref} in {n32} f32 iterations")
    je, j32, j64 = LIH_JAX_CCSD_MIXED
    print(f"[{card}] mixed CCSD LiH/3-21G: E={e:.13f}, |E - oracle| = "
          f"{abs(e - e_ref):.2e}, |E - JAX mixed| = {abs(e - je):.2e}, "
          f"{n32} f32 + {n64} f64 iterations (JAX mixed {j32} + {j64}); "
          f"wall {wall:.3f} s (f64: {out[False][3]:.3f} s in "
          f"{out[False][1]} iterations)", flush=True)
    dense = ("ccsd_jacobi_diis", "ccsd_mix_energy", "pair_symmetrize")
    want = {k: n64 + out[False][1] for k in dense}
    want.update({k + "_f32": n32 for k in dense})

    fock = q["focks"]["non-canonical"]
    mf = dict(ladder=q["plan_all"], level_shift=-1.0, delta_e=1e-10,
              max_iter=100)
    mf_kernels = ("block_ladder", "ccsd_jacobi_diis", "ccsd_mix_energy",
                  "pair_symmetrize")
    t0 = time.time()
    s = ccsd.CCSD(NO, device=device)
    res = s.solve(fock, q["mf_dict"], mixed_precision=True, **mf)
    wall = time.time() - t0
    e, n64, n32 = res["ccsd e"], len(res["e history"]), s.n_iterations_f32
    err = abs(e - E_JAX_CCSD_NONCANONICAL)
    check(n32 >= 1 and err <= 1e-8 and abs(res["dE"]) <= 1e-10
          and float(res["t1"].abs().max()) > 1e-4,
          f"mixed mf-CCSD nP={q['nP']}: E={e:.13f} vs JAX "
          f"{E_JAX_CCSD_NONCANONICAL}, dE {res['dE']:.1e}, {n32} f32 "
          "iterations")
    ref = mf_walls["non-canonical"]
    print(f"[{card}] mf-CCSD non-canonical nP={q['nP']} "
          f"mixed_precision=True: E={e:.13f}, |E - E_jax| = {err:.2e}, "
          f"{n32} f32 + {n64} f64 iterations; wall {wall:.2f} s (phase 7, "
          f"f64: {ref['wall']:.2f} s in {len(ref['e history'])} "
          "iterations)", flush=True)
    for k in mf_kernels:
        want[k + "_f32"] = want.get(k + "_f32", 0) + n32
        want[k] = want.get(k, 0) + n64
    for k, v in {"ovvv_gather": 4 * n64, "ovvv_gather_f32": 4 * n32,
                 "ovvv_gather_diag": 2 * n64,
                 "ovvv_gather_diag_f32": 2 * n32}.items():
        want[k] = want.get(k, 0) + v
    return want


def prec_phase(problems, q, results, mf_res, eom_cases, eom_walls, lih,
               mols, device, card, launches, compare):
    """Phase 25: the f32 kernels of the precision modes against their f32
    twins and timed at nP=219 (f32 K1 and K4 at their nP=219 widths beside
    the f64 kernels, :func:`prec_ladder_gather`), then the mixed EOM, the
    mixed CCD and the CCSD modes, each path in a counted window whose
    launches must equal what its solves imply.  Returns the kernels' times
    and bounds and the f32 K1/K4 sub-entries of the kernels line."""
    import torch

    t0 = time.time()
    x = prec_inputs(q, eom_cases[1][2], 61)
    errs, _ = compare_prec_kernels(x, q)
    compare.append(errs)
    t = time_prec_kernels(x, q)
    b = prec_bounds(q)
    del x
    torch.cuda.empty_cache()
    for name in PREC_KERNELS:
        print(f"[{card}] nP={q['nP']} {name}: kernel {t[name][0]:.4f} ms, "
              f"twin {t[name][1]:.4f} ms per call; bound {b[name][0]:.4f} "
              f"ms ({b[name][1]}), the kernel at {b[name][0] / t[name][0]:.3f}"
              " of it", flush=True)
    errs, sub = prec_ladder_gather(problems[14], q, 62, card)
    compare.append(errs)
    tight = eom_tight(eom_cases, device)
    counted_exactly("mixed EOM", lambda: eom_mixed(
        eom_cases, tight, lih, eom_walls, device, card), launches)
    counted_exactly("mixed CCD", lambda: ccd_mixed(
        problems, results, device, card), launches)
    counted_exactly("CCSD precision modes", lambda: ccsd_prec(
        q, mols["LiH"], mf_res, device, card), launches)
    for name in PREC_KERNELS:
        check(sum(launches[w][name] for w in (
            "mixed EOM", "mixed CCD", "CCSD precision modes")) > 0,
              f"kernel {name} never launched on the precision-mode paths")
    print(f"phase 25 (precision modes): {time.time() - t0:.2f} s",
          flush=True)
    return t, b, sub


def generic_seed(p5, V, T2, lih, device):
    """Phase 20 set-up, outside the counted window: the port's Davidson at
    nP=57 with ``GENERIC57_N_EXCIT`` roots (|dE| < 1e-10), which straddle
    the FEAST window, and on LiH; their roots and first Ritz vectors."""
    out = {}
    for label, (fock, V_, T2_, n_excit) in (
            ("nP=57", (p5["fock"], V, T2, GENERIC57_N_EXCIT)),
            ("LiH", (*lih, 2))):
        from pymes_tpu_torch.solver import eom_ccsd

        t0 = time.time()
        s = eom_ccsd.EOM_CCSD(T2_.shape[-1], device=device, n_excit=n_excit)
        s.e_epsilon = 1e-10
        s.max_iter = 1000
        roots = np.sort(np.real(s.solve(fock, V_, T2_)))
        u = np.concatenate([s.u_singles[0].cpu().numpy().ravel(),
                            s.u_doubles[0].cpu().numpy().ravel()])
        print(f"Davidson {label} (n_excit={n_excit}): roots {roots} in "
              f"{s.n_iterations} iterations, {time.time() - t0:.2f} s",
              flush=True)
        out[label] = (roots, float(np.real(s.e_excit[0])),
                      u / np.linalg.norm(u))
    return out


def near(got, want, tol):
    """Every value of ``got`` within ``tol`` of one of ``want`` (and
    ``want`` not empty)."""
    want = np.asarray(want)
    return len(want) > 0 and all(np.min(np.abs(want - g)) <= tol
                                 for g in got)


def generic_phase(p5, V, T2, lih, seeds, feast_roots, device, card):
    """Phase 20: the generic FEAST kernel (host gcrotmk over ONE batched
    sigma a matvec, ``eom_ccsd.PackedSigma``) at nP=57 against the port's
    Davidson and phase 12's FEAST roots, one CIF step from the Davidson
    vector, and the PySCF-shaped adapters over the card's LiH sigma.
    Returns the launch counts the window must hold: on the no-ovvv
    operator K1 = matvecs + 1 (H̄ built once), K4 = 3·matvecs, K5 =
    matvecs; on LiH (dense) K5 = matvecs."""
    import torch

    from pymes_tpu_torch.solver import (eom_ccsd, feast_eom_rccsd,
                                        feast_kernel)

    e_c, e_r = GENERIC57["e_c"], GENERIC57["e_r"]
    roots_dav, _, _ = seeds["nP=57"]
    dav_in = roots_dav[np.abs(roots_dav - e_c) < e_r]
    ph12 = np.real(feast_roots[np.abs(feast_roots.real - e_c) < e_r])
    s57 = eom_solver(NO, device)
    t0 = time.perf_counter()
    op = eom_ccsd.PackedSigma(s57, p5["fock"], V, T2)
    ev, _ = feast_kernel.feast(op.matvec, op.diag, **GENERIC57)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_feast = s57.n_sigma
    ev = np.sort(ev.real)
    inside = ev[np.abs(ev - e_c) < e_r]
    check(len(inside) >= 1 and len(dav_in) >= 1
          and near(inside, dav_in, 1e-6) and near(dav_in, inside, 1e-6),
          f"generic FEAST nP=57: in-window roots {inside} vs Davidson "
          f"{dav_in}")
    check(near(inside, ph12, 1e-6) and near(ph12, inside, 1e-6),
          f"generic FEAST nP=57: in-window roots {inside} vs phase 12 "
          f"{ph12}")
    err = max(np.min(np.abs(dav_in - g)) for g in inside)
    print(f"generic FEAST nP=57 ({GENERIC57}): {len(inside)} roots in the "
          f"window, max |root - Davidson| = {err:.2e}, all Ritz values {ev}; "
          f"{n_feast} matvecs, {wall:.2f} s, {wall * 1e3 / n_feast:.3f} ms "
          "per matvec", flush=True)

    _, root, u0 = seeds["nP=57"]
    t0 = time.perf_counter()
    q = feast_kernel.rt_step(op.matvec, op.diag, u0, e_c=root,
                               **GENERIC57_RT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_rt = s57.n_sigma - n_feast
    dt = GENERIC57_RT["dt"]
    e_step = float(np.angle(np.vdot(u0, q)) / dt)
    norm = float(np.linalg.norm(q))
    check(abs(e_step - root) <= 1e-6,
          f"generic rt_step nP=57: phase energy {e_step} vs root {root}")
    check(abs(norm - 1.0) <= 1e-8, f"generic rt_step nP=57: norm {norm}")
    print(f"generic rt_step nP=57 ({GENERIC57_RT}): phase energy "
          f"{e_step:.13f}, |E - root| = {abs(e_step - root):.2e}, |norm - 1| "
          f"= {abs(norm - 1):.2e}; {n_rt} matvecs, {wall:.2f} s, "
          f"{wall * 1e3 / n_rt:.3f} ms per matvec", flush=True)
    # the matvec alone (23 calls, in the window's count): what the card
    # path costs of each ms per matvec above; the rest is GCROT on the host
    xc = u0 + 1j * np.roll(u0, 1)
    print(f"[{card}] packed matvec nP=57 alone (one complex vector: one "
          f"2-row sigma, up and down): {cuda_ms(lambda: op.matvec(xc)):.3f} "
          "ms per call", flush=True)

    roots_lih, root_lih, u_lih = seeds["LiH"]
    sl = eom_solver(lih[2].shape[-1], device)
    eom = eom_ccsd.PackedSigma(sl, *lih)
    t0 = time.perf_counter()
    fs = feast_eom_rccsd.FEAST_EOMEESinglet(eom=eom)
    fs.max_cycle, fs.ls_max_iter = LIH_ADAPTER["max_cycle"], \
        LIH_ADAPTER["ls_max_iter"]
    ev, _ = fs.kernel(n_jobs=1, **LIH_ADAPTER["feast"])
    ev = np.sort(ev.real)
    n_f = sl.n_sigma
    check(near(roots_lih, ev, 1e-6) and near(LIH_EOM_ORACLE, roots_lih,
                                              1e-6),
          f"FEAST_EOMEESinglet LiH: {ev} vs Davidson {roots_lih}")
    cs = feast_eom_rccsd.CIFRT_EOMEESinglet(eom=eom)
    cs.ls_conv_tol = GENERIC57_RT["ls_conv_tol"]
    q = cs.kernel(dt=dt, e_c=root_lih, e_r=GENERIC57_RT["e_r"],
                  ngl_pts=GENERIC57_RT["ngl_pts"], guess=[u_lih])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    e_lih = float(np.angle(np.vdot(u_lih, q)) / dt)
    check(abs(e_lih - root_lih) <= 1e-6,
          f"CIFRT_EOMEESinglet LiH: phase energy {e_lih} vs {root_lih}")
    err = max(np.min(np.abs(ev - r)) for r in roots_lih)
    print(f"adapters on LiH/3-21G: FEAST_EOMEESinglet roots {ev} (max_cycle "
          f"{fs.max_cycle}, ls_max_iter {fs.ls_max_iter}), max |Davidson "
          f"root - FEAST| = {err:.2e}; CIFRT_EOMEESinglet phase energy "
          f"{e_lih:.13f}, |E - root| = {abs(e_lih - root_lih):.2e}; "
          f"{n_f} + {sl.n_sigma - n_f} "
          f"matvecs, {wall:.2f} s, {wall * 1e3 / sl.n_sigma:.3f} ms per "
          "matvec", flush=True)
    n = s57.n_sigma
    return {"block_ladder": n + 1, "ovvv_gather": 3 * n,
            "pair_symmetrize": n + sl.n_sigma}


def mesh_phase(p5, V, T2, ref, device):
    """Phase 21: phase 12's FEAST nP=57 with its nodes fanned out over
    ``node_mesh(P, devices=["cuda:0"] * P)``, P = 2 and 4: roots
    within 1e-10 of phase 12's in its iterations, one lane chunk a device
    and iteration (64 / P lanes), and K7/K8 held exactly to those
    chunks."""
    import torch

    from pymes_tpu_torch import kernels
    from pymes_tpu_torch.parallel import sharding

    s12 = ref["solver"]
    for P in NODE_MESHES:
        t0 = time.time()
        before = dict(kernels.LAUNCHES)
        mesh = sharding.node_mesh(P, device=device, axis="a",
                                  devices=[f"{device}:0"] * P)
        torch.cuda.reset_peak_memory_stats()
        s, roots = feast_run(p5["fock"], V, T2, device,
                             dict(FEAST57, node_mesh=mesh), FEAST57_GMRES)
        peak = torch.cuda.max_memory_allocated()
        st = s.ls_stats
        label = f"FEAST nP=57 over {P} shares"
        check_krylov_launches(label, before, s.n_sigma, st, ladder=True)
        lanes = [len(np.atleast_1d(a)) for a in st["steps"]]
        share = K4_LANES["FEAST"] // P
        check(lanes == [share] * (P * s.n_iterations),
              f"{label}: lanes per chunk {lanes}")
        err = float(np.abs(roots - ref["roots"]).max()) \
            if roots.shape == ref["roots"].shape else np.inf
        check(err <= 1e-10 and s.n_iterations == s12.n_iterations,
              f"{label}: roots {roots} in {s.n_iterations} iterations vs "
              f"phase 12 {ref['roots']} in {s12.n_iterations}")
        print(f"{label} of one card: max |roots - phase 12| = {err:.2e} in "
              f"{s.n_iterations} iterations, lanes per chunk"
              f" {lanes}, walls per iteration "
              f"{[round(w, 3) for w in s.iter_walls]} s (phase 12: "
              f"{[round(w, 3) for w in s12.iter_walls]} s), peak device "
              f"memory {peak / 1e9:.3f} GB (phase 12: "
              f"{ref['peak'] / 1e9:.3f} GB), {time.time() - t0:.2f} s",
              flush=True)
        del s
        torch.cuda.empty_cache()


def native_phase(card):
    """Phase 22: the native record parser ran for the dumps the molecular
    paths read, and equals the numpy parse bit for bit on every dump of
    ``tests/data`` and on a synthetic body of 1 M records with Fortran
    ``D`` exponents; both parse times on this machine's host."""
    from pymes_tpu_torch import _native
    from pymes_tpu_torch.util import fcidump, tcdump

    check(_native.PARSES["native"] > 0 and _native.PARSES["numpy"] == 0,
          f"native parser: parses {_native.PARSES}")

    def same(a, b):
        return (np.array_equal(a[0].view(np.int64), b[0].view(np.int64))
                and np.array_equal(a[1], b[1]))

    names = sorted(p.name for p in DATA.iterdir()
                   if p.name.startswith(("FCIDUMP", "TCDUMP")))
    for name in names:
        with open(DATA / name) as reader:
            if name.startswith("FCIDUMP"):
                fcidump._parse_header(reader)
                k, numpy_parse = 4, fcidump._numpy_parse
            else:
                reader.readline()
                k, numpy_parse = 6, tcdump._numpy_parse
            body = reader.read()
        got = _native.parse_integral_lines(body, k)
        check(len(got[0]) > 0 and same(got, numpy_parse(body)),
              f"native parser: {name} differs from the numpy parse")
    rng = np.random.default_rng(22)
    n = 1_000_000
    vals = rng.standard_normal(n) * 10.0 ** rng.integers(-12, 2, n)
    idx = rng.integers(1, 120, (n, 4))
    body = "\n".join(
        f"{v:.16E} {a} {b} {c} {d}".replace("E", "D")
        for v, (a, b, c, d) in zip(vals.tolist(), idx.tolist())) + "\n"
    t0 = time.perf_counter()
    got = _native.parse_integral_lines(body)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = fcidump._numpy_parse(body)
    t_numpy = time.perf_counter() - t0
    check(same(got, want) and np.array_equal(got[0], vals)
          and np.array_equal(got[1], idx),
          "native parser: the synthetic body differs from the numpy parse")
    print(f"native parser: bit-equal to the numpy parse on {len(names)} "
          f"dumps ({', '.join(names)}) and on {n} records with D exponents "
          f"({len(body) / 1e6:.1f} MB); parse time on the host of "
          f"[{card}]: native {t_native:.3f} s, numpy {t_numpy:.3f} s "
          f"({t_numpy / t_native:.1f}x); parses this run {_native.PARSES}",
          flush=True)
    return t_native, t_numpy


def tc_model(cutoff):
    """The transcorrelated UEG of phase 18: 14 electrons, rs = 0.5, the
    ``gaskell`` correlator's ``k_cutoff`` as ``tests/test_ueg.py:114``."""
    from pymes_tpu_torch.models import ueg

    u = ueg.UEG(14, NO, NO, TC_RS)
    u.init_single_basis(cutoff)
    u.gamma = None
    u.k_cutoff = u.L / (2 * np.pi) * 2.3225029893472993 / TC_RS
    return u


def setup_tc(cutoff, device):
    """Phase 18 set-up on the host, each build on its own model in a thread
    of one pool (numpy's large operations release the GIL): the sparse
    integrals of the non-hermitian class (``is_only_2b``) and of the
    hermitian one (``is_only_hermi_2b``), the virtual non-hermitian plan,
    the all-bra hermitian plan and the three hermitian OVVV plans; then the
    named blocks on the card, the diagonal HF Fock of each class, the
    seeded non-canonical Fock (noise rng(5)·0.02, symmetrised) and the MP2
    guesses.  Prints each build's host seconds and the wall."""
    import torch
    from concurrent.futures import ThreadPoolExecutor

    from pymes_tpu_torch.mean_field import hf
    from pymes_tpu_torch.models import ueg
    from pymes_tpu_torch.ops import ueg_ladder
    from pymes_tpu_torch.solver import mp2

    nh, herm = {"is_only_2b": True}, {"is_only_hermi_2b": True}

    def timed(fn):
        t0 = time.time()
        u = tc_model(cutoff)
        return fn(u), time.time() - t0

    builds = {
        "integrals is_only_2b": lambda u: u.eval_2b_integrals(
            correlator=u.gaskell, sp=2, **nh),
        "integrals is_only_hermi_2b": lambda u: u.eval_2b_integrals(
            correlator=u.gaskell, sp=2, **herm),
        "virtual non-hermitian plan": lambda u:
            ueg_ladder.build_block_ladder(u, device=device,
                                          correlator=u.gaskell,
                                          **nh),
        "all-bra hermitian plan": lambda u: ueg_ladder.build_block_ladder(
            u, device=device, correlator=u.gaskell, bra="all", **herm),
        **{f"OVVV plan {pat}": (lambda u, pat=pat:
                                ueg_ladder.build_ovvv_t1_plan(
                                    u, pat, device=device,
                                    correlator=u.gaskell, **herm))
           for pat in ("vvo", "ovv", "vov")}}
    t0 = time.time()
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        futures = {k: pool.submit(timed, fn) for k, fn in builds.items()}
        out = {k: f.result() for k, f in futures.items()}
    host = {k: s for k, (_, s) in out.items()}
    wall = time.time() - t0
    u = tc_model(cutoff)
    n_p, nv = u.n_spatial, u.n_spatial - NO
    kin = u.kinetic_energies()
    tc = {"cutoff": cutoff, "nP": n_p, "nv": nv, "ueg": u,
          "host_s": host, "host_wall_s": wall}
    for kind, flags_name in (("nh", "is_only_2b"),
                             ("herm", "is_only_hermi_2b")):
        idx, vals = out[f"integrals {flags_name}"][0]
        d = ueg.sparse_to_blocks(idx, vals, n_p, NO, device=device, names=NEED)
        eps_i = hf.calcOccupiedOrbE(kin, d["klij"], NO)
        eps_a = hf.calcVirtualOrbE(kin, d["aibj"], d["aijb"], NO, nv)
        tc[kind] = {"dict": d, "sparse": (idx, vals), "eps_i": eps_i,
                    "eps_a": eps_a,
                    "fock": torch.diag(torch.cat([eps_i, eps_a]))}
    p = tc["nh"]
    plan = out["virtual non-hermitian plan"][0]
    p["blocks"] = ccd_blocks(p["dict"], plan)
    p["T0"] = mp2.solve(p["eps_i"], p["eps_a"], p["dict"]["ijab"],
                        p["dict"]["abij"], -1.0)[1]
    q = tc["herm"]
    q["plan_all"] = out["all-bra hermitian plan"][0]
    q["mf_dict"] = dict(q["dict"])
    q["mf_dict"]["_ovvv_plans"] = {
        pat: out[f"OVVV plan {pat}"][0] for pat in ("vvo", "ovv", "vov")}
    eps = torch.cat([q["eps_i"], q["eps_a"]]).cpu().numpy()
    noise = np.random.default_rng(5).standard_normal((n_p, n_p)) * 0.02
    q["fock_nc"] = torch.as_tensor(np.diag(eps) + noise + noise.T,
                                   device=q["fock"].device)
    torch.cuda.synchronize()
    print(f"setup TC nP={n_p} (gaskell): host builds in one pool of "
          f"{len(builds)} threads, wall {wall:.2f} s; " + ", ".join(
              f"{k} {s:.2f} s" for k, s in host.items())
          + f"; blocks and Fock on the card {time.time() - t0 - wall:.2f} "
          "s", flush=True)
    return tc


def ccd_blocks(d, ladder=None, abcd=None):
    from pymes_tpu_torch.solver import ccd

    return ccd.CCDBlocks(klij=d["klij"], ijab=d["ijab"], abij=d["abij"],
                         iajb=d["iajb"], iabj=d["iabj"], abcd=abcd,
                         ladder=ladder)


def compare_tc_kernels(tc, seed):
    """K1 against its twin on the virtual non-hermitian plan and on the
    all-bra hermitian plan (N = no², 1e-12·max), K4 bit for bit on the
    hermitian-TC OVVV plans at the dressing's 7 columns and its fused trace
    (1e-12·max); returns max abs errors."""
    import torch

    from pymes_tpu_torch.ops import ueg_ladder

    rng = np.random.default_rng(seed)
    nv, dev = tc["nv"], tc["nh"]["fock"].device
    T = torch.as_tensor(rng.standard_normal((NO, NO, nv, nv)) * 0.01,
                        device=dev)
    e1 = 0.0
    for label, plan in (("non-hermitian virtual",
                         tc["nh"]["blocks"].ladder),
                        ("hermitian all-bra", tc["herm"]["plan_all"])):
        got = ueg_ladder.block_ladder_apply_ij(plan, T)
        want = ueg_ladder.block_ladder_apply_ij(plan, T, twin=True)
        e1 = max(e1, rel_err(got, want, f"K1 on the TC {label} plan"))
    T1 = torch.as_tensor(rng.standard_normal((nv, NO)) * 0.01, device=dev)
    plans = tc["herm"]["mf_dict"]["_ovvv_plans"]
    e4 = max(bit_equal(ueg_ladder.ovvv_t1_apply_j(plan, T1),
                       ueg_ladder.ovvv_t1_apply_j(plan, T1, twin=True),
                       f"K4 on the TC {pat} plan")
             for pat, plan in plans.items())
    e4d = max(rel_err(ueg_ladder.ovvv_t1_trace(plans[pat], T1, axis),
                      ueg_ladder.ovvv_t1_trace(plans[pat], T1, axis,
                                               twin=True),
                      f"K4 trace on the TC {pat} plan")
              for pat, axis in DIAG_PLANS)
    print(f"kernel vs twin, TC nP={tc['nP']}: block_ladder max_abs_err="
          f"{e1:.3e} (non-hermitian virtual, hermitian all-bra), ovvv_gather"
          f" {e4:.1e} (bit for bit), ovvv_gather_diag {e4d:.3e}", flush=True)
    return {"block_ladder": e1, "ovvv_gather": e4, "ovvv_gather_diag": e4d}


def tc_mf_ccd(tc, device, out):
    """Phase 18(a): non-hermitian TC CCD through K1 on the virtual plan to
    |dE| < 1e-8, within 1e-9 of the JAX package in its iteration count,
    one K1, K2, K3 and K5 launch an iteration and no other."""
    import torch

    from pymes_tpu_torch import kernels
    from pymes_tpu_torch.solver import ccd

    t0 = time.time()
    p, (e_ref, n_ref) = tc["nh"], TC_JAX[tc["cutoff"]]["ccd"]
    before = dict(kernels.LAUNCHES)
    res = ccd.CCD(NO, device=device).solve(p["fock"], p["blocks"],
                                           level_shift=-1.0, max_iter=60)
    e, n, T = res["ccd e"], len(res["e history"]), res["t2 amp"]
    got = {k: kernels.LAUNCHES[k] - before[k] for k in KERNELS}
    want = dict.fromkeys(KERNELS, 0)
    want.update(dict.fromkeys(CCD_KERNELS, n))
    check(got == want, f"TC mf-CCD: launches {got}, expected {want} for {n} "
          "iterations")
    check(T.shape == (tc["nv"], tc["nv"], NO, NO)
          and bool(torch.isfinite(T).all()),
          "TC mf-CCD: amplitudes not finite or of the wrong shape")
    check(abs(e - e_ref) <= 1e-9 and n == n_ref,
          f"TC mf-CCD nP={tc['nP']}: E={e:.13f} in {n} iterations vs the JAX "
          f"package's {e_ref} in {n_ref}")
    print(f"TC mf-CCD (gaskell, is_only_2b) nP={tc['nP']}: E={e:.13f} in {n} "
          f"iterations, |E - E_jax|={abs(e - e_ref):.2e}, launches "
          f"{ {k: v for k, v in got.items() if v} }, {time.time() - t0:.2f} s",
          flush=True)
    out.update(e=e, n=n, e_hist=res["e history"],
               launches={k: got[k] for k in CCD_KERNELS})


def tc_dense_ccd(tc, e_hist, device):
    """Phase 18(a), the dense check: the TC ``abcd`` scattered on the card
    (16.2 GB at nP=219) and TC_DENSE_ITERS iterations of the dense-abcd CCD
    from the same guess, each energy within 1e-10 of the matrix-free
    solve's."""
    import torch

    from pymes_tpu_torch.models import ueg
    from pymes_tpu_torch.solver import ccd

    t0 = time.time()
    p = tc["nh"]
    abcd = ueg.sparse_to_blocks(*p["sparse"], tc["nP"], NO, device=device,
                                names=("abcd",))["abcd"]
    gb = abcd.numel() * 8 / 1e9
    out = ccd.ccd_solve(p["fock"], ccd_blocks(p["dict"], abcd=abcd), NO,
                        p["T0"], level_shift=-1.0, delta_e=-1.0,
                        max_iter=TC_DENSE_ITERS - 1)
    dense = out[6].cpu().numpy()
    del abcd, out
    torch.cuda.empty_cache()
    gap = float(np.abs(dense - e_hist[:TC_DENSE_ITERS]).max())
    check(len(dense) == TC_DENSE_ITERS and np.isfinite(dense).all()
          and gap <= 1e-10, f"TC CCD nP={tc['nP']}: dense-abcd energies "
          f"{dense} vs matrix-free {e_hist[:TC_DENSE_ITERS]}")
    print(f"TC CCD nP={tc['nP']}: dense abcd {gb:.2f} GB on the card, its "
          f"first {TC_DENSE_ITERS} energies within {gap:.2e} of the "
          f"matrix-free solve's, {time.time() - t0:.2f} s", flush=True)
    return gap


def tc_mf_ccsd(tc, device, out):
    """Phase 18(b): hermitian-TC matrix-free CCSD (all-bra plan, TC OVVV
    plans, seeded non-canonical Fock: T1 ≠ 0) to |dE| < 1e-10, within 1e-9
    of the JAX package in its iteration count; K4 4 gathers and 2 traces an
    iteration, K1, K2′, K3′ and K5 one."""
    import torch

    from pymes_tpu_torch import kernels
    from pymes_tpu_torch.solver import ccsd

    t0 = time.time()
    q, (e_ref, n_ref) = tc["herm"], TC_JAX[tc["cutoff"]]["ccsd"]
    before = dict(kernels.LAUNCHES)
    res = ccsd.CCSD(NO, device=device).solve(
        q["fock_nc"], q["mf_dict"], level_shift=-1.0, ladder=q["plan_all"],
        delta_e=1e-10, max_iter=100)
    e, n = res["ccsd e"], len(res["e history"])
    got = {k: kernels.LAUNCHES[k] - before[k] for k in KERNELS}
    want = dict.fromkeys(KERNELS, 0)
    want.update(dict.fromkeys(MF_CCSD_KERNELS, n))
    want.update(ovvv_gather=4 * n, ovvv_gather_diag=2 * n)
    check(got == want, f"TC mf-CCSD: launches {got}, expected {want} for {n}"
          " iterations")
    t1max = float(res["t1"].abs().max())
    check(res["t2"].shape == (tc["nv"], tc["nv"], NO, NO)
          and bool(torch.isfinite(res["t2"]).all())
          and bool(torch.isfinite(res["t1"]).all()) and t1max > 1e-4,
          f"TC mf-CCSD: amplitudes not finite, misshapen or T1 ≡ 0 "
          f"(|T1|max {t1max:.3e})")
    check(abs(e - e_ref) <= 1e-9 and n == n_ref,
          f"TC mf-CCSD nP={tc['nP']}: E={e:.13f} in {n} iterations vs the "
          f"JAX package's {e_ref} in {n_ref}")
    print(f"TC mf-CCSD (gaskell, is_only_hermi_2b, non-canonical) "
          f"nP={tc['nP']}: E={e:.13f} in {n} iterations, |E - E_jax|="
          f"{abs(e - e_ref):.2e}, |T1|max={t1max:.3e}, launches "
          f"{ {k: v for k, v in got.items() if v} }, {time.time() - t0:.2f} s",
          flush=True)
    out.update(e=e, n=n, launches={k: got[k] for k in MF_CCSD_KERNELS})


def drccd_np57(p, device, out):
    """Phase 18(c): Coulomb drCCD on the nP=57 dense blocks (no ladder) to
    |dE| < 1e-8, within 1e-9 of the JAX package in its iteration count;
    one K2 and one K3 launch an iteration and no other."""
    import torch

    from pymes_tpu_torch import kernels
    from pymes_tpu_torch.solver import ccd

    t0 = time.time()
    before = dict(kernels.LAUNCHES)
    res = ccd.CCD(NO, device=device, is_dr_ccd=True).solve(
        p["fock"], ccd_blocks(p["dict"]), level_shift=-1.0, max_iter=60)
    e, n, T = res["ccd e"], len(res["e history"]), res["t2 amp"]
    got = {k: kernels.LAUNCHES[k] - before[k] for k in KERNELS}
    want = dict.fromkeys(KERNELS, 0)
    want.update(ccd_jacobi_diis=n, ccd_mix_energy=n)
    check(got == want, f"drCCD: launches {got}, expected {want} for {n} "
          "iterations")
    check(T.shape == (p["nv"], p["nv"], NO, NO)
          and bool(torch.isfinite(T).all()),
          "drCCD: amplitudes not finite or of the wrong shape")
    check(abs(e - E_JAX_DRCCD_NP57) <= 1e-9 and n == N_IT_JAX_DRCCD_NP57,
          f"drCCD nP={p['nP']}: E={e:.13f} in {n} iterations vs the JAX "
          f"package's {E_JAX_DRCCD_NP57} in {N_IT_JAX_DRCCD_NP57}")
    print(f"drCCD nP={p['nP']}: E={e:.13f} in {n} iterations, |E - E_jax|="
          f"{abs(e - E_JAX_DRCCD_NP57):.2e}, launches "
          f"{ {k: v for k, v in got.items() if v} }, {time.time() - t0:.2f} s",
          flush=True)
    out.update(e=e, n=n, launches={k: got[k] for k in
                                   ("ccd_jacobi_diis", "ccd_mix_energy")})


def time_tc(tc, coulomb_plan, seed):
    """Phase 18 timing: ms/iteration of the fixed-61-iteration TC mf-CCD
    (min of 5, kernels and twins; every run must stay finite), K1 per call
    on the non-hermitian plan at N = no² (held to its twin in
    :func:`compare_tc_kernels`) with the Coulomb plan of the same buckets
    beside it (Coulomb, TC, TC, Coulomb on the same operand), and K4 per
    call on the hermitian-TC OVVV plans at 7 columns (bit for bit against
    its twin first)."""
    import torch

    from pymes_tpu_torch.ops import ueg_ladder

    p = {**tc["nh"], "nv": tc["nv"]}
    walls = {False: [], True: []}
    n_fixed = 0
    for _ in range(5):
        for twin in (False, True):
            ms, n_fixed, e = solve_fixed(p, twin)
            check(np.isfinite(e), "the fixed-iteration TC mf-CCD went "
                  f"non-finite (twin={twin})")
            walls[twin].append(ms)
    rng = np.random.default_rng(seed)
    dev, nv = p["fock"].device, tc["nv"]
    T = torch.as_tensor(rng.standard_normal((NO, NO, nv, nv)) * 0.01,
                        device=dev)
    plan = p["blocks"].ladder
    t = [cuda_ms(lambda: ueg_ladder.block_ladder_apply_ij(plan, T, twin=tw))
         for tw in (True, False, False, True)]
    tk = [cuda_ms(lambda: ueg_ladder.block_ladder_apply_ij(pl, T))
          for pl in (coulomb_plan, plan, plan, coulomb_plan)]
    T1 = torch.as_tensor(rng.standard_normal((nv, NO)) * 0.01, device=dev)
    k4 = time_k4(tc["herm"]["mf_dict"]["_ovvv_plans"], T1,
                 "TC hermitian, 7 columns", alone=False)
    return {"fixed": (min(walls[False]), min(walls[True]), n_fixed),
            "k1": ((t[1] + t[2]) / 2, (t[0] + t[3]) / 2,
                   ladder_bound(plan, NO * NO)),
            "k1 TC / Coulomb": ((tk[1] + tk[2]) / 2, (tk[0] + tk[3]) / 2),
            "k4": k4}


def tc_phase(problems, device, card, launches, compare):
    """Phase 18: the transcorrelated UEG at nP=219 (host set-up, kernels
    against their twins on the TC plans, the dense-abcd check: all outside
    the counted windows), the non-hermitian mf-CCD, the hermitian-TC
    mf-CCSD and drCCD at nP=57 in counted windows (added to ``launches``),
    then the timing.  Appends the kernel errors to ``compare``; returns the
    runs as sub-entries of their kernels' JSON entries."""
    import torch

    t18 = time.time()
    tc = setup_tc(TC_CUTOFF, device)
    tc_err = compare_tc_kernels(tc, 20)
    compare.append(tc_err)
    tc_runs = {"ccd": {}, "ccsd": {}, "drccd": {}}
    launches["TC mf-CCD"] = path_launches(
        "TC mf-CCD", lambda: tc_mf_ccd(tc, device, tc_runs["ccd"]),
        CCD_KERNELS)
    tc_dense_ccd(tc, tc_runs["ccd"]["e_hist"], device)
    launches["TC mf-CCSD"] = path_launches(
        "TC mf-CCSD", lambda: tc_mf_ccsd(tc, device, tc_runs["ccsd"]),
        MF_CCSD_KERNELS)
    launches["drCCD"] = path_launches(
        "drCCD", lambda: drccd_np57(problems[5], device, tc_runs["drccd"]),
        ("ccd_jacobi_diis", "ccd_mix_energy"))
    tc_t = time_tc(tc, problems[14]["blocks"].ladder, 21)
    fx_k, fx_t, n_fixed = tc_t["fixed"]
    print(f"[{card}] TC nP={tc['nP']} fixed-{n_fixed}-iteration mf-CCD "
          f"(non-hermitian), min of 5: kernels {fx_k:.3f} ms/iter, twins "
          f"{fx_t:.3f} ms/iter", flush=True)
    k1_ms, k1_plain, k1_b = tc_t["k1"]
    k1_tc, k1_coul = tc_t["k1 TC / Coulomb"]
    print(f"[{card}] TC nP={tc['nP']} block_ladder on the non-hermitian "
          f"plan, N = no^2: kernel {k1_ms:.4f} ms, twin {k1_plain:.4f} ms per"
          f" call; bound {k1_b[0]:.4f} ms ({k1_b[1]}); in turns with the "
          f"Coulomb plan (Coulomb, TC, TC, Coulomb): TC {k1_tc:.4f} ms, "
          f"Coulomb {k1_coul:.4f} ms", flush=True)
    k4_ms, k4_plain, _, k4_b, _ = tc_t["k4"]
    print(f"[{card}] TC nP={tc['nP']} ovvv_gather on the hermitian-TC plans, "
          f"7 columns: kernel {k4_ms:.4f} ms, twin {k4_plain:.4f} ms per "
          f"call; bound {k4_b[0]:.4f} ms ({k4_b[1]})", flush=True)
    print(f"phase 18 (TC set-up, checks, solves and timing): "
          f"{time.time() - t18:.2f} s", flush=True)
    n_tc = tc["nP"]
    del tc
    torch.cuda.empty_cache()
    # the TC and drCCD runs as sub-entries of their kernels' JSON entries
    tc_sub = {}
    for label, run, names in (
            (f"TC mf-CCD nP={n_tc}", tc_runs["ccd"], CCD_KERNELS),
            (f"TC mf-CCSD nP={n_tc}", tc_runs["ccsd"], MF_CCSD_KERNELS),
            (f"drCCD nP={problems[5]['nP']}", tc_runs["drccd"],
             ("ccd_jacobi_diis", "ccd_mix_energy"))):
        for name in names:
            tc_sub.setdefault(name, {})[label] = {
                "launches": run["launches"][name], "iterations": run["n"],
                "energy": run["e"]}
    ccd_lab, ccsd_lab = (f"TC mf-CCD nP={n_tc}", f"TC mf-CCSD nP={n_tc}")
    for name in CCD_KERNELS:
        tc_sub[name][ccd_lab].update(
            ms_per_iter=fx_k, plain_ms_per_iter=fx_t)
    tc_sub["block_ladder"][ccd_lab].update(
        max_abs_err=tc_err["block_ladder"], ms=k1_ms, plain_ms=k1_plain,
        bound_ms=k1_b[0], bound_by=k1_b[1], in_turns_ms=k1_tc,
        coulomb_plan_in_turns_ms=k1_coul)
    tc_sub["ovvv_gather"][ccsd_lab].update(
        max_abs_err=tc_err["ovvv_gather"], ms=k4_ms, plain_ms=k4_plain,
        bound_ms=k4_b[0], bound_by=k4_b[1])
    tc_sub["ovvv_gather_diag"][ccsd_lab]["max_abs_err"] = \
        tc_err["ovvv_gather_diag"]
    return tc_sub


def tp_mesh(n, shape, device):
    """A mesh of ``n`` shares of one card, 1-D ("a",) or 2-D ("a", "b")
    of ``shape``."""
    from pymes_tpu_torch.parallel import mesh

    axes = ("a",) if shape is None else ("a", "b")
    return mesh.make_mesh(n, device=device, axis_names=axes, shape=shape,
                          devices=[device] * n)


def tp_label(n, shape):
    return f"{n} shards" if shape is None else "{} x {}".format(*shape)


def timed_solve(solver, fock, V, **kw):
    """One converged solve from a reset peak: (result, ms per iteration
    of its wall (host clock, synchronised; set-up and MP2 included),
    peak device memory in bytes)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = solver.solve(fock, V, **kw)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    return (res, wall / len(res["e history"]),
            torch.cuda.max_memory_allocated())


def tp_ccd(p, n_ref, device, launches):
    """Phase 23(a): dense CCD at nP=219 on the ``abcd`` scattered on the
    card and cut, with the blocks it reads, over each mesh of
    ``TP_MESHES`` (the tensor-parallel ladder, one product per piece):
    |dE| < 1e-8, E within 1e-9 of the JAX package in the matrix-free
    CCD's ``n_ref`` iterations, one K2, K3 and K5 launch an iteration;
    its peak memory above the phase's start below abcd + 25 %, beside
    the peak of the gathering path (``Sharded.gather``, then the dense
    solve).  Returns the scattered ``abcd`` and the phase's baseline."""
    import torch

    from pymes_tpu_torch.models import ueg
    from pymes_tpu_torch.parallel import mesh as pmesh
    from pymes_tpu_torch.solver import ccd

    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    t0 = time.time()
    abcd = ueg.sparse_to_blocks(*p["sparse"], p["nP"], NO, device=device,
                                names=("abcd",))["abcd"]
    torch.cuda.synchronize()
    size = abcd.numel() * 8
    print(f"tensor-parallel set-up nP={p['nP']}: dense abcd "
          f"{size / 1e9:.3f} GB scattered on the card "
          f"({time.time() - t0:.2f} s); earlier phases hold "
          f"{base / 1e9:.3f} GB", flush=True)
    d = {k: p["dict"][k] for k in ("klij", "ijab", "abij", "iajb", "iabj")}
    d["abcd"] = abcd
    kw = dict(level_shift=-1.0, max_iter=60)
    out = {}
    for n, shape in ((None, None),) + TP_MESHES:
        label = "gathering path" if n is None else tp_label(n, shape)
        m = tp_mesh(*(TP_MESHES[0] if n is None else (n, shape)), device)
        cut = pmesh.shard_blocks(m, d)
        if n is None:
            # the gathering path: abcd put together on the card, whole
            cut["abcd"] = cut["abcd"].gather(device)
            res, ms, peak = timed_solve(ccd.CCD(NO, device=device), p["fock"],
                                        cut,
                                        **kw)
        else:
            def run():
                out["run"] = timed_solve(ccd.CCD(NO, device=device), p["fock"],
                                         cut,
                                         **kw)
                k = len(out["run"][0]["e history"])
                return {"ccd_jacobi_diis": k, "ccd_mix_energy": k,
                        "pair_symmetrize": k}
            counted_exactly(f"tensor-parallel CCD nP={p['nP']}, {label}",
                            run, launches)
            res, ms, peak = out.pop("run")
        del cut
        e, n_it, T = res["ccd e"], len(res["e history"]), res["t2 amp"]
        check(T.shape == (p["nv"], p["nv"], NO, NO)
              and bool(torch.isfinite(T).all()),
              f"tensor-parallel CCD {label}: amplitudes not finite or of "
              "the wrong shape")
        check(abs(e - E_JAX[p["cutoff"]]) <= 1e-9 and abs(res["dE"]) < 1e-8,
              f"tensor-parallel CCD {label}: E={e:.13f} (dE {res['dE']:.2e})"
              f" vs JAX {E_JAX[p['cutoff']]}")
        check(n_it == n_ref, f"tensor-parallel CCD {label}: {n_it} "
              f"iterations, the matrix-free CCD {n_ref}")
        out[label] = (e, ms, peak - base)
        print(f"tensor-parallel CCD nP={p['nP']} ({label} of one card): "
              f"E={e:.13f} in {n_it} iterations, |E - E_jax|="
              f"{abs(e - E_JAX[p['cutoff']]):.2e}, {ms:.3f} ms/iter, peak "
              f"device memory {peak / 1e9:.3f} GB ({(peak - base) / 1e9:.3f} "
              f"GB above the phase's start; abcd {size / 1e9:.3f} GB)",
              flush=True)
        if n is not None:
            check(peak - base < (1 + TP_PEAK_HEADROOM) * size,
                  f"tensor-parallel CCD {label}: peak {peak - base} B above "
                  f"the start, abcd {size} B")
    return abcd, base, out


def tp_ccsd(p, q, abcd, base, device, launches):
    """Phase 23(b): dense CCSD at nP=219 with the seeded non-canonical
    Fock on all 16 blocks scattered on the card and cut over each mesh
    of ``TP_MESHES`` (abcd dressed into new per-piece tiles): |dE| <
    1e-10, E within 1e-9 of the JAX package, T1 ≠ 0, one K2′, K3′ and K5
    launch an iteration; then the unsharded dense CCSD where it fits
    (within 1e-10 of the cut solves), else a line that says it does
    not."""
    import torch

    from pymes_tpu_torch.integral.partition import BLOCK_NAMES
    from pymes_tpu_torch.models import ueg
    from pymes_tpu_torch.parallel import mesh as pmesh
    from pymes_tpu_torch.solver import ccsd

    more = [k for k in BLOCK_NAMES if k not in p["dict"] and k != "abcd"]
    d = {k: p["dict"][k] for k in BLOCK_NAMES if k in p["dict"]}
    d.update(ueg.sparse_to_blocks(*p["sparse"], p["nP"], NO, device=device,
                                  names=more))
    d["abcd"] = abcd
    fock = q["focks"]["non-canonical"]
    kw = dict(level_shift=-1.0, delta_e=1e-10, max_iter=100)
    out = {}
    for n, shape in TP_MESHES:
        label = tp_label(n, shape)
        cut = pmesh.shard_blocks(tp_mesh(n, shape, device), d)

        def run():
            out["run"] = timed_solve(ccsd.CCSD(NO, device=device), fock, cut,
                                     **kw)
            k = len(out["run"][0]["e history"])
            return {"ccsd_jacobi_diis": k, "ccsd_mix_energy": k,
                    "pair_symmetrize": k}

        counted_exactly(f"tensor-parallel CCSD nP={p['nP']}, {label}", run,
                        launches)
        res, ms, peak = out.pop("run")
        del cut
        e, n_it = res["ccsd e"], len(res["e history"])
        t1max = float(res["t1"].abs().max())
        check(bool(torch.isfinite(res["t2"]).all())
              and res["t2"].shape == (p["nv"], p["nv"], NO, NO),
              f"tensor-parallel CCSD {label}: amplitudes not finite or of "
              "the wrong shape")
        check(abs(e - E_JAX_CCSD_NONCANONICAL) <= 1e-9
              and abs(res["dE"]) < 1e-10 and t1max > 1e-4,
              f"tensor-parallel CCSD {label}: E={e:.13f} (dE "
              f"{res['dE']:.2e}, |T1|max {t1max:.3e}) vs JAX "
              f"{E_JAX_CCSD_NONCANONICAL}")
        out[label] = (e, ms, peak - base)
        print(f"tensor-parallel CCSD nP={p['nP']} non-canonical ({label} of "
              f"one card): E={e:.13f} in {n_it} iterations (JAX "
              f"{N_IT_JAX_CCSD_NONCANONICAL}), |E - E_jax|="
              f"{abs(e - E_JAX_CCSD_NONCANONICAL):.2e}, |T1|max={t1max:.3e}, "
              f"{ms:.3f} ms/iter, peak device memory {peak / 1e9:.3f} GB "
              f"({(peak - base) / 1e9:.3f} GB above the phase's start)",
              flush=True)
    try:
        res, ms, peak = timed_solve(ccsd.CCSD(NO, device=device), fock, d,
                                    **kw)
    except torch.cuda.OutOfMemoryError as err:
        res, why = None, str(err).splitlines()[0]
    if res is None:   # the failed solve's frames are released by now
        torch.cuda.empty_cache()
        print(f"unsharded dense CCSD nP={p['nP']} does not fit on the card: "
              f"{why}", flush=True)
        return out
    e = res["ccsd e"]
    for n, shape in TP_MESHES:
        label = tp_label(n, shape)
        check(abs(out[label][0] - e) <= 1e-10,
              f"tensor-parallel CCSD {label}: E={out[label][0]:.13f}, "
              f"unsharded {e:.13f}")
    out["unsharded"] = (e, ms, peak - base)
    print(f"unsharded dense CCSD nP={p['nP']} non-canonical: E={e:.13f} in "
          f"{len(res['e history'])} iterations, {ms:.3f} ms/iter, peak "
          f"device memory {peak / 1e9:.3f} GB ({(peak - base) / 1e9:.3f} GB "
          "above the phase's start); the cut solves within 1e-10 of it",
          flush=True)
    return out


def tp_lih(mol, e_one, device, launches):
    """Phase 23(c): LiH/3-21G CCSD with its blocks cut over each mesh of
    ``LIH_TP_MESHES``: within 1e-8 of the oracle and 1e-10 of phase 6's
    unsharded solve ``e_one``, one K2′, K3′ and K5 launch an
    iteration."""
    from pymes_tpu_torch.integral.partition import part_2_body_int
    from pymes_tpu_torch.parallel import mesh as pmesh
    from pymes_tpu_torch.solver import ccsd

    no = mol["no"]
    oracle = MOLECULES["LiH"][2]
    d = part_2_body_int(no, mol["V"])
    for n, shape in LIH_TP_MESHES:
        label = tp_label(n, shape)
        cut = pmesh.shard_blocks(tp_mesh(n, shape, device), d)
        out = {}

        def run():
            out["res"], out["ms"], out["peak"] = timed_solve(
                ccsd.CCSD(no, device=device), mol["fock"], cut, **mol["kw"])
            k = len(out["res"]["e history"])
            return {"ccsd_jacobi_diis": k, "ccsd_mix_energy": k,
                    "pair_symmetrize": k}

        counted_exactly(f"tensor-parallel CCSD LiH, {label}", run, launches)
        e = out["res"]["ccsd e"]
        check(abs(e - oracle) <= 1e-8 and abs(e - e_one) <= 1e-10,
              f"tensor-parallel CCSD LiH {label}: E={e:.15f}, oracle "
              f"{oracle}, phase 6 {e_one:.15f}")
        print(f"tensor-parallel CCSD LiH ({label} of one card): E={e:.15f} "
              f"in {len(out['res']['e history'])} iterations, |E - oracle|="
              f"{abs(e - oracle):.2e}, |E - phase 6|={abs(e - e_one):.2e}, "
              f"{out['ms']:.3f} ms/iter, peak device memory "
              f"{out['peak'] / 1e9:.3f} GB", flush=True)


def tp_phase(p, q, n_ref, mols, mol_e, device, card, launches):
    """Phase 23: the tensor-parallel dense CCD and CCSD at nP=219 and LiH
    CCSD, each on a 1-D and a 2-D mesh of one card."""
    import torch

    t0 = time.time()
    abcd, base, ccd_out = tp_ccd(p, n_ref, device, launches)
    ccsd_out = tp_ccsd(p, q, abcd, base, device, launches)
    del abcd
    torch.cuda.empty_cache()
    tp_lih(mols["LiH"], mol_e["LiH"], device, launches)
    for what, res in (("CCD", ccd_out), ("CCSD", ccsd_out)):
        print(f"[{card}] nP={p['nP']} tensor-parallel dense {what}: "
              + "; ".join(f"{label} {ms:.3f} ms/iter, peak {peak / 1e9:.3f} "
                          "GB above the phase's start"
                          for label, (_, ms, peak) in res.items()),
              flush=True)
    print(f"phase 23 (tensor-parallel dense CCD/CCSD): "
          f"{time.time() - t0:.2f} s", flush=True)


def counted_exactly(label, run, launches):
    """A counted window (as :func:`path_launches`) whose launches must
    equal, kernel by kernel, the counts that ``run`` returns (0 for every
    kernel it does not name); added to ``launches``."""
    from pymes_tpu_torch import kernels

    kernels.reset_launches()
    want = run()
    got = dict(kernels.LAUNCHES)
    print(f"launches on the {label} path: {got}", flush=True)
    want = {k: want.get(k, 0) for k in got}
    check(got == want, f"{label}: launches {got}, expected {want}")
    launches[label] = got


def configs_mf_ccd(device, launches, records):
    """19a: the nP=219 model and solver built through ``configs`` (the
    solver with no device argument: the card by default), the mf-CCD in
    a counted window, one K1, K2, K3 and K5 launch an iteration."""
    import torch

    from pymes_tpu_torch import configs

    u = configs.UEGConfig(n_ele=14, rs=0.5, cutoff=14).make()
    p = setup(14, device, u=u)
    solver = configs.GroundStateConfig(no=NO, max_iter=60).make_ccd()
    check(solver.device == torch.device("cuda"),
          f"configs built the solver on {solver.device}, not the card")
    out = {}

    def run():
        t0 = time.perf_counter()
        res = out["res"] = solver.solve(p["fock"], p["blocks"],
                                        level_shift=-1.0)
        wall = time.perf_counter() - t0
        e, n = res["ccd e"], len(res["e history"])
        check(abs(e - E_JAX[14]) <= 1e-9 and n == 6,
              f"configs mf-CCD nP={p['nP']}: E={e!r} in {n} iterations vs "
              f"JAX {E_JAX[14]} in 6")
        records.append(("ccd", f"configs mf-CCD nP={p['nP']}", res, wall))
        print(f"configs mf-CCD nP={p['nP']} (solver on {solver.device}): "
              f"E={e:.13f} in {n} iterations, |E - E_jax|="
              f"{abs(e - E_JAX[14]):.2e}, {wall:.3f} s", flush=True)
        return {k: n for k in CCD_KERNELS}

    counted_exactly("configs mf-CCD", run, launches)
    return p, out["res"]


def resume_mf_ccsd(q, device, tmp, launches, records):
    """19b: the seeded non-canonical mf-CCSD at nP=219 stopped after 3
    iterations, checkpointed and loaded (T1, T2 bit-equal), then resumed
    through ``amps=`` to |dE| < 1e-10 in a counted window: 4 K4 gathers,
    2 traces and one each of K1, K2', K3' and K5 an iteration."""
    import dataclasses
    import os

    from pymes_tpu_torch.solver import ccsd
    from pymes_tpu_torch.util import checkpoint

    fock = q["focks"]["non-canonical"]
    kw = dict(level_shift=-1.0, ladder=q["plan_all"], delta_e=1e-10)
    part = ccsd.CCSD(NO, device=device).solve(fock, q["mf_dict"], max_iter=2,
                                              **kw)
    n0 = len(part["e history"])
    check(n0 == 3, f"the stopped mf-CCSD ran {n0} iterations, not 3")
    ck = dataclasses.replace(checkpoint.from_result(
        part, meta={"system": f"UEG 14e rs 0.5 nP={q['nP']}"}),
        iteration=n0)
    base = os.path.join(tmp, "mf_ccsd")
    t0 = time.perf_counter()
    checkpoint.save(base, ck)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    ck = checkpoint.load(base)
    t_load = time.perf_counter() - t0
    size = os.path.getsize(base + ".npz") + os.path.getsize(base + ".json")
    check(np.array_equal(ck.t1, part["t1"].cpu().numpy())
          and np.array_equal(ck.t2, part["t2"].cpu().numpy())
          and ck.iteration == n0,
          "the loaded checkpoint differs from the saved amplitudes")

    def run():
        t0 = time.perf_counter()
        res = ccsd.CCSD(NO, device=device).solve(fock, q["mf_dict"],
                                                 max_iter=100,
                                                 amps=ck.amps, **kw)
        wall = time.perf_counter() - t0
        e, n = res["ccsd e"], len(res["e history"])
        err = abs(e - E_JAX_CCSD_NONCANONICAL)
        check(err <= 1e-9, f"resumed mf-CCSD: E={e!r} vs JAX "
              f"{E_JAX_CCSD_NONCANONICAL}")
        records.append(("ccsd", f"resumed mf-CCSD nP={q['nP']}", res, wall))
        print(f"mf-CCSD nP={q['nP']} (non-canonical) checkpoint: {n0} "
              f"iterations before, {n} after the resume, E={e:.13f}, "
              f"|E - E_jax|={err:.2e}; save {t_save:.4f} s, load "
              f"{t_load:.4f} s, {size} bytes (npz + json)", flush=True)
        return {"ovvv_gather": 4 * n, "ovvv_gather_diag": 2 * n,
                **{k: n for k in ("block_ladder", "ccsd_jacobi_diis",
                                  "ccsd_mix_energy", "pair_symmetrize")}}

    counted_exactly("resumed mf-CCSD", run, launches)


def twist_average(device, launches, records):
    """19c: the mf-CCD at each irreducible twist of the 3³ mesh through
    ``configs`` (the host set-up of all four before the counted window),
    each against its JAX pin, and the weighted mean."""
    import torch

    from pymes_tpu_torch import configs
    from pymes_tpu_torch.util import kpoints

    ks, weights = kpoints.gen_ir_ks(3)
    check(len(ks) == len(TWIST_JAX) and all(
        np.array_equal(k, pin[0]) for k, pin in zip(ks, TWIST_JAX)),
        f"irreducible twists {ks.tolist()}")
    ps = []
    for k in ks:
        t0 = time.time()
        u = configs.UEGConfig(n_ele=14, rs=0.5, cutoff=14,
                              k_shift=tuple(k)).make()
        ps.append(setup(14, device, u=u))
        gap = float(ps[-1]["eps_a"].min() - ps[-1]["eps_i"].max())
        print(f"twist {np.round(k, 4).tolist()}: nP={ps[-1]['nP']}, HF gap "
              f"{gap:.4f} Ha, host set-up {time.time() - t0:.2f} s",
              flush=True)
    solver = configs.GroundStateConfig(no=NO, max_iter=60).make_ccd()
    energies = []

    def run():
        n_all = 0
        for p, (k, n_p, e_pin, n_pin) in zip(ps, TWIST_JAX):
            t0 = time.perf_counter()
            res = solver.solve(p["fock"], p["blocks"], level_shift=-1.0)
            wall = time.perf_counter() - t0
            e, n = res["ccd e"], len(res["e history"])
            check(p["nP"] == n_p and n == n_pin and abs(e - e_pin) <= 1e-9,
                  f"twist {k}: nP={p['nP']} E={e!r} in {n} iterations vs "
                  f"JAX nP={n_p} {e_pin} in {n_pin}")
            check(bool(torch.isfinite(res["t2 amp"]).all()),
                  f"twist {k}: amplitudes not finite")
            energies.append(e)
            n_all += n
            records.append(("ccd", f"twist {k} mf-CCD nP={n_p}", res, wall))
            print(f"twist {np.round(k, 4).tolist()} mf-CCD nP={n_p}: "
                  f"E={e:.13f} in {n} iterations, |E - E_jax|="
                  f"{abs(e - e_pin):.2e}, {wall:.3f} s", flush=True)
        return {k: n_all for k in CCD_KERNELS}

    counted_exactly("twist-averaged mf-CCD", run, launches)
    mean = float(np.dot(weights, energies))
    check(abs(mean - TWIST_MEAN_JAX) <= 1e-9,
          f"twist mean {mean!r} vs JAX {TWIST_MEAN_JAX}")
    print(f"twist-averaged mf-CCD (3³ mesh, weights "
          f"{[round(float(w), 4) for w in weights]}): E={mean:.13f}, "
          f"|E - E_jax|={abs(mean - TWIST_MEAN_JAX):.2e}", flush=True)


def structure_factor_check(p, T2):
    """19d: S(q) and g(r) of the converged Γ T2 on the card and from
    ``T2.cpu()``, within 1e-12 relative."""
    from pymes_tpu_torch.util import structure_factor as sf

    u = p["ueg"]
    q, S = sf.calcReciprocalSpaceStructureFactor(u, T2)
    q_h, S_h = sf.calcReciprocalSpaceStructureFactor(u, T2.cpu())
    r = np.linspace(0.1, 5.0, 50)
    g = sf.calcRealSpaceStructureFactor(r, u, T2)
    g_h = sf.calcRealSpaceStructureFactor(r, u, T2.cpu())
    e_s = float(np.abs(S - S_h).max() / np.abs(S_h).max())
    e_g = float(np.abs(g - g_h).max() / np.abs(g_h).max())
    check(np.array_equal(q, q_h) and e_s <= 1e-12 and e_g <= 1e-12
          and np.isfinite(S).all() and np.isfinite(g).all(),
          f"structure factor card vs CPU: S {e_s:.2e}, g {e_g:.2e}")
    print(f"structure factor of the Γ mf-CCD T2 (nP={p['nP']}): {len(q)} "
          f"transfer vectors, card vs CPU S(q) {e_s:.2e}, g(r) {e_g:.2e} "
          "relative", flush=True)


def roofline_line(p, wall, card):
    """19e: achieved f64 TFLOP/s of the fixed-61-iteration mf-CCD at
    nP=219, from ``util/flops.ccd_ij_iteration_flops`` on its plan and
    ``wall``, phase 5's (ms per iteration, iterations), the min of 5 taken
    before any profiler session."""
    from pymes_tpu_torch.util import flops

    f = flops.ccd_ij_iteration_flops(NO, p["nv"], p["blocks"].ladder)
    ms, n_fixed = wall
    print(f"[{card}] " + roofline.report(
        f"nP={p['nP']} fixed-{n_fixed}-iteration mf-CCD (phase 5, min of "
        f"5), "
        f"{f / 1e9:.3f} GFLOP an iteration", ms / 1e3, f), flush=True)


def examples_run(device, tmp, launches):
    """19f: each example's ``main`` once on the card at its own size,
    against the JAX package's examples (``EX_JAX``)."""
    import os

    from pymes_tpu_torch.examples import (molecular_ccsd_eom,
                                          rt_autocorrelation,
                                          ueg_tc_twist_average)
    from pymes_tpu_torch.util import checkpoint

    def run():
        t0 = time.time()
        base = os.path.join(tmp, "lih_ccsd")
        mol = molecular_ccsd_eom.main(device=device, checkpoint_path=base)
        e, roots = mol["ccsd e"], np.array(mol["roots"])
        d_root = float(np.abs(roots - np.array(EX_JAX["roots"])).max())
        check(abs(e - EX_JAX["ccsd e"]) <= 1e-10
              and abs(e - MOLECULES["LiH"][2]) <= 1e-8 and d_root <= 1e-8
              and checkpoint.load(base).energy == e,
              f"molecular example: E={e!r}, roots {roots.tolist()}")
        print(f"example molecular_ccsd_eom (LiH/3-21G): CCSD E={e:.13f} in "
              f"{mol['iterations']} iterations, |E - E_jax|="
              f"{abs(e - EX_JAX['ccsd e']):.2e}; EOM roots "
              f"{roots.tolist()}, |roots - JAX| {d_root:.2e} "
              f"({time.time() - t0:.2f} s)", flush=True)
        t0 = time.time()
        _, c_t = rt_autocorrelation.main(3, 0.1, os.path.join(tmp, "ct.npy"),
                                         device=device)
        want = np.array([complex(*c) for c in EX_JAX["c(t)"]])
        d_c = float(np.abs(c_t - want).max())
        check(d_c <= 1e-7, f"RT example: c(t) {c_t.tolist()}")
        print(f"example rt_autocorrelation (H2/STO-6G, 3 steps): |c(t) - "
              f"JAX| {d_c:.2e} ({time.time() - t0:.2f} s)", flush=True)
        t0 = time.time()
        rows, total = ueg_tc_twist_average.main(3, device=device)
        d_tc = max(float(np.abs(np.array(row[2:]) - np.array(ref)).max()
                         / np.abs(ref).max())
                   for row, ref in zip(rows, EX_JAX["tc"]))
        check(len(rows) == len(EX_JAX["tc"]) and d_tc <= 1e-12,
              f"TC twist example: {[row[2:] for row in rows]}")
        print(f"example ueg_tc_twist_average (mesh 3): total "
              f"{float(total.sum()):.10f}, |rows - JAX| {d_tc:.2e} relative "
              f"({time.time() - t0:.2f} s)", flush=True)

    launches["examples"] = path_launches(
        "examples", run, ("ccsd_jacobi_diis", "ccsd_mix_energy",
                          "pair_symmetrize", "davidson_residual",
                          "arnoldi_cgs2", "shifted_precond"))


def observability(p, records, device, tmp):
    """19g, after every timed wall: one ``RunRecord`` line per solve of
    the phase, read back with equal energies; then ``profile`` around
    three fixed CCD iterations must write a trace holding card kernels."""
    import json
    import os

    from pymes_tpu_torch.solver import ccd
    from pymes_tpu_torch.util.observability import RunRecord, profile

    rec = RunRecord(os.path.join(tmp, "runs.jsonl"))
    for solver, system, res, wall in records:
        rec.log(solver, system=system, result=res, wall_s=wall)
    rows = rec.read()
    check(len(rows) == len(records) and all(
        row[f"{solver} e"] == res[f"{solver} e"]
        and row["iterations"] == len(res["e history"])
        for row, (solver, _, res, _) in zip(rows, records)),
        "the run records do not read back the solves' energies")
    log_dir = os.path.join(tmp, "trace")
    with profile(log_dir, device=device):
        ccd.ccd_solve(p["fock"], p["blocks"], NO, p["T0"], level_shift=-1.0,
                      delta_e=-1.0, max_iter=2)
    path = os.path.join(log_dir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    n_kernel = sum(e.get("cat") == "kernel" for e in events)
    check(n_kernel > 0, f"the trace holds no card kernel ({len(events)} "
          "events)")
    print(f"observability: {len(rows)} run records read back; profile of 3 "
          f"fixed CCD iterations: {os.path.getsize(path)} bytes, "
          f"{len(events)} events, {n_kernel} card kernels", flush=True)


def utilities_phase(p14, q, ccd_wall, device, card, launches):
    """Phase 19, the utilities slice: 19a-f, then 19g last.  ``ccd_wall``
    is phase 5's wall of the fixed-iteration mf-CCD on ``p14``."""
    import tempfile

    import torch

    t19 = time.time()
    records = []
    with tempfile.TemporaryDirectory() as tmp:
        p, res = configs_mf_ccd(device, launches, records)
        resume_mf_ccsd(q, device, tmp, launches, records)
        twist_average(device, launches, records)
        torch.cuda.empty_cache()
        structure_factor_check(p, res["t2 amp"])
        roofline_line(p14, ccd_wall, card)
        examples_run(device, tmp, launches)
        observability(p, records, device, tmp)
    print(f"phase 19 (configs, checkpoint, twists, structure factor, "
          f"roofline, examples, observability): {time.time() - t19:.2f} s",
          flush=True)


# phase 26: the JAX package's own drivers, examples/*.py, read as text
# with their import lines pointed at pymes_tpu_torch and run with no
# device argument (the card): (file, main's arguments)
REFERENCE_EXAMPLES = (
    ("molecular_ccsd_eom", (str(DATA / "FCIDUMP.LiH.321g"),)),
    ("rt_autocorrelation", (3, 0.1)),
    ("ueg_tc_twist_average", (3,)))


def reference_example(name):
    """The module of the JAX package's ``examples/<name>.py`` with
    ``pymes_tpu`` replaced by ``pymes_tpu_torch`` in its import lines and
    nothing else of its text changed; ``__file__`` stays the example's, so
    its paths (``tests/data``) resolve as in the repository."""
    import re
    import types

    path = DATA.parent.parent / "examples" / f"{name}.py"
    lines = path.read_text(encoding="utf-8").splitlines(keepends=True)
    pat = re.compile(r"^(\s*(?:from|import)\s+)pymes_tpu\b")
    text = "".join(pat.sub(r"\1pymes_tpu_torch", line) for line in lines)
    changed = sum(a != b for a, b in zip(lines, text.splitlines(True)))
    check(changed > 0 and not re.search(r"^\s*(from|import)\s+pymes_tpu\b"
                                        r"(?!_torch)", text, re.M),
          f"examples/{name}.py: import lines not repointed")
    mod = types.ModuleType(f"reference_example_{name}")
    mod.__file__ = str(path)
    exec(compile(text, str(path), "exec"), mod.__dict__)
    return mod


@contextlib.contextmanager
def recording(targets, tmp):
    """Wrap each ``(owner, attribute)`` of ``targets`` so that every call's
    result is appended to ``out["<owner>.<attribute>"]`` (the owner's last
    dotted name), restored on exit; the
    checkpoint writer is pointed into ``tmp`` (the molecular example's
    ``/tmp/ccsd_ckpt`` becomes ``<tmp>/ccsd_ckpt``), and ``out["saved"]``
    lists the paths it wrote."""
    import os

    from pymes_tpu_torch.util import checkpoint

    out = {"saved": []}
    saved = [(o, a, getattr(o, a)) for o, a in targets]
    saved.append((checkpoint, "save", checkpoint.save))

    def wrap(fn, key):
        def rec(*args, **kw):
            res = fn(*args, **kw)
            out.setdefault(key, []).append(res)
            return res
        return rec

    def save(path, ck):
        path = os.path.join(tmp, os.path.basename(str(path)))
        out["saved"].append(path)
        return saved[-1][2](path, ck)

    try:
        for o, a, fn in saved[:-1]:
            setattr(o, a, wrap(fn, f"{o.__name__.rsplit('.', 1)[-1]}.{a}"))
        checkpoint.save = save
        yield out
    finally:
        for o, a, fn in saved:
            setattr(o, a, fn)


def tensors_in(x):
    """Every torch tensor in a (nested) result."""
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in tensors_in(y)]
    return []


def reference_examples_phase(p5, card, launches):
    """Phase 26: each of ``REFERENCE_EXAMPLES`` run through the port (its
    ``main`` with no device argument, in a temporary working directory),
    held to the pins of phase 19 (``EX_JAX``), every tensor the port's
    calls return to it on the card; its launches in one counted window.
    Then the reference's ``ladder_apply(plan, T, 1)`` (``chunk`` spelled
    out) on the nP=57 plan: one K1 launch, equal to the default call bit
    for bit."""
    import os
    import tempfile

    import torch

    from pymes_tpu_torch import kernels
    from pymes_tpu_torch.mean_field import hf
    from pymes_tpu_torch.ops import ueg_ladder
    from pymes_tpu_torch.solver import ccsd, eom_ccsd, mp2, rt_eom_ccsd
    from pymes_tpu_torch.util import checkpoint
    from pymes_tpu_torch.util.kpoints import gen_ir_ks

    t26 = time.time()
    targets = ((hf, "calc_hf_e"), (hf, "construct_hf_matrix"),
               (mp2, "solve"), (ccsd.CCSD, "solve"),
               (ccsd.CCSD, "get_T1_dressed_fock"),
               (ccsd.CCSD, "get_T1_dressed_V"),
               (eom_ccsd.EOM_CCSD, "solve"), (rt_eom_ccsd.RT_EOM_CCSD,
                                               "solve"))
    results, walls = {}, {}
    cwd = os.getcwd()

    def run():
        for name, args in REFERENCE_EXAMPLES:
            with tempfile.TemporaryDirectory() as tmp:
                os.chdir(tmp)
                try:
                    mod = reference_example(name)
                    with recording(targets, tmp) as out:
                        t0 = time.time()
                        mod.main(*args)
                        torch.cuda.synchronize()
                        walls[name] = time.time() - t0
                    if name == "molecular_ccsd_eom":
                        out["checkpoint"] = checkpoint.load(out["saved"][0])
                    if name == "rt_autocorrelation":
                        out["ct"] = np.load(os.path.join(tmp, "ct.npy"))
                finally:
                    os.chdir(cwd)
            results[name] = out

    launches["reference examples"] = path_launches(
        "reference examples", run, ("ccsd_jacobi_diis", "ccsd_mix_energy",
                                    "pair_symmetrize", "davidson_residual",
                                    "arnoldi_cgs2", "shifted_precond"))
    for name, out in results.items():
        ts = [t for key, res in out.items() if key not in ("saved", "ct")
              for t in tensors_in(res)]
        check(ts and all(t.is_cuda for t in ts),
              f"{name}: {sum(not t.is_cuda for t in ts)} of {len(ts)} "
              "returned tensors off the card")
        print(f"reference example {name}: {len(ts)} returned tensors, all "
              f"on {ts[0].device}; wall {walls[name]:.2f} s", flush=True)

    mol = results["molecular_ccsd_eom"]
    e = mol["CCSD.solve"][0]["ccsd e"]
    roots = np.asarray(mol["EOM_CCSD.solve"][0])
    e_hf = float(mol["hf.calc_hf_e"][0])
    d_root = float(np.abs(roots - np.array(EX_JAX["roots"])).max())
    check(abs(e - EX_JAX["ccsd e"]) <= 1e-10
          and abs(e - MOLECULES["LiH"][2]) <= 1e-8
          and abs(e_hf - MOLECULES["LiH"][3]) <= 1e-8 and d_root <= 1e-8
          and mol["checkpoint"].energy == e,
          f"reference molecular example: E={e!r}, roots {roots.tolist()}")
    print(f"reference examples/molecular_ccsd_eom.py through the port "
          f"(LiH/3-21G): HF {e_hf:.12f}, CCSD E={e:.13f}, |E - E_jax|="
          f"{abs(e - EX_JAX['ccsd e']):.2e}; EOM roots {roots.tolist()}, "
          f"|roots - JAX| {d_root:.2e}; checkpoint {mol['saved'][0]!r} "
          "read back", flush=True)

    ct = results["rt_autocorrelation"]["ct"]
    c_t = ct[:, 1] + 1j * ct[:, 2]
    want = np.array([complex(*c) for c in EX_JAX["c(t)"]])
    d_c = float(np.abs(c_t - want).max())
    check(len(results["rt_autocorrelation"]["RT_EOM_CCSD.solve"]) == len(want)
          and d_c <= 1e-7, f"reference RT example: c(t) {c_t.tolist()}")
    print(f"reference examples/rt_autocorrelation.py through the port "
          f"(H2/STO-6G, 3 steps): |c(t) - JAX| {d_c:.2e}", flush=True)

    tc = results["ueg_tc_twist_average"]
    e_mp2 = np.array([float(r[0]) for r in tc["mp2.solve"]])
    e_hf = np.array([float(e) for e in tc["hf.calc_hf_e"]])
    ref = np.array(EX_JAX["tc"])
    _, weights = gen_ir_ks(3)
    mean, mean_ref = float(weights @ e_mp2), float(weights @ ref[:, 2])
    d_tc = max(float(np.abs(e_mp2 - ref[:, 2]).max() / np.abs(ref[:, 2])
                     .max()),
               float(np.abs(e_hf - ref[:, 0]).max() / np.abs(ref[:, 0])
                     .max()))
    check(len(e_mp2) == len(ref) and d_tc <= 1e-12
          and abs(mean - mean_ref) <= 1e-12 * abs(mean_ref),
          f"reference TC twist example: MP2 {e_mp2.tolist()}")
    print(f"reference examples/ueg_tc_twist_average.py through the port "
          f"(mesh 3): twist-averaged TC-MP2 {mean:.12f}, JAX "
          f"{mean_ref:.12f}, |rows - JAX| {d_tc:.2e} relative", flush=True)

    # the reference's chunk of ladder_apply: K1, not the twin
    plan = p5["blocks"].ladder
    T = torch.as_tensor(np.random.default_rng(26).standard_normal(
        (plan.nv, plan.nv, NO, NO)), device=plan.inv_bra.device)
    kernels.reset_launches()
    W1 = ueg_ladder.ladder_apply(plan, T, 1)
    torch.cuda.synchronize()
    got = {k: v for k, v in kernels.LAUNCHES.items() if v}
    W0 = ueg_ladder.ladder_apply(plan, T)
    check(got == {"block_ladder": 1} and torch.equal(W1, W0),
          f"ladder_apply(plan, T, 1): launches {got}, bit-equal "
          f"{torch.equal(W1, W0)}")
    print(f"ladder_apply(plan, T, 1) at nP={p5['nP']}: launches {got}, "
          "equal to ladder_apply(plan, T) bit for bit", flush=True)
    print(f"[{card}] phase 26 (the JAX package's examples through the "
          f"port): {time.time() - t26:.2f} s; walls " + ", ".join(
              f"{k} {v:.2f} s" for k, v in walls.items()), flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    # phase 0: card and versions
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    card = smi.strip()
    print(f"card: {card}", flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    device = "cuda"

    from pymes_tpu_torch.kernels import _build
    from pymes_tpu_torch.solver import ccd

    # phase 1: builds (nvcc for K1-K5, K7 and K9; Triton JIT for K6 and K8
    # at their first launch)
    t0 = time.time()
    _build.library()
    print(f"K1 + K2/K3 + K4 + K5 + K7 + K9 nvcc build + load: "
          f"{time.time() - t0:.2f} s", flush=True)
    # the set-up path: the integral lists of nP=57 and nP=219 scattered
    # into the named blocks on the card (K10), counted as a path
    problems = {}
    launches = {"set-up": path_launches(
        "set-up", lambda: problems.update({c: setup(c, device)
                                           for c in (5, 14)}),
        ("block_scatter",))}
    q = setup_ccsd(problems[14], device)
    t0 = time.time()
    compare = [compare_kernels(problems[5], 1)]
    print(f"first CCD kernel launches: {time.time() - t0:.2f} s",
          flush=True)
    t0 = time.time()
    compare.append(compare_ccsd_kernels(q, 4))
    print(f"first CCSD kernel launches at nP={q['nP']}: "
          f"{time.time() - t0:.2f} s", flush=True)
    # phase 2: kernel vs twin at the nP=219 CCD plan and at the dense
    # CCSD path's molecular shapes too
    compare.append(compare_kernels(problems[14], 2))
    t0 = time.time()
    mols = {name: load_molecule(name, device) for name in MOLECULES}
    print(f"molecular integrals read: {time.time() - t0:.2f} s", flush=True)
    compare.append(compare_molecular_kernels(mols, 6))
    t0 = time.time()
    eom_ops = {5: eom_operator(problems[5], device),
               14: eom_operator(problems[14], device, q["plan_all"],
                                q["mf_dict"]["_ovvv_plans"])}
    compare.append(compare_eom_kernels(q, eom_ops[14], 7))
    print("EOM operators + first K5/K6 launches (Triton JIT of K6 "
          f"included): {time.time() - t0:.2f} s", flush=True)
    # phases 3-4: the CCD path, converged
    results = {}

    def run_ccd():
        for c, p in problems.items():
            t0 = time.time()
            res = ccd.CCD(NO, device=device).solve(
                p["fock"], p["blocks"], level_shift=-1.0, max_iter=60)
            n_it = len(res["e history"])
            e = res["ccd e"]
            T = res["t2 amp"]
            check(T.shape == (p["nv"], p["nv"], NO, NO)
                  and bool(torch.isfinite(T).all()),
                  f"nP={p['nP']}: amplitudes not finite or of the wrong "
                  "shape")
            check(abs(e - E_JAX[c]) <= 1e-9,
                  f"nP={p['nP']}: E={e:.13f} vs JAX {E_JAX[c]}")
            wall = time.time() - t0
            print(f"CCD nP={p['nP']}: E={e:.13f} in {n_it} iterations, "
                  f"|E - E_jax|={abs(e - E_JAX[c]):.2e}, {wall:.2f} s",
                  flush=True)
            results[c] = (e, n_it, T, wall)

    launches["CCD"] = path_launches("CCD", run_ccd, CCD_KERNELS)
    e57, it57 = results[5][:2]
    check(it57 == 6, f"nP=57 took {it57} iterations, expected 6")
    check(abs(e57 - ORACLE_NP57) <= 1e-8,
          f"nP=57 E={e57} vs oracle {ORACLE_NP57}")
    print(f"nP=57 |E - oracle| = {abs(e57 - ORACLE_NP57):.2e}", flush=True)

    # phase 6: dense molecular CCSD (molecular and transcorrelated)
    mol_e = {}
    launches["dense CCSD"] = path_launches(
        "dense CCSD", lambda: mol_e.update(molecular_ccsd(mols, device)),
        DENSE_CCSD_KERNELS)
    # phase 7: matrix-free CCSD at nP=219
    ccsd_res = {}
    launches["matrix-free CCSD"] = path_launches(
        "matrix-free CCSD", lambda: ccsd_res.update(mf_ccsd(q, device)),
        MF_CCSD_KERNELS)
    # phase 9: EOM-CCSD, the no-ovvv operator at nP=57 and nP=219, and LiH
    T2_ccsd = ccsd_res["canonical"]["t2"]
    cases = [(f"nP={problems[c]['nP']} CCD amplitudes", problems[c]["fock"],
              eom_ops[c], results[c][2], *EOM_JAX[c]) for c in (5, 14)]
    cases.append((f"nP={q['nP']} CCSD amplitudes", q["fock"], eom_ops[14],
                  T2_ccsd, *EOM_JAX_CCSD_AMPS_NP219))
    # the LiH ground state and its dressing run before the EOM path's
    # counted window, so that the window holds EOM solves alone
    t0 = time.time()
    lih = lih_dressed(mols["LiH"], device)
    print(f"LiH CCSD + T1 dressing for EOM: {time.time() - t0:.2f} s",
          flush=True)
    eom_roots, eom_walls = {}, {}
    launches["EOM"] = path_launches(
        "EOM", lambda: eom_roots.update(eom_runs(cases, lih, device,
                                                 eom_walls)),
        EOM_KERNELS)
    r_ccd, r_ccsd = (eom_roots[c[0]] for c in cases[1:])
    for label, r in (("CCD", r_ccd), ("CCSD", r_ccsd)):
        dev = float(np.abs(r - np.asarray(EOM_RECORDED_NP219)).max())
        check(dev <= 1e-6, f"EOM nP={q['nP']} {label} amplitudes: roots {r} "
              f"vs recorded {EOM_RECORDED_NP219}")
    gap = float(np.abs(r_ccd - r_ccsd).max())
    check(gap <= 1e-7, f"EOM nP={q['nP']}: CCD- vs CCSD-amplitude roots "
          f"differ by {gap:.3e}")
    print(f"EOM nP={q['nP']}: |roots - recorded| <= 1e-6, |roots(CCD amps)"
          f" - roots(CCSD amps)| = {gap:.2e}", flush=True)

    # phase 5: CCD timing
    kernel_ms, ccd_wall = {}, {}
    for c, p in problems.items():
        kernel_ms[c] = time_kernels(p, 3)
        for name, (ms, plain) in kernel_ms[c].items():
            print(f"[{card}] nP={p['nP']} {name}: kernel {ms:.4f} ms, "
                  f"twin {plain:.4f} ms per call", flush=True)
        walls = {False: [], True: []}
        n_fixed = 0
        for _ in range(5):
            for twin in (False, True):
                ms, n_fixed, _ = solve_fixed(p, twin)
                walls[twin].append(ms)
        ccd_wall[c] = (min(walls[False]), n_fixed)
        print(f"[{card}] nP={p['nP']} fixed-{n_fixed}-iteration CCD, min of "
              f"5: kernels {min(walls[False]):.3f} ms/iter, twins "
              f"{min(walls[True]):.3f} ms/iter", flush=True)
    # phase 8: CCSD timing at nP=219
    kernel_ms[14].update(time_ccsd_kernels(q, 5))
    k4_7 = kernel_ms[14].pop("ovvv_gather")
    kernel_ms[14]["ovvv_gather"] = k4_7[:2]
    for name in ("ovvv_gather_diag", "ccsd_jacobi_diis", "ccsd_mix_energy"):
        ms, plain = kernel_ms[14][name]
        print(f"[{card}] nP={q['nP']} {name}: kernel {ms:.4f} ms, twin "
              f"{plain:.4f} ms per call", flush=True)
    walls = {False: [], True: []}
    n_fixed = 0
    for _ in range(5):
        for twin in (False, True):
            ms, n_fixed = solve_ccsd_fixed(q, twin)
            walls[twin].append(ms)
    print(f"[{card}] nP={q['nP']} fixed-{n_fixed}-iteration matrix-free "
          f"CCSD (non-canonical), min of 5: kernels "
          f"{min(walls[False]):.3f} ms/iter, twins {min(walls[True]):.3f} "
          "ms/iter", flush=True)
    k4_dev, diag_dev = ccsd_k4_alone(q, 5)
    kernel_ms[14]["ovvv_gather_diag device"] = diag_dev
    tails_dev = tails_alone(problems[14], q, 5)
    print(f"[{card}] nP={q['nP']} tails on the card alone (profiler, every "
          "device op of a call): " + ", ".join(
              f"{k} {v:.4f} ms" for k, v in tails_dev.items()), flush=True)
    k4_t = {"CCSD dressing, 7 columns": (*k4_7[:2], k4_dev, *k4_7[3:])}
    print_k4(card, f"nP={q['nP']} CCSD dressing, 7 columns",
             k4_t["CCSD dressing, 7 columns"])
    b = np.mean([diag_bound(q["mf_dict"]["_ovvv_plans"][pat], q["nv"],
                            NO)[0]
                 for pat, _ in DIAG_PLANS])
    print(f"[{card}] nP={q['nP']} ovvv_gather_diag on the card alone "
          f"(profiler) {diag_dev:.4f} ms; bound {b:.4f} ms (bytes)",
          flush=True)

    # phase 10: EOM timing at nP=219
    kernel_ms[14].update(time_eom_kernels(q, eom_ops[14], 8))
    for name in ("pair_symmetrize", "pair_symmetrize ijab+Y",
                 "davidson_residual"):
        ms, plain = kernel_ms[14][name]
        print(f"[{card}] nP={q['nP']} {name}: kernel {ms:.4f} ms, twin "
              f"{plain:.4f} ms per call", flush=True)
    print(f"[{card}] nP={q['nP']} pair_symmetrize: torch.add(X, X "
          "transposed) (library) "
          f"{kernel_ms[14]['pair_symmetrize library']:.4f} ms per call",
          flush=True)
    print(f"[{card}] nP={q['nP']} pair_symmetrize on the card alone "
          "(profiler): kernel "
          f"{kernel_ms[14]['pair_symmetrize device']:.4f} ms, ijab+Y "
          f"{kernel_ms[14]['pair_symmetrize ijab+Y device']:.4f} ms, "
          "torch.add (library) "
          f"{kernel_ms[14]['pair_symmetrize library device']:.4f} ms",
          flush=True)
    k4_t["EOM batch of 2, 14 columns"] = kernel_ms[14].pop(
        "ovvv_gather EOM batch")
    print_k4(card, f"nP={q['nP']} EOM batch of 2, 14 columns",
             k4_t["EOM batch of 2, 14 columns"])
    ladder_t, errs = time_ladder(problems[14], q, eom_ops[5]["abcd_ladder"],
                                 9)
    compare.append(errs)
    k1_alone = ladder_t.pop("ijab entry, N = no^2 (the CCD path), K1 alone")
    print(f"[{card}] block_ladder ijab entry N = no^2: K1 on the card alone "
          f"(profiler) {k1_alone:.4f} ms", flush=True)
    for label, (ms, plain, b, dev) in ladder_t.items():
        print(f"[{card}] block_ladder {label}: kernel {ms:.4f} ms per call "
              f"({dev:.4f} ms on the card alone), twin {plain:.4f} ms; bound "
              f"{b[0]:.4f} ms ({b[1]}), the kernel alone at "
              f"{b[0] / dev:.3f} of it", flush=True)
    it_ms = {True: [], False: []}
    for twin in (True, False, False, True):
        it_ms[twin].append(eom_ms_per_iter(q["fock"], eom_ops[14],
                                           results[14][2], device, twin))
    print(f"[{card}] nP={q['nP']} EOM-CCSD Davidson (k=2, max_dim=16), mean "
          f"of 2: kernels {np.mean(it_ms[False]):.3f} ms/iter, twins "
          f"{np.mean(it_ms[True]):.3f} ms/iter", flush=True)
    b8 = time_scatter(problems[14])
    compare.append({"block_scatter": b8["err"]})
    share = b8["bound"][0] / b8["device"]
    print(f"[{card}] nP={problems[14]['nP']} set-up scatter (B8, "
          f"sparse_to_blocks of {len(NEED)} blocks, {b8['nnz']} entries): "
          f"K10 {b8['wall']:.3f} ms a call, twin {b8['twin_wall']:.3f} ms "
          f"(min of 3, twin-kernel-kernel-twin); upload alone (min of 5) "
          f"{b8['upload']:.3f} ms (int16-packed, pinned), the int64 list as "
          f"given {b8['upload_int64']:.3f} ms (pageable); on the card alone: "
          f"zero fills + K10 {b8['device']:.4f} ms, K10 {b8['kernel']:.4f} "
          f"ms; bound {b8['bound'][0]:.4f} ms ({b8['bound'][1]}; the packed "
          f"list, the kept values and the blocks written once), the card's "
          f"work at {share:.3f} of it", flush=True)
    b8_dense = dense_past_2_31(problems[14])
    print(f"[{card}] nP={problems[14]['nP']} sparse_to_dense through K10: "
          f"{b8_dense['elements']} elements "
          f"({b8_dense['elements'] * 8 / 1e9:.2f} GB), offsets up to "
          f"{b8_dense['max_offset']}, every entry "
          f"read back, {b8_dense['nonzero']} nonzero as in the list; "
          f"{b8_dense['wall']:.3f} ms a call (min of 3), K10 alone "
          f"{b8_dense['kernel']:.4f} ms, bound {b8_dense['bound'][0]:.4f} ms "
          f"({b8_dense['bound'][1]}), one index_put_ of the flat indices on "
          f"the card {b8_dense['library']:.4f} ms", flush=True)

    # phase 13 set-up (outside every counted window): nP=123 CCD, its
    # no-ovvv operator and the port's Davidson, the RT seed
    p123, V123, T123, root123, u123 = rt123_seed(device)
    # phase 11: K7/K8 vs their twins and per call, at the lane shapes of
    # the FEAST nP=57 (64 lanes of GMRES(120)) and RT nP=123 (32 lanes of
    # GMRES(20)) solves
    krylov_shapes = {
        f"FEAST nP={problems[5]['nP']}": (
            FEAST57["n_quad"] * FEAST57["n_trial"], FEAST57_GMRES[0] + 1,
            2 * (problems[5]["nv"] * NO + problems[5]["nv"] ** 2 * NO * NO),
            problems[5]["nv"] * NO, (1, 60, FEAST57_GMRES[0])),
        f"RT nP={p123['nP']}": (
            RT123["n_quad"], RT123["ls_restart"] + 1,
            2 * (p123["nv"] * NO + p123["nv"] ** 2 * NO * NO),
            p123["nv"] * NO, (1, 10, RT123["ls_restart"]))}
    krylov_ms, krylov_b = {}, {}
    for label, shape in krylov_shapes.items():
        errs, t = krylov_ms[label] = krylov_phase(label, shape, device)
        compare.append(errs)
        La_, _, n_, _, ms_ = shape
        b = krylov_b[label] = krylov_bounds(La_, ms_[len(ms_) // 2], n_)
        for name in ("arnoldi_cgs2", "krylov_combine", "shifted_precond"):
            print(f"[{card}] {label} {name}: kernel {t[name][0]:.4f} ms, "
                  f"twin {t[name][1]:.4f} ms per call", flush=True)
        proj = t["arnoldi_cgs2"][0]
        print(f"[{card}] {label} K7 projection at m={ms_[len(ms_) // 2]}: "
              f"{proj:.4f} ms, three-pass floor {b['floor_ms']:.4f} ms "
              f"({proj / b['floor_ms']:.3f}x), once-read bound "
              f"{b['bound'][0]:.4f} ms; fused "
              f"combine {t['krylov_combine'][0]:.4f} ms, torch.baddbmm "
              f"(La, 2, m) {t['krylov_combine library']:.4f} ms, bound "
              f"{b['combine'][0]:.4f} ms", flush=True)
    krylov_ms = {label: t for label, (_, t) in krylov_ms.items()}
    # K4 at the lane batches of the same solves: 2 trials a lane
    for label, V_, nv_, lanes_, seed in (
            (f"FEAST nP={problems[5]['nP']}", eom_ops[5], problems[5]["nv"],
             K4_LANES["FEAST"], 31),
            (f"RT nP={p123['nP']}", V123, p123["nv"], K4_LANES["RT"], 32)):
        t = k4_t[f"{label}, {2 * lanes_ * NO} columns"] = k4_lanes(
            V_, nv_, 2 * lanes_, seed, label)
        print_k4(card, f"{label}, {2 * lanes_} trials = {2 * lanes_ * NO} "
                 "columns", t)
        torch.cuda.empty_cache()
    compare.append({"ovvv_gather": max(t[4] for t in k4_t.values())})

    # phase 12: FEAST nP=57; phase 13: RT nP=123; phase 14: FEAST LiH
    runs = {"FEAST": {}, "RT": {}, "LiH": {}}
    launches["FEAST nP=57"] = path_launches(
        "FEAST nP=57", lambda: feast57(problems[5], eom_ops[5],
                                       results[5][2], device, runs["FEAST"]),
        KRYLOV_KERNELS)
    launches["RT nP=123"] = path_launches(
        "RT nP=123", lambda: rt123(p123, V123, T123, root123, u123, device,
                                   runs["RT"]), KRYLOV_KERNELS)
    launches["FEAST LiH"] = path_launches(
        "FEAST LiH", lambda: lih_feast(lih, device, runs["LiH"]),
        ("arnoldi_cgs2", "shifted_precond"))

    # timing: ms per Arnoldi step of one GMRES cycle over all lanes, wall
    # per FEAST iteration and per RT step
    fs, rs = runs["FEAST"]["solver"], runs["RT"]["solver"]
    step_ms = {}
    for label, s_, lanes_, restart, rt, dt in (
            ("FEAST nP=57 x 64 lanes", fs, feast57_lanes(fs, device),
             FEAST57_GMRES[0], False, 0.0),
            (f"RT nP={p123['nP']} x 32 lanes", rs,
             rt123_lanes(rs, u123, root123, device), RT123["ls_restart"],
             True, RT123["dt"])):
        k_ms, t_ms, parts = step_ms[label] = arnoldi_step_ms(
            s_, *lanes_, restart, rt, dt)
        print(f"[{card}] {label}: GMRES({restart}) cycle, kernels "
              f"{k_ms:.3f} ms per Arnoldi step, twins {t_ms:.3f}; sigma "
              f"{parts['sigma']:.3f} ms, K8 {parts['K8']:.4f} ms and K7 "
              f"(m = {restart // 2}) {parts['K7']:.4f} ms per call",
              flush=True)
    print(f"[{card}] FEAST nP=57: wall per iteration "
          f"{[round(w, 3) for w in fs.iter_walls]} s; RT nP={p123['nP']}: "
          f"wall per step {[round(w, 3) for w in runs['RT']['walls']]} s",
          flush=True)

    # phase 24: the FEAST/RT mixed-precision engine: the f32 kernels
    # against their f32 twins and timed at the FEAST nP=57 and RT nP=123
    # lane shapes, phase 12's window and phase 13's steps with
    # ls_precision="mixed" in one counted window, then ms per Arnoldi step
    # of the f32 solves beside phase 12/13's f64 ones
    feast_label, rt_label = (f"FEAST nP={problems[5]['nP']}",
                             f"RT nP={p123['nP']}")
    f32_t, f32_b = {}, {}
    for label, V_, seed in ((feast_label, eom_ops[5], 41),
                            (rt_label, V123, 42)):
        errs, t, b, kb = f32_phase(label, V_["abcd_ladder"],
                                   V_["_ovvv_plans"], krylov_shapes[label],
                                   seed, device, card)
        compare.append(errs)
        f32_t[label], f32_b[label] = (t, kb), b
    mixed = {}

    def run_mixed():
        s_f, want = feast57_mixed(problems[5], eom_ops[5], results[5][2],
                                  device, runs["FEAST"], card)
        s_r, want_rt = rt123_mixed(p123, V123, T123, root123, u123,
                                   runs["RT"], device, card)
        mixed.update(FEAST=s_f, RT=s_r)
        return {k: want.get(k, 0) + want_rt.get(k, 0)
                for k in set(want) | set(want_rt)}

    counted_exactly("mixed FEAST/RT", run_mixed, launches)
    for name in F32_KERNELS:
        check(launches["mixed FEAST/RT"][name] > 0,
              f"kernel {name} never launched on the mixed FEAST/RT path")
    for label, s_, lanes_, restart, rt, dt in (
            ("FEAST nP=57 x 64 lanes", mixed["FEAST"],
             feast57_lanes(mixed["FEAST"], device), FEAST57_GMRES[0],
             False, 0.0),
            (f"RT nP={p123['nP']} x 32 lanes", mixed["RT"],
             rt123_lanes(mixed["RT"], u123, root123, device),
             RT123["ls_restart"], True, RT123["dt"])):
        k_ms, t_ms, parts = arnoldi_step_ms(s_, *lanes_, restart, rt, dt,
                                            f32=True)
        k64, t64, p64 = step_ms[label]
        print(f"[{card}] {label}: GMRES({restart}) cycle per Arnoldi step, "
              f"f32 (mixed engine) kernels {k_ms:.3f} ms, twins {t_ms:.3f};"
              f" f64 kernels {k64:.3f}, twins {t64:.3f}; per call f32 / "
              f"f64: sigma {parts['sigma']:.3f} / {p64['sigma']:.3f} ms, K8 "
              f"{parts['K8']:.4f} / {p64['K8']:.4f} ms, K7 (m = "
              f"{restart // 2}) {parts['K7']:.4f} / {p64['K7']:.4f} ms",
              flush=True)
    del mixed
    torch.cuda.empty_cache()

    # phase 25: the ground-state and Davidson precision modes: their f32
    # kernels against their f32 twins and timed at nP=219, then the mixed
    # EOM (nP=57, nP=219, LiH), the mixed CCD (nP=57, nP=219) and the mixed
    # CCSD (LiH, the nP=219 mf-CCSD), each path in a counted window
    prec_t, prec_b, prec_sub = prec_phase(
        problems, q, results, ccsd_res, cases[:2], eom_walls, lih, mols,
        device, card, launches, compare)

    # phase 20: the generic FEAST kernel and one CIF step over the card's
    # sigma at nP=57, the adapters over the LiH sigma (the Davidson seeds
    # outside the counted window); phase 21: phase 12's FEAST with its
    # nodes over 2 and 4 shares of the card; phase 22: the native parser
    seeds = generic_seed(problems[5], eom_ops[5], results[5][2], lih, device)
    t0 = time.time()
    counted_exactly("generic FEAST", lambda: generic_phase(
        problems[5], eom_ops[5], results[5][2], lih, seeds,
        runs["FEAST"]["roots"], device, card), launches)
    print(f"phase 20 (generic FEAST, rt_step, adapters): "
          f"{time.time() - t0:.2f} s", flush=True)
    launches["FEAST node mesh"] = path_launches(
        "FEAST node mesh", lambda: mesh_phase(
            problems[5], eom_ops[5], results[5][2], runs["FEAST"], device),
        KRYLOV_KERNELS)
    native_phase(card)

    # phase 15: K9 against its twin at the ring shapes of nP=57 (5
    # shards) and nP=219 (4 shards, a 4.04 GB V block), every panel
    # offset and an odd one, both layouts, and at the edge shapes; then
    # per call at both ring shapes
    torch.cuda.empty_cache()
    meshes = {c: ring_mesh(problems[c]["nv"], device) for c in (5, 14)}
    e9, ring_t = 0.0, {}
    for c in (5, 14):
        x = ring_inputs(problems[c]["nv"], meshes[c].shape["a"], 15 + c,
                        device)
        e9 = max(e9, compare_ring_step(x, f"ring nP={problems[c]['nP']}"))
        ring_t[c] = time_ring_step(x)
        del x
    e9 = max(e9, compare_ring_edges(19, device))
    compare.append({"ring_step": e9})
    torch.cuda.empty_cache()
    k9_ms, k9_plain, k9_lib, ring_shape = ring_t[14]
    kernel_ms[14]["ring_step"] = (k9_ms, k9_plain)
    for c, (ms, plain, lib, shape) in ring_t.items():
        b = ring_bound(shape)
        print(f"[{card}] nP={problems[c]['nP']} ring_step {shape}: kernel "
              f"{ms:.4f} ms, twin {plain:.4f} ms, torch.addmm (library) "
              f"{lib:.4f} ms per call; bound {b[0]:.4f} ms ({b[1]}), the "
              f"kernel at {b[0] / ms:.3f} of it", flush=True)

    # phase 16: ring CCD on a one-card mesh (dense abcd cut on a), nP=57
    # (5 shards) and nP=219 (4 shards, 16.2 GB of abcd), converged
    rings = {c: ring_setup(problems[c], device) for c in (5, 14)}
    peaks = {}
    launches["ring CCD"] = path_launches(
        "ring CCD", lambda: peaks.update(
            {c: ring_ccd(problems[c], *rings[c], results[c][1], device)
             for c in rings}), RING_KERNELS)
    walls = {False: [], True: []}
    for _ in range(5):
        for twin in (False, True):
            ms, n_fixed, _ = solve_fixed(problems[14], twin,
                                         blocks=rings[14][1],
                                         ring_mesh=rings[14][0])
            walls[twin].append(ms)
    print(f"[{card}] nP={problems[14]['nP']} fixed-{n_fixed}-iteration ring "
          f"CCD ({rings[14][0].shape['a']} shards of one card), min of 5: "
          f"kernels {min(walls[False]):.3f} ms/iter, twins "
          f"{min(walls[True]):.3f} ms/iter; peak device memory of the "
          f"converged solve {peaks[14] / 1e9:.3f} GB", flush=True)
    del rings
    torch.cuda.empty_cache()

    # phase 17: the sector-sharded BlockLadder at nP=219, matrix-free CCD
    # and the seeded non-canonical CCSD
    plans = sharded_plans(q, device, 17)
    sharded_t = time_sharded(q, plans, 18)
    print(f"[{card}] nP={q['nP']} sector-sharded K1 apply ({SECTOR_SHARDS} "
          f"shards of one card, N = no^2): {sharded_t[0]:.4f} ms per call, "
          f"K1 on the whole plan {sharded_t[1]:.4f} ms, the sharded twin "
          f"{sharded_t[2]:.4f} ms", flush=True)
    sharded = {}
    launches["sector-sharded mf-CCD/CCSD"] = path_launches(
        "sector-sharded mf-CCD/CCSD",
        lambda: sharded_mf(q, plans, device, sharded), MF_CCSD_KERNELS)

    del plans
    torch.cuda.empty_cache()

    # phase 23: the tensor-parallel dense CCD and CCSD at nP=219 (abcd and
    # the ov³ blocks cut over 4 shards and 2 x 2 of the card) and LiH CCSD
    # (3 shards and 3 x 3)
    tp_phase(problems[14], q, results[14][1], mols, mol_e, device, card,
             launches)
    torch.cuda.empty_cache()

    # phase 18: the transcorrelated UEG at nP=219 and drCCD at nP=57
    tc_sub = tc_phase(problems, device, card, launches, compare)
    # phase 19: configs, checkpoint/resume, the twist average, the structure
    # factor, the roofline line, the examples, and observability last
    utilities_phase(problems[14], q, ccd_wall[14], device, card, launches)
    # phase 26: the JAX package's examples with the import root changed
    reference_examples_phase(problems[5], card, launches)

    total = {k: sum(run.get(k, 0) for run in launches.values())
             for k in KERNELS}
    max_err = {k: max(c[k] for c in compare if k in c) for k in KERNELS}
    kernel_ms = {name: kernel_ms[14][name] for name in kernel_ms[14]}
    for name in ("arnoldi_cgs2", "shifted_precond"):
        kernel_ms[name] = krylov_ms[feast_label][name]
    La, R1, n2 = krylov_shapes[feast_label][:3]
    bounds = kernel_bounds(problems[14], q, {"La": La, "R1": R1, "n": n2,
                                             "m": 60}, ring_shape)
    # the f32 kernels at the FEAST nP=57 lane shape (phase 24) and at
    # nP=219 (phase 25)
    for name in F32_KERNELS:
        kernel_ms[name] = f32_t[feast_label][0][name]
        bounds[name] = f32_b[feast_label][name]
    kernel_ms.update(prec_t)
    bounds.update(prec_b)
    kernel_ms["block_scatter"] = (b8["wall"], b8["twin_wall"])
    bounds["block_scatter"] = b8["bound"]
    # the one PyTorch call of the same function, where there is one: for
    # K7 it computes the fused Krylov combine (its kernel time:
    # combine_ms); K7 also carries its three-pass floor and the RT nP=123
    # lane shape, K9 its nP=57 ring step; each f32 kernel its RT nP=123
    # lane shape

    def k7_extra(label):
        t, b = krylov_ms[label], krylov_b[label]
        return {"floor_ms": b["floor_ms"],
                "combine_ms": t["krylov_combine"][0],
                "combine_plain_ms": t["krylov_combine"][1],
                "combine_bound_ms": b["combine"][0],
                "library_ms": t["krylov_combine library"]}

    ms57, plain57, lib57, shape57 = ring_t[5]

    def sub(ms, plain, b, dev=None, **extra):
        return {"ms": ms, "plain_ms": plain, "bound_ms": b[0],
                "bound_by": b[1], "library_ms": None, "device_ms": dev,
                **extra}

    library = {
        "ovvv_gather": {
            "device_ms": k4_t["CCSD dressing, 7 columns"][2],
            **{label: sub(ms, plain, b, dev)
               for label, (ms, plain, dev, b, _) in k4_t.items()
               if label != "CCSD dressing, 7 columns"}},
        "ovvv_gather_diag": {
            "device_ms": kernel_ms["ovvv_gather_diag device"]},
        **{name: {"device_ms": ms} for name, ms in tails_dev.items()},
        "block_ladder": {
            "device_ms": k1_alone,
            **{label: sub(*t) for label, t in ladder_t.items()},
            f"sector-sharded, {SECTOR_SHARDS} shards, N = no^2": sub(
                sharded_t[0], sharded_t[2], bounds["block_ladder"],
                whole_plan_ms=sharded_t[1])},
        "pair_symmetrize": {
            "library_ms": kernel_ms["pair_symmetrize library"],
            "library_call": "torch.add(X, X.transpose(-4, -3)"
                            ".transpose(-2, -1))",
            "device_ms": kernel_ms["pair_symmetrize device"],
            "library_device_ms": kernel_ms["pair_symmetrize library device"],
            "ijab+Y": sub(*kernel_ms["pair_symmetrize ijab+Y"],
                          bounds["pair_symmetrize ijab+Y"],
                          kernel_ms["pair_symmetrize ijab+Y device"])},
        "ring_step": {
            "library_ms": k9_lib,
            "library_call": "torch.addmm on the strided panel",
            f"nP={problems[5]['nP']}": {
                "shape": shape57, "ms": ms57, "plain_ms": plain57,
                "library_ms": lib57, "bound_ms": ring_bound(shape57)[0],
                "bound_by": ring_bound(shape57)[1]}},
        "arnoldi_cgs2": {
            "library_call": "torch.baddbmm with a (La, 2, m) coefficient "
                            "batch, the fused Krylov combine",
            **k7_extra(feast_label),
            rt_label: {"ms": krylov_ms[rt_label]["arnoldi_cgs2"][0],
                       "plain_ms": krylov_ms[rt_label]["arnoldi_cgs2"][1],
                       "bound_ms": krylov_b[rt_label]["bound"][0],
                       **k7_extra(rt_label)}}}
    for label in (feast_label, rt_label):
        t, kb = f32_t[label]
        k7 = {"floor_ms": kb["floor_ms"],
              "sweep_ms": {str(m): v[0] for m, v in kb["sweep"].items()},
              "combine_ms": t["krylov_combine_f32"][0],
              "combine_plain_ms": t["krylov_combine_f32"][1],
              "combine_bound_ms": kb["combine"][0],
              "library_ms": t["krylov_combine_f32 library"]}
        k5 = {"library_ms": t["pair_symmetrize_f32 library"]}
        if label == feast_label:
            library["arnoldi_cgs2_f32"] = dict(
                k7, library_call="torch.baddbmm with an f32 (La, 2, m) "
                "coefficient batch, the fused Krylov combine")
            library["pair_symmetrize_f32"] = dict(
                k5, library_call="torch.add(X, X.transpose(-4, -3)"
                ".transpose(-2, -1)), f32")
            continue
        for name in F32_KERNELS:
            library.setdefault(name, {})[label] = {
                "ms": t[name][0], "plain_ms": t[name][1],
                "bound_ms": f32_b[label][name][0],
                "bound_by": f32_b[label][name][1],
                **(k7 if name == "arnoldi_cgs2_f32" else
                   k5 if name == "pair_symmetrize_f32" else {})}
    for name, entries in prec_sub.items():
        library.setdefault(name, {}).update(entries)
    library["block_scatter"] = {
        "device_ms": b8["device"], "kernel_device_ms": b8["kernel"],
        "upload_ms": b8["upload"], "upload_int64_ms": b8["upload_int64"],
        "dense nP=219": {
            "ms": b8_dense["wall"], "device_ms": b8_dense["kernel"],
            "bound_ms": b8_dense["bound"][0],
            "bound_by": b8_dense["bound"][1],
            "library_ms": b8_dense["library"],
            "library_call": "index_put_ of the flat indices and values "
                            "on the card"}}
    print(json.dumps({"kernels": [
        {"name": name, "route": route, "source": src, "replaces": rep,
         "launches": total[name], "max_abs_err": max_err[name],
         "ms": kernel_ms[name][0], "plain_ms": kernel_ms[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": None, **library.get(name, {}),
         **tc_sub.get(name, {})}
        for name, (route, src, rep) in KERNELS.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
