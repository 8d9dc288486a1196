#!/usr/bin/env python3
"""Time the f32 kernels of K1 (the sector ladder), K4 (the ovvv T1
gather) and K7 (the CGS2 projection and the Krylov combine) of one
checkout, beside their f64 kernels at the same widths, on one CUDA card.

    python3 tools/time_f32.py [--tree DIR] [--parts k1,k4,k7] [--out FILE]

Imports ``pymes_tpu_torch`` from ``DIR`` (default: the checkout this file
lies in), so that two trees, a parent and a change, can be timed in one
call on one card, in turns (parent, change, change, parent).  On UEG 14
electrons, rs = 0.5, through the entries the precision modes call:

* K1 on a cd-major operand (nv², N) (``block_ladder_cd``): N = 49 on the
  nP=219 virtual plan (the mixed CCD bulk), N = 98 on the nP=219 all-bra
  plan (an EOM batch of two), N = 3136 on the nP=123 all-bra plan (the RT
  lane batch, 32 lanes of two rows) and N = 6272 on the nP=57 all-bra
  plan (the FEAST lane batch, 64 lanes), in f32 on the plan cast by
  ``cast_plan`` and in f64;
* K4 (``ovvv_gather``) on each of the three OVVV plans: 7 columns at
  nP=219 (the (nv, no) T1 of the CCSD dressing), 14 at nP=219 (an EOM
  batch of two), 448 at nP=123 and 896 at nP=57 (the RT and FEAST lane
  batches), each a (k, nv, no) view of (k, N) Krylov rows; f32 on the
  plan's weights cast, and f64;
* K4′, the fused G_vv trace of the dressing (``ovvv_t1_trace`` on the vov
  and ovv plans at nP=219), f32 and f64: launch-bound (its bound, 2 MB of
  reads, is below the time of one launch);
* K7 on an f32 basis at the FEAST nP=57 lane shape (64 lanes, 121 basis
  rows of 245 700) and the RT nP=123 one (32 lanes, 21 rows of
  1 320 312): the projection of all lanes at each m of ``K7_SWEEP``, and
  the fused x/r combine at m + 1 of the shape's middle m (60, 10); every
  call follows a write of ``FLUSH_BYTES`` that evicts the 50 MB L2 (in the
  solver a sigma runs between two projections).  Each m is held to the
  twin (1e-5 relative).  Beside each time: the three-pass floor and the
  once-read bound (``util/roofline.py`` ``krylov_bounds``).  Also a digest
  of the f64 K7's outputs (projection and combine) on seeded inputs, so
  that two trees can show the same f64 bits.

``--parts`` picks the sections (default: all).  Each f32 call of K1 and
K4 is first held to its f32 twin (K1 within 1e-5 relative and
a rerun bit for bit, K4 bit for bit).  Per call: ms through the wrapper
(CUDA events, mean of 20 calls after 3 warm-ups; K4 the mean over the
three plans), on the card alone (``torch.profiler``, the kernels whose
name holds ``block_ladder`` or ``ovvv``), and the bound: the larger of
the bytes (each input read once, each output written once, 4 or 8 bytes
an element, int32 indices) over 3.35 TB/s and the flops over 67 TFLOP/s
(FP32 FMA; f64: the tensor cores for K1, 34 TFLOP/s FMA for K4).  Prints
the card and one JSON line; ``--out`` also writes it to FILE.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

NO = 7
HBM_BYTES_S = 3.35e12
FLOPS_S = {4: 67e12, 8: 67e12}          # FP32 FMA; FP64 tensor cores (K1)
K4_FLOPS_S = {4: 67e12, 8: 34e12}       # FP32 FMA; FP64 FMA
# (label, cutoff, bra of the plan, N)
K1_WIDTHS = (("N = 49, nP=219 virtual plan", 14, "virtual", 49),
             ("N = 98, nP=219 all-bra plan (EOM batch)", 14, "all", 98),
             ("N = 3136, nP=123 all-bra plan (RT lanes)", 10, "all", 3136),
             ("N = 6272, nP=57 all-bra plan (FEAST lanes)", 5, "all", 6272))
# (label, cutoff, trials): None trials = the dressing's (nv, no) T1
# K7: (label, lanes, basis rows, n, the projection's m sweep, the timed m)
K7_SHAPES = (("FEAST nP=57", 64, 121, 245700, (8, 16, 30, 60, 90, 120), 60),
             ("RT nP=123", 32, 21, 1320312, (4, 10, 16, 20), 10))
FLUSH_BYTES = 256 << 20
K7_KERNELS = {"projection": ("arnoldi_pass", "arnoldi_scale", "cgs2"),
              "combine": ("krylov_combine", "combine_kernel")}
K4_WIDTHS = (("7 columns, nP=219 (CCSD dressing)", 14, None),
             ("14 columns, nP=219 (EOM batch)", 14, 2),
             ("448 columns, RT nP=123", 10, 64),
             ("896 columns, FEAST nP=57", 5, 128))


def cuda_ms(torch, fn, n=20, warmup=3):
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


def card_ms(torch, fn, name, n=20, warmup=3):
    """Mean time on the card of the kernels whose name holds ``name`` in a
    call of ``fn`` (``torch.profiler``); a session whose trace holds no such
    kernel is run again, up to three sessions (a session on an H100 lost
    its CUDA activity once), then None."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_cuda_time_total
                 if getattr(e, "self_device_time_total", None) is None
                 else e.self_device_time_total
                 for e in prof.key_averages() if name in e.key)
        if us > 0:
            return us / 1e3 / n
    return None


def flushed_ms(torch, fn, flush, n=10, warmup=2):
    """Mean ms of ``fn`` over n calls (CUDA events around each call), each
    after a write of ``flush`` that evicts the L2."""
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


def flushed_card_ms(torch, fn, flush, names, n=10):
    """Mean time on the card of the kernels whose name holds one of
    ``names`` in a call of ``fn`` after an L2 flush (``torch.profiler``;
    None when a session's trace holds no such kernel three times)."""
    from torch.profiler import ProfilerActivity, profile

    flush.add_(1)
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                flush.add_(1)
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_cuda_time_total
                 if getattr(e, "self_device_time_total", None) is None
                 else e.self_device_time_total
                 for e in prof.key_averages()
                 if any(k in e.key for k in names))
        if us > 0:
            return us / 1e3 / n
    return None


def time_k7(torch, dev, g):
    import hashlib

    from pymes_tpu_torch.kernels import arnoldi
    from pymes_tpu_torch.util.roofline import krylov_bounds

    flush = torch.zeros(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    out = {}
    for label, La, R1, n, sweep, mid in K7_SHAPES:
        V = torch.randn((La, R1, n), generator=g, dtype=torch.float32,
                        device=dev) / float(n ** 0.5)
        lanes = torch.arange(La, device=dev)
        entry = {}
        for m in sweep:
            # a fresh w per m: the row an earlier m wrote lies in the span
            # of its w, which a projection would reduce to rounding noise
            w0 = torch.randn((La, n), generator=g, dtype=torch.float32,
                             device=dev)
            mt = torch.full_like(lanes, m)
            hk = arnoldi.arnoldi_cgs2(V, w0.clone(), lanes, mt)
            row = V[:, m].clone()
            again = arnoldi.arnoldi_cgs2(V, w0.clone(), lanes, mt)
            torch.cuda.synchronize()
            assert torch.equal(hk, again) and torch.equal(row, V[:, m]), \
                f"K7 f32 {label} m={m}: a rerun changed the bits"
            ht = arnoldi.arnoldi_cgs2(V, w0.clone(), lanes, mt, twin=True)
            rel = max(float((hk - ht).abs().max() / ht.abs().max()),
                      float((row.double() - V[:, m].double()).abs().max()
                            / V[:, m].double().abs().max()))
            assert rel <= 1e-5, f"K7 f32 {label} m={m}: {rel:.2e}"
            ws = [w0.clone() for _ in range(12)]

            def proj(ws=ws, mt=mt):
                return arnoldi.arnoldi_cgs2(V, ws.pop() if ws else
                                            w0.clone(), lanes, mt)

            kb = krylov_bounds(La, m, n, elem=4)
            ms = flushed_ms(torch, proj, flush)
            entry[f"m={m}"] = {
                "ms": ms, "device_ms": flushed_card_ms(
                    torch, proj, flush, K7_KERNELS["projection"]),
                "floor_ms": kb["floor_ms"], "bound_ms": kb["bound"][0],
                "floor_share": kb["floor_ms"] / ms,
                "bound_share": kb["bound"][0] / ms, "max_rel_err": rel}
            del ws
        m1 = torch.full_like(lanes, mid + 1)
        C = torch.randn((La, 2, R1), generator=g, dtype=torch.float64,
                        device=dev)
        x0 = torch.randn((La, n), generator=g, dtype=torch.float32,
                         device=dev)

        def comb(tw=False):
            return arnoldi.krylov_combine_xr(V, C, m1, lanes, x0=x0, twin=tw)

        got, want = comb(), comb(True)
        rel = max(float((a.double() - b.double()).abs().max()
                        / b.double().abs().max()) for a, b in zip(got, want))
        assert rel <= 1e-5, f"K7 f32 combine {label}: {rel:.2e}"
        kb = krylov_bounds(La, mid + 1, n, elem=4)
        ms = flushed_ms(torch, comb, flush)
        entry["combine"] = {
            "m": mid + 1, "ms": ms, "device_ms": flushed_card_ms(
                torch, comb, flush, K7_KERNELS["combine"]),
            "bound_ms": kb["combine"][0],
            "bound_share": kb["combine"][0] / ms, "max_rel_err": rel}
        out[label] = entry
        del V, w0, got, want, x0, hk, ht, again
        torch.cuda.empty_cache()
    # the f64 K7's bits on seeded inputs (lanes at uneven m)
    g64 = torch.Generator(device=dev).manual_seed(64)
    V = torch.randn((6, 21, 70001), generator=g64, dtype=torch.float64,
                    device=dev)
    w = torch.randn((5, 70001), generator=g64, dtype=torch.float64,
                    device=dev)
    C = torch.randn((5, 2, 21), generator=g64, dtype=torch.float64,
                    device=dev)
    lanes = torch.as_tensor([4, 0, 2, 5, 1], device=dev)
    m = torch.as_tensor([1, 7, 16, 17, 20], device=dev)
    H = arnoldi.arnoldi_cgs2(V, w, lanes, m)
    x, r = arnoldi.krylov_combine_xr(V, C, m + 1, lanes, x0=w)
    digest = hashlib.sha1()
    for t in (H, V, x, r):
        digest.update(t.cpu().numpy().tobytes())
    out["f64 K7 digest"] = digest.hexdigest()
    return out


def per_plan(ms, n):
    return None if ms is None else ms / n


def bound_ms(nbytes, flops, flops_s):
    t_b, t_f = nbytes / HBM_BYTES_S * 1e3, flops / flops_s * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def time_k1(torch, models, dev, g):
    from pymes_tpu_torch.kernels import block_ladder
    from pymes_tpu_torch.ops import ueg_ladder

    out = {}
    for label, cutoff, bra, N in K1_WIDTHS:
        u = models[cutoff]
        plan = ueg_ladder.build_block_ladder(u, device=dev, bra=bra)
        p32 = ueg_ladder.cast_plan(plan, torch.float32)
        nv = u.n_spatial - NO
        T = torch.randn((nv * nv, N), generator=g, dtype=torch.float64,
                        device=dev) * 0.01
        T32 = T.float()
        got = block_ladder.block_ladder_cd(p32, T32)
        again = block_ladder.block_ladder_cd(p32, T32)
        want = block_ladder.block_ladder_cd(p32, T32, twin=True)
        torch.cuda.synchronize()
        assert torch.equal(got, again), f"K1 f32 {label}: rerun differs"
        rel = float((got.double() - want.double()).abs().max()
                    / want.double().abs().max())
        assert rel <= 1e-5, f"K1 f32 {label}: {rel:.2e} from the twin"
        pk = plan.packed
        rows, blocks = pk.n_rows, pk.blocks.numel()
        idx = 4 * (pk.perm.numel() + pk.bra_of_row.numel())
        entry = {"max_rel_err": rel}
        for tag, P, X, e in (("f32", p32, T32, 4), ("f64", plan, T, 8)):
            def fn(tw, P=P, X=X):
                return block_ladder.block_ladder_cd(P, X, twin=tw)

            t = [cuda_ms(torch, lambda: fn(tw)) for tw in (True, False,
                                                           False, True)]
            b = bound_ms(e * (nv * nv * N + rows * N + blocks) + idx,
                         2 * blocks * N, FLOPS_S[e])
            entry[tag] = {"ms": (t[1] + t[2]) / 2, "plain_ms": (t[0] + t[3])
                          / 2, "device_ms": card_ms(torch, lambda: fn(False),
                                                    "block_ladder"),
                          "bound_ms": b[0], "bound_by": b[1]}
        out[label] = entry
        del T, T32, got, again, want
        torch.cuda.empty_cache()
    return out


def time_k4(torch, models, dev, g):
    from pymes_tpu_torch.kernels import ovvv_gather
    from pymes_tpu_torch.ops import ueg_ladder

    out, plans_of = {}, {}
    for label, cutoff, k in K4_WIDTHS:
        u = models[cutoff]
        if cutoff not in plans_of:
            plans_of[cutoff] = ueg_ladder.build_ovvv_plans(u, device=dev)
        plans = plans_of[cutoff]
        nv = u.n_spatial - NO
        N = nv * NO + nv * nv * NO * NO
        if k is None:
            T = torch.randn((nv, NO), generator=g, dtype=torch.float64,
                            device=dev)
            ncol = NO
        else:
            rows = torch.randn((k, N), generator=g, dtype=torch.float64,
                               device=dev)
            T = rows[:, :nv * NO].reshape(k, nv, NO)
            ncol = k * NO
        if k is None:
            T32 = T.float()
        else:
            T32 = rows.float()[:, :nv * NO].reshape(k, nv, NO)
        p32 = {n: p._replace(W=p.W.float()) for n, p in plans.items()}
        for p in p32.values():
            got = ovvv_gather.ovvv_gather(p.S, p.W, T32)
            assert torch.equal(got, ovvv_gather.ovvv_gather(p.S, p.W, T32,
                                                            twin=True)), \
                f"K4 f32 {label}: kernel and twin differ"
        entry = {}
        for tag, P, X, e in (("f32", p32, T32, 4), ("f64", plans, T, 8)):
            def fn(tw, P=P, X=X):
                return [ovvv_gather.ovvv_gather(p.S, p.W, X, twin=tw)
                        for p in P.values()]

            n = len(P)
            t = [cuda_ms(torch, lambda: fn(tw)) / n
                 for tw in (True, False, False, True)]
            bs = [bound_ms(4 * p.S.numel() + e * (p.W.numel() + nv * ncol
                                                  + ncol * p.S.numel()),
                           ncol * p.S.numel(), K4_FLOPS_S[e])
                  for p in P.values()]
            entry[tag] = {"ms": (t[1] + t[2]) / 2,
                          "plain_ms": (t[0] + t[3]) / 2,
                          "device_ms": per_plan(card_ms(
                              torch, lambda: fn(False), "ovvv"), n),
                          "bound_ms": sum(b[0] for b in bs) / n,
                          "bound_by": bs[0][1]}
        out[label] = entry
        del T, T32
        torch.cuda.empty_cache()
    return out


def time_trace(torch, models, dev, g):
    from pymes_tpu_torch.ops import ueg_ladder

    u = models[14]
    plans = ueg_ladder.build_ovvv_plans(u, device=dev)
    nv = u.n_spatial - NO
    T = torch.randn((nv, NO), generator=g, dtype=torch.float64, device=dev)
    out = {}
    for tag, X, cast, e in (("f32", T.float(), torch.float32, 4),
                            ("f64", T, torch.float64, 8)):
        P = [(plans[pat]._replace(W=plans[pat].W.to(cast)), axis)
             for pat, axis in (("vov", 1), ("ovv", 0))]

        def fn(tw, P=P, X=X):
            return [ueg_ladder.ovvv_t1_trace(p, X, axis, twin=tw)
                    for p, axis in P]

        t = [cuda_ms(torch, lambda: fn(tw)) / 2 for tw in (True, False,
                                                           False, True)]
        bs = [bound_ms(4 * p.S.numel() + e * (p.W.numel() + nv * NO
                                              + nv * nv),
                       2 * p.S.numel(), K4_FLOPS_S[e]) for p, _ in P]
        out[tag] = {"ms": (t[1] + t[2]) / 2, "plain_ms": (t[0] + t[3]) / 2,
                    "device_ms": per_plan(card_ms(torch, lambda: fn(False),
                                                  "diag"), 2),
                    "bound_ms": sum(b[0] for b in bs) / 2,
                    "bound_by": bs[0][1]}
    return {"G_vv trace, nP=219 (vov and ovv plans)": out}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent
                                          .parent))
    ap.add_argument("--parts", default="k1,k4,k7")
    ap.add_argument("--out")
    args = ap.parse_args()
    parts = set(args.parts.split(","))
    tree = str(Path(args.tree).resolve())
    sys.path.insert(0, tree)

    import torch

    if not torch.cuda.is_available():
        print("time_f32: torch sees no CUDA device", file=sys.stderr)
        return 1
    from pymes_tpu_torch.models import ueg
    from pymes_tpu_torch.ops import ueg_ladder

    assert Path(ueg_ladder.__file__).resolve().is_relative_to(tree)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.splitlines()[0]
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(17)
    models = {}
    for cutoff in (5, 10, 14) if parts & {"k1", "k4"} else ():
        u = models[cutoff] = ueg.UEG(14, 7, 7, 0.5)
        u.init_single_basis(cutoff)
    out = {"tree": tree, "card": card.strip()}
    if "k1" in parts:
        out["K1"] = time_k1(torch, models, dev, g)
    if "k4" in parts:
        out["K4"] = time_k4(torch, models, dev, g)
        out["K4'"] = time_trace(torch, models, dev, g)
    if "k7" in parts:
        out["K7"] = time_k7(torch, dev, g)
    print(card.strip())
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
