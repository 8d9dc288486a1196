"""K7: the CGS2 Arnoldi projection and the Krylov row combines.

Replaces B6, the body of ``pymes_tpu/ops/gmres.py:87-131`` ``gmres``
(the projection at :101-108) and its two Krylov combines, the solution
update ``x = x0 + Σ y_i V_i`` (:162) and the reconstructed restart residual
``Σ u_i V_i`` (:179), for L independent GMRES systems ("lanes") at once.
For each active lane a with ``m_a`` valid basis rows V[ℓ_a, :m_a]:

    h = V w;  w ← w − Vᵀh;  h += V w;  w ← w − Vᵀ(V w);  ‖w‖

then the new row V[ℓ_a, m_a] = w/‖w‖, or zero when ‖w‖ ≤ the JAX
``_BREAK`` guard (1e-140 for an f64 basis, 1e-18 for an f32 one: a
near-zero direction is noise and must not be normalised).  The returned
Hessenberg column is (h₁ + h₂, ‖w‖) in rows 0..m_a, zero past them, in
float64 for either basis type.

The basis V (and w, x0 and the combines' outputs) is float64, or float32
for the f32 Krylov solves of the mixed-precision engine: every sum, the
projection coefficients h, the norm and the combine coefficients are
float64 in both (the source says where an f32 basis rounds).

The kernels are CUDA C++ (``pymes_tpu_torch/csrc/arnoldi.cu``, built with
nvcc for sm_90a at first use), of two designs:

* f64: exact CGS2 in three dependent streaming passes over the m_a valid
  rows and a guarded scale (4 launches a projection), all lanes in one
  wave; one pass over V for both cycle-end combines
  (:func:`krylov_combine_xr`).  :func:`plan` cuts each lane's columns into
  the blocks' ranges; it and :func:`tile_cols` (the tile width the kernel
  takes for m rows) are plain Python so that the CPU tests reach them.
* f32: the three passes and the scale in one cooperative launch of one
  block an SM over every lane at once, each block an equal share of the
  lanes' rows laid end to end (:func:`f32_plan`); a block keeps its share
  for the three passes and walks its tiles (:func:`f32_steps`) forward,
  backward, forward (:func:`f32_walk`), so each pass starts on what the L2
  holds of the one before.  The f32 combine streams the rows with 16-byte
  loads and stores.

The source says what bounds each and how the design answers.

The twins (``*_twin``) loop over the lanes with ``torch.mv`` products in
the JAX order, in float64 on the widened basis, rounding to the basis type
where the kernel stores; a lane's twin result does not depend on the other
lanes, so the lane-batched GMRES on the CPU equals one-lane solves bit for
bit.
"""

import collections
import functools

import torch

from pymes_tpu_torch import kernels
from pymes_tpu_torch.kernels import _build

BREAK = 1e-140        # ops/gmres.py:69, the f64 breakdown guard
BREAK_F32 = 1e-18     # the same guard of an f32 basis
# the doubles of one tile buffer of the projection and of the combine
# (csrc/arnoldi.cu PROJ_TILE, COMB_TILE)
PROJ_TILE = 3072
COMB_TILE = 4096
MAX_ROWS = 128        # basis rows a projection or combine takes
BLOCKS_PER_SM = 2     # two ~99 KB blocks share an SM's shared memory
MIN_SPAN = 2048       # columns a block takes at least
# the f32 projection (csrc/arnoldi.cu namespace f32k)
F32_BLOCKS_PER_SM = 1         # one 201 KB block an SM, all resident at once
F32_PART_ROWS = 16            # rows a thread holds at most
F32_RING_FLOATS = 48 * 1024   # the tiles' ring: 192 KB ...
F32_MAX_BUF = 8               # ... of at most 8 buffers
F32_SMEM = 4 * F32_RING_FLOATS + 8 * (128 + 8 * 128) + 8 * F32_MAX_BUF \
    + 16                      # the block's shared memory (csrc SMEM)


def breakdown(dtype):
    """The breakdown guard of a basis of ``dtype`` (``ops/gmres.py:69``)."""
    return BREAK_F32 if dtype == torch.float32 else BREAK


def tile_cols(rows, tile=PROJ_TILE):
    """Columns of the kernel's tile of ``rows`` rows (the m valid rows,
    plus w's row in a projection) of the f64 kernels in a buffer of
    ``tile`` doubles: a multiple of 16."""
    return tile // max(rows, 1) // 16 * 16


@functools.lru_cache(maxsize=256)
def plan(n, La, sms, elem=8):
    """(G, span): each lane's n columns cut into G ranges of ``span``
    columns (a multiple of 16 bytes of ``elem``-byte elements, so every
    row segment stays 16-byte aligned), G as large as fills ``sms`` SMs two
    blocks deep with La lanes, and at least ``MIN_SPAN`` columns a
    range."""
    G = max(1, min(sms * BLOCKS_PER_SM // max(La, 1), -(-n // MIN_SPAN)))
    vec = 16 // elem
    span = -(-n // G)
    span = -(-span // vec) * vec
    return -(-n // span), span


def block_tiles(n, G, span, rows, tile=PROJ_TILE):
    """The column tiles [c0, c1) that block g of a lane walks, for each g,
    as the kernel walks them with ``rows`` tile rows."""
    C = tile_cols(rows, tile)
    out = []
    for g in range(G):
        cb, ce = g * span, min(n, (g + 1) * span)
        out.append([(c, min(ce, c + C)) for c in range(cb, ce, C)])
    return out


F32Plan = collections.namedtuple("F32Plan", "share blocks maxg")
F32Plan.__doc__ = """The f32 projection's plan for one call: each block takes
``share`` columns of the active lanes' rows laid end to end, ``blocks``
blocks have some, and ``maxg`` is the most blocks whose shares meet one
lane (the partials' layout)."""


def f32_parts(m):
    """Threads that share a column quad of the f32 projection's tiles for
    m valid rows, each with every G-th row: G = 1, 2, 4, 8, so that a thread
    holds at most ``F32_PART_ROWS`` rows (csrc ``parts_of``)."""
    return 1 if m < 16 else 2 if m < 32 else 4 if m < 64 else 8


@functools.lru_cache(maxsize=256)
def f32_plan(n, La, nb):
    """The f32 projection's plan for ``La`` active lanes with rows of ``n``
    columns on a grid of ``nb`` resident blocks (the SMs ×
    ``F32_BLOCKS_PER_SM``): the lanes' rows laid end to end are cut into
    equal shares, a multiple of 4 columns, one a block, so every block
    streams the same columns a pass (the same bytes where the lanes share
    m, as the GMRES's do) and, where n is a multiple of 4, every row
    segment stays 16-byte aligned.  A share may end one lane and start the
    next.  The plan does not depend on the lanes' row counts, so the
    wrapper needs no host copy of them (the kernel takes each lane's tile
    shape from its m on the card).  (Lanes taken a few at a time, so that
    passes 1 and 2 read from the L2, lost on the H100: each lane's three
    meetings of its blocks cost more than the L2 saved; PERF.md.)"""
    total = La * n
    share = -(-total // nb)
    share = -(-share // 4) * 4
    maxg = max(((a + 1) * n - 1) // share - a * n // share + 1
               for a in range(La))
    return F32Plan(share, -(-total // share), maxg)


def f32_tile_cols(m):
    """Columns of the f32 projection's tiles for m valid rows: 256
    threads, G of them a quad of 4 columns."""
    return 1024 // f32_parts(m)


def f32_steps(cb, ce, m):
    """The column tiles [c0, c1) of a block's range [cb, ce) in the
    forward walk of a lane with m valid rows."""
    w = f32_tile_cols(m)
    return [(c, min(ce, c + w)) for c in range(cb, ce, w)]


def f32_walk(plan, n, ms):
    """The f32 kernel's walk of ``plan`` for lanes of ``ms`` valid rows:
    for each block, its items (lane, (cb, ce)) and, pass by pass in the
    order the block takes them, (pass, lane, the column tiles in the order
    walked).  Odd passes take the items, and each item's tiles, in
    reverse."""
    out = []
    total = len(ms) * n
    for b in range(plan.blocks):
        t0, t1 = b * plan.share, min(total, (b + 1) * plan.share)
        items = [(a, (max(t0, a * n) - a * n, min(t1, (a + 1) * n) - a * n))
                 for a in range(t0 // n, (t1 - 1) // n + 1)]
        walk = []
        for p in range(3):
            for a, (cb, ce) in (items[::-1] if p == 1 else items):
                tiles = f32_steps(cb, ce, ms[a])
                walk.append((p, a, tiles[::-1] if p == 1 else tiles))
        out.append((items, walk))
    return out


def f32_ring_buffers(m):
    """Tile buffers of the f32 ring for m valid rows: as many (m + 1)-row
    tiles as fit, at most ``F32_MAX_BUF``."""
    return min(F32_MAX_BUF, F32_RING_FLOATS // ((m + 1) * f32_tile_cols(m)))


def _check(V, lanes, m, *rows):
    """The type, device and shape refusals; returns the type suffix."""
    sfx = kernels.type_suffix("K7", V, *rows)
    for t in (V,) + rows:
        if not t.is_contiguous():
            raise TypeError("K7 takes contiguous tensors")
    for t in (lanes, m):
        if t.dtype != torch.int64 or not t.is_contiguous():
            raise TypeError("K7 takes int64 lane and row counts")
    if len({t.device for t in (V, lanes, m) + rows}) != 1:
        raise ValueError("tensors lie on different devices")
    if V.dim() != 3 or lanes.shape != m.shape or lanes.dim() != 1:
        raise ValueError("K7 takes V (L, rows, n) and per-lane lanes, m")
    if V.shape[1] > MAX_ROWS:
        raise ValueError(f"K7 takes at most {MAX_ROWS} basis rows "
                         "(GMRES restart ≤ 127)")
    for t in rows:
        if t.shape[0] != lanes.shape[0]:
            raise ValueError("one row per active lane")
    return sfx


def _launch(V, La):
    """(library, (G, span)) for a K7 launch on V's device."""
    return (_build.library(),
            plan(V.shape[2], La, _build.sm_count(V.device),
                 V.element_size()))


def _rc(dev, fn, what, *args):
    """Launch ``fn(*args)`` on ``dev``'s current stream; raise on an
    error."""
    rc = _build.launch(dev, fn, *args)
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


def arnoldi_cgs2_twin(V, w, lanes, m):
    """Plain twin: per lane, two CGS passes as ``torch.mv`` products in the
    JAX order (h = V w; w − Vᵀh; h summed over both), the norm, and the
    guarded normalised row written into V; float64 sums on the widened
    basis, w₁ and the new row rounded to the basis type where the kernel
    stores them (no-ops for an f64 basis)."""
    H = torch.zeros((w.shape[0], V.shape[1]), dtype=torch.float64,
                    device=w.device)
    brk = breakdown(V.dtype)
    for a, (lane, mm) in enumerate(zip(lanes.tolist(), m.tolist())):
        Vl = V[lane, :mm].double()
        wa = w[a].double()
        for p in range(2):
            hp = torch.mv(Vl, wa)
            wa = wa - torch.mv(Vl.t(), hp)
            if p == 0:
                wa = wa.to(V.dtype).double()
            H[a, :mm] += hp
        hn = torch.sqrt(torch.dot(wa, wa))
        H[a, mm] = hn
        V[lane, mm] = (torch.where(hn > brk, 1.0 / torch.clamp(hn, min=brk),
                                   torch.zeros_like(hn))
                       * wa.to(V.dtype).double()).to(V.dtype)
    return H


def arnoldi_cgs2(V, w, lanes, m, twin=False):
    """One CGS2 Arnoldi projection for each active lane: ``V`` (L, R+1, n)
    the Krylov bases, ``w`` (La, n) the new operator images of the active
    lanes ``lanes`` (La,) int64, whose first ``m`` (La,) int64 rows are
    valid (m ≤ R).  Writes the guarded normalised row V[lanes, m] in place
    and returns the float64 Hessenberg columns (La, R+1) (rows < m: h₁ +
    h₂, row m: ‖w‖).  ``V`` and ``w`` are float64 or float32.  ``w`` is
    consumed.  K7 on a CUDA tensor, the twin on a CPU tensor or with
    ``twin=True``."""
    if not kernels.check_device(V) or twin:
        return arnoldi_cgs2_twin(V, w, lanes, m)
    sfx = _check(V, lanes, m, w)
    L, R1, n = V.shape
    La = lanes.shape[0]
    if w.shape != (La, n):
        raise ValueError("w must be (active lanes, n)")
    if sfx:
        return _cgs2_f32(V, w, lanes, m)
    lib, (G, span) = _launch(V, La)
    dev = V.device
    f64 = torch.float64
    P = torch.empty((3, La, G, MAX_ROWS), dtype=f64, device=dev)
    h1 = torch.empty((La, MAX_ROWS), dtype=f64, device=dev)
    H = torch.empty((La, R1), dtype=f64, device=dev)
    ptrs = [t.data_ptr() for t in (V, w, lanes, m, P, h1, H)]
    fn = getattr(lib, "pymes_arnoldi_pass" + sfx)
    for p in range(3):
        _rc(dev, fn, f"K7 pass {p}", p, *ptrs, n, R1 * n, R1, span, G, La)
    _rc(dev, getattr(lib, "pymes_arnoldi_scale" + sfx), "K7 scale", ptrs[0],
        ptrs[2], ptrs[3], ptrs[4], ptrs[6], n, R1 * n, R1, span, G, La,
        breakdown(V.dtype))
    kernels.LAUNCHES["arnoldi_cgs2" + sfx] += 1
    return H


def _cgs2_f32(V, w, lanes, m):
    """The f32 projection: one cooperative launch over :func:`f32_plan`'s
    lane groups; H, the partials, the lane sums and the meeting words in
    one allocation."""
    L, R1, n = V.shape
    La = lanes.shape[0]
    dev = V.device
    if La == 0:
        return torch.empty((0, R1), dtype=torch.float64, device=dev)
    nb = _build.sm_count(dev) * F32_BLOCKS_PER_SM
    plan = f32_plan(n, La, nb)
    sizes = (La * R1, 3 * La * plan.maxg * R1, La * 3 * MAX_ROWS, 3 * La)
    buf = torch.empty(sum(sizes), dtype=torch.float64, device=dev)
    H, P, S, sync = torch.split(buf, sizes)
    ptr = [t.data_ptr() for t in (V, w, lanes, m, P, S, H, sync)]
    _rc(dev, _build.library().pymes_arnoldi_cgs2_f32, "K7 f32 projection",
        *ptr[:4], plan.share, *ptr[4:], n, R1 * n, R1, La, plan.maxg, R1,
        plan.blocks, BREAK_F32)
    kernels.LAUNCHES["arnoldi_cgs2_f32"] += 1
    return H.view(La, R1)


def krylov_combine_twin(V, coeffs, m, lanes, x0=None):
    """Per lane ``x0 + Σ_i coeffs[a, i] V_i``, summed in float64 and
    rounded to the basis type."""
    out = []
    for a, (lane, mm) in enumerate(zip(lanes.tolist(), m.tolist())):
        s = torch.mv(V[lane, :mm].double().t(), coeffs[a, :mm].double())
        out.append((s if x0 is None else x0[a].double() + s).to(V.dtype))
    return torch.stack(out)


def krylov_combine_xr_twin(V, coeffs, m, lanes, x0=None):
    """The two single combines: ``x0 + Σ coeffs[a, 0, i] V_i`` and
    ``Σ coeffs[a, 1, i] V_i``."""
    return (krylov_combine_twin(V, coeffs[:, 0], m, lanes, x0),
            krylov_combine_twin(V, coeffs[:, 1], m, lanes))


def _combine(V, coeffs, m, lanes, x0):
    """K7's combine of ``coeffs`` (La, nout, k ≤ R+1; float64 or float32,
    widened to float64) on the card; returns the nout outputs (La, n) of
    V's type."""
    La, nout = coeffs.shape[:2]
    sfx = _check(V, lanes, m, *(() if x0 is None else (x0,)))
    if coeffs.dtype not in kernels.SUFFIX or coeffs.device != V.device:
        raise TypeError("K7 takes float coefficients on V's device")
    L, R1, n = V.shape
    if (coeffs.shape[0] != La or coeffs.shape[2] > R1
            or (x0 is not None and x0.shape != (La, n))):
        raise ValueError("coefficients or x0 do not fit V")
    C = torch.zeros((La, nout, R1), dtype=torch.float64, device=V.device)
    C[:, :, :coeffs.shape[2]] = coeffs
    out = torch.empty((nout, La, n), dtype=V.dtype, device=V.device)
    ptrs = (V.data_ptr(), lanes.data_ptr(), m.data_ptr(), C.data_ptr(), nout,
            None if x0 is None else x0.data_ptr(), out[0].data_ptr(),
            out[nout - 1].data_ptr() if nout > 1 else None, n, R1 * n, R1)
    if sfx:
        _rc(V.device, _build.library().pymes_krylov_combine_f32,
            "K7 f32 combine", *ptrs, La)
    else:
        lib, (G, span) = _launch(V, La)
        _rc(V.device, lib.pymes_krylov_combine, "K7 combine", *ptrs, span,
            G, La)
    kernels.LAUNCHES["arnoldi_cgs2" + sfx] += 1
    return out


def krylov_combine(V, coeffs, m, lanes, x0=None, twin=False):
    """``x0 + Σ_{i<m_a} coeffs[a, i]·V[lanes[a], i]`` per active lane (the
    GMRES solution update and the reconstructed residual, ``x0=None``);
    ``coeffs`` (La, R+1).  K7 on a CUDA tensor, the twin on a CPU tensor
    or with ``twin=True``."""
    if not kernels.check_device(V) or twin:
        return krylov_combine_twin(V, coeffs, m, lanes, x0)
    return _combine(V, coeffs[:, None], m, lanes, x0)[0]


def krylov_combine_xr(V, coeffs, m, lanes, x0=None, twin=False):
    """Both cycle-end combines in one pass over V: ``coeffs`` (La, 2, R+1)
    holds the solution coefficients y (row 0) and the residual's u (row
    1); returns ``(x0 + Σ y_i V_i, Σ u_i V_i)``, each summed as the single
    combine sums it.  K7 on a CUDA tensor, the twin on a CPU tensor or
    with ``twin=True``."""
    if not kernels.check_device(V) or twin:
        return krylov_combine_xr_twin(V, coeffs, m, lanes, x0)
    x, r = _combine(V, coeffs, m, lanes, x0)
    return x, r
