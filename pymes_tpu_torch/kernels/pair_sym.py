"""K5: the P(ab,ij) pair symmetrisation, in Triton.

Replaces the tail of B2, the ``R + Ex + Exᵀ`` of
``pymes_tpu/solver/ccd.py:232-350`` (``doubles_residual_ij``), which is also
the ``d + P(d)`` of the EOM doubles sigma
(``pymes_tpu/solver/eom_ccsd.py:352``):

    out[n, p, q, r, s] = Y[n, p, q, r, s] + X[n, p, q, r, s] + X[n, q, p, s, r]

over an optional leading batch axis n, with Y optional.  It serves both
layouts: ijab (p, q occupied, r, s virtual; the CCD/CCSD residual) and abij
(p, q virtual, r, s occupied; the EOM sigma).

What bounds it on an H100: memory bandwidth — each output element reads
two elements of X (and one of Y) and writes one, with no reduction and no
matrix work.  Two programs, by the size R of the trailing pair:

* R > 16 (ijab: r, s run over nv): the partner X[q, p, s, r] is the
  transposed element of a tile.  A program takes a 32 × 32 tile of (r, s)
  at one (n, p, q); the direct load is contiguous along s, the partner
  load along r, and Triton's layout conversion moves the partner through
  shared memory, so both loads and the store are coalesced.
* R ≤ 16 (abij: r, s run over no): an (r, s) block is too small to tile.
  A program takes 1024 consecutive elements of the flat (q, r, s) index at
  one (n, p), so the direct load and the store are contiguous; the partner
  of a run of R² elements is one contiguous R²-element chunk (row (q, p))
  read in transposed order, so every sector it touches is used whole.

The sum is taken in the twin's order, (Y + X) + Xᵀ, so kernel and twin
agree bit for bit.  Triton is imported inside the launching function: the
module must import where there is no Triton.
"""

import torch

from pymes_tpu_torch import kernels

_K5 = None


def _kernel():
    global _K5
    if _K5 is None:
        import triton
        import triton.language as tl

        @triton.jit
        def pair_sym_kernel(X, Y, out, P, R, HAS_Y: tl.constexpr,
                            TILE: tl.constexpr):
            row = tl.program_id(0)          # n * P + p
            n = row // P
            p = row % P
            q = tl.program_id(1)
            n_t = tl.cdiv(R, TILE)
            r = (tl.program_id(2) // n_t) * TILE + tl.arange(0, TILE)[:, None]
            s = (tl.program_id(2) % n_t) * TILE + tl.arange(0, TILE)[None, :]
            mask = (r < R) & (s < R)
            base = n * P * P * R * R
            direct = base + ((p * P + q) * R + r) * R + s
            partner = base + ((q * P + p) * R + s) * R + r
            x = tl.load(X + direct, mask=mask, other=0.0)
            xp = tl.load(X + partner, mask=mask, other=0.0)
            if HAS_Y:
                y = tl.load(Y + direct, mask=mask, other=0.0)
                val = y + x + xp
            else:
                val = x + xp
            tl.store(out + direct, val, mask=mask)

        @triton.jit
        def pair_sym_flat_kernel(X, Y, out, P, R, HAS_Y: tl.constexpr,
                                 BLOCK: tl.constexpr):
            row = tl.program_id(0)          # n * P + p
            n = row // P
            p = row % P
            RR = R * R
            L = P * RR
            offs = tl.program_id(1) * BLOCK + tl.arange(0, BLOCK)
            mask = offs < L
            q = offs // RR
            rs = offs % RR
            base = n * P * L
            direct = base + p * L + offs
            partner = base + (q * P + p) * RR + (rs % R) * R + rs // R
            x = tl.load(X + direct, mask=mask, other=0.0)
            xp = tl.load(X + partner, mask=mask, other=0.0)
            if HAS_Y:
                y = tl.load(Y + direct, mask=mask, other=0.0)
                val = y + x + xp
            else:
                val = x + xp
            tl.store(out + direct, val, mask=mask)

        _K5 = pair_sym_kernel, pair_sym_flat_kernel
    return _K5


def pair_symmetrize_twin(X, Y=None):
    """Plain twin: ``Y + X + P(X)`` with P swapping the two pairs of the
    last four axes (p↔q and r↔s)."""
    Xp = X.transpose(-4, -3).transpose(-2, -1)
    return X + Xp if Y is None else Y + X + Xp


TILE = 32      # (r, s) tile edge of the tiled program (R > 16)
BLOCK = 1024   # flat elements per program of the flat program (R ≤ 16)


def pair_symmetrize(X, Y=None, twin=False):
    """``out[..., p,q,r,s] = Y + X[..., p,q,r,s] + X[..., q,p,s,r]`` (Y
    optional): K5 on a CUDA tensor, the twin on a CPU tensor or with
    ``twin=True``.  ``X`` is (P, P, R, R) or (n, P, P, R, R), float64."""
    if not kernels.check_device(X) or twin:
        return pair_symmetrize_twin(X, Y)
    if X.dtype != torch.float64 or (Y is not None and Y.dtype != X.dtype):
        raise TypeError("the pair symmetrisation takes float64 tensors")
    if X.dim() not in (4, 5):
        raise ValueError(f"X of shape {tuple(X.shape)}: want (P,P,R,R) or "
                         "(n,P,P,R,R)")
    P, P2, R, R2 = X.shape[-4:]
    if P != P2 or R != R2:
        raise ValueError(f"X of shape {tuple(X.shape)} is not pair-square")
    if Y is not None and (Y.shape != X.shape or Y.device != X.device):
        raise ValueError("Y must have X's shape and device")
    if X.numel() >= 2 ** 31:
        raise ValueError("X too large for 32-bit offsets")
    X = X.contiguous()
    Y = Y.contiguous() if Y is not None else None
    nb = X.numel() // (P * P * R * R)
    out = torch.empty_like(X)
    tiled, flat = _kernel()
    Yp = Y if Y is not None else X
    if R > 16:
        n_t = -(-R // TILE)
        tiled[(nb * P, P, n_t * n_t)](X, Yp, out, P, R, HAS_Y=Y is not None,
                                      TILE=TILE)
    else:
        flat[(nb * P, -(-(P * R * R) // BLOCK))](X, Yp, out, P, R,
                                                 HAS_Y=Y is not None,
                                                 BLOCK=BLOCK)
    kernels.LAUNCHES["pair_symmetrize"] += 1
    return out
