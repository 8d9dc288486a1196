"""48-fold permutation symmetry of the 3-body L tensor (host numpy).

A copy of ``pymes_tpu/integral/symmetry.py``, held equal to it by
``tests/test_torch_io.py``.

The transcorrelated 3-body integral L^{opq}_{rst} is symmetric under the 6
joint permutations of its electron pairs and (for real orbitals) the 2³
bra↔ket exchanges within each pair — 48 images total.  The reference ships
broken/unfinished helpers for this (``pymes/integral/contraction.py:98-283``:
``recover_L`` calls CTF methods on numpy arrays, ``gen_sym_int_inds``
returns ``None``); these are working, vectorized equivalents operating on
the chemists' pair-interleaved storage layout (o, r, p, s, q, t) of
:mod:`pymes_tpu_torch.util.tcdump`.
"""

import itertools

import numpy as np

# pair slots in the interleaved layout: (ket, bra) axis positions
_PAIRS = ((0, 1), (2, 3), (4, 5))


def sym_images_axes():
    """The 48 axis permutations (tuples of length 6) generating the
    symmetry images of an interleaved-layout L tensor."""
    images = []
    for per in itertools.permutations(range(3)):          # permute pairs
        base = [_PAIRS[p][0] for p in per], [_PAIRS[p][1] for p in per]
        for flips in itertools.product((False, True), repeat=3):
            axes = []
            for i in range(3):
                k, b = base[0][i], base[1][i]
                if flips[i]:
                    k, b = b, k
                axes.extend((k, b))
            images.append(tuple(axes))
    return images


def gen_sym_str_inds(string_inds):
    """All 48 symmetry-related index strings of a 6-character einsum index
    (working version of ``contraction.py:205``)."""
    s = list(string_inds)
    return ["".join(s[a] for a in axes) for axes in sym_images_axes()]


def symmetrize(t_L):
    """Average a 6-index tensor over its 48 symmetry images."""
    acc = np.zeros_like(t_L)
    for axes in sym_images_axes():
        acc += np.transpose(t_L, axes)
    return acc / 48.0


def symmetry_defect(t_L):
    """Max absolute deviation of the tensor from each symmetry image —
    a property-test utility for TCDUMP round trips."""
    return max(float(np.abs(np.transpose(t_L, axes) - t_L).max())
               for axes in sym_images_axes())


def unique_triangle(t_L, tol=0.0):
    """Compress to the canonical unique entries: returns (indices (n, 6),
    values) keeping, for each orbit of the 6 pair-permutation images, the
    lexicographically smallest index (bra/ket flips are NOT applied — they
    are only a symmetry for real orbitals; matches the TCDUMP writer's
    dedup rule in spirit)."""
    nz = np.nonzero(np.abs(t_L) > tol)
    idx = np.stack(nz, axis=1)
    vals = t_L[nz]
    # canonical representative over the 6 pair permutations
    cands = []
    for per in itertools.permutations(range(3)):
        cols = []
        for p in per:
            cols.extend(_PAIRS[p])
        cands.append(idx[:, cols])
    cands = np.stack(cands, axis=1)           # (n, 6perm, 6)
    # lexicographic minimum over the 6 permutation images
    best = cands[:, 0, :]
    for k in range(1, 6):
        cand = cands[:, k, :]
        smaller = np.zeros(len(idx), dtype=bool)
        decided = np.zeros(len(idx), dtype=bool)
        for col in range(6):
            lt = (cand[:, col] < best[:, col]) & ~decided
            gt = (cand[:, col] > best[:, col]) & ~decided
            smaller |= lt
            decided |= lt | gt
        best = np.where(smaller[:, None], cand, best)
    uniq, first = np.unique(best, axis=0, return_index=True)
    return uniq, vals[first]


def global_ind_2_list_inds(global_ind, shape):
    """Decompose a flat index into per-axis indices (row-major; working
    version of ``contraction.py:124``)."""
    out = []
    for n in range(len(shape) - 1, -1, -1):
        out.append(int(global_ind % shape[n]))
        global_ind //= shape[n]
    return out[::-1]


def list_inds_2_global_ind(list_inds, shape):
    """Flat row-major index of per-axis indices (fixes the reference's
    broken accumulation at ``contraction.py:147-167``)."""
    g = 0
    for i, n in zip(list_inds, shape):
        g = g * n + int(i)
    return g


def recover_L(indices, values, nb):
    """Rebuild the full dense L from unique entries by scattering all 6
    pair-permutation images (working replacement for the reference's
    unfinished ``recover_L``, ``contraction.py:98``)."""
    t_L = np.zeros([nb] * 6)
    idx = np.asarray(indices)
    for per in itertools.permutations(range(3)):
        cols = []
        for p in per:
            cols.extend(_PAIRS[p])
        img = idx[:, cols]
        t_L[img[:, 0], img[:, 1], img[:, 2], img[:, 3], img[:, 4],
            img[:, 5]] = values
    return t_L
