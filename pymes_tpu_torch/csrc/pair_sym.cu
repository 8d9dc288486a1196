// K5: the P(ab,ij) pair symmetrisation (sm_90a), f64, and f32 for the
// sigma of the FEAST/RT mixed-precision engine: the kernels are templates
// on the element type T, and a tile is sized in bytes (below), so an f32
// tile holds as many or more pairs in the same shared memory.
//
// Replaces the tail of B2 in the JAX package, the R + Ex + Ex^T of
// pymes_tpu/solver/ccd.py:232-350 (doubles_residual_ij), which is also the
// d + P(d) of the EOM doubles sigma (pymes_tpu/solver/eom_ccsd.py:351-352):
//
//   out[n, p, q, r, s] = (Y[n, p, q, r, s] + X[n, p, q, r, s]) + X[n, q, p, s, r]
//
// over a leading batch n, with Y optional, in both layouts: ijab (p, q
// occupied, r, s virtual; the CCD/CCSD residual) and abij (p, q virtual,
// r, s occupied; the EOM sigma).  The sum is taken in the plain version's
// order, so kernel and plain version agree bit for bit.
//
// What bounds it on an H100: device-memory bandwidth.  Every element of X
// (and Y) must be read once and every output written once, with no
// arithmetic to speak of: at the EOM sigma's batch of 2 at nP=219 that is
// 70.5 MB, 0.021 ms at 3.35 TB/s.  Output (p, q) needs chunk X[q, p]
// transposed and output (q, p) needs chunk X[p, q] transposed, so a unit
// of work owns the PAIR of chunks (p, q) and (q, p), p <= q (the diagonal
// p == q is one chunk): it reads both once, coalesced, transposes them
// through shared memory and writes both outputs.  X crosses HBM once.
//
// * R <= 16 (abij: a chunk is R x R = 49 contiguous doubles at no = 7):
//   one chunk is too small a read, so a block owns a TP x TP tile of
//   chunks (p, q) and its mirror tile (q, p) (TP = 4 at R = 7): each tile
//   row is TP contiguous chunks (1568 bytes), read whole, and so is each
//   row written.  R is a template parameter, so the transposed index of
//   an element is computed with constant divisors.
// * R > 16 (ijab: r, s run over nv): a block owns a 32 x 32 tile (rt, st)
//   of chunk (p, q) and the partner tile (st, rt) of chunk (q, p); on the
//   diagonal only the tiles with rt <= st.  Every load (both tiles, both
//   Y tiles) is issued before the first use, and offsets come from the
//   tile loops, with no division by R per element.

#include <cuda_runtime.h>

namespace {

constexpr int STHREADS = 128;          // threads of a block, R <= 16
constexpr int TILE = 32;               // tile edge, R > 16
constexpr int ROWS = 4;                // thread rows of a tile block

// Unit u -> the pair (p, q), p <= q, of a P x P triangle, or p = -1 for a
// hole: the upper triangle folded into ceil(P/2) rows of P + 1 units (row
// h holds the pairs of row h and of row P - 1 - h)
__device__ __forceinline__ void pair_of(int rem, int P, int& p, int& q)
{
    const int h = rem / (P + 1), c = rem - h * (P + 1);
    if (c < P - h) {
        p = h;
        q = h + c;
    } else {
        p = P - 1 - h;
        q = p + c - (P - h);
        if (p <= h) p = -1;            // the middle row of an odd P
    }
}

// Chunk tiles of the small-R program: TP x TP chunks (p, q), TP the
// largest power of two <= 32 with TP x TP x R x R elements in TILE_BYTES
// (for doubles: 1024 elements, TP = 4 at R = 7, a tile row TP contiguous
// chunks of 1568 bytes; for floats TP = 4 too at R = 7, 784 bytes a row)
constexpr int TILE_BYTES = 8192;

constexpr int tile_pairs(int ch, int elem, int tp = 32)
{
    return tp > 1 && tp * tp * ch * elem > TILE_BYTES
        ? tile_pairs(ch, elem, tp / 2) : tp;
}

template <typename T, int R>
struct Small {
    static constexpr int CH = R * R;
    static constexpr int TP = tile_pairs(CH, sizeof(T));
    static constexpr int SEG = TP * CH;         // elements of a tile row
    static constexpr int EL = TP * SEG;         // elements of a tile
    static constexpr int PER = (EL + STHREADS - 1) / STHREADS;
};

template <typename T, int R, bool HAS_Y>
__global__ void __launch_bounds__(STHREADS)
pair_sym_small(const T* __restrict__ X, const T* __restrict__ Y,
               T* __restrict__ out, int P, int nTP)
{
    using G = Small<T, R>;
    constexpr int CH = G::CH, SEG = G::SEG, EL = G::EL, PER = G::PER;
    __shared__ T sa[EL], sb[EL];
    int a, b;
    pair_of(blockIdx.x, nTP, a, b);
    if (a < 0) return;
    const bool diag = a == b;
    // tile A: chunks (pa + i, qb + j); tile B: chunks (qb + i, pa + j)
    const int pa = a * G::TP, qb = b * G::TP;
    const int na = min(G::TP, P - pa), nq = min(G::TP, P - qb);
    const long long base = static_cast<long long>(blockIdx.y) * P * P * CH;
    const long long oa = base + (static_cast<long long>(pa) * P + qb) * CH;
    const long long ob = base + (static_cast<long long>(qb) * P + pa) * CH;
    const long long row = static_cast<long long>(P) * CH;
    T xa[PER], xb[PER], ya[PER], yb[PER];
    bool va[PER], vb[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
        const int f = threadIdx.x + STHREADS * k;
        const int i = f / SEG, c = f - i * SEG, j = c / CH;
        va[k] = f < EL && i < na && j < nq;
        vb[k] = !diag && f < EL && i < nq && j < na;
        if (va[k]) {
            xa[k] = X[oa + i * row + c];
            if (HAS_Y) ya[k] = Y[oa + i * row + c];
        }
        if (vb[k]) {
            xb[k] = X[ob + i * row + c];
            if (HAS_Y) yb[k] = Y[ob + i * row + c];
        }
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
        const int f = threadIdx.x + STHREADS * k;
        if (va[k]) sa[f] = xa[k];
        if (vb[k]) sb[f] = xb[k];
    }
    __syncthreads();
    const T* pb = diag ? sa : sb;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
        const int f = threadIdx.x + STHREADS * k;
        const int i = f / SEG, c = f - i * SEG, j = c / CH, e = c - j * CH;
        // the partner of element e of chunk (row i, column j) of one tile
        // is element (s, r) of chunk (row j, column i) of the other
        const int t = j * SEG + i * CH + (e % R) * R + e / R;
        if (va[k])
            out[oa + i * row + c] = (HAS_Y ? ya[k] + xa[k] : xa[k]) + pb[t];
        if (vb[k])
            out[ob + i * row + c] = (HAS_Y ? yb[k] + xb[k] : xb[k]) + sa[t];
    }
}

template <typename T, bool HAS_Y>
__global__ void __launch_bounds__(TILE * ROWS)
pair_sym_tiled(const T* __restrict__ X, const T* __restrict__ Y,
               T* __restrict__ out, int P, int R, int nT)
{
    constexpr int PER = TILE / ROWS;
    __shared__ T t1[TILE][TILE + 1], t2[TILE][TILE + 1];
    // blockIdx.y: the pair (p, q), p <= q, in row order of the upper
    // triangle (P is the occupied count here, so the walk is short)
    int pi = blockIdx.y, p = 0;
    while (pi >= P - p) {
        pi -= P - p;
        ++p;
    }
    const int q = p + pi;
    const int rt = blockIdx.x / nT, st = blockIdx.x - rt * nT;
    if (p == q && rt > st) return;
    const bool second = !(p == q && rt == st);
    const long long RR = static_cast<long long>(R) * R;
    const long long base = static_cast<long long>(blockIdx.z) * P * P * RR;
    const long long o1 = base + (static_cast<long long>(p) * P + q) * RR;
    const long long o2 = base + (static_cast<long long>(q) * P + p) * RR;
    const int tx = threadIdx.x % TILE, ty = threadIdx.x / TILE;
    const int r0 = rt * TILE, s0 = st * TILE;
    // tile 1: chunk (p, q) rows r0.., columns s0..; tile 2: chunk (q, p)
    // rows s0.., columns r0.. (the transposed partner); every load issued
    // before the first use
    T x1[PER], x2[PER], y1[PER], y2[PER];
    bool v1[PER], v2[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
        const int i = ty + ROWS * k;
        v1[k] = r0 + i < R && s0 + tx < R;
        v2[k] = second && s0 + i < R && r0 + tx < R;
        const long long e1 = o1 + static_cast<long long>(r0 + i) * R + s0 + tx;
        const long long e2 = o2 + static_cast<long long>(s0 + i) * R + r0 + tx;
        if (v1[k]) {
            x1[k] = X[e1];
            if (HAS_Y) y1[k] = Y[e1];
        }
        if (v2[k]) {
            x2[k] = X[e2];
            if (HAS_Y) y2[k] = Y[e2];
        }
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
        const int i = ty + ROWS * k;
        if (v1[k]) t1[i][tx] = x1[k];
        if (v2[k]) t2[i][tx] = x2[k];
    }
    __syncthreads();
    const T (*u2)[TILE + 1] = second ? t2 : t1;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
        const int i = ty + ROWS * k;
        if (v1[k])
            out[o1 + static_cast<long long>(r0 + i) * R + s0 + tx] =
                (HAS_Y ? y1[k] + x1[k] : x1[k]) + u2[tx][i];
        if (v2[k])
            out[o2 + static_cast<long long>(s0 + i) * R + r0 + tx] =
                (HAS_Y ? y2[k] + x2[k] : x2[k]) + t1[tx][i];
    }
}

template <typename T, int R>
cudaError_t launch_small(const T* X, const T* Y, T* out, int nb, int P,
                         cudaStream_t stream)
{
    const int nTP = (P + Small<T, R>::TP - 1) / Small<T, R>::TP;
    const dim3 grid((nTP + 1) / 2 * (nTP + 1), nb);
    if (Y)
        pair_sym_small<T, R, true><<<grid, STHREADS, 0, stream>>>(
            X, Y, out, P, nTP);
    else
        pair_sym_small<T, R, false><<<grid, STHREADS, 0, stream>>>(
            X, Y, out, P, nTP);
    return cudaGetLastError();
}

template <typename T>
int pair_sym(const T* X, const T* Y, T* out, int nb, int P, int R,
             cudaStream_t stream)
{
    if (nb <= 0 || P <= 0 || R <= 0) return static_cast<int>(cudaSuccess);
    switch (R) {
        case 1: return launch_small<T, 1>(X, Y, out, nb, P, stream);
        case 2: return launch_small<T, 2>(X, Y, out, nb, P, stream);
        case 3: return launch_small<T, 3>(X, Y, out, nb, P, stream);
        case 4: return launch_small<T, 4>(X, Y, out, nb, P, stream);
        case 5: return launch_small<T, 5>(X, Y, out, nb, P, stream);
        case 6: return launch_small<T, 6>(X, Y, out, nb, P, stream);
        case 7: return launch_small<T, 7>(X, Y, out, nb, P, stream);
        case 8: return launch_small<T, 8>(X, Y, out, nb, P, stream);
        case 9: return launch_small<T, 9>(X, Y, out, nb, P, stream);
        case 10: return launch_small<T, 10>(X, Y, out, nb, P, stream);
        case 11: return launch_small<T, 11>(X, Y, out, nb, P, stream);
        case 12: return launch_small<T, 12>(X, Y, out, nb, P, stream);
        case 13: return launch_small<T, 13>(X, Y, out, nb, P, stream);
        case 14: return launch_small<T, 14>(X, Y, out, nb, P, stream);
        case 15: return launch_small<T, 15>(X, Y, out, nb, P, stream);
        case 16: return launch_small<T, 16>(X, Y, out, nb, P, stream);
        default: break;
    }
    const int nT = (R + TILE - 1) / TILE;
    const dim3 grid(nT * nT, P * (P + 1) / 2, nb);
    if (Y)
        pair_sym_tiled<T, true><<<grid, TILE * ROWS, 0, stream>>>(
            X, Y, out, P, R, nT);
    else
        pair_sym_tiled<T, false><<<grid, TILE * ROWS, 0, stream>>>(
            X, Y, out, P, R, nT);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out = (Y + X) + P(X) for X (nb, P, P, R, R) contiguous, Y of the same
// shape or null, on `stream`; returns the cudaError_t of the launch.
// Doubles (_f32: floats).
extern "C" int pymes_pair_sym(const double* X, const double* Y, double* out,
                              int nb, int P, int R, cudaStream_t stream)
{
    return pair_sym(X, Y, out, nb, P, R, stream);
}

extern "C" int pymes_pair_sym_f32(const float* X, const float* Y, float* out,
                                  int nb, int P, int R, cudaStream_t stream)
{
    return pair_sym(X, Y, out, nb, P, R, stream);
}
