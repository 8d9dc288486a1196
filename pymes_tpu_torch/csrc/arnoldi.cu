// K7: the CGS2 Arnoldi projection and the Krylov combines of the
// lane-batched GMRES (sm_90a), for a basis of doubles (the f64 FEAST/RT
// path) or of floats (the f32 Krylov solves of the mixed-precision engine,
// ls_precision="mixed").  Each type runs kernels of its own design.
//
// Replaces B6, the body of pymes_tpu/ops/gmres.py:87-131 `gmres` (the two
// CGS passes at :101-108, h = h1 + h2, the _BREAK guard at :69-73) and its
// Krylov combines, x = x0 + sum_i y_i V_i (:162) and the restart residual
// sum_i u_i V_i (:179), for La active lanes at once.  For lane a with m_a
// valid rows of its basis V[lanes[a]] (rows of length n):
//
//   pass 0:  h1 = V w                       (row dots)
//   pass 1:  w1 = w - V^T h1  (into w),  h2 = V w1
//   pass 2:  w2 = w1 - V^T h2 (into row m_a),  |w2|^2
//   scale:   row m_a *= 1/|w2| if |w2| > BREAK, else 0
//
// and H[a] = (h1 + h2, |w2|, 0, ...).  Exact CGS2: three dependent passes
// over the m_a valid rows, each needing the finished sums of the one
// before.
//
// Types: everything that is summed is double for either basis.  The row
// dots h1, h2, their block partials, the column sums of V^T h and of the
// combines, and |w2|^2 accumulate in double from the widened values, and
// the Hessenberg column H is written in double (the Givens work reads it
// on the host in f64).  So an f32 basis rounds only where a value is
// stored as float: w1 into w, w2 into row m_a, the scaled row, and the
// combines' outputs.  The JAX package's f32 GMRES (pymes_tpu/ops/gmres.py:
// 58-69) sums in f32; the guard BREAK is the caller's (1e-140 for f64,
// 1e-18 for f32, as there).  A rerun gives the same bits: every sum across
// blocks is taken in a fixed order, no atomics add values.
//
// What bounds it on an H100: bytes.  The once-read bound counts the m_a
// rows and w read once and the new row and w1 written; exact CGS2 reads the
// rows three times, and with the lanes' rows together far past the 50 MB L2
// the three reads come from HBM: the three-pass floor (util/roofline.py
// krylov_bounds, floor_ms).  At the FEAST nP=57 shape (64 lanes, m = 60,
// n = 245700) the floor is 6.95 ms in f64 and 3.47 ms in f32; the
// once-read bound 2.33 and 1.16 ms.  Each design aims at the floor.
//
// f64 (the anonymous namespace below): a block owns a column range of one
// lane, the grid (G, La) covers every lane in one wave: tiles of (m_a + 1)
// rows in 4 shared buffers of 24 KB filled by cp.async (3 in flight), a
// register pass at m_a <= 16, the partials of pass p summed in block order
// by every block of pass p+1, 4 launches a projection.  The combine
// streams the rows once through 3 buffers of 32 KB, one thread a column.
//
// f32 (namespace f32k):
// * One cooperative launch of one 201 KB block an SM (grid-wide waits
//   cannot deadlock) does the three passes and the scale.  The lanes' rows
//   laid end to end are cut into equal shares of columns, one a block
//   (arnoldi.f32_plan): every SM streams the same bytes, and a share may
//   end one lane and start the next.  A block takes its items pass by pass
//   (each item's pass p and ticket before any wait for pass p's sums), and
//   walks them forward in pass 0, backward in pass 1 and forward in pass 2,
//   so each pass starts on what the L2 holds of the one before.  A block
//   reads back only the w1 and the row that it wrote itself.
// * Taking the lanes a few at a time, sized to the L2, so that passes 1
//   and 2 would read from it, lost on this card: every lane group pays
//   three meetings of all the blocks, about as long as a pass over a lane,
//   and saved too little (1.7x this design's time at FEAST m = 60 on an
//   H100 80GB HBM3, tools/time_f32.py; PERF.md).  In one wave a lane meets
//   its 2-6 blocks three times a call.
// * A lane's meeting: each block writes its partials and takes a ticket;
//   the last block sums the partials (coalesced loads, a fixed order) and
//   raises the lane's flag.  Before waiting on the flag a block issues the
//   next pass's first tiles (V does not depend on h).
// * Tiles of (m_a rows and w) x 1024/G columns through a ring of up to 8
//   buffers (192 KB) filled by 16-byte cp.async: G threads own a quad of 4
//   columns (16-byte shared reads), each every G-th row, G = 1, 2, 4, 8 so
//   that a thread holds at most 16 rows.  A column's sum of V^T h meets in a
//   butterfly of warp shuffles, so a tile costs one barrier.  Passes 0 and
//   2 widen each element to double once; pass 1 twice (keeping 64 doubles
//   a thread for the row dots would spill).  The kernel takes each lane's G
//   from its m on the card, so the plan needs no host copy of m.
// * Offsets are 64-bit (the FEAST basis is 1.90e9 floats).
// * The f32 combine streams the rows once, with no staging: 4 columns a
//   thread, 8 rows' 16-byte loads in flight, 16-byte stores of x and r,
//   each a sum over i in order.

#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int RPW = 16;                       // rows a warp owns at most
constexpr int MAX_ROWS = NWARPS * RPW;        // 128
// tile buffers, in bytes: the projection keeps 3 of 4 buffers of 24 KB in
// flight, the combine 2 of 3 of 32 KB (sizes chosen by timing variants on
// an H100, f64)
constexpr int PROJ_BYTES = 3072 * 8, PROJ_NBUF = 4;
constexpr int COMB_BYTES = 4096 * 8, COMB_NBUF = 3;

// the buffers, the h / partial doubles, one full mbarrier a buffer
template <int TB, int NB>
constexpr size_t smem_bytes()
{
    return static_cast<size_t>(NB) * TB
        + sizeof(double) * (2 * MAX_ROWS + NWARPS) + NB * sizeof(uint64_t);
}

static_assert(MAX_ROWS * 16 * 8 <= PROJ_BYTES
                  && MAX_ROWS * 16 * 8 <= COMB_BYTES,
              "16 columns of every row fit");

// columns of a tile of `rows` rows: a multiple of 16 that fits TD elements
template <int TD>
__device__ __forceinline__ int tile_cols(int rows)
{
    return TD / max(rows, 1) / 16 * 16;
}

// columns of the tile that starts `rest` columns before the range's end
__device__ __forceinline__ int cols_left(int C, long long rest)
{
    return rest < C ? static_cast<int>(rest) : C;
}

template <typename T>
struct Lane {
    T* V;                // the lane's basis rows
    int mm;              // valid rows
    long long cb, ce;    // the block's column range
};

template <typename T>
__device__ __forceinline__ Lane<T> lane_of(T* V, const long long* lanes,
                                           const long long* m, long long n,
                                           long long stride_lane,
                                           long long span)
{
    const long long cb = static_cast<long long>(blockIdx.x) * span;
    return {V + lanes[blockIdx.y] * stride_lane,
            static_cast<int>(m[blockIdx.y]), cb, min(n, cb + span)};
}

// every row segment of a block starts 16-byte aligned: the rows (n), the
// block's first column (cb) and the pointers
template <typename T>
__device__ __forceinline__ bool rows_aligned(const T* a, const T* b,
                                             long long n, long long cb)
{
    constexpr int VEC = 16 / sizeof(T);
    return pymes::aligned16(a) && pymes::aligned16(b) && n % VEC == 0
        && cb % VEC == 0;
}

// The tiles of one block: (nv rows of Vl, and wrow as row nv when it is
// not null) x C columns, walking the block's range [cb, ce) of rows of
// length n, through NBUF shared buffers of TD elements with one full
// mbarrier each.
template <typename T, int TD, int NBUF>
struct Tiles {
    T* smem; uint64_t* full;
    const T* Vl; const T* wrow;
    long long n, cb, ce;
    int nv, C, count;
    bool aligned;       // every row segment 16-byte aligned

    __device__ Tiles(T* smem_, uint64_t* full_, const T* Vl_, int nv_,
                     const T* wrow_, long long n_, long long cb_,
                     long long ce_, int C_, bool aligned_)
        : smem(smem_), full(full_), Vl(Vl_), wrow(wrow_), n(n_), cb(cb_),
          ce(ce_), nv(nv_), C(C_), aligned(aligned_)
    {
        count = ce > cb ? static_cast<int>((ce - cb + C - 1) / C) : 0;
        if (threadIdx.x == 0)
            for (int b = 0; b < NBUF; ++b)
                pymes::mbar_init(&full[b], NTHREADS);
    }

    __device__ T* buf(int t) const { return smem + (t % NBUF) * TD; }
    __device__ long long c0(int t) const
    {
        return cb + static_cast<long long>(t) * C;
    }
    __device__ int cols(int t) const { return cols_left(C, ce - c0(t)); }

    // all threads: start the copies of tile t (when it exists), 16 bytes
    // a copy where the rows are 16-byte aligned
    __device__ void issue(int t) const
    {
        if (t >= count) return;
        constexpr int VEC = 16 / sizeof(T);
        const int rows = nv + (wrow != nullptr), cv = cols(t);
        const long long col = c0(t);
        T* dst = buf(t);
        // element e = threadIdx.x + k*NTHREADS of the (rows, cw) copy grid
        // walks (i, c) by a fixed stride, without a division per copy
        const bool wide = aligned && cv % VEC == 0;
        const int cw = wide ? cv / VEC : cv, total = rows * cw;
        const int di = NTHREADS / cw, dc = NTHREADS % cw;
        int i = threadIdx.x / cw, c = threadIdx.x % cw;
        for (int e = threadIdx.x; e < total; e += NTHREADS) {
            const T* src = (i < nv ? Vl + i * n : wrow) + col;
            if (wide) pymes::cp_async16(dst + i * C + VEC * c, src + VEC * c);
            else pymes::cp_async_elem(dst + i * C + c, src + c);
            i += di;
            c += dc;
            if (c >= cw) {
                c -= cw;
                ++i;
            }
        }
        pymes::cp_async_arrive_noinc(&full[t % NBUF]);
    }

    // all threads: wait for tile t; the buffer it refills was released by
    // the __syncthreads that ended tile t - 1
    __device__ T* wait(int t) const
    {
        pymes::mbar_wait(&full[t % NBUF], (t / NBUF) & 1);
        return buf(t);
    }
};

__device__ __forceinline__ double warp_sum(double x)
{
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

template <typename T>
struct PassArgs {
    T* V; T* w; const long long* lanes; const long long* m;
    double* P;           // (3, La, G, MAX_ROWS) partials of each pass
    double* h1;          // (La, MAX_ROWS)
    double* H;           // (La, R1) Hessenberg columns
    long long n, stride_lane, span;
    int R1, G, La;
};

template <typename T>
__device__ __forceinline__ double* partial(const PassArgs<T>& p, int pass,
                                           int a, int g)
{
    return p.P + ((static_cast<long long>(pass) * p.La + a) * p.G + g)
        * MAX_ROWS;
}

// Block reduction of the per-thread row partials acc[i], i < mm <= RPW
// (red: NWARPS*RPW doubles of shared memory): a butterfly in each warp,
// then the warps in order; thread i writes row i's partial to out.
__device__ __forceinline__ void reduce_rows(const double (&acc)[RPW], int mm,
                                            double* red, double* out)
{
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
        if (i >= mm) break;
        const double s = warp_sum(acc[i]);
        if (lane == 0) red[warp * RPW + i] = s;
    }
    __syncthreads();
    if (threadIdx.x < mm) {
        double tot = 0.0;
        for (int k = 0; k < NWARPS; ++k) tot += red[k * RPW + threadIdx.x];
        out[threadIdx.x] = tot;
    }
}

// Block sum of one value a thread, in a fixed order, by thread 0.
__device__ __forceinline__ double block_sum(double x, double* red)
{
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const double s = warp_sum(x);
    if (lane == 0) red[warp] = s;
    __syncthreads();
    double tot = 0.0;
    if (threadIdx.x == 0)
        for (int k = 0; k < NWARPS; ++k) tot += red[k];
    return tot;
}

// A pass for m_a <= RPW rows, without staging: a thread takes columns
// cb + tid, cb + tid + NTHREADS, ... two at a time, holds their m_a
// values in registers (coalesced loads, 2 (m_a + 1) of them in flight a
// thread), and keeps every row's partial in registers.  Each value is
// still read from HBM once; there is no tile, no barrier per tile, and
// more loads in flight than the tiles keep at small m_a.
template <typename T, int PASS>
__device__ void register_pass(const PassArgs<T>& p, const Lane<T>& L, T* wa,
                              const double* hs, double* red, double* out)
{
    const int mm = L.mm;
    double acc[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) acc[i] = 0.0;
    double nacc = 0.0;
    for (long long c0 = L.cb + threadIdx.x; c0 < L.ce;
         c0 += 2 * NTHREADS) {
        T v[2][RPW];
        double x[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            const long long c = c0 + u * NTHREADS;
            const bool ok = c < L.ce;
#pragma unroll
            for (int i = 0; i < RPW; ++i)
                v[u][i] = ok && i < mm ? __ldg(L.V + i * p.n + c) : T(0);
            x[u] = ok ? static_cast<double>(wa[c]) : 0.0;
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            const long long c = c0 + u * NTHREADS;
            if (PASS > 0) {
                double s = 0.0;
#pragma unroll
                for (int i = 0; i < RPW; ++i)
                    if (i < mm) s = fma(hs[i], static_cast<double>(v[u][i]),
                                        s);
                x[u] -= s;
                if (PASS == 1) {
                    // w1 as stored: pass 1's row dots read what pass 2 will
                    x[u] = static_cast<double>(static_cast<T>(x[u]));
                    if (c < L.ce) wa[c] = static_cast<T>(x[u]);
                } else if (c < L.ce) {
                    L.V[mm * p.n + c] = static_cast<T>(x[u]);
                }
                if (PASS == 2) nacc = fma(x[u], x[u], nacc);
            }
            if (PASS < 2) {
#pragma unroll
                for (int i = 0; i < RPW; ++i)
                    if (i < mm)
                        acc[i] = fma(static_cast<double>(v[u][i]), x[u],
                                     acc[i]);
            }
        }
    }
    if (PASS < 2) {
        reduce_rows(acc, mm, red, out);
    } else {
        const double tot = block_sum(nacc, red);
        if (threadIdx.x == 0) out[0] = tot;
    }
}

template <typename T, int PASS>
__global__ void __launch_bounds__(NTHREADS, 2) arnoldi_pass(PassArgs<T> p)
{
    extern __shared__ __align__(128) unsigned char smem[];
    constexpr int NBUF = PROJ_NBUF, TD = PROJ_BYTES / sizeof(T);
    double* hs = reinterpret_cast<double*>(smem + NBUF * PROJ_BYTES);
    double* red = hs + 2 * MAX_ROWS;             // per-warp norm partials
    uint64_t* full = reinterpret_cast<uint64_t*>(red + NWARPS);
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int a = blockIdx.y, g = blockIdx.x;
    const Lane<T> L = lane_of(p.V, p.lanes, p.m, p.n, p.stride_lane, p.span);
    const int mm = L.mm;
    T* wa = p.w + a * p.n;
    const Tiles<T, TD, NBUF> tiles(
        reinterpret_cast<T*>(smem), full, L.V, mm, wa, p.n, L.cb, L.ce,
        tile_cols<TD>(mm + 1), rows_aligned(L.V, wa, p.n, L.cb));
    if (PASS > 0) {
        // h of the pass before: its block partials summed in block order
        for (int i = tid; i < mm; i += NTHREADS) {
            double s = 0.0;
            for (int b = 0; b < p.G; ++b) s += partial(p, PASS - 1, a, b)[i];
            hs[i] = s;
            if (g == 0) {
                if (PASS == 1) p.h1[a * MAX_ROWS + i] = s;
                else p.H[static_cast<long long>(a) * p.R1 + i] =
                    p.h1[a * MAX_ROWS + i] + s;
            }
        }
    }
    __syncthreads();
    if (mm <= RPW) {
        // a uniform branch: the whole block takes it
        register_pass<T, PASS>(p, L, wa, hs, hs + MAX_ROWS,
                               partial(p, PASS, a, g));
        return;
    }
    for (int t = 0; t < NBUF - 1; ++t) tiles.issue(t);

    // rows warp, warp + 8, ... of this warp: nr of them are valid
    const int nr = mm > warp ? (mm - warp + NWARPS - 1) / NWARPS : 0;
    const int C = tiles.C;
    double acc[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) acc[r] = 0.0;
    double nacc = 0.0;

    for (int t = 0; t < tiles.count; ++t) {
        tiles.issue(t + NBUF - 1);
        T* tile = tiles.wait(t);
        T* wrow = tile + mm * C;
        const long long c0 = tiles.c0(t);
        const int cv = tiles.cols(t);
        if (PASS > 0) {
            // column combine: w - V^T h, one thread a column, rows in order
            for (int c = tid; c < cv; c += NTHREADS) {
                double s = 0.0;
                for (int i = 0; i < mm; ++i)
                    s = fma(hs[i], static_cast<double>(tile[i * C + c]), s);
                const double x = static_cast<double>(wrow[c]) - s;
                if (PASS == 1) {
                    wrow[c] = static_cast<T>(x);
                    wa[c0 + c] = static_cast<T>(x);
                } else {
                    L.V[mm * p.n + c0 + c] = static_cast<T>(x);
                    nacc = fma(x, x, nacc);
                }
            }
            if (PASS == 1) __syncthreads();
        }
        if (PASS < 2) {
            // row dots with the tile's w row
            for (int c = lane; c < cv; c += 32) {
                const double x = static_cast<double>(wrow[c]);
#pragma unroll
                for (int r = 0; r < RPW; ++r)
                    if (r < nr)
                        acc[r] = fma(static_cast<double>(
                                         tile[(warp + NWARPS * r) * C + c]),
                                     x, acc[r]);
            }
        }
        __syncthreads();
    }

    if (PASS < 2) {
        double* out = partial(p, PASS, a, g);
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
            if (r >= nr) break;
            const double s = warp_sum(acc[r]);
            if (lane == 0) out[warp + NWARPS * r] = s;
        }
    } else {
        const double tot = block_sum(nacc, red);
        if (tid == 0) partial(p, 2, a, g)[0] = tot;
    }
}

// row m_a *= 1/max(|w2|, brk) where |w2| > brk, else 0; H[a, m_a] = |w2|
// and H[a, i] = 0 past it.  Block (x, a) scales SCALE_COLS columns of lane
// a's row, SCALE_COLS / NTHREADS a thread with their loads in flight
// together.
constexpr int SCALE_COLS = 8 * NTHREADS;

template <typename T>
__global__ void __launch_bounds__(NTHREADS) arnoldi_scale(PassArgs<T> p,
                                                          double brk)
{
    const int a = blockIdx.y;
    const int mm = static_cast<int>(p.m[a]);
    double s = 0.0;
    for (int b = 0; b < p.G; ++b) s += partial(p, 2, a, b)[0];
    const double nrm = sqrt(s);
    const double scale = nrm > brk ? 1.0 / fmax(nrm, brk) : 0.0;
    T* row = p.V + p.lanes[a] * p.stride_lane + mm * p.n;
    const long long c0 = static_cast<long long>(blockIdx.x) * SCALE_COLS
        + threadIdx.x;
    T v[SCALE_COLS / NTHREADS];
#pragma unroll
    for (int k = 0; k < SCALE_COLS / NTHREADS; ++k) {
        const long long c = c0 + k * NTHREADS;
        v[k] = c < p.n ? row[c] : T(0);
    }
#pragma unroll
    for (int k = 0; k < SCALE_COLS / NTHREADS; ++k) {
        const long long c = c0 + k * NTHREADS;
        if (c < p.n) row[c] = static_cast<T>(scale * v[k]);
    }
    if (blockIdx.x == 0)
        for (int i = mm + threadIdx.x; i < p.R1; i += NTHREADS)
            p.H[static_cast<long long>(a) * p.R1 + i] = i == mm ? nrm : 0.0;
}

template <typename T>
struct CombineArgs {
    T* V; const long long* lanes; const long long* m;
    const double* C;     // (La, NOUT, ldc) coefficients
    const T* x0;         // (La, n) or null: added to output 0
    T* out0; T* out1;
    long long n, stride_lane, span;
    int ldc;
};

template <typename T, int NOUT>
__global__ void __launch_bounds__(NTHREADS, 2)
krylov_combine(CombineArgs<T> p)
{
    extern __shared__ __align__(128) unsigned char smem[];
    constexpr int NBUF = COMB_NBUF, TD = COMB_BYTES / sizeof(T);
    double* cs = reinterpret_cast<double*>(smem + NBUF * COMB_BYTES);
    uint64_t* full = reinterpret_cast<uint64_t*>(cs + 2 * MAX_ROWS
                                                 + NWARPS);
    const int tid = threadIdx.x, a = blockIdx.y;
    const Lane<T> L = lane_of(p.V, p.lanes, p.m, p.n, p.stride_lane, p.span);
    const int mm = L.mm;
    const Tiles<T, TD, NBUF> tiles(reinterpret_cast<T*>(smem), full, L.V, mm,
                                   nullptr, p.n, L.cb, L.ce,
                                   tile_cols<TD>(mm),
                                   rows_aligned(L.V, L.V, p.n, L.cb));
    for (int i = tid; i < mm; i += NTHREADS)
#pragma unroll
        for (int o = 0; o < NOUT; ++o)
            cs[o * MAX_ROWS + i] =
                p.C[(static_cast<long long>(a) * NOUT + o) * p.ldc + i];
    __syncthreads();
    for (int t = 0; t < NBUF - 1; ++t) tiles.issue(t);

    const int C = tiles.C;
    const long long base = a * p.n;
    for (int t = 0; t < tiles.count; ++t) {
        tiles.issue(t + NBUF - 1);
        const T* tile = tiles.wait(t);
        const long long c0 = tiles.c0(t);
        const int cv = tiles.cols(t);
        for (int c = tid; c < cv; c += NTHREADS) {
            double s0 = 0.0, s1 = 0.0;
            for (int i = 0; i < mm; ++i) {
                const double v = static_cast<double>(tile[i * C + c]);
                s0 = fma(cs[i], v, s0);
                if (NOUT == 2) s1 = fma(cs[MAX_ROWS + i], v, s1);
            }
            p.out0[base + c0 + c] = static_cast<T>(
                p.x0 ? static_cast<double>(p.x0[base + c0 + c]) + s0 : s0);
            if (NOUT == 2) p.out1[base + c0 + c] = static_cast<T>(s1);
        }
        __syncthreads();
    }
}

constexpr size_t PROJ_SMEM = smem_bytes<PROJ_BYTES, PROJ_NBUF>();
constexpr size_t COMB_SMEM = smem_bytes<COMB_BYTES, COMB_NBUF>();

template <typename A>
cudaError_t launch(void (*kernel)(A), size_t smem, dim3 grid,
                   cudaStream_t stream, const A& args)
{
    // set on every launch: the attribute belongs to the current device
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kernel<<<grid, NTHREADS, smem, stream>>>(args);
    return cudaGetLastError();
}

template <typename T>
int pass_entry(int pass, T* V, T* w, const long long* lanes,
               const long long* m, double* P, double* h1, double* H,
               long long n, long long stride_lane, int R1, long long span,
               int G, int La, cudaStream_t stream)
{
    if (La <= 0) return static_cast<int>(cudaSuccess);
    const PassArgs<T> p{V, w, lanes, m, P, h1, H, n, stride_lane, span, R1,
                        G, La};
    const dim3 grid(G, La);
    cudaError_t err = cudaErrorInvalidValue;
    switch (pass) {
        case 0: err = launch(arnoldi_pass<T, 0>, PROJ_SMEM, grid, stream, p);
            break;
        case 1: err = launch(arnoldi_pass<T, 1>, PROJ_SMEM, grid, stream, p);
            break;
        case 2: err = launch(arnoldi_pass<T, 2>, PROJ_SMEM, grid, stream, p);
            break;
        default: break;
    }
    return static_cast<int>(err);
}

template <typename T>
int scale_entry(T* V, const long long* lanes, const long long* m, double* P,
                double* H, long long n, long long stride_lane, int R1,
                long long span, int G, int La, double brk,
                cudaStream_t stream)
{
    if (La <= 0) return static_cast<int>(cudaSuccess);
    const PassArgs<T> p{V, nullptr, lanes, m, P, nullptr, H, n, stride_lane,
                        span, R1, G, La};
    const dim3 grid(static_cast<unsigned>((n + SCALE_COLS - 1) / SCALE_COLS),
                    La);
    arnoldi_scale<T><<<grid, NTHREADS, 0, stream>>>(p, brk);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int combine_entry(T* V, const long long* lanes, const long long* m,
                  const double* C, int nout, const T* x0, T* out0, T* out1,
                  long long n, long long stride_lane, int ldc, long long span,
                  int G, int La, cudaStream_t stream)
{
    if (La <= 0) return static_cast<int>(cudaSuccess);
    const CombineArgs<T> p{V, lanes, m, C, x0, out0, out1, n, stride_lane,
                           span, ldc};
    const dim3 grid(G, La);
    if (nout == 1)
        return static_cast<int>(
            launch(krylov_combine<T, 1>, COMB_SMEM, grid, stream, p));
    if (nout == 2)
        return static_cast<int>(
            launch(krylov_combine<T, 2>, COMB_SMEM, grid, stream, p));
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// One pass (0, 1 or 2) of the CGS2 projection over the La active lanes of
// an f64 basis, G column ranges of `span` columns a lane; returns the
// cudaError_t.  P, h1 and H are doubles.
extern "C" int pymes_arnoldi_pass(int pass, double* V, double* w,
                                  const long long* lanes, const long long* m,
                                  double* P, double* h1, double* H,
                                  long long n, long long stride_lane, int R1,
                                  long long span, int G, int La,
                                  cudaStream_t stream)
{
    return pass_entry(pass, V, w, lanes, m, P, h1, H, n, stride_lane, R1,
                      span, G, La, stream);
}

// The guarded scale of row m_a and the Hessenberg rows m_a.. (after pass 2).
extern "C" int pymes_arnoldi_scale(double* V, const long long* lanes,
                                   const long long* m, double* P, double* H,
                                   long long n, long long stride_lane, int R1,
                                   long long span, int G, int La, double brk,
                                   cudaStream_t stream)
{
    return scale_entry(V, lanes, m, P, H, n, stride_lane, R1, span, G, La,
                       brk, stream);
}

// out0 = x0 + sum_i C[a, 0, i] V_i (x0 may be null) and, with nout = 2,
// out1 = sum_i C[a, 1, i] V_i, over the m_a valid rows of each lane of an
// f64 basis.
extern "C" int pymes_krylov_combine(double* V, const long long* lanes,
                                    const long long* m, const double* C,
                                    int nout, const double* x0, double* out0,
                                    double* out1, long long n,
                                    long long stride_lane, int ldc,
                                    long long span, int G, int La,
                                    cudaStream_t stream)
{
    return combine_entry(V, lanes, m, C, nout, x0, out0, out1, n,
                         stride_lane, ldc, span, G, La, stream);
}

// ---- f32: the projection in one cooperative launch, and the streaming
// combine

namespace f32k {

constexpr int NT = 256;                   // threads a block, one block an SM
constexpr int NW = NT / 32;
constexpr int RPW = 16;                   // rows a thread holds at most
constexpr int MAX_ROWS = NW * RPW;        // 128
constexpr int RING_FLOATS = 48 * 1024;    // the tile ring, 192 KB
constexpr int MAX_BUF = 8;
constexpr long long STEP = 4 * NT;        // columns 4 a thread
constexpr int CROWS = 8;                  // combine: rows' loads in flight

// the ring, h, the warps' row partials, the mbarriers and the
// last-ticket word
constexpr size_t SMEM = sizeof(float) * RING_FLOATS
    + sizeof(double) * (MAX_ROWS + NW * MAX_ROWS)
    + sizeof(uint64_t) * MAX_BUF + 16;
static_assert(SMEM <= 227 * 1024, "one block an SM");

struct Args {
    float* V; float* w; const long long* lanes; const long long* m;
    long long share;     // columns of the lanes' concatenated rows a block
    double* P;           // (3, La, maxg, pst) block partials of each pass
    double* S;           // (La, 3, MAX_ROWS) lane sums: h1, h2, |w2|^2
    double* H;           // (La, R1) Hessenberg columns
    unsigned* sync;      // (3, La) tickets, then (3, La) flags
    long long n, stride_lane;
    int R1, La, maxg, pst;
    double brk;
};

// A block's work in one lane: a column range.
struct Item {
    float* Vl; float* wa;        // the lane's rows and its w
    int a, j, nblk, mm;          // active lane, block of the lane, the lane's
                                 // blocks, valid rows
    long long cb, ce;            // the column range
    bool aligned;                // every row segment 16-byte aligned
};

struct Smem {
    float* ring;                 // RING_FLOATS
    double* hs;                  // MAX_ROWS: the sums of the pass before
    double* wred;                // NW x MAX_ROWS: the warps' row partials
    uint64_t* full;              // MAX_BUF
    int* last;
};

__device__ __forceinline__ double warp_sum(double x)
{
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* f)
{
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                 : "=r"(v) : "l"(f) : "memory");
    return v;
}

__device__ __forceinline__ void st_release(unsigned* f, unsigned v)
{
    asm volatile("st.release.gpu.global.u32 [%0], %1;"
                 :: "l"(f), "r"(v) : "memory");
}

__device__ __forceinline__ float comp(const float4& v, int j)
{
    return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// four columns of a read-only row (zeros past its `left` remaining ones)
__device__ __forceinline__ float4 load4(const float* row, long long left,
                                        bool wide)
{
    if (wide && left >= 4) return __ldg(reinterpret_cast<const float4*>(row));
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (left > 0) v.x = __ldg(row);
    if (left > 1) v.y = __ldg(row + 1);
    if (left > 2) v.z = __ldg(row + 2);
    if (left > 3) v.w = __ldg(row + 3);
    return v;
}

// the same for a row that this launch writes (w, row m_a): coherent loads
__device__ __forceinline__ float4 load4w(const float* row, long long left,
                                         bool wide)
{
    if (wide && left >= 4) return *reinterpret_cast<const float4*>(row);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (left > 0) v.x = row[0];
    if (left > 1) v.y = row[1];
    if (left > 2) v.z = row[2];
    if (left > 3) v.w = row[3];
    return v;
}

__device__ __forceinline__ void store4(float* dst, const float (&o)[4],
                                       long long left, bool wide)
{
    if (wide && left >= 4) {
        *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
        return;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
        if (j < left) dst[j] = o[j];
}

__device__ __forceinline__ double* part(const Args& p, int pass, int a,
                                        int j)
{
    return p.P + ((static_cast<long long>(pass) * p.La + a) * p.maxg + j)
        * p.pst;
}

__device__ __forceinline__ double* sums(const Args& p, int a, int pass)
{
    return p.S + (static_cast<long long>(a) * 3 + pass) * MAX_ROWS;
}

// Block blockIdx.x's share of the La lanes' rows laid end to end is
// [t0, t1), share columns; its item in lane a is that share's part of the
// lane, and the lane's blocks are those whose shares meet it.
__device__ Item item_at(const Args& p, int a, long long t0, long long t1)
{
    Item it;
    const long long l0 = a * p.n;
    it.a = a;
    it.j = static_cast<int>(blockIdx.x - l0 / p.share);
    it.nblk = static_cast<int>((l0 + p.n - 1) / p.share - l0 / p.share + 1);
    it.mm = static_cast<int>(p.m[a]);
    it.cb = max(t0, l0) - l0;
    it.ce = min(t1, l0 + p.n) - l0;
    it.Vl = p.V + p.lanes[a] * p.stride_lane;
    it.wa = p.w + a * p.n;
    it.aligned = p.n % 4 == 0 && it.cb % 4 == 0
        && pymes::aligned16(it.Vl) && pymes::aligned16(it.wa);
    return it;
}

// After every thread's share of the block's partials of `rows` rows is in
// part(pass, a, j): take a ticket.  The block that takes the lane's last
// one sums the blocks' partials, writes the lane's sums and the Hessenberg
// entries they finish, and raises the lane's flag.  The sum: thread (q, i)
// adds row i's partials of blocks q, q + Q, ... in order (the threads of a
// warp take neighbouring rows, so the loads coalesce; SU of them in
// flight), then thread i adds the Q sums of row i in order: a fixed order,
// whichever block sums.
constexpr int SU = 40;

__device__ void lane_arrive(const Args& p, const Item& it, int pass,
                            int rows, const Smem& sm)
{
    __syncthreads();
    if (threadIdx.x == 0) {
        // the block's writes before the barrier are ordered before the
        // ticket (the fence is cumulative), the other blocks' after it
        __threadfence();
        *sm.last = atomicAdd(p.sync + pass * p.La + it.a, 1u)
            == static_cast<unsigned>(it.nblk - 1);
        __threadfence();
    }
    __syncthreads();
    if (!*sm.last) return;
    const int rs = max(32, (rows + 31) / 32 * 32), Q = NT / rs;
    const int i = threadIdx.x % rs, q = threadIdx.x / rs;
    if (q < Q) {
        double s = 0.0;
        if (i < rows) {
            const double* P = part(p, pass, it.a, 0) + i;
            for (int j0 = q; j0 < it.nblk; j0 += Q * SU) {
                double v[SU];
#pragma unroll
                for (int u = 0; u < SU; ++u) {
                    const int j = j0 + Q * u;
                    v[u] = j < it.nblk
                        ? __ldcg(P + static_cast<long long>(j) * p.pst) : 0.0;
                }
#pragma unroll
                for (int u = 0; u < SU; ++u) s += v[u];
            }
        }
        sm.wred[q * rs + i] = s;
    }
    __syncthreads();
    double* H = p.H + static_cast<long long>(it.a) * p.R1;
    if (threadIdx.x < rows) {
        const int r = threadIdx.x;
        double t = 0.0;
        for (int k = 0; k < Q; ++k) t += sm.wred[k * rs + r];
        sums(p, it.a, pass)[r] = t;
        if (pass == 1) H[r] = __ldcg(sums(p, it.a, 0) + r) + t;
        if (pass == 2) H[it.mm] = sqrt(t);
    }
    if (pass == 2)
        for (int r = it.mm + 1 + threadIdx.x; r < p.R1; r += NT) H[r] = 0.0;
    __syncthreads();
    if (threadIdx.x == 0) {
        __threadfence();
        st_release(p.sync + (3 + pass) * p.La + it.a, 1u);
    }
}

// Wait for the lane's flag of `pass`, then take its `rows` sums into hs.
// A wait of some seconds can only be a fault: it traps, and the launch
// fails instead of holding the card.
__device__ void lane_wait(const Args& p, const Item& it, int pass, int rows,
                          const Smem& sm)
{
    if (threadIdx.x == 0) {
        const unsigned* f = p.sync + (3 + pass) * p.La + it.a;
        for (unsigned spins = 0; ld_acquire(f) == 0u; ++spins)
            if (spins > (1u << 30)) __trap();
    }
    __syncthreads();
    const double* s = sums(p, it.a, pass);
    for (int i = threadIdx.x; i < rows; i += NT) sm.hs[i] = __ldcg(s + i);
    __syncthreads();
}

// The block's sum of one value a thread, in a fixed order, to out[0].
__device__ void block_norm(double x, double* wred, double* out)
{
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const double s = warp_sum(x);
    if (lane == 0) wred[warp] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
        double t = 0.0;
        for (int k = 0; k < NW; ++k) t += wred[k];
        out[0] = t;
    }
}

// row m_a *= 1/max(|w2|, brk) where |w2| > brk, else 0, on the block's
// range (which this block wrote in pass 2); a thread's SCALE_U quads'
// loads are in flight together
constexpr int SCALE_U = 8;

__device__ void scale_range(const Args& p, const Item& it, double nrm2)
{
    const double nrm = sqrt(nrm2);
    const double scale = nrm > p.brk ? 1.0 / fmax(nrm, p.brk) : 0.0;
    float* row = it.Vl + it.mm * p.n;
    for (long long c0 = it.cb + 4 * threadIdx.x; c0 < it.ce;
         c0 += SCALE_U * STEP) {
        float4 v[SCALE_U];
#pragma unroll
        for (int u = 0; u < SCALE_U; ++u)
            v[u] = load4w(row + c0 + u * STEP, it.ce - c0 - u * STEP,
                          it.aligned);
#pragma unroll
        for (int u = 0; u < SCALE_U; ++u) {
            const float o[4] = {static_cast<float>(scale * v[u].x),
                                static_cast<float>(scale * v[u].y),
                                static_cast<float>(scale * v[u].z),
                                static_cast<float>(scale * v[u].w)};
            store4(row + c0 + u * STEP, o, it.ce - c0 - u * STEP,
                   it.aligned);
        }
    }
}

// ---- the tile ring: (m_a rows and w) x tc columns a tile

struct Ring {
    float* ring; uint64_t* full;
    int nbuf, td, tc;            // buffers, floats a buffer, columns a tile
    unsigned& phases;            // bit b: the parity of buffer b's next wait
};

__device__ __forceinline__ long long tile_c0(const Ring& r, const Item& it,
                                             int count, int t, bool fwd)
{
    return it.cb + static_cast<long long>(fwd ? t : count - 1 - t) * r.tc;
}

__device__ __forceinline__ int tile_cv(const Ring& r, const Item& it,
                                       long long c0)
{
    return static_cast<int>(min(static_cast<long long>(r.tc), it.ce - c0));
}

// all threads: start the copies of tile t of a walk into buffer t % nbuf,
// 16 bytes a copy where the row segments allow
__device__ void tile_issue(const Ring& r, const Item& it, long long n,
                           int count, int t, bool fwd)
{
    if (t >= count) return;
    const long long c0 = tile_c0(r, it, count, t, fwd);
    const int cv = tile_cv(r, it, c0);
    const int b = t % r.nbuf;
    float* dst = r.ring + b * r.td;
    const bool wide = it.aligned && cv % 4 == 0;
    const int cw = wide ? cv / 4 : cv, total = (it.mm + 1) * cw;
    for (int e = threadIdx.x; e < total; e += NT) {
        const int i = e / cw, c = e - i * cw;
        const float* src = (i < it.mm ? it.Vl + i * n : it.wa) + c0;
        if (wide) pymes::cp_async16(dst + i * r.tc + 4 * c, src + 4 * c);
        else pymes::cp_async4(dst + i * r.tc + c, src + c);
    }
    pymes::cp_async_arrive_noinc(&r.full[b]);
}

__device__ __forceinline__ float* tile_wait(const Ring& r, int t)
{
    const int b = t % r.nbuf;
    pymes::mbar_wait(&r.full[b], (r.phases >> b) & 1u);
    r.phases ^= 1u << b;
    return r.ring + b * r.td;
}

// zero the components of v at and past `keep`
__device__ __forceinline__ void mask4(float4& v, int keep)
{
    if (keep < 4) v.w = 0.f;
    if (keep < 3) v.z = 0.f;
    if (keep < 2) v.y = 0.f;
    if (keep < 1) v.x = 0.f;
}

// ---- the passes: a tile of (m_a rows and w) x 1024/G columns; G threads
// own a column quad (4 columns), each with the rows g, g+G, ... of the
// column (part g), at most RPW of them: G = 1, 2, 4, 8 for m_a < 16, 32,
// 64, 128.  A warp holds Q = 32/G quads, lane = g Q + j, so the G threads
// of a quad lie in one warp and a column's sum over its rows meets in a
// butterfly of warp shuffles (a fixed order).  One barrier a tile (the
// buffer's release); columns past the range are masked to zero.
//   pass 0: each thread's rows' dots with the tile's w quad.
//   pass 1: the parts' shares of V^T h1 meet in the butterfly; w1 (as
//     stored) to w by part 0; the row dots with w1 (each element widened
//     again: keeping RPW x 4 doubles would spill).
//   pass 2: the same sums give w2 into row m_a and |w2|^2 by part 0.

template <int G>
__device__ __forceinline__ void thread_part(int mm, int& g, int& nr, int& q)
{
    constexpr int Q = 32 / G;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    g = lane / Q;
    nr = mm > g ? (mm - g + G - 1) / G : 0;
    q = 4 * (warp * Q + lane % Q);
}

template <int PASS, int G>
__device__ void part_pass(const Ring& r, const Item& it, long long n,
                          int count, bool fwd, const Smem& sm,
                          double (&acc)[RPW], double& nacc)
{
    constexpr int Q = 32 / G;
    const int mm = it.mm, tc = r.tc;
    int g, nr, q;
    thread_part<G>(mm, g, nr, q);
    for (int t = 0; t < count; ++t) {
        // tile t - 1's buffer, released by the barrier that ended it
        tile_issue(r, it, n, count, t + r.nbuf - 1, fwd);
        const float* tile = tile_wait(r, t);
        const long long c0 = tile_c0(r, it, count, t, fwd);
        const int keep = tile_cv(r, it, c0) - q;
        float4 x = *reinterpret_cast<const float4*>(tile + mm * tc + q);
        mask4(x, keep);
        float4 v[RPW];
#pragma unroll
        for (int k = 0; k < RPW; ++k) {
            if (k >= nr) break;
            v[k] = *reinterpret_cast<const float4*>(tile + (g + G * k) * tc
                                                    + q);
            mask4(v[k], keep);
        }
        if constexpr (PASS == 0) {
            const double x0 = x.x, x1 = x.y, x2 = x.z, x3 = x.w;
#pragma unroll
            for (int k = 0; k < RPW; ++k) {
                if (k >= nr) break;
                double s = acc[k];
                s = fma(static_cast<double>(v[k].x), x0, s);
                s = fma(static_cast<double>(v[k].y), x1, s);
                s = fma(static_cast<double>(v[k].z), x2, s);
                s = fma(static_cast<double>(v[k].w), x3, s);
                acc[k] = s;
            }
        } else {
            // the column sums of V^T h: the part's rows in order, the four
            // columns' chains side by side, then the parts in a butterfly
            double s[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
            for (int k = 0; k < RPW; ++k) {
                if (k >= nr) break;
                const double h = sm.hs[g + G * k];
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    s[j] = fma(h, static_cast<double>(comp(v[k], j)), s[j]);
            }
#pragma unroll
            for (int o = Q; o < 32; o <<= 1)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    s[j] += __shfl_xor_sync(0xffffffffu, s[j], o);
            float f[4];
            double x1[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const double xj = static_cast<double>(comp(x, j)) - s[j];
                f[j] = static_cast<float>(xj);
                // w1 as stored: the row dots read what pass 2 will
                x1[j] = static_cast<double>(f[j]);
                if constexpr (PASS == 2) nacc = fma(xj, xj, nacc);
            }
            if (g == 0 && keep > 0)
                store4(PASS == 1 ? it.wa + c0 + q : it.Vl + mm * n + c0 + q,
                       f, keep, it.aligned);
            if constexpr (PASS == 1) {
#pragma unroll
                for (int k = 0; k < RPW; ++k) {
                    if (k >= nr) break;
                    double a = acc[k];
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        a = fma(static_cast<double>(comp(v[k], j)), x1[j],
                                a);
                    acc[k] = a;
                }
            }
        }
        __syncthreads();
    }
    if constexpr (PASS == 2)
        if (g != 0) nacc = 0.0;      // the parts hold the same w2
}

// The block's row partials: each thread's acc[k] is row g + G k's sum over
// its quad's columns; a butterfly over the warp's Q quads, then thread i
// adds the warps' sums of row i in order, to out[i].
template <int G>
__device__ void part_rows(const double (&acc)[RPW], int mm, double* wred,
                          double* out)
{
    constexpr int Q = 32 / G;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    int g, nr, q;
    thread_part<G>(mm, g, nr, q);
#pragma unroll
    for (int k = 0; k < RPW; ++k) {
        double s = k < nr ? acc[k] : 0.0;
#pragma unroll
        for (int o = 1; o < Q; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane % Q == 0 && k < nr) wred[warp * MAX_ROWS + g + G * k] = s;
    }
    __syncthreads();
    if (threadIdx.x < mm) {
        double t = 0.0;
        for (int w = 0; w < NW; ++w) t += wred[w * MAX_ROWS + threadIdx.x];
        out[threadIdx.x] = t;
    }
}

// Pass `pass` of one item through the ring, G threads a column: its first
// tiles are issued, then the wait for the sums of the pass before, then
// the tiles, then the block's partials and its ticket.  Returns the ring's
// phases.
template <int G>
__device__ __forceinline__ unsigned item_pass(int pass, const Args& p,
                                              const Item& it, const Smem& sm,
                                              unsigned phases)
{
    const int tc = 1024 / G, td = (it.mm + 1) * tc;
    const Ring r{sm.ring, sm.full, min(MAX_BUF, RING_FLOATS / td), td, tc,
                 phases};
    const int count = static_cast<int>((it.ce - it.cb + tc - 1) / tc);
    const bool fwd = pass != 1;
    for (int t = 0; t < r.nbuf - 1; ++t)
        tile_issue(r, it, p.n, count, t, fwd);
    if (pass > 0) lane_wait(p, it, pass - 1, it.mm, sm);
    double acc[RPW];
    double nacc = 0.0;
#pragma unroll
    for (int k = 0; k < RPW; ++k) acc[k] = 0.0;
    if (pass == 0) {
        part_pass<0, G>(r, it, p.n, count, fwd, sm, acc, nacc);
        part_rows<G>(acc, it.mm, sm.wred, part(p, 0, it.a, it.j));
    } else if (pass == 1) {
        part_pass<1, G>(r, it, p.n, count, fwd, sm, acc, nacc);
        part_rows<G>(acc, it.mm, sm.wred, part(p, 1, it.a, it.j));
    } else {
        part_pass<2, G>(r, it, p.n, count, fwd, sm, acc, nacc);
        block_norm(nacc, sm.wred, part(p, 2, it.a, it.j));
    }
    lane_arrive(p, it, pass, pass < 2 ? it.mm : 1, sm);
    return phases;
}

// threads a column for m valid rows: at most RPW rows a thread (more rows a
// thread ran faster, and a tile of (m_a + 1) x 1024/G floats still leaves
// the ring 3 buffers)
__device__ __forceinline__ int parts_of(int mm)
{
    return mm < RPW ? 1 : mm < 2 * RPW ? 2 : mm < 4 * RPW ? 4 : 8;
}

// The block takes its items (one lane, or the end of one and the start of
// the next) pass by pass: every item's pass p and its ticket before any
// wait for pass p's sums, so no wait can close a circle.  Odd passes take
// the items in reverse, as they walk their tiles: each pass starts on what
// the one before read last.
__global__ void __launch_bounds__(NT, 1) cgs2_kernel(Args p)
{
    extern __shared__ __align__(128) unsigned char smem[];
    Smem sm;
    sm.ring = reinterpret_cast<float*>(smem);
    sm.hs = reinterpret_cast<double*>(smem + sizeof(float) * RING_FLOATS);
    sm.wred = sm.hs + MAX_ROWS;
    sm.full = reinterpret_cast<uint64_t*>(sm.wred + NW * MAX_ROWS);
    sm.last = reinterpret_cast<int*>(sm.full + MAX_BUF);
    const long long t0 = blockIdx.x * p.share;
    const long long t1 = min(t0 + p.share, p.La * p.n);
    if (t0 >= t1) return;
    if (threadIdx.x == 0)
        for (int b = 0; b < MAX_BUF; ++b) pymes::mbar_init(&sm.full[b], NT);
    __syncthreads();
    const int a0 = static_cast<int>(t0 / p.n);
    const int a1 = static_cast<int>((t1 - 1) / p.n);
    unsigned phases = 0;
    for (int pass = 0; pass < 3; ++pass)
        for (int k = 0; k <= a1 - a0; ++k) {
            const Item it = item_at(p, pass == 1 ? a1 - k : a0 + k, t0, t1);
            switch (parts_of(it.mm)) {
                case 1: phases = item_pass<1>(pass, p, it, sm, phases); break;
                case 2: phases = item_pass<2>(pass, p, it, sm, phases); break;
                case 4: phases = item_pass<4>(pass, p, it, sm, phases); break;
                default: phases = item_pass<8>(pass, p, it, sm, phases);
            }
        }
    for (int a = a0; a <= a1; ++a) {
        const Item it = item_at(p, a, t0, t1);
        lane_wait(p, it, 2, 1, sm);
        scale_range(p, it, sm.hs[0]);
    }
}

struct CombineArgs {
    const float* V; const long long* lanes; const long long* m;
    const double* C;     // (La, NOUT, ldc) coefficients
    const float* x0;     // (La, n) or null: added to output 0
    float* out0; float* out1;
    long long n, stride_lane;
    int ldc;
};

// Block (x, a): lane a's columns x*1024.. , 4 a thread; the rows in
// order, 8 rows' 16-byte loads in flight; each element widened once.
template <int NOUT>
__global__ void __launch_bounds__(NT) combine_kernel(CombineArgs p)
{
    __shared__ double cs[NOUT][MAX_ROWS];
    const int a = blockIdx.y;
    const int mm = static_cast<int>(p.m[a]);
    for (int i = threadIdx.x; i < mm; i += NT)
#pragma unroll
        for (int o = 0; o < NOUT; ++o)
            cs[o][i] = p.C[(static_cast<long long>(a) * NOUT + o) * p.ldc
                           + i];
    __syncthreads();
    const long long col = blockIdx.x * STEP + 4 * threadIdx.x;
    const long long left = p.n - col;
    if (left <= 0) return;
    const bool wide = p.n % 4 == 0 && pymes::aligned16(p.V)
        && pymes::aligned16(p.out0)
        && (NOUT == 1 || pymes::aligned16(p.out1))
        && (p.x0 == nullptr || pymes::aligned16(p.x0));
    const float* Vl = p.V + p.lanes[a] * p.stride_lane + col;
    const long long base = a * p.n + col;
    double s[NOUT][4] = {};
    for (int i0 = 0; i0 < mm; i0 += CROWS) {
        float4 v[CROWS];
#pragma unroll
        for (int u = 0; u < CROWS; ++u)
            v[u] = i0 + u < mm ? load4(Vl + (i0 + u) * p.n, left, wide)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int u = 0; u < CROWS; ++u) {
            if (i0 + u >= mm) break;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const double dv = static_cast<double>(comp(v[u], j));
#pragma unroll
                for (int o = 0; o < NOUT; ++o)
                    s[o][j] = fma(cs[o][i0 + u], dv, s[o][j]);
            }
        }
    }
    float o[4];
    const float4 x = p.x0 ? load4(p.x0 + base, left, wide)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < 4; ++j)
        o[j] = static_cast<float>(
            p.x0 ? static_cast<double>(comp(x, j)) + s[0][j] : s[0][j]);
    store4(p.out0 + base, o, left, wide);
    if (NOUT == 2) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
            o[j] = static_cast<float>(s[NOUT - 1][j]);
        store4(p.out1 + base, o, left, wide);
    }
}

}  // namespace f32k

// The CGS2 projection of an f32 basis in one cooperative launch of `grid`
// blocks (one an SM), each with `share` columns of the lanes' rows laid end
// to end (arnoldi.f32_plan): V and w of floats, P (3, La, maxg, pst), S
// (La, 3, 128) and H (La, R1) of doubles, sync 6·La words (zeroed here).
// Returns the cudaError_t; a grid larger than the card holds at once is
// refused.
extern "C" int pymes_arnoldi_cgs2_f32(float* V, float* w,
                                      const long long* lanes,
                                      const long long* m, long long share,
                                      double* P, double* S, double* H,
                                      unsigned* sync, long long n,
                                      long long stride_lane, int R1, int La,
                                      int maxg, int pst, int grid,
                                      double brk, cudaStream_t stream)
{
    if (La <= 0) return static_cast<int>(cudaSuccess);
    cudaError_t err = cudaMemsetAsync(sync, 0, sizeof(unsigned) * 6 * La,
                                      stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(f32k::cgs2_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(f32k::SMEM));
    if (err != cudaSuccess) return static_cast<int>(err);
    f32k::Args args{V, w, lanes, m, share, P, S, H, sync, n, stride_lane,
                    R1, La, maxg, pst, brk};
    void* params[] = {&args};
    return static_cast<int>(cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(f32k::cgs2_kernel), dim3(grid),
        dim3(f32k::NT), params, f32k::SMEM, stream));
}

// The f32 combines: out0 = x0 + sum_i C[a, 0, i] V_i (x0 may be null) and,
// with nout = 2, out1 = sum_i C[a, 1, i] V_i; C of doubles.
extern "C" int pymes_krylov_combine_f32(const float* V,
                                        const long long* lanes,
                                        const long long* m, const double* C,
                                        int nout, const float* x0,
                                        float* out0, float* out1,
                                        long long n, long long stride_lane,
                                        int ldc, int La, cudaStream_t stream)
{
    if (La <= 0) return static_cast<int>(cudaSuccess);
    const f32k::CombineArgs p{V, lanes, m, C, x0, out0, out1, n,
                              stride_lane, ldc};
    const dim3 grid(static_cast<unsigned>((n + f32k::STEP - 1) / f32k::STEP),
                    La);
    if (nout == 1) f32k::combine_kernel<1><<<grid, f32k::NT, 0, stream>>>(p);
    else if (nout == 2)
        f32k::combine_kernel<2><<<grid, f32k::NT, 0, stream>>>(p);
    else return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
}
