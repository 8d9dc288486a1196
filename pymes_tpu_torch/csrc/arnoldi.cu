// K7: the CGS2 Arnoldi projection and the Krylov combines of the
// lane-batched GMRES (sm_90a), for a basis of doubles (the f64 FEAST/RT
// path) or of floats (the f32 Krylov solves of the mixed-precision engine,
// ls_precision="mixed").
//
// Replaces B6, the body of pymes_tpu/ops/gmres.py:87-131 `gmres` (the two
// CGS passes at :101-108, h = h1 + h2, the _BREAK = 1e-140 guard at
// :69-73) and its Krylov combines, x = x0 + sum_i y_i V_i (:162) and the
// restart residual sum_i u_i V_i (:179), for La active lanes at once.  For
// lane a with m_a valid rows of its basis V[lanes[a]] (rows of length n):
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
// What bounds it on an H100: HBM bandwidth.  At the FEAST nP=57 shape (64
// lanes, m = 60, n = 245700) a pass reads 7.5 GB of an f64 basis for ~1
// flop per byte; the three passes must move ~23.3 GB (6.95 ms at 3.35
// TB/s).  An f32 basis halves every pass's bytes.
//
// Types: V, w and the outputs x, r are of the basis type T; everything
// that is summed is double in both instantiations.  The row dots h1, h2
// (the projection coefficients), their block partials, the column sums of
// V^T h and of the combines, and |w2|^2 accumulate in double from the
// widened T values, and the Hessenberg column H is written in double (the
// Givens work reads it on the host in f64).  So an f32 basis rounds only
// where a value is stored as T: w1 into w and the tile, w2 into row m_a,
// the scaled row, and the combines' outputs.  The JAX package's f32 GMRES
// (pymes_tpu/ops/gmres.py:58-69) sums in f32; the guard BREAK is the
// caller's (1e-140 for f64, 1e-18 for f32, as there).
//
// Design:
// * A block owns a contiguous column range (span) of one lane; the grid is
//   (G, La), G ranges per lane from the Python planner, sized so that the
//   La*G blocks fill the 132 SMs two blocks deep (~99 KB a block).  The
//   block walks its range in tiles of (m_a + 1) rows x C columns, C sized
//   from m_a on the card so the tile fits its buffer; rows past m_a are
//   never read (the JAX version reads all restart+1 rows).
// * Tile buffers in shared memory: while the block works on one tile, the
//   copies of the next ones are in flight (16-byte cp.async by all threads,
//   the rows being 16-byte aligned where n and the span are multiples of
//   16 bytes of T, else one-element cp.async), and an mbarrier per buffer
//   says when a tile has landed.  The projection keeps 3 of 4 buffers of
//   24 KB in flight, the combine 2 of 3 of 32 KB, of either type: an f32
//   tile holds twice the columns.
// * At m_a <= 16 rows a pass stages nothing: each thread holds its
//   columns' m_a values in registers (register_pass), which keeps more
//   loads in flight than the tiles do when a tile row is short.
// * Each element is read from HBM once per pass.  Pass 1 uses the tile
//   twice: the column combine (one thread a column, rows in order) writes
//   w1 into the tile's w row and to w, then the row dots read it.  Row dots:
//   warp k owns rows k, k+8, ...; each lane keeps its partial of each row
//   in registers across all the block's tiles; at the end a fixed
//   butterfly of warp shuffles gives one partial per block and row.
// * The partials of pass p are summed in block order by every block of
//   pass p+1 for its lane (G values a row): no reduction launch, no
//   atomics, and a rerun gives the same bits.  A projection is 4 launches.
// * Offsets are 64-bit: L*(restart+1)*n is 1.90e9 at nP=57 with 64 lanes.
// * The combine streams the m_a rows once and writes both x = x0 + sum
//   y_i V_i and r = sum u_i V_i (NOUT = 2), each a sum over i in order by
//   one thread a column; NOUT = 1 is the single combine.

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

// One pass (0, 1 or 2) of the CGS2 projection over the La active lanes,
// G column ranges of `span` columns a lane; returns the cudaError_t.  V and
// w of doubles (_f32: of floats); P, h1 and H are doubles in both.
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

extern "C" int pymes_arnoldi_pass_f32(int pass, float* V, float* w,
                                      const long long* lanes,
                                      const long long* m, double* P,
                                      double* h1, double* H, long long n,
                                      long long stride_lane, int R1,
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

extern "C" int pymes_arnoldi_scale_f32(float* V, const long long* lanes,
                                       const long long* m, double* P,
                                       double* H, long long n,
                                       long long stride_lane, int R1,
                                       long long span, int G, int La,
                                       double brk, cudaStream_t stream)
{
    return scale_entry(V, lanes, m, P, H, n, stride_lane, R1, span, G, La,
                       brk, stream);
}

// out0 = x0 + sum_i C[a, 0, i] V_i (x0 may be null) and, with nout = 2,
// out1 = sum_i C[a, 1, i] V_i, over the m_a valid rows of each lane; the
// coefficients C are doubles for either basis type.
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

extern "C" int pymes_krylov_combine_f32(float* V, const long long* lanes,
                                        const long long* m, const double* C,
                                        int nout, const float* x0,
                                        float* out0, float* out1,
                                        long long n, long long stride_lane,
                                        int ldc, long long span, int G,
                                        int La, cudaStream_t stream)
{
    return combine_entry(V, lanes, m, C, nout, x0, out0, out1, n,
                         stride_lane, ldc, span, G, La, stream);
}
