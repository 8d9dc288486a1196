// K9: one step of the ring-accumulated particle-particle ladder (f64, sm_90a).
//
// Replaces the GEMM of one ring step of B7 in the JAX package:
// pymes_tpu/parallel/ring_ladder.py:85-97 (_ring_kernel_ij, and the abij
// form _ring_kernel, :26-44).  Shard `me` holds V_loc = V[a_loc rows, b, c, d]
// and, at step k, the T shard that started on shard src = (me - k) mod P;
// the step adds
//
//   R[m, n] += sum_{k < K} T[m, k] * V[n, k]          (in place, beta = 1)
//
// with m = (i,j) (M = no*no), n = (a_loc,b) (N = a_loc*nv) and k = (c,d) over
// the c-panel src (K = csz*nv).  Seen as the (a_loc*nv, nv*nv) matrix, V_loc's
// panel is the column window [src*csz*nv, (src+1)*csz*nv): row stride ldv =
// nv*nv, contiguous inside a row.  The kernel reads that window in place (the
// JAX step first materialises transpose(V_slice), a 1.0 GB copy per step at
// nP=219) and accumulates into R in place.  T and R come with explicit
// strides, so the ijab form (T (M, K) row-major, R (M, N) row-major) and the
// abij form (T cd-major, seen as (M, K) with m stride 1; R likewise) run the
// same kernel, no transpose copy.
//
// What bounds it on an H100: at nP=219 (nv = 212, 4 shards, M = 49,
// N = K = 11236) one launch reads a 1.01 GB panel once for 12.4 GFLOP, so
// HBM bandwidth: 0.305 ms at 3.35 TB/s.  f64 FMA on the CUDA cores (~34
// TFLOP/s) would need 0.364 ms for the arithmetic alone, above that bound,
// so the products run on the f64 tensor cores (DMMA, 67 TFLOP/s).
//
// Design:
// * DMMA: mma.sync.aligned.m16n8k8.row.col.f64 (a shape new in sm_90,
//   twice the work of an m8n8k4 instruction), accumulators in registers.
//   A block holds 64 rows of M (4 m16 tiles; M = 49 is padded to 64, so
//   the step costs 2*64*N*K = 16.2 GFLOP at nP=219, >= 0.241 ms at 67
//   TFLOP/s, under the byte bound).  V's rows are k-contiguous: exactly
//   the .col B operand.  Rows of a tile past M or N hold whatever the
//   buffer held; they feed only outputs that are never stored (an output
//   row depends only on its A row, a column only on its B column).  Only
//   the k tail of the last stage is masked to zero in the fragments.
// * A 4-stage shared-memory ring of (TN x 32) V and (64 x 32) T tiles,
//   rows padded to 36 doubles so the fragment loads are free of bank
//   conflicts.  Two producer warps fill it with 16-byte cp.async (a warp
//   instruction moves two 256-byte row segments), each thread's copies
//   arriving on the stage's full mbarrier (cp.async.mbarrier.arrive.noinc);
//   four consumer warps release a stage through its empty mbarrier.  Where
//   a row is not 16-byte aligned (an odd panel offset or row stride, an
//   odd K tail) or T has m stride 1 (abij), the producers move single
//   doubles with 8-byte cp.async on the same barriers, so any offset runs
//   on the card (async_copy.cuh says why not cp.async.bulk).
// * A tile of TN = 128, 64 or 32 output columns (4, 2 or 1 n8 tiles a
//   consumer warp) and a split of the contraction into contiguous stage
//   ranges, both chosen per shape by the Python planner
//   (kernels/ring_step.py plan): at nP=219 TN = 128 (T's re-reads through
//   L2 are 88 x 4.4 MB beside the 1.01 GB panel) and 3 splits (264 blocks,
//   two full waves on 132 SMs); at nP=57 TN = 32 and one split (16
//   blocks, no second launch).  With several splits each writes its
//   partial to scratch and ring_reduce adds them in split order: no
//   atomics, and a rerun gives the same bits.

#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

using pymes::aligned16;

constexpr int MT = 4;                  // m16 tiles of a block
constexpr int BM = 16 * MT;            // rows of M per block
constexpr int KK = 8;                  // depth of one DMMA (m16n8k8)
constexpr int TK = 32;                 // contraction depth of a stage
constexpr int LDS = TK + 4;            // padded shared row, in doubles
constexpr int STAGES = 4;
constexpr int CWARPS = 4;              // consumer warps
constexpr int PTHREADS = 64;           // two producer warps
constexpr int NTHREADS = 32 * CWARPS + PTHREADS;

template <int NT>
__host__ __device__ constexpr int tile_n() { return CWARPS * 8 * NT; }

template <int NT>
__host__ __device__ constexpr int stage_doubles()
{
    return (tile_n<NT>() + BM) * LDS;
}

template <int NT>
constexpr size_t smem_bytes()
{
    return sizeof(double) * STAGES * stage_doubles<NT>()
        + 2 * STAGES * sizeof(uint64_t);
}

struct Args {
    const double* T; long long stm, stk;
    const double* V; long long ldv;    // V points at the panel's column 0
    double* R; long long srm, srn;
    int M, N, K, sps;                  // sps: stages of one split
    double* W;                         // (splits, M, N) partials or null
};

// C (16 x 8) += A (16 x 8) B (8 x 8); with g = lane / 4, t = lane % 4 a
// lane holds A[g + 8h][t + 4q] in a[2q + h], B[t + 4q][g] in b[q] and
// C[g + 8h][2t + e] in c[2h + e]
__device__ __forceinline__ void dmma(double (&c)[4], const double (&a)[4],
                                     const double (&b)[2])
{
    asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
                 "{%0, %1, %2, %3};"
                 : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
                 : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]),
                   "d"(b[1]));
}

// Rows [0, nrows) x depth [0, kv) of src (row stride ld, unit k stride)
// into dst (row stride LDS): 16-byte copies when src rows are 16-byte
// aligned, else 8-byte ones; producer thread p takes every PTHREADS-th.
__device__ __forceinline__ void copy_rows(double* dst, const double* src,
                                          long long ld, int nrows, int kv,
                                          bool al16, int p)
{
    if (al16 && kv == TK) {
        for (int e = p; e < nrows * (TK / 2); e += PTHREADS) {
            const int r = e / (TK / 2), c = 2 * (e % (TK / 2));
            pymes::cp_async16(dst + r * LDS + c, src + r * ld + c);
        }
    } else if (al16 && kv % 2 == 0) {
        const int cpr = kv / 2;
        for (int e = p; e < nrows * cpr; e += PTHREADS) {
            const int r = e / cpr, c = 2 * (e % cpr);
            pymes::cp_async16(dst + r * LDS + c, src + r * ld + c);
        }
    } else {
        for (int e = p; e < nrows * kv; e += PTHREADS) {
            const int r = e / kv, k = e % kv;
            pymes::cp_async8(dst + r * LDS + k, src + r * ld + k);
        }
    }
}

// The producer warps (thread p of PTHREADS): fill stage u of the block's
// range [s0, s0 + nst) once the consumers have released its buffer.
template <int NT>
__device__ void produce(const Args& a, double* smem, uint64_t* full,
                        uint64_t* empty, int n0, int m0, int s0, int nst,
                        int p)
{
    constexpr int TN = tile_n<NT>();
    const int nrows = min(TN, a.N - n0), mrows = min(BM, a.M - m0);
    const bool v_al = aligned16(a.V) && a.ldv % 2 == 0;
    const bool t_al = aligned16(a.T) && a.stm % 2 == 0;
    for (int u = 0; u < nst; ++u) {
        const int slot = u % STAGES;
        pymes::mbar_wait(&empty[slot], ((u / STAGES) & 1) ^ 1);
        const int k0 = (s0 + u) * TK, kv = min(TK, a.K - k0);
        double* Vs = smem + slot * stage_doubles<NT>();
        double* Ts = Vs + TN * LDS;
        copy_rows(Vs, a.V + n0 * a.ldv + k0, a.ldv, nrows, kv, v_al, p);
        if (a.stk == 1) {
            copy_rows(Ts, a.T + m0 * a.stm + k0, a.stm, mrows, kv, t_al, p);
        } else {
            // m stride 1 (abij): neighbouring threads on neighbouring rows
            for (int e = p; e < mrows * kv; e += PTHREADS) {
                const int k = e / mrows, r = e % mrows;
                pymes::cp_async8(Ts + r * LDS + k,
                                 a.T + (m0 + r) * a.stm + (k0 + k) * a.stk);
            }
        }
        pymes::cp_async_arrive_noinc(&full[slot]);
    }
}

// One stage of products into a consumer warp's accumulators; MASK zeroes
// the fragments past the valid depth kv of the last stage.
template <int NT, bool MASK>
__device__ __forceinline__ void mma_stage(const double* Vs, const double* Ts,
                                          double (&acc)[MT][NT][4], int g,
                                          int t, int wn, int kv)
{
#pragma unroll
    for (int ks = 0; ks < TK / KK; ++ks) {
        if (MASK && ks * KK >= kv) break;
        double av[MT][4], bv[NT][2];
#pragma unroll
        for (int q = 0; q < KK / 4; ++q) {
            const int k = ks * KK + 4 * q + t;
            const bool ok = !MASK || k < kv;
#pragma unroll
            for (int i = 0; i < MT; ++i)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const double x = Ts[(16 * i + 8 * h + g) * LDS + k];
                    av[i][2 * q + h] = ok ? x : 0.0;
                }
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                const double x = Vs[(wn + 8 * j + g) * LDS + k];
                bv[j][q] = ok ? x : 0.0;
            }
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < NT; ++j) dmma(acc[i][j], av[i], bv[j]);
    }
}

// Block (x, y, z): output columns [x*TN, (x+1)*TN), rows [y*64, (y+1)*64),
// contraction stages [z*sps, (z+1)*sps); into R when W is null, else into
// W[z].
template <int NT>
__global__ void __launch_bounds__(NTHREADS) ring_step_kernel(Args a)
{
    constexpr int TN = tile_n<NT>();
    extern __shared__ __align__(128) double smem[];
    uint64_t* full = reinterpret_cast<uint64_t*>(
        smem + STAGES * stage_doubles<NT>());
    uint64_t* empty = full + STAGES;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int n0 = blockIdx.x * TN, m0 = blockIdx.y * BM;
    const int s0 = blockIdx.z * a.sps;
    const int nst = min((a.K + TK - 1) / TK, s0 + a.sps) - s0;
    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            pymes::mbar_init(&full[s], PTHREADS);
            pymes::mbar_init(&empty[s], CWARPS);
        }
    }
    __syncthreads();
    if (warp >= CWARPS) {
        produce<NT>(a, smem, full, empty, n0, m0, s0, nst,
                    threadIdx.x - 32 * CWARPS);
        return;
    }

    const int g = lane >> 2, t = lane & 3, wn = warp * 8 * NT;
    double acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0;

    for (int u = 0; u < nst; ++u) {
        const int slot = u % STAGES;
        pymes::mbar_wait(&full[slot], (u / STAGES) & 1);
        const double* Vs = smem + slot * stage_doubles<NT>();
        const double* Ts = Vs + TN * LDS;
        const int kv = min(TK, a.K - (s0 + u) * TK);
        if (kv == TK) mma_stage<NT, false>(Vs, Ts, acc, g, t, wn, kv);
        else mma_stage<NT, true>(Vs, Ts, acc, g, t, wn, kv);
        __syncwarp();
        if (lane == 0) pymes::mbar_arrive(&empty[slot]);
    }

    double* Wz = a.W ? a.W + static_cast<long long>(blockIdx.z) * a.M * a.N
                     : nullptr;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int m = m0 + 16 * i + 8 * h + g;
            if (m >= a.M) continue;
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int n = n0 + wn + 8 * j + 2 * t + e;
                    if (n >= a.N) continue;
                    const double c = acc[i][j][2 * h + e];
                    if (Wz) Wz[static_cast<long long>(m) * a.N + n] = c;
                    else a.R[m * a.srm + n * a.srn] += c;
                }
        }
}

// R[m, n] += W[0][m][n] + W[1][m][n] + ... in split order (deterministic)
__global__ void ring_reduce(const double* __restrict__ W, int splits,
                            double* __restrict__ R, long long srm,
                            long long srn, int M, int N)
{
    const long long MN = static_cast<long long>(M) * N;
    const long long e = static_cast<long long>(blockIdx.x) * blockDim.x
        + threadIdx.x;
    if (e >= MN) return;
    double s = W[e];
    for (int z = 1; z < splits; ++z) s += W[z * MN + e];
    R[(e / N) * srm + (e % N) * srn] += s;
}

template <int NT>
cudaError_t launch(const Args& a, dim3 grid, cudaStream_t stream)
{
    // set on every launch: the attribute belongs to the current device
    cudaError_t err = cudaFuncSetAttribute(
        ring_step_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<NT>()));
    if (err != cudaSuccess) return err;
    ring_step_kernel<NT><<<grid, NTHREADS, smem_bytes<NT>(), stream>>>(a);
    return cudaGetLastError();
}

}  // namespace

// R[m*srm + n*srn] += sum_k T[m*stm + k*stk] * V[n*ldv + k] for m < M,
// n < N, k < K (V points at the panel's first column), on `stream`, with
// output tiles of tn columns (128, 64 or 32) and the contraction cut
// into `splits` ranges of whole 32-deep stages (W a scratch of splits*M*N
// doubles when that leaves more than one range, else unused); returns the
// cudaError_t of the launches.
extern "C" int pymes_ring_step(const double* T, long long stm, long long stk,
                               const double* V, long long ldv, double* R,
                               long long srm, long long srn, int M, int N,
                               int K, int tn, int splits, double* W,
                               cudaStream_t stream)
{
    if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaSuccess);
    if (splits < 1) return static_cast<int>(cudaErrorInvalidValue);
    const int stages = (K + TK - 1) / TK;
    const int sps = (stages + splits - 1) / splits;
    const int nz = (stages + sps - 1) / sps;      // <= splits
    if (nz > 1 && W == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const Args a{T, stm, stk, V, ldv, R, srm, srn, M, N, K, sps,
                 nz > 1 ? W : nullptr};
    const dim3 grid((N + tn - 1) / tn, (M + BM - 1) / BM, nz);
    cudaError_t err;
    switch (tn) {
        case tile_n<4>(): err = launch<4>(a, grid, stream); break;
        case tile_n<2>(): err = launch<2>(a, grid, stream); break;
        case tile_n<1>(): err = launch<1>(a, grid, stream); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    if (err != cudaSuccess || nz == 1) return static_cast<int>(err);
    const long long MN = static_cast<long long>(M) * N;
    ring_reduce<<<static_cast<unsigned>((MN + 255) / 256), 256, 0, stream>>>(
        W, nz, R, srm, srn, M, N);
    return static_cast<int>(cudaGetLastError());
}
