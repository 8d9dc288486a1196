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
// abij form (T cd-major (K, M), R (N, M)) run the same kernel, no transpose
// copy.
//
// What bounds it on an H100: at nP=219 (nv = 212, 4 shards) one launch
// reads a 1.01 GB panel once for 12.4 GFLOP (12 FLOP per byte), so HBM
// bandwidth: 0.30 ms at 3.35 TB/s.  One CCD iteration runs P*P launches and
// reads all of V_abcd (16.2 GB) once.
// This first version is simple and deterministic: one block per 64 x 64
// output tile holding every row of the (padded) M and one split of K, K
// staged through shared memory 32 at a time with the next stage's loads in
// flight in registers, f64 FMA in registers (4 x 4 outputs a thread), each
// output's split summed by one thread in k order, the splits then added in
// split order by a second pass (no atomics).
// Row groups past M are skipped warp by warp (M = 49 fills 49 of 64 rows).
// DMMA (mma.sync f64) and TMA loads are left for later work.

#include <cuda_runtime.h>

namespace {

constexpr int TM = 64;                 // output rows (i,j) per block
constexpr int TN = 64;                 // output columns (a,b) per block
constexpr int TK = 32;                 // contraction depth per stage
constexpr int NTHREADS = 256;          // 16 x 16 threads, 4 x 4 outputs each
constexpr int NG = 4;                  // row (and column) groups a thread

static_assert(NTHREADS == 256 && TM == 16 * NG && TN == 16 * NG,
              "a 16 x 16 thread grid covers the tile");

// FMA of one shared-memory stage into the accumulators of the first NI row
// groups (NI is uniform across a warp but for the warp holding row M-1)
template <int NI>
__device__ __forceinline__ void stage_fma(const double (&As)[TK][TM + 1],
                                          const double (&Bs)[TK][TN + 1],
                                          double (&acc)[NG][NG], int ty,
                                          int tx)
{
#pragma unroll 8
    for (int k = 0; k < TK; ++k) {
        double b[NG];
#pragma unroll
        for (int j = 0; j < NG; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < NI; ++i) {
            const double a = As[k][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < NG; ++j) acc[i][j] = fma(a, b[j], acc[i][j]);
        }
    }
}

// Per stage each thread moves LA elements of the T tile and LB of the V tile
// from device memory through registers: the next stage's loads are issued
// before the current stage's FMA, so they are in flight together and
// overlap the arithmetic.
constexpr int LA = TM * TK / NTHREADS;
constexpr int LB = TN * TK / NTHREADS;

struct Operands {
    const double* T; long long stm, stk;
    const double* V; long long ldv;
    int M, N, K, m0, n0;
};

// UNIT_K: T's k stride is 1 (ijab), so consecutive threads walk k; else
// (abij, m stride 1) they walk m.  Both keep the loads coalesced.
template <bool UNIT_K>
__device__ __forceinline__ void load_stage(const Operands& o, int k0, int tid,
                                           double (&ra)[LA], double (&rb)[LB])
{
#pragma unroll
    for (int u = 0; u < LA; ++u) {
        const int e = tid + u * NTHREADS;
        const int k = UNIT_K ? e % TK : e / TM;
        const int m = UNIT_K ? e / TK : e % TM;
        ra[u] = (o.m0 + m < o.M && k0 + k < o.K)
            ? o.T[(o.m0 + m) * o.stm + (k0 + k) * o.stk] : 0.0;
    }
#pragma unroll
    for (int u = 0; u < LB; ++u) {
        const int e = tid + u * NTHREADS;
        const int k = e % TK, n = e / TK;
        rb[u] = (o.n0 + n < o.N && k0 + k < o.K)
            ? o.V[(o.n0 + n) * o.ldv + (k0 + k)] : 0.0;
    }
}

template <bool UNIT_K>
__device__ __forceinline__ void store_stage(double (&As)[TK][TM + 1],
                                            double (&Bs)[TK][TN + 1], int tid,
                                            const double (&ra)[LA],
                                            const double (&rb)[LB])
{
#pragma unroll
    for (int u = 0; u < LA; ++u) {
        const int e = tid + u * NTHREADS;
        As[UNIT_K ? e % TK : e / TM][UNIT_K ? e / TK : e % TM] = ra[u];
    }
#pragma unroll
    for (int u = 0; u < LB; ++u) {
        const int e = tid + u * NTHREADS;
        Bs[e % TK][e / TK] = rb[u];
    }
}

// The stages [k_begin, o.K) of one split of the contraction (o.K is the
// split's end).
template <bool UNIT_K>
__device__ __forceinline__ void tile_loop(const Operands& o, int k_begin,
                                          double (&As)[TK][TM + 1],
                                          double (&Bs)[TK][TN + 1],
                                          double (&acc)[NG][NG], int ni,
                                          int tid, int ty, int tx)
{
    double ra[LA], rb[LB];
    load_stage<UNIT_K>(o, k_begin, tid, ra, rb);
    for (int k0 = k_begin; k0 < o.K; k0 += TK) {
        store_stage<UNIT_K>(As, Bs, tid, ra, rb);
        __syncthreads();
        if (k0 + TK < o.K) load_stage<UNIT_K>(o, k0 + TK, tid, ra, rb);
        switch (ni) {
            case 4: stage_fma<4>(As, Bs, acc, ty, tx); break;
            case 3: stage_fma<3>(As, Bs, acc, ty, tx); break;
            case 2: stage_fma<2>(As, Bs, acc, ty, tx); break;
            case 1: stage_fma<1>(As, Bs, acc, ty, tx); break;
            default: break;
        }
        __syncthreads();
    }
}

// Block (x, y, z) sums the contraction split z, [z*Kc, (z+1)*Kc), for the
// output tile (y, x): into R when there is one split (W null), else into
// its slice W[z] of the (splits, M, N) scratch that ring_reduce adds up.
__global__ void __launch_bounds__(NTHREADS)
ring_step_kernel(const double* __restrict__ T, long long stm, long long stk,
                 const double* __restrict__ V, long long ldv,
                 double* __restrict__ R, long long srm, long long srn,
                 int M, int N, int K, int Kc, double* __restrict__ W)
{
    __shared__ double As[TK][TM + 1];      // T tile, As[k][m]
    __shared__ double Bs[TK][TN + 1];      // V tile, Bs[k][n]

    const int k_begin = static_cast<int>(blockIdx.z) * Kc;
    const Operands o{T, stm, stk, V, ldv, M, N, min(K, k_begin + Kc),
                     static_cast<int>(blockIdx.y) * TM,
                     static_cast<int>(blockIdx.x) * TN};
    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    // row groups of this thread that hold a row < M
    int ni = 0;
    while (ni < NG && o.m0 + ty + 16 * ni < M) ++ni;

    double acc[NG][NG];
#pragma unroll
    for (int i = 0; i < NG; ++i)
#pragma unroll
        for (int j = 0; j < NG; ++j) acc[i][j] = 0.0;

    // stk is uniform over the grid, so the branch holds every barrier
    if (stk == 1) tile_loop<true>(o, k_begin, As, Bs, acc, ni, tid, ty, tx);
    else tile_loop<false>(o, k_begin, As, Bs, acc, ni, tid, ty, tx);

    double* Wz = W ? W + static_cast<long long>(blockIdx.z) * M * N : nullptr;
#pragma unroll
    for (int i = 0; i < NG; ++i) {
        const int m = o.m0 + ty + 16 * i;
        if (i >= ni) break;
#pragma unroll
        for (int j = 0; j < NG; ++j) {
            const int n = o.n0 + tx + 16 * j;
            if (n >= N) continue;
            if (Wz) Wz[static_cast<long long>(m) * N + n] = acc[i][j];
            else R[m * srm + n * srn] += acc[i][j];
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

int stages(int K) { return (K + TK - 1) / TK; }

}  // namespace

// The number of K splits for one launch: the output tiles alone fill 132
// SMs unevenly (176 tiles at nP=219: two waves, the second a third full),
// so the contraction is cut into up to 8 splits, taking the count that
// minimises (blocks per SM) x (stages per block), the fewest on a tie.
extern "C" int pymes_ring_step_splits(int M, int N, int K)
{
    if (M <= 0 || N <= 0 || K <= 0) return 1;
    int dev = 0, sms = 1;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const long long tiles = static_cast<long long>((N + TN - 1) / TN)
        * ((M + TM - 1) / TM);
    int best = 1;
    long long best_cost = -1;
    for (int S = 1; S <= 8 && S <= stages(K); ++S) {
        const long long per_block = (stages(K) + S - 1) / S;
        const long long cost = (tiles * S + sms - 1) / sms * per_block;
        if (best_cost < 0 || cost < best_cost) { best = S; best_cost = cost; }
    }
    return best;
}

// R[m*srm + n*srn] += sum_k T[m*stm + k*stk] * V[n*ldv + k] for m < M,
// n < N, k < K, on `stream`, with the contraction cut into `splits` (W a
// scratch of splits*M*N doubles when splits > 1, else unused); returns the
// cudaError_t of the launches.
extern "C" int pymes_ring_step(const double* T, long long stm, long long stk,
                               const double* V, long long ldv, double* R,
                               long long srm, long long srn, int M, int N,
                               int K, int splits, double* W,
                               cudaStream_t stream)
{
    if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaSuccess);
    if (splits < 1) return static_cast<int>(cudaErrorInvalidValue);
    const int Kc = (stages(K) + splits - 1) / splits * TK;
    const int nz = (K + Kc - 1) / Kc;      // <= splits
    const dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM, nz);
    ring_step_kernel<<<grid, NTHREADS, 0, stream>>>(
        T, stm, stk, V, ldv, R, srm, srn, M, N, K, Kc, nz > 1 ? W : nullptr);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || nz == 1) return static_cast<int>(err);
    const long long MN = static_cast<long long>(M) * N;
    ring_reduce<<<static_cast<unsigned>((MN + 255) / 256), 256, 0, stream>>>(
        W, nz, R, srm, srn, M, N);
    return static_cast<int>(cudaGetLastError());
}
