// K1: momentum-sector ladder GEMM for the UEG CCD residual (f64, sm_90a).
//
// Replaces B1 of the JAX package: pymes_tpu/ops/ueg_ladder.py:450
// block_ladder_apply_ij (and its integer-MXU form block_ladder_apply_ij_ozaki,
// :533 / _block_ozaki_rows, :517).  For every bucket group g, sector s and
// padded bra row m with bra_of_row[s,m] >= 0:
//
//   outT[bra_of_row[s,m], ij] = sum_{k < mK} blocks[s,m,k] * Tt[perm_ket[s,k], ij]
//
// for all N = no*no values of ij.  Bra pairs whose total momentum has no ket
// pair are never written; the wrapper zero-fills outT (the JAX trailing zero
// column, ueg_ladder.py:439, :469-472).  Every bra pair is the row of exactly
// one sector, so rows map one-to-one onto output rows and no atomics are
// needed.
//
// Layout.  The amplitudes arrive cd-major, Tt = (nv*nv, N): in the ijab
// layout a ket pair's amplitudes are N doubles spaced nv*nv apart, here they
// are N contiguous doubles, so the perm_ket gather that builds the B tile
// reads whole 392-byte rows (N = 49).  The output is written bra-major,
// outT = (n_bra*n_bra, N), for the same reason; the wrapper returns its
// transposed view.  The perm_ket gather is fused into the B-tile load and
// the inv_bra permutation into the store.
//
// What bounds it on an H100: N = 49 is skinny and most sectors are small
// (8x8 .. 224x224 after padding), so the work is many small GEMMs whose
// operands (27 MB of sector blocks at nP=219, one pass, plus 17.6 MB of T
// in and out) are read once per call for 0.33 GFLOP: device-memory
// bandwidth and per-tile latency, not f64 FLOPs.
// One launch covers every group: blocks walk a work list of (group, sector,
// row tile) entries built once with the plan, largest buckets first.
// This first version keeps tiles in shared memory and accumulates with f64
// FMA; DMMA (mma.sync f64) and TMA are left for later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TM = 16;                       // bra rows per block
constexpr int TN = 64;                       // ij columns per block
constexpr int TK = 32;                       // ket pairs per shared-memory stage
constexpr int NTHREADS = 256;
constexpr int RPT = TM * TN / NTHREADS;      // rows per thread (4)

static_assert(NTHREADS % TN == 0, "one column per thread");
static_assert(RPT * (NTHREADS / TN) == TM, "rows cover the tile");

__global__ void __launch_bounds__(NTHREADS)
block_ladder_kernel(const double* __restrict__ Tt,        // (nv*nv, N)
                    const double* __restrict__ blocks,    // groups' (nS, mB, mK), flat
                    const int* __restrict__ perm,         // groups' (nS, mK), flat
                    const int* __restrict__ bra_of_row,   // groups' (nS, mB), flat
                    const long long* __restrict__ gtab,   // (G, 5): blk, perm, bra offsets, mB, mK
                    const int* __restrict__ work,         // (n_work, 3): group, sector, row0
                    double* __restrict__ outT,            // (n_bra*n_bra, N)
                    int N)
{
    __shared__ double As[TM][TK + 1];
    __shared__ double Bs[TK][TN];

    const int w = blockIdx.x;
    const int g = work[3 * w], s = work[3 * w + 1], r0 = work[3 * w + 2];
    const long long* gt = gtab + 5 * g;
    const int mB = static_cast<int>(gt[3]);
    const int mK = static_cast<int>(gt[4]);
    const double* A = blocks + gt[0] + static_cast<long long>(s) * mB * mK;
    const int* pk = perm + gt[1] + static_cast<long long>(s) * mK;
    const int* br = bra_of_row + gt[2] + static_cast<long long>(s) * mB;

    const int n0 = blockIdx.y * TN;
    const int tid = threadIdx.x;
    const int col = tid % TN;
    const int rg = tid / TN;

    double acc[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[i] = 0.0;

    for (int k0 = 0; k0 < mK; k0 += TK) {
        // A tile (sector rows): consecutive threads read consecutive k
        for (int e = tid; e < TM * TK; e += NTHREADS) {
            const int r = e / TK, k = e % TK;
            const int m = r0 + r, kk = k0 + k;
            As[r][k] = (m < mB && kk < mK)
                ? A[static_cast<long long>(m) * mK + kk] : 0.0;
        }
        // B tile: ket rows gathered through perm_ket (fused gather)
        for (int e = tid; e < TK * TN; e += NTHREADS) {
            const int k = e / TN, c = e % TN;
            const int kk = k0 + k, n = n0 + c;
            Bs[k][c] = (kk < mK && n < N)
                ? Tt[static_cast<long long>(pk[kk]) * N + n] : 0.0;
        }
        __syncthreads();
#pragma unroll 8
        for (int k = 0; k < TK; ++k) {
            const double b = Bs[k][col];
#pragma unroll
            for (int i = 0; i < RPT; ++i)
                acc[i] = fma(As[rg * RPT + i][k], b, acc[i]);
        }
        __syncthreads();
    }

    // store through the bra permutation (fused inv_bra scatter)
    const int n = n0 + col;
    if (n < N) {
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            const int m = r0 + rg * RPT + i;
            if (m < mB) {
                const int b = br[m];
                if (b >= 0) outT[static_cast<long long>(b) * N + n] = acc[i];
            }
        }
    }
}

}  // namespace

extern "C" int pymes_block_ladder_row_tile() { return TM; }

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int pymes_block_ladder(const double* Tt, const double* blocks,
                                  const int* perm, const int* bra_of_row,
                                  const long long* gtab, const int* work,
                                  int n_work, double* outT, int N,
                                  cudaStream_t stream)
{
    if (n_work <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
    const dim3 grid(n_work, (N + TN - 1) / TN);
    block_ladder_kernel<<<grid, NTHREADS, 0, stream>>>(
        Tt, blocks, perm, bra_of_row, gtab, work, outT, N);
    return static_cast<int>(cudaGetLastError());
}
