// K10: the set-up scatter of a momentum-sparse integral list into the
// named o/v blocks of V[p,q,r,s] (sm_90a), all blocks in one launch.
//
// Replaces B8 in the JAX package: the jitted multi-block scatter
// _scatter_all of pymes_tpu/models/ueg.py:688 under sparse_to_blocks
// (:639-682), together with the host masks in front of it (:654-676) and
// the flat scatter of sparse_to_dense (:611-636).  The sorting of each
// entry into its block moves onto the card:
//
//   class c = [p < no][q < no][r < no][s < no]   (4 bits, p the highest)
//   block   = base[c] (null: the caller did not ask for it; the entry drops)
//   offset  = sum_k (index_k - shift[c][k]) * stride[c][k]
//             (shift no on a virtual slot, 0 on an occupied one; row-major
//              strides of the block's dims)
//   block[offset] = vals[e]
//
// sparse_to_dense is the case no = 0 with the one block abcd of dims
// (nP,)^4.  Offsets are int64: the dense (219,)^4 holds 2.3e9 elements.
// The indices are unique (the lists of eval_2b_integrals are), so plain
// stores suffice, as in the plain version's index_put_ without
// accumulate.  An index outside [0, nP) is not stored; it is counted in
// *bad, which the wrapper reads and raises on.
//
// What bounds it on an H100: device-memory bandwidth.  Every entry's four
// indices must be read to know where it goes (the list arrives packed as
// 4 x int16, 8 bytes an entry); only the entries that land in a block
// read their value and store it.  The blocks are zeroed by the wrapper
// before the launch.  Design: a grid-stride walk, one entry a thread per
// step and UNROLL steps in flight (the index loads of a thread issued
// before the first use); the per-class table (base pointer, strides,
// shifts: 56 bytes a class) is a kernel argument, copied by thread 0 into
// shared memory, since the class of neighbouring entries differs and a
// dynamic index into the argument space would spill it to local memory.
// The grid is one wave of the blocks the SMs hold at once (at 48
// registers a thread, five blocks of 256 an SM), so no second wave runs
// a short tail.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;
constexpr int CLASSES = 16;

struct Slot {
    double* base;
    long long stride[4];
    int shift[4];
};

struct Table {
    Slot slot[CLASSES];
};

__device__ __forceinline__ void load4(const short4* __restrict__ idx,
                                      long long e, int (&q)[4])
{
    const short4 v = __ldg(idx + e);
    q[0] = v.x;
    q[1] = v.y;
    q[2] = v.z;
    q[3] = v.w;
}

__global__ void __launch_bounds__(THREADS)
block_scatter_kernel(const short4* __restrict__ idx,
                     const double* __restrict__ vals, long long nnz,
                     int n_p, int no, Table t,
                     unsigned long long* __restrict__ bad)
{
    __shared__ Slot s[CLASSES];
    if (threadIdx.x == 0) {
#pragma unroll
        for (int c = 0; c < CLASSES; ++c) s[c] = t.slot[c];
    }
    __syncthreads();
    const long long step = static_cast<long long>(gridDim.x) * THREADS;
    for (long long e0 = static_cast<long long>(blockIdx.x) * THREADS
                        + threadIdx.x; e0 < nnz; e0 += UNROLL * step) {
        int q[UNROLL][4];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const long long e = e0 + u * step;
            if (e < nnz) load4(idx, e, q[u]);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const long long e = e0 + u * step;
            if (e >= nnz) break;
            int c = 0;
            bool in = true;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                in &= static_cast<unsigned>(q[u][k])
                      < static_cast<unsigned>(n_p);
                c = (c << 1) | (q[u][k] < no);
            }
            if (!in) {
                atomicAdd(bad, 1ULL);
                continue;
            }
            const Slot& b = s[c];
            if (b.base == nullptr) continue;
            long long off = 0;
#pragma unroll
            for (int k = 0; k < 4; ++k)
                off += static_cast<long long>(q[u][k] - b.shift[k])
                       * b.stride[k];
            b.base[off] = __ldg(vals + e);
        }
    }
}

}  // namespace

// idx: nnz rows of 4 int16 (8 bytes, 8-byte aligned); vals: nnz doubles;
// base: 16 block pointers by class (null: drop); stride, shift: 4 a
// class; bad: one zeroed counter.  The grid is one wave of resident
// blocks (or fewer, for a short list).
extern "C" int pymes_block_scatter(const void* idx, const double* vals,
                                   long long nnz, int n_p, int no,
                                   void* const* base,
                                   const long long* stride,
                                   const int* shift,
                                   unsigned long long* bad,
                                   cudaStream_t stream)
{
    Table t;
    for (int c = 0; c < CLASSES; ++c) {
        t.slot[c].base = static_cast<double*>(base[c]);
        for (int k = 0; k < 4; ++k) {
            t.slot[c].stride[k] = stride[4 * c + k];
            t.slot[c].shift[k] = shift[4 * c + k];
        }
    }
    int dev, sms, per_sm;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, block_scatter_kernel, THREADS, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long need = (nnz + THREADS - 1) / THREADS;
    const int grid = static_cast<int>(
        need < static_cast<long long>(per_sm) * sms ? need : per_sm * sms);
    block_scatter_kernel<<<grid, THREADS, 0, stream>>>(
        static_cast<const short4*>(idx), vals, nnz, n_p, no, t, bad);
    return static_cast<int>(cudaGetLastError());
}
