// K1: momentum-sector ladder GEMM for the UEG CCD residual (sm_90a), in
// f64 on the tensor cores and, for the f32 sigmas and ground-state bulk of
// the precision modes, in f32 on the CUDA cores (namespace f32k below).
//
// Replaces B1 of the JAX package: pymes_tpu/ops/ueg_ladder.py:450
// block_ladder_apply_ij (and its integer-MXU form block_ladder_apply_ij_ozaki,
// :533 / _block_ozaki_rows, :517).  For every bucket group g, sector s and
// padded bra row m with bra_of_row[s,m] >= 0:
//
//   outT[bra_of_row[s,m], x] = sum_{k < mK} blocks[s,m,k] * Tt[perm_ket[s,k], x]
//
// for all x < N.  Every bra pair is the row of exactly one sector, so rows
// map one-to-one onto output rows and no atomics are needed; rows that no
// sector holds (a bra momentum with no ket pair) are listed in zero_rows
// and written as zeros by the same launch.
//
// Layout.  The amplitudes arrive cd-major, Tt = (nv*nv, N) with row stride
// ldt >= N: a ket pair's N amplitudes are contiguous, so the perm_ket
// gather that builds the B tile reads whole rows.  The output is written
// bra-major, outT = (n_rows, N).  The perm_ket gather is fused into the
// B-tile load and the inv_bra permutation into the store.
//
// What bounds it on an H100: the sector blocks (27 MB at nP=219) are read
// once, and T in, the output out (17.6 MB each at N = 49): 0.019 ms of
// HBM at 3.35 TB/s against 0.33 GFLOP, 0.005 ms on the f64 tensor cores.
// Bytes bind at every N the solvers use (N = 49, 98, and the FEAST lane
// batch 6272, where T and the output dominate), provided the products run
// on the tensor cores and the loads keep HBM busy.  (Measured on an H100,
// the kernel stays at about 40 % of that bound: PERF.md.)
//
// Design:
// * DMMA: mma.sync.aligned.m16n8k8.row.col.f64.  A is the sector block,
//   k-contiguous rows (mK is a multiple of 8 under the "fine" padding);
//   B the perm_ket-gathered rows of Tt, k-major in shared memory.  Shared
//   rows are padded (A to 36 doubles, B to 8 NT + 4) so the fragment
//   loads are free of bank conflicts.
// * A block has 4 consumer warps; a warp owns one m16 slot of a work unit
//   and all 8 NT columns of the block's column tile (NT = 7 at N = 49: 56
//   columns, not 64).  A unit is up to 4 slots of ONE bucket: four m16
//   tiles of one sector (its ket panel gathered once per 64 rows), or the
//   leftover tiles of up to 4 sectors, each with its own panel (so 8- and
//   16-row buckets fill the block).  A stage holds 32 k rows of B split
//   evenly among the unit's panels (32, 16 or 8 each) and the matching
//   k columns of A.
// * A ring of shared stages, filled by four producer warps with 16-byte
//   cp.async (8-byte copies where a Tt row is only 8-byte aligned: an odd
//   ldt) completing on per-stage full mbarriers (async_copy.cuh); the
//   consumer warps release a stage through its empty mbarrier.  The block
//   is persistent over its bin of units: the producers run on into the
//   next unit while the consumers finish the last, so small sectors do
//   not drain the pipeline.
// * The units, the ket row of every B row of every stage, and their bins
//   (one bin per SM, balanced by bytes, largest first) are planned in
//   Python at plan-build time (kernels/block_ladder.py plan_units), the
//   column tile per N at launch (plan).  So no copy waits on a dependent
//   load: the producers hold 16 unit descriptors and 32 stage-table rows
//   in shared memory, and copy each unit's descriptor and bra ids into
//   the header of its first stage, where the consumers read them.  One
//   block per bin, which walks its units once per column tile, so the
//   ring runs on across tiles (the FEAST lane batch has 49 tiles of 128
//   columns and about one unit a bin).
// * A row's sum is the sequence of its k8 DMMA steps in k order from
//   zero, whatever unit, slot or shard holds it, so reruns and the
//   sector-sharded plan give the same bits.

#include <cstdint>
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

using pymes::aligned16;

constexpr int CW = 4;                       // consumer warps = m16 slots
constexpr int PTHREADS = 128;               // four producer warps
constexpr int PW = PTHREADS / 32;
constexpr int NTHREADS = 32 * CW + PTHREADS;
constexpr int BM = 16 * CW;                 // A rows of a stage
constexpr int TK = 32;                      // B rows of a stage
constexpr int LDA = TK + 4;                 // padded A row, doubles
constexpr int UNIT = 20;                    // ints of a work unit
constexpr int HDR = 44;                     // a stage's unit header, doubles
constexpr int SMEM_BUDGET = 227 * 1024;     // a block's shared memory
constexpr int MAX_STAGES = 6;
constexpr int KCH = 32;                     // stage-table rows held
constexpr int UCH = 16;                     // unit descriptors held
constexpr int KET_BYTES = 4 * TK * KCH;     // TK / PW columns a warp
constexpr int UDESC_BYTES = 4 * UNIT * UCH;

// A unit's descriptor (kernels/block_ladder.py _unit_rows): [0] mK, [1]
// kd, [2] stages, [4 + w] slot w's first A element, [8 + w] its live rows
// (0: idle), [12 + w] its first bra_of_row entry, [16 + w] its panel's
// first B row.  The producers copy it, and the 16 bra ids of each busy
// slot, into the header of the unit's first stage, so the consumers read
// both from shared memory.
template <int NT>
__host__ __device__ constexpr int ldb() { return 8 * NT + 4; }

template <int NT>
__host__ __device__ constexpr int stage_doubles()
{
    return BM * LDA + TK * ldb<NT>() + HDR;
}

template <int NT>
__host__ __device__ constexpr int n_stages()
{
    return (SMEM_BUDGET - KET_BYTES - UDESC_BYTES - 256)
        / (8 * stage_doubles<NT>()) < MAX_STAGES
        ? (SMEM_BUDGET - KET_BYTES - UDESC_BYTES - 256)
            / (8 * stage_doubles<NT>())
        : MAX_STAGES;
}

// the stage ring, the producers' stage-table rows and unit descriptors,
// the mbarriers
template <int NT>
constexpr int smem_bytes()
{
    return 8 * n_stages<NT>() * stage_doubles<NT>() + KET_BYTES
        + UDESC_BYTES
        + 2 * n_stages<NT>() * static_cast<int>(sizeof(uint64_t));
}

struct Args {
    const double* Tt; long long ldt;
    const double* blocks;
    const int* bra;                         // 16 entries of padding after
    const int* units;                       // (n_units, UNIT)
    const int* stages;                      // (n_stages, TK) ket rows
    const int* bins;                        // (n_bins + 1, 2)
    const int* zero_rows; int n_zero;
    double* out; int N;
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

__device__ __forceinline__ void producers_sync()
{
    asm volatile("bar.sync 1, %0;" :: "n"(PTHREADS) : "memory");
}

// The producer warps (thread p of PTHREADS) fill the bin's stages in
// order, each once the consumers have released its slot.  A thread copies
// a fixed 16-byte column of 8 of the 64 A rows, and warp wp the TK / PW B
// rows [wp TK / PW, (wp + 1) TK / PW), its lanes along each row.  They
// hold UCH unit descriptors and (each warp its columns of) KCH rows of
// the planned stage table in shared memory, loaded together, so no copy
// waits on a load of its own.
template <int NT>
__device__ void produce(const Args& a, double* smem, int* kets, int* udesc,
                        uint64_t* full, uint64_t* empty, int u0, int u1,
                        int st0, int st1, int p)
{
    constexpr int SD = stage_doubles<NT>(), S = n_stages<NT>();
    constexpr int LDB = ldb<NT>(), RPW = TK / PW;
    constexpr int ROWS_A = BM * 16 / PTHREADS;
    const int lane = p & 31, wp = p >> 5;
    const int ac = 2 * (p & 15), ar = p >> 4;   // A column, first row
    const int nu = u1 - u0, n_it = nu * ((a.N + 8 * NT - 1) / (8 * NT));
    kets += wp * RPW * KCH;
    int k_first = 0, d_first = -UCH;            // stage, unit of row 0
    int st = 0, ring = 0;
    for (int it = 0; it < n_it; ++it) {
        const int w = it % nu;                  // the unit, in the bin
        const int n0 = it / nu * 8 * NT;
        const int ncols = min(8 * NT, a.N - n0);
        const bool t_al = aligned16(a.Tt + n0) && a.ldt % 2 == 0;
        if (w == 0) {                           // the bin again, next tile
            st = st0;
            k_first = st0 - KCH;
        }
        if (w < d_first || w - d_first >= UCH) {
            producers_sync();
            for (int e = p; e < UCH * UNIT; e += PTHREADS) {
                const int uu = w + e / UNIT;
                udesc[e] = uu < nu
                    ? __ldg(a.units + static_cast<long long>(u0 + uu) * UNIT
                            + e % UNIT) : 0;
            }
            producers_sync();
            d_first = w;
        }
        const int* U = udesc + (w - d_first) * UNIT;
        const int mK = U[0], kd = U[1], nst = U[2];
        int a_off[CW], alive[CW];
#pragma unroll
        for (int s4 = 0; s4 < CW; ++s4) {
            a_off[s4] = U[4 + s4];
            alive[s4] = U[8 + s4];
        }
        for (int t = 0; t < nst; ++t, ++st, ++ring) {
            if (st - k_first == KCH) {
                // lane l: column l % RPW of rows st + l / RPW + i 32 / RPW
                k_first = st;
                constexpr int STEP = 32 / RPW;
                int v[KCH / STEP];
#pragma unroll
                for (int i = 0; i < KCH / STEP; ++i) {
                    const int row = st + lane / RPW + STEP * i;
                    v[i] = row < st1 ? __ldg(a.stages + row * TK + wp * RPW
                                             + lane % RPW) : -1;
                }
#pragma unroll
                for (int i = 0; i < KCH / STEP; ++i)
                    kets[(lane / RPW + STEP * i) * RPW + lane % RPW] = v[i];
                __syncwarp();
            }
            int kr[RPW];
#pragma unroll
            for (int i = 0; i < RPW; ++i)
                kr[i] = kets[(st - k_first) * RPW + i];
            const int k0 = t * kd, kv = min(kd, mK - k0);
            const int slot = ring % S;
            pymes::mbar_wait(&empty[slot], ((ring / S) & 1) ^ 1);
            double* As = smem + slot * SD;
            double* Bs = As + BM * LDA;
            if (t == 0 && wp == 0) {
                // the unit's header: its descriptor, each busy slot's rows'
                // bra ids (16-byte aligned: offsets are multiples of 8)
                int* hdr = reinterpret_cast<int*>(Bs + TK * LDB);
                if (lane < UNIT / 4) {
                    pymes::cp_async16(hdr + 4 * lane,
                                      a.units + static_cast<long long>(u0 + w)
                                          * UNIT + 4 * lane);
                } else if (lane >= 8 && lane < 8 + 4 * CW) {
                    const int s4 = (lane - 8) / 4, c = 4 * ((lane - 8) % 4);
                    if (U[8 + s4] > 0)
                        pymes::cp_async16(hdr + UNIT + 16 * s4 + c,
                                          a.bra + U[12 + s4] + c);
                }
            }
            if (ac < kv) {
#pragma unroll
                for (int i = 0; i < ROWS_A; ++i) {
                    // row ar + 8 i of the stage: slot i / 2, row of slot
                    const int w4 = i / 2, m = ar + 8 * (i % 2);
                    if (m < alive[w4])
                        pymes::cp_async16(
                            As + (16 * w4 + m) * LDA + ac,
                            a.blocks + a_off[w4]
                                + static_cast<long long>(m) * mK + k0 + ac);
                }
            }
#pragma unroll
            for (int i = 0; i < RPW; ++i) {
                if (kr[i] < 0) continue;
                const double* src = a.Tt + a.ldt * kr[i] + n0;
                double* dst = Bs + (wp * RPW + i) * LDB;
                if (t_al) {
#pragma unroll
                    for (int c = 2 * lane; c < 8 * NT; c += 64) {
                        if (c + 1 < ncols) pymes::cp_async16(dst + c, src + c);
                        else if (c < ncols) pymes::cp_async8(dst + c, src + c);
                    }
                } else {
#pragma unroll
                    for (int c = lane; c < 8 * NT; c += 32)
                        if (c < ncols) pymes::cp_async8(dst + c, src + c);
                }
            }
            pymes::cp_async_arrive_noinc(&full[slot]);
        }
    }
}

// Consumer warp `warp`: its slot of every unit of the bin, the unit's
// fields and its rows' bra ids read from the header of the unit's first
// stage, products of each stage into registers, then the store.
template <int NT>
__device__ void consume(const Args& a, const double* smem, uint64_t* full,
                        uint64_t* empty, int u0, int u1, int warp, int lane)
{
    constexpr int SD = stage_doubles<NT>(), S = n_stages<NT>();
    constexpr int LDB = ldb<NT>();
    const int g8 = lane >> 2, t = lane & 3;
    const int nu = u1 - u0, n_it = nu * ((a.N + 8 * NT - 1) / (8 * NT));
    int u = 0;
    for (int it = 0; it < n_it; ++it) {
        const int n0 = it / nu * 8 * NT;
        pymes::mbar_wait(&full[u % S], (u / S) & 1);
        const int* hdr = reinterpret_cast<const int*>(
            smem + (u % S) * SD + BM * LDA + TK * LDB);
        const int mK = hdr[0], kd = hdr[1], nst = hdr[2];
        const int alive = hdr[8 + warp], b_row = hdr[16 + warp];
        const int b0 = g8 < alive ? hdr[UNIT + 16 * warp + g8] : -1;
        const int b1 = g8 + 8 < alive ? hdr[UNIT + 16 * warp + g8 + 8] : -1;
        double acc[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][e] = 0.0;
        for (int st = 0; st < nst; ++st, ++u) {
            const int slot = u % S;
            if (st > 0) pymes::mbar_wait(&full[slot], (u / S) & 1);
            if (alive > 0) {
                const double* As = smem + slot * SD + 16 * warp * LDA;
                const double* Bs = smem + slot * SD + BM * LDA + b_row * LDB;
                const int kv = min(kd, mK - st * kd);
                for (int ks = 0; ks < kv; ks += 8) {
                    double av[4];
#pragma unroll
                    for (int q = 0; q < 2; ++q)
#pragma unroll
                        for (int h = 0; h < 2; ++h)
                            av[2 * q + h] =
                                As[(g8 + 8 * h) * LDA + ks + t + 4 * q];
#pragma unroll
                    for (int j = 0; j < NT; ++j) {
                        double bv[2];
#pragma unroll
                        for (int q = 0; q < 2; ++q)
                            bv[q] = Bs[(ks + t + 4 * q) * LDB + 8 * j + g8];
                        dmma(acc[j], av, bv);
                    }
                }
            }
            __syncwarp();
            if (lane == 0) pymes::mbar_arrive(&empty[slot]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int b = h ? b1 : b0;
            if (b < 0) continue;
            double* orow = a.out + static_cast<long long>(b) * a.N;
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int n = n0 + 8 * j + 2 * t + e;
                    if (n < a.N) orow[n] = acc[j][2 * h + e];
                }
        }
    }
}

// Block x: the units of bin x on each column tile of 8 NT columns in turn,
// and zeros on every gridDim.x-th row of zero_rows.
template <int NT>
__global__ void __launch_bounds__(NTHREADS, 1) block_ladder_kernel(Args a)
{
    constexpr int SD = stage_doubles<NT>(), S = n_stages<NT>();
    extern __shared__ __align__(128) double smem[];
    int* kets = reinterpret_cast<int*>(smem + S * SD);
    int* udesc = kets + KET_BYTES / 4;
    uint64_t* full = reinterpret_cast<uint64_t*>(udesc + UDESC_BYTES / 4);
    uint64_t* empty = full + S;
    for (int z = blockIdx.x; z < a.n_zero; z += gridDim.x) {
        double* orow = a.out + static_cast<long long>(a.zero_rows[z]) * a.N;
        for (int c = threadIdx.x; c < a.N; c += NTHREADS) orow[c] = 0.0;
    }
    const int u0 = a.bins[2 * blockIdx.x], u1 = a.bins[2 * blockIdx.x + 2];
    if (u0 == u1) return;
    if (threadIdx.x == 0) {
        for (int s = 0; s < S; ++s) {
            pymes::mbar_init(&full[s], PTHREADS);
            pymes::mbar_init(&empty[s], CW);
        }
    }
    __syncthreads();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (warp >= CW)
        produce<NT>(a, smem, kets, udesc, full, empty, u0, u1,
                    a.bins[2 * blockIdx.x + 1], a.bins[2 * blockIdx.x + 3],
                    threadIdx.x - 32 * CW);
    else
        consume<NT>(a, smem, full, empty, u0, u1, warp, lane);
}

template <int NT>
cudaError_t launch(const Args& a, int n_bins, cudaStream_t stream)
{
    // set on every launch: the attribute belongs to the current device
    cudaError_t err = cudaFuncSetAttribute(
        block_ladder_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes<NT>());
    if (err != cudaSuccess) return err;
    block_ladder_kernel<NT><<<n_bins, NTHREADS, smem_bytes<NT>(), stream>>>(
        a);
    return cudaGetLastError();
}

// ---- f32 ----------------------------------------------------------------
//
// The f32 kernel: the same function on float amplitudes and sector blocks
// (a plan in f32), f32 sums.  DMMA has no f32 form, and the tensor cores
// take f32 only as TF32 (about three decimal digits), which the f32 solves
// of the precision modes cannot use, so the products run as FFMA on the
// CUDA cores (67 TFLOP/s f32 on an H100 SXM5).
//
// What bounds it.  At the FEAST nP=57 lane batch (N = 6272) the bytes
// (T read, the output written: 144 MB, 0.043 ms at 3.35 TB/s) take three
// times the flops at the FFMA rate (0.92 GFLOP, 0.014 ms), so the kernel
// stays bytes-bound as long as the FFMA loop runs at a third of its peak
// and the loads keep HBM busy.  At N = 49 (nP=219) the blocks weigh most
// (14 of the 32 MB), and the latency of a unit's few stages.  (Measured
// on an H100: 53-55 % of the byte bound at N = 3136 and 6272, 29-35 % at
// N = 98 and 49, there faster than the f64 DMMA kernel: PERF.md.)
//
// Design, against what held the first form (synchronous loads, scalar
// shared loads, four-byte stores, one block an SM at narrow widths):
// * Work items, planned in Python (kernels/block_ladder.py f32_plan, per
//   plan and width): an item is one unit of the plan (plan_units: up to
//   four m16 slots, one ket panel each) on one column tile of NC = 64 or
//   128 columns.  The items are dealt largest first onto the least loaded
//   of two bins an SM, so the column tiles of a large unit spread over the
//   card and no bin is empty.  An item's record (REC ints) holds all that
//   its copies need (first stage-table row, n0, the unit's fields), so no
//   copy waits on a dependent load but the stage table's ket ids; the
//   producers load the next item's record while they issue this one's.
// * A ring of shared stages (3 to 6 of them), filled by four producer
//   warps with 16-byte cp.async (4-byte copies where a Tt row is not
//   16-byte aligned: ldt % 4 or the base) completing on per-stage full
//   mbarriers; the four consumer warps release a stage through its empty
//   mbarrier.  The block is persistent over its bin: the producers run on
//   into the next item while the consumers finish the last.  A stage holds
//   the item's record and its slots' bra ids (first stage of an item), the
//   A columns of its slots (k-contiguous rows, padded to LDA = 36 floats)
//   and TK gathered ket rows of Tt (NC columns).
// * Register tile: a consumer warp owns one slot (16 rows) and the tile's
//   NC columns; lane (rg, cg) = (lane / 8, lane % 8) holds rows rg + 4 i
//   (i < 4) and the column runs 4 cg + 32 j .. + 3: 32 (NC = 64) or 64
//   (NC = 128) accumulators.  Per 4 k a lane loads its 4 rows' A as four
//   16-byte words (4 k of one row each) and, per k, one 16-byte word a
//   column run: 2.7 (NC = 64) or 3.2 (NC = 128) FFMA per loaded word.  The
//   rows a lane reads lie LDA = 36 (4 mod 32 banks) apart and the eight
//   lanes of a quarter warp read 128 contiguous bytes of a B row, so the
//   shared loads are free of bank conflicts.  (Two consumer warps a slot
//   at NC = 128, 32 accumulators each, spilled under the register cap of
//   two blocks an SM and ran slower.)
// * Stores: where N % 4 == 0 a lane stores its column runs as 16-byte
//   words (eight lanes, 128 contiguous bytes of a row), scalars past N.
//   Else each row of the warp's slot goes through a shared staging row
//   shifted by the row's misalignment, and leaves as 16-byte words with
//   scalar heads and tails.  Zero rows are written by the blocks in turn, in the
//   same launch, the same way.
// * A row's sum runs over k in order from zero, one fmaf a k, whatever
//   item, slot, tile or shard holds it: reruns and the sector-sharded plan
//   give the same bits.

namespace f32k {

constexpr int CW = 4;                       // consumer warps = m16 slots
constexpr int PT = 128;                     // four producer warps
constexpr int NTH = 32 * CW + PT;
constexpr int TK = 32;                      // B rows of a stage (the plan's)
constexpr int LDA = TK + 4;                 // padded A row, floats
constexpr int REC = 24;                     // ints of an item record
constexpr int HDR = REC + 16 * CW;          // ints of a stage's header
constexpr int BLOCK_SMEM = 113 * 1024;      // two blocks an SM
constexpr int MAX_STAGES = 6;

// An item record (kernels/block_ladder.py f32_plan): [0] its first row of
// the stage table, [1] n0, [2] mK, [3] kd, [4] stages, [5] the unit,
// [8 + w] slot w's first A element, [12 + w] its live rows (0: idle),
// [16 + w] its first bra_of_row entry, [20 + w] its panel's first B row.

template <int NC>
__host__ __device__ constexpr int stage_floats()
{
    return HDR + 64 * LDA + TK * NC;
}

template <int NC, bool STAGED>
__host__ __device__ constexpr int staging_floats()
{
    return STAGED ? CW * 16 * (NC + 4) + CW * 16 : 0;
}

template <int NC, bool STAGED>
__host__ __device__ constexpr int n_stages()
{
    return (BLOCK_SMEM - 4 * staging_floats<NC, STAGED>() - 256)
        / (4 * stage_floats<NC>()) < MAX_STAGES
        ? (BLOCK_SMEM - 4 * staging_floats<NC, STAGED>() - 256)
            / (4 * stage_floats<NC>())
        : MAX_STAGES;
}

template <int NC, bool STAGED>
constexpr int smem_bytes()
{
    return 4 * (n_stages<NC, STAGED>() * stage_floats<NC>()
                + staging_floats<NC, STAGED>())
        + 2 * n_stages<NC, STAGED>() * static_cast<int>(sizeof(uint64_t));
}

struct Args {
    const float* Tt; long long ldt; int vec4;
    const float* blocks;
    const int* bra;                         // 16 entries of padding after
    const int* items;                       // (n_items, REC), bin by bin
    const int* stages;                      // (n_stages, TK) ket rows
    const int* bins;                        // (n_bins + 1): first item
    const int* zero_rows; int n_zero;
    float* out; int N;
};

// An item record's first 20 ints, as the producers read them.
struct Rec {
    int4 h;                                 // first stage row, n0, mK, kd
    int4 s;                                 // stages, unit
    int4 off, live, bra;                    // per slot
};

__device__ __forceinline__ Rec load_rec(const int* items, int it)
{
    const int4* R = reinterpret_cast<const int4*>(
        items + static_cast<long long>(it) * REC);
    return {__ldg(R), __ldg(R + 1), __ldg(R + 2), __ldg(R + 3),
            __ldg(R + 4)};
}

// Producer thread p of PT: per stage, chunk p % 8 (4 k) of A rows p / 8 +
// 16 i (slot i), and chunk p % (NC / 4) of B rows p / (NC / 4) + RPP i.
template <int NC, bool STAGED>
__device__ void produce(const Args& a, float* smem, uint64_t* full,
                        uint64_t* empty, int i0, int i1, int p)
{
    constexpr int SD = stage_floats<NC>(), S = n_stages<NC, STAGED>();
    constexpr int CPR = NC / 4, RPP = PT / CPR, NPASS = TK / RPP;
    const int bc = 4 * (p % CPR), br = p / CPR;
    const int ac = 4 * (p & 7), ar = p >> 3;
    int ring = 0;
    // the next item's record is loaded while this item's stages are
    // issued, so an item's first copies wait only on its ket ids
    Rec cur = i0 < i1 ? load_rec(a.items, i0) : Rec{};
    for (int it = i0; it < i1; ++it) {
        const Rec nxt = it + 1 < i1 ? load_rec(a.items, it + 1) : cur;
        const int* R = a.items + static_cast<long long>(it) * REC;
        const int st0 = cur.h.x, n0 = cur.h.y, mK = cur.h.z, kd = cur.h.w;
        const int nst = cur.s.x;
        const int a_off[CW] = {cur.off.x, cur.off.y, cur.off.z, cur.off.w};
        const int alive[CW] = {cur.live.x, cur.live.y, cur.live.z,
                               cur.live.w};
        const int bra_off[CW] = {cur.bra.x, cur.bra.y, cur.bra.z,
                                 cur.bra.w};
        const int ncols = min(NC, a.N - n0);
        for (int t = 0; t < nst; ++t, ++ring) {
            // the ket ids first: their load overlaps the wait for a slot
            int kr[NPASS];
            const int* srow = a.stages + static_cast<long long>(st0 + t) * TK
                + br;
#pragma unroll
            for (int i = 0; i < NPASS; ++i) kr[i] = __ldg(srow + RPP * i);
            const int slot = ring % S;
            pymes::mbar_wait(&empty[slot], ((ring / S) & 1) ^ 1);
            float* stg = smem + slot * SD;
            float* As = stg + HDR;
            float* Bs = As + 64 * LDA;
            if (t == 0) {
                int* hdr = reinterpret_cast<int*>(stg);
                if (p < REC / 4) {
                    pymes::cp_async16(hdr + 4 * p, R + 4 * p);
                } else if (p >= 8 && p < 8 + 4 * CW) {
                    const int w = (p - 8) / 4, c = 4 * ((p - 8) % 4);
                    if (alive[w] > 0)
                        pymes::cp_async16(hdr + REC + 16 * w + c,
                                          a.bra + bra_off[w] + c);
                }
            }
            const int k0 = t * kd, kv = min(kd, mK - k0);
            if (ac < kv) {
#pragma unroll
                for (int w = 0; w < CW; ++w)
                    if (ar < alive[w])
                        pymes::cp_async16(
                            As + (16 * w + ar) * LDA + ac,
                            a.blocks + a_off[w]
                                + static_cast<long long>(ar) * mK + k0 + ac);
            }
#pragma unroll
            for (int i = 0; i < NPASS; ++i) {
                if (kr[i] < 0 || bc >= ncols) continue;
                const float* src = a.Tt + a.ldt * kr[i] + n0 + bc;
                float* dst = Bs + (br + RPP * i) * NC + bc;
                if (a.vec4 && bc + 4 <= ncols) {
                    pymes::cp_async16(dst, src);
                } else {
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        if (bc + e < ncols) pymes::cp_async4(dst + e, src + e);
                }
            }
            pymes::cp_async_arrive_noinc(&full[slot]);
        }
        cur = nxt;
    }
}

// One row of the output: columns [0, n) of out + off, a 16-byte word
// where the address allows, from src (shifted by the row's misalignment
// h: src[h + c] is column c); lanes `lane` of `nl`.
__device__ __forceinline__ void store_row(float* out, long long off,
                                          const float* src, int h, int n,
                                          int lane, int nl)
{
    for (int q = lane; 4 * q < n + h; q += nl) {
        const int lo = 4 * q - h;
        float* dst = out + off + lo;
        if (lo >= 0 && lo + 4 <= n) {
            *reinterpret_cast<float4*>(dst) =
                *reinterpret_cast<const float4*>(src + 4 * q);
        } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
                if (lo + e >= 0 && lo + e < n) dst[e] = src[4 * q + e];
        }
    }
}

// Consumer warp w: its slot of every item of the bin.
template <int NC, bool STAGED>
__device__ void consume(const Args& a, const float* smem, float* staging,
                        uint64_t* full, uint64_t* empty, int i0, int i1,
                        int w, int lane)
{
    constexpr int SD = stage_floats<NC>(), S = n_stages<NC, STAGED>();
    constexpr int NJ = NC / 32, LDS = NC + 4;
    const int rg = lane >> 3, cg = lane & 7;
    float* sw = staging + w * 16 * LDS;             // STAGED only
    int* sbra = reinterpret_cast<int*>(staging + CW * 16 * LDS) + 16 * w;
    int u = 0;
    for (int it = i0; it < i1; ++it) {
        pymes::mbar_wait(&full[u % S], (u / S) & 1);
        const int* hdr = reinterpret_cast<const int*>(smem + (u % S) * SD);
        const int n0 = hdr[1], mK = hdr[2], kd = hdr[3], nst = hdr[4];
        const int alive = hdr[12 + w], b_row = hdr[20 + w];
        int bra[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
            bra[i] = rg + 4 * i < alive ? hdr[REC + 16 * w + rg + 4 * i] : -1;
        float acc[4][NJ][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
        for (int st = 0; st < nst; ++st, ++u) {
            const int slot = u % S;
            if (st > 0) pymes::mbar_wait(&full[slot], (u / S) & 1);
            if (alive > 0) {
                const float* As = smem + slot * SD + HDR + 16 * w * LDA
                    + rg * LDA;
                const float* Bs = smem + slot * SD + HDR + 64 * LDA
                    + b_row * NC + 4 * cg;
                const int kv = min(kd, mK - st * kd);
#pragma unroll 2
                for (int kk = 0; kk < kv; kk += 4) {
                    float4 av[4];
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                        av[i] = *reinterpret_cast<const float4*>(
                            As + 4 * i * LDA + kk);
#pragma unroll
                    for (int kq = 0; kq < 4; ++kq) {
                        float4 bv[NJ];
#pragma unroll
                        for (int j = 0; j < NJ; ++j)
                            bv[j] = *reinterpret_cast<const float4*>(
                                Bs + (kk + kq) * NC + 32 * j);
#pragma unroll
                        for (int i = 0; i < 4; ++i) {
                            const float x = kq == 0 ? av[i].x
                                : kq == 1 ? av[i].y
                                : kq == 2 ? av[i].z : av[i].w;
#pragma unroll
                            for (int j = 0; j < NJ; ++j) {
                                acc[i][j][0] = fmaf(x, bv[j].x, acc[i][j][0]);
                                acc[i][j][1] = fmaf(x, bv[j].y, acc[i][j][1]);
                                acc[i][j][2] = fmaf(x, bv[j].z, acc[i][j][2]);
                                acc[i][j][3] = fmaf(x, bv[j].w, acc[i][j][3]);
                            }
                        }
                    }
                }
            }
            __syncwarp();
            if (lane == 0) pymes::mbar_arrive(&empty[slot]);
        }
        const int ncols = min(NC, a.N - n0);
        if constexpr (!STAGED) {
            // N % 4 == 0: every row and column run is 16-byte aligned
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                if (bra[i] < 0) continue;
                float* orow = a.out + static_cast<long long>(bra[i]) * a.N
                    + n0;
#pragma unroll
                for (int j = 0; j < NJ; ++j) {
                    const int c = 4 * cg + 32 * j;
                    if (c + 4 <= ncols) {
                        *reinterpret_cast<float4*>(orow + c) = make_float4(
                            acc[i][j][0], acc[i][j][1], acc[i][j][2],
                            acc[i][j][3]);
                    } else {
#pragma unroll
                        for (int e = 0; e < 4; ++e)
                            if (c + e < ncols) orow[c + e] = acc[i][j][e];
                    }
                }
            }
        } else {
            // the slot's rows through the staging rows, each shifted by
            // its misalignment h, then out in 16-byte words
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int r = rg + 4 * i;
                const int h = bra[i] < 0 ? 0 : static_cast<int>(
                    (static_cast<long long>(bra[i]) * a.N + n0) & 3);
                float* srow = sw + r * LDS + h + 4 * cg;
#pragma unroll
                for (int j = 0; j < NJ; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        srow[32 * j + e] = acc[i][j][e];
                if (cg == 0) sbra[r] = bra[i];
            }
            __syncwarp();
            // half a warp a row, two rows at a time
            for (int r = lane >> 4; r < 16; r += 2) {
                const int b = sbra[r];
                if (b < 0) continue;
                const long long off = static_cast<long long>(b) * a.N + n0;
                store_row(a.out, off, sw + r * LDS,
                          static_cast<int>(off & 3), ncols, lane & 15, 16);
            }
            __syncwarp();
        }
    }
}

// Block x: the items of bin x, and zeros on every gridDim.x-th zero row.
template <int NC, bool STAGED>
__global__ void __launch_bounds__(NTH, 2) block_ladder_f32_kernel(Args a)
{
    constexpr int SD = stage_floats<NC>(), S = n_stages<NC, STAGED>();
    extern __shared__ __align__(128) float fsmem[];
    float* staging = fsmem + S * SD;
    uint64_t* full = reinterpret_cast<uint64_t*>(
        staging + staging_floats<NC, STAGED>());
    uint64_t* empty = full + S;
    if (threadIdx.x == 0) {
        for (int s = 0; s < S; ++s) {
            pymes::mbar_init(&full[s], PT);
            pymes::mbar_init(&empty[s], CW);
        }
    }
    // zero rows: 16-byte words where the row allows, a warp a row
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int z = blockIdx.x * (NTH / 32) + warp; z < a.n_zero;
         z += gridDim.x * (NTH / 32)) {
        const long long off = static_cast<long long>(a.zero_rows[z]) * a.N;
        const int h = static_cast<int>(off & 3);
        for (int q = lane; 4 * q < a.N + h; q += 32) {
            const int lo = 4 * q - h;
            float* dst = a.out + off + lo;
            if (lo >= 0 && lo + 4 <= a.N) {
                *reinterpret_cast<float4*>(dst) = zero;
            } else {
                for (int e = 0; e < 4; ++e)
                    if (lo + e >= 0 && lo + e < a.N) dst[e] = 0.0f;
            }
        }
    }
    __syncthreads();
    const int i0 = a.bins[blockIdx.x], i1 = a.bins[blockIdx.x + 1];
    if (warp >= CW)
        produce<NC, STAGED>(a, fsmem, full, empty, i0, i1,
                            threadIdx.x - 32 * CW);
    else
        consume<NC, STAGED>(a, fsmem, staging, full, empty, i0, i1, warp,
                            lane);
}

template <int NC, bool STAGED>
cudaError_t launch(const Args& a, int n_bins, cudaStream_t stream)
{
    cudaError_t err = cudaFuncSetAttribute(
        block_ladder_f32_kernel<NC, STAGED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes<NC, STAGED>());
    if (err != cudaSuccess) return err;
    block_ladder_f32_kernel<NC, STAGED>
        <<<n_bins, NTH, smem_bytes<NC, STAGED>(), stream>>>(a);
    return cudaGetLastError();
}

}  // namespace f32k

}  // namespace

// Shared memory of a block at column tile nt (in n8 tiles), or -1 for a
// tile the library was not built for; the wrapper holds its planner to it.
extern "C" int pymes_block_ladder_smem(int nt)
{
    switch (nt) {
        case 1: return smem_bytes<1>();
        case 2: return smem_bytes<2>();
        case 4: return smem_bytes<4>();
        case 7: return smem_bytes<7>();
        case 8: return smem_bytes<8>();
        case 13: return smem_bytes<13>();
        case 16: return smem_bytes<16>();
        default: return -1;
    }
}

// Launch on `stream` with column tiles of nt n8 tiles; returns the
// cudaError_t of the launch (0 = success).
extern "C" int pymes_block_ladder(const double* Tt, long long ldt,
                                  const double* blocks, const int* bra_of_row,
                                  const int* units, const int* stages,
                                  const int* bins, int n_bins,
                                  const int* zero_rows, int n_zero,
                                  double* outT, int N, int nt,
                                  cudaStream_t stream)
{
    if (n_bins <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
    const Args a{Tt, ldt, blocks, bra_of_row, units, stages, bins,
                 zero_rows, n_zero, outT, N};
    switch (nt) {
        case 1: return static_cast<int>(launch<1>(a, n_bins, stream));
        case 2: return static_cast<int>(launch<2>(a, n_bins, stream));
        case 4: return static_cast<int>(launch<4>(a, n_bins, stream));
        case 7: return static_cast<int>(launch<7>(a, n_bins, stream));
        case 8: return static_cast<int>(launch<8>(a, n_bins, stream));
        case 13: return static_cast<int>(launch<13>(a, n_bins, stream));
        case 16: return static_cast<int>(launch<16>(a, n_bins, stream));
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// Shared memory of an f32 block at column tile nc (64 or 128), staged
// stores (N % 4 != 0) or not, or -1 for a tile the library was not built
// for; the wrapper holds its planner to it.
extern "C" int pymes_block_ladder_f32_smem(int nc, int staged)
{
    if (nc == 64) return staged ? f32k::smem_bytes<64, true>()
                                : f32k::smem_bytes<64, false>();
    if (nc == 128) return staged ? f32k::smem_bytes<128, true>()
                                 : f32k::smem_bytes<128, false>();
    return -1;
}

// The f32 kernel: the f32 operand (16-byte copies where vec4), the f32
// blocks, the plan's bra_of_row and stage table, the width's item records
// and bins (kernels/block_ladder.py f32_plan), the zero rows, the f32
// output, its width and column tile; returns the cudaError_t of the launch.
extern "C" int pymes_block_ladder_f32(const float* Tt, long long ldt,
                                      int vec4, const float* blocks,
                                      const int* bra_of_row,
                                      const int* items, const int* stages,
                                      const int* bins, int n_bins,
                                      const int* zero_rows, int n_zero,
                                      float* outT, int N, int nc,
                                      cudaStream_t stream)
{
    if (n_bins <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
    const f32k::Args a{Tt, ldt, vec4, blocks, bra_of_row, items, stages,
                       bins, zero_rows, n_zero, outT, N};
    const bool staged = N % 4 != 0;
    cudaError_t err = cudaErrorInvalidValue;
    if (nc == 64)
        err = staged ? f32k::launch<64, true>(a, n_bins, stream)
                     : f32k::launch<64, false>(a, n_bins, stream);
    else if (nc == 128)
        err = staged ? f32k::launch<128, true>(a, n_bins, stream)
                     : f32k::launch<128, false>(a, n_bins, stream);
    return static_cast<int>(err);
}
