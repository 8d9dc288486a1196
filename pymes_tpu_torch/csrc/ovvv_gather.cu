// K4: the ovvv T1 momentum gather of the matrix-free CCSD dressing and the
// EOM sigmas (sm_90a), f64, and f32 for the f32 sigmas and dressing of the
// precision modes (a kernel of its own, below the f64 one).
//
// Replaces B4 in the JAX package, pymes_tpu/ops/ueg_ladder.py:150-163
// (ovvv_t1_apply_j):
//
//   out[c, p, q, r] = W[p, r] * T1[S[p, q, r], c]      (0 where S < 0)
//
// the contraction sum_s V[p,q,r,s] T1[s,c] of a momentum-structured block
// whose last axis is virtual: momentum conservation fixes s from (p, q, r),
// so the nv^3*no-sized ovvv blocks never exist.  The columns c run over
// batch x no: c = b*no + j reads T1[b, s, j] through explicit strides, so
// the (nv, no) T1 of the CCSD dressing and the (k, nv, no) trial batch of
// the EOM, FEAST and RT sigmas (a strided view of the Krylov rows) are read
// in place.  One multiply per element, as the plain version computes it:
// the two agree bit for bit.
//
// What bounds it on an H100: the output write.  At nP=219 a plan has n =
// 212*212*7 = 314 608 (p, q, r) entries: at 7 columns the output is 17.6 MB
// (5.3 us at 3.35 TB/s); the FEAST nP=57 sigma passes 2*64 trials as 896
// columns (n = 17 500, 125 MB), RT nP=123 2*32 trials as 448 columns (n =
// 94 192, 338 MB).  S (4 B an entry) and W (8 B a (p, r)) are read once for
// all columns, T1 is small and stays on chip.
//
// Design of the f64 gather: a 2-D grid, tiles of THREADS*EPT flat (p, q, r)
// entries x tiles of ct columns, planned in Python (kernels/ovvv_gather.py plan).  A thread
// loads its EPT = 2 S and W entries once into registers, then for each
// column of the tile gathers its T1 values through L1 (T1 is at most a few
// MB and a tile's columns stay on chip; staging the tile in shared memory
// first was no faster on the H100) and stores: consecutive threads store
// consecutive (p, q, r) of one output column, 256 coalesced bytes a warp.
// Where the entry tiles alone fill the card (n = 314 608 at nP=219: 615
// blocks) one tile takes all the columns, so S and W are read and the
// indices computed once; where they do not (the 35 entry tiles of the
// FEAST width) the columns are cut into tiles of 4, about 8 stores a
// thread: on the H100, 4 were too little work for a block and 16 or more
// left too few blocks in flight.
//
// The second entry, the diagonal, fuses the G_vv trace of the CCSD
// dressing (pymes_tpu/solver/ccsd.py:271-274) into the gather:
//
//   axis 1 (vov plan, S (nv, no, nv)):
//     d[p, r] = sum_j W[p, r] T1[S[p, j, r], j]
//   axis 0 (ovv plan, S (no, nv, nv)):
//     d[q, r] = sum_j W[j, r] T1[S[j, q, r], j]
//
// i.e. einsum("jajb->ab") and einsum("jjab->ab") of the full gathers: it
// writes nv^2 values instead of 17.6 MB, one thread an output, j summed in
// order from 0 (products and sums rounded separately, no FMA).  It is a
// template on the element type too: the f32 instance serves the dressing
// of the f32 bulk of the mixed-precision CCSD (pymes_tpu/solver/
// ccsd.py:803-816), on a plan whose weights W are cast.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int EPT = 2;          // (p, q, r) entries a thread

template <typename T>
struct Gather {
    const int* S;
    const T* W;
    const T* T1;
    long long sb, ss, sj;       // T1 strides: batch, row s, column j
    T* out;                     // (ncol, n)
    long long n;                // (p, q, r) entries
    long long n12;              // n1 * n2
    int n2, no, ncol, ct;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
ovvv_gather_kernel(const Gather<T> g)
{
    const int c0 = blockIdx.y * g.ct;
    const int nc = min(g.ct, g.ncol - c0);
    const long long i0 =
        static_cast<long long>(blockIdx.x) * (THREADS * EPT) + threadIdx.x;
    long long srow[EPT];                    // offset of row s, -1: S < 0
    T w[EPT];
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
        const long long i = i0 + e * THREADS;
        srow[e] = -1;
        w[e] = T(0);
        if (i < g.n) {
            const int s = g.S[i];
            const long long p = i / g.n12;
            const int r = static_cast<int>(i % g.n2);
            w[e] = g.W[p * g.n2 + r];
            if (s >= 0) srow[e] = s * g.ss;
        }
    }
    T* o = g.out + static_cast<long long>(c0) * g.n;
    for (int cc = 0; cc < nc; ++cc, o += g.n) {
        const int c = c0 + cc, b = c / g.no, j = c - b * g.no;
        const T* col = g.T1 + b * g.sb + j * g.sj;
#pragma unroll
        for (int e = 0; e < EPT; ++e) {
            const long long i = i0 + e * THREADS;
            if (i < g.n)
                o[i] = (srow[e] >= 0 ? __ldg(col + srow[e]) : T(0)) * w[e];
        }
    }
}

// ---- the f32 gather --------------------------------------------------------
//
// The f64 design instantiated in f32 ran at 45-50 % of its f32 bound at
// the FEAST and RT widths (PERF.md): an output element still cost the f64
// kernel's instructions (an index step, one L1 gather of T1, one multiply,
// a 4-byte store) at half the bytes, so issue and gather rate, not HBM,
// set its pace.  This kernel:
// * A thread takes F_EPT = 4 consecutive (p, q, r) entries: one 16-byte S
//   load, its W and index arithmetic once for all the tile's columns, and
//   for each column one 16-byte store of its four products (a warp's
//   column: 512 contiguous bytes), where n % 4 == 0 and the buffers are
//   16-byte aligned (every UEG plan: n = nv^2 no with nv even); scalar
//   stores otherwise.
// * The T1 gathers go through L1 (T1 is at most a few MB and a tile's
//   columns stay on chip).  Staging the tile's columns in shared memory
//   (a zero row for S < 0, four columns a 16-byte shared load) was
//   measured on an H100 and was slower at every width (1.0-1.7x at 7 to
//   896 columns: the block's staging loads and barrier, the shared loads'
//   bank conflicts), so it was not kept.
// * Column tiles planned for f32 in Python (kernels/ovvv_gather.py
//   plan_f32): up to F32_WIDE_TILE = 8 columns, narrower where the entry
//   tiles of 1024 with the column tiles do not give every SM three
//   blocks; the fastest tiles measured at 7, 14, 448 and 896 columns.
// The product is one __fmul_rn an element, as the twin's: bit for bit.
// (Measured on an H100, on the card alone: 76-88 % of the byte bound at
// 448 and 896 columns, 52-62 % at 7 and 14, where a launch's fixed cost
// weighs, and faster than the f64 gather at every width: PERF.md.)

constexpr int F_THREADS = 256;
constexpr int F_EPT = 4;                // consecutive entries a thread
constexpr int F_ENT = F_THREADS * F_EPT;

struct GatherF {
    const int* S;
    const float* W;
    const float* T1;
    long long sb, ss, sj;
    float* out;
    long long n, n12;
    int n2, no, ncol, ct, vec;          // vec: S and out 16-byte aligned,
};                                      // n % 4 == 0

__global__ void __launch_bounds__(F_THREADS)
ovvv_gather_f32_kernel(const GatherF g)
{
    const int c0 = blockIdx.y * g.ct, nc = min(g.ct, g.ncol - c0);
    const long long i0 = static_cast<long long>(blockIdx.x) * F_ENT
        + F_EPT * threadIdx.x;
    if (i0 >= g.n) return;
    const bool whole = g.vec && i0 + F_EPT <= g.n;
    int s[F_EPT];
    float w[F_EPT];
    if (whole) {
        const int4 s4 = *reinterpret_cast<const int4*>(g.S + i0);
        s[0] = s4.x; s[1] = s4.y; s[2] = s4.z; s[3] = s4.w;
    }
#pragma unroll
    for (int e = 0; e < F_EPT; ++e) {
        const long long i = i0 + e;
        if (!whole) s[e] = i < g.n ? g.S[i] : -1;
        w[e] = 0.0f;
        if (i < g.n) {
            const long long p = i / g.n12;
            const int r = static_cast<int>(i % g.n2);
            w[e] = __ldg(g.W + p * g.n2 + r);
        }
    }
    long long srow[F_EPT];
#pragma unroll
    for (int e = 0; e < F_EPT; ++e) srow[e] = s[e] >= 0 ? s[e] * g.ss : -1;
    float* o = g.out + static_cast<long long>(c0) * g.n + i0;
    for (int cc = 0; cc < nc; ++cc, o += g.n) {
        const int c = c0 + cc, b = c / g.no, j = c - b * g.no;
        const float* col = g.T1 + b * g.sb + j * g.sj;
        float v[F_EPT];
#pragma unroll
        for (int e = 0; e < F_EPT; ++e)
            v[e] = __fmul_rn(srow[e] >= 0 ? __ldg(col + srow[e]) : 0.0f,
                             w[e]);
        if (whole) {
            *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2],
                                                        v[3]);
        } else {
#pragma unroll
            for (int e = 0; e < F_EPT; ++e)
                if (i0 + e < g.n) o[e] = v[e];
        }
    }
}

// Products and sums rounded one at a time (no FMA contraction).
__device__ __forceinline__ double mul_rn(double a, double b)
{
    return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b)
{
    return __fmul_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b)
{
    return __dadd_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b)
{
    return __fadd_rn(a, b);
}

// One thread an output (a, r) of the trace over the plan's j axis.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ovvv_diag_kernel(const int* __restrict__ S, const T* __restrict__ W,
                 const T* __restrict__ T1, long long ss, long long sj,
                 T* __restrict__ out, int na, int n1, int n2, int no,
                 int axis)
{
    const int o = blockIdx.x * THREADS + threadIdx.x;
    if (o >= na * n2) return;
    const int a = o / n2, r = o - a * n2;
    T acc = T(0);
    for (int j = 0; j < no; ++j) {
        const long long si = axis == 1
            ? (static_cast<long long>(a) * n1 + j) * n2 + r
            : (static_cast<long long>(j) * n1 + a) * n2 + r;
        const int s = S[si];
        const T w = W[(axis == 1 ? a : j) * n2 + r];
        const T t = s >= 0 ? T1[s * ss + j * sj] : T(0);
        acc = add_rn(acc, mul_rn(t, w));
    }
    out[o] = acc;
}

template <typename T>
int gather(const int* S, const T* W, const T* T1, long long sb, long long ss,
           long long sj, int no, int ncol, T* out, long long n,
           long long n12, int n2, int ct, cudaStream_t stream)
{
    if (n <= 0 || ncol <= 0) return static_cast<int>(cudaSuccess);
    const Gather<T> g{S, W, T1, sb, ss, sj, out, n, n12, n2, no, ncol, ct};
    const dim3 grid(static_cast<unsigned>((n + THREADS * EPT - 1)
                                          / (THREADS * EPT)),
                    (ncol + ct - 1) / ct);
    ovvv_gather_kernel<T><<<grid, THREADS, 0, stream>>>(g);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int diag(const int* S, const T* W, const T* T1, long long ss, long long sj,
         T* out, int n0, int n1, int n2, int no, int axis,
         cudaStream_t stream)
{
    const int na = axis == 1 ? n0 : n1;
    if (na <= 0 || n2 <= 0) return static_cast<int>(cudaSuccess);
    ovvv_diag_kernel<T><<<(na * n2 + THREADS - 1) / THREADS, THREADS, 0,
                          stream>>>(S, W, T1, ss, sj, out, na, n1, n2, no,
                                    axis);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The gather: S (n0, n1, n2) int32 (n = n0*n1*n2 entries, n12 = n1*n2), W
// (n0, n2), T1 element (b, s, j) at T1[b*sb + s*ss + j*sj], ncol = batch*no
// columns, out (ncol, n), column tiles of ct; W, T1 and out of doubles.  Returns the cudaError_t of the launch (0 = success).
extern "C" int pymes_ovvv_gather(const int* S, const double* W,
                                 const double* T1, long long sb, long long ss,
                                 long long sj, int no, int ncol, double* out,
                                 long long n, long long n12, int n2, int ct,
                                 cudaStream_t stream)
{
    return gather(S, W, T1, sb, ss, sj, no, ncol, out, n, n12, n2, ct,
                  stream);
}

// The f32 gather: the same operands in floats, column tiles of ct.
extern "C" int pymes_ovvv_gather_f32(const int* S, const float* W,
                                     const float* T1, long long sb,
                                     long long ss, long long sj, int no,
                                     int ncol, float* out, long long n,
                                     long long n12, int n2, int ct,
                                     cudaStream_t stream)
{
    if (n <= 0 || ncol <= 0) return static_cast<int>(cudaSuccess);
    const int vec = (reinterpret_cast<uintptr_t>(S) & 15) == 0
        && (reinterpret_cast<uintptr_t>(out) & 15) == 0 && n % 4 == 0;
    const GatherF g{S, W, T1, sb, ss, sj, out, n, n12, n2, no, ncol, ct,
                    vec};
    const dim3 grid(static_cast<unsigned>((n + F_ENT - 1) / F_ENT),
                    (ncol + ct - 1) / ct);
    ovvv_gather_f32_kernel<<<grid, F_THREADS, 0, stream>>>(g);
    return static_cast<int>(cudaGetLastError());
}

// The fused trace: S (n0, n1, n2), W (n0, n2), T1 (nv, no) with strides
// (ss, sj); axis 1 sums j over S's middle axis (out (n0, n2)), axis 0 over
// its first (out (n1, n2)); doubles (_f32: floats).
extern "C" int pymes_ovvv_gather_diag(const int* S, const double* W,
                                      const double* T1, long long ss,
                                      long long sj, double* out, int n0,
                                      int n1, int n2, int no, int axis,
                                      cudaStream_t stream)
{
    return diag(S, W, T1, ss, sj, out, n0, n1, n2, no, axis, stream);
}

extern "C" int pymes_ovvv_gather_diag_f32(const int* S, const float* W,
                                          const float* T1, long long ss,
                                          long long sj, float* out, int n0,
                                          int n1, int n2, int no, int axis,
                                          cudaStream_t stream)
{
    return diag(S, W, T1, ss, sj, out, n0, n1, n2, no, axis, stream);
}
