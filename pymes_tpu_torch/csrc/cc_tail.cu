// K2/K3 and K2'/K3': the per-iteration tail of the CCD and CCSD fixed
// points (sm_90a), templated on the element type: double, and float for
// the f32 bulk of the mixed-precision CCD/CCSD (all arithmetic, sums
// included, in the element type, as the JAX package's f32 pass).
//
// Replaces B3 of the JAX package: the Jacobi step of ccd_solve_jit
// (pymes_tpu/solver/ccd.py:525-537) and of ccsd_iteration
// (pymes_tpu/solver/ccsd.py:615-618), the DIIS insertion and Gram row
// (pymes_tpu/mixer/diis.py:107), the DIIS mix (pymes_tpu/mixer/diis.py:160)
// and the energies ccd_energy_ij (pymes_tpu/solver/ccd.py:353) and
// ccsd_energy_ij (pymes_tpu/solver/ccsd.py:393).  Both passes run over the
// flat DIIS vector [T1 (nv, no) | T2 (no, no, nv, nv)] of N elements, the
// T1 segment N1 long: CCD is the case N1 = 0, for which the CCSD pass does
// exactly what the CCD pass does (the same D, ring writes and Gram row;
// T_eff = T2 and a one-body energy of 0), so one source serves both.
//
// * Jacobi/insert (pymes_cc_jacobi): dT = R / (D + shift), D built from
//   eps_i, eps_a in the twins' order (eps_i[i] - eps_a[a] on the T1
//   segment, ((eps_i[i] + eps_i[j]) - eps_a[a]) - eps_a[b] on T2), so the
//   ring rows errs[slot] = dT and amps[slot] = T + dT, written in place,
//   equal the twins' bit for bit; and the Gram row <errs[k], dT> for
//   k < n_valid, zero past it.
// * Mix/energy (pymes_cc_mix): T <- sum_{k < n_valid} c_k amps[k] in
//   place, and (2 sum f_ia T1[a,i], 2 sum T_eff V_ijab, -sum T_eff V_ijba)
//   with T_eff = T2 + T1[a,i] T1[b,j].
//
// What bounds them on an H100: device-memory bandwidth.  Per element the
// Jacobi pass reads R, T and the other valid error rows and writes two
// ring rows; the mix pass reads the valid amplitude rows, V and Vx and
// writes T: 9 rows of N at a 6-slot ring, no matrix work.  The design:
//
// * A persistent grid (the wrappers' plan: MIN_BLOCKS blocks an SM, one
//   wave) walks the elements with grid-stride loops in 16-byte vectors
//   (double2, float4; float2 or scalars where the operands' alignments do
//   not agree), with a scalar head and tail, and the T1 segment scalar.
//   The streamed operands are read with the evict-first hint.  32-bit
//   indices (the wrappers refuse m*N >= 2^31).
// * The T2 segment is indexed by (i, j) rows of nv^2: a thread turns its
//   first position into (i, j, a, b) once and then steps the four digits
//   by the grid stride with carries, so no element pays a division.
// * Each thread issues every load of an element (R, T, the ring rows of a
//   group) before the first use, keeps its Gram sums, one per valid slot,
//   in registers (up to SLOTS; further slots in more groups over the same
//   elements, each reading dT back from the thread's own ring writes), and
//   a block reduces them once, at the end.
// * Cross-block sums are deterministic: each block writes its partials,
//   and the block that takes the last ticket (__threadfence, atomic
//   counter) sums them in a fixed order (thread t the blocks t, t +
//   THREADS, ... in order, then a fixed tree).  No floating-point atomics:
//   the same inputs give the same bits.  The entry zeroes the counter on
//   its stream before it launches, so a failed launch leaves nothing
//   behind.
// * The mix pass mixes the T1 segment first, in a small launch of the same
//   entry (its one-body partials go into the last block's sum): the T2
//   elements then read the two mixed T1 factors of T_eff, L2-resident
//   (12 KB at nP=219), instead of recomputing them from the ring.  Any T1
//   size works (no shared-memory copy of T1).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// blocks an SM the register budget must allow (the wrappers' plan sizes
// the persistent grid to it: one wave)
constexpr int MIN_BLOCKS = 2;
// ring rows a thread loads at once and Gram sums it holds in registers:
// 8 keep the f64 Jacobi pass within MIN_BLOCKS' register budget with
// every load of an element in flight together (16 did not, and ran slower
// on an H100; so did more blocks an SM, or two vectors a thread a step)
constexpr int SLOTS = 8;

template <typename T, int W>
struct alignas(sizeof(T) * W) Pack {
    T v[W];
};

// a vector of a streamed operand, read once a pass (each pass moves three
// times the L2): the evict-first load, ld.global.cs
template <typename T, int W>
__device__ __forceinline__ Pack<T, W> load(const T* p)
{
    Pack<T, W> r;
    if constexpr (sizeof(T) == 8 && W == 2) {
        const double2 x = __ldcs(reinterpret_cast<const double2*>(p));
        r.v[0] = x.x;
        r.v[1] = x.y;
    } else if constexpr (sizeof(T) == 4 && W == 4) {
        const float4 x = __ldcs(reinterpret_cast<const float4*>(p));
        r.v[0] = x.x;
        r.v[1] = x.y;
        r.v[2] = x.z;
        r.v[3] = x.w;
    } else if constexpr (sizeof(T) == 4 && W == 2) {
        const float2 x = __ldcs(reinterpret_cast<const float2*>(p));
        r.v[0] = x.x;
        r.v[1] = x.y;
    } else {
        static_assert(W == 1, "a vector is 16 bytes at most");
        r.v[0] = __ldcs(p);
    }
    return r;
}

template <typename T, int W>
__device__ __forceinline__ void store(T* p, const Pack<T, W>& x)
{
    *reinterpret_cast<Pack<T, W>*>(p) = x;
}

// a position of the T2 segment as its digits (i, j, a, b) of
// (no, no, nv, nv); i is not reduced, so a stride may hold any count
struct Idx {
    int i, j, a, b;
};

__device__ __forceinline__ Idx digits(int p, int no, int nv)
{
    const int nvv = nv * nv;
    const int r = p / nvv, q = p - r * nvv;
    Idx x;
    x.i = r / no;
    x.j = r - x.i * no;
    x.a = q / nv;
    x.b = q - x.a * nv;
    return x;
}

// the next position
__device__ __forceinline__ void step1(Idx& x, int no, int nv)
{
    if (++x.b == nv) {
        x.b = 0;
        if (++x.a == nv) {
            x.a = 0;
            if (++x.j == no) {
                x.j = 0;
                ++x.i;
            }
        }
    }
}

// d positions on, d given by its digits: each digit sum is below twice
// its radix, so one carry a digit
__device__ __forceinline__ void stepd(Idx& x, const Idx& d, int no, int nv)
{
    x.b += d.b;
    int c = x.b >= nv;
    x.b -= c ? nv : 0;
    x.a += d.a + c;
    c = x.a >= nv;
    x.a -= c ? nv : 0;
    x.j += d.j + c;
    c = x.j >= no;
    x.j -= c ? no : 0;
    x.i += d.i + c;
}

// the pair denominator in the twin's order
template <typename T>
__device__ __forceinline__ T pair_d(const T* eps_i, const T* eps_a,
                                    const Idx& x)
{
    return ((eps_i[x.i] + eps_i[x.j]) - eps_a[x.a]) - eps_a[x.b];
}

template <typename T>
__device__ __forceinline__ T warp_sum(T s)
{
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    return s;
}

// the block's sums of acc[0..n) (n <= N) into out[0..n), in a fixed order
template <typename T, int N>
__device__ __forceinline__ void block_sums(const T (&acc)[N], int n, T* out,
                                          T (*red)[N])
{
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
    for (int k = 0; k < N; ++k) {
        if (k < n) {
            const T s = warp_sum(acc[k]);
            if (lane == 0) red[warp][k] = s;
        }
    }
    __syncthreads();
    const int k = threadIdx.x;
    if (k < n) {
        T s = red[0][k];
        for (int w = 1; w < WARPS; ++w) s += red[w][k];
        out[k] = s;
    }
    __syncthreads();
}

// true in the one block that takes the last ticket, after every block has
// written its partials
__device__ __forceinline__ bool last_block(unsigned* ticket)
{
    __shared__ bool last;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    __syncthreads();
    if (last) __threadfence();
    return last;
}

// the last block's sums over the blocks b < nb of part[b * ld + k], k < n
// (n <= N), into out[0, n): thread t adds the blocks t, t + THREADS, ... in
// order (all its loads in flight together), then block_sums' fixed tree
template <typename T, int N>
__device__ __forceinline__ void blocks_sums(const T* part, int ld, int nb,
                                           int n, T* out, T (*red)[N])
{
    T s[N];
#pragma unroll
    for (int k = 0; k < N; ++k) s[k] = 0;
    for (int b = threadIdx.x; b < nb; b += THREADS) {
#pragma unroll
        for (int k = 0; k < N; ++k)
            if (k < n) s[k] += __ldcg(part + b * ld + k);
    }
    block_sums(s, n, out, red);
}

template <typename T>
struct JacobiArgs {
    const T *R1, *T1, *R2, *T2, *eps_i, *eps_a;
    T *errs, *amps, *row, *part;
    unsigned* ticket;
    T shift;
    int n1, n, no, nv, m, slot, n_valid, head, nvec, tail;
};

template <typename T, int W>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
cc_jacobi_insert(const JacobiArgs<T> g)
{
    __shared__ T red[WARPS][SLOTS];
    const int gtid = blockIdx.x * THREADS + threadIdx.x;
    const int stride = gridDim.x * THREADS;
    T* const ein = g.errs + g.slot * g.n;
    T* const ain = g.amps + g.slot * g.n;
    const int nscal = g.n1 + g.head + g.tail;
    const Idx d = digits(stride * W, g.no, g.nv);
    for (int g0 = 0; g0 < g.n_valid; g0 += SLOTS) {
        const int ng = min(SLOTS, g.n_valid - g0);
        const bool first = g0 == 0;
        T acc[SLOTS];
#pragma unroll
        for (int k = 0; k < SLOTS; ++k) acc[k] = 0;
        // scalars: the T1 segment, then the T2 segment's head and tail
        for (int s = gtid; s < nscal; s += stride) {
            int f;
            T dT;
            if (s < g.n1) {
                f = s;
                if (first) {
                    const int a = s / g.no, i = s - a * g.no;
                    dT = g.R1[s] / ((g.eps_i[i] - g.eps_a[a]) + g.shift);
                    ein[f] = dT;
                    ain[f] = g.T1[s] + dT;
                }
            } else {
                const int t = s - g.n1;
                const int p = t < g.head ? t : t + g.nvec * W;
                f = g.n1 + p;
                if (first) {
                    const Idx x = digits(p, g.no, g.nv);
                    dT = g.R2[p] / (pair_d(g.eps_i, g.eps_a, x) + g.shift);
                    ein[f] = dT;
                    ain[f] = g.T2[p] + dT;
                }
            }
            if (!first) dT = ein[f];
#pragma unroll
            for (int k = 0; k < SLOTS; ++k) {
                if (k < ng) {
                    const int kk = g0 + k;
                    const T e = kk == g.slot ? dT : g.errs[kk * g.n + f];
                    acc[k] += e * dT;
                }
            }
        }
        // 16-byte vectors of the T2 segment: every load of an element (R, T
        // and the group's other error rows) issued before the first use and
        // before the ring writes
        Idx x = digits(g.head + gtid * W, g.no, g.nv);
        for (int v = gtid; v < g.nvec; v += stride, stepd(x, d, g.no, g.nv)) {
            const int p = g.head + v * W, f = g.n1 + p;
            Pack<T, W> dT, r, t, e[SLOTS];
            if (first) {
                r = load<T, W>(g.R2 + p);
                t = load<T, W>(g.T2 + p);
            } else {
                dT = load<T, W>(ein + f);
            }
#pragma unroll
            for (int k = 0; k < SLOTS; ++k)
                if (k < ng && g0 + k != g.slot)
                    e[k] = load<T, W>(g.errs + (g0 + k) * g.n + f);
            if (first) {
                Pack<T, W> s;
                Idx y = x;
#pragma unroll
                for (int w = 0; w < W; ++w) {
                    dT.v[w] = r.v[w] / (pair_d(g.eps_i, g.eps_a, y) + g.shift);
                    s.v[w] = t.v[w] + dT.v[w];
                    step1(y, g.no, g.nv);
                }
                store<T, W>(ein + f, dT);
                store<T, W>(ain + f, s);
            }
            // values, not a reference to dT or e: a reference chosen at run
            // time puts e in local memory
#pragma unroll
            for (int k = 0; k < SLOTS; ++k) {
                if (k < ng) {
                    const bool self = g0 + k == g.slot;
#pragma unroll
                    for (int w = 0; w < W; ++w)
                        acc[k] += (self ? dT.v[w] : e[k].v[w]) * dT.v[w];
                }
            }
        }
        block_sums(acc, ng, g.part + blockIdx.x * g.n_valid + g0, red);
    }
    if (!last_block(g.ticket)) return;
    for (int g0 = 0; g0 < g.n_valid; g0 += SLOTS)
        blocks_sums(g.part + g0, g.n_valid, gridDim.x,
                    min(SLOTS, g.n_valid - g0), g.row + g0, red);
    for (int k = g.n_valid + threadIdx.x; k < g.m; k += THREADS)
        g.row[k] = 0;
}

template <typename T>
struct MixArgs {
    const T *amps, *coeff, *F1, *V, *Vx;
    T *T1, *T2, *out, *part, *part1;
    unsigned* ticket;
    int n1, n, no, nv, n_valid, head, nvec, tail, grid1;
};

// the T1 segment: T1 <- sum_k c_k amps[k][0:N1), and the block's partial of
// sum T1 * F1 into part1[block]
template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
cc_mix_t1(const MixArgs<T> g)
{
    __shared__ T red[WARPS][1];
    T e1[1] = {0};
    for (int f = blockIdx.x * THREADS + threadIdx.x; f < g.n1;
         f += gridDim.x * THREADS) {
        T acc = 0;
        for (int k = 0; k < g.n_valid; ++k)
            acc += g.coeff[k] * g.amps[k * g.n + f];
        g.T1[f] = acc;
        e1[0] += acc * g.F1[f];
    }
    block_sums(e1, 1, g.part1 + blockIdx.x, red);
}

// one element of the T2 segment at digits x: the mixed value into T2[p],
// its energy terms into e[0] (V), e[1] (Vx)
template <typename T, bool HAS_T1>
__device__ __forceinline__ void mix_terms(const MixArgs<T>& g, const Idx& x,
                                          T acc, T v, T vx, T (&e)[2])
{
    T teff = acc;
    if (HAS_T1)
        teff += g.T1[x.a * g.no + x.i] * g.T1[x.b * g.no + x.j];
    e[0] += teff * v;
    e[1] += teff * vx;
}

template <typename T, int W, bool HAS_T1>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
cc_mix_energy(const MixArgs<T> g)
{
    __shared__ T red[WARPS][2], red1[WARPS][1];
    const int gtid = blockIdx.x * THREADS + threadIdx.x;
    const int stride = gridDim.x * THREADS;
    const T* const amps2 = g.amps + g.n1;
    T e[2] = {0, 0};
    // scalars: the T2 segment's head and tail
    for (int s = gtid; s < g.head + g.tail; s += stride) {
        const int p = s < g.head ? s : s + g.nvec * W;
        T acc = 0;
        for (int k = 0; k < g.n_valid; ++k)
            acc += g.coeff[k] * amps2[k * g.n + p];
        g.T2[p] = acc;
        mix_terms<T, HAS_T1>(g, digits(p, g.no, g.nv), acc, g.V[p], g.Vx[p],
                             e);
    }
    // V, Vx and SLOTS ring rows at a time issued before the first use
    const Idx d = digits(stride * W, g.no, g.nv);
    Idx x = digits(g.head + gtid * W, g.no, g.nv);
    for (int v = gtid; v < g.nvec; v += stride, stepd(x, d, g.no, g.nv)) {
        const int p = g.head + v * W;
        const Pack<T, W> pv = load<T, W>(g.V + p);
        const Pack<T, W> px = load<T, W>(g.Vx + p);
        Pack<T, W> acc;
#pragma unroll
        for (int w = 0; w < W; ++w) acc.v[w] = 0;
        for (int k0 = 0; k0 < g.n_valid; k0 += SLOTS) {
            Pack<T, W> a[SLOTS];
#pragma unroll
            for (int k = 0; k < SLOTS; ++k)
                if (k0 + k < g.n_valid)
                    a[k] = load<T, W>(amps2 + (k0 + k) * g.n + p);
#pragma unroll
            for (int k = 0; k < SLOTS; ++k) {
                if (k0 + k < g.n_valid) {
                    const T c = g.coeff[k0 + k];
#pragma unroll
                    for (int w = 0; w < W; ++w) acc.v[w] += c * a[k].v[w];
                }
            }
        }
        store<T, W>(g.T2 + p, acc);
        Idx y = x;
#pragma unroll
        for (int w = 0; w < W; ++w) {
            mix_terms<T, HAS_T1>(g, y, acc.v[w], pv.v[w], px.v[w], e);
            step1(y, g.no, g.nv);
        }
    }
    block_sums(e, 2, g.part + 2 * blockIdx.x, red);
    if (!last_block(g.ticket)) return;
    // the one-body sum over the T1 mix's blocks, the direct and exchange
    // sums over this launch's
    __shared__ T sums[3];
    blocks_sums(g.part1, 1, g.grid1, 1, sums, red1);
    blocks_sums(g.part, 2, gridDim.x, 2, sums + 1, red);
    const int k = threadIdx.x;
    if (k < 3) g.out[k] = k == 2 ? -sums[2] : T(2) * sums[k];
}

template <typename T, int W>
cudaError_t jacobi_launch(const JacobiArgs<T>& g, int grid,
                          cudaStream_t stream)
{
    cc_jacobi_insert<T, W><<<grid, THREADS, 0, stream>>>(g);
    return cudaGetLastError();
}

template <typename T>
int jacobi(const T* R1, const T* T1, const T* R2, const T* T2,
           const T* eps_i, const T* eps_a, double shift, T* errs, T* amps,
           T* out, int n1, int n, int no, int nv, int m, int slot,
           int n_valid, int vec, int head, int nvec, int tail, int grid,
           cudaStream_t stream)
{
    if (grid <= 0 || m <= 0 || n_valid <= 0 || n_valid > m || slot < 0
        || slot >= m || vec * static_cast<int>(sizeof(T)) > 16)
        return static_cast<int>(cudaErrorInvalidValue);
    JacobiArgs<T> g;
    g.R1 = R1;
    g.T1 = T1;
    g.R2 = R2;
    g.T2 = T2;
    g.eps_i = eps_i;
    g.eps_a = eps_a;
    g.errs = errs;
    g.amps = amps;
    g.row = out;
    g.part = out + m;
    g.ticket = reinterpret_cast<unsigned*>(out + m + grid * m);
    g.shift = static_cast<T>(shift);
    g.n1 = n1;
    g.n = n;
    g.no = no;
    g.nv = nv;
    g.m = m;
    g.slot = slot;
    g.n_valid = n_valid;
    g.head = head;
    g.nvec = nvec;
    g.tail = tail;
    cudaError_t rc = cudaMemsetAsync(g.ticket, 0, sizeof(unsigned), stream);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    switch (vec) {
        case 1: rc = jacobi_launch<T, 1>(g, grid, stream); break;
        case 2: rc = jacobi_launch<T, 2>(g, grid, stream); break;
        case 4:
            if constexpr (sizeof(T) <= 4) {
                rc = jacobi_launch<T, 4>(g, grid, stream);
                break;
            }
            [[fallthrough]];
        default: rc = cudaErrorInvalidValue;
    }
    return static_cast<int>(rc);
}

template <typename T, int W>
cudaError_t mix_launch(const MixArgs<T>& g, int grid, cudaStream_t stream)
{
    if (g.n1 > 0) {
        cc_mix_t1<T><<<g.grid1, THREADS, 0, stream>>>(g);
        const cudaError_t rc = cudaGetLastError();
        if (rc != cudaSuccess) return rc;
        cc_mix_energy<T, W, true><<<grid, THREADS, 0, stream>>>(g);
    } else {
        cc_mix_energy<T, W, false><<<grid, THREADS, 0, stream>>>(g);
    }
    return cudaGetLastError();
}

template <typename T>
int mix(const T* amps, const T* coeff, T* T1, T* T2, const T* F1,
        const T* V, const T* Vx, T* out, int n1, int n, int no, int nv,
        int n_valid, int vec, int head, int nvec, int tail, int grid,
        int grid1, cudaStream_t stream)
{
    if (grid <= 0 || n_valid < 0 || (n1 > 0 && grid1 <= 0)
        || vec * static_cast<int>(sizeof(T)) > 16)
        return static_cast<int>(cudaErrorInvalidValue);
    MixArgs<T> g;
    g.amps = amps;
    g.coeff = coeff;
    g.F1 = F1;
    g.V = V;
    g.Vx = Vx;
    g.T1 = T1;
    g.T2 = T2;
    g.out = out;
    g.part = out + 3;
    g.grid1 = n1 > 0 ? grid1 : 0;
    g.part1 = out + 3 + 2 * grid;
    g.ticket = reinterpret_cast<unsigned*>(out + 3 + 2 * grid + g.grid1);
    g.n1 = n1;
    g.n = n;
    g.no = no;
    g.nv = nv;
    g.n_valid = n_valid;
    g.head = head;
    g.nvec = nvec;
    g.tail = tail;
    cudaError_t rc = cudaMemsetAsync(g.ticket, 0, sizeof(unsigned), stream);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    switch (vec) {
        case 1: rc = mix_launch<T, 1>(g, grid, stream); break;
        case 2: rc = mix_launch<T, 2>(g, grid, stream); break;
        case 4:
            if constexpr (sizeof(T) <= 4) {
                rc = mix_launch<T, 4>(g, grid, stream);
                break;
            }
            [[fallthrough]];
        default: rc = cudaErrorInvalidValue;
    }
    return static_cast<int>(rc);
}

}  // namespace

// The Jacobi/insert pass over [T1 | T2] (R1, T1 null when n1 = 0): the
// ring rows errs[slot], amps[slot] in place, the Gram row into out[0, m);
// out holds m + grid * m elements and the ticket after them.  The vector
// width, head, vector count and tail of the T2 segment and the grid come
// from the wrapper's plan.  Returns the cudaError_t of the launch.
// Doubles (_f32: floats).
extern "C" int pymes_cc_jacobi(
    const double* R1, const double* T1, const double* R2, const double* T2,
    const double* eps_i, const double* eps_a, double shift, double* errs,
    double* amps, double* out, int n1, int n, int no, int nv, int m,
    int slot, int n_valid, int vec, int head, int nvec, int tail, int grid,
    cudaStream_t stream)
{
    return jacobi(R1, T1, R2, T2, eps_i, eps_a, shift, errs, amps, out, n1,
                  n, no, nv, m, slot, n_valid, vec, head, nvec, tail, grid,
                  stream);
}

extern "C" int pymes_cc_jacobi_f32(
    const float* R1, const float* T1, const float* R2, const float* T2,
    const float* eps_i, const float* eps_a, double shift, float* errs,
    float* amps, float* out, int n1, int n, int no, int nv, int m, int slot,
    int n_valid, int vec, int head, int nvec, int tail, int grid,
    cudaStream_t stream)
{
    return jacobi(R1, T1, R2, T2, eps_i, eps_a, shift, errs, amps, out, n1,
                  n, no, nv, m, slot, n_valid, vec, head, nvec, tail, grid,
                  stream);
}

// The mix/energy pass (T1, F1 null when n1 = 0): T1, T2 in place, the
// energy pieces (2 e_1b, 2 e_dir, -e_exc) into out[0, 3); out holds
// 3 + 2 * grid + grid1 elements and the ticket after them.  Doubles (_f32:
// floats).
extern "C" int pymes_cc_mix(
    const double* amps, const double* coeff, double* T1, double* T2,
    const double* F1, const double* V, const double* Vx, double* out,
    int n1, int n, int no, int nv, int n_valid, int vec, int head, int nvec,
    int tail, int grid, int grid1, cudaStream_t stream)
{
    return mix(amps, coeff, T1, T2, F1, V, Vx, out, n1, n, no, nv, n_valid,
               vec, head, nvec, tail, grid, grid1, stream);
}

extern "C" int pymes_cc_mix_f32(
    const float* amps, const float* coeff, float* T1, float* T2,
    const float* F1, const float* V, const float* Vx, float* out, int n1,
    int n, int no, int nv, int n_valid, int vec, int head, int nvec,
    int tail, int grid, int grid1, cudaStream_t stream)
{
    return mix(amps, coeff, T1, T2, F1, V, Vx, out, n1, n, no, nv, n_valid,
               vec, head, nvec, tail, grid, grid1, stream);
}
