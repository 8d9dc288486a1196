// Shared-memory staging for the sm_90a kernels: mbarriers and cp.async
// copies that complete on them.
//
// Protocol of a "full" barrier: it is initialised with the number of
// copying threads; for each fill every one of them issues its cp.asyncs
// (16 bytes where source and destination are 16-byte aligned, else one
// element) and then arrives through cp_async_arrive_noinc, which fires
// once that thread's copies have landed.  The phase completes when all of
// them have, so readers that wait on it see the whole buffer.
//
// Why not cp.async.bulk: one bulk copy per row segment costs the copy
// engine a fixed time per request, and with the 256- to 768-byte row
// segments of these kernels that, not HBM, set the pace.

#pragma once

#include <cstdint>

namespace pymes {

__device__ __forceinline__ unsigned smem_addr(const void* p)
{
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar)
{
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 :: "r"(smem_addr(bar)) : "memory");
}

// block until the phase of parity `parity` of `bar` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity)
{
    const unsigned addr = smem_addr(bar);
    unsigned done = 0;
    do {
        asm volatile("{\n\t.reg .pred p;\n\t"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;"
                     "\n\tselp.u32 %0, 1, 0, p;\n\t}"
                     : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    } while (!done);
}

// two doubles, 16-byte aligned source and destination, bypassing L1, with
// a hint to fetch the surrounding 256 bytes into L2 (the rows are streamed)
__device__ __forceinline__ void cp_async16(void* dst, const void* src)
{
    asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16;"
                 :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// one double, 8-byte aligned
__device__ __forceinline__ void cp_async8(void* dst, const void* src)
{
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;"
                 :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// one float, 4-byte aligned
__device__ __forceinline__ void cp_async4(void* dst, const void* src)
{
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                 :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// one element of T (float or double), aligned to its size
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src)
{
    static_assert(sizeof(T) == 4 || sizeof(T) == 8, "float or double");
    if constexpr (sizeof(T) == 8) cp_async8(dst, src);
    else cp_async4(dst, src);
}

__device__ __forceinline__ void cp_async_arrive_noinc(uint64_t* bar)
{
    asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];"
                 :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ bool aligned16(const void* p)
{
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace pymes
