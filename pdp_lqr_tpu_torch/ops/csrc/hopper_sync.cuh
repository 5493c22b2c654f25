// Hopper's shared-memory barriers (mbarrier, sm_80 and later; parity
// waits as on sm_90), in PTX, for the kernels whose warps take roles: a
// producer warp that copies stages into a ring of shared-memory slots,
// and warps that consume them.  A slot is handed over by a barrier object
// in shared memory that counts arrivals a phase and flips its phase bit
// when the count is reached; a waiter names the parity of the phase it
// waits for, so no thread passes a barrier that another has not reached
// and no block-wide barrier is needed a stage.
//
// Include directly from a kernel source (not from another header).

#pragma once

#include <cuda.h>

namespace {

typedef unsigned long long mbar_t;   // one barrier object, 8 bytes, shared

__device__ __forceinline__ unsigned smem_u32(const void* p)
{
    return (unsigned)__cvta_generic_to_shared(p);
}

// Set up a barrier that completes a phase after `count` arrivals (one
// thread; a __syncthreads before any other thread uses it).
__device__ __forceinline__ void mbar_init(mbar_t* bar, unsigned count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// One arrival (release: what this thread wrote before it is seen by the
// threads that wait for the phase).
__device__ __forceinline__ void mbar_arrive(mbar_t* bar)
{
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 :: "r"(smem_u32(bar)) : "memory");
}

// One arrival, made by the hardware once every cp.async this thread has
// issued so far has landed (the barrier's count includes it: .noinc).
__device__ __forceinline__ void mbar_arrive_on_copies(mbar_t* bar)
{
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
                 :: "r"(smem_u32(bar)) : "memory");
}

// One arrival that also expects `bytes` more to land by the copy engine
// before the phase can complete (the barrier's transaction count).
__device__ __forceinline__ void mbar_arrive_expect_tx(mbar_t* bar,
                                                      unsigned bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// A box of a row-major 2-D tensor (see make_rows_map), from column `col`
// and row `row`, copied by the copy engine (TMA, sm_90) into shared
// memory (128-byte aligned) dense, row after row, and counted off the
// barrier's transaction count as it lands; words past the tensor's edge
// land as zeros.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int col, int row, mbar_t* bar)
{
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
        ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];"
        :: "r"(smem_u32(dst)), "l"(map), "r"(col), "r"(row),
           "r"(smem_u32(bar))
        : "memory");
}

// `bytes` contiguous bytes (a multiple of 16; both ends 16-byte aligned)
// copied by the copy engine into shared memory as one bulk copy, counted
// off the barrier's transaction count as they land.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, mbar_t* bar)
{
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

// Host: the copy engine's map of a row-major tensor of `rows` rows of
// `cols` elements of `word` bytes at `base` (the row stride a multiple of
// 16 bytes, `base` 16-byte aligned), in boxes of box_rows x box_cols;
// elements of 8, 4 or 2 bytes are float64, float32 or bfloat16.  Returns
// 0, or a CUDA error.
inline int make_rows_map(CUtensorMap* map, const void* base,
                         unsigned long long rows, unsigned long long cols,
                         unsigned box_rows, unsigned box_cols, int word)
{
    typedef CUresult (*Encode)(
        CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
        const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
        const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
        CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
    static Encode encode = nullptr;
    if (encode == nullptr) {
        void* fn = nullptr;
        cudaDriverEntryPointQueryResult found;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                    cudaEnableDefault, &found) != cudaSuccess
            || found != cudaDriverEntryPointSuccess || fn == nullptr)
            return (int)cudaErrorNotSupported;
        encode = (Encode)fn;
    }
    const cuuint64_t dims[2] = {cols, rows};
    const cuuint64_t strides[1] = {cols * (unsigned long long)word};
    const cuuint32_t box[2] = {box_cols, box_rows};
    const cuuint32_t step[2] = {1, 1};
    const CUresult r = encode(
        map, word == 8 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT64
             : word == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
        2, const_cast<void*>(base), dims, strides, box, step,
        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
        CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A hint, no copy: fetch a copy-engine map (a kernel parameter) ahead of
// its first box, so that the first box does not wait for it.
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map)
{
    asm volatile("prefetch.tensormap [%0];" :: "l"(map) : "memory");
}

// A hint, no copy: bring the 128-byte line holding `p` from device memory
// into the L2 cache, for an ordinary load some stages later.
__device__ __forceinline__ void prefetch_l2(const void* p)
{
    asm volatile("prefetch.global.L2 [%0];" :: "l"(p));
}

// Wait (acquire) until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(mbar_t* bar, unsigned parity)
{
    unsigned done;
    do {
        asm volatile("{\n\t.reg .pred p;\n\t"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                     "selp.u32 %0, 1, 0, p;\n\t}"
                     : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    } while (!done);
}

}  // namespace
