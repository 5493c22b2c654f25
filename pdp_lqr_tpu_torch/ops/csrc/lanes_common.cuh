// Shared by the kernel sources of this directory: the scalar type, the
// problem widths, and the geometry and copy helpers of the shared-model
// per-scenario kernels (one model, Bt scenarios; see the note at K2/K3 in
// riccati_kernels.cu).  Include after <cuda_pipeline.h> and
// <cuda_runtime.h>, with -DSCALAR, -DNX and -DNU given.

#pragma once

typedef SCALAR scalar;

namespace {

constexpr int NZ = NX + NU;

// Asynchronous copy of one word from device to shared memory (cp.async).
__device__ __forceinline__ void copy_word(scalar* dst, const scalar* src)
{
    __pipeline_memcpy_async(dst, src, sizeof(scalar));
}

// A block serves VS_LANES scenarios with VS_GROUPS threads each: thread
// (lane, grp) owns every VS_GROUPS-th slice of the scenario's rows, and a
// warp is one group, so a branch on grp never diverges.  Stage inputs ride
// a ring of VS_SLOTS shared-memory slots, copied VS_PF stages ahead.
// A source sets VS_GROUPS_N before it includes this header where its
// kernel wants another number of threads a scenario than four.
constexpr int VS_LANES = 32;                 // scenarios per block
#ifndef VS_GROUPS_N
#define VS_GROUPS_N 4
#endif
constexpr int VS_GROUPS = VS_GROUPS_N;       // threads per scenario
constexpr int VS_THREADS = VS_LANES * VS_GROUPS;
constexpr int VS_RX = (NX + VS_GROUPS - 1) / VS_GROUPS;   // state rows/thread
constexpr int VS_RU = (NU + VS_GROUPS - 1) / VS_GROUPS;   // input rows/thread
constexpr int VS_PF = 4;                     // stages in flight (>= 2)
constexpr int VS_SLOTS = VS_PF + 1;

// Copy `words` contiguous matrix words into a ring slot, dealt over the
// block's threads.
__device__ __forceinline__ void copy_matrix(scalar* dst, const scalar* src,
                                            int words)
{
    for (int w = threadIdx.x; w < words; w += VS_THREADS)
        copy_word(dst + w, src + w);
}

// Copy this thread's scenario's entries of a (ROWS, Bt) per-scenario
// stage tensor into a ring slot: rows grp, grp + VS_GROUPS, ...; `src`
// points at the scenario's entry of row 0.
template <int ROWS>
__device__ __forceinline__ void copy_rows(scalar* dst, const scalar* src,
                                          size_t Bs, int lane, int grp)
{
#pragma unroll
    for (int r = 0; r < (ROWS + VS_GROUPS - 1) / VS_GROUPS; ++r) {
        const int row = grp + r * VS_GROUPS;
        if (row < ROWS)
            copy_word(dst + row * VS_LANES + lane, src + row * Bs);
    }
}

// Allow a kernel more than the default 48 KB of dynamic shared memory.
template <class Kernel>
int set_smem(Kernel kernel, size_t smem)
{
    if (smem <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace
