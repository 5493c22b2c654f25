// Shared by the kernel sources of this directory: the scalar type, the
// problem widths, and the geometry and copy helpers of the shared-model
// per-scenario kernels (one model, Bt scenarios; see the note at K2/K3 in
// riccati_kernels.cu) and of the kernels whose warps take roles.  Include
// after <cuda_pipeline.h> and <cuda_runtime.h>, with -DSCALAR, -DNX and
// -DNU given.

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
constexpr int VS_LANES = 32;                 // scenarios per block
constexpr int VS_GROUPS = 4;                 // threads per scenario
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

// The copies of a producer warp (the kernels whose warps take roles):
// a run of `words` contiguous words into a slot (16-byte aligned), 16
// bytes a copy where the source and the length allow, a word otherwise.
__device__ __forceinline__ void warp_copy_run(scalar* dst, const scalar* src,
                                              int words, int lane)
{
    constexpr int VW = 16 / (int)sizeof(scalar);
    if (words % VW == 0 && ((size_t)src & 15) == 0) {
#pragma unroll 1
        for (int q = lane; q < words / VW; q += 32)
            __pipeline_memcpy_async(dst + q * VW, src + q * VW, 16);
    } else {
#pragma unroll 1
        for (int q = lane; q < words; q += 32) copy_word(dst + q, src + q);
    }
}

// `rows` rows of a batch-last stage block (row r of scenario b at
// src[r * Bt + b]) for a block's W scenarios from b0 (W a multiple of 32),
// into slot rows of W words: 16-byte copies (a row of W words is whole
// lines) when `vec`, else a word a copy, a scenario past the batch copying
// the last one's.
template <int W>
__device__ __forceinline__ void warp_copy_rows(scalar* dst, const scalar* src,
                                               int rows, size_t Bt, size_t b0,
                                               bool vec, int lane)
{
    constexpr int VW = 16 / (int)sizeof(scalar);
    constexpr int CH = W / VW;                   // 16-byte pieces a row
    if (vec) {
#pragma unroll 1
        for (int q = lane; q < rows * CH; q += 32) {
            const int r = q / CH, p = q % CH;
            __pipeline_memcpy_async(dst + r * W + p * VW,
                                    src + r * Bt + b0 + p * VW, 16);
        }
    } else {
#pragma unroll 1
        for (int q = lane; q < rows * W; q += 32) {
            const int r = q / W, j = q % W;
            const size_t b = b0 + j < Bt ? b0 + j : Bt - 1;
            copy_word(dst + r * W + j, src + r * Bt + b);
        }
    }
}

// COLS consecutive shared-memory words into registers: 16 bytes a load
// when VEC (the row starts on a 16-byte boundary and COLS is a multiple
// of the 16-byte width), a word a load otherwise.  A broadcast row (every
// lane the same address) costs a quarter of the loads (float32) this way.
template <int COLS, bool VEC>
__device__ __forceinline__ void ld_row(scalar (&v)[COLS], const scalar* p)
{
    constexpr int VW = 16 / (int)sizeof(scalar);
    if constexpr (VEC && COLS % VW == 0) {
        struct alignas(16) Piece { scalar w[VW]; };
#pragma unroll
        for (int q = 0; q < COLS / VW; ++q) {
            const Piece t = reinterpret_cast<const Piece*>(p)[q];
#pragma unroll
            for (int i = 0; i < VW; ++i) v[q * VW + i] = t.w[i];
        }
    } else {
#pragma unroll
        for (int c = 0; c < COLS; ++c) v[c] = p[c];
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
