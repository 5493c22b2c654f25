// Conic ADMM iteration kernels for NVIDIA Hopper (sm_90a), plain C
// interface.
//
// Four kernels, the counterparts of the kernels in
// pdp_lqr_tpu/ops/pallas_admm.py:
//
//   admm_bwd_vec_prefold  <- _admm_bwd_vec_prefold_kernel
//                            (admm_bwd_vec_prefold_lanes, K4)
//   admm_bwd_vec          <- _admm_bwd_vec_kernel_il
//                            (admm_bwd_vec_lanes, K6)
//   admm_fwd_update       <- _admm_fwd_update_kernel_il
//                            (admm_fwd_update_lanes, K5)
//   admm_iter             <- _admm_iter_kernel (admm_iter_lanes, K8)
//
// One model serves Bt scenarios.  Every tensor is batch-last: element
// (k, i, j) of scenario b of an (N, R, C, Bt) tensor lives at
// ((k*R + i)*C + j)*Bt + b; the shared streams carry Bt = 1.  The problem
// sizes are compile-time constants; a shared library is one
// specialisation:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -DSCALAR=float -DNX=12 -DNU=4 \
//        [-DNC=19 [-DNRUNG=4] (-DFOLD=1 | [-DITER=1 | -DDIAG_COST=1]
//         -DHAS_SHIFT=1 -DNCONES=1 -DCONE0=16003000)]
//
// Without -DNC the library holds K4 (it reads no constraint rows); with it
// and -DFOLD, K6; with it and -DITER, K8; with it alone, K5, whose cost
// form (DIAG_COST: Hs is the diagonal) is compile-time.  K5's and K8's
// shift presence and cone list (NCONES cones, each one integer
// offset * 1000000 + dim * 1000 + kind, kind 0 a second-order cone, 1 a
// rotated one) are compile-time too.  NRUNG (default 1) is the number of
// rho-ladder rungs whose factors K6 and K5 read, stacked on the rows of
// their shared streams: a scenario's rung is an int32 index, and a lane
// reads that rung's matrices at an offset in the ring slot, which holds
// all of them (the TPU kernels blend all rungs with one-hot weights).
//
// What bounds K4-K6 on this card is bytes (the per-scenario streams; the
// shared ones are kilobytes), and what a plain loop runs into first is
// latency: N dependent stages, a few thousand scenarios.  So K4, K5 and K6
// give the warps of a block roles on 32 scenarios, a lane each: a producer
// copies every stage into a ring of shared-memory slots, one warp runs the
// carry's chain (p backwards in K4 and K6, x+ = M x + v forwards in K5),
// and the rest of a stage runs on other warps that take whole stages
// ahead of it (K6's fold) or behind it (the tails), handed on by
// shared-memory barriers (hopper_sync.cuh); see each kernel.  The whole
// horizon runs inside one launch; the per-scenario carry (p; x and the
// four residual maxima) never leaves the block.  K8 carries per-scenario
// matrices and has a design of its own (see there).
//
// Narrow streams (-DSTAGE_BF16=1; K4, K5, K6): the JAX package's narrow
// set of a kernel's streams (its storage_dtype on the split and ladder
// iterations) stored in bfloat16 while every product runs in SCALAR: K4's
// AK, BL and c; K6's A, B, h, D, P, L, K and c; K5's M, K, Hs, D and h.
// The shared runs among them (a few kilobytes a stage, one copy that every
// block reads from the L2) are widened into the compute-type slot layout
// as they are loaded (wd_load / wd_store: 2-byte loads issued before the
// slot is free, widening stores after), so the chains, folds and tails
// read the slots as they do at full width, each kernel's by a widening
// warp of its own.  The per-scenario c stays 2
// bytes an entry in the slot (a box of a bfloat16 map, or 2-byte loads
// where no box takes its rows) and is widened where it is read.
//
// Each extern "C" entry point launches on the given stream, does not
// synchronise, allocates nothing and returns cudaGetLastError().

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#if defined(ITER) || defined(STAGE_BF16)
#include <cuda_bf16.h>
#endif
#ifdef ITER
#include <type_traits>
#endif

#if !defined(SCALAR) || !defined(NX) || !defined(NU)
#error "build with -DSCALAR=<float|double> -DNX=<n> -DNU=<n> [-DNC=<n> ...]"
#endif
#if defined(ITER) && defined(STAGE_BF16)
#error "K8's storage type is a template switch: -DSTAGE_BF16 is for K4-K6"
#endif
#ifndef NRUNG
#define NRUNG 1
#endif

#include "lanes_common.cuh"
#include "hopper_sync.cuh"

namespace {

#ifndef ITER
// The storage type of the narrow streams, and its widening to SCALAR.
#ifdef STAGE_BF16
typedef __nv_bfloat16 stage_t;
__device__ __forceinline__ scalar up(stage_t v)
{
    return (scalar)__bfloat162float(v);
}
#else
typedef scalar stage_t;
__device__ __forceinline__ scalar up(stage_t v) { return v; }
#endif
constexpr bool NARROW = sizeof(stage_t) != sizeof(scalar);

// The narrow forms' widening of shared runs into a slot, by one warp.
// RUNS lists a stage's runs (NR of them; run q: words(q) entries, rows of
// cols(q) words laid pitch(q) words apart from slot word dst(q)); lane l
// takes entries l, l + 32, ... of each run.  wd_load issues its 2-byte
// loads into registers (v) before the slot is free, wd_store writes them
// widened once it is; wd_arrive, the warp's barrier arrival (release)
// after the stores, hands them on.  A load waits for its data, where a
// copy of the full-width form does not: every block reaches a stage's
// runs at about the same time, so each stage would wait out a trip to
// device memory.  wd_prefetch asks the L2 cache for the runs WD_AHEAD
// stages ahead, so the loads find them there.
constexpr int WD_AHEAD = 4;
template <class RUNS, int Q = 0>
__device__ __forceinline__ void wd_prefetch(const stage_t* const* at, int lane)
{
    if constexpr (Q < RUNS::NR) {
        // The lines from the run's first byte on that cover its last.
        constexpr int LINES = (RUNS::words(Q) * (int)sizeof(stage_t) + 127)
            / 128;
#pragma unroll 1
        for (int j = lane; j < LINES; j += 32)
            prefetch_l2(reinterpret_cast<const char*>(at[Q]) + j * 128);
        wd_prefetch<RUNS, Q + 1>(at, lane);
    }
}
template <class RUNS>
__host__ __device__ constexpr int wd_per(int q)
{
    return (RUNS::words(q) + 31) / 32;
}
template <class RUNS>
__host__ __device__ constexpr int wd_base(int q)
{
    int b = 0;
    for (int i = 0; i < q; ++i) b += wd_per<RUNS>(i);
    return b;
}
template <class RUNS>
__host__ __device__ constexpr int wd_total()
{
    return wd_base<RUNS>(RUNS::NR) > 0 ? wd_base<RUNS>(RUNS::NR) : 1;
}
// After a warp's widening stores: one arrival for the warp (the warp's
// barrier orders its lanes' stores before lane 0's release): one atomic
// update of the slot's barrier a warp, not one a lane.
__device__ __forceinline__ void wd_arrive(mbar_t* bar, int lane)
{
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
}

// at[q]: run q of this stage.
template <class RUNS, int Q = 0>
__device__ __forceinline__ void wd_load(stage_t* v, const stage_t* const* at,
                                        int lane)
{
    if constexpr (Q < RUNS::NR) {
        constexpr int PER = wd_per<RUNS>(Q), BASE = wd_base<RUNS>(Q);
#pragma unroll
        for (int i = 0; i < PER; ++i) {
            const int e = i * 32 + lane;
            if (e < RUNS::words(Q)) v[BASE + i] = at[Q][e];
        }
        wd_load<RUNS, Q + 1>(v, at, lane);
    }
}
template <class RUNS, int Q = 0>
__device__ __forceinline__ void wd_store(scalar* S, const stage_t* v, int lane)
{
    if constexpr (Q < RUNS::NR) {
        constexpr int PER = wd_per<RUNS>(Q), BASE = wd_base<RUNS>(Q);
        constexpr int COLS = RUNS::cols(Q) > 0 ? RUNS::cols(Q) : 1;
#pragma unroll
        for (int i = 0; i < PER; ++i) {
            const int e = i * 32 + lane;
            if (e < RUNS::words(Q))
                S[RUNS::dst(Q) + e / COLS * RUNS::pitch(Q) + e % COLS] =
                    up(v[BASE + i]);
        }
        wd_store<RUNS, Q + 1>(S, v, lane);
    }
}
#endif  // !ITER

#if !defined(NC) || defined(FOLD)
// ------------------------------------------------ kernels A: K4 and K6
// The cached-factor vector recursion, backwards from p = pN:
//   Pcp  = Pc + p                 rbar = hf[:nu] + B^T Pcp
//   d    = -(L L^T)^{-1} rbar     v    = B d + c
//   p    = hf[nu:] + A^T Pcp + K^T rbar
// written as dv = [d | v].  K4 reads hf and Pc as given; K6 folds them from
// the iterates first (see there).  What bounds both on this card is bytes
// (the scenarios' rows; the shared matrices are a few kilobytes a stage),
// and what a plain loop runs into first is the carry's chain: N dependent
// stages.  But the carry p needs only Pcp, rbar and p; the fold, d, v and
// their stores hang off it.  So the warps of a block take roles on 32
// consecutive scenarios (a lane each), as K5 and shared K2 do:
//   * producers copy each stage into a ring of slots: the shared runs
//     (K4: by cp.async, 16 bytes a copy where they allow; K6: see there),
//     the scenarios' rows as 2-D boxes of the copy engine (TMA) where the
//     row stride allows, else by cp.async a word a copy;
//   * the chain warp carries p in registers (a lane holds its scenario's
//     whole stage: no exchange), reads the rows of A, B and K as
//     broadcasts in axpy order (acc[i] += A[t][i] Pcp[t] over A's
//     contiguous rows, so the packed streams are read as they lie) and
//     leaves rbar in the slot (va_chain);
//   * (K6) fold warps take whole stages ahead of the chain;
//   * tail warps take whole stages behind it (tail t: stages t, t + T,
//     ...): d, v and the dv stores, a warp's store of a row one line
//     (va_tail).
// Shared-memory barriers hand a slot on (hopper_sync.cuh): `full` (the
// copies landed), `folded` (K6: hf and Pc are in the slot), `ready` (rbar
// is) and `empty` (the tail is done with it); no block-wide barrier a
// stage.  A waiter names only the parity of the phase it waits for, so no
// role has more warps than the ring has slots (see K5).  Per-stage loops
// that several warps run at different points stay rolled (K5's lesson:
// the instruction cache).  A lane past the batch computes on the last
// scenario's rows (zeros where the copy engine takes them) and stores
// nothing.

constexpr int VA_W = 32;                      // scenarios a block, a lane each
constexpr int VA_VW = 16 / (int)sizeof(scalar);
// Rows of nx, nu and nz words read 16 bytes a load where the widths allow.
constexpr bool VA_VX = NX % VA_VW == 0;
constexpr bool VA_VU = NU % VA_VW == 0;
constexpr bool VA_VZ = NZ % VA_VW == 0;
constexpr int VA_SMEM_MAX = 232448;           // 227 KB, the most a block has
constexpr int VA_TAILS_MAX = 3;

// A shared run's words in a slot: whole 16-byte pieces.
__host__ __device__ constexpr int va_run(int words)
{
    return (words + VA_VW - 1) / VA_VW * VA_VW;
}
// A rung's stride in a slot: an odd number of 16-byte pieces, so that the
// lanes of a ladder block, on different rungs, read different banks.
__host__ __device__ constexpr int va_rung(int words)
{
    return va_run(words) / VA_VW % 2 ? va_run(words) : va_run(words) + VA_VW;
}
// The scenarios' rows start on a 128-byte boundary (the copy engine's boxes).
__host__ __device__ constexpr int va_rows(int words)
{
    return (words + 31) / 32 * 32;
}
__host__ __device__ constexpr int va_min(int a, int b) { return a < b ? a : b; }
// Slots of `slot` words (and four barriers each) in a block.
__host__ __device__ constexpr int va_fit(int slot)
{
    return (VA_SMEM_MAX - 128) / (slot * (int)sizeof(scalar) + 4 * 8);
}

// One stage of the chain for the lane's scenario:
//   Pcp = Pc + p,  rbar = hf_u + B^T Pcp,  p <- hf_x + A^T Pcp + K^T rbar,
// rbar left at rb.  sA: A[t][i] at t*NX + i; sB: B[t][j] at t*NU + j; sK:
// K[u][i] at u*NX + i; pc, hv, rb: the lane's column of rows VA_W words
// apart.  The sums run in the plain version's order.
__device__ __forceinline__ void va_chain(scalar (&p)[NX], const scalar* sA,
                                         const scalar* sB, const scalar* sK,
                                         const scalar* pc, const scalar* hv,
                                         scalar* rb)
{
    scalar Pcp[NX], rbar[NU], acc[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) Pcp[i] = pc[i * VA_W] + p[i];
#pragma unroll
    for (int j = 0; j < NU; ++j) rbar[j] = hv[j * VA_W];
#pragma unroll
    for (int t = 0; t < NX; ++t) {
        scalar row[NU];
        ld_row<NU, VA_VU>(row, sB + t * NU);
#pragma unroll
        for (int j = 0; j < NU; ++j) rbar[j] += row[j] * Pcp[t];
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) acc[i] = hv[(NU + i) * VA_W];
#pragma unroll
    for (int t = 0; t < NX; ++t) {
        scalar row[NX];
        ld_row<NX, VA_VX>(row, sA + t * NX);
#pragma unroll
        for (int i = 0; i < NX; ++i) acc[i] += row[i] * Pcp[t];
    }
#pragma unroll
    for (int u = 0; u < NU; ++u) {
        scalar row[NX];
        ld_row<NX, VA_VX>(row, sK + u * NX);
#pragma unroll
        for (int i = 0; i < NX; ++i) acc[i] += row[i] * rbar[u];
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) p[i] = acc[i];
    // rbar into the slot last: a store before the loads above would hold
    // them behind it (they might alias).
#pragma unroll
    for (int u = 0; u < NU; ++u) rb[u * VA_W] = rbar[u];
}

// One stage of a tail warp for the lane's scenario: d = -(L L^T)^{-1} rbar
// and v = B d + c, stored at out[j * Bs] (d, j < NU) and out[(NU + i) *
// Bs] (v); a lane past the batch stores nothing.  sL: L[i][j] at i*NU + j;
// sB as in va_chain; cv (the storage type, widened here), rb: the lane's
// column of rows VA_W entries apart.
__device__ __forceinline__ void va_tail(const scalar* sL, const scalar* sB,
                                        const stage_t* cv, const scalar* rb,
                                        scalar* out, size_t Bs, bool valid)
{
    scalar dv[NU], inv[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) inv[i] = (scalar)1 / sL[i * NU + i];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
        scalar acc = rb[i * VA_W];
#pragma unroll
        for (int t = 0; t < i; ++t) acc -= sL[i * NU + t] * dv[t];
        dv[i] = acc * inv[i];
    }
#pragma unroll
    for (int i = NU - 1; i >= 0; --i) {
        scalar acc = dv[i];
#pragma unroll
        for (int t = i + 1; t < NU; ++t) acc -= sL[t * NU + i] * dv[t];
        dv[i] = acc * inv[i];
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
        dv[i] = -dv[i];
        if (valid) out[i * Bs] = dv[i];
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
        scalar row[NU];
        ld_row<NU, VA_VU>(row, sB + i * NU);
        scalar vv = up(cv[i * VA_W]);
#pragma unroll
        for (int t = 0; t < NU; ++t) vv += row[t] * dv[t];
        if (valid) out[(NU + i) * Bs] = vv;
    }
}

// Whether the scenarios' rows can go by the copy engine: the row stride a
// multiple of 16 bytes (narrow: of c's 2-byte entries too, B a multiple
// of 8), the streams 16-byte aligned, a box's rows within its limit of 256.
inline bool va_boxes(int Bt, int rows, const void* a, const void* b,
                     const void* c)
{
    return (size_t)Bt * sizeof(scalar) % 16 == 0
        && (size_t)Bt * sizeof(stage_t) % 16 == 0 && rows <= 256
        && (((size_t)a | (size_t)b | (size_t)c) & 15) == 0;
}

// The narrow forms' c rows where no box takes them: this lane's scenario
// (bc, the last one's past the batch) of ROWS rows (row r at src[r *
// Bs]), loaded before the slot is free and stored, still 2 bytes an
// entry, into the slot's rows of VA_W entries after; rows_prefetch asks
// the L2 cache for a later stage's rows of the block's scenarios from b0
// (lane r: row r's first and last entry).
template <int ROWS>
__device__ __forceinline__ void rows_prefetch(const stage_t* src, size_t Bs,
                                              size_t b0, int lane)
{
    const size_t last = b0 + VA_W - 1 < Bs ? b0 + VA_W - 1 : Bs - 1;
    if (lane < ROWS) {
        prefetch_l2(src + lane * Bs + b0);
        prefetch_l2(src + lane * Bs + last);
    }
}
template <int ROWS>
__device__ __forceinline__ void rows_load(stage_t (&v)[ROWS],
                                          const stage_t* src, size_t Bs,
                                          size_t bc)
{
#pragma unroll
    for (int r = 0; r < ROWS; ++r) v[r] = src[r * Bs + bc];
}
template <int ROWS>
__device__ __forceinline__ void rows_store(stage_t* dst,
                                           const stage_t (&v)[ROWS], int lane)
{
#pragma unroll
    for (int r = 0; r < ROWS; ++r) dst[r * VA_W + lane] = v[r];
}

// Diagnostic build (-DADMM_PROFILE): lane 0 of each role's first warp in
// block 0 sums the SM cycles of its sections (a fold or tail warp's per
// stage it took); admm_read_prof copies the sums out.  Sections: producer
// waiting, copying; fold waiting, folding; chain waiting, computing; tail
// waiting, computing and storing; (K6 narrow) widening warp waiting,
// widening.
constexpr int VA_SECTIONS = 10;
#ifdef ADMM_PROFILE
__device__ long long admm_prof[VA_SECTIONS];
#define VA_PROF_INIT                                                         \
    long long prof_acc[VA_SECTIONS] = {};                                    \
    long long prof_t = clock64();
#define VA_MARK(i)                                                           \
    do {                                                                     \
        const long long t_ = clock64();                                      \
        prof_acc[i] += t_ - prof_t;                                          \
        prof_t = t_;                                                         \
    } while (0)
#define VA_PROF_DONE(lo, hi, mul, div)                                       \
    if (blockIdx.x == 0 && lane == 0)                                        \
        for (int i_ = lo; i_ < hi; ++i_)                                     \
            admm_prof[i_] = prof_acc[i_] * (mul) / (div);
#else
#define VA_PROF_INIT
#define VA_MARK(i)
#define VA_PROF_DONE(lo, hi, mul, div)
#endif
#endif  // K4, K6

#ifndef NC
// ------------------------------------------------------------------- K4
// Kernel A on the emitted hf: the packed shared streams AK = [A; K] (nz x
// nx a stage) and BL = [B; L] (nz x nu) ride the slot as they lie (the
// chain walks the rows of A and K, so nothing repacks the factors per
// call), with the scenarios' rows of c, hf and the pre-folded Pc.  Warps:
// the producer (warp 0: two runs and three boxes a stage), the chain
// (warp 1), K4_TAILS tail warps.  Measured on an H100 (PERF.md):
// the chain bounds it (about 830 cycles a stage).  Narrow form: a warp of
// its own, after the tails, widens AK and BL into their slot runs
// (K4Runs) and, where no box takes them, copies c's rows; c lands 2 bytes
// an entry in the first half of its rows (the tails widen it).  Its loads
// wait for their data, so the producer's boxes are kept off its path.

constexpr int K4_AK = 0;
constexpr int K4_BL = K4_AK + va_run(NZ * NX);
constexpr int K4_C = va_rows(K4_BL + va_run(NZ * NU));
constexpr int K4_HF = K4_C + NX * VA_W;
constexpr int K4_PC = K4_HF + NZ * VA_W;
constexpr int K4_RB = K4_PC + NX * VA_W;       // the chain's rbar
constexpr int K4_SLOT = K4_RB + NU * VA_W;
// Stages in flight: one a tail warp, the chain and the producer ahead.
constexpr int K4_SLOTS = va_min(va_fit(K4_SLOT), VA_TAILS_MAX + 5);
constexpr int K4_TAILS = va_min(K4_SLOTS, VA_TAILS_MAX);
constexpr int K4_WIDEN = 2 + K4_TAILS;   // the narrow form's widening warp
constexpr int K4_THREADS = 32 * (K4_WIDEN + NARROW);
static_assert(K4_SLOTS >= 2, "K4: two stages do not fit a block");
constexpr int K4_BAR = K4_SLOTS * K4_SLOT * (int)sizeof(scalar);
constexpr int K4_SMEM = K4_BAR + 3 * 8 * K4_SLOTS + 128;   // + alignment
// The shared runs of a stage (the narrow form widens them): AK, BL.
struct K4Runs {
    static constexpr int NR = 2;
    static __host__ __device__ constexpr int words(int q)
    {
        return q == 0 ? NZ * NX : NZ * NU;
    }
    static __host__ __device__ constexpr int cols(int q) { return words(q); }
    static __host__ __device__ constexpr int pitch(int q) { return words(q); }
    static __host__ __device__ constexpr int dst(int q)
    {
        return q == 0 ? K4_AK : K4_BL;
    }
};

__global__ void __launch_bounds__(K4_THREADS, 1)
bwd_vec_prefold_kernel(
    int N, int Bt,
    const scalar* __restrict__ pN, const stage_t* __restrict__ AK,
    const stage_t* __restrict__ BL, const stage_t* __restrict__ c,
    const scalar* __restrict__ Pc, const scalar* __restrict__ hf,
    scalar* __restrict__ dv_out,
    const __grid_constant__ CUtensorMap c_map,
    const __grid_constant__ CUtensorMap hf_map,
    const __grid_constant__ CUtensorMap pc_map, int tma)
{
    extern __shared__ double smem_aligned[];
    char* base = reinterpret_cast<char*>(
        (reinterpret_cast<size_t>(smem_aligned) + 127) / 128 * 128);
    scalar* ring = reinterpret_cast<scalar*>(base);
    mbar_t* full = reinterpret_cast<mbar_t*>(base + K4_BAR);
    mbar_t* ready = full + K4_SLOTS;
    mbar_t* empty = ready + K4_SLOTS;

    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const size_t Bs = (size_t)Bt;
    const size_t b0 = (size_t)blockIdx.x * VA_W;
    const size_t b = b0 + lane;
    const bool valid = b < Bs;

    if (threadIdx.x == 0) {
        for (int s = 0; s < K4_SLOTS; ++s) {
            mbar_init(&full[s], NARROW ? 34 : 33);   // the producer's lanes
                                                 // and lane 0's boxes or
                                                 // arrival (narrow: and the
                                                 // widening warp's lane 0)
            mbar_init(&ready[s], 32);            // the chain's
            mbar_init(&empty[s], 32);            // the stage's tail warp's
        }
    }
    __syncthreads();

    // Stage n of the sweep is model stage k = N-1-n, in slot n % K4_SLOTS.
    if (warp == K4_WIDEN) {
        // ---- (narrow form) widening warp: AK, BL; c's rows where no box
        // takes them.
        const size_t bc = valid ? b : Bs - 1;
        stage_t wide[wd_total<K4Runs>()], cv[NX];
#pragma unroll 1
        for (int n = 0; n < N; ++n) {
            const int s = n % K4_SLOTS;
            const size_t ks = (size_t)(N - 1 - n);
            if (n + WD_AHEAD < N) {
                const size_t ka = ks - WD_AHEAD;
                const stage_t* ahead[2] = {AK + ka * NZ * NX,
                                           BL + ka * NZ * NU};
                wd_prefetch<K4Runs>(ahead, lane);
                if (!tma) rows_prefetch<NX>(c + ka * NX * Bs, Bs, b0, lane);
            }
            const stage_t* at[2] = {AK + ks * NZ * NX, BL + ks * NZ * NU};
            wd_load<K4Runs>(wide, at, lane);
            if (!tma) rows_load<NX>(cv, c + ks * NX * Bs, Bs, bc);
            if (n >= K4_SLOTS) mbar_wait(&empty[s], (n / K4_SLOTS - 1) & 1);
            scalar* S = ring + s * K4_SLOT;
            wd_store<K4Runs>(S, wide, lane);
            if (!tma)
                rows_store<NX>(reinterpret_cast<stage_t*>(S + K4_C), cv, lane);
            wd_arrive(&full[s], lane);
        }
    } else if (warp == 0) {
        // ---- producer.
        const bool vec = Bs % VA_VW == 0 && b0 + VA_W <= Bs
            && (((size_t)c | (size_t)hf | (size_t)Pc) & 15) == 0;
        constexpr int CB = NX * VA_W * (int)sizeof(stage_t);   // c's box
        VA_PROF_INIT
#pragma unroll 1
        for (int n = 0; n < N; ++n) {
            const int s = n % K4_SLOTS;
            const size_t ks = (size_t)(N - 1 - n);
            if (n >= K4_SLOTS) mbar_wait(&empty[s], (n / K4_SLOTS - 1) & 1);
            VA_MARK(0);
            scalar* S = ring + s * K4_SLOT;
            if constexpr (!NARROW) {
                // (Full width: stage_t is scalar.)
                warp_copy_run(S + K4_AK, (const scalar*)AK + ks * NZ * NX,
                              NZ * NX, lane);
                warp_copy_run(S + K4_BL, (const scalar*)BL + ks * NZ * NU,
                              NZ * NU, lane);
            }
            if (tma) {
                if (lane == 0) {
                    mbar_arrive_expect_tx(
                        &full[s], CB + (NX + NZ) * VA_W * (int)sizeof(scalar));
                    tma_box(S + K4_C, &c_map, (int)b0, (int)ks * NX, &full[s]);
                    tma_box(S + K4_HF, &hf_map, (int)b0, (int)ks * NZ, &full[s]);
                    tma_box(S + K4_PC, &pc_map, (int)b0, (int)ks * NX, &full[s]);
                }
            } else {
                if constexpr (!NARROW)
                    warp_copy_rows<VA_W>(S + K4_C, (const scalar*)c
                                         + ks * NX * Bs, NX, Bs, b0, vec,
                                         lane);
                warp_copy_rows<VA_W>(S + K4_HF, hf + ks * NZ * Bs, NZ, Bs, b0,
                                     vec, lane);
                warp_copy_rows<VA_W>(S + K4_PC, Pc + ks * NX * Bs, NX, Bs, b0,
                                     vec, lane);
                if (lane == 0) mbar_arrive(&full[s]);
            }
            mbar_arrive_on_copies(&full[s]);
            VA_MARK(1);
        }
        VA_PROF_DONE(0, 2, 1, 1)
    } else if (warp == 1) {
        // ---- chain: p, rbar left in the slot.
        const size_t bc = valid ? b : Bs - 1;
        scalar p[NX];
#pragma unroll
        for (int i = 0; i < NX; ++i) p[i] = pN[i * Bs + bc];
        VA_PROF_INIT
#pragma unroll 1
        for (int n = 0; n < N; ++n) {
            const int s = n % K4_SLOTS;
            mbar_wait(&full[s], (n / K4_SLOTS) & 1);
            VA_MARK(4);
            scalar* S = ring + s * K4_SLOT;
            va_chain(p, S + K4_AK, S + K4_BL, S + K4_AK + NX * NX,
                     S + K4_PC + lane, S + K4_HF + lane, S + K4_RB + lane);
            mbar_arrive(&ready[s]);
            VA_MARK(5);
        }
        VA_PROF_DONE(4, 6, 1, 1)
    } else {
        // ---- tail warp t: stages t, t + K4_TAILS, ...: d, v, the stores.
        const int t = warp - 2;
        VA_PROF_INIT
#pragma unroll 1
        for (int n = t; n < N; n += K4_TAILS) {
            const int s = n % K4_SLOTS;
            mbar_wait(&ready[s], (n / K4_SLOTS) & 1);
            VA_MARK(6);
            const size_t ks = (size_t)(N - 1 - n);
            const scalar* S = ring + s * K4_SLOT;
            va_tail(S + K4_BL + NX * NU, S + K4_BL,
                    reinterpret_cast<const stage_t*>(S + K4_C) + lane,
                    S + K4_RB + lane, dv_out + ks * NZ * Bs + b, Bs, valid);
            mbar_arrive(&empty[s]);
            VA_MARK(7);
        }
        if (t == 0) {
            VA_PROF_DONE(6, 8, N, (N + K4_TAILS - 1) / K4_TAILS)
        }
    }
}

#elif defined(FOLD)
// ------------------------------------------------------------------- K6
// K4's recursion with the iterate fold in front of it, on the scenario's
// own rung of R stacked factor sets.  Per stage, backwards from p = pN:
//   rg   = rho m z - y             hf = h - sigma w - D^T rg
//   Pc   = P c  (or Pc as given)   then K4's recursion on hf, Pc
// None of the fold waits for p, so it has warps of its own: K6_FOLDS fold
// warps take whole stages ahead of the chain (fold f: stages f, f +
// K6_FOLDS, ...), a lane a scenario: rg and all nz rows of hf (D's rows in
// axpy order), and, with the P stream, Pc = P_r c on the scenario's rung;
// they leave hf and Pc in the slot.  Its stage brings five times K4's
// shared bytes: A, B, h, D, the rho scale m, and the R rungs of P, L and
// K (each rung at an odd number of 16-byte pieces in the slot, so that
// lanes on different rungs read different banks), besides the scenarios'
// rows of c, wzy = [w | z | y] and (Pc mode) Pc.  One producer warp took
// 2,300-2,900 cycles a stage to start them, by cp.async or by the copy
// engine alike (an H100, PERF.md), so K6_PRODUCERS warps deal a
// stage's copies: the shared runs as bulk copies of the copy engine (the
// rung streams as one box each, its padding landing as zeros), the rows
// as boxes on a warp of their own.  Warps: the chain (warp 0), the folds,
// the tails, the producers.  PC_MODE: the per-scenario Pc = P_{k+1} c_k
// rides the ring instead of the P stream (one rung only).  Narrow form: a
// widening warp of its own (after the producers), K4's narrow design,
// loads every shared run but the rho scale (K6Runs: A, B, h, D and the
// rungs of P, L and K, about 1,300 entries a stage at the quadrotor's
// widths on four rungs), asked of the L2 WD_AHEAD stages ahead, stores
// them widened into the slot layout of the full-width form once the
// slot's copies have landed, and hands the slot to the folds (`widened`);
// the producers issue copies only (the rho scale's, the rows' boxes), so
// none of them waits for a load.  Measured on an H100 (PERF.md): with the
// producers widening by loads, the narrow form ran 1.4x slower than the
// full width; with the runs brought by the copy engine into a staging
// area of the slot and widened from there, 2.4x; with this warp, faster
// than the full width.  c lands 2 bytes an entry (the folds and the tails
// widen it).

constexpr int K6_NW = NZ + 2 * NC;            // wzy rows: w, z, y
constexpr int K6_FOLDS_MAX = 3;
// Producer warps: a stage's copies are dealt over them (see above).
constexpr int K6_PRODUCERS = 4;
// A stage's copies ("jobs"): the shared runs, each a stage's block of
// `rows` rows of `cols` words (the rung streams a row a rung) laid in the
// slot at a stride of `box` words a row (a rung's: va_rung), then the
// scenarios' rows.  A run goes as one bulk copy where its rows lie back to
// back in the slot and are whole 16-byte pieces, as one box of the copy
// engine where it pads them (the padding lands as zeros past the tensor's
// edge), else by cp.async.
enum { K6_A, K6_B, K6_H, K6_D, K6_MASK, K6_P, K6_L, K6_K, K6_ROWS,
       K6_JOBS };
struct K6Run { int rows, cols, box; };
__host__ __device__ constexpr K6Run k6_run(int q)
{
    return q == K6_A ? K6Run{NX, NX, NX}
        : q == K6_B ? K6Run{NX, NU, NU}
        : q == K6_H ? K6Run{1, NZ, NZ}
        : q == K6_D ? K6Run{NC, NZ, NZ}
        : q == K6_MASK ? K6Run{1, NC, NC}
        : q == K6_P ? K6Run{NRUNG, NX * NX, va_rung(NX * NX)}
        : q == K6_L ? K6Run{NRUNG, NU * NU, va_rung(NU * NU)}
        : K6Run{NRUNG, NU * NX, va_rung(NU * NX)};
}
__host__ __device__ constexpr bool k6_bulk(int q)
{
    return k6_run(q).box == k6_run(q).cols
        && k6_run(q).cols * (int)sizeof(scalar) % 16 == 0;
}
__host__ __device__ constexpr bool k6_boxed(int q)
{
    return k6_run(q).box != k6_run(q).cols
        && k6_run(q).cols * (int)sizeof(scalar) % 16 == 0
        && k6_run(q).box * (int)sizeof(scalar) % 16 == 0
        && k6_run(q).box <= 256 && k6_run(q).rows <= 256;
}
// The producer warp of job q: the rows on the last, the runs dealt over
// the others.
__host__ __device__ constexpr int k6_owner(int q)
{
    return K6_PRODUCERS == 1 ? 0
        : q == K6_ROWS ? K6_PRODUCERS - 1 : q % (K6_PRODUCERS - 1);
}
template <bool PC_MODE> struct K6Layout {
    // Each shared run from a 128-byte boundary: A, B, h, D, the rho scale
    // m, then the R rungs of P (not in Pc mode), L and K, rung r at r times
    // its stride.
    static constexpr int PR = k6_run(K6_P).box;
    static constexpr int LR = k6_run(K6_L).box;
    static constexpr int KR = k6_run(K6_K).box;
    static constexpr int A = 0;
    static constexpr int B = A + va_rows(NX * NX);
    static constexpr int H = B + va_rows(NX * NU);
    static constexpr int D = H + va_rows(NZ);
    static constexpr int MASK = D + va_rows(NC * NZ);
    static constexpr int P = MASK + va_rows(NC);
    static constexpr int L = P + (PC_MODE ? 0 : va_rows(NRUNG * PR));
    static constexpr int K = L + va_rows(NRUNG * LR);
    // The scenarios' rows: c, wzy, Pc (copied in Pc mode, else the folds'),
    // the folds' hf, the chain's rbar.
    static constexpr int C = K + va_rows(NRUNG * KR);
    static constexpr int WZY = C + NX * VA_W;
    static constexpr int PC = WZY + K6_NW * VA_W;
    static constexpr int HF = PC + NX * VA_W;
    static constexpr int RB = HF + NZ * VA_W;
    static constexpr int SLOT = RB + NU * VA_W;
    static constexpr int ROW_BYTES =
        (NX * (int)sizeof(stage_t)
         + (K6_NW + (PC_MODE ? NX : 0)) * (int)sizeof(scalar)) * VA_W;
    static __host__ __device__ constexpr int off(int q)
    {
        return q == K6_A ? A : q == K6_B ? B : q == K6_H ? H : q == K6_D ? D
            : q == K6_MASK ? MASK : q == K6_P ? P : q == K6_L ? L : K;
    }
    // Stages in flight: one a fold and a tail warp, and the chain and the
    // producers ahead (narrow: a fifth barrier a slot, `widened`, counted
    // as 8 bytes more of each slot).
    static constexpr int SLOTS =
        va_min(va_fit(SLOT + (NARROW ? 8 / (int)sizeof(scalar) : 0)),
               K6_FOLDS_MAX + VA_TAILS_MAX + 4);
    static constexpr int BAR = SLOTS * SLOT * (int)sizeof(scalar);
    static constexpr int SMEM = BAR + (4 + NARROW) * 8 * SLOTS + 128;   // + alignment
};
// No role has more warps than slots (the P-stream form has the fewer).
constexpr int K6_FOLDS = va_min(K6Layout<false>::SLOTS, K6_FOLDS_MAX);
constexpr int K6_TAILS = va_min(K6Layout<false>::SLOTS, VA_TAILS_MAX);
// Warps: the chain, the folds, the tails, the producers, (narrow) the
// widening warp.
constexpr int K6_PROD0 = 1 + K6_FOLDS + K6_TAILS;
constexpr int K6_WIDEN = K6_PROD0 + K6_PRODUCERS;
constexpr int K6_THREADS = 32 * (K6_WIDEN + NARROW);
static_assert(K6Layout<false>::SLOTS >= 2, "K6: two stages do not fit a block");
// The shared runs the narrow form widens: every run but the rho scale (P
// none in Pc mode), each in its full-width slot place.
template <bool PC_MODE> struct K6Runs {
    static constexpr int NR = K6_ROWS - 1;
    static __host__ __device__ constexpr int job(int q)
    {
        return q < K6_MASK ? q : q + 1;
    }
    static __host__ __device__ constexpr int cols(int q)
    {
        return k6_run(job(q)).cols;
    }
    static __host__ __device__ constexpr int words(int q)
    {
        return PC_MODE && job(q) == K6_P ? 0 : k6_run(job(q)).rows * cols(q);
    }
    static __host__ __device__ constexpr int pitch(int q)
    {
        return k6_run(job(q)).box;
    }
    static __host__ __device__ constexpr int dst(int q)
    {
        return K6Layout<PC_MODE>::off(job(q));
    }
};

// The copy engine's maps: the scenarios' rows of c, wzy and Pc, then the
// rung streams P, L and K.
enum { K6_MC, K6_MWZY, K6_MPC, K6_MP, K6_ML, K6_MK, K6_MAPS };
struct K6Maps { CUtensorMap m[K6_MAPS]; };

template <bool PC_MODE>
__global__ void __launch_bounds__(K6_THREADS, 1)
bwd_vec_kernel(
    int N, int Bt, double sigma_d,
    const scalar* __restrict__ rho, const scalar* __restrict__ pN,
    const stage_t* __restrict__ A, const stage_t* __restrict__ B,
    const stage_t* __restrict__ h, const stage_t* __restrict__ D,
    const scalar* __restrict__ mask, const stage_t* __restrict__ P,
    const stage_t* __restrict__ L, const stage_t* __restrict__ K,
    const stage_t* __restrict__ c, const scalar* __restrict__ Pc,
    const scalar* __restrict__ wzy, const int* __restrict__ rung,
    scalar* __restrict__ dv_out, const __grid_constant__ K6Maps maps,
    int row_boxes, int run_copies)
{
    using Lay = K6Layout<PC_MODE>;
    constexpr int SLOTS = Lay::SLOTS;
    extern __shared__ double smem_aligned[];
    char* base = reinterpret_cast<char*>(
        (reinterpret_cast<size_t>(smem_aligned) + 127) / 128 * 128);
    scalar* ring = reinterpret_cast<scalar*>(base);
    mbar_t* full = reinterpret_cast<mbar_t*>(base + Lay::BAR);
    mbar_t* folded = full + SLOTS;
    mbar_t* ready = folded + SLOTS;
    mbar_t* empty = ready + SLOTS;
    mbar_t* widened = empty + SLOTS;          // (narrow)
    using Runs = K6Runs<PC_MODE>;
    // The shared runs of the storage type, in the slot's order.
    const stage_t* narrow_src[Runs::NR] = {A, B, h, D, P, L, K};

    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const size_t Bs = (size_t)Bt;
    const size_t b0 = (size_t)blockIdx.x * VA_W;
    const size_t b = b0 + lane;
    const bool valid = b < Bs;
    const size_t bc = valid ? b : Bs - 1;
    // This scenario's rung: where its P, L and K lie in a slot.
    const int r_ix = NRUNG > 1 ? rung[bc] : 0;

    if (threadIdx.x == 0) {
        for (int s = 0; s < SLOTS; ++s) {
            mbar_init(&full[s], 33 * K6_PRODUCERS + NARROW);
                                                 // each producer's lanes, and
                                                 // its lane 0's with the bytes
                                                 // it expects (narrow: and the
                                                 // rows warp's once after its
                                                 // stores of c's rows)
            mbar_init(&folded[s], 32);           // the stage's fold warp's
            mbar_init(&ready[s], 32);            // the chain's
            mbar_init(&empty[s], 32);            // the stage's tail warp's
            if (NARROW) mbar_init(&widened[s], 1);   // the widening warp's
        }
    }
    __syncthreads();

    // Stage n of the sweep is model stage k = N-1-n, in slot n % SLOTS.
    if (NARROW && warp == K6_WIDEN) {
        // ---- (narrow form) widening warp: the shared runs, loaded (asked
        // of the L2 WD_AHEAD stages ahead), stored widened into the slot
        // once its copies have landed.
        stage_t wide[wd_total<Runs>()];
        VA_PROF_INIT
#pragma unroll 1
        for (int n = 0; n < N; ++n) {
            const int s = n % SLOTS;
            const size_t ks = (size_t)(N - 1 - n);
            const stage_t* at[Runs::NR];
            if (n + WD_AHEAD < N) {
#pragma unroll
                for (int q = 0; q < Runs::NR; ++q)
                    at[q] = narrow_src[q] + (ks - WD_AHEAD) * Runs::words(q);
                wd_prefetch<Runs>(at, lane);
            }
#pragma unroll
            for (int q = 0; q < Runs::NR; ++q)
                at[q] = narrow_src[q] + ks * Runs::words(q);
            wd_load<Runs>(wide, at, lane);
            mbar_wait(&full[s], (n / SLOTS) & 1);
            VA_MARK(8);
            wd_store<Runs>(ring + s * Lay::SLOT, wide, lane);
            wd_arrive(&widened[s], lane);
            VA_MARK(9);
        }
        VA_PROF_DONE(8, 10, 1, 1)
    } else if (warp >= K6_PROD0) {
        // ---- producer warp pw: its jobs of each stage.
        const int pw = warp - K6_PROD0;
        constexpr int SZ = (int)sizeof(scalar);
        const scalar* src[K6_ROWS] = {
            (const scalar*)A, (const scalar*)B, (const scalar*)h,
            (const scalar*)D, mask, (const scalar*)P, (const scalar*)L,
            (const scalar*)K};
        // Copied as they lie: every run at full width, the rho scale alone
        // in the narrow form.
        auto skip = [](int q) {
            return (PC_MODE && q == K6_P) || (NARROW && q != K6_MASK);
        };
        // The bytes this warp's bulk copies and boxes bring a stage.
        int tx = 0;
        for (int q = 0; q < K6_JOBS; ++q) {
            if (k6_owner(q) != pw || (q != K6_ROWS && skip(q))) continue;
            if (q == K6_ROWS)
                tx += row_boxes ? Lay::ROW_BYTES : 0;
            else if (run_copies && (k6_bulk(q) || k6_boxed(q)))
                tx += k6_run(q).rows * k6_run(q).box * SZ;
        }
        const bool vec = Bs % VA_VW == 0 && b0 + VA_W <= Bs
            && (((size_t)c | (size_t)wzy | (size_t)Pc) & 15) == 0;
        const bool rows_here = k6_owner(K6_ROWS) == pw;
        stage_t cv[NX];
        VA_PROF_INIT
#pragma unroll 1
        for (int n = 0; n < N; ++n) {
            const int s = n % SLOTS;
            const size_t ks = (size_t)(N - 1 - n);
            if constexpr (NARROW) {
                // c's rows where no box takes them (2-byte loads, the rows
                // asked of the L2 WD_AHEAD stages ahead).
                if (rows_here && !row_boxes) {
                    if (n + WD_AHEAD < N)
                        rows_prefetch<NX>(c + (ks - WD_AHEAD) * NX * Bs, Bs,
                                          b0, lane);
                    rows_load<NX>(cv, c + ks * NX * Bs, Bs, bc);
                }
            }
            if (n >= SLOTS) mbar_wait(&empty[s], (n / SLOTS - 1) & 1);
            VA_MARK(0);
            scalar* S = ring + s * Lay::SLOT;
            if (lane == 0) mbar_arrive_expect_tx(&full[s], tx);
            __syncwarp();
#pragma unroll
            for (int q = 0; q < K6_ROWS; ++q) {
                if (k6_owner(q) != pw || skip(q)) continue;
                const K6Run r = k6_run(q);
                scalar* dst = S + Lay::off(q);
                const scalar* from = src[q] + ks * r.rows * r.cols;
                if (run_copies && k6_bulk(q)) {
                    if (lane == 0)
                        bulk_copy(dst, from, r.rows * r.cols * SZ, &full[s]);
                } else if (run_copies && k6_boxed(q)) {
                    if (lane == 0)
                        tma_box(dst, &maps.m[K6_MP + q - K6_P], 0,
                                (int)ks * r.rows, &full[s]);
                } else if (r.box == r.cols) {
                    warp_copy_run(dst, from, r.rows * r.cols, lane);
                } else {
#pragma unroll 1
                    for (int i = 0; i < r.rows; ++i)
                        warp_copy_run(dst + i * r.box, from + i * r.cols,
                                      r.cols, lane);
                }
            }
            if (rows_here) {
                if (row_boxes) {
                    if (lane == 0)
                        tma_box(S + Lay::C, &maps.m[K6_MC], (int)b0,
                                (int)ks * NX, &full[s]);
                    if (lane == 1)
                        tma_box(S + Lay::WZY, &maps.m[K6_MWZY], (int)b0,
                                (int)ks * K6_NW, &full[s]);
                    if (PC_MODE && lane == 2)
                        tma_box(S + Lay::PC, &maps.m[K6_MPC], (int)b0,
                                (int)ks * NX, &full[s]);
                } else {
                    if constexpr (NARROW)
                        rows_store<NX>(reinterpret_cast<stage_t*>(S + Lay::C),
                                       cv, lane);
                    else
                        warp_copy_rows<VA_W>(S + Lay::C, (const scalar*)c
                                             + ks * NX * Bs, NX, Bs, b0, vec,
                                             lane);
                    warp_copy_rows<VA_W>(S + Lay::WZY, wzy + ks * K6_NW * Bs,
                                         K6_NW, Bs, b0, vec, lane);
                    if (PC_MODE)
                        warp_copy_rows<VA_W>(S + Lay::PC, Pc + ks * NX * Bs,
                                             NX, Bs, b0, vec, lane);
                }
            }
            mbar_arrive_on_copies(&full[s]);
            if constexpr (NARROW)
                if (rows_here) wd_arrive(&full[s], lane);
            VA_MARK(1);
        }
        if (pw == 0) {
            VA_PROF_DONE(0, 2, 1, 1)
        }
    } else if (warp == 0) {
        // ---- chain: p, rbar left in the slot.
        scalar p[NX];
#pragma unroll
        for (int i = 0; i < NX; ++i) p[i] = pN[i * Bs + bc];
        VA_PROF_INIT
#pragma unroll 1
        for (int n = 0; n < N; ++n) {
            const int s = n % SLOTS;
            mbar_wait(&folded[s], (n / SLOTS) & 1);
            VA_MARK(4);
            scalar* S = ring + s * Lay::SLOT;
            va_chain(p, S + Lay::A, S + Lay::B, S + Lay::K + r_ix * Lay::KR,
                     S + Lay::PC + lane, S + Lay::HF + lane, S + Lay::RB + lane);
            mbar_arrive(&ready[s]);
            VA_MARK(5);
        }
        VA_PROF_DONE(4, 6, 1, 1)
    } else if (warp <= K6_FOLDS) {
        // ---- fold warp f: stages f, f + K6_FOLDS, ...: hf and Pc.
        const int f = warp - 1;
        const scalar sigma = (scalar)sigma_d;
        const scalar rho_b = rho[bc];
        VA_PROF_INIT
#pragma unroll 1
        for (int n = f; n < N; n += K6_FOLDS) {
            const int s = n % SLOTS;
            // (Narrow: the widening warp's hand-over, after the copies.)
            mbar_wait(NARROW ? &widened[s] : &full[s], (n / SLOTS) & 1);
            VA_MARK(2);
            scalar* S = ring + s * Lay::SLOT;
            const scalar* wv = S + Lay::WZY + lane;      // w rows, z rows, y rows
            // hf = h - sigma w - D^T rg, D^T rg as a sum over D's rows.
            scalar hfv[NZ];
            ld_row<NZ, VA_VZ>(hfv, S + Lay::H);
#pragma unroll
            for (int e = 0; e < NZ; ++e) hfv[e] -= sigma * wv[e * VA_W];
#pragma unroll 4
            for (int ci = 0; ci < NC; ++ci) {
                const scalar rg = rho_b * S[Lay::MASK + ci] * wv[(NZ + ci) * VA_W]
                    - wv[(NZ + NC + ci) * VA_W];
                scalar Dr[NZ];
                ld_row<NZ, VA_VZ>(Dr, S + Lay::D + ci * NZ);
#pragma unroll
                for (int e = 0; e < NZ; ++e) hfv[e] -= rg * Dr[e];
            }
#pragma unroll
            for (int e = 0; e < NZ; ++e) S[Lay::HF + e * VA_W + lane] = hfv[e];
            if (!PC_MODE) {
                // Pc = P_r c on the scenario's rung.
                const scalar* sP = S + Lay::P + r_ix * Lay::PR;
                const stage_t* sc =
                    reinterpret_cast<const stage_t*>(S + Lay::C);
                scalar cv[NX];
#pragma unroll
                for (int t = 0; t < NX; ++t) cv[t] = up(sc[t * VA_W + lane]);
#pragma unroll
                for (int i = 0; i < NX; ++i) {
                    scalar row[NX];
                    ld_row<NX, VA_VX>(row, sP + i * NX);
                    scalar acc = (scalar)0;
#pragma unroll
                    for (int t = 0; t < NX; ++t) acc += row[t] * cv[t];
                    S[Lay::PC + i * VA_W + lane] = acc;
                }
            }
            mbar_arrive(&folded[s]);
            VA_MARK(3);
        }
        if (f == 0) {
            VA_PROF_DONE(2, 4, N, (N + K6_FOLDS - 1) / K6_FOLDS)
        }
    } else {
        // ---- tail warp t: stages t, t + K6_TAILS, ...: d, v, the stores.
        const int t = warp - 1 - K6_FOLDS;
        VA_PROF_INIT
#pragma unroll 1
        for (int n = t; n < N; n += K6_TAILS) {
            const int s = n % SLOTS;
            mbar_wait(&ready[s], (n / SLOTS) & 1);
            VA_MARK(6);
            const size_t ks = (size_t)(N - 1 - n);
            const scalar* S = ring + s * Lay::SLOT;
            va_tail(S + Lay::L + r_ix * Lay::LR, S + Lay::B,
                    reinterpret_cast<const stage_t*>(S + Lay::C) + lane,
                    S + Lay::RB + lane, dv_out + ks * NZ * Bs + b, Bs, valid);
            mbar_arrive(&empty[s]);
            VA_MARK(7);
        }
        if (t == 0) {
            VA_PROF_DONE(6, 8, N, (N + K6_TAILS - 1) / K6_TAILS)
        }
    }
}

#else  // K5, K8
// ------------------------------------------ K5 and K8: the constraint rows
// Both kernels end a stage the same way: relax, project onto the box and
// the cones, dual update, and the residual maxima.  The device code of that
// tail is here, once: the cone list is compile-time (NCONES cones,
// -DCONE<q>), as is the presence of a shift (HAS_SHIFT).

#if !defined(HAS_SHIFT) || !defined(NCONES)
#error "kernels B and K8: build with -DHAS_SHIFT -DNCONES [-DCONE0 ...] as well"
#endif

// Field f (0 offset, 1 dim, 2 kind) of cone q; constant after unrolling.
// Cone q arrives as one integer, -DCONE<q> = offset * 1000000 + dim * 1000
// + kind (a -D value cannot hold a comma).
#define CONE_ROW(v) {(v) / 1000000, (v) / 1000 % 1000, (v) % 1000}
#if NCONES > 8
#error "kernels B and K8: at most 8 cones"
#endif
__device__ __forceinline__ int cone_field(int q, int f)
{
    const int table[NCONES > 0 ? NCONES : 1][3] = {
#if NCONES == 0
        {0, 0, 0}
#endif
#if NCONES > 0
        CONE_ROW(CONE0),
#endif
#if NCONES > 1
        CONE_ROW(CONE1),
#endif
#if NCONES > 2
        CONE_ROW(CONE2),
#endif
#if NCONES > 3
        CONE_ROW(CONE3),
#endif
#if NCONES > 4
        CONE_ROW(CONE4),
#endif
#if NCONES > 5
        CONE_ROW(CONE5),
#endif
#if NCONES > 6
        CONE_ROW(CONE6),
#endif
#if NCONES > 7
        CONE_ROW(CONE7),
#endif
    };
    return table[q][f];
}

// Row j of the projection of one cone block onto its cone.  The block
// lies, already shifted, in rows off .. off+dim-1 of `vx` (row i at
// vx[i * stride]).  kind 0: [t; x] onto ||x|| <= t; kind 1: [p; q; x] onto
// the rotated cone by the change of basis ((p+q)/sqrt2, (p-q)/sqrt2, x).
__device__ __forceinline__ scalar cone_row(const scalar* vx, int stride,
                                           int off, int dim, int kind, int j)
{
    const scalar eps = (scalar)1e-12;
    const scalar rh = (scalar)0.7071067811865476;
    auto at = [&](int i) { return vx[(off + i) * stride]; };
    scalar t = at(0), s = (scalar)0, sq = (scalar)0;
    int first = 1;
    if (kind == 1) {
        const scalar pp = at(0), qq = at(1);
        t = rh * (pp + qq);
        s = rh * (pp - qq);
        sq = s * s;
        first = 2;
    }
    for (int i = first; i < dim; ++i) sq += at(i) * at(i);
    const scalar nxn = sqrt(sq);
    const scalar scale = (scalar)0.5 * (t + nxn);
    const bool inside = nxn <= t;
    const bool polar = nxn <= -t;
    const scalar safe = nxn > eps ? nxn : (scalar)1;
    const scalar t_p = inside ? t : (polar ? (scalar)0 : scale);
    auto x_p = [&](scalar x) {
        return inside ? x : (polar ? (scalar)0 : scale * (x / safe));
    };
    if (kind == 0) return j == 0 ? t_p : x_p(at(j));
    const scalar s_p = x_p(s);
    if (j == 0) return rh * (t_p + s_p);
    if (j == 1) return rh * (t_p - s_p);
    return x_p(at(j));
}

// Row ci of the projection of the value v: its clamp to [lb, ub], or on a
// cone's rows row ci of the cone projection of the shifted block in vx
// (row i at vx[i * stride]), shifted back by sh.
__device__ __forceinline__ scalar project_row(const scalar* vx, int stride,
                                              int ci, scalar v, scalar lb,
                                              scalar ub, scalar sh)
{
    scalar zp = fmin(fmax(v, lb), ub);
#pragma unroll
    for (int q = 0; q < NCONES; ++q) {
        const int off = cone_field(q, 0), dim = cone_field(q, 1);
        if (ci >= off && ci < off + dim) {
            zp = cone_row(vx, stride, off, dim, cone_field(q, 2), ci - off);
            if (HAS_SHIFT) zp -= sh;
        }
    }
    return zp;
}

// The value to project of one constraint row: alpha z~ + (1-alpha) z (the
// relaxation, returned in `relax`) + y / (rho m) on an active row (m > 0).
__device__ __forceinline__ scalar value_to_project(
    scalar zt, scalar z, scalar y, scalar m, scalar rho_m, scalar alpha,
    scalar oma, scalar& relax)
{
    const scalar floor_ = (scalar)1e-30;
    relax = alpha * zt + oma * z;
    return relax + (m > (scalar)0
                    ? y / (rho_m > floor_ ? rho_m : floor_) : (scalar)0);
}

// The dual residual's terms of row e of w, into the running maxima:
//   |(1-alpha) Hs dw + alpha sigma dw + D^T zt|  and  max(|Hs w+ - sigma
//   w+|, |D^T y+|), given Hs dw, Hs w+, D^T zt and D^T y+ of the row.
__device__ __forceinline__ void dual_row(
    scalar Hdw, scalar Hwn, scalar dT, scalar dty, scalar dw_e, scalar wn_e,
    scalar oma, scalar asig, scalar sigma, scalar& rd, scalar& ds)
{
    const scalar dvec = oma * Hdw + asig * dw_e + dT;
    const scalar Hw = Hwn - sigma * wn_e;
    rd = fmax(rd, fabs(dvec));
    ds = fmax(ds, fmax(fabs(Hw), fabs(dty)));
}

#ifndef ITER
// ------------------------------------------------------------------- K5
// Per stage, forwards from x = x0 (alpha the relaxation, m the per-row
// rho scale, 0 on padded rows):
//   u = K x + d            w~ = [u; x]           x+ = M x + v
//   z~ = D w~              w+ = alpha w~ + (1-alpha) w
//   v  = alpha z~ + (1-alpha) z + [m>0] y / (rho m)
//   z+ = project(v) [m>0]  y+ = y + rho m (alpha z~ + (1-alpha) z - z+)
//   hf+ = h - sigma w+ - D^T (rho m z+ - y+)      (EMIT_HF: next
//                                                   iteration's cost)
// and the running maxima over the stages of the four residual terms
//   |D w+ - z+|,
//   |(1-alpha) Hs (w - w~) + alpha sigma (w - w~)
//      + D^T rho m ((alpha-1)(z~ - z) + (z - z+))|,
//   max(|D w+|, |z+|),  max(|Hs w+ - sigma w+|, |D^T y+|).
// M and K come as two streams with a stage stride each: the packed
// MK = [M; K] of one rung is both at once (stride nz*nx, K nx*nx words
// in), the rung form R rungs of each stacked on rows.
//
// What bounds it on this card is bytes: 64 words a scenario and stage in
// (dv, wzy; quadrotor widths, box rows) and 64 out (wzy+, hf+), the
// shared matrices a few kilobytes a stage.  The only carry is x+ = M x + v:
// everything else of stage k needs x_k and stage k's data alone.  So the
// warps of a block take roles, on 32 consecutive scenarios (a lane each):
//   * warp 0, the producer, copies each stage into a ring of SLOTS
//     shared-memory slots: the scenarios' rows (dv, wzy) as two boxes of
//     the copy engine (TMA, one instruction each, lane 0) where the row
//     stride allows, else by cp.async a word a copy; the shared matrices
//     by cp.async as contiguous runs, 16 bytes a copy where they allow;
//   * warp 1, the chain, runs x+ = M x + v with x in registers and M read
//     as a broadcast, and leaves x_k in the stage's slot;
//   * warps 2 .. TAILS+1, the tail, take whole stages (tail warp t the
//     stages t, t + TAILS, ...): a lane computes its scenario's u, w~,
//     w+, z~, the projection (a cone's rows lie with one lane: no
//     exchange), y+, hf+, the stores (a warp's store is one line) and its
//     running maxima, several stages in flight at once behind the chain.
// Three shared-memory barriers (mbarrier) a slot hand a stage on: `full`
// (the producer's copies landed), `ready` (the chain is done with the
// slot and x_k is in it) and `empty` (the tail is done with it); no
// block-wide barrier a stage.  The maxima of the tail warps are joined
// once at the end.  A lane past the batch reads the last scenario's data
// and stores nothing (where the copy engine takes the rows, a lane past
// the batch reads zeros).  Measured on an H100 (PERF.md): with the rows by
// cp.async the producer bounded the kernel (about 2,100 cycles a stage);
// with them as boxes the tail does, and 8 tail warps beat 6 by 10-15 % in
// the float32 diagonal-cost forms (with cp.async they did not); the row
// loop unrolled by 2, more slots, and 1-D bulk copies (a run or a 128-byte
// row an instruction) were no faster or slower.  Narrow form: a widening
// warp of its own (the last) loads M, K, Hs, D and h (K5Runs), asked of
// the L2 WD_AHEAD stages ahead, before the slot is free, stores them
// widened into their slot runs and counts once off `full`; the producer
// only copies (bnd, the rows), and no copy waits behind a load.

#ifndef DIAG_COST
#error "kernel B: build with -DDIAG_COST as well"
#endif

constexpr int NB = 3 + HAS_SHIFT;             // bnd rows: lb, ub, mask[, shift]
constexpr int NW = NZ + 2 * NC;               // wzy rows: w, z, y
constexpr int HS_WORDS = DIAG_COST ? NZ : NZ * NZ;
constexpr int K5_W = 32;                      // scenarios a block, a lane each
// Shared rows read 16 bytes a load where the widths allow (M and K rows
// of nx words from 16-byte boundaries, D rows of nz).
constexpr int K5_VW = 16 / (int)sizeof(scalar);
constexpr bool K5_VR = NX % K5_VW == 0;
constexpr bool K5_VD = NZ % K5_VW == 0;
__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }
// Where five vectors of nz do not fit a tail warp's registers (the wide
// widths, nz=30 and 50, where the one-pass tail spilled 0.1-7 KB), the tail
// keeps w+ in the slot's dv rows and the D^T terms go in a second pass
// (K5_TWO_PASS): the row loop leaves each row's coefficients (rho m z+ -
// y+, y+, the dual residual's) in the slot's rows it has read (z, y, and
// x: nc <= nx), and the rows of w sum them, K5_ECH entries at a time, in
// the one-pass sums' order (the same numbers).
constexpr bool K5_TWO_PASS = NZ > (sizeof(scalar) == 4 ? 20 : 16) && NC <= NX;
constexpr int K5_ECH = K5_TWO_PASS ? 40 / (int)sizeof(scalar) : NZ;

// Slot (words): the shared runs, each from a 16-byte boundary (all R
// rungs of M and K), then x_k, the dv rows and the wzy rows (32 words a
// row, one a scenario).
constexpr int K5_M = 0;
constexpr int K5_K = K5_M + round4(NRUNG * NX * NX);
constexpr int K5_HS = K5_K + round4(NRUNG * NU * NX);
constexpr int K5_D = K5_HS + round4(HS_WORDS);
constexpr int K5_BND = K5_D + round4(NC * NZ);
constexpr int K5_H = K5_BND + round4(NB * NC);
// x_k and the rows from a 128-byte boundary (the copy engine's boxes).
constexpr int K5_X = (K5_H + round4(NZ) + 31) / 32 * 32;
constexpr int K5_DV = K5_X + NX * K5_W;
constexpr int K5_WZY = K5_DV + NZ * K5_W;
constexpr int K5_SLOT = K5_WZY + NW * K5_W;
// After the slots: each tail warp's shifted cone values (NC rows of a
// lane each) and the closing join of the maxima; then the barriers.
constexpr int K5_VX = NCONES > 0 ? NC * K5_W : 0;
constexpr int K5_SMEM_MAX = 232448;           // 227 KB, the most a block has
constexpr int K5_SLOT_BYTES = K5_SLOT * (int)sizeof(scalar) + 3 * 8;
// A form's warps and slots.  The tail sets the pace at the quadrotor's
// widths (its row loop ~7 cycles an instruction a warp, far from the SM's
// instruction rate: an H100, PERF.md), so the float32 diagonal-cost forms
// (the served ones) take 8 tail warps with hf-emit (9 ran no faster) and
// 12 without (15 warps: 128 registers, which the tail without hf+ keeps,
// spilling under 60 bytes; with hf+ it spilled 116 and ran slower).  At
// the two-pass widths the tails wait on the chain, and 5 (8 warps at
// most: 255 registers) keep the tail's long vectors out of local memory.
// The float64 and full-Hs forms take 6, 5 beside the widening warp (8
// warps: 255 registers; at 9 warps, 168, the float64 narrow forms spilled
// 0.4-1.1 KB).
template <bool EMIT_HF> struct K5Fit {
    static constexpr int TAILS_MAX =
        sizeof(scalar) == 4 && DIAG_COST
            ? (K5_TWO_PASS ? 5 : EMIT_HF ? 8 : 12) : 6 - NARROW;
    static constexpr int FIXED = TAILS_MAX * K5_VX + 4 * TAILS_MAX * K5_W;
    static constexpr int FIT =
        (K5_SMEM_MAX - FIXED * (int)sizeof(scalar) - 8 - 128) / K5_SLOT_BYTES;
    // Stages in flight: one a tail warp, and the chain and the producer
    // ahead.
    static constexpr int SLOTS = FIT < TAILS_MAX + 3 ? FIT : TAILS_MAX + 3;
    // No more tail warps than slots: a waiter names only the parity of the
    // phase it waits for, so two tail warps must never wait on one slot's
    // barrier for two different stages (with fewer slots than tail warps,
    // the later stage's wait would pass on the earlier stage's phase).
    static constexpr int TAILS = SLOTS < TAILS_MAX ? SLOTS : TAILS_MAX;
    // Warps: the producer, the chain, the tails, (narrow) the widening warp.
    static constexpr int WIDEN = 2 + TAILS;
    static constexpr int THREADS = 32 * (WIDEN + NARROW);
    static_assert(SLOTS >= 2, "kernel B: two stages do not fit a block");
    static constexpr int BAR_OFF =
        ((SLOTS * K5_SLOT + FIXED) * (int)sizeof(scalar) + 7) / 8 * 8;
    static constexpr int SMEM = BAR_OFF + 3 * 8 * SLOTS + 128;   // + alignment
};

// The shared runs the narrow form widens: M and K (all rungs), Hs, D and
// (EMIT_HF) h, each at its slot run.
template <bool EMIT_HF> struct K5Runs {
    static constexpr int NR = 5;
    static __host__ __device__ constexpr int words(int q)
    {
        return q == 0 ? NRUNG * NX * NX : q == 1 ? NRUNG * NU * NX
            : q == 2 ? HS_WORDS : q == 3 ? NC * NZ : EMIT_HF ? NZ : 0;
    }
    static __host__ __device__ constexpr int cols(int q) { return words(q); }
    static __host__ __device__ constexpr int pitch(int q) { return words(q); }
    static __host__ __device__ constexpr int dst(int q)
    {
        return q == 0 ? K5_M : q == 1 ? K5_K : q == 2 ? K5_HS
            : q == 3 ? K5_D : K5_H;
    }
};

// Diagnostic build (-DADMM_PROFILE): lane 0 of each role in block 0 sums
// the SM cycles of its sections (K5_SECTIONS; the tail's per stage that
// warp took); admm_read_prof copies the sums out.
constexpr int K5_SECTIONS = 8 + 2 * NARROW;
#ifdef ADMM_PROFILE
__device__ long long admm_prof[K5_SECTIONS];
#define K5_PROF_INIT                                                         \
    long long prof_acc[K5_SECTIONS] = {};                                    \
    long long prof_t = clock64();
#define K5_MARK(i)                                                           \
    do {                                                                     \
        const long long t_ = clock64();                                      \
        prof_acc[i] += t_ - prof_t;                                          \
        prof_t = t_;                                                         \
    } while (0)
#define K5_PROF_DONE(lo, hi, mul, div)                                       \
    if (blockIdx.x == 0 && lane == 0)                                        \
        for (int i_ = lo; i_ < hi; ++i_)                                     \
            admm_prof[i_] = prof_acc[i_] * (mul) / (div);
#else
#define K5_PROF_INIT
#define K5_MARK(i)
#define K5_PROF_DONE(lo, hi, mul, div)
#endif

// Whether constraint row ci lies in a cone (constant after unrolling).
__device__ __forceinline__ bool in_cone(int ci)
{
    bool in = false;
#pragma unroll
    for (int q = 0; q < NCONES; ++q)
        in = in || (ci >= cone_field(q, 0)
                    && ci < cone_field(q, 0) + cone_field(q, 1));
    return in;
}

template <bool EMIT_HF>
__global__ void __launch_bounds__(K5Fit<EMIT_HF>::THREADS, 1)
fwd_update_kernel(
    int N, int Bt, double alpha_d, double sigma_d, int m_stride, int k_stride,
    const scalar* __restrict__ rho, const scalar* __restrict__ x0,
    const stage_t* __restrict__ M, const stage_t* __restrict__ K,
    const stage_t* __restrict__ Hs,
    const stage_t* __restrict__ D, const scalar* __restrict__ bnd,
    const stage_t* __restrict__ h, const int* __restrict__ rung,
    const scalar* __restrict__ dv, const scalar* __restrict__ wzy,
    scalar* __restrict__ wzy_new, scalar* __restrict__ hf_new,
    scalar* __restrict__ xN, scalar* __restrict__ res,
    const __grid_constant__ CUtensorMap dv_map,
    const __grid_constant__ CUtensorMap wzy_map, int tma)
{
    extern __shared__ double smem_aligned[];
    char* base = reinterpret_cast<char*>(
        (reinterpret_cast<size_t>(smem_aligned) + 127) / 128 * 128);
    scalar* ring = reinterpret_cast<scalar*>(base);
    using Fit = K5Fit<EMIT_HF>;
    constexpr int K5_SLOTS = Fit::SLOTS, K5_TAILS = Fit::TAILS;
    scalar* vx_all = ring + K5_SLOTS * K5_SLOT;
    scalar* join = vx_all + Fit::TAILS_MAX * K5_VX;
    mbar_t* full = reinterpret_cast<mbar_t*>(base + Fit::BAR_OFF);
    mbar_t* ready = full + K5_SLOTS;
    mbar_t* empty = ready + K5_SLOTS;

    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const size_t Bs = (size_t)Bt;
    const size_t b0 = (size_t)blockIdx.x * K5_W;
    const size_t b = b0 + lane;
    const bool valid = b < Bs;
    // This scenario's rung: where its M and K lie in a slot.
    const int r_ix = (NRUNG > 1 && valid) ? rung[b] : 0;

    if (threadIdx.x == 0) {
        for (int s = 0; s < K5_SLOTS; ++s) {
            mbar_init(&full[s], NARROW ? 34 : 33);   // the producer's lanes
                                                 // and lane 0's box bytes
                                                 // (narrow: and once after
                                                 // the widening stores)
            mbar_init(&ready[s], 32);            // the chain's
            mbar_init(&empty[s], 32);            // the stage's tail warp's
        }
    }
    __syncthreads();

    if (NARROW && warp == Fit::WIDEN) {
        // ---- (narrow form) widening warp: stage k's shared runs, loaded
        // (asked of the L2 WD_AHEAD stages ahead), stored widened into slot
        // k % K5_SLOTS once the tail of stage k - K5_SLOTS has let go of it.
        using Runs = K5Runs<EMIT_HF>;
        stage_t wide[wd_total<Runs>()];
        auto runs_at = [&](size_t ka, const stage_t** at) {
            at[0] = M + ka * m_stride;
            at[1] = K + ka * k_stride;
            at[2] = Hs + ka * HS_WORDS;
            at[3] = D + ka * NC * NZ;
            at[4] = EMIT_HF ? h + ka * NZ : h;
        };
        K5_PROF_INIT
#pragma unroll 1
        for (int k = 0; k < N; ++k) {
            const int s = k % K5_SLOTS;
            const stage_t* at[Runs::NR];
            if (k + WD_AHEAD < N) {
                runs_at((size_t)(k + WD_AHEAD), at);
                wd_prefetch<Runs>(at, lane);
            }
            runs_at((size_t)k, at);
            wd_load<Runs>(wide, at, lane);
            if (k >= K5_SLOTS) mbar_wait(&empty[s], (k / K5_SLOTS - 1) & 1);
            K5_MARK(K5_SECTIONS - 2);
            wd_store<Runs>(ring + s * K5_SLOT, wide, lane);
            wd_arrive(&full[s], lane);
            K5_MARK(K5_SECTIONS - 1);
        }
        K5_PROF_DONE(K5_SECTIONS - 2, K5_SECTIONS, 1, 1)
    } else if (warp == 0) {
        // ---- producer: stage k into slot k % K5_SLOTS, once the tail of
        // stage k - K5_SLOTS has let go of it (narrow: bnd and the rows).
        constexpr size_t VW = 16 / sizeof(scalar);
        const bool vec = Bs % VW == 0 && b0 + K5_W <= Bs
            && (((size_t)dv | (size_t)wzy) & 15) == 0;
        K5_PROF_INIT
#pragma unroll 1
        for (int k = 0; k < N; ++k) {
            const int s = k % K5_SLOTS;
            const size_t ks = (size_t)k;
            if (k >= K5_SLOTS) mbar_wait(&empty[s], (k / K5_SLOTS - 1) & 1);
            K5_MARK(0);
            scalar* S = ring + s * K5_SLOT;
            if constexpr (!NARROW) {
                // (Full width: stage_t is scalar.)
                warp_copy_run(S + K5_M, (const scalar*)M + ks * m_stride,
                              NRUNG * NX * NX, lane);
                warp_copy_run(S + K5_K, (const scalar*)K + ks * k_stride,
                              NRUNG * NU * NX, lane);
                warp_copy_run(S + K5_HS, (const scalar*)Hs + ks * HS_WORDS,
                              HS_WORDS, lane);
                warp_copy_run(S + K5_D, (const scalar*)D + ks * NC * NZ,
                              NC * NZ, lane);
                if (EMIT_HF)
                    warp_copy_run(S + K5_H, (const scalar*)h + ks * NZ, NZ,
                                  lane);
            }
            warp_copy_run(S + K5_BND, bnd + ks * NB * NC, NB * NC, lane);
            if (tma) {
                // The scenarios' rows as two boxes of the copy engine.
                if (lane == 0) {
                    mbar_arrive_expect_tx(
                        &full[s], (NZ + NW) * K5_W * (int)sizeof(scalar));
                    tma_box(S + K5_DV, &dv_map, (int)b0, k * NZ, &full[s]);
                    tma_box(S + K5_WZY, &wzy_map, (int)b0, k * NW, &full[s]);
                }
            } else {
                warp_copy_rows<K5_W>(S + K5_DV, dv + ks * NZ * Bs, NZ, Bs, b0,
                                     vec, lane);
                warp_copy_rows<K5_W>(S + K5_WZY, wzy + ks * NW * Bs, NW, Bs,
                                     b0, vec, lane);
                if (lane == 0) mbar_arrive(&full[s]);
            }
            mbar_arrive_on_copies(&full[s]);
            K5_MARK(1);
        }
        K5_PROF_DONE(0, 2, 1, 1)
    } else if (warp == 1) {
        // ---- chain: x+ = M x + v, x_k left in the slot for the tail.
        scalar x[NX];
#pragma unroll
        for (int i = 0; i < NX; ++i) x[i] = valid ? x0[i * Bs + b] : (scalar)0;
        K5_PROF_INIT
#pragma unroll 1
        for (int k = 0; k < N; ++k) {
            const int s = k % K5_SLOTS;
            mbar_wait(&full[s], (k / K5_SLOTS) & 1);
            K5_MARK(2);
            scalar* S = ring + s * K5_SLOT;
            const scalar* sM = S + K5_M + r_ix * NX * NX;   // M[i][t] at i*NX + t
            const scalar* vv = S + K5_DV + NU * K5_W + lane;
            scalar xn[NX];
#pragma unroll
            for (int i = 0; i < NX; ++i) {
                scalar row[NX];
                ld_row<NX, K5_VR>(row, sM + i * NX);
                scalar acc = vv[i * K5_W];
#pragma unroll
                for (int t = 0; t < NX; ++t) acc += row[t] * x[t];
                xn[i] = acc;
            }
#pragma unroll
            for (int i = 0; i < NX; ++i) {
                S[K5_X + i * K5_W + lane] = x[i];
                x[i] = xn[i];
            }
            mbar_arrive(&ready[s]);
            K5_MARK(3);
        }
        if (valid) {
#pragma unroll
            for (int i = 0; i < NX; ++i) xN[i * Bs + b] = x[i];
        }
        K5_PROF_DONE(2, 4, 1, 1)
    } else if (warp < 2 + K5_TAILS) {
        // ---- tail warp t: stages t, t + K5_TAILS, ...
        const int t = warp - 2;
        const scalar alpha = (scalar)alpha_d;
        const scalar oma = (scalar)(1.0 - alpha_d);
        const scalar amo = (scalar)(alpha_d - 1.0);
        const scalar sigma = (scalar)sigma_d;
        const scalar asig = (scalar)(alpha_d * sigma_d);
        const scalar rho_b = valid ? rho[b] : (scalar)1;
        scalar* vx = vx_all + t * K5_VX + lane;     // row ci at vx[ci * K5_W]
        // Running maxima of this lane's stages: r_prim, r_dual, prim /
        // dual scale.
        scalar rp = (scalar)0, rd = (scalar)0, ps = (scalar)0, ds = (scalar)0;
        K5_PROF_INIT
#pragma unroll 1
        for (int k = t; k < N; k += K5_TAILS) {
            const int s = k % K5_SLOTS;
            mbar_wait(&ready[s], (k / K5_SLOTS) & 1);
            K5_MARK(4);
            const size_t ks = (size_t)k;
            const scalar* S = ring + s * K5_SLOT;
            const scalar* sK = S + K5_K + r_ix * NU * NX;   // K[j][t] at j*NX + t
            const scalar* sHs = S + K5_HS;
            const scalar* sD = S + K5_D;                 // D[c][e] at c*NZ + e
            const scalar* sbnd = S + K5_BND;             // lb | ub | m [| shift]
            const scalar* sh = S + K5_H;
            const scalar* xv = S + K5_X + lane;
            const scalar* dvv = S + K5_DV + lane;        // d rows, then v rows
            const scalar* wv = S + K5_WZY + lane;        // w rows, z rows, y rows

            scalar w_t[NZ], w_new[NZ];
#pragma unroll
            for (int i = 0; i < NX; ++i) w_t[NU + i] = xv[i * K5_W];
#pragma unroll
            for (int j = 0; j < NU; ++j) {
                scalar row[NX];
                ld_row<NX, K5_VR>(row, sK + j * NX);
                scalar acc = dvv[j * K5_W];
#pragma unroll
                for (int q = 0; q < NX; ++q) acc += row[q] * w_t[NU + q];
                w_t[j] = acc;
            }
            // K5_TWO_PASS: w+ in the dv rows (the chain's v and the d read
            // above are spent), each row's coefficients in its z, y and x
            // rows once read (nc <= nx).
            scalar* wn = ring + s * K5_SLOT + K5_DV + lane;
            scalar* cs = ring + s * K5_SLOT + lane;
#pragma unroll
            for (int e = 0; e < NZ; ++e) {
                w_new[e] = alpha * w_t[e] + oma * wv[e * K5_W];
                if constexpr (K5_TWO_PASS) wn[e * K5_W] = w_new[e];
            }
            auto wnew = [&](int e) {
                return K5_TWO_PASS ? wn[e * K5_W] : w_new[e];
            };
            // A cone's rows: the shifted values to project, all of them
            // before any row is projected.
#pragma unroll
            for (int ci = 0; ci < NC; ++ci) {
                if (NCONES > 0 && in_cone(ci)) {
                    scalar zt = (scalar)0;
#pragma unroll
                    for (int e = 0; e < NZ; ++e) zt += sD[ci * NZ + e] * w_t[e];
                    const scalar m = sbnd[2 * NC + ci];
                    scalar relax;
                    const scalar v = value_to_project(
                        zt, wv[(NZ + ci) * K5_W], wv[(NZ + NC + ci) * K5_W], m,
                        rho_b * m, alpha, oma, relax);
                    vx[ci * K5_W] = v + (HAS_SHIFT ? sbnd[3 * NC + ci] : (scalar)0);
                }
            }
            K5_MARK(5);

            // Constraint rows: projection, dual update, their stores, and
            // their terms of hf+ and of the dual residual (D^T products as
            // sums over the rows, c = 0 .. nc-1; K5_TWO_PASS: the rows'
            // coefficients, summed in the rows of w).
            scalar hfn[NZ], dT[NZ], dty[NZ];
            auto init_terms = [&](int e) {
                hfn[e] = EMIT_HF ? sh[e] - sigma * wnew(e) : (scalar)0;
                dT[e] = (scalar)0;
                dty[e] = (scalar)0;
            };
            if constexpr (!K5_TWO_PASS) {
#pragma unroll
                for (int e = 0; e < NZ; ++e) init_terms(e);
            }
            // The row loop stays rolled: unrolled, the tail's code outgrew
            // the instruction cache that its warps, at different rows,
            // share (a stage took 4x its issue time on an H100).
#pragma unroll 1
            for (int ci = 0; ci < NC; ++ci) {
                // z~ = D w~ and D w+ of the row (K5_TWO_PASS: D read where
                // it is used, w+ from the slot).
                scalar Dr[NZ];
                if constexpr (!K5_TWO_PASS)
                    ld_row<NZ, K5_VD>(Dr, sD + ci * NZ);
                scalar zt = (scalar)0, Dwn = (scalar)0;
#pragma unroll
                for (int e = 0; e < NZ; ++e) {
                    const scalar De = K5_TWO_PASS ? sD[ci * NZ + e] : Dr[e];
                    zt += De * w_t[e];
                    Dwn += De * wnew(e);
                }
                const scalar zo = wv[(NZ + ci) * K5_W];
                const scalar yo = wv[(NZ + NC + ci) * K5_W];
                const scalar m = sbnd[2 * NC + ci];
                const scalar rho_m = rho_b * m;
                scalar relax;
                const scalar v = value_to_project(zt, zo, yo, m, rho_m, alpha,
                                                  oma, relax);
                const scalar zp = project_row(
                    vx, K5_W, ci, v, sbnd[ci], sbnd[NC + ci],
                    HAS_SHIFT ? sbnd[3 * NC + ci] : (scalar)0);
                const scalar z_new = zp * (m > (scalar)0 ? (scalar)1 : (scalar)0);
                const scalar y_new = yo + rho_m * (relax - z_new);
                if (valid) {
                    wzy_new[(ks * NW + NZ + ci) * Bs + b] = z_new;
                    wzy_new[(ks * NW + NZ + NC + ci) * Bs + b] = y_new;
                }
                rp = fmax(rp, fabs(Dwn - z_new));
                ps = fmax(ps, fmax(fabs(Dwn), fabs(z_new)));
                const scalar rg = rho_m * z_new - y_new;
                const scalar ztt = rho_m * (amo * (zt - zo) + (zo - z_new));
                if constexpr (K5_TWO_PASS) {
                    cs[K5_WZY + (NZ + ci) * K5_W] = rg;
                    cs[K5_WZY + (NZ + NC + ci) * K5_W] = y_new;
                    cs[K5_X + ci * K5_W] = ztt;
                } else {
#pragma unroll
                    for (int e = 0; e < NZ; ++e) {
                        if (EMIT_HF) hfn[e] -= rg * Dr[e];
                        dT[e] += ztt * Dr[e];
                        dty[e] += y_new * Dr[e];
                    }
                }
            }
            K5_MARK(6);

            // Rows of w: w+, the next iteration's hf, the dual residual;
            // K5_TWO_PASS: K5_ECH entries at a time, their D^T terms first
            // (each row's three coefficients against its piece of D, rows
            // c = 0 .. nc-1: the one-pass sums' order).
#pragma unroll
            for (int e0 = 0; e0 < NZ; e0 += K5_ECH) {
                if constexpr (K5_TWO_PASS) {
#pragma unroll
                    for (int e = e0; e < e0 + K5_ECH && e < NZ; ++e)
                        init_terms(e);
#pragma unroll 1
                    for (int ci = 0; ci < NC; ++ci) {
                        const scalar rg = cs[K5_WZY + (NZ + ci) * K5_W];
                        const scalar yn = cs[K5_WZY + (NZ + NC + ci) * K5_W];
                        const scalar ztt = cs[K5_X + ci * K5_W];
#pragma unroll
                        for (int e = e0; e < e0 + K5_ECH && e < NZ; ++e) {
                            const scalar De = sD[ci * NZ + e];
                            if (EMIT_HF) hfn[e] -= rg * De;
                            dT[e] += ztt * De;
                            dty[e] += yn * De;
                        }
                    }
                }
#pragma unroll
                for (int e = e0; e < e0 + K5_ECH && e < NZ; ++e) {
                    const scalar dw_e = wv[e * K5_W] - w_t[e];
                    const scalar wn_e = wnew(e);
                    scalar Hdw, Hwn;
                    if (DIAG_COST) {
                        Hdw = sHs[e] * dw_e;
                        Hwn = sHs[e] * wn_e;
                    } else {
                        Hdw = (scalar)0;
                        Hwn = (scalar)0;
#pragma unroll
                        for (int f = 0; f < NZ; ++f) {
                            Hdw += sHs[e * NZ + f] * (wv[f * K5_W] - w_t[f]);
                            Hwn += sHs[e * NZ + f] * wnew(f);
                        }
                    }
                    dual_row(Hdw, Hwn, dT[e], dty[e], dw_e, wn_e, oma, asig,
                             sigma, rd, ds);
                    if (valid) {
                        wzy_new[(ks * NW + e) * Bs + b] = wn_e;
                        if (EMIT_HF) hf_new[(ks * NZ + e) * Bs + b] = hfn[e];
                    }
                }
            }
            mbar_arrive(&empty[s]);
            K5_MARK(7);
        }
        join[(t * 4 + 0) * K5_W + lane] = rp;
        join[(t * 4 + 1) * K5_W + lane] = rd;
        join[(t * 4 + 2) * K5_W + lane] = ps;
        join[(t * 4 + 3) * K5_W + lane] = ds;
        if (t == 0) {
            K5_PROF_DONE(4, 8, N, (N + K5_TAILS - 1) / K5_TAILS)
        }
    }
    // The tail warps join their maxima.
    __syncthreads();
    if (warp == 0 && valid) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            scalar m = join[q * K5_W + lane];
            for (int u = 1; u < K5_TAILS; ++u)
                m = fmax(m, join[(u * 4 + q) * K5_W + lane]);
            res[q * Bs + b] = m;
        }
    }
}


#else  // ITER
// ------------------------------------------------------------------- K8
// One whole conic ADMM iteration over stages 0..N-1 (the TPU kernel
// _admm_iter_kernel of pdp_lqr_tpu/ops/pallas_admm.py).  Per scenario, with rho its penalty and m the per-row
// rho SCALE (0 on padded rows, the equality boost on equality rows):
//
// Phase 1, backwards from (P, p) = (PN, pN), k = N-1 .. 0:
//   uncached: H = Hs + sum_c rho m_c D_c D_c^T,
//             h = h - sigma w - sum_c (rho m_c z_c - y_c) D_c,
//             the Riccati step of K1 on (A, B, c, H, h): [K d] = -Huu^-1
//             [G rbar], P = Q + A^T P A + G^T K, p = q + A^T Pcp + K^T rbar;
//   cached:   the same h, then the vector recursion of K2 on the exported
//             (P_{k+1}, L = chol(Huu), K): d = -(L L^T)^-1 rbar,
//             p = h_x + A^T Pcp + K^T rbar.
//   The gains go to a scratch buffer in device memory (K and d uncached,
//   d cached), a scenario's stages contiguous.
// Phase 2, forwards from x = x0, k = 0 .. N-1: u = K x + d, w~ = [u; x],
//   x+ = A x + B u + c (the raw dynamics), then K5's tail: relaxation,
//   projection, dual update and the four residual maxima, with the full
//   sigma-folded Hs in the dual residual.
//
// What bounds it on this card: each scenario carries its own P (nx^2)
// and, uncached, its folded H (nz^2) through a chain of N dependent
// stages, so a scenario is one warp: the carry and the stage's products
// live in the warp's slice of shared memory, each product's entries are
// dealt over the 32 lanes, and __syncwarp orders the steps.  What the
// warps can share is the stage DATA.  A warp that loads every stage's
// data itself spends most of its issue slots and memory latency on it: on
// one model every warp of an SM copies the same words, and on a batched
// problem each of a warp's loads touches 32 sectors for 4 bytes of each.
// So a block of WB warps (WB consecutive scenarios) stages each stage's
// data ONCE: its threads together fill a ring of K8_SLOTS shared-memory
// slots with cp.async, K8_PF stages ahead of use, one __syncthreads a
// stage.  A shared model's streams (trailing size 1) are one copy in the
// slot, which every warp reads as broadcasts; a per-scenario stream (c,
// w, z, y, the spilled gains, and every stream of a batched problem) is
// held as rows of the block's WB scenarios, scenario index fastest, so a
// copy instruction reads whole sectors and a warp reads its own column.
// Every matrix row in a slot has an odd length and a row of scenarios an
// odd stride in words, so the lanes of a warp fall on distinct banks
// whether they walk along a row or down a column, and the inner products
// unroll over compile-time offsets; a warp's own vectors, which all its
// lanes read alike, are read 16 bytes a load.  bf16 stage data travels as
// aligned pairs of 4 bytes into a staging area, and the block
// converts it to the compute type one stage ahead of use: the products
// never see the storage type.  A warp past the batch computes the last
// scenario's numbers and stores nothing: it stays in the loop for the
// block's barriers.  The gains make a round trip through device memory
// (mostly the L2 cache) between the phases, a scenario's stages
// contiguous.  The copy loops stay rolled: unrolled, they made the kernel
// 8-17 thousand instructions and every stage slower (instruction fetch;
// on an H100, quadrotor f32: cached N=512 5.3 ms against 4.2 rolled).
// What is left (-DADMM_PROFILE on an H100, quadrotor f32, cached N=512):
// issuing the next stages' copies and the products share a stage's
// cycles; registers (128 a thread, capped so that two blocks of 8 warps
// fit an SM), not shared-memory bandwidth or the barrier (50 cycles a
// stage), limit the warps in flight.
// Templates: SHARED (the model's streams, factors included, have trailing
// size 1), CACHED (phase 1 on exported factors), S the storage type of
// the stage data A, B, c, Hs, h, D (the compute type, or bf16).  WB
// (K8Fit) is 8 on one model and 4 on a batched problem, whose serving
// batches are smaller (the rocket's 512 scenarios in 128 blocks), fewer
// where a form's stage does not fit a block's shared memory (float64 at
// wide models).

// Diagnostic build (-DADMM_PROFILE): thread 0 of block 0 sums the SM
// cycles it spends in each marked section of a stage (K8_SECTIONS, both
// phases); admm_read_prof copies the sums out.
constexpr int K8_SECTIONS = 12;
#ifdef ADMM_PROFILE
__device__ long long admm_prof[K8_SECTIONS];
#define K8_PROF_INIT                                                         \
    const bool prof_on = (threadIdx.x == 0 && blockIdx.x == 0);             \
    long long prof_acc[K8_SECTIONS] = {};                                    \
    long long prof_t = clock64();
#define K8_MARK(i)                                                           \
    do {                                                                     \
        const long long t_ = clock64();                                      \
        prof_acc[i] += t_ - prof_t;                                          \
        prof_t = t_;                                                         \
    } while (0)
#define K8_PROF_DONE                                                         \
    if (prof_on)                                                             \
        for (int i_ = 0; i_ < K8_SECTIONS; ++i_) admm_prof[i_] = prof_acc[i_];
#else
#define K8_PROF_INIT
#define K8_MARK(i)
#define K8_PROF_DONE
#endif

constexpr int K8_RC = (NC + 31) / 32;         // constraint rows a lane
constexpr int K8_SMEM_MAX = 227 * 1024;       // a block's shared memory
constexpr int K8_RED = 4 * 32;                // the closing reduction
constexpr int K8_PF = 2;                      // stages in flight
constexpr int K8_SLOTS = K8_PF + 1;

// A matrix row's length in a slot: odd.
constexpr int k8_pad(int c) { return c | 1; }
// Words of an R x C stream in a slot, a row of scenarios rs words apart.
constexpr int k8_words(int r, int c, int rs) { return r * k8_pad(c) * rs; }
// Staging bytes of a narrow stream of n entries (kind 1: one copy, the
// pair cover and one pair more; kind 2: rows of rb entries; 0: none),
// 4-byte aligned.
constexpr int k8_staged(int n, int kind, int rb)
{
    return kind == 0 ? 0 : kind == 1 ? ((n + 2) * 2 + 3) / 4 * 4 : n * rb * 2;
}

// A warp's own words: phase 1's carry and products (P, K and the
// products of P only uncached; the folded H only uncached and not
// INPLACE: a compact form's warp on a batched problem folds its own
// column of the slot's Hs in place) ...  Every vector starts on 16 bytes,
// so a lane reads four (float64: two) entries a load.
constexpr int K8_VEC = 16 / (int)sizeof(scalar);   // scalars in 16 bytes
constexpr int k8_up(int n) { return (n + K8_VEC - 1) / K8_VEC * K8_VEC; }
template <bool CACHED, bool INPLACE> struct K8Warp {
    static constexpr int U = CACHED ? 0 : 1;
    static constexpr int UH = INPLACE ? 0 : U;
    static constexpr int P = 0;                          // P
    static constexpr int PV = P + U * k8_up(NX * NX);    // p
    static constexpr int HF = PV + k8_up(NX);            // folded H
    static constexpr int HV = HF + UH * k8_up(NZ * NZ);  // folded h
    static constexpr int RG = HV + k8_up(NZ);            // rho m z - y
    static constexpr int RMD = RG + k8_up(NC);           // rho m D
    static constexpr int PA = RMD + U * k8_up(NC * NZ);
    static constexpr int PB = PA + U * k8_up(NX * NX);
    static constexpr int PCP = PB + U * k8_up(NX * NU);
    static constexpr int G = PCP + k8_up(NX);
    static constexpr int RB = G + U * k8_up(NU * NX);    // rbar
    static constexpr int HUU = RB + k8_up(NU);
    static constexpr int K = HUU + U * k8_up(NU * NU);
    static constexpr int END1 = K + U * k8_up(NU * NX);
    // ... and phase 2's over them: x (x2), w~, w+, w - w~, the shifted
    // v, zt, y+ and the closing reduction.
    static constexpr int XS = k8_up(NX);
    static constexpr int X = 0;
    static constexpr int WT = X + 2 * XS;
    static constexpr int WN = WT + k8_up(NZ);
    static constexpr int DW = WN + k8_up(NZ);
    static constexpr int VX = DW + k8_up(NZ);
    static constexpr int ZT = VX + k8_up(NC);
    static constexpr int YN = ZT + k8_up(NC);
    static constexpr int RED = YN + k8_up(NC);
    static constexpr int END2 = RED + K8_RED;
    static constexpr int WORDS = END1 > END2 ? END1 : END2;
};

// A ring slot, one layout a phase: words of the compute type, then (bf16
// stage data) the staging bytes of the narrow streams.  A stream of R x C
// entries a stage (a vector: C = 1) is one copy (entry (r, c) at
// r * pad(C) + c) or rows of the block's scenarios (entry (r, c) of
// scenario j at (r * pad(C) + c) * RF + j).  The model's streams are one
// copy when SHARED; c, w, z, y are rows; the spilled gains are the
// scenarios' runs one after another.  A narrow stream's staging holds
// the aligned pair cover of its block (one copy: one entry and one pair
// more; rows: RB entries a row).  COMPACT (the forms that do not fit
// otherwise: float64 bf16 stage data at nz=50) keeps the staging apart
// from the slots, in two areas, not one a slot: a step's staged bytes
// are converted during the step before it, so only steps n+1 (being
// converted) and n+2 (in flight) hold staging at step n.
template <class S, bool SHARED, bool CACHED, int WB, bool COMPACT>
struct K8Slot {
    static constexpr bool NARROW = sizeof(S) != sizeof(scalar);
    static constexpr int RF = WB | 1;             // row stride (words)
    static constexpr int RM = SHARED ? 1 : RF;    // the model's streams
    static constexpr int RB = 2 * ((WB + 2) / 2); // a staged bf16 row
    static constexpr int SPW = CACHED ? NU : NU * (NX + 1);
    static constexpr int ST = !NARROW ? 0 : SHARED ? 1 : 2;   // staging kind
    // Phase 1: A, B, h, D, the rho scale, Hs (uncached) or P, L, K
    // (cached); c, w, z, y.
    static constexpr int A1 = 0;
    static constexpr int B1 = A1 + k8_words(NX, NX, RM);
    static constexpr int H1 = B1 + k8_words(NX, NU, RM);
    static constexpr int D1 = H1 + k8_words(NZ, 1, RM);
    static constexpr int M1 = D1 + k8_words(NC, NZ, RM);
    static constexpr int HS1 = M1 + k8_words(NC, 1, RM);
    static constexpr int PF1 = HS1;
    static constexpr int LF1 = PF1 + k8_words(NX, NX, RM);
    static constexpr int KF1 = LF1 + k8_words(NU, NU, RM);
    static constexpr int C1 =
        CACHED ? KF1 + k8_words(NU, NX, RM) : HS1 + k8_words(NZ, NZ, RM);
    static constexpr int W1 = C1 + k8_words(NX, 1, RF);
    static constexpr int Z1 = W1 + k8_words(NZ, 1, RF);
    static constexpr int Y1 = Z1 + k8_words(NC, 1, RF);
    static constexpr int END1 = Y1 + k8_words(NC, 1, RF);
    // Phase 2: A, B, Hs, D, the rho scale, lb, ub, shift, K (cached);
    // c, w, z, y; the gains.
    static constexpr int A2 = 0;
    static constexpr int B2 = A2 + k8_words(NX, NX, RM);
    static constexpr int HS2 = B2 + k8_words(NX, NU, RM);
    static constexpr int D2 = HS2 + k8_words(NZ, NZ, RM);
    static constexpr int M2 = D2 + k8_words(NC, NZ, RM);
    static constexpr int LB2 = M2 + k8_words(NC, 1, RM);
    static constexpr int UB2 = LB2 + k8_words(NC, 1, RM);
    static constexpr int SH2 = UB2 + k8_words(NC, 1, RM);
    static constexpr int KF2 = SH2 + (HAS_SHIFT ? k8_words(NC, 1, RM) : 0);
    static constexpr int C2 = KF2 + (CACHED ? k8_words(NU, NX, RM) : 0);
    static constexpr int W2 = C2 + k8_words(NX, 1, RF);
    static constexpr int Z2 = W2 + k8_words(NZ, 1, RF);
    static constexpr int Y2 = Z2 + k8_words(NC, 1, RF);
    static constexpr int SP2 = Y2 + k8_words(NC, 1, RF);
    static constexpr int END2 = SP2 + WB * SPW;
    static constexpr int WORDS0 = ((END1 > END2 ? END1 : END2) + 3) / 4 * 4;
    // The staging (bytes from the end of the words): phase 1 A, B, h, D,
    // Hs (uncached), c; phase 2 A, B, Hs, D, c.
    static constexpr int SA1 = 0;
    static constexpr int SB1 = SA1 + k8_staged(NX * NX, ST, RB);
    static constexpr int SH1 = SB1 + k8_staged(NX * NU, ST, RB);
    static constexpr int SD1 = SH1 + k8_staged(NZ, ST, RB);
    static constexpr int SHS1 = SD1 + k8_staged(NC * NZ, ST, RB);
    static constexpr int SC1 = SHS1 + (CACHED ? 0 : k8_staged(NZ * NZ, ST, RB));
    static constexpr int SEND1 = SC1 + (NARROW ? k8_staged(NX, 2, RB) : 0);
    static constexpr int SA2 = 0;
    static constexpr int SB2 = SA2 + k8_staged(NX * NX, ST, RB);
    static constexpr int SHS2 = SB2 + k8_staged(NX * NU, ST, RB);
    static constexpr int SD2 = SHS2 + k8_staged(NZ * NZ, ST, RB);
    static constexpr int SC2 = SD2 + k8_staged(NC * NZ, ST, RB);
    static constexpr int SEND2 = SC2 + (NARROW ? k8_staged(NX, 2, RB) : 0);
    static constexpr int STAGE = SEND1 > SEND2 ? SEND1 : SEND2;
    static constexpr int BYTES =                    // a slot: words, staging
        (WORDS0 * (int)sizeof(scalar) + STAGE + 15) / 16 * 16;
    static constexpr int WBYTES = (WORDS0 * (int)sizeof(scalar) + 15) / 16 * 16;
    static constexpr int SBYTES = (STAGE + 15) / 16 * 16;
    static constexpr int RING = COMPACT
        ? K8_SLOTS * WBYTES + (NARROW ? 2 * SBYTES : 0) : K8_SLOTS * BYTES;
};

template <class S, bool SHARED, bool CACHED, int WB, bool COMPACT>
constexpr int k8_bytes()
{
    return K8Slot<S, SHARED, CACHED, WB, COMPACT>::RING
        + WB * K8Warp<CACHED, COMPACT && !SHARED>::WORDS * (int)sizeof(scalar);
}

// The widest block of 8 (one model) or 4, then 2 or 1 warps that a
// layout fits; 0 where none does.
template <class S, bool SHARED, bool CACHED, bool COMPACT>
constexpr int k8_fit()
{
    constexpr int W0 = SHARED ? 8 : 4;
    return k8_bytes<S, SHARED, CACHED, W0, COMPACT>() <= K8_SMEM_MAX ? W0
        : k8_bytes<S, SHARED, CACHED, 4, COMPACT>() <= K8_SMEM_MAX ? 4
        : k8_bytes<S, SHARED, CACHED, 2, COMPACT>() <= K8_SMEM_MAX ? 2
        : k8_bytes<S, SHARED, CACHED, 1, COMPACT>() <= K8_SMEM_MAX ? 1 : 0;
}

// A form's block: 8 warps on one model, 4 on a batched problem, fewer
// where that does not fit; the COMPACT layout only where one scenario
// alone does not fit otherwise (it changes how many blocks share an SM,
// and on the quadrotor's batched bf16 and uncached forms that cost 30 %:
// PERF.md).  OK is false only where one scenario does not fit compact.
template <class S, bool SHARED, bool CACHED> struct K8Fit {
    static constexpr bool COMPACT = k8_fit<S, SHARED, CACHED, false>() == 0;
    static constexpr int FIT = k8_fit<S, SHARED, CACHED, COMPACT>();
    static constexpr int WB = FIT > 0 ? FIT : 1;
    static constexpr bool OK = FIT > 0;
    // Blocks an SM the registers must allow (float32): 2 of 8 warps on
    // one model (128 registers: fewer spill), 3 of 4 on a batched problem
    // (where shared memory allows no more).
    static constexpr int MINB = sizeof(scalar) > 4 ? 1 : SHARED ? 2 : 3;
    static constexpr int BYTES = k8_bytes<S, SHARED, CACHED, WB, COMPACT>();
};

__device__ __forceinline__ scalar up(__nv_bfloat16 v)
{
    return (scalar)__bfloat162float(v);
}

// A warp's own vector of L entries (16-byte aligned) into registers,
// 16 bytes a load: what all lanes read alike costs a quarter (float64: a
// half) of the shared-memory loads it would one entry a load.
template <int L>
__device__ __forceinline__ void k8_vec(scalar (&v)[L], const scalar* p)
{
    constexpr int L4 = L / K8_VEC * K8_VEC;
#pragma unroll
    for (int i = 0; i < L4; i += K8_VEC) {
        if constexpr (sizeof(scalar) == 4) {
            const float4 q = *reinterpret_cast<const float4*>(p + i);
            v[i] = q.x;
            v[i + 1] = q.y;
            v[i + 2] = q.z;
            v[i + 3] = q.w;
        } else {
            const double2 q = *reinterpret_cast<const double2*>(p + i);
            v[i] = q.x;
            v[i + 1] = q.y;
        }
    }
#pragma unroll
    for (int i = L4; i < L; ++i) v[i] = p[i];
}

template <class S, bool SHARED, bool CACHED>
__global__ void __launch_bounds__((32 * K8Fit<S, SHARED, CACHED>::WB),
                                  (K8Fit<S, SHARED, CACHED>::MINB))
iter_kernel(
    int N, int Bt, double alpha_d, double sigma_d,
    const scalar* __restrict__ rho, const scalar* __restrict__ PN,
    const scalar* __restrict__ pN, const scalar* __restrict__ x0,
    const S* __restrict__ A, const S* __restrict__ B,
    const S* __restrict__ c, const S* __restrict__ Hs,
    const S* __restrict__ h, const S* __restrict__ D,
    const scalar* __restrict__ lb, const scalar* __restrict__ ub,
    const scalar* __restrict__ mask, const scalar* __restrict__ shift,
    const scalar* __restrict__ Pf, const scalar* __restrict__ Lf,
    const scalar* __restrict__ Kf,
    const scalar* __restrict__ w, const scalar* __restrict__ z,
    const scalar* __restrict__ y, scalar* __restrict__ spill,
    scalar* __restrict__ w_new, scalar* __restrict__ z_new,
    scalar* __restrict__ y_new, scalar* __restrict__ xN,
    scalar* __restrict__ res)
{
    constexpr int WB = K8Fit<S, SHARED, CACHED>::WB;
    constexpr bool COMPACT = K8Fit<S, SHARED, CACHED>::COMPACT;
    constexpr bool INPLACE = COMPACT && !SHARED;    // the fold into the slot
    constexpr int NT = 32 * WB;
    using L = K8Slot<S, SHARED, CACHED, WB, COMPACT>;
    using Wp = K8Warp<CACHED, INPLACE>;
    constexpr bool NARROW = L::NARROW;
    constexpr int RF = L::RF, RM = L::RM, SPW = L::SPW;
    constexpr int XP = NX | 1, UP = NU | 1, ZP = NZ | 1;   // k8_pad

    extern __shared__ double smem_aligned[];
    char* ring = reinterpret_cast<char*>(smem_aligned);
    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int warp = tid / 32;
    const size_t Bs = (size_t)Bt, Ns = (size_t)N;
    const size_t b0 = (size_t)blockIdx.x * WB;
    const size_t b = b0 + warp;
    const bool valid = b < Bs;
    const size_t bc = valid ? b : Bs - 1;       // whose numbers this warp computes
    scalar* sm = reinterpret_cast<scalar*>(ring + L::RING)
        + warp * Wp::WORDS;

    const scalar alpha = (scalar)alpha_d;
    const scalar oma = (scalar)(1.0 - alpha_d);
    const scalar amo = (scalar)(alpha_d - 1.0);
    const scalar sigma = (scalar)sigma_d;
    const scalar asig = (scalar)(alpha_d * sigma_d);
    const scalar rho_b = rho[bc];
    scalar* spill_b = spill + bc * Ns * SPW;

    auto words = [&](int n) {                    // slot n % K8_SLOTS
        return reinterpret_cast<scalar*>(
            ring + (n % K8_SLOTS) * (COMPACT ? L::WBYTES : L::BYTES));
    };
    auto staging = [&](int n) {                  // COMPACT: area n % 2
        if constexpr (COMPACT)
            return ring + K8_SLOTS * L::WBYTES + (n % 2) * L::SBYTES;
        else
            return ring + (n % K8_SLOTS) * L::BYTES
                + L::WORDS0 * (int)sizeof(scalar);
    };
    // Stage k's block of an R x C stream (a model stream when `one` is
    // SHARED, else per scenario) into a slot: entry e of scenario b at
    // src[(k R C + e) * bs + b] (bs = 1 for one copy).  Compute-type data
    // goes straight to its place, a word a copy; a narrow stream to the
    // staging as aligned pairs (an odd last element of the stream, which
    // has no pair, plainly).  With bf16 stage data the streams of a step
    // share out their copies round the block: a stream's first copy goes
    // to the thread after the one that took the last copy of the stream
    // before it (`turn`).  Measured on an H100: without that the bf16
    // forms spill registers and run slower; with it the f32 forms do.
    int turn = 0;
    auto stage = [&](bool one, scalar* dst, char* stg, const auto* src,
                     int R, int C, int k) {
        using T = typename std::remove_cv<
            typename std::remove_pointer<decltype(src)>::type>::type;
        const int n = R * C, cp = C | 1;             // k8_pad
        const size_t g0 = (size_t)k * n;
        const int q0 = NARROW ? (tid + NT - turn) % NT : tid;   // first copy
        const int copies = sizeof(T) == sizeof(scalar) ? (one ? n : n * WB)
            : one ? (int)((g0 + n - (g0 & ~(size_t)1) + 1) / 2)
                  : n * (L::RB / 2);
        if (NARROW) turn = (turn + copies) % NT;
        if constexpr (sizeof(T) == sizeof(scalar)) {
            if (one) {
                #pragma unroll 1
                for (int q = q0; q < n; q += NT)
                    __pipeline_memcpy_async(dst + (q / C) * cp + q % C,
                                            src + g0 + q, sizeof(scalar));
            } else {
                #pragma unroll 1
                for (int q = q0; q < n * WB; q += NT) {
                    const int e = q / WB, j = q % WB;
                    const size_t bj = b0 + j < Bs ? b0 + j : Bs - 1;
                    __pipeline_memcpy_async(
                        dst + ((e / C) * cp + e % C) * RF + j,
                        src + (g0 + e) * Bs + bj, sizeof(scalar));
                }
            }
        } else {
            T* d = reinterpret_cast<T*>(stg);
            if (one) {
                const size_t a0 = g0 & ~(size_t)1, total = Ns * n;
                const int np = (int)((g0 + n - a0 + 1) / 2);
                #pragma unroll 1
                for (int q = q0; q < np; q += NT) {
                    const size_t gi = a0 + 2 * (size_t)q;
                    if (gi + 1 < total)
                        __pipeline_memcpy_async(d + 2 * q, src + gi, 4);
                    else if (gi < total)
                        d[2 * q] = src[gi];
                }
            } else {
                constexpr int NP = L::RB / 2;
                const size_t total = Ns * n * Bs;
                #pragma unroll 1
                for (int q = q0; q < n * NP; q += NT) {
                    const int e = q / NP, p = q % NP;
                    const size_t gi =
                        (((g0 + e) * Bs + b0) & ~(size_t)1) + 2 * p;
                    if (gi + 1 < total)
                        __pipeline_memcpy_async(d + e * L::RB + 2 * p,
                                                src + gi, 4);
                    else if (gi < total)
                        d[e * L::RB + 2 * p] = src[gi];
                }
            }
        }
    };
    // A narrow stream's staged block of stage k into its place, upcast.
    auto convert = [&](bool one, scalar* dst, const char* stg, int R, int C,
                       int k) {
        const __nv_bfloat16* s = reinterpret_cast<const __nv_bfloat16*>(stg);
        const int n = R * C, cp = C | 1;             // k8_pad
        const size_t g0 = (size_t)k * n;
        if (one) {
            const int o = (int)(g0 & 1);
            #pragma unroll 1
            for (int q = tid; q < n; q += NT)
                dst[(q / C) * cp + q % C] = up(s[o + q]);
        } else {
            #pragma unroll 1
            for (int q = tid; q < n * WB; q += NT) {
                const int e = q / WB, j = q % WB;
                const int o = (int)(((g0 + e) * Bs + b0) & 1);
                dst[((e / C) * cp + e % C) * RF + j] = up(s[e * L::RB + o + j]);
            }
        }
    };

    // ------------------------------------------------------ phase 1
    // Step n of the sweep is stage k = N-1-n.  One copy group a step
    // (empty past the end), so groups and steps stay in step.
    auto prefetch1 = [&](int n) {
        if (n < N) {
            const int k = N - 1 - n;
            scalar* s = words(n);
            char* g = staging(n);
            stage(SHARED, s + L::A1, g + L::SA1, A, NX, NX, k);
            stage(SHARED, s + L::B1, g + L::SB1, B, NX, NU, k);
            stage(SHARED, s + L::H1, g + L::SH1, h, NZ, 1, k);
            stage(SHARED, s + L::D1, g + L::SD1, D, NC, NZ, k);
            stage(SHARED, s + L::M1, g, mask, NC, 1, k);
            if constexpr (CACHED) {
                stage(SHARED, s + L::PF1, g, Pf, NX, NX, k);
                stage(SHARED, s + L::LF1, g, Lf, NU, NU, k);
                stage(SHARED, s + L::KF1, g, Kf, NU, NX, k);
            } else {
                stage(SHARED, s + L::HS1, g + L::SHS1, Hs, NZ, NZ, k);
            }
            stage(false, s + L::C1, g + L::SC1, c, NX, 1, k);
            stage(false, s + L::W1, g, w, NZ, 1, k);
            stage(false, s + L::Z1, g, z, NC, 1, k);
            stage(false, s + L::Y1, g, y, NC, 1, k);
        }
        __pipeline_commit();
    };
    auto convert1 = [&](int n) {
        if (NARROW && n < N) {
            const int k = N - 1 - n;
            scalar* s = words(n);
            const char* g = staging(n);
            convert(SHARED, s + L::A1, g + L::SA1, NX, NX, k);
            convert(SHARED, s + L::B1, g + L::SB1, NX, NU, k);
            convert(SHARED, s + L::H1, g + L::SH1, NZ, 1, k);
            convert(SHARED, s + L::D1, g + L::SD1, NC, NZ, k);
            if (!CACHED) convert(SHARED, s + L::HS1, g + L::SHS1, NZ, NZ, k);
            convert(false, s + L::C1, g + L::SC1, NX, 1, k);
        }
    };
    // At the top of step n: step n's data in its place (converted, when
    // narrow, during step n-1), published by one barrier that also frees
    // the slot of step n-1 for step n+K8_PF.
    auto wait = [&]() {
        if constexpr (NARROW)
            __pipeline_wait_prior(K8_PF - 2);    // steps n and n+1 landed
        else
            __pipeline_wait_prior(K8_PF - 1);    // step n landed (my copies)
        __syncthreads();
    };

    scalar* P = sm + Wp::P;
    scalar* p = sm + Wp::PV;
    scalar* const HfW = sm + Wp::HF;
    scalar* hf = sm + Wp::HV;
    scalar* rg = sm + Wp::RG;
    scalar* rmD = sm + Wp::RMD;
    scalar* Pcp = sm + Wp::PCP;
    scalar* rbar = sm + Wp::RB;
    for (int e = lane; e < NX; e += 32) p[e] = pN[e * Bs + bc];
    if (!CACHED)
        for (int e = lane; e < NX * NX; e += 32) P[e] = PN[e * Bs + bc];
    for (int n = 0; n < K8_PF; ++n) prefetch1(n);
    if (NARROW) {
        __pipeline_wait_prior(K8_PF - 1);
        __syncthreads();
        convert1(0);
    }
    K8_PROF_INIT
    for (int n = 0; n < N; ++n) {
        const int k = N - 1 - n;
        const size_t ks = (size_t)k;
        wait();
        K8_MARK(0);
        prefetch1(n + K8_PF);
        convert1(n + 1);
        K8_MARK(1);
        // This step's slot: the model's streams (M) and this scenario's
        // (V); entry (r, c) of an R x C stream at [OFF + (r pad(C) + c) R*].
        const scalar* Ms = words(n) + (SHARED ? 0 : warp);
        const scalar* Vs = words(n) + warp;
        auto mA = [&](int r, int q) { return Ms[L::A1 + (r * XP + q) * RM]; };
        auto mB = [&](int r, int q) { return Ms[L::B1 + (r * UP + q) * RM]; };
        auto mD = [&](int r, int q) { return Ms[L::D1 + (r * ZP + q) * RM]; };
        auto mHs = [&](int r, int q) { return Ms[L::HS1 + (r * ZP + q) * RM]; };
        auto mP = [&](int r, int q) { return Ms[L::PF1 + (r * XP + q) * RM]; };
        auto mL = [&](int r, int q) { return Ms[L::LF1 + (r * UP + q) * RM]; };
        auto mK = [&](int r, int q) { return Ms[L::KF1 + (r * XP + q) * RM]; };
        auto vh = [&](int e) { return Ms[L::H1 + e * RM]; };
        auto vM = [&](int e) { return Ms[L::M1 + e * RM]; };
        auto vc = [&](int e) { return Vs[L::C1 + e * RF]; };
        auto vw = [&](int e) { return Vs[L::W1 + e * RF]; };
        auto vz = [&](int e) { return Vs[L::Z1 + e * RF]; };
        auto vy = [&](int e) { return Vs[L::Y1 + e * RF]; };
        // The folded H, entry (r, q): the warp's own words, or (INPLACE)
        // its column of the slot's Hs, folded in place.
        scalar* const Hcol = words(n) + warp + L::HS1;
        auto Hf = [&](int r, int q) -> scalar& {
            if constexpr (INPLACE) return Hcol[(r * ZP + q) * RF];
            else return HfW[r * NZ + q];
        };

        // rho m z - y a row, and (uncached) rho m D.
        for (int e = lane; e < NC; e += 32) rg[e] = rho_b * vM(e) * vz(e) - vy(e);
        if (!CACHED)
            for (int e = lane; e < NC * NZ; e += 32)
                rmD[e] = (rho_b * vM(e / NZ)) * mD(e / NZ, e % NZ);
        __syncwarp();
        K8_MARK(2);
        // The penalty fold (uncached: H and h; cached: h), and in the
        // cached form Pcp = P_{k+1} c + p beside it.
        const int nfold = CACHED ? NZ + NX : NZ * NZ + NZ;
        for (int e = lane; e < nfold; e += 32) {
            const int r = CACHED ? e : e - NZ * NZ;
            if (!CACHED && e < NZ * NZ) {
                const int i = e / NZ, q = e % NZ;
                scalar acc = mHs(i, q);
#pragma unroll
                for (int ci = 0; ci < NC; ++ci)
                    acc += mD(ci, i) * rmD[ci * NZ + q];
                Hf(i, q) = acc;
            } else if (r < NZ) {
                scalar rgv[NC];
                k8_vec(rgv, rg);
                scalar acc = vh(r) - sigma * vw(r);
#pragma unroll
                for (int ci = 0; ci < NC; ++ci) acc -= rgv[ci] * mD(ci, r);
                hf[r] = acc;
            } else {
                const int i = r - NZ;
                scalar acc = mP(i, 0) * vc(0);
#pragma unroll
                for (int t = 1; t < NX; ++t) acc += mP(i, t) * vc(t);
                Pcp[i] = acc + p[i];
            }
        }
        __syncwarp();
        K8_MARK(3);
        if constexpr (CACHED) {
            // rbar = h_u + B^T Pcp; d = -(L L^T)^-1 rbar (every lane);
            // p = h_x + A^T Pcp + K^T rbar.
            for (int j = lane; j < NU; j += 32) {
                scalar pv[NX];
                k8_vec(pv, Pcp);
                scalar acc = hf[j];
#pragma unroll
                for (int t = 0; t < NX; ++t) acc += mB(t, j) * pv[t];
                rbar[j] = acc;
            }
            __syncwarp();
            scalar dv[NU], inv[NU], rb[NU];
            k8_vec(rb, rbar);
#pragma unroll
            for (int i = 0; i < NU; ++i) inv[i] = (scalar)1 / mL(i, i);
#pragma unroll
            for (int i = 0; i < NU; ++i) {
                scalar acc = rb[i];
#pragma unroll
                for (int t = 0; t < i; ++t) acc -= mL(i, t) * dv[t];
                dv[i] = acc * inv[i];
            }
#pragma unroll
            for (int i = NU - 1; i >= 0; --i) {
                scalar acc = dv[i];
#pragma unroll
                for (int t = i + 1; t < NU; ++t) acc -= mL(t, i) * dv[t];
                dv[i] = acc * inv[i];
            }
#pragma unroll
            for (int i = 0; i < NU; ++i)
                if (i == lane && valid) spill_b[ks * SPW + i] = -dv[i];
            for (int i = lane; i < NX; i += 32) {
                scalar pv[NX];
                k8_vec(pv, Pcp);
                scalar acc = hf[NU + i];
#pragma unroll
                for (int t = 0; t < NX; ++t) acc += mA(t, i) * pv[t];
#pragma unroll
                for (int t = 0; t < NU; ++t) acc += mK(t, i) * rb[t];
                p[i] = acc;
            }
            __syncwarp();
            K8_MARK(4);
            continue;
        }
        // PA = P A, PB = P B, Pcp = P c + p.
        scalar* PA = sm + Wp::PA;
        scalar* PB = sm + Wp::PB;
        for (int e = lane; e < NX * NX + NX * NU + NX; e += 32) {
            const int i = e < NX * NX ? e / NX
                : e < NX * NX + NX * NU ? (e - NX * NX) / NU
                                        : e - NX * NX - NX * NU;
            scalar pr[NX];                       // row i of P
            if constexpr (NX % K8_VEC == 0)
                k8_vec(pr, P + i * NX);
            else
                for (int t = 0; t < NX; ++t) pr[t] = P[i * NX + t];
            if (e < NX * NX) {
                const int j = e % NX;
                scalar acc = pr[0] * mA(0, j);
#pragma unroll
                for (int t = 1; t < NX; ++t) acc += pr[t] * mA(t, j);
                PA[e] = acc;
            } else if (e < NX * NX + NX * NU) {
                const int f = e - NX * NX, j = f % NU;
                scalar acc = pr[0] * mB(0, j);
#pragma unroll
                for (int t = 1; t < NX; ++t) acc += pr[t] * mB(t, j);
                PB[f] = acc;
            } else {
                scalar acc = pr[0] * vc(0);
#pragma unroll
                for (int t = 1; t < NX; ++t) acc += pr[t] * vc(t);
                Pcp[i] = acc + p[i];
            }
        }
        __syncwarp();
        // G = S + B^T PA, rbar = r + B^T Pcp, lower Huu = R + B^T PB.
        scalar* G = sm + Wp::G;
        scalar* Huu = sm + Wp::HUU;
        scalar* sK = sm + Wp::K;
        for (int e = lane; e < NU * NX + NU + NU * NU; e += 32) {
            if (e < NU * NX) {
                const int i = e / NX, j = e % NX;
                scalar acc = mB(0, i) * PA[j];
#pragma unroll
                for (int t = 1; t < NX; ++t) acc += mB(t, i) * PA[t * NX + j];
                G[e] = Hf(i, NU + j) + acc;
            } else if (e < NU * NX + NU) {
                const int i = e - NU * NX;
                scalar pv[NX];
                k8_vec(pv, Pcp);
                scalar acc = mB(0, i) * pv[0];
#pragma unroll
                for (int t = 1; t < NX; ++t) acc += mB(t, i) * pv[t];
                rbar[i] = hf[i] + acc;
            } else {
                const int f = e - NU * NX - NU, i = f / NU, j = f % NU;
                if (j <= i) {
                    scalar acc = Hf(i, j);
#pragma unroll
                    for (int t = 0; t < NX; ++t) acc += mB(t, i) * PB[t * NU + j];
                    Huu[f] = acc;
                }
            }
        }
        __syncwarp();
        // [K d] = -Huu^-1 [G rbar], one lane a column (K1's phase 3): each
        // factors the NU x NU block itself, in registers, then substitutes.
        for (int col = lane; col <= NX; col += 32) {
            scalar Lr[NU][NU], inv[NU], yv[NU];
#pragma unroll
            for (int j = 0; j < NU; ++j) {
                scalar sjj = Huu[j * NU + j];
#pragma unroll
                for (int t = 0; t < j; ++t) sjj -= Lr[j][t] * Lr[j][t];
                Lr[j][j] = sqrt(sjj);
                inv[j] = (scalar)1 / Lr[j][j];
#pragma unroll
                for (int i = j + 1; i < NU; ++i) {
                    scalar sij = Huu[i * NU + j];
#pragma unroll
                    for (int t = 0; t < j; ++t) sij -= Lr[i][t] * Lr[j][t];
                    Lr[i][j] = sij * inv[j];
                }
            }
#pragma unroll
            for (int i = 0; i < NU; ++i) {
                scalar acc = (col < NX) ? G[i * NX + col] : rbar[i];
#pragma unroll
                for (int t = 0; t < i; ++t) acc -= Lr[i][t] * yv[t];
                yv[i] = acc * inv[i];
            }
#pragma unroll
            for (int i = NU - 1; i >= 0; --i) {
                scalar acc = yv[i];
#pragma unroll
                for (int t = i + 1; t < NU; ++t) acc -= Lr[t][i] * yv[t];
                yv[i] = acc * inv[i];
            }
#pragma unroll
            for (int i = 0; i < NU; ++i) {
                if (col < NX) {
                    sK[i * NX + col] = -yv[i];
                    if (valid) spill_b[ks * SPW + i * NX + col] = -yv[i];
                } else if (valid) {
                    spill_b[ks * SPW + NU * NX + i] = -yv[i];
                }
            }
        }
        __syncwarp();
        // P = Q + A^T PA + G^T K (upper triangle, mirrored: exactly
        // symmetric), p = q + A^T Pcp + K^T rbar.  Neither reads P or p.
        for (int e = lane; e < NX * NX + NX; e += 32) {
            if (e < NX * NX) {
                const int i = e / NX, j = e % NX;
                if (j >= i) {
                    scalar acc = Hf(NU + i, NU + j);
#pragma unroll
                    for (int t = 0; t < NX; ++t) acc += mA(t, i) * PA[t * NX + j];
#pragma unroll
                    for (int t = 0; t < NU; ++t) acc += G[t * NX + i] * sK[t * NX + j];
                    P[i * NX + j] = acc;
                    P[j * NX + i] = acc;
                }
            } else {
                const int i = e - NX * NX;
                scalar pv[NX], rb[NU];
                k8_vec(pv, Pcp);
                k8_vec(rb, rbar);
                scalar acc = hf[NU + i];
#pragma unroll
                for (int t = 0; t < NX; ++t) acc += mA(t, i) * pv[t];
#pragma unroll
                for (int t = 0; t < NU; ++t) acc += sK[t * NX + i] * rb[t];
                p[i] = acc;
            }
        }
        __syncwarp();
        K8_MARK(4);
    }

    // ------------------------------------------------------ phase 2
    // Every warp's gains are in device memory and the ring is free.
    __pipeline_wait_prior(0);
    __syncthreads();
    auto prefetch2 = [&](int k) {
        if (k < N) {
            scalar* s = words(k);
            char* g = staging(k);
            stage(SHARED, s + L::A2, g + L::SA2, A, NX, NX, k);
            stage(SHARED, s + L::B2, g + L::SB2, B, NX, NU, k);
            stage(SHARED, s + L::HS2, g + L::SHS2, Hs, NZ, NZ, k);
            stage(SHARED, s + L::D2, g + L::SD2, D, NC, NZ, k);
            stage(SHARED, s + L::M2, g, mask, NC, 1, k);
            stage(SHARED, s + L::LB2, g, lb, NC, 1, k);
            stage(SHARED, s + L::UB2, g, ub, NC, 1, k);
            if (HAS_SHIFT) stage(SHARED, s + L::SH2, g, shift, NC, 1, k);
            if (CACHED) stage(SHARED, s + L::KF2, g, Kf, NU, NX, k);
            stage(false, s + L::C2, g + L::SC2, c, NX, 1, k);
            stage(false, s + L::W2, g, w, NZ, 1, k);
            stage(false, s + L::Z2, g, z, NC, 1, k);
            stage(false, s + L::Y2, g, y, NC, 1, k);
            // The WB scenarios' gains of stage k, one run each.
            scalar* d = s + L::SP2;
#pragma unroll 1
            for (int q = NARROW ? (tid + NT - turn) % NT : tid; q < WB * SPW;
                 q += NT) {
                const int j = q / SPW, e = q % SPW;
                const size_t bj = b0 + j < Bs ? b0 + j : Bs - 1;
                __pipeline_memcpy_async(d + q, spill + (bj * Ns + k) * SPW + e,
                                        sizeof(scalar));
            }
        }
        __pipeline_commit();
    };
    auto convert2 = [&](int k) {
        if (NARROW && k < N) {
            scalar* s = words(k);
            const char* g = staging(k);
            convert(SHARED, s + L::A2, g + L::SA2, NX, NX, k);
            convert(SHARED, s + L::B2, g + L::SB2, NX, NU, k);
            convert(SHARED, s + L::HS2, g + L::SHS2, NZ, NZ, k);
            convert(SHARED, s + L::D2, g + L::SD2, NC, NZ, k);
            convert(false, s + L::C2, g + L::SC2, NX, 1, k);
        }
    };
    scalar *wt = sm + Wp::WT, *wn = sm + Wp::WN, *dw = sm + Wp::DW,
           *vx = sm + Wp::VX, *ztt = sm + Wp::ZT, *yn = sm + Wp::YN;
    for (int e = lane; e < NX; e += 32) sm[Wp::X + e] = x0[e * Bs + bc];
    for (int k = 0; k < K8_PF; ++k) prefetch2(k);
    if (NARROW) {
        __pipeline_wait_prior(K8_PF - 1);
        __syncthreads();
        convert2(0);
    }
    scalar rp = (scalar)0, rd = (scalar)0, ps = (scalar)0, ds = (scalar)0;
    for (int k = 0; k < N; ++k) {
        const size_t ks = (size_t)k;
        K8_MARK(11);
        wait();
        K8_MARK(5);
        prefetch2(k + K8_PF);
        convert2(k + 1);
        K8_MARK(6);
        const scalar* Ms = words(k) + (SHARED ? 0 : warp);
        const scalar* Vs = words(k) + warp;
        auto mA = [&](int r, int q) { return Ms[L::A2 + (r * XP + q) * RM]; };
        auto mB = [&](int r, int q) { return Ms[L::B2 + (r * UP + q) * RM]; };
        auto mHs = [&](int r, int q) { return Ms[L::HS2 + (r * ZP + q) * RM]; };
        auto mD = [&](int r, int q) { return Ms[L::D2 + (r * ZP + q) * RM]; };
        auto mK = [&](int r, int q) { return Ms[L::KF2 + (r * XP + q) * RM]; };
        auto vM = [&](int e) { return Ms[L::M2 + e * RM]; };
        auto vlb = [&](int e) { return Ms[L::LB2 + e * RM]; };
        auto vub = [&](int e) { return Ms[L::UB2 + e * RM]; };
        auto vsh = [&](int e) { return Ms[L::SH2 + e * RM]; };
        auto vc = [&](int e) { return Vs[L::C2 + e * RF]; };
        auto vw = [&](int e) { return Vs[L::W2 + e * RF]; };
        auto vz = [&](int e) { return Vs[L::Z2 + e * RF]; };
        auto vy = [&](int e) { return Vs[L::Y2 + e * RF]; };
        // This warp's gains: K and d (uncached), d (cached; K is the
        // model's).
        const scalar* gk = words(k) + L::SP2 + warp * SPW;
        const scalar* gd = gk + (CACHED ? 0 : NU * NX);
        const scalar* x = sm + Wp::X + (k & 1) * Wp::XS;
        scalar* xn = sm + Wp::X + ((k + 1) & 1) * Wp::XS;
        // w~ = [K x + d; x].
        for (int e = lane; e < NZ; e += 32) {
            if (e < NU) {
                scalar xv[NX];
                k8_vec(xv, x);
                scalar acc = gd[e];
#pragma unroll
                for (int t = 0; t < NX; ++t)
                    acc += (CACHED ? mK(e, t) : gk[e * NX + t]) * xv[t];
                wt[e] = acc;
            } else {
                wt[e] = x[e - NU];
            }
        }
        __syncwarp();
        K8_MARK(7);
        // x+ = A x + B u + c; w+ = alpha w~ + (1-alpha) w; w - w~.
        for (int e = lane; e < NX + NZ; e += 32) {
            if (e < NX) {
                scalar xv[NX], uv[NU];
                k8_vec(xv, x);
                k8_vec(uv, wt);
                scalar acc = vc(e);
#pragma unroll
                for (int t = 0; t < NX; ++t) acc += mA(e, t) * xv[t];
#pragma unroll
                for (int t = 0; t < NU; ++t) acc += mB(e, t) * uv[t];
                xn[e] = acc;
            } else {
                const int f = e - NX;
                wn[f] = alpha * wt[f] + oma * vw(f);
                dw[f] = vw(f) - wt[f];
            }
        }
        __syncwarp();
        K8_MARK(8);
        // This lane's constraint rows, up to the value to project.
        scalar zt[K8_RC], Dwn[K8_RC], relax[K8_RC], vv[K8_RC], rho_m[K8_RC];
#pragma unroll
        for (int r = 0; r < K8_RC; ++r) {
            const int ci = lane + 32 * r;
            if (ci < NC) {
                scalar wtv[NZ], wnv[NZ];
                k8_vec(wtv, wt);
                k8_vec(wnv, wn);
                scalar a = (scalar)0, an = (scalar)0;
#pragma unroll
                for (int f = 0; f < NZ; ++f) {
                    const scalar dv = mD(ci, f);
                    a += dv * wtv[f];
                    an += dv * wnv[f];
                }
                zt[r] = a;
                Dwn[r] = an;
                rho_m[r] = rho_b * vM(ci);
                vv[r] = value_to_project(a, vz(ci), vy(ci), vM(ci), rho_m[r],
                                         alpha, oma, relax[r]);
                vx[ci] = vv[r] + (HAS_SHIFT ? vsh(ci) : (scalar)0);
            }
        }
        __syncwarp();
        K8_MARK(9);
        // Projection, dual update, stores, and the terms the rows of w need.
#pragma unroll
        for (int r = 0; r < K8_RC; ++r) {
            const int ci = lane + 32 * r;
            if (ci < NC) {
                const scalar zp = project_row(
                    vx, 1, ci, vv[r], vlb(ci), vub(ci),
                    HAS_SHIFT ? vsh(ci) : (scalar)0);
                const scalar zn = zp * (vM(ci) > (scalar)0 ? (scalar)1 : (scalar)0);
                const scalar yv = vy(ci) + rho_m[r] * (relax[r] - zn);
                if (valid) {
                    z_new[(ks * NC + ci) * Bs + b] = zn;
                    y_new[(ks * NC + ci) * Bs + b] = yv;
                }
                ztt[ci] = rho_m[r] * (amo * (zt[r] - vz(ci)) + (vz(ci) - zn));
                yn[ci] = yv;
                rp = fmax(rp, fabs(Dwn[r] - zn));
                ps = fmax(ps, fmax(fabs(Dwn[r]), fabs(zn)));
            }
        }
        __syncwarp();
        K8_MARK(10);
        // Rows of w: w+ out, and the dual residual's terms.
        for (int e = lane; e < NZ; e += 32) {
            scalar dT = (scalar)0, dty = (scalar)0, Hdw = (scalar)0,
                   Hwn = (scalar)0;
            {
                scalar zv[NC], yv[NC];
                k8_vec(zv, ztt);
                k8_vec(yv, yn);
#pragma unroll
                for (int ci = 0; ci < NC; ++ci) {
                    const scalar dv = mD(ci, e);
                    dT += zv[ci] * dv;
                    dty += yv[ci] * dv;
                }
            }
            {
                scalar dwv[NZ], wnv[NZ];
                k8_vec(dwv, dw);
                k8_vec(wnv, wn);
#pragma unroll
                for (int f = 0; f < NZ; ++f) {
                    const scalar hv = mHs(e, f);
                    Hdw += hv * dwv[f];
                    Hwn += hv * wnv[f];
                }
            }
            dual_row(Hdw, Hwn, dT, dty, dw[e], wn[e], oma, asig, sigma, rd, ds);
            if (valid) w_new[(ks * NZ + e) * Bs + b] = wn[e];
        }
        __syncwarp();
    }
    K8_MARK(11);
    K8_PROF_DONE
    __pipeline_wait_prior(0);
    const scalar* xf = sm + Wp::X + (N & 1) * Wp::XS;
    for (int e = lane; e < NX; e += 32)
        if (valid) xN[e * Bs + b] = xf[e];
    // The lanes join their maxima.
    scalar* red = sm + Wp::RED;
    red[lane] = rp;
    red[32 + lane] = rd;
    red[64 + lane] = ps;
    red[96 + lane] = ds;
    __syncwarp();
    if (lane < 4 && valid) {
        scalar m = red[lane * 32];
        for (int g = 1; g < 32; ++g) m = fmax(m, red[lane * 32 + g]);
        res[lane * Bs + b] = m;
    }
}

template <class S, bool SHARED, bool CACHED>
int launch_iter(int N, int Bt, double alpha, double sigma, cudaStream_t st,
                const void* const* in, void* const* out)
{
    using Fit = K8Fit<S, SHARED, CACHED>;
    if (!Fit::OK) return (int)cudaErrorInvalidValue;   // one scenario does not fit
    const size_t smem = (size_t)Fit::BYTES;
    int e = set_smem(iter_kernel<S, SHARED, CACHED>, smem);
    if (e) return e;
    const int blocks = (Bt + Fit::WB - 1) / Fit::WB;
    const scalar* const* f = reinterpret_cast<const scalar* const*>(in);
    const S* const* s = reinterpret_cast<const S* const*>(in);
    scalar* const* o = reinterpret_cast<scalar* const*>(out);
    iter_kernel<S, SHARED, CACHED><<<blocks, 32 * Fit::WB, smem, st>>>(
        N, Bt, alpha, sigma, f[0], f[1], f[2], f[3], s[4], s[5], s[6], s[7],
        s[8], s[9], f[10], f[11], f[12], f[13], f[14], f[15], f[16], f[17],
        f[18], f[19], o[0], o[1], o[2], o[3], o[4], o[5]);
    return (int)cudaGetLastError();
}

#endif  // K5 / K8
#endif  // K4 / K6 / K5, K8

}  // namespace

extern "C" {

#if !defined(NC) || defined(FOLD)
#ifdef ADMM_PROFILE
int admm_read_prof(long long* out)
{
    return (int)cudaMemcpyFromSymbol(out, admm_prof, sizeof(admm_prof));
}
#endif
#endif
#ifndef NC
int admm_bwd_vec_prefold(int N, int Bt, void* stream,
                         const void* pN, const void* AK, const void* BL,
                         const void* c, const void* Pc, const void* hf,
                         void* dv)
{
    if (N <= 0 || Bt <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    const int blocks = (Bt + VA_W - 1) / VA_W;
    // The scenarios' rows go by the copy engine where its maps can take
    // them.
    constexpr int SZ = (int)sizeof(scalar);
    CUtensorMap maps[3] = {};
    const int tma = va_boxes(Bt, NZ, c, hf, Pc);
    if (tma) {
        int e = make_rows_map(&maps[0], c, (size_t)N * NX, Bt, NX, VA_W,
                              (int)sizeof(stage_t));
        if (!e) e = make_rows_map(&maps[1], hf, (size_t)N * NZ, Bt, NZ, VA_W, SZ);
        if (!e) e = make_rows_map(&maps[2], Pc, (size_t)N * NX, Bt, NX, VA_W, SZ);
        if (e) return e;
    }
    int e = set_smem(bwd_vec_prefold_kernel, K4_SMEM);
    if (e) return e;
    bwd_vec_prefold_kernel<<<blocks, K4_THREADS, K4_SMEM, st>>>(
        N, Bt, (const scalar*)pN, (const stage_t*)AK, (const stage_t*)BL,
        (const stage_t*)c, (const scalar*)Pc, (const scalar*)hf, (scalar*)dv,
        maps[0], maps[1], maps[2], tma);
    return (int)cudaGetLastError();
}
#elif defined(FOLD)
int admm_bwd_vec(int N, int Bt, double sigma, int pc_mode, void* stream,
                 const void* rho, const void* pN, const void* A,
                 const void* B, const void* h, const void* D,
                 const void* mask, const void* P, const void* L,
                 const void* K, const void* c, const void* Pc,
                 const void* wzy, const void* rung, void* dv)
{
    if (N <= 0 || Bt <= 0) return 0;
    if (pc_mode && NRUNG != 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int blocks = (Bt + VA_W - 1) / VA_W;
    // The copy engine takes the scenarios' rows where its maps can, and
    // the shared runs where they are aligned.
    constexpr int SZ = (int)sizeof(scalar);
    K6Maps maps = {};
    const int row_boxes = va_boxes(Bt, K6_NW, c, wzy, pc_mode ? Pc : nullptr);
    if (row_boxes) {
        int e = make_rows_map(&maps.m[K6_MC], c, (size_t)N * NX, Bt, NX, VA_W,
                              (int)sizeof(stage_t));
        if (!e) e = make_rows_map(&maps.m[K6_MWZY], wzy, (size_t)N * K6_NW, Bt,
                                  K6_NW, VA_W, SZ);
        if (!e && pc_mode)
            e = make_rows_map(&maps.m[K6_MPC], Pc, (size_t)N * NX, Bt, NX,
                              VA_W, SZ);
        if (e) return e;
    }
    // (The narrow form copies the rho scale alone as it lies.)
    const void* runs[K6_ROWS] = {A, B, h, D, mask, pc_mode ? nullptr : P, L, K};
    size_t any = 0;
    for (int q = 0; q < K6_ROWS; ++q)
        if (!NARROW || q == K6_MASK) any |= (size_t)runs[q];
    const int run_copies = (any & 15) == 0;
    for (int q = K6_P; q <= K6_K && run_copies && !NARROW; ++q) {
        const K6Run r = k6_run(q);
        if (!k6_boxed(q) || runs[q] == nullptr) continue;
        int e = make_rows_map(&maps.m[K6_MP + q - K6_P], runs[q],
                              (size_t)N * r.rows, r.cols, r.rows, r.box, SZ);
        if (e) return e;
    }
#define ADMM_BV_ARGS                                                         \
    N, Bt, sigma, (const scalar*)rho, (const scalar*)pN, (const stage_t*)A,  \
        (const stage_t*)B, (const stage_t*)h, (const stage_t*)D,             \
        (const scalar*)mask, (const stage_t*)P, (const stage_t*)L,           \
        (const stage_t*)K, (const stage_t*)c, (const scalar*)Pc,             \
        (const scalar*)wzy, (const int*)rung, (scalar*)dv, maps, row_boxes,  \
        run_copies
    if (pc_mode) {
        constexpr size_t smem = K6Layout<true>::SMEM;
        int e = set_smem(bwd_vec_kernel<true>, smem);
        if (e) return e;
        bwd_vec_kernel<true><<<blocks, K6_THREADS, smem, st>>>(ADMM_BV_ARGS);
    } else {
        constexpr size_t smem = K6Layout<false>::SMEM;
        int e = set_smem(bwd_vec_kernel<false>, smem);
        if (e) return e;
        bwd_vec_kernel<false><<<blocks, K6_THREADS, smem, st>>>(ADMM_BV_ARGS);
    }
#undef ADMM_BV_ARGS
    return (int)cudaGetLastError();
}
#elif !defined(ITER)  // K5
#ifdef ADMM_PROFILE
int admm_read_prof(long long* out)
{
    return (int)cudaMemcpyFromSymbol(out, admm_prof, sizeof(admm_prof));
}
#endif
int admm_fwd_update(int N, int Bt, double alpha, double sigma, int m_stride,
                    int k_stride, int emit_hf, void* stream,
                    const void* rho, const void* x0, const void* M,
                    const void* K, const void* Hs, const void* D,
                    const void* bnd, const void* h, const void* rung,
                    const void* dv, const void* wzy, void* wzy_new,
                    void* hf_new, void* xN, void* res)
{
    if (N <= 0 || Bt <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    const int blocks = (Bt + K5_W - 1) / K5_W;
#define ADMM_FU_ARGS                                                         \
    N, Bt, alpha, sigma, m_stride, k_stride, (const scalar*)rho,             \
        (const scalar*)x0, (const stage_t*)M, (const stage_t*)K,             \
        (const stage_t*)Hs, (const stage_t*)D, (const scalar*)bnd,           \
        (const stage_t*)h, (const int*)rung, (const scalar*)dv,              \
        (const scalar*)wzy, (scalar*)wzy_new, (scalar*)hf_new, (scalar*)xN,  \
        (scalar*)res, maps[0], maps[1], tma
    // The scenarios' rows go by the copy engine where its maps can take
    // them (the row stride a multiple of 16 bytes, aligned streams).
    constexpr int SZ = (int)sizeof(scalar);
    CUtensorMap maps[2] = {};
    const int tma = (size_t)Bt * SZ % 16 == 0
        && (((size_t)dv | (size_t)wzy) & 15) == 0;
    if (tma) {
        int e = make_rows_map(&maps[0], dv, (size_t)N * NZ, Bt, NZ, K5_W, SZ);
        if (e) return e;
        e = make_rows_map(&maps[1], wzy, (size_t)N * NW, Bt, NW, K5_W, SZ);
        if (e) return e;
    }
    if (emit_hf) {
        constexpr size_t smem = K5Fit<true>::SMEM;
        constexpr int threads = K5Fit<true>::THREADS;
        int e = set_smem(fwd_update_kernel<true>, smem);
        if (e) return e;
        fwd_update_kernel<true><<<blocks, threads, smem, st>>>(ADMM_FU_ARGS);
    } else {
        constexpr size_t smem = K5Fit<false>::SMEM;
        constexpr int threads = K5Fit<false>::THREADS;
        int e = set_smem(fwd_update_kernel<false>, smem);
        if (e) return e;
        fwd_update_kernel<false><<<blocks, threads, smem, st>>>(ADMM_FU_ARGS);
    }
#undef ADMM_FU_ARGS
    return (int)cudaGetLastError();
}
#else  // K8
#ifdef ADMM_PROFILE
int admm_read_prof(long long* out)
{
    return (int)cudaMemcpyFromSymbol(out, admm_prof, sizeof(admm_prof));
}
#endif
// in:  rho, PN, pN, x0, A, B, c, Hs, h, D, lb, ub, mask, shift, P, L, K, w,
//      z, y (A .. D of the storage type, bf16 when `narrow`);
// out: spill, w_new, z_new, y_new, xN, res.
int admm_iter(int N, int Bt, double alpha, double sigma, int shared,
              int cached, int narrow, void* stream,
              const void* rho, const void* PN, const void* pN, const void* x0,
              const void* A, const void* B, const void* c, const void* Hs,
              const void* h, const void* D, const void* lb, const void* ub,
              const void* mask, const void* shift, const void* P,
              const void* L, const void* K, const void* w, const void* z,
              const void* y, void* spill, void* w_new, void* z_new,
              void* y_new, void* xN, void* res)
{
    if (N <= 0 || Bt <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    const void* in[20] = {rho, PN, pN, x0, A, B, c, Hs, h, D, lb, ub, mask,
                          shift, P, L, K, w, z, y};
    void* out[6] = {spill, w_new, z_new, y_new, xN, res};
#define ADMM_IT(S, SH, CA)                                                   \
    if ((narrow != 0) == !std::is_same<S, scalar>::value                    \
        && (shared != 0) == SH && (cached != 0) == CA)                       \
        return launch_iter<S, SH, CA>(N, Bt, alpha, sigma, st, in, out);
    ADMM_IT(scalar, false, false) ADMM_IT(scalar, false, true)
    ADMM_IT(scalar, true, false) ADMM_IT(scalar, true, true)
    ADMM_IT(__nv_bfloat16, false, false) ADMM_IT(__nv_bfloat16, false, true)
    ADMM_IT(__nv_bfloat16, true, false) ADMM_IT(__nv_bfloat16, true, true)
#undef ADMM_IT
    return (int)cudaErrorInvalidValue;
}
#endif  // K4 / K6 / K5 / K8

}  // extern "C"
