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
// their shared streams: a scenario's rung is an int32 index, and a thread
// reads that rung's matrices at an offset in the ring slot, which holds
// all of them (the TPU kernels blend all rungs with one-hot weights).
//
// What bounds K4-K6 on this card is bytes (the per-scenario streams; the
// shared ones are kilobytes), and what a plain loop runs into first is
// latency: N dependent stages, a few thousand scenarios.  They take the
// geometry of the shared-model sweeps in riccati_kernels.cu
// (lanes_common.cuh): a block serves 32 scenarios with 4 threads each
// (K4, K6) or 8 (K5), a
// thread owns a slice of the rows of each per-scenario vector, what the
// others need is exchanged through shared memory, and every stage's inputs
// — the shared matrices and the 32 scenarios' vectors — are copied
// asynchronously into a ring of shared-memory slots 4 stages ahead of
// their use.  The whole horizon runs inside one launch; the per-scenario
// carry (p; x and the four residual maxima) never leaves the block.  K8
// carries per-scenario matrices and has a design of its own (see there).
//
// Each extern "C" entry point launches on the given stream, does not
// synchronise, allocates nothing and returns cudaGetLastError().

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#ifdef ITER
#include <cuda_bf16.h>

#include <type_traits>
#endif

#if !defined(SCALAR) || !defined(NX) || !defined(NU)
#error "build with -DSCALAR=<float|double> -DNX=<n> -DNU=<n> [-DNC=<n> ...]"
#endif
#ifndef NRUNG
#define NRUNG 1
#endif

// K5 runs eight threads a scenario, not the four of the other
// shared-model kernels: its stage is three times theirs.  With four its
// float32 instantiations took 142-168 registers a thread and a launch at
// N=512, B=4096 took 1.96 ms on an H100 (700 W); with eight they take
// 115-128 and the launch 1.40 ms (chip_smoke.py; PERF.md).  K4, like
// the two sweeps it is modelled on, was no faster with eight at that batch
// and slower at four times that batch, so it keeps four, and K6, its
// recursion with the fold in front, does the same.
#if defined(NC) && !defined(FOLD)
#define VS_GROUPS_N 8
#endif

#include "lanes_common.cuh"

namespace {

#ifndef NC
// ------------------------------------------------------------- kernel A
// The cached-factor vector recursion, backwards from p = pN:
//   Pcp  = Pc + p                 rbar = hf[:nu] + B^T Pcp
//   d    = -(L L^T)^{-1} rbar     v    = B d + c
//   p    = hf[nu:] + A^T Pcp + K^T rbar
// on the packed shared streams AK = [A; K] (nz x nx a stage) and
// BL = [B; L] (nz x nu), read as they are: the slot holds both row-major
// and a thread's reads of them are one address per warp (a broadcast).
// It writes dv = [d | v].  Every thread solves the nu x nu system (each
// needs the whole of d); the rows of v and p are split over the
// scenario's threads.

constexpr int K4_AK = 0;
constexpr int K4_BL = K4_AK + NZ * NX;
constexpr int K4_PACK = K4_BL + NZ * NU;
// Per-scenario rows after the matrices: c, hf, Pc.
constexpr int K4_SLOT_WORDS = K4_PACK + (NX + NZ + NX) * VS_LANES;
constexpr int K4_SMEM_WORDS = VS_SLOTS * K4_SLOT_WORDS + 2 * NX * VS_LANES;

__global__ void __launch_bounds__(VS_THREADS)
bwd_vec_prefold_kernel(
    int N, int Bt,
    const scalar* __restrict__ pN, const scalar* __restrict__ AK,
    const scalar* __restrict__ BL, const scalar* __restrict__ c,
    const scalar* __restrict__ Pc, const scalar* __restrict__ hf,
    scalar* __restrict__ dv_out)
{
    extern __shared__ double smem_aligned[];
    scalar* ring = reinterpret_cast<scalar*>(smem_aligned);
    scalar* xs = ring + VS_SLOTS * K4_SLOT_WORDS;            // Pcp exchange, x2

    const int tid = threadIdx.x;
    const int lane = tid % VS_LANES;
    const int grp = tid / VS_LANES;
    const size_t Bs = (size_t)Bt;
    const size_t b = (size_t)blockIdx.x * VS_LANES + lane;
    const bool valid = b < Bs;

    // Stage n of the sweep is model stage k = N-1-n.  One copy group per
    // call (empty past the end), so groups and stages stay in step.
    auto prefetch = [&](int n) {
        if (n < N) {
            const size_t ks = (size_t)(N - 1 - n);
            scalar* S = ring + (n % VS_SLOTS) * K4_SLOT_WORDS;
            scalar* V = S + K4_PACK;
            copy_matrix(S + K4_AK, AK + ks * NZ * NX, NZ * NX);
            copy_matrix(S + K4_BL, BL + ks * NZ * NU, NZ * NU);
            if (valid) {
                copy_rows<NX>(V, c + ks * NX * Bs + b, Bs, lane, grp);
                copy_rows<NZ>(V + NX * VS_LANES, hf + ks * NZ * Bs + b, Bs,
                              lane, grp);
                copy_rows<NX>(V + (NX + NZ) * VS_LANES, Pc + ks * NX * Bs + b,
                              Bs, lane, grp);
            }
        }
        __pipeline_commit();
    };

    // Pcp rows this thread owns, for the stage held in slot S.
    scalar p[VS_RX];
    auto put_Pcp = [&](const scalar* S, scalar* dst) {
        const scalar* pc = S + K4_PACK + (NX + NZ) * VS_LANES;
#pragma unroll
        for (int r = 0; r < VS_RX; ++r) {
            const int i = grp * VS_RX + r;
            if (i < NX) dst[i * VS_LANES + lane] = pc[i * VS_LANES + lane] + p[r];
        }
    };

#pragma unroll
    for (int r = 0; r < VS_RX; ++r) {
        const int i = grp * VS_RX + r;
        p[r] = (valid && i < NX) ? pN[i * Bs + b] : (scalar)0;
    }
    for (int n = 0; n < VS_PF; ++n) prefetch(n);
    __pipeline_wait_prior(VS_PF - 1);        // stage 0 landed (my copies)
    __syncthreads();                         // ... and everyone's
    put_Pcp(ring, xs);

    for (int n = 0; n < N; ++n) {
        const size_t ks = (size_t)(N - 1 - n);
        const scalar* S = ring + (n % VS_SLOTS) * K4_SLOT_WORDS;
        const scalar* sA = S + K4_AK;                // A[i][j] at i*NX + j
        const scalar* sK = sA + NX * NX;             // K[t][i] at t*NX + i
        const scalar* sB = S + K4_BL;                // B[i][j] at i*NU + j
        const scalar* sL = sB + NX * NU;             // L[i][j] at i*NU + j
        const scalar* cv = S + K4_PACK;
        const scalar* hv = cv + NX * VS_LANES;
        // Stage n+1 has landed too (it is read at the end of this stage),
        // and the barrier publishes it and this stage's Pcp.
        __pipeline_wait_prior(VS_PF - 2);
        __syncthreads();

        scalar Pcp[NX], rbar[NU], dv[NU], inv[NU];
        const scalar* xin = xs + (n & 1) * NX * VS_LANES;
#pragma unroll
        for (int t = 0; t < NX; ++t) Pcp[t] = xin[t * VS_LANES + lane];

        // rbar = hf_u + B^T Pcp ; d = -(L L^T)^{-1} rbar.
#pragma unroll
        for (int j = 0; j < NU; ++j) rbar[j] = hv[j * VS_LANES + lane];
#pragma unroll
        for (int t = 0; t < NX; ++t) {
#pragma unroll
            for (int j = 0; j < NU; ++j) rbar[j] += sB[t * NU + j] * Pcp[t];
        }
#pragma unroll
        for (int i = 0; i < NU; ++i) inv[i] = (scalar)1 / sL[i * NU + i];
#pragma unroll
        for (int i = 0; i < NU; ++i) {
            scalar acc = rbar[i];
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
        for (int i = 0; i < NU; ++i) dv[i] = -dv[i];

#pragma unroll
        for (int j = 0; j < NU; ++j)     // each input row stored by one group
            if (j / VS_RU == grp && valid) dv_out[(ks * NZ + j) * Bs + b] = dv[j];
        // Own rows: v = B d + c ; p = hf_x + A^T Pcp + K^T rbar.
#pragma unroll
        for (int r = 0; r < VS_RX; ++r) {
            const int i = grp * VS_RX + r;
            if (i < NX) {
                scalar vv = cv[i * VS_LANES + lane];
#pragma unroll
                for (int t = 0; t < NU; ++t) vv += sB[i * NU + t] * dv[t];
                if (valid) dv_out[(ks * NZ + NU + i) * Bs + b] = vv;
                scalar acc = hv[(NU + i) * VS_LANES + lane];
#pragma unroll
                for (int t = 0; t < NX; ++t) acc += sA[t * NX + i] * Pcp[t];
#pragma unroll
                for (int t = 0; t < NU; ++t) acc += sK[t * NX + i] * rbar[t];
                p[r] = acc;
            }
        }
        if (n + 1 < N)
            put_Pcp(ring + ((n + 1) % VS_SLOTS) * K4_SLOT_WORDS,
                    xs + ((n + 1) & 1) * NX * VS_LANES);
        prefetch(n + VS_PF);
    }
    __pipeline_wait_prior(0);
}

#elif defined(FOLD)
// ------------------------------------------------------------------- K6
// K4's recursion with the iterate fold in front of it, on the scenario's
// own rung of R stacked factor sets.  Per stage, backwards from p = pN:
//   rg   = rho m z - y             hf = h - sigma w - D^T rg
//   Pcp  = P c + p  (or Pc + p)    rbar = hf[:nu] + B^T Pcp
//   d    = -(L L^T)^{-1} rbar      v    = B d + c
//   p    = hf[nu:] + A^T Pcp + K^T rbar
// A thread folds every constraint row itself (nc products of one
// multiply-add each: cheaper than a barrier) and then the rows of hf it
// needs: all nu input rows (each thread solves the nu x nu system) and
// its own state rows.  PC_MODE: the per-scenario Pc = P_{k+1} c_k rides
// the ring instead of the P stream (one rung only).

constexpr int K6_NW = NZ + 2 * NC;            // wzy rows: w, z, y
constexpr int K6_A = 0;
constexpr int K6_B = K6_A + NX * NX;
constexpr int K6_H = K6_B + NX * NU;
constexpr int K6_D = K6_H + NZ;
constexpr int K6_MASK = K6_D + NC * NZ;
template <bool PC_MODE> struct K6Layout {
    // The R rungs of P (not in Pc mode), L and K, rung r at r * rows*cols.
    static constexpr int P = K6_MASK + NC;
    static constexpr int L = P + (PC_MODE ? 0 : NRUNG * NX * NX);
    static constexpr int K = L + NRUNG * NU * NU;
    // Per-scenario rows after the matrices: c, wzy, then (Pc mode) Pc.
    static constexpr int VEC = K + NRUNG * NU * NX;
    static constexpr int SLOT_WORDS =
        VEC + (NX + K6_NW + (PC_MODE ? NX : 0)) * VS_LANES;
    static constexpr int SMEM_WORDS =
        VS_SLOTS * SLOT_WORDS + 2 * NX * VS_LANES;
};

template <bool PC_MODE>
__global__ void __launch_bounds__(VS_THREADS)
bwd_vec_kernel(
    int N, int Bt, double sigma_d,
    const scalar* __restrict__ rho, const scalar* __restrict__ pN,
    const scalar* __restrict__ A, const scalar* __restrict__ B,
    const scalar* __restrict__ h, const scalar* __restrict__ D,
    const scalar* __restrict__ mask, const scalar* __restrict__ P,
    const scalar* __restrict__ L, const scalar* __restrict__ K,
    const scalar* __restrict__ c, const scalar* __restrict__ Pc,
    const scalar* __restrict__ wzy, const int* __restrict__ rung,
    scalar* __restrict__ dv_out)
{
    using Lay = K6Layout<PC_MODE>;
    extern __shared__ double smem_aligned[];
    scalar* ring = reinterpret_cast<scalar*>(smem_aligned);
    scalar* xs = ring + VS_SLOTS * Lay::SLOT_WORDS;          // Pcp exchange, x2

    const int tid = threadIdx.x;
    const int lane = tid % VS_LANES;
    const int grp = tid / VS_LANES;
    const size_t Bs = (size_t)Bt;
    const size_t b = (size_t)blockIdx.x * VS_LANES + lane;
    const bool valid = b < Bs;
    const scalar sigma = (scalar)sigma_d;
    const scalar rho_b = valid ? rho[b] : (scalar)0;
    // This scenario's rung: where its matrices lie in a slot.
    const int r_ix = (NRUNG > 1 && valid) ? rung[b] : 0;
    const int oP = Lay::P + r_ix * NX * NX;
    const int oL = Lay::L + r_ix * NU * NU;
    const int oK = Lay::K + r_ix * NU * NX;

    // Stage n of the sweep is model stage k = N-1-n.  One copy group per
    // call (empty past the end), so groups and stages stay in step.
    auto prefetch = [&](int n) {
        if (n < N) {
            const size_t ks = (size_t)(N - 1 - n);
            scalar* S = ring + (n % VS_SLOTS) * Lay::SLOT_WORDS;
            scalar* V = S + Lay::VEC;
            copy_matrix(S + K6_A, A + ks * NX * NX, NX * NX);
            copy_matrix(S + K6_B, B + ks * NX * NU, NX * NU);
            copy_matrix(S + K6_H, h + ks * NZ, NZ);
            copy_matrix(S + K6_D, D + ks * NC * NZ, NC * NZ);
            copy_matrix(S + K6_MASK, mask + ks * NC, NC);
            if (!PC_MODE)
                copy_matrix(S + Lay::P, P + ks * NRUNG * NX * NX,
                            NRUNG * NX * NX);
            copy_matrix(S + Lay::L, L + ks * NRUNG * NU * NU, NRUNG * NU * NU);
            copy_matrix(S + Lay::K, K + ks * NRUNG * NU * NX, NRUNG * NU * NX);
            if (valid) {
                copy_rows<NX>(V, c + ks * NX * Bs + b, Bs, lane, grp);
                copy_rows<K6_NW>(V + NX * VS_LANES, wzy + ks * K6_NW * Bs + b,
                                 Bs, lane, grp);
                if (PC_MODE)
                    copy_rows<NX>(V + (NX + K6_NW) * VS_LANES,
                                  Pc + ks * NX * Bs + b, Bs, lane, grp);
            }
        }
        __pipeline_commit();
    };

    // Pcp rows this thread owns, for the stage held in slot S.
    scalar p[VS_RX];
    auto put_Pcp = [&](const scalar* S, scalar* dst) {
        const scalar* cv = S + Lay::VEC;
#pragma unroll
        for (int r = 0; r < VS_RX; ++r) {
            const int i = grp * VS_RX + r;
            if (i < NX) {
                scalar acc;
                if (PC_MODE) {
                    acc = cv[(NX + K6_NW + i) * VS_LANES + lane];
                } else {
                    acc = (scalar)0;
#pragma unroll
                    for (int t = 0; t < NX; ++t)
                        acc += S[oP + i * NX + t] * cv[t * VS_LANES + lane];
                }
                dst[i * VS_LANES + lane] = acc + p[r];
            }
        }
    };

#pragma unroll
    for (int r = 0; r < VS_RX; ++r) {
        const int i = grp * VS_RX + r;
        p[r] = (valid && i < NX) ? pN[i * Bs + b] : (scalar)0;
    }
    for (int n = 0; n < VS_PF; ++n) prefetch(n);
    __pipeline_wait_prior(VS_PF - 1);        // stage 0 landed (my copies)
    __syncthreads();                         // ... and everyone's
    put_Pcp(ring, xs);

    for (int n = 0; n < N; ++n) {
        const size_t ks = (size_t)(N - 1 - n);
        const scalar* S = ring + (n % VS_SLOTS) * Lay::SLOT_WORDS;
        const scalar* sA = S + K6_A;                 // A[i][j] at i*NX + j
        const scalar* sB = S + K6_B;                 // B[i][j] at i*NU + j
        const scalar* sh = S + K6_H;
        const scalar* sD = S + K6_D;                 // D[c][e] at c*NZ + e
        const scalar* sm = S + K6_MASK;
        const scalar* sL = S + oL;                   // L[i][j] at i*NU + j
        const scalar* sK = S + oK;                   // K[t][i] at t*NX + i
        const scalar* cv = S + Lay::VEC;
        const scalar* wv = cv + NX * VS_LANES;       // w rows, z rows, y rows
        // Stage n+1 has landed too (it is read at the end of this stage),
        // and the barrier publishes it and this stage's Pcp.
        __pipeline_wait_prior(VS_PF - 2);
        __syncthreads();

        scalar Pcp[NX], rg[NC], rbar[NU], dv[NU], inv[NU];
        const scalar* xin = xs + (n & 1) * NX * VS_LANES;
#pragma unroll
        for (int t = 0; t < NX; ++t) Pcp[t] = xin[t * VS_LANES + lane];
#pragma unroll
        for (int ci = 0; ci < NC; ++ci)
            rg[ci] = rho_b * sm[ci] * wv[(NZ + ci) * VS_LANES + lane]
                - wv[(NZ + NC + ci) * VS_LANES + lane];
        // Row e of the folded cost hf.
        auto hf_row = [&](int e) {
            scalar acc = sh[e] - sigma * wv[e * VS_LANES + lane];
#pragma unroll
            for (int ci = 0; ci < NC; ++ci) acc -= rg[ci] * sD[ci * NZ + e];
            return acc;
        };

        // rbar = hf_u + B^T Pcp ; d = -(L L^T)^{-1} rbar.
#pragma unroll
        for (int j = 0; j < NU; ++j) {
            scalar acc = hf_row(j);
#pragma unroll
            for (int t = 0; t < NX; ++t) acc += sB[t * NU + j] * Pcp[t];
            rbar[j] = acc;
        }
#pragma unroll
        for (int i = 0; i < NU; ++i) inv[i] = (scalar)1 / sL[i * NU + i];
#pragma unroll
        for (int i = 0; i < NU; ++i) {
            scalar acc = rbar[i];
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
        for (int i = 0; i < NU; ++i) dv[i] = -dv[i];

#pragma unroll
        for (int j = 0; j < NU; ++j)     // each input row stored by one group
            if (j / VS_RU == grp && valid) dv_out[(ks * NZ + j) * Bs + b] = dv[j];
        // Own rows: v = B d + c ; p = hf_x + A^T Pcp + K^T rbar.
#pragma unroll
        for (int r = 0; r < VS_RX; ++r) {
            const int i = grp * VS_RX + r;
            if (i < NX) {
                scalar vv = cv[i * VS_LANES + lane];
#pragma unroll
                for (int t = 0; t < NU; ++t) vv += sB[i * NU + t] * dv[t];
                if (valid) dv_out[(ks * NZ + NU + i) * Bs + b] = vv;
                scalar acc = hf_row(NU + i);
#pragma unroll
                for (int t = 0; t < NX; ++t) acc += sA[t * NX + i] * Pcp[t];
#pragma unroll
                for (int t = 0; t < NU; ++t) acc += sK[t * NX + i] * rbar[t];
                p[r] = acc;
            }
        }
        if (n + 1 < N)
            put_Pcp(ring + ((n + 1) % VS_SLOTS) * Lay::SLOT_WORDS,
                    xs + ((n + 1) & 1) * NX * VS_LANES);
        prefetch(n + VS_PF);
    }
    __pipeline_wait_prior(0);
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
// A thread holds all of w~ and w+ (each thread computes u itself: nu
// short dot products cost less than a barrier) and owns its share of the
// constraint rows and of the rows of w.  Two exchanges through
// shared memory a stage: the (shifted) v of the constraint rows, so that
// a thread can take the norm over a cone whose rows lie with other
// threads (only when there are cones), and rg = rho m z+ - y+, the dual
// residual's row term and y+, which every row of hf+ and of the residual
// sums needs in full.  M and K come as two streams with a stage stride
// each: the packed MK = [M; K] of one rung is both at once (stride nz*nx,
// K nx*nx words in), the rung form R rungs of each stacked on rows.

#ifndef DIAG_COST
#error "kernel B: build with -DDIAG_COST as well"
#endif

constexpr int NB = 3 + HAS_SHIFT;             // bnd rows: lb, ub, mask[, shift]
constexpr int NW = NZ + 2 * NC;               // wzy rows: w, z, y
constexpr int HS_WORDS = DIAG_COST ? NZ : NZ * NZ;
constexpr int VS_RZ = (NZ + VS_GROUPS - 1) / VS_GROUPS;   // w rows/thread
constexpr int VS_RC = (NC + VS_GROUPS - 1) / VS_GROUPS;   // constraint rows/thread

// Slot layout (words): the shared matrices (all R rungs of M and K), then
// dv and wzy rows.
constexpr int K5_M = 0;
constexpr int K5_K = K5_M + NRUNG * NX * NX;
constexpr int K5_HS = K5_K + NRUNG * NU * NX;
constexpr int K5_D = K5_HS + HS_WORDS;
constexpr int K5_BND = K5_D + NC * NZ;
constexpr int K5_H = K5_BND + NB * NC;
constexpr int K5_VEC = K5_H + NZ;
constexpr int K5_SLOT_WORDS = K5_VEC + (NZ + NW) * VS_LANES;
// After the ring: x (x2), the cone stage's v, then rg / zt / y+ (which the
// closing reduction of the residual maxima reuses).
constexpr int K5_EX_ROWS = 3 * NC > 4 * VS_GROUPS ? 3 * NC : 4 * VS_GROUPS;
constexpr int K5_SMEM_WORDS =
    VS_SLOTS * K5_SLOT_WORDS + (2 * NX + NC + K5_EX_ROWS) * VS_LANES;

template <bool EMIT_HF>
__global__ void __launch_bounds__(VS_THREADS)
fwd_update_kernel(
    int N, int Bt, double alpha_d, double sigma_d, int m_stride, int k_stride,
    const scalar* __restrict__ rho, const scalar* __restrict__ x0,
    const scalar* __restrict__ M, const scalar* __restrict__ K,
    const scalar* __restrict__ Hs,
    const scalar* __restrict__ D, const scalar* __restrict__ bnd,
    const scalar* __restrict__ h, const int* __restrict__ rung,
    const scalar* __restrict__ dv, const scalar* __restrict__ wzy,
    scalar* __restrict__ wzy_new, scalar* __restrict__ hf_new,
    scalar* __restrict__ xN, scalar* __restrict__ res)
{
    extern __shared__ double smem_aligned[];
    scalar* ring = reinterpret_cast<scalar*>(smem_aligned);
    scalar* xs = ring + VS_SLOTS * K5_SLOT_WORDS;           // x exchange, x2
    scalar* vx = xs + 2 * NX * VS_LANES;                    // shifted v (cones)
    scalar* ex = vx + NC * VS_LANES;                        // rg | zt | y+

    const int tid = threadIdx.x;
    const int lane = tid % VS_LANES;
    const int grp = tid / VS_LANES;
    const size_t Bs = (size_t)Bt;
    const size_t b = (size_t)blockIdx.x * VS_LANES + lane;
    const bool valid = b < Bs;

    const scalar alpha = (scalar)alpha_d;
    const scalar oma = (scalar)(1.0 - alpha_d);
    const scalar amo = (scalar)(alpha_d - 1.0);
    const scalar sigma = (scalar)sigma_d;
    const scalar asig = (scalar)(alpha_d * sigma_d);
    const scalar rho_b = valid ? rho[b] : (scalar)1;
    // This scenario's rung: where its M and K lie in a slot.
    const int r_ix = (NRUNG > 1 && valid) ? rung[b] : 0;
    // The packed MK of one rung: one copy a stage fills both.
    const bool packed = NRUNG == 1 && K == M + NX * NX && k_stride == m_stride;
    const int oM = K5_M + r_ix * NX * NX;
    const int oK = K5_K + r_ix * NU * NX;

    auto prefetch = [&](int k) {
        if (k < N) {
            const size_t ks = (size_t)k;
            scalar* S = ring + (k % VS_SLOTS) * K5_SLOT_WORDS;
            if (packed) {            // [M; K] is one run, as the slot holds it
                copy_matrix(S + K5_M, M + ks * m_stride, NZ * NX);
            } else {
                copy_matrix(S + K5_M, M + ks * m_stride, NRUNG * NX * NX);
                copy_matrix(S + K5_K, K + ks * k_stride, NRUNG * NU * NX);
            }
            copy_matrix(S + K5_HS, Hs + ks * HS_WORDS, HS_WORDS);
            copy_matrix(S + K5_D, D + ks * NC * NZ, NC * NZ);
            copy_matrix(S + K5_BND, bnd + ks * NB * NC, NB * NC);
            if (EMIT_HF) copy_matrix(S + K5_H, h + ks * NZ, NZ);
            if (valid) {
                copy_rows<NZ>(S + K5_VEC, dv + ks * NZ * Bs + b, Bs, lane, grp);
                copy_rows<NW>(S + K5_VEC + NZ * VS_LANES,
                              wzy + ks * NW * Bs + b, Bs, lane, grp);
            }
        }
        __pipeline_commit();
    };

#pragma unroll
    for (int r = 0; r < VS_RX; ++r) {
        const int i = grp * VS_RX + r;
        if (i < NX) xs[i * VS_LANES + lane] = valid ? x0[i * Bs + b] : (scalar)0;
    }
    for (int k = 0; k < VS_PF; ++k) prefetch(k);
    // Running maxima of this thread's rows: r_prim, r_dual, prim / dual scale.
    scalar rp = (scalar)0, rd = (scalar)0, ps = (scalar)0, ds = (scalar)0;

    for (int k = 0; k < N; ++k) {
        const size_t ks = (size_t)k;
        const scalar* S = ring + (k % VS_SLOTS) * K5_SLOT_WORDS;
        const scalar* sM = S + oM;                   // M[i][t] at i*NX + t
        const scalar* sK = S + oK;                   // K[j][t] at j*NX + t
        const scalar* sHs = S + K5_HS;
        const scalar* sD = S + K5_D;                 // D[c][e] at c*NZ + e
        const scalar* sbnd = S + K5_BND;             // lb | ub | m [| shift]
        const scalar* sh = S + K5_H;
        const scalar* dvv = S + K5_VEC;              // d rows, then v rows
        const scalar* wv = dvv + NZ * VS_LANES;      // w rows, z rows, y rows
        __pipeline_wait_prior(VS_PF - 1);    // stage k landed (my copies)
        __syncthreads();                     // ... everyone's, and x_k

        const scalar* xin = xs + (k & 1) * NX * VS_LANES;
        scalar* xout = xs + ((k + 1) & 1) * NX * VS_LANES;
        scalar x[NX], w_t[NZ], w_new[NZ], dw[NZ];
#pragma unroll
        for (int t = 0; t < NX; ++t) x[t] = xin[t * VS_LANES + lane];
#pragma unroll
        for (int j = 0; j < NU; ++j) {
            scalar acc = dvv[j * VS_LANES + lane];
#pragma unroll
            for (int t = 0; t < NX; ++t) acc += sK[j * NX + t] * x[t];
            w_t[j] = acc;
        }
#pragma unroll
        for (int i = 0; i < NX; ++i) w_t[NU + i] = x[i];
#pragma unroll
        for (int e = 0; e < NZ; ++e) {
            const scalar w = wv[e * VS_LANES + lane];
            w_new[e] = alpha * w_t[e] + oma * w;
            dw[e] = w - w_t[e];
        }
        // Own rows of the rollout: x+ = M x + v.
#pragma unroll
        for (int r = 0; r < VS_RX; ++r) {
            const int i = grp * VS_RX + r;
            if (i < NX) {
                scalar acc = dvv[(NU + i) * VS_LANES + lane];
#pragma unroll
                for (int t = 0; t < NX; ++t) acc += sM[i * NX + t] * x[t];
                xout[i * VS_LANES + lane] = acc;
            }
        }

        // Own constraint rows, up to the value to project.
        scalar zt[VS_RC], zo[VS_RC], yo[VS_RC], vv[VS_RC], relax[VS_RC],
            Dwn[VS_RC], rho_m[VS_RC];
#pragma unroll
        for (int r = 0; r < VS_RC; ++r) {
            const int ci = grp * VS_RC + r;
            if (ci < NC) {
                scalar a = (scalar)0, an = (scalar)0;
#pragma unroll
                for (int e = 0; e < NZ; ++e) {
                    a += sD[ci * NZ + e] * w_t[e];
                    an += sD[ci * NZ + e] * w_new[e];
                }
                zt[r] = a;
                Dwn[r] = an;
                zo[r] = wv[(NZ + ci) * VS_LANES + lane];
                yo[r] = wv[(NZ + NC + ci) * VS_LANES + lane];
                const scalar m = sbnd[2 * NC + ci];
                rho_m[r] = rho_b * m;
                vv[r] = value_to_project(zt[r], zo[r], yo[r], m, rho_m[r],
                                         alpha, oma, relax[r]);
                if (NCONES > 0)
                    vx[ci * VS_LANES + lane] =
                        vv[r] + (HAS_SHIFT ? sbnd[3 * NC + ci] : (scalar)0);
            }
        }
        if (NCONES > 0) __syncthreads();

        // Projection, dual update, stores, and this row's exchange terms.
#pragma unroll
        for (int r = 0; r < VS_RC; ++r) {
            const int ci = grp * VS_RC + r;
            if (ci < NC) {
                const scalar m = sbnd[2 * NC + ci];
                const scalar zp = project_row(
                    vx + lane, VS_LANES, ci, vv[r], sbnd[ci], sbnd[NC + ci],
                    HAS_SHIFT ? sbnd[3 * NC + ci] : (scalar)0);
                const scalar z_new = zp * (m > (scalar)0 ? (scalar)1 : (scalar)0);
                const scalar y_new = yo[r] + rho_m[r] * (relax[r] - z_new);
                if (valid) {
                    wzy_new[(ks * NW + NZ + ci) * Bs + b] = z_new;
                    wzy_new[(ks * NW + NZ + NC + ci) * Bs + b] = y_new;
                }
                if (EMIT_HF) ex[ci * VS_LANES + lane] = rho_m[r] * z_new - y_new;
                ex[(NC + ci) * VS_LANES + lane] =
                    rho_m[r] * (amo * (zt[r] - zo[r]) + (zo[r] - z_new));
                ex[(2 * NC + ci) * VS_LANES + lane] = y_new;
                rp = fmax(rp, fabs(Dwn[r] - z_new));
                ps = fmax(ps, fmax(fabs(Dwn[r]), fabs(z_new)));
            }
        }
        __syncthreads();

        // Own rows of w: w+, the next iteration's hf, the dual residual.
#pragma unroll
        for (int r = 0; r < VS_RZ; ++r) {
            const int e = grp * VS_RZ + r;
            if (e < NZ) {
                const scalar wo = wv[e * VS_LANES + lane];
                scalar wt_e;
                if (e < NU) {
                    wt_e = dvv[e * VS_LANES + lane];
#pragma unroll
                    for (int t = 0; t < NX; ++t) wt_e += sK[e * NX + t] * x[t];
                } else {
                    wt_e = xin[(e - NU) * VS_LANES + lane];
                }
                const scalar wn_e = alpha * wt_e + oma * wo;
                const scalar dw_e = wo - wt_e;
                scalar hfn = EMIT_HF ? sh[e] - sigma * wn_e : (scalar)0;
                scalar dT = (scalar)0, dty = (scalar)0;
#pragma unroll
                for (int ci = 0; ci < NC; ++ci) {
                    const scalar Dce = sD[ci * NZ + e];
                    if (EMIT_HF) hfn -= ex[ci * VS_LANES + lane] * Dce;
                    dT += ex[(NC + ci) * VS_LANES + lane] * Dce;
                    dty += ex[(2 * NC + ci) * VS_LANES + lane] * Dce;
                }
                scalar Hdw, Hwn;
                if (DIAG_COST) {
                    Hdw = sHs[e] * dw_e;
                    Hwn = sHs[e] * wn_e;
                } else {
                    Hdw = (scalar)0;
                    Hwn = (scalar)0;
#pragma unroll
                    for (int f = 0; f < NZ; ++f) {
                        Hdw += sHs[e * NZ + f] * dw[f];
                        Hwn += sHs[e * NZ + f] * w_new[f];
                    }
                }
                dual_row(Hdw, Hwn, dT, dty, dw_e, wn_e, oma, asig, sigma, rd, ds);
                if (valid) {
                    wzy_new[(ks * NW + e) * Bs + b] = wn_e;
                    if (EMIT_HF) hf_new[(ks * NZ + e) * Bs + b] = hfn;
                }
            }
        }
        prefetch(k + VS_PF);
    }
    __pipeline_wait_prior(0);
    __syncthreads();
    const scalar* xfin = xs + (N & 1) * NX * VS_LANES;
#pragma unroll
    for (int r = 0; r < VS_RX; ++r) {
        const int i = grp * VS_RX + r;
        if (i < NX && valid) xN[i * Bs + b] = xfin[i * VS_LANES + lane];
    }
    // The threads of a scenario join their maxima.
    ex[(grp * 4 + 0) * VS_LANES + lane] = rp;
    ex[(grp * 4 + 1) * VS_LANES + lane] = rd;
    ex[(grp * 4 + 2) * VS_LANES + lane] = ps;
    ex[(grp * 4 + 3) * VS_LANES + lane] = ds;
    __syncthreads();
    for (int q = grp; q < 4; q += VS_GROUPS) {
        scalar m = ex[q * VS_LANES + lane];
        for (int g = 1; g < VS_GROUPS; ++g)
            m = fmax(m, ex[(g * 4 + q) * VS_LANES + lane]);
        if (valid) res[q * Bs + b] = m;
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
// What bounds it on this card: with per-scenario matrices (a batched
// problem, or per-scenario rho on one model) each scenario carries its own
// P (nx^2) and folded H (nz^2) through a chain of N dependent stages, and
// the bytes of a batched problem's stage data.  The design gives a
// scenario one warp: the carry and the stage's data and products live in
// the warp's slice of shared memory, each product's entries are dealt over
// the 32 lanes, and only __syncwarp orders the steps (no block barrier).
// Every stage's data is read from device memory when it is needed; on a
// shared model all warps read the same addresses, which the L1 cache
// serves.  The TPU kept the gains in its on-chip memory; here they make a
// round trip through device memory (mostly the L2 cache).  Templates:
// SHARED (the model's streams, factors included, have trailing size 1),
// CACHED (phase 1 on exported factors), S the storage type of the stage
// data A, B, c, Hs, h, D (the compute type, or bf16: upcast at load).

constexpr int K8_WARPS = 4;                   // scenarios a block
constexpr int K8_THREADS = 32 * K8_WARPS;
constexpr int K8_RC = (NC + 31) / 32;         // constraint rows a lane
// A warp's slice of shared memory (words): the stage's data ...
constexpr int W_A = 0;
constexpr int W_B = W_A + NX * NX;
constexpr int W_C = W_B + NX * NU;
constexpr int W_H = W_C + NX;                 // Hs, folded in phase 1
constexpr int W_HV = W_H + NZ * NZ;           // h, folded in phase 1
constexpr int W_D = W_HV + NZ;
constexpr int W_M = W_D + NC * NZ;            // rho scale
constexpr int W_LB = W_M + NC;
constexpr int W_UB = W_LB + NC;
constexpr int W_SH = W_UB + NC;
constexpr int W_W = W_SH + NC;
constexpr int W_Z = W_W + NZ;
constexpr int W_Y = W_Z + NC;
constexpr int W_FP = W_Y + NC;                // cached P_{k+1}
constexpr int W_FL = W_FP + NX * NX;          // cached chol(Huu)
constexpr int W_K = W_FL + NU * NU;           // K (either form)
constexpr int W_DV = W_K + NU * NX;           // d
// ... phase 1's carry and products ...
constexpr int W_P = W_DV + NU;
constexpr int W_PV = W_P + NX * NX;
constexpr int W_PA = W_PV + NX;
constexpr int W_PB = W_PA + NX * NX;
constexpr int W_PCP = W_PB + NX * NU;
constexpr int W_G = W_PCP + NX;
constexpr int W_RB = W_G + NU * NX;
constexpr int W_HUU = W_RB + NU;
// ... phase 2's: x (x2), w~, w+, w - w~, the shifted v, zt, y+, and the
// closing reduction's 4 x 32.
constexpr int W_X = W_HUU + NU * NU;
constexpr int W_WT = W_X + 2 * NX;
constexpr int W_WN = W_WT + NZ;
constexpr int W_DW = W_WN + NZ;
constexpr int W_VX = W_DW + NZ;
constexpr int W_ZT = W_VX + NC;
constexpr int W_YN = W_ZT + NC;
constexpr int W_RED = W_YN + NC;
constexpr int W_WORDS = W_RED + 4 * 32;
constexpr int K8_SMEM_WORDS = K8_WARPS * W_WORDS;

__device__ __forceinline__ scalar up(scalar v) { return v; }
__device__ __forceinline__ scalar up(__nv_bfloat16 v)
{
    return (scalar)__bfloat162float(v);
}

// n entries of one stage block into the warp's slice, entry e at src[e*st].
template <class T>
__device__ __forceinline__ void load(scalar* dst, const T* src, int n,
                                     size_t st, int lane)
{
    for (int e = lane; e < n; e += 32) dst[e] = up(src[e * st]);
}

template <class S, bool SHARED, bool CACHED>
__global__ void __launch_bounds__(K8_THREADS)
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
    extern __shared__ double smem_aligned[];
    const int lane = threadIdx.x % 32;
    const int warp = threadIdx.x / 32;
    const size_t Bs = (size_t)Bt;
    const size_t b = (size_t)blockIdx.x * K8_WARPS + warp;
    if (b >= Bs) return;                     // the whole warp: no barrier waits
    scalar* sm = reinterpret_cast<scalar*>(smem_aligned) + warp * W_WORDS;
    scalar *sA = sm + W_A, *sB = sm + W_B, *sc = sm + W_C, *sH = sm + W_H,
           *sh = sm + W_HV, *sD = sm + W_D, *sM = sm + W_M, *sw = sm + W_W,
           *sz = sm + W_Z, *sy = sm + W_Y, *sK = sm + W_K, *sd = sm + W_DV;

    const scalar alpha = (scalar)alpha_d;
    const scalar oma = (scalar)(1.0 - alpha_d);
    const scalar amo = (scalar)(alpha_d - 1.0);
    const scalar sigma = (scalar)sigma_d;
    const scalar asig = (scalar)(alpha_d * sigma_d);
    const scalar rho_b = rho[b];
    // The model's streams: entry e of a stage block at e*ms + mo.
    const size_t ms = SHARED ? 1 : Bs, mo = SHARED ? 0 : b;
    constexpr int SPW = CACHED ? NU : NU * (NX + 1);   // spill words a stage
    scalar* spill_b = spill + b * (size_t)N * SPW;
    // One stage's vectors of this scenario: w, z, y, and c.
    auto load_vectors = [&](size_t ks) {
        load(sc, c + ks * NX * Bs + b, NX, Bs, lane);
        load(sw, w + ks * NZ * Bs + b, NZ, Bs, lane);
        load(sz, z + ks * NC * Bs + b, NC, Bs, lane);
        load(sy, y + ks * NC * Bs + b, NC, Bs, lane);
    };

    // ------------------------------------------------------ phase 1
    scalar* P = sm + W_P;
    scalar* p = sm + W_PV;
    scalar* Pcp = sm + W_PCP;
    scalar* rbar = sm + W_RB;
    for (int e = lane; e < NX; e += 32) p[e] = pN[e * Bs + b];
    if (!CACHED)
        for (int e = lane; e < NX * NX; e += 32) P[e] = PN[e * Bs + b];
    __syncwarp();
    for (int k = N - 1; k >= 0; --k) {
        const size_t ks = (size_t)k;
        load(sA, A + ks * NX * NX * ms + mo, NX * NX, ms, lane);
        load(sB, B + ks * NX * NU * ms + mo, NX * NU, ms, lane);
        load(sh, h + ks * NZ * ms + mo, NZ, ms, lane);
        load(sD, D + ks * NC * NZ * ms + mo, NC * NZ, ms, lane);
        load(sM, mask + ks * NC * ms + mo, NC, ms, lane);
        load_vectors(ks);
        if (CACHED) {
            load(sm + W_FP, Pf + ks * NX * NX * ms + mo, NX * NX, ms, lane);
            load(sm + W_FL, Lf + ks * NU * NU * ms + mo, NU * NU, ms, lane);
            load(sK, Kf + ks * NU * NX * ms + mo, NU * NX, ms, lane);
        } else {
            load(sH, Hs + ks * NZ * NZ * ms + mo, NZ * NZ, ms, lane);
        }
        __syncwarp();
        // The penalty fold (uncached: H and h; cached: h), and in the
        // cached form Pcp = P_{k+1} c + p beside it.
        const int nfold = CACHED ? NZ + NX : NZ * NZ + NZ;
        for (int e = lane; e < nfold; e += 32) {
            const int r = CACHED ? e : e - NZ * NZ;
            if (!CACHED && e < NZ * NZ) {
                const int i = e / NZ, q = e % NZ;
                scalar acc = sH[e];
                for (int ci = 0; ci < NC; ++ci)
                    acc += sD[ci * NZ + i] * ((rho_b * sM[ci]) * sD[ci * NZ + q]);
                sH[e] = acc;
            } else if (r < NZ) {
                scalar acc = sh[r] - sigma * sw[r];
                for (int ci = 0; ci < NC; ++ci)
                    acc -= (rho_b * sM[ci] * sz[ci] - sy[ci]) * sD[ci * NZ + r];
                sh[r] = acc;
            } else {
                const int i = r - NZ;
                const scalar* sP = sm + W_FP;
                scalar acc = sP[i * NX] * sc[0];
                for (int t = 1; t < NX; ++t) acc += sP[i * NX + t] * sc[t];
                Pcp[i] = acc + p[i];
            }
        }
        __syncwarp();
        if (CACHED) {
            // rbar = h_u + B^T Pcp; d = -(L L^T)^-1 rbar (every lane);
            // p = h_x + A^T Pcp + K^T rbar.
            for (int j = lane; j < NU; j += 32) {
                scalar acc = sh[j];
                for (int t = 0; t < NX; ++t) acc += sB[t * NU + j] * Pcp[t];
                rbar[j] = acc;
            }
            __syncwarp();
            const scalar* sL = sm + W_FL;
            scalar dv[NU];
#pragma unroll
            for (int i = 0; i < NU; ++i) {
                scalar acc = rbar[i];
#pragma unroll
                for (int t = 0; t < i; ++t) acc -= sL[i * NU + t] * dv[t];
                dv[i] = acc / sL[i * NU + i];
            }
#pragma unroll
            for (int i = NU - 1; i >= 0; --i) {
                scalar acc = dv[i];
#pragma unroll
                for (int t = i + 1; t < NU; ++t) acc -= sL[t * NU + i] * dv[t];
                dv[i] = acc / sL[i * NU + i];
            }
#pragma unroll
            for (int i = 0; i < NU; ++i)
                if (i == lane) spill_b[ks * SPW + i] = -dv[i];
            for (int i = lane; i < NX; i += 32) {
                scalar acc = sh[NU + i];
                for (int t = 0; t < NX; ++t) acc += sA[t * NX + i] * Pcp[t];
                for (int t = 0; t < NU; ++t) acc += sK[t * NX + i] * rbar[t];
                p[i] = acc;
            }
            __syncwarp();
            continue;
        }
        // PA = P A, PB = P B, Pcp = P c + p.
        scalar* PA = sm + W_PA;
        scalar* PB = sm + W_PB;
        for (int e = lane; e < NX * NX + NX * NU + NX; e += 32) {
            if (e < NX * NX) {
                const int i = e / NX, j = e % NX;
                scalar acc = P[i * NX] * sA[j];
                for (int t = 1; t < NX; ++t) acc += P[i * NX + t] * sA[t * NX + j];
                PA[e] = acc;
            } else if (e < NX * NX + NX * NU) {
                const int f = e - NX * NX, i = f / NU, j = f % NU;
                scalar acc = P[i * NX] * sB[j];
                for (int t = 1; t < NX; ++t) acc += P[i * NX + t] * sB[t * NU + j];
                PB[f] = acc;
            } else {
                const int i = e - NX * NX - NX * NU;
                scalar acc = P[i * NX] * sc[0];
                for (int t = 1; t < NX; ++t) acc += P[i * NX + t] * sc[t];
                Pcp[i] = acc + p[i];
            }
        }
        __syncwarp();
        // G = S + B^T PA, rbar = r + B^T Pcp, lower Huu = R + B^T PB.
        scalar* G = sm + W_G;
        scalar* Huu = sm + W_HUU;
        for (int e = lane; e < NU * NX + NU + NU * NU; e += 32) {
            if (e < NU * NX) {
                const int i = e / NX, j = e % NX;
                scalar acc = sB[i] * PA[j];
                for (int t = 1; t < NX; ++t) acc += sB[t * NU + i] * PA[t * NX + j];
                G[e] = sH[i * NZ + NU + j] + acc;
            } else if (e < NU * NX + NU) {
                const int i = e - NU * NX;
                scalar acc = sB[i] * Pcp[0];
                for (int t = 1; t < NX; ++t) acc += sB[t * NU + i] * Pcp[t];
                rbar[i] = sh[i] + acc;
            } else {
                const int f = e - NU * NX - NU, i = f / NU, j = f % NU;
                if (j <= i) {
                    scalar acc = sH[i * NZ + j];
                    for (int t = 0; t < NX; ++t) acc += sB[t * NU + i] * PB[t * NU + j];
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
                    spill_b[ks * SPW + i * NX + col] = -yv[i];
                } else {
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
                    scalar acc = sH[(NU + i) * NZ + NU + j];
                    for (int t = 0; t < NX; ++t) acc += sA[t * NX + i] * PA[t * NX + j];
                    for (int t = 0; t < NU; ++t) acc += G[t * NX + i] * sK[t * NX + j];
                    P[i * NX + j] = acc;
                    P[j * NX + i] = acc;
                }
            } else {
                const int i = e - NX * NX;
                scalar acc = sh[NU + i];
                for (int t = 0; t < NX; ++t) acc += sA[t * NX + i] * Pcp[t];
                for (int t = 0; t < NU; ++t) acc += sK[t * NX + i] * rbar[t];
                p[i] = acc;
            }
        }
        __syncwarp();
    }

    // ------------------------------------------------------ phase 2
    scalar *wt = sm + W_WT, *wn = sm + W_WN, *dw = sm + W_DW, *vx = sm + W_VX,
           *ztt = sm + W_ZT, *yn = sm + W_YN, *slb = sm + W_LB,
           *sub = sm + W_UB, *ssh = sm + W_SH;
    for (int e = lane; e < NX; e += 32) sm[W_X + e] = x0[e * Bs + b];
    scalar rp = (scalar)0, rd = (scalar)0, ps = (scalar)0, ds = (scalar)0;
    for (int k = 0; k < N; ++k) {
        const size_t ks = (size_t)k;
        const scalar* x = sm + W_X + (k & 1) * NX;
        scalar* xn = sm + W_X + ((k + 1) & 1) * NX;
        load(sA, A + ks * NX * NX * ms + mo, NX * NX, ms, lane);
        load(sB, B + ks * NX * NU * ms + mo, NX * NU, ms, lane);
        load(sH, Hs + ks * NZ * NZ * ms + mo, NZ * NZ, ms, lane);
        load(sD, D + ks * NC * NZ * ms + mo, NC * NZ, ms, lane);
        load(sM, mask + ks * NC * ms + mo, NC, ms, lane);
        load(slb, lb + ks * NC * ms + mo, NC, ms, lane);
        load(sub, ub + ks * NC * ms + mo, NC, ms, lane);
        if (HAS_SHIFT) load(ssh, shift + ks * NC * ms + mo, NC, ms, lane);
        load_vectors(ks);
        if (CACHED) {
            load(sK, Kf + ks * NU * NX * ms + mo, NU * NX, ms, lane);
            load(sd, spill_b + ks * SPW, NU, 1, lane);
        } else {
            load(sK, spill_b + ks * SPW, NU * NX, 1, lane);
            load(sd, spill_b + ks * SPW + NU * NX, NU, 1, lane);
        }
        __syncwarp();
        // w~ = [K x + d; x].
        for (int e = lane; e < NZ; e += 32) {
            if (e < NU) {
                scalar acc = sd[e];
                for (int t = 0; t < NX; ++t) acc += sK[e * NX + t] * x[t];
                wt[e] = acc;
            } else {
                wt[e] = x[e - NU];
            }
        }
        __syncwarp();
        // x+ = A x + B u + c; w+ = alpha w~ + (1-alpha) w; w - w~.
        for (int e = lane; e < NX + NZ; e += 32) {
            if (e < NX) {
                scalar acc = sc[e];
                for (int t = 0; t < NX; ++t) acc += sA[e * NX + t] * x[t];
                for (int t = 0; t < NU; ++t) acc += sB[e * NU + t] * wt[t];
                xn[e] = acc;
            } else {
                const int f = e - NX;
                wn[f] = alpha * wt[f] + oma * sw[f];
                dw[f] = sw[f] - wt[f];
            }
        }
        __syncwarp();
        // This lane's constraint rows, up to the value to project.
        scalar zt[K8_RC], Dwn[K8_RC], relax[K8_RC], vv[K8_RC], rho_m[K8_RC];
#pragma unroll
        for (int r = 0; r < K8_RC; ++r) {
            const int ci = lane + 32 * r;
            if (ci < NC) {
                scalar a = (scalar)0, an = (scalar)0;
                for (int e = 0; e < NZ; ++e) {
                    a += sD[ci * NZ + e] * wt[e];
                    an += sD[ci * NZ + e] * wn[e];
                }
                zt[r] = a;
                Dwn[r] = an;
                rho_m[r] = rho_b * sM[ci];
                vv[r] = value_to_project(a, sz[ci], sy[ci], sM[ci], rho_m[r],
                                         alpha, oma, relax[r]);
                vx[ci] = vv[r] + (HAS_SHIFT ? ssh[ci] : (scalar)0);
            }
        }
        __syncwarp();
        // Projection, dual update, stores, and the terms the rows of w need.
#pragma unroll
        for (int r = 0; r < K8_RC; ++r) {
            const int ci = lane + 32 * r;
            if (ci < NC) {
                const scalar zp = project_row(
                    vx, 1, ci, vv[r], slb[ci], sub[ci],
                    HAS_SHIFT ? ssh[ci] : (scalar)0);
                const scalar zn = zp * (sM[ci] > (scalar)0 ? (scalar)1 : (scalar)0);
                const scalar yv = sy[ci] + rho_m[r] * (relax[r] - zn);
                z_new[(ks * NC + ci) * Bs + b] = zn;
                y_new[(ks * NC + ci) * Bs + b] = yv;
                ztt[ci] = rho_m[r] * (amo * (zt[r] - sz[ci]) + (sz[ci] - zn));
                yn[ci] = yv;
                rp = fmax(rp, fabs(Dwn[r] - zn));
                ps = fmax(ps, fmax(fabs(Dwn[r]), fabs(zn)));
            }
        }
        __syncwarp();
        // Rows of w: w+ out, and the dual residual's terms.
        for (int e = lane; e < NZ; e += 32) {
            scalar dT = (scalar)0, dty = (scalar)0, Hdw = (scalar)0,
                   Hwn = (scalar)0;
            for (int ci = 0; ci < NC; ++ci) {
                dT += ztt[ci] * sD[ci * NZ + e];
                dty += yn[ci] * sD[ci * NZ + e];
            }
            for (int f = 0; f < NZ; ++f) {
                Hdw += sH[e * NZ + f] * dw[f];
                Hwn += sH[e * NZ + f] * wn[f];
            }
            dual_row(Hdw, Hwn, dT, dty, dw[e], wn[e], oma, asig, sigma, rd, ds);
            w_new[(ks * NZ + e) * Bs + b] = wn[e];
        }
        __syncwarp();
    }
    const scalar* xf = sm + W_X + (N & 1) * NX;
    for (int e = lane; e < NX; e += 32) xN[e * Bs + b] = xf[e];
    // The lanes join their maxima.
    scalar* red = sm + W_RED;
    red[lane] = rp;
    red[32 + lane] = rd;
    red[64 + lane] = ps;
    red[96 + lane] = ds;
    __syncwarp();
    if (lane < 4) {
        scalar m = red[lane * 32];
        for (int g = 1; g < 32; ++g) m = fmax(m, red[lane * 32 + g]);
        res[lane * Bs + b] = m;
    }
}

template <class S, bool SHARED, bool CACHED>
int launch_iter(int N, int Bt, double alpha, double sigma, cudaStream_t st,
                const void* const* in, void* const* out)
{
    const size_t smem = (size_t)K8_SMEM_WORDS * sizeof(scalar);
    int e = set_smem(iter_kernel<S, SHARED, CACHED>, smem);
    if (e) return e;
    const int blocks = (Bt + K8_WARPS - 1) / K8_WARPS;
    const scalar* const* f = reinterpret_cast<const scalar* const*>(in);
    const S* const* s = reinterpret_cast<const S* const*>(in);
    scalar* const* o = reinterpret_cast<scalar* const*>(out);
    iter_kernel<S, SHARED, CACHED><<<blocks, K8_THREADS, smem, st>>>(
        N, Bt, alpha, sigma, f[0], f[1], f[2], f[3], s[4], s[5], s[6], s[7],
        s[8], s[9], f[10], f[11], f[12], f[13], f[14], f[15], f[16], f[17],
        f[18], f[19], o[0], o[1], o[2], o[3], o[4], o[5]);
    return (int)cudaGetLastError();
}

#endif  // K5 / K8
#endif  // K4 / K6 / K5, K8

}  // namespace

extern "C" {

#ifndef NC
int admm_bwd_vec_prefold(int N, int Bt, void* stream,
                         const void* pN, const void* AK, const void* BL,
                         const void* c, const void* Pc, const void* hf,
                         void* dv)
{
    if (N <= 0 || Bt <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    const int blocks = (Bt + VS_LANES - 1) / VS_LANES;
    const size_t smem = K4_SMEM_WORDS * sizeof(scalar);
    int e = set_smem(bwd_vec_prefold_kernel, smem);
    if (e) return e;
    bwd_vec_prefold_kernel<<<blocks, VS_THREADS, smem, st>>>(
        N, Bt, (const scalar*)pN, (const scalar*)AK, (const scalar*)BL,
        (const scalar*)c, (const scalar*)Pc, (const scalar*)hf, (scalar*)dv);
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
    const int blocks = (Bt + VS_LANES - 1) / VS_LANES;
#define ADMM_BV_ARGS                                                         \
    N, Bt, sigma, (const scalar*)rho, (const scalar*)pN, (const scalar*)A,   \
        (const scalar*)B, (const scalar*)h, (const scalar*)D,                \
        (const scalar*)mask, (const scalar*)P, (const scalar*)L,             \
        (const scalar*)K, (const scalar*)c, (const scalar*)Pc,               \
        (const scalar*)wzy, (const int*)rung, (scalar*)dv
    if (pc_mode) {
        const size_t smem = K6Layout<true>::SMEM_WORDS * sizeof(scalar);
        int e = set_smem(bwd_vec_kernel<true>, smem);
        if (e) return e;
        bwd_vec_kernel<true><<<blocks, VS_THREADS, smem, st>>>(ADMM_BV_ARGS);
    } else {
        const size_t smem = K6Layout<false>::SMEM_WORDS * sizeof(scalar);
        int e = set_smem(bwd_vec_kernel<false>, smem);
        if (e) return e;
        bwd_vec_kernel<false><<<blocks, VS_THREADS, smem, st>>>(ADMM_BV_ARGS);
    }
#undef ADMM_BV_ARGS
    return (int)cudaGetLastError();
}
#elif !defined(ITER)  // K5
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
    const int blocks = (Bt + VS_LANES - 1) / VS_LANES;
    const size_t smem = K5_SMEM_WORDS * sizeof(scalar);
#define ADMM_FU_ARGS                                                         \
    N, Bt, alpha, sigma, m_stride, k_stride, (const scalar*)rho,             \
        (const scalar*)x0, (const scalar*)M, (const scalar*)K,               \
        (const scalar*)Hs, (const scalar*)D, (const scalar*)bnd,             \
        (const scalar*)h, (const int*)rung, (const scalar*)dv,               \
        (const scalar*)wzy, (scalar*)wzy_new, (scalar*)hf_new, (scalar*)xN,  \
        (scalar*)res
    if (emit_hf) {
        int e = set_smem(fwd_update_kernel<true>, smem);
        if (e) return e;
        fwd_update_kernel<true><<<blocks, VS_THREADS, smem, st>>>(ADMM_FU_ARGS);
    } else {
        int e = set_smem(fwd_update_kernel<false>, smem);
        if (e) return e;
        fwd_update_kernel<false><<<blocks, VS_THREADS, smem, st>>>(ADMM_FU_ARGS);
    }
#undef ADMM_FU_ARGS
    return (int)cudaGetLastError();
}
#else  // K8
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
