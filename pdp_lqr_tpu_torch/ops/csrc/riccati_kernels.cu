// Riccati sweep kernels for NVIDIA Hopper (sm_90a), plain C interface.
//
// The counterparts of the fused sweep kernels in
// pdp_lqr_tpu/ops/pallas_riccati.py:
//
//   riccati_backward          <- _backward_kernel      (backward_lanes, K1)
//   riccati_backward_vectors  <- _backward_vec_kernel  (backward_vectors_lanes, K2)
//   riccati_forward           <- _forward_kernel       (forward_lanes, K3)
//   riccati_forward_rollout   <- _forward_abc_kernel   (forward_rollout_lanes, K7)
//   riccati_backward_pdp      <- _backward_pdp_kernel  (backward_pdp_lanes, K9)
//   riccati_backward_pdp_vectors
//                             <- _backward_pdp_vec_kernel
//                                                      (backward_pdp_vectors_lanes, K10)
//   riccati_backward_packed   <- _backward_packed_kernel (backward_packed, K11)
//   riccati_forward_packed    <- _forward_packed_kernel  (forward_packed, K12)
//
// Every tensor is batch-last: element (k, i, j) of instance b of an
// (N, R, C, Bt) tensor lives at ((k*R + i)*C + j)*Bt + b.  The problem
// sizes are compile-time constants; a shared library is one
// specialisation:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -DSCALAR=float -DNX=12 -DNU=4 [-DNC=16] ...
//
// With -DNC the library holds the matrix sweeps (K1, K9, K11: the only
// kernels that read constraint rows); without it, the per-scenario kernels.
//
// Segments (K9, K10, K3): the horizon of N stages is cut into S segments
// of N/S contiguous stages, each run by its own blocks or threads in one
// launch: the one-card form of the reference's segment-parallel solver
// (lqr_solver_parallel.hpp), whose segments the JAX package puts on the
// devices of a mesh axis.  Per-segment carries and boundary values are
// (S, ..., Bt) tensors.
//
// Each extern "C" entry point launches on the given stream, does not
// synchronise, allocates nothing and returns cudaGetLastError().

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#if !defined(SCALAR) || !defined(NX) || !defined(NU)
#error "build with -DSCALAR=<float|double> -DNX=<n> -DNU=<n> [-DNC=<n>]"
#endif

#include "lanes_common.cuh"

namespace {

// Diagnostic build (-DRICCATI_PROFILE): thread 0 of block 0 sums the SM
// cycles it spends in each marked section of a stage; riccati_read_prof
// copies the sums out: a view inside a kernel for where the vendor's
// profilers cannot run.
#ifdef RICCATI_PROFILE
__device__ long long riccati_prof[8];
#define PROF_INIT                                                            \
    const bool prof_on = (threadIdx.x == 0 && blockIdx.x == 0);             \
    long long prof_acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};                        \
    long long prof_t = clock64();
#define PROF_MARK(i)                                                         \
    do {                                                                     \
        const long long t_ = clock64();                                      \
        prof_acc[i] += t_ - prof_t;                                          \
        prof_t = t_;                                                         \
    } while (0)
#define PROF_DONE                                                            \
    if (prof_on)                                                             \
        for (int i_ = 0; i_ < 8; ++i_) riccati_prof[i_] = prof_acc[i_];
#else
#define PROF_INIT
#define PROF_MARK(i)
#define PROF_DONE
#endif

#ifdef NC
// ------------------------------------------------------- K1, K9, K11
// Matrix sweep.  What bounds it on this card: neither bytes nor
// operations (one instance moves a few megabytes and does a few tens of
// kFLOP per stage) but the chain of N dependent stages, each a chain of
// dependent phases.  So the design spends one thread block per instance,
// keeps the stage data and the (P, p) carry in shared memory, lets
// threads own matrix entries inside each phase, and runs the loop over
// stages inside the block: no launch, no grid step and no device-memory
// round trip sits between two stages.  Off the chain are moved: the load
// of a stage's data (copied asynchronously into a second buffer while
// the stage before it runs) and its penalty fold, which does not depend
// on the carry (done by the warps that idle while one warp runs the
// Cholesky and the solves).  The serving path runs the kernel on ONE
// instance (the shared model); per-instance batches give one block each.
//
// PDP (K9, the segment reduction of the reference's parallel solver):
// one block per (segment, instance), S*Bt blocks, each sweeping its own
// N/S stages from its own initial carry, so the chain a block runs is
// S times shorter.  On top of K1's stage it carries the segment's
// closed-loop transition F, its offset f and the Gram C of the boundary
// dual, and solves [K Gp d] = -Huu^{-1} [G (F+ B)^T rbar] with 2nx+1
// right-hand sides:
//     Gp = -Huu^{-1} B^T F+^T,   F = F+ (A + B K) = F+ A + (F+ B) K,
//     f  = F+ (B d + c) + f+ = F+ c + (F+ B) d + f+,
//     C  = C+ - (F+ B) Gp       (upper triangle, mirrored: exactly symmetric,
//                                so the condensed Cholesky sees what JAX's does).
// F+ A, F+ B and F+ c are formed beside P A in phase 1, so F, f and C need
// no extra barrier.  After the segment's first stage the block writes the
// carry it hands its left neighbour, (P0, p0, F0, C0, f0).
//
// PACKED (K11): the stage data come row-packed, Sd = (A | B | c) and
// Sc = (H | h | D | rho | rho g), and the gains go out as G = (K | d): only
// the strides of the streams change (the entry point offsets the pointers).

// Stage buffer layout (words).
constexpr int S_A = 0;
constexpr int S_B = S_A + NX * NX;
constexpr int S_C = S_B + NX * NU;
constexpr int S_H = S_C + NX;
constexpr int S_HV = S_H + NZ * NZ;
constexpr int S_D = S_HV + NZ;
constexpr int S_RHO = S_D + NC * NZ;
constexpr int S_RG = S_RHO + NC;
constexpr int S_WORDS = S_RG + NC;

constexpr int K1_WORDS =
    2 * S_WORDS                                                // stage data (x2)
    + 2 * NX * NX + 2 * NX                                     // P, p (x2)
    + NX * NX + NX * NU + NX                                   // PA PB Pcp
    + NU * NX + NU + NU * NU + NU * NX + NU;                   // G rbar Huu K d
constexpr int K9_WORDS =
    K1_WORDS
    + 4 * NX * NX + 2 * NX                                     // F, C, f (x2)
    + NX * NX + NX * NU + NX                                   // FA FB Fc
    + NU * NX;                                                 // Gp

// Rows a stage takes in each stream: packed (K11) or one tensor a stream.
constexpr int SD_ROWS = NX * (NX + NU + 1);                    // A | B | c
constexpr int SC_ROWS = NZ * NZ + NZ + NC * NZ + 2 * NC;       // H | h | D | rho | rg
constexpr int G_ROWS = NU * NX + NU;                           // K | d
template <bool PACKED> struct K1Rows {
    static constexpr int A = PACKED ? SD_ROWS : NX * NX;
    static constexpr int B = PACKED ? SD_ROWS : NX * NU;
    static constexpr int C = PACKED ? SD_ROWS : NX;
    static constexpr int H = PACKED ? SC_ROWS : NZ * NZ;
    static constexpr int HV = PACKED ? SC_ROWS : NZ;
    static constexpr int D = PACKED ? SC_ROWS : NC * NZ;
    static constexpr int RHO = PACKED ? SC_ROWS : NC;
    static constexpr int K = PACKED ? G_ROWS : NU * NX;
    static constexpr int DV = PACKED ? G_ROWS : NU;
};

template <bool EMIT_MV, bool EXPORT, bool PDP, bool PACKED>
__global__ void backward_kernel(
    int N, int Bt, int S,
    const scalar* __restrict__ A, const scalar* __restrict__ B,
    const scalar* __restrict__ c, const scalar* __restrict__ H,
    const scalar* __restrict__ h, const scalar* __restrict__ D,
    const scalar* __restrict__ rho, const scalar* __restrict__ rg,
    const scalar* __restrict__ PN, const scalar* __restrict__ pN,
    scalar* __restrict__ K_out, scalar* __restrict__ d_out,
    scalar* __restrict__ M_out, scalar* __restrict__ v_out,
    scalar* __restrict__ P_out, scalar* __restrict__ L_out,
    const scalar* __restrict__ Fi, const scalar* __restrict__ Ci,
    const scalar* __restrict__ fi, scalar* __restrict__ Gp_out,
    scalar* __restrict__ F_out, scalar* __restrict__ P0_out,
    scalar* __restrict__ p0_out, scalar* __restrict__ F0_out,
    scalar* __restrict__ C0_out, scalar* __restrict__ f0_out)
{
    using R = K1Rows<PACKED>;
    extern __shared__ double smem_aligned[];
    scalar* s = reinterpret_cast<scalar*>(smem_aligned);
    scalar* stage0 = s;        s += S_WORDS;
    scalar* stage1 = s;        s += S_WORDS;
    scalar* P = s;             s += NX * NX;
    scalar* Pn = s;            s += NX * NX;
    scalar* p = s;             s += NX;
    scalar* pn = s;            s += NX;
    scalar* sPA = s;           s += NX * NX;
    scalar* sPB = s;           s += NX * NU;
    scalar* sPcp = s;          s += NX;
    scalar* sG = s;            s += NU * NX;
    scalar* srbar = s;         s += NU;
    scalar* sHuu = s;          s += NU * NU;
    scalar* sK = s;            s += NU * NX;
    scalar* sd = s;            s += NU;
    // K9's segment carries and products (past K1's words; unused by K1).
    scalar* F = s;             s += NX * NX;
    scalar* Fn = s;            s += NX * NX;
    scalar* C = s;             s += NX * NX;
    scalar* Cn = s;            s += NX * NX;
    scalar* f = s;             s += NX;
    scalar* fn = s;            s += NX;
    scalar* sFA = s;           s += NX * NX;
    scalar* sFB = s;           s += NX * NU;
    scalar* sFc = s;           s += NX;
    scalar* sGp = s;           s += NU * NX;

    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    // Block (segment, instance): the segment's stages are k0 .. k0+Nl-1.
    const int seg = PDP ? (int)(blockIdx.x / Bt) : 0;
    const size_t b = PDP ? blockIdx.x % Bt : blockIdx.x;
    const size_t Bs = (size_t)Bt;
    const int Nl = PDP ? N / S : N;
    const int k0 = seg * Nl;
    const size_t cs = (size_t)seg;          // this segment's carry slot

    // Copy stage k's data into buffer `which`, asynchronously.
    auto prefetch = [&](int k, int which) {
        scalar* S = which ? stage1 : stage0;
        const size_t ks = (size_t)k;
        if (k >= 0) {
            for (int i = tid; i < NX * NX; i += nt)
                copy_word(S + S_A + i, A + (ks * R::A + i) * Bs + b);
            for (int i = tid; i < NX * NU; i += nt)
                copy_word(S + S_B + i, B + (ks * R::B + i) * Bs + b);
            for (int i = tid; i < NX; i += nt)
                copy_word(S + S_C + i, c + (ks * R::C + i) * Bs + b);
            for (int i = tid; i < NZ * NZ; i += nt)
                copy_word(S + S_H + i, H + (ks * R::H + i) * Bs + b);
            for (int i = tid; i < NZ; i += nt)
                copy_word(S + S_HV + i, h + (ks * R::HV + i) * Bs + b);
            for (int i = tid; i < NC * NZ; i += nt)
                copy_word(S + S_D + i, D + (ks * R::D + i) * Bs + b);
            for (int i = tid; i < NC; i += nt) {
                copy_word(S + S_RHO + i, rho + (ks * R::RHO + i) * Bs + b);
                copy_word(S + S_RG + i, rg + (ks * R::RHO + i) * Bs + b);
            }
        }
        __pipeline_commit();
    };

    // Penalty fold (lqr_kernel.hpp:106-112), in place in the buffer S, by
    // the threads first .. nt-1:
    //   H += sum_c rho_c D_c D_c^T ;  h -= sum_c (rho_c g_c) D_c
    auto fold = [&](scalar* S, int first) {
        const scalar* sD = S + S_D;
        for (int e = tid - first; e >= 0 && e < NZ * NZ + NZ; e += nt - first) {
            if (e < NZ * NZ) {
                const int r = e / NZ, q = e % NZ;
                scalar acc = S[S_H + e];
                for (int ci = 0; ci < NC; ++ci)
                    acc += sD[ci * NZ + r] * (S[S_RHO + ci] * sD[ci * NZ + q]);
                S[S_H + e] = acc;
            } else {
                const int r = e - NZ * NZ;
                scalar acc = S[S_HV + r];
                for (int ci = 0; ci < NC; ++ci)
                    acc -= S[S_RG + ci] * sD[ci * NZ + r];
                S[S_HV + r] = acc;
            }
        }
    };

    // The warps that fold while warp 0 factors and solves; a block of a
    // single warp folds after it has solved.
    const int fold_first = nt > 32 ? 32 : 0;
    // Right-hand sides of the phase-3 solve: [G rbar], or [G (F+ B)^T rbar].
    constexpr int NCOL = PDP ? 2 * NX + 1 : NX + 1;

    prefetch(k0 + Nl - 1, 0);
    for (int i = tid; i < NX * NX; i += nt) P[i] = PN[(cs * NX * NX + i) * Bs + b];
    for (int i = tid; i < NX; i += nt) p[i] = pN[(cs * NX + i) * Bs + b];
    if (PDP) {
        for (int i = tid; i < NX * NX; i += nt) {
            F[i] = Fi[(cs * NX * NX + i) * Bs + b];
            C[i] = Ci[(cs * NX * NX + i) * Bs + b];
        }
        for (int i = tid; i < NX; i += nt) f[i] = fi[(cs * NX + i) * Bs + b];
    }
    __pipeline_wait_prior(0);
    __syncthreads();
    fold(stage0, 0);
    __syncthreads();
    PROF_INIT

    for (int k = k0 + Nl - 1; k >= k0; --k) {
        const size_t ks = (size_t)k;
        const int n = k0 + Nl - 1 - k;      // stages done in this block
        scalar* S = (n & 1) ? stage1 : stage0;
        scalar* Snext = (n & 1) ? stage0 : stage1;
        const scalar* sA = S + S_A;
        const scalar* sB = S + S_B;
        const scalar* sc = S + S_C;
        const scalar* sH = S + S_H;       // folded already
        const scalar* sh = S + S_HV;
        prefetch(k > k0 ? k - 1 : -1, (n + 1) & 1);
        PROF_MARK(0);

        // ---- phase 1: products with the carry: PA, PB, Pcp = P c + p
        // (and with F: FA, FB, Fc).
        for (int e = tid; e < NX * NX; e += nt) {
            const int i = e / NX, j = e % NX;
            scalar acc = P[i * NX] * sA[j];
            for (int t = 1; t < NX; ++t) acc += P[i * NX + t] * sA[t * NX + j];
            sPA[e] = acc;
            if (EXPORT) P_out[(ks * NX * NX + e) * Bs + b] = P[e];
            if (PDP) {
                scalar fa = F[i * NX] * sA[j];
                for (int t = 1; t < NX; ++t) fa += F[i * NX + t] * sA[t * NX + j];
                sFA[e] = fa;
                if (EXPORT) F_out[(ks * NX * NX + e) * Bs + b] = F[e];
            }
        }
        for (int e = tid; e < NX * NU; e += nt) {
            const int i = e / NU, j = e % NU;
            scalar acc = P[i * NX] * sB[j];
            for (int t = 1; t < NX; ++t) acc += P[i * NX + t] * sB[t * NU + j];
            sPB[e] = acc;
            if (PDP) {
                scalar fb = F[i * NX] * sB[j];
                for (int t = 1; t < NX; ++t) fb += F[i * NX + t] * sB[t * NU + j];
                sFB[e] = fb;
            }
        }
        for (int i = tid; i < NX; i += nt) {
            scalar acc = P[i * NX] * sc[0];
            for (int t = 1; t < NX; ++t) acc += P[i * NX + t] * sc[t];
            sPcp[i] = acc + p[i];
            if (PDP) {
                scalar fc = F[i * NX] * sc[0];
                for (int t = 1; t < NX; ++t) fc += F[i * NX + t] * sc[t];
                sFc[i] = fc;
            }
        }
        PROF_MARK(1);
        __syncthreads();
        PROF_MARK(2);

        // ---- phase 2: G = S + B^T PA, rbar = r + B^T Pcp, and the lower
        // triangle of Huu = R + B^T P B.
        for (int e = tid; e < NU * NX; e += nt) {
            const int i = e / NX, j = e % NX;
            scalar acc = sB[i] * sPA[j];
            for (int t = 1; t < NX; ++t) acc += sB[t * NU + i] * sPA[t * NX + j];
            sG[e] = sH[i * NZ + NU + j] + acc;
        }
        for (int i = tid; i < NU; i += nt) {
            scalar acc = sB[i] * sPcp[0];
            for (int t = 1; t < NX; ++t) acc += sB[t * NU + i] * sPcp[t];
            srbar[i] = sh[i] + acc;
        }
        for (int e = tid; e < NU * NU; e += nt) {
            const int i = e / NU, j = e % NU;
            if (j <= i) {
                scalar acc = sH[i * NZ + j];
                for (int t = 0; t < NX; ++t) acc += sB[t * NU + i] * sPB[t * NU + j];
                sHuu[e] = acc;
            }
        }
        __pipeline_wait_prior(0);     // the next stage's data is there
        PROF_MARK(3);
        __syncthreads();
        PROF_MARK(4);

        // ---- phase 3: [K (Gp) d] = -Huu^{-1} [G ((F+ B)^T) rbar], one
        // thread per column: each factors the NU x NU block itself, in
        // registers (cheaper than a barrier), then substitutes.  Meanwhile
        // the other warps fold the next stage's penalty.
        for (int col = tid; col < NCOL; col += nt) {
            scalar Lr[NU][NU], inv[NU], y[NU];
#pragma unroll
            for (int j = 0; j < NU; ++j) {
                scalar sjj = sHuu[j * NU + j];
#pragma unroll
                for (int t = 0; t < j; ++t) sjj -= Lr[j][t] * Lr[j][t];
                Lr[j][j] = sqrt(sjj);
                inv[j] = (scalar)1 / Lr[j][j];
#pragma unroll
                for (int i = j + 1; i < NU; ++i) {
                    scalar sij = sHuu[i * NU + j];
#pragma unroll
                    for (int t = 0; t < j; ++t) sij -= Lr[i][t] * Lr[j][t];
                    Lr[i][j] = sij * inv[j];
                }
            }
#pragma unroll
            for (int i = 0; i < NU; ++i) {
                scalar acc = col < NX ? sG[i * NX + col]
                           : (PDP && col < 2 * NX) ? sFB[(col - NX) * NU + i]
                           : srbar[i];
#pragma unroll
                for (int t = 0; t < i; ++t) acc -= Lr[i][t] * y[t];
                y[i] = acc * inv[i];
            }
#pragma unroll
            for (int i = NU - 1; i >= 0; --i) {
                scalar acc = y[i];
#pragma unroll
                for (int t = i + 1; t < NU; ++t) acc -= Lr[t][i] * y[t];
                y[i] = acc * inv[i];
            }
#pragma unroll
            for (int i = 0; i < NU; ++i) {
                if (col < NX) sK[i * NX + col] = -y[i];
                else if (PDP && col < 2 * NX) sGp[i * NX + col - NX] = -y[i];
                else sd[i] = -y[i];
            }
            if (EXPORT && col == 0) {     // chol(Huu), zeros above the diagonal
#pragma unroll
                for (int i = 0; i < NU; ++i)
#pragma unroll
                    for (int j = 0; j < NU; ++j)
                        L_out[(ks * NU * NU + i * NU + j) * Bs + b] =
                            (j <= i) ? Lr[i][j] : (scalar)0;
            }
        }
        if (k > k0) fold(Snext, fold_first);
        PROF_MARK(5);
        __syncthreads();
        PROF_MARK(6);

        // ---- phase 4: P+ = Q + A^T PA + G^T K (upper triangle, mirrored:
        // exactly symmetric), p+ = q + A^T Pcp + K^T rbar, the closed-loop
        // maps M = A + B K, v = B d + c, the segment carries, and the stores.
        for (int e = tid; e < NX * NX; e += nt) {
            const int i = e / NX, j = e % NX;
            if (j >= i) {
                scalar acc = sH[(NU + i) * NZ + NU + j];
                for (int t = 0; t < NX; ++t) acc += sA[t * NX + i] * sPA[t * NX + j];
                for (int t = 0; t < NU; ++t) acc += sG[t * NX + i] * sK[t * NX + j];
                Pn[i * NX + j] = acc;
                Pn[j * NX + i] = acc;
                if (PDP) {
                    scalar cc = C[e];
                    for (int t = 0; t < NU; ++t) cc -= sFB[i * NU + t] * sGp[t * NX + j];
                    Cn[i * NX + j] = cc;
                    Cn[j * NX + i] = cc;
                }
            }
            if (EMIT_MV) {
                scalar m = sA[e];
                for (int t = 0; t < NU; ++t) m += sB[i * NU + t] * sK[t * NX + j];
                M_out[(ks * NX * NX + e) * Bs + b] = m;
            }
            if (PDP) {
                scalar fm = sFA[e];
                for (int t = 0; t < NU; ++t) fm += sFB[i * NU + t] * sK[t * NX + j];
                Fn[e] = fm;
            }
        }
        for (int i = tid; i < NX; i += nt) {
            scalar acc = sh[NU + i];
            for (int t = 0; t < NX; ++t) acc += sA[t * NX + i] * sPcp[t];
            for (int t = 0; t < NU; ++t) acc += sK[t * NX + i] * srbar[t];
            pn[i] = acc;
            if (EMIT_MV) {
                scalar vv = sc[i];
                for (int t = 0; t < NU; ++t) vv += sB[i * NU + t] * sd[t];
                v_out[(ks * NX + i) * Bs + b] = vv;
            }
            if (PDP) {
                scalar fv = sFc[i];
                for (int t = 0; t < NU; ++t) fv += sFB[i * NU + t] * sd[t];
                fn[i] = fv + f[i];
            }
        }
        for (int e = tid; e < NU * NX; e += nt) {
            K_out[(ks * R::K + e) * Bs + b] = sK[e];
            if (PDP) Gp_out[(ks * NU * NX + e) * Bs + b] = sGp[e];
        }
        for (int i = tid; i < NU; i += nt)
            d_out[(ks * R::DV + i) * Bs + b] = sd[i];
        __syncthreads();
        PROF_MARK(7);

        scalar* t0 = P; P = Pn; Pn = t0;
        scalar* t1 = p; p = pn; pn = t1;
        if (PDP) {
            scalar* t2 = F; F = Fn; Fn = t2;
            scalar* t3 = C; C = Cn; Cn = t3;
            scalar* t4 = f; f = fn; fn = t4;
        }
    }
    PROF_DONE
    if (PDP) {      // the carry after the segment's first stage
        for (int i = tid; i < NX * NX; i += nt) {
            P0_out[(cs * NX * NX + i) * Bs + b] = P[i];
            F0_out[(cs * NX * NX + i) * Bs + b] = F[i];
            C0_out[(cs * NX * NX + i) * Bs + b] = C[i];
        }
        for (int i = tid; i < NX; i += nt) {
            p0_out[(cs * NX + i) * Bs + b] = p[i];
            f0_out[(cs * NX + i) * Bs + b] = f[i];
        }
    }
}

struct BackwardArgs {
    int N, Bt, S, threads;
    cudaStream_t stream;
    const scalar *A, *B, *c, *H, *h, *D, *rho, *rg, *PN, *pN;
    scalar *K, *d, *M, *v, *P, *L;
    const scalar *Fi, *Ci, *fi;
    scalar *Gp, *F, *P0, *p0, *F0, *C0, *f0;
};

template <bool EMIT_MV, bool EXPORT, bool PDP, bool PACKED>
int launch_backward(const BackwardArgs& a)
{
    const size_t words = PDP ? K9_WORDS : K1_WORDS;
    const size_t smem = (words * sizeof(scalar) + 15) / 16 * 16;
    auto kernel = backward_kernel<EMIT_MV, EXPORT, PDP, PACKED>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    kernel<<<a.S * a.Bt, a.threads, smem, a.stream>>>(
        a.N, a.Bt, a.S, a.A, a.B, a.c, a.H, a.h, a.D, a.rho, a.rg, a.PN,
        a.pN, a.K, a.d, a.M, a.v, a.P, a.L, a.Fi, a.Ci, a.fi, a.Gp, a.F,
        a.P0, a.p0, a.F0, a.C0, a.f0);
    return (int)cudaGetLastError();
}

#else  // !NC
// ------------------------------------------- K2 / K3, per-instance mode
// One matrix set per scenario (every tensor has trailing size Bt).  K2
// (and K10) give a scenario one thread: the carry and the stage
// temporaries live in registers, and every stream, matrices included, is
// batch-last, so a warp reads and writes whole lines.  PC_MODE: the P
// argument holds the pre-folded Pc = P_{k+1} c_k.  These are kernels of
// their own, not the shared-model ones below with another stride: there a
// block stages ONE matrix set per stage in shared memory for all its
// scenarios, and 32 sets a stage would not fit.  K3 stages the sets of 8
// scenarios a block (see there).

constexpr int PI_THREADS = 64;               // scenarios per block

template <bool PC_MODE>
__global__ void backward_vectors_kernel(
    int N, int Bt,
    const scalar* __restrict__ A, const scalar* __restrict__ B,
    const scalar* __restrict__ c, const scalar* __restrict__ hf,
    const scalar* __restrict__ P, const scalar* __restrict__ K,
    const scalar* __restrict__ L, const scalar* __restrict__ pN,
    scalar* __restrict__ d_out, scalar* __restrict__ v_out)
{
    const size_t b = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= (size_t)Bt) return;
    const size_t Bs = (size_t)Bt;
    const size_t mb = Bs;                  // matrix trailing size
    const size_t mo = b;                   // this thread's matrix lane

    scalar p[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) p[i] = pN[i * Bs + b];

    for (int k = N - 1; k >= 0; --k) {
        const size_t ks = (size_t)k;
        const scalar* Ak = A + ks * NX * NX * mb + mo;
        const scalar* Bk = B + ks * NX * NU * mb + mo;
        const scalar* Kk = K + ks * NU * NX * mb + mo;
        const scalar* Lk = L + ks * NU * NU * mb + mo;

        scalar cv[NX], Pcp[NX], rbar[NU], hx[NX], dv[NU], inv[NU];
#pragma unroll
        for (int i = 0; i < NX; ++i) cv[i] = c[(ks * NX + i) * Bs + b];
#pragma unroll
        for (int i = 0; i < NU; ++i) rbar[i] = hf[(ks * NZ + i) * Bs + b];
#pragma unroll
        for (int i = 0; i < NX; ++i) hx[i] = hf[(ks * NZ + NU + i) * Bs + b];

        if (PC_MODE) {
#pragma unroll
            for (int i = 0; i < NX; ++i)
                Pcp[i] = P[(ks * NX + i) * Bs + b] + p[i];
        } else {
            const scalar* Pk = P + ks * NX * NX * mb + mo;
#pragma unroll
            for (int i = 0; i < NX; ++i) {
                scalar acc = __ldg(Pk + (i * NX) * mb) * cv[0];
#pragma unroll
                for (int t = 1; t < NX; ++t)
                    acc += __ldg(Pk + (i * NX + t) * mb) * cv[t];
                Pcp[i] = acc + p[i];
            }
        }

        // rbar = hf_u + B^T Pcp
#pragma unroll
        for (int t = 0; t < NX; ++t) {
#pragma unroll
            for (int i = 0; i < NU; ++i)
                rbar[i] += __ldg(Bk + (t * NU + i) * mb) * Pcp[t];
        }

        // d = -(L L^T)^{-1} rbar
#pragma unroll
        for (int i = 0; i < NU; ++i)
            inv[i] = (scalar)1 / __ldg(Lk + (i * NU + i) * mb);
#pragma unroll
        for (int i = 0; i < NU; ++i) {
            scalar acc = rbar[i];
#pragma unroll
            for (int t = 0; t < i; ++t)
                acc -= __ldg(Lk + (i * NU + t) * mb) * dv[t];
            dv[i] = acc * inv[i];
        }
#pragma unroll
        for (int i = NU - 1; i >= 0; --i) {
            scalar acc = dv[i];
#pragma unroll
            for (int t = i + 1; t < NU; ++t)
                acc -= __ldg(Lk + (t * NU + i) * mb) * dv[t];
            dv[i] = acc * inv[i];
        }
#pragma unroll
        for (int i = 0; i < NU; ++i) {
            dv[i] = -dv[i];
            d_out[(ks * NU + i) * Bs + b] = dv[i];
        }

        // v = B d + c
#pragma unroll
        for (int i = 0; i < NX; ++i) {
            scalar acc = cv[i];
#pragma unroll
            for (int t = 0; t < NU; ++t)
                acc += __ldg(Bk + (i * NU + t) * mb) * dv[t];
            v_out[(ks * NX + i) * Bs + b] = acc;
        }

        // p = hf_x + A^T Pcp + K^T rbar
#pragma unroll
        for (int t = 0; t < NX; ++t) {
#pragma unroll
            for (int i = 0; i < NX; ++i)
                hx[i] += __ldg(Ak + (t * NX + i) * mb) * Pcp[t];
        }
#pragma unroll
        for (int t = 0; t < NU; ++t) {
#pragma unroll
            for (int i = 0; i < NX; ++i)
                hx[i] += __ldg(Kk + (t * NX + i) * mb) * rbar[t];
        }
#pragma unroll
        for (int i = 0; i < NX; ++i) p[i] = hx[i];
    }
}

// ---- K10, the cached-factor vector sweep of the segment reduction (K9's
// export_factors outputs P_{k+1}, K, chol(Huu), F_{k+1} per stage): K2's
// per-instance recursion with the segment offset f = F v + f carried
// beside p.  One thread per (segment, scenario), the carries in registers,
// every stream batch-last as in K2; the blocks of segment s cover its
// scenarios.  p starts at the segment's pi (zero but on the last), f at 0;
// after the segment's first stage the thread writes (p0, f0).
__global__ void backward_pdp_vectors_kernel(
    int N, int Bt, int S,
    const scalar* __restrict__ A, const scalar* __restrict__ B,
    const scalar* __restrict__ c, const scalar* __restrict__ hf,
    const scalar* __restrict__ P, const scalar* __restrict__ K,
    const scalar* __restrict__ L, const scalar* __restrict__ F,
    const scalar* __restrict__ pi,
    scalar* __restrict__ d_out, scalar* __restrict__ v_out,
    scalar* __restrict__ p0, scalar* __restrict__ f0)
{
    const unsigned bps = (Bt + PI_THREADS - 1) / PI_THREADS;   // blocks a segment
    const size_t seg = blockIdx.x / bps;
    const size_t b = (size_t)(blockIdx.x % bps) * blockDim.x + threadIdx.x;
    if (b >= (size_t)Bt) return;
    const size_t Bs = (size_t)Bt;
    const int Nl = N / S;
    const size_t s0 = seg * (size_t)Nl;         // the segment's first stage
    A += s0 * NX * NX * Bs;
    B += s0 * NX * NU * Bs;
    c += s0 * NX * Bs;
    hf += s0 * NZ * Bs;
    P += s0 * NX * NX * Bs;
    K += s0 * NU * NX * Bs;
    L += s0 * NU * NU * Bs;
    F += s0 * NX * NX * Bs;
    d_out += s0 * NU * Bs;
    v_out += s0 * NX * Bs;

    scalar p[NX], f[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
        p[i] = pi[(seg * NX + i) * Bs + b];
        f[i] = (scalar)0;
    }

    for (int k = Nl - 1; k >= 0; --k) {
        const size_t ks = (size_t)k;
        const scalar* Ak = A + ks * NX * NX * Bs + b;
        const scalar* Bk = B + ks * NX * NU * Bs + b;
        const scalar* Kk = K + ks * NU * NX * Bs + b;
        const scalar* Lk = L + ks * NU * NU * Bs + b;
        const scalar* Pk = P + ks * NX * NX * Bs + b;
        const scalar* Fk = F + ks * NX * NX * Bs + b;

        scalar cv[NX], Pcp[NX], rbar[NU], dv[NU], inv[NU], vv[NX];
#pragma unroll
        for (int i = 0; i < NX; ++i) cv[i] = c[(ks * NX + i) * Bs + b];
#pragma unroll
        for (int i = 0; i < NU; ++i) rbar[i] = hf[(ks * NZ + i) * Bs + b];

        // Pcp = P c + p
#pragma unroll
        for (int i = 0; i < NX; ++i) {
            scalar acc = __ldg(Pk + (i * NX) * Bs) * cv[0];
#pragma unroll
            for (int t = 1; t < NX; ++t) acc += __ldg(Pk + (i * NX + t) * Bs) * cv[t];
            Pcp[i] = acc + p[i];
        }
        // rbar = hf_u + B^T Pcp ; d = -(L L^T)^{-1} rbar
#pragma unroll
        for (int t = 0; t < NX; ++t) {
#pragma unroll
            for (int i = 0; i < NU; ++i)
                rbar[i] += __ldg(Bk + (t * NU + i) * Bs) * Pcp[t];
        }
#pragma unroll
        for (int i = 0; i < NU; ++i) inv[i] = (scalar)1 / __ldg(Lk + (i * NU + i) * Bs);
#pragma unroll
        for (int i = 0; i < NU; ++i) {
            scalar acc = rbar[i];
#pragma unroll
            for (int t = 0; t < i; ++t) acc -= __ldg(Lk + (i * NU + t) * Bs) * dv[t];
            dv[i] = acc * inv[i];
        }
#pragma unroll
        for (int i = NU - 1; i >= 0; --i) {
            scalar acc = dv[i];
#pragma unroll
            for (int t = i + 1; t < NU; ++t) acc -= __ldg(Lk + (t * NU + i) * Bs) * dv[t];
            dv[i] = acc * inv[i];
        }
#pragma unroll
        for (int i = 0; i < NU; ++i) {
            dv[i] = -dv[i];
            d_out[(ks * NU + i) * Bs + b] = dv[i];
        }
        // v = B d + c
#pragma unroll
        for (int i = 0; i < NX; ++i) {
            scalar acc = cv[i];
#pragma unroll
            for (int t = 0; t < NU; ++t) acc += __ldg(Bk + (i * NU + t) * Bs) * dv[t];
            vv[i] = acc;
            v_out[(ks * NX + i) * Bs + b] = acc;
        }
        // p = hf_x + A^T Pcp + K^T rbar (into cv, no longer read)
#pragma unroll
        for (int i = 0; i < NX; ++i) cv[i] = hf[(ks * NZ + NU + i) * Bs + b];
#pragma unroll
        for (int t = 0; t < NX; ++t) {
#pragma unroll
            for (int i = 0; i < NX; ++i) cv[i] += __ldg(Ak + (t * NX + i) * Bs) * Pcp[t];
        }
#pragma unroll
        for (int t = 0; t < NU; ++t) {
#pragma unroll
            for (int i = 0; i < NX; ++i) cv[i] += __ldg(Kk + (t * NX + i) * Bs) * rbar[t];
        }
#pragma unroll
        for (int i = 0; i < NX; ++i) p[i] = cv[i];
        // f = F v + f
#pragma unroll
        for (int i = 0; i < NX; ++i) {
            scalar acc = f[i];
#pragma unroll
            for (int t = 0; t < NX; ++t) acc += __ldg(Fk + (i * NX + t) * Bs) * vv[t];
            f[i] = acc;
        }
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
        p0[(seg * NX + i) * Bs + b] = p[i];
        f0[(seg * NX + i) * Bs + b] = f[i];
    }
}

// ---- K3, per instance.  Segment form: the blocks of segment s roll its
// N/S stages out from x0[s] and write their own end state to xN[s] (the
// segment's boundary state comes from the condensed solve).  S = 1 is the
// whole horizon.  The streams are shifted to the segment's first stage
// before the loop, so the loop is the one-segment rollout's.
//
// What bounds it on this card is bytes: 208 words a scenario and stage
// in (M, K, v, d; quadrotor widths), 16 out.  A thread a scenario that
// loads its own stage with __ldg waits out device-memory latency several
// times a stage (its registers cannot hold the stage), and a batch of
// 1,024 is 16 blocks on 16 SMs.  Here a scenario has K3I_G threads, each
// owning every K3I_G-th row of x+ and of u, and a block serves K3I_WS
// consecutive scenarios: B=1024 is 128 blocks a segment.  The block copies
// each stage's M, K, v, d of its scenarios with cp.async into a ring of
// K3I_SLOTS shared-memory slots, K3I_PF stages ahead of use (16-byte
// copies where the batch and the pointers allow, whole sectors either
// way), so the per-stage chain holds only shared-memory reads, FMAs and
// one barrier, for the exchange of x.  A slot holds each entry as a row of
// the K3I_WS scenarios, scenario index fastest, and the rows of M and K
// padded to an odd length: the four threads of a scenario read rows g,
// g+4, ... on distinct banks.  A scenario past the batch reads the last
// one's data and stores nothing.
constexpr int K3I_G = 4;                      // threads a scenario
constexpr int K3I_WS = 8;                     // scenarios a block
constexpr int K3I_THREADS = K3I_G * K3I_WS;
constexpr int K3I_RX = (NX + K3I_G - 1) / K3I_G;   // x+ rows a thread
constexpr int K3I_RU = (NU + K3I_G - 1) / K3I_G;   // u rows a thread
constexpr int K3I_PF = 4;                     // stages in flight
constexpr int K3I_SLOTS = K3I_PF + 1;
constexpr int K3I_MP = NX | 1;                // a slot's row of M or K
// Slot (entries; each entry a row of K3I_WS words): M, K, v, d.
constexpr int K3I_M = 0;
constexpr int K3I_K = K3I_M + NX * K3I_MP;
constexpr int K3I_V = K3I_K + NU * K3I_MP;
constexpr int K3I_D = K3I_V + NX;
constexpr int K3I_SLOT = (K3I_D + NU) * K3I_WS;           // words
constexpr int K3I_SMEM_WORDS = K3I_SLOTS * K3I_SLOT + 2 * NX * K3I_WS;

// n entries of a stage block (entry e of scenario b at src[e*Bt + b]),
// source rows of C entries padded to CP in the slot, for the block's
// scenarios b0.. : 16-byte copies when `vec` (the block's scenarios lie
// whole and aligned in every row), else one word a copy.
template <int C, int CP>
__device__ __forceinline__ void k3_stage(scalar* dst, const scalar* src,
                                         int n, size_t Bt, size_t b0,
                                         bool vec, int tid)
{
    if (vec) {
        constexpr int CH = 16 / (int)sizeof(scalar);      // words a copy
        constexpr int NCH = K3I_WS / CH;
#pragma unroll 1
        for (int q = tid; q < n * NCH; q += K3I_THREADS) {
            const int e = q / NCH, hh = q % NCH;
            const int de = (e / C) * CP + e % C;
            __pipeline_memcpy_async(dst + de * K3I_WS + hh * CH,
                                    src + e * Bt + b0 + hh * CH, 16);
        }
    } else {
#pragma unroll 1
        for (int q = tid; q < n * K3I_WS; q += K3I_THREADS) {
            const int e = q / K3I_WS, j = q % K3I_WS;
            const size_t b = b0 + j < Bt ? b0 + j : Bt - 1;
            const int de = (e / C) * CP + e % C;
            copy_word(dst + de * K3I_WS + j, src + e * Bt + b);
        }
    }
}

__global__ void __launch_bounds__(K3I_THREADS)
forward_kernel(
    int N, int Bt, int S,
    const scalar* __restrict__ M, const scalar* __restrict__ v,
    const scalar* __restrict__ K, const scalar* __restrict__ d,
    const scalar* __restrict__ x0,
    scalar* __restrict__ ws, scalar* __restrict__ xN)
{
    extern __shared__ double smem_aligned[];
    scalar* ring = reinterpret_cast<scalar*>(smem_aligned);
    scalar* xs = ring + K3I_SLOTS * K3I_SLOT;               // x exchange, x2
    const int tid = threadIdx.x;
    const int j = tid % K3I_WS;                  // scenario in the block
    const int g = tid / K3I_WS;                  // thread of the scenario
    const unsigned bps = (Bt + K3I_WS - 1) / K3I_WS;        // blocks a segment
    const size_t seg = blockIdx.x / bps;
    const size_t Bs = (size_t)Bt;
    const size_t b0 = (size_t)(blockIdx.x % bps) * K3I_WS;
    const size_t b = b0 + j;
    const bool valid = b < Bs;
    const int Nl = N / S;
    const size_t s0 = seg * (size_t)Nl;         // the segment's first stage
    M += s0 * NX * NX * Bs;
    K += s0 * NU * NX * Bs;
    v += s0 * NX * Bs;
    d += s0 * NU * Bs;
    ws += s0 * NZ * Bs;
    x0 += seg * NX * Bs;
    xN += seg * NX * Bs;
    constexpr size_t CH = 16 / sizeof(scalar);
    const bool vec = Bs % CH == 0 && b0 + K3I_WS <= Bs
        && (((size_t)M | (size_t)K | (size_t)v | (size_t)d) & 15) == 0;

    auto prefetch = [&](int k) {
        if (k < Nl) {
            const size_t ks = (size_t)k;
            scalar* sl = ring + (k % K3I_SLOTS) * K3I_SLOT;
            k3_stage<NX, K3I_MP>(sl + K3I_M * K3I_WS, M + ks * NX * NX * Bs,
                                 NX * NX, Bs, b0, vec, tid);
            k3_stage<NX, K3I_MP>(sl + K3I_K * K3I_WS, K + ks * NU * NX * Bs,
                                 NU * NX, Bs, b0, vec, tid);
            k3_stage<NX, NX>(sl + K3I_V * K3I_WS, v + ks * NX * Bs, NX, Bs,
                             b0, vec, tid);
            k3_stage<NU, NU>(sl + K3I_D * K3I_WS, d + ks * NU * Bs, NU, Bs,
                             b0, vec, tid);
        }
        __pipeline_commit();
    };

    const size_t bc = valid ? b : Bs - 1;
#pragma unroll
    for (int r = 0; r < K3I_RX; ++r) {
        const int i = g + K3I_G * r;
        if (i < NX) xs[i * K3I_WS + j] = x0[i * Bs + bc];
    }
    for (int k = 0; k < K3I_PF; ++k) prefetch(k);

    for (int k = 0; k < Nl; ++k) {
        const size_t ks = (size_t)k;
        __pipeline_wait_prior(K3I_PF - 1);       // stage k landed (my copies)
        __syncthreads();                         // ... everyone's, and x_k
        prefetch(k + K3I_PF);                    // into the slot of stage k-1
        const scalar* sl = ring + (k % K3I_SLOTS) * K3I_SLOT;
        const scalar* xin = xs + (k & 1) * NX * K3I_WS;
        scalar* xout = xs + ((k + 1) & 1) * NX * K3I_WS;
        scalar x[NX];
#pragma unroll
        for (int t = 0; t < NX; ++t) x[t] = xin[t * K3I_WS + j];
#pragma unroll
        for (int r = 0; r < K3I_RU; ++r) {
            const int i = g + K3I_G * r;
            if (i < NU) {
                scalar acc = sl[(K3I_D + i) * K3I_WS + j];
#pragma unroll
                for (int t = 0; t < NX; ++t)
                    acc += sl[(K3I_K + i * K3I_MP + t) * K3I_WS + j] * x[t];
                if (valid) ws[(ks * NZ + i) * Bs + b] = acc;
            }
        }
#pragma unroll
        for (int r = 0; r < K3I_RX; ++r) {
            const int i = g + K3I_G * r;
            if (i < NX) {
                if (valid) ws[(ks * NZ + NU + i) * Bs + b] = x[i];
                scalar acc = sl[(K3I_V + i) * K3I_WS + j];
#pragma unroll
                for (int t = 0; t < NX; ++t)
                    acc += sl[(K3I_M + i * K3I_MP + t) * K3I_WS + j] * x[t];
                xout[i * K3I_WS + j] = acc;
            }
        }
    }
    __pipeline_wait_prior(0);
    __syncthreads();
    const scalar* xfin = xs + (Nl & 1) * NX * K3I_WS;
#pragma unroll
    for (int r = 0; r < K3I_RX; ++r) {
        const int i = g + K3I_G * r;
        if (i < NX && valid) xN[i * Bs + b] = xfin[i * K3I_WS + j];
    }
}

// --------------------------------------------- K2 / K3, shared-model mode
// One model, Bt scenarios: the matrices carry trailing size 1.  What
// bounds both kernels on this card is bytes (the per-scenario streams),
// but what a plain one-thread-per-scenario loop runs into first is
// latency: a serving batch of a few thousand scenarios is a few thousand
// threads, one warp per SM, and every stage waits for its own loads.
// The design here:
//   * a block serves 32 scenarios with 4 threads each (4 warps): a thread
//     owns a quarter of the rows of the per-scenario state, so the dot
//     products of a stage are split four ways and exchanged through
//     shared memory, one block-wide barrier per stage;
//   * every stage's inputs — the shared matrices and the 32 scenarios'
//     vectors — are copied asynchronously (cp.async) into a ring of
//     shared-memory slots VS_PF stages ahead of their use, so device
//     memory latency is off the per-stage chain.  A copy is one word:
//     the matrix words are dealt over the block's threads, and a thread
//     copies its own scenario's entry of every VS_GROUPS-th vector row;
//   * the matrices lie in the slot so that each thread's reads are
//     contiguous rows at one address per warp (a broadcast).

// ---- K2.  The wrapper packs each stage's matrices into one run, laid out
// for the reads below: A^T [i][t], B^T [j][t], B [i][t], K^T [i][t],
// L [i][t], then (plain-P mode) P [i][j].
constexpr int K2_AT = 0;
constexpr int K2_BT = K2_AT + NX * NX;
constexpr int K2_B = K2_BT + NU * NX;
constexpr int K2_KT = K2_B + NX * NU;
constexpr int K2_L = K2_KT + NX * NU;
constexpr int K2_P = K2_L + NU * NU;
template <bool PC_MODE> struct K2Layout {
    static constexpr int PACK = K2_P + (PC_MODE ? 0 : NX * NX);
    // Per-scenario rows after the pack: c, hf, then (Pc mode) Pc.
    static constexpr int VEC_ROWS = NX + NZ + (PC_MODE ? NX : 0);
    static constexpr int SLOT_WORDS = PACK + VEC_ROWS * VS_LANES;
    static constexpr int SMEM_WORDS =
        VS_SLOTS * SLOT_WORDS + 2 * NX * VS_LANES;
};

template <bool PC_MODE>
__global__ void __launch_bounds__(VS_THREADS)
backward_vectors_shared_kernel(
    int N, int Bt,
    const scalar* __restrict__ pack, const scalar* __restrict__ c,
    const scalar* __restrict__ hf, const scalar* __restrict__ Pc,
    const scalar* __restrict__ pN,
    scalar* __restrict__ d_out, scalar* __restrict__ v_out)
{
    using Lay = K2Layout<PC_MODE>;
    extern __shared__ double smem_aligned[];
    scalar* ring = reinterpret_cast<scalar*>(smem_aligned);
    scalar* xs = ring + VS_SLOTS * Lay::SLOT_WORDS;          // Pcp exchange, x2

    const int tid = threadIdx.x;
    const int lane = tid % VS_LANES;
    const int grp = tid / VS_LANES;
    const size_t Bs = (size_t)Bt;
    const size_t b0 = (size_t)blockIdx.x * VS_LANES;
    const size_t b = b0 + lane;
    const bool valid = b < Bs;

    // Stage n of the sweep is model stage k = N-1-n.  One copy group per
    // call (empty past the end), so groups and stages stay in step.
    auto prefetch = [&](int n) {
        if (n < N) {
            const size_t ks = (size_t)(N - 1 - n);
            scalar* S = ring + (n % VS_SLOTS) * Lay::SLOT_WORDS;
            scalar* V = S + Lay::PACK;
            copy_matrix(S, pack + ks * Lay::PACK, Lay::PACK);
            if (valid) {
                copy_rows<NX>(V, c + ks * NX * Bs + b, Bs, lane, grp);
                copy_rows<NZ>(V + NX * VS_LANES, hf + ks * NZ * Bs + b, Bs,
                              lane, grp);
                if (PC_MODE)
                    copy_rows<NX>(V + (NX + NZ) * VS_LANES,
                                  Pc + ks * NX * Bs + b, Bs, lane, grp);
            }
        }
        __pipeline_commit();
    };

    // Pcp rows this thread owns, for the stage held in slot S.
    scalar p[VS_RX];
    auto put_Pcp = [&](const scalar* S, scalar* dst) {
        const scalar* cv = S + Lay::PACK;
#pragma unroll
        for (int r = 0; r < VS_RX; ++r) {
            const int i = grp * VS_RX + r;
            if (i < NX) {
                scalar acc;
                if (PC_MODE) {
                    acc = cv[(NX + NZ + i) * VS_LANES + lane];
                } else {
                    acc = (scalar)0;
#pragma unroll
                    for (int t = 0; t < NX; ++t)
                        acc += S[K2_P + i * NX + t] * cv[t * VS_LANES + lane];
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
    PROF_INIT

    for (int n = 0; n < N; ++n) {
        const size_t ks = (size_t)(N - 1 - n);
        const scalar* S = ring + (n % VS_SLOTS) * Lay::SLOT_WORDS;
        const scalar* cv = S + Lay::PACK;
        const scalar* hv = cv + NX * VS_LANES;
        // Stage n+1 has landed too (it is read at the end of this stage),
        // and the barrier publishes it and this stage's Pcp.
        __pipeline_wait_prior(VS_PF - 2);
        PROF_MARK(0);
        __syncthreads();
        PROF_MARK(1);

        scalar Pcp[NX], rbar[NU], dv[NU], inv[NU];
        const scalar* xin = xs + (n & 1) * NX * VS_LANES;
#pragma unroll
        for (int t = 0; t < NX; ++t) Pcp[t] = xin[t * VS_LANES + lane];

        // rbar = hf_u + B^T Pcp ; d = -(L L^T)^{-1} rbar (every thread: the
        // whole of both is needed by each of the four).
#pragma unroll
        for (int j = 0; j < NU; ++j) {
            scalar acc = hv[j * VS_LANES + lane];
#pragma unroll
            for (int t = 0; t < NX; ++t) acc += S[K2_BT + j * NX + t] * Pcp[t];
            rbar[j] = acc;
        }
#pragma unroll
        for (int i = 0; i < NU; ++i) inv[i] = (scalar)1 / S[K2_L + i * NU + i];
#pragma unroll
        for (int i = 0; i < NU; ++i) {
            scalar acc = rbar[i];
#pragma unroll
            for (int t = 0; t < i; ++t) acc -= S[K2_L + i * NU + t] * dv[t];
            dv[i] = acc * inv[i];
        }
#pragma unroll
        for (int i = NU - 1; i >= 0; --i) {
            scalar acc = dv[i];
#pragma unroll
            for (int t = i + 1; t < NU; ++t) acc -= S[K2_L + t * NU + i] * dv[t];
            dv[i] = acc * inv[i];
        }
#pragma unroll
        for (int i = 0; i < NU; ++i) dv[i] = -dv[i];

#pragma unroll
        for (int j = 0; j < NU; ++j)     // each input row stored by one group
            if (j / VS_RU == grp && valid) d_out[(ks * NU + j) * Bs + b] = dv[j];
        PROF_MARK(2);
        // Own rows: v = B d + c ; p = hf_x + A^T Pcp + K^T rbar.
#pragma unroll
        for (int r = 0; r < VS_RX; ++r) {
            const int i = grp * VS_RX + r;
            if (i < NX) {
                scalar vv = cv[i * VS_LANES + lane];
#pragma unroll
                for (int t = 0; t < NU; ++t) vv += S[K2_B + i * NU + t] * dv[t];
                if (valid) v_out[(ks * NX + i) * Bs + b] = vv;
                scalar acc = hv[(NU + i) * VS_LANES + lane];
#pragma unroll
                for (int t = 0; t < NX; ++t) acc += S[K2_AT + i * NX + t] * Pcp[t];
#pragma unroll
                for (int t = 0; t < NU; ++t) acc += S[K2_KT + i * NU + t] * rbar[t];
                p[r] = acc;
            }
        }
        PROF_MARK(3);
        if (n + 1 < N)
            put_Pcp(ring + ((n + 1) % VS_SLOTS) * Lay::SLOT_WORDS,
                    xs + ((n + 1) & 1) * NX * VS_LANES);
        PROF_MARK(4);
        prefetch(n + VS_PF);
        PROF_MARK(5);
    }
    __pipeline_wait_prior(0);
    PROF_DONE
}

// ---- K3 slot layout (words): [K; M] row-major, then d and v rows.
constexpr int K3_KM = 0;
constexpr int K3_VEC = NZ * NX;
constexpr int K3_SLOT_WORDS = K3_VEC + NZ * VS_LANES;
constexpr int K3_SMEM_WORDS =
    VS_SLOTS * K3_SLOT_WORDS + 2 * NX * VS_LANES;

__global__ void __launch_bounds__(VS_THREADS)
forward_shared_kernel(
    int N, int Bt,
    const scalar* __restrict__ M, const scalar* __restrict__ v,
    const scalar* __restrict__ K, const scalar* __restrict__ d,
    const scalar* __restrict__ x0,
    scalar* __restrict__ ws, scalar* __restrict__ xN)
{
    extern __shared__ double smem_aligned[];
    scalar* ring = reinterpret_cast<scalar*>(smem_aligned);
    scalar* xs = ring + VS_SLOTS * K3_SLOT_WORDS;           // x exchange, x2

    const int tid = threadIdx.x;
    const int lane = tid % VS_LANES;
    const int grp = tid / VS_LANES;
    const size_t Bs = (size_t)Bt;
    const size_t b0 = (size_t)blockIdx.x * VS_LANES;
    const size_t b = b0 + lane;
    const bool valid = b < Bs;

    auto prefetch = [&](int k) {
        if (k < N) {
            const size_t ks = (size_t)k;
            scalar* S = ring + (k % VS_SLOTS) * K3_SLOT_WORDS;
            copy_matrix(S, K + ks * NU * NX, NU * NX);
            copy_matrix(S + NU * NX, M + ks * NX * NX, NX * NX);
            if (valid) {
                copy_rows<NU>(S + K3_VEC, d + ks * NU * Bs + b, Bs, lane, grp);
                copy_rows<NX>(S + K3_VEC + NU * VS_LANES,
                              v + ks * NX * Bs + b, Bs, lane, grp);
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
    PROF_INIT

    for (int k = 0; k < N; ++k) {
        const size_t ks = (size_t)k;
        const scalar* S = ring + (k % VS_SLOTS) * K3_SLOT_WORDS;
        const scalar* dvec = S + K3_VEC;
        const scalar* vvec = dvec + NU * VS_LANES;
        __pipeline_wait_prior(VS_PF - 1);    // stage k landed (my copies)
        PROF_MARK(0);
        __syncthreads();                     // ... everyone's, and x_k
        PROF_MARK(1);

        scalar x[NX];
        const scalar* xin = xs + (k & 1) * NX * VS_LANES;
        scalar* xout = xs + ((k + 1) & 1) * NX * VS_LANES;
#pragma unroll
        for (int t = 0; t < NX; ++t) x[t] = xin[t * VS_LANES + lane];

#pragma unroll
        for (int r = 0; r < VS_RU; ++r) {
            const int j = grp * VS_RU + r;
            if (j < NU) {
                scalar acc = dvec[j * VS_LANES + lane];
#pragma unroll
                for (int t = 0; t < NX; ++t) acc += S[K3_KM + j * NX + t] * x[t];
                if (valid) ws[(ks * NZ + j) * Bs + b] = acc;
            }
        }
#pragma unroll
        for (int r = 0; r < VS_RX; ++r) {
            const int i = grp * VS_RX + r;
            if (i < NX) {
                if (valid)
                    ws[(ks * NZ + NU + i) * Bs + b] = xin[i * VS_LANES + lane];
                scalar acc = vvec[i * VS_LANES + lane];
#pragma unroll
                for (int t = 0; t < NX; ++t)
                    acc += S[K3_KM + (NU + i) * NX + t] * x[t];
                xout[i * VS_LANES + lane] = acc;
            }
        }
        PROF_MARK(2);
        prefetch(k + VS_PF);
        PROF_MARK(3);
    }
    PROF_DONE
    __pipeline_wait_prior(0);
    __syncthreads();
    const scalar* xfin = xs + (N & 1) * NX * VS_LANES;
#pragma unroll
    for (int r = 0; r < VS_RX; ++r) {
        const int i = grp * VS_RX + r;
        if (i < NX && valid) xN[i * Bs + b] = xfin[i * VS_LANES + lane];
    }
}

// ---- K7, per-instance rollout from the raw dynamics: u = K x + d,
// x+ = A x + B u + c, every matrix per scenario (trailing size Bt).  What
// bounds it is bytes: 272 words a scenario and stage in (A, B, c, K, d)
// and out (ws).  One thread a scenario leaves a batch of 4,096 at 128 warps
// for 132 SMs, each stage waiting on its own loads (the first K2/K3 measured
// so).  Here a block serves 32 scenarios with RO_GROUPS threads each (a
// warp is one group, so a warp's loads of one matrix entry are 32
// neighbouring words): a thread computes all of u itself (nu short dot
// products on K rows that the scenario's threads share through L1) and
// owns a slice of the rows of x+; x goes round through shared memory, one
// barrier a stage.  Each stage's loads are issued before that barrier, so
// they are in flight while the block waits on it.
//
// PACKED (K12): A, B, c are row blocks of one packed Sd = (A | B | c) and
// K, d of G = (K | d), K11's output; only the strides change (the entry
// point offsets the pointers).
constexpr int RO_GROUPS = 8;                 // threads per scenario
constexpr int RO_THREADS = VS_LANES * RO_GROUPS;
constexpr int RO_RX = (NX + RO_GROUPS - 1) / RO_GROUPS;   // x rows/thread
constexpr int RO_RU = (NU + RO_GROUPS - 1) / RO_GROUPS;   // u rows stored/thread

template <bool PACKED>
__global__ void __launch_bounds__(RO_THREADS)
forward_rollout_kernel(
    int N, int Bt,
    const scalar* __restrict__ A, const scalar* __restrict__ B,
    const scalar* __restrict__ c, const scalar* __restrict__ K,
    const scalar* __restrict__ d, const scalar* __restrict__ x0,
    scalar* __restrict__ ws, scalar* __restrict__ xN)
{
    extern __shared__ double smem_aligned[];
    scalar* xs = reinterpret_cast<scalar*>(smem_aligned);   // x exchange, x2

    const int tid = threadIdx.x;
    const int lane = tid % VS_LANES;
    const int grp = tid / VS_LANES;
    const size_t Bs = (size_t)Bt;
    const size_t b = (size_t)blockIdx.x * VS_LANES + lane;
    const bool valid = b < Bs;
    const size_t bb = valid ? b : 0;         // an idle lane reads scenario 0
    // Rows a stage takes in each stream.
    constexpr int RA = PACKED ? NX * (NX + NU + 1) : NX * NX;
    constexpr int RB = PACKED ? NX * (NX + NU + 1) : NX * NU;
    constexpr int RC = PACKED ? NX * (NX + NU + 1) : NX;
    constexpr int RK = PACKED ? NU * NX + NU : NU * NX;
    constexpr int RD = PACKED ? NU * NX + NU : NU;

#pragma unroll
    for (int r = 0; r < RO_RX; ++r) {
        const int i = grp * RO_RX + r;
        if (i < NX) xs[i * VS_LANES + lane] = x0[i * Bs + bb];
    }

    for (int k = 0; k < N; ++k) {
        const size_t ks = (size_t)k;
        scalar Kr[NU][NX], dr[NU], Ar[RO_RX][NX], Br[RO_RX][NU], cr[RO_RX];
#pragma unroll
        for (int j = 0; j < NU; ++j) {
            dr[j] = __ldg(d + (ks * RD + j) * Bs + bb);
#pragma unroll
            for (int t = 0; t < NX; ++t)
                Kr[j][t] = __ldg(K + (ks * RK + j * NX + t) * Bs + bb);
        }
#pragma unroll
        for (int r = 0; r < RO_RX; ++r) {
            const int i = grp * RO_RX + r < NX ? grp * RO_RX + r : NX - 1;
            cr[r] = __ldg(c + (ks * RC + i) * Bs + bb);
#pragma unroll
            for (int t = 0; t < NX; ++t)
                Ar[r][t] = __ldg(A + (ks * RA + i * NX + t) * Bs + bb);
#pragma unroll
            for (int t = 0; t < NU; ++t)
                Br[r][t] = __ldg(B + (ks * RB + i * NU + t) * Bs + bb);
        }
        __syncthreads();                     // x_k published

        const scalar* xin = xs + (k & 1) * NX * VS_LANES;
        scalar* xout = xs + ((k + 1) & 1) * NX * VS_LANES;
        scalar x[NX], u[NU];
#pragma unroll
        for (int t = 0; t < NX; ++t) x[t] = xin[t * VS_LANES + lane];
#pragma unroll
        for (int j = 0; j < NU; ++j) {
            scalar acc = dr[j];
#pragma unroll
            for (int t = 0; t < NX; ++t) acc += Kr[j][t] * x[t];
            u[j] = acc;
        }
#pragma unroll
        for (int r = 0; r < RO_RU; ++r) {
            const int j = grp * RO_RU + r;
            if (j < NU && valid) ws[(ks * NZ + j) * Bs + b] = u[j];
        }
#pragma unroll
        for (int r = 0; r < RO_RX; ++r) {
            const int i = grp * RO_RX + r;
            if (i < NX) {
                if (valid) ws[(ks * NZ + NU + i) * Bs + b] = x[i];
                scalar acc = cr[r];
#pragma unroll
                for (int t = 0; t < NX; ++t) acc += Ar[r][t] * x[t];
#pragma unroll
                for (int t = 0; t < NU; ++t) acc += Br[r][t] * u[t];
                xout[i * VS_LANES + lane] = acc;
            }
        }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RO_RX; ++r) {
        const int i = grp * RO_RX + r;
        if (i < NX && valid) xN[i * Bs + b] = xs[((N & 1) * NX + i) * VS_LANES + lane];
    }
}

#endif  // NC

}  // namespace

extern "C" {

#ifdef RICCATI_PROFILE
int riccati_read_prof(long long* out)
{
    return (int)cudaMemcpyFromSymbol(out, riccati_prof, sizeof(riccati_prof));
}
#endif

#ifdef NC
int riccati_backward(int N, int Bt, int emit_mv, int export_factors,
                     int threads, void* stream,
                     const void* A, const void* B, const void* c,
                     const void* H, const void* h, const void* D,
                     const void* rho, const void* rg, const void* PN,
                     const void* pN, void* K, void* d, void* M, void* v,
                     void* P, void* L)
{
    if (N <= 0 || Bt <= 0) return 0;
    BackwardArgs a{};
    a.N = N; a.Bt = Bt; a.S = 1; a.threads = threads;
    a.stream = (cudaStream_t)stream;
    a.A = (const scalar*)A; a.B = (const scalar*)B; a.c = (const scalar*)c;
    a.H = (const scalar*)H; a.h = (const scalar*)h; a.D = (const scalar*)D;
    a.rho = (const scalar*)rho; a.rg = (const scalar*)rg;
    a.PN = (const scalar*)PN; a.pN = (const scalar*)pN;
    a.K = (scalar*)K; a.d = (scalar*)d; a.M = (scalar*)M; a.v = (scalar*)v;
    a.P = (scalar*)P; a.L = (scalar*)L;
    if (emit_mv && export_factors) return launch_backward<true, true, false, false>(a);
    if (emit_mv) return launch_backward<true, false, false, false>(a);
    if (export_factors) return launch_backward<false, true, false, false>(a);
    return launch_backward<false, false, false, false>(a);
}

// K9: S segments of N/S stages, one block per (segment, instance).  The
// initial carries (Pi, pi, Fi, Ci, fi) and the boundary outputs (P0, p0,
// F0, C0, f0) are (S, nx[, nx], Bt); with export_factors also P, L, F per
// stage.
int riccati_backward_pdp(int N, int Bt, int S, int export_factors,
                         int threads, void* stream,
                         const void* A, const void* B, const void* c,
                         const void* H, const void* h, const void* D,
                         const void* rho, const void* rg, const void* Pi,
                         const void* pi, const void* Fi, const void* Ci,
                         const void* fi, void* K, void* d, void* M, void* v,
                         void* Gp, void* P, void* L, void* F, void* P0,
                         void* p0, void* F0, void* C0, void* f0)
{
    if (N <= 0 || Bt <= 0) return 0;
    if (S <= 0 || N % S != 0) return (int)cudaErrorInvalidValue;
    BackwardArgs a{};
    a.N = N; a.Bt = Bt; a.S = S; a.threads = threads;
    a.stream = (cudaStream_t)stream;
    a.A = (const scalar*)A; a.B = (const scalar*)B; a.c = (const scalar*)c;
    a.H = (const scalar*)H; a.h = (const scalar*)h; a.D = (const scalar*)D;
    a.rho = (const scalar*)rho; a.rg = (const scalar*)rg;
    a.PN = (const scalar*)Pi; a.pN = (const scalar*)pi;
    a.Fi = (const scalar*)Fi; a.Ci = (const scalar*)Ci; a.fi = (const scalar*)fi;
    a.K = (scalar*)K; a.d = (scalar*)d; a.M = (scalar*)M; a.v = (scalar*)v;
    a.Gp = (scalar*)Gp; a.P = (scalar*)P; a.L = (scalar*)L; a.F = (scalar*)F;
    a.P0 = (scalar*)P0; a.p0 = (scalar*)p0; a.F0 = (scalar*)F0;
    a.C0 = (scalar*)C0; a.f0 = (scalar*)f0;
    if (export_factors) return launch_backward<true, true, true, false>(a);
    return launch_backward<true, false, true, false>(a);
}

// K11: K1 for the gains only, on row-packed Sd (N, nx(nx+nu+1), Bt) and
// Sc (N, nz^2+nz+nc*nz+2nc, Bt); the gains go out as G (N, nu*nx+nu, Bt).
int riccati_backward_packed(int N, int Bt, int threads, void* stream,
                            const void* Sd, const void* Sc, const void* PN,
                            const void* pN, void* G)
{
    if (N <= 0 || Bt <= 0) return 0;
    const scalar* sd = (const scalar*)Sd;
    const scalar* sc = (const scalar*)Sc;
    const size_t Bs = (size_t)Bt;
    BackwardArgs a{};
    a.N = N; a.Bt = Bt; a.S = 1; a.threads = threads;
    a.stream = (cudaStream_t)stream;
    a.A = sd;
    a.B = sd + (size_t)(NX * NX) * Bs;
    a.c = sd + (size_t)(NX * NX + NX * NU) * Bs;
    a.H = sc;
    a.h = sc + (size_t)(NZ * NZ) * Bs;
    a.D = sc + (size_t)(NZ * NZ + NZ) * Bs;
    a.rho = sc + (size_t)(NZ * NZ + NZ + NC * NZ) * Bs;
    a.rg = sc + (size_t)(NZ * NZ + NZ + NC * NZ + NC) * Bs;
    a.PN = (const scalar*)PN; a.pN = (const scalar*)pN;
    a.K = (scalar*)G;
    a.d = (scalar*)G + (size_t)(NU * NX) * Bs;
    return launch_backward<false, false, false, true>(a);
}
#else  // !NC

// Per-instance mode: one matrix set per scenario.
int riccati_backward_vectors(int N, int Bt, int pc_mode, void* stream,
                             const void* A, const void* B, const void* c,
                             const void* hf, const void* P, const void* K,
                             const void* L, const void* pN, void* d, void* v)
{
    if (N <= 0 || Bt <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    const int blocks = (Bt + PI_THREADS - 1) / PI_THREADS;
#define RICCATI_BV_ARGS                                                      \
    N, Bt, (const scalar*)A, (const scalar*)B, (const scalar*)c,             \
        (const scalar*)hf, (const scalar*)P, (const scalar*)K,               \
        (const scalar*)L, (const scalar*)pN, (scalar*)d, (scalar*)v
    if (pc_mode)
        backward_vectors_kernel<true><<<blocks, PI_THREADS, 0, st>>>(RICCATI_BV_ARGS);
    else
        backward_vectors_kernel<false><<<blocks, PI_THREADS, 0, st>>>(RICCATI_BV_ARGS);
#undef RICCATI_BV_ARGS
    return (int)cudaGetLastError();
}

// Shared-model mode: `pack` holds each stage's matrices as one run (see
// the layout at K2); `Pc` is read in Pc mode only.
int riccati_backward_vectors_shared(int N, int Bt, int pc_mode, void* stream,
                                    const void* pack, const void* c,
                                    const void* hf, const void* Pc,
                                    const void* pN, void* d, void* v)
{
    if (N <= 0 || Bt <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    const int blocks = (Bt + VS_LANES - 1) / VS_LANES;
#define RICCATI_BV_ARGS                                                      \
    N, Bt, (const scalar*)pack, (const scalar*)c, (const scalar*)hf,   \
        (const scalar*)Pc, (const scalar*)pN, (scalar*)d, (scalar*)v
    if (pc_mode) {
        const size_t smem = K2Layout<true>::SMEM_WORDS * sizeof(scalar);
        int e = set_smem(backward_vectors_shared_kernel<true>, smem);
        if (e) return e;
        backward_vectors_shared_kernel<true><<<blocks, VS_THREADS, smem, st>>>(RICCATI_BV_ARGS);
    } else {
        const size_t smem = K2Layout<false>::SMEM_WORDS * sizeof(scalar);
        int e = set_smem(backward_vectors_shared_kernel<false>, smem);
        if (e) return e;
        backward_vectors_shared_kernel<false><<<blocks, VS_THREADS, smem, st>>>(RICCATI_BV_ARGS);
    }
#undef RICCATI_BV_ARGS
    return (int)cudaGetLastError();
}

// K3.  Shared mode runs the whole horizon (S = 1); per-instance mode takes
// S segments, x0 and xN (S, nx, Bt).
int riccati_forward(int N, int Bt, int shared, int S, void* stream,
                    const void* M, const void* v, const void* K,
                    const void* d, const void* x0, void* ws, void* xN)
{
    if (N <= 0 || Bt <= 0) return 0;
    if (S <= 0 || N % S != 0 || (shared && S != 1))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (shared) {
        const int blocks = (Bt + VS_LANES - 1) / VS_LANES;
        const size_t smem = K3_SMEM_WORDS * sizeof(scalar);
        int e = set_smem(forward_shared_kernel, smem);
        if (e) return e;
        forward_shared_kernel<<<blocks, VS_THREADS, smem, st>>>(
            N, Bt, (const scalar*)M, (const scalar*)v, (const scalar*)K,
            (const scalar*)d, (const scalar*)x0, (scalar*)ws, (scalar*)xN);
    } else {
        const int blocks = S * ((Bt + K3I_WS - 1) / K3I_WS);
        const size_t smem = K3I_SMEM_WORDS * sizeof(scalar);
        int e = set_smem(forward_kernel, smem);
        if (e) return e;
        forward_kernel<<<blocks, K3I_THREADS, smem, st>>>(
            N, Bt, S, (const scalar*)M, (const scalar*)v, (const scalar*)K,
            (const scalar*)d, (const scalar*)x0, (scalar*)ws, (scalar*)xN);
    }
    return (int)cudaGetLastError();
}

// K10: S segments; pi, p0 and f0 are (S, nx, Bt).
int riccati_backward_pdp_vectors(int N, int Bt, int S, void* stream,
                                 const void* A, const void* B, const void* c,
                                 const void* hf, const void* P, const void* K,
                                 const void* L, const void* F, const void* pi,
                                 void* d, void* v, void* p0, void* f0)
{
    if (N <= 0 || Bt <= 0) return 0;
    if (S <= 0 || N % S != 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int blocks = S * ((Bt + PI_THREADS - 1) / PI_THREADS);
    backward_pdp_vectors_kernel<<<blocks, PI_THREADS, 0, st>>>(
        N, Bt, S, (const scalar*)A, (const scalar*)B, (const scalar*)c,
        (const scalar*)hf, (const scalar*)P, (const scalar*)K,
        (const scalar*)L, (const scalar*)F, (const scalar*)pi, (scalar*)d,
        (scalar*)v, (scalar*)p0, (scalar*)f0);
    return (int)cudaGetLastError();
}

int riccati_forward_rollout(int N, int Bt, void* stream,
                            const void* A, const void* B, const void* c,
                            const void* K, const void* d, const void* x0,
                            void* ws, void* xN)
{
    if (N <= 0 || Bt <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    const int blocks = (Bt + VS_LANES - 1) / VS_LANES;
    const size_t smem = 2 * NX * VS_LANES * sizeof(scalar);
    forward_rollout_kernel<false><<<blocks, RO_THREADS, smem, st>>>(
        N, Bt, (const scalar*)A, (const scalar*)B, (const scalar*)c,
        (const scalar*)K, (const scalar*)d, (const scalar*)x0, (scalar*)ws,
        (scalar*)xN);
    return (int)cudaGetLastError();
}

// K12: K7 on row-packed Sd (N, nx(nx+nu+1), Bt) and G (N, nu*nx+nu, Bt).
int riccati_forward_packed(int N, int Bt, void* stream, const void* Sd,
                           const void* G, const void* x0, void* ws, void* xN)
{
    if (N <= 0 || Bt <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    const scalar* sd = (const scalar*)Sd;
    const scalar* g = (const scalar*)G;
    const size_t Bs = (size_t)Bt;
    const int blocks = (Bt + VS_LANES - 1) / VS_LANES;
    const size_t smem = 2 * NX * VS_LANES * sizeof(scalar);
    forward_rollout_kernel<true><<<blocks, RO_THREADS, smem, st>>>(
        N, Bt, sd, sd + (size_t)(NX * NX) * Bs,
        sd + (size_t)(NX * NX + NX * NU) * Bs, g, g + (size_t)(NU * NX) * Bs,
        (const scalar*)x0, (scalar*)ws, (scalar*)xN);
    return (int)cudaGetLastError();
}

#endif  // NC

}  // extern "C"
