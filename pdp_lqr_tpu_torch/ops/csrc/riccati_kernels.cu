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
// Narrow stage streams (-DSTAGE_BF16=1): the per-scenario stage data (A,
// B, c, H, h, D, rho, rho g; the JAX package's storage_dtype) stored in
// bfloat16 while every product runs in SCALAR.  Such a library holds the
// forms that read them and nothing else: K1 for the gains only and K11
// (with -DNC), K7 and K12 (without); the kernels widen each entry on the
// card (see K1 and K7).
//
// Each extern "C" entry point launches on the given stream, does not
// synchronise, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#if !defined(SCALAR) || !defined(NX) || !defined(NU)
#error "build with -DSCALAR=<float|double> -DNX=<n> -DNU=<n> [-DNC=<n>]"
#endif

#include "lanes_common.cuh"
#include "hopper_sync.cuh"

namespace {

// The storage type of the stage streams, and its widening to SCALAR.
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

// Diagnostic build (-DRICCATI_PROFILE): thread 0 of block 0 (or lane 0 of
// a role's warp in block 0) sums the SM cycles it spends in each marked
// section of a stage; riccati_read_prof
// copies the sums out: a view inside a kernel for where the vendor's
// profilers cannot run.
#ifdef RICCATI_PROFILE
__device__ long long riccati_prof[8];
#define PROF_INIT_AT(cond)                                                   \
    const bool prof_on = (cond);                                             \
    long long prof_acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};                        \
    long long prof_t = clock64();
#define PROF_MARK(i)                                                         \
    do {                                                                     \
        const long long t_ = clock64();                                      \
        prof_acc[i] += t_ - prof_t;                                          \
        prof_t = t_;                                                         \
    } while (0)
// Sections lo .. hi-1 out, scaled by mul / div (a tail warp's sums: per
// stage it took, where the others' are per stage of the sweep).
#define PROF_DONE_SCALED(lo, hi, mul, div)                                   \
    if (prof_on)                                                             \
        for (int i_ = lo; i_ < hi; ++i_)                                     \
            riccati_prof[i_] = prof_acc[i_] * (mul) / (div);
#else
#define PROF_INIT_AT(cond)
#define PROF_MARK(i)
#define PROF_DONE_SCALED(lo, hi, mul, div)
#endif
#define PROF_INIT PROF_INIT_AT(threadIdx.x == 0 && blockIdx.x == 0)
#define PROF_DONE_RANGE(lo, hi) PROF_DONE_SCALED(lo, hi, 1, 1)
#define PROF_DONE PROF_DONE_RANGE(0, 8)

#ifdef NC
// ------------------------------------------------------- K1, K9, K11
// Matrix sweep.  What bounds it on this card: a chain of N dependent
// stages an instance, each a chain of dependent products (some ten
// thousand FMAs an instance and stage), and where many instances run at
// once the shared-memory reads of those products and the copies of 3 kB
// an instance and stage (float32).  The design:
//
//   * A warp an instance, a block of G consecutive instances (for K9, of
//     one segment: block = segment * ceil(Bt/G) + group).  A stage's
//     products are dealt over the warp's lanes as tiles of 2 x 4 outputs,
//     whose operand rows a lane reads 16 bytes a load, a few steps of the
//     sum ahead; __syncwarp orders the steps.  Where the (segment,
//     instance) pairs are no more than the SMs (Bt = 1: the shared model;
//     a few long horizons), an instance gets a block of ONE_WARPS
//     warps instead, the steps ordered by __syncthreads, and the products
//     with the carry an output a thread (its chain is the whole stage):
//     the same body.
//   * The Cholesky factor's diagonal comes from rsqrt (L_jj = s rsqrt(s),
//     its inverse rsqrt(s)): no division and no square root on the chain.
//   * The block copies each stage of its G instances into a ring of SLOTS
//     shared-memory slots, SLOTS - 1 stages ahead (cp.async, a word a
//     copy; consecutive threads take consecutive instances of one entry,
//     so a warp's copies read whole sectors; a thread's copies of a stage
//     are unrolled, their addresses independent of each other).  The
//     outputs go out a stage later from a double-buffered out slot, 16
//     bytes a store (four instances' words of one entry) where the batch is
//     a multiple of the vector width and the pointers are aligned, a word
//     a store otherwise.  One __syncthreads a stage hands the slots over
//     (two where the out slot is single: SweepFit::OUTS).
//     A slot holds each instance's stage as a run of its own padded rows,
//     so a lane reads its operand rows 16 bytes a load; 16-byte copies
//     would need the instances side by side, where a warp's reads of one
//     instance fall on few banks.
//   * G and SLOTS follow from the widths and the dtype (SweepFit): as many
//     instances as make a 32-byte sector (8 in float32, 4 in float64) and 3
//     slots where 227 KB hold them, fewer where they do not.
//
// A stage, on the carry (P, p) = (P_{k+1}, p_{k+1}) (K9: also F, C, f):
//   A  Dr = [diag(rho) D | -rg];  [PA Pcp PB] = P [A c B] + [0 p 0]
//      (K9: [FA Fc FB] = F [A c B], the same product on F's rows)
//   B  the penalty fold [H h] += D^T Dr (lqr_kernel.hpp:106-112) on the
//      entries that are read: Huu and the cross block, Q's upper triangle
//      and h, each entry's sum in the order c = 0 .. nc-1;
//      S = B^T [PA Pcp PB]
//   C  G = Hux + S_x, rbar = h_u + S_c, Huu = Huu + S_u; a lane a column
//      factors Huu in registers (cheaper than a barrier) and solves
//      [K (Gp) d] = -Huu^{-1} [G ((F+ B)^T) rbar]
//   D  [P+ p+] = [Q q] + A^T [PA Pcp] + G^T [K d] (P+'s upper triangle,
//      mirrored: exactly symmetric; K^T rbar = G^T d), [M v] = [A c] +
//      B [K d] (K9: C = C+ - (F+ B) Gp, mirrored, so the condensed
//      Cholesky sees what JAX's does; [F f] = [FA Fc] + (F+ B) [K d] +
//      [0 f+])
// and the carries are updated in place (no step reads what it writes).
//
// PDP (K9, the segment reduction of the reference's parallel solver):
// each (segment, instance) sweeps its own N/S stages from its own carry
// and solves [K Gp d] with 2nx+1 right-hand sides:
//     Gp = -Huu^{-1} B^T F+^T,   F = F+ A + (F+ B) K,
//     f  = F+ c + (F+ B) d + f+,  C = C+ - (F+ B) Gp.
// After the segment's first stage the block writes the carry it hands its
// left neighbour, (P0, p0, F0, C0, f0).
//
// PACKED (K11): the stage data come row-packed, Sd = (A | B | c) and
// Sc = (H | h | D | rho | rho g), and the gains go out as G = (K | d): only
// the strides of the streams change (the entry point offsets the pointers).
//
// NARROW (bfloat16 stage streams, K1 gains only and K11).  Measured on an
// H100 (PERF.md), a stage of the batch form waits mostly on shared-memory
// instructions: issuing the compute type's copies (a word a copy, G of
// them an entry) takes 35-40 % of its cycles, and a widening pass costs
// what its loads and stores cost, on whichever warp it runs (the registers
// leave no room for a warp of its own: 128 a thread fill the SM with two
// blocks of 8 warps at the quadrotor's widths, 255 one block at nz=30).
// So the narrow forms keep the compute type's warp an instance and its two
// slots, and spend as few of those instructions as they can:
//   * the copy engine brings each stage of the G instances in boxes of a
//     bfloat16 map (8 instances = 16 bytes a row, an entry a row, from a
//     multiple of 8 instances: a box starts 16-byte aligned; a stream's
//     rows in boxes of at most 256, spread over the block's warps, their
//     maps fetched at the start; K11: its two packed streams) into a
//     staging area, a stage ahead, and counts them off a shared-memory
//     barrier (`landed`); where no box takes the streams (B no multiple
//     of 8, unaligned; the block of one instance), the aligned 4-byte
//     pairs that cover an entry's instances (G/2 + 1 of them: the first may
//     sit in a pair's second half) go by cp.async, the stream's last by a
//     zero-filling one, and every thread's copies count off the barrier;
//   * at the end of stage n the block widens stage n+1 into the next slot,
//     a thread four columns of a row of a stream at a time: four staging
//     rows (one 16-byte load each), then each instance's four entries in
//     one store where the run's rows are 16-byte aligned: 12 shared-memory
//     instructions for 32 entries, where the compute type's copies take 32
//     and a warp widening its own instance 64.
// The products never see the storage type: reading H, h, D, rho and rho g
// in bfloat16 from the staging at their reads instead (only [A c B]
// widened, three staging stages) ran 25 % slower on an H100, a warp's
// reads of its instance's entries, 16 bytes apart in the rows, falling
// on 8 banks (PERF.md).  The block of one instance (ONE) takes the same
// staging, widening and barrier, its stages by pairs (a box's rows would
// bring 8 instances for its one).
constexpr int VW = 16 / (int)sizeof(scalar);         // words a 16-byte access
// Row widths (words), each a multiple of 4: every row starts 16 bytes
// aligned (32 in float64), so a lane reads four entries a load.
constexpr int X4 = (NX + 3) / 4 * 4;                 // P, F, C, Gp
constexpr int WAB = (NX + 1 + NU + 3) / 4 * 4;       // [A c B], [PA Pcp PB]
constexpr int WH = (NZ + 1 + 3) / 4 * 4;             // [H h], Dr
constexpr int WD = (NZ + 3) / 4 * 4;                 // D
constexpr int WK = (NX + 1 + 3) / 4 * 4;             // [K d]
constexpr int NC4 = (NC + 3) / 4 * 4;
// An instance's stage in a slot.
constexpr int S_AB = 0;
constexpr int S_H = S_AB + NX * WAB;
constexpr int S_D = S_H + NZ * WH;
constexpr int S_RHO = S_D + NC * WD;
constexpr int S_RG = S_RHO + NC4;
constexpr int S_WORDS = S_RG + NC4;
// Instances lie S_STRIDE words apart (4 mod 8): the words of one entry of
// neighbouring instances, stored by one warp, fall on distinct banks.
constexpr int S_STRIDE = (S_WORDS + 7) / 8 * 8 + 4;

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

// An instance's carry and stage temporaries, and its outputs of one
// stage (in the order of the output streams), in words.
template <bool EMIT_MV, bool EXPORT, bool PDP> struct SweepLayout {
    static constexpr int XR = PDP ? 2 * NX : NX;      // rows of [P; F]
    static constexpr int P = 0;                       // [P; F] (+1 row: the
    static constexpr int PAB = P + (XR + 1) * X4;     //  tiles' row pairs)
    static constexpr int DR = PAB + (XR + 1) * WAB;   // [PA Pcp PB; FA Fc FB]
    static constexpr int GS = DR + NC * WH;           // [G rbar Huu] sums
    static constexpr int KD = GS + NU * WAB;          // [K d]
    static constexpr int GP = KD + NU * WK;
    static constexpr int PV = GP + (PDP ? NU * X4 : 0);   // p, f
    static constexpr int C = PV + (PDP ? 2 : 1) * X4;
    static constexpr int CARRY = C + (PDP ? NX * X4 : 0);
    static constexpr int OK = 0;
    static constexpr int OD = OK + NU * NX;
    static constexpr int OM = OD + NU;
    static constexpr int OV = OM + (EMIT_MV ? NX * NX : 0);
    static constexpr int OP = OV + (EMIT_MV ? NX : 0);
    static constexpr int OL = OP + (EXPORT ? NX * NX : 0);
    static constexpr int OGP = OL + (EXPORT ? NU * NU : 0);
    static constexpr int OF = OGP + (PDP ? NU * NX : 0);
    static constexpr int OUT = (OF + (PDP && EXPORT ? NX * NX : 0)) | 1;
};

constexpr int SWEEP_SMEM_MAX = 232448;      // 227 KB, the most a block has

// The compute-type forms' ring: SLOTS slots of S_STRIDE words an instance.
template <bool EMIT_MV, bool EXPORT, bool PDP>
constexpr int sweep_bytes(int g, int slots, int outs)
{
    using L = SweepLayout<EMIT_MV, EXPORT, PDP>;
    return (slots * g * S_STRIDE + g * L::CARRY + outs * g * L::OUT)
        * (int)sizeof(scalar);
}

// G * 8 + (OUTS - 1) * 4 + SLOTS of a compute-type form: the widest group
// from g0 down, 3 slots before 2, that fits with a double-buffered out
// slot; where none does, the same with one out slot (K9 exporting its
// factors at nz=50 in float64: its out slot is 46 KB); one instance, 2
// slots and one out slot where nothing fits.
template <bool EMIT_MV, bool EXPORT, bool PDP>
constexpr int sweep_pick(int g0)
{
    for (int outs = 2; outs >= 1; --outs)
        for (int g = g0; g >= 1; g /= 2)
            for (int slots = 3; slots >= 2; --slots)
                if (sweep_bytes<EMIT_MV, EXPORT, PDP>(g, slots, outs)
                    <= SWEEP_SMEM_MAX)
                    return g * 8 + (outs - 1) * 4 + slots;
    return 8 + 2;
}

// The narrow forms' staging (see the note): a stage's entries as
// rows, stream after stream in the streams' order A, B, c, H, h, D, rho,
// rho g (K11: Sd = A | B | c, then Sc), each box region (a stream; K11 a
// packed stream) taking box_count boxes of box_rows rows (a multiple of
// 8: every box lands 128-byte aligned); a row is BOX_W instances' entries
// (16 bytes) where the boxes take the streams, the pairs that cover G
// instances (row_bytes) where they do not.
constexpr int BOX_W = 8;
__host__ __device__ constexpr int entry_pairs(int g) { return (g + 2) / 2; }
__host__ __device__ constexpr int box_count(int e) { return (e + 255) / 256; }
__host__ __device__ constexpr int box_rows(int e)
{
    return e > 0 ? ((e + box_count(e) - 1) / box_count(e) + 7) / 8 * 8 : 0;
}
__host__ __device__ constexpr int box_span(int e) { return box_count(e) * box_rows(e); }
// The stage streams in the kernel's order: A, B, c, H, h, D, rho, rho g.
constexpr int NSTREAMS = 8;
__host__ __device__ constexpr int stream_entries(int q)
{
    return q == 0 ? NX * NX : q == 1 ? NX * NU : q == 2 ? NX : q == 3 ? NZ * NZ
        : q == 4 ? NZ : q == 5 ? NC * NZ : NC;
}
template <bool PACKED> struct Regions {
    static constexpr int N = PACKED ? 2 : NSTREAMS;
    // A stage's rows of region r.
    static __host__ __device__ constexpr int rows(int r)
    {
        return PACKED ? (r == 0 ? SD_ROWS : SC_ROWS) : stream_entries(r);
    }
    // Region r's first staging row.
    static __host__ __device__ constexpr int start(int r)
    {
        int at = 0;
        for (int i = 0; i < r; ++i) at += box_span(rows(i));
        return at;
    }
    // Stream q's first staging row (K11: its rows within Sd or Sc).
    static __host__ __device__ constexpr int row(int q)
    {
        if (!PACKED) return start(q);
        int at = q < 3 ? 0 : start(1);
        for (int i = q < 3 ? 0 : 3; i < q; ++i) at += stream_entries(i);
        return at;
    }
    // The bytes the boxes of a stage bring.
    static __host__ __device__ constexpr int box_bytes()
    {
        return start(N) * BOX_W * (int)sizeof(stage_t);
    }
};
constexpr int STAGE_ROWS = Regions<false>::start(NSTREAMS) > Regions<true>::start(2)
    ? Regions<false>::start(NSTREAMS) : Regions<true>::start(2);
// A staging row's bytes: the pairs of g instances, at least a box's row
// where boxes may bring the stage.
__host__ __device__ constexpr int row_bytes(int g, bool boxes)
{
    return 4 * entry_pairs(g) > BOX_W * 2 || !boxes ? 4 * entry_pairs(g)
                                                     : BOX_W * 2;
}
__host__ __device__ constexpr int stage_bytes(int g, bool boxes)
{
    return (STAGE_ROWS * row_bytes(g, boxes) + 127) / 128 * 128;
}
// The narrow forms' shared memory: two slots, a carry and OUTS out slots
// an instance, 128 bytes of alignment, one staging stage and its barrier.
template <bool EMIT_MV, bool EXPORT, bool PDP>
constexpr int narrow_bytes(int g, int outs, bool boxes)
{
    using L = SweepLayout<EMIT_MV, EXPORT, PDP>;
    return g * (2 * S_STRIDE + L::CARRY + outs * L::OUT) * (int)sizeof(scalar)
        + 128 + stage_bytes(g, boxes) + 16;
}
// G * 16 + BOXES * 8 + (OUTS - 1) * 4 + 2 of a narrow form: the widest
// group from g0 down (at most BOX_W), with a double-buffered out slot
// where it fits, else with one (the warps an SM first), rows that boxes
// may fill (where the caller allows them) before rows of pairs only.
template <bool EMIT_MV, bool EXPORT, bool PDP>
constexpr int narrow_pick(int g0, bool boxes)
{
    for (int g = g0 < BOX_W ? g0 : BOX_W; g >= 1; g /= 2)
        for (int outs = 2; outs >= 1; --outs)
            for (int b = boxes ? 1 : 0; b >= 0; --b)
                if (narrow_bytes<EMIT_MV, EXPORT, PDP>(g, outs, b)
                    <= SWEEP_SMEM_MAX)
                    return g * 16 + b * 8 + (outs - 1) * 4 + 2;
    return 16 + 2;
}

// Warps of the block of one instance (ONE): on the shared model (Bt = 1)
// 4 and 8 ran as fast as each other and faster than 1, K9 on few long
// horizons ran faster with 8 (PERF.md).
constexpr int ONE_WARPS = 8;

// A form's block: G instances of a warp each (ONE: one instance of
// ONE_WARPS warps), and its ring.  OK is false only where one instance
// alone does not fit.  Narrow forms (see the note): two slots and a
// staging stage, boxes only in the batch form (NB), whose instances share
// a box's rows.
template <bool EMIT_MV, bool EXPORT, bool PDP, bool ONE> struct SweepFit {
    static constexpr bool NB = NARROW && !ONE;
    static constexpr int PICK = NARROW
        ? narrow_pick<EMIT_MV, EXPORT, PDP>(ONE ? 1 : 32 / (int)sizeof(scalar), NB)
        : sweep_pick<EMIT_MV, EXPORT, PDP>(ONE ? 1 : 32 / (int)sizeof(scalar));
    static constexpr int G = NARROW ? PICK / 16 : PICK / 8;
    static constexpr bool BOXES = NARROW && PICK / 8 % 2;
    static constexpr int SLOTS = PICK % 4;
    static constexpr int OUTS = PICK / 4 % 2 + 1;   // out slots
    static constexpr int W = ONE ? ONE_WARPS : 1;
    static constexpr int THREADS = 32 * W * G;
    static constexpr int BYTES = NARROW
        ? narrow_bytes<EMIT_MV, EXPORT, PDP>(G, OUTS, BOXES)
        : sweep_bytes<EMIT_MV, EXPORT, PDP>(G, SLOTS, OUTS);
    static constexpr bool OK = BYTES <= SWEEP_SMEM_MAX;
    // Narrow batch forms: two blocks an SM where their shared memory
    // allows (228 KB an SM, 1 KB of it a block's own), the registers
    // capped to match (the compute-type forms take two at the quadrotor's
    // widths unasked: 128 registers, 111 KB).
    static constexpr int MINB = NB && 2 * (BYTES + 1024) <= 233472 ? 2 : 1;
};

// The tiles of the triangular steps, 2 x 4 outputs: column tile by column
// tile (columns 4 jt .. 4 jt + 3), each holding the row pairs that have an
// entry the sweep reads:
//   FOLD   [H h]: the rows of Huu and the cross block, and Q's rows up to
//          the tile's last column;
//   UPPER  P+'s upper triangle (and its column nx, p+: every row);
//   CUPPER C's upper triangle.
enum Tri { FOLD, UPPER, CUPPER };

template <int KIND>
__host__ __device__ constexpr int tri_pairs(int jt)
{
    const int last = 4 * jt + 3;                      // the tile's last column
    const int rows = KIND == FOLD ? NZ : NX;
    int need = last + 1;                              // rows 0 .. last
    if (KIND == FOLD && need < NU) need = NU;
    if (KIND == UPPER && last >= NX) need = NX;       // column nx: p+
    if (need > rows) need = rows;
    return (need + 1) / 2;
}

template <int KIND>
__host__ __device__ constexpr int tri_tiles()
{
    int n = 0;
    for (int jt = 0; jt < (KIND == FOLD ? WH : KIND == UPPER ? WK : X4) / 4; ++jt)
        n += tri_pairs<KIND>(jt);
    return n;
}

// Threads of whole warps that n items take.
__host__ __device__ constexpr int warps(int n) { return (n + 31) / 32 * 32; }

// Tile q of a triangle -> its first row r0 and first column j0.
template <int KIND>
__device__ __forceinline__ void tri_tile(int q, int& r0, int& j0)
{
    int jt = 0;
    while (q >= tri_pairs<KIND>(jt)) q -= tri_pairs<KIND>(jt++);
    r0 = 2 * q;
    j0 = 4 * jt;
}

// Four consecutive words (16-byte aligned) in and out of registers.
template <class Sc>
__device__ __forceinline__ void ld4(Sc (&v)[4], const Sc* p)
{
    if constexpr (sizeof(Sc) == 4) {
        const float4 q = *reinterpret_cast<const float4*>(p);
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
        const double2 a = *reinterpret_cast<const double2*>(p);
        const double2 b = *reinterpret_cast<const double2*>(p + 2);
        v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
    }
}

template <class Sc>
__device__ __forceinline__ void st4(Sc* p, const Sc (&v)[4])
{
    if constexpr (sizeof(Sc) == 4) {
        *reinterpret_cast<float4*>(p) = float4{v[0], v[1], v[2], v[3]};
    } else {
        *reinterpret_cast<double2*>(p) = double2{v[0], v[1]};
        *reinterpret_cast<double2*>(p + 2) = double2{v[2], v[3]};
    }
}

// TW consecutive words (16-byte aligned where TW is 4) in and out of
// registers.
template <int TW>
__device__ __forceinline__ void ldw(scalar (&v)[TW], const scalar* p)
{
    if constexpr (TW == 4) {
        ld4(v, p);
    } else {
#pragma unroll
        for (int b = 0; b < TW; ++b) v[b] = p[b];
    }
}

template <int TW>
__device__ __forceinline__ void stw(scalar* p, const scalar (&v)[TW])
{
    if constexpr (TW == 4) {
        st4(p, v);
    } else {
#pragma unroll
        for (int b = 0; b < TW; ++b) p[b] = v[b];
    }
}

// acc[r][b] += sum_t x_r[t * XT] * y[t * YT + b], t = 0 .. T-1 in order,
// for the tile's rows r < R: y's rows read TW words a load, the operands
// of TC steps loaded before their FMAs.
template <int R, int TR, int TW, int T, int XT, int YT>
__device__ __forceinline__ void tile_mac(scalar (&acc)[TR][TW],
                                         const scalar* const (&x)[TR],
                                         const scalar* y)
{
    constexpr int TC = 4;
#pragma unroll
    for (int t0 = 0; t0 < T; t0 += TC) {
        scalar xv[R][TC], yv[TC][TW];
#pragma unroll
        for (int tt = 0; tt < TC; ++tt) {
            if (t0 + tt < T) {
                ldw<TW>(yv[tt], y + (t0 + tt) * YT);
#pragma unroll
                for (int r = 0; r < R; ++r) xv[r][tt] = x[r][(t0 + tt) * XT];
            }
        }
#pragma unroll
        for (int tt = 0; tt < TC; ++tt) {
            if (t0 + tt < T) {
#pragma unroll
                for (int r = 0; r < R; ++r)
#pragma unroll
                    for (int b = 0; b < TW; ++b) acc[r][b] += xv[r][tt] * yv[tt][b];
            }
        }
    }
}

// The copies of one stage stream into the G instances' runs of a slot:
// entry e of instance b0+i at src[e*Bs + b0+i] to row e / COLS, column
// e % COLS of instance i's run (rows STRIDE apart).  Thread t copies
// instance t % G (the last one's words past the batch), entries t / G,
// t / G + NT / G, ...: unrolled, so that no copy waits on another's
// address arithmetic.
template <int E, int COLS, int STRIDE, int G, int NT>
__device__ __forceinline__ void stage_copy(scalar* __restrict__ dst,
                                           const scalar* __restrict__ src,
                                           size_t Bs, int tid)
{
    constexpr int ES = NT / G;
#pragma unroll
    for (int m = 0; m < (E + ES - 1) / ES; ++m) {
        const int e = tid / G + m * ES;
        if (e < E)
            copy_word(dst + (e / COLS) * STRIDE + e % COLS, src + e * Bs);
    }
}

// The narrow forms: a stream's pairs of a stage (E entries, entry e of
// the group's first instance at src[e*Bs]) copied by the block's threads
// into the staging rows from `rows` (RB bytes a row), a pair a copy; the
// stream's last pair, where it reaches `end`, by a copy that fills what
// lies past `end` with zeros (nothing past it is read).
template <int E, int RB, int NT>
__device__ __forceinline__ void narrow_pairs(char* __restrict__ rows,
                                             const stage_t* src,
                                             const stage_t* end, size_t Bs,
                                             int tid)
{
    constexpr int NP = RB / 4;
#pragma unroll 1
    for (int q = tid; q < E * NP; q += NT) {
        const int e = q / NP, j = q % NP;
        const stage_t* first = src + e * Bs;
        const stage_t* a = first - (((size_t)first >> 1) & 1);
        const stage_t* p = a + 2 * j;
        const int past = p + 1 < end ? 0 : p < end ? 2 : 4;   // bytes
        __pipeline_memcpy_async(rows + e * RB + 4 * j, past < 4 ? p : a, 4,
                                past);
    }
}

// The narrow forms: a stream's staging rows (entry e of the G instances
// at rows + e*rb; instance i 2 (i + o) bytes in: boxes start on a multiple
// of BOX_W instances, o = ob the group's place in it; pairs start a half
// early where the row's instance 0, at src[e*Bs], sits in a pair's second
// half: o = 1) widened into the instances' runs of a slot (instance i's entry e at
// dst[i*S_STRIDE + (e/COLS)*STRIDE + e%COLS]): a thread four columns of a
// row at a time, its four staging rows loaded (16 bytes each where boxes
// brought them, else RB/4 words), then each instance's four entries in one
// store where the run's rows start 16-byte aligned (VEC), else two at a
// time where they lie on a pair of words (ODD: the run's rows start on a
// pair's second word), one otherwise.
template <int ROWS, int COLS, int STRIDE, bool VEC, bool ODD, int G, int NT,
          int RB>
__device__ __forceinline__ void narrow_widen_rows(scalar* __restrict__ dst,
                                                  const char* __restrict__ rows,
                                                  bool boxes, int ob,
                                                  const stage_t* src,
                                                  size_t Bs, int tid)
{
    constexpr int C4 = (COLS + 3) / 4;
    constexpr int NW = RB / 4;                    // words a pairs row holds
#pragma unroll 1
    for (int it = tid; it < ROWS * C4; it += NT) {
        const int r = it / C4, c0 = it % C4 * 4;
        const int k = COLS - c0 < 4 ? COLS - c0 : 4;
        unsigned w[4][NW > 4 ? NW : 4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int e = r * COLS + c0 + (j < k ? j : 0);
            const char* row = rows + e * (boxes ? BOX_W * 2 : RB);
            if (boxes) {
                const uint4 v = *reinterpret_cast<const uint4*>(row);
                unsigned long long lo = v.x | (unsigned long long)v.y << 32;
                unsigned long long hi = v.z | (unsigned long long)v.w << 32;
                if (ob) {                     // shift the group to the front
                    const int sh = 16 * ob;
                    lo = sh >= 64 ? hi >> (sh - 64) : lo >> sh | hi << (64 - sh);
                    hi = sh >= 64 ? 0 : hi >> sh;
                }
                w[j][0] = (unsigned)lo; w[j][1] = (unsigned)(lo >> 32);
                w[j][2] = (unsigned)hi; w[j][3] = (unsigned)(hi >> 32);
            } else {
                const unsigned* u = reinterpret_cast<const unsigned*>(row);
#pragma unroll
                for (int t = 0; t < NW; ++t) w[j][t] = u[t];
                if (((size_t)(src + e * Bs) >> 1) & 1)   // a half early: shift
#pragma unroll
                    for (int t = 0; t < NW; ++t)
                        w[j][t] = (w[j][t] >> 16)
                            | (t + 1 < NW ? w[j][t + 1] << 16 : 0u);
            }
        }
        scalar* d = dst + r * STRIDE + c0;
#pragma unroll
        for (int i = 0; i < G; ++i) {
            scalar v[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
                v[j] = (scalar)__uint_as_float(
                    i % 2 ? w[j][i / 2] & 0xffff0000u : w[j][i / 2] << 16);
            scalar* di = d + i * S_STRIDE;
            struct alignas(2 * sizeof(scalar)) Two { scalar a, b; };
            auto two = [&](int j) {
                *reinterpret_cast<Two*>(di + j) = Two{v[j], v[j + 1]};
            };
            if (VEC && k == 4) {
                st4(di, v);
            } else if (!ODD) {
                if (k >= 2) two(0); else di[0] = v[0];
                if (k == 4) two(2); else if (k == 3) di[2] = v[2];
            } else {
                di[0] = v[0];
                if (k >= 3) two(1); else if (k == 2) di[1] = v[1];
                if (k == 4) di[3] = v[3];
            }
        }
    }
}

// The copy engine's maps of the narrow batch form's box regions (see
// Regions; a compute-type library, and the block of one instance, pass an
// unused one).
struct SweepMaps { CUtensorMap m[NARROW ? NSTREAMS : 1]; };

// An output stream of the G instances from the out slot (instances OW
// words apart) to device memory: entry e of instance b0+i to
// dst[e*Bs + b0+i], VW instances a store where `vec`; unrolled, the
// shared-memory reads ahead of the stores.
template <int E, int G, int NT, int OW>
__device__ __forceinline__ void out_store(scalar* __restrict__ dst,
                                          const scalar* __restrict__ src,
                                          size_t Bs, size_t b0, int tid,
                                          bool vec)
{
    constexpr int CV = G / VW, CVD = CV > 0 ? CV : 1;
    if (CV > 0 && vec) {
#pragma unroll
        for (int m = 0; m < (E * CV + NT - 1) / NT; ++m) {
            const int q = tid + m * NT;
            const int e = q / CVD, ch = q % CVD;
            if (q < E * CV && b0 + ch * VW < Bs) {
                const scalar* s = src + ch * VW * OW + e;
                scalar* d = dst + e * Bs + b0 + ch * VW;
                if constexpr (VW == 4) {
                    const scalar v[4] = {s[0], s[OW], s[2 * OW], s[3 * OW]};
                    st4(d, v);
                } else {
                    *reinterpret_cast<double2*>(d) = double2{s[0], s[OW]};
                }
            }
        }
    } else {
#pragma unroll
        for (int m = 0; m < (E * G + NT - 1) / NT; ++m) {
            const int q = tid + m * NT;
            const int e = q / G, i = q % G;
            if (q < E * G && b0 + i < Bs) dst[e * Bs + b0 + i] = src[i * OW + e];
        }
    }
}

// One instance's output stream of E entries (an entry a thread, NT
// threads), held in registers between the reads of the out slot and the
// stores.
template <int E, int NT>
struct Held {
    static constexpr int M = (E + NT - 1) / NT;
    scalar v[M > 0 ? M : 1];

    __device__ __forceinline__ void load(const scalar* src, int tid)
    {
#pragma unroll
        for (int m = 0; m < M; ++m)
            if (tid + m * NT < E) v[m] = src[tid + m * NT];
    }

    // Entry e to dst[e * Bs].
    __device__ __forceinline__ void store(scalar* dst, size_t Bs, int tid) const
    {
#pragma unroll
        for (int m = 0; m < M; ++m)
            if (tid + m * NT < E) dst[(tid + m * NT) * Bs] = v[m];
    }
};

// A carry stream of the G instances between device memory and the
// carries (instances CW words apart), once a block.
template <int ROWS, int COLS, int STRIDE, int G, int NT, int CW>
__device__ __forceinline__ void carry_in(scalar* dst, const scalar* src,
                                         size_t Bs, size_t b0, int tid)
{
#pragma unroll 1
    for (int q = tid; q < ROWS * COLS * G; q += NT) {
        const int e = q / G, i = q % G;
        const size_t b = b0 + i < Bs ? b0 + i : Bs - 1;
        dst[i * CW + (e / COLS) * STRIDE + e % COLS] = src[e * Bs + b];
    }
}

template <int ROWS, int COLS, int STRIDE, int G, int NT, int CW>
__device__ __forceinline__ void carry_out(scalar* dst, const scalar* src,
                                          size_t Bs, size_t b0, int tid)
{
#pragma unroll 1
    for (int q = tid; q < ROWS * COLS * G; q += NT) {
        const int e = q / G, i = q % G;
        if (b0 + i < Bs)
            dst[e * Bs + b0 + i] = src[i * CW + (e / COLS) * STRIDE + e % COLS];
    }
}

template <bool EMIT_MV, bool EXPORT, bool PDP, bool PACKED, bool ONE>
#ifdef STAGE_BF16
__global__ void __launch_bounds__(SweepFit<EMIT_MV, EXPORT, PDP, ONE>::THREADS,
                                  SweepFit<EMIT_MV, EXPORT, PDP, ONE>::MINB)
#else
__global__ void __launch_bounds__(SweepFit<EMIT_MV, EXPORT, PDP, ONE>::THREADS)
#endif
backward_kernel(
    int N, int Bt, int S,
    const stage_t* __restrict__ A, const stage_t* __restrict__ B,
    const stage_t* __restrict__ c, const stage_t* __restrict__ H,
    const stage_t* __restrict__ h, const stage_t* __restrict__ D,
    const stage_t* __restrict__ rho, const stage_t* __restrict__ rg,
    const scalar* __restrict__ PN, const scalar* __restrict__ pN,
    scalar* __restrict__ K_out, scalar* __restrict__ d_out,
    scalar* __restrict__ M_out, scalar* __restrict__ v_out,
    scalar* __restrict__ P_out, scalar* __restrict__ L_out,
    const scalar* __restrict__ Fi, const scalar* __restrict__ Ci,
    const scalar* __restrict__ fi, scalar* __restrict__ Gp_out,
    scalar* __restrict__ F_out, scalar* __restrict__ P0_out,
    scalar* __restrict__ p0_out, scalar* __restrict__ F0_out,
    scalar* __restrict__ C0_out, scalar* __restrict__ f0_out,
    const __grid_constant__ SweepMaps maps, int boxes)
{
    using R = K1Rows<PACKED>;
    using L = SweepLayout<EMIT_MV, EXPORT, PDP>;
    using Fit = SweepFit<EMIT_MV, EXPORT, PDP, ONE>;
    constexpr int G = Fit::G, SLOTS = Fit::SLOTS, NT = Fit::THREADS;
    constexpr int OUTS = Fit::OUTS;
    constexpr int T = 32 * Fit::W;              // threads of one instance
    // Tiles of TR x TW outputs (few rounds, loads reused); one instance's
    // many threads take the products with the carry, [P; F] [A c B] and
    // B^T [PA Pcp PB], an output each (TRA x TWA).
    constexpr int TR = 2, TW = 4;
    constexpr int TRA = ONE ? 1 : TR, TWA = ONE ? 1 : TW;
    constexpr int CW = L::CARRY, OW = L::OUT;
    // The narrow forms (see the note): a staging stage, rows of RB bytes
    // where pairs fill them, of BOX_W bfloat16 where boxes do.
    constexpr bool BOXES = Fit::BOXES;
    constexpr int RB = row_bytes(G, BOXES);
    using Rg = Regions<PACKED>;
    extern __shared__ double smem_aligned[];
    scalar* ring = reinterpret_cast<scalar*>(smem_aligned);
    scalar* carries = ring + SLOTS * G * S_STRIDE;
    scalar* outs = carries + G * CW;
    char* staging = reinterpret_cast<char*>(
        (reinterpret_cast<size_t>(outs + OUTS * G * OW) + 127) / 128 * 128);
    mbar_t* landed = reinterpret_cast<mbar_t*>(staging + stage_bytes(G, BOXES));

    const int tid = threadIdx.x;
    const int lane = tid % T;
    const int inst = tid / T;                   // the instance in the block
    const size_t Bs = (size_t)Bt;
    const unsigned groups = (Bt + G - 1) / G;
    const int seg = PDP ? (int)(blockIdx.x / groups) : 0;
    const size_t b0 = (size_t)(blockIdx.x % groups) * G;
    const int Nl = PDP ? N / S : N;
    const int k0 = seg * Nl;
    const size_t cs = (size_t)seg;              // this segment's carry slot
    // 16-byte stores: the batch a multiple of the vector width, every
    // output stream aligned.
    const bool vec = G % VW == 0 && Bs % VW == 0
        && (((size_t)K_out | (size_t)d_out | (size_t)M_out | (size_t)v_out
             | (size_t)P_out | (size_t)L_out | (size_t)Gp_out
             | (size_t)F_out) & 15) == 0;
    // This thread's instance of the copies (the last one past the batch).
    const size_t bc = b0 + tid % G < Bs ? b0 + tid % G : Bs - 1;
    // The end of a narrow stream: its last stage's last entry.
    auto end = [&](const stage_t* x, int rows, int e) {
        return x + ((size_t)(N - 1) * rows + e) * Bs;
    };
    // This instance's carry.
    scalar* const cw = carries + inst * CW;
    scalar* const P = cw + L::P;
    scalar* const F = P + NX * X4;
    scalar* const PAB = cw + L::PAB;
    scalar* const Dr = cw + L::DR;
    scalar* const GS = cw + L::GS;
    scalar* const KD = cw + L::KD;
    scalar* const Gp = cw + L::GP;
    scalar* const p = cw + L::PV;
    scalar* const f = p + X4;
    scalar* const C = cw + L::C;

    // Narrow: the copies of the stage at ks of the G instances into the
    // staging: the boxes dealt over the warps' lane 0 (thread 0 posting
    // their bytes), or every thread's pairs.
    auto issue = [&](size_t ks) {
        if constexpr (NARROW) {
            char* st = staging;
            if (BOXES && boxes) {
                if (tid == 0) mbar_arrive_expect_tx(landed, Rg::box_bytes());
                if (lane == 0) {
                    int bx = 0;
#pragma unroll
                    for (int r = 0; r < Rg::N; ++r) {
                        const int rows = Rg::rows(r), br = box_rows(rows);
                        for (int j = 0; j < box_count(rows); ++j, ++bx)
                            if (bx % G == inst)
                                tma_box(st + (Rg::start(r) + j * br) * (BOX_W * 2),
                                        &maps.m[r], (int)(b0 - b0 % BOX_W),
                                        (int)(ks * rows + j * br), landed);
                    }
                }
            } else {
                narrow_pairs<NX * NX, RB, NT>(st + Rg::row(0) * RB, A + ks * R::A * Bs + b0, end(A, R::A, NX * NX), Bs, tid);
                narrow_pairs<NX * NU, RB, NT>(st + Rg::row(1) * RB, B + ks * R::B * Bs + b0, end(B, R::B, NX * NU), Bs, tid);
                narrow_pairs<NX, RB, NT>(st + Rg::row(2) * RB, c + ks * R::C * Bs + b0, end(c, R::C, NX), Bs, tid);
                narrow_pairs<NZ * NZ, RB, NT>(st + Rg::row(3) * RB, H + ks * R::H * Bs + b0, end(H, R::H, NZ * NZ), Bs, tid);
                narrow_pairs<NZ, RB, NT>(st + Rg::row(4) * RB, h + ks * R::HV * Bs + b0, end(h, R::HV, NZ), Bs, tid);
                narrow_pairs<NC * NZ, RB, NT>(st + Rg::row(5) * RB, D + ks * R::D * Bs + b0, end(D, R::D, NC * NZ), Bs, tid);
                narrow_pairs<NC, RB, NT>(st + Rg::row(6) * RB, rho + ks * R::RHO * Bs + b0, end(rho, R::RHO, NC), Bs, tid);
                narrow_pairs<NC, RB, NT>(st + Rg::row(7) * RB, rg + ks * R::RHO * Bs + b0, end(rg, R::RHO, NC), Bs, tid);
                mbar_arrive_on_copies(landed);
            }
        }
    };

    // The block's copies of stage n (k = k0 + Nl-1 - n) into its slot
    // (narrow: into the staging).
    auto prefetch = [&](int n) {
        if (n < Nl) {
            const size_t ks = (size_t)(k0 + Nl - 1 - n);
            if constexpr (NARROW) {
                issue(ks);
            } else {
                scalar* sl = ring + ((n % SLOTS) * G + tid % G) * S_STRIDE;
                stage_copy<NX * NX, NX, WAB, G, NT>(sl + S_AB, A + ks * R::A * Bs + bc, Bs, tid);
                stage_copy<NX, 1, WAB, G, NT>(sl + S_AB + NX, c + ks * R::C * Bs + bc, Bs, tid);
                stage_copy<NX * NU, NU, WAB, G, NT>(sl + S_AB + NX + 1, B + ks * R::B * Bs + bc, Bs, tid);
                stage_copy<NZ * NZ, NZ, WH, G, NT>(sl + S_H, H + ks * R::H * Bs + bc, Bs, tid);
                stage_copy<NZ, 1, WH, G, NT>(sl + S_H + NZ, h + ks * R::HV * Bs + bc, Bs, tid);
                stage_copy<NC * NZ, NZ, WD, G, NT>(sl + S_D, D + ks * R::D * Bs + bc, Bs, tid);
                stage_copy<NC, 1, 1, G, NT>(sl + S_RHO, rho + ks * R::RHO * Bs + bc, Bs, tid);
                stage_copy<NC, 1, 1, G, NT>(sl + S_RG, rg + ks * R::RHO * Bs + bc, Bs, tid);
            }
        }
        __pipeline_commit();
    };

    // Narrow: once stage n landed, the block widens it into its slot.
    auto widen = [&](int n) {
        if (n >= Nl) return;
        const size_t ks = (size_t)(k0 + Nl - 1 - n);
        mbar_wait(landed, n & 1);
        scalar* sl = ring + (n % SLOTS) * G * S_STRIDE;     // instance 0's run
        const char* st = staging;
        const bool bx = BOXES && boxes;
        const int rb = bx ? BOX_W * 2 : RB;                 // a row's bytes
        const int ob = G % BOX_W ? (int)(b0 % BOX_W) : 0;   // in its box
        constexpr bool VB = (S_AB + NX + 1) % 4 == 0;       // B's rows aligned
        narrow_widen_rows<NX, NX, WAB, S_AB % 4 == 0, S_AB % 2, G, NT, RB>(sl + S_AB, st + rb * Rg::row(0), bx, ob, A + ks * R::A * Bs + b0, Bs, tid);
        narrow_widen_rows<NX, NU, WAB, VB, (S_AB + NX + 1) % 2, G, NT, RB>(sl + S_AB + NX + 1, st + rb * Rg::row(1), bx, ob, B + ks * R::B * Bs + b0, Bs, tid);
        narrow_widen_rows<NX, 1, WAB, false, false, G, NT, RB>(sl + S_AB + NX, st + rb * Rg::row(2), bx, ob, c + ks * R::C * Bs + b0, Bs, tid);
        narrow_widen_rows<NZ, NZ, WH, S_H % 4 == 0, S_H % 2, G, NT, RB>(sl + S_H, st + rb * Rg::row(3), bx, ob, H + ks * R::H * Bs + b0, Bs, tid);
        narrow_widen_rows<NZ, 1, WH, false, false, G, NT, RB>(sl + S_H + NZ, st + rb * Rg::row(4), bx, ob, h + ks * R::HV * Bs + b0, Bs, tid);
        narrow_widen_rows<NC, NZ, WD, S_D % 4 == 0, S_D % 2, G, NT, RB>(sl + S_D, st + rb * Rg::row(5), bx, ob, D + ks * R::D * Bs + b0, Bs, tid);
        narrow_widen_rows<1, NC, 1, S_RHO % 4 == 0, S_RHO % 2, G, NT, RB>(sl + S_RHO, st + rb * Rg::row(6), bx, ob, rho + ks * R::RHO * Bs + b0, Bs, tid);
        narrow_widen_rows<1, NC, 1, S_RG % 4 == 0, S_RG % 2, G, NT, RB>(sl + S_RG, st + rb * Rg::row(7), bx, ob, rg + ks * R::RHO * Bs + b0, Bs, tid);
    };

    // The block's stores of stage n's outputs from its out slot (one
    // instance: every stream read before any is written).
    auto store = [&](int n) {
        const size_t ks = (size_t)(k0 + Nl - 1 - n);
        const scalar* o = outs + (n % OUTS) * G * OW;
        if constexpr (ONE) {
            Held<NU * NX, NT> hK;
            Held<NU, NT> hd;
            Held<EMIT_MV ? NX * NX : 0, NT> hM;
            Held<EMIT_MV ? NX : 0, NT> hv;
            Held<EXPORT ? NX * NX : 0, NT> hP;
            Held<EXPORT ? NU * NU : 0, NT> hL;
            Held<PDP ? NU * NX : 0, NT> hGp;
            Held<PDP && EXPORT ? NX * NX : 0, NT> hF;
            hK.load(o + L::OK, tid);
            hd.load(o + L::OD, tid);
            hM.load(o + L::OM, tid);
            hv.load(o + L::OV, tid);
            hP.load(o + L::OP, tid);
            hL.load(o + L::OL, tid);
            hGp.load(o + L::OGP, tid);
            hF.load(o + L::OF, tid);
            hK.store(K_out + ks * R::K * Bs + b0, Bs, tid);
            hd.store(d_out + ks * R::DV * Bs + b0, Bs, tid);
            hM.store(M_out + ks * NX * NX * Bs + b0, Bs, tid);
            hv.store(v_out + ks * NX * Bs + b0, Bs, tid);
            hP.store(P_out + ks * NX * NX * Bs + b0, Bs, tid);
            hL.store(L_out + ks * NU * NU * Bs + b0, Bs, tid);
            hGp.store(Gp_out + ks * NU * NX * Bs + b0, Bs, tid);
            hF.store(F_out + ks * NX * NX * Bs + b0, Bs, tid);
            return;
        }
        out_store<NU * NX, G, NT, OW>(K_out + ks * R::K * Bs, o + L::OK, Bs, b0, tid, vec);
        out_store<NU, G, NT, OW>(d_out + ks * R::DV * Bs, o + L::OD, Bs, b0, tid, vec);
        if (EMIT_MV) {
            out_store<NX * NX, G, NT, OW>(M_out + ks * NX * NX * Bs, o + L::OM, Bs, b0, tid, vec);
            out_store<NX, G, NT, OW>(v_out + ks * NX * Bs, o + L::OV, Bs, b0, tid, vec);
        }
        if (EXPORT) {
            out_store<NX * NX, G, NT, OW>(P_out + ks * NX * NX * Bs, o + L::OP, Bs, b0, tid, vec);
            out_store<NU * NU, G, NT, OW>(L_out + ks * NU * NU * Bs, o + L::OL, Bs, b0, tid, vec);
        }
        if (PDP)
            out_store<NU * NX, G, NT, OW>(Gp_out + ks * NU * NX * Bs, o + L::OGP, Bs, b0, tid, vec);
        if (PDP && EXPORT)
            out_store<NX * NX, G, NT, OW>(F_out + ks * NX * NX * Bs, o + L::OF, Bs, b0, tid, vec);
    };

    // The first item of a step's loop that starts after loops of `off`
    // whole warps' items: the independent loops of a step go to different
    // warps of the instance (not one after another on its first threads,
    // nor diverging within one warp).  One warp an instance: no offset.
    auto first = [&](int off) { return (lane + T - off % T) % T; };

    auto group_sync = [] {
        if constexpr (ONE) __syncthreads();
        else __syncwarp();
    };

    if constexpr (NARROW) {
        // The staging lands on its barrier: thread 0's posting of the
        // boxes' bytes, or every thread once its pairs land.  The maps are
        // fetched ahead of the first boxes.
        if (tid == 0) mbar_init(landed, BOXES && boxes ? 1 : NT);
        if (BOXES && boxes && lane == 0)
#pragma unroll
            for (int r = 0; r < Rg::N; ++r)
                if (r % G == inst && Rg::rows(r) > 0) prefetch_map(&maps.m[r]);
        __syncthreads();
    }
    for (int n = 0; n < SLOTS - 1; ++n) prefetch(n);
    if constexpr (NARROW) widen(0);
    carry_in<NX, NX, X4, G, NT, CW>(carries + L::P, PN + cs * NX * NX * Bs, Bs, b0, tid);
    carry_in<1, NX, 0, G, NT, CW>(carries + L::PV, pN + cs * NX * Bs, Bs, b0, tid);
    if (PDP) {
        carry_in<NX, NX, X4, G, NT, CW>(carries + L::P + NX * X4, Fi + cs * NX * NX * Bs, Bs, b0, tid);
        carry_in<NX, NX, X4, G, NT, CW>(carries + L::C, Ci + cs * NX * NX * Bs, Bs, b0, tid);
        carry_in<1, NX, 0, G, NT, CW>(carries + L::PV + X4, fi + cs * NX * Bs, Bs, b0, tid);
    }
    PROF_INIT

    for (int n = 0; n < Nl; ++n) {
        if constexpr (!NARROW)
            __pipeline_wait_prior(SLOTS - 2); // stage n landed (my copies)
        __syncthreads();                      // ... everyone's (narrow:
                                              // widened); the slot and
                                              // out slot of n-1 free
        PROF_MARK(0);
        if (n > 0) store(n - 1);
        if constexpr (OUTS == 1) __syncthreads();   // stored before rewritten
        PROF_MARK(1);
        prefetch(n + SLOTS - 1);              // into the slot of stage n-1
                                              // (narrow: the staging)
        PROF_MARK(2);
        scalar* const sl = ring + ((n % SLOTS) * G + inst) * S_STRIDE;
        const scalar* const sAB = sl + S_AB;
        scalar* const sH = sl + S_H;
        const scalar* const sD = sl + S_D;
        scalar* const o = outs + ((n % OUTS) * G + inst) * OW; // outputs

        // ---- A: Dr, and [PA Pcp PB] = P [A c B] + [0 p 0] (K9: F's rows
        // too); the exported carries.
        for (int e = lane; e < NC * (NZ + 1); e += T) {
            const int ci = e / (NZ + 1), q = e % (NZ + 1);
            Dr[ci * WH + q] = q < NZ ? sl[S_RHO + ci] * sD[ci * WD + q]
                                     : -sl[S_RG + ci];
        }
        for (int q = lane; q < (L::XR + TRA - 1) / TRA * (WAB / TWA); q += T) {
            const int r0 = q / (WAB / TWA) * TRA, j0 = q % (WAB / TWA) * TWA;
            scalar acc[TRA][TWA] = {};
            const scalar* x[TRA];
#pragma unroll
            for (int r = 0; r < TRA; ++r) x[r] = P + (r0 + r) * X4;
            tile_mac<TRA, TRA, TWA, NX, 1, WAB>(acc, x, sAB + j0);
#pragma unroll
            for (int r = 0; r < TRA; ++r) {
#pragma unroll
                for (int b = 0; b < TWA; ++b)
                    if (r0 + r < NX && j0 + b == NX) acc[r][b] += p[r0 + r];
                if (r0 + r < L::XR) stw<TWA>(PAB + (r0 + r) * WAB + j0, acc[r]);
            }
        }
        if (EXPORT) {
            for (int e = lane; e < NX * NX; e += T) {
                o[L::OP + e] = P[e / NX * X4 + e % NX];
                if (PDP) o[L::OF + e] = F[e / NX * X4 + e % NX];
            }
        }
        group_sync();
        PROF_MARK(3);

        // ---- B: the fold [H h] += D^T Dr on the entries read, and
        // S = B^T [PA Pcp PB].
        for (int q = lane; q < tri_tiles<FOLD>(); q += T) {
            int r0, j0;
            tri_tile<FOLD>(q, r0, j0);
            scalar acc[TR][TW];
            const scalar* x[TR];
#pragma unroll
            for (int r = 0; r < TR; ++r) {
                ldw<TW>(acc[r], sH + (r0 + r) * WH + j0);   // past NZ: not stored
                x[r] = sD + r0 + r;
            }
            tile_mac<TR, TR, TW, NC, WD, WH>(acc, x, Dr + j0);
#pragma unroll
            for (int r = 0; r < TR; ++r)
                if (r0 + r < NZ) stw<TW>(sH + (r0 + r) * WH + j0, acc[r]);
        }
        for (int q = first(warps(tri_tiles<FOLD>())); q < NU * (WAB / TWA);
             q += T) {
            const int i = q / (WAB / TWA), j0 = q % (WAB / TWA) * TWA;
            scalar acc[1][TWA] = {};
            const scalar* const x[1] = {sAB + NX + 1 + i};
            tile_mac<1, 1, TWA, NX, WAB, WAB>(acc, x, PAB + j0);
            stw<TWA>(GS + i * WAB + j0, acc[0]);
        }
        group_sync();
        PROF_MARK(4);

        // ---- C: [K (Gp) d] = -Huu^{-1} [G ((F+ B)^T) rbar], a lane a
        // column; G and rbar go back into S for step D.
        constexpr int NCOL = PDP ? 2 * NX + 1 : NX + 1;
        for (int col = lane; col < NCOL; col += T) {
            scalar Lr[NU][NU], inv[NU], y[NU];
#pragma unroll
            for (int jj = 0; jj < NU; ++jj) {
                scalar sjj = sH[jj * WH + jj] + GS[jj * WAB + NX + 1 + jj];
#pragma unroll
                for (int t = 0; t < jj; ++t) sjj -= Lr[jj][t] * Lr[jj][t];
                if constexpr (sizeof(scalar) == 4) inv[jj] = rsqrtf(sjj);
                else inv[jj] = rsqrt(sjj);
                Lr[jj][jj] = sjj * inv[jj];
#pragma unroll
                for (int i = jj + 1; i < NU; ++i) {
                    scalar sij = sH[i * WH + jj] + GS[i * WAB + NX + 1 + jj];
#pragma unroll
                    for (int t = 0; t < jj; ++t) sij -= Lr[i][t] * Lr[jj][t];
                    Lr[i][jj] = sij * inv[jj];
                }
            }
#pragma unroll
            for (int i = 0; i < NU; ++i) {
                scalar acc;
                if (col < NX) {
                    acc = sH[i * WH + NU + col] + GS[i * WAB + col];
                    GS[i * WAB + col] = acc;
                } else if (PDP && col < 2 * NX) {
                    // (F+ B)[col-NX][i]: row col of [PA Pcp PB; FA Fc FB].
                    acc = PAB[col * WAB + NX + 1 + i];
                } else {
                    acc = sH[i * WH + NZ] + GS[i * WAB + NX];
                    GS[i * WAB + NX] = acc;
                }
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
                if (col < NX) {
                    KD[i * WK + col] = -y[i];
                    o[L::OK + i * NX + col] = -y[i];
                } else if (PDP && col < 2 * NX) {
                    Gp[i * X4 + col - NX] = -y[i];
                    o[L::OGP + i * NX + col - NX] = -y[i];
                } else {
                    KD[i * WK + NX] = -y[i];
                    o[L::OD + i] = -y[i];
                }
            }
            if (EXPORT && col == 0) {     // chol(Huu), zeros above the diagonal
#pragma unroll
                for (int i = 0; i < NU; ++i)
#pragma unroll
                    for (int jj = 0; jj < NU; ++jj)
                        o[L::OL + i * NU + jj] = jj <= i ? Lr[i][jj] : (scalar)0;
            }
        }
        group_sync();
        PROF_MARK(5);

        // ---- D: [P+ p+] (P+'s upper triangle, mirrored), [M v] and the
        // segment carries, in place.
        for (int q = lane; q < tri_tiles<UPPER>(); q += T) {
            int r0, j0;
            tri_tile<UPPER>(q, r0, j0);
            scalar acc[TR][TW];
#pragma unroll
            for (int r = 0; r < TR; ++r)
#pragma unroll
                for (int b = 0; b < TW; ++b)
                    acc[r][b] = r0 + r < NX && j0 + b <= NX
                        ? sH[(NU + r0 + r) * WH + NU + j0 + b] : (scalar)0;
            const scalar* xa[TR];
            const scalar* xg[TR];
#pragma unroll
            for (int r = 0; r < TR; ++r) {
                xa[r] = sAB + r0 + r;
                xg[r] = GS + r0 + r;
            }
            tile_mac<TR, TR, TW, NX, WAB, WAB>(acc, xa, PAB + j0);
            tile_mac<TR, TR, TW, NU, WAB, WK>(acc, xg, KD + j0);
#pragma unroll
            for (int r = 0; r < TR; ++r) {
                const int i = r0 + r;
#pragma unroll
                for (int b = 0; b < TW; ++b) {
                    const int jj = j0 + b;
                    if (i < NX && jj >= i && jj < NX) {
                        P[i * X4 + jj] = acc[r][b];
                        P[jj * X4 + i] = acc[r][b];
                    } else if (i < NX && jj == NX) {
                        p[i] = acc[r][b];
                    }
                }
            }
        }
        if (PDP) {    // C = C+ - (F+ B) Gp
            for (int q = first(warps(tri_tiles<UPPER>())); q < tri_tiles<CUPPER>();
                 q += T) {
                int r0, j0;
                tri_tile<CUPPER>(q, r0, j0);
                scalar acc[TR][TW];
#pragma unroll
                for (int r = 0; r < TR; ++r)
#pragma unroll
                    for (int b = 0; b < TW; ++b)
                        acc[r][b] = r0 + r < NX && j0 + b >= r0 + r && j0 + b < NX
                            ? -C[(r0 + r) * X4 + j0 + b] : (scalar)0;
                const scalar* x[TR];
#pragma unroll
                for (int r = 0; r < TR; ++r) x[r] = PAB + (NX + r0 + r) * WAB + NX + 1;
                tile_mac<TR, TR, TW, NU, 1, X4>(acc, x, Gp + j0);
#pragma unroll
                for (int r = 0; r < TR; ++r) {
                    const int i = r0 + r;
#pragma unroll
                    for (int b = 0; b < TW; ++b) {
                        const int jj = j0 + b;
                        if (i < NX && jj >= i && jj < NX) {
                            C[i * X4 + jj] = -acc[r][b];
                            C[jj * X4 + i] = -acc[r][b];
                        }
                    }
                }
            }
        }
        PROF_MARK(6);
        // [M v] = [A c] + B [K d]; K9: [F f] = [FA Fc] + (F+ B) [K d] + [0 f]
        // (rows nx .. 2nx-1 of the tiles).
        constexpr int MROWS = (EMIT_MV ? NX : 0) + (PDP ? NX : 0);
        constexpr int MBASE = EMIT_MV ? 0 : NX;       // first row's index
        constexpr int MOFF = warps(tri_tiles<UPPER>())
            + (PDP ? warps(tri_tiles<CUPPER>()) : 0);
        for (int q = first(MOFF); q < (MROWS + TR - 1) / TR * (WK / TW); q += T) {
            const int r0 = MBASE + q / (WK / TW) * TR, j0 = q % (WK / TW) * TW;
            const scalar* row[TR];
            scalar acc[TR][TW];
#pragma unroll
            for (int r = 0; r < TR; ++r) {
                row[r] = (r0 + r < NX ? sAB : PAB) + (r0 + r) * WAB;
                ldw<TW>(acc[r], row[r] + j0);
            }
            const scalar* x[TR];
#pragma unroll
            for (int r = 0; r < TR; ++r) x[r] = row[r] + NX + 1;
            tile_mac<TR, TR, TW, NU, 1, WK>(acc, x, KD + j0);
#pragma unroll
            for (int r = 0; r < TR; ++r) {
                const int i = r0 + r;
#pragma unroll
                for (int b = 0; b < TW; ++b) {
                    const int jj = j0 + b;
                    if (i < NX) {
                        if (jj < NX) o[L::OM + i * NX + jj] = acc[r][b];
                        else if (jj == NX) o[L::OV + i] = acc[r][b];
                    } else if (i < MBASE + MROWS) {
                        if (jj < NX) F[(i - NX) * X4 + jj] = acc[r][b];
                        else if (jj == NX) f[i - NX] = acc[r][b] + f[i - NX];
                    }
                }
            }
        }
        PROF_MARK(7);
        if constexpr (NARROW) widen(n + 1);   // into the slot of stage n-1
    }
    PROF_DONE
    __pipeline_wait_prior(0);
    __syncthreads();
    store(Nl - 1);
    if (PDP) {      // the carry after the segment's first stage
        carry_out<NX, NX, X4, G, NT, CW>(P0_out + cs * NX * NX * Bs, carries + L::P, Bs, b0, tid);
        carry_out<NX, NX, X4, G, NT, CW>(F0_out + cs * NX * NX * Bs, carries + L::P + NX * X4, Bs, b0, tid);
        carry_out<NX, NX, X4, G, NT, CW>(C0_out + cs * NX * NX * Bs, carries + L::C, Bs, b0, tid);
        carry_out<1, NX, 0, G, NT, CW>(p0_out + cs * NX * Bs, carries + L::PV, Bs, b0, tid);
        carry_out<1, NX, 0, G, NT, CW>(f0_out + cs * NX * Bs, carries + L::PV + X4, Bs, b0, tid);
    }
}

struct BackwardArgs {
    int N, Bt, S;
    cudaStream_t stream;
    const stage_t *A, *B, *c, *H, *h, *D, *rho, *rg;
    const scalar *PN, *pN;
    scalar *K, *d, *M, *v, *P, *L;
    const scalar *Fi, *Ci, *fi;
    scalar *Gp, *F, *P0, *p0, *F0, *C0, *f0;
};

// The narrow batch form's maps of its box regions (Regions: the streams,
// K11 its two packed ones): 1 where boxes take them (B a multiple of
// BOX_W, every region's base 16-byte aligned), 0 where its pairs go by
// cp.async, or -(a CUDA error).
template <bool PACKED>
int sweep_maps(const BackwardArgs& a, SweepMaps& maps)
{
    using Rg = Regions<PACKED>;
    const stage_t* streams[NSTREAMS] = {a.A, a.B, a.c, a.H, a.h, a.D, a.rho, a.rg};
    auto base = [&](int r) { return PACKED ? (r == 0 ? a.A : a.H) : streams[r]; };
    if (a.Bt % BOX_W) return 0;
    for (int r = 0; r < Rg::N; ++r)
        if (Rg::rows(r) > 0 && ((size_t)base(r) & 15)) return 0;
    for (int r = 0; r < Rg::N; ++r) {
        if (Rg::rows(r) == 0) continue;
        const int e = make_rows_map(&maps.m[r], base(r),
                                    (unsigned long long)a.N * Rg::rows(r), a.Bt,
                                    box_rows(Rg::rows(r)), BOX_W,
                                    (int)sizeof(stage_t));
        if (e) return -e;
    }
    return 1;
}

template <bool EMIT_MV, bool EXPORT, bool PDP, bool PACKED, bool ONE>
int launch_sweep(const BackwardArgs& a)
{
    using Fit = SweepFit<EMIT_MV, EXPORT, PDP, ONE>;
    if (!Fit::OK) return (int)cudaErrorInvalidValue;   // one instance does not fit
    const size_t smem = (size_t)Fit::BYTES;
    auto kernel = backward_kernel<EMIT_MV, EXPORT, PDP, PACKED, ONE>;
    int e = set_smem(kernel, smem);
    if (e) return e;
    SweepMaps maps = {};
    int boxes = 0;
    if constexpr (Fit::BOXES) {
        boxes = sweep_maps<PACKED>(a, maps);
        if (boxes < 0) return -boxes;
    }
    const int blocks = a.S * ((a.Bt + Fit::G - 1) / Fit::G);
    kernel<<<blocks, Fit::THREADS, smem, a.stream>>>(
        a.N, a.Bt, a.S, a.A, a.B, a.c, a.H, a.h, a.D, a.rho, a.rg, a.PN,
        a.pN, a.K, a.d, a.M, a.v, a.P, a.L, a.Fi, a.Ci, a.fi, a.Gp, a.F,
        a.P0, a.p0, a.F0, a.C0, a.f0, maps, boxes);
    return (int)cudaGetLastError();
}

// The card's SMs (the current device's, read once).
inline int sm_count()
{
    static int n = 0;
    if (n == 0) {
        int dev = 0, sms = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        n = sms > 0 ? sms : 1;
    }
    return n;
}

// Where the (segment, instance) pairs are few, groups of G would leave
// SMs idle and a warp's chain would set the time: each instance gets the
// block of one instance (the shared model's, Bt = 1).  Up to four pairs
// an SM that block was faster than groups, and as fast at 512 pairs on
// 132 SMs (K9, N=1024; PERF.md).
inline bool one_block(long long pairs) { return pairs <= 4LL * sm_count(); }

template <bool EMIT_MV, bool EXPORT, bool PDP, bool PACKED>
int launch_backward(const BackwardArgs& a)
{
    if (one_block((long long)a.S * a.Bt))
        return launch_sweep<EMIT_MV, EXPORT, PDP, PACKED, true>(a);
    return launch_sweep<EMIT_MV, EXPORT, PDP, PACKED, false>(a);
}

#else  // !NC
// ------------------------------------------ K2, K3, K10, per-instance mode
// One matrix set per scenario (every tensor has trailing size Bt).  These
// are kernels of their own, not the shared-model ones below with another
// stride: there a block stages ONE matrix set per stage in shared memory
// for all its scenarios.  K3 and K2 stage the sets of 8 scenarios a block,
// K7, K12 and K10 the sets of W scenarios a lane each (see there).  A
// narrow library (STAGE_BF16) holds K7 and K12 alone.
#ifndef STAGE_BF16

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
constexpr int K3I_MP = NX | 1;                // a slot's row of M or K
constexpr int K3I_ROW = (NX + NU) * K3I_MP + NX + NU;   // a scenario's stage
constexpr int K3I_SMEM_MAX = 232448;          // 227 KB, the most a block has
// WS * 8 + PF: the most scenarios a block (8, 4, 2, 1) with 2 to 4 stages
// in flight that 227 KB hold, else with 1.  8 and 4 at the quadrotor's
// widths; at nx=40, nu=10 a scenario's stage is 8-17 KB: 8 scenarios a
// block in float32 and 4 in float64, 2 stages in flight.
__host__ __device__ constexpr int k3i_pick()
{
    for (int pmin = 2; pmin >= 1; --pmin)
        for (int ws = 8; ws >= 1; ws /= 2)
            for (int pf = 4; pf >= pmin; --pf)
                if (((pf + 1) * K3I_ROW + 2 * NX) * ws * (int)sizeof(scalar)
                    <= K3I_SMEM_MAX)
                    return ws * 8 + pf;
    return 8 + 1;
}
constexpr int K3I_WS = k3i_pick() / 8;        // scenarios a block
constexpr int K3I_G = 32 / K3I_WS;            // threads a scenario: a warp
constexpr int K3I_THREADS = K3I_G * K3I_WS;
constexpr int K3I_RX = (NX + K3I_G - 1) / K3I_G;   // x+ rows a thread
constexpr int K3I_RU = (NU + K3I_G - 1) / K3I_G;   // u rows a thread
constexpr int K3I_PF = k3i_pick() % 8;        // stages in flight
constexpr int K3I_SLOTS = K3I_PF + 1;
// Slot (entries; each entry a row of K3I_WS words): M, K, v, d.
constexpr int K3I_M = 0;
constexpr int K3I_K = K3I_M + NX * K3I_MP;
constexpr int K3I_V = K3I_K + NU * K3I_MP;
constexpr int K3I_D = K3I_V + NX;
constexpr int K3I_SLOT = (K3I_D + NU) * K3I_WS;           // words
constexpr int K3I_SMEM_WORDS = K3I_SLOTS * K3I_SLOT + 2 * NX * K3I_WS;

// n entries of a stage block (entry e of scenario b at src[e*Bt + b]),
// source rows of C entries padded to CP in the slot, for the block's WS
// scenarios b0.. over NT threads: 16-byte copies when `vec` (the block's
// scenarios lie whole and aligned in every row), else one word a copy.
template <int C, int CP, int WS = K3I_WS, int NT = K3I_THREADS>
__device__ __forceinline__ void k3_stage(scalar* dst, const scalar* src,
                                         int n, size_t Bt, size_t b0,
                                         bool vec, int tid)
{
    if (vec) {
        constexpr int CH = 16 / (int)sizeof(scalar);      // words a copy
        constexpr int NCH = WS / CH;
#pragma unroll 1
        for (int q = tid; q < n * NCH; q += NT) {
            const int e = q / NCH, hh = q % NCH;
            const int de = (e / C) * CP + e % C;
            __pipeline_memcpy_async(dst + de * WS + hh * CH,
                                    src + e * Bt + b0 + hh * CH, 16);
        }
    } else {
#pragma unroll 1
        for (int q = tid; q < n * WS; q += NT) {
            const int e = q / WS, j = q % WS;
            const size_t b = b0 + j < Bt ? b0 + j : Bt - 1;
            const int de = (e / C) * CP + e % C;
            copy_word(dst + de * WS + j, src + e * Bt + b);
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
    const bool vec = K3I_WS % CH == 0 && Bs % CH == 0 && b0 + K3I_WS <= Bs
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

// ---- K2, per instance (plain-P or Pc mode).  Backwards from p = pN:
//   Pcp  = P_{k+1} c + p (Pc + p)   rbar = hf[:nu] + B^T Pcp
//   d    = -(L L^T)^{-1} rbar        v    = B d + c
//   p    = hf[nu:] + A^T Pcp + K^T rbar                    (the carry)
//
// What bounds it on this card is bytes: 428 words a scenario and stage in
// (A, B, K, L, P, c, hf; quadrotor widths, plain-P mode), 16 out.  A
// thread a scenario that loads its own stage (the first design) waits out
// device-memory latency on every entry of the chain, and a batch of 1,024
// is 16 blocks on 16 SMs.  Here a block serves WS consecutive
// scenarios with warps in roles:
//   * K2I_PW producer warps copy each stage of the block's scenarios
//     into a ring of SLOTS shared-memory slots (cp.async: consecutive
//     lanes on consecutive scenarios of one entry, 16 bytes a copy where
//     the batch and the pointers allow, a word otherwise; K3's slot
//     layout, the rows of P and B that a lane reads by rows padded to an
//     odd length so that a scenario's lanes read on distinct banks);
//   * one warp computes: K2I_G lanes a scenario, each owning a block of
//     K2I_RX rows of p.  The chain a stage is only Pcp = Pc + p (its rows
//     gathered by __shfl_sync within the scenario's lanes), rbar and p;
//     P_{k+1} c_k of the next stage is formed ahead of it and d, v and
//     their stores behind it, where they fill the chain's latency.
// A shared-memory barrier a slot (`full`: the producer's copies landed;
// `empty`: the compute warp is done with it) hands the stages on.  A
// scenario past the batch reads the last one's data and stores nothing.
constexpr int K2I_G = 4;                      // lanes a scenario
constexpr int K2I_WS_MAX = 32 / K2I_G;        // scenarios a block, at most
// Producer warps: two copy a stage in 0.57 ms at B=1024 against 0.82 for
// one; three and four were no faster (an H100, PERF.md).
constexpr int K2I_PW = 2;
constexpr int K2I_THREADS = 32 * (K2I_PW + 1);
constexpr int K2I_RX = (NX + K2I_G - 1) / K2I_G;   // rows of p a lane
constexpr int K2I_SLOTS_MAX = 4;              // stages in flight + 1
constexpr int K2I_SMEM_MAX = 232448;          // 227 KB, the most a block has
// WS * 8 + SLOTS for a scenario's stage of `row` words: the most scenarios
// a block (8, 4, 2, 1) with 3 or 4 slots that 227 KB hold, else with 2.
// At nx=40, nu=10 a scenario's stage is 21-34 KB in float64: two scenarios
// a block (the lanes of the other six idle); four in float32.
__host__ __device__ constexpr int k2i_pick(int row)
{
    for (int smin = 3; smin >= 2; --smin)
        for (int ws = K2I_WS_MAX; ws >= 1; ws /= 2)
            for (int slots = K2I_SLOTS_MAX; slots >= smin; --slots)
                if (slots * (row * ws * (int)sizeof(scalar) + 16) <= K2I_SMEM_MAX)
                    return ws * 8 + slots;
    return 8 + 2;
}
constexpr int K2I_XP = NX | 1;                // a slot's row of P
constexpr int K2I_UP = NU | 1;                // a slot's row of B
// Slot (entries, each a row of WS words): A, B, K, L, then P (plain-P
// mode) or Pc, c, hf.
template <bool PC_MODE> struct K2ILayout {
    static constexpr int A = 0;
    static constexpr int B = A + NX * NX;
    static constexpr int K = B + NX * K2I_UP;
    static constexpr int L = K + NU * NX;
    static constexpr int P = L + NU * NU;
    static constexpr int C = P + (PC_MODE ? NX : NX * K2I_XP);
    static constexpr int HF = C + NX;
    static constexpr int PICK = k2i_pick(HF + NZ);
    static constexpr int WS = PICK / 8;                         // scenarios
    static constexpr int SLOTS = PICK % 8;
    static constexpr int SLOT = (HF + NZ) * WS;                 // words
    static constexpr int SMEM = SLOTS * SLOT * (int)sizeof(scalar)
        + 2 * 8 * SLOTS;                                         // bytes
};

template <bool PC_MODE>
__global__ void __launch_bounds__(K2I_THREADS)
backward_vectors_kernel(
    int N, int Bt,
    const scalar* __restrict__ A, const scalar* __restrict__ B,
    const scalar* __restrict__ c, const scalar* __restrict__ hf,
    const scalar* __restrict__ P, const scalar* __restrict__ K,
    const scalar* __restrict__ L, const scalar* __restrict__ pN,
    scalar* __restrict__ d_out, scalar* __restrict__ v_out)
{
    using Lay = K2ILayout<PC_MODE>;
    constexpr int K2I_WS = Lay::WS, K2I_SLOTS = Lay::SLOTS;
    extern __shared__ double smem_aligned[];
    scalar* ring = reinterpret_cast<scalar*>(smem_aligned);
    mbar_t* full = reinterpret_cast<mbar_t*>(ring + K2I_SLOTS * Lay::SLOT);
    mbar_t* empty = full + K2I_SLOTS;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const size_t Bs = (size_t)Bt;
    const size_t b0 = (size_t)blockIdx.x * K2I_WS;

    if (threadIdx.x == 0) {
        for (int s = 0; s < K2I_SLOTS; ++s) {
            mbar_init(&full[s], 32 * K2I_PW);    // the producers' lanes
            mbar_init(&empty[s], 32);            // the compute warp's
        }
    }
    __syncthreads();

    // Stage n of the sweep is model stage k = N-1-n, in slot n % K2I_SLOTS.
    if (warp < K2I_PW) {
        const int tp = threadIdx.x;              // thread of the producers
        constexpr size_t CH = 16 / sizeof(scalar);
        const bool vec = K2I_WS % CH == 0 && Bs % CH == 0 && b0 + K2I_WS <= Bs
            && (((size_t)A | (size_t)B | (size_t)c | (size_t)hf | (size_t)P
                 | (size_t)K | (size_t)L) & 15) == 0;
        PROF_INIT_AT(blockIdx.x == 0 && tp == 0)
#pragma unroll 1
        for (int n = 0; n < N; ++n) {
            const int s = n % K2I_SLOTS;
            if (n >= K2I_SLOTS) mbar_wait(&empty[s], (n / K2I_SLOTS - 1) & 1);
            PROF_MARK(4);
            const size_t ks = (size_t)(N - 1 - n);
            scalar* S = ring + s * Lay::SLOT;
            constexpr int WS = K2I_WS, NT = 32 * K2I_PW;
            k3_stage<NX, NX, WS, NT>(S + Lay::A * WS, A + ks * NX * NX * Bs,
                                     NX * NX, Bs, b0, vec, tp);
            k3_stage<NU, K2I_UP, WS, NT>(S + Lay::B * WS,
                                         B + ks * NX * NU * Bs, NX * NU, Bs,
                                         b0, vec, tp);
            k3_stage<NX, NX, WS, NT>(S + Lay::K * WS, K + ks * NU * NX * Bs,
                                     NU * NX, Bs, b0, vec, tp);
            k3_stage<NU, NU, WS, NT>(S + Lay::L * WS, L + ks * NU * NU * Bs,
                                     NU * NU, Bs, b0, vec, tp);
            if (PC_MODE)
                k3_stage<NX, NX, WS, NT>(S + Lay::P * WS, P + ks * NX * Bs,
                                         NX, Bs, b0, vec, tp);
            else
                k3_stage<NX, K2I_XP, WS, NT>(S + Lay::P * WS,
                                             P + ks * NX * NX * Bs, NX * NX,
                                             Bs, b0, vec, tp);
            k3_stage<NX, NX, WS, NT>(S + Lay::C * WS, c + ks * NX * Bs, NX,
                                     Bs, b0, vec, tp);
            k3_stage<NZ, NZ, WS, NT>(S + Lay::HF * WS, hf + ks * NZ * Bs, NZ,
                                     Bs, b0, vec, tp);
            mbar_arrive_on_copies(&full[s]);
            PROF_MARK(5);
        }
        PROF_DONE_RANGE(4, 6)
        return;
    }

    // A group of lanes past the block's WS scenarios (a wide model's
    // block) computes the last one's numbers and stores nothing.
    const int j = lane / K2I_G < K2I_WS ? lane / K2I_G : K2I_WS - 1;
    const int g = lane % K2I_G;                  // lane of the scenario
    const size_t b = b0 + j;
    const bool valid = b < Bs && lane / K2I_G < K2I_WS;
    const size_t bc = b < Bs ? b : Bs - 1;
    // Entry e of this scenario in slot S.
    auto at = [&](const scalar* S, int e) { return S[e * K2I_WS + j]; };
    // This lane's rows i = g*K2I_RX + r of Pc, for the stage in slot S.
    auto fold = [&](const scalar* S, scalar (&out)[K2I_RX]) {
#pragma unroll
        for (int r = 0; r < K2I_RX; ++r) {
            const int i = g * K2I_RX + r;
            if (i < NX) {
                if (PC_MODE) {
                    out[r] = at(S, Lay::P + i);
                } else {
                    scalar acc = at(S, Lay::P + i * K2I_XP) * at(S, Lay::C);
#pragma unroll
                    for (int t = 1; t < NX; ++t)
                        acc += at(S, Lay::P + i * K2I_XP + t) * at(S, Lay::C + t);
                    out[r] = acc;
                }
            }
        }
    };

    scalar p[K2I_RX], pc[K2I_RX];
#pragma unroll
    for (int r = 0; r < K2I_RX; ++r) {
        const int i = g * K2I_RX + r;
        p[r] = i < NX ? pN[i * Bs + bc] : (scalar)0;
        pc[r] = (scalar)0;
    }
    mbar_wait(&full[0], 0);
    fold(ring, pc);
    PROF_INIT_AT(blockIdx.x == 0 && threadIdx.x == 32 * K2I_PW)
#pragma unroll 1
    for (int n = 0; n < N; ++n) {
        const size_t ks = (size_t)(N - 1 - n);
        const int s = n % K2I_SLOTS;
        const scalar* S = ring + s * Lay::SLOT;
        const scalar* S1 = ring + ((n + 1) % K2I_SLOTS) * Lay::SLOT;
        if (n + 1 < N) mbar_wait(&full[(n + 1) % K2I_SLOTS],
                                 ((n + 1) / K2I_SLOTS) & 1);
        PROF_MARK(0);

        // The chain: Pcp (gathered over the scenario's lanes), rbar, p.
        scalar own[K2I_RX], x[NX], rbar[NU];
#pragma unroll
        for (int r = 0; r < K2I_RX; ++r) own[r] = pc[r] + p[r];
#pragma unroll
        for (int r = 0; r < K2I_RX; ++r) {
#pragma unroll
            for (int q = 0; q < K2I_G; ++q) {
                const int t = q * K2I_RX + r;
                const scalar y = __shfl_sync(0xffffffffu, own[r], q, K2I_G);
                if (t < NX) x[t] = y;
            }
        }
#pragma unroll
        for (int u = 0; u < NU; ++u) {
            scalar acc = at(S, Lay::HF + u);
#pragma unroll
            for (int t = 0; t < NX; ++t)
                acc += at(S, Lay::B + t * K2I_UP + u) * x[t];
            rbar[u] = acc;
        }
#pragma unroll
        for (int r = 0; r < K2I_RX; ++r) {
            const int i = g * K2I_RX + r;
            if (i < NX) {
                scalar acc = at(S, Lay::HF + NU + i);
#pragma unroll
                for (int t = 0; t < NX; ++t) acc += at(S, Lay::A + t * NX + i) * x[t];
#pragma unroll
                for (int u = 0; u < NU; ++u) acc += at(S, Lay::K + u * NX + i) * rbar[u];
                p[r] = acc;
            }
        }
        PROF_MARK(1);
        // Ahead of the chain: the next stage's Pc.
        if (n + 1 < N) fold(S1, pc);
        PROF_MARK(2);

        // Behind it: d = -(L L^T)^{-1} rbar (every lane), v on own rows.
        scalar dv[NU], inv[NU];
#pragma unroll
        for (int i = 0; i < NU; ++i) inv[i] = (scalar)1 / at(S, Lay::L + i * NU + i);
#pragma unroll
        for (int i = 0; i < NU; ++i) {
            scalar acc = rbar[i];
#pragma unroll
            for (int t = 0; t < i; ++t) acc -= at(S, Lay::L + i * NU + t) * dv[t];
            dv[i] = acc * inv[i];
        }
#pragma unroll
        for (int i = NU - 1; i >= 0; --i) {
            scalar acc = dv[i];
#pragma unroll
            for (int t = i + 1; t < NU; ++t) acc -= at(S, Lay::L + t * NU + i) * dv[t];
            dv[i] = acc * inv[i];
        }
#pragma unroll
        for (int i = 0; i < NU; ++i) {
            dv[i] = -dv[i];
            if (i % K2I_G == g && valid) d_out[(ks * NU + i) * Bs + b] = dv[i];
        }
#pragma unroll
        for (int r = 0; r < K2I_RX; ++r) {
            const int i = g * K2I_RX + r;
            if (i < NX) {
                scalar acc = at(S, Lay::C + i);
#pragma unroll
                for (int t = 0; t < NU; ++t) acc += at(S, Lay::B + i * K2I_UP + t) * dv[t];
                if (valid) v_out[(ks * NX + i) * Bs + b] = acc;
            }
        }
        mbar_arrive(&empty[s]);
        PROF_MARK(3);
    }
    PROF_DONE_RANGE(0, 4)
}

// --------------------------------------------- K2 / K3, shared-model mode
// One model, Bt scenarios: the matrices carry trailing size 1.  What
// bounds both kernels on this card is bytes (the per-scenario streams),
// but what a plain one-thread-per-scenario loop runs into first is
// latency: a serving batch of a few thousand scenarios is a few thousand
// threads, one warp per SM, and every stage waits for its own loads.
// K3's design:
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
// K2 splits its stage between warps in roles instead (below).

// ---- K2, shared model.  The wrapper packs each stage's matrices into one
// run, laid out for the reads below: A^T [i][t], B^T [j][t], B [i][t],
// K^T [i][t], L [i][t], then (plain-P mode) P [i][j].
//
// The carry p needs only Pcp, rbar and p; d, v and their stores hang off
// it.  So the warps take roles on 32 scenarios a block (a lane each), as
// K5 does (admm_kernels.cu): warp 0, the producer, copies the pack (16
// bytes a copy where it allows) and the scenarios' rows (whole lines)
// into a ring of K2S_SLOTS slots; warp 1, the chain, carries p in
// registers (no exchange: a lane holds its scenario's whole stage), reads
// A^T, B^T and K^T as broadcasts and leaves rbar in the slot; the
// K2S_TAILS tail warps take whole stages behind it, solve d, form v and
// store both (a warp's store is one line).  Shared-memory barriers hand
// the slots on (full, ready, empty: hopper_sync.cuh); no block-wide
// barrier a stage.
constexpr int K2_AT = 0;
constexpr int K2_BT = K2_AT + NX * NX;
constexpr int K2_B = K2_BT + NU * NX;
constexpr int K2_KT = K2_B + NX * NU;
constexpr int K2_L = K2_KT + NX * NU;
constexpr int K2_P = K2_L + NU * NU;
constexpr int K2S_W = 32;                     // scenarios a block, a lane each
constexpr int K2S_TAILS = 2;                  // tail warps
constexpr int K2S_THREADS = 32 * (2 + K2S_TAILS);
constexpr int K2S_SLOTS_MAX = K2S_TAILS + 4;
constexpr int K2S_SMEM_MAX = 232448;          // 227 KB, the most a block has
                                              // (admm_kernels.cu)
template <bool PC_MODE> struct K2SLayout {
    static constexpr int PACK = K2_P + (PC_MODE ? 0 : NX * NX);
    // Slot (words): the pack (from a 16-byte boundary), then rows of K2S_W
    // words: c, hf, (Pc mode) Pc, and the chain's rbar.
    static constexpr int C = (PACK + 3) / 4 * 4;
    static constexpr int HF = C + NX * K2S_W;
    static constexpr int PC = HF + NZ * K2S_W;
    static constexpr int RB = PC + (PC_MODE ? NX * K2S_W : 0);
    static constexpr int SLOT = RB + NU * K2S_W;
    // As many slots as 227 KB hold, up to K2S_SLOTS_MAX: at nx=40, nu=10
    // in float64 a slot is 59-72 KB and three fit.  No fewer than the tail
    // warps (see K5's note: a parity wait two phases ahead passes at once).
    static constexpr int FIT = (K2S_SMEM_MAX - 128) / (SLOT * (int)sizeof(scalar) + 3 * 8);
    static constexpr int SLOTS = FIT < K2S_SLOTS_MAX ? FIT : K2S_SLOTS_MAX;
    static_assert(SLOTS >= K2S_TAILS, "K2 shared: a slot per tail warp does not fit");
    static constexpr int SMEM = SLOTS * SLOT * (int)sizeof(scalar)
        + 3 * 8 * SLOTS;                                         // bytes
};

template <bool PC_MODE>
__global__ void __launch_bounds__(K2S_THREADS)
backward_vectors_shared_kernel(
    int N, int Bt,
    const scalar* __restrict__ pack, const scalar* __restrict__ c,
    const scalar* __restrict__ hf, const scalar* __restrict__ Pc,
    const scalar* __restrict__ pN,
    scalar* __restrict__ d_out, scalar* __restrict__ v_out)
{
    using Lay = K2SLayout<PC_MODE>;
    extern __shared__ double smem_aligned[];
    scalar* ring = reinterpret_cast<scalar*>(smem_aligned);
    constexpr int K2S_SLOTS = Lay::SLOTS;
    mbar_t* full = reinterpret_cast<mbar_t*>(ring + K2S_SLOTS * Lay::SLOT);
    mbar_t* ready = full + K2S_SLOTS;
    mbar_t* empty = ready + K2S_SLOTS;

    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const size_t Bs = (size_t)Bt;
    const size_t b0 = (size_t)blockIdx.x * K2S_W;
    const size_t b = b0 + lane;
    const bool valid = b < Bs;

    if (threadIdx.x == 0) {
        for (int s = 0; s < K2S_SLOTS; ++s) {
            mbar_init(&full[s], 32);             // the producer's lanes
            mbar_init(&ready[s], 32);            // the chain's
            mbar_init(&empty[s], 32);            // the stage's tail warp's
        }
    }
    __syncthreads();

    // Stage n of the sweep is model stage k = N-1-n, in slot n % K2S_SLOTS.
    if (warp == 0) {
        constexpr size_t VW = 16 / sizeof(scalar);
        const bool vec = Bs % VW == 0 && b0 + K2S_W <= Bs
            && (((size_t)c | (size_t)hf | (size_t)Pc) & 15) == 0;
        PROF_INIT_AT(blockIdx.x == 0 && lane == 0)
#pragma unroll 1
        for (int n = 0; n < N; ++n) {
            const int s = n % K2S_SLOTS;
            if (n >= K2S_SLOTS) mbar_wait(&empty[s], (n / K2S_SLOTS - 1) & 1);
            PROF_MARK(0);
            const size_t ks = (size_t)(N - 1 - n);
            scalar* S = ring + s * Lay::SLOT;
            warp_copy_run(S, pack + ks * Lay::PACK, Lay::PACK, lane);
            warp_copy_rows<K2S_W>(S + Lay::C, c + ks * NX * Bs, NX, Bs, b0,
                                  vec, lane);
            warp_copy_rows<K2S_W>(S + Lay::HF, hf + ks * NZ * Bs, NZ, Bs, b0,
                                  vec, lane);
            if (PC_MODE)
                warp_copy_rows<K2S_W>(S + Lay::PC, Pc + ks * NX * Bs, NX, Bs,
                                      b0, vec, lane);
            mbar_arrive_on_copies(&full[s]);
            PROF_MARK(1);
        }
        PROF_DONE_RANGE(0, 2)
    } else if (warp == 1) {
        // ---- chain: p, rbar left in the slot.
        const size_t bc = valid ? b : Bs - 1;
        scalar p[NX];
#pragma unroll
        for (int i = 0; i < NX; ++i) p[i] = pN[i * Bs + bc];
        PROF_INIT_AT(blockIdx.x == 0 && lane == 0)
#pragma unroll 1
        for (int n = 0; n < N; ++n) {
            const int s = n % K2S_SLOTS;
            mbar_wait(&full[s], (n / K2S_SLOTS) & 1);
            PROF_MARK(2);
            scalar* S = ring + s * Lay::SLOT;
            const scalar* cv = S + Lay::C + lane;
            const scalar* hv = S + Lay::HF + lane;
            // Rows of the pack read 16 bytes a load where the widths allow.
            constexpr int VW = 16 / (int)sizeof(scalar);
            constexpr bool VR = NX % VW == 0 && NU % VW == 0;
            scalar Pcp[NX], rbar[NU];
#pragma unroll
            for (int i = 0; i < NX; ++i) {
                scalar acc;
                if (PC_MODE) {
                    acc = S[Lay::PC + i * K2S_W + lane];
                } else {
                    scalar row[NX];
                    ld_row<NX, VR>(row, S + K2_P + i * NX);
                    acc = (scalar)0;
#pragma unroll
                    for (int t = 0; t < NX; ++t) acc += row[t] * cv[t * K2S_W];
                }
                Pcp[i] = acc + p[i];
            }
#pragma unroll
            for (int u = 0; u < NU; ++u) {
                scalar row[NX];
                ld_row<NX, VR>(row, S + K2_BT + u * NX);
                scalar acc = hv[u * K2S_W];
#pragma unroll
                for (int t = 0; t < NX; ++t) acc += row[t] * Pcp[t];
                rbar[u] = acc;
            }
#pragma unroll
            for (int i = 0; i < NX; ++i) {
                scalar ra[NX], rk[NU];
                ld_row<NX, VR>(ra, S + K2_AT + i * NX);
                ld_row<NU, VR>(rk, S + K2_KT + i * NU);
                scalar acc = hv[(NU + i) * K2S_W];
#pragma unroll
                for (int t = 0; t < NX; ++t) acc += ra[t] * Pcp[t];
#pragma unroll
                for (int u = 0; u < NU; ++u) acc += rk[u] * rbar[u];
                p[i] = acc;
            }
            // rbar into the slot last: a store there before the loads of
            // the p rows would hold them behind it (they might alias).
#pragma unroll
            for (int u = 0; u < NU; ++u) S[Lay::RB + u * K2S_W + lane] = rbar[u];
            mbar_arrive(&ready[s]);
            PROF_MARK(3);
        }
        PROF_DONE_RANGE(2, 4)
    } else {
        // ---- tail warp t: stages t, t + K2S_TAILS, ...: d and v.
        const int t = warp - 2;
        PROF_INIT_AT(blockIdx.x == 0 && lane == 0 && t == 0)
#pragma unroll 1
        for (int n = t; n < N; n += K2S_TAILS) {
            const int s = n % K2S_SLOTS;
            mbar_wait(&ready[s], (n / K2S_SLOTS) & 1);
            PROF_MARK(4);
            const size_t ks = (size_t)(N - 1 - n);
            const scalar* S = ring + s * Lay::SLOT;
            scalar dv[NU], inv[NU];
#pragma unroll
            for (int i = 0; i < NU; ++i) inv[i] = (scalar)1 / S[K2_L + i * NU + i];
#pragma unroll
            for (int i = 0; i < NU; ++i) {
                scalar acc = S[Lay::RB + i * K2S_W + lane];
#pragma unroll
                for (int q = 0; q < i; ++q) acc -= S[K2_L + i * NU + q] * dv[q];
                dv[i] = acc * inv[i];
            }
#pragma unroll
            for (int i = NU - 1; i >= 0; --i) {
                scalar acc = dv[i];
#pragma unroll
                for (int q = i + 1; q < NU; ++q) acc -= S[K2_L + q * NU + i] * dv[q];
                dv[i] = acc * inv[i];
            }
#pragma unroll
            for (int i = 0; i < NU; ++i) {
                dv[i] = -dv[i];
                if (valid) d_out[(ks * NU + i) * Bs + b] = dv[i];
            }
#pragma unroll
            for (int i = 0; i < NX; ++i) {
                scalar vv = S[Lay::C + i * K2S_W + lane];
#pragma unroll
                for (int q = 0; q < NU; ++q) vv += S[K2_B + i * NU + q] * dv[q];
                if (valid) v_out[(ks * NX + i) * Bs + b] = vv;
            }
            mbar_arrive(&empty[s]);
            PROF_MARK(5);
        }
        PROF_DONE_SCALED(4, 6, N, (N + K2S_TAILS - 1) / K2S_TAILS)
    }
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

#endif  // STAGE_BF16

// ---- K7, per-instance rollout from the raw dynamics: u = K x + d,
// ws_k = [u; x], x+ = A x + B u + c, every matrix per scenario (trailing
// size Bt).  What bounds it on this card is bytes: 256 words a scenario
// and stage in at the quadrotor's widths (A 144, B 48, c 12, K 48, d 4)
// and 16 out, 0.68 ms at N=512, B=4096 in float32; its arithmetic (240
// FMAs a scenario and stage) is far below that.  So it is a streaming
// problem, and what a loop that loads each stage when it reaches it runs
// into is latency: one stage in flight, each paying a loaded DRAM
// latency.  The warps of a block take roles on W consecutive scenarios
// (a lane each; W = 32 where the ring holds three slots of them, fewer at
// wide models: RoFit):
//   * RO_PRODUCERS producer warps put whole stages into a ring of
//     RoFit::SLOTS slots ahead of the chain: each stream a (rows, W) box
//     of the copy engine (TMA; a stream taller than a box's 256 rows in
//     several), the streams dealt over the warps (a copy-engine
//     instruction costs its warp 140-460 cycles, and they queue behind
//     each other on one warp: PERF.md).  Where the rows are not
//     whole 16-byte pieces (or a stream is not 16-byte aligned) the copy
//     engine refuses them, and the producers copy a word a copy
//     (cp.async);
//   * the chain warp keeps x in registers, reads K, d, A, B and c from the
//     slot (row r of a stage at r*W + lane: a warp reads W consecutive
//     words, no bank conflict), computes u, then x+ (the rows' sums
//     independent of each other), frees the slot and writes [u; x] into
//     a small out-ring;
//   * the store warp writes the out-ring to ws, a row a store (a line in
//     float32).  The chain itself stores only xN, after the last stage.
// Shared-memory barriers hand the slots on (full, empty; the out-ring's
// ofull, oempty: hopper_sync.cuh); no block-wide barrier a stage.  A lane
// past the batch computes on zeros (the copy engine's) or the last
// scenario's rows and stores nothing.  Measured on an H100 (PERF.md):
// 80-84 % of the byte bound, held by the copies (every slot in flight, the
// chain waiting on `full`).
//
// PACKED (K12): A, B, c are the row blocks of one packed stream Sd = (A |
// B | c), and K, d of G = (K | d), K11's output: two streams a stage
// instead of five, lying in the slot where K7's do; only the producers'
// boxes differ.
//
// NARROW (bfloat16 A, B, c or Sd; K, d and G in the compute type): the
// dynamics' rows stay 2 bytes an entry in the slot (boxes of a bfloat16
// map, half the bytes a row), so one slot holds two entry sizes, each
// stream's rows from a 128-byte boundary; the chain widens an entry where
// it reads it (a lane a scenario: one conversion an entry, no pass of its
// own).  A box row is then W * 2 bytes: W a multiple of 8 (RoFit).  Where
// the copy engine does not take the rows (a batch that is no multiple of
// 8), no copy moves 2 bytes: the kernel's PAIRS form copies the W/2 + 1
// aligned 4-byte pairs that cover a row's W scenarios into a slot row of
// W + 2 entries, and the chain reads its scenario at o(r) + lane, o(r) = 1
// where the row starts in a pair's second half (every other row of an odd
// batch).  The stream's last entry, where it ends mid-pair, comes by a
// copy that fills the pair's other half with zero.
constexpr int RO_PRODUCERS = 2;
constexpr int RO_THREADS = 32 * (2 + RO_PRODUCERS);   // chain, store, producers
constexpr int RO_OSLOTS = 4;                 // the out-ring's slots
constexpr int RO_SLOTS_MAX = 8;
constexpr int RO_SMEM_MAX = 232448;          // 227 KB, the most a block has
constexpr int RO_BOX_MAX = 256;              // the copy engine's rows a box

// The streams of a stage and their rows: K7's A, B, c, K, d; K12's Sd, G.
__host__ __device__ constexpr int ro_streams(bool packed)
{
    return packed ? 2 : 5;
}
__host__ __device__ constexpr int ro_rows(bool packed, int q)
{
    return packed ? (q == 0 ? NX * (NX + NU + 1) : NU * NX + NU)
        : q == 0 ? NX * NX : q == 1 ? NX * NU : q == 2 ? NX
        : q == 3 ? NU * NX : NU;
}
// Stream q holds stage data (A, B, c; Sd: stage_t) or gains (the compute
// type), and the bytes of its entries.
__host__ __device__ constexpr bool ro_stage(bool packed, int q)
{
    return packed ? q == 0 : q < 3;
}
__host__ __device__ constexpr int ro_esz(bool packed, int q)
{
    return ro_stage(packed, q) ? (int)sizeof(stage_t) : (int)sizeof(scalar);
}
// Rows of w entries of e bytes rounded up to whole 128-byte pieces (a box
// lands on a 128-byte boundary).  (The PAIRS form: stage rows of w + 2.)
__host__ __device__ constexpr int ro_up(int rows, int w, int e)
{
    const int a = 128 / (w * e);
    return a > 1 ? (rows + a - 1) / a * a : rows;
}
// A stream of `rows` rows a stage goes as ro_boxes boxes of ro_box rows
// of w entries, each whole 128-byte pieces (the last may reach past the
// stream's rows: its slot keeps ro_span).
__host__ __device__ constexpr int ro_boxes(int rows)
{
    return (rows + RO_BOX_MAX - 1) / RO_BOX_MAX;
}
__host__ __device__ constexpr int ro_box(int rows, int w, int e)
{
    return ro_up((rows + ro_boxes(rows) - 1) / ro_boxes(rows), w, e);
}
__host__ __device__ constexpr int ro_span(int rows, int w, int e)
{
    return ro_boxes(rows) * ro_box(rows, w, e);
}
// The bytes of stream q's rows of a stage in a slot: boxes of w, or
// (pairs) stage rows of w + 2 entries.
__host__ __device__ constexpr int ro_bytes(bool packed, int q, int w,
                                           bool pairs)
{
    const int rows = ro_rows(packed, q), e = ro_esz(packed, q);
    return pairs && ro_stage(packed, q) ? rows * (w + 2) * e
                                        : ro_span(rows, w, e) * w * e;
}
// The first byte of stream q in a slot (q = ro_streams: a slot's bytes),
// each stream from a 128-byte boundary.
__host__ __device__ constexpr int ro_off(bool packed, int q, int w,
                                         bool pairs)
{
    int off = 0;
    for (int i = 0; i < q; ++i)
        off = (off + ro_bytes(packed, i, w, pairs) + 127) / 128 * 128;
    return off;
}
__host__ __device__ constexpr int ro_owner(int q) { return q % RO_PRODUCERS; }
// Slots of w scenarios (and two barriers each) beside the out-ring.
__host__ __device__ constexpr int ro_fit(bool packed, int w, bool pairs)
{
    constexpr int SZ = (int)sizeof(scalar);
    return (RO_SMEM_MAX - 128 - RO_OSLOTS * (ro_up(NZ, w, SZ) * w * SZ + 16))
        / (ro_off(packed, ro_streams(packed), w, pairs) + 16);
}
// W: the widest of 32, 16, 8 and 4 scenarios (narrow: 8 at least, a box
// row of 16 bytes) whose ring holds 3 slots, else 2.
__host__ __device__ constexpr int ro_pick(bool packed, bool pairs)
{
    constexpr int least_w = NARROW ? 8 : 4;
    for (int least = 3; least >= 2; --least)
        for (int w = 32; w >= least_w; w /= 2)
            if (ro_fit(packed, w, pairs) >= least) return w;
    return least_w;
}
template <bool PACKED, bool PAIRS> struct RoFit {
    static constexpr int NS = ro_streams(PACKED);
    static constexpr int W = ro_pick(PACKED, PAIRS);
    static constexpr int SLOTS = ro_fit(PACKED, W, PAIRS) < RO_SLOTS_MAX
        ? ro_fit(PACKED, W, PAIRS) : RO_SLOTS_MAX;
    static constexpr int SLOT = ro_off(PACKED, NS, W, PAIRS);   // bytes
    static constexpr int OSLOT = ro_up(NZ, W, (int)sizeof(scalar)) * W;
    // The entries of a stage row (A, B, c) in a slot.
    static constexpr int RW = PAIRS ? W + 2 : W;
    // The bytes of A, B, c (stage_t) and K, d (scalar) in a slot.
    static constexpr int ES = (int)sizeof(stage_t), SZ = (int)sizeof(scalar);
    static constexpr int A = 0;
    static constexpr int B = PACKED ? NX * NX * RW * ES
                                    : ro_off(false, 1, W, PAIRS);
    static constexpr int C = PACKED ? (NX * NX + NX * NU) * RW * ES
                                    : ro_off(false, 2, W, PAIRS);
    static constexpr int K = ro_off(PACKED, PACKED ? 1 : 3, W, PAIRS);
    static constexpr int D = PACKED ? K + NU * NX * W * SZ
                                    : ro_off(false, 4, W, PAIRS);
    static constexpr int OUT = SLOTS * SLOT;   // the out-ring (bytes)
    static constexpr int BAR = OUT + RO_OSLOTS * OSLOT * SZ;
    static constexpr int SMEM = BAR + 8 * 2 * (SLOTS + RO_OSLOTS) + 128;
    static_assert(SLOTS >= 2, "K7/K12: two stages of the least W do not fit");
    static_assert(W * ES % 16 == 0 && W * SZ % 16 == 0, "K7/K12: a box row");
    static_assert(!PAIRS || NARROW, "K7/K12: pairs are of 2-byte entries");
};
// The streams (the word-copy path) and the copy engine's maps of them.
template <bool PACKED> struct RoSrc { const void* p[ro_streams(PACKED)]; };
template <bool PACKED> struct RoMaps { CUtensorMap m[ro_streams(PACKED)]; };

// The PAIRS form, a producer lane's part of one stream's `rows` rows (row
// r of scenario b0 at src[r*Bt]) into the slot's rows of W + 2 entries
// (dst): item t = (row t / NP, pair j = t % NP) the aligned pair at
// scenario 2j - o of the row (o = 1 where the row starts in a pair's
// second half) into entries 2j, 2j + 1.  A pair at or past `end` (the
// stream's end) is not read past it: its half there is zero, or the pair
// is left out (scenarios past the batch, which no lane stores).
template <int W>
__device__ __forceinline__ void ro_pairs(stage_t* dst, const stage_t* src,
                                         const stage_t* end, int rows,
                                         size_t Bt, int lane)
{
    constexpr int NP = W / 2 + 1;
#pragma unroll 1
    for (int t = lane; t < rows * NP; t += 32) {
        const int r = t / NP, j = t % NP;
        const stage_t* first = src + r * Bt;
        const stage_t* p = first - (((size_t)first >> 1) & 1) + 2 * j;
        if (p + 1 < end)
            __pipeline_memcpy_async(dst + r * (W + 2) + 2 * j, p, 4);
        else if (p < end)
            __pipeline_memcpy_async(dst + r * (W + 2) + 2 * j, p, 4, 2);
    }
}

template <bool PACKED, bool PAIRS>
__global__ void __launch_bounds__(RO_THREADS, 1)
forward_rollout_kernel(
    int N, int Bt, const RoSrc<PACKED> src, const scalar* __restrict__ x0,
    scalar* __restrict__ ws, scalar* __restrict__ xN,
    const __grid_constant__ RoMaps<PACKED> maps, int tma)
{
    using Fit = RoFit<PACKED, PAIRS>;
    constexpr int W = Fit::W, SLOTS = Fit::SLOTS, RW = Fit::RW;
    extern __shared__ double smem_aligned[];
    char* base = reinterpret_cast<char*>(
        (reinterpret_cast<size_t>(smem_aligned) + 127) / 128 * 128);
    char* ring = base;
    scalar* oring = reinterpret_cast<scalar*>(base + Fit::OUT);
    mbar_t* full = reinterpret_cast<mbar_t*>(base + Fit::BAR);
    mbar_t* empty = full + SLOTS;
    mbar_t* ofull = empty + SLOTS;
    mbar_t* oempty = ofull + RO_OSLOTS;

    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int col = lane < W ? lane : W - 1;     // lanes past W shadow the last
    const size_t Bs = (size_t)Bt;
    const size_t b0 = (size_t)blockIdx.x * W;
    const size_t b = b0 + col;
    const bool mine = lane < W && b < Bs;        // stores its scenario's rows

    if (threadIdx.x == 0) {
        for (int s = 0; s < SLOTS; ++s) {
            mbar_init(&full[s], 33 * RO_PRODUCERS);   // each producer's
                                                 // lanes, and its lane 0's
                                                 // with the bytes it expects
            mbar_init(&empty[s], 32);            // the chain's
        }
        for (int o = 0; o < RO_OSLOTS; ++o) {
            mbar_init(&ofull[o], 32);            // the chain's
            mbar_init(&oempty[o], 32);           // the store warp's
        }
    }
    __syncthreads();

    // Stage n in slot n % SLOTS and out slot n % RO_OSLOTS.
    if (warp >= 2) {
        // ---- producer warp pw: its streams of each stage.
        const int pw = warp - 2;
        int tx = 0;                              // the bytes of its boxes
#pragma unroll
        for (int q = 0; q < Fit::NS; ++q)
            if (ro_owner(q) == pw)
                tx += ro_span(ro_rows(PACKED, q), W, ro_esz(PACKED, q)) * W
                    * ro_esz(PACKED, q);
        PROF_INIT_AT(blockIdx.x == 0 && lane == 0 && pw == 0)
#pragma unroll 1
        for (int n = 0; n < N; ++n) {
            const int s = n % SLOTS;
            if (n >= SLOTS) mbar_wait(&empty[s], (n / SLOTS - 1) & 1);
            PROF_MARK(0);
            char* S = ring + s * Fit::SLOT;
            if (lane == 0) mbar_arrive_expect_tx(&full[s], tma ? tx : 0);
#pragma unroll
            for (int q = 0; q < Fit::NS; ++q) {
                if (ro_owner(q) != pw) continue;
                const int rows = ro_rows(PACKED, q), e = ro_esz(PACKED, q);
                char* dst = S + ro_off(PACKED, q, W, PAIRS);
                const size_t first = (size_t)n * rows * Bs;   // the stage's
                if (tma) {
                    if (lane == 0)
                        for (int i = 0; i < ro_boxes(rows); ++i)
                            tma_box(dst + i * ro_box(rows, W, e) * W * e,
                                    &maps.m[q], (int)b0,
                                    n * rows + i * ro_box(rows, W, e), &full[s]);
                } else if (PAIRS && ro_stage(PACKED, q)) {
                    const stage_t* x = (const stage_t*)src.p[q];
                    ro_pairs<W>(reinterpret_cast<stage_t*>(dst),
                                x + first + b0, x + (size_t)N * rows * Bs,
                                rows, Bs, lane);
                } else {
                    warp_copy_rows<W>(reinterpret_cast<scalar*>(dst),
                                      (const scalar*)src.p[q] + first, rows,
                                      Bs, b0, false, lane);
                }
            }
            mbar_arrive_on_copies(&full[s]);
            PROF_MARK(1);
        }
        PROF_DONE_RANGE(0, 2)
    } else if (warp == 0) {
        // ---- chain: x in registers, [u; x] into the out-ring.
        const size_t bc = b < Bs ? b : Bs - 1;
        // PAIRS: a stage row's first scenario at entry o of its slot row,
        // o = 1 where the row starts in a pair's second half (on an odd
        // batch, every other row of a stream).
        const int odd = PAIRS ? (int)(Bs & 1) : 0;
        scalar x[NX];
#pragma unroll
        for (int i = 0; i < NX; ++i) x[i] = x0[i * Bs + bc];
        PROF_INIT_AT(blockIdx.x == 0 && lane == 0)
#pragma unroll 1
        for (int n = 0; n < N; ++n) {
            const int s = n % SLOTS;
            mbar_wait(&full[s], (n / SLOTS) & 1);
            PROF_MARK(2);
            const char* S = ring + s * Fit::SLOT;
            // Row r of a block of stage rows starting at row r0 of a stream
            // of `rows` rows a stage: at at[r & 1][r * RW].
            auto rows_at = [&](int off, int rows, int r0, const stage_t** at) {
                const int o = odd & (n * rows + r0);
                at[0] = reinterpret_cast<const stage_t*>(S + off) + col + o;
                at[1] = at[0] + (o ^ odd) - o;
            };
            const stage_t *sA[2], *sB[2], *sC[2];
            rows_at(Fit::A, ro_rows(PACKED, 0), 0, sA);
            rows_at(Fit::B, ro_rows(PACKED, PACKED ? 0 : 1),
                    PACKED ? NX * NX : 0, sB);
            rows_at(Fit::C, ro_rows(PACKED, PACKED ? 0 : 2),
                    PACKED ? NX * NX + NX * NU : 0, sC);
            const scalar* sK = reinterpret_cast<const scalar*>(S + Fit::K) + col;
            const scalar* sD = reinterpret_cast<const scalar*>(S + Fit::D) + col;
            scalar u[NU], xn[NX];
#pragma unroll
            for (int j = 0; j < NU; ++j) {
                scalar acc = sD[j * W];
#pragma unroll
                for (int t = 0; t < NX; ++t)
                    acc += sK[(j * NX + t) * W] * x[t];
                u[j] = acc;
            }
#pragma unroll
            for (int i = 0; i < NX; ++i) {
                scalar acc = up(sC[i & 1][i * RW]);
#pragma unroll
                for (int t = 0; t < NX; ++t) {
                    const int r = i * NX + t;
                    acc += up(sA[r & 1][r * RW]) * x[t];
                }
#pragma unroll
                for (int t = 0; t < NU; ++t) {
                    const int r = i * NU + t;
                    acc += up(sB[r & 1][r * RW]) * u[t];
                }
                xn[i] = acc;
            }
            mbar_arrive(&empty[s]);
            PROF_MARK(3);
            const int o = n % RO_OSLOTS;
            if (n >= RO_OSLOTS) mbar_wait(&oempty[o], (n / RO_OSLOTS - 1) & 1);
            PROF_MARK(4);
            if (lane < W) {
                scalar* O = oring + o * Fit::OSLOT + lane;
#pragma unroll
                for (int j = 0; j < NU; ++j) O[j * W] = u[j];
#pragma unroll
                for (int i = 0; i < NX; ++i) O[(NU + i) * W] = x[i];
            }
            mbar_arrive(&ofull[o]);
#pragma unroll
            for (int i = 0; i < NX; ++i) x[i] = xn[i];
            PROF_MARK(5);
        }
        PROF_DONE_RANGE(2, 6)
        if (mine) {
#pragma unroll
            for (int i = 0; i < NX; ++i) xN[i * Bs + b] = x[i];
        }
    } else {
        // ---- store warp: the out-ring to ws, a row a store.
        PROF_INIT_AT(blockIdx.x == 0 && lane == 0)
#pragma unroll 1
        for (int n = 0; n < N; ++n) {
            const int o = n % RO_OSLOTS;
            mbar_wait(&ofull[o], (n / RO_OSLOTS) & 1);
            PROF_MARK(6);
            const scalar* O = oring + o * Fit::OSLOT + col;
            scalar* out = ws + (size_t)n * NZ * Bs + b;
            if (mine) {
#pragma unroll
                for (int r = 0; r < NZ; ++r) out[r * Bs] = O[r * W];
            }
            mbar_arrive(&oempty[o]);
            PROF_MARK(7);
        }
        PROF_DONE_RANGE(6, 8)
    }
}

// K7 on its five streams, K12 on its two.  The streams go by the copy
// engine where its maps can take them (every stream's row stride a
// multiple of 16 bytes, each stream 16-byte aligned); a map that cannot be
// made is an error.
template <bool PACKED, bool PAIRS>
int launch_rollout_form(int N, int Bt, cudaStream_t st,
                        const RoSrc<PACKED>& src, const RoMaps<PACKED>& maps,
                        bool tma, const void* x0, void* ws, void* xN)
{
    using Fit = RoFit<PACKED, PAIRS>;
    const int e = set_smem(forward_rollout_kernel<PACKED, PAIRS>, Fit::SMEM);
    if (e) return e;
    const int blocks = (Bt + Fit::W - 1) / Fit::W;
    forward_rollout_kernel<PACKED, PAIRS><<<blocks, RO_THREADS, Fit::SMEM, st>>>(
        N, Bt, src, (const scalar*)x0, (scalar*)ws, (scalar*)xN, maps,
        (int)tma);
    return (int)cudaGetLastError();
}

template <bool PACKED>
int launch_rollout(int N, int Bt, cudaStream_t st, const RoSrc<PACKED>& src,
                   const void* x0, void* ws, void* xN)
{
    using Fit = RoFit<PACKED, false>;
    bool tma = true;
    for (int q = 0; q < Fit::NS; ++q)
        tma = tma && (size_t)Bt * ro_esz(PACKED, q) % 16 == 0
            && ((size_t)src.p[q] & 15) == 0;
    RoMaps<PACKED> maps = {};
    for (int q = 0; tma && q < Fit::NS; ++q) {
        const int rows = ro_rows(PACKED, q), e = ro_esz(PACKED, q);
        const int err = make_rows_map(&maps.m[q], src.p[q], (size_t)N * rows,
                                      Bt, ro_box(rows, Fit::W, e), Fit::W, e);
        if (err) return err;
    }
    if constexpr (NARROW)
        if (!tma)        // narrow rows no box takes: the PAIRS form
            return launch_rollout_form<PACKED, true>(N, Bt, st, src, maps,
                                                     false, x0, ws, xN);
    return launch_rollout_form<PACKED, false>(N, Bt, st, src, maps, tma, x0,
                                              ws, xN);
}

#ifndef STAGE_BF16
// ---- K10, the cached-factor vector sweep of the segment reduction (K9's
// export_factors outputs P_{k+1}, K, chol(Huu), F_{k+1} per stage): K2's
// per-instance recursion with the segment offset f carried beside p.  Per
// segment of N/S stages, backwards from p = pi (zero but on the last
// segment) and f = 0:
//   Pcp = P c + p                  rbar = hf[:nu] + B^T Pcp
//   d   = -(L L^T)^{-1} rbar       v    = B d + c
//   p   = hf[nu:] + A^T Pcp + K^T rbar            f = F v + f
// and after the segment's first stage (p0, f0) = (p, f).
//
// What bounds it on this card is bytes: 572 words a scenario and stage in
// (A, B, c, hf, P, K, L, F at the quadrotor's widths) and 16 out, 0.37 ms
// at S=8, B=1024, N=512 in float32.  The first design gave a (segment,
// scenario) one thread that loaded its own stage (__ldg): about two warps
// an SM there, too few loads in flight, and at nx=40 its carries and
// temporaries spilled.  Here the warps of a block take roles on W
// consecutive scenarios of one segment (block = segment *
// blocks_a_segment + group), as K7's do, and the G = 32 / W lanes of a
// warp that share a scenario split its rows:
//   * PV_PRODUCERS producer warps put whole stages into a ring of
//     PvFit::SLOTS slots, by boxes of the copy engine where every stream
//     starts on 16 bytes, else by cp.async a word a copy (dealt over all
//     their lanes).  A box takes rows whose stride is whole 16-byte pieces
//     and starts on one; where Bt's rows are not (Bt no multiple of 4 in
//     float32, of 2 in float64), the rows r = c, c + CL, c + 2 CL, ... of
//     a stream (CL the rows a 16-byte phase takes to come round: 2 or 4)
//     are, since a stage's rows are whole multiples of CL, rows of a view
//     of the stream with CL * Bt words a row, and go as boxes of one phase
//     c into the slot's part c: W + 16 bytes wide, from the 16-byte piece
//     the phase's scenarios start in, o_c = c Bt mod (16 bytes) words
//     before them (where some stream's rows are no multiple of CL, or two
//     slots of such rows do not fit, the word copies);
//   * the chain warp carries p through Pcp, rbar and p: lane g*W + j owns
//     rows g, g + G, ... of scenario j's p (G = 1 at the quadrotor's
//     widths in float32, 8 and 16 at nx=40).  It forms Pcp of its rows,
//     rbar's share of them (joined over the scenario's lanes by
//     __shfl_xor_sync), p's rows from Pcp in the chain's own shared rows,
//     and leaves rbar in the slot;
//   * the tail warp, behind it, carries f the same way: d from rbar, v's
//     rows (into the tail's own shared rows), f += F v, and the d and v
//     stores.
// A warp reads W consecutive words of a row a scenario group: no bank
// conflict between the scenarios; a lane's rows g + G m of P and F are
// walked from column g * PV_SKEW on, so that the G groups read different
// banks.  Shared-memory barriers hand a slot on (full, ready: rbar is in
// it, empty); no block-wide barrier a stage.  A scenario past the batch
// computes on zeros (the copy engine's), another row's entries (a phase's
// box) or the last scenario's rows (word copies) and stores nothing.
constexpr int PV_PRODUCERS = 4;
constexpr int PV_THREADS = 32 * (2 + PV_PRODUCERS);   // chain, tail, producers
constexpr int PV_SLOTS_MAX = 4;
constexpr int PV_STREAMS = 8;                // A, B, c, hf, P, K, L, F
// A lane's first column of P and F: g * PV_SKEW (odd NX + PV_SKEW).
constexpr int PV_SKEW = NX % 2 ? 2 : 1;

__host__ __device__ constexpr int pv_rows(int q)
{
    return q == 0 || q == 4 || q == 7 ? NX * NX : q == 1 ? NX * NU
        : q == 2 ? NX : q == 3 ? NZ : q == 5 ? NU * NX : NU * NU;
}
// A slot row's words: W, or (phases) W and a 16-byte piece.
__host__ __device__ constexpr int pv_stride(int w, int cl)
{
    return cl == 1 ? w : w + 16 / (int)sizeof(scalar);
}
// The rows of a box of one phase of stream q (cl phases; cl = 1: the
// stream) for w scenarios: at most 256, each box whole 128-byte pieces.
// (No recursion and no loop but pv_off's over the streams: the kernels
// call these with constant arguments, which the compiler folds.)
__host__ __device__ constexpr int pv_box(int q, int w, int cl)
{
    const int pr = pv_rows(q) / cl, nb = ro_boxes(pr);
    const int row = pv_stride(w, cl) * (int)sizeof(scalar);
    const int low = row & -row;       // the largest power of 2 dividing it
    const int a = low >= 128 ? 1 : 128 / low;    // rows of whole pieces
    return ((pr + nb - 1) / nb + a - 1) / a * a;
}
// The slot rows of one phase of stream q.
__host__ __device__ constexpr int pv_part(int q, int w, int cl)
{
    return ro_boxes(pv_rows(q) / cl) * pv_box(q, w, cl);
}
// The first byte of stream q in a slot of w scenarios, each from a
// 128-byte boundary; q = PV_STREAMS: rbar's NU rows (the chain's), q =
// PV_STREAMS + 1: a slot's bytes.
__host__ __device__ constexpr int pv_off(int q, int w, int cl)
{
    constexpr int SZ = (int)sizeof(scalar);
    int off = 0;
    for (int i = 0; i < q; ++i) {
        const int bytes = i == PV_STREAMS
            ? NU * w * SZ : cl * pv_part(i, w, cl) * pv_stride(w, cl) * SZ;
        off = (off + bytes + 127) / 128 * 128;
    }
    return off;
}
// Slots of w scenarios (and three barriers each) beside the chain's rows
// of Pcp and the tail's of v (nx rows of w each).
__host__ __device__ constexpr int pv_fit(int w, int cl)
{
    return (RO_SMEM_MAX - 128 - 2 * NX * w * (int)sizeof(scalar))
        / (pv_off(PV_STREAMS + 1, w, cl) + 3 * 8);
}
// W: the widest of 32, 16, 8, 4 (and 2 in float64: a box row of 16 bytes
// at least) scenarios whose ring holds 3 slots, else 2: 32 in float32 at
// the quadrotor's widths (3 slots of 72 KB), 8 at the centroidal model's,
// 4 at nx=40 (2 slots of 91 KB).
__host__ __device__ constexpr int pv_pick(int cl)
{
    constexpr int least_w = 16 / (int)sizeof(scalar);
    for (int least = 3; least >= 2; --least)
        for (int w = 32; w >= least_w; w /= 2)
            if (pv_fit(w, cl) >= least) return w;
    return least_w;
}
// Boxes of cl phases: every stream's rows a whole number of phases, and
// two slots of the phases' wider rows fit.
__host__ __device__ constexpr bool pv_phases(int cl)
{
    for (int q = 0; q < PV_STREAMS; ++q)
        if (pv_rows(q) % cl) return false;
    return pv_fit(pv_pick(cl), cl) >= 2;
}
template <int CL> struct PvFit {
    static constexpr int W = pv_pick(CL);
    static constexpr int G = 32 / W;                 // lanes a scenario
    static constexpr int RX = (NX + G - 1) / G;      // rows of p a lane
    static constexpr int RS = pv_stride(W, CL);      // a slot row's words
    // The product steps a loop iteration (rolled where a lane has many
    // rows: one lane a scenario at nx=40 spilled in float64 unrolled).
    static constexpr int UNROLL = RX <= 12 ? 4 : 1;
    static constexpr int SLOTS = pv_fit(W, CL) < PV_SLOTS_MAX ? pv_fit(W, CL)
                                                              : PV_SLOTS_MAX;
    static constexpr int SLOT = pv_off(PV_STREAMS + 1, W, CL);   // bytes
    static constexpr int BAR = SLOTS * SLOT;
    static constexpr int XS = BAR + 3 * 8 * SLOTS;   // Pcp's rows, then v's
    static constexpr int SMEM = XS + 2 * NX * W * (int)sizeof(scalar) + 128;
    static_assert(SLOTS >= 2, "K10: two stages of the least W do not fit");
};
struct PvSrc { const scalar* p[PV_STREAMS]; };
struct PvMaps { CUtensorMap m[PV_STREAMS]; };

template <int CL>
__global__ void __launch_bounds__(PV_THREADS, 1)
backward_pdp_vectors_kernel(
    int N, int Bt, int S, const PvSrc src, const scalar* __restrict__ pi,
    scalar* __restrict__ d_out, scalar* __restrict__ v_out,
    scalar* __restrict__ p0, scalar* __restrict__ f0,
    const __grid_constant__ PvMaps maps, int tma)
{
    using Fit = PvFit<CL>;
    constexpr int W = Fit::W, SLOTS = Fit::SLOTS, G = Fit::G, RX = Fit::RX;
    constexpr int UNR = Fit::UNROLL, RS = Fit::RS, VW = 16 / (int)sizeof(scalar);
    constexpr int SZ = (int)sizeof(scalar);
    constexpr unsigned FULL = 0xffffffffu;
    extern __shared__ double smem_aligned[];
    char* base = reinterpret_cast<char*>(
        (reinterpret_cast<size_t>(smem_aligned) + 127) / 128 * 128);
    mbar_t* full = reinterpret_cast<mbar_t*>(base + Fit::BAR);
    mbar_t* ready = full + SLOTS;
    mbar_t* empty = ready + SLOTS;

    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int j = lane % W;                      // the lane's scenario
    const int g = G == 1 ? 0 : lane / W;         // its rows: g, g + G, ...
    const size_t Bs = (size_t)Bt;
    const unsigned bps = (Bt + W - 1) / W;       // blocks a segment
    const size_t seg = blockIdx.x / bps;
    const size_t b0 = (size_t)(blockIdx.x % bps) * W;
    const size_t b = b0 + j;
    const bool mine = b < Bs;                    // stores its scenario's rows
    const int Nl = N / S;
    const int s0 = (int)seg * Nl;                // the segment's first stage
    // Row m of the lane's rows is g + G m; the last may lie past NX.
    auto own = [&](int m) {
        return NX % G == 0 || m < NX / G || g + G * m < NX;
    };
    // Stream q (rbar: PV_STREAMS) of slot s, at the lane's scenario; row r
    // of stream q at [at(q, r)] (rbar's at [r * W]).  Phase c's boxes start
    // oc(c) words before their scenarios.
    const unsigned bm = Bt % VW;
    auto oc = [&](unsigned c) { return (int)(c * bm % VW); };
    auto slot = [&](int s, int q) {
        return reinterpret_cast<scalar*>(base + s * Fit::SLOT
                                         + pv_off(q, W, CL)) + j;
    };
    auto at = [&](int q, int r) {
        const unsigned u = r, c = u % CL;
        return CL == 1 ? r * W
            : (int)((c * pv_part(q, W, CL) + u / CL) * RS) + oc(c);
    };
    // Row a * NX + t: where NX is whole phases, row t's place and a whole
    // phase rows on (the part of a lane's rows the compiler lifts out of
    // the loops over t).
    auto at_nx = [&](int q, int a, int t) {
        if constexpr (NX % CL == 0) return at(q, t) + a * (NX / CL) * RS;
        else return at(q, a * NX + t);
    };

    if (threadIdx.x == 0) {
        for (int s = 0; s < SLOTS; ++s) {
            mbar_init(&full[s], 33 * PV_PRODUCERS);   // each producer's lanes,
                                                 // and its lane 0's with the
                                                 // bytes it expects
            mbar_init(&ready[s], 32);            // the chain's
            mbar_init(&empty[s], 32);            // the tail's
        }
    }
    __syncthreads();

    // Stage n of the segment's sweep is model stage s0 + Nl-1-n, in slot
    // n % SLOTS.
    if (warp >= 2) {
        // ---- producer warp pw: its (stream, phase) boxes, or its share
        // of every stream's words.
        const int pw = warp - 2;
        const int tp = threadIdx.x - 64;         // thread of the producers
        int tx = 0;                              // the bytes of its boxes
#pragma unroll
        for (int q = 0; q < PV_STREAMS; ++q)
            for (int c = 0; c < CL; ++c)
                if ((q * CL + c) % PV_PRODUCERS == pw)
                    tx += pv_part(q, W, CL) * RS * SZ;
        PROF_INIT_AT(blockIdx.x == 0 && tp == 0)
#pragma unroll 1
        for (int n = 0; n < Nl; ++n) {
            const int s = n % SLOTS;
            if (n >= SLOTS) mbar_wait(&empty[s], (n / SLOTS - 1) & 1);
            PROF_MARK(0);
            const int k = s0 + Nl - 1 - n;
            if (lane == 0) mbar_arrive_expect_tx(&full[s], tma ? tx : 0);
#pragma unroll
            for (int q = 0; q < PV_STREAMS; ++q) {
                constexpr int NT = 32 * PV_PRODUCERS;
                const int rows = pv_rows(q);
                scalar* dst = slot(s, q) - j;
                if (tma) {
                    // Phase c: view row k rows / CL on, columns from
                    // c Bt + b0 - oc(c).
                    const int pr = rows / CL, br = pv_box(q, W, CL);
                    for (int c = 0; c < CL; ++c)
                        if ((q * CL + c) % PV_PRODUCERS == pw && lane == 0)
                            for (int i = 0; i < ro_boxes(pr); ++i)
                                tma_box(dst + (c * pv_part(q, W, CL)
                                               + i * br) * RS,
                                        &maps.m[q], c * Bt + (int)b0 - oc(c),
                                        k * pr + i * br, &full[s]);
                } else {
                    const scalar* x = src.p[q] + (size_t)k * rows * Bs;
#pragma unroll 1
                    for (int t = tp; t < rows * W; t += NT) {
                        const int r = t / W, jj = t % W;
                        const size_t bj = b0 + jj < Bs ? b0 + jj : Bs - 1;
                        copy_word(dst + r * W + jj, x + r * Bs + bj);
                    }
                }
            }
            mbar_arrive_on_copies(&full[s]);
            PROF_MARK(1);
        }
        PROF_DONE_RANGE(0, 2)
    } else if (warp == 0) {
        // ---- chain: p's rows in registers, rbar into the slot.
        const size_t bc = b < Bs ? b : Bs - 1;
        scalar* xs = reinterpret_cast<scalar*>(base + Fit::XS) + j;
        const int t0 = (g * PV_SKEW) % NX;       // the lane's first column
        scalar p[RX];
#pragma unroll
        for (int m = 0; m < RX; ++m)
            p[m] = own(m) ? pi[(seg * NX + g + G * m) * Bs + bc] : (scalar)0;
        PROF_INIT_AT(blockIdx.x == 0 && lane == 0)
#pragma unroll 1
        for (int n = 0; n < Nl; ++n) {
            const int s = n % SLOTS;
            mbar_wait(&full[s], (n / SLOTS) & 1);
            PROF_MARK(2);
            const scalar* sA = slot(s, 0);
            const scalar* sB = slot(s, 1);
            const scalar* sc = slot(s, 2);
            const scalar* shf = slot(s, 3);
            const scalar* sP = slot(s, 4);
            const scalar* sK = slot(s, 5);
            // The products in axpy order (a column of P, a row of B, A and
            // K a step, their vector's entry read from shared memory), the
            // steps rolled by UNR.  Pcp = P c + p of the lane's rows.
#pragma unroll UNR
            for (int t1 = 0; t1 < NX; ++t1) {
                const int t = t1 + t0 < NX ? t1 + t0 : t1 + t0 - NX;
                const scalar ct = sc[at(2, t)];
#pragma unroll
                for (int m = 0; m < RX; ++m)
                    if (own(m)) p[m] += sP[at_nx(4, g + G * m, t)] * ct;
            }
            // rbar = hf_u + B^T Pcp: the lane's rows' share (hf_u in lane
            // g = 0's), joined over the scenario's G lanes; Pcp into the
            // chain's rows; p = hf_x of the lane's rows.
            scalar rbar[NU];
#pragma unroll
            for (int u = 0; u < NU; ++u)
                rbar[u] = g == 0 ? shf[at(3, u)] : (scalar)0;
            if constexpr (G > 1) __syncwarp();   // the last stage's reads
#pragma unroll
            for (int m = 0; m < RX; ++m) {
                if (!own(m)) continue;
                const int i = g + G * m;
#pragma unroll
                for (int u = 0; u < NU; ++u)
                    rbar[u] += sB[at(1, i * NU + u)] * p[m];
                xs[i * W] = p[m];
                p[m] = shf[at(3, NU + i)];
            }
#pragma unroll
            for (int w = W; w < 32; w *= 2) {
#pragma unroll
                for (int u = 0; u < NU; ++u)
                    rbar[u] += __shfl_xor_sync(FULL, rbar[u], w);
            }
            if constexpr (G > 1) __syncwarp();   // Pcp's rows written
            // p = hf_x + A^T Pcp + K^T rbar
#pragma unroll UNR
            for (int t = 0; t < NX; ++t) {
                const scalar xt = xs[t * W];
#pragma unroll
                for (int m = 0; m < RX; ++m)
                    if (own(m)) p[m] += sA[at_nx(0, t, g + G * m)] * xt;
            }
#pragma unroll
            for (int u = 0; u < NU; ++u) {
#pragma unroll
                for (int m = 0; m < RX; ++m)
                    if (own(m))
                        p[m] += sK[at_nx(5, u, g + G * m)] * rbar[u];
            }
            scalar* srb = slot(s, PV_STREAMS);
#pragma unroll
            for (int u = 0; u < NU; ++u)
                if (u % G == g) srb[u * W] = rbar[u];
            mbar_arrive(&ready[s]);
            PROF_MARK(3);
        }
        PROF_DONE_RANGE(2, 4)
        if (mine) {
#pragma unroll
            for (int m = 0; m < RX; ++m)
                if (own(m)) p0[(seg * NX + g + G * m) * Bs + b] = p[m];
        }
    } else {
        // ---- tail: d, v's rows and their stores, f's rows in registers.
        scalar* vs = reinterpret_cast<scalar*>(base + Fit::XS) + NX * W + j;
        const int t0 = (g * PV_SKEW) % NX;
        scalar f[RX];
#pragma unroll
        for (int m = 0; m < RX; ++m) f[m] = (scalar)0;
        PROF_INIT_AT(blockIdx.x == 0 && lane == 0)
#pragma unroll 1
        for (int n = 0; n < Nl; ++n) {
            const int s = n % SLOTS;
            mbar_wait(&ready[s], (n / SLOTS) & 1);
            PROF_MARK(4);
            const size_t k = (size_t)(s0 + Nl - 1 - n);
            const scalar* sB = slot(s, 1);
            const scalar* sc = slot(s, 2);
            const scalar* sL = slot(s, 6);
            const scalar* sF = slot(s, 7);
            const scalar* srb = slot(s, PV_STREAMS);
            // d = -(L L^T)^{-1} rbar, every lane of the scenario
            scalar dv[NU], inv[NU];
#pragma unroll
            for (int i = 0; i < NU; ++i) inv[i] = (scalar)1 / sL[at(6, i * NU + i)];
#pragma unroll
            for (int i = 0; i < NU; ++i) {
                scalar acc = srb[i * W];
#pragma unroll
                for (int t = 0; t < i; ++t) acc -= sL[at(6, i * NU + t)] * dv[t];
                dv[i] = acc * inv[i];
            }
#pragma unroll
            for (int i = NU - 1; i >= 0; --i) {
                scalar acc = dv[i];
#pragma unroll
                for (int t = i + 1; t < NU; ++t) acc -= sL[at(6, t * NU + i)] * dv[t];
                dv[i] = acc * inv[i];
            }
#pragma unroll
            for (int i = 0; i < NU; ++i) {
                dv[i] = -dv[i];
                if (mine && i % G == g) d_out[(k * NU + i) * Bs + b] = dv[i];
            }
            // v = B d + c of the lane's rows, into the tail's rows
            if constexpr (G > 1) __syncwarp();   // the last stage's reads
#pragma unroll
            for (int m = 0; m < RX; ++m) {
                if (!own(m)) continue;
                const int t = g + G * m;
                scalar vt = sc[at(2, t)];
#pragma unroll
                for (int u = 0; u < NU; ++u) vt += sB[at(1, t * NU + u)] * dv[u];
                if (mine) v_out[(k * NX + t) * Bs + b] = vt;
                vs[t * W] = vt;
            }
            if constexpr (G > 1) __syncwarp();   // v's rows written
            // f = F v + f of the lane's rows, a column of F an entry of v
#pragma unroll UNR
            for (int t1 = 0; t1 < NX; ++t1) {
                const int t = t1 + t0 < NX ? t1 + t0 : t1 + t0 - NX;
                const scalar vt = vs[t * W];
#pragma unroll
                for (int m = 0; m < RX; ++m)
                    if (own(m)) f[m] += sF[at_nx(7, g + G * m, t)] * vt;
            }
            mbar_arrive(&empty[s]);
            PROF_MARK(5);
        }
        PROF_DONE_RANGE(4, 6)
        if (mine) {
#pragma unroll
            for (int m = 0; m < RX; ++m)
                if (own(m)) f0[(seg * NX + g + G * m) * Bs + b] = f[m];
        }
    }
}

template <int CL>
int launch_pdp_vectors(int N, int Bt, int S, cudaStream_t st,
                       const PvSrc& src, const void* pi, void* d, void* v,
                       void* p0, void* f0, int tma)
{
    using Fit = PvFit<CL>;
    constexpr int SZ = (int)sizeof(scalar);
    PvMaps maps = {};
    for (int q = 0; tma && q < PV_STREAMS; ++q) {
        const int pr = pv_rows(q) / CL;
        const int err = make_rows_map(&maps.m[q], src.p[q], (size_t)N * pr,
                                      (size_t)CL * Bt,
                                      pv_box(q, Fit::W, CL), Fit::RS, SZ);
        if (err) return err;
    }
    const int e = set_smem(backward_pdp_vectors_kernel<CL>, Fit::SMEM);
    if (e) return e;
    const int blocks = S * ((Bt + Fit::W - 1) / Fit::W);
    backward_pdp_vectors_kernel<CL><<<blocks, PV_THREADS, Fit::SMEM, st>>>(
        N, Bt, S, src, (const scalar*)pi, (scalar*)d, (scalar*)v,
        (scalar*)p0, (scalar*)f0, maps, tma);
    return (int)cudaGetLastError();
}

#endif  // STAGE_BF16

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
                     void* stream,
                     const void* A, const void* B, const void* c,
                     const void* H, const void* h, const void* D,
                     const void* rho, const void* rg, const void* PN,
                     const void* pN, void* K, void* d, void* M, void* v,
                     void* P, void* L)
{
    if (N <= 0 || Bt <= 0) return 0;
    BackwardArgs a{};
    a.N = N; a.Bt = Bt; a.S = 1;
    a.stream = (cudaStream_t)stream;
    a.A = (const stage_t*)A; a.B = (const stage_t*)B; a.c = (const stage_t*)c;
    a.H = (const stage_t*)H; a.h = (const stage_t*)h; a.D = (const stage_t*)D;
    a.rho = (const stage_t*)rho; a.rg = (const stage_t*)rg;
    a.PN = (const scalar*)PN; a.pN = (const scalar*)pN;
    a.K = (scalar*)K; a.d = (scalar*)d; a.M = (scalar*)M; a.v = (scalar*)v;
    a.P = (scalar*)P; a.L = (scalar*)L;
#ifdef STAGE_BF16
    // Narrow stage streams: the gains-only form (solve_lanes') alone.
    if (emit_mv || export_factors) return (int)cudaErrorInvalidValue;
#else
    if (emit_mv && export_factors) return launch_backward<true, true, false, false>(a);
    if (emit_mv) return launch_backward<true, false, false, false>(a);
    if (export_factors) return launch_backward<false, true, false, false>(a);
#endif
    return launch_backward<false, false, false, false>(a);
}

#ifndef STAGE_BF16

// K9: S segments of N/S stages, a block a (segment, group of instances).  The
// initial carries (Pi, pi, Fi, Ci, fi) and the boundary outputs (P0, p0,
// F0, C0, f0) are (S, nx[, nx], Bt); with export_factors also P, L, F per
// stage.
int riccati_backward_pdp(int N, int Bt, int S, int export_factors,
                         void* stream,
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
    a.N = N; a.Bt = Bt; a.S = S;
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
#endif  // STAGE_BF16

// The instances a block of K1 (emit_mv, export_factors), K9 (pdp:
// export_factors) or K11 (neither) serves on `pairs` (segment, instance)
// pairs: G of the batch form (a compile-time consequence of the widths and
// the dtype: SweepFit), or 0 where each instance takes a block of its own.
// A narrow library's one form (gains only) whatever the switches.
int riccati_sweep_group(int emit_mv, int export_factors, int pdp,
                        long long pairs)
{
    if (one_block(pairs)) return 0;
    if (NARROW) return SweepFit<false, false, false, false>::G;
    if (pdp)
        return export_factors ? SweepFit<true, true, true, false>::G
                              : SweepFit<true, false, true, false>::G;
    if (emit_mv)
        return export_factors ? SweepFit<true, true, false, false>::G
                              : SweepFit<true, false, false, false>::G;
    return export_factors ? SweepFit<false, true, false, false>::G
                          : SweepFit<false, false, false, false>::G;
}

// K11: K1 for the gains only, on row-packed Sd (N, nx(nx+nu+1), Bt) and
// Sc (N, nz^2+nz+nc*nz+2nc, Bt); the gains go out as G (N, nu*nx+nu, Bt).
int riccati_backward_packed(int N, int Bt, void* stream,
                            const void* Sd, const void* Sc, const void* PN,
                            const void* pN, void* G)
{
    if (N <= 0 || Bt <= 0) return 0;
    const stage_t* sd = (const stage_t*)Sd;
    const stage_t* sc = (const stage_t*)Sc;
    const size_t Bs = (size_t)Bt;
    BackwardArgs a{};
    a.N = N; a.Bt = Bt; a.S = 1;
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
#ifndef STAGE_BF16

// Per-instance mode: one matrix set per scenario.
int riccati_backward_vectors(int N, int Bt, int pc_mode, void* stream,
                             const void* A, const void* B, const void* c,
                             const void* hf, const void* P, const void* K,
                             const void* L, const void* pN, void* d, void* v)
{
    if (N <= 0 || Bt <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    const int blocks = pc_mode
        ? (Bt + K2ILayout<true>::WS - 1) / K2ILayout<true>::WS
        : (Bt + K2ILayout<false>::WS - 1) / K2ILayout<false>::WS;
#define RICCATI_BV_ARGS                                                      \
    N, Bt, (const scalar*)A, (const scalar*)B, (const scalar*)c,             \
        (const scalar*)hf, (const scalar*)P, (const scalar*)K,               \
        (const scalar*)L, (const scalar*)pN, (scalar*)d, (scalar*)v
    if (pc_mode) {
        const size_t smem = K2ILayout<true>::SMEM;
        int e = set_smem(backward_vectors_kernel<true>, smem);
        if (e) return e;
        backward_vectors_kernel<true><<<blocks, K2I_THREADS, smem, st>>>(RICCATI_BV_ARGS);
    } else {
        const size_t smem = K2ILayout<false>::SMEM;
        int e = set_smem(backward_vectors_kernel<false>, smem);
        if (e) return e;
        backward_vectors_kernel<false><<<blocks, K2I_THREADS, smem, st>>>(RICCATI_BV_ARGS);
    }
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
    const int blocks = (Bt + K2S_W - 1) / K2S_W;
#define RICCATI_BV_ARGS                                                      \
    N, Bt, (const scalar*)pack, (const scalar*)c, (const scalar*)hf,   \
        (const scalar*)Pc, (const scalar*)pN, (scalar*)d, (scalar*)v
    if (pc_mode) {
        const size_t smem = K2SLayout<true>::SMEM;
        int e = set_smem(backward_vectors_shared_kernel<true>, smem);
        if (e) return e;
        backward_vectors_shared_kernel<true><<<blocks, K2S_THREADS, smem, st>>>(RICCATI_BV_ARGS);
    } else {
        const size_t smem = K2SLayout<false>::SMEM;
        int e = set_smem(backward_vectors_shared_kernel<false>, smem);
        if (e) return e;
        backward_vectors_shared_kernel<false><<<blocks, K2S_THREADS, smem, st>>>(RICCATI_BV_ARGS);
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

// K10: S segments; pi, p0 and f0 are (S, nx, Bt).  The streams go by the
// copy engine where every stream starts on 16 bytes: boxes of W where the
// rows are whole 16-byte pieces, else (CL = 2 or 4) a box a 16-byte phase
// of rows, where every stream's rows are whole multiples of CL; otherwise
// a word a copy.  A map that cannot be made is an error.
int riccati_backward_pdp_vectors(int N, int Bt, int S, void* stream,
                                 const void* A, const void* B, const void* c,
                                 const void* hf, const void* P, const void* K,
                                 const void* L, const void* F, const void* pi,
                                 void* d, void* v, void* p0, void* f0)
{
    if (N <= 0 || Bt <= 0) return 0;
    if (S <= 0 || N % S != 0) return (int)cudaErrorInvalidValue;
    const PvSrc src = {{(const scalar*)A, (const scalar*)B, (const scalar*)c,
                        (const scalar*)hf, (const scalar*)P, (const scalar*)K,
                        (const scalar*)L, (const scalar*)F}};
    const cudaStream_t st = (cudaStream_t)stream;
    bool tma = true;
    for (int q = 0; q < PV_STREAMS; ++q)
        tma = tma && ((size_t)src.p[q] & 15) == 0;
    int cl = 1;                                  // rows a 16-byte phase
    while ((size_t)Bt * sizeof(scalar) * cl % 16) cl *= 2;
    if constexpr (pv_phases(2)) {
        if (tma && cl == 2)
            return launch_pdp_vectors<2>(N, Bt, S, st, src, pi, d, v, p0, f0,
                                         1);
    }
    if constexpr (sizeof(scalar) == 4 && pv_phases(4)) {
        if (tma && cl == 4)
            return launch_pdp_vectors<4>(N, Bt, S, st, src, pi, d, v, p0, f0,
                                         1);
    }
    return launch_pdp_vectors<1>(N, Bt, S, st, src, pi, d, v, p0, f0,
                                 tma && cl == 1);
}
#endif  // STAGE_BF16

int riccati_forward_rollout(int N, int Bt, void* stream,
                            const void* A, const void* B, const void* c,
                            const void* K, const void* d, const void* x0,
                            void* ws, void* xN)
{
    if (N <= 0 || Bt <= 0) return 0;
    const RoSrc<false> src = {{A, B, c, K, d}};
    return launch_rollout<false>(N, Bt, (cudaStream_t)stream, src, x0, ws, xN);
}

// K12: K7 on row-packed Sd (N, nx(nx+nu+1), Bt) and G (N, nu*nx+nu, Bt).
int riccati_forward_packed(int N, int Bt, void* stream, const void* Sd,
                           const void* G, const void* x0, void* ws, void* xN)
{
    if (N <= 0 || Bt <= 0) return 0;
    const RoSrc<true> src = {{Sd, G}};
    return launch_rollout<true>(N, Bt, (cudaStream_t)stream, src, x0, ws, xN);
}

#endif  // NC

}  // extern "C"
