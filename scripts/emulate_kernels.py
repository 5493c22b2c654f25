#!/usr/bin/env python3
"""Rehearse the CUDA kernels' logic on a CPU, where there is no ``nvcc``.

    python3 scripts/emulate_kernels.py [--quick]

A CUDA kernel runs only on a card.  Its indexing, its shared-memory
layout and the order of its barriers can still be rehearsed without one:
this script rewrites ``ops/csrc/riccati_kernels.cu`` and
``ops/csrc/admm_kernels.cu`` into host C++ (each
``<<<grid, block, smem, stream>>>`` launch becomes a loop over blocks that
starts one OS thread per CUDA thread, ``__syncthreads`` a ``std::barrier``
of the block and ``__syncwarp`` and ``__shfl_sync`` one of the warp,
``cp.async`` a ``memcpy``, the shared-memory barrier objects of
``hopper_sync.cuh`` an atomic word with their phases and transaction
counts, a box of the copy engine a strided copy), builds it with
``g++ -std=c++20`` into ``build/emulate/``, loads it through the wrappers'
own ``ctypes`` bindings and holds every kernel and mode against its plain
PyTorch version at small sizes (K1-K12, every form of K5 and of K8, K9 in
both forms, K3 in segments, the narrow forms of K1, K4-K7, K11 and K12 on
bfloat16 streams; K8, per-instance K3, both forms of K2 and the
matrix sweep K1 / K9 / K11, K7 and K12 across several blocks with a
ragged last one; K2, K5, K7 and K12 past their rings' slots).  It proves nothing about what ``nvcc`` accepts, about races between
asynchronous copies and their waits, or about speed; it finds wrong
indices, layouts and missing barriers before a run on the card is spent
on them.  About three minutes (some thirty small g++ builds); ``--quick`` runs
the cases that ``tests/test_torch_emulate.py`` keeps alive.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    K4_NARROW, K5_NARROW, K6_NARROW, iter_factors, narrow_args,
    narrow_storage, narrow_streams, pack_streams, random_admm_inputs,
    random_iter_inputs, random_ladder_inputs,
)
from pdp_lqr_tpu_torch.ops import _build, cuda_admm as ca, cuda_riccati as cr  # noqa: E402

OUT = ROOT / "build" / "emulate"

HEADERS = {
    "cuda_pipeline.h": """#pragma once
#include <cstring>
#include <cstddef>
#include <cstdlib>
// A copy of n bytes needs both ends n-byte aligned (the card faults).
inline void __pipeline_memcpy_async(void* d, const void* s, size_t n, size_t z = 0)
{
    if (((size_t)d | (size_t)s) % n) std::abort();
    std::memcpy(d, s, n - z); std::memset((char*)d + n - z, 0, z);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(int) {}
#define __launch_bounds__(...)
""",
    "cuda_runtime.h": """#pragma once
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
struct emu_dim3 { unsigned x, y, z; };
static thread_local emu_dim3 threadIdx, blockIdx, blockDim, gridDim;
static thread_local std::barrier<>* emu_bar;
static thread_local std::barrier<>* emu_warp_bar;
static thread_local unsigned long long* emu_shfl;
static thread_local double* emu_smem;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __grid_constant__
#define __syncthreads() emu_bar->arrive_and_wait()
// A warp's barrier: the 32 threads of the caller's warp only.
inline void __syncwarp(unsigned = 0xffffffffu) { emu_warp_bar->arrive_and_wait(); }
// A shuffle: every lane of the warp posts its value, then reads its source
// lane's (within sections of `width` lanes).
template <class T> T emu_shuffle(T v, unsigned src) {
    const unsigned lane = threadIdx.x % 32;
    std::memcpy(&emu_shfl[lane], &v, sizeof(T));
    emu_warp_bar->arrive_and_wait();
    T r;
    std::memcpy(&r, &emu_shfl[src % 32], sizeof(T));
    emu_warp_bar->arrive_and_wait();
    return r;
}
template <class T> T __shfl_sync(unsigned, T v, int src, int width = 32) {
    const unsigned lane = threadIdx.x % 32;
    return emu_shuffle(v, lane / width * width + (unsigned)src % width);
}
template <class T> T __shfl_xor_sync(unsigned, T v, int mask) {
    return emu_shuffle(v, (threadIdx.x % 32) ^ (unsigned)mask);
}
template <class T> inline T __ldg(const T* p) { return *p; }
// Shared-memory atomics and fences: the host's, sequentially consistent.
template <class T> inline T atomicAdd(T* p, T v) {
    return std::atomic_ref<T>(*p).fetch_add(v);
}
inline void __threadfence_block() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
inline double rsqrt(double x) { return 1.0 / std::sqrt(x); }
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
struct alignas(16) double2 { double x, y; };
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline int cudaGetLastError() { return 0; }
// The SMs the host code sees (1: every batch of more than one instance
// takes the batch form; a case sets it to reach the one-instance block).
extern "C" { int emu_sms = 1; }
enum { cudaDevAttrMultiProcessorCount = 16 };
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, int, int) { *v = emu_sms; return 0; }
// The card's limit on a block's shared memory (227 KB): a kernel asking
// for more fails there, and here.
template <class F> inline int cudaFuncSetAttribute(F, int attr, int v) {
    return attr == cudaFuncAttributeMaxDynamicSharedMemorySize && v > 232448
        ? cudaErrorInvalidValue : 0;
}
// A block: one OS thread a CUDA thread, a std::barrier for the block and
// one for each warp (threads that return drop out of both).
template <class F>
void emu_launch(int grid, int block, size_t smem, void*, F f) {
    const int warps = (block + 31) / 32;
    for (int g = 0; g < grid; ++g) {
        std::vector<double> sm(smem / 8 + 2);
        std::vector<unsigned long long> shfl(32 * warps);
        std::barrier<> bar(block);
        std::vector<std::unique_ptr<std::barrier<>>> wbar;
        for (int w = 0; w < warps; ++w)
            wbar.emplace_back(new std::barrier<>(std::min(32, block - 32 * w)));
        std::vector<std::thread> th;
        for (int t = 0; t < block; ++t)
            th.emplace_back([&, t, g] {
                threadIdx = {(unsigned)t, 0, 0}; blockIdx = {(unsigned)g, 0, 0};
                blockDim = {(unsigned)block, 1, 1}; gridDim = {(unsigned)grid, 1, 1};
                emu_bar = &bar; emu_smem = sm.data();
                emu_warp_bar = wbar[t / 32].get(); emu_shfl = &shfl[t / 32 * 32];
                f();
                emu_warp_bar->arrive_and_drop();
                bar.arrive_and_drop();
            });
        for (auto& x : th) x.join();
    }
}
""",
    # The shared-memory barrier objects (mbarrier), with their phases: a
    # 64-bit word in the block's shared memory holds the arrivals still
    # missing (bits 0-15), the count a phase (16-31), the transaction
    # count (bytes still to land by the copy engine, signed, 32-62) and the
    # phase bit (63), updated atomically; a phase completes when no
    # arrival and no byte is missing; a waiter sleeps until the phase of
    # the parity it names has completed.  cp.async and the copy engine's
    # boxes and bulk copies are copied at once here, so an arrival on a
    # thread's copies is an arrival at once and a box's bytes land as it is
    # started (out of the tensor: zeros); a bulk copy checks its 16-byte
    # alignment and length.
    "hopper_sync.cuh": """#pragma once
#include <atomic>
#include <cstdlib>
#include <cstring>
typedef unsigned long long mbar_t;
inline void mbar_init(mbar_t* bar, unsigned count) {
    *bar = ((unsigned long long)count << 16) | count;
}
// `arrivals` arrivals and `tx` more expected bytes (negative: landed).
inline void emu_mbar_update(mbar_t* bar, unsigned arrivals, long long tx) {
    std::atomic_ref<unsigned long long> a(*bar);
    unsigned long long old = a.load(), nw;
    do {
        const unsigned long long pending = old & 0xffffULL;
        const unsigned long long count = (old >> 16) & 0xffffULL;
        long long t = (long long)((old >> 32) & 0x7fffffffULL);
        if (t >= (1LL << 30)) t -= 1LL << 31;
        if (pending < arrivals) std::abort();
        const unsigned long long p = pending - arrivals;
        t += tx;
        if (t <= -(1LL << 30) || t >= (1LL << 30)) std::abort();
        const unsigned long long phase = old >> 63;
        nw = p == 0 && t == 0
            ? ((phase ^ 1ULL) << 63) | (count << 16) | count
            : (phase << 63) | (((unsigned long long)t & 0x7fffffffULL) << 32)
              | (count << 16) | p;
    } while (!a.compare_exchange_weak(old, nw));
    a.notify_all();
}
inline void mbar_arrive(mbar_t* bar) { emu_mbar_update(bar, 1, 0); }
inline void mbar_arrive_on_copies(mbar_t* bar) { emu_mbar_update(bar, 1, 0); }
inline void mbar_arrive_expect_tx(mbar_t* bar, unsigned bytes) {
    emu_mbar_update(bar, 1, (long long)bytes);
}
inline void mbar_wait(mbar_t* bar, unsigned parity) {
    std::atomic_ref<unsigned long long> a(*bar);
    for (unsigned long long v = a.load(); (unsigned)(v >> 63) == parity;
         v = a.load())
        a.wait(v);
}
inline void prefetch_l2(const void*) {}
template <class M> inline void prefetch_map(const M*) {}
inline void bulk_copy(void* dst, const void* src, unsigned bytes, mbar_t* bar) {
    if (((size_t)dst & 15) || ((size_t)src & 15) || (bytes & 15)) std::abort();
    std::memcpy(dst, src, bytes);
    emu_mbar_update(bar, 0, -(long long)bytes);
}
struct CUtensorMap {
    const char* base; unsigned long long rows, cols;
    unsigned box_rows, box_cols; int word;
};
inline int make_rows_map(CUtensorMap* map, const void* base,
                         unsigned long long rows, unsigned long long cols,
                         unsigned box_rows, unsigned box_cols, int word) {
    if (((size_t)base & 15) || cols * word % 16) return 1;
    *map = {(const char*)base, rows, cols, box_rows, box_cols, word};
    return 0;
}
inline void tma_box(void* dst, const CUtensorMap* m, int col, int row,
                    mbar_t* bar) {
    if ((size_t)dst & 127) std::abort();
    if ((long long)col * m->word % 16) std::abort();
    char* d = (char*)dst;
    for (unsigned r = 0; r < m->box_rows; ++r)
        for (unsigned c = 0; c < m->box_cols; ++c, d += m->word) {
            const unsigned long long gr = row + r, gc = col + c;
            if (gr < m->rows && gc < m->cols)
                std::memcpy(d, m->base + (gr * m->cols + gc) * m->word, m->word);
            else
                std::memset(d, 0, m->word);
        }
    emu_mbar_update(bar, 0,
                    -(long long)m->box_rows * m->box_cols * m->word);
}
""",
    "cuda_bf16.h": """#pragma once
#include <cstdint>
#include <cstring>
struct __nv_bfloat16 { uint16_t bits; };
inline float __bfloat162float(__nv_bfloat16 v) {
    uint32_t u = (uint32_t)v.bits << 16; float f; std::memcpy(&f, &u, 4); return f;
}
""",
}


def host_source(source: str) -> str:
    src = (_build.CSRC / source).read_text()
    shared = "extern __shared__ double smem_aligned[];"
    if shared not in src:
        raise RuntimeError(f"{source}: expected `{shared}` in every kernel")
    src = src.replace(shared, "double* smem_aligned = emu_smem;")
    launch = re.compile(r"(\w+(?:<[^<>;]*>)?)<<<([^>]*?)>>>\((.*?)\);", re.S)
    src, n = launch.subn(
        lambda m: f"emu_launch({m.group(2)}, [&]{{ {m.group(1)}({m.group(3)}); }});",
        src)
    if n == 0:
        raise RuntimeError(f"{source}: no kernel launch found to rewrite")
    return src


_HOST_LIBS: dict = {}


def build_host(source: str, defines: dict) -> ctypes.CDLL:
    """One specialisation of one kernel source as a host library (built
    once a process)."""
    key = (source, tuple(sorted(defines.items())))
    if key not in _HOST_LIBS:
        _HOST_LIBS[key] = _build_host(source, defines)
    return _HOST_LIBS[key]


def _build_host(source: str, defines: dict) -> ctypes.CDLL:
    tag = Path(source).stem + "_" + "_".join(
        f"{k}{v}" for k, v in sorted(defines.items()))
    cpp, so = OUT / f"{tag}.cpp", OUT / f"{tag}.so"
    cpp.write_text(host_source(source))
    cmd = ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
           f"-I{OUT / 'include'}", f"-I{_build.CSRC}",
           *[f"-D{k}={v}" for k, v in defines.items()],
           "-o", str(so), str(cpp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed: {' '.join(cmd)}\n{proc.stderr[:6000]}")
    return ctypes.CDLL(str(so))


def library(dtype, nx, nu, nc=None, narrow=False) -> ctypes.CDLL:
    lib = build_host(cr.SOURCE, cr.kernel_defines(dtype, nx, nu, nc,
                                                  narrow=narrow))
    cr.bind_library(lib, with_matrix_sweep=nc is not None, narrow=narrow)
    return lib


def admm_library(dtype, nx, nu, nc=None, **modes) -> ctypes.CDLL:
    defines = ca.kernel_defines(dtype, nx, nu, nc, **modes)
    lib = build_host(ca.SOURCE, defines)
    ca.bind_library(lib, defines)
    return lib


def check(what, outs, refs, tol):
    """Largest error over the outputs, each against its own largest
    magnitude where that exceeds 1."""
    err = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
              for a, b in zip(outs, refs))
    print(f"{what}: max err {err:.2e}", flush=True)
    if not err <= tol:
        raise RuntimeError(f"{what}: {err} > {tol}")


def sweep_inputs(T, rng, dtype, nx, nu, nc, N, Bt):
    """Random inputs of the matrix sweep (H and PN positive definite)."""
    nz = nx + nu
    A, B, c = T(N, nx, nx, Bt) * 0.3, T(N, nx, nu, Bt) * 0.5, T(N, nx, Bt) * 0.1
    G = T(N, nz, nz, Bt) * 0.3
    H = (torch.einsum("kijb,kljb->kilb", G, G)
         + 0.5 * torch.eye(nz, dtype=dtype)[None, :, :, None]).contiguous()
    h, D = T(N, nz, Bt) * 0.3, T(N, nc, nz, Bt) * 0.5
    rho = torch.as_tensor(rng.uniform(0, 1, size=(N, nc, Bt))).to(dtype)
    rg = T(N, nc, Bt)
    GN = T(nx, nx, Bt)
    PN = (torch.einsum("ijb,ljb->ilb", GN, GN)
          + torch.eye(nx, dtype=dtype)[:, :, None]).contiguous()
    pN = T(nx, Bt)
    return A, B, c, H, h, D, rho, rg, PN, pN


def pdp_carries(T, dtype, nx, S, Bt):
    """Random per-segment carries (P, p, F, C, f) of K9."""
    eye = torch.eye(nx, dtype=dtype)[None, :, :, None]
    return (
        (torch.einsum("sijb,sljb->silb", *(T(S, nx, nx, Bt),) * 2)
         + eye).contiguous(),
        T(S, nx, Bt), (eye + 0.2 * T(S, nx, nx, Bt)).contiguous(),
        (torch.einsum("sijb,sljb->silb", *(T(S, nx, nx, Bt),) * 2)
         + eye).contiguous(),
        T(S, nx, Bt))


def run(dtype, nx, nu, nc, N, Bt, Bs, tol):
    """All modes of the three kernels at one size: ``Bt`` instances for the
    per-instance modes, ``Bs`` scenarios on instance 0 for the shared ones."""
    rng = np.random.default_rng(1)
    T = lambda *s: torch.as_tensor(rng.normal(size=s)).to(dtype).contiguous()
    nz = nx + nu
    tag = f"{str(dtype).split('.')[-1]} nx={nx} nu={nu} nc={nc} N={N}"
    k1_in = sweep_inputs(T, rng, dtype, nx, nu, nc, N, Bt)
    A, B, c, H, h, D, rho, rg, PN, pN = k1_in

    lib1 = library(dtype, nx, nu, nc)
    for export in (True, False):
        for closed in (True, False):
            check(f"K1 [{tag} B={Bt} export={export} closed_loop={closed}]",
                  cr._launch_backward(lib1, *k1_in, export, closed, None),
                  cr.backward_lanes_reference(*k1_in, export_factors=export,
                                              emit_closed_loop=closed), tol)
    K, d, M, v, P, L = cr.backward_lanes_reference(*k1_in, export_factors=True)

    lib = library(dtype, nx, nu)
    hf, x0 = T(N, nz, Bt), T(nx, Bt)
    Pc = torch.einsum("kijb,kjb->kib", P, c).contiguous()
    for pc in (False, True):
        check(f"K2 per-instance [{tag} B={Bt} Pc={pc}]",
              cr._launch_backward_vectors(lib, A, B, c, hf, Pc if pc else P,
                                          K, L, pN, False, pc, None),
              cr.backward_vectors_lanes_reference(
                  A, B, c, hf, P, K, L, pN, Pc=Pc if pc else None), tol)
    check(f"K3 per-instance [{tag} B={Bt}]",
          cr._launch_forward(lib, M, v, K, d, x0, False, None),
          cr.forward_lanes_reference(M, v, K, d, x0), tol)
    # K7 on a batch that leaves the last block's lanes partly idle.
    Bw = Bs
    wide = lambda x: x[..., :1].expand(x.shape[:-1] + (Bw,)).contiguous()
    A7, B7, K7 = wide(A), wide(B), wide(K)
    c7, d7, x07 = T(N, nx, Bw) * 0.1, T(N, nu, Bw), T(nx, Bw)
    check(f"K7 per-instance [{tag} B={Bw}]",
          cr._launch_forward_rollout(lib, A7, B7, c7, K7, d7, x07, None),
          cr.forward_rollout_lanes_reference(A7, B7, c7, K7, d7, x07), tol)

    # K9 in S segments (both forms) from random carries, K10 on its
    # factors, K3 in the same segments; K11 and K12 on the packed streams.
    S = next(n for n in range(2, N + 1) if N % n == 0)
    carries = pdp_carries(T, dtype, nx, S, Bt)
    for export in (False, True):
        check(f"K9 [{tag} B={Bt} S={S} export={export}]",
              cr._launch_backward_pdp(lib1, *k1_in[:8], *carries, export, S,
                                      None),
              cr.backward_pdp_lanes_reference(*k1_in[:8], *carries,
                                              export_factors=export,
                                              segments=S), tol)
    K9, d9, M9, v9, _, P9, L9, F9 = cr.backward_pdp_lanes_reference(
        *k1_in[:8], *carries, export_factors=True, segments=S)[:8]
    Sd = torch.cat([A.flatten(1, 2), B.flatten(1, 2), c], dim=1)
    Sc = torch.cat([H.flatten(1, 2), h, D.flatten(1, 2), rho, rg], dim=1)
    check(f"K11 [{tag} B={Bt}]",
          [cr._launch_backward_packed(lib1, Sd, Sc, PN, pN, nu, None)],
          [cr.backward_packed_reference(Sd, Sc, PN, pN, nu, nc)], tol)
    pi, x0s = T(S, nx, Bt), T(S, nx, Bt)
    check(f"K10 [{tag} B={Bt} S={S}]",
          cr._launch_backward_pdp_vectors(lib, A, B, c, hf, P9, K9, L9, F9,
                                          pi, S, None),
          cr.backward_pdp_vectors_lanes_reference(A, B, c, hf, P9, K9, L9,
                                                  F9, pi, segments=S), tol)
    check(f"K3 segments [{tag} B={Bt} S={S}]",
          cr._launch_forward(lib, M9, v9, K9, d9, x0s, False, None, S),
          cr.forward_lanes_reference(M9, v9, K9, d9, x0s, segments=S), tol)
    G = cr.backward_packed_reference(Sd, Sc, PN, pN, nu, nc)
    check(f"K12 [{tag} B={Bt}]",
          cr._launch_forward_packed(lib, Sd, G, x0, None),
          cr.forward_packed_reference(Sd, G, x0, nu), tol)

    one = lambda x: x[..., :1].contiguous()
    A1, B1, P1, K1, L1, M1 = (one(x) for x in (A, B, P, K, L, M))
    c2, hf2, pN2, x02 = T(N, nx, Bs) * 0.1, T(N, nz, Bs), T(nx, Bs), T(nx, Bs)
    Pc2 = cr.fold_Pc(P1, c2).contiguous()
    for pc in (False, True):
        ref = cr.backward_vectors_lanes_reference(
            A1, B1, c2, hf2, P1, K1, L1, pN2, Pc=Pc2 if pc else None)
        check(f"K2 shared [{tag} B={Bs} Pc={pc}]",
              cr._launch_backward_vectors(lib, A1, B1, c2, hf2,
                                          Pc2 if pc else P1, K1, L1, pN2,
                                          True, pc, None), ref, tol)
    d2, v2 = ref
    check(f"K3 shared [{tag} B={Bs}]",
          cr._launch_forward(lib, M1, v2, K1, d2, x02, True, None),
          cr.forward_lanes_reference(M1, v2, K1, d2, x02), tol)


def run_admm(dtype, nx, nu, nc, N, Bs, cones, diag_cost, has_shift, tol):
    """The two kernels of the split ADMM iteration at one size and mode,
    ``Bs`` scenarios on one shared model (random matrices: at these short
    horizons the recursions need no stable model)."""
    rng = np.random.default_rng(2)
    T = lambda *s: torch.as_tensor(rng.normal(size=s)).to(dtype).contiguous()
    tag = (f"{str(dtype).split('.')[-1]} nx={nx} nu={nu} nc={nc} N={N} B={Bs} "
           f"cones={cones} diag={diag_cost} shift={has_shift}")
    L = torch.tril(T(N, nu, nu) * 0.2)
    L = (L + torch.diag_embed(1.0 + T(N, nu).abs())).unsqueeze(-1)
    k4_in, k5_in = random_admm_inputs(
        rng, T(N, nx, nx, 1) * 0.3, T(N, nx, nu, 1) * 0.5, T(N, nu, nx, 1) * 0.3,
        T(N, nx, nx, 1) * 0.25, L, nc, Bs, cones, diag_cost, has_shift)
    check(f"K4 [{tag}]",
          [ca._launch_bwd_vec_prefold(admm_library(dtype, nx, nu), *k4_in, None)],
          [ca.admm_bwd_vec_prefold_lanes_reference(*k4_in, nu=nu)], tol)
    rho, x0, MK, Hs, D, bnd, dv, wzy, h = k5_in
    lib = admm_library(dtype, nx, nu, nc, cones=cones, diag_cost=diag_cost,
                       has_shift=has_shift)
    for hh in (h, None):
        check(f"K5 [{tag} hf-emit={hh is not None}]",
              ca._launch_fwd_update(lib, rho, x0, MK, None, Hs, D, bnd, dv,
                                    wzy, hh, None, 1.6, 1e-6, None),
              ca.admm_fwd_update_lanes_reference(
                  rho, x0, MK, None, Hs, D, bnd, dv, wzy, hh, nu=nu,
                  cones=cones, alpha=1.6, sigma=1e-6), tol)


def run_ladder(dtype, nx, nu, nc, N, Bs, R, cones, diag_cost, has_shift, tol):
    """K6 (with the Pc form at one rung) and K5's rung form, with and
    without hf-emit, at one size and mode: ``Bs`` scenarios on R rungs of
    one shared model's factors."""
    rng = np.random.default_rng(3)
    T = lambda *s: torch.as_tensor(rng.normal(size=s)).to(dtype).contiguous()
    tag = (f"{str(dtype).split('.')[-1]} nx={nx} nu={nu} nc={nc} N={N} B={Bs} "
           f"R={R} cones={cones} diag={diag_cost} shift={has_shift}")
    k6_in, k5_in, rung, Pc = random_ladder_inputs(
        rng, T(N, nx, nx, 1) * 0.3, T(N, nx, nu, 1) * 0.5, R, nc, Bs, cones,
        diag_cost, has_shift)
    rung = rung if R > 1 else None
    lib6 = admm_library(dtype, nx, nu, nc, fold=True, rungs=R)
    check(f"K6 [{tag}]",
          [ca._launch_bwd_vec(lib6, *k6_in, rung, None, 1e-6, None)],
          [ca.admm_bwd_vec_lanes_reference(*k6_in, nu=nu, sigma=1e-6,
                                           rung=rung)], tol)
    if R == 1:
        pc_in = k6_in[:7] + (None,) + k6_in[8:]
        check(f"K6 Pc form [{tag}]",
              [ca._launch_bwd_vec(lib6, *pc_in, None, Pc, 1e-6, None)],
              [ca.admm_bwd_vec_lanes_reference(*pc_in, nu=nu, sigma=1e-6,
                                               Pc=Pc)], tol)
    rho, x0, M, Hs, D, bnd, dv, wzy, h = k5_in
    K = k6_in[9]
    lib5 = admm_library(dtype, nx, nu, nc, cones=cones, diag_cost=diag_cost,
                        has_shift=has_shift, rungs=R)
    for hh in (None, h):
        check(f"K5 rung form [{tag} hf-emit={hh is not None}]",
              ca._launch_fwd_update(lib5, rho, x0, M, K, Hs, D, bnd, dv, wzy,
                                    hh, rung, 1.6, 1e-6, None),
              ca.admm_fwd_update_lanes_reference(
                  rho, x0, M, K, Hs, D, bnd, dv, wzy, hh, nu=nu,
                  cones=cones, alpha=1.6, sigma=1e-6, rung=rung), tol)


def run_iter(dtype, nx, nu, nc, N, Bs, cones, has_shift, tol):
    """K8 in its eight forms (shared or batched, cached or not, the stage
    data in the compute type or in bfloat16) at one size and mode, ``Bs``
    scenarios."""
    rng = np.random.default_rng(4)
    lib = admm_library(dtype, nx, nu, nc, cones=cones, has_shift=has_shift,
                       single=True)
    for shared in (False, True):
        args = random_iter_inputs(rng, N, nx, nu, nc, Bs, cones, shared,
                                  has_shift, dtype, "cpu")
        for factors in (None, iter_factors(args, shared)):
            for narrow in (False, True):
                a = narrow_storage(args) if narrow else args
                tag = (f"{str(dtype).split('.')[-1]} nx={nx} nu={nu} nc={nc} "
                       f"N={N} B={Bs} cones={cones} shift={has_shift} "
                       f"shared={shared} cached={factors is not None} "
                       f"bf16={narrow}")
                check(f"K8 [{tag}]",
                      ca._launch_iter(lib, *a, factors, shared, 1.6, 1e-6,
                                      None),
                      ca.admm_iter_lanes_reference(
                          *a, nu=nu, cones=cones, alpha=1.6, sigma=1e-6,
                          factors=factors), tol)


def run_k3(dtype, nx, nu, N, Bt, S, tol):
    """Per-instance K3 (one matrix set a scenario) in S segments of N/S
    stages, ``Bt`` scenarios: blocks of the kernel's 8 scenarios, the last
    one ragged where Bt is no multiple of 8."""
    rng = np.random.default_rng(5)
    T = lambda *s: torch.as_tensor(rng.normal(size=s)).to(dtype).contiguous()
    M, K = T(N, nx, nx, Bt) * 0.3, T(N, nu, nx, Bt) * 0.3
    v, d = T(N, nx, Bt), T(N, nu, Bt)
    x0 = T(S, nx, Bt) if S > 1 else T(nx, Bt)
    check(f"K3 per-instance [{str(dtype).split('.')[-1]} nx={nx} nu={nu} "
          f"N={N} B={Bt} S={S}]",
          cr._launch_forward(library(dtype, nx, nu), M, v, K, d, x0, False,
                             None, S),
          cr.forward_lanes_reference(M, v, K, d, x0,
                                     segments=S if S > 1 else None), tol)


def run_sweep(dtype, nx, nu, nc, N, Bt, S, tol, one=False):
    """The matrix sweep on ``Bt`` instances, across its blocks of G
    instances (8 in float32, 4 in float64; the last ragged where Bt is no
    multiple of G): K1 in its four forms, K9 in both forms in S segments,
    K11.  ``one``: as on a card with more SMs than (segment, instance)
    pairs, a block an instance."""
    rng = np.random.default_rng(6)
    T = lambda *s: torch.as_tensor(rng.normal(size=s)).to(dtype).contiguous()
    tag = (f"{str(dtype).split('.')[-1]} nx={nx} nu={nu} nc={nc} N={N} "
           f"B={Bt}" + (" a block an instance" if one else ""))
    k1_in = sweep_inputs(T, rng, dtype, nx, nu, nc, N, Bt)
    # The host code reads the SM count once a library: a library of its own.
    defines = {**cr.kernel_defines(dtype, nx, nu, nc), **({"EMU_SMS": 1 << 20} if one else {})}
    lib = build_host(cr.SOURCE, defines)
    cr.bind_library(lib, with_matrix_sweep=True)
    ctypes.c_int.in_dll(lib, "emu_sms").value = defines.get("EMU_SMS", 1)
    lib.riccati_sweep_group.argtypes = [ctypes.c_int] * 3 + [ctypes.c_longlong]
    for pdp, pairs in ((False, Bt), (True, S * Bt)):
        G = lib.riccati_sweep_group(1, 1, int(pdp), pairs)
        if (G == 0) != one or not one and (Bt <= 2 * G
                                           or G > 1 and Bt % G == 0):
            raise AssertionError(f"{tag}: B={Bt} takes G={G}, not "
                                 + ("a block an instance" if one else
                                    "groups with a ragged third one"))
    for export in (True, False):
        for closed in (True, False):
            check(f"K1 [{tag} export={export} closed_loop={closed}]",
                  cr._launch_backward(lib, *k1_in, export, closed, None),
                  cr.backward_lanes_reference(*k1_in, export_factors=export,
                                              emit_closed_loop=closed), tol)
    carries = pdp_carries(T, dtype, nx, S, Bt)
    for export in (False, True):
        check(f"K9 [{tag} S={S} export={export}]",
              cr._launch_backward_pdp(lib, *k1_in[:8], *carries, export, S,
                                      None),
              cr.backward_pdp_lanes_reference(*k1_in[:8], *carries,
                                              export_factors=export,
                                              segments=S), tol)
    A, B, c, H, h, D, rho, rg, PN, pN = k1_in
    Sd = torch.cat([A.flatten(1, 2), B.flatten(1, 2), c], dim=1)
    Sc = torch.cat([H.flatten(1, 2), h, D.flatten(1, 2), rho, rg], dim=1)
    check(f"K11 [{tag}]",
          [cr._launch_backward_packed(lib, Sd, Sc, PN, pN, nu, None)],
          [cr.backward_packed_reference(Sd, Sc, PN, pN, nu, nc)], tol)


def run_k2(dtype, nx, nu, N, Bt, Bs, tol):
    """K2 in both modes (plain P and Pc) across its blocks, the last one
    ragged: per instance on ``Bt`` scenarios (8 a block) with a matrix set
    each, and on one shared model with ``Bs`` scenarios (32 a block); N
    past the rings' slots, so every slot's barriers go through several
    phases."""
    rng = np.random.default_rng(7)
    T = lambda *s: torch.as_tensor(rng.normal(size=s)).to(dtype).contiguous()
    tag = f"{str(dtype).split('.')[-1]} nx={nx} nu={nu} N={N}"
    lib = library(dtype, nx, nu)
    L = torch.tril(T(N, nu, nu, Bt) * 0.2, diagonal=-1) + torch.diag_embed(
        1.0 + T(N, nu, Bt).abs().transpose(1, 2)).permute(0, 2, 3, 1)
    A, B, K, P = T(N, nx, nx, Bt) * 0.3, T(N, nx, nu, Bt) * 0.5, \
        T(N, nu, nx, Bt) * 0.3, T(N, nx, nx, Bt) * 0.3
    for Bn, one in ((Bt, False), (Bs, True)):
        pick = (lambda x: x[..., :1].contiguous()) if one else (lambda x: x)
        Am, Bm, Km, Pm, Lm = (pick(x) for x in (A, B, K, P, L.contiguous()))
        c, hf, pN = T(N, nx, Bn) * 0.1, T(N, nx + nu, Bn), T(nx, Bn)
        Pc = torch.einsum("kijb,kjb->kib", Pm.expand(N, nx, nx, Bn), c).contiguous()
        for pc in (False, True):
            check(f"K2 {'shared' if one else 'per-instance'} [{tag} B={Bn} Pc={pc}]",
                  cr._launch_backward_vectors(lib, Am, Bm, c, hf, Pc if pc else Pm,
                                              Km, Lm, pN, one, pc, None),
                  cr.backward_vectors_lanes_reference(
                      Am, Bm, c, hf, Pm, Km, Lm, pN, Pc=Pc if pc else None), tol)


def run_k46(dtype, nx, nu, nc, N, Bs, R, tol):
    """Kernel A in both its forms across blocks of 32 scenarios, the last
    ragged where Bs is no multiple of 32, N past the rings' slots: K4 on
    its packed streams, and K6 on R rungs (scenario b on rung b mod R:
    every block mixes them), with its Pc form at one rung."""
    rng = np.random.default_rng(8)
    T = lambda *s: torch.as_tensor(rng.normal(size=s)).to(dtype).contiguous()
    tag = (f"{str(dtype).split('.')[-1]} nx={nx} nu={nu} nc={nc} N={N} B={Bs} "
           f"R={R}")
    A, Bm = T(N, nx, nx, 1) * 0.3, T(N, nx, nu, 1) * 0.5
    K = T(N, nu, nx, 1) * 0.3
    L = torch.tril(T(N, nu, nu) * 0.2, diagonal=-1) + torch.diag_embed(
        1.0 + T(N, nu).abs())
    AK = torch.cat([A, K], dim=1).contiguous()
    BL = torch.cat([Bm, L.unsqueeze(-1)], dim=1).contiguous()
    k4_in = (T(nx, Bs), AK, BL, T(N, nx, Bs) * 0.1, T(N, nx, Bs),
             T(N, nx + nu, Bs))
    check(f"K4 across blocks [{tag}]",
          [ca._launch_bwd_vec_prefold(admm_library(dtype, nx, nu), *k4_in,
                                      None)],
          [ca.admm_bwd_vec_prefold_lanes_reference(*k4_in, nu=nu)], tol)
    k6_in, _, rung, Pc = random_ladder_inputs(rng, A, Bm, R, nc, Bs, (), True,
                                              False)
    rung = rung if R > 1 else None
    lib6 = admm_library(dtype, nx, nu, nc, fold=True, rungs=R)
    check(f"K6 across blocks [{tag}]",
          [ca._launch_bwd_vec(lib6, *k6_in, rung, None, 1e-6, None)],
          [ca.admm_bwd_vec_lanes_reference(*k6_in, nu=nu, sigma=1e-6,
                                           rung=rung)], tol)
    if R == 1:
        pc_in = k6_in[:7] + (None,) + k6_in[8:]
        check(f"K6 Pc form across blocks [{tag}]",
              [ca._launch_bwd_vec(lib6, *pc_in, None, Pc, 1e-6, None)],
              [ca.admm_bwd_vec_lanes_reference(*pc_in, nu=nu, sigma=1e-6,
                                               Pc=Pc)], tol)


def run_k7(dtype, nx, nu, N, Bt, tol):
    """The rollout from the raw dynamics on ``Bt`` scenarios across the
    kernel's blocks of W (32 at these widths), the last ragged, N past
    its ring's slots: K7 on its five streams and K12 on the packed two.
    The streams go as boxes of the copy engine where their rows are whole
    16-byte pieces (Bt a multiple of 4 in float32, of 2 in float64), a
    word a copy otherwise."""
    rng = np.random.default_rng(9)
    T = lambda *s: torch.as_tensor(rng.normal(size=s)).to(dtype).contiguous()
    tag = f"{str(dtype).split('.')[-1]} nx={nx} nu={nu} N={N} B={Bt}"
    A, B, K = T(N, nx, nx, Bt) * 0.2, T(N, nx, nu, Bt) * 0.3, \
        T(N, nu, nx, Bt) * 0.2
    c, d, x0 = T(N, nx, Bt) * 0.1, T(N, nu, Bt), T(nx, Bt)
    lib = library(dtype, nx, nu)
    check(f"K7 across blocks [{tag}]",
          cr._launch_forward_rollout(lib, A, B, c, K, d, x0, None),
          cr.forward_rollout_lanes_reference(A, B, c, K, d, x0), tol)
    Sd = torch.cat([A.flatten(1, 2), B.flatten(1, 2), c], dim=1).contiguous()
    G = torch.cat([K.flatten(1, 2), d], dim=1).contiguous()
    check(f"K12 across blocks [{tag}]",
          cr._launch_forward_packed(lib, Sd, G, x0, None),
          cr.forward_packed_reference(Sd, G, x0, nu), tol)


def run_k10(dtype, nx, nu, N, Bt, S, tol, offset=False):
    """K10 in S segments of N/S stages (N = S: segments of one stage) on
    ``Bt`` scenarios across its blocks of W scenarios of one segment (32
    in float32 and 16 in float64 at the quadrotor's widths, 8 / 4 at the
    centroidal model's, 4 / 2 at nx=40; G = 32 / W lanes a scenario), the
    last ragged: the streams by boxes of the copy engine where every
    stream starts on 16 bytes: boxes of W where the rows are whole 16-byte
    pieces (Bt a multiple of 4 in float32, of 2 in float64), else boxes of
    a 16-byte phase of rows, W + 16 bytes wide, where every stream's rows
    of a stage are whole multiples of the phases (2 or 4) and two slots of
    them fit, else a word a copy.  ``offset``:
    every input starts a word into its storage (word copies).  Random
    factors: K10 needs no relation between them."""
    rng = np.random.default_rng(14)
    T = lambda *s: torch.as_tensor(rng.normal(size=s)).to(dtype).contiguous()
    g = 1.0 / nx ** 0.5                  # products of norm about one
    tag = f"{str(dtype).split('.')[-1]} nx={nx} nu={nu} N={N} B={Bt} S={S}"
    A, B, P, F = (T(N, nx, nx, Bt) * g, T(N, nx, nu, Bt) * g,
                  T(N, nx, nx, Bt) * g, T(N, nx, nx, Bt) * g)
    K = T(N, nu, nx, Bt) * g
    L = (torch.tril(T(N, nu, nu, Bt).permute(0, 3, 1, 2) * 0.2, diagonal=-1)
         + torch.diag_embed(1.0 + T(N, Bt, nu).abs())).permute(0, 2, 3, 1)
    k10_in = (A, B, T(N, nx, Bt) * 0.1, T(N, nx + nu, Bt), P, K,
              L.contiguous(), F, T(S, nx, Bt))
    if offset:
        def shifted(x):
            buf = torch.empty(x.numel() + 1, dtype=dtype)
            buf[1:].copy_(x.flatten())
            return buf[1:].view(x.shape)
        k10_in = tuple(shifted(x) for x in k10_in)
        tag += " offset"
    check(f"K10 across blocks [{tag}]",
          cr._launch_backward_pdp_vectors(library(dtype, nx, nu), *k10_in, S,
                                          None),
          cr.backward_pdp_vectors_lanes_reference(*k10_in, segments=S), tol)


def run_narrow_sweep(dtype, nx, nu, nc, N, Bt, tol, one=False):
    """The matrix sweep's forms on bfloat16 stage streams (K1 gains only,
    K11) on ``Bt`` instances, in the compute type ``dtype``: across its
    groups of G, the stages landing in boxes of the copy engine (8
    instances a row) where Bt is a multiple of 8 and the library's
    staging takes boxes, else as pairs (a ragged last group; an odd Bt
    puts every other entry's first instance in a pair's second half), the
    block widening [A c B] and the products reading the rest of a stage
    in bfloat16 from the staging, N past the staging's stages, or
    (``one``) a block an instance (pairs)."""
    rng = np.random.default_rng(10)
    T = lambda *s: torch.as_tensor(rng.normal(size=s)).to(dtype).contiguous()
    tag = (f"{str(dtype).split('.')[-1]} nx={nx} nu={nu} nc={nc} N={N} "
           f"B={Bt} bf16" + (" a block an instance" if one else ""))
    A, B, c, H, h, D, rho, rg, PN, pN = sweep_inputs(T, rng, dtype, nx, nu,
                                                     nc, N, Bt)
    narrow = narrow_streams((A, B, c, H, h, D, rho, rg))
    defines = {**cr.kernel_defines(dtype, nx, nu, nc, narrow=True),
               **({"EMU_SMS": 1 << 20} if one else {})}
    lib = build_host(cr.SOURCE, defines)
    cr.bind_library(lib, with_matrix_sweep=True, narrow=True)
    ctypes.c_int.in_dll(lib, "emu_sms").value = defines.get("EMU_SMS", 1)
    lib.riccati_sweep_group.argtypes = [ctypes.c_int] * 3 + [ctypes.c_longlong]
    G = lib.riccati_sweep_group(0, 0, 0, Bt)
    if (G == 0) != one or not one and Bt <= G:
        raise AssertionError(f"{tag}: B={Bt} takes G={G}")
    # Boxes where Bt is a multiple of their 8 instances, else pairs.
    tag += " boxes" if G > 0 and Bt % 8 == 0 else " pairs"
    check(f"K1 gains [{tag}]",
          cr._launch_backward(lib, *narrow, PN, pN, False, False, None),
          cr.backward_lanes_reference(*narrow, PN, pN,
                                      emit_closed_loop=False), tol)
    Sd, Sc = pack_streams(*narrow)
    check(f"K11 [{tag}]",
          [cr._launch_backward_packed(lib, Sd, Sc, PN, pN, nu, None)],
          [cr.backward_packed_reference(Sd, Sc, PN, pN, nu, nc)], tol)


def run_narrow_k7(dtype, nx, nu, N, Bt, tol):
    """K7 and K12 on bfloat16 dynamics (A, B, c; Sd) and gains in the
    compute type, across three blocks of W (the last ragged), N past the
    ring's slots: boxes of a bfloat16 map where Bt is a multiple of 8, the
    PAIRS form's aligned 4-byte pairs otherwise (an odd Bt: rows starting
    mid-pair)."""
    rng = np.random.default_rng(11)
    T = lambda *s: torch.as_tensor(rng.normal(size=s)).to(dtype).contiguous()
    tag = f"{str(dtype).split('.')[-1]} nx={nx} nu={nu} N={N} B={Bt} bf16"
    A, B, c = narrow_streams((T(N, nx, nx, Bt) * 0.2, T(N, nx, nu, Bt) * 0.3,
                              T(N, nx, Bt) * 0.1))
    K, d, x0 = T(N, nu, nx, Bt) * 0.2, T(N, nu, Bt), T(nx, Bt)
    lib = library(dtype, nx, nu, narrow=True)
    check(f"K7 across blocks [{tag}]",
          cr._launch_forward_rollout(lib, A, B, c, K, d, x0, None),
          cr.forward_rollout_lanes_reference(A, B, c, K, d, x0), tol)
    Sd = torch.cat([A.flatten(1, 2), B.flatten(1, 2), c], dim=1).contiguous()
    G = torch.cat([K.flatten(1, 2), d], dim=1).contiguous()
    check(f"K12 across blocks [{tag}]",
          cr._launch_forward_packed(lib, Sd, G, x0, None),
          cr.forward_packed_reference(Sd, G, x0, nu), tol)


# (dtype, nx, nu, nc, N, Bt, Bs, tol).  Quadrotor widths in both dtypes
# (one shared instance, as served; a batch of 64 fills its blocks, 70
# leaves a ragged last block), no constraint rows, two odd small shapes.
CASES = [
    (torch.float64, 12, 4, 16, 6, 1, 70, 1e-10),
    (torch.float32, 5, 2, 3, 7, 2, 33, 1e-3),
    (torch.float32, 12, 4, 16, 9, 3, 64, 1e-3),
    (torch.float64, 12, 4, 0, 5, 2, 70, 1e-10),
    (torch.float64, 2, 1, 1, 4, 1, 5, 1e-10),
]
# (dtype, nx, nu, N, Bt, Bs, tol): K2 per instance across blocks of 8
# scenarios, the last ragged (19: a word a copy; 20 in float32: 16-byte
# copies in the whole blocks), and shared across blocks of 32 (69, 64),
# N past the slots of both rings; odd widths.
K2_CASES = [
    (torch.float64, 12, 4, 11, 19, 69, 1e-10),
    (torch.float32, 12, 4, 10, 20, 64, 1e-4),
    (torch.float64, 3, 2, 9, 17, 33, 1e-10),
]
def run_narrow_admm(dtype, nx, nu, nc, N, Bs, cones, diag_cost, has_shift,
                    tol):
    """The narrow forms of the split pair (K4 on bfloat16 AK, BL, c; K5
    packed on bfloat16 MK, Hs, D, h, with and without hf-emit) at one size
    and mode, ``Bs`` scenarios on one shared model: c by boxes of the
    bfloat16 map where Bs is a multiple of 8, by 2-byte loads otherwise."""
    rng = np.random.default_rng(12)
    T = lambda *s: torch.as_tensor(rng.normal(size=s)).to(dtype).contiguous()
    tag = (f"{str(dtype).split('.')[-1]} nx={nx} nu={nu} nc={nc} N={N} B={Bs} "
           f"cones={cones} diag={diag_cost} shift={has_shift} bf16")
    L = torch.tril(T(N, nu, nu) * 0.2)
    L = (L + torch.diag_embed(1.0 + T(N, nu).abs())).unsqueeze(-1)
    k4_in, k5_in = random_admm_inputs(
        rng, T(N, nx, nx, 1) * 0.3, T(N, nx, nu, 1) * 0.5, T(N, nu, nx, 1) * 0.3,
        T(N, nx, nx, 1) * 0.25, L, nc, Bs, cones, diag_cost, has_shift)
    k4_in, k5_in = narrow_args(k4_in, K4_NARROW), narrow_args(k5_in, K5_NARROW)
    check(f"K4 [{tag}]",
          [ca._launch_bwd_vec_prefold(admm_library(dtype, nx, nu, narrow=True),
                                      *k4_in, None)],
          [ca.admm_bwd_vec_prefold_lanes_reference(*k4_in, nu=nu)], tol)
    rho, x0, MK, Hs, D, bnd, dv, wzy, h = k5_in
    lib = admm_library(dtype, nx, nu, nc, cones=cones, diag_cost=diag_cost,
                       has_shift=has_shift, narrow=True)
    for hh in (h, None):
        check(f"K5 [{tag} hf-emit={hh is not None}]",
              ca._launch_fwd_update(lib, rho, x0, MK, None, Hs, D, bnd, dv,
                                    wzy, hh, None, 1.6, 1e-6, None),
              ca.admm_fwd_update_lanes_reference(
                  rho, x0, MK, None, Hs, D, bnd, dv, wzy, hh, nu=nu,
                  cones=cones, alpha=1.6, sigma=1e-6), tol)


def run_narrow_ladder(dtype, nx, nu, nc, N, Bs, R, cones, diag_cost, has_shift,
                      tol):
    """The narrow forms of the ladder's pair at one size and mode: K6 on R
    rungs of bfloat16 factors with bfloat16 A, B, h, D, c (and its Pc form
    at one rung), K5's rung form on bfloat16 M, K, Hs, D without and with
    hf-emit."""
    rng = np.random.default_rng(13)
    T = lambda *s: torch.as_tensor(rng.normal(size=s)).to(dtype).contiguous()
    tag = (f"{str(dtype).split('.')[-1]} nx={nx} nu={nu} nc={nc} N={N} B={Bs} "
           f"R={R} cones={cones} diag={diag_cost} shift={has_shift} bf16")
    k6_in, k5_in, rung, Pc = random_ladder_inputs(
        rng, T(N, nx, nx, 1) * 0.3, T(N, nx, nu, 1) * 0.5, R, nc, Bs, cones,
        diag_cost, has_shift)
    k6_in, k5_in = narrow_args(k6_in, K6_NARROW), narrow_args(k5_in, K5_NARROW)
    rung = rung if R > 1 else None
    lib6 = admm_library(dtype, nx, nu, nc, fold=True, rungs=R, narrow=True)
    check(f"K6 [{tag}]",
          [ca._launch_bwd_vec(lib6, *k6_in, rung, None, 1e-6, None)],
          [ca.admm_bwd_vec_lanes_reference(*k6_in, nu=nu, sigma=1e-6,
                                           rung=rung)], tol)
    if R == 1:
        pc_in = k6_in[:7] + (None,) + k6_in[8:]
        check(f"K6 Pc form [{tag}]",
              [ca._launch_bwd_vec(lib6, *pc_in, None, Pc, 1e-6, None)],
              [ca.admm_bwd_vec_lanes_reference(*pc_in, nu=nu, sigma=1e-6,
                                               Pc=Pc)], tol)
    rho, x0, M, Hs, D, bnd, dv, wzy, h = k5_in
    K = k6_in[9]
    lib5 = admm_library(dtype, nx, nu, nc, cones=cones, diag_cost=diag_cost,
                        has_shift=has_shift, rungs=R, narrow=True)
    for hh in (None, h):
        check(f"K5 rung form [{tag} hf-emit={hh is not None}]",
              ca._launch_fwd_update(lib5, rho, x0, M, K, Hs, D, bnd, dv, wzy,
                                    hh, rung, 1.6, 1e-6, None),
              ca.admm_fwd_update_lanes_reference(
                  rho, x0, M, K, Hs, D, bnd, dv, wzy, hh, nu=nu,
                  cones=cones, alpha=1.6, sigma=1e-6, rung=rung), tol)


# (dtype, nx, nu, nc, N, Bs, cones, diag_cost, has_shift, tol): the
# quadrotor's box rows with a diagonal and a full stage cost, its thrust
# cone with a shift, a rotated cone and two cones on odd small shapes.
ADMM_CASES = [
    (torch.float64, 12, 4, 19, 21, 70, ((16, 3, "soc"),), True, True, 1e-10),
    (torch.float64, 12, 4, 16, 5, 33, (), True, False, 1e-10),
    (torch.float32, 12, 4, 16, 7, 64, (), False, False, 1e-3),
    (torch.float64, 5, 2, 7, 6, 40, ((1, 4, "rsoc"),), False, False, 1e-10),
    (torch.float32, 3, 2, 9, 5, 33, ((0, 3, "soc"), (4, 5, "rsoc")), True,
     True, 1e-3),
    (torch.float64, 2, 1, 1, 4, 5, (), False, False, 1e-10),
    # The float32 diagonal-cost forms' tail warps (9 with hf-emit, 12
    # without), N past their slots (12 and 15) twice.
    (torch.float32, 12, 4, 16, 33, 40, (), True, False, 1e-3),
]
# (dtype, nx, nu, nc, N, Bs, R, tol): kernel A (K4, and K6 on R rungs)
# across blocks of 32 scenarios, N past the rings' slots (at most 10): the
# rows by the copy engine (70 in float64, 96 in float32: the row stride a
# multiple of 16 bytes) and a word a copy (67, 65: it is not), a ragged
# last block (70, 67, 65, 37), K6 at R = 4, 3, 1 (with its Pc form) and
# at odd widths.
K46_CASES = [
    (torch.float64, 12, 4, 16, 23, 70, 4, 1e-10),
    (torch.float32, 12, 4, 19, 13, 67, 3, 1e-4),
    (torch.float64, 12, 4, 16, 12, 65, 1, 1e-10),
    (torch.float32, 12, 4, 16, 12, 96, 1, 1e-4),
    (torch.float64, 3, 2, 5, 12, 37, 2, 1e-10),
]
# (dtype, nx, nu, nc, N, Bs, R, cones, diag_cost, has_shift, tol): the
# quadrotor's box rows on four rungs, its thrust cone with a shift on
# three, one rung (with K6's Pc form) and an odd small shape.
LADDER_CASES = [
    (torch.float64, 12, 4, 16, 20, 40, 4, (), True, False, 1e-10),
    (torch.float32, 12, 4, 19, 4, 33, 3, ((16, 3, "soc"),), True, True, 1e-3),
    (torch.float64, 12, 4, 16, 4, 33, 1, (), False, False, 1e-10),
    (torch.float64, 3, 2, 6, 5, 35, 2, ((3, 3, "soc"),), False, True, 1e-10),
]
# (dtype, nx, nu, nc, N, Bs, cones, has_shift, tol): the quadrotor's thrust
# cone with a shift (a ragged last block), its box rows, the rocket's two
# cones, and a rotated cone on an odd small shape.
ITER_CASES = [
    (torch.float64, 12, 4, 19, 5, 6, ((16, 3, "soc"),), True, 1e-10),
    (torch.float32, 12, 4, 16, 4, 8, (), False, 1e-3),
    (torch.float64, 6, 3, 7, 4, 5, ((1, 3, "soc"), (4, 3, "soc")), False, 1e-10),
    (torch.float64, 3, 2, 9, 5, 7, ((0, 4, "rsoc"),), True, 1e-10),
    # Across blocks: B = 2 * 8 + 3 (K8's blocks of 8 warps, the last
    # ragged; odd B puts bf16 rows at odd offsets), at the quadrotor's
    # widths and at odd ones (odd bf16 stage blocks).
    (torch.float32, 12, 4, 19, 4, 19, ((16, 3, "soc"),), True, 1e-3),
    (torch.float64, 12, 4, 16, 3, 19, (), False, 1e-10),
    (torch.float64, 3, 2, 5, 5, 19, ((1, 3, "soc"),), True, 1e-10),
    (torch.float32, 3, 2, 5, 4, 19, (), False, 1e-3),
]
# (dtype, nx, nu, N, Bt, S, tol): per-instance K3 across its blocks of 8
# scenarios, the last ragged (19), at S=1 and in 4 segments; batches of
# 20 (float32: 16-byte copies in the whole blocks, a word a copy in the
# last) and 16 (float64, whole blocks), and odd widths.
K3_CASES = [
    (torch.float64, 12, 4, 8, 19, 4, 1e-10),
    (torch.float64, 12, 4, 8, 19, 1, 1e-10),
    (torch.float32, 12, 4, 8, 20, 4, 1e-4),
    (torch.float64, 12, 4, 6, 16, 1, 1e-10),
    (torch.float64, 3, 2, 6, 19, 2, 1e-10),
]
# (dtype, nx, nu, nc, N, Bt, S, tol[, one]): the matrix sweep across its
# groups of G instances (G = 4 in float64, 8 in float32), the last group
# ragged: Bt = 2G + 2 (a multiple of the 16-byte width: 16-byte stores, the
# last group half empty) and 2G + 3 (a word a store) at the quadrotor's
# widths, and odd widths; then a block an instance (few pairs, many SMs).
SWEEP_CASES = [
    (torch.float64, 12, 4, 16, 4, 10, 2, 1e-10),
    (torch.float64, 12, 4, 16, 4, 11, 2, 1e-10),
    (torch.float32, 12, 4, 16, 4, 20, 2, 1e-4),
    (torch.float32, 12, 4, 16, 4, 19, 2, 1e-4),
    (torch.float64, 3, 2, 5, 6, 11, 3, 1e-10),
    (torch.float32, 3, 2, 5, 4, 19, 4, 1e-4),
    (torch.float64, 12, 4, 16, 4, 5, 2, 1e-10, True),
    (torch.float32, 3, 2, 5, 4, 3, 4, 1e-4, True),
]
# (dtype, nx, nu, N, Bt, tol): K7 and K12 across three blocks of 32
# scenarios, the last ragged, N three times the ring's slots or more (3 in
# float64, 6 in float32 at the quadrotor's widths; 8 at odd small ones):
# the copy engine's boxes (70 in float64, 68 and 72 in float32) and a word
# a copy (67 in both, 69), at the quadrotor's widths and odd small ones;
# then at the mass-spring chain's widths (nx=40, nu=10), where a block
# takes W = 4 scenarios (float32: 5 slots, float64: 2) and A seven boxes a
# stage: boxes (12 in float32; 10 in float64, the last block ragged) and
# a word a copy (10 in float32).
K7_CASES = [
    (torch.float64, 12, 4, 10, 70, 1e-10),
    (torch.float32, 12, 4, 19, 67, 1e-4),
    (torch.float32, 12, 4, 19, 68, 1e-4),
    (torch.float64, 12, 4, 10, 67, 1e-10),
    (torch.float64, 3, 2, 25, 69, 1e-10),
    (torch.float32, 3, 2, 25, 72, 1e-4),
    (torch.float32, 40, 10, 16, 12, 1e-4),
    (torch.float32, 40, 10, 16, 10, 1e-4),
    (torch.float64, 40, 10, 7, 10, 1e-10),
]
# The two widest models, in both dtypes: the mass-spring chain (nx=40,
# nu=10, no constraint rows; the ADMM kernels, which need rows, with a box
# on each of its 10 forces) and the centroidal model (nx=24, nu=6, its two
# friction cones of 3 rows).  Every kernel that the wide requests run and
# every other, in the forms of the cases above: ``run`` (K1-K3, K7, K9-K12,
# shared and per instance), the split pair K4 + K5 (both hf forms), K4 and
# K6 across blocks, K8 in its eight forms, K2 in both forms across blocks,
# the matrix sweep across groups (G = 1 at nz=50 in float64, 2 in float32;
# 2 / 4 at nz=30; enough instances for more than one block on the
# emulator's one SM) and a block an instance, K7 and K12 at nz=30.
CENTROIDAL_CONES = ((0, 3, "soc"), (3, 3, "soc"))
WIDE_CASES = [
    (torch.float64, 40, 10, 0, 4, 2, 35, 1e-10),
    (torch.float32, 40, 10, 0, 4, 3, 33, 1e-3),
    (torch.float64, 24, 6, 6, 6, 3, 35, 1e-10),
    (torch.float32, 24, 6, 6, 5, 2, 33, 1e-3),
]
WIDE_ADMM_CASES = [
    (torch.float64, 24, 6, 6, 6, 35, CENTROIDAL_CONES, True, False, 1e-10),
    (torch.float32, 24, 6, 6, 5, 64, CENTROIDAL_CONES, True, False, 1e-3),
    (torch.float64, 40, 10, 10, 4, 33, (), True, False, 1e-10),
    (torch.float32, 40, 10, 10, 4, 36, (), False, False, 1e-3),
]
WIDE_K46_CASES = [
    (torch.float64, 24, 6, 6, 12, 70, 2, 1e-10),
    (torch.float32, 24, 6, 6, 12, 67, 1, 1e-4),
    (torch.float64, 40, 10, 10, 9, 37, 1, 1e-10),
    (torch.float32, 40, 10, 10, 9, 36, 2, 1e-4),
]
WIDE_ITER_CASES = [
    (torch.float64, 24, 6, 6, 4, 9, CENTROIDAL_CONES, False, 1e-10),
    (torch.float32, 24, 6, 6, 3, 9, CENTROIDAL_CONES, False, 1e-3),
    (torch.float64, 40, 10, 10, 3, 5, (), False, 1e-10),
    (torch.float32, 40, 10, 10, 3, 5, (), False, 1e-3),
]
WIDE_K2_CASES = [
    (torch.float64, 40, 10, 9, 19, 35, 1e-10),
    (torch.float32, 24, 6, 10, 20, 64, 1e-4),
    (torch.float64, 24, 6, 9, 17, 33, 1e-10),
]
WIDE_SWEEP_CASES = [
    (torch.float64, 40, 10, 0, 4, 5, 2, 1e-10),
    (torch.float32, 40, 10, 0, 4, 7, 2, 1e-4),
    (torch.float64, 24, 6, 6, 4, 7, 2, 1e-10),
    (torch.float32, 24, 6, 6, 4, 11, 2, 1e-4),
    (torch.float64, 40, 10, 0, 4, 2, 2, 1e-10, True),
    (torch.float32, 24, 6, 6, 4, 2, 2, 1e-4, True),
]
WIDE_K7_CASES = [
    (torch.float64, 24, 6, 10, 70, 1e-10),
    (torch.float32, 24, 6, 12, 67, 1e-4),
]
# (dtype, nx, nu, N, Bt, S, tol[, offset]): K10 across its blocks, the
# last ragged: boxes of the copy engine (68 and 20 in float32, 34 and 4 in
# float64), boxes of a 16-byte phase of rows, W + 16 bytes wide from the
# piece the phase starts in (67, 65: four phases in float32 at the
# quadrotor's widths; 66: two; 19 and 9 in float64: two; 18 at the
# centroidal model's in float32: two) and a word a copy (at nx=40, where
# two slots of the phases' wider rows do not fit: 9 in float32, 5 and 3
# in float64; 64 with every input a word into its storage), in one segment past the ring's slots (3 at the quadrotor's and
# the centroidal model's widths, 2 at nx=40), in 4 and 2 and in segments
# of one stage (N = S), at the quadrotor's, the centroidal model's and the
# mass-spring chain's widths (G = 2 lanes a scenario at the quadrotor's in
# float64, 4 and 8 at the centroidal model's, 8 and 16 at nx=40).
K10_CASES = [
    (torch.float64, 12, 4, 6, 34, 2, 1e-10),
    (torch.float64, 12, 4, 5, 19, 5, 1e-10),
    (torch.float64, 40, 10, 4, 5, 1, 1e-10),
    (torch.float32, 12, 4, 8, 68, 1, 1e-4),
    (torch.float32, 12, 4, 8, 67, 4, 1e-4),
    (torch.float32, 12, 4, 6, 65, 2, 1e-4),
    (torch.float32, 12, 4, 5, 66, 5, 1e-4),
    (torch.float32, 12, 4, 4, 64, 2, 1e-4, True),
    (torch.float32, 24, 6, 8, 20, 1, 1e-4),
    (torch.float64, 24, 6, 4, 9, 4, 1e-10),
    (torch.float32, 40, 10, 6, 12, 2, 1e-4),
    (torch.float64, 40, 10, 3, 3, 3, 1e-10),
    (torch.float32, 40, 10, 4, 9, 2, 1e-4),
    (torch.float32, 24, 6, 4, 18, 2, 1e-4),
]
# (dtype, nx, nu, nc, N, Bt, tol[, one]): the narrow forms of the matrix
# sweep (K1 gains only, K11 on bfloat16 stage streams) across their groups
# (G = 4 in float64, 8 in float32 at the quadrotor's and the centroidal
# model's widths), N past the staging's stages (3 at the quadrotor's
# widths, 2 at the centroidal model's): boxes (Bt a multiple of 8: 24, 16;
# in float64 two groups a box row, the second starting mid-row; the
# streams' box regions at odd widths, nx=3, nu=2), pairs (the last group
# ragged; 2G + 3, 19 and 11: odd, at odd offsets; 18 and 12: even), at the
# widest widths (nx=40, nu=10, no constraint rows: regions of no rows;
# float64 G = 1) and a block an instance (pairs; an odd batch).
NARROW_SWEEP_CASES = [
    (torch.float64, 12, 4, 16, 4, 11, 1e-10),
    (torch.float32, 12, 4, 16, 4, 24, 1e-4),
    (torch.float32, 24, 6, 6, 5, 16, 1e-4),
    (torch.float64, 12, 4, 16, 5, 16, 1e-10),
    (torch.float32, 24, 6, 6, 4, 19, 1e-4),
    (torch.float32, 12, 4, 16, 4, 18, 1e-4),
    (torch.float32, 12, 4, 16, 4, 19, 1e-4),
    (torch.float64, 3, 2, 5, 6, 11, 1e-10),
    (torch.float64, 3, 2, 5, 7, 16, 1e-10),
    (torch.float64, 12, 4, 16, 4, 5, 1e-10, True),
    (torch.float32, 3, 2, 5, 4, 3, 1e-4, True),
    (torch.float64, 40, 10, 0, 3, 5, 1e-10),
    (torch.float64, 40, 10, 0, 3, 8, 1e-10),
    (torch.float64, 24, 6, 6, 3, 12, 1e-10),
    (torch.float64, 24, 6, 6, 3, 11, 1e-10),
    (torch.float64, 24, 6, 6, 3, 16, 1e-10),
    (torch.float32, 40, 10, 0, 3, 7, 1e-4),
]
# (dtype, nx, nu, N, Bt, tol): the narrow forms of K7 and K12 across three
# blocks, the last ragged, N past the slots: boxes of the bfloat16 map (72
# in float32, 80 in float64: Bt a multiple of 8), pairs (67, 69, 37: odd,
# 69 with streams that end mid-pair; 70, 250, 20 even but no multiple of
# 8), at the quadrotor's
# widths (8 slots), odd small ones, the centroidal model's (float64: W =
# 16, 5 slots) and the mass-spring chain's (W = 8; 4 slots in float32, 3
# in float64).
NARROW_K7_CASES = [
    (torch.float32, 12, 4, 19, 72, 1e-4),
    (torch.float32, 12, 4, 19, 67, 1e-4),
    (torch.float64, 12, 4, 10, 80, 1e-10),
    (torch.float64, 12, 4, 10, 70, 1e-10),
    (torch.float64, 3, 2, 25, 69, 1e-10),
    (torch.float32, 12, 4, 5, 250, 1e-4),
    (torch.float32, 40, 10, 16, 24, 1e-4),
    (torch.float64, 40, 10, 7, 20, 1e-10),
    (torch.float32, 24, 6, 9, 72, 1e-4),
    (torch.float64, 24, 6, 11, 37, 1e-10),
]
# (dtype, nx, nu, nc, N, Bs, cones, diag_cost, has_shift, tol): the narrow
# split pair (K4, K5 packed) across blocks of 32, N past the rings' slots:
# c by boxes of the bfloat16 map (72: a multiple of 8, the last block
# ragged) and by 2-byte loads (67: odd, every other row starting mid-word;
# 250: even, no multiple of 8), the thrust cone with a shift and a full
# stage cost, and at the mass-spring chain's widths in float64 (the slots
# within 227 KB).
NARROW_ADMM_CASES = [
    (torch.float64, 12, 4, 19, 21, 72, ((16, 3, "soc"),), True, True, 1e-10),
    (torch.float32, 12, 4, 16, 7, 67, (), False, False, 1e-4),
    (torch.float64, 12, 4, 16, 5, 250, (), True, False, 1e-10),
    (torch.float64, 40, 10, 10, 4, 33, (), False, False, 1e-10),
]
# (dtype, nx, nu, nc, N, Bs, R, cones, diag_cost, has_shift, tol): the
# narrow ladder pair (K6 on R rungs, its widening warp handing each slot to
# the folds, its Pc form at one; K5's rung form) across blocks, N past the
# slots: c by boxes (72, R=4), by 2-byte loads on an odd batch with the
# thrust cone (67, R=3) and on 250, one rung; the centroidal model's
# widths, odd widths (runs of odd lengths), and the mass-spring chain's
# widths in float64 on two rungs.
NARROW_LADDER_CASES = [
    (torch.float64, 12, 4, 16, 20, 72, 4, (), True, False, 1e-10),
    (torch.float32, 12, 4, 19, 6, 67, 3, ((16, 3, "soc"),), True, True, 1e-4),
    (torch.float64, 12, 4, 16, 5, 250, 1, (), False, False, 1e-10),
    (torch.float32, 24, 6, 6, 12, 40, 1, CENTROIDAL_CONES, True, False, 1e-4),
    (torch.float64, 3, 2, 5, 13, 35, 2, ((1, 3, "soc"),), False, True, 1e-10),
    (torch.float64, 40, 10, 10, 4, 33, 2, (), True, False, 1e-10),
    # The float32 diagonal-cost rung form's 12 tail warps (9 with hf-emit),
    # N past their 15 slots twice.
    (torch.float32, 12, 4, 16, 33, 40, 4, (), True, False, 1e-4),
]
WIDE = (WIDE_CASES, WIDE_ADMM_CASES, [], WIDE_ITER_CASES, [],
        WIDE_SWEEP_CASES, WIDE_K2_CASES, WIDE_K46_CASES, WIDE_K7_CASES)

# K5 on a batch whose rows the copy engine takes (70 in float64) and on one
# it does not (33: a word a copy); every kernel of ``run`` at the
# mass-spring chain's widths in float64 (the shared-memory fits of K2 and K3
# in both forms and of K9's single out slot).
QUICK, ADMM_QUICK, LADDER_QUICK = (CASES[:1] + WIDE_CASES[:1], ADMM_CASES[:2],
                                   LADDER_CASES[:1])
ITER_QUICK, K3_QUICK, SWEEP_QUICK = ITER_CASES[:1], K3_CASES[:1], SWEEP_CASES[:1]
K2_QUICK, K46_QUICK, K7_QUICK = K2_CASES[:1], K46_CASES[:1], K7_CASES[:1]
NARROW_SWEEP_QUICK, NARROW_K7_QUICK = NARROW_SWEEP_CASES[:3], NARROW_K7_CASES[:2]
NARROW_ADMM_QUICK, NARROW_LADDER_QUICK = (NARROW_ADMM_CASES[:1],
                                          NARROW_LADDER_CASES[:1])
# K10 on boxes and on a box a 16-byte phase of rows in segments of one
# stage (the libraries of QUICK's float64 cases; two lanes a scenario) and
# at nx=40 (16 lanes a scenario).
K10_QUICK = K10_CASES[:3]


def main(cases=CASES, admm_cases=ADMM_CASES, ladder_cases=LADDER_CASES,
         iter_cases=ITER_CASES, k3_cases=K3_CASES, sweep_cases=SWEEP_CASES,
         k2_cases=K2_CASES, k46_cases=K46_CASES, k7_cases=K7_CASES,
         narrow_sweep_cases=(), narrow_k7_cases=(), narrow_admm_cases=(),
         narrow_ladder_cases=(), k10_cases=()):
    (OUT / "include").mkdir(parents=True, exist_ok=True)
    for name, text in HEADERS.items():
        (OUT / "include" / name).write_text(text)
    for case in cases:
        run(*case)
    for case in admm_cases:
        run_admm(*case)
    for case in ladder_cases:
        run_ladder(*case)
    for case in iter_cases:
        run_iter(*case)
    for case in k3_cases:
        run_k3(*case)
    for case in sweep_cases:
        run_sweep(*case)
    for case in k2_cases:
        run_k2(*case)
    for case in k46_cases:
        run_k46(*case)
    for case in k7_cases:
        run_k7(*case)
    for case in k10_cases:
        run_k10(*case)
    for case in narrow_sweep_cases:
        run_narrow_sweep(*case)
    for case in narrow_k7_cases:
        run_narrow_k7(*case)
    for case in narrow_admm_cases:
        run_narrow_admm(*case)
    for case in narrow_ladder_cases:
        run_narrow_ladder(*case)
    print("emulated kernels agree with their plain versions")
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    if "--quick" in args:
        sys.exit(main(QUICK, ADMM_QUICK, LADDER_QUICK, ITER_QUICK, K3_QUICK,
                      SWEEP_QUICK, K2_QUICK, K46_QUICK, K7_QUICK,
                      NARROW_SWEEP_QUICK, NARROW_K7_QUICK, NARROW_ADMM_QUICK,
                      NARROW_LADDER_QUICK, K10_QUICK))
    if "--wide" in args:
        sys.exit(main(*WIDE))
    if "--k10" in args:
        sys.exit(main([], [], [], [], [], [], [], [], [], k10_cases=K10_CASES))
    if "--narrow" in args:
        sys.exit(main([], [], [], [], [], [], [], [], [], NARROW_SWEEP_CASES,
                      NARROW_K7_CASES, NARROW_ADMM_CASES,
                      NARROW_LADDER_CASES))
    main(narrow_sweep_cases=NARROW_SWEEP_CASES,
         narrow_k7_cases=NARROW_K7_CASES, narrow_admm_cases=NARROW_ADMM_CASES,
         narrow_ladder_cases=NARROW_LADDER_CASES, k10_cases=K10_CASES)
    sys.exit(main(*WIDE))
