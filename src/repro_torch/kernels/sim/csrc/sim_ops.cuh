// The simulators' opcode space and its evaluation, shared by sim_dense.cu
// and sim_sparse.cu.
//
// SimOp is the order of _OPS in repro_torch/core/sim_vec.py (the tests read
// it from this file and compare). The host (kernels/sim/sim.py, canon_op)
// rewrites each SimOp into one of 14 micro-ops (Uop, the order of UOPS
// there) over permuted operands: min and max become z & 1 ? max : min, gt,
// ge, lt and le become x + (z & 1) > y (lt and le with x and y swapped), eq
// and ne (x != y) ^ z, mux, sel, phi and steer one select, pass and zero an
// add of zeros. Each micro-op is the interpreter's PE_OPS formula with the
// reference's 16-bit mask; values stay in [0, 0xFFFF], so uint32
// arithmetic is exact (a 16-bit product fits).

#pragma once

#include <stdint.h>

namespace {

enum SimOp {
  kOp_zero, kOp_pass, kOp_add, kOp_sub, kOp_mul, kOp_and, kOp_or, kOp_xor,
  kOp_shr, kOp_shl, kOp_min, kOp_max, kOp_abs, kOp_gt, kOp_lt, kOp_eq,
  kOp_ne, kOp_ge, kOp_le, kOp_mux, kOp_sel, kOp_phi, kOp_steer, kOp_rom,
  kOp_acc, kOp_accp,
};

enum Uop {
  kU_add, kU_sub, kU_mul, kU_and, kU_or, kU_xor, kU_shr, kU_shl, kU_minmax,
  kU_abs, kU_gtz, kU_nez, kU_sel, kU_accp,
};

constexpr uint32_t kMask = 0xFFFFu;

// Micro-op u over (x, y, z), without a branch: every candidate is computed
// (independent instructions, issued back to back) and a 4-level select
// tree on u's bits picks one (u 12 and 13 sit a level higher). The select
// costs about as much as the candidates; a switch would be an indirect
// branch on the stage's chain, serialised over the distinct micro-ops of a
// round.
__device__ __forceinline__ uint32_t alu16(uint32_t u, uint32_t x, uint32_t y,
                                          uint32_t z) {
  const uint32_t s = y & 0xFu;
  const uint32_t zm = 0u - (z & 1u);
  const uint32_t c0 = x + y;                           // add
  const uint32_t c1 = x - y;                           // sub
  const uint32_t c2 = x * y;                           // mul
  const uint32_t c3 = x & y;                           // and
  const uint32_t c4 = x | y;                           // or
  const uint32_t c5 = x ^ y;                           // xor
  const uint32_t c6 = x >> s;                          // shr
  const uint32_t c7 = x << s;                          // shl
  const uint32_t c8 = (z & 1u) ? max(x, y) : min(x, y);  // max; min z = 0
  const uint32_t c9 = x < 0x8000u ? x : 0u - x;       // abs
  const uint32_t c10 = x + (z & 1u) > y;              // ge; gt with z = 0
  const uint32_t c11 = (x != y) ^ (z & 1u);           // eq; ne with z = 0
  const uint32_t c12 = (x & zm) | (y & ~zm);          // z & 1 ? x : y
  const uint32_t c13 = x + (y & zm);                  // predicated acc
  const bool b0 = u & 1u, b1 = u & 2u, b2 = u & 4u, b3 = u & 8u;
  const uint32_t p0 = b0 ? c1 : c0, p1 = b0 ? c3 : c2;
  const uint32_t p2 = b0 ? c5 : c4, p3 = b0 ? c7 : c6;
  const uint32_t p4 = b0 ? c9 : c8, p5 = b0 ? c11 : c10;
  const uint32_t p6 = b0 ? c13 : c12;
  const uint32_t q0 = b1 ? p1 : p0, q1 = b1 ? p3 : p2;
  const uint32_t q2 = b1 ? p5 : p4;
  const uint32_t r0 = b2 ? q1 : q0, r1 = b2 ? p6 : q2;
  return (b3 ? r1 : r0) & kMask;
}

// A ROM entry without a modulo: rom = (first table word, d, m, 0) of the
// row (sim.py rom_magic); the entry of address a is a % tab_len =
// umulhi(m * a, d), exact for 16-bit a.
__device__ __forceinline__ uint32_t rom_lookup(const int4 rom,
                                               const int* table, uint32_t a) {
  const uint32_t idx = __umulhi(static_cast<uint32_t>(rom.z) * a,
                                static_cast<uint32_t>(rom.y));
  return static_cast<uint32_t>(table[rom.x + idx]);
}

// 4-byte asynchronous copy, device memory to shared memory: the low word of
// an int64 value in [0, 0xFFFF].
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem));
}

// The program blob (a multiple of 16 bytes) to shared memory, 16 bytes a
// copy, all in flight at once; the caller waits with cp_async_wait_all().
__device__ __forceinline__ void copy_blob(int* sm, const int* blob,
                                          int words, int lane) {
  for (int i = 4 * lane; i < words; i += 4 * 32) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(sm + i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(blob + i));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Where the program and the state live (sim.py LAYOUTS): both in shared
// memory; the state (and the program's tables) in shared memory with the
// descriptors streamed from device memory; both in device memory.
enum Layout { kSharedLayout = 0, kStreamLayout = 1, kGlobalLayout = 2 };

// One lane's descriptors streamed from device memory on the stream layout:
// W uint4 a round, the rounds of a list of n taken in a cycle (round r at
// src[(r' * 32 + lane) * W], r' = r + 1 from round `skip` on: a list may
// hold a round that is not streamed). The stream's positions (position q
// is round q % n) go in chunks of C, double-buffered in shared memory:
// chunk j + 1 is cp.async'ed, as one copy group, while chunk j runs, and
// the lane waits once a chunk, at its first position, for a copy issued a
// whole chunk earlier. Within a chunk a round's descriptor is one
// shared-memory load, made a round ahead into registers, as on the shared
// route. A chunk's buffer is refilled only after its last position was
// loaded. The ring's words are the lane's own, so no other lane needs to see
// them. Tested lane by lane in tests/test_torch_sim_vec.py (_Stream).
template <int W, int C>
struct DescStream {
  const uint4* src;
  uint4* ring;                            // [2][C][32][W], shared memory
  int n, skip, lane, next_r;
  int q;                                  // the held position mod 2C
  uint4 held[W];

  // The next C positions into buffer `buf`, one copy group.
  __device__ __forceinline__ void fetch(int buf) {
    for (int i = 0; i < C; ++i) {
      const int r = next_r + (next_r >= skip);
      const uint4* s = src + static_cast<size_t>(r * 32 + lane) * W;
      uint4* d = ring + ((buf * C + i) * 32 + lane) * W;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const unsigned dst = static_cast<unsigned>(
            __cvta_generic_to_shared(d + w));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     ::"r"(dst), "l"(s + w));
      }
      next_r = next_r + 1 == n ? 0 : next_r + 1;
    }
    cp_async_commit();
  }

  __device__ __forceinline__ void load() {
    const uint4* d = ring + (q * 32 + lane) * W;
#pragma unroll
    for (int w = 0; w < W; ++w) held[w] = d[w];
  }

  // Chunks 0 and 1 in flight, position 0 held. n > 0.
  __device__ __forceinline__ void start(const uint4* src_, uint4* ring_,
                                        int n_, int skip_, int lane_) {
    src = src_;
    ring = ring_;
    n = n_;
    skip = skip_;
    lane = lane_;
    next_r = 0;
    q = 0;
    fetch(0);
    fetch(1);
    cp_async_wait_group<1>();
    load();
  }

  // The held position's descriptor into `out`, and the next one held; at a
  // chunk's first position, wait for it and send for the chunk after it
  // into the buffer just used up.
  __device__ __forceinline__ void advance(uint4 (&out)[W]) {
#pragma unroll
    for (int w = 0; w < W; ++w) out[w] = held[w];
    q = q + 1 == 2 * C ? 0 : q + 1;
    if (q % C == 0) {
      cp_async_wait_group<0>();   // wait_all would commit an empty group
      fetch(q == 0);
    }
    load();
  }
};

}  // namespace
