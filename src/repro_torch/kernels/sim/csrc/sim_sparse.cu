// The ready-valid (sparse) simulator of a lowered Cascade DFG, for Hopper
// (sm_90a).
//
// Replaces the jitted lax.while_loop of the JAX package's vectorized
// simulator, src/repro/core/sim_vec.py::_jitted_sparse (line 877). Same
// function: the masked fire-vector fixpoint of a SparseProgram
// (repro_torch/core/sim_vec.py::lower_sparse), one circular buffer a
// (dst, port) input. Each round, against the state frozen at its start:
//   * every evaluable node with all inputs non-empty and all output buffers
//     with space fires, every OUTPUT with a token fires, every INPUT with
//     feed left and space downstream fires, every CONST buffer that is empty
//     is refilled; if nothing fires the loop stops;
//   * fired nodes evaluate on their buffers' heads (accumulators, predicated
//     accumulators and ROMs included), fired outputs append their head to
//     outm[o, ocnt[o]];
//   * consumed buffers pop, then produced buffers push against the occupancy
//     after the pops, and fired inputs advance their feed pointer.
// It stops at quiescence or after max_cycles rounds, the last non-firing
// round counted, as the reference's while_loop counts it.
//
// Bound on an H100: latency. Each round depends on the one before; the
// bytes (feed read once, outputs written once) and the ops of a run take
// microseconds at the card's rates; the run takes a round's chain of
// dependent shared-memory steps, times the rounds.
//
// What the design does about that bound: it shortens the round.
//   * One launch runs every round on one warp, with no host round trip.
//     Every node, OUTPUT, INPUT and CONST refill is an item, packed on the
//     host 32 to a round of items, one a lane (sim.py pack_sparse); with at
//     most 32 items (every sparse app) a lane's descriptor stays in its
//     registers for the whole run.
//   * One phase a round. A buffer's occupancy is split into a push count
//     (written only by its producer) and a pop count (only by its consumer),
//     each kept in two banks: round r reads bank r % 2 and writes the other,
//     so every item decides, evaluates, pops and pushes at once, with one
//     __syncwarp() and one __any_sync() (the stop test) a round. A pop and a
//     push never touch the same data word in a round (a firing producer
//     writes a free slot), and every other word has one owner, so a round
//     needs no atomics. The push index advances by one compare and select.
//   * The feed is staged in shared memory: whole where it fits, else a ring
//     of 2R tokens a row refilled by cp.async R rounds ahead of the feed
//     pointer (an input takes at most one token a round), so no round waits
//     on device memory.
//   * Operands come from the heads by one byte permute each (selectors set
//     on the host), and the micro-op is sim_ops.cuh's branch-free alu16.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

#include "sim_ops.cuh"

namespace {

// All sizes and offsets, in 32-bit words. The field order is the Python
// wrapper's SPARSE_FIELDS (repro_torch/kernels/sim/sim.py). Buffers
// [0, n_buf) are the lowering's, n_buf + j is feed row j, n_tot = n_buf +
// n_in is the dummy an absent input reads (never empty, head 0) and n_tot +
// 1 the one an absent output checks (never full); nothing writes either.
struct SparseHeader {
  int n_buf, n_in, n_out, n_rows, n_rounds, desc_words, fan, max_feed;
  int window, refill, max_cycles, blob_words;
  // sections of the program blob (copied to shared memory as it is)
  int o_desc, o_binfo, o_rom, o_table;
  // state sections in shared memory, after the blob
  int s_p, s_q, s_rpa, s_wpa, s_data, s_accv, s_ocnt, s_trash, s_words;
};

constexpr int kLanes = 32;
constexpr int kFan = 4;                   // output words kept in registers

// Descriptor flags, bits 4-11 of word 0 (sim.py SPARSE_FLAGS); the ROM row
// sits in bits 12-31, the micro-op in bits 0-3.
constexpr uint32_t kRom = 1u << 4;        // a ROM
constexpr uint32_t kAcc = 2u << 4;        // an accumulator
constexpr uint32_t kValid = 4u << 4;      // an item, not an idle lane
constexpr int kRomShift = 12;

struct State {
  int* P;           // [2][n_tot + 2] push counts
  int* Q;           // [2][n_tot + 2] pop counts
  int* rpa;         // [n_tot + 2] word of each buffer's head (consumer's)
  int* wpa;         // [n_tot + 2] word of each buffer's next push (producer's)
  uint32_t* data;   // buffer slots, the feed rows, the dummies' zero word
  uint32_t* accv;   // [rounds x 32] accumulator of each item
  int* ocnt;        // [n_out + 1] output counts (the last for no output)
  int* trash;       // [32] a word a lane for the stores an item must not make
  const int2* binfo;  // (first word, capacity) of each buffer
};

// Copies of feed tokens [lo_j, lo_j + span) of every row j into its ring
// (token k at ring slot k % window), clipped to the row's tokens: lo_j =
// fptr[j] + skip, or skip where fptr is null.
__device__ __forceinline__ void stage_feed(const SparseHeader& h,
                                           const State& s, const int* fptr,
                                           int skip, int span,
                                           const long long* feed,
                                           const long long* frem0, int lane) {
  for (int i = lane; i < h.n_in * span; i += kLanes) {
    const int j = i / span;
    const int k = (fptr ? fptr[j] : 0) + skip + i % span;
    if (k < static_cast<int>(frem0[j]) && k < h.max_feed)
      cp_async4(s.data + s.binfo[h.n_buf + j].x + k % h.window,
                feed + static_cast<size_t>(j) * h.max_feed + k);
  }
  cp_async_commit();
}

__device__ __forceinline__ int wrap(int a, int2 bi) {
  return a == bi.x + bi.y ? bi.x : a;
}

// One item's round: decide against bank cur, evaluate, pop and push into
// bank cur ^ 1. d0, d1: the descriptor's first 8 words, out3 its ninth (the
// fourth output word); more: the output words past kFan. Every load comes
// first and is unconditional (absent entries read the dummies), every test
// is a bitwise and, and every store is unconditional too, into its word or,
// where the item must not write, into the lane's trash word: a round is one
// basic block. Returns whether it fired.
__device__ __forceinline__ bool step(const SparseHeader& h, const State& s,
                                     const int* table, const int4* roms,
                                     const uint4 d0, const uint4 d1,
                                     uint32_t out3, const int* more,
                                     int item, int cur, long long* outm,
                                     int* trash) {
  const int nt = h.n_buf + h.n_in, nb = nt + 2;
  const int* Pc = s.P + cur * nb;
  const int* Qc = s.Q + cur * nb;
  int* Pn = s.P + (cur ^ 1) * nb;
  int* Qn = s.Q + (cur ^ 1) * nb;
  const uint32_t w = d0.x;
  const int in[3] = {static_cast<int>(d0.y & 0xFFFFu),
                     static_cast<int>(d0.y >> 16),
                     static_cast<int>(d0.z & 0xFFFFu)};
  const uint32_t outw[kFan] = {d1.y, d1.z, d1.w, out3};
  bool ok = w & kValid;
  uint32_t head[3];
  int q[3], ra[3];
  int2 bi[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    q[k] = Qc[in[k]];
    ra[k] = s.rpa[in[k]];
    bi[k] = s.binfo[in[k]];
    ok &= Pc[in[k]] != q[k];
    head[k] = s.data[ra[k]];
  }
  int ob[kFan], po[kFan], wa[kFan];
  int2 bo[kFan];
#pragma unroll
  for (int f = 0; f < kFan; ++f) {
    ob[f] = outw[f] & 0xFFFFu;
    po[f] = Pc[ob[f]];
    wa[f] = s.wpa[ob[f]];
    bo[f] = s.binfo[ob[f]];
    ok &= po[f] - Qc[ob[f]] < static_cast<int>(outw[f] >> 16);
  }
  for (int f = kFan; f < h.fan; ++f) {    // wide fan-outs only
    const uint32_t o = static_cast<uint32_t>(more[f - kFan]);
    const int b = o & 0xFFFFu;
    ok &= Pc[b] - Qc[b] < static_cast<int>(o >> 16);
  }
  const int sink = d0.z >> 16;
  const int oc = s.ocnt[sink];
  const uint32_t acc = s.accv[item];
  const int4 rom = roms[w >> kRomShift];
  // operands: one byte permute each from the three heads and the constant
  // (an accumulator's state, a CONST's value, 1 or 0)
  const uint32_t kval = (w & kAcc) ? acc : d1.x >> 16;
  const uint32_t h01 = head[0] | head[1] << 16, h2k = head[2] | kval << 16;
  const uint32_t x = __byte_perm(h01, h2k, d0.w & 0xFFFFu) & kMask;
  const uint32_t y = __byte_perm(h01, h2k, d0.w >> 16) & kMask;
  const uint32_t z = __byte_perm(h01, h2k, d1.x & 0xFFFFu) & kMask;
  const uint32_t a = alu16(w & 0xFu, x, y, z);
  const uint32_t r = rom_lookup(rom, table, x);
  const uint32_t v = (w & kRom) ? r : a;
  const int fire = ok;
  uint32_t* utrash = reinterpret_cast<uint32_t*>(trash);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const bool real = in[k] < nt;
    *(real ? &Qn[in[k]] : trash) = q[k] + fire;
    *(real ? &s.rpa[in[k]] : trash) = fire ? wrap(ra[k] + 1, bi[k]) : ra[k];
  }
#pragma unroll
  for (int f = 0; f < kFan; ++f) {
    const bool real = ob[f] < nt;
    *(real ? &Pn[ob[f]] : trash) = po[f] + fire;
    *(real && fire ? &s.data[wa[f]] : utrash) = v;
    *(real ? &s.wpa[ob[f]] : trash) = fire ? wrap(wa[f] + 1, bo[f]) : wa[f];
  }
  for (int f = kFan; f < h.fan; ++f) {
    const int b = static_cast<uint32_t>(more[f - kFan]) & 0xFFFFu;
    if (b < nt) {
      Pn[b] = Pc[b] + fire;
      if (fire) {
        const int wb = s.wpa[b];
        s.data[wb] = v;
        s.wpa[b] = wrap(wb + 1, s.binfo[b]);
      }
    }
  }
  const bool out = fire && sink < h.n_out;
  if (out) outm[static_cast<size_t>(sink) * h.max_cycles + oc] = v;
  *(out ? &s.ocnt[sink] : trash) = oc + 1;
  *(fire && (w & kAcc) ? &s.accv[item] : utrash) = v;
  return fire;
}

__global__ void __launch_bounds__(kLanes, 1)
sim_sparse_kernel(SparseHeader h, const int* __restrict__ blob,
                  const long long* __restrict__ feed,
                  const long long* __restrict__ frem0,
                  long long* __restrict__ outm,
                  long long* __restrict__ state) {
  extern __shared__ __align__(16) int sm[];
  const int lane = threadIdx.x;
  const int nt = h.n_buf + h.n_in, nb = nt + 2;
  copy_blob(sm, blob, h.blob_words, lane);
  for (int i = h.s_p + lane; i < h.s_words; i += kLanes) sm[i] = 0;
  cp_async_wait_all();
  __syncwarp();
  State s;
  s.P = sm + h.s_p;
  s.Q = sm + h.s_q;
  s.rpa = sm + h.s_rpa;
  s.wpa = sm + h.s_wpa;
  s.data = reinterpret_cast<uint32_t*>(sm + h.s_data);
  s.accv = reinterpret_cast<uint32_t*>(sm + h.s_accv);
  s.ocnt = sm + h.s_ocnt;
  s.trash = sm + h.s_trash;
  s.binfo = reinterpret_cast<const int2*>(sm + h.o_binfo);
  const int* table = sm + h.o_table;
  const int4* roms = reinterpret_cast<const int4*>(sm + h.o_rom);
  const int* dsc = sm + h.o_desc;
  for (int b = lane; b < nb; b += kLanes) {
    s.rpa[b] = s.wpa[b] = s.binfo[b].x;
    // a feed row's pushes are its tokens; the input dummy holds one token
    const int n = b < h.n_buf ? 0
                  : b < nt ? static_cast<int>(frem0[b - h.n_buf])
                           : b == nt;
    s.P[b] = s.P[nb + b] = n;
  }
  // the feed: whole, or its first 2R tokens a row
  stage_feed(h, s, nullptr, 0, h.refill ? 2 * h.refill : h.max_feed, feed,
             frem0, lane);
  cp_async_wait_all();
  __syncwarp();

  // with one round of items (up to 32), a lane's descriptor is loop-invariant
  const int* mine = dsc + lane * h.desc_words;
  const uint4 zero4 = make_uint4(0, 0, 0, 0);
  const uint4 a0 = h.n_rounds ? reinterpret_cast<const uint4*>(mine)[0]
                              : zero4;
  const uint4 a1 = h.n_rounds ? reinterpret_cast<const uint4*>(mine)[1]
                              : zero4;
  const uint32_t a8 = h.n_rounds ? mine[8] : 0u;
  int fired = 1, rounds = 0, cur = 0;
  while (rounds < h.max_cycles) {
    if (h.refill && rounds > 0 && rounds % h.refill == 0) {
      // tokens [f, f + R) of each row are resident; fetch [f + R, f + 2R)
      cp_async_wait_all();
      __syncwarp();
      stage_feed(h, s, s.Q + cur * nb + h.n_buf, h.refill, h.refill, feed,
                 frem0, lane);
    }
    ++rounds;
    bool any = h.n_rounds > 0 &&
               step(h, s, table, roms, a0, a1, a8, mine + 9, lane, cur, outm,
                    s.trash + lane);
    for (int k = 1; k < h.n_rounds; ++k) {
      const int* dk = dsc + (k * kLanes + lane) * h.desc_words;
      any |= step(h, s, table, roms, reinterpret_cast<const uint4*>(dk)[0],
                  reinterpret_cast<const uint4*>(dk)[1], dk[8], dk + 9,
                  k * kLanes + lane, cur, outm, s.trash + lane);
    }
    fired = __any_sync(0xFFFFFFFFu, any);
    __syncwarp();
    cur ^= 1;
    if (!fired) break;
  }
  cp_async_wait_all();

  // state: blen [n_buf], frem [n_rows], ocnt [max(1, n_out)], fired,
  // rounds; feed rows past n_in and the output count past n_out are the
  // lowering's padding
  const int* P = s.P + cur * nb;
  const int* Q = s.Q + cur * nb;
  const int n_ocnt = max(1, h.n_out);
  long long* st_frem = state + h.n_buf;
  long long* st_ocnt = st_frem + h.n_rows;
  for (int b = lane; b < h.n_buf; b += kLanes) state[b] = P[b] - Q[b];
  for (int j = lane; j < h.n_rows; j += kLanes)
    st_frem[j] = j < h.n_in ? P[h.n_buf + j] - Q[h.n_buf + j] : frem0[j];
  for (int o = lane; o < n_ocnt; o += kLanes)
    st_ocnt[o] = o < h.n_out ? s.ocnt[o] : 0;
  if (lane == 0) {
    st_ocnt[n_ocnt] = fired;
    st_ocnt[n_ocnt + 1] = rounds;
  }
}

}  // namespace

extern "C" {

int sim_sparse_header_ints() { return sizeof(SparseHeader) / sizeof(int); }

// hdr: SparseHeader's fields, host memory. blob: the program; feed: int64
// [n_rows, max_feed]; frem0: int64 [n_rows]; outm: int64
// [max(1, n_out), max_cycles]; state: int64 [n_buf + n_rows + max(1, n_out)
// + 2]; all device memory.
// Returns the launch's cudaError_t.
int sim_sparse_launch(const int* hdr, const int* blob, const long long* feed,
                      const long long* frem0, long long* outm,
                      long long* state, cudaStream_t stream) {
  SparseHeader h;
  memcpy(&h, hdr, sizeof(h));
  const size_t smem = static_cast<size_t>(h.s_words) * sizeof(int);
  if (smem > 48 * 1024) {                 // past the default, opt in
    const cudaError_t err = cudaFuncSetAttribute(
        sim_sparse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  sim_sparse_kernel<<<1, kLanes, smem, stream>>>(h, blob, feed, frem0, outm,
                                                 state);
  return cudaGetLastError();
}

}  // extern "C"
