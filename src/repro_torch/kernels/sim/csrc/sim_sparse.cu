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
//   * An item's descriptor holds its first four outputs (in registers);
//     the rest sit in one packed out-list, the descriptor giving their
//     count and first entry. Those of the round's wide items are the
//     warp's: every lane tests a stride of an item's entries (__all_sync of
//     the parts) before the items fire, and pushes the same stride after,
//     item after item, so a round of narrow items runs no loop at all.
//
// A program whose blob and state pass a block's shared memory takes the
// global route, in one of two layouts (the kernel's kLayout):
//   * kStreamLayout, where the state fits: the state, binfo, the out-list,
//     ROM rows and tables stay in shared memory, and only the descriptors
//     stay in device memory; each lane streams its own (DescStream,
//     sim_ops.cuh: chunks of 4 item rounds double-buffered by cp.async).
//   * kGlobalLayout, where the state passes shared memory too or the buffers
//     pass the descriptor's 16-bit fields: blob and state live in a
//     workspace in device memory that the wrapper allocates (blob first,
//     the state after it, the same word offsets), the feed is staged by
//     plain loads and stores, and the descriptor is wide: every buffer
//     index, the sink and each output limit a 32-bit word of its own
//     (sim.py pack_sparse).
// The rounds, the phase and the micro-ops are the shared route's;
// __syncwarp() orders the warp's device-memory accesses as it orders its
// shared-memory ones.
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
  int n_buf, n_in, n_out, n_rows, n_rounds, desc_words, max_feed;
  int window, refill, max_cycles, layout;
  // sections of the program blob: o_desc in the blob, the others where
  // shared memory holds them (blob words [o_copy, o_copy + copy_words)
  // copied to word 0; the whole blob but on the stream layout)
  int o_desc, o_binfo, o_outs, o_rom, o_table, o_copy, copy_words;
  // state sections in shared memory, after the copy (s_pre: the streamed
  // descriptors' ring, stream layout only)
  int s_p, s_q, s_rpa, s_wpa, s_data, s_accv, s_ocnt, s_trash, s_pre;
  int s_words;
};

constexpr int kLanes = 32;
constexpr int kFan = 4;                   // outputs a descriptor holds
constexpr int kMoreShift = 12;            // sim.py MORE_SHIFT
constexpr int kStreamChunk = 4;           // sim.py STREAM_CHUNKS["sparse"]
constexpr uint32_t kFull = 0xFFFFFFFFu;

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
// fptr[j] + skip, or skip where fptr is null. By cp.async into shared
// memory, or by plain loads and stores on the global route.
template <bool kGlobal>
__device__ __forceinline__ void stage_feed(const SparseHeader& h,
                                           const State& s, const int* fptr,
                                           int skip, int span,
                                           const long long* feed,
                                           const long long* frem0, int lane) {
  for (int i = lane; i < h.n_in * span; i += kLanes) {
    const int j = i / span;
    const int k = (fptr ? fptr[j] : 0) + skip + i % span;
    if (k < static_cast<int>(frem0[j]) && k < h.max_feed) {
      uint32_t* dst = s.data + s.binfo[h.n_buf + j].x + k % h.window;
      const long long* src = feed + static_cast<size_t>(j) * h.max_feed + k;
      if (kGlobal)
        *dst = static_cast<uint32_t>(*src);
      else
        cp_async4(dst, src);
    }
  }
  if (!kGlobal) cp_async_commit();
}

// An item's descriptor, decoded: its first kFan outputs' buffers and
// limits, and the count and first out-list entry of the rest.
struct Item {
  uint32_t w;        // uop | flags << 4 | rom << 12
  int in[3];
  int sink;          // the OUTPUT's index, n_out for none
  uint32_t selxy;    // x's selector | y's << 16
  uint32_t selzk;    // z's selector | the constant << 16
  int ob[kFan];
  int lim[kFan];
  int n_more, more_at;
};

// Out-list entry e: a word (buffer | limit << 16), or on the global layout
// a pair of words.
template <bool kGlobal>
__device__ __forceinline__ void out_entry(const int* outs, int e, int& b,
                                          int& lim) {
  if (kGlobal) {
    b = outs[2 * e];
    lim = outs[2 * e + 1];
  } else {
    const uint32_t o = static_cast<uint32_t>(outs[e]);
    b = o & 0xFFFFu;
    lim = o >> 16;
  }
}

__device__ __forceinline__ void set_more(Item& it, uint32_t more) {
  it.n_more = more & ((1u << kMoreShift) - 1);
  it.more_at = more >> kMoreShift;
}

// The shared and stream layouts' descriptor: words 0-11 in three uint4.
__device__ __forceinline__ Item item16(const uint4 d0, const uint4 d1,
                                       const uint4 d2) {
  Item it;
  it.w = d0.x;
  it.in[0] = d0.y & 0xFFFFu;
  it.in[1] = d0.y >> 16;
  it.in[2] = d0.z & 0xFFFFu;
  it.sink = d0.z >> 16;
  it.selxy = d0.w;
  it.selzk = d1.x;
  const uint32_t o[kFan] = {d1.y, d1.z, d1.w, d2.x};
#pragma unroll
  for (int f = 0; f < kFan; ++f) {
    it.ob[f] = o[f] & 0xFFFFu;
    it.lim[f] = o[f] >> 16;
  }
  set_more(it, d2.y);
  return it;
}

// The global layout's wide descriptor: uop | flags << 4 | rom << 12, in0,
// in1, in2, sink, selectors of x and y, z's selector | the constant << 16,
// more, then kFan buffers and kFan limits.
__device__ __forceinline__ Item item32(const int* d) {
  const uint4 d0 = reinterpret_cast<const uint4*>(d)[0];
  const uint4 d1 = reinterpret_cast<const uint4*>(d)[1];
  const int4 ob = reinterpret_cast<const int4*>(d)[2];
  const int4 lim = reinterpret_cast<const int4*>(d)[3];
  Item it;
  it.w = d0.x;
  it.in[0] = d0.y;
  it.in[1] = d0.z;
  it.in[2] = d0.w;
  it.sink = d1.x;
  it.selxy = d1.y;
  it.selzk = d1.z;
  it.ob[0] = ob.x, it.ob[1] = ob.y, it.ob[2] = ob.z, it.ob[3] = ob.w;
  it.lim[0] = lim.x, it.lim[1] = lim.y, it.lim[2] = lim.z, it.lim[3] = lim.w;
  set_more(it, d1.w);
  return it;
}

__device__ __forceinline__ int wrap(int a, int2 bi) {
  return a == bi.x + bi.y ? bi.x : a;
}

// One item round: every lane's item decides against bank cur, evaluates,
// pops and pushes into bank cur ^ 1. Every load comes first and is
// unconditional (absent entries read the dummies), every test is a
// bitwise and, and every store is unconditional too, into its word or,
// where the item must not write, into the lane's trash word: for narrow
// items the round is one basic block. The outputs past kFan of the round's
// wide items are tested, then pushed, by the whole warp, a stride of an
// item's entries a lane (an item's output buffers are distinct, and each
// has one producer). Returns whether the lane's item fired.
template <bool kGlobal>
__device__ __forceinline__ bool step(const SparseHeader& h, const State& s,
                                     const int* table, const int4* roms,
                                     const int* outs, const Item& it,
                                     int item, int cur, long long* outm,
                                     int* trash, int lane) {
  const int nt = h.n_buf + h.n_in, nb = nt + 2;
  const int* Pc = s.P + cur * nb;
  const int* Qc = s.Q + cur * nb;
  int* Pn = s.P + (cur ^ 1) * nb;
  int* Qn = s.Q + (cur ^ 1) * nb;
  const uint32_t w = it.w;
  const int* in = it.in;
  bool ok = w & kValid;
  // the wide items' further outputs, each tested by the warp
  const uint32_t wide = __ballot_sync(kFull, it.n_more > 0);
  for (uint32_t m = wide; m; m &= m - 1) {
    const int src = __ffs(m) - 1;
    const int n = __shfl_sync(kFull, it.n_more, src);
    const int at = __shfl_sync(kFull, it.more_at, src);
    bool part = true;
    for (int f = lane; f < n; f += kLanes) {
      int b, lim;
      out_entry<kGlobal>(outs, at + f, b, lim);
      part &= Pc[b] - Qc[b] < lim;
    }
    const bool all = __all_sync(kFull, part);
    if (lane == src) ok &= all;
  }
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
    ob[f] = it.ob[f];
    po[f] = Pc[ob[f]];
    wa[f] = s.wpa[ob[f]];
    bo[f] = s.binfo[ob[f]];
    ok &= po[f] - Qc[ob[f]] < it.lim[f];
  }
  const int sink = it.sink;
  const int oc = s.ocnt[sink];
  const uint32_t acc = s.accv[item];
  const int4 rom = roms[w >> kRomShift];
  // operands: one byte permute each from the three heads and the constant
  // (an accumulator's state, a CONST's value, 1 or 0)
  const uint32_t kval = (w & kAcc) ? acc : it.selzk >> 16;
  const uint32_t h01 = head[0] | head[1] << 16, h2k = head[2] | kval << 16;
  const uint32_t x = __byte_perm(h01, h2k, it.selxy & 0xFFFFu) & kMask;
  const uint32_t y = __byte_perm(h01, h2k, it.selxy >> 16) & kMask;
  const uint32_t z = __byte_perm(h01, h2k, it.selzk & 0xFFFFu) & kMask;
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
  const bool out = fire && sink < h.n_out;
  if (out) outm[static_cast<size_t>(sink) * h.max_cycles + oc] = v;
  *(out ? &s.ocnt[sink] : trash) = oc + 1;
  *(fire && (w & kAcc) ? &s.accv[item] : utrash) = v;
  // the wide items' further outputs, each pushed by the warp
  for (uint32_t m = wide; m; m &= m - 1) {
    const int src = __ffs(m) - 1;
    const int n = __shfl_sync(kFull, it.n_more, src);
    const int at = __shfl_sync(kFull, it.more_at, src);
    const int fs = __shfl_sync(kFull, fire, src);
    const uint32_t vs = __shfl_sync(kFull, v, src);
    for (int f = lane; f < n; f += kLanes) {
      int b, lim;
      out_entry<kGlobal>(outs, at + f, b, lim);
      Pn[b] = Pc[b] + fs;
      if (fs) {
        const int wb = s.wpa[b];
        s.data[wb] = vs;
        s.wpa[b] = wrap(wb + 1, s.binfo[b]);
      }
    }
  }
  return fire;
}

// blob: the program (shared and stream layouts), or the workspace that
// holds the program and the state (global layout).
template <int kLayout>
__global__ void __launch_bounds__(kLanes, 1)
sim_sparse_kernel(SparseHeader h, int* blob,
                  const long long* __restrict__ feed,
                  const long long* __restrict__ frem0,
                  long long* __restrict__ outm,
                  long long* __restrict__ state) {
  constexpr bool kGlobal = kLayout == kGlobalLayout;
  constexpr bool kStreamed = kLayout == kStreamLayout;
  extern __shared__ __align__(16) int smem[];
  int* sm = kGlobal ? blob : smem;
  const int lane = threadIdx.x;
  const int nt = h.n_buf + h.n_in, nb = nt + 2;
  if (!kGlobal) copy_blob(sm, blob + h.o_copy, h.copy_words, lane);
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
  const int* outs = sm + h.o_outs;
  const int* dsc = (kStreamed ? blob : sm) + h.o_desc;
  for (int b = lane; b < nb; b += kLanes) {
    s.rpa[b] = s.wpa[b] = s.binfo[b].x;
    // a feed row's pushes are its tokens; the input dummy holds one token
    const int n = b < h.n_buf ? 0
                  : b < nt ? static_cast<int>(frem0[b - h.n_buf])
                           : b == nt;
    s.P[b] = s.P[nb + b] = n;
  }
  // the feed: whole, or its first 2R tokens a row
  stage_feed<kGlobal>(h, s, nullptr, 0,
                      h.refill ? 2 * h.refill : h.max_feed, feed, frem0,
                      lane);
  cp_async_wait_all();
  __syncwarp();

  // on the shared layout with one round of items (up to 32), a lane's
  // descriptor is loop-invariant and stays in registers
  const uint4* mine = reinterpret_cast<const uint4*>(dsc + lane * 12);
  const uint4 zero4 = make_uint4(0, 0, 0, 0);
  const bool held = kLayout == kSharedLayout && h.n_rounds > 0;
  const uint4 a0 = held ? mine[0] : zero4;
  const uint4 a1 = held ? mine[1] : zero4;
  const uint4 a2 = held ? mine[2] : zero4;
  DescStream<3, kStreamChunk> stream;
  if (kStreamed && h.n_rounds > 0)
    stream.start(reinterpret_cast<const uint4*>(dsc),
                 reinterpret_cast<uint4*>(sm + h.s_pre), h.n_rounds,
                 h.n_rounds, lane);
  int fired = 1, rounds = 0, cur = 0;
  while (rounds < h.max_cycles) {
    if (h.refill && rounds > 0 && rounds % h.refill == 0) {
      // tokens [f, f + R) of each row are resident; fetch [f + R, f + 2R)
      cp_async_wait_all();
      __syncwarp();
      stage_feed<kGlobal>(h, s, s.Q + cur * nb + h.n_buf, h.refill,
                          h.refill, feed, frem0, lane);
    }
    ++rounds;
    bool any = false;
    for (int k = 0; k < h.n_rounds; ++k) {
      const int item = k * kLanes + lane;
      Item it;
      if (kGlobal) {
        it = item32(dsc + item * h.desc_words);
      } else if (kStreamed) {
        uint4 d[3];
        stream.advance(d);
        it = item16(d[0], d[1], d[2]);
      } else if (k == 0) {
        it = item16(a0, a1, a2);
      } else {
        const uint4* dk = reinterpret_cast<const uint4*>(dsc + item * 12);
        it = item16(dk[0], dk[1], dk[2]);
      }
      any |= step<kGlobal>(h, s, table, roms, outs, it, item, cur, outm,
                           s.trash + lane, lane);
    }
    fired = __any_sync(kFull, any);
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

template <int kLayout>
cudaError_t launch_sparse(const SparseHeader& h, int* blob,
                          const long long* feed, const long long* frem0,
                          long long* outm, long long* state,
                          cudaStream_t stream) {
  const size_t smem = kLayout == kGlobalLayout
                          ? 0 : static_cast<size_t>(h.s_words) * sizeof(int);
  if (smem > 48 * 1024) {                 // past the default, opt in
    const cudaError_t err = cudaFuncSetAttribute(
        sim_sparse_kernel<kLayout>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  sim_sparse_kernel<kLayout><<<1, kLanes, smem, stream>>>(h, blob, feed,
                                                          frem0, outm, state);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int sim_sparse_header_ints() { return sizeof(SparseHeader) / sizeof(int); }

// hdr: SparseHeader's fields, host memory. blob: the program (shared and
// stream layouts) or the workspace of s_words words that starts with it
// (global layout); feed: int64 [n_rows, max_feed]; frem0: int64 [n_rows]; outm:
// int64 [max(1, n_out), max_cycles]; state: int64 [n_buf + n_rows +
// max(1, n_out) + 2]; all device memory.
// Returns the launch's cudaError_t.
int sim_sparse_launch(const int* hdr, int* blob, const long long* feed,
                      const long long* frem0, long long* outm,
                      long long* state, cudaStream_t stream) {
  SparseHeader h;
  memcpy(&h, hdr, sizeof(h));
  switch (h.layout) {
    case kSharedLayout:
      return launch_sparse<kSharedLayout>(h, blob, feed, frem0, outm, state,
                                          stream);
    case kStreamLayout:
      return launch_sparse<kStreamLayout>(h, blob, feed, frem0, outm, state,
                                          stream);
    case kGlobalLayout:
      return launch_sparse<kGlobalLayout>(h, blob, feed, frem0, outm, state,
                                          stream);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
