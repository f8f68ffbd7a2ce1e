// The dense cycle simulator of a lowered Cascade DFG, for Hopper (sm_90a).
//
// Replaces the jitted lax.scan of the JAX package's vectorized simulator,
// src/repro/core/sim_vec.py::_jitted_dense (line 440). Same function: every
// cycle of a DenseProgram (repro_torch/core/sim_vec.py::lower_dense) —
//   present:       inputs, the heads of the latency rings, the accumulators;
//   combinational: the (level, opcode) groups in level order;
//   outputs:       the OUTPUT slots, written to out[n_out, cycles];
//   sample:        the accumulators (a false predicate holds them), then the
//                  latency rings, whose pointers advance modulo their latency.
// Every op is the interpreter's PE_OPS formula over values in [0, 0xFFFF]
// with the reference's masks, so uint32 is exact (a 16-bit product fits).
//
// Bound on an H100: latency. The work is a chain: a cycle's combinational
// stages depend on each other and a cycle on the one before, so at most one
// stage of a few tens of nodes is ever in flight. The bytes (inputs read
// once, outputs written once) and the 16-bit ops of a run take microseconds
// at the card's rates; the run takes (stages + heavy rounds) dependent
// steps a cycle, each a shared-memory load, an evaluation, a store and a
// __syncwarp().
//
// What the design does about that bound: it shortens the step and takes
// everything else off the chain.
//   * One launch runs all cycles on one warp, with no host round trip. A
//     stage's nodes are cut into rounds of 32, one a lane; __syncwarp()
//     replaces the block barrier.
//   * The schedule is packed lane-major on the host (sim.py pack_dense): one
//     descriptor a lane and round, operands and destination as byte offsets
//     into a bank of values. A light round (a combinational stage) is one
//     basic block: the next round's descriptor is loaded first, then three
//     operand loads, the branch-free micro-op (sim_ops.cuh alu16), the store.
//   * Inputs, outputs, accumulators and latency-1 nodes ride in the idle
//     lanes of the light rounds, each after its operands are final, as the
//     same load, micro-op and store with other bases. Latency rings longer
//     than one and ROMs (a modulo-free lookup by a host-computed reciprocal,
//     run only by a program that has a ROM) take heavy rounds after the
//     stages.
//   * The values live in two banks. A cycle reads bank t % 2 and writes the
//     next cycle's present slots (inputs, ring heads, accumulators) into the
//     other, so there is no present phase.
//   * Inputs come to shared memory by cp.async a chunk of 32 cycles ahead,
//     and outputs go to shared memory and out to device memory a chunk at a
//     time, coalesced: no cycle touches device memory.
//
// A program whose blob and state pass a block's shared memory takes the
// global route, in one of two layouts (the kernel's kLayout):
//   * kStreamLayout, where the state fits: the value banks, rings, pointers
//     and input staging stay in shared memory with the constants, ROM rows
//     and tables, and only the descriptors stay in device memory. Each lane
//     streams its own (DescStream, sim_ops.cuh): chunks of 16 rounds
//     double-buffered by cp.async, one wait a chunk, each round's
//     descriptor loaded from shared memory a round ahead. Its output
//     staging holds out_chunk cycles a bank (the host takes the largest of
//     32, 16, ..., 1 that fits: 2 x 32 cycles of a few thousand outputs
//     would pass shared memory), flushed as the shared route flushes.
//   * kGlobalLayout, where the state passes shared memory too or the slots pass
//     the 18-bit destination field: the blob and state live in a workspace
//     in device memory that the wrapper allocates (blob first, state after
//     it, the same word offsets; H100's 50 MB L2 holds it at the sizes that
//     need it), the inputs are staged by plain loads and stores, and the
//     descriptor moves its flags and micro-op to word 7, leaving word 3 a
//     full 32-bit destination offset.
// The rounds, the stage rule, the micro-ops and the __syncwarp()s are the
// shared route's; __syncwarp() orders the warp's device-memory accesses as
// it orders its shared-memory ones.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

#include "sim_ops.cuh"

namespace {

// All sizes and offsets, in 32-bit words. The field order is the Python
// wrapper's DENSE_FIELDS (repro_torch/kernels/sim/sim.py).
struct DenseHeader {
  int n_nodes, n_in, n_out, n_const, n_light, n_heavy, n_rom, cycles;
  int stride, out_chunk, layout;
  // sections of the program blob: o_desc in the blob, the others where
  // shared memory holds them (blob words [o_copy, o_copy + copy_words)
  // copied to word 0; the whole blob but on the stream layout)
  int o_desc, o_const, o_rom, o_table, o_copy, copy_words;
  // state sections in shared memory, after the copy (s_pre: the streamed
  // descriptors' ring, stream layout only; s_out: none there)
  int s_val, s_ring, s_ptr, s_in, s_out, s_pre, s_words;
};

constexpr int kLanes = 32;
constexpr int kChunk = 32;                // sim.py CHUNK
constexpr int kStreamChunk = 16;          // sim.py STREAM_CHUNKS["dense"]

// Descriptor flags, bits 18-23 of word 3 (sim.py DENSE_FLAGS); the
// destination's byte offset sits below them, the micro-op above. On the
// global route the flags and micro-op sit at the same bits of word 7, and
// word 3 is the destination's byte offset alone.
constexpr uint32_t kXIn = 1u << 18;       // x from the input staging
constexpr uint32_t kDNext = 2u << 18;     // into the next cycle's bank
constexpr uint32_t kDOut = 4u << 18;      // into the output staging
constexpr uint32_t kRing = 8u << 18;      // a latency ring longer than one
constexpr uint32_t kRom = 16u << 18;      // a ROM
constexpr uint32_t kDestMask = (1u << 18) - 1;

__device__ __forceinline__ uint32_t lds(const char* base, uint32_t off) {
  return *reinterpret_cast<const uint32_t*>(base + off);
}

// Copies of input chunk c (cycles [32c, 32c + 32)) into staging bank c % 2:
// inbuf[bank][row][cycle % 32]; by cp.async into shared memory, or by plain
// loads and stores on the global layout.
template <bool kGlobal>
__device__ __forceinline__ void stage_inputs(const DenseHeader& h, int c,
                                             uint32_t* inbuf,
                                             const long long* in, int lane) {
  const int t0 = c * kChunk;
  if (t0 >= h.cycles) return;
  const int width = min(kChunk, h.cycles - t0);
  uint32_t* dst = inbuf + (c & 1) * h.n_in * kChunk;
  for (int i = lane; i < h.n_in * width; i += kLanes) {
    const int r = i / width, k = i % width;
    const long long* src = in + static_cast<size_t>(r) * h.cycles + t0 + k;
    if (kGlobal)
      dst[r * kChunk + k] = static_cast<uint32_t>(*src);
    else
      cp_async4(dst + r * kChunk + k, src);
  }
  if (!kGlobal) cp_async_commit();
}

// The outputs of output chunk c (cycles [c oc, c oc + oc), oc =
// h.out_chunk), from staging bank c % 2 to out[n_out, cycles].
__device__ __forceinline__ void flush_outputs(const DenseHeader& h, int c,
                                              const uint32_t* outbuf,
                                              long long* out, int lane) {
  const int oc = h.out_chunk;
  const int t0 = c * oc;
  const int width = min(oc, h.cycles - t0);
  const uint32_t* src = outbuf + (c & 1) * h.n_out * oc;
  for (int i = lane; i < h.n_out * width; i += kLanes) {
    const int o = i / width, k = i % width;
    out[static_cast<size_t>(o) * h.cycles + t0 + k] = src[o * oc + k];
  }
}

// blob: the program (shared and stream layouts), or the workspace that
// holds the program and the state (global layout).
template <int kLayout>
__global__ void __launch_bounds__(kLanes, 1)
sim_dense_kernel(DenseHeader h, int* blob, const long long* __restrict__ in,
                 long long* __restrict__ out) {
  constexpr bool kGlobal = kLayout == kGlobalLayout;
  constexpr bool kStreamed = kLayout == kStreamLayout;
  extern __shared__ __align__(16) int smem[];
  int* sm = kGlobal ? blob : smem;
  const int lane = threadIdx.x;
  if (!kGlobal) copy_blob(sm, blob + h.o_copy, h.copy_words, lane);
  for (int i = h.s_val + lane; i < h.s_words; i += kLanes) sm[i] = 0;
  cp_async_wait_all();
  __syncwarp();
  uint32_t* val = reinterpret_cast<uint32_t*>(sm + h.s_val);
  uint32_t* ring = reinterpret_cast<uint32_t*>(sm + h.s_ring);
  uint32_t* ptr = reinterpret_cast<uint32_t*>(sm + h.s_ptr);
  uint32_t* inbuf = reinterpret_cast<uint32_t*>(sm + h.s_in);
  uint32_t* outbuf = reinterpret_cast<uint32_t*>(sm + h.s_out);
  // descriptors: two uint4 a lane and round, the light rounds' list ending
  // with a copy of its first round, then the heavy rounds
  const uint4* desc = reinterpret_cast<const uint4*>(
      (kStreamed ? blob : sm) + h.o_desc);
  const uint4* heavy = desc + 2 * kLanes * (h.n_light + (h.n_light > 0));
  const int4* roms = reinterpret_cast<const int4*>(sm + h.o_rom);
  const int* table = sm + h.o_table;
  // both banks: constants, and the slot after the pad that reads 1
  for (int i = lane; i < h.n_const; i += kLanes) {
    const int slot = sm[h.o_const + 2 * i];
    const uint32_t v = static_cast<uint32_t>(sm[h.o_const + 2 * i + 1]);
    val[slot] = v;
    val[h.stride + slot] = v;
  }
  if (lane == 0) val[h.n_nodes + 1] = val[h.stride + h.n_nodes + 1] = 1u;
  // chunk 0 now, chunk 1 in flight; cycle 0's inputs into bank 0
  stage_inputs<kGlobal>(h, 0, inbuf, in, lane);
  cp_async_wait_all();
  stage_inputs<kGlobal>(h, 1, inbuf, in, lane);
  __syncwarp();
  for (int i = lane; i < h.n_in; i += kLanes) val[i] = inbuf[i * kChunk];
  __syncwarp();

  const uint4 zero4 = make_uint4(0, 0, 0, 0);
  // the stream layout's descriptors: the light rounds, then the heavy
  // ones (the light list's closing copy is not streamed)
  const int per_cycle = h.n_light + h.n_heavy;
  DescStream<2, kStreamChunk> stream;
  if (kStreamed && per_cycle > 0)
    stream.start(desc, reinterpret_cast<uint4*>(sm + h.s_pre), per_cycle,
                 h.n_light > 0 ? h.n_light : per_cycle, lane);
  uint4 d = !kStreamed && h.n_light > 0 ? desc[2 * lane] : zero4;
  // the global layout's control word (word 7): flags and micro-op
  uint32_t dc = kGlobal && h.n_light > 0 ? desc[2 * lane + 1].w : 0u;
  // one heavy round (every app): its descriptor stays in registers
  const uint4 ha = !kStreamed && h.n_heavy > 0 ? heavy[2 * lane] : zero4;
  const uint4 hb = !kStreamed && h.n_heavy > 0 ? heavy[2 * lane + 1] : zero4;
  // the output staging: out_chunk cycles a bank, a power of two, so a
  // cycle takes its bank and column by a shift and a mask (no division by a
  // run-time value on the cycle's path)
  const int oc = h.out_chunk, oshift = __ffs(oc) - 1;
  const int obank = h.n_out * oc;
  for (int t = 0; t < h.cycles; ++t) {
    if ((t & (kChunk - 1)) == kChunk - 1 && t + 1 < h.cycles) {
      // input chunk t / 32 + 1 has landed
      cp_async_wait_all();
      __syncwarp();
      stage_inputs<kGlobal>(h, t / kChunk + 2, inbuf, in, lane);
    }
    if ((t & (oc - 1)) == oc - 1 && t >= oc)
      flush_outputs(h, (t >> oshift) - 1, outbuf, out, lane);
    const char* V = reinterpret_cast<const char*>(val + (t & 1) * h.stride);
    char* Vw = reinterpret_cast<char*>(val + (t & 1) * h.stride);
    char* Vn = reinterpret_cast<char*>(val + ((t + 1) & 1) * h.stride);
    const int u = t + 1;
    const char* inb = reinterpret_cast<const char*>(
        inbuf + ((u / kChunk) & 1) * h.n_in * kChunk + u % kChunk);
    char* outb = reinterpret_cast<char*>(
        outbuf + ((t >> oshift) & 1) * obank + (t & (oc - 1)));
    auto put = [&](uint32_t ctl, uint32_t dest, uint32_t v) {
      char* db = (ctl & kDNext) ? Vn : ((ctl & kDOut) ? outb : Vw);
      *reinterpret_cast<uint32_t*>(db + dest) = v;
    };
    for (int k = 0; k < h.n_light; ++k) {
      uint4 dn = zero4;
      uint32_t dcn = 0u;
      if (kStreamed) {
        uint4 sd[2];
        stream.advance(sd);
        d = sd[0];
      } else {
        // the next round's descriptor first, off this round's chain
        dn = desc[2 * ((k + 1) * kLanes + lane)];
        dcn = kGlobal ? desc[2 * ((k + 1) * kLanes + lane) + 1].w : 0u;
      }
      const uint32_t ctl = kGlobal ? dc : d.w;
      const uint32_t dest = kGlobal ? d.w : (d.w & kDestMask);
      const uint32_t x = lds((ctl & kXIn) ? inb : V, d.x);
      const uint32_t v = alu16(ctl >> 24, x, lds(V, d.y), lds(V, d.z));
      put(ctl, dest, v);
      __syncwarp();
      if (!kStreamed) {
        d = dn;
        dc = dcn;
      }
    }
    for (int k = 0; k < h.n_heavy; ++k) {
      uint4 a, b;
      if (kStreamed) {
        uint4 sd[2];
        stream.advance(sd);
        a = sd[0];
        b = sd[1];
      } else {
        a = k == 0 ? ha : heavy[2 * (k * kLanes + lane)];
        b = k == 0 ? hb : heavy[2 * (k * kLanes + lane) + 1];
      }
      const uint32_t ctl = kGlobal ? b.w : a.w;
      const uint32_t dest = kGlobal ? a.w : (a.w & kDestMask);
      const uint32_t x = lds((ctl & kXIn) ? inb : V, a.x);
      const int item = k * kLanes + lane;
      const uint32_t p = ptr[item];             // the ring's write slot
      const uint32_t pn = p + 1 == b.z ? 0u : p + 1;
      const uint32_t head = ring[b.y + pn];     // written L - 1 cycles ago
      uint32_t v = alu16(ctl >> 24, x, lds(V, a.y), lds(V, a.z));
      if (h.n_rom > 0) {                  // the lookup only where ROMs are
        const uint32_t r = rom_lookup(roms[b.x], table, x);
        v = (ctl & kRom) ? r : v;
      }
      ring[b.y + p] = v;
      ptr[item] = pn;
      put(ctl, dest, (ctl & kRing) ? head : v);
    }
    __syncwarp();
  }
  // the outputs not flushed yet: the last output chunk, and the one before
  // it unless the last is whole
  const int last = (h.cycles - 1) >> oshift;
  if ((h.cycles & (oc - 1)) != 0 && last > 0)
    flush_outputs(h, last - 1, outbuf, out, lane);
  if (h.cycles > 0) flush_outputs(h, last, outbuf, out, lane);
  cp_async_wait_all();
}

template <int kLayout>
cudaError_t launch_dense(const DenseHeader& h, int* blob, const long long* in,
                         long long* out, cudaStream_t stream) {
  const size_t smem = kLayout == kGlobalLayout
                          ? 0 : static_cast<size_t>(h.s_words) * sizeof(int);
  if (smem > 48 * 1024) {                 // past the default, opt in
    const cudaError_t err = cudaFuncSetAttribute(
        sim_dense_kernel<kLayout>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  sim_dense_kernel<kLayout><<<1, kLanes, smem, stream>>>(h, blob, in, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int sim_dense_header_ints() { return sizeof(DenseHeader) / sizeof(int); }

// hdr: DenseHeader's fields, host memory. blob: the program (shared and
// stream layouts) or the workspace of s_words words that starts with it
// (global layout), device memory. in: int64 [n_in, cycles], out: int64 [n_out, cycles],
// device memory. Returns the launch's cudaError_t.
int sim_dense_launch(const int* hdr, int* blob, const long long* in,
                     long long* out, cudaStream_t stream) {
  DenseHeader h;
  memcpy(&h, hdr, sizeof(h));
  switch (h.layout) {
    case kSharedLayout: return launch_dense<kSharedLayout>(h, blob, in, out, stream);
    case kStreamLayout: return launch_dense<kStreamLayout>(h, blob, in, out, stream);
    case kGlobalLayout: return launch_dense<kGlobalLayout>(h, blob, in, out, stream);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
