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
  int stride, blob_words;
  // sections of the program blob (copied to shared memory as it is)
  int o_desc, o_const, o_rom, o_table;
  // state sections in shared memory, after the blob
  int s_val, s_ring, s_ptr, s_in, s_out, s_words;
};

constexpr int kLanes = 32;
constexpr int kChunk = 32;                // sim.py CHUNK

// Descriptor flags, bits 18-23 of word 3 (sim.py DENSE_FLAGS); the
// destination's byte offset sits below them, the micro-op above.
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
// inbuf[bank][row][cycle % 32].
__device__ __forceinline__ void stage_inputs(const DenseHeader& h, int c,
                                             uint32_t* inbuf,
                                             const long long* in, int lane) {
  const int t0 = c * kChunk;
  if (t0 >= h.cycles) return;
  const int width = min(kChunk, h.cycles - t0);
  uint32_t* dst = inbuf + (c & 1) * h.n_in * kChunk;
  for (int i = lane; i < h.n_in * width; i += kLanes) {
    const int r = i / width, k = i % width;
    cp_async4(dst + r * kChunk + k,
              in + static_cast<size_t>(r) * h.cycles + t0 + k);
  }
  cp_async_commit();
}

// The outputs of chunk c, from staging bank c % 2 to out[n_out, cycles].
__device__ __forceinline__ void flush_outputs(const DenseHeader& h, int c,
                                              const uint32_t* outbuf,
                                              long long* out, int lane) {
  const int t0 = c * kChunk;
  const int width = min(kChunk, h.cycles - t0);
  const uint32_t* src = outbuf + (c & 1) * h.n_out * kChunk;
  for (int i = lane; i < h.n_out * width; i += kLanes) {
    const int o = i / width, k = i % width;
    out[static_cast<size_t>(o) * h.cycles + t0 + k] = src[o * kChunk + k];
  }
}

__global__ void __launch_bounds__(kLanes, 1)
sim_dense_kernel(DenseHeader h, const int* __restrict__ blob,
                 const long long* __restrict__ in,
                 long long* __restrict__ out) {
  extern __shared__ __align__(16) int sm[];
  const int lane = threadIdx.x;
  copy_blob(sm, blob, h.blob_words, lane);
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
  const uint4* desc = reinterpret_cast<const uint4*>(sm + h.o_desc);
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
  stage_inputs(h, 0, inbuf, in, lane);
  cp_async_wait_all();
  stage_inputs(h, 1, inbuf, in, lane);
  __syncwarp();
  for (int i = lane; i < h.n_in; i += kLanes) val[i] = inbuf[i * kChunk];
  __syncwarp();

  const uint4 zero4 = make_uint4(0, 0, 0, 0);
  uint4 d = h.n_light > 0 ? desc[2 * lane] : zero4;
  // one heavy round (every app): its descriptor stays in registers
  const uint4 ha = h.n_heavy > 0 ? heavy[2 * lane] : zero4;
  const uint4 hb = h.n_heavy > 0 ? heavy[2 * lane + 1] : zero4;
  for (int t = 0; t < h.cycles; ++t) {
    if ((t & (kChunk - 1)) == kChunk - 1) {
      const int c = t / kChunk;
      if (t + 1 < h.cycles) {             // chunk c + 1 has landed
        cp_async_wait_all();
        __syncwarp();
        stage_inputs(h, c + 2, inbuf, in, lane);
      }
      if (c > 0) flush_outputs(h, c - 1, outbuf, out, lane);
    }
    const char* V = reinterpret_cast<const char*>(val + (t & 1) * h.stride);
    char* Vw = reinterpret_cast<char*>(val + (t & 1) * h.stride);
    char* Vn = reinterpret_cast<char*>(val + ((t + 1) & 1) * h.stride);
    const int u = t + 1;
    const char* inb = reinterpret_cast<const char*>(
        inbuf + ((u / kChunk) & 1) * h.n_in * kChunk + u % kChunk);
    char* outb = reinterpret_cast<char*>(
        outbuf + ((t / kChunk) & 1) * h.n_out * kChunk + t % kChunk);
    for (int k = 0; k < h.n_light; ++k) {
      // the next round's descriptor first, off this round's chain
      const uint4 dn = desc[2 * ((k + 1) * kLanes + lane)];
      const uint32_t x = lds((d.w & kXIn) ? inb : V, d.x);
      const uint32_t v = alu16(d.w >> 24, x, lds(V, d.y), lds(V, d.z));
      char* db = (d.w & kDNext) ? Vn : ((d.w & kDOut) ? outb : Vw);
      *reinterpret_cast<uint32_t*>(db + (d.w & kDestMask)) = v;
      __syncwarp();
      d = dn;
    }
    for (int k = 0; k < h.n_heavy; ++k) {
      const uint4 a = k == 0 ? ha : heavy[2 * (k * kLanes + lane)];
      const uint4 b = k == 0 ? hb : heavy[2 * (k * kLanes + lane) + 1];
      const uint32_t x = lds((a.w & kXIn) ? inb : V, a.x);
      const int item = k * kLanes + lane;
      const uint32_t p = ptr[item];             // the ring's write slot
      const uint32_t pn = p + 1 == b.z ? 0u : p + 1;
      const uint32_t head = ring[b.y + pn];     // written L - 1 cycles ago
      uint32_t v = alu16(a.w >> 24, x, lds(V, a.y), lds(V, a.z));
      if (h.n_rom > 0) {                  // the lookup only where ROMs are
        const uint32_t r = rom_lookup(roms[b.x], table, x);
        v = (a.w & kRom) ? r : v;
      }
      ring[b.y + p] = v;
      ptr[item] = pn;
      char* db = (a.w & kDNext) ? Vn : ((a.w & kDOut) ? outb : Vw);
      *reinterpret_cast<uint32_t*>(db + (a.w & kDestMask)) =
          (a.w & kRing) ? head : v;
    }
    __syncwarp();
  }
  // the outputs not flushed yet: the last chunk, and the one before it
  // unless the last chunk is whole
  const int last = (h.cycles - 1) / kChunk;
  if (h.cycles % kChunk != 0 && last > 0)
    flush_outputs(h, last - 1, outbuf, out, lane);
  if (h.cycles > 0) flush_outputs(h, last, outbuf, out, lane);
  cp_async_wait_all();
}

}  // namespace

extern "C" {

int sim_dense_header_ints() { return sizeof(DenseHeader) / sizeof(int); }

// hdr: DenseHeader's fields, host memory. blob: the program, device memory.
// in: int64 [n_in, cycles], out: int64 [n_out, cycles], device memory.
// Returns the launch's cudaError_t.
int sim_dense_launch(const int* hdr, const int* blob, const long long* in,
                     long long* out, cudaStream_t stream) {
  DenseHeader h;
  memcpy(&h, hdr, sizeof(h));
  const size_t smem = static_cast<size_t>(h.s_words) * sizeof(int);
  if (smem > 48 * 1024) {                 // past the default, opt in
    const cudaError_t err = cudaFuncSetAttribute(
        sim_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  sim_dense_kernel<<<1, kLanes, smem, stream>>>(h, blob, in, out);
  return cudaGetLastError();
}

}  // extern "C"
