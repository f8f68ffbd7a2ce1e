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
// at the card's rates; the run takes what (stages + 2) block barriers and
// shared-memory round trips a cycle take, times the cycles.
//
// What the design does about that bound:
//   * One launch runs all cycles, in one thread block, with no host round
//     trip: the reference's per-op XLA program becomes one loop on one SM.
//   * The value vector, the rings, the accumulators and the program itself
//     (op, three argument slots and ROM row a node; the ROM tables) live in
//     shared memory, copied there once.
//   * The host splits the level-ordered groups into stages (a stage ends
//     before the first group that reads a slot the stage wrote), so a cycle
//     takes one __syncthreads() a stage, not one a level-and-opcode group.
//   * Inputs are staged into shared memory a chunk of cycles at a time, so a
//     cycle waits on no device-memory load.
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
  int n_nodes, n_in, n_out, n_seq, n_acc, n_const, n_comb, comb_base;
  int n_stages, max_tab, cycles, chunk, threads, blob_words;
  // sections of the program blob (copied to shared memory as it is)
  int o_comb, o_stage, o_seq, o_seq_lat, o_ring_off, o_acc, o_out_pos;
  int o_const, o_table, o_tab_len;
  // state sections in shared memory, after the blob
  int s_val, s_ring, s_ptr, s_acc, s_in, s_words;
};

__device__ __forceinline__ uint32_t eval_node(const int* d,
                                              const uint32_t* val,
                                              const int* table, int max_tab,
                                              const int* tab_len) {
  return sim_op(d[0] & 0xff, val[d[1]], val[d[2]], val[d[3]], d[0] >> 8,
                table, max_tab, tab_len);
}

__global__ void sim_dense_kernel(DenseHeader h, const int* __restrict__ blob,
                                 const long long* __restrict__ in,
                                 long long* __restrict__ out) {
  extern __shared__ int sm[];
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < h.blob_words; i += nt) sm[i] = blob[i];
  uint32_t* val = reinterpret_cast<uint32_t*>(sm + h.s_val);
  uint32_t* ring = reinterpret_cast<uint32_t*>(sm + h.s_ring);
  int* ptr = sm + h.s_ptr;
  uint32_t* acc = reinterpret_cast<uint32_t*>(sm + h.s_acc);
  uint32_t* inbuf = reinterpret_cast<uint32_t*>(sm + h.s_in);
  for (int i = h.s_val + tid; i < h.s_words; i += nt) sm[i] = 0;
  __syncthreads();
  const int* comb = sm + h.o_comb;
  const int* stage = sm + h.o_stage;
  const int* seq = sm + h.o_seq;
  const int* seq_lat = sm + h.o_seq_lat;
  const int* ring_off = sm + h.o_ring_off;
  const int* accd = sm + h.o_acc;
  const int* out_pos = sm + h.o_out_pos;
  const int* table = sm + h.o_table;
  const int* tab_len = sm + h.o_tab_len;
  for (int i = tid; i < h.n_const; i += nt)
    val[sm[h.o_const + 2 * i]] = static_cast<uint32_t>(sm[h.o_const + 2 * i + 1]);

  const int n_present = h.n_in + h.n_seq + h.n_acc;
  for (int t = 0; t < h.cycles; ++t) {
    const int tc = t % h.chunk;
    if (tc == 0) {
      const int width = min(h.chunk, h.cycles - t);
      for (int i = tid; i < h.n_in * h.chunk; i += nt) {
        const int r = i / h.chunk, c = i % h.chunk;
        inbuf[i] = c < width ? static_cast<uint32_t>(
                                   in[static_cast<size_t>(r) * h.cycles + t + c])
                             : 0u;
      }
      __syncthreads();
    }
    // present: the canonical layout puts inputs, seq heads and accumulators
    // in slots [0, n_in + n_seq + n_acc), in that order
    for (int i = tid; i < n_present; i += nt) {
      uint32_t v;
      if (i < h.n_in) {
        v = inbuf[i * h.chunk + tc];
      } else if (i < h.n_in + h.n_seq) {
        const int j = i - h.n_in;
        v = ring[ring_off[j] + ptr[j]];
      } else {
        v = acc[i - h.n_in - h.n_seq];
      }
      val[i] = v;
    }
    __syncthreads();
    // combinational: stage by stage; a stage's nodes read no slot it writes
    for (int s = 0; s < h.n_stages; ++s) {
      for (int k = stage[s] + tid; k < stage[s + 1]; k += nt)
        val[h.comb_base + k] = eval_node(comb + 4 * k, val, table, h.max_tab,
                                         tab_len);
      __syncthreads();
    }
    // outputs and sample: read val only, write out, acc and the rings
    for (int o = tid; o < h.n_out; o += nt)
      out[static_cast<size_t>(o) * h.cycles + t] = val[out_pos[o]];
    for (int k = tid; k < h.n_acc; k += nt) {
      const int* d = accd + 3 * k;          // src slot, pred slot, predicated
      if (!d[2] || (val[d[1]] & 1u)) acc[k] = (acc[k] + val[d[0]]) & kMask;
    }
    for (int j = tid; j < h.n_seq; j += nt) {
      const uint32_t v = eval_node(seq + 4 * j, val, table, h.max_tab, tab_len);
      const int p = ptr[j];
      ring[ring_off[j] + p] = v;
      ptr[j] = p + 1 == seq_lat[j] ? 0 : p + 1;
    }
    __syncthreads();
  }
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
  sim_dense_kernel<<<1, h.threads, smem, stream>>>(h, blob, in, out);
  return cudaGetLastError();
}

}  // extern "C"
