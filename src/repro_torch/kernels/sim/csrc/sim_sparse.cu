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
// microseconds at the card's rates; the run takes two block barriers and a
// few shared-memory round trips a round, times the rounds.
//
// What the design does about that bound:
//   * One launch runs every round, in one thread block, with no host round
//     trip; the stop test is one __syncthreads_or a round.
//   * Buffers, occupancies, read pointers and the program's index tables
//     live in shared memory. Every buffer has one producer and one
//     consumer, so the pop and the push of a buffer are one thread's work,
//     and every node's state (accumulator, feed pointer, output count) has
//     one owner thread: a round needs no atomics.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

#include "sim_ops.cuh"

namespace {

// All sizes and offsets, in 32-bit words. The field order is the Python
// wrapper's SPARSE_FIELDS (repro_torch/kernels/sim/sim.py). Index entries
// of -1 mean "none" (a masked input or fan-out slot, no producer, ...).
struct SparseHeader {
  int n_buf, max_cap, n_ev, fan, n_in, fan_in, n_out, max_tab, n_rows;
  int max_feed, max_cycles, threads, blob_words;
  // sections of the program blob (copied to shared memory as it is)
  int o_cap, o_ev, o_ev_out, o_in_out, o_out_buf, o_buf_src_ev, o_buf_src_in;
  int o_buf_cons_ev, o_buf_cons_out, o_buf_const, o_table, o_tab_len;
  // state sections in shared memory, after the blob
  int s_buf, s_blen, s_brp, s_fire, s_v, s_accv, s_tok, s_fptr, s_frem;
  int s_ocnt, s_words;
};

__global__ void sim_sparse_kernel(SparseHeader h, const int* __restrict__ blob,
                                  const long long* __restrict__ feed,
                                  const long long* __restrict__ frem0,
                                  long long* __restrict__ outm,
                                  long long* __restrict__ state) {
  extern __shared__ int sm[];
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < h.blob_words; i += nt) sm[i] = blob[i];
  for (int i = h.s_buf + tid; i < h.s_words; i += nt) sm[i] = 0;
  __syncthreads();
  for (int i = tid; i < h.n_in; i += nt)
    sm[h.s_frem + i] = static_cast<int>(frem0[i]);
  const int* cap = sm + h.o_cap;
  const int* ev = sm + h.o_ev;                // op | rom << 8, in0, in1, in2
  const int* ev_out = sm + h.o_ev_out;        // [n_ev, fan]
  const int* in_out = sm + h.o_in_out;        // [n_in, fan_in]
  const int* out_buf = sm + h.o_out_buf;
  const int* src_ev = sm + h.o_buf_src_ev;
  const int* src_in = sm + h.o_buf_src_in;
  const int* cons_ev = sm + h.o_buf_cons_ev;
  const int* cons_out = sm + h.o_buf_cons_out;
  const int* cval = sm + h.o_buf_const;      // const value, or -1
  const int* table = sm + h.o_table;
  const int* tab_len = sm + h.o_tab_len;
  uint32_t* buf = reinterpret_cast<uint32_t*>(sm + h.s_buf);
  int* blen = sm + h.s_blen;
  int* brp = sm + h.s_brp;
  // fire flags: ev nodes, then outputs, then inputs
  int* fire = sm + h.s_fire;
  uint32_t* v = reinterpret_cast<uint32_t*>(sm + h.s_v);
  uint32_t* accv = reinterpret_cast<uint32_t*>(sm + h.s_accv);
  uint32_t* tok = reinterpret_cast<uint32_t*>(sm + h.s_tok);
  int* fptr = sm + h.s_fptr;
  int* frem = sm + h.s_frem;
  int* ocnt = sm + h.s_ocnt;
  __syncthreads();

  const int n_items = h.n_ev + h.n_out + h.n_in + h.n_buf;
  int fired = 1, rounds = 0;
  while (rounds < h.max_cycles) {
    ++rounds;
    // phase A: fire decisions and evaluation against the frozen state
    int any = 0;
    for (int i = tid; i < n_items; i += nt) {
      if (i < h.n_ev) {
        const int* d = ev + 4 * i;
        bool ok = d[1] >= 0 || d[2] >= 0 || d[3] >= 0;
        uint32_t a[3];
        for (int k = 0; k < 3; ++k) {
          const int b = d[1 + k];
          a[k] = 0u;
          if (b >= 0) {
            ok = ok && blen[b] > 0;
            a[k] = buf[b * h.max_cap + brp[b]];
          }
        }
        for (int f = 0; f < h.fan; ++f) {
          const int b = ev_out[i * h.fan + f];
          if (b >= 0) ok = ok && blen[b] < cap[b];
        }
        fire[i] = ok;
        if (ok) {
          const int op = d[0] & 0xff;
          uint32_t r;
          if (op == kOp_acc) {
            r = accv[i] = (accv[i] + a[0]) & kMask;
          } else if (op == kOp_accp) {
            if (a[1] & 1u) accv[i] = (accv[i] + a[0]) & kMask;
            r = accv[i];
          } else {
            r = sim_op(op, a[0], a[1], a[2], d[0] >> 8, table, h.max_tab,
                       tab_len);
          }
          v[i] = r;
          any = 1;
        }
      } else if (i < h.n_ev + h.n_out) {
        const int o = i - h.n_ev, b = out_buf[o];
        const bool ok = blen[b] > 0;
        fire[i] = ok;
        if (ok) {
          outm[static_cast<size_t>(o) * h.max_cycles + ocnt[o]] =
              buf[b * h.max_cap + brp[b]];
          ++ocnt[o];
          any = 1;
        }
      } else if (i < h.n_ev + h.n_out + h.n_in) {
        const int j = i - h.n_ev - h.n_out;
        bool ok = frem[j] > 0;
        for (int f = 0; f < h.fan_in; ++f) {
          const int b = in_out[j * h.fan_in + f];
          if (b >= 0) ok = ok && blen[b] < cap[b];
        }
        fire[i] = ok;
        if (ok) {
          tok[j] = static_cast<uint32_t>(
              feed[static_cast<size_t>(j) * h.max_feed + fptr[j]]);
          ++fptr[j];
          --frem[j];
          any = 1;
        }
      } else {
        const int b = i - h.n_ev - h.n_out - h.n_in;
        if (cval[b] >= 0 && blen[b] == 0) any = 1;      // a const refill
      }
    }
    fired = __syncthreads_or(any);
    if (!fired) break;
    // phase B: each buffer's pop, then its push against the new occupancy
    for (int b = tid; b < h.n_buf; b += nt) {
      int len = blen[b], rp = brp[b];
      const bool refill = cval[b] >= 0 && len == 0;
      const bool popped =
          (cons_ev[b] >= 0 && fire[cons_ev[b]]) ||
          (cons_out[b] >= 0 && fire[h.n_ev + cons_out[b]]);
      if (popped) {
        --len;
        rp = rp + 1 == cap[b] ? 0 : rp + 1;
      }
      bool push = false;
      uint32_t pval = 0u;
      if (src_ev[b] >= 0 && fire[src_ev[b]]) {
        push = true;
        pval = v[src_ev[b]];
      } else if (src_in[b] >= 0 && fire[h.n_ev + h.n_out + src_in[b]]) {
        push = true;
        pval = tok[src_in[b]];
      } else if (refill) {
        push = true;
        pval = static_cast<uint32_t>(cval[b]);
      }
      if (push) {
        buf[b * h.max_cap + (rp + len) % cap[b]] = pval;
        ++len;
      }
      blen[b] = len;
      brp[b] = rp;
    }
    __syncthreads();
  }

  // state: blen [n_buf], frem [n_rows], ocnt [max(1, n_out)], fired,
  // rounds; feed rows past n_in and the output count past n_out are the
  // lowering's padding
  const int n_ocnt = max(1, h.n_out);
  long long* st_frem = state + h.n_buf;
  long long* st_ocnt = st_frem + h.n_rows;
  for (int b = tid; b < h.n_buf; b += nt) state[b] = blen[b];
  for (int j = tid; j < h.n_rows; j += nt)
    st_frem[j] = j < h.n_in ? frem[j] : frem0[j];
  for (int o = tid; o < n_ocnt; o += nt) st_ocnt[o] = o < h.n_out ? ocnt[o] : 0;
  if (tid == 0) {
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
  sim_sparse_kernel<<<1, h.threads, smem, stream>>>(h, blob, feed, frem0,
                                                    outm, state);
  return cudaGetLastError();
}

}  // extern "C"
