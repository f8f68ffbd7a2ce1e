// One-token GQA decode attention over a KV cache, for Hopper (sm_90a),
// split over the cache (flash-decoding).
//
// Replaces the TPU kernel src/repro/kernels/flash_decode/flash_decode.py
// ::_decode_kernel (pallas_call at line 90). Same function: q [B, KV, G, hd]
// against k/v [B, KV, T, hd]; cache slots t >= lengths[b] are masked; the
// online-softmax state is f32; the output is [B, KV, G, hd] in q's type.
//
// Bound on an H100: memory. Every cached element feeds 4 * G flops (QK and
// PV), far below the card's ~295 flops per byte ridge, so the least time is
// the K and V rows below each sequence's length read once:
//     2 * KV * hd * sum_b min(lengths[b], T) * sizeof(dtype) bytes
// (2 * B * KV * T * hd * sizeof(dtype) at full length) over 3.35 TB/s.
//
// What the design does about that bound: keep every SM's share of the
// bandwidth busy, and the arithmetic off its path.
//   * The grid is (B * KV * ceil(G / heads a block), n_split). The wrapper
//     chooses n_split on the host from T, B * KV and the SM count (never
//     from lengths, which would sync): as many as put at most two blocks on
//     each SM (a ragged last wave of memory-bound blocks costs), at most
//     one split a tile. Split y of sequence b takes rows [y * c, (y + 1) *
//     c) of [0, lengths[b]), where c = ceil(lengths[b] / n_split) rounded
//     up to whole tiles, so a short sequence leaves its last splits empty.
//   * A block streams its rows in tiles of bk rows through a ring of up to 4
//     stages, filled by one producer warp and released by four consumer
//     warps through full and empty mbarriers; no block-wide barrier until
//     the warps merge their states once, at the end of the chunk.
//   * bf16 at hd 16, 32, 64 or 128 with bk a multiple of 16 (the serving
//     path) runs on the tensor cores: the producer copies rows with 16-byte
//     cp.async into XOR-swizzled rows (conflict-free ldmatrix), each warp
//     takes 16-row units in turn, S = Q K^T and O += P V are mma.sync
//     m16n8k16 products with 16 query heads as M, the online softmax runs
//     on the S fragment, and P goes in as two bf16 halves (hi + lo).
//   * Everything else (f32, other head dims) runs on CUDA cores: rows [t0,
//     t0 + rows) of one (b, kv) pair are one contiguous byte range, so one
//     thread fills a stage with two 1-D bulk copies (cp.async.bulk, no
//     tensor map). 4 query heads a block stay in registers; a cache row is
//     split over LPR lanes, 16 bytes a lane, so a warp scores 32 / LPR rows
//     at once and keeps its own running (m, l, acc), updated every 4 rows.
//   * With one split the block writes the output. With more it writes a
//     partial (m, l, acc) in f32 and a second kernel rescales and sums the
//     partials into the output, launched as a programmatic dependent so
//     that its launch overlaps the first kernel's tail. An empty chunk
//     writes m = -inf, l = 0, acc = 0, which the merge weighs 0; a row whose
//     every partial is empty stays 0 (the l == 0 guard).
//   * The partial form (a non-null `lse`): the normalised output in f32
//     (not q's type: a merge of shards' outputs rounded to bf16 each would
//     round twice) and, beside it, each row's log-sum-exp [B, KV, G] in f32,
//     written by the kernel that writes the output (the split kernel with
//     one split, else the combine), in natural log units of the scaled
//     scores: lse = ln sum_t exp(q.k_t / sqrt(hd)) = (M + log2 L) ln 2 over
//     the state (M in log2 units, L). A length of 0
//     (a cache shard wholly past its sequence's frontier) gives output 0
//     and lse = -inf, which a merge of partial states weighs 0. The caller
//     combines the states of several cache shards, one a rank, as the
//     combine kernel combines splits; each shard passes its own frontier,
//     so the kernel needs no slot offset.
//
// Known limits: on CUDA cores a group of more than 4 query heads is taken 4
// heads a block (16 on the tensor cores), so its cache is read once for
// each 4 (llama3-8b has G = 4). The split count follows T, not lengths: a
// short sequence in a long cache gets fewer blocks, each of at least one
// tile. The CUDA-core scoring loop, not its copies, sets that route's time
// at long caches.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                   // consumer warps
constexpr int kConsumers = 32 * kWarps;
constexpr int kThreads = kConsumers + 32;   // and one producer warp
constexpr int kGB = 4;                      // query heads a CUDA-core block
constexpr int kRB = 4;                      // rows a group takes an update
constexpr int kMaxStages = 4;
constexpr int kBarBytes = 128;              // the ring's mbarriers, padded
constexpr int kCombineThreads = 128;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* out;        // [B, KV, G, hd], q's type; f32 where lse is given
  float* lse;       // [B, KV, G] or null: log-sum-exp, natural log units
  float* part_ml;   // [B * KV, n_split, G, 2]: m (log2 units), l
  float* part_acc;  // [B * KV, n_split, G, hd]
  int KV, G, T, hd, bk, n_split, n_hg, stages;
  float scale_log2;  // log2(e) / sqrt(hd)
};

// 16 bytes of the cache or of q: 4 floats or 8 bf16, widened to f32.
template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* x) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  }
};
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* x) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x, x[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// The weight 2^(m - M) of a softmax state with running max m in a merge
// whose max is M >= m; an empty state (m = -inf) weighs 0, also when M is
// -inf too.
__device__ __forceinline__ float weight(float m, float M) {
  return m == -INFINITY ? 0.f : exp2f(m - M);
}

// The output's element i: q's type, or f32 in the partial form.
template <typename T>
__device__ __forceinline__ void store_out(const Params& p, size_t i, float x) {
  if (p.lse)
    store(static_cast<float*>(p.out) + i, x);
  else
    store(static_cast<T*>(p.out) + i, x);
}

// A state's log-sum-exp in natural log units: (M + log2 L) ln 2, M the
// running max in log2 units and L the sum of 2^(s - M); -inf when empty.
__device__ __forceinline__ float log_sum_exp(float M, float L) {
  return L == 0.f ? -INFINITY : (M + log2f(L)) * 0.6931471805599453f;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// A 1-D bulk copy global -> shared of `bytes` (a multiple of 16, both
// addresses 16-byte aligned), counted on `bar`'s transaction count.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// What one block of the grid takes: the (b, kv) pair bh, query heads
// [g0, g0 + gb), and the rows [c0, c1) of split `split` of the cache, in
// n_tiles tiles of bk rows.
struct Span {
  int bh, g0, gb, split, c0, c1, n_tiles;
};

__device__ __forceinline__ Span span_of(const Params& p, int heads) {
  Span sp;
  sp.bh = blockIdx.x / p.n_hg;
  sp.g0 = (blockIdx.x - sp.bh * p.n_hg) * heads;
  sp.gb = min(heads, p.G - sp.g0);
  sp.split = blockIdx.y;
  const int len = max(0, min(p.lengths[sp.bh / p.KV], p.T));
  const int per = (len + p.n_split - 1) / p.n_split;
  const int chunk = (per + p.bk - 1) / p.bk * p.bk;
  sp.c0 = static_cast<int>(min(static_cast<long long>(len),
                               static_cast<long long>(sp.split) * chunk));
  sp.c1 = min(len, sp.c0 + chunk);
  sp.n_tiles = (sp.c1 - sp.c0 + p.bk - 1) / p.bk;
  return sp;
}

// The end of a block: merge the consumer warps' states (running max m in
// log2 units, sum l, accumulator acc over `heads` heads of hd each) into
// the output (one split) or the block's partial (m, l, acc).
template <typename T>
__device__ __forceinline__ void merge_warps(const Params& p, const Span& sp,
                                            int heads, const float* red_m,
                                            const float* red_l,
                                            const float* red_acc) {
  const int hd = p.hd;
  for (int i = threadIdx.x; i < sp.gb * hd; i += kConsumers) {
    const int g = i / hd, d = i - g * hd;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, red_m[w * heads + g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = weight(red_m[w * heads + g], M);
      L += red_l[w * heads + g] * wt;
      A += red_acc[(w * heads + g) * hd + d] * wt;
    }
    const size_t row = static_cast<size_t>(sp.bh) * p.G + sp.g0 + g;
    if (p.n_split == 1) {
      store_out<T>(p, row * hd + d, A / (L == 0.f ? 1.f : L));
      if (p.lse && d == 0) p.lse[row] = log_sum_exp(M, L);
    } else {
      const size_t part =
          (static_cast<size_t>(sp.bh) * p.n_split + sp.split) * p.G + sp.g0 +
          g;
      p.part_acc[part * hd + d] = A;
      if (d == 0) {
        p.part_ml[2 * part] = M;
        p.part_ml[2 * part + 1] = L;
      }
    }
  }
}

// LPR lanes share a cache row, NC 16-byte chunks of it each.
template <typename T, int LPR, int NC>
__global__ void __launch_bounds__(kThreads)
    flash_decode_split_kernel(const Params p) {
  using V = Chunk<T>;
  constexpr int EPL = V::N;        // elements a chunk
  constexpr int E = NC * EPL;      // elements of a row a lane holds
  constexpr int RPW = 32 / LPR;    // rows a warp scores at once
  constexpr int NG = kWarps * RPW; // row groups a block

  extern __shared__ __align__(128) unsigned char smem[];
  const int S = p.stages, hd = p.hd, bk = p.bk;
  const size_t tile_elems = static_cast<size_t>(bk) * hd;
  unsigned char* ring = smem + kBarBytes;
  float* red_m = reinterpret_cast<float*>(ring + 2 * S * tile_elems *
                                                     sizeof(T));
  float* red_l = red_m + kWarps * kGB;
  float* red_acc = red_l + kWarps * kGB;
  const uint32_t bars = smem_addr(smem);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (S + s); };

  const Span sp = span_of(p, kGB);
  const int bh = sp.bh, g0 = sp.g0, gb = sp.gb;
  const int c0 = sp.c0, c1 = sp.c1, n_tiles = sp.n_tiles;
  const T* kg = static_cast<const T*>(p.k) + static_cast<size_t>(bh) * p.T * hd;
  const T* vg = static_cast<const T*>(p.v) + static_cast<size_t>(bh) * p.T * hd;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  if (warp == kWarps) {
    // ---- producer: one thread keeps the ring full ----
    if (lane == 0) {
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % S;
        if (t >= S) mbar_wait(empty(s), ((t / S) - 1) & 1);
        const int r0 = c0 + t * bk;
        const uint32_t bytes =
            static_cast<uint32_t>(min(bk, c1 - r0) * hd * sizeof(T));
        const uint32_t dst = smem_addr(ring + 2 * s * tile_elems * sizeof(T));
        mbar_expect_tx(full(s), 2 * bytes);
        bulk_load(dst, kg + static_cast<size_t>(r0) * hd, bytes, full(s));
        bulk_load(dst + tile_elems * sizeof(T),
                  vg + static_cast<size_t>(r0) * hd, bytes, full(s));
      }
    }
    return;
  }

  // ---- consumers ----
  const int sub = lane % LPR;                 // lane within its row group
  const int grp = warp * RPW + lane / LPR;    // row group within the block
  const int C = hd / EPL;                     // chunks a row

  float qf[kGB][E];
#pragma unroll
  for (int g = 0; g < kGB; ++g)
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = sub + i * LPR;
      float* x = qf[g] + i * EPL;
      if (g < gb && c < C) {
        V::load(static_cast<const T*>(p.q) +
                    (static_cast<size_t>(bh) * p.G + g0 + g) * hd + c * EPL,
                x);
#pragma unroll
        for (int e = 0; e < EPL; ++e) x[e] *= p.scale_log2;
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) x[e] = 0.f;
      }
    }
  float m[kGB], l[kGB], acc[kGB][E];
#pragma unroll
  for (int g = 0; g < kGB; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % S;
    mbar_wait(full(s), (t / S) & 1);
    const T* ks = reinterpret_cast<const T*>(ring) + 2 * s * tile_elems;
    const T* vs = ks + tile_elems;
    const int rows = min(bk, c1 - (c0 + t * bk));

    for (int j0 = 0; j0 < rows; j0 += NG * kRB) {  // uniform over the block
      // 1. Scores of kRB rows a group, in log2 units.
      float sc[kRB][kGB];
#pragma unroll
      for (int r = 0; r < kRB; ++r) {
        const int j = j0 + r * NG + grp;
        float kf[E];
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          const int c = sub + i * LPR;
          if (j < rows && c < C) {
            V::load(ks + static_cast<size_t>(j) * hd + c * EPL,
                    kf + i * EPL);
          } else {
#pragma unroll
            for (int e = 0; e < EPL; ++e) kf[i * EPL + e] = 0.f;
          }
        }
#pragma unroll
        for (int g = 0; g < kGB; ++g) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) d = fmaf(qf[g][e], kf[e], d);
          sc[r][g] = d;
        }
      }
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1)
#pragma unroll
        for (int r = 0; r < kRB; ++r)
#pragma unroll
          for (int g = 0; g < kGB; ++g)
            sc[r][g] += __shfl_xor_sync(0xffffffffu, sc[r][g], o);

      // 2. Online softmax: one rescale of the state per kRB rows.
#pragma unroll
      for (int g = 0; g < kGB; ++g) {
        float mx = m[g];
#pragma unroll
        for (int r = 0; r < kRB; ++r)
          if (j0 + r * NG + grp < rows) mx = fmaxf(mx, sc[r][g]);
        const float alpha = weight(m[g], mx);
        float sum = 0.f;
#pragma unroll
        for (int r = 0; r < kRB; ++r) {
          sc[r][g] = j0 + r * NG + grp < rows ? exp2f(sc[r][g] - mx) : 0.f;
          sum += sc[r][g];
        }
        l[g] = l[g] * alpha + sum;
        m[g] = mx;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
      }

      // 3. acc += p V over the same rows.
#pragma unroll
      for (int r = 0; r < kRB; ++r) {
        const int j = j0 + r * NG + grp;
        if (j >= rows) continue;
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          const int c = sub + i * LPR;
          if (c >= C) continue;
          float vf[EPL];
          V::load(vs + static_cast<size_t>(j) * hd + c * EPL, vf);
#pragma unroll
          for (int g = 0; g < kGB; ++g)
#pragma unroll
            for (int e = 0; e < EPL; ++e)
              acc[g][i * EPL + e] = fmaf(sc[r][g], vf[e], acc[g][i * EPL + e]);
        }
      }
    }
    mbar_arrive(empty(s));  // this thread has read stage s
  }
  // the combine kernel may launch now; it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // Merge the warp's row groups (lanes LPR apart), then the warps.
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1)
#pragma unroll
    for (int g = 0; g < kGB; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float M = fmaxf(m[g], mo);
      const float wa = weight(m[g], M), wb = weight(mo, M);
      l[g] = l[g] * wa + lo * wb;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
        acc[g][e] = acc[g][e] * wa + ao * wb;
      }
      m[g] = M;
    }
  if (lane < LPR) {
#pragma unroll
    for (int g = 0; g < kGB; ++g)
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = sub + i * LPR;
        if (c >= C) continue;
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          red_acc[(warp * kGB + g) * hd + c * EPL + e] = acc[g][i * EPL + e];
      }
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < kGB; ++g) {
      red_m[warp * kGB + g] = m[g];
      red_l[warp * kGB + g] = l[g];
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  merge_warps<T>(p, sp, kGB, red_m, red_l, red_acc);
}

// ---- the bf16 tensor-core kernel ----

constexpr int kMmaHeads = 16;  // query heads a block: mma's 16 rows

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// d += a b for a 16 x 16 bf16 A (row major), a 16 x 8 bf16 B (column
// major) and a 16 x 8 f32 D, in mma.sync's register fragments.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
// Arrive on `bar` once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// The 16-byte chunk c of cache row r of a tile sits at chunk c ^ f(r) of its
// row in shared memory, with C chunks a row (hd / 8): the 8 rows an
// ldmatrix reads at one chunk then fall on 8 distinct bank groups.
template <int C>
__device__ __forceinline__ int swizzle(int r, int c) {
  return c ^ (C >= 8 ? (r & 7) : ((r * C >> 3) & (C - 1)));
}

// The same function in bf16 on the tensor cores: S = Q K^T and O += P V as
// mma.sync m16n8k16 products with the block's 16 query heads as M (heads
// past G are zero rows). Each warp takes units of 16 cache rows in turn
// (bk a multiple of 16); P goes in as two bf16 halves, hi = bf16(p) and lo =
// bf16(p - hi), as in the bf16 flash_attention kernel. The producer warp
// fills the ring with 16-byte cp.async copies into swizzled rows (a bulk
// copy cannot swizzle, and ldmatrix over unswizzled 256-byte rows conflicts
// 8 ways); each lane's copies arrive on the stage's full barrier.
template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_decode_mma_kernel(const Params p) {
  constexpr int C = HD / 8;    // 16-byte chunks a row
  constexpr int kRow = 2 * HD;
  constexpr int NB = HD / 8;   // n8 blocks of O
  constexpr int KS = HD / 16;  // k16 steps of Q K^T

  extern __shared__ __align__(128) unsigned char smem[];
  const int S = p.stages, bk = p.bk;
  unsigned char* ring = smem + kBarBytes;
  const uint32_t ring_s = smem_addr(ring);
  const uint32_t tile_bytes = static_cast<uint32_t>(bk) * kRow;  // K or V
  const uint32_t bars = smem_addr(smem);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (S + s); };
  const Span sp = span_of(p, kMmaHeads);
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(p.k) + static_cast<size_t>(sp.bh) * p.T * HD;
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(p.v) + static_cast<size_t>(sp.bh) * p.T * HD;

  // Zero the ring: rows of a 16-row unit past a chunk's end are never
  // copied, and their p = 0 must not meet a NaN left in shared memory.
  // (cp.async writes through the generic proxy: the barrier below orders
  // the zeros before every copy.)
  for (uint32_t i = threadIdx.x; i < 2 * S * tile_bytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(ring)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 32);  // the producer warp's lanes
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  if (warp == kWarps) {
    // ---- producer warp: 16-byte copies into swizzled rows ----
    for (int t = 0; t < sp.n_tiles; ++t) {
      const int s = t % S;
      if (t >= S) mbar_wait(empty(s), ((t / S) - 1) & 1);
      const int r0 = sp.c0 + t * bk, rows = min(bk, sp.c1 - r0);
      const uint32_t dst = ring_s + 2 * s * tile_bytes;
      const char* ksrc = reinterpret_cast<const char*>(
          kg + static_cast<size_t>(r0) * HD);
      const char* vsrc = reinterpret_cast<const char*>(
          vg + static_cast<size_t>(r0) * HD);
      for (int i = lane; i < rows * C; i += 32) {
        const int r = i / C, c = i - r * C;
        const uint32_t off = r * kRow + swizzle<C>(r, c) * 16;
        cp_async16(dst + off, ksrc + 16 * static_cast<size_t>(i));
        cp_async16(dst + tile_bytes + off, vsrc + 16 * static_cast<size_t>(i));
      }
      cp_async_arrive(full(s));
    }
    return;
  }

  // ---- consumers ----
  const int g = lane >> 2, cq = 2 * (lane & 3);  // fragment row, column pair
  uint32_t qa[KS][4];  // Q as A: heads g and g + 8, d pairs cq and cq + 8
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) +
                            (static_cast<size_t>(sp.bh) * p.G + sp.g0) * HD;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int head = g + (i & 1) * 8, d = kk * 16 + cq + (i >> 1) * 8;
      qa[kk][i] = head < sp.gb
                      ? *reinterpret_cast<const uint32_t*>(qg + head * HD + d)
                      : 0u;
    }
  float o[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[nb][c] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // heads g, g + 8

  const int units_per_tile = bk / 16;
  for (int t = 0; t < sp.n_tiles; ++t) {
    const int s = t % S;
    mbar_wait(full(s), (t / S) & 1);
    const int rows = min(bk, sp.c1 - (sp.c0 + t * bk));
    const uint32_t k_s = ring_s + 2 * s * tile_bytes, v_s = k_s + tile_bytes;
    for (int u = 0; 16 * u < rows; ++u) {
      if ((t * units_per_tile + u) % kWarps != warp) continue;
      const int j0 = 16 * u;
      // 1. S = Q K^T over keys j0 .. j0 + 15 (two n8 blocks)
      float sc[2][4];
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[nb][c] = 0.f;
        const int kr = j0 + nb * 8 + (lane & 7);
        const uint32_t row = k_s + kr * kRow;
        if constexpr (KS == 1) {
          uint32_t r[2];
          ldsm_x2(r, row + swizzle<C>(kr, (lane >> 3) & 1) * 16);
          mma_bf16(sc[nb], qa[0], r[0], r[1]);
        } else {
#pragma unroll
          for (int kp = 0; kp < KS / 2; ++kp) {
            uint32_t r[4];
            ldsm_x4(r, row + swizzle<C>(kr, kp * 4 + (lane >> 3)) * 16);
            mma_bf16(sc[nb], qa[2 * kp], r[0], r[1]);
            mma_bf16(sc[nb], qa[2 * kp + 1], r[2], r[3]);
          }
        }
      }
      // 2. scale to log2 units, mask keys past the tile, online softmax;
      // element 2h + c of sc[nb] is head g + 8h, key j0 + 8nb + cq + c
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = sc[nb][2 * h + c];
            x = j0 + 8 * nb + cq + c < rows ? x * p.scale_log2 : -INFINITY;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[h], mx);  // key j0 is always in range
        const float alpha = weight(m[h], m_new);
        float sum = 0.f;
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = sc[nb][2 * h + c];
            x = exp2f(x - m_new);
            sum += x;
          }
        l[h] = l[h] * alpha + sum;
        m[h] = m_new;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          o[nb][2 * h] *= alpha;
          o[nb][2 * h + 1] *= alpha;
        }
      }
      // 3. P as A (the S fragment in place), hi and lo halves
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* x = &sc[i >> 1][2 * (i & 1)];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x[0], x[1]);
        const float2 hf = __bfloat1622float2(hi);
        ph[i] = *reinterpret_cast<const uint32_t*>(&hi);
        pl[i] = pack_bf16(x[0] - hf.x, x[1] - hf.y);
      }
      // 4. O += P V, V read transposed; two n8 blocks an ldmatrix
#pragma unroll
      for (int np = 0; np < NB / 2; ++np) {
        uint32_t r[4];
        const int vr = j0 + ((lane >> 3) & 1) * 8 + (lane & 7);
        ldsm_x4_t(r, v_s + vr * kRow + swizzle<C>(vr, np * 2 + (lane >> 4)) * 16);
        mma_bf16(o[2 * np], ph, r[0], r[1]);
        mma_bf16(o[2 * np], pl, r[0], r[1]);
        mma_bf16(o[2 * np + 1], ph, r[2], r[3]);
        mma_bf16(o[2 * np + 1], pl, r[2], r[3]);
      }
    }
    mbar_arrive(empty(s));  // this thread has read stage s
  }
  // the combine kernel may launch now; it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // Row sums over the quad, then the warps' states through the drained ring.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  float* red_m = reinterpret_cast<float*>(ring);
  float* red_l = red_m + kWarps * kMmaHeads;
  float* red_acc = red_l + kWarps * kMmaHeads;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int head = g + 8 * h, w = warp * kMmaHeads + head;
    if (head >= sp.gb) continue;
    if ((lane & 3) == 0) {
      red_m[w] = m[h];
      red_l[w] = l[h];
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      red_acc[w * HD + nb * 8 + cq] = o[nb][2 * h];
      red_acc[w * HD + nb * 8 + cq + 1] = o[nb][2 * h + 1];
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  merge_warps<__nv_bfloat16>(p, sp, kMmaHeads, red_m, red_l, red_acc);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The block's max (op = max) or sum of x; every thread gets it.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* red) {
  constexpr int kW = kCombineThreads / 32;
  x = kMax ? warp_max(x) : warp_sum(x);
  __syncthreads();  // red may still be read by a previous reduction
  if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float y = red[0];
#pragma unroll
  for (int w = 1; w < kW; ++w) y = kMax ? fmaxf(y, red[w]) : y + red[w];
  return y;
}

// out[bh, g] = sum_s 2^(m_s - M) acc_s / sum_s 2^(m_s - M) l_s over the
// splits s, one block a (bh, g) row; empty partials weigh 0. Launched as a
// programmatic dependent of the split kernel: its launch overlaps the split
// kernel's tail, and it waits for that grid's writes before reading them.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
    flash_decode_combine_kernel(const Params p) {
  __shared__ float red[kCombineThreads / 32];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int row = blockIdx.x;                 // bh * G + g
  const int bh = row / p.G, g = row - bh * p.G, n = p.n_split;
  const size_t part0 = static_cast<size_t>(bh) * n * p.G + g;
  const float* ml = p.part_ml;
  auto part = [&](int s) { return part0 + static_cast<size_t>(s) * p.G; };

  float x = -INFINITY;
  for (int s = threadIdx.x; s < n; s += kCombineThreads)
    x = fmaxf(x, ml[2 * part(s)]);
  const float M = block_reduce<true>(x, red);
  float y = 0.f;
  for (int s = threadIdx.x; s < n; s += kCombineThreads)
    y += ml[2 * part(s) + 1] * weight(ml[2 * part(s)], M);
  const float L = block_reduce<false>(y, red);
  const float inv = 1.f / (L == 0.f ? 1.f : L);
  if (p.lse && threadIdx.x == 0) p.lse[row] = log_sum_exp(M, L);

  constexpr int kBatch = 8;  // splits whose loads are in flight together
  for (int d = threadIdx.x; d < p.hd; d += kCombineThreads) {
    float A = 0.f;
    for (int s0 = 0; s0 < n; s0 += kBatch) {
      float a[kBatch], w[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const bool ok = s0 + i < n;
        w[i] = ok ? weight(ml[2 * part(s0 + i)], M) : 0.f;
        a[i] = ok ? p.part_acc[part(s0 + i) * p.hd + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) A = fmaf(a[i], w[i], A);
    }
    store_out<T>(p, static_cast<size_t>(row) * p.hd + d, A * inv);
  }
}

// Raise a kernel's dynamic shared-memory limit to the card's maximum once
// on each device (one bit a device in `set_on`), so a later launch, also
// under CUDA graph capture, makes no runtime call but cudaGetDevice.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, unsigned long long& set_on) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (set_on & bit) return cudaSuccess;
  int most = 0;
  e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           most);
  if (e == cudaSuccess) set_on |= bit;
  return e;
}

template <typename T, int LPR, int NC>
int launch_split(const Params& p, int BKV, size_t smem,
                 cudaStream_t stream) {
  auto kernel = flash_decode_split_kernel<T, LPR, NC>;
  static unsigned long long set_on = 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = allow_smem(kernel, set_on);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(BKV * p.n_hg, p.n_split), kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_mma(const Params& p, int BKV, size_t smem, cudaStream_t stream) {
  auto kernel = flash_decode_mma_kernel<HD>;
  static unsigned long long set_on = 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = allow_smem(kernel, set_on);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(BKV * p.n_hg, p.n_split), kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Params& p, int BKV, bool tensor_cores, size_t smem,
           cudaStream_t stream) {
  // 16-byte chunks a row: 1-32 in bf16, 2-64 in f32 (hd 8-256)
  const int chunks = p.hd * static_cast<int>(sizeof(T)) / 16;
  int err;
  if (tensor_cores) {
    if (p.hd == 16) err = launch_mma<16>(p, BKV, smem, stream);
    else if (p.hd == 32) err = launch_mma<32>(p, BKV, smem, stream);
    else if (p.hd == 64) err = launch_mma<64>(p, BKV, smem, stream);
    else err = launch_mma<128>(p, BKV, smem, stream);
  } else if constexpr (sizeof(T) == 2) {
    if (chunks <= 1) err = launch_split<T, 1, 1>(p, BKV, smem, stream);
    else if (chunks <= 2) err = launch_split<T, 2, 1>(p, BKV, smem, stream);
    else if (chunks <= 4) err = launch_split<T, 4, 1>(p, BKV, smem, stream);
    else if (chunks <= 8) err = launch_split<T, 8, 1>(p, BKV, smem, stream);
    else if (chunks <= 16) err = launch_split<T, 16, 1>(p, BKV, smem, stream);
    else err = launch_split<T, 32, 1>(p, BKV, smem, stream);
  } else {
    if (chunks <= 2) err = launch_split<T, 2, 1>(p, BKV, smem, stream);
    else if (chunks <= 4) err = launch_split<T, 4, 1>(p, BKV, smem, stream);
    else if (chunks <= 8) err = launch_split<T, 8, 1>(p, BKV, smem, stream);
    else if (chunks <= 16) err = launch_split<T, 16, 1>(p, BKV, smem, stream);
    else if (chunks <= 32) err = launch_split<T, 32, 1>(p, BKV, smem, stream);
    else err = launch_split<T, 32, 2>(p, BKV, smem, stream);
  }
  if (err != 0 || p.n_split == 1) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(BKV * p.G);
  cfg.blockDim = dim3(kCombineThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, flash_decode_combine_kernel<T>, p));
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, k, v, out: device pointers of
// contiguous tensors, 16-byte aligned; lse: null, or B * KV * G floats that
// take each row's log-sum-exp (natural log; -inf at length 0), and then out
// is f32 whatever q's type (the partial form); lengths may
// be 0 or past T (clamped to [0, T]); hd a multiple of 8 up to 256; bk >= 1;
// 1 <= stages <= 4; n_split >= 1, and with n_split > 1 part_ml and part_acc
// hold B * KV * n_split * G * 2 and * hd floats. tensor_cores = 1 takes the
// tensor-core kernel: bf16, hd 16, 32, 64 or 128, bk a multiple of 16.
// smem is a block's dynamic shared memory, as the wrapper's `smem_bytes`
// gives it for these (hd, bk, stages, route): the barriers, the ring, and
// the warps' states (past the ring on the CUDA cores, inside the drained
// ring on the tensor cores); the kernels lay out their regions from
// `stages`. Launches the split kernel and, when n_split > 1, the combine
// kernel on `stream`; returns the cudaError_t of the launches (0 on
// success). Does not synchronise and allocates nothing.
int flash_decode_launch(int dtype, const void* q, const void* k,
                        const void* v, const int* lengths, void* out,
                        float* lse, float* part_ml, float* part_acc, int B,
                        int KV, int G,
                        int T_len, int hd, int bk, int n_split, int stages,
                        int tensor_cores, long long smem, float scale_log2,
                        cudaStream_t stream) {
  if (B < 1 || KV < 1 || G < 1 || T_len < 1 || hd < 8 || hd > 256 ||
      hd % 8 || bk < 1 || n_split < 1 || n_split > 65535 || stages < 1 ||
      stages > kMaxStages || smem <= kBarBytes ||
      (n_split > 1 && (!part_ml || !part_acc)) ||
      (tensor_cores && (dtype != 1 || bk % 16 ||
                        (hd != 16 && hd != 32 && hd != 64 && hd != 128))))
    return static_cast<int>(cudaErrorInvalidValue);
  const int heads = tensor_cores ? kMmaHeads : kGB;
  const Params p{q,       k,  v, lengths, out,     lse,
                 part_ml, part_acc, KV, G, T_len, hd, bk, n_split,
                 (G + heads - 1) / heads, stages, scale_log2};
  const size_t bytes = static_cast<size_t>(smem);
  if (dtype == 0) return launch<float>(p, B * KV, false, bytes, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(p, B * KV, tensor_cores != 0, bytes,
                                 stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
