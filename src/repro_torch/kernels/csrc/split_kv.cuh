// The split-KV decode body shared by paged decode, dense (split-K) decode
// and the per-request suffix of shared-prefix decode.
//
// One block of 4 warps takes the G query rows of one (lane, KV head)
// against one split [t_begin, t_end) of that lane's keys. Where a key's
// K/V rows live is the caller's row-address policy `Rows`:
//   * PagedRows (paged_attention.cu): the split's page ids go to shared
//     memory once; a position is (page, slot) of the pool [n_pages, PS,
//     KH, D];
//   * DenseRows (below): base + b * sb + h * sh + pos * ss, so the
//     head-major [B, KH, S, D] cache and a transposed view of the model
//     layout [B, S, KH, D] are read in place, with no copy.
//
// What bounds it: memory. Each K/V row of a KV head is read once for the
// G = H / KH query rows that share it, 4 * G flops per element read
// (G <= 8), far below the H100's ~295 flop/byte ridge. The least traffic
// is the valid KV bytes plus q and out, a few to a few tens of
// microseconds at the shapes served, so what has to be beaten is
// latency, with enough bytes in flight on every SM.
//
// What the design does about it:
//   * the tile's K and V rows (16 KB whatever (dtype, D): 64 tokens at
//     bf16 D 64, 32 at bf16 D 128) are copied with cp.async, 16 bytes a
//     thread, into a ring of kStages tiles, so the next tiles are in
//     flight while this one computes; positions past the split's end
//     are zero-filled and never read;
//   * lanes of a warp split the head dim: a group of D / (16 B) lanes
//     holds one token's K row, each lane 16 bytes of it and the matching
//     slice of all G query rows in registers (no shared-memory load per
//     FMA). Scores are summed across the group with shuffles; the softmax
//     state (base-2 max with the scale folded in, sum, acc slice) is kept
//     per lane group and rescaled once a tile, so a tile costs one block
//     barrier (the pipeline's). Groups and warps merge once a split;
//   * V is read as 16-byte vectors from shared memory;
//   * a split that starts past its lane's length takes no tile; it
//     writes the empty partial (acc 0, m -inf, l 0) unless merged in the
//     launch (below). With acc_out == nullptr (one split a row) the block
//     normalises and writes q's dtype; otherwise it writes its f32
//     partial (m as a natural-log max) to slot slot0 + split of [B, KH,
//     n_slots, G, (D)];
//   * with counters (paged and dense decode with more than one split) the
//     splits of a (lane, head) merge themselves, in the one launch: each
//     block that holds a key, having written its partial, passes a block
//     barrier, and its thread 0 fences and bumps the (lane, head)'s
//     arrival counter; the block that arrives last of the lane's
//     non-empty splits merges their slots for its G rows, one warp a row
//     (merge_row of attention.cuh, the standalone merge's routine, slots
//     in index order, so the result does not depend on which block came
//     last and equals the partials merged by lse_merge_kernel bit for
//     bit: an empty slot adds exact zeros there), writes q's dtype and
//     sets the counter back to 0 for the next launch. A merge is latency
//     and a launch, not bytes (attention.cuh): here it costs no launch,
//     and its loads overlap the other blocks' splits. What it costs
//     instead is the fence: a block's slot is held until its partial has
//     reached L2, which under a saturated memory system is microseconds,
//     so empty splits (past their lane's end) write nothing and skip it;
//     a lane of len 0 gets 0 from its first split. Without counters the
//     partials, empty ones included, stay for a merge elsewhere: the slot
//     shards of a tensor-parallel pool, the suffix of shared-prefix
//     decode.
// Not done yet (later work): bulk (TMA) copies into a deeper ring, since
// the copies, not the products, set the time (see decode_attention.cu);
// persistent blocks that take splits from a queue.
#pragma once

#include "attention.cuh"

namespace repro {
namespace skv {

constexpr int kThreads = 128;       // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;          // tiles in the cp.async ring
constexpr int kSteps = 4;           // tokens a lane group takes per tile

// Tile geometry of one (T, D) instantiation.
template <typename T, int D>
struct Cfg {
  static constexpr int kVec = Vec<T>::n;         // elements per 16 bytes
  static constexpr int L = D / kVec;             // lanes holding one K row
  static constexpr int NTW = 32 / L;             // tokens a warp takes at once
  static constexpr int TT = kWarps * kSteps * NTW;  // tokens per tile
  static constexpr int kChunks = TT * L;            // 16-byte chunks of K
  static constexpr size_t stage_bytes = 2 * (size_t)TT * D * sizeof(T);
  static constexpr size_t ring_bytes = kStages * stage_bytes;
  static_assert(L >= 1 && L <= 32 && 32 % L == 0, "unsupported head width");
  static_assert(kChunks % kThreads == 0, "whole chunks per thread");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Combine the running state (m, l, acc) with another one (base-2 maxima).
template <int G, int V>
__device__ __forceinline__ void combine(float (&m)[G], float (&l)[G],
                                        float (&acc)[G][V],
                                        const float (&mo)[G],
                                        const float (&lo)[G],
                                        const float (&acco)[G][V]) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float mn = fmaxf(m[g], mo[g]);
    const float ms = mn == -INFINITY ? 0.f : mn;
    const float a = exp2f(m[g] - ms), b = exp2f(mo[g] - ms);  // -inf: 0
    l[g] = l[g] * a + lo[g] * b;
#pragma unroll
    for (int e = 0; e < V; ++e) acc[g][e] = acc[g][e] * a + acco[g][e] * b;
    m[g] = mn;
  }
}

// Dense rows: K/V row of (lane b, head h, position pos) at element offset
// b * sb + h * sh + pos * ss of k and v (which share their strides).
template <typename T>
struct DenseRows {
  const T* k;
  const T* v;
  long long sb, sh, ss;
  long long base;
  __device__ void begin(int b, int h, int, int, int, void*) {
    base = b * sb + h * sh;
  }
  __device__ long long offset(int pos) const { return base + pos * ss; }
};

// The end of a split block whose (lane b, head h) has counters: its
// partial is written; the block that arrives last of the lane's n_valid
// splits that hold a key merges their slots into out (q's dtype), one
// warp a row (empty splits weigh exactly 0 in a merge, so they neither
// write nor arrive). All threads of the block call it. The barrier puts
// every thread's partial before thread 0's fence and atomic, as a
// grid-wide sync does: one fence a block, not one a thread. Shared
// memory: one int at smem_raw, free by then (the ring is drained and the
// warp merge's reads are behind the barrier).
template <typename T, int G, int D>
__device__ __forceinline__ void arrive_and_merge(
    int* __restrict__ counters, const float* acc, const float* m,
    const float* l, T* __restrict__ out, int b, int h, int H, int KH,
    int n_slots, int n_valid, uint4* smem_raw) {
  int* last = reinterpret_cast<int*>(smem_raw);
  __syncthreads();
  if (threadIdx.x == 0) {
    int* c = counters + (size_t)b * KH + h;
    __threadfence();  // the block's partial before the arrival
    const bool is_last = atomicAdd(c, 1) == n_valid - 1;
    if (is_last) *c = 0;  // every split has arrived: clean for the next call
    __threadfence();  // the others' partials after the arrival
    *last = is_last;
  }
  __syncthreads();
  if (!*last) return;
  const size_t row0 = ((size_t)b * KH + h) * n_slots * G;
  const size_t orow0 = (size_t)b * H + (size_t)h * G;
  for (int g = threadIdx.x >> 5; g < G; g += kWarps)
    merge_row<T, D>(acc, m, l, row0 + g, G, n_valid, out, nullptr, nullptr,
                    nullptr, orow0 + g);
}

// The split-KV body; see the header. Grid (splits, KH, B), kThreads
// threads, dynamic shared memory Cfg::ring_bytes plus what rows.begin
// keeps after the ring. Split si covers [si * split_len, (si + 1) *
// split_len) of lane b's [0, min(lens[b], max_len)).
template <typename T, int G, int D, typename Rows>
__device__ __forceinline__ void split_kv(
    Rows rows, const T* __restrict__ q, const int32_t* __restrict__ lens,
    T* __restrict__ out, float* __restrict__ acc_out,
    float* __restrict__ m_out, float* __restrict__ l_out,
    int* __restrict__ counters, int H, int KH, int max_len, int split_len,
    int n_slots, int slot0, float scale_log2, uint4* smem_raw) {
  using C = Cfg<T, D>;
  constexpr int kVec = C::kVec, L = C::L, NTW = C::NTW, TT = C::TT;
  T* ring = reinterpret_cast<T*>(smem_raw);  // kStages x {K, V} [TT][D]

  const int si = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane / L, c = lane % L;  // token group, 16-byte chunk

  int len = lens[b];
  len = len < 0 ? 0 : (len > max_len ? max_len : len);
  const int t_begin = si * split_len;
  const int t_end = min(t_begin + split_len, len);
  const size_t row0 = (((size_t)b * KH + h) * n_slots + slot0 + si) * G;

  const int n_valid = (len + split_len - 1) / split_len;  // splits with keys

  if (t_begin >= t_end) {  // nothing of this lane here
    if (acc_out == nullptr || counters != nullptr) {
      // one split, or merged here (empty splits are skipped): a lane of
      // len 0 gets 0 from its first split, as from the TPU kernels
      T* ob = out + ((size_t)b * H + (size_t)h * G) * D;
      if (si == 0)
        for (int i = tid; i < G * D; i += kThreads) store(ob + i, 0.f);
    } else {
      for (int i = tid; i < G * D; i += kThreads) acc_out[row0 * D + i] = 0.f;
      if (tid < G) {
        m_out[row0 + tid] = -INFINITY;
        l_out[row0 + tid] = 0.f;
      }
    }
    return;
  }
  rows.begin(b, h, t_begin, t_end, tid,
             reinterpret_cast<char*>(smem_raw) + C::ring_bytes);

  // this lane's slice of the G query rows, scaled to base-2 logits
  float qf[G][kVec];
  const T* qb = q + ((size_t)b * H + (size_t)h * G) * D + c * kVec;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load16(qb + (size_t)g * D, qf[g]);
#pragma unroll
    for (int e = 0; e < kVec; ++e) qf[g][e] *= scale_log2;
  }
  __syncthreads();  // what rows.begin put in shared memory

  const int n_tiles = (t_end - t_begin + TT - 1) / TT;

  auto issue = [&](int tile) {
    if (tile < n_tiles) {
      T* ks = ring + (size_t)(tile % kStages) * (2 * TT * D);
      T* vs = ks + TT * D;
      const int t0 = t_begin + tile * TT;
#pragma unroll
      for (int r = 0; r < C::kChunks / kThreads; ++r) {
        const int idx = tid + r * kThreads;
        const int tt = idx / L, cc = idx % L;
        const int pos = t0 + tt;
        const bool valid = pos < t_end;
        const long long off = (valid ? rows.offset(pos) : 0) + cc * kVec;
        cp_async16(ks + tt * D + cc * kVec, rows.k + off, valid);
        cp_async16(vs + tt * D + cc * kVec, rows.v + off, valid);
      }
    }
    cp_async_commit();  // an empty group keeps the count uniform
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  float m[G], l[G], acc[G][kVec];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[g][e] = 0.f;
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this tile landed; the slot refilled below is free
    issue(tile + kStages - 1);
    const T* ks = ring + (size_t)(tile % kStages) * (2 * TT * D);
    const T* vs = ks + TT * D;
    const int t0 = t_begin + tile * TT;

    float s[kSteps][G];
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      const int tt = warp * (kSteps * NTW) + st * NTW + grp;
      float kf[kVec];
      load16(ks + tt * D + c * kVec, kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) x = fmaf(qf[g][e], kf[e], x);
#pragma unroll
        for (int o = L / 2; o > 0; o >>= 1)
          x += __shfl_xor_sync(0xffffffffu, x, o);
        s[st][g] = t0 + tt < t_end ? x : -INFINITY;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = s[0][g];
#pragma unroll
      for (int st = 1; st < kSteps; ++st) mx = fmaxf(mx, s[st][g]);
      const float mn = fmaxf(m[g], mx);
      const float ms = mn == -INFINITY ? 0.f : mn;
      const float corr = exp2f(m[g] - ms);  // m -inf: 0
      float sum = 0.f;
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        s[st][g] = exp2f(s[st][g] - ms);  // masked: 0
        sum += s[st][g];
      }
      l[g] = l[g] * corr + sum;
      m[g] = mn;
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[g][e] *= corr;
    }
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      const int tt = warp * (kSteps * NTW) + st * NTW + grp;
      float vf[kVec];
      load16(vs + tt * D + c * kVec, vf);  // zeros past t_end
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          acc[g][e] = fmaf(s[st][g], vf[e], acc[g][e]);
    }
  }

  // merge the token groups of the warp (lanes with the same chunk c)
#pragma unroll
  for (int o = L; o < 32; o <<= 1) {
    float mo[G], lo[G], ao[G][kVec];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      mo[g] = __shfl_xor_sync(0xffffffffu, m[g], o);
      lo[g] = __shfl_xor_sync(0xffffffffu, l[g], o);
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        ao[g][e] = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
    }
    combine<G, kVec>(m, l, acc, mo, lo, ao);
  }

  // then the warps, through shared memory (the ring is drained)
  cp_async_wait<0>();
  __syncthreads();
  float* acc_s = reinterpret_cast<float*>(smem_raw);  // [kWarps][G][D]
  float* m_s = acc_s + kWarps * G * D;                // [kWarps][G]
  float* l_s = m_s + kWarps * G;
  static_assert(sizeof(float) * kWarps * G * (D + 2) <= C::ring_bytes,
                "warp merge must fit in the ring");
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        acc_s[(warp * G + g) * D + c * kVec + e] = acc[g][e];
      if (c == 0) {
        m_s[warp * G + g] = m[g];
        l_s[warp * G + g] = l[g];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w * G + g]);
    const float ms = mx == -INFINITY ? 0.f : mx;
    float lt = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2f(m_s[w * G + g] - ms);
      lt += l_s[w * G + g] * wt;
      o += acc_s[(w * G + g) * D + i % D] * wt;
    }
    if (acc_out == nullptr) {
      T* ob = out + ((size_t)b * H + (size_t)h * G) * D;
      store(ob + i, lt > 0.f ? o / lt : 0.f);
    } else {
      acc_out[row0 * D + i] = o;
      if (i % D == 0) {
        m_out[row0 + g] = mx == -INFINITY ? mx : mx * kLn2;  // natural log
        l_out[row0 + g] = lt;
      }
    }
  }
  if (counters != nullptr)
    arrive_and_merge<T, G, D>(counters, acc_out, m_out, l_out, out, b, h, H,
                              KH, n_slots, n_valid, smem_raw);
}

// Split-KV over dense strided rows: grid (splits, KH, B), split si into
// slot slot0 + si of n_slots (acc == nullptr: one split, out written;
// counters: the last split of each (lane, head) merges into out).
template <typename T, int G, int D>
__global__ void __launch_bounds__(kThreads)
dense_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int32_t* __restrict__ lens,
                   T* __restrict__ out, float* __restrict__ acc,
                   float* __restrict__ m, float* __restrict__ l,
                   int* __restrict__ counters, int H, int KH, int S,
                   int split_len, int n_slots, int slot0, long long sb,
                   long long sh, long long ss, float scale_log2) {
  extern __shared__ uint4 smem_raw[];
  const DenseRows<T> rows{k, v, sb, sh, ss, 0};
  split_kv<T, G, D>(rows, q, lens, out, acc, m, l, counters, H, KH, S,
                    split_len, n_slots, slot0, scale_log2, smem_raw);
}

// Launch dense_split_kernel (acc == nullptr: n_split must be 1; counters
// [B * KH] at 0: n_slots == n_split and slot0 0, out receives the merge).
template <typename T, int G, int D>
cudaError_t launch_dense_split(const void* q, const void* k, const void* v,
                               const void* lens, void* out, float* acc,
                               float* m, float* l, int* counters, int B,
                               int H, int KH, int S, int n_split,
                               int split_len, int n_slots, int slot0,
                               long long sb, long long sh, long long ss,
                               cudaStream_t stream) {
  auto* kernel = &dense_split_kernel<T, G, D>;
  const size_t smem = Cfg<T, D>::ring_bytes;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_split, KH, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(lens),
      static_cast<T*>(out), acc, m, l, counters, H, KH, S, split_len,
      n_slots, slot0, sb, sh, ss, inv_sqrt(D) * kLog2e);
  return cudaGetLastError();
}

}  // namespace skv
}  // namespace repro
