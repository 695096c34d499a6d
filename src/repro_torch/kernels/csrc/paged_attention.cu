// Paged decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py::
// paged_decode_attention: one-token GQA decode attention over the shared
// KV page pool [n_pages, PS, KH, D], read through a per-lane page table
// [B, P] and masked by the valid lengths lens [B].
//
// What bounds it: memory. Each K/V row of a KV head is read once for the
// G = H/KH query rows that share it, 4*G flops per element read (G <= 8),
// far below the ~295 flop/byte at which an H100 stops being memory-bound.
// The least traffic is the KV the lanes need, sum_b len_b * KH * D * 2 *
// itemsize bytes, plus q, out and the tables: a few microseconds at the
// serving shapes, so what has to be beaten is latency, with enough bytes
// in flight on every SM.
//
// What the design does about it:
//   * split-KV: grid (n_splits, KH, B). Each split is a whole number of
//     pages (and at least one tile) of its lane's table; the wrapper picks
//     n_splits on the host from B, KH, the table width and the SM count
//     (never from lens, which live on the card), so a batch of 1 still
//     puts tens of blocks per KV head on the 132 SMs. A split that starts
//     past its lane's length writes the empty partial and returns;
//   * the split's page ids go to shared memory once; each tile's K and V
//     page slices (PS rows of D contiguous elements at a row stride of
//     KH*D, the pool read in place: no gathered or transposed copy) are
//     copied with cp.async, 16 bytes a thread, into a ring of kStages
//     tiles, so the next tiles' pages are in flight while this one
//     computes. A stage is 16 KB of K and V whatever (dtype, D): 64 tokens
//     at bf16 D 64, 16 at f32 D 128;
//   * lanes of a warp split the head dim: a group of D / (16 B) lanes
//     holds one token's K row, each lane 16 bytes of it and the matching
//     slice of all G query rows in registers, so every K/V row read from
//     shared memory serves the G rows. Scores are summed across the group
//     with shuffles; the softmax state (max, sum, acc slice) is kept per
//     lane group in registers and rescaled once per tile, so a tile costs
//     one block barrier (the pipeline's). The groups and the 4 warps are
//     merged once, at the end of the split;
//   * V is read as 16-byte vectors from shared memory;
//   * n_splits 1: the block normalises and writes [G, D] in q's dtype (one
//     launch). n_splits > 1: f32 partials (acc [B, KH, n_splits, G, D],
//     m, l) and repro::lse_merge_kernel (two launches).
// Not done yet (later work): tensor-core products for G 8, and persistent
// blocks (the grid is still one wave of ragged splits).
#include "attention.cuh"

namespace {

using repro::store;
using repro::to_f32;

constexpr int kThreads = 128;       // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;          // tiles in the cp.async ring
constexpr int kSteps = 4;           // tokens a lane group takes per tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Tile geometry of one (T, D) instantiation.
template <typename T, int D>
struct PagedCfg {
  static constexpr int kVec = repro::Vec<T>::n;  // elements per 16 bytes
  static constexpr int L = D / kVec;             // lanes holding one K row
  static constexpr int NTW = 32 / L;             // tokens a warp takes at once
  static constexpr int TT = kWarps * kSteps * NTW;  // tokens per tile
  static constexpr int kChunks = TT * L;            // 16-byte chunks of K
  static constexpr size_t stage_bytes = 2 * (size_t)TT * D * sizeof(T);
  static_assert(L >= 1 && L <= 32 && 32 % L == 0, "unsupported head width");
  static_assert(kChunks % kThreads == 0, "whole chunks per thread");
  static size_t smem_bytes(int pages_per_split) {
    return kStages * stage_bytes + sizeof(int) * (size_t)pages_per_split;
  }
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

// grid (n_splits, KH, B), block kThreads, dynamic shared memory
// PagedCfg::smem_bytes(pps). Split si covers pages [si*pps, (si+1)*pps) of
// lane b's table. acc_out == nullptr: write out (n_splits 1); else write
// the split's partial to slot si of [B, KH, n_splits, G, (D)].
template <typename T, int G, int D>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                   const T* __restrict__ v_pages,
                   const int32_t* __restrict__ page_table,
                   const int32_t* __restrict__ lens, T* __restrict__ out,
                   float* __restrict__ acc_out, float* __restrict__ m_out,
                   float* __restrict__ l_out, int H, int KH, int P, int PS,
                   int n_pages, int pps, float scale_log2) {
  using C = PagedCfg<T, D>;
  constexpr int kVec = C::kVec, L = C::L, NTW = C::NTW, TT = C::TT;
  extern __shared__ uint4 smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);  // kStages x {K, V} [TT][D]
  int* page_s = reinterpret_cast<int*>(
      reinterpret_cast<char*>(smem_raw) + kStages * C::stage_bytes);

  const int si = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane / L, c = lane % L;  // token group, 16-byte chunk

  int len = lens[b];
  len = len < 0 ? 0 : (len > P * PS ? P * PS : len);
  const int t_begin = si * pps * PS;
  const int t_end = min(t_begin + pps * PS, len);
  const size_t row0 = (((size_t)b * KH + h) * n_splits + si) * G;

  if (t_begin >= t_end) {  // nothing of this lane here
    if (acc_out == nullptr) {  // len 0: 0, as the TPU kernel
      T* ob = out + ((size_t)b * H + (size_t)h * G) * D;
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

  const int first_page = si * pps;
  const int n_pg = min(pps, (t_end - t_begin + PS - 1) / PS);
  for (int i = tid; i < n_pg; i += kThreads) {
    int page = page_table[(size_t)b * P + first_page + i];
    page_s[i] = page < 0 ? 0 : (page >= n_pages ? n_pages - 1 : page);
  }

  // this lane's slice of the G query rows, scaled to base-2 logits
  float qf[G][kVec];
  const T* qb = q + ((size_t)b * H + (size_t)h * G) * D + c * kVec;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    repro::load16(qb + (size_t)g * D, qf[g]);
#pragma unroll
    for (int e = 0; e < kVec; ++e) qf[g][e] *= scale_log2;
  }
  __syncthreads();  // page_s

  const size_t row_stride = (size_t)KH * D;  // one slot of a page
  const size_t page_stride = (size_t)PS * row_stride;
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
        size_t off = 0;
        if (valid)
          off = (size_t)page_s[pos / PS - first_page] * page_stride +
                (size_t)(pos % PS) * row_stride + (size_t)h * D + cc * kVec;
        cp_async16(ks + tt * D + cc * kVec, k_pages + off, valid);
        cp_async16(vs + tt * D + cc * kVec, v_pages + off, valid);
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
      repro::load16(ks + tt * D + c * kVec, kf);
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
      repro::load16(vs + tt * D + c * kVec, vf);  // zeros past t_end
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
  static_assert(sizeof(float) * kWarps * G * (D + 2) <=
                    kStages * PagedCfg<T, D>::stage_bytes,
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
}

template <typename T, int G, int D>
cudaError_t launch_gd(const void* q, const void* k, const void* v,
                      const int32_t* pt, const int32_t* lens, void* out,
                      float* acc, float* m, float* l, int B, int H, int KH,
                      int P, int PS, int n_pages, int n_splits, int pps,
                      cudaStream_t stream) {
  auto* kernel = &paged_split_kernel<T, G, D>;
  const size_t smem = PagedCfg<T, D>::smem_bytes(pps);
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_splits, KH, B);
  const bool direct = n_splits == 1;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pt, lens, static_cast<T*>(out),
      direct ? nullptr : acc, m, l, H, KH, P, PS, n_pages, pps,
      repro::inv_sqrt(D) * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess || direct) return err;
  return repro::launch_lse_merge<T>(acc, m, l, B * H, G, n_splits, D,
                                    static_cast<T*>(out), nullptr, nullptr,
                                    nullptr, stream);
}

// Functors for dispatch (a local class may not have member templates).
struct LaunchFn {
  const void *q, *k, *v, *pt, *lens;
  void* out;
  float *acc, *m, *l;
  int B, H, KH, P, PS, n_pages, n_splits, pps;
  cudaStream_t stream;
  cudaError_t* err;
  template <typename T, int G, int D>
  void operator()() const {
    *err = launch_gd<T, G, D>(q, k, v, static_cast<const int32_t*>(pt),
                              static_cast<const int32_t*>(lens), out, acc, m,
                              l, B, H, KH, P, PS, n_pages, n_splits, pps,
                              stream);
  }
};

struct QueryFn {
  int pps;
  int *blocks, *regs, *smem, *tile;
  cudaError_t* err;
  template <typename T, int G, int D>
  void operator()() const {
    *tile = PagedCfg<T, D>::TT;
    *err = repro::occupancy(&paged_split_kernel<T, G, D>, kThreads,
                            PagedCfg<T, D>::smem_bytes(pps), blocks, regs,
                            smem);
  }
};

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. All tensors contiguous:
// q/out [B, H, D]; k/v pages [n_pages, PS, KH, D]; page_table [B, P] int32;
// lens [B] int32. Split si covers pages [si * pps, (si + 1) * pps) of each
// row; n_splits * pps >= P. With n_splits > 1, acc [B, KH, n_splits, G, D]
// and m, l [B, KH, n_splits, G] are f32 scratch (unused when n_splits is
// 1). Returns the cudaError_t of the launches (0 = success);
// cudaErrorInvalidValue when (dtype, G, D) has no instantiation.
int repro_paged_decode_attention(const void* q, const void* k_pages,
                                 const void* v_pages, const void* page_table,
                                 const void* lens, void* out, void* acc,
                                 void* m, void* l, int B, int H, int KH, int D,
                                 int P, int PS, int n_pages, int n_splits,
                                 int pps, int dtype, void* stream) {
  if (B <= 0 || KH <= 0 || H % KH != 0 || P <= 0 || PS <= 0 || n_pages <= 0 ||
      n_splits <= 0 || pps <= 0 || (long long)n_splits * pps < P ||
      (n_splits > 1 && (acc == nullptr || m == nullptr || l == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  const LaunchFn f{q, k_pages, v_pages, page_table, lens, out,
                   static_cast<float*>(acc), static_cast<float*>(m),
                   static_cast<float*>(l), B, H, KH, P, PS, n_pages,
                   n_splits, pps, static_cast<cudaStream_t>(stream), &err};
  if (!repro::dispatch_dtype_gd(dtype, H / KH, D, f))
    return (int)cudaErrorInvalidValue;
  return (int)err;
}

// Occupancy of one (dtype, G, D) instantiation with pps pages a split on
// the current device: resident blocks per SM, registers per thread, shared
// bytes (dynamic), tokens per tile.
int repro_paged_decode_occupancy(int dtype, int G, int D, int pps,
                                 int* blocks_per_sm, int* regs,
                                 int* smem_bytes, int* tile) {
  cudaError_t err = cudaSuccess;
  const QueryFn f{pps, blocks_per_sm, regs, smem_bytes, tile, &err};
  if (!repro::dispatch_dtype_gd(dtype, G, D, f))
    return (int)cudaErrorInvalidValue;
  return (int)err;
}

}  // extern "C"
