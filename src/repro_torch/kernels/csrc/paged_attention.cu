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
//     past its lane's length takes no tile (and, merged in the launch,
//     writes nothing);
//   * the split body is the one of split_kv.cuh (shared with the dense
//     decode and the suffix of shared-prefix decode; its header says how
//     it stages tiles and keeps the softmax state). Here the row-address
//     policy PagedRows puts the split's page ids in shared memory once,
//     and each token's K/V row is read in place from its page (PS rows of
//     D contiguous elements at a row stride of KH * D): no gathered or
//     transposed copy of the pool;
//   * n_splits 1: the block normalises and writes [G, D] in q's dtype.
//     n_splits > 1: each split that holds a key writes its f32 partial
//     (acc [B, KH, n_splits, G, D], m, l) and the last of them to arrive
//     merges the (lane, KV head)'s partials into [G, D] in q's dtype
//     (split_kv.cuh: an arrival counter per (lane, head) in a workspace
//     the wrapper keeps at 0 between calls). One launch a call either
//     way: the merge is a chain of dependent loads and, as a kernel of
//     its own, a launch, not bytes (attention.cuh); as the last block's
//     tail it costs no launch and overlaps the splits still running, and
//     each split that holds a key pays one fence instead;
//   * the partials entry (repro_paged_decode_partials) passes no counters
//     and returns every split's f32 partial, whatever n_splits: a slot
//     shard of a tensor-parallel pool holds PS/tp slots of every page, so
//     its lane's valid tokens are a prefix of its own pages of PS/tp
//     slots, and the shards' partials are merged together by one launch
//     of the standalone lse_merge_kernel (repro_lse_merge, one warp a
//     row), distributed flash-decoding over the slot shards. A shard whose
//     prefix is empty (len 0) writes the empty partial (acc 0, m -inf,
//     l 0), which weighs nothing there.
// Not done yet (later work): tensor-core products for G 8, and persistent
// blocks (the grid is still one wave of ragged splits).
#include "attention.cuh"
#include "split_kv.cuh"

namespace {

namespace skv = repro::skv;

// Paged rows: the split's page ids, clamped into the pool, in shared
// memory (after the ring); position pos is slot pos % PS of page
// page_s[pos / PS - first_page].
template <typename T>
struct PagedRows {
  const T* k;
  const T* v;
  const int32_t* table;
  int P, PS, n_pages, KH, D;
  int* page_s;
  int first_page;
  long long head;
  __device__ void begin(int b, int h, int t_begin, int t_end, int tid,
                        void* extra) {
    page_s = static_cast<int*>(extra);
    first_page = t_begin / PS;
    head = (long long)h * D;
    const int n_pg = (t_end - t_begin + PS - 1) / PS;
    for (int i = tid; i < n_pg; i += skv::kThreads) {
      const int page = table[(size_t)b * P + first_page + i];
      page_s[i] = page < 0 ? 0 : (page >= n_pages ? n_pages - 1 : page);
    }
  }
  __device__ long long offset(int pos) const {
    return ((long long)page_s[pos / PS - first_page] * PS + pos % PS) *
               ((long long)KH * D) + head;
  }
};

template <typename T, int D>
size_t smem_bytes(int pps) {
  return skv::Cfg<T, D>::ring_bytes + sizeof(int) * (size_t)pps;
}

// grid (n_splits, KH, B), block skv::kThreads, dynamic shared memory
// smem_bytes(pps). Split si covers pages [si*pps, (si+1)*pps) of lane b's
// table. acc_out == nullptr: write out (n_splits 1); else write the
// split's partial to slot si of [B, KH, n_splits, G, (D)] and, with
// counters, let the last split of each (lane, head) merge into out.
template <typename T, int G, int D>
__global__ void __launch_bounds__(skv::kThreads)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                   const T* __restrict__ v_pages,
                   const int32_t* __restrict__ page_table,
                   const int32_t* __restrict__ lens, T* __restrict__ out,
                   float* __restrict__ acc_out, float* __restrict__ m_out,
                   float* __restrict__ l_out, int* __restrict__ counters,
                   int H, int KH, int P, int PS, int n_pages, int pps,
                   float scale_log2) {
  extern __shared__ uint4 smem_raw[];
  const PagedRows<T> rows{k_pages, v_pages, page_table, P, PS, n_pages, KH,
                          D, nullptr, 0, 0};
  skv::split_kv<T, G, D>(rows, q, lens, out, acc_out, m_out, l_out, counters,
                         H, KH, P * PS, pps * PS, gridDim.x, 0, scale_log2,
                         smem_raw);
}

// One launch: n_splits 1 writes out directly; more split blocks write
// partials and, unless partials (the partials entry), merge them into out
// through counters.
template <typename T, int G, int D>
cudaError_t launch_gd(const void* q, const void* k, const void* v,
                      const int32_t* pt, const int32_t* lens, void* out,
                      float* acc, float* m, float* l, int* counters, int B,
                      int H, int KH, int P, int PS, int n_pages, int n_splits,
                      int pps, bool partials, cudaStream_t stream) {
  auto* kernel = &paged_split_kernel<T, G, D>;
  const size_t smem = smem_bytes<T, D>(pps);
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_splits, KH, B);
  const bool direct = n_splits == 1 && !partials;
  kernel<<<grid, skv::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pt, lens, static_cast<T*>(out),
      direct ? nullptr : acc, m, l, direct || partials ? nullptr : counters,
      H, KH, P, PS, n_pages, pps, repro::inv_sqrt(D) * repro::kLog2e);
  return cudaGetLastError();
}

// Functors for dispatch (a local class may not have member templates).
struct LaunchFn {
  const void *q, *k, *v, *pt, *lens;
  void* out;
  float *acc, *m, *l;
  int* counters;
  int B, H, KH, P, PS, n_pages, n_splits, pps;
  bool partials;
  cudaStream_t stream;
  cudaError_t* err;
  template <typename T, int G, int D>
  void operator()() const {
    *err = launch_gd<T, G, D>(q, k, v, static_cast<const int32_t*>(pt),
                              static_cast<const int32_t*>(lens), out, acc, m,
                              l, counters, B, H, KH, P, PS, n_pages, n_splits,
                              pps, partials, stream);
  }
};

struct QueryFn {
  int pps;
  int *blocks, *regs, *smem, *tile;
  cudaError_t* err;
  template <typename T, int G, int D>
  void operator()() const {
    *tile = skv::Cfg<T, D>::TT;
    *err = repro::occupancy(&paged_split_kernel<T, G, D>, skv::kThreads,
                            smem_bytes<T, D>(pps), blocks, regs, smem);
  }
};

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. All tensors contiguous:
// q/out [B, H, D]; k/v pages [n_pages, PS, KH, D]; page_table [B, P] int32;
// lens [B] int32. Split si covers pages [si * pps, (si + 1) * pps) of each
// row; n_splits * pps >= P. With n_splits > 1, acc [B, KH, n_splits, G, D]
// and m, l [B, KH, n_splits, G] are f32 scratch, and counters [B * KH]
// int32 are 0 on entry and left at 0 by the launch (all unused when
// n_splits is 1). One launch. Returns its cudaError_t (0 = success);
// cudaErrorInvalidValue when (dtype, G, D) has no instantiation.
int repro_paged_decode_attention(const void* q, const void* k_pages,
                                 const void* v_pages, const void* page_table,
                                 const void* lens, void* out, void* acc,
                                 void* m, void* l, void* counters, int B,
                                 int H, int KH, int D, int P, int PS,
                                 int n_pages, int n_splits, int pps,
                                 int dtype, void* stream) {
  if (B <= 0 || KH <= 0 || H % KH != 0 || P <= 0 || PS <= 0 || n_pages <= 0 ||
      n_splits <= 0 || pps <= 0 || (long long)n_splits * pps < P ||
      (n_splits > 1 && (acc == nullptr || m == nullptr || l == nullptr ||
                        counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  const LaunchFn f{q, k_pages, v_pages, page_table, lens, out,
                   static_cast<float*>(acc), static_cast<float*>(m),
                   static_cast<float*>(l), static_cast<int*>(counters), B, H,
                   KH, P, PS, n_pages, n_splits, pps, false,
                   static_cast<cudaStream_t>(stream), &err};
  if (!repro::dispatch_dtype_gd(dtype, H / KH, D, f))
    return (int)cudaErrorInvalidValue;
  return (int)err;
}

// The split kernel alone, for any n_splits: every split's f32 partial in
// acc [B, KH, n_splits, G, D], m and l [B, KH, n_splits, G] (m in natural
// log units; an empty split: acc 0, m -inf, l 0). Same arguments as
// repro_paged_decode_attention without out.
int repro_paged_decode_partials(const void* q, const void* k_pages,
                                const void* v_pages, const void* page_table,
                                const void* lens, void* acc, void* m, void* l,
                                int B, int H, int KH, int D, int P, int PS,
                                int n_pages, int n_splits, int pps, int dtype,
                                void* stream) {
  if (B <= 0 || KH <= 0 || H % KH != 0 || P <= 0 || PS <= 0 || n_pages <= 0 ||
      n_splits <= 0 || pps <= 0 || (long long)n_splits * pps < P ||
      acc == nullptr || m == nullptr || l == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  const LaunchFn f{q, k_pages, v_pages, page_table, lens, nullptr,
                   static_cast<float*>(acc), static_cast<float*>(m),
                   static_cast<float*>(l), nullptr, B, H, KH, P, PS, n_pages,
                   n_splits, pps, true, static_cast<cudaStream_t>(stream),
                   &err};
  if (!repro::dispatch_dtype_gd(dtype, H / KH, D, f))
    return (int)cudaErrorInvalidValue;
  return (int)err;
}

// One launch of repro::lse_merge_kernel (one warp a row) over f32
// partials acc [R, n_slots, G, D], m and l [R, n_slots, G] (R = rows / G;
// acc 16-byte aligned): out [rows, D] in dtype, the normalised merge of
// every row's slots (0 where all are empty). cudaErrorInvalidValue for a
// D other than 16, 32, 64 or 128.
int repro_lse_merge(const void* acc, const void* m, const void* l, void* out,
                    int rows, int G, int n_slots, int D, int dtype,
                    void* stream) {
  if (rows <= 0 || G <= 0 || rows % G != 0 || n_slots <= 0 || D <= 0)
    return (int)cudaErrorInvalidValue;
  const auto* a = static_cast<const float*>(acc);
  const auto* mm = static_cast<const float*>(m);
  const auto* ll = static_cast<const float*>(l);
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)repro::launch_lse_merge<float>(
        a, mm, ll, rows, G, n_slots, D, static_cast<float*>(out), nullptr,
        nullptr, nullptr, st);
  if (dtype == 1)
    return (int)repro::launch_lse_merge<__nv_bfloat16>(
        a, mm, ll, rows, G, n_slots, D, static_cast<__nv_bfloat16*>(out),
        nullptr, nullptr, nullptr, st);
  return (int)cudaErrorInvalidValue;
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
