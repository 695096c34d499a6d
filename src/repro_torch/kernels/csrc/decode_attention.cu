// Split-K decode attention (flash-decoding) for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention (body _kernel, grid (B, KH, n_splits)) and its jnp
// lse_merge: one-token GQA decode attention over a dense per-lane cache
// K/V [B, KH, S, D] (or the model layout [B, S, KH, D], read in place
// through strides) with valid lengths lens [B].
//
// What bounds it: memory. Each K/V element is read once for the G = H/KH
// query rows of its head, 4*G flops per element, far below the ~295
// flop/byte at which an H100 stops being memory-bound. The least traffic is
// the valid KV, sum_b min(len_b, S) * KH * D * 2 * itemsize, plus q and out.
// With ragged lanes the lanes' valid keys, not S, set the work, and the
// longest lane sets the time unless its keys are spread over many blocks.
//
// What the design does about it:
//   * split-KV, grid (n_splits, KH, B), built on the body of split_kv.cuh
//     (shared with paged decode and the suffix of shared-prefix decode):
//     K/V tiles of 16 KB staged by cp.async through a 3-stage ring, lanes
//     of a warp splitting D with the q slice in registers, softmax state
//     per lane group, one block barrier a tile, V read as 16-byte vectors
//     from shared memory. The row-address policy is DenseRows: base +
//     pos * stride, so the model layout needs no copy;
//   * the split plan (n_splits, split length in whole tiles) is made on
//     the host from B, KH, S, the tile and the SM count only, never from
//     lens (that would sync): about 8 blocks per SM, so that the block
//     scheduler evens out ragged lanes (splits past a lane's length exit
//     at once), with at least one wave of blocks at B 1. The Pallas clamp
//     of the public n_splits does not apply here: the merged output does
//     not depend on the split beyond f32 rounding;
//   * one split: the block normalises and writes q's dtype. More: each
//     split that holds a key writes its f32 partial to one scratch
//     buffer, and the last of them to arrive merges the (lane, KV head)'s
//     slots into q's dtype (split_kv.cuh: an arrival counter per (lane,
//     head) in a workspace the wrapper keeps at 0 between calls). One
//     launch either way: the merge is latency and a launch, not bytes
//     (attention.cuh), and as the last block's tail it needs no launch of
//     its own; each split pays one fence instead. With no out
//     (the partials entry) every split's partial, empty ones included, is
//     left for a merge elsewhere.
// Measured on an H100 80GB HBM3 at 700 W (tools/ablate_decode.py, B 8,
// S 8192, KH 8, D 128, every lane full): the copies alone move the cache
// at about 2.6 TB/s, 77 % of the data sheet's rate, and the products and
// softmax alone take two thirds of that time, so the kernel is bound by
// its copies, not by instruction issue; with ragged lanes the longest
// lanes' splits add a tail.
// Not done yet (later work): bulk (TMA) copies into a deeper ring, and
// persistent blocks taking splits longest lane first.
#include "attention.cuh"
#include "split_kv.cuh"

namespace {

namespace skv = repro::skv;

struct LaunchFn {
  const void *q, *k, *v, *lens;
  void* out;
  float *acc, *m, *l;
  int* counters;
  int B, H, KH, S, n_split, split_len;
  long long kv_sb, kv_sh, kv_ss;
  cudaStream_t stream;
  cudaError_t* err;
  template <typename T, int G, int D>
  void operator()() const {
    const bool direct = n_split == 1 && out != nullptr;
    *err = skv::launch_dense_split<T, G, D>(
        q, k, v, lens, out, direct ? nullptr : acc, m, l,
        direct || out == nullptr ? nullptr : counters, B, H, KH, S, n_split,
        split_len, n_split, 0, kv_sb, kv_sh, kv_ss, stream);
  }
};

struct QueryFn {
  int *blocks, *regs, *smem, *tile;
  cudaError_t* err;
  template <typename T, int G, int D>
  void operator()() const {
    *tile = skv::Cfg<T, D>::TT;
    *err = repro::occupancy(&skv::dense_split_kernel<T, G, D>, skv::kThreads,
                            skv::Cfg<T, D>::ring_bytes, blocks, regs, smem);
  }
};

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q/out [B, H, D] contiguous; k and v
// share the element strides kv_sb, kv_sh, kv_ss of their batch, head and
// position dims (last dim contiguous); lens [B] int32. Split si covers
// positions [si * split_len, (si + 1) * split_len). With n_split > 1, acc
// [B, KH, n_split, G, D] and m, l [B, KH, n_split, G] are f32 scratch,
// and counters [B * KH] int32 are 0 on entry and left at 0 by the launch
// (all unused with one split and out). out == NULL: no merge, every
// split's partial (m in natural log units) is left in acc, m, l, whatever
// n_split (counters unused). One launch. Returns its cudaError_t (0 =
// success); cudaErrorInvalidValue when (dtype, G, D) has no
// instantiation.
int repro_decode_attention(const void* q, const void* k, const void* v,
                           const void* lens, void* acc, void* m, void* l,
                           void* counters, void* out, int B, int H, int KH,
                           int D, int S, int n_split, int split_len,
                           long long kv_sb, long long kv_sh, long long kv_ss,
                           int dtype, void* stream) {
  const bool merge = out != nullptr && n_split > 1;
  if (B <= 0 || KH <= 0 || H % KH != 0 || S <= 0 || n_split <= 0 ||
      split_len <= 0 || (long long)n_split * split_len < S ||
      ((n_split > 1 || out == nullptr) &&
       (acc == nullptr || m == nullptr || l == nullptr)) ||
      (merge && counters == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  const LaunchFn f{q, k, v, lens, out,
                   static_cast<float*>(acc), static_cast<float*>(m),
                   static_cast<float*>(l), static_cast<int*>(counters), B, H,
                   KH, S, n_split, split_len, kv_sb, kv_sh, kv_ss,
                   static_cast<cudaStream_t>(stream), &err};
  if (!repro::dispatch_dtype_gd(dtype, H / KH, D, f))
    return (int)cudaErrorInvalidValue;
  return (int)err;
}

// Occupancy of the split kernel for one (dtype, G, D): resident blocks
// per SM, registers per thread, shared bytes (dynamic), tokens per tile.
int repro_decode_occupancy(int dtype, int G, int D, int* blocks_per_sm,
                           int* regs, int* smem_bytes, int* tile) {
  cudaError_t err = cudaSuccess;
  const QueryFn f{blocks_per_sm, regs, smem_bytes, tile, &err};
  if (!repro::dispatch_dtype_gd(dtype, G, D, f))
    return (int)cudaErrorInvalidValue;
  return (int)err;
}

}  // extern "C"
