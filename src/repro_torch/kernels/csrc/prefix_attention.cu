// Shared-prefix (Hydragen) decode attention for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/prefix_attention.py::
// prefix_partial (body _prefix_kernel, grid (KH, n_kv)) and the jnp suffix
// partial and lse_merge that prefix_attention adds to it: B decode queries
// whose requests share one prompt prefix K/V [KH, Sp, D], stored once, plus
// per-request suffixes K/V [B, KH, Ss, D] with lengths lens [B].
//
// What bounds it: memory. The least traffic is the shared prefix once
// (2 * KH * Sp * D * itemsize), the valid suffix rows, q and out; the
// products do 4 * B * G flops per prefix element, below the H100's ~295
// flop/byte ridge for any batch this serves (B * G <= 128).
//
// What the design does about it (the property the Pallas kernel exists for):
//   * every prefix K/V row is read from device memory once per KV head for
//     the whole batch: one block takes all B * G query rows of a KV head
//     (batch folded into the row dim, as the TPU kernel folds it into the
//     matmul) and a chunk of the prefix, staged through shared memory in
//     64-key tiles (tile_attend); a batch of more than 128 rows is cut into
//     128-row tiles, and only then is the prefix read once per row tile;
//   * the prefix is split into chunks across blocks (a multiple of 64 keys
//     each, chosen by the wrapper to fill the SMs: only KH blocks would hold
//     a whole head each), each writing an unnormalised partial slot;
//   * the suffix is a per-request decode: the split-partial kernel of
//     decode_attention.cu at one split writes one more slot per row;
//   * one merge kernel combines the slots: the normalised output in q's
//     dtype (prefix_attention), or the prefix's combined (acc, m, l)
//     (prefix_partial), so no partial of a chunk outlives the call.
// Not done yet (later work): tensor-core (mma/wgmma) products and cp.async
// or TMA staging of the prefix tiles.
#include "attention.cuh"

namespace {

using repro::TileCfg;

// Tile row r of a prefix block: folded row gr = row0 + r = b * G + g of KV
// head h is query row h * G + g of lane b; rows at or past BG are padding.
template <typename T, int D>
struct PrefixRows {
  const T* q;
  int row0, BG, G, H, h;
  __device__ const T* operator()(int r) const {
    const int gr = row0 + r;
    if (gr >= BG) return nullptr;
    return q + ((size_t)(gr / G) * H + (size_t)h * G + gr % G) * D;
  }
};

// grid (n_split, row tiles, KH): split si of the prefix against row tile
// blockIdx.y of KV head blockIdx.z, into slot si.
template <typename T, int D, int RT>
__global__ void __launch_bounds__(repro::kTileThreads)
prefix_kernel(const T* __restrict__ q, const T* __restrict__ kp,
              const T* __restrict__ vp, float* __restrict__ acc_out,
              float* __restrict__ m_out, float* __restrict__ l_out, int H,
              int KH, int Sp, int BG, int chunk, int n_slots, long long kv_sh,
              long long kv_ss, float scale) {
  using C = TileCfg<D, RT>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int si = blockIdx.x, h = blockIdx.z;
  const int G = H / KH;
  const int row0 = blockIdx.y * C::BQ;
  const PrefixRows<T, D> q_row{q, row0, BG, G, H, h};
  const int c0 = si * chunk;
  const int c1 = min(c0 + chunk, Sp);
  float acc[RT][D / 16], m[RT], l[RT];
  repro::tile_attend<T, D, RT>(smem, q_row, kp + h * kv_sh, vp + h * kv_sh,
                               kv_ss, c0, c1, Sp, c1, false, 0, 0, scale, acc,
                               m, l);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int gr = row0 + ty * RT + i;
    if (gr >= BG) continue;
    const int b = gr / G, g = gr % G;
    const size_t row = (((size_t)b * KH + h) * n_slots + si) * G + g;
#pragma unroll
    for (int cc = 0; cc < C::NC; ++cc)
#pragma unroll
      for (int e = 0; e < C::VW; ++e)
        acc_out[row * D + C::col(tx, cc, e)] = acc[i][cc * C::VW + e];
    if (tx == 0) {
      m_out[row] = m[i];
      l_out[row] = l[i];
    }
  }
}

template <typename T, int D, int RT>
cudaError_t launch_prefix(const void* q, const void* kp, const void* vp,
                          float* acc, float* m, float* l, int H, int KH,
                          int Sp, int BG, int n_split, int chunk, int n_slots,
                          long long kv_sh, long long kv_ss,
                          cudaStream_t stream) {
  using C = TileCfg<D, RT>;
  auto* kernel = &prefix_kernel<T, D, RT>;
  cudaError_t err = repro::allow_smem(kernel, C::smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_split, (BG + C::BQ - 1) / C::BQ, KH);
  kernel<<<grid, repro::kTileThreads, C::smem_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), acc, m, l, H, KH, Sp, BG, chunk, n_slots,
      kv_sh, kv_ss, repro::inv_sqrt(D));
  return cudaGetLastError();
}

// Rows per thread: 4 (64-row tiles) for up to 64 rows, else 8 (128 rows).
int rows_per_thread(int BG) { return BG <= 64 ? 4 : 8; }

struct PrefixFn {
  const void *q, *kp, *vp;
  float *acc, *m, *l;
  int H, KH, Sp, BG, n_split, chunk, n_slots;
  long long kv_sh, kv_ss;
  cudaStream_t stream;
  cudaError_t* err;
  template <typename T, int D>
  void operator()() const {
    if (rows_per_thread(BG) == 4)
      *err = launch_prefix<T, D, 4>(q, kp, vp, acc, m, l, H, KH, Sp, BG,
                                    n_split, chunk, n_slots, kv_sh, kv_ss,
                                    stream);
    else
      *err = launch_prefix<T, D, 8>(q, kp, vp, acc, m, l, H, KH, Sp, BG,
                                    n_split, chunk, n_slots, kv_sh, kv_ss,
                                    stream);
  }
};

// The suffix: one split over each lane's [0, lens[b]) into slot `slot`.
struct SuffixFn {
  const void *q, *ks, *vs, *lens;
  float *acc, *m, *l;
  int B, H, KH, Ss, n_slots, slot;
  long long sb, sh, ss;
  cudaStream_t stream;
  cudaError_t* err;
  template <typename T, int G, int D>
  void operator()() const {
    const dim3 grid(1, KH, B);
    repro::split_partial_kernel<T, G, D><<<grid, repro::kSplitThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(ks),
        static_cast<const T*>(vs), static_cast<const int32_t*>(lens), acc, m, l,
        H, KH, Ss, Ss, n_slots, slot, sb, sh, ss, repro::inv_sqrt(D));
    *err = cudaGetLastError();
  }
};

struct QueryFn {
  int rt;
  int *blocks, *regs, *smem;
  cudaError_t* err;
  template <typename T, int D>
  void operator()() const {
    if (rt == 4)
      *err = repro::occupancy(&prefix_kernel<T, D, 4>, repro::kTileThreads,
                              TileCfg<D, 4>::smem_bytes, blocks, regs, smem);
    else
      *err = repro::occupancy(&prefix_kernel<T, D, 8>, repro::kTileThreads,
                              TileCfg<D, 8>::smem_bytes, blocks, regs, smem);
  }
};

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q [B, H, D] contiguous; kp/vp share the
// element strides kp_sh (head) and kp_ss (position) of a [KH, Sp, D] view,
// last dim contiguous. Prefix split si covers [si * chunk, (si + 1) * chunk),
// chunk a multiple of 64. Scratch acc [B, KH, n_slots, G, D], m and l
// [B, KH, n_slots, G] f32 with n_slots = n_split (+ 1 with a suffix).
// With ks != NULL (prefix_attention): ks/vs share the strides ks_sb, ks_sh,
// ks_ss of a [B, KH, Ss, D] view, lens [B] int32, and out [B, H, D] in q's
// dtype receives the normalised result. With ks == NULL (prefix_partial):
// acc_out [B, KH, G, D], m_out and l_out [B, KH, G] f32 receive the prefix's
// combined unnormalised partial. Returns the cudaError_t of the launches.
int repro_prefix_attention(const void* q, const void* kp, const void* vp,
                           const void* ks, const void* vs, const void* lens,
                           void* acc, void* m, void* l, void* out,
                           void* acc_out, void* m_out, void* l_out, int B,
                           int H, int KH, int D, int Sp, int n_split,
                           int chunk, long long kp_sh, long long kp_ss, int Ss,
                           long long ks_sb, long long ks_sh, long long ks_ss,
                           int dtype, void* stream) {
  if (B <= 0 || KH <= 0 || H % KH != 0 || Sp <= 0 || n_split <= 0 ||
      chunk <= 0 || chunk % repro::kTileK != 0 || (ks != nullptr && Ss <= 0))
    return (int)cudaErrorInvalidValue;
  const int G = H / KH;
  const int n_slots = n_split + (ks != nullptr ? 1 : 0);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* accf = static_cast<float*>(acc);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  cudaError_t err = cudaSuccess;
  // the suffix kernel is built for G in {1, 2, 3, 4, 8}: refuse any other
  // before anything launches
  const SuffixFn sfx{q, ks, vs, lens, accf, mf, lf, B, H, KH, Ss, n_slots,
                     n_split, ks_sb, ks_sh, ks_ss, st, &err};
  if (G != 1 && G != 2 && G != 3 && G != 4 && G != 8)
    return (int)cudaErrorInvalidValue;
  const PrefixFn pre{q, kp, vp, accf, mf, lf, H, KH, Sp, B * G, n_split,
                     chunk, n_slots, kp_sh, kp_ss, st, &err};
  if (!repro::dispatch_dtype_d(dtype, D, pre)) return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  if (ks != nullptr) {
    repro::dispatch_dtype_gd(dtype, G, D, sfx);
    if (err != cudaSuccess) return (int)err;
  }
  if (out == nullptr)
    err = repro::launch_lse_merge<float>(
        accf, mf, lf, B * H, G, n_slots, D, nullptr,
        static_cast<float*>(acc_out), static_cast<float*>(m_out),
        static_cast<float*>(l_out), st);
  else if (dtype == 0)
    err = repro::launch_lse_merge<float>(accf, mf, lf, B * H, G, n_slots, D,
                                         static_cast<float*>(out), nullptr,
                                         nullptr, nullptr, st);
  else
    err = repro::launch_lse_merge<__nv_bfloat16>(
        accf, mf, lf, B * H, G, n_slots, D, static_cast<__nv_bfloat16*>(out),
        nullptr, nullptr, nullptr, st);
  return (int)err;
}

// Occupancy of the prefix kernel for one (dtype, D, rows per thread 4 or
// 8): resident blocks per SM, registers per thread, shared bytes.
int repro_prefix_occupancy(int dtype, int D, int rt, int* blocks_per_sm,
                           int* regs, int* smem_bytes) {
  if (rt != 4 && rt != 8) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  const QueryFn f{rt, blocks_per_sm, regs, smem_bytes, &err};
  if (!repro::dispatch_dtype_d(dtype, D, f)) return (int)cudaErrorInvalidValue;
  return (int)err;
}

}  // extern "C"
