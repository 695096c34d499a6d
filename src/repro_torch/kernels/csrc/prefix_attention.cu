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
// flop/byte ridge for any batch this serves (B * G <= 128) on the tensor
// cores, but not on the CUDA cores: at mistral-7b's heads (B 32, G 4,
// D 128) the f32 FMAs alone take three times the byte bound. So the bf16
// products must run on the tensor cores, and once they do, the f32
// partials that the prefix splits write and the merge reads back are a
// visible share of the bytes.
//
// What the design does about it (the property the Pallas kernel exists for
// is kept: every prefix K/V row is read from device memory once per KV
// head for the whole batch):
//   * bf16, prefix half: one block of two warpgroups takes the 128 folded
//     rows gr = b * G + g of one KV head (rows past B * G are zero and
//     never written; more rows take further row tiles) against the key
//     range [c0, c1) of the prefix. The threads store Q swizzled; thread 0
//     copies 64-key K/V tiles by TMA (4-D tensor maps of the [KH, Sp, D]
//     views) into the 4-stage 128-byte-swizzled ring of wgmma.cuh, paced
//     by "full" and "empty" mbarriers. S = Q K^T is SS-wgmma; P V is
//     RS-wgmma with V read through the transposed descriptor, P rounded to
//     bf16 as the Pallas kernel's p.astype(v.dtype), row sums in f32;
//     S_t and P_{t-1} V_{t-1} are issued together. The prefix has no mask:
//     only keys at or past the block's end (the last tile, zero-filled by
//     TMA past Sp) are cut. Each block writes its unnormalised partial
//     (acc f32, m as a natural-log max, l) to its slot;
//   * the prefix's split count comes from the host plan (shapes and the
//     SM count): one block per SM, unless the f32 partials the splits
//     write and the merge reads back would outweigh the prefix itself.
//     More splits fill more of the card but move more partial bytes; a
//     sweep on the card (PERF.md) sets the balance;
//   * f32, prefix half: the same split and rows, on the CUDA cores through
//     tile_attend (attention.cuh), as flash's f32 path (f32 accuracy);
//   * the suffix is a per-request decode on the split-KV body of
//     split_kv.cuh (dense strided rows, cp.async ring) writing the slots
//     after the prefix's. The halves need nothing of each other, so they
//     run side by side: the prefix half on a second stream of the highest
//     priority (forked from the caller's stream and joined back before
//     the merge), so that its large blocks are placed first, and the
//     suffix on the caller's stream, its 48 KB blocks filling the room
//     the prefix blocks leave on each SM;
//   * one launch of the standalone lse_merge_kernel (one warp a row,
//     attention.cuh) combines the slots: the normalised output in q's
//     dtype (prefix_attention), or the prefix's combined (acc, m, l)
//     (prefix_partial; with one split the block writes it directly and
//     nothing is merged). The suffix's splits do not merge themselves
//     (no arrival counters): their slots sit beside the prefix's, which
//     another kernel writes.
// Not done yet (later work): combining the prefix splits' partials inside
// a thread-block cluster through distributed shared memory before they
// reach device memory, and a merge fused into the last block of each
// (lane, head) over both halves' slots.
#include <mutex>
#include <type_traits>

#include "attention.cuh"
#include "split_kv.cuh"
#include "wgmma.cuh"

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

// f32 on the CUDA cores. grid (n_split, row tiles, KH): split si of the
// prefix against row tile blockIdx.y of KV head blockIdx.z, into slot si.
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

// Rows per thread of the f32 kernel: 4 (64-row tiles) for up to 64 rows,
// else 8 (128 rows).
int rows_per_thread(int BG) { return BG <= 64 ? 4 : 8; }

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: wgmma over the folded rows, TMA-fed K/V ring
// ---------------------------------------------------------------------------

using namespace repro::wg;

// grid (n_split, row tiles of kRows, KH), kThreadsWg threads. Warpgroup w
// computes tile rows 64 w .. 64 w + 63; tk and tv are 4-D TMA views of
// kp and vp (D, then position, head and a batch of 1 in stride order,
// perm). Split si covers keys [si * chunk, min((si + 1) * chunk, Sp)),
// chunk a multiple of kBK, and writes slot si.
template <int D>
__global__ void __launch_bounds__(kThreadsWg, 1)
prefix_wgmma_kernel(const bf16* __restrict__ q,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    float* __restrict__ acc_out, float* __restrict__ m_out,
                    float* __restrict__ l_out, int H, int KH, int Sp, int BG,
                    int chunk, int n_slots, int perm, float scale_log2) {
  using C = WgCfg<D>;
  constexpr int NT = D / 8;  // n-tiles of the output
  extern __shared__ float4 smem4[];
  // the swizzle repeats every 1 KB: tiles start on a 1 KB boundary
  char* base = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem4) + 1023) & ~uintptr_t(1023));
  bf16* ring = reinterpret_cast<bf16*>(base) + kRows * D;  // after Q
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + kStages * 2 * C::tile_elems);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int si = blockIdx.x, h = blockIdx.z;
  const int G = H / KH;
  const int row0 = blockIdx.y * kRows;
  const int c0 = si * chunk;
  const int c1 = min(c0 + chunk, Sp);
  const int n_tiles = (c1 - c0 + kBK - 1) / kBK;  // >= 1: c0 < Sp

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, kThreadsWg / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the mbarriers are initialised
  // tile t into its stage (thread 0), after every warp is done with the
  // tile the stage held (t - kStages)
  auto issue = [&](int t) {
    const int s = t % kStages;
    if (t >= kStages) bar_wait(empty + s, (t / kStages - 1) & 1);
    const int kt0 = c0 + t * kBK;
    bf16* ks = ring + s * 2 * C::tile_elems;
    bar_expect(full + s, 2 * C::tile_bytes);
#pragma unroll
    for (int c = 0; c < D / C::CB; ++c) {
      tma_box(ks + c * C::CB * kBK, &tk, full + s, c * C::CB, kt0, h, 0,
              perm);
      tma_box(ks + C::tile_elems + c * C::CB * kBK, &tv, full + s, c * C::CB,
              kt0, h, 0, perm);
    }
  };
  if (tid == 0)
    for (int t = 0; t < kAhead && t < n_tiles; ++t) issue(t);
  // Q: 16-byte chunk c of folded row r, zero past BG
  for (int i = tid; i < kRows * (D / 8); i += kThreadsWg) {
    const int r = i % kRows, c = i / kRows;
    const int gr = row0 + r;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (gr < BG)
      x = *reinterpret_cast<const uint4*>(
          q + ((size_t)(gr / G) * H + (size_t)h * G + gr % G) * D + c * 8);
    *reinterpret_cast<uint4*>(base + C::at(kRows, r, c * 8)) = x;
  }
  // the stores went through the generic proxy; wgmma reads through the
  // async one
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int wg = warp >> 2;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int r0 = wg * 64 + (warp & 3) * 16 + g8;  // this thread's rows r0, + 8
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};

  uint32_t pk[kBK / 16][4];  // P of the previous tile, as the A operand
  for (int t = 0; t < n_tiles; ++t) {
    if (tid == 0 && t + kAhead < n_tiles) issue(t + kAhead);
    __syncwarp();
    const int s = t % kStages;
    bar_wait(full + s, (t / kStages) & 1);
    const bf16* ks = ring + s * 2 * C::tile_elems;
    const int kt0 = c0 + t * kBK;

    // S = Q K^T: m64 n64, D / 16 steps of k16 (K-major)
    float sc[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(
          sc,
          smem_desc(base + C::at(kRows, wg * 64, kk * 16), 16, 8 * C::RB,
                    C::layout),
          smem_desc(reinterpret_cast<const char*>(ks) + C::at(kBK, 0, kk * 16),
                    16, 8 * C::RB, C::layout),
          kk > 0);
    wg_commit();
    if (t > 0) {
      pv_step<D>(o, pk, ring + ((t - 1) % kStages) * 2 * C::tile_elems +
                            C::tile_elems);
      wg_commit();
      wg_wait<1>();  // S_t has landed; P_{t-1} V_{t-1} may still run
    } else {
      wg_wait<0>();
    }

    // online softmax per row in base 2 (sc[4 j + 2 h2 + e] is row r0 +
    // 8 h2, key 8 j + 2 t4 + e); keys at or past c1 only in the last tile
    const bool cut = kt0 + kBK > c1;
    float corr[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      if (cut) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (kt0 + j * 8 + 2 * t4 + e >= c1)
              sc[4 * j + 2 * h2 + e] = -INFINITY;
      }
      float mx4[4];  // a tree of maxima: short dependency chains
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mx4[i] = fmaxf(fmaxf(sc[8 * i + 2 * h2], sc[8 * i + 2 * h2 + 1]),
                       fmaxf(sc[8 * i + 4 + 2 * h2], sc[8 * i + 5 + 2 * h2]));
      float mx = fmaxf(fmaxf(mx4[0], mx4[1]), fmaxf(mx4[2], mx4[3]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[h2], mx * scale_log2);  // finite
      corr[h2] = ex2(m_r[h2] - m_new);  // m -inf: 0
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * j + 2 * h2 + e];
          x = ex2(fmaf(x, scale_log2, -m_new));  // cut: 0
          sum += x;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_r[h2] = l_r[h2] * corr[h2] + sum;
      m_r[h2] = m_new;
    }

    if (t > 0) {
      wg_wait<0>();  // P_{t-1} V_{t-1} has landed: the stage is free
      __syncwarp();
      if (lane == 0) bar_arrive(empty + (t - 1) % kStages);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[4 * n] *= corr[0];
      o[4 * n + 1] *= corr[0];
      o[4 * n + 2] *= corr[1];
      o[4 * n + 3] *= corr[1];
    }
    // P to bf16 (as the Pallas kernel's p.astype(v.dtype)): the S
    // fragments of key n-tiles 2u and 2u + 1 are the A operand of step u
#pragma unroll
    for (int u = 0; u < kBK / 16; ++u) {
      pk[u][0] = pack_bf16(sc[8 * u], sc[8 * u + 1]);
      pk[u][1] = pack_bf16(sc[8 * u + 2], sc[8 * u + 3]);
      pk[u][2] = pack_bf16(sc[8 * u + 4], sc[8 * u + 5]);
      pk[u][3] = pack_bf16(sc[8 * u + 6], sc[8 * u + 7]);
    }
  }
  // the last tile's P V
  wg_fence();
  pv_step<D>(o, pk, ring + ((n_tiles - 1) % kStages) * 2 * C::tile_elems +
                        C::tile_elems);
  wg_commit();
  wg_wait<0>();

  // the unnormalised partial of each real row: acc f32, m natural log, l
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int gr = row0 + r0 + 8 * h2;
    if (gr >= BG) continue;
    const int b = gr / G, g = gr % G;
    const size_t row = (((size_t)b * KH + h) * n_slots + si) * G + g;
    float* ob = acc_out + row * D;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(ob + n * 8 + 2 * t4) =
          make_float2(o[4 * n + 2 * h2], o[4 * n + 2 * h2 + 1]);
    if (t4 == 0) {
      m_out[row] = m_r[h2] * repro::kLn2;
      l_out[row] = l_r[h2];
    }
  }
}

template <int D>
cudaError_t launch_prefix_wgmma(const void* q, const void* kp,
                                const void* vp, float* acc, float* m,
                                float* l, int H, int KH, int Sp, int BG,
                                int n_split, int chunk, int n_slots,
                                long long kv_sh, long long kv_ss,
                                cudaStream_t stream) {
  CUtensorMap tk, tv;
  int perm;
  cudaError_t err = make_view(&tk, kp, D, Sp, KH, 1, kv_ss, kv_sh, 0, &perm);
  if (err == cudaSuccess)
    err = make_view(&tv, vp, D, Sp, KH, 1, kv_ss, kv_sh, 0, &perm);
  if (err != cudaSuccess) return err;
  auto* kernel = &prefix_wgmma_kernel<D>;
  err = repro::allow_smem(kernel, WgCfg<D>::smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_split, (BG + kRows - 1) / kRows, KH);
  kernel<<<grid, kThreadsWg, WgCfg<D>::smem_bytes, stream>>>(
      static_cast<const bf16*>(q), tk, tv, acc, m, l, H, KH, Sp, BG, chunk,
      n_slots, perm, repro::inv_sqrt(D) * repro::kLog2e);
  return cudaGetLastError();
}

template <typename T, int D, int RT>
cudaError_t launch_prefix_f32(const void* q, const void* kp, const void* vp,
                              float* acc, float* m, float* l, int H, int KH,
                              int Sp, int BG, int n_split, int chunk,
                              int n_slots, long long kv_sh, long long kv_ss,
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

// The prefix half: wgmma for bf16, the CUDA cores for f32.
struct PrefixFn {
  const void *q, *kp, *vp;
  float *acc, *m, *l;
  int H, KH, Sp, BG, n_split, chunk, n_slots;
  long long kv_sh, kv_ss;
  cudaStream_t stream;
  cudaError_t* err;
  template <typename T, int D>
  void operator()() const {
    if constexpr (std::is_same<T, bf16>::value)
      *err = launch_prefix_wgmma<D>(q, kp, vp, acc, m, l, H, KH, Sp, BG,
                                    n_split, chunk, n_slots, kv_sh, kv_ss,
                                    stream);
    else if (rows_per_thread(BG) == 4)
      *err = launch_prefix_f32<T, D, 4>(q, kp, vp, acc, m, l, H, KH, Sp, BG,
                                        n_split, chunk, n_slots, kv_sh,
                                        kv_ss, stream);
    else
      *err = launch_prefix_f32<T, D, 8>(q, kp, vp, acc, m, l, H, KH, Sp, BG,
                                        n_split, chunk, n_slots, kv_sh,
                                        kv_ss, stream);
  }
};

// The suffix: n_sfx splits of each lane's [0, lens[b]) into the slots
// from slot0 on.
struct SuffixFn {
  const void *q, *ks, *vs, *lens;
  float *acc, *m, *l;
  int B, H, KH, Ss, n_sfx, sfx_len, n_slots, slot0;
  long long sb, sh, ss;
  cudaStream_t stream;
  cudaError_t* err;
  template <typename T, int G, int D>
  void operator()() const {
    *err = repro::skv::launch_dense_split<T, G, D>(
        q, ks, vs, lens, nullptr, acc, m, l, nullptr, B, H, KH, Ss, n_sfx,
        sfx_len, n_slots, slot0, sb, sh, ss, stream);
  }
};

struct QueryFn {
  int BG;
  int *blocks, *regs, *smem, *threads;
  cudaError_t* err;
  template <typename T, int D>
  void operator()() const {
    if constexpr (std::is_same<T, bf16>::value) {
      *threads = kThreadsWg;
      *err = repro::occupancy(&prefix_wgmma_kernel<D>, kThreadsWg,
                              WgCfg<D>::smem_bytes, blocks, regs, smem);
    } else if (rows_per_thread(BG) == 4) {
      *threads = repro::kTileThreads;
      *err = repro::occupancy(&prefix_kernel<T, D, 4>, repro::kTileThreads,
                              TileCfg<D, 4>::smem_bytes, blocks, regs, smem);
    } else {
      *threads = repro::kTileThreads;
      *err = repro::occupancy(&prefix_kernel<T, D, 8>, repro::kTileThreads,
                              TileCfg<D, 8>::smem_bytes, blocks, regs, smem);
    }
  }
};

bool built_group(int G) {
  return G == 1 || G == 2 || G == 3 || G == 4 || G == 6 || G == 8;
}

// A second stream of each device, of the highest priority, with the two
// events that fork it from the caller's stream and join it back, made at
// first use. The mutex also keeps one caller's fork-launch-join sequence
// whole.
struct Side {
  cudaStream_t stream = nullptr;
  cudaEvent_t fork = nullptr, join = nullptr;
};
std::mutex side_mutex;

cudaError_t side_of_device(Side** out) {
  static Side sides[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  Side& s = sides[dev];
  if (s.stream == nullptr) {
    int least = 0, greatest = 0;
    err = cudaDeviceGetStreamPriorityRange(&least, &greatest);
    if (err == cudaSuccess)
      err = cudaStreamCreateWithPriority(&s.stream, cudaStreamNonBlocking,
                                         greatest);
    if (err == cudaSuccess)
      err = cudaEventCreateWithFlags(&s.fork, cudaEventDisableTiming);
    if (err == cudaSuccess)
      err = cudaEventCreateWithFlags(&s.join, cudaEventDisableTiming);
    if (err != cudaSuccess) return err;
  }
  *out = &s;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q [B, H, D] contiguous; kp/vp share the
// element strides kp_sh (head) and kp_ss (position) of a [KH, Sp, D] view,
// last dim contiguous. Prefix split si covers [si * chunk, (si + 1) * chunk),
// chunk a multiple of 64. Scratch acc [B, KH, n_slots, G, D], m and l
// [B, KH, n_slots, G] f32 with n_slots = n_split (+ n_sfx with a suffix).
// With ks != NULL (prefix_attention): ks/vs share the strides ks_sb, ks_sh,
// ks_ss of a [B, KH, Ss, D] view, lens [B] int32, the suffix is cut into
// n_sfx splits of sfx_len keys, and out [B, H, D] in q's dtype receives the
// normalised result. With ks == NULL (prefix_partial): acc_out [B, KH, G, D],
// m_out and l_out [B, KH, G] f32 receive the prefix's combined unnormalised
// partial (with n_split 1 the scratch is not used). Returns the cudaError_t
// of the launches.
int repro_prefix_attention(const void* q, const void* kp, const void* vp,
                           const void* ks, const void* vs, const void* lens,
                           void* acc, void* m, void* l, void* out,
                           void* acc_out, void* m_out, void* l_out, int B,
                           int H, int KH, int D, int Sp, int n_split,
                           int chunk, long long kp_sh, long long kp_ss, int Ss,
                           int n_sfx, int sfx_len, long long ks_sb,
                           long long ks_sh, long long ks_ss, int dtype,
                           void* stream) {
  const bool sfx = ks != nullptr;
  if (B <= 0 || KH <= 0 || H % KH != 0 || Sp <= 0 || n_split <= 0 ||
      chunk <= 0 || chunk % repro::kTileK != 0 ||
      (long long)n_split * chunk < Sp ||
      (long long)(n_split - 1) * chunk >= Sp ||
      (sfx && (Ss <= 0 || n_sfx <= 0 || sfx_len <= 0 ||
               (long long)n_sfx * sfx_len < Ss)))
    return (int)cudaErrorInvalidValue;
  const int G = H / KH;
  // the suffix kernel is built for G in {1, 2, 3, 4, 6, 8}: refuse any
  // other before anything launches
  if (!built_group(G)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool direct = !sfx && n_split == 1;  // the partial is the result
  float* accf = static_cast<float*>(direct ? acc_out : acc);
  float* mf = static_cast<float*>(direct ? m_out : m);
  float* lf = static_cast<float*>(direct ? l_out : l);
  if (accf == nullptr || mf == nullptr || lf == nullptr)
    return (int)cudaErrorInvalidValue;
  const int n_slots = n_split + (sfx ? n_sfx : 0);
  cudaError_t err = cudaSuccess;
  // the two halves write their own slots: with a suffix, the prefix half
  // runs on the high-priority second stream (its large blocks are placed
  // first) and the suffix on the caller's, forked after the caller's
  // earlier work and joined before the merge
  std::unique_lock<std::mutex> lock(side_mutex, std::defer_lock);
  Side* side = nullptr;
  if (sfx) {
    lock.lock();
    err = side_of_device(&side);
    if (err == cudaSuccess) err = cudaEventRecord(side->fork, st);
    if (err == cudaSuccess)
      err = cudaStreamWaitEvent(side->stream, side->fork, 0);
    if (err != cudaSuccess) return (int)err;
  }
  const PrefixFn pre{q, kp, vp, accf, mf, lf, H, KH, Sp, B * G, n_split,
                     chunk, n_slots, kp_sh, kp_ss,
                     sfx ? side->stream : st, &err};
  if (!repro::dispatch_dtype_d(dtype, D, pre)) err = cudaErrorInvalidValue;
  if (sfx) {
    if (err == cudaSuccess) {
      const SuffixFn f{q, ks, vs, lens, accf, mf, lf, B, H, KH, Ss, n_sfx,
                       sfx_len, n_slots, n_split, ks_sb, ks_sh, ks_ss, st,
                       &err};
      repro::dispatch_dtype_gd(dtype, G, D, f);
    }
    // join even after a failed launch, so the caller's stream never runs
    // ahead of work already queued on the second one
    const cudaError_t e1 = cudaEventRecord(side->join, side->stream);
    const cudaError_t e2 = cudaStreamWaitEvent(st, side->join, 0);
    if (err == cudaSuccess) err = e1 != cudaSuccess ? e1 : e2;
    lock.unlock();
  }
  if (err != cudaSuccess || direct) return (int)err;
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

// Occupancy of the prefix kernel that a launch with BG folded rows runs
// for (dtype, D): resident blocks per SM, registers per thread, shared
// bytes, threads a block.
int repro_prefix_occupancy(int dtype, int D, int BG, int* blocks_per_sm,
                           int* regs, int* smem_bytes, int* threads) {
  if (BG <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  const QueryFn f{BG, blocks_per_sm, regs, smem_bytes, threads, &err};
  if (!repro::dispatch_dtype_d(dtype, D, f)) return (int)cudaErrorInvalidValue;
  return (int)err;
}

}  // extern "C"
