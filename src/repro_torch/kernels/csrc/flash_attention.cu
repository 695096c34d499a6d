// Causal GQA flash attention for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _kernel, grid (B, H, nq, nk), the KV axis sequential
// with the online-softmax state in VMEM scratch): q [B, H, Sq, D] against
// k/v [B, KH, Skv, D], masked by k < kv_len, k <= q when causal and
// k > q - window when window > 0 (positions from 0 on both sides). A row
// with no visible key returns 0.
//
// What bounds it: operations. Each visible (query, key) pair costs 4 * D
// flops and the operands are reused across a whole tile, so at prefill
// lengths the work is far above the H100's ~295 flop/byte ridge; the bound
// is the visible pairs' flops over the tensor-core peak (989 TFLOP/s bf16).
//
// What the design does about it:
//   * bf16 inputs go to Hopper's warpgroup tensor-core instruction (wgmma
//     m64nNk16, bf16 in, f32 accumulate), one block of two warpgroups per
//     (query tile, group of GH query heads of one KV head, lane): GH = G
//     for G <= 4 (4 of the 8 for G 8). The block's 128 rows are the GH
//     heads' (head, position) pairs, 128 / GH positions each (42 at
//     smollm's G 3), so each 64-key K/V tile is loaded from device memory
//     once for all GH heads, and the longest causal block (the critical
//     path at S 2048) holds 128 rows rather than 64 per head;
//   * the threads store Q once; thread 0 copies a ring of 4 K/V tiles into
//     shared memory with TMA (cp.async.bulk.tensor over 4-D views of the
//     strided tensors, one swizzled box of 64 columns x 64 rows a block of
//     columns, zero past the end), two tiles ahead of the one in use,
//     paced by two mbarriers a stage ("full" completes on the tile's bytes,
//     "empty" when every warp is done with it), so the next tiles load
//     while this one computes and the warpgroups drift apart instead of
//     meeting at a block barrier;
//   * S = Q K^T reads both operands from shared memory through wgmma
//     descriptors (swizzled, K-major); P V takes P from the
//     S registers (rounded to bf16, as the Pallas kernel's
//     p.astype(v.dtype); the row sums stay f32) and V from shared memory
//     through a transposed (MN-major) descriptor, so no transposed copy of
//     V is ever built. S, the running max and sum and O stay in registers.
//     S_t = Q K_t^T and P_{t-1} V_{t-1} are issued together, and the
//     softmax of S_t (base 2: ex2 of one fma, the scale folded in) runs
//     while P_{t-1} V_{t-1} is on the tensor cores; masks are evaluated
//     only on the tiles that cut the block's positions;
//   * f32 inputs keep f32 accuracy on the CUDA cores: 256 threads stage Q,
//     K^T, V and P^T through shared memory as f32 and each computes 4 x 4
//     scores and 4 x D/16 outputs (tile_attend in attention.cuh), one block
//     per (64-query tile, head, lane);
//   * the block visits only the key tiles that hold a visible key: tiles
//     wholly above the diagonal, left of every row's window or past kv_len
//     are never loaded (the TPU grid still steps through them);
//   * blocks are launched longest first (the last query tile of a causal
//     prefill has the most keys), so the tail of the grid is short;
//   * q, k, v and out are read and written in place through element
//     strides, so the model layout [B, S, H, D] needs no transposed copy.
// Not done yet (later work): a producer warp with register reallocation
// (setmaxnreg) and two consumer warpgroups in ping-pong, since each
// warpgroup's chain S -> softmax -> P V per tile is what holds the smollm
// shape back, and splitting the longest causal query tiles along the keys.
#include <type_traits>

#include "attention.cuh"
#include "wgmma.cuh"

namespace {

using repro::TileCfg;
constexpr int kRT = 4;  // 4 rows per thread: 64-query tiles

template <typename T>
struct FlashRows {
  const T* q;
  long long q_ss;
  int q0, Sq;
  __device__ const T* operator()(int r) const {
    return q0 + r < Sq ? q + (long long)(q0 + r) * q_ss : nullptr;
  }
};

// f32 on the CUDA cores. grid (query tiles, H, B). Strides in elements; the
// last dim contiguous.
template <typename T, int D>
__global__ void __launch_bounds__(repro::kTileThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int H, int KH,
             int Sq, int kv_mem, int kv_valid, int causal, int window,
             long long q_sb, long long q_sh, long long q_ss, long long kv_sb,
             long long kv_sh, long long kv_ss, long long o_sb, long long o_sh,
             long long o_ss, float scale) {
  using C = TileCfg<D, kRT>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int q0 = qt * C::BQ;
  const int q_end = min(q0 + C::BQ, Sq);
  // keys any real row of this tile can see: [k_lo, k_hi)
  int k_hi = kv_valid;
  if (causal) k_hi = min(k_hi, q_end);
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_first = (k_lo / C::BK) * C::BK;
  const FlashRows<T> q_row{q + b * q_sb + h * q_sh, q_ss, q0, Sq};
  float acc[kRT][D / 16], m[kRT], l[kRT];
  repro::tile_attend<T, D, kRT>(smem, q_row, k + b * kv_sb + kh * kv_sh,
                                v + b * kv_sb + kh * kv_sh, kv_ss, k_first,
                                k_hi, kv_mem, kv_valid, causal != 0, window,
                                q0, scale, acc, m, l);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  T* ob = out + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    const int qpos = q0 + ty * kRT + i;
    if (qpos >= Sq) continue;
    const float lsafe = fmaxf(l[i], 1e-30f);  // no visible key: 0 / 1e-30
#pragma unroll
    for (int cc = 0; cc < C::NC; ++cc)
#pragma unroll
      for (int e = 0; e < C::VW; ++e)
        repro::store(ob + qpos * o_ss + C::col(tx, cc, e),
                     acc[i][cc * C::VW + e] / lsafe);
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: wgmma, K/V shared by the GH heads of a block
// ---------------------------------------------------------------------------

// the ring geometry, wgmma, mbarrier and TMA helpers (shared with the
// shared-prefix kernel)
using namespace repro::wg;
using repro::kLog2e;

// grid (query tiles of P positions, KH * G / GH, B), kThreadsWg threads,
// P = kRows / GH. The block's kRows rows are the (head, position) pairs of
// its GH heads, head-major: row r is head h0 + r / P at position q0 + r %
// P (rows from GH P on are padding, zero, never written), so every K/V
// tile serves all GH heads; warpgroup w computes rows 64 w .. 64 w + 63.
// The threads store Q; thread 0 loads a ring of kStages K/V tiles with
// TMA, kAhead tiles ahead of the one in use: a stage's "full" mbarrier
// completes when its bytes have landed, its "empty" one when every warp is
// done with it, and a stage is refilled only once all warps have finished
// the tile it held, two tiles back, so the warpgroups drift apart instead
// of meeting at a block barrier. tk and tv are 4-D TMA views (D, then
// position, head and batch in stride order, perm). Same masks, tile
// skipping and order as flash_kernel.
template <int D>
__global__ void __launch_bounds__(kThreadsWg, 1)
flash_wgmma_kernel(const bf16* __restrict__ q,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   bf16* __restrict__ out, int H, int KH, int GH, int Sq,
                   int kv_valid, int causal, int window, int perm,
                   long long q_sb, long long q_sh, long long q_ss,
                   long long o_sb, long long o_sh, long long o_ss,
                   float scale_log2) {
  using C = WgCfg<D>;
  constexpr int NT = D / 8;  // n-tiles of the output
  extern __shared__ float4 smem4[];
  // the swizzle repeats every 1 KB: tiles start on a 1 KB boundary
  char* base = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem4) + 1023) & ~uintptr_t(1023));
  bf16* Qs = reinterpret_cast<bf16*>(base);  // [kRows x D]
  bf16* ring = Qs + kRows * D;               // kStages x {K, V} [64 x D]
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + kStages * 2 * C::tile_elems);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int P = kRows / GH;                   // positions a block
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest tiles first
  const int G = H / KH, n_hg = G / GH;
  const int kh = blockIdx.y / n_hg;
  const int h0 = kh * G + (blockIdx.y % n_hg) * GH;
  const int b = blockIdx.z;
  const int q0 = qt * P;
  const int q_end = min(q0 + P, Sq);
  int k_hi = kv_valid;
  if (causal) k_hi = min(k_hi, q_end);
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_first = (k_lo / kBK) * kBK;
  const int n_tiles = k_hi > k_first ? (k_hi - k_first + kBK - 1) / kBK : 0;

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
    const int kt0 = k_first + t * kBK;
    bf16* ks = ring + s * 2 * C::tile_elems;
    bar_expect(full + s, 2 * C::tile_bytes);
#pragma unroll
    for (int c = 0; c < D / C::CB; ++c) {
      tma_box(ks + c * C::CB * kBK, &tk, full + s, c * C::CB, kt0, kh, b,
              perm);
      tma_box(ks + C::tile_elems + c * C::CB * kBK, &tv, full + s, c * C::CB,
              kt0, kh, b, perm);
    }
  };
  if (tid == 0)
    for (int t = 0; t < kAhead && t < n_tiles; ++t) issue(t);
  // Q: 16-byte chunk c of row r, zero for padding rows and past Sq
  for (int i = tid; i < kRows * (D / 8); i += kThreadsWg) {
    const int r = i % kRows, c = i / kRows;
    const int pos = q0 + r % P;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < GH * P && pos < Sq)
      x = *reinterpret_cast<const uint4*>(q + b * q_sb + (h0 + r / P) * q_sh +
                                          pos * q_ss + c * 8);
    *reinterpret_cast<uint4*>(base + C::at(kRows, r, c * 8)) = x;
  }
  // the stores went through the generic proxy; wgmma reads through the
  // async one
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int wg = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = wg * 64 + (warp & 3) * 16 + g;  // this thread's rows r0, + 8
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};

  // Per tile t: S_t = Q K_t^T and O += P_{t-1} V_{t-1} go to the tensor
  // cores together; the softmax of S_t runs while the second is in flight,
  // and O is rescaled once it has landed.
  uint32_t pk[kBK / 16][4];  // P of the previous tile, as the A operand
  for (int t = 0; t < n_tiles; ++t) {
    if (tid == 0 && t + kAhead < n_tiles) issue(t + kAhead);
    __syncwarp();
    const int s = t % kStages;
    bar_wait(full + s, (t / kStages) & 1);
    const bf16* ks = ring + s * 2 * C::tile_elems;
    const int kt0 = k_first + t * kBK;

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

    // online softmax per row in base 2 (a row's 64 scores lie in one
    // quad: sc[4 j + 2 h2 + e] is row r0 + 8 h2, key 8 j + 2 t4 + e); the
    // mask only where the tile cuts the block's positions
    const bool full_tile = kt0 + kBK <= kv_valid &&
                           (!causal || kt0 + kBK - 1 <= q0) &&
                           (window <= 0 || kt0 > q_end - 1 - window);
    float corr[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int qpos = q0 + (r0 + 8 * h2) % P;
      if (!full_tile) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kpos = kt0 + j * 8 + 2 * t4 + e;
            const bool ok = kpos < kv_valid && (!causal || kpos <= qpos) &&
                            (window <= 0 || kpos > qpos - window);
            if (!ok) sc[4 * j + 2 * h2 + e] = -INFINITY;
          }
      }
      float mx4[4];  // a tree of maxima: short dependency chains
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mx4[i] = fmaxf(fmaxf(sc[8 * i + 2 * h2], sc[8 * i + 2 * h2 + 1]),
                       fmaxf(sc[8 * i + 4 + 2 * h2], sc[8 * i + 5 + 2 * h2]));
      float mx = fmaxf(fmaxf(mx4[0], mx4[1]), fmaxf(mx4[2], mx4[3]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[h2], mx * scale_log2);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      corr[h2] = ex2(m_r[h2] - m_safe);  // m -inf: 0
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * j + 2 * h2 + e];
          x = ex2(fmaf(x, scale_log2, -m_safe));  // masked: 0
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
  if (n_tiles > 0) {  // the last tile's P V
    wg_fence();
    pv_step<D>(o, pk, ring + ((n_tiles - 1) % kStages) * 2 * C::tile_elems +
                          C::tile_elems);
    wg_commit();
    wg_wait<0>();
  }

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = r0 + 8 * h2, qpos = q0 + r % P;
    if (r >= GH * P || qpos >= Sq) continue;
    bf16* ob = out + b * o_sb + (h0 + r / P) * o_sh;
    const float lsafe = fmaxf(l_r[h2], 1e-30f);  // no visible key: 0
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(ob + qpos * o_ss + n * 8 + 2 * t4) =
          __floats2bfloat162_rn(o[4 * n + 2 * h2] / lsafe,
                                o[4 * n + 2 * h2 + 1] / lsafe);
  }
}


template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* out, int B, int H, int KH, int GH, int Sq,
                         int kv_mem, int kv_valid, int causal, int window,
                         long long q_sb, long long q_sh, long long q_ss,
                         long long kv_sb, long long kv_sh, long long kv_ss,
                         long long o_sb, long long o_sh, long long o_ss,
                         cudaStream_t stream) {
  if (GH < 1 || GH > 4 || (H / KH) % GH != 0) return cudaErrorInvalidValue;
  CUtensorMap tk, tv;
  int perm;
  cudaError_t err =
      make_view(&tk, k, D, kv_mem, KH, B, kv_ss, kv_sh, kv_sb, &perm);
  if (err == cudaSuccess)
    err = make_view(&tv, v, D, kv_mem, KH, B, kv_ss, kv_sh, kv_sb, &perm);
  if (err != cudaSuccess) return err;
  auto* kernel = &flash_wgmma_kernel<D>;
  err = repro::allow_smem(kernel, WgCfg<D>::smem_bytes);
  if (err != cudaSuccess) return err;
  const int P = kRows / GH;
  const dim3 grid((Sq + P - 1) / P, H / GH, B);
  kernel<<<grid, kThreadsWg, WgCfg<D>::smem_bytes, stream>>>(
      static_cast<const bf16*>(q), tk, tv, static_cast<bf16*>(out), H, KH, GH,
      Sq, kv_valid, causal, window, perm, q_sb, q_sh, q_ss, o_sb, o_sh, o_ss,
      repro::inv_sqrt(D) * kLog2e);
  return cudaGetLastError();
}

struct LaunchFn {
  const void *q, *k, *v;
  void* out;
  int B, H, KH, GH, Sq, kv_mem, kv_valid, causal, window;
  long long q_sb, q_sh, q_ss, kv_sb, kv_sh, kv_ss, o_sb, o_sh, o_ss;
  cudaStream_t stream;
  cudaError_t* err;
  template <typename T, int D>
  void operator()() const {
    if constexpr (std::is_same<T, bf16>::value) {
      *err = launch_wgmma<D>(q, k, v, out, B, H, KH, GH, Sq, kv_mem, kv_valid,
                             causal, window, q_sb, q_sh, q_ss, kv_sb, kv_sh,
                             kv_ss, o_sb, o_sh, o_ss, stream);
    } else {
      using C = TileCfg<D, kRT>;
      auto* kernel = &flash_kernel<T, D>;
      *err = repro::allow_smem(kernel, C::smem_bytes);
      if (*err != cudaSuccess) return;
      const dim3 grid((Sq + C::BQ - 1) / C::BQ, H, B);
      kernel<<<grid, repro::kTileThreads, C::smem_bytes, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(out), H, KH, Sq, kv_mem,
          kv_valid, causal, window, q_sb, q_sh, q_ss, kv_sb, kv_sh, kv_ss,
          o_sb, o_sh, o_ss, repro::inv_sqrt(D));
      *err = cudaGetLastError();
    }
  }
};

struct QueryFn {
  int *blocks, *regs, *smem, *threads;
  cudaError_t* err;
  template <typename T, int D>
  void operator()() const {
    if constexpr (std::is_same<T, bf16>::value) {
      *threads = kThreadsWg;
      *err = repro::occupancy(&flash_wgmma_kernel<D>, kThreadsWg,
                              WgCfg<D>::smem_bytes, blocks, regs, smem);
    } else {
      *threads = repro::kTileThreads;
      *err = repro::occupancy(&flash_kernel<T, D>, repro::kTileThreads,
                              TileCfg<D, kRT>::smem_bytes, blocks, regs, smem);
    }
  }
};

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q [B, H, Sq, D], k/v [B, KH, Skv, D]
// and out [B, H, Sq, D] as element strides of their batch, head and
// position dims (k and v share theirs), last dim contiguous. kv_valid <=
// Skv masks the real KV length. GH: query heads a bf16 block holds (1..4,
// dividing G = H / KH; the f32 path ignores it). Returns the cudaError_t
// of the launch (0 = success); cudaErrorInvalidValue when (dtype, D, GH)
// has no instantiation.
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* out, int B, int H, int KH, int D, int Sq,
                          int Skv, int kv_valid, int causal, int window,
                          int GH, long long q_sb, long long q_sh,
                          long long q_ss, long long kv_sb, long long kv_sh,
                          long long kv_ss, long long o_sb, long long o_sh,
                          long long o_ss, int dtype, void* stream) {
  if (B <= 0 || KH <= 0 || H % KH != 0 || Sq <= 0 || Skv <= 0 ||
      kv_valid < 0 || kv_valid > Skv || window < 0 || GH <= 0 ||
      (H / KH) % GH != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  const LaunchFn f{q, k, v, out, B, H, KH, GH, Sq, Skv, kv_valid, causal,
                   window, q_sb, q_sh, q_ss, kv_sb, kv_sh, kv_ss, o_sb, o_sh,
                   o_ss, static_cast<cudaStream_t>(stream), &err};
  if (!repro::dispatch_dtype_d(dtype, D, f)) return (int)cudaErrorInvalidValue;
  return (int)err;
}

// Occupancy of one (dtype, D) instantiation: resident blocks per SM,
// registers per thread, shared bytes (static + dynamic), threads a block.
int repro_flash_occupancy(int dtype, int D, int* blocks_per_sm, int* regs,
                          int* smem_bytes, int* threads) {
  cudaError_t err = cudaSuccess;
  const QueryFn f{blocks_per_sm, regs, smem_bytes, threads, &err};
  if (!repro::dispatch_dtype_d(dtype, D, f)) return (int)cudaErrorInvalidValue;
  return (int)err;
}

}  // extern "C"
