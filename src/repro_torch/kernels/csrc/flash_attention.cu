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
#include <cuda.h>  // CUtensorMap (its encoder is fetched at run time)

#include <algorithm>
#include <type_traits>

#include "attention.cuh"

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

using bf16 = __nv_bfloat16;
constexpr int kWG = 2;        // warpgroups a block
constexpr int kRows = 64 * kWG;  // (head, position) rows a block
constexpr int kThreadsWg = 128 * kWG;
constexpr int kBK = 64;       // keys per tile
constexpr int kStages = 4;    // K/V tiles in the ring
constexpr int kAhead = kStages - 2;  // tiles loaded ahead of the one in use
constexpr float kLog2e = 1.4426950408889634f;

// Tiles sit in shared memory in the layout TMA writes with a swizzle and
// wgmma reads back: the columns in blocks of CB = min(D, 64) (rows of RB =
// 2 CB bytes; D 128 has two blocks, kept apart), each block's rows
// back to back, and each 16-byte chunk j of row r moved to j ^ (r's bits
// above the chunk), the "128B" (or, for D 32 and 16, "64B" and "32B")
// swizzle, so that a wgmma's eight rows of one chunk fall on different
// banks. A K/V tile (64 rows) is D / CB TMA boxes of CB columns x 64 rows;
// Q (kRows rows) is stored by the threads with the same XOR.
template <int D>
struct WgCfg {
  static constexpr int CB = D < 64 ? D : 64;  // columns a block
  static constexpr int RB = 2 * CB;           // bytes a row of a block
  static constexpr int SW = RB == 128 ? 3 : (RB == 64 ? 2 : 1);  // XOR bits
  static constexpr int layout = 4 - SW;  // descriptor: 1 128B, 2 64B, 3 32B
  static constexpr int tile_elems = kBK * D;
  static constexpr uint32_t tile_bytes = tile_elems * sizeof(bf16);
  static constexpr size_t smem_bytes =
      1024 /* alignment slack */ + 128 /* 2 kStages mbarriers */ +
      sizeof(bf16) * ((size_t)kRows * D + (size_t)kStages * 2 * tile_elems);
  // byte offset of (row r, column c) in a tile of n rows, swizzled
  __device__ static uint32_t at(int n, int r, int c) {
    const uint32_t o = (c / CB) * n * RB + r * RB + (c % CB) * 2;
    return o ^ (((o >> 7) & ((1u << SW) - 1)) << 4);
  }
};

// 64-bit wgmma shared-memory descriptor: start address, the "leading" and
// "stride" byte offsets and the swizzle (layout). For a swizzled K-major
// operand, sbo is the stride of 8-row groups (lbo unused) and k advances
// by moving the start inside the row; for an MN-major one (V, read
// transposed), lbo is the stride of the column blocks, sbo that of 8-row
// groups.
__device__ __forceinline__ uint64_t smem_desc(const void* p, int lbo, int sbo,
                                              int layout) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

// d (m64 n64, f32) = A K^T over k16 (+ d when scale_d): A and B from
// shared-memory descriptors, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 16) wgmma_rs_n16(o, a, db);
  else if constexpr (D == 32) wgmma_rs_n32(o, a, db);
  else if constexpr (D == 64) wgmma_rs_n64(o, a, db);
  else wgmma_rs_n128(o, a, db);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// O += P V over a 64-key tile: P from registers (pk[u]: keys 16 u .. 16 u +
// 15), V from shared memory read transposed (MN-major), no transposed copy.
template <int D>
__device__ __forceinline__ void pv_step(float (&o)[D / 2],
                                        const uint32_t (&pk)[kBK / 16][4],
                                        const bf16* vs) {
#pragma unroll
  for (int u = 0; u < kBK / 16; ++u)
    wgmma_pv<D>(o, pk[u], smem_desc(reinterpret_cast<const char*>(vs) +
                                        u * 16 * WgCfg<D>::RB,
                                    kBK * WgCfg<D>::RB, 8 * WgCfg<D>::RB,
                                    WgCfg<D>::layout));
}

// 2^x, flushing a subnormal result to 0 (a probability under 2^-126 of
// the row's largest: nothing the f32 sums can see).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               ::"r"(smem_u32(bar))
               : "memory");
}
// Arrive on bar and expect `bytes` more to land on it (from TMA).
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One TMA box (CB columns x 64 rows, swizzled, zero past the tensor's end)
// of the 4-D view m into dst, completing on bar. Coordinates: column c0,
// then the position, head and batch index at the map's dims 1-3 as `perm`
// orders them (dims sorted by stride on the host: 2 bits a dim, s | h << 2
// | b << 4).
__device__ __forceinline__ void tma_box(bf16* dst, const CUtensorMap* m,
                                        uint64_t* bar, int c0, int pos,
                                        int head, int batch, int perm) {
  int x[4];
  x[0] = c0;
  x[perm & 3] = pos;
  x[(perm >> 2) & 3] = head;
  x[(perm >> 4) & 3] = batch;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(x[0]), "r"(x[1]), "r"(x[2]),
      "r"(x[3]), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo: low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

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

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// The driver's tensor-map encoder, fetched through the runtime (no link
// against libcuda).
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 4-D TMA view of a bf16 tensor with D contiguous columns and position,
// head and batch dims of the given sizes and element strides: boxes of
// min(D, 64) columns x 64 positions, swizzled as WgCfg<D> lays tiles out,
// zero past the end. The three outer dims are put
// in stride order (a dim of size 1 last, with a stride past every other),
// as the encoder wants; *perm says where each landed (see tma_box).
cudaError_t make_view(CUtensorMap* m, const void* base, int D, int S, int Hn,
                      int Bn, long long ss, long long sh, long long sb,
                      int* perm) {
  struct Dim {
    long long size, stride;
    cuuint32_t box;
    int id;
  } d[3] = {{S, ss, (cuuint32_t)kBK, 0}, {Hn, sh, 1, 1}, {Bn, sb, 1, 2}};
  const int cb = D < 64 ? D : 64;  // WgCfg<D>::CB
  long long past = 8;  // elements: a stride past every stepped dim
  for (const Dim& x : d)
    if (x.size > 1) past = std::max(past, x.size * x.stride);
  past = (past + 7) / 8 * 8;
  for (Dim& x : d)
    if (x.size <= 1) x.stride = past;
  std::sort(d, d + 3, [](const Dim& a, const Dim& b) {
    return a.stride < b.stride || (a.stride == b.stride && a.id < b.id);
  });
  cuuint64_t dims[4] = {(cuuint64_t)D, 0, 0, 0}, strides[3];
  cuuint32_t box[4] = {(cuuint32_t)cb, 1, 1, 1}, estr[4] = {1, 1, 1, 1};
  *perm = 0;
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = (cuuint64_t)d[i].size;
    strides[i] = (cuuint64_t)d[i].stride * sizeof(bf16);
    box[i + 1] = d[i].box;
    *perm |= (i + 1) << (2 * d[i].id);
  }
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const CUresult r = encode(
      m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      cb == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
               : (cb == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B),
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
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
