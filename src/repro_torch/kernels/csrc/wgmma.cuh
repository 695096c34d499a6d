// Hopper building blocks shared by the bf16 flash and shared-prefix
// kernels: the tile geometry of a swizzled 4-stage K/V ring of 64-key
// tiles for a block of two warpgroups (128 rows), wgmma shared-memory
// descriptors and instructions (bf16 in, f32 accumulate), mbarrier
// pacing, TMA box copies and the tensor-map encoder (fetched from the CUDA
// driver at run time, so no library links against libcuda).
#pragma once

#include <cuda.h>  // CUtensorMap

#include <algorithm>

#include "common.cuh"

namespace repro {
namespace wg {

using bf16 = __nv_bfloat16;
constexpr int kWG = 2;        // warpgroups a block
constexpr int kRows = 64 * kWG;  // (head, position) rows a block
constexpr int kThreadsWg = 128 * kWG;
constexpr int kBK = 64;       // keys per tile
constexpr int kStages = 4;    // K/V tiles in the ring
constexpr int kAhead = kStages - 2;  // tiles loaded ahead of the one in use

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

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// The CUDA driver's tensor-map encoder, fetched through the runtime (no
// link against libcuda).
inline EncodeTiledFn encode_tiled() {
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
inline cudaError_t make_view(CUtensorMap* m, const void* base, int D,
                             int S, int Hn, int Bn, long long ss,
                             long long sh, long long sb, int* perm) {
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

}  // namespace wg
}  // namespace repro
