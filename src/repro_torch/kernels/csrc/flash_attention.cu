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
// is the visible pairs' flops over the tensor-core peak.
//
// What the design does about it:
//   * one block per (64-query tile, head, lane) runs the online softmax
//     over 64-key tiles in a loop inside the block (the TPU's sequential
//     grid axis);
//   * bf16 inputs go to the tensor cores: 4 warps of 16 query rows each
//     run mma.sync m16n8k16 (bf16 in, f32 accumulate) for S = Q K^T from
//     padded (bank-conflict-free) bf16 tiles of Q, K and V^T in shared
//     memory, keep S, the running max and sum and O in registers, and feed
//     P back as the A operand of P V straight from the S registers (rounded
//     to bf16, as the Pallas kernel's p.astype(v.dtype); the row sums stay
//     f32);
//   * f32 inputs keep f32 accuracy on the CUDA cores: 256 threads stage Q,
//     K^T, V and P^T through shared memory as f32 and each computes 4 x 4
//     scores and 4 x D/16 outputs (tile_attend in attention.cuh);
//   * the block visits only the key tiles that hold a visible key: tiles
//     wholly above the diagonal, left of every row's window or past kv_len
//     are never loaded (the TPU grid still steps through them);
//   * blocks are launched longest first (the last query tile of a causal
//     prefill has the most keys), so the tail of the grid is short;
//   * q, k, v and out are read and written in place through element
//     strides, so the model layout [B, S, H, D] needs no transposed copy.
// Not done yet (later work): wgmma with TMA-fed tiles and a pipeline of
// key tiles (the loads here are synchronous), and sharing each K/V tile
// among the G query heads of a KV head.
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
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kMmaThreads = 128;  // 4 warps x 16 query rows
constexpr int kMmaBQ = 64, kMmaBK = 64;

template <int D>
struct MmaCfg {
  static constexpr int QS = D + 8;       // padded bf16 row of Q and K
  static constexpr int VS = kMmaBK + 8;  // padded bf16 row of V^T
  static constexpr size_t smem_bytes =
      sizeof(bf16) * ((size_t)kMmaBQ * QS + (size_t)kMmaBK * QS + (size_t)D * VS);
};

// c += a (16 x 16, row) * b (16 x 8, col); bf16 in, f32 accumulate. Per
// lane (g = lane / 4, t = lane % 4): a[0] rows g, cols 2t..2t+1; a[1] row
// g + 8; a[2], a[3] the same at cols + 8; b[0] rows (k) 2t..2t+1, col (n)
// g; b[1] rows + 8; c[0..1] row g, cols 2t..2t+1; c[2..3] row g + 8.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo: low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// grid (query tiles, H, B), 128 threads; the same masks, tile skipping and
// order as flash_kernel.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, int H,
                 int KH, int Sq, int kv_mem, int kv_valid, int causal,
                 int window, long long q_sb, long long q_sh, long long q_ss,
                 long long kv_sb, long long kv_sh, long long kv_ss,
                 long long o_sb, long long o_sh, long long o_ss, float scale) {
  using C = MmaCfg<D>;
  constexpr int QS = C::QS, VS = C::VS, BQ = kMmaBQ, BK = kMmaBK;
  constexpr int kChunks = D / 8;         // 16-byte chunks of a row
  constexpr int NT = D / 8;              // n-tiles of the output
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);  // [BQ][QS]
  bf16* Ks = Qs + BQ * QS;                    // [BK][QS]
  bf16* Vt = Ks + BK * QS;                    // [D][VS], V transposed
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int q0 = qt * BQ;
  const int q_end = min(q0 + BQ, Sq);
  int k_hi = kv_valid;
  if (causal) k_hi = min(k_hi, q_end);
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_first = (k_lo / BK) * BK;
  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * kv_sb + kh * kv_sh;
  const bf16* vb = v + b * kv_sb + kh * kv_sh;

  for (int idx = tid; idx < BQ * kChunks; idx += kMmaThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < Sq) x = *reinterpret_cast<const uint4*>(qb + (q0 + r) * q_ss + c * 8);
    *reinterpret_cast<uint4*>(Qs + r * QS + c * 8) = x;
  }

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  const int row0 = warp * 16;  // this warp's rows of the tile

  for (int kt0 = k_first; kt0 < k_hi; kt0 += BK) {
    __syncthreads();  // the previous tile's K and V^T are no longer read
    for (int idx = tid; idx < BK * kChunks; idx += kMmaThreads) {
      const int r = idx / kChunks, c = idx % kChunks;
      const int pos = kt0 + r;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (pos < kv_mem) x = *reinterpret_cast<const uint4*>(kb + pos * kv_ss + c * 8);
      *reinterpret_cast<uint4*>(Ks + r * QS + c * 8) = x;
    }
    // V^T: neighbouring threads take neighbouring keys, so the 2-byte
    // stores of a warp land on neighbouring addresses
    for (int idx = tid; idx < BK * kChunks; idx += kMmaThreads) {
      const int r = idx % BK, c = idx / BK;
      const int pos = kt0 + r;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (pos < kv_mem) x = *reinterpret_cast<const uint4*>(vb + pos * kv_ss + c * 8);
      const bf16* e = reinterpret_cast<const bf16*>(&x);
#pragma unroll
      for (int i = 0; i < 8; ++i) Vt[(c * 8 + i) * VS + r] = e[i];
    }
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < D; k0 += 16) {
      const bf16* qa = Qs + (row0 + g) * QS + k0 + 2 * t4;
      const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * QS), ld32(qa + 8),
                             ld32(qa + 8 * QS + 8)};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bf16* kr = Ks + (j * 8 + g) * QS + k0 + 2 * t4;
        const uint32_t bb[2] = {ld32(kr), ld32(kr + 8)};
        mma_bf16(s[j], a, bb);
      }
    }

    // mask, online softmax per row (a row's 64 scores lie in one quad)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int qpos = q0 + row0 + g + 8 * hh;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = kt0 + j * 8 + 2 * t4 + e;
          const bool ok = kpos < kv_valid && (!causal || kpos <= qpos) &&
                          (window <= 0 || kpos > qpos - window);
          float& x = s[j][2 * hh + e];
          x = ok ? x * scale : -INFINITY;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[hh], mx);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float corr = m_r[hh] == -INFINITY ? 0.f : expf(m_r[hh] - m_safe);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[j][2 * hh + e];
          x = expf(x - m_safe);  // masked: exp(-inf) = 0
          sum += x;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_r[hh] = l_r[hh] * corr + sum;
      m_r[hh] = m_new;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][2 * hh] *= corr;
        o[n][2 * hh + 1] *= corr;
      }
    }

    // O += P V: the S fragments of key tiles 2u, 2u + 1 are the A operand
    // of the 16-key step u
#pragma unroll
    for (int u = 0; u < BK / 16; ++u) {
      const uint32_t a[4] = {pack_bf16(s[2 * u][0], s[2 * u][1]),
                             pack_bf16(s[2 * u][2], s[2 * u][3]),
                             pack_bf16(s[2 * u + 1][0], s[2 * u + 1][1]),
                             pack_bf16(s[2 * u + 1][2], s[2 * u + 1][3])};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const bf16* vr = Vt + (n * 8 + g) * VS + u * 16 + 2 * t4;
        const uint32_t bb[2] = {ld32(vr), ld32(vr + 8)};
        mma_bf16(o[n], a, bb);
      }
    }
  }

  bf16* ob = out + b * o_sb + h * o_sh;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qpos = q0 + row0 + g + 8 * hh;
    if (qpos >= Sq) continue;
    const float lsafe = fmaxf(l_r[hh], 1e-30f);  // no visible key: 0
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(ob + qpos * o_ss + n * 8 + 2 * t4) =
          __floats2bfloat162_rn(o[n][2 * hh] / lsafe, o[n][2 * hh + 1] / lsafe);
  }
}

struct LaunchFn {
  const void *q, *k, *v;
  void* out;
  int B, H, KH, Sq, kv_mem, kv_valid, causal, window;
  long long q_sb, q_sh, q_ss, kv_sb, kv_sh, kv_ss, o_sb, o_sh, o_ss;
  cudaStream_t stream;
  cudaError_t* err;
  template <typename T, int D>
  void operator()() const {
    if constexpr (std::is_same<T, bf16>::value) {
      auto* kernel = &flash_mma_kernel<D>;
      *err = repro::allow_smem(kernel, MmaCfg<D>::smem_bytes);
      if (*err != cudaSuccess) return;
      const dim3 grid((Sq + kMmaBQ - 1) / kMmaBQ, H, B);
      kernel<<<grid, kMmaThreads, MmaCfg<D>::smem_bytes, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<bf16*>(out), H, KH, Sq,
          kv_mem, kv_valid, causal, window, q_sb, q_sh, q_ss, kv_sb, kv_sh,
          kv_ss, o_sb, o_sh, o_ss, repro::inv_sqrt(D));
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
    }
    *err = cudaGetLastError();
  }
};

struct QueryFn {
  int *blocks, *regs, *smem;
  cudaError_t* err;
  template <typename T, int D>
  void operator()() const {
    if constexpr (std::is_same<T, bf16>::value)
      *err = repro::occupancy(&flash_mma_kernel<D>, kMmaThreads,
                              MmaCfg<D>::smem_bytes, blocks, regs, smem);
    else
      *err = repro::occupancy(&flash_kernel<T, D>, repro::kTileThreads,
                              TileCfg<D, kRT>::smem_bytes, blocks, regs, smem);
  }
};

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q [B, H, Sq, D], k/v [B, KH, Skv, D]
// and out [B, H, Sq, D] as element strides of their batch, head and
// position dims (k and v share theirs), last dim contiguous. kv_valid <=
// Skv masks the real KV length. Returns the cudaError_t of the launch
// (0 = success); cudaErrorInvalidValue when (dtype, D) has no
// instantiation.
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* out, int B, int H, int KH, int D, int Sq,
                          int Skv, int kv_valid, int causal, int window,
                          long long q_sb, long long q_sh, long long q_ss,
                          long long kv_sb, long long kv_sh, long long kv_ss,
                          long long o_sb, long long o_sh, long long o_ss,
                          int dtype, void* stream) {
  if (B <= 0 || KH <= 0 || H % KH != 0 || Sq <= 0 || Skv <= 0 ||
      kv_valid < 0 || kv_valid > Skv || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  const LaunchFn f{q, k, v, out, B, H, KH, Sq, Skv, kv_valid, causal, window,
                   q_sb, q_sh, q_ss, kv_sb, kv_sh, kv_ss, o_sb, o_sh, o_ss,
                   static_cast<cudaStream_t>(stream), &err};
  if (!repro::dispatch_dtype_d(dtype, D, f)) return (int)cudaErrorInvalidValue;
  return (int)err;
}

// Occupancy of one (dtype, D) instantiation: resident blocks per SM,
// registers per thread, shared bytes (static + dynamic).
int repro_flash_occupancy(int dtype, int D, int* blocks_per_sm, int* regs,
                          int* smem_bytes) {
  cudaError_t err = cudaSuccess;
  const QueryFn f{blocks_per_sm, regs, smem_bytes, &err};
  if (!repro::dispatch_dtype_d(dtype, D, f)) return (int)cudaErrorInvalidValue;
  return (int)err;
}

}  // extern "C"
