// Building blocks of the port's attention kernels.
//
//   lse_merge_kernel      combines the f32 (acc, m, l) partial slots of
//                         every row: normalised output in the caller's
//                         dtype, or one combined partial (the split-KV
//                         decodes of split_kv.cuh and the prefix halves of
//                         prefix_attention.cu write the slots).
//   tile_attend           a 256-thread block's online softmax of a tile of
//                         BQ query rows (16 * RT) against a key range, in
//                         64-key tiles staged through shared memory as f32,
//                         with CUDA-core products: S = Q K^T as RT x 4 scores
//                         per thread, P V as RT x D/16 outputs per thread.
//                         The f32 paths of flash and shared-prefix decode
//                         (f32 accuracy, so no tensor cores); the bf16 ones
//                         run on wgmma (wgmma.cuh).
//
// What bounds them: the merge reads n_slots f32 partials per output
// element once (bytes); tile_attend's f32 FMAs (operations: the CUDA
// cores' 67 TFLOP/s, not the tensor cores'). Not done yet (later work):
// cp.async or TMA staging in tile_attend; a merge fused into the kernels
// that write the partials.
//
// Layouts: K/V rows are reached through element strides (batch, head,
// position), the last dim contiguous, so one kernel reads both the
// head-major [B, KH, S, D] layout and the model layout [B, S, KH, D] in
// place. The wrappers check that every base and stride is 16-byte aligned.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kMergeThreads = 128;
constexpr int kTileThreads = 256;   // a 16 x 16 grid of threads
constexpr int kTileK = 64;          // keys per shared-memory tile

// ---------------------------------------------------------------------------
// LSE merge of the slots of every row
// ---------------------------------------------------------------------------

// One thread per (row, column). Row r = (bk, g) with bk = r / G indexes a
// partial buffer [B*KH, n_slots, G, D]. With out: out[r, d] = the merged,
// normalised value in T. Without: the combined unnormalised partial
// (acc_out [rows, D], m_out and l_out [rows]), as the Pallas prefix kernel
// returns it. Same arithmetic as lse_merge in the JAX package.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
lse_merge_kernel(const float* __restrict__ acc, const float* __restrict__ m,
                 const float* __restrict__ l, int rows, int G, int n_slots,
                 int D, T* __restrict__ out, float* __restrict__ acc_out,
                 float* __restrict__ m_out, float* __restrict__ l_out) {
  const long long idx = (long long)blockIdx.x * kMergeThreads + threadIdx.x;
  if (idx >= (long long)rows * D) return;
  const int row = (int)(idx / D), d = (int)(idx % D);
  const size_t base = (size_t)(row / G) * n_slots * G + row % G;
  float mx = -INFINITY;
  for (int s = 0; s < n_slots; ++s) mx = fmaxf(mx, m[base + (size_t)s * G]);
  const float m_safe = mx == -INFINITY ? 0.f : mx;
  float lt = 0.f, o = 0.f;
  for (int s = 0; s < n_slots; ++s) {
    const size_t r = base + (size_t)s * G;
    const float w = expf(m[r] - m_safe);
    lt += l[r] * w;
    o += acc[r * D + d] * w;
  }
  if (out != nullptr) {
    store(out + idx, o / fmaxf(lt, 1e-30f));
  } else {
    acc_out[idx] = o;
    if (d == 0) {
      m_out[row] = mx;
      l_out[row] = lt;
    }
  }
}

template <typename T>
cudaError_t launch_lse_merge(const float* acc, const float* m, const float* l,
                             int rows, int G, int n_slots, int D, T* out,
                             float* acc_out, float* m_out, float* l_out,
                             cudaStream_t stream) {
  const long long n = (long long)rows * D;
  const int blocks = (int)((n + kMergeThreads - 1) / kMergeThreads);
  lse_merge_kernel<T><<<blocks, kMergeThreads, 0, stream>>>(
      acc, m, l, rows, G, n_slots, D, out, acc_out, m_out, l_out);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tiled online softmax (flash and prefix)
// ---------------------------------------------------------------------------

template <int D, int RT>
struct TileCfg {
  static constexpr int BQ = 16 * RT;                  // query rows
  static constexpr int BK = kTileK;                   // keys per tile
  static constexpr int PQ = BQ + 4;                   // padded row of P^T
  static constexpr int CW = D / 16;                   // out columns a thread
  static constexpr int VW = CW < 4 ? CW : 4;          // ... per vector
  static constexpr int NC = CW / VW;                  // vectors a thread
  // Q^T [D][BQ], K^T [D][BK], V [BK][D], P^T [BK][PQ], all f32
  static constexpr size_t smem_bytes =
      sizeof(float) * ((size_t)D * BQ + (size_t)D * BK + (size_t)BK * D +
                       (size_t)BK * PQ);
  // thread (tx, ty) of the 16 x 16 grid owns rows ty*RT + i, score columns
  // tx + 16*j of each key tile, and out columns col(tx, cc, e) below
  __device__ static int col(int tx, int cc, int e) {
    return cc * 16 * VW + tx * VW + e;
  }
};

template <int N>
__device__ __forceinline__ void lds(const float* p, float* out) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x; out[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = p[i];
  }
}

// The block's online softmax over keys [k_first, k_hi) in 64-key tiles.
// q_row(r) is the address of tile row r's D elements, or nullptr for a row
// past the end (loaded as 0, never written by the caller). Keys at or past
// k_mem are not in memory and load as 0. A key is visible to row r when
// key < k_valid, and key <= q0 + r when causal, and key > q0 + r - window
// when window > 0 (positions from 0 on both sides, as the Pallas kernel).
// Leaves each thread's rows' unnormalised acc, running max m (-inf for a
// row that saw no visible key) and sum l, replicated over the 16 threads
// of a row group (tx).
template <typename T, int D, int RT, typename QRow>
__device__ __forceinline__ void tile_attend(
    float* smem, const QRow& q_row, const T* __restrict__ kb,
    const T* __restrict__ vb, long long kv_ss, int k_first, int k_hi,
    int k_mem, int k_valid, bool causal, int window, int q0, float scale,
    float (&acc)[RT][D / 16], float (&m)[RT], float (&l)[RT]) {
  using C = TileCfg<D, RT>;
  constexpr int BQ = C::BQ, BK = C::BK, PQ = C::PQ, VW = C::VW, NC = C::NC;
  constexpr int kVec = Vec<T>::n;
  constexpr int kChunks = D / kVec;
  static_assert(D % 16 == 0 && D % kVec == 0, "unsupported head width");
  static_assert(RT % 4 == 0, "rows per thread come in float4s");
  float* Qt = smem;
  float* Kt = Qt + D * BQ;
  float* Vs = Kt + D * BK;
  float* Pt = Vs + BK * D;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
  }
  for (int idx = tid; idx < BQ * kChunks; idx += kTileThreads) {
    const int r = idx % BQ, c = idx / BQ;
    const T* p = q_row(r);
    float x[kVec];
    if (p != nullptr) {
      load16(p + c * kVec, x);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) Qt[(c * kVec + e) * BQ + r] = x[e];
  }

  for (int kt0 = k_first; kt0 < k_hi; kt0 += BK) {
    // K^T: neighbouring threads take neighbouring keys (conflict-free
    // stores); V row-major with 16-byte stores
    for (int idx = tid; idx < BK * kChunks; idx += kTileThreads) {
      const int kk = idx % BK, c = idx / BK;
      const int pos = kt0 + kk;
      float x[kVec];
      if (pos < k_mem) {
        load16(kb + pos * kv_ss + c * kVec, x);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) x[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) Kt[(c * kVec + e) * BK + kk] = x[e];
    }
    for (int idx = tid; idx < BK * kChunks; idx += kTileThreads) {
      const int kk = idx / kChunks, c = idx % kChunks;
      const int pos = kt0 + kk;
      float x[kVec];
      if (pos < k_mem) {
        load16(vb + pos * kv_ss + c * kVec, x);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) x[e] = 0.f;
      }
      float4* dst = reinterpret_cast<float4*>(Vs + kk * D + c * kVec);
#pragma unroll
      for (int e = 0; e < kVec; e += 4)
        dst[e / 4] = make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
    }
    __syncthreads();

    float s[RT][4];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RT], kv[4];
#pragma unroll
      for (int rr = 0; rr < RT; rr += 4) lds<4>(Qt + d * BQ + ty * RT + rr, qv + rr);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Kt[d * BK + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int qpos = q0 + ty * RT + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = kt0 + tx + 16 * j;
        const bool ok = kpos < k_valid && (!causal || kpos <= qpos) &&
                        (window <= 0 || kpos > qpos - window);
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float corr = m[i] == -INFINITY ? 0.f : expf(m[i] - m_safe);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_safe);  // masked: exp(-inf) = 0
        sum += s[i][j];
      }
      sum = half_warp_sum(sum);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int rr = 0; rr < RT; rr += 4)
        *reinterpret_cast<float4*>(Pt + (tx + 16 * j) * PQ + ty * RT + rr) =
            make_float4(s[rr][j], s[rr + 1][j], s[rr + 2][j], s[rr + 3][j]);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RT];
#pragma unroll
      for (int rr = 0; rr < RT; rr += 4) lds<4>(Pt + kk * PQ + ty * RT + rr, pv + rr);
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        float vv[VW];
        lds<VW>(Vs + kk * D + C::col(tx, cc, 0), vv);
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int e = 0; e < VW; ++e)
            acc[i][cc * VW + e] = fmaf(pv[i], vv[e], acc[i][cc * VW + e]);
      }
    }
    __syncthreads();  // K^T, V and P^T are rewritten by the next tile
  }
}

}  // namespace repro
