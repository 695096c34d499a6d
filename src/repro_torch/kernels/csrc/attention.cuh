// Building blocks of the port's attention kernels.
//
//   merge_row             one warp's LSE merge of the f32 (acc, m, l)
//                         partial slots of one row: the normalised output
//                         in the caller's dtype, or one combined partial.
//                         The split-KV decodes of split_kv.cuh run it in
//                         the last split block of each (lane, KV head);
//   lse_merge_kernel      merge_row over every row, one warp a row, for
//                         the partials that no split block merges: the
//                         slot shards of a tensor-parallel pool and the
//                         two halves of shared-prefix decode;
//   tile_attend           a 256-thread block's online softmax of a tile of
//                         BQ query rows (16 * RT) against a key range, in
//                         64-key tiles staged through shared memory as f32,
//                         with CUDA-core products: S = Q K^T as RT x 4 scores
//                         per thread, P V as RT x D/16 outputs per thread.
//                         The f32 paths of flash and shared-prefix decode
//                         (f32 accuracy, so no tensor cores); the bf16 ones
//                         run on wgmma (wgmma.cuh).
//
// What bounds the merge: not its bytes. It reads n_slots f32 partials of
// each output element once, 0.1-0.5 MB at the shapes served, a fraction of
// a microsecond at the HBM rate; what it costs is latency (a chain of
// dependent loads: the slots' maxima, then their weights, then acc) and,
// as a kernel of its own, a launch. What the design does about it: one
// warp a row, so m and l are read once a slot by parallel lanes (32 slots
// a load), the maximum taken with shuffles and each slot's weight computed
// once and broadcast; each lane holds D / 32 columns as one vector and
// issues the acc loads of 8 slots before it uses any. The split-KV decodes
// need no launch for it at all: their last block merges (split_kv.cuh).
// The arithmetic is the one-thread-per-element merge's (the JAX package's
// lse_merge), slot by slot in index order, so every merge of the same
// partials gives the same bits, wherever it runs. What bounds tile_attend:
// its f32 FMAs (operations: the CUDA cores' 67 TFLOP/s, not the tensor
// cores'). Not done yet (later work): cp.async or TMA staging in
// tile_attend.
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
// LSE merge of the slots of a row
// ---------------------------------------------------------------------------

// n (1, 2 or 4) consecutive f32 from global memory, cached in L2 only
// (__ldcg: the slots may have been written by other SMs in this launch,
// and L1 is not coherent across SMs). p is 4 * n-byte aligned.
template <int N>
__device__ __forceinline__ void ldcg_vec(const float* p, float* out) {
  if constexpr (N == 4) {
    const float4 t = __ldcg(reinterpret_cast<const float4*>(p));
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = __ldcg(reinterpret_cast<const float2*>(p));
    out[0] = t.x; out[1] = t.y;
  } else {
    static_assert(N == 1, "1, 2 or 4 floats");
    out[0] = __ldcg(p);
  }
}

// One warp merges the n_slots partials of one row. Slot s of the row is
// partial row r = row0 + s * stride: acc [r * D, r * D + D), m[r] (natural
// log, -inf when the slot saw no key) and l[r]. With out: out[orow * D +
// d] = the normalised merge in T (0 when every slot is empty). Without:
// the combined unnormalised partial acc_out[orow * D + d], m_out[orow],
// l_out[orow]. Called by all 32 lanes of the warp.
template <typename T, int D>
__device__ __forceinline__ void merge_row(
    const float* __restrict__ acc, const float* __restrict__ m,
    const float* __restrict__ l, size_t row0, int stride, int n_slots,
    T* __restrict__ out, float* __restrict__ acc_out,
    float* __restrict__ m_out, float* __restrict__ l_out, size_t orow) {
  constexpr int VW = D >= 32 ? D / 32 : 1;  // columns a lane holds
  constexpr int U = 8;                       // acc loads issued together
  constexpr int kCached = 2;                 // chunks of 32 slots whose m
                                             // and l stay in registers
  static_assert(D % 32 == 0 || D == 16, "unsupported head width");
  const int lane = threadIdx.x & 31;
  const int c0 = lane * VW < D ? lane * VW : 0;  // D 16: lanes 16-31 idle
  auto slot = [&](int s) { return row0 + (size_t)s * stride; };

  // the slots' maxima, 32 slots a load
  float mc[kCached], lc[kCached];
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < kCached; ++j) {
    const int s = j * 32 + lane;
    mc[j] = s < n_slots ? __ldcg(m + slot(s)) : -INFINITY;
    lc[j] = s < n_slots ? __ldcg(l + slot(s)) : 0.f;
    mx = fmaxf(mx, mc[j]);
  }
  for (int s = kCached * 32 + lane; s < n_slots; s += 32)
    mx = fmaxf(mx, __ldcg(m + slot(s)));
  mx = warp_max(mx);
  const float m_safe = mx == -INFINITY ? 0.f : mx;

  // slots [s0, s0 + 32): lane i holds slot s0 + i's weight w and l, which
  // every lane takes by shuffle, slot by slot in index order
  float lt = 0.f, o[VW];
#pragma unroll
  for (int e = 0; e < VW; ++e) o[e] = 0.f;
  auto chunk = [&](int s0, float w, float ls) {
    const int n = min(32, n_slots - s0);
    for (int u0 = 0; u0 < n; u0 += U) {
      float a[U][VW];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (u0 + u < n) ldcg_vec<VW>(acc + slot(s0 + u0 + u) * D + c0, a[u]);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u0 + u < n) {  // the same for every lane
          const float wu = __shfl_sync(0xffffffffu, w, u0 + u);
          const float lu = __shfl_sync(0xffffffffu, ls, u0 + u);
          lt = fmaf(lu, wu, lt);
#pragma unroll
          for (int e = 0; e < VW; ++e) o[e] = fmaf(a[u][e], wu, o[e]);
        }
      }
    }
  };
#pragma unroll
  for (int j = 0; j < kCached; ++j)
    if (j * 32 < n_slots) chunk(j * 32, expf(mc[j] - m_safe), lc[j]);
  for (int s0 = kCached * 32; s0 < n_slots; s0 += 32) {
    const int s = s0 + lane;
    const float ms = s < n_slots ? __ldcg(m + slot(s)) : -INFINITY;
    const float ls = s < n_slots ? __ldcg(l + slot(s)) : 0.f;
    chunk(s0, expf(ms - m_safe), ls);  // exp(-inf) = 0
  }

  if (lane * VW >= D) return;
  if (out != nullptr) {
    const float den = fmaxf(lt, 1e-30f);
#pragma unroll
    for (int e = 0; e < VW; ++e) store(out + orow * D + c0 + e, o[e] / den);
  } else {
#pragma unroll
    for (int e = 0; e < VW; ++e) acc_out[orow * D + c0 + e] = o[e];
    if (lane == 0) {
      m_out[orow] = mx;
      l_out[orow] = lt;
    }
  }
}

// One warp a row, kMergeThreads / 32 rows a block. Row r = (bk, g) with
// bk = r / G indexes a partial buffer [B*KH, n_slots, G, D] (m and l
// [B*KH, n_slots, G]); out, or acc_out / m_out / l_out, as merge_row.
template <typename T, int D>
__global__ void __launch_bounds__(kMergeThreads)
lse_merge_kernel(const float* __restrict__ acc, const float* __restrict__ m,
                 const float* __restrict__ l, int rows, int G, int n_slots,
                 T* __restrict__ out, float* __restrict__ acc_out,
                 float* __restrict__ m_out, float* __restrict__ l_out) {
  const int row = blockIdx.x * (kMergeThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp
  merge_row<T, D>(acc, m, l, (size_t)(row / G) * n_slots * G + row % G, G,
                  n_slots, out, acc_out, m_out, l_out, (size_t)row);
}

struct MergeLaunch {
  const float *acc, *m, *l;
  int rows, G, n_slots;
  void* out;
  float *acc_out, *m_out, *l_out;
  cudaStream_t stream;
  template <typename T, int D>
  void operator()() const {
    const int blocks = (rows + kMergeThreads / 32 - 1) / (kMergeThreads / 32);
    lse_merge_kernel<T, D><<<blocks, kMergeThreads, 0, stream>>>(
        acc, m, l, rows, G, n_slots, static_cast<T*>(out), acc_out, m_out,
        l_out);
  }
};

// Launch lse_merge_kernel: out in T, or (out == nullptr) the combined
// partial. cudaErrorInvalidValue for a head width with no instantiation.
template <typename T>
cudaError_t launch_lse_merge(const float* acc, const float* m, const float* l,
                             int rows, int G, int n_slots, int D, T* out,
                             float* acc_out, float* m_out, float* l_out,
                             cudaStream_t stream) {
  const MergeLaunch f{acc, m, l, rows, G, n_slots, out, acc_out, m_out,
                      l_out, stream};
  if (!dispatch_d<T>(D, f)) return cudaErrorInvalidValue;
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
