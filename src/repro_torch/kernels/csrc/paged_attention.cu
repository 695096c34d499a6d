// Paged decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py::
// paged_decode_attention: one-token GQA decode attention over the shared
// KV page pool [n_pages, PS, KH, D], read through a per-lane page table
// [B, P] and masked by the valid lengths lens [B].
//
// What bounds it: memory. Per KV head the block reads every valid K and V
// row once and does 4*G flops per element read (G = H/KH <= 8), far below
// the ~295 flop/byte at which an H100 stops being memory-bound. The least
// traffic is the KV the lanes need, sum_b len_b * KH * D * 2 * itemsize
// bytes, plus q, out and the tables.
//
// What the design does about it:
//   * the pool is read in place. A page's rows for one head are D
//     contiguous elements at a stride of KH*D; the kernel computes those
//     addresses itself, so no transposed or gathered copy of the pool is
//     ever made (the TPU wrapper transposes the whole pool per call);
//   * one block per (KV head, lane) holds the G query rows of that head in
//     shared memory, so each K/V row is read from device memory once for
//     all G heads that share it;
//   * the block walks only the first ceil(len_b / PS) table entries (the
//     TPU grid visits all P pages and masks), with an online softmax in
//     f32 across tiles, and writes [G, D] straight to the output in q's
//     dtype: no partials in device memory and no separate merge pass;
//   * K rows are read with 16-byte vector loads, V columns by neighbouring
//     threads on neighbouring addresses.
// Not done yet (later work): split-KV across blocks to fill 132 SMs at
// small batch, and cp.async/TMA staging of pages into shared memory.
#include "common.cuh"

namespace {

using repro::store;
using repro::to_f32;
using repro::warp_max;
using repro::warp_sum;

constexpr int kThreads = 128;  // one token of the tile per thread
constexpr int kTile = kThreads;

// grid (KH, B), block kThreads. Template: element type T, group G, head D.
template <typename T, int G, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int32_t* __restrict__ page_table,
                    const int32_t* __restrict__ lens, T* __restrict__ out,
                    int H, int KH, int P, int PS, int n_pages, float scale) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kVec = 16 / sizeof(T);       // elements per 16-byte load
  static_assert(D % kVec == 0, "D must fill whole 16-byte vectors");
  constexpr int kSplit = kThreads / D;       // token groups in the PV pass
  static_assert(kThreads % D == 0, "D must divide the block");

  __shared__ float q_s[G][D];
  __shared__ float p_s[G][kTile];
  __shared__ float red_s[G][kWarps];
  __shared__ float m_s[G], l_s[G], corr_s[G];
  __shared__ int page_s[kTile];
  __shared__ float acc_s[kSplit][G][D];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  const T* qb = q + ((size_t)b * H + (size_t)h * G) * D;
  for (int i = tid; i < G * D; i += kThreads) q_s[i / D][i % D] = to_f32(qb[i]);
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  int len = lens[b];
  len = len < 0 ? 0 : (len > P * PS ? P * PS : len);
  const size_t row_stride = (size_t)KH * D;  // one slot of a page
  const size_t page_stride = (size_t)PS * row_stride;

  // PV pass ownership: column d, tokens t with t % kSplit == j
  const int d = tid % D, j = tid / D;
  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < len; t0 += kTile) {
    const int pos = t0 + tid;
    const bool valid = pos < len;
    int page = 0;
    if (valid) {
      page = page_table[(size_t)b * P + pos / PS];
      page = page < 0 ? 0 : (page >= n_pages ? n_pages - 1 : page);
    }
    page_s[tid] = page;

    // scores for this thread's token, all G rows
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = -INFINITY;
    if (valid) {
      const T* krow = k_pages + page * page_stride + (size_t)(pos % PS) * row_stride
                      + (size_t)h * D;
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] = 0.f;
#pragma unroll
      for (int c = 0; c < D; c += kVec) {
        const uint4 raw = *reinterpret_cast<const uint4*>(krow + c);
        const T* kv = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float kf = to_f32(kv[e]);
#pragma unroll
          for (int g = 0; g < G; ++g) s[g] = fmaf(q_s[g][c + e], kf, s[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] *= scale;
    }

    // tile max per row -> new running max and the rescale of old partials
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float m = warp_max(s[g]);
      if (lane == 0) red_s[g][warp] = m;
    }
    __syncthreads();
    if (tid < G) {
      float m = red_s[tid][0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red_s[tid][w]);
      const float m_new = fmaxf(m_s[tid], m);  // finite: token t0 is valid
      corr_s[tid] = expf(m_s[tid] - m_new);    // exp(-inf) = 0 on tile 0
      m_s[tid] = m_new;
    }
    __syncthreads();

    // probabilities of this tile and their row sums
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float p = valid ? expf(s[g] - m_s[g]) : 0.f;
      p_s[g][tid] = p;
      const float ps = warp_sum(p);
      if (lane == 0) red_s[g][warp] = ps;
    }
    __syncthreads();
    if (tid < G) {
      float l = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) l += red_s[tid][w];
      l_s[tid] = l_s[tid] * corr_s[tid] + l;
    }

    // acc[g] (column d) += sum over this thread's tokens of p * v
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] *= corr_s[g];
    const int n_tile = min(kTile, len - t0);
    for (int t = j; t < n_tile; t += kSplit) {
      const int tp = t0 + t;
      const float vf = to_f32(v_pages[page_s[t] * page_stride
                                      + (size_t)(tp % PS) * row_stride
                                      + (size_t)h * D + d]);
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] = fmaf(p_s[g][t], vf, acc[g]);
    }
    __syncthreads();  // p_s, page_s, red_s are rewritten by the next tile
  }

  // merge the kSplit token groups, normalize, write [G, D] in q's dtype
#pragma unroll
  for (int g = 0; g < G; ++g) acc_s[j][g][d] = acc[g];
  __syncthreads();
  T* ob = out + ((size_t)b * H + (size_t)h * G) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, dd = i % D;
    float o = 0.f;
#pragma unroll
    for (int jj = 0; jj < kSplit; ++jj) o += acc_s[jj][g][dd];
    const float l = l_s[g];
    store(ob + i, l > 0.f ? o / l : 0.f);  // len 0: 0, as the TPU kernel
  }
}

template <typename T, int G, int D>
cudaError_t launch_gd(const void* q, const void* k, const void* v,
                      const int32_t* pt, const int32_t* lens, void* out,
                      int B, int H, int KH, int P, int PS, int n_pages,
                      cudaStream_t stream) {
  const dim3 grid(KH, B);
  paged_decode_kernel<T, G, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pt, lens, static_cast<T*>(out), H, KH, P, PS,
      n_pages, (float)(1.0 / sqrt((double)D)));  // D**-0.5, rounded once
  return cudaGetLastError();
}

template <typename T, int G, int D>
const void* kernel_ptr() {
  return reinterpret_cast<const void*>(&paged_decode_kernel<T, G, D>);
}

// Functors for dispatch (a local class may not have member templates).
struct LaunchFn {
  const void *q, *k, *v, *pt, *lens;
  void* out;
  int B, H, KH, P, PS, n_pages;
  cudaStream_t stream;
  cudaError_t* err;
  template <typename T, int G, int D>
  void operator()() const {
    *err = launch_gd<T, G, D>(q, k, v, static_cast<const int32_t*>(pt),
                              static_cast<const int32_t*>(lens), out, B, H, KH,
                              P, PS, n_pages, stream);
  }
};

struct QueryFn {
  int *blocks, *regs, *smem;
  cudaError_t* err;
  template <typename T, int G, int D>
  void operator()() const {
    cudaFuncAttributes attr;
    *err = cudaFuncGetAttributes(&attr, kernel_ptr<T, G, D>());
    if (*err != cudaSuccess) return;
    *regs = attr.numRegs;
    *smem = (int)attr.sharedSizeBytes;
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel_ptr<T, G, D>(), kThreads, 0);
  }
};

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. All tensors contiguous:
// q/out [B, H, D]; k/v pages [n_pages, PS, KH, D]; page_table [B, P] int32;
// lens [B] int32. Returns the cudaError_t of the launch (0 = success);
// cudaErrorInvalidValue when (dtype, G, D) has no instantiation.
int repro_paged_decode_attention(const void* q, const void* k_pages,
                                 const void* v_pages, const void* page_table,
                                 const void* lens, void* out, int B, int H,
                                 int KH, int D, int P, int PS, int n_pages,
                                 int dtype, void* stream) {
  if (B <= 0 || KH <= 0 || H % KH != 0 || P <= 0 || PS <= 0 || n_pages <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  const LaunchFn f{q, k_pages, v_pages, page_table, lens, out, B, H, KH, P,
                   PS, n_pages, static_cast<cudaStream_t>(stream), &err};
  if (!repro::dispatch_dtype_gd(dtype, H / KH, D, f))
    return (int)cudaErrorInvalidValue;
  return (int)err;
}

// Occupancy of one (dtype, G, D) instantiation on the current device:
// resident blocks per SM, registers per thread, static shared bytes.
int repro_paged_decode_occupancy(int dtype, int G, int D, int* blocks_per_sm,
                                 int* regs, int* smem_bytes) {
  cudaError_t err = cudaSuccess;
  const QueryFn f{blocks_per_sm, regs, smem_bytes, &err};
  if (!repro::dispatch_dtype_gd(dtype, G, D, f))
    return (int)cudaErrorInvalidValue;
  return (int)err;
}

}  // extern "C"
