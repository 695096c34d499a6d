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
//
// What the design does about it:
//   * one block per (split, KV head, lane): the n_splits chunks of S are
//     separate blocks, so a small batch still puts B * KH * n_splits blocks
//     on the 132 SMs (the TPU runs the same grid in order on one core);
//   * the block holds its head's G query rows in shared memory and reads
//     each K row once with 16-byte loads for all G of them; a split past a
//     lane's length reads nothing;
//   * partials (acc, m, l) go to an f32 scratch buffer that the wrapper
//     allocates, and a second small kernel merges them per (row, column)
//     with the Pallas wrapper's lse_merge arithmetic, writing q's dtype.
// Not done yet (later work): staging K/V tiles through shared memory with
// cp.async/TMA, and tensor-core products for G >= 8.
#include "attention.cuh"

namespace {

struct PartialFn {
  const void *q, *k, *v, *lens;
  float *acc, *m, *l;
  int B, H, KH, S, n_split, chunk;
  long long kv_sb, kv_sh, kv_ss;
  cudaStream_t stream;
  cudaError_t* err;
  template <typename T, int G, int D>
  void operator()() const {
    const dim3 grid(n_split, KH, B);
    repro::split_partial_kernel<T, G, D><<<grid, repro::kSplitThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int32_t*>(lens), acc, m, l,
        H, KH, S, chunk, n_split, 0, kv_sb, kv_sh, kv_ss, repro::inv_sqrt(D));
    *err = cudaGetLastError();
  }
};

struct QueryFn {
  int *blocks, *regs, *smem;
  cudaError_t* err;
  template <typename T, int G, int D>
  void operator()() const {
    *err = repro::occupancy(&repro::split_partial_kernel<T, G, D>,
                            repro::kSplitThreads, 0, blocks, regs, smem);
  }
};

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q/out [B, H, D] contiguous; k and v
// share the element strides kv_sb, kv_sh, kv_ss of their batch, head and
// position dims (last dim contiguous); lens [B] int32; acc [B, KH,
// n_split, G, D], m and l [B, KH, n_split, G] f32 scratch. Split si covers
// positions [si * chunk, (si + 1) * chunk). Returns the cudaError_t of the
// launches (0 = success); cudaErrorInvalidValue when (dtype, G, D) has no
// instantiation.
int repro_decode_attention(const void* q, const void* k, const void* v,
                           const void* lens, void* acc, void* m, void* l,
                           void* out, int B, int H, int KH, int D, int S,
                           int n_split, int chunk, long long kv_sb,
                           long long kv_sh, long long kv_ss, int dtype,
                           void* stream) {
  if (B <= 0 || KH <= 0 || H % KH != 0 || S <= 0 || n_split <= 0 ||
      chunk <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* accf = static_cast<float*>(acc);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  cudaError_t err = cudaSuccess;
  const PartialFn f{q, k, v, lens, accf, mf, lf, B, H, KH, S, n_split, chunk,
                    kv_sb, kv_sh, kv_ss, st, &err};
  if (!repro::dispatch_dtype_gd(dtype, H / KH, D, f))
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  if (dtype == 0)
    err = repro::launch_lse_merge<float>(accf, mf, lf, B * H, H / KH, n_split,
                                         D, static_cast<float*>(out), nullptr,
                                         nullptr, nullptr, st);
  else
    err = repro::launch_lse_merge<__nv_bfloat16>(
        accf, mf, lf, B * H, H / KH, n_split, D,
        static_cast<__nv_bfloat16*>(out), nullptr, nullptr, nullptr, st);
  return (int)err;
}

// Occupancy of the partial kernel for one (dtype, G, D): resident blocks
// per SM, registers per thread, shared bytes.
int repro_decode_occupancy(int dtype, int G, int D, int* blocks_per_sm,
                           int* regs, int* smem_bytes) {
  cudaError_t err = cudaSuccess;
  const QueryFn f{blocks_per_sm, regs, smem_bytes, &err};
  if (!repro::dispatch_dtype_gd(dtype, G, D, f))
    return (int)cudaErrorInvalidValue;
  return (int)err;
}

}  // extern "C"
