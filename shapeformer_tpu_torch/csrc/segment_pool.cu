// segment_pool: per-point segment max / mean over cell-sorted rows (sm_90a).
//
// Replaces shapeformer_tpu/ops/pallas_scatter.py::segmented_scan, the Pallas
// TPU kernel whose forward and reverse inclusive scans ops/scatter.py::_pg_core
// combines into a per-point segment value (max(fwd, rev) for max,
// (fwd + rev - x) / n for mean).  The TPU kernel walks 256-row tiles in order
// and carries a (1, C) running value from one tile to the next; CUDA blocks run
// in no order, so this kernel does not scan at all.  It reduces each segment
// directly and writes the pooled row back to every member, in one pass.
//
// Layout: x and out are (rows, C) row-major, rows = B * N in sorted order.
// offsets (n_seg + 1) holds each segment's first row and ends with rows.
// A segment never crosses a batch row, because every batch row starts one.
//
// Design: one warp per segment, lanes over channels (C = 32 at the flagship
// width: one channel per lane), so each row is read and written as one
// coalesced 128-byte line.  Sums and maxima are taken in f32; bf16 input is
// widened on load, as the TPU wrapper widens it before its scan.
//
// Bound on an H100: bytes.  It must read rows * C values and write as many,
// 2 * B * N * C * 4 bytes in f32, plus (n_seg + 1) * 4 bytes of offsets.
// The arithmetic is one max or add per value read.
//
// Weak case: one huge segment serialises on one warp (all points in one cell
// means one warp walks all rows twice while the rest of the card idles).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

constexpr int kWarpsPerBlock = 8;

// MODE 0 = max, 1 = mean.
template <typename T, int MODE>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_pool_kernel(const T* __restrict__ x, const int32_t* __restrict__ offsets,
                    int n_seg, int C, T* __restrict__ out) {
  const int seg = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (seg >= n_seg) return;
  const int64_t begin = offsets[seg];
  const int64_t end = offsets[seg + 1];
  const float n = static_cast<float>(end - begin);
  for (int c = lane; c < C; c += 32) {
    float acc = MODE == 0 ? -INFINITY : 0.0f;
    for (int64_t r = begin; r < end; ++r) {
      const float v = load_f32(x + r * C + c);
      acc = MODE == 0 ? fmaxf(acc, v) : acc + v;
    }
    const float pooled = MODE == 0 ? acc : acc / n;
    for (int64_t r = begin; r < end; ++r) store_f32(out + r * C + c, pooled);
  }
}

template <typename T>
cudaError_t launch(const void* x, const int32_t* offsets, int n_seg, int C,
                   int mode, void* out, cudaStream_t stream) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((n_seg + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (mode == 0) {
    segment_pool_kernel<T, 0><<<grid, block, 0, stream>>>(xt, offsets, n_seg, C, ot);
  } else {
    segment_pool_kernel<T, 1><<<grid, block, 0, stream>>>(xt, offsets, n_seg, C, ot);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  dtype: 0 = float32, 1 = bfloat16 (out has
// the dtype of x).  mode: 0 = max, 1 = mean.  Returns the cudaError_t of the
// launch (0 on success); the caller raises on anything else.
extern "C" int segment_pool_launch(const void* x, const int32_t* offsets,
                                   int n_seg, int C, int mode, int dtype,
                                   void* out, void* stream) {
  if (n_seg <= 0 || C <= 0 || (mode != 0 && mode != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(x, offsets, n_seg, C, mode, out, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(x, offsets, n_seg, C, mode, out, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* segment_pool_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
