// attention: causal softmax attention with key validity, forward and backward
// (sm_90a).
//
// Replaces the three Pallas TPU kernels behind
// shapeformer_tpu/models/shapeformer/transformer/mingpt.py::_attend_flash, the
// bundled flash_attention forward, its dK/dV backward and its dQ backward.
// The TPU kernels pad T to a multiple of 128 and D to the lane width, walk the
// K/V blocks as a sequential grid dimension with the running max, sum and
// output carried in scratch, and express key validity as segment ids.  Here a
// block owns one 64-row tile of one (batch row, head) and loops over the
// 64-row tiles on the other side of the product up to the diagonal; nothing is
// carried between blocks, the ragged last tile is masked in the kernel, and
// validity is read as bytes.
//
// What they compute, per batch row b, head h and query i (D = 64):
//   S_ij = scale * q_i . k_j;  j is attended iff j <= i and key_valid[b, j];
//   P = softmax_j(S) in f32;  O_i = sum_j P_ij v_j;  L_i = log sum_j exp(S_ij).
// Backward, from Q, K, V, O, L and dO, with P recomputed as exp(S - L):
//   delta_i = dO_i . O_i;  dP_ij = dO_i . v_j;  dS_ij = P_ij (dP_ij - delta_i);
//   dV_j = sum_i P_ij dO_i;  dK_j = scale sum_i dS_ij q_i;
//   dQ_i = scale sum_j dS_ij k_j.
// attention_bwd_dq owns a query tile, loops over K/V tiles, and also writes
// delta; attention_bwd_dkv owns a K/V tile, loops over query tiles and reads
// delta, so it is launched after attention_bwd_dq.  No atomics: the results
// do not change from run to run.  A query row without any attended key gets
// O = 0 and L = -inf, and contributes nothing to any gradient.
//
// Layout: q, k, v are (B, T, H, 64) views that share one set of strides
// (elements; the innermost stride is 1), e.g. the three thirds of a packed
// (B, T, 3 * H * 64) projection.  out, d_out, dq, dk and dv are contiguous
// (B, T, H, 64); lse and delta are (B, H, T) f32; key_valid is (B, T) bytes or
// null.  Inputs are f32 or bf16; every product, the softmax and the running
// sums are f32, and the tiles sit in shared memory as f32.
//
// Design: 256 threads as 16 x 16, each holding a 4 x 4 block of the 64 x 64
// tile in registers (rows ty + 16 r, columns tx + 16 c).  Tiles are row-major
// with a row stride of 65 floats, which makes both operand reads of A B^T and
// of A B free of bank conflicts.  The row max and sum run over the 16 lanes
// that share ty with xor shuffles.  All arithmetic is scalar f32 FMA: the
// training path is f32, and TF32 tensor-core products would not hold its
// tolerance.
//
// Bound on an H100: operations.  With n = the number of attended (i, j) pairs
// summed over B (T (T + 1) / 2 per row when every key is valid), forward does
// 2 products, 4 H D n operations; dK/dV needs S, dP, dV, dK, 8 H D n; dQ
// needs S, dP, dQ, 6 H D n (a fused backward would need 5 products, 2.5 x the
// forward).  Bytes: Q, K, V, O, dO and each gradient once, far below that.
//
// Weak point: each inner step makes 8 shared-memory loads for 16 FMAs, so the
// kernels are bound by shared-memory bandwidth at about a third of the f32
// rate at best, and bf16 inputs gain nothing because they do not reach the
// tensor cores.  Tiles are loaded without overlap with the arithmetic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;             // tile rows, and the head width D
constexpr int kLd = kTile + 1;        // shared-memory row stride in floats
constexpr int kThreads = 256;
constexpr int kTileFloats = kTile * kLd;

struct Shape {
  int B, T, H;
  int64_t sb, st, sh;                 // strides of q, k and v in elements
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Rows row0 .. row0 + 63 of a (T, 64) matrix with the given row stride into a
// shared tile; rows at or beyond T become zeros.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t row_stride, int row0,
                                          int n_rows) {
  for (int idx = threadIdx.x; idx < kTile * kTile; idx += kThreads) {
    const int r = idx >> 6;
    const int d = idx & 63;
    const int row = row0 + r;
    dst[r * kLd + d] = row < n_rows ? to_f32(src[row * row_stride + d]) : 0.0f;
  }
}

// acc[r][c] += sum_d A[ty + 16 r][d] * B[tx + 16 c][d]
__device__ __forceinline__ void tile_nt(const float* A, const float* B, int ty,
                                        int tx, float acc[4][4]) {
#pragma unroll 8
  for (int d = 0; d < kTile; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = A[(ty + 16 * r) * kLd + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = B[(tx + 16 * c) * kLd + d];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

// acc[r][c] += sum_j A[ty + 16 r][j] * B[j][tx + 16 c]
__device__ __forceinline__ void tile_nn(const float* A, const float* B, int ty,
                                        int tx, float acc[4][4]) {
#pragma unroll 8
  for (int j = 0; j < kTile; ++j) {
    float a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = A[(ty + 16 * r) * kLd + j];
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = B[j * kLd + tx + 16 * c];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

// Reductions over the 16 lanes that share ty (lane = (ty & 1) * 16 + tx).
__device__ __forceinline__ float max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void zero(float acc[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
}

// valid_s[x] = key k0 + x exists and is valid.
__device__ __forceinline__ void load_valid(uint8_t* valid_s,
                                           const uint8_t* key_valid, int b,
                                           int k0, int T) {
  if (threadIdx.x < kTile) {
    const int j = k0 + threadIdx.x;
    valid_s[threadIdx.x] =
        j < T && (key_valid == nullptr || key_valid[(int64_t)b * T + j] != 0);
  }
}

// Forward: grid (query tiles, H, B).  Shared: Q, K, V, P tiles.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const uint8_t* __restrict__ key_valid,
                     T* __restrict__ out, float* __restrict__ lse, Shape s,
                     float scale) {
  extern __shared__ float smem[];
  __shared__ uint8_t valid_s[kTile];
  float* Qs = smem;
  float* Ks = Qs + kTileFloats;
  float* Vs = Ks + kTileFloats;
  float* Ps = Vs + kTileFloats;
  const int qt = gridDim.x - 1 - blockIdx.x;      // longest loops first
  const int h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int q0 = qt * kTile;
  const int64_t base = b * s.sb + h * s.sh;

  load_tile(Qs, q + base, s.st, q0, s.T);
  float m[4], l[4], acc[4][4];
  zero(acc);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
  }
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();                  // the last step's reads of K, V, P are done
    load_tile(Ks, k + base, s.st, k0, s.T);
    load_tile(Vs, v + base, s.st, k0, s.T);
    load_valid(valid_s, key_valid, b, k0, s.T);
    __syncthreads();
    float sc[4][4];
    zero(sc);
    tile_nt(Qs, Ks, ty, tx, sc);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + ty + 16 * r;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int jj = tx + 16 * c;
        const bool ok = valid_s[jj] && k0 + jj <= i;
        sc[r][c] = ok ? sc[r][c] * scale : -INFINITY;
        mx = fmaxf(mx, sc[r][c]);
      }
      mx = max16(mx);
      const float m_new = fmaxf(m[r], mx);
      const float m_safe = m_new == -INFINITY ? 0.0f : m_new;
      const float alpha = expf(m[r] - m_safe);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(sc[r][c] - m_safe);
        Ps[(ty + 16 * r) * kLd + tx + 16 * c] = p;
        sum += p;
      }
      sum = sum16(sum);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();
    tile_nn(Ps, Vs, ty, tx, acc);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty + 16 * r;
    if (i >= s.T) continue;
    const float inv = l[r] > 0.0f ? 1.0f / l[r] : 0.0f;
    T* o_row = out + (((int64_t)b * s.T + i) * s.H + h) * kTile;
#pragma unroll
    for (int c = 0; c < 4; ++c) store_f32(o_row + tx + 16 * c, acc[r][c] * inv);
    if (tx == 0) {
      lse[((int64_t)b * s.H + h) * s.T + i] =
          l[r] > 0.0f ? m[r] + logf(l[r]) : -INFINITY;
    }
  }
}

// Backward dQ: grid (query tiles, H, B).  Shared: Q, dO, K, V, dS tiles.  Also
// writes delta_i = dO_i . O_i for its rows.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const uint8_t* __restrict__ key_valid,
                        const T* __restrict__ out, const T* __restrict__ d_out,
                        const float* __restrict__ lse, T* __restrict__ dq,
                        float* __restrict__ delta, Shape s, float scale) {
  extern __shared__ float smem[];
  __shared__ uint8_t valid_s[kTile];
  float* Qs = smem;
  float* dOs = Qs + kTileFloats;
  float* Ks = dOs + kTileFloats;
  float* Vs = Ks + kTileFloats;
  float* Ss = Vs + kTileFloats;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int q0 = qt * kTile;
  const int64_t base = b * s.sb + h * s.sh;
  const int64_t o_base = ((int64_t)b * s.T * s.H + h) * kTile;
  const int64_t o_stride = (int64_t)s.H * kTile;
  const int64_t row_base = ((int64_t)b * s.H + h) * s.T;

  load_tile(Qs, q + base, s.st, q0, s.T);
  load_tile(dOs, d_out + o_base, o_stride, q0, s.T);
  load_tile(Ks, out + o_base, o_stride, q0, s.T);     // O, until the loop
  __syncthreads();
  float li[4], dl[4], acc[4][4];
  zero(acc);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty + 16 * r;
    float part = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      part += dOs[row * kLd + tx + 16 * c] * Ks[row * kLd + tx + 16 * c];
    }
    dl[r] = sum16(part);
    const int i = q0 + row;
    li[r] = i < s.T ? lse[row_base + i] : 0.0f;
    if (tx == 0 && i < s.T) delta[row_base + i] = dl[r];
  }
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile(Ks, k + base, s.st, k0, s.T);
    load_tile(Vs, v + base, s.st, k0, s.T);
    load_valid(valid_s, key_valid, b, k0, s.T);
    __syncthreads();
    float sc[4][4], dp[4][4];
    zero(sc);
    zero(dp);
    tile_nt(Qs, Ks, ty, tx, sc);
    tile_nt(dOs, Vs, ty, tx, dp);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int jj = tx + 16 * c;
        const bool ok = valid_s[jj] && k0 + jj <= i && i < s.T;
        const float p = ok ? expf(sc[r][c] * scale - li[r]) : 0.0f;
        Ss[(ty + 16 * r) * kLd + jj] = p * (dp[r][c] - dl[r]);
      }
    }
    __syncthreads();
    tile_nn(Ss, Ks, ty, tx, acc);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty + 16 * r;
    if (i >= s.T) continue;
    T* row = dq + o_base + i * o_stride;
#pragma unroll
    for (int c = 0; c < 4; ++c) store_f32(row + tx + 16 * c, acc[r][c] * scale);
  }
}

// Backward dK, dV: grid (key tiles, H, B).  Shared: K, V, Q, dO, P^T, dS^T
// tiles.  Thread (ty, tx) holds keys ty + 16 r and queries tx + 16 c of the
// transposed tiles, and channels tx + 16 c of dK and dV.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const uint8_t* __restrict__ key_valid,
                         const T* __restrict__ d_out,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, Shape s, float scale) {
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTileFloats;
  float* Qs = Vs + kTileFloats;
  float* dOs = Qs + kTileFloats;
  float* Pt = dOs + kTileFloats;
  float* dSt = Pt + kTileFloats;
  const int jt = blockIdx.x;                      // key tile 0 loops longest
  const int n_tiles = gridDim.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int k0 = jt * kTile;
  const int64_t base = b * s.sb + h * s.sh;
  const int64_t o_base = ((int64_t)b * s.T * s.H + h) * kTile;
  const int64_t o_stride = (int64_t)s.H * kTile;
  const int64_t row_base = ((int64_t)b * s.H + h) * s.T;

  load_tile(Ks, k + base, s.st, k0, s.T);
  load_tile(Vs, v + base, s.st, k0, s.T);
  bool key_ok[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = k0 + ty + 16 * r;
    key_ok[r] = j < s.T &&
                (key_valid == nullptr || key_valid[(int64_t)b * s.T + j] != 0);
  }
  float acc_k[4][4], acc_v[4][4];
  zero(acc_k);
  zero(acc_v);
  for (int it = jt; it < n_tiles; ++it) {
    const int q0 = it * kTile;
    __syncthreads();
    load_tile(Qs, q + base, s.st, q0, s.T);
    load_tile(dOs, d_out + o_base, o_stride, q0, s.T);
    __syncthreads();
    float li[4], dl[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = q0 + tx + 16 * c;
      li[c] = i < s.T ? lse[row_base + i] : 0.0f;
      dl[c] = i < s.T ? delta[row_base + i] : 0.0f;
    }
    float st[4][4], dpt[4][4];
    zero(st);
    zero(dpt);
    tile_nt(Ks, Qs, ty, tx, st);
    tile_nt(Vs, dOs, ty, tx, dpt);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = k0 + ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = q0 + tx + 16 * c;
        const bool ok = key_ok[r] && j <= i && i < s.T;
        const float p = ok ? expf(st[r][c] * scale - li[c]) : 0.0f;
        Pt[(ty + 16 * r) * kLd + tx + 16 * c] = p;
        dSt[(ty + 16 * r) * kLd + tx + 16 * c] = p * (dpt[r][c] - dl[c]);
      }
    }
    __syncthreads();
    tile_nn(Pt, dOs, ty, tx, acc_v);
    tile_nn(dSt, Qs, ty, tx, acc_k);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = k0 + ty + 16 * r;
    if (j >= s.T) continue;
    T* k_row = dk + o_base + j * o_stride;
    T* v_row = dv + o_base + j * o_stride;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      store_f32(k_row + tx + 16 * c, acc_k[r][c] * scale);
      store_f32(v_row + tx + 16 * c, acc_v[r][c]);
    }
  }
}

constexpr size_t kFwdSmem = 4 * kTileFloats * sizeof(float);
constexpr size_t kDqSmem = 5 * kTileFloats * sizeof(float);
constexpr size_t kDkvSmem = 6 * kTileFloats * sizeof(float);

bool bad_shape(const Shape& s) {
  return s.B <= 0 || s.T <= 0 || s.H <= 0 || s.B > 65535 || s.H > 65535;
}

dim3 grid_of(const Shape& s) {
  return dim3((s.T + kTile - 1) / kTile, s.H, s.B);
}

// Each launcher raises its kernel's dynamic shared-memory limit once per
// instantiation (a function-local static), not on every launch.
template <typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const uint8_t* key_valid, void* out, float* lse,
                       Shape s, float scale, cudaStream_t stream) {
  auto kernel = attention_fwd_kernel<T>;
  static const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kFwdSmem);
  if (err != cudaSuccess) return err;
  kernel<<<grid_of(s), kThreads, kFwdSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), key_valid, static_cast<T*>(out), lse, s, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const uint8_t* key_valid, const void* out,
                      const void* d_out, const float* lse, void* dq,
                      float* delta, Shape s, float scale, cudaStream_t stream) {
  auto kernel = attention_bwd_dq_kernel<T>;
  static const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDqSmem);
  if (err != cudaSuccess) return err;
  kernel<<<grid_of(s), kThreads, kDqSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), key_valid, static_cast<const T*>(out),
      static_cast<const T*>(d_out), lse, static_cast<T*>(dq), delta, s, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const uint8_t* key_valid, const void* d_out,
                       const float* lse, const float* delta, void* dk, void* dv,
                       Shape s, float scale, cudaStream_t stream) {
  auto kernel = attention_bwd_dkv_kernel<T>;
  static const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDkvSmem);
  if (err != cudaSuccess) return err;
  kernel<<<grid_of(s), kThreads, kDkvSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), key_valid, static_cast<const T*>(d_out), lse,
      delta, static_cast<T*>(dk), static_cast<T*>(dv), s, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes.  dtype: 0 = float32, 1 = bfloat16, the type
// of q, k, v, out, d_out, dq, dk and dv.  sb, st, sh: the strides of q, k and
// v in elements.  key_valid may be null.  Each returns the cudaError_t of its
// launch (0 on success); the caller raises on anything else.
extern "C" int attention_fwd_launch(const void* q, const void* k, const void* v,
                                    const void* key_valid, void* out, void* lse,
                                    int B, int T, int H, int64_t sb, int64_t st,
                                    int64_t sh, float scale, int dtype,
                                    void* stream) {
  const Shape s{B, T, H, sb, st, sh};
  if (bad_shape(s)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const uint8_t* kv = static_cast<const uint8_t*>(key_valid);
  float* l = static_cast<float*>(lse);
  if (dtype == 0) {
    return static_cast<int>(launch_fwd<float>(q, k, v, kv, out, l, s, scale, cs));
  }
  if (dtype == 1) {
    return static_cast<int>(
        launch_fwd<__nv_bfloat16>(q, k, v, kv, out, l, s, scale, cs));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int attention_bwd_dq_launch(const void* q, const void* k,
                                       const void* v, const void* key_valid,
                                       const void* out, const void* d_out,
                                       const void* lse, void* dq, void* delta,
                                       int B, int T, int H, int64_t sb,
                                       int64_t st, int64_t sh, float scale,
                                       int dtype, void* stream) {
  const Shape s{B, T, H, sb, st, sh};
  if (bad_shape(s)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const uint8_t* kv = static_cast<const uint8_t*>(key_valid);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0) {
    return static_cast<int>(
        launch_dq<float>(q, k, v, kv, out, d_out, l, dq, dl, s, scale, cs));
  }
  if (dtype == 1) {
    return static_cast<int>(launch_dq<__nv_bfloat16>(q, k, v, kv, out, d_out, l,
                                                     dq, dl, s, scale, cs));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int attention_bwd_dkv_launch(const void* q, const void* k,
                                        const void* v, const void* key_valid,
                                        const void* d_out, const void* lse,
                                        const void* delta, void* dk, void* dv,
                                        int B, int T, int H, int64_t sb,
                                        int64_t st, int64_t sh, float scale,
                                        int dtype, void* stream) {
  const Shape s{B, T, H, sb, st, sh};
  if (bad_shape(s)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const uint8_t* kv = static_cast<const uint8_t*>(key_valid);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 0) {
    return static_cast<int>(
        launch_dkv<float>(q, k, v, kv, d_out, l, dl, dk, dv, s, scale, cs));
  }
  if (dtype == 1) {
    return static_cast<int>(launch_dkv<__nv_bfloat16>(q, k, v, kv, d_out, l, dl,
                                                      dk, dv, s, scale, cs));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
