// Pairwise squared distances for Hopper (sm_90a): the full (n, m) matrix.
//
// Replaces the TPU kernel src/repro/kernels/pairwise.py `pairwise_dist2`
// (body `_pairwise_kernel`). For x (n, d) and c (m, d), in f32 or f16, each
// converted to f32 on load:
//   out[i, q] = max((|x_i|^2 + |c_q|^2) - 2 * (x_i . c_q), 0)     (f32)
//
// Bound on this card: the output's 4·n·m bytes against 2·d·n·m operations
// outside the tensor cores; at d = 38 the two are close (n = 65,536,
// m = 1,024: 268 MB, 80 us at 3.35 TB/s; 5.1 GFLOP, 76 us at 67 TFLOP/s).
// Design: one 256-thread block computes a 64 x 64 output tile. The block
// stages 32 columns at a time of its 64 x rows and 64 c rows in shared
// memory (transposed, so that a thread's four rows and four centers are
// strided loads that broadcast or hit distinct banks), and each thread keeps
// a 4 x 4 block of dot products in registers, accumulated with fmaf in j
// order: the same sequence as dist2.cuh's Row::dot, so a pair's dot, and
// with the norms and the epilogue (dist2.cuh's clamped_d2, the norms summed
// in j order as stage_tile does) its d2, round as in the nearest-center
// kernels. The TPU runs the product on its matrix unit in (bn, bm) tiles;
// here there are no tensor cores and no TF32 (a later version may use
// wgmma), so the product runs on the f32 units. Ragged edges are masked by
// the counts, not padded.

#include <cuda_fp16.h>

#include "dist2.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;            // output rows and columns per block
constexpr int kDepth = 32;           // columns of d staged at a time
constexpr int kPer = kTile / 16;     // outputs per thread along each axis

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

// Squared norm of each of `rows` rows of a (rows, d) matrix, in j order.
template <typename T>
__device__ __forceinline__ void row_norms(const T* __restrict__ a, int rows,
                                          int d, int t, float* out) {
  if (t < rows) {
    float s = 0.0f;
    for (int j = 0; j < d; ++j) {
      const float v = to_f32(a[(int64_t)t * d + j]);
      s = __fadd_rn(s, __fmul_rn(v, v));
    }
    out[t] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pairwise_kernel(const T* __restrict__ x, const T* __restrict__ c, int n,
                int m, int d, float* __restrict__ out) {
  __shared__ float xs[kDepth][kTile + 1];
  __shared__ float cs[kDepth][kTile + 1];
  __shared__ float xn[kTile];
  __shared__ float cn[kTile];
  const int64_t n0 = (int64_t)blockIdx.x * kTile;
  const int64_t m0 = (int64_t)blockIdx.y * kTile;
  const int nr = n - n0 < kTile ? (int)(n - n0) : kTile;  // ragged edges
  const int mr = m - m0 < kTile ? (int)(m - m0) : kTile;
  const int t = threadIdx.x;
  const int tx = t & 15;
  const int ty = t >> 4;
  // threads 0-63 take the x rows' norms, 64-127 the c rows'
  if (t < kTile) row_norms(x + n0 * d, nr, d, t, xn);
  else if (t < 2 * kTile) row_norms(c + m0 * d, mr, d, t - kTile, cn);

  float acc[kPer][kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
#pragma unroll
    for (int q = 0; q < kPer; ++q) acc[i][q] = 0.0f;
  }
  for (int k0 = 0; k0 < d; k0 += kDepth) {
    const int kd = min(kDepth, d - k0);
    __syncthreads();  // the previous slab is consumed
    for (int e = t; e < kTile * kDepth; e += kThreads) {
      const int r = e / kDepth;
      const int j = e % kDepth;
      const bool in = j < kd;
      xs[j][r] = in && r < nr ? to_f32(x[(n0 + r) * d + k0 + j]) : 0.0f;
      cs[j][r] = in && r < mr ? to_f32(c[(m0 + r) * d + k0 + j]) : 0.0f;
    }
    __syncthreads();
    for (int j = 0; j < kd; ++j) {
      float a[kPer], b[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) a[i] = xs[j][ty + 16 * i];
#pragma unroll
      for (int q = 0; q < kPer; ++q) b[q] = cs[j][tx + 16 * q];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
#pragma unroll
        for (int q = 0; q < kPer; ++q) acc[i][q] = fmaf(a[i], b[q], acc[i][q]);
      }
    }
  }
  __syncthreads();  // the norms are written
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = ty + 16 * i;
    if (r >= nr) continue;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int col = tx + 16 * q;
      if (col < mr) {
        out[(n0 + r) * m + m0 + col] = repro::clamped_d2(xn[r], cn[col],
                                                         acc[i][q]);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* c, void* out, int n, int m, int d,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  pairwise_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(c), n, m, d,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (n, d) and c (m, d), both f32 (half = 0) or both f16 (half = 1); out
// (n, m) f32. 1 <= m <= 65535·64. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError().
int repro_pairwise_dist2(const void* x, const void* c, void* out, int n,
                         int m, int d, int half, int device, void* stream) {
  if (half) return launch<__half>(x, c, out, n, m, d, device, stream);
  return launch<float>(x, c, out, n, m, d, device, stream);
}

}  // extern "C"
