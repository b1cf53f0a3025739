// The clamped squared distance of one (row, center) pair, shared by the
// nearest-center kernels (assign.cu, fused_filter.cu, argmin_rows.cu) so
// that every pair rounds the same way in all of them:
//
//   d2 = max((|x|^2 + |c|^2) - 2 * (x . c), 0)
//
// The norms and the epilogue use __fmul_rn/__fadd_rn/__fsub_rn, so nvcc
// cannot contract them into FMAs and they round step by step, like the plain
// version (`kernels/ref.py:pairwise_dist2`). The dot product accumulates
// with fmaf in j order, as an f32 GEMM does. No tensor cores, so no TF32.
// The result is never -0: |x|^2 + |c|^2 >= +0, so the subtraction gives
// -0 only from a negative value, which the clamp turns into +0. Its float
// bits therefore order like its values (argmin_rows.cu relies on it).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace repro {

__device__ __forceinline__ float clamped_d2(float xn, float cn, float dot) {
  return fmaxf(__fsub_rn(__fadd_rn(xn, cn), __fmul_rn(2.0f, dot)), 0.0f);
}

// A row of d floats, kept in registers when d <= DMAX (DMAX > 0); DMAX = 0
// reads it from memory at each use (large d).
template <int DMAX>
struct Row {
  float v[DMAX > 0 ? DMAX : 1];
  const float* p;
  float norm;

  __device__ __forceinline__ void load(const float* src, int d) {
    p = src;
    norm = 0.0f;
    if constexpr (DMAX > 0) {
#pragma unroll
      for (int j = 0; j < DMAX; ++j) {
        if (j < d) {
          v[j] = src[j];
          norm = __fadd_rn(norm, __fmul_rn(v[j], v[j]));
        }
      }
    } else {
      for (int j = 0; j < d; ++j) norm = __fadd_rn(norm, __fmul_rn(src[j], src[j]));
    }
  }

  // x . q in j order, for a vector q of d floats (shared or global memory)
  __device__ __forceinline__ float dot(const float* q, int d) const {
    float s = 0.0f;
    if constexpr (DMAX > 0) {
#pragma unroll
      for (int j = 0; j < DMAX; ++j) {
        if (j < d) s = fmaf(v[j], q[j], s);
      }
    } else {
      for (int j = 0; j < d; ++j) s = fmaf(p[j], q[j], s);
    }
    return s;
  }
};

// Stage `nr` vectors of d floats starting at `src` into shared memory `dst`
// (nr * d floats) and their squared norms into `dst_norm` (nr floats), in j
// order like Row::load. Every thread of the block calls it; it ends with a
// barrier, so the tile is ready when it returns.
__device__ __forceinline__ void stage_tile(const float* __restrict__ src,
                                           int nr, int d, float* dst,
                                           float* dst_norm) {
  for (int e = threadIdx.x; e < nr * d; e += blockDim.x) dst[e] = src[e];
  __syncthreads();
  for (int q = threadIdx.x; q < nr; q += blockDim.x) {
    float s = 0.0f;
    for (int j = 0; j < d; ++j) {
      s = __fadd_rn(s, __fmul_rn(dst[q * d + j], dst[q * d + j]));
    }
    dst_norm[q] = s;
  }
  __syncthreads();
}

// The nearest of the k centers c (k, d) to row x (live threads only): the
// running (min, argmin) takes a center on strict <, so the earliest center
// wins a tie, as torch.argmin does. The block walks the centers in tiles of
// `tc` staged in shared memory `smem` (tc * (d + 1) floats); every thread of
// the warp reads the same center word, so the reads broadcast. Every thread
// of the block calls it (it synchronises), live or not.
template <int DMAX>
__device__ __forceinline__ void nearest_center(const Row<DMAX>& x, bool live,
                                               const float* __restrict__ c,
                                               int k, int d, int tc,
                                               float* smem, float& best,
                                               int& best_i) {
  float* sc = smem;            // (tc, d) center tile
  float* scn = smem + tc * d;  // (tc,) their squared norms
  best = __int_as_float(0x7f800000);  // +inf
  best_i = 0;
  for (int c0 = 0; c0 < k; c0 += tc) {
    const int nc = min(tc, k - c0);
    __syncthreads();  // the previous tile is consumed
    stage_tile(c + (int64_t)c0 * d, nc, d, sc, scn);
    if (live) {
      for (int q = 0; q < nc; ++q) {
        const float d2 = clamped_d2(x.norm, scn[q], x.dot(sc + q * d, d));
        if (d2 < best) {
          best = d2;
          best_i = c0 + q;
        }
      }
    }
  }
}

// Calls f(std::integral_constant<int, DMAX>{}) with the smallest register
// width DMAX >= d, or DMAX = 0 past 64.
template <typename F>
inline void dispatch_d(int d, F&& f) {
  if (d <= 2) f(std::integral_constant<int, 2>{});
  else if (d <= 4) f(std::integral_constant<int, 4>{});
  else if (d <= 8) f(std::integral_constant<int, 8>{});
  else if (d <= 16) f(std::integral_constant<int, 16>{});
  else if (d <= 32) f(std::integral_constant<int, 32>{});
  else if (d <= 64) f(std::integral_constant<int, 64>{});
  else f(std::integral_constant<int, 0>{});
}

}  // namespace repro
