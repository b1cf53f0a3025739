// Nearest-center assignment for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/assign.py `assign_nearest_blocks`
// (body `_assign_kernel`). For every row x_i of x (n, d) and centers c (k, d):
//   d2[i, q] = max((|x_i|^2 + |c_q|^2) - 2 * (x_i . c_q), 0)
//   idx[i]   = first argmin_q d2[i, q],  d2_out[i] = d2[i, idx[i]]
//
// Bound on this card: operations at large k·d, since each (row, center) pair
// costs ~2·d + 5 f32 operations on the non-tensor units while a row moves
// only 4·d + 8 bytes. At n = 1e6, k = 100, d = 2 that is ~9e8 operations
// (13 us at 67 TFLOP/s) against 16 MB (4.8 us at 3.35 TB/s).
// Design: one thread per row holds its row in registers (d <= 64; larger d
// re-reads the row from L1) and walks the centers, which the block stages in
// shared memory in tiles of `tc` centers with their norms; every thread of a
// warp reads the same center word, so the reads broadcast. The TPU kernel
// walks center tiles over a sequential grid axis into a revisited output
// block; a CUDA grid is not sequential, so the center loop runs inside the
// block instead. The running (min, argmin) takes a center only on strict <,
// so the earliest center wins ties, as torch.argmin does. The ragged last
// center tile is bounded by the count, not padded with a 1e18 coordinate.
//
// Rounding: the norms and the epilogue use __fmul_rn/__fadd_rn/__fsub_rn, so
// nvcc cannot contract (|x|^2 + |c|^2) - 2·dot into an FMA and the card
// rounds them like the plain version. The dot product accumulates with fmaf
// in j order, as an f32 GEMM does; its rounding (not its order) therefore
// matches the plain version's matrix product. No tensor cores, so no TF32.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
assign_kernel(const float* __restrict__ x, const float* __restrict__ c, int n,
              int k, int d, int tc, int* __restrict__ idx_out,
              float* __restrict__ d2_out) {
  extern __shared__ float smem[];
  float* sc = smem;            // (tc, d) center tile
  float* scn = smem + tc * d;  // (tc,) their squared norms
  const int64_t row = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool live = row < n;
  const float* xr = x + row * d;

  float xv[DMAX > 0 ? DMAX : 1];
  float xn = 0.0f;
  if (live) {
    if constexpr (DMAX > 0) {
#pragma unroll
      for (int j = 0; j < DMAX; ++j) {
        if (j < d) {
          xv[j] = xr[j];
          xn = __fadd_rn(xn, __fmul_rn(xv[j], xv[j]));
        }
      }
    } else {
      for (int j = 0; j < d; ++j) xn = __fadd_rn(xn, __fmul_rn(xr[j], xr[j]));
    }
  }

  float best = CUDART_INF_F;
  int best_i = 0;
  for (int c0 = 0; c0 < k; c0 += tc) {
    const int nc = min(tc, k - c0);
    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < nc * d; e += kThreads) {
      sc[e] = c[(int64_t)c0 * d + e];
    }
    __syncthreads();
    for (int q = threadIdx.x; q < nc; q += kThreads) {
      float s = 0.0f;
      for (int j = 0; j < d; ++j) {
        s = __fadd_rn(s, __fmul_rn(sc[q * d + j], sc[q * d + j]));
      }
      scn[q] = s;
    }
    __syncthreads();
    if (live) {
      for (int q = 0; q < nc; ++q) {
        const float* cq = sc + q * d;
        float dot = 0.0f;
        if constexpr (DMAX > 0) {
#pragma unroll
          for (int j = 0; j < DMAX; ++j) {
            if (j < d) dot = fmaf(xv[j], cq[j], dot);
          }
        } else {
          for (int j = 0; j < d; ++j) dot = fmaf(xr[j], cq[j], dot);
        }
        const float d2 = fmaxf(
            __fsub_rn(__fadd_rn(xn, scn[q]), __fmul_rn(2.0f, dot)), 0.0f);
        if (d2 < best) {
          best = d2;
          best_i = c0 + q;
        }
      }
    }
  }
  if (live) {
    idx_out[row] = best_i;
    d2_out[row] = best;
  }
}

template <int DMAX>
void launch(const float* x, const float* c, int n, int k, int d, int tc,
            int* idx, float* d2, cudaStream_t s) {
  const int blocks = (n + kThreads - 1) / kThreads;
  const size_t smem = sizeof(float) * (size_t)tc * (d + 1);
  assign_kernel<DMAX><<<blocks, kThreads, smem, s>>>(x, c, n, k, d, tc, idx,
                                                     d2);
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (n, d), c (k, d) f32; idx (n,) int32, d2 (n,) f32. `tc` centers per
// shared-memory tile: tc·(d + 1)·4 bytes must stay within 48 KB. Launches on
// `stream`, does not synchronise, and returns cudaGetLastError().
int repro_assign_nearest(const void* x, const void* c, void* idx, void* d2,
                         int n, int k, int d, int tc, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* xp = static_cast<const float*>(x);
  const float* cp = static_cast<const float*>(c);
  int* ip = static_cast<int*>(idx);
  float* dp = static_cast<float*>(d2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 2) launch<2>(xp, cp, n, k, d, tc, ip, dp, s);
  else if (d <= 4) launch<4>(xp, cp, n, k, d, tc, ip, dp, s);
  else if (d <= 8) launch<8>(xp, cp, n, k, d, tc, ip, dp, s);
  else if (d <= 16) launch<16>(xp, cp, n, k, d, tc, ip, dp, s);
  else if (d <= 32) launch<32>(xp, cp, n, k, d, tc, ip, dp, s);
  else if (d <= 64) launch<64>(xp, cp, n, k, d, tc, ip, dp, s);
  else launch<0>(xp, cp, n, k, d, tc, ip, dp, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
