// GON step for Hopper (sm_90a): one Gonzalez iteration over m machine blocks.
//
// Replaces the TPU kernel src/repro/kernels/fused_argfar.py
// `fused_min_argmax_blocks` (body `_fused_kernel`), batched over the machine
// axis that the JAX package maps with `jax.vmap`.
//
// For machine b and its new center c[b]:
//   d2[b, r]     = sum_j (x[b, r, j] - c[b, j])^2      (direct form, j order)
//   md[b, r]     = min(md[b, r], d2[b, r])             (in place)
//   far_i[b]     = first argmax_r md[b, r],  far_v[b] = md[b, far_i[b]]
//
// The update is in place: `md` is read and overwritten, unlike the JAX
// kernel, which writes a fresh output. The far index is exactly
// `argmax(new md)` with first-occurrence ties, so the caller takes the next
// center from it without recomputing the argmax.
//
// Bound on this card: bytes. Each row is read once (4·d bytes of x, 4 of md)
// and md written once (4 bytes); the arithmetic is ~3·d operations per row.
// At m·per = 1e6 rows and d = 2 that is 16 MB, 4.8 us at 3.35 TB/s.
// Design: one thread per row, neighbouring threads on neighbouring rows, so
// the loads of a warp are contiguous; no shared memory for x. CUDA blocks
// run in no order, so each block writes its tile's (max, first argmax)
// partial and a second kernel reduces the partials of each machine. Both
// merges order pairs by (value descending, row ascending), which is the
// first-occurrence argmax whatever order the pairs meet in. A float-only
// atomicMax would lose the index.
//
// Rounding: __fsub_rn/__fmul_rn/__fadd_rn keep nvcc from contracting
// diff*diff + s into an FMA, so the card rounds like the plain version
// (`(x - c) * (x - c)`, then the sum).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;
constexpr int kTileRows = kThreads * kRowsPerThread;  // REPRO_GON_TILE_ROWS
constexpr int kIdxNone = 0x7fffffff;

// (v, i) beats (bv, bi): larger value, or equal value at an earlier row.
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (beats(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// Block-wide (max, first argmax); the result is valid in thread 0.
__device__ __forceinline__ void block_argmax(float& v, int& i) {
  __shared__ float sv[32];
  __shared__ int si[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_argmax(v, i);
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    v = lane < nw ? sv[lane] : -CUDART_INF_F;
    i = lane < nw ? si[lane] : kIdxNone;
    warp_argmax(v, i);
  }
}

// grid (tiles, m): block (t, b) updates rows [t·kTileRows, (t+1)·kTileRows)
// of machine b and writes that tile's partial.
__global__ void __launch_bounds__(kThreads)
gon_tile_kernel(const float* __restrict__ x, const float* __restrict__ c,
                float* __restrict__ md, float* __restrict__ part_v,
                int* __restrict__ part_i, int per, int d, int ntiles) {
  const int b = blockIdx.y;
  const int t = blockIdx.x;
  const float* xb = x + (int64_t)b * per * d;
  const float* cb = c + (int64_t)b * d;  // same address across the warp
  float* mdb = md + (int64_t)b * per;
  float bv = -CUDART_INF_F;
  int bi = kIdxNone;
  const int row0 = t * kTileRows + threadIdx.x;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int row = row0 + r * kThreads;  // rows ascend within a thread
    if (row < per) {
      const float* xr = xb + (int64_t)row * d;
      float s = 0.0f;
      for (int j = 0; j < d; ++j) {
        const float diff = __fsub_rn(xr[j], cb[j]);
        s = __fadd_rn(s, __fmul_rn(diff, diff));
      }
      const float nm = fminf(mdb[row], s);
      mdb[row] = nm;
      if (beats(nm, row, bv, bi)) {
        bv = nm;
        bi = row;
      }
    }
  }
  block_argmax(bv, bi);
  if (threadIdx.x == 0) {
    part_v[(int64_t)b * ntiles + t] = bv;
    part_i[(int64_t)b * ntiles + t] = bi;
  }
}

// grid (m,): the ordered reduction of machine b's tile partials.
__global__ void __launch_bounds__(kThreads)
gon_reduce_kernel(const float* __restrict__ part_v,
                  const int* __restrict__ part_i, int ntiles,
                  float* __restrict__ far_v, int* __restrict__ far_i) {
  const int b = blockIdx.x;
  float bv = -CUDART_INF_F;
  int bi = kIdxNone;
  for (int t = threadIdx.x; t < ntiles; t += blockDim.x) {
    const float v = part_v[(int64_t)b * ntiles + t];
    const int i = part_i[(int64_t)b * ntiles + t];
    if (beats(v, i, bv, bi)) {
      bv = v;
      bi = i;
    }
  }
  block_argmax(bv, bi);
  if (threadIdx.x == 0) {
    far_v[b] = bv;
    far_i[b] = bi;
  }
}

}  // namespace

extern "C" {

int repro_gon_tile_rows() { return kTileRows; }

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (m, per, d), c (m, d), md (m, per) f32; part_v/part_i (m, ntiles) scratch;
// far_v (m,) f32, far_i (m,) int32. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError().
int repro_gon_step(const void* x, const void* c, void* md, void* part_v,
                   void* part_i, void* far_v, void* far_i, int m, int per,
                   int d, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ntiles = (per + kTileRows - 1) / kTileRows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gon_tile_kernel<<<dim3(ntiles, m), kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(c),
      static_cast<float*>(md), static_cast<float*>(part_v),
      static_cast<int*>(part_i), per, d, ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gon_reduce_kernel<<<m, kThreads, 0, s>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i),
      ntiles, static_cast<float*>(far_v), static_cast<int*>(far_i));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
