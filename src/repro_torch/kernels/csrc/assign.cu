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
// Batched entry: m machine blocks x (m, per, d) against their own centers
// c (m, k, d), the machine a second grid axis (blockIdx.y), as in the GON
// step; the weighted round-1 reducer assigns each machine's rows to that
// machine's centers with it. The 2-D entry is the same kernel with one
// machine, so a batch of one is bitwise the 2-D entry.
//
// Rounding: dist2.cuh, which every nearest-center kernel of the port
// shares, so a pair rounds the same in each of them.

#include "dist2.cuh"

namespace {

constexpr int kThreads = 128;

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
assign_kernel(const float* __restrict__ x, const float* __restrict__ c, int n,
              int k, int d, int tc, int* __restrict__ idx_out,
              float* __restrict__ d2_out) {
  extern __shared__ float smem[];
  // machine blockIdx.y: its rows, its centers and its outputs
  x += (int64_t)blockIdx.y * n * d;
  c += (int64_t)blockIdx.y * k * d;
  idx_out += (int64_t)blockIdx.y * n;
  d2_out += (int64_t)blockIdx.y * n;
  const int64_t row = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool live = row < n;
  repro::Row<DMAX> xr;
  if (live) xr.load(x + row * d, d);
  float best;
  int best_i;
  repro::nearest_center(xr, live, c, k, d, tc, smem, best, best_i);
  if (live) {
    idx_out[row] = best_i;
    d2_out[row] = best;
  }
}

int launch_assign(const void* x, const void* c, void* idx, void* d2, int m,
                  int n, int k, int d, int tc, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* xp = static_cast<const float*>(x);
  const float* cp = static_cast<const float*>(c);
  int* ip = static_cast<int*>(idx);
  float* dp = static_cast<float*>(d2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kThreads - 1) / kThreads, m);
  const size_t smem = sizeof(float) * (size_t)tc * (d + 1);
  repro::dispatch_d(d, [&](auto dmax) {
    assign_kernel<decltype(dmax)::value>
        <<<grid, kThreads, smem, s>>>(xp, cp, n, k, d, tc, ip, dp);
  });
  return static_cast<int>(cudaGetLastError());
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
  return launch_assign(x, c, idx, d2, 1, n, k, d, tc, device, stream);
}

// Batched: x (m, per, d) against c (m, k, d) f32, machine by machine;
// idx (m, per) int32, d2 (m, per) f32; 1 <= m <= 65535.
int repro_assign_nearest_batched(const void* x, const void* c, void* idx,
                                 void* d2, int m, int per, int k, int d,
                                 int tc, int device, void* stream) {
  return launch_assign(x, c, idx, d2, m, per, k, d, tc, device, stream);
}

}  // extern "C"
