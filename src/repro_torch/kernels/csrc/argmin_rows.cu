// Per-center nearest row for Hopper (sm_90a), folded across blocks.
//
// Replaces the TPU kernel src/repro/kernels/fused_stream.py
// `fused_argmin_blocks` (body `_argmin_rows_kernel`). For every center c_q of
// c (m, d) and the rows x_r of x (n, d), numbered off + r in the source:
//   key(q, r)  = float_bits(d2(x_r, c_q)) << 32 | (off + r)
//   carry[q]   = min(carry[q], min_r key(q, r))       (64-bit, unsigned)
// d2 is dist2.cuh's clamped decomposition, >= +0 and never -0, so its float
// bits order as unsigned integers like its values, and the packed minimum is
// the smallest d2 at its first row. The engine starts the carry at
// (3.4e38, row 0) and passes one block after another with growing `off`:
// the carry then ends, over the whole source, at the global first argmin,
// which is the TPU's strict-< merge of per-tile (min, first argmin) pairs.
// Rows past n are never read, so they never win, and n = 0 leaves the
// carry as it was.
//
// Bound on this card: operations (each pair ~2·d + 5 f32 operations; a row
// is read once, 4·d bytes, for all m centers).
// Design: the TPU accumulates the (m,) carry over a sequential grid into a
// revisited output block; CUDA blocks run in no order, so the order-free
// packed minimum with a 64-bit atomicMin takes its place. A block stages a
// tile of rows in shared memory with their norms (dist2.cuh's stage_tile),
// and each thread holds one center in registers and walks a share of the
// tile's rows: with mc <= 256 centers in flight, 256 / mc groups of threads
// split the rows, so a warp reads one or two rows at a time and the shared
// reads broadcast. Blocks walk the row tiles grid-stride, keep their running
// key in a register across tiles, and end with one atomicMin per thread,
// skipped when the carry already holds a smaller key (the carry only
// decreases, so a stale read costs an atomic and never a wrong answer).
// Past 256 centers the block repeats the walk for each chunk of 256.

#include <algorithm>

#include "dist2.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileFloats = 8192;  // staged rows and norms: 32 KB
constexpr int kMaxTileRows = 1024;

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
argmin_rows_kernel(const float* __restrict__ x, const float* __restrict__ c,
                   unsigned long long* carry, int n, int m, int d, int off,
                   int tile_rows) {
  extern __shared__ float smem[];
  float* sx = smem;                   // (tile_rows, d) staged rows
  float* sxn = smem + tile_rows * d;  // (tile_rows,) their squared norms
  const int ntiles = (n + tile_rows - 1) / tile_rows;
  for (int q0 = 0; q0 < m; q0 += kThreads) {
    const int mc = min(kThreads, m - q0);
    const int groups = kThreads / mc;
    const bool active = threadIdx.x < groups * mc;
    const int q = q0 + threadIdx.x % mc;
    const int g = threadIdx.x / mc;
    repro::Row<DMAX> cq;
    if (active) cq.load(c + (int64_t)q * d, d);
    unsigned long long best = ~0ull;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const int r0 = t * tile_rows;
      const int nr = min(tile_rows, n - r0);
      __syncthreads();  // the previous tile is consumed
      repro::stage_tile(x + (int64_t)r0 * d, nr, d, sx, sxn);
      if (active) {
        for (int r = g; r < nr; r += groups) {
          const float d2 =
              repro::clamped_d2(sxn[r], cq.norm, cq.dot(sx + r * d, d));
          const unsigned long long key =
              ((unsigned long long)__float_as_uint(d2) << 32) |
              (unsigned int)(off + r0 + r);
          if (key < best) best = key;
        }
      }
    }
    if (active && best < carry[q]) atomicMin(carry + q, best);
  }
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (n, d), c (m, d) f32; carry (m,) packed keys (uint64), updated in place.
// Row r of x is numbered off + r; off + n < 2^31. Launches on `stream`, does
// not synchronise, and returns cudaGetLastError().
int repro_argmin_rows(const void* x, const void* c, void* carry, int n, int m,
                      int d, int off, int device, void* stream) {
  if (n <= 0 || m <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tile_rows = std::min(kMaxTileRows, kTileFloats / (d + 1));
  const int ntiles = (n + tile_rows - 1) / tile_rows;
  const int blocks = std::min(ntiles, 4 * sms);
  const size_t smem = sizeof(float) * (size_t)tile_rows * (d + 1);
  const float* xp = static_cast<const float*>(x);
  const float* cp = static_cast<const float*>(c);
  unsigned long long* kp = static_cast<unsigned long long*>(carry);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  repro::dispatch_d(d, [&](auto dmax) {
    argmin_rows_kernel<decltype(dmax)::value>
        <<<blocks, kThreads, smem, s>>>(xp, cp, kp, n, m, d, off, tile_rows);
  });
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
