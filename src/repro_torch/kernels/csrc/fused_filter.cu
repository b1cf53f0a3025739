// Streamed filter step for Hopper (sm_90a): distance min-update plus each
// tile's top-`rank` of the candidates, in one pass over a block of points.
//
// Replaces the TPU kernels src/repro/kernels/fused_stream.py
// `fused_filter_blocks` (body `_filter_kernel`, with `_dist2_tile` and
// `_top_rank`) and its weighted sibling `fused_filter_blocks_w` (body
// `_filter_kernel_w`). For every row x_i of x (n, d) and centers c (k, d):
//   new_ds[i] = min(ds[i], min_q d2(x_i, c_q))      (ds null: +3.4e38)
//   cand[i]   = hm[i] && w[i] > 0 ? new_ds[i] : -3.4e38
//               (hm null: every row; w null, the plain entry: every row)
//   tops[t]   = descending top-min(rank, 256) of cand over tile t (256
//               rows), slots past the tile's rows filled with -3.4e38
// `new_ds` is written in place over `ds`, and only when `ds` is given:
// at rank 1 with no ds this is the covering-radius fold's block maximum,
// which then reads nothing but x and writes one float a tile. The weights
// gate candidacy only: a row with w <= 0 (absent from the weighted
// instance, or padding) still updates its ds, as in the TPU body. The
// plain and the weighted entry launch the same kernel, so with w > 0
// everywhere the weighted one is bitwise the plain one.
//
// Bound on this card: operations at large k·d (each pair ~2·d + 5 f32
// operations against 4·d bytes a row, 4 more with weights); at k = 25,
// d = 2 bytes.
// Design: one thread per row, one 256-row tile per CUDA block. The distance
// pass is dist2.cuh's nearest_center, as in assign.cu: centers staged in
// shared memory in tiles of `tc` (the TPU keeps the whole center set in
// VMEM; shared memory holds ~48 KB, so the block loops over center tiles),
// so this kernel's min d2 is bitwise assign.cu's. The TPU extracts the
// per-tile top-rank by `rank` unrolled argmax-and-mask steps over its lanes.
// A tile has 256 candidates, so it has at most 256 values to give: the
// kernel writes the first min(rank, 256) slots of a tile's row of `tops`
// and the wrapper fills the rest with -3.4e38. Below kSortRank each slot is
// one block-wide (max, first row) reduction whose winning thread masks its
// candidate to -3.4e38, so duplicates keep their multiplicity; from
// kSortRank on, the tile's 256 candidates are sorted in shared memory by a
// bitonic network (36 compare-exchange stages of one barrier each, against
// two barriers per extracted slot) and the first slots copied out. Both
// give the same value multiset. Per-tile top values depend on the tile
// size; the engine merges the tiles with torch.topk, and the merged values
// do not.

#include "dist2.cuh"

namespace {

constexpr int kThreads = 256;  // rows per tile: REPRO_FILTER_TILE_ROWS
// From this rank on, a tile sorts its candidates instead of extracting
// them one slot at a time.
constexpr int kSortRank = 32;
constexpr float kBig = 3.4e38f;
constexpr float kNeg = -3.4e38f;

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

// The tile's candidates sorted descending in shared memory `sv` (one per
// thread, kThreads of them). Ties need no order: equal values are
// interchangeable in a top-k of values.
__device__ __forceinline__ void bitonic_desc(float* sv) {
  const int t = threadIdx.x;
#pragma unroll 1
  for (int size = 2; size <= kThreads; size <<= 1) {
#pragma unroll 1
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const int p = t ^ stride;
      if (p > t) {
        const float a = sv[t];
        const float b = sv[p];
        // the pair (t, p) ends descending where bit `size` of t is 0
        const bool desc = (t & size) == 0;
        if (desc ? a < b : a > b) {
          sv[t] = b;
          sv[p] = a;
        }
      }
      __syncthreads();
    }
  }
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
filter_kernel(const float* __restrict__ x, const float* __restrict__ c,
              float* ds, const bool* __restrict__ hm,
              const float* __restrict__ w, int n, int k, int d, int tc,
              int rank, float* __restrict__ tops) {
  extern __shared__ float smem[];
  __shared__ float sv[kThreads];
  __shared__ int si[kThreads / 32];
  __shared__ int win;
  const int64_t row = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool live = row < n;
  repro::Row<DMAX> xr;
  if (live) xr.load(x + row * d, d);
  float best;
  int best_i;
  repro::nearest_center(xr, live, c, k, d, tc, smem, best, best_i);

  float cand = kNeg;
  if (live) {
    const float nd = fminf(ds != nullptr ? ds[row] : kBig, best);
    if (ds != nullptr) ds[row] = nd;
    if ((hm == nullptr || hm[row]) && (w == nullptr || w[row] > 0.0f)) {
      cand = nd;
    }
  }

  // a tile has kThreads candidates: slots past them are the wrapper's
  const int slots = min(rank, kThreads);
  float* out = tops + (int64_t)blockIdx.x * rank;
  if (rank >= kSortRank) {
    sv[threadIdx.x] = cand;
    __syncthreads();
    bitonic_desc(sv);
    if (threadIdx.x < slots) out[threadIdx.x] = sv[threadIdx.x];
    return;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = 0; r < slots; ++r) {
    float v = cand;
    int i = threadIdx.x;
    warp_argmax(v, i);
    if (lane == 0) {
      sv[warp] = v;
      si[warp] = i;
    }
    __syncthreads();
    if (warp == 0) {
      v = lane < kThreads / 32 ? sv[lane] : -__int_as_float(0x7f800000);
      i = lane < kThreads / 32 ? si[lane] : kThreads;
      warp_argmax(v, i);
      if (lane == 0) {
        win = i;
        out[r] = v;
      }
    }
    __syncthreads();
    if (threadIdx.x == win) cand = kNeg;
  }
}

int launch_filter(const void* x, const void* c, void* ds, const void* hm,
                  const void* w, void* tops, int n, int k, int d, int tc,
                  int rank, int device, void* stream) {
  if (rank < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* xp = static_cast<const float*>(x);
  const float* cp = static_cast<const float*>(c);
  float* dsp = static_cast<float*>(ds);
  const bool* hp = static_cast<const bool*>(hm);
  const float* wp = static_cast<const float*>(w);
  float* tp = static_cast<float*>(tops);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (n + kThreads - 1) / kThreads;
  const size_t smem = sizeof(float) * (size_t)tc * (d + 1);
  repro::dispatch_d(d, [&](auto dmax) {
    filter_kernel<decltype(dmax)::value><<<blocks, kThreads, smem, s>>>(
        xp, cp, dsp, hp, wp, n, k, d, tc, rank, tp);
  });
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int repro_filter_tile_rows() { return kThreads; }

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (n, d), c (k, d) f32; ds (n,) f32 or null, updated in place; hm (n,)
// bool or null; tops (ceil(n / 256), rank) f32, rank >= 1, of which the
// kernel writes the first min(rank, 256) columns. `tc` centers per
// shared-memory tile: tc·(d + 1)·4 bytes within 48 KB. Launches on
// `stream`, does not synchronise, and returns cudaGetLastError().
int repro_fused_filter(const void* x, const void* c, void* ds, const void* hm,
                       void* tops, int n, int k, int d, int tc, int rank,
                       int device, void* stream) {
  return launch_filter(x, c, ds, hm, nullptr, tops, n, k, d, tc, rank, device,
                       stream);
}

// The weighted entry: as repro_fused_filter, plus w (n,) f32, which gates
// candidacy (rows with w <= 0 never enter the top-k).
int repro_fused_filter_w(const void* x, const void* c, void* ds,
                         const void* hm, const void* w, void* tops, int n,
                         int k, int d, int tc, int rank, int device,
                         void* stream) {
  if (w == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_filter(x, c, ds, hm, w, tops, n, k, d, tc, rank, device,
                       stream);
}

}  // extern "C"
