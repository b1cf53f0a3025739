// The register-tiled nearest-center core of assign.cu's
// `assign_tiled_kernel`, as the filter (fused_filter.cu
// `filter_tiled_kernel`) runs it: the pieces of a CTA of 256 threads that
// walks stages of 128·sub rows against centers staged once in shared memory.
//
//   * Rows are staged j-major, (d, xs) with xs = 128·sub + 4, by 4-byte
//     cp.async copies that are coalesced in global memory and transposed on
//     landing; each row's squared norm is taken once a stage, in j order.
//   * Centers are staged j-major too, (d, cs) with cs = cc + 1, cc centers
//     resident at once, with their j-order squared norms.
//   * 256 threads form 16 row groups × 16 center lanes (a warp: 2 row
//     groups); a thread holds the dot products of 8 rows × TC centers in
//     registers. Each j step reads two float4 of rows (broadcast over a half
//     warp) and TC center values (16 consecutive words) and feeds 8·TC FMAs.
//     The dot product runs by fmaf in j order from 0, so every pair rounds
//     as in assign.cu and dist2.cuh's other users.
//
// assign.cu keeps its own inline copy of these pieces: built on this
// header, nvcc gave its TC = 7 kernel 127 registers instead of 120, and the
// assign ran 3.3-3.8 % slower at k = 100, d = 38 on an H100 (its outputs
// bitwise the same), with the strides and the thread index passed in or
// not.

#pragma once

#include "cp_async.cuh"
#include "dist2.cuh"

namespace repro {
namespace tiled {

constexpr int kThreads = 256;  // a CTA: 16 row groups × 16 center lanes
constexpr int kRows = 128;     // rows of a sub-tile: 16 groups × 8

// The row of a 128-row sub-tile that row group ty holds in its slot i
// (0..7): ty·4 + 0..3 and 64 + ty·4 + 0..3, so that a slot's rows are two
// float4 apart.
__device__ __forceinline__ int sub_row(int ty, int i) {
  return i < 4 ? ty * 4 + i : 60 + ty * 4 + i;
}

// Issue the cp.async copies of stage `st` (rows [st·rows_stage, ...) of the
// n rows of x (n, d)) into dst (d, xs), j-major; dr and dj: 256 / d and
// 256 % d, the step of a thread's (row, j) between its copies. Every thread
// calls it; the caller commits and waits.
__device__ __forceinline__ void stage_rows(const float* __restrict__ x, int st, int rows_stage,
                                           int n, int d, int xs, int dr, int dj, int tid,
                                           float* dst) {
  const int nr = min(rows_stage, n - st * rows_stage);
  const float* src = x + static_cast<int64_t>(st) * rows_stage * d;
  int r = tid / d, j = tid - (tid / d) * d;  // element tid = r·d + j
  for (int e = tid; e < nr * d; e += kThreads) {
    cp_async4(dst + j * xs + r, src + e);
    j += dj;
    r += dr;
    if (j >= d) {
      j -= d;
      ++r;
    }
  }
}

// Stage centers q0 .. q0 + cc - 1 of c (k, d) into sct (d, cs), j-major.
// Slots past the k centers hold copies of center k - 1, which cannot change
// a minimum over the centers (the assign, which needs the argmin, stages
// zeros there and skips them by index). Every thread calls it.
__device__ __forceinline__ void stage_centers(const float* __restrict__ c, int q0, int k, int cc,
                                              int d, int cs, int tid, float* sct) {
  const int nc = min(cc, k - q0);
  for (int e = tid; e < cc * d; e += kThreads) {
    const int i = e / d, j = e - i * d;
    sct[j * cs + i] = c[static_cast<int64_t>(q0 + min(i, nc - 1)) * d + j];
  }
}

// The squared norms of the cc staged centers, in j order, into scn. Call it
// after a barrier behind stage_centers.
__device__ __forceinline__ void center_norms(const float* sct, int cc, int d, int cs, int tid,
                                             float* scn) {
  for (int i = tid; i < cc; i += kThreads) {
    float acc = 0.0f;
    for (int j = 0; j < d; ++j) {
      const float v = sct[j * cs + i];
      acc = __fadd_rn(acc, __fmul_rn(v, v));
    }
    scn[i] = acc;
  }
}

// The squared norms of a landed stage's nr rows, in j order, into sxn.
__device__ __forceinline__ void row_norms(const float* sx, int nr, int d, int xs, int tid,
                                          float* sxn) {
  for (int r = tid; r < nr; r += kThreads) {
    float acc = 0.0f;
    for (int j = 0; j < d; ++j) {
      const float v = sx[j * xs + r];
      acc = __fadd_rn(acc, __fmul_rn(v, v));
    }
    sxn[r] = acc;
  }
}

// acc[i][ci] = x_row . c_center by fmaf in j order from 0, for the thread's
// 8 rows (xr: the stage at the sub-tile's row ty·4) and its TC centers
// (cr: the staged centers at the tile's center tx; center ci is 16·ci on).
template <int TC>
__device__ __forceinline__ void dot_tile(const float* xr, int xs, const float* cr, int cs,
                                         int d, float (&acc)[8][TC]) {
#pragma unroll
  for (int ri = 0; ri < 8; ++ri) {
#pragma unroll
    for (int ci = 0; ci < TC; ++ci) acc[ri][ci] = 0.0f;
  }
  for (int j = 0; j < d; ++j) {
    const float4 a0 = *reinterpret_cast<const float4*>(xr + j * xs);
    const float4 a1 = *reinterpret_cast<const float4*>(xr + j * xs + 64);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    float b[TC];
#pragma unroll
    for (int ci = 0; ci < TC; ++ci) b[ci] = cr[j * cs + 16 * ci];
#pragma unroll
    for (int ri = 0; ri < 8; ++ri) {
#pragma unroll
      for (int ci = 0; ci < TC; ++ci) acc[ri][ci] = fmaf(a[ri], b[ci], acc[ri][ci]);
    }
  }
}

}  // namespace tiled
}  // namespace repro
