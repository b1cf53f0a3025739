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
// plain and the weighted entry launch the same kernels, so with w > 0
// everywhere the weighted one is bitwise the plain one.
//
// Bound on this card: operations at large k·d (each pair ~2·d + 5 f32
// operations against 4·d bytes a row, 4 more with weights); at k = 25,
// d = 2 about even between operations and bytes.
//
// Three kernels compute the min over the centers; fused_stream.py's
// `filter_plan` picks one from n, k and d:
//   * filter_tiled_kernel (d past SMALL_MAX_D and k·d from TILED_MIN_KD,
//     while a 16-center tile fits): tiled_min.cuh's register-tiled core,
//     as the assign runs it: persistent CTAs (2 a SM), double-buffered
//     cp.async row stages, centers staged once a CTA, 8 rows × TC centers
//     a thread. A pair costs its dot product, the clamp and one fminf: the
//     filter needs the min, not the argmin, so no index is carried, and
//     center slots past k hold copies of the last center instead of being
//     skipped. A tile (256 rows) is one 256-row stage, or two 128-row
//     stages of the same CTA where two 256-row stages would not fit two
//     CTAs a SM, and the grid strides over tiles; the lane that owns a row
//     writes its ds and its candidate into the tile's 256 floats of shared
//     memory.
//   * filter_small_kernel (d <= SMALL_MAX_D): a thread holds row tid of
//     each of a CTA's 4 tiles in registers, the centers are staged once a
//     CTA as float4 (coordinates padded with zeros to D, then the norm),
//     so one broadcast shared load feeds 4 pairs; no cross-lane merge.
//   * filter_wide_kernel (the rest: small k·d, and d past ~200): one
//     thread a row, one tile a CTA, dist2.cuh's nearest_center (the
//     design the other two replaced on the main paths).
// All three round every pair through dist2.cuh's clamped_d2 with the dot
// product by fmaf in j order from 0 and j-order norms (a zero coordinate
// on both sides leaves a sum and a norm as it was, a -0 dot product aside,
// which the clamp cannot tell from +0), and d2 is never NaN or -0, so
// their min, ds and candidates are bitwise equal.
//
// The tile's top-rank (tile_tops), the same for the three: rank 1 is a
// block (max, first row) reduction. From rank 2 each warp sorts its 32
// candidates descending in registers by a shuffle bitonic network, the 8
// runs go to shared memory, and each thread finds its value's place in the
// tile's order by binary search in the other 7 runs (ties to the lower
// run), writing it straight to tops when the place is below min(rank,
// 256): two barriers a tile, whatever the rank; the small-d kernel's 4
// tiles go through it together, so that their steps overlap. Equal values are
// interchangeable, so tops are bitwise any other exact top-k's, +0 against
// -0 aside, which only a ds holding -0 can bring (d2 is never -0). Per-tile
// top values depend on the tile size; the engine merges the tiles with
// torch.topk, and the merged values do not.

#include "tiled_min.cuh"

namespace {

constexpr int kTile = 256;       // rows a tile (REPRO_FILTER_TILE_ROWS), threads a CTA
constexpr int kSmallTiles = 4;   // tiles a CTA of filter_small_kernel holds, a row each a thread
constexpr float kBig = 3.4e38f;
constexpr float kNeg = -3.4e38f;
static_assert(repro::tiled::kThreads == kTile, "a tiled CTA's threads");

// Routes of fused_stream.py's FilterPlan.
constexpr int kRouteWide = 0;
constexpr int kRouteSmall = 1;
constexpr int kRouteTiled = 2;

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

// Each of R values a lane (v[i] over the warp's 32 lanes) sorted
// descending across the lanes by a bitonic network of shuffles, the R
// networks interleaved. Both lanes of a pair take one decision from the
// same two values, so each multiset is kept as it was.
template <int R>
__device__ __forceinline__ void warp_sort_desc(float (&v)[R]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const bool lower = (lane & stride) == 0;
      // the block of `size` lanes ends descending where bit `size` is 0
      const bool desc = (lane & size) == 0;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float o = __shfl_xor_sync(0xffffffffu, v[i], stride);
        const float a = lower ? v[i] : o;  // the pair's lower lane's value
        const float b = lower ? o : v[i];
        if (desc ? a < b : a > b) v[i] = o;
      }
    }
  }
}

// How many of a descending run's 32 values come before v: those >= v
// (ties, a lower run) or those > v.
__device__ __forceinline__ int run_before(const float* run, float v, bool ties) {
  int c = 0;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const float u = run[c + s - 1];
    if (u > v || (ties && u == v)) c += s;
  }
  const float u = run[c];
  return c + ((u > v || (ties && u == v)) ? 1 : 0);
}

// The descending top-min(rank, 256) of R consecutive tiles t0 .. t0 + R - 1
// (cand[i]: this thread's candidate of tile t0 + i; every thread of the CTA
// calls it) into their rows of tops (ceil(n / 256), rank), tiles from
// `ntiles` on skipped. `buf`: R·256 floats of shared memory, which the
// caller may have read its candidates from; the first barrier orders those
// reads before the writes here. The R tiles go through each step together,
// so their shuffles and searches overlap.
template <int R>
__device__ __forceinline__ void tile_tops(const float (&cand)[R], int rank, float* buf,
                                          float* __restrict__ tops, int t0, int ntiles) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kTile / 32;
  if (rank == 1) {
    float v[R];
    int idx[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      v[i] = cand[i];
      idx[i] = tid;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float ov = __shfl_down_sync(0xffffffffu, v[i], off);
        const int oi = __shfl_down_sync(0xffffffffu, idx[i], off);
        if (beats(ov, oi, v[i], idx[i])) {
          v[i] = ov;
          idx[i] = oi;
        }
      }
    }
    int* const ibuf = reinterpret_cast<int*>(buf + R * kWarps);
    __syncthreads();
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        buf[i * kWarps + warp] = v[i];
        ibuf[i * kWarps + warp] = idx[i];
      }
    }
    __syncthreads();
    if (warp < R && t0 + warp < ntiles) {  // warp i merges tile t0 + i
      float u = lane < kWarps ? buf[warp * kWarps + lane] : -__int_as_float(0x7f800000);
      int j = lane < kWarps ? ibuf[warp * kWarps + lane] : kTile;
      warp_argmax(u, j);
      if (lane == 0) tops[static_cast<int64_t>(t0 + warp) * rank] = u;
    }
    return;
  }
  float v[R];
#pragma unroll
  for (int i = 0; i < R; ++i) v[i] = cand[i];
  warp_sort_desc<R>(v);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < R; ++i) buf[i * kTile + tid] = v[i];
  __syncthreads();
  const int slots = min(rank, kTile);
  if (lane >= slots) return;  // a place is at least the lane's
  int pos[R];
#pragma unroll
  for (int i = 0; i < R; ++i) pos[i] = lane;
#pragma unroll
  for (int r = 0; r < kWarps; ++r) {
    const bool ties = r < warp;  // a lower run's equal values come first
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int c = run_before(buf + i * kTile + 32 * r, v[i], ties);
      pos[i] += r == warp ? 0 : c;
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (t0 + i < ntiles && pos[i] < slots) {
      tops[static_cast<int64_t>(t0 + i) * rank + pos[i]] = v[i];
    }
  }
}

// A row's new ds and candidate (the lane that owns row `row`).
__device__ __forceinline__ float row_candidate(int64_t row, float best, float* ds,
                                               const bool* __restrict__ hm,
                                               const float* __restrict__ w) {
  const float nd = fminf(ds != nullptr ? ds[row] : kBig, best);
  if (ds != nullptr) ds[row] = nd;
  const bool in = (hm == nullptr || hm[row]) && (w == nullptr || w[row] > 0.0f);
  return in ? nd : kNeg;
}

template <int TC>
__global__ void __launch_bounds__(kTile, 2)
filter_tiled_kernel(const float* __restrict__ x, const float* __restrict__ c, float* ds,
                    const bool* __restrict__ hm, const float* __restrict__ w, int n, int k,
                    int d, int sub, int chunk, int rank, float* __restrict__ tops) {
  using repro::tiled::kRows;
  constexpr int C = 16 * TC;
  const int rows_stage = kRows * sub;  // 128 or 256
  const int spt = kTile / rows_stage;  // stages a tile: 2 or 1
  const int xs = rows_stage + 4;       // floats between two dims of a row stage
  const int cc = chunk * C;            // centers resident at once
  const int cs = cc + 1;               // floats between two dims of the centers
  const int nchunks = (k + cc - 1) / cc;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  float* const sx0 = smem;               // (d, xs) rows, j-major, stage 0
  float* const sx1 = smem + d * xs;      // stage 1
  float* const sxn = smem + 2 * d * xs;  // (rows_stage,) row norms
  float* const scand = sxn + rows_stage; // (256,) the tile's candidates
  float* const sct = scand + kTile;      // (d, cs) centers, j-major
  float* const scn = sct + d * cs;       // (cc,) center norms
  float* const sbd = scn + cc;           // (rows_stage,) a row's min over the chunks so far

  const int tid = threadIdx.x, lane = tid & 31;
  const int tx = lane & 15;                     // center lane 0..15
  const int ty = (tid >> 5) * 2 + (lane >> 4);  // row group 0..15
  const int dr = kTile / d, dj = kTile - dr * d;
  const int ntiles = (n + kTile - 1) / kTile;
  // the CTA's m-th stage: stage m % spt of its tile blockIdx.x + (m / spt)
  // · gridDim.x, or -1 past the last tile
  auto stage_of = [&](int m) {
    const int t = blockIdx.x + (m / spt) * gridDim.x;
    return t < ntiles ? t * spt + m % spt : -1;
  };

  if (nchunks == 1) repro::tiled::stage_centers(c, 0, k, cc, d, cs, tid, sct);
  int st = stage_of(0);
  if (st >= 0) repro::tiled::stage_rows(x, st, rows_stage, n, d, xs, dr, dj, tid, sx0);
  repro::cp_async_commit();
  __syncthreads();  // the centers are staged
  if (nchunks == 1) repro::tiled::center_norms(sct, cc, d, cs, tid, scn);

  for (int m = 0; st >= 0; ++m) {
    const int buf = m & 1;
    repro::cp_async_wait<0>();
    __syncthreads();  // stage st has landed; the previous stage and tile are consumed
    const int next = stage_of(m + 1);
    if (next >= 0) {
      repro::tiled::stage_rows(x, next, rows_stage, n, d, xs, dr, dj, tid, buf ? sx0 : sx1);
    }
    repro::cp_async_commit();
    const float* sx = buf ? sx1 : sx0;
    const int r0 = st * rows_stage;
    const int nr = min(rows_stage, n - r0);  // <= 0: a tile's second stage past n
    repro::tiled::row_norms(sx, nr, d, xs, tid, sxn);
    float* const cand = scand + (m % spt) * rows_stage;
    for (int ch = 0; ch < nchunks; ++ch) {
      const int q0 = ch * cc;
      if (nchunks > 1) {
        __syncthreads();  // the previous chunk is consumed
        repro::tiled::stage_centers(c, q0, k, cc, d, cs, tid, sct);
        __syncthreads();
        repro::tiled::center_norms(sct, cc, d, cs, tid, scn);
      }
      __syncthreads();  // the row norms and the chunk's centers are ready
      const int nct = min(chunk, (k - q0 + C - 1) / C);
      for (int s0 = 0; s0 < nr; s0 += kRows) {
        float best[8];
#pragma unroll
        for (int ri = 0; ri < 8; ++ri) best[ri] = __int_as_float(0x7f800000);  // +inf
        const float* xr = sx + s0 + ty * 4;
        for (int t = 0; t < nct; ++t) {
          float acc[8][TC];
          repro::tiled::dot_tile<TC>(xr, xs, sct + t * C + tx, cs, d, acc);
#pragma unroll
          for (int ri = 0; ri < 8; ++ri) {
            const float xn = sxn[s0 + repro::tiled::sub_row(ty, ri)];
#pragma unroll
            for (int ci = 0; ci < TC; ++ci) {
              best[ri] = fminf(best[ri],
                               repro::clamped_d2(xn, scn[t * C + tx + 16 * ci], acc[ri][ci]));
            }
          }
        }
        // the min over the 16 center lanes of each row
#pragma unroll
        for (int ri = 0; ri < 8; ++ri) {
#pragma unroll
          for (int off = 1; off < 16; off <<= 1) {
            best[ri] = fminf(best[ri], __shfl_xor_sync(0xffffffffu, best[ri], off));
          }
        }
        // lane tx < 8 owns row tx of its group
        float mine = best[0];
#pragma unroll
        for (int ri = 1; ri < 8; ++ri) {
          if (tx == ri) mine = best[ri];
        }
        const int r = s0 + repro::tiled::sub_row(ty, tx);
        if (tx < 8 && r < nr) {
          if (nchunks > 1) {  // fold in the earlier chunks
            if (ch > 0) mine = fminf(mine, sbd[r]);
            sbd[r] = mine;
          }
          if (ch + 1 == nchunks) {
            cand[r] = row_candidate(static_cast<int64_t>(r0) + r, mine, ds, hm, w);
          }
        }
      }
    }
    if (m % spt == spt - 1) {  // the tile's last stage: its candidates are in
      __syncthreads();
      const int t = st / spt;
      const float v[1] = {static_cast<int64_t>(t) * kTile + tid < n ? scand[tid] : kNeg};
      tile_tops<1>(v, rank, scand, tops, t, ntiles);
    }
    st = next;
  }
}

// D: the register width, 2, 4 or 8 (coordinates d .. D - 1 are zeros).
// Three CTAs a SM: held to four, D = 2 spilled and ran 2-3 % slower.
template <int D>
__global__ void __launch_bounds__(kTile, 3)
filter_small_kernel(const float* __restrict__ x, const float* __restrict__ c, float* ds,
                    const bool* __restrict__ hm, const float* __restrict__ w, int n, int k,
                    int d, int kc, int rank, float* __restrict__ tops) {
  constexpr int W = D / 4 + 1;  // float4 a center: its D coordinates, then its norm
  constexpr int R = kSmallTiles;
  extern __shared__ float4 sc[];  // (kc, W) centers
  __shared__ float runs[R * kTile];
  const int tid = threadIdx.x;
  const int ntiles = (n + kTile - 1) / kTile;
  const int groups = (ntiles + R - 1) / R;
  const int nchunks = (k + kc - 1) / kc;
  auto stage = [&](int q0) {  // centers q0 .. q0 + kc - 1, with their j-order norms
    const int nc = min(kc, k - q0);
    for (int q = tid; q < nc; q += kTile) {
      float v[4 * W];
      float norm = 0.0f;
#pragma unroll
      for (int j = 0; j < 4 * W; ++j) {
        v[j] = j < D && j < d ? c[static_cast<int64_t>(q0 + q) * d + j] : 0.0f;
        if (j < D && j < d) norm = __fadd_rn(norm, __fmul_rn(v[j], v[j]));
      }
      v[D] = norm;
#pragma unroll
      for (int u = 0; u < W; ++u) {
        sc[q * W + u] = make_float4(v[4 * u], v[4 * u + 1], v[4 * u + 2], v[4 * u + 3]);
      }
    }
  };
  for (int g = blockIdx.x; g < groups; g += gridDim.x) {
    // the rows first, so that their loads overlap the centers' staging
    float xv[R][D], xn[R], best[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int64_t row = (static_cast<int64_t>(g) * R + i) * kTile + tid;
      xn[i] = 0.0f;
      best[i] = __int_as_float(0x7f800000);  // +inf
#pragma unroll
      for (int j = 0; j < D; ++j) {
        xv[i][j] = row < n && j < d ? x[row * d + j] : 0.0f;
        if (j < d) xn[i] = __fadd_rn(xn[i], __fmul_rn(xv[i][j], xv[i][j]));
      }
    }
    for (int ch = 0; ch < nchunks; ++ch) {
      const int q0 = ch * kc;
      if (nchunks > 1 || g == static_cast<int>(blockIdx.x)) {  // staged once if all fit
        __syncthreads();  // the previous chunk is consumed
        stage(q0);
        __syncthreads();
      }
      const int nc = min(kc, k - q0);
#pragma unroll 2
      for (int q = 0; q < nc; ++q) {
        float cv[4 * W];
#pragma unroll
        for (int u = 0; u < W; ++u) {
          const float4 f = sc[q * W + u];
          cv[4 * u] = f.x;
          cv[4 * u + 1] = f.y;
          cv[4 * u + 2] = f.z;
          cv[4 * u + 3] = f.w;
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
          float dot = 0.0f;
#pragma unroll
          for (int j = 0; j < D; ++j) dot = fmaf(xv[i][j], cv[j], dot);
          best[i] = fminf(best[i], repro::clamped_d2(xn[i], cv[D], dot));
        }
      }
    }
    float cand[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int64_t row = (static_cast<int64_t>(g) * R + i) * kTile + tid;
      cand[i] = row < n ? row_candidate(row, best[i], ds, hm, w) : kNeg;
    }
    tile_tops<R>(cand, rank, runs, tops, g * R, ntiles);
  }
}

// One thread a row, one tile a CTA, `tc` centers a shared-memory tile.
template <int DMAX>
__global__ void __launch_bounds__(kTile)
filter_wide_kernel(const float* __restrict__ x, const float* __restrict__ c, float* ds,
                   const bool* __restrict__ hm, const float* __restrict__ w, int n, int k,
                   int d, int tc, int rank, float* __restrict__ tops) {
  extern __shared__ float smem[];  // (tc, d + 1) center tile
  __shared__ float runs[kTile];
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
  const bool live = row < n;
  repro::Row<DMAX> xr;
  if (live) xr.load(x + row * d, d);
  float best;
  int best_i;
  repro::nearest_center(xr, live, c, k, d, tc, smem, best, best_i);
  const float cand[1] = {live ? row_candidate(row, best, ds, hm, w) : kNeg};
  tile_tops<1>(cand, rank, runs, tops, blockIdx.x, gridDim.x);
}

// The shared memory each tiled variant was allowed so far, a device each.
template <int TC>
std::atomic<int> tiled_allowed[repro::kMaxDevices];

template <int TC>
cudaError_t launch_tiled(int grid, int smem, int device, cudaStream_t stream, const float* x,
                         const float* c, float* ds, const bool* hm, const float* w, int n,
                         int k, int d, int sub, int chunk, int rank, float* tops) {
  auto kernel = filter_tiled_kernel<TC>;
  const cudaError_t err = repro::allow_smem(kernel, smem, device, tiled_allowed<TC>);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kTile, smem, stream>>>(x, c, ds, hm, w, n, k, d, sub, chunk, rank, tops);
  return cudaGetLastError();
}

// One launch of fused_stream.py's FilterPlan (route, tc, sub, chunk,
// grid_x, smem): the tiled kernel with TC = tc, 128·sub-row stages and
// `chunk` center tiles resident; the small-d kernel with D = tc and
// `chunk` centers a shared chunk; the wide kernel with `chunk` centers a
// shared tile.
int launch_filter(const void* x, const void* c, void* ds, const void* hm, const void* w,
                  void* tops, int n, int k, int d, int rank, int route, int tc, int sub,
                  int chunk, int grid_x, int smem, int device, void* stream) {
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
  if (route == kRouteSmall) {
    switch (tc) {
      case 2: filter_small_kernel<2><<<grid_x, kTile, smem, s>>>(xp, cp, dsp, hp, wp, n, k, d, chunk, rank, tp); break;
      case 4: filter_small_kernel<4><<<grid_x, kTile, smem, s>>>(xp, cp, dsp, hp, wp, n, k, d, chunk, rank, tp); break;
      case 8: filter_small_kernel<8><<<grid_x, kTile, smem, s>>>(xp, cp, dsp, hp, wp, n, k, d, chunk, rank, tp); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (route == kRouteWide) {
    repro::dispatch_d(d, [&](auto dmax) {
      filter_wide_kernel<decltype(dmax)::value><<<grid_x, kTile, smem, s>>>(
          xp, cp, dsp, hp, wp, n, k, d, chunk, rank, tp);
    });
    return static_cast<int>(cudaGetLastError());
  }
  if (route != kRouteTiled || (sub != 1 && sub != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (tc) {
    case 1: err = launch_tiled<1>(grid_x, smem, device, s, xp, cp, dsp, hp, wp, n, k, d, sub, chunk, rank, tp); break;
    case 2: err = launch_tiled<2>(grid_x, smem, device, s, xp, cp, dsp, hp, wp, n, k, d, sub, chunk, rank, tp); break;
    case 3: err = launch_tiled<3>(grid_x, smem, device, s, xp, cp, dsp, hp, wp, n, k, d, sub, chunk, rank, tp); break;
    case 4: err = launch_tiled<4>(grid_x, smem, device, s, xp, cp, dsp, hp, wp, n, k, d, sub, chunk, rank, tp); break;
    case 5: err = launch_tiled<5>(grid_x, smem, device, s, xp, cp, dsp, hp, wp, n, k, d, sub, chunk, rank, tp); break;
    case 6: err = launch_tiled<6>(grid_x, smem, device, s, xp, cp, dsp, hp, wp, n, k, d, sub, chunk, rank, tp); break;
    case 7: err = launch_tiled<7>(grid_x, smem, device, s, xp, cp, dsp, hp, wp, n, k, d, sub, chunk, rank, tp); break;
    case 8: err = launch_tiled<8>(grid_x, smem, device, s, xp, cp, dsp, hp, wp, n, k, d, sub, chunk, rank, tp); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

int repro_filter_tile_rows() { return kTile; }

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (n, d), c (k, d) f32; ds (n,) f32 or null, updated in place; hm (n,)
// bool or null; tops (ceil(n / 256), rank) f32, rank >= 1, of which the
// kernel writes the first min(rank, 256) columns. The six ints after rank
// are fused_stream.py's FilterPlan (route, tc, sub, chunk, grid_x, smem).
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError().
int repro_fused_filter(const void* x, const void* c, void* ds, const void* hm, void* tops,
                       int n, int k, int d, int rank, int route, int tc, int sub, int chunk,
                       int grid_x, int smem, int device, void* stream) {
  return launch_filter(x, c, ds, hm, nullptr, tops, n, k, d, rank, route, tc, sub, chunk,
                       grid_x, smem, device, stream);
}

// The weighted entry: as repro_fused_filter, plus w (n,) f32, which gates
// candidacy (rows with w <= 0 never enter the top-k).
int repro_fused_filter_w(const void* x, const void* c, void* ds, const void* hm,
                         const void* w, void* tops, int n, int k, int d, int rank, int route,
                         int tc, int sub, int chunk, int grid_x, int smem, int device,
                         void* stream) {
  if (w == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_filter(x, c, ds, hm, w, tops, n, k, d, rank, route, tc, sub, chunk, grid_x,
                       smem, device, stream);
}

}  // extern "C"
