// Pairwise squared distances for Hopper (sm_90a): the full (n, m) matrix.
//
// Replaces the TPU kernel src/repro/kernels/pairwise.py `pairwise_dist2`
// (body `_pairwise_kernel`). For x (n, d) and c (m, d), in f32 or f16:
//   out[i, q] = max((|x_i|^2 + |c_q|^2) - 2 * (x_i . c_q), 0)     (f32)
//
// Bound on this card: the output's 4·n·m bytes against 2·d·n·m operations
// of the product; at d = 38 the two are close (n = 65,536, m = 1,024:
// 268 MB, 80 us at 3.35 TB/s; 5.1 GFLOP, 76 us at 67 TFLOP/s on the f32
// units, 5 us at 989 TFLOP/s on the f16 tensor cores).
//
// Design. Every pair rounds as dist2.cuh's clamped_d2 on norms summed in j
// order by __fadd_rn(s, __fmul_rn(v, v)); on the f32 units the dot product
// is fmaf in j order from 0, so a pair's d2 is bitwise that of the nearest-
// center kernels (and of the previous design), whatever the tile shape. No
// TF32, no split-K.
//   * Register-tiled f32 (pairwise_simt_kernel<T, TR, TC>): a CTA of 256
//     threads (16 row groups × 16 column lanes) computes 16·TR × 16·TC
//     output tiles, a thread TR × TC outputs. The tile's x rows and c rows
//     are staged j-major in slabs of `ks` columns of d (all of d where it
//     fits), f32 by 4-byte cp.async (coalesced in global memory, transposed
//     on landing), f16 (on the small route) by plain loads converted on
//     the way. At TR, TC = 8 a
//     j step reads its 8 rows and 8 columns as four float4 (rows g·4..+3
//     and 64 + g·4..+3) and feeds 64 FMAs; the previous design read 8
//     scalars for 16. One thread a row sums each row's norm from the slab
//     while it is resident, so the norms cost no pass over device memory.
//   * A CTA takes a run of tiles, a row of tiles after another, with one
//     barrier an item (a tile's slab) and the next item's copies in flight
//     while it computes, across tiles too. Where d is one slab the x rows
//     stay staged along the row of tiles and only the c rows are copied
//     again, which halves the copies of a large output. Those plans run
//     persistent CTAs (two a SM on the large route); at small d a tile a
//     CTA measured faster, and where d takes several slabs every tile
//     copies its x rows anyway.
//   * The large route (outputs past a few tiles) takes 128 × 128 tiles; the
//     small route 16 × 16, so that the streaming sketch's (k+1)² bootstrap
//     spreads over many CTAs.
//   * f16 on the tensor cores (pairwise_mma_kernel): a product of two f16
//     values is exact in f32, so mma.sync m16n8k16 (f16 in, f32 sums)
//     computes the same dot products up to the order of its additions, as
//     the TPU's matrix unit does with preferred_element_type=f32. A CTA of
//     8 warps computes a 128 × 128 tile, a warp 32 × 64 (2 × 8 mma tiles);
//     the x and c rows are staged row-major in slabs of up to 64 halves, d
//     zero-padded to a multiple of 16, and the fragments come by ldmatrix
//     (a row stride of 144 bytes keeps its 8 row reads on distinct banks).
//     The norms and the epilogue stay on the f32 units. On integer inputs
//     whose sums stay below 2^24 the result is bitwise the plain version's.
//   * Stores: the kernels never read their output back, so they store it
//     with streaming stores (__stcs), float4 where the row is 16-byte
//     aligned and the group lies inside the matrix, scalars on the ragged
//     edge. The f16 kernel passes each warp's accumulators through shared
//     memory, 16 rows at a time, to store them so too.
//   * Grid: 1-D, so neither n nor m is capped by a grid dimension (the
//     previous design put m's tiles on grid.y, at most 65,535).
// The launch plan (route, tile shape, slab depth, grid, shared bytes) comes
// from kernels/pairwise.py `pairwise_plan`.

#include <cuda_fp16.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

#include "cp_async.cuh"
#include "dist2.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMmaTile = 128;               // the f16 kernel's tile: rows and columns
constexpr int kMmaDepth = 64;               // halves of d staged at a time
constexpr int kMmaStride = kMmaDepth + 8;   // halves between two staged rows

// Register i's row of a tile of 16·R rows for thread group g (0..15): R a
// multiple of 4, rows g·4 + i % 4 + 64·(i / 4) (float4 groups); else g + 16·i.
template <int R>
__device__ __forceinline__ int lane_row(int g, int i) {
  if constexpr (R % 4 == 0) {
    return (i >> 2) * 64 + g * 4 + (i & 3);
  } else {
    return g + 16 * i;
  }
}

// Thread group g's R values of one j-major staged column `s`.
template <int R>
__device__ __forceinline__ void load_regs(float (&v)[R], const float* s, int g) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int h = 0; h < R / 4; ++h) {
      const float4 f = *reinterpret_cast<const float4*>(s + h * 64 + g * 4);
      v[4 * h] = f.x;
      v[4 * h + 1] = f.y;
      v[4 * h + 2] = f.z;
      v[4 * h + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) v[i] = s[g + 16 * i];
  }
}

// Stage columns [k0, k0 + kd) of rows [0, nr) of the (·, d) matrix at `src`
// j-major into `dst` (ld floats a column), walked by the whole block in
// element order (coalesced reads): whole rows (kd = d) as one span of nr·d
// values, else a slab of `rows` × ks elements. f32 goes by 4-byte cp.async
// (the caller commits and waits); f16 is converted by plain loads. Elements
// past kd or nr are not written.
template <typename T>
__device__ __forceinline__ void stage_slab(float* dst, int ld, const T* __restrict__ src,
                                           int rows, int nr, int d, int k0, int ks, int kd) {
  const int t = threadIdx.x;
  const int dr = kThreads / ks, dj = kThreads - (kThreads / ks) * ks;
  int r = t / ks, j = t - (t / ks) * ks;  // element t = r·ks + j
  auto copy = [&](const T* p) {
    if constexpr (std::is_same_v<T, float>) {
      repro::cp_async4(dst + j * ld + r, p);
    } else {
      dst[j * ld + r] = __half2float(*p);
    }
  };
  auto next = [&]() {
    j += dj;
    r += dr;
    if (j >= ks) {
      j -= ks;
      ++r;
    }
  };
  if (kd == d) {
    for (int e = t; e < nr * d; e += kThreads, next()) copy(src + e);
  } else {
    for (int e = t; e < rows * ks; e += kThreads, next()) {
      if (r < nr && j < kd) copy(src + static_cast<int64_t>(r) * d + k0 + j);
    }
  }
}

// Floats of one stage of a SIMT plan: ks columns of the x rows' (TN + 4
// apart) and of the c rows' (TM + 4 apart). The kernel's shared memory is
// two x stages, two c stages, then the TN + TM norms.
template <int TR, int TC>
__host__ __device__ constexpr int simt_stage_floats(int ks) {
  return ks * (16 * TR + 4 + 16 * TC + 4);
}

// A CTA's work: items (tile, slab) over its run of tiles [lo, hi) of the
// (n, m) output in TN × TM tiles (tiles_m along m), a tile's slabs in j
// order, a row of tiles after another. The kernels keep item i + 1 in
// flight while item i is computed, across tiles too. Where d is one slab,
// the x rows stay staged along a row of tiles: only the c rows are staged
// again.
template <int TN, int TM>
struct TileRun {
  struct Item {
    int64_t n0, m0;  // the tile's first row and column
    int nr, mr, s;   // its rows and columns (ragged edges), slab
    bool fresh_x;    // the x rows are staged for this item
  };
  int n, m, tiles_m, nslabs, lo, items;

  __device__ TileRun(int n_, int m_, int tiles_m_, int tiles, int nslabs_)
      : n(n_), m(m_), tiles_m(tiles_m_), nslabs(nslabs_) {
    lo = static_cast<int>(static_cast<int64_t>(blockIdx.x) * tiles / gridDim.x);
    const int hi = static_cast<int>(static_cast<int64_t>(blockIdx.x + 1) * tiles / gridDim.x);
    items = (hi - lo) * nslabs;
  }

  __device__ Item at(int item) const {
    const int b = lo + item / nslabs;
    const int bn = b / tiles_m;
    Item it;
    it.n0 = static_cast<int64_t>(bn) * TN;
    it.m0 = static_cast<int64_t>(b - bn * tiles_m) * TM;
    it.nr = n - it.n0 < TN ? static_cast<int>(n - it.n0) : TN;
    it.mr = m - it.m0 < TM ? static_cast<int>(m - it.m0) : TM;
    it.s = item - (item / nslabs) * nslabs;
    it.fresh_x = nslabs > 1 || item == 0 || (b - 1) / tiles_m != bn;
    return it;
  }
};

template <typename T, int TR, int TC>
__global__ void __launch_bounds__(kThreads, (TR * TC >= 32) ? 2 : 1)
pairwise_simt_kernel(const T* __restrict__ x, const T* __restrict__ c, int n, int m, int d,
                     int ks, int tiles_m, int tiles, float* __restrict__ out) {
  constexpr int TN = 16 * TR, TM = 16 * TC;
  constexpr int SX = TN + 4, SC = TM + 4;  // floats between two staged columns
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  float* const xst = smem;                   // two x stages of ks × SX floats
  float* const cst = smem + 2 * ks * SX;     // two c stages of ks × SC floats
  float* const xn_s = cst + 2 * ks * SC;     // (TN,) row norms
  float* const cn_s = xn_s + TN;             // (TM,) column norms
  const int t = threadIdx.x, ty = t >> 4, tx = t & 15;

  using Run = TileRun<TN, TM>;
  const Run run(n, m, tiles_m, tiles, (d + ks - 1) / ks);
  const int nslabs = run.nslabs, items = run.items;
  int xb = 0;  // the x stage of the item computed next
  auto issue = [&](const typename Run::Item& it, int xbuf, int cbuf) {
    const int k0 = it.s * ks, kd = min(ks, d - k0);
    if (it.fresh_x) stage_slab(xst + xbuf * ks * SX, SX, x + it.n0 * d, TN, it.nr, d, k0, ks, kd);
    stage_slab(cst + cbuf * ks * SC, SC, c + it.m0 * d, TM, it.mr, d, k0, ks, kd);
  };

  float acc[TR][TC];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
#pragma unroll
    for (int q = 0; q < TC; ++q) acc[i][q] = 0.0f;
  }
  float norm = 0.0f;  // thread t < TN: x row t's; TN <= t < TN + TM: c row t - TN's
  typename Run::Item it = run.at(0);
  if (items > 0) issue(it, 0, 0);
  repro::cp_async_commit();
  for (int item = 0; item < items; ++item) {
    const typename Run::Item cur = it;
    const float* const sx = xst + xb * ks * SX;
    const float* const sc = cst + (item & 1) * ks * SC;
    repro::cp_async_wait<0>();
    __syncthreads();  // item has landed; item - 1 is consumed
    if (item + 1 < items) {
      it = run.at(item + 1);
      issue(it, it.fresh_x ? xb ^ 1 : xb, (item + 1) & 1);
    }
    repro::cp_async_commit();
    const int kd = min(ks, d - cur.s * ks);
    if ((t < TN && cur.fresh_x) || (t >= TN && t < TN + TM)) {
      const float* col = t < TN ? sx + t : sc + (t - TN);
      const int ld = t < TN ? SX : SC;
#pragma unroll 4
      for (int j = 0; j < kd; ++j) {
        const float v = col[j * ld];
        norm = __fadd_rn(norm, __fmul_rn(v, v));
      }
    }
#pragma unroll 2
    for (int j = 0; j < kd; ++j) {
      float a[TR], b[TC];
      load_regs<TR>(a, sx + j * SX, ty);
      load_regs<TC>(b, sc + j * SC, tx);
#pragma unroll
      for (int i = 0; i < TR; ++i) {
#pragma unroll
        for (int q = 0; q < TC; ++q) acc[i][q] = fmaf(a[i], b[q], acc[i][q]);
      }
    }
    if (item + 1 < items && it.fresh_x) xb ^= 1;
    if (cur.s + 1 < nslabs) continue;

    // the tile's last slab: its outputs. xn_s and cn_s are rewritten only
    // after the next item's barrier, which every thread reaches after this;
    // xn_s stays as it is while the x rows do.
    if (t < TN) {
      if (cur.fresh_x) xn_s[t] = norm;
    } else if (t < TN + TM) {
      cn_s[t - TN] = norm;
    }
    norm = 0.0f;
    __syncthreads();
    const bool vec = m % 4 == 0;  // rows start 16-byte aligned
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int r = lane_row<TR>(ty, i);
      float* const orow = out + (cur.n0 + r) * static_cast<int64_t>(m) + cur.m0;
      const float xn = xn_s[r];
      if constexpr (TC % 4 == 0) {
#pragma unroll
        for (int h = 0; h < TC / 4; ++h) {
          const int q0 = h * 64 + tx * 4;
          const float4 cn = *reinterpret_cast<const float4*>(cn_s + q0);
          const float4 v = make_float4(repro::clamped_d2(xn, cn.x, acc[i][4 * h]),
                                       repro::clamped_d2(xn, cn.y, acc[i][4 * h + 1]),
                                       repro::clamped_d2(xn, cn.z, acc[i][4 * h + 2]),
                                       repro::clamped_d2(xn, cn.w, acc[i][4 * h + 3]));
          if (r >= cur.nr) continue;
          if (vec && q0 + 4 <= cur.mr) {
            __stcs(reinterpret_cast<float4*>(orow + q0), v);
          } else {
            if (q0 < cur.mr) __stcs(orow + q0, v.x);
            if (q0 + 1 < cur.mr) __stcs(orow + q0 + 1, v.y);
            if (q0 + 2 < cur.mr) __stcs(orow + q0 + 2, v.z);
            if (q0 + 3 < cur.mr) __stcs(orow + q0 + 3, v.w);
          }
        }
      } else {
#pragma unroll
        for (int q = 0; q < TC; ++q) {
          const int col = tx + 16 * q;
          if (r < cur.nr && col < cur.mr) {
            __stcs(orow + col, repro::clamped_d2(xn, cn_s[col], acc[i][q]));
          }
        }
      }
#pragma unroll
      for (int q = 0; q < TC; ++q) acc[i][q] = 0.0f;
    }
  }
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(repro::shared_addr(p))
               : "memory");
}

// d += a · b on one 16 × 8 tile, f16 in, f32 sums.
__device__ __forceinline__ void mma_f16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                        unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage a slab of 128 rows × w halves (w = kd rounded up to 16: columns
// [k0, k0 + kd) of the (·, d) matrix at `src`, rows [0, nr)) row-major into
// `dst`, with zeros in columns [kd, w), so the padding adds nothing to a
// product (rows past nr are left as they are: they reach only outputs that
// are not stored). `pairs` (d even and both matrices 4-byte aligned): pairs
// of halves by 4-byte cp.async (the caller commits and waits), thread t
// taking pair t % 8 of each 16-column block, rows t / 8 + 32·u. Else plain
// loads, each thread's loads of a block in flight before its stores.
__device__ __forceinline__ void stage_rows(unsigned short* dst, const unsigned short* __restrict__ src,
                                           int nr, int d, int k0, int kd, int w, bool pairs) {
  if (pairs) {
    const int jp = (threadIdx.x & 7) * 2, rt = threadIdx.x >> 3;
    for (int j = jp; j < w; j += 16) {
#pragma unroll
      for (int u = 0; u < kMmaTile / 32; ++u) {
        const int r = rt + 32 * u;
        unsigned short* const to = dst + r * kMmaStride + j;
        if (j >= kd) {
          *reinterpret_cast<unsigned*>(to) = 0u;
        } else if (r < nr) {
          repro::cp_async4(reinterpret_cast<float*>(to),
                           reinterpret_cast<const float*>(src + static_cast<int64_t>(r) * d + k0 + j));
        }
      }
    }
    return;
  }
  const int jt = threadIdx.x & 15, rt = threadIdx.x >> 4;
  for (int j = jt; j < w; j += 16) {
    unsigned short v[kMmaTile / 16];
#pragma unroll
    for (int u = 0; u < kMmaTile / 16; ++u) {
      const int r = rt + 16 * u;
      v[u] = r < nr && j < kd ? __ldg(src + static_cast<int64_t>(r) * d + k0 + j) : 0;
    }
#pragma unroll
    for (int u = 0; u < kMmaTile / 16; ++u) dst[(rt + 16 * u) * kMmaStride + j] = v[u];
  }
}

// Shared bytes of the f16 kernel: two x and two c stages of (128,
// kMmaStride) halves, the warps' output staging (8 × 16 rows of
// kOutStride floats), then the 128 + 128 norms.
constexpr int kMmaStage = kMmaTile * kMmaStride;  // halves
constexpr int kOutStride = 72;                    // floats between two staged output rows
constexpr int kMmaSmem = 4 * kMmaStage * 2 + 8 * 16 * kOutStride * 4 + 2 * kMmaTile * 4;

__global__ void __launch_bounds__(kThreads, 2)
pairwise_mma_kernel(const __half* __restrict__ x, const __half* __restrict__ c, int n, int m,
                    int d, int tiles_m, int tiles, bool pairs, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  unsigned short* const xst = reinterpret_cast<unsigned short*>(smem4);  // two x stages
  unsigned short* const cst = xst + 2 * kMmaStage;                       // two c stages
  float* const so_all = reinterpret_cast<float*>(cst + 2 * kMmaStage);   // output staging
  float* const xn_s = so_all + 8 * 16 * kOutStride;
  float* const cn_s = xn_s + kMmaTile;
  const unsigned short* const xg = reinterpret_cast<const unsigned short*>(x);
  const unsigned short* const cg = reinterpret_cast<const unsigned short*>(c);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int wr = warp >> 1, wc = warp & 1;  // the warp's rows wr·32.., columns wc·64..

  using Run = TileRun<kMmaTile, kMmaTile>;  // as in pairwise_simt_kernel
  const Run run(n, m, tiles_m, tiles, (d + kMmaDepth - 1) / kMmaDepth);
  const int nslabs = run.nslabs, items = run.items;
  auto issue = [&](const Run::Item& it, int xbuf, int cbuf) {
    const int k0 = it.s * kMmaDepth, kd = min(kMmaDepth, d - k0), w = (kd + 15) & ~15;
    if (it.fresh_x) stage_rows(xst + xbuf * kMmaStage, xg + it.n0 * d, it.nr, d, k0, kd, w, pairs);
    stage_rows(cst + cbuf * kMmaStage, cg + it.m0 * d, it.mr, d, k0, kd, w, pairs);
  };

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][q][e] = 0.0f;
    }
  }
  float norm = 0.0f;  // thread t < 128: x row t's; else c row t - 128's
  int xb = 0;
  Run::Item it = run.at(0);
  if (items > 0) issue(it, 0, 0);
  repro::cp_async_commit();
  for (int item = 0; item < items; ++item) {
    const Run::Item cur = it;
    const unsigned short* const sa = xst + xb * kMmaStage;
    const unsigned short* const sb = cst + (item & 1) * kMmaStage;
    repro::cp_async_wait<0>();
    __syncthreads();  // item has landed; item - 1 is consumed
    if (item + 1 < items) {
      it = run.at(item + 1);
      issue(it, it.fresh_x ? xb ^ 1 : xb, (item + 1) & 1);
    }
    repro::cp_async_commit();
    const int kd = min(kMmaDepth, d - cur.s * kMmaDepth), w = (kd + 15) & ~15;
    if (t >= kMmaTile || cur.fresh_x) {
      const unsigned short* const srow =
          t < kMmaTile ? sa + t * kMmaStride : sb + (t - kMmaTile) * kMmaStride;
      for (int j = 0; j < kd; ++j) {
        const float v = __half2float(__ushort_as_half(srow[j]));
        norm = __fadd_rn(norm, __fmul_rn(v, v));
      }
    }
    for (int s = 0; s < w; s += 16) {
      unsigned a[2][4], b[4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        ldmatrix_x4(a[mt], sa + (wr * 32 + mt * 16 + (lane & 15)) * kMmaStride + s +
                               (lane >> 4) * 8);
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {  // column tiles 2p and 2p + 1
        ldmatrix_x4(b[p], sb + (wc * 64 + p * 16 + (lane & 7) + ((lane >> 4) << 3)) * kMmaStride +
                              s + ((lane >> 3) & 1) * 8);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          mma_f16(acc[mt][nt], a[mt], b[nt >> 1][(nt & 1) * 2], b[nt >> 1][(nt & 1) * 2 + 1]);
        }
      }
    }
    if (item + 1 < items && it.fresh_x) xb ^= 1;
    if (cur.s + 1 < nslabs) continue;

    // the tile's last slab: its outputs (norms as in pairwise_simt_kernel)
    if (t < kMmaTile) {
      if (cur.fresh_x) xn_s[t] = norm;
    } else {
      cn_s[t - kMmaTile] = norm;
    }
    norm = 0.0f;
    __syncthreads();
    // Each warp's 32 × 64 outputs go out 16 rows at a time through its own
    // 16 × kOutStride floats: accumulator e of tile (mt, nt) is row g (+8
    // for e >= 2), column nt·8 + q2 + e % 2; then float4 stores of two rows
    // a warp instruction, as the f32 kernel's.
    float* const so = so_all + warp * 16 * kOutStride;
    const int g = lane >> 2, q2 = (lane & 3) * 2;
    const int cw = wc * 64;
    const bool vec = m % 4 == 0;  // rows start 16-byte aligned
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int rw = wr * 32 + mt * 16;
      const float xn0 = xn_s[rw + g], xn1 = xn_s[rw + g + 8];
      __syncwarp();  // the previous rows are read
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = nt * 8 + q2;
        const float c0 = cn_s[cw + col], c1 = cn_s[cw + col + 1];
        *reinterpret_cast<float2*>(so + g * kOutStride + col) =
            make_float2(repro::clamped_d2(xn0, c0, acc[mt][nt][0]),
                        repro::clamped_d2(xn0, c1, acc[mt][nt][1]));
        *reinterpret_cast<float2*>(so + (g + 8) * kOutStride + col) =
            make_float2(repro::clamped_d2(xn1, c0, acc[mt][nt][2]),
                        repro::clamped_d2(xn1, c1, acc[mt][nt][3]));
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
      }
      __syncwarp();
#pragma unroll
      for (int rep = 0; rep < 8; ++rep) {
        const int rr = rep * 2 + (lane >> 4), col = (lane & 15) * 4;
        const int r = rw + rr, q = cw + col;
        if (r >= cur.nr) continue;
        const float4 v = *reinterpret_cast<const float4*>(so + rr * kOutStride + col);
        float* const o = out + (cur.n0 + r) * static_cast<int64_t>(m) + cur.m0 + q;
        if (vec && q + 4 <= cur.mr) {
          __stcs(reinterpret_cast<float4*>(o), v);
        } else {
          if (q < cur.mr) __stcs(o, v.x);
          if (q + 1 < cur.mr) __stcs(o + 1, v.y);
          if (q + 2 < cur.mr) __stcs(o + 2, v.z);
          if (q + 3 < cur.mr) __stcs(o + 3, v.w);
        }
      }
    }
  }
}

// The shared memory each kernel was allowed so far, a device each.
template <typename T, int TR, int TC>
std::atomic<int> simt_allowed[repro::kMaxDevices];
std::atomic<int> mma_allowed[repro::kMaxDevices];

template <typename T, int TR, int TC>
cudaError_t launch_simt(const void* x, const void* c, float* out, int n, int m, int d, int ks,
                        int tiles_m, int tiles, int grid, int smem, int device,
                        cudaStream_t stream) {
  auto kernel = pairwise_simt_kernel<T, TR, TC>;
  const cudaError_t err = repro::allow_smem(kernel, smem, device, simt_allowed<T, TR, TC>);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(c),
                                           n, m, d, ks, tiles_m, tiles, out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_simt_tile(int tr, int tc, const void* x, const void* c, float* out, int n,
                             int m, int d, int ks, int tiles_m, int tiles, int grid, int smem,
                             int device, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, float>) {  // f16 takes the tensor cores past the small route
    if (tr == 8 && tc == 8) {
      return launch_simt<T, 8, 8>(x, c, out, n, m, d, ks, tiles_m, tiles, grid, smem, device,
                                  stream);
    }
  }
  if (tr == 1 && tc == 1) {
    return launch_simt<T, 1, 1>(x, c, out, n, m, d, ks, tiles_m, tiles, grid, smem, device,
                                stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (n, d) and c (m, d), both f32 (half = 0) or both f16 (half = 1); out
// (n, m) f32. mma = 1: the f16 tensor-core kernel (128 × 128 tiles, smem
// must be its kMmaSmem); else the register-tiled kernel with tiles of
// 16·tr × 16·tc ({tr, tc} = {1, 1}, and for f32 also {8, 8}) and slabs of
// ks columns. tiles output tiles, tiles_m of them
// along m, over grid CTAs. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError().
int repro_pairwise_dist2(const void* x, const void* c, void* out, int n, int m, int d, int half,
                         int mma, int tr, int tc, int ks, int tiles_m, int tiles, int grid,
                         int smem, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto st = static_cast<cudaStream_t>(stream);
  float* const o = static_cast<float*>(out);
  if (mma) {
    if (!half || smem != kMmaSmem) return static_cast<int>(cudaErrorInvalidValue);
    err = repro::allow_smem(pairwise_mma_kernel, smem, device, mma_allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
    // 4-byte copies of half pairs need 4-byte aligned rows: even d, and
    // matrices that start so (a view may start at any half)
    const bool pairs = d % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(c) % 4 == 0;
    pairwise_mma_kernel<<<grid, kThreads, smem, st>>>(static_cast<const __half*>(x),
                                                      static_cast<const __half*>(c), n, m, d,
                                                      tiles_m, tiles, pairs, o);
    return static_cast<int>(cudaGetLastError());
  }
  if (half) {
    return static_cast<int>(launch_simt_tile<__half>(tr, tc, x, c, o, n, m, d, ks, tiles_m, tiles, grid,
                                                     smem, device, st));
  }
  return static_cast<int>(launch_simt_tile<float>(tr, tc, x, c, o, n, m, d, ks, tiles_m, tiles, grid,
                                                  smem, device, st));
}

}  // extern "C"
