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
// is read once, 4·d bytes, for all m centers): 70 us at 573,580 rows, m =
// 100, d = 38; 6.4 us at 1,864,135 rows, m = 25, d = 2. The previous design
// took 686 / 55 us there (one launch on a fresh carry; 215 us at m = 100,
// d = 2): one center a thread, one shared load per FMA, a 64-bit key built
// and compared per pair, and only groups·mc of 256 threads at work. This
// one takes 185 / 55 / 116 us: at d = 2, m = 25 it is no faster.
//
// Design (register-tiled SIMT f32; no tensor cores, which take f32 only as
// TF32):
//   * A CTA owns a tile of C = 16·TC centers (TC = 1..8, from m and d) and walks
//     stages of 128·sub rows grid-stride. 256 threads form 16 row groups ×
//     16 center lanes; a thread holds 8 rows × TC centers of dot products
//     in registers. Rows and centers are staged j-major (transposed), so
//     each j step reads two float4 of rows (4 row groups a warp: one
//     64-byte broadcast) and TC center values (8 lanes a warp on
//     consecutive words) and feeds 8·TC FMAs.
//   * Stages are double-buffered with 4-byte cp.async copies (coalesced in
//     global memory, transposed on landing; a staged dim is 128·sub + 4
//     floats long, so a warp's copies meet 4-way bank conflicts at worst).
//     The next stage loads while this one is reduced; the row norms are
//     computed once a stage, each row's by one thread in j order.
//   * A thread walks its rows in ascending order and keeps a running
//     (d2, row) per center on strict <, a 32-bit compare per pair; it packs
//     the keys once at the end. The 16 row groups of a center merge by the
//     packed minimum (shuffles, then shared memory), and one atomicMin per
//     center per CTA folds the result into the carry, skipped when the
//     carry already holds a smaller key (the carry only decreases, so a
//     stale read costs an atomic and never a wrong answer). Past 128
//     centers the grid's second axis takes the center tiles.
//   * Each pair rounds as in assign.cu: the dot product by fmaf in j order
//     from 0 (fmaf(a, b, s) is fmaf(b, a, s)), then dist2.cuh's clamped_d2
//     on j-order norms, so the keys are bitwise the previous kernel's.
//   * Where the staged tiles do not fit a block's shared memory even at
//     C = 16 (the wrapper's plan shrinks the center tile first: d past
//     202), `argmin_wide_kernel`, the previous design with the row read
//     from shared memory, is the correct path.

#include <algorithm>

#include "cp_async.cuh"
#include "dist2.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 128;        // rows of a sub-tile: 16 groups × 8
constexpr int kTileFloats = 8192; // the wide kernel's staged rows and norms
constexpr int kMaxTileRows = 1024;

template <int TC>
__global__ void __launch_bounds__(kThreads, 2)
argmin_tiled_kernel(const float* __restrict__ x, const float* __restrict__ c,
                    unsigned long long* carry, int n, int m, int d, int off,
                    int sub) {
  constexpr int C = 16 * TC;
  const int rows_stage = kRows * sub;
  const int xs = rows_stage + 4;  // floats between two dims of a row stage
  const int cs = C + 1;           // floats between two dims of the centers
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  float* const sx0 = smem;                  // (d, xs) rows, j-major, stage 0
  float* const sx1 = smem + d * xs;         // stage 1
  float* const sxn = smem + 2 * d * xs;     // (rows_stage,) row norms
  float* const sct = sxn + rows_stage;      // (d, cs) centers, j-major
  float* const scn = sct + d * cs;          // (C,) center norms
  __shared__ unsigned long long skeys[4][C];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = (warp >> 1) * 4 + (lane >> 3);  // row group 0..15
  const int tx = (warp & 1) * 8 + (lane & 7);    // center lane 0..15
  const int q0 = blockIdx.y * C;
  const int mc = min(C, m - q0);

  for (int e = tid; e < C * d; e += kThreads) {
    const int i = e / d, j = e - i * d;
    sct[j * cs + i] = i < mc ? c[static_cast<int64_t>(q0 + i) * d + j] : 0.0f;
  }
  const int nstages = (n + rows_stage - 1) / rows_stage;
  const int dr = kThreads / d, dj = kThreads - dr * d;
  auto issue = [&](int st, float* dst) {
    const int nr = min(rows_stage, n - st * rows_stage);
    const float* src = x + static_cast<int64_t>(st) * rows_stage * d;
    int r = tid / d, j = tid - (tid / d) * d;  // element tid = r·d + j
    for (int e = tid; e < nr * d; e += kThreads) {
      repro::cp_async4(dst + j * xs + r, src + e);
      j += dj;
      r += dr;
      if (j >= d) {
        j -= d;
        ++r;
      }
    }
  };
  if (static_cast<int>(blockIdx.x) < nstages) issue(blockIdx.x, sx0);
  repro::cp_async_commit();
  __syncthreads();  // the centers are staged
  for (int i = tid; i < C; i += kThreads) {
    float s = 0.0f;
    for (int j = 0; j < d; ++j) {
      const float v = sct[j * cs + i];
      s = __fadd_rn(s, __fmul_rn(v, v));
    }
    scn[i] = s;
  }

  float best[TC];
  int brow[TC];
#pragma unroll
  for (int ci = 0; ci < TC; ++ci) {
    best[ci] = __int_as_float(0x7f800000);  // +inf: no row yet
    brow[ci] = 0;
  }
  int buf = 0;
  for (int st = blockIdx.x; st < nstages; st += gridDim.x, buf ^= 1) {
    repro::cp_async_wait<0>();
    __syncthreads();  // stage st has landed; the previous stage is consumed
    if (st + static_cast<int>(gridDim.x) < nstages) {
      issue(st + gridDim.x, buf ? sx0 : sx1);
    }
    repro::cp_async_commit();
    const float* sx = buf ? sx1 : sx0;
    const int r0 = st * rows_stage;
    const int nr = min(rows_stage, n - r0);
    for (int r = tid; r < nr; r += kThreads) {
      float s = 0.0f;
      for (int j = 0; j < d; ++j) {
        const float v = sx[j * xs + r];
        s = __fadd_rn(s, __fmul_rn(v, v));
      }
      sxn[r] = s;
    }
    __syncthreads();  // the norms are ready
    for (int s0 = 0; s0 < nr; s0 += kRows) {
      float acc[8][TC];
#pragma unroll
      for (int ri = 0; ri < 8; ++ri) {
#pragma unroll
        for (int ci = 0; ci < TC; ++ci) acc[ri][ci] = 0.0f;
      }
      const float* xr = sx + s0 + ty * 4;
      const float* cr = sct + tx;
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
      // my rows in ascending order: ty·4 + 0..3, then 64 + ty·4 + 0..3
#pragma unroll
      for (int ri = 0; ri < 8; ++ri) {
        const int r = s0 + (ri < 4 ? ty * 4 + ri : 64 + ty * 4 + ri - 4);
        if (r < nr) {
          const float xn = sxn[r];
#pragma unroll
          for (int ci = 0; ci < TC; ++ci) {
            const float d2 = repro::clamped_d2(xn, scn[tx + 16 * ci], acc[ri][ci]);
            if (d2 < best[ci]) {
              best[ci] = d2;
              brow[ci] = r0 + r;
            }
          }
        }
      }
    }
  }
  // merge the 16 row groups of each center by the packed minimum
#pragma unroll
  for (int ci = 0; ci < TC; ++ci) {
    unsigned long long key =
        (static_cast<unsigned long long>(__float_as_uint(best[ci])) << 32) |
        static_cast<unsigned int>(off + brow[ci]);
    key = min(key, __shfl_xor_sync(0xffffffffu, key, 8));
    key = min(key, __shfl_xor_sync(0xffffffffu, key, 16));
    if (lane < 8) skeys[warp >> 1][tx + 16 * ci] = key;
  }
  __syncthreads();
  for (int i = tid; i < mc; i += kThreads) {
    const unsigned long long key =
        min(min(skeys[0][i], skeys[1][i]), min(skeys[2][i], skeys[3][i]));
    if (key < carry[q0 + i]) atomicMin(carry + q0 + i, key);
  }
}

// The previous design, for widths whose staged tiles do not fit the tiled
// kernel: each thread holds one center and walks a share of a staged tile's
// rows.
__global__ void __launch_bounds__(kThreads)
argmin_wide_kernel(const float* __restrict__ x, const float* __restrict__ c,
                   unsigned long long* carry, int n, int m, int d, int off,
                   int tile_rows) {
  extern __shared__ float4 smem4[];
  float* const sx = reinterpret_cast<float*>(smem4);  // (tile_rows, d)
  float* const sxn = sx + tile_rows * d;                // (tile_rows,)
  const int ntiles = (n + tile_rows - 1) / tile_rows;
  for (int q0 = 0; q0 < m; q0 += kThreads) {
    const int mc = min(kThreads, m - q0);
    const int groups = kThreads / mc;
    const bool active = threadIdx.x < groups * mc;
    const int q = q0 + threadIdx.x % mc;
    const int g = threadIdx.x / mc;
    repro::Row<0> cq;
    if (active) cq.load(c + static_cast<int64_t>(q) * d, d);
    unsigned long long best = ~0ull;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const int r0 = t * tile_rows;
      const int nr = min(tile_rows, n - r0);
      __syncthreads();  // the previous tile is consumed
      repro::stage_tile(x + static_cast<int64_t>(r0) * d, nr, d, sx, sxn);
      if (active) {
        for (int r = g; r < nr; r += groups) {
          const float d2 = repro::clamped_d2(sxn[r], cq.norm, cq.dot(sx + r * d, d));
          const unsigned long long key =
              (static_cast<unsigned long long>(__float_as_uint(d2)) << 32) |
              static_cast<unsigned int>(off + r0 + r);
          if (key < best) best = key;
        }
      }
    }
    if (active && best < carry[q]) atomicMin(carry + q, best);
  }
}

// The shared memory each variant was allowed so far, a device each.
template <int TC>
std::atomic<int> allowed[repro::kMaxDevices];

template <int TC>
cudaError_t launch_tiled(dim3 grid, int smem, int device, cudaStream_t s,
                         const float* x, const float* c,
                         unsigned long long* carry, int n, int m, int d,
                         int off, int sub) {
  auto kernel = argmin_tiled_kernel<TC>;
  const cudaError_t err = repro::allow_smem(kernel, smem, device, allowed<TC>);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, s>>>(x, c, carry, n, m, d, off, sub);
  return cudaGetLastError();
}

template <int TC>
int ctas_per_sm(int smem) {
  int ctas = 0, device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = repro::allow_smem(argmin_tiled_kernel<TC>, smem, device, allowed<TC>);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, argmin_tiled_kernel<TC>,
                                                        kThreads, smem);
  }
  return err == cudaSuccess ? ctas : -static_cast<int>(err);
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (n, d), c (m, d) f32; carry (m,) packed keys (uint64), updated in place.
// Row r of x is numbered off + r; off + n < 2^31. The launch follows
// fused_stream.argmin_plan: tc in 1..8 takes the tiled kernel on a grid of
// (grid_x, ceil(m / (16·tc))) CTAs with `smem` dynamic bytes and stages of
// 128·sub rows; tc = 0 takes the wide kernel. Launches on `stream`, does
// not synchronise, and returns cudaGetLastError().
int repro_argmin_rows(const void* x, const void* c, void* carry, int n, int m,
                      int d, int off, int tc, int sub, int grid_x, int smem,
                      int device, void* stream) {
  if (n <= 0 || m <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* xp = static_cast<const float*>(x);
  const float* cp = static_cast<const float*>(c);
  unsigned long long* kp = static_cast<unsigned long long*>(carry);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tc == 0) {
    const int tile_rows = std::min(kMaxTileRows, kTileFloats / (d + 1));
    const int smem_wide = static_cast<int>(sizeof(float)) * tile_rows * (d + 1);
    argmin_wide_kernel<<<grid_x, kThreads, smem_wide, s>>>(xp, cp, kp, n, m, d,
                                                           off, tile_rows);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid(grid_x, (m + 16 * tc - 1) / (16 * tc));
  switch (tc) {
    case 1: err = launch_tiled<1>(grid, smem, device, s, xp, cp, kp, n, m, d, off, sub); break;
    case 2: err = launch_tiled<2>(grid, smem, device, s, xp, cp, kp, n, m, d, off, sub); break;
    case 3: err = launch_tiled<3>(grid, smem, device, s, xp, cp, kp, n, m, d, off, sub); break;
    case 4: err = launch_tiled<4>(grid, smem, device, s, xp, cp, kp, n, m, d, off, sub); break;
    case 5: err = launch_tiled<5>(grid, smem, device, s, xp, cp, kp, n, m, d, off, sub); break;
    case 6: err = launch_tiled<6>(grid, smem, device, s, xp, cp, kp, n, m, d, off, sub); break;
    case 7: err = launch_tiled<7>(grid, smem, device, s, xp, cp, kp, n, m, d, off, sub); break;
    case 8: err = launch_tiled<8>(grid, smem, device, s, xp, cp, kp, n, m, d, off, sub); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// CTAs of the tiled kernel with `tc` centers a thread that one SM holds at
// `smem` dynamic bytes (the plan assumes 2), or minus a CUDA error.
int repro_argmin_ctas_per_sm(int tc, int smem) {
  switch (tc) {
    case 1: return ctas_per_sm<1>(smem);
    case 2: return ctas_per_sm<2>(smem);
    case 3: return ctas_per_sm<3>(smem);
    case 4: return ctas_per_sm<4>(smem);
    case 5: return ctas_per_sm<5>(smem);
    case 6: return ctas_per_sm<6>(smem);
    case 7: return ctas_per_sm<7>(smem);
    case 8: return ctas_per_sm<8>(smem);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
