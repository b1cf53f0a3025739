// Nearest-center assignment for Hopper (sm_90a), with the cluster sums.
//
// Replaces the TPU kernels src/repro/kernels/assign.py `assign_nearest_blocks`
// (body `_assign_kernel`) and src/repro/kernels/fused_stream.py
// `fused_assign_blocks`, which compute the same function. For every row x_i
// of x (n, d) and centers c (k, d):
//   d2[i, q] = max((|x_i|^2 + |c_q|^2) - 2 * (x_i . c_q), 0)
//   idx[i]   = first argmin_q d2[i, q],  d2_out[i] = d2[i, idx[i]]
// The sums entry also adds each row's weight w_i (or 1, into int32 counts)
// into sums[idx[i]]: the `index_add_` that followed every pass on the
// weighted and coreset paths (the JAX package's `.at[idx].add`).
//
// Bound on this card: operations at large k·d, since each (row, center) pair
// costs ~2·d + 5 f32 operations on the non-tensor units while a row moves
// only 4·d + 8 bytes: 70 us at 573,580 rows, k = 100, d = 38; 13 us at 1e6
// rows, k = 100, d = 2. The previous design (one thread a row, the centers
// walked from shared memory) issued one broadcast shared load per FMA and a
// serial compare chain: 512 / 73 us there, and the `index_add_` after it
// took ~1 ms a super-shard on the weighted path, its atomics contending on
// k bins of ~4,600 rows each.
//
// Design (register-tiled SIMT f32, the transpose of argmin_rows.cu; no
// tensor cores, which take f32 only as TF32):
//   * A CTA walks stages of 128·sub rows of one machine grid-stride; the
//     centers are staged once, j-major, in tiles of C = 16·TC (TC = 1..8,
//     from k and d), all of them resident where they fit. 256 threads form
//     16 row groups × 16 center lanes (a warp: 2 row groups); a thread holds
//     8 rows × TC centers of dot products in registers. Rows are staged
//     j-major too, so each j step reads two float4 of rows (broadcast over a
//     half warp) and TC center values (16 consecutive words) and feeds 8·TC
//     FMAs.
//   * Stages are double-buffered with 4-byte cp.async copies (coalesced in
//     global memory, transposed on landing), as in argmin_rows.cu; the row
//     norms are computed once a stage, each row's by one thread in j order.
//   * Ties: a thread takes its centers tx, tx + 16, ... tile after tile, in
//     ascending order, on strict <; the 16 center lanes of a row then merge
//     by (d2, center) through shuffles, the smaller center winning a tie.
//     d2 is never NaN (fmaxf drops it) and lies in [+0, +inf], and a row
//     with every d2 = +inf keeps center 0, so the result is the sequential
//     strict-< scan's: the first argmin, as torch.argmin and the TPU take.
//   * Rounding: each pair as before, the dot product by fmaf in j order from
//     0 (fmaf(a, b, s) is fmaf(b, a, s)), then dist2.cuh's clamped_d2 on
//     j-order norms, so idx and d2 are bitwise the previous kernel's on any
//     input.
//   * Where the centers do not all fit a block's shared memory beside two
//     row stages, they are staged in chunks of tiles for each stage, and a
//     row's (d2, center) over the chunks so far waits in shared memory.
//   * Sums: the thread that writes a row adds its weight (or 1) into the
//     CTA's k bins in shared memory; at its end the CTA issues one global
//     atomic per non-zero bin (past 8,192 bins the rows add straight into
//     global memory). Integer weights whose sums stay below 2^24, and the
//     int32 counts, are therefore exact in any order; float weights agree
//     to f32 rounding of the sum.
//   * Where not even a 16-center tile fits beside two row stages (d past
//     ~200; the wrapper's `assign_plan` decides), `assign_wide_kernel`, the
//     previous design, is the path: one thread a row, the row in registers
//     up to d = 64, the centers walked from shared memory.
//
// Batched entry: m machine blocks x (m, per, d) against their own centers
// c (m, k, d), the machine the grid's second axis (blockIdx.y), sums (m, k);
// the 2-D entry is the same launch with m = 1, so a batch of one is bitwise
// the 2-D entry.

#include <algorithm>

#include "cp_async.cuh"
#include "dist2.cuh"

namespace {

constexpr int kThreads = 256;      // the tiled kernel
constexpr int kRows = 128;         // rows of a sub-tile: 16 groups × 8
constexpr int kWideThreads = 128;  // the wide kernel: one thread a row

// What a launch adds into: sums (m, k) int32 counts (w null) or f32 sums of
// the row weights w (m, per); sums null: no sums. bins_in_smem: a CTA's k
// bins live in shared memory (else rows add into sums directly).
struct Sums {
  void* sums;
  const float* w;
  int bins_in_smem;
};

// Add row `r` (assigned to center q) into the bins.
__device__ __forceinline__ void add_to_bin(void* bins, const float* w, int64_t r, int q) {
  if (w != nullptr) {
    atomicAdd(static_cast<float*>(bins) + q, w[r]);
  } else {
    atomicAdd(static_cast<int*>(bins) + q, 1);
  }
}

// The CTA's shared bins into the machine's global sums, one atomic per
// non-zero bin. Every thread calls it.
__device__ __forceinline__ void flush_bins(const Sums& s, const void* sbins, int k,
                                           int64_t machine) {
  if (s.sums == nullptr || !s.bins_in_smem) return;
  __syncthreads();
  for (int q = threadIdx.x; q < k; q += blockDim.x) {
    if (s.w != nullptr) {
      const float v = static_cast<const float*>(sbins)[q];
      if (v != 0.0f) atomicAdd(static_cast<float*>(s.sums) + machine * k + q, v);
    } else {
      const int v = static_cast<const int*>(sbins)[q];
      if (v != 0) atomicAdd(static_cast<int*>(s.sums) + machine * k + q, v);
    }
  }
}

// Where this CTA's rows add: its shared bins (zeroed here; the caller
// synchronises before the first add), the machine's global sums, or none.
__device__ __forceinline__ void* bins_of(const Sums& s, void* sbins, int k, int64_t machine) {
  if (s.sums == nullptr) return nullptr;
  if (!s.bins_in_smem) return static_cast<int*>(s.sums) + machine * k;
  for (int q = threadIdx.x; q < k; q += blockDim.x) static_cast<int*>(sbins)[q] = 0;
  return sbins;
}

template <int TC>
__global__ void __launch_bounds__(kThreads, 2)
assign_tiled_kernel(const float* __restrict__ x, const float* __restrict__ c, int n,
                    int k, int d, int sub, int chunk, int* __restrict__ idx_out,
                    float* __restrict__ d2_out, Sums s) {
  constexpr int C = 16 * TC;
  const int rows_stage = kRows * sub;
  const int xs = rows_stage + 4;  // floats between two dims of a row stage
  const int cc = chunk * C;       // centers resident at once
  const int cs = cc + 1;          // floats between two dims of the centers
  const int nchunks = (k + cc - 1) / cc;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  float* const sx0 = smem;               // (d, xs) rows, j-major, stage 0
  float* const sx1 = smem + d * xs;      // stage 1
  float* const sxn = smem + 2 * d * xs;  // (rows_stage,) row norms
  float* const sct = sxn + rows_stage;   // (d, cs) centers, j-major
  float* const scn = sct + d * cs;       // (cc,) center norms
  // (rows_stage,) a row's best (d2, center) over the chunks so far
  const int carried = nchunks > 1 ? rows_stage : 0;
  float* const sbd = scn + cc;
  int* const sbi = reinterpret_cast<int*>(sbd + carried);
  void* const sbins = sbi + carried;     // (k,) the CTA's sums

  // machine blockIdx.y: its rows, its centers, its outputs and sums
  const int64_t machine = blockIdx.y;
  x += machine * n * d;
  c += machine * k * d;
  if (idx_out != nullptr) idx_out += machine * n;
  if (d2_out != nullptr) d2_out += machine * n;
  const float* const w = s.w == nullptr ? nullptr : s.w + machine * n;
  void* const bins = bins_of(s, sbins, k, machine);

  const int tid = threadIdx.x, lane = tid & 31;
  const int tx = lane & 15;                     // center lane 0..15
  const int ty = (tid >> 5) * 2 + (lane >> 4);  // row group 0..15

  auto load_centers = [&](int q0) {
    const int nc = min(cc, k - q0);
    for (int e = tid; e < cc * d; e += kThreads) {
      const int i = e / d, j = e - i * d;
      sct[j * cs + i] = i < nc ? c[static_cast<int64_t>(q0 + i) * d + j] : 0.0f;
    }
  };
  auto center_norms = [&]() {  // after a barrier behind load_centers
    for (int i = tid; i < cc; i += kThreads) {
      float acc = 0.0f;
      for (int j = 0; j < d; ++j) {
        const float v = sct[j * cs + i];
        acc = __fadd_rn(acc, __fmul_rn(v, v));
      }
      scn[i] = acc;
    }
  };
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
  if (nchunks == 1) load_centers(0);
  if (static_cast<int>(blockIdx.x) < nstages) issue(blockIdx.x, sx0);
  repro::cp_async_commit();
  __syncthreads();  // the centers are staged, the bins zeroed
  if (nchunks == 1) center_norms();

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
      float acc = 0.0f;
      for (int j = 0; j < d; ++j) {
        const float v = sx[j * xs + r];
        acc = __fadd_rn(acc, __fmul_rn(v, v));
      }
      sxn[r] = acc;
    }
    for (int ch = 0; ch < nchunks; ++ch) {
      const int q0 = ch * cc;
      if (nchunks > 1) {
        __syncthreads();  // the previous chunk is consumed
        load_centers(q0);
        __syncthreads();
        center_norms();
      }
      __syncthreads();  // the row norms and the chunk's centers are ready
      const int ntiles = min(chunk, (k - q0 + C - 1) / C);
      for (int s0 = 0; s0 < nr; s0 += kRows) {
        float best[8];
        int bidx[8];
#pragma unroll
        for (int ri = 0; ri < 8; ++ri) {
          best[ri] = __int_as_float(0x7f800000);  // +inf: no center yet
          bidx[ri] = 0;
        }
        const float* xr = sx + s0 + ty * 4;
        for (int t = 0; t < ntiles; ++t) {
          float acc[8][TC];
#pragma unroll
          for (int ri = 0; ri < 8; ++ri) {
#pragma unroll
            for (int ci = 0; ci < TC; ++ci) acc[ri][ci] = 0.0f;
          }
          const float* cr = sct + t * C + tx;
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
          // my rows ty·4 + 0..3 and 64 + ty·4 + 0..3; my centers ascending
#pragma unroll
          for (int ri = 0; ri < 8; ++ri) {
            const float xn = sxn[s0 + (ri < 4 ? ty * 4 + ri : 60 + ty * 4 + ri)];
#pragma unroll
            for (int ci = 0; ci < TC; ++ci) {
              const int qi = t * C + tx + 16 * ci;
              const float d2 = repro::clamped_d2(xn, scn[qi], acc[ri][ci]);
              if (q0 + qi < k && d2 < best[ri]) {
                best[ri] = d2;
                bidx[ri] = q0 + qi;
              }
            }
          }
        }
        // merge the 16 center lanes of each row by (d2, center)
#pragma unroll
        for (int ri = 0; ri < 8; ++ri) {
#pragma unroll
          for (int off = 1; off < 16; off <<= 1) {
            const float od = __shfl_xor_sync(0xffffffffu, best[ri], off);
            const int oi = __shfl_xor_sync(0xffffffffu, bidx[ri], off);
            if (od < best[ri] || (od == best[ri] && oi < bidx[ri])) {
              best[ri] = od;
              bidx[ri] = oi;
            }
          }
        }
        // lane tx < 8 owns row tx of its group
        float my_d = best[0];
        int my_i = bidx[0];
#pragma unroll
        for (int ri = 1; ri < 8; ++ri) {
          if (tx == ri) {
            my_d = best[ri];
            my_i = bidx[ri];
          }
        }
        const int r = s0 + (tx < 4 ? ty * 4 + tx : 60 + ty * 4 + tx);
        if (tx < 8 && r < nr) {
          if (nchunks > 1) {  // fold in the earlier chunks (smaller centers)
            if (ch > 0) {
              const float pd = sbd[r];
              const int pi = sbi[r];
              if (pd < my_d || (pd == my_d && pi < my_i)) {
                my_d = pd;
                my_i = pi;
              }
            }
            sbd[r] = my_d;
            sbi[r] = my_i;
          }
          if (ch + 1 == nchunks) {
            const int64_t row = static_cast<int64_t>(r0) + r;
            if (idx_out != nullptr) idx_out[row] = my_i;
            if (d2_out != nullptr) d2_out[row] = my_d;
            if (bins != nullptr) add_to_bin(bins, w, row, my_i);
          }
        }
      }
    }
  }
  flush_bins(s, sbins, k, machine);
}

// The previous design, for widths whose staged tiles do not fit the tiled
// kernel: one thread a row, `tc` centers a shared-memory tile.
template <int DMAX>
__global__ void __launch_bounds__(kWideThreads)
assign_wide_kernel(const float* __restrict__ x, const float* __restrict__ c, int n, int k,
                   int d, int tc, int* __restrict__ idx_out, float* __restrict__ d2_out,
                   Sums s) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);  // (tc, d + 1) center tile
  void* const sbins = smem + tc * (d + 1);               // (k,) the CTA's sums
  const int64_t machine = blockIdx.y;
  x += machine * n * d;
  c += machine * k * d;
  void* const bins = bins_of(s, sbins, k, machine);  // nearest_center synchronises
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWideThreads + threadIdx.x;
  const bool live = row < n;
  repro::Row<DMAX> xr;
  if (live) xr.load(x + row * d, d);
  float best;
  int best_i;
  repro::nearest_center(xr, live, c, k, d, tc, smem, best, best_i);
  if (live) {
    const int64_t at = machine * n + row;
    if (idx_out != nullptr) idx_out[at] = best_i;
    if (d2_out != nullptr) d2_out[at] = best;
    if (bins != nullptr) add_to_bin(bins, s.w, at, best_i);
  }
  if (bins != nullptr) flush_bins(s, sbins, k, machine);
}

// The shared memory each variant was allowed so far, a device each.
template <int TC>
std::atomic<int> tiled_allowed[repro::kMaxDevices];
template <int DMAX>
std::atomic<int> wide_allowed[repro::kMaxDevices];

template <int TC>
cudaError_t launch_tiled(dim3 grid, int smem, int device, cudaStream_t stream,
                         const float* x, const float* c, int n, int k, int d, int sub,
                         int chunk, int* idx, float* d2, const Sums& s) {
  auto kernel = assign_tiled_kernel<TC>;
  const cudaError_t err = repro::allow_smem(kernel, smem, device, tiled_allowed<TC>);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(x, c, n, k, d, sub, chunk, idx, d2, s);
  return cudaGetLastError();
}

// One launch of the plan (see assign.py:assign_plan): tc in 1..8 takes the
// tiled kernel on a (grid_x, m) grid with stages of 128·sub rows and `chunk`
// center tiles resident; tc = 0 takes the wide kernel with `chunk` centers a
// tile on ceil(n / 128) × m CTAs.
int launch(const void* x, const void* c, void* idx, void* d2, const Sums& s, int m,
           int n, int k, int d, int tc, int sub, int chunk, int grid_x, int smem,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* xp = static_cast<const float*>(x);
  const float* cp = static_cast<const float*>(c);
  int* ip = static_cast<int*>(idx);
  float* dp = static_cast<float*>(d2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(grid_x, m);
  if (tc == 0) {
    repro::dispatch_d(d, [&](auto dmax) {
      constexpr int D = decltype(dmax)::value;
      auto kernel = assign_wide_kernel<D>;
      // past 48 KB only (the sums' slots beside a full tile): the default
      // carveout keeps more L1 for the rows this kernel reads from global
      if (smem > 48 * 1024) err = repro::allow_smem(kernel, smem, device, wide_allowed<D>);
      if (err == cudaSuccess) {
        kernel<<<grid, kWideThreads, smem, st>>>(xp, cp, n, k, d, chunk, ip, dp, s);
        err = cudaGetLastError();
      }
    });
    return static_cast<int>(err);
  }
  switch (tc) {
    case 1: err = launch_tiled<1>(grid, smem, device, st, xp, cp, n, k, d, sub, chunk, ip, dp, s); break;
    case 2: err = launch_tiled<2>(grid, smem, device, st, xp, cp, n, k, d, sub, chunk, ip, dp, s); break;
    case 3: err = launch_tiled<3>(grid, smem, device, st, xp, cp, n, k, d, sub, chunk, ip, dp, s); break;
    case 4: err = launch_tiled<4>(grid, smem, device, st, xp, cp, n, k, d, sub, chunk, ip, dp, s); break;
    case 5: err = launch_tiled<5>(grid, smem, device, st, xp, cp, n, k, d, sub, chunk, ip, dp, s); break;
    case 6: err = launch_tiled<6>(grid, smem, device, st, xp, cp, n, k, d, sub, chunk, ip, dp, s); break;
    case 7: err = launch_tiled<7>(grid, smem, device, st, xp, cp, n, k, d, sub, chunk, ip, dp, s); break;
    case 8: err = launch_tiled<8>(grid, smem, device, st, xp, cp, n, k, d, sub, chunk, ip, dp, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (n, d), c (k, d) f32; idx (n,) int32, d2 (n,) f32. The last five ints
// are assign.py's AssignPlan (tc, sub, chunk, grid_x, smem). Launches on
// `stream`, does not synchronise, and returns cudaGetLastError().
int repro_assign_nearest(const void* x, const void* c, void* idx, void* d2, int n, int k,
                         int d, int tc, int sub, int chunk, int grid_x, int smem,
                         int device, void* stream) {
  return launch(x, c, idx, d2, Sums{nullptr, nullptr, 0}, 1, n, k, d, tc, sub, chunk,
                grid_x, smem, device, stream);
}

// Batched: x (m, per, d) against c (m, k, d) f32, machine by machine;
// idx (m, per) int32, d2 (m, per) f32; 1 <= m <= 65535.
int repro_assign_nearest_batched(const void* x, const void* c, void* idx, void* d2, int m,
                                 int per, int k, int d, int tc, int sub, int chunk,
                                 int grid_x, int smem, int device, void* stream) {
  return launch(x, c, idx, d2, Sums{nullptr, nullptr, 0}, m, per, k, d, tc, sub, chunk,
                grid_x, smem, device, stream);
}

// The sums entry: x (m, per, d) against c (m, k, d) (m = 1: the 2-D form),
// adding each row's weight w (m, per) f32 into sums (m, k) f32, or, with w
// null, 1 into sums (m, k) int32 counts. idx and d2 may be null (not
// written). bins_in_smem follows the plan (k <= 8,192).
int repro_assign_sums(const void* x, const void* c, const void* w, void* idx, void* d2,
                      void* sums, int m, int per, int k, int d, int bins_in_smem, int tc,
                      int sub, int chunk, int grid_x, int smem, int device,
                      void* stream) {
  const Sums s{sums, static_cast<const float*>(w), bins_in_smem};
  return launch(x, c, idx, d2, s, m, per, k, d, tc, sub, chunk, grid_x, smem, device,
                stream);
}

}  // extern "C"
