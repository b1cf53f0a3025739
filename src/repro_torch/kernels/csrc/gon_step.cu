// GON step for Hopper (sm_90a): one Gonzalez iteration over m machine blocks,
// in one launch, with the next center picked on the card.
//
// Replaces the TPU kernel src/repro/kernels/fused_argfar.py
// `fused_min_argmax_blocks` (body `_fused_kernel`), batched over the machine
// axis that the JAX package maps with `jax.vmap`.
//
// For machine b and its center c[b]:
//   d2[b, r]  = sum_j (x[b, r, j] - c[b, j])^2      (direct form, j order)
//   md[b, r]  = min(md[b, r], d2[b, r])             (in place)
//   far_i[b]  = first argmax_r md[b, r],  far_v[b] = md[b, far_i[b]]
// and, by the CTA that finishes machine b last:
//   * with a carry (the streamed pass): (carry_v, carry_i, carry_row)[b]
//     takes (far_v, off + far_i, x[b, far_i]) when `reset` (the pass's first
//     block) or on strict far_v > carry_v, so the earliest block keeps a tie;
//   * with a slot 0 <= slot < k: centers[b, slot] and indices[b, slot] get the
//     row and index of the far point (the carry's, when there is one). The
//     in-memory loop reads centers[:, i] as the center of step i and writes
//     slot i + 1, so a GON iteration is this launch and nothing else.
//
// Bound on this card: bytes. Each row is read once (4·d bytes of x, 4 of md)
// and md written once (4 bytes); ~3·d operations a row. At m = 50, per =
// 20,000: 16 MB at d = 2 (4.8 us at 3.35 TB/s), 160 MB at d = 38 (47.8 us).
// An iteration of the previous design took 16.6 / 141 us there and 67 us
// on the streamed kddlike super-shard (573,580 rows, d = 38, bound ~27 us),
// its step kernel and a reduce kernel 11.4 / 133 / 60 us of that: one
// thread read its row's d floats at a stride of 4·d bytes (32 cache lines a
// warp load at d = 38), and a gather of the next center followed. This
// design takes 13.8 / 68 / 45 us for the whole iteration.
//
// Design:
//   * Persistent CTAs (as many as the SMs' shared memory holds, up to 4 a
//     SM: 4 at d <= 3, 3 at d = 4 and 5, 2 from d = 6 on) each take a contiguous range of the
//     (machine, tile) pairs, tiles of `tile_rows` rows (36 KB of x, at most
//     1,024 rows).
//     A tile's rows and md values are contiguous in memory, so every d takes
//     one path: the CTA stages them in shared memory in a 3-stage ring, two
//     tiles ahead of the one it reduces: one thread asks the copy engine for
//     each span's 16-byte aligned body (cp.async.bulk, counted in by the
//     stage's mbarrier), and a few threads copy the misaligned head and tail
//     of up to 3 floats by 4-byte cp.async (cp_async.cuh). The loads are
//     coalesced at any d; the per-row arithmetic stays one thread a row, read
//     from shared memory (a stride of d floats: 2-way bank conflicts at d = 2
//     and d = 38), so the rounding does not change.
//   * Each CTA keeps its running (max, first argmax) across its tiles of a
//     machine and writes one partial per machine it touched, into slot
//     cta + b: the CTAs' ranges are ordered, so (cta, b) pairs form a chain
//     and cta + b never repeats (grid + m - 1 slots). It then fences and adds
//     its tile count to the machine's counter; the CTA that completes the
//     count merges the machine's partials in (value descending, row
//     ascending) order, which does not depend on the arrival order, writes
//     the outputs and resets the counter to 0 for the next launch (its warp
//     0 alone, without block barriers). Where m <= the CTA count the plan gives
//     each machine the same number of CTAs, so no CTA's range crosses a
//     machine and each publishes once, after its last tile.
//
// Rounding: __fsub_rn/__fmul_rn/__fadd_rn keep nvcc from contracting
// diff*diff + s into an FMA, so the card rounds like the plain version
// (`(x - c) * (x - c)`, then the sum): md is bitwise the plain version's.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 3;
constexpr int kIdxNone = 0x7fffffff;

// Mirrored by fused_argfar.GonArgs (ctypes); repro_gon_args_size checks it.
struct GonArgs {
  const float* x;        // (m, per, d)
  const float* c;        // (m, d), rows c_stride floats apart
  float* md;             // (m, per), updated in place
  float* part_v;         // (grid + m) per-CTA partials, slot cta + b
  int* part_i;
  int* counter;          // (m,) tiles done; 0 between launches
  float* far_v;          // (m,)
  int* far_i;            // (m,)
  float* centers;        // (m, k, d) or null
  int* indices;          // (m, k) or null
  float* carry_v;        // (m,) or null: the streamed pass's far point
  long long* carry_i;    // (m,)
  float* carry_row;      // (m, d)
  long long c_stride;
  long long off;         // global number of row 0 (carry and indices)
  int m, per, d, k, slot, reset;
  int tile_rows, ntiles, grid;
  int x_stage, md_stage, c_floats;  // floats of a ring stage's parts, center
  int smem;                         // dynamic shared bytes
};

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

// Block-wide (max, first argmax); the result is valid in thread 0. Every
// thread calls it; it may be called again right after.
__device__ __forceinline__ void block_argmax(float& v, int& i) {
  __shared__ float sv[32];
  __shared__ int si[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // the previous call's reads of sv/si are done
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

// The CTA whose pair range [cta·P/G, (cta+1)·P/G) holds pair p.
__device__ __forceinline__ int cta_of(int64_t p, int64_t pairs, int grid) {
  return static_cast<int>(((p + 1) * grid - 1) / pairs);
}

// sum_j (xr[j] - c[j])^2 in j order, over D floats unrolled, or over d
// with D = 0. Only d = 2 takes an unrolled variant: there it was 17-20 %
// faster than the loop on the card, and an unroll to 16 was 4.5 % slower
// than the loop at d = 10 (PERF.md).
template <int D>
__device__ __forceinline__ float direct_d2(const float* xr, const float* c,
                                           int d) {
  float s = 0.0f;
  if constexpr (D > 0) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const float diff = __fsub_rn(xr[j], c[j]);
      s = __fadd_rn(s, __fmul_rn(diff, diff));
    }
  } else {
    for (int j = 0; j < d; ++j) {
      const float diff = __fsub_rn(xr[j], c[j]);
      s = __fadd_rn(s, __fmul_rn(diff, diff));
    }
  }
  return s;
}

// This CTA is done with machine b over `tiles` tiles: publish its partial;
// the CTA that completes the machine merges the partials and writes the
// outputs. Every thread calls it.
__device__ void finish_machine(const GonArgs& p, int b, float bv, int bi,
                               int tiles) {
  __shared__ int s_last;
  block_argmax(bv, bi);
  if (threadIdx.x == 0) {
    p.part_v[blockIdx.x + b] = bv;
    p.part_i[blockIdx.x + b] = bi;
    // release: the partial is visible before the count; acquire: the CTA
    // that completes the count sees every other CTA's partial
    int before;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], %2;\n"
                 : "=r"(before)
                 : "l"(p.counter + b), "r"(tiles)
                 : "memory");
    s_last = before + tiles == p.ntiles;
  }
  __syncthreads();
  if (!s_last || threadIdx.x >= 32) return;
  // warp 0 of the CTA that completed machine b merges its partials, read
  // from L2 after thread 0's acquire and the barrier
  __threadfence();
  const int lane = threadIdx.x;
  const int64_t pairs = static_cast<int64_t>(p.m) * p.ntiles;
  const int lo = cta_of(static_cast<int64_t>(b) * p.ntiles, pairs, p.grid);
  const int hi = cta_of(static_cast<int64_t>(b + 1) * p.ntiles - 1, pairs, p.grid);
  float v = -CUDART_INF_F;
  int i = kIdxNone;
  for (int j = lo + lane; j <= hi; j += 32) {
    const float pv = __ldcg(p.part_v + j + b);
    const int pi = __ldcg(p.part_i + j + b);
    if (beats(pv, pi, v, i)) {
      v = pv;
      i = pi;
    }
  }
  warp_argmax(v, i);  // the machine's far point, in lane 0
  const bool slot = p.slot >= 0 && p.slot < p.k;
  int take = 1;
  if (lane == 0) {
    p.far_v[b] = v;
    p.far_i[b] = i;
    long long gi = p.off + i;
    if (p.carry_v != nullptr) {
      take = p.reset || v > __ldcg(p.carry_v + b);
      if (take) {
        p.carry_v[b] = v;
        p.carry_i[b] = gi;
      } else {
        gi = __ldcg(p.carry_i + b);
      }
    }
    if (slot) p.indices[static_cast<int64_t>(b) * p.k + p.slot] = static_cast<int>(gi);
    p.counter[b] = 0;  // ready for the next launch
  }
  i = __shfl_sync(0xffffffffu, i, 0);
  take = __shfl_sync(0xffffffffu, take, 0);
  const float* src = take ? p.x + (static_cast<int64_t>(b) * p.per + i) * p.d
                          : p.carry_row + static_cast<int64_t>(b) * p.d;
  for (int j = lane; j < p.d; j += 32) {
    const float val = take ? src[j] : __ldcg(src + j);
    if (take && p.carry_row != nullptr) p.carry_row[static_cast<int64_t>(b) * p.d + j] = val;
    if (slot) p.centers[(static_cast<int64_t>(b) * p.k + p.slot) * p.d + j] = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2) gon_kernel(const GonArgs p) {
  extern __shared__ float4 smem4[];
  __shared__ uint64_t full[kStages];  // a stage's bytes have landed
  float* const sc = reinterpret_cast<float*>(smem4);  // the machine's center
  float* const ring = sc + p.c_floats;                 // kStages × (x, md)
  const int stage = p.x_stage + p.md_stage;
  const int64_t pairs = static_cast<int64_t>(p.m) * p.ntiles;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * pairs / p.grid;
  const int mine = static_cast<int>(
      static_cast<int64_t>(blockIdx.x + 1) * pairs / p.grid - lo);

  // my q-th pair -> (first row of its tile in x's row numbering, rows)
  auto tile_of = [&](int q, int& b, int& r0, int& nr) {
    const int64_t pr = lo + q;
    b = static_cast<int>(pr / p.ntiles);
    r0 = static_cast<int>(pr % p.ntiles) * p.tile_rows;
    nr = min(p.tile_rows, p.per - r0);
  };
  auto issue = [&](int q) {
    int b, r0, nr;
    tile_of(q, b, r0, nr);
    const int64_t row0 = static_cast<int64_t>(b) * p.per + r0;
    const float* xs = p.x + row0 * p.d;
    const float* mds = p.md + row0;
    float* st = ring + (q % kStages) * stage;
    uint64_t* bar = full + q % kStages;
    if (threadIdx.x == 0) {
      repro::fence_proxy_async();  // the stage's last reads come first
      repro::mbar_expect_tx(bar, repro::span_body_bytes(xs, nr * p.d) +
                                     repro::span_body_bytes(mds, nr));
    }
    repro::stage_span_bulk(st, xs, nr * p.d, bar);
    repro::stage_span_bulk(st + p.x_stage, mds, nr, bar);
  };

  if (threadIdx.x == 0) {
    for (int q = 0; q < kStages; ++q) repro::mbar_init(full + q, 1);
    repro::mbar_init_fence();
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) {
    if (q < mine) issue(q);
    repro::cp_async_commit();
  }
  float bv = -CUDART_INF_F;
  int bi = kIdxNone;
  int cur = -1, tiles = 0;
  for (int q = 0; q < mine; ++q) {
    if (q + kStages - 1 < mine) issue(q + kStages - 1);
    repro::cp_async_commit();
    repro::cp_async_wait<kStages - 1>();  // my head/tail copies of pair q
    repro::mbar_wait(full + q % kStages, (q / kStages) & 1);  // and the bodies
    int b, r0, nr;
    tile_of(q, b, r0, nr);
    if (b != cur) {
      if (cur >= 0) {
        finish_machine(p, cur, bv, bi, tiles);
        bv = -CUDART_INF_F;
        bi = kIdxNone;
        tiles = 0;
      }
      for (int j = threadIdx.x; j < p.d; j += kThreads) sc[j] = p.c[b * p.c_stride + j];
      cur = b;
    }
    __syncthreads();  // the tile and the center are visible to the block
    const int64_t row0 = static_cast<int64_t>(b) * p.per + r0;
    const float* st = ring + (q % kStages) * stage;
    const float* sx = st + repro::misalign(p.x + row0 * p.d);
    const float* smd = st + p.x_stage + repro::misalign(p.md + row0);
    float* md = p.md + row0;
    for (int r = threadIdx.x; r < nr; r += kThreads) {
      const float nm = fminf(smd[r], direct_d2<D>(sx + r * p.d, sc, p.d));
      md[r] = nm;
      if (beats(nm, r0 + r, bv, bi)) {
        bv = nm;
        bi = r0 + r;
      }
    }
    ++tiles;
    __syncthreads();  // the stage is consumed before it is refilled
  }
  if (cur >= 0) finish_machine(p, cur, bv, bi, tiles);
}

// The shared memory each variant was allowed so far, a device each.
template <int D>
std::atomic<int> allowed[repro::kMaxDevices];

// f(kernel, its record) for the variant that takes width d.
template <typename F>
cudaError_t with_variant(int d, F&& f) {
  return d == 2 ? f(gon_kernel<2>, allowed<2>) : f(gon_kernel<0>, allowed<0>);
}

}  // namespace

extern "C" {

int repro_gon_args_size() { return static_cast<int>(sizeof(GonArgs)); }

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One GON step as planned by fused_argfar.gon_plan; `args` is a GonArgs. Launches on `stream`,
// does not synchronise, and returns cudaGetLastError().
int repro_gon_step(const void* args, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const GonArgs p = *static_cast<const GonArgs*>(args);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = with_variant(p.d, [&](auto kernel, std::atomic<int>* allowed) {
    cudaError_t e = repro::allow_smem(kernel, p.smem, device, allowed);
    if (e == cudaSuccess) kernel<<<p.grid, kThreads, p.smem, s>>>(p);
    return e;
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of the d-wide variant that one SM holds at `smem` dynamic bytes
// (what fused_argfar.gon_plan counts on), or minus a CUDA error.
int repro_gon_ctas_per_sm(int d, int smem) {
  int ctas = 0, device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = with_variant(d, [&](auto kernel, std::atomic<int>* allowed) {
      cudaError_t e = repro::allow_smem(kernel, smem, device, allowed);
      if (e != cudaSuccess) return e;
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, kThreads, smem);
    });
  }
  return err == cudaSuccess ? ctas : -static_cast<int>(err);
}

}  // extern "C"
