// LayerNorm over the last axis, forward and one-pass backward, for Hopper (sm_90a).
//
//   ln_fwd: y = (x - mean) * rstd * scale + bias, rounded once to x's type, with the f32
//           row statistics mean = sum(x) / D and rstd = 1 / sqrt(sum((x - mean)^2) / D + eps)
//           (the variance is centred: never E[x^2] - mean^2);
//   ln_bwd: dx = (g - mean(g) - xhat * mean(g * xhat)) * rstd with g = dy * scale and
//           xhat = (x - mean) * rstd, rounded once to x's type; and dscale = sum(dy * xhat),
//           dbias = sum(dy) over the rows, in f32.
// x, dy, y, dx are row-major [N, D] float32 or bfloat16; scale and bias are read as f32.
//
// Replaces the TPU kernels `_ln_fwd_kernel` (ln_fwd_kernel) and `_ln_bwd_kernel`
// (ln_bwd_kernel) in vit_project_tpu/ops/layernorm.py (reached through `layer_norm_fused`).
// Differences of form: no padded copy of x or dy (rows >= N are never read; the TPU version
// pads N up to its 256-row grid blocks); mean and rstd are [N] f32 (there [Np, 1]); the
// backward's partials of dscale and dbias are one [2D] f32 row per block of this file's
// partition (there one row per 256 rows), summed inside the same launch.
//
// Bound. Both kernels move each element of x, y, dy, dx once and do 8-12 flops per element:
// at the ViT-B/16 step (N = 50,432, D = 768, bf16) the forward moves 155 MB (0.046 ms at
// 3.35 TB/s) against 0.3 GFLOP of f32 work (0.005 ms at 67 TFLOP/s), the backward 234 MB
// (0.070 ms) against 0.46 GFLOP: bytes bind. The design reads and writes each element once
// and keeps enough bytes in flight to fill the memory.
//
// Row layout (both kernels). A block is 8 warps. A row is read by WPR warps (1 for
// D <= 1024, 2 up to 2048, 4 up to 4096), a row group; each thread owns VPL chunks of 8
// consecutive columns, accessed with 16-byte (bf16) or 2 x 16-byte (f32) vectors. A row sum
// is a warp butterfly, and across the WPR warps of a group a fixed-order sum through shared
// memory under the group's own named barrier (double buffered: one barrier per sum).
//
// Forward: one row per row group, 8 / WPR rows per block; the row stays in registers
// between its two reductions.
//
// Backward: a persistent grid, one launch.
//   - Partition (bwd_schedule, exported as ln_bwd_schedule; ops/layernorm.py bwd_schedule
//     computes the same): B = min(264, ceil(N / 8)) blocks (264: two per SM of a 132-SM
//     H100), each owning one contiguous, ordered range of rows = ceil(N / B) rows (the last
//     range ragged; B then recounted so that none is empty). It depends on N alone, never on
//     the card, so the bits do not.
//   - Prefetch: each row group keeps a ring of `stages` shared-memory stages (one row of x
//     and dy each, filled by two 1-D cp.async.bulk copies completing on the stage's
//     mbarrier). The group's next rows are in flight while it reduces the current one; a
//     stage is refilled as soon as its row's second pass has read it. stages = min(4,
//     96 KB / (groups x 2 D sizeof(T))), at least 1: the ring is at most 96 KB, so two
//     blocks fit on an SM (bf16 D = 768: 4 stages; bf16 1,024: 3; f32 768: 2; f32 1,024: 1).
//     The rows' mean and rstd come 32 rows ahead, one row a lane.
//   - Registers: the two passes over a row read x and dy back from the stage, so a thread
//     holds only its columns' sums of dy * xhat and of dy across its rows (2 x VPL x 8 floats)
//     and `__launch_bounds__(256, 2)` caps it at 128 registers, without spills.
//   - dx per row exactly as the unpartitioned kernel computed it (the same in-row sum order
//     and the same expressions), so dx, like y, mean and rstd, keeps its bits.
//   - Partials: once per block, the row groups' sums are added in group order through
//     shared memory and the block writes one [2D] f32 partial row (dscale then dbias).
//   - The final sum runs in the same launch. The kernel is launched cooperatively (the whole
//     grid resident), so after its partial row each block meets the others at a grid
//     barrier, and then every warp of the grid sums one float4 column of the partials in a
//     fixed order (sum_column). No float atomics, no scratch to zero, nothing shared between
//     two calls: calls on two streams never meet. The "last block" alternative (an integer
//     ticket per run of 16 blocks, zeroed by a memset, the runs' last blocks summing in two
//     levels) was slower on an H100 at every shape: its two chained L2 reductions, each by
//     one block, came after the last partial (PERF.md, tools/compare_layernorm_builds.py).
//     A device that cannot hold the grid at once (ln_bwd_resident < B) takes a plain launch
//     and ln_sum_parts_kernel, the same sum in the same order: two kernels, the same bits.
//   - Repeat launches give the same bits: every sum has a fixed order.
//
// rstd is 1.f / sqrtf(var + eps): IEEE square root and division (nvcc's defaults), two
// correct roundings, not the approximate rsqrtf.
//
// The C entries take the target device and set it (cudaSetDevice) only when it is not the
// calling thread's current one, restoring it on return: the Python wrappers pay no device
// context per call.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// The backward's schedule (ops/layernorm.py mirrors every constant; a CPU test ties them).
constexpr int kBwdMaxBlocks = 264;        // two blocks per SM of a 132-SM H100
constexpr int kBwdMinRows = 8;            // rows a block at least: one per warp
constexpr int kBwdMaxStages = 4;          // ring stages per row group, at most
constexpr int kBwdRingBytes = 96 * 1024;  // ring bytes per block, at most

// ---- 8 consecutive elements <-> 8 floats ----------------------------------------------

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// ---- row groups ------------------------------------------------------------------------

// Waits for every thread of row group `group` (WPR warps): the warp itself for WPR = 1,
// else the group's named barrier (ids 1..4; 0 is __syncthreads').
template <int WPR>
__device__ __forceinline__ void group_sync(int group) {
  if constexpr (WPR == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "r"(32 * WPR) : "memory");
  }
}

// Sums each of v[0..NV) over the row: a butterfly in the warp (every lane ends with the same
// bits), then, for WPR > 1, the row's WPR warp sums in warp order through `red`
// ([2][NV][kWarps] floats, alternated by `parity`). Every thread of the row group must call
// this the same number of times, in step.
template <int WPR, int NV>
__device__ __forceinline__ void row_sums(float (&v)[NV], float* red, int& parity, int group) {
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  if constexpr (WPR > 1) {
    const int warp = threadIdx.x >> 5;
    const int first = warp - warp % WPR;
    float* buf = red + parity * NV * kWarps;
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int i = 0; i < NV; ++i) buf[i * kWarps + warp] = v[i];
    }
    group_sync<WPR>(group);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float s = buf[i * kWarps + first];
#pragma unroll
      for (int w = 1; w < WPR; ++w) s += buf[i * kWarps + first + w];
      v[i] = s;
    }
    parity ^= 1;
  }
}

// ---- mbarriers and 1-D bulk copies -------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

// Waits for the phase of parity `parity` to complete. A copy that never lands (a fault: one
// row takes microseconds) traps after 2^26 polls, so the launch fails instead of holding the
// card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  uint32_t polls = 0;
  do {
    if (++polls == (1u << 26)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// `bytes` (a multiple of 16) from 16-byte aligned global `src` to shared `dst`, completing
// on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- forward ---------------------------------------------------------------------------

// sc, bi: [D] f32. mean, rstd: [N] f32.
template <typename T, int WPR, int VPL>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ sc,
              const float* __restrict__ bi, T* __restrict__ y, float* __restrict__ mean,
              float* __restrict__ rstd, int N, int D, float eps) {
  __shared__ float red[2 * kWarps];
  constexpr int kGroups = kWarps / WPR;  // rows per block
  const int warp = threadIdx.x >> 5;
  const int group = warp / WPR;
  const int t = (warp % WPR) * 32 + (threadIdx.x & 31);  // thread within the row's group
  const int row = blockIdx.x * kGroups + group;
  const bool live = row < N;
  const T* xr = x + (long)row * D;
  int parity = 0;

  float v[VPL][8];
  float s[1] = {0.f};
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = (t + i * 32 * WPR) * 8;
    if (live && c < D) {
      load8(xr + c, v[i]);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[i][k] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) s[0] += v[i][k];
  }
  row_sums<WPR, 1>(s, red, parity, group);
  const float mu = s[0] / D;

  float q[1] = {0.f};
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = (t + i * 32 * WPR) * 8;
    if (c < D) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        v[i][k] -= mu;
        q[0] += v[i][k] * v[i][k];
      }
    }
  }
  row_sums<WPR, 1>(q, red, parity, group);
  const float rs = 1.f / sqrtf(q[0] / D + eps);

  if (!live) return;  // the whole group: no barrier follows
  T* yr = y + (long)row * D;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = (t + i * 32 * WPR) * 8;
    if (c < D) {
      float w[8], b[8], o[8];
      load8(sc + c, w);
      load8(bi + c, b);
#pragma unroll
      for (int k = 0; k < 8; ++k) o[k] = (v[i][k] * rs) * w[k] + b[k];
      store8(yr + c, o);
    }
  }
  if (t == 0) {
    mean[row] = mu;
    rstd[row] = rs;
  }
}

// ---- backward --------------------------------------------------------------------------

// The backward's schedule for N rows of D columns of a type of `elem` bytes read by `wpr`
// warps a row (ops/layernorm.py bwd_schedule computes the same).
struct BwdSchedule {
  int blocks, rows, stages;
  int smem;             // dynamic shared memory bytes: the ring, the row groups' sums or the
                        // final sum's staging, whichever is largest
  long scratch_floats;  // the partial rows, [blocks][2D]
};

inline BwdSchedule bwd_schedule(int N, int D, int elem, int wpr) {
  BwdSchedule s;
  const int b = N < 1 ? 1 : (N + kBwdMinRows - 1) / kBwdMinRows;
  const int blocks = b < kBwdMaxBlocks ? b : kBwdMaxBlocks;
  s.rows = N < 1 ? 1 : (N + blocks - 1) / blocks;
  s.blocks = N < 1 ? 0 : (N + s.rows - 1) / s.rows;
  const int groups = kWarps / wpr;
  const int row_pair = 2 * D * elem;
  const int k = kBwdRingBytes / (groups * row_pair);
  s.stages = k < 1 ? 1 : (k > kBwdMaxStages ? kBwdMaxStages : k);
  const int ring = groups * s.stages * row_pair;
  const int sums = groups * 2 * D * 4;
  const int cols = kWarps * kBwdMaxBlocks * 16;  // the final sum's staging, a column a warp
  s.smem = ring > sums ? ring : sums;
  s.smem = s.smem > cols ? s.smem : cols;
  s.scratch_floats = (long)s.blocks * 2 * D;
  return s;
}

// dsb[4q .. 4q + 4) = the sum over b < n_b of float4 column q of the partial rows parts
// [n_b][nq] float4, by one warp, in a fixed order: its lanes stage the column in `col`
// (shared, n_b float4); lane 8c + k adds component c of rows k, k + 8, ... in order, and
// lane 8c adds the eight lanes' sums in k order. `parts` was written by other blocks: read
// through L2.
__device__ __forceinline__ void sum_column(const float4* parts, int n_b, int nq, int q,
                                           float4* col, float* dsb) {
  const int lane = threadIdx.x & 31;
  for (int b = lane; b < n_b; b += 32) col[b] = __ldcg(parts + (long)b * nq + q);
  __syncwarp();
  const int comp = lane >> 3, k = lane & 7;
  const float* c = reinterpret_cast<const float*>(col) + comp;
  float acc = 0.f;
  for (int b = k; b < n_b; b += 8) acc += c[4 * b];
  float total = acc;
#pragma unroll
  for (int i = 1; i < 8; ++i) {
    const float v = __shfl_sync(0xffffffffu, acc, (lane & ~7) + i);
    if (k == 0) total += v;
  }
  if (k == 0) dsb[4 * q + comp] = total;
  __syncwarp();
}

// sc: [D] f32; mean, rstd: [N] f32; parts: [gridDim.x][2D] f32 scratch, the blocks' partial
// rows; dsb: [2D] f32 out, dscale then dbias. Block b owns rows [b * rows, min(N, (b + 1) *
// rows)); row group g of it takes the block's rows g, g + groups, ... in order. Dynamic
// shared memory: `smem` bytes of the schedule. With `final_sum` (a cooperative launch: the
// whole grid is resident) the blocks then meet at a grid barrier and sum the partials into
// dsb, warp w of block b taking float4 columns b + w * gridDim.x, ...; without it they stop
// after the partials, which ln_sum_parts_kernel sums in the same order.
template <typename T, int WPR, int VPL>
__global__ void __launch_bounds__(kThreads, 2)
ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ sc,
              const float* __restrict__ mean, const float* __restrict__ rstd,
              const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ parts,
              float* __restrict__ dsb, int N, int D, int rows, int stages, int final_sum) {
  constexpr int kGroups = kWarps / WPR;
  // chunks i < kInside lie inside every row of this (WPR, VPL) (width_config's least D for
  // it), so only the others test c < D: the compiler can schedule their loads together. In
  // f32 at most 2 (at D = 1,024, 3 spilled past the 128-register cap).
  constexpr int kSafe = WPR == 1 ? VPL - 1 : VPL / 2;
  constexpr int kInside = sizeof(T) == 4 && kSafe > 2 ? 2 : kSafe;
  __shared__ float red[2 * 2 * kWarps];
  __shared__ __align__(8) uint64_t full[kWarps * kBwdMaxStages];  // [group][stage]
  extern __shared__ float4 dyn4[];
  char* dyn = reinterpret_cast<char*>(dyn4);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int group = warp / WPR;
  const int t = (warp % WPR) * 32 + lane;  // thread within the row group
  const int r0 = blockIdx.x * rows;
  const int mine = min(N, r0 + rows) - r0;  // this block's rows
  const int n_rows = mine > group ? (mine - group + kGroups - 1) / kGroups : 0;
  const uint32_t row_bytes = (uint32_t)D * sizeof(T);
  char* ring = dyn + (size_t)group * stages * 2 * row_bytes;
  uint64_t* bars = full + group * kBwdMaxStages;
  int parity = 0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kGroups * kBwdMaxStages; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the group's j-th row (block row group + j * kGroups) into stage j % stages
  auto fill = [&](int j) {
    const int s = j % stages;
    const long off = (long)(r0 + group + j * kGroups) * D;
    char* dst = ring + (size_t)s * 2 * row_bytes;
    mbar_expect_tx(&bars[s], 2 * row_bytes);
    bulk_load(dst, x + off, row_bytes, &bars[s]);
    bulk_load(dst + row_bytes, dy + off, row_bytes, &bars[s]);
  };
  if (t == 0)
    for (int j = 0; j < stages && j < n_rows; ++j) fill(j);

  // The statistics of the group's rows, 32 rows at a time: lane l holds those of row l of the
  // current batch and of the next, loaded a batch ahead.
  float mu_b = 0.f, rs_b = 0.f, mu_n = 0.f, rs_n = 0.f;
  if (lane < n_rows) {
    mu_b = mean[r0 + group + lane * kGroups];
    rs_b = rstd[r0 + group + lane * kGroups];
  }
  if (32 + lane < n_rows) {
    mu_n = mean[r0 + group + (32 + lane) * kGroups];
    rs_n = rstd[r0 + group + (32 + lane) * kGroups];
  }

  float a_sc[VPL][8], a_bi[VPL][8];  // this thread's columns: sums of dy * xhat and of dy
#pragma unroll
  for (int i = 0; i < VPL; ++i)
#pragma unroll
    for (int k = 0; k < 8; ++k) a_sc[i][k] = a_bi[i][k] = 0.f;

  for (int j = 0; j < n_rows; ++j) {
    const int s = j % stages;
    const int row = r0 + group + j * kGroups;
    if (j > 0 && (j & 31) == 0) {
      mu_b = mu_n;
      rs_b = rs_n;
      if (j + 32 + lane < n_rows) {
        mu_n = mean[r0 + group + (j + 32 + lane) * kGroups];
        rs_n = rstd[r0 + group + (j + 32 + lane) * kGroups];
      }
    }
    const float mu = __shfl_sync(0xffffffffu, mu_b, j & 31);
    const float rs = __shfl_sync(0xffffffffu, rs_b, j & 31);
    mbar_wait(&bars[s], (uint32_t)(j / stages) & 1u);
    const T* xs = reinterpret_cast<const T*>(ring + (size_t)s * 2 * row_bytes);
    const T* ds = xs + D;
    float sums[2] = {0.f, 0.f};  // sums of g and of g * xhat
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = (t + i * 32 * WPR) * 8;
      if (i < kInside || c < D) {
        float xv[8], d[8], w[8];
        load8(xs + c, xv);
        load8(ds + c, d);
        load8(sc + c, w);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float xh = (xv[k] - mu) * rs;
          const float g = d[k] * w[k];
          sums[0] += g;
          sums[1] += g * xh;
        }
      }
    }
    row_sums<WPR, 2>(sums, red, parity, group);
    const float m1 = sums[0] / D;
    const float m2 = sums[1] / D;
    T* dxr = dx + (long)row * D;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = (t + i * 32 * WPR) * 8;
      if (i < kInside || c < D) {
        float xv[8], d[8], w[8], o[8];
        load8(xs + c, xv);
        load8(ds + c, d);
        load8(sc + c, w);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float xh = (xv[k] - mu) * rs;
          o[k] = (d[k] * w[k] - m1 - xh * m2) * rs;
          a_sc[i][k] += d[k] * xh;
          a_bi[i][k] += d[k];
        }
        store8(dxr + c, o);
      }
    }
    // every thread of the group has read stage s (the values are consumed: the reads are
    // complete, so the async proxy's refill needs no fence after them)
    group_sync<WPR>(group);
    if (t == 0 && j + stages < n_rows) fill(j + stages);
  }

  // the row groups' sums, added in group order: one partial row for the block. Every copy
  // has landed (each group waited for all it issued), so the ring is free.
  __syncthreads();
  float* slots = reinterpret_cast<float*>(dyn);  // [kGroups][2D]
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = (t + i * 32 * WPR) * 8;
    if (c < D) {
      store8(slots + (long)group * 2 * D + c, a_sc[i]);
      store8(slots + (long)group * 2 * D + D + c, a_bi[i]);
    }
  }
  __syncthreads();
  const int width = 2 * D;
  float* part = parts + (long)blockIdx.x * width;
  for (int c = threadIdx.x * 4; c < width; c += kThreads * 4) {
    float4 acc = *reinterpret_cast<const float4*>(slots + c);
#pragma unroll
    for (int g = 1; g < kGroups; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(slots + g * width + c);
      acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
    }
    *reinterpret_cast<float4*>(part + c) = acc;
  }
  if (!final_sum) return;

  // every block's partial row is written: the grid barrier orders those writes before the
  // reads below (it is a gpu-scope release and acquire). Then the column sums.
  cooperative_groups::this_grid().sync();
  const int n_b = gridDim.x;
  const int nq = width / 4;
  float4* col = dyn4 + warp * kBwdMaxBlocks;  // this warp's staging (the slots are free)
  for (int q = blockIdx.x + warp * n_b; q < nq; q += n_b * kWarps)
    sum_column(reinterpret_cast<const float4*>(parts), n_b, nq, q, col, dsb);
}

// The partials' sum where the backward could not be launched cooperatively: warp w of block
// b takes float4 column b * kWarps + w; the same order as ln_bwd_kernel's final sum, so the
// same bits.
__global__ void __launch_bounds__(kThreads)
ln_sum_parts_kernel(const float* __restrict__ parts, float* __restrict__ dsb, int n_b,
                    int width) {
  __shared__ float4 cols[kWarps][kBwdMaxBlocks];
  const int warp = threadIdx.x >> 5;
  const int q = blockIdx.x * kWarps + warp;
  if (q < width / 4)
    sum_column(reinterpret_cast<const float4*>(parts), n_b, width / 4, q, cols[warp], dsb);
}

// ---- launch by row width and type ---------------------------------------------------------

// (WPR, VPL) by the row's chunks of 8: the fewest warps, then the fewest chunks per thread,
// that cover it. Returns false for D outside [8, 4096] or not a multiple of 8.
inline bool width_config(int D, int* wpr, int* vpl) {
  if (D < 8 || D > 4096 || D % 8 != 0) return false;
  const int chunks = D / 8;
  if (chunks <= 32) { *wpr = 1; *vpl = 1; }
  else if (chunks <= 64) { *wpr = 1; *vpl = 2; }
  else if (chunks <= 96) { *wpr = 1; *vpl = 3; }
  else if (chunks <= 128) { *wpr = 1; *vpl = 4; }
  else if (chunks <= 256) { *wpr = 2; *vpl = 4; }
  else { *wpr = 4; *vpl = 4; }
  return true;
}

template <int V>
using Int = std::integral_constant<int, V>;

// Calls f(T{}, Int<WPR>{}, Int<VPL>{}) with T float (dtype 0) or __nv_bfloat16 (dtype 1) and
// (WPR, VPL) of width_config. Returns false for any other dtype or width.
template <typename F>
bool dispatch(int dtype, int D, F&& f) {
  int wpr, vpl;
  if (!width_config(D, &wpr, &vpl) || (dtype != 0 && dtype != 1)) return false;
  auto by_width = [&](auto t) {
    if (wpr == 1 && vpl == 1) f(t, Int<1>{}, Int<1>{});
    else if (wpr == 1 && vpl == 2) f(t, Int<1>{}, Int<2>{});
    else if (wpr == 1 && vpl == 3) f(t, Int<1>{}, Int<3>{});
    else if (wpr == 1) f(t, Int<1>{}, Int<4>{});
    else if (wpr == 2) f(t, Int<2>{}, Int<4>{});
    else f(t, Int<4>{}, Int<4>{});
  };
  if (dtype == 0) by_width(float{});
  else by_width(__nv_bfloat16{});
  return true;
}

// Sets ln_bwd_kernel<T, W, V>'s attribute once per device (the calling thread's current
// one): up to kBwdRingBytes of dynamic shared memory (above 48 KB needs the attribute; the
// row groups' sums take at most 64 KB). Returns in *resident the blocks the device holds at
// once at that shared memory (every SM's share), which decides whether the grid can be
// launched cooperatively.
template <typename T, int W, int V>
cudaError_t prepare_bwd(int device, int* resident) {
  static int held[64] = {0};  // per device: 0 unknown, else resident blocks + 1
  const bool known = device >= 0 && device < 64;
  if (known && held[device] > 0) {
    *resident = held[device] - 1;
    return cudaSuccess;
  }
  auto kernel = ln_bwd_kernel<T, W, V>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdRingBytes);
  int per_sm = 0, sms = 0, coop = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                        kBwdRingBytes);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  *resident = coop ? per_sm * sms : 0;
  if (known) held[device] = *resident + 1;
  return cudaSuccess;
}

// Makes `device` current for the scope, and restores the caller's device after.
struct DeviceScope {
  int saved = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceScope(int device) {
    int cur;
    err = cudaGetDevice(&cur);
    if (err == cudaSuccess && cur != device) {
      err = cudaSetDevice(device);
      if (err == cudaSuccess) saved = cur;
    }
  }
  ~DeviceScope() {
    if (saved >= 0) cudaSetDevice(saved);
  }
};

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16. Every pointer is
// 16-byte aligned, every array contiguous, on CUDA device `device`; D a multiple of 8 in
// [8, 4096], N > 0. Launches on `stream` and returns the first cudaError_t (0 on success).

// x, y: [N, D]; scale, bias: [D] f32; mean, rstd: [N] f32.
extern "C" int ln_fwd(const void* x, const void* scale, const void* bias, void* y, void* mean,
                      void* rstd, int N, int D, float eps, int dtype, int device,
                      void* stream) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  auto launch = [&](auto t, auto wpr, auto vpl) {
    using T = decltype(t);
    constexpr int kRows = kWarps / decltype(wpr)::value;
    ln_fwd_kernel<T, decltype(wpr)::value, decltype(vpl)::value>
        <<<(N + kRows - 1) / kRows, kThreads, 0, st>>>(
            static_cast<const T*>(x), static_cast<const float*>(scale),
            static_cast<const float*>(bias), static_cast<T*>(y), static_cast<float*>(mean),
            static_cast<float*>(rstd), N, D, eps);
  };
  if (N <= 0 || !dispatch(dtype, D, launch)) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The backward's schedule for (N, D, dtype): out = {blocks, rows, stages, smem bytes, scratch
// floats}; the last entry is always the scratch ln_bwd takes. Returns cudaErrorInvalidValue
// for a width or dtype the kernel refuses.
extern "C" int ln_bwd_schedule(int N, int D, int dtype, long* out) {
  int wpr, vpl;
  if (!width_config(D, &wpr, &vpl) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const BwdSchedule s = bwd_schedule(N, D, dtype == 0 ? 4 : 2, wpr);
  out[0] = s.blocks; out[1] = s.rows; out[2] = s.stages; out[3] = s.smem;
  out[4] = s.scratch_floats;
  return 0;
}

namespace {

// ln_bwd's launch; `whole_grid` allows the cooperative one where the device holds the grid.
int launch_bwd(const void* x, const void* sc, const void* mean, const void* rstd,
               const void* dy, void* dx, void* parts, void* dsb, int N, int D, int dtype,
               int device, void* stream, bool whole_grid) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  auto launch = [&](auto t, auto wpr, auto vpl) {
    using T = decltype(t);
    constexpr int W = decltype(wpr)::value, V = decltype(vpl)::value;
    const BwdSchedule s = bwd_schedule(N, D, (int)sizeof(T), W);
    int resident = 0;
    err = prepare_bwd<T, W, V>(device, &resident);
    if (err != cudaSuccess) return;
    const T* x_ = static_cast<const T*>(x);
    const float* sc_ = static_cast<const float*>(sc);
    const float* mean_ = static_cast<const float*>(mean);
    const float* rstd_ = static_cast<const float*>(rstd);
    const T* dy_ = static_cast<const T*>(dy);
    T* dx_ = static_cast<T*>(dx);
    float* parts_ = static_cast<float*>(parts);
    float* dsb_ = static_cast<float*>(dsb);
    int n = N, d = D, rows = s.rows, stages = s.stages;
    int final_sum = whole_grid && s.blocks <= resident;
    if (final_sum) {
      void* args[] = {&x_, &sc_, &mean_, &rstd_, &dy_, &dx_, &parts_, &dsb_,
                      &n, &d, &rows, &stages, &final_sum};
      err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(ln_bwd_kernel<T, W, V>),
                                        s.blocks, kThreads, args, s.smem, st);
      return;
    }
    ln_bwd_kernel<T, W, V><<<s.blocks, kThreads, s.smem, st>>>(
        x_, sc_, mean_, rstd_, dy_, dx_, parts_, dsb_, n, d, rows, stages, 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return;
    ln_sum_parts_kernel<<<(2 * D / 4 + kWarps - 1) / kWarps, kThreads, 0, st>>>(
        parts_, dsb_, s.blocks, 2 * D);
    err = cudaGetLastError();
  };
  if (N <= 0 || !dispatch(dtype, D, launch)) return (int)cudaErrorInvalidValue;
  return (int)err;
}

}  // namespace

// x, dy, dx: [N, D]; sc: [D] f32; mean, rstd: [N] f32; parts: the schedule's scratch_floats
// f32 (no initial value); dsb: [2D] f32 out, dscale then dbias. One cooperative launch of
// ln_bwd_kernel on `stream`, which also sums the partials; where the device cannot hold the
// whole grid at once (fewer than 132 SMs at two blocks each), a plain launch and then
// ln_sum_parts_kernel, with the same bits.
extern "C" int ln_bwd(const void* x, const void* sc, const void* mean, const void* rstd,
                      const void* dy, void* dx, void* parts, void* dsb, int N, int D,
                      int dtype, int device, void* stream) {
  return launch_bwd(x, sc, mean, rstd, dy, dx, parts, dsb, N, D, dtype, device, stream, true);
}

// ln_bwd's two-kernel path on any device, the one it takes where the grid does not fit (a
// card test holds its bits to ln_bwd's).
extern "C" int ln_bwd_split(const void* x, const void* sc, const void* mean, const void* rstd,
                            const void* dy, void* dx, void* parts, void* dsb, int N, int D,
                            int dtype, int device, void* stream) {
  return launch_bwd(x, sc, mean, rstd, dy, dx, parts, dsb, N, D, dtype, device, stream,
                    false);
}

// Blocks of the backward kernel that `device` holds at once at width D and dtype (-1 on a
// refused width or an error): the whole grid of up to 264 runs as one cooperative launch
// where this is at least the schedule's blocks.
extern "C" int ln_bwd_resident(int D, int dtype, int device) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return -1;
  int n = -1;
  auto query = [&](auto t, auto wpr, auto vpl) {
    using T = decltype(t);
    constexpr int W = decltype(wpr)::value, V = decltype(vpl)::value;
    if (prepare_bwd<T, W, V>(device, &n) != cudaSuccess) n = -1;
  };
  if (!dispatch(dtype, D, query)) return -1;
  return n;
}
