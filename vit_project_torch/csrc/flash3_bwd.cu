// Flash attention backward on one packed [B, S, 3D] qkv tensor, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash3_bwd_kernel` in vit_project_tpu/ops/attention.py
// (with `_attn_bwd_head` and `_attn_masks`), the backward of `flash_mha_packed_qkv`.
// It computes, per head and in that function's order of operations:
//   s  = q k^T (q already scaled by 1/sqrt(dh)), masked: keys >= S, and with `causal`
//        every key past the row, get p = 0 (the TPU kernel's exp(-1e30 - lse));
//   p  = exp(s - lse), replaying the forward's float32 row log-sum-exp: no max and
//        no sum is recomputed;
//   dv = p^T do, with p rounded to the working type first;
//   dp = do v^T in float32;
//   c  = sum_j p * dp over the whole row, in float32 (from p and dp, not from o);
//   ds = p * (dp - c), rounded to the working type;
//   dq = ds k and dk = ds^T q, accumulated in float32.
// Inputs: packed qkv (q at lanes h*dh, k at D + h*dh, v at 2D + h*dh), do [B, S, D]
// and lse [B, S, H] f32. Output: one packed dqkv [B, S, 3D] in qkv's type, dq, dk
// and dv at the lanes of q, k and v. Every operand is read by stride straight out of
// the packed rows; no split and no head transpose goes to device memory.
//
// Design. The TPU kernel holds a whole 257-row head tile in VMEM and needs no sum
// carried between grid steps. Hopper blocks run in no order, so the work is two
// passes, and no float atomics anywhere (gradients stay bit-identical run to run,
// which the bit-exact resume of the training loop relies on):
//   1. dq pass, grid (64-row q tile, head, batch): a first loop over the 64-key k/v
//      tiles forms c for its rows (written to a float32 scratch `delta` [B, S, H]);
//      a second loop forms ds and accumulates dq in registers.
//   2. dk/dv pass, grid (64-key tile, head, batch), launched after the first on the
//      same stream: a loop over the q tiles (reading their lse and c) accumulates
//      dk and dv for its keys in registers. It works on the transposed scores
//      s^T = k q^T, so each warp owns 16 keys and p^T, ds^T stay in registers.
// A causal block skips every tile that lies wholly above the diagonal. Rows and
// keys past S read as zero and are never written. dh is fixed at 64.
//   - bf16: 4 warps of 16 rows (or keys) each; every product runs on the tensor
//     cores with mma.sync m16n8k16 (bf16 in, f32 accumulate). Score accumulators
//     are re-packed in registers as the A operand of the next product.
//   - f32: the tensor cores have no exact f32 product, so two threads share a row
//     (or key), each holding 32 of its 64 lanes, and compute every product with
//     FMAs from shared memory (dot products joined with one shuffle).
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s dense bf16; NVIDIA's data sheet):
// at the training step's image shape, qkv [64, 257, 3072] bf16 with H = 16, the
// function must read qkv, do and lse (136 MB) and write dqkv (101 MB): 237 MB,
// 0.07 ms, against five products over the 67.6 M kept (row, key, head) pairs,
// 43 GFLOP, 0.04 ms. It is bound by bytes. This design reads each q, k, v, do
// tile once per tile pair (from L2 mostly) and does nine products per pair, not
// five: c and the scores are recomputed in each pass instead of going through
// device memory. Speed is left to later work (wgmma, TMA, one fused pass).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kDh = 64;       // head width this file has a template for
constexpr int kTile = 64;     // q rows of a dq block, keys of a dk/dv block, loop tiles
constexpr int kPad = 8;       // bf16 row padding: 144-byte rows, conflict-free fragment loads
constexpr int kF32Tile = 32;  // loop tile of the f32 kernels

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// p of one score: exp(s - lse) where (row, col) is kept, else exactly 0.
__device__ __forceinline__ float replay_p(float s, int row, int col, float lse, int S,
                                          int causal) {
  const bool ok = row < S && col < S && (!causal || col <= row);
  return ok ? expf(s - lse) : 0.f;
}

// Copy rows [row0, row0 + 64) of one 64-lane column slice into shared memory,
// 16 bytes per thread and load; rows past S are zero.
__device__ __forceinline__ void load_tile_bf16(bf16 (*dst)[kDh + kPad], const bf16* src,
                                               long row_stride, int row0, int S) {
  for (int i = threadIdx.x; i < kTile * (kDh / 8); i += blockDim.x) {
    const int r = i / (kDh / 8);
    const int c = (i % (kDh / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S) {
      v = *reinterpret_cast<const uint4*>(src + (long)(row0 + r) * row_stride + c);
    }
    *reinterpret_cast<uint4*>(&dst[r][c]) = v;
  }
}

// A fragments (m16n8k16) of 16 rows starting at `r_lo - g` of a tile, for the 4
// k-steps of 16 lanes of dh.
__device__ __forceinline__ void load_a_frags(uint32_t (*a)[4], bf16 (*tile)[kDh + kPad],
                                             int r_lo, int t) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int c = ks * 16 + t * 2;
    a[ks][0] = *reinterpret_cast<const uint32_t*>(&tile[r_lo][c]);
    a[ks][1] = *reinterpret_cast<const uint32_t*>(&tile[r_lo + 8][c]);
    a[ks][2] = *reinterpret_cast<const uint32_t*>(&tile[r_lo][c + 8]);
    a[ks][3] = *reinterpret_cast<const uint32_t*>(&tile[r_lo + 8][c + 8]);
  }
}

// out[16 rows x 64 cols] = A (16 rows x 64 dh) * tile^T, where the 64 rows of
// `tile` are the output columns: 8 n-tiles of 8 columns.
__device__ __forceinline__ void product_nt(float (*out)[4], uint32_t (*a)[4],
                                           bf16 (*tile)[kDh + kPad], int g, int t) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    out[nt][0] = out[nt][1] = out[nt][2] = out[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int c = ks * 16 + t * 2;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&tile[nt * 8 + g][c]);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&tile[nt * 8 + g][c + 8]);
      mma_bf16_16816(out[nt], a[ks], b0, b1);
    }
  }
}

// acc[16 rows x 64 dh] += X (16 rows x 64, the f32 accumulators `x`, rounded to
// bf16) * tile (64 rows x 64 dh). The accumulators of n-tiles 2j, 2j+1 are, lane
// for lane, the A fragment of k-step j.
__device__ __forceinline__ void product_nn(float (*acc)[4], float (*x)[4],
                                           bf16 (*tile)[kDh + kPad], int g, int t) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t xa[4];
    xa[0] = pack_bf16(x[2 * j][0], x[2 * j][1]);
    xa[1] = pack_bf16(x[2 * j][2], x[2 * j][3]);
    xa[2] = pack_bf16(x[2 * j + 1][0], x[2 * j + 1][1]);
    xa[3] = pack_bf16(x[2 * j + 1][2], x[2 * j + 1][3]);
    const int kr = j * 16 + t * 2;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int d = nt * 8 + g;
      const uint32_t b0 = pack_bf16(tile[kr][d], tile[kr + 1][d]);
      const uint32_t b1 = pack_bf16(tile[kr + 8][d], tile[kr + 9][d]);
      mma_bf16_16816(acc[nt], xa, b0, b1);
    }
  }
}

// Write 16 rows x 64 lanes of f32 accumulators as bf16 at `dst` + row * stride,
// rows `row0` and `row0 + 8` of this thread, skipping rows >= S.
__device__ __forceinline__ void store_rows_bf16(bf16* dst, long stride, float (*acc)[4],
                                                int row0, int S, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    if (row >= S) continue;
    bf16* out = dst + (long)row * stride;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      *reinterpret_cast<uint32_t*>(out + nt * 8 + t * 2) =
          pack_bf16(acc[nt][2 * i], acc[nt][2 * i + 1]);
    }
  }
}

__global__ void __launch_bounds__(128)
flash3_bwd_dq_bf16_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, bf16* __restrict__ dqkv,
                          float* __restrict__ delta, int S, int D, int H, int causal) {
  __shared__ __align__(16) bf16 q_s[kTile][kDh + kPad];
  __shared__ __align__(16) bf16 do_s[kTile][kDh + kPad];
  __shared__ __align__(16) bf16 k_s[kTile][kDh + kPad];
  __shared__ __align__(16) bf16 v_s[kTile][kDh + kPad];

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long qkv_stride = 3L * D;
  const bf16* base = qkv + (long)b * S * qkv_stride;
  const bf16* dbase = dout + (long)b * S * D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group

  load_tile_bf16(q_s, base + h * kDh, qkv_stride, q0, S);
  load_tile_bf16(do_s, dbase + h * kDh, D, q0, S);
  __syncthreads();

  const int r_lo = warp * 16 + g;
  uint32_t qa[4][4], da[4][4];
  load_a_frags(qa, q_s, r_lo, t);
  load_a_frags(da, do_s, r_lo, t);
  const int row0 = q0 + r_lo;  // absolute q row of fragment rows g; g + 8 is row0 + 8
  float lse_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    lse_r[i] = row < S ? lse[((long)b * S + row) * H + h] : 0.f;
  }

  int n_tiles = (S + kTile - 1) / kTile;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kTile, S) - 1) / kTile + 1);

  // loop 1: c = sum over the row of p * dp
  float c[2] = {0.f, 0.f};
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile_bf16(k_s, base + D + h * kDh, qkv_stride, k0, S);
    load_tile_bf16(v_s, base + 2 * D + h * kDh, qkv_stride, k0, S);
    __syncthreads();
    float s[8][4], dp[8][4];
    product_nt(s, qa, k_s, g, t);
    product_nt(dp, da, v_s, g, t);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + t * 2 + (e & 1);
        const float p = replay_p(s[nt][e], row0 + (e >> 1) * 8, col, lse_r[e >> 1], S, causal);
        c[e >> 1] += p * dp[nt][e];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    c[i] += __shfl_xor_sync(0xffffffffu, c[i], 1);
    c[i] += __shfl_xor_sync(0xffffffffu, c[i], 2);
    const int row = row0 + i * 8;
    if (t == 0 && row < S) delta[((long)b * S + row) * H + h] = c[i];
  }

  // loop 2: ds = p * (dp - c), dq += ds k
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile_bf16(k_s, base + D + h * kDh, qkv_stride, k0, S);
    load_tile_bf16(v_s, base + 2 * D + h * kDh, qkv_stride, k0, S);
    __syncthreads();
    float s[8][4], dp[8][4];
    product_nt(s, qa, k_s, g, t);
    product_nt(dp, da, v_s, g, t);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + t * 2 + (e & 1);
        const float p = replay_p(s[nt][e], row0 + (e >> 1) * 8, col, lse_r[e >> 1], S, causal);
        s[nt][e] = p * (dp[nt][e] - c[e >> 1]);
      }
    }
    product_nn(acc, s, k_s, g, t);
  }
  store_rows_bf16(dqkv + (long)b * S * qkv_stride + h * kDh, qkv_stride, acc, row0, S, t);
}

__global__ void __launch_bounds__(128)
flash3_bwd_dkv_bf16_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           bf16* __restrict__ dqkv, int S, int D, int H, int causal) {
  __shared__ __align__(16) bf16 k_s[kTile][kDh + kPad];
  __shared__ __align__(16) bf16 v_s[kTile][kDh + kPad];
  __shared__ __align__(16) bf16 q_s[kTile][kDh + kPad];
  __shared__ __align__(16) bf16 do_s[kTile][kDh + kPad];
  __shared__ float lse_s[kTile];
  __shared__ float c_s[kTile];

  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long qkv_stride = 3L * D;
  const bf16* base = qkv + (long)b * S * qkv_stride;
  const bf16* dbase = dout + (long)b * S * D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  load_tile_bf16(k_s, base + D + h * kDh, qkv_stride, k0, S);
  load_tile_bf16(v_s, base + 2 * D + h * kDh, qkv_stride, k0, S);
  __syncthreads();
  const int r_lo = warp * 16 + g;
  uint32_t ka[4][4], va[4][4];
  load_a_frags(ka, k_s, r_lo, t);
  load_a_frags(va, v_s, r_lo, t);
  const int key0 = k0 + r_lo;  // absolute key of fragment rows g; g + 8 is key0 + 8

  float dk[8][4], dv[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    dk[nt][0] = dk[nt][1] = dk[nt][2] = dk[nt][3] = 0.f;
    dv[nt][0] = dv[nt][1] = dv[nt][2] = dv[nt][3] = 0.f;
  }

  const int n_tiles = (S + kTile - 1) / kTile;
  // causal: q tiles below this key tile see none of its keys
  for (int qt = causal ? blockIdx.x : 0; qt < n_tiles; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // every warp is done with the previous q/do tile
    load_tile_bf16(q_s, base + h * kDh, qkv_stride, q0, S);
    load_tile_bf16(do_s, dbase + h * kDh, D, q0, S);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      const long at = ((long)b * S + row) * H + h;
      lse_s[threadIdx.x] = row < S ? lse[at] : 0.f;
      c_s[threadIdx.x] = row < S ? delta[at] : 0.f;
    }
    __syncthreads();
    // transposed scores: rows are this warp's keys, columns the tile's q rows
    float st[8][4], dpt[8][4];
    product_nt(st, ka, q_s, g, t);
    product_nt(dpt, va, do_s, g, t);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = nt * 8 + t * 2 + (e & 1);
        const float p = replay_p(st[nt][e], q0 + qi, key0 + (e >> 1) * 8, lse_s[qi], S, causal);
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - c_s[qi]);
      }
    }
    product_nn(dv, st, do_s, g, t);   // dv += p^T do
    product_nn(dk, dpt, q_s, g, t);   // dk += ds^T q
  }
  bf16* out = dqkv + (long)b * S * qkv_stride;
  store_rows_bf16(out + D + h * kDh, qkv_stride, dk, key0, S, t);
  store_rows_bf16(out + 2 * D + h * kDh, qkv_stride, dv, key0, S, t);
}

// f32: two threads per row (or key). Thread `half` of a pair holds lanes
// 8m + 4*half .. 8m + 4*half + 3 for m = 0..7, so a pair reads 8 consecutive floats
// of a shared-memory row per step (no bank conflict).
__device__ __forceinline__ void load_half_row(float* r, const float* src, bool valid, int half) {
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (valid) v = *reinterpret_cast<const float4*>(src + 8 * m + 4 * half);
    r[4 * m] = v.x; r[4 * m + 1] = v.y; r[4 * m + 2] = v.z; r[4 * m + 3] = v.w;
  }
}

__device__ __forceinline__ void store_half_row(float* dst, const float* r, int half) {
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    *reinterpret_cast<float4*>(dst + 8 * m + 4 * half) =
        make_float4(r[4 * m], r[4 * m + 1], r[4 * m + 2], r[4 * m + 3]);
  }
}

// Dot product of this thread's half row with lanes of a shared-memory row,
// joined with the pair partner's half.
__device__ __forceinline__ float pair_dot(const float* r, const float* row_s, int half) {
  float acc = 0.f;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const float4 x = *reinterpret_cast<const float4*>(row_s + 8 * m + 4 * half);
    acc = fmaf(r[4 * m], x.x, acc);
    acc = fmaf(r[4 * m + 1], x.y, acc);
    acc = fmaf(r[4 * m + 2], x.z, acc);
    acc = fmaf(r[4 * m + 3], x.w, acc);
  }
  return acc + __shfl_xor_sync(0xffffffffu, acc, 1);
}

// r += w * (lanes of a shared-memory row)
__device__ __forceinline__ void pair_axpy(float* r, float w, const float* row_s, int half) {
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const float4 x = *reinterpret_cast<const float4*>(row_s + 8 * m + 4 * half);
    r[4 * m] = fmaf(w, x.x, r[4 * m]);
    r[4 * m + 1] = fmaf(w, x.y, r[4 * m + 1]);
    r[4 * m + 2] = fmaf(w, x.z, r[4 * m + 2]);
    r[4 * m + 3] = fmaf(w, x.w, r[4 * m + 3]);
  }
}

// Stage rows [row0, row0 + 32) of two 64-lane column slices (stride `stride`,
// offsets `off_a`, `off_b` into each row) in shared memory; rows past S are zero.
__device__ __forceinline__ void load_pair_f32(float (*a_s)[kDh], float (*b_s)[kDh],
                                              const float* src_a, long stride_a,
                                              const float* src_b, long stride_b,
                                              int row0, int S) {
  for (int i = threadIdx.x; i < kF32Tile * (kDh / 4); i += blockDim.x) {
    const int r = i / (kDh / 4);
    const int c = (i % (kDh / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
    if (row0 + r < S) {
      x = *reinterpret_cast<const float4*>(src_a + (long)(row0 + r) * stride_a + c);
      y = *reinterpret_cast<const float4*>(src_b + (long)(row0 + r) * stride_b + c);
    }
    *reinterpret_cast<float4*>(&a_s[r][c]) = x;
    *reinterpret_cast<float4*>(&b_s[r][c]) = y;
  }
}

__global__ void __launch_bounds__(128)
flash3_bwd_dq_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                         const float* __restrict__ lse, float* __restrict__ dqkv,
                         float* __restrict__ delta, int S, int D, int H, int causal) {
  __shared__ __align__(16) float k_s[kF32Tile][kDh];
  __shared__ __align__(16) float v_s[kF32Tile][kDh];

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long qkv_stride = 3L * D;
  const float* base = qkv + (long)b * S * qkv_stride;
  const float* dbase = dout + (long)b * S * D;
  const int half = threadIdx.x & 1;
  const int row = q0 + (threadIdx.x >> 1);
  const bool valid = row < S;

  float q[32], dov[32];
  load_half_row(q, base + (long)row * qkv_stride + h * kDh, valid, half);
  load_half_row(dov, dbase + (long)row * D + h * kDh, valid, half);
  const float lse_r = valid ? lse[((long)b * S + row) * H + h] : 0.f;

  int n_tiles = (S + kF32Tile - 1) / kF32Tile;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kTile, S) - 1) / kF32Tile + 1);

  float c = 0.f;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kF32Tile;
    __syncthreads();
    load_pair_f32(k_s, v_s, base + D + h * kDh, qkv_stride, base + 2 * D + h * kDh,
                  qkv_stride, k0, S);
    __syncthreads();
    for (int j = 0; j < kF32Tile; ++j) {
      const float s = pair_dot(q, k_s[j], half);
      const float dp = pair_dot(dov, v_s[j], half);
      c += replay_p(s, row, k0 + j, lse_r, S, causal) * dp;
    }
  }
  if (half == 0 && valid) delta[((long)b * S + row) * H + h] = c;

  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kF32Tile;
    __syncthreads();
    load_pair_f32(k_s, v_s, base + D + h * kDh, qkv_stride, base + 2 * D + h * kDh,
                  qkv_stride, k0, S);
    __syncthreads();
    for (int j = 0; j < kF32Tile; ++j) {
      const float s = pair_dot(q, k_s[j], half);
      const float dp = pair_dot(dov, v_s[j], half);
      const float p = replay_p(s, row, k0 + j, lse_r, S, causal);
      pair_axpy(dq, p * (dp - c), k_s[j], half);
    }
  }
  if (valid) store_half_row(dqkv + ((long)b * S + row) * qkv_stride + h * kDh, dq, half);
}

__global__ void __launch_bounds__(128)
flash3_bwd_dkv_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dqkv, int S, int D, int H, int causal) {
  __shared__ __align__(16) float q_s[kF32Tile][kDh];
  __shared__ __align__(16) float do_s[kF32Tile][kDh];
  __shared__ float lse_s[kF32Tile];
  __shared__ float c_s[kF32Tile];

  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long qkv_stride = 3L * D;
  const float* base = qkv + (long)b * S * qkv_stride;
  const float* dbase = dout + (long)b * S * D;
  const int half = threadIdx.x & 1;
  const int key = k0 + (threadIdx.x >> 1);
  const bool valid = key < S;

  float kk[32], vv[32], dk[32], dv[32];
  load_half_row(kk, base + (long)key * qkv_stride + D + h * kDh, valid, half);
  load_half_row(vv, base + (long)key * qkv_stride + 2 * D + h * kDh, valid, half);
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

  const int n_tiles = (S + kF32Tile - 1) / kF32Tile;
  // causal: q rows below k0 see none of this block's keys
  for (int qt = causal ? k0 / kF32Tile : 0; qt < n_tiles; ++qt) {
    const int q0 = qt * kF32Tile;
    __syncthreads();
    load_pair_f32(q_s, do_s, base + h * kDh, qkv_stride, dbase + h * kDh, D, q0, S);
    if (threadIdx.x < kF32Tile) {
      const int row = q0 + threadIdx.x;
      const long at = ((long)b * S + row) * H + h;
      lse_s[threadIdx.x] = row < S ? lse[at] : 0.f;
      c_s[threadIdx.x] = row < S ? delta[at] : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < kF32Tile; ++i) {
      const float s = pair_dot(kk, q_s[i], half);
      const float dp = pair_dot(vv, do_s[i], half);
      const float p = replay_p(s, q0 + i, key, lse_s[i], S, causal);
      pair_axpy(dv, p, do_s[i], half);
      pair_axpy(dk, p * (dp - c_s[i]), q_s[i], half);
    }
  }
  if (valid) {
    float* out = dqkv + ((long)b * S + key) * qkv_stride;
    store_half_row(out + D + h * kDh, dk, half);
    store_half_row(out + 2 * D + h * kDh, dv, half);
  }
}

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16. `delta` is
// float32 scratch [B, S, H] for the row sums c, allocated by the caller. Launches the
// dq pass and then the dk/dv pass on `stream`; returns the first launch error
// (cudaError_t, 0 on success).
extern "C" int flash3_bwd(const void* qkv, const void* dout, const void* lse, void* dqkv,
                          void* delta, int B, int S, int D, int H, int causal, int dtype,
                          void* stream) {
  if (H <= 0 || D != H * kDh || B <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    flash3_bwd_dq_bf16_kernel<<<grid, 128, 0, st>>>(
        static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<bf16*>(dqkv), static_cast<float*>(delta),
        S, D, H, causal);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    flash3_bwd_dkv_bf16_kernel<<<grid, 128, 0, st>>>(
        static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<bf16*>(dqkv), S, D, H, causal);
  } else if (dtype == 0) {
    flash3_bwd_dq_f32_kernel<<<grid, 128, 0, st>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<float*>(dqkv), static_cast<float*>(delta),
        S, D, H, causal);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    flash3_bwd_dkv_f32_kernel<<<grid, 128, 0, st>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dqkv), S, D, H, causal);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
