// Attention backward for Hopper (sm_90a): two bodies behind three entry points.
//
// It replaces three TPU kernels of vit_project_tpu/ops/attention.py:
//   - `flash3_bwd` replaces `_flash3_bwd_kernel` (with `_attn_bwd_head` and
//     `_attn_masks`), the backward of `flash_mha_packed_qkv`: packed qkv [B, S, 3D]
//     (q prescaled), do [B, S, D] and the forward's lse [B, S, H] in; one packed dqkv
//     [B, S, 3D] out, dq, dk and dv at the lanes of q, k and v.
//   - `flash_bwd` replaces `_flash_bwd_kernel`, the backward of `flash_mha_packed`: the
//     same math on three [B, S, D] tensors and do; dq, dk, dv [B, S, D] each.
//   - `mha_bwd` replaces `_mha_bwd_kernel` (`_mha_bwd_pallas`), the backward of
//     `attention_core(_bshd)` with `use_pallas=True`: q, k, v, do as [B, H, S, dh]
//     views; no lse comes from the forward.
// Each operand is a [B, H, S, 64] view given by a batch, head and row stride
// (attention.cuh): no split, no transpose, no copy.
//
// `flash3_bwd` and `flash_bwd` compute, per head and in `_attn_bwd_head`'s order:
//   s  = q k^T (q already scaled), masked: keys >= S, and with `causal` every key past
//        the row, get p = 0 (the TPU kernel's exp(-1e30 - lse));
//   p  = exp(s - lse), replaying the forward's float32 row log-sum-exp;
//   dv = p^T do, with p rounded to the working type first;
//   dp = do v^T in float32;
//   c  = sum_j p * dp over the whole row, in float32 (from p and dp, not from o);
//   ds = p * (dp - c), rounded to the working type;
//   dq = ds k and dk = ds^T q, accumulated in float32.
// `mha_bwd` computes `_mha_bwd_kernel`'s math: s = (q k^T) / sqrt(dh) in float32; the
// row max and sum of the softmax recomputed (lse = m + log l, so p = exp(s - lse) is
// e / sum e up to float32 rounding); then dv, dp, c and ds as above but ALL in
// float32, even for bf16 operands: p and ds are never rounded; dq = ds k / sqrt(dh)
// and dk = ds^T q / sqrt(dh); the outputs are rounded to the operands' type.
//
// Design. The TPU kernels hold a whole head tile in VMEM and need no sum carried
// between grid steps. Hopper blocks run in no order, so the work is two passes, and no
// float atomics anywhere (gradients stay bit-identical run to run, which the bit-exact
// resume of the training loop relies on):
//   1. dq pass, grid (64-row q tile, head, batch): `mha_bwd` first forms the row max
//      and sum over the 32-key tiles and writes lse to a float32 scratch [B, S, H];
//      then a loop over the k/v tiles forms c for its rows (written to a float32
//      scratch `delta` [B, S, H]); a last loop forms ds and accumulates dq in registers.
//   2. dk/dv pass, grid (64-key tile, head, batch), launched after the first on the
//      same stream: a loop over the q tiles (reading their lse and c) accumulates dk
//      and dv for its keys in registers. The bf16 route works on the transposed scores
//      s^T = k q^T, so each warp owns 16 keys and p^T, ds^T stay in registers.
// A causal block skips every tile that lies wholly above the diagonal. Rows and keys
// past S read as zero and are never written. dh is fixed at 64.
//   - bf16, `flash3_bwd` and `flash_bwd`: 4 warps of 16 rows (or keys) each; every
//     product runs on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
//     accumulate). Score accumulators are re-packed in registers as the A operand of
//     the next product.
//   - f32, and `mha_bwd` in both types (the "FMA route"): two threads share a row (or
//     key), each holding 32 of its 64 lanes widened to float32, and compute every
//     product with FMAs from shared memory (dot products joined with one shuffle). The
//     tensor cores have no exact f32 product, and `mha_bwd` multiplies float32 p and
//     ds, so the bf16 mma route (which rounds them) is not used there.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s dense bf16, 67 TFLOP/s f32; NVIDIA's
// data sheet): at the training step's image shape, qkv [64, 257, 3072] bf16 with H =
// 16, `flash3_bwd` must read qkv, do and lse (136 MB) and write dqkv (101 MB): 237 MB,
// 0.07 ms, against five products over the 67.6 M kept (row, key, head) pairs, 43
// GFLOP, 0.04 ms. It is bound by bytes. `mha_bwd` runs three of its five products on
// float32 p or ds, 26 GFLOP at 67 TFLOP/s: 0.39 ms, bound by operations. This design
// reads each q, k, v, do tile once per tile pair (from L2 mostly) and does nine
// products per pair, not five: c and the scores are recomputed in each pass instead
// of going through device memory. Speed is left to later work (wgmma, TMA, one fused
// pass).

#include <math.h>

#include "attention.cuh"

namespace {

using namespace attn;

constexpr int kTile = 64;     // q rows of a dq block, keys of a dk/dv block, loop tiles
constexpr int kF32Tile = 32;  // loop tile of the FMA route

template <typename T>
struct BwdArgs {
  const T* q;
  const T* k;
  const T* v;
  const T* dout;
  T* dq;
  T* dk;
  T* dv;
  float* lse;    // [B, S, H]: the forward's, or (mha_bwd) written by the dq pass
  float* delta;  // [B, S, H] scratch: the row sums c, written by the dq pass
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
  int S, H, causal;
  float scale;   // mha_bwd: 1/sqrt(dh) on the scores and on dq, dk
};

// p of one score: exp(s - lse) where (row, col) is kept, else exactly 0.
__device__ __forceinline__ float replay_p(float s, int row, int col, float lse, int S,
                                          int causal) {
  const bool ok = row < S && col < S && (!causal || col <= row);
  return ok ? expf(s - lse) : 0.f;
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
__device__ __forceinline__ void store_rows_bf16(bf16* dst, long long stride, float (*acc)[4],
                                                int row0, int S, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    if (row >= S) continue;
    bf16* out = dst + row * stride;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      *reinterpret_cast<uint32_t*>(out + nt * 8 + t * 2) =
          pack_bf16(acc[nt][2 * i], acc[nt][2 * i + 1]);
    }
  }
}

__global__ void __launch_bounds__(128) attn_bwd_dq_bf16_kernel(const BwdArgs<bf16> a) {
  __shared__ __align__(16) bf16 q_s[kTile][kDh + kPad];
  __shared__ __align__(16) bf16 do_s[kTile][kDh + kPad];
  __shared__ __align__(16) bf16 k_s[kTile][kDh + kPad];
  __shared__ __align__(16) bf16 v_s[kTile][kDh + kPad];

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int S = a.S;
  const int causal = a.causal;
  const bf16* kh = head_base(a.k, a.sk, b, h);
  const bf16* vh = head_base(a.v, a.sv, b, h);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group

  load_tile_bf16<128>(q_s, head_base(a.q, a.sq, b, h), a.sq.s, q0, S);
  load_tile_bf16<128>(do_s, head_base(a.dout, a.sdo, b, h), a.sdo.s, q0, S);
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
    lse_r[i] = row < S ? a.lse[((long long)b * S + row) * a.H + h] : 0.f;
  }

  int n_tiles = (S + kTile - 1) / kTile;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kTile, S) - 1) / kTile + 1);

  // loop 1: c = sum over the row of p * dp
  float c[2] = {0.f, 0.f};
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile_bf16<128>(k_s, kh, a.sk.s, k0, S);
    load_tile_bf16<128>(v_s, vh, a.sv.s, k0, S);
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
    if (t == 0 && row < S) a.delta[((long long)b * S + row) * a.H + h] = c[i];
  }

  // loop 2: ds = p * (dp - c), dq += ds k
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile_bf16<128>(k_s, kh, a.sk.s, k0, S);
    load_tile_bf16<128>(v_s, vh, a.sv.s, k0, S);
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
  store_rows_bf16(head_base(a.dq, a.sdq, b, h), a.sdq.s, acc, row0, S, t);
}

__global__ void __launch_bounds__(128) attn_bwd_dkv_bf16_kernel(const BwdArgs<bf16> a) {
  __shared__ __align__(16) bf16 k_s[kTile][kDh + kPad];
  __shared__ __align__(16) bf16 v_s[kTile][kDh + kPad];
  __shared__ __align__(16) bf16 q_s[kTile][kDh + kPad];
  __shared__ __align__(16) bf16 do_s[kTile][kDh + kPad];
  __shared__ float lse_s[kTile];
  __shared__ float c_s[kTile];

  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int S = a.S;
  const int causal = a.causal;
  const bf16* qh = head_base(a.q, a.sq, b, h);
  const bf16* doh = head_base(a.dout, a.sdo, b, h);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  load_tile_bf16<128>(k_s, head_base(a.k, a.sk, b, h), a.sk.s, k0, S);
  load_tile_bf16<128>(v_s, head_base(a.v, a.sv, b, h), a.sv.s, k0, S);
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
    load_tile_bf16<128>(q_s, qh, a.sq.s, q0, S);
    load_tile_bf16<128>(do_s, doh, a.sdo.s, q0, S);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      const long long at = ((long long)b * S + row) * a.H + h;
      lse_s[threadIdx.x] = row < S ? a.lse[at] : 0.f;
      c_s[threadIdx.x] = row < S ? a.delta[at] : 0.f;
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
  store_rows_bf16(head_base(a.dk, a.sdk, b, h), a.sdk.s, dk, key0, S, t);
  store_rows_bf16(head_base(a.dv, a.sdv, b, h), a.sdv.s, dv, key0, S, t);
}

// FMA route: two threads per row (or key). Thread `half` of a pair holds lanes
// 8m + 4*half .. 8m + 4*half + 3 for m = 0..7, so a pair reads 8 consecutive floats
// of a shared-memory row per step (no bank conflict).
template <typename T>
__device__ __forceinline__ void load_half_row(float* r, const T* src, bool valid, int half) {
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (valid) v = load4(src + 8 * m + 4 * half);
    r[4 * m] = v.x; r[4 * m + 1] = v.y; r[4 * m + 2] = v.z; r[4 * m + 3] = v.w;
  }
}

template <typename T>
__device__ __forceinline__ void store_half_row(T* dst, const float* r, int half) {
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    store4(dst + 8 * m + 4 * half, make_float4(r[4 * m], r[4 * m + 1], r[4 * m + 2], r[4 * m + 3]));
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

// Stage rows [row0, row0 + 32) of one head (64 lanes, `stride` elements apart) in
// shared memory as float32; rows past S are zero. The FMA kernels run 128 threads.
template <typename T>
__device__ __forceinline__ void load_rows_f32(float (*dst)[kDh], const T* src, long long stride,
                                              int row0, int S) {
  for (int i = threadIdx.x; i < kF32Tile * (kDh / 4); i += 128) {
    const int r = i / (kDh / 4);
    const int c = (i % (kDh / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S) x = load4(src + (row0 + r) * stride + c);
    *reinterpret_cast<float4*>(&dst[r][c]) = x;
  }
}

// The same rows of two heads at once (k and v, or q and do), their loads interleaved.
template <typename T>
__device__ __forceinline__ void load_pair_f32(float (*a_s)[kDh], float (*b_s)[kDh],
                                              const T* src_a, long long stride_a,
                                              const T* src_b, long long stride_b,
                                              int row0, int S) {
  for (int i = threadIdx.x; i < kF32Tile * (kDh / 4); i += 128) {
    const int r = i / (kDh / 4);
    const int c = (i % (kDh / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
    if (row0 + r < S) {
      x = load4(src_a + (row0 + r) * stride_a + c);
      y = load4(src_b + (row0 + r) * stride_b + c);
    }
    *reinterpret_cast<float4*>(&a_s[r][c]) = x;
    *reinterpret_cast<float4*>(&b_s[r][c]) = y;
  }
}

// kMha: `mha_bwd` (scores scaled by a.scale, row statistics recomputed here, dq
// scaled at the end); otherwise the forward's lse is replayed and nothing is scaled.
template <typename T, bool kMha>
__global__ void __launch_bounds__(128) attn_bwd_dq_fma_kernel(const BwdArgs<T> a) {
  __shared__ __align__(16) float k_s[kF32Tile][kDh];
  __shared__ __align__(16) float v_s[kF32Tile][kDh];

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int S = a.S;
  const int causal = a.causal;
  const T* kh = head_base(a.k, a.sk, b, h);
  const T* vh = head_base(a.v, a.sv, b, h);
  const int half = threadIdx.x & 1;
  const int row = q0 + (threadIdx.x >> 1);
  const bool valid = row < S;
  const long long at = ((long long)b * S + row) * a.H + h;

  float q[32], dov[32];
  load_half_row(q, head_base(a.q, a.sq, b, h) + row * a.sq.s, valid, half);
  load_half_row(dov, head_base(a.dout, a.sdo, b, h) + row * a.sdo.s, valid, half);

  int n_tiles = (S + kF32Tile - 1) / kF32Tile;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kTile, S) - 1) / kF32Tile + 1);

  float lse_r;
  if (kMha) {
    // loop 0: the row's softmax max and sum (the forward saved no statistics)
    float m = -INFINITY, l = 0.f;
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int k0 = kt * kF32Tile;
      __syncthreads();
      load_rows_f32(k_s, kh, a.sk.s, k0, S);
      __syncthreads();
      float s[kF32Tile];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kF32Tile; ++j) {
        const float dot = pair_dot(q, k_s[j], half);  // a warp shuffle: every lane runs it
        const int col = k0 + j;
        const bool ok = col < S && (!causal || col <= row);
        s[j] = ok ? dot * a.scale : -INFINITY;
        mx = fmaxf(mx, s[j]);
      }
      // every row sees key 0 in tile 0, so m_new is finite from the first tile on
      const float m_new = fmaxf(m, mx);
      l *= expf(m - m_new);
      m = m_new;
#pragma unroll
      for (int j = 0; j < kF32Tile; ++j) l += expf(s[j] - m);
    }
    lse_r = valid ? m + logf(l) : 0.f;
    if (half == 0 && valid) a.lse[at] = lse_r;
  } else {
    lse_r = valid ? a.lse[at] : 0.f;
  }

  // loop 1: c = sum over the row of p * dp
  float c = 0.f;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kF32Tile;
    __syncthreads();
    load_pair_f32(k_s, v_s, kh, a.sk.s, vh, a.sv.s, k0, S);
    __syncthreads();
    for (int j = 0; j < kF32Tile; ++j) {
      float s = pair_dot(q, k_s[j], half);
      if (kMha) s *= a.scale;
      const float dp = pair_dot(dov, v_s[j], half);
      c += replay_p(s, row, k0 + j, lse_r, S, causal) * dp;
    }
  }
  if (half == 0 && valid) a.delta[at] = c;

  // loop 2: ds = p * (dp - c), dq += ds k
  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kF32Tile;
    __syncthreads();
    load_pair_f32(k_s, v_s, kh, a.sk.s, vh, a.sv.s, k0, S);
    __syncthreads();
    for (int j = 0; j < kF32Tile; ++j) {
      float s = pair_dot(q, k_s[j], half);
      if (kMha) s *= a.scale;
      const float dp = pair_dot(dov, v_s[j], half);
      const float p = replay_p(s, row, k0 + j, lse_r, S, causal);
      pair_axpy(dq, p * (dp - c), k_s[j], half);
    }
  }
  if (kMha) {
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[i] *= a.scale;
  }
  if (valid) store_half_row(head_base(a.dq, a.sdq, b, h) + row * a.sdq.s, dq, half);
}

template <typename T, bool kMha>
__global__ void __launch_bounds__(128) attn_bwd_dkv_fma_kernel(const BwdArgs<T> a) {
  __shared__ __align__(16) float q_s[kF32Tile][kDh];
  __shared__ __align__(16) float do_s[kF32Tile][kDh];
  __shared__ float lse_s[kF32Tile];
  __shared__ float c_s[kF32Tile];

  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int S = a.S;
  const int causal = a.causal;
  const T* qh = head_base(a.q, a.sq, b, h);
  const T* doh = head_base(a.dout, a.sdo, b, h);
  const int half = threadIdx.x & 1;
  const int key = k0 + (threadIdx.x >> 1);
  const bool valid = key < S;

  float kk[32], vv[32], dk[32], dv[32];
  load_half_row(kk, head_base(a.k, a.sk, b, h) + key * a.sk.s, valid, half);
  load_half_row(vv, head_base(a.v, a.sv, b, h) + key * a.sv.s, valid, half);
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

  const int n_tiles = (S + kF32Tile - 1) / kF32Tile;
  // causal: q rows below k0 see none of this block's keys
  for (int qt = causal ? k0 / kF32Tile : 0; qt < n_tiles; ++qt) {
    const int q0 = qt * kF32Tile;
    __syncthreads();
    load_pair_f32(q_s, do_s, qh, a.sq.s, doh, a.sdo.s, q0, S);
    if (threadIdx.x < kF32Tile) {
      const int row = q0 + threadIdx.x;
      const long long at = ((long long)b * S + row) * a.H + h;
      lse_s[threadIdx.x] = row < S ? a.lse[at] : 0.f;
      c_s[threadIdx.x] = row < S ? a.delta[at] : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < kF32Tile; ++i) {
      float s = pair_dot(kk, q_s[i], half);
      if (kMha) s *= a.scale;
      const float dp = pair_dot(vv, do_s[i], half);
      const float p = replay_p(s, q0 + i, key, lse_s[i], S, causal);
      pair_axpy(dv, p, do_s[i], half);
      pair_axpy(dk, p * (dp - c_s[i]), q_s[i], half);
    }
  }
  if (valid) {
    if (kMha) {
#pragma unroll
      for (int i = 0; i < 32; ++i) dk[i] *= a.scale;
    }
    store_half_row(head_base(a.dk, a.sdk, b, h) + key * a.sdk.s, dk, half);
    store_half_row(head_base(a.dv, a.sdv, b, h) + key * a.sdv.s, dv, half);
  }
}

template <typename T, bool kMha>
int launch_fma(const BwdArgs<T>& a, dim3 grid, cudaStream_t cs) {
  attn_bwd_dq_fma_kernel<T, kMha><<<grid, 128, 0, cs>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkv_fma_kernel<T, kMha><<<grid, 128, 0, cs>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
BwdArgs<T> bwd_args(const void* const* p, float* lse, float* delta, const Strides* st,
                    int S, int H, int causal, float scale) {
  return BwdArgs<T>{static_cast<const T*>(p[0]), static_cast<const T*>(p[1]),
                    static_cast<const T*>(p[2]), static_cast<const T*>(p[3]),
                    static_cast<T*>(const_cast<void*>(p[4])),
                    static_cast<T*>(const_cast<void*>(p[5])),
                    static_cast<T*>(const_cast<void*>(p[6])), lse, delta,
                    st[0], st[1], st[2], st[3], st[4], st[5], st[6], S, H, causal, scale};
}

// Launch the dq pass and then the dk/dv pass on `stream`. p: q, k, v, do, dq, dk, dv;
// st: their strides in that order; lse and delta [B, S, H] float32. `mha` selects
// mha_bwd's math. dtype: 0 = float32, 1 = bfloat16. Returns the first launch error
// (cudaError_t, 0 on success).
int launch_bwd(const void* const* p, float* lse, float* delta, const Strides* st, int B,
               int S, int H, int causal, int dtype, bool mha, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  cudaStream_t cs = reinterpret_cast<cudaStream_t>(stream);
  const float scale = mha ? 1.f / sqrtf((float)kDh) : 1.f;
  if (dtype == 1 && !mha) {
    const BwdArgs<bf16> a = bwd_args<bf16>(p, lse, delta, st, S, H, causal, scale);
    attn_bwd_dq_bf16_kernel<<<grid, 128, 0, cs>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    attn_bwd_dkv_bf16_kernel<<<grid, 128, 0, cs>>>(a);
    return (int)cudaGetLastError();
  }
  if (dtype == 1) {
    return launch_fma<bf16, true>(bwd_args<bf16>(p, lse, delta, st, S, H, causal, scale),
                                  grid, cs);
  }
  if (dtype == 0) {
    const BwdArgs<float> a = bwd_args<float>(p, lse, delta, st, S, H, causal, scale);
    return mha ? launch_fma<float, true>(a, grid, cs) : launch_fma<float, false>(a, grid, cs);
  }
  return (int)cudaErrorInvalidValue;
}

Strides strides_at(const long long* s, int i) { return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

int launch_strided(const void* const* ptrs, const long long* strides, int B, int S, int H,
                   int causal, int dtype, bool mha, void* stream) {
  Strides st[7];
  for (int i = 0; i < 7; ++i) st[i] = strides_at(strides, i);
  const void* p[7] = {ptrs[0], ptrs[1], ptrs[2], ptrs[3], ptrs[4], ptrs[5], ptrs[6]};
  return launch_bwd(p, static_cast<float*>(const_cast<void*>(ptrs[7])),
                    static_cast<float*>(const_cast<void*>(ptrs[8])), st, B, S, H, causal,
                    dtype, mha, stream);
}

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16. `delta` (and for
// mha_bwd `lse`) is float32 scratch [B, S, H] allocated by the caller. Each entry
// launches the dq pass and then the dk/dv pass on `stream` and returns the first launch
// error (cudaError_t, 0 on success).

// Packed qkv [B, S, 3D], do [B, S, D], lse [B, S, H] -> packed dqkv [B, S, 3D].
extern "C" int flash3_bwd(const void* qkv, const void* dout, const void* lse, void* dqkv,
                          void* delta, int B, int S, int D, int H, int causal, int dtype,
                          void* stream) {
  if (H <= 0 || D != H * kDh || B <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const long long lane_bytes = dtype == 1 ? 2 : 4;
  const char* in = static_cast<const char*>(qkv);
  const char* out = static_cast<const char*>(dqkv);
  const Strides packed{(long long)S * 3 * D, kDh, 3LL * D};
  const Strides rows{(long long)S * D, kDh, D};
  const Strides st[7] = {packed, packed, packed, rows, packed, packed, packed};
  const void* p[7] = {in, in + D * lane_bytes, in + 2 * D * lane_bytes, dout,
                      out, out + D * lane_bytes, out + 2 * D * lane_bytes};
  return launch_bwd(p, static_cast<float*>(const_cast<void*>(lse)),
                    static_cast<float*>(delta), st, B, S, H, causal, dtype, false, stream);
}

// ptrs: q (prescaled), k, v, do, dq, dk, dv, lse (the forward's), delta; strides:
// (batch, head, row) of q, k, v, do, dq, dk, dv.
extern "C" int flash_bwd(const void* const* ptrs, const long long* strides, int B, int S,
                         int H, int causal, int dtype, void* stream) {
  return launch_strided(ptrs, strides, B, S, H, causal, dtype, false, stream);
}

// ptrs: q, k, v, do, dq, dk, dv, lse (scratch, written here), delta; strides as
// flash_bwd's. The scores are scaled by 1/sqrt(dh); every product after them is float32.
extern "C" int mha_bwd(const void* const* ptrs, const long long* strides, int B, int S,
                       int H, int causal, int dtype, void* stream) {
  return launch_strided(ptrs, strides, B, S, H, causal, dtype, true, stream);
}
