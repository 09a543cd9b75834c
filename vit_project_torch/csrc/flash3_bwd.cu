// Attention backward for Hopper (sm_90a): three routes behind three entry points.
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
// No route uses float atomics: gradients are bit-identical run to run, which the
// bit-exact resume of the training loop relies on. dh is fixed at 64.
//
// 1. bf16 with S <= kWholeHeadMaxS, all three entries, the "whole-head" route:
//    ONE launch, one block per (head, batch), as the TPU kernel holds a whole head in
//    VMEM. The block copies q, k, v and do of its head into shared
//    memory with cp.async (rows padded to a multiple of 16 with zeros, 128-byte rows
//    under an XOR swizzle of their 16-byte chunks, so every ldmatrix is free of bank
//    conflicts; attention.cuh) and the head's lse beside them, then
//      phase A, warps own 16-row blocks: a sweep over the key tiles forms s and dp
//        and c (to shared memory, for phase B); a second sweep forms ds and
//        accumulates dq = ds k in registers, written once;
//      phase B, after one barrier, warps own 16-key blocks: a sweep over the row
//        tiles forms s^T and dp^T, p^T and ds^T in registers, and accumulates
//        dv += p^T do and dk += ds^T q, written once.
//    Nine products per 16x16 (row, key) tile pair. Every product runs on the tensor
//    cores as mma.sync m16n8k16 (bf16 in, f32 accumulate); every operand fragment
//    comes from ldmatrix (ldmatrix.trans where the product contracts over the rows of
//    a stored tile: dq over k's rows, dv over do's, dk over q's), or from the
//    accumulators of the previous product re-packed in registers (p, ds). Each warp
//    sums its own rows (or keys) in a fixed order, so no partial sum crosses warps.
//    p = exp(s - lse) comes from the special function unit (ex2.approx). Padding to
//    16 (not 64) leaves S = 197 at 208 rows and S = 257 at 272. Shared memory is 520
//    bytes a row: two blocks of 8 warps fit an SM up to 216 rows (ViT-B/16), one block
//    (of 12 warps) up to 432.
//    `mha_bwd` (the template flag kMha) differs in three places. No lse comes in:
//    phase A first sweeps its key tiles once more for s alone (scaled by 1/8, exact)
//    and forms each row's max and sum online in float32; the row's lse, in the log2
//    domain, goes to the same shared array the flash entries load theirs into. p and
//    ds stay float32, and each of the three products that takes them (dv += p^T do,
//    dq += ds k, dk += ds^T q) runs as two bf16 products on hi = bf16(x) and
//    lo = bf16(x - hi), into one float32 accumulator: both are exact, as do, k and q
//    are bf16 already, and hi + lo is x to 2^-16 of |x| (the tensor cores' TF32 rate,
//    not a rounding of p or ds to bf16). dq and dk are scaled by 1/8 at the end.
//    Thirteen products per tile pair. Two blocks of 8 warps at 128 registers and one
//    of 12 at 157 build without a spill (ptxas), so mha_bwd takes the flash shapes.
// 2. bf16 `flash3_bwd` / `flash_bwd` with S > kWholeHeadMaxS, the "streamed" route:
//    two passes, 4 warps of 16 rows (or keys) each; tiles of 64 rows stream through
//    two shared-memory stages with cp.async (tile i + 1 in flight while tile i is
//    multiplied), and mma.sync takes the transposed operands from ldmatrix.trans:
//      dq pass, grid (64-row q tile, head, batch): a loop over the k/v tiles forms c
//        for its rows (to a float32 scratch `delta` [B, S, H]); a last loop forms ds
//        and accumulates dq in registers;
//      dk/dv pass, grid (64-key tile, head, batch), launched after the first on the
//        same stream: a loop over the q tiles (reading their lse and c) accumulates
//        dk and dv on the transposed scores s^T = k q^T.
// 3. float32, and bf16 `mha_bwd` with S > kWholeHeadMaxS (the "FMA route"): the two
//    passes of route 2
//    (`mha_bwd` first forms the row max and sum over the 32-key tiles and writes lse
//    to a float32 scratch [B, S, H]), with two threads sharing a row (or key), each
//    holding 32 of its 64 lanes widened to float32, and every product computed with
//    FMAs from shared memory (dot products joined with one shuffle): the tensor cores
//    have no exact f32 product.
// A causal block skips every tile that lies wholly above the diagonal. Rows and keys
// past S read as zero and are never written.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s dense bf16, 67 TFLOP/s f32; NVIDIA's
// data sheet): at the ViT-B/16 step's shape, qkv [256, 197, 2304] bf16 with H = 12,
// `flash3_bwd` must read qkv, do and lse (315 MB) and write dqkv (232 MB): 0.16 ms,
// against five products over the 119 M (row, key, head) pairs, 76 GFLOP, 0.08 ms. It
// is bound by bytes. The whole-head route reads each operand from device memory once
// and writes each gradient once, so its bytes are the bound's; what it adds is
// arithmetic (nine products, not five, over padded tiles) and the latency of one
// block's load before its products start, which a second block on the SM hides where
// two fit.
// `mha_bwd` in bf16 reads q, k, v and do and writes dq, dk and dv, 7 B S D 2 bytes
// (542 MB at ViT-B/16: 0.16 ms), against two bf16 products and three at the TF32 rate
// that its split runs at (0.12 ms): it is bound by bytes, and the whole-head route
// moves that many.

#include <math.h>

#include "attention.cuh"

namespace {

using namespace attn;

constexpr int kTile = 64;     // streamed and FMA routes: rows of a dq block, keys of a
                              // dk/dv block, loop tiles
constexpr int kF32Tile = 32;  // loop tile of the FMA route
constexpr int kWholeHeadMaxS = 432;  // the whole-head route takes S up to this

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

constexpr float kLog2e = 1.4426950408889634f;

// replay_p for the whole-head route: p = 2^(s s2 - lse2), where s2 = scale log2 e and
// lse2 = lse log2 e, from the special function unit (ex2.approx: relative error
// ~2^-22, against the 2^-9 of the bf16 rounding that p and ds then take in the flash
// entries; expf's exact range reduction was the route's largest single cost).
__device__ __forceinline__ float head_p(float s, int row, int col, float lse2, int S,
                                        int causal, float s2) {
  const float e = ex2(fmaf(s, s2, -lse2));
  const bool ok = row < S && col < S && (!causal || col <= row);
  return ok ? e : 0.f;
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
// for lane, the A fragment of k-step j; the tile's fragments come from ldmatrix.trans.
__device__ __forceinline__ void product_nn(float (*acc)[4], float (*x)[4],
                                           bf16 (*tile)[kDh + kPad], const LaneOffsets& lo) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t xa[4];
    xa[0] = pack_bf16(x[2 * j][0], x[2 * j][1]);
    xa[1] = pack_bf16(x[2 * j][2], x[2 * j][3]);
    xa[2] = pack_bf16(x[2 * j + 1][0], x[2 * j + 1][1]);
    xa[3] = pack_bf16(x[2 * j + 1][2], x[2 * j + 1][3]);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bb[4];
      ldsm_x4_trans(bb, smem_addr(&tile[j * 16 + lo.k_row][np * 16 + lo.k_chk * 8]));
      mma_bf16_16816(acc[2 * np], xa, bb[0], bb[1]);
      mma_bf16_16816(acc[2 * np + 1], xa, bb[2], bb[3]);
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

// Rows [row0, row0 + 64) of one head into a padded tile with cp.async (128 threads,
// 16 bytes each); rows past S are zero. The caller commits and waits.
__device__ __forceinline__ void load_tile_async(bf16 (*dst)[kDh + kPad], const bf16* src,
                                                long long stride, int row0, int S) {
  for (int i = threadIdx.x; i < kTile * (kDh / 8); i += 128) {
    const int r = i / (kDh / 8);
    const int c = (i % (kDh / 8)) * 8;
    const bool ok = row0 + r < S;
    cp_async_16(smem_addr(&dst[r][c]), ok ? src + (row0 + r) * stride + c : src, ok);
  }
}

// Streamed route, dq pass. The k/v tiles stream through two stages: tile i + 1 is in
// flight while tile i is multiplied. Iterations 0..n-1 form c, n..2n-1 form dq, both
// over the same n tiles. q and do pass through stage 1 on their way to registers.
__global__ void __launch_bounds__(128) attn_bwd_dq_bf16_kernel(const BwdArgs<bf16> a) {
  __shared__ __align__(16) bf16 kv_s[2][2][kTile][kDh + kPad];  // [stage][k, v]

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
  const LaneOffsets lo(lane);

  int n_tiles = (S + kTile - 1) / kTile;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kTile, S) - 1) / kTile + 1);

  load_tile_async(kv_s[1][0], head_base(a.q, a.sq, b, h), a.sq.s, q0, S);
  load_tile_async(kv_s[1][1], head_base(a.dout, a.sdo, b, h), a.sdo.s, q0, S);
  cp_async_commit();
  load_tile_async(kv_s[0][0], kh, a.sk.s, 0, S);
  load_tile_async(kv_s[0][1], vh, a.sv.s, 0, S);
  cp_async_commit();
  cp_async_wait(true);
  __syncthreads();

  const int r_lo = warp * 16 + g;
  uint32_t qa[4][4], da[4][4];
  load_a_frags(qa, kv_s[1][0], r_lo, t);
  load_a_frags(da, kv_s[1][1], r_lo, t);
  __syncthreads();  // stage 1 is free for the next tile
  const int row0 = q0 + r_lo;  // absolute q row of fragment rows g; g + 8 is row0 + 8
  float lse_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    lse_r[i] = row < S ? a.lse[((long long)b * S + row) * a.H + h] : 0.f;
  }

  float c[2] = {0.f, 0.f};
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  for (int it = 0; it < 2 * n_tiles; ++it) {
    const bool more = it + 1 < 2 * n_tiles;
    if (more) {
      const int nk0 = ((it + 1) % n_tiles) * kTile;
      load_tile_async(kv_s[(it + 1) & 1][0], kh, a.sk.s, nk0, S);
      load_tile_async(kv_s[(it + 1) & 1][1], vh, a.sv.s, nk0, S);
      cp_async_commit();
    }
    cp_async_wait(more);
    __syncthreads();
    bf16 (*k_s)[kDh + kPad] = kv_s[it & 1][0];
    bf16 (*v_s)[kDh + kPad] = kv_s[it & 1][1];
    const int k0 = (it % n_tiles) * kTile;
    if (it == n_tiles) {
      // c = sum over the row of p * dp is complete
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        c[i] += __shfl_xor_sync(0xffffffffu, c[i], 1);
        c[i] += __shfl_xor_sync(0xffffffffu, c[i], 2);
        const int row = row0 + i * 8;
        if (t == 0 && row < S) a.delta[((long long)b * S + row) * a.H + h] = c[i];
      }
    }
    float s[8][4], dp[8][4];
    product_nt(s, qa, k_s, g, t);
    product_nt(dp, da, v_s, g, t);
    if (it < n_tiles) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + nt * 8 + t * 2 + (e & 1);
          const float p = replay_p(s[nt][e], row0 + (e >> 1) * 8, col, lse_r[e >> 1], S, causal);
          c[e >> 1] += p * dp[nt][e];
        }
      }
    } else {
      // ds = p * (dp - c), dq += ds k
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + nt * 8 + t * 2 + (e & 1);
          const float p = replay_p(s[nt][e], row0 + (e >> 1) * 8, col, lse_r[e >> 1], S, causal);
          s[nt][e] = p * (dp[nt][e] - c[e >> 1]);
        }
      }
      product_nn(acc, s, k_s, lo);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  store_rows_bf16(head_base(a.dq, a.sdq, b, h), a.sdq.s, acc, row0, S, t);
}

// Streamed route, dk/dv pass: the q/do tiles (with their lse and c) stream through two
// stages; k and v pass through stage 1 on their way to registers.
__global__ void __launch_bounds__(128) attn_bwd_dkv_bf16_kernel(const BwdArgs<bf16> a) {
  __shared__ __align__(16) bf16 qd_s[2][2][kTile][kDh + kPad];  // [stage][q, do]
  __shared__ float lse_s[2][kTile];
  __shared__ float c_s[2][kTile];

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
  const LaneOffsets lo(lane);

  const int n_tiles = (S + kTile - 1) / kTile;
  // causal: q tiles below this key tile see none of its keys
  const int qt0 = causal ? blockIdx.x : 0;

  // lse and c of the q tile at q0 into stage `st` (plain loads; the barrier that
  // makes the stage's tiles visible covers them too)
  auto load_stats = [&](int st, int q0) {
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      const long long at = ((long long)b * S + row) * a.H + h;
      lse_s[st][threadIdx.x] = row < S ? a.lse[at] : 0.f;
      c_s[st][threadIdx.x] = row < S ? a.delta[at] : 0.f;
    }
  };

  load_tile_async(qd_s[1][0], head_base(a.k, a.sk, b, h), a.sk.s, k0, S);
  load_tile_async(qd_s[1][1], head_base(a.v, a.sv, b, h), a.sv.s, k0, S);
  cp_async_commit();
  load_tile_async(qd_s[0][0], qh, a.sq.s, qt0 * kTile, S);
  load_tile_async(qd_s[0][1], doh, a.sdo.s, qt0 * kTile, S);
  cp_async_commit();
  load_stats(0, qt0 * kTile);
  cp_async_wait(true);
  __syncthreads();
  const int r_lo = warp * 16 + g;
  uint32_t ka[4][4], va[4][4];
  load_a_frags(ka, qd_s[1][0], r_lo, t);
  load_a_frags(va, qd_s[1][1], r_lo, t);
  __syncthreads();  // stage 1 is free for the next tile
  const int key0 = k0 + r_lo;  // absolute key of fragment rows g; g + 8 is key0 + 8

  float dk[8][4], dv[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    dk[nt][0] = dk[nt][1] = dk[nt][2] = dk[nt][3] = 0.f;
    dv[nt][0] = dv[nt][1] = dv[nt][2] = dv[nt][3] = 0.f;
  }

  for (int qt = qt0; qt < n_tiles; ++qt) {
    const int st = (qt - qt0) & 1;
    const bool more = qt + 1 < n_tiles;
    if (more) {
      load_tile_async(qd_s[st ^ 1][0], qh, a.sq.s, (qt + 1) * kTile, S);
      load_tile_async(qd_s[st ^ 1][1], doh, a.sdo.s, (qt + 1) * kTile, S);
      cp_async_commit();
      load_stats(st ^ 1, (qt + 1) * kTile);
    }
    cp_async_wait(more);
    __syncthreads();
    const int q0 = qt * kTile;
    bf16 (*q_s)[kDh + kPad] = qd_s[st][0];
    bf16 (*do_s)[kDh + kPad] = qd_s[st][1];
    // transposed scores: rows are this warp's keys, columns the tile's q rows
    float stp[8][4], dpt[8][4];
    product_nt(stp, ka, q_s, g, t);
    product_nt(dpt, va, do_s, g, t);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = nt * 8 + t * 2 + (e & 1);
        const float p = replay_p(stp[nt][e], q0 + qi, key0 + (e >> 1) * 8, lse_s[st][qi], S,
                                 causal);
        stp[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - c_s[st][qi]);
      }
    }
    product_nn(dv, stp, do_s, lo);   // dv += p^T do
    product_nn(dk, dpt, q_s, lo);    // dk += ds^T q
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  store_rows_bf16(head_base(a.dk, a.sdk, b, h), a.sdk.s, dk, key0, S, t);
  store_rows_bf16(head_base(a.dv, a.sdv, b, h), a.sdv.s, dv, key0, S, t);
}

// ---- whole-head route ----------------------------------------------------------

// Shared memory of the whole-head route for Sp padded rows: q, k, v, do (bf16) and
// the row statistics lse and c (float32).
__host__ __device__ __forceinline__ int head_smem_bytes(int Sp) {
  return Sp * (4 * kRowBytes + 2 * 4);
}

// s = X Y^T and d = Z W^T for one 16-row block, from the A fragments x, z (4 k-steps
// over dh) and the 16 rows of the tiles y, w at `row` (this lane's ldmatrix row): two
// n-tiles of 8 columns each.
__device__ __forceinline__ void scores_pair(float (&s)[2][4], float (&d)[2][4],
                                            const uint32_t (&x)[4][4], const uint32_t (&z)[4][4],
                                            uint32_t y, uint32_t w, int row,
                                            const LaneOffsets& lo) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = d[j][e] = 0.f;
  }
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t yb[4], wb[4];
    ldsm_x4(yb, swz(y, row, 2 * ks + lo.n_chk));
    ldsm_x4(wb, swz(w, row, 2 * ks + lo.n_chk));
    mma_bf16_16816(s[0], x[ks], yb[0], yb[1]);
    mma_bf16_16816(s[1], x[ks], yb[2], yb[3]);
    mma_bf16_16816(d[0], z[ks], wb[0], wb[1]);
    mma_bf16_16816(d[1], z[ks], wb[2], wb[3]);
  }
}

// mha_bwd's row statistics for one 16-row block (rows `row`, this thread's g and
// g + 8): a sweep over the key tiles [0, kt_end) forms s = q k^T on the tensor cores
// and an online max and sum of 2^(s s2) in float32. Returns lse2 = max + log2(sum),
// the same in every lane of a quad.
__device__ __forceinline__ void row_stats(float (&lse2)[2], const uint32_t (&qa)[4][4],
                                          uint32_t sk, int kt_end, const int (&row)[2], int S,
                                          int causal, float s2, const LaneOffsets& lo, int t) {
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's partial sums, reduced over the quad at the end
  for (int kt = 0; kt < kt_end; ++kt) {
    float s[2][4];
    scores_16(s, qa, sk, kt * 16 + lo.n_row, lo);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kt * 16 + j * 8 + t * 2 + (e & 1);
        const bool ok = col < S && (!causal || col <= row[e >> 1]);
        s[j][e] = ok ? s[j][e] * s2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    // every row sees key 0 in tile 0, so the max is finite from the first tile on
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      l[i] *= ex2(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) l[e >> 1] += ex2(s[j][e] - m[e >> 1]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    lse2[i] = m[i] + log2f(l[i]);
  }
}

// The two-term split of a float32 A fragment (16 x 16, two n-tiles of accumulators):
// hi = bf16(x) and lo = bf16(x - hi), so hi + lo is x to 2^-16 of |x| and each of
// hi * y and lo * y is exact in float32 for a bf16 y (x - hi is exact in float32).
__device__ __forceinline__ void split_a(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                        const float (&f)[2][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x0 = f[i >> 1][(i & 1) * 2];
    const float x1 = f[i >> 1][(i & 1) * 2 + 1];
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = pack_bf16(x0 - hf.x, x1 - hf.y);
  }
}

// acc[16 x 64] += (hi + lo) * the 16 rows at `row0` of tile y: product_rows on both
// terms of a split fragment, hi then lo into the same float32 accumulators, one
// ldmatrix.trans for both.
__device__ __forceinline__ void product_rows_split(float (&acc)[8][4], const uint32_t (&hi)[4],
                                                   const uint32_t (&lo)[4], uint32_t y,
                                                   int row0, const LaneOffsets& lanes) {
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    uint32_t yb[4];
    ldsm_x4_trans(yb, swz(y, row0 + lanes.k_row, 2 * np + lanes.k_chk));
    mma_bf16_16816(acc[2 * np], hi, yb[0], yb[1]);
    mma_bf16_16816(acc[2 * np], lo, yb[0], yb[1]);
    mma_bf16_16816(acc[2 * np + 1], hi, yb[2], yb[3]);
    mma_bf16_16816(acc[2 * np + 1], lo, yb[2], yb[3]);
  }
}

// acc += X * the 16 rows at `row0` of tile y, X the float32 fragment `x`: rounded to
// bf16 once (flash entries, as the TPU kernel rounds p and ds to the working type) or
// split in two terms (kMha: mha_bwd keeps p and ds in float32).
template <bool kMha>
__device__ __forceinline__ void product_rows_of(float (&acc)[8][4], const float (&x)[2][4],
                                                uint32_t y, int row0, const LaneOffsets& lanes) {
  if (kMha) {
    uint32_t xh[4], xl[4];
    split_a(xh, xl, x);
    product_rows_split(acc, xh, xl, y, row0, lanes);
  } else {
    uint32_t xa[4];
    pack_a(xa, x);
    product_rows(acc, xa, y, row0, lanes);
  }
}

__device__ __forceinline__ void scale_acc(float (&acc)[8][4], float f) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] *= f;
  }
}

// One block of kWarps warps per (head, batch): grid (H, B), head_smem_bytes of dynamic
// shared memory. kMha: `mha_bwd` (no lse in: phase A forms each row's statistics
// first; the scores scaled by a.scale; p and ds enter the products as two bf16 terms;
// dq and dk scaled by a.scale at the end); otherwise `flash3_bwd` / `flash_bwd`.
template <int kWarps, int kMinBlocks, bool kMha>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
    attn_bwd_head_bf16_kernel(const BwdArgs<bf16> a) {
  constexpr int kThreads = kWarps * 32;
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int S = a.S;
  const int Sp = padded_rows(S);
  const int n16 = Sp / 16;
  const int causal = a.causal;
  const uint32_t sq = smem_addr(smem);
  const uint32_t sk = sq + Sp * kRowBytes;
  const uint32_t sv = sk + Sp * kRowBytes;
  const uint32_t sdo = sv + Sp * kRowBytes;
  float* lse_s = reinterpret_cast<float*>(smem + 4 * Sp * kRowBytes);  // lse log2 e
  float* c_s = lse_s + Sp;
  // the exponent of p per unit of q k^T: log2 e, times 1/sqrt(dh) for mha_bwd (exact)
  const float s2 = kMha ? a.scale * kLog2e : kLog2e;

  load_head_async<kThreads>(sq, head_base(a.q, a.sq, b, h), a.sq.s, S, Sp);
  load_head_async<kThreads>(sk, head_base(a.k, a.sk, b, h), a.sk.s, S, Sp);
  load_head_async<kThreads>(sv, head_base(a.v, a.sv, b, h), a.sv.s, S, Sp);
  load_head_async<kThreads>(sdo, head_base(a.dout, a.sdo, b, h), a.sdo.s, S, Sp);
  cp_async_commit();
  if (!kMha) {
    for (int r = threadIdx.x; r < Sp; r += kThreads) {
      lse_s[r] = r < S ? a.lse[((long long)b * S + r) * a.H + h] * kLog2e : 0.f;
    }
  }
  cp_async_wait(false);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const LaneOffsets lo(lane);

  // phase A: warps own 16-row blocks; (mha_bwd: the row statistics,) c, then dq
  for (int rb = warp; rb < n16; rb += kWarps) {
    const int r0 = rb * 16;
    uint32_t qa[4][4], da[4][4];
    head_a_frags(qa, sq, r0, lo);
    head_a_frags(da, sdo, r0, lo);
    const int row[2] = {r0 + g, r0 + g + 8};
    const int kt_end = causal ? rb + 1 : n16;  // causal: key tiles past the block are empty
    float lse_r[2];
    if (kMha) {
      row_stats(lse_r, qa, sk, kt_end, row, S, causal, s2, lo, t);
      if (t == 0) {
        lse_s[row[0]] = lse_r[0];
        lse_s[row[1]] = lse_r[1];
      }
    } else {
      lse_r[0] = lse_s[row[0]];
      lse_r[1] = lse_s[row[1]];
    }
    float c[2] = {0.f, 0.f};
    for (int kt = 0; kt < kt_end; ++kt) {
      float s[2][4], dp[2][4];
      scores_pair(s, dp, qa, da, sk, sv, kt * 16 + lo.n_row, lo);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kt * 16 + j * 8 + t * 2 + (e & 1);
          const float p = head_p(s[j][e], row[e >> 1], col, lse_r[e >> 1], S, causal, s2);
          c[e >> 1] += p * dp[j][e];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      c[i] += __shfl_xor_sync(0xffffffffu, c[i], 1);
      c[i] += __shfl_xor_sync(0xffffffffu, c[i], 2);
    }
    if (t == 0) {
      c_s[row[0]] = c[0];
      c_s[row[1]] = c[1];
    }
    float dq[8][4];
    zero_acc(dq);
    for (int kt = 0; kt < kt_end; ++kt) {
      float s[2][4], dp[2][4];
      scores_pair(s, dp, qa, da, sk, sv, kt * 16 + lo.n_row, lo);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kt * 16 + j * 8 + t * 2 + (e & 1);
          const float p = head_p(s[j][e], row[e >> 1], col, lse_r[e >> 1], S, causal, s2);
          s[j][e] = p * (dp[j][e] - c[e >> 1]);
        }
      }
      product_rows_of<kMha>(dq, s, sk, kt * 16, lo);  // dq += ds k
    }
    if (kMha) scale_acc(dq, a.scale);
    store_rows_bf16(head_base(a.dq, a.sdq, b, h), a.sdq.s, dq, row[0], S, t);
  }
  __syncthreads();  // c (and for mha_bwd lse) of every row is in shared memory

  // phase B: warps own 16-key blocks; dk and dv on the transposed scores
  for (int kb = warp; kb < n16; kb += kWarps) {
    const int k0 = kb * 16;
    uint32_t ka[4][4];
    head_a_frags(ka, sk, k0, lo);
    const int key[2] = {k0 + g, k0 + g + 8};
    float dk[8][4], dv[8][4];
    zero_acc(dk);
    zero_acc(dv);
    for (int rt = causal ? kb : 0; rt < n16; ++rt) {  // causal: earlier rows see none
      const int q0 = rt * 16;
      float st[2][4], dpt[2][4];
      uint32_t va[4][4];  // reloaded per tile: held, it pushed 8 warps past 128 registers
      head_a_frags(va, sv, k0, lo);
      scores_pair(st, dpt, ka, va, sq, sdo, q0 + lo.n_row, lo);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = q0 + j * 8 + t * 2 + (e & 1);
          const float p = head_p(st[j][e], qi, key[e >> 1], lse_s[qi], S, causal, s2);
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - c_s[qi]);
        }
      }
      if (kMha) {
        product_rows_of<true>(dv, st, sdo, q0, lo);   // dv += p^T do
        product_rows_of<true>(dk, dpt, sq, q0, lo);   // dk += ds^T q
      } else {
        uint32_t pa[4], dsa[4];
        pack_a(pa, st);
        pack_a(dsa, dpt);
        product_rows(dv, pa, sdo, q0, lo);   // dv += p^T do
        product_rows(dk, dsa, sq, q0, lo);   // dk += ds^T q
      }
    }
    if (kMha) scale_acc(dk, a.scale);
    store_rows_bf16(head_base(a.dk, a.sdk, b, h), a.sdk.s, dk, key[0], S, t);
    store_rows_bf16(head_base(a.dv, a.sdv, b, h), a.sdv.s, dv, key[0], S, t);
  }
}

template <int kWarps, int kMinBlocks, bool kMha>
int launch_head_kernel(const BwdArgs<bf16>& a, int B, int H, cudaStream_t cs) {
  auto kernel = attn_bwd_head_bf16_kernel<kWarps, kMinBlocks, kMha>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         head_smem_bytes(padded_rows(kWholeHeadMaxS)));
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(H, B), kWarps * 32, head_smem_bytes(padded_rows(a.S)), cs>>>(a);
  return (int)cudaGetLastError();
}

// The block shape for S, chosen by timing on an H100 SXM: where two blocks' shared
// memory fits an SM (Sp <= kTwoBlockRows: ViT-B/16's 208 rows, the text tower's 80),
// two blocks of 8 warps (128 registers a thread); else one block of 12 warps (at
// CLIP's 272 rows, 17 row blocks, it beat 8 warps and 16, which spill).
constexpr int kTwoBlockRows = 216;

int launch_whole_head(const BwdArgs<bf16>& a, int B, int H, bool mha, cudaStream_t cs) {
  const bool two = padded_rows(a.S) <= kTwoBlockRows;
  if (mha) {
    return two ? launch_head_kernel<8, 2, true>(a, B, H, cs)
               : launch_head_kernel<12, 1, true>(a, B, H, cs);
  }
  return two ? launch_head_kernel<8, 2, false>(a, B, H, cs)
             : launch_head_kernel<12, 1, false>(a, B, H, cs);
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

// Launch one route on `stream`: the whole-head kernel, or the dq pass and then the
// dk/dv pass. p: q, k, v, do, dq, dk, dv; st: their strides in that order; lse and
// delta [B, S, H] float32 (delta may be null where the whole-head route runs). `mha`
// selects mha_bwd's math. dtype: 0 = float32, 1 = bfloat16. Returns the first launch
// error (cudaError_t, 0 on success).
int launch_bwd(const void* const* p, float* lse, float* delta, const Strides* st, int B,
               int S, int H, int causal, int dtype, bool mha, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  cudaStream_t cs = reinterpret_cast<cudaStream_t>(stream);
  const float scale = mha ? 1.f / sqrtf((float)kDh) : 1.f;
  if (dtype == 1 && S <= kWholeHeadMaxS) {
    if (!mha && lse == nullptr) return (int)cudaErrorInvalidValue;
    return launch_whole_head(bwd_args<bf16>(p, lse, delta, st, S, H, causal, scale), B, H,
                             mha, cs);
  }
  if (lse == nullptr || delta == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    const BwdArgs<bf16> a = bwd_args<bf16>(p, lse, delta, st, S, H, causal, scale);
    if (mha) return launch_fma<bf16, true>(a, grid, cs);
    attn_bwd_dq_bf16_kernel<<<grid, 128, 0, cs>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    attn_bwd_dkv_bf16_kernel<<<grid, 128, 0, cs>>>(a);
    return (int)cudaGetLastError();
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
// mha_bwd `lse`) is float32 scratch [B, S, H] allocated by the caller; bf16 with
// S <= kWholeHeadMaxS (432) runs the whole-head route in one launch and takes a null
// `delta` (and, for mha_bwd, a null `lse`). Otherwise an entry launches the dq pass and
// then the dk/dv pass on `stream`. Each returns the first launch error (cudaError_t, 0
// on success).

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

// ptrs: q, k, v, do, dq, dk, dv, lse and delta (scratch of the FMA route, else null);
// strides as flash_bwd's. The scores are scaled by 1/sqrt(dh); p and ds stay float32
// (in bf16 on the whole-head route, as two exact bf16 terms).
extern "C" int mha_bwd(const void* const* ptrs, const long long* strides, int B, int S,
                       int H, int causal, int dtype, void* stream) {
  return launch_strided(ptrs, strides, B, S, H, causal, dtype, true, stream);
}
