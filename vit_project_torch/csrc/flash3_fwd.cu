// Attention forward for Hopper (sm_90a): one body behind three entry points.
//
// It replaces three TPU kernels of vit_project_tpu/ops/attention.py. All three compute
// the same per-head softmax attention; they differ in how q, k and v lie in memory and
// in where the score scale is applied:
//   - `flash3_fwd` replaces `_flash3_fwd_kernel` (with `_attn_masks`, `_attn_fwd_head`),
//     reached through `flash_mha_packed_qkv`: one packed [B, S, 3D] qkv, q at lanes
//     h*dh, k at D + h*dh, v at 2D + h*dh, q already scaled by 1/sqrt(dh). Writes o
//     [B, S, D] at lanes h*dh and the row log-sum-exp lse [B, S, H] in float32.
//   - `flash_fwd` replaces `_flash_fwd_kernel`, reached through `flash_mha_packed`: the
//     same math on three [B, S, D] tensors (q prescaled), heads as dh-lane slices; o
//     [B, S, D] and lse [B, S, H].
//   - `mha_fwd` replaces `_mha_kernel`, reached through `attention_core(_bshd)` with
//     `use_pallas=True`: whole-sequence attention over [B, H, S, dh] tensors (or
//     [B, S, H, dh], read by stride where the TPU path transposes), the float32 scores
//     multiplied by 1/sqrt(dh) inside the kernel; o only, no lse. The TPU kernel pads S
//     and dh to 128 with zeros and masks the padded keys, which changes nothing here.
// Each operand is a [B, H, S, 64] view given by a batch, head and row stride
// (attention.cuh): no split, no transpose, no copy.
//   - key columns >= S are masked, and with `causal` every column past the row.
//   - softmax statistics are float32; in bf16, p is rounded to bf16 before the PV
//     product (as the TPU kernels round p to v's type).
//
// Routes. dh is fixed at 64 (a template for another dh raises in the wrapper). Both
// bf16 routes run the two products on the tensor cores as mma.sync m16n8k16 (bf16 in,
// f32 accumulate), a warp owning 16 q rows, the S accumulator fragment re-packed in
// registers as the A operand of the PV product. The TPU's whole-sequence kernel rounds
// the normalized p to bf16 where these round the running exp; the two differ by at
// most one bf16 spacing of o.
// 1. bf16 with S <= kFwdWholeHeadMaxS (288), the "whole-head" route: one block per
//    (head, batch element), so each head's q, k and v are read from device memory
//    once (the streamed route read k and v once per 64-row q tile: 4 times at S = 197,
//    5 at S = 257). The block copies them with cp.async into shared memory, rows
//    padded to 16 with zeros, 128-byte rows under the backward's XOR swizzle
//    (attention.cuh), in groups of 64 keys: the first round's products start while
//    later keys are in flight. min(8, Sp / 16) warps own 16-row blocks round robin; each sweeps the key
//    tiles of 16 in steps of 64 keys with an online softmax in float32, k's fragments
//    from ldmatrix and v's from ldmatrix.trans. Only the tile that holds key S - 1 and
//    (causal) the diagonal tile are masked element by element; causal rows skip the
//    tiles past their diagonal. The score scale and log2 e are one FMA, and
//    p = 2^(s c - m c) comes from ex2.approx. Two blocks of 8 warps an SM (127
//    registers, no spill; 3 Sp 128 bytes of shared memory: 78 KB at S = 197, 102 KB at
//    257).
//    Measured on an H100 SXM (tools/compare_flash3_builds.py): warps that each own two
//    16-row tiles sharing every k and v fragment (FlashAttention-2's layout) were
//    14-115% slower at every block shape tried; a wgmma version (q and k by descriptor
//    from the same tiles, p from registers, o += p v in flight under the next step's
//    softmax) gave the same bits and the same time, as ptxas serialized its wgmma for
//    want of registers at the 128 a thread that 16 warps an SM leave.
// 2. bf16 with longer S, the "streamed" route: one block per (64-row q tile, head,
//    batch element), 4 warps, a loop over 64-key k/v tiles staged in shared memory.
// 3. f32: the tensor cores have no exact f32 product, so 64 threads each own one q row
//    and compute both products with FMAs from shared memory, a loop over 32-key tiles.
// A scale of 1 (the packed entry points) multiplies exactly, so `flash3_fwd` gives the
// bits of `flash_fwd` on the same q, k and v.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s dense bf16; NVIDIA's data sheet): for
// the image tower at serving bucket 256, qkv [256, 257, 3072] bf16, the kernel must
// read 404 MB and write 139 MB (o and lse): 543 MB, 0.16 ms, against 4*B*H*S*S*dh =
// 69 GFLOP, 0.07 ms. It is memory-bound, as are the other entry points at the repo's
// shapes. chip_smoke.py recomputes each bound for the card that nvidia-smi names. The
// whole-head route moves the bound's bytes; what holds it at 2.4-2.9 times the bound
// is instruction issue: in the build's SASS (cuobjdump -sass) a step of 64 keys is
// ~570 instructions a warp, ~100 of them mma.sync and ldmatrix, the rest the softmax
// and its indexing.

#include <math.h>

#include "attention.cuh"

namespace {

using namespace attn;

constexpr int kBlockQ = 64;   // q rows per block
constexpr int kBlockK = 64;   // keys per k/v tile

template <typename T>
struct FwdArgs {
  const T* q;
  const T* k;
  const T* v;
  T* o;
  float* lse;  // [B, S, H] row log-sum-exp, or null (mha_fwd writes none)
  Strides sq, sk, sv, so;
  int S, H, causal;
  float scale;  // multiplies the float32 scores; 1 where q comes prescaled
};

__global__ void __launch_bounds__(128) attn_fwd_bf16_kernel(const FwdArgs<bf16> a) {
  __shared__ __align__(16) bf16 q_s[kBlockQ][kDh + kPad];
  __shared__ __align__(16) bf16 k_s[kBlockK][kDh + kPad];
  __shared__ __align__(16) bf16 v_s[kBlockK][kDh + kPad];

  const int q0 = blockIdx.x * kBlockQ;
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
  __syncthreads();

  // A fragments of this warp's 16 q rows, for the 4 k-steps of 16 lanes of dh
  const int r_lo = warp * 16 + g;
  uint32_t qa[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int c = ks * 16 + t * 2;
    qa[ks][0] = *reinterpret_cast<const uint32_t*>(&q_s[r_lo][c]);
    qa[ks][1] = *reinterpret_cast<const uint32_t*>(&q_s[r_lo + 8][c]);
    qa[ks][2] = *reinterpret_cast<const uint32_t*>(&q_s[r_lo][c + 8]);
    qa[ks][3] = *reinterpret_cast<const uint32_t*>(&q_s[r_lo + 8][c + 8]);
  }

  const int row0 = q0 + r_lo;  // absolute q row of fragment rows g; g + 8 is row0 + 8
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's partial row sums, reduced over the quad at the end
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  }

  int n_tiles = (S + kBlockK - 1) / kBlockK;
  if (causal) {
    const int last = (min(q0 + kBlockQ, S) - 1) / kBlockK + 1;
    n_tiles = min(n_tiles, last);
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile_bf16<128>(k_s, kh, a.sk.s, k0, S);
    load_tile_bf16<128>(v_s, vh, a.sv.s, k0, S);
    __syncthreads();

    // s = q k^T for 16 rows x 64 keys: 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int c = ks * 16 + t * 2;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&k_s[nt * 8 + g][c]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&k_s[nt * 8 + g][c + 8]);
        mma_bf16_16816(s[nt], qa[ks], b0, b1);
      }
    }

    // scale; masks: key columns >= S, and with causal every column past the row
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + t * 2 + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        const bool ok = col < S && (!causal || col <= row);
        s[nt][e] = ok ? s[nt][e] * a.scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
    // Every row sees key 0 in tile 0, so m_new is finite from the first tile on.
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = __expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        l[e >> 1] += p;
      }
      acc[nt][0] *= corr[0];
      acc[nt][1] *= corr[0];
      acc[nt][2] *= corr[1];
      acc[nt][3] *= corr[1];
    }

    // o += p v: the S accumulators of key tiles 2j, 2j+1 are the A fragment of k-step j
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      pa[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      pa[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      pa[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
      const int kr = j * 16 + t * 2;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int d = nt * 8 + g;
        const uint32_t b0 = pack_bf16(v_s[kr][d], v_s[kr + 1][d]);
        const uint32_t b1 = pack_bf16(v_s[kr + 8][d], v_s[kr + 9][d]);
        mma_bf16_16816(acc[nt], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  bf16* oh = head_base(a.o, a.so, b, h);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    if (row >= S) continue;
    bf16* orow = oh + row * a.so.s;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const uint32_t v = pack_bf16(acc[nt][2 * i] * inv[i], acc[nt][2 * i + 1] * inv[i]);
      *reinterpret_cast<uint32_t*>(orow + nt * 8 + t * 2) = v;
    }
    if (a.lse != nullptr && t == 0) {
      a.lse[((long long)b * S + row) * a.H + h] = m[i] + logf(l[i]);
    }
  }
}

// ---- whole-head route (bf16, S <= kFwdWholeHeadMaxS) ---------------------------

constexpr int kFwdWholeHeadMaxS = 288;  // the whole-head route takes S up to this
constexpr int kFwdMaxWarps = 8;         // warps of a whole-head block (fewer for short S)
constexpr int kChunk = 64;              // keys of one cp.async group and softmax step
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of the whole-head route for Sp padded rows: q, k and v of one head.
__host__ __device__ __forceinline__ int fwd_smem_bytes(int Sp) { return 3 * Sp * kRowBytes; }

// Wait until at most `n` (0 to 4) committed cp.async groups are still in flight.
__device__ __forceinline__ void cp_async_wait_at_most(int n) {
  switch (n) {
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
  }
}

// One block per (head, batch): grid (H, B), min(8, Sp / 16) warps, fwd_smem_bytes of
// dynamic shared memory. The block copies its head's q, k and v into swizzled shared
// memory with cp.async, in groups of 64 keys (group 0 also carries the q rows of the
// first round, group 1 the rest), so the first round's products start while later
// keys are in flight. Warps own 16-row blocks, round robin; each sweeps the key tiles
// of 16 in steps of 64 keys with an online softmax in float32.
__global__ void __launch_bounds__(kFwdMaxWarps * 32, 2)
    attn_fwd_head_bf16_kernel(const FwdArgs<bf16> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int S = a.S;
  const int Sp = padded_rows(S);
  const int n16 = Sp / 16;
  const int n_chunks = (Sp + kChunk - 1) / kChunk;
  const int causal = a.causal;
  const int n_warps = blockDim.x >> 5;
  const uint32_t sq = smem_addr(smem);
  const uint32_t sk = sq + Sp * kRowBytes;
  const uint32_t sv = sk + Sp * kRowBytes;
  const bf16* qh = head_base(a.q, a.sq, b, h);
  const bf16* kh = head_base(a.k, a.sk, b, h);
  const bf16* vh = head_base(a.v, a.sv, b, h);

  const int q_first = min(Sp, n_warps * 16);  // q rows of the first round
  for (int j = 0; j < n_chunks; ++j) {
    const int r0 = j * kChunk;
    const int r1 = min(Sp, r0 + kChunk);
    if (j == 0) load_rows_async(sq, qh, a.sq.s, 0, q_first, S, blockDim.x);
    if (j == 1) load_rows_async(sq, qh, a.sq.s, q_first, Sp, S, blockDim.x);
    load_rows_async(sk, kh, a.sk.s, r0, r1, S, blockDim.x);
    load_rows_async(sv, vh, a.sv.s, r0, r1, S, blockDim.x);
    cp_async_commit();
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const LaneOffsets lo(lane);
  const float c2 = a.scale * kLog2e;  // the exponent of p per unit of q k^T
  bf16* oh = head_base(a.o, a.so, b, h);

  const int n_rounds = (n16 + n_warps - 1) / n_warps;
  for (int round = 0; round < n_rounds; ++round) {
    const int rb = round * n_warps + warp;
    const bool active = rb < n16;
    const int r0 = rb * 16;
    const int row[2] = {r0 + g, r0 + g + 8};
    const int kt_end = causal ? rb + 1 : n16;  // causal: key tiles past the block are empty
    uint32_t qa[4][4];
    float m[2] = {-INFINITY, -INFINITY};  // row max of the raw scores q k^T
    float l[2] = {0.f, 0.f};  // this thread's partial row sums, reduced over the quad at the end
    float acc[8][4];
    zero_acc(acc);
    for (int j = 0; j < n_chunks; ++j) {
      if (round == 0) {  // keys [0, 64 (j + 1)) have landed, for every warp to read
        cp_async_wait_at_most(n_chunks - 1 - j);
        __syncthreads();
      }
      if (!active || 4 * j >= kt_end) continue;
      if (j == 0) head_a_frags(qa, sq, r0, lo);

      float s[4][2][4];
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
        const int kt = 4 * j + tt;
        if (kt < kt_end) {
          scores_16(s[tt], qa, sk, kt * 16 + lo.n_row, lo);
          if (kt * 16 + 16 > S || (causal && kt == rb)) {
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int col = kt * 16 + jj * 8 + t * 2 + (e & 1);
                if (col >= S || (causal && col > row[e >> 1])) s[tt][jj][e] = -INFINITY;
              }
            }
          }
        } else {
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            s[tt][jj][0] = s[tt][jj][1] = s[tt][jj][2] = s[tt][jj][3] = -INFINITY;
          }
        }
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[tt][jj][e]);
        }
      }
      // Every row sees key 0 in step 0, so the max is finite from the first step on.
      float corr[2], mc[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        corr[i] = ex2((m[i] - m_new) * c2);
        m[i] = m_new;
        mc[i] = m_new * c2;
        l[i] *= corr[i];
      }
      if (j > 0)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[nt][0] *= corr[0];
        acc[nt][1] *= corr[0];
        acc[nt][2] *= corr[1];
        acc[nt][3] *= corr[1];
      }
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = ex2(fmaf(s[tt][jj][e], c2, -mc[e >> 1]));  // scale folded in
            s[tt][jj][e] = p;
            l[e >> 1] += p;
          }
        }
      }
      // o += p v: p rounded to bf16 (the A fragment), v's fragments by ldmatrix.trans
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
        const int kt = 4 * j + tt;
        if (kt >= kt_end) break;
        uint32_t pa[4];
        pack_a(pa, s[tt]);
        product_rows(acc, pa, sv, kt * 16, lo);
      }
    }
    if (!active) continue;

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      if (row[i] >= S) continue;
      const float inv = 1.f / l[i];
      bf16* orow = oh + row[i] * a.so.s;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        *reinterpret_cast<uint32_t*>(orow + nt * 8 + t * 2) =
            pack_bf16(acc[nt][2 * i] * inv, acc[nt][2 * i + 1] * inv);
      }
      // lse in natural log: l sums 2^((s - m) c2) = e^((s - m) scale)
      if (a.lse != nullptr && t == 0) {
        a.lse[((long long)b * S + row[i]) * a.H + h] = m[i] * a.scale + logf(l[i]);
      }
    }
  }
}

int launch_fwd_whole_head(const FwdArgs<bf16>& a, int B, int H, cudaStream_t cs) {
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_head_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         fwd_smem_bytes(padded_rows(kFwdWholeHeadMaxS)));
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attn_fwd_head_bf16_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const int Sp = padded_rows(a.S);
  const int warps = min(kFwdMaxWarps, Sp / 16);
  attn_fwd_head_bf16_kernel<<<dim3(H, B), warps * 32, fwd_smem_bytes(Sp), cs>>>(a);
  return (int)cudaGetLastError();
}

constexpr int kF32Keys = 32;  // keys per k/v tile in the f32 kernel

__global__ void __launch_bounds__(kBlockQ) attn_fwd_f32_kernel(const FwdArgs<float> a) {
  __shared__ __align__(16) float k_s[kF32Keys][kDh];
  __shared__ __align__(16) float v_s[kF32Keys][kDh];

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int S = a.S;
  const int causal = a.causal;
  const float* qh = head_base(a.q, a.sq, b, h);
  const float* kh = head_base(a.k, a.sk, b, h);
  const float* vh = head_base(a.v, a.sv, b, h);
  const int row = q0 + threadIdx.x;

  float q[kDh];
#pragma unroll
  for (int d = 0; d < kDh; d += 4) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < S) v = *reinterpret_cast<const float4*>(qh + row * a.sq.s + d);
    q[d] = v.x; q[d + 1] = v.y; q[d + 2] = v.z; q[d + 3] = v.w;
  }
  float acc[kDh];
#pragma unroll
  for (int d = 0; d < kDh; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;

  int n_tiles = (S + kF32Keys - 1) / kF32Keys;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kBlockQ, S) - 1) / kF32Keys + 1);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kF32Keys;
    __syncthreads();
    for (int i = threadIdx.x; i < kF32Keys * (kDh / 4); i += kBlockQ) {
      const int r = i / (kDh / 4);
      const int c = (i % (kDh / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + r < S) {
        kv = *reinterpret_cast<const float4*>(kh + (k0 + r) * a.sk.s + c);
        vv = *reinterpret_cast<const float4*>(vh + (k0 + r) * a.sv.s + c);
      }
      *reinterpret_cast<float4*>(&k_s[r][c]) = kv;
      *reinterpret_cast<float4*>(&v_s[r][c]) = vv;
    }
    __syncthreads();

    float s[kF32Keys];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kF32Keys; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < kDh; d += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(&k_s[j][d]);
        dot = fmaf(q[d], kv.x, dot);
        dot = fmaf(q[d + 1], kv.y, dot);
        dot = fmaf(q[d + 2], kv.z, dot);
        dot = fmaf(q[d + 3], kv.w, dot);
      }
      const int col = k0 + j;
      const bool ok = col < S && (!causal || col <= row);
      s[j] = ok ? dot * a.scale : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    m = m_new;
    l *= corr;
#pragma unroll
    for (int d = 0; d < kDh; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < kF32Keys; ++j) {
      const float p = expf(s[j] - m);
      l += p;
#pragma unroll
      for (int d = 0; d < kDh; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&v_s[j][d]);
        acc[d] = fmaf(p, vv.x, acc[d]);
        acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
      }
    }
  }

  if (row < S) {
    const float inv = 1.f / l;
    float* orow = head_base(a.o, a.so, b, h) + row * a.so.s;
#pragma unroll
    for (int d = 0; d < kDh; d += 4) {
      *reinterpret_cast<float4*>(orow + d) =
          make_float4(acc[d] * inv, acc[d + 1] * inv, acc[d + 2] * inv, acc[d + 3] * inv);
    }
    if (a.lse != nullptr) a.lse[((long long)b * S + row) * a.H + h] = m + logf(l);
  }
}

// Launch the forward over operands given as base pointers and strides st[0..3] of
// q, k, v and o. dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t.
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
               const Strides* st, int B, int S, int H, int causal, float scale, int dtype,
               void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  cudaStream_t cs = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const FwdArgs<bf16> a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                          static_cast<const bf16*>(v), static_cast<bf16*>(o), lse,
                          st[0], st[1], st[2], st[3], S, H, causal, scale};
    if (S <= kFwdWholeHeadMaxS) return launch_fwd_whole_head(a, B, H, cs);
    attn_fwd_bf16_kernel<<<grid, 128, 0, cs>>>(a);
  } else if (dtype == 0) {
    const FwdArgs<float> a{static_cast<const float*>(q), static_cast<const float*>(k),
                           static_cast<const float*>(v), static_cast<float*>(o), lse,
                           st[0], st[1], st[2], st[3], S, H, causal, scale};
    attn_fwd_f32_kernel<<<grid, kBlockQ, 0, cs>>>(a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

Strides strides_at(const long long* s, int i) { return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16. Each entry
// launches on `stream` and returns the launch's cudaError_t (0 on success).

// Packed qkv [B, S, 3D] (q prescaled) -> o [B, S, D], lse [B, S, H].
extern "C" int flash3_fwd(const void* qkv, void* o, void* lse, int B, int S, int D,
                          int H, int causal, int dtype, void* stream) {
  if (H <= 0 || D != H * kDh || B <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const long long lane_bytes = dtype == 1 ? 2 : 4;
  const char* base = static_cast<const char*>(qkv);
  const Strides packed{(long long)S * 3 * D, kDh, 3LL * D};
  const Strides out{(long long)S * D, kDh, D};
  const Strides st[4] = {packed, packed, packed, out};
  return launch_fwd(base, base + D * lane_bytes, base + 2 * D * lane_bytes, o,
                    static_cast<float*>(lse), st, B, S, H, causal, 1.f, dtype, stream);
}

// ptrs: q (prescaled), k, v, o, lse [B, S, H]; strides: (batch, head, row) of q, k, v, o.
extern "C" int flash_fwd(const void* const* ptrs, const long long* strides, int B, int S,
                         int H, int causal, int dtype, void* stream) {
  const Strides st[4] = {strides_at(strides, 0), strides_at(strides, 1),
                         strides_at(strides, 2), strides_at(strides, 3)};
  return launch_fwd(ptrs[0], ptrs[1], ptrs[2], const_cast<void*>(ptrs[3]),
                    static_cast<float*>(const_cast<void*>(ptrs[4])), st, B, S, H, causal,
                    1.f, dtype, stream);
}

// ptrs: q, k, v, o; strides as flash_fwd's. The scores are scaled by 1/sqrt(dh).
extern "C" int mha_fwd(const void* const* ptrs, const long long* strides, int B, int S,
                       int H, int causal, int dtype, void* stream) {
  const Strides st[4] = {strides_at(strides, 0), strides_at(strides, 1),
                         strides_at(strides, 2), strides_at(strides, 3)};
  return launch_fwd(ptrs[0], ptrs[1], ptrs[2], const_cast<void*>(ptrs[3]), nullptr, st, B,
                    S, H, causal, 1.f / sqrtf((float)kDh), dtype, stream);
}
