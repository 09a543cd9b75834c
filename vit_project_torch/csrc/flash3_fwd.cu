// Flash attention forward on one packed [B, S, 3D] qkv tensor, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash3_fwd_kernel` in vit_project_tpu/ops/attention.py
// (with `_attn_masks` and `_attn_fwd_head`), reached through `flash_mha_packed_qkv`.
// It computes what that kernel computes:
//   - q, k and v of head h are read by stride straight out of the packed tensor:
//     q at lanes h*dh, k at D + h*dh, v at 2D + h*dh. No split, no transpose.
//   - q is already scaled by 1/sqrt(dh); the kernel applies no scale.
//   - key columns >= S are masked, and with `causal` every column past the row.
//   - o is written into packed [B, S, D] at lanes h*dh, and the row log-sum-exp
//     as lse [B, S, H] in float32.
//   - softmax statistics are float32; in bf16, p is rounded to bf16 before the
//     PV product (as attention.py:314 rounds p to v's type).
//
// Design: one block per (64-row q tile, head, batch element), a loop over
// 64-key k/v tiles staged in shared memory, and an online softmax in float32
// registers. dh is fixed at 64 (a template for another dh raises in the wrapper).
//   - bf16: 4 warps, each owning 16 q rows, run the two products on the tensor
//     cores with mma.sync m16n8k16 (bf16 in, f32 accumulate). The S accumulator
//     fragment is re-packed in registers as the A operand of the PV product.
//   - f32: the tensor cores have no exact f32 product, so 64 threads each own one
//     q row and compute both products with FMAs from shared memory.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s dense bf16; NVIDIA's data sheet):
// for the image tower at serving bucket 256, qkv [256, 257, 3072] bf16, the kernel
// must read 404 MB and write 139 MB (o and lse): 543 MB, 0.16 ms, against
// 4*B*H*S*S*dh = 69 GFLOP, 0.07 ms. It is memory-bound. The text tower
// ([66, 77, 2304], causal) moves about 31 MB. chip_smoke.py recomputes both
// bounds for the card that nvidia-smi names.
//
// Speed is left to later work: TMA loads into a ring of shared-memory tiles,
// wgmma in place of mma.sync, and a q tile that skips the ragged last k/v tile
// (S = 257 leaves one valid key in the fifth tile of 64).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kDh = 64;       // head width this file has a template for
constexpr int kBlockQ = 64;   // q rows per block
constexpr int kBlockK = 64;   // keys per k/v tile
constexpr int kPad = 8;       // bf16 row padding: 144-byte rows, conflict-free fragment loads

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

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [row0, row0 + 64) of one 64-lane column slice into shared memory,
// 16 bytes per thread and load; rows past S are zero.
template <int kThreads>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16 (*dst)[kDh + kPad],
                                               const __nv_bfloat16* src, long row_stride,
                                               int row0, int S) {
  for (int i = threadIdx.x; i < 64 * (kDh / 8); i += kThreads) {
    int r = i / (kDh / 8);
    int c = (i % (kDh / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S) {
      v = *reinterpret_cast<const uint4*>(src + (long)(row0 + r) * row_stride + c);
    }
    *reinterpret_cast<uint4*>(&dst[r][c]) = v;
  }
}

__global__ void __launch_bounds__(128)
flash3_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int S, int D, int H, int causal) {
  __shared__ __align__(16) __nv_bfloat16 q_s[kBlockQ][kDh + kPad];
  __shared__ __align__(16) __nv_bfloat16 k_s[kBlockK][kDh + kPad];
  __shared__ __align__(16) __nv_bfloat16 v_s[kBlockK][kDh + kPad];

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long row_stride = 3L * D;
  const __nv_bfloat16* base = qkv + (long)b * S * row_stride;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group

  load_tile_bf16<128>(q_s, base + h * kDh, row_stride, q0, S);
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
    load_tile_bf16<128>(k_s, base + D + h * kDh, row_stride, k0, S);
    load_tile_bf16<128>(v_s, base + 2 * D + h * kDh, row_stride, k0, S);
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

    // masks: key columns >= S, and with causal every column past the row
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + t * 2 + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        const bool ok = col < S && (!causal || col <= row);
        s[nt][e] = ok ? s[nt][e] : -INFINITY;
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
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    if (row >= S) continue;
    __nv_bfloat16* orow = o + ((long)b * S + row) * D + h * kDh;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const uint32_t v = pack_bf16(acc[nt][2 * i] * inv[i], acc[nt][2 * i + 1] * inv[i]);
      *reinterpret_cast<uint32_t*>(orow + nt * 8 + t * 2) = v;
    }
    if (t == 0) lse[((long)b * S + row) * H + h] = m[i] + logf(l[i]);
  }
}

constexpr int kF32Keys = 32;  // keys per k/v tile in the f32 kernel

__global__ void __launch_bounds__(kBlockQ)
flash3_fwd_f32_kernel(const float* __restrict__ qkv, float* __restrict__ o,
                      float* __restrict__ lse, int S, int D, int H, int causal) {
  __shared__ __align__(16) float k_s[kF32Keys][kDh];
  __shared__ __align__(16) float v_s[kF32Keys][kDh];

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long row_stride = 3L * D;
  const float* base = qkv + (long)b * S * row_stride;
  const int row = q0 + threadIdx.x;

  float q[kDh];
#pragma unroll
  for (int d = 0; d < kDh; d += 4) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < S) v = *reinterpret_cast<const float4*>(base + (long)row * row_stride + h * kDh + d);
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
        const float* src = base + (long)(k0 + r) * row_stride + h * kDh + c;
        kv = *reinterpret_cast<const float4*>(src + D);
        vv = *reinterpret_cast<const float4*>(src + 2 * D);
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
      s[j] = ok ? dot : -INFINITY;
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
    float* orow = o + ((long)b * S + row) * D + h * kDh;
#pragma unroll
    for (int d = 0; d < kDh; d += 4) {
      *reinterpret_cast<float4*>(orow + d) =
          make_float4(acc[d] * inv, acc[d + 1] * inv, acc[d + 2] * inv, acc[d + 3] * inv);
    }
    lse[((long)b * S + row) * H + h] = m + logf(l);
  }
}

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// Launches on `stream` and returns the launch's cudaError_t (0 on success).
extern "C" int flash3_fwd(const void* qkv, void* o, void* lse, int B, int S, int D,
                          int H, int causal, int dtype, void* stream) {
  if (H <= 0 || D != H * kDh || B <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    flash3_fwd_bf16_kernel<<<grid, 128, 0, st>>>(
        static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(o),
        static_cast<float*>(lse), S, D, H, causal);
  } else if (dtype == 0) {
    flash3_fwd_f32_kernel<<<grid, kBlockQ, 0, st>>>(
        static_cast<const float*>(qkv), static_cast<float*>(o), static_cast<float*>(lse),
        S, D, H, causal);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
