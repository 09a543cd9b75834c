// Device code shared by the attention kernels (attention forward in flash3_fwd.cu,
// backward in flash3_bwd.cu), for Hopper (sm_90a).
//
// Every attention operand (q, k, v, o, do and the gradients) is a [B, H, S, 64] view
// of some tensor, read and written by stride: a batch, a head and a row stride in
// elements, with the 64 lanes of a row contiguous. The packed [B, S, 3D] qkv of
// `flash_mha_packed_qkv`, the three [B, S, D] tensors of `flash_mha_packed` and the
// [B, H, S, dh] or [B, S, H, dh] tensors of `attention_core(_bshd)` are all such
// views, so no entry point splits, transposes or copies an operand. The wrappers in
// ops/attention.py check that every stride and base address is a multiple of 16
// bytes (the tile loads are 16-byte vectors).
//
// The whole-head routes of both sources keep a head's tiles in shared memory as
// 128-byte rows whose 16-byte chunks are permuted by the row (`swz`), and take every
// mma.sync fragment from them with ldmatrix; the helpers for that live here, once.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

typedef __nv_bfloat16 bf16;

constexpr int kDh = 64;    // head width the kernels have a template for
constexpr int kPad = 8;    // bf16 row padding: 144-byte rows, conflict-free fragment loads

// Element strides of one operand: batch, head and row.
struct Strides {
  long long b, h, s;
};

// The first row of head h of batch element b.
template <typename T>
__device__ __forceinline__ T* head_base(T* p, const Strides& st, int b, int h) {
  return p + b * st.b + h * st.h;
}

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

// Copy rows [row0, row0 + 64) of one head (64 lanes, `row_stride` elements apart)
// into shared memory, 16 bytes per thread and load; rows past S are zero.
template <int kThreads>
__device__ __forceinline__ void load_tile_bf16(bf16 (*dst)[kDh + kPad], const bf16* src,
                                               long long row_stride, int row0, int S) {
  for (int i = threadIdx.x; i < 64 * (kDh / 8); i += kThreads) {
    const int r = i / (kDh / 8);
    const int c = (i % (kDh / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S) {
      v = *reinterpret_cast<const uint4*>(src + (row0 + r) * row_stride + c);
    }
    *reinterpret_cast<uint4*>(&dst[r][c]) = v;
  }
}

// ---- shared-memory tiles of whole heads, read by ldmatrix ---------------------

constexpr int kRowBytes = kDh * 2;  // one bf16 row of a head: eight 16-byte chunks

__host__ __device__ __forceinline__ int padded_rows(int S) { return (S + 15) / 16 * 16; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices from shared memory; lanes 8i..8i+7 give the row addresses of
// matrix i, and register i of lane l holds row l/4, columns 2(l%4), 2(l%4)+1 of it
// (with .trans: column l/4, rows 2(l%4), 2(l%4)+1).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 16 bytes from global to shared memory without passing through registers; zeros
// where `valid` is false (the source is then not read).
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` (0 or 1) committed groups are still in flight.
__device__ __forceinline__ void cp_async_wait(bool one_pending) {
  if (one_pending) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
}

// Lane offsets of the x4 loads of one 16x16 block (m16n8k16 fragments), with `tile`
// rows of 8 16-byte chunks:
//   A (16 rows x 16 k, k contiguous): row lane & 15, chunk lane >> 4;
//   B stored n-major (16 n x 16 k): row ((lane >> 4) << 3) | (lane & 7), chunk
//     (lane >> 3) & 1; registers 0-1 are b0, b1 of n 0-7, registers 2-3 of n 8-15;
//   B stored k-major (16 k x 16 n), .trans: row (((lane >> 3) & 1) << 3) | (lane & 7),
//     chunk lane >> 4; registers as above.
struct LaneOffsets {
  int a_row, a_chk, n_row, n_chk, k_row, k_chk;
  __device__ __forceinline__ explicit LaneOffsets(int lane)
      : a_row(lane & 15), a_chk(lane >> 4), n_row(((lane >> 4) << 3) | (lane & 7)),
        n_chk((lane >> 3) & 1), k_row((((lane >> 3) & 1) << 3) | (lane & 7)),
        k_chk(lane >> 4) {}
};

// The A fragment (16 x 16) of the f32 accumulators of two n-tiles, rounded to bf16.
__device__ __forceinline__ void pack_a(uint32_t (&x)[4], const float (&f)[2][4]) {
  x[0] = pack_bf16(f[0][0], f[0][1]);
  x[1] = pack_bf16(f[0][2], f[0][3]);
  x[2] = pack_bf16(f[1][0], f[1][1]);
  x[3] = pack_bf16(f[1][2], f[1][3]);
}

// Byte address of 16-byte chunk `c` of row `r` of a head tile at `base`: the chunks of
// a row are permuted by r mod 8, so the eight row addresses of one ldmatrix matrix
// (8 consecutive rows, one logical chunk) fall on eight different bank groups.
__device__ __forceinline__ uint32_t swz(uint32_t base, int r, int c) {
  return base + r * kRowBytes + ((c ^ (r & 7)) << 4);
}

// Rows [r0, r1) of one head into a swizzled tile with cp.async, by `n_threads` threads;
// rows past S are zero. The caller commits and waits.
__device__ __forceinline__ void load_rows_async(uint32_t dst, const bf16* src, long long stride,
                                                int r0, int r1, int S, int n_threads) {
  for (int i = r0 * (kDh / 8) + threadIdx.x; i < r1 * (kDh / 8); i += n_threads) {
    const int r = i >> 3;
    const int c = i & 7;
    const bool ok = r < S;
    cp_async_16(swz(dst, r, c), ok ? src + r * stride + c * 8 : src, ok);
  }
}

// Rows [0, Sp) of one head into a swizzled tile with cp.async; rows past S are zero.
template <int kThreads>
__device__ __forceinline__ void load_head_async(uint32_t dst, const bf16* src, long long stride,
                                                int S, int Sp) {
  load_rows_async(dst, src, stride, 0, Sp, S, kThreads);
}

// The A fragments (4 k-steps over dh) of the 16 rows at `row0` of a head tile.
__device__ __forceinline__ void head_a_frags(uint32_t (&x)[4][4], uint32_t tile, int row0,
                                             const LaneOffsets& lo) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) ldsm_x4(x[ks], swz(tile, row0 + lo.a_row, 2 * ks + lo.a_chk));
}

// acc[16 x 64] += X (the A fragment of 16 x 16) * the 16 rows at `row0` of tile y
// (contracting over those rows; fragments from ldmatrix.trans).
__device__ __forceinline__ void product_rows(float (&acc)[8][4], const uint32_t (&x)[4],
                                             uint32_t y, int row0, const LaneOffsets& lo) {
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    uint32_t yb[4];
    ldsm_x4_trans(yb, swz(y, row0 + lo.k_row, 2 * np + lo.k_chk));
    mma_bf16_16816(acc[2 * np], x, yb[0], yb[1]);
    mma_bf16_16816(acc[2 * np + 1], x, yb[2], yb[3]);
  }
}

// s[16 x 16] = X Y^T for one 16-row block: the A fragments x (4 k-steps over dh) and
// the 16 rows of tile y at `row` (this lane's n-major ldmatrix row): two n-tiles.
__device__ __forceinline__ void scores_16(float (&s)[2][4], const uint32_t (&x)[4][4],
                                          uint32_t y, int row, const LaneOffsets& lo) {
#pragma unroll
  for (int j = 0; j < 2; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t yb[4];
    ldsm_x4(yb, swz(y, row, 2 * ks + lo.n_chk));
    mma_bf16_16816(s[0], x[ks], yb[0], yb[1]);
    mma_bf16_16816(s[1], x[ks], yb[2], yb[3]);
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
}

// 2^x from the special function unit (relative error ~2^-22; subnormal results flush
// to zero).
__device__ __forceinline__ float ex2(float x) {
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(x));
  return e;
}

// Four consecutive lanes widened to float32 (16-byte load for float, 8-byte for bf16).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Four consecutive lanes stored in the operand's type (bf16: rounded to nearest).
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(bf16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

}  // namespace attn
