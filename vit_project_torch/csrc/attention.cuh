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
