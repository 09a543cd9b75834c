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
// Replaces the TPU kernels `_ln_fwd_kernel` and `_ln_bwd_kernel` in
// vit_project_tpu/ops/layernorm.py (reached through `layer_norm_fused`). Differences of form:
//   - no padded copy of x or dy: rows >= N are masked here (the TPU version pads N up to its
//     256-row grid blocks and zeroes the padded rows);
//   - mean and rstd are [N] f32 (there [Np, 1]);
//   - the per-block partials of dscale and dbias are [n_b, 2D] f32, one row per block of
//     `rows` rows (there two [8 * ceil(n_b / 8), D] arrays, one row per 256 rows), and a
//     second kernel of this file sums them.
//
// Bound. Both kernels move each element of x, y, dy, dx once and do 8-12 flops per element:
// at the ViT-B/16 step (N = 50,432, D = 768, bf16) the forward moves 155 MB (0.046 ms at
// 3.35 TB/s) against 0.3 GFLOP of f32 work (0.005 ms at 67 TFLOP/s): bytes bind, so the
// design reads and writes each element once and keeps everything else in registers.
//
// Design.
//   - A block is 8 warps. A row is read by WPR warps (1 for D <= 1024, 2 up to 2048, 4 up
//     to 4096), each thread owning VPL chunks of 8 consecutive columns, loaded and stored
//     with 16-byte (bf16) or 2 x 16-byte (f32) vector accesses. The row stays in registers
//     between its two reductions; a row sum is a warp butterfly, and across the WPR warps of
//     a row a fixed-order sum through shared memory (double buffered: one barrier per sum).
//   - Forward: one row per row group, 8 / WPR rows per block.
//   - Backward: one block per `rows` rows (a multiple of 8, chosen by the caller: 256 where
//     that gives enough blocks to fill the card, fewer for small N), each row group taking
//     every (8 / WPR)-th of them.
//     Each thread keeps its columns' sums of dy * xhat and dy in registers across its rows;
//     at the end the row groups are added in group order through shared memory and the
//     block writes one partial row. A second kernel sums the partials over the blocks
//     (warp w takes blocks w, w + 8, ... in order, then the 8 warps are added in order).
//   - No float atomics anywhere: repeat launches give the same bits.
//   - rstd is 1.f / sqrtf(var + eps): IEEE square root and division (nvcc's defaults), two
//     correct roundings, not the approximate rsqrtf.
//
// Speed is left to later work: prefetch of the next row's loads in the backward, and fewer
// registers in the backward (161 at D = 1,024 in f32 leave one block of 8 warps per SM).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

// ---- row sums --------------------------------------------------------------------------

// Sums each of v[0..NV) over the row: a butterfly in the warp (every lane ends with the same
// bits), then, for WPR > 1, the row's WPR warp sums in warp order through `red`
// ([2][NV][kWarps] floats, alternated by `parity`). Every thread of the block must call this
// the same number of times, in step.
template <int WPR, int NV>
__device__ __forceinline__ void row_sums(float (&v)[NV], float* red, int& parity) {
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
    __syncthreads();
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
  const int t = (warp % WPR) * 32 + (threadIdx.x & 31);  // thread within the row's group
  const int row = blockIdx.x * kGroups + warp / WPR;
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
  row_sums<WPR, 1>(s, red, parity);
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
  row_sums<WPR, 1>(q, red, parity);
  const float rs = 1.f / sqrtf(q[0] / D + eps);

  if (!live) return;  // no barrier follows
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

// sc: [D] f32. parts: [gridDim.x][2D] f32, the sums of dy * xhat then of dy over this
// block's `rows` rows (a multiple of 8). Dynamic shared memory: 2D floats, where the row
// groups' sums meet.
template <typename T, int WPR, int VPL>
__global__ void __launch_bounds__(kThreads)
ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ sc,
              const float* __restrict__ mean, const float* __restrict__ rstd,
              const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ parts, int N,
              int D, int rows) {
  __shared__ float red[2 * 2 * kWarps];
  extern __shared__ float4 meet4[];
  float* meet = reinterpret_cast<float*>(meet4);
  constexpr int kGroups = kWarps / WPR;  // rows in flight per block
  const int warp = threadIdx.x >> 5;
  const int group = warp / WPR;
  const int t = (warp % WPR) * 32 + (threadIdx.x & 31);
  int parity = 0;

  float a_sc[VPL][8], a_bi[VPL][8];  // this thread's columns: sums of dy * xhat and of dy
#pragma unroll
  for (int i = 0; i < VPL; ++i)
#pragma unroll
    for (int k = 0; k < 8; ++k) a_sc[i][k] = a_bi[i][k] = 0.f;

  // the same trip count in every group (rows / kGroups): row_sums needs them in step
  for (int j = group; j < rows; j += kGroups) {
    const int row = blockIdx.x * rows + j;
    const bool live = row < N;
    const float mu = live ? mean[row] : 0.f;
    const float rs = live ? rstd[row] : 0.f;
    const long off = (long)row * D;
    float xh[VPL][8], d[VPL][8];
    float s[2] = {0.f, 0.f};  // sums of g and of g * xhat
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = (t + i * 32 * WPR) * 8;
      if (live && c < D) {
        float w[8];
        load8(x + off + c, xh[i]);
        load8(dy + off + c, d[i]);
        load8(sc + c, w);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          xh[i][k] = (xh[i][k] - mu) * rs;
          const float g = d[i][k] * w[k];
          s[0] += g;
          s[1] += g * xh[i][k];
        }
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) xh[i][k] = d[i][k] = 0.f;
      }
    }
    row_sums<WPR, 2>(s, red, parity);
    if (!live) continue;  // no barrier in the rest of the iteration
    const float m1 = s[0] / D;
    const float m2 = s[1] / D;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = (t + i * 32 * WPR) * 8;
      if (c < D) {
        float w[8], o[8];
        load8(sc + c, w);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          o[k] = (d[i][k] * w[k] - m1 - xh[i][k] * m2) * rs;
          a_sc[i][k] += d[i][k] * xh[i][k];
          a_bi[i][k] += d[i][k];
        }
        store8(dx + off + c, o);
      }
    }
  }

  // the row groups' sums, added in group order; the last group writes the block's partial
  float* part = parts + (long)blockIdx.x * 2 * D;
  for (int gg = 0; gg < kGroups; ++gg) {
    if (group == gg) {
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int c = (t + i * 32 * WPR) * 8;
        if (c >= D) continue;
        if (gg > 0) {
          float ps[8], pb[8];
          load8(meet + c, ps);
          load8(meet + D + c, pb);
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            a_sc[i][k] = ps[k] + a_sc[i][k];
            a_bi[i][k] = pb[k] + a_bi[i][k];
          }
        }
        if (gg == kGroups - 1) {
          store8(part + c, a_sc[i]);
          store8(part + D + c, a_bi[i]);
        } else {
          store8(meet + c, a_sc[i]);
          store8(meet + D + c, a_bi[i]);
        }
      }
    }
    __syncthreads();
  }
}

// out[c] = sum over b of parts[b][c], c < width: block = 32 columns x 8 warps; warp w adds
// blocks w, w + 8, ... in order, then warp 0 adds the 8 warps' sums in order.
__global__ void __launch_bounds__(kThreads)
ln_sum_parts_kernel(const float* __restrict__ parts, float* __restrict__ out, int n_b,
                    int width) {
  __shared__ float sums[kWarps][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (c < width) {
#pragma unroll 4
    for (int b = warp; b < n_b; b += kWarps) acc += parts[(long)b * width + c];
  }
  sums[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && c < width) {
    float s = sums[0][lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += sums[w][lane];
    out[c] = s;
  }
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

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16. Every pointer is
// 16-byte aligned, every array contiguous, D a multiple of 8 in [8, 4096], N > 0. Launches on
// `stream` and returns the first cudaError_t (0 on success).

// x, y: [N, D]; scale, bias: [D] f32; mean, rstd: [N] f32.
extern "C" int ln_fwd(const void* x, const void* scale, const void* bias, void* y, void* mean,
                      void* rstd, int N, int D, float eps, int dtype, void* stream) {
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

// x, dy, dx: [N, D]; sc: [D] f32; mean, rstd: [N] f32; rows: rows per block, a positive
// multiple of 8; parts: [ceil(N / rows), 2D] f32 scratch; dsb: [2D] f32 out, dscale then dbias.
extern "C" int ln_bwd(const void* x, const void* sc, const void* mean, const void* rstd,
                      const void* dy, void* dx, void* parts, void* dsb, int N, int D, int rows,
                      int dtype, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int n_b = rows > 0 ? (N + rows - 1) / rows : 0;
  auto launch = [&](auto t, auto wpr, auto vpl) {
    using T = decltype(t);
    ln_bwd_kernel<T, decltype(wpr)::value, decltype(vpl)::value>
        <<<n_b, kThreads, 2 * D * sizeof(float), st>>>(
            static_cast<const T*>(x), static_cast<const float*>(sc),
            static_cast<const float*>(mean), static_cast<const float*>(rstd),
            static_cast<const T*>(dy), static_cast<T*>(dx), static_cast<float*>(parts), N, D,
            rows);
  };
  if (N <= 0 || rows <= 0 || rows % 8 != 0 || !dispatch(dtype, D, launch))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ln_sum_parts_kernel<<<(2 * D + 31) / 32, kThreads, 0, st>>>(
      static_cast<const float*>(parts), static_cast<float*>(dsb), n_b, 2 * D);
  return (int)cudaGetLastError();
}
