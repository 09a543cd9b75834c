// Fused weight and bias gradient of a dense layer, for Hopper (sm_90a):
//   dW = x^T g   [Din, Dout] float32      db = sum over rows of g   [Dout] float32
// from x [N, Din] and g [N, Dout], both row-major, both bfloat16 or both float32.
//
// Replaces the TPU kernel `_dw_db_kernel` in vit_project_tpu/ops/fused_dw.py (reached
// through `dw_db_pallas` and the custom VJP `dense_dw_fused`). It computes what that
// kernel computes, with these differences of form:
//   - N, Din and Dout are arbitrary: ragged edges read as zero and are never written
//     (the TPU version zero-pads the operands to tile multiples instead);
//   - dW comes out as [Din, Dout], as there. It is never rounded to bfloat16.
//
// Design. The reduction runs over the rows N (50,432 = 256 x 197 at the ViT-B/16
// training step), so both operands are read "transposed" against their storage.
//   - Grid (Dout tile, Din tile, split of the rows). A block owns one 128 x 128 tile of
//     dW (bf16) or 64 x 64 (f32) and loops over its share of the rows in steps of 32
//     (bf16) or 16 (f32). The TPU keeps one accumulator resident over a sequential
//     grid; here blocks run in parallel and nothing carries between them.
//   - Splitting the rows gives enough blocks to fill the 132 SMs (the 768 x 768 output
//     projection has only 36 tiles of 128 x 128). Each split writes its own float32
//     partial of dW and db, and a second kernel sums the partials in split order.
//     No float atomics: two launches give identical bits (a resumed run depends on it).
//   - db is summed by the blocks of the first Din tile only (the TPU's `ji == 0` rule),
//     from the g tile already in shared memory, never once per Din tile.
//   - bf16: 8 warps, each owning 64 x 32 of the tile, run mma.sync m16n8k16 (bf16 in,
//     f32 accumulate). Both operands are staged row-major in shared memory by 16-byte
//     cp.async copies (double buffered) and turned into fragments by ldmatrix.trans.
//   - f32: the tensor cores have no exact f32 product, so 256 threads each own 4 x 4
//     outputs and compute them with FMAs from shared memory.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s dense bf16; NVIDIA's data sheet): for the
// MLP's fc1 at the training step, x [50432, 768] and g [50432, 3072] bf16, the kernel
// must read 387 MB and write 9 MB (0.12 ms), against 2 N Din Dout = 239 GFLOP (0.24 ms):
// it is bound by operations. chip_smoke.py recomputes the bound for each shape.
//
// Speed is left to later work: wgmma on TMA-loaded tiles, a deeper pipeline, and a
// persistent schedule in place of the split and its second pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- bfloat16: tensor cores ------------------------------------------------------------

constexpr int kBM = 128;     // dW rows (Din) per block
constexpr int kBN = 128;     // dW columns (Dout) per block
constexpr int kBK = 32;      // input rows (N) per pipeline stage
constexpr int kPad = 8;      // bf16 row padding: 272-byte rows, conflict-free ldmatrix
constexpr int kThreads = 256;

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* smem_row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Stage rows [r0, r0 + kBK) x columns [c0, c0 + kCols) of a row-major [N, D] bf16 matrix
// into dst. A 16-byte chunk inside the matrix goes by cp.async when `vec` (D % 8 == 0 and
// a 16-byte aligned base), else element by element; anything outside reads as zero.
template <int kCols>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16 (*dst)[kCols + kPad],
                                           const __nv_bfloat16* src, int N, int D, int r0,
                                           int r_end, int c0, bool vec) {
  constexpr int kChunks = kCols / 8;
  for (int i = threadIdx.x; i < kBK * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const int row = r0 + r;
    const int col = c0 + c;
    __nv_bfloat16* d = &dst[r][c];
    if (row < r_end && col < D) {
      const __nv_bfloat16* s = src + (long)row * D + col;
      if (vec) {
        cp_async_16(d, s);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) d[e] = (col + e < D) ? s[e] : __float2bfloat16(0.f);
      }
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// out points at this split's [Din * Dout + Dout] float32 slab: dW row-major, then db.
__global__ void __launch_bounds__(kThreads)
dw_db_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
                  float* __restrict__ out, int N, int Din, int Dout, int rows_per_split,
                  int vec_x, int vec_g) {
  __shared__ __align__(16) __nv_bfloat16 xs[2][kBK][kBM + kPad];
  __shared__ __align__(16) __nv_bfloat16 gs[2][kBK][kBN + kPad];

  const int n0 = blockIdx.x * kBN;  // first dW column (Dout)
  const int m0 = blockIdx.y * kBM;  // first dW row (Din)
  const int split = blockIdx.z;
  const int r_begin = split * rows_per_split;
  const int r_end = min(N, r_begin + rows_per_split);
  float* slab = out + (long)split * ((long)Din * Dout + Dout);
  const bool do_db = blockIdx.y == 0;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp >> 2;  // 2 warps along Din: 64 rows each
  const int wn = warp & 3;   // 4 warps along Dout: 32 columns each
  const int lg = lane >> 2;  // fragment row group
  const int lt = lane & 3;   // thread in group
  const int lmat = lane >> 3;  // which 8x8 matrix of an ldmatrix.x4 this lane addresses
  const int lrow = lane & 7;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  float db_acc = 0.f;  // column threadIdx.x of this block's Dout tile (threads < kBN)

  const int n_steps = r_end > r_begin ? (r_end - r_begin + kBK - 1) / kBK : 0;
  if (n_steps > 0) {
    stage_bf16<kBM>(xs[0], x, N, Din, r_begin, r_end, m0, vec_x);
    stage_bf16<kBN>(gs[0], g, N, Dout, r_begin, r_end, n0, vec_g);
  }
  cp_async_commit();

  for (int step = 0; step < n_steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < n_steps) {
      const int r0 = r_begin + (step + 1) * kBK;
      stage_bf16<kBM>(xs[buf ^ 1], x, N, Din, r0, r_end, m0, vec_x);
      stage_bf16<kBN>(gs[buf ^ 1], g, N, Dout, r0, r_end, n0, vec_g);
    }
    cp_async_commit();
    cp_async_wait_one();  // this step's stage has landed
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      // A[m][k] = xs[k][m]: matrices (k 0-7, m 0-7), (k 0-7, m 8-15), (k 8-15, m 0-7),
      // (k 8-15, m 8-15) give the four A registers of m16n8k16.
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int k = kk + (lmat >> 1) * 8 + lrow;
        const int m = wm * 64 + mt * 16 + (lmat & 1) * 8;
        ldmatrix_x4_trans(a[mt], &xs[buf][k][m]);
      }
      // B[k][n] = gs[k][n]: matrices (k 0-7, n), (k 8-15, n), (k 0-7, n+8), (k 8-15, n+8)
      // give the B registers of two neighbouring n-tiles of 8.
      uint32_t b[2][4];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int k = kk + (lmat & 1) * 8 + lrow;
        const int n = wn * 32 + np * 16 + (lmat >> 1) * 8;
        ldmatrix_x4_trans(b[np], &gs[buf][k][n]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const uint32_t* bp = b[nt >> 1] + (nt & 1) * 2;
          mma_bf16_16816(acc[mt][nt], a[mt], bp[0], bp[1]);
        }
    }
    if (do_db && threadIdx.x < kBN) {
#pragma unroll 8
      for (int k = 0; k < kBK; ++k) db_acc += __bfloat162float(gs[buf][k][threadIdx.x]);
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  // dW: accumulator (row lg, cols 2lt, 2lt+1) and (row lg + 8, same cols) of each tile
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 64 + mt * 16 + lg + half * 8;
      if (m >= Din) continue;
      float* row = slab + (long)m * Dout;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + wn * 32 + nt * 8 + lt * 2;
        if (n < Dout) row[n] = acc[mt][nt][half * 2];
        if (n + 1 < Dout) row[n + 1] = acc[mt][nt][half * 2 + 1];
      }
    }
  if (do_db && threadIdx.x < kBN && n0 + threadIdx.x < Dout) {
    slab[(long)Din * Dout + n0 + threadIdx.x] = db_acc;
  }
}

// ---- float32: scalar FMAs --------------------------------------------------------------

constexpr int kFT = 64;   // dW tile edge
constexpr int kFK = 16;   // input rows per step

__global__ void __launch_bounds__(kThreads)
dw_db_f32_kernel(const float* __restrict__ x, const float* __restrict__ g,
                 float* __restrict__ out, int N, int Din, int Dout, int rows_per_split) {
  __shared__ float xs[kFK][kFT];
  __shared__ float gs[kFK][kFT];

  const int n0 = blockIdx.x * kFT;
  const int m0 = blockIdx.y * kFT;
  const int split = blockIdx.z;
  const int r_begin = split * rows_per_split;
  const int r_end = min(N, r_begin + rows_per_split);
  float* slab = out + (long)split * ((long)Din * Dout + Dout);
  const bool do_db = blockIdx.y == 0;
  const int tx = threadIdx.x & 15;  // columns tx + 16 j
  const int ty = threadIdx.x >> 4;  // rows ty + 16 i

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float db_acc = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += kFK) {
    __syncthreads();
    for (int i = threadIdx.x; i < kFK * kFT; i += kThreads) {
      const int r = i / kFT;
      const int c = i % kFT;
      const int row = r0 + r;
      xs[r][c] = (row < r_end && m0 + c < Din) ? x[(long)row * Din + m0 + c] : 0.f;
      gs[r][c] = (row < r_end && n0 + c < Dout) ? g[(long)row * Dout + n0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = gs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (do_db && threadIdx.x < kFT) {
#pragma unroll
      for (int k = 0; k < kFK; ++k) db_acc += gs[k][threadIdx.x];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= Din) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < Dout) slab[(long)m * Dout + n] = acc[i][j];
    }
  }
  if (do_db && threadIdx.x < kFT && n0 + threadIdx.x < Dout) {
    slab[(long)Din * Dout + n0 + threadIdx.x] = db_acc;
  }
}

// ---- the second pass: sum the splits' partials in split order --------------------------

__global__ void sum_splits_kernel(const float* __restrict__ parts, float* __restrict__ out,
                                  long len, int splits) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < len;
       i += (long)gridDim.x * blockDim.x) {
    float s = parts[i];
    for (int k = 1; k < splits; ++k) s += parts[(long)k * len + i];
    out[i] = s;
  }
}

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// out: [Din * Dout + Dout] float32, dW row-major then db. With splits > 1, `parts` is a
// scratch of splits * (Din * Dout + Dout) float32 that the first pass fills and the second
// sums into `out`; with splits == 1 the first pass writes `out` directly and `parts` is
// unused. Launches on `stream` and returns the first cudaError_t (0 on success).
extern "C" int dw_db(const void* x, const void* g, void* out, void* parts, int N, int Din,
                     int Dout, int splits, int dtype, void* stream) {
  if (N <= 0 || Din <= 0 || Dout <= 0 || splits <= 0) return (int)cudaErrorInvalidValue;
  if (splits > 1 && parts == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  float* first = splits > 1 ? static_cast<float*>(parts) : static_cast<float*>(out);
  if (dtype == 1) {
    const int steps = (N + kBK - 1) / kBK;
    const int rows_per_split = ((steps + splits - 1) / splits) * kBK;
    const dim3 grid((Dout + kBN - 1) / kBN, (Din + kBM - 1) / kBM, splits);
    const int vec_x = (Din % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
    const int vec_g = (Dout % 8 == 0) && (reinterpret_cast<uintptr_t>(g) % 16 == 0);
    dw_db_bf16_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g), first, N,
        Din, Dout, rows_per_split, vec_x, vec_g);
  } else if (dtype == 0) {
    const int steps = (N + kFK - 1) / kFK;
    const int rows_per_split = ((steps + splits - 1) / splits) * kFK;
    const dim3 grid((Dout + kFT - 1) / kFT, (Din + kFT - 1) / kFT, splits);
    dw_db_f32_kernel<<<grid, kThreads, 0, st>>>(static_cast<const float*>(x),
                                                 static_cast<const float*>(g), first, N, Din,
                                                 Dout, rows_per_split);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long len = (long)Din * Dout + Dout;
  const int blocks = (int)((len + 255) / 256 < 132 * 8 ? (len + 255) / 256 : 132 * 8);
  sum_splits_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(parts),
                                            static_cast<float*>(out), len, splits);
  return (int)cudaGetLastError();
}
