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
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s dense bf16, 67 TFLOP/s f32 FMA; NVIDIA's
// data sheet): for the MLP's fc1 at the ViT-B/16 training step, x [50432, 768] and
// g [50432, 3072] bf16, the kernel must read 387 MB and write 9 MB (0.12 ms), against
// 2 N Din Dout = 239 GFLOP (0.24 ms): it is bound by operations, in f32 too (3.6 ms).
// chip_smoke.py recomputes the bound for each shape.
//
// Schedule (every route). The reduction runs over the rows N (50,432 at the ViT step)
// and there are few dW tiles (fc1: 72 of 128 x 256), so the rows of each tile are cut
// into `splits` equal ranges of whole row steps. A work item is (split, tile); items are
// numbered split-major (item = split * tiles + tile) and a persistent grid of
// min(blocks, items) blocks takes items b, b + blocks, b + 2 blocks, ... Each item writes
// a float32 partial of its tile and of db to its own slot, and a fix-up kernel sums each
// tile's partials in split order (db's in split, then Din-tile order). No float atomics:
// the cuts depend only on (N, Din, Dout, dtype), so every launch gives the same bits. The
// wrapper (ops/fused_dw.py `schedule`) picks `splits` from the shape: the fewest waves of
// items times the item's length plus a fixed cost for its start and partial.
// Split-major order keeps the blocks that run at once on the same rows, so each row of x
// and g comes from device memory about once and then from L2 for the other tiles of its
// split. Equal contiguous ranges of (tile, row step) per block, with no wave tail, would
// start every block on other rows: at fc1 each block would stream its own 48 KB a step,
// 2.7 GB in all, 0.8 ms at the memory rate, where the products take 0.24. The split
// costs a wave tail instead (fc1: 360 items on 132 blocks, 91% of 3 waves).
//
// db. The items of one Dout tile load the same g tiles, so they share its sum: the item
// of Din tile tm adds the rows [bk tm / tiles_m, bk (tm + 1) / tiles_m) of every step.
// (Summing db only in the items of Din tile 0, as the TPU kernel's `ji == 0` rule does,
// made those items the slowest of every wave: their two db warps held every stage until
// they had read all 64 of its rows.)
//
// Routes, chosen in Python from dtype, shape and pointer alignment (`route`):
//   - "tma" (bf16, Din and Dout multiples of 8, 16-byte aligned bases; every ViT-B/16
//     shape): 128 x 256 dW tiles, 64 rows a step. One producer warp loads 64-row x 64-
//     column boxes of x and g by TMA (128-byte swizzle) into a ring of kStages stages
//     guarded by mbarriers. Two consumer warpgroups each run wgmma m64n256k16 on the
//     tiles in place: A[m][k] = x[k][m] and B[k][n] = g[k][n] are both MN-major, which
//     wgmma reads with its transpose bits set, so nothing is transposed. f32
//     accumulators stay in registers (setmaxnreg: 224 a consumer thread, 56 the rest).
//     Two more warps sum db from g's boxes in shared memory (16-byte reads, half the
//     item's rows each, the halves added in a fixed order); a stage is released when
//     all ten of its readers have arrived on its empty barrier.
//   - "mma" (bf16 shapes TMA cannot take: Din or Dout not a multiple of 8, or an
//     unaligned base): 128 x 128 tiles, 32 rows a step, mma.sync m16n8k16 from
//     ldmatrix.trans on cp.async (or element-wise) double-buffered stages.
//   - "fma" (float32; the card has no exact f32 product on the tensor cores, and TF32 or
//     split-bf16 products would change the numbers): a register-tiled SGEMM with exact
//     FMAs. 128 x 128 tiles, 16 rows a step, 256 threads of 8 x 8 outputs, two blocks a
//     SM; a 3-stage cp.async ring (element-wise copies where Din or Dout is not a
//     multiple of 4 or a base is unaligned). Both operands keep the rows N as rows in
//     shared memory, so a thread's 8 rows of A and 8 columns of B are two 16-byte reads
//     each (two runs of 4, 16 or 32 apart, which keeps a warp's reads free of bank
//     conflicts). db: the two halves of the block each sum half the item's rows of a
//     column of g's stage.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

// ---- schedule --------------------------------------------------------------------------

// (dW tile rows, columns, input rows per step, blocks of the persistent grid) by route;
// ops/fused_dw.py ROUTES mirrors these.
constexpr int kRouteFma = 0, kRouteMma = 1, kRouteTma = 2;
constexpr int kTile[3][4] = {{128, 128, 16, 264}, {128, 128, 32, 264}, {128, 256, 64, 132}};

struct Schedule {
  int tiles_n, tiles, steps, steps_per_split, splits, items;
};

__host__ __device__ inline long slot_floats(int bm, int bn) { return (long)bm * bn + bn; }

// The rows of each step whose g values an item of Din tile tm adds to its db partial:
// the items of one Dout tile share their g tiles, so they share the sum too.
__device__ __forceinline__ int db_row(int bk, int tm, int tiles_m) { return bk * tm / tiles_m; }

// ---- shared helpers --------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// ---- bfloat16, route "tma": wgmma on TMA-loaded tiles ----------------------------------

constexpr int kTBM = 128, kTBN = 256, kTBK = 64;
constexpr int kStages = 4;
constexpr int kBoxBytes = 64 * 64 * 2;             // 64 rows x 64 bf16 (one 128-byte row each)
constexpr int kXBoxes = kTBM / 64, kGBoxes = kTBN / 64;
constexpr int kStageBytes = (kXBoxes + kGBoxes) * kBoxBytes;   // 48 KB
constexpr int kTmaThreads = 384;                   // 2 consumer warpgroups + 1 producer
constexpr int kTmaSmem = kStages * kStageBytes + 2 * kStages * 8 + kTBN * 4 + 1024;
// wgmma descriptors for an MN-major operand under the 128-byte swizzle: LBO is the stride
// from one 64-element column block to the next (the next box), SBO from one 8-row group
// to the next (8 rows of 128 bytes). One k16 step advances the start by 16 rows.
constexpr uint32_t kDescLbo = kBoxBytes, kDescSbo = 8 * 128, kDescK16 = 16 * 128;
constexpr int kDbWarp0 = 9;                       // warps 9-10 sum db
// setmaxnreg moves registers within the block's launch allocation, 168 a thread x 384:
// 2 x 128 consumers at 224 and 128 others at 56 use exactly all of it (an increase that
// finds too few free registers waits for ever).
constexpr uint32_t kEmptyArrivals = 8 + 2;         // 8 consumer warps + 2 db warps

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

// Waits for the phase of parity `parity` to complete. A pipeline stalled for good (a
// fault, not a slow stage: one step takes microseconds) traps after 2^26 polls, so the
// launch fails with an error instead of holding the card.
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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row)
      : "memory");
}

__device__ __forceinline__ uint64_t mn_major_desc(const void* smem) {
  return (uint64_t)((smem_u32(smem) & 0x3FFFF) >> 4) | ((uint64_t)(kDescLbo >> 4) << 16) |
         ((uint64_t)(kDescSbo >> 4) << 32) | (1ull << 62);  // layout 1: 128-byte swizzle
}

__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 256] += A[64 x 16] B[16 x 256], bf16 in, f32 accumulate, A and B MN-major.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      "%125, %126, %127}, "
      "%128, %129, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
        "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
        "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
        "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// parts: one slot of kTBM * kTBN + kTBN float32 per item, the tile row-major then db.
__global__ void __launch_bounds__(kTmaThreads, 1)
dw_db_tma_kernel(const __grid_constant__ CUtensorMap tmap_x,
                 const __grid_constant__ CUtensorMap tmap_g, float* __restrict__ parts,
                 Schedule sc) {
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: boxes start on a 1024-byte boundary
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kEmptyArrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // ---- producer warpgroup: warp 8 loads, warps 9-10 sum db, warp 11 idles ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    if (warp == 8) {
      if (lane == 0) {
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tmap_x))
                     : "memory");
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tmap_g))
                     : "memory");
        int stage = 0;
        uint32_t phase = 0;
        for (int item = blockIdx.x; item < sc.items; item += gridDim.x) {
          const int split = item / sc.tiles, tile = item % sc.tiles;
          const int m0 = (tile / sc.tiles_n) * kTBM, n0 = (tile % sc.tiles_n) * kTBN;
          const int s0 = split * sc.steps_per_split;
          const int s1 = min(s0 + sc.steps_per_split, sc.steps);
          for (int s = s0; s < s1; ++s) {
            mbar_wait(&empty[stage], phase ^ 1);
            mbar_expect_tx(&full[stage], kStageBytes);
            uint8_t* base = smem + stage * kStageBytes;
#pragma unroll
            for (int b = 0; b < kXBoxes; ++b)
              tma_load_2d(base + b * kBoxBytes, &tmap_x, &full[stage], m0 + 64 * b, s * kTBK);
#pragma unroll
            for (int b = 0; b < kGBoxes; ++b)
              tma_load_2d(base + (kXBoxes + b) * kBoxBytes, &tmap_g, &full[stage],
                          n0 + 64 * b, s * kTBK);
            if (++stage == kStages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    } else if (warp == kDbWarp0 || warp == kDbWarp0 + 1) {
      // db: lane l owns columns 8 l .. 8 l + 7, one 16-byte chunk of g's box l / 8. A box
      // row is 128 bytes whose chunks the swizzle permutes: chunk c of row r sits at
      // chunk c ^ (r % 8).
      const int h = warp - kDbWarp0;
      const int box = lane >> 3, chunk = lane & 7;
      const int tiles_m = sc.tiles / sc.tiles_n;
      float* scratch = reinterpret_cast<float*>(empty + kStages);   // [kTBN]
      int stage = 0;
      uint32_t phase = 0;
      for (int item = blockIdx.x; item < sc.items; item += gridDim.x) {
        const int split = item / sc.tiles, tm = (item % sc.tiles) / sc.tiles_n;
        const int s0 = split * sc.steps_per_split;
        const int s1 = min(s0 + sc.steps_per_split, sc.steps);
        // this item's rows of each step, [lo, hi), halved between the two warps
        const int lo = db_row(kTBK, tm, tiles_m), hi = db_row(kTBK, tm + 1, tiles_m);
        const int r0 = h == 0 ? lo : (lo + hi) / 2, r1 = h == 0 ? (lo + hi) / 2 : hi;
        float acc[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = 0.f;
        for (int s = s0; s < s1; ++s) {
          mbar_wait(&full[stage], phase);
          {
            const uint32_t b =
                smem_u32(smem + stage * kStageBytes + (kXBoxes + box) * kBoxBytes);
#pragma unroll 4
            for (int r = r0; r < r1; ++r) {
              uint32_t v[4];
              asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                           : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
                           : "r"(b + r * 128 + ((chunk ^ (r & 7)) << 4)));
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                acc[2 * i] += __uint_as_float(v[i] << 16);
                acc[2 * i + 1] += __uint_as_float(v[i] & 0xffff0000u);
              }
            }
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[stage]);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
        // the two halves of each column, added in a fixed order
        if (h == 1) {
#pragma unroll
          for (int i = 0; i < 8; ++i) scratch[8 * lane + i] = acc[i];
        }
        asm volatile("bar.sync 1, 64;\n" ::: "memory");
        if (h == 0) {
          float* slot = parts + (long)item * slot_floats(kTBM, kTBN) + kTBM * kTBN;
#pragma unroll
          for (int i = 0; i < 8; ++i) slot[8 * lane + i] = acc[i] + scratch[8 * lane + i];
        }
        asm volatile("bar.sync 1, 64;\n" ::: "memory");
      }
    }
  } else {
    // ---- consumer warpgroups: wg 0 takes dW rows 0-63 of the tile, wg 1 rows 64-127 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    const int wg = warp >> 2;
    float acc[128];
    int stage = 0;
    uint32_t phase = 0;
    for (int item = blockIdx.x; item < sc.items; item += gridDim.x) {
      const int split = item / sc.tiles;
      const int s0 = split * sc.steps_per_split;
      const int s1 = min(s0 + sc.steps_per_split, sc.steps);
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      int prev = -1;
      for (int s = s0; s < s1; ++s) {
        mbar_wait(&full[stage], phase);
        const uint8_t* base = smem + stage * kStageBytes;
        const uint64_t desc_a = mn_major_desc(base + wg * kBoxBytes);
        const uint64_t desc_b = mn_major_desc(base + kXBoxes * kBoxBytes);
        fence_acc(acc);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int k = 0; k < kTBK / 16; ++k)
          wgmma_m64n256k16(acc, desc_a + k * (kDescK16 >> 4), desc_b + k * (kDescK16 >> 4));
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        fence_acc(acc);
        // the step before this one is done with its stage: hand it back to the producer
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        fence_acc(acc);
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(acc);
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);

      // accumulator layout of m64nNk16: warp w of the group holds rows 16 (w % 4) + lane / 4
      // and + 8; register 4 i + {0, 1} is columns 8 i + 2 (lane % 4) + {0, 1}, 4 i + {2, 3}
      // the same columns 8 rows down
      float* slot = parts + (long)item * slot_floats(kTBM, kTBN);
      const int row = wg * 64 + (warp & 3) * 16 + (lane >> 2);
      const int col = (lane & 3) * 2;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        *reinterpret_cast<float2*>(slot + (long)row * kTBN + 8 * i + col) =
            make_float2(acc[4 * i], acc[4 * i + 1]);
        *reinterpret_cast<float2*>(slot + (long)(row + 8) * kTBN + 8 * i + col) =
            make_float2(acc[4 * i + 2], acc[4 * i + 3]);
      }
    }
  }
}

// ---- bfloat16, route "mma": mma.sync where TMA cannot go --------------------------------

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
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(smem_row)));
}

// Stage rows [r0, r0 + kBK) x columns [c0, c0 + kCols) of a row-major [N, D] bf16 matrix
// into dst. A 16-byte chunk inside the matrix goes by cp.async when `vec` (D % 8 == 0 and
// a 16-byte aligned base), else element by element; anything outside reads as zero.
template <int kCols>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16 (*dst)[kCols + kPad],
                                           const __nv_bfloat16* src, int D, int r0,
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
        cp_async_16(d, s, 16);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) d[e] = (col + e < D) ? s[e] : __float2bfloat16(0.f);
      }
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// parts: one slot of kBM * kBN + kBN float32 per item, the tile row-major then db.
__global__ void __launch_bounds__(kThreads)
dw_db_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
                 float* __restrict__ parts, int N, int Din, int Dout, Schedule sc, int vec_x,
                 int vec_g) {
  __shared__ __align__(16) __nv_bfloat16 xs[2][kBK][kBM + kPad];
  __shared__ __align__(16) __nv_bfloat16 gs[2][kBK][kBN + kPad];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp >> 2;  // 2 warps along Din: 64 rows each
  const int wn = warp & 3;   // 4 warps along Dout: 32 columns each
  const int lg = lane >> 2;  // fragment row group
  const int lt = lane & 3;   // thread in group
  const int lmat = lane >> 3;  // which 8x8 matrix of an ldmatrix.x4 this lane addresses
  const int lrow = lane & 7;

  for (int item = blockIdx.x; item < sc.items; item += gridDim.x) {
    const int split = item / sc.tiles, tile = item % sc.tiles;
    const int m0 = (tile / sc.tiles_n) * kBM;  // first dW row (Din)
    const int n0 = (tile % sc.tiles_n) * kBN;  // first dW column (Dout)
    const int s0 = split * sc.steps_per_split;
    const int r_begin = s0 * kBK;
    const int r_end = min(N, min(s0 + sc.steps_per_split, sc.steps) * kBK);
    float* slot = parts + (long)item * slot_floats(kBM, kBN);
    const int tiles_m = sc.tiles / sc.tiles_n, tm = tile / sc.tiles_n;
    const int db_lo = db_row(kBK, tm, tiles_m), db_hi = db_row(kBK, tm + 1, tiles_m);

    float acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
    float db_acc = 0.f;  // column threadIdx.x of this block's Dout tile (threads < kBN)

    const int n_steps = (r_end - r_begin + kBK - 1) / kBK;
    stage_bf16<kBM>(xs[0], x, Din, r_begin, r_end, m0, vec_x);
    stage_bf16<kBN>(gs[0], g, Dout, r_begin, r_end, n0, vec_g);
    cp_async_commit();

    for (int step = 0; step < n_steps; ++step) {
      const int buf = step & 1;
      if (step + 1 < n_steps) {
        const int r0 = r_begin + (step + 1) * kBK;
        stage_bf16<kBM>(xs[buf ^ 1], x, Din, r0, r_end, m0, vec_x);
        stage_bf16<kBN>(gs[buf ^ 1], g, Dout, r0, r_end, n0, vec_g);
      }
      cp_async_commit();
      cp_async_wait<1>();  // this step's stage has landed
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
      if (threadIdx.x < kBN) {
        for (int k = db_lo; k < db_hi; ++k) db_acc += __bfloat162float(gs[buf][k][threadIdx.x]);
      }
      __syncthreads();  // every warp is done with this buffer before it is refilled
    }

    // dW: accumulator (row lg, cols 2lt, 2lt+1) and (row lg + 8, same cols) of each tile
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float* row = slot + (long)(wm * 64 + mt * 16 + lg + half * 8) * kBN;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          *reinterpret_cast<float2*>(row + wn * 32 + nt * 8 + lt * 2) =
              make_float2(acc[mt][nt][half * 2], acc[mt][nt][half * 2 + 1]);
        }
      }
    if (threadIdx.x < kBN) slot[kBM * kBN + threadIdx.x] = db_acc;
  }
}

// ---- float32, route "fma": register-tiled SGEMM -----------------------------------------

constexpr int kFBM = 128, kFBN = 128, kFBK = 16, kFStages = 3;
constexpr int kFStageFloats = kFBK * (kFBM + kFBN);
constexpr int kFSmem = (kFStages * kFStageFloats + 2 * kFBN) * 4;   // 50,176 bytes

// Stage rows [r0, r0 + kFBK) x columns [c0, c0 + 128) of a row-major [N, D] float32 matrix
// into dst [kFBK][128]: 16-byte cp.async copies (zero-filled outside) when kVec, else
// element by element.
template <bool kVec>
__device__ __forceinline__ void stage_f32(float* dst, const float* src, int D, int r0,
                                          int r_end, int c0) {
  for (int i = threadIdx.x; i < kFBK * 32; i += kThreads) {
    const int r = i >> 5, c = (i & 31) * 4;
    const int row = r0 + r, col = c0 + c;
    float* d = dst + r * 128 + c;
    if (kVec) {
      const bool in = row < r_end && col < D;
      cp_async_16(d, in ? src + (long)row * D + col : src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        d[e] = (row < r_end && col + e < D) ? src[(long)row * D + col + e] : 0.f;
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
dw_db_fma_kernel(const float* __restrict__ x, const float* __restrict__ g,
                 float* __restrict__ parts, int N, int Din, int Dout, Schedule sc) {
  extern __shared__ float fsmem[];
  float* dbs = fsmem + kFStages * kFStageFloats;   // [2][kFBN]: the two halves of db

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // warp (wm, wn) owns rows 32 wm .. +32 and columns 64 wn .. +64 of the tile; its lane
  // (ty, tx) owns rows am + {0..3, 16..19} and columns bn + {0..3, 32..35}
  const int am = (warp >> 1) * 32 + (lane >> 3) * 4;
  const int bn = (warp & 1) * 64 + (lane & 7) * 4;
  const int dcol = threadIdx.x & (kFBN - 1), dhalf = threadIdx.x >> 7;

  for (int item = blockIdx.x; item < sc.items; item += gridDim.x) {
    const int split = item / sc.tiles, tile = item % sc.tiles;
    const int m0 = (tile / sc.tiles_n) * kFBM, n0 = (tile % sc.tiles_n) * kFBN;
    const int s0 = split * sc.steps_per_split;
    const int r_begin = s0 * kFBK;
    const int r_end = min(N, min(s0 + sc.steps_per_split, sc.steps) * kFBK);
    const int n_steps = (r_end - r_begin + kFBK - 1) / kFBK;
    // this item's rows of each step for db, [lo, hi), halved between the two thread halves
    const int tiles_m = sc.tiles / sc.tiles_n, tm = tile / sc.tiles_n;
    const int lo = db_row(kFBK, tm, tiles_m), hi = db_row(kFBK, tm + 1, tiles_m);
    const int db_r0 = dhalf == 0 ? lo : (lo + hi) / 2, db_r1 = dhalf == 0 ? (lo + hi) / 2 : hi;

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    float db_acc = 0.f;

#pragma unroll
    for (int p = 0; p < kFStages - 1; ++p) {
      if (p < n_steps) {
        float* st = fsmem + p * kFStageFloats;
        stage_f32<kVec>(st, x, Din, r_begin + p * kFBK, r_end, m0);
        stage_f32<kVec>(st + kFBK * kFBM, g, Dout, r_begin + p * kFBK, r_end, n0);
      }
      cp_async_commit();
    }
    for (int step = 0; step < n_steps; ++step) {
      cp_async_wait<kFStages - 2>();  // this step's stage has landed
      __syncthreads();                // and every thread is done with the one refilled next
      const int next = step + kFStages - 1;
      if (next < n_steps) {
        float* st = fsmem + (next % kFStages) * kFStageFloats;
        stage_f32<kVec>(st, x, Din, r_begin + next * kFBK, r_end, m0);
        stage_f32<kVec>(st + kFBK * kFBM, g, Dout, r_begin + next * kFBK, r_end, n0);
      }
      cp_async_commit();

      const float* xs = fsmem + (step % kFStages) * kFStageFloats;
      const float* gs = xs + kFBK * kFBM;
#pragma unroll
      for (int k = 0; k < kFBK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(xs + k * kFBM + am);
        const float4 a1 = *reinterpret_cast<const float4*>(xs + k * kFBM + am + 16);
        const float4 b0 = *reinterpret_cast<const float4*>(gs + k * kFBN + bn);
        const float4 b1 = *reinterpret_cast<const float4*>(gs + k * kFBN + bn + 32);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      for (int k = db_r0; k < db_r1; ++k) db_acc += gs[k * kFBN + dcol];
    }

    float* slot = parts + (long)item * slot_floats(kFBM, kFBN);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float* row = slot + (long)(am + (i & 3) + (i >> 2) * 16) * kFBN;
      *reinterpret_cast<float4*>(row + bn) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(row + bn + 32) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
    dbs[dhalf * kFBN + dcol] = db_acc;
    __syncthreads();  // the ring and dbs are free again before the next item stages
    if (threadIdx.x < kFBN) {
      slot[kFBM * kFBN + threadIdx.x] = dbs[threadIdx.x] + dbs[kFBN + threadIdx.x];
    }
  }
}

// ---- the fix-up: each tile's partials summed in split order -----------------------------

// grid (chunks, tiles); out is dW [Din, Dout] row-major then db [Dout]
__global__ void dw_db_fixup_kernel(const float* __restrict__ parts, float* __restrict__ out,
                                   int Din, int Dout, int bm, int bn, Schedule sc,
                                   int vec_out) {
  const int tile = blockIdx.y;
  const int m0 = (tile / sc.tiles_n) * bm, n0 = (tile % sc.tiles_n) * bn;
  const long slot = slot_floats(bm, bn);
  const float* first = parts + (long)tile * slot;
  const long split_stride = (long)sc.tiles * slot;
  const int quads = bm * bn / 4;
  for (int q = blockIdx.x * blockDim.x + threadIdx.x; q < quads; q += gridDim.x * blockDim.x) {
    const int e = 4 * q;
    const int m = m0 + e / bn, n = n0 + e % bn;
    if (m >= Din || n >= Dout) continue;
    float4 s = *reinterpret_cast<const float4*>(first + e);
    for (int j = 1; j < sc.splits; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(first + j * split_stride + e);
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    float* o = out + (long)m * Dout + n;
    if (vec_out && n + 3 < Dout) {
      *reinterpret_cast<float4*>(o) = s;
    } else {
      const float v[4] = {s.x, s.y, s.z, s.w};
      for (int k = 0; k < 4 && n + k < Dout; ++k) o[k] = v[k];
    }
  }
  if (tile < sc.tiles_n && blockIdx.x == 0) {
    // db of Dout tile `tile`: the partials of its items of every Din tile, split-major
    const int tiles_m = sc.tiles / sc.tiles_n;
    const int terms = sc.splits * tiles_m;
    for (int c = threadIdx.x; c < bn && n0 + c < Dout; c += blockDim.x) {
      const float* db0 = first + (long)bm * bn + c;
      float s = 0.f;
#pragma unroll 16
      for (int i = 0; i < terms; ++i)   // the loads are independent: many in flight
        s += db0[(i / tiles_m) * split_stride + (long)(i % tiles_m) * sc.tiles_n * slot];
      out[(long)Din * Dout + n0 + c] = s;
    }
  }
}

// ---- host ------------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, which this library is not linked against, so
// it comes through the runtime's entry-point lookup.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                             12000, cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Lets `kernel` use `bytes` of dynamic shared memory on the current device, once per
// device (`done` holds a bit per device): the call costs the host microseconds.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, std::atomic<uint64_t>* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = 1ull << (dev & 63);
  if (done->load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done->fetch_or(bit);
  return err;
}

std::atomic<uint64_t> tma_smem_set{0}, fma_smem_set[2] = {{0}, {0}};

// A row-major [rows, cols] bf16 matrix read in 64 x 64 boxes under the 128-byte swizzle;
// what lies outside reads as zero.
CUresult make_map(CUtensorMap* map, EncodeTiledFn enc, const void* base, int rows, int cols) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16. route: 0 = "fma"
// (float32), 1 = "mma" (bfloat16), 2 = "tma" (bfloat16, Din and Dout multiples of 8,
// 16-byte aligned x and g). out: [Din * Dout + Dout] float32, dW row-major then db.
// parts: scratch of parts_len float32, at least items * (bm * bn + bn), where items =
// tiles * splits and `splits` cuts each tile's row steps into equal ranges, none empty.
// Launches the route's kernel and the fix-up on `stream` and returns the first
// cudaError_t (0 on success), or 10000 + the CUresult if a tensor map cannot be made.
extern "C" int dw_db(const void* x, const void* g, void* out, void* parts, long parts_len,
                     int N, int Din, int Dout, int dtype, int route, int splits,
                     void* stream) {
  if (N <= 0 || Din <= 0 || Dout <= 0 || splits <= 0 || route < 0 || route > 2 ||
      dtype != (route == kRouteFma ? 0 : 1))
    return (int)cudaErrorInvalidValue;
  const int bm = kTile[route][0], bn = kTile[route][1], bk = kTile[route][2];
  Schedule sc;
  sc.tiles_n = (Dout + bn - 1) / bn;
  sc.tiles = ((Din + bm - 1) / bm) * sc.tiles_n;
  sc.steps = (N + bk - 1) / bk;
  sc.steps_per_split = (sc.steps + splits - 1) / splits;
  sc.splits = splits;
  if ((sc.steps + sc.steps_per_split - 1) / sc.steps_per_split != splits)
    return (int)cudaErrorInvalidValue;  // a split would be empty
  sc.items = sc.tiles * splits;
  const int blocks = sc.items < kTile[route][3] ? sc.items : kTile[route][3];
  if (parts == nullptr || parts_len < (long)sc.items * slot_floats(bm, bn))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(parts);
  cudaError_t err;

  if (route == kRouteTma) {
    if (Din % 8 != 0 || Dout % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(g) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    const EncodeTiledFn enc = encode_tiled();
    if (enc == nullptr) return (int)cudaErrorNotSupported;
    CUtensorMap tmap_x, tmap_g;
    CUresult cr = make_map(&tmap_x, enc, x, N, Din);
    if (cr == CUDA_SUCCESS) cr = make_map(&tmap_g, enc, g, N, Dout);
    if (cr != CUDA_SUCCESS) return 10000 + (int)cr;
    err = allow_smem(dw_db_tma_kernel, kTmaSmem, &tma_smem_set);
    if (err != cudaSuccess) return (int)err;
    dw_db_tma_kernel<<<blocks, kTmaThreads, kTmaSmem, st>>>(tmap_x, tmap_g, p, sc);
  } else if (route == kRouteMma) {
    const int vec_x = (Din % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
    const int vec_g = (Dout % 8 == 0) && (reinterpret_cast<uintptr_t>(g) % 16 == 0);
    dw_db_mma_kernel<<<blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g), p, N, Din,
        Dout, sc, vec_x, vec_g);
  } else {
    const bool vec = Din % 4 == 0 && Dout % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(g) % 16 == 0;
    auto kernel = vec ? dw_db_fma_kernel<true> : dw_db_fma_kernel<false>;
    err = allow_smem(kernel, kFSmem, &fma_smem_set[vec]);
    if (err != cudaSuccess) return (int)err;
    kernel<<<blocks, kThreads, kFSmem, st>>>(static_cast<const float*>(x),
                                                static_cast<const float*>(g), p, N, Din, Dout,
                                                sc);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int quads = bm * bn / 4;
  const dim3 grid((quads + 4 * 256 - 1) / (4 * 256), sc.tiles);
  const int vec_out = Dout % 4 == 0;   // out comes from torch.empty: 16-byte aligned
  dw_db_fixup_kernel<<<grid, 256, 0, st>>>(p, static_cast<float*>(out), Din, Dout, bm, bn, sc,
                                           vec_out);
  return (int)cudaGetLastError();
}
