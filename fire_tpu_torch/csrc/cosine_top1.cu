// K1: fused cosine top-1 over the identity gallery, for Hopper (sm_90a).
//
// Replaces the TPU kernel fire_tpu/ops/pallas_topk.py:61
// (pallas_cosine_top1 -> _kernel at :30, pl.pallas_call at :88).
//
// What it computes: for each query m < M, the maximum over gallery rows
// j < count of bf16(q_m) . bf16(g_j), accumulated in float32, and its
// row index.  Rows >= count score NEG = -2.  Ties go to the lowest row
// index.  With no live row the answer is (NEG, 0).  The M x N similarity
// matrix is never written to device memory.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s dense bf16): the live
// gallery rows are read once, count * D * 2 bytes = 99,900 * 512 * 2 =
// 102.3 MB = 30.5 us; the work is 2 * M * count * D FLOP, 26.2 GFLOP =
// 26.5 us at M = 256 and 209.5 GFLOP = 211.8 us at M = 2048.  So the
// call is bound by bytes below M ~ 295 queries and by operations above.
//
// Design (tensor cores fed by TMA: the gallery goes from device memory to
// the tensor cores as it is, no thread converts or transposes it):
// * The product is turned round for wgmma, whose M side is fixed at 64
//   rows and whose N side is any multiple of 8: the GALLERY tile is
//   operand A (64 rows per warpgroup), the QUERY tile is operand B, QT
//   columns wide, QT a template parameter in {8, 16, 32, 64, 128}.  Both
//   are K-major in shared memory, as both arrays are row-major over D.
//   One query runs m64n8k16, 64 queries m64n64k16: no size pads to 64.
// * A block owns one query tile and one chunk of gallery rows.  Its
//   QT x D queries are loaded once and stay in shared memory.  One
//   producer thread streams the chunk through a ring of stages (128 rows
//   x 64 depth values = 16 KB each) with cp.async.bulk.tensor, one
//   `full` and one `empty` mbarrier a stage.  Two consumer warpgroups
//   take rows 0-63 and 64-127 of each stage, start four wgmma a stage and
//   release the stage one wgmma group later, so the copies, the tensor
//   cores and the arg-max of the other warpgroup overlap.
// * Both tensor maps use the 128-byte swizzle; the wgmma descriptors name
//   the same swizzle, an 8-row pitch of 1024 bytes, and advance 32 bytes
//   for each 16-deep step inside the 128-byte span.  TMA's zero fill
//   past M, N and D takes the place of predicates, so the wrapper pads
//   nothing and D % 8 == 0 is the only requirement.
// * Only live rows are read: the wrapper's plan cuts rows [0, count) into
//   chunks of whole tiles, one block each for every query tile; the one
//   tile that straddles `count` masks by row index in its epilogue.
//   `count` is a plain int argument: no host read of a device value.
// * The arg-max stays in registers.  In the accumulator a thread holds,
//   for each of its QT/4 query columns, rows r and r + 8 of the tile; it
//   folds them into a running (max, row) per column with strict '>',
//   rows ascending, the row kept as a 16-bit code (tile in chunk, r or
//   r + 8) so that QT = 128 fits 65,536 / 384 = 168 registers without a
//   spill.  Nothing crosses threads until the chunk is done:
//   then three shuffles over the 8 lanes that share a column and one pass
//   through shared memory over the 8 consumer warps, the lower row
//   winning on equal values, give the block's partial.
// * Each block writes its partial (max, row) per query to (S, M) buffers;
//   top1_merge, one warp per query, finds the first chunk that holds the
//   maximum (chunks ascending, strict '>'), so the answer does not
//   depend on the split.
// * float32 queries (what the encoder gives) are rounded to bf16 on the
//   card by the same call: by the blocks themselves while the ring fills
//   (one narrow query tile), or by a small pass of its own (a wide tile
//   or several, where every chunk's block would read the float32 again).
// * Large M: the grid is (query tiles, chunks) with the query tile the
//   fastest index, so the blocks that share a gallery chunk run at the
//   same time and all but the first read it from L2.  The gallery is
//   re-read through L2 once per 128 queries, not kept in shared memory
//   across query tiles.  Measured on an NVIDIA H100 80GB HBM3 at 700 W
//   (chip_smoke.py, the launches replayed from a CUDA graph): 0.328 ms at
//   M = 2048, 1.55 x the operation bound (638 TFLOP/s); 0.039 ms at M = 1
//   and 0.043 ms at M = 64, 1.28 x and 1.41 x the byte bound.  Called
//   one by one from Python the host adds 0.01 ms or more.
// Every card-side wait is a bounded spin that traps, so a wrong barrier
// phase fails the launch instead of hanging the card.

#include <cuda.h>  // CUtensorMap and its enums; the encoder itself is fetched with dlsym
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int RT = 128;                    // gallery rows per stage: 64 per consumer warpgroup
constexpr int KD = 64;                     // depth values per stage: one 128-byte swizzle span
constexpr int STAGE_BYTES = RT * KD * 2;   // 16 KB
constexpr int CONSUMER_WARPS = 8;          // two warpgroups
constexpr int CONSUMER_THREADS = CONSUMER_WARPS * 32;
constexpr int THREADS = CONSUMER_THREADS + 128;  // + the producer's warpgroup
constexpr int TMA_THREAD = CONSUMER_THREADS;      // its first thread starts the copies
constexpr int CAST_THREADS = THREADS - 1;         // every other thread casts float32 queries
constexpr int SMEM_ALIGN = 1024;           // a 128-byte-swizzled stage starts on 1024 bytes
constexpr float NEG = -2.0f;
constexpr uint32_t SPIN_LIMIT = 1u << 26;  // polls of one wait before the kernel traps
// fire_cosine_top1's own return codes, above every cudaError_t
constexpr int ERR_BAD_PLAN = 20001;    // the plan does not fit the kernel
constexpr int ERR_NO_LIBCUDA = 20002;   // cuTensorMapEncodeTiled not found in libcuda
constexpr int ERR_TENSOR_MAP = 21000;  // + the CUresult of cuTensorMapEncodeTiled

// ---------------------------------------------------------------- PTX ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(arrivals) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (spins > SPIN_LIMIT) __trap();
  }
}

// One box of a 2-D bf16 tensor map into shared memory; completion is
// counted in bytes on `bar`.  c0 is the depth coordinate, c1 the row.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Shared-memory operand of wgmma: K-major, 128-byte swizzle, 8-row
// groups 1024 bytes apart (the leading offset is unused in this mode).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

// D (64 x N, float32, N/2 registers a thread) (+)= A (64 x 16) . B (N x 16)^T,
// both bf16 from shared memory; scale_d == 0 overwrites D.
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(float (&d)[4], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, "
        "%4, %5, p, 1, 1, 0, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, 0, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

// ------------------------------------------------------------- kernels ----

// Folds one tile's accumulator into the thread's running (max, row) per
// column.  acc[4j + e] is row r, acc[4j + 2 + e] row r + 8 of the tile, for
// column 8j + 2 * (lane % 4) + e, r being the thread's own row.  The row
// is kept as a 16-bit code, 2 * (tile in chunk) + (0 for r, 1 for r + 8),
// two columns to a register: code[j] holds column 2j low, 2j + 1 high.
template <int QT, bool MASK>
__device__ __forceinline__ void fold_tile(float (&acc)[QT / 2], float (&best_v)[QT / 4],
                                          uint32_t (&code)[QT / 8], uint32_t tile, int row0,
                                          int live_end) {
  // wgmma wrote the accumulator behind the compiler's back: no read of it
  // may be scheduled ahead of the wgmma_wait that precedes this call
#pragma unroll
  for (int i = 0; i < QT / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");
  const bool dead0 = MASK && row0 >= live_end;
  const bool dead8 = MASK && row0 + 8 >= live_end;
#pragma unroll
  for (int j = 0; j < QT / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 2 * j + e;
      const float v0 = dead0 ? NEG : acc[4 * j + e];
      const float v8 = dead8 ? NEG : acc[4 * j + 2 + e];
      const uint32_t keep = e ? 0x0000FFFFu : 0xFFFF0000u;
      if (v0 > best_v[c]) {
        best_v[c] = v0;
        code[j] = (code[j] & keep) | ((2 * tile) << (16 * e));
      }
      if (v8 > best_v[c]) {
        best_v[c] = v8;
        code[j] = (code[j] & keep) | ((2 * tile + 1) << (16 * e));
      }
    }
  }
}

// What the kernel's two roles share: where things lie in shared memory
// and which rows the block owns.
struct Block {
  uint32_t q_smem, g_smem, bar_full, bar_empty, bar_q, q_block;
  int KB, stages, q0, r_begin, live_end, n_tiles;
};

// One thread keeps the ring full: the query tile once (if it comes as
// bf16), then the chunk's tiles, one depth block of 64 a stage.
__device__ __forceinline__ void produce(const Block& b, const CUtensorMap* map_g,
                                        const CUtensorMap* map_q, bool load_queries) {
  if (load_queries) {
    mbar_expect_tx(b.bar_q, b.KB * b.q_block);
    for (int kb = 0; kb < b.KB; ++kb)
      tma_load_2d(b.q_smem + kb * b.q_block, map_q, b.bar_q, kb * KD, b.q0);
  }
  int stage = 0;
  uint32_t phase = 0;
  for (int t = 0; t < b.n_tiles; ++t) {
    const int row = b.r_begin + t * RT;
    for (int kb = 0; kb < b.KB; ++kb) {
      mbar_wait(b.bar_empty + 8 * stage, phase ^ 1);
      mbar_expect_tx(b.bar_full + 8 * stage, STAGE_BYTES);
      tma_load_2d(b.g_smem + stage * STAGE_BYTES, map_g, b.bar_full + 8 * stage, kb * KD, row);
      if (++stage == b.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// float32 queries: before the roles part, every thread but the one that
// starts the copies rounds its share of the block's QT x D tile to bf16
// and stores it where TMA would have put it.  In the 128-byte swizzle
// the 16-byte unit j of row r lies at unit j ^ (r % 8) of that row.  Rows
// past M and depth past D are zeros.  `p` is the thread's number among
// the casting threads.
template <int QT>
__device__ __forceinline__ void cast_queries(const Block& b, const float* __restrict__ qf, int M,
                                             int D, uint8_t* smem_raw, uint32_t raw, int p) {
  constexpr int UNROLL = 8;  // 16 loads of 16 bytes in flight a thread
  const int units_per_row = b.KB * 8;
  const int total = QT * units_per_row;
  for (int first = p; first < total; first += CAST_THREADS * UNROLL) {
    float4 lo[UNROLL], hi[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int unit = first + u * CAST_THREADS;
      const int r = unit / units_per_row, col = (unit % units_per_row) * 8;
      lo[u] = hi[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (unit < total && b.q0 + r < M && col < D) {
        const float4* src = reinterpret_cast<const float4*>(qf + (size_t)(b.q0 + r) * D + col);
        lo[u] = __ldg(src);
        hi[u] = __ldg(src + 1);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int unit = first + u * CAST_THREADS;
      if (unit >= total) break;
      const int r = unit / units_per_row, cj = unit % units_per_row;
      const uint32_t at = b.q_smem + (cj >> 3) * b.q_block + r * 128 + (((cj & 7) ^ (r & 7)) << 4);
      __nv_bfloat162 h[4] = {__floats2bfloat162_rn(lo[u].x, lo[u].y),
                             __floats2bfloat162_rn(lo[u].z, lo[u].w),
                             __floats2bfloat162_rn(hi[u].x, hi[u].y),
                             __floats2bfloat162_rn(hi[u].z, hi[u].w)};
      *reinterpret_cast<uint4*>(smem_raw + (at - raw)) = *reinterpret_cast<uint4*>(h);
    }
  }
  // the tensor cores read shared memory through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_arrive(b.bar_q);
}

// The 8 consumer warps: warpgroup `wg` takes rows wg*64 .. wg*64+63 of each
// stage.  Writes the block's partial for its QT queries.
template <int QT>
__device__ __forceinline__ void consume(const Block& b, int M, int s, float* red_v, int* red_i,
                                        float* __restrict__ part_v, int* __restrict__ part_i) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wg = warp >> 2;
  const int row_in_tile = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  float acc[QT / 2];
  float best_v[QT / 4];
  uint32_t code[QT / 8];
#pragma unroll
  for (int c = 0; c < QT / 4; ++c) best_v[c] = NEG;
#pragma unroll
  for (int j = 0; j < QT / 8; ++j) code[j] = 0;

  if (b.n_tiles > 0) {
    mbar_wait(b.bar_q, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int t = 0; t < b.n_tiles; ++t) {
      int prev = -1;  // the stage whose wgmma group is still in flight
      for (int kb = 0; kb < b.KB; ++kb) {
        mbar_wait(b.bar_full + 8 * stage, phase);
        const uint64_t da = smem_desc(b.g_smem + stage * STAGE_BYTES + wg * (64 * KD * 2));
        const uint64_t db = smem_desc(b.q_smem + kb * b.q_block);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < KD / 16; ++k)  // 32 bytes = 2 descriptor units a step
          Wgmma<QT>::mma(acc, da + 2 * k, db + 2 * k, (kb | k) != 0);
        wgmma_commit();
        if (prev >= 0) {
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(b.bar_empty + 8 * prev);
        }
        prev = stage;
        if (++stage == b.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(b.bar_empty + 8 * prev);
      const int row0 = b.r_begin + t * RT + row_in_tile;
      if (b.r_begin + (t + 1) * RT > b.live_end)
        fold_tile<QT, true>(acc, best_v, code, t, row0, b.live_end);
      else
        fold_tile<QT, false>(acc, best_v, code, t, row0, b.live_end);
    }
  }

  // the block's partial: 8 lanes share a column, then 8 warps
#pragma unroll
  for (int c = 0; c < QT / 4; ++c) {
    const uint32_t cd = (code[c >> 1] >> (16 * (c & 1))) & 0xFFFFu;
    float bv = best_v[c];
    int bi = bv > NEG ? b.r_begin + int(cd >> 1) * RT + row_in_tile + int(cd & 1) * 8 : 0;
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane < 4) {
      const int col = 8 * (c >> 1) + 2 * lane + (c & 1);
      red_v[warp * QT + col] = bv;
      red_i[warp * QT + col] = bi;
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMER_THREADS) : "memory");
  if (tid < QT && b.q0 + tid < M) {
    float bv = red_v[tid];
    int bi = red_i[tid];
#pragma unroll
    for (int w = 1; w < CONSUMER_WARPS; ++w) {
      const float v = red_v[w * QT + tid];
      const int i = red_i[w * QT + tid];
      if (v > bv || (v == bv && i < bi)) {
        bv = v;
        bi = i;
      }
    }
    part_v[(size_t)s * M + b.q0 + tid] = bv;
    part_i[(size_t)s * M + b.q0 + tid] = bi;
  }
}

// grid (query tiles, live chunks), THREADS threads, dynamic shared memory:
// [queries: KB blocks of QT rows x 128 B][stages x 16 KB][8 x QT (float, int)]
// [full[stages], empty[stages], q_full mbarriers], from a 1024-byte boundary.
// The queries come through `map_q` as bf16, or, if `qf` is set, as float32
// that the block casts itself.
template <int QT>
__global__ void __launch_bounds__(THREADS, 1)
top1_partial(const __grid_constant__ CUtensorMap map_g, const __grid_constant__ CUtensorMap map_q,
             const float* __restrict__ qf, int M, int D, int count, int chunk_rows, int stages,
             float* __restrict__ part_v, int* __restrict__ part_i) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  Block b;
  b.KB = (D + KD - 1) / KD;
  b.stages = stages;
  b.q_block = QT * KD * 2;  // one depth block of the query tile
  b.q_smem = (raw + SMEM_ALIGN - 1) & ~uint32_t(SMEM_ALIGN - 1);
  b.g_smem = b.q_smem + b.KB * b.q_block;
  const uint32_t red_off = b.g_smem + stages * STAGE_BYTES - raw;
  b.bar_full = raw + red_off + CONSUMER_WARPS * QT * 8;
  b.bar_empty = b.bar_full + 8 * stages;
  b.bar_q = b.bar_empty + 8 * stages;
  float* red_v = reinterpret_cast<float*>(smem_raw + red_off);
  int* red_i = reinterpret_cast<int*>(red_v + CONSUMER_WARPS * QT);

  const int tid = threadIdx.x;
  const int s = blockIdx.y;
  b.q0 = blockIdx.x * QT;
  b.r_begin = s * chunk_rows;
  b.live_end = min(count, b.r_begin + chunk_rows);
  b.n_tiles = b.live_end > b.r_begin ? (b.live_end - b.r_begin + RT - 1) / RT : 0;

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(b.bar_full + 8 * i, 1);
      mbar_init(b.bar_empty + 8 * i, CONSUMER_WARPS);
    }
    mbar_init(b.bar_q, qf ? CAST_THREADS : 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (qf && tid != TMA_THREAD && b.n_tiles > 0)
    cast_queries<QT>(b, qf, M, D, smem_raw, raw, tid - (tid > TMA_THREAD));
  // The roles never meet again.
  if (tid < CONSUMER_THREADS)
    consume<QT>(b, M, s, red_v, red_i, part_v, part_i);
  else if (tid == TMA_THREAD && b.n_tiles > 0)
    produce(b, &map_g, &map_q, qf == nullptr);
}

// float32 queries to the bf16 the tensor cores take (round to nearest
// even, as torch's cast): 8 values a thread.
__global__ void cast_bf16(const float4* __restrict__ in, uint4* __restrict__ out, int n8) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n8) return;
  const float4 a = in[2 * i], b = in[2 * i + 1];
  __nv_bfloat162 h[4] = {__floats2bfloat162_rn(a.x, a.y), __floats2bfloat162_rn(a.z, a.w),
                         __floats2bfloat162_rn(b.x, b.y), __floats2bfloat162_rn(b.z, b.w)};
  out[i] = *reinterpret_cast<uint4*>(h);
}

// One warp per query: lane l folds chunks l, l + 32, ... in ascending
// order with strict '>', then the lanes combine, the lower chunk winning
// on equal values.  That is the first chunk that holds the maximum, as a
// walk over the chunks in order would find it.
constexpr int MERGE_THREADS = 256;

__global__ void __launch_bounds__(MERGE_THREADS)
top1_merge(const float* __restrict__ part_v, const int* __restrict__ part_i, int M, int S,
           float* __restrict__ out_v, int* __restrict__ out_i) {
  const int qi = (blockIdx.x * MERGE_THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (qi >= M) return;
  float bv = NEG;
  int bs = S;  // S: no chunk beat NEG
  for (int s = lane; s < S; s += 32) {
    const float v = part_v[(size_t)s * M + qi];
    if (v > bv) {
      bv = v;
      bs = s;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int os = __shfl_xor_sync(0xffffffffu, bs, off);
    if (ov > bv || (ov == bv && os < bs)) {
      bv = ov;
      bs = os;
    }
  }
  if (lane == 0) {
    out_v[qi] = bv;
    out_i[qi] = bs < S ? part_i[(size_t)bs * M + qi] : 0;
  }
}

// ---------------------------------------------------------------- host ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// Tensor map of a row-major (rows, D) bf16 array cut into boxes of
// `box_rows` rows x 64 depth values, 128-byte swizzle, zero fill outside.
int encode_rows(CUtensorMap* map, const void* base, int rows, int D, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return ERR_NO_LIBCUDA;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * 2};
  const cuuint32_t box[2] = {KD, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP + static_cast<int>(r);
}

template <int QT>
int launch_partial(const CUtensorMap& map_g, const CUtensorMap& map_q, const float* qf, int M,
                   int D, int count,
                   int chunk_rows, int live_chunks, int stages, int smem_bytes, float* part_v,
                   int* part_i, cudaStream_t st) {
  // The attribute is per device and grows only: set it when a device
  // first needs this much (a host call of some microseconds otherwise).
  static int granted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || granted[dev] < smem_bytes) {
    err = cudaFuncSetAttribute(top1_partial<QT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) granted[dev] = smem_bytes;
  }
  dim3 grid((M + QT - 1) / QT, live_chunks);
  top1_partial<QT><<<grid, THREADS, smem_bytes, st>>>(map_g, map_q, qf, M, D, count, chunk_rows,
                                                      stages, part_v, part_i);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (M, D), bf16 or (q_is_f32) float32.  Float32 queries are cast by
// the blocks themselves (cast_in_block, one query tile only) or by a pass
// of its own into the scratch `q16` (M * D bf16), which is not used
// otherwise.  g: (N, D) bf16.  Both contiguous and
// 16-byte aligned, D % 8 == 0.  The launch plan comes from the caller and
// is not chosen again here: `qt` queries per block (8, 16, 32, 64 or
// 128), `chunk_rows` gallery rows per block (whole 128-row tiles),
// `stages` ring stages, `smem_bytes` of dynamic shared memory (at least
// what the layout needs).  part_v / part_i: (ceil(count / chunk_rows), M)
// scratch; out_v / out_i: (M,).  Launches on `stream`.  Returns 0, the
// cudaError_t of a refused launch, or one of the ERR_* codes above.
extern "C" int fire_cosine_top1(const void* q, int q_is_f32, int cast_in_block, void* q16,
                                const void* g, int M, int N, int D, int count, int qt,
                                int chunk_rows, int stages, int smem_bytes, void* part_v,
                                void* part_i, void* out_v, void* out_i, void* stream) {
  if (M <= 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  float* pv = static_cast<float*>(part_v);
  int* pi = static_cast<int*>(part_i);
  count = count < N ? count : N;
  int live_chunks = 0;
  if (count > 0) {
    if (chunk_rows <= 0 || chunk_rows % RT || chunk_rows / RT > 32767 || stages < 2 || D <= 0 ||
        D % 8)
      return ERR_BAD_PLAN;  // (a tile's number in its chunk is kept in 15 bits)
    const int KB = (D + KD - 1) / KD;
    const int need = SMEM_ALIGN + KB * qt * KD * 2 + stages * STAGE_BYTES +
                     CONSUMER_WARPS * qt * 8 + (2 * stages + 1) * 8;
    if (smem_bytes < need) return ERR_BAD_PLAN;
    live_chunks = (count + chunk_rows - 1) / chunk_rows;
    const float* qf = nullptr;
    if (q_is_f32 && cast_in_block) {
      if (M > qt) return ERR_BAD_PLAN;
      qf = static_cast<const float*>(q);
    } else if (q_is_f32) {
      const int n8 = M * (D / 8);
      cast_bf16<<<(n8 + 255) / 256, 256, 0, st>>>(static_cast<const float4*>(q),
                                                  static_cast<uint4*>(q16), n8);
      q = q16;
    }
    CUtensorMap map_g, map_q;
    int rc = encode_rows(&map_g, g, N, D, RT);
    if (rc) return rc;
    if (qf)
      map_q = map_g;  // not read
    else if ((rc = encode_rows(&map_q, q, M, D, qt)))
      return rc;
    switch (qt) {
#define FIRE_K1_CASE(W)                                                                       \
  case W:                                                                                     \
    rc = launch_partial<W>(map_g, map_q, qf, M, D, count, chunk_rows, live_chunks, stages,    \
                           smem_bytes, pv, pi, st);                                           \
    break;
      FIRE_K1_CASE(8)
      FIRE_K1_CASE(16)
      FIRE_K1_CASE(32)
      FIRE_K1_CASE(64)
      FIRE_K1_CASE(128)
#undef FIRE_K1_CASE
      default:
        return ERR_BAD_PLAN;
    }
    if (rc) return rc;
  }
  constexpr int PER_BLOCK = MERGE_THREADS / 32;
  top1_merge<<<(M + PER_BLOCK - 1) / PER_BLOCK, MERGE_THREADS, 0, st>>>(
      pv, pi, M, live_chunks, static_cast<float*>(out_v), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

