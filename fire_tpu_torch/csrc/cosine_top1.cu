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
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s dense bf16): the gallery
// read is N * D * 2 bytes = 100,352 * 512 * 2 = 102.8 MB = 30.7 us; the
// work is 2 * M * N * D FLOP, 26.3 GFLOP = 26.6 us at M = 256 and
// 210.5 GFLOP = 212.8 us at M = 2048.  So it is memory-bound below
// M ~ 295 queries and compute-bound above.
//
// Design (correct and simple first; no tensor cores yet):
// * The TPU kernel walks the gallery in order on one core and carries
//   (max, argmax) in VMEM scratch.  Here the gallery is split into S
//   chunks of `chunk_rows` rows, chosen by the wrapper so that the grid
//   (query tiles x chunks) holds a few blocks per SM even for one query.
// * A block takes 64 queries x one chunk.  It walks the chunk in tiles of
//   64 rows; each tile is a 64 x 64 block of dot products, computed from
//   shared-memory stages of 32 depth values converted to float32, with
//   each of the 256 threads owning a 4 x 4 patch (plain FMA).
// * After a tile, each query's maximum over the tile's live rows is
//   reduced across the 16 threads that share the query (first index on
//   ties) and folded into a running (max, argmax) with strict '>', so a
//   later tile never displaces an equal earlier one.
// * Each block writes a partial (max, argmax) per query to (S, M)
//   buffers; a second kernel merges them in ascending chunk order with
//   strict '>', which keeps the lowest index on ties.
// * Masking j >= count happens inside the kernel; count is a plain int
//   argument, so no host read of a device value is needed.
// Tensor cores (mma.sync / wgmma) and TMA are later work: at M = 2048
// this FMA version sits far above the 213 us compute bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QT = 64;         // queries per block
constexpr int RT = 64;         // gallery rows per tile
constexpr int DK = 32;         // depth values per shared-memory stage
constexpr int THREADS = 256;   // 16 x 16 threads, each a 4 x 4 patch
constexpr int LD = 64 + 4;     // shared row stride in floats (16-byte rows)
constexpr float NEG = -2.0f;

__device__ __forceinline__ void load8(const __nv_bfloat16* p, bool ok, float* out) {
  if (ok) {
    uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = 0.0f;
  }
}

__global__ void __launch_bounds__(THREADS)
top1_partial(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ g,
             int M, int N, int D, int count, int chunk_rows,
             float* __restrict__ part_v, int* __restrict__ part_i) {
  __shared__ __align__(16) float qs[DK][LD];
  __shared__ __align__(16) float gs[DK][LD];

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // row group: rows tx*4 .. tx*4+3 of a tile
  const int ty = tid >> 4;   // query group: queries ty*4 .. ty*4+3
  const int q0 = blockIdx.x * QT;
  const int s = blockIdx.y;
  const int r_begin = s * chunk_rows;
  const int r_end = min(N, r_begin + chunk_rows);
  const int live = min(count, r_end);
  // loader: each thread brings 8 consecutive depth values of one row
  const int lr = tid >> 2;
  const int lc = (tid & 3) * 8;

  float best_v[4];
  int best_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best_v[i] = NEG;
    best_i[i] = 0;
  }

  for (int r0 = r_begin; r0 < r_end; r0 += RT) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    for (int d0 = 0; d0 < D; d0 += DK) {
      float tmp[8];
      const int d = d0 + lc;
      const int qrow = q0 + lr;
      load8(q + (size_t)qrow * D + d, qrow < M && d < D, tmp);
#pragma unroll
      for (int e = 0; e < 8; ++e) qs[lc + e][lr] = tmp[e];
      const int grow = r0 + lr;
      load8(g + (size_t)grow * D + d, grow < r_end && d < D, tmp);
#pragma unroll
      for (int e = 0; e < 8; ++e) gs[lc + e][lr] = tmp[e];
      __syncthreads();
#pragma unroll
      for (int k = 0; k < DK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&qs[k][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&gs[k][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row0 = r0 + tx * 4;
      float v = row0 < live ? acc[i][0] : NEG;
      int idx = row0;
#pragma unroll
      for (int j = 1; j < 4; ++j) {
        const float c = (row0 + j) < live ? acc[i][j] : NEG;
        if (c > v) {
          v = c;
          idx = row0 + j;
        }
      }
      // the 16 lanes sharing this query sit in one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, off);
        const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
        if (ov > v || (ov == v && oi < idx)) {
          v = ov;
          idx = oi;
        }
      }
      if (v > best_v[i]) {
        best_v[i] = v;
        best_i[i] = idx;
      }
    }
  }

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      if (qi < M) {
        part_v[(size_t)s * M + qi] = best_v[i];
        part_i[(size_t)s * M + qi] = best_i[i];
      }
    }
  }
}

__global__ void top1_merge(const float* __restrict__ part_v, const int* __restrict__ part_i,
                           int M, int S, float* __restrict__ out_v, int* __restrict__ out_i) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= M) return;
  float bv = NEG;
  int bi = 0;
  for (int s = 0; s < S; ++s) {
    const float v = part_v[(size_t)s * M + qi];
    if (v > bv) {
      bv = v;
      bi = part_i[(size_t)s * M + qi];
    }
  }
  out_v[qi] = bv;
  out_i[qi] = bi;
}

}  // namespace

// q: (M, D) bf16, g: (N, D) bf16, both contiguous with 16-byte aligned
// rows (D % 8 == 0).  part_v/part_i: (S, M) scratch with
// S = ceil(N / chunk_rows) (at least 1); out_v/out_i: (M,).
// Launches on `stream`; returns the cudaError_t of the launches.
extern "C" int fire_cosine_top1(const void* q, const void* g, int M, int N, int D,
                                int count, int chunk_rows, void* part_v, void* part_i,
                                void* out_v, void* out_i, void* stream) {
  if (M <= 0) return 0;
  int S = (N + chunk_rows - 1) / chunk_rows;
  if (S < 1) S = 1;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  dim3 grid((M + QT - 1) / QT, S);
  top1_partial<<<grid, THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(g), M, N, D,
      count, chunk_rows, static_cast<float*>(part_v), static_cast<int*>(part_i));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  top1_merge<<<(M + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i), M, S,
      static_cast<float*>(out_v), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}
