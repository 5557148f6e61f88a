// K2: the tracker scan, B frames of SORT for one stream in one launch,
// for Hopper (sm_90a).
//
// Replaces the JAX code that XLA compiles for the TPU: the batched step's
// lax.scan over the frames with its identity bookkeeping
// (fire_tpu/pipeline/batch_engine.py:131-230), the per-frame sort_step
// (fire_tpu/track/sort.py:229) and the device assignment it calls, the
// row-minimum fast path and the Jonker-Volgenant solve, or greedy
// matching (fire_tpu/track/assignment.py:89-237).  K2 is not the port of
// a Pallas kernel: JAX leaves this code to XLA.  It is written by hand
// because the scan is the hot path of every serving cell, and eager
// PyTorch runs it as some 375 small launches and a host read per frame.
//
// What it computes, for frames f = 0 .. B-1 in order, each what
// sort_step does (fire_tpu_torch/track/sort.py):
// * predict: the linear KF predict of every active track's 10-d state
//   and 10x10 covariance (F P F^T + Q), the state clamp, age and
//   time-since-update + 1, and each track's box (_state_to_box);
// * the K x T cost (1 - IoU) + centre distance / max_distance;
// * the assignment: the exact LAP of lap_assign (row minima when they
//   are distinct, else the shortest-augmenting-path JV solve, the
//   smaller side as rows) and its gate, or greedy_assign;
// * apply_assignment: the KF update of matched tracks with the
//   closed-form 4x4 inverse, prune before spawn, rank-paired spawning
//   of unmatched detections into free slots, next_id, the confirmed
//   mask and each track's source detection;
// * with identity inputs, the batched step's bookkeeping: gallery row,
//   similarity, unknown streak, pending and enrolment flags, and for
//   every (frame, track) the flat index f*K + k of the detection whose
//   embedding the track now carries, or -1 for the one it carried into
//   the launch.  No embedding is copied here.
// The track table and the identity state are read at the start and
// written back at the end, in place.  The float32 formulas follow the
// plain version's in its order, every product and sum a separate rounding
// (the build turns FMA contraction off), so that x and P come out as the
// plain version's do on the card; its matrix products are ordered sums
// (track/ukf.py ordered_matmul), not a BLAS call, for that reason.
//
// Bound on an H100 SXM: a launch moves a few hundred KB at most (the
// table in and out, the detections, the per-frame outputs), a few us at
// 3.35 TB/s, and does a few MFLOP; neither bounds it.  What bounds it is
// the serial chain: frame f + 1 needs frame f's table, and inside a frame
// predict -> cost -> assignment -> update -> spawn ranks -> emit depend
// on each other, with about ten block-wide barriers between them, plus
// two per Dijkstra step on a frame that needs the JV solve.
//
// Design: one block of one to eight warps a launch (the recurrence is
// serial, so more blocks have nothing to do); the table and the K x T
// cost stay in shared memory for the whole launch (dynamic shared
// memory: 195 KB at T = 192, K = 128); a thread per track for predict,
// update and emit, its integer state and identity in registers; block
// reductions for the arg-mins (lowest index on ties, NaN first, as
// torch.argmin) and one packed block prefix sum for both spawn ranks.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;  // T and K are at most this
constexpr float PAD = 16384.0f;   // assignment.py _PAD = 2**14
constexpr float BIG = 1e9f;       // assignment.py BIG
constexpr int ERR_BAD_ARGS = 20001;
// A track's state in shared memory: x in XS words, P in PS words.  The odd
// strides keep a warp's 32 tracks on 32 banks, and a track's elements sit
// at fixed offsets from its base, so no per-element address is computed.
constexpr int XS = 11, PS = 101;

}  // namespace

// The launch's arguments; mirrored field for field by _Args in track/scan.py.
struct FireScanArgs {
  // table (T rows), read and written
  float* x;        // (T, 10)
  float* p;        // (T, 10, 10)
  int* tid;        // (T,)
  int* age;
  int* tsu;
  int* hits;
  int* streak;
  uint8_t* active;
  int* next_id;    // ()
  // detections
  const float* boxes;  // (B, K, 4) xywh
  const uint8_t* mask; // (B, K)
  // identity (all null without it)
  const int* det_gid;          // (B, K)
  const float* det_sim;        // (B, K)
  const uint8_t* det_has_emb;  // (B, K)
  int* gid;                    // (T,) read and written
  float* sim;
  int* unk;
  uint8_t* pending;
  // per-frame outputs
  int* o_tid;       // (B, T)
  int* o_boxes;     // (B, T, 4)
  int* o_age;
  uint8_t* o_mask;
  int* o_src;
  int* o_gid;       // identity outputs (null without it)
  float* o_sim;
  uint8_t* o_enroll;
  int* o_emb_src;
  int* stats;       // (5,) counts added here, or null: frames that took the JV solve, track
                    // predictions, KF updates, Dijkstra steps, greedy rounds
  int B, K, T;
  int greedy;
  int max_age, min_hits, unknown_trigger;
  float q[10];      // diagonal of Q
  float r_diag, max_velocity, max_acceleration, min_log_area, min_log_aspect, min_wh, max_wh;
  float max_distance, gate, similarity_threshold;
};

namespace {

struct Smem {
  float4* tbox;   // (T,) predicted track boxes
  float4* dbox;   // (K,) this frame's detections
  float* x;       // (T, XS): a track's 10 state values
  float* p;       // (T, PS): a track's 10 x 10 covariance, row-major
  float* cost;    // (K, T)
  int* active;    // (T,)
  int* match;     // (T,) detection per track or -1
  int* dmask;     // (K,)
  int* det_matched;
  int* rank2det;  // (K,) unmatched detection of each rank
  float* u;       // JV, max(K, T) each
  float* v;
  int* col4row;
  int* row4col;
  float* sh_short;
  int* sh_path;
  int* sh_seen;
  int* colcount;
  float* red_v;   // 32: per-warp arg-min values
  int* red_i;     // 32
  int* scan;      // 32: per-warp sums
  float* bc_v;    // 1: the block's arg-min
  int* bc_i;      // 1
};

// 4-byte words of dynamic shared memory: track_scan.shared_bytes / 4 in Python
__host__ __device__ inline int smem_words(int T, int K) {
  const int M = K > T ? K : T;
  return 4 * T + 4 * K + (XS + PS) * T + K * T + 2 * T + 3 * K + 8 * M + 128;
}

__device__ Smem carve(float* base, int T, int K) {
  const int M = K > T ? K : T;
  Smem s;
  float* w = base;
  s.tbox = reinterpret_cast<float4*>(w); w += 4 * T;
  s.dbox = reinterpret_cast<float4*>(w); w += 4 * K;
  s.x = w; w += XS * T;
  s.p = w; w += PS * T;
  s.cost = w; w += K * T;
  s.active = reinterpret_cast<int*>(w); w += T;
  s.match = reinterpret_cast<int*>(w); w += T;
  s.dmask = reinterpret_cast<int*>(w); w += K;
  s.det_matched = reinterpret_cast<int*>(w); w += K;
  s.rank2det = reinterpret_cast<int*>(w); w += K;
  s.u = w; w += M;
  s.v = w; w += M;
  s.col4row = reinterpret_cast<int*>(w); w += M;
  s.row4col = reinterpret_cast<int*>(w); w += M;
  s.sh_short = w; w += M;
  s.sh_path = reinterpret_cast<int*>(w); w += M;
  s.sh_seen = reinterpret_cast<int*>(w); w += M;
  s.colcount = reinterpret_cast<int*>(w); w += M;
  s.red_v = w; w += 32;
  s.red_i = reinterpret_cast<int*>(w); w += 32;
  s.scan = reinterpret_cast<int*>(w); w += 32;
  s.bc_v = w; w += 1;
  s.bc_i = reinterpret_cast<int*>(w);
  return s;
}

// (av, ai) comes before (bv, bi) in torch.argmin's order: NaN first,
// then the smaller value, then the lower index.
__device__ __forceinline__ bool before(float av, int ai, float bv, int bi) {
  const bool an = isnan(av), bn = isnan(bv);
  if (an != bn) return an;
  if (an) return ai < bi;
  return av < bv || (av == bv && ai < bi);
}

// Arg-min over the block of one (value, index) per thread; every thread
// gets the result.  Two barriers.
__device__ void block_argmin(const Smem& s, float v, int i, float& out_v, int& out_i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, o);
    const int oi = __shfl_down_sync(0xffffffffu, i, o);
    if (before(ov, oi, v, i)) { v = ov; i = oi; }
  }
  if (lane == 0) { s.red_v[warp] = v; s.red_i[warp] = i; }
  __syncthreads();
  if (warp == 0) {
    v = lane < nwarps ? s.red_v[lane] : INFINITY;
    i = lane < nwarps ? s.red_i[lane] : 0x7fffffff;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, v, o);
      const int oi = __shfl_down_sync(0xffffffffu, i, o);
      if (before(ov, oi, v, i)) { v = ov; i = oi; }
    }
    if (lane == 0) { *s.bc_v = v; *s.bc_i = i; }
  }
  __syncthreads();
  out_v = *s.bc_v;
  out_i = *s.bc_i;
}

// Inclusive prefix sum over the block; ``total`` gets the block's sum.
// Two barriers.
__device__ int block_scan(const Smem& s, int v, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) s.scan[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? s.scan[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    s.scan[lane] = w;
  }
  __syncthreads();
  total = s.scan[nwarps - 1];
  return v + (warp > 0 ? s.scan[warp - 1] : 0);
}

// _bbox_to_z: [x, y, w, h] -> [cx, cy, log s, log r] with the guards.
__device__ void bbox_to_z(const float4 b, const FireScanArgs& a, float z[4]) {
  const float s = b.z * b.w;
  const float r = b.w != 0.0f ? b.z / b.w : 1.0f;
  z[0] = b.x + b.z / 2.0f;
  z[1] = b.y + b.w / 2.0f;
  z[2] = s > 0.0f ? logf(fmaxf(s, 1e-20f)) : a.min_log_area;
  z[3] = r > 0.0f ? logf(fmaxf(r, 1e-20f)) : a.min_log_aspect;
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// _state_to_box: truncated [x, y, w, h] as floats holding integers.
__device__ float4 state_to_box(const Smem& s, int t, const FireScanArgs& a) {
  const float* x = s.x + t * XS;
  const float cx = x[0], cy = x[1];
  const float log_s = fmaxf(x[2], a.min_log_area);
  const float log_r = fmaxf(x[3], a.min_log_aspect);
  const float sc = expf(log_s), r = expf(log_r);
  float w = sqrtf(sc * r);
  float h = sc / w;
  w = clampf(w, a.min_wh, a.max_wh);
  h = clampf(h, a.min_wh, a.max_wh);
  return make_float4(truncf(cx - w / 2.0f), truncf(cy - h / 2.0f), truncf(w), truncf(h));
}

// _clamp_state on a track's state x
__device__ void clamp_state(float* x, const FireScanArgs& a) {
#pragma unroll
  for (int e = 4; e < 7; ++e) x[e] = clampf(x[e], -a.max_velocity, a.max_velocity);
#pragma unroll
  for (int e = 7; e < 10; ++e)
    x[e] = clampf(x[e], -a.max_acceleration, a.max_acceleration);
}

// kf_predict with the constant-acceleration F (dt = 1), in place.
__device__ void predict(const Smem& s, int t, const FireScanArgs& a) {
  float* x = s.x + t * XS;
  float* p = s.p + t * PS;
#define X(e) x[e]
#define P(i, j) p[(i) * 10 + (j)]
  // x F^T: rows 0-2 read the old 4-9, rows 4-6 the old 7-9
#pragma unroll
  for (int i = 0; i < 3; ++i) X(i) = (X(i) + X(4 + i)) + X(7 + i) * 0.5f;
#pragma unroll
  for (int i = 0; i < 3; ++i) X(4 + i) = X(4 + i) + X(7 + i);
  // (F P) F^T + Q a row at a time: row i of F P reads rows i, 4 + i and
  // 7 + i of P, all still unwritten in the order 0 .. 9
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    float r[10];
#pragma unroll
    for (int j = 0; j < 10; ++j) {
      if (i < 3) r[j] = (P(i, j) + P(4 + i, j)) + P(7 + i, j) * 0.5f;
      else if (i >= 4 && i < 7) r[j] = P(i, j) + P(3 + i, j);
      else r[j] = P(i, j);
    }
#pragma unroll
    for (int j = 0; j < 10; ++j) {
      float v = r[j];
      if (j < 3) v = (r[j] + r[4 + j]) + r[7 + j] * 0.5f;
      else if (j >= 4 && j < 7) v = r[j] + r[3 + j];
      P(i, j) = j == i ? v + a.q[i] : v;
    }
  }
#undef X
#undef P
  clamp_state(x, a);
}

// Matrix products as the plain version's ordered_matmul (track/ukf.py)
// takes them: the sum over k ascending, every product and sum rounded on
// its own (the build turns contraction off).
__device__ __forceinline__ float dot2(float a0, float b0, float a1, float b1) {
  return a0 * b0 + a1 * b1;
}

__device__ __forceinline__ float dot4(float a0, float b0, float a1, float b1, float a2, float b2,
                                      float a3, float b3) {
  return ((a0 * b0 + a1 * b1) + a2 * b2) + a3 * b3;
}

// 2x2 product on row-major arrays
__device__ __forceinline__ void mm2(const float* m, const float* n, float* o) {
  o[0] = dot2(m[0], n[0], m[1], n[2]);
  o[1] = dot2(m[0], n[1], m[1], n[3]);
  o[2] = dot2(m[2], n[0], m[3], n[2]);
  o[3] = dot2(m[2], n[1], m[3], n[3]);
}

__device__ __forceinline__ void inv2(const float* m, float* o) {
  const float det = m[0] * m[3] - m[1] * m[2];
  o[0] = m[3] / det;
  o[1] = -m[1] / det;
  o[2] = -m[2] / det;
  o[3] = m[0] / det;
}

// _inv4_spd: the 4x4 inverse by 2x2 blocks (Schur complement).
__device__ void inv4_spd(const float s[16], float o[16]) {
  const float a[4] = {s[0], s[1], s[4], s[5]};
  const float b[4] = {s[2], s[3], s[6], s[7]};
  const float c[4] = {s[8], s[9], s[12], s[13]};
  const float d[4] = {s[10], s[11], s[14], s[15]};
  float ai[4], aib[4], cab[4], sc[4], sci[4], cai[4], scicai[4], tl[4], tr[4];
  inv2(a, ai);
  mm2(ai, b, aib);
  mm2(c, aib, cab);
  for (int e = 0; e < 4; ++e) sc[e] = d[e] - cab[e];
  inv2(sc, sci);
  mm2(c, ai, cai);
  mm2(sci, cai, scicai);
  mm2(aib, scicai, tl);
  mm2(aib, sci, tr);
  o[0] = ai[0] + tl[0];  o[1] = ai[1] + tl[1];  o[2] = -tr[0];      o[3] = -tr[1];
  o[4] = ai[2] + tl[2];  o[5] = ai[3] + tl[3];  o[6] = -tr[2];      o[7] = -tr[3];
  o[8] = -scicai[0];     o[9] = -scicai[1];     o[10] = sci[0];     o[11] = sci[1];
  o[12] = -scicai[2];    o[13] = -scicai[3];    o[14] = sci[2];     o[15] = sci[3];
}

// kf_update_tracker: H = [I4 0], S = P[:4,:4] + r I, K = P[:, :4] S^-1.
__device__ void kf_update(const Smem& s, int t, const float z[4], const FireScanArgs& a) {
  float* x = s.x + t * XS;
  float* p = s.p + t * PS;
#define X(e) x[e]
#define P(i, j) p[(i) * 10 + (j)]
  float sm[16], si[16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sm[i * 4 + j] = P(i, j) + (i == j ? a.r_diag : 0.0f);
  inv4_spd(sm, si);
  float k[10][4];
#pragma unroll
  for (int i = 0; i < 10; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      k[i][j] = dot4(P(i, 0), si[j], P(i, 1), si[4 + j], P(i, 2), si[8 + j], P(i, 3), si[12 + j]);
  float y[4];
#pragma unroll
  for (int l = 0; l < 4; ++l) y[l] = z[l] - X(l);
#pragma unroll
  for (int i = 0; i < 10; ++i)
    X(i) = X(i) + dot4(k[i][0], y[0], k[i][1], y[1], k[i][2], y[2], k[i][3], y[3]);
  // P - (K S) K^T, a row of K S at a time (registers: K, S and one row)
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    float ks[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ks[j] = dot4(k[i][0], sm[j], k[i][1], sm[4 + j], k[i][2], sm[8 + j], k[i][3], sm[12 + j]);
#pragma unroll
    for (int j = 0; j < 10; ++j)
      P(i, j) = P(i, j) - dot4(ks[0], k[j][0], ks[1], k[j][1], ks[2], k[j][2], ks[3], k[j][3]);
  }
#undef X
#undef P
  clamp_state(x, a);
}

// cost_matrix for one (detection, track) pair.
__device__ float pair_cost(const float4 d, const float4 t, float max_distance) {
  const float ax2 = d.x + d.z, ay2 = d.y + d.w, bx2 = t.x + t.z, by2 = t.y + t.w;
  const float iw = fmaxf(fminf(ax2, bx2) - fmaxf(d.x, t.x), 0.0f);
  const float ih = fmaxf(fminf(ay2, by2) - fmaxf(d.y, t.y), 0.0f);
  const float inter = iw * ih;
  const float area_a = (ax2 - d.x) * (ay2 - d.y);
  const float area_b = (bx2 - t.x) * (by2 - t.y);
  const float uni = (area_a + area_b) - inter;
  float iou = uni > 0.0f ? inter / uni : 0.0f;
  if (!(d.z > 0.0f && d.w > 0.0f && t.z > 0.0f && t.w > 0.0f)) iou = 0.0f;
  const float dx = (d.x + d.z / 2.0f) - (t.x + t.z / 2.0f);
  const float dy = (d.y + d.w / 2.0f) - (t.y + t.w / 2.0f);
  const float dist = sqrtf(dx * dx + dy * dy);
  return (1.0f - iou) + dist / max_distance;
}

// The LAP's matrix: rows are detections when K <= T, else tracks; masked
// columns cost PAD.
__device__ __forceinline__ float lap_c(const Smem& s, bool rows_dets, int r, int j, int T) {
  if (rows_dets) return s.active[j] ? s.cost[r * T + j] : PAD;
  return s.dmask[j] ? s.cost[j * T + r] : PAD;
}

// lap_assign -> s.match.  Returns whether the frame took the JV solve;
// ``steps`` (thread 0's) counts its Dijkstra steps.
__device__ bool lap_assign(const Smem& s, const FireScanArgs& a, int& steps) {
  const int T = a.T, K = a.K, tx = threadIdx.x;
  const bool rows_dets = K <= T;
  const int R = rows_dets ? K : T, C = rows_dets ? T : K;
  // fast path: every valid row's cheapest column (first minimum)
  int jmin = 0;
  bool rv = false;
  if (tx < R) {
    rv = rows_dets ? s.dmask[tx] != 0 : s.active[tx] != 0;
    float best = lap_c(s, rows_dets, tx, 0, T);
    for (int j = 1; j < C; ++j) {
      const float c = lap_c(s, rows_dets, tx, j, T);
      if (before(c, j, best, jmin)) { best = c; jmin = j; }
    }
  }
  if (tx < C) s.colcount[tx] = 0;
  __syncthreads();
  if (rv) atomicAdd(&s.colcount[jmin], 1);
  __syncthreads();
  const bool conflict = __syncthreads_or(tx < C && s.colcount[tx] > 1);
  if (!conflict) {
    if (tx < R) s.col4row[tx] = rv ? jmin : -1;
  } else {
    // the JV solve: one Dijkstra over columns per valid row, column j on thread j
    if (tx < R) { s.u[tx] = 0.0f; s.col4row[tx] = -1; }
    if (tx < C) { s.v[tx] = 0.0f; s.row4col[tx] = -1; }
    __syncthreads();
    for (int i = 0; i < R; ++i) {
      const bool valid = rows_dets ? s.dmask[i] != 0 : s.active[i] != 0;
      if (!valid) continue;
      float my_short = INFINITY, minval = 0.0f;
      int my_path = -1, cur = i, sink;
      bool my_seen = false;
      while (true) {
        float masked = INFINITY;
        if (tx < C && !my_seen) {
          const float red = ((minval + lap_c(s, rows_dets, cur, tx, T)) - s.u[cur]) - s.v[tx];
          if (red < my_short) { my_short = red; my_path = cur; }
          masked = my_short;
        }
        int j;
        block_argmin(s, masked, tx, minval, j);
        ++steps;
        if (tx == j) my_seen = true;
        const int rj = s.row4col[j];
        if (rj < 0) { sink = j; break; }
        cur = rj;
      }
      if (tx < C) { s.sh_short[tx] = my_short; s.sh_seen[tx] = my_seen; s.sh_path[tx] = my_path; }
      __syncthreads();
      // duals: u over the alternating tree, v over the seen columns
      if (tx < R) {
        if (tx == i) {
          s.u[i] = s.u[i] + minval;
        } else {
          const int cj = s.col4row[tx];
          if (cj >= 0 && s.sh_seen[cj]) s.u[tx] = s.u[tx] + (minval - s.sh_short[cj]);
        }
      }
      if (tx < C && my_seen) s.v[tx] = s.v[tx] - (minval - my_short);
      __syncthreads();
      if (tx == 0) {  // augment from the free column back to row i
        int j = sink;
        while (true) {
          const int rr = s.sh_path[j];
          s.row4col[j] = rr;
          const int jn = s.col4row[rr];
          s.col4row[rr] = j;
          if (rr == i) break;
          j = jn;
        }
      }
      __syncthreads();
    }
  }
  __syncthreads();
  // gate and turn into a track -> detection match
  if (rows_dets) {
    if (tx < K) {
      const int j = s.col4row[tx];
      const int jj = min(max(j, 0), T - 1);
      if (s.dmask[tx] && j >= 0 && s.active[jj] && s.cost[tx * T + jj] <= a.gate) s.match[jj] = tx;
    }
  } else if (tx < T) {
    const int j = s.col4row[tx];
    const int jj = min(max(j, 0), K - 1);
    const bool ok = s.active[tx] && j >= 0 && s.dmask[jj] && s.cost[jj * T + tx] <= a.gate;
    s.match[tx] = ok ? jj : -1;
  }
  return conflict;
}

// greedy_assign -> s.match: the global minimum under the gate, min(K, T)
// times; ``rounds`` counts the arg-mins taken.
__device__ void greedy_assign(const Smem& s, const FireScanArgs& a, int& rounds) {
  const int T = a.T, K = a.K, n = blockDim.x, tx = threadIdx.x;
  for (int idx = tx; idx < K * T; idx += n) {
    const int k = idx / T, t = idx - k * T;
    float c = (s.dmask[k] && s.active[t]) ? s.cost[idx] : BIG;
    s.cost[idx] = c <= a.gate ? c : BIG;
  }
  __syncthreads();
  const int pairs = min(K, T);
  for (int it = 0; it < pairs; ++it) {
    float best = INFINITY;
    int bi = 0x7fffffff;
    for (int idx = tx; idx < K * T; idx += n) {
      if (before(s.cost[idx], idx, best, bi)) { best = s.cost[idx]; bi = idx; }
    }
    block_argmin(s, best, bi, best, bi);
    ++rounds;
    if (!(best < BIG / 2.0f)) break;  // nothing left: later rounds change nothing
    const int di = bi / T, ti = bi - di * T;
    if (tx == 0) s.match[ti] = di;
    for (int t = tx; t < T; t += n) s.cost[di * T + t] = BIG;
    for (int k = tx; k < K; k += n) s.cost[k * T + ti] = BIG;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(MAX_THREADS) track_scan_kernel(const FireScanArgs a) {
  extern __shared__ float4 smem_raw[];
  const int T = a.T, K = a.K, tx = threadIdx.x, n = blockDim.x;
  const Smem s = carve(reinterpret_cast<float*>(smem_raw), T, K);
  const bool ident = a.gid != nullptr;

  // the table: shared state in shared memory, a track's own in its thread's registers
  int tid = 0, age = 0, tsu = 0, hits = 0, streak = 0;
  int gid = -1, unk = 0, emb_src = -1;
  float sim = 0.0f;
  bool pending = false;
  for (int i = tx; i < 10 * T; i += n) s.x[(i / 10) * XS + i % 10] = a.x[i];
  for (int i = tx; i < 100 * T; i += n) s.p[(i / 100) * PS + i % 100] = a.p[i];
  if (tx < T) {
    tid = a.tid[tx]; age = a.age[tx]; tsu = a.tsu[tx]; hits = a.hits[tx]; streak = a.streak[tx];
    s.active[tx] = a.active[tx] != 0;
    if (ident) { gid = a.gid[tx]; sim = a.sim[tx]; unk = a.unk[tx]; pending = a.pending[tx] != 0; }
  }
  int next_id = *a.next_id;
  int jv = 0, predicted = 0, updated = 0, steps = 0, rounds = 0;
  __syncthreads();

  for (int f = 0; f < a.B; ++f) {
    // predict, the tracks' boxes, this frame's detections
    const int old_tid = tid;
    if (tx < T) {
      if (s.active[tx]) {
        predict(s, tx, a);
        ++predicted;
        age += 1;
        tsu += 1;
      }
      s.tbox[tx] = state_to_box(s, tx, a);
      s.match[tx] = -1;
    }
    if (tx < K) {
      const float* b = a.boxes + (static_cast<size_t>(f) * K + tx) * 4;
      s.dbox[tx] = make_float4(b[0], b[1], b[2], b[3]);
      s.dmask[tx] = a.mask[static_cast<size_t>(f) * K + tx] != 0;
      s.det_matched[tx] = 0;
    }
    __syncthreads();
    for (int idx = tx; idx < K * T; idx += n) {
      const int k = idx / T;
      s.cost[idx] = pair_cost(s.dbox[k], s.tbox[idx - k * T], a.max_distance);
    }
    __syncthreads();
    if (a.greedy) {
      greedy_assign(s, a, rounds);
    } else if (lap_assign(s, a, steps)) {
      ++jv;
    }
    __syncthreads();

    // update matched tracks, prune
    int m = -1;
    bool matched = false, alive = false;
    if (tx < T) {
      m = s.match[tx];
      matched = m >= 0 && s.active[tx];
      m = min(max(m, 0), K - 1);
      if (matched) {
        float z[4];
        bbox_to_z(s.dbox[m], a, z);
        kf_update(s, tx, z, a);
        ++updated;
        tsu = 0;
        hits += 1;
        streak += 1;
        s.det_matched[m] = 1;
      }
      alive = s.active[tx] && tsu <= a.max_age;
    }
    __syncthreads();
    // spawn: the rank-i unmatched detection into the rank-i free slot;
    // both ranks from one scan (detections in the low 16 bits)
    const bool unmatched = tx < K && s.dmask[tx] && !s.det_matched[tx];
    const bool is_free = tx < T && !alive;
    int total;
    const int incl = block_scan(s, (unmatched ? 1 : 0) + (is_free ? 1 << 16 : 0), total);
    const int n_unmatched = total & 0xffff, n_free = total >> 16;
    const int det_rank = (incl & 0xffff) - 1, free_rank = (incl >> 16) - 1;
    if (unmatched && det_rank < n_free) s.rank2det[det_rank] = tx;
    __syncthreads();
    if (tx < T) {
      int src = matched ? m : -1;
      if (is_free && free_rank < n_unmatched) {
        src = s.rank2det[free_rank];
        float z[4];
        bbox_to_z(s.dbox[src], a, z);
#pragma unroll
        for (int e = 0; e < 10; ++e) s.x[tx * XS + e] = e < 4 ? z[e] : 0.0f;
#pragma unroll
        for (int e = 0; e < 100; ++e) s.p[tx * PS + e] = (e % 11 == 0) ? 1.0f : 0.0f;
        tid = next_id + free_rank;
        age = tsu = hits = streak = 0;
        alive = true;
      }
      s.active[tx] = alive;
      const bool confirmed = alive && hits >= a.min_hits;
      const float4 box = state_to_box(s, tx, a);
      const size_t o = static_cast<size_t>(f) * T + tx;
      a.o_tid[o] = tid;
      reinterpret_cast<int4*>(a.o_boxes)[o] = make_int4(static_cast<int>(box.x), static_cast<int>(box.y),
                                                        static_cast<int>(box.z), static_cast<int>(box.w));
      a.o_age[o] = age;
      a.o_mask[o] = confirmed;
      a.o_src[o] = src;

      if (ident) {  // the batched step's identity bookkeeping
        const bool has_det = src >= 0 && alive;
        const size_t d = static_cast<size_t>(f) * K + min(max(src, 0), K - 1);
        const bool has_emb = has_det && a.det_has_emb[d];
        const int tgid = has_det ? a.det_gid[d] : -1;
        const float tsim = has_det ? a.det_sim[d] : 0.0f;
        if (has_emb) emb_src = static_cast<int>(d);
        if (tid != old_tid) {  // a fresh slot starts its identity anew
          gid = -1; sim = 0.0f; unk = 0; pending = false;
        }
        if (has_det && tsim > a.similarity_threshold && gid < 0) { gid = tgid; sim = tsim; }
        pending = pending && gid < 0;
        const bool sighted = has_emb && gid < 0 && confirmed;
        if (sighted) unk += 1;
        const bool enroll = sighted && unk >= a.unknown_trigger && !pending;
        pending = pending || enroll;
        a.o_gid[o] = gid;
        a.o_sim[o] = gid >= 0 ? sim : 0.0f;
        a.o_enroll[o] = enroll && confirmed;
        a.o_emb_src[o] = emb_src;
      }
    }
    next_id += min(n_unmatched, n_free);
    __syncthreads();
  }

  // write the table back
  for (int i = tx; i < 10 * T; i += n) a.x[i] = s.x[(i / 10) * XS + i % 10];
  for (int i = tx; i < 100 * T; i += n) a.p[i] = s.p[(i / 100) * PS + i % 100];
  if (tx < T) {
    a.tid[tx] = tid; a.age[tx] = age; a.tsu[tx] = tsu; a.hits[tx] = hits; a.streak[tx] = streak;
    a.active[tx] = s.active[tx];
    if (ident) { a.gid[tx] = gid; a.sim[tx] = sim; a.unk[tx] = unk; a.pending[tx] = pending; }
  }
  if (tx == 0) *a.next_id = next_id;
  if (a.stats) {
    if (predicted) atomicAdd(&a.stats[1], predicted);
    if (updated) atomicAdd(&a.stats[2], updated);
    if (tx == 0) {
      a.stats[0] += jv;
      atomicAdd(&a.stats[3], steps);
      atomicAdd(&a.stats[4], rounds);
    }
  }
}

}  // namespace

// Launch K2 on ``stream``.  ``threads`` is max(T, K) rounded up to a warp,
// ``smem_bytes`` the dynamic shared memory, both checked against the
// arguments.  Returns 0, a cudaError_t, or ERR_BAD_ARGS (20001).
extern "C" int fire_track_scan(const FireScanArgs* args, int threads, int smem_bytes,
                               void* stream) {
  const FireScanArgs& a = *args;
  if (a.T < 1 || a.K < 1 || a.T > MAX_THREADS || a.K > MAX_THREADS || a.B < 1) return ERR_BAD_ARGS;
  const int want = ((a.T > a.K ? a.T : a.K) + 31) / 32 * 32;
  if (threads != want || smem_bytes < smem_words(a.T, a.K) * 4) return ERR_BAD_ARGS;
  // the opt-in above 48 KB is per function and device: raise it once per size
  static int attr_bytes[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return ERR_BAD_ARGS;
  if (smem_bytes > 48 * 1024 && smem_bytes > attr_bytes[dev]) {
    e = cudaFuncSetAttribute(track_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
    if (e != cudaSuccess) return e;
    attr_bytes[dev] = smem_bytes;
  }
  track_scan_kernel<<<1, threads, smem_bytes, reinterpret_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
