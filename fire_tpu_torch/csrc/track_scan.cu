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
// predict -> cost -> assignment -> update -> emit depend on each other.
//
// What stalled the chain in the first design (one thread per track and
// per detection, thread 0's clock64 by phase, NVIDIA H100 80GB HBM3 at
// 700 W, B = 64 / T = 64 / K = 8, cycles a frame): the row-minimum fast
// path 9,500 (a row per thread, 64 columns one after another, two
// dependent shared loads each), the JV solve 9,200 (two block barriers a
// Dijkstra step), the cost 6,400 (eight pairs a thread, each a chain of
// divisions and a square root), the KF update 5,800 (1,550 dependent
// operations on one thread), predict 1,400, the rest about 2,000 (the
// detections and identity inputs read from device memory on the chain).
// The crowd (T = 192, K = 128) spent 631,000 of its 788,000 cycles a frame
// in the JV solve: 423 Dijkstra steps of 1,490 cycles, each a block arg-min
// between two block barriers.
// This design, one block of one to eight warps (a 256-thread bound keeps
// 255 registers, so the loads of a scan are issued together):
// * Inputs ahead of the chain.  The detection-side inputs of a chunk of
//   frames (boxes, mask, det_gid, det_sim, det_has_emb) come into shared
//   memory by cp.async.bulk, completion on an mbarrier, two chunks in
//   flight: while chunk c is tracked, chunk c + 1 is on its way.  The
//   per-frame outputs are stored to device memory, where nothing waits
//   on them.
// * The Kalman filter across lanes: ten lanes a track, three tracks a
//   warp, a lane per row of P, over a list of the active (predict) or
//   matched (update) tracks.  Every element keeps the plain version's
//   ordered sum; the 4x4 inverse is computed by each of the ten lanes
//   alike, and the rows of K = P H^T S^-1 go between them by shuffles.
//   The matched tracks' update runs on warps 1 and up as soon as warp 0
//   has listed them (named barrier 1), beside warp 0's spawn ranks.
// * The cost and the fast path in one block-wide pass: a group of lanes
//   a row computes the row's pairs (only where both sides are live;
//   masked pairs get the PAD or BIG they are read as) and its first
//   minimum as it goes, and claims that column in a bitmap: a column
//   claimed twice is the fast path's conflict.  No second scan of the
//   cost is made.
// * The JV solve and greedy in warp 0, no block barrier inside.  A lane
//   owns the columns j = lane + 32 q, their shortest distance, path, seen
//   flag and dual v in registers (up to 512 columns; beyond, in memory);
//   a Dijkstra step's arg-min is two warp reductions (redux.sync) over a
//   key that orders floats as torch.argmin does (NaN first, then the
//   smaller value), then over the lowest index holding it.  The duals of
//   the alternating tree are updated from the list of rows the search
//   took, not from a pass over all rows.  Greedy keeps each row's
//   minimum and scans again only the rows whose minimum was taken.  The
//   same warp gates, ranks the unmatched detections and free slots with
//   ballots, and writes the lists the other warps work from.
// * Scans issue their loads together: indices are clamped rather than
//   predicated, and keys are masked by integer arithmetic, because ptxas
//   serialises loads that each need one of its seven predicate registers.
// * No ceiling.  Threads stride over tracks, detections and pairs, and
//   all per-track state lives in memory.  The launch plan (track/scan.py
//   launch_plan) puts every array in shared memory where all fit, else
//   first the cost and then P and x (in place, in the table itself), then
//   the rest, in a device scratch buffer the wrapper allocates.  The
//   kernel is built twice: with every array in shared memory (each
//   address derived from the shared array, so 32-bit shared loads), and
//   with generic pointers for the shapes that spill.
// What still holds the chain (B = 64 / T = 64 / K = 8, thread 0's cycles a
// frame): the JV frames' solve, about 3,700 a frame on average; the cost
// pass, about 2,500; the spawn ranks, predict, the detections' log z and
// emit (with the wait for the KF updates beside the ranks), 1,100 to
// 1,800 each.  The clock read after a barrier is not held by it (the
// barrier defers blocking), so a phase's count runs from thread 0's
// arrival at one barrier to its arrival at the next.  The crowd spends
// 77% of its time in 423 Dijkstra steps a frame and the duals and
// augmenting path of its 128 rows.  PERF.md section 6 has both
// breakdowns.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float PAD = 16384.0f;   // assignment.py _PAD = 2**14
constexpr float BIG = 1e9f;       // assignment.py BIG
constexpr int ERR_BAD_ARGS = 20001;
constexpr int MAX_THREADS = 256;
constexpr int MAX_SHARED = 232448;
constexpr unsigned FULL = 0xffffffffu;
constexpr long long SPIN_LIMIT = 1ll << 30;  // a lost bulk copy traps instead of hanging
// A track's state in shared memory: x in XS words, P in PS words (odd
// strides, so the rows of three tracks in a warp spread over the banks);
// in the table itself 10 and 100.
constexpr int XS = 11, PS = 101;
// Bytes before the first array: two mbarriers and the shared counters.
constexpr int MISC_BYTES = 128;

// The arrays of a launch, placed by launch_plan (track/scan.py ARRAYS).
enum { A_COST, A_P, A_X, A_TRACKS, A_DETS, A_LAP, A_CHUNKS, N_ARRAYS };
enum { IN_SHARED = 0, IN_SCRATCH = 1, IN_TABLE = 2 };
// Per-track int fields of the tracks array (T each), after T float4
// predicted boxes.
enum {
  F_TID, F_AGE, F_TSU, F_HITS, F_STREAK, F_ACTIVE, F_GID, F_SIM, F_UNK, F_PENDING, F_EMB_SRC,
  F_SRC, F_FRESH, F_ALIST, F_UL_T, F_UL_D, N_TRACK_FIELDS
};
// The shared counters after the mbarriers.
enum { M_NACT, M_NMATCH, M_NEXT_ID, M_CONFLICT };
// stats: counts, then thread 0's cycles by phase.
enum {
  S_JV, S_PREDICTED, S_UPDATED, S_STEPS, S_ROUNDS, S_CYC, N_STATS = S_CYC + 9
};
enum { P_LOAD, P_PREDICT, P_COST, P_FAST, P_SOLVE, P_SPAWN, P_UPDATE, P_EMIT, P_TOTAL };

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
  long long* stats;  // (14,) added here, or null: frames that took the JV solve, track
                     // predictions, KF updates, Dijkstra steps, greedy rounds, then thread 0's
                     // clock64 cycles by phase: load, predict, cost, fast path, JV or greedy,
                     // spawn ranks, spawn writes to the barrier (the matched tracks' KF
                     // updates run beside both on the other warps), emit, and the launch
  void* scratch;     // device scratch for the arrays placed there, or null
  long long off[N_ARRAYS];  // byte offset of each array in its space
  int where[N_ARRAYS];      // IN_SHARED, IN_SCRATCH or IN_TABLE (p and x)
  int B, K, T;
  int greedy;
  int max_age, min_hits, unknown_trigger;
  int chunk_frames;  // frames a staging chunk holds; 0: the inputs are read where they lie
  float q[10];       // diagonal of Q
  float r_diag, max_velocity, max_acceleration, min_log_area, min_log_aspect, min_wh, max_wh;
  float max_distance, gate, similarity_threshold;
};

namespace {

__host__ __device__ inline long long r16(long long n) { return (n + 15) / 16 * 16; }

// One staging buffer: boxes, det_gid, det_sim, mask, det_has_emb of F frames.
__host__ __device__ inline long long chunk_bytes(int f, int k) {
  const long long n = static_cast<long long>(f) * k;
  return 16 * n + 2 * r16(4 * n) + 2 * r16(n);
}

// Bytes of array ``a`` placed at ``where`` (launch_plan's _array_bytes).
__host__ __device__ inline long long array_bytes(int a, int t, int k, int f, int where) {
  const long long T = t, K = k, R = t < k ? t : k, C = t < k ? k : t;
  switch (a) {
    case A_COST: return r16(4 * K * T);
    case A_P: return where == IN_TABLE ? 0 : r16(4 * T * PS);
    case A_X: return where == IN_TABLE ? 0 : r16(4 * T * XS);
    case A_TRACKS: return r16(16 * T + 4 * T * N_TRACK_FIELDS);
    case A_DETS: return r16(32 * K + 12 * K);
    case A_LAP: return r16(4 * (2 * R + 5 * C + (C + 31) / 32 + 2 * K));
    default: return f > 0 ? 2 * chunk_bytes(f, k) : 0;
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(arrivals) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase differs from ``parity``.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (long long spins = 0; !done; ++spins) {
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

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Where the kernel finds each array, through generic pointers.
struct View {
  float* cost;  // (R, C) row-major for the LAP, (K, T) for greedy
  float* p;
  float* x;
  int ps, xs;   // a track's stride in p and x
  float4* tbox; // (T,) predicted track boxes
  int* trk;     // field f of track t at trk[f * T + t]
  float4* dbox; // (K,) this frame's detections
  float4* dz;   // (K,) their measurements [cx, cy, log s, log r]
  int* dmask;
  int* dmatched;
  int* rank2det;
  float* u;     // the JV duals and matching: rows R, columns C
  int* col4row;
  float* v;
  int* row4col;
  float* sshort;
  int* spath;
  int* sseen;
  unsigned* claim;  // ceil(C / 32): columns taken by the fast path's row minima
  float* rmin_v;    // greedy: each detection row's minimum and its column
  int* rmin_i;
  unsigned char* chunk;  // two staging buffers of chunk_bytes each
  uint64_t* bar;    // two mbarriers, one per staging buffer
  int* misc;
};

extern __shared__ __align__(16) unsigned char k2_smem[];

// The arrays' addresses, from the launch's arguments alone (kernel
// parameters, which no store can alias): each phase carves its own, so
// that no pointer is kept in, or read back from, memory.  With S (every
// array in shared memory) each address derives from the shared array
// itself, and the compiler emits shared loads and stores on 32-bit
// addresses; else they are generic.
template <bool S>
__device__ __forceinline__ View carve(const FireScanArgs& a) {
  unsigned char* smem = k2_smem;
  const int T = a.T, K = a.K, R = T < K ? T : K, C = T < K ? K : T;
  auto base = [&](int i) -> unsigned char* {
    if constexpr (S) return smem + a.off[i];
    return (a.where[i] == IN_SHARED ? smem : static_cast<unsigned char*>(a.scratch)) + a.off[i];
  };
  View w;
  w.cost = reinterpret_cast<float*>(base(A_COST));
  if constexpr (S) {
    w.p = reinterpret_cast<float*>(base(A_P));
    w.ps = PS;
    w.x = reinterpret_cast<float*>(base(A_X));
    w.xs = XS;
  } else {
    const bool p_table = a.where[A_P] == IN_TABLE, x_table = a.where[A_X] == IN_TABLE;
    w.p = p_table ? a.p : reinterpret_cast<float*>(base(A_P));
    w.ps = p_table ? 100 : PS;
    w.x = x_table ? a.x : reinterpret_cast<float*>(base(A_X));
    w.xs = x_table ? 10 : XS;
  }
  unsigned char* tr = base(A_TRACKS);
  w.tbox = reinterpret_cast<float4*>(tr);
  w.trk = reinterpret_cast<int*>(tr + 16 * T);
  unsigned char* de = base(A_DETS);
  w.dbox = reinterpret_cast<float4*>(de);
  w.dz = w.dbox + K;
  int* di = reinterpret_cast<int*>(w.dz + K);
  w.dmask = di;
  w.dmatched = di + K;
  w.rank2det = di + 2 * K;
  float* l = reinterpret_cast<float*>(base(A_LAP));
  w.u = l;
  w.col4row = reinterpret_cast<int*>(l + R);
  w.v = l + 2 * R;
  w.row4col = reinterpret_cast<int*>(l + 2 * R + C);
  w.sshort = l + 2 * R + 2 * C;
  w.spath = reinterpret_cast<int*>(l + 2 * R + 3 * C);
  w.sseen = reinterpret_cast<int*>(l + 2 * R + 4 * C);
  w.claim = reinterpret_cast<unsigned*>(l + 2 * R + 5 * C);
  w.rmin_v = l + 2 * R + 5 * C + (C + 31) / 32;
  w.rmin_i = reinterpret_cast<int*>(w.rmin_v + K);
  w.chunk = smem + a.off[A_CHUNKS];
  w.bar = reinterpret_cast<uint64_t*>(smem);
  w.misc = reinterpret_cast<int*>(smem + 16);
  return w;
}

// One frame's detection-side inputs: in a staging buffer, or where they lie.
struct FrameIn {
  const float4* box;
  const uint8_t* mask;
  const int* gid;
  const float* sim;
  const uint8_t* has_emb;
};

template <bool S>
__device__ __forceinline__ FrameIn frame_in(const FireScanArgs& a, int f, int c, int lf) {
  const View w = carve<S>(a);
  const int K = a.K, F = a.chunk_frames;
  FrameIn in;
  if (F == 0) {
    const long long o = static_cast<long long>(f) * K;
    in.box = reinterpret_cast<const float4*>(a.boxes) + o;
    in.mask = a.mask + o;
    in.gid = a.det_gid ? a.det_gid + o : nullptr;
    in.sim = a.det_sim ? a.det_sim + o : nullptr;
    in.has_emb = a.det_has_emb ? a.det_has_emb + o : nullptr;
    return in;
  }
  const int n = F * K, o = lf * K;
  const unsigned char* buf = w.chunk + (c & 1) * static_cast<int>(chunk_bytes(F, K));
  in.box = reinterpret_cast<const float4*>(buf) + o;
  in.gid = reinterpret_cast<const int*>(buf + 16 * n) + o;
  in.sim = reinterpret_cast<const float*>(buf + 16 * n + r16(4 * n)) + o;
  in.mask = buf + 16 * n + 2 * r16(4 * n) + o;
  in.has_emb = buf + 16 * n + 2 * r16(4 * n) + r16(n) + o;
  return in;
}

// Starts the copies of chunk ``c`` into its staging buffer: the 16-byte
// multiples by cp.async.bulk, completion on the buffer's mbarrier, the
// last bytes of a short final chunk by this thread.
template <bool S>
__device__ __forceinline__ void issue_chunk(const FireScanArgs& a, int c) {
  const View w = carve<S>(a);
  const int K = a.K, F = a.chunk_frames;
  const int f0 = c * F, nf = min(F, a.B - f0);
  const long long n = static_cast<long long>(F) * K, m = static_cast<long long>(nf) * K;
  const long long o = static_cast<long long>(f0) * K;
  unsigned char* dst = w.chunk + (c & 1) * chunk_bytes(F, K);
  const bool ident = a.det_gid != nullptr;
  struct Part { unsigned char* dst; const unsigned char* src; uint32_t bytes; };
  const Part parts[5] = {
      {dst, reinterpret_cast<const unsigned char*>(a.boxes) + 16 * o,
       static_cast<uint32_t>(16 * m)},
      {dst + 16 * n + 2 * r16(4 * n), a.mask + o, static_cast<uint32_t>(m)},
      {dst + 16 * n, ident ? reinterpret_cast<const unsigned char*>(a.det_gid) + 4 * o : nullptr,
       ident ? static_cast<uint32_t>(4 * m) : 0u},
      {dst + 16 * n + r16(4 * n),
       ident ? reinterpret_cast<const unsigned char*>(a.det_sim) + 4 * o : nullptr,
       ident ? static_cast<uint32_t>(4 * m) : 0u},
      {dst + 16 * n + 2 * r16(4 * n) + r16(n), ident ? a.det_has_emb + o : nullptr,
       ident ? static_cast<uint32_t>(m) : 0u}};
  uint32_t bulk = 0;
#pragma unroll
  for (int i = 0; i < 5; ++i) bulk += parts[i].bytes & ~15u;
  const uint32_t bar = smem_u32(&w.bar[c & 1]);
  // the buffer was last read by the generic proxy: order that before the copies
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_expect_tx(bar, bulk);
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const uint32_t b = parts[i].bytes & ~15u;
    if (b) bulk_copy(parts[i].dst, parts[i].src, b, bar);
    for (uint32_t e = b; e < parts[i].bytes; ++e) parts[i].dst[e] = parts[i].src[e];
  }
}

// An unsigned key in torch.argmin's order of values: NaN lowest, then the
// floats ascending, -0 and +0 alike (ties go to the lower index).
// Integer operations only, so that a scan of many values takes no
// predicate registers (which would keep its loads from being issued
// together).
__device__ __forceinline__ unsigned okey(float f) {
  const unsigned b = __float_as_uint(f + 0.0f);  // -0 + 0 = +0; every other value unchanged
  const unsigned k = b ^ (static_cast<unsigned>(static_cast<int>(b) >> 31) | 0x80000000u);
  const unsigned nan = static_cast<unsigned>(static_cast<int>(0x7f800000u - (b & 0x7fffffffu)) >> 31);
  return k & ~nan;
}

// ~0u where j is at or past n, else 0: masks a key without a predicate.
__device__ __forceinline__ unsigned past(int j, int n) {
  return static_cast<unsigned>((n - 1 - j) >> 31);
}

// Arg-min over the warp of one (key, index) a lane (index ~0u for none):
// the lowest key, then the lowest index among the lanes holding it.
__device__ __forceinline__ unsigned warp_argmin(unsigned key, unsigned idx, unsigned& min_key) {
  min_key = __reduce_min_sync(FULL, key);
  return __reduce_min_sync(FULL, key == min_key ? idx : ~0u);
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// _bbox_to_z: [x, y, w, h] -> [cx, cy, log s, log r] with the guards.
__device__ __forceinline__ float4 bbox_to_z(const float4 b, const FireScanArgs& a) {
  const float s = b.z * b.w;
  const float r = b.w != 0.0f ? b.z / b.w : 1.0f;
  return make_float4(b.x + b.z / 2.0f, b.y + b.w / 2.0f,
                     s > 0.0f ? logf(fmaxf(s, 1e-20f)) : a.min_log_area,
                     r > 0.0f ? logf(fmaxf(r, 1e-20f)) : a.min_log_aspect);
}

// _state_to_box: truncated [x, y, w, h] as floats holding integers.
__device__ __forceinline__ float4 state_to_box(const float* x, const FireScanArgs& a) {
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

// _clamp_state on element e of a state
__device__ __forceinline__ float clamp_elem(float v, int e, const FireScanArgs& a) {
  if (e >= 7) return clampf(v, -a.max_acceleration, a.max_acceleration);
  if (e >= 4) return clampf(v, -a.max_velocity, a.max_velocity);
  return v;
}

// cost_matrix for one (detection, track) pair.
__device__ __forceinline__ float pair_cost(const float4 d, const float4 t, float max_distance) {
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
__device__ __forceinline__ void inv4_spd(const float s[16], float o[16]) {
  const float a[4] = {s[0], s[1], s[4], s[5]};
  const float b[4] = {s[2], s[3], s[6], s[7]};
  const float c[4] = {s[8], s[9], s[12], s[13]};
  const float d[4] = {s[10], s[11], s[14], s[15]};
  float ai[4], aib[4], cab[4], sc[4], sci[4], cai[4], scicai[4], tl[4], tr[4];
  inv2(a, ai);
  mm2(ai, b, aib);
  mm2(c, aib, cab);
#pragma unroll
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

// Row r of the constant-acceleration F (dt = 1) as r + c1 * r1 + c2 * r2:
// x F^T and F P both take it, (a + c1 b) + c2 c as the plain version's
// ordered sum is for finite values.
__device__ __forceinline__ void f_row(int r, int& r1, float& c1, int& r2, float& c2) {
  if (r < 3) { r1 = 4 + r; c1 = 1.0f; r2 = 7 + r; c2 = 0.5f; }
  else if (r >= 4 && r < 7) { r1 = r + 3; c1 = 1.0f; r2 = r; c2 = 0.0f; }
  else { r1 = r; c1 = 0.0f; r2 = r; c2 = 0.0f; }
}

// kf_predict for the active tracks, ten lanes a track (lane r: row r of P
// and x[r]), three tracks a warp; then each track's box, age and tsu.
template <bool S>
__device__ __forceinline__ void predict_phase(const FireScanArgs& a, int nact) {
  const View w = carve<S>(a);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int g = lane / 10, r = lane - 10 * g;
  int* alist = w.trk + F_ALIST * a.T;
  int r1, r2;
  float c1, c2;
  f_row(r < 10 ? r : 0, r1, c1, r2, c2);
  for (int base = 3 * warp; base < nact; base += 3 * nw) {  // warp-uniform
    const int idx = base + g;
    const bool on = lane < 30 && idx < nact;
    const int t = on ? alist[idx] : 0;
    float* P = w.p + static_cast<long long>(t) * w.ps;
    float* X = w.x + static_cast<long long>(t) * w.xs;
    float nr[10], nx = 0.0f;
    if (on) {
      float fp[10];
#pragma unroll
      for (int j = 0; j < 10; ++j)
        fp[j] = (P[r * 10 + j] + c1 * P[r1 * 10 + j]) + c2 * P[r2 * 10 + j];
      // row r of (F P) F^T + Q
#pragma unroll
      for (int j = 0; j < 10; ++j) {
        float v = fp[j];
        if (j < 3) v = (fp[j] + fp[4 + j]) + fp[7 + j] * 0.5f;
        else if (j >= 4 && j < 7) v = fp[j] + fp[3 + j];
        nr[j] = j == r ? v + a.q[r] : v;
      }
      nx = clamp_elem((X[r] + c1 * X[r1]) + c2 * X[r2], r, a);
    }
    __syncwarp();
    if (on) {
#pragma unroll
      for (int j = 0; j < 10; ++j) P[r * 10 + j] = nr[j];
      X[r] = nx;
    }
    __syncwarp();
    if (on && r == 0) {
      w.tbox[t] = state_to_box(X, a);
      w.trk[F_AGE * a.T + t] += 1;
      w.trk[F_TSU * a.T + t] += 1;
    }
  }
}

// The K x T cost in the assignment's layout, and each row's first
// minimum in the same pass: a group of lanes a row (as many as the block
// has to spare, up to a warp), each scanning its columns in ascending
// order, so a strictly smaller key alone replaces its best, then a
// butterfly over the group.  Rows the assignment never reads (a masked
// detection, an inactive track) are skipped; masked columns get the
// value they are read as (PAD in the LAP, BIG in greedy).  The LAP gets
// each valid row's column in col4row and a conflict flag when two rows
// claim one column (the fast path's test); greedy gets the minima.
template <bool S>
__device__ __forceinline__ void cost_phase(const FireScanArgs& a) {
  constexpr int U = 4;  // pairs a lane takes at once: their loads, then their arithmetic
  const View w = carve<S>(a);
  const int T = a.T, K = a.K, n = blockDim.x, tx = threadIdx.x;
  const bool by_track = !a.greedy && K > T;  // the LAP's rows are tracks: (T, K)
  const int R = by_track ? T : K, C = by_track ? K : T;
  const int* active = w.trk + F_ACTIVE * T;
  const int* row_ok = by_track ? active : w.dmask;
  const float masked = a.greedy ? BIG : PAD;
  int g = 32;
  while (g > 1 && g * R > n) g >>= 1;
  const int sub = tx & (g - 1);
  for (int rb = 0; rb < R; rb += n / g) {  // block-uniform
    const int r = rb + tx / g;
    const bool on = r < R && row_ok[min(r, R - 1)];
    float best = INFINITY;
    unsigned bkey = ~0u, bj = ~0u;
    if (on) {
      float* row = w.cost + r * C;
      for (int j0 = sub; j0 < C; j0 += U * g) {
        float4 d[U], t[U];
        bool valid[U];
#pragma unroll
        for (int q = 0; q < U; ++q) {
          const int j = min(j0 + q * g, C - 1), k = by_track ? j : r, tr = by_track ? r : j;
          valid[q] = (j0 + q * g < C) & (w.dmask[k] != 0) & (active[tr] != 0);
          d[q] = w.dbox[k];
          t[q] = w.tbox[tr];
        }
#pragma unroll
        for (int q = 0; q < U; ++q) {
          const int j = j0 + q * g;
          float c = valid[q] ? pair_cost(d[q], t[q], a.max_distance) : masked;
          if (a.greedy && !(c <= a.gate)) c = BIG;
          if (j < C) row[j] = c;
          const unsigned key = okey(c) | past(j, C);
          const bool take = key < bkey;
          bkey = take ? key : bkey;
          bj = take ? j : bj;
          best = take ? c : best;
        }
      }
    }
    for (int o = g >> 1; o > 0; o >>= 1) {
      const unsigned ok = __shfl_xor_sync(FULL, bkey, o), oj = __shfl_xor_sync(FULL, bj, o);
      const float ov = __shfl_xor_sync(FULL, best, o);
      const bool take = ok < bkey || (ok == bkey && oj < bj);
      bkey = take ? ok : bkey;
      bj = take ? oj : bj;
      best = take ? ov : best;
    }
    if (r >= R || sub != 0) continue;
    if (a.greedy) {  // a skipped row is all BIG: its first minimum is column 0
      w.rmin_v[r] = on ? best : BIG;
      w.rmin_i[r] = on ? static_cast<int>(bj) : 0;
    } else if (on) {
      w.col4row[r] = static_cast<int>(bj);
      const unsigned old = atomicOr(&w.claim[bj >> 5], 1u << (bj & 31));
      if ((old >> (bj & 31)) & 1u) w.misc[M_CONFLICT] = 1;
    } else {
      w.col4row[r] = -1;
    }
  }
}

__device__ __forceinline__ unsigned lanemask_lt() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// Warp 0: the matched pair (track t, detection d) at list position pos.
__device__ __forceinline__ void record_match(const FireScanArgs& a, const View& w, int pos, int t,
                                             int d) {
  const int T = a.T;
  w.trk[F_UL_T * T + pos] = t;
  w.trk[F_UL_D * T + pos] = d;
  w.trk[F_SRC * T + t] = d;
  w.trk[F_TSU * T + t] = 0;
  w.trk[F_HITS * T + t] += 1;
  w.trk[F_STREAK * T + t] += 1;
  w.dmatched[d] = 1;
}

// The augmenting path from the free column ``sink`` back to row i, by
// lane 0 over the published paths, then the warp meets.
__device__ __forceinline__ void jv_augment(const View& w, int i, int sink) {
  if ((threadIdx.x & 31) == 0) {
    int j = sink;
    while (true) {
      const int rr = w.spath[j];
      w.row4col[j] = rr;
      const int jn = w.col4row[rr];
      w.col4row[rr] = j;
      if (rr == i) break;
      j = jn;
    }
  }
  __syncwarp();
}

// The JV solve in one warp: a Dijkstra over columns per valid row, lane
// l owning columns l + 32 q (q < W), whose shortest distance, path, seen
// flag and dual v stay in its registers; each step's arg-min is
// warp_argmin over okey()'s order.  The rows of the alternating tree
// are the rows matched to the columns the search took, in the order it
// took them (the sink's excepted): their dual update needs only that list
// and the step's minimum at each, so no pass over all rows is made.
template <int W>
__device__ __forceinline__ void jv_solve(const View& w, int R, int C, const int* row_ok,
                                         long long& steps) {
  const int lane = threadIdx.x & 31;
  int* tree_r = w.sseen;     // the tree's rows, and the minimum at which each
  float* tree_v = w.sshort;  // joined it (the short of its column, final once taken)
  float v[W];
#pragma unroll
  for (int q = 0; q < W; ++q) v[q] = 0.0f;
  for (int r = lane; r < R; r += 32) { w.u[r] = 0.0f; w.col4row[r] = -1; }
  for (int j = lane; j < C; j += 32) w.row4col[j] = -1;
  __syncwarp();
  for (int i = 0; i < R; ++i) {
    if (!row_ok[i]) continue;  // warp-uniform
    float sh[W];
    int pa[W];
    unsigned seen = 0;
#pragma unroll
    for (int q = 0; q < W; ++q) { sh[q] = INFINITY; pa[q] = -1; }
    float minval = 0.0f;
    int cur = i, sink, n_tree = 0;
    while (true) {
      const float ucur = w.u[cur];
      const float* row = w.cost + cur * C;
      float c[W];
#pragma unroll
      for (int q = 0; q < W; ++q) c[q] = row[min(lane + 32 * q, C - 1)];
      unsigned bkey = ~0u, bj = ~0u;
      float bval = INFINITY;
#pragma unroll
      for (int q = 0; q < W; ++q) {
        const int j = lane + 32 * q;
        const bool done = (seen >> q) & 1u;
        const float red = ((minval + c[q]) - ucur) - v[q];
        const bool upd = !done && red < sh[q];
        sh[q] = upd ? red : sh[q];
        pa[q] = upd ? cur : pa[q];
        const float val = done ? INFINITY : sh[q];
        const unsigned key = okey(val) | past(j, C);
        const bool take = key < bkey;
        bkey = take ? key : bkey;
        bj = take ? j : bj;
        bval = take ? val : bval;
      }
      unsigned mkey;
      const int j = static_cast<int>(warp_argmin(bkey, bj, mkey));
      minval = __shfl_sync(FULL, bval, j & 31);
      ++steps;
      if (lane == (j & 31)) seen |= 1u << (j >> 5);
      const int rj = w.row4col[j];
      if (rj < 0) { sink = j; break; }
      if (lane == 0) { tree_r[n_tree] = rj; tree_v[n_tree] = minval; }
      ++n_tree;
      cur = rj;
    }
#pragma unroll
    for (int q = 0; q < W; ++q) {
      if (lane + 32 * q < C) w.spath[lane + 32 * q] = pa[q];
      if ((seen >> q) & 1u) v[q] = v[q] - (minval - sh[q]);  // v over the taken columns
    }
    __syncwarp();
    for (int k = lane; k < n_tree; k += 32) {  // u over the tree: distinct rows
      const int r = tree_r[k];
      w.u[r] = w.u[r] + (minval - tree_v[k]);
    }
    if (lane == 0) w.u[i] = w.u[i] + minval;
    __syncwarp();
    jv_augment(w, i, sink);
  }
}

// The same solve for more columns than registers hold: the columns'
// state in memory, read eight columns a lane at a time.
__device__ __forceinline__ void jv_solve_wide(const View& w, int R, int C, const int* row_ok,
                                              long long& steps) {
  constexpr int U = 8;
  const int lane = threadIdx.x & 31;
  for (int r = lane; r < R; r += 32) { w.u[r] = 0.0f; w.col4row[r] = -1; }
  for (int j = lane; j < C; j += 32) { w.v[j] = 0.0f; w.row4col[j] = -1; }
  __syncwarp();
  for (int i = 0; i < R; ++i) {
    if (!row_ok[i]) continue;  // warp-uniform
    for (int j = lane; j < C; j += 32) {
      w.sshort[j] = INFINITY;
      w.spath[j] = -1;
      w.sseen[j] = 0;
    }
    float minval = 0.0f;
    int cur = i, sink;
    while (true) {
      const float ucur = w.u[cur];
      const float* row = w.cost + static_cast<long long>(cur) * C;
      unsigned bkey = ~0u, bj = ~0u;
      float bval = INFINITY;
      for (int j0 = lane; j0 < C; j0 += 32 * U) {
        float c[U], sh[U], vv[U];
        int done[U];
#pragma unroll
        for (int q = 0; q < U; ++q) {
          const int j = j0 + 32 * q;
          const bool in = j < C;
          c[q] = in ? row[j] : 0.0f;
          sh[q] = in ? w.sshort[j] : 0.0f;
          vv[q] = in ? w.v[j] : 0.0f;
          done[q] = in ? w.sseen[j] : 1;
        }
#pragma unroll
        for (int q = 0; q < U; ++q) {
          const int j = j0 + 32 * q;
          const float red = ((minval + c[q]) - ucur) - vv[q];
          const bool upd = j < C && !done[q] && red < sh[q];
          if (upd) { sh[q] = red; w.sshort[j] = red; w.spath[j] = cur; }
          const float val = done[q] ? INFINITY : sh[q];
          const unsigned key = j < C ? okey(val) : ~0u;
          if (key < bkey) { bkey = key; bj = j; bval = val; }
        }
      }
      unsigned mkey;
      const int j = static_cast<int>(warp_argmin(bkey, bj, mkey));
      minval = __shfl_sync(FULL, bval, j & 31);
      ++steps;
      if (lane == (j & 31)) w.sseen[j] = 1;
      const int rj = w.row4col[j];
      if (rj < 0) { sink = j; break; }
      cur = rj;
    }
    for (int j = lane; j < C; j += 32)  // v over the seen columns
      if (w.sseen[j]) w.v[j] = w.v[j] - (minval - w.sshort[j]);
    __syncwarp();
    for (int r = lane; r < R; r += 32) {  // u over the alternating tree
      if (r == i) {
        w.u[i] = w.u[i] + minval;
      } else {
        const int cj = w.col4row[r];
        if (cj >= 0 && w.sseen[cj]) w.u[r] = w.u[r] + (minval - w.sshort[cj]);
      }
    }
    __syncwarp();
    jv_augment(w, i, sink);
  }
}

// lap_assign in warp 0 -> the matched list.  Returns the list's length;
// ``jv`` says whether the frame took the JV solve, ``steps`` counts its
// Dijkstra steps.
template <bool S>
__device__ __forceinline__ int lap_assign(const FireScanArgs& a, bool& jv, long long& steps,
                                          long long* cyc, long long& clk) {
  const View w = carve<S>(a);
  const int T = a.T, K = a.K, lane = threadIdx.x & 31;
  const bool rows_dets = K <= T;
  const int R = rows_dets ? K : T, C = rows_dets ? T : K;
  const int* active = w.trk + F_ACTIVE * T;
  const int* row_ok = rows_dets ? w.dmask : active;
  // fast path: the cost pass took every valid row's cheapest column (first
  // minimum) into col4row and flagged a column claimed twice
  const bool conflict = w.misc[M_CONFLICT] != 0;
  __syncwarp();
  for (int i = lane; i < (C + 31) / 32; i += 32) w.claim[i] = 0;
  if (lane == 0) w.misc[M_CONFLICT] = 0;
  if (threadIdx.x == 0) { const long long c = clock64(); cyc[P_FAST] += c - clk; clk = c; }
  jv = conflict;
  if (conflict) {
    if (C <= 64) jv_solve<2>(w, R, C, row_ok, steps);
    else if (C <= 192) jv_solve<6>(w, R, C, row_ok, steps);
    else if (C <= 256) jv_solve<8>(w, R, C, row_ok, steps);
    else if (C <= 512) jv_solve<16>(w, R, C, row_ok, steps);
    else jv_solve_wide(w, R, C, row_ok, steps);
  }
  // gate, and the matched list in row order
  int n = 0;
  for (int rb = 0; rb < R; rb += 32) {
    const int r = rb + lane;
    bool ok = false;
    int t = 0, d = 0;
    if (r < R) {
      const int j = w.col4row[r];
      const int jj = min(max(j, 0), C - 1);
      t = rows_dets ? jj : r;
      d = rows_dets ? r : jj;
      ok = row_ok[r] && j >= 0 && (rows_dets ? active[jj] : w.dmask[jj]) &&
           w.cost[static_cast<long long>(r) * C + jj] <= a.gate;
    }
    const unsigned bal = __ballot_sync(FULL, ok);
    if (ok) record_match(a, w, n + __popc(bal & lanemask_lt()), t, d);
    n += __popc(bal);
  }
  return n;
}

// greedy_assign in warp 0 -> the matched list: the global minimum under
// the gate, min(K, T) times (rows are detections); ``rounds`` counts the
// arg-mins taken.  Each row keeps its first minimum; taking a pair
// invalidates its row and column, and only the rows whose minimum sat in
// that column are scanned again.
template <bool S>
__device__ __forceinline__ int greedy_assign(const FireScanArgs& a, long long& rounds) {
  const View w = carve<S>(a);
  const int T = a.T, K = a.K, lane = threadIdx.x & 31;
  int n = 0;
  const int pairs = min(K, T);
  for (int it = 0; it < pairs; ++it) {
    unsigned bkey = ~0u, bk = ~0u;
    float bval = INFINITY;
    for (int k = lane; k < K; k += 32) {
      const float v = w.rmin_v[k];
      const unsigned key = okey(v);
      if (key < bkey) { bkey = key; bk = k; bval = v; }
    }
    unsigned mkey;
    const int di = static_cast<int>(warp_argmin(bkey, bk, mkey));
    const float best = __shfl_sync(FULL, bval, di & 31);
    ++rounds;
    if (!(best < BIG / 2.0f)) break;  // nothing left: later rounds change nothing
    const int ti = w.rmin_i[di];
    if (lane == 0) {
      record_match(a, w, n, ti, di);
      w.rmin_v[di] = BIG;  // its row is all BIG now: first minimum at column 0
      w.rmin_i[di] = 0;
    }
    ++n;
    for (int k = lane; k < K; k += 32) w.cost[static_cast<long long>(k) * T + ti] = BIG;
    __syncwarp();
    for (int kb = 0; kb < K; kb += 32) {
      const int k = kb + lane;
      unsigned redo = __ballot_sync(FULL, k < K && w.rmin_i[k] == ti && w.rmin_v[k] < BIG);
      while (redo) {  // the whole warp scans one row
        const int rk = kb + __ffs(redo) - 1;
        redo &= redo - 1;
        const float* row = w.cost + static_cast<long long>(rk) * T;
        unsigned rkey = ~0u, rj = ~0u;
        float rv = INFINITY;
        for (int j = lane; j < T; j += 32) {
          const unsigned key = okey(row[j]);
          if (key < rkey) { rkey = key; rj = j; rv = row[j]; }
        }
        unsigned mk;
        const int j = static_cast<int>(warp_argmin(rkey, rj, mk));
        const float v = __shfl_sync(FULL, rv, j & 31);
        if (lane == 0) { w.rmin_v[rk] = v; w.rmin_i[rk] = j; }
      }
    }
    __syncwarp();
  }
  return n;
}

// Warp 0 after the matching: prune, rank the unmatched detections and the
// free slots, spawn (ids and counters; the spawned pairs follow the
// matched ones in the list), and list the active tracks for the next
// frame's predict.  Returns the spawn count.
template <bool S>
__device__ __forceinline__ int spawn_ranks(const FireScanArgs& a, int n_match) {
  const View w = carve<S>(a);
  const int T = a.T, K = a.K, lane = threadIdx.x & 31;
  int* active = w.trk + F_ACTIVE * T;
  // prune before spawn: alive = active and tsu <= max_age (0 when matched)
  int n_free = 0;
  for (int tb = 0; tb < T; tb += 32) {
    const int t = tb + lane;
    bool alive = false;
    if (t < T) {
      alive = active[t] && w.trk[F_TSU * T + t] <= a.max_age;
      active[t] = alive;
    }
    n_free += __popc(__ballot_sync(FULL, t < T && !alive));
  }
  int n_unmatched = 0;
  for (int kb = 0; kb < K; kb += 32) {
    const int k = kb + lane;
    const bool un = k < K && w.dmask[k] && !w.dmatched[k];
    const unsigned bal = __ballot_sync(FULL, un);
    const int rank = n_unmatched + __popc(bal & lanemask_lt());
    if (un && rank < n_free) w.rank2det[rank] = k;
    n_unmatched += __popc(bal);
  }
  __syncwarp();
  const int n_spawn = min(n_unmatched, n_free);
  const int next_id = w.misc[M_NEXT_ID];
  int n_free_seen = 0, n_act = 0;
  for (int tb = 0; tb < T; tb += 32) {
    const int t = tb + lane;
    const bool is_free = t < T && !active[t];
    const unsigned bal = __ballot_sync(FULL, is_free);
    const int rank = n_free_seen + __popc(bal & lanemask_lt());
    n_free_seen += __popc(bal);
    bool live = t < T && active[t];
    if (is_free && rank < n_spawn) {
      const int d = w.rank2det[rank];
      const int tid = next_id + rank;
      w.trk[F_FRESH * T + t] = tid != w.trk[F_TID * T + t];
      w.trk[F_TID * T + t] = tid;
      w.trk[F_AGE * T + t] = 0;
      w.trk[F_TSU * T + t] = 0;
      w.trk[F_HITS * T + t] = 0;
      w.trk[F_STREAK * T + t] = 0;
      w.trk[F_SRC * T + t] = d;
      w.trk[F_UL_T * T + n_match + rank] = t;
      w.trk[F_UL_D * T + n_match + rank] = d;
      active[t] = 1;
      live = true;
    }
    const unsigned lb = __ballot_sync(FULL, live);
    if (live) w.trk[F_ALIST * T + n_act + __popc(lb & lanemask_lt())] = t;
    n_act += __popc(lb);
  }
  if (lane == 0) {
    w.misc[M_NACT] = n_act;
    w.misc[M_NEXT_ID] = next_id + n_spawn;
  }
  return n_spawn;
}

// kf_update_tracker of the matched tracks (the list's first n_match
// items), ten lanes a track (lane r: row r), three tracks a warp, on
// warps w0 and up.
template <bool S>
__device__ __forceinline__ void update_phase(const FireScanArgs& a, int n_match, int w0) {
  const View w = carve<S>(a);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int g = lane / 10, r = lane < 30 ? lane - 10 * g : 0, first = 10 * g;
  const int T = a.T;
  if (warp < w0) return;
  for (int base = 3 * (warp - w0); base < n_match; base += 3 * (nw - w0)) {  // warp-uniform
    const int idx = base + g;
    const bool on = lane < 30 && idx < n_match;
    const int t = on ? w.trk[F_UL_T * T + idx] : 0;
    const int d = on ? w.trk[F_UL_D * T + idx] : 0;
    float* P = w.p + static_cast<long long>(t) * w.ps;
    float* X = w.x + static_cast<long long>(t) * w.xs;
    const float4 z4 = w.dz[d];
    const float z[4] = {z4.x, z4.y, z4.z, z4.w};
    // S = P[:4, :4] + r I, K = P[:, :4] S^-1: this lane's row of K
    float sm[16], si[16], prow[10], k[4], ks[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sm[i * 4 + j] = P[i * 10 + j] + (i == j ? a.r_diag : 0.0f);
#pragma unroll
    for (int j = 0; j < 10; ++j) prow[j] = P[r * 10 + j];
    inv4_spd(sm, si);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      k[j] = dot4(prow[0], si[j], prow[1], si[4 + j], prow[2], si[8 + j], prow[3], si[12 + j]);
    float y[4];
#pragma unroll
    for (int l = 0; l < 4; ++l) y[l] = z[l] - X[l];
    const float xr = clamp_elem(X[r] + dot4(k[0], y[0], k[1], y[1], k[2], y[2], k[3], y[3]), r, a);
    // P - (K S) K^T: this lane's row of K S, the other rows of K by shuffles
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ks[j] = dot4(k[0], sm[j], k[1], sm[4 + j], k[2], sm[8 + j], k[3], sm[12 + j]);
    float nr[10];
#pragma unroll
    for (int j = 0; j < 10; ++j) {
      float kj[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) kj[c] = __shfl_sync(FULL, k[c], first + j);
      nr[j] = prow[j] - dot4(ks[0], kj[0], ks[1], kj[1], ks[2], kj[2], ks[3], kj[3]);
    }
    __syncwarp();
    if (on) {
#pragma unroll
      for (int j = 0; j < 10; ++j) P[r * 10 + j] = nr[j];
      X[r] = xr;
    }
    __syncwarp();
  }
}

// The spawned slots' fresh state (the list's items lo .. n - 1): x = [z,
// 0], P = I, a lane a (slot, row) of warp 0.
template <bool S>
__device__ __forceinline__ void spawn_state(const FireScanArgs& a, int lo, int n) {
  const View w = carve<S>(a);
  const int T = a.T;
  for (int i = threadIdx.x & 31; i < 10 * (n - lo); i += 32) {
    const int item = lo + i / 10, r = i % 10;
    const int t = w.trk[F_UL_T * T + item], d = w.trk[F_UL_D * T + item];
    float* P = w.p + static_cast<long long>(t) * w.ps + r * 10;
#pragma unroll
    for (int j = 0; j < 10; ++j) P[j] = j == r ? 1.0f : 0.0f;
    w.x[static_cast<long long>(t) * w.xs + r] =
        r < 4 ? reinterpret_cast<const float*>(&w.dz[d])[r] : 0.0f;
  }
}

// The frame's outputs and the identity bookkeeping, a thread a track.
template <bool S>
__device__ __forceinline__ void emit_phase(const FireScanArgs& a, const FrameIn& in, int f) {
  const View w = carve<S>(a);
  const int T = a.T, K = a.K;
  const bool ident = a.gid != nullptr;
  int* tr = w.trk;
  float* simf = reinterpret_cast<float*>(tr + F_SIM * T);
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    const bool alive = tr[F_ACTIVE * T + t];
    const int tid = tr[F_TID * T + t], src = tr[F_SRC * T + t];
    const bool confirmed = alive && tr[F_HITS * T + t] >= a.min_hits;
    const float* X = w.x + static_cast<long long>(t) * w.xs;
    const float4 box = state_to_box(X, a);
    const long long o = static_cast<long long>(f) * T + t;
    a.o_tid[o] = tid;
    reinterpret_cast<int4*>(a.o_boxes)[o] = make_int4(static_cast<int>(box.x),
                                                      static_cast<int>(box.y),
                                                      static_cast<int>(box.z),
                                                      static_cast<int>(box.w));
    a.o_age[o] = tr[F_AGE * T + t];
    a.o_mask[o] = confirmed;
    a.o_src[o] = src;
    tr[F_SRC * T + t] = -1;
    const bool fresh = tr[F_FRESH * T + t];
    tr[F_FRESH * T + t] = 0;
    if (ident) {  // the batched step's identity bookkeeping
      int gid = tr[F_GID * T + t], unk = tr[F_UNK * T + t];
      float sim = simf[t];
      bool pending = tr[F_PENDING * T + t];
      const bool has_det = src >= 0 && alive;
      const int dd = min(max(src, 0), K - 1);
      const bool has_emb = has_det && in.has_emb[dd];
      const int tgid = has_det ? in.gid[dd] : -1;
      const float tsim = has_det ? in.sim[dd] : 0.0f;
      if (has_emb) tr[F_EMB_SRC * T + t] = f * K + dd;
      if (fresh) {  // a fresh slot starts its identity anew
        gid = -1; sim = 0.0f; unk = 0; pending = false;
      }
      if (has_det && tsim > a.similarity_threshold && gid < 0) { gid = tgid; sim = tsim; }
      pending = pending && gid < 0;
      const bool sighted = has_emb && gid < 0 && confirmed;
      if (sighted) unk += 1;
      const bool enroll = sighted && unk >= a.unknown_trigger && !pending;
      pending = pending || enroll;
      tr[F_GID * T + t] = gid;
      tr[F_UNK * T + t] = unk;
      simf[t] = sim;
      tr[F_PENDING * T + t] = pending;
      a.o_gid[o] = gid;
      a.o_sim[o] = gid >= 0 ? sim : 0.0f;
      a.o_enroll[o] = enroll && confirmed;
      a.o_emb_src[o] = tr[F_EMB_SRC * T + t];
    }
  }
}

template <bool S>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    track_scan_kernel(const __grid_constant__ FireScanArgs a) {
  const int T = a.T, K = a.K, B = a.B, F = a.chunk_frames, tx = threadIdx.x, n = blockDim.x;
  const int warp = tx >> 5, nw = n >> 5;
  const bool ident = a.gid != nullptr;
  const View w = carve<S>(a);
  const int n_chunks = F > 0 ? (B + F - 1) / F : 0;
  long long cyc[P_TOTAL + 1] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  long long clk = clock64();
  const long long clk0 = clk;
  long long jv_frames = 0, predicted = 0, updated = 0, steps = 0, rounds = 0;
#define PHASE(i) \
  if (tx == 0) { const long long c_ = clock64(); cyc[i] += c_ - clk; clk = c_; }

  if (tx == 0) {
    mbar_init(smem_u32(&w.bar[0]), 1);
    mbar_init(smem_u32(&w.bar[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (n_chunks > 0) issue_chunk<S>(a, 0);
    w.misc[M_NEXT_ID] = *a.next_id;
    w.misc[M_CONFLICT] = 0;
  }
  // the table into the working arrays
  if (a.where[A_X] == IN_SHARED)
    for (int i = tx; i < 10 * T; i += n) w.x[(i / 10) * XS + i % 10] = a.x[i];
  if (a.where[A_P] == IN_SHARED)
    for (int i = tx; i < 100 * T; i += n) w.p[(i / 100) * PS + i % 100] = a.p[i];
  float* simf = reinterpret_cast<float*>(w.trk + F_SIM * T);
  for (int t = tx; t < T; t += n) {
    w.trk[F_TID * T + t] = a.tid[t];
    w.trk[F_AGE * T + t] = a.age[t];
    w.trk[F_TSU * T + t] = a.tsu[t];
    w.trk[F_HITS * T + t] = a.hits[t];
    w.trk[F_STREAK * T + t] = a.streak[t];
    w.trk[F_ACTIVE * T + t] = a.active[t] != 0;
    w.trk[F_GID * T + t] = ident ? a.gid[t] : -1;
    simf[t] = ident ? a.sim[t] : 0.0f;
    w.trk[F_UNK * T + t] = ident ? a.unk[t] : 0;
    w.trk[F_PENDING * T + t] = ident ? a.pending[t] != 0 : 0;
    w.trk[F_EMB_SRC * T + t] = -1;
    w.trk[F_SRC * T + t] = -1;
    w.trk[F_FRESH * T + t] = 0;
  }
  for (int i = tx; i < ((T > K ? T : K) + 31) / 32; i += n) w.claim[i] = 0;
  __syncthreads();
  if (warp == 0) {  // the list of active tracks
    int n_act = 0;
    for (int tb = 0; tb < T; tb += 32) {
      const int t = tb + (tx & 31);
      const bool live = t < T && w.trk[F_ACTIVE * T + t];
      const unsigned b = __ballot_sync(FULL, live);
      if (live) w.trk[F_ALIST * T + n_act + __popc(b & lanemask_lt())] = t;
      n_act += __popc(b);
    }
    if (tx == 0) w.misc[M_NACT] = n_act;
  }
  __syncthreads();

  for (int f = 0, c = 0, lf = 0; f < B; ++f) {  // frame f is frame lf of chunk c
    // this frame's detections: from the staging buffer once its chunk is in
    if (F > 0 && lf == 0) mbar_wait(smem_u32(&w.bar[c & 1]), static_cast<uint32_t>(c >> 1) & 1u);
    const FrameIn in = frame_in<S>(a, f, c, lf);
    for (int k = tx; k < K; k += n) {
      const float4 b = in.box[k];
      w.dbox[k] = b;
      w.dz[k] = bbox_to_z(b, a);
      w.dmask[k] = in.mask[k] != 0;
      w.dmatched[k] = 0;
    }
    __syncthreads();
    PHASE(P_LOAD)
    // the next chunk into the buffer the last one left
    if (F > 0 && lf == 0 && c + 1 < n_chunks && tx == n - 32) issue_chunk<S>(a, c + 1);
    const int nact = w.misc[M_NACT];
    predicted += nact;
    predict_phase<S>(a, nact);
    __syncthreads();
    PHASE(P_PREDICT)
    cost_phase<S>(a);
    __syncthreads();
    PHASE(P_COST)
    // warp 0 assigns; once the matched list is out (named barrier 1) the
    // other warps update the matched tracks while warp 0 ranks the spawns
    if (warp == 0) {
      int n_match;
      if (a.greedy) {
        n_match = greedy_assign<S>(a, rounds);
      } else {
        bool jv;
        n_match = lap_assign<S>(a, jv, steps, cyc, clk);
        jv_frames += jv;
      }
      updated += n_match;
      if (tx == 0) w.misc[M_NMATCH] = n_match;
      PHASE(P_SOLVE)
      __syncwarp();
      if (nw > 1) asm volatile("bar.arrive 1, %0;\n" ::"r"(n) : "memory");
      const int n_spawn = spawn_ranks<S>(a, n_match);
      __syncwarp();
      PHASE(P_SPAWN)
      spawn_state<S>(a, n_match, n_match + n_spawn);
      if (nw == 1) update_phase<S>(a, n_match, 0);
    } else {
      asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
      update_phase<S>(a, w.misc[M_NMATCH], 1);
    }
    __syncthreads();
    PHASE(P_UPDATE)
    emit_phase<S>(a, in, f);
    __syncthreads();
    PHASE(P_EMIT)
    if (F > 0 && ++lf == F) { lf = 0; ++c; }
  }
#undef PHASE

  // write the table back
  if (a.where[A_X] == IN_SHARED)
    for (int i = tx; i < 10 * T; i += n) a.x[i] = w.x[(i / 10) * XS + i % 10];
  if (a.where[A_P] == IN_SHARED)
    for (int i = tx; i < 100 * T; i += n) a.p[i] = w.p[(i / 100) * PS + i % 100];
  for (int t = tx; t < T; t += n) {
    a.tid[t] = w.trk[F_TID * T + t];
    a.age[t] = w.trk[F_AGE * T + t];
    a.tsu[t] = w.trk[F_TSU * T + t];
    a.hits[t] = w.trk[F_HITS * T + t];
    a.streak[t] = w.trk[F_STREAK * T + t];
    a.active[t] = w.trk[F_ACTIVE * T + t] != 0;
    if (ident) {
      a.gid[t] = w.trk[F_GID * T + t];
      a.sim[t] = simf[t];
      a.unk[t] = w.trk[F_UNK * T + t];
      a.pending[t] = w.trk[F_PENDING * T + t] != 0;
    }
  }
  if (tx == 0) {
    *a.next_id = w.misc[M_NEXT_ID];
    if (a.stats) {
      cyc[P_TOTAL] = clock64() - clk0;
      const long long counts[S_CYC] = {jv_frames, predicted, updated, steps, rounds};
      auto add = [&](int i, long long v) {
        atomicAdd(reinterpret_cast<unsigned long long*>(a.stats + i),
                  static_cast<unsigned long long>(v));
      };
#pragma unroll
      for (int i = 0; i < S_CYC; ++i) add(i, counts[i]);
#pragma unroll
      for (int i = 0; i <= P_TOTAL; ++i) add(S_CYC + i, cyc[i]);
    }
  }
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

// The plan's placement: sizes as array_bytes says, every shared array
// after the counters, 16-byte aligned, inside ``smem_bytes`` and apart
// from the others; scratch arrays inside ``scratch_bytes``.
bool plan_ok(const FireScanArgs& a, int smem_bytes, long long scratch_bytes) {
  long long lo[N_ARRAYS], hi[N_ARRAYS];
  for (int i = 0; i < N_ARRAYS; ++i) {
    const int where = a.where[i];
    if (where == IN_TABLE && i != A_P && i != A_X) return false;
    if (where != IN_SHARED && where != IN_SCRATCH && where != IN_TABLE) return false;
    if (i == A_CHUNKS && a.chunk_frames > 0 && where != IN_SHARED) return false;
    const long long size = array_bytes(i, a.T, a.K, a.chunk_frames, where);
    lo[i] = a.off[i];
    hi[i] = a.off[i] + size;
    if (where == IN_TABLE || size == 0) continue;
    if (lo[i] < 0 || lo[i] % 16 != 0) return false;
    if (where == IN_SHARED && (lo[i] < MISC_BYTES || hi[i] > smem_bytes)) return false;
    if (where == IN_SCRATCH && (a.scratch == nullptr || hi[i] > scratch_bytes)) return false;
    for (int j = 0; j < i; ++j)
      if (a.where[j] == where && hi[j] > lo[j] && lo[i] < hi[j] && lo[j] < hi[i]) return false;
  }
  return true;
}

}  // namespace

// Launch K2 on ``stream``: ``threads`` a multiple of 32 up to 512,
// ``smem_bytes`` of dynamic shared memory and ``scratch_bytes`` of
// scratch as launch_plan gave them, checked against the arguments.
// Returns 0, a cudaError_t, or ERR_BAD_ARGS (20001).
extern "C" int fire_track_scan(const FireScanArgs* args, int threads, int smem_bytes,
                               long long scratch_bytes, void* stream) {
  const FireScanArgs& a = *args;
  if (a.T < 1 || a.K < 1 || a.B < 1 || a.chunk_frames < 0) return ERR_BAD_ARGS;
  if (threads < 32 || threads > MAX_THREADS || threads % 32 != 0) return ERR_BAD_ARGS;
  if (smem_bytes < MISC_BYTES || smem_bytes > MAX_SHARED || !plan_ok(a, smem_bytes, scratch_bytes))
    return ERR_BAD_ARGS;
  if (a.chunk_frames > 0) {  // the bulk copies' sources: 16-byte aligned, chunk starts too
    if ((static_cast<long long>(a.chunk_frames) * a.K) % 16 != 0) return ERR_BAD_ARGS;
    if (!aligned16(a.boxes) || !aligned16(a.mask)) return ERR_BAD_ARGS;
    if (a.det_gid && (!aligned16(a.det_gid) || !aligned16(a.det_sim) ||
                      !aligned16(a.det_has_emb)))
      return ERR_BAD_ARGS;
  }
  bool shared = a.chunk_frames > 0;
  for (int i = 0; i < N_ARRAYS; ++i) shared = shared && a.where[i] == IN_SHARED;
  void (*kernel)(FireScanArgs) = shared ? track_scan_kernel<true> : track_scan_kernel<false>;
  // the opt-in above 48 KB is per function and device: raise it once per size
  static int attr_bytes[2][64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return ERR_BAD_ARGS;
  if (smem_bytes > 48 * 1024 && smem_bytes > attr_bytes[shared][dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return e;
    attr_bytes[shared][dev] = smem_bytes;
  }
  kernel<<<1, threads, smem_bytes, reinterpret_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
