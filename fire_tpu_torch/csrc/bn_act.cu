// K3: inference BatchNorm with its ReLU and residual add, one bf16 pass,
// for Hopper (sm_90a).
//
// Replaces, for a network served in bf16 on the card, what an eval-mode
// BatchNorm (fire_tpu_torch/models/layers.py) and the ops after it ran as
// four to six kernels: a cast of the convolution's bf16 output to
// float32, cuDNN's float32 BatchNorm, a cast back to bf16, the residual
// add and the ReLU, some 22-26 bytes an element.  K3 reads x (and the
// residual) once and writes y once: 4 bytes an element, 6 with a
// residual.  The convolution before it is left as it is.
//
// What it computes, per element x of channel c, in float32 and in the
// order of flax.linen.BatchNorm (and of the module's train path):
//   y = (x - mean[c]) * (rsqrt(var[c] + eps) * scale[c]) + bias[c]
// rounded to bf16 once; with a residual r, bf16(float(y) + float(r)),
// what PyTorch's bf16 + bf16 computes; with relu, max(y, 0) with NaN
// kept, what torch.relu computes.  Every product and sum is a rounding
// of its own (the build turns FMA contraction off) and rsqrt is rsqrtf,
// as in torch.rsqrt, so that K3 equals that formula written as separate
// PyTorch ops on the card bitwise (ops/bn_act.py plain_bn_act).  The
// four per-channel float32 tensors are read on every launch, so a CUDA
// graph that holds the launch follows weights loaded into them in place.
//
// Layout: channels innermost, the memory of a channels-last NCHW tensor
// or of a (rows, C) matrix, so that element i is in channel i % C.  A
// row is the C channels of one pixel (or one matrix row); the launch
// cuts a row into `groups` vectors of V elements (V = 8, a 16-byte load,
// when C % 8 == 0 and the operands are 16-byte aligned; else V = 1).  A
// block holds `rpb` rows of `tpr` threads, a thread one vector of a row:
// it forms the V channels' mean, multiplier and bias once, in registers,
// then walks the rows with a grid stride, so that one launch serves
// B = 1 and the batched engine's B = 64 alike.  Consecutive threads read
// consecutive vectors of one row, and the block's rows are consecutive:
// the loads coalesce.  Rows wider than one block (groups > tpr) are
// walked a group at a time.
//
// Bound on an H100 SXM: bytes only (a few operations an element), 4 or
// 6 bytes an element at 3.35 TB/s: 60 M elements, RetinaFace's
// BatchNorms at 512^2, in about 0.09 ms.
//
// The PReLU route (bn_prelu_kernel, ArcFace IResNet's BatchNorm before
// its PReLU) ends the same formula, with no residual (no network adds
// one before a PReLU), in a PReLU with one float32 slope a channel:
//   y <= 0 ? bf16(y * slope[c]) : y
// which is y > 0 ? y : slope * y with a NaN kept as it is, the plain
// version's torch.where of the same product, rounded once.  A thread
// reads its V channels' slopes once, with the other parameters; the
// route reads and writes the same bytes as the ReLU route.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ERR_BAD_ARGS = 20001;
constexpr int MAX_THREADS = 256;

struct BnActArgs {
  const uint16_t* x;   // bf16 bits
  const uint16_t* r;   // the residual's bf16 bits, or null
  uint16_t* y;
  const float* mean;
  const float* var;
  const float* scale;
  const float* bias;
  float eps;
  long long rows;
  int groups;          // vectors a row: C / V
  int tpr;             // threads a row
  int rpb;             // rows a block
};

template <int V> struct Vec;
template <> struct Vec<8> { using T = uint4; };
template <> struct Vec<1> { using T = uint16_t; };

__device__ __forceinline__ float bf16_to_float(uint16_t bits) {
  return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}

__device__ __forceinline__ uint16_t float_to_bf16(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <int V, bool RES, bool RELU>
__global__ void __launch_bounds__(MAX_THREADS) bn_act_kernel(BnActArgs a) {
  using T = typename Vec<V>::T;
  union Pack { T raw; uint16_t h[V]; };
  const T* __restrict__ xv = reinterpret_cast<const T*>(a.x);
  const T* __restrict__ rv = reinterpret_cast<const T*>(a.r);
  T* __restrict__ yv = reinterpret_cast<T*>(a.y);
  const int lane = threadIdx.x % a.tpr;
  const long long row0 = static_cast<long long>(blockIdx.x) * a.rpb + threadIdx.x / a.tpr;
  const long long row_step = static_cast<long long>(gridDim.x) * a.rpb;
  for (int g = lane; g < a.groups; g += a.tpr) {
    float mean[V], mul[V], bias[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int c = g * V + v;
      mean[v] = __ldg(a.mean + c);
      mul[v] = rsqrtf(__ldg(a.var + c) + a.eps) * __ldg(a.scale + c);
      bias[v] = __ldg(a.bias + c);
    }
    for (long long row = row0; row < a.rows; row += row_step) {
      const long long i = row * a.groups + g;
      Pack in, res, out;
      in.raw = xv[i];
      if (RES) res.raw = rv[i];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        uint16_t h = float_to_bf16((bf16_to_float(in.h[v]) - mean[v]) * mul[v] + bias[v]);
        if (RES) h = float_to_bf16(bf16_to_float(h) + bf16_to_float(res.h[v]));
        if (RELU) {
          const float f = bf16_to_float(h);
          h = isnan(f) ? h : float_to_bf16(fmaxf(f, 0.0f));
        }
        out.h[v] = h;
      }
      yv[i] = out.raw;
    }
  }
}

template <int V>
__global__ void __launch_bounds__(MAX_THREADS) bn_prelu_kernel(BnActArgs a,
                                                               const float* __restrict__ slope) {
  using T = typename Vec<V>::T;
  union Pack { T raw; uint16_t h[V]; };
  const T* __restrict__ xv = reinterpret_cast<const T*>(a.x);
  T* __restrict__ yv = reinterpret_cast<T*>(a.y);
  const int lane = threadIdx.x % a.tpr;
  const long long row0 = static_cast<long long>(blockIdx.x) * a.rpb + threadIdx.x / a.tpr;
  const long long row_step = static_cast<long long>(gridDim.x) * a.rpb;
  for (int g = lane; g < a.groups; g += a.tpr) {
    float mean[V], mul[V], bias[V], neg[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int c = g * V + v;
      mean[v] = __ldg(a.mean + c);
      mul[v] = rsqrtf(__ldg(a.var + c) + a.eps) * __ldg(a.scale + c);
      bias[v] = __ldg(a.bias + c);
      neg[v] = __ldg(slope + c);
    }
    for (long long row = row0; row < a.rows; row += row_step) {
      const long long i = row * a.groups + g;
      Pack in, out;
      in.raw = xv[i];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const uint16_t h = float_to_bf16((bf16_to_float(in.h[v]) - mean[v]) * mul[v] + bias[v]);
        const float f = bf16_to_float(h);
        out.h[v] = f <= 0.0f ? float_to_bf16(f * neg[v]) : h;
      }
      yv[i] = out.raw;
    }
  }
}

template <int V>
void* pick(bool res, bool relu) {
  if (res) {
    return relu ? reinterpret_cast<void*>(bn_act_kernel<V, true, true>)
                : reinterpret_cast<void*>(bn_act_kernel<V, true, false>);
  }
  return relu ? reinterpret_cast<void*>(bn_act_kernel<V, false, true>)
              : reinterpret_cast<void*>(bn_act_kernel<V, false, false>);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The launch's arguments, checked: x, the residual (or null) and y are
// bf16 (rows, C) with channels innermost; mean, var, scale and bias float32
// (C).  `vector` is 8 or 1; the plan (threads = tpr * rpb, blocks) is the
// wrapper's (ops/bn_act.py launch_plan).  Returns 0 or ERR_BAD_ARGS.
int make_args(BnActArgs* a, const void* x, const void* r, void* y, const float* mean,
              const float* var, const float* scale, const float* bias, float eps,
              long long rows, int channels, int vector, int tpr, int rpb, int blocks) {
  if (!x || !y || !mean || !var || !scale || !bias) return ERR_BAD_ARGS;
  if (rows < 1 || channels < 1 || blocks < 1 || tpr < 1 || rpb < 1) return ERR_BAD_ARGS;
  if (tpr * rpb > MAX_THREADS) return ERR_BAD_ARGS;
  if (vector == 8) {
    if (channels % 8 != 0 || !aligned16(x) || !aligned16(y) || (r && !aligned16(r)))
      return ERR_BAD_ARGS;
  } else if (vector != 1) {
    return ERR_BAD_ARGS;
  }
  *a = BnActArgs{static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(r),
                 static_cast<uint16_t*>(y), mean, var, scale, bias, eps, rows,
                 channels / vector, tpr, rpb};
  return tpr > a->groups ? ERR_BAD_ARGS : 0;
}

cudaError_t launch(void* kernel, int blocks, int threads, void** params, void* stream) {
  cudaError_t e = cudaLaunchKernel(kernel, dim3(blocks), dim3(threads), params, 0,
                                   reinterpret_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// One launch on `stream` (make_args says what it takes).  Returns 0, a
// cudaError_t, or ERR_BAD_ARGS for arguments the kernel cannot take.
extern "C" int fire_bn_act(const void* x, const void* r, void* y, const float* mean,
                           const float* var, const float* scale, const float* bias, float eps,
                           long long rows, int channels, int vector, int relu, int tpr, int rpb,
                           int blocks, void* stream) {
  BnActArgs a;
  if (int bad = make_args(&a, x, r, y, mean, var, scale, bias, eps, rows, channels, vector, tpr,
                          rpb, blocks))
    return bad;
  void* kernel = vector == 8 ? pick<8>(r != nullptr, relu != 0) : pick<1>(r != nullptr, relu != 0);
  void* params[] = {&a};
  return launch(kernel, blocks, tpr * rpb, params, stream);
}

// The PReLU route: as fire_bn_act with no residual, and `slope`
// (float32, C) in place of the ReLU.
extern "C" int fire_bn_prelu(const void* x, void* y, const float* mean, const float* var,
                             const float* scale, const float* bias, const float* slope, float eps,
                             long long rows, int channels, int vector, int tpr, int rpb,
                             int blocks, void* stream) {
  BnActArgs a;
  if (!slope) return ERR_BAD_ARGS;
  if (int bad = make_args(&a, x, nullptr, y, mean, var, scale, bias, eps, rows, channels, vector,
                          tpr, rpb, blocks))
    return bad;
  void* kernel = vector == 8 ? reinterpret_cast<void*>(bn_prelu_kernel<8>)
                             : reinterpret_cast<void*>(bn_prelu_kernel<1>);
  void* params[] = {&a, &slope};
  return launch(kernel, blocks, tpr * rpb, params, stream);
}
