// Hand-written Hopper (sm_90a) kernels for train-mode batch norm (SyncBN).
// Python side: torchseg_tpu_torch/ops/kernels/bn_kernels.py (wrappers, shape
// checks, plain PyTorch versions); the autograd Function that runs them is
// torchseg_tpu_torch/ops/norm.py.
//
//   channel_sums_kernel + channel_sums_finish_kernel  (K8)  replace the TPU
//       kernel torchseg_tpu/ops/pallas/bn_kernel.py:41 channel_sum_sumsq
//   scale_bias_act_kernel                             (K9)  replaces
//       torchseg_tpu/ops/pallas/bn_kernel.py:68 fused_scale_bias_act
//
// Both take NCHW tensors, float32 or bfloat16, contiguous: channel c of
// image n is the contiguous run x[(n * C + c) * HW, +HW).
//
// K8: per-channel (sum x, sum x^2) over N*H*W -> (2, C) float32.  The TPU
// kernel carries one running sum across its sequential grid; blocks here run
// in no order, so the reduction is two launches.  Pass 1: block (p, c, n)
// reduces piece p of run (n, c) into a float64 partial; pass 2: one thread
// per channel adds the N*P partials in a fixed order and rounds to float32
// once.  No atomics, so the result is the same on every run.  Each thread
// accumulates in float64 (an f32 square is exact in float64), so the sums
// are within one float32 rounding of the exact ones whatever the order.
// What bounds it: bytes (each input byte read once; the float64 work is
// ~2 flops per element against the memory stream).  Design: 16-byte loads
// when HW is a multiple of the vector width, pieces of ~8K elements so the
// largest BiSeNet input ((2, 64, 512, 512), 134 MB) spreads over 4096
// blocks.
//
// K9: y = x * a[c] + b[c] per channel, optional ReLU, in x's dtype.  The
// wrapper hands a and b already rounded to x's dtype (the TPU kernel casts
// them, bn_kernel.py:62) and widened to float32; the kernel computes one
// float32 fused multiply-add (__fmaf_rn; the library is built with
// -fmad=false, so nothing else is contracted), the ReLU, and one rounding
// to x's dtype.  What bounds it: bytes (read x once, write y once).
// Design: grid.y walks the N*C runs, so a and b are two scalars per block;
// 16-byte loads and stores when HW is a multiple of the vector width.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
struct Vec;  // 16 bytes of T

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const float* p, float* v) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* v) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float* v) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  }
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_float(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

// Block-wide sum of two float64 values in a fixed order (warp shuffles,
// then warp 0 over the per-warp sums); thread 0 gets the totals.
__device__ __forceinline__ void block_sum2(double* s, double* ss) {
  __shared__ double red[2][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    *s = __dadd_rn(*s, __shfl_down_sync(0xffffffffu, *s, off));
    *ss = __dadd_rn(*ss, __shfl_down_sync(0xffffffffu, *ss, off));
  }
  if (lane == 0) {
    red[0][warp] = *s;
    red[1][warp] = *ss;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double a = 0.0, b = 0.0;
    for (int w = 0; w < kWarps; ++w) {
      a = __dadd_rn(a, red[0][w]);
      b = __dadd_rn(b, red[1][w]);
    }
    *s = a;
    *ss = b;
  }
}

// Pass 1 of K8.  grid (P, C, N): piece p of run (n, c) covers elements
// [p * piece, min((p + 1) * piece, hw)), piece a multiple of the vector
// width.  partial[((n * P + p) * 2 + k) * C + c], k = 0 sum, 1 sum of
// squares.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
channel_sums_kernel(const T* __restrict__ x, int c_dim, long long hw,
                    long long piece, double* __restrict__ partial) {
  const int p = blockIdx.x, c = blockIdx.y, n = blockIdx.z;
  const T* run = x + (static_cast<long long>(n) * c_dim + c) * hw;
  const long long lo = p * piece;
  const long long hi = min(lo + piece, hw);
  double s = 0.0, ss = 0.0;
  if constexpr (kVec) {
    constexpr int kN = Vec<T>::kN;
    for (long long i = lo + static_cast<long long>(threadIdx.x) * kN; i < hi;
         i += static_cast<long long>(kThreads) * kN) {
      float v[kN];
      Vec<T>::load(run + i, v);
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const double d = static_cast<double>(v[j]);
        s = __dadd_rn(s, d);
        ss = __fma_rn(d, d, ss);
      }
    }
  } else {
    for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
      const double d = static_cast<double>(to_float(run[i]));
      s = __dadd_rn(s, d);
      ss = __fma_rn(d, d, ss);
    }
  }
  block_sum2(&s, &ss);
  if (threadIdx.x == 0) {
    const long long row = static_cast<long long>(n) * gridDim.x + p;
    partial[(row * 2) * c_dim + c] = s;
    partial[(row * 2 + 1) * c_dim + c] = ss;
  }
}

// Pass 2 of K8: out[k * C + c] = float32(sum over the n_rows partials, in
// order).
__global__ void __launch_bounds__(kThreads)
channel_sums_finish_kernel(const double* __restrict__ partial, int n_rows,
                           int c_dim, float* __restrict__ out) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= c_dim) return;
  double s = 0.0, ss = 0.0;
  for (int r = 0; r < n_rows; ++r) {
    s = __dadd_rn(s, partial[(static_cast<long long>(r) * 2) * c_dim + c]);
    ss = __dadd_rn(ss,
                   partial[(static_cast<long long>(r) * 2 + 1) * c_dim + c]);
  }
  out[c] = __double2float_rn(s);
  out[c_dim + c] = __double2float_rn(ss);
}

// K9.  grid (X, min(N*C, 65535)): block (bx, r) handles run r = n * C + c
// (and r + gridDim.y, ...) from element bx * kThreads * vec on, striding by
// the grid's width.
template <typename T, bool kVec, bool kRelu>
__global__ void __launch_bounds__(kThreads)
scale_bias_act_kernel(const T* __restrict__ x, const float* __restrict__ a,
                      const float* __restrict__ b, int c_dim, int n_runs,
                      long long hw, T* __restrict__ y) {
  constexpr int kN = kVec ? Vec<T>::kN : 1;
  for (int r = blockIdx.y; r < n_runs; r += gridDim.y) {
    const float ar = __ldg(a + r % c_dim), br = __ldg(b + r % c_dim);
    const long long base = static_cast<long long>(r) * hw;
    for (long long i = (static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x) * kN;
         i < hw; i += static_cast<long long>(gridDim.x) * kThreads * kN) {
      float v[kN];
      if constexpr (kVec) {
        Vec<T>::load(x + base + i, v);
      } else {
        v[0] = to_float(x[base + i]);
      }
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const float t = __fmaf_rn(v[j], ar, br);
        v[j] = kRelu ? (t > 0.f ? t : 0.f) : t;
      }
      if constexpr (kVec) {
        Vec<T>::store(y + base + i, v);
      } else {
        from_float(v[0], y + base + i);
      }
    }
  }
}

constexpr long long kPiece = 8192;  // K8 elements per block, at most
constexpr long long kK9PerThread = 4;  // K9 vectors per thread, about

template <typename T, bool kVec>
int launch_sums(const void* x, int n, int c, long long hw, void* partial,
                int pieces, float* out, cudaStream_t st) {
  const long long per = (hw + pieces - 1) / pieces;
  const long long piece = (per + Vec<T>::kN - 1) / Vec<T>::kN * Vec<T>::kN;
  channel_sums_kernel<T, kVec><<<dim3(pieces, c, n), kThreads, 0, st>>>(
      static_cast<const T*>(x), c, hw, piece, static_cast<double*>(partial));
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  channel_sums_finish_kernel<<<(c + kThreads - 1) / kThreads, kThreads, 0,
                               st>>>(static_cast<const double*>(partial),
                                     n * pieces, c, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kVec, bool kRelu>
int launch_affine(const void* x, const float* a, const float* b, int n, int c,
                  long long hw, void* y, cudaStream_t st) {
  constexpr int kN = kVec ? Vec<T>::kN : 1;
  const long long vecs = (hw + kN - 1) / kN;
  long long gx = (vecs + kThreads * kK9PerThread - 1) /
                 (kThreads * kK9PerThread);
  gx = gx < 1 ? 1 : (gx > 65535 ? 65535 : gx);
  const int runs = n * c;
  const int gy = runs < 65535 ? runs : 65535;
  scale_bias_act_kernel<T, kVec, kRelu>
      <<<dim3(static_cast<unsigned>(gx), gy), kThreads, 0, st>>>(
          static_cast<const T*>(x), a, b, c, runs, hw, static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Pieces per (n, c) run that K8's pass 1 uses for a run of hw elements; the
// wrapper sizes the float64 partial tensor (n * pieces, 2, c) from it.
int tsg_channel_sums_pieces(long long hw) {
  const long long p = (hw + kPiece - 1) / kPiece;
  return static_cast<int>(p < 1 ? 1 : (p > 65535 ? 65535 : p));
}

// x (n, c, hw) float32 (bf16 = 0) or bfloat16 (bf16 = 1) -> out (2, c)
// float32 (sum, sum of squares); partial: float64 scratch of
// (n * tsg_channel_sums_pieces(hw), 2, c); vec: hw is a multiple of the
// 16-byte vector width and x is 16-byte aligned.  Two launches on the
// caller's stream; returns cudaGetLastError().
int tsg_channel_sums(const void* x, int n, int c, long long hw, int bf16,
                     int vec, void* partial, void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int pieces = tsg_channel_sums_pieces(hw);
  float* o = static_cast<float*>(out);
  if (bf16) {
    return vec ? launch_sums<__nv_bfloat16, true>(x, n, c, hw, partial,
                                                  pieces, o, st)
               : launch_sums<__nv_bfloat16, false>(x, n, c, hw, partial,
                                                   pieces, o, st);
  }
  return vec ? launch_sums<float, true>(x, n, c, hw, partial, pieces, o, st)
             : launch_sums<float, false>(x, n, c, hw, partial, pieces, o, st);
}

// y = relu?(x * a[c] + b[c]) for x, y (n, c, hw) float32 or bfloat16; a, b
// (c,) float32, already rounded to x's dtype.  One launch on the caller's
// stream; returns cudaGetLastError().
int tsg_scale_bias_act(const void* x, const void* a, const void* b, int n,
                       int c, long long hw, int bf16, int vec, int relu,
                       void* y, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
#define TSG_AFFINE(T, V, R) \
  return launch_affine<T, V, R>(x, af, bf, n, c, hw, y, st)
  if (bf16) {
    if (vec) {
      if (relu) TSG_AFFINE(__nv_bfloat16, true, true);
      TSG_AFFINE(__nv_bfloat16, true, false);
    }
    if (relu) TSG_AFFINE(__nv_bfloat16, false, true);
    TSG_AFFINE(__nv_bfloat16, false, false);
  }
  if (vec) {
    if (relu) TSG_AFFINE(float, true, true);
    TSG_AFFINE(float, true, false);
  }
  if (relu) TSG_AFFINE(float, false, true);
  TSG_AFFINE(float, false, false);
#undef TSG_AFFINE
}

}  // extern "C"
