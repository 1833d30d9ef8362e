// Hand-written Hopper (sm_90a) kernels for train-mode batch norm (SyncBN).
// Python side: torchseg_tpu_torch/ops/kernels/bn_kernels.py (wrappers, shape
// checks, plain PyTorch versions); the autograd Function that runs them is
// torchseg_tpu_torch/ops/norm.py.
//
//   channel_sums_kernel, channel_sums_tiny_kernel  (K8)  replace the TPU
//       kernel torchseg_tpu/ops/pallas/bn_kernel.py:41 channel_sum_sumsq
//   scale_bias_act_kernel, scale_bias_act_flat_kernel  (K9)  replace
//       torchseg_tpu/ops/pallas/bn_kernel.py:68 fused_scale_bias_act
//
// Both take NCHW tensors, float32 or bfloat16, contiguous: channel c of
// image n is the contiguous run x[(n * C + c) * HW, +HW).  Runs may start
// anywhere (odd HW, a view 4 bytes past a boundary): each run is read as a
// head of single elements up to the first 16-byte boundary, 16-byte
// vectors, and a tail.
//
// K8: per-channel (sum x, sum x^2) over N*H*W, one launch.  The TPU kernel
// carries one running sum across its sequential grid; here channel c is
// reduced by one thread (N*HW <= kTinyRun or HW = 1), by one block, or by
// a thread block cluster of k <= 8 blocks, each reducing a slice of every
// run; the cluster's first block adds the k partials through distributed
// shared memory in rank order.  Each thread accumulates in float64 (an f32
// square is exact in float64) in an order fixed by the shape, so the sums
// are the same on every run and within one float32 rounding of the exact
// ones.  No atomics, no scratch in device memory.  The finishing thread of
// each channel either writes the float32 sums, or (given the BN
// parameters) folds them, in float32 in the JAX module's term order
// (torchseg_tpu/ops/norm.py:76-104), with IEEE divide and square root:
//   mean = s/n, d = ss/n - mean*mean, var = max(d, 0),
//   inv = 1/sqrt(var + eps), a = inv*gamma, b = beta - mean*a,
//   running_mean = (1-m)*running_mean + m*mean,
//   running_var  = (1-m)*running_var  + m*(var * n/max(n-1, 1)),
// writes (mean, inv, a, b, d) as a (5, C) tensor, updates the running stats
// in place and adds one to num_batches_tracked.  What bounds it: bytes
// (each input byte read once; the float64 work is 3 operations per element
// against 4 or 2 bytes).  Design: most BN inputs are a few MB (PERF.md), so
// a kernel's time is its load latencies as much as its bytes: a thread
// issues kGroupElems elements of 16-byte loads, across the N runs, before
// it adds any (a warp stalls at the first use of a load); the fast path
// (whole 16-byte vectors) indexes in 32 bits to stay light in registers; a
// channel is split over a cluster only while the grid still fits on the
// card at once (kSlots) and each block keeps kMinSlice elements.
//
// K9: y = x * a[c] + b[c] per channel, optional ReLU, in x's dtype.  a and b
// are float32; the kernel rounds them to x's dtype (the TPU kernel casts
// them, bn_kernel.py:62) and computes one float32 fused multiply-add
// (__fmaf_rn; the library is built with -fmad=false, so nothing else is
// contracted), the ReLU, and one rounding to x's dtype.  What bounds it:
// bytes (read x once, write y once).  Design: runs of HW >= kFlatHw get a
// grid whose y walks the N*C runs (a and b two scalars per block); shorter
// runs (HW = 1 included) a flat grid-stride over N*C*HW with the channel
// from a multiply-shift divide.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // K9's blocks
// K8 (scripts/torch_bn_k8_variants.py times other values of these)
constexpr int kSumThreads = 256;   // a block's threads
constexpr int kSumWarps = kSumThreads / 32;
constexpr int kTinyRun = 32;       // thread per channel up to N*HW = this
constexpr int kMaxCluster = 8;     // portable cluster size
constexpr int kGroupElems = 16;    // elements a thread loads before it adds
constexpr int kMinBlocks = 4;      // blocks resident on an SM (launch bounds)
constexpr long long kSlots = kMinBlocks * 132;  // on the H100's 132 SMs
constexpr long long kMinSlice = 16384;  // least elements a cluster block reads
// K9
constexpr long long kFlatHw = 4096;  // flat grid below this HW

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
// v rounded to T and back (the TPU kernel's a.astype(x.dtype))
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Elements of T before the first 16-byte boundary at or after p.
template <typename T>
__device__ __forceinline__ long long head_of(const T* p) {
  return static_cast<long long>(
      ((16u - (reinterpret_cast<uintptr_t>(p) & 15u)) & 15u) / sizeof(T));
}

__device__ __forceinline__ void acc(float v, double* s, double* ss) {
  const double d = static_cast<double>(v);
  *s = __dadd_rn(*s, d);
  *ss = __fma_rn(d, d, *ss);
}

// Vectors a thread loads before it adds any (kGroupElems elements).
template <typename T>
struct Group {
  static constexpr int kU =
      kGroupElems / Vec<T>::kN > 0 ? kGroupElems / Vec<T>::kN : 1;
};

// This thread's share (thread t of nt) of the sums of the slices
// [lo, lo + len) of the n_img runs of channel c.  The runs' 16-byte vector
// parts are walked as one sequence, kU vectors a thread at a time, all
// loaded before any is added, so a short run costs no load latency of its
// own (a warp stalls at the first use of a load, not at the load).  Each
// run's scalar head and tail elements (fewer than 2 * kN) are loaded
// first and added last.  The order of the adds is fixed by (t, nt) and the
// shape, so the sums are the same on every run.
template <typename T>
__device__ __forceinline__ void slice_sums(const T* __restrict__ x, int n_img,
                                           int c_dim, int c, long long hw,
                                           long long lo, long long len, int t,
                                           int nt, double* s, double* ss) {
  constexpr int kN = Vec<T>::kN, kU = Group<T>::kU;
  const long long stride = static_cast<long long>(c_dim) * hw;
  const T* first = x + static_cast<long long>(c) * hw + lo;
  // the scalar edges: slot q = (run, k), k < kN the head, else the tail
  const int n_slots = n_img * 2 * kN;
  float edge = 0.f;
  bool has_edge = false;
  for (int q = t; q < n_slots; q += nt) {
    const int n = q / (2 * kN), k = q % (2 * kN);
    const T* p = first + n * stride;
    long long h = head_of(p);
    h = h < len ? h : len;
    const long long idx = k < kN ? k : h + (len - h) / kN * kN + (k - kN);
    if ((k < kN && idx < h) || (k >= kN && idx < len)) {
      const float v = to_float(p[idx]);
      if (q + nt < n_slots) {
        acc(v, s, ss);  // more edges than threads: no prefetch
      } else {
        edge = v;
        has_edge = true;
      }
    }
  }
  // the vector parts of all runs as one sequence
  long long total = 0;
  for (int n = 0; n < n_img; ++n) {
    const long long h = head_of(first + n * stride);
    total += (len - (h < len ? h : len)) / kN;
  }
  int n = 0;
  long long off = 0;  // vectors of the runs before run n
  const T* run = first;
  long long h = head_of(run);
  h = h < len ? h : len;
  long long nv = (len - h) / kN;
  for (long long v = t; v < total; v += static_cast<long long>(kU) * nt) {
    float val[kU][kN];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const long long vv = v + static_cast<long long>(u) * nt;
      if (vv < total) {
        while (vv >= off + nv) {  // the next run (vv only grows)
          off += nv;
          ++n;
          run = first + n * stride;
          h = head_of(run);
          h = h < len ? h : len;
          nv = (len - h) / kN;
        }
        Vec<T>::load(run + h + (vv - off) * kN, val[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (v + static_cast<long long>(u) * nt < total) {
#pragma unroll
        for (int j = 0; j < kN; ++j) acc(val[u][j], s, ss);
      }
    }
  }
  if (has_edge) acc(edge, s, ss);
}

// n / d for n < 2^31 by a multiply and a shift (d >= 1).
struct Divider {
  unsigned d, magic, shift;
  __device__ __forceinline__ unsigned div(unsigned n) const {
    return (__umulhi(n, magic) + n) >> shift;
  }
};

Divider make_divider(unsigned d) {
  unsigned shift = 0;
  while (shift < 32 && (1ull << shift) < d) ++shift;
  const unsigned long long magic =
      ((1ull << 32) * ((1ull << shift) - d)) / d + 1;
  return Divider{d, static_cast<unsigned>(magic), shift};
}

// slice_sums where every run starts on a 16-byte boundary and hw is a
// multiple of kN, so each slice is whole vectors: thread t's vectors i = t,
// t + kSumThreads, ... of every run's slice, walked as (i, n) pairs with n
// fastest (one group holds the loads of all N runs), in 32-bit indices.
template <typename T>
__device__ __forceinline__ void aligned_sums(const T* __restrict__ x,
                                             Divider n_div, int c_dim, int c,
                                             long long hw, long long lo,
                                             long long len, int t, double* s,
                                             double* ss) {
  constexpr int kN = Vec<T>::kN, kU = Group<T>::kU;
  const long long stride = static_cast<long long>(c_dim) * hw;
  const T* first = x + static_cast<long long>(c) * hw + lo;
  const int m = static_cast<int>(len / kN);
  const int jt = m > t ? (m - t + kSumThreads - 1) / kSumThreads : 0;
  const int total = jt * static_cast<int>(n_div.d);
  for (int q0 = 0; q0 < total; q0 += kU) {
    float val[kU][kN];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int q = q0 + u;
      if (q < total) {
        const int j = static_cast<int>(n_div.div(q));
        const int n = q - j * static_cast<int>(n_div.d);
        Vec<T>::load(first + n * stride +
                         static_cast<long long>(t + j * kSumThreads) * kN,
                     val[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (q0 + u < total) {
#pragma unroll
        for (int j = 0; j < kN; ++j) acc(val[u][j], s, ss);
      }
    }
  }
}

// Block-wide sum of two float64 values in a fixed order (warp shuffles,
// then thread 0 over the per-warp sums); thread 0 gets the totals.
__device__ __forceinline__ void block_sum2(double* s, double* ss) {
  __shared__ double red[2][kSumWarps];
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
    for (int w = 0; w < kSumWarps; ++w) {
      a = __dadd_rn(a, red[0][w]);
      b = __dadd_rn(b, red[1][w]);
    }
    *s = a;
    *ss = b;
  }
}

// The BN parameters K8 folds its sums with; weight == nullptr: sums only.
struct Fold {
  const float* weight;
  const float* bias;
  float* running_mean;
  float* running_var;
  long long* num_batches_tracked;  // may be nullptr
  float n, eps, m, keep, unbias;   // keep = 1 - m
};

// Channel c's (weight, bias, running_mean, running_var), loaded by its
// finishing thread before the sums so that their latency hides behind them.
__device__ __forceinline__ float4 fold_operands(int c, const Fold& f) {
  if (f.weight == nullptr) return make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(f.weight[c], f.bias[c], f.running_mean[c],
                     f.running_var[c]);
}

// Channel c's finishing thread: out (2, C) sums, or out (5, C) (mean, inv,
// a, b, d) and the running stats (see the header for the formulas); op:
// fold_operands(c, f).
__device__ __forceinline__ void finish(int c, int c_dim, double s_acc,
                                       double ss_acc, float* __restrict__ out,
                                       const Fold& f, float4 op) {
  const float s = __double2float_rn(s_acc), ss = __double2float_rn(ss_acc);
  if (f.weight == nullptr) {
    out[c] = s;
    out[c_dim + c] = ss;
    return;
  }
  const float mean = __fdiv_rn(s, f.n);
  const float mean_sq = __fdiv_rn(ss, f.n);
  const float d = __fsub_rn(mean_sq, __fmul_rn(mean, mean));
  const float var = d < 0.f ? 0.f : d;
  const float inv = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, f.eps)));
  const float a = __fmul_rn(inv, op.x);
  const float b = __fsub_rn(op.y, __fmul_rn(mean, a));
  out[c] = mean;
  out[c_dim + c] = inv;
  out[2 * c_dim + c] = a;
  out[3 * c_dim + c] = b;
  out[4 * c_dim + c] = d;
  f.running_mean[c] = __fadd_rn(__fmul_rn(f.keep, op.z),
                                __fmul_rn(f.m, mean));
  f.running_var[c] = __fadd_rn(__fmul_rn(f.keep, op.w),
                               __fmul_rn(f.m, __fmul_rn(var, f.unbias)));
  if (c == 0 && f.num_batches_tracked != nullptr) *f.num_batches_tracked += 1;
}

// K8 for N*HW <= kTinyRun or HW = 1: one thread per channel (HW = 1:
// neighbouring threads read neighbouring channels).
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
channel_sums_tiny_kernel(const T* __restrict__ x, int n_img, int c_dim,
                         long long hw, float* __restrict__ out, Fold f) {
  const int c = blockIdx.x * kSumThreads + threadIdx.x;
  if (c >= c_dim) return;
  const float4 op = fold_operands(c, f);
  // element e = (n, i) of the channel, kTinyRun of them loaded at a time
  const long long count = static_cast<long long>(n_img) * hw;
  double s = 0.0, ss = 0.0;
  for (long long e0 = 0; e0 < count; e0 += kTinyRun) {
    float v[kTinyRun];
#pragma unroll
    for (int j = 0; j < kTinyRun; ++j) {
      const long long e = e0 + j;
      if (e < count)
        v[j] = to_float(x[((e / hw) * c_dim + c) * hw + e % hw]);
    }
#pragma unroll
    for (int j = 0; j < kTinyRun; ++j)
      if (e0 + j < count) acc(v[j], &s, &ss);
  }
  finish(c, c_dim, s, ss, out, f, op);
}

// K8: block (c * k + r) reduces elements [r * piece, (r + 1) * piece) of
// every run of channel c; k = the cluster size (1 without kCluster);
// kAligned: the runs are whole 16-byte vectors (aligned_sums), n_div
// divides by N.
template <typename T, bool kCluster, bool kAligned>
__global__ void __launch_bounds__(kSumThreads, kMinBlocks)
channel_sums_kernel(const T* __restrict__ x, int n_img, int c_dim,
                    long long hw, long long piece, Divider n_div,
                    float* __restrict__ out, Fold f) {
  int c = blockIdx.x, r = 0;
  if constexpr (kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    c = blockIdx.x / cluster.dim_blocks().x;
    r = static_cast<int>(cluster.block_rank());
  }
  const float4 op = r == 0 && threadIdx.x == 0 ? fold_operands(c, f)
                                              : make_float4(0.f, 0.f, 0.f, 0.f);
  const long long lo = r * piece;
  const long long hi = lo + piece < hw ? lo + piece : hw;
  double s = 0.0, ss = 0.0;
  if (lo < hi) {
    if constexpr (kAligned) {
      aligned_sums(x, n_div, c_dim, c, hw, lo, hi - lo, threadIdx.x, &s,
                   &ss);
    } else {
      slice_sums(x, n_img, c_dim, c, hw, lo, hi - lo, threadIdx.x,
                 kSumThreads, &s, &ss);
    }
  }
  block_sum2(&s, &ss);
  if constexpr (kCluster) {
    __shared__ double part[2];
    cg::cluster_group cluster = cg::this_cluster();
    if (threadIdx.x == 0) {
      part[0] = s;
      part[1] = ss;
    }
    cluster.sync();
    if (r == 0 && threadIdx.x < 32) {
      // lane q reads block q's partials; lane 0 adds them in rank order
      const int k = static_cast<int>(cluster.dim_blocks().x);
      double ps = 0.0, pss = 0.0;
      if (static_cast<int>(threadIdx.x) < k) {
        const double* p = cluster.map_shared_rank(&part[0], threadIdx.x);
        ps = p[0];
        pss = p[1];
      }
      s = 0.0;
      ss = 0.0;
      for (int q = 0; q < k; ++q) {
        s = __dadd_rn(s, __shfl_sync(0xffffffffu, ps, q));
        ss = __dadd_rn(ss, __shfl_sync(0xffffffffu, pss, q));
      }
    }
    cluster.sync();  // keep every block's part alive until it is read
    if (r != 0) return;
  }
  if (threadIdx.x == 0) finish(c, c_dim, s, ss, out, f, op);
}

__device__ __forceinline__ float affine(float v, float a, float b,
                                        bool relu) {
  const float t = __fmaf_rn(v, a, b);
  return relu ? (t > 0.f ? t : 0.f) : t;
}

// K9, HW >= kFlatHw.  grid (X, min(N*C, 65535)): block (bx, r) handles run
// r = n * C + c (and r + gridDim.y, ...), its elements strided by the
// grid's width; kVec: x and y share their offset from a 16-byte boundary,
// so each run is a scalar head, 16-byte vectors and a scalar tail.
template <typename T, bool kVec, bool kRelu>
__global__ void __launch_bounds__(kThreads)
scale_bias_act_kernel(const T* __restrict__ x, const float* __restrict__ a,
                      const float* __restrict__ b, int c_dim, int n_runs,
                      long long hw, T* __restrict__ y) {
  constexpr int kN = Vec<T>::kN;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const long long nt = static_cast<long long>(gridDim.x) * kThreads;
  for (int r = blockIdx.y; r < n_runs; r += gridDim.y) {
    const float ar = round_to(__ldg(a + r % c_dim), x);
    const float br = round_to(__ldg(b + r % c_dim), x);
    const T* xr = x + static_cast<long long>(r) * hw;
    T* yr = y + static_cast<long long>(r) * hw;
    long long head = hw;
    if constexpr (kVec) {
      head = head_of(xr);
      if (head > hw) head = hw;
    }
    for (long long i = t; i < head; i += nt)
      from_float(affine(to_float(xr[i]), ar, br, kRelu), yr + i);
    if constexpr (kVec) {
      const long long nv = (hw - head) / kN;
      for (long long i = t; i < nv; i += nt) {
        float v[kN];
        Vec<T>::load(xr + head + i * kN, v);
#pragma unroll
        for (int j = 0; j < kN; ++j) v[j] = affine(v[j], ar, br, kRelu);
        Vec<T>::store(yr + head + i * kN, v);
      }
      for (long long i = head + nv * kN + t; i < hw; i += nt)
        from_float(affine(to_float(xr[i]), ar, br, kRelu), yr + i);
    }
  }
}

// K9, HW < kFlatHw: element e = (n * C + c) * HW + i over a flat grid-stride,
// kN elements a thread at a time (16-byte loads when kVec: x and y
// 16-byte aligned), with the channel of each element.
template <typename T, bool kVec, bool kRelu>
__global__ void __launch_bounds__(kThreads)
scale_bias_act_flat_kernel(const T* __restrict__ x,
                           const float* __restrict__ a,
                           const float* __restrict__ b, Divider hw_div,
                           Divider c_div, unsigned total, T* __restrict__ y) {
  constexpr int kN = kVec ? Vec<T>::kN : 1;
  const unsigned n_vec = total / kN;
  const unsigned step = gridDim.x * kThreads;
  for (unsigned v = blockIdx.x * kThreads + threadIdx.x; v < n_vec;
       v += step) {
    const unsigned e = v * kN;
    unsigned run = hw_div.div(e);
    unsigned i = e - run * hw_div.d;
    unsigned c = run - c_div.div(run) * c_div.d;
    float ac = round_to(__ldg(a + c), x), bc = round_to(__ldg(b + c), x);
    float val[kN];
    if constexpr (kVec) {
      Vec<T>::load(x + e, val);
    } else {
      val[0] = to_float(x[e]);
    }
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      if (j > 0 && ++i == hw_div.d) {  // the next run: the next channel
        i = 0;
        c = c + 1 == c_div.d ? 0 : c + 1;
        ac = round_to(__ldg(a + c), x);
        bc = round_to(__ldg(b + c), x);
      }
      val[j] = affine(val[j], ac, bc, kRelu);
    }
    if constexpr (kVec) {
      Vec<T>::store(y + e, val);
    } else {
      from_float(val[0], y + e);
    }
  }
  // the last total % kN elements
  const unsigned e = n_vec * kN + blockIdx.x * kThreads + threadIdx.x;
  if (kVec && blockIdx.x == 0 && e < total) {
    const unsigned run = hw_div.div(e);
    const unsigned c = run - c_div.div(run) * c_div.d;
    from_float(affine(to_float(x[e]), round_to(__ldg(a + c), x),
                      round_to(__ldg(b + c), x), kRelu),
               y + e);
  }
}

template <typename T>
int launch_sums(const void* xv, int n, int c, long long hw, float* out,
                const Fold& f, cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  const long long run = static_cast<long long>(n) * hw;
  if (run <= kTinyRun || hw == 1) {
    channel_sums_tiny_kernel<T>
        <<<(c + kSumThreads - 1) / kSumThreads, kSumThreads, 0, st>>>(
            x, n, c, hw, out, f);
    return static_cast<int>(cudaGetLastError());
  }
  // split a channel over k blocks while the grid still fits on the card
  // at once and each block still reads kMinSlice elements
  int k = 1;
  while (k < kMaxCluster && static_cast<long long>(c) * k * 2 <= kSlots &&
         run / (2 * k) >= kMinSlice)
    k *= 2;
  long long piece = (hw + k - 1) / k;
  piece = (piece + 15) / 16 * 16;  // slices start 16-byte aligned in a run
  const bool aligned = (reinterpret_cast<uintptr_t>(xv) & 15u) == 0 &&
                       hw % Vec<T>::kN == 0;
  const Divider n_div = make_divider(static_cast<unsigned>(n));
  if (k == 1) {
    if (aligned) {
      channel_sums_kernel<T, false, true><<<c, kSumThreads, 0, st>>>(
          x, n, c, hw, hw, n_div, out, f);
    } else {
      channel_sums_kernel<T, false, false><<<c, kSumThreads, 0, st>>>(
          x, n, c, hw, hw, n_div, out, f);
    }
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(c) * k);
  cfg.blockDim = dim3(kSumThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      aligned ? cudaLaunchKernelEx(&cfg, channel_sums_kernel<T, true, true>,
                                   x, n, c, hw, piece, n_div, out, f)
              : cudaLaunchKernelEx(&cfg, channel_sums_kernel<T, true, false>,
                                   x, n, c, hw, piece, n_div, out, f);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kRelu>
int launch_affine(const void* xv, const float* a, const float* b, int n,
                  int c, long long hw, void* yv, cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(xv);
  const uintptr_t ya = reinterpret_cast<uintptr_t>(yv);
  const long long total = static_cast<long long>(n) * c * hw;
  if (hw < kFlatHw && total < (1ll << 31)) {
    const bool vec = ((xa | ya) & 15u) == 0;
    const long long per = vec ? Vec<T>::kN : 1;
    long long blocks = (total / per + kThreads - 1) / kThreads;  // 1 a thread
    blocks = blocks < 1 ? 1 : (blocks > 65535 ? 65535 : blocks);
    const Divider hd = make_divider(static_cast<unsigned>(hw));
    const Divider cd = make_divider(static_cast<unsigned>(c));
    if (vec) {
      scale_bias_act_flat_kernel<T, true, kRelu>
          <<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
              x, a, b, hd, cd, static_cast<unsigned>(total), y);
    } else {
      scale_bias_act_flat_kernel<T, false, kRelu>
          <<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
              x, a, b, hd, cd, static_cast<unsigned>(total), y);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const bool vec = ((xa ^ ya) & 15u) == 0;
  const long long per = vec ? Vec<T>::kN : 1;
  long long gx = (hw / per + kThreads * 4 - 1) / (kThreads * 4);
  gx = gx < 1 ? 1 : (gx > 65535 ? 65535 : gx);
  const int runs = n * c;
  const int gy = runs < 65535 ? runs : 65535;
  const dim3 grid(static_cast<unsigned>(gx), gy);
  if (vec) {
    scale_bias_act_kernel<T, true, kRelu><<<grid, kThreads, 0, st>>>(
        x, a, b, c, runs, hw, y);
  } else {
    scale_bias_act_kernel<T, false, kRelu><<<grid, kThreads, 0, st>>>(
        x, a, b, c, runs, hw, y);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K8.  x (n, c, hw) float32 (bf16 = 0) or bfloat16 (bf16 = 1).  weight ==
// NULL: out (2, c) float32 (sum, sum of squares).  Otherwise out (5, c)
// float32 (mean, inv, a, b, d), running_mean and running_var (c,) float32
// updated in place, num_batches_tracked (int64 scalar, or NULL) + 1; eps and
// momentum as torch's BatchNorm takes them.  One launch on the caller's
// stream; returns the launch's CUDA error (0: none).
int tsg_channel_sums(const void* x, int n, int c, long long hw, int bf16,
                     void* out, const void* weight, const void* bias,
                     void* running_mean, void* running_var,
                     void* num_batches_tracked, double eps, double momentum,
                     void* stream) {
  const long long count = static_cast<long long>(n) * hw;
  Fold f;
  f.weight = static_cast<const float*>(weight);
  f.bias = static_cast<const float*>(bias);
  f.running_mean = static_cast<float*>(running_mean);
  f.running_var = static_cast<float*>(running_var);
  f.num_batches_tracked = static_cast<long long*>(num_batches_tracked);
  // as torch rounds a Python float operand of a float32 tensor op
  f.n = static_cast<float>(count);
  f.eps = static_cast<float>(eps);
  f.m = static_cast<float>(momentum);
  f.keep = static_cast<float>(1.0 - momentum);
  f.unbias = static_cast<float>(static_cast<double>(count) /
                                static_cast<double>(count > 1 ? count - 1 : 1));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  return bf16 ? launch_sums<__nv_bfloat16>(x, n, c, hw, o, f, st)
              : launch_sums<float>(x, n, c, hw, o, f, st);
}

// K9.  y = relu?(x * a[c] + b[c]) for x, y (n, c, hw) float32 or bfloat16
// (flags bit 0: bfloat16; bit 1: ReLU); a, b (c,) float32, rounded to x's
// dtype in the kernel.  One launch on the caller's stream; returns the
// launch's CUDA error.
int tsg_scale_bias_act(const void* x, const void* a, const void* b, int n,
                       int c, long long hw, int flags, void* y,
                       void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  switch (flags & 3) {
    case 0: return launch_affine<float, false>(x, af, bf, n, c, hw, y, st);
    case 1:
      return launch_affine<__nv_bfloat16, false>(x, af, bf, n, c, hw, y, st);
    case 2: return launch_affine<float, true>(x, af, bf, n, c, hw, y, st);
    default:
      return launch_affine<__nv_bfloat16, true>(x, af, bf, n, c, hw, y, st);
  }
}

}  // extern "C"
