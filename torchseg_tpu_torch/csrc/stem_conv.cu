// Hand-written Hopper (sm_90a) kernel for the deploy graph's fused stem.
// Python side: torchseg_tpu_torch/ops/kernels/stem_conv.py (wrapper, shape
// checks, plain PyTorch version).
//
//   stem_conv_kernel  (K11)  replaces the TPU kernel
//       torchseg_tpu/ops/pallas/stem_conv.py:75 stem_conv7x7_s2
//
// What it computes: for an image of (N, H, W, 3) pixels, read either NHWC
// with 3 or 8 channels (the first 3 are the image) or as the 2x2
// space-to-depth tensor (N, H/2, W/2, 12) whose channel (2a + b) * 3 + c
// holds pixel (2i + a, 2j + b, c), and a (7, 7, 3, cout) HWIO kernel:
//     y[n, o, i, j] = relu(acc * a[o] + b[o]),
//     acc = sum over (u, v, c) of img[2i-3+u, 2j-3+v, c] * k[u, v, c, o]
// (zeros outside the image), summed, scaled and shifted in float32 and
// cast once to the output type.  Channels [0, n_sp) go to out1, the rest to
// out2, both NCHW (N, ., H/2, W/2).  BiSeNet's SpatialPath 7x7/2 and the
// backbone stem (ResNet's 7x7/2, or Xception39's 3x3/2 centred in the 7x7
// window) are the two halves.
//
// What bounds it: float32 multiply-adds on the CUDA cores.  The 7x7 window
// over 3 channels is 147 taps a pixel and channel (zeros of an embedded 3x3
// included): 3.1 G multiply-adds for X39.speed's 72 channels at 768x1536,
// ~93 us at the card's 67 TFLOP/s float32 rate, against 14.8 us of bytes.
// Design, the simple one: a block computes a strip of 64 output columns
// of up to 8 output rows; its warps each own 8 output channels, and each
// thread two pixels of the strip (columns j and j + 32) for those
// channels, so each tap's two float4 weight reads from shared memory
// serve 16 multiply-adds.  The (147, cout) float32 weights sit in shared
// memory for the whole block (75 KB at cout 128: the limit is opted in to
// in tsg_init); the 7 input rows of each output row are staged as float32
// with even and odd columns apart, so the stride-2 taps of consecutive
// threads read consecutive words.  Consecutive threads write consecutive
// pixels of one channel plane (coalesced NCHW stores).  Tensor cores
// (mma / wgmma bf16 on an im2col tile) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCin = 3;                   // image channels the kernel reads
constexpr int kTaps = 7 * 7 * kCin;       // 147
constexpr int kWarpPix = 32;              // pixels a warp covers per pass
constexpr int kPix = 2;                   // pixels a thread computes
constexpr int kTile = kWarpPix * kPix;    // 64 output columns per block
constexpr int kRows = 8;                  // output rows per block
constexpr int kGroup = 8;                 // output channels per warp
constexpr int kMaxCout = 128;
constexpr int kHalf = kTile + 3;          // strip columns of one parity
constexpr int kInFloats = 7 * kCin * 2 * kHalf;

__host__ __device__ constexpr int cout_pad(int cout) {
  return (cout + kGroup - 1) / kGroup * kGroup;
}

__host__ __device__ constexpr size_t smem_bytes(int cout) {
  return (static_cast<size_t>(kTaps) * cout_pad(cout) + kInFloats) *
         sizeof(float);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kWarpPix * kMaxCout / kGroup)
stem_conv_kernel(const Tin* __restrict__ x, int h, int w, int cx, int s2d,
                 const float* __restrict__ wt, const float* __restrict__ a,
                 const float* __restrict__ b, int cout, int n_sp,
                 Tout* __restrict__ out1, Tout* __restrict__ out2) {
  extern __shared__ __align__(16) float smem[];
  const int cpad = cout_pad(cout);
  float* s_w = smem;                   // [tap = (u * 7 + v) * 3 + c][cpad]
  float* s_in = smem + kTaps * cpad;   // [u][c][column parity][kHalf]
  const int ho = h >> 1, wo = w >> 1;
  const int j0 = blockIdx.x * kTile;
  const int i0 = blockIdx.y * kRows;
  const int n = blockIdx.z;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int g = tid >> 5;  // this warp's channel group

  for (int k = tid; k < kTaps * cpad; k += nthreads) {
    const int t = k / cpad, c = k - t * cpad;
    s_w[k] = c < cout ? __ldg(wt + t * cout + c) : 0.f;
  }
  // both layouts hold H * W * 3 (s2d) or H * W * cx (nhwc) elements an image
  const Tin* img = x + static_cast<size_t>(n) * h * w * cx;
  const size_t plane = static_cast<size_t>(ho) * wo;
  const int i_end = min(i0 + kRows, ho);

  for (int i = i0; i < i_end; ++i) {
    __syncthreads();  // the weights are in; the last row's reads are done
    for (int k = tid; k < 7 * kCin * 2 * kHalf; k += nthreads) {
      const int q = k % (2 * kHalf);  // strip column, 0 .. 2 * kTile + 5
      const int rest = k / (2 * kHalf);
      const int c = rest % kCin;
      const int u = rest / kCin;
      const int r = 2 * i - 3 + u;
      const int col = 2 * j0 - 3 + q;
      float v = 0.f;
      if (r >= 0 && r < h && col >= 0 && col < w) {
        const size_t idx =
            s2d ? (static_cast<size_t>(r >> 1) * (w >> 1) + (col >> 1)) * 12 +
                      ((r & 1) * 2 + (col & 1)) * kCin + c
                : (static_cast<size_t>(r) * w + col) * cx + c;
        v = to_f32(img[idx]);
      }
      s_in[((u * kCin + c) * 2 + (q & 1)) * kHalf + (q >> 1)] = v;
    }
    __syncthreads();

    float acc[kPix][kGroup];
#pragma unroll
    for (int p = 0; p < kPix; ++p)
#pragma unroll
      for (int o = 0; o < kGroup; ++o) acc[p][o] = 0.f;
    for (int u = 0; u < 7; ++u) {
#pragma unroll
      for (int v = 0; v < 7; ++v) {
#pragma unroll
        for (int c = 0; c < kCin; ++c) {
          const float* row = s_in + ((u * kCin + c) * 2 + (v & 1)) * kHalf +
                             (v >> 1) + lane;
          const float4* wp = reinterpret_cast<const float4*>(
              s_w + ((u * 7 + v) * kCin + c) * cpad + g * kGroup);
          const float4 w0 = wp[0], w1 = wp[1];
          const float wv[kGroup] = {w0.x, w0.y, w0.z, w0.w,
                                    w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int p = 0; p < kPix; ++p) {
            const float xv = row[p * kWarpPix];
#pragma unroll
            for (int o = 0; o < kGroup; ++o)
              acc[p][o] = __fmaf_rn(xv, wv[o], acc[p][o]);
          }
        }
      }
    }

#pragma unroll
    for (int o = 0; o < kGroup; ++o) {
      const int ch = g * kGroup + o;
      if (ch >= cout) break;
      const float sa = __ldg(a + ch), sb = __ldg(b + ch);
      const int n2 = cout - n_sp;
      Tout* dst = ch < n_sp
          ? out1 + (static_cast<size_t>(n) * n_sp + ch) * plane
          : out2 + (static_cast<size_t>(n) * n2 + ch - n_sp) * plane;
      dst += static_cast<size_t>(i) * wo;
#pragma unroll
      for (int p = 0; p < kPix; ++p) {
        const int j = j0 + p * kWarpPix + lane;
        if (j < wo)
          store(dst + j,
                fmaxf(__fadd_rn(__fmul_rn(acc[p][o], sa), sb), 0.f));
      }
    }
  }
}

template <typename Tin, typename Tout>
cudaError_t opt_in() {
  return cudaFuncSetAttribute(
      reinterpret_cast<const void*>(stem_conv_kernel<Tin, Tout>),
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(kMaxCout)));
}

template <typename Tin, typename Tout>
void launch(const void* x, int batch, int h, int w, int cx, int s2d,
            const void* wt, const void* a, const void* b, int cout, int n_sp,
            void* out1, void* out2, cudaStream_t stream) {
  const int ho = h / 2, wo = w / 2;
  dim3 grid((wo + kTile - 1) / kTile, (ho + kRows - 1) / kRows, batch);
  const int threads = kWarpPix * (cout_pad(cout) / kGroup);
  stem_conv_kernel<Tin, Tout><<<grid, threads, smem_bytes(cout), stream>>>(
      static_cast<const Tin*>(x), h, w, cx, s2d,
      static_cast<const float*>(wt), static_cast<const float*>(a),
      static_cast<const float*>(b), cout, n_sp, static_cast<Tout*>(out1),
      static_cast<Tout*>(out2));
}

}  // namespace

extern "C" {

// Opt every instantiation in to the shared memory of cout = 128 on the
// current device; returns the first CUDA error.
int tsg_init() {
  cudaError_t e[4] = {opt_in<float, float>(), opt_in<float, __nv_bfloat16>(),
                      opt_in<__nv_bfloat16, float>(),
                      opt_in<__nv_bfloat16, __nv_bfloat16>()};
  for (cudaError_t err : e)
    if (err != cudaSuccess) return static_cast<int>(err);
  return 0;
}

// x: (batch, h, w, cx) NHWC image, or with s2d the (batch, h/2, w/2, 12)
// space-to-depth tensor (cx = 3); float32 or bf16 (in_bf16).  wt (7, 7, 3,
// cout) float32 HWIO, a and b (cout,) float32.  out1 (batch, n_sp, h/2,
// w/2) and out2 (batch, cout - n_sp, h/2, w/2), float32 or bf16 (out_bf16).
// h and w even, 1 <= cout <= 128, 0 <= n_sp <= cout.  On the caller's
// stream; returns cudaGetLastError().
int tsg_stem_conv(const void* x, int batch, int h, int w, int cx, int s2d,
                  int in_bf16, const void* wt, const void* a, const void* b,
                  int cout, int n_sp, void* out1, void* out2, int out_bf16,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16 && out_bf16)
    launch<__nv_bfloat16, __nv_bfloat16>(x, batch, h, w, cx, s2d, wt, a, b,
                                         cout, n_sp, out1, out2, s);
  else if (in_bf16)
    launch<__nv_bfloat16, float>(x, batch, h, w, cx, s2d, wt, a, b, cout,
                                 n_sp, out1, out2, s);
  else if (out_bf16)
    launch<float, __nv_bfloat16>(x, batch, h, w, cx, s2d, wt, a, b, cout,
                                 n_sp, out1, out2, s);
  else
    launch<float, float>(x, batch, h, w, cx, s2d, wt, a, b, cout, n_sp, out1,
                         out2, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
