// Hand-written Hopper (sm_90a) kernel for the full-resolution serving
// epilogue.  Python side: torchseg_tpu_torch/ops/kernels/upsample_argmax.py
// (wrapper, shape checks, plain PyTorch version).
//
//   upsample_argmax_kernel  (K7)  replaces the TPU kernel
//       torchseg_tpu/ops/pallas/upsample_argmax.py:49
//       fused_upsample_argmax (and stands in for the XLA epilogue
//       ops/resize.py:89 tiled_upsample_argmax).
//
// What it computes: (B, h, w, C) f32 logits -> (B, H, W) int32, the argmax
// over classes of the align-corners bilinear upsample to (H, W), first
// maximum wins.  The (H, W, C) score tensor is never stored.  Per output
// pixel (i, j) and class c, as the plain version orders it (rows first,
// then columns):
//     z0 = a0 * x[y0, x0, c] + a1 * x[y1, x0, c]
//     z1 = a0 * x[y0, x1, c] + a1 * x[y1, x1, c]
//     s  = b0 * z0 + b1 * z1
// with the two taps and f32 weights of row i of _interp_matrix_np(h, H)
// (a) and row j of _interp_matrix_np(w, W) (b), recomputed here from the
// same float64 source position, so the weights are that function's bit
// for bit.  Classes are scanned in order with a strict >.
//
// What bounds it: bytes, and few of them: the logits (2.5 MB at
// 128x256x19) stay in L2 and L1, and the only device-memory stream is the
// 8 MB int32 label write at 1024x2048 -- against 160 MB written and read
// back by the materialized epilogue.  Design: one thread per output pixel;
// a warp covers 32 neighbouring columns of one row, whose source taps span
// a few neighbouring source pixels, so its logit loads are near-broadcasts
// served from L1.  Any H, W, C (the TPU kernel's 128-multiple tiles were a
// TPU layout limit).  No shared memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // output columns per block

// Row i of _interp_matrix_np(n_in, n_out) (torchseg_tpu/ops/resize.py:20):
// its two taps t0 <= t1 and their float32 weights.
__device__ __forceinline__ void interp_taps(int i, int n_in, int n_out,
                                            int* t0, int* t1, float* w0,
                                            float* w1) {
  if (n_in == 1 || n_out == 1) {  // everything reads source position 0
    *t0 = *t1 = 0;
    *w0 = 1.f;
    *w1 = 0.f;
    return;
  }
  // numpy: arange(n_out, float64) * (n_in - 1) / (n_out - 1), both IEEE
  // float64 operations rounded to nearest
  const double src = __ddiv_rn(static_cast<double>(i) * (n_in - 1),
                                static_cast<double>(n_out - 1));
  const int f = min(max(static_cast<int>(floor(src)), 0), n_in - 2);
  const float frac = __double2float_rn(src - f);  // exact, then to f32
  *t0 = f;
  *t1 = f + 1;
  *w0 = __fsub_rn(1.f, frac);
  *w1 = frac;
}

__global__ void __launch_bounds__(kThreads)
upsample_argmax_kernel(const float* __restrict__ x, int h, int w, int nc,
                       int32_t* __restrict__ out, int oh, int ow) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const int i = blockIdx.y;
  const int b = blockIdx.z;
  if (j >= ow) return;
  int y0, y1, x0, x1;
  float a0, a1, b0, b1;
  interp_taps(i, h, oh, &y0, &y1, &a0, &a1);
  interp_taps(j, w, ow, &x0, &x1, &b0, &b1);
  const float* img = x + static_cast<size_t>(b) * h * w * nc;
  const float* p00 = img + (static_cast<size_t>(y0) * w + x0) * nc;
  const float* p01 = img + (static_cast<size_t>(y0) * w + x1) * nc;
  const float* p10 = img + (static_cast<size_t>(y1) * w + x0) * nc;
  const float* p11 = img + (static_cast<size_t>(y1) * w + x1) * nc;
  float best = -INFINITY;
  int arg = 0;
  for (int c = 0; c < nc; ++c) {
    const float z0 = __fadd_rn(__fmul_rn(a0, __ldg(p00 + c)), __fmul_rn(a1, __ldg(p10 + c)));
    const float z1 = __fadd_rn(__fmul_rn(a0, __ldg(p01 + c)), __fmul_rn(a1, __ldg(p11 + c)));
    const float s = __fadd_rn(__fmul_rn(b0, z0), __fmul_rn(b1, z1));
    if (s > best) {
      best = s;
      arg = c;
    }
  }
  out[(static_cast<size_t>(b) * oh + i) * ow + j] = arg;
}

}  // namespace

extern "C" {

// x (B, h, w, nc) f32 NHWC logits -> out (B, oh, ow) int32 labels, on the
// caller's stream; returns cudaGetLastError().
int tsg_upsample_argmax(const void* x, int batch, int h, int w, int nc,
                        void* out, int oh, int ow, void* stream) {
  dim3 grid((ow + kThreads - 1) / kThreads, oh, batch);
  upsample_argmax_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), h, w, nc, static_cast<int32_t*>(out), oh,
      ow);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
