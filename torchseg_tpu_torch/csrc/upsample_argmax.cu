// Hand-written Hopper (sm_90a) kernel for the full-resolution serving
// epilogue.  Python side: torchseg_tpu_torch/ops/kernels/upsample_argmax.py
// (wrapper, shape checks, block sizing, plain PyTorch version).
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
// (a) and row j of _interp_matrix_np(w, W) (b), which the wrapper hands
// over as tables built by the same numpy operations (tap_table), so the
// weights are that function's bit for bit.  Classes are scanned in order
// with a strict >.
//
// What bounds it: bytes -- the logits (2.5 MB at 128x256x19) and the 8 MB
// int32 label write at 1024x2048.  The separable form needs 3 float32
// operations a class and output pixel (two products, one sum) plus the row
// pass, which is far below the card's rate for those bytes.
//
// Design (separable): a block owns a chunk of up to 1024 output columns
// of a few output rows.  Per output row it first computes the row lerp
//     r[x, c] = a0 * x[y0, x, c] + a1 * x[y1, x, c]
// once for the source columns the chunk reads, into shared memory
// (coalesced loads of the two contiguous source-row segments), then each
// thread scans the classes for its columns (j = chunk start + thread +
// 256 k) as s = b0 * r[x0, c] + b1 * r[x1, c].  These are z0, z1 and s of
// the per-pixel formula with the same operations in the same rounding
// order (__fmul_rn / __fadd_rn, nothing contracted), so the labels are
// those of the one-thread-a-pixel kernel this replaced, bit for bit; only
// the row lerps of a row are no longer recomputed by every pixel.  The
// column taps and weights of a thread's columns are read once per block,
// into registers, and serve the block's output rows.
// Consecutive threads write consecutive labels
// (128-byte warp stores).  Any H, W, C: the host picks the chunk so that
// one source column of r fits the shared memory, and where a row of r
// (span x C floats) does not, the classes are scanned in chunks with the
// running (best, arg) kept in registers, which keeps the first-maximum
// rule.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kColsPerThread = 4;  // output columns a thread may own
constexpr int kRows = 2;           // output rows a block computes

// grid (column chunks, row groups, batch); dynamic shared memory
// span_max * cc4 floats, where span_max bounds the source columns of any
// chunk of `cols` output columns, cc is the class chunk and cc4 = cc
// rounded up to 4 (a row of r is read as float4; the pad holds -inf,
// whose scores never beat the running maximum under the strict >).
__global__ void __launch_bounds__(kThreads)
upsample_argmax_kernel(const float* __restrict__ x, int h, int w, int nc,
                       const int* __restrict__ rtab,
                       const int* __restrict__ ctab,
                       int32_t* __restrict__ out, int oh, int ow, int cols,
                       int cc) {
  extern __shared__ __align__(16) float r_s[];  // [column - xs0][class - c0]
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * cols;
  const int j_end = min(j0 + cols, ow);
  const int i0 = blockIdx.y * kRows;
  const int b = blockIdx.z;
  const float* img = x + static_cast<size_t>(b) * h * w * nc;

  // this chunk's source columns: the taps of its first and last column
  const int xs0 = __ldg(ctab + j0), xs1 = __ldg(ctab + ow + j_end - 1);
  const int span = xs1 - xs0 + 1;

  const int cc4 = (cc + 3) & ~3;
  // this thread's columns: local tap offsets and weights, once per block
  int t0[kColsPerThread], t1[kColsPerThread];
  float w0[kColsPerThread], w1[kColsPerThread];
#pragma unroll
  for (int k = 0; k < kColsPerThread; ++k) {
    const int j = j0 + tid + k * kThreads;
    int c0 = xs0, c1 = xs0;
    float f0 = 0.f, f1 = 0.f;
    if (j < j_end) {
      c0 = __ldg(ctab + j);
      c1 = __ldg(ctab + ow + j);
      f0 = __int_as_float(__ldg(ctab + 2 * ow + j));
      f1 = __int_as_float(__ldg(ctab + 3 * ow + j));
    }
    t0[k] = (c0 - xs0) * cc4;
    t1[k] = (c1 - xs0) * cc4;
    w0[k] = f0;
    w1[k] = f1;
  }

  const int i_end = min(i0 + kRows, oh);
  for (int i = i0; i < i_end; ++i) {
    const int y0 = __ldg(rtab + i), y1 = __ldg(rtab + oh + i);
    const float a0 = __int_as_float(__ldg(rtab + 2 * oh + i));
    const float a1 = __int_as_float(__ldg(rtab + 3 * oh + i));
    const float* row0 = img + (static_cast<size_t>(y0) * w + xs0) * nc;
    const float* row1 = img + (static_cast<size_t>(y1) * w + xs0) * nc;
    float best[kColsPerThread];
    int arg[kColsPerThread];
#pragma unroll
    for (int k = 0; k < kColsPerThread; ++k) {
      best[k] = -INFINITY;
      arg[k] = 0;
    }
    for (int c0 = 0; c0 < nc; c0 += cc) {
      const int ncc = min(cc, nc - c0);
      const int ncc4 = (ncc + 3) & ~3;
      __syncthreads();  // the last pass's readers of r_s are done
      // row pass: r = a0 * row y0 + a1 * row y1 over span x ncc values,
      // -inf in the pad up to ncc4; element e = q * ncc4 + c walks by
      // kThreads with (q, c) carried, not divided
      const int dq = kThreads / ncc4, dc = kThreads - dq * ncc4;
      int q = tid / ncc4, c = tid - q * ncc4;
      for (; q < span; q += dq, c += dc) {
        if (c >= ncc4) {
          c -= ncc4;
          ++q;
          if (q >= span) break;
        }
        const size_t g = static_cast<size_t>(q) * nc + c0 + c;
        r_s[q * cc4 + c] =
            c < ncc ? __fadd_rn(__fmul_rn(a0, __ldg(row0 + g)),
                                __fmul_rn(a1, __ldg(row1 + g)))
                    : -INFINITY;
      }
      __syncthreads();
      // column pass: s = b0 * r[x0] + b1 * r[x1], classes in order, four
      // at a time (float4 reads: one shared load serves four classes); the
      // thread's columns interleaved (independent chains); a column past
      // the chunk reads local column 0 and is never stored
      for (int c = 0; c < ncc4; c += 4) {
#pragma unroll
        for (int k = 0; k < kColsPerThread; ++k) {
          const float4 p = *reinterpret_cast<const float4*>(r_s + t0[k] + c);
          const float4 q = *reinterpret_cast<const float4*>(r_s + t1[k] + c);
          const float v0[4] = {p.x, p.y, p.z, p.w};
          const float v1[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float s = __fadd_rn(__fmul_rn(w0[k], v0[e]),
                                      __fmul_rn(w1[k], v1[e]));
            if (s > best[k]) {
              best[k] = s;
              arg[k] = c0 + c + e;
            }
          }
        }
      }
    }
    int32_t* dst = out + (static_cast<size_t>(b) * oh + i) * ow;
#pragma unroll
    for (int k = 0; k < kColsPerThread; ++k) {
      const int j = j0 + tid + k * kThreads;
      if (j < j_end) dst[j] = arg[k];
    }
  }
}

}  // namespace

extern "C" {

// The most output columns one block takes (the wrapper's chunk bound).
int tsg_upsample_max_cols() { return kThreads * kColsPerThread; }

// x (B, h, w, nc) f32 NHWC logits -> out (B, oh, ow) int32 labels, on the
// caller's stream.  rtab (4, oh) and ctab (4, ow) int32: the taps t0, t1
// and the float32 weights' bits w0, w1 of each output row / column.  cols
// (<= tsg_upsample_max_cols()) output columns a block, cc classes a pass,
// smem_bytes = 4 * (cc rounded up to 4) * (largest source span of a
// chunk), at most 48 KB (the wrapper sizes them); returns
// cudaGetLastError().
int tsg_upsample_argmax(const void* x, int batch, int h, int w, int nc,
                        const void* rtab, const void* ctab, void* out, int oh,
                        int ow, int cols, int cc, int smem_bytes,
                        void* stream) {
  if (cols < 1 || cols > kThreads * kColsPerThread || cc < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((ow + cols - 1) / cols, (oh + kRows - 1) / kRows, batch);
  upsample_argmax_kernel<<<grid, kThreads, smem_bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), h, w, nc, static_cast<const int*>(rtab),
      static_cast<const int*>(ctab), static_cast<int32_t*>(out), oh, ow, cols,
      cc);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
