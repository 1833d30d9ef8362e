// Hand-written Hopper (sm_90a) kernels for the deploy graph's fused stem.
// Python side: torchseg_tpu_torch/ops/kernels/stem_conv.py (wrapper, shape
// checks, weight packing, plain PyTorch version).
//
//   K11 replaces the TPU kernel
//       torchseg_tpu/ops/pallas/stem_conv.py:75 stem_conv7x7_s2
//   as two routes, chosen by the image's dtype (a dispatch, not a
//   fallback: a bf16 image on the card always runs the first):
//     stem_conv_wgmma_kernel  bf16 image: bf16 tensor cores (wgmma,
//                             m64nNk16, A from registers, B resident in
//                             shared memory), float32-exact products;
//                             with bf16 output followed by
//     stem_fix_kernel         the outputs whose bf16 rounding the sum's
//                             order could decide, recomputed in the
//                             float32 reference order (CUDA cores);
//     stem_conv_kernel        float32 image: float32 FMAs on the CUDA
//                             cores (the float32 model's card checks only).
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
// --- the tensor-core route (bf16 image) ---------------------------------
// What bounds it: bytes.  The output is 134 MB of bf16 at R18's 1024x2048
// (64 + 64 channels at 512x1024), 146.9 MB moved in all = 44 us at 3.35
// TB/s; its tensor work is 2 * pixels * cout * 192 * 3 = 77 G operations
// (78 us at the 989 TFLOP/s dense bf16 peak), so at the tensor cores' real
// rate the operations come close to binding too, and the rounding check
// adds its per-output test and the listed outputs' 147-step chains.
// Design:
//   * the conv is an implicit-im2col GEMM over the s2d image: M = output
//     pixels, N = cout (padded to the packed width 64, 72 or 128), and the
//     7x7/2 window is the 4x4 s2d window, K = 4 rows x 48: for s2d row
//     offset dy the window of output pixel j is the 48 contiguous values
//     from element 12 j of that staged row (s2d columns j-2 .. j+1, the row
//     staged from column -2), k = 48 dy + 12 dx + (2a + b) 3 + c, tap
//     (u, v) = (2 dy + a - 1, 2 dx + b - 1); u or v = -1 is a zero weight.
//     The windows of neighbouring pixels start 24 bytes apart, so the A
//     fragments (each warp's 16 pixels x 16 k, mma.m16n8k16's layout) come
//     from 4-byte shared loads, not ldmatrix;
//   * exact products: every float32 weight is split on the host into three
//     bf16 terms, w = hi + mid + lo, exact for normal weights (3 x 8
//     significand bits), and the three products run against the same A
//     fragment into one float32 accumulator, lo's and mid's steps first so
//     the small terms are summed at their own magnitude.  A bf16 pixel
//     times a bf16 term is exact in float32, so the result differs from
//     the float32 conv only in the order of the float32 sum;
//   * the same bf16 output as the reference: the plain version's float32
//     conv (cuDNN's and the CPU's, and the CUDA-core route: one FMA chain
//     over (u, v, c)) rounds a few outputs in 1e5 to the other bf16
//     neighbour than the tensor cores' order does, and BiSeNet-X39's bf16
//     graph amplifies those into label changes.  So the epilogue checks
//     each bf16 output: within kKappa * 2^-24 * |a| * ||x|| * ||w|| of a
//     bf16 rounding boundary or of zero (||x|| of the pixel's window,
//     computed per row from the ring; ||w|| per channel) it is listed, and
//     stem_fix_kernel recomputes the listed ones in the reference order
//     (~0.7 % of the served stems' outputs);
//   * the three packed terms (3 x 192 x N bf16, 144 KB at N = 128) are
//     staged once per block in wgmma's no-swizzle K-major layout (8 x 8
//     core matrices of 128 bytes, [term][k / 8][n / 8]) and stay resident;
//   * a block is three warpgroups, persistent (about one block per SM);
//     each warpgroup walks its own run of output rows of one 64-column
//     tile at a time, with its own ring of five staged s2d rows (cp.async,
//     the next row in flight while it computes) and its own named
//     barrier, so the three drift apart and one's loads and epilogue
//     overlap another's tensor work;
//   * per output row a warpgroup loads its 12 k16 steps of A (48
//     registers), issues 12 x 3 x (N / 64 m64n64k16 + N % 64 / 8 m64n8k16)
//     wgmmas on the resident B, and waits once;
//   * the epilogue applies the affine and ReLU in float32 and casts once;
//     a bf16 tile (the served graphs') is staged transposed in shared
//     memory, (channel, 64 pixels), and leaves in 16-byte stores along W
//     while the warpgroup's next row runs its wgmmas; float32 output is
//     stored from the fragments (eight pixels of a channel a store).
// The NHWC image is rearranged into the s2d layout while it is staged
// (plain loads; the served graphs feed the s2d tensor).
//
// --- the CUDA-core route (float32 image) --------------------------------
// What bounds it: float32 multiply-adds on the CUDA cores: 147 taps a pixel
// and channel.  A block computes a strip of 64 output columns of up to 8
// output rows; its warps each own 8 output channels, each thread two pixels
// of the strip, so each tap's two float4 weight reads from shared memory
// serve 16 multiply-adds; the (147, cout) float32 weights sit in shared
// memory for the whole block; the 7 input rows of each output row are
// staged with even and odd columns apart, so the stride-2 taps of
// consecutive threads read consecutive words.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// ===================== tensor-core route (bf16 image) ===================

constexpr int kWgs = 3;                    // warpgroups a block
constexpr int kTcThreads = 128 * kWgs;
constexpr int kTileCols = 64;              // output columns a warpgroup row
constexpr int kStagePix = kTileCols + 3;   // s2d columns j0-2 .. j0+64
constexpr int kStageBytes = kStagePix * 24;  // 12 bf16 a pixel: 1608
constexpr int kRing = 5;                   // staged s2d rows a warpgroup
constexpr int kK = 192;                    // the s2d window's depth
constexpr int kTerms = 3;                  // hi, mid, lo

__host__ __device__ constexpr int pack_bytes(int n) {
  return kTerms * kK * n * 2;
}

constexpr int kOutRow = (kTileCols + 8) * 2;  // a staged bf16 channel row
// the warpgroups' rings, rounded up so the staged output tiles after them
// are 16-byte aligned
constexpr int kRingsBytes = (kWgs * kRing * kStageBytes + 127) / 128 * 128;

// The rounding check's margin: a bf16 output is recomputed in the float32
// FMA order when its float32 value lies within kKappa * 2^-24 * |a| *
// ||x|| * ||w|| of a bf16 rounding boundary or of zero.  ||x|| ||w|| bounds
// the sum of |products| (Cauchy-Schwarz); the two sums differed by at most
// 5.6 of these units over 2.5e8 outputs of the served stems and random
// ones on an H100 (PERF.md), their worst-case bound is ~180.
constexpr float kKappa = 8.f;
// stem_fix_kernel: threads a block, and the warpgroups' lists a block
// takes (kWgs: those of one tensor-core block)
constexpr int kFixThreads = 512;
constexpr int kFixLists = 3;

// bf16 output leaves through a staged (channel, pixel) tile per warpgroup,
// with the weights' and the windows' norms for the rounding check; float32
// output is stored from the fragments.
__host__ __device__ constexpr size_t tc_smem_bytes(int n, bool bf16_out) {
  return static_cast<size_t>(pack_bytes(n)) + 2 * n * sizeof(float) +
         kRingsBytes +
         (bf16_out ? static_cast<size_t>(kWgs) * n * kOutRow +
                         (n + kWgs * kTileCols + 4) * sizeof(float)
                   : 0);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 8-byte asynchronous copy global -> shared; src_bytes = 0 zero-fills.
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The barrier of warpgroup wg alone (ids 1..kWgs; 0 is __syncthreads).
__device__ __forceinline__ void wg_barrier(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(wg + 1) : "memory");
}

// wgmma's shared-memory matrix descriptor, no swizzle: start address,
// leading byte offset (the next core matrix along K) and stride byte
// offset (the next 8 rows along N), all in 16-byte units.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

template <int kLen>
__device__ __forceinline__ void fence_regs(float (&d)[kLen]) {
#pragma unroll
  for (int i = 0; i < kLen; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x 64 f32, the warpgroup's fragments) += a (64 x 16 bf16, registers)
// * b (16 x 64 bf16, K-major in shared memory).
__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// The same for an n8 slice (X39's 72 = 64 + 8 channels).
__device__ __forceinline__ void wgmma_n8(float (&d)[4], const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ int ring_slot(int r) {
  return ((r % kRing) + kRing) % kRing;
}

// Stage s2d row sr, columns j0-2 .. j0+64, of image n into one ring slot
// (zeros outside the image), by the 128 threads of a warpgroup (t = 0..127).
// s2d input: 8-byte cp.async copies (the caller commits); NHWC input: the
// 2x2 rearrangement with plain loads and stores.
__device__ __forceinline__ void stage_row(unsigned char* slot,
                                          const uint16_t* __restrict__ x,
                                          int n, int sr, int j0, int h2,
                                          int w2, int cx, int s2d, int t) {
  if (s2d) {
    const uint32_t base = smem_addr(slot);
    for (int q = t; q < kStagePix * 3; q += 128) {
      const int pix = q / 3, part = q - 3 * pix;
      const int sc = j0 - 2 + pix;
      const bool ok = sr >= 0 && sr < h2 && sc >= 0 && sc < w2;
      const uint16_t* src =
          ok ? x + ((static_cast<size_t>(n) * h2 + sr) * w2 + sc) * 12 +
                   4 * part
             : x;
      cp_async8(base + q * 8, src, ok ? 8 : 0);
    }
  } else {
    uint16_t* dst = reinterpret_cast<uint16_t*>(slot);
    const int h = 2 * h2, w = 2 * w2;
    for (int q = t; q < kStagePix * 12; q += 128) {
      const int pix = q / 12, ch = q - 12 * pix;
      const int ab = ch / 3, c = ch - 3 * ab;
      const int r = 2 * sr + (ab >> 1);
      const int col = 2 * (j0 - 2 + pix) + (ab & 1);
      uint16_t v = 0;
      if (sr >= 0 && sr < h2 && col >= 0 && col < w)
        v = x[((static_cast<size_t>(n) * h + r) * w + col) * cx + c];
      dst[q] = v;
    }
  }
}

// x: bf16 bits, (batch, h/2, w/2, 12) s2d or (batch, h, w, cx) NHWC.
// pack: the three bf16 terms, [term][k / 8][n / 8][n % 8][k % 8] (kN
// wide).  Work: batch x ceil(wo / 64) tiles x ho rows, row fastest; the
// warpgroup with global index s takes rows [s * rows_per_wg, ...).
template <int kN, typename Tout>
__global__ void __launch_bounds__(kTcThreads, 1)
stem_conv_wgmma_kernel(const uint16_t* __restrict__ x, int batch, int h,
                       int w, int cx, int s2d, const uint4* __restrict__ pack,
                       const float* __restrict__ wt,
                       const float* __restrict__ a, const float* __restrict__ b,
                       int cout, int n_sp, Tout* __restrict__ out1,
                       Tout* __restrict__ out2, int rows_per_wg,
                       uint32_t* __restrict__ fix_list,
                       int* __restrict__ fix_counts, int fix_cap) {
  constexpr int kN64 = kN / 64;       // m64n64k16 slices
  constexpr int kN8 = (kN % 64) / 8;  // m64n8k16 slices
  constexpr int kNb = kN / 8;         // core matrices along N
  constexpr bool kStaged = std::is_same<Tout, __nv_bfloat16>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* b_s = smem;
  float* sa = reinterpret_cast<float*>(smem + pack_bytes(kN));
  float* sb = sa + kN;
  unsigned char* ring = reinterpret_cast<unsigned char*>(sb + kN);
  // kStaged only: [warpgroup][channel][64 pixels + 8 pad] bf16, then
  // ||w|| per channel and ||window|| per pixel of each warpgroup's row
  unsigned char* out_s = ring + kRingsBytes;
  float* tol_ch = reinterpret_cast<float*>(out_s + kWgs * kN * kOutRow);
  float* xnorm = tol_ch + kN;
  int* fix_cnt = reinterpret_cast<int*>(xnorm + kWgs * kTileCols);

  const int tid = threadIdx.x;
  if constexpr (kStaged) {
    if (tid < kWgs) fix_cnt[tid] = 0;
  }
  for (int i = tid; i < pack_bytes(kN) / 16; i += kTcThreads)
    reinterpret_cast<uint4*>(b_s)[i] = __ldg(pack + i);
  for (int i = tid; i < kN; i += kTcThreads) {
    sa[i] = i < cout ? __ldg(a + i) : 0.f;
    sb[i] = i < cout ? __ldg(b + i) : 0.f;
    if constexpr (kStaged) {  // kKappa 2^-24 |a| ||w||, per channel
      float ss = 0.f;
      for (int k = 0; i < cout && k < 147; ++k)
        ss = __fmaf_rn(__ldg(wt + k * cout + i), __ldg(wt + k * cout + i), ss);
      tol_ch[i] = kKappa * 5.9604645e-8f * fabsf(sa[i]) * sqrtf(ss);
    }
  }
  // the generic-proxy stores above, before wgmma reads B (async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, t4 = lane & 3;
  unsigned char* my_ring = ring + wg * kRing * kStageBytes;
  const int h2 = h >> 1, w2 = w >> 1;  // = the output's ho, wo
  const int tiles = (w2 + kTileCols - 1) / kTileCols;
  const int total = batch * tiles * h2;
  const int u0 = (blockIdx.x * kWgs + wg) * rows_per_wg;
  const int u1 = min(u0 + rows_per_wg, total);
  const size_t plane = static_cast<size_t>(h2) * w2;
  const uint32_t b_base = smem_addr(b_s);
  constexpr uint32_t kTermBytes = kK / 8 * kNb * 128;
  unsigned char* my_out = out_s + wg * kN * kOutRow;
  float* my_xnorm = xnorm + wg * kTileCols;
  uint32_t* my_list =
      fix_list + static_cast<size_t>(blockIdx.x * kWgs + wg) * fix_cap;
  const int n2 = cout - n_sp;


  // The staged tile of output row pi, columns pj0.., image pn, to the two
  // NCHW planes: 16-byte stores of 8 pixels where the row allows them.
  auto copy_out = [&](int pn, int pi, int pj0) {
    const bool vec = (w2 & 7) == 0 && pj0 + kTileCols <= w2;
    for (int q = t; q < kN * 8; q += 128) {
      const int ch = q >> 3, part = q & 7;
      if (ch >= cout) break;
      Tout* dst = (ch < n_sp
          ? out1 + (static_cast<size_t>(pn) * n_sp + ch) * plane
          : out2 + (static_cast<size_t>(pn) * n2 + ch - n_sp) * plane) +
          static_cast<size_t>(pi) * w2 + pj0 + 8 * part;
      const unsigned char* src = my_out + ch * kOutRow + 16 * part;
      if (vec) {
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8 && pj0 + 8 * part + e < w2; ++e)
          dst[e] = reinterpret_cast<const Tout*>(src)[e];
      }
    }
  };
  int pend_n = 0, pend_i = 0, pend_j0 = 0;
  bool pending = false;

  for (int u = u0; u < u1; ++u) {
    const int i = u % h2;
    const int tile = (u / h2) % tiles;
    const int n = u / (h2 * tiles);
    const int j0 = tile * kTileCols;
    if (u == u0 || i == 0) {  // a new run of rows: refill the ring
      cp_async_wait_all();
      wg_barrier(wg);
      for (int d = -2; d < 2; ++d)
        stage_row(my_ring + ring_slot(i + d) * kStageBytes, x, n, i + d, j0,
                  h2, w2, cx, s2d, t);
      cp_async_commit();
    }
    cp_async_wait_all();
    wg_barrier(wg);  // rows i-2 .. i+1 staged; row i-1's readers are done
    stage_row(my_ring + ring_slot(i + 2) * kStageBytes, x, n, i + 2, j0, h2,
              w2, cx, s2d, t);  // the next row's new s2d row, in flight
    cp_async_commit();

    if constexpr (kStaged) {
      // each pixel's window norm ||x|| for the rounding check (two threads
      // a pixel, two s2d rows each; the 8x8 window's extra row and column
      // only widen the bound)
      const int p = t >> 1;
      float ss = 0.f;
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        const __nv_bfloat162* row = reinterpret_cast<const __nv_bfloat162*>(
            my_ring + ring_slot(i - 2 + 2 * (t & 1) + d) * kStageBytes) +
            6 * p;
#pragma unroll 4
        for (int e = 0; e < 24; ++e) {
          const float2 v = __bfloat1622float2(row[e]);
          ss = __fmaf_rn(v.x, v.x, __fmaf_rn(v.y, v.y, ss));
        }
      }
      ss += __shfl_xor_sync(0xffffffffu, ss, 1);
      if ((t & 1) == 0) my_xnorm[p] = sqrtf(ss);
    }

    // A: this warp's 16 pixels (16 warp + g, + 8) x 192 k, 12 k16 steps
    uint32_t af[12][4];
#pragma unroll
    for (int dy = 0; dy < 4; ++dy) {
      const uint32_t* row = reinterpret_cast<const uint32_t*>(
          my_ring + ring_slot(i - 2 + dy) * kStageBytes);
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const int e = 6 * (16 * warp + g) + 8 * s + t4;  // 32-bit words
        af[3 * dy + s][0] = row[e];
        af[3 * dy + s][1] = row[e + 48];  // pixel + 8: 96 bf16 further
        af[3 * dy + s][2] = row[e + 4];   // k + 8
        af[3 * dy + s][3] = row[e + 52];
      }
    }

    float acc64[kN64 > 0 ? kN64 : 1][32];
    float acc8[kN8 > 0 ? kN8 : 1][4];
#pragma unroll
    for (int c = 0; c < kN64; ++c) {
#pragma unroll
      for (int e = 0; e < 32; ++e) acc64[c][e] = 0.f;
      fence_regs(acc64[c]);
    }
#pragma unroll
    for (int c = 0; c < kN8; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc8[c][e] = 0.f;
      fence_regs(acc8[c]);
    }
    wgmma_fence();
    // lo, mid, then hi: the small terms' sums are rounded at their own
    // magnitude before the large one joins them
#pragma unroll
    for (int term = kTerms - 1; term >= 0; --term) {
#pragma unroll
      for (int ks = 0; ks < 12; ++ks) {
        const uint32_t kb =
            b_base + term * kTermBytes + 2 * ks * kNb * 128;
#pragma unroll
        for (int c = 0; c < kN64; ++c)
          wgmma_n64(acc64[c], af[ks], gmma_desc(kb + 8 * c * 128, kNb * 128,
                                                128));
#pragma unroll
        for (int c = 0; c < kN8; ++c)
          wgmma_n8(acc8[c], af[ks],
                   gmma_desc(kb + (8 * kN64 + c) * 128, kNb * 128, 128));
      }
    }
    wgmma_commit();
    if constexpr (kStaged) {
      // the last row's tile leaves while this row's wgmmas run
      if (pending) copy_out(pend_n, pend_i, pend_j0);
    }
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < kN64; ++c) fence_regs(acc64[c]);
#pragma unroll
    for (int c = 0; c < kN8; ++c) fence_regs(acc8[c]);

    // epilogue: fragment (row g + 8 hh, channel 8 jj + 2 t4 + e); bf16
    // into the staged tile (after every thread's copy-out of the last),
    // float32 straight to the planes
    if constexpr (kStaged) wg_barrier(wg);
    const int px = 16 * warp + g;
    // bf16: the fragments whose rounding the tensor cores' sum order could
    // change (bit 32 c + 4 jj + q, then the n8 slices')
    uint64_t recheck = 0;
    float xn[2] = {0.f, 0.f};
    if constexpr (kStaged) {
      xn[0] = my_xnorm[px];
      xn[1] = my_xnorm[px + 8];
    }
    auto emit = [&](float v, int ch, int hh, int bit) {
      const float z = __fadd_rn(__fmul_rn(v, sa[ch]), sb[ch]);
      const float y = fmaxf(z, 0.f);
      if constexpr (kStaged) {
        store(reinterpret_cast<Tout*>(my_out + ch * kOutRow) + px + 8 * hh,
              y);
        // the nearest bf16 rounding boundary (same binade), or zero
        const float mid = __uint_as_float(
            (__float_as_uint(y) & 0xFFFF0000u) | 0x8000u);
        const float tol = tol_ch[ch] * xn[hh];
        if (z <= 0.f ? -z <= tol : fabsf(y - mid) <= tol)
          recheck |= uint64_t{1} << bit;
      } else {
        const int j = j0 + px + 8 * hh;
        if (ch >= cout || j >= w2) return;
        Tout* dst = ch < n_sp
            ? out1 + (static_cast<size_t>(n) * n_sp + ch) * plane
            : out2 + (static_cast<size_t>(n) * n2 + ch - n_sp) * plane;
        store(dst + static_cast<size_t>(i) * w2 + j, y);
      }
    };
#pragma unroll
    for (int c = 0; c < kN64; ++c)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          emit(acc64[c][4 * jj + q], 64 * c + 8 * jj + 2 * t4 + (q & 1),
               q >> 1, 32 * c + 4 * jj + q);
#pragma unroll
    for (int c = 0; c < kN8; ++c)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        emit(acc8[c][q], 64 * kN64 + 8 * c + 2 * t4 + (q & 1), q >> 1,
             32 * kN64 + 4 * c + q);
    if constexpr (kStaged) {
      // the ambiguous roundings go to the warpgroup's list, recomputed in
      // the reference order by stem_fix_kernel; past the list's room
      // (1/16 of the outputs, ~9x the served stems' share) an output keeps
      // the tensor-core value, which is within one bf16 ulp of it
      while (recheck) {
        const int bit = __ffsll(static_cast<long long>(recheck)) - 1;
        recheck &= recheck - 1;
        const int q = bit & 3, jj = (bit >> 2) & 7;
        const int slice = bit < 32 * kN64
            ? 64 * (bit >> 5) + 8 * jj                   // an n64 slice
            : 64 * kN64 + 8 * ((bit >> 2) - 8 * kN64);   // an n8 slice
        const int ch = slice + 2 * t4 + (q & 1);
        const int pp = px + 8 * (q >> 1);
        if (ch >= cout || j0 + pp >= w2) continue;
        const int slot = atomicAdd(fix_cnt + wg, 1);
        if (slot < fix_cap)
          my_list[slot] = (static_cast<uint32_t>(u - u0) << 13) |
                          (static_cast<uint32_t>(ch) << 6) | pp;
      }
    }
    pending = true;
    pend_n = n;
    pend_i = i;
    pend_j0 = j0;
  }
  if constexpr (kStaged) {
    wg_barrier(wg);  // the last tile is staged
    if (pending) copy_out(pend_n, pend_i, pend_j0);
    // the list's length, for stem_fix_kernel (after every append of the
    // warpgroup: they precede its last barrier)
    if (t == 0) fix_counts[blockIdx.x * kWgs + wg] = min(fix_cnt[wg], fix_cap);
  }
  cp_async_wait_all();  // no copy outlives the block
}

// The listed roundings of kFixLists warpgroups' rows (block b: lists
// b kFixLists ..), each
// recomputed in the reference order over the value the tensor-core kernel
// stored: acc = fma(x, w, acc) over (u, v, c) of the 7x7x3 window, zeros
// outside the image, then relu(acc * a + b) -- the plain version's conv
// (cuDNN's and the CPU's give the same bits) and the CUDA-core route's
// sum.  A thread an output; the block stages the float32 weights in shared
// memory ([tap][cout]), and a thread loads its output's whole s2d window
// (4 rows of 4 pixels x 12 channels, 8 bytes a load) before the chain, so
// the chain waits for memory once.  Image row 2i-3+u is s2d row i-2+dy
// (dy = (u+1)/2, parity (u+1)%2), column 2j-3+v is s2d column j-2+dx.
template <typename Tout>
__global__ void __launch_bounds__(kFixThreads)
stem_fix_kernel(const uint16_t* __restrict__ x, int h, int w, int cx,
                int s2d, const float* __restrict__ wt,
                const float* __restrict__ a, const float* __restrict__ b,
                int cout, int n_sp, Tout* __restrict__ out1,
                Tout* __restrict__ out2, int rows_per_wg,
                const uint32_t* __restrict__ fix_list,
                const int* __restrict__ fix_counts, int fix_cap,
                int* __restrict__ n_rechecked) {
  extern __shared__ float w_s[];  // [147][cout]
  int count = 0;
#pragma unroll
  for (int l = 0; l < kFixLists; ++l)
    count += fix_counts[blockIdx.x * kFixLists + l];
  if (count == 0) return;
  if (n_rechecked && threadIdx.x == 0) atomicAdd(n_rechecked, count);
  for (int k = threadIdx.x; k < 147 * cout; k += blockDim.x)
    w_s[k] = __ldg(wt + k);
  __syncthreads();
  const int h2 = h >> 1, w2 = w >> 1;
  const int tiles = (w2 + kTileCols - 1) / kTileCols;
  const size_t plane = static_cast<size_t>(h2) * w2;
  const int n2 = cout - n_sp;
  for (int k = threadIdx.x; k < count; k += blockDim.x) {
    int list = blockIdx.x * kFixLists, slot = k;
#pragma unroll
    for (int l = 0; l + 1 < kFixLists; ++l)
      if (slot >= fix_counts[list]) slot -= fix_counts[list++];
    const uint32_t code = fix_list[static_cast<size_t>(list) * fix_cap + slot];
    const int u0 = list * rows_per_wg + static_cast<int>(code >> 13);
    const int ch = (code >> 6) & 127;
    const int i = u0 % h2, n = u0 / (h2 * tiles);
    const int j = ((u0 / h2) % tiles) * kTileCols + (code & 63);
    float acc = 0.f;
    if (s2d) {
      uint2 win[4][12];  // [dy][8-byte word of 4 pixels x 12 channels]
#pragma unroll
      for (int dy = 0; dy < 4; ++dy) {
        const int sr = i - 2 + dy;
        const int sr_in = sr >= 0 && sr < h2 ? sr : 0;
        const uint2* row = reinterpret_cast<const uint2*>(
            x + ((static_cast<size_t>(n) * h2 + sr_in) * w2 + (j - 2)) * 12);
#pragma unroll
        for (int q = 0; q < 12; ++q) {
          const int sc = j - 2 + q / 3;
          win[dy][q] = sr >= 0 && sr < h2 && sc >= 0 && sc < w2
              ? __ldg(row + q) : make_uint2(0u, 0u);
        }
      }
#pragma unroll
      for (int u = 0; u < 7; ++u)
#pragma unroll
        for (int v = 0; v < 7; ++v)
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const int dy = (u + 1) >> 1, dx = (v + 1) >> 1;
            const int e =
                12 * dx + (2 * ((u + 1) & 1) + ((v + 1) & 1)) * 3 + c;
            const uint32_t word =
                (e & 2) ? win[dy][e >> 2].y : win[dy][e >> 2].x;
            const float xv = __uint_as_float((e & 1) ? word & 0xFFFF0000u
                                                     : word << 16);
            acc = __fmaf_rn(xv, w_s[((u * 7 + v) * 3 + c) * cout + ch], acc);
          }
    } else {
      for (int u = 0; u < 7; ++u) {
        const int r = 2 * i - 3 + u;
#pragma unroll
        for (int v = 0; v < 7; ++v) {
          const int col = 2 * j - 3 + v;
          const bool in = r >= 0 && r < h && col >= 0 && col < w;
          const size_t base =
              ((static_cast<size_t>(n) * h + r) * w + col) * cx;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float xv = in ? __uint_as_float(static_cast<uint32_t>(
                                      __ldg(x + base + c)) << 16)
                                : 0.f;
            acc = __fmaf_rn(xv, w_s[((u * 7 + v) * 3 + c) * cout + ch], acc);
          }
        }
      }
    }
    Tout* dst = ch < n_sp
        ? out1 + (static_cast<size_t>(n) * n_sp + ch) * plane
        : out2 + (static_cast<size_t>(n) * n2 + ch - n_sp) * plane;
    store(dst + static_cast<size_t>(i) * w2 + j,
          fmaxf(__fadd_rn(__fmul_rn(acc, __ldg(a + ch)), __ldg(b + ch)),
                0.f));
  }
}

template <typename Tout>
constexpr bool kBf16 = std::is_same<Tout, __nv_bfloat16>::value;

template <int kN, typename Tout>
cudaError_t tc_opt_in() {
  return cudaFuncSetAttribute(
      reinterpret_cast<const void*>(stem_conv_wgmma_kernel<kN, Tout>),
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(tc_smem_bytes(kN, kBf16<Tout>)));
}

// A launch's work split: rows a warpgroup, blocks (about one a SM), and
// the room of each warpgroup's list of roundings to recheck (1/16 of its
// outputs; ~0.7 % of the served stems' outputs are listed), after which
// its lengths (one int a warpgroup) are kept.
struct TcPlan {
  int per_wg, blocks, fix_cap;
};

inline TcPlan tc_plan(int batch, int h, int w, int n_pack) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int h2 = h / 2, w2 = w / 2;
  const long total = static_cast<long>(batch) *
                     ((w2 + kTileCols - 1) / kTileCols) * h2;
  const long slots = static_cast<long>(kWgs) * (sms > 0 ? sms : 1);
  TcPlan p;
  p.per_wg = static_cast<int>((total + slots - 1) / slots);
  const long wgs = (total + p.per_wg - 1) / p.per_wg;
  p.blocks = static_cast<int>((wgs + kWgs - 1) / kWgs);
  p.fix_cap = static_cast<int>(
      (static_cast<long>(p.per_wg) * kTileCols * n_pack + 15) / 16);
  return p;
}

template <int kN, typename Tout>
int tc_launch(const void* x, int batch, int h, int w, int cx, int s2d,
              const void* pack, const void* wt, const void* a, const void* b,
              int cout, int n_sp, void* out1, void* out2, void* fix_list,
              void* n_rechecked, cudaStream_t stream) {
  const TcPlan p = tc_plan(batch, h, w, kN);
  uint32_t* list = static_cast<uint32_t*>(fix_list);
  int* counts = reinterpret_cast<int*>(
      list + static_cast<size_t>(p.blocks) * kWgs * p.fix_cap);
  stem_conv_wgmma_kernel<kN, Tout>
      <<<p.blocks, kTcThreads, tc_smem_bytes(kN, kBf16<Tout>), stream>>>(
          static_cast<const uint16_t*>(x), batch, h, w, cx, s2d,
          static_cast<const uint4*>(pack), static_cast<const float*>(wt),
          static_cast<const float*>(a), static_cast<const float*>(b), cout,
          n_sp, static_cast<Tout*>(out1), static_cast<Tout*>(out2), p.per_wg,
          list, counts, p.fix_cap);
  if constexpr (kBf16<Tout>) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    stem_fix_kernel<Tout><<<p.blocks * kWgs / kFixLists, kFixThreads,
                            147 * cout * sizeof(float), stream>>>(
        static_cast<const uint16_t*>(x), h, w, cx, s2d,
        static_cast<const float*>(wt), static_cast<const float*>(a),
        static_cast<const float*>(b), cout, n_sp, static_cast<Tout*>(out1),
        static_cast<Tout*>(out2), p.per_wg, list, counts, p.fix_cap,
        static_cast<int*>(n_rechecked));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename Tout>
int tc_dispatch(int n_pack, const void* x, int batch, int h, int w, int cx,
                int s2d, const void* pack, const void* wt, const void* a,
                const void* b, int cout, int n_sp, void* out1, void* out2,
                void* fix_list, void* n_rechecked, cudaStream_t stream) {
  switch (n_pack) {
    case 64:
      return tc_launch<64, Tout>(x, batch, h, w, cx, s2d, pack, wt, a, b,
                                 cout, n_sp, out1, out2, fix_list, n_rechecked,
                                 stream);
    case 72:
      return tc_launch<72, Tout>(x, batch, h, w, cx, s2d, pack, wt, a, b,
                                 cout, n_sp, out1, out2, fix_list, n_rechecked,
                                 stream);
    case 128:
      return tc_launch<128, Tout>(x, batch, h, w, cx, s2d, pack, wt, a, b,
                                  cout, n_sp, out1, out2, fix_list,
                                  n_rechecked, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ===================== CUDA-core route (float32 image) ==================

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

template <typename Tout>
__global__ void __launch_bounds__(kWarpPix * kMaxCout / kGroup)
stem_conv_kernel(const float* __restrict__ x, int h, int w, int cx, int s2d,
                 const float* __restrict__ wt, const float* __restrict__ a,
                 const float* __restrict__ b, int cout, int n_sp,
                 Tout* __restrict__ out1, Tout* __restrict__ out2) {
  extern __shared__ __align__(16) float smem_f[];
  const int cpad = cout_pad(cout);
  float* s_w = smem_f;                   // [tap = (u * 7 + v) * 3 + c][cpad]
  float* s_in = smem_f + kTaps * cpad;   // [u][c][column parity][kHalf]
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
  const float* img = x + static_cast<size_t>(n) * h * w * cx;
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
        v = img[idx];
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

template <typename Tout>
cudaError_t opt_in() {
  return cudaFuncSetAttribute(
      reinterpret_cast<const void*>(stem_conv_kernel<Tout>),
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(kMaxCout)));
}

template <typename Tout>
void launch(const void* x, int batch, int h, int w, int cx, int s2d,
            const void* wt, const void* a, const void* b, int cout, int n_sp,
            void* out1, void* out2, cudaStream_t stream) {
  const int ho = h / 2, wo = w / 2;
  dim3 grid((wo + kTile - 1) / kTile, (ho + kRows - 1) / kRows, batch);
  const int threads = kWarpPix * (cout_pad(cout) / kGroup);
  stem_conv_kernel<Tout><<<grid, threads, smem_bytes(cout), stream>>>(
      static_cast<const float*>(x), h, w, cx, s2d,
      static_cast<const float*>(wt), static_cast<const float*>(a),
      static_cast<const float*>(b), cout, n_sp, static_cast<Tout*>(out1),
      static_cast<Tout*>(out2));
}

}  // namespace

extern "C" {

// Opt every instantiation in to its shared memory on the current device;
// returns the first CUDA error.
int tsg_init() {
  cudaError_t e[9] = {opt_in<float>(), opt_in<__nv_bfloat16>(),
                      cudaFuncSetAttribute(
                          reinterpret_cast<const void*>(
                              stem_fix_kernel<__nv_bfloat16>),
                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                          147 * kMaxCout * static_cast<int>(sizeof(float))),
                      tc_opt_in<64, float>(), tc_opt_in<64, __nv_bfloat16>(),
                      tc_opt_in<72, float>(), tc_opt_in<72, __nv_bfloat16>(),
                      tc_opt_in<128, float>(),
                      tc_opt_in<128, __nv_bfloat16>()};
  for (cudaError_t err : e)
    if (err != cudaSuccess) return static_cast<int>(err);
  return 0;
}

// The ints of the list a bf16-out tensor-core launch needs (fix_list).
long long tsg_stem_tc_fix_ints(int batch, int h, int w, int n_pack) {
  const TcPlan p = tc_plan(batch, h, w, n_pack);
  return static_cast<long long>(p.blocks) * kWgs * (p.fix_cap + 1);
}

// Shared memory of a tensor-core launch at packed width n_pack (bf16 out:
// the larger).
long long tsg_stem_tc_smem_bytes(int n_pack) {
  return static_cast<long long>(tc_smem_bytes(n_pack, true));
}

// The float32 image on the CUDA cores.  x: (batch, h, w, cx) NHWC image,
// or with s2d the (batch, h/2, w/2, 12) space-to-depth tensor (cx = 3),
// float32.  wt (7, 7, 3, cout) float32 HWIO, a and b (cout,) float32.  out1
// (batch, n_sp, h/2, w/2) and out2 (batch, cout - n_sp, h/2, w/2), float32
// or bf16 (out_bf16).  h and w even, 1 <= cout <= 128, 0 <= n_sp <= cout.
// On the caller's stream; returns cudaGetLastError().
int tsg_stem_conv_f32(const void* x, int batch, int h, int w, int cx, int s2d,
                      const void* wt, const void* a, const void* b, int cout,
                      int n_sp, void* out1, void* out2, int out_bf16,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    launch<__nv_bfloat16>(x, batch, h, w, cx, s2d, wt, a, b, cout, n_sp,
                          out1, out2, s);
  else
    launch<float>(x, batch, h, w, cx, s2d, wt, a, b, cout, n_sp, out1, out2,
                  s);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 image on the tensor cores.  x as above in bf16; pack the three
// bf16 weight terms (3, 24, n_pack / 8, 8, 8) of pack_stem_weights, n_pack
// in {64, 72, 128} and >= cout; wt the float32 weights (the rounding
// check's reference order); a, b, out1, out2 as above.  x 8-byte aligned.
// fix_list: with bf16 out, scratch of tsg_stem_tc_fix_ints ints.
// n_rechecked: null, or an int that counts the bf16 outputs recomputed in
// the reference order.  On the caller's stream; returns
// cudaGetLastError().
int tsg_stem_conv_bf16(const void* x, int batch, int h, int w, int cx,
                       int s2d, const void* pack, int n_pack, const void* wt,
                       const void* a, const void* b, int cout, int n_sp,
                       void* out1, void* out2, int out_bf16, void* fix_list,
                       void* n_rechecked, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cout > n_pack) return static_cast<int>(cudaErrorInvalidValue);
  return out_bf16
      ? tc_dispatch<__nv_bfloat16>(n_pack, x, batch, h, w, cx, s2d, pack, wt,
                                   a, b, cout, n_sp, out1, out2, fix_list,
                                   n_rechecked, s)
      : tc_dispatch<float>(n_pack, x, batch, h, w, cx, s2d, pack, wt, a, b,
                           cout, n_sp, out1, out2, fix_list, n_rechecked, s);
}

}  // extern "C"
