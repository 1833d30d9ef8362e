// Hand-written Hopper (sm_90a) kernels for the int8-through serving graphs
// (BiSeNet-R18 and the dilated Bottleneck body of PSPNet).  Python side:
// torchseg_tpu_torch/ops/kernels/int8_serve_kernels.py (wrappers, shape
// checks, plain PyTorch versions).
//
// Six kernels behind fourteen wrappers: thirteen of the int8-through
// serving graphs and the post-training int8 conv:
//
//   stem_pool_i8_mma_kernel  (K1)  replaces the TPU kernel
//       torchseg_tpu/ops/pallas/int8_serve_kernels.py:384
//       s2d_stem_pool_quad_i8 (and the v1/v2 stems at :128 and :214):
//       the s2d 4x4 stem conv on bf16 tensor cores (mma.sync m16n8k16),
//       its requant, and the backbone half's 3x3/2 max pool.
//   conv_i8_mma_kernel             the streaming int8 tensor-core conv
//       (mma.sync m16n8k32, weights staged chunk by chunk; 3x3, dilated
//       3x3 or 1x1 window), launched by
//       K4 down_stage_i8  replacing down_stage_i8_from_paired (:986),
//                         stages 2 and 3: four launches (the 1x1/2
//                         projection fused into the first block's conv2
//                         as a second GEMM);
//       K5 down_block_i8  replacing down_block_i8_from_paired (:1136),
//                         stage 4's strided block: K4's first two
//                         launches, each tile's K walk split over a
//                         two-block cluster (128 output tiles on 132 SMs;
//                         the projection's chunks all on the first block);
//       K6 res_block_i8   replacing res_block_i8_std (:1226), stage 4's
//                         stride-1 block: two launches, K split as K5's;
//       K3 l1_stage_i8    (below) at widths whose weights do not fit
//                         conv_i8_mma_res_kernel;
//       cbr_i8            one CBR (any k in {1, 3}, stride, dilation;
//                         codes or float32 out): the R18 decoder's six
//                         convs and the spatial path's 1x1 (sp3), the
//                         deep stem's stem2/stem3 (XLA convs in JAX,
//                         deploy/int8_serve.py:940, :1038, :756);
//       bottleneck_i8     a dilated Bottleneck, three launches: 1x1, 3x3
//                         with stride and dilation, 1x1 with the residual
//                         or the 1x1/s projection in its epilogue (XLA
//                         in JAX, deploy/int8_serve.py:716 _apply_bottleneck);
//                         the last block of the body writes float32;
//       conv_i8_affine    the generic post-training int8 conv
//                         (deploy/quantize.py; an XLA conv in JAX,
//                         deploy/quantize.py:100-146): mode 3, the float
//                         input quantized into each tile's footprint as
//                         the kernel stages it, float32 out with no ReLU,
//                         above 64 input channels;
//       xblock_i8         a projection block's sep3: its 1x1 with the
//                         separable projection's 1x1 as the second GEMM
//                         (mode 4; XLA in JAX, deploy/int8_serve.py:986
//                         _apply_xblock), after K14.
//   dwconv3x3_i8_kernel  (K14) the int8 3x3 depthwise conv and requant of
//       the Xception39 body's projection blocks' sep3 and projection (an
//       XLA conv in JAX, deploy/int8_serve.py:961 _qconv_dw): 6 launches
//       an X39 forward.
//   conv_i8_mma_res_kernel         the int8 tensor-core conv with the
//       link's whole weight resident in shared memory, persistent blocks
//       (stride 1 or 2; the same windows and outputs); launched by
//       K3 l1_stage_i8    replacing l1_stage_i8_paired_view (:763),
//                         stage 1: a chain of four launches (and K6 at
//                         widths up to 64);
//       K2 conv3x3s2_i8   replacing conv3x3s2_i8_quad (:515), twice per
//                         forward through spatial_path_i8 (:569/:587),
//                         at stride 2;
//       cbr_i8, bottleneck_i8  their convs of up to 64 input channels
//                         (sp3, stem2/stem3, layer1's);
//       conv_i8_affine    up to 64 input channels (mode 3, as above);
//       sep_fused_i8      the separable window: the Xception39 body's
//                         separable convs (XLA in JAX, deploy/int8_serve.py:
//                         961-996), K14's depthwise codes computed in the
//                         1x1's A producer: sep1 and sep2 (sep_i8) in mode
//                         0, an identity block's sep3 (xblock_i8) in mode
//                         1; 45 launches an X39 forward.
//   maxpool_i8_vec16_kernel, maxpool_i8_kernel  (K10) replace
//       maxpool2d_3x3s2_i8 (:1308), the standalone 3x3/2 pad-1 max pool
//       after the deep stem: 16-byte loads and a strip of output rows a
//       thread where C % 16 == 0 and the tensors are 16-byte aligned, else
//       4-byte loads.
//
// Numerics (the spec is the JAX XLA path, deploy/int8_serve.py:716-958 and
// :1274-1295, as XLA compiles it on the CPU where the tests run it):
//   * int8 x int8 products accumulate exactly in int32 on the int8 tensor
//     cores: integer sums are exact in any order, so the convs are
//     bit-exact;
//   * the stem's int8 codes are exact in bf16 and its weights are bf16, so
//     the bf16 tensor cores form every product exactly and accumulate in
//     f32; the order and rounding of that sum differ from any other
//     implementation's, so round-half ties may move a code by one: the
//     promised tolerance is +-1 code (the JAX kernel's, :31-33);
//   * XLA contracts the epilogue's multiply-adds into fused multiply-adds.
//     Measured on its CPU output, bit for bit:
//         cbr:        z = fma(y, m, c)
//         identity:   z = fma(x, rr, fma(y, m, c))
//         projection: z = fma(yd, md, fma(y, m, c)) + cd
//     (the BasicBlock's conv2 and the Bottleneck's conv3 alike), so the
//     kernels write exactly these with __fmaf_rn and __fadd_rn, and the
//     library is built with -fmad=false so nvcc contracts nothing else;
//   * rintf rounds half to even, as jnp.round does;
//   * the pools only compare codes: they are exact for any code.
//
// Every launching entry point runs on the caller's stream, allocates
// nothing and returns cudaGetLastError(); tsg_init() runs once per device
// before them.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ int8_t requant(float z) {
  // clip(round(z), -127, 127); z >= 0 after a ReLU, either sign in K14
  float q = fmaxf(fminf(rintf(z), 127.f), -127.f);
  return static_cast<int8_t>(static_cast<int>(q));
}

// Two requantized codes as the little-endian 16-bit word of adjacent bytes.
__device__ __forceinline__ uint16_t pack2(int8_t lo, int8_t hi) {
  return static_cast<uint16_t>(static_cast<uint8_t>(lo) |
                               (static_cast<uint16_t>(static_cast<uint8_t>(hi)) << 8));
}

// Four codes as the little-endian word of adjacent bytes.
__device__ __forceinline__ uint32_t pack4(int8_t a, int8_t b, int8_t c, int8_t d) {
  return static_cast<uint32_t>(pack2(a, b)) | (static_cast<uint32_t>(pack2(c, d)) << 16);
}

// The post-training quantization of one float32 value: clip(rint(x / s),
// -127, 127) of the true quotient rounded to nearest, as XLA's (JAX
// deploy/quantize.py:119-122), half to even; inv = 1 / s rounded.  Its
// code is the low byte of the result.  Fast path, on full-rate operations
// only: r = x * inv clamped to [-127, 127] (NaN to 127, as requant's clip
// takes it) is within 1.5 * 2^-23 * 2^7 < 2^-14 of the clamped fl(x / s),
// so unless r lies within 2^-14 of a half-integer both round to the same
// integer; t = r + 1.5 * 2^23 rounds r to that integer k (half to even),
// and t's bits are 0x4B400000 + k, whose low byte is k's.  Near a
// half-integer the exact quotient decides (__fdiv_rn).
__device__ __forceinline__ uint32_t quant_bits(float x, float s, float inv) {
  constexpr float kMagic = 12582912.f;  // 1.5 * 2^23
  const float r = fmaxf(fminf(__fmul_rn(x, inv), 127.f), -127.f);
  float t = __fadd_rn(r, kMagic);
  if (fabsf(fabsf(__fadd_rn(r, -__fadd_rn(t, -kMagic))) - 0.5f) < 6.103515625e-05f)
    t = __fadd_rn(fmaxf(fminf(__fdiv_rn(x, s), 127.f), -127.f), kMagic);
  return __float_as_uint(t);
}

// Four values quantized (quant_bits) and packed into one word.
__device__ __forceinline__ uint32_t quant4(float a, float b, float c, float d, float s,
                                           float inv) {
  return __byte_perm(__byte_perm(quant_bits(a, s, inv), quant_bits(b, s, inv), 0x0040),
                     __byte_perm(quant_bits(c, s, inv), quant_bits(d, s, inv), 0x0040),
                     0x5410);
}

// Two bf16 values (a word) as float32, exactly.
__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// The footprint kernels (conv_i8_affine's mode 3 on either tensor-core
// conv, and the resident kernel's separable window) tile the output in 2-D,
// tr rows x kFpTC columns of one image, and stage the input that a tile's
// window reads, its footprint, in shared memory once a tile (and a
// 64-channel chunk): for a 3x3 window of dilation d at stride s, (tr - 1) s
// + 2d + 1 input rows x (kFpTC - 1) s + 2d + 1 columns from (oy0 s - d,
// ox0 s - d), the pad included as code 0; for a 1x1, the tr x kFpTC input
// pixels the tile samples.  Footprint pixel f (row-major), 16-byte group g
// (channels 16g .. 16g + 15 of the chunk) lies at fp_byte(f, g, s2): with
// one footprint pixel between neighbouring output pixels the group is
// XOR-swizzled by bits 1-2 of f; with two (s2: a 3x3 at stride 2) the
// pixels of odd pairs swap places and the group is swizzled by bits 2-3.
// So eight pixels f0 + k step (k = 0..7) at one group, as an ldmatrix or a
// producer's quarter warp reads them, fall in distinct banks, and so do two
// pixels a step apart at all four groups.
constexpr int kFpTC = 16;  // output columns of a footprint tile

__device__ __forceinline__ int fp_byte(int f, int g, bool s2) {
  return s2 ? (f ^ ((f >> 1) & 1)) * 64 + ((g ^ ((f >> 2) & 3)) << 4)
            : f * 64 + ((g ^ ((f >> 1) & 3)) << 4);
}

// The footprint of a tile of tr output rows: its rows and columns, the step
// between neighbouring output pixels in it, and the input pixel of its
// first element; the input row of footprint row r is iy0 + r * mul (mul =
// the stride for a 1x1, else 1), and likewise for columns.
struct Footprint {
  int rows, cols, step, mul;
};

__host__ __device__ __forceinline__ Footprint footprint_of(int tr, bool one, int stride,
                                                           int dil) {
  const int step = one ? 1 : stride, span = one ? 1 : 2 * dil + 1;
  return {(tr - 1) * step + span, (kFpTC - 1) * step + span, step, one ? stride : 1};
}

// Bytes of one footprint: 64 a pixel, one pixel more for the stride-2 swap.
__host__ __device__ __forceinline__ int footprint_bytes(int tr, bool one, int stride,
                                                        int dil) {
  const Footprint fp = footprint_of(tr, one, stride, dil);
  return (fp.rows * fp.cols + 1) * 64;
}

// Mode 3: channels c0 .. c0 + 63 of a tile's footprint, from the float32
// (kBf16: bf16) activation x (batch, h, w, cin) of image b, quantized into
// the footprint fp at smem: each element once, the 16-channel groups of
// kU items a thread loaded (16-byte loads) before any is converted, the
// pad and the channels past cin as code 0.  kThreads: the block's
// threads.
template <int kThreads, bool kBf16>
__device__ __forceinline__ void quantize_footprint_as(
    unsigned char* __restrict__ fp_s, const Footprint fp, const void* __restrict__ x, float s,
    int b, int h, int w, int cin, int c0, int iy0, int ix0) {
  constexpr int kU = kBf16 ? 4 : 2;       // items in flight
  constexpr int kLoads = kBf16 ? 2 : 4;   // 16-byte loads an item
  const float inv = __fdiv_rn(1.f, s);
  const bool s2 = fp.step == 2;
  const int n = fp.rows * fp.cols * 4;
  for (int i0 = threadIdx.x; i0 < n; i0 += kU * kThreads) {
    uint4 raw[kU][kLoads];
    bool ok[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kThreads, f = i >> 2, ch = c0 + 16 * (i & 3);
      const int r = f / fp.cols, iy = iy0 + r * fp.mul, ix = ix0 + (f - r * fp.cols) * fp.mul;
      ok[u] = i < n && ch < cin && iy >= 0 && iy < h && ix >= 0 && ix < w;
      const long long e = ((static_cast<long long>(b) * h + iy) * w + ix) * cin + ch;
      const uint4* src = reinterpret_cast<const uint4*>(
          static_cast<const unsigned char*>(x) + e * (kBf16 ? 2 : 4));
#pragma unroll
      for (int k = 0; k < kLoads; ++k)
        raw[u][k] = ok[u] ? __ldg(src + k) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kThreads;
      if (i >= n) break;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (ok[u]) {
        uint32_t q[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if constexpr (kBf16) {
            const uint4 r = raw[u][k / 2];
            const uint32_t a = k % 2 ? r.z : r.x, c = k % 2 ? r.w : r.y;
            q[k] = quant4(bf16_lo(a), bf16_hi(a), bf16_lo(c), bf16_hi(c), s, inv);
          } else {
            const uint4 r = raw[u][k];
            q[k] = quant4(__uint_as_float(r.x), __uint_as_float(r.y), __uint_as_float(r.z),
                          __uint_as_float(r.w), s, inv);
          }
        }
        v = make_uint4(q[0], q[1], q[2], q[3]);
      }
      *reinterpret_cast<uint4*>(fp_s + fp_byte(i >> 2, i & 3, s2)) = v;
    }
  }
}

template <int kThreads>
__device__ __forceinline__ void quantize_footprint(
    unsigned char* __restrict__ fp_s, const Footprint fp, const void* __restrict__ x,
    int x_bf16, float s, int b, int h, int w, int cin, int c0, int iy0, int ix0) {
  if (x_bf16)
    quantize_footprint_as<kThreads, true>(fp_s, fp, x, s, b, h, w, cin, c0, iy0, ix0);
  else
    quantize_footprint_as<kThreads, false>(fp_s, fp, x, s, b, h, w, cin, c0, iy0, ix0);
}

// --- PTX wrappers for the tensor-core kernels (K1-K6) ----------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; src_bytes = 0 zero-fills the
// destination and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// 8-byte asynchronous copy global -> shared (cached in L1 too); src_bytes
// = 0 zero-fills the destination and reads nothing.
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending));
}

// Four 8x8 matrices of 16-bit elements (8 rows of 16 bytes each); lane l
// gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0,
                                            uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}

// d += a (16x32 s8, row) * b (32x8 s8, col), exact in int32.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), accumulated in f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// K1: fused serving stem on bf16 tensor cores.
//
// What it computes: a 4x4 stride-1 valid conv over the pre-padded s2d int8
// image xs (h2+3, w2+3, cin) with bf16 weights (4, 4, cin, cout) and an f32
// accumulator, the requant epilogue q = clip(rint(max(fma(acc, m, c), 0))),
// then the split: channels [0, n_sp) are the SpatialPath codes sp (h2, w2,
// n_sp), channels [n_sp, cout) go through the backbone 3x3/2 pad-1 max pool
// into pooled (h2/2, w2/2, cout - n_sp).  The backbone half never reaches
// device memory at stem resolution.
//
// What bounds it on an H100: bf16 tensor-core operations, 2*h2*w2*cout*256
// with each tap's cin channels padded to 16 (34 G at 1024x2048, ~35 us at
// the 989 TFLOP/s dense peak), against ~48 MB of traffic (~14 us).  The
// CUDA-core kernel it replaced ran the same sum as scalar f32 FMAs fed from
// shared memory (~6 TFLOP/s, 4 ms).
//
// Design: one GEMM per stem row pair, M = stem pixels, N = cout, K = 16
// taps x 16 channels (12 channels and 4 zeros per tap, so one k16 step is
// one (dy, dx) tap and the A fragment of a tap is 16 pixels' 32-byte rows:
// an implicit im2col by per-lane ldmatrix addresses; keeping K = 192 would
// need fragments that straddle taps, for 25 % fewer MACs on a kernel far
// from its bound).  A block owns 63 pooled columns (128 stem columns: the
// pooled windows' left halo column is its first) and a band of pooled
// rows, and walks down it two stem rows at a time, so no stem row is
// computed twice except the one above the band:
//   * the weights are staged once per block as [n][k] bf16 (64 KB), their
//     16-byte chunks XOR-swizzled by n % 8 so ldmatrix is conflict-free;
//   * input rows live in a ring of 7 rows x 132 columns x 16 bf16, each
//     code converted once from int8 while it is staged (exact); the next
//     pair of rows is loaded into registers before the MMAs and stored
//     after them; each pixel's two 16-byte halves are swapped by bit 2 of
//     its column, which makes any 8 consecutive pixels conflict-free;
//   * 16 warps: 8 along M (two m16 tiles each: 16 pixels of one row) x 2
//     along N (the sp half and the backbone half, eight n8 tiles each);
//   * the epilogue writes sp codes and backbone codes to shared memory;
//     sp leaves with 16-byte stores, and the backbone codes of three stem
//     rows (a ring of 3; the row above is the previous pair's second) are
//     max-pooled with __vmaxs4 and leave with 16-byte stores.  Padding is
//     -128, which never wins: every code is >= 0 after the ReLU.
// The host sizes the bands so the grid is about one block per SM (the
// shared memory, ~134 KB, allows one).
// ---------------------------------------------------------------------------

constexpr int kStemThreads = 512;
constexpr int kStemCols = 128;             // stem columns a block computes
constexpr int kStemPC = kStemCols / 2 - 1;  // pooled columns a block owns
constexpr int kStemXW = kStemCols + 4;     // input columns staged (131 used)
constexpr int kStemRing = 7;               // input rows staged
constexpr int kStemN = 128;                // largest cout
constexpr int kStemRowBytes = 512;         // one weight row: 256 bf16 of K
constexpr int kStemPix = 32;               // one staged pixel: 16 bf16
constexpr int kStemLoads = (2 * kStemXW * 4 + kStemThreads - 1) / kStemThreads;

__device__ __forceinline__ int ring_slot(int row, int n) {
  return ((row % n) + n) % n;
}

__global__ void __launch_bounds__(kStemThreads, 1)
stem_pool_i8_mma_kernel(const int8_t* __restrict__ xs,
                        const uint16_t* __restrict__ wf,
                        const float* __restrict__ m, const float* __restrict__ c,
                        int8_t* __restrict__ sp, int8_t* __restrict__ pooled,
                        int h2, int w2, int cin, int cout, int n_sp,
                        int band) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nbb = cout - n_sp;
  unsigned char* w_s = smem;                                // [128][256] bf16
  unsigned char* x_s = w_s + kStemN * kStemRowBytes;        // [7][132][16] bf16
  int8_t* bb_s = reinterpret_cast<int8_t*>(x_s + kStemRing * kStemXW * kStemPix);
  int8_t* sp_s = bb_s + 3 * kStemCols * nbb;                // [2][128][n_sp]
  float* m_s = reinterpret_cast<float*>(sp_s + 2 * kStemCols * n_sp);
  float* c_s = m_s + kStemN;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pw = w2 / 2;
  const int a = blockIdx.x * kStemPC;   // first pooled column owned
  const int col0 = 2 * a - 1;           // stem (and xs) column of local column 0
  const int py0 = blockIdx.y * band;
  const int py1 = min(h2 / 2, py0 + band);
  const int hp = h2 + 3, wp = w2 + 3;
  const int ng = cin / 4;               // 4-channel words per input pixel

  // weights -> [n][k = tap * 16 + channel], zero beyond cin and cout
  for (int i = tid; i < kStemN * 256; i += kStemThreads) {
    const int n = i % kStemN, ch = (i / kStemN) % 16, tap = i / (kStemN * 16);
    uint16_t v = 0;
    if (n < cout && ch < cin) v = wf[(tap * cin + ch) * cout + n];
    const int chunk = (tap * 2 + ch / 8) ^ (n & 7);
    *reinterpret_cast<uint16_t*>(w_s + n * kStemRowBytes + chunk * 16 +
                                 (ch & 7) * 2) = v;
  }
  for (int i = tid; i < kStemN; i += kStemThreads) {
    m_s[i] = i < cout ? m[i] : 0.f;
    c_s[i] = i < cout ? c[i] : 0.f;
  }
  for (int i = tid; i < kStemRing * kStemXW * kStemPix / 16; i += kStemThreads)
    reinterpret_cast<uint4*>(x_s)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  // Input rows r, r+1 (columns col0 .. col0+131) as 4-channel words, into
  // registers; then into the ring as bf16.
  const int n_units = 2 * kStemXW * ng;
  uint32_t xv[kStemLoads];
  auto load_rows = [&](int r) {
#pragma unroll
    for (int q = 0; q < kStemLoads; ++q) {
      const int u = tid + q * kStemThreads;
      xv[q] = 0;
      if (u < n_units) {
        const int row = r + u / (kStemXW * ng);
        const int col = col0 + (u / ng) % kStemXW;
        if (row >= 0 && row < hp && col >= 0 && col < wp)
          xv[q] = __ldg(reinterpret_cast<const uint32_t*>(
              xs + (static_cast<size_t>(row) * wp + col) * cin + 4 * (u % ng)));
      }
    }
  };
  auto store_rows = [&](int r) {
#pragma unroll
    for (int q = 0; q < kStemLoads; ++q) {
      const int u = tid + q * kStemThreads;
      if (u < n_units) {
        const int row = r + u / (kStemXW * ng);
        const int lc = (u / ng) % kStemXW, grp = u % ng;
        uint32_t bits[4];
#pragma unroll
        for (int b = 0; b < 4; ++b)  // an int8 code is exact in bf16
          bits[b] = __float_as_uint(static_cast<float>(
                        static_cast<int8_t>(xv[q] >> (8 * b)))) >> 16;
        const int half = (grp >> 1) ^ ((lc >> 2) & 1);
        *reinterpret_cast<uint2*>(
            x_s + (ring_slot(row, kStemRing) * kStemXW + lc) * kStemPix +
            half * 16 + (grp & 1) * 8) =
            make_uint2(bits[0] | (bits[1] << 16), bits[2] | (bits[3] << 16));
      }
    }
  };

  // prologue: input rows 2*py0-2 .. 2*py0+3
  for (int r = 2 * py0 - 2; r < 2 * py0 + 4; r += 2) {
    load_rows(r);
    store_rows(r);
  }

  const int wm = warp & 7;    // M: tiles 2*wm, 2*wm+1 (tile t: row t/8, columns 16*(t%8)..)
  const int wn = warp >> 3;   // N: channels 64*wn ..
  const int g = lane >> 2, t4 = lane & 3;
  const uint32_t w_base = smem_addr(w_s);
  const uint32_t x_base = smem_addr(x_s);

  // step -1 computes the stem row above the band (its backbone codes only)
  for (int s = -1; py0 + s < py1; ++s) {
    const int ra = 2 * (py0 + s);   // this step's stem rows: ra, ra + 1
    const bool more = py0 + s + 1 < py1;
    __syncthreads();  // this step's input rows staged; last step's readers done
    if (more) load_rows(ra + 5);

    float acc[2][8][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    bool live[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      live[i] = wn * 64 < cout && col0 + ((2 * wm + i) & 7) * 16 < w2 &&
                (s >= 0 || 2 * wm + i >= 8);  // step -1 needs its second row only
    if (live[0] || live[1]) {
      // tile t = 2*wm + i lies in stem row ra + wm/4, columns 16*(t%8) ..
      const uint32_t lane_pc = (lane & 7) + ((lane >> 3) & 1) * 8;
      const int k_half = (lane >> 3) & 1;
      for (int dy = 0; dy < 4; ++dy) {
        const uint32_t xrow =
            x_base + ring_slot(ra + (wm >> 2) + dy, kStemRing) * kStemXW * kStemPix;
#pragma unroll
        for (int dx = 0; dx < 4; ++dx) {
          const int tap = dy * 4 + dx;
          uint32_t af[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int pc = ((2 * wm + i) & 7) * 16 + lane_pc + dx;
            const int half = (lane >> 4) ^ ((pc >> 2) & 1);
            ldmatrix_x4(xrow + pc * kStemPix + half * 16, af[i][0], af[i][1],
                        af[i][2], af[i][3]);
          }
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const int n = wn * 64 + p * 16 + (lane & 7) + (lane >> 4) * 8;
            const int chunk = (tap * 2 + k_half) ^ (lane & 7);  // n % 8 == lane % 8
            uint32_t b0, b1, b2, b3;
            ldmatrix_x4(w_base + n * kStemRowBytes + chunk * 16, b0, b1, b2, b3);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              if (!live[i]) continue;
              mma_bf16(acc[i][2 * p], af[i], b0, b1);
              mma_bf16(acc[i][2 * p + 1], af[i], b2, b3);
            }
          }
        }
      }
    }

    // epilogue: requant; sp codes and backbone codes to shared memory
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = 2 * wm + i;
      const int rsel = t >> 3, sr = ra + rsel;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int lc = (t & 7) * 16 + g + 8 * hh;
        const int sc = col0 + lc;
        const bool valid = sr >= 0 && sr < h2 && sc >= 0 && sc < w2;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = wn * 64 + j * 8 + 2 * t4;
          if (n >= cout) continue;
          const int8_t q0 = requant(fmaxf(
              __fmaf_rn(acc[i][j][2 * hh], m_s[n], c_s[n]), 0.f));
          const int8_t q1 = requant(fmaxf(
              __fmaf_rn(acc[i][j][2 * hh + 1], m_s[n + 1], c_s[n + 1]), 0.f));
          if (n < n_sp) {
            *reinterpret_cast<uint16_t*>(sp_s + (rsel * kStemCols + lc) * n_sp + n) =
                pack2(q0, q1);
          } else {
            *reinterpret_cast<uint16_t*>(
                bb_s + (ring_slot(sr, 3) * kStemCols + lc) * nbb + n - n_sp) =
                valid ? pack2(q0, q1) : uint16_t(0x8080);
          }
        }
      }
    }
    if (more) store_rows(ra + 5);
    __syncthreads();
    if (s < 0) continue;

    // sp rows ra, ra+1, owned columns (local 1..126): 16-byte stores
    const int spc = n_sp / 16;
    for (int u = tid; u < 2 * (kStemCols - 2) * spc; u += kStemThreads) {
      const int ck = u % spc, lc = 1 + (u / spc) % (kStemCols - 2);
      const int rsel = u / (spc * (kStemCols - 2));
      const int sc = col0 + lc;
      if (sc >= w2) continue;
      *reinterpret_cast<uint4*>(sp + (static_cast<size_t>(ra + rsel) * w2 + sc) * n_sp +
                                ck * 16) =
          *reinterpret_cast<const uint4*>(sp_s + (rsel * kStemCols + lc) * n_sp + ck * 16);
    }
    // pooled row py0+s: the max over stem rows ra-1 .. ra+1
    const int bbc = nbb / 16;
    for (int u = tid; u < kStemPC * bbc; u += kStemThreads) {
      const int ck = u % bbc, i = u / bbc;
      const int px = a + i;
      if (px >= pw) continue;
      uint4 mx = make_uint4(0x80808080u, 0x80808080u, 0x80808080u, 0x80808080u);
#pragma unroll
      for (int r = -1; r < 2; ++r) {
        const int8_t* row = bb_s + ring_slot(ra + r, 3) * kStemCols * nbb;
#pragma unroll
        for (int dc = 0; dc < 3; ++dc) {
          const uint4 v = *reinterpret_cast<const uint4*>(row + (2 * i + dc) * nbb + ck * 16);
          mx.x = __vmaxs4(mx.x, v.x);
          mx.y = __vmaxs4(mx.y, v.y);
          mx.z = __vmaxs4(mx.z, v.z);
          mx.w = __vmaxs4(mx.w, v.w);
        }
      }
      *reinterpret_cast<uint4*>(pooled + (static_cast<size_t>(py0 + s) * pw + px) * nbb +
                                ck * 16) = mx;
    }
  }
}

size_t stem_smem_bytes(int cout, int n_sp) {
  return static_cast<size_t>(kStemN) * kStemRowBytes +
         static_cast<size_t>(kStemRing) * kStemXW * kStemPix +
         static_cast<size_t>(kStemCols) * (3 * (cout - n_sp) + 2 * n_sp) +
         2 * 4 * kStemN;
}

// ---------------------------------------------------------------------------
// The streaming int8 tensor-core conv + epilogue, the weights streamed chunk
// by chunk: K4's, K5's and K6's links, and the 3x3 and 1x1 convs of cbr_i8
// (the R18 decoder, sp3) and bottleneck_i8 (PSPNet's body) above 64 input
// channels.
//
// What it computes: y = conv(x, w) over NHWC int8 codes x (h, w, cin) and
// HWIO int8 weights (k, k, cin, cout), exact in int32, for one of three
// windows (kWin): 3x3 pad 1 (kWin3, K2-K6's), 3x3 with dilation d and pad
// d (kWinDil), or 1x1 pad 0 (kWin1), at any stride; then one of four
// epilogues, the first three ending in ReLU and either the requant to
// int8 codes or (kF32) the float32 value itself:
//   mode 0 (CBR):        z = fma(y, m, c)
//   mode 1 (identity):   z = fma(res, rr, fma(y, m, c)), res (ho, wo, cout)
//   mode 2 (projection): z = fma(yd, md, fma(y, m, c)) + cd, with
//        yd = 1x1/sd conv of the block input xd (hd, wd, cdin) by wd,
//        a second GEMM into its own int32 accumulators;
//   mode 3 (affine):     z = fma(y, m, c), no ReLU, float32 out only: the
//        post-training int8 conv of deploy/quantize.py, m = s_in * s_w
//        and c = the conv's bias (or 0); its x is the float32 (or bf16)
//        activation (batch, h, w, cin), quantized by the kernel as it
//        stages it (below);
//   mode 4 (separable projection): z = fma(y, m, c) + fma(yd, md, cd),
//        yd as in mode 2: the Xception block's sep3 pointwise with its
//        separable projection's pointwise (xd the projection's depthwise
//        codes, sd = 1) as the second GEMM, the two affines summed as XLA
//        contracts JAX's _apply_xblock (deploy/int8_serve.py:986).
// XLA contracts exactly these multiply-adds on the CPU, so the chain is
// written with __fmaf_rn/__fadd_rn under -fmad=false.
//
// What bounds it on an H100: int8 tensor-core operations (34.4 G for a
// whole stage-2 or stage-3 down stage, ~17 us at the 1,979 TOP/s dense
// peak) against 13 MB (stage 2) or 8 MB (stage 3) of traffic (~4 us).
// The __dp4a CUDA-core kernel it replaced ran at ~22-35 TOP/s.
//
// Design: an implicit GEMM, M = output pixels (flattened, so a tile may
// cross rows and the ragged edge is masked per pixel), N = cout, K = taps
// x cin (+ cdin for the projection).  A block owns kMmaBM = 128 pixels x
// kMmaBN = 64 channels and walks K in 64-byte chunks, each inside one tap
// (cin % 16 == 0; a chunk's channels past cin are zero-filled), tap by tap
// without divisions (each A row keeps its window offset and a mask of the
// taps inside the image; the window is a template parameter, so the 3x3
// pad-1 instantiations that K2-K6 launch are compiled as before: their
// dilation is the constant 1):
//   * A tiles are gathered from x with 16-byte cp.async copies, zero-filled
//     at the pad and past the edge (src-size 0), in a ring of kMmaStages;
//   * B tiles are the HWIO weights, read as 4-channel x 4-k words into
//     registers kMmaStages - 1 chunks ahead, transposed with byte permutes
//     and stored K-major ([n][k]) as mma's col operand wants one chunk
//     later, so the package's weights stay as they are;
//   * both tiles' 16-byte chunks are XOR-swizzled by row bits, which makes
//     every ldmatrix conflict-free (mma_chunk_addr);
//   * 8 warps (4 along M x 2 along N), each 32 pixels x 32 channels: per
//     32-byte k step two A and two B ldmatrix.x4 feed 8 mma.sync.m16n8k32;
//   * the epilogue writes codes to shared memory (over the ring), and they
//     leave with 16-byte stores (8-byte where cout % 16 == 8); float32
//     values (kF32) are staged the same way, 128 x 64 floats in rows
//     padded by 32 bytes (36,864 bytes of the 49,152-byte ring: a
//     half-warp's 8-byte stores hit 32 distinct banks), and leave with
//     16-byte stores.
// Integer sums are exact in any order, so the kernel is bit-exact against
// the plain version.  At stage 3 (8,192 pixels x 256
// channels) the grid is 256 blocks: one wave at two blocks an SM.  Tuned
// with scripts/torch_int8_kernel_variants.py on an H100: 64 x 64 tiles of
// 4 warps were 20-45 % slower a link, 3 or 5 stages within 3 %, and 128 x
// 32 tiles 6-14 % slower.
//
// K6 (stage 4's identity block, 2,048 pixels x 512 channels, K = 4,608 in
// 72 chunks) gives this tiling 16 x 8 = 128 tiles on 132 SMs: one block an
// SM, below one wave, each with the longest K walk of the path and nothing
// beside it to hide its latency.  With kSplit = 2 the K walk of a tile is
// split over a thread-block cluster of two blocks (256 blocks, 36 chunks
// each): the second block leaves its int32 sums in its shared memory, the
// first adds them through distributed shared memory and runs the epilogue.
// K5 (stage 4's strided block) has the same 128 tiles in both links; its
// conv2 adds the projection's 4 chunks (cdin = 256) to the 72 of the main
// walk.  Only one set of sums fits a block's ring (32 KB of 48), so in a
// split the first block takes every projection chunk into its own second
// accumulator set and correspondingly fewer main chunks (34 + 4 against
// the second block's 38), and only main sums cross between the blocks.
// Integer sums are exact in any order, so the split stays bit-exact.  The
// host splits a launch (any mode) when its tiles do not outnumber the SMs;
// K4's launches on the serving path have 256 or more tiles and stay whole.
// ---------------------------------------------------------------------------

constexpr int kMmaWM = 4;         // warps along M (32 pixels each)
constexpr int kMmaWN = 2;         // warps along N (32 channels each)
constexpr int kMmaStages = 4;     // cp.async ring depth (>= 3)
constexpr int kMmaBM = 32 * kMmaWM;                 // output pixels per block
constexpr int kMmaBN = 32 * kMmaWN;                 // output channels per block
constexpr int kMmaBK = 64;                          // bytes of K per stage
constexpr int kMmaThreads = 32 * kMmaWM * kMmaWN;
constexpr int kMmaSlot = (kMmaBM + kMmaBN) * kMmaBK;  // one stage: A tile, B tile
constexpr int kMmaOutPitch = kMmaBN + 16;           // bytes of a staged output row
constexpr int kMmaOutPitchF = kMmaBN + 8;           // floats of a staged float32 row
constexpr int kMmaARows = kMmaBM * 4 / kMmaThreads;  // 16-byte A copies a thread
constexpr int kMmaBBlocks = kMmaBN * 4 / kMmaThreads;  // 4x4 B blocks a thread
static_assert(kMmaStages >= 3, "B is stored two chunks behind its loads");
static_assert(kMmaBM * 4 % kMmaThreads == 0 && kMmaBN * 4 % kMmaThreads == 0,
              "whole copies per thread");
static_assert(32 * kMmaThreads * 4 <= kMmaStages * kMmaSlot,
              "a split block's int32 sums fit in its ring");
static_assert(kMmaBM * kMmaOutPitchF * 4 <= kMmaStages * kMmaSlot,
              "a float32 output tile fits in the ring");
constexpr int kMmaTR = kMmaBM / kFpTC;  // output rows of a mode-3 tile

// The streaming kernel's ring (or staged output tile).  Mode 3 reads A
// from its footprint, so its ring holds B tiles only, and the footprint
// follows them; the staged float32 output tile and a split's sums overlay
// both once the MMAs are done.
__host__ __device__ constexpr int conv_mma_ring_bytes() {
  return kMmaStages * kMmaSlot > kMmaBM * kMmaOutPitch ? kMmaStages * kMmaSlot
                                                       : kMmaBM * kMmaOutPitch;
}
constexpr int kMmaSlotB = kMmaBN * kMmaBK;  // mode 3: one stage, a B tile

// The window of a tensor-core conv (a template parameter of both kernels):
// 3x3 pad 1 (K2-K6), 3x3 with dilation d and pad d, or 1x1 pad 0; and, on
// the resident-weight kernel only, the separable conv (a 3x3 pad-1
// depthwise conv at the stride, then a 1x1).
constexpr int kWin3 = 0, kWinDil = 1, kWin1 = 2, kWinSep = 3;

// Byte offset of 16-byte chunk `chunk` of tile row `row` (64-byte rows).
// ldmatrix reads 8 consecutive rows (r % 8 == 0) at one chunk; the
// transposed B stores write rows 4i + q (i = 0..7) at one chunk: the XOR of
// bits 1-2 and 3-4 of the row spreads both over the banks.
__device__ __forceinline__ int mma_chunk_addr(int row, int chunk) {
  return row * kMmaBK + ((chunk ^ (((row >> 1) ^ (row >> 3)) & 3)) << 4);
}

template <int kMode, int kSplit, int kWin, bool kF32>
__global__ void __launch_bounds__(kMmaThreads, 512 / kMmaThreads)
conv_i8_mma_kernel(const void* __restrict__ xv, int batch, int h, int w, int cin,
                   float s_in, int x_bf16, const int8_t* __restrict__ wt, int stride,
                   int dilation, int cout, const float* __restrict__ m,
                   const float* __restrict__ c, const int8_t* __restrict__ res, float rr,
                   const int8_t* __restrict__ xd, int wd_, int cdin, int sd,
                   const int8_t* __restrict__ wdt, const float* __restrict__ md,
                   const float* __restrict__ cd, void* __restrict__ out, int ho, int wo) {
  constexpr int kTaps = kWin == kWin1 ? 1 : 9;  // the projection is "tap" kTaps
  constexpr bool kProj = kMode == 2 || kMode == 4;  // a second GEMM of xd
  const int dil = kWin == kWinDil ? dilation : 1;
  const int pad = kWin == kWin1 ? 0 : dil;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t s_base = smem_addr(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr bool kFp = kMode == 3;  // A from the quantized footprint
  const int8_t* __restrict__ x = static_cast<const int8_t*>(xv);  // the codes (not mode 3)
  const int hw_out = ho * wo;
  const int n_pix = batch * hw_out;  // modes 2 and 4: batch 1
  const int tile = static_cast<int>(blockIdx.x) / kSplit;
  const int m0 = tile * kMmaBM;
  const int n0 = blockIdx.y * kMmaBN;
  const int rank = static_cast<int>(blockIdx.x) % kSplit;  // rank in the K-split cluster
  // kFp: the tile is kMmaTR x kFpTC output pixels of image fb at (fy0, fx0)
  const int tiles_x = (wo + kFpTC - 1) / kFpTC, tiles_y = (ho + kMmaTR - 1) / kMmaTR;
  const int fb = tile / (tiles_x * tiles_y), ft = tile - fb * tiles_x * tiles_y;
  const int fy0 = ft / tiles_x * kMmaTR, fx0 = (ft - ft / tiles_x * tiles_x) * kFpTC;
  const Footprint fp = footprint_of(kMmaTR, kWin == kWin1, stride, dil);
  unsigned char* fp_s = smem + kMmaStages * kMmaSlotB;
  // a ring slot's B tile (mode 3: the slots hold B only)
  const int slot_bytes = kFp ? kMmaSlotB : kMmaSlot, b_off = kFp ? 0 : kMmaBM * kMmaBK;
  // The output pixel of tile row ml, or -1 past the edge.
  auto out_pix = [&](int ml) -> long long {
    if constexpr (kFp) {
      const int oy = fy0 + ml / kFpTC, ox = fx0 + ml % kFpTC;
      return oy < ho && ox < wo ? (static_cast<long long>(fb) * ho + oy) * wo + ox : -1;
    } else {
      return m0 + ml < n_pix ? m0 + ml : -1;
    }
  };
  const int cch = (cin + kMmaBK - 1) / kMmaBK;   // chunks per tap
  const int n_main = kTaps * cch;
  const int n_proj = kProj ? (cdin + kMmaBK - 1) / kMmaBK : 0;
  // This block's main chunks [mc0, mc1), then (rank 0) the projection's:
  // rank 0 takes main chunks [0, lead) and every projection chunk, so only
  // main sums cross the cluster; the other ranks share [lead, n_main).
  // lead evens the chunk counts: (n_main + n_proj) / kSplit - n_proj.
  int mc0 = 0, mc1 = n_main;
  if (kSplit > 1) {
    const int lead = max(0, (n_main + n_proj) / kSplit - n_proj);
    mc0 = rank == 0 ? 0 : lead + (rank - 1) * (n_main - lead) / (kSplit - 1);
    mc1 = rank == 0 ? lead : lead + rank * (n_main - lead) / (kSplit - 1);
  }
  const int nk_main = mc1 - mc0;
  const int nk = nk_main + (rank == 0 ? n_proj : 0);  // chunks this block walks

  // The A rows this thread copies: rows tid/4 + i * threads/4, 16-byte
  // column tid % 4.  Per row: the offset of its window's top-left input
  // pixel (it may lie in the pad), the mask of taps inside the image (bit
  // 9: the pixel exists), and the offset of its projection pixel.
  const int a_col = tid & 3;
  long long a_off[kMmaARows], a_doff[kMmaARows];
  int a_mask[kMmaARows];
#pragma unroll
  for (int i = 0; i < kMmaARows; ++i) {
    const int p = m0 + (tid >> 2) + (kMmaThreads / 4) * i;
    a_mask[i] = 0;
    a_off[i] = a_doff[i] = 0;
    if (!kFp && p < n_pix) {
      const int b = p / hw_out, r = p - b * hw_out;
      const int oy = r / wo, ox = r % wo;
      const int iy0 = oy * stride - pad, ix0 = ox * stride - pad;
      for (int t = 0; t < kTaps; ++t) {
        const int iy = iy0 + t / 3 * dil, ix = ix0 + t % 3 * dil;
        if (iy >= 0 && iy < h && ix >= 0 && ix < w) a_mask[i] |= 1 << t;
      }
      a_mask[i] |= 1 << 9;  // the pixel exists: its projection row is read
      a_off[i] = ((static_cast<long long>(b) * h + iy0) * w + ix0) * cin;
      if (kProj) a_doff[i] = (static_cast<long long>(oy) * sd * wd_ + ox * sd) * cdin;
    }
  }

  // The chunk the next load_chunk call stages, walked without divisions:
  // tap-major over the window in channel chunks of kMmaBK, then (mode 2,
  // rank 0) the projection's channel chunks (tap kTaps).  Only a split
  // projection's rank 0 leaves the main walk early, after lead chunks.
  // Mode 3 walks channel-chunk-major instead (main chunk j: channels
  // j / kTaps * kMmaBK, tap j % kTaps), so that each chunk of channels is
  // quantized into the footprint once for its taps.
  int ld_main = nk_main;   // main chunks still to stage
  int ld_tap = nk_main > 0 ? (kFp ? mc0 % kTaps : mc0 / cch) : kTaps;
  int ld_c0 = nk_main > 0 ? (kFp ? mc0 / kTaps : mc0 % cch) * kMmaBK : 0;
  auto next_chunk = [&]() {
    if constexpr (kFp) {
      if (++ld_tap == kTaps) {
        ld_tap = 0;
        ld_c0 += kMmaBK;
      }
      return;
    }
    if (kProj && kSplit > 1 && ld_tap < kTaps && --ld_main == 0) {
      ld_tap = kTaps;
      ld_c0 = 0;
      return;
    }
    ld_c0 += kMmaBK;
    if (ld_tap < kTaps && ld_c0 >= cin) {
      ld_c0 = 0;
      ++ld_tap;
    }
  };

  // B: this thread's 4(k) x 4(n) byte blocks.  Block group G = warp + j *
  // warps covers k rows 16*(G / WN) .. +16 and n 32*(G % WN) .. +32; a lane
  // takes k 4*(lane/8) and n 4*(lane%8) in it, so eight lanes read 32
  // contiguous bytes of one weight row.
  auto b_kr = [&](int j) {
    return 16 * ((warp + j * kMmaWM * kMmaWN) / kMmaWN) + 4 * (lane >> 3);
  };
  auto b_nn = [&](int j) {
    return 32 * ((warp + j * kMmaWM * kMmaWN) % kMmaWN) + 4 * (lane & 7);
  };

  // Stage the chunk (ld_tap, ld_c0): its A rows by cp.async into `slot`
  // (mode 3: none, A is read from the footprint), its B words into
  // registers; then advance to the next chunk.
  auto load_chunk = [&](int slot, uint32_t (&breg)[kMmaBBlocks][4]) {
    const bool proj = kProj && ld_tap == kTaps;
    const int ch = ld_c0 + a_col * 16;
    const long long a_src =
        proj ? ch
             : (kTaps == 1 ? 0 : (ld_tap / 3 * w + ld_tap % 3) *
                                     static_cast<long long>(dil * cin)) + ch;
    const bool ch_ok = ch < (proj ? cdin : cin);
#pragma unroll
    for (int i = 0; i < (kFp ? 0 : kMmaARows); ++i) {
      const bool ok = ch_ok && ((a_mask[i] >> (proj ? 9 : ld_tap)) & 1);
      const int row = (tid >> 2) + (kMmaThreads / 4) * i;
      cp_async16(s_base + slot * kMmaSlot + mma_chunk_addr(row, a_col),
                 ok ? (proj ? xd + a_src + a_doff[i] : x + a_src + a_off[i]) : x,
                 ok ? 16 : 0);
    }
    const int klim = proj ? cdin : cin;
    const int8_t* b_src = proj ? wdt + static_cast<size_t>(ld_c0) * cout
                               : wt + (static_cast<size_t>(ld_tap) * cin + ld_c0) * cout;
#pragma unroll
    for (int j = 0; j < kMmaBBlocks; ++j) {
      const int kr = b_kr(j), n = n0 + b_nn(j);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        breg[j][q] = (ld_c0 + kr + q < klim && n < cout)
            ? __ldg(reinterpret_cast<const uint32_t*>(
                  b_src + static_cast<size_t>(kr + q) * cout + n))
            : 0u;
    }
    next_chunk();
  };
  auto store_b = [&](int slot, const uint32_t (&breg)[kMmaBBlocks][4]) {
    unsigned char* b_s = smem + slot * slot_bytes + b_off;
#pragma unroll
    for (int j = 0; j < kMmaBBlocks; ++j) {
      const int kr = b_kr(j), nn = b_nn(j);
      // 4x4 byte transpose: word q of the result is n = nn + q, k = kr..kr+3
      const uint32_t t0 = __byte_perm(breg[j][0], breg[j][1], 0x5140);
      const uint32_t t1 = __byte_perm(breg[j][0], breg[j][1], 0x7362);
      const uint32_t t2 = __byte_perm(breg[j][2], breg[j][3], 0x5140);
      const uint32_t t3 = __byte_perm(breg[j][2], breg[j][3], 0x7362);
      const uint32_t col[4] = {__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                               __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        *reinterpret_cast<uint32_t*>(b_s + mma_chunk_addr(nn + q, kr >> 4) + (kr & 15)) =
            col[q];
    }
  };
  const int wm = warp % kMmaWM, wn = warp / kMmaWM;  // warp tile: 32 pixels x 32 channels
  int acc[2][4][4], accd[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0;
        accd[i][j][e] = 0;
      }

  // Mode 3: the footprint pixel of this lane's two ldmatrix rows at tap
  // 0; tap t adds tap_off(t).
  int fpix[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wm * 32 + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    fpix[i] = row / kFpTC * fp.step * fp.cols + row % kFpTC * fp.step;
  }
  auto tap_off = [&](int t) { return kTaps == 1 ? 0 : (t / 3 * fp.cols + t % 3) * dil; };
  const uint32_t fp_base = s_base + kMmaStages * kMmaSlotB;

  // kc: the chunk's index in this block's walk (mode 3: its tap).
  auto compute = [&](int slot, int (&sum)[2][4][4], int kc) {
    const uint32_t a_s = s_base + slot * kMmaSlot;
    const uint32_t b_s = s_base + slot * slot_bytes + b_off;
    const int toff = kFp ? tap_off((mc0 + kc) % kTaps) : 0;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = wm * 32 + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const uint32_t a_addr =
            kFp ? fp_base + fp_byte(fpix[i] + toff, ks * 2 + (lane >> 4), fp.step == 2)
                : a_s + mma_chunk_addr(row, ks * 2 + (lane >> 4));
        ldmatrix_x4(a_addr, af[i][0], af[i][1], af[i][2], af[i][3]);
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int row = wn * 32 + p * 16 + (lane & 7) + (lane >> 4) * 8;
        ldmatrix_x4(b_s + mma_chunk_addr(row, ks * 2 + ((lane >> 3) & 1)), bf[2 * p][0],
                    bf[2 * p][1], bf[2 * p + 1][0], bf[2 * p + 1][1]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(sum[i][j], af[i], bf[j][0], bf[j][1]);
    }
  };

  // The ring: chunk kc's A copies are issued kMmaStages - 1 chunks ahead.
  // Its B words are loaded into registers as many chunks ahead and stored
  // (transposed) one chunk later, after the next chunk's MMAs, so two
  // chunks' MMAs cover their latency.
  uint32_t b_even[kMmaBBlocks][4], b_odd[kMmaBBlocks][4];
#pragma unroll
  for (int s = 0; s < kMmaStages - 2; ++s) {
    if (s < nk) {
      load_chunk(s, b_even);
      store_b(s, b_even);
    }
    cp_async_commit();
  }
  if (kMmaStages - 2 < nk) load_chunk(kMmaStages - 2, b_odd);
  cp_async_commit();

  // one chunk: ld receives chunk kc + S - 1, st holds chunk kc + S - 2
  auto step = [&](int kc, uint32_t (&ld)[kMmaBBlocks][4],
                  const uint32_t (&st)[kMmaBBlocks][4]) {
    if constexpr (kFp) {  // no A copies in the ring
      __syncthreads();  // everyone is done with chunk kc - 1
      if (kc == 0 || (mc0 + kc) % kTaps == 0) {
        // the footprint of the chunk's channels, once for its taps
        quantize_footprint<kMmaThreads>(fp_s, fp, xv, x_bf16, s_in, fb, h, w, cin,
                                        (mc0 + kc) / kTaps * kMmaBK, fy0 * stride - pad,
                                        fx0 * stride - pad);
        __syncthreads();
      }
    } else {
      cp_async_wait<kMmaStages - 2>();
      __syncthreads();  // chunk kc staged; everyone is done with chunk kc - 1
    }
    const int nxt = kc + kMmaStages - 1;
    if (nxt < nk) load_chunk(nxt % kMmaStages, ld);
    cp_async_commit();
    if (kProj && kc >= nk_main)
      compute(kc % kMmaStages, accd, kc);
    else
      compute(kc % kMmaStages, acc, kc);
    if (nxt - 1 < nk) store_b((nxt - 1) % kMmaStages, st);
  };
  for (int kc = 0; kc < nk; kc += 2) {
    step(kc, b_even, b_odd);
    if (kc + 1 < nk) step(kc + 1, b_odd, b_even);
  }
  cp_async_wait<0>();
  __syncthreads();

  if constexpr (kSplit > 1) {
    // The other ranks leave their main sums in their own ring; rank 0 adds
    // them through distributed shared memory, thread by thread, and alone
    // runs the epilogue (with its own projection sums, mode 2).  The second
    // sync keeps each part alive until it is read.
    cg::cluster_group cluster = cg::this_cluster();
    int* part = reinterpret_cast<int*>(smem);  // [32 sums][kMmaThreads]
    if (rank != 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            part[((i * 4 + j) * 4 + e) * kMmaThreads + tid] = acc[i][j][e];
    }
    cluster.sync();
    if (rank == 0) {
      for (int r = 1; r < kSplit; ++r) {
        const int* rp = cluster.map_shared_rank(part, r);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][j][e] += rp[((i * 4 + j) * 4 + e) * kMmaThreads + tid];
      }
    }
    cluster.sync();
    if (rank != 0) return;
  }

  // epilogue: codes (or float32 values) to shared memory, then 16-byte
  // stores
  int8_t* o_s = reinterpret_cast<int8_t*>(smem);
  float* o_f = reinterpret_cast<float*>(smem);
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int nl = wn * 32 + j * 8 + 2 * t4;
    const int n = n0 + nl;
    if (n >= cout) continue;   // cout % 8 == 0: n + 1 < cout too
    float mv[2], cv[2], mdv[2] = {0.f, 0.f}, cdv[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mv[e] = m[n + e];
      cv[e] = c[n + e];
      if (kProj) {
        mdv[e] = md[n + e];
        cdv[e] = cd[n + e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int ml = wm * 32 + i * 16 + g + 8 * hh;
        const long long p = out_pix(ml);
        if (p < 0) continue;
        float z[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          z[e] = __fmaf_rn(__int2float_rn(acc[i][j][2 * hh + e]), mv[e], cv[e]);
          if (kMode == 1) {
            z[e] = __fmaf_rn(static_cast<float>(res[static_cast<size_t>(p) * cout + n + e]), rr,
                             z[e]);
          } else if (kMode == 2) {
            z[e] = __fadd_rn(__fmaf_rn(__int2float_rn(accd[i][j][2 * hh + e]), mdv[e], z[e]),
                             cdv[e]);
          } else if (kMode == 4) {
            z[e] = __fadd_rn(z[e],
                             __fmaf_rn(__int2float_rn(accd[i][j][2 * hh + e]), mdv[e], cdv[e]));
          }
          if (kMode != 3) z[e] = fmaxf(z[e], 0.f);  // mode 3: no ReLU
        }
        if constexpr (kF32)
          *reinterpret_cast<float2*>(o_f + ml * kMmaOutPitchF + nl) = make_float2(z[0], z[1]);
        else
          *reinterpret_cast<uint16_t*>(o_s + ml * kMmaOutPitch + nl) =
              pack2(requant(z[0]), requant(z[1]));
      }
  }
  __syncthreads();
  if constexpr (kF32) {
    // 4 channels a 16-byte store (cout % 8 == 0: all four or none)
    float* outf = static_cast<float*>(out);
    for (int idx = tid; idx < kMmaBM * (kMmaBN / 4); idx += kMmaThreads) {
      const int row = idx / (kMmaBN / 4), n = n0 + (idx % (kMmaBN / 4)) * 4;
      const long long p = out_pix(row);
      if (p < 0 || n >= cout) continue;
      *reinterpret_cast<float4*>(outf + static_cast<size_t>(p) * cout + n) =
          *reinterpret_cast<const float4*>(o_f + row * kMmaOutPitchF + (n - n0));
    }
    return;
  }
  int8_t* outq = static_cast<int8_t*>(out);
  for (int idx = tid; idx < kMmaBM * (kMmaBN / 16); idx += kMmaThreads) {
    const int row = idx / (kMmaBN / 16), n = n0 + (idx % (kMmaBN / 16)) * 16;
    const long long p = out_pix(row);
    if (p < 0 || n >= cout) continue;
    int8_t* dst = outq + static_cast<size_t>(p) * cout + n;
    const int8_t* src = o_s + row * kMmaOutPitch + (n - n0);
    if ((cout & 15) == 0) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
      if (n + 8 < cout)
        *reinterpret_cast<uint2*>(dst + 8) = *reinterpret_cast<const uint2*>(src + 8);
    }
  }
}

// Dynamic shared memory of a streaming launch: the ring, or in mode 3 the
// B ring and the footprint of a k x k window at this stride and dilation
// (at least the staged float32 output tile).
size_t conv_mma_smem_bytes(int mode, int k, int stride, int dil) {
  if (mode != 3) return static_cast<size_t>(conv_mma_ring_bytes());
  const int staged = kMmaStages * kMmaSlotB + footprint_bytes(kMmaTR, k == 1, stride, dil);
  const int out = kMmaBM * kMmaOutPitchF * 4;
  return static_cast<size_t>(staged > out ? staged : out);
}

// ---------------------------------------------------------------------------
// K3's and K2's links, and the convs of cbr_i8 and bottleneck_i8 up to 64
// input channels: int8 conv + epilogue on int8 tensor cores, the link's
// whole weight resident in shared memory, persistent blocks.
//
// Replaces, four launches per call, the TPU kernel l1_stage_i8_paired_view
// (torchseg_tpu/ops/pallas/int8_serve_kernels.py:763): ResNet-18's stage 1,
// two identity BasicBlocks at (1, 256, 512, 64) on the main path; and, one
// launch per call at stride 2, conv3x3s2_i8_quad (:515): the SpatialPath's
// two 3x3/2 CBRs, (1, 512, 1024, 64) -> (1, 256, 512, 64) and on to (1,
// 128, 256, 64).
//
// What it computes: conv_i8_mma_kernel's modes 0, 1 and 3 at stride 1 or
// 2 (the same __fmaf_rn chain; mode 3 from the float32 activation, its
// batch folded into M, as there), for cin % 16 == 0 and cout % 8 == 0,
// over the same windows (kWin: 3x3 pad 1, 3x3 dilated, 1x1), int8 codes or
// (kF32) float32 values out; and a fourth window, kWinSep, the separable
// conv (below).  Stride, dilation and window change only the
// gather: output pixel (oy, ox)'s window starts at input (s oy - p, s ox -
// p), its taps lie d apart, and its tap mask and the zero fill at the pad
// follow from that; the shared-memory tiles, and so every ldmatrix, are
// laid out as for the 3x3 at stride 1 (a 1x1 has one tap: 64 + 16 bytes
// of weight a channel).
//
// What bounds it on an H100: int8 tensor-core operations, 9.66 G a link
// at stage 1 (M = 131,072 pixels, N = 64, K = 9 x 64 = 576), ~4.9 us at the
// 1,979 TOP/s dense peak, against 16.8 MB a link (~5 us); the same GEMM
// at K2's first launch against 42 MB (~12.5 us: bytes).  The streaming
// kernel above is badly matched to this shape: K is 9 chunks against its
// 4-stage ring, so a third of each block's loop is fill and drain; each
// of its 1,024 blocks loads and byte-transposes the link's whole 36,864-byte
// weight; its epilogue overlaps no load.
//
// Design:
//   * a block stages the weights of its 64 output channels once, K-major
//     ([n][k = tap * cpad + channel], each tap's channels padded to the
//     64-byte chunk with zeros), rows padded to an odd number of 16-byte
//     chunks so ldmatrix is conflict-free: 37,888 bytes at cin = 64;
//   * the grid is as many blocks as fit on the card at once (two an SM at
//     cin = 64), and each walks the M tiles blockIdx.x, + gridDim.x, ...;
//     the cp.async ring of A chunks runs across the tile
//     boundaries, so the next tile's first chunks load while this tile's
//     last chunks compute and its epilogue runs;
//   * A chunks are gathered as in conv_i8_mma_kernel (per-row window
//     offset and tap mask, zero-fill at the pad and past cin); the chunk
//     loop holds no weight loads, no transposes and no divisions;
//   * 8 warps along M, each 32 pixels x 64 channels (a 256 x 64 tile): per
//     32-byte k step two A and four B ldmatrix.x4 feed 16 mma.sync.m16n8k32;
//     a 2-stage ring (one chunk loads while one computes) keeps two blocks
//     an SM (109 KB of shared memory each at cin = 64).  Tuned with
//     scripts/torch_int8_kernel_variants.py on an H100: against 128 x 64
//     tiles of 4 x 2 warps (32 x 32) and a 4-stage ring, 2-8 % faster a
//     link; 3 stages at 256 x 64 leave one block an SM and were 25-35 %
//     slower;
//   * mode 1's residual tile is copied into shared memory by cp.async at
//     the tile's first chunk, in that chunk's group, so the epilogue reads
//     it from shared memory (read from device memory by the epilogue, 2
//     bytes a thread at a time, it made the residual links ~25 % slower);
//   * the epilogue stages codes in a buffer of its own (the ring keeps
//     loading) and they leave with 16-byte stores; float32 values (a 256
//     x 64 tile is 64 KB, which does not fit beside the weights) leave
//     straight from the accumulator fragments, each lane's two adjacent
//     channels as one 8-byte store (a warp's store fills whole 32-byte
//     sectors).
// Integer sums are exact in any order: bit-exact against the plain version.
//
// Mode 3 (conv_i8_affine, the post-training int8 conv, up to 64 input
// channels by conv_route's rule) and kWinSep tile the output in 2-D
// (kResTR x kFpTC pixels) and stage each tile's footprint (fp_byte above)
// in shared memory.  Mode 3 quantizes the float32 or bf16 activation into
// it at the tile's first chunk, each element once a tile (quant_bits: the
// true quotient's rounding on full-rate operations), and its ldmatrix
// reads the A fragments of every tap straight from the footprint, so it
// keeps no A ring.  Staging the A chunk tap by tap instead read and
// quantized every element once a tap: the 33 convs of R18.speed's --int8
// forward took 5.5 ms of device time on an H100 against 0.84 on codes.
//
// kWinSep, "dw3x3 then 1x1" (sep_fused_i8: the Xception39 separable
// convs; replaces K14's launch and the pointwise launch that read its
// codes back): out = the 1x1 conv (its weight resident: a row of cin
// bytes padded to 64-byte chunks, plus 16, for each of the block's 64
// output channels) of the depthwise codes
// q = clip(rint(__fmul_rn(y_dw, dm)), -127, 127), y_dw the exact 3x3 pad-1
// depthwise sum of x at the depthwise stride (K14's arithmetic); the 1x1
// runs at stride 1 on the depthwise output grid, modes 0 and 1.  Each A
// chunk (the tile's 256 pixels x 64 channels of depthwise codes) is
// computed by the producer from the chunk's footprint of input codes,
// which cp.async stages one chunk ahead (its copies fly while the MMAs of
// the chunk before run): a thread's 16 channels of a pixel read the 9 taps
// from shared memory, each group of four taps is byte-transposed (4 x 4
// blocks, __byte_perm) so that one __dp4a sums four taps of one channel
// against the resident depthwise weights (staged as three words a
// channel: taps 0-3, taps 4-7, tap 8 in the byte of the channel's lane),
// the ninth tap is one __dp4a a channel, and the requantized codes go into
// the swizzled A tile that ldmatrix feeds to the int8 mma.  The depthwise
// codes never reach device memory; each N tile (64 output channels)
// recomputes them for its pixels.  What bounds it at X39's shapes:
// launches and the producer's CUDA-core work (~2 x 9 integer operations a
// depthwise code against 2 x 64 tensor-core operations of the 1x1 an N
// tile).
// ---------------------------------------------------------------------------

constexpr int kResWM = 8;         // warps along M (32 pixels each)
constexpr int kResWN = 1;         // warps along N
constexpr int kResStages = 2;     // cp.async ring depth (>= 2)
constexpr int kResBN = 64;        // output channels per block
constexpr int kResBM = 32 * kResWM;                 // output pixels per tile
constexpr int kResTN = kResBN / kResWN;             // channels per warp
constexpr int kResThreads = 32 * kResWM * kResWN;
constexpr int kResARows = kResBM * 4 / kResThreads;  // 16-byte A copies a thread
constexpr int kResSlot = kResBM * kMmaBK;           // one stage: an A chunk
constexpr int kResOutPitch = kResBN + 16;           // bytes of a staged output / residual row
static_assert(kResStages >= 2 && kResTN % 16 == 0, "ring depth, warp tile");
static_assert(kResBM * 4 % kResThreads == 0, "whole copies per thread");
constexpr int kResTR = kResBM / kFpTC;              // output rows of a footprint tile

// Bytes of one resident weight row: taps x cin padded to 64-byte chunks,
// plus 16 so the row is an odd number of 16-byte chunks.
__host__ __device__ __forceinline__ int res_w_pitch(int cin, int taps) {
  return taps * ((cin + kMmaBK - 1) / kMmaBK) * kMmaBK + 16;
}

// The separable window's 4 x 4 byte transpose: word j of the result holds
// byte j of a, b, c and d (the same channel of four taps).
__device__ __forceinline__ void transpose4(uint32_t a, uint32_t b, uint32_t c,
                                           uint32_t d, uint32_t (&col)[4]) {
  const uint32_t t0 = __byte_perm(a, b, 0x5140);
  const uint32_t t1 = __byte_perm(a, b, 0x7362);
  const uint32_t t2 = __byte_perm(c, d, 0x5140);
  const uint32_t t3 = __byte_perm(c, d, 0x7362);
  col[0] = __byte_perm(t0, t2, 0x5410);
  col[1] = __byte_perm(t0, t2, 0x7632);
  col[2] = __byte_perm(t1, t3, 0x5410);
  col[3] = __byte_perm(t1, t3, 0x7632);
}

__device__ __forceinline__ uint32_t word_of(const uint4 v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// The resident kernel's shared memory, in order: the weights [kResBN][pitch];
// the A ring (not mode 3); the staged output tile and the residual tile
// (both for the other windows; kSep's output unless float32 out, its
// residual in mode 1); kSep's depthwise tables (16 bytes a channel) and
// the epilogue's m and c of the block's channels; the footprint (kSep,
// mode 3).  off: the byte offsets of the ring, output, residual, tables
// and footprint, then the total.
__host__ __device__ __forceinline__ void res_smem_layout(int cin, int taps, int mode, bool f32,
                                                         bool sep, int stride, int dil,
                                                         int (&off)[6]) {
  const bool fp = sep || mode == 3;
  const int cpad = (cin + kMmaBK - 1) / kMmaBK * kMmaBK;
  const int tile = kResBM * kResOutPitch;
  off[0] = kResBN * res_w_pitch(cin, sep ? 1 : taps);
  off[1] = off[0] + (mode == 3 ? 0 : kResStages * kResSlot);
  off[2] = off[1] + (!fp || !f32 ? tile : 0);
  off[3] = off[2] + (!fp || mode == 1 ? tile : 0);
  off[4] = off[3] + (sep ? 16 * cpad + 8 * kResBN : 0);
  off[5] = off[4] + (fp ? footprint_bytes(kResTR, !sep && taps == 1, stride, sep ? 1 : dil) : 0);
}

// kWinSep's grids at X39's shapes are a wave or less, so its blocks take
// the registers of one block an SM (its producer's and the MMAs' live
// together); every other window keeps two blocks an SM.
template <int kMode, int kWin, bool kF32>
__global__ void __launch_bounds__(kResThreads, kWin == kWinSep ? 1 : 2)
conv_i8_mma_res_kernel(const void* __restrict__ xv, int batch, int h, int w, int cin,
                       int stride, int dilation, float s_in, int x_bf16,
                       const int8_t* __restrict__ dw, const float* __restrict__ dm,
                       const int8_t* __restrict__ wt, int cout,
                       const float* __restrict__ m, const float* __restrict__ c,
                       const int8_t* __restrict__ res, float rr,
                       void* __restrict__ out, int ho, int wo) {
  constexpr bool kSep = kWin == kWinSep;
  constexpr bool kFp = kSep || kMode == 3;       // 2-D tiles and a staged footprint
  constexpr bool kRing = kMode != 3;             // A chunks in a ring (mode 3: the footprint)
  constexpr int kTaps = kWin == kWin1 ? 1 : 9;   // taps a pixel gathers
  constexpr int kKTaps = kSep ? 1 : kTaps;       // taps along K (of the weight)
  const int dil = kWin == kWinDil ? dilation : 1;
  const int pad = kWin == kWin1 ? 0 : dil;
  const int8_t* __restrict__ x = static_cast<const int8_t*>(xv);  // the codes (not mode 3)
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hw_out = ho * wo;
  const int n_pix = batch * hw_out;
  const int n0 = blockIdx.y * kResBN;
  const int cpad = (cin + kMmaBK - 1) / kMmaBK * kMmaBK;
  const int nk = kKTaps * cpad / kMmaBK;   // chunks per tile
  const int pitch = res_w_pitch(cin, kKTaps);
  const int tiles_x = (wo + kFpTC - 1) / kFpTC, tiles_y = (ho + kResTR - 1) / kResTR;
  const int m_tiles = kFp ? batch * tiles_x * tiles_y : (n_pix + kResBM - 1) / kResBM;
  const int bx = static_cast<int>(blockIdx.x);
  const int my_tiles = (m_tiles - 1 - bx) / gridDim.x + 1;
  const int total = my_tiles * nk;    // chunks this block computes
  int off[6];
  res_smem_layout(cin, kTaps, kMode, kF32, kSep, stride, dil, off);
  unsigned char* w_s = smem;                                   // [kResBN][pitch]
  const uint32_t w_base = smem_addr(w_s);
  unsigned char* a_s = smem + off[0];                          // [stages][BM][64]
  const uint32_t a_base = smem_addr(a_s);
  int8_t* o_s = reinterpret_cast<int8_t*>(smem + off[1]);      // [BM][kResOutPitch]
  const int8_t* r_s = reinterpret_cast<const int8_t*>(smem + off[2]);  // mode 1: as o_s
  // kSep: the depthwise weights, three words a channel (taps 0-3, taps
  // 4-7, tap 8 in byte c % 4), then dm, each [cpad], zero past cin; then m
  // and c of channels n0 .. n0 + 63
  uint32_t* dw_s = reinterpret_cast<uint32_t*>(smem + off[3]);
  float* dm_s = reinterpret_cast<float*>(dw_s + 3 * cpad);
  float* mc_s = dm_s + cpad;
  unsigned char* fp_s = smem + off[4];
  const uint32_t fp_base = smem_addr(fp_s);
  const Footprint fp = footprint_of(kResTR, kWin == kWin1, stride, dil);
  const bool s2 = fp.step == 2;

  // A tile's place: its first pixel m0 (the flat tiles), or (kFp) its
  // image b and first output row and column; out_pix: the output pixel of
  // its row ml, or -1 past the edge.
  struct Org {
    int m0, b, oy0, ox0;
  };
  auto tile_org = [&](int tile) {
    Org o{tile * kResBM, 0, 0, 0};
    if constexpr (kFp) {
      o.b = tile / (tiles_x * tiles_y);
      const int t = tile - o.b * tiles_x * tiles_y, ty = t / tiles_x;
      o.oy0 = ty * kResTR;
      o.ox0 = (t - ty * tiles_x) * kFpTC;
    }
    return o;
  };
  auto out_pix = [&](const Org& o, int ml) -> long long {
    if constexpr (kFp) {
      const int oy = o.oy0 + ml / kFpTC, ox = o.ox0 + ml % kFpTC;
      return oy < ho && ox < wo ? (static_cast<long long>(o.b) * ho + oy) * wo + ox : -1;
    } else {
      return o.m0 + ml < n_pix ? o.m0 + ml : -1;
    }
  };

  // The A rows this thread copies (rows tid/4 + i * threads/4, 16-byte
  // column tid % 4) of the tile being loaded: the offset of each window's
  // top-left input pixel and its mask of taps inside the image.
  const int a_col = tid & 3;
  long long a_off[kResARows];
  int a_mask[kResARows];
  auto setup_rows = [&](int tile) {
#pragma unroll
    for (int i = 0; i < kResARows; ++i) {
      const int p = tile * kResBM + (tid >> 2) + (kResThreads / 4) * i;
      a_mask[i] = 0;
      a_off[i] = 0;
      if (p < n_pix) {
        const int b = p / hw_out, r = p - b * hw_out;
        const int oy = r / wo, ox = r - oy * wo;
        const int iy0 = oy * stride - pad, ix0 = ox * stride - pad;
#pragma unroll
        for (int t = 0; t < kTaps; ++t) {
          const int iy = iy0 + t / 3 * dil, ix = ix0 + t % 3 * dil;
          if (iy >= 0 && iy < h && ix >= 0 && ix < w) a_mask[i] |= 1 << t;
        }
        a_off[i] = ((static_cast<long long>(b) * h + iy0) * w + ix0) * cin;
      }
    }
  };
  if constexpr (!kFp) setup_rows(bx);

  // The load cursor: the ld_i-th of this block's tiles, tap, channel chunk.
  int ld_i = 0, ld_tap = 0, ld_c0 = 0;
  auto load_chunk = [&](int slot) {
    const int ch = ld_c0 + a_col * 16;
    const long long src = static_cast<long long>(ld_tap / 3 * w + ld_tap % 3) * (dil * cin) + ch;
#pragma unroll
    for (int i = 0; i < kResARows; ++i) {
      const bool ok = ch < cin && ((a_mask[i] >> ld_tap) & 1);
      const int row = (tid >> 2) + (kResThreads / 4) * i;
      cp_async16(a_base + slot * kResSlot + mma_chunk_addr(row, a_col),
                 ok ? x + src + a_off[i] : x, ok ? 16 : 0);
    }
    ld_c0 += kMmaBK;
    if (ld_c0 >= cin) {
      ld_c0 = 0;
      if (++ld_tap == kTaps) {
        ld_tap = 0;
        if (++ld_i < my_tiles) setup_rows(blockIdx.x + ld_i * gridDim.x);
      }
    }
  };

  // The weights of channels n0 .. n0 + 63, K-major: each 4(k) x 4(n) byte
  // block read as four words and transposed with byte permutes.
  auto stage_weights = [&]() {
    for (int i = tid; i < kKTaps * cpad / 4 * (kResBN / 4); i += kResThreads) {
      const int nn = 4 * (i % (kResBN / 4)), kk = 4 * (i / (kResBN / 4));
      const int tap = kk / cpad, ch = kk - tap * cpad, n = n0 + nn;
      uint32_t v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)  // cin % 16 == 0, cout % 8 == 0: all four or none
        v[q] = ch < cin && n < cout
            ? __ldg(reinterpret_cast<const uint32_t*>(
                  wt + (static_cast<long long>(tap) * cin + ch + q) * cout + n))
            : 0u;
      uint32_t col[4];
      transpose4(v[0], v[1], v[2], v[3], col);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        *reinterpret_cast<uint32_t*>(w_s + (nn + q) * pitch + kk) = col[q];
    }
  };

  const int wm = warp % kResWM, wn = warp / kResWM;
  constexpr int kJ = kResTN / 8;   // n8 tiles a warp
  int acc[2][kJ][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // Mode 3: the footprint pixel of this lane's two ldmatrix rows at tap
  // 0 (chunk kc is tap kc: cin <= 64).
  int fpix[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wm * 32 + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    fpix[i] = row / kFpTC * fp.step * fp.cols + row % kFpTC * fp.step;
  }
  auto compute = [&](int slot, int kc) {
    const uint32_t a_sl = a_base + slot * kResSlot;
    const int toff = kTaps == 1 ? 0 : (kc / 3 * fp.cols + kc % 3) * dil;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t af[2][4], bf[kJ][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = wm * 32 + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const uint32_t a_addr =
            kRing ? a_sl + mma_chunk_addr(row, ks * 2 + (lane >> 4))
                  : fp_base + fp_byte(fpix[i] + toff, ks * 2 + (lane >> 4), s2);
        ldmatrix_x4(a_addr, af[i][0], af[i][1], af[i][2], af[i][3]);
      }
#pragma unroll
      for (int p = 0; p < kJ / 2; ++p) {
        const int n = wn * kResTN + p * 16 + (lane & 7) + (lane >> 4) * 8;
        ldmatrix_x4(w_base + n * pitch + kc * kMmaBK + (ks * 2 + ((lane >> 3) & 1)) * 16,
                    bf[2 * p][0], bf[2 * p][1], bf[2 * p + 1][0], bf[2 * p + 1][1]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < kJ; ++j) mma_s8(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  };

  // Mode 1: the residual tile (the tile's rows, channels n0..n0+63) into
  // r_s, 8 bytes a copy (cout % 16 may be 8), zero past the edges.
  auto load_res = [&](int tile) {
    const Org o = tile_org(tile);
    for (int idx = tid; idx < kResBM * kResBN / 8; idx += kResThreads) {
      const int row = idx / (kResBN / 8), col = 8 * (idx % (kResBN / 8));
      const long long p = out_pix(o, row);
      const bool ok = p >= 0 && n0 + col < cout;
      cp_async8(smem_addr(r_s + row * kResOutPitch + col),
                ok ? res + static_cast<size_t>(p) * cout + n0 + col : res, ok ? 8 : 0);
    }
  };

  // The tile's epilogue (conv_i8_mma_kernel's chain), then the sums reset.
  const int g = lane >> 2, t4 = lane & 3;
  auto epilogue = [&](int tile) {
    const Org o = tile_org(tile);
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int nl = wn * kResTN + j * 8 + 2 * t4;
      const int n = n0 + nl;
      if (n < cout) {   // cout % 8 == 0: n + 1 < cout too
        const float mv[2] = {kSep ? mc_s[nl] : __ldg(m + n), kSep ? mc_s[nl + 1] : __ldg(m + n + 1)};
        const float cv[2] = {kSep ? mc_s[kResBN + nl] : __ldg(c + n),
                             kSep ? mc_s[kResBN + nl + 1] : __ldg(c + n + 1)};
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int ml = wm * 32 + i * 16 + g + 8 * hh;
            const long long p = out_pix(o, ml);
            if (p < 0) continue;
            uint32_t rv = 0;
            if (kMode == 1) rv = *reinterpret_cast<const uint16_t*>(r_s + ml * kResOutPitch + nl);
            float z[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              z[e] = __fmaf_rn(__int2float_rn(acc[i][j][2 * hh + e]), mv[e], cv[e]);
              if (kMode == 1)
                z[e] = __fmaf_rn(static_cast<float>(static_cast<int8_t>(rv >> (8 * e))), rr,
                                 z[e]);
              if (kMode != 3) z[e] = fmaxf(z[e], 0.f);  // mode 3: no ReLU
            }
            if constexpr (kF32)
              *reinterpret_cast<float2*>(static_cast<float*>(out) + static_cast<size_t>(p) * cout +
                                         n) = make_float2(z[0], z[1]);
            else
              *reinterpret_cast<uint16_t*>(o_s + ml * kResOutPitch + nl) =
                  pack2(requant(z[0]), requant(z[1]));
          }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
    }
    if constexpr (kF32) return;
    __syncthreads();
    for (int idx = tid; idx < kResBM * (kResBN / 16); idx += kResThreads) {
      const int row = idx / (kResBN / 16), n = n0 + (idx % (kResBN / 16)) * 16;
      const long long p = out_pix(o, row);
      if (p < 0 || n >= cout) continue;
      int8_t* dst = static_cast<int8_t*>(out) + static_cast<size_t>(p) * cout + n;
      const int8_t* src = o_s + row * kResOutPitch + (n - n0);
      if ((cout & 15) == 0) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
        if (n + 8 < cout)
          *reinterpret_cast<uint2*>(dst + 8) = *reinterpret_cast<const uint2*>(src + 8);
      }
    }
  };

  if constexpr (kSep) {
    // Chunk j of this block: channels (j % nk) * 64 of its tile j / nk.
    // stage_fp(j): the chunk's footprint of input codes by cp.async (the
    // pad and the past-the-edge pixels zero-filled); produce(slot, j): its
    // depthwise codes into an A slot, from the footprint.
    auto stage_fp = [&](int j) {
      const Org o = tile_org(bx + j / nk * gridDim.x);
      const int c0 = j % nk * kMmaBK, groups = min(4, (cin - c0) / 16);
      const int iy0 = o.oy0 * stride - 1, ix0 = o.ox0 * stride - 1;
      // copy i = (row, column, group) row-major, every kResThreads-th from
      // tid; the loop steps (row, column, group) by kResThreads without a
      // division
      int r = tid / (fp.cols * groups), col = tid - r * fp.cols * groups;
      int grp = col % groups;
      col /= groups;
      const int adv = kResThreads % (fp.cols * groups), adv_r = kResThreads / (fp.cols * groups);
      const int adv_c = adv / groups, adv_g = adv % groups;
      for (; r < fp.rows;) {
        const int iy = iy0 + r, ix = ix0 + col;
        const bool ok = iy >= 0 && iy < h && ix >= 0 && ix < w;
        cp_async16(fp_base + fp_byte(r * fp.cols + col, grp, s2),
                   ok ? x + (static_cast<long long>(iy) * w + ix) * cin + c0 + 16 * grp : x,
                   ok ? 16 : 0);
        r += adv_r;
        col += adv_c;
        if ((grp += adv_g) >= groups) {
          grp -= groups;
          ++col;
        }
        if (col >= fp.cols) {
          col -= fp.cols;
          ++r;
        }
      }
    };
    // The chunk's (pixel, 16-channel group) items spread over the threads,
    // neighbouring threads on neighbouring groups, then pixels, so that a
    // thread keeps one group (unless a chunk has 3) and holds its
    // depthwise weights and dm in registers; an item sums 9 taps of its 16
    // channels, each four taps transposed and summed by __dp4a against
    // them.  A chunk's columns past cin keep stale codes: their weights
    // are zero.
    auto produce = [&](int slot, int j) {
      const Org o = tile_org(bx + j / nk * gridDim.x);
      const int c0 = j % nk * kMmaBK, groups = min(4, (cin - c0) / 16);
      int wgrp = -1;
      uint4 wt0[4], wt1[4], wt2[4];  // taps 0-3, 4-7, 8 of the group's channels
      float4 dmv[4];
#pragma unroll 1
      for (int it = tid; it < kResBM * groups; it += kResThreads) {
        const int row = it / groups, grp = it - row * groups;
        const int ch = c0 + 16 * grp, ty = row / kFpTC, tx = row % kFpTC;
        if (grp != wgrp) {
          wgrp = grp;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            wt0[q] = *reinterpret_cast<const uint4*>(dw_s + ch + 4 * q);
            wt1[q] = *reinterpret_cast<const uint4*>(dw_s + cpad + ch + 4 * q);
            wt2[q] = *reinterpret_cast<const uint4*>(dw_s + 2 * cpad + ch + 4 * q);
            dmv[q] = *reinterpret_cast<const float4*>(dm_s + ch + 4 * q);
          }
        }
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (o.oy0 + ty < ho && o.ox0 + tx < wo) {
          const int f = (ty * fp.cols + tx) * fp.step;
          auto tap = [&](int t) {
            return *reinterpret_cast<const uint4*>(
                fp_s + fp_byte(f + t / 3 * fp.cols + t % 3, grp, s2));
          };
          int acc_dw[16];
#pragma unroll
          for (int e = 0; e < 16; ++e) acc_dw[e] = 0;
#pragma unroll
          for (int gg = 0; gg < 2; ++gg) {
            const uint4 t0 = tap(4 * gg), t1 = tap(4 * gg + 1), t2 = tap(4 * gg + 2),
                        t3 = tap(4 * gg + 3);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              uint32_t col[4];
              transpose4(word_of(t0, q), word_of(t1, q), word_of(t2, q), word_of(t3, q), col);
              const uint4 wv = gg ? wt1[q] : wt0[q];
              acc_dw[4 * q + 0] = __dp4a(static_cast<int>(col[0]), static_cast<int>(wv.x), acc_dw[4 * q + 0]);
              acc_dw[4 * q + 1] = __dp4a(static_cast<int>(col[1]), static_cast<int>(wv.y), acc_dw[4 * q + 1]);
              acc_dw[4 * q + 2] = __dp4a(static_cast<int>(col[2]), static_cast<int>(wv.z), acc_dw[4 * q + 2]);
              acc_dw[4 * q + 3] = __dp4a(static_cast<int>(col[3]), static_cast<int>(wv.w), acc_dw[4 * q + 3]);
            }
          }
          const uint4 t8 = tap(8);
          uint32_t words[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int xw = static_cast<int>(word_of(t8, q));
            const uint4 wv = wt2[q];
            const float4 d = dmv[q];
            words[q] = pack4(
                requant(__fmul_rn(__int2float_rn(__dp4a(xw, static_cast<int>(wv.x), acc_dw[4 * q + 0])), d.x)),
                requant(__fmul_rn(__int2float_rn(__dp4a(xw, static_cast<int>(wv.y), acc_dw[4 * q + 1])), d.y)),
                requant(__fmul_rn(__int2float_rn(__dp4a(xw, static_cast<int>(wv.z), acc_dw[4 * q + 2])), d.z)),
                requant(__fmul_rn(__int2float_rn(__dp4a(xw, static_cast<int>(wv.w), acc_dw[4 * q + 3])), d.w)));
          }
          v = make_uint4(words[0], words[1], words[2], words[3]);
        }
        *reinterpret_cast<uint4*>(a_s + slot * kResSlot + mma_chunk_addr(row, grp)) = v;
      }
    };

    // the first footprint's copies, then both weights (the 1x1's, and the
    // depthwise ones and dm) while they fly, before the first chunk is
    // produced
    if (total > 0) stage_fp(0);
    cp_async_commit();
    stage_weights();
    for (int ch = tid; ch < cpad; ch += kResThreads) {
      uint32_t wd[9];
#pragma unroll
      for (int t = 0; t < 9; ++t)
        wd[t] = ch < cin ? static_cast<uint8_t>(dw[t * cin + ch]) : 0u;
      dw_s[ch] = wd[0] | wd[1] << 8 | wd[2] << 16 | wd[3] << 24;
      dw_s[cpad + ch] = wd[4] | wd[5] << 8 | wd[6] << 16 | wd[7] << 24;
      dw_s[2 * cpad + ch] = wd[8] << (8 * (ch & 3));
      dm_s[ch] = ch < cin ? dm[ch] : 0.f;
    }
    if (tid < kResBN) {
      mc_s[tid] = n0 + tid < cout ? m[n0 + tid] : 0.f;
      mc_s[kResBN + tid] = n0 + tid < cout ? c[n0 + tid] : 0.f;
    }
    if (kMode == 1 && total > 0) load_res(bx);  // the first tile's residual
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (total > 0) produce(0, 0);
    __syncthreads();
    if (total > 1) stage_fp(1);
    cp_async_commit();

    // Chunk q: produce chunk q + 1 from its footprint (landed), free the
    // footprint, send chunk q + 2's copies, then chunk q's MMAs while they
    // fly.  The first barrier also orders the MMAs of chunk q - 1 and an
    // epilogue's reads of o_s and r_s before the slot, o_s and r_s are
    // written again.  Mode 1's residual copies (the first tile's with the
    // first footprint) are a group of their own, sent before the
    // footprint's, and waited for (not the footprint) before the epilogue.
    int kc = 0, tile_i = 0;
    for (int q = 0; q < total; ++q) {
      cp_async_wait<0>();
      __syncthreads();  // chunk q produced, chunk q + 1's footprint landed
      if (kMode == 1 && kc == 0 && q > 0) load_res(bx + tile_i * gridDim.x);
      cp_async_commit();
      if (q + 1 < total) produce((q + 1) % kResStages, q + 1);
      __syncthreads();  // the footprint is free
      if (q + 2 < total) stage_fp(q + 2);
      cp_async_commit();
      compute(q % kResStages, kc);
      if (++kc == nk) {
        if (kMode == 1) {
          cp_async_wait<1>();  // the residual; chunk q + 2's footprint may fly
          __syncthreads();
        }
        epilogue(bx + tile_i * gridDim.x);
        kc = 0;
        ++tile_i;
      }
    }
    cp_async_wait<0>();
    return;
  }

  if constexpr (kRing) {
#pragma unroll
    for (int s = 0; s < kResStages - 1; ++s) {
      if (s < total) load_chunk(s);
      cp_async_commit();
    }
  }
  stage_weights();  // while the first A chunks load

  // One flat walk over this block's (tile, chunk) pairs: chunk q's copies
  // are issued kResStages - 1 chunks ahead, across tile boundaries; mode 3
  // quantizes the tile's footprint at its first chunk instead.  The
  // barrier of each step also orders an epilogue's reads of o_s and r_s
  // before the next tile's residual copies and epilogue writes, and the
  // MMAs of a tile's last chunk before its footprint is written again; the
  // residual copies join the group of the tile's first step, which is
  // complete before its epilogue when the tile has at least kResStages
  // chunks (every 3x3 tile: 9 or more); a 1x1 tile of fewer chunks waits
  // for its residual (and the next chunk) before its epilogue.
  static_assert(kResStages <= 9, "a 3x3 tile's residual lands before its epilogue");
  int kc = 0, tile_i = 0;
  for (int q = 0; q < total; ++q) {
    cp_async_wait<kResStages - 2>();
    __syncthreads();  // chunk q staged (and the weights); chunk q - 1's readers done
    if constexpr (kMode == 3) {
      if (kc == 0) {  // the tile's footprint, once for its taps
        const Org o = tile_org(bx + tile_i * gridDim.x);
        quantize_footprint<kResThreads>(fp_s, fp, xv, x_bf16, s_in, o.b, h, w, cin, 0,
                                        o.oy0 * stride - pad, o.ox0 * stride - pad);
        __syncthreads();
      }
    }
    if (kMode == 1 && kc == 0) load_res(blockIdx.x + tile_i * gridDim.x);
    if (kRing && q + kResStages - 1 < total) load_chunk((q + kResStages - 1) % kResStages);
    cp_async_commit();
    compute(q % kResStages, kc);
    if (++kc == nk) {
      if (kMode == 1 && kTaps == 1 && nk < kResStages) {
        cp_async_wait<0>();
        __syncthreads();
      }
      epilogue(blockIdx.x + tile_i * gridDim.x);
      kc = 0;
      ++tile_i;
    }
  }
  cp_async_wait<0>();
}

// Dynamic shared memory of a resident launch (res_smem_layout).
size_t conv_mma_res_smem_bytes(int cin, int taps, int mode, bool f32, bool sep, int stride,
                               int dil) {
  int off[6];
  res_smem_layout(cin, taps, mode, f32, sep, stride, dil, off);
  return static_cast<size_t>(off[5]);
}

// ---------------------------------------------------------------------------
// K10: standalone 3x3 stride-2 pad-1 max pool on NHWC int8 codes.
//
// Replaces torchseg_tpu/ops/pallas/int8_serve_kernels.py:1308
// maxpool2d_3x3s2_i8 (_maxpool_kernel at :1271), the pool after the deep
// stem of the dilated Bottleneck body (deploy/int8_serve.py:758).
//
// What it computes: out (ceil(h/2), ceil(w/2), C) = the max over each 3x3
// window at stride 2, with the pad at -128 (XLA's s8 reduce-window
// identity, int8_serve.py:1026-1029), so it is exact for any code: the
// window's centre is always a real element.  The Pallas kernel assumes
// non-negative codes, h % 8 == 0 and computes in bf16 over a width-paired
// view; none of that is needed here.
//
// What bounds it: bytes.  It reads h*w*C and writes a quarter of that (9.2
// MB at (240, 240, 128), 2.75 us at 3.35 TB/s) and does eight byte maxes an
// output.  Two routes, picked on the host (maxpool_i8_route):
//
//   16-byte (C % 16 == 0, x and out on 16-byte boundaries; PSPNet's C =
//   128): a thread owns one 16-byte piece of channels of one output column
//   and walks kPoolRows consecutive output rows.  For output row oy it takes
//   the horizontal max of the three taps (columns 2ox-1, 2ox, 2ox+1) of
//   input rows 2oy and 2oy+1, and the vertical max with the horizontal max
//   of row 2oy-1, carried from the step before.  So each input row is
//   fetched once a strip (its first row, 2oy-1, by the strip above as
//   well), and only the one-column horizontal overlap is read again, from
//   L1.  Neighbouring lanes take neighbouring pieces, then neighbouring
//   output columns: a warp's loads and stores are runs of contiguous bytes.
//   The grid is 2-D (x: pieces of a row of output columns, y: strips),
//   which leaves one 32-bit divide a thread.
//
//   4-byte (any other C % 4 == 0, or x or out off a 16-byte boundary, such
//   as a channel-sliced view): one thread per four channels of an output
//   pixel, nine 4-byte loads.
//
// The pad: a tap past an edge (input row -1, column -1, and row or column
// h or w where that is odd) reads the edge row or column instead, which is
// in the same window, so the max is the -128-padded one bit for bit and
// every load is unconditional: a load predicated on the edge, with -128
// preset in its registers, makes ptxas hold each row's loads back until
// the row before has arrived (1.2x slower at kPoolRows = 4 on an H100).
// Index math is 32-bit: the wrapper refuses an input of 2^31 codes or
// more.  The maxes are __vmaxs4, four signed byte maxes at once.  On an
// H100 (700 W) it takes ~0.005 ms at PSPNet's shape, where PyTorch's copy
// of the same 9.2 MB takes 0.0046; strips of 1, 2 or 4 rows, 256-thread
// blocks, a persistent grid and an L2 prefetch of the strip's rows were
// all within noise of it (scripts/torch_int8_kernel_variants.py
// --k10-only).
// ---------------------------------------------------------------------------

constexpr int kPoolRows = 2;        // output rows a thread walks (16-byte route)
constexpr int kPoolThreads = 128;   // threads a block, 16-byte route
constexpr int kPool4Threads = 256;  // threads a block, 4-byte route

__device__ __forceinline__ uint4 vmax16(uint4 a, uint4 b) {
  return make_uint4(__vmaxs4(a.x, b.x), __vmaxs4(a.y, b.y), __vmaxs4(a.z, b.z),
                    __vmaxs4(a.w, b.w));
}

// the horizontal max of a row's three taps
__device__ __forceinline__ uint4 row_max16(const uint4 (&t)[3]) {
  return vmax16(t[0], vmax16(t[1], t[2]));
}

// The window's first tap index on an axis of n elements at output o, and
// the last; an edge tap clamped onto the edge element (in the window).
__device__ __forceinline__ int tap_lo(int o) { return o > 0 ? 2 * o - 1 : 0; }
__device__ __forceinline__ int tap_hi(int o, int n) {
  return 2 * o + 1 < n ? 2 * o + 1 : 2 * o;
}

__global__ void __launch_bounds__(kPoolThreads)
maxpool_i8_vec16_kernel(const uint4* __restrict__ x, int h, int w, int c16,
                        uint4* __restrict__ out, int ho, int wo) {
  const int t = blockIdx.x * kPoolThreads + threadIdx.x;  // piece + c16 * ox
  if (t >= wo * c16) return;
  const int ox = t / c16;
  const int piece = t - ox * c16;
  const int cols[3] = {tap_lo(ox) * c16 + piece, 2 * ox * c16 + piece,
                       tap_hi(ox, w) * c16 + piece};
  const int pitch = w * c16;  // 16-byte pieces an input row
  const int oy0 = blockIdx.y * kPoolRows;
  // the taps of input rows 2*oy0 - 1 + k, k = 0 .. 2R (clamped to the
  // image: a clamped row serves only a window that holds it, or an output
  // row past ho)
  uint4 v[2 * kPoolRows + 1][3];
#pragma unroll
  for (int k = 0; k <= 2 * kPoolRows; ++k) {
    const int iy = 2 * oy0 - 1 + k;
    const uint4* row = x + (iy < 0 ? 0 : (iy < h ? iy : h - 1)) * pitch;
#pragma unroll
    for (int j = 0; j < 3; ++j) v[k][j] = __ldg(row + cols[j]);
  }
  uint4 carry = row_max16(v[0]);  // row 2oy - 1
#pragma unroll
  for (int r = 0; r < kPoolRows; ++r) {
    const uint4 a = row_max16(v[2 * r + 1]), b = row_max16(v[2 * r + 2]);
    const int oy = oy0 + r;
    if (oy < ho)
      out[(oy * wo + ox) * c16 + piece] = vmax16(carry, vmax16(a, b));
    carry = b;
  }
}

__global__ void __launch_bounds__(kPool4Threads)
maxpool_i8_kernel(const unsigned int* __restrict__ x, int h, int w, int c4,
                  unsigned int* __restrict__ out, int ho, int wo) {
  const int i = blockIdx.x * kPool4Threads + threadIdx.x;
  if (i >= ho * wo * c4) return;
  const int p = i / c4, ch = i - p * c4;
  const int oy = p / wo, ox = p - oy * wo;
  const int rows[3] = {tap_lo(oy), 2 * oy, tap_hi(oy, h)};
  const int cols[3] = {tap_lo(ox), 2 * ox, tap_hi(ox, w)};
  unsigned int v[3][3];
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
      v[dy][dx] = __ldg(x + (rows[dy] * w + cols[dx]) * c4 + ch);
  unsigned int mx = v[0][0];
#pragma unroll
  for (int k = 1; k < 9; ++k) mx = __vmaxs4(mx, v[k / 3][k % 3]);
  out[i] = mx;
}

// ---------------------------------------------------------------------------
// K14: the int8 3x3 depthwise conv of the Xception39 body's separable convs
// (dwconv3x3_i8_kernel).  It replaces no TPU kernel: JAX runs it as an XLA
// conv (deploy/int8_serve.py:961 _qconv_dw, feature_group_count = C), but
// every int8 conv of a served graph here is a hand-written launch, and
// PyTorch has no int8 depthwise conv on CUDA that gives int32 sums.
//
// What it computes: NHWC int8 codes x (h, w, C), HWIO weights (3, 3, 1,
// C), pad 1, stride 1 or 2, batch 1: y = the exact int32 sum of the nine
// taps of each channel, then q = clip(rint(y * dm), -127, 127) with the
// float32 per-channel dm (JAX's _requant(ydw * dm), :975-976: one float32
// multiply, no add, so nothing to contract; rintf rounds half to even).
//
// What bounds it on an H100: bytes.  Nine multiply-adds a code read, so
// ~9 operations a byte at stride 1, far below the ~590 int8 operations a
// byte of the card's balance; the largest call of the X39 body at 768x1536
// moves ~3.5 MB (~1 us at 3.35 TB/s), and a launch costs several us, so
// one launch a call and coalesced 16-byte accesses are what matter.
//
// Design: one thread an output pixel and 16 channels (C % 16 == 0);
// neighbouring threads take neighbouring 16-channel groups of a pixel, then
// neighbouring pixels, so each tap is a coalesced 16-byte load a thread
// (read-only path); the nine taps' 16 weights are 16-byte __ldg loads
// (the whole weight is 9 C bytes and stays in L1), the 16 sums are int32
// registers, and the codes leave in one 16-byte store.
// ---------------------------------------------------------------------------

constexpr int kDwThreads = 256;

// acc[4 q + b] += byte b of word q of x times byte b of word q of w, both
// signed
__device__ __forceinline__ void dw_mac16(int (&acc)[16], const uint4 xv,
                                         const uint4 wv) {
  const unsigned int xs[4] = {xv.x, xv.y, xv.z, xv.w};
  const unsigned int ws[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      acc[4 * q + b] += static_cast<int>(static_cast<int8_t>(xs[q] >> (8 * b))) *
                        static_cast<int>(static_cast<int8_t>(ws[q] >> (8 * b)));
}

__global__ void __launch_bounds__(kDwThreads)
dwconv3x3_i8_kernel(const int8_t* __restrict__ x, int h, int w, int c16,
                    const int8_t* __restrict__ wt, const float* __restrict__ dm,
                    int stride, int8_t* __restrict__ out, int ho, int wo) {
  const long long t = static_cast<long long>(blockIdx.x) * kDwThreads + threadIdx.x;
  if (t >= static_cast<long long>(ho) * wo * c16) return;
  const int g = static_cast<int>(t % c16);
  const long long p = t / c16;
  const int oy = static_cast<int>(p / wo), ox = static_cast<int>(p % wo);
  const uint4* x4 = reinterpret_cast<const uint4*>(x);
  const uint4* w4 = reinterpret_cast<const uint4*>(wt);
  int acc[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = 0;
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
    const int iy = oy * stride - 1 + ky;
    if (iy < 0 || iy >= h) continue;
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      const int ix = ox * stride - 1 + kx;
      if (ix < 0 || ix >= w) continue;
      dw_mac16(acc, __ldg(x4 + (static_cast<long long>(iy) * w + ix) * c16 + g),
               __ldg(w4 + (ky * 3 + kx) * c16 + g));
    }
  }
  const float4* dm4 = reinterpret_cast<const float4*>(dm) + 4 * g;
  unsigned int words[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 d = __ldg(dm4 + q);
    const float dv[4] = {d.x, d.y, d.z, d.w};
    unsigned int word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      word |= static_cast<unsigned int>(static_cast<uint8_t>(
                  requant(__fmul_rn(__int2float_rn(acc[4 * q + b]), dv[b]))))
              << (8 * b);
    words[q] = word;
  }
  reinterpret_cast<uint4*>(out)[p * c16 + g] = make_uint4(words[0], words[1], words[2],
                                                          words[3]);
}

// The conv window of a launch, from its kernel size and dilation (-1: no
// kernel takes it).
int window_of(int k, int dil) {
  if (k == 3 && dil >= 1) return dil == 1 ? kWin3 : kWinDil;
  return k == 1 && dil == 1 ? kWin1 : -1;
}

// The tensor-core conv instantiations, by (mode, window, float32 out):
// every window in mode 0 (a CBR); in modes 1 and 2 (a block's last conv)
// the 3x3 pad-1 window with codes out (K3-K6) and the 1x1 with either
// output (the Bottleneck's conv3), and in mode 1 the 3x3 pad-1 window with
// float32 out too (K6 as the last block of the bf16 decoder's body), on
// the streaming kernel; in mode 3 (the affine epilogue without ReLU, from
// float input) every window with float32 out, on both kernels; in mode 4
// (the separable projection) the 1x1 with codes out, unsplit, on the
// streaming kernel only; the separable window in modes 0 and 1 with
// either output, on the resident kernel only.  No other combination is
// compiled: its lookup gives null and the entry point returns
// cudaErrorInvalidValue.
using MmaKernel = void (*)(const void*, int, int, int, int, float, int,
                           const int8_t*, int, int, int, const float*, const float*,
                           const int8_t*, float, const int8_t*, int, int, int,
                           const int8_t*, const float*, const float*, void*, int, int);
using ResKernel = void (*)(const void*, int, int, int, int, int, int, float, int,
                           const int8_t*, const float*, const int8_t*, int, const float*,
                           const float*, const int8_t*, float, void*, int, int);

template <int kMode, int kSplit>
MmaKernel mma_kernel_of(int win, int f32) {
  if constexpr (kMode == 3) {  // the post-training int8 conv: float32 only
    if (!f32) return nullptr;
    if (win == kWin3) return conv_i8_mma_kernel<3, kSplit, kWin3, true>;
    if (win == kWin1) return conv_i8_mma_kernel<3, kSplit, kWin1, true>;
    if (win == kWinDil) return conv_i8_mma_kernel<3, kSplit, kWinDil, true>;
    return nullptr;
  }
  else if constexpr (kMode == 4) {  // the Xception block's sep3: a 1x1, unsplit
    if constexpr (kSplit == 1)
      if (win == kWin1 && !f32) return conv_i8_mma_kernel<4, 1, kWin1, false>;
    return nullptr;
  } else {
    if (win == kWin3 && !f32) return conv_i8_mma_kernel<kMode, kSplit, kWin3, false>;
    if constexpr (kMode == 1)  // K6 writing float32 (the bf16 decoder's body)
      if (win == kWin3) return conv_i8_mma_kernel<1, kSplit, kWin3, true>;
    if (win == kWin1)
      return f32 ? conv_i8_mma_kernel<kMode, kSplit, kWin1, true>
                 : conv_i8_mma_kernel<kMode, kSplit, kWin1, false>;
    if constexpr (kMode == 0) {
      if (win == kWin3) return conv_i8_mma_kernel<0, kSplit, kWin3, true>;
      if (win == kWinDil)
        return f32 ? conv_i8_mma_kernel<0, kSplit, kWinDil, true>
                   : conv_i8_mma_kernel<0, kSplit, kWinDil, false>;
    }
    return nullptr;
  }
}

template <int kSplit>
MmaKernel mma_kernel_split(int mode, int win, int f32) {
  return mode == 0   ? mma_kernel_of<0, kSplit>(win, f32)
         : mode == 1 ? mma_kernel_of<1, kSplit>(win, f32)
         : mode == 2 ? mma_kernel_of<2, kSplit>(win, f32)
         : mode == 3 ? mma_kernel_of<3, kSplit>(win, f32)
         : mode == 4 ? mma_kernel_of<4, kSplit>(win, f32)
                     : nullptr;
}

MmaKernel mma_kernel(int mode, int split, int win, int f32) {
  return split == 1   ? mma_kernel_split<1>(mode, win, f32)
         : split == 2 ? mma_kernel_split<2>(mode, win, f32)
                      : nullptr;
}

template <int kMode>
ResKernel res_kernel_of(int win, int f32) {
  if constexpr (kMode == 3) {  // the post-training int8 conv: float32 only
    if (!f32) return nullptr;
    if (win == kWin3) return conv_i8_mma_res_kernel<3, kWin3, true>;
    if (win == kWin1) return conv_i8_mma_res_kernel<3, kWin1, true>;
    if (win == kWinDil) return conv_i8_mma_res_kernel<3, kWinDil, true>;
    return nullptr;
  } else {
    if (win == kWinSep)
      return f32 ? conv_i8_mma_res_kernel<kMode, kWinSep, true>
                 : conv_i8_mma_res_kernel<kMode, kWinSep, false>;
    if (win == kWin3 && !f32) return conv_i8_mma_res_kernel<kMode, kWin3, false>;
    if (win == kWin1)
      return f32 ? conv_i8_mma_res_kernel<kMode, kWin1, true>
                 : conv_i8_mma_res_kernel<kMode, kWin1, false>;
    if constexpr (kMode == 0) {
      if (win == kWin3) return conv_i8_mma_res_kernel<0, kWin3, true>;
      if (win == kWinDil)
        return f32 ? conv_i8_mma_res_kernel<0, kWinDil, true>
                   : conv_i8_mma_res_kernel<0, kWinDil, false>;
    }
    return nullptr;
  }
}

ResKernel res_kernel(int mode, int win, int f32) {
  return mode == 0   ? res_kernel_of<0>(win, f32)
         : mode == 1 ? res_kernel_of<1>(win, f32)
         : mode == 3 ? res_kernel_of<3>(win, f32)
                     : nullptr;
}

// One launch of the resident-weight kernel: as many blocks as fit on the
// device at once, capped by the M tiles (2-D tiles where fp), times the N
// tiles.
int launch_res(ResKernel kernel, size_t smem, bool fp, const void* x, int batch, int h,
               int w, int cin, int stride, int dil, float s_in, int x_bf16, const void* dw,
               const void* dm, const void* wt, int cout, const void* m, const void* c,
               const void* res, float rr, void* out, void* stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kResThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ho = (h - 1) / stride + 1, wo = (w - 1) / stride + 1;
  const long long m_tiles =
      fp ? static_cast<long long>(batch) * ((ho + kResTR - 1) / kResTR) *
               ((wo + kFpTC - 1) / kFpTC)
         : (static_cast<long long>(batch) * ho * wo + kResBM - 1) / kResBM;
  const int n_tiles = (cout + kResBN - 1) / kResBN;
  long long gx = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms / n_tiles;
  gx = gx < 1 ? 1 : (gx > m_tiles ? m_tiles : gx);
  kernel<<<dim3(static_cast<unsigned>(gx), n_tiles), kResThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      x, batch, h, w, cin, stride, dil, s_in, x_bf16, static_cast<const int8_t*>(dw),
      static_cast<const float*>(dm), static_cast<const int8_t*>(wt), cout,
      static_cast<const float*>(m), static_cast<const float*>(c),
      static_cast<const int8_t*>(res), rr, out, ho, wo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Once per device, before the first launch on it: lets every kernel take
// up to the device's opt-in dynamic shared memory.  A launch that needs
// more fails, and its entry point returns that error (the wrappers check
// the smem_bytes entry points against tsg_smem_optin first).
int tsg_init(void) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto allow = [&](const void* fn) {
    return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  };
  err = allow(reinterpret_cast<const void*>(stem_pool_i8_mma_kernel));
  for (int mode = 0; mode < 5; ++mode)
    for (int win = 0; win < 4; ++win)
      for (int f32 = 0; f32 < 2; ++f32) {
        for (int split = 1; split <= 2; ++split)
          if (const MmaKernel fn = mma_kernel(mode, split, win, f32); fn && !err)
            err = allow(reinterpret_cast<const void*>(fn));
        if (const ResKernel fn = res_kernel(mode, win, f32); fn && !err)
          err = allow(reinterpret_cast<const void*>(fn));
      }
  return static_cast<int>(err);
}

// The current device's opt-in shared memory per block, in bytes (-1 on a
// CUDA error).
int tsg_smem_optin(void) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return optin;
}

// Dynamic shared memory of one tsg_stem_pool_i8 / tsg_conv_i8_mma launch.
long long tsg_stem_smem_bytes(int cout, int n_sp) {
  return static_cast<long long>(stem_smem_bytes(cout, n_sp));
}

// Dynamic shared memory of one tsg_conv_i8_mma launch in this mode, of
// this kernel size (1 or 3), stride and dilation (mode 3 stages a
// footprint; every other mode takes the same).
long long tsg_conv_mma_smem_bytes(int mode, int k, int stride, int dil) {
  return static_cast<long long>(conv_mma_smem_bytes(mode, k, stride, dil));
}

// Dynamic shared memory of one tsg_conv_i8_mma_res launch at this cin,
// kernel size (1 or 3), mode, output, stride and dilation, or (k = 0) of
// one tsg_sep_i8_mma_res launch.
long long tsg_conv_mma_res_smem_bytes(int cin, int k, int mode, int out_f32, int stride,
                                      int dil) {
  return static_cast<long long>(conv_mma_res_smem_bytes(
      cin, k == 0 ? 1 : k * k, mode, out_f32 != 0, k == 0, stride, k == 0 ? 1 : dil));
}

// xs (h2+3, w2+3, cin) int8, 4-byte aligned, cin <= 16, cin % 4 == 0;
// cout <= 128, n_sp and cout - n_sp multiples of 16; h2, w2 even.
int tsg_stem_pool_i8(const void* xs, const void* wf, const void* m,
                     const void* c, void* sp, void* pooled, int h2, int w2,
                     int cin, int cout, int n_sp, void* stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // bands of pooled rows: about one block per SM (one fits an SM)
  const int ph = h2 / 2;
  const int strips = (w2 / 2 + kStemPC - 1) / kStemPC;
  const int target = sms / strips < 1 ? 1 : (sms / strips < ph ? sms / strips : ph);
  const int band = (ph + target - 1) / target;
  dim3 grid(strips, (ph + band - 1) / band);
  stem_pool_i8_mma_kernel<<<grid, kStemThreads, stem_smem_bytes(cout, n_sp),
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xs), static_cast<const uint16_t*>(wf),
      static_cast<const float*>(m), static_cast<const float*>(c),
      static_cast<int8_t*>(sp), static_cast<int8_t*>(pooled), h2, w2, cin,
      cout, n_sp, band);
  return static_cast<int>(cudaGetLastError());
}

// The int8 conv on tensor cores, the weights streamed: x (batch, h, w,
// cin) int8 codes (mode 3: float32 values, or bf16 with x_bf16 != 0,
// quantized by s_in as the kernel stages them), cin % 16 == 0, 16-byte
// aligned, batch 1 in modes 2 and 4; weights (k, k, cin, cout) with k = 3
// (pad = dil) or k = 1 (pad 0, dil 1); any stride; cout % 8 == 0; mode
// 2's and mode 4's xd (hd, wd, cdin) with cdin % 16 == 0, 16-byte aligned;
// out (ho, wo, cout) int8 codes, or float32 values with out_f32 != 0 (in
// mode 2 only for k = 1, in mode 1 for k = 1 or the 3x3 pad 1, dil > 1 only
// in modes 0 and 3, mode 3 float32 only, mode 4 k = 1 with codes out and
// split 1: see mma_kernel_of).  split: the blocks of a cluster that share
// a tile's K walk, 1 or 2 (any mode but 4; in mode 2 the first block
// takes the projection's chunks), or 0: 2 where the launch has no more
// tiles than the device has SMs, else 1.  Mode 3's tiles are kMmaTR x
// kFpTC output pixels of one image.
int tsg_conv_i8_mma(const void* x, int batch, int h, int w, int cin, float s_in,
                    int x_bf16, const void* wt, int k, int stride, int dil, int cout,
                    const void* m, const void* c, int mode, const void* res, float rr,
                    const void* xd, int wd, int cdin, int sd, const void* wdt,
                    const void* md, const void* cd, void* out, int out_f32, int ho, int wo,
                    int split, void* stream) {
  if (batch < 1 || ((mode == 2 || mode == 4) && batch != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long m_tiles =
      mode == 3 ? static_cast<long long>(batch) * ((ho + kMmaTR - 1) / kMmaTR) *
                      ((wo + kFpTC - 1) / kFpTC)
                : (static_cast<long long>(batch) * ho * wo + kMmaBM - 1) / kMmaBM;
  const int n_tiles = (cout + kMmaBN - 1) / kMmaBN;
  if (split == 0) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    split = m_tiles * n_tiles <= sms ? 2 : 1;
  }
  const MmaKernel kernel = mma_kernel(mode, split, window_of(k, dil), out_f32 != 0);
  if (!kernel || stride < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(m_tiles * split), n_tiles);
  cfg.blockDim = dim3(kMmaThreads);
  cfg.dynamicSmemBytes = conv_mma_smem_bytes(mode, k, stride, dil);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, x, batch, h, w, cin, s_in, x_bf16, static_cast<const int8_t*>(wt), stride,
      dil, cout, static_cast<const float*>(m), static_cast<const float*>(c),
      static_cast<const int8_t*>(res), rr, static_cast<const int8_t*>(xd), wd, cdin, sd,
      static_cast<const int8_t*>(wdt), static_cast<const float*>(md),
      static_cast<const float*>(cd), out, ho, wo);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// The int8 conv on tensor cores with resident weights (K3's and K2's
// links; cbr_i8's, bottleneck_i8's and conv_i8_affine's up to 64 input
// channels): x (batch, h, w, cin) int8 codes (mode 3: float32 or bf16
// values quantized by s_in as the kernel stages them, cin <= 64), cin %
// 16 == 0, 16-byte aligned; weights (k, k, cin, cout) with k = 3 (pad =
// dil) or k = 1 (pad 0, dil 1); stride 1 or 2; cout % 8 == 0; mode 0, 1
// (res (batch, ho, wo, cout), 8-byte aligned) or 3 (float32 out only); out
// (batch, ho, wo, cout) int8 codes, or float32 values with out_f32 != 0
// (as tsg_conv_i8_mma).
int tsg_conv_i8_mma_res(const void* x, int batch, int h, int w, int cin, float s_in,
                        int x_bf16, const void* wt, int k, int stride, int dil, int cout,
                        const void* m, const void* c, int mode, const void* res, float rr,
                        void* out, int out_f32, void* stream) {
  const ResKernel kernel = res_kernel(mode, window_of(k, dil), out_f32 != 0);
  if (!kernel || batch < 1 || (stride != 1 && stride != 2) || (mode == 3 && cin > kMmaBK))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_res(kernel,
                    conv_mma_res_smem_bytes(cin, k * k, mode, out_f32 != 0, false, stride, dil),
                    mode == 3, x, batch, h, w, cin, stride, dil, s_in, x_bf16, nullptr,
                    nullptr, wt, cout, m, c, res, rr, out, stream);
}

// The fused separable conv (the resident kernel's separable window): x (h,
// w, cin) int8 codes, cin % 16 == 0, 16-byte aligned; dw (3, 3, 1, cin)
// int8 and dm (cin) float32, the 3x3 pad-1 depthwise conv at stride 1 or 2
// and its requant; wt (1, 1, cin, cout), cout % 8 == 0, the 1x1 at stride
// 1 on the depthwise output; mode 0 or 1 (res (ho, wo, cout), 8-byte
// aligned); out (ho, wo, cout) int8 codes, or float32 with out_f32 != 0.
int tsg_sep_i8_mma_res(const void* x, int h, int w, int cin, const void* dw,
                       const void* dm, int stride, const void* wt, int cout,
                       const void* m, const void* c, int mode, const void* res,
                       float rr, void* out, int out_f32, void* stream) {
  const ResKernel kernel = res_kernel(mode, kWinSep, out_f32 != 0);
  if (!kernel || (stride != 1 && stride != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_res(kernel,
                    conv_mma_res_smem_bytes(cin, 1, mode, out_f32 != 0, true, stride, 1), true,
                    x, 1, h, w, cin, stride, 1, 0.f, 0, dw, dm, wt, cout, m, c, res, rr, out,
                    stream);
}

// x (h, w, C) int8 -> out (ho, wo, C) int8, C % 4 == 0, fewer than 2^31
// codes.  route 16: C % 16 == 0 and x, out on 16-byte boundaries (the
// 16-byte kernel); route 4: on 4-byte boundaries (the 4-byte kernel).
int tsg_maxpool_i8(const void* x, int h, int w, int c, void* out, int ho,
                   int wo, int route, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 4) {
    const int n = ho * wo * (c / 4);
    const int blocks = (n + kPool4Threads - 1) / kPool4Threads;
    maxpool_i8_kernel<<<blocks, kPool4Threads, 0, s>>>(
        static_cast<const unsigned int*>(x), h, w, c / 4,
        static_cast<unsigned int*>(out), ho, wo);
    return static_cast<int>(cudaGetLastError());
  }
  if (route != 16 || c % 16) return static_cast<int>(cudaErrorInvalidValue);
  const int c16 = c / 16;
  const dim3 grid((wo * c16 + kPoolThreads - 1) / kPoolThreads,
                  (ho + kPoolRows - 1) / kPoolRows);
  maxpool_i8_vec16_kernel<<<grid, kPoolThreads, 0, s>>>(
      static_cast<const uint4*>(x), h, w, c16, static_cast<uint4*>(out), ho,
      wo);
  return static_cast<int>(cudaGetLastError());
}

// K14: x (h, w, c) int8 codes, c % 16 == 0, wt (3, 3, 1, c) int8, dm (c)
// float32, all three and out (ho, wo, c) 16-byte aligned; pad 1, stride 1
// or 2.
int tsg_dwconv3x3_i8(const void* x, int h, int w, int c, const void* wt,
                     const void* dm, int stride, void* out, int ho, int wo,
                     void* stream) {
  if (c % 16 || (stride != 1 && stride != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(ho) * wo * (c / 16);
  const int blocks = static_cast<int>((n + kDwThreads - 1) / kDwThreads);
  dwconv3x3_i8_kernel<<<blocks, kDwThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), h, w, c / 16, static_cast<const int8_t*>(wt),
      static_cast<const float*>(dm), stride, static_cast<int8_t*>(out), ho, wo);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
