// Hand-written Hopper (sm_90a) kernels for the int8-through serving graphs
// (BiSeNet-R18 and the dilated Bottleneck body of PSPNet).  Python side:
// torchseg_tpu_torch/ops/kernels/int8_serve_kernels.py (wrappers, shape
// checks, plain PyTorch versions).
//
// Five kernels, nine entry points of the serving graphs:
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
//                         the last block of the body writes float32.
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
//                         (sp3, stem2/stem3, layer1's).
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
  // z is post-ReLU (>= 0); clip(round(z), -127, 127)
  float q = fmaxf(fminf(rintf(z), 127.f), -127.f);
  return static_cast<int8_t>(static_cast<int>(q));
}

// Two requantized codes as the little-endian 16-bit word of adjacent bytes.
__device__ __forceinline__ uint16_t pack2(int8_t lo, int8_t hi) {
  return static_cast<uint16_t>(static_cast<uint8_t>(lo) |
                               (static_cast<uint16_t>(static_cast<uint8_t>(hi)) << 8));
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
// d (kWinDil), or 1x1 pad 0 (kWin1), at any stride; then one of three
// epilogues, all ending in ReLU and either the requant to int8 codes or
// (kF32) the float32 value itself:
//   mode 0 (CBR):        z = fma(y, m, c)
//   mode 1 (identity):   z = fma(res, rr, fma(y, m, c)), res (ho, wo, cout)
//   mode 2 (projection): z = fma(yd, md, fma(y, m, c)) + cd, with
//        yd = 1x1/sd conv of the block input xd (hd, wd, cdin) by wd,
//        a second GEMM into its own int32 accumulators.
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

// The window of a tensor-core conv (a template parameter of both kernels):
// 3x3 pad 1 (K2-K6), 3x3 with dilation d and pad d, or 1x1 pad 0.
constexpr int kWin3 = 0, kWinDil = 1, kWin1 = 2;

// Byte offset of 16-byte chunk `chunk` of tile row `row` (64-byte rows).
// ldmatrix reads 8 consecutive rows (r % 8 == 0) at one chunk; the
// transposed B stores write rows 4i + q (i = 0..7) at one chunk: the XOR of
// bits 1-2 and 3-4 of the row spreads both over the banks.
__device__ __forceinline__ int mma_chunk_addr(int row, int chunk) {
  return row * kMmaBK + ((chunk ^ (((row >> 1) ^ (row >> 3)) & 3)) << 4);
}

template <int kMode, int kSplit, int kWin, bool kF32>
__global__ void __launch_bounds__(kMmaThreads, 512 / kMmaThreads)
conv_i8_mma_kernel(const int8_t* __restrict__ x, int h, int w, int cin,
                   const int8_t* __restrict__ wt, int stride, int dilation,
                   int cout, const float* __restrict__ m,
                   const float* __restrict__ c, const int8_t* __restrict__ res,
                   float rr, const int8_t* __restrict__ xd, int wd_, int cdin,
                   int sd, const int8_t* __restrict__ wdt,
                   const float* __restrict__ md, const float* __restrict__ cd,
                   void* __restrict__ out, int ho, int wo) {
  constexpr int kTaps = kWin == kWin1 ? 1 : 9;  // the projection is "tap" kTaps
  const int dil = kWin == kWinDil ? dilation : 1;
  const int pad = kWin == kWin1 ? 0 : dil;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t s_base = smem_addr(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_pix = ho * wo;
  const int m0 = blockIdx.x / kSplit * kMmaBM;
  const int n0 = blockIdx.y * kMmaBN;
  const int rank = blockIdx.x % kSplit;          // rank in the K-split cluster
  const int cch = (cin + kMmaBK - 1) / kMmaBK;   // chunks per tap
  const int n_main = kTaps * cch;
  const int n_proj = kMode == 2 ? (cdin + kMmaBK - 1) / kMmaBK : 0;
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
    if (p < n_pix) {
      const int oy = p / wo, ox = p % wo;
      const int iy0 = oy * stride - pad, ix0 = ox * stride - pad;
      for (int t = 0; t < kTaps; ++t) {
        const int iy = iy0 + t / 3 * dil, ix = ix0 + t % 3 * dil;
        if (iy >= 0 && iy < h && ix >= 0 && ix < w) a_mask[i] |= 1 << t;
      }
      a_mask[i] |= 1 << 9;  // the pixel exists: its projection row is read
      a_off[i] = (static_cast<long long>(iy0) * w + ix0) * cin;
      if (kMode == 2) a_doff[i] = (static_cast<long long>(oy) * sd * wd_ + ox * sd) * cdin;
    }
  }

  // The chunk the next load_chunk call stages, walked without divisions:
  // tap-major over the window in channel chunks of kMmaBK, then (mode 2,
  // rank 0) the projection's channel chunks (tap kTaps).  Only a split
  // projection's rank 0 leaves the main walk early, after lead chunks.
  int ld_main = nk_main;   // main chunks still to stage
  int ld_tap = nk_main > 0 ? mc0 / cch : kTaps;
  int ld_c0 = nk_main > 0 ? mc0 % cch * kMmaBK : 0;
  auto next_chunk = [&]() {
    if (kMode == 2 && kSplit > 1 && ld_tap < kTaps && --ld_main == 0) {
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

  // Stage the chunk (ld_tap, ld_c0): its A rows by cp.async into `slot`,
  // its B words into registers; then advance to the next chunk.
  auto load_chunk = [&](int slot, uint32_t (&breg)[kMmaBBlocks][4]) {
    const bool proj = kMode == 2 && ld_tap == kTaps;
    const int ch = ld_c0 + a_col * 16;
    const int8_t* a_src =
        proj ? xd + ch
             : x + (kTaps == 1 ? 0 : (ld_tap / 3 * w + ld_tap % 3) *
                                         static_cast<long long>(dil * cin)) + ch;
    const bool ch_ok = ch < (proj ? cdin : cin);
#pragma unroll
    for (int i = 0; i < kMmaARows; ++i) {
      const bool ok = ch_ok && ((a_mask[i] >> (proj ? 9 : ld_tap)) & 1);
      const int row = (tid >> 2) + (kMmaThreads / 4) * i;
      cp_async16(s_base + slot * kMmaSlot + mma_chunk_addr(row, a_col),
                 ok ? a_src + (proj ? a_doff[i] : a_off[i]) : x, ok ? 16 : 0);
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
    unsigned char* b_s = smem + slot * kMmaSlot + kMmaBM * kMmaBK;
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

  auto compute = [&](int slot, int (&sum)[2][4][4]) {
    const uint32_t a_s = s_base + slot * kMmaSlot;
    const uint32_t b_s = a_s + kMmaBM * kMmaBK;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = wm * 32 + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(a_s + mma_chunk_addr(row, ks * 2 + (lane >> 4)), af[i][0], af[i][1],
                    af[i][2], af[i][3]);
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
    cp_async_wait<kMmaStages - 2>();
    __syncthreads();  // chunk kc staged; everyone is done with chunk kc - 1
    const int nxt = kc + kMmaStages - 1;
    if (nxt < nk) load_chunk(nxt % kMmaStages, ld);
    cp_async_commit();
    if (kMode == 2 && kc >= nk_main)
      compute(kc % kMmaStages, accd);
    else
      compute(kc % kMmaStages, acc);
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
      if (kMode == 2) {
        mdv[e] = md[n + e];
        cdv[e] = cd[n + e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int ml = wm * 32 + i * 16 + g + 8 * hh;
        const int p = m0 + ml;
        if (p >= n_pix) continue;
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
          }
          z[e] = fmaxf(z[e], 0.f);
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
      const int p = m0 + row;
      if (p >= n_pix || n >= cout) continue;
      *reinterpret_cast<float4*>(outf + static_cast<size_t>(p) * cout + n) =
          *reinterpret_cast<const float4*>(o_f + row * kMmaOutPitchF + (n - n0));
    }
    return;
  }
  int8_t* outq = static_cast<int8_t*>(out);
  for (int idx = tid; idx < kMmaBM * (kMmaBN / 16); idx += kMmaThreads) {
    const int row = idx / (kMmaBN / 16), n = n0 + (idx % (kMmaBN / 16)) * 16;
    const int p = m0 + row;
    if (p >= n_pix || n >= cout) continue;
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

size_t conv_mma_smem_bytes() {
  const size_t ring = static_cast<size_t>(kMmaStages) * kMmaSlot;
  const size_t out = static_cast<size_t>(kMmaBM) * kMmaOutPitch;
  return ring > out ? ring : out;
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
// What it computes: conv_i8_mma_kernel's modes 0 and 1 at stride 1 or 2
// (the same __fmaf_rn chain), for cin % 16 == 0 and cout % 8 == 0, over
// the same windows (kWin: 3x3 pad 1, 3x3 dilated, 1x1), int8 codes or
// (kF32) float32 values out.  Stride, dilation and window change only the
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

// Bytes of one resident weight row: taps x cin padded to 64-byte chunks,
// plus 16 so the row is an odd number of 16-byte chunks.
__host__ __device__ __forceinline__ int res_w_pitch(int cin, int taps) {
  return taps * ((cin + kMmaBK - 1) / kMmaBK) * kMmaBK + 16;
}

template <int kMode, int kWin, bool kF32>
__global__ void __launch_bounds__(kResThreads, 2)
conv_i8_mma_res_kernel(const int8_t* __restrict__ x, int h, int w, int cin,
                       int stride, int dilation, const int8_t* __restrict__ wt,
                       int cout, const float* __restrict__ m,
                       const float* __restrict__ c, const int8_t* __restrict__ res,
                       float rr, void* __restrict__ out, int ho, int wo) {
  constexpr int kTaps = kWin == kWin1 ? 1 : 9;
  const int dil = kWin == kWinDil ? dilation : 1;
  const int pad = kWin == kWin1 ? 0 : dil;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_pix = ho * wo;
  const int n0 = blockIdx.y * kResBN;
  const int cpad = (cin + kMmaBK - 1) / kMmaBK * kMmaBK;
  const int nk = kTaps * cpad / kMmaBK;   // chunks per tile
  const int pitch = res_w_pitch(cin, kTaps);
  const int m_tiles = (n_pix + kResBM - 1) / kResBM;
  const int my_tiles = (m_tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1;
  const int total = my_tiles * nk;    // chunks this block computes
  unsigned char* w_s = smem;                                     // [kResBN][pitch]
  const uint32_t w_base = smem_addr(w_s);
  const uint32_t a_base = w_base + kResBN * pitch;               // [stages][BM][64]
  int8_t* o_s = reinterpret_cast<int8_t*>(smem + kResBN * pitch +
                                          kResStages * kResSlot);  // [BM][kResOutPitch]
  const int8_t* r_s = o_s + kResBM * kResOutPitch;  // mode 1: [BM][kResOutPitch]

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
        const int oy = p / wo, ox = p - oy * wo;
        const int iy0 = oy * stride - pad, ix0 = ox * stride - pad;
#pragma unroll
        for (int t = 0; t < kTaps; ++t) {
          const int iy = iy0 + t / 3 * dil, ix = ix0 + t % 3 * dil;
          if (iy >= 0 && iy < h && ix >= 0 && ix < w) a_mask[i] |= 1 << t;
        }
        a_off[i] = (static_cast<long long>(iy0) * w + ix0) * cin;
      }
    }
  };
  setup_rows(blockIdx.x);

  // The load cursor: the ld_i-th of this block's tiles, tap, channel chunk.
  int ld_i = 0, ld_tap = 0, ld_c0 = 0;
  auto load_chunk = [&](int slot) {
    const int ch = ld_c0 + a_col * 16;
    const int8_t* src =
        x + static_cast<long long>(ld_tap / 3 * w + ld_tap % 3) * (dil * cin) + ch;
#pragma unroll
    for (int i = 0; i < kResARows; ++i) {
      const bool ok = ch < cin && ((a_mask[i] >> ld_tap) & 1);
      const int row = (tid >> 2) + (kResThreads / 4) * i;
      cp_async16(a_base + slot * kResSlot + mma_chunk_addr(row, a_col),
                 ok ? src + a_off[i] : x, ok ? 16 : 0);
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
#pragma unroll
  for (int s = 0; s < kResStages - 1; ++s) {
    if (s < total) load_chunk(s);
    cp_async_commit();
  }

  // The weights of channels n0 .. n0 + 63, K-major, while the first A
  // chunks load: each 4(k) x 4(n) byte block read as four words and
  // transposed with byte permutes.
  for (int i = tid; i < kTaps * cpad / 4 * (kResBN / 4); i += kResThreads) {
    const int nn = 4 * (i % (kResBN / 4)), kk = 4 * (i / (kResBN / 4));
    const int tap = kk / cpad, ch = kk - tap * cpad, n = n0 + nn;
    uint32_t v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)  // cin % 16 == 0, cout % 8 == 0: all four or none
      v[q] = ch < cin && n < cout
          ? __ldg(reinterpret_cast<const uint32_t*>(
                wt + (static_cast<long long>(tap) * cin + ch + q) * cout + n))
          : 0u;
    const uint32_t t0 = __byte_perm(v[0], v[1], 0x5140);
    const uint32_t t1 = __byte_perm(v[0], v[1], 0x7362);
    const uint32_t t2 = __byte_perm(v[2], v[3], 0x5140);
    const uint32_t t3 = __byte_perm(v[2], v[3], 0x7362);
    const uint32_t col[4] = {__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                             __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
#pragma unroll
    for (int q = 0; q < 4; ++q)
      *reinterpret_cast<uint32_t*>(w_s + (nn + q) * pitch + kk) = col[q];
  }

  const int wm = warp % kResWM, wn = warp / kResWM;
  constexpr int kJ = kResTN / 8;   // n8 tiles a warp
  int acc[2][kJ][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  auto compute = [&](int slot, int kc) {
    const uint32_t a_s = a_base + slot * kResSlot;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t af[2][4], bf[kJ][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = wm * 32 + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(a_s + mma_chunk_addr(row, ks * 2 + (lane >> 4)), af[i][0], af[i][1],
                    af[i][2], af[i][3]);
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

  // Mode 1: the residual tile (rows m0.., channels n0..n0+63) into r_s,
  // 8 bytes a copy (cout % 16 may be 8), zero past the edges.
  auto load_res = [&](int tile) {
    const int m0 = tile * kResBM;
    for (int idx = tid; idx < kResBM * kResBN / 8; idx += kResThreads) {
      const int row = idx / (kResBN / 8), col = 8 * (idx % (kResBN / 8));
      const bool ok = m0 + row < n_pix && n0 + col < cout;
      cp_async8(smem_addr(r_s + row * kResOutPitch + col),
                ok ? res + static_cast<size_t>(m0 + row) * cout + n0 + col : res,
                ok ? 8 : 0);
    }
  };

  // The tile's epilogue (conv_i8_mma_kernel's chain), then the sums reset.
  const int g = lane >> 2, t4 = lane & 3;
  auto epilogue = [&](int tile) {
    const int m0 = tile * kResBM;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int nl = wn * kResTN + j * 8 + 2 * t4;
      const int n = n0 + nl;
      if (n < cout) {   // cout % 8 == 0: n + 1 < cout too
        const float mv[2] = {__ldg(m + n), __ldg(m + n + 1)};
        const float cv[2] = {__ldg(c + n), __ldg(c + n + 1)};
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int ml = wm * 32 + i * 16 + g + 8 * hh;
            const int p = m0 + ml;
            if (p >= n_pix) continue;
            uint32_t rv = 0;
            if (kMode == 1) rv = *reinterpret_cast<const uint16_t*>(r_s + ml * kResOutPitch + nl);
            float z[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              z[e] = __fmaf_rn(__int2float_rn(acc[i][j][2 * hh + e]), mv[e], cv[e]);
              if (kMode == 1)
                z[e] = __fmaf_rn(static_cast<float>(static_cast<int8_t>(rv >> (8 * e))), rr,
                                 z[e]);
              z[e] = fmaxf(z[e], 0.f);
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
      const int p = m0 + row;
      if (p >= n_pix || n >= cout) continue;
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

  // One flat walk over this block's (tile, chunk) pairs: chunk q's copies
  // are issued kResStages - 1 chunks ahead, across tile boundaries.  The
  // barrier of each step also orders an epilogue's reads of o_s and r_s
  // before the next tile's residual copies and epilogue writes; the
  // residual copies join the group of the tile's first step, which is
  // complete before its epilogue when the tile has at least kResStages
  // chunks (every 3x3 tile: 9 or more); a 1x1 tile of fewer chunks waits
  // for its residual (and the next chunk) before its epilogue.
  static_assert(kResStages <= 9, "a 3x3 tile's residual lands before its epilogue");
  int kc = 0, tile_i = 0;
  for (int q = 0; q < total; ++q) {
    cp_async_wait<kResStages - 2>();
    __syncthreads();  // chunk q staged (and the weights); chunk q - 1's readers done
    if (kMode == 1 && kc == 0) load_res(blockIdx.x + tile_i * gridDim.x);
    if (q + kResStages - 1 < total) load_chunk((q + kResStages - 1) % kResStages);
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

size_t conv_mma_res_smem_bytes(int cin, int taps) {
  return static_cast<size_t>(kResBN) * res_w_pitch(cin, taps) +
         static_cast<size_t>(kResStages) * kResSlot +
         2 * static_cast<size_t>(kResBM) * kResOutPitch;
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

// The conv window of a launch, from its kernel size and dilation (-1: no
// kernel takes it).
int window_of(int k, int dil) {
  if (k == 3 && dil >= 1) return dil == 1 ? kWin3 : kWinDil;
  return k == 1 && dil == 1 ? kWin1 : -1;
}

// The tensor-core conv instantiations, by (mode, window, float32 out):
// every window in mode 0 (a CBR); in modes 1 and 2 (a block's last conv)
// the 3x3 pad-1 window with codes out (K3-K6) and the 1x1 with either
// output (the Bottleneck's conv3).  No other combination is compiled: its
// lookup gives null and the entry point returns cudaErrorInvalidValue.
using MmaKernel = void (*)(const int8_t*, int, int, int, const int8_t*, int, int, int,
                           const float*, const float*, const int8_t*, float,
                           const int8_t*, int, int, int, const int8_t*,
                           const float*, const float*, void*, int, int);
using ResKernel = void (*)(const int8_t*, int, int, int, int, int, const int8_t*, int,
                           const float*, const float*, const int8_t*, float, void*,
                           int, int);

template <int kMode, int kSplit>
MmaKernel mma_kernel_of(int win, int f32) {
  if (win == kWin3 && !f32) return conv_i8_mma_kernel<kMode, kSplit, kWin3, false>;
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

template <int kSplit>
MmaKernel mma_kernel_split(int mode, int win, int f32) {
  return mode == 0   ? mma_kernel_of<0, kSplit>(win, f32)
         : mode == 1 ? mma_kernel_of<1, kSplit>(win, f32)
         : mode == 2 ? mma_kernel_of<2, kSplit>(win, f32)
                     : nullptr;
}

MmaKernel mma_kernel(int mode, int split, int win, int f32) {
  return split == 1   ? mma_kernel_split<1>(mode, win, f32)
         : split == 2 ? mma_kernel_split<2>(mode, win, f32)
                      : nullptr;
}

template <int kMode>
ResKernel res_kernel_of(int win, int f32) {
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

ResKernel res_kernel(int mode, int win, int f32) {
  return mode == 0 ? res_kernel_of<0>(win, f32) : mode == 1 ? res_kernel_of<1>(win, f32)
                                                            : nullptr;
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
  for (int mode = 0; mode < 3; ++mode)
    for (int win = 0; win < 3; ++win)
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

long long tsg_conv_mma_smem_bytes(void) {
  return static_cast<long long>(conv_mma_smem_bytes());
}

// Dynamic shared memory of one tsg_conv_i8_mma_res launch at this cin and
// kernel size (1 or 3).
long long tsg_conv_mma_res_smem_bytes(int cin, int k) {
  return static_cast<long long>(conv_mma_res_smem_bytes(cin, k * k));
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

// The int8 conv on tensor cores, the weights streamed: x (h, w, cin), cin
// % 16 == 0, 16-byte aligned; weights (k, k, cin, cout) with k = 3 (pad =
// dil) or k = 1 (pad 0, dil 1); any stride; cout % 8 == 0; mode 2's xd
// (hd, wd, cdin) with cdin % 16 == 0, 16-byte aligned; out (ho, wo, cout)
// int8 codes, or float32 values with out_f32 != 0 (in modes 1 and 2 only
// for k = 1, and dil > 1 only in mode 0: see mma_kernel_of).  split: the
// blocks of a cluster that share a tile's K walk, 1 or 2 (any mode; in
// mode 2 the first block takes the projection's chunks), or 0: 2 where
// the launch has no more tiles than the device has SMs, else 1.
int tsg_conv_i8_mma(const void* x, int h, int w, int cin, const void* wt, int k,
                    int stride, int dil, int cout, const void* m, const void* c,
                    int mode, const void* res, float rr, const void* xd,
                    int wd, int cdin, int sd, const void* wdt, const void* md,
                    const void* cd, void* out, int out_f32, int ho, int wo,
                    int split, void* stream) {
  const int m_tiles = (ho * wo + kMmaBM - 1) / kMmaBM;
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
  cfg.gridDim = dim3(m_tiles * split, n_tiles);
  cfg.blockDim = dim3(kMmaThreads);
  cfg.dynamicSmemBytes = conv_mma_smem_bytes();
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const int8_t*>(x), h, w, cin,
      static_cast<const int8_t*>(wt), stride, dil, cout, static_cast<const float*>(m),
      static_cast<const float*>(c), static_cast<const int8_t*>(res), rr,
      static_cast<const int8_t*>(xd), wd, cdin, sd, static_cast<const int8_t*>(wdt),
      static_cast<const float*>(md), static_cast<const float*>(cd), out, ho, wo);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// The int8 conv on tensor cores with resident weights (K3's and K2's
// links; cbr_i8's and bottleneck_i8's up to 64 input channels): x (h, w,
// cin), cin % 16 == 0, 16-byte aligned; weights (k, k, cin, cout) with k =
// 3 (pad = dil) or k = 1 (pad 0, dil 1); stride 1 or 2; cout % 8 == 0;
// mode 0 or 1 (res (ho, wo, cout), 8-byte aligned); out (ho, wo, cout)
// int8 codes, or float32 values with out_f32 != 0 (as tsg_conv_i8_mma).
// The grid is as many blocks as fit on the device at once, capped by the
// M tiles.
int tsg_conv_i8_mma_res(const void* x, int h, int w, int cin, const void* wt,
                        int k, int stride, int dil, int cout, const void* m,
                        const void* c, int mode, const void* res, float rr,
                        void* out, int out_f32, void* stream) {
  const ResKernel kernel = res_kernel(mode, window_of(k, dil), out_f32 != 0);
  if (!kernel || (stride != 1 && stride != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = conv_mma_res_smem_bytes(cin, k * k);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kResThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ho = (h - 1) / stride + 1, wo = (w - 1) / stride + 1;
  const int m_tiles = (ho * wo + kResBM - 1) / kResBM;
  const int n_tiles = (cout + kResBN - 1) / kResBN;
  int gx = (per_sm > 0 ? per_sm : 1) * sms / n_tiles;
  gx = gx < 1 ? 1 : (gx > m_tiles ? m_tiles : gx);
  kernel<<<dim3(gx, n_tiles), kResThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), h, w, cin, stride, dil, static_cast<const int8_t*>(wt),
      cout, static_cast<const float*>(m), static_cast<const float*>(c),
      static_cast<const int8_t*>(res), rr, out, ho, wo);
  return static_cast<int>(cudaGetLastError());
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

}  // extern "C"
