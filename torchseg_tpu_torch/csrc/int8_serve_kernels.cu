// Hand-written Hopper (sm_90a) kernels for the int8-through serving graphs
// (BiSeNet-R18 and the dilated Bottleneck body of PSPNet).  Python side:
// torchseg_tpu_torch/ops/kernels/int8_serve_kernels.py (wrappers, shape
// checks, plain PyTorch versions).
//
// Three kernels, nine entry points of the serving graphs:
//
//   stem_pool_i8_kernel  (K1)  replaces the TPU kernel
//       torchseg_tpu/ops/pallas/int8_serve_kernels.py:384
//       s2d_stem_pool_quad_i8 (and the v1/v2 stems at :128 and :214).
//   conv_i8_kernel             the shared int8 conv + epilogue (any k,
//       stride, dilation), launched by
//       K2 conv3x3s2_i8   replacing conv3x3s2_i8_quad (:515), twice per
//                         forward through spatial_path_i8 (:569/:587);
//       K3 l1_stage_i8    replacing l1_stage_i8_paired_view (:763):
//                         a chain of four launches;
//       K4 down_stage_i8  replacing down_stage_i8_from_paired (:986),
//                         stages 2 and 3: a chain of four launches, the
//                         1x1/2 projection fused into the first block's
//                         conv2 launch;
//       K5 down_block_i8  replacing down_block_i8_from_paired (:1136),
//                         stage 4's strided block: two launches;
//       K6 res_block_i8   replacing res_block_i8_std (:1226), stage 4's
//                         stride-1 block: two launches;
//       cbr_i8            the deep stem's stem2/stem3 CBRs, one launch
//                         each (XLA convs in JAX, deploy/int8_serve.py:756);
//       bottleneck_i8     a dilated Bottleneck, three launches: 1x1, 3x3
//                         with stride and dilation, 1x1 with the residual
//                         or the 1x1/s projection in its epilogue (XLA
//                         in JAX, deploy/int8_serve.py:716 _apply_bottleneck).
//   maxpool_i8_kernel    (K10) replaces maxpool2d_3x3s2_i8 (:1308), the
//       standalone 3x3/2 pad-1 max pool after the deep stem.
//
// Numerics (the spec is the JAX XLA path, deploy/int8_serve.py:716-958 and
// :1274-1295, as XLA compiles it on the CPU where the tests run it):
//   * int8 x int8 products accumulate exactly in int32 (__dp4a);
//   * the stem reads bf16 weights as f32 and accumulates in f32 (its order
//     differs from any other implementation's, so round-half ties may move
//     a code by one: the promised tolerance is +-1 code);
//   * XLA contracts the epilogue's multiply-adds into fused multiply-adds.
//     Measured on its CPU output, bit for bit:
//         cbr:        z = fma(y, m, c)
//         identity:   z = fma(x, rr, fma(y, m, c))
//         projection: z = fma(yd, md, fma(y, m, c)) + cd
//     (the BasicBlock's conv2 and the Bottleneck's conv3 alike), so the
//     kernels write exactly these with __fmaf_rn and __fadd_rn, and the
//     library is built with -fmad=false so nvcc contracts nothing else;
//   * rintf rounds half to even, as jnp.round does;
//   * the pool only compares codes: it is exact for any code.
//
// Every launching entry point runs on the caller's stream, allocates
// nothing and returns cudaGetLastError(); tsg_init() runs once per device
// before them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int8_t requant(float z) {
  // z is post-ReLU (>= 0); clip(round(z), -127, 127)
  float q = fmaxf(fminf(rintf(z), 127.f), -127.f);
  return static_cast<int8_t>(static_cast<int>(q));
}

__device__ __forceinline__ float bf16_bits_to_f32(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// ---------------------------------------------------------------------------
// K1: fused serving stem.
//
// What it computes: a 4x4 stride-1 valid conv over the pre-padded s2d int8
// image xs (h2+3, w2+3, cin) with bf16 weights (4, 4, cin, cout) and an f32
// accumulator, the requant epilogue q = clip(rint(max(acc*m + c, 0))), then
// the split: channels [0, n_sp) are the SpatialPath codes sp (h2, w2, n_sp),
// channels [n_sp, cout) go through the backbone 3x3/2 pad-1 max pool into
// pooled (h2/2, w2/2, cout - n_sp).  The backbone half never reaches device
// memory at stem resolution.
//
// What bounds it: 2*h2*w2*cout*16*cin FLOP (26 GFLOP at 1024x2048) of f32
// FMA outside the tensor cores; bytes are small (4.4 MB in, 50 MB out).
// Design: one block owns one pooled row and PW pooled columns; it stages its
// 6-row input patch as f32 and the whole bf16 weight tensor in shared
// memory, computes the three stem rows that pooled row reads (the row and
// column above and left are halo, recomputed for the backbone half only),
// keeps the backbone codes in shared memory and pools them there.  Each
// thread computes four neighbouring pixels of one channel, so one weight
// load feeds four FMAs and the input loads are warp-wide broadcasts.
// ---------------------------------------------------------------------------

constexpr int kStemPW = 32;                    // pooled columns per block
constexpr int kStemG = kStemPW / 2 + 1;        // 4-pixel groups per stem row
constexpr int kStemNC = 4 * kStemG;            // stem columns computed
constexpr int kStemXW = kStemNC + 3;           // input columns staged
constexpr int kStemThreads = 256;

__global__ void __launch_bounds__(kStemThreads)
stem_pool_i8_kernel(const int8_t* __restrict__ xs,
                    const uint16_t* __restrict__ wf,
                    const float* __restrict__ m, const float* __restrict__ c,
                    int8_t* __restrict__ sp, int8_t* __restrict__ pooled,
                    int h2, int w2, int cin, int cout, int n_sp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nbb = cout - n_sp;
  const int kk = 16 * cin;
  uint16_t* w_s = reinterpret_cast<uint16_t*>(smem);            // [kk][cout]
  float* m_s = reinterpret_cast<float*>(w_s + kk * cout + (kk * cout & 1));
  float* c_s = m_s + cout;
  float* x_s = c_s + cout;                                       // [6][XW][cin]
  int8_t* bb_s = reinterpret_cast<int8_t*>(x_s + 6 * kStemXW * cin);
                                                                 // [3][NC][nbb]
  const int py = blockIdx.y;
  const int px0 = blockIdx.x * kStemPW;
  const int row0 = 2 * py - 1;    // first stem row (and first xs row) used
  const int col0 = 2 * px0 - 1;   // first stem column (and xs column) used
  const int hp = h2 + 3, wp = w2 + 3;
  const int tid = threadIdx.x;

  for (int i = tid; i < kk * cout; i += blockDim.x) w_s[i] = wf[i];
  for (int i = tid; i < cout; i += blockDim.x) {
    m_s[i] = m[i];
    c_s[i] = c[i];
  }
  for (int i = tid; i < 6 * kStemXW * cin; i += blockDim.x) {
    const int ci = i % cin;
    const int lc = (i / cin) % kStemXW;
    const int lr = i / (cin * kStemXW);
    const int gr = row0 + lr, gc = col0 + lc;
    float v = 0.f;
    if (gr >= 0 && gr < hp && gc >= 0 && gc < wp)
      v = static_cast<float>(xs[(static_cast<size_t>(gr) * wp + gc) * cin + ci]);
    x_s[i] = v;
  }
  __syncthreads();

  // items: (stem row r in 0..2, 4-column group g, channel co), co fastest
  const int n_items = 3 * kStemG * cout;
  for (int it = tid; it < n_items; it += blockDim.x) {
    const int co = it % cout;
    const int g = (it / cout) % kStemG;
    const int r = it / (cout * kStemG);
    const bool is_sp = co < n_sp;
    if (is_sp && r == 0) continue;  // row 2py-1 belongs to the block above
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int dy = 0; dy < 4; ++dy) {
      for (int dx = 0; dx < 4; ++dx) {
        const float* xrow = x_s + ((r + dy) * kStemXW + 4 * g + dx) * cin;
        const uint16_t* wrow = w_s + ((dy * 4 + dx) * cin) * cout + co;
        for (int ci = 0; ci < cin; ++ci) {
          const float wv = bf16_bits_to_f32(wrow[ci * cout]);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[j] = __fmaf_rn(xrow[j * cin + ci], wv, acc[j]);
        }
      }
    }
    const int sr = row0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int lj = 4 * g + j;
      const int sc = col0 + lj;
      const bool valid = sr >= 0 && sr < h2 && sc >= 0 && sc < w2;
      const int8_t q = requant(fmaxf(__fmaf_rn(acc[j], m_s[co], c_s[co]), 0.f));
      if (is_sp) {
        if (valid && lj >= 1 && lj <= 2 * kStemPW)
          sp[(static_cast<size_t>(sr) * w2 + sc) * n_sp + co] = q;
      } else {
        // padding never wins: the codes are >= 0 after the ReLU
        bb_s[(r * kStemNC + lj) * nbb + (co - n_sp)] = valid ? q : int8_t(-128);
      }
    }
  }
  __syncthreads();

  const int pw = w2 / 2;
  for (int it = tid; it < kStemPW * nbb; it += blockDim.x) {
    const int ch = it % nbb;
    const int j = it / nbb;
    const int px = px0 + j;
    if (px >= pw) continue;
    int mx = -128;
    for (int r = 0; r < 3; ++r)
      for (int dc = 0; dc < 3; ++dc)
        mx = max(mx, static_cast<int>(bb_s[(r * kStemNC + 2 * j + dc) * nbb + ch]));
    pooled[(static_cast<size_t>(py) * pw + px) * nbb + ch] = static_cast<int8_t>(mx);
  }
}

size_t stem_smem_bytes(int cin, int cout, int n_sp) {
  const size_t kk = 16 * static_cast<size_t>(cin);
  const size_t w = 2 * (kk * cout + ((kk * cout) & 1));
  return w + 2 * 4 * cout + 4 * 6 * kStemXW * cin +
         3 * kStemNC * static_cast<size_t>(cout - n_sp);
}

// ---------------------------------------------------------------------------
// Shared int8 conv + epilogue (K2, the links of the K3-K6 chains, the deep
// stem's CBRs and the Bottleneck chains).
//
// What it computes: y = conv(x, w) over NHWC int8 codes x (h, w, cin) and
// HWIO int8 weights (k, k, cin, cout), stride s, dilation d, symmetric pad,
// exact in int32; then one of three epilogues, all ending in ReLU and
// either the requant to int8 codes or (out_f32) the float32 value itself,
// (ho, wo, cout):
//   mode 0 (CBR):        z = fma(y, m, c)
//   mode 1 (identity):   z = fma(res, rr, fma(y, m, c)), res (ho, wo, cout)
//   mode 2 (projection): z = fma(yd, md, fma(y, m, c)) + cd, with
//        yd = 1x1/sd conv of the block input xd (hd, wd, cdin) by wd.
// The projection's weights are staged whole (cdin4 x kConvCO words: 64 KB
// at cdin = 1024, the widest projection of ResNet-50/101).
//
// What bounds it: int8 MACs, 2*ho*wo*cout*k*k*cin (9.7 GOP for one stage-1
// conv at 1024x2048), which at dp4a rates is a fraction of a millisecond
// against ~8-16 MB of traffic; a simple kernel is bounded instead by its
// shared-memory loads.  Design: one block owns kConvTH output rows x kConvTW
// columns x kConvCO channels.  The input channels are walked in chunks of
// kConvChunk 4-channel words; each chunk's weight slice is packed into
// shared memory as int32 words ([k][k][chunk][kConvCO]), and each row's
// input patch is staged in turn as int32 words.  Each thread computes
// eight pixels of one output channel with __dp4a: one weight word feeds
// eight dot products, and the eight input words are warp-wide broadcasts.
// Chunking bounds shared memory by the chunk, not by cin: a whole 3x3
// cin=512 slice (288 KB) would not fit a block's 227 KB; a chunk takes
// 72 KB.  The sums are exact integers, so the chunk order changes no code.
//
// kRows is how many rows' sums a thread holds at once.  When the weight
// slice is one chunk (cin <= 128), it is packed once per block and the
// rows are finished one at a time (kRows = 1: 62 registers, four blocks
// per SM).  When it takes several chunks, every chunk serves all the
// block's rows before the next is packed, so all their sums stay in
// registers (kRows = kConvTH: 128 registers, two blocks per SM, which is
// also what a chunk's shared memory allows).  Holding four rows' sums at
// cin <= 128 too cost those convs 5-8 % on an H100 (80 registers, three
// blocks per SM).
// ---------------------------------------------------------------------------

constexpr int kConvTW = 32;       // output columns per block
constexpr int kConvTH = 4;        // output rows per block (weights reused)
constexpr int kConvCO = 64;       // output channels per block
constexpr int kConvPX = 8;        // pixels per thread
constexpr int kConvChunk = 32;    // input-channel words (x4 channels) per chunk
constexpr int kConvThreads = kConvCO * kConvTW / kConvPX;  // 256

__device__ __forceinline__ int pack4(const int8_t* src, int step) {
  uint32_t word = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    word |= (static_cast<uint32_t>(static_cast<uint8_t>(src[b * step])) << (8 * b));
  return static_cast<int>(word);
}

template <int kRows>
__global__ void __launch_bounds__(kConvThreads)
conv_i8_kernel(const int8_t* __restrict__ x, int h, int w, int cin,
               const int8_t* __restrict__ wt, int k, int stride, int pad,
               int dil, int cout, const float* __restrict__ m,
               const float* __restrict__ c, int mode,
               const int8_t* __restrict__ res, float rr,
               const int8_t* __restrict__ xd, int hd, int wd_, int cdin,
               int sd, const int8_t* __restrict__ wdt,
               const float* __restrict__ md, const float* __restrict__ cd,
               void* __restrict__ out, int out_f32, int ho, int wo) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cin4 = cin / 4;
  const int cdin4 = cdin / 4;
  const int chunk = min(cin4, kConvChunk);
  const int kw_in = (kConvTW - 1) * stride + (k - 1) * dil + 1;  // staged columns
  int* w_s = reinterpret_cast<int*>(smem);                   // [k*k][chunk][CO]
  int* x_s = w_s + k * k * chunk * kConvCO;                  // [k][kw_in][chunk]
  int* wd_s = x_s + k * kw_in * chunk;                       // [cdin4][CO]
  int* xd_s = wd_s + (mode == 2 ? cdin4 * kConvCO : 0);      // [TW][cdin4]

  const int tid = threadIdx.x;
  const int co_l = tid % kConvCO;
  const int pg = tid / kConvCO;                 // pixel group 0..3
  const int ox0 = blockIdx.x * kConvTW;
  const int oy_begin = blockIdx.y * kConvTH;
  const int oy_end = min(ho, oy_begin + kConvTH);
  const int co0 = blockIdx.z * kConvCO;
  const int co = co0 + co_l;

  if (mode == 2) {  // the projection's weights, packed once
    for (int i = tid; i < cdin4 * kConvCO; i += blockDim.x) {
      const int cl = i % kConvCO, ci4 = i / kConvCO;
      wd_s[i] = co0 + cl < cout
          ? pack4(wdt + static_cast<size_t>(4 * ci4) * cout + co0 + cl, cout) : 0;
    }
  }
  float mv = 0.f, cv = 0.f, mdv = 0.f, cdv = 0.f;
  if (co < cout) {
    mv = m[co];
    cv = c[co];
    if (mode == 2) {
      mdv = md[co];
      cdv = cd[co];
    }
  }
  const int* x32 = reinterpret_cast<const int*>(x);
  const int* xd32 = reinterpret_cast<const int*>(xd);

  for (int g0 = oy_begin; g0 < oy_end; g0 += kRows) {
    const int nrows = min(kRows, oy_end - g0);   // block-uniform
    int acc[kRows][kConvPX];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < kConvPX; ++j) acc[r][j] = 0;

    for (int c0 = 0; c0 < cin4; c0 += chunk) {
      const int cn = min(chunk, cin4 - c0);
      __syncthreads();  // the previous readers are done with shared memory
      if (cn != cin4 || g0 == oy_begin) {  // one chunk: packed once per block
        // 4 consecutive input channels per word
        for (int i = tid; i < k * k * cn * kConvCO; i += blockDim.x) {
          const int cl = i % kConvCO;
          const int kc = i / kConvCO;              // tap * cn + ci
          const int tap = kc / cn, ci4 = c0 + kc % cn;
          w_s[i] = co0 + cl < cout
              ? pack4(wt + (static_cast<size_t>(tap) * cin + 4 * ci4) * cout + co0 + cl,
                      cout)
              : 0;
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r >= nrows) break;
        if (r > 0) __syncthreads();  // the previous row's readers are done with x_s
        const int iy0 = (g0 + r) * stride - pad;
        const int ix0 = ox0 * stride - pad;
        for (int i = tid; i < k * kw_in * cn; i += blockDim.x) {
          const int ci = i % cn;
          const int t = (i / cn) % kw_in;
          const int ky = i / (cn * kw_in);
          const int iy = iy0 + ky * dil, ix = ix0 + t;
          int v = 0;
          if (iy >= 0 && iy < h && ix >= 0 && ix < w)
            v = x32[(static_cast<size_t>(iy) * w + ix) * cin4 + c0 + ci];
          x_s[i] = v;
        }
        __syncthreads();
        for (int ky = 0; ky < k; ++ky) {
          for (int kx = 0; kx < k; ++kx) {
            const int* wrow = w_s + ((ky * k + kx) * cn) * kConvCO + co_l;
            const int* xrow = x_s + (ky * kw_in + pg * kConvPX * stride + kx * dil) * cn;
            for (int ci = 0; ci < cn; ++ci) {
              const int wv = wrow[ci * kConvCO];
#pragma unroll
              for (int j = 0; j < kConvPX; ++j)
                acc[r][j] = __dp4a(xrow[j * stride * cn + ci], wv, acc[r][j]);
            }
          }
        }
      }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= nrows) break;
      const int oy = g0 + r;
      int accd[kConvPX];
#pragma unroll
      for (int j = 0; j < kConvPX; ++j) accd[j] = 0;
      if (mode == 2) {
        __syncthreads();  // the previous readers are done with xd_s
        const int iy = oy * sd;
        for (int i = tid; i < kConvTW * cdin4; i += blockDim.x) {
          const int ci4 = i % cdin4, p = i / cdin4;
          const int ix = (ox0 + p) * sd;
          int v = 0;
          if (iy < hd && ix < wd_)
            v = xd32[(static_cast<size_t>(iy) * wd_ + ix) * cdin4 + ci4];
          xd_s[i] = v;
        }
        __syncthreads();
        const int* xrow = xd_s + pg * kConvPX * cdin4;
        for (int ci4 = 0; ci4 < cdin4; ++ci4) {
          const int wv = wd_s[ci4 * kConvCO + co_l];
#pragma unroll
          for (int j = 0; j < kConvPX; ++j)
            accd[j] = __dp4a(xrow[j * cdin4 + ci4], wv, accd[j]);
        }
      }
      if (co < cout) {
#pragma unroll
        for (int j = 0; j < kConvPX; ++j) {
          const int ox = ox0 + pg * kConvPX + j;
          if (ox >= wo) continue;
          const size_t o = (static_cast<size_t>(oy) * wo + ox) * cout + co;
          float z = __fmaf_rn(__int2float_rn(acc[r][j]), mv, cv);
          if (mode == 1) {
            z = __fmaf_rn(static_cast<float>(res[o]), rr, z);
          } else if (mode == 2) {
            z = __fadd_rn(__fmaf_rn(__int2float_rn(accd[j]), mdv, z), cdv);
          }
          if (out_f32)
            static_cast<float*>(out)[o] = fmaxf(z, 0.f);
          else
            static_cast<int8_t*>(out)[o] = requant(fmaxf(z, 0.f));
        }
      }
    }
  }
}

size_t conv_smem_bytes(int cin, int k, int stride, int mode, int cdin, int dil) {
  const size_t cin4 = cin / 4, cdin4 = cdin / 4;
  const size_t chunk = cin4 < static_cast<size_t>(kConvChunk) ? cin4 : kConvChunk;
  const size_t kw_in = (kConvTW - 1) * stride + (k - 1) * dil + 1;
  size_t words = k * k * chunk * kConvCO + k * kw_in * chunk;
  if (mode == 2) words += cdin4 * kConvCO + kConvTW * cdin4;
  return 4 * words;
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
// MB at (240, 240, 128), 2.75 us at 3.35 TB/s) and does nine byte-maxes an
// output.  Design: one thread per four channels of an output pixel; each
// of the nine window words is one 4-byte load (neighbouring threads read
// neighbouring words) and one __vmaxs4, the four signed byte maxes at once.
// The windows overlap by a row and a column, and those re-reads hit L2.
// ---------------------------------------------------------------------------

constexpr int kPoolThreads = 256;

__global__ void __launch_bounds__(kPoolThreads)
maxpool_i8_kernel(const int* __restrict__ x, int h, int w, int c4,
                  unsigned int* __restrict__ out, int ho, int wo) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(ho) * wo * c4) return;
  const int ch = static_cast<int>(i % c4);
  const long long p = i / c4;
  const int ox = static_cast<int>(p % wo), oy = static_cast<int>(p / wo);
  unsigned int mx = 0x80808080u;  // -128 in every byte
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int iy = 2 * oy - 1 + dy;
    if (iy < 0 || iy >= h) continue;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int ix = 2 * ox - 1 + dx;
      if (ix < 0 || ix >= w) continue;
      mx = __vmaxs4(mx, static_cast<unsigned int>(
                            x[(static_cast<size_t>(iy) * w + ix) * c4 + ch]));
    }
  }
  out[i] = mx;
}

}  // namespace

extern "C" {

// Once per device, before the first launch on it: lets every kernel take
// up to the device's opt-in dynamic shared memory.  A launch that needs
// more fails, and its entry point returns that error (the wrappers check
// tsg_conv_smem_bytes against tsg_smem_optin first).
int tsg_init(void) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* kernels[] = {reinterpret_cast<const void*>(stem_pool_i8_kernel),
                           reinterpret_cast<const void*>(conv_i8_kernel<1>),
                           reinterpret_cast<const void*>(conv_i8_kernel<kConvTH>)};
  for (const void* fn : kernels) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
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

// Dynamic shared memory one tsg_conv_i8 launch with these arguments takes.
long long tsg_conv_smem_bytes(int cin, int k, int stride, int mode, int cdin,
                              int dil) {
  return static_cast<long long>(conv_smem_bytes(cin, k, stride, mode, cdin, dil));
}

int tsg_stem_pool_i8(const void* xs, const void* wf, const void* m,
                     const void* c, void* sp, void* pooled, int h2, int w2,
                     int cin, int cout, int n_sp, void* stream) {
  const size_t smem = stem_smem_bytes(cin, cout, n_sp);
  dim3 grid((w2 / 2 + kStemPW - 1) / kStemPW, h2 / 2);
  stem_pool_i8_kernel<<<grid, kStemThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xs), static_cast<const uint16_t*>(wf),
      static_cast<const float*>(m), static_cast<const float*>(c),
      static_cast<int8_t*>(sp), static_cast<int8_t*>(pooled), h2, w2, cin,
      cout, n_sp);
  return static_cast<int>(cudaGetLastError());
}

// out is int8 codes, or float32 values with out_f32 != 0.
int tsg_conv_i8(const void* x, int h, int w, int cin, const void* wt, int k,
                int stride, int pad, int dil, int cout, const void* m,
                const void* c, int mode, const void* res, float rr,
                const void* xd, int hd, int wd, int cdin, int sd,
                const void* wdt, const void* md, const void* cd, void* out,
                int out_f32, int ho, int wo, void* stream) {
  const size_t smem = conv_smem_bytes(cin, k, stride, mode, cdin, dil);
  dim3 grid((wo + kConvTW - 1) / kConvTW, (ho + kConvTH - 1) / kConvTH,
            (cout + kConvCO - 1) / kConvCO);
  // several weight chunks: hold all the block's rows (see conv_i8_kernel)
  const auto kernel = cin / 4 > kConvChunk ? conv_i8_kernel<kConvTH> : conv_i8_kernel<1>;
  kernel<<<grid, kConvThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), h, w, cin, static_cast<const int8_t*>(wt),
      k, stride, pad, dil, cout, static_cast<const float*>(m),
      static_cast<const float*>(c), mode, static_cast<const int8_t*>(res), rr,
      static_cast<const int8_t*>(xd), hd, wd, cdin, sd,
      static_cast<const int8_t*>(wdt), static_cast<const float*>(md),
      static_cast<const float*>(cd), out, out_f32, ho, wo);
  return static_cast<int>(cudaGetLastError());
}

// x (h, w, C) int8, 4-byte aligned, C % 4 == 0 -> out (ho, wo, C) int8.
int tsg_maxpool_i8(const void* x, int h, int w, int c, void* out, int ho,
                   int wo, void* stream) {
  const long long n = static_cast<long long>(ho) * wo * (c / 4);
  const unsigned int blocks = static_cast<unsigned int>((n + kPoolThreads - 1) / kPoolThreads);
  maxpool_i8_kernel<<<blocks, kPoolThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), h, w, c / 4, static_cast<unsigned int*>(out), ho, wo);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
