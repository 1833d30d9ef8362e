// Hand-written Hopper (sm_90a) kernels for the int8-through BiSeNet-R18
// serving graph.  Python side: torchseg_tpu_torch/ops/kernels/
// int8_serve_kernels.py (wrappers, shape checks, plain PyTorch versions).
//
// Two kernels, four entry points of the serving graph:
//
//   stem_pool_i8_kernel  (K1)  replaces the TPU kernel
//       torchseg_tpu/ops/pallas/int8_serve_kernels.py:384
//       s2d_stem_pool_quad_i8 (and the v1/v2 stems at :128 and :214).
//   conv_i8_kernel             the shared int8 3x3/1x1 conv + epilogue,
//       launched by
//       K2 conv3x3s2_i8   replacing conv3x3s2_i8_quad (:515), twice per
//                         forward through spatial_path_i8 (:569/:587);
//       K3 l1_stage_i8    replacing l1_stage_i8_paired_view (:763):
//                         a chain of four launches;
//       K4 down_stage_i8  replacing down_stage_i8_from_paired (:986):
//                         a chain of four launches, the 1x1/2 projection
//                         fused into the first block's conv2 launch.
//
// Numerics (the spec is the JAX XLA path, deploy/int8_serve.py:909-958 and
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
//     so the kernels write exactly these with __fmaf_rn and __fadd_rn, and
//     the library is built with -fmad=false so nvcc contracts nothing else;
//   * rintf rounds half to even, as jnp.round does.
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
// Shared int8 conv + epilogue (K2, and the links of the K3/K4 chains).
//
// What it computes: y = conv(x, w) over NHWC int8 codes x (h, w, cin) and
// HWIO int8 weights (k, k, cin, cout), stride s, symmetric pad, exact in
// int32; then one of three epilogues, all ending in ReLU and requant to
// int8 codes (ho, wo, cout):
//   mode 0 (CBR):        z = fma(y, m, c)
//   mode 1 (identity):   z = fma(res, rr, fma(y, m, c)), res (ho, wo, cout)
//   mode 2 (projection): z = fma(yd, md, fma(y, m, c)) + cd, with
//        yd = 1x1/sd conv of the block input xd (hd, wd, cdin) by wd.
//
// What bounds it: int8 MACs, 2*ho*wo*cout*k*k*cin (9.7 GOP for one stage-1
// conv at 1024x2048), which at dp4a rates is a fraction of a millisecond
// against ~8-16 MB of traffic; a simple kernel is bounded instead by its
// shared-memory loads.  Design: one block owns kConvTH output rows x kConvTW
// columns x kConvCO channels; its weight slice is packed once into shared
// memory as 4-channel int32 words ([k][k][cin/4][kConvCO]), each row's
// input patch is staged as int32 words, and each thread computes eight
// pixels of one output channel with __dp4a: one weight word feeds eight
// dot products, and the eight input words are warp-wide broadcasts.
// ---------------------------------------------------------------------------

constexpr int kConvTW = 32;       // output columns per block
constexpr int kConvTH = 4;        // output rows per block (weights reused)
constexpr int kConvCO = 64;       // output channels per block
constexpr int kConvPX = 8;        // pixels per thread
constexpr int kConvThreads = kConvCO * kConvTW / kConvPX;  // 256

__global__ void __launch_bounds__(kConvThreads)
conv_i8_kernel(const int8_t* __restrict__ x, int h, int w, int cin,
               const int8_t* __restrict__ wt, int k, int stride, int pad,
               int cout, const float* __restrict__ m,
               const float* __restrict__ c, int mode,
               const int8_t* __restrict__ res, float rr,
               const int8_t* __restrict__ xd, int hd, int wd_, int cdin,
               int sd, const int8_t* __restrict__ wdt,
               const float* __restrict__ md, const float* __restrict__ cd,
               int8_t* __restrict__ out, int ho, int wo) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cin4 = cin / 4;
  const int cdin4 = cdin / 4;
  const int kw_in = (kConvTW - 1) * stride + k;   // staged input columns
  int* w_s = reinterpret_cast<int*>(smem);                   // [k*k*cin4][CO]
  int* x_s = w_s + k * k * cin4 * kConvCO;                   // [k][kw_in][cin4]
  int* wd_s = x_s + k * kw_in * cin4;                        // [cdin4][CO]
  int* xd_s = wd_s + (mode == 2 ? cdin4 * kConvCO : 0);      // [TW][cdin4]

  const int tid = threadIdx.x;
  const int co_l = tid % kConvCO;
  const int pg = tid / kConvCO;                 // pixel group 0..3
  const int ox0 = blockIdx.x * kConvTW;
  const int co0 = blockIdx.z * kConvCO;
  const int co = co0 + co_l;

  // pack this block's weight slice: 4 consecutive input channels per word
  for (int i = tid; i < k * k * cin4 * kConvCO; i += blockDim.x) {
    const int cl = i % kConvCO;
    const int kc = i / kConvCO;                  // (ky*k + kx)*cin4 + ci4
    const int tap = kc / cin4, ci4 = kc % cin4;
    uint32_t word = 0;
    if (co0 + cl < cout) {
      const int8_t* src = wt + (static_cast<size_t>(tap) * cin + 4 * ci4) * cout + co0 + cl;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        word |= (static_cast<uint32_t>(static_cast<uint8_t>(src[b * cout])) << (8 * b));
    }
    w_s[i] = static_cast<int>(word);
  }
  if (mode == 2) {
    for (int i = tid; i < cdin4 * kConvCO; i += blockDim.x) {
      const int cl = i % kConvCO, ci4 = i / kConvCO;
      uint32_t word = 0;
      if (co0 + cl < cout) {
        const int8_t* src = wdt + static_cast<size_t>(4 * ci4) * cout + co0 + cl;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          word |= (static_cast<uint32_t>(static_cast<uint8_t>(src[b * cout])) << (8 * b));
      }
      wd_s[i] = static_cast<int>(word);
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
  const int oy_end = min(ho, (static_cast<int>(blockIdx.y) + 1) * kConvTH);
  for (int oy = static_cast<int>(blockIdx.y) * kConvTH; oy < oy_end; ++oy) {
    __syncthreads();  // previous row's readers are done with x_s / xd_s
    const int iy0 = oy * stride - pad;
    const int ix0 = ox0 * stride - pad;
    for (int i = tid; i < k * kw_in * cin4; i += blockDim.x) {
      const int ci4 = i % cin4;
      const int t = (i / cin4) % kw_in;
      const int ky = i / (cin4 * kw_in);
      const int iy = iy0 + ky, ix = ix0 + t;
      int v = 0;
      if (iy >= 0 && iy < h && ix >= 0 && ix < w)
        v = x32[(static_cast<size_t>(iy) * w + ix) * cin4 + ci4];
      x_s[i] = v;
    }
    if (mode == 2) {
      const int iy = oy * sd;
      for (int i = tid; i < kConvTW * cdin4; i += blockDim.x) {
        const int ci4 = i % cdin4, p = i / cdin4;
        const int ix = (ox0 + p) * sd;
        int v = 0;
        if (iy < hd && ix < wd_)
          v = xd32[(static_cast<size_t>(iy) * wd_ + ix) * cdin4 + ci4];
        xd_s[i] = v;
      }
    }
    __syncthreads();

    int acc[kConvPX];
#pragma unroll
    for (int j = 0; j < kConvPX; ++j) acc[j] = 0;
    for (int ky = 0; ky < k; ++ky) {
      for (int kx = 0; kx < k; ++kx) {
        const int* wrow = w_s + ((ky * k + kx) * cin4) * kConvCO + co_l;
        const int* xrow = x_s + (ky * kw_in + pg * kConvPX * stride + kx) * cin4;
        for (int ci4 = 0; ci4 < cin4; ++ci4) {
          const int wv = wrow[ci4 * kConvCO];
#pragma unroll
          for (int j = 0; j < kConvPX; ++j)
            acc[j] = __dp4a(xrow[j * stride * cin4 + ci4], wv, acc[j]);
        }
      }
    }
    int accd[kConvPX];
#pragma unroll
    for (int j = 0; j < kConvPX; ++j) accd[j] = 0;
    if (mode == 2) {
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
        float z = __fmaf_rn(__int2float_rn(acc[j]), mv, cv);
        if (mode == 1) {
          z = __fmaf_rn(static_cast<float>(res[o]), rr, z);
        } else if (mode == 2) {
          z = __fadd_rn(__fmaf_rn(__int2float_rn(accd[j]), mdv, z), cdv);
        }
        out[o] = requant(fmaxf(z, 0.f));
      }
    }
  }
}

size_t conv_smem_bytes(int cin, int k, int stride, int mode, int cdin) {
  const size_t cin4 = cin / 4, cdin4 = cdin / 4;
  const size_t kw_in = (kConvTW - 1) * stride + k;
  size_t words = k * k * cin4 * kConvCO + k * kw_in * cin4;
  if (mode == 2) words += cdin4 * kConvCO + kConvTW * cdin4;
  return 4 * words;
}

}  // namespace

extern "C" {

// Once per device, before the first launch on it: lets both kernels take
// up to the device's opt-in dynamic shared memory.  A launch that needs
// more fails, and its entry point returns that error.
int tsg_init(void) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* kernels[] = {reinterpret_cast<const void*>(stem_pool_i8_kernel),
                           reinterpret_cast<const void*>(conv_i8_kernel)};
  for (const void* fn : kernels) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
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

int tsg_conv_i8(const void* x, int h, int w, int cin, const void* wt, int k,
                int stride, int pad, int cout, const void* m, const void* c,
                int mode, const void* res, float rr, const void* xd, int hd,
                int wd, int cdin, int sd, const void* wdt, const void* md,
                const void* cd, void* out, int ho, int wo, void* stream) {
  const size_t smem = conv_smem_bytes(cin, k, stride, mode, cdin);
  dim3 grid((wo + kConvTW - 1) / kConvTW, (ho + kConvTH - 1) / kConvTH,
            (cout + kConvCO - 1) / kConvCO);
  conv_i8_kernel<<<grid, kConvThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), h, w, cin, static_cast<const int8_t*>(wt),
      k, stride, pad, cout, static_cast<const float*>(m),
      static_cast<const float*>(c), mode, static_cast<const int8_t*>(res), rr,
      static_cast<const int8_t*>(xd), hd, wd, cdin, sd,
      static_cast<const int8_t*>(wdt), static_cast<const float*>(md),
      static_cast<const float*>(cd), static_cast<int8_t*>(out), ho, wo);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
