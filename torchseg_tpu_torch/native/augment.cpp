// Host image kernels of the data pipeline, bound with ctypes
// (torchseg_tpu_torch/native/__init__.py).
//
// A copy of the JAX package's torchseg_tpu/native/src/augment.cpp (the
// uint8 resizes, the flip and the fused crop/normalize/pad), whose
// arithmetic it keeps line for line, so that the port's data pipeline
// gives the bits of JAX's native route; plus cv2's own INTER_LINEAR (the
// route of the JAX functions that call cv2.resize) and the PNG scanline
// unfilter that the port's PNG reader (data/image_io.py) runs, and cv2's
// warpAffine and GaussianBlur for the transforms that call them.
// OpenMP-parallel, GIL-free loops.
//
// Semantics:
//   * bilinear resize: half-pixel centers, edge clamp (cv2 INTER_LINEAR,
//     within one code of it)
//   * cv2's INTER_LINEAR exactly: 11-bit fixed-point weights, its 2x area
//     route
//   * nearest resize:  sx = floor(dx * scale) (cv2 INTER_NEAREST)
//   * normalize: /255 then (x - mean) / std   (img_utils.py:181-187)
//   * crop+pad: fixed window with constant pad value (img_utils.py:24-39)
//   * PNG unfilter: the five filter types of the PNG specification
//   * cv2.warpAffine, uint8, INTER_LINEAR / INTER_NEAREST, BORDER_CONSTANT
//     0: OpenCV 5's float32 kernels (see warp_affine_u8)
//   * cv2.GaussianBlur((k, k), 0), uint8, k = 3, 5, 7, BORDER_REFLECT_101:
//     OpenCV's bit-exact fixed-point route (see gaussian_blur_u8)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// dst (dh, dw, c) <- bilinear(src (sh, sw, c)), uint8, cv2 INTER_LINEAR.
void resize_bilinear_u8(const uint8_t* src, int sh, int sw, int c,
                        uint8_t* dst, int dh, int dw) {
  const double scale_y = (double)sh / dh;
  const double scale_x = (double)sw / dw;
#pragma omp parallel for schedule(static)
  for (int dy = 0; dy < dh; ++dy) {
    double fy = (dy + 0.5) * scale_y - 0.5;
    int y0 = (int)std::floor(fy);
    double wy = fy - y0;
    int y1 = std::min(y0 + 1, sh - 1);
    y0 = std::max(y0, 0);
    if (y0 > y1) y0 = y1;
    for (int dx = 0; dx < dw; ++dx) {
      double fx = (dx + 0.5) * scale_x - 0.5;
      int x0 = (int)std::floor(fx);
      double wx = fx - x0;
      int x1 = std::min(x0 + 1, sw - 1);
      x0 = std::max(x0, 0);
      if (x0 > x1) x0 = x1;
      const uint8_t* p00 = src + (y0 * sw + x0) * c;
      const uint8_t* p01 = src + (y0 * sw + x1) * c;
      const uint8_t* p10 = src + (y1 * sw + x0) * c;
      const uint8_t* p11 = src + (y1 * sw + x1) * c;
      uint8_t* out = dst + (dy * dw + dx) * c;
      for (int k = 0; k < c; ++k) {
        double v = (1 - wy) * ((1 - wx) * p00[k] + wx * p01[k]) +
                   wy * ((1 - wx) * p10[k] + wx * p11[k]);
        out[k] = (uint8_t)std::min(255.0, std::max(0.0, std::round(v)));
      }
    }
  }
}

// cv2.resize(..., INTER_LINEAR) of uint8 images, bit for bit: OpenCV's
// fixed-point route (imgproc/src/resize.cpp, resizeGeneric_ with
// HResizeLinear and VResizeLinear<uchar, int, short>).  The caller builds
// the tables in OpenCV's float order (native/__init__.py): xofs the left
// source column of each output column, already clamped onto the image,
// xa its two 11-bit weights (2048 and 0 where OpenCV clamps the column);
// yofs the floor of each output row's source coordinate, NOT clamped, and
// yb its two weights.  Each source row's horizontal pass sums in int32
// (x0 * a0 + x1 * a1); the two rows clip(sy) and clip(sy + 1) are then
// blended as OpenCV does, each product of the weight and the row >> 4
// shifted down by 16 before the sum, so that an edge row blended with
// itself can differ by one code from the row itself, as in OpenCV.
void resize_linear_fixed_u8(const uint8_t* src, int sh, int sw, int c,
                            uint8_t* dst, int dh, int dw,
                            const int32_t* xofs, const int16_t* xa,
                            const int32_t* yofs, const int16_t* yb) {
  const int width = dw * c;
#pragma omp parallel
  {
    int32_t* rows = (int32_t*)std::malloc(sizeof(int32_t) * 2 * width);
#pragma omp for schedule(static)
    for (int dy = 0; dy < dh; ++dy) {
      for (int k = 0; k < 2; ++k) {
        const int sy = std::min(std::max(yofs[dy] + k, 0), sh - 1);
        const uint8_t* s = src + (size_t)sy * sw * c;
        int32_t* r = rows + k * width;
        for (int dx = 0; dx < dw; ++dx) {
          const int x0 = xofs[dx], x1 = std::min(x0 + 1, sw - 1);
          const int a0 = xa[2 * dx], a1 = xa[2 * dx + 1];
          for (int ch = 0; ch < c; ++ch)
            r[dx * c + ch] = s[x0 * c + ch] * a0 + s[x1 * c + ch] * a1;
        }
      }
      const int b0 = yb[2 * dy], b1 = yb[2 * dy + 1];
      const int32_t* s0 = rows;
      const int32_t* s1 = rows + width;
      uint8_t* out = dst + (size_t)dy * width;
      for (int i = 0; i < width; ++i)
        out[i] = (uint8_t)((((b0 * (s0[i] >> 4)) >> 16) +
                            ((b1 * (s1[i] >> 4)) >> 16) + 2) >> 2);
    }
    std::free(rows);
  }
}

// cv2.resize(..., INTER_LINEAR) where both scales are exactly 2: OpenCV
// takes its fast area route (resizeAreaFast_).  A whole 2x2 block is
// (sum + 2) >> 2 for 1, 3 or 4 channels and rint(sum * 0.25f) for 2; a
// block cut by the image's edge (an odd size rounded up) is
// rint(sum / count) in float.
void resize_area2_u8(const uint8_t* src, int sh, int sw, int c,
                     uint8_t* dst, int dh, int dw) {
#pragma omp parallel for schedule(static)
  for (int dy = 0; dy < dh; ++dy) {
    for (int dx = 0; dx < dw; ++dx) {
      const int y0 = 2 * dy, x0 = 2 * dx;
      const int ny = std::min(2, sh - y0), nx = std::min(2, sw - x0);
      for (int ch = 0; ch < c; ++ch) {
        int sum = 0;
        for (int y = 0; y < ny; ++y)
          for (int x = 0; x < nx; ++x)
            sum += src[((size_t)(y0 + y) * sw + x0 + x) * c + ch];
        int v;
        if (ny * nx == 4 && c != 2)
          v = (sum + 2) >> 2;
        else if (ny * nx == 4)
          v = (int)std::nearbyint((float)sum * 0.25f);
        else
          v = (int)std::nearbyint((float)sum / (float)(ny * nx));
        dst[((size_t)dy * dw + dx) * c + ch] = (uint8_t)v;
      }
    }
  }
}

// nearest-neighbor resize, cv2 INTER_NEAREST convention.
void resize_nearest_u8(const uint8_t* src, int sh, int sw, int c,
                       uint8_t* dst, int dh, int dw) {
  const double scale_y = (double)sh / dh;
  const double scale_x = (double)sw / dw;
#pragma omp parallel for schedule(static)
  for (int dy = 0; dy < dh; ++dy) {
    int sy = std::min((int)std::floor(dy * scale_y), sh - 1);
    for (int dx = 0; dx < dw; ++dx) {
      int sx = std::min((int)std::floor(dx * scale_x), sw - 1);
      std::memcpy(dst + (dy * dw + dx) * c, src + (sy * sw + sx) * c, c);
    }
  }
}

// horizontal flip in place-to-dst, uint8 HWC.
void hflip_u8(const uint8_t* src, int h, int w, int c, uint8_t* dst) {
#pragma omp parallel for schedule(static)
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      std::memcpy(dst + (y * w + x) * c, src + (y * w + (w - 1 - x)) * c, c);
    }
  }
}

// Fused: crop window [y0, y0+ch) x [x0, x0+cw) from a uint8 HWC image,
// normalize (/255 - mean)/std to float32, pad out-of-bounds with pad_val.
// Window coordinates are in the source frame and may exceed its bounds
// (the crop-pad-to-shape behavior of img_utils.py:24-39 with centered
// margins precomputed by the caller).
void crop_normalize_pad_f32(const uint8_t* src, int h, int w, int c,
                            const float* mean, const float* stdv,
                            float* dst, int ch, int cw, int y0, int x0,
                            float pad_val) {
#pragma omp parallel for schedule(static)
  for (int dy = 0; dy < ch; ++dy) {
    int sy = y0 + dy;
    for (int dx = 0; dx < cw; ++dx) {
      int sx = x0 + dx;
      float* out = dst + (dy * cw + dx) * c;
      if (sy < 0 || sy >= h || sx < 0 || sx >= w) {
        for (int k = 0; k < c; ++k) out[k] = pad_val;
      } else {
        const uint8_t* p = src + (sy * w + sx) * c;
        for (int k = 0; k < c; ++k)
          out[k] = ((float)p[k] / 255.0f - mean[k]) / stdv[k];
      }
    }
  }
}

// int32 label crop with constant pad (no normalization).
void crop_pad_i32(const int32_t* src, int h, int w, int32_t* dst, int ch,
                  int cw, int y0, int x0, int32_t pad_val) {
#pragma omp parallel for schedule(static)
  for (int dy = 0; dy < ch; ++dy) {
    int sy = y0 + dy;
    for (int dx = 0; dx < cw; ++dx) {
      int sx = x0 + dx;
      dst[dy * cw + dx] = (sy < 0 || sy >= h || sx < 0 || sx >= w)
                              ? pad_val
                              : src[sy * w + sx];
    }
  }
}

// PNG scanline unfilter.  src holds `rows` scanlines of 1 + stride bytes
// (the filter type byte first), dst (rows, stride); bpp is the bytes per
// complete pixel, 1 for bit depths under 8.  Returns 0, or 1 + the row
// whose filter type is not one of the five.
int png_unfilter(const uint8_t* src, int rows, int stride, int bpp,
                 uint8_t* dst) {
  for (int y = 0; y < rows; ++y) {
    const uint8_t* in = src + (size_t)y * (stride + 1);
    const int type = in[0];
    ++in;
    uint8_t* out = dst + (size_t)y * stride;
    const uint8_t* up = y > 0 ? out - stride : nullptr;
    switch (type) {
      case 0:  // None
        std::memcpy(out, in, stride);
        break;
      case 1:  // Sub
        for (int i = 0; i < stride; ++i)
          out[i] = (uint8_t)(in[i] + (i >= bpp ? out[i - bpp] : 0));
        break;
      case 2:  // Up
        for (int i = 0; i < stride; ++i)
          out[i] = (uint8_t)(in[i] + (up ? up[i] : 0));
        break;
      case 3:  // Average
        for (int i = 0; i < stride; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          out[i] = (uint8_t)(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:  // Paeth
        for (int i = 0; i < stride; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          const int c = (up && i >= bpp) ? up[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          out[i] = (uint8_t)(in[i] + pred);
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}

// cv2.warpAffine(src, m, (dw, dh), flags, BORDER_CONSTANT, 0) for uint8
// (h, w, c) images, m the forward 2x3 map in double.  OpenCV 5's kernels:
// the map inverted in double (its formula), cast to float; the source
// coordinate of pixel (x, y) in float32, in its SIMD loop (16 pixels a
// step on this build) fma(x, M0, y * M1 + M2), in its scalar tail (the
// last dw % 16 columns) fma(x, M0, y * M1) + M2; INTER_NEAREST reads
// round-half-even(coordinate), INTER_LINEAR blends the four neighbours
// (zero outside the image) as v0 = fma(a, p01 - p00, p00), v1 likewise,
// fma(b, v1 - v0, v0), rounded half to even.  Contraction is off here:
// every fused multiply-add is written out.
#pragma GCC push_options
#pragma GCC optimize("fp-contract=off")
void warp_affine_u8(const uint8_t* src, int h, int w, int c, uint8_t* dst,
                    int dh, int dw, const double* m, int nearest) {
  double d = m[0] * m[4] - m[1] * m[3];
  d = d != 0 ? 1. / d : 0;
  double a11 = m[4] * d, a22 = m[0] * d;
  double a12 = m[1] * -d, a21 = m[3] * -d;
  double b1 = -a11 * m[2] - a12 * m[5];
  double b2 = -a21 * m[2] - a22 * m[5];
  const float M[6] = {(float)a11, (float)a12, (float)b1,
                      (float)a21, (float)a22, (float)b2};
  const int simd_end = dw - dw % 16;
#pragma omp parallel for schedule(static)
  for (int y = 0; y < dh; ++y) {
    const float fy = (float)y;
    const float mx = fy * M[1] + M[2], my = fy * M[4] + M[5];
    const float tx = fy * M[1], ty = fy * M[4];
    for (int x = 0; x < dw; ++x) {
      const float fx = (float)x;
      float sx, sy;
      if (x < simd_end) {
        sx = std::fmaf(fx, M[0], mx);
        sy = std::fmaf(fx, M[3], my);
      } else {
        sx = std::fmaf(fx, M[0], tx) + M[2];
        sy = std::fmaf(fx, M[3], ty) + M[5];
      }
      uint8_t* out = dst + ((size_t)y * dw + x) * c;
      if (nearest) {
        const long ix = std::lrint(sx), iy = std::lrint(sy);
        const bool in = ix >= 0 && ix < w && iy >= 0 && iy < h;
        for (int k = 0; k < c; ++k)
          out[k] = in ? src[((size_t)iy * w + ix) * c + k] : 0;
        continue;
      }
      const float flx = std::floor(sx), fly = std::floor(sy);
      const long ix = (long)flx, iy = (long)fly;
      const float a = sx - flx, b = sy - fly;
      for (int k = 0; k < c; ++k) {
        float p[4];
        for (int j = 0; j < 4; ++j) {
          const long yy = iy + (j >> 1), xx = ix + (j & 1);
          p[j] = (yy >= 0 && yy < h && xx >= 0 && xx < w)
                     ? (float)src[((size_t)yy * w + xx) * c + k]
                     : 0.f;
        }
        const float v0 = std::fmaf(a, p[1] - p[0], p[0]);
        const float v1 = std::fmaf(a, p[3] - p[2], p[2]);
        const long v = std::lrint(std::fmaf(b, v1 - v0, v0));
        out[k] = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
      }
    }
  }
}
#pragma GCC pop_options

// OpenCV's borderInterpolate for BORDER_REFLECT_101 (a one-pixel axis reads
// its pixel)
static inline int reflect101(int p, int n) {
  if (n == 1) return 0;
  while (p < 0 || p >= n) p = p < 0 ? -p : 2 * n - 2 - p;
  return p;
}

// cv2.GaussianBlur(src, (k, k), 0) for uint8 (h, w, c), k = 3, 5 or 7,
// BORDER_REFLECT_101: OpenCV's fixed-point route with its small-kernel
// table at sigma 0 (1/4 1/2 1/4; 1/16 4/16 6/16 4/16 1/16; 1/32 3.5/32
// 7/32 9/32 7/32 3.5/32 1/32), every weight a whole number of 1/256: the
// row pass sums exactly in 1/256 units, the column pass in 1/65536 units,
// the result rounded half up.  Returns 1 for another k.
int gaussian_blur_u8(const uint8_t* src, int h, int w, int c, uint8_t* dst,
                     int k) {
  static const int k3[3] = {64, 128, 64};
  static const int k5[5] = {16, 64, 96, 64, 16};
  static const int k7[7] = {8, 28, 56, 72, 56, 28, 8};
  const int* kt = k == 3 ? k3 : k == 5 ? k5 : k == 7 ? k7 : nullptr;
  if (!kt) return 1;
  const int r = k / 2;
  const size_t row = (size_t)w * c;
  uint32_t* tmp = (uint32_t*)std::malloc(sizeof(uint32_t) * h * row);
  if (!tmp) return 2;
#pragma omp parallel for schedule(static)
  for (int y = 0; y < h; ++y) {
    const uint8_t* in = src + y * row;
    for (int x = 0; x < w; ++x)
      for (int ch = 0; ch < c; ++ch) {
        uint32_t s = 0;
        for (int j = 0; j < k; ++j)
          s += (uint32_t)kt[j] * in[(size_t)reflect101(x + j - r, w) * c + ch];
        tmp[y * row + (size_t)x * c + ch] = s;
      }
  }
#pragma omp parallel for schedule(static)
  for (int y = 0; y < h; ++y) {
    uint8_t* out = dst + y * row;
    for (size_t i = 0; i < row; ++i) {
      uint32_t s = 0;
      for (int j = 0; j < k; ++j)
        s += (uint32_t)kt[j] * tmp[(size_t)reflect101(y + j - r, h) * row + i];
      const uint32_t v = (s + 32768) >> 16;
      out[i] = (uint8_t)(v > 255 ? 255 : v);
    }
  }
  std::free(tmp);
  return 0;
}

}  // extern "C"
