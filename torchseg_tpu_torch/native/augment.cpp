// Host image kernels of the data pipeline, bound with ctypes
// (torchseg_tpu_torch/native/__init__.py).
//
// A copy of the JAX package's torchseg_tpu/native/src/augment.cpp (the
// uint8 resizes, the flip and the fused crop/normalize/pad), whose
// arithmetic it keeps line for line, so that the port's data pipeline
// gives the bits of JAX's native route; plus the PNG scanline unfilter
// that the port's PNG reader (data/image_io.py) runs.  OpenMP-parallel,
// GIL-free loops.
//
// Semantics:
//   * bilinear resize: half-pixel centers, edge clamp (cv2 INTER_LINEAR,
//     within one code of it)
//   * nearest resize:  sx = floor(dx * scale) (cv2 INTER_NEAREST)
//   * normalize: /255 then (x - mean) / std   (img_utils.py:181-187)
//   * crop+pad: fixed window with constant pad value (img_utils.py:24-39)
//   * PNG unfilter: the five filter types of the PNG specification

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

}  // extern "C"
