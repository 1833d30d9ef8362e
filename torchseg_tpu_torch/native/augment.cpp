// Host image kernels of the data pipeline, bound with ctypes
// (torchseg_tpu_torch/native/__init__.py).
//
// A copy of the JAX package's torchseg_tpu/native/src/augment.cpp (the
// uint8 resizes, the flip and the fused crop/normalize/pad), whose
// arithmetic it keeps line for line, so that the port's data pipeline
// gives the bits of JAX's native route; plus cv2's own INTER_LINEAR (the
// route of the JAX functions that call cv2.resize) and the PNG scanline
// unfilter that the port's PNG reader (data/image_io.py) runs.
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

}  // extern "C"
