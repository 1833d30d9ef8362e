"""Host image kernels of the data pipeline (counterpart of
torchseg_tpu/native/): ``augment.cpp`` and the JPEG decoder ``jpeg.cpp``,
each built with g++ at first use into the git-ignored
``torchseg_tpu_torch/_build/`` (``ops.kernels._build.host_library``:
hash-named, under the build lock) and bound with ctypes.

It is the port's only route for the uint8 resizes, the fused
crop/normalize/pad, the PNG unfilter, JPEG decoding (``decode_jpeg``: what
``cv2.imread`` gives through libjpeg-turbo, bit for bit), and cv2's
``warpAffine`` and ``GaussianBlur`` (``warp_affine``, ``gaussian_blur``,
for the transforms that call them): the route JAX's ``SegTrainPre``
takes wherever its library builds (``resize_bilinear``, within one code
of cv2), and, for the JAX functions that call ``cv2.resize(...,
INTER_LINEAR)`` (the transforms, the evaluator's scales and the speed
protocol's resize), ``resize_linear_cv``: cv2's own fixed-point
arithmetic, bit for bit.  (The copy keeps ``hflip_u8`` unbound: the
pipelines mirror with numpy views, as JAX's do.)  There is no fallback:
if the library cannot be built, ``lib()`` raises with the compiler's
message (the port never carries on through cv2).
"""

import ctypes
import functools
import os

import numpy as np

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "augment.cpp")
JPEG_SOURCE = os.path.join(os.path.dirname(SOURCE), "jpeg.cpp")


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """The built and loaded library (built once per checkout)."""
    from ..ops.kernels._build import host_library

    lb = ctypes.CDLL(host_library(SOURCE))
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    i = ctypes.c_int
    signatures = {
        "resize_bilinear_u8": [u8p, i, i, i, u8p, i, i],
        "resize_linear_fixed_u8": [u8p, i, i, i, u8p, i, i, i32p, i16p, i32p,
                                   i16p],
        "resize_area2_u8": [u8p, i, i, i, u8p, i, i],
        "resize_nearest_u8": [u8p, i, i, i, u8p, i, i],
        "crop_normalize_pad_f32": [u8p, i, i, i, f32p, f32p, f32p, i, i, i,
                                   i, ctypes.c_float],
        "crop_pad_i32": [i32p, i, i, i32p, i, i, i, i, ctypes.c_int32],
        "png_unfilter": [u8p, i, i, i, u8p],
        "warp_affine_u8": [u8p, i, i, i, u8p, i, i,
                           np.ctypeslib.ndpointer(np.float64), i],
        "gaussian_blur_u8": [u8p, i, i, i, u8p, i],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lb, name)
        fn.argtypes = argtypes
        fn.restype = (ctypes.c_int if name in ("png_unfilter",
                                               "gaussian_blur_u8") else None)
    return lb


@functools.lru_cache(maxsize=None)
def jpeg_lib() -> ctypes.CDLL:
    """The built and loaded JPEG decoder (``jpeg.cpp``)."""
    from ..ops.kernels._build import host_library

    lb = ctypes.CDLL(host_library(JPEG_SOURCE))
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    buf, size = ctypes.c_char_p, ctypes.c_long
    lb.jpeg_header.argtypes = [buf, size, np.ctypeslib.ndpointer(np.int32),
                               ctypes.c_char_p, ctypes.c_int]
    lb.jpeg_decode.argtypes = [buf, size, ctypes.c_int, u8p, ctypes.c_char_p,
                               ctypes.c_int]
    lb.jpeg_header.restype = lb.jpeg_decode.restype = ctypes.c_int
    return lb


def _hwc(img: np.ndarray):
    """(contiguous uint8 image, h, w, channels)."""
    if img.dtype != np.uint8:
        raise TypeError(f"the native kernels take uint8 images, not "
                        f"{img.dtype}")
    img = np.ascontiguousarray(img)
    h, w = img.shape[:2]
    return img, h, w, 1 if img.ndim == 2 else img.shape[2]


def _resize(fn_name: str, img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    img, h, w, c = _hwc(img)
    if dh < 1 or dw < 1:
        raise ValueError(f"resize to {dh}x{dw}")
    out = np.empty((dh, dw) if img.ndim == 2 else (dh, dw, c), np.uint8)
    getattr(lib(), fn_name)(img.reshape(h, w, c), h, w, c,
                            out.reshape(dh, dw, c), dh, dw)
    return out


def resize_bilinear(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """uint8 (H, W[, C]) -> (dh, dw[, C]), half-pixel bilinear."""
    return _resize("resize_bilinear_u8", img, dh, dw)


def _linear_table(n_out: int, scale: float):
    """OpenCV's source index and 11-bit weight pair of each output
    position, in its float order: the coordinate ``(d + 0.5) * scale -
    0.5`` in double, cast to float, floored; the fraction and ``1 - f`` in
    float, times 2048 and rounded half to even (``saturate_cast<short>``)."""
    f = ((np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5).astype(
        np.float32)
    s = np.floor(f)
    f = f - s
    w = np.stack([(np.float32(1) - f) * np.float32(2048),
                  f * np.float32(2048)], axis=1)
    return s.astype(np.int32), np.rint(w).astype(np.int16)


def resize_linear_cv(img: np.ndarray, dsize=None, fx: float = 0.0,
                     fy: float = 0.0) -> np.ndarray:
    """``cv2.resize(img, dsize, fx=fx, fy=fy, interpolation=
    cv2.INTER_LINEAR)`` for uint8 (H, W[, C]) images of 1-4 channels, bit
    for bit (one channel comes back (H, W), as from cv2).  ``dsize`` is
    cv2's (width, height), the scale then in / out; without it the output
    is ``round(in * f)`` and the scale ``1 / f``.  Scales of exactly 2 take
    cv2's 2x area route; otherwise its fixed-point bilinear route, edge
    rows blended with themselves as OpenCV does (see ``augment.cpp``)."""
    img, h, w, c = _hwc(img)
    if not 1 <= c <= 4:
        raise ValueError(f"{c} channels: cv2's INTER_LINEAR port takes 1-4")
    if dsize is None:
        if fx <= 0 or fy <= 0:
            raise ValueError("resize_linear_cv needs dsize or fx, fy > 0")
        dw, dh = round(w * fx), round(h * fy)
        inv_x, inv_y = float(fx), float(fy)
    else:
        dw, dh = int(dsize[0]), int(dsize[1])
        inv_x, inv_y = dw / w, dh / h
    if dh < 1 or dw < 1:
        raise ValueError(f"resize to {dh}x{dw}")
    # cv2 gives a one-channel image back without its channel axis
    shape = (dh, dw) if c == 1 else (dh, dw, c)
    if (dh, dw) == (h, w):
        return img.reshape((h, w) if c == 1 else (h, w, c)).copy()
    out = np.empty(shape, np.uint8)
    scale_x, scale_y = 1.0 / inv_x, 1.0 / inv_y
    if scale_x == 2.0 and scale_y == 2.0:
        lib().resize_area2_u8(img.reshape(h, w, c), h, w, c,
                              out.reshape(dh, dw, c), dh, dw)
        return out
    xofs, xa = _linear_table(dw, scale_x)
    clamped = (xofs < 0) | (xofs >= w - 1)  # cv2 clamps columns, not rows
    xofs = np.clip(xofs, 0, w - 1).astype(np.int32)
    xa[clamped] = (2048, 0)
    yofs, yb = _linear_table(dh, scale_y)
    lib().resize_linear_fixed_u8(img.reshape(h, w, c), h, w, c,
                                 out.reshape(dh, dw, c), dh, dw, xofs,
                                 np.ascontiguousarray(xa), yofs, yb)
    return out


def resize_nearest(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """uint8 (H, W[, C]) -> (dh, dw[, C]), cv2's INTER_NEAREST."""
    return _resize("resize_nearest_u8", img, dh, dw)


def crop_normalize_pad(img: np.ndarray, mean, std, ch: int, cw: int,
                       y0: int, x0: int, pad_val: float = 0.0) -> np.ndarray:
    """uint8 HWC -> float32 (ch, cw, C): the window at (y0, x0) of the
    source frame (it may reach outside), /255 then (x - mean) / std,
    ``pad_val`` outside the image."""
    img, h, w, c = _hwc(img)
    if img.ndim != 3:
        raise ValueError("crop_normalize_pad takes an (H, W, C) image")
    out = np.empty((ch, cw, c), np.float32)
    lib().crop_normalize_pad_f32(
        img, h, w, c, np.ascontiguousarray(mean, np.float32),
        np.ascontiguousarray(std, np.float32), out, ch, cw, y0, x0,
        ctypes.c_float(float(pad_val)))
    return out


def crop_pad_labels(gt: np.ndarray, ch: int, cw: int, y0: int, x0: int,
                    pad_val: int) -> np.ndarray:
    """int32 (ch, cw) window of the (H, W) labels at (y0, x0), ``pad_val``
    outside."""
    gt = np.ascontiguousarray(gt, np.int32)
    h, w = gt.shape
    out = np.empty((ch, cw), np.int32)
    lib().crop_pad_i32(gt, h, w, out, ch, cw, y0, x0, int(pad_val))
    return out


def png_unfilter(raw: np.ndarray, rows: int, stride: int, bpp: int
                 ) -> np.ndarray:
    """PNG scanlines (rows * (1 + stride) inflated bytes) -> (rows,
    stride) uint8; raises ValueError on an unknown filter type."""
    raw = np.ascontiguousarray(raw, np.uint8).reshape(-1)
    if raw.size != rows * (stride + 1):
        raise ValueError(f"{raw.size} bytes of image data, expected "
                         f"{rows * (stride + 1)}")
    out = np.empty((rows, stride), np.uint8)
    bad = lib().png_unfilter(raw, rows, stride, bpp, out)
    if bad:
        kind = raw[(bad - 1) * (stride + 1)]
        raise ValueError(f"unknown PNG filter type {kind} on row {bad - 1}")
    return out


def decode_jpeg(data: bytes, color: bool, path: str = "<bytes>"):
    """JPEG bytes -> ((H, W, 3) BGR if ``color`` else (H, W) uint8, whether
    libjpeg would have block-smoothed it): ``cv2.imdecode`` before any EXIF
    orientation.  Raises ValueError naming ``path`` for what the decoder
    refuses (see ``jpeg.cpp``)."""
    lb = jpeg_lib()
    err = ctypes.create_string_buffer(256)
    info = np.zeros(3, np.int32)
    if lb.jpeg_header(data, len(data), info, err, len(err)):
        raise ValueError(f"{path}: {err.value.decode()}")
    h, w = int(info[0]), int(info[1])
    out = np.empty((h, w, 3) if color else (h, w), np.uint8)
    rc = lb.jpeg_decode(data, len(data), int(color), out, err, len(err))
    if rc == 1:
        raise ValueError(f"{path}: {err.value.decode()}")
    return out, rc == 2


def warp_affine(img: np.ndarray, m, dsize, nearest: bool) -> np.ndarray:
    """``cv2.warpAffine(img, m, dsize, flags=INTER_NEAREST if nearest else
    INTER_LINEAR)`` (BORDER_CONSTANT 0) for uint8 (H, W) or (H, W, 3)
    images, bit for bit; ``dsize`` is cv2's (width, height)."""
    img, h, w, c = _hwc(img)
    if c not in (1, 3):
        raise ValueError(f"warp_affine takes 1 or 3 channels, not {c}")
    dw, dh = int(dsize[0]), int(dsize[1])
    out = np.empty((dh, dw) if img.ndim == 2 else (dh, dw, c), np.uint8)
    m = np.ascontiguousarray(np.asarray(m, np.float64).reshape(6))
    lib().warp_affine_u8(img.reshape(h, w, c), h, w, c,
                         out.reshape(dh, dw, c), dh, dw, m, int(nearest))
    return out


def gaussian_blur(img: np.ndarray, k: int) -> np.ndarray:
    """``cv2.GaussianBlur(img, (k, k), 0)`` for uint8 (H, W[, C]) images
    and k = 3, 5 or 7, bit for bit."""
    img, h, w, c = _hwc(img)
    if k not in (3, 5, 7):
        raise ValueError(f"gaussian_blur takes k = 3, 5 or 7, not {k}")
    out = np.empty_like(img)
    if lib().gaussian_blur_u8(img.reshape(h, w, c), h, w, c,
                              out.reshape(h, w, c), k):
        raise MemoryError("gaussian_blur: no memory for the row pass")
    return out
