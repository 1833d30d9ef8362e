"""Host image kernels of the data pipeline (counterpart of
torchseg_tpu/native/): ``augment.cpp``, built with g++ at first use into
the git-ignored ``torchseg_tpu_torch/_build/`` (``ops.kernels._build.
host_library``: hash-named, under the build lock) and bound with ctypes.

It is the port's only route for the uint8 resizes, the fused
crop/normalize/pad and the PNG unfilter: the route JAX's ``SegTrainPre``
takes wherever its library builds.  (The copy keeps ``hflip_u8`` unbound:
the pipelines mirror with numpy views, as JAX's do.)  There is no fallback: if the library
cannot be built, ``lib()`` raises with the compiler's message (the port
never carries on through cv2).
"""

import ctypes
import functools
import os

import numpy as np

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "augment.cpp")


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """The built and loaded library (built once per checkout)."""
    from ..ops.kernels._build import host_library

    lb = ctypes.CDLL(host_library(SOURCE))
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i = ctypes.c_int
    signatures = {
        "resize_bilinear_u8": [u8p, i, i, i, u8p, i, i],
        "resize_nearest_u8": [u8p, i, i, i, u8p, i, i],
        "crop_normalize_pad_f32": [u8p, i, i, i, f32p, f32p, f32p, i, i, i,
                                   i, ctypes.c_float],
        "crop_pad_i32": [i32p, i, i, i32p, i, i, i, i, ctypes.c_int32],
        "png_unfilter": [u8p, i, i, i, u8p],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lb, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int if name == "png_unfilter" else None
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
