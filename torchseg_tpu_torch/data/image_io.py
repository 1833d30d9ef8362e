"""Image reading without OpenCV (the reads of JAX's ``data/base.py``,
``cv2.imread``).

PNG is decoded here: the chunks parsed and their CRCs checked, the image
data inflated with ``zlib``, the scanlines unfiltered by the native
library (``native.png_unfilter``: the five filter types) and the pixels
laid out with numpy.  Supported: non-interlaced PNGs of bit depth 8 in
grey, grey+alpha, RGB and RGBA, and of bit depth 1, 2, 4 or 8 in grey and
palette.  The result is what ``cv2.imread`` gives:

  * ``COLOR``: (H, W, 3) uint8 BGR; alpha dropped (not composited), grey
    replicated, a palette expanded;
  * ``GRAYSCALE``: (H, W) uint8; a colour image through libpng's
    ``png_set_rgb_to_gray(0.299, 0.587)`` fixed point (15-bit weights,
    the sum truncated; a pixel with R = G = B kept as it is), which is
    what cv2's PNG decoder asks libpng for; grey below 8 bits scaled to
    0-255.

16-bit and Adam7-interlaced PNGs raise ValueError naming the file.  Every
other format (the JPEG images of ADE, VOC and PASCAL-Context) goes
through ``cv2.imread`` when cv2 is importable, and otherwise raises
RuntimeError: the port has no JPEG decoder of its own yet (ROADMAP A6).
Cityscapes (PNG images and labels) and every dataset's PNG labels need no
cv2.
"""

import struct
import zlib

import numpy as np

from .. import native

COLOR = 1       # cv2.IMREAD_COLOR
GRAYSCALE = 0   # cv2.IMREAD_GRAYSCALE

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# libpng's png_set_rgb_to_gray_fixed(29900, 58700): (w * 32768) / 100000
# truncated, blue the rest of 32768
RED_15, GREEN_15 = 29900 * 32768 // 100000, 58700 * 32768 // 100000
BLUE_15 = 32768 - RED_15 - GREEN_15

# colour type -> samples a pixel
_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8), 2: (8,), 3: (1, 2, 4, 8), 4: (8,), 6: (8,)}


def _chunks(data: bytes, path: str):
    """(type, payload) of each chunk, CRCs checked."""
    pos = len(PNG_SIGNATURE)
    while pos + 12 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        payload = data[pos + 8:pos + 8 + length]
        crc, = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(payload) != length or zlib.crc32(ctype + payload) != crc:
            raise ValueError(f"{path}: corrupt PNG chunk {ctype!r}")
        yield ctype, payload
        if ctype == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG ends without an IEND chunk")


def decode_png(data: bytes, mode: int = COLOR, path: str = "<bytes>"
               ) -> np.ndarray:
    """PNG bytes -> the array ``cv2.imread(path, mode)`` gives."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, palette, idat = None, None, []
    for ctype, payload in _chunks(data, path):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif ctype == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _SAMPLES:
        raise ValueError(f"{path}: unknown PNG colour type {ctype}")
    if depth == 16:
        raise ValueError(f"{path}: 16-bit PNG is not supported")
    if depth not in _DEPTHS[ctype]:
        raise ValueError(f"{path}: bit depth {depth} with colour type "
                         f"{ctype} is not a valid PNG")
    if interlace:
        raise ValueError(f"{path}: Adam7-interlaced PNG is not supported")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    samples = _SAMPLES[ctype]
    stride = (w * samples * depth + 7) // 8
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt PNG image data ({e})") from None
    if raw.size < h * (stride + 1):
        raise ValueError(f"{path}: truncated PNG image data")
    rows = native.png_unfilter(raw[:h * (stride + 1)], h, stride,
                               max(1, samples * depth // 8))
    if depth < 8:
        bits = np.unpackbits(rows, axis=1)[:, :w * depth].reshape(h, w,
                                                                   depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        px = (bits * weights).sum(axis=-1, dtype=np.uint8)[..., None]
        if ctype == 0:  # libpng's png_set_expand_gray_1_2_4_to_8
            px = px * np.uint8(255 // ((1 << depth) - 1))
    else:
        px = rows[:, :w * samples].reshape(h, w, samples)
    if ctype == 3:
        if int(px.max(initial=0)) >= len(palette):
            raise ValueError(f"{path}: palette index beyond the PLTE chunk")
        rgb = palette[px[..., 0]]
    elif ctype in (2, 6):
        rgb = px[..., :3]
    else:  # grey, grey + alpha
        grey = px[..., 0]
        return (np.ascontiguousarray(grey) if mode == GRAYSCALE
                else np.repeat(grey[..., None], 3, axis=2))
    if mode == GRAYSCALE:
        return rgb_to_grey(rgb)
    return np.ascontiguousarray(rgb[..., ::-1])


def rgb_to_grey(rgb: np.ndarray) -> np.ndarray:
    """libpng's 8-bit rgb_to_gray without gamma: (R r + G g + B b) >> 15
    on the 15-bit weights, a grey pixel (r = g = b) unchanged."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    mixed = ((RED_15 * r + GREEN_15 * g + BLUE_15 * b) >> 15).astype(
        np.uint8)
    grey = (r == g) & (r == b)
    return np.where(grey, rgb[..., 0], mixed)


def imread(path: str, mode: int = COLOR) -> np.ndarray:
    """``cv2.imread(path, mode)`` for ``COLOR`` and ``GRAYSCALE``; PNG
    decoded here, anything else through cv2 when it is importable.
    Raises FileNotFoundError for a missing file."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        raise FileNotFoundError(path) from None
    if data.startswith(PNG_SIGNATURE):
        return decode_png(data, mode, path)
    try:
        import cv2
    except ImportError:
        raise RuntimeError(
            f"{path}: not a PNG, and this machine has no JPEG (or other "
            f"image) decoder: the port decodes PNG itself and reads other "
            f"formats through cv2, which is not installed (a decoder of "
            f"the port's own is ROADMAP A6)") from None
    img = cv2.imread(path, mode)
    if img is None:
        raise FileNotFoundError(path)
    return img
