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

16-bit and Adam7-interlaced PNGs raise ValueError naming the file.

JPEG (the images of ADE, VOC and PASCAL-Context) is decoded by the port's
own decoder (``native/jpeg.cpp``, ``native.decode_jpeg``), which gives what
``cv2.imread`` gives through libjpeg-turbo bit for bit: (H, W, 3) BGR for
``COLOR``, the Y plane for a colour file read as ``GRAYSCALE``.  A
truncated progressive file that libjpeg would block-smooth decodes
unsmoothed, with a warning.  Any other format raises ValueError naming the
file: the port reads PNG and JPEG, which is every dataset's.

EXIF orientation, as cv2 applies it in both read modes: the tag 0x0112 of
IFD0 of a PNG's ``eXIf`` chunk or of a JPEG's APP1 ``Exif`` segment (either
TIFF byte order), applied as OpenCV's ``ApplyExifOrientation`` does (2
flip left-right, 3 rotate 180, 4 flip up-down, 5 transpose, 6 rotate 90
clockwise, 7 transverse, 8 rotate 90 counter-clockwise); a missing or
malformed block, or another value, means 1 (as read).

Writing (``imwrite``, ``encode_png``; the evaluator's ``cv2.imwrite`` of
predictions, submissions and composites): 8-bit grey and 3-channel PNGs,
every row of filter type 0, deflated by the standard library's ``zlib``.
As with ``cv2.imwrite``, a 3-channel array is taken as BGR and the file
holds RGB.
"""

import struct
import warnings
import zlib

import numpy as np

from .. import native

COLOR = 1       # cv2.IMREAD_COLOR
GRAYSCALE = 0   # cv2.IMREAD_GRAYSCALE

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SOI = b"\xff\xd8"
EXIF_ORIENTATION = 0x0112
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
    header, palette, idat, exif = None, None, [], None
    for ctype, payload in _chunks(data, path):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif ctype == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(payload)
        elif ctype == b"eXIf" and exif is None:
            exif = payload
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
        img = (grey if mode == GRAYSCALE
               else np.repeat(grey[..., None], 3, axis=2))
        return orient(img, exif_orientation(exif))
    img = rgb_to_grey(rgb) if mode == GRAYSCALE else rgb[..., ::-1]
    return orient(img, exif_orientation(exif))


def exif_orientation(tiff) -> int:
    """The orientation (1-8) in IFD0 of a TIFF-structured EXIF block; 1 for
    None, a malformed block, no tag or a value outside 1-8."""
    if not tiff or len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    end = "<" if tiff[:2] == b"II" else ">"
    magic, ifd = struct.unpack(end + "HI", tiff[2:8])
    if magic != 42 or ifd + 2 > len(tiff):
        return 1
    count, = struct.unpack(end + "H", tiff[ifd:ifd + 2])
    for pos in range(ifd + 2, ifd + 2 + 12 * count, 12):
        if pos + 12 > len(tiff):
            return 1
        tag, = struct.unpack(end + "H", tiff[pos:pos + 2])
        if tag == EXIF_ORIENTATION:
            value, = struct.unpack(end + "H", tiff[pos + 8:pos + 10])
            return value if 1 <= value <= 8 else 1
    return 1


def orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """``img`` (H, W[, C]) as OpenCV's ``ApplyExifOrientation`` turns it
    for an EXIF orientation; a contiguous array."""
    if orientation >= 5:  # 5-8 transpose first
        img = img.swapaxes(0, 1)
    flips = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}
    for axis in flips.get(orientation, ()):
        img = np.flip(img, axis)
    return np.ascontiguousarray(img)


def jpeg_exif(data: bytes):
    """The TIFF block of a JPEG's first APP1 ``Exif`` segment before its
    first scan, or None."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker == 0xFF:  # fill byte
            pos += 1
            continue
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        if marker in (0xDA, 0xD9):
            return None
        length, = struct.unpack(">H", data[pos + 2:pos + 4])
        if marker == 0xE1 and data[pos + 4:pos + 10] == b"Exif\0\0":
            return data[pos + 10:pos + 2 + length]
        pos += 2 + length
    return None


def decode_jpeg(data: bytes, mode: int = COLOR, path: str = "<bytes>"
                ) -> np.ndarray:
    """JPEG bytes -> the array ``cv2.imread(path, mode)`` gives."""
    img, unsmoothed = native.decode_jpeg(data, mode == COLOR, path)
    if unsmoothed:
        warnings.warn(f"{path}: a truncated progressive JPEG, decoded "
                      f"without libjpeg's block smoothing (cv2 reads other "
                      f"pixels)", stacklevel=3)
    return orient(img, exif_orientation(jpeg_exif(data)))


def rgb_to_grey(rgb: np.ndarray) -> np.ndarray:
    """libpng's 8-bit rgb_to_gray without gamma: (R r + G g + B b) >> 15
    on the 15-bit weights, a grey pixel (r = g = b) unchanged."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    mixed = ((RED_15 * r + GREEN_15 * g + BLUE_15 * b) >> 15).astype(
        np.uint8)
    grey = (r == g) & (r == b)
    return np.where(grey, rgb[..., 0], mixed)


def imread(path: str, mode: int = COLOR) -> np.ndarray:
    """``cv2.imread(path, mode)`` for ``COLOR`` and ``GRAYSCALE`` of a PNG
    or JPEG file.  Raises FileNotFoundError for a missing file and
    ValueError naming the file for any other format."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        raise FileNotFoundError(path) from None
    if data.startswith(PNG_SIGNATURE):
        return decode_png(data, mode, path)
    if data.startswith(JPEG_SOI):
        return decode_jpeg(data, mode, path)
    raise ValueError(f"{path}: neither a PNG nor a JPEG file (the port "
                     f"reads those two formats)")


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def encode_png(img: np.ndarray, level: int = 1) -> bytes:
    """uint8 (H, W), (H, W, 1) or BGR (H, W, 3) -> PNG bytes (grey or RGB,
    8 bits), deflated at zlib ``level``."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"PNG writing takes uint8 images, not {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 3 and img.shape[2] == 3:
        img, ctype = img[..., ::-1], 2  # BGR in, RGB in the file
    elif img.ndim == 2:
        ctype = 0
    else:
        raise ValueError(f"PNG writing takes grey or 3-channel images, not "
                         f"{img.shape}")
    h, w = img.shape[:2]
    rows = np.zeros((h, 1 + img[0].size), np.uint8)  # filter type 0
    rows[:, 1:] = img.reshape(h, -1)
    return (PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0,
                                          0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def imwrite(path: str, img: np.ndarray):
    """``cv2.imwrite(path, img)`` for a PNG path (see ``encode_png``)."""
    if not path.lower().endswith(".png"):
        raise ValueError(f"{path}: the port writes PNG files only")
    with open(path, "wb") as f:
        f.write(encode_png(img))
