"""PyTorch port, EXIF orientation in ``data/image_io.imread``: a PNG's
``eXIf`` chunk (before or after the image data) and a JPEG's APP1
``Exif`` segment, in both TIFF byte orders, for every orientation 1-8
(and two values outside it, which mean 1), read as ``cv2.imread`` reads
them in ``COLOR`` and ``GRAYSCALE``: the image flipped, rotated or
transposed as OpenCV's ``ApplyExifOrientation`` turns it.  A malformed
block means orientation 1.  The EXIF bytes are spliced into
``cv2.imencode`` output here.  (The reader before this one ignored a
PNG's orientation, which cv2 applies.)
"""

import struct
import zlib

import cv2
import numpy as np
import pytest

from torchseg_tpu_torch.data import image_io

HW = (5, 7)  # neither square nor even: every orientation is distinct


def exif_block(orientation, order="<"):
    """A TIFF block whose IFD0 holds a software tag and the orientation."""
    mark = b"II" if order == "<" else b"MM"
    entries = (struct.pack(order + "HHII", 0x0131, 2, 4, 0)
               + struct.pack(order + "HHIHH", 0x0112, 3, 1, orientation, 0))
    return (mark + struct.pack(order + "HI", 42, 8)
            + struct.pack(order + "H", 2) + entries
            + struct.pack(order + "I", 0))


def with_exif_chunk(png, tiff, before_idat):
    at = (png.index(b"IDAT") if before_idat else png.index(b"IEND")) - 4
    chunk = (struct.pack(">I", len(tiff)) + b"eXIf" + tiff
             + struct.pack(">I", zlib.crc32(b"eXIf" + tiff)))
    return png[:at] + chunk + png[at:]


def with_app1(jpeg, tiff):
    length, = struct.unpack(">H", jpeg[4:6])
    app1 = b"Exif\0\0" + tiff
    return (jpeg[:4 + length] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2)
            + app1 + jpeg[4 + length:])


def _image():
    return np.random.default_rng(0).integers(0, 256, (*HW, 3), np.uint8)


def _check(path):
    for mode in (image_io.COLOR, image_io.GRAYSCALE):
        ref = cv2.imread(str(path), mode)
        got = image_io.imread(str(path), mode)
        assert got.shape == ref.shape and np.array_equal(got, ref), mode
        assert got.flags.c_contiguous


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("orientation", range(10))
def test_png_orientation_equals_cv2(tmp_path, orientation, order):
    png = cv2.imencode(".png", _image())[1].tobytes()
    for before in (True, False):
        path = tmp_path / f"o{orientation}.png"
        path.write_bytes(with_exif_chunk(png, exif_block(orientation, order),
                                         before))
        _check(path)


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("orientation", range(10))
def test_jpeg_orientation_equals_cv2(tmp_path, orientation, order):
    jpeg = cv2.imencode(".jpg", _image())[1].tobytes()
    path = tmp_path / f"o{orientation}.jpg"
    path.write_bytes(with_app1(jpeg, exif_block(orientation, order)))
    _check(path)


def test_orientation_reads_and_malformed_blocks():
    assert [image_io.exif_orientation(exif_block(o)) for o in range(10)] == \
        [1, 1, 2, 3, 4, 5, 6, 7, 8, 1]
    good = exif_block(6, ">")
    for bad in (None, b"", good[:12], b"XX" + good[2:],
                good[:2] + b"\x00\x2b" + good[4:], good[:-16]):
        assert image_io.exif_orientation(bad) == 1
    img = np.arange(6).reshape(2, 3)
    assert np.array_equal(image_io.orient(img, 6), np.rot90(img, -1))
    assert np.array_equal(image_io.orient(img, 8), np.rot90(img, 1))
    assert np.array_equal(image_io.orient(img, 3), np.rot90(img, 2))
