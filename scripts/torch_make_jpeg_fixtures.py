"""Write the JPEG fixtures of the port's image reader into
``tests/fixtures/torch_jpeg/`` with cv2, and what ``cv2.imread`` reads from
each (``expected.json``).

The set: four ADE-shaped 512x683 smooth-field images at quality 90
(baseline 4:2:0, progressive 4:2:0, 4:4:4 with a restart interval, grey),
and two small images with an EXIF orientation, a JPEG (APP1 ``Exif``
segment) and a PNG (``eXIf`` chunk).  ``expected.json`` holds, for each
file and each read mode (``color``, ``grayscale``), the shape and the
sha256 of the array ``cv2.imread`` returns, and the OpenCV and
libjpeg-turbo versions that read them.  ``tests/test_torch_jpeg.py`` and
``chip_smoke.py`` hold the port's decoder to those digests (the card's
machine has no cv2).

Usage: python scripts/torch_make_jpeg_fixtures.py [--out DIR]
"""

import argparse
import hashlib
import json
import os
import re
import struct
import zlib

import cv2
import numpy as np

ADE_HW = (512, 683)
QUALITY = 90
RST_INTERVAL = 4
EXIF_HW = (40, 64)
JPEG_ORIENTATION, PNG_ORIENTATION = 6, 5


def smooth_field(rng, hw, channels):
    """A smooth uint8 image: a coarse random grid, cubic-upsampled, with a
    little noise (a photograph's spectrum, roughly)."""
    grid = rng.random((hw[0] // 48 + 2, hw[1] // 48 + 2, channels))
    img = cv2.resize(grid, (hw[1], hw[0]), interpolation=cv2.INTER_CUBIC)
    img = img.reshape(*hw, channels) + rng.normal(0, 0.008, (*hw, channels))
    out = np.clip(img * 255, 0, 255).astype(np.uint8)
    return out[..., 0] if channels == 1 else out


def exif_block(orientation):
    """A little-endian TIFF block whose IFD0 holds only the orientation."""
    entry = struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0)
    return (b"II" + struct.pack("<HI", 42, 8) + struct.pack("<H", 1) + entry
            + struct.pack("<I", 0))


def with_app1(jpeg, tiff):
    """``jpeg`` with an APP1 Exif segment after its APP0."""
    length, = struct.unpack(">H", jpeg[4:6])
    app1 = b"Exif\0\0" + tiff
    return (jpeg[:4 + length] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2)
            + app1 + jpeg[4 + length:])


def with_exif_chunk(png, tiff):
    """``png`` with an eXIf chunk before its first IDAT."""
    at = png.index(b"IDAT") - 4
    chunk = (struct.pack(">I", len(tiff)) + b"eXIf" + tiff
             + struct.pack(">I", zlib.crc32(b"eXIf" + tiff)))
    return png[:at] + chunk + png[at:]


def encode(img, *params):
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, QUALITY,
                                         *params])
    assert ok
    return buf.tobytes()


def fixtures():
    rng = np.random.default_rng(22)
    colour = [smooth_field(rng, ADE_HW, 3) for _ in range(3)]
    grey = smooth_field(rng, ADE_HW, 1)
    small = smooth_field(rng, EXIF_HW, 3)
    s420 = [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420]
    return {
        "ade_baseline_420.jpg": encode(colour[0], *s420),
        "ade_progressive_420.jpg": encode(colour[1], *s420,
                                          cv2.IMWRITE_JPEG_PROGRESSIVE, 1),
        "ade_444_restart.jpg": encode(
            colour[2], cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            cv2.IMWRITE_JPEG_RST_INTERVAL, RST_INTERVAL),
        "ade_grey.jpg": encode(grey),
        "exif_orientation6.jpg": with_app1(encode(small, *s420),
                                           exif_block(JPEG_ORIENTATION)),
        "exif_orientation5.png": with_exif_chunk(
            cv2.imencode(".png", small)[1].tobytes(),
            exif_block(PNG_ORIENTATION)),
    }


def digest(arr):
    return {"shape": list(arr.shape),
            "sha256": hashlib.sha256(np.ascontiguousarray(arr).tobytes())
            .hexdigest()}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "tests", "fixtures", "torch_jpeg"))
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    expected = {}
    for name, data in fixtures().items():
        path = os.path.join(args.out, name)
        with open(path, "wb") as f:
            f.write(data)
        expected[name] = {
            "color": digest(cv2.imread(path, cv2.IMREAD_COLOR)),
            "grayscale": digest(cv2.imread(path, cv2.IMREAD_GRAYSCALE))}
    jpeg = re.search(r"JPEG:.*\(ver ([^)]*)\)", cv2.getBuildInformation())
    meta = {"opencv": cv2.__version__,
            "libjpeg_turbo": jpeg.group(1) if jpeg else None,
            "files": expected}
    with open(os.path.join(args.out, "expected.json"), "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
        f.write("\n")
    sizes = {n: os.path.getsize(os.path.join(args.out, n)) for n in expected}
    print(f"wrote {len(sizes)} fixtures, {sum(sizes.values())} bytes: "
          f"{sizes}")


if __name__ == "__main__":
    main()
