"""PyTorch port, the JPEG decoder (``native/jpeg.cpp`` through
``data/image_io.imread``) against ``cv2.imread`` (OpenCV with libjpeg-turbo),
bit for bit in ``COLOR`` (BGR) and ``GRAYSCALE`` (a colour file's Y plane):

* ``cv2.imencode`` output at qualities 50, 75, 95 and 100; chroma sampling
  4:4:4, 4:2:2, 4:2:0, 4:1:1 and 4:4:0 and grey sources; baseline and
  progressive; Huffman optimization on and off; restart intervals 0, 1
  and 7; sizes 1x1, 17x23 and 255x333 (odd sizes, partial MCUs, planes
  two samples wide);
* a colour file without JFIF marker, one whose component ids read 'R',
  'G', 'B' and one with an Adobe marker of transform 0 (both RGB);
* a baseline file cut short (with and without restarts): libjpeg's zero
  bits past the end and its grey rest of the restart interval; a
  progressive one cut short decodes with a warning (no block smoothing);
* the refusals (arithmetic coding, lossless, hierarchical, 12-bit, two
  and four components, a file that is neither PNG nor JPEG), each a
  ValueError naming the file;
* the committed fixtures (``tests/fixtures/torch_jpeg/``,
  ``scripts/torch_make_jpeg_fixtures.py``) against the digests cv2 gave
  when they were written (``chip_smoke.py`` checks the same on the card's
  machine, which has no cv2).
"""

import hashlib
import json
import os
import struct
import warnings

import cv2
import numpy as np
import pytest

from torchseg_tpu_torch.data import image_io

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "torch_jpeg")
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}
SIZES = ((1, 1), (17, 23), (255, 333))
QUALITIES = (50, 75, 95, 100)
MODES = (image_io.COLOR, image_io.GRAYSCALE)


def _image(rng, hw, grey):
    """A smooth field with noise: every coefficient band gets energy."""
    c = 1 if grey else 3
    base = rng.random((max(hw[0] // 8, 2), max(hw[1] // 8, 2), c))
    img = cv2.resize(base, (hw[1], hw[0]), interpolation=cv2.INTER_CUBIC)
    img = img.reshape(*hw, c) + rng.normal(0, 0.08, (*hw, c))
    img = np.clip(img * 255, 0, 255).astype(np.uint8)
    return img[..., 0] if grey else img


def _encode(img, quality, sampling=None, progressive=0, optimize=0, rst=0):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_PROGRESSIVE, progressive,
              cv2.IMWRITE_JPEG_OPTIMIZE, optimize,
              cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
    if sampling is not None:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def _assert_reads_equal(path, modes=MODES):
    for mode in modes:
        ref = cv2.imread(str(path), mode)
        got = image_io.imread(str(path), mode)
        assert got.dtype == np.uint8 and got.shape == ref.shape, (mode,
                                                                  got.shape)
        assert np.array_equal(got, ref), (mode, int((got != ref).sum()))


@pytest.mark.parametrize("progressive", [0, 1])
@pytest.mark.parametrize("sampling", [*SAMPLING, "grey"])
def test_decoder_equals_cv2(tmp_path, sampling, progressive):
    """Every quality, size, restart interval and optimize setting of one
    sampling and one coding process, in both modes."""
    rng = np.random.default_rng(len(sampling) + 10 * progressive)
    grey = sampling == "grey"
    path = tmp_path / "x.jpg"
    for hw in SIZES:
        img = _image(rng, hw, grey)
        for quality in QUALITIES:
            for rst in (0, 1, 7):
                for optimize in (0, 1):
                    path.write_bytes(_encode(
                        img, quality, None if grey else sampling,
                        progressive, optimize, rst))
                    _assert_reads_equal(path)


def _segments(data):
    """(marker, start, end) of each marker segment before the scan."""
    pos, out = 2, []
    while data[pos + 1] != 0xDA:
        length, = struct.unpack(">H", data[pos + 2:pos + 4])
        out.append((data[pos + 1], pos, pos + 2 + length))
        pos += 2 + length
    return out


def _without_jfif(data):
    (_, a, b), = [s for s in _segments(data) if s[0] == 0xE0]
    return data[:a] + data[b:]


def test_rgb_colour_spaces_equal_cv2(tmp_path):
    """Without a JFIF marker, component ids 'R' 'G' 'B' or an Adobe marker
    of transform 0 make the three components RGB (no conversion), and
    GRAYSCALE libjpeg's rgb_gray_convert; ids 1 2 3 stay YCbCr."""
    img = _image(np.random.default_rng(3), (37, 45), False)
    plain = _without_jfif(_encode(img, 90, "420"))
    rgb = bytearray(plain)
    (_, sof, _), = [s for s in _segments(plain) if s[0] == 0xC0]
    sos = plain.index(b"\xff\xda")
    for i, cid in enumerate(b"RGB"):
        rgb[sof + 10 + 3 * i] = cid
        rgb[sos + 5 + 2 * i] = cid
    adobe = (plain[:2] + b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00"
             + plain[2:])
    for name, data in (("ids123", plain), ("idsRGB", bytes(rgb)),
                       ("adobe0", adobe)):
        path = tmp_path / f"{name}.jpg"
        path.write_bytes(data)
        _assert_reads_equal(path)


@pytest.mark.parametrize("rst", [0, 3])
def test_truncated_baseline_equals_cv2(tmp_path, rst):
    """Cut at a third, a half and near the end: cv2 warns of a premature
    end and returns the full image; libjpeg's zero bits past the end and
    its grey rest of the segment are reproduced exactly."""
    img = _image(np.random.default_rng(4), (255, 333), False)
    data = _encode(img, 90, "420", rst=rst)
    for frac in (0.33, 0.5, 0.97):
        path = tmp_path / f"cut{frac}.jpg"
        path.write_bytes(data[:int(len(data) * frac)])
        _assert_reads_equal(path)


def test_truncated_progressive_decodes_with_a_warning(tmp_path):
    data = _encode(_image(np.random.default_rng(5), (64, 80), False), 90,
                   "420", progressive=1)
    path = tmp_path / "cut.jpg"
    path.write_bytes(data[:len(data) // 3])
    with pytest.warns(UserWarning, match="cut.jpg: a truncated progressive"):
        got = image_io.imread(str(path))
    assert got.shape == (64, 80, 3)
    path.write_bytes(data)  # complete: no smoothing, no warning
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _assert_reads_equal(path)


def _patched(data, marker_from, marker_to=None, at=0, value=None):
    data = bytearray(data)
    pos = data.index(bytes([0xFF, marker_from]))
    if marker_to is not None:
        data[pos + 1] = marker_to
    if value is not None:
        data[pos + at] = value
    return bytes(data)


@pytest.mark.parametrize("kind,match", [
    ("arithmetic", "arithmetic-coded"), ("lossless", "lossless JPEG"),
    ("hierarchical", "hierarchical JPEG"), ("12bit", "12-bit"),
    ("cmyk", "4-component JPEG \\(CMYK/YCCK\\)"),
    ("two", "2-component"), ("gif", "neither a PNG nor a JPEG")])
def test_refusals_name_the_file(tmp_path, kind, match):
    base = _encode(_image(np.random.default_rng(6), (16, 16), False), 90)
    data = {
        "arithmetic": lambda: _patched(base, 0xC0, 0xC9),
        "lossless": lambda: _patched(base, 0xC0, 0xC3),
        "hierarchical": lambda: _patched(base, 0xC0, 0xC5),
        "12bit": lambda: _patched(base, 0xC0, at=4, value=12),
        "cmyk": lambda: _patched(base, 0xC0, at=9, value=4),
        "two": lambda: _patched(base, 0xC0, at=9, value=2),
        "gif": lambda: b"GIF89a" + bytes(32),
    }[kind]()
    path = tmp_path / f"{kind}.jpg"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=f"{kind}.jpg: .*{match}"):
        image_io.imread(str(path))


def _digest(arr):
    return {"shape": list(arr.shape),
            "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}


def test_fixtures_equal_their_recorded_cv2_digests():
    with open(os.path.join(FIXTURES, "expected.json")) as f:
        expected = json.load(f)
    assert expected["libjpeg_turbo"].startswith("3.")
    assert len(expected["files"]) == 6
    total = 0
    for name, want in expected["files"].items():
        path = os.path.join(FIXTURES, name)
        total += os.path.getsize(path)
        for key, mode in (("color", image_io.COLOR),
                          ("grayscale", image_io.GRAYSCALE)):
            assert _digest(image_io.imread(path, mode)) == want[key], (name,
                                                                       key)
            assert _digest(cv2.imread(path, mode)) == want[key], (name, key)
    assert total < 400_000
