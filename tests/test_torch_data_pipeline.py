"""PyTorch port, the host data pipeline without cv2, against the JAX package
and OpenCV on the CPU.

  PNG reading (``data.image_io``): every PNG kind the port reads, written
      here by cv2 (grey, RGB, RGBA; its adaptive filters use all five
      types) and PIL (palette at 1, 2, 4 and 8 bits, grey+alpha, 1-bit
      grey), and one written here row by row in each of the five filter
      types, equal to ``cv2.imread`` in both read modes; 16-bit,
      interlaced and corrupt PNGs raise; a JPEG raises without cv2;
  the native library (``native``): its resizes equal the JAX package's
      native library bit for bit, bilinear within one code of cv2's
      INTER_LINEAR and nearest equal to INTER_NEAREST at the pipelines'
      uniform scales; ``transforms.resize_labels`` equal to INTER_NEAREST
      at any sizes;
  transforms: each against JAX's with the same ``np.random.default_rng``
      draws, labels exact, images bit-exact against JAX's native route;
  pipelines: ``SegTrainPre`` (with ``gt_down_sampling``), ``ADETrainPre``
      (float32 labels, as the ADE dataset reads them) bit-exact against
      JAX's native route at three seeds and scale draws; ``DFNTrainPre``:
      image within one code of JAX's cv2 route, labels and the Canny
      border label exact;
  ``canny`` equal to ``cv2.Canny(..., apertureSize=7)`` on label maps with
      many classes, edges at all angles and regions on the border, at
      DFN's thresholds and at others that exercise the hysteresis.
"""

import struct
import sys
import zlib

import cv2
import numpy as np
import pytest

from torchseg_tpu import native as jnative
from torchseg_tpu.data import preprocess as jpre
from torchseg_tpu.data import transforms as jT
from torchseg_tpu_torch import native
from torchseg_tpu_torch.data import image_io
from torchseg_tpu_torch.data import preprocess as tpre
from torchseg_tpu_torch.data import transforms as tT

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def _smooth(rng, h, w, c):
    y, x = np.mgrid[:h, :w]
    base = np.sin(x / 7.0) * 60 + np.cos(y / 5.0) * 60 + 128
    img = np.stack([base + rng.normal(0, 20, (h, w)) for _ in range(c)], -1)
    return np.clip(img, 0, 255).astype(np.uint8)


def _label_map(rng, h, w, n_classes):
    """Regions cut by random half-planes at all angles and rings, several
    touching the border."""
    y, x = np.mgrid[:h, :w]
    lab = np.zeros((h, w), np.int64)
    for _ in range(8):
        a = rng.uniform(0, 2 * np.pi)
        cx, cy = rng.uniform(0, w), rng.uniform(0, h)
        lab[(np.cos(a) * (x - cx) + np.sin(a) * (y - cy)) > 0] += int(
            rng.integers(1, n_classes))
    r = np.hypot(x - rng.uniform(0, w), y - rng.uniform(0, h))
    lab += (r // rng.uniform(3, 9)).astype(np.int64)
    return (lab % n_classes).astype(np.uint8)


# -- PNG ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("png")
    rng = np.random.default_rng(0)
    paths = []
    for h, w in ((37, 53), (64, 128), (5, 3)):
        for name, img in (("grey", _smooth(rng, h, w, 1)[..., 0]),
                          ("rgb", _smooth(rng, h, w, 3)),
                          ("rgba", _smooth(rng, h, w, 4)),
                          ("noise", rng.integers(0, 256, (h, w, 3),
                                                 dtype=np.uint8))):
            paths.append(str(d / f"{name}{h}.png"))
            assert cv2.imwrite(paths[-1], img)
        for n in (2, 4, 16, 200):  # PIL: 1, 2, 4 and 8 bits a pixel
            im = Image.fromarray(rng.integers(0, n, (h, w)).astype(np.uint8),
                                 "P")
            im.putpalette(rng.integers(0, 256, 768).astype(np.uint8).tolist())
            paths.append(str(d / f"p{n}_{h}.png"))
            im.save(paths[-1])
        paths.append(str(d / f"la{h}.png"))
        Image.fromarray(_smooth(rng, h, w, 2), "LA").save(paths[-1])
        paths.append(str(d / f"bw{h}.png"))
        Image.fromarray((rng.integers(0, 2, (h, w)) * 255).astype(
            np.uint8)).convert("1").save(paths[-1])
        paths.append(str(d / f"filters{h}.png"))
        write_png_all_filters(paths[-1], rng.integers(0, 256, (h, w, 3),
                                                      dtype=np.uint8))
    return paths


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def write_png_all_filters(path, img):
    """An 8-bit RGB PNG whose rows take the filter types 0-4 in turn."""
    h, w, _ = img.shape
    rows = img.reshape(h, w * 3).astype(int)
    out = bytearray()
    for y in range(h):
        t, row = y % 5, rows[y]
        up = rows[y - 1] if y else np.zeros_like(row)
        left = np.concatenate([[0, 0, 0], row[:-3]])
        ul = np.concatenate([[0, 0, 0], up[:-3]])
        pred = {0: 0 * row, 1: left, 2: up, 3: (left + up) // 2,
                4: np.array([_paeth(a, b, c) for a, b, c in zip(
                    left, up, ul)])}[t]
        out += bytes([t]) + bytes(((row - pred) % 256).astype(np.uint8))

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    with open(path, "wb") as f:
        f.write(image_io.PNG_SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(bytes(out)))
                + chunk(b"IEND", b""))


def _filter_types(path):
    data = open(path, "rb").read()
    chunks, pos = {}, 8
    while pos < len(data):
        n, t = struct.unpack(">I4s", data[pos:pos + 8])
        chunks.setdefault(t, []).append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    w, h, depth, ctype = struct.unpack(">IIBB", chunks[b"IHDR"][0][:10])
    stride = (w * {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype] * depth + 7) // 8
    raw = zlib.decompress(b"".join(chunks[b"IDAT"]))
    return {raw[i * (stride + 1)] for i in range(h)}


def test_png_reads_equal_cv2_imread(pngs):
    seen = set()
    for path in pngs:
        seen |= _filter_types(path)
        for mode in (image_io.COLOR, image_io.GRAYSCALE):
            ref = cv2.imread(path, mode)
            got = image_io.imread(path, mode)
            assert got.dtype == np.uint8 and got.shape == ref.shape, path
            np.testing.assert_array_equal(got, ref, err_msg=f"{path} {mode}")
    assert seen == {0, 1, 2, 3, 4}  # every filter type was decoded


def _rewrite_ihdr(data, **fields):
    """The PNG bytes with IHDR fields replaced and its CRC recomputed."""
    names = ("w", "h", "depth", "ctype", "comp", "filt", "interlace")
    vals = dict(zip(names, struct.unpack(">IIBBBBB", data[16:29])))
    vals.update(fields)
    payload = struct.pack(">IIBBBBB", *(vals[n] for n in names))
    crc = struct.pack(">I", zlib.crc32(b"IHDR" + payload))
    return data[:16] + payload + crc + data[33:]


def test_png_refusals(tmp_path, pngs, monkeypatch):
    deep = str(tmp_path / "deep.png")
    cv2.imwrite(deep, np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000)
    with pytest.raises(ValueError, match="16-bit.*deep.png|deep.png.*16-bit"):
        image_io.imread(deep)
    data = open(pngs[1], "rb").read()
    laced = tmp_path / "laced.png"
    laced.write_bytes(_rewrite_ihdr(data, interlace=1))
    with pytest.raises(ValueError, match="laced.png: Adam7-interlaced"):
        image_io.imread(str(laced))
    corrupt = tmp_path / "corrupt.png"
    corrupt.write_bytes(data[:20] + bytes([data[20] ^ 1]) + data[21:])
    with pytest.raises(ValueError, match="corrupt PNG chunk"):
        image_io.imread(str(corrupt))
    with pytest.raises(FileNotFoundError):
        image_io.imread(str(tmp_path / "missing.png"))
    jpg = str(tmp_path / "photo.jpg")
    cv2.imwrite(jpg, np.zeros((8, 8, 3), np.uint8))
    assert image_io.imread(jpg).shape == (8, 8, 3)  # through cv2 here
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="photo.jpg.*no JPEG"):
        image_io.imread(jpg)


# -- the native library -------------------------------------------------------

@pytest.mark.parametrize("shape", [(37, 53, 3), (480, 640, 3), (64, 96, 1),
                                   (1, 7, 3)])
def test_native_resizes_equal_jax_and_within_one_code_of_cv2(shape):
    rng = np.random.default_rng(shape[0])
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    if shape[2] == 1:
        img = img[..., 0]
    for s in (0.5, 0.75, 1.0, 1.25, 1.75, 2.0):
        dh, dw = max(1, int(shape[0] * s)), max(1, int(shape[1] * s))
        got = native.resize_bilinear(img, dh, dw)
        np.testing.assert_array_equal(got, jnative.resize_bilinear(
            img, dh, dw))
        ref = cv2.resize(img, (dw, dh), interpolation=cv2.INTER_LINEAR)
        assert int(np.abs(got.astype(int) - ref).max()) <= 1
        near = native.resize_nearest(img, dh, dw)
        np.testing.assert_array_equal(near, jnative.resize_nearest(
            img, dh, dw))
        np.testing.assert_array_equal(near, cv2.resize(
            img, (dw, dh), interpolation=cv2.INTER_NEAREST))


def test_label_resize_equals_cv2_nearest_at_any_size():
    rng = np.random.default_rng(5)
    for _ in range(100):
        sh, sw, dh, dw = (int(v) for v in rng.integers(1, 160, 4))
        gt = rng.integers(0, 255, (sh, sw)).astype(np.uint8)
        np.testing.assert_array_equal(
            tT.resize_labels(gt, dh, dw),
            cv2.resize(gt, (dw, dh), interpolation=cv2.INTER_NEAREST))
    gt = rng.integers(0, 151, (45, 61)).astype(np.float32)  # ADE's type
    got = tT.resize_labels(gt, 70, 70)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, cv2.resize(
        gt, (70, 70), interpolation=cv2.INTER_NEAREST))


def test_native_refuses_other_types():
    with pytest.raises(TypeError, match="uint8"):
        native.resize_bilinear(np.zeros((4, 4), np.float32), 2, 2)
    with pytest.raises(ValueError, match="integers in"):
        tT.label_codes(np.full((4, 4), 300, np.int32))


# -- transforms ---------------------------------------------------------------

def _pair(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (45, 61, 3), dtype=np.uint8),
            rng.integers(0, 19, (45, 61), dtype=np.uint8))


def _same_draws(fn_t, fn_j, seed):
    """Both functions called with generators of one seed; the generators
    end in the same state."""
    rt, rj = np.random.default_rng(seed), np.random.default_rng(seed)
    got, ref = fn_t(rt), fn_j(rj)
    assert rt.random() == rj.random()
    return got, ref


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_transforms_match_jax(seed):
    img, gt = _pair(seed)
    scales = (0.5, 0.75, 1, 1.25, 1.5, 2.0)
    # random_scale: the image as JAX's native route resizes it, exactly,
    # and within one code of JAX's cv2 route; the labels exact
    (ti, tg, ts), (ji, jg, js) = _same_draws(
        lambda r: tT.random_scale(r, img, gt, scales),
        lambda r: jT.random_scale(r, img, gt, scales), seed)
    assert ts == js
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_array_equal(ti, jnative.resize_bilinear(
        img, *ji.shape[:2]))
    assert int(np.abs(ti.astype(int) - ji).max()) <= 1
    (ti, tg, tn), (ji, jg, jn) = _same_draws(
        lambda r: tT.random_scale_with_length(r, img, gt, (32, 50, 70)),
        lambda r: jT.random_scale_with_length(r, img, gt, (32, 50, 70)), seed)
    assert tn == jn
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_array_equal(ti, jnative.resize_bilinear(img, jn, jn))
    for fn in ("random_mirror",):
        got, ref = _same_draws(lambda r: getattr(tT, fn)(r, img, gt),
                               lambda r: getattr(jT, fn)(r, img, gt), seed)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
    for size in ((32, 40), (50, 70), 44):
        got, ref = _same_draws(lambda r: tT.random_crop(r, img, gt, size),
                               lambda r: jT.random_crop(r, img, gt, size),
                               seed)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
        got, ref = _same_draws(
            lambda r: tT.generate_random_crop_pos(r, img.shape[:2], size),
            lambda r: jT.generate_random_crop_pos(r, img.shape[:2], size),
            seed)
        assert got == ref
        for a, pad in ((img, 0), (gt, 255)):
            g, gm = tT.random_crop_pad_to_shape(a, got, size, pad)
            r, rm = jT.random_crop_pad_to_shape(a, got, size, pad)
            np.testing.assert_array_equal(g, r)
            np.testing.assert_array_equal(gm, rm)
        np.testing.assert_array_equal(tT.center_crop(img, size),
                                      jT.center_crop(img, size))


def test_deterministic_transforms_match_jax():
    img, gt = _pair(9)
    for m in (8, 32):
        for a in (img, gt):
            g, gm = tT.pad_image_size_to_multiples_of(a, m, 7)
            r, rm = jT.pad_image_size_to_multiples_of(a, m, 7)
            np.testing.assert_array_equal(g, r)
            np.testing.assert_array_equal(gm, rm)
    for edge in (30, 64):
        got = tT.resize_ensure_shortest_edge(img, edge)
        ref = jT.resize_ensure_shortest_edge(img, edge)
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got, jnative.resize_bilinear(
            img, *ref.shape[:2]))


# -- pipelines ----------------------------------------------------------------

def _items(pre_t, pre_j, img, gt, seed):
    return _same_draws(lambda r: pre_t(r, img, gt),
                       lambda r: pre_j(r, img, gt), seed)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seg_and_ade_train_pre_match_jax_native_route(seed):
    assert jnative.available()  # JAX takes its native route here
    rng = np.random.default_rng(100 + seed)
    img = _smooth(rng, 90, 120, 3)
    gt = _label_map(rng, 90, 120, 19)
    gt[:5] = 255
    crop, scales = (64, 80), (0.5, 0.75, 1, 1.5, 1.75, 2.0)
    cases = [
        (tpre.SegTrainPre(MEAN, STD, crop, scales),
         jpre.SegTrainPre(MEAN, STD, crop, scales), gt),
        (tpre.SegTrainPre(MEAN, STD, crop, scales, gt_down_sampling=8),
         jpre.SegTrainPre(MEAN, STD, crop, scales, gt_down_sampling=8), gt),
        (tpre.SegTrainPre(MEAN, STD, (128, 160), None),
         jpre.SegTrainPre(MEAN, STD, (128, 160), None), gt),
        # the ADE dataset reads its labels as float32
        (tpre.ADETrainPre(MEAN, STD, crop, scales),
         jpre.ADETrainPre(MEAN, STD, crop, scales),
         (_label_map(rng, 90, 120, 151)).astype(np.float32)),
    ]
    for pre_t, pre_j, labels in cases:
        (ti, tg, te), (ji, jg, je) = _items(pre_t, pre_j, img, labels, seed)
        assert te is None and je is None
        assert ti.dtype == np.float32 and tg.dtype == np.int32
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tg, jg)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dfn_train_pre_matches_jax(seed):
    rng = np.random.default_rng(200 + seed)
    img = _smooth(rng, 90, 120, 3)
    gt = _label_map(rng, 90, 120, 19)
    gt[-6:, :30] = 255
    crop, scales = (64, 80), (0.5, 0.75, 1, 1.5, 1.75, 2.0)
    (ti, tg, te), (ji, jg, je) = _items(
        tpre.DFNTrainPre(MEAN, STD, crop, scales),
        jpre.DFNTrainPre(MEAN, STD, crop, scales), img, gt, seed)
    # one code of the uint8 image, after /255 and /std
    assert float(np.abs(ti - ji).max()) <= 1.0001 / 255 / min(STD)
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_array_equal(te["aux_label"], je["aux_label"])
    assert set(np.unique(te["aux_label"])) <= {0, 1, 255}
    assert (te["aux_label"] == 1).any()


def test_canny_equals_cv2():
    rng = np.random.default_rng(7)
    maps = [_label_map(rng, int(rng.integers(5, 90)), int(rng.integers(5, 90)),
                       n) for n in (2, 5, 19, 60, 150, 256) for _ in range(3)]
    maps += [rng.integers(0, 4, (33, 47)).astype(np.uint8),  # noise
             (rng.random((40, 40)) < 0.05).astype(np.uint8),  # 1-pixel bumps
             np.zeros((9, 9), np.uint8)]
    for lab in maps:
        for low, high in ((5, 5), (50, 100), (100, 50), (30, 400)):
            np.testing.assert_array_equal(
                tpre.canny(lab, low, high),
                cv2.Canny(lab, low, high, apertureSize=7),
                err_msg=f"{lab.shape} ({low}, {high})")


def test_border_label_equals_the_cv2_pipeline():
    rng = np.random.default_rng(8)
    gt = _label_map(rng, 120, 150, 19)
    gt[rng.random(gt.shape) < 0.02] = 255
    no255 = np.array(gt)
    no255[gt == 255] = 0
    ref = cv2.dilate(cv2.Canny(no255, 5, 5, apertureSize=7),
                     cv2.getStructuringElement(cv2.MORPH_RECT, (7, 7)))
    ref[ref == 255] = 1
    np.testing.assert_array_equal(tpre.border_label(gt), ref)
