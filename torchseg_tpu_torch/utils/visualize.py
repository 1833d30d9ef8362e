"""Visualization helpers (counterpart of torchseg_tpu/utils/visualize.py,
the reference's furnace/utils/visualize.py): class-colour overlays and the
per-class IoU table, in numpy on the host."""

from typing import Optional, Sequence

import numpy as np


def set_img_color(colors, background, img, pred, gt=None, show255=False):
    """Colour pixels by predicted class (reference visualize.py:6-21)."""
    for i in range(len(colors)):
        img[pred == i] = colors[i]
    if show255 and gt is not None:
        img[gt == 255] = [255, 255, 255]
    return img


def show_prediction(colors, background, img, pred, weight=0.5):
    """Blend the class colours over the image (reference
    visualize.py:24-39)."""
    im = np.array(img, np.uint8)
    canvas = im.copy()
    set_img_color(colors, background, canvas, pred)
    return (im * (1 - weight) + canvas * weight).astype(np.uint8)


def show_img(colors, background, img, gt, *preds, weight=0.5):
    """Side-by-side composite [image | coloured gt | coloured preds...]
    with white separators (the reference's eval -s)."""
    im = np.array(img, np.uint8)
    h = im.shape[0]
    sep = np.full((h, 3, 3), 255, np.uint8)
    panels = [im]
    gt_panel = np.zeros_like(im)
    set_img_color(colors, background, gt_panel, gt, show255=False)
    panels += [sep, gt_panel]
    for p in preds:
        panels += [sep, show_prediction(colors, background, im, p, weight)]
    return np.concatenate(panels, axis=1)


def print_iou(
    iu: np.ndarray,
    mean_pixel_acc: float,
    class_names: Optional[Sequence[str]] = None,
    show_no_back: bool = False,
) -> str:
    """The per-class IoU table (reference visualize.py:59-86), returned as
    text."""
    n = iu.size
    lines = []
    for i in range(n):
        cls = (f"Class {i + 1}:" if class_names is None
               else f"{i + 1} {class_names[i]}")
        lines.append(f"{cls:<24} {iu[i] * 100:.3f}%")
    mean_iu = np.nanmean(iu)
    mean_iu_no_back = np.nanmean(iu[1:]) if n > 1 else mean_iu
    tail = f"\nmean_IU {mean_iu * 100:.3f}% "
    if show_no_back:
        tail += f"mean_IU_no_back {mean_iu_no_back * 100:.3f}% "
    lines.append("-" * 42 + tail
                 + f"mean_pixel_ACC {mean_pixel_acc * 100:.3f}%")
    return "\n".join(lines)
