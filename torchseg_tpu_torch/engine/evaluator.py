"""Evaluator — the evaluation protocols and the dataset loop (counterpart
of torchseg_tpu/engine/evaluator.py, reference ``furnace/engine/
evaluator.py``).

Whole-image (reference :164-183; JAX ``whole_eval`` and ``_whole_fn``,
:349-441): the uint8 image goes to the device, is normalized there (a pad
margin masked to 0), runs one forward (with flip: the score of the
flipped image, flipped back on the width axis, added), ``exp`` (reference
nets emit log-softmax), the margin cut off, the scores resized to the
label's size with ``jax.image.resize``'s "linear" (``ops.resize.
resize_linear``: half-pixel centres, antialiased when downscaling), and the
argmax; only the int32 prediction exists at the end, still on the device,
where ``ConfusionAccumulator`` counts it.

Sliding window (reference :186-253; JAX ``sliding_eval``,
``scale_process``, ``_single_fn``, ``_grid_fn``, ``_finish_fn``): each of
``multi_scales`` is resized on the host by cv2's INTER_LINEAR
(``native.resize_linear_cv``, bit for bit), or taken from
``scaled_imgs``.  A scale whose long side fits the crop is padded to the
crop and forwarded once as the whole-image protocol does (normalized, the
margin masked to 0 after).  A larger one takes the crop grid: the raw
uint8 image padded with 0 BEFORE normalizing (so the network sees (0 -
mean) / std in the margins, as the reference normalizes each padded
crop), ``stride = ceil(crop * stride_rate)``, JAX's coordinate rule (the
last crop of a row or column flush with the padded edge), the crops
forwarded in balanced chunks of at most ``max_batch`` (with flip: one
forward of the chunk and its mirror), and each crop's exp scores summed
onto a canvas in slot order, with no count normalization (reference
:243-245).  The canvas is unpadded and resized to the image's size with
``resize_linear``; the scales' scores are summed on the device and the
argmax taken once.  ``shard_crops`` with ``devices=[...]``: the devices
share one image's crop slots (``ceil(n / devices)`` each, in order), each
sums its own canvas (a copy of the model on each, made afresh for every
``run_dataset``), and the canvases are added on the evaluator's device.

``run_dataset``: the items of this process (``range(index, len,
count)``; by default the rank and the world size of the initialized
process group) through a one-item-lookahead prefetch thread that also
resizes every scale of the next image (and the speed protocol's input)
while the device works on this one; ``label_offset``; the speed protocol
(``resize_to``: the image resized by cv2's INTER_LINEAR, the labels to
``resize_to // gt_down_sampling`` by cv2's INTER_NEAREST rule,
``data.transforms.resize_labels``; or only the labels, ``//
gt_down_sampling``); the prediction dump (``save_pred_dir``), the
submission remap (``submit_dir`` with ``transform_label``) and
``show_image`` as a directory of [image | gt | prediction] composites,
all written as PNG by ``data.image_io.imwrite``; the multi-device path
(one worker thread a device, contiguous index shards, a worker's error
re-raised).  ``show_image="window"`` (the reference's interactive window)
raises ValueError: the port ships no GUI toolkit.

``spatial_shards=n`` (JAX :82-116, :348-440): whole-image evaluation with
the image height split over a space group of n ranks (the initialized
process group's ranks in consecutive blocks of n, ``parallel.spatial.
make_dp_sp_mesh(world // n, n)``).  Every rank reads the whole image, runs
the model on its rows under a ``SpaceContext`` (``ops.spatial``: halo
rows, gathered small maps, space-group means and resizes), and the int32
labels are gathered so that every rank gets the full label map (the scores
are gathered instead when a margin or a resize follows).  The split is at
multiples of ``ops.spatial.split_unit`` rows (``plan_rows``), where JAX
pads uneven shards.  ``run_dataset`` then splits the images over the data
groups, and each rank counts its own band of each label map's rows, so
the histograms summed over the group count every pixel once.

The model is read at every call: ``set_model`` swaps it (a module on
another device is copied to the evaluator's).
"""

import copy
import math
import os
import queue
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .. import native
from ..data.image_io import imwrite
from ..data.transforms import normalize, pad_image_to_shape, resize_labels
from ..ops.metrics import ConfusionAccumulator
from ..ops.resize import resize_linear
from ..ops.spatial import plan_rows
from .logger import get_logger


def _on_device(model_or_state, device: torch.device):
    """A module that lies on another device is deep-copied to ``device``;
    one already there is shared (its eval forward only reads it); anything
    else is ``apply_fn``'s to place."""
    if isinstance(model_or_state, nn.Module):
        p = next(model_or_state.parameters(), None)
        if p is None or p.device == device:
            return model_or_state
        return copy.deepcopy(model_or_state).to(device)
    return model_or_state


class Evaluator:
    """Args:
      apply_fn: (model_or_state, images NCHW float32) -> scores (B, C, H,
        W); must be the model's eval-mode forward (log-softmax or raw
        logits, like the reference networks).  It runs under
        ``torch.inference_mode()``.
      model_or_state: what ``apply_fn`` reads (an eval-mode module).
      num_classes, image_mean, image_std: protocol constants.
      multi_scales / crop_size / stride_rate / max_batch: the sliding
        protocol's (per-experiment config, e.g. eval_scale_array).
      is_flip: flip TTA.
      devices: several devices: ``run_dataset`` runs one worker thread on
        each (a model on another device is deep-copied there), or, with
        ``shard_crops``, they share each image's crops.
      shard_crops: the devices team up on each image's sliding crop grid
        instead of splitting the images (needs two or more ``devices``).
      spatial_shards: n > 1 splits each image's height over a space group
        of n ranks of the initialized process group (module docstring);
        every rank of the group constructs the evaluator.
      device: where it runs without ``devices`` (default the card).
    """

    def __init__(
        self,
        apply_fn: Callable,
        model_or_state,
        num_classes: int,
        image_mean,
        image_std,
        multi_scales: Sequence[float] = (1.0,),
        is_flip: bool = False,
        crop_size: Optional[int] = None,
        stride_rate: float = 5 / 6,
        max_batch: int = 16,
        devices: Optional[Sequence] = None,
        shard_crops: bool = False,
        spatial_shards: int = 1,
        device="cuda",
    ):
        self.spatial_shards = int(spatial_shards)
        self.devices = ([torch.device(d) for d in devices]
                        if devices is not None else None)
        self.shard_crops = (bool(shard_crops) and self.devices is not None
                            and len(self.devices) > 1)
        if shard_crops and self.spatial_shards > 1:
            raise ValueError("spatial_shards and shard_crops are mutually "
                             "exclusive (whole vs sliding protocol "
                             "parallelism)")
        self._mesh = None
        if self.spatial_shards > 1:
            n = self.spatial_shards
            world = dist.get_world_size() if dist.is_initialized() else 0
            if not world or world % n:
                raise ValueError(
                    f"spatial_shards={n} needs a process group of a multiple "
                    f"of {n} ranks (devices, one a rank), have {world}")
            if devices is not None and len(devices) > 1:
                raise ValueError("spatial_shards runs one device a rank; "
                                 "devices= is the multi-device path")
            from ..parallel.spatial import make_dp_sp_mesh
            self._mesh = make_dp_sp_mesh(world // n, n)
        self.apply_fn = apply_fn
        self.num_classes = num_classes
        self.image_mean = np.asarray(image_mean, np.float32)
        self.image_std = np.asarray(image_std, np.float32)
        self.multi_scales = list(multi_scales)
        self.is_flip = is_flip
        self.crop_size = crop_size
        self.stride_rate = stride_rate
        self.max_batch = max_batch
        self.device = (self.devices[0] if self.devices
                       else torch.device(device))
        self.set_model(model_or_state)
        self.logger = get_logger()
        self._norm = {}  # device -> (mean, std, 255) tensors
        self._crop_models = None  # shard_crops: (device, model) pairs

    def set_model(self, model_or_state):
        """Evaluate ``model_or_state`` from now on (a module on another
        device is deep-copied to the evaluator's)."""
        self.model_or_state = _on_device(model_or_state, self.device)

    def _constants(self, device):
        """(mean, std, 255) on ``device``; 255 a tensor divisor: CUDA
        divides by a Python scalar as a multiply by its reciprocal, JAX
        (and the CPU) divide."""
        c = self._norm.get(device)
        if c is None:
            c = (torch.from_numpy(self.image_mean).to(device),
                 torch.from_numpy(self.image_std).to(device),
                 torch.tensor(255.0, device=device))
            self._norm[device] = c
        return c

    def _normalize(self, img_u8: torch.Tensor) -> torch.Tensor:
        mean, std, c255 = self._constants(img_u8.device)
        return (img_u8.float() / c255 - mean) / std

    # ------------------------------------------------------------------
    # reference algorithms
    # ------------------------------------------------------------------
    def process_image(self, img: np.ndarray, crop_size=None):
        """normalize + optional pad (reference :277-297), on the host.
        HWC."""
        p_img = _three_channels(img)
        p_img = normalize(p_img, self.image_mean, self.image_std)
        if crop_size is not None:
            p_img, margin = pad_image_to_shape(p_img, crop_size, 0)
            return p_img, margin
        return p_img

    def _masked(self, img_u8: torch.Tensor, margin) -> torch.Tensor:
        """HWC uint8 on the device -> normalized NCHW float32, the pad
        margin masked to 0 after normalizing (JAX ``_single_fn``,
        ``_whole_fn``)."""
        x = self._normalize(img_u8)
        if margin is not None:
            t, b, l, r = margin
            h, w = x.shape[:2]
            inside = torch.zeros((h, w, 1), dtype=torch.bool,
                                 device=x.device)
            inside[t:h - b, l:w - r] = True
            x = torch.where(inside, x, torch.zeros((), device=x.device))
        return x.permute(2, 0, 1)[None].contiguous()

    def _whole(self, img_u8: torch.Tensor, margin, output_size):
        """uint8 HWC on the device -> normalize (pad margin masked to 0) ->
        forward (+flip) -> exp -> unpad -> resize -> argmax: (H, W) int32
        on the device (JAX ``_whole_fn``).  With ``spatial_shards`` the
        forward runs on this rank's rows, and the labels (or, before an
        unpad or a resize, the scores) are gathered over the space
        group."""
        x = self._masked(img_u8, margin)
        space = self._space(x.shape[-2:])
        if space is None:
            score = self._score(x)
        else:
            r0, r1 = space.rows(space.levels[0])
            with space:
                score = self._score(x[:, :, r0:r1].contiguous())
            # a score at a size no shard holds is whole on every rank
            if space.level_of(score) is not None:
                if margin is None and (output_size is None or tuple(
                        output_size) == tuple(x.shape[-2:])):
                    return space.gather(score.argmax(dim=0).to(torch.int32))
                score = space.gather(score)
        score = self._finish(score, margin, output_size)
        return score.argmax(dim=0).to(torch.int32)

    @staticmethod
    def _finish(score: torch.Tensor, margin, output_size) -> torch.Tensor:
        """(C, H, W) scores: the pad margin cut off, then resized to
        ``output_size`` by ``resize_linear`` (JAX ``_finish_fn``)."""
        if margin is not None:
            t, b, l, r = margin
            score = score[:, t:score.shape[1] - b, l:score.shape[2] - r]
        if output_size is not None and \
                tuple(score.shape[1:]) != tuple(output_size):
            score = resize_linear(score, output_size)
        return score

    def _score(self, x: torch.Tensor) -> torch.Tensor:
        """exp of the model's (flip-summed) score of one NCHW image: (C,
        H, W) float32."""
        return self._scores(self.model_or_state, x)[0]

    def _scores(self, model, x: torch.Tensor) -> torch.Tensor:
        """exp of the model's (flip-summed) scores of an NCHW batch: (B,
        C, H, W) float32; with flip one forward of the batch and its
        mirror on the width axis."""
        if self.is_flip:
            n = x.shape[0]
            s = self.apply_fn(model, torch.cat([x, x.flip(-1)])).float()
            score = s[:n] + s[n:].flip(-1)
        else:
            score = self.apply_fn(model, x).float()
        return torch.exp(score)

    def _space(self, hw):
        """The space context of an image of ``hw`` (None without
        ``spatial_shards``, or when no map of it would be sharded)."""
        if self._mesh is None:
            return None
        bounds = plan_rows(int(hw[0]), self._mesh.sp)
        return None if bounds is None else self._mesh.context(hw, bounds)

    def whole_eval(self, img, output_size=None, input_size=None):
        """Single forward on the (optionally padded) image (:164-183).
        Returns the argmax prediction at output_size (or the input
        resolution), an (H, W) int32 tensor on the device."""
        img = _three_channels(img)
        if input_size is not None:
            img, margin = pad_image_to_shape(img, input_size, 0)
            margin = tuple(int(m) for m in margin)
        else:
            margin = None
        out = (tuple(int(v) for v in output_size)
               if output_size is not None else None)
        x = torch.from_numpy(np.ascontiguousarray(img, np.uint8)).to(
            self.device)
        with torch.inference_mode():
            return self._whole(x, margin, out)

    def _grid_canvas(self, model, img_u8: torch.Tensor, coords, crop: int
                     ) -> torch.Tensor:
        """The exp scores of the crops at ``coords`` of the padded uint8
        image (HWC, on the model's device) summed onto a (C, H, W) canvas
        in slot order; the crops forwarded in balanced chunks of at most
        ``max_batch`` (JAX ``_grid_fn``: normalized with no mask, so the
        zero-padded margins read (0 - mean) / std)."""
        x = self._normalize(img_u8).permute(2, 0, 1)
        canvas = torch.zeros((self.num_classes, *x.shape[1:]),
                             dtype=torch.float32, device=x.device)
        n = len(coords)
        if not n:
            return canvas
        n_chunks = -(-n // self.max_batch)
        chunk = -(-n // n_chunks)
        for c0 in range(0, n, chunk):
            part = coords[c0:c0 + chunk]
            crops = torch.stack([x[:, y:y + crop, x0:x0 + crop]
                                 for y, x0 in part])
            score = self._scores(model, crops)
            for k, (y, x0) in enumerate(part):
                canvas[:, y:y + crop, x0:x0 + crop] += score[k]
        return canvas

    def _crop_copies(self):
        """shard_crops: (device, model) of every device; made afresh
        unless ``run_dataset`` holds a set for its run."""
        if self._crop_models is not None:
            return self._crop_models
        return [(d, _on_device(self.model_or_state, d))
                for d in self.devices]

    def scale_process(self, img, ori_shape, crop_size, stride_rate,
                      device_out: bool = False):
        """One scale of the sliding protocol (:202-253).  Returns the
        scores resized to ``ori_shape``: (C, H, W) float32 on the device
        with ``device_out``, else (H, W, C) numpy as JAX's."""
        img = _three_channels(img)
        new_rows, new_cols = img.shape[:2]
        img_pad, margin = pad_image_to_shape(img, crop_size, 0)
        margin = tuple(int(m) for m in margin)
        with torch.inference_mode():
            if max(new_rows, new_cols) <= crop_size:
                x = torch.from_numpy(np.ascontiguousarray(img_pad)).to(
                    self.device)
                raw = self._score(self._masked(x, margin))
            else:
                stride = int(math.ceil(crop_size * stride_rate))
                pad_rows, pad_cols = img_pad.shape[:2]
                r_grid = int(math.ceil((pad_rows - crop_size) / stride)) + 1
                c_grid = int(math.ceil((pad_cols - crop_size) / stride)) + 1
                coords = []
                for gy in range(r_grid):
                    for gx in range(c_grid):
                        e_x = min(gx * stride + crop_size, pad_cols)
                        e_y = min(gy * stride + crop_size, pad_rows)
                        coords.append((e_y - crop_size, e_x - crop_size))
                host = torch.from_numpy(np.ascontiguousarray(img_pad))
                if self.shard_crops:
                    copies = self._crop_copies()
                    spd = -(-len(coords) // len(copies))
                    canvases = [self._grid_canvas(
                        m, host.to(d), coords[i * spd:(i + 1) * spd],
                        crop_size) for i, (d, m) in enumerate(copies)]
                    raw = canvases[0].to(self.device)
                    for c in canvases[1:]:
                        raw = raw + c.to(self.device)
                else:
                    raw = self._grid_canvas(self.model_or_state,
                                            host.to(self.device), coords,
                                            crop_size)
            score = self._finish(raw, margin, tuple(ori_shape))
        if device_out:
            return score
        return score.permute(1, 2, 0).cpu().numpy()

    def sliding_eval(self, img, crop_size=None, stride_rate=None,
                     scaled_imgs=None):
        """Multi-scale sliding-window prediction (:186-200): every scale's
        scores summed on the device, one argmax; returns the (H, W) int32
        prediction on the device.

        scaled_imgs: the images already resized (one per multi_scale),
        e.g. by the lookahead prefetch thread, so that the host resize
        overlaps device compute of the previous image."""
        crop_size = crop_size or self.crop_size
        stride_rate = stride_rate or self.stride_rate
        ori_rows, ori_cols = img.shape[:2]
        total = None
        for si, s in enumerate(self.multi_scales):
            img_scale = (scaled_imgs[si] if scaled_imgs is not None
                         else native.resize_linear_cv(img, None, s, s))
            score = self.scale_process(img_scale, (ori_rows, ori_cols),
                                       crop_size, stride_rate,
                                       device_out=True)
            total = score if total is None else total + score
        return total.argmax(dim=0).to(torch.int32)

    # ------------------------------------------------------------------
    # dataset loop
    # ------------------------------------------------------------------
    def run_dataset(
        self,
        dataset,
        mode: str = "sliding",
        gt_down_sampling: int = 1,
        resize_to: Optional[Sequence[int]] = None,
        save_pred_dir: Optional[str] = None,
        label_offset: int = 0,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
        submit_dir: Optional[str] = None,
        transform_label: Optional[Callable] = None,
        show_image: Optional[str] = None,
        class_colors=None,
        background: int = -1,
    ) -> ConfusionAccumulator:
        """Evaluate a val dataset; returns the confusion accumulator (on
        the evaluator's device).

        mode: 'sliding' or 'whole'.
        resize_to + gt_down_sampling: the speed protocol: the input resized
        to (h, w), the labels (nearest) to (h // k, w // k), compared at
        the /k resolution (reference model/bisenet/*.speed/eval.py:25-40).
        label_offset: added to raw labels (ADE uses -1).
        process_index/count: this process's shard of the indices,
        ``range(index, len, count)`` (replaces the reference's per-GPU
        mp.Process sharding); by default the rank and world size of the
        initialized process group, else 0 and 1.
        save_pred_dir: the predictions as ``<fn>.png``.
        submit_dir + transform_label: server-submission PNGs, train ids
        remapped by the dataset's ``transform_label`` (reference
        datasets/cityscapes/cityscapes.py:35-48).
        show_image: a directory the [image | gt | prediction] composites
        are written to (``<fn>_comp.png``); needs class_colors and
        background.  'window' (the reference's interactive window) raises
        ValueError.
        """
        if mode not in ("sliding", "whole"):
            raise ValueError(f"mode={mode!r}: 'sliding' or 'whole'")
        if show_image == "window":
            raise ValueError(
                "show_image='window' opens the reference's interactive cv2 "
                "window: the port ships no GUI toolkit (and the card's "
                "machine has no display); pass a directory to write the "
                "composites to")
        group = dist.is_initialized()
        if self._mesh is not None:  # the images split over the data groups
            group_index, group_count = self._mesh.data_index, self._mesh.dp
        else:
            group_index, group_count = ((dist.get_rank(),
                                         dist.get_world_size()) if group
                                        else (0, 1))
        pidx = process_index if process_index is not None else group_index
        pcnt = process_count if process_count is not None else group_count
        opts = dict(mode=mode, gt_down_sampling=gt_down_sampling,
                    resize_to=resize_to, save_pred_dir=save_pred_dir,
                    label_offset=label_offset, submit_dir=submit_dir,
                    transform_label=transform_label, show_image=show_image,
                    class_colors=class_colors, background=background)
        if (self.devices is not None and len(self.devices) > 1
                and not self.shard_crops):
            return self._run_dataset_multidevice(dataset, pidx, pcnt, opts)
        acc = ConfusionAccumulator(self.num_classes, device=self.device)
        n = len(dataset)
        t0 = time.time()
        if self.shard_crops:  # this run's copies of the model
            self._crop_models = None
            self._crop_models = self._crop_copies()
        try:
            for k, (idx, item) in enumerate(self._prefetch_items(
                    dataset, range(pidx, n, pcnt), mode, resize_to)):
                acc.update(*self._eval_one(item, **opts))
                if k % 10 == 0:
                    self.logger.info("eval %d/%d (%.2fs/img)", idx + 1, n,
                                     (time.time() - t0) / (k + 1))
        finally:
            self._crop_models = None
        return acc

    def _prefetch_items(self, dataset, indices, mode="whole",
                        resize_to=None):
        """One-item-lookahead host pipeline: dataset reads, the sliding
        protocol's per-scale resizes and the speed protocol's input resize
        run on a worker thread (the native library releases the GIL),
        overlapping device compute of the previous image.  Worker errors
        re-raise in the consumer (the same loudness contract as the
        multi-device path)."""
        q = queue.Queue(maxsize=2)
        done = object()

        def work():
            try:
                for idx in indices:
                    item = dataset[idx]
                    if resize_to is not None:
                        h, w = resize_to
                        item["_resized"] = native.resize_linear_cv(
                            item["image"], (w, h))
                    elif mode == "sliding":
                        item["_scaled"] = [
                            native.resize_linear_cv(item["image"], None, s, s)
                            for s in self.multi_scales]
                    q.put((idx, item))
            except BaseException as e:  # noqa: BLE001 — re-raised below
                q.put(e)
            else:
                q.put(done)

        threading.Thread(target=work, daemon=True).start()
        while True:
            got = q.get()
            if got is done:
                return
            if isinstance(got, BaseException):
                raise RuntimeError("eval prefetch worker failed") from got
            yield got

    def _eval_one(self, item, mode="whole", gt_down_sampling=1,
                  resize_to=None, save_pred_dir=None, label_offset=0,
                  submit_dir=None, transform_label=None, show_image=None,
                  class_colors=None, background=-1):
        """(prediction, label) of one item, both on the device; the dumps
        written on the way (JAX :686-753)."""
        img, label = item["image"], np.asarray(item["label"])
        if label_offset:
            label = label.astype(np.int64) + label_offset
        if resize_to is not None:
            h, w = resize_to
            img = item.get("_resized")
            if img is None:
                img = native.resize_linear_cv(item["image"], (w, h))
            label = resize_labels(label.astype(np.int32),
                                  h // gt_down_sampling,
                                  w // gt_down_sampling)
        elif gt_down_sampling > 1:
            label = resize_labels(label.astype(np.int32),
                                  label.shape[0] // gt_down_sampling,
                                  label.shape[1] // gt_down_sampling)
        if mode == "sliding":
            pred = self.sliding_eval(img, scaled_imgs=item.get("_scaled"))
        else:
            pred = self.whole_eval(img, output_size=label.shape)
        if save_pred_dir is not None or show_image or (
                submit_dir is not None and transform_label is not None):
            self._dump(item["fn"], img, label, pred.cpu().numpy(),
                       save_pred_dir, submit_dir, transform_label,
                       show_image, class_colors, background)
        label = torch.from_numpy(np.ascontiguousarray(label)).to(self.device)
        if self._mesh is not None:  # this rank's band of rows is counted
            n, s = self._mesh.sp, self._mesh.space_index
            h = label.shape[0]
            pred = pred[s * h // n:(s + 1) * h // n]
            label = label[s * h // n:(s + 1) * h // n]
        return pred, label

    @staticmethod
    def _dump(fn, img, label, pred, save_pred_dir, submit_dir,
              transform_label, show_image, class_colors, background):
        """The PNG files of one prediction (JAX's cv2.imwrite calls)."""
        if save_pred_dir is not None:
            os.makedirs(save_pred_dir, exist_ok=True)
            imwrite(os.path.join(save_pred_dir, fn + ".png"),
                    pred.astype(np.uint8))
        if submit_dir is not None and transform_label is not None:
            # server-submission remap (cityscapes.py:35-48): train ids ->
            # official label ids, the file renamed by the dataset's rule
            os.makedirs(submit_dir, exist_ok=True)
            out, new_name = transform_label(pred, fn + ".png")
            imwrite(os.path.join(submit_dir, new_name), out.astype(np.uint8))
        if show_image:
            from ..utils.visualize import show_img

            im_show = img
            if img.shape[:2] != pred.shape:
                # the speed protocol compares at gt / k: the image comes
                # down to the prediction's grid for the overlay
                im_show = native.resize_linear_cv(
                    img, (pred.shape[1], pred.shape[0]))
            comp = show_img(class_colors, background, im_show, label, pred)
            os.makedirs(show_image, exist_ok=True)
            imwrite(os.path.join(show_image, fn + "_comp.png"), comp)

    def _run_dataset_multidevice(self, dataset, pidx, pcnt, opts):
        """One worker thread per device, contiguous index shards — the
        in-process equivalent of the reference's one-mp.Process-per-GPU
        architecture (evaluator.py:96-146)."""
        my_indices = list(range(pidx, len(dataset), pcnt))
        n_dev = len(self.devices)
        step = -(-len(my_indices) // n_dev)
        results = [None] * n_dev
        errors = [None] * n_dev

        def worker(slot, device, idxs):
            try:
                sub = Evaluator(
                    self.apply_fn, self.model_or_state, self.num_classes,
                    self.image_mean, self.image_std,
                    multi_scales=self.multi_scales, is_flip=self.is_flip,
                    crop_size=self.crop_size, stride_rate=self.stride_rate,
                    max_batch=self.max_batch, device=device)
                acc = ConfusionAccumulator(self.num_classes, device=device)
                for idx in idxs:
                    acc.update(*sub._eval_one(dataset[idx], **opts))
                results[slot] = acc
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors[slot] = e

        threads = []
        for d, device in enumerate(self.devices):
            idxs = my_indices[d * step:(d + 1) * step]
            t = threading.Thread(target=worker, args=(d, device, idxs))
            t.start()
            threads.append(t)
        for t in threads:
            t.join()
        for e in errors:
            if e is not None:
                # a dead worker must fail loudly — silently dropping its
                # shard would report a partial-dataset mIoU as the result
                raise e
        acc = ConfusionAccumulator(self.num_classes, device=self.device)
        for r in results:
            if r is not None:
                acc.merge(r)
        return acc


def _three_channels(img: np.ndarray) -> np.ndarray:
    """An (H, W) or (H, W, 1..2) image as (H, W, 3), its channels
    repeated (the reference's process_image)."""
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[2] < 3:
        img = np.concatenate([img] * 3, axis=2)
    return img
