"""Evaluator — whole-image inference and the dataset loop (counterpart of
torchseg_tpu/engine/evaluator.py, reference ``furnace/engine/evaluator.py``).

Ported: the whole-image protocol (reference :164-183; JAX ``whole_eval``
and ``_whole_fn``, :349-441): the uint8 image goes to the device, is
normalized there (a pad margin masked to 0), runs one forward (with flip:
the score of the flipped image, flipped back, added), ``exp`` (reference
nets emit log-softmax), the margin cut off, the scores resized to the
label's size with ``jax.image.resize``'s "linear" (``ops.resize.
resize_linear``: half-pixel centres, antialiased when downscaling), and the
argmax; only the int32 prediction exists at the end, still on the device,
where ``ConfusionAccumulator`` counts it.  ``run_dataset(mode="whole")``
with its one-item-lookahead prefetch thread, the process split of the
indices (``process_index``/``process_count``, by default the rank and the
world size of the initialized process group), and the multi-device path
(one worker thread a device, contiguous index shards, a worker's error
re-raised).

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
the histograms summed over the group count every pixel once.  The model is
read at every call, so a swapped ``model_or_state`` is honoured.

Not ported yet, each raising ``NotImplementedError``: the sliding-window
protocol with its msf and flip modes and ``shard_crops`` (ROADMAP A7); the
speed protocol's cv2 resizes (``resize_to``, ``gt_down_sampling``), the
prediction dump (``save_pred_dir``), the submission remap (``submit_dir``)
and ``show_image`` (A7).
"""

import copy
import queue
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..data.transforms import normalize, pad_image_to_shape
from ..ops.metrics import ConfusionAccumulator
from ..ops.resize import resize_linear
from ..ops.spatial import plan_rows
from .logger import get_logger

_A7 = "is not ported yet (ROADMAP A7: evaluation protocols)"


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
        protocol's (kept for the signature; ROADMAP A7).
      is_flip: flip TTA.
      devices: several devices: ``run_dataset`` runs one worker thread on
        each (a model on another device is deep-copied there).
      shard_crops: the sliding protocol's crop sharding (ROADMAP A7).
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
        if shard_crops and self.spatial_shards > 1:
            raise ValueError("spatial_shards and shard_crops are mutually "
                             "exclusive (whole vs sliding protocol "
                             "parallelism)")
        if shard_crops:
            raise NotImplementedError(f"shard_crops {_A7}")
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
        self.devices = ([torch.device(d) for d in devices]
                        if devices is not None else None)
        self.device = (self.devices[0] if self.devices
                       else torch.device(device))
        self.model_or_state = _on_device(model_or_state, self.device)
        self.logger = get_logger()
        self._mean = torch.from_numpy(self.image_mean).to(self.device)
        self._std = torch.from_numpy(self.image_std).to(self.device)
        # a tensor divisor: CUDA divides by a Python scalar as a multiply
        # by its reciprocal, JAX (and the CPU) divide
        self._255 = torch.tensor(255.0, device=self.device)

    # ------------------------------------------------------------------
    # reference algorithms
    # ------------------------------------------------------------------
    def process_image(self, img: np.ndarray, crop_size=None):
        """normalize + optional pad (reference :277-297), on the host.
        HWC."""
        p_img = img
        if p_img.ndim == 2:
            p_img = p_img[:, :, None]
        if p_img.shape[2] < 3:
            p_img = np.concatenate([p_img] * 3, axis=2)
        p_img = normalize(p_img, self.image_mean, self.image_std)
        if crop_size is not None:
            p_img, margin = pad_image_to_shape(p_img, crop_size, 0)
            return p_img, margin
        return p_img

    def _whole(self, img_u8: torch.Tensor, margin, output_size):
        """uint8 HWC on the device -> normalize (pad margin masked to 0) ->
        forward (+flip) -> exp -> unpad -> resize -> argmax: (H, W) int32
        on the device (JAX ``_whole_fn``).  With ``spatial_shards`` the
        forward runs on this rank's rows, and the labels (or, before an
        unpad or a resize, the scores) are gathered over the space
        group."""
        x = (img_u8.float() / self._255 - self._mean) / self._std
        if margin is not None:
            t, b, l, r = margin
            h, w = x.shape[:2]
            inside = torch.zeros((h, w, 1), dtype=torch.bool,
                                 device=x.device)
            inside[t:h - b, l:w - r] = True
            x = torch.where(inside, x, torch.zeros((), device=x.device))
        x = x.permute(2, 0, 1)[None].contiguous()
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
        if margin is not None:
            t, b, l, r = margin
            score = score[:, t:score.shape[1] - b, l:score.shape[2] - r]
        if output_size is not None and \
                tuple(score.shape[1:]) != tuple(output_size):
            score = resize_linear(score, output_size)
        return score.argmax(dim=0).to(torch.int32)

    def _score(self, x: torch.Tensor) -> torch.Tensor:
        """exp of the model's (flip-summed) score of one NCHW image: (C,
        H, W) float32."""
        if self.is_flip:
            s = self.apply_fn(self.model_or_state,
                              torch.cat([x, x.flip(-1)])).float()
            score = s[0] + s[1].flip(-1)
        else:
            score = self.apply_fn(self.model_or_state, x)[0].float()
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
        if img.ndim == 2:
            img = img[:, :, None]
        if img.shape[2] < 3:
            img = np.concatenate([img] * 3, axis=2)
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

    def sliding_eval(self, img, crop_size=None, stride_rate=None,
                     scaled_imgs=None):
        raise NotImplementedError(f"the sliding-window protocol {_A7}")

    def scale_process(self, img, ori_shape, crop_size, stride_rate,
                      device_out: bool = False):
        raise NotImplementedError(f"the sliding-window protocol {_A7}")

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

        mode: only 'whole' is ported ('sliding': ROADMAP A7).
        label_offset: added to raw labels (ADE uses -1).
        process_index/count: this process's shard of the indices,
        ``range(index, len, count)`` (replaces the reference's per-GPU
        mp.Process sharding); by default the rank and world size of the
        initialized process group, else 0 and 1.
        resize_to, gt_down_sampling, save_pred_dir, submit_dir,
        transform_label, show_image: ROADMAP A7.
        """
        if mode != "whole":
            raise NotImplementedError(f"mode={mode!r}: only 'whole' is "
                                      f"ported; the sliding protocol {_A7}")
        if resize_to is not None or gt_down_sampling > 1:
            raise NotImplementedError(
                f"resize_to / gt_down_sampling (the speed protocol's cv2 "
                f"resizes) {_A7}")
        for name, value in (("save_pred_dir", save_pred_dir),
                            ("submit_dir", submit_dir),
                            ("transform_label", transform_label),
                            ("show_image", show_image)):
            if value is not None:
                raise NotImplementedError(f"{name} {_A7}")
        group = dist.is_initialized()
        if self._mesh is not None:  # the images split over the data groups
            group_index, group_count = self._mesh.data_index, self._mesh.dp
        else:
            group_index, group_count = ((dist.get_rank(),
                                         dist.get_world_size()) if group
                                        else (0, 1))
        pidx = process_index if process_index is not None else group_index
        pcnt = process_count if process_count is not None else group_count
        if self.devices is not None and len(self.devices) > 1:
            return self._run_dataset_multidevice(dataset, label_offset,
                                                 pidx, pcnt)
        acc = ConfusionAccumulator(self.num_classes, device=self.device)
        n = len(dataset)
        t0 = time.time()
        for k, (idx, item) in enumerate(
                self._prefetch_items(dataset, range(pidx, n, pcnt))):
            acc.update(*self._eval_one(item, label_offset))
            if k % 10 == 0:
                self.logger.info("eval %d/%d (%.2fs/img)", idx + 1, n,
                                 (time.time() - t0) / (k + 1))
        return acc

    def _prefetch_items(self, dataset, indices):
        """One-item-lookahead host pipeline: dataset reads run on a worker
        thread, overlapping device compute of the previous image.  Worker
        errors re-raise in the consumer (the same loudness contract as the
        multi-device path)."""
        q = queue.Queue(maxsize=2)
        done = object()

        def work():
            try:
                for idx in indices:
                    q.put((idx, dataset[idx]))
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

    def _eval_one(self, item, label_offset):
        """(prediction, label) of one item, both on the device."""
        label = np.asarray(item["label"])
        if label_offset:
            label = label.astype(np.int64) + label_offset
        pred = self.whole_eval(item["image"], output_size=label.shape)
        label = torch.from_numpy(np.ascontiguousarray(label)).to(self.device)
        if self._mesh is not None:  # this rank's band of rows is counted
            n, s = self._mesh.sp, self._mesh.space_index
            h = label.shape[0]
            pred = pred[s * h // n:(s + 1) * h // n]
            label = label[s * h // n:(s + 1) * h // n]
        return pred, label

    def _run_dataset_multidevice(self, dataset, label_offset, pidx, pcnt):
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
                    acc.update(*sub._eval_one(dataset[idx], label_offset))
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
