"""Prefetching train loader (counterpart of torchseg_tpu/data/loader.py;
the reference's torch DataLoader + DistributedSampler, model/*/
dataloader.py:36-64, num_workers=24).

``TrainLoader`` is JAX's: a thread pool runs the numpy/native preprocess
(the native kernels release the GIL) and a bounded queue keeps batches
ahead of the step.  Batches are *global*: each rank takes its rows
(``parallel.shard_batch``), which replaces the reference's per-process
DistributedSampler and batch_size // world_size.

``prefetch_to_device`` is the device half: the next batches' host-to-device
copies overlap the current step.
"""

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional

import numpy as np
import torch


def _collate(items):
    batch = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], np.ndarray):
            batch[key] = np.stack(vals)
        else:
            batch[key] = vals
    return batch


class TrainLoader:
    """Iterate epochs of shuffled, drop-last global batches.

    Args:
      dataset: indexable with __len__, reshuffle(seed).
      batch_size: GLOBAL batch size (divisible by the number of ranks).
      num_workers: preprocess threads.
      prefetch: max batches queued ahead.
    """

    def __init__(self, dataset, batch_size: int, num_workers: int = 8,
                 prefetch: int = 4, seed: int = 0, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def set_epoch(self, epoch: int):
        """DistributedSampler.set_epoch equivalent: reseeds the shuffle."""
        self._epoch = epoch

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed + self._epoch)
        if hasattr(self.dataset, "reshuffle"):
            self.dataset.reshuffle(self.seed + self._epoch)
        order = rng.permutation(len(self.dataset))
        nb = len(self)

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def _put(item) -> bool:
            # bounded put that honours an early consumer exit (no thread
            # left behind when the consumer leaves the epoch mid-way)
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in range(nb):
                        if stop.is_set():
                            return
                        idxs = order[b * self.batch_size:
                                     (b + 1) * self.batch_size]
                        items = list(pool.map(self.dataset.__getitem__,
                                              idxs))
                        if not _put(_collate(items)):
                            return
                _put(None)
            except Exception as e:  # handed to the consumer, raised there
                _put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = out_q.get()
                if batch is None:
                    return
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()


def _to_tensors(batch) -> dict:
    """The array leaves of a host batch as CPU tensors, as they are (images
    NHWC)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items() if isinstance(v, np.ndarray)}


def prefetch_to_device(iterator, device, size: int = 2,
                       place: Optional[Callable] = None):
    """Wrap a host-batch iterator so that the next ``size`` batches' copies
    to ``device`` overlap the current step (JAX ``prefetch_to_device``;
    the reference relies on the DataLoader's pinned-memory prefetch).

    Each batch (a dict of numpy arrays; other leaves dropped) is first cut
    by ``place`` (a function of the dict of host tensors, images still
    NHWC, e.g. this rank's rows: ``lambda b: parallel.shard_batch(b, rank,
    world)``), then on a CUDA device pinned and copied with
    ``non_blocking=True`` on a side stream that the consuming stream waits
    for, and there the images made NCHW and the integer labels int64.  On
    the CPU it only converts."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if cuda else None
    buf = collections.deque()

    def _place(batch):
        host = _to_tensors(batch)
        if place is not None:
            host = place(host)
        if not cuda:
            return {k: _finish(v) for k, v in host.items()}, None
        with torch.cuda.stream(copy_stream):
            out = {k: _finish(v.contiguous().pin_memory().to(
                device, non_blocking=True)) for k, v in host.items()}
            # (the pinned allocator holds each host buffer until the copy
            # that reads it is done)
            done = torch.cuda.Event()
            done.record(copy_stream)
        return out, done

    it = iter(iterator)
    try:
        for _ in range(size):
            buf.append(_place(next(it)))
    except StopIteration:
        pass
    while buf:
        out, done = buf.popleft()
        if done is not None:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(done)
            for v in out.values():  # the consumer's stream now owns them
                v.record_stream(stream)
        try:
            buf.append(_place(next(it)))
        except StopIteration:
            pass
        yield out


def _finish(t: torch.Tensor) -> torch.Tensor:
    """NHWC images -> contiguous NCHW; integer labels int64 (the losses'
    type)."""
    if t.dim() == 4:
        return t.permute(0, 3, 1, 2).contiguous()
    if not t.is_floating_point():
        return t.long()
    return t
