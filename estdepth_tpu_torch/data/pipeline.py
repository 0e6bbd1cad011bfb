"""Host input pipeline of training: shuffling, sharding, batching, decode on
a thread pool and upload ahead of the step (the port's own copy of
estdepth_tpu/data/pipeline.py).

It replaces the reference's torch DataLoader + DistributedSampler
(train_hybrid.py:376-400) as the JAX package does, with threads: a
`torch.utils.data.DataLoader` would draw another order from its sampler
and decode in worker processes. The order is one permutation per epoch
from `np.random.default_rng(seed + epoch)`, padded at the head to a
multiple of `num_shards` and strided by `shard_index` (the sampler's
`set_epoch` and padding), so every package and every shard visits the same
windows in the same order.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Iterator

import numpy as np
import torch


def collate(samples) -> Dict[str, np.ndarray]:
    """Stack a list of dict samples along a new leading batch axis."""
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples]) for k in keys}


class TrainLoader:
    """Shuffled, sharded, prefetched batch iterator over a map-style
    dataset."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shard_index: int = 0,
        num_shards: int = 1,
        num_workers: int = 4,
        prefetch: int = 2,
        seed: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.seed = seed

    def steps_per_epoch(self) -> int:
        # as epoch(): shards are padded up to equal length, the ragged
        # tail of a shard is dropped
        per_shard = -(-len(self.dataset) // self.num_shards)
        return per_shard // self.batch_size

    def order(self, epoch: int) -> np.ndarray:
        """The dataset indices this shard visits in `epoch`, in order."""
        order = np.random.default_rng(self.seed + epoch).permutation(
            len(self.dataset))
        # pad to a multiple of num_shards by repeating the head (torch
        # DistributedSampler's padding): every shard yields the same number
        # of batches, so no rank steps into a collective the others skip
        if len(order) % self.num_shards:
            pad = self.num_shards - len(order) % self.num_shards
            order = np.concatenate([order, order[:pad]])
        shard = order[self.shard_index::self.num_shards]
        return shard[:len(shard) // self.batch_size * self.batch_size]

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        """The epoch's batches, decoded by `num_workers` threads at most
        `prefetch` batches ahead. A worker's exception is raised here."""
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)  # fresh retry draws per epoch
        batches = self.order(epoch).reshape(-1, self.batch_size)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # a plain put blocks forever on a full queue once the consumer
            # has left; poll the stop event so the thread and its pool end
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            # an exception must reach the consumer: a producer that dies
            # silently leaves it blocked on q.get() forever
            try:
                with ThreadPoolExecutor(max(self.num_workers, 1)) as pool:
                    for ids in batches:
                        if stop.is_set():
                            return
                        samples = list(pool.map(self.dataset.__getitem__,
                                                ids))
                        if not put(collate(samples)):
                            return
                put(None)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                put(e)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on `device`. To a CUDA device each array is
    copied into pinned memory and uploaded with `non_blocking=True`: the
    copy is queued on the current stream and the host goes on."""
    device = torch.device(device)
    if device.type != "cuda":
        return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    return {k: torch.from_numpy(v).pin_memory().to(device, non_blocking=True)
            for k, v in batch.items()}


def prefetch_to_device(batches: Iterable[Dict[str, np.ndarray]],
                       device) -> Iterator[Dict[str, torch.Tensor]]:
    """Upload each batch one ahead of the one handed out, so the copy of
    the next batch is queued behind the step that runs now."""
    ahead = None
    for batch in batches:
        batch = to_device(batch, device)
        if ahead is not None:
            yield ahead
        ahead = batch
    if ahead is not None:
        yield ahead
