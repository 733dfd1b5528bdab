"""Host data loading: sharded sampling, threaded batching, and the upload
of batches to the device.

Counterpart of tal_asrd_tpu/data/loader.py:
  * ShardedSampler deals each epoch's (optionally shuffled) indices
    round-robin across data-parallel shards (DistributedSampler semantics:
    per-epoch seed, padding to equal shard sizes);
  * DataLoader maps a dataset through worker threads (audio decoding in
    numpy/scipy releases the GIL) and collates batches, in sampler order;
  * to_device uploads a batch's arrays; to a CUDA device through pinned
    (page-locked) host memory with non_blocking=True, so the copy does not
    stage through a pageable buffer and does not hold the host;
  * DevicePrefetcher keeps `depth` uploaded batches in flight.
"""
from __future__ import annotations

import collections
import queue
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch


class ShardedSampler:
    def __init__(self, dataset_len: int, shard_id: int = 0, num_shards: int = 1,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = False):
        self.n = dataset_len
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.drop_last = drop_last

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        idx = np.arange(self.n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(idx)
        if self.drop_last:
            usable = (self.n // self.num_shards) * self.num_shards
            idx = idx[:usable]
        else:
            # pad to equal shard sizes (DistributedSampler semantics)
            pad = (-len(idx)) % self.num_shards
            if pad:
                idx = np.concatenate([idx, idx[:pad]])
        return iter(idx[self.shard_id :: self.num_shards].tolist())

    def __len__(self) -> int:
        if self.drop_last:
            return self.n // self.num_shards
        return -(-self.n // self.num_shards)


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        collate_fn: Callable,
        sampler: Optional[ShardedSampler] = None,
        num_workers: int = 4,
        drop_last: bool = True,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.sampler = sampler or ShardedSampler(len(dataset), shuffle=False)
        self.num_workers = max(num_workers, 0)
        self.drop_last = drop_last

    def __len__(self) -> int:
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        indices = list(iter(self.sampler))
        batches = [
            indices[i : i + self.batch_size]
            for i in range(0, len(indices), self.batch_size)
        ]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        if self.num_workers == 0:
            for batch_idx in batches:
                yield self.collate_fn([self.dataset[i] for i in batch_idx])
            return

        # The futures are read in submission order, so batches keep the
        # sampler's order.
        with ThreadPoolExecutor(self.num_workers) as pool:
            def fetch(batch_idx):
                return self.collate_fn([self.dataset[i] for i in batch_idx])

            futures: "queue.Queue" = queue.Queue()
            depth = self.num_workers * 2
            it = iter(batches)
            inflight = 0
            for _ in range(depth):
                try:
                    futures.put(pool.submit(fetch, next(it)))
                    inflight += 1
                except StopIteration:
                    break
            while inflight:
                f = futures.get()
                inflight -= 1
                try:
                    futures.put(pool.submit(fetch, next(it)))
                    inflight += 1
                except StopIteration:
                    pass
                yield f.result()


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (or tensors) as tensors on `device`. To a CUDA
    device each array is copied into pinned host memory and uploaded with
    non_blocking=True; the caller's stream orders the copy before any kernel
    that reads it."""
    dev = torch.device(device)
    out = {}
    for key, value in batch.items():
        t = torch.as_tensor(value)
        if dev.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory()
        out[key] = t.to(dev, non_blocking=True)
    return out


class DevicePrefetcher:
    """Keeps `depth` device-resident batches in flight (host->device overlap).
    `put_fn` uploads one batch; by default `to_device(batch, device)`."""

    def __init__(self, iterator, put_fn: Optional[Callable] = None, depth: int = 2,
                 device: str = "cuda"):
        self.iterator = iter(iterator)
        self.put_fn = put_fn or (lambda batch: to_device(batch, device))
        self.depth = depth

    def __iter__(self):
        buf = collections.deque()
        for item in self.iterator:
            buf.append(self.put_fn(item))
            if len(buf) >= self.depth:
                yield buf.popleft()
        while buf:
            yield buf.popleft()
