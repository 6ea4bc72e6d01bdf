"""Batch collation and sampling.

Torch-package copy of easyhec_tpu/data/batching.py (the reference's
collators and samplers): collation produces static-shape padded numpy
batches (ragged entries padded to the max, with a validity mask), which
the caller moves to the device; samplers draw from explicit
``np.random.Generator``s. Host-side numpy only.
"""
from __future__ import annotations

from typing import Iterable, Iterator, Sequence

import numpy as np

__all__ = [
    "default_collate",
    "padded_collate",
    "IterationBasedBatchSampler",
    "ImageSizeBatchSampler",
    "OrderedShardSampler",
]


def default_collate(items: Sequence[dict]) -> dict:
    """Stack same-shaped fields (reference DefaultBatchCollator)."""
    out = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], np.ndarray) or np.isscalar(vals[0]):
            out[key] = np.stack([np.asarray(v) for v in vals])
        else:
            out[key] = vals
    return out


def padded_collate(items: Sequence[dict], pad_value: float = 0.0) -> dict:
    """Ragged-tolerant collation (reference ExtendedBatchCollator:12-61):
    array fields whose shapes differ are padded to the per-field max shape;
    a boolean `<key>_valid` mask of the same padded shape is added."""
    out = {}
    for key in items[0]:
        raw = [it[key] for it in items]
        if any(isinstance(v, str) or v is None for v in raw):
            out[key] = raw
            continue
        vals = [np.asarray(v) for v in raw]
        shapes = {v.shape for v in vals}
        if len(shapes) == 1:
            out[key] = np.stack(vals)
            continue
        ndim = vals[0].ndim
        if any(v.ndim != ndim for v in vals):
            out[key] = raw
            continue
        max_shape = tuple(max(v.shape[d] for v in vals) for d in range(ndim))
        batch = np.full((len(vals), *max_shape), pad_value, vals[0].dtype)
        valid = np.zeros((len(vals), *max_shape), bool)
        for i, v in enumerate(vals):
            sl = (i,) + tuple(slice(0, s) for s in v.shape)
            batch[sl] = v
            valid[sl] = True
        out[key] = batch
        out[key + "_valid"] = valid
    return out


class IterationBasedBatchSampler:
    """Resample an index-batch iterable until num_iterations batches
    (reference samplers/iteration_based_batch_sampler.py:1-21)."""

    def __init__(self, batches: Iterable, num_iterations: int, start_iter: int = 0):
        self.batches = batches
        self.num_iterations = num_iterations
        self.start_iter = start_iter

    def __iter__(self) -> Iterator:
        it = self.start_iter
        while it < self.num_iterations:
            for batch in self.batches:
                if it >= self.num_iterations:
                    return
                it += 1
                yield batch

    def __len__(self) -> int:
        return self.num_iterations - self.start_iter


class ImageSizeBatchSampler:
    """Per-batch random (H, W) on a size_int grid (reference
    samplers/image_size_batch_sampler.py:4-38); consumers resize the whole
    batch to that shape, so each bucket has one static shape."""

    def __init__(self, indices: Sequence[int], batch_size: int, drop_last: bool = True,
                 min_size: int = 600, max_size: int = 800, size_int: int = 8,
                 seed: int = 0):
        self.indices = list(indices)
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.min_size = min_size
        self.max_size = max_size
        self.size_int = size_int
        self.rng = np.random.default_rng(seed)

    def _size(self) -> tuple[int, int]:
        n = (self.max_size - self.min_size) // self.size_int + 1
        h = self.min_size + int(self.rng.integers(0, n)) * self.size_int
        w = self.min_size + int(self.rng.integers(0, n)) * self.size_int
        return h, w

    def __iter__(self):
        batch, hw = [], self._size()
        for idx in self.indices:
            batch.append((idx, *hw))
            if len(batch) == self.batch_size:
                yield batch
                batch, hw = [], self._size()
        if batch and not self.drop_last:
            yield batch

    def __len__(self) -> int:
        n = len(self.indices)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)


class OrderedShardSampler:
    """Deterministic contiguous sharding with tail padding for multi-host
    eval (the reference's OrderedDistributedSampler,
    samplers/ordered_distributed_sampler.py:7-59): every shard gets
    ceil(N / world) indices in dataset order; the last indices repeat to
    fill. Gathered predictions are truncated back to N by the caller."""

    def __init__(self, n_items: int, shard: int, n_shards: int):
        if not (0 <= shard < n_shards):
            raise ValueError(f"shard {shard} out of range for {n_shards}")
        self.n_items = n_items
        self.shard = shard
        self.n_shards = n_shards
        self.per_shard = -(-n_items // n_shards)

    def indices(self) -> np.ndarray:
        idx = np.arange(self.per_shard * self.n_shards) % max(self.n_items, 1)
        return idx[self.shard * self.per_shard : (self.shard + 1) * self.per_shard]

    def __iter__(self):
        return iter(self.indices().tolist())

    def __len__(self) -> int:
        return self.per_shard
