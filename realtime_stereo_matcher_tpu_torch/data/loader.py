"""Threaded batched data loader (port of the JAX package's framework-free
``realtime_stereo_matcher_tpu/data/loader.py``).

Replaces the reference's torch ``DataLoader`` (reference
dataset/stereo_datasets.py:484-491) with a dependency-free threaded loader:

* per-rank sharding (``shard_id`` / ``num_shards``): each rank of a
  data-parallel run reads a disjoint slice of every epoch's permutation,
  ``perm[shard_id::num_shards]`` -- the replacement for DataParallel's
  scatter;
* worker threads decode + augment (numpy releases the GIL in its C loops)
  into a bounded prefetch queue of ready NHWC numpy batches;
* fixed shapes (crop sizes) per batch: every epoch is a fresh permutation
  cut into whole batches, the remainder dropped;
* deterministic: an epoch-dependent permutation from a base seed and a
  per-sample augmentation RNG ``default_rng((seed, epoch, index))``, the
  same stream as the JAX package's loader.

The JAX loader's unshuffled and ragged-batch modes are left out: the
trainer shuffles and drops the last partial batch.
"""

from __future__ import annotations

import os
import queue
import threading

import numpy as np

# batches in flight beyond those the consumer has taken
PREFETCH = 4


class StereoDataLoader:
    """Iterable over (files, img1, img2, flow, valid) NHWC numpy batches."""

    def __init__(self, dataset, batch_size: int, *,
                 num_workers: int | None = None, seed: int = 1234,
                 shard_id: int = 0, num_shards: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shard_id = shard_id
        self.num_shards = num_shards
        if num_workers is None:
            # reference: SLURM_CPUS_PER_TASK - 2, default 6 - 2
            num_workers = max(1, int(os.environ.get("SLURM_CPUS_PER_TASK", 6)) - 2)
        self.num_workers = num_workers
        self.seed = seed
        self.epoch = 0

    def __len__(self):
        return len(self.dataset) // self.num_shards // self.batch_size

    def _epoch_indices(self, epoch: int):
        """This shard's disjoint slice of the epoch's shared permutation."""
        idx = np.random.default_rng(self.seed + epoch).permutation(
            len(self.dataset))
        return idx[self.shard_id::self.num_shards]

    def __iter__(self):
        # the epoch advances HERE, when the iterator is created -- an explicit
        # contract (each __iter__ call is one epoch draw), not a side effect
        # of generator finalization that would depend on refcounting GC if a
        # consumer abandons the iterator mid-epoch
        epoch = self.epoch
        self.epoch += 1
        indices = self._epoch_indices(epoch)
        # len(self), not len(indices): a shard one index longer than the
        # others would take one more batch, and its rank would wait at a
        # collective the others never reach
        nb = len(self)
        if nb == 0:
            return iter(())

        sample_q: queue.Queue = queue.Queue()
        done_q: queue.Queue = queue.Queue()
        stop = threading.Event()
        budget = threading.Semaphore(PREFETCH)

        for b in range(nb):
            sample_q.put((b, indices[b * self.batch_size:(b + 1) * self.batch_size]))

        def worker():
            while not stop.is_set():
                # acquire prefetch budget without deadlocking on abandonment
                if not budget.acquire(timeout=0.1):
                    continue
                try:
                    b, idxs = sample_q.get_nowait()
                except queue.Empty:
                    budget.release()
                    return
                try:
                    samples = []
                    for i in idxs:
                        # per-sample RNG: deterministic under any thread
                        # scheduling (seed, epoch, sample index)
                        srng = np.random.default_rng((self.seed, epoch, int(i)))
                        if hasattr(self.dataset, "get"):
                            samples.append(self.dataset.get(int(i), srng))
                        else:
                            samples.append(self.dataset[int(i)])
                    files = [s[0] for s in samples]
                    batch = (files,
                             np.stack([s[1] for s in samples]),
                             np.stack([s[2] for s in samples]),
                             np.stack([s[3] for s in samples]),
                             np.stack([s[4] for s in samples]))
                except Exception as exc:  # surface worker errors to consumer
                    batch = exc
                done_q.put((b, batch))

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        def gen():
            pending: dict = {}
            nxt = 0
            try:
                while nxt < nb:
                    while nxt not in pending:
                        b, batch = done_q.get()
                        pending[b] = batch
                    item = pending.pop(nxt)
                    nxt += 1
                    budget.release()
                    if isinstance(item, Exception):
                        raise item
                    yield item
            finally:
                stop.set()

        return gen()


def fetch_dataloader(exp_config, *, raw: bool = False, shard_id: int = 0,
                     num_shards: int = 1) -> StereoDataLoader:
    """Reference fetch_dataloader (stereo_datasets.py:411-494) equivalent.

    The config's ``train.batch_size`` is the GLOBAL batch (reference
    DataParallel semantics): with ``num_shards`` ranks each loader yields
    ``batch_size / num_shards`` samples a step from its disjoint shard.

    ``raw=True``: no host augmentors and uint8 images -- full-size samples
    for the on-device augmentation path (data/device_augment.py).
    """
    from realtime_stereo_matcher_tpu_torch.data.datasets import (
        ConcatDataset,
        build_train_dataset,
    )

    dataset = build_train_dataset(exp_config, raw=raw)
    if raw:
        leaves = (dataset.datasets if isinstance(dataset, ConcatDataset)
                  else [dataset])
        for d in leaves:
            d.out_dtype = np.uint8
    gb = exp_config.train.batch_size
    if gb % num_shards:
        raise ValueError(f"global batch {gb} not divisible by {num_shards} "
                         "ranks")
    return StereoDataLoader(dataset, gb // num_shards, shard_id=shard_id,
                            num_shards=num_shards)
