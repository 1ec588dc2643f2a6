"""Input pipeline: per-process sharding, threaded batch assembly and a
prefetching copy to the device.

The counterpart of `setok_tpu/data/loader.py`. `host_shard` takes this
process's slice of an index stream over the data ranks (the `data` axis of
a mesh, or the world); `batch_rows` and `BatchLoader(shard=)` a data
rank's rows of each global batch, which the ranks of one `model` or `seq`
group share. `BatchLoader` assembles
collated numpy batches on worker threads, with the JAX package's
permutation, order and `drop_last`. `DeviceLoader` takes the place of
`jax.device_put` with a sharding: a prefetch thread copies each batch to
the device while the consumer computes on the one before.

On a CUDA device each array goes through pinned host memory with
`non_blocking=True` on a copy stream of the loader's own; an event recorded
after the copies is waited on by the consumer's stream before the batch is
handed out, every tensor is `record_stream`ed on that stream (so the caching
allocator cannot give its memory to the copy stream again while the
consumer still reads it), and the pinned buffers are held until their event
has passed. On the CPU the arrays become tensors with no pinning and no
stream. A loader error is raised to the consumer.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Any, Callable, Dict, Iterator, Optional, Sequence

import numpy as np
import torch


def data_coordinates(mesh=None) -> tuple:
    """(this process's index, the count) over the data ranks: the `data`
    axis of `mesh` (the ranks of a `model` or `seq` group read the same
    batch), else the whole world when `torch.distributed` is initialised,
    else (0, 1)."""
    if mesh is not None:
        from setok_tpu_torch.parallel.mesh import (DATA_AXIS, axis_rank,
                                                   axis_size)
        return axis_rank(mesh, DATA_AXIS), axis_size(mesh, DATA_AXIS)
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_shard(indices: Sequence[int], process_index: Optional[int] = None,
               process_count: Optional[int] = None,
               mesh=None) -> Sequence[int]:
    """This process's slice of the global index stream (data parallel):
    index and count as given, or over the data ranks
    (`data_coordinates(mesh)`)."""
    pi, pc = data_coordinates(mesh)
    pi = pi if process_index is None else process_index
    pc = pc if process_count is None else process_count
    return list(indices)[pi::pc]


def batch_rows(batch: Dict[str, Any], index: int, count: int):
    """Rows [index·B/count, (index+1)·B/count) of a global batch's arrays
    (a data rank's share; other leaves pass through)."""
    if count == 1:
        return batch
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.ndim:
            n = v.shape[0]
            if n % count:
                raise ValueError(f"a batch of {n} rows cannot split over "
                                 f"{count} data ranks")
            v = v[index * n // count:(index + 1) * n // count]
        out[k] = v
    return out


class BatchLoader:
    """Threaded batch assembly: dataset[idx] on worker threads → collated
    numpy batches (the torch DataLoader's role, with threads: native
    preprocessing releases the GIL)."""

    def __init__(self, dataset, batch_size: int, collate: Callable,
                 sampler: Optional[Iterator[int]] = None,
                 num_workers: int = 2, seed: int = 0,
                 drop_last: bool = True, shard: tuple = (0, 1)):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate
        self.sampler = sampler
        self.num_workers = max(num_workers, 1)
        self.seed = seed
        self.drop_last = drop_last
        # (index, count): assemble only this data rank's rows of each
        # global batch (`batch_rows`' share)
        self.shard = shard

    def _indices(self):
        if self.sampler is not None:
            return list(self.sampler)
        rng = np.random.default_rng(self.seed)
        return rng.permutation(len(self.dataset)).tolist()

    def __iter__(self):
        from concurrent.futures import ThreadPoolExecutor
        idx = self._indices()
        nb = len(idx) // self.batch_size
        if not self.drop_last and len(idx) % self.batch_size:
            nb += 1
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            for b in range(nb):
                chunk = idx[b * self.batch_size:(b + 1) * self.batch_size]
                i, n = self.shard
                if n > 1:
                    chunk = chunk[i * len(chunk) // n:
                                  (i + 1) * len(chunk) // n]
                items = list(pool.map(self.dataset.__getitem__, chunk))
                yield self.collate(items)

    def __len__(self):
        return len(self._indices()) // self.batch_size


class DeviceLoader:
    """Wrap a host batch iterator with a background copy to `device`.

    Batches are dicts; their numpy leaves become tensors on `device`, other
    leaves pass through. `device=None` hands the host batches on unchanged.
    At most `prefetch` copied batches wait in the queue.
    """

    def __init__(self, iterator, device=None, prefetch: int = 2):
        self.iterator = iterator
        self.device = None if device is None else torch.device(device)
        self.prefetch = prefetch

    def _put(self, batch: Dict[str, Any], stream):
        """The batch's arrays on the device; with a copy stream also the
        event after the copies and the pinned buffers they read."""
        if self.device is None:
            return batch, None, ()
        if stream is None:
            return {k: (torch.from_numpy(v).to(self.device)
                        if isinstance(v, np.ndarray) else v)
                    for k, v in batch.items()}, None, ()
        out, pinned = {}, []
        with torch.cuda.stream(stream):
            for k, v in batch.items():
                if isinstance(v, np.ndarray):
                    host = torch.from_numpy(v).pin_memory()
                    out[k] = host.to(self.device, non_blocking=True)
                    pinned.append(host)
                else:
                    out[k] = v
            done = torch.cuda.Event()
            done.record(stream)
        return out, done, pinned

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        err = []
        stop = threading.Event()
        cuda = self.device is not None and self.device.type == "cuda"
        stream = torch.cuda.Stream(self.device) if cuda else None

        def offer(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def feed():
            it = None
            try:
                if cuda and self.device.index is not None:
                    torch.cuda.set_device(self.device)
                it = iter(self.iterator)
                for batch in it:
                    if not offer(self._put(batch, stream)):
                        return
            except Exception as e:        # surface loader errors to consumer
                err.append(e)
            finally:
                close = getattr(it, "close", None)
                if close is not None:
                    close()
                offer(sentinel)

        t = threading.Thread(target=feed, daemon=True)
        t.start()
        held = collections.deque()        # (event, pinned buffers) in flight
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if err:
                        raise err[0]
                    return
                batch, done, pinned = item
                if done is not None:
                    consumer = torch.cuda.current_stream(self.device)
                    consumer.wait_event(done)
                    for v in batch.values():
                        if isinstance(v, torch.Tensor):
                            v.record_stream(consumer)
                    held.append((done, pinned))
                    while held and held[0][0].query():
                        held.popleft()
                yield batch
        finally:
            stop.set()
            t.join(timeout=60)
            for done, _ in held:
                done.synchronize()
