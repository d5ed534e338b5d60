"""Prefetching host data loaders (thread pool + process pool).

Counterpart of `gcdlss_tpu/data/loader.py`, in numpy alone: pipelines that
overlap scan reading/augmentation/voxelization with the device step
(SURVEY §7.4). Batches are collated into fixed-capacity numpy buffers; the
trainers copy them to the device (`train/common.voxel_batch_to_device`).

Two backends:
  * `PrefetchLoader` — thread pool. Zero-copy handoff; scales as far as the
    numpy-releases-the-GIL fraction of the per-scan work allows.
  * `MultiprocessLoader` — worker processes, one dataset copy each, like
    the torch DataLoader. Sidesteps the GIL entirely at the cost of
    pickling each ScanSample (~2 MB/scan) through a pipe; use when per-scan
    Python time (label decode, aug bookkeeping) dominates. Default start
    method is "spawn": the parent holds the framework's worker threads,
    and forking a multithreaded process is a latent deadlock (CPython
    emits DeprecationWarning for exactly this). Pass mp_context="fork" to
    compare.

Two ways to draw a scan's augmentation:
  * `per_scan_seed=True`, the default — scan `i` of epoch `e` draws from a
    generator of its own, seeded by (dataset seed, e, i) through
    `dataset.get(i, rng)`. The batches are then the same on every run and
    for every worker count. The port's trainers use this mode. A loader's
    `view` v > 0 seeds by (dataset seed, e, i, v): the same scans in the
    same order (the order depends on the loader's `seed` alone), other
    augmentation draws, as SwaV's second view needs.
  * `per_scan_seed=False` — every `dataset[i]` draws from the dataset's one
    generator, as the JAX package's loader does. With one worker the batches
    equal that loader's bit for bit (what the parity test asks for); with
    several, which scan gets which draw depends on thread timing.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np

from .collation import collate_batch

# worker-global dataset: initialized once per worker process (fork inherits
# the parent copy; spawn unpickles it once), so per-item tasks ship only an
# integer index instead of re-pickling the dataset per call
_WORKER_DS = None


def _mp_init(dataset):
    global _WORKER_DS
    _WORKER_DS = dataset


def _mp_get(i: int, epoch: int | None = None, view: int = 0):
    return _fetch(_WORKER_DS, i, epoch, view)


def scan_rng(dataset_seed: int, epoch: int, index: int, view: int = 0) -> np.random.Generator:
    """The generator of scan `index` in epoch `epoch` of a dataset (of view
    `view` > 0 of it: another stream for the same scan)."""
    key = [int(dataset_seed), int(epoch), int(index)] + ([int(view)] if view else [])
    return np.random.default_rng(key)


def _fetch(dataset, i: int, epoch: int | None, view: int = 0):
    """`dataset[i]`, from the shared generator (`epoch` None) or the scan's own."""
    if epoch is None:
        return dataset[int(i)]
    return dataset.get(int(i), scan_rng(dataset.seed, epoch, i, view))


def _check_per_scan(dataset) -> None:
    if not (hasattr(dataset, "get") and hasattr(dataset, "seed")):
        raise TypeError(f"per_scan_seed needs a dataset with get(i, rng) and a seed, "
                        f"got {type(dataset).__module__}.{type(dataset).__name__}")


def _prefetched(produce, prefetch: int):
    """Run `produce(put, stop)` in a thread and yield what it puts. An
    exception in the producer is raised here, not lost with its thread (which
    would leave the consumer waiting for ever)."""
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def run():
        try:
            produce(q.put, stop)
            end = None
        except BaseException as exc:  # handed to the consumer, which raises it
            end = exc
        if not stop.is_set():
            q.put(end)

    threading.Thread(target=run, daemon=True).start()
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


class PrefetchLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        voxel_cap: int,
        point_cap: int | None = None,
        shuffle: bool = True,
        num_workers: int = 4,
        prefetch: int = 2,
        seed: int = 0,
        drop_last: bool = True,
        per_scan_seed: bool = True,
        epoch: int = 0,
        view: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.voxel_cap = voxel_cap
        self.point_cap = point_cap
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last
        if per_scan_seed:
            _check_per_scan(dataset)
        elif view:
            raise ValueError("a view > 0 needs per_scan_seed")
        self.per_scan_seed = per_scan_seed
        # the pass the next iteration is (part of each scan's seed): `epoch`
        # to begin with, one more for each pass started
        self.epoch = epoch
        self.view = view

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        nb = len(self)
        batches = [
            order[i * self.batch_size : (i + 1) * self.batch_size] for i in range(nb)
        ]
        epoch = self.epoch if self.per_scan_seed else None
        self.epoch += 1

        def produce(put, stop):
            with ThreadPoolExecutor(self.num_workers) as pool:
                for idxs in batches:
                    if stop.is_set():
                        return
                    samples = list(pool.map(
                        lambda i: _fetch(self.dataset, i, epoch, self.view), idxs))
                    put(collate_batch(samples, self.voxel_cap, self.point_cap))

        return _prefetched(produce, self.prefetch)


class MultiprocessLoader:
    """Process-pool variant of `PrefetchLoader` (same iteration protocol).

    Each `__iter__` starts `num_workers` processes (spawned by default, see
    module docstring) holding the dataset. With `per_scan_seed=False` every
    __getitem__ draws from the dataset's own rng state in its worker copy,
    so the worker rng streams diverge from the serial order and epoch
    contents depend on the worker count, as with the torch DataLoader this
    mirrors; with per-scan seeds they do not."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        voxel_cap: int,
        point_cap: int | None = None,
        shuffle: bool = True,
        num_workers: int = 4,
        prefetch: int = 2,
        seed: int = 0,
        drop_last: bool = True,
        mp_context: str = "spawn",
        per_scan_seed: bool = True,
        epoch: int = 0,
        view: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.voxel_cap = voxel_cap
        self.point_cap = point_cap
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last
        self.mp_context = mp_context
        if per_scan_seed:
            _check_per_scan(dataset)
        elif view:
            raise ValueError("a view > 0 needs per_scan_seed")
        self.per_scan_seed = per_scan_seed
        self.epoch = epoch
        self.view = view

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        nb = len(self)
        batches = [
            order[i * self.batch_size : (i + 1) * self.batch_size]
            for i in range(nb)
        ]
        epoch = self.epoch if self.per_scan_seed else None
        self.epoch += 1

        def produce(put, stop):
            ctx = mp.get_context(self.mp_context)
            with ProcessPoolExecutor(
                self.num_workers, mp_context=ctx,
                initializer=_mp_init, initargs=(self.dataset,),
            ) as pool:
                # keep ~2 batches in flight per worker: submitting ahead
                # pipelines sample production across batches
                futs = []
                for idxs in batches:
                    futs.append([pool.submit(_mp_get, i, epoch, self.view) for i in idxs])
                    # bound the submission window so cancellation works
                    while len(futs) > self.prefetch + 2:
                        if stop.is_set():
                            for fb in futs:
                                for f in fb:
                                    f.cancel()
                            return
                        samples = [f.result() for f in futs.pop(0)]
                        put(collate_batch(samples, self.voxel_cap, self.point_cap))
                for fb in futs:
                    if stop.is_set():
                        return
                    samples = [f.result() for f in fb]
                    put(collate_batch(samples, self.voxel_cap, self.point_cap))

        return _prefetched(produce, self.prefetch)


def make_loader(dataset, batch_size, voxel_cap, *, backend: str = "thread",
                **kw):
    """Loader factory: backend 'thread' (PrefetchLoader) or 'process'."""
    cls = MultiprocessLoader if backend == "process" else PrefetchLoader
    return cls(dataset, batch_size, voxel_cap, **kw)


def cycle(loader):
    while True:
        yield from loader
