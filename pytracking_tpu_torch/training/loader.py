"""Batch loader: frame-major stacking with a background prefetch thread
(counterpart of pytracking_tpu/training/loader.py). Batches stack the
samples at dim 1, (num_frames, batch, ...), the layout the actors and nets
take. The samples are made by a thread pool: the producers are numpy and
cv2, which release the GIL, and the heavy math runs on the device.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np


def _stack_dim1(samples: list, stack_dim: int = 1) -> dict:
    """Collate processed samples: per-frame lists -> (num_frames, batch,
    ...) arrays (stack_dim 1) or (batch, num_frames, ...) (stack_dim 0);
    other arrays gain a leading axis of 1 over the batch (stack_dim 1) or
    stack at 0; strings stay a list."""
    out = {}
    keys = samples[0].keys()
    for k in keys:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], str):
            out[k] = vals
            continue
        if isinstance(vals[0], (list, tuple)):
            frames = len(vals[0])
            stacked = np.stack(
                [np.stack([np.asarray(v[f]) for v in vals], axis=0)
                 for f in range(frames)], axis=0)
            out[k] = stacked if stack_dim == 1 else \
                np.moveaxis(stacked, 0, 1)
        elif stack_dim == 0:
            out[k] = np.stack([np.asarray(v) for v in vals], axis=0)
        else:
            out[k] = np.stack([np.asarray(v) for v in vals], axis=0)[None] \
                if np.asarray(vals[0]).ndim > 0 else np.asarray(vals)
    return out


class LTRLoader:
    """Iterable over an epoch of frame-major batches, `prefetch` batches
    made ahead by a thread with `num_workers` worker threads."""

    def __init__(self, name: str, dataset, training: bool = True, batch_size: int = 8,
                 num_workers: int = 4, epoch_interval: int = 1, stack_dim: int = 1,
                 drop_last: bool = True, prefetch: int = 2):
        self.name = name
        self.training = training
        self.dataset = dataset
        self.batch_size = batch_size
        self.epoch_interval = epoch_interval
        self.stack_dim = stack_dim
        self.num_workers = max(num_workers, 1)
        self.prefetch = prefetch
        self.__len = len(dataset) // batch_size

    def __len__(self):
        return self.__len

    def _batches(self, pool, stop: threading.Event):
        idx = 0
        for _ in range(len(self)):
            if stop.is_set():
                return
            samples = list(pool.map(self.dataset.__getitem__,
                                    range(idx, idx + self.batch_size)))
            idx += self.batch_size
            yield _stack_dim1(samples, self.stack_dim)

    def _produce(self, q: queue.Queue, stop: threading.Event):
        from concurrent.futures import ThreadPoolExecutor
        try:
            with ThreadPoolExecutor(self.num_workers) as pool:
                for batch in self._batches(pool, stop):
                    q.put(batch)
        except BaseException as e:          # the consumer raises it
            q.put(e)
        finally:
            q.put(None)

    def __iter__(self) -> Iterator[dict]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        t = threading.Thread(target=self._produce, args=(q, stop), daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
            while t.is_alive():             # unblock a producer waiting on a full queue
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass


class MultiEpochLTRLoader(LTRLoader):
    """LTRLoader whose producer keeps running across epochs, so the next
    epoch's first batch is made while this epoch's last step runs.
    `close()` stops it."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._q: Optional[queue.Queue] = None
        self._stop = threading.Event()

    def _produce_forever(self, q: queue.Queue, stop: threading.Event):
        from concurrent.futures import ThreadPoolExecutor
        try:
            with ThreadPoolExecutor(self.num_workers) as pool:
                while not stop.is_set():
                    for batch in self._batches(pool, stop):
                        while not stop.is_set():
                            try:
                                q.put(batch, timeout=0.1)
                                break
                            except queue.Full:
                                pass
        except BaseException as e:
            q.put(e)

    def __iter__(self) -> Iterator[dict]:
        if self._q is None:
            self._q = queue.Queue(maxsize=self.prefetch)
            t = threading.Thread(target=self._produce_forever,
                                 args=(self._q, self._stop), daemon=True)
            t.start()
        for _ in range(len(self)):
            batch = self._q.get()
            if isinstance(batch, BaseException):
                raise batch
            yield batch

    def close(self) -> None:
        self._stop.set()
