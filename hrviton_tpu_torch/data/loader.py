"""Batching / prefetching loader (counterpart of ``hrviton_tpu/data/loader.py``).

Replaces CPDataLoader (reference cp_dataset.py:404-426): an infinite
iterator with shuffle, drop_last and auto-restart, plus background prefetch so
host PIL preprocessing (the get_agnostic drawing is CPU-heavy at 1024x768)
overlaps device compute. Two worker modes:

  * threads (default): zero-copy, but PIL decode holds the GIL for part of
    its work, so scaling saturates below core count;
  * processes (``worker_processes=True``): spawn-context worker processes,
    the semantic match of the reference's torch DataLoader ``--workers``
    (samples cross back as pickled numpy arrays). A worker only decodes
    with numpy and PIL: it never initialises CUDA.

String keys ('im_name', 'c_name') are carried out-of-band since they never
reach the device.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

__all__ = ["Loader", "collate"]

_STR_KEYS = ("im_name", "c_name")


def _proc_worker(dataset, task_q, result_q):
    """Worker-process loop: fetch (job_id, indices), return decoded samples."""
    while True:
        item = task_q.get()
        if item is None:
            return
        job_id, idxs = item
        result_q.put((job_id, [dataset[i] for i in idxs]))


def collate(samples: Sequence[Dict]) -> Dict:
    """Stack a list of sample dicts into a batch dict (nested one level for
    the cloth 'paired'/'unpaired' sub-dicts)."""
    out: Dict = {}
    first = samples[0]
    for k, v in first.items():
        if k in _STR_KEYS:
            if isinstance(v, dict):
                out[k] = {kk: [s[k][kk] for s in samples] for kk in v}
            else:
                out[k] = [s[k] for s in samples]
        elif isinstance(v, dict):
            out[k] = {kk: np.stack([s[k][kk] for s in samples]) for kk in v}
        else:
            out[k] = np.stack([s[k] for s in samples])
    return out


class Loader:
    """Infinite prefetching batch loader over a map-style dataset."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 4,
                 prefetch: int = 2, seed: int = 0,
                 indices: Optional[Sequence[int]] = None,
                 process_id: int = 0, num_processes: int = 1,
                 worker_processes: bool = False):
        """batch_size is the GLOBAL batch. Under several processes
        (num_processes > 1) every process shuffles the identical seeded
        permutation and yields only its contiguous slice of each global
        chunk: the per-process batches concatenate (in process order) to
        exactly the single-process batch."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        if batch_size % num_processes:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"{num_processes} processes")
        self._num_processes = num_processes
        self._proc_lo = (batch_size // num_processes) * process_id
        self._proc_hi = self._proc_lo + batch_size // num_processes
        self._indices = list(indices) if indices is not None \
            else list(range(len(dataset)))
        self._rng = np.random.default_rng(seed)
        self._workers: List = []
        if worker_processes:
            self._start_process_pool(max(1, num_workers), dataset)
            self._pool = None
        else:
            self._pool = ThreadPoolExecutor(max_workers=max(1, num_workers))
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _start_process_pool(self, n: int, dataset):
        ctx = mp.get_context("spawn")
        self._task_q = ctx.Queue()
        self._result_q = ctx.Queue()
        for _ in range(n):
            p = ctx.Process(target=_proc_worker,
                            args=(dataset, self._task_q, self._result_q),
                            daemon=True)
            p.start()
            self._workers.append(p)

    def _fetch_samples(self, chunk: List[int]) -> List[Dict]:
        if self._pool is not None:
            return list(self._pool.map(self.dataset.__getitem__, chunk))
        # split the batch across workers; reassemble in submission order
        n = len(self._workers)
        subs = [chunk[i::n] for i in range(n)]
        subs = [s for s in subs if s]
        for jid, s in enumerate(subs):
            self._task_q.put((jid, s))
        parts: Dict[int, List[Dict]] = {}
        while len(parts) < len(subs):
            jid, samples = self._result_q.get()
            parts[jid] = samples
        # undo the [i::n] round-robin interleave
        out: List[Optional[Dict]] = [None] * len(chunk)
        for jid, s in enumerate(subs):
            for pos, sample in zip(range(jid, len(chunk), len(subs)), parts[jid]):
                out[pos] = sample
        return out  # type: ignore[return-value]

    def _epoch_batches(self) -> Iterator[List[int]]:
        idx = self._indices[:]
        if self.shuffle:
            self._rng.shuffle(idx)
        for i in range(0, len(idx), self.batch_size):
            chunk = idx[i:i + self.batch_size]
            if len(chunk) < self.batch_size:
                if self.drop_last or self._num_processes > 1:
                    return  # ragged tails can't shard evenly across processes
                yield chunk
                continue
            yield chunk[self._proc_lo:self._proc_hi]

    def _produce(self):
        while not self._stop.is_set():
            for chunk in self._epoch_batches():
                samples = self._fetch_samples(chunk)
                batch = collate(samples)
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=0.5)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return

    def next_batch(self) -> Dict:
        return self._q.get()

    def __iter__(self):
        while True:
            yield self.next_batch()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        if self._pool is not None:
            self._pool.shutdown(wait=False)
        for _ in self._workers:
            try:
                self._task_q.put(None)
            except (OSError, ValueError):      # the queue is already closed
                pass
        for p in self._workers:
            p.join(timeout=2)
            if p.is_alive():
                p.terminate()
