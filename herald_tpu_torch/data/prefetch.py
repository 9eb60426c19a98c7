"""Async host-to-device prefetch (port of `herald_tpu/data/prefetch.py`).

A worker thread stages the next chunks of a host dataset on the device
while the current chunk trains, as JAX's `DevicePrefetcher` does with
`jax.device_put` (the reference's host ring buffer,
`python/hetu/dataloader.py:28-56`). On a card:

- The worker packs each chunk into one pinned host buffer
  (`train/graphs.py` `pack`) and copies it with `non_blocking=True` on a
  CUDA stream of its own (`CopyStream`), then records an event. A copy
  on the worker's default stream would wait for all earlier compute and
  overlap nothing.
- The consumer makes its current stream wait on that event and calls
  `record_stream` on the device buffer before any step reads it: the
  buffer was allocated on the copy stream, and without it the caching
  allocator could hand its memory to the next staged chunk while a read
  is still queued.
- The pinned buffer is dropped once its copy is issued; the caching host
  allocator reuses its memory only after the copy has landed.

On the CPU there is no stream and no pinning. numpy and torch only.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch

from herald_tpu_torch.train.graphs import PackedSteps, pack


class CopyStream:
    """Host-to-device copies from worker threads on a CUDA stream of their
    own; nothing of the kind on the CPU."""

    def __init__(self, device: torch.device):
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)

    def run(self, fn: Callable, *args, **kwargs):
        """(fn(*args, **kwargs) with this stream current, an event recorded
        on the stream after it; None on the CPU)."""
        if self.stream is None:
            return fn(*args, **kwargs), None
        with torch.cuda.stream(self.stream):
            out = fn(*args, **kwargs)
            event = torch.cuda.Event()
            event.record(self.stream)
        return out, event

    @staticmethod
    def ready(tensor: torch.Tensor, event) -> torch.Tensor:
        """On the thread that reads `tensor`: its current stream waits for
        the copy, and the allocator learns that the stream uses it."""
        if event is not None:
            cur = torch.cuda.current_stream(tensor.device)
            cur.wait_event(event)
            tensor.record_stream(cur)
        return tensor


class DevicePrefetcher:
    """Iterate chunks of a host dataset staged on `device`, in order.

    A chunk holds K steps of `global_batch` rows of every array (at most
    three: dense features, sparse ids, labels), cast to its dtype, as
    `PackedSteps` (`train/graphs.py`) whose inputs are named "d", "s" and
    "y", what `Engine.train_epoch` reads; `PackedSteps.tensors()` gives
    each as [K, rows, ...]. Over `ranks` > 1 ranks a chunk holds this
    rank's block of each global batch (the rows `Engine._rank_block`
    takes), so a rank stages 1/S of the bytes.

    `drop_last=True` stages every full batch: an epoch trains `n // GB`
    steps, its last chunk holding the remaining `n // GB % K` (JAX's
    stages `n // (K * GB)` whole chunks and drops those steps).
    `drop_last=False` wraps the last chunk's tail from the head of the
    data, as JAX's does.
    """

    _END = object()
    NAMES = ("d", "s", "y")

    def __init__(self, arrays: Sequence[np.ndarray], steps_per_chunk: int,
                 global_batch: int, dtypes: Sequence, device=None,
                 depth: int = 2, drop_last: bool = True, rank: int = 0,
                 ranks: int = 1):
        from herald_tpu_torch.train.engine import resolve_device
        if global_batch % ranks:
            raise ValueError(f"a global batch of {global_batch} rows does "
                             f"not split over {ranks} ranks")
        if len(arrays) > len(self.NAMES):
            raise ValueError(f"{len(arrays)} arrays: at most "
                             f"{len(self.NAMES)}")
        self.arrays = [np.asarray(a) for a in arrays]
        self.K = steps_per_chunk
        self.gb = global_batch
        self.dtypes = [np.dtype(d) for d in dtypes]
        self.device = resolve_device(device)
        self.rank, self.ranks = rank, ranks
        self.names = self.NAMES[:len(self.arrays)]
        n = len(self.arrays[0])
        if drop_last:
            self._steps = n // self.gb
            self.num_chunks = -(-self._steps // self.K)
        else:
            self.num_chunks = -(-n // (self.K * self.gb))
            self._steps = self.num_chunks * self.K
        if self.num_chunks < 1:
            raise ValueError("not enough samples for one chunk")
        self._copies = CopyStream(self.device)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None

    @property
    def steps_per_epoch(self) -> int:
        """Steps of one pass over the data: the sum of its chunks' K."""
        return self._steps

    def _host(self, ci: int):
        """{name: [k, rows, ...] host array} of chunk `ci`."""
        k = min(self.K, self._steps - ci * self.K)
        lo, m = ci * self.K * self.gb, k * self.gb
        b = self.gb // self.ranks
        out = {}
        for name, a, dt in zip(self.names, self.arrays, self.dtypes):
            chunk = a[lo:lo + m]
            if len(chunk) < m:      # wrap the tail from the head
                chunk = np.concatenate([chunk, a[:m - len(chunk)]])
            chunk = chunk.astype(dt, copy=False).reshape(k, self.gb,
                                                         *a.shape[1:])
            out[name] = chunk[:, self.rank * b:(self.rank + 1) * b]
        return k, out

    def _stage(self, ci: int):
        k, host = self._host(ci)

        def put():
            buf, layout = pack(host, k, pin=self.device.type == "cuda")
            return PackedSteps(buf.to(self.device, non_blocking=True),
                               layout)
        return self._copies.run(put)

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self, epochs: int) -> None:
        try:
            for _ in range(epochs):
                for ci in range(self.num_chunks):
                    if self._stop.is_set() or not self._put(self._stage(ci)):
                        return
        except BaseException as e:      # raised again by the consumer
            self._err = e
        finally:
            self._put(self._END)

    def __call__(self, epochs: int = 1) -> Iterator[PackedSteps]:
        self._stop.clear()
        self._err = None
        self._thread = threading.Thread(target=self._worker, args=(epochs,),
                                        daemon=True,
                                        name="herald-prefetch")
        self._thread.start()
        while True:
            item = self._q.get()
            if item is self._END:
                if self._err is not None:
                    raise self._err
                return
            chunk, event = item
            CopyStream.ready(chunk.packed, event)
            yield chunk

    def close(self) -> None:
        """Stop the worker (mid-stream too) and drop what it staged."""
        self._stop.set()
        if self._thread is not None:
            while self._thread.is_alive():
                try:
                    self._q.get(timeout=0.1)
                except queue.Empty:
                    pass
            self._thread.join()
        while not self._q.empty():
            self._q.get_nowait()
