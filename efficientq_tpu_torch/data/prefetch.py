"""Host -> device input pipeline: a threaded prefetch queue and the
upload of a loader's batches.

Counterpart of the JAX package's ``data/prefetch.py``.  ``PrefetchLoader``
materializes upcoming batches on a background thread (NumPy IO and the
augmentations release the GIL in their hot paths).  ``device_feed`` is the
card's version of JAX's asynchronous ``device_put``: each array is copied
into a pinned host staging buffer and uploaded on a side stream while the
caller's stream computes the batch before it.  Its span on a card
(``utils/tracing.py``): ``feed.stage``, the host's copy of an item into
pinned memory, with the item's index and ``bytes``.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

from ..utils.tracing import span


class PrefetchLoader:
    """Wraps a loader with a ``depth``-deep background prefetch queue."""

    def __init__(self, loader, depth: int = 2):
        self.loader = loader
        self.depth = depth

    def __len__(self):
        return len(self.loader)

    @property
    def dataset(self):
        return self.loader.dataset

    def __iter__(self) -> Iterator:
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        sentinel = object()
        err = []

        def worker():
            try:
                for item in self.loader:
                    q.put(item)
            except BaseException as e:  # raised again in the consumer
                err.append(e)
            finally:
                q.put(sentinel)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item


class _Staging:
    """A ring of pinned host buffers (two per array of an item), reused and
    grown to the largest batch.  A slot is written by the host only after
    the upload that last read it has finished (its event)."""

    def __init__(self, slots: int = 2):
        self.bufs = [None] * slots
        self.events = [None] * slots
        self.slot = 0

    def take(self, nbytes: int) -> torch.Tensor:
        k = self.slot
        self.slot = (k + 1) % len(self.bufs)
        if self.events[k] is not None:
            self.events[k].synchronize()
        if self.bufs[k] is None or self.bufs[k].numel() < nbytes:
            self.bufs[k] = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                                       pin_memory=True)
        self.last = k
        return self.bufs[k]

    def uploaded(self, event):
        self.events[self.last] = event


def _side_stream(device) -> "torch.cuda.Stream":
    return torch.cuda.Stream(device)


def device_feed(loader: Iterable, device=None, mesh=None):
    """Iterate ``loader`` (one NumPy array per item, or a tuple of them,
    as the train loader's (image, label) batches) keeping the next item's
    host -> device transfer in flight while the caller consumes the
    current one (double buffering).

    Each array goes to ``device`` (the card unless told ``"cpu"``) as a
    torch tensor of its dtype and shape.  On a card: the array is copied
    into one of the pinned staging buffers (two per array of an item), then
    uploaded with
    ``non_blocking=True`` on a side stream; the caller's current stream
    waits on the upload's event (the host does not), and ``record_stream``
    keeps the caching allocator from handing the device copy to the side
    stream again while the caller's stream may still read it.  On the CPU
    the array is wrapped as a tensor.

    ``mesh``: batch-axis sharding over a device mesh is ROADMAP queue 1
    item 9; any value but None raises."""
    if mesh is not None:
        raise NotImplementedError("device_feed over a device mesh is ROADMAP "
                                  "queue 1 item 9")
    device = torch.device("cuda" if device is None else device)
    it = iter(loader)
    ring = None

    if device.type != "cuda":
        def put_one(a, batch):
            return torch.as_tensor(np.asarray(a), device=device), None
    else:
        stream = _side_stream(device)

        def put_one(a, batch):
            a = np.ascontiguousarray(a)
            buf = ring.take(a.nbytes)[:a.nbytes]
            with span("feed.stage", batch=batch, bytes=a.nbytes):
                np.copyto(buf.numpy().view(a.dtype).reshape(a.shape), a)
            host = buf.view(torch.from_numpy(a[:0]).dtype).view(a.shape)
            # allocated on the side stream: its blocks return to that
            # stream's pool, and record_stream (in ready) holds them until
            # the caller's stream is done with them
            with torch.cuda.stream(stream):
                dev = host.to(device, non_blocking=True)
                event = torch.cuda.Event()
                event.record(stream)
            ring.uploaded(event)
            return dev, event

    def put(item, batch):
        nonlocal ring
        arrays = item if isinstance(item, tuple) else (item,)
        if device.type == "cuda" and ring is None:
            ring = _Staging(2 * len(arrays))
        return isinstance(item, tuple), [put_one(a, batch) for a in arrays]

    def ready_one(tensor, event):
        if event is not None:
            cur = torch.cuda.current_stream(device)
            cur.wait_event(event)
            tensor.record_stream(cur)
        return tensor

    def ready(is_tuple, uploads):
        out = tuple(ready_one(*u) for u in uploads)
        return out if is_tuple else out[0]

    try:
        pending = put(next(it), 0)
    except StopIteration:
        return
    for batch, item in enumerate(it, 1):
        nxt = put(item, batch)
        yield ready(*pending)
        pending = nxt
    yield ready(*pending)
