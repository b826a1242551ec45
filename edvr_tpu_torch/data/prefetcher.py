"""The CUDA-stream prefetcher of ``prefetch_mode: cuda`` (reference:
basicsr/data/prefetch_dataloader.py:84-126), the counterpart of
``edvr_tpu/data/loader.py::DevicePrefetcher``: ``depth`` batches in flight
to the card while the current step computes."""

from __future__ import annotations

import collections

import torch


class CUDAPrefetcher:
    """Batches of ``loader`` on ``device``, ``depth`` of them in flight.

    On a CUDA device each batch's tensors are copied on a side stream
    (``non_blocking``: the loader pins its batches when this mode is asked
    for) and the copy's event is recorded; :meth:`next` makes the caller's
    current stream wait on that event and records the tensors' use on it
    (``record_stream``), so that the allocator does not hand their memory
    out while the step reads them. ``feed_data``'s ``.to(device)`` then
    finds them in place and copies nothing. On the CPU (which the caller
    asks for) the batches pass through with no stream. A CUDA device with
    no card raises.

    Batches are fetched when :meth:`next` is called, ``depth`` ahead of
    the one it returns, so that the items and their order are
    CPUPrefetcher's (a loader iterator is made here, as CPUPrefetcher
    makes one, since making one draws the loader's base seed); a
    :meth:`reset` in mid-epoch drops the batches in flight."""

    def __init__(self, loader, device, depth=2):
        self.loader = loader
        self.device = torch.device(device)
        self.depth = depth
        self.stream = None
        if self.device.type == 'cuda':
            if not torch.cuda.is_available():
                raise RuntimeError('prefetch_mode cuda: device '
                                   f'{self.device} was asked for but CUDA '
                                   'is not available')
            self.stream = torch.cuda.Stream(self.device)
        self._queue = collections.deque()
        self._iter = iter(loader)

    def _put(self, batch):
        """(batch on the device, the copy's event or None)."""
        if self.stream is None:
            return {k: v.to(self.device) if torch.is_tensor(v) else v
                    for k, v in batch.items()}, None
        with torch.cuda.stream(self.stream):
            out = {k: v.to(self.device, non_blocking=True)
                   if torch.is_tensor(v) else v for k, v in batch.items()}
            event = torch.cuda.Event()
            event.record(self.stream)
        return out, event

    def _fill(self):
        while len(self._queue) < self.depth:
            try:
                batch = next(self._iter)
            except StopIteration:
                return
            self._queue.append(self._put(batch))

    def reset(self):
        self._iter = iter(self.loader)
        self._queue.clear()

    def next(self):
        self._fill()
        if not self._queue:
            return None
        batch, event = self._queue.popleft()
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            for v in batch.values():
                if torch.is_tensor(v):
                    v.record_stream(consumer)
        self._fill()
        return batch
