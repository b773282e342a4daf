"""Asynchronous device feed, the host I/O layer (counterpart of
`front_end_tpu/io/feed.py`).

`DeviceFeed` takes (left, right) frames from any iterator (numpy arrays
or CPU tensors) and hands them out in order as tensors on the device,
`depth` frames ahead of the consumer, so the frame step does not stall on
host decode or the host-to-device copy.

On the card, frames keep their source dtype (ship uint8: 4x fewer bytes
than float32; `vo_step` casts on the device).  A ring of `depth` pinned
host slots takes each frame, and its copy to the card is issued
`non_blocking` on a side stream, with an event recorded per slot.  A slot
is written again only once its event has completed: a slot overwritten
while its copy is in flight would give a wrong frame, not an error.  The
consumer's stream waits on the frame's event before it uses the frame,
and the frame's memory is marked as used by that stream (`record_stream`)
so the allocator does not hand it to the side stream early.  Frames
already on the device pass through.

On the CPU the feed is a plain ordered prefetch.  `threaded=False` does
the same work inline on the consumer's thread.  An exception raised by
the upstream iterator surfaces on the next `__next__`.
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from front_end_tpu_torch.utils.precision import resolve_device


class _Slot:
    """Pinned host buffers of one frame pair and the event of their last
    copy to the card."""

    def __init__(self):
        self.host = None
        self.copied = None

    def fill(self, l: np.ndarray, r: np.ndarray):
        if self.copied is not None:
            self.copied.synchronize()     # the last copy out has finished
        if (self.host is None or self.host[0].shape != l.shape
                or self.host[0].numpy().dtype != l.dtype):
            self.host = tuple(torch.from_numpy(np.empty_like(a)).pin_memory()
                              for a in (l, r))
        for buf, a in zip(self.host, (l, r)):
            np.copyto(buf.numpy(), a)
        return self.host


class DeviceFeed:
    """Iterate (left, right) frames -> tensors on `device`, prefetched.

    depth: frames in flight (ring slots on the card).  dtype: optional
    numpy dtype to convert to on the host before the copy (default: keep
    the source dtype)."""

    def __init__(self, frame_iter, depth: int = 3, device="cuda",
                 dtype=None, threaded: bool = True):
        self._device = resolve_device(device)
        self._dtype = dtype
        self._cuda = self._device.type == "cuda"
        if self._cuda:
            if self._device.index is None:    # compare equal to cuda:N
                self._device = torch.device("cuda",
                                            torch.cuda.current_device())
            self._stream = torch.cuda.Stream(self._device)
            self._slots = [_Slot() for _ in range(depth)]
            self._n = 0
        self._err = None
        self._threaded = threaded
        if threaded:
            self._q = queue.Queue(maxsize=depth)
            self._thread = threading.Thread(
                target=self._worker, args=(iter(frame_iter),), daemon=True)
            self._thread.start()
        else:
            self._it = iter(frame_iter)

    def _host(self, a):
        if isinstance(a, torch.Tensor):
            a = a.numpy()
        return np.asarray(a, self._dtype) if self._dtype else np.asarray(a)

    def _put(self, l, r):
        """One pair onto the device -> (left, right, event or None)."""
        if all(isinstance(a, torch.Tensor) and a.device == self._device
               for a in (l, r)):
            return l, r, None
        l, r = self._host(l), self._host(r)
        if not self._cuda:
            return torch.from_numpy(l.copy()), torch.from_numpy(r.copy()), \
                None
        slot = self._slots[self._n % len(self._slots)]
        self._n += 1
        hl, hr = slot.fill(l, r)
        with torch.cuda.stream(self._stream):
            dl = hl.to(self._device, non_blocking=True)
            dr = hr.to(self._device, non_blocking=True)
            slot.copied = torch.cuda.Event()
            slot.copied.record(self._stream)
        return dl, dr, slot.copied

    def _worker(self, it):
        try:
            for l, r in it:
                self._q.put(self._put(l, r))
        except Exception as e:          # surfaced on the next __next__
            self._err = e
        finally:
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        if self._threaded:
            item = self._q.get()
            if item is None:
                if self._err is not None:
                    raise self._err
                raise StopIteration
        else:
            item = self._put(*next(self._it))
        l, r, copied = item
        if copied is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(copied)
            l.record_stream(stream)
            r.record_stream(stream)
        return l, r
