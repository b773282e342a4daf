"""ctypes wrapper over the repository's native stereo frame feed,
`csrc/feed.cc` (counterpart of `front_end_tpu/io/native_feed.py`).

N decoder threads fill an ordered ring of pre-allocated frame slots (PGM,
8-bit gray PNG or raw grayscale); the consumer drains it strictly in
frame order.  It is an upstream iterator for `io.feed.DeviceFeed`, which
overlaps the copy to the card as well:

    frames = NativeStereoFeed(lefts, rights, h, w)
    for l_dev, r_dev in DeviceFeed(frames.frames_zero_copy()):
        state, out = vo.vo_step(state, l_dev, r_dev, rig, cfg)
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np

from front_end_tpu_torch import native


class _Lib:
    handle = None

    @classmethod
    def get(cls) -> ctypes.CDLL:
        if cls.handle is None:
            lib = ctypes.CDLL(str(native.feed_library_path()))
            lib.fe_feed_open.restype = ctypes.c_void_p
            lib.fe_feed_open.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.c_long, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int]
            lib.fe_feed_acquire.restype = ctypes.c_long
            lib.fe_feed_acquire.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte))]
            lib.fe_feed_release.restype = None
            lib.fe_feed_release.argtypes = [ctypes.c_void_p]
            lib.fe_feed_next.restype = ctypes.c_long
            lib.fe_feed_next.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_ubyte),
                ctypes.POINTER(ctypes.c_ubyte)]
            lib.fe_feed_error.restype = ctypes.c_char_p
            lib.fe_feed_error.argtypes = [ctypes.c_void_p]
            lib.fe_feed_close.restype = None
            lib.fe_feed_close.argtypes = [ctypes.c_void_p]
            cls.handle = lib
        return cls.handle


def available() -> bool:
    """True if the native feed builds and loads on this machine."""
    try:
        _Lib.get()
        return True
    except (native.NativeBuildError, OSError):
        return False


class NativeStereoFeed:
    """Iterate (left, right) uint8 (H, W) frames decoded by native threads.

    Frames come out strictly in input order whatever order the decoders
    finish in.  Each pair from iterating is an owned copy (safe to hold);
    `frames_zero_copy` yields views into the ring, for a consumer that is
    done with a frame before it asks for the next (e.g. `DeviceFeed`,
    which copies it into a pinned slot first).
    """

    def __init__(self, left_paths: Sequence[str], right_paths: Sequence[str],
                 height: int, width: int, ring: int = 8, threads: int = 4):
        if len(left_paths) != len(right_paths):
            raise ValueError("left/right path lists differ in length")
        self._lib = _Lib.get()
        self._n = len(left_paths)
        self._h, self._w = height, width
        # kept alive for the feed's life: the decoder threads read them
        self._paths = [(ctypes.c_char_p * self._n)(
            *[str(p).encode() for p in ps])
            for ps in (left_paths, right_paths)]
        self._feed = self._lib.fe_feed_open(
            *self._paths, self._n, height, width, ring, threads)
        if not self._feed:
            raise RuntimeError("fe_feed_open failed")

    def _check_error(self):
        err = self._lib.fe_feed_error(self._feed)
        if err:
            raise RuntimeError(f"native feed: {err.decode()}")

    def __len__(self):
        return self._n

    def __iter__(self):
        buf_l = np.empty((self._h, self._w), np.uint8)
        buf_r = np.empty((self._h, self._w), np.uint8)
        pl = buf_l.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))
        pr = buf_r.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))
        while True:
            if self._lib.fe_feed_next(self._feed, pl, pr) < 0:
                self._check_error()
                return
            yield buf_l.copy(), buf_r.copy()

    def frames_zero_copy(self):
        """Yield views into ring slots; each is valid only until the next
        step of the generator (the slot is released when it resumes)."""
        lp = ctypes.POINTER(ctypes.c_ubyte)()
        rp = ctypes.POINTER(ctypes.c_ubyte)()
        n_px = self._h * self._w
        while True:
            if self._lib.fe_feed_acquire(self._feed, ctypes.byref(lp),
                                         ctypes.byref(rp)) < 0:
                self._check_error()
                return
            l = np.ctypeslib.as_array(lp, shape=(n_px,)).reshape(
                self._h, self._w)
            r = np.ctypeslib.as_array(rp, shape=(n_px,)).reshape(
                self._h, self._w)
            try:
                yield l, r
            finally:
                self._lib.fe_feed_release(self._feed)

    def close(self):
        if getattr(self, "_feed", None):
            self._lib.fe_feed_close(self._feed)
            self._feed = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
