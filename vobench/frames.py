"""The general traffic generator: a cell's frames from its configuration,
its traffic mix and the seed.

The frames are rendered on the card at set-up (`scene.py`) at the
deployment's rig, resolution and camera rate, then held as uint8 pairs
in host memory, as a camera driver or a decoded log delivers them.  A
mix renders `unique_pairs` pairs along the deployment's camera path and
replays them in the order it names (`pingpong`: forward, then backward,
then forward again, so any number of frames sees continuous motion).
The source is `mem` (the host arrays) or `png` (KITTI-layout files
written once per checkout, seed and configuration into `vobench/_cache/`,
and read back by the port's `io/kitti.py`; the `PNG_KEEP` keys used last
are kept, about 56 MB each at KITTI's size).  The loop is `closed` (a
frame is there when the loop asks for it) or `open` (a camera: frame k
is handed over no earlier than its due time, at the mix's `rate`).
"""
from __future__ import annotations

import hashlib
import itertools
import json
import math
import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from vobench import pngenc, scene

CACHE = Path(__file__).resolve().parent / "_cache"
RENDER_BATCH = 16       # poses rendered per call
ENCODE_THREADS = 6      # zlib releases the interpreter lock
PNG_KEEP = 8            # png file sets kept in the cache, by last use
SPIN_S = 0.002          # an open loop spins the last stretch before a due
                        # time: the host's timer wakes a sleeper ~1 ms late


@dataclass
class Frames:
    lefts: np.ndarray       # (N, H, W) uint8, host memory
    rights: np.ndarray
    gt: np.ndarray          # (N, 4, 4) float64 world_T_camera
    png_root: Path | None   # KITTI-layout root of the png source
    hz: float = 0.0         # the camera rate the path was rendered at


def seed_of(seed: int) -> int:
    """Any whole number -> a 63-bit generator seed."""
    return int(seed) % (1 << 63)


def render(config: dict, n: int, seed: int, device) -> Frames:
    """n stereo pairs along the configuration's camera path."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_of(seed))
    planes = scene.box_scene(config["scene"], gen)
    gt = scene.camera_path(config["motion"], n, config["camera_hz"])
    poses = torch.as_tensor(gt, dtype=torch.float64, device=device)
    H, W = config["rig"]["height"], config["rig"]["width"]
    lefts = np.empty((n, H, W), np.uint8)
    rights = np.empty((n, H, W), np.uint8)
    for a in range(0, n, RENDER_BATCH):
        b = min(n, a + RENDER_BATCH)
        for out, right in ((lefts, False), (rights, True)):
            out[a:b] = scene.render_views(planes, config["rig"], poses[a:b],
                                          right=right).cpu().numpy()
    return Frames(lefts, rights, gt, None, float(config["camera_hz"]))


def replay(n: int, kind: str):
    """Endless frame indices over n unique pairs."""
    if kind != "pingpong":
        raise ValueError(f"unknown replay {kind!r}")
    if n < 2:
        raise ValueError("pingpong needs two pairs or more")
    k = 0
    while True:
        yield k % (2 * n - 2) if k % (2 * n - 2) < n else \
            2 * n - 2 - k % (2 * n - 2)
        k += 1


def order(n: int, kind: str, count: int) -> list[int]:
    it = replay(n, kind)
    return [next(it) for _ in range(count)]


def _calib_text(rig: dict) -> str:
    fx, fy, cx, cy, b = (rig[k] for k in ("fx", "fy", "cx", "cy",
                                          "baseline"))
    p0 = [fx, 0, cx, 0, 0, fy, cy, 0, 0, 0, 1, 0]
    p1 = [fx, 0, cx, -fx * b, 0, fy, cy, 0, 0, 0, 1, 0]
    return "".join(f"{k}: " + " ".join(f"{v:.12e}" for v in p) + "\n"
                   for k, p in (("P0", p0), ("P1", p1)))


def png_key(config: dict, traffic: dict, seed: int) -> str:
    what = json.dumps([config, traffic.get("unique_pairs"),
                       pngenc.ZLIB_LEVEL, pngenc.IDAT_BYTES],
                      sort_keys=True)
    return (f"{config['name']}-{seed_of(seed)}-"
            f"{hashlib.sha1(what.encode()).hexdigest()[:10]}")


def write_png(frames: Frames, config: dict, traffic: dict, seed: int,
              cache: Path = CACHE) -> Path:
    """The frames as a KITTI odometry layout (`sequences/00/image_0`,
    `image_1`, `calib.txt`) under `cache/png/<key>`, written once a key
    and read again by later runs of the same seed; the directory keeps
    the `PNG_KEEP` keys used last (the mtime of each key's `done`)."""
    base = cache / "png"
    root = base / png_key(config, traffic, seed)
    done = root / "done"
    if done.exists():
        done.touch()
        return root
    if root.exists():           # a run that stopped while writing
        shutil.rmtree(root)
    seq = root / "sequences" / "00"
    for side in ("image_0", "image_1"):
        (seq / side).mkdir(parents=True)
    (seq / "calib.txt").write_text(_calib_text(config["rig"]))

    def one(job):       # on the disk before the window, not during it
        side, i, img = job
        with open(seq / side / f"{i:06d}.png", "wb") as f:
            f.write(pngenc.encode(img))
            f.flush()
            os.fsync(f.fileno())

    jobs = [(side, i, imgs[i])
            for i in range(len(frames.lefts))
            for side, imgs in (("image_0", frames.lefts),
                               ("image_1", frames.rights))]
    with ThreadPoolExecutor(ENCODE_THREADS) as ex:
        for _ in ex.map(one, jobs):
            pass
    done.write_text("")
    _evict(base, PNG_KEEP)
    return root


def _evict(base: Path, keep: int):
    """Remove all but the `keep` key directories used last, and any left
    unfinished."""
    dirs = list(base.iterdir())
    keys = sorted((d for d in dirs if (d / "done").exists()),
                  key=lambda d: (d / "done").stat().st_mtime, reverse=True)
    for old in keys[keep:] + [d for d in dirs if d not in keys]:
        shutil.rmtree(old)


def attach_source(frames: Frames, config: dict, traffic: dict, seed: int):
    """Make the traffic's source of the rendered frames (the png files)."""
    if traffic["source"] == "png":
        frames.png_root = write_png(frames, config, traffic, seed)
    elif traffic["source"] != "mem":
        raise ValueError(f"unknown frame source {traffic['source']!r}")


def prepare(config: dict, traffic: dict, seed: int, device) -> Frames:
    frames = render(config, traffic["unique_pairs"], seed, device)
    attach_source(frames, config, traffic, seed)
    return frames


def rate_of(frames: Frames, traffic: dict) -> float:
    """An open loop's frames a second: the mix's `rate`, a number or
    `camera_hz` (the configuration's camera rate)."""
    rate = traffic["rate"]
    rate = frames.hz if rate == "camera_hz" else float(rate)
    if not rate > 0:
        raise ValueError(f"an open loop needs a rate above 0, not {rate!r}")
    return rate


class Clock:
    """The host's clock, on which an open loop's frames fall due (tests
    give a fake one)."""

    @staticmethod
    def now() -> float:
        return time.perf_counter()

    @staticmethod
    def sleep_until(t: float, stop: threading.Event):
        """Until now() >= t, or until `stop` is set."""
        while not stop.is_set():
            left = t - time.perf_counter()
            if left <= 0:
                return
            if left > SPIN_S:
                stop.wait(left - SPIN_S)
            else:
                time.sleep(0)       # lets the interpreter lock go


class Source:
    """The frames a loop requests, in replay order, as the source delivers
    them: host arrays (`mem`) or files read by the port's KITTI loader
    (`png`).  In a closed loop a frame is handed over when it is asked
    for.  In an open loop nothing is handed over before `start(t0)`, and
    frame k not before its due time `due(k) = t0 + (k - first) / rate`; a
    frame asked for late is handed over at once and never dropped, and
    `lags` keeps each hand-off's seconds after its due time.  The source
    begins at frame `first` of the replay.  `stop()` ends the iteration
    after the frame in hand."""

    def __init__(self, frames: Frames, traffic: dict, clock=None,
                 first: int = 0):
        if traffic["loop"] not in ("closed", "open"):
            raise ValueError(f"unknown loop {traffic['loop']!r}")
        self._frames = frames
        self._kind = traffic["replay"]
        self.rate = (rate_of(frames, traffic) if traffic["loop"] == "open"
                     else None)
        self.clock = clock or Clock()
        self.first = first
        self.lags = []
        self._t0 = None
        self._stop = threading.Event()
        self._go = threading.Event()        # started or stopped
        self._seq = None
        if frames.png_root is not None:
            from front_end_tpu_torch.io import kitti
            self._seq = kitti.KittiSequence(str(frames.png_root), "00")

    def start(self, t0: float):
        self._t0 = t0
        self._go.set()

    def due(self, k: int) -> float:
        return self._t0 + (k - self.first) / self.rate

    def due_by(self, t: float) -> int:
        """How many frames, from frame 0, are due at time t."""
        return self.first + math.floor((t - self._t0) * self.rate) + 1

    def stop(self):
        self._stop.set()
        self._go.set()

    def __iter__(self):
        n = len(self._frames.lefts)
        for k, i in itertools.islice(enumerate(replay(n, self._kind)),
                                     self.first, None):
            if self.rate is not None:
                self._go.wait()
                if not self._stop.is_set():
                    self.clock.sleep_until(self.due(k), self._stop)
            if self._stop.is_set():
                return
            if self.rate is not None:
                self.lags.append(self.clock.now() - self.due(k))
            if self._seq is not None:
                yield self._seq[i]
            else:
                yield self._frames.lefts[i], self._frames.rights[i]
