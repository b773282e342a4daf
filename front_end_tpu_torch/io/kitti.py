"""KITTI odometry loader, grayscale stereo (counterpart of
`front_end_tpu/io/kitti.py`).

    <root>/sequences/<seq>/image_0/*.png   (left, grayscale)
    <root>/sequences/<seq>/image_1/*.png   (right)
    <root>/sequences/<seq>/calib.txt       (P0/P1 3x4)
    <root>/poses/<seq>.txt                 (ground truth, 3x4 rows)

Frames come out as (H, W) uint8 arrays, the bytes of the files: shipped
to the card as they are (4x fewer bytes than float32), `vo_step` casts
them there.  Images decode with PIL where it is installed, else PGM or
the port's own PNG decoder (`utils/png.py`), so the loader runs where
PIL is not.  Importing needs no dataset; opening a missing sequence
raises FileNotFoundError.
"""
from __future__ import annotations

import os

import numpy as np

from front_end_tpu_torch.geometry.camera import StereoRig
from front_end_tpu_torch.pipeline import telemetry
from front_end_tpu_torch.utils import png


def _read_pgm(f) -> np.ndarray:
    dims = f.readline().split()
    while dims and dims[0].startswith(b"#"):
        dims = f.readline().split()
    w, h = int(dims[0]), int(dims[1])
    f.readline()
    return np.frombuffer(f.read(w * h), np.uint8).reshape(h, w).copy()


def _read_image(path) -> np.ndarray:
    """(H, W) uint8 gray: PIL's `convert("L")` where PIL is installed, else
    a binary PGM or an 8-bit PNG decoded to the same values.  Span
    `io.decode`."""
    with telemetry.span("io.decode"):
        return _decode(path)


def _decode(path) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError:
        pass
    else:
        with Image.open(path) as im:
            return np.array(im.convert("L"), np.uint8)
    with open(path, "rb") as f:
        head = f.read(8)
        if head == png.SIGNATURE:
            return png.decode(head + f.read())
        f.seek(0)
        if f.readline().strip() != b"P5":
            raise RuntimeError(f"cannot decode {path} without PIL: it is "
                               "neither an 8-bit PNG nor a binary PGM")
        return _read_pgm(f)


def load_calib(seq_dir: str) -> StereoRig:
    P = {}
    with open(os.path.join(seq_dir, "calib.txt")) as f:
        for line in f:
            k, *vals = line.split()
            P[k.rstrip(":")] = np.array(vals, np.float64).reshape(3, 4)
    P0, P1 = P["P0"], P["P1"]
    img_dir = os.path.join(seq_dir, "image_0")
    first = sorted(os.listdir(img_dir))[0]
    h, w = _read_image(os.path.join(img_dir, first)).shape
    return StereoRig.create(fx=P0[0, 0], fy=P0[1, 1], cx=P0[0, 2],
                            cy=P0[1, 2], baseline=-P1[0, 3] / P1[0, 0],
                            width=w, height=h)


def load_poses(root: str, seq: str) -> np.ndarray:
    """(T, 4, 4) ground-truth world_T_camera poses."""
    rows = np.loadtxt(os.path.join(root, "poses", f"{seq}.txt")).reshape(
        -1, 3, 4)
    T = np.tile(np.eye(4), (rows.shape[0], 1, 1))
    T[:, :3, :] = rows
    return T


class KittiSequence:
    def __init__(self, root: str, seq: str = "00",
                 max_frames: int | None = None):
        self.seq_dir = os.path.join(root, "sequences", seq)
        if not os.path.isdir(self.seq_dir):
            raise FileNotFoundError(
                f"KITTI sequence not found at {self.seq_dir}")
        self.rig = load_calib(self.seq_dir)
        self.left_dir = os.path.join(self.seq_dir, "image_0")
        self.right_dir = os.path.join(self.seq_dir, "image_1")
        self.names = sorted(os.listdir(self.left_dir))
        if max_frames:
            self.names = self.names[:max_frames]
        try:
            self.poses = load_poses(root, seq)[:len(self.names)]
        except OSError:
            self.poses = None

    def __len__(self):
        return len(self.names)

    def paths(self):
        """(left paths, right paths), e.g. for `NativeStereoFeed`."""
        return ([os.path.join(self.left_dir, n) for n in self.names],
                [os.path.join(self.right_dir, n) for n in self.names])

    def __getitem__(self, i):
        return (_read_image(os.path.join(self.left_dir, self.names[i])),
                _read_image(os.path.join(self.right_dir, self.names[i])))

    def frames(self):
        for i in range(len(self)):
            yield self[i]
