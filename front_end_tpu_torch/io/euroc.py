"""EuRoC MAV loader, ASL folder layout, stereo grayscale (counterpart of
`front_end_tpu/io/euroc.py`).

    <root>/<seq>/mav0/cam0/data/*.png   (left)
    <root>/<seq>/mav0/cam1/data/*.png   (right)
    <root>/<seq>/mav0/cam0/sensor.yaml  (intrinsics, radtan distortion,
                                         T_BS extrinsics)
    <root>/<seq>/mav0/state_groundtruth_estimate0/data.csv

EuRoC's cameras are raw (radial-tangential distortion, not coplanar).
With `rectify=True` (the default) the loader builds a `StereoRectifier`
from both cameras' sensor.yaml once, and every pair is undistorted and
row-aligned on `device` (the card unless the caller asks for the CPU):
frames come out as float32 tensors there.  Without it they are the files'
uint8 arrays.  sensor.yaml is read by a parser of its own for the four
fields used (flow lists, as EuRoC writes them), so no YAML package is
needed.
"""
from __future__ import annotations

import csv
import os
import re

import numpy as np

from front_end_tpu_torch.geometry.camera import StereoRig
from front_end_tpu_torch.io.kitti import _read_image

# nominal cam0 values (used where sensor.yaml is absent)
_NOMINAL = dict(intrinsics=(458.654, 457.296, 367.215, 248.375),
                resolution=(752, 480),
                distortion=(-0.28340811, 0.07395907, 0.00019359,
                            1.76187114e-05))


def _flow_list(text: str, key: str, after: int = 0):
    """The numbers of `key: [a, b, ...]` at or after offset `after` (the
    list may span lines), and where the match ends; None if absent."""
    m = re.compile(rf"^\s*{key}\s*:\s*\[([^\]]*)\]", re.M).search(text, after)
    if m is None:
        return None, after
    return [float(v) for v in m.group(1).replace("\n", " ").split(",")
            if v.strip()], m.end()


def read_sensor_yaml(path: str) -> dict:
    """One camera's sensor.yaml -> {K (3,3), D (4,), T_BS (4,4), size (W,
    H)}; the nominal cam0 values where the file is missing."""
    cal = dict(_NOMINAL)
    T = np.eye(4)
    if os.path.exists(path):
        with open(path) as f:
            text = re.sub(r"#[^\n]*", "", f.read())
        for key, name in (("intrinsics", "intrinsics"),
                          ("resolution", "resolution"),
                          ("distortion_coefficients", "distortion")):
            vals, _ = _flow_list(text, key)
            if vals is None:
                raise ValueError(f"{path}: no `{key}: [...]` list")
            cal[name] = tuple(vals)
        cal["resolution"] = tuple(int(v) for v in cal["resolution"])
        m = re.search(r"^T_BS\s*:", text, re.M)
        if m:
            data, _ = _flow_list(text, "(?:T_BS|data)", m.start())
            if data is None or len(data) != 16:
                raise ValueError(f"{path}: T_BS is not 16 numbers")
            T = np.asarray(data, np.float64).reshape(4, 4)
    fx, fy, cx, cy = cal["intrinsics"]
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    return {"K": K, "D": np.asarray(cal["distortion"]), "T_BS": T,
            "size": tuple(cal["resolution"])}


def load_rig(seq_dir: str) -> StereoRig:
    """Nominal (unrectified) EuRoC rig from cam0's intrinsics, for callers
    that skip rectification."""
    cal = read_sensor_yaml(
        os.path.join(seq_dir, "mav0", "cam0", "sensor.yaml"))
    w, h = cal["size"]
    return StereoRig.create(fx=float(cal["K"][0, 0]),
                            fy=float(cal["K"][1, 1]),
                            cx=float(cal["K"][0, 2]),
                            cy=float(cal["K"][1, 2]),
                            baseline=0.11, width=w, height=h)


def build_rectifier(seq_dir: str, device="cuda"):
    """StereoRectifier from cam0 + cam1 sensor.yaml (T_cam1_cam0 from the
    body-frame extrinsics)."""
    from front_end_tpu_torch.io.rectify import StereoRectifier

    c0 = read_sensor_yaml(os.path.join(seq_dir, "mav0", "cam0",
                                       "sensor.yaml"))
    c1 = read_sensor_yaml(os.path.join(seq_dir, "mav0", "cam1",
                                       "sensor.yaml"))
    if np.allclose(c1["T_BS"], np.eye(4)):
        # missing cam1 extrinsics: nominal 11 cm x-baseline
        T01 = np.eye(4)
        T01[0, 3] = -0.11
    else:
        T01 = np.linalg.inv(c1["T_BS"]) @ c0["T_BS"]   # cam0 -> cam1
    return StereoRectifier(c0["K"], c0["D"], c1["K"], c1["D"],
                           T01[:3, :3], T01[:3, 3], c0["size"],
                           device=device)


class EurocSequence:
    def __init__(self, root: str, seq: str = "MH_01_easy",
                 max_frames: int | None = None, rectify: bool = True,
                 device="cuda"):
        self.seq_dir = os.path.join(root, seq)
        cam0 = os.path.join(self.seq_dir, "mav0", "cam0", "data")
        cam1 = os.path.join(self.seq_dir, "mav0", "cam1", "data")
        if not os.path.isdir(cam0):
            raise FileNotFoundError(f"EuRoC sequence not found at {cam0}")
        self.rectifier = (build_rectifier(self.seq_dir, device) if rectify
                          else None)
        self.rig = (self.rectifier.rig() if self.rectifier
                    else load_rig(self.seq_dir))
        self.names = sorted(set(os.listdir(cam0)) & set(os.listdir(cam1)))
        if max_frames:
            self.names = self.names[:max_frames]
        self._cam0, self._cam1 = cam0, cam1

    def __len__(self):
        return len(self.names)

    def __getitem__(self, i):
        l = _read_image(os.path.join(self._cam0, self.names[i]))
        r = _read_image(os.path.join(self._cam1, self.names[i]))
        if self.rectifier is not None:
            l, r = self.rectifier(l, r)
        return l, r

    def frames(self):
        for i in range(len(self)):
            yield self[i]

    def ground_truth(self):
        """(timestamps (T,) int, positions (T, 3))."""
        path = os.path.join(self.seq_dir, "mav0",
                            "state_groundtruth_estimate0", "data.csv")
        ts, pos = [], []
        with open(path) as f:
            for row in csv.reader(f):
                if row[0].startswith("#"):
                    continue
                ts.append(int(row[0]))
                pos.append([float(row[1]), float(row[2]), float(row[3])])
        return np.asarray(ts), np.asarray(pos)
