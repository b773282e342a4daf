"""The torch renderer against the frozen numpy ray caster."""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from vobench import scene
from render_np import render_view

RIG = {"fx": 180.0, "fy": 181.5, "cx": 80.3, "cy": 47.6, "baseline": 0.3,
       "width": 160, "height": 96}


def _np_rig():
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    return SimpleNamespace(**{k: f32(v) if k not in ("width", "height")
                              else v for k, v in RIG.items()})


def test_torch_render_equals_numpy():
    gen = torch.Generator().manual_seed(4)
    spec = {"x_left_m": -3.0, "x_right_m": 4.0, "y_top_m": -4.0,
            "y_floor_m": 1.5, "z_near_m": -2.0, "z_far_m": 30.0,
            "ceiling": True, "near_wall": True, "texel_m": 0.08}
    planes = scene.box_scene(spec, gen)
    motion = {"speed_m_s": 6.0, "sway_x_m": 0.4, "sway_y_m": 0.1,
              "sway_period_s": 5.0, "yaw_deg": 25.0, "yaw_period_s": 3.0,
              "pitch_deg": 6.0, "pitch_period_s": 2.0, "roll_deg": 4.0,
              "roll_period_s": 2.5}
    poses = scene.camera_path(motion, 6, 10.0)
    np_planes = [SimpleNamespace(p0=np.array(p.p0), u=np.array(p.u),
                                 v=np.array(p.v), extent=p.extent,
                                 tex=p.tex.numpy(), scale=p.scale)
                 for p in planes]
    for right in (False, True):
        got = scene.render_views(planes, RIG, torch.as_tensor(poses),
                                 right=right).numpy()
        for k, T in enumerate(poses):
            want = render_view(np_planes, _np_rig(), T, right=right)
            diff = np.abs(got[k].astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1, (right, k)       # a rounding tie at most
            assert (diff == 0).mean() > 0.999, (right, k)


def test_texture_is_even_and_seeded():
    a = scene.make_texture(torch.Generator().manual_seed(1), 200, 900)
    b = scene.make_texture(torch.Generator().manual_seed(1), 200, 900)
    c = scene.make_texture(torch.Generator().manual_seed(2), 200, 900)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.min() >= 0 and a.max() <= 255 and torch.equal(a, a.round())
    # blobs cover the texture evenly along its length (the last 24 texels
    # of each side have fewer blobs, as in the port's `make_texture`)
    t = scene.make_texture(torch.Generator().manual_seed(5), 400, 4048)
    inner = t[:, 24:4024]
    cover = (inner - 128).abs().gt(8).float().reshape(400, 8, 500).mean(
        (0, 2))
    assert cover.min() > 0.9 * cover.max()


def test_replay_is_forward_then_backward():
    from vobench import frames
    assert frames.order(4, "pingpong", 11) == [0, 1, 2, 3, 2, 1, 0, 1, 2,
                                               3, 2]
