"""The port's rig and `VOConfig` from a configuration file's `rig` and
`vo` groups (the port entries' shared part)."""
from front_end_tpu_torch.geometry.camera import StereoRig
from front_end_tpu_torch.ops import grid
from front_end_tpu_torch.pipeline import vo


def make_rig(rig: dict) -> StereoRig:
    return StereoRig.create(fx=rig["fx"], fy=rig["fy"], cx=rig["cx"],
                            cy=rig["cy"], baseline=rig["baseline"],
                            width=rig["width"], height=rig["height"])


def vo_config(group: dict) -> vo.VOConfig:
    kw = dict(group)
    return vo.VOConfig(grid=grid.GridConfig(**kw.pop("grid")), **kw)
