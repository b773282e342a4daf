"""The plain reference's rig and `VOConfig` from a configuration file's
`rig` and `vo` groups (the reference entries' shared part)."""
from vobench.reference import camera, grid, vo


def make_rig(rig: dict) -> camera.StereoRig:
    return camera.StereoRig.create(
        fx=rig["fx"], fy=rig["fy"], cx=rig["cx"], cy=rig["cy"],
        baseline=rig["baseline"], width=rig["width"], height=rig["height"])


def vo_config(group: dict) -> vo.VOConfig:
    kw = dict(group)
    return vo.VOConfig(grid=grid.GridConfig(**kw.pop("grid")), **kw)
