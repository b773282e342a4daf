"""On the card: the control (the reference with its products in TF32, in
the program's place) comes out not correct, at half the cells' size."""
from __future__ import annotations

import pytest

from vobench import check, frames, run, spec

from conftest import shrink


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["kitti00-vo-brief.replay-mem",
                                  "euroc-mh01-window-surfext.replay-mem"])
def test_control_is_not_correct(name, cuda_card):
    cell = shrink(spec.load_cell(name), scale=0.5, pairs=40)
    cell.config["vo"]["grid"].update(cell_capacity=192, set_point=1000)
    fr = frames.prepare(cell.config, cell.traffic, 31, cuda_card)
    ref = run.reference_run(fr, cell.traffic, 31, cell.config, cuda_card,
                            40)
    ctrl = check.control(lambda: run.reference_run(
        fr, cell.traffic, 31, cell.config, cuda_card, 40))
    ok, table = check.judge(check.gaps(ctrl[0], ctrl[1], *ref),
                            cell.config["check"])
    assert not ok, table
