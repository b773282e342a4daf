"""`python -m vobench.spans` on the CPU, at a tiny size: the port's spans
and counters come back for each phase, and the recording is closed."""
from __future__ import annotations

import json

import pytest

from vobench import spans


@pytest.mark.parametrize("name", ["kitti00-vo-brief.replay-mem",
                                  "euroc-mh01-window-surfext.replay-mem"])
def test_probe_on_the_cpu(tiny, monkeypatch, name):
    from front_end_tpu_torch.pipeline import telemetry
    monkeypatch.setattr(spans, "SPAN_FRAMES", 3)
    monkeypatch.setattr(spans, "MICRO_CALLS", 10)
    res = spans.probe(tiny(name), 3_000_000_007, "cpu")
    assert telemetry._active is None
    # the recording changes no frame's outcome (at this size kitti's
    # frames lose track: motion_ok is false from frame 1 on)
    assert len({p["failed"] for p in res["phases"]}) == 1
    assert "profiled" not in res            # no card, no device events
    assert [p["recording"] for p in res["phases"]] == list(spans.PHASES)
    root = "window.step" if "window" in name else "vo.step"
    for p in res["phases"]:
        assert p["frames"] == 3
        if p["recording"] == "on":
            assert p["host_ms"][root] >= p["host_ms"]["vo.lm"] > 0
            assert 0 <= p["counters"]["lm.accepted_pct"] <= 100
            assert p["counters"]["lm.accepted_n"] == 2 * 6
        else:
            assert "host_ms" not in p
    assert res["frame_ms_off"] > 0 and res["frame_ms_on"] > 0
    json.dumps(res)
    assert res["cell"] in spans.table(res)
