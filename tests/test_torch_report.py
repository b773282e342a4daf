"""`analysis/report.py`, `analysis/explore.py` and `viz/svg.py` against the
JAX package's report and explorer.

The port writes SVG where the JAX package draws with matplotlib, so the
figures' data are compared, not their pixels: the series the JAX package
hands `Axes.plot` / `Axes.barh` (caught by wrapping them) against the
series each SVG carries in its `data-*` attributes.  Counts and tables
are compared exactly; descriptor times differ by nature and are only
checked positive.
"""
import os
import xml.etree.ElementTree as ET

import matplotlib
import numpy as np
import pytest

from front_end_tpu.analysis import explore as jexplore
from front_end_tpu.analysis import report as jreport
from front_end_tpu.analysis import sweeps as jsweeps
from front_end_tpu_torch import cli
from front_end_tpu_torch.analysis import explore as texplore
from front_end_tpu_torch.analysis import report as treport
from front_end_tpu_torch.analysis import sweeps as tsweeps
from front_end_tpu_torch.pipeline.telemetry import (ProcTime, TelemetryLog,
                                                    save_log)
from front_end_tpu_torch.viz import svg
from test_report import _frames
from torch_parity import pan_poses, write_kitti

matplotlib.use("Agg")


def svg_series(path) -> dict:
    """{label: (xs, ys)} of the polylines of an SVG figure, and
    {"bars": (labels, values)} for its bar group."""
    out = {}
    for el in ET.parse(path).iter():
        if el.get("data-x") is not None:
            out[el.get("data-label") or None] = (
                [float(v) for v in el.get("data-x").split()],
                [float(v) for v in el.get("data-y").split()])
        if el.get("data-values") is not None:
            out["bars"] = (el.get("data-labels").split("|"),
                           [float(v) for v in el.get("data-values").split()])
    return out


@pytest.fixture
def mpl_series(monkeypatch):
    """The series the JAX package's figures hand matplotlib, per figure
    file name (the figure is keyed when it is saved)."""
    from matplotlib.axes import Axes
    from matplotlib.figure import Figure
    pending, saved = [], {}
    plot, barh, savefig = Axes.plot, Axes.barh, Figure.savefig

    def spy_plot(self, *args, **kw):
        xs, ys = args[:2] if len(args) > 1 else (range(len(args[0])),
                                                 args[0])
        pending.append((kw.get("label"), ([float(v) for v in xs],
                                          [float(v) for v in ys])))
        return plot(self, *args, **kw)

    def spy_barh(self, y, width, *args, **kw):
        pending.append(("bars", [float(v) for v in width]))
        return barh(self, y, width, *args, **kw)

    def spy_save(self, path, *args, **kw):
        saved[os.path.basename(str(path))] = dict(pending)
        pending.clear()
        return savefig(self, path, *args, **kw)

    monkeypatch.setattr(Axes, "plot", spy_plot)
    monkeypatch.setattr(Axes, "barh", spy_barh)
    monkeypatch.setattr(Figure, "savefig", spy_save)
    return saved


def _same_series(port_svg, jax_series):
    got = svg_series(port_svg)
    lines = {k: v for k, v in got.items() if k != "bars"}
    want = {k: v for k, v in jax_series.items() if k != "bars"}
    assert lines.keys() == want.keys(), (lines.keys(), want.keys())
    for k in want:
        np.testing.assert_allclose(lines[k][0], want[k][0], rtol=1e-6)
        np.testing.assert_allclose(lines[k][1], want[k][1], rtol=1e-6)
    if "bars" in jax_series:
        np.testing.assert_allclose(got["bars"][1], jax_series["bars"],
                                   rtol=1e-6)


def test_nice_ticks_cover_the_range():
    assert svg.nice_ticks(0.0, 1.0) == pytest.approx([0.0, 0.2, 0.4, 0.6,
                                                      0.8, 1.0])
    t = svg.nice_ticks(-3.2, 117.0)
    assert t[0] >= -3.2 and t[-1] <= 117.0 and len(t) >= 3
    assert all(np.isclose(b - a, t[1] - t[0]) for a, b in zip(t, t[1:]))


def test_svg_figure_parses_and_carries_its_data(tmp_path):
    fig = svg.Figure(4.0, 3.0, ncols=2, sharey=True)
    fig.axes[0].plot([0, 1, 2], [1.5, 2.5, 0.5], color="#000", marker=True,
                     label="a & <b>")
    fig.axes[0].axhline(2.0, color="#888")
    fig.axes[0].annotate("end", (2, 0.5), dx=5)
    fig.axes[1].plot([0, 1], [3.0, 4.0], color="#123", label="c")
    fig.axes[1].set(title="T", xlabel="x", ylabel="y")
    fig.axes[1].legend()
    fig.suptitle = "S"
    path = fig.save(str(tmp_path / "f.svg"))
    root = ET.parse(path).getroot()
    assert root.tag.endswith("svg")
    assert svg_series(path) == {"a & <b>": ([0.0, 1.0, 2.0],
                                            [1.5, 2.5, 0.5]),
                                "c": ([0.0, 1.0], [3.0, 4.0])}
    bars = svg.Figure(3.0, 2.0)
    bars.axes[0].barh(["x", "y"], [1.0, 2.5], color="#000")
    assert svg_series(bars.save(str(tmp_path / "b.svg")))["bars"] == (
        ["x", "y"], [1.0, 2.5])


def _fake_study():
    rs = np.random.RandomState(0)
    conds = {}
    for curve in (100, 500):
        for noise in (0.25, 1.0):
            for frac in (0.0, 0.1):
                conds[(curve, noise, frac)] = {
                    "rot_err_deg": rs.uniform(0.01, 1.0, 16),
                    "trans_err_m": rs.uniform(1e-4, 0.01, 16)}
    return {"PCL": {"medium": conds}, "BA": {"medium": dict(conds)}}


@pytest.mark.parametrize("stat", ["rot_err_deg", "trans_err_m"])
def test_study_figures_carry_jax_series(stat, tmp_path, mpl_series):
    study = _fake_study()
    jfigs = (jreport.plot_method_comparison(study, str(tmp_path), stat=stat)
             + jreport.plot_operating_curves(study, str(tmp_path), stat=stat))
    tfigs = (treport.plot_method_comparison(study, str(tmp_path), stat=stat)
             + treport.plot_operating_curves(study, str(tmp_path), stat=stat))
    assert [os.path.basename(p)[:-4] for p in tfigs] == \
        [os.path.basename(p)[:-4] for p in jfigs]
    for tp, jp in zip(tfigs, jfigs):
        _same_series(tp, mpl_series[os.path.basename(jp)])


@pytest.fixture(scope="module")
def frames():
    return _frames()


def test_detection_figures_carry_jax_series(frames, tmp_path, mpl_series):
    lefts, rights = frames
    jp = jreport.plot_detection_sweep(lefts[0], rights[0], str(tmp_path))
    tp = treport.plot_detection_sweep(lefts[0], rights[0], str(tmp_path),
                                      device="cpu")
    _same_series(tp, mpl_series[os.path.basename(jp)])
    jp = jreport.plot_setpoint_tracking(lefts, str(tmp_path))
    tp = treport.plot_setpoint_tracking(lefts, str(tmp_path), device="cpu")
    _same_series(tp, mpl_series[os.path.basename(jp)])


def test_descriptor_timing_table_has_jax_configs(frames):
    lefts, rights = _frames(n=1, h=128, w=160)
    rows = treport.descriptor_timing_table(lefts[0], rights[0], repeats=1,
                                           device="cpu")
    ref = jreport.descriptor_timing_table(lefts[0], rights[0], repeats=1)
    assert [(r["config"], r["dims"]) for r in rows] == \
        [(r["config"], r["dims"]) for r in ref]
    assert [r["config"] for r in rows] == [c for c, _ in
                                           jreport.DESC_CONFIGS]
    for got, want in zip(rows, ref):
        assert got["ms"] > 0
        assert got["matches"] == want["matches"], (got, want)


@pytest.fixture(scope="module")
def recording(tmp_path_factory):
    """A `cli vo --record` file of the port's command line."""
    from front_end_tpu_torch.sim.sequence import make_sequence
    root = str(tmp_path_factory.mktemp("kitti"))
    L, R = make_sequence(4, 96, 160)
    write_kitti(root, L, R, fx=200.0, baseline=0.3, poses=pan_poses(4, 0.3))
    rec = os.path.join(root, "run")
    cli.main(["vo", "--kitti", root, "--device", "cpu", "--window",
              "--record", rec])
    return root, rec + ".npz"


def test_recorded_run_figures_carry_jax_series(recording, tmp_path,
                                               mpl_series):
    recording = recording[1]
    jfigs = jreport.plot_recorded_run(recording, str(tmp_path))
    tfigs = treport.plot_recorded_run(recording, str(tmp_path))
    assert [os.path.basename(p)[:-4] for p in tfigs] == \
        [os.path.basename(p)[:-4] for p in jfigs]
    assert len(tfigs) == 3          # frame time, counts, ba_rms_px
    for tp, jp in zip(tfigs, jfigs):
        _same_series(tp, mpl_series[os.path.basename(jp)])


def test_platform_comparison_carries_jax_series(tmp_path, mpl_series):
    recs = []
    for name, plat, dt in (("a", "card", 0.003), ("b", "cpu-host", 0.05)):
        log = TelemetryLog()
        for i in range(12):
            log.add_frame([ProcTime("frame", dt * (1 + 0.1 * (i % 3)))])
            log.count("n_stereo", 400)
        recs.append(str(tmp_path / f"{name}.npz"))
        save_log(recs[-1], log, meta={"platform": plat})
    jfigs = jreport.plot_recorded_comparison(recs, str(tmp_path))
    tfigs = treport.plot_recorded_comparison(recs, str(tmp_path))
    for tp, jp in zip(tfigs, jfigs):
        _same_series(tp, mpl_series[os.path.basename(jp)])
    assert svg_series(tfigs[1])["bars"][0] == ["card", "cpu-host"]


def test_generate_report_end_to_end(tmp_path, frames, recording):
    study = str(tmp_path / "study")
    tsweeps.run_study(study, methods=("PCL", "BA"), speeds=("medium",),
                      curves=(100,), noises=(0.0, 1.0), outliers=(0.0,),
                      batch=4, verbose=False, device="cpu")
    out = tmp_path / "rep"
    path = treport.generate_report(study, str(out), frames=frames,
                                   records=[recording[1][:-4]],
                                   device="cpu")
    txt = open(path).read()
    for section in ("## Estimator operating curves", "## Recorded run",
                    "## Detection", "## Descriptor timing"):
        assert section in txt
    table = treport._study_table(tsweeps.load_study(study))
    assert "\n".join(table) in txt
    assert "\n".join(table) == "\n".join(
        jreport._study_table(jsweeps.load_study(study)))
    figs = [ln[ln.index("(") + 1:ln.index(")")]
            for ln in txt.splitlines() if ln.startswith("![")]
    assert len(figs) == 4 + 2 + 3 + 2 + 2     # study, detect, rec, timing
    for f in figs:
        assert f.endswith(".svg")
        ET.parse(out / f)
    rows = [ln for ln in txt.splitlines() if ln.startswith("| BRIEF_16 |")]
    assert len(rows) == 1 and rows[0].split("|")[2].strip() == "128"


def test_cli_report_writes_the_report(recording, tmp_path, capsys):
    root, rec = recording
    cli.main(["report", "--kitti", root, "--frames", "2", "--record", rec,
              "--out", str(tmp_path), "--no-timings", "--device", "cpu"])
    assert "report ->" in capsys.readouterr().out
    txt = (tmp_path / "REPORT.md").read_text()
    assert "## Recorded run: `run.npz`" in txt
    for name in ("detect_sweep.svg", "setpoint_tracking.svg",
                 "recorded_run_frame_time.svg"):
        assert name in txt and (tmp_path / name).exists()
    counts = svg_series(tmp_path / "setpoint_tracking.svg")
    assert all(len(xs) == 2 for xs, _ in counts.values())


def _index_rows(path):
    return [ln.split("|")[1:5] for ln in open(path).read().splitlines()
            if ln.startswith("| ") and ln.split("|")[1].strip().isdigit()]


def test_explore_ranking_equals_jax(tmp_path, monkeypatch):
    """FAST over two frames: the ranking, parameters and mean counts of
    every row of INDEX.md equal the JAX package's."""
    lefts, _ = _frames(n=2)
    two = [np.asarray(f) for f in lefts]
    monkeypatch.setattr(jexplore, "_frames", lambda image, n: two)
    monkeypatch.setattr(texplore, "_frames", lambda image, n: two)
    jidx = jexplore.explore_features(family="FAST", out=str(tmp_path / "j"),
                                     n_frames=2, top=4)
    tidx = texplore.explore_features(family="FAST", out=str(tmp_path / "t"),
                                     n_frames=2, top=4, device="cpu")
    got, want = _index_rows(tidx), _index_rows(jidx)
    assert len(got) == len(want) == 354
    assert got == want
    txt = open(tidx).read()
    assert "![summary](summary_FAST.svg)" in txt
    for ln in txt.splitlines():
        if ln.startswith("!["):
            f = ln[ln.index("(") + 1:ln.index(")")]
            assert (tmp_path / "t" / f).exists(), f
    ET.parse(tmp_path / "t" / "summary_FAST.svg")
    pngs = sorted(f for f in os.listdir(tmp_path / "t")
                  if f.endswith(".png"))
    assert pngs == sorted(f for f in os.listdir(tmp_path / "j")
                          if f.endswith(".png") and f != "summary_FAST.png")
    assert len(pngs) == 4
