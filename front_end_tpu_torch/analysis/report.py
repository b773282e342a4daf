"""Study and run reports: the `bin/result_*` figures (counterpart of
`front_end_tpu/analysis/report.py`).

Renders the recorded artifacts into figures and one markdown report:
- operating curves (rotation / translation error against noise × outliers
  × landmark curve) over an `analysis.sweeps` study directory;
- detections against the FAST threshold with the reference's set-point
  lines, and the adaptive grid's set-point tracking over a sequence;
- description + matching time and stereo match counts per benchmarked
  descriptor configuration;
- recorded runs (`cli vo --record`), alone and compared by platform.

The figures' data are the JAX package's; the figures are SVG, written by
`viz/svg.py` (the card's machine has no matplotlib), in the same visual
system: a fixed categorical slot per method or family, a single-hue ramp
for magnitude, one axis per chart, recessive grids, direct labels where
series are few.  The live figures run the port's kernels: the grid FAST
kernel for detection and set-point tracking; the grid, keypoint BRIEF and
match kernels (4, 8 and 16 words) for the descriptor table.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from front_end_tpu_torch.utils.precision import resolve_device
from front_end_tpu_torch.viz import svg

# fixed categorical slot order: an entity keeps its hue in every figure
CAT = ("#2a78d6", "#eb6834", "#1baf7a", "#eda100", "#e87ba4", "#008300")
# single-hue sequential ramp (light -> dark) for ordered magnitude
SEQ = ("#cde2fb", "#9ec5f4", "#6da7ec", "#3987e5", "#256abf", "#184f95",
       "#0d366b")
INK = "#1a1a19"
INK_MUT = "#6b6a63"
GRID = "#e6e5de"

METHOD_SLOTS = {"PCL": 0, "Nister": 1, "BA": 2, "WindowBA": 3}


def _figure(width_in, height_in, ncols=1, sharey=False) -> svg.Figure:
    return svg.Figure(width_in, height_in, ncols, sharey, ink=INK,
                      spine=INK_MUT, grid=GRID)


def _style(ax, title=None, xlabel=None, ylabel=None):
    ax.set(title=title, xlabel=xlabel, ylabel=ylabel)


def _seq_color(i, n):
    """Ramp step for item i of n (the near-white first step avoided)."""
    return SEQ[1 + round((len(SEQ) - 2) * (i / max(n - 1, 1)))]


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# operating curves (study directory -> figures)
# ---------------------------------------------------------------------------

def plot_operating_curves(study: dict, out_dir: str, *,
                          stat: str = "rot_err_deg",
                          speed: str | None = None) -> list[str]:
    """Per method and speed: median error against noise, one line per
    outlier fraction (the ramp), one axes per landmark curve.  `study`:
    `sweeps.load_study`."""
    unit = "deg" if "rot" in stat else "m"
    paths = []
    for method, per_speed in study.items():
        for sp in [speed] if speed else sorted(per_speed):
            conds = per_speed.get(sp, {})
            if not conds:
                continue
            curves = sorted({k[0] for k in conds})
            fracs = sorted({k[2] for k in conds})
            fig = _figure(3.3 * len(curves), 3.0, len(curves), sharey=True)
            for ci, curve in enumerate(curves):
                ax = fig.axes[ci]
                for fi, frac in enumerate(fracs):
                    pts = sorted((k[1], np.median(v[stat]))
                                 for k, v in conds.items()
                                 if k[0] == curve and k[2] == frac
                                 and stat in v)
                    if not pts:
                        continue
                    xs, ys = zip(*pts)
                    ax.plot(xs, ys, color=_seq_color(fi, len(fracs)),
                            marker=True, label=f"{frac*100:.0f}% outliers")
                _style(ax, title=f"{curve} landmarks",
                       xlabel="pixel noise σ (px)",
                       ylabel=f"median {stat} ({unit})" if ci == 0 else None)
            fig.axes[-1].legend()
            fig.suptitle = f"{method} — {sp} motion"
            paths.append(fig.save(os.path.join(
                out_dir, f"curves_{method}_{sp}_{stat.split('_')[0]}.svg")))
    return paths


def plot_method_comparison(study: dict, out_dir: str, *,
                           stat: str = "rot_err_deg",
                           outlier_frac: float = 0.0) -> list[str]:
    """All methods on one axes: median error against noise at one outlier
    level, at each method's largest landmark curve."""
    unit = "deg" if "rot" in stat else "m"
    paths = []
    for sp in sorted({sp for m in study.values() for sp in m}):
        fig = _figure(4.6, 3.2)
        ax = fig.axes[0]
        plotted = 0
        for method, per_speed in sorted(study.items()):
            conds = per_speed.get(sp, {})
            curves = sorted({k[0] for k in conds})
            if not curves:
                continue
            pts = sorted((k[1], np.median(v[stat]))
                         for k, v in conds.items()
                         if k[0] == curves[-1] and k[2] == outlier_frac
                         and stat in v)
            if not pts:
                continue
            xs, ys = zip(*pts)
            c = CAT[METHOD_SLOTS.get(method, 5)]
            ax.plot(xs, ys, color=c, marker=True, label=method)
            ax.annotate(method, (xs[-1], ys[-1]), dx=5)
            plotted += 1
        if not plotted:
            continue
        _style(ax, title=f"Estimator degradation — {sp} motion, "
                         f"{outlier_frac*100:.0f}% outliers",
               xlabel="pixel noise σ (px)",
               ylabel=f"median {stat} ({unit})")
        if plotted > 1:         # a single series: the title names it
            ax.legend()
        paths.append(fig.save(os.path.join(
            out_dir, f"methods_{sp}_{stat.split('_')[0]}.svg")))
    return paths


# ---------------------------------------------------------------------------
# live figures (run the port, draw what result_ONE..FOUR recorded)
# ---------------------------------------------------------------------------

SET_POINTS = (750, 1500, 3000, 5000)


def detection_sweep(left, right, thresholds=tuple(range(5, 60, 5)),
                    device="cuda") -> dict:
    """{circle type: left-image keypoint count per threshold}, NMS on."""
    from front_end_tpu_torch import services
    out = {}
    for d_type in ("5_8", "7_12", "9_16"):
        ids = [{"Name": "FAST",
                "Param": {"threshold": t, "d_type": d_type,
                          "non_maximum_suppression": True}}
               for t in thresholds]
        res = services.single_image_detection(ids, left, right,
                                              device=device)
        out[d_type] = [r["leftFeatures"]["nPoints"] for r in res]
    return out


def plot_detection_sweep(left, right, out_dir: str,
                         thresholds=tuple(range(5, 60, 5)),
                         device="cuda") -> str:
    """Detections against the FAST threshold per circle type, with the
    reference's set-point lines."""
    fig = _figure(4.8, 3.4)
    ax = fig.axes[0]
    counts = detection_sweep(left, right, thresholds, device)
    for i, (d_type, c) in enumerate(counts.items()):
        ax.plot(thresholds, c, color=CAT[i], marker=True,
                label=f"FAST {d_type}")
    for spt in SET_POINTS:
        ax.axhline(spt, color=INK_MUT)
        ax.annotate(str(spt), (thresholds[-1], spt), dy=2, size=7,
                    color=INK_MUT, anchor="end")
    _style(ax, title="Detections vs threshold (NMS on)",
           xlabel="FAST threshold", ylabel="keypoints (left image)")
    ax.legend()
    return fig.save(os.path.join(out_dir, "detect_sweep.svg"))


def setpoint_tracking(lefts, set_points=(1000, 3000, 5000),
                      device="cuda") -> dict:
    """{set-point: detections per frame} of the adaptive grid controller."""
    from front_end_tpu_torch.ops import grid as grid_mod
    dev = resolve_device(device)
    out = {}
    for spt in set_points:
        cfg = grid_mod.GridConfig(set_point=spt, init_threshold=15.0)
        th = cfg.init_thresholds(dev)
        counts = []
        for img in lefts:
            det = grid_mod.detect(torch.as_tensor(img, device=dev), th, cfg)
            th = det.thresholds
            counts.append(int(det.keypoints.count))
        out[spt] = counts
    return out


def plot_setpoint_tracking(lefts, out_dir: str,
                           set_points=(1000, 3000, 5000),
                           device="cuda") -> str:
    """The adaptive grid controller's convergence at several set-points
    over a sequence, with the set-point lines."""
    fig = _figure(4.8, 3.4)
    ax = fig.axes[0]
    for i, (spt, counts) in enumerate(
            setpoint_tracking(lefts, set_points, device).items()):
        ax.plot(range(len(counts)), counts, color=CAT[i],
                label=f"set-point {spt}")
        ax.axhline(spt, color=CAT[i], opacity=0.5)
    _style(ax, title="Adaptive grid set-point tracking", xlabel="frame",
           ylabel="detections")
    ax.legend()
    return fig.save(os.path.join(out_dir, "setpoint_tracking.svg"))


DESC_CONFIGS = (                      # bin/result_ONE:24-25 configurations
    ("BRIEF_16", {"Name": "BRIEF", "Param": {"bytes": 16,
                                             "use_orientation": 0}}),
    ("BRIEF_64", {"Name": "BRIEF", "Param": {"bytes": 64,
                                             "use_orientation": 0}}),
    ("SURF", {"Name": "SURF", "Param": {"extended": 0, "upright": 0}}),
    ("SURF_EXT", {"Name": "SURF", "Param": {"extended": 1, "upright": 0}}),
    ("FREAK", {"Name": "FREAK", "Param": {"pattern_scale": 1.0}}),
    ("ORB", {"Name": "ORB", "Param": {"bytes": 32}}),
)


def descriptor_timing_table(left, right, *, repeats: int = 3,
                            device="cuda") -> list[dict]:
    """Description + stereo matching time per benchmarked descriptor
    configuration on one pair: run once, then `repeats` times between two
    device synchronisations (eager; the JAX package times a compiled
    `run`)."""
    from front_end_tpu_torch import features as features_mod
    from front_end_tpu_torch.ops import grid as grid_mod
    from front_end_tpu_torch.ops import match as match_mod

    dev = resolve_device(device)
    left = torch.as_tensor(left, device=dev).to(torch.float32)
    right = torch.as_tensor(right, device=dev).to(torch.float32)
    cfg = grid_mod.GridConfig()
    kl = grid_mod.detect(left, cfg.init_thresholds(dev), cfg).keypoints
    kr = grid_mod.detect(right, cfg.init_thresholds(dev), cfg).keypoints

    rows = []
    for label, settings in DESC_CONFIGS:
        fn, ok = features_mod.make_descriptor(settings)
        if not ok:
            continue
        norm = ("l2" if settings.get(
            "NormType", "NORM_L2" if settings["Name"] == "SURF"
            else "NORM_HAMMING") == "NORM_L2" else "hamming")

        def run():
            dl = fn(left, kl.xy)
            dr = fn(right, kr.xy)
            return dl, match_mod.stereo_match_knn(
                kl, dl, kr, dr, epi_threshold=2.0, ratio=0.8, norm=norm)

        run()
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(repeats):
            dl, m = run()
        _sync(dev)
        dt = (time.perf_counter() - t0) / repeats
        rows.append({"config": label, "ms": dt * 1e3,
                     "dims": int(dl.bits.shape[-1]),
                     "matches": int(m.count)})
    return rows


def plot_descriptor_timing(rows: list[dict], out_dir: str) -> list[str]:
    """Desc + match ms and stereo match counts as two bar charts."""
    paths = []
    for key, title, fname in (
            ("ms", "Description + matching time", "descriptor_time.svg"),
            ("matches", "Stereo matches", "descriptor_matches.svg")):
        fig = _figure(4.8, 2.8)
        ax = fig.axes[0]
        ax.barh([r["config"] for r in rows], [r[key] for r in rows],
                color=CAT[0], fmt="{:.1f}" if key == "ms" else "{:.0f}")
        _style(ax, title=title,
               xlabel="ms / stereo pair" if key == "ms" else "matches")
        paths.append(fig.save(os.path.join(out_dir, fname)))
    return paths


# ---------------------------------------------------------------------------
# recorded runs (draw FROM a recording, as result_ONE from bags)
# ---------------------------------------------------------------------------

FRAME_BUDGET_S = 1.0 / 15.0          # the reference camera's budget


def plot_recorded_run(record_path: str, out_dir: str) -> list[str]:
    """A `cli vo --record` stream: frame time with the 15 fps budget line,
    the count series on one axes, every other series on its own."""
    from front_end_tpu_torch.pipeline import telemetry

    stages, counters, meta = telemetry.load_log(record_path)
    plat = meta.get("platform", "device")
    stem = os.path.basename(record_path)
    if stem.endswith(".npz"):
        stem = stem[:-4]
    paths = []
    if "frame" in stages:
        ts = stages["frame"] * 1e3
        fig = _figure(4.8, 3.0)
        ax = fig.axes[0]
        ax.plot(range(len(ts)), ts, color=CAT[0], width=1.5)
        ax.axhline(FRAME_BUDGET_S * 1e3, color=INK_MUT)
        ax.annotate("15 fps budget", (0, FRAME_BUDGET_S * 1e3), dy=2,
                    size=7, color=INK_MUT)
        _style(ax, title=f"Recorded frame time — {plat}", xlabel="frame",
               ylabel="ms / frame")
        paths.append(fig.save(os.path.join(
            out_dir, f"recorded_{stem}_frame_time.svg")))
    series = [(k, v) for k, v in sorted(counters.items())
              if k.startswith("n_")]
    if series:
        fig = _figure(4.8, 3.0)
        ax = fig.axes[0]
        for i, (k, v) in enumerate(series):
            ax.plot(range(len(v)), v, color=CAT[i % len(CAT)], width=1.5,
                    label=k)
        _style(ax, title=f"Recorded pipeline counters — {plat}",
               xlabel="frame", ylabel="count")
        ax.legend()
        paths.append(fig.save(os.path.join(
            out_dir, f"recorded_{stem}_counters.svg")))
    others = [(k, v) for k, v in sorted(counters.items())
              if not k.startswith("n_")]
    for i, (k, v) in enumerate(others):
        fig = _figure(4.8, 2.6)
        ax = fig.axes[0]
        ax.plot(range(len(v)), v, color=CAT[(i + 1) % len(CAT)], width=1.5)
        _style(ax, title=f"Recorded {k} — {plat}", xlabel="frame", ylabel=k)
        paths.append(fig.save(os.path.join(
            out_dir, f"recorded_{stem}_{k}.svg")))
    return paths


def plot_recorded_comparison(record_paths: list[str], out_dir: str,
                             labels: list[str] | None = None) -> list[str]:
    """The same pipeline recorded on several platforms: one frame-time
    chart (log scale) and one median-fps bar chart; labels default to each
    recording's platform."""
    from front_end_tpu_torch.pipeline import telemetry

    loaded = []
    for i, rec in enumerate(record_paths):
        stages, _, meta = telemetry.load_log(rec)
        lab = (labels[i] if labels and i < len(labels)
               else meta.get("platform", os.path.basename(rec)))
        loaded.append((lab, stages))
    fig = _figure(5.4, 3.2)
    ax = fig.axes[0]
    for i, (lab, stages) in enumerate(loaded):
        if "frame" in stages:
            ts = stages["frame"] * 1e3
            ax.plot(range(len(ts)), ts, color=CAT[i % len(CAT)], width=1.5,
                    label=lab)
    ax.axhline(FRAME_BUDGET_S * 1e3, color=INK_MUT)
    ax.annotate("15 fps budget", (0, FRAME_BUDGET_S * 1e3), dy=2, size=7,
                color=INK_MUT)
    ax.ylog = True
    _style(ax, title="Recorded frame time by platform", xlabel="frame",
           ylabel="ms / frame (log)")
    ax.legend()
    paths = [fig.save(os.path.join(out_dir, "platform_frame_time.svg"))]

    labs, fps = [], []
    for lab, stages in loaded:
        if "frame" in stages and len(stages["frame"]):
            labs.append(lab)
            fps.append(1.0 / float(np.median(stages["frame"])))
    fig = _figure(4.8, 2.2)
    ax = fig.axes[0]
    ax.barh(labs, fps, color=CAT[0])
    _style(ax, title="Median throughput by platform", xlabel="frames / s")
    paths.append(fig.save(os.path.join(out_dir, "platform_fps.svg")))
    return paths


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------

def _study_table(study: dict) -> list[str]:
    lines = ["| method | speed | landmarks | noise px | outliers | "
             "rot err (deg, med) | trans err (mm, med) |",
             "|---|---|---|---|---|---|---|"]
    for method in sorted(study):
        for sp in sorted(study[method]):
            for (curve, noise, frac), v in sorted(study[method][sp].items()):
                lines.append(
                    f"| {method} | {sp} | {curve} | {noise:g} | "
                    f"{frac*100:.0f}% | "
                    f"{np.median(v['rot_err_deg']):.4f} | "
                    f"{np.median(v['trans_err_m'])*1e3:.2f} |")
    return lines


def generate_report(study_dir: str | None, out_dir: str, *, frames=None,
                    with_timings: bool = True,
                    bench_json: str | None = None,
                    records: list[str] | None = None,
                    device="cuda") -> str:
    """Render everything available into `out_dir` and write REPORT.md.

    study_dir: an `analysis.sweeps` output directory (None skips it);
    frames: (lefts, rights) for the live figures (default: 12 frames of
    `sim.sequence.make_sequence`); bench_json: a benchmark's JSON output to
    inline; records: `cli vo --record` streams to render."""
    os.makedirs(out_dir, exist_ok=True)
    sections = ["# front_end_tpu_torch report",
                "\nGenerated by `cli report`: the `bin/result_ONE..FOUR` "
                "and operating-curve (`analysis.py:383-557`) capability.\n"]
    figs: list[str] = []
    if frames is None:
        from front_end_tpu_torch.sim.sequence import make_sequence
        lefts, rights = make_sequence(12)
    else:
        lefts, rights = frames

    if study_dir and os.path.isdir(study_dir):
        from front_end_tpu_torch.analysis import sweeps
        study = sweeps.load_study(study_dir)
        if study:
            sections.append("## Estimator operating curves\n")
            for stat in ("rot_err_deg", "trans_err_m"):
                figs += plot_method_comparison(study, out_dir, stat=stat)
                figs += plot_operating_curves(study, out_dir, stat=stat)
            sections += ["", "### Median errors per condition", ""]
            sections += _study_table(study)
            sections.append("")

    found = []
    for rec in records or []:
        if not os.path.exists(rec) and os.path.exists(rec + ".npz"):
            rec = rec + ".npz"       # save_log appends the extension
        if os.path.exists(rec):
            found.append(rec)
            sections.append(f"## Recorded run: `{os.path.basename(rec)}`\n")
            figs += plot_recorded_run(rec, out_dir)
    if len(found) >= 2:
        sections.append("## Platform comparison\n\nThe same pipeline "
                        "recorded on each backend, overlaid: the "
                        "reference's i7-vs-Jetson experiment "
                        "(`bin/result_ONE:60-91`).\n")
        figs += plot_recorded_comparison(found, out_dir)

    sections.append("## Detection\n")
    figs.append(plot_detection_sweep(lefts[0], rights[0], out_dir,
                                     device=device))
    figs.append(plot_setpoint_tracking(lefts, out_dir, device=device))

    if with_timings:
        sections.append("## Descriptor timing\n")
        rows = descriptor_timing_table(lefts[0], rights[0], device=device)
        figs += plot_descriptor_timing(rows, out_dir)
        sections += ["| config | dims | desc+match ms | matches |",
                     "|---|---|---|---|"]
        sections += [f"| {r['config']} | {r['dims']} | {r['ms']:.2f} | "
                     f"{r['matches']} |" for r in rows]
        sections.append("")

    if bench_json and os.path.exists(bench_json):
        with open(bench_json) as f:
            sections += ["## Headline bench\n", "```json", f.read().strip(),
                         "```", ""]

    sections.append("## Figures\n")
    sections += [f"![{os.path.basename(p)}]({os.path.basename(p)})"
                 for p in figs]
    path = os.path.join(out_dir, "REPORT.md")
    with open(path, "w") as f:
        f.write("\n".join(sections) + "\n")
    return path
