"""Parameter exploration, batch mode: the `bin/exploreFeatures` capability
(counterpart of `front_end_tpu/analysis/explore.py`).

The reference's explorer is an interactive trackbar window; this is its
batch equivalent:
- sweep a family's whole parameter grid (the stable-ID tables of
  `features.py`) over a few frames through the sweep service (one
  response map per structural group: for FAST, the margin kernel);
- rank the combinations by mean detection count;
- draw keypoint overlays (PNG) for a spread of the ranking, and a
  count-against-parameter summary figure (SVG);
- write INDEX.md listing every combination's counts and time.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from front_end_tpu_torch.analysis.report import CAT, INK_MUT, _figure, _style
from front_end_tpu_torch.utils.precision import resolve_device


def _frames(image: str | None, n_frames: int):
    if image:
        from front_end_tpu_torch.io.kitti import _read_image
        return [_read_image(image).astype(np.float32)]
    from front_end_tpu_torch.sim.sequence import make_sequence
    return list(make_sequence(max(n_frames, 1))[0])


def explore_features(*, family: str = "FAST", out: str,
                     image: str | None = None, n_frames: int = 4,
                     top: int = 12, device="cuda") -> str:
    """Sweep `family`'s whole grid over the frames; write the overlays, the
    summary figure and INDEX.md.  Returns the index's path."""
    from front_end_tpu_torch import features as features_mod
    from front_end_tpu_torch import services
    from front_end_tpu_torch.types import Keypoints
    from front_end_tpu_torch.utils import png
    from front_end_tpu_torch.viz import draw

    dev = resolve_device(device)
    os.makedirs(out, exist_ok=True)
    frames = _frames(image, n_frames)
    table = features_mod.detector_table()
    ids = features_mod.ids_for(family, table)
    if not ids:
        raise SystemExit(f"unknown family {family!r}; known: "
                         f"{sorted({v['Name'] for v in table.values()})}")

    # ---- the grid over the frames (the batched service) -----------------
    per_id = {i: [] for i in ids}
    times = {}
    for f in frames:
        for r in services.single_image_detection(ids, f, f, device=dev):
            if not r.get("supported"):
                per_id.pop(r["detID"], None)
                continue
            per_id[r["detID"]].append(r["leftFeatures"]["nPoints"])
            times[r["detID"]] = r["processingTime"][0]["seconds"]
    ranked = sorted(per_id, key=lambda i: -np.mean(per_id[i]))

    # ---- overlays for a spread of the ranking ---------------------------
    pick = ranked[:: max(len(ranked) // max(top, 1), 1)][:top]
    overlay_rows = []
    img0 = torch.as_tensor(frames[0], dtype=torch.float32, device=dev)
    for det_id in pick:
        fn, ok = features_mod.make_detector(table[det_id])
        if not ok:
            continue
        smap = fn(img0).cpu().numpy()
        ys, xs = np.nonzero(smap > 0)
        k = min(len(xs), 2048)
        sel = np.argsort(-smap[ys, xs])[:k]
        kps = Keypoints(
            xy=torch.as_tensor(np.stack([xs[sel], ys[sel]], -1),
                               dtype=torch.float32),
            score=torch.as_tensor(smap[ys[sel], xs[sel]]),
            angle=torch.zeros(k), valid=torch.ones(k, dtype=torch.bool))
        path = os.path.join(out, f"{det_id}.png")
        png.write(path, draw.draw_keypoints(frames[0], kps))
        overlay_rows.append((det_id, k, path))

    fig_path = _summary_figure(family, table, per_id, out)

    # ---- the index -------------------------------------------------------
    lines = [f"# exploreFeatures — {family}", "",
             f"{len(ids)} parameter combinations x {len(frames)} frames "
             f"(`bin/exploreFeatures` batch equivalent).", "",
             f"![summary]({os.path.basename(fig_path)})", "",
             "| rank | ID | params | mean kp | ms |", "|---|---|---|---|---|"]
    for rank, det_id in enumerate(ranked):
        ptxt = ", ".join(f"{k}={v}" for k, v in table[det_id]["Param"].items())
        lines.append(f"| {rank} | {det_id} | {ptxt} | "
                     f"{np.mean(per_id[det_id]):.0f} | "
                     f"{times.get(det_id, 0.0)*1e3:.2f} |")
    lines += ["", "## Overlays", ""]
    lines += [f"![{d}]({os.path.basename(p)}) `{d}` ({k} kp)"
              for d, k, p in overlay_rows]
    index = os.path.join(out, "INDEX.md")
    with open(index, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"explored {len(ids)} {family} combinations -> {index}")
    return index


def _summary_figure(family, table, per_id, out) -> str:
    """Mean count against the family's primary threshold parameter, one
    line per structural variant (at most 6; the rest stay in the index)."""
    prim = {"FAST": "threshold", "SURF": "hessian_threshold",
            "BRISK": "threshold", "AKAZE": "threshold",
            "ORB": "fast_threshold"}.get(family)
    groups: dict = {}
    for det_id, counts in per_id.items():
        p = dict(table[det_id]["Param"])
        x = p.pop(prim, None)
        key = ", ".join(f"{k}={v}" for k, v in sorted(p.items()))
        if x is not None:
            groups.setdefault(key, []).append((float(x), np.mean(counts)))
    fig = _figure(5.2, 3.4)
    ax = fig.axes[0]
    shown = sorted(groups)[:6]
    for i, key in enumerate(shown):
        xs, ys = zip(*sorted(groups[key]))
        ax.plot(xs, ys, color=CAT[i % len(CAT)],
                label=key if len(key) < 48 else key[:45] + "…")
    _style(ax, title=f"{family}: detections vs {prim}", xlabel=prim,
           ylabel="mean keypoints")
    if len(shown) > 1:
        ax.legend()
    if len(groups) > len(shown):
        ax.annotate(f"(+{len(groups) - len(shown)} more variants in table)",
                    (0.98, 0.02), anchor="end", size=7, color=INK_MUT,
                    axes_fraction=True)
    return fig.save(os.path.join(out, f"summary_{family}.svg"))
