"""Figures written as SVG with the standard library alone.

The port's machines need not have matplotlib, so `analysis/report.py`
and `analysis/explore.py` draw through this small writer: a figure of one
row of axes, each with linear (or logarithmic y) axes, ticks and tick
labels, a recessive grid, left and bottom spines, a left-aligned title,
polylines with round markers, horizontal reference lines, horizontal bars
with category labels, direct text labels and a legend.  Every polyline
and bar group carries its data as `data-*` attributes (`data-label`,
`data-x`, `data-y`; `data-labels` joined by `|`, `data-values`), so a
figure's series can be read back from the file.
"""
from __future__ import annotations

import math
from xml.sax.saxutils import escape, quoteattr

PX_PER_IN = 96.0
FONT = "DejaVu Sans, Helvetica, Arial, sans-serif"


def _num(v) -> str:
    return f"{float(v):.2f}".rstrip("0").rstrip(".")


def nice_ticks(lo: float, hi: float) -> list[float]:
    """About five round tick values (1, 2 or 5 × 10^k steps) in [lo, hi]."""
    if not math.isfinite(lo) or not math.isfinite(hi):
        return []
    if hi <= lo:
        hi = lo + (abs(lo) or 1.0)
    raw = (hi - lo) / 5
    mag = 10.0 ** math.floor(math.log10(raw))
    step = next(m * mag for m in (1, 2, 5, 10) if m * mag >= raw)
    first = math.ceil(lo / step - 1e-9) * step
    return [first + i * step for i in range(int((hi - first) / step + 1e-9)
                                            + 1)]


def _tick_text(v: float) -> str:
    return f"{v:.6g}" if abs(v) >= 1e-4 or v == 0 else f"{v:.1e}"


class Axes:
    def __init__(self, style: dict):
        self.s = style
        self.lines: list[dict] = []
        self.hlines: list[dict] = []
        self.bars: dict | None = None
        self.notes: list[dict] = []
        self.title = self.xlabel = self.ylabel = None
        self.ylog = False
        self.show_legend = False

    def plot(self, xs, ys, *, color: str, width: float = 2.0,
             marker: bool = False, label: str | None = None):
        self.lines.append(dict(x=[float(v) for v in xs],
                               y=[float(v) for v in ys], color=color,
                               width=width, marker=marker, label=label))

    def axhline(self, y: float, *, color: str, opacity: float = 1.0):
        """A dashed reference line across the axes."""
        self.hlines.append(dict(y=float(y), color=color, opacity=opacity))

    def barh(self, labels, values, *, color: str, fmt: str = "{:.1f}"):
        """Horizontal bars, the first label at the top, each value written
        at its bar's end."""
        self.bars = dict(labels=[str(v) for v in labels],
                         values=[float(v) for v in values], color=color,
                         fmt=fmt)

    def annotate(self, text: str, xy, *, dx: float = 0.0, dy: float = 0.0,
                 color: str | None = None, size: float = 8,
                 anchor: str = "start", axes_fraction: bool = False):
        """Text at data point `xy` (or at a fraction of the axes), offset
        by (dx, dy) px, dy up."""
        self.notes.append(dict(text=str(text), x=float(xy[0]),
                               y=float(xy[1]), dx=dx, dy=dy,
                               color=color or self.s["ink"], size=size,
                               anchor=anchor, frac=axes_fraction))

    def set(self, title=None, xlabel=None, ylabel=None):
        self.title, self.xlabel, self.ylabel = title, xlabel, ylabel

    def legend(self):
        self.show_legend = True

    # ---- rendering -------------------------------------------------------
    def _ylims(self):
        ys = [v for ln in self.lines for v in ln["y"]]
        ys += [h["y"] for h in self.hlines]
        ys = [v for v in ys if math.isfinite(v) and (v > 0 or not self.ylog)]
        if not ys:
            return (1.0, 10.0) if self.ylog else (0.0, 1.0)
        lo, hi = min(ys), max(ys)
        if self.ylog:
            return (10.0 ** math.floor(math.log10(lo)),
                    10.0 ** math.ceil(math.log10(hi) + 1e-12))
        pad = 0.05 * (hi - lo) if hi > lo else (abs(hi) or 1.0) * 0.5
        return lo - pad, hi + pad

    def _xlims(self):
        xs = [v for ln in self.lines for v in ln["x"] if math.isfinite(v)]
        if not xs:
            return 0.0, 1.0
        lo, hi = min(xs), max(xs)
        pad = 0.05 * (hi - lo) if hi > lo else 0.5
        return lo - pad, hi + pad

    def render(self, x0: float, y0: float, w: float, h: float,
               ylims=None, ytick_labels: bool = True) -> list[str]:
        s, out = self.s, []
        if self.bars is not None:
            return self._render_bars(x0, y0, w, h)
        xlo, xhi = self._xlims()
        ylo, yhi = ylims or self._ylims()

        def X(v):
            return x0 + (v - xlo) / (xhi - xlo) * w

        def Y(v):
            if self.ylog:
                v = math.log10(max(v, 1e-300))
                lo, hi = math.log10(ylo), math.log10(yhi)
                return y0 + h - (v - lo) / (hi - lo) * h
            return y0 + h - (v - ylo) / (yhi - ylo) * h

        yt = ([10.0 ** k for k in range(round(math.log10(ylo)),
                                         round(math.log10(yhi)) + 1)]
              if self.ylog else nice_ticks(ylo, yhi))
        yt = [v for v in yt if ylo <= v <= yhi]
        xt = [v for v in nice_ticks(xlo, xhi) if xlo <= v <= xhi]
        out += _grid_and_spines(s, x0, y0, w, h, [X(v) for v in xt],
                                [Y(v) for v in yt])
        for v in xt:
            out.append(_text(s, _tick_text(v), X(v), y0 + h + 13, 8,
                             "middle"))
        if ytick_labels:
            for v in yt:
                out.append(_text(s, _tick_text(v), x0 - 5, Y(v) + 3, 8,
                                 "end"))
        for hl in self.hlines:
            out.append(f'<line x1="{_num(x0)}" y1="{_num(Y(hl["y"]))}" '
                       f'x2="{_num(x0 + w)}" y2="{_num(Y(hl["y"]))}" '
                       f'stroke="{hl["color"]}" stroke-width="0.8" '
                       f'stroke-opacity="{hl["opacity"]}" '
                       f'stroke-dasharray="4 3"/>')
        for ln in self.lines:
            pts = " ".join(f"{_num(X(a))},{_num(Y(b))}"
                           for a, b in zip(ln["x"], ln["y"])
                           if math.isfinite(b) and (b > 0 or not self.ylog))
            out.append(
                f'<polyline points="{pts}" fill="none" '
                f'stroke="{ln["color"]}" stroke-width="{ln["width"]}" '
                f'stroke-linejoin="round" data-label='
                f'{quoteattr(ln["label"] or "")} data-x="'
                f'{" ".join(repr(v) for v in ln["x"])}" data-y="'
                f'{" ".join(repr(v) for v in ln["y"])}"/>')
            if ln["marker"]:
                out += [f'<circle cx="{_num(X(a))}" cy="{_num(Y(b))}" r="2.5"'
                        f' fill="{ln["color"]}"/>'
                        for a, b in zip(ln["x"], ln["y"]) if math.isfinite(b)]
        for nt in self.notes:
            px = (x0 + nt["x"] * w if nt["frac"] else X(nt["x"])) + nt["dx"]
            py = (y0 + h - nt["y"] * h if nt["frac"] else Y(nt["y"]))
            out.append(_text(s, nt["text"], px, py - nt["dy"], nt["size"],
                             nt["anchor"], nt["color"]))
        out += self._decorations(x0, y0, w, h)
        return out

    def _render_bars(self, x0, y0, w, h) -> list[str]:
        s, b, out = self.s, self.bars, []
        vals = b["values"]
        hi = max([v for v in vals if math.isfinite(v)] + [0.0]) * 1.15 or 1.0
        xt = [v for v in nice_ticks(0.0, hi) if v <= hi]
        slot = h / max(len(vals), 1)

        def X(v):
            return x0 + v / hi * w

        out += _grid_and_spines(s, x0, y0, w, h, [X(v) for v in xt], [])
        for v in xt:
            out.append(_text(s, _tick_text(v), X(v), y0 + h + 13, 8,
                             "middle"))
        out.append(f'<g data-labels={quoteattr("|".join(b["labels"]))} '
                   f'data-values="{" ".join(repr(v) for v in vals)}">')
        for i, (lab, v) in enumerate(zip(b["labels"], vals)):
            top = y0 + i * slot + 0.2 * slot
            out.append(f'<rect x="{_num(x0)}" y="{_num(top)}" '
                       f'width="{_num(max(X(v) - x0, 0.0))}" '
                       f'height="{_num(0.6 * slot)}" fill="{b["color"]}"/>')
            mid = top + 0.3 * slot + 3
            out.append(_text(s, lab, x0 - 5, mid, 8, "end"))
            out.append(_text(s, b["fmt"].format(v), X(v) + 4, mid, 8,
                             "start"))
        out.append("</g>")
        out += self._decorations(x0, y0, w, h)
        return out

    def _decorations(self, x0, y0, w, h) -> list[str]:
        s, out = self.s, []
        if self.title:
            out.append(_text(s, self.title, x0, y0 - 10, 11, "start"))
        if self.xlabel:
            out.append(_text(s, self.xlabel, x0 + w / 2, y0 + h + 30, 9,
                             "middle"))
        if self.ylabel:
            cx, cy = x0 - 44, y0 + h / 2
            out.append(f'<text x="{_num(cx)}" y="{_num(cy)}" '
                       f'font-family="{FONT}" font-size="9" '
                       f'fill="{s["ink"]}" text-anchor="middle" '
                       f'transform="rotate(-90 {_num(cx)} {_num(cy)})">'
                       f'{escape(self.ylabel)}</text>')
        if self.show_legend:
            items = [ln for ln in self.lines if ln["label"]]
            for i, ln in enumerate(items):
                ly = y0 + 10 + 12 * i
                lx = x0 + w - 130
                out.append(f'<line x1="{_num(lx)}" y1="{_num(ly)}" '
                           f'x2="{_num(lx + 14)}" y2="{_num(ly)}" '
                           f'stroke="{ln["color"]}" stroke-width="2"/>')
                out.append(_text(s, ln["label"], lx + 18, ly + 3, 7,
                                 "start"))
        return out


def _text(s, text, x, y, size, anchor, color=None) -> str:
    return (f'<text x="{_num(x)}" y="{_num(y)}" font-family="{FONT}" '
            f'font-size="{size}" fill="{color or s["ink"]}" '
            f'text-anchor="{anchor}">{escape(str(text))}</text>')


def _grid_and_spines(s, x0, y0, w, h, gx, gy) -> list[str]:
    out = [f'<line x1="{_num(x)}" y1="{_num(y0)}" x2="{_num(x)}" '
           f'y2="{_num(y0 + h)}" stroke="{s["grid"]}" stroke-width="0.8"/>'
           for x in gx]
    out += [f'<line x1="{_num(x0)}" y1="{_num(y)}" x2="{_num(x0 + w)}" '
            f'y2="{_num(y)}" stroke="{s["grid"]}" stroke-width="0.8"/>'
            for y in gy]
    out.append(f'<polyline points="{_num(x0)},{_num(y0)} {_num(x0)},'
               f'{_num(y0 + h)} {_num(x0 + w)},{_num(y0 + h)}" fill="none" '
               f'stroke="{s["spine"]}" stroke-width="1"/>')
    return out


class Figure:
    """`ncols` axes side by side, `width_in` × `height_in` inches;
    `sharey` puts every axes on one y range, tick labels on the first."""

    def __init__(self, width_in: float, height_in: float, ncols: int = 1,
                 sharey: bool = False, *, ink: str = "#000000",
                 spine: str = "#666666", grid: str = "#e6e6e6"):
        self.style = dict(ink=ink, spine=spine, grid=grid)
        self.w, self.h = width_in * PX_PER_IN, height_in * PX_PER_IN
        self.axes = [Axes(self.style) for _ in range(ncols)]
        self.sharey = sharey
        self.suptitle = None

    def save(self, path: str) -> str:
        left, right, top, bottom, gap = 64.0, 16.0, 34.0, 44.0, 24.0
        if self.suptitle:
            top += 22.0
        n = len(self.axes)
        if any(ax.bars for ax in self.axes):
            left = 24.0 + 6.0 * max(len(lab) for ax in self.axes if ax.bars
                                    for lab in ax.bars["labels"])
        aw = (self.w - left - right - gap * (n - 1)) / n
        ah = self.h - top - bottom
        ylims = None
        if self.sharey:
            lims = [ax._ylims() for ax in self.axes]
            ylims = (min(a for a, _ in lims), max(b for _, b in lims))
        body = []
        for i, ax in enumerate(self.axes):
            body += ax.render(left + i * (aw + gap), top, aw, ah, ylims,
                              ytick_labels=not (self.sharey and i))
        if self.suptitle:
            body.insert(0, _text(self.style, self.suptitle, 8, 20, 12,
                                 "start"))
        svg = (f'<svg xmlns="http://www.w3.org/2000/svg" '
               f'width="{_num(self.w)}" height="{_num(self.h)}" '
               f'viewBox="0 0 {_num(self.w)} {_num(self.h)}">\n'
               f'<rect width="100%" height="100%" fill="white"/>\n'
               + "\n".join(body) + "\n</svg>\n")
        with open(path, "w", encoding="utf-8") as f:
            f.write(svg)
        return path
