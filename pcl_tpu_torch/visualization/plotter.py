"""PCLPlotter / histogram & range-image visualization — headless exports.

Capability match for the reference's plotting/visualization widgets as
file artifacts (no VTK window on a headless host):

- ``plot_histogram_svg``: pcl::visualization::PCLPlotter (reference:
  visualization/include/pcl/visualization/pcl_plotter.h addFeatureHistogram
  / addPlotData) — renders one or more named series (e.g. a FPFH33
  histogram) as a standalone SVG line/bar chart.
- ``plot_xy_svg``: addPlotData for (x, y) polylines.
- ``range_image_to_pgm``: pcl::visualization::RangeImageVisualizer
  (range_image_visualizer.h) — range image to a grayscale PGM (binary P5),
  normalized like getVisualImage.
- ``histogram_visualizer_svg``: PCLHistogramVisualizer batch form — one
  SVG per cloud feature row.

Counterpart of ``pcl_tpu/visualization/plotter.py``: a copy of its numpy
code; the SVG and PGM files are the JAX package's byte for byte.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

_COLORS = ["#1f77b4", "#d62728", "#2ca02c", "#9467bd", "#ff7f0e", "#8c564b"]


def _svg_header(w: int, h: int) -> str:
    return (
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{w}" height="{h}" '
        f'viewBox="0 0 {w} {h}"><rect width="{w}" height="{h}" fill="white"/>'
    )


def plot_xy_svg(
    path: str,
    series: Sequence[Tuple[np.ndarray, np.ndarray, str]],
    width: int = 640,
    height: int = 400,
    title: str = "",
) -> None:
    """series: list of (x, y, name)."""
    margin = 46
    xs = np.concatenate([np.asarray(s[0], float) for s in series])
    ys = np.concatenate([np.asarray(s[1], float) for s in series])
    x0, x1 = float(xs.min()), float(xs.max())
    y0, y1 = float(ys.min()), float(ys.max())
    if x1 - x0 < 1e-12:
        x1 = x0 + 1.0
    if y1 - y0 < 1e-12:
        y1 = y0 + 1.0

    def sx(x):
        return margin + (x - x0) / (x1 - x0) * (width - 2 * margin)

    def sy(y):
        return height - margin - (y - y0) / (y1 - y0) * (height - 2 * margin)

    parts = [_svg_header(width, height)]
    # axes
    parts.append(
        f'<line x1="{margin}" y1="{height-margin}" x2="{width-margin}" '
        f'y2="{height-margin}" stroke="black"/>'
        f'<line x1="{margin}" y1="{margin}" x2="{margin}" '
        f'y2="{height-margin}" stroke="black"/>'
    )
    for t, frac in ((x0, 0.0), ((x0 + x1) / 2, 0.5), (x1, 1.0)):
        px = margin + frac * (width - 2 * margin)
        parts.append(
            f'<text x="{px:.1f}" y="{height-margin+16}" font-size="11" '
            f'text-anchor="middle">{t:.3g}</text>'
        )
    for t, frac in ((y0, 0.0), ((y0 + y1) / 2, 0.5), (y1, 1.0)):
        py = height - margin - frac * (height - 2 * margin)
        parts.append(
            f'<text x="{margin-6}" y="{py+4:.1f}" font-size="11" '
            f'text-anchor="end">{t:.3g}</text>'
        )
    if title:
        parts.append(
            f'<text x="{width/2}" y="20" font-size="14" '
            f'text-anchor="middle">{title}</text>'
        )
    for i, (x, y, name) in enumerate(series):
        col = _COLORS[i % len(_COLORS)]
        pts = " ".join(
            f"{sx(float(a)):.1f},{sy(float(b)):.1f}" for a, b in zip(x, y)
        )
        parts.append(
            f'<polyline points="{pts}" fill="none" stroke="{col}" '
            f'stroke-width="1.5"/>'
        )
        parts.append(
            f'<text x="{width-margin-4}" y="{margin+14*(i+1)}" font-size="12" '
            f'fill="{col}" text-anchor="end">{name}</text>'
        )
    parts.append("</svg>")
    with open(path, "w") as f:
        f.write("".join(parts))


def plot_histogram_svg(
    path: str,
    hist: np.ndarray,
    name: str = "histogram",
    width: int = 640,
    height: int = 400,
) -> None:
    """One feature histogram (e.g. one FPFH33 row) as bars
    (pcl_plotter.h addFeatureHistogram)."""
    h = np.asarray(hist, float).ravel()
    x = np.arange(len(h), dtype=float)
    plot_xy_svg(path, [(x, h, name)], width, height, title=name)


def histogram_visualizer_svg(
    path_prefix: str, features: np.ndarray, indices: Sequence[int],
) -> List[str]:
    """Write one SVG per selected feature row (PCLHistogramVisualizer
    addFeatureHistogram per cloud); returns written paths."""
    out = []
    for i in indices:
        p = f"{path_prefix}_{i}.svg"
        plot_histogram_svg(p, features[i], name=f"feature[{i}]")
        out.append(p)
    return out


def range_image_to_pgm(path: str, ranges: np.ndarray) -> None:
    """Range image -> binary PGM, unobserved (<=0 / inf / nan) white
    (range_image_visualizer.h getVisualImage normalization)."""
    r = np.asarray(ranges, np.float64)
    finite = np.isfinite(r) & (r > 0)
    if finite.any():
        lo, hi = r[finite].min(), r[finite].max()
        span = max(hi - lo, 1e-9)
        img = ((r - lo) / span * 255.0).clip(0, 255)
    else:
        img = np.zeros_like(r)
    img = np.where(finite, img, 255.0).astype(np.uint8)
    H, W = img.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{W} {H}\n255\n".encode())
        f.write(img.tobytes())
