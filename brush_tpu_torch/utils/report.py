"""Self-contained HTML report for a training run directory (a copy of
`brush_tpu/utils/report.py`; numpy only).

Replaces the interactive side of brush-rerun (visualize_tools.rs:86-707)
for this environment: `write_report(run_dir)` reads the telemetry stream
(stats.jsonl), eval render PNGs, and splat-distribution snapshots (npz)
written by utils/telemetry.py, and emits one dependency-free `report.html`
with stat tiles, SVG training curves (crosshair + tooltip), an eval-image
gallery, and splat histograms.

Charts follow the dataviz method: single-hue series from the validated
default palette (slots 1-3, documented adjacent CVD dE 9.1 light / 8.4
dark), one axis per chart, recessive grid, text in text tokens, hover
tooltips, light/dark via prefers-color-scheme.
"""

from __future__ import annotations

import base64
import json
import math
from pathlib import Path

import numpy as np

_CSS = """
:root { color-scheme: light dark; }
body { margin: 0; padding: 24px; background: #fcfcfb; color: #0b0b0b;
       font: 14px/1.45 system-ui, sans-serif; }
h1 { font-size: 20px; margin: 0 0 4px; }
h2 { font-size: 15px; margin: 28px 0 10px; }
.sub { color: #52514e; font-size: 12px; margin-bottom: 18px; }
.tiles { display: flex; flex-wrap: wrap; gap: 12px; }
.tile { background: #f4f3f1; border-radius: 8px; padding: 12px 16px;
        min-width: 130px; }
.tile .v { font-size: 22px; font-weight: 600; font-variant-numeric:
           tabular-nums; }
.tile .k { color: #52514e; font-size: 12px; }
.charts { display: grid; grid-template-columns: repeat(auto-fill,
          minmax(420px, 1fr)); gap: 16px; }
.chart { background: #f4f3f1; border-radius: 8px; padding: 10px 12px; }
.chart h3 { font-size: 13px; margin: 0 0 6px; font-weight: 600; }
svg text { fill: #52514e; font: 10px system-ui, sans-serif; }
svg .grid { stroke: #0b0b0b; stroke-opacity: .07; }
svg .axis { stroke: #0b0b0b; stroke-opacity: .25; }
svg .s1 { stroke: #2a78d6; } svg .f1 { fill: #2a78d6; }
.gallery { display: flex; flex-wrap: wrap; gap: 10px; }
.gallery figure { margin: 0; }
.gallery img { max-width: 300px; border-radius: 6px; display: block; }
.gallery figcaption { font-size: 11px; color: #52514e; padding: 2px 0; }
.tip { position: fixed; pointer-events: none; background: #0b0b0b;
       color: #fcfcfb; padding: 4px 8px; border-radius: 5px; font-size: 11px;
       display: none; z-index: 9; }
@media (prefers-color-scheme: dark) {
  body { background: #1a1a19; color: #fff; }
  .sub, .tile .k, .gallery figcaption, svg text { color: #c3c2b7;
       fill: #c3c2b7; }
  .tile, .chart { background: #242423; }
  svg .grid, svg .axis { stroke: #fff; }
  svg .s1 { stroke: #3987e5; } svg .f1 { fill: #3987e5; }
  .tip { background: #fff; color: #0b0b0b; }
}
"""

_JS = """
const tip = document.createElement('div'); tip.className = 'tip';
document.body.appendChild(tip);
for (const svg of document.querySelectorAll('svg[data-pts]')) {
  const pts = JSON.parse(svg.dataset.pts);
  const cross = svg.querySelector('.cross'), dot = svg.querySelector('.dot');
  svg.addEventListener('mousemove', (e) => {
    const r = svg.getBoundingClientRect();
    const x = (e.clientX - r.left) * (svg.viewBox.baseVal.width / r.width);
    let best = 0, bd = 1e18;
    for (let i = 0; i < pts.length; i++) {
      const d = Math.abs(pts[i][0] - x);
      if (d < bd) { bd = d; best = i; }
    }
    const [px, py, step, val] = pts[best];
    cross.setAttribute('x1', px); cross.setAttribute('x2', px);
    cross.style.display = 'block'; dot.style.display = 'block';
    dot.setAttribute('cx', px); dot.setAttribute('cy', py);
    tip.style.display = 'block';
    tip.style.left = (e.clientX + 12) + 'px';
    tip.style.top = (e.clientY - 10) + 'px';
    tip.textContent = `step ${step}: ${val}`;
  });
  svg.addEventListener('mouseleave', () => {
    tip.style.display = 'none'; cross.style.display = 'none';
    dot.style.display = 'none';
  });
}
"""


def _fmt(v: float) -> str:
    if v == 0:
        return "0"
    if abs(v) >= 10000 or abs(v) < 0.001:
        return f"{v:.3g}"
    return f"{v:.4g}"


def _line_chart(title: str, steps, vals, w=420, h=160) -> str:
    """Single-series SVG line (2px stroke, recessive grid, last-value
    direct label, crosshair hover via _JS)."""
    pts = [(s, v) for s, v in zip(steps, vals)
           if v is not None and math.isfinite(v)]
    if len(pts) < 2:
        return ""
    xs = [p[0] for p in pts]
    ys = [p[1] for p in pts]
    x0, x1 = min(xs), max(xs)
    y0, y1 = min(ys), max(ys)
    if y1 == y0:
        y0, y1 = y0 - 1, y1 + 1
    pad_l, pad_r, pad_t, pad_b = 42, 46, 8, 18
    sx = lambda x: pad_l + (x - x0) / max(x1 - x0, 1e-12) * (w - pad_l - pad_r)
    sy = lambda y: pad_t + (y1 - y) / (y1 - y0) * (h - pad_t - pad_b)
    path = " ".join(f"{'M' if i == 0 else 'L'}{sx(x):.1f},{sy(y):.1f}"
                    for i, (x, y) in enumerate(pts))
    grid = "".join(
        f'<line class="grid" x1="{pad_l}" x2="{w - pad_r}" '
        f'y1="{sy(y0 + f * (y1 - y0)):.1f}" y2="{sy(y0 + f * (y1 - y0)):.1f}"/>'
        f'<text x="{pad_l - 4}" y="{sy(y0 + f * (y1 - y0)) + 3:.1f}" '
        f'text-anchor="end">{_fmt(y0 + f * (y1 - y0))}</text>'
        for f in (0.0, 0.5, 1.0))
    hover = json.dumps([[round(sx(x), 1), round(sy(y), 1), x, _fmt(y)]
                        for x, y in pts])
    last_x, last_y = pts[-1]
    return f"""
<div class="chart"><h3>{title}</h3>
<svg viewBox="0 0 {w} {h}" data-pts='{hover}'>
{grid}
<line class="axis" x1="{pad_l}" x2="{w - pad_r}" y1="{h - pad_b}" y2="{h - pad_b}"/>
<text x="{pad_l}" y="{h - 4}">{_fmt(x0)}</text>
<text x="{w - pad_r}" y="{h - 4}" text-anchor="end">{_fmt(x1)}</text>
<path class="s1" d="{path}" fill="none" stroke-width="2"/>
<text x="{sx(last_x) + 4:.1f}" y="{sy(last_y) + 3:.1f}">{_fmt(last_y)}</text>
<line class="cross axis" y1="{pad_t}" y2="{h - pad_b}" x1="0" x2="0"
 style="display:none"/>
<circle class="dot f1" r="3.5" style="display:none"/>
</svg></div>"""


def _histogram(title: str, data: np.ndarray, w=420, h=140, bins=40) -> str:
    data = data[np.isfinite(data)]
    if data.size == 0:
        return ""
    counts, edges = np.histogram(data, bins=bins)
    pad_l, pad_t, pad_b = 42, 8, 18
    bw = (w - pad_l - 8) / bins
    top = max(int(counts.max()), 1)
    bars = "".join(
        f'<rect class="f1" x="{pad_l + i * bw:.1f}" '
        f'y="{pad_t + (1 - c / top) * (h - pad_t - pad_b):.1f}" '
        f'width="{max(bw - 2, 1):.1f}" '
        f'height="{(c / top) * (h - pad_t - pad_b):.1f}" rx="2">'
        f'<title>[{_fmt(edges[i])}, {_fmt(edges[i + 1])}): {c}</title></rect>'
        for i, c in enumerate(counts) if c > 0)
    return f"""
<div class="chart"><h3>{title}</h3>
<svg viewBox="0 0 {w} {h}">
<line class="axis" x1="{pad_l}" x2="{w - 8}" y1="{h - pad_b}" y2="{h - pad_b}"/>
<text x="{pad_l}" y="{h - 4}">{_fmt(edges[0])}</text>
<text x="{w - 8}" y="{h - 4}" text-anchor="end">{_fmt(edges[-1])}</text>
<text x="{pad_l - 4}" y="{pad_t + 4}" text-anchor="end">{top}</text>
{bars}
</svg></div>"""


def write_report(run_dir: str | Path, max_images: int = 12) -> Path:
    """Render run_dir/report.html from the telemetry artifacts. Returns the
    report path. Safe to call repeatedly (idempotent snapshot)."""
    run = Path(run_dir)
    records = []
    stats_path = run / "stats.jsonl"
    if stats_path.exists():
        for line in stats_path.read_text().splitlines():
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                continue

    steps = [r.get("step") for r in records]
    keys = sorted({k for r in records for k in r} - {"step", "t"})
    series = {k: [r.get(k) for r in records] for k in keys}

    tiles = []
    if records:
        last = records[-1]
        for k in ("psnr", "ssim", "loss", "num_splats", "steps_per_sec"):
            v = next((r[k] for r in reversed(records)
                      if r.get(k) is not None), None)
            if v is not None:
                tiles.append(f'<div class="tile"><div class="v">{_fmt(v)}'
                             f'</div><div class="k">{k}</div></div>')
        tiles.append(f'<div class="tile"><div class="v">{last["step"]}'
                     f'</div><div class="k">last step</div></div>')

    charts = []
    priority = [k for k in ("loss", "psnr", "ssim", "num_splats")
                if k in series]
    rest = [k for k in keys if k not in priority and not k.startswith("mem")]
    mem = [k for k in keys if k.startswith("mem") and "bytes_in_use" in k]
    for k in priority + rest + mem[:1]:
        charts.append(_line_chart(k, steps, series[k]))

    gallery = []
    pngs = sorted(run.glob("*.png"))
    if len(pngs) > max_images:
        stride = len(pngs) / max_images
        pngs = [pngs[int(i * stride)] for i in range(max_images)]
    for p in pngs:
        b64 = base64.b64encode(p.read_bytes()).decode()
        gallery.append(f'<figure><img src="data:image/png;base64,{b64}"/>'
                       f'<figcaption>{p.stem}</figcaption></figure>')

    hists = []
    dists = sorted(run.glob("splat_dist_*.npz"))
    if dists:
        d = np.load(dists[-1])
        step_tag = dists[-1].stem.split("_")[-1]
        if "log_scales" in d:
            hists.append(_histogram(f"log_scales @ step {step_tag}",
                                    d["log_scales"].ravel()))
        if "raw_opacities" in d:
            hists.append(_histogram(f"raw_opacities @ step {step_tag}",
                                    d["raw_opacities"].ravel()))

    html = f"""<!doctype html><html><head><meta charset="utf-8">
<title>brush_tpu run report</title><style>{_CSS}</style></head><body>
<h1>brush_tpu training run</h1>
<div class="sub">{run.resolve()} &middot; {len(records)} telemetry records</div>
<div class="tiles">{''.join(tiles)}</div>
<h2>Training curves</h2><div class="charts">{''.join(c for c in charts if c)}</div>
{'<h2>Splat distributions</h2><div class="charts">' + ''.join(hists) + '</div>' if hists else ''}
{'<h2>Eval renders</h2><div class="gallery">' + ''.join(gallery) + '</div>' if gallery else ''}
<script>{_JS}</script></body></html>"""
    out = run / "report.html"
    out.write_text(html)
    return out
