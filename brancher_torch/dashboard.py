"""Self-contained HTML posterior dashboards.

Counterpart of ``brancher_tpu/dashboard.py`` (lines 1-322), under its
names: ``export_dashboard_html`` renders inline SVG with a few lines of
vanilla JS (hover tooltips, a crosshair on the traces) into ONE portable
file: no network, no dependencies.  Per flattened coordinate, a histogram
of the pooled draws, the traces of the first chains and a row of the
stats table (mean, sd, q5/q95, ESS, R-hat); header tiles summarize the
run.  The draws on the card go to the host once; ESS and R-hat not in the
run's diagnostics come from ``inference.diagnostics`` on host numpy.

The design follows the JAX package's: histogram for the distribution,
trace for change over draws, a validated categorical palette in fixed slot
order (one hue per chain), recessive grid, text never in series colours,
and selected dark-mode steps through CSS custom properties.
"""
from __future__ import annotations

import html
from typing import Dict, Optional, Sequence

import numpy as np

from .pandas_interface import _host

# Validated categorical palette (fixed slot order; light / dark steps are
# separately selected for each surface).  Adjacent-pair CVD dE >= 8.4 and
# normal-vision dE >= 19.3 in both modes per the palette's validation
# record; traces cap at 4 chains so the yellow/orange all-pairs failure
# mode never arises.
_SERIES_LIGHT = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100"]
_SERIES_DARK = ["#3987e5", "#d95926", "#199e70", "#c98500"]

_CSS = """
:root { color-scheme: light dark; }
.viz-root {
  --surface-1: #fcfcfb; --surface-2: #f4f4f2;
  --text-primary: #0b0b0b; --text-secondary: #52514e;
  --grid: #e4e3df; --axis: #b9b8b2;
  --s1: #2a78d6; --s2: #eb6834; --s3: #1baf7a; --s4: #eda100;
  background: var(--surface-1); color: var(--text-primary);
  font: 14px/1.45 system-ui, -apple-system, "Segoe UI", sans-serif;
  margin: 0; padding: 24px;
}
@media (prefers-color-scheme: dark) {
  :root:where(:not([data-theme="light"])) .viz-root {
    --surface-1: #1a1a19; --surface-2: #242423;
    --text-primary: #ffffff; --text-secondary: #c3c2b7;
    --grid: #34342f; --axis: #55544e;
    --s1: #3987e5; --s2: #d95926; --s3: #199e70; --s4: #c98500;
  }
}
.viz-root h1 { font-size: 20px; margin: 0 0 4px; }
.viz-root .sub { color: var(--text-secondary); margin: 0 0 18px; }
.tiles { display: flex; gap: 12px; flex-wrap: wrap; margin-bottom: 22px; }
.tile { background: var(--surface-2); border-radius: 8px; padding: 10px 16px; }
.tile .v { font-size: 20px; font-weight: 600; font-variant-numeric: tabular-nums; }
.tile .l { color: var(--text-secondary); font-size: 12px; }
.panel { margin-bottom: 26px; }
.panel h2 { font-size: 15px; margin: 0 0 6px; }
.row { display: flex; gap: 18px; flex-wrap: wrap; align-items: flex-start; }
.legend { display: flex; gap: 12px; font-size: 12px; color: var(--text-secondary);
          margin: 2px 0 0; }
.legend .chip { display: inline-block; width: 10px; height: 10px;
                border-radius: 2px; margin-right: 4px; vertical-align: -1px; }
table.stats { border-collapse: collapse; font-size: 13px;
              font-variant-numeric: tabular-nums; }
table.stats th, table.stats td { padding: 3px 10px; text-align: right;
  border-bottom: 1px solid var(--grid); }
table.stats th { color: var(--text-secondary); font-weight: 500; }
table.stats td:first-child, table.stats th:first-child { text-align: left; }
svg text { fill: var(--text-secondary); font-size: 11px; }
#tt { position: fixed; pointer-events: none; background: var(--surface-2);
  color: var(--text-primary); border: 1px solid var(--grid); border-radius: 6px;
  padding: 4px 8px; font-size: 12px; display: none; z-index: 9;
  font-variant-numeric: tabular-nums; }
"""

_JS = """
const tt = document.getElementById('tt');
function showTT(e, html) {
  tt.innerHTML = html; tt.style.display = 'block';
  tt.style.left = (e.clientX + 12) + 'px';
  tt.style.top = (e.clientY - 10) + 'px';
}
function hideTT() { tt.style.display = 'none'; }
document.querySelectorAll('[data-tt]').forEach(el => {
  el.addEventListener('mousemove', e => showTT(e, el.dataset.tt));
  el.addEventListener('mouseleave', hideTT);
});
document.querySelectorAll('svg.trace').forEach(svg => {
  const data = JSON.parse(svg.dataset.trace);  // [chain][point]
  const x0 = +svg.dataset.x0, x1 = +svg.dataset.x1;
  const n = data[0].length;
  const cross = svg.querySelector('.cross');
  svg.addEventListener('mousemove', e => {
    const r = svg.getBoundingClientRect();
    const fx = (e.clientX - r.left) / r.width * (x1 - x0) + x0;
    const i = Math.max(0, Math.min(n - 1,
        Math.round((fx - x0) / (x1 - x0) * (n - 1))));
    const px = x0 + i / (n - 1) * (x1 - x0);
    cross.setAttribute('x1', px); cross.setAttribute('x2', px);
    cross.style.display = 'block';
    const draw = svg.dataset.draws ?
        Math.round(i * (+svg.dataset.draws - 1) / (n - 1)) : i;
    let s = 'draw ' + draw;
    data.forEach((c, j) => { s += '<br>chain ' + j + ': ' +
        (+c[i]).toPrecision(4); });
    showTT(e, s);
  });
  svg.addEventListener('mouseleave', () => {
    cross.style.display = 'none'; hideTT();
  });
});
"""


def _fmt(x: float) -> str:
    if not np.isfinite(x):
        return "–"
    ax = abs(x)
    if ax != 0 and (ax < 1e-3 or ax >= 1e5):
        return f"{x:.2e}"
    return f"{x:.3g}"


def _svg_hist(vals: np.ndarray, width=320, height=120, bins=40) -> str:
    counts, edges = np.histogram(vals, bins=bins)
    peak = max(counts.max(), 1)
    pad_l, pad_b = 6, 16
    w = (width - 2 * pad_l) / bins
    parts = [f'<svg width="{width}" height="{height}" role="img">']
    # recessive baseline
    parts.append(
        f'<line x1="{pad_l}" y1="{height-pad_b}" x2="{width-pad_l}" '
        f'y2="{height-pad_b}" stroke="var(--axis)" stroke-width="1"/>'
    )
    for i, c in enumerate(counts):
        if c == 0:
            continue
        h = (height - pad_b - 6) * c / peak
        x = pad_l + i * w
        tt = (f"[{_fmt(edges[i])}, {_fmt(edges[i+1])}): {int(c)}")
        parts.append(
            f'<rect x="{x+1:.1f}" y="{height-pad_b-h:.1f}" '
            f'width="{max(w-2, 1):.1f}" height="{h:.1f}" rx="1.5" '
            f'fill="var(--s1)" data-tt="{html.escape(tt)}"/>'
        )
    parts.append(
        f'<text x="{pad_l}" y="{height-3}">{_fmt(edges[0])}</text>'
        f'<text x="{width-pad_l}" y="{height-3}" text-anchor="end">'
        f"{_fmt(edges[-1])}</text></svg>"
    )
    return "".join(parts)


def _svg_trace(chains: np.ndarray, width=420, height=120,
               max_points=400) -> str:
    """chains: [C, S] (already capped to <=4 chains)."""
    c, s = chains.shape
    stride = max(1, s // max_points)
    ds = chains[:, ::stride]
    n = ds.shape[1]
    lo, hi = float(np.min(ds)), float(np.max(ds))
    if hi - lo < 1e-12:
        hi = lo + 1.0
    pad_l, pad_b = 6, 16
    x0, x1 = pad_l, width - pad_l
    import json

    def ys(v):
        return (height - pad_b) - (height - pad_b - 6) * (v - lo) / (hi - lo)

    parts = [
        f'<svg class="trace" width="{width}" height="{height}" role="img" '
        f'data-trace="{html.escape(json.dumps([[round(float(v), 5) for v in row] for row in ds]))}" '
        f'data-x0="{x0}" data-x1="{x1}" data-draws="{s}">'
    ]
    for gy in (0.25, 0.5, 0.75):
        yy = (height - pad_b) * gy
        parts.append(
            f'<line x1="{x0}" y1="{yy:.1f}" x2="{x1}" y2="{yy:.1f}" '
            f'stroke="var(--grid)" stroke-width="1"/>'
        )
    for j in range(c):
        pts = " ".join(
            f"{x0 + i*(x1-x0)/max(n-1,1):.1f},{ys(ds[j, i]):.1f}"
            for i in range(n)
        )
        parts.append(
            f'<polyline points="{pts}" fill="none" '
            f'stroke="var(--s{j+1})" stroke-width="2" opacity="0.9"/>'
        )
    parts.append(
        f'<line class="cross" x1="0" x2="0" y1="4" y2="{height-pad_b}" '
        f'stroke="var(--axis)" stroke-width="1" style="display:none"/>'
    )
    parts.append(
        f'<text x="{x0}" y="{height-3}">0</text>'
        f'<text x="{x1}" y="{height-3}" text-anchor="end">{s}</text></svg>'
    )
    return "".join(parts)


def export_dashboard_html(
    result,
    path: str,
    variables: Optional[Sequence[str]] = None,
    title: str = "Posterior dashboard",
    max_panels: int = 24,
    max_trace_chains: int = 4,
) -> str:
    """Write a self-contained HTML dashboard for an MCMCResult (or a
    ``{name: [chains, draws, ...]}`` dict); returns the path.

    Per flattened coordinate: draw histogram (pooled), per-chain trace
    (first ``max_trace_chains`` chains, crosshair tooltip), and a stats
    table (mean, sd, q5/q95, ESS, R-hat) — the table view that backs the
    charts.  Header tiles summarize the run.
    """
    if hasattr(result, "samples"):
        samples: Dict[str, np.ndarray] = {k: _host(v) for k, v in result.samples.items()}
        diag = getattr(result, "diagnostics", {}) or {}
    else:
        samples = {k: _host(v) for k, v in dict(result).items()}
        diag = {}
    if variables:
        samples = {k: samples[k] for k in variables}

    from .inference.diagnostics import (
        effective_sample_size, potential_scale_reduction,
    )

    panels = []
    stats_rows = []
    n_done = 0
    truncated = []
    header = None
    for name, arr in samples.items():
        if arr.ndim == 1:
            arr = arr[None, :]
        c, s = arr.shape[0], arr.shape[1]
        if header is None:
            header = (c, s)
        flat = arr.reshape(c, s, -1)
        ess_d = diag.get("ess", {}).get(name)
        rhat_d = diag.get("r_hat", {}).get(name)
        ess_d = None if ess_d is None else np.atleast_1d(np.asarray(ess_d)).ravel()
        rhat_d = None if rhat_d is None else np.atleast_1d(np.asarray(rhat_d)).ravel()
        for j in range(flat.shape[2]):
            if n_done >= max_panels:
                truncated.append(name)
                break
            col = flat[:, :, j]
            label = name if flat.shape[2] == 1 else f"{name}[{j}]"
            pooled = col.ravel()
            ess = float(ess_d[j]) if ess_d is not None else float(
                effective_sample_size(col))
            rhat = float(rhat_d[j]) if rhat_d is not None else float(
                potential_scale_reduction(col))
            mean, sd = float(pooled.mean()), float(pooled.std())
            q5, q95 = (float(np.percentile(pooled, q)) for q in (5, 95))
            stats_rows.append(
                f"<tr><td>{html.escape(label)}</td><td>{_fmt(mean)}</td>"
                f"<td>{_fmt(sd)}</td><td>{_fmt(q5)}</td><td>{_fmt(q95)}</td>"
                f"<td>{_fmt(ess)}</td><td>{rhat:.3f}</td></tr>"
            )
            tr = col[:max_trace_chains]
            legend = "".join(
                f'<span><span class="chip" style="background:var(--s{i+1})">'
                f"</span>chain {i}</span>"
                for i in range(tr.shape[0])
            ) if tr.shape[0] > 1 else ""
            panels.append(
                f'<div class="panel"><h2>{html.escape(label)}</h2>'
                f'<div class="row"><div>{_svg_hist(pooled)}</div>'
                f"<div>{_svg_trace(tr)}"
                + (f'<div class="legend">{legend}</div>' if legend else "")
                + "</div></div></div>"
            )
            n_done += 1

    c, s = header if header else (0, 0)
    tiles = [("chains", f"{c}"), ("draws", f"{s}")]
    for k, lab, fmt in (
        ("mean_accept_prob", "accept", lambda v: f"{float(v):.3f}"),
        ("num_divergences", "divergences", lambda v: f"{int(v)}"),
        ("step_size", "step size", lambda v: _fmt(float(_host(v).ravel()[0]))),
    ):
        if k in diag:
            tiles.append((lab, fmt(diag[k])))
    tiles_html = "".join(
        f'<div class="tile"><div class="v">{v}</div><div class="l">{l}</div></div>'
        for l, v in tiles
    )
    trunc_note = (
        f'<p class="sub">… {len(truncated)} variable(s) truncated at '
        f"max_panels={max_panels}: {', '.join(sorted(set(truncated)))}</p>"
        if truncated else ""
    )

    doc = f"""<!doctype html>
<html><head><meta charset="utf-8"><title>{html.escape(title)}</title>
<style>{_CSS}</style></head>
<body class="viz-root">
<h1>{html.escape(title)}</h1>
<p class="sub">brancher_torch MCMC run · histogram = pooled draws ·
trace = first {max_trace_chains} chains</p>
<div class="tiles">{tiles_html}</div>
{''.join(panels)}
{trunc_note}
<h2>Summary table</h2>
<table class="stats"><tr><th>variable</th><th>mean</th><th>sd</th>
<th>q5</th><th>q95</th><th>ESS</th><th>R-hat</th></tr>
{''.join(stats_rows)}</table>
<div id="tt"></div>
<script>{_JS}</script>
</body></html>"""
    with open(path, "w") as f:
        f.write(doc)
    return path
