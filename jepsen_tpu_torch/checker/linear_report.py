"""SVG rendering of a failed linearization analysis
(capability parallel of knossos.linear.report/render-analysis!, invoked
by the reference at jepsen/src/jepsen/checker.clj:203-207 to produce
linear.svg when a linearizability check fails).

Layout: time flows left to right; one horizontal lane per process; each
op is a rounded bar spanning invoke → completion. The counterexample op
(analysis["op"]) is outlined red. Each final-path (a maximal
linearization attempt, [{"op": .., "model": ..}, ...]) is drawn as a
colored polyline threading the linearized ops in order, its model state
annotated at every hop, ending at the point where no continuation was
legal.

A copy of `jepsen_tpu.checker.linear_report`; the store it writes into
is duck-typed (`write_file(parts, text)`, `path(*parts)`)."""

from __future__ import annotations

import html as _html
from typing import Dict, List, Optional

BAR_H = 22
LANE_GAP = 14
LEFT = 110
RIGHT_PAD = 40
TOP = 50
TIME_W = 760

TYPE_FILL = {"ok": "#6DB6FE", "info": "#FFAA26", "fail": "#FEB5DA"}
PATH_COLORS = ("#d62728", "#9467bd", "#2ca02c", "#ff7f0e", "#17becf",
               "#8c564b", "#e377c2")


def _esc(s) -> str:
    return _html.escape(str(s))


def _pairs(history) -> List[dict]:
    """[{invoke, completion?}] spans in invocation order."""
    spans, open_by_p = [], {}
    for op in history:
        t, p = op.get("type"), op.get("process")
        if t == "invoke":
            span = {"invoke": op, "completion": None}
            open_by_p[p] = span
            spans.append(span)
        elif t in ("ok", "fail", "info") and p in open_by_p:
            open_by_p.pop(p)["completion"] = op
    return spans


def render_analysis(history, analysis: Dict,
                    title: str = "linearizability analysis") -> str:
    """The SVG document for a (typically failed) analysis."""
    spans = _pairs(history)
    if not spans:
        return ('<svg xmlns="http://www.w3.org/2000/svg" width="400" '
                'height="60"><text x="10" y="30">empty history</text></svg>')

    times = [s["invoke"].get("time") or 0 for s in spans] + \
            [s["completion"].get("time") or 0 for s in spans
             if s["completion"] is not None]
    t0, t1 = min(times), max(times)
    t1 = t1 if t1 > t0 else t0 + 1

    def sx(t) -> float:
        return LEFT + (t - t0) / (t1 - t0) * TIME_W

    procs: List = []
    for s in spans:
        p = s["invoke"].get("process")
        if p not in procs:
            procs.append(p)
    lane = {p: i for i, p in enumerate(procs)}

    def sy(p) -> float:
        return TOP + lane[p] * (BAR_H + LANE_GAP)

    height = TOP + len(procs) * (BAR_H + LANE_GAP) + 60
    width = LEFT + TIME_W + RIGHT_PAD
    bad_index = (analysis.get("op") or {}).get("index")

    svg = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
           f'height="{height}" viewBox="0 0 {width} {height}" '
           f'font-family="Helvetica,Arial,sans-serif" font-size="11">',
           f'<rect width="{width}" height="{height}" fill="white"/>',
           f'<text x="{LEFT}" y="24" font-size="14">{_esc(title)}</text>']

    for p in procs:
        svg.append(f'<text x="8" y="{sy(p) + BAR_H / 2 + 4:.0f}">'
                   f'process {_esc(p)}</text>')

    # op bars; remember each op's anchor point for path polylines
    anchor: Dict[int, tuple] = {}
    for s in spans:
        inv, comp = s["invoke"], s["completion"]
        x0 = sx(inv.get("time") or 0)
        x1 = sx(comp.get("time") or t1) if comp is not None \
            else LEFT + TIME_W
        y = sy(inv.get("process"))
        fill = TYPE_FILL.get((comp or {}).get("type"), "#eeeeee")
        idx = inv.get("index")
        is_bad = bad_index is not None and idx == bad_index
        stroke = ' stroke="#d00000" stroke-width="2"' if is_bad \
            else ' stroke="#888888" stroke-width="0.5"'
        svg.append(f'<rect x="{x0:.1f}" y="{y:.1f}" '
                   f'width="{max(3.0, x1 - x0):.1f}" height="{BAR_H}" '
                   f'rx="3" fill="{fill}"{stroke}/>')
        val = inv.get("value")
        if comp is not None and comp.get("value") != val and \
                comp.get("value") is not None:
            label = f"{inv.get('f')} {val!r} → {comp.get('value')!r}"
        else:
            label = f"{inv.get('f')} {val!r}"
        svg.append(f'<text x="{x0 + 3:.1f}" y="{y + BAR_H - 7:.1f}">'
                   f'{_esc(label)}</text>')
        if idx is not None:
            anchor[idx] = ((x0 + min(x1, x0 + 60)) / 2, y + BAR_H / 2)

    # final paths: polylines through linearized ops with model labels
    for i, path in enumerate(analysis.get("final-paths") or []):
        color = PATH_COLORS[i % len(PATH_COLORS)]
        pts, labels = [], []
        for step in path:
            op = step.get("op") or {}
            idx = op.get("index")
            if idx in anchor:
                x, y = anchor[idx]
                x += i * 3  # de-overlap concurrent paths slightly
                pts.append((x, y))
                labels.append((x, y, step.get("model")))
        if len(pts) >= 2:
            d = "M" + "L".join(f"{x:.1f} {y:.1f}" for x, y in pts)
            svg.append(f'<path d="{d}" fill="none" stroke="{color}" '
                       f'stroke-width="1.5" stroke-opacity="0.8"/>')
        for x, y, model in labels:
            if model is not None:
                svg.append(f'<text x="{x + 4:.1f}" y="{y - 4:.1f}" '
                           f'fill="{color}" font-size="9">'
                           f'{_esc(model)}</text>')
        if pts:
            x, y = pts[-1]
            svg.append(f'<circle cx="{x:.1f}" cy="{y:.1f}" r="4" '
                       f'fill="none" stroke="{color}" stroke-width="2"/>')

    if bad_index is not None:
        svg.append(f'<text x="{LEFT}" y="{height - 14}" fill="#d00000">'
                   f'No legal linearization past op {bad_index} '
                   f'({_esc((analysis.get("op") or {}).get("f"))} '
                   f'{_esc((analysis.get("op") or {}).get("value"))})'
                   f'</text>')
    svg.append("</svg>")
    return "\n".join(svg)


def render_analysis_file(history, analysis: Dict, test: Optional[dict],
                         opts: Optional[dict] = None) -> Optional[str]:
    """Write linear.svg into the test store, as the reference does on
    failure (checker.clj:203-207). Returns the path, or None without a
    store."""
    store = (test or {}).get("store")
    if store is None:
        return None
    sub = (opts or {}).get("subdirectory")
    parts = [sub, "linear.svg"] if sub else ["linear.svg"]
    store.write_file(parts, render_analysis(history, analysis))
    return store.path(*parts)
