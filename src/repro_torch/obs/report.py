"""``python -m repro_torch.obs.report`` — text report over a saved trace.

Renders the two views the paper's tail-latency story needs from a
``TraceRecorder`` JSONL export (``repro_torch.experiments.run --trace``):

  * **phase breakdown** — host-clock span totals by name (calls, total
    seconds, mean, share), so "where does per-step time go" (encode vs
    solve vs sampling) is one glance;
  * **straggler timeline** — per (cell, realization) lane group: per-worker
    miss counts with a bar chart, active-set-size stats, and the first
    iterations as an ASCII lane diagram (``#`` active, ``.`` erased);
  * **async summary** — staleness histogram + drop/clamp counts for
    per-arrival cells;
  * **fault timeline** — for fault-injected runs (``--faults``): per-kind
    event counts (crash / blackout / corrupt), the failed-entry share of
    the (iteration, worker) grid, and the first fault events in time
    order.

  * ``--html OUT.html`` — the same views as one self-contained HTML page
    (inline CSS, no external assets): phase-breakdown table, per-worker
    miss-rate bar charts, lane diagrams, staleness histograms — plus a
    cross-run comparison table when ``--compare RUN_A RUN_B`` references
    two stored runs (see ``repro_torch.obs.runstore``).

    PYTHONPATH=src python -m repro_torch.obs.report runs/exp/trace.jsonl \\
        [--max-steps 24] [--cell SUBSTR] [--html report.html] \\
        [--compare latest latest~1]
"""
from __future__ import annotations

import argparse
import html as _html
import os
from collections import defaultdict
from typing import Sequence

import numpy as np

from .trace import TraceRecorder

__all__ = ["phase_breakdown", "render_report", "render_html_report",
           "main"]

_BAR = 28


def _bar(frac: float, width: int = _BAR) -> str:
    n = int(round(max(0.0, min(1.0, frac)) * width))
    return "#" * n + "." * (width - n)


def phase_breakdown(events) -> list[tuple]:
    """Aggregate span events by name -> sorted [(name, calls, total_s,
    mean_s, share)] rows (share of the summed span time; spans nest, so
    shares can exceed 1 in total)."""
    agg: dict = defaultdict(lambda: [0, 0.0])
    for ev in events:
        if ev.kind == "span":
            agg[ev.name][0] += 1
            agg[ev.name][1] += ev.dur
    total = sum(v[1] for v in agg.values()) or 1.0
    rows = [(name, calls, secs, secs / calls, secs / total)
            for name, (calls, secs) in agg.items()]
    return sorted(rows, key=lambda r: -r[2])


def _lane_groups(events) -> dict:
    """(cell, realization) -> {"iter": [...], "worker": [...], ...}."""
    groups: dict = defaultdict(lambda: defaultdict(list))
    for ev in events:
        if ev.kind in ("iter", "worker", "update", "instant"):
            groups[(ev.cell, ev.realization)][ev.kind].append(ev)
    return groups


def _render_sync_group(out, iters, workers, max_steps: int) -> None:
    m = 1 + max(int(ev.lane.split(":", 1)[1]) for ev in workers)
    steps = sorted({ev.step for ev in iters})
    active = np.zeros((len(steps), m), dtype=bool)
    index = {t: j for j, t in enumerate(steps)}
    for ev in workers:
        active[index[ev.step], int(ev.lane.split(":", 1)[1])] = \
            bool(ev.args.get("active", True))
    miss = 1.0 - active.mean(axis=0)
    sizes = active.sum(axis=1)
    durs = [ev.dur for ev in iters]
    out.append(f"  iterations={len(steps)} workers={m} "
               f"active_size mean={sizes.mean():.2f} "
               f"min={sizes.min()} max={sizes.max()}")
    out.append(f"  step latency s: p50={np.percentile(durs, 50):.4f} "
               f"p95={np.percentile(durs, 95):.4f} "
               f"p99={np.percentile(durs, 99):.4f}")
    out.append("  per-worker miss-rate:")
    for i in range(m):
        out.append(f"    worker {i:3d} {_bar(miss[i])} {miss[i]:6.1%}")
    shown = steps[:max_steps]
    out.append(f"  lanes (first {len(shown)} iterations; # active, "
               f". erased):")
    for t in shown:
        row = "".join("#" if active[index[t], i] else "."
                      for i in range(m))
        out.append(f"    iter {t:4d} |{row}|")


def _fault_summary(workers, instants):
    """Fault view of one lane group: per-kind event counts, the event
    timeline, and the failed-entry share of the (iteration, worker) grid.
    Everything is empty when the trace carries no fault lane."""
    events = [ev for ev in instants if ev.name.startswith("fault:")]
    counts: dict = {}
    for ev in events:
        kind = ev.args.get("fault", ev.name.split(":", 1)[1])
        counts[kind] = counts.get(kind, 0) + 1
    frac: dict = {}
    if workers:
        by_kind: dict = {}
        for ev in workers:
            code = ev.args.get("failed")
            if code is not None:
                by_kind[code] = by_kind.get(code, 0) + 1
        frac = {k: v / len(workers) for k, v in sorted(by_kind.items())}
    return counts, events, frac


def _render_fault_group(out, workers, instants, max_events: int = 12) -> None:
    counts, events, frac = _fault_summary(workers, instants)
    if not counts and not frac:
        return
    head = " ".join(f"{k}={v}" for k, v in sorted(counts.items()))
    out.append(f"  faults: {head or '(failed codes only)'}")
    if frac:
        out.append("  failed share of (iteration, worker) grid: "
                   + " ".join(f"{k}={v:.1%}" for k, v in frac.items()))
    for ev in sorted(events, key=lambda e: e.ts)[:max_events]:
        dur = ev.args.get("duration_s")
        tail = f" dur={dur:.2f}s" if dur else ""
        out.append(f"    t={ev.ts:8.3f} {ev.lane:10s} "
                   f"{ev.args.get('fault', ev.name)}{tail}")
    if len(events) > max_events:
        out.append(f"    ... {len(events) - max_events} more fault events")


def _render_async_group(out, updates, instants) -> None:
    stale = np.asarray([ev.args.get("staleness", 0) for ev in updates])
    out.append(f"  updates={stale.size} mean_staleness={stale.mean():.2f} "
               f"max={stale.max()}")
    vals, cnts = np.unique(stale, return_counts=True)
    peak = cnts.max()
    out.append("  staleness histogram:")
    for v, c in zip(vals, cnts):
        out.append(f"    tau={int(v):3d} {_bar(c / peak)} {int(c)}")
    for ev in instants:
        if ev.name == "async-summary":
            out.append(f"  dropped={ev.args.get('dropped', 0)} "
                       f"staleness_clamped="
                       f"{ev.args.get('staleness_clamped', 0)}")


def render_report(rec: TraceRecorder, *, max_steps: int = 24,
                  cell: str | None = None) -> str:
    """The full text report for a loaded trace."""
    events = rec.events()
    out: list[str] = []
    if rec.meta:
        out.append(f"trace meta: {rec.meta}")
    rows = phase_breakdown(events)
    if rows:
        out.append("")
        out.append("phase breakdown (host spans):")
        out.append(f"  {'phase':24s} {'calls':>6s} {'total_s':>10s} "
                   f"{'mean_ms':>9s} {'share':>7s}")
        for name, calls, secs, mean, share in rows:
            out.append(f"  {name:24s} {calls:6d} {secs:10.4f} "
                       f"{mean * 1e3:9.3f} {share:7.1%}")
    for (cell_name, r), kinds in sorted(
            _lane_groups(events).items(),
            key=lambda kv: (str(kv[0][0]), kv[0][1])):
        if cell is not None and cell not in str(cell_name):
            continue
        out.append("")
        out.append(f"straggler timeline — cell={cell_name or 'run'} "
                   f"realization={r}")
        if kinds.get("iter"):
            _render_sync_group(out, kinds["iter"], kinds.get("worker", []),
                               max_steps)
        if kinds.get("update"):
            _render_async_group(out, kinds["update"],
                                kinds.get("instant", []))
        _render_fault_group(out, kinds.get("worker", []),
                            kinds.get("instant", []))
    if len(out) <= 1 and not rows:
        out.append("(trace contains no span or simulation events)")
    return "\n".join(out)


# ---------------------------------------------------------------------------
# HTML export
# ---------------------------------------------------------------------------

def _html_bar(frac: float, *, miss: bool = False,
              width: int = 160) -> str:
    px = int(round(max(0.0, min(1.0, frac)) * width))
    cls = "bar miss" if miss else "bar"
    return f"<span class='{cls}' style='width:{px}px'></span>"


def _html_phase_section(rows) -> str:
    body = "".join(
        f"<tr><td>{_html.escape(name)}</td><td>{calls}</td>"
        f"<td>{secs:.4f}</td><td>{mean * 1e3:.3f}</td>"
        f"<td>{_html_bar(share)} {share:.1%}</td></tr>"
        for name, calls, secs, mean, share in rows)
    return ("<h2>phase breakdown (host spans)</h2>"
            "<table><tr><th>phase</th><th>calls</th><th>total_s</th>"
            "<th>mean_ms</th><th>share</th></tr>" + body + "</table>")


def _html_sync_group(iters, workers, max_steps: int) -> str:
    m = 1 + max(int(ev.lane.split(":", 1)[1]) for ev in workers)
    steps = sorted({ev.step for ev in iters})
    active = np.zeros((len(steps), m), dtype=bool)
    index = {t: j for j, t in enumerate(steps)}
    for ev in workers:
        active[index[ev.step], int(ev.lane.split(":", 1)[1])] = \
            bool(ev.args.get("active", True))
    miss = 1.0 - active.mean(axis=0)
    sizes = active.sum(axis=1)
    durs = [ev.dur for ev in iters]
    out = [f"<p>iterations={len(steps)} workers={m} "
           f"active_size mean={sizes.mean():.2f} min={sizes.min()} "
           f"max={sizes.max()} &middot; step latency s: "
           f"p50={np.percentile(durs, 50):.4f} "
           f"p95={np.percentile(durs, 95):.4f} "
           f"p99={np.percentile(durs, 99):.4f}</p>",
           "<table><tr><th>worker</th><th>miss-rate</th></tr>"]
    out += [f"<tr><td>{i}</td><td>{_html_bar(miss[i], miss=True)} "
            f"{miss[i]:.1%}</td></tr>" for i in range(m)]
    out.append("</table>")
    shown = steps[:max_steps]
    lanes = "\n".join(
        f"iter {t:4d} |" + "".join("#" if active[index[t], i] else "."
                                   for i in range(m)) + "|"
        for t in shown)
    out.append(f"<p>lanes (first {len(shown)} iterations; # active, "
               f". erased):</p><pre class='lanes'>{lanes}</pre>")
    return "".join(out)


def _html_async_group(updates, instants) -> str:
    stale = np.asarray([ev.args.get("staleness", 0) for ev in updates])
    vals, cnts = np.unique(stale, return_counts=True)
    peak = cnts.max()
    out = [f"<p>updates={stale.size} "
           f"mean_staleness={stale.mean():.2f} max={stale.max()}</p>",
           "<table><tr><th>staleness &tau;</th><th>count</th></tr>"]
    out += [f"<tr><td>{int(v)}</td><td>{_html_bar(c / peak)} {int(c)}"
            f"</td></tr>" for v, c in zip(vals, cnts)]
    out.append("</table>")
    for ev in instants:
        if ev.name == "async-summary":
            out.append(f"<p>dropped={ev.args.get('dropped', 0)} "
                       f"staleness_clamped="
                       f"{ev.args.get('staleness_clamped', 0)}</p>")
    return "".join(out)


def _html_fault_group(workers, instants, max_events: int = 12) -> str:
    counts, events, frac = _fault_summary(workers, instants)
    if not counts and not frac:
        return ""
    head = " ".join(f"{_html.escape(str(k))}={v}"
                    for k, v in sorted(counts.items()))
    out = [f"<p><b>faults:</b> {head or '(failed codes only)'}</p>"]
    if frac:
        out.append("<table><tr><th>failed code</th><th>share of "
                   "(iteration, worker) grid</th></tr>")
        out += [f"<tr><td>{_html.escape(str(k))}</td>"
                f"<td>{_html_bar(v, miss=True)} {v:.1%}</td></tr>"
                for k, v in frac.items()]
        out.append("</table>")
    if events:
        rows = "".join(
            f"<tr><td>{ev.ts:.3f}</td><td>{_html.escape(ev.lane)}</td>"
            f"<td>{_html.escape(str(ev.args.get('fault', ev.name)))}</td>"
            f"<td>{ev.args.get('duration_s', '')}</td></tr>"
            for ev in sorted(events, key=lambda e: e.ts)[:max_events])
        out.append("<table><tr><th>t (sim s)</th><th>lane</th>"
                   "<th>fault</th><th>duration_s</th></tr>"
                   + rows + "</table>")
        if len(events) > max_events:
            out.append(f"<p><small>... {len(events) - max_events} more "
                       f"fault events</small></p>")
    return "".join(out)


def render_html_report(rec: TraceRecorder, *, max_steps: int = 24,
                       cell: str | None = None,
                       extra_sections: list[str] | None = None) -> str:
    """One self-contained HTML page with the same views as the text
    report (plus optional pre-rendered extra sections, e.g. a cross-run
    comparison table from ``repro_torch.obs.analyze``)."""
    from .analyze import render_html_page
    events = rec.events()
    sections: list[str] = []
    if rec.meta:
        sections.append(
            f"<p><small>trace meta: {_html.escape(str(rec.meta))}"
            f"</small></p>")
    rows = phase_breakdown(events)
    if rows:
        sections.append(_html_phase_section(rows))
    for (cell_name, r), kinds in sorted(
            _lane_groups(events).items(),
            key=lambda kv: (str(kv[0][0]), kv[0][1])):
        if cell is not None and cell not in str(cell_name):
            continue
        sections.append(f"<h2>straggler timeline — "
                        f"cell={_html.escape(str(cell_name or 'run'))} "
                        f"realization={r}</h2>")
        if kinds.get("iter"):
            sections.append(_html_sync_group(
                kinds["iter"], kinds.get("worker", []), max_steps))
        if kinds.get("update"):
            sections.append(_html_async_group(kinds["update"],
                                              kinds.get("instant", [])))
        fault_html = _html_fault_group(kinds.get("worker", []),
                                       kinds.get("instant", []))
        if fault_html:
            sections.append(fault_html)
    if not sections:
        sections.append("<p>(trace contains no span or simulation "
                        "events)</p>")
    sections.extend(extra_sections or [])
    return render_html_page("repro straggler report", sections)


def _compare_section(refs: list[str]) -> str:
    """Cross-run comparison table for two stored-run references."""
    from .analyze import diff_manifests
    from .runstore import default_store
    store = default_store()
    if store is None:
        raise SystemExit("--compare needs an enabled run store "
                         "(REPRO_RUNSTORE)")
    a, b = (store.resolve(r) for r in refs)
    rep = diff_manifests(a, b, a_label=a.get("run_id", refs[0]),
                         b_label=b.get("run_id", refs[1]))
    return rep.render_html_section()


def main(argv: Sequence[str] | None = None) -> str:
    ap = argparse.ArgumentParser(
        prog="repro_torch.obs.report",
        description="straggler-timeline + phase-breakdown report from a "
                    "saved obs trace (JSONL)")
    ap.add_argument("trace", help="path to a TraceRecorder JSONL export")
    ap.add_argument("--max-steps", type=int, default=24,
                    help="iterations to draw per lane diagram")
    ap.add_argument("--cell", default=None,
                    help="only render timelines whose cell label contains "
                         "this substring")
    ap.add_argument("--html", default=None, metavar="OUT",
                    help="also write the report as one self-contained "
                         "HTML page")
    ap.add_argument("--compare", nargs=2, default=None,
                    metavar=("RUN_A", "RUN_B"),
                    help="embed a cross-run comparison table for two "
                         "stored-run references (HTML output only)")
    args = ap.parse_args(argv)
    rec = TraceRecorder.load(args.trace)
    text = render_report(rec, max_steps=args.max_steps, cell=args.cell)
    print(text)
    if args.html:
        extra = [_compare_section(args.compare)] if args.compare else None
        page = render_html_report(rec, max_steps=args.max_steps,
                                  cell=args.cell, extra_sections=extra)
        d = os.path.dirname(args.html)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(args.html, "w") as f:
            f.write(page)
        print(f"wrote html report to {args.html}")
    return text


if __name__ == "__main__":
    main()
