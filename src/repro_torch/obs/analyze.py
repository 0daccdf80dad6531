"""Cross-run analytics: align two runs cell-by-cell, gate on regressions.

The comparison layer over :mod:`repro_torch.obs.runstore` (DESIGN.md §13):

  * :func:`cell_key` / :func:`summarize_records` — the identity of one
    matrix cell (workload, preset, strategy, delay, problem shape,
    trials, seed) and the compact per-cell summary a manifest stores;
  * :func:`diff_manifests` — align two manifests (or raw record lists)
    by cell key and compute wall-clock ratios + convergence deltas;
  * :func:`diff_bench` — align two ``BENCH_*.json`` trees by path and
    compare every time-like leaf (``*_s``, ``us_*``, ``seconds*``);
  * :class:`DiffReport` — the result: per-cell :class:`CellDelta` rows,
    regression list, exit code (0 clean / 1 regression), text and HTML
    renderings.  ``python -m repro_torch.obs.diff`` is the CLI front-end the
    CI bench-regression gate calls.

Gating semantics: a cell regresses when its wall-clock ratio
``b / a`` exceeds ``Thresholds.wallclock_ratio`` (and the absolute delta
exceeds ``min_seconds``, so micro-cells don't flag on timer noise), or
when ``final_objective`` — lower is better for every workload — worsens
by more than ``metric_rel`` relative.  ``final_metric`` deltas are
reported but never gated (metric direction is workload-specific).
"""
from __future__ import annotations

import dataclasses
import html as _html

__all__ = [
    "CELL_KEY_FIELDS", "cell_key", "summarize_records", "Thresholds",
    "CellDelta", "DiffReport", "diff_manifests", "diff_bench",
    "flatten_bench", "render_html_page",
]


CELL_KEY_FIELDS = ("workload", "preset", "strategy", "delay", "n", "p",
                   "m", "k", "trials", "seed")


def cell_key(rec: dict) -> tuple:
    """The alignment identity of one cell record/summary."""
    return tuple(rec.get(f) for f in CELL_KEY_FIELDS)


def _label(rec: dict) -> str:
    parts = []
    if rec.get("workload"):
        parts.append(str(rec["workload"]))
    parts.append(str(rec.get("strategy", "?")))
    parts.append(str(rec.get("delay", "?")))
    return "x".join(parts)


_SUMMARY_FIELDS = ("metric_name", "final_metric", "final_objective",
                   "wallclock_s", "host_s", "compile_s", "execute_s",
                   "compiles", "skipped")


def summarize_records(records) -> list[dict]:
    """Compact per-cell summaries for a manifest: the cell key fields plus
    wall-clock / convergence scalars — no traces (manifests stay small;
    artifact paths point at the full records)."""
    out = []
    for rec in records:
        row = {f: rec.get(f) for f in CELL_KEY_FIELDS if f in rec}
        row.update({f: rec[f] for f in _SUMMARY_FIELDS if f in rec})
        obs = rec.get("obs") or {}
        tail = (obs.get("schedule") or obs.get("async") or {}) \
            .get("delay_tail")
        if tail:
            row["delay_tail_p99_max"] = tail.get("p99_max")
        out.append(row)
    return out


@dataclasses.dataclass(frozen=True)
class Thresholds:
    """Regression gate configuration (all CLI-overridable)."""
    wallclock_ratio: float = 1.5   # flag when b/a exceeds this
    metric_rel: float = 0.25       # relative final_objective worsening
    min_seconds: float = 1e-3      # absolute slack below which time noise
    #                                never flags

    def validate(self) -> None:
        if self.wallclock_ratio <= 0:
            raise ValueError("wallclock_ratio must be > 0")


@dataclasses.dataclass
class CellDelta:
    """One aligned comparison row (a = reference, b = candidate)."""
    label: str
    key: tuple
    wallclock_a: float | None = None
    wallclock_b: float | None = None
    ratio: float | None = None
    objective_a: float | None = None
    objective_b: float | None = None
    objective_rel: float | None = None
    status: str = "ok"             # ok | regression | improved | skipped
    reasons: list = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["key"] = list(self.key)
        return d


@dataclasses.dataclass
class DiffReport:
    """The aligned diff of two runs; exit-code gated for CI."""
    kind: str                      # "run" | "bench"
    a_label: str
    b_label: str
    thresholds: Thresholds
    deltas: list = dataclasses.field(default_factory=list)
    unmatched_a: list = dataclasses.field(default_factory=list)
    unmatched_b: list = dataclasses.field(default_factory=list)
    notes: list = dataclasses.field(default_factory=list)

    @property
    def regressions(self) -> list:
        return [d for d in self.deltas if d.status == "regression"]

    @property
    def exit_code(self) -> int:
        return 1 if self.regressions else 0

    def to_dict(self) -> dict:
        return {
            "kind": self.kind, "a": self.a_label, "b": self.b_label,
            "thresholds": dataclasses.asdict(self.thresholds),
            "deltas": [d.to_dict() for d in self.deltas],
            "unmatched_a": self.unmatched_a,
            "unmatched_b": self.unmatched_b,
            "notes": self.notes,
            "regressions": len(self.regressions),
            "exit_code": self.exit_code,
        }

    # -- renderings ------------------------------------------------------

    def render_text(self) -> str:
        out = [f"{self.kind} diff: {self.a_label} -> {self.b_label}"]
        out += [f"  note: {n}" for n in self.notes]
        if self.deltas:
            out.append(f"  {'cell':40s} {'a':>12s} {'b':>12s} "
                       f"{'ratio':>7s} {'obj delta':>10s} status")
        for d in self.deltas:
            ratio = f"{d.ratio:.2f}x" if d.ratio is not None else "-"
            rel = (f"{d.objective_rel:+.1%}"
                   if d.objective_rel is not None else "-")
            wa = f"{d.wallclock_a:.4g}" if d.wallclock_a is not None else "-"
            wb = f"{d.wallclock_b:.4g}" if d.wallclock_b is not None else "-"
            line = (f"  {d.label:40s} {wa:>12s} {wb:>12s} {ratio:>7s} "
                    f"{rel:>10s} {d.status}")
            if d.reasons:
                line += f"  ({'; '.join(d.reasons)})"
            out.append(line)
        for side, keys in (("a", self.unmatched_a), ("b", self.unmatched_b)):
            if keys:
                out.append(f"  only in {side}: "
                           + ", ".join(str(k) for k in keys))
        n = len(self.regressions)
        if n:
            out.append(f"RESULT: REGRESSION ({n} of {len(self.deltas)} "
                       f"compared)")
        else:
            out.append(f"RESULT: OK ({len(self.deltas)} compared, "
                       f"0 regressions)")
        return "\n".join(out)

    def render_html_section(self) -> str:
        rows = []
        for d in self.deltas:
            cls = {"regression": "bad", "improved": "good"}.get(d.status,
                                                                "")
            ratio = f"{d.ratio:.2f}x" if d.ratio is not None else "–"
            rel = (f"{d.objective_rel:+.1%}"
                   if d.objective_rel is not None else "–")
            wa = f"{d.wallclock_a:.4g}" if d.wallclock_a is not None else "–"
            wb = f"{d.wallclock_b:.4g}" if d.wallclock_b is not None else "–"
            rows.append(
                f"<tr class='{cls}'><td>{_html.escape(d.label)}</td>"
                f"<td>{wa}</td><td>{wb}</td><td>{ratio}</td><td>{rel}</td>"
                f"<td>{d.status}"
                + (f" <small>{_html.escape('; '.join(d.reasons))}</small>"
                   if d.reasons else "")
                + "</td></tr>")
        verdict = (f"<p class='bad'><b>REGRESSION</b>: "
                   f"{len(self.regressions)} cell(s)</p>"
                   if self.regressions else
                   "<p class='good'><b>OK</b>: no regressions</p>")
        notes = "".join(f"<p><small>{_html.escape(n)}</small></p>"
                        for n in self.notes)
        return (
            f"<h2>{self.kind} diff: {_html.escape(self.a_label)} &rarr; "
            f"{_html.escape(self.b_label)}</h2>{notes}{verdict}"
            "<table><tr><th>cell</th><th>a</th><th>b</th><th>ratio</th>"
            "<th>objective &Delta;</th><th>status</th></tr>"
            + "".join(rows) + "</table>")


# ---------------------------------------------------------------------------
# Run-vs-run (manifest / record-list) diff
# ---------------------------------------------------------------------------

def _as_cells(side) -> list[dict]:
    """Manifest dict -> its cell summaries; record list -> summarized."""
    if isinstance(side, dict):
        return list(side.get("cells") or [])
    return summarize_records(side)


def _diff_one(key, a: dict, b: dict, th: Thresholds) -> CellDelta:
    d = CellDelta(label=_label(a or b), key=key)
    if "skipped" in (a or {}) or "skipped" in (b or {}):
        d.status = "skipped"
        d.reasons.append(
            (a or {}).get("skipped") or (b or {}).get("skipped") or "")
        return d
    d.wallclock_a = a.get("wallclock_s")
    d.wallclock_b = b.get("wallclock_s")
    if d.wallclock_a and d.wallclock_b:
        d.ratio = d.wallclock_b / d.wallclock_a
        slow = d.wallclock_b - d.wallclock_a > th.min_seconds
        if d.ratio > th.wallclock_ratio and slow:
            d.status = "regression"
            d.reasons.append(
                f"wallclock {d.ratio:.2f}x > {th.wallclock_ratio:g}x")
        elif d.ratio < 1.0 / th.wallclock_ratio:
            d.status = "improved"
    d.objective_a = a.get("final_objective")
    d.objective_b = b.get("final_objective")
    if d.objective_a is not None and d.objective_b is not None:
        scale = max(abs(d.objective_a), 1e-12)
        d.objective_rel = (d.objective_b - d.objective_a) / scale
        if d.objective_rel > th.metric_rel:
            d.status = "regression"
            d.reasons.append(
                f"final_objective worsened {d.objective_rel:+.1%} "
                f"> {th.metric_rel:.0%}")
    return d


def diff_manifests(a, b, *, thresholds: Thresholds | None = None,
                   a_label: str = "a", b_label: str = "b") -> DiffReport:
    """Align run ``a`` (reference) and ``b`` (candidate) by cell key and
    gate.  Accepts store manifests or raw record lists on either side."""
    th = thresholds or Thresholds()
    th.validate()
    report = DiffReport(kind="run", a_label=a_label, b_label=b_label,
                        thresholds=th)
    if isinstance(a, dict) and isinstance(b, dict):
        ha, hb = a.get("spec_hash"), b.get("spec_hash")
        if ha and hb:
            if ha == hb:
                report.notes.append(f"spec hash match: {ha}")
            else:
                report.notes.append(
                    f"spec hash MISMATCH: {ha} vs {hb} — comparing "
                    f"overlapping cells only")
    cells_a = {cell_key(c): c for c in _as_cells(a)}
    cells_b = {cell_key(c): c for c in _as_cells(b)}
    for key, ca in cells_a.items():
        if key in cells_b:
            report.deltas.append(_diff_one(key, ca, cells_b[key], th))
        else:
            report.unmatched_a.append(_label(ca))
    report.unmatched_b = [_label(cb) for key, cb in cells_b.items()
                          if key not in cells_a]
    if not report.deltas:
        report.notes.append("no cells aligned — are these runs of the "
                            "same spec?")
    return report


# ---------------------------------------------------------------------------
# Bench-baseline diff (BENCH_*.json trees)
# ---------------------------------------------------------------------------

_ID_KEYS = ("case", "name", "placement")


def _time_like(key: str) -> bool:
    return (key.endswith("_s") or key.endswith("_us")
            or key.startswith("us_") or "seconds" in key)


def flatten_bench(doc, prefix: str = "") -> dict:
    """``{dotted.path: value}`` over every time-like numeric leaf of a
    BENCH json tree.  List elements are keyed by their ``case`` / ``name``
    / ``placement`` (+``R``) field when present, by index otherwise, so
    reordered suites still align.  ``meta`` subtrees (provenance stamps)
    are skipped."""
    out: dict = {}
    if isinstance(doc, dict):
        for k, v in doc.items():
            if k == "meta":
                continue
            path = f"{prefix}.{k}" if prefix else str(k)
            if isinstance(v, (dict, list)):
                out.update(flatten_bench(v, path))
            elif isinstance(v, (int, float)) and not isinstance(v, bool) \
                    and _time_like(str(k)):
                out[path] = float(v)
    elif isinstance(doc, list):
        for i, v in enumerate(doc):
            tag = str(i)
            if isinstance(v, dict):
                for idk in _ID_KEYS:
                    if idk in v:
                        tag = str(v[idk])
                        if "R" in v:
                            tag += f"[R{v['R']}]"
                        break
            out.update(flatten_bench(v, f"{prefix}[{tag}]"))
    return out


def diff_bench(a, b, *, thresholds: Thresholds | None = None,
               a_label: str = "baseline", b_label: str = "candidate"
               ) -> DiffReport:
    """Compare candidate ``b`` against baseline ``a``: every time-like
    leaf present in both trees is gated on its ratio (``b / a``)."""
    th = thresholds or Thresholds()
    th.validate()
    report = DiffReport(kind="bench", a_label=a_label, b_label=b_label,
                        thresholds=th)
    fa, fb = flatten_bench(a), flatten_bench(b)
    for path, va in fa.items():
        if path not in fb:
            report.unmatched_a.append(path)
            continue
        vb = fb[path]
        d = CellDelta(label=path, key=(path,), wallclock_a=va,
                      wallclock_b=vb)
        if va > 0:
            d.ratio = vb / va
            # per-leaf units vary (us vs s); min_seconds only guards
            # second-denominated leaves
            slack = th.min_seconds if path.endswith("_s") else 0.0
            if d.ratio > th.wallclock_ratio and vb - va > slack:
                d.status = "regression"
                d.reasons.append(
                    f"{d.ratio:.2f}x > {th.wallclock_ratio:g}x")
            elif d.ratio < 1.0 / th.wallclock_ratio:
                d.status = "improved"
        report.deltas.append(d)
    report.unmatched_b = [p for p in fb if p not in fa]
    if not report.deltas:
        report.notes.append("no overlapping time-like leaves")
    return report


# ---------------------------------------------------------------------------
# Shared HTML page scaffold
# ---------------------------------------------------------------------------

_CSS = """
body { font: 14px/1.45 system-ui, sans-serif; margin: 2em auto;
       max-width: 70em; color: #1a1a2e; padding: 0 1em; }
h1, h2 { font-weight: 600; }
table { border-collapse: collapse; margin: 1em 0; width: 100%; }
th, td { border: 1px solid #d8d8e0; padding: .3em .6em;
         text-align: left; font-variant-numeric: tabular-nums; }
th { background: #f2f2f7; }
tr.bad td { background: #fdecec; }
tr.good td { background: #ecf8ef; }
.bad { color: #b3261e; } .good { color: #1e7d32; }
pre.lanes { font: 12px/1.2 ui-monospace, monospace; background: #f7f7fa;
            padding: .8em; overflow-x: auto; }
.bar { display: inline-block; height: .75em; background: #5b72d8;
       vertical-align: baseline; }
.bar.miss { background: #d86a5b; }
small { color: #666; }
"""


def render_html_page(title: str, sections: list[str]) -> str:
    """One self-contained HTML document (inline CSS, no external
    assets) from pre-rendered body sections."""
    body = "\n".join(sections)
    return (f"<!doctype html><html><head><meta charset='utf-8'>"
            f"<title>{_html.escape(title)}</title>"
            f"<style>{_CSS}</style></head><body>"
            f"<h1>{_html.escape(title)}</h1>\n{body}</body></html>")
