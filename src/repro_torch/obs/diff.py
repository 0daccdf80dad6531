"""Regression gate CLI: compare two stored runs or bench baselines.

Usage::

    python -m repro_torch.obs.diff <run-a> <run-b> [--store DIR]
    python -m repro_torch.obs.diff <run-b> --against-baseline BENCH_fused.json
    python -m repro_torch.obs.diff BENCH_new.json \\
        --against-baseline BENCH_old.json

Run references are store run ids (or unique prefixes), ``latest`` /
``latest~N``, or paths to a manifest file / run directory.  A plain
``*.json`` positional that is not a manifest is treated as a bench
document (``BENCH_*.json``), so the CI gate can diff a fresh bench
output directly against the committed baseline.

Exit codes: ``0`` no regression, ``1`` at least one gated leaf/cell
regressed, ``2`` usage / resolution error.  Thresholds are configurable
(``--threshold`` wall-clock ratio, ``--metric-threshold`` relative
objective worsening); ``--json`` and ``--html`` write machine- and
human-readable reports alongside the text summary.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from .analyze import (Thresholds, diff_bench, diff_manifests,
                      render_html_page)
from .runstore import DEFAULT_ROOT, ENV_VAR, RunStore

__all__ = ["main"]


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.diff",
        description="Align two runs cell-by-cell and gate on wall-clock/"
                    "convergence regressions (exit 1 on regression).")
    ap.add_argument("run_a", help="reference run: store id / prefix / "
                    "'latest' / 'latest~N' / manifest path / BENCH json")
    ap.add_argument("run_b", nargs="?", default=None,
                    help="candidate run (omit with --against-baseline)")
    ap.add_argument("--against-baseline", metavar="BENCH_JSON",
                    help="compare run_a (a BENCH_*.json or stored run) "
                         "against this committed baseline json")
    ap.add_argument("--store", default=None,
                    help=f"run store root (default: ${ENV_VAR} or "
                         f"{DEFAULT_ROOT})")
    ap.add_argument("--threshold", type=float, default=1.5,
                    help="wall-clock ratio above which a cell regresses "
                         "(default 1.5)")
    ap.add_argument("--metric-threshold", type=float, default=0.25,
                    help="relative final-objective worsening above which "
                         "a cell regresses (default 0.25)")
    ap.add_argument("--min-seconds", type=float, default=1e-3,
                    help="absolute wall-clock slack below which timing "
                         "noise never flags (default 1e-3)")
    ap.add_argument("--json", metavar="PATH", dest="json_out",
                    help="write the full report as JSON")
    ap.add_argument("--html", metavar="PATH", dest="html_out",
                    help="write a self-contained HTML report")
    return ap


def _ensure_parent(path: str) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)


def _store(args) -> RunStore:
    root = args.store or os.environ.get(ENV_VAR) or DEFAULT_ROOT
    return RunStore(root)


def _is_bench_doc(doc: dict) -> bool:
    return "bench" in doc and "cells" not in doc


def _load_side(ref: str, store: RunStore):
    """Resolve one CLI reference to (doc, label, kind)."""
    if os.path.isfile(ref) and not os.path.isdir(ref):
        with open(ref) as f:
            doc = json.load(f)
        kind = "bench" if _is_bench_doc(doc) else "run"
        return doc, os.path.basename(ref), kind
    doc = store.resolve(ref)
    return doc, doc.get("run_id", ref), "run"


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    if (args.run_b is None) == (args.against_baseline is None):
        print("error: provide either <run-b> or --against-baseline, "
              "not both", file=sys.stderr)
        return 2
    store = _store(args)
    th = Thresholds(wallclock_ratio=args.threshold,
                    metric_rel=args.metric_threshold,
                    min_seconds=args.min_seconds)

    try:
        if args.against_baseline:
            # baseline is reference (a); the positional is the candidate
            cand, cand_label, cand_kind = _load_side(args.run_a, store)
            with open(args.against_baseline) as f:
                base = json.load(f)
            base_label = os.path.basename(args.against_baseline)
            if cand_kind == "run" and not _is_bench_doc(cand):
                report = diff_manifests(base, cand, thresholds=th,
                                        a_label=base_label,
                                        b_label=cand_label)
            else:
                report = diff_bench(base, cand, thresholds=th,
                                    a_label=base_label,
                                    b_label=cand_label)
        else:
            a, a_label, a_kind = _load_side(args.run_a, store)
            b, b_label, b_kind = _load_side(args.run_b, store)
            if "bench" in (a_kind, b_kind):
                report = diff_bench(a, b, thresholds=th, a_label=a_label,
                                    b_label=b_label)
            else:
                report = diff_manifests(a, b, thresholds=th,
                                        a_label=a_label, b_label=b_label)
    except (KeyError, OSError, json.JSONDecodeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    print(report.render_text())
    if args.json_out:
        _ensure_parent(args.json_out)
        with open(args.json_out, "w") as f:
            json.dump(report.to_dict(), f, indent=1)
    if args.html_out:
        page = render_html_page(
            f"repro diff: {report.a_label} vs {report.b_label}",
            [report.render_html_section()])
        _ensure_parent(args.html_out)
        with open(args.html_out, "w") as f:
            f.write(page)
    return report.exit_code


if __name__ == "__main__":
    sys.exit(main())
