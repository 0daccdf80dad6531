"""Shared experiment record I/O (the ONE copy; DESIGN.md §10).

Every harness record — synthetic compare cells, workload cells, batched
Monte-Carlo cells, skip-with-reason cells — flows through the same three
writers:

  * :func:`write_json`        — the full per-cell records, traces included;
  * :func:`write_trace_csv`   — long format, one row per recorded
    (workload, strategy, delay, trial, step) point;
  * :func:`write_summary_csv` — one row per cell: the paper-table view;
  * :func:`write_metrics_csv` — one row per cell: the obs view (compile /
    execute split, miss-rate, active-set, latency percentiles, staleness),
    from records produced with the spec's :class:`ObsAxis` enabled.

``runtime/compare.py`` and ``workloads/runner.py`` import these instead of
carrying their own copies.
"""
from __future__ import annotations

import csv
import json

__all__ = ["write_json", "trace_rows", "write_trace_csv",
           "write_summary_csv", "write_metrics_csv", "print_table"]


def write_json(records: list[dict], path: str) -> None:
    with open(path, "w") as f:
        json.dump(records, f, indent=1)


def trace_rows(rec: dict):
    """Yield (trial, step, time, objective) rows from a record's traces —
    single-trial records carry flat (T,) lists (trial 0), batched records a
    (R, T) nesting."""
    times, obj = rec["times"], rec["objective"]
    if times and isinstance(times[0], (list, tuple)):
        for r, (ts, os_) in enumerate(zip(times, obj)):
            for i, (t, o) in enumerate(zip(ts, os_)):
                yield r, i, t, o
    else:
        for i, (t, o) in enumerate(zip(times, obj)):
            yield 0, i, t, o


def write_trace_csv(records: list[dict], path: str) -> None:
    """Long-format trace table: one row per recorded (strategy, delay,
    trial, step).

    Every row repeats the cell's ``metric_name`` / ``final_metric`` so the
    CSV is self-describing; a skipped cell contributes a single row whose
    ``skipped`` column carries the reason.
    """
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["workload", "strategy", "delay", "trial", "step",
                    "time_s", "objective", "metric_name", "final_metric",
                    "skipped"])
        for rec in records:
            wl = rec.get("workload", "")
            metric_name = rec.get("metric_name", "objective")
            if "skipped" in rec:
                w.writerow([wl, rec["strategy"], rec["delay"], "", "", "",
                            "", metric_name, "", rec["skipped"]])
                continue
            final_metric = f"{rec['final_metric']:.8e}"
            for r, i, t, obj in trace_rows(rec):
                w.writerow([wl, rec["strategy"], rec["delay"], r, i,
                            f"{t:.6f}", f"{obj:.8e}", metric_name,
                            final_metric, ""])


def write_summary_csv(records: list[dict], path: str) -> None:
    """One row per cell: the paper-table view (final metric + wall-clock)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["workload", "strategy", "delay", "preset", "metric_name",
                    "final_metric", "final_objective", "wallclock_s",
                    "skipped"])
        for r in records:
            if "skipped" in r:
                w.writerow([r.get("workload", ""), r["strategy"], r["delay"],
                            r.get("preset", ""), r.get("metric_name", ""),
                            "", "", "", r["skipped"]])
            else:
                w.writerow([r.get("workload", ""), r["strategy"], r["delay"],
                            r.get("preset", ""), r["metric_name"],
                            f"{r['final_metric']:.6g}",
                            f"{r['final_objective']:.6g}",
                            f"{r['wallclock_s']:.2f}", ""])


METRICS_COLUMNS = [
    "workload", "strategy", "delay", "trials",
    "host_s", "compile_s", "execute_s", "compiles",
    "mean_miss_rate", "max_miss_rate",
    "active_size_mean", "active_size_min", "active_size_max",
    "step_latency_p50", "step_latency_p95", "step_latency_p99",
    "staleness_mean", "staleness_max", "staleness_clamped", "dropped",
    "delay_tail_p99_max", "delay_tail_p99_mean", "delay_tail_p99_workers",
    "crashes", "blackout_s", "corrupt_count", "subk_fraction",
    "skipped",
]


def _fmt(v, spec: str = ".6g") -> str:
    return "" if v is None else format(v, spec)


def write_metrics_csv(records: list[dict], path: str) -> None:
    """One row per cell: the straggler/compile metrics attached by
    ``execute`` under an enabled :class:`ObsAxis` (records without the
    ``obs`` key — e.g. from a no-obs run — produce mostly-empty rows)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(METRICS_COLUMNS)
        pad = len(METRICS_COLUMNS) - 4        # between delay and skipped
        for r in records:
            if "skipped" in r:
                w.writerow([r.get("workload", ""), r["strategy"],
                            r["delay"]] + [""] * pad + [r["skipped"]])
                continue
            obs = r.get("obs", {})
            sched = obs.get("schedule", {})
            asy = obs.get("async", {})
            active = sched.get("active_size", {})
            lat = sched.get("step_latency_s", {})
            stale = asy.get("staleness", {})
            # delay_tail comes from whichever artifact stream the cell
            # produced (sync schedules or the async trace)
            tail = sched.get("delay_tail") or asy.get("delay_tail") or {}
            faults = sched.get("faults", {})
            # subk_fraction lives in the strategy meta (it knows the
            # decode threshold); the obs summarizer has no k
            subk = (r.get("meta") or {}).get("subk_fraction")
            w.writerow([
                r.get("workload", ""), r["strategy"], r["delay"],
                r.get("trials", 1),
                _fmt(r.get("host_s")), _fmt(r.get("compile_s")),
                _fmt(r.get("execute_s")), _fmt(r.get("compiles"), "d"),
                _fmt(sched.get("mean_miss_rate")),
                _fmt(sched.get("max_miss_rate")),
                _fmt(active.get("mean")), _fmt(active.get("min")),
                _fmt(active.get("max")),
                _fmt(lat.get("p50")), _fmt(lat.get("p95")),
                _fmt(lat.get("p99")),
                _fmt(stale.get("mean")), _fmt(stale.get("max")),
                _fmt(asy.get("staleness_clamped"), "d"),
                _fmt(asy.get("dropped"), "d"),
                _fmt(tail.get("p99_max")), _fmt(tail.get("p99_mean")),
                _fmt(tail.get("workers"), "d"),
                _fmt(faults.get("crashes"), "d"),
                _fmt(faults.get("blackout_s")),
                _fmt(faults.get("corrupt_count"), "d"),
                _fmt(subk), "",
            ])


def print_table(records: list[dict]) -> None:
    """Human summary of a record list on stdout (shared by all CLIs).

    Records from an obs-enabled run carry the CompileWatch host-time
    split; the table then grows a ``compile/exec_s`` column so one glance
    separates the kernels' build from steady-state execution.
    """
    has_wl = any(r.get("workload") for r in records)
    has_split = any(r.get("compile_s") is not None for r in records)
    head = (f"{'workload':10s} " if has_wl else "") + \
        (f"{'strategy':14s} {'delay':12s} {'final f':>12s} "
         f"{'metric':>22s} {'wallclock_s':>12s}") + \
        (f" {'compile/exec_s':>15s}" if has_split else "") + \
        f" {'trialsxT':>9s}"
    print(head)
    for rec in records:
        lead = f"{rec.get('workload', '-'):10s} " if has_wl else ""
        if "skipped" in rec:
            print(f"{lead}{rec['strategy']:14s} {rec['delay']:12s} "
                  f"{'skipped:':>12s} {rec['skipped']}")
            continue
        metric = f"{rec['metric_name']}={rec['final_metric']:.5g}"
        obj = rec["objective"]
        shape = (f"{len(obj)}x{len(obj[0])}"
                 if obj and isinstance(obj[0], (list, tuple))
                 else f"1x{len(obj)}")
        split = ""
        if has_split:
            cs, es = rec.get("compile_s"), rec.get("execute_s")
            split = (f" {cs:7.2f}/{es:7.2f}"
                     if cs is not None and es is not None
                     else f" {'-':>15s}")
        print(f"{lead}{rec['strategy']:14s} {rec['delay']:12s} "
              f"{rec['final_objective']:12.5f} {metric:>22s} "
              f"{rec['wallclock_s']:12.2f}{split} {shape:>9s}")
