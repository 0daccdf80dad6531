"""Indexed run store: every executed matrix leaves a provenance manifest.

The paper's claims are wall-clock claims, so runs must be comparable
across time and machines (DESIGN.md §13).  Every
``repro_torch.experiments.execute`` records one **manifest** — spec hash,
git sha, backend, torch and CUDA versions, device count and name, ISO
timestamp, per-cell result summaries, artifact paths — into a store laid
out as::

    runs/store/
      index.jsonl                  # one line per run (the query index)
      <run_id>/manifest.json       # run_id = <UTC stamp>-<spec_hash[:8]>

``python -m repro_torch.obs.diff`` aligns two manifests cell-by-cell and gates
on regressions.  The store root comes from the ``REPRO_RUNSTORE`` env
var: unset -> ``runs/store`` under the current directory, a path ->
that directory, ``0``/empty -> recording disabled (benchmark timing
loops disable it explicitly instead, via ``execute(record_to=False)``).

Resumable runs (DESIGN.md §14): ``execute`` opens its manifest with
``status: "running"`` BEFORE the first cell and streams each completed
cell record to ``<run_id>/cells/<index>.json``; ``--resume RUN_ID``
replays those files (after a spec-hash check) and only executes the
cells that never finished.  ``python -m repro_torch.obs.runstore prune`` keeps
the store bounded (``--keep N`` / ``--older-than DAYS``) and repairs the
index if run directories and index lines have drifted apart.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
from datetime import datetime, timezone

__all__ = [
    "RunStore", "default_store", "runstore_enabled", "provenance",
    "git_sha", "spec_signature", "spec_hash", "record_experiment",
    "begin_experiment", "finish_experiment", "record_cell",
    "completed_cells", "prune",
]

ENV_VAR = "REPRO_RUNSTORE"
DEFAULT_ROOT = os.path.join("runs", "store")


# ---------------------------------------------------------------------------
# Provenance
# ---------------------------------------------------------------------------

def git_sha(cwd: str | None = None) -> str:
    """The current commit sha (``unknown`` outside a git checkout)."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=cwd, capture_output=True,
            text=True, timeout=10)
        if out.returncode == 0:
            return out.stdout.strip()
    except Exception:
        pass
    return "unknown"


def provenance(device=None) -> dict:
    """The environment stamp every manifest carries: git sha, backend (the
    type of ``device``, "cuda" or "cpu"; unset, "cuda" where a card is
    present), torch and CUDA versions, device count and name, ISO-8601 UTC
    timestamp."""
    import torch
    meta = {
        "git_sha": git_sha(),
        "timestamp": datetime.now(timezone.utc).isoformat(
            timespec="seconds"),
    }
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    meta.update(
        backend=dev.type, torch_version=torch.__version__,
        cuda_version=torch.version.cuda,
        device_count=torch.cuda.device_count() if on_card else 1,
        device_name=(torch.cuda.get_device_name(dev) if on_card
                     else dev.type))
    return meta


# ---------------------------------------------------------------------------
# Spec hashing
# ---------------------------------------------------------------------------

def _sig_value(v):
    """A canonical JSON-able stand-in for one spec field value."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [_sig_value(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _sig_value(x) for k, x in sorted(v.items())}
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        try:
            return {f.name: _sig_value(getattr(v, f.name))
                    for f in dataclasses.fields(v)}
        except Exception:
            pass
    # array-likes / ProblemSpec / policy instances: identify by type +
    # shape-ish attributes, never by contents (hashing a 16 GiB matrix
    # would defeat the point; same-shaped respins intentionally collide)
    tag = {"type": type(v).__name__}
    for attr in ("n", "p", "m", "k", "shape", "name"):
        try:
            a = getattr(v, attr)
        except Exception:
            continue
        if isinstance(a, (bool, int, float, str)):
            tag[attr] = a
        elif isinstance(a, tuple):
            tag[attr] = [int(x) for x in a]
    return tag


def spec_signature(spec) -> dict:
    """Canonical JSON-safe description of an ``ExperimentSpec`` — the
    dataclass tree with problem/policy objects reduced to type + shape."""
    return _sig_value(spec)


def spec_hash(spec) -> str:
    """Stable 16-hex-digit hash of :func:`spec_signature` — the key two
    runs of the same declared matrix share."""
    blob = json.dumps(spec_signature(spec), sort_keys=True,
                      separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# The store
# ---------------------------------------------------------------------------

def runstore_enabled() -> bool:
    """False iff ``REPRO_RUNSTORE`` is set to ``0``/empty."""
    v = os.environ.get(ENV_VAR)
    return v is None or v not in ("", "0", "off", "false")


def default_store() -> "RunStore | None":
    """The process-default store (None when recording is disabled)."""
    if not runstore_enabled():
        return None
    root = os.environ.get(ENV_VAR) or DEFAULT_ROOT
    return RunStore(root)


class RunStore:
    """An append-only directory of run manifests with a JSONL index."""

    def __init__(self, root: str):
        self.root = str(root)

    @property
    def index_path(self) -> str:
        return os.path.join(self.root, "index.jsonl")

    def manifest_path(self, run_id: str) -> str:
        return os.path.join(self.root, run_id, "manifest.json")

    def cells_dir(self, run_id: str) -> str:
        """Per-cell record directory of one run (resume granularity)."""
        return os.path.join(self.root, run_id, "cells")

    # -- write ----------------------------------------------------------

    def _new_run_id(self, manifest: dict) -> str:
        stamp = datetime.now(timezone.utc).strftime("%Y%m%dT%H%M%SZ")
        tag = (manifest.get("spec_hash") or manifest.get("kind")
               or "run")[:8]
        base = f"{stamp}-{tag}"
        run_id, n = base, 1
        while os.path.exists(os.path.join(self.root, run_id)):
            n += 1
            run_id = f"{base}.{n}"
        return run_id

    def record(self, manifest: dict) -> str:
        """Assign a run id, write ``<run_id>/manifest.json`` and append
        the index line; returns the run id."""
        os.makedirs(self.root, exist_ok=True)
        manifest = dict(manifest)
        manifest.setdefault("kind", "experiment")
        if "timestamp" not in manifest:
            manifest.update(provenance())
        run_id = manifest.get("run_id") or self._new_run_id(manifest)
        manifest["run_id"] = run_id
        os.makedirs(os.path.join(self.root, run_id), exist_ok=True)
        with open(self.manifest_path(run_id), "w") as f:
            json.dump(manifest, f, indent=1)
        entry = {k: manifest.get(k) for k in
                 ("run_id", "kind", "spec_hash", "timestamp", "git_sha",
                  "backend", "label")}
        with open(self.index_path, "a") as f:
            f.write(json.dumps(entry) + "\n")
        return run_id

    def attach_artifacts(self, run_id: str, artifacts: dict) -> None:
        """Merge artifact paths (records JSON, metrics CSV, trace, ...)
        into an existing manifest."""
        manifest = self.load(run_id)
        arts = dict(manifest.get("artifacts") or {})
        arts.update({k: str(v) for k, v in artifacts.items()
                     if v is not None})
        manifest["artifacts"] = arts
        with open(self.manifest_path(manifest["run_id"]), "w") as f:
            json.dump(manifest, f, indent=1)

    # -- query ----------------------------------------------------------

    def runs(self) -> list[dict]:
        """Index entries, oldest first (corrupt lines skipped)."""
        if not os.path.exists(self.index_path):
            return []
        out = []
        with open(self.index_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
        return out

    def load(self, ref: str) -> dict:
        """Load one manifest by run id (or unique prefix), or by path to
        a manifest file / run directory."""
        if os.path.isdir(ref):
            ref = os.path.join(ref, "manifest.json")
        if os.path.isfile(ref):
            with open(ref) as f:
                return json.load(f)
        path = self.manifest_path(ref)
        if os.path.isfile(path):
            with open(path) as f:
                return json.load(f)
        matches = [r["run_id"] for r in self.runs()
                   if r.get("run_id", "").startswith(ref)]
        if len(matches) == 1:
            return self.load(matches[0])
        if len(matches) > 1:
            raise KeyError(f"run ref '{ref}' is ambiguous: {matches}")
        raise KeyError(f"no run '{ref}' in store {self.root}")

    def latest(self, *, spec_hash: str | None = None,
               kind: str | None = None, offset: int = 0) -> dict | None:
        """The manifest of the most recent matching run (``offset`` steps
        back in time); None when nothing matches."""
        rows = [r for r in self.runs()
                if (spec_hash is None or r.get("spec_hash") == spec_hash)
                and (kind is None or r.get("kind") == kind)]
        if offset >= len(rows):
            return None
        return self.load(rows[-1 - offset]["run_id"])

    def resolve(self, ref: str) -> dict:
        """Resolve a CLI run reference: ``latest`` / ``latest~N`` (N runs
        back), a run id or unique prefix, or a path."""
        if ref == "latest":
            m = self.latest()
            if m is None:
                raise KeyError(f"store {self.root} is empty")
            return m
        if ref.startswith("latest~"):
            off = int(ref.split("~", 1)[1])
            m = self.latest(offset=off)
            if m is None:
                raise KeyError(f"store {self.root} has no run {ref}")
            return m
        return self.load(ref)


# ---------------------------------------------------------------------------
# Experiment wiring
# ---------------------------------------------------------------------------

def record_experiment(result, *, store: "RunStore | None" = None,
                      artifacts: dict | None = None) -> str | None:
    """Write the manifest of one ``ExperimentResult`` (see
    ``repro_torch.experiments.execute``), stamped with the device it ran
    on; returns the run id, or None when recording is disabled and no
    explicit store was given."""
    from .analyze import summarize_records
    if store is None:
        store = default_store()
        if store is None:
            return None
    spec = result.spec
    manifest = {
        "kind": "experiment",
        "spec_hash": spec_hash(spec),
        "spec": spec_signature(spec),
        **provenance(getattr(result, "device", None)),
        "cells": summarize_records(result.records),
        "artifacts": {k: str(v) for k, v in (artifacts or {}).items()},
    }
    return store.record(manifest)


# ---------------------------------------------------------------------------
# Resumable runs: running manifest + streamed per-cell records
# ---------------------------------------------------------------------------

def begin_experiment(spec, *, store: "RunStore | None" = None,
                     total_cells: int = 0, device=None) -> str | None:
    """Open a ``status: "running"`` manifest BEFORE the first cell runs,
    so a killed matrix leaves a resumable run id behind; ``device`` is the
    one the cells run on (see :func:`provenance`).  Returns the run id
    (None when recording is disabled)."""
    if store is None:
        store = default_store()
        if store is None:
            return None
    manifest = {
        "kind": "experiment",
        "status": "running",
        "spec_hash": spec_hash(spec),
        "spec": spec_signature(spec),
        **provenance(device),
        "total_cells": int(total_cells),
        "cells": [],
    }
    return store.record(manifest)


def record_cell(store: "RunStore", run_id: str, index: int,
                record: dict) -> None:
    """Stream one completed cell record to ``<run_id>/cells/<index>.json``
    (atomic rename so a kill mid-write never leaves a truncated record)."""
    d = store.cells_dir(run_id)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{index:04d}.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(record, f)
    os.replace(tmp, path)


def completed_cells(store: "RunStore", run_id: str) -> dict:
    """The streamed cell records of one run, ``{cell index: record}``
    (corrupt/truncated files are treated as never-completed)."""
    d = store.cells_dir(run_id)
    if not os.path.isdir(d):
        return {}
    out: dict = {}
    for name in sorted(os.listdir(d)):
        if not name.endswith(".json"):
            continue
        try:
            with open(os.path.join(d, name)) as f:
                out[int(name[:-len(".json")])] = json.load(f)
        except (ValueError, json.JSONDecodeError, OSError):
            continue
    return out


def finish_experiment(result, store: "RunStore", run_id: str) -> str:
    """Finalize a :func:`begin_experiment` manifest: cell summaries in,
    ``status`` -> ``complete``."""
    from .analyze import summarize_records
    manifest = store.load(run_id)
    manifest["status"] = "complete"
    manifest["cells"] = summarize_records(result.records)
    with open(store.manifest_path(manifest["run_id"]), "w") as f:
        json.dump(manifest, f, indent=1)
    return run_id


# ---------------------------------------------------------------------------
# Store maintenance: prune + index consistency
# ---------------------------------------------------------------------------

def _run_dirs(store: "RunStore") -> list[str]:
    if not os.path.isdir(store.root):
        return []
    return sorted(d for d in os.listdir(store.root)
                  if os.path.isfile(store.manifest_path(d)))


def prune(store: "RunStore", *, keep: int | None = None,
          older_than_days: float | None = None,
          dry_run: bool = False) -> dict:
    """Bound the store: delete run directories beyond the newest ``keep``
    and/or older than ``older_than_days``, then rewrite ``index.jsonl`` to
    exactly match the surviving run directories (repairing any drift:
    index lines whose directory is gone, directories the index never
    heard of).  Returns ``{"kept": [...], "removed": [...], "repaired":
    n}``; ``dry_run`` reports without touching disk."""
    entries = {r["run_id"]: r for r in store.runs() if r.get("run_id")}
    dirs = _run_dirs(store)
    # timestamp per run: index entry if present, else the manifest's
    stamps = {}
    for rid in dirs:
        ts = (entries.get(rid) or {}).get("timestamp")
        if ts is None:
            try:
                ts = store.load(rid).get("timestamp")
            except Exception:
                ts = None
        stamps[rid] = ts or ""
    ordered = sorted(dirs, key=lambda rid: (stamps[rid], rid))
    removed = set()
    if older_than_days is not None:
        from datetime import timedelta
        cutoff = (datetime.now(timezone.utc)
                  - timedelta(days=float(older_than_days)))
        for rid in ordered:
            try:
                when = datetime.fromisoformat(stamps[rid])
            except ValueError:
                continue        # unparseable stamp: never age-prune it
            if when < cutoff:
                removed.add(rid)
    if keep is not None:
        survivors = [rid for rid in ordered if rid not in removed]
        if keep >= 0 and len(survivors) > keep:
            removed.update(survivors[:len(survivors) - keep])
    kept = [rid for rid in ordered if rid not in removed]
    # index repair: lines without a directory are drift either way
    orphan_lines = [rid for rid in entries if rid not in set(dirs)]
    orphan_dirs = [rid for rid in dirs if rid not in entries]
    repaired = len(orphan_lines) + len(orphan_dirs)
    if not dry_run:
        for rid in sorted(removed):
            shutil.rmtree(os.path.join(store.root, rid),
                          ignore_errors=True)
        lines = []
        for rid in kept:
            entry = entries.get(rid)
            if entry is None:      # directory the index never heard of
                m = store.load(rid)
                entry = {k: m.get(k) for k in
                         ("run_id", "kind", "spec_hash", "timestamp",
                          "git_sha", "backend", "label")}
            lines.append(json.dumps(entry))
        os.makedirs(store.root, exist_ok=True)
        tmp = store.index_path + ".tmp"
        with open(tmp, "w") as f:
            f.write("".join(line + "\n" for line in lines))
        os.replace(tmp, store.index_path)
    return {"kept": kept, "removed": sorted(removed), "repaired": repaired}


def main(argv=None) -> int:
    """``python -m repro_torch.obs.runstore`` — store maintenance CLI."""
    import argparse
    ap = argparse.ArgumentParser(
        prog="repro_torch.obs.runstore",
        description="run-store maintenance (REPRO_RUNSTORE or --store)")
    ap.add_argument("--store", default=None,
                    help="store root (default: REPRO_RUNSTORE / runs/store)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    lp = sub.add_parser("list", help="print the index, oldest first")
    pp = sub.add_parser("prune",
                        help="bound the store and repair the index")
    pp.add_argument("--keep", type=int, default=None, metavar="N",
                    help="keep only the N newest runs")
    pp.add_argument("--older-than", type=float, default=None,
                    metavar="DAYS", help="drop runs older than DAYS days")
    pp.add_argument("--dry-run", action="store_true",
                    help="report what would be removed; touch nothing")
    del lp
    args = ap.parse_args(argv)
    store = (RunStore(args.store) if args.store is not None
             else default_store())
    if store is None:
        print("runstore: recording disabled (REPRO_RUNSTORE=0)")
        return 1
    if args.cmd == "list":
        for r in store.runs():
            print(json.dumps(r))
        return 0
    if args.keep is None and args.older_than is None:
        # a bare prune is still useful: it repairs index drift
        print("# no --keep/--older-than: repairing the index only")
    out = prune(store, keep=args.keep, older_than_days=args.older_than,
                dry_run=args.dry_run)
    tag = "would remove" if args.dry_run else "removed"
    print(f"runstore prune: kept {len(out['kept'])}, {tag} "
          f"{len(out['removed'])}, repaired {out['repaired']} index "
          f"entries in {store.root}")
    for rid in out["removed"]:
        print(f"  - {rid}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
