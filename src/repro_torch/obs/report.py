"""Fold a telemetry JSONL log into summary tables.

One analysis path for live runs and offline benchmarks: anything that
emits the :mod:`repro_torch.obs.events` schema — ``launch.train
--telemetry``, ``benchmarks.variance_stability``,
``benchmarks.comm_fraction`` (either package's) — folds through here.
Sections (each skipped when its events are absent): **run**
(``run_meta``), **steps** (count, loss first→last, the stage switch,
sync skips, the tail of the Fig. 2 ``v_l1`` curve), **plans** and
**comm** (per-tier bytes and predicted times; comm-vs-compute
fractions), **spans** (host/probe regions by name; ``train.window``
spans give measured s/step as ``dur / n``), **drift** and
**recalibration**, **profile** (the folded ``torch.profiler`` window:
s/step, comm fraction, overlap efficiency, attributed vs residual, the
per-stream audit against the predicted schedule, the ready order, the
grid cells), **audit** (per-segment fidelity, worst drift), **memory**
(predicted categories, each measured step's attribution, live samples),
**health** and **warnings**.

CLI::

    python -m repro_torch.obs.report LOG                # the report
    python -m repro_torch.obs.report LOG --validate --json summary.json
    python -m repro_torch.obs.report LOG_A LOG_B        # the two side by side

The port of ``repro/obs/report.py`` (the same sections, rows and diff).
"""
from __future__ import annotations

import argparse
import json
import math
from typing import Dict, List, Optional

from repro_torch.obs.events import validate_records


def load(path: str, validate: bool = False) -> List[dict]:
    """Read a JSONL telemetry log; optionally schema-check every
    record (raises with the offending line's index)."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    if validate:
        validate_records(records)
    return records


def _by_type(records: List[dict]) -> Dict[str, List[dict]]:
    out: Dict[str, List[dict]] = {}
    for r in records:
        out.setdefault(r.get("type", "?"), []).append(r)
    return out


def summarize(records: List[dict]) -> Dict[str, object]:
    """Fold a record list into the section dict ``format_report``
    renders (also the ``--json`` payload)."""
    by = _by_type(records)
    out: Dict[str, object] = {"n_events": len(records),
                              "by_type": {k: len(v) for k, v in
                                          sorted(by.items())}}

    if by.get("run_meta"):
        out["run"] = {k: v for k, v in by["run_meta"][0].items()
                      if k not in ("type", "t")}

    steps = by.get("step", [])
    if steps:
        steps = sorted(steps, key=lambda r: r["step"])
        sec: Dict[str, object] = {
            "n_steps": len(steps),
            "first_step": steps[0]["step"], "last_step": steps[-1]["step"],
        }
        losses = [(r["step"], r["loss"]) for r in steps if "loss" in r]
        if losses:
            sec["loss_first"], sec["loss_last"] = losses[0][1], losses[-1][1]
        stages = [r.get("stage") for r in steps if r.get("stage")]
        if stages:
            sec["stages"] = {s: stages.count(s) for s in dict.fromkeys(stages)}
        syncs = [r["sync"] for r in steps if "sync" in r]
        if syncs:
            sec["sync_skipped"] = syncs.count(False)
        v_curve = [(r["step"], r["v_l1"]) for r in steps if "v_l1" in r]
        if v_curve:
            sec["v_l1_last"] = v_curve[-1][1]
            sec["v_l1_curve_tail"] = v_curve[-8:]
        out["steps"] = sec

    transitions = by.get("transition", [])
    switch = [r for r in transitions
              if r.get("kind") == "stage" and r.get("to") == "compressed"]
    if switch:
        out.setdefault("steps", {})["switch_step"] = switch[0]["step"]
        if "ratio" in switch[0]:
            out["steps"]["switch_ratio"] = switch[0]["ratio"]

    plans = by.get("plan", [])
    if plans:
        out["plans"] = [{k: r[k] for k in
                         ("name", "stage", "d", "n_buckets",
                          "intra_hlo_bytes", "cross_hlo_bytes",
                          "wire_send_bytes", "t_predicted",
                          "overlap_bwd", "t_bwd", "ready_times")
                         if k in r}
                        for r in plans]

    comm = by.get("comm", [])
    if comm:
        rows = []
        for r in comm:
            tc, tx = r["t_comm"], r["t_compute"]
            rows.append({
                "label": r.get("label", r.get("compressor", "?")),
                "t_comm": tc, "t_compute": tx,
                "frac": r.get("frac", tc / (tc + tx) if tc + tx > 0
                              else 0.0),
                "source": r.get("source", "?"),
            })
        out["comm"] = rows

    spans = by.get("span", [])
    if spans:
        groups: Dict[str, List[dict]] = {}
        for r in spans:
            groups.setdefault(r["name"], []).append(r)
        sec = {}
        for name, ss in sorted(groups.items()):
            durs = [s["dur"] for s in ss]
            row = {"count": len(ss), "total": sum(durs),
                   "mean": sum(durs) / len(durs)}
            nsteps = sum(s.get("n", 0) for s in ss)
            if nsteps:                    # windowed spans: honest s/step
                row["per_step"] = sum(durs) / nsteps
            sec[name] = row
        out["spans"] = sec

    profiles = by.get("profile", [])
    if profiles:
        p = profiles[-1]           # the run's (last) folded window
        sec = {k: p[k] for k in
               ("n_steps", "t_window", "t_attributed", "t_residual",
                "s_per_step", "comm_fraction", "overlap_efficiency",
                "exposed_comm_s", "roofline_fraction", "bytes_per_step",
                "n_cells", "n_unattributed") if k in p}
        if p.get("t_window"):
            sec["attributed_fraction"] = p["t_attributed"] / p["t_window"]
        if p.get("streams"):
            sec["streams"] = [{"stream": s, **row}
                              for s, row in sorted(p["streams"].items())]
        if p.get("audit_vs_predicted"):
            sec["audit_vs_predicted"] = p["audit_vs_predicted"]
        if p.get("ready_order"):
            sec["ready_order"] = p["ready_order"]
        if p.get("cells"):
            sec["cells"] = p["cells"]
        out["profile"] = sec

    drift = by.get("drift", [])
    if drift:
        out["drift"] = [{k: r[k] for k in
                         ("op_kind", "tier", "n_samples", "t_measured",
                          "t_predicted", "ratio", "drifting") if k in r}
                        for r in drift]
        out["drifting"] = [f"{r['op_kind']}@{r['tier']}" for r in drift
                           if r.get("drifting")]
    recal = by.get("recalibration", [])
    if recal:
        out["recalibration"] = [{k: v for k, v in r.items()
                                 if k not in ("type", "t")} for r in recal]

    fidelity = by.get("fidelity", [])
    if fidelity:
        fidelity = sorted(fidelity, key=lambda r: r["step"])
        last = fidelity[-1]
        sec = {"n_audits": len(fidelity),
               "first_step": fidelity[0]["step"],
               "last_step": last["step"]}
        for k in ("v_ratio", "v_drift_max", "cos_sim_min",
                  "sign_agree_min"):
            if k in last:
                sec[f"{k}_last"] = last[k]
        n_seg = last.get("n_segments", 0)
        seg_cols = ("cos_sim", "sign_agree", "v_drift", "v_l1_seg",
                    "worker_err_seg", "server_err_seg", "scale_seg")
        present = [k for k in seg_cols
                   if isinstance(last.get(k), list)
                   and len(last[k]) == n_seg]
        if present and n_seg:
            sec["segments"] = [
                {"seg": i, **{k: last[k][i] for k in present}}
                for i in range(n_seg)]
            drift = last.get("v_drift")
            if isinstance(drift, list) and len(drift) == n_seg:
                ranked = sorted(
                    (i for i in range(n_seg)
                     if math.isfinite(drift[i])),
                    key=lambda i: abs(math.log(max(drift[i], 1e-30))),
                    reverse=True)
                sec["worst_drift"] = [{"seg": i, "v_drift": drift[i]}
                                      for i in ranked[:5]]
        out["audit"] = sec

    memories = by.get("memory", [])
    if memories:
        sec = {}
        predicted = [r for r in memories if r.get("kind") == "predicted"]
        if predicted:
            p = predicted[-1]
            pred = {"categories": p.get("categories", {}),
                    "total_bytes": p.get("total_bytes")}
            for k in ("capacity_bytes", "headroom_frac",
                      "wire_watermark_bytes", "state_bytes_per_rank"):
                if k in p:
                    pred[k] = p[k]
            sec["predicted"] = pred
        compiled = [r for r in memories if r.get("kind") == "compiled"]
        if compiled:
            sec["compiled"] = [
                {k: r[k] for k in
                 ("program", "argument_bytes", "output_bytes",
                  "temp_bytes", "peak_bytes", "attributed_bytes",
                  "residual_bytes", "residual_frac") if k in r}
                for r in compiled]
        live = sorted((r for r in memories if r.get("kind") == "live"),
                      key=lambda r: r.get("step", 0))
        if live:
            sec["live"] = {
                "n_samples": len(live),
                "source": live[-1].get("device", "?"),
                "first_bytes": live[0].get("bytes_in_use"),
                "last_bytes": live[-1].get("bytes_in_use"),
                "peak_bytes": max(r.get("peak_bytes_in_use",
                                        r.get("bytes_in_use", 0.0))
                                  for r in live),
            }
        out["memory"] = sec

    healths = by.get("health", [])
    if healths:
        healths = sorted(healths, key=lambda r: r["step"])
        failed = [r for r in healths if not r.get("ok", True)]
        out["health"] = {
            "n_checks": len(healths), "n_failed": len(failed),
            "timeline": [{"step": r["step"], "ok": r.get("ok", True),
                          "verdicts": ",".join(r.get("verdicts") or [])
                          or "-"}
                         for r in healths]}

    warnings = by.get("warning", [])
    if warnings:
        out["warnings"] = [{k: v for k, v in r.items()
                            if k not in ("type", "t")} for r in warnings]
    return out


# --------------------------------------------------------------------------
# rendering
# --------------------------------------------------------------------------

def _fmt(v) -> str:
    if isinstance(v, bool):
        return str(v)
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def _table(rows: List[dict], cols: List[str]) -> List[str]:
    cells = [[_fmt(r.get(c, "")) for c in cols] for r in rows]
    widths = [max(len(c), *(len(row[i]) for row in cells))
              if cells else len(c) for i, c in enumerate(cols)]
    lines = ["  ".join(c.ljust(w) for c, w in zip(cols, widths))]
    lines += ["  ".join(c.ljust(w) for c, w in zip(row, widths))
              for row in cells]
    return lines


def format_report(summary: Dict[str, object]) -> str:
    lines: List[str] = []

    def head(title):
        lines.extend(["", f"== {title} =="])

    lines.append(f"telemetry: {summary['n_events']} events "
                 + " ".join(f"{k}:{v}" for k, v in
                            summary["by_type"].items()))
    if "run" in summary:
        head("run")
        lines += [f"  {k}: {_fmt(v)}" for k, v in summary["run"].items()]
    if "steps" in summary:
        head("steps")
        s = summary["steps"]
        lines += [f"  {k}: {_fmt(v)}" for k, v in s.items()
                  if k != "v_l1_curve_tail"]
        if "v_l1_curve_tail" in s:
            lines.append("  v_l1 tail: " + " ".join(
                f"{st}:{_fmt(v)}" for st, v in s["v_l1_curve_tail"]))
    if "plans" in summary:
        head("plans")
        lines += ["  " + ln for ln in _table(
            summary["plans"], ["name", "stage", "d", "n_buckets",
                               "intra_hlo_bytes", "cross_hlo_bytes",
                               "t_predicted"])]
    if "comm" in summary:
        head("comm fraction")
        lines += ["  " + ln for ln in _table(
            summary["comm"], ["label", "t_comm", "t_compute", "frac",
                              "source"])]
    if "spans" in summary:
        head("spans")
        rows = [{"name": n, **row} for n, row in summary["spans"].items()]
        lines += ["  " + ln for ln in _table(
            rows, ["name", "count", "mean", "total", "per_step"])]
    if "profile" in summary:
        head("profile (measured trace fold)")
        p = summary["profile"]
        lines += [f"  {k}: {_fmt(v)}" for k, v in p.items()
                  if k not in ("streams", "cells", "audit_vs_predicted",
                               "ready_order")]
        if "streams" in p:
            lines.append("  per-stream overlap audit:")
            lines += ["    " + ln for ln in _table(
                p["streams"], ["stream", "busy", "hidden", "exposed"])]
        if "audit_vs_predicted" in p:
            lines.append("  measured vs predicted (per step vs window):")
            lines += ["    " + ln for ln in _table(
                p["audit_vs_predicted"],
                ["stream", "busy_measured", "busy_predicted",
                 "hidden_measured", "hidden_predicted",
                 "exposed_measured", "exposed_predicted"])]
        if "ready_order" in p:
            lines.append("  backward ready order "
                         "(per-bucket first collective start):")
            lines += ["    " + ln for ln in _table(
                p["ready_order"],
                ["bucket", "ready_predicted", "first_start_predicted",
                 "first_start_measured"])]
        if "cells" in p:
            lines.append("  grid cells:")
            lines += ["    " + ln for ln in _table(
                p["cells"], ["plan", "bucket", "stage", "kind", "tier",
                             "n", "t_wire", "t_compute"])]
    if "drift" in summary:
        head("cost-model drift")
        lines += ["  " + ln for ln in _table(
            summary["drift"], ["op_kind", "tier", "n_samples",
                               "t_measured", "t_predicted", "ratio",
                               "drifting"])]
        if summary.get("drifting"):
            lines.append("  DRIFTING: " + ", ".join(summary["drifting"]))
    if "recalibration" in summary:
        head("recalibration")
        for r in summary["recalibration"]:
            lines += [f"  {k}: {_fmt(v) if not isinstance(v, dict) else v}"
                      for k, v in r.items()]
    if "audit" in summary:
        head("compression-fidelity audit")
        au = summary["audit"]
        lines += [f"  {k}: {_fmt(v)}" for k, v in au.items()
                  if k not in ("segments", "worst_drift")]
        if "segments" in au:
            lines.append("  per-segment (last audit):")
            cols = ["seg"] + [c for c in
                              ("cos_sim", "sign_agree", "v_drift",
                               "v_l1_seg", "worker_err_seg",
                               "server_err_seg", "scale_seg")
                              if c in au["segments"][0]]
            lines += ["    " + ln for ln in _table(au["segments"], cols)]
        if "worst_drift" in au:
            lines.append("  worst drift: " + " ".join(
                f"seg{r['seg']}:{_fmt(r['v_drift'])}"
                for r in au["worst_drift"]))
    if "memory" in summary:
        head("memory ledger")
        m = summary["memory"]
        if "predicted" in m:
            p = m["predicted"]
            lines.append("  predicted (per rank):")
            for name, b in p.get("categories", {}).items():
                lines.append(f"    {name:12s} {_fmt(b)} B")
            lines += [f"  {k}: {_fmt(p[k])}" for k in
                      ("total_bytes", "capacity_bytes", "headroom_frac")
                      if k in p]
        if "compiled" in m:
            lines.append("  compiled programs:")
            lines += ["    " + ln for ln in _table(
                m["compiled"], ["program", "argument_bytes",
                                "output_bytes", "temp_bytes",
                                "peak_bytes", "residual_frac"])]
        if "live" in m:
            lv = m["live"]
            lines.append(f"  live ({lv['source']}): "
                         f"{lv['n_samples']} sample(s), "
                         f"first {_fmt(lv['first_bytes'])} B, "
                         f"last {_fmt(lv['last_bytes'])} B, "
                         f"peak {_fmt(lv['peak_bytes'])} B")
    if "health" in summary:
        head("health timeline")
        h = summary["health"]
        lines.append(f"  checks: {h['n_checks']}  "
                     f"failed: {h['n_failed']}")
        lines += ["  " + ln for ln in _table(
            h["timeline"], ["step", "ok", "verdicts"])]
    if "warnings" in summary:
        head("warnings")
        lines += [f"  {w}" for w in summary["warnings"]]
    return "\n".join(lines)


# --------------------------------------------------------------------------
# two-run diff (--diff): the manual counterpart of the CI ledger gate
# --------------------------------------------------------------------------

def _diff_rows(a: Dict[str, object], b: Dict[str, object]) -> List[dict]:
    """Comparable headline quantities of two summaries as (metric, a, b)
    rows: steps/s, per-tier plan bytes, drift verdicts."""
    rows: List[dict] = []

    def row(metric, va, vb):
        rows.append({"metric": metric,
                     "a": va if va is not None else "-",
                     "b": vb if vb is not None else "-"})

    def steps_per_s(s):
        win = (s.get("spans") or {}).get("train.window", {})
        per = win.get("per_step") or (s.get("profile") or {}).get(
            "s_per_step")
        return 1.0 / per if per else None

    row("steps/s", steps_per_s(a), steps_per_s(b))
    for field in ("s_per_step", "comm_fraction", "overlap_efficiency",
                  "exposed_comm_s", "t_residual"):
        va = (a.get("profile") or {}).get(field)
        vb = (b.get("profile") or {}).get(field)
        if va is not None or vb is not None:
            row(f"profile.{field}", va, vb)
    plans_a = {(p["name"], p["stage"]): p for p in a.get("plans", [])}
    plans_b = {(p["name"], p["stage"]): p for p in b.get("plans", [])}
    for key in sorted(set(plans_a) | set(plans_b), key=str):
        for tier in ("intra", "cross"):
            va = (plans_a.get(key) or {}).get(f"{tier}_hlo_bytes")
            vb = (plans_b.get(key) or {}).get(f"{tier}_hlo_bytes")
            if va or vb:
                row(f"{key[0]}[{key[1]}] {tier} B", va, vb)
    da = a.get("drifting", [])
    db = b.get("drifting", [])
    if "drift" in a or "drift" in b:
        row("drifting", ",".join(da) or "none", ",".join(db) or "none")
    if "audit" in a or "audit" in b:
        for field in ("v_ratio_last", "v_drift_max_last",
                      "cos_sim_min_last", "sign_agree_min_last"):
            va = (a.get("audit") or {}).get(field)
            vb = (b.get("audit") or {}).get(field)
            if va is not None or vb is not None:
                row(f"audit.{field}", va, vb)
    if "memory" in a or "memory" in b:
        def mem(s, *path):
            node = s.get("memory") or {}
            for p in path:
                node = (node or {}).get(p) if isinstance(node, dict) \
                    else None
            return node
        for field in ("total_bytes", "wire_watermark_bytes",
                      "state_bytes_per_rank", "headroom_frac"):
            va, vb = mem(a, "predicted", field), mem(b, "predicted", field)
            if va is not None or vb is not None:
                row(f"mem.predicted.{field}", va, vb)
        progs_a = {r["program"]: r for r in mem(a, "compiled") or []}
        progs_b = {r["program"]: r for r in mem(b, "compiled") or []}
        for prog in sorted(set(progs_a) | set(progs_b)):
            for field in ("temp_bytes", "residual_frac"):
                va = (progs_a.get(prog) or {}).get(field)
                vb = (progs_b.get(prog) or {}).get(field)
                if va is not None or vb is not None:
                    row(f"mem.{prog}.{field}", va, vb)
        va, vb = mem(a, "live", "peak_bytes"), mem(b, "live", "peak_bytes")
        if va is not None or vb is not None:
            row("mem.live.peak_bytes", va, vb)
    if "health" in a or "health" in b:
        row("health.failed", (a.get("health") or {}).get("n_failed"),
            (b.get("health") or {}).get("n_failed"))
    return rows


def format_diff(a: Dict[str, object], b: Dict[str, object],
                label_a: str = "a", label_b: str = "b") -> str:
    rows = _diff_rows(a, b)
    renamed = [{"metric": r["metric"], label_a: r["a"], label_b: r["b"]}
               for r in rows]
    lines = [f"== diff: {label_a} vs {label_b} =="]
    lines += ["  " + ln for ln in _table(renamed,
                                         ["metric", label_a, label_b])]
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Summarize a telemetry JSONL log, or diff two.")
    ap.add_argument("log", help="path to telemetry.jsonl")
    ap.add_argument("log_b", nargs="?", default=None,
                    help="a second log: print the two runs side by side "
                         "(steps/s, per-tier bytes, drift, audit, memory, "
                         "health) instead of one full report")
    ap.add_argument("--validate", action="store_true",
                    help="schema-check every record before summarizing")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also write the summary dict as JSON")
    args = ap.parse_args(argv)
    records = load(args.log, validate=args.validate)
    if args.validate:
        print(f"validated {len(records)} records OK")
    summary = summarize(records)
    if args.log_b:
        other = summarize(load(args.log_b, validate=args.validate))
        print(format_diff(summary, other, label_a=args.log,
                          label_b=args.log_b))
        return 0
    print(format_report(summary))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=2, default=str)
        print(f"\nwrote {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
