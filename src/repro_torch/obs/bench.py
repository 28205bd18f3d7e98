"""BENCH perf ledger: the canonical ``BENCH_<name>.json`` writer/reader.

One ledger is a JSON file ``{"schema": "repro.obs.bench/v1", "meta":
{...}, "records": [...]}`` where each record is one measured
(bench, config, mesh, pipeline, kernels) cell with a flat ``metrics``
dict of numbers — the schema lives in :mod:`repro_torch.obs.events`
(``validate_bench_record``), unchanged from the reference, so
``results/bench_compare.py`` diffs a port ledger against any other.
The port's writers:

  * ``repro_torch.launch.train --profile DIR`` — the folded-profile
    metrics of a real run (s/step, comm fraction, overlap efficiency,
    attributed fraction, and the ``mem_*`` cells with ``--memory on``);
  * ``repro_torch.benchmarks.{throughput_scaling,comm_fraction,
    variance_stability} --ledger`` — the analytic Fig. 5 / Table 1 cells
    and the Fig. 2 result.

The port of ``repro/obs/bench.py``.
"""
from __future__ import annotations

import json
import time
from typing import Dict, Iterable, List, Optional, Sequence

from repro_torch.obs.events import (BENCH_SCHEMA, bench_key,
                              validate_bench_record)


def bench_record(bench: str, config: str, mesh: Sequence[int],
                 pipeline: int, kernels: bool,
                 metrics: Dict[str, float], t: Optional[float] = None
                 ) -> dict:
    """Build + validate one ledger record."""
    rec = {"bench": str(bench), "config": str(config),
           "mesh": [int(m) for m in mesh], "pipeline": int(pipeline),
           "kernels": bool(kernels),
           "metrics": {k: v for k, v in metrics.items()},
           "t": time.time() if t is None else float(t)}
    return validate_bench_record(rec)


def _numeric_items(d: dict) -> Dict[str, float]:
    out = {}
    for k, v in d.items():
        if isinstance(v, bool):
            out[k] = int(v)
        elif isinstance(v, (int, float)):
            out[k] = v
    return out


def records_from_result(bench: str, result,
                        mesh: Sequence[int] = (1,), pipeline: int = 1,
                        kernels: bool = False) -> List[dict]:
    """Flatten an arbitrary benchmark result into ledger records.

    The benchmarks return heterogeneous shapes — a flat dict of
    scalars, a dict with list/dict values, a list of row dicts.  The
    flattening keeps every NUMBER it can name and drops the rest
    (strings, nested blobs):

      * a dict result is one record (``config="all"``) of its scalar
        entries, plus one record per dict-valued entry (``config`` = the
        key) and one per element of list-of-dict entries (``config`` =
        ``key[i]``);
      * a list of dicts is one record per row (``config`` = the row's
        ``label``/``network``/``name`` field when present, else its
        index).

    Rows with no numeric fields produce no record.
    """
    records: List[dict] = []

    def add(config, d):
        metrics = _numeric_items(d)
        if metrics:
            records.append(bench_record(bench, config, mesh, pipeline,
                                        kernels, metrics))

    if isinstance(result, dict):
        add("all", result)
        for key, value in result.items():
            if isinstance(value, dict):
                add(key, value)
            elif isinstance(value, list) and value and \
                    all(isinstance(r, dict) for r in value):
                for i, row in enumerate(value):
                    add(f"{key}[{i}]", row)
    elif isinstance(result, list) and \
            all(isinstance(r, dict) for r in result):
        for i, row in enumerate(result):
            label = next((str(row[k]) for k in
                          ("label", "name", "network", "config")
                          if k in row), str(i))
            extra = {k: str(row[k]) for k in ("gpus", "n")
                     if k in row and str(row[k]) not in label}
            config = "/".join([label, *extra.values()])
            add(config, row)
    return records


def write_ledger(path: str, records: Iterable[dict],
                 meta: Optional[dict] = None) -> dict:
    """Validate + write one ledger; returns the written payload."""
    recs = [validate_bench_record(r) for r in records]
    payload = {"schema": BENCH_SCHEMA, "meta": dict(meta or {}),
               "records": recs}
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=False)
        f.write("\n")
    return payload


def load_ledger(path: str) -> dict:
    """Read + validate one ledger file."""
    with open(path) as f:
        payload = json.load(f)
    schema = payload.get("schema")
    if schema != BENCH_SCHEMA:
        raise ValueError(f"{path}: unknown ledger schema {schema!r} "
                         f"(expected {BENCH_SCHEMA!r})")
    for i, rec in enumerate(payload.get("records", [])):
        try:
            validate_bench_record(rec)
        except ValueError as e:
            raise ValueError(f"{path}: record {i}: {e}") from None
    return payload


def merge_ledgers(*payloads: dict) -> List[dict]:
    """Concatenate ledger records, later payloads overriding earlier
    ones on equal :func:`~repro_torch.obs.events.bench_key`."""
    by_key = {}
    for payload in payloads:
        for rec in payload.get("records", []):
            by_key[bench_key(rec)] = rec
    return [by_key[k] for k in sorted(by_key, key=str)]
