"""``BENCHMARK.json`` against the benchmark's contract, and every file it
names present: configurations, traffic mixes, limits and metric readers."""
import json
import math
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
CELLS = [w["name"] for w in MAN["workloads"]]
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(MAN) == TOP
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    cmd = MAN["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(c) for c in cmd)
    for word in cmd[1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in MAN["paths"])
            assert (ROOT / word).exists()
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits the driver's time
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entries():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MAN[group]:
            assert NAME.match(e["name"]), e["name"]
            assert e["name"] not in seen
            seen.add(e["name"])
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_configs():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in MAN["paths"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) and k in body for k in c["reduced"])
        assert (ROOT / "portbench" / "reference"
                / f"{body['reference']}.py").exists()
        assert (ROOT / "portbench" / "flops"
                / f"{body['flops']}.py").exists()
        assert any(w["config"] == c["name"] for w in MAN["workloads"])
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))


def test_workloads():
    pairs = set()
    n4 = 0
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert _line(w["why"]) and w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        t = json.loads((ROOT / "portbench" / "traffic"
                        / f"{w['traffic']}.json").read_text())
        assert math.prod(int(x) for x in t["mesh"].split("x")) \
            == w["chips"]
        lim = json.loads((ROOT / "portbench" / "limits"
                          / f"{w['name']}.json").read_text())
        assert lim and all(v["limit"] > 0 for v in lim.values())
        n4 += w["chips"] == 4
    assert n4 <= max(1, len(MAN["workloads"]) // 4)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_its_metrics(cell):
    """Every cell reports setup_s, another end-to-end metric and a
    per-layer metric; each per-layer metric's cells report the metric it
    moves; every metric has a reader."""
    def mine(ms):
        return [m for m in ms if "workloads" not in m or cell in
                m["workloads"]]
    e2e = {m["name"] for m in mine(MAN["end_to_end"])}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = mine(MAN["per_layer"])
    assert layer
    for m in layer:
        assert m["moves"] in e2e
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert all(w in CELLS for w in m.get("workloads", ()))
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()


def test_every_file_under_paths_is_named_from_name_characters():
    for p in MAN["paths"]:
        for f in (ROOT / p).rglob("*"):
            if "__pycache__" in f.parts:
                continue
            rel = f.relative_to(ROOT).as_posix()
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
