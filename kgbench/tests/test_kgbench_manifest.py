"""BENCHMARK.json against the contract's rules: names, units and lengths,
each entry's keys, the files each entry names, and each per-layer
metric's cells reporting the end-to-end metric that it moves."""

import json
import re

import pytest

from kgbench.run import KGBENCH, ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
TEXT = ("why", "layer", "source")


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "kgbench/run.py"]
    assert BENCH["paths"] == ["kgbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", list(KEYS))
def test_entries(section):
    entries = BENCH[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra
        assert NAME.match(e["name"]), e["name"]
        for key in TEXT:
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                    and "\t" not in e[key]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")


def test_configs_and_cells_point_at_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in configs.values():
        assert c["file"] == f"kgbench/configs/{c['name']}.json"
        assert (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank", "_dims"))
                       for k in c["reduced"])
    used = set()
    pairs = set()
    for w in BENCH["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])
        assert (KGBENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (KGBENCH / "limits" / f"{w['name']}.json").is_file()
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
    assert used == set(configs)
    assert len(pairs) == len(BENCH["workloads"])
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics_and_their_cells():
    cells = {w["name"] for w in BENCH["workloads"]}
    ends = {m["name"]: set(m.get("workloads", cells))
            for m in BENCH["end_to_end"]}
    assert "setup_s" in ends and ends["setup_s"] == cells
    bound = {m["name"]: m["bound"] for m in BENCH["end_to_end"]}
    assert all(0.01 <= b <= 0.25 for b in bound.values())
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in ends
        wl = set(m.get("workloads", ends[m["moves"]]))
        assert wl <= ends[m["moves"]], m["name"]
        assert (KGBENCH / "metrics" / f"{m['name']}.py").is_file()
        layers.setdefault(m["layer"], set()).add(m["name"])
    for cell in cells:
        reported = {n for n, wl in ends.items() if cell in wl}
        assert len(reported) >= 2
        assert any(cell in m.get("workloads", cells)
                   for m in BENCH["per_layer"])
