"""Every cell of BENCHMARK.json loads from its files, and the file keeps to
the benchmark's contract."""

import json
import re

import pytest

from portbench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("work", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_loads(work):
    cell = harness.Cell.load(work["name"])
    assert cell.config["name"] == work["config"]
    assert (harness.BENCH / "kinds" / f"{cell.traffic['kind']}.py").exists()
    assert hasattr(harness.kind_module(cell.traffic["kind"]), "run")
    assert cell.limits and all(isinstance(v, (int, float)) for v in cell.limits.values())
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").exists()


def test_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    configs = {c["name"] for c in BENCH["configs"]}
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == configs
    for c in BENCH["configs"]:
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert c["file"].startswith("portbench/") and cfg["reduced"] == c["reduced"]
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        layers.setdefault(m["layer"], m["layer"])
        if m["name"].endswith("_roofline") or "roofline" in m["name"]:
            assert m["unit"] == "%"
    for w in BENCH["workloads"]:
        cell = harness.Cell.load(w["name"])
        assert any(m["name"] != "setup_s" for m in cell.end_to_end)


def test_traffic_files_are_data():
    """A traffic mix is a data file that one general driver reads."""
    for w in BENCH["workloads"]:
        mix = json.loads((harness.BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert mix["kind"] and mix["why"]
