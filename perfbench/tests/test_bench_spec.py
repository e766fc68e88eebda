"""BENCHMARK.json against the benchmark's rules, and every file a cell is
found by; the entries of a cell held out of it (``perfbench/parked``) are
held to the same rules, so that adding them back is valid."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def with_parked(bench):
    """``bench`` with the held-out cells' entries added."""
    full = json.loads(json.dumps(bench))
    for path in sorted((ROOT / "perfbench" / "parked").glob("*.json")):
        parked = json.loads(path.read_text())
        for key in ("workloads", "end_to_end", "per_layer"):
            full[key] += parked[key]
    return full


FULL = with_parked(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source", "bound", "layer", "moves",
               "workloads"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def all_names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in FULL[group]:
            yield group, entry["name"]
    for w in FULL["workloads"]:
        yield "config", w["config"]
        yield "traffic", w["traffic"]
    for c in FULL["configs"]:
        for k in c["reduced"]:
            yield "reduced", k


@pytest.mark.parametrize("group,name", list(all_names()))
def test_name_characters(group, name):
    assert NAME.match(name), (group, name)


@pytest.mark.parametrize("metric", FULL["end_to_end"] + FULL["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    assert set(metric) <= METRIC_KEYS
    cells = {w["name"] for w in FULL["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert TEXT.match(metric["layer"])
        assert metric["moves"] in {m["name"] for m in FULL["end_to_end"]}


def test_unique_names():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in FULL[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in FULL["end_to_end"] + FULL["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in FULL["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", FULL["workloads"], ids=lambda w: w["name"])
def test_cell_files_and_metrics(cell):
    pb = ROOT / "perfbench"
    assert cell["chips"] in (1, 4) and TEXT.match(cell["why"])
    conf = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    assert (ROOT / conf["file"]).is_file()
    mix = json.loads((pb / "traffic" / (cell["traffic"] + ".json"))
                     .read_text())
    assert (pb / "entries" / (mix["entry"] + ".py")).is_file()
    assert (pb / "limits" / (cell["name"] + ".json")).is_file()

    def reported(kind):
        return [m for m in FULL[kind]
                if "workloads" not in m or cell["name"] in m["workloads"]]
    e2e, layer = reported("end_to_end"), reported("per_layer")
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert layer
    for m in e2e:
        assert (pb / "e2e" / (m["name"] + ".py")).is_file()
    for m in layer:
        assert (pb / "layer_metrics" / (m["name"] + ".py")).is_file()
        assert m["moves"] in [x["name"] for x in e2e]


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])
    assert conf["file"].startswith("perfbench/")
    assert TEXT.match(conf["source"]) and TEXT.match(conf["why"])
    data = json.loads((ROOT / conf["file"]).read_text())
    assert data["name"] == conf["name"]
    assert data["reduced"] == conf["reduced"] == []
    assert (ROOT / data["reference"]).is_file()


def test_run_seconds_fits_a_full_check():
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("in_flight,ok", [(None, True), (1, True), (4, False)])
def test_traffic_in_flight(tmp_path, in_flight, ok):
    """The window keeps one request in flight: a mix that states more is
    refused, not measured as one."""
    from perfbench.lib import traffic

    mix = json.loads((ROOT / "perfbench" / "traffic" / "edge.b16.json")
                     .read_text())
    if in_flight is not None:
        mix["in_flight"] = in_flight
    (tmp_path / "perfbench" / "traffic").mkdir(parents=True)
    (tmp_path / "perfbench" / "traffic" / "x.json").write_text(
        json.dumps(mix))
    if ok:
        assert traffic.load(tmp_path, "x")["batch"] == mix["batch"]
    else:
        with pytest.raises(ValueError, match="in flight"):
            traffic.load(tmp_path, "x")
