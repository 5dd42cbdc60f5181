"""BENCHMARK.json against the benchmark's contract, and the files it names
found by name."""

import json

import pytest
from _small import ROOT

from portbench.lib import manifest as mf

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
CELLS = {w["name"]: w for w in BENCH["workloads"]}


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16
    assert len(BENCH["command"]) <= 32
    assert len(json.dumps(BENCH)) <= 64 * 1024
    for p in BENCH["paths"]:
        assert (ROOT / p).is_dir() and not p.startswith("/")
        assert ".." not in p.split("/") and not p.endswith("_torch")
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word.split("/")


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda e: e["name"])
def test_names_units_and_text(entry):
    assert mf.valid_name(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            v = entry[key]
            assert 1 <= len(v) <= 200 and "\n" not in v and "\t" not in v
    if "unit" in entry:
        assert mf.valid_unit(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")


def test_unique_names():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    assert conf["file"].startswith(BENCH["paths"][0] + "/")
    data = json.loads((ROOT / conf["file"]).read_text())
    assert data["reduced"] == conf["reduced"] == []
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])
    assert conf["source"].startswith("https://")


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_files_found_by_name(name):
    w = CELLS[name]
    assert w["chips"] in (1, 4)
    cell = mf.Manifest(ROOT).cell(name)
    driver = cell.traffic["driver"]
    assert (ROOT / "portbench" / "drivers" / f"{driver}.py").is_file()
    checks = {k: v for k, v in cell.limits.items() if isinstance(v, dict)}
    assert checks and all(v["lower"] < v["limit"] < v["upper"]
                          for v in checks.values())
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer one
    man = mf.Manifest(ROOT)
    e2e = [m.name for m in man.metrics_for(name, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert man.metrics_for(name, True)


def test_four_chip_share():
    fours = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert fours <= max(1, len(BENCH["workloads"]) // 4)


def test_end_to_end_bounds():
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_reader(m):
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}
    assert m["moves"] in E2E
    reader = mf.metric_reader(m["name"])
    assert (reader.LAYER, reader.UNIT, reader.MOVES) == (
        m["layer"], m["unit"], m["moves"])
    moved = E2E[m["moves"]]
    for cell in m["workloads"]:
        assert cell in CELLS
        assert moved.get("workloads") is None or cell in moved["workloads"]
    if m["name"].endswith("_roofline") or "roofline" in m["name"] \
            or "mfu" in m["name"]:
        assert m["unit"] == "%"


def test_layers_named_alike():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


@pytest.mark.parametrize("bad", ["", "a b", "a,b", "a/b", "x" * 65, "-a",
                                 "µs"])
def test_name_rule_refuses(bad):
    assert not mf.valid_name(bad)


@pytest.mark.parametrize("bad", ["", "tokens per s", "x" * 17,
                                 "µs"])
def test_unit_rule_refuses(bad):
    assert not mf.valid_unit(bad)


def test_unit_rule_accepts():
    for good in ("frames/s", "%", "ms", "steps/s", "ops", "frames"):
        assert mf.valid_unit(good)


@pytest.mark.parametrize("path", sorted(
    p for p in (ROOT / "portbench" / "metrics").glob("*.py")
    if not p.name.startswith("_")), ids=lambda p: p.stem)
def test_every_reader_declares_itself(path):
    reader = mf.metric_reader(path.stem)
    assert mf.valid_name(path.stem) and mf.valid_unit(reader.UNIT)
    assert reader.MOVES and reader.LAYER and callable(reader.read)
    assert reader.read({"summary": None, "layer": {}, "config": {},
                        "traffic": {}, "flops": None}) is None
