"""`BENCHMARK.json` and the files it names, found by name.

A cell (an entry of `workloads`) names a configuration and a traffic
mix. The configuration's file is the entry's `file`; the traffic mix is
`portbench/traffic/<traffic>.json`, whose `driver` names the module
`portbench/drivers/<driver>.py` that runs it; a per-layer metric is
read by `portbench/metrics/<metric name>.py`; the limits of a cell's
correctness check are `portbench/limits/<cell>.json`. A later change
adds a cell, a configuration or a metric by adding such files and
entries, never by editing one that is there.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "portbench"

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def valid_name(s: str) -> bool:
    return isinstance(s, str) and bool(NAME_RE.match(s))


def valid_unit(s: str) -> bool:
    return isinstance(s, str) and bool(UNIT_RE.match(s))


@dataclass
class Metric:
    name: str
    unit: str
    workloads: Optional[List[str]]

    def applies_to(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict


class Manifest:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        with open(self.root / "BENCHMARK.json") as fp:
            self.raw = json.load(fp)
        self.configs = {c["name"]: c for c in self.raw["configs"]}
        self.workloads = {w["name"]: w for w in self.raw["workloads"]}
        self.end_to_end, self.per_layer = (
            [Metric(m["name"], m["unit"], m.get("workloads"))
             for m in self.raw[group]] for group in ("end_to_end",
                                                     "per_layer"))

    def cell(self, name: str) -> Cell:
        """A cell of BENCHMARK.json."""
        if name not in self.workloads:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"known: {sorted(self.workloads)}")
        w = self.workloads[name]
        conf_file = self.root / self.configs[w["config"]]["file"]
        return Cell(name=name, chips=int(w["chips"]),
                    config=load_json(conf_file),
                    traffic=load_json(BENCH_DIR / "traffic"
                                      / f"{w['traffic']}.json"),
                    limits=load_json(BENCH_DIR / "limits" / f"{name}.json"))

    def metrics_for(self, cell: str, trace: bool) -> List[Metric]:
        pool = self.per_layer if trace else self.end_to_end
        return [m for m in pool if m.applies_to(cell)]


def load_json(path: Path) -> dict:
    with open(path) as fp:
        return json.load(fp)


def load_module(path: Path, name: str):
    """Import a file by path (metric files carry dots in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The reader module of per-layer metric `name`."""
    return load_module(BENCH_DIR / "metrics" / f"{name}.py",
                       "portbench_metric_" + name.replace(".", "_")
                       .replace("-", "_"))


def readers(metrics: List[Metric]) -> Dict[str, object]:
    return {m.name: metric_reader(m.name) for m in metrics}
