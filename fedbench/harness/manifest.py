"""Everything a cell is made of, found by the names in ``BENCHMARK.json``:
the cell (``fedbench/workloads/<cell>.json``: its limits and the kernels
its rooflines read), its configuration (the file ``BENCHMARK.json`` names,
``as_run`` being what the program runs), its traffic
(``fedbench/traffic/<traffic>.json``), the family's reference
(``fedbench/reference/<family>.py``) and arithmetic
(``fedbench/work/<family>.py``) and one reader per per-layer metric
(``fedbench/metrics/<metric>.py``)."""
from __future__ import annotations

import importlib
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "fedbench"


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return _json(ROOT / "BENCHMARK.json")


class Cell:
    def __init__(self, name: str, bench: dict = None):
        bench = bench or manifest()
        entry = {w["name"]: w for w in bench["workloads"]}.get(name)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = entry
        self.spec = _json(HERE / "workloads" / f"{name}.json")
        conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
        self.config = _json(ROOT / conf["file"])
        self.traffic = _json(HERE / "traffic" / f"{entry['traffic']}.json")
        self.family = self.config["family"]
        self.c = dict(self.config["as_run"])
        # the traffic draws from the source's vocabulary; the model may pad
        # its embedding beyond it, as the published checkpoint does
        self.vocab = int(self.config.get("vocab_size", self.c["vocab_size"]))
        self.reference = importlib.import_module(
            f"fedbench.reference.{self.family}")
        self.work = importlib.import_module(f"fedbench.work.{self.family}")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]

    def reader(self, metric: str):
        """The reader of a per-layer metric, found by its name."""
        return importlib.import_module(f"fedbench.metrics.{metric}").read
