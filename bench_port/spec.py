"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; everything else follows from names, so a new cell, configuration,
mix or per-layer metric is new files and new entries, never an edit:

    configs[].file                      the configuration (JSON); its
                                        "problem" names the two files below
    bench_port/problems/<problem>.py    the port's side: operators, starts, solver
    bench_port/reference/<problem>.py   the plain reference (imports nothing of the port)
    bench_port/mixes/<traffic>.json     the traffic mix; its "kind" names
    bench_port/drivers/<kind>.py        the driver that runs that kind of mix
    bench_port/layers/<metric>.py       the reader of one per-layer metric

Modules are loaded from their files under the root given, so a test can
lay out a root of its own.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import sys

HARNESS = "bench_port"
_MODULES: dict = {}


def load_module(path: pathlib.Path):
    """The module of one harness file, loaded once per path."""
    path = pathlib.Path(path).resolve()
    if path not in _MODULES:
        if not path.is_file():
            raise FileNotFoundError(f"no harness file {path}")
        name = f"_bench_port_{path.parent.name}_{path.stem}_{len(_MODULES)}"
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
        _MODULES[path] = module
    return _MODULES[path]


@dataclasses.dataclass
class Cell:
    """One workload of BENCHMARK.json with the files it names."""

    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list  # the end_to_end entries this cell reports
    per_layer: list  # the per_layer entries this cell reports
    all_per_layer: list  # every per_layer entry, in BENCHMARK.json's order
    root: pathlib.Path

    def module(self, folder: str, name: str):
        """``bench_port/<folder>/<name>.py`` under this cell's root."""
        return load_module(self.root / HARNESS / folder / f"{name}.py")

    def driver(self):
        return self.module("drivers", self.mix["kind"])

    def problem(self):
        return self.module("problems", self.config["problem"])

    def reference(self):
        return self.module("reference", self.config["problem"])

    def layer(self, metric: str):
        return self.module("layers", metric)


def _applies(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric.get("moves") in e2e_names


def load_cell(root, name: str) -> Cell:
    """The cell ``name`` of ``root``/BENCHMARK.json; raises KeyError for
    a name it does not hold."""
    root = pathlib.Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    mix = json.loads(
        (root / HARNESS / "mixes" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, None)]
    e2e_names = {m["name"] for m in e2e}
    layers = [m for m in bench["per_layer"] if _applies(m, name, e2e_names)]
    return Cell(name=name, chips=int(w["chips"]), config=config, mix=mix,
                end_to_end=e2e, per_layer=layers,
                all_per_layer=list(bench["per_layer"]), root=root)
