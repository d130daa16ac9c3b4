"""Finding a cell from files: ``<config>.<mix>`` names
``configs/<config>.json`` and ``mixes/<mix>.json``; the mix's ``kind``
names ``traffic/<kind>.py``; a metric ``m`` is read by
``metrics/<m>.py``; the limits of a cell's correctness check sit in
``limits/<cell>.json``; the config's published ``model_type`` names
``archs/<model_type>.py``, which makes the weights, the port's config
and parameters, the plain reference and the architecture's counts.
``BENCHMARK.json`` at the root says which metrics a cell reports."""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    limits: Dict[str, float] = field(default_factory=dict)

    @property
    def arch(self):
        """The architecture of the cell's config (:func:`arch_of`)."""
        return arch_of(self.config)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(workload: str) -> Cell:
    """The cell ``workload`` from the benchmark's files."""
    config, _, mix = workload.partition(".")
    if not config or not mix:
        raise ValueError(f"a workload is <config>.<mix>, got {workload!r}")
    lim = HERE / "limits" / f"{workload}.json"
    cfg = load_json(HERE / "configs" / f"{config}.json")
    arch_of(cfg)
    return Cell(workload, cfg, load_json(HERE / "mixes" / f"{mix}.json"),
                load_json(lim) if lim.exists() else {})


_plugins: Dict[str, object] = {}


def plugin(kind: str, name: str):
    """The module ``<kind>/<name>.py`` beside this file, loaded once."""
    path = HERE / kind / f"{name}.py"
    key = str(path)
    if key not in _plugins:
        if str(HERE) not in sys.path:
            sys.path.insert(0, str(HERE))
        mod_name = "h100bench_" + f"{kind}_{name}".replace(".", "_") \
            .replace("-", "_")
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _plugins[key] = mod
    return _plugins[key]


def arch_of(cfg: dict):
    """The module ``archs/<model_type>.py`` of the config ``cfg``; a
    ``FileNotFoundError`` naming the path where there is none."""
    path = HERE / "archs" / f"{cfg.get('model_type')}.py"
    if not path.is_file():
        raise FileNotFoundError(
            f"config {cfg.get('name')!r}: no architecture for model_type "
            f"{cfg.get('model_type')!r}; {path} is missing")
    return plugin("archs", cfg["model_type"])


def metrics_of(workload: str, trace: bool,
               bench: Optional[dict] = None) -> List[dict]:
    """The metrics ``BENCHMARK.json`` gives the cell: end-to-end without a
    trace, per-layer with one.  Each lists its cells, or reports in every
    cell when it lists none."""
    if bench is None:
        bench = load_json(ROOT / "BENCHMARK.json")
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def all_metrics(trace: bool) -> List[dict]:
    """Every metric that has a reader, for a cell the benchmark does not
    list: the unit is the reader's own."""
    names = sorted(p.stem for p in (HERE / "metrics").glob("*.py"))
    out = []
    for n in names:
        mod = plugin("metrics", n)
        if bool(getattr(mod, "TRACED", False)) == trace:
            out.append({"name": n, "unit": mod.UNIT})
    return out
