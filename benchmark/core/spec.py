"""Finding a cell and its parts by name.

A cell of BENCHMARK.json names a configuration and a traffic mix. The
configuration's file is the one its `configs` entry gives; the mix is
traffic/<traffic>.json under the benchmark's folder, and the mix's `kind`
names drivers/<kind>.py. Each metric is metrics/<name>.py, or
metrics/<stem>.py for a name <stem>.<suffix>, and each section that a
traced run clocks is sections/<name>.json. Nothing here lists a cell, a
mix, a driver or a metric: adding one is adding its files and entries.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
REPO_ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    driver: ModuleType
    end_to_end: List[Dict] = field(default_factory=list)
    per_layer: List[Dict] = field(default_factory=list)
    bench_dir: Path = BENCH_DIR


def _load_module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _for_cell(metrics: List[Dict], cell: str) -> List[Dict]:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def load_cell(name: str, root: Path = REPO_ROOT,
              bench_dir: Optional[Path] = None) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its configuration,
    mix, driver and metrics."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench_dir = bench_dir or root / bench["paths"][0]
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    driver = _load_module(bench_dir / "drivers" / f"{traffic['kind']}.py",
                          f"bench_driver_{traffic['kind']}")
    return Cell(name, w["chips"], config, traffic, driver,
                _for_cell(bench["end_to_end"], name),
                _for_cell(bench["per_layer"], name), bench_dir)


def metric_reader(bench_dir: Path, name: str) -> ModuleType:
    """metrics/<name>.py, else metrics/<stem>.py for <stem>.<suffix>."""
    for stem in (name, name.split(".")[0]):
        path = bench_dir / "metrics" / f"{stem}.py"
        if path.is_file():
            return _load_module(path, f"bench_metric_{stem}")
    raise FileNotFoundError(f"no reader for metric {name!r}")


def sections(bench_dir: Path) -> Dict[str, List[str]]:
    """{section: ["module:attribute.path", ...]} from sections/*.json."""
    out = {}
    for path in sorted((bench_dir / "sections").glob("*.json")):
        out[path.stem] = json.loads(path.read_text())["targets"]
    return out
