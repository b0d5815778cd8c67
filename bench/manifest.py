"""``BENCHMARK.json`` and the files it names, found by name.

A cell's configuration is ``bench/configs/<config>.json`` (the ``file``
of its ``configs`` entry), its traffic mix ``bench/mixes/<traffic>.json``
and each per-layer metric's reader ``bench/metrics/<metric>.py``.  The
root is any checkout that holds ``BENCHMARK.json``; tests point it at a
scratch copy.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[1]
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
# top-level module names the benchmark's process may never hold: JAX and
# the JAX package (compared whole, so ``repro_torch`` is not ``repro``)
FORBIDDEN_MODULES = frozenset({"jax", "jaxlib", "flax", "repro"})


@dataclass
class Cell:
    """One entry of ``workloads`` with everything it names, loaded."""

    root: Path
    workload: dict
    config: dict        # the configuration file's contents
    mix: dict           # the traffic mix file's contents
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def name(self) -> str:
        return self.workload["name"]


def load(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def mix_path(root: Path, traffic: str) -> Path:
    return Path(root) / "bench" / "mixes" / f"{traffic}.json"


def reader_path(root: Path, metric: str) -> Path:
    return Path(root) / "bench" / "metrics" / f"{metric}.py"


def reports(metric: dict, cell_name: str) -> bool:
    """Whether a metric is reported in a cell (all cells without a
    ``workloads`` key)."""
    return cell_name in metric.get("workloads", [cell_name])


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of the manifest at ``root``; raises KeyError for
    an unknown cell."""
    man = load(root)
    work = {w["name"]: w for w in man["workloads"]}[name]
    conf = {c["name"]: c for c in man["configs"]}[work["config"]]
    config = json.loads((Path(root) / conf["file"]).read_text())
    mix = json.loads(mix_path(root, work["traffic"]).read_text())
    return Cell(
        root=Path(root), workload=work, config=config, mix=mix,
        end_to_end=[m for m in man["end_to_end"] if reports(m, name)],
        per_layer=[m for m in man["per_layer"] if reports(m, name)],
    )


def load_reader(root: Path, metric: str) -> ModuleType:
    """The reader module of a per-layer metric: ``read(ctx)`` returns the
    value, or None where the trace holds nothing to read."""
    path = reader_path(root, metric)
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_readers(c: Cell) -> Dict[str, ModuleType]:
    return {m["name"]: load_reader(c.root, m["name"]) for m in c.per_layer}


def forbidden_modules(names) -> List[str]:
    """The forbidden top-level names among module names ``names``."""
    return sorted({n.split(".")[0] for n in names} & FORBIDDEN_MODULES)


def read_json(name: str) -> dict:
    """A data file of this package (``layers.json``, ``peaks.json``)."""
    return json.loads((Path(__file__).resolve().parent / name).read_text())
