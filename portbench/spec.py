"""Resolving a cell of ``BENCHMARK.json`` to its files, by name.

A cell (an entry of ``workloads``) pairs a configuration and a traffic
mix. Everything that belongs to one of them, or to one metric, sits in a
file of its own under the benchmark's directory, found by its name:

* ``configs/<config>.json`` (the ``file`` of the configuration's entry),
  which names its plain reference, ``reference/<reference>.py``, and the
  adapter that drives the program, ``programs/<program>.py``;
* ``traffic/<traffic>.json``, read by ``traffic.py``;
* ``metrics/<metric>.py``, one reader a metric (``read(run)``);
* ``limits/<workload>.json``, the limit of each number the output check
  compares in that cell, with the readings it was set from.

So a later change adds a cell, a configuration, a mix or a metric by
adding files and entries, and edits none that is there.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, bench: dict, workload: str, bench_dir: Path,
                 root: Path):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r}; the benchmark has "
                           f"{sorted(cells)}")
        self.bench, self.dir, self.root = bench, Path(bench_dir), Path(root)
        self.entry = cells[workload]
        self.name = workload
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = json.loads(
            (self.root / self.config_entry["file"]).read_text())
        self.traffic_name = self.entry["traffic"]
        self.end_to_end = [m for m in bench["end_to_end"]
                           if self._reports(m)]
        self.per_layer = [m for m in bench["per_layer"] if self._reports(m)]
        limits = self.dir / "limits" / f"{workload}.json"
        self.limits = json.loads(limits.read_text())
        self.peaks = json.loads((self.dir / "peaks.json").read_text())

    def _reports(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def traffic(self) -> dict:
        from . import traffic

        return traffic.load_mix(self.traffic_name, self.dir / "traffic")

    def module(self, kind: str, name: str):
        """``<kind>/<name>.py`` of the benchmark's directory, loaded by
        path (a module of its own each, so a later file never clashes)."""
        path = self.dir / kind / f"{name}.py"
        key = f"_portbench_{kind}_{name}"
        if key not in sys.modules:
            spec = importlib.util.spec_from_file_location(key, path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[key] = mod
            spec.loader.exec_module(mod)
        return sys.modules[key]

    def reader(self, metric: dict):
        return self.module("metrics", metric["name"]).read


def load(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def problems(bench: dict, bench_dir: Path = HERE, root: Path = ROOT
             ) -> List[str]:
    """What in ``bench`` breaks the naming rules or names a missing file."""
    out: List[str] = []
    bench_dir, root = Path(bench_dir), Path(root)

    def name_ok(what, n):
        if not isinstance(n, str) or not NAME.match(n):
            out.append(f"{what}: bad name {n!r}")

    seen: Dict[str, set] = {"configs": set(), "workloads": set(),
                            "metrics": set()}
    files = set()
    for c in bench["configs"]:
        name_ok("config", c["name"])
        for k in c["reduced"]:
            name_ok(f"config {c['name']} reduced", k)
        if c["file"] in files:
            out.append(f"config {c['name']}: file {c['file']} shared")
        files.add(c["file"])
        if c["name"] in seen["configs"]:
            out.append(f"config {c['name']} twice")
        seen["configs"].add(c["name"])
        path = root / c["file"]
        if not path.is_file():
            out.append(f"config {c['name']}: no file {c['file']}")
            continue
        cfg = json.loads(path.read_text())
        for kind in ("reference", "program"):
            if not (bench_dir / ("reference" if kind == "reference"
                                 else "programs")
                    / f"{cfg[kind]}.py").is_file():
                out.append(f"config {c['name']}: no {kind} {cfg[kind]}")
    pairs = set()
    for w in bench["workloads"]:
        for k in ("name", "config", "traffic"):
            name_ok(f"workload {k}", w[k])
        if w["name"] in seen["workloads"]:
            out.append(f"workload {w['name']} twice")
        seen["workloads"].add(w["name"])
        if (w["config"], w["traffic"]) in pairs:
            out.append(f"workload {w['name']}: pair repeated")
        pairs.add((w["config"], w["traffic"]))
        if w["config"] not in seen["configs"]:
            out.append(f"workload {w['name']}: no config {w['config']}")
        if not (bench_dir / "traffic" / f"{w['traffic']}.json").is_file():
            out.append(f"workload {w['name']}: no traffic {w['traffic']}")
        if not (bench_dir / "limits" / f"{w['name']}.json").is_file():
            out.append(f"workload {w['name']}: no limits file")
    for group in ("end_to_end", "per_layer"):
        for m in bench[group]:
            name_ok(group, m["name"])
            if m["name"] in seen["metrics"]:
                out.append(f"metric {m['name']} twice")
            seen["metrics"].add(m["name"])
            if not UNIT.match(m["unit"]):
                out.append(f"metric {m['name']}: bad unit {m['unit']!r}")
            if m["better"] not in ("lower", "higher"):
                out.append(f"metric {m['name']}: better {m['better']!r}")
            if not (bench_dir / "metrics" / f"{m['name']}.py").is_file():
                out.append(f"metric {m['name']}: no reader")
            for w in m.get("workloads", []):
                if w not in seen["workloads"]:
                    out.append(f"metric {m['name']}: no workload {w}")
    return out
