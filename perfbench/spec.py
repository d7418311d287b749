"""What `BENCHMARK.json` names, found by name among the files of the
benchmark's `paths`: a cell's configuration (its `file`), its traffic
(`traffic/<name>.json`), the loop its traffic names and the numbers that
judge it (`kinds/<loop>.py`), its limits (`cells/<name>.json`), each
metric's reader (`metrics/<name>.py`) and each configuration's plain
reference (`references/<name>.py`).  A later cell, traffic mix or metric is added
by adding such files and an entry, and no file is edited."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path


class Spec:
    def __init__(self, root):
        self.root = Path(root).resolve()
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        self.paths = [self.root / p for p in self.bench["paths"]]

    def find(self, kind: str, name: str, suffix: str) -> Path:
        for base in self.paths:
            path = base / kind / f"{name}{suffix}"
            if path.is_file():
                return path
        raise FileNotFoundError(f"no {kind}/{name}{suffix} under "
                                f"{self.bench['paths']}")

    def workload(self, name: str) -> dict:
        for cell in self.bench["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")

    def config(self, name: str) -> dict:
        for config in self.bench["configs"]:
            if config["name"] == name:
                return json.loads((self.root / config["file"]).read_text())
        raise KeyError(f"BENCHMARK.json has no config {name!r}")

    def traffic(self, name: str) -> dict:
        return json.loads(self.find("traffic", name, ".json").read_text())

    def cell_file(self, name: str) -> dict:
        return json.loads(self.find("cells", name, ".json").read_text())

    def _module(self, kind: str, name: str):
        path = self.find(kind, name, ".py")
        mod_name = f"perfbench_{kind}_{name}".replace(".", "_")
        spec = importlib.util.spec_from_file_location(mod_name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    def reference(self, config: dict):
        return self._module("references", config["reference"])

    def kind(self, loop: str):
        return self._module("kinds", loop)

    def reader(self, metric: str):
        return self._module("metrics", metric)

    def metrics(self, workload: str, per_layer: bool) -> list[dict]:
        """The metrics a cell reports in a run with or without the trace:
        those that list it under `workloads`, or that list none."""
        group = self.bench["per_layer" if per_layer else "end_to_end"]
        return [m for m in group
                if workload in m.get("workloads", [workload])]
