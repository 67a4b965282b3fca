"""The cell a run measures, read from ``BENCHMARK.json`` and the files the
harness finds by name: ``configs/<config>.json`` (with its plain reference
``configs/<config>.py``), ``traffic/<traffic>.json``,
``workloads/<cell>.json`` and ``metrics/<metric>.py``."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def load_module(path: pathlib.Path, name: str):
    """The Python file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One workload: its names, configuration, traffic, checks and the
    metrics it reports."""

    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def reference(self):
        """The configuration's plain reference module."""
        name = self.config["name"]
        return load_module(HERE / "configs" / f"{name}.py", f"bench_config_{name.replace('.', '_')}")


def metric_reader(name: str):
    """``read(run)`` of ``metrics/<name>.py``."""
    return load_module(HERE / "metrics" / f"{name}.py",
                       f"bench_metric_{name.replace('.', '_')}").read


def _applies(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load_cell(name: str, bench_path: pathlib.Path | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``. Raises KeyError for a name
    it does not list."""
    bench = read_json(bench_path or ROOT / "BENCHMARK.json")
    entry = {w["name"]: w for w in bench["workloads"]}[name]
    work = read_json(HERE / "workloads" / f"{name}.json")
    if (work["config"], work["traffic"]) != (entry["config"], entry["traffic"]):
        raise ValueError(f"workloads/{name}.json names {work['config']}/{work['traffic']}, "
                         f"BENCHMARK.json {entry['config']}/{entry['traffic']}")
    config = read_json(HERE / "configs" / f"{entry['config']}.json")
    traffic = read_json(HERE / "traffic" / f"{entry['traffic']}.json")
    traffic.update(work.get("traffic_params", {}))
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, names)]
    return Cell(name, entry["chips"], config, traffic, work.get("check", {}),
                work.get("limits", {}), e2e, per_layer)
