"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout names the cells; each configuration is the file its entry
names, each traffic mix ``traffic/<name>.json``, and each metric a reader
``metrics/<name>.py`` with a ``read(record)`` function that returns a number
or None (nothing to read: the metric is left out of the line).

A cell, a mix, a configuration or a metric is added as new files and
manifest entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Optional

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = Path(__file__).resolve().parent.name

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _checked_name(name: str) -> str:
    if not NAME_RE.match(name):
        raise ValueError(f"not a valid name: {name!r}")
    return name


def traffic(name: str, root: Path = ROOT) -> dict:
    return json.loads((root / PACKAGE / "traffic" / f"{_checked_name(name)}.json").read_text())


def reader(name: str, root: Path = ROOT) -> Callable[[dict], Optional[float]]:
    """The ``read`` function of ``metrics/<name>.py``, loaded from its file
    (a metric's name may hold dots, which an import path cannot)."""
    path = root / PACKAGE / "metrics" / f"{_checked_name(name)}.py"
    spec = importlib.util.spec_from_file_location(f"{PACKAGE}_metric_{re.sub(r'[.-]', '_', name)}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell(name: str, manifest: Optional[dict] = None, root: Path = ROOT) -> dict:
    """The cell ``name``: its manifest entry, configuration and traffic, and
    the metrics it reports (``end_to_end`` with ``--trace 0``, ``per_layer``
    with ``--trace 1``): those that list it in their ``workloads``, and
    those without that key: every end-to-end one, and each per-layer one
    whose ``moves`` the cell reports."""
    manifest = manifest if manifest is not None else load(root)
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in manifest["configs"] if c["name"] == entry["config"])

    def applies(metric: dict) -> bool:
        return "workloads" not in metric or name in metric["workloads"]

    end_to_end = [m for m in manifest["end_to_end"] if applies(m)]
    reported = {m["name"] for m in end_to_end}
    return {
        "workload": entry,
        "config": json.loads((root / cfg_entry["file"]).read_text()),
        "traffic": traffic(entry["traffic"], root),
        "end_to_end": end_to_end,
        "per_layer": [m for m in manifest["per_layer"]
                      if name in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in reported)],
    }
