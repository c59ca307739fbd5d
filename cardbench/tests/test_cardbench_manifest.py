"""BENCHMARK.json and the files it names: every configuration, traffic mix
and metric reader resolves by name, names and units keep to their
characters, and a cell, a mix, a configuration and a metric can be added as
new files and manifest entries alone."""

import json
import shutil

import pytest

from cardbench import manifest

DATA = manifest.load()
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection", "head", "expansion", "experts_per_tok")


def test_top_level_keys_and_command():
    assert set(DATA) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert DATA["paths"] == ["cardbench"]
    assert DATA["command"][:2] == ["python3", "-m"] and DATA["command"][2] == "cardbench"
    assert 1 <= DATA["run_seconds"] <= 51 and isinstance(DATA["run_seconds"], int)
    assert len(json.dumps(DATA)) < 64 * 1024


@pytest.mark.parametrize("section", sorted(ENTRY_KEYS))
def test_entries_keep_to_their_keys_and_names(section):
    names = [e["name"] for e in DATA[section]]
    assert len(names) == len(set(names))
    for e in DATA[section]:
        assert set(e) <= ENTRY_KEYS[section], e
        assert manifest.NAME_RE.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key], e[key]
        if "unit" in e:
            assert manifest.UNIT_RE.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")


def test_every_workload_resolves_and_reports_every_metric():
    metric_names = {m["name"] for m in DATA["end_to_end"] + DATA["per_layer"]}
    assert {"commit_rps", "reply_p50_ms", "setup_s"} <= metric_names
    for w in DATA["workloads"]:
        assert w["chips"] in (1, 4)
        for key in ("config", "traffic"):
            assert manifest.NAME_RE.match(w[key])
        cell = manifest.cell(w["name"], DATA)
        assert cell["config"]["name"] == w["config"]
        assert cell["traffic"]["loop"] == "closed"
        assert cell["traffic"]["source"] and cell["traffic"]["why"]
        reported = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell["per_layer"]
        # A per-layer metric is read only where the end-to-end metric it
        # moves is reported.
        assert all(m["moves"] in reported for m in cell["per_layer"])
        for m in cell["end_to_end"] + cell["per_layer"]:
            assert callable(manifest.reader(m["name"]))
    four = sum(1 for w in DATA["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(DATA["workloads"]) // 4)


def test_bounds_and_sources():
    for m in DATA["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in DATA["end_to_end"]}
    for m in DATA["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert m["layer"] and "\n" not in m["layer"]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_configs_files_and_reduced_keys():
    files = [c["file"] for c in DATA["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in DATA["workloads"]}
    for c in DATA["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("cardbench/")
        body = json.loads((manifest.ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"]
        assert set(c["reduced"]) == set(body["reduced"]) and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert manifest.NAME_RE.match(key)
            assert not key.endswith(("_dim", "_rank")) and not any(w in key for w in WIDTH_WORDS)
        assert "guarantees" in body and "assumed" in body
        assert body["replicas"] == 3 * body["f"] + 1 and len(body["byzantine"]) <= body["f"]


def test_a_cell_mix_config_and_metric_are_added_as_files_alone(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a cell
    and a per-layer metric as new files and manifest entries; they resolve
    by name, and no file that was there changed."""
    shutil.copytree(manifest.ROOT / manifest.PACKAGE, tmp_path / manifest.PACKAGE,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / manifest.PACKAGE).rglob("*") if p.is_file()}
    pkg = tmp_path / manifest.PACKAGE
    cfg = json.loads((pkg / "configs" / "pbft-n4-f1.json").read_text())
    cfg.update(name="pbft-n7-f2", replicas=7, f=2, byzantine=[6])
    (pkg / "configs" / "pbft-n7-f2.json").write_text(json.dumps(cfg))
    (pkg / "traffic" / "closed64.json").write_text(json.dumps(
        {"source": "x", "why": "x", "loop": "closed", "clients": 8, "outstanding_per_client": 8, "client_processes": 2, "operation": "null",
         "ramp_s": 2.0, "drain_s": 60.0}))
    (pkg / "metrics" / "rounds_per_s.v2.py").write_text(
        "def read(record):\n    return record['rounds'] / record['seconds']\n")
    data = json.loads(json.dumps(DATA))
    data["configs"].append({"name": "pbft-n7-f2", "source": "x", "file": "cardbench/configs/pbft-n7-f2.json",
                            "reduced": [], "why": "x"})
    data["workloads"].append({"name": "pbft-n7-f2.closed64", "config": "pbft-n7-f2", "traffic": "closed64",
                              "chips": 1, "why": "x"})
    data["per_layer"].append({"name": "rounds_per_s.v2", "unit": "round/s", "better": "higher",
                              "source": "program_counter", "layer": "replicas", "moves": "commit_rps",
                              "workloads": ["pbft-n7-f2.closed64"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    cell = manifest.cell("pbft-n7-f2.closed64", root=tmp_path)
    assert cell["config"]["replicas"] == 7 and cell["traffic"]["clients"] == 8
    # The new cell reports every per-layer metric that names no cells and
    # moves one of its end-to-end metrics, and the new metric, which names
    # it; the existing cells do not gain it.
    assert [m["name"] for m in cell["end_to_end"]] == ["commit_rps", "reply_p50_ms", "setup_s"]
    assert [m["name"] for m in cell["per_layer"]] == [
        m["name"] for m in DATA["per_layer"]
        if "workloads" not in m and m["moves"] in ("commit_rps", "reply_p50_ms")] + ["rounds_per_s.v2"]
    assert all("rounds_per_s.v2" not in [m["name"] for m in manifest.cell(w["name"], root=tmp_path)["per_layer"]]
               for w in DATA["workloads"])
    assert manifest.reader("rounds_per_s.v2", root=tmp_path)({"rounds": 30, "seconds": 10}) == 3.0
    assert all(p.read_bytes() == b for p, b in before.items())


def test_names_outside_the_characters_are_refused():
    for bad in ("a b", "a/b", "", ".x" * 40, "é"):
        with pytest.raises(ValueError):
            manifest.traffic(bad)
