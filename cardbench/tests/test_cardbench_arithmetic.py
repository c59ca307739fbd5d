"""The yardstick's arithmetic on stand-in records: percentiles, the
window, each metric reader, the ladder's bound, and the import rule."""

import ast
from pathlib import Path

import pytest

from cardbench import manifest, roofline, run, stats

PKG = manifest.ROOT / manifest.PACKAGE


def _records():
    # 10 requests sent 0.1 s apart, each answered 0.25 s later; t0 = 0.3,
    # t1 = 1.0: quorums at 0.25 ... 1.15, of which 0.35 ... 0.95 lie inside.
    return [{"client": 0, "timestamp": i, "send": 0.1 * i, "quorum": 0.1 * i + 0.25 + 0.001 * i} for i in range(10)]


def test_percentile_is_the_harness_nearest_rank():
    vals = list(range(1, 101))
    assert stats.percentile(vals, 0.5) == 51
    assert stats.percentile(vals, 0.95) == 96
    assert stats.percentile([3.0], 0.95) == 3.0
    assert stats.percentile([5, 1, 3, 2, 4], 0.5) == 3
    with pytest.raises(ValueError):
        stats.percentile([], 0.5)


def test_window_counts_quorums_inside_it():
    recs = _records() + [{"client": 1, "timestamp": 1, "send": 0.5, "quorum": None}]
    done = stats.completed_in(recs, 0.3, 1.0)
    assert [r["timestamp"] for r in done] == [1, 2, 3, 4, 5, 6, 7]
    assert stats.latencies_ms(done)[0] == pytest.approx(251.0)


def test_end_to_end_readers():
    record = {"requests": _records(), "t0": 0.3, "t1": 1.0, "seconds": 0.7, "setup_s": 31.5}
    assert manifest.reader("commit_rps")(record) == pytest.approx(7 / 0.7)
    assert manifest.reader("reply_p50_ms")(record) == pytest.approx(254.0)
    assert manifest.reader("setup_s")(record) == 31.5
    empty = dict(record, requests=[])
    assert manifest.reader("reply_p50_ms")(empty) is None


def test_per_layer_readers():
    rep = lambda ex, rounds: {"executed": ex, "rounds_executed": rounds}  # noqa: E731
    record = {
        "t0": 10.0, "t1": 20.0,
        "before": {"replicas": [rep(100, 10), rep(0, 0)], "service": {"items": 1000, "launches": 10}},
        "after": {"replicas": [rep(700, 40), rep(0, 0)], "service": {"items": 31000, "launches": 110}},
        "service_trace": [{"ev": "verify_batch", "ts": 9.0, "secs": 1.0},
                          {"ev": "verify_batch", "ts": 12.0, "secs": 0.030},
                          {"ev": "verify_batch", "ts": 13.0, "secs": 0.040},
                          {"ev": "verify_window_failed", "ts": 14.0, "secs": 5.0}],
        "profile": {"busy_s": 0.4, "window_s": 0.5,
                    "ladder": [{"grid": [256, 1, 1], "s": 0.0015}, {"grid": [64, 1, 1], "s": 0.0005}]},
    }
    assert manifest.reader("requests_per_round")(record) == pytest.approx(20.0)
    assert manifest.reader("items_per_window")(record) == pytest.approx(300.0)
    assert manifest.reader("window_ms")(record) == pytest.approx(35.0)
    assert manifest.reader("device_idle_pct")(record) == pytest.approx(20.0)
    bound = roofline.bound_s("ladder", 4096) + roofline.bound_s("ladder", 1024)
    assert manifest.reader("ladder_roofline")(record) == pytest.approx(100 * bound / 0.002)
    silent = dict(record, profile={"busy_s": 0.0, "window_s": 0.5, "ladder": []})
    assert manifest.reader("ladder_roofline")(silent) is None
    assert manifest.reader("device_idle_pct")(silent) is None


def test_ladder_bound_at_4096_rows():
    # IMAD operations per item from the counts (chip_smoke.py's), and the
    # bound at 4,096 rows over the published peak: 0.73983 ms (PERF.md's
    # table of kernels gives the same figure).
    assert roofline.OPS_PER_ITEM["ladder"] == (3021262, 2034546)
    assert roofline.bound_s("ladder", 4096) * 1e3 == pytest.approx(0.739825405, rel=1e-8)
    assert roofline.OPS_PER_ITEM["inv"][0] * 4096 / roofline.IMAD_PER_S * 1e3 == pytest.approx(0.037935, rel=1e-4)


def test_import_check_compares_whole_top_level_names():
    loaded = ["pbft_tpu_torch", "pbft_tpu_torch.net.client", "jaxlib.xla_client", "pbft_tpu.crypto", "flax",
              "jaxtyping", "pbft_tpu_tools"]
    assert run.forbidden_modules(loaded) == ["flax", "jaxlib.xla_client", "pbft_tpu.crypto"]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")), ids=lambda p: str(p.relative_to(PKG)))
def test_no_file_imports_jax_or_reads_the_jax_records(path):
    names = list(_imports(path))
    assert not run.forbidden_modules(names), names
    assert "benchmarks/" not in path.read_text() or path.parent.name == "tests"
    if path.parent.name == "reference":
        assert not any(n.split(".")[0] in ("pbft_tpu_torch", "torch") for n in names), names
