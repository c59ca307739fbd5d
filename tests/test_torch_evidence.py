"""The port's evidence and sweep tools (pbft_tpu_torch/scripts: bench_compare,
launch_cost_model, chaos_soak, scale_curve, window_sweep, gpu_evidence) on
the CPU: each against the reference's script (scripts/) on the same inputs
where both compute the same thing, each driven through its CPU arm, and the
card's arms refusing to run without CUDA."""

from __future__ import annotations

import importlib.util
import json
import pathlib
import sys

import pytest
import torch

from pbft_tpu_torch import native
from pbft_tpu_torch.crypto import ed25519 as E
from pbft_tpu_torch.crypto import ref
from pbft_tpu_torch.scripts import (
    bench_compare,
    chaos_soak,
    gpu_evidence,
    launch_cost_model,
    scale_curve,
    window_sweep,
)

REPO = pathlib.Path(__file__).resolve().parent.parent


def _reference(name: str):
    """The reference's ``scripts/<name>.py``, loaded under a name of its own."""
    spec = importlib.util.spec_from_file_location(f"reference_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jsonl(path: pathlib.Path, rows) -> str:
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return str(path)


# -- bench_compare -------------------------------------------------------------


def test_bench_compare_gates_like_the_reference(tmp_path):
    ref_bc = _reference("bench_compare")
    base = [{"replicas": n, "requests_per_sec": r, "reply_p99_ms": p}
            for n, r, p in ((4, 100.0, 50.0), (4, 102.0, 52.0), (4, 98.0, 51.0), (7, 60.0, 80.0), (7, 61.0, 81.0))]
    old = _jsonl(tmp_path / "old.jsonl", base)
    # name -> (new rows, exit code flat, exit code grouped by replicas)
    cases = {
        "same": (base, 0, 0),
        # throughput down 20% at n = 4 only
        "slower": ([dict(r, requests_per_sec=r["requests_per_sec"] * (0.8 if r["replicas"] == 4 else 1))
                    for r in base], 1, 1),
        # lower is better: the p99 up 30% regresses, down 30% does not
        "p99_up": ([dict(r, reply_p99_ms=r["reply_p99_ms"] * 1.3) for r in base], 1, 1),
        "p99_down": ([dict(r, reply_p99_ms=r["reply_p99_ms"] * 0.7) for r in base], 0, 0),
        # one wild run of n = 4's three: that group's median holds, the
        # median over both groups does not
        "outlier": (base[:2] + [dict(base[2], requests_per_sec=1.0)] + base[3:], 1, 0),
    }
    for name, (rows, flat, grouped) in cases.items():
        new = _jsonl(tmp_path / f"{name}.jsonl", rows)
        for args, want in (([old, new], flat), ([old, new, "--group-by", "replicas"], grouped)):
            assert bench_compare.main(args) == ref_bc.main(args) == want, (name, args)
        old_runs, new_runs = bench_compare.load_runs(old), bench_compare.load_runs(new)
        metrics = list(bench_compare.DEFAULT_METRICS)
        lower = bench_compare.DEFAULT_LOWER_BETTER
        assert bench_compare.compare(old_runs, new_runs, metrics, 10.0, lower_better=lower) == ref_bc.compare(
            old_runs, new_runs, metrics, 10.0, lower_better=lower)
        assert bench_compare.compare_grouped(old_runs, new_runs, "replicas", metrics, 10.0,
                                             lower_better=lower) == ref_bc.compare_grouped(
            old_runs, new_runs, "replicas", metrics, 10.0, lower_better=lower)
    grouped = bench_compare.compare_grouped(bench_compare.load_runs(old), bench_compare.load_runs(
        str(tmp_path / "slower.jsonl")), "replicas", ["requests_per_sec"], 10.0)
    assert grouped["replicas=4:requests_per_sec"]["regressed"]
    assert not grouped["replicas=7:requests_per_sec"]["regressed"]
    assert bench_compare.DEFAULT_METRICS == ref_bc.DEFAULT_METRICS
    assert bench_compare.DEFAULT_LOWER_BETTER == ref_bc.DEFAULT_LOWER_BETTER
    # Data errors exit 2: an empty file, a line that is not JSON, no shared metric.
    (tmp_path / "empty.jsonl").write_text("")
    (tmp_path / "junk.jsonl").write_text('{"requests_per_sec": 1}\nnot json\n')
    other = _jsonl(tmp_path / "other.jsonl", [{"something": 1.0}])
    for bad in ("empty.jsonl", "junk.jsonl", "other.jsonl"):
        args = [old, str(tmp_path / bad)]
        assert bench_compare.main(args) == ref_bc.main(args) == 2, bad
    assert bench_compare.main([other, other]) == 2


# -- launch_cost_model ---------------------------------------------------------


def test_launch_cost_model_matches_the_reference(tmp_path, capsys):
    ref_lcm = _reference("launch_cost_model")
    traces = tmp_path / "cfg1"
    traces.mkdir()
    events = {
        "replica-0.jsonl": [{"ev": "verify_batch", "ts": 1.0 + i * 0.01, "size": 4 + i % 5} for i in range(40)],
        "replica-1.jsonl": [{"ev": "verify_batch", "ts": 1.2 + i * 0.02, "size": 16} for i in range(10)]
                           + [{"ev": "executed", "ts": 2.0, "seq": 1}],
        "replica-2.jsonl": [{"ev": "executed", "ts": 2.0, "seq": 1}],
    }
    for name, evs in events.items():
        _jsonl(traces / name, evs)
    files = launch_cost_model.expand_trace_args([str(traces)])
    assert launch_cost_model.window_stats(files) == ref_lcm.window_stats(files)
    stats = launch_cost_model.window_stats(files)
    assert stats["launches"] == 50 and stats["items"] == sum(4 + i % 5 for i in range(40)) + 160
    for rate, lus, occ in ((111_000.0, 100.0, 8.0), (5e4, 2_500.0, 23.5), (1e6, 0.0, 1.0)):
        assert launch_cost_model.project(rate, lus, occ) == ref_lcm.project(rate, lus, occ)
    assert launch_cost_model.ON_HOST_LAUNCH_US == ref_lcm.ON_HOST_LAUNCH_US
    # The kernel record: the rate and the card's measured graph launch.
    record = tmp_path / "kernel.json"
    record.write_text(json.dumps({"step": "kernel", "value": 110_000.0, "graph_launch_us": 2_400.0,
                                  "device": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}) + "\n")
    launch_cost_model.main(["--traces", str(traces), "--kernel", str(record)])
    out = json.loads(capsys.readouterr().out)
    assert set(out["projected"]) == {"launch_100us", "launch_2400us"}
    assert out["projected"]["launch_2400us"] == ref_lcm.project(110_000.0, 2_400.0, stats["items_per_launch"])
    assert out["kernel_device"] == "NVIDIA H100 80GB HBM3" and out["graph_launch_us"] == 2_400.0
    launch_cost_model.main(["--traces", str(traces), "--kernel-rate", "5e4", "--launch-us", "7"])
    assert set(json.loads(capsys.readouterr().out)["projected"]) == {"launch_7us"}
    with pytest.raises(SystemExit):
        launch_cost_model.window_stats([str(traces / "replica-2.jsonl")])


# -- chaos_soak ----------------------------------------------------------------


def test_chaos_soak_seed_gives_the_references_schedule_and_verdict():
    if not native.available():
        pytest.skip("the native core cannot be built here")
    ref_cs = _reference("chaos_soak")
    keys = ("ok", "seed", "n", "submitted", "executed", "faults_injected", "chaos_dropped", "violation",
            "health_verdicts")
    for seed, mode in ((3, "sig"), (5, "mac")):
        ours = chaos_soak.run_one(seed, 4, 120, mode=mode, verifier="native", health_gate=True)
        theirs = ref_cs.run_one(seed, 4, 120, mode=mode, health_gate=True)
        assert ours["schedule"].describe() == theirs["schedule"].describe()
        assert {k: ours.get(k) for k in keys} == {k: theirs.get(k) for k in keys}
        assert ours["ok"] and ours["verifier"] == "native" and ours["windows"] > 0 and ours["verified_items"] > 0
    tripped = chaos_soak.validate_checker(verifier="native")
    assert tripped["tripped"] and tripped["windows"] > 0
    assert tripped["step"] == ref_cs.validate_checker()["step"]


def test_chaos_soak_cli_json_lines(capsys):
    assert chaos_soak.main(["--seeds", "1", "--steps", "60", "--n", "4", "--mode", "sig", "--verifier", "cpu",
                            "--json"]) == 0
    (line,) = capsys.readouterr().out.splitlines()
    row = json.loads(line)
    assert row["ok"] and row["verifier"] == "cpu" and row["steps"] == 60 and "step" in row["schedule"]
    assert chaos_soak.main(["--validate", "--verifier", "cpu", "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["tripped"]


# -- scale_curve and window_sweep (the CPU arms) -------------------------------


def test_scale_curve_n4_smoke_through_the_gateway(tmp_path):
    out = tmp_path / "curve.jsonl"
    assert scale_curve.main(["--n", "4", "--clients", "4", "--requests", "5", "--window", "4", "--batch", "16",
                             "--verifier", "cpu", "--out", str(out)]) == 0
    (row,) = bench_compare.load_runs(str(out))
    assert row["replicas"] == 4 and row["completed_pct"] == 100.0 and row["requests"] == 20
    assert row["requests_per_sec"] > 0 and row["reply_p99_ms"] >= row["reply_p50_ms"] > 0
    assert "verify_accounting" not in row
    assert bench_compare.main([str(out), str(out), "--group-by", "replicas"]) == 0


def test_window_sweep_one_cell_on_the_native_daemon():
    kernel = {"value": 100_000.0, "graph_launch_us": 3_000.0}
    (row,) = window_sweep.sweep([8], [2000], 12, kernel, "native")
    assert row["service_backend"] == "native" and row["requests"] == 12
    assert row["items_per_launch"] > 0 and row["launches"] >= row["service_windows"] > 0
    assert row["service_items"] == row["replica_sig_checks"] > 0 and row["service_fallback_items"] == 0
    assert set(row["projected"]) == {"launch_100us", "launch_3000us"}
    assert row["projected_100us_per_sec"] == row["projected"]["launch_100us"]["verifies_per_sec"]


def test_card_arms_refuse_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        chaos_soak.run_one(0, 4, 10, verifier="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        window_sweep.sweep([8], [0], 4, {"value": 1.0}, "cuda")
    assert scale_curve.main(["--n", "4", "--verifier", "daemon", "--service-backend", "cuda"]) == 2
    with pytest.raises(ValueError):
        chaos_soak.run_one(0, 4, 10, verifier="jax")


# -- gpu_evidence --------------------------------------------------------------


def test_gpu_evidence_stages_compose_to_the_verify_kernel():
    """At B = 8 on the plain versions: the stages, run one after another,
    give verify_kernel's verdicts and the oracle's, hostile rows included."""
    seed, msg = bytes(range(32)), b"stage split".ljust(32, b".")
    pub, sig = ref.public_key(seed), ref.sign(seed, msg)
    s = int.from_bytes(sig[32:], "little")
    off_curve = next(k.to_bytes(32, "little") for k in range(2, 1000)
                     if ref.point_decompress(k.to_bytes(32, "little")) is None)
    items = [
        (pub, msg, sig),
        (pub, msg, bytes([sig[0] ^ 0x40]) + sig[1:]),  # corrupted R
        (pub, bytes(32), sig),  # another message
        (pub, msg, sig[:32] + (s + ref.L).to_bytes(32, "little")),  # S + L
        ((2**255 - 19).to_bytes(32, "little"), msg, sig),  # y = p
        (off_curve, msg, sig),
        ((1).to_bytes(32, "little"), msg, sig),  # small-order A
        (ref.public_key(b"\x07" * 32), msg, ref.sign(b"\x07" * 32, msg)),
    ]
    pubs, msgs, sigs = gpu_evidence._device_tensors(items, "cpu")
    env = gpu_evidence.run_stages(pubs, msgs, sigs)
    want = [ref.verify(*it) for it in items]
    assert want == [True, False, False, False, False, False, False, True]
    assert env["valid"].tolist() == E.verify_kernel(pubs, msgs, sigs).tolist() == want
    names = [name for name, *_ in gpu_evidence.STAGES]
    assert names == ["sha512", "mod_l", "decompress", "ladder", "compress", "compare"]
    produced = {"pub", "msg", "sig"}
    for _, _, ins, outs in gpu_evidence.STAGES:  # each stage reads only earlier outputs
        assert set(ins) <= produced
        produced |= set(outs)
    assert set(gpu_evidence.STAGE_KERNELS.values()) == {"sha512", "inv", "p58", "ladder"}


def test_gpu_evidence_signed_pool_and_step_rejection(tmp_path):
    items, want = gpu_evidence.signed_pool(64, signers=4)
    assert len(items) == 64 and want.count(False) == 1 and not want[32]
    assert [ref.verify(*items[i]) for i in (0, 1, 32, 63)] == [want[i] for i in (0, 1, 32, 63)]
    py = sys.executable

    def step(line: str):
        return gpu_evidence.run_step("t", [py, "-c", f"print({line!r})"], timeout=60, out_dir=tmp_path,
                                     out_json="t.json")

    assert step('{"error": "RuntimeError: no card"}') is None
    assert step('{"value": 0}') is None
    assert step("no json here") is None
    assert not (tmp_path / "t.json").exists()
    assert step('{"value": 5.0, "step": "t"}') == {"value": 5.0, "step": "t"}
    assert json.loads((tmp_path / "t.json").read_text())["value"] == 5.0


def test_gpu_evidence_fails_without_a_card(tmp_path):
    """No fallback: the kernel step's worker raises without CUDA, the step
    is rejected, and the capture exits 1 with nothing written."""
    assert gpu_evidence.main(["--steps", "kernel", "--out-dir", str(tmp_path / "ev")]) == 1
    assert not (tmp_path / "ev" / "kernel.json").exists()
