"""The port's import rule: nothing in pbft_tpu_torch/ or chip_smoke.py
imports jax, the JAX package pbft_tpu (pbft_tpu_torch is fine) or the
reference's scripts/ (the port has its own copies), checked
on the AST of every file; and device selection never falls back to the CPU
on its own."""

import ast
import os

import pytest
import torch

from pbft_tpu_torch.crypto import ed25519 as E
from pbft_tpu_torch.crypto import field as F
from pbft_tpu_torch.device import resolve_device

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
    files = [os.path.join(_REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(_REPO, "pbft_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


# The reference's operator scripts (scripts/*.py), importable as top-level
# modules once scripts/ is on sys.path, as the reference's scripts do.
_ROOT_SCRIPTS = {n[:-3] for n in os.listdir(os.path.join(_REPO, "scripts")) if n.endswith(".py")}


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "pbft_tpu", "scripts") or top in _ROOT_SCRIPTS


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) >= 30, files
    for name in (
        "native.py", "utils/metrics.py", "utils/trace_schema.py", "net/verify_service.py",
        "consensus/__init__.py", "consensus/messages.py", "consensus/config.py", "net/launcher.py",
        "net/client.py", "utils/waterfall.py", "bench/__init__.py", "bench/harness.py",
        "consensus/wal.py", "consensus/replica.py", "consensus/simulation.py", "consensus/invariants.py",
        "consensus/faults.py", "net/server.py", "net/secure.py", "net/discovery.py", "net/gateway.py",
        "utils/flight.py", "utils/__init__.py", "net/__init__.py",
        "utils/cache.py", "analysis/__init__.py", "analysis/health.py", "analysis/constants.py",
        "analysis/async_blocking.py", "analysis/metrics_lint.py", "analysis/sockets.py",
        "scripts/__init__.py", "scripts/pbft_lint.py", "scripts/check_trace_schema.py",
        "scripts/verify_status.py", "scripts/flight_dump.py", "scripts/trace_report.py",
        "scripts/consensus_timeline.py", "scripts/pbft_top.py", "scripts/chaos_bench.py",
        "scripts/endurance_soak.py", "scripts/bench_compare.py", "scripts/launch_cost_model.py",
        "scripts/window_sweep.py", "scripts/scale_curve.py", "scripts/chaos_soak.py", "scripts/gpu_evidence.py",
    ):
        assert os.path.join(_REPO, "pbft_tpu_torch", name) in files, name
    bad = []
    for path in files:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, _REPO)}:{node.lineno} {n}" for n in names if _forbidden(n)]
    assert not bad, bad


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_constructors_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: F.from_numpy(F.limbs_const(1)), lambda: E.identity((2,)), lambda: E.base_point((2,))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert F.from_numpy(F.limbs_const(1), "cpu").device.type == "cpu"
    assert all(c.device.type == "cpu" and c.shape == (2, 32) for c in E.identity((2,), "cpu") + E.base_point((2,), "cpu"))
