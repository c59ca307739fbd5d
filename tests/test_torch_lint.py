"""The port's static-analysis layer (pbft_tpu_torch/analysis/,
``python -m pbft_tpu_torch.scripts.pbft_lint``).

1. The repo is clean under every pass, and the entry point exits 0 (the
   tier-1 wiring: drift between core/ and the port fails the build here).
2. Each pass trips on a shadow tree — a copy of exactly the files the
   passes read — with one deliberate divergence in a port file: a wire
   constant, a protocol version, a health threshold, the pad ladder, a
   blocking call in pbft_tpu_torch/net, an unregistered metric, an
   untuned dial. The entry point exits 1 on each.
3. The port's PAIRS equal the reference's pair for pair (label and C++
   side equal, the Python side moved from pbft_tpu/ to pbft_tpu_torch/),
   with one stated exception: the RLC window's Python side is ``WINDOW``
   below, not tests/test_verify_pool.py's. A pair added to one lint and
   not the other fails here.
4. ``WINDOW`` is the native verify pool's fixed RLC window (paired by the
   constants pass with core/ed25519.h kEd25519RlcWindowItems): the port's
   native.verify_batch gives the per-item verdicts with invalid rows on
   both sides of each window boundary, at one and two pool threads.
"""

from __future__ import annotations

import hashlib
import pathlib
import shutil
import subprocess
import sys

import pytest

from pbft_tpu.analysis import constants as jax_constants
from pbft_tpu_torch import analysis, native
from pbft_tpu_torch.analysis import async_blocking, constants, metrics_lint, sockets

REPO = pathlib.Path(__file__).resolve().parent.parent
WINDOW = 256  # mirrors core/ed25519.h kEd25519RlcWindowItems


def _shadow_tree(tmp_path: pathlib.Path) -> pathlib.Path:
    """Copy exactly the files the passes scan into a fresh tree."""
    root = tmp_path / "tree"
    for src in analysis.scanned_files(REPO):
        dst = root / src.relative_to(REPO)
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(src, dst)
    return root


def _run_lint(root: pathlib.Path, passes: str = None):
    cmd = [sys.executable, "-m", "pbft_tpu_torch.scripts.pbft_lint", "--root", str(root)]
    if passes:
        cmd += ["--passes", passes]
    return subprocess.run(cmd, capture_output=True, text=True, cwd=REPO, timeout=120)


# -- 1. the repo -------------------------------------------------------------

def test_repo_is_clean_under_every_pass():
    results = analysis.run_all(REPO)
    flat = [e for errs in results.values() for e in errs]
    assert flat == [], "\n".join(flat)


def test_entry_points_exit_zero_on_the_repo():
    proc = _run_lint(REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "all passes clean" in proc.stdout
    for name, count in analysis.files_per_pass(REPO).items():
        assert f"[pbft_lint] {name}: ok ({count} files)" in proc.stdout
    assert _run_lint(REPO, passes="no-such-pass").returncode == 2
    shim = subprocess.run([sys.executable, "-m", "pbft_tpu_torch.scripts.check_trace_schema"],
                          capture_output=True, text=True, cwd=REPO, timeout=120)
    assert shim.returncode == 0, shim.stdout + shim.stderr


def test_scanned_files_exist_and_are_the_ports():
    paths = analysis.scanned_files(REPO)
    for path in paths:
        assert path.exists(), f"scanned file missing: {path}"
    rels = {str(p.relative_to(REPO)) for p in paths}
    assert not any(r.startswith("pbft_tpu/") for r in rels), sorted(rels)
    for rel in ("pbft_tpu_torch/net/server.py", "pbft_tpu_torch/analysis/health.py", "core/net.cc",
                "pbft_tpu_torch/utils/trace_schema.py", "tests/test_torch_lint.py"):
        assert rel in rels, rel


# -- 2. each violation class trips its pass ----------------------------------

def _replace(rel, old, new):
    def edit(root):
        path = root / rel
        text = path.read_text()
        assert old in text, (rel, old)
        path.write_text(text.replace(old, new, 1))
    return edit


def _add(rel, text):
    def edit(root):
        (root / rel).write_text(text)
    return edit


def _strip_lines(rel, token):
    def edit(root):
        path = root / rel
        text = path.read_text()
        assert token in text
        path.write_text("\n".join(line for line in text.splitlines() if token not in line))
    return edit


# case -> (pass, edit of the shadow tree, text every report must hold)
VIOLATIONS = {
    "wire-magic": ("constants", _replace(
        "pbft_tpu_torch/consensus/messages.py", "WIRE_BINARY_MAGIC = 0xB2", "WIRE_BINARY_MAGIC = 0xB3"),
        "wire binary magic"),
    "protocol-version": ("constants", _replace(
        "pbft_tpu_torch/net/secure.py", 'PROTOCOL_VERSION = "pbft-tpu/1.3.0"', 'PROTOCOL_VERSION = "pbft-tpu/1.4.0"'),
        "protocol version (current)"),
    "mac-tag-length": ("constants", _replace(
        "pbft_tpu_torch/net/secure.py", "MAC_TAG_LEN = 16", "MAC_TAG_LEN = 12"), "MAC tag length"),
    "config-default": ("constants", _replace(
        "pbft_tpu_torch/consensus/config.py", "watermark_window: int = 256", "watermark_window: int = 128"),
        "watermark_window"),
    "health-threshold": ("constants", _replace(
        "pbft_tpu_torch/analysis/health.py", "HEALTH_STALL_SECONDS = 5", "HEALTH_STALL_SECONDS = 9"),
        "health stall threshold seconds"),
    "rlc-window": ("constants", _replace(
        "tests/test_torch_lint.py", "WINDOW = 256  #", "WINDOW = 128  #"), "ed25519 RLC window items"),
    "pad-ladder": ("constants", _replace(
        "pbft_tpu_torch/crypto/batch.py", "_PAD_LADDER = (16, 64, 256, 1024, 4096)",
        "_PAD_LADDER = (16, 64, 256, 1024, 2048)"), "pad ladder top"),
    "blocking-sleep": ("async-blocking", _add(
        "pbft_tpu_torch/net/fixture_blocking.py",
        "import time\n\n\nasync def stall_the_loop():\n    time.sleep(1)  # the violation\n"),
        "time.sleep"),
    "blocking-socket": ("async-blocking", _add(
        "pbft_tpu_torch/net/fixture_blocking2.py",
        "async def bad_socket(sock):\n    return sock.recv(4096)\n"), "sock.recv"),
    "unregistered-metric": ("metrics", _add(
        "pbft_tpu_torch/fixture_metrics.py",
        "def emit(registry):\n    registry.counter('pbft_totally_unregistered_total').inc()\n"),
        "pbft_totally_unregistered_total"),
    "renamed-emitter-metric": ("metrics", _replace(
        "pbft_tpu_torch/net/server.py", '"pbft_frames_in_total"', '"pbft_frames_in_renamed_total"'),
        "pbft_frames_in_renamed_total"),
    "untuned-dial": ("sockets", _strip_lines("pbft_tpu_torch/net/client.py", "TCP_NODELAY"), "client.py"),
}


@pytest.mark.parametrize("case", sorted(VIOLATIONS))
def test_each_pass_trips_on_a_divergent_port_file(tmp_path, case):
    name, edit, needle = VIOLATIONS[case]
    root = _shadow_tree(tmp_path)
    assert analysis.PASSES[name](root) == []  # the copy is clean
    edit(root)
    errors = analysis.PASSES[name](root)
    assert any(needle in e for e in errors), errors
    proc = _run_lint(root, passes=name)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert needle in proc.stdout


def test_blocking_calls_outside_the_loop_pass(tmp_path):
    root = _shadow_tree(tmp_path)
    (root / "pbft_tpu_torch/net/fixture_fine.py").write_text(
        "async def fine(loop, sock):\n"
        "    await loop.run_in_executor(None, sock.close)\n"
        "\n\nasync def nested_sync_ok():\n"
        "    def helper():\n"
        "        import time\n"
        "        time.sleep(0)\n"
        "    return helper\n"
    )
    assert async_blocking.check(root) == []
    assert sockets.check(root) == [] and metrics_lint.check(root) == []


# -- 3. the port's pairs are the reference's --------------------------------

RLC_PAIR = "ed25519 RLC window items"


def test_pairs_equal_the_reference_pair_for_pair():
    assert len(constants.PAIRS) == len(jax_constants.PAIRS)
    for mine, ref in zip(constants.PAIRS, jax_constants.PAIRS):
        (label, cxx, (py_file, py_name)), (ref_label, ref_cxx, (ref_file, ref_name)) = mine, ref
        assert (label, cxx, py_name) == (ref_label, ref_cxx, ref_name)
        if label == RLC_PAIR:
            assert (ref_file, py_file) == ("tests/test_verify_pool.py", "tests/test_torch_lint.py")
        else:
            assert ref_file.startswith("pbft_tpu/") and py_file == "pbft_tpu_torch/" + ref_file[len("pbft_tpu/"):]
    assert constants.EXTRA_FILES == [f.replace("pbft_tpu/", "pbft_tpu_torch/") for f in jax_constants.EXTRA_FILES]
    assert constants.py_const(REPO / "tests/test_torch_lint.py", "WINDOW") == WINDOW
    assert constants.cxx_const(REPO / "core/ed25519.h", "kEd25519RlcWindowItems") == WINDOW


# -- 4. WINDOW pins the native pool's window ---------------------------------

@pytest.mark.parametrize("threads", [1, 2])
def test_native_pool_verdicts_across_window_boundaries(threads):
    if not native.available():
        pytest.skip("the C++ core cannot be built here")
    n = 2 * WINDOW + 37  # three windows, the last one ragged
    seed = bytes(range(32))
    pub = native.public_key(seed)
    items = []
    for i in range(n):
        msg = hashlib.sha256(b"window-%d" % i).digest()  # a 32-byte digest
        items.append((pub, msg, native.sign(seed, msg)))
    bad = {0, WINDOW - 1, WINDOW, 2 * WINDOW - 1, 2 * WINDOW, n - 1}
    for i in bad:
        pub_i, msg, sig = items[i]
        items[i] = (pub_i, bytes([msg[0] ^ 1]) + msg[1:], sig)
    before = native.verify_threads()
    native.set_verify_threads(threads)
    try:
        got = native.verify_batch(items)
    finally:
        native.set_verify_threads(before)
    assert got == [native.verify(*it) for it in items] == [i not in bad for i in range(n)]
