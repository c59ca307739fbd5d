"""Cross-runtime constant conformance: the port's copy of
``pbft_tpu/analysis/constants.py``. Every pair keeps its C++ side and
names the port's file on the Python side.

The C++ core and the port's asyncio runtime must agree on every
hand-mirrored wire and protocol constant — the 0xB2 binary magic, the
message type tags, the protocol version set, the ClusterConfig defaults,
the RLC window width, the verify-service pad ladder. Castro & Liskov's
safety argument assumes replicas compute identical digests; a one-byte
drift in any of these forks the accept set silently. The cross-runtime
tests (tests/test_torch_server.py) check the DYNAMIC behavior; this pass
is the static complement — it parses both source trees (C++ by regex
over declarations, Python by AST) and fails the build when the values
diverge.

Policy: a new cross-runtime constant is added to BOTH runtimes and to
``PAIRS`` below in the same commit, or the lint fails the build
(tests/test_torch_lint.py also holds these pairs equal to the
reference's, pair for pair).

Every check reads files relative to ``root`` so tests/test_torch_lint.py
can run the pass against a shadow tree with one deliberately divergent
value.
"""

from __future__ import annotations

import ast
import pathlib
import re
from typing import Dict, List, Optional, Tuple, Union

REPO = pathlib.Path(__file__).resolve().parent.parent.parent

Value = Union[int, str, tuple]

# (label, (C++ file, declaration name), (Python file, binding name)).
# C++ names are matched against `<name> = <value>[;,]` declarations
# (enumerators, constexprs, struct-member defaults alike); Python names
# against any `<name> = <literal>` / `<name>: T = <literal>` binding.
PAIRS: List[Tuple[str, Tuple[str, str], Tuple[str, str]]] = [
    ("wire binary magic",
     ("core/messages.h", "kBinaryMagic"),
     ("pbft_tpu_torch/consensus/messages.py", "WIRE_BINARY_MAGIC")),
    ("binary codec name",
     ("core/messages.h", "kCodecBinary2"),
     ("pbft_tpu_torch/consensus/messages.py", "CODEC_BINARY2")),
    ("binary tag: client-request",
     ("core/messages.cc", "kBinClientRequest"),
     ("pbft_tpu_torch/consensus/messages.py", "_BIN_CLIENT_REQUEST")),
    ("binary tag: pre-prepare",
     ("core/messages.cc", "kBinPrePrepare"),
     ("pbft_tpu_torch/consensus/messages.py", "_BIN_PRE_PREPARE")),
    ("binary tag: prepare",
     ("core/messages.cc", "kBinPrepare"),
     ("pbft_tpu_torch/consensus/messages.py", "_BIN_PREPARE")),
    ("binary tag: commit",
     ("core/messages.cc", "kBinCommit"),
     ("pbft_tpu_torch/consensus/messages.py", "_BIN_COMMIT")),
    ("binary tag: checkpoint",
     ("core/messages.cc", "kBinCheckpoint"),
     ("pbft_tpu_torch/consensus/messages.py", "_BIN_CHECKPOINT")),
    ("binary tag: batched pre-prepare",
     ("core/messages.cc", "kBinPrePrepareBatch"),
     ("pbft_tpu_torch/consensus/messages.py", "_BIN_PRE_PREPARE_BATCH")),
    ("binary max batch",
     ("core/messages.cc", "kBinMaxBatch"),
     ("pbft_tpu_torch/consensus/messages.py", "_BIN_MAX_BATCH")),
    # MAC-vector frame variants: the five authenticated
    # codes, the lane-vector bound, the tag length, the KDF/domain
    # labels, and the auth-mode offer name — one byte of drift here and
    # a mixed-runtime mac link rejects every frame.
    ("binary tag: pre-prepare (MAC)",
     ("core/messages.cc", "kBinPrePrepareMac"),
     ("pbft_tpu_torch/consensus/messages.py", "_BIN_PRE_PREPARE_MAC")),
    ("binary tag: prepare (MAC)",
     ("core/messages.cc", "kBinPrepareMac"),
     ("pbft_tpu_torch/consensus/messages.py", "_BIN_PREPARE_MAC")),
    ("binary tag: commit (MAC)",
     ("core/messages.cc", "kBinCommitMac"),
     ("pbft_tpu_torch/consensus/messages.py", "_BIN_COMMIT_MAC")),
    ("binary tag: checkpoint (MAC)",
     ("core/messages.cc", "kBinCheckpointMac"),
     ("pbft_tpu_torch/consensus/messages.py", "_BIN_CHECKPOINT_MAC")),
    ("binary tag: batched pre-prepare (MAC)",
     ("core/messages.cc", "kBinPrePrepareBatchMac"),
     ("pbft_tpu_torch/consensus/messages.py", "_BIN_PRE_PREPARE_BATCH_MAC")),
    ("MAC vector bound",
     ("core/messages.cc", "kMacVectorMax"),
     ("pbft_tpu_torch/consensus/messages.py", "_MAC_VECTOR_MAX")),
    ("MAC tag length",
     ("core/secure.h", "kMacTagLen"),
     ("pbft_tpu_torch/net/secure.py", "MAC_TAG_LEN")),
    ("MAC domain-separation label",
     ("core/secure.h", "kMacContext"),
     ("pbft_tpu_torch/net/secure.py", "MAC_CONTEXT")),
    ("MAC auth-mode offer name",
     ("core/secure.h", "kAuthModeMac"),
     ("pbft_tpu_torch/net/secure.py", "AUTH_MODE_MAC")),
    # Tentative-reply flag: the signed JSON member both
    # runtimes omit-when-zero — a renamed/mis-cased field would fork
    # every tentative reply's signable bytes.
    ("tentative-reply field tag",
     ("core/messages.h", "kTentativeField"),
     ("pbft_tpu_torch/consensus/messages.py", "TENTATIVE_FIELD")),
    ("protocol version (current)",
     ("core/secure.h", "kProtocolVersion"),
     ("pbft_tpu_torch/net/secure.py", "PROTOCOL_VERSION")),
    ("protocol version (batch)",
     ("core/secure.h", "kProtocolVersionBatch"),
     ("pbft_tpu_torch/net/secure.py", "PROTOCOL_VERSION_BATCH")),
    ("protocol version (bin2)",
     ("core/secure.h", "kProtocolVersionBin2"),
     ("pbft_tpu_torch/net/secure.py", "PROTOCOL_VERSION_BIN2")),
    ("protocol version (legacy)",
     ("core/secure.h", "kProtocolVersionLegacy"),
     ("pbft_tpu_torch/net/secure.py", "PROTOCOL_VERSION_LEGACY")),
    # The fixed RLC window width. The port names 256 nowhere as a
    # binding (native.py drives the pool without it), so its mirror is the
    # WINDOW of the port's lint suite (tests/test_torch_lint.py), which
    # checks the native pool's verdicts across that boundary.
    ("ed25519 RLC window items",
     ("core/ed25519.h", "kEd25519RlcWindowItems"),
     ("tests/test_torch_lint.py", "WINDOW")),
    # ClusterConfig defaults: a replica constructed from a sparse
    # network.json must behave identically in either runtime.
    ("ClusterConfig default: watermark_window",
     ("core/replica.h", "watermark_window"),
     ("pbft_tpu_torch/consensus/config.py", "watermark_window")),
    ("ClusterConfig default: checkpoint_interval",
     ("core/replica.h", "checkpoint_interval"),
     ("pbft_tpu_torch/consensus/config.py", "checkpoint_interval")),
    ("ClusterConfig default: batch_pad",
     ("core/replica.h", "batch_pad"),
     ("pbft_tpu_torch/consensus/config.py", "batch_pad")),
    ("ClusterConfig default: verify_flush_us",
     ("core/replica.h", "verify_flush_us"),
     ("pbft_tpu_torch/consensus/config.py", "verify_flush_us")),
    ("ClusterConfig default: verify_flush_items",
     ("core/replica.h", "verify_flush_items"),
     ("pbft_tpu_torch/consensus/config.py", "verify_flush_items")),
    ("ClusterConfig default: batch_max_items",
     ("core/replica.h", "batch_max_items"),
     ("pbft_tpu_torch/consensus/config.py", "batch_max_items")),
    ("ClusterConfig default: batch_flush_us",
     ("core/replica.h", "batch_flush_us"),
     ("pbft_tpu_torch/consensus/config.py", "batch_flush_us")),
    # Admission control: per-client in-flight cap + global
    # backlog watermark — a sparse network.json must disable both
    # identically in either runtime.
    ("ClusterConfig default: admission_inflight",
     ("core/replica.h", "admission_inflight"),
     ("pbft_tpu_torch/consensus/config.py", "admission_inflight")),
    ("ClusterConfig default: admission_backlog",
     ("core/replica.h", "admission_backlog"),
     ("pbft_tpu_torch/consensus/config.py", "admission_backlog")),
    # Multi-core replica core: a sparse network.json must mean
    # the classic single-threaded loop in both runtimes.
    ("ClusterConfig default: net_threads",
     ("core/replica.h", "net_threads"),
     ("pbft_tpu_torch/consensus/config.py", "net_threads")),
    # Fast-path modes: a sparse network.json must mean
    # signature mode + committed-only replies in both runtimes.
    ("ClusterConfig default: fastpath",
     ("core/replica.h", "fastpath"),
     ("pbft_tpu_torch/consensus/config.py", "fastpath")),
    ("ClusterConfig default: tentative",
     ("core/replica.h", "tentative"),
     ("pbft_tpu_torch/consensus/config.py", "tentative")),
    # Durable replica recovery: the WAL's on-disk format is
    # byte-identical across runtimes (a pbftd-written log must replay in
    # the asyncio runtime's tooling and vice versa) — magic, version,
    # record tags, and vote kinds are all hand-mirrored; and a sparse
    # network.json must mean no-WAL + fsync-on identically in both.
    ("WAL file magic",
     ("core/wal.h", "kWalMagic"),
     ("pbft_tpu_torch/consensus/wal.py", "WAL_MAGIC")),
    ("WAL format version",
     ("core/wal.h", "kWalVersion"),
     ("pbft_tpu_torch/consensus/wal.py", "WAL_VERSION")),
    ("WAL record tag: view",
     ("core/wal.h", "kWalRecView"),
     ("pbft_tpu_torch/consensus/wal.py", "WAL_REC_VIEW")),
    ("WAL record tag: vote",
     ("core/wal.h", "kWalRecVote"),
     ("pbft_tpu_torch/consensus/wal.py", "WAL_REC_VOTE")),
    ("WAL record tag: checkpoint",
     ("core/wal.h", "kWalRecCheckpoint"),
     ("pbft_tpu_torch/consensus/wal.py", "WAL_REC_CHECKPOINT")),
    ("WAL vote kind: pre-prepare",
     ("core/wal.h", "kWalVotePrePrepare"),
     ("pbft_tpu_torch/consensus/wal.py", "WAL_VOTE_PRE_PREPARE")),
    ("WAL vote kind: prepare",
     ("core/wal.h", "kWalVotePrepare"),
     ("pbft_tpu_torch/consensus/wal.py", "WAL_VOTE_PREPARE")),
    ("WAL vote kind: commit",
     ("core/wal.h", "kWalVoteCommit"),
     ("pbft_tpu_torch/consensus/wal.py", "WAL_VOTE_COMMIT")),
    ("ClusterConfig default: wal_dir",
     ("core/replica.h", "wal_dir"),
     ("pbft_tpu_torch/consensus/config.py", "wal_dir")),
    ("ClusterConfig default: wal_fsync",
     ("core/replica.h", "wal_fsync"),
     ("pbft_tpu_torch/consensus/config.py", "wal_fsync")),
    # Forwarded-request retention (view-change re-aim) bound —
    # same eviction point in both runtimes or their storm behavior forks.
    ("forwarded-request retention bound",
     ("core/replica.h", "kMaxForwardedRetained"),
     ("pbft_tpu_torch/consensus/replica.py", "MAX_FORWARDED_RETAINED")),
    # Verify-service readiness handshake record shape.
    ("verify-service status version",
     ("core/verifier.cc", "kStatusVersionLint"),  # custom, see below
     ("pbft_tpu_torch/net/service.py", "STATUS_VERSION")),
    # Gateway tier: the routing-token prefix both runtimes
    # switch the reply path on, and the bounded-queue/route-cache sizes
    # the backpressure and fan-back fallback policies share.
    ("gateway client-token prefix",
     ("core/net.h", "kGatewayClientPrefix"),
     ("pbft_tpu_torch/net/gateway.py", "GATEWAY_CLIENT_PREFIX")),
    ("max per-connection outbound bytes",
     ("core/net.cc", "kMaxConnOutbound"),
     ("pbft_tpu_torch/net/server.py", "MAX_CONN_OUTBOUND")),
    ("gateway route-cache bound",
     ("core/net.cc", "kMaxGatewayRoutes"),
     ("pbft_tpu_torch/net/server.py", "MAX_GATEWAY_ROUTES")),
    # Health introspection: the health-document schema version both
    # runtimes stamp into their /status surface, and the detector
    # thresholds every gate (pbft_top, endurance_soak, chaos_bench)
    # shares — a fork here makes a mixed-runtime cluster's health reads
    # incomparable.
    ("health document version",
     ("core/net.h", "kHealthDocVersion"),
     ("pbft_tpu_torch/utils/trace_schema.py", "HEALTH_DOC_VERSION")),
    ("health stall threshold seconds",
     ("core/net.h", "kHealthStallSeconds"),
     ("pbft_tpu_torch/analysis/health.py", "HEALTH_STALL_SECONDS")),
    ("health snapshot interval seconds",
     ("core/net.h", "kHealthSnapshotIntervalS"),
     ("pbft_tpu_torch/analysis/health.py", "HEALTH_SNAPSHOT_INTERVAL_S")),
]

# Files consulted by extractors that are not simple name pairs.
EXTRA_FILES = [
    "core/net.h",
    "core/secure.cc",
    "pbft_tpu_torch/consensus/simulation.py",
    "pbft_tpu_torch/crypto/batch.py",
]


def files_scanned() -> List[str]:
    """Repo-relative paths this pass reads (tests build shadow trees)."""
    out = []
    for _, (cxx, _), (py, _) in PAIRS:
        out.extend([cxx, py])
    out.extend(EXTRA_FILES)
    seen: Dict[str, None] = {}
    for p in out:
        seen.setdefault(p)
    return list(seen)


# -- C++ extraction (regex over declarations) --------------------------------

def _parse_cxx_value(raw: str) -> Optional[Value]:
    raw = raw.strip()
    # bool defaults (e.g. `bool tentative = false;`): compare as 0/1 —
    # Python-side `False` literals extract as bool, and False == 0.
    if raw == "false":
        return 0
    if raw == "true":
        return 1
    m = re.fullmatch(r'"([^"]*)"', raw)
    if m:
        return m.group(1)
    m = re.fullmatch(r"(0[xX][0-9a-fA-F]+|\d+)\s*[uUlL]*\s*<<\s*(\d+)", raw)
    if m:
        return int(m.group(1), 0) << int(m.group(2))
    m = re.fullmatch(r"(0[xX][0-9a-fA-F]+|\d+)[uUlL]*", raw)
    if m:
        return int(m.group(1), 0)
    return None


def cxx_const(path: pathlib.Path, name: str) -> Optional[Value]:
    """The value of `name = <value>[;,]` in a C++ source/header: covers
    constexpr declarations, enumerators, and struct-member defaults."""
    text = path.read_text()
    hits = set()
    for m in re.finditer(
            r"\b" + re.escape(name) + r"\s*=\s*([^;,\n]+)[;,]", text):
        v = _parse_cxx_value(m.group(1))
        if v is not None:
            hits.add(v)
    if len(hits) > 1:
        raise ValueError(f"{path.name}: {name} bound to multiple values {hits}")
    return next(iter(hits)) if hits else None


# -- Python extraction (AST over bindings) -----------------------------------

def _literal(node: ast.AST) -> Optional[Value]:
    if isinstance(node, ast.Constant) and isinstance(
            node.value, (int, str, bytes)):
        v = node.value
        return v.decode("latin-1") if isinstance(v, bytes) else v
    if (isinstance(node, ast.BinOp) and isinstance(node.op, ast.LShift)
            and isinstance(node.left, ast.Constant)
            and isinstance(node.right, ast.Constant)):
        return node.left.value << node.right.value
    if isinstance(node, ast.Tuple):
        items = [_literal(e) for e in node.elts]
        if all(i is not None for i in items):
            return tuple(items)
    return None


def py_const(path: pathlib.Path, name: str) -> Optional[Value]:
    """The literal bound to `name` anywhere in the module (module level,
    class attribute, or dataclass field annotation-assignment)."""
    tree = ast.parse(path.read_text())
    hits = set()
    for node in ast.walk(tree):
        target = None
        value = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            target, value = node.targets[0].id, node.value
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name) and node.value is not None:
            target, value = node.target.id, node.value
        if target != name or value is None:
            continue
        v = _literal(value)
        if v is not None:
            hits.add(v)
    if len(hits) > 1:
        raise ValueError(f"{path.name}: {name} bound to multiple values {hits}")
    return next(iter(hits)) if hits else None


# -- the pass ----------------------------------------------------------------

def _check_pair(root: pathlib.Path, label: str, cxx_spec, py_spec,
                errors: List[str]) -> None:
    cxx_file, cxx_name = cxx_spec
    py_file, py_name = py_spec
    cxx_path = root / cxx_file
    py_path = root / py_file
    for p in (cxx_path, py_path):
        if not p.exists():
            errors.append(f"constants: {label}: missing file {p}")
            return
    try:
        if cxx_name == "kStatusVersionLint":
            # The readiness probe's version byte: verifier.cc checks it
            # inline (`status[2] != 1`) rather than naming a constant.
            m = re.search(r"status\[2\]\s*!=\s*(\d+)", cxx_path.read_text())
            cxx_val: Optional[Value] = int(m.group(1)) if m else None
        else:
            cxx_val = cxx_const(cxx_path, cxx_name)
        py_val = py_const(py_path, py_name)
    except (ValueError, SyntaxError) as exc:
        errors.append(f"constants: {label}: {exc}")
        return
    if cxx_val is None:
        errors.append(
            f"constants: {label}: {cxx_name} not found in {cxx_file}")
        return
    if py_val is None:
        errors.append(f"constants: {label}: {py_name} not found in {py_file}")
        return
    if cxx_val != py_val:
        errors.append(
            f"constants: {label}: C++ {cxx_file}:{cxx_name} = {cxx_val!r} "
            f"!= Python {py_file}:{py_name} = {py_val!r}")


def _check_chaos_seed(root: pathlib.Path, errors: List[str]) -> None:
    """net.h's default chaos RNG seed and the simulator's seed-mix
    constant are the same magic value by design (one chaos namespace)."""
    net_h = (root / "core/net.h").read_text()
    sim = (root / "pbft_tpu_torch/consensus/simulation.py").read_text()
    m_cxx = re.search(r"chaos_rng_\{(0[xX][0-9a-fA-F]+|\d+)\}", net_h)
    m_py = re.search(
        r"chaos_rng\s*=\s*random\.Random\([^\n]*\^\s*(0[xX][0-9a-fA-F]+|\d+)\)",
        sim)
    if not m_cxx:
        errors.append("constants: chaos seed: default not found in core/net.h")
        return
    if not m_py:
        errors.append(
            "constants: chaos seed: mix constant not found in simulation.py")
        return
    if int(m_cxx.group(1), 0) != int(m_py.group(1), 0):
        errors.append(
            f"constants: chaos seed: net.h {m_cxx.group(1)} != "
            f"simulation.py {m_py.group(1)}")


def _check_pad_ladder(root: pathlib.Path, errors: List[str]) -> None:
    """Pad-ladder shape: ascending, topped by the service merge cap
    (service.py MAX_WINDOW) and the C++ async-budget clamp (verifier.cc)
    — three independent spellings of the largest window shape."""
    ladder = py_const(root / "pbft_tpu_torch/crypto/batch.py", "_PAD_LADDER")
    if not isinstance(ladder, tuple) or not ladder:
        errors.append("constants: pad ladder: _PAD_LADDER not found/parsed "
                      "in crypto/batch.py")
        return
    if list(ladder) != sorted(ladder):
        errors.append(f"constants: pad ladder {ladder} is not ascending")
    top = ladder[-1]
    max_window = py_const(root / "pbft_tpu_torch/net/service.py", "MAX_WINDOW")
    if max_window != top:
        errors.append(
            f"constants: pad ladder top {top} != service.py MAX_WINDOW "
            f"{max_window}")
    vcc = (root / "core/verifier.cc").read_text()
    m = re.search(
        r"async_budget_items_\s*>\s*(\d+)\)\s*async_budget_items_\s*=\s*(\d+)",
        vcc)
    if not m:
        errors.append(
            "constants: pad ladder: async-budget clamp not found in "
            "core/verifier.cc")
    elif int(m.group(1)) != top or int(m.group(2)) != top:
        errors.append(
            f"constants: pad ladder top {top} != verifier.cc async-budget "
            f"clamp {m.group(1)}/{m.group(2)}")


def _check_status_magic(root: pathlib.Path, errors: List[str]) -> None:
    """service.py STATUS_MAGIC vs the byte checks in verifier.cc."""
    magic = py_const(root / "pbft_tpu_torch/net/service.py", "STATUS_MAGIC")
    vcc = (root / "core/verifier.cc").read_text()
    m = re.search(r"status\[0\]\s*!=\s*'(.)'\s*\|\|\s*status\[1\]\s*!=\s*'(.)'",
                  vcc)
    if not isinstance(magic, str) or len(magic) != 2:
        errors.append("constants: status magic: STATUS_MAGIC not found/2-byte "
                      "in service.py")
        return
    if not m:
        errors.append("constants: status magic: byte checks not found in "
                      "core/verifier.cc")
        return
    if m.group(1) + m.group(2) != magic:
        errors.append(
            f"constants: status magic: verifier.cc checks "
            f"{m.group(1) + m.group(2)!r} != service.py STATUS_MAGIC "
            f"{magic!r}")


def _check_version_set(root: pathlib.Path, errors: List[str]) -> None:
    """secure.py's _COMPATIBLE_VERSIONS must be exactly the four version
    constants (which the pairwise checks pin to the C++ spellings); the
    C++ compatible set in secure.cc is the same four names by check."""
    path = root / "pbft_tpu_torch/net/secure.py"
    tree = ast.parse(path.read_text())
    consts = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            v = _literal(node.value)
            if v is not None:
                consts[node.targets[0].id] = v
    compatible = None
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                node.targets[0].id == "_COMPATIBLE_VERSIONS" and \
                isinstance(node.value, ast.Tuple):
            names = [e.id for e in node.value.elts if isinstance(e, ast.Name)]
            compatible = {consts.get(n) for n in names}
    want = {consts.get("PROTOCOL_VERSION"),
            consts.get("PROTOCOL_VERSION_BATCH"),
            consts.get("PROTOCOL_VERSION_BIN2"),
            consts.get("PROTOCOL_VERSION_LEGACY")}
    if compatible is None:
        errors.append(
            "constants: version set: _COMPATIBLE_VERSIONS not found in "
            "secure.py")
    elif compatible != want:
        errors.append(
            f"constants: version set: _COMPATIBLE_VERSIONS {compatible} != "
            f"the four protocol versions {want}")
    # C++ side: secure.cc must admit exactly the four named constants.
    scc = (root / "core/secure.cc")
    if scc.exists():
        text = scc.read_text()
        for name in ("kProtocolVersion", "kProtocolVersionBatch",
                     "kProtocolVersionBin2", "kProtocolVersionLegacy"):
            if not re.search(r"ver\s*!=\s*" + name, text):
                errors.append(
                    f"constants: version set: secure.cc compatible-set check "
                    f"does not name {name}")


def check(root: pathlib.Path = REPO) -> List[str]:
    """All conformance checks; [] when the runtimes agree."""
    errors: List[str] = []
    for label, cxx_spec, py_spec in PAIRS:
        _check_pair(root, label, cxx_spec, py_spec, errors)
    try:
        _check_chaos_seed(root, errors)
        _check_pad_ladder(root, errors)
        _check_status_magic(root, errors)
        _check_version_set(root, errors)
    except FileNotFoundError as exc:
        errors.append(f"constants: missing file: {exc}")
    return errors
