"""Metrics/trace-event conformance lint: the port's copy of
``pbft_tpu/analysis/metrics_lint.py``. Every trace-event and metric
emitter of the port's runtime, and of the C++ core, is statically
extracted and diffed against the port's manifest,
``pbft_tpu_torch/utils/trace_schema.py`` (pinned to the reference's by
tests/test_torch_surface.py).

Per emitter:

- Python emitters (net/server.py, net/service.py, net/verify_service.py,
  net/client.py, net/gateway.py, utils/metrics.py): every
  ``tracer.event("name", field=...)`` call is parsed from the AST — the
  event name must be in the manifest with this file listed as an
  emitter, its keyword fields a subset of required|optional, every
  required field present. Every ``registry.counter/gauge/histogram("name")``
  lookup must name a manifest metric of that type.
- Sweep: every other module under ``pbft_tpu_torch/`` is scanned for
  ``.counter/.gauge/.histogram("pbft_...")`` lookups — an unregistered
  metric name anywhere in the package fails the lint, not just in the
  declared emitter files.
- C++ emitter (core/net.cc): event names extracted from the
  ``\\"ev\\":\\"<name>\\"`` tokens in its format strings — exact two-way
  match against the manifest's net.cc events, field tokens checked both
  directions.
- C++ metric tables (core/metrics.cc): kCounterNames/kGaugeNames/
  kHistogramNames must match the manifest's net.cc metric sets
  name-for-name and type-for-type; kLatencyBuckets/kSizeBuckets must
  equal LATENCY_BUCKETS_S/BATCH_SIZE_BUCKETS value-for-value.
- Phase names passed to phase_hook in the port's consensus/replica.py
  and core/replica.cc must be exactly the manifest PHASES.

Everything reads relative to ``root`` (the manifest too, loaded by file
path) so tests/test_torch_lint.py can run the pass against a shadow tree
with a deliberately unregistered metric.
"""

from __future__ import annotations

import ast
import importlib.util
import pathlib
import re
from typing import Dict, List

REPO = pathlib.Path(__file__).resolve().parent.parent.parent

PY_EMITTERS = {
    "server.py": pathlib.Path("pbft_tpu_torch/net/server.py"),
    "service.py": pathlib.Path("pbft_tpu_torch/net/service.py"),
    "verify_service.py": pathlib.Path("pbft_tpu_torch/net/verify_service.py"),
    # The client emits its half of the latency waterfall (client_request
    # send/first-reply/quorum stamps) — held to the same manifest
    # contract as the replica runtimes.
    "client.py": pathlib.Path("pbft_tpu_torch/net/client.py"),
    # The gateway tier: clients-open gauge, forwarded counter,
    # and the shared backpressure counter — same manifest contract.
    "gateway.py": pathlib.Path("pbft_tpu_torch/net/gateway.py"),
}
# utils/metrics.py emits consensus_span on behalf of server.py (the spans
# object is wired there); lint it under the server.py emitter identity.
PY_EMITTER_ALIASES = {
    pathlib.Path("pbft_tpu_torch/utils/metrics.py"): "server.py",
}
NET_CC = pathlib.Path("core/net.cc")
METRICS_CC = pathlib.Path("core/metrics.cc")
PY_REPLICA = pathlib.Path("pbft_tpu_torch/consensus/replica.py")
CC_REPLICA = pathlib.Path("core/replica.cc")
MANIFEST = pathlib.Path("pbft_tpu_torch/utils/trace_schema.py")


def load_manifest(root: pathlib.Path):
    """Import the manifest module FROM root (not the installed package),
    so a shadow tree lints against its own manifest copy."""
    spec = importlib.util.spec_from_file_location(
        "_pbft_torch_lint_trace_schema", root / MANIFEST)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # type: ignore[union-attr]
    return mod


def files_scanned(root: pathlib.Path = REPO) -> List[pathlib.Path]:
    fixed = [root / p for p in PY_EMITTERS.values()]
    fixed += [root / p for p in PY_EMITTER_ALIASES]
    fixed += [root / p for p in (NET_CC, METRICS_CC, PY_REPLICA, CC_REPLICA,
                                 MANIFEST)]
    return fixed + _sweep_files(root)


def _sweep_files(root: pathlib.Path) -> List[pathlib.Path]:
    """The sweep targets: every pbft_tpu_torch module that is not
    already a declared emitter (those get the stricter per-emitter lint)."""
    known = {root / p for p in PY_EMITTERS.values()}
    known |= {root / p for p in PY_EMITTER_ALIASES}
    out = []
    for path in sorted((root / "pbft_tpu_torch").rglob("*.py")):
        if path in known or "__pycache__" in path.parts:
            continue
        out.append(path)
    return out


def _event_calls(path: pathlib.Path):
    """(event_name, keyword_field_set, has_dynamic_kwargs, lineno) for
    every .event(...) call; a conditional name (IfExp) yields one entry
    per branch."""
    tree = ast.parse(path.read_text())
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if not (isinstance(func, ast.Attribute) and func.attr == "event"):
            continue
        if not node.args:
            continue
        arg = node.args[0]
        names = []
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            names = [arg.value]
        elif isinstance(arg, ast.IfExp):
            for side in (arg.body, arg.orelse):
                if isinstance(side, ast.Constant) and isinstance(
                        side.value, str):
                    names.append(side.value)
        if not names:
            continue
        fields = set()
        dynamic = False
        for kw in node.keywords:
            if kw.arg is None:
                dynamic = True  # **fields: contents checked at the call site
            else:
                fields.add(kw.arg)
        for name in names:
            out.append((name, fields, dynamic, node.lineno))
    return out


def _metric_lookups(path: pathlib.Path):
    """(kind, name, lineno) for registry.counter/gauge/histogram("...")."""
    tree = ast.parse(path.read_text())
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if not (
            isinstance(func, ast.Attribute)
            and func.attr in ("counter", "gauge", "histogram")
        ):
            continue
        if node.args and isinstance(node.args[0], ast.Constant):
            val = node.args[0].value
            if isinstance(val, str):
                out.append((func.attr, val, node.lineno))
    return out


def check(root: pathlib.Path = REPO) -> List[str]:
    errors: List[str] = []
    trace_schema = load_manifest(root)
    schemas = trace_schema.EVENT_SCHEMAS
    metrics = trace_schema.METRIC_SCHEMAS

    # -- Python trace events -------------------------------------------------
    py_seen: Dict[str, set] = {}  # emitter -> set of event names
    files = [(em, root / p) for em, p in PY_EMITTERS.items()] + [
        (em, root / p) for p, em in PY_EMITTER_ALIASES.items()
    ]
    for emitter, path in files:
        for name, fields, dynamic, line in _event_calls(path):
            loc = f"{path.name}:{line}"
            schema = schemas.get(name)
            if schema is None:
                errors.append(f"{loc}: event {name!r} not in manifest")
                continue
            if emitter not in schema["emitters"]:
                errors.append(
                    f"{loc}: {emitter} is not a manifest emitter of {name!r}"
                )
            allowed = schema["required"] | schema["optional"]
            # ts/ev are stamped by Tracer.event itself.
            extra = fields - allowed
            if extra:
                errors.append(
                    f"{loc}: event {name!r} has unknown fields {sorted(extra)}"
                )
            if not dynamic:
                missing = schema["required"] - fields - {"ts", "ev"}
                if missing:
                    errors.append(
                        f"{loc}: event {name!r} missing required fields "
                        f"{sorted(missing)}"
                    )
            py_seen.setdefault(emitter, set()).add(name)
    for name, schema in schemas.items():
        for emitter in schema["emitters"] & set(PY_EMITTERS):
            if name not in py_seen.get(emitter, set()):
                errors.append(
                    f"{emitter}: manifest event {name!r} is never emitted"
                )

    # -- Python metric lookups (declared emitters) ---------------------------
    py_metrics_seen: Dict[str, set] = {}
    for emitter, path in files:
        for kind, name, line in _metric_lookups(path):
            loc = f"{path.name}:{line}"
            if name not in metrics:
                errors.append(f"{loc}: metric {name!r} not in manifest")
                continue
            want, emitters = metrics[name]
            if kind != want:
                errors.append(
                    f"{loc}: metric {name!r} looked up as {kind}, "
                    f"manifest says {want}"
                )
            if emitter not in emitters:
                errors.append(
                    f"{loc}: {emitter} is not a manifest emitter of {name!r}"
                )
            py_metrics_seen.setdefault(emitter, set()).add(name)
    # ConsensusSpans (utils/metrics.py, wired into server.py) records the
    # phase histograms through the PHASE_HISTOGRAMS table rather than
    # string literals — credit those to server.py from the manifest table
    # itself (drift there is drift in the manifest, not the emitter).
    py_metrics_seen.setdefault("server.py", set()).update(
        trace_schema.PHASE_HISTOGRAMS.values()
    )
    for name, (kind, emitters) in metrics.items():
        for emitter in emitters & set(PY_EMITTERS):
            if name not in py_metrics_seen.get(emitter, set()):
                errors.append(
                    f"{emitter}: manifest metric {name!r} is never recorded"
                )

    # -- generalized sweep: unregistered metric names anywhere -----------------
    # Only pbft_-prefixed literals are considered (collections.Counter and
    # friends share the method names); declared emitters were already held
    # to the stricter emitter/type contract above.
    for path in _sweep_files(root):
        try:
            lookups = _metric_lookups(path)
        except SyntaxError as exc:
            errors.append(f"{path.name}: unparseable: {exc}")
            continue
        for kind, name, line in lookups:
            if not name.startswith("pbft_"):
                continue
            rel = path.relative_to(root)
            if name not in metrics:
                errors.append(
                    f"{rel}:{line}: metric {name!r} not in manifest")
            elif metrics[name][0] != kind:
                errors.append(
                    f"{rel}:{line}: metric {name!r} looked up as {kind}, "
                    f"manifest says {metrics[name][0]}")

    # -- C++ trace events (net.cc) ------------------------------------------
    cc = (root / NET_CC).read_text()
    cc_events = set(re.findall(r'\\"ev\\":\\"(\w+)\\"', cc))
    want_cc = {n for n, s in schemas.items() if "net.cc" in s["emitters"]}
    for name in cc_events - want_cc:
        errors.append(f"net.cc: event {name!r} not a manifest net.cc event")
    for name in want_cc - cc_events:
        errors.append(f"net.cc: manifest event {name!r} is never emitted")
    cc_fields = set(re.findall(r'\\"(\w+)\\":', cc))
    known_cc_fields = set()
    for name in want_cc:
        known_cc_fields |= schemas[name]["required"] | schemas[name]["optional"]
    for f in cc_fields - known_cc_fields - cc_events:
        errors.append(f"net.cc: JSON field {f!r} not in any net.cc event schema")
    for name in want_cc:
        for f in schemas[name]["required"] - {"ts", "ev"}:
            # consensus_span assembles its optional-phase fields from a
            # plain string-literal names array, so accept either the
            # \"field\": format-string token or a bare "field" literal.
            if f not in cc_fields and f'"{f}"' not in cc:
                errors.append(
                    f"net.cc: required field {f!r} of event {name!r} "
                    "never appears in a format string"
                )

    # -- C++ metric name tables + buckets (metrics.cc) -----------------------
    mc = (root / METRICS_CC).read_text()

    def array_strings(var):
        m = re.search(re.escape(var) + r"\[\]\s*=\s*\{(.*?)\};", mc, re.S)
        return re.findall(r'"([^"]+)"', m.group(1)) if m else None

    want_native = {
        kind: {n for n, (k, em) in metrics.items() if k == kind and "net.cc" in em}
        for kind in ("counter", "gauge", "histogram")
    }
    for var, kind in (
        ("kCounterNames", "counter"),
        ("kGaugeNames", "gauge"),
        ("kHistogramNames", "histogram"),
    ):
        got = array_strings(var)
        if got is None:
            errors.append(f"metrics.cc: table {var} not found")
            continue
        if set(got) != want_native[kind]:
            errors.append(
                f"metrics.cc: {var} = {sorted(got)} != manifest {kind}s "
                f"{sorted(want_native[kind])}"
            )

    def array_numbers(var):
        m = re.search(re.escape(var) + r"\s*=\s*\{(.*?)\};", mc, re.S)
        if not m:
            return None
        return [float(x) for x in re.findall(r"[0-9.]+", m.group(1))]

    for var, want in (
        ("kLatencyBuckets", list(trace_schema.LATENCY_BUCKETS_S)),
        ("kSizeBuckets", [float(x) for x in trace_schema.BATCH_SIZE_BUCKETS]),
    ):
        got = array_numbers(var)
        if got != want:
            errors.append(f"metrics.cc: {var} = {got} != manifest {want}")

    # -- phase names in both replicas ----------------------------------------
    for path, pattern in (
        (root / PY_REPLICA, r'hook\("(\w+)"'),
        (root / CC_REPLICA, r'phase_hook\("(\w+)"'),
    ):
        got = set(re.findall(pattern, path.read_text()))
        if got != set(trace_schema.PHASES):
            errors.append(
                f"{path.name}: phase_hook phases {sorted(got)} != manifest "
                f"PHASES {sorted(trace_schema.PHASES)}"
            )
    return errors
