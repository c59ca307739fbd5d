"""No blocking calls inside ``async def``: the port's copy of
``pbft_tpu/analysis/async_blocking.py``, over ``pbft_tpu_torch/net/``.

The asyncio runtime's event loop is the Python twin of net.cc's poll()
loop: ONE blocking call inside a coroutine stalls every replica duty —
verify batching, view-change timers, the chaos delay pump — exactly the
wedge class the C++ side guards with deadlines. This pass walks the AST
of every module in ``pbft_tpu_torch/net/`` and flags calls that are known to
block when they appear inside an ``async def`` body:

    time.sleep                    (asyncio.sleep is the loop-safe spelling)
    subprocess.run/call/check_*   (use asyncio.create_subprocess_*)
    os.system
    socket.create_connection      (use loop.sock_connect / open_connection)
    <sock>.recv/recv_into/accept/connect/sendall  un-awaited socket method
                                  calls (use loop.sock_* or streams)
    open(...)                     blocking file I/O on the loop

Nested ``def`` bodies inside an ``async def`` are NOT flagged (a sync
helper defined in a coroutine runs wherever it is called — commonly via
run_in_executor); ``await loop.run_in_executor(None, time.sleep, ...)``
passes the callable without calling it, so it never trips the pass.
"""

from __future__ import annotations

import ast
import pathlib
from typing import List, Optional, Tuple

REPO = pathlib.Path(__file__).resolve().parent.parent.parent

# (module, attribute) calls that block the loop.
BLOCKING_MODULE_CALLS = {
    ("time", "sleep"),
    ("subprocess", "run"),
    ("subprocess", "call"),
    ("subprocess", "check_call"),
    ("subprocess", "check_output"),
    ("os", "system"),
    ("socket", "create_connection"),
}
# Method names that block when called on a raw socket-ish object inside a
# coroutine. Narrow on purpose: generic enough names (read/write/send)
# would drown the pass in false positives on asyncio streams.
BLOCKING_METHODS = {"recv", "recv_into", "recvfrom", "accept", "connect",
                    "sendall"}
# Bare calls that block (file I/O on the loop).
BLOCKING_BARE_CALLS = {"open"}


def _call_signature(node: ast.Call) -> Optional[Tuple[str, str]]:
    func = node.func
    if isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name):
        return (func.value.id, func.attr)
    return None


def _blocking_reason(node: ast.Call) -> Optional[str]:
    func = node.func
    if isinstance(func, ast.Name) and func.id in BLOCKING_BARE_CALLS:
        return f"{func.id}()"
    sig = _call_signature(node)
    if sig is None:
        return None
    if sig in BLOCKING_MODULE_CALLS:
        return f"{sig[0]}.{sig[1]}"
    # obj.recv(...) etc: flag unless obj is a module from the allow-set
    # (asyncio.X, loop helpers are Attribute chains and never match).
    if sig[1] in BLOCKING_METHODS and sig[0] not in ("asyncio", "loop"):
        return f"{sig[0]}.{sig[1]}"
    return None


class _AsyncWalker(ast.NodeVisitor):
    def __init__(self, path: pathlib.Path, errors: List[str]):
        self.path = path
        self.errors = errors
        self.async_stack: List[str] = []

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self.async_stack.append(node.name)
        self.generic_visit(node)
        self.async_stack.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        # A sync def nested in a coroutine is a new (non-loop) context.
        saved, self.async_stack = self.async_stack, []
        self.generic_visit(node)
        self.async_stack = saved

    def visit_Lambda(self, node: ast.Lambda) -> None:
        saved, self.async_stack = self.async_stack, []
        self.generic_visit(node)
        self.async_stack = saved

    def visit_Call(self, node: ast.Call) -> None:
        if self.async_stack:
            reason = _blocking_reason(node)
            if reason:
                self.errors.append(
                    f"async-blocking: {self.path.name}:{node.lineno}: "
                    f"blocking call {reason} inside async def "
                    f"'{self.async_stack[-1]}'")
        self.generic_visit(node)


def check_file(path: pathlib.Path) -> List[str]:
    errors: List[str] = []
    try:
        tree = ast.parse(path.read_text())
    except SyntaxError as exc:
        return [f"async-blocking: {path.name}: unparseable: {exc}"]
    _AsyncWalker(path, errors).visit(tree)
    return errors


def files_scanned(root: pathlib.Path = REPO) -> List[pathlib.Path]:
    return sorted((root / "pbft_tpu_torch" / "net").glob("*.py"))


def check(root: pathlib.Path = REPO) -> List[str]:
    errors: List[str] = []
    for path in files_scanned(root):
        errors.extend(check_file(path))
    return errors
