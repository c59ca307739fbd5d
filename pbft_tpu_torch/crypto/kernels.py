"""The four CUDA kernels of the verify path: wrappers, plain versions,
launch counters and the build.

=========  ======================  ====================================
wrapper    CUDA source             replaces (pbft_tpu/crypto/...)
=========  ======================  ====================================
``inv``      ``csrc/chains.cu``    ``pallas_kernels.py`` ``_inv_kernel``
``pow_p58``  ``csrc/chains.cu``    ``pallas_kernels.py`` ``_p58_kernel``
``ladder``   ``csrc/ladder.cu``    ``pallas_kernels.py`` ``_ladder_kernel``
``sha512``   ``csrc/sha512.cu``    none: plain ``sha512.py``
=========  ======================  ====================================

Each wrapper takes its plain PyTorch version (``inv_plain``,
``pow_p58_plain``, ``ladder_plain``, ``sha512_plain``: the ports of
``field.inv``, ``field.pow_p58``, ``ed25519.shamir_ladder`` and
``sha512.sha512``) **only** for a tensor on the CPU. For a CUDA tensor it
launches its kernel or raises; nothing falls back. Inputs are checked
(dtype, shape, contiguity, alignment, device) and handed to the kernels in
their own batch-major layout, with no transposes: (..., 32) limbs, where a
group of lanes of one warp owns each item (``csrc/fe25519.cuh``), or
(..., n) bytes, one thread a row (``csrc/sha512.cu``). Kernels launch on
the calling thread's current stream: on a graph's own stream when it is
captured (``utils/graphs.py``). ``LAUNCHES`` counts kernel launches per
wrapper; a launch that is recorded into a CUDA graph is counted at each
replay of the graph instead (``recording``, ``add_launches``).

The kernels are compiled by ``nvcc`` for ``sm_90a`` at first use, one
process per source started together, into plain-C shared libraries loaded
with ``ctypes``: ``build/pbft_tpu_torch/<hash of sources, arch, nvcc>/``
under the repository root, or ``<host_keyed_cache_dir(cache_dir)>/<hash>/``
when ``build`` is given a ``cache_dir`` (the verify daemon's
``--cache-dir``): a directory that holds the libraries already is loaded
without compiling. Nothing is compiled when this module is imported.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import math
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

from . import field as F
from . import ref

ARCH = "sm_90a"
_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "pbft_tpu_torch"
# library name -> source; each library is built by its own nvcc process.
_SOURCES = {"chains": "chains.cu", "ladder": "ladder.cu", "sha512": "sha512.cu"}
_HEADERS = ("fe25519.cuh",)
# wrapper -> (library, C entry point, mangled-name fragment of its kernel).
KERNELS = {
    "inv": ("chains", "pbft_inv", "chain_kernelILb1"),
    "p58": ("chains", "pbft_pow_p58", "chain_kernelILb0"),
    "ladder": ("ladder", "pbft_ladder", "ladder_kernel"),
    "sha512": ("sha512", "pbft_sha512_rows", "sha512_kernel"),
}
_VP, _CI = ctypes.c_void_p, ctypes.c_int
# C entry point -> its ctypes argument types (pointers and stream as void*).
ARGTYPES = {
    "pbft_inv": [_VP, _VP, _CI, _VP],
    "pbft_pow_p58": [_VP, _VP, _CI, _VP],
    "pbft_ladder": [_VP] * 11 + [_CI, _VP],
    "pbft_sha512_rows": [_VP, _VP, _CI, _CI, _VP],
}

LAUNCHES = {name: 0 for name in KERNELS}
_count_lock = threading.Lock()
_build_lock = threading.Lock()
_libs: dict = {}
BUILD_INFO: dict = {}


def reset_launches() -> None:
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


_capture = threading.local()


def _count(name: str) -> None:
    recorded = getattr(_capture, "counts", None)
    if recorded is not None:  # into a graph: counted when it replays
        recorded[name] += 1
        return
    with _count_lock:
        LAUNCHES[name] += 1


@contextlib.contextmanager
def recording():
    """While this thread captures a CUDA graph: the launches its wrappers
    record, per kernel, instead of counting them in ``LAUNCHES``."""
    counts = dict.fromkeys(LAUNCHES, 0)
    _capture.counts = counts
    try:
        yield counts
    finally:
        _capture.counts = None


def add_launches(counts: dict) -> None:
    """Count the launches of one replay of a graph (``recording``'s counts)."""
    with _count_lock:
        for name, n in counts.items():
            LAUNCHES[name] += n


# ---------------------------------------------------------------------------
# Build and load.
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return path


def _parse_ptxas(text: str) -> dict:
    """``-Xptxas -v`` output -> {mangled kernel: registers/spills/stack}."""
    out: dict = {}
    cur = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur.update(stack_bytes=int(m.group(1)), spill_store_bytes=int(m.group(2)),
                       spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def build_root(cache_dir=None) -> Path:
    """The directory under which ``build`` keeps one subdirectory per hash
    of sources, arch and nvcc: ``build/pbft_tpu_torch/`` in the repository,
    or ``host_keyed_cache_dir(cache_dir)`` (``utils/cache.py``)."""
    if cache_dir is None:
        return _BUILD_ROOT
    from ..utils.cache import host_keyed_cache_dir

    return Path(host_keyed_cache_dir(os.fspath(cache_dir)))


def build(cache_dir=None) -> dict:
    """Compile (if needed) and load the kernel libraries; idempotent: the
    first call of a process loads its libraries, and later calls return
    them, whatever their ``cache_dir``.

    Returns ``BUILD_INFO``: the build directory (under
    ``build_root(cache_dir)``), seconds spent, the libraries compiled
    (``compiled``: none when the directory held them), and per-kernel
    registers/spills from ptxas."""
    with _build_lock:
        if len(_libs) == len(_SOURCES):
            return BUILD_INFO
        t0 = time.perf_counter()
        nvcc = _nvcc()
        version = subprocess.run([nvcc, "--version"], capture_output=True, text=True, check=True).stdout
        h = hashlib.sha256(f"{ARCH}\n{version}".encode())
        for name in sorted(list(_SOURCES.values()) + list(_HEADERS)):
            h.update(name.encode() + b"\0" + (_CSRC / name).read_bytes())
        out_dir = build_root(cache_dir) / h.hexdigest()[:16]
        out_dir.mkdir(parents=True, exist_ok=True)
        procs = {}
        for lib, src in _SOURCES.items():
            if (out_dir / f"lib{lib}.so").exists():
                continue
            tmp = out_dir / f"lib{lib}.so.tmp{os.getpid()}"
            cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                   "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(_CSRC),
                   "-o", str(tmp), str(_CSRC / src)]
            procs[lib] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True), tmp)
        logs = {lib: proc.communicate()[0] for lib, (proc, _) in procs.items()}
        for lib, (proc, tmp) in procs.items():
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {_SOURCES[lib]}:\n{logs[lib]}")
            (out_dir / f"lib{lib}.ptxas.txt").write_text(logs[lib])
            os.replace(tmp, out_dir / f"lib{lib}.so")
        ptxas: dict = {}
        for lib in _SOURCES:
            report = out_dir / f"lib{lib}.ptxas.txt"
            if report.exists():
                ptxas.update(_parse_ptxas(report.read_text()))
            _libs[lib] = ctypes.CDLL(str(out_dir / f"lib{lib}.so"))
        for lib, entry, _ in KERNELS.values():
            fn = getattr(_libs[lib], entry)
            fn.restype = _CI
            fn.argtypes = ARGTYPES[entry]
        BUILD_INFO.update(
            dir=str(out_dir),
            build_s=time.perf_counter() - t0,
            compiled=sorted(procs),
            kernels={
                name: next((v for k, v in ptxas.items() if frag in k), {})
                for name, (_, _, frag) in KERNELS.items()
            },
        )
        return BUILD_INFO


def _entry(name: str):
    build()
    lib, entry, _ = KERNELS[name]
    return getattr(_libs[lib], entry)


def _check(x: torch.Tensor, what: str, last=None, dtype=torch.int32, align: int = 16) -> None:
    """Raise ``ValueError`` unless ``x`` is a contiguous, ``align``-byte
    aligned CUDA tensor of ``dtype`` and shape (..., last) (any last
    dimension for ``last=None``)."""
    if not isinstance(x, torch.Tensor):
        raise ValueError(f"{what}: expected a CUDA tensor")
    if x.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {x.dtype}")
    if x.dim() < 1 or (last is not None and x.shape[-1] != last):
        raise ValueError(f"{what}: expected shape (..., {last or 'n'}), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if x.data_ptr() % align:
        raise ValueError(f"{what}: expected a {align}-byte aligned tensor")
    if x.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# ---------------------------------------------------------------------------
# The chain kernels: inv and pow_p58.
# ---------------------------------------------------------------------------


def inv_plain(z):
    """Plain version of ``inv``: ``field.inv``."""
    return F.inv(z)


def pow_p58_plain(z):
    """Plain version of ``pow_p58``: ``field.pow_p58``."""
    return F.pow_p58(z)


def _run_chain(name: str, z: torch.Tensor) -> torch.Tensor:
    _check(z, name, F.NLIMBS)
    g = z.numel() // F.NLIMBS
    with torch.cuda.device(z.device):
        out = torch.empty_like(z)
        _raise_on(_entry(name)(z.data_ptr(), out.data_ptr(), g, _stream(z.device)), name)
        _count(name)
        return out


def inv(z: torch.Tensor) -> torch.Tensor:
    """z^(p-2) (inv(0) = 0) on (..., 32) carried int32 limbs; carried out."""
    if z.device.type == "cpu":
        return inv_plain(z)
    return _run_chain("inv", z)


def pow_p58(z: torch.Tensor) -> torch.Tensor:
    """z^((p-5)/8) on (..., 32) carried int32 limbs; carried out."""
    if z.device.type == "cpu":
        return pow_p58_plain(z)
    return _run_chain("p58", z)


# ---------------------------------------------------------------------------
# The ladder kernel.
# ---------------------------------------------------------------------------


def _ladder_consts() -> np.ndarray:
    """The (32, 32) limb-major constant block of the TPU ladder kernel
    (``pallas_kernels._LADDER_CONSTS``): column 0 = 2p, 1 = 2d, 2 = 1, then
    3 + 4*s + c = coordinate c of [s]B."""
    out = np.zeros((F.NLIMBS, 32), np.int32)
    out[:, 0] = F.limbs_const(2 * F.P)
    out[:, 1] = F.limbs_const(2 * ref.D % F.P)
    out[:, 2] = F.limbs_const(1)
    for s, entry in enumerate(ref.shamir_row0()):
        for c, v in enumerate(entry):
            out[:, 3 + 4 * s + c] = F.limbs_const(v)
    return out


LADDER_CONSTS = _ladder_consts()
_consts_on: dict = {}


def ladder_plain(s_bits, h_bits, a_neg):
    """Plain version of ``ladder``: ``ed25519.shamir_ladder``."""
    from .ed25519 import shamir_ladder

    return shamir_ladder(s_bits, h_bits, a_neg)


def ladder_digits(s_bits: torch.Tensor, h_bits: torch.Tensor) -> torch.Tensor:
    """(g, 256) LSB-first bit arrays -> (g, 128) MSB-first digits
    d = s0 + 2 s1 + 4 h0 + 8 h1 in 0..15 (``pallas_kernels.ladder``)."""
    dig = s_bits[:, 0::2] + 2 * s_bits[:, 1::2] + 4 * h_bits[:, 0::2] + 8 * h_bits[:, 1::2]
    return dig.flip(1)


def ladder(s_bits: torch.Tensor, h_bits: torch.Tensor, a_neg):
    """[S]B + [h](-A). s_bits, h_bits: (..., 256) int32 in {0, 1},
    LSB-first; a_neg: 4 x (..., 32) int32 (extended X, Y, Z, T). Returns the
    accumulator point, 4 x (..., 32) int32, batch-major."""
    if s_bits.device.type == "cpu":
        return ladder_plain(s_bits, h_bits, a_neg)
    _check(s_bits, "ladder s_bits", 256)
    _check(h_bits, "ladder h_bits", 256)
    if h_bits.shape != s_bits.shape or len(a_neg) != 4:
        raise ValueError("ladder: mismatched s_bits/h_bits or a_neg is not 4 coordinates")
    lead = s_bits.shape[:-1]
    for c in a_neg:
        _check(c, "ladder a_neg", F.NLIMBS)
        if c.shape[:-1] != lead or c.device != s_bits.device:
            raise ValueError("ladder: a_neg does not match the scalars' batch or device")
    dev = s_bits.device
    g = s_bits.numel() // 256
    with torch.cuda.device(dev):
        consts = _consts_on.get(dev)
        if consts is None:
            consts = _consts_on.setdefault(dev, torch.from_numpy(LADDER_CONSTS).to(dev))
        digits = ladder_digits(s_bits.reshape(g, 256), h_bits.reshape(g, 256))  # (g, 128)
        outs = [torch.empty_like(c) for c in a_neg]
        table = torch.empty((g, 16, 4, F.NLIMBS), dtype=torch.int32, device=dev)
        rc = _entry("ladder")(
            consts.data_ptr(), digits.data_ptr(), *(c.data_ptr() for c in a_neg),
            *(o.data_ptr() for o in outs), table.data_ptr(), g, _stream(dev),
        )
        _raise_on(rc, "ladder")
        _count("ladder")
        return tuple(outs)


# ---------------------------------------------------------------------------
# The SHA-512 kernel.
# ---------------------------------------------------------------------------


def sha512_plain(msg):
    """Plain version of ``sha512``: ``sha512.sha512_plain``."""
    from .sha512 import sha512_plain

    return sha512_plain(msg)


def sha512(msg: torch.Tensor) -> torch.Tensor:
    """SHA-512 of each row of a (..., n) uint8 tensor: (..., 64) uint8
    digests on its device. Any n; the kernel pads each row itself."""
    if msg.device.type == "cpu":
        return sha512_plain(msg)
    _check(msg, "sha512", dtype=torch.uint8, align=1)
    lead = tuple(msg.shape[:-1])
    rows = math.prod(lead)
    with torch.cuda.device(msg.device):
        out = torch.empty(lead + (64,), dtype=torch.uint8, device=msg.device)
        rc = _entry("sha512")(msg.data_ptr(), out.data_ptr(), rows, msg.shape[-1], _stream(msg.device))
        _raise_on(rc, "sha512")
        _count("sha512")
        return out
