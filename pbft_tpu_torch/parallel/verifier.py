"""Verification sharded over the local cards, per-round quorum certification
and the round step: the port of ``pbft_tpu/parallel/verifier.py``.

- A :class:`Mesh` is the ordered list of local devices that a window is cut
  over (one shard each; a device may repeat) and, across processes, the
  ``torch.distributed`` group it spans.
- ``sharded_verify``: a window of B rows splits into equal row blocks, one
  per local shard. Each shard is staged to its device and verified there by
  ``ed25519.verify_kernel`` (the three CUDA kernels on a card, their plain
  versions on the CPU). A card shard runs on a CUDA stream of its own, from
  a worker thread of its own, so the host work of the shards overlaps.
  Verdicts are gathered in row order on the mesh's first device.
- ``quorum_certify``: each shard also counts its valid rows per round; the
  shard counts are summed, then all-reduced over the mesh's group, so every
  process reads the same ``counts`` and ``certified``. This is the only
  computation that crosses shards.
- ``round_step``: certification plus the fold of the certified rounds into
  an (8,) int32 state digest.

The semantics are the JAX module's, edge cases included: a round id below 0
counts for round 0 and one of R or more is dropped (``jnp.clip`` to
[0, R], then segment R is sliced off; pad rows carry R), and the fold's
running sum wraps in int32 (``jnp.cumsum``) before its ``% (2**31 - 1)``.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from ..crypto.ed25519 import verify_kernel
from ..device import resolve_device

_STATE_MOD = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The shards of a window: this process's devices in row order, and the
    process group the mesh spans (``None`` for one process). Every process
    of a group holds the same number of shards."""

    devices: tuple
    group: object = None

    @property
    def size(self) -> int:
        """Shards over all processes."""
        if self.group is None:
            return len(self.devices)
        import torch.distributed as dist

        return len(self.devices) * dist.get_world_size(self.group)


def _device(d) -> torch.device:
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """A one-process mesh. ``devices=None`` takes every local card (and
    raises without CUDA; it never takes the CPU); a list may name the CPU
    and may repeat a device. ``n_devices`` keeps the first n."""
    if devices is None:
        resolve_device(None)
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"asked for {n_devices} devices, {len(devices)} available")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(devices))


# -- shards --------------------------------------------------------------


def _blocks(x, k: int) -> list:
    """Rows of a host array (or a list of k per-shard tensors, as
    ``batch_sharding`` stages them) -> k equal row blocks."""
    if isinstance(x, (list, tuple)):
        if len(x) != k:
            raise ValueError(f"{len(x)} staged shards for a mesh of {k}")
        return list(x)
    if not isinstance(x, torch.Tensor):
        x = np.ascontiguousarray(x)
    if x.shape[0] % k:
        raise ValueError(f"batch of {x.shape[0]} rows does not split into {k} equal shards")
    step = x.shape[0] // k
    return [x[i * step : (i + 1) * step] for i in range(k)]


def _stage(x, dev: torch.device, dtype=None, non_blocking: bool = True) -> torch.Tensor:
    """One block onto its device, on the current stream. From host memory to
    a card the copy goes through pinned memory; ``non_blocking=False`` waits
    for it, so another stream may read the result."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    if dtype is not None:
        x = x.to(dtype)
    if x.device == dev:
        return x
    if dev.type == "cuda" and x.device.type == "cpu" and non_blocking:
        return x.contiguous().pin_memory().to(dev, non_blocking=True)
    return x.to(dev)


def _on_shard(dev: torch.device, fn):
    """fn() for one shard: on a card under that device and on a stream of its
    own, finished before returning."""
    if dev.type != "cuda":
        return fn()
    stream = torch.cuda.Stream(device=dev)
    with torch.cuda.device(dev), torch.cuda.stream(stream):
        out = fn()
    stream.synchronize()
    return out


def _run_shards(devices, fn, blocks) -> list:
    """fn(dev, *block) for every shard; a shard's exception propagates.
    Card shards run each from a worker thread of its own, so one shard's
    host work overlaps another's device work. CPU shards (the plain path)
    run one after another on the calling thread: PyTorch's CPU ops gain
    nothing from it and contend (two 4-row shards in two threads took about
    3x one shard's time on an 8-core host)."""
    if len(devices) == 1 or all(d.type == "cpu" for d in devices):
        return [_on_shard(dev, functools.partial(fn, dev, *blk)) for dev, blk in zip(devices, blocks)]
    with ThreadPoolExecutor(len(devices)) as pool:
        futures = [
            pool.submit(_on_shard, dev, functools.partial(fn, dev, *blk))
            for dev, blk in zip(devices, blocks)
        ]
        return [f.result() for f in futures]


def _collect(parts, dev: torch.device) -> list:
    """Shard outputs onto ``dev`` for the caller's stream. A shard's memory
    was allocated on its own stream; it stays reserved until the caller's
    stream has read it."""
    out = []
    for p in parts:
        if p.device.type == "cuda":
            p.record_stream(torch.cuda.current_stream(p.device))
        out.append(p.to(dev))
    return out


def _concat(parts, dev: torch.device) -> torch.Tensor:
    parts = _collect(parts, dev)
    return parts[0] if len(parts) == 1 else torch.cat(parts)


# -- verification --------------------------------------------------------


def _verify_block(kernel, dev, pubs, msgs, sigs) -> torch.Tensor:
    """One shard's rows staged onto ``dev`` and verified there (``kernel``
    None: ``ed25519.verify_kernel``, looked up at the call)."""
    return (kernel or verify_kernel)(*(_stage(a, dev, torch.uint8) for a in (pubs, msgs, sigs)))


def sharded_verify(mesh: Mesh, kernel=None):
    """(B,32),(B,32),(B,64) uint8 (host arrays, or per-shard lists from
    :func:`batch_sharding`) -> (B,) bool on the mesh's first device, B rows
    of this process split into equal shards. ``kernel`` replaces
    ``ed25519.verify_kernel`` (tests pass a cheap stand-in)."""
    devices = mesh.devices
    shard = functools.partial(_verify_block, kernel)

    def verify(pubs, msgs, sigs):
        blocks = list(zip(*(_blocks(a, len(devices)) for a in (pubs, msgs, sigs))))
        return _concat(_run_shards(devices, shard, blocks), devices[0])

    return verify


def batch_sharding(mesh: Mesh):
    """The staging step of a window: a host array -> the list of its row
    blocks on the mesh's devices, copied before it returns (the shards read
    them on streams of their own)."""

    def stage(x):
        blocks = _blocks(x, len(mesh.devices))
        return [_stage(b, dev, non_blocking=False) for b, dev in zip(blocks, mesh.devices)]

    return stage


def compile_sharded(mesh: Mesh, size: int, kernel=None):
    """The sharded verifier for windows of ``size`` rows (over all
    processes), warmed: the kernels are built or loaded, and every shard
    runs once on an all-pad window, which must verify True. Nothing is
    serialized; the build directory is the only cache."""
    from ..crypto import kernels
    from ..crypto.batch import pad_batch

    if size % mesh.size:
        raise ValueError(f"window {size} not divisible by mesh size {mesh.size}")
    if kernel is None and any(d.type == "cuda" for d in mesh.devices):
        kernels.build()
    fn = sharded_verify(mesh, kernel=kernel)
    pubs, msgs, sigs, _ = pad_batch([], size // mesh.size * len(mesh.devices))
    out = fn(pubs, msgs, sigs)
    if kernel is None and not bool(out.all()):
        raise RuntimeError(f"pad triple rejected at window {size}")
    return fn


# One serving mesh per process, over every local card, built on first use
# under a lock: the verify service's launch threads may race the first call.
_SERVING = None  # (mesh, fn)
_SERVING_LOCK = threading.Lock()


def _serving():
    global _SERVING
    with _SERVING_LOCK:
        if _SERVING is None:
            mesh = make_mesh()
            _SERVING = (mesh, sharded_verify(mesh))
        return _SERVING


def verify_many_sharded(items, pad_to: Optional[int] = None, device=None) -> list:
    """``batch.verify_many`` with its window sharded: list of (pub32, msg32,
    sig64) byte triples -> list[bool]. ``device=None`` shards over every
    local card (one cached mesh); a device, or a list of devices, gives the
    shards. The padded size, an explicit ``pad_to`` included, is rounded up
    to a multiple of the mesh size."""
    from ..crypto import batch as _batch

    if not items:
        return []
    if device is None:
        mesh, fn = _serving()
    else:
        mesh = make_mesh(devices=list(device) if isinstance(device, (list, tuple)) else [device])
        fn = sharded_verify(mesh)
    return _batch.verify_many(items, pad_to=pad_to, launch=fn, size_multiple=mesh.size)


def verify_many_auto(items, pad_to: Optional[int] = None, device=None) -> list:
    """The serving path's one choice: sharded over the local cards when
    ``device`` is None and there are several, else ``batch.verify_many`` on
    ``device`` (``None`` = the card; raises without CUDA)."""
    if device is None and torch.cuda.device_count() > 1:
        return verify_many_sharded(items, pad_to=pad_to)
    from ..crypto import batch as _batch

    return _batch.verify_many(items, pad_to=pad_to, device=device)


# -- quorums ---------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QuorumResult:
    """One certification: ``valid`` covers this process's rows; ``counts``
    and ``certified`` are equal on every process of the mesh."""

    valid: torch.Tensor  # (B,) bool
    counts: torch.Tensor  # (R,) int32 valid signatures per round
    certified: torch.Tensor  # (R,) bool, counts >= thresholds


def _all_reduce(counts: torch.Tensor, group) -> torch.Tensor:
    """Sum the (R,) counts over the group (gloo reduces on the host)."""
    if group is None:
        return counts
    import torch.distributed as dist

    buf = counts.cpu() if dist.get_backend(group) == "gloo" else counts
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(counts.device)


def quorum_certify(mesh: Mesh, num_rounds: int):
    """(pubs (B,32), msgs (B,32), sigs (B,64), round_ids (B,), thresholds
    (R,)) -> :class:`QuorumResult`. Row i counts for round round_ids[i],
    clipped to [0, R]; round R (the pad rows) is dropped. Each shard
    verifies and counts its rows; the counts are summed over the local
    shards and all-reduced over the mesh's group."""
    R = num_rounds
    devices = mesh.devices

    def shard(dev, pubs, msgs, sigs, round_ids):
        ok = _verify_block(None, dev, pubs, msgs, sigs)
        rid = _stage(round_ids, dev, torch.int32).clamp(0, R).long()
        counts = torch.zeros(R + 1, dtype=torch.int32, device=dev)
        counts.scatter_add_(0, rid, ok.to(torch.int32))
        return ok, counts[:R]

    def certify(pubs, msgs, sigs, round_ids, thresholds):
        k = len(devices)
        blocks = list(zip(*(_blocks(a, k) for a in (pubs, msgs, sigs, round_ids))))
        results = _run_shards(devices, shard, blocks)
        dev = devices[0]
        valid = _concat([ok for ok, _ in results], dev)
        counts = torch.stack(_collect([c for _, c in results], dev)).sum(0, dtype=torch.int32)
        counts = _all_reduce(counts, mesh.group)
        thresholds = _stage(thresholds, dev, torch.int32, non_blocking=False)
        return QuorumResult(valid=valid, counts=counts, certified=counts >= thresholds)

    return certify


def round_step(mesh: Mesh, num_rounds: int):
    """(state (8,) int32, pubs, msgs, sigs, round_ids, thresholds) ->
    (new_state, QuorumResult): certify every round of the window, then fold
    the certified rounds' counts into the state digest exactly as the JAX
    step does: cumsum of [state ‖ where(certified, counts, 0)] in int32
    (wrapping), the last 8 entries, mod 2^31 - 1 (floored)."""
    certify = quorum_certify(mesh, num_rounds)

    def step(state, pubs, msgs, sigs, round_ids, thresholds):
        res = certify(pubs, msgs, sigs, round_ids, thresholds)
        state = _stage(state, res.counts.device, torch.int32, non_blocking=False)
        contrib = torch.where(res.certified, res.counts, torch.zeros_like(res.counts))
        # torch.cumsum of int32 returns int64; the exact sum, taken back into
        # int32's two's-complement range, is the wrapped int32 running sum.
        run = torch.cumsum(torch.cat([state, contrib]).to(torch.int64), 0)
        run = (run + 2**31) % 2**32 - 2**31
        new_state = torch.remainder(run[-state.shape[0] :], _STATE_MOD).to(torch.int32)
        return new_state, res

    return step
