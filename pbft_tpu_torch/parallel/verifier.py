"""Verification sharded over the local cards, per-round quorum certification
and the round step: the port of ``pbft_tpu/parallel/verifier.py``.

- A :class:`Mesh` is the ordered list of local devices that a window is cut
  over (one shard each; a device may repeat) and, across processes, the
  ``torch.distributed`` group it spans.
- ``sharded_verify``: a window of B rows splits into equal row blocks, one
  per local shard. Each shard is verified on its device by
  ``ed25519.verify_kernel`` (the four CUDA kernels on a card, their plain
  versions on the CPU) in a window captured once per block shape
  (``utils/graphs.py``: one CUDA graph with the copies in and out, replayed
  per window on a stream of its own; the counterpart of ``jax.jit``). The
  card shards of a window run at once; verdicts are gathered in row order
  on the mesh's first device.
- ``quorum_certify``: each shard's captured window also counts its valid
  rows per round; the shard counts are summed, then all-reduced over the
  mesh's group, so every process reads the same ``counts`` and
  ``certified``. This is the only computation that crosses shards, and it
  stays outside the graphs.
- ``round_step``: certification plus the fold of the certified rounds into
  an (8,) int32 state digest (on the host, outside the graphs).

The semantics are the JAX module's, edge cases included: a round id below 0
counts for round 0 and one of R or more is dropped (``jnp.clip`` to
[0, R], then segment R is sliced off; pad rows carry R), and the fold's
running sum wraps in int32 (``jnp.cumsum``) before its ``% (2**31 - 1)``.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Optional

import numpy as np
import torch

from ..crypto.ed25519 import verify_kernel
from ..device import resolve_device
from ..utils import graphs

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


# -- shards ----------------------------------------------------------------


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


def _stage(x, dev: torch.device) -> torch.Tensor:
    """One block onto its device, copied before it returns. From host
    memory to a card the copy goes through pinned memory."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    if x.device == dev:
        return x
    if dev.type == "cuda" and x.device.type == "cpu":
        x = x.contiguous().pin_memory()
    return x.to(dev)


def _host(x, dtype) -> torch.Tensor:
    """An array or a tensor on any device -> a host tensor of ``dtype``."""
    if isinstance(x, torch.Tensor):
        return x.cpu().to(dtype)
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def _verify_specs(rows: int, *extra) -> list:
    return [((rows, w), torch.uint8) for w in (32, 32, 64)] + list(extra)


def _run(pool_for, devices, arrays) -> list:
    """One window over the mesh: the rows of each array split into one block
    per shard, and a slot of ``pool_for(rows per shard)`` run on the blocks.
    Returns each shard's outputs, in shard order, on the host."""
    blocks = list(zip(*(_blocks(a, len(devices)) for a in arrays)))
    with pool_for(len(blocks[0][0])).slot() as windows:
        return graphs.run_shards(windows, blocks)


def _cached(key, capture, devices):
    """Block shape -> the process's pool for ``key`` on ``devices``, its
    windows captured at first use."""
    return lambda rows: graphs.cached_pool(key + (devices, rows), functools.partial(capture, devices, rows))


# -- verification --------------------------------------------------------


def _verify_block(kernel, pubs, msgs, sigs) -> torch.Tensor:
    """One shard's verify (``kernel`` None: ``ed25519.verify_kernel``,
    looked up at each call, so a capture takes the one in place then)."""
    return (kernel or verify_kernel)(pubs, msgs, sigs)


def _verdicts(pool_for, devices, pubs, msgs, sigs) -> torch.Tensor:
    return torch.cat([out[0] for out in _run(pool_for, devices, (pubs, msgs, sigs))]).to(devices[0])


def _capture_verify(kernel, devices, rows: int) -> tuple:
    fn = functools.partial(_verify_block, kernel)
    return graphs.capture_shards(fn, _verify_specs(rows), devices)


def sharded_verify(mesh: Mesh, kernel=None):
    """(B,32),(B,32),(B,64) uint8 (host arrays, or per-shard lists from
    :func:`batch_sharding`) -> (B,) bool on the mesh's first device, B rows
    of this process split into equal shards. Each shard's block shape is captured at its
    first use (``utils/graphs.py``) and replayed after; the card shards of a
    window run at once, each on its window's stream. ``kernel`` replaces
    ``ed25519.verify_kernel`` (tests pass a cheap stand-in)."""
    pool_for = _cached(("verify", kernel), functools.partial(_capture_verify, kernel), mesh.devices)
    return functools.partial(_verdicts, pool_for, mesh.devices)


def batch_sharding(mesh: Mesh):
    """The staging step of a window: a host array -> the list of its row
    blocks on the mesh's devices, copied before it returns."""

    def stage(x):
        return [_stage(b, dev) for b, dev in zip(_blocks(x, len(mesh.devices)), mesh.devices)]

    return stage


def compile_sharded(mesh: Mesh, size: int, kernel=None, slots: int = 1):
    """The sharded verifier for windows of ``size`` rows (over all
    processes), compiled ahead of traffic: ``slots`` slots, each one captured
    window per shard (``utils/graphs.py``; on the CPU the function is kept),
    with a pool of its own. A caller waits for a free slot when all are in
    use; no shape or slot is captured after this returns. One all-pad window
    runs through it and must verify True. A CUDA graph cannot be
    serialized: the build directory of the kernels is the only cache."""
    from ..crypto import kernels
    from ..crypto.batch import pad_batch

    if size % mesh.size:
        raise ValueError(f"window {size} not divisible by mesh size {mesh.size}")
    if kernel is None and any(d.type == "cuda" for d in mesh.devices):
        kernels.build()
    rows = size // mesh.size
    pool = graphs.SlotPool(functools.partial(_capture_verify, kernel, mesh.devices, rows), limit=slots)
    pool.fill(slots)
    fn = functools.partial(_verdicts, lambda _: pool, mesh.devices)
    out = fn(*pad_batch([], rows * len(mesh.devices))[:3])
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


def _all_reduce(counts: torch.Tensor, group, dev: torch.device) -> torch.Tensor:
    """Sum the (R,) host counts over the group: on the host for gloo, on
    ``dev`` for NCCL."""
    if group is None:
        return counts
    import torch.distributed as dist

    if dist.get_backend(group) == "gloo":
        dist.all_reduce(counts, op=dist.ReduceOp.SUM, group=group)
        return counts
    buf = counts.to(dev)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.cpu()


def _quorum_block(R: int, pubs, msgs, sigs, round_ids):
    """One shard's part of a certification: its verdicts and its valid rows
    counted per round (ids clipped to [0, R], segment R dropped)."""
    ok = verify_kernel(pubs, msgs, sigs)
    counts = torch.zeros(R + 1, dtype=torch.int32, device=ok.device)
    counts.scatter_add_(0, round_ids.clamp(0, R).long(), ok.to(torch.int32))
    return ok, counts[:R]


def _capture_quorum(R: int, devices, rows: int) -> tuple:
    fn = functools.partial(_quorum_block, R)
    return graphs.capture_shards(fn, _verify_specs(rows, ((rows,), torch.int32)), devices)


def _on(res: QuorumResult, dev: torch.device) -> QuorumResult:
    return QuorumResult(*(t.to(dev) for t in (res.valid, res.counts, res.certified)))


def _certify_host(mesh: Mesh, R: int):
    """The certification with its results on the host."""
    devices = mesh.devices
    pool_for = _cached(("quorum", R), functools.partial(_capture_quorum, R), devices)

    def certify(pubs, msgs, sigs, round_ids, thresholds):
        results = _run(pool_for, devices, (pubs, msgs, sigs, round_ids))
        valid = torch.cat([ok for ok, _ in results])
        counts = torch.stack([c for _, c in results]).sum(0, dtype=torch.int32)
        counts = _all_reduce(counts, mesh.group, devices[0])
        return QuorumResult(valid=valid, counts=counts, certified=counts >= _host(thresholds, torch.int32))

    return certify


def quorum_certify(mesh: Mesh, num_rounds: int):
    """(pubs (B,32), msgs (B,32), sigs (B,64), round_ids (B,), thresholds
    (R,)) -> :class:`QuorumResult` on the mesh's first device. Row i counts
    for round round_ids[i], clipped to [0, R]; round R (the pad rows) is
    dropped. Each shard verifies and counts its rows in one captured window
    per (block shape, R), captured at first use; the counts are summed over
    the local shards and all-reduced over the mesh's group outside the
    graphs."""
    certify = _certify_host(mesh, num_rounds)
    return lambda *args: _on(certify(*args), mesh.devices[0])


def round_step(mesh: Mesh, num_rounds: int):
    """(state (8,) int32, pubs, msgs, sigs, round_ids, thresholds) ->
    (new_state, QuorumResult), on the mesh's first device: certify every
    round of the window, then fold the certified rounds' counts into the
    state digest on the host exactly as the JAX step does: cumsum of
    [state ‖ where(certified, counts, 0)] in int32 (wrapping), the last 8
    entries, mod 2^31 - 1 (floored)."""
    certify = _certify_host(mesh, num_rounds)
    dev = mesh.devices[0]

    def step(state, pubs, msgs, sigs, round_ids, thresholds):
        res = certify(pubs, msgs, sigs, round_ids, thresholds)
        state = _host(state, torch.int32)
        contrib = torch.where(res.certified, res.counts, torch.zeros_like(res.counts))
        # torch.cumsum of int32 returns int64; the exact sum, taken back into
        # int32's two's-complement range, is the wrapped int32 running sum.
        run = torch.cumsum(torch.cat([state, contrib]).to(torch.int64), 0)
        run = (run + 2**31) % 2**32 - 2**31
        new_state = torch.remainder(run[-state.shape[0] :], _STATE_MOD).to(torch.int32)
        return new_state.to(dev), _on(res, dev)

    return step
