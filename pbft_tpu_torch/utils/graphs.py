"""The compile step of the port: each fixed window shape is captured once
into a CUDA graph and replayed per window.

The JAX package compiles every verify entry point, and XLA turns a whole
window (SHA-512, mod L, decompression, the three Pallas kernels,
compression) into one executable:

- ``pbft_tpu/crypto/batch.py`` ``_verify_jit`` (``jax.jit``, traced once per
  shape);
- ``pbft_tpu/parallel/verifier.py`` ``sharded_verify`` (``jax.jit``) and
  ``compile_sharded`` (``jax.jit(...).lower(...).compile()``, ahead of the
  first traffic);
- ``pbft_tpu/parallel/verifier.py`` ``quorum_certify`` and ``round_step``
  (``@jax.jit``);
- ``pbft_tpu/net/verify_service.py`` ``ShardedVerifyEngine``: one
  AOT-compiled executable per window shape, none compiled while serving.

PyTorch runs op by op, so the same window issues each of its ~21.5k kernels
from the host. Here a ``torch.cuda.CUDAGraph`` of the window takes the
executable's place:

- :class:`CapturedWindow`: a function of fixed-shape inputs, with static
  device inputs, pinned host staging buffers for its inputs and outputs, a
  CUDA stream of its own and an event that marks when the last replay has
  consumed the host buffers. The graph holds the host-to-device copies, the
  function and the device-to-host copies of its outputs; a window stages,
  replays once, synchronizes its stream and hands back copies of the
  outputs. On the CPU "capture" keeps the function and "replay" calls it on
  the static buffers, so the buffer and slot logic runs in the CPU tests.
- :class:`SlotPool`: the captured windows (or per-shard tuples of windows)
  of one shape, one per slot. Windows of one shape that run at the same
  time never share buffers, nor a graph memory pool.
- :func:`cached_pool`: the process's cache of shapes captured at first use,
  the counterpart of ``jax.jit``'s cache.

Nothing falls back: a capture or a replay that fails raises. Captures run
one at a time in the process (under a lock), each in the ``thread_local``
capture mode, so another thread's CUDA work cannot break it.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

_CAPTURE_LOCK = threading.Lock()


def _tuple(out) -> tuple:
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


class CapturedWindow:
    """``fn(*inputs)`` over fixed-shape inputs, captured once on ``device``.

    ``specs`` holds one ``(shape, dtype)`` per input; ``fn`` returns a tensor
    or a tuple of tensors on ``device``. ``capture()`` runs ``fn`` once
    eagerly on the window's stream (kernel build and per-device constants
    fill outside the capture), then captures the copies in, ``fn`` and the
    copies out. ``run(*inputs)`` takes host arrays or tensors of exactly the
    specs' shapes and returns the outputs as host tensors of their own."""

    def __init__(self, fn: Callable, specs: Sequence[tuple], device):
        self.device = torch.device(device)
        self._fn = fn
        self._cuda = self.device.type == "cuda"
        self._host_in = [torch.zeros(tuple(s), dtype=d, pin_memory=self._cuda) for s, d in specs]
        self._dev_in = (
            [torch.zeros(tuple(s), dtype=d, device=self.device) for s, d in specs]
            if self._cuda else self._host_in
        )
        self._host_out: Optional[list] = None
        self._graph = None
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._consumed = torch.cuda.Event() if self._cuda else None
        self.launches: dict = {}  # kernel launches one replay makes
        self.prime_s = 0.0  # the eager priming run
        self.capture_s = 0.0  # the capture and the graph's instantiation

    def capture(self) -> "CapturedWindow":
        if not self._cuda:
            self._graph = self._fn
            return self
        from ..crypto import kernels

        graph = torch.cuda.CUDAGraph()
        with _CAPTURE_LOCK, torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            t0 = time.perf_counter()
            for d, h in zip(self._dev_in, self._host_in):
                d.copy_(h)
            self._host_out = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                              for o in _tuple(self._fn(*self._dev_in))]
            self._stream.synchronize()
            t1 = time.perf_counter()
            with kernels.recording() as launches, torch.cuda.graph(
                graph, stream=self._stream, capture_error_mode="thread_local"
            ):
                for d, h in zip(self._dev_in, self._host_in):
                    d.copy_(h, non_blocking=True)
                outs = _tuple(self._fn(*self._dev_in))
                if len(outs) != len(self._host_out):
                    raise RuntimeError("the captured function changed its outputs")
                for h, o in zip(self._host_out, outs):
                    h.copy_(o, non_blocking=True)
        self._graph = graph
        self.launches = launches
        self.prime_s, self.capture_s = t1 - t0, time.perf_counter() - t1
        return self

    def launch(self, *inputs) -> None:
        """Stage the inputs and start the window (on the card: replay the
        graph on the window's stream, without waiting for it)."""
        if self._graph is None:
            raise RuntimeError("window not captured")
        if len(inputs) != len(self._host_in):
            raise ValueError(f"{len(inputs)} inputs for a window of {len(self._host_in)}")
        xs = [_as_tensor(x) for x in inputs]
        for h, x in zip(self._host_in, xs):
            if tuple(x.shape) != tuple(h.shape):
                raise ValueError(f"input of shape {tuple(x.shape)} for a window of {tuple(h.shape)}")
        if self._cuda:
            self._consumed.synchronize()  # the last replay has read the host buffers
        for h, x in zip(self._host_in, xs):
            h.copy_(x)
        if not self._cuda:
            outs = _tuple(self._graph(*self._host_in))
            if self._host_out is None:
                self._host_out = [torch.empty_like(o) for o in outs]
            for h, o in zip(self._host_out, outs):
                h.copy_(o)
            return
        from ..crypto import kernels

        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            self._graph.replay()
            self._consumed.record(self._stream)
        kernels.add_launches(self.launches)

    def finish(self) -> tuple:
        """Wait for the window; its outputs, copied out of the static buffers."""
        if self._cuda:
            self._stream.synchronize()
        return tuple(h.clone() for h in self._host_out)

    def run(self, *inputs) -> tuple:
        self.launch(*inputs)
        return self.finish()


def capture_shards(fn: Callable, specs: Sequence[tuple], devices: Sequence) -> tuple:
    """One captured window of ``fn`` over ``specs`` per shard device,
    captured one after another."""
    return tuple(CapturedWindow(fn, specs, dev).capture() for dev in devices)


def run_shards(windows: Sequence[CapturedWindow], blocks: Sequence[Sequence]) -> list:
    """Every shard's window started (the card shards run at once, each on
    its own stream), then each one's outputs in shard order."""
    for w, blk in zip(windows, blocks):
        w.launch(*blk)
    return [w.finish() for w in windows]


class SlotPool:
    """The captured windows of one shape, one per slot. ``slot()`` hands a
    caller a window no other caller holds, and takes it back after. With a
    ``limit`` a caller waits for a free slot once that many are captured
    (``fill`` captures them ahead of traffic); without one, a caller that
    finds no free slot captures another."""

    def __init__(self, capture: Callable, limit: Optional[int] = None):
        self._capture = capture
        self._limit = limit
        self._free: list = []
        self.size = 0  # slots captured or being captured
        self._cond = threading.Condition()

    def _new(self):
        try:
            return self._capture()
        except BaseException:
            with self._cond:
                self.size -= 1
                self._cond.notify()
            raise

    def fill(self, n: int) -> None:
        """Capture slots until there are ``n``."""
        while True:
            with self._cond:
                if self.size >= n:
                    return
                self.size += 1
            w = self._new()
            with self._cond:
                self._free.append(w)
                self._cond.notify()

    @contextlib.contextmanager
    def slot(self):
        with self._cond:
            while not self._free and self._limit is not None and self.size >= self._limit:
                self._cond.wait()
            w = self._free.pop() if self._free else None
            if w is None:
                self.size += 1
        if w is None:
            w = self._new()
        try:
            yield w
        finally:
            with self._cond:
                self._free.append(w)
                self._cond.notify()


_POOLS: dict = {}
_POOLS_LOCK = threading.Lock()


def cached_pool(key, capture: Callable) -> SlotPool:
    """The process's slot pool for ``key`` (a caller's tag, its devices and
    its shape), made at the key's first use; its windows are captured as
    callers need them."""
    with _POOLS_LOCK:
        pool = _POOLS.get(key)
        if pool is None:
            pool = _POOLS[key] = SlotPool(capture)
        return pool
