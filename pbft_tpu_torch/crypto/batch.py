"""The batched verifier: the port of ``pbft_tpu/crypto/batch.py``.

``verify_batch(pubs, msgs, sigs, device=None)`` verifies B independent
Ed25519 signatures in one pass of ``ed25519.verify_kernel`` on the card (or
on the CPU when asked), launching each of the four CUDA kernels once. On
the card the pass is a CUDA graph captured at the first batch of each shape
(as ``jax.jit`` traces once per shape; ``utils/graphs.py``) and replayed
through static buffers after. ``verify_many`` pads a list of byte triples to
the pad ladder with a known-good self-signed triple (pad slots never fail a
batch) and slices the verdicts back.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import resolve_device
from ..utils import graphs
from . import ref
from .ed25519 import verify_kernel

# One known-valid (pub, msg, sig) triple for padding slots (the JAX
# package's triple, derived from the same seed and message).
_PAD_SEED = bytes(range(32))
_PAD_MSG = b"pbft_tpu batch padding.........."
assert len(_PAD_MSG) == 32
_PAD_PUB = np.frombuffer(ref.public_key(_PAD_SEED), np.uint8)
_PAD_SIG = np.frombuffer(ref.sign(_PAD_SEED, _PAD_MSG), np.uint8)
_PAD_MSG_ARR = np.frombuffer(_PAD_MSG, np.uint8)
# The pad triple as bytes: a window of it alone verifies True.
PAD_ITEM = (_PAD_PUB.tobytes(), _PAD_MSG, _PAD_SIG.tobytes())


def _verify(pubs, msgs, sigs):
    return verify_kernel(pubs, msgs, sigs)  # looked up at each call (or capture)


def _capture(dev: torch.device, rows: int):
    specs = [((rows, w), torch.uint8) for w in (32, 32, 64)]
    return graphs.CapturedWindow(_verify, specs, dev).capture()


def verify_batch(pubs, msgs, sigs, device=None) -> torch.Tensor:
    """(B,32),(B,32),(B,64) uint8 arrays or tensors -> (B,) bool tensor on
    the device the batch ran on. The batch runs in a window captured for
    (device, B) at its first use and held in a slot of its own while it
    runs."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    rows = len(pubs)
    pool = graphs.cached_pool(("batch", dev, rows), lambda: _capture(dev, rows))
    with pool.slot() as window:
        return window.run(pubs, msgs, sigs)[0].to(dev)


def pad_batch(items, size: int):
    """items: list of (pub32, msg32, sig64) bytes -> padded uint8 arrays.

    Returns (pubs, msgs, sigs, n) where slots >= n are the known-good pad
    triple (they verify True and are sliced off by the caller). Raises
    ValueError on an item of other lengths, as the reference's row by row
    assignment does: the rows are cut out of one joined buffer, so a short
    field would otherwise shift its neighbours' bytes into its row.
    """
    n = len(items)
    if n > size:
        raise ValueError(f"batch of {n} exceeds padded size {size}")
    for i, (pub, msg, sig) in enumerate(items):
        if len(pub) != 32 or len(msg) != 32 or len(sig) != 64:
            raise ValueError(f"item {i} is not a (pub32, msg32, sig64) triple: {len(pub)}, {len(msg)}, {len(sig)} bytes")
    pubs = np.tile(_PAD_PUB, (size, 1))
    msgs = np.tile(_PAD_MSG_ARR, (size, 1))
    sigs = np.tile(_PAD_SIG, (size, 1))
    if n:
        for arr, k, width in ((pubs, 0, 32), (msgs, 1, 32), (sigs, 2, 64)):
            arr[:n] = np.frombuffer(b"".join(it[k] for it in items), np.uint8).reshape(n, width)
    return pubs, msgs, sigs, n


# Padded sizes come from a short ladder (the JAX package's), so the service
# warms a bounded set of window shapes.
_PAD_LADDER = (16, 64, 256, 1024, 4096)


def pad_size(n: int) -> int:
    for size in _PAD_LADDER:
        if n <= size:
            return size
    return ((n + _PAD_LADDER[-1] - 1) // _PAD_LADDER[-1]) * _PAD_LADDER[-1]


def verify_many(
    items,
    pad_to: int | None = None,
    launch=None,
    size_multiple: int = 1,
    device=None,
) -> list[bool]:
    """List of (pub, msg, sig) byte triples -> bools.

    ``launch`` overrides the verify call (pubs, msgs, sigs uint8 arrays ->
    verdicts); ``size_multiple`` rounds the padded size up to a multiple.
    ``device`` picks where the default launch runs (``None`` = the card).
    """
    if not items:
        return []
    size = pad_to or pad_size(len(items))
    if size % size_multiple:
        size = ((size + size_multiple - 1) // size_multiple) * size_multiple
    pubs, msgs, sigs, n = pad_batch(items, size)
    out = (launch or functools.partial(verify_batch, device=device))(pubs, msgs, sigs)
    if isinstance(out, torch.Tensor):
        out = out.cpu().numpy()
    return [bool(v) for v in np.asarray(out)[:n]]
