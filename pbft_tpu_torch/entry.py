"""Two small entry points that compile and run the port's device path: the
port of ``__graft_entry__.py``.

- ``entry()``: one verify window of 16 signed triples on the card.
- ``dryrun_multichip(n)``: one round step (verification sharded over n
  shards, per-round counts, the state fold) at B = 2n signatures and R = 4
  rounds.
"""

from __future__ import annotations

import numpy as np
import torch

from .crypto import ref
from .crypto.batch import pad_batch
from .device import resolve_device


def _signed(count: int, msg_tag: int):
    """count valid (pub, msg, sig) triples: seed bytes([i+1])*32, message
    bytes([msg_tag ^ i])*32."""
    items = []
    for i in range(count):
        seed = bytes([i + 1]) * 32
        msg = bytes([msg_tag ^ i]) * 32
        items.append((ref.public_key(seed), msg, ref.sign(seed, msg)))
    return items


def entry(device=None):
    """(fn, example_args): fn(pubs (16,32), msgs (16,32), sigs (16,64)) uint8
    tensors -> (16,) bool is ``ed25519.verify_kernel`` (SHA-512 challenge,
    decompression, the Shamir ladder; the four CUDA kernels on a card), and
    the example is 16 valid triples staged on ``device`` (None = the card)."""
    from .crypto.ed25519 import verify_kernel

    dev = resolve_device(device)
    pubs, msgs, sigs, _ = pad_batch(_signed(16, 0x5A), 16)
    return verify_kernel, tuple(torch.from_numpy(a).to(dev) for a in (pubs, msgs, sigs))


def dryrun_multichip(n_devices: int, device=None):
    """One ``parallel.round_step`` over n shards: the first n local cards
    when ``device`` is None (raises when there are fewer), else n shards on
    ``device``. B = 2n valid signatures over R = 4 rounds, each round's
    threshold max(1, B // R - 1), from a zero state. Raises AssertionError
    unless every signature counts and every round certifies; returns
    (new_state, QuorumResult)."""
    from .parallel import make_mesh, round_step

    if device is None:
        mesh = make_mesh(n_devices)
    else:
        mesh = make_mesh(devices=[device] * n_devices)
    R, B = 4, 2 * n_devices
    pubs, msgs, sigs, _ = pad_batch(_signed(B, 0xC3), B)
    round_ids = np.arange(B) % R
    thresholds = np.full(R, max(1, B // R - 1), np.int32)
    new_state, res = round_step(mesh, R)(np.zeros(8, np.int32), pubs, msgs, sigs, round_ids, thresholds)
    counts = res.counts.cpu()
    if int(counts.sum()) != B:
        raise AssertionError(f"expected {B} valid signatures, got {counts.tolist()}")
    if not bool(res.certified.all()):
        raise AssertionError(f"all rounds should certify: {res.certified.tolist()}")
    return new_state, res
