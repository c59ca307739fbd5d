"""Verification over several processes on ``torch.distributed``: the port of
``pbft_tpu/parallel/multihost.py``.

Consensus traffic stays on the host network; what spreads over processes is
the verification of a window. Each process verifies its own rows on its own
devices, and ``quorum_certify`` all-reduces the per-round counts over the
group, so every process reads the same ``counts`` and ``certified``.

Usage (one process per host, or per card)::

    initialize_distributed("10.0.0.1:29400", num_processes=N, process_id=k)
    mesh = global_mesh()                          # this process's cards
    rows = partition_items(range(B))              # rows k, k+N, ...
    certify = quorum_certify(mesh, num_rounds=R)
    res = certify(*(host_shard_to_global(mesh, a[rows]) for a in (pubs, msgs, sigs, round_ids)),
                  thresholds)                     # res.certified: equal on every process

A single process needs no initialization and runs the same code.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import torch

from .verifier import Mesh, batch_sharding, make_mesh


def _group():
    """The default group when this process is one of several, else None."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return dist.group.WORLD
    return None


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """``torch.distributed.init_process_group`` over a ``tcp://`` rendezvous,
    from explicit arguments or torchrun's environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).

    Does nothing when a group already exists, or for a single process with
    neither arguments nor ``MASTER_ADDR`` / ``WORLD_SIZE`` > 1 in the
    environment. ``backend`` defaults to NCCL when every process of this
    host can own a card of its own (``LOCAL_WORLD_SIZE``, else the world
    size, at most the local card count), else gloo; NCCL refuses two
    processes on one card."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    env = os.environ
    env_discovery = bool(env.get("MASTER_ADDR")) or int(env.get("WORLD_SIZE") or 1) > 1
    if num_processes in (None, 1) and coordinator_address is None and not env_discovery:
        return
    if coordinator_address is None:
        if not env.get("MASTER_ADDR"):
            raise ValueError("no coordinator address: pass one or set MASTER_ADDR and MASTER_PORT")
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    world = int(num_processes if num_processes is not None else env.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    if backend is None:
        local = int(env.get("LOCAL_WORLD_SIZE") or world)
        backend = "nccl" if torch.cuda.is_available() and torch.cuda.device_count() >= local else "gloo"
    init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank)


def global_mesh(devices=None) -> Mesh:
    """This process's shards (``devices=None``: every local card) joined to
    the default group when there are several processes."""
    return dataclasses.replace(make_mesh(devices=devices), group=_group())


def host_shard_to_global(mesh: Mesh, local):
    """This process's rows, staged as the mesh's per-shard blocks on its
    devices. There is no global array: each process keeps its own rows, in
    process order, and ``quorum_certify`` reduces only the counts. With one
    process this is the staging of the whole window."""
    return batch_sharding(mesh)(local)


def partition_items(items: Sequence, process_id: Optional[int] = None, num: Optional[int] = None):
    """The round-robin split of a window over processes: process k takes
    items k, k + N, k + 2N, ... Every process computes the same split from
    the same window; rank and world size come from the group (0 and 1
    without one)."""
    import torch.distributed as dist

    grouped = _group() is not None
    if process_id is None:
        process_id = dist.get_rank() if grouped else 0
    if num is None:
        num = dist.get_world_size() if grouped else 1
    return list(items[process_id::num])
