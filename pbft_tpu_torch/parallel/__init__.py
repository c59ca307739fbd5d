"""pbft_tpu_torch.parallel: a verify window sharded over the local cards, and
per-round quorum counts reduced over the shards and, on ``torch.distributed``,
over processes. The port of ``pbft_tpu.parallel``; the same names."""

from .verifier import (
    QuorumResult,
    batch_sharding,
    compile_sharded,
    make_mesh,
    sharded_verify,
    verify_many_auto,
    verify_many_sharded,
    quorum_certify,
    round_step,
)
from .multihost import (
    global_mesh,
    host_shard_to_global,
    initialize_distributed,
    partition_items,
)

__all__ = [
    "QuorumResult",
    "batch_sharding",
    "compile_sharded",
    "make_mesh",
    "sharded_verify",
    "verify_many_auto",
    "verify_many_sharded",
    "quorum_certify",
    "round_step",
    "global_mesh",
    "host_shard_to_global",
    "initialize_distributed",
    "partition_items",
]
