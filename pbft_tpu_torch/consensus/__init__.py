"""The deterministic PBFT consensus core: the port's copy of
``pbft_tpu/consensus``.

A pure message-in/message-out state machine (no sockets, no threads, no
clocks), so it tests as truth tables and drives identically under the
in-memory simulation (``simulation.Cluster``), the harness's ``cpu`` and
``cuda`` arms and real clusters. Messages, ``network.json`` and the
write-ahead log are byte-identical to the JAX package's and to ``pbftd``'s
(``core/``). Only the verifier differs: a simulation verifies each
replica's pending signatures on the host (``cpu``) or in windows on the
card (``cuda``).
"""

from .messages import (
    ClientRequest,
    ClientReply,
    PrePrepare,
    Prepare,
    Commit,
    Checkpoint,
    ViewChange,
    NewView,
    from_wire,
    to_wire,
)
from .config import ClusterConfig, ReplicaIdentity
from .replica import Replica
from .simulation import Cluster
