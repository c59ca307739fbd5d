"""The port's host-side runtime around the card.

- ``server``    the asyncio replica runtime (``AsyncReplicaServer``): its
  batches verified on the card in-process (``--verifier cuda``), on the
  host, or on a verify service.
- ``service``   the 128-byte-triple coalescing server (backends ``cuda``,
  ``native`` and ``cpu``; ``/metrics``), wire-compatible with
  ``core/verifier.cc`` RemoteVerifier and with the JAX package's client.
- ``verify_service``  the card-owning daemon with its engine
  (``CudaVerifyEngine``), its CLI and the replica-side ``ServiceVerifier``.
- ``secure``    encrypted replica links and protocol versioning.
- ``discovery`` UDP-multicast peer discovery.
- ``client``    the PBFT client (f + 1 signed replies).
- ``gateway``   the client-gateway tier.
- ``launcher``  a localhost cluster of ``pbftd`` and asyncio replicas.

Importing this package imports neither torch nor numpy.
"""

from .client import PbftClient
from .launcher import LocalCluster, pbftd_path
from .secure import PROTOCOL_VERSION, SecureChannel
from .service import VerifierService, native_backend
from .verify_service import (
    CudaVerifyEngine,
    ServiceVerifier,
    VerifyServiceDaemon,
    probe_status,
    probe_status_json,
)

__all__ = [
    "CudaVerifyEngine",
    "LocalCluster",
    "PROTOCOL_VERSION",
    "PbftClient",
    "SecureChannel",
    "ServiceVerifier",
    "VerifierService",
    "VerifyServiceDaemon",
    "native_backend",
    "pbftd_path",
    "probe_status",
    "probe_status_json",
]
