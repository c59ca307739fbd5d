"""The port's verify service: the 128-byte-triple coalescing server
(``service``), the card-owning daemon with its engine, its CLI and the
replica-side client (``verify_service``). Wire-compatible with
``core/verifier.cc`` RemoteVerifier and with the JAX package's client."""

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
    "ServiceVerifier",
    "VerifierService",
    "VerifyServiceDaemon",
    "native_backend",
    "probe_status",
    "probe_status_json",
]
