"""The port's verify service: the 128-byte-triple coalescing server
(``service``) and the card-owning daemon with its engine and CLI
(``verify_service``). Wire-compatible with ``core/verifier.cc``
RemoteVerifier and with the JAX package's client."""
