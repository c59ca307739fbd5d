"""pbft_tpu_torch: the PyTorch/CUDA port of pbft_tpu.

The port runs batched Ed25519 verification, per-round quorum counting over
the local cards and processes, the verify service that owns the
accelerator, and the asyncio replica runtime whose replicas verify on the
card in their own process, on NVIDIA H100s. Every long multiply chain that the JAX
package ran as a Pallas kernel is a CUDA C++ kernel written for sm_90a
(``crypto/csrc/``); everything around the kernels is plain PyTorch.

Rules: the port imports nothing of JAX and nothing of ``pbft_tpu`` (it keeps
its own copies of what it needs); every entry point takes an explicit
``device`` and runs on the card unless the caller asks for the CPU
(``device.resolve_device``). Importing this package imports nothing heavy.

Modules, each named after its JAX counterpart:

- ``crypto.ref``      RFC 8032 oracle and signer (hashlib only)
- ``crypto.field``    GF(2^255-19) and mod-L limb arithmetic
- ``crypto.sha512``   SHA-512: a CUDA kernel on a card, int64-held 32-bit
  halves in plain torch on the CPU
- ``crypto.kernels``  the four kernel wrappers, plain versions, counters
- ``crypto.ed25519``  decompress / Shamir ladder / compress / verify_kernel
- ``crypto.batch``    pad ladder and ``verify_many``
- ``parallel.verifier``  a window sharded over the local cards, per-round
  quorum certification, the round step
- ``parallel.multihost``  processes on ``torch.distributed``
- ``net.service``     the 128-byte-triple coalescing server (backends
  ``cuda``, ``native`` and ``cpu``; ``/metrics``)
- ``net.verify_service``  ``CudaVerifyEngine`` over a mesh of cards, the
  daemon, the CLI, the replica-side ``ServiceVerifier``
- ``native``          the C++ core's verify pool (``ctypes``), built with
  ``g++`` into ``build-core/``; ``host_batch_verify``, the host's verifier;
  the core's single-signature ``sign`` and ``verify``
- ``utils.metrics``, ``utils.trace_schema``, ``utils.flight``, ``utils.trace``
  the metrics registry, consensus-phase spans, scrape server and health
  readers; the whole schema manifest; the black-box flight recorder; JSONL
  tracing
- ``utils.graphs``    the compile step: each window shape captured once into
  a CUDA graph and replayed (no JAX counterpart file: ``jax.jit`` does it)
- ``entry``           ``entry()`` and ``dryrun_multichip(n)``
- ``consensus``       the Python replica core: every message type and its
  codecs, ``network.json``, the write-ahead log, ``Replica``, the in-memory
  ``simulation.Cluster`` (verifier ``cpu`` or ``cuda``), the invariant
  checker and seeded fault schedules, byte-identical to the JAX package's
- ``net.server``      the asyncio replica runtime (``AsyncReplicaServer``,
  ``python -m pbft_tpu_torch.net.server``): verifier ``cuda`` (the default:
  the card, in-process), ``cpu``, a verify service's address, or a callable
- ``net.secure``, ``net.discovery``, ``net.gateway``  encrypted replica links
  and protocol versions, multicast peer discovery, the client-gateway tier
- ``net.launcher``, ``net.client``  a localhost cluster of ``pbftd``, asyncio
  replica processes and replicas on threads of the caller, and the PBFT
  client (f + 1 signed replies)
- ``utils.waterfall`` the per-request latency join of client and replica
  traces
- ``bench.harness``   BASELINE's configs 0-4 in the in-memory simulation
  (arms ``cpu`` and ``cuda``) and as clusters of ``pbftd`` or asyncio
  replicas (``impl``), on their own verify pools (``native``), on the
  card's daemon (``native-cuda``) or, for asyncio replicas, on the card in
  each replica's process
"""
