"""pbft_tpu_torch: the PyTorch/CUDA port of pbft_tpu's device layer.

The port runs batched Ed25519 verification, per-round quorum counting over
the local cards and processes, and the verify service that owns the
accelerator, on NVIDIA H100s. Every long multiply chain that the JAX
package ran as a Pallas kernel is a CUDA C++ kernel written for sm_90a
(``crypto/csrc/``); everything around the kernels is plain PyTorch.

Rules: the port imports nothing of JAX and nothing of ``pbft_tpu`` (it keeps
its own copies of what it needs); every entry point takes an explicit
``device`` and runs on the card unless the caller asks for the CPU
(``device.resolve_device``). Importing this package imports nothing heavy.

Modules, each named after its JAX counterpart:

- ``crypto.ref``      RFC 8032 oracle and signer (hashlib only)
- ``crypto.field``    GF(2^255-19) and mod-L limb arithmetic
- ``crypto.sha512``   SHA-512 on int64-held 32-bit halves
- ``crypto.kernels``  the three kernel wrappers, plain versions, counters
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
- ``utils.metrics``, ``utils.trace_schema``  the service's metrics registry,
  scrape server and manifest
- ``utils.graphs``    the compile step: each window shape captured once into
  a CUDA graph and replayed (no JAX counterpart file: ``jax.jit`` does it)
- ``entry``           ``entry()`` and ``dryrun_multichip(n)``
- ``consensus``       the Python replica core: every message type and its
  codecs, ``network.json``, the write-ahead log, ``Replica``, the in-memory
  ``simulation.Cluster`` (verifier ``cpu`` or ``cuda``), the invariant
  checker and seeded fault schedules, byte-identical to the JAX package's
- ``net.launcher``, ``net.client``  a localhost ``pbftd`` cluster and the
  PBFT client (f + 1 signed replies)
- ``utils.waterfall`` the per-request latency join of client and replica
  traces
- ``bench.harness``   BASELINE's configs 0-4 in the in-memory simulation
  (arms ``cpu`` and ``cuda``) and as ``pbftd`` clusters, on their own verify
  pools (``native``) or on the card's daemon (``native-cuda``)
"""
