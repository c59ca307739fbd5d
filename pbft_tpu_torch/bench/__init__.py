"""The port's benchmarks, two entries:

- ``verify_bench`` (``python -m pbft_tpu_torch.bench``): the counterpart of
  the root ``bench.py``, Ed25519 verifies per second on the card (in
  process, or through the verify service) and on the host's native pool,
  and the f = 1 firehose on ``pbftd``; one JSON line.
- ``harness`` (``python -m pbft_tpu_torch.bench.harness``): BASELINE's
  cluster configurations driven as ``pbftd`` clusters, on their own verify
  pools or through the port's verify service on the card, and in the
  in-memory simulation."""
