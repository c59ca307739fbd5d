"""Crypto subsystem of the port: Ed25519 verification on PyTorch tensors,
with the three long multiply chains (inv, pow_p58, the Shamir ladder) and
the challenge hash (SHA-512) as hand-written CUDA kernels (``kernels``,
``csrc/``)."""
