"""The port's entry points (pbft_tpu_torch.entry) on the CPU: ``entry()``
stages the same 16 signed triples as the JAX package's ``__graft_entry__``
and they verify; ``dryrun_multichip`` runs one round step over 2 CPU
shards; both raise without CUDA when no device is named."""

import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from pbft_tpu_torch.entry import dryrun_multichip, entry


def test_entry_stages_the_jax_example_and_it_verifies():
    fn, args = entry(device="cpu")
    _, jax_args = jax_entry.entry()
    assert all(np.array_equal(a.numpy(), np.asarray(b)) for a, b in zip(args, jax_args))
    assert [tuple(a.shape) for a in args] == [(16, 32), (16, 32), (16, 64)]
    assert fn(*args).tolist() == [True] * 16


def test_dryrun_multichip_on_two_cpu_shards():
    state, res = dryrun_multichip(2, device="cpu")
    assert res.counts.tolist() == [1, 1, 1, 1] and res.certified.all()
    assert res.valid.tolist() == [True] * 4
    assert state.dtype == torch.int32 and state.tolist() == [0, 0, 0, 0, 1, 2, 3, 4]


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    for call in (entry, lambda: dryrun_multichip(2)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
