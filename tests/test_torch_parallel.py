"""The port's parallel package (pbft_tpu_torch.parallel) against the JAX
package's (pbft_tpu.parallel).

- Parity: one stand-in verdict rule (sig[0] odd) replaces verify_kernel in
  both packages; quorum_certify and round_step then run on the same seeded
  numpy inputs, JAX over conftest's 8 virtual CPU devices and the port over
  a mesh of 8 CPU shards. Round ids run over [-3, R + 3] (below 0 counts for
  round 0, R and above is dropped), thresholds over 0..B, and the state
  starts at [2^31 - 2] * 8 and is stepped several times, so the fold's int32
  wrap is exercised. Tolerance: bit equality of valid, counts, certified and
  the state.
- The real plain verify on a 2-shard CPU mesh (the only plain verify calls
  of the tier-1 cases: one per shard), the size checks, the pad rounding of
  verify_many_sharded, verify_many_auto on the CPU, no fallback without
  CUDA, and the single-process multihost helpers.
- slow: the JAX quorum_certify and round_step with the real verify_kernel
  (a cold jit of the verifier is ~95 s here) against the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pbft_tpu.parallel.verifier as JV
import pbft_tpu_torch.crypto.batch as TB
import pbft_tpu_torch.parallel.verifier as TV
from pbft_tpu_torch.crypto import ref
from pbft_tpu_torch.parallel import (
    batch_sharding,
    compile_sharded,
    global_mesh,
    host_shard_to_global,
    initialize_distributed,
    make_mesh,
    partition_items,
    quorum_certify,
    round_step,
    sharded_verify,
    verify_many_auto,
    verify_many_sharded,
)

_BIG = [2**31 - 2] * 8


def _standin(pubs, msgs, sigs):
    """The stand-in verdict rule, on jax arrays and torch tensors alike."""
    return (sigs[..., 0] & 1) == 1


@pytest.fixture
def standin(monkeypatch):
    monkeypatch.setattr(JV, "verify_kernel", _standin)
    monkeypatch.setattr(TV, "verify_kernel", _standin)


def _window(seed: int, B: int, R: int):
    """Random triples, round ids in [-3, R + 3], and thresholds around each
    round's stand-in count, with 0 and B among them."""
    rng = np.random.default_rng(seed)
    pubs = rng.integers(0, 256, (B, 32), dtype=np.uint8)
    msgs = rng.integers(0, 256, (B, 32), dtype=np.uint8)
    sigs = rng.integers(0, 256, (B, 64), dtype=np.uint8)
    round_ids = rng.integers(-3, R + 4, B).astype(np.int32)
    ok = (sigs[:, 0] & 1) == 1
    count = np.bincount(np.clip(round_ids, 0, R), weights=ok, minlength=R + 1)[:R].astype(np.int32)
    thresholds = np.maximum(count + rng.integers(-1, 2, R), 0).astype(np.int32)
    thresholds[0], thresholds[-1] = 0, B
    return pubs, msgs, sigs, round_ids, thresholds


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(port_res, jax_res):
    for field in ("valid", "counts", "certified"):
        got, want = _np(getattr(port_res, field)), _np(getattr(jax_res, field))
        assert got.dtype == want.dtype and np.array_equal(got, want), (field, got, want)


@pytest.mark.parametrize("seed,B,R", [(1, 64, 4), (2, 64, 13), (3, 128, 2), (4, 128, 40)])
def test_quorum_certify_equals_jax(standin, seed, B, R):
    args = _window(seed, B, R)
    want = JV.quorum_certify(JV.make_mesh(8), R)(*args)
    got = quorum_certify(make_mesh(devices=["cpu"] * 8), R)(*args)
    _assert_same(got, want)
    # The edges are in the case: clipped ids on both sides, both outcomes.
    assert (args[3] < 0).any() and (args[3] > R).any()
    assert _np(want.certified).any() and not _np(want.certified).all()


def test_round_step_equals_jax_through_the_int32_wrap(standin):
    R = 6
    jax_step = JV.round_step(JV.make_mesh(8), R)
    port_step = round_step(make_mesh(devices=["cpu"] * 8), R)
    jax_state = jnp.asarray(_BIG, jnp.int32)
    port_state = np.array(_BIG, np.int32)
    naive_differs = False
    for seed in range(5):
        args = _window(100 + seed, 64, R)
        jax_state, jres = jax_step(jax_state, *args)
        new_state, pres = port_step(port_state, *args)
        _assert_same(pres, jres)
        assert new_state.dtype == torch.int32
        assert np.array_equal(new_state.numpy(), np.asarray(jax_state)), seed
        # A fold in int64 without the wrap gives another digest.
        contrib = np.where(pres.certified.numpy(), pres.counts.numpy(), 0)
        naive = np.cumsum(np.concatenate([port_state, contrib]).astype(np.int64))[-8:] % (2**31 - 1)
        naive_differs |= not np.array_equal(naive, np.asarray(jax_state))
        port_state = new_state.numpy()
    assert naive_differs


def _signed(count: int, bad=()):
    items = []
    for i in range(count):
        seed = bytes([i + 1]) * 32
        msg = bytes([0xA0 ^ i]) * 32
        sig = ref.sign(seed, msg)
        if i in bad:
            sig = sig[:10] + bytes([sig[10] ^ 0xFF]) + sig[11:]
        items.append((ref.public_key(seed), msg, sig))
    return items


def test_real_plain_verify_on_a_two_shard_mesh_equals_the_oracle():
    """16 signed rows over 2 CPU shards, invalid rows at both ends of both
    shards (7 | 8 is the boundary); counts over 4 rounds of 4."""
    bad = {0, 6, 7, 8, 9, 15}
    items = _signed(16, bad)
    pubs, msgs, sigs, _ = TB.pad_batch(items, 16)
    round_ids = np.arange(16) // 4
    res = quorum_certify(make_mesh(devices=["cpu", "cpu"]), 4)(
        pubs, msgs, sigs, round_ids, np.array([3, 2, 3, 2], np.int32)
    )
    want = [ref.verify(*it) for it in items]
    assert want == [i not in bad for i in range(16)]
    assert res.valid.tolist() == want
    assert res.counts.tolist() == [3, 2, 2, 3]
    assert res.certified.tolist() == [True, True, False, True]


def test_sizes_must_split_into_equal_shards():
    mesh = make_mesh(devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="not divisible by mesh size 3"):
        compile_sharded(mesh, 16, kernel=_standin)
    fn = compile_sharded(mesh, 18, kernel=_standin)
    sigs = np.arange(18 * 64, dtype=np.uint8).reshape(18, 64)
    zeros = np.zeros((18, 32), np.uint8)
    assert fn(zeros, zeros, sigs).tolist() == ((sigs[:, 0] & 1) == 1).tolist()
    with pytest.raises(ValueError, match="equal shards"):
        sharded_verify(mesh, kernel=_standin)(zeros[:10], zeros[:10], sigs[:10])


def test_verify_many_sharded_rounds_pad_to_up(standin):
    shard_rows = []

    def recording(pubs, msgs, sigs):
        shard_rows.append(pubs.shape[0])
        return _standin(pubs, msgs, sigs)

    TV.verify_kernel = recording  # restored by the standin fixture
    items = [(bytes(32), bytes(32), bytes([i]) + bytes(63)) for i in range(5)]
    want = [i % 2 == 1 for i in range(5)]
    assert verify_many_sharded(items, pad_to=16, device=["cpu"] * 3) == want
    assert shard_rows == [6, 6, 6]  # 16 -> 18
    shard_rows.clear()
    assert verify_many_sharded(items, device=["cpu"] * 3) == want  # ladder 16 -> 18
    assert shard_rows == [6, 6, 6]
    assert verify_many_sharded([], device="cpu") == []


def test_verify_many_auto_on_the_cpu(monkeypatch):
    calls = []

    def counting(pubs, msgs, sigs):
        calls.append(pubs.device.type)
        return _standin(pubs, msgs, sigs)

    monkeypatch.setattr(TB, "verify_kernel", counting)
    items = [(bytes(32), bytes(32), bytes([i]) + bytes(63)) for i in range(5)]
    assert verify_many_auto(items, device="cpu") == [i % 2 == 1 for i in range(5)]
    assert calls == ["cpu"]


def test_no_fallback_to_the_cpu_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    items = [(bytes(32), bytes(32), bytes(64))]
    for call in (make_mesh, global_mesh, lambda: verify_many_auto(items), lambda: verify_many_sharded(items)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_multihost_helpers_single_process(monkeypatch):
    """As tests/test_parallel.py checks the JAX helpers: one process needs
    no initialization, and host_shard_to_global stages the whole window."""
    for var in ("MASTER_ADDR", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    initialize_distributed()  # a no-op for one process
    mesh = global_mesh(devices=["cpu"] * 8)
    assert mesh.size == 8 and mesh.group is None
    local = np.arange(16 * 32, dtype=np.uint8).reshape(16, 32)
    shards = host_shard_to_global(mesh, local)
    assert [tuple(s.shape) for s in shards] == [(2, 32)] * 8
    assert np.array_equal(torch.cat(shards).numpy(), local)
    assert all(torch.equal(a, b) for a, b in zip(batch_sharding(mesh)(local), shards))
    items = list(range(10))
    assert partition_items(items, process_id=0, num=2) == [0, 2, 4, 6, 8]
    assert partition_items(items, process_id=1, num=2) == [1, 3, 5, 7, 9]
    assert partition_items(items) == items


@pytest.mark.slow
def test_real_verify_quorum_and_round_step_equal_jax():
    """The JAX functions with the real verify_kernel against the port's, on
    the same signed window with invalid rows and a wrapping state."""
    R = 4
    items = _signed(16, bad={1, 5, 6, 12})
    pubs, msgs, sigs, _ = TB.pad_batch(items, 16)
    round_ids = np.array([i // 4 if i % 5 else i % 7 - 2 for i in range(16)], np.int32)
    thresholds = np.array([2, 3, 3, 4], np.int32)
    args = (pubs, msgs, sigs, round_ids, thresholds)
    jax_state, jres = JV.round_step(JV.make_mesh(8), R)(jnp.asarray(_BIG, jnp.int32), *args)
    state, pres = round_step(make_mesh(devices=["cpu"] * 2), R)(np.array(_BIG, np.int32), *args)
    _assert_same(pres, jres)
    _assert_same(quorum_certify(make_mesh(devices=["cpu"] * 2), R)(*args), jres)
    assert np.array_equal(state.numpy(), np.asarray(jax_state))
    assert pres.valid.tolist() == [ref.verify(*it) for it in items]
