"""The port's compile step (pbft_tpu_torch.utils.graphs): windows captured
once per shape and replayed through static buffers, and the slots that keep
concurrent windows of one shape apart.

On the CPU a captured window keeps its function and calls it on its static
buffers, so the buffer and slot logic runs here:

- verify_many through the captured windows equals the eager stand-in and the
  JAX verify_many (same stand-in verdict rule as tests/test_torch_parallel.py)
  at every pad shape, and the real plain verifier equals the oracle on one
  16-row batch (the one real verify call of the file);
- windows of different rows through one slot's static buffers each get
  their own verdicts, and an earlier window's result is not overwritten;
- two threads inside one shape at once hold distinct slots (distinct static
  buffers), for the lazily grown pools and for the engine's fixed slots;
- the engine's stats carry the JAX engine's keys plus the port's own;
- a launch recorded at capture counts once per replay.

cuda (skipped without a card): replayed verdicts equal the eager on-card
path raw verdict for raw verdict at every pad shape, one launch per kernel
per replay; a capture that fails raises from warm(), and nothing serves.
Tolerance everywhere: exact verdict bits.
"""

import threading

import numpy as np
import pytest
import torch

import pbft_tpu_torch.crypto.batch as TB
import pbft_tpu_torch.parallel.verifier as TV
from pbft_tpu_torch.crypto import ed25519 as E
from pbft_tpu_torch.crypto import kernels as K
from pbft_tpu_torch.crypto import ref
from pbft_tpu_torch.net.verify_service import CudaVerifyEngine
from pbft_tpu_torch.utils import graphs


def _standin(pubs, msgs, sigs):
    """The stand-in verdict rule (sig[0] odd), on jax arrays and tensors."""
    return (sigs[..., 0] & 1) == 1


@pytest.fixture
def standin(monkeypatch):
    monkeypatch.setattr(TB, "verify_kernel", _standin)
    monkeypatch.setattr(TV, "verify_kernel", _standin)


def _items(rng, n: int):
    raw = rng.integers(0, 256, (n, 128), dtype=np.uint8)
    return [(bytes(r[:32]), bytes(r[32:64]), bytes(r[64:])) for r in raw]


def _specs(rows: int):
    return [((rows, w), torch.uint8) for w in (32, 32, 64)]


def _slots(key) -> int:
    pool = graphs._POOLS.get(key)
    return pool.size if pool else 0


@pytest.mark.parametrize("size", TB._PAD_LADDER)
def test_captured_windows_equal_eager_and_jax_at_every_pad_shape(standin, size):
    import jax.numpy as jnp

    import pbft_tpu.crypto.batch as JB

    items = _items(np.random.default_rng(size), size - 3)
    got = TB.verify_many(items, device="cpu")
    pubs, msgs, sigs, n = TB.pad_batch(items, size)
    eager = _standin(*(torch.from_numpy(a) for a in (pubs, msgs, sigs)))[:n].tolist()
    want = JB.verify_many(items, launch=lambda p, m, s: _standin(p, m, jnp.asarray(s)))
    assert got == eager == want
    assert TB.pad_size(len(items)) == size
    assert _slots(("batch", torch.device("cpu"), size)) >= 1


def test_real_plain_verify_through_a_window_equals_the_oracle():
    items = []
    for i in range(16):
        seed, pub = ref.keygen(bytes([0x71 + i]) * 32)
        msg = bytes([i]) * 32
        sig = ref.sign(seed, msg)
        if i in (0, 7, 15):
            sig = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
        items.append((pub, msg, sig))
    assert TB.verify_many(items, device="cpu") == [ref.verify(*it) for it in items]
    assert [ref.verify(*it) for it in items] == [i not in (0, 7, 15) for i in range(16)]


def test_windows_through_the_same_buffers_keep_their_own_verdicts():
    """Row 7 is invalid in the first window and a pad row of the second: the
    second reads True there, and the first window's result stays as it was
    (results are copies, not views of the static output)."""
    window = graphs.CapturedWindow(_standin, _specs(16), "cpu").capture()
    items = [(bytes(32), bytes(32), bytes([1]) + bytes(63))] * 10
    items[7] = (bytes(32), bytes(32), bytes(64))
    pubs, msgs, sigs, _ = TB.pad_batch(items, 16)
    sigs[10:, 0] |= 1  # the stand-in accepts the pad rows
    first = window.run(pubs, msgs, sigs)[0]
    assert first.tolist() == [i != 7 for i in range(16)]
    pubs, msgs, sigs, _ = TB.pad_batch(items[:5], 16)
    sigs[5:, 0] |= 1
    second = window.run(pubs, msgs, sigs)[0]
    assert second.tolist() == [True] * 16
    assert first.tolist() == [i != 7 for i in range(16)]
    with pytest.raises(ValueError, match="window of"):
        window.run(*TB.pad_batch(items, 64)[:3])


def test_verify_many_windows_of_one_shape_in_sequence(standin):
    key = ("batch", torch.device("cpu"), 16)
    rng = np.random.default_rng(7)
    items = _items(rng, 10)
    assert TB.verify_many(items, device="cpu") == [(it[2][0] & 1) == 1 for it in items]
    slots = _slots(key)
    for n in (5, 16, 1):
        items = _items(rng, n)
        assert TB.verify_many(items, device="cpu") == [(it[2][0] & 1) == 1 for it in items]
    assert _slots(key) == slots >= 1  # one caller at a time: no slot added


class _Meeting:
    """A stand-in that, once armed, holds each caller until two callers are
    inside it at once, and records the static input buffer each one got."""

    def __init__(self):
        self.armed = False
        self.barrier = threading.Barrier(2, timeout=10)
        self.buffers = []

    def __call__(self, pubs, msgs, sigs):
        if self.armed:
            self.buffers.append(pubs.data_ptr())
            self.barrier.wait()
        return _standin(pubs, msgs, sigs)


def _two_threads(call, args):
    out, errors = {}, []

    def run(i):
        try:
            out[i] = call(args[i])
        except Exception as e:  # noqa: BLE001 - asserted below
            errors.append(repr(e))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(20)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    return out


def test_two_threads_in_one_shape_get_distinct_slots(monkeypatch):
    meeting = _Meeting()
    monkeypatch.setattr(TB, "verify_kernel", meeting)
    rng = np.random.default_rng(11)
    batches = [_items(rng, 12), _items(rng, 12)]
    key = ("batch", torch.device("cpu"), 256)
    TB.verify_many(batches[0], pad_to=256, device="cpu")  # a slot exists
    before = _slots(key)
    meeting.armed = True
    out = _two_threads(lambda items: TB.verify_many(items, pad_to=256, device="cpu"), batches)
    for i in (0, 1):
        assert out[i] == [(it[2][0] & 1) == 1 for it in batches[i]]
    assert len(set(meeting.buffers)) == 2
    assert _slots(key) == max(before, 2)


def test_engine_slots_run_at_once_and_are_captured_at_warm():
    meeting = _Meeting()
    engine = CudaVerifyEngine(shapes=(16,), device="cpu", kernel=meeting, slots=2)
    stats = engine.warm()
    assert stats["compiled"] == 2 and stats["slots"] == 2
    rng = np.random.default_rng(12)
    batches = [_items(rng, 9), _items(rng, 14)]
    meeting.armed = True
    out = _two_threads(engine.verify, batches)
    for i in (0, 1):
        assert out[i] == [(it[2][0] & 1) == 1 for it in batches[i]]
    assert len(set(meeting.buffers)) == 2


def test_engine_stats_keys_are_the_jax_engines_plus_the_ports():
    from pbft_tpu.net.verify_service import ShardedVerifyEngine

    jax_stats = ShardedVerifyEngine(shapes=(16,), kernel=_standin).warm()
    stats = CudaVerifyEngine(shapes=(16,), device="cpu", kernel=_standin, devices=2, slots=3).warm()
    assert set(stats) == set(jax_stats) | {"device", "shards", "build_s", "build_compiled", "build_dir", "slots",
                                           "graph_pool_bytes", "compile_s_by_shape", "graph_pool_bytes_by_shape"}
    assert stats["build_compiled"] == [] and stats["build_dir"] is None  # no kernel build off the card
    assert list(stats["compile_s_by_shape"]) == stats["shapes"] == [16]
    assert stats["compiled"] == 6  # 1 shape x 2 shards x 3 slots
    assert stats["aot_loaded"] == 0 and stats["graph_pool_bytes"] == 0  # no card


def test_recorded_launches_count_once_per_replay():
    K.reset_launches()
    with K.recording() as recorded:
        K._count("ladder")
        K._count("inv")
        K._count("sha512")
    assert K.LAUNCHES == {"inv": 0, "p58": 0, "ladder": 0, "sha512": 0}
    assert recorded == {"inv": 1, "p58": 0, "ladder": 1, "sha512": 1}
    for _ in range(3):
        K.add_launches(recorded)
    assert K.LAUNCHES == {"inv": 3, "p58": 0, "ladder": 3, "sha512": 3}
    K._count("p58")  # outside a capture: counted at once
    assert K.LAUNCHES["p58"] == 1
    K.reset_launches()


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", torch.cuda.current_device())


def _signed_window(size: int):
    """size rows from 24 signed items and their corrupted copies."""
    base = []
    for i in range(24):
        seed, pub = ref.keygen(bytes([0x90 + i]) * 32)
        msg = bytes([i, 0x5A]) * 16
        sig = ref.sign(seed, msg)
        base += [(pub, msg, sig), (pub, msg, bytes([sig[0] ^ 0x40]) + sig[1:])]
    items = [base[(7 * i) % len(base)] for i in range(size)]
    return items, [ref.verify(*it) for it in base], [(7 * i) % len(base) for i in range(size)]


@pytest.mark.cuda
def test_replay_equals_eager_on_the_card_at_every_pad_shape(cuda_device):
    for size in TB._PAD_LADDER:
        items, want, pick = _signed_window(size)
        pubs, msgs, sigs, _ = TB.pad_batch(items, size)
        eager = E.verify_kernel(*(torch.from_numpy(a).to(cuda_device) for a in (pubs, msgs, sigs))).cpu()
        TB.verify_batch(pubs, msgs, sigs)  # captured at the shape's first use
        K.reset_launches()
        replayed = TB.verify_batch(pubs, msgs, sigs).cpu()
        assert K.LAUNCHES == {"inv": 1, "p58": 1, "ladder": 1, "sha512": 1}, size
        assert torch.equal(replayed, eager), size
        assert replayed.tolist() == [want[i] for i in pick], size


@pytest.mark.cuda
def test_capture_failure_raises_from_warm_and_nothing_serves(cuda_device):
    calls = []

    def syncs(pubs, msgs, sigs):
        calls.append(1)
        if int(sigs.sum().item()) < 0:  # a host sync: legal eagerly, not under capture
            raise AssertionError
        return _standin(pubs, msgs, sigs)

    engine = CudaVerifyEngine(shapes=(16,), kernel=syncs)
    with pytest.raises(RuntimeError):
        engine.warm()
    seen = len(calls)
    with pytest.raises(RuntimeError, match="engine not warmed"):
        engine.verify(_items(np.random.default_rng(3), 4))
    assert len(calls) == seen and engine.warmed_sizes == ()
