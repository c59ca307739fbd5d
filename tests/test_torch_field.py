"""The port's field arithmetic (pbft_tpu_torch.crypto.field) against the JAX
module (pbft_tpu.crypto.field, jitted on the CPU) and Python big integers,
on the same numpy inputs. Tolerance: exact equality of the int32 limbs (the
two modules compute the same integers, carried form included) and of the
big-integer values."""

import secrets

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pbft_tpu.crypto import field as JF
from pbft_tpu_torch.crypto import field as F
from pbft_tpu_torch.crypto import kernels as K

_RNG = np.random.default_rng(0xF1E1D)


def _hostile():
    """The loosest limbs add/sub can produce (tests/test_field.py)."""
    return np.stack(
        [
            np.full(F.NLIMBS, 1023, np.int32),
            np.full(F.NLIMBS, -1023, np.int32),
            np.array([1023 if i % 2 else -1023 for i in range(F.NLIMBS)], np.int32),
        ]
    )


def _operands():
    """(a, b): every pair of hostile patterns, random carried limbs,
    canonical random values, edge values and zero."""
    h = _hostile()
    a = [np.repeat(h, 3, axis=0)]
    b = [np.tile(h, (3, 1))]
    rand = _RNG.integers(-(2**9) + 1, 2**9, size=(2, 6, F.NLIMBS)).astype(np.int32)
    a.append(rand[0])
    b.append(rand[1])
    vals = [0, 1, 2, 19, F.P - 1, F.P - 19, 2**255 - 20] + [secrets.randbelow(F.P) for _ in range(3)]
    a.append(np.stack([F.limbs_const(v) for v in vals]))
    b.append(np.stack([F.limbs_const(v) for v in reversed(vals)]))
    return np.concatenate(a), np.concatenate(b)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _val(row) -> int:
    return F.limbs_to_int(np.asarray(row)) % F.P


@jax.jit
def _jax_ops(a, b):
    return {
        "carry": JF.carry(a),
        "carry4": JF.carry(a, passes=4),
        "carry_seq": JF.carry_seq(a),
        "add": JF.add(a, b),
        "sub": JF.sub(a, b),
        "neg": JF.neg(a),
        "mul": JF.mul(a, b),
        "sqr": JF.sqr(a),
        "mul_small": JF.mul_small(a, 2),
        "canon": JF.canon(a),
        "eq": JF.eq(a, b),
        "eq_self": JF.eq(a, JF.add(a, jnp.zeros_like(a))),
        "is_zero": JF.is_zero(a),
    }


def _port_ops(a, b):
    return {
        "carry": F.carry(a),
        "carry4": F.carry(a, passes=4),
        "carry_seq": F.carry_seq(a),
        "add": F.add(a, b),
        "sub": F.sub(a, b),
        "neg": F.neg(a),
        "mul": F.mul(a, b),
        "sqr": F.sqr(a),
        "mul_small": F.mul_small(a, 2),
        "canon": F.canon(a),
        "eq": F.eq(a, b),
        "eq_self": F.eq(a, F.add(a, torch.zeros_like(a))),
        "is_zero": F.is_zero(a),
    }


def test_field_ops_match_jax_limbs_and_bigints():
    a, b = _operands()
    want = {k: np.asarray(v) for k, v in _jax_ops(jnp.asarray(a), jnp.asarray(b)).items()}
    got = {k: v.numpy() for k, v in _port_ops(_t(a), _t(b)).items()}
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    canon = lambda x: F.canon(_t(x)).numpy()  # noqa: E731
    for i in range(a.shape[0]):
        x, y = _val(a[i]), _val(b[i])
        assert F.limbs_to_int(canon(got["mul"])[i]) == x * y % F.P, i
        assert F.limbs_to_int(canon(got["sqr"])[i]) == x * x % F.P, i
        assert F.limbs_to_int(canon(got["add"])[i]) == (x + y) % F.P, i
        assert F.limbs_to_int(canon(got["sub"])[i]) == (x - y) % F.P, i
        assert F.limbs_to_int(canon(got["neg"])[i]) == (-x) % F.P, i
        assert F.limbs_to_int(canon(got["mul_small"])[i]) == 2 * x % F.P, i
        assert F.limbs_to_int(got["canon"][i]) == x, i
        assert bool(got["eq"][i]) == (x == y), i
    assert got["eq_self"].all()
    # Deep subtraction chains stay correct (signed-limb soundness).
    x = _t(F.limbs_const(0))
    for k in range(20):
        x = F.sub(x, _t(F.limbs_const(F.P - 3 - k)))
    assert F.limbs_to_int(F.canon(x)) == sum(3 + k for k in range(20)) % F.P


def test_bytes_roundtrip_and_from_numpy():
    v = secrets.randbelow(F.P)
    raw = np.frombuffer(int.to_bytes(v, 32, "little"), np.uint8)
    limbs = F.bytes_to_limbs(F.from_numpy(raw, "cpu"))
    assert limbs.dtype == torch.int32
    assert bytes(F.limbs_to_bytes(limbs).numpy()) == int.to_bytes(v, 32, "little")
    pt = F.from_numpy((np.asarray(JF.limbs_const(v)), jnp.asarray(JF.limbs_const(1))), "cpu")
    assert isinstance(pt, tuple) and all(c.dtype == torch.int32 for c in pt)
    assert F.limbs_to_int(pt[0]) == v


def test_mod_l_reduction_and_scalars_match_jax_and_bigints():
    cases = [0, 1, F.L - 1, F.L, F.L + 1, 2**252, 2**512 - 1]
    cases += [secrets.randbelow(2**512) for _ in range(6)]
    wide = np.stack([np.frombuffer(int.to_bytes(v, 64, "little"), np.uint8) for v in cases])
    got = F.reduce512_mod_l(F.bytes_to_limbs(_t(wide))).numpy()
    want = np.asarray(jax.jit(JF.reduce512_mod_l)(JF.bytes_to_limbs(jnp.asarray(wide))))
    np.testing.assert_array_equal(got, want)
    for row, v in zip(got, cases):
        assert F.limbs_to_int(row) == v % F.L

    scalars = [0, F.L - 1, F.L, 2**256 - 1] + [secrets.randbelow(2**256) for _ in range(4)]
    limbs = np.stack([F.limbs_const(v) for v in scalars])
    lt = F.scalar_lt_l(_t(limbs)).numpy()
    np.testing.assert_array_equal(lt, np.asarray(jax.jit(JF.scalar_lt_l)(jnp.asarray(limbs))))
    assert lt.tolist() == [v < F.L for v in scalars]
    bits = F.scalar_bits(_t(limbs)).numpy()
    np.testing.assert_array_equal(bits, np.asarray(jax.jit(JF.scalar_bits)(jnp.asarray(limbs))))
    for row, v in zip(bits, scalars):
        assert row.tolist() == [(v >> k) & 1 for k in range(256)]


def test_chain_plain_versions_match_jax_and_bigints():
    """inv_plain / pow_p58_plain (the plain versions of the chain kernels)
    against JAX field.inv / field.pow_p58 and pow(); inv(0) = 0."""
    x = np.concatenate(
        [
            _hostile(),
            _RNG.integers(-(2**9) + 1, 2**9, size=(4, F.NLIMBS)).astype(np.int32),
            np.zeros((1, F.NLIMBS), np.int32),
        ]
    )
    xj = jnp.asarray(x)
    inv_got = K.inv_plain(_t(x)).numpy()
    p58_got = K.pow_p58_plain(_t(x)).numpy()
    np.testing.assert_array_equal(inv_got, np.asarray(jax.jit(JF.inv)(xj)))
    np.testing.assert_array_equal(p58_got, np.asarray(jax.jit(JF.pow_p58)(xj)))
    inv_c = F.canon(_t(inv_got)).numpy()
    p58_c = F.canon(_t(p58_got)).numpy()
    for i in range(x.shape[0]):
        v = _val(x[i])
        assert F.limbs_to_int(inv_c[i]) == pow(v, F.P - 2, F.P), i
        assert F.limbs_to_int(p58_c[i]) == pow(v, (F.P - 5) // 8, F.P), i
    assert F.limbs_to_int(inv_c[-1]) == 0
