"""toyni_tpu_torch.field against toyni_tpu.field and the numpy oracle.

Inputs are made with numpy from a seed and go through both packages; every
comparison is exact equality of field values, words or bytes (tolerance
zero)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from toyni_tpu.field import babybear as jbb
from toyni_tpu.field import ext as jext
from toyni_tpu.field import oracle
from toyni_tpu_torch.field import babybear as bb
from toyni_tpu_torch.field import ext

P = jbb.P
RNG = np.random.default_rng(0x70C4)
EDGES = np.array([0, 1, 2, P - 2, P - 1], np.uint64)


def operands():
    """Random values plus every pair of edge values (0, 1, p-1, ...)."""
    a = np.concatenate([RNG.integers(0, P, 512, dtype=np.uint64),
                        np.repeat(EDGES, len(EDGES))])
    b = np.concatenate([RNG.integers(0, P, 512, dtype=np.uint64),
                        np.tile(EDGES, len(EDGES))])
    return a, b


def t(a):
    return torch.from_numpy(np.asarray(a, np.uint64).astype(np.int64))


def j(a):
    return jnp.asarray(np.asarray(a, np.uint64).astype(np.uint32))


def same(port, ref):
    np.testing.assert_array_equal(
        port.numpy().astype(np.uint64), np.asarray(ref, np.uint64)
    )


def test_constants_and_roots():
    assert (bb.P, bb.TWO_ADICITY, bb.PRIMITIVE_ROOT) == (
        jbb.P, jbb.TWO_ADICITY, jbb.PRIMITIVE_ROOT)
    for log_n in range(jbb.TWO_ADICITY + 1):
        assert bb.get_root_of_unity(log_n) == jbb.get_root_of_unity(log_n)


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops(op):
    a, b = operands()
    port = getattr(bb, op)(t(a), t(b))
    same(port, getattr(jbb, op)(j(a), j(b)))
    same(port, getattr(oracle, op)(a, b))


def test_neg_pow_inv():
    a, _ = operands()
    same(bb.neg(t(a)), jbb.neg(j(a)))
    for e in (0, 1, 2, 7, P - 2):
        same(bb.pow_const(t(a), e), oracle.pow_(a, e))
    inv = bb.inv(t(a))
    same(inv, jbb.inv(j(a)))
    assert int(bb.inv(t([0]))[0]) == 0  # 0 -> 0, as in toyni_tpu


def test_sum_mod_and_powers():
    v = RNG.integers(0, P, (3, 1000), dtype=np.uint64)
    same(bb.sum_mod(t(v)), jbb.sum_mod(j(v)))
    same(bb.sum_mod(t(np.full(4096, P - 1, np.uint64))),
         jbb.sum_mod(j(np.full(4096, P - 1, np.uint64))))
    for base, n in ((7, 1), (7, 1000), (P - 1, 33)):
        same(bb.powers(base, n), jbb.powers(base, n))


def test_host_helpers_and_codecs():
    a, b = (int(x) for x in RNG.integers(0, P, 2))
    for name in ("h_mul", "h_add", "h_sub"):
        assert getattr(bb, name)(a, b) == getattr(jbb, name)(a, b)
    assert bb.h_pow(a, 12345) == jbb.h_pow(a, 12345)
    assert bb.h_inv(a) == jbb.h_inv(a)
    for v in (0, 1, P - 1, a):
        assert bb.to_bytes(v) == jbb.to_bytes(v)
    for data in (b"", b"\x01", bytes(range(8)), b"\xff" * 8, bytes(range(40))):
        assert bb.from_bytes_mod_order(data) == jbb.from_bytes_mod_order(data)


def test_ext_host_helpers():
    x = tuple(int(v) for v in RNG.integers(0, P, 4))
    y = tuple(int(v) for v in RNG.integers(0, P, 4))
    assert ext.W == jext.W and ext.H_ONE == jext.H_ONE
    for name in ("h_add", "h_sub", "h_mul"):
        assert getattr(ext, name)(x, y) == getattr(jext, name)(x, y)
    assert ext.h_mul_base(x, 5) == jext.h_mul_base(x, 5)
    assert ext.h_pow(x, 1000) == jext.h_pow(x, 1000)
    assert ext.h_inv(x) == jext.h_inv(x)
    assert ext.h_to_bytes(x) == jext.h_to_bytes(x)
    assert ext.h_from_bytes(ext.h_to_bytes(x)) == x


def test_int32_word_round_trip():
    """Words >= 2^31 become negative int32 bit patterns and come back."""
    words = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 1],
                         dtype=torch.int64)
    w32 = bb.to_i32(words)
    assert w32.dtype == torch.int32
    assert w32.tolist() == [0, 1, 2**31 - 1, -(2**31), -(2**31) + 1, -1]
    assert torch.equal(bb.from_i32(w32), words)
