"""toyni_tpu_torch salts, SHA-256 and Merkle trees against toyni_tpu and
hashlib.

On CPU tensors the hash entry points run their plain torch versions, which
the CUDA kernel is held against on the card. Inputs are numpy draws from a
seed; every comparison is exact equality of words or bytes."""

import hashlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from toyni_tpu import merkle as jmerkle
from toyni_tpu.field.babybear import P
from toyni_tpu.ops import salts as jsalts
from toyni_tpu.ops import sha256 as jsha
from toyni_tpu_torch import merkle
from toyni_tpu_torch.ops import salts, sha256 as sha

RNG = np.random.default_rng(0x5A17)


def t(a):
    return torch.from_numpy(np.asarray(a, np.uint64).astype(np.int64))


def j(a):
    return jnp.asarray(np.asarray(a, np.uint64).astype(np.uint32))


def same(port, ref):
    np.testing.assert_array_equal(
        port.numpy().astype(np.uint64), np.asarray(ref, np.uint64)
    )


@pytest.mark.parametrize("seed", [0, 12345, 2**62 + 17])
def test_salts_match_jax(seed):
    key = salts.key_words(seed)
    jkey = jsalts.key_words(seed)
    assert key == tuple(int(k) for k in jkey)
    full = salts.salts_full(key, 300)
    same(full, jax.jit(jsalts.salts_full, static_argnums=1)(jnp.asarray(jkey), 300))
    idx = np.array([0, 1, 17, 299, 150], np.int64)
    assert torch.equal(salts.salts_for_indices(key, torch.from_numpy(idx)), full[idx])


def _random_words(shape):
    return RNG.integers(0, 2**32, shape, dtype=np.uint64)


def test_hash_entry_points_match_jax_and_hashlib():
    n = 64
    values = np.concatenate([RNG.integers(0, P, n - 2, dtype=np.uint64),
                             np.array([0, P - 1], np.uint64)])
    salt_words = _random_words((n, 4))
    left, right = _random_words((n, 8)), _random_words((n, 8))
    leaves = sha.hash_salted_leaves(t(values), t(salt_words))
    plain = sha.hash_unsalted_leaves(t(values))
    parents = sha.hash_nodes(t(left), t(right))
    same(leaves, jax.jit(jsha.hash_salted_leaves)(j(values), j(salt_words)))
    same(plain, jax.jit(jsha.hash_unsalted_leaves)(j(values)))
    same(parents, jax.jit(jsha.hash_nodes)(j(left), j(right)))
    for i in (0, n - 2, n - 1):
        salt = b"".join(int(w).to_bytes(4, "big") for w in salt_words[i])
        value = int(values[i]).to_bytes(8, "little")
        assert sha.digest_bytes(leaves[i]) == hashlib.sha256(b"\x00" + salt + value).digest()
        assert sha.digest_bytes(plain[i]) == hashlib.sha256(b"\x00" + value).digest()
        node = b"\x01" + sha.digest_bytes(t(left[i])) + sha.digest_bytes(t(right[i]))
        assert sha.digest_bytes(parents[i]) == hashlib.sha256(node).digest()


def test_two_block_node_boundary_and_word_codec():
    """All-ones left and zero right digests: every byte that crosses the
    64-byte block boundary of the 65-byte node message is extreme."""
    left = torch.full((1, 8), 0xFFFFFFFF, dtype=torch.int64)
    right = torch.zeros((1, 8), dtype=torch.int64)
    got = sha.hash_nodes(left, right)[0]
    want = hashlib.sha256(b"\x01" + b"\xff" * 32 + b"\x00" * 32).digest()
    assert sha.digest_bytes(got) == want
    assert torch.equal(sha.words_from_bytes(want), got)
    np.testing.assert_array_equal(
        sha.words_from_bytes(want).numpy(), jsha.words_from_bytes(want))


@pytest.mark.parametrize("n_leaves", [1, 5, 64])
def test_tree_roots_and_paths_match_jax(n_leaves):
    """Salted and unsalted roots against the JAX device trees and the host
    oracle (odd levels duplicate their last node); sibling paths against
    `toyni_tpu.merkle.extract_paths` and verified by hashlib."""
    values = RNG.integers(0, P, n_leaves, dtype=np.uint64)
    salt_words = _random_words((n_leaves, 4))
    tree = merkle.build_salted_device_tree(t(values), t(salt_words))
    jtree = jmerkle.build_salted_device_tree(j(values), j(salt_words))
    assert tree.root() == jtree.root()
    assert len(tree.levels) == len(jtree.levels)
    for lv, jlv in zip(tree.levels, jtree.levels):
        same(lv, jlv)
    leaf_bytes = [
        b"".join(int(w).to_bytes(4, "big") for w in salt_words[i])
        + int(values[i]).to_bytes(8, "little")
        for i in range(n_leaves)
    ]
    assert tree.root() == merkle.host_tree_root(leaf_bytes)
    utree = merkle.build_unsalted_device_tree(t(values))
    assert utree.root() == jmerkle.build_unsalted_device_tree(j(values)).root()
    assert utree.root() == merkle.host_tree_root(
        [int(v).to_bytes(8, "little") for v in values])

    if n_leaves & (n_leaves - 1) == 0 and n_leaves > 1:
        idx = np.array([0, 3, n_leaves - 1, 17 % n_leaves], np.int64)
        paths = merkle.extract_paths(tree.levels, torch.from_numpy(idx))
        same(paths, jmerkle.extract_paths(jtree.levels, jnp.asarray(idx, jnp.int32)))
        proofs = merkle.openings_from_paths(idx.tolist(), paths, tree.depth)
        for i, proof in zip(idx.tolist(), proofs):
            assert merkle.verify_merkle_proof(leaf_bytes[i], proof, tree.root())
            assert jmerkle.verify_merkle_proof(leaf_bytes[i], proof, tree.root())
            assert not merkle.verify_merkle_proof(leaf_bytes[i ^ 1], proof, tree.root())


def test_leaf_node_domain_separation():
    """An inner node's digest committed as a leaf gives another root."""
    a = hashlib.sha256(b"\x00" + b"a").digest()
    b = hashlib.sha256(b"\x00" + b"b").digest()
    node_root = merkle.hash_node_bytes(a, b)
    assert node_root == jmerkle.hash_node_bytes(a, b)
    assert merkle.host_tree_root([a, b]) != node_root
    assert merkle.host_tree_root([node_root]) != node_root
