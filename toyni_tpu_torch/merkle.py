"""Salted SHA-256 Merkle commitments on torch tensors.

The tree of `toyni_tpu.merkle`: leaf = SHA256(0x00 || leaf bytes), inner
node = SHA256(0x01 || left || right), the last node of an odd level
duplicated as its own sibling. Levels are (n_i, 8) int64 digest-word
tensors kept on the device; only roots and opened paths reach the host.

Every tree is stored whole. The JAX package's pruned and key-form storage
for huge trees (`prune_levels`, `_levels_salted_pruned`) is not ported; the
prover refuses LDE sizes that need it (`LEAFLESS_MIN`).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import torch

from .ops import sha256 as sha

# the JAX package stores trees of this many leaves or more pruned
LEAFLESS_MIN = 1 << 22


@dataclass
class MerkleProof:
    """Sibling path bottom-up; position[i] True = sibling is on the LEFT of
    the current hash (the current index was odd)."""

    path: list  # list[bytes], 32-byte digests
    position: list  # list[bool]


class DeviceTree:
    """A Merkle tree whose levels stay on the device: levels[0] = leaf
    digests ... levels[-1] = [root]."""

    def __init__(self, levels: list):
        self.levels = levels
        self._root = None

    @property
    def depth(self) -> int:
        """Number of path elements in an opening."""
        return len(self.levels) - 1

    def root(self) -> bytes:
        if self._root is None:
            self._root = sha.digest_bytes(self.levels[-1][0])
        return self._root


def _device_levels(leaf_digests: torch.Tensor) -> list:
    """Hash pairwise up from (n, 8) leaf digests: one `hash_nodes` call per
    level, an odd level's last node duplicated."""
    levels = [leaf_digests]
    cur = leaf_digests
    while cur.shape[0] > 1:
        if cur.shape[0] % 2 == 1:
            cur = torch.cat([cur, cur[-1:]], dim=0)
        pairs = cur.reshape(-1, 16)
        cur = sha.hash_nodes(pairs[:, :8], pairs[:, 8:])
        levels.append(cur)
    return levels


def build_salted_device_tree(values: torch.Tensor, salts: torch.Tensor) -> DeviceTree:
    """Hiding commitment to (n,) values with (n, 4) salt words."""
    return DeviceTree(_device_levels(sha.hash_salted_leaves(values, salts)))


def build_unsalted_device_tree(values: torch.Tensor) -> DeviceTree:
    """Public commitment (leaf = value bytes), for the final FRI layer."""
    return DeviceTree(_device_levels(sha.hash_unsalted_leaves(values)))


def extract_paths(levels: list, indices: torch.Tensor) -> torch.Tensor:
    """Sibling paths of power-of-two trees: (Q,) indices -> (Q, depth, 8)
    digest words, bottom-up."""
    idx = indices.to(torch.int64)
    out = []
    for level in levels[:-1]:
        out.append(level[idx ^ 1])
        idx = idx >> 1
    return torch.stack(out, dim=1)


def openings_from_paths(indices, paths, depth: int) -> list:
    """Host assembly: (Q, depth, 8) path words -> list[MerkleProof]."""
    if isinstance(paths, torch.Tensor):
        paths = paths.tolist()
    proofs = []
    for qi, path in zip(indices, paths):
        p, pos = [], []
        idx = qi
        for l in range(depth):
            p.append(sha.digest_bytes(path[l]))
            pos.append(idx % 2 == 1)
            idx //= 2
        proofs.append(MerkleProof(p, pos))
    return proofs


# ── host-side verification (hashlib) ────────────────────────────────────────

def hash_leaf_bytes(data: bytes) -> bytes:
    """SHA256(0x00 || data)."""
    return hashlib.sha256(b"\x00" + data).digest()


def hash_node_bytes(left: bytes, right: bytes) -> bytes:
    """SHA256(0x01 || left || right)."""
    return hashlib.sha256(b"\x01" + left + right).digest()


def verify_merkle_proof(leaf: bytes, proof: MerkleProof, root: bytes) -> bool:
    """Stateless path verification."""
    cur = hash_leaf_bytes(leaf)
    for sibling, is_right in zip(proof.path, proof.position):
        cur = hash_node_bytes(sibling, cur) if is_right else hash_node_bytes(cur, sibling)
    return cur == root


def host_tree_root(leaves: list) -> bytes:
    """Root of the tree over a list of leaf byte strings."""
    level = [hash_leaf_bytes(l) for l in leaves]
    while len(level) > 1:
        if len(level) % 2 == 1:
            level.append(level[-1])
        level = [hash_node_bytes(level[i], level[i + 1]) for i in range(0, len(level), 2)]
    return level[0]
