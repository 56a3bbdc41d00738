"""Counter-mode leaf salts: Threefry-2x32, sliceable at any index.

The stream of `toyni_tpu.ops.salts`: a layer's salts are a function of
(key, leaf index). Element i of the flat (count * 4) salt-word stream is

    bits[i] = y0 ^ y1,  (y0, y1) = threefry2x32(key, (hi32(i), lo32(i)))

and leaf j holds words 4j .. 4j+3. The block function is the 20-round
Threefry-2x32 with jax's key and rotation schedule, so proofs match the JAX
package byte for byte. Plain torch int64 with 32-bit masks; not a kernel.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROTS = ((13, 15, 26, 6), (17, 29, 16, 24))


def key_words(seed: int) -> tuple:
    """The (k0, k1) key of a 63-bit rng draw: (0, seed mod 2^32)."""
    return (0, int(seed) & M32)


def _rotl(x, d: int):
    return ((x << d) & M32) | (x >> (32 - d))


def threefry2x32(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor):
    """The Threefry-2x32 block function over int64 tensors of 32-bit words
    (20 rounds); k0, k1 are host ints."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for g in range(5):
        for r in _ROTS[g % 2]:
            x0 = (x0 + x1) & M32
            x1 = x0 ^ _rotl(x1, r)
        x0 = (x0 + ks[(g + 1) % 3]) & M32
        x1 = (x1 + ks[(g + 2) % 3] + g + 1) & M32
    return x0, x1


def _bits_at_flat(key: tuple, flat: torch.Tensor) -> torch.Tensor:
    y0, y1 = threefry2x32(key[0], key[1], flat >> 32, flat & M32)
    return y0 ^ y1


def salts_full(key: tuple, count: int, device="cpu") -> torch.Tensor:
    """(count, 4) int64 salt words of a whole layer."""
    flat = torch.arange(count * 4, dtype=torch.int64, device=device)
    return _bits_at_flat(key, flat).reshape(count, 4)


def salts_for_indices(key: tuple, leaf_idx: torch.Tensor) -> torch.Tensor:
    """(Q, 4) salt words of the given leaves; equal to
    `salts_full(key, N)[leaf_idx]` for any N > max(leaf_idx)."""
    idx = leaf_idx.to(torch.int64)
    flat = idx[:, None] * 4 + torch.arange(4, dtype=torch.int64, device=idx.device)
    return _bits_at_flat(key, flat)
