"""Batched SHA-256 of the protocol's leaf and node messages.

The three fixed message shapes of `toyni_tpu.ops.sha256`:
  * salted leaf    SHA256(0x00 || salt16 || value8LE)   25 B, one block
  * unsalted leaf  SHA256(0x00 || value8LE)              9 B, one block
  * inner node     SHA256(0x01 || left32 || right32)    65 B, two blocks
Salt words and digests are big-endian 32-bit words, held in int64 tensors
(0 <= w < 2^32): a salt is (..., 4) words, a digest (..., 8).

`hash_salted_leaves`, `hash_unsalted_leaves` and `hash_nodes` dispatch on
the device: a CUDA tensor goes to the hand-written kernel (`csrc/sha256.cu`,
wrappers `salted_leaves`, `unsalted_leaves`, `nodes` below, which take and
return int32 bit patterns), a CPU tensor to the plain torch version
(`*_plain`), which the kernel is held against.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..field import babybear as bb

M32 = 0xFFFFFFFF

# FIPS 180-4 constants
_K = (
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
)

_H0 = (
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19,
)

# kernel launches since the last reset (each wrapper call is one)
LAUNCHES = 0


# ── plain torch version ──────────────────────────────────────────────────────
# Words are int64 tensors or Python ints (constant message words); every op
# works on both, so constant parts of the schedule fold to ints.

def _rotr(x, n: int):
    return ((x >> n) | (x << (32 - n))) & M32


def _compress(state: list, win: list) -> list:
    """One compression over a 16-word block (tensors or ints)."""
    a, b, c, d, e, f, g, h = state
    win = list(win)
    for t in range(64):
        w_t = win[0]
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = (h + s1 + ch + _K[t] + w_t) & M32
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = s0 + maj
        w1, w14 = win[1], win[14]
        sig0 = _rotr(w1, 7) ^ _rotr(w1, 18) ^ (w1 >> 3)
        sig1 = _rotr(w14, 17) ^ _rotr(w14, 19) ^ (w14 >> 10)
        win = win[1:] + [(win[0] + sig0 + win[9] + sig1) & M32]
        h, g, f, e = g, f, e, (d + t1) & M32
        d, c, b, a = c, b, a, (t1 + t2) & M32
    return [(s + x) & M32 for s, x in zip(state, (a, b, c, d, e, f, g, h))]


def _sha256_words(blocks: list) -> torch.Tensor:
    state = list(_H0)
    for win in blocks:
        state = _compress(state, win)
    return torch.stack(state, dim=-1)


def _le_bytes_012(v):
    """Bytes 0..2 of a value's little-endian form, as bytes 1..3 of a
    big-endian word."""
    return ((v & 0xFF) << 16) | (((v >> 8) & 0xFF) << 8) | ((v >> 16) & 0xFF)


def salted_leaves_plain(values: torch.Tensor, salts: torch.Tensor) -> torch.Tensor:
    s0, s1, s2, s3 = (salts[..., k] for k in range(4))
    v = values
    win = [
        s0 >> 8,                                   # 0x00 tag + salt bytes
        ((s0 & 0xFF) << 24) | (s1 >> 8),
        ((s1 & 0xFF) << 24) | (s2 >> 8),
        ((s2 & 0xFF) << 24) | (s3 >> 8),
        ((s3 & 0xFF) << 24) | _le_bytes_012(v),
        ((v >> 24) & 0xFF) << 24,
        0x00800000,
        0, 0, 0, 0, 0, 0, 0, 0,
        200,                                       # 25-byte message
    ]
    return _sha256_words([win])


def unsalted_leaves_plain(values: torch.Tensor) -> torch.Tensor:
    v = values
    win = [
        _le_bytes_012(v),
        ((v >> 24) & 0xFF) << 24,
        0x00800000,
        0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
        72,                                        # 9-byte message
    ]
    return _sha256_words([win])


def nodes_plain(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    l = [left[..., k] for k in range(8)]
    r = [right[..., k] for k in range(8)]
    w = [(l[0] >> 8) | (0x01 << 24)]
    for i in range(1, 8):
        w.append(((l[i - 1] & 0xFF) << 24) | (l[i] >> 8))
    w.append(((l[7] & 0xFF) << 24) | (r[0] >> 8))
    for i in range(1, 8):
        w.append(((r[i - 1] & 0xFF) << 24) | (r[i] >> 8))
    w2 = [((r[7] & 0xFF) << 24) | 0x00800000] + [0] * 14 + [520]
    return _sha256_words([w, w2])


# ── kernel wrappers (int32 bit patterns in and out) ─────────────────────────

def _check(t: torch.Tensor, shape: tuple, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"sha256 kernel: {what} must be a CUDA tensor")
    if t.dtype != torch.int32:
        raise TypeError(f"sha256 kernel: {what} must be int32")
    if tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"sha256 kernel: {what} must be contiguous {shape}")
    if t.data_ptr() % 16:
        raise ValueError(f"sha256 kernel: {what} must be 16-byte aligned")


def _launch(name: str, inputs: list, n: int) -> torch.Tensor:
    global LAUNCHES
    dev = inputs[0].device
    if any(t.device != dev for t in inputs):
        raise ValueError("sha256 kernel: tensors must be on one device")
    out = torch.empty((n, 8), dtype=torch.int32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, name)(
            *(t.data_ptr() for t in inputs), out.data_ptr(), n, stream
        )
    _build.check(rc, f"{name} launch")
    LAUNCHES += 1
    return out


def salted_leaves(values: torch.Tensor, salts: torch.Tensor) -> torch.Tensor:
    """Kernel: (N,) values and (N, 4) salt words -> (N, 8) digests, int32."""
    n = values.shape[0]
    _check(values, (n,), "values")
    _check(salts, (n, 4), "salts")
    return _launch("toyni_sha256_salted_leaves", [values, salts], n)


def unsalted_leaves(values: torch.Tensor) -> torch.Tensor:
    """Kernel: (N,) values -> (N, 8) digests, int32."""
    n = values.shape[0]
    _check(values, (n,), "values")
    return _launch("toyni_sha256_unsalted_leaves", [values], n)


def nodes(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Kernel: (M, 8) left and right digests -> (M, 8) parents, int32."""
    m = left.shape[0]
    _check(left, (m, 8), "left")
    _check(right, (m, 8), "right")
    return _launch("toyni_sha256_nodes", [left, right], m)


# ── dispatch (int64 words in and out) ───────────────────────────────────────

def _on_cuda(*ts: torch.Tensor) -> bool:
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"sha256: no path for devices {sorted(kinds)}")


def _i32(t: torch.Tensor) -> torch.Tensor:
    return bb.to_i32(t).contiguous()


def hash_salted_leaves(values: torch.Tensor, salts: torch.Tensor) -> torch.Tensor:
    """SHA256(0x00 || salt || value8LE) for every lane: (N,) values below p
    and (N, 4) salt words -> (N, 8) digest words."""
    if not _on_cuda(values, salts):
        return salted_leaves_plain(values, salts)
    return bb.from_i32(salted_leaves(_i32(values), _i32(salts)))


def hash_unsalted_leaves(values: torch.Tensor) -> torch.Tensor:
    """SHA256(0x00 || value8LE): the public final-FRI-layer leaves."""
    if not _on_cuda(values):
        return unsalted_leaves_plain(values)
    return bb.from_i32(unsalted_leaves(_i32(values)))


def hash_nodes(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """SHA256(0x01 || left || right) for (M, 8) digest pairs."""
    if not _on_cuda(left, right):
        return nodes_plain(left, right)
    return bb.from_i32(nodes(_i32(left), _i32(right)))


# ── host boundary helpers ───────────────────────────────────────────────────

def digest_bytes(words) -> bytes:
    """One (8,) digest -> its canonical 32-byte big-endian form."""
    if isinstance(words, torch.Tensor):
        words = words.tolist()
    return b"".join(int(w).to_bytes(4, "big") for w in words)


def words_from_bytes(digest: bytes) -> torch.Tensor:
    """32-byte digest -> (8,) int64 words."""
    return torch.from_numpy(np.frombuffer(digest, dtype=">u4").astype(np.int64))
