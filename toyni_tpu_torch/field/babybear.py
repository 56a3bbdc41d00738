"""BabyBear field arithmetic on torch tensors.

p = 2^31 - 2^27 + 1, the prime of `toyni_tpu.field.babybear`. Values are
held in ``torch.int64`` in standard form (0 <= v < p): a product of two
values below p is below 2^62, so ``(a * b) % P`` is exact and no Montgomery
form is needed outside the CUDA kernels. (torch's ``uint32`` has no add,
shift or compare on the CPU, so int64 is also the only integer type that
the plain code can use for 32-bit words.)

Every op takes tensors of any shape and broadcasts like torch does. The
host helpers (`h_*`, byte codecs) work on Python ints.
"""

from __future__ import annotations

import torch

P = 2013265921  # 2^31 - 2^27 + 1
TWO_ADICITY = 27
# 31^15 mod p, a generator of the 2^27-torsion
PRIMITIVE_ROOT = 440564289

I64 = torch.int64


def add(a, b):
    """(a + b) mod p for reduced operands."""
    s = a + b
    return torch.where(s >= P, s - P, s)


def sub(a, b):
    """(a - b) mod p for reduced operands."""
    d = a - b
    return torch.where(d < 0, d + P, d)


def neg(a):
    """-a mod p, with 0 -> 0."""
    return torch.where(a == 0, a, P - a)


def mul(a, b):
    """(a * b) mod p; the int64 product of two values below p is exact."""
    return a * b % P


def pow_const(a, exp: int):
    """a^exp mod p elementwise, for a host-int exponent (pow(_, 0) = 1)."""
    if exp == 0:
        return torch.ones_like(a)
    result = None
    base = a
    e = exp
    while e > 0:
        if e & 1:
            result = base if result is None else mul(result, base)
        e >>= 1
        if e > 0:
            base = mul(base, base)
    return result


def inv(a):
    """a^-1 mod p by Fermat; maps 0 -> 0 (the protocol checks zeros on the
    host)."""
    return pow_const(a, P - 2)


def sum_mod(v, dim: int = -1):
    """Modular sum along a dim. n values below p sum below 2^58 for every
    n up to 2^27, so one int64 sum and one reduction are exact."""
    return torch.sum(v, dim=dim) % P


def powers(base: int, n: int, device=None) -> torch.Tensor:
    """[base^0 .. base^(n-1)] mod p as an int64 tensor, by the vectorized
    binary method (log n passes over the whole vector)."""
    base %= P
    idx = torch.arange(n, dtype=I64, device=device)
    result = torch.ones(n, dtype=I64, device=device)
    sq = base
    for b in range(max(1, (n - 1).bit_length())):
        bit = (idx >> b) & 1
        result = torch.where(bit == 1, result * sq % P, result)
        sq = sq * sq % P
    return result


# ── host-side scalar helpers (Python ints, exact) ────────────────────────────

def h_mul(a: int, b: int) -> int:
    return a * b % P


def h_add(a: int, b: int) -> int:
    return (a + b) % P


def h_sub(a: int, b: int) -> int:
    return (a - b) % P


def h_pow(a: int, e: int) -> int:
    return pow(a, e, P)


def h_inv(a: int) -> int:
    return pow(a, P - 2, P)


def get_root_of_unity(log_n: int) -> int:
    """Primitive 2^log_n-th root of unity: 440564289^(2^(27-log_n)) mod p."""
    assert log_n <= TWO_ADICITY, "BabyBear only supports NTT up to 2^27"
    return pow(PRIMITIVE_ROOT, 1 << (TWO_ADICITY - log_n), P)


# ── byte codecs (host) ───────────────────────────────────────────────────────

def to_bytes(v: int) -> bytes:
    """8-byte little-endian encoding."""
    return int(v).to_bytes(8, "little")


def from_bytes_mod_order(data: bytes) -> int:
    """First 8 bytes as a little-endian u64, reduced mod p."""
    return int.from_bytes(data[:8].ljust(8, b"\0"), "little") % P


# ── 32-bit words at a kernel's boundary ──────────────────────────────────────

def to_i32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> int32 tensors holding the same bit
    patterns (what a CUDA kernel reads as uint32)."""
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def from_i32(words: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 words in [0, 2^32)."""
    return words.to(I64) & 0xFFFFFFFF
