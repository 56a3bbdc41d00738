"""Number-theoretic transform over BabyBear on torch tensors.

The contract of `toyni_tpu.ops.ntt`: a forward NTT along the last axis,
out[k] = sum_j values[j] * omega^(jk), natural order in and natural order
out; `intt` is the forward transform with omega^(n-1), then a multiply by
n^-1.

One twiddle table per (n, omega) in standard form, packed by stage: stage s
(butterfly span 2^s) reads omega_{2^s}^j for j < 2^(s-1) at offset
2^(s-1) - 1, so the whole table holds n - 1 entries. Tables are int32
(values below p fit), so the kernel reads them as they are; int64 values
times an int32 twiddle promote to int64 in the plain version.

Dispatch is by the tensor's device. A CUDA tensor goes to the hand-written
kernel (`ntt_cuda`, `csrc/ntt.cu`) and a CPU tensor to `ntt_plain`, the
radix-2 decimation-in-time transform in plain torch int64 that the kernel is
held against.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..field import babybear as bb
from ..field.babybear import P, I64
from . import ntt_cuda


def bit_reverse_permutation(n: int) -> np.ndarray:
    """Index array rev such that out[i] = in[rev[i]]."""
    log_n = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, np.int64)
    x = idx.copy()
    for _ in range(log_n):
        rev = (rev << 1) | (x & 1)
        x >>= 1
    return rev


def np_powers(base: int, n: int) -> np.ndarray:
    """[base^0 .. base^(n-1)] mod p as numpy uint64, via the vectorized
    binary method (log n passes; u64 products of 31-bit values are exact)."""
    base %= P
    idx = np.arange(n, dtype=np.uint64)
    result = np.ones(n, np.uint64)
    sq = base
    for b in range(max(1, (n - 1).bit_length())):
        bit = (idx >> np.uint64(b)) & np.uint64(1)
        result = np.where(bit == 1, result * np.uint64(sq) % np.uint64(P), result)
        sq = sq * sq % P
    return result


@functools.lru_cache(maxsize=64)
def twiddle_table(n: int, omega: int, device: str = "cpu") -> torch.Tensor:
    """The packed (n - 1,) int32 twiddle table for size n and root omega,
    built once per device."""
    parts = [torch.zeros(0, dtype=I64, device=device)]
    for s in range(1, n.bit_length()):
        w_len = pow(omega, n >> s, P)
        parts.append(bb.powers(w_len, 1 << (s - 1), device=device))
    return torch.cat(parts).to(torch.int32)


@functools.lru_cache(maxsize=64)
def _bitrev(n: int, device: str) -> torch.Tensor:
    return torch.from_numpy(bit_reverse_permutation(n)).to(device)


def ntt_plain(values: torch.Tensor, twiddles: torch.Tensor) -> torch.Tensor:
    """Forward NTT along the last axis in plain torch int64: a bit-reversal
    gather, then log n radix-2 butterfly stages over the whole tensor.
    `twiddles` is the packed table of `twiddle_table`."""
    n = values.shape[-1]
    lead = values.shape[:-1]
    v = values[..., _bitrev(n, str(values.device))]
    for s in range(1, n.bit_length()):
        half = 1 << (s - 1)
        v = v.reshape(*lead, n // (2 * half), 2, half)
        u = v[..., 0, :]
        t = bb.mul(v[..., 1, :], twiddles[half - 1 : 2 * half - 1])
        v = torch.cat([bb.add(u, t), bb.sub(u, t)], dim=-1).reshape(*lead, n)
    return v


def apply_ntt(values: torch.Tensor, twiddles: torch.Tensor) -> torch.Tensor:
    """Forward NTT along the last axis of an int64 tensor of values < p,
    with the packed twiddle table of its size and root. A CUDA tensor goes
    through the kernel, a CPU tensor through `ntt_plain`; any other device
    raises."""
    n = values.shape[-1]
    if n < 1 or n & (n - 1) or tuple(twiddles.shape) != (n - 1,):
        raise ValueError(f"NTT of size {n} needs a power of two and its "
                         f"(n - 1,) twiddle table")
    if values.device.type == "cpu":
        return ntt_plain(values, twiddles)
    if values.device.type != "cuda":
        raise ValueError(f"no NTT for device {values.device}")
    if n == 1:
        return values.clone()
    lead = values.shape[:-1]
    rows = values.reshape(-1, n).to(torch.int32).contiguous()
    out = ntt_cuda.forward(rows, twiddles)
    return out.to(I64).reshape(*lead, n)


def ntt(values: torch.Tensor, omega: int) -> torch.Tensor:
    """Forward NTT: out[k] = sum_j values[j] * omega^(jk)."""
    n = values.shape[-1]
    return apply_ntt(values, twiddle_table(n, omega, str(values.device)))


def ntt_batched(values: torch.Tensor, omega: int) -> torch.Tensor:
    """(B, n) batched forward NTT: every row transformed independently, in
    one kernel launch on the card."""
    if values.dim() != 2:
        raise ValueError("ntt_batched takes a (B, n) tensor")
    return ntt(values, omega)


def intt(values: torch.Tensor, omega: int) -> torch.Tensor:
    """Inverse NTT: forward transform with omega^(n-1), then scale by n^-1."""
    n = values.shape[-1]
    v = ntt(values, pow(omega, n - 1, P))
    return bb.mul(v, pow(n, P - 2, P))


def roots_of_unity_domain(n: int, device="cpu") -> torch.Tensor:
    """{omega^i : i < n} for the canonical size-n subgroup."""
    return bb.powers(bb.get_root_of_unity(n.bit_length() - 1), n, device=device)
