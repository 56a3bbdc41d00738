"""Host scalar arithmetic in the quartic extension F_p[X]/(X^4 - 11).

Only the pure-Python helpers of `toyni_tpu.field.ext` that the transcript
needs. Ext scalars are 4-tuples (c0, c1, c2, c3) of Python ints. The device
side of the extension-field mode is not ported yet.
"""

from __future__ import annotations

from .babybear import P

W = 11  # X^4 = W; X^4 - 11 is irreducible over BabyBear

ExtScalar = tuple  # (int, int, int, int)

H_ZERO: ExtScalar = (0, 0, 0, 0)
H_ONE: ExtScalar = (1, 0, 0, 0)


def h_from_base(a: int) -> ExtScalar:
    return (a % P, 0, 0, 0)


def h_add(a: ExtScalar, b: ExtScalar) -> ExtScalar:
    return tuple((x + y) % P for x, y in zip(a, b))


def h_sub(a: ExtScalar, b: ExtScalar) -> ExtScalar:
    return tuple((x - y) % P for x, y in zip(a, b))


def h_mul(a: ExtScalar, b: ExtScalar) -> ExtScalar:
    r0 = (a[0] * b[0] + W * (a[1] * b[3] + a[2] * b[2] + a[3] * b[1])) % P
    r1 = (a[0] * b[1] + a[1] * b[0] + W * (a[2] * b[3] + a[3] * b[2])) % P
    r2 = (a[0] * b[2] + a[1] * b[1] + a[2] * b[0] + W * a[3] * b[3]) % P
    r3 = (a[0] * b[3] + a[1] * b[2] + a[2] * b[1] + a[3] * b[0]) % P
    return (r0, r1, r2, r3)


def h_mul_base(a: ExtScalar, s: int) -> ExtScalar:
    return tuple(x * s % P for x in a)


def h_pow(a: ExtScalar, e: int) -> ExtScalar:
    result = H_ONE
    base = a
    while e > 0:
        if e & 1:
            result = h_mul(result, base)
        base = h_mul(base, base)
        e >>= 1
    return result


def h_inv(a: ExtScalar) -> ExtScalar:
    assert a != H_ZERO, "Cannot invert zero"
    return h_pow(a, P**4 - 2)


def h_to_bytes(a: ExtScalar) -> bytes:
    """32-byte LE serialization, 4 x 8-byte limbs."""
    return b"".join(int(x).to_bytes(8, "little") for x in a)


def h_from_bytes(data: bytes) -> ExtScalar:
    return tuple(
        int.from_bytes(data[i * 8 : i * 8 + 8], "little") % P for i in range(4)
    )
