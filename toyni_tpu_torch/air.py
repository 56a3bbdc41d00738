"""The Fibonacci AIR of `toyni_tpu.air`, the only constraint system of the
port so far:

    C(x) = (T(g^2 x) - T(g x) - T(x)) * (x - g^(n-1)) * (x - g^(n-2))

The two boundary factors switch the transition off on the final two rows.
On the LDE grid the shift by g is a roll by `blowup` positions.
"""

from __future__ import annotations

from .field import babybear as bb
from .field.babybear import P


class FibonacciAir:
    num_shifts = 3
    num_columns = 1
    num_constraints = 1

    def constraint_lde(self, t, x, g: int, n: int):
        """C on every LDE point: t[k] is the eval vector of T(g^k x), x the
        domain elements (int64 tensors)."""
        fib = bb.sub(t[2], bb.add(t[1], t[0]))
        b1 = bb.sub(x, pow(g, n - 1, P))
        b2 = bb.sub(x, pow(g, n - 2, P))
        return bb.mul(bb.mul(fib, b1), b2)

    def constraint_at(self, t, z: int, g: int, n: int) -> int:
        """C at one host scalar z, from the openings t[k] = T(g^k z)."""
        fib = (t[2] - t[1] - t[0]) % P
        b1 = (z - pow(g, n - 1, P)) % P
        b2 = (z - pow(g, n - 2, P)) % P
        return fib * b1 % P * b2 % P


def require_ported(air, config) -> None:
    """Refuse the modes the port does not prove or verify yet."""
    if not isinstance(air, FibonacciAir):
        raise NotImplementedError("only FibonacciAir is ported")
    if config.ext_challenges:
        raise NotImplementedError("extension-field challenges are not ported")
    if config.hash != "sha256":
        raise NotImplementedError(f"the {config.hash} tree hash is not ported")
