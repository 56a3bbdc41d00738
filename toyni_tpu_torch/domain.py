"""Evaluation domains over BabyBear with NTT-based coset FFT/IFFT.

The counterpart of `toyni_tpu.domain`: a multiplicative subgroup
{omega^i} optionally shifted to a coset {h * omega^i}; FFT = coset shift,
then NTT; IFFT = INTT, then unshift. Tables are in standard form and built
once per (size, shift, device).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace

import torch

from .field import babybear as bb
from .field.babybear import P, get_root_of_unity
from .ops import ntt as ntt_ops


@functools.lru_cache(maxsize=64)
def _shift_tables(n: int, shift: int, device: str = "cpu"):
    """(shift^i, shift^-i) for i < n, standard form, int64 on `device`."""
    return (
        bb.powers(shift, n, device=device),
        bb.powers(pow(shift, P - 2, P), n, device=device),
    )


@dataclass(frozen=True)
class Domain:
    """A size-2^k evaluation domain {shift * omega^i : i < size}."""

    size: int
    log_size: int
    omega: int  # primitive size-th root of unity
    shift: int  # 1 for the standard domain, h for the coset {h * omega^i}

    @staticmethod
    def new(size: int) -> "Domain":
        assert size & (size - 1) == 0, "Domain size must be power of 2"
        log_size = size.bit_length() - 1
        return Domain(size, log_size, get_root_of_unity(log_size), 1)

    def get_coset(self, shift: int) -> "Domain":
        return replace(self, shift=shift % P)

    def group_gen(self) -> int:
        return self.omega

    def elements(self, device="cpu") -> torch.Tensor:
        """{shift * omega^i} as an int64 tensor."""
        return bb.powers(self.omega, self.size, device=device) * self.shift % P

    def eval_vanishing(self, x: int) -> int:
        """Z_H(x) = x^n - shift^n at a host scalar."""
        return (pow(x, self.size, P) - pow(self.shift, self.size, P)) % P

    def fft(self, coeffs: torch.Tensor) -> torch.Tensor:
        """Evaluate the coefficients on this domain (along the last axis):
        zero-pad to size (the low-degree extension), multiply coeff[i] by
        h^i, then NTT."""
        n = self.size
        pad = n - coeffs.shape[-1]
        assert pad >= 0, "more coefficients than domain points"
        c = torch.nn.functional.pad(coeffs, (0, pad)) if pad else coeffs
        if self.shift != 1:
            fwd, _ = _shift_tables(n, self.shift, str(c.device))
            c = bb.mul(c, fwd)
        return ntt_ops.ntt(c, self.omega)

    def ifft(self, evals: torch.Tensor) -> torch.Tensor:
        """Coefficients from evaluations on this domain: INTT, then divide
        coeff[i] by h^i."""
        assert evals.shape[-1] == self.size, "evaluation count must match size"
        v = ntt_ops.intt(evals, self.omega)
        if self.shift != 1:
            _, bwd = _shift_tables(self.size, self.shift, str(v.device))
            v = bb.mul(v, bwd)
        return v
