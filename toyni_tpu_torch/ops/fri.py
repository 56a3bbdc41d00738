"""FRI folding in standard form (`toyni_tpu.pipeline._fold_traced` and
`toyni_tpu.ops.fri.fri_fold`):

    folded[i] = (f(x_i) + f(-x_i))/2 + beta * (f(x_i) - f(-x_i))/2 * x_i^-1

with f(-x_i) = evals[i + half]. The inverse points come from a power table
squared between layers, so the fold computes no inversions.
"""

from __future__ import annotations

import torch

from ..field import babybear as bb
from ..field.babybear import P

HALF_INV = (P + 1) // 2  # 1/2 mod p


def fri_fold(evals: torch.Tensor, xs_inv: torch.Tensor, beta: int) -> torch.Tensor:
    """Fold an (n,) codeword to (n/2,) with challenge beta (host int);
    `xs_inv` holds x_i^-1 for i < n/2."""
    half = evals.shape[-1] // 2
    a, b = evals[..., :half], evals[..., half:]
    avg = bb.mul(bb.add(a, b), HALF_INV)
    diff = bb.mul(bb.sub(a, b), HALF_INV)
    odd = bb.mul(bb.mul(diff, beta), xs_inv)
    return bb.add(avg, odd)
