"""Carry the JAX package's constant tables over to the port.

A STARK has no weights: the state a prover carries is its config and its
constant tables. `toyni_tpu` stores several tables in Montgomery form
(a * 2^32 mod p); the port keeps every table in standard form. This module
converts the JAX tables, handed over as numpy arrays, into the port's
tensors, so the port's own table builders can be checked against them.
"""

from __future__ import annotations

import numpy as np
import torch

from .field.babybear import P

MONT_R_INV = pow(1 << 32, P - 2, P)  # 2^-32 mod p

# entries of toyni_tpu.prover._phase_fns(...)["tables"] (plus "xs_inv",
# from _xs_inv0_dev) by storage form
MONT_KEYS = ("shift_fwd", "zh_tile", "xs_inv")
STANDARD_KEYS = ("x",)
NTT_KEYS = ("trace_intt", "fft")


def from_mont(a) -> torch.Tensor:
    """Montgomery-form u32 values -> standard-form int64 tensor."""
    v = np.asarray(a).astype(np.uint64) % np.uint64(P)
    return torch.from_numpy((v * np.uint64(MONT_R_INV) % np.uint64(P)).astype(np.int64))


def _std(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _ntt_table(tabs):
    """The JAX NTT tables of one size, converted:
    - per-stage twiddle vectors (sizes below 2^12) -> the port's packed
      (n - 1,) int32 table;
    - the four-step triple (column twiddles, row twiddles, W) -> a dict of
      the two packed tables and W, all standard form."""
    if len(tabs) == 3 and np.asarray(tabs[2]).ndim == 2:
        col, row, w = tabs
        return dict(col=_ntt_table(col), row=_ntt_table(row), w=from_mont(w))
    parts = [torch.zeros(0, dtype=torch.int64)]
    return torch.cat(parts + [from_mont(t) for t in tabs]).to(torch.int32)


def tables_from_jax(np_tables: dict) -> dict:
    """JAX phase tables (numpy arrays; NTT entries as tuples of them) ->
    the port's standard-form tensors, under the same keys."""
    out = {}
    for key, val in np_tables.items():
        if key in MONT_KEYS:
            out[key] = from_mont(val)
        elif key in STANDARD_KEYS:
            out[key] = _std(val)
        elif key in NTT_KEYS:
            out[key] = _ntt_table(val)
        else:
            raise KeyError(f"unknown JAX table {key!r}")
    return out
