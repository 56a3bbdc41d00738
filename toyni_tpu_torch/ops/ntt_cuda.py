"""Launch wrapper of the NTT kernel (`csrc/ntt.cu`).

The kernel takes the place of the TPU's Pallas level kernel
(`toyni_tpu/ops/ntt_mxu.py::_level_kernel_i8` through `_dft_level`). Its
plain version is `ops.ntt.ntt_plain`, which `ops.ntt.apply_ntt` uses for
CPU tensors.
"""

from __future__ import annotations

import torch

from .. import _build

# kernel launches since the last reset (each `forward` call is one)
LAUNCHES = 0


def forward(x: torch.Tensor, twiddles: torch.Tensor) -> torch.Tensor:
    """Forward NTT of every row of a (B, n) int32 CUDA tensor of values
    below p, natural order in and out. `twiddles` is the packed (n - 1,)
    int32 table of `ops.ntt.twiddle_table`."""
    global LAUNCHES
    if x.device.type != "cuda" or twiddles.device != x.device:
        raise ValueError("ntt kernel: tensors must be on one CUDA device")
    if x.dtype != torch.int32 or twiddles.dtype != torch.int32:
        raise TypeError("ntt kernel: int32 tensors expected")
    if x.dim() != 2 or not x.is_contiguous() or not twiddles.is_contiguous():
        raise ValueError("ntt kernel: a contiguous (B, n) tensor expected")
    rows, n = x.shape
    log_n = n.bit_length() - 1
    if n != 1 << log_n or not 1 <= log_n <= 27:
        raise ValueError(f"ntt kernel: n = {n} is not 2^k with 1 <= k <= 27")
    if twiddles.numel() != n - 1:
        raise ValueError("ntt kernel: twiddle table does not match n")
    out = torch.empty_like(x)
    if rows == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(
            lib.toyni_ntt_forward(
                x.data_ptr(), out.data_ptr(), twiddles.data_ptr(), rows, log_n,
                stream,
            ),
            "ntt kernel launch",
        )
    LAUNCHES += 1
    return out
