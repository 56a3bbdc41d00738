"""toyni_tpu_torch: the toyni-tpu STARK prover in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (H100).

A port of `toyni_tpu` (JAX on a TPU), which stays the reference: the port
mirrors its module names, and for the same seed its prover writes the same
proof bytes. Plain code holds field values and 32-bit words in torch.int64;
the NTT and SHA-256 run as CUDA kernels (`csrc/`) for tensors on the card
and as plain torch for tensors on the CPU. The kernels are built with nvcc
at first CUDA use (`_build.py`).
"""
