"""The CUDA kernels of toyni_tpu_torch against their plain torch versions.

Tests marked `gpu` need a CUDA card and nvcc; without a card they skip.
Run them on the card with
    python -m pytest tests/test_torch_cuda.py -q -m gpu --noconftest
(the suite's conftest imports jax, which these tests do not need;
`chip_smoke.py` runs the same comparisons at the proof's full sizes). The
unmarked tests check, on any machine, that the kernel wrappers refuse
tensors the kernels do not take instead of falling back to plain code."""

import hashlib

import numpy as np
import pytest
import torch

from toyni_tpu_torch.field import babybear as bb
from toyni_tpu_torch.field.babybear import P
from toyni_tpu_torch.ops import ntt, ntt_cuda, salts, sha256 as sha

RNG = np.random.default_rng(0xC0DA)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"


def rand(shape, dev, high=P):
    return torch.from_numpy(RNG.integers(0, high, shape, dtype=np.int64)).to(dev)


@pytest.mark.gpu
def test_ntt_kernel_matches_plain(cuda):
    for log_n, rows in ((1, 1), (2, 3), (6, 1), (11, 2), (12, 1), (15, 3)):
        n = 1 << log_n
        tw = ntt.twiddle_table(n, bb.get_root_of_unity(log_n), cuda)
        for x in (rand((rows, n), cuda),
                  torch.full((rows, n), P - 1, dtype=torch.int64, device=cuda)):
            before = ntt_cuda.LAUNCHES
            got = ntt.apply_ntt(x, tw)
            assert ntt_cuda.LAUNCHES == before + 1
            assert torch.equal(got, ntt.ntt_plain(x, tw)), (log_n, rows)


@pytest.mark.gpu
def test_sha256_kernels_match_plain_and_hashlib(cuda):
    for lanes in (1, 7, 1000):
        v = rand((lanes,), cuda)
        s = salts.salts_full((0, lanes), lanes, cuda)
        left, right = rand((lanes, 8), cuda, 1 << 32), rand((lanes, 8), cuda, 1 << 32)
        before = sha.LAUNCHES
        leaves = sha.hash_salted_leaves(v, s)
        assert torch.equal(leaves, sha.salted_leaves_plain(v, s))
        assert torch.equal(sha.hash_unsalted_leaves(v), sha.unsalted_leaves_plain(v))
        parents = sha.hash_nodes(left, right)
        assert torch.equal(parents, sha.nodes_plain(left, right))
        assert sha.LAUNCHES == before + 3
        salt = b"".join(int(w).to_bytes(4, "big") for w in s[-1].tolist())
        want = hashlib.sha256(b"\x00" + salt + int(v[-1]).to_bytes(8, "little"))
        assert sha.digest_bytes(leaves[-1]) == want.digest()


def test_kernel_wrappers_refuse_cpu_and_wrong_dtype():
    x = torch.zeros((1, 8), dtype=torch.int32)
    tw = torch.zeros(7, dtype=torch.int32)
    with pytest.raises(ValueError):
        ntt_cuda.forward(x, tw)
    with pytest.raises(ValueError):
        sha.salted_leaves(torch.zeros(4, dtype=torch.int32),
                          torch.zeros((4, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        sha.nodes(torch.zeros((2, 8), dtype=torch.int32),
                  torch.zeros((2, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        ntt.apply_ntt(torch.zeros(8, dtype=torch.int64, device="meta"),
                      torch.zeros(7, dtype=torch.int64, device="meta"))
