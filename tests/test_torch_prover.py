"""The port's prover and verifier against toyni_tpu: the golden proof bytes,
byte equality with the JAX prover for another seed and size, acceptance and
tamper rejection by both verifiers, and the port's import boundary.

The port proves on the CPU here (plain torch NTT and SHA-256); on the card
`chip_smoke.py` reproduces the same golden bytes through the CUDA kernels.
Tolerance: none, proof bytes must be equal."""

import hashlib
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from toyni_tpu import proof as jproof
from toyni_tpu.prover import StarkProver as JStarkProver
from toyni_tpu.trace import ExecutionTrace as JExecutionTrace
from toyni_tpu.verifier import StarkVerifier as JStarkVerifier
from toyni_tpu_torch import proof as proof_mod
from toyni_tpu_torch.config import StarkConfig
from toyni_tpu_torch.field.babybear import P
from toyni_tpu_torch.prover import StarkProver
from toyni_tpu_torch.trace import ExecutionTrace
from toyni_tpu_torch.verifier import StarkVerifier

# the golden fixture of tests/test_golden.py (64 rows, seed 96)
GOLDEN_SHA256 = "c71dd20794b4fae75bac1d5e608819b64893fd58bf7407945b3ba986985f42e8"
GOLDEN_T_Z = 1739385554
GOLDEN_TRACE_ROOT = "dfe84c96deb33cac1bdc33b3c3ba5830b8f2738d81994bfa8aa7ef1bb3db9b56"
REPO = Path(__file__).resolve().parent.parent


def fib(n: int) -> list:
    out, a, b = [], 1, 1
    for _ in range(n):
        out.append(a)
        a, b = b, (a + b) % P
    return out


def trace_of(cls, n: int):
    tr = cls()
    tr.insert_column(fib(n))
    return tr


@pytest.fixture(scope="module")
def golden():
    proof = StarkProver(trace_of(ExecutionTrace, 64), seed=96, device="cpu").generate_proof()
    return proof, proof_mod.serialize(proof)


def test_golden_proof_bytes(golden):
    proof, blob = golden
    assert proof.t_z == GOLDEN_T_Z
    assert proof.trace_commitment.hex() == GOLDEN_TRACE_ROOT
    assert hashlib.sha256(blob).hexdigest() == GOLDEN_SHA256


def test_both_verifiers_accept_and_reject_tampered(golden):
    _, blob = golden
    port_proof = proof_mod.deserialize(blob)
    jax_proof = jproof.deserialize(blob)
    assert StarkVerifier().verify(port_proof)
    assert JStarkVerifier().verify(jax_proof)

    def tampered(mod, field):
        p = mod.deserialize(blob)
        if field == "t_z":
            p.t_z = (p.t_z + 1) % P
        elif field == "trace_opening":
            op = p.query_proofs[3].trace_opening
            op.value = (op.value + 1) % P
        elif field == "fri_final_layer":
            p.fri_final_layer[0] = (p.fri_final_layer[0] + 1) % P
        elif field == "salt":
            op = p.query_proofs[0].quotient_opening
            op.salt = bytes([op.salt[0] ^ 1]) + op.salt[1:]
        return p

    for field in ("t_z", "trace_opening", "fri_final_layer", "salt"):
        assert not StarkVerifier().verify(tampered(proof_mod, field)), field
        assert not JStarkVerifier().verify(tampered(jproof, field)), field


def test_proof_bytes_equal_jax_prover():
    """Another size and seed: trace 128, seed 7, byte-equal to the JAX
    phase prover's proof."""
    port = StarkProver(trace_of(ExecutionTrace, 128), seed=7, device="cpu").generate_proof()
    ref = JStarkProver(trace_of(JExecutionTrace, 128), seed=7).generate_proof()
    assert proof_mod.serialize(port) == jproof.serialize(ref)
    assert StarkVerifier().verify(port)


def test_invalid_trace_is_refused():
    tr = ExecutionTrace()
    col = fib(64)
    col[10] = (col[10] + 1) % P
    tr.insert_column(col)
    with pytest.raises(ValueError, match="Constraint check"):
        StarkProver(tr, seed=1, device="cpu").generate_proof()


def test_modes_not_ported_raise():
    tr = trace_of(ExecutionTrace, 64)
    with pytest.raises(NotImplementedError):
        StarkProver(tr, config=StarkConfig(ext_challenges=True), device="cpu")
    with pytest.raises(NotImplementedError):
        StarkProver(tr, config=StarkConfig(hash="poseidon2"), device="cpu")
    with pytest.raises(NotImplementedError):
        StarkVerifier(config=StarkConfig(ext_challenges=True))
    big = ExecutionTrace()
    big.insert_column(np.ones(1 << 17, np.uint64))  # LDE 2^22: pruned trees
    with pytest.raises(NotImplementedError):
        StarkProver(big, device="cpu").generate_proof()


def test_cuda_prover_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StarkProver(trace_of(ExecutionTrace, 64), seed=96)


def test_verifier_rejects_wrong_shapes(golden):
    _, blob = golden
    p = proof_mod.deserialize(blob)
    assert not StarkVerifier().verify(replace(p, lde_size=p.lde_size * 2))
    assert not StarkVerifier().verify(replace(p, query_proofs=p.query_proofs[:-1]))
    assert not StarkVerifier().verify(replace(p, fri_commitments=p.fri_commitments[:-1]))


def test_port_imports_no_jax():
    code = (
        "import sys, toyni_tpu_torch.prover, toyni_tpu_torch.verifier, "
        "toyni_tpu_torch.convert\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'toyni_tpu' or m.startswith('toyni_tpu.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)
