#!/usr/bin/env python3
"""Smoke run of toyni_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and nvcc
(sm_90a, i.e. an H100). It builds the port's CUDA kernels from csrc/, holds
each against its plain torch version on the card, proves the golden 64-row
proof and a trace-2^16 proof (LDE 2^21) through `StarkProver`, checks them
with the port's verifier, and times the kernels and the proofs. It exits
non-zero on any failure, and without a card.

The line before the last holds the kernels' results as JSON:
name, route, source, the TPU code it replaces, launches during the 2^16
proof, max |kernel - plain| over every comparison, and the kernel's and the
plain version's time in ms at the proof's main shape (2^21). The last line
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

GOLDEN_SHA256 = "c71dd20794b4fae75bac1d5e608819b64893fd58bf7407945b3ba986985f42e8"
GOLDEN_T_Z = 1739385554
GOLDEN_TRACE_ROOT = "dfe84c96deb33cac1bdc33b3c3ba5830b8f2738d81994bfa8aa7ef1bb3db9b56"
MAIN_LOG_TRACE = 16  # trace 2^16 -> LDE 2^21, the main path's size
MAIN_SEED = 2026


def say(*a):
    print(*a, flush=True)


def fib_trace(n: int):
    from toyni_tpu_torch.field.babybear import P
    from toyni_tpu_torch.trace import ExecutionTrace

    out, a, b = [], 1, 1
    for _ in range(n):
        out.append(a)
        a, b = b, (a + b) % P
    t = ExecutionTrace()
    t.insert_column(out)
    return t


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() in ms over `iters` runs, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    assert a.shape == b.shape, (a.shape, b.shape)
    return int((a - b).abs().max())


class Checks:
    def __init__(self):
        self.err = {"ntt": 0, "sha256": 0}

    def record(self, kernel: str, what: str, got, want) -> None:
        e = max_err(got, want)
        self.err[kernel] = max(self.err[kernel], e)
        say(f"  {kernel} {what}: max|kernel - plain| = {e}")
        if e != 0:
            raise SystemExit(f"FAIL: {kernel} {what} disagrees with its plain version")


def check_kernels(chk: Checks, dev: str) -> None:
    from toyni_tpu_torch.field import babybear as bb
    from toyni_tpu_torch.field.babybear import P
    from toyni_tpu_torch.ops import ntt as ntt_ops
    from toyni_tpu_torch.ops import salts, sha256 as sha

    rng = np.random.default_rng(7)

    def rand(shape, high=P):
        return torch.from_numpy(
            rng.integers(0, high, shape, dtype=np.int64)
        ).to(dev)

    for log_n, batch in ((11, 1), (16, 1), (21, 1), (24, 1), (16, 4)):
        n = 1 << log_n
        tw = ntt_ops.twiddle_table(n, bb.get_root_of_unity(log_n), dev)
        x = rand((batch, n))
        chk.record("ntt", f"forward 2^{log_n} x{batch}",
                   ntt_ops.apply_ntt(x, tw), ntt_ops.ntt_plain(x, tw))
    n = 1 << 21
    tw = ntt_ops.twiddle_table(n, bb.get_root_of_unity(21), dev)
    x = torch.full((n,), P - 1, dtype=torch.int64, device=dev)
    chk.record("ntt", "forward 2^21 all p-1",
               ntt_ops.apply_ntt(x, tw), ntt_ops.ntt_plain(x, tw))
    n = 1 << 24
    om = bb.get_root_of_unity(24)
    x = rand((n,))
    inv_tw = ntt_ops.twiddle_table(n, pow(om, n - 1, P), dev)
    plain_inv = bb.mul(ntt_ops.ntt_plain(x, inv_tw), pow(n, P - 2, P))
    chk.record("ntt", "inverse 2^24", ntt_ops.intt(x, om), plain_inv)
    back = ntt_ops.intt(ntt_ops.ntt(x, om), om)
    if not torch.equal(back, x):
        raise SystemExit("FAIL: intt(ntt(x)) != x at 2^24")
    say("  ntt round trip 2^24: intt(ntt(x)) == x")
    del x, back, plain_inv

    lanes = 1 << 21
    v = rand((lanes,))
    s = salts.salts_full((0, 12345), lanes, dev)
    leaves = sha.hash_salted_leaves(v, s)
    chk.record("sha256", "salted leaves 2^21", leaves, sha.salted_leaves_plain(v, s))
    chk.record("sha256", "unsalted leaves 2^21", sha.hash_unsalted_leaves(v),
               sha.unsalted_leaves_plain(v))
    left, right = rand((lanes, 8), 1 << 32), rand((lanes, 8), 1 << 32)
    parents = sha.hash_nodes(left, right)
    chk.record("sha256", "nodes 2^21", parents, sha.nodes_plain(left, right))
    for i in (0, 1, lanes - 1):
        salt = b"".join(int(w).to_bytes(4, "big") for w in s[i].tolist())
        want = hashlib.sha256(b"\x00" + salt + int(v[i]).to_bytes(8, "little"))
        want_node = hashlib.sha256(
            b"\x01" + sha.digest_bytes(left[i]) + sha.digest_bytes(right[i])
        )
        if (sha.digest_bytes(leaves[i]) != want.digest()
                or sha.digest_bytes(parents[i]) != want_node.digest()):
            raise SystemExit(f"FAIL: sha256 lane {i} disagrees with hashlib")
    say("  sha256 lanes 0, 1, 2^21-1 equal hashlib")


def reset_counts() -> None:
    from toyni_tpu_torch.ops import ntt_cuda, sha256

    ntt_cuda.LAUNCHES = 0
    sha256.LAUNCHES = 0


def read_counts() -> dict:
    from toyni_tpu_torch.ops import ntt_cuda, sha256

    return {"ntt": ntt_cuda.LAUNCHES, "sha256": sha256.LAUNCHES}


def golden_proof(dev: str) -> None:
    from toyni_tpu_torch import proof as proof_mod
    from toyni_tpu_torch.prover import StarkProver
    from toyni_tpu_torch.verifier import StarkVerifier

    reset_counts()
    proof = StarkProver(fib_trace(64), seed=96, device=dev).generate_proof()
    counts = read_counts()
    blob = proof_mod.serialize(proof)
    digest = hashlib.sha256(blob).hexdigest()
    say(f"  sha256(proof) = {digest}; launches {counts}")
    if (digest != GOLDEN_SHA256 or proof.t_z != GOLDEN_T_Z
            or proof.trace_commitment.hex() != GOLDEN_TRACE_ROOT):
        raise SystemExit("FAIL: golden proof bytes differ")
    if min(counts.values()) == 0:
        raise SystemExit("FAIL: a kernel was not launched by the golden proof")
    verify_and_tamper(proof_mod, StarkVerifier(), proof)


def verify_and_tamper(proof_mod, verifier, proof) -> None:
    if not verifier.verify(proof):
        raise SystemExit("FAIL: the verifier rejects the proof")
    bad = proof_mod.deserialize(proof_mod.serialize(proof))
    op = bad.query_proofs[0].trace_opening
    op.value = (op.value + 1) % (1 << 31)
    if verifier.verify(bad):
        raise SystemExit("FAIL: the verifier accepts a tampered proof")
    say("  verifier accepts the proof and rejects a tampered copy")


def main_proof(dev: str) -> dict:
    """The main path: a trace-2^16 proof through StarkProver on the card.
    Returns the kernel launch counts of that run."""
    from toyni_tpu_torch import proof as proof_mod
    from toyni_tpu_torch.field import babybear as bb
    from toyni_tpu_torch.field.babybear import P
    from toyni_tpu_torch.ops import ntt as ntt_ops
    from toyni_tpu_torch.ops import salts, sha256 as sha
    from toyni_tpu_torch.prover import StarkProver, lde_input, phase_tables
    from toyni_tpu_torch.verifier import StarkVerifier

    n = 1 << MAIN_LOG_TRACE
    trace = fib_trace(n)
    prover = StarkProver(trace, seed=MAIN_SEED, device=dev)
    cfg = prover.config
    N = n * cfg.blowup
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    proof = prover.generate_proof()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    say(f"  trace 2^{MAIN_LOG_TRACE} (LDE 2^{N.bit_length() - 1}) proof in "
        f"{seconds:.3f} s (cold: builds its tables); launches {counts}; "
        f"{len(proof_mod.serialize(proof))} bytes")
    if min(counts.values()) == 0:
        raise SystemExit("FAIL: a kernel of the main path was not launched")
    verify_and_tamper(proof_mod, StarkVerifier(), proof)

    # The commit's first half again through the plain versions on the card:
    # the same draws (mask, then the trace salts' key), plain NTTs, plain
    # SHA-256 leaves and levels. Its LDE must equal the kernel's and its root
    # the proof's trace commitment.
    rng = np.random.default_rng(MAIN_SEED)
    r_mask = torch.from_numpy(
        rng.integers(0, P, cfg.mask_degree, dtype=np.uint64).astype(np.int64)
    ).to(dev)
    key = salts.key_words(int(rng.integers(0, 2**63)))
    tabs = phase_tables(n, N, cfg.coset_shift, dev)
    col = torch.from_numpy(trace.columns[0].astype(np.int64)).to(dev)
    coeffs_plain = bb.mul(ntt_ops.ntt_plain(col, tabs["trace_intt"]), pow(n, P - 2, P))
    coeffs_kern = bb.mul(ntt_ops.apply_ntt(col, tabs["trace_intt"]), pow(n, P - 2, P))
    lde_plain = ntt_ops.ntt_plain(
        lde_input(coeffs_plain, r_mask, tabs["shift_fwd"]), tabs["fft"])
    lde_kern = ntt_ops.apply_ntt(
        lde_input(coeffs_kern, r_mask, tabs["shift_fwd"]), tabs["fft"])
    if not torch.equal(lde_plain, lde_kern):
        raise SystemExit("FAIL: trace LDE differs between kernel and plain paths")
    level = sha.salted_leaves_plain(lde_plain, salts.salts_full(key, N, dev))
    while level.shape[0] > 1:
        pairs = level.reshape(-1, 16)
        level = sha.nodes_plain(pairs[:, :8], pairs[:, 8:])
    if sha.digest_bytes(level[0]) != proof.trace_commitment:
        raise SystemExit("FAIL: trace root differs between kernel and plain paths")
    say("  trace LDE and trace root equal the plain path's on the card")
    return counts


def timings(dev: str) -> dict:
    from toyni_tpu_torch.field import babybear as bb
    from toyni_tpu_torch.field.babybear import P
    from toyni_tpu_torch.ops import ntt as ntt_ops, ntt_cuda
    from toyni_tpu_torch.ops import salts, sha256 as sha
    from toyni_tpu_torch.prover import StarkProver

    rng = np.random.default_rng(9)
    out = {}
    for log_n in (16, 21, 24):
        n = 1 << log_n
        tw = ntt_ops.twiddle_table(n, bb.get_root_of_unity(log_n), dev)
        x = torch.from_numpy(rng.integers(0, P, (1, n), dtype=np.int64)).to(dev)
        x32 = x.to(torch.int32)
        iters = 20 if log_n < 24 else 10
        k_ms = cuda_ms(lambda: ntt_cuda.forward(x32, tw), iters)
        d_ms = cuda_ms(lambda: ntt_ops.apply_ntt(x, tw), iters)
        p_ms = cuda_ms(lambda: ntt_ops.ntt_plain(x, tw), max(2, iters // 4))
        gbf = n // 2 * log_n / 1e9
        say(f"  ntt 2^{log_n}: kernel {k_ms:.4f} ms ({gbf / k_ms * 1e3:.2f} Gbf/s), "
            f"with int64<->int32 dispatch {d_ms:.4f} ms, plain {p_ms:.4f} ms "
            f"({gbf / p_ms * 1e3:.2f} Gbf/s)")
        out[f"ntt_2^{log_n}"] = dict(kernel_ms=k_ms, dispatch_ms=d_ms, plain_ms=p_ms,
                                     kernel_gbf_s=gbf / k_ms * 1e3,
                                     plain_gbf_s=gbf / p_ms * 1e3)

    lanes = 1 << 21
    v = torch.from_numpy(rng.integers(0, P, lanes, dtype=np.int64)).to(dev)
    s = salts.salts_full((0, 99), lanes, dev)
    v32, s32 = bb.to_i32(v), bb.to_i32(s).contiguous()
    left = torch.from_numpy(rng.integers(0, 1 << 32, (lanes, 8), dtype=np.int64)).to(dev)
    right = torch.from_numpy(rng.integers(0, 1 << 32, (lanes, 8), dtype=np.int64)).to(dev)
    l32, r32 = bb.to_i32(left).contiguous(), bb.to_i32(right).contiguous()
    for name, kern, plain, count in (
        ("salted leaf level", lambda: sha.salted_leaves(v32, s32),
         lambda: sha.salted_leaves_plain(v, s), lanes),
        ("node level", lambda: sha.nodes(l32, r32),
         lambda: sha.nodes_plain(left, right), lanes),
    ):
        k_ms = cuda_ms(kern, 20)
        p_ms = cuda_ms(plain, 3)
        say(f"  sha256 {name} ({count} hashes): kernel {k_ms:.4f} ms "
            f"({count / k_ms / 1e3:.1f} Mhash/s), plain {p_ms:.4f} ms "
            f"({count / p_ms / 1e3:.1f} Mhash/s)")
        out[f"sha256_{name.split()[0]}"] = dict(
            kernel_ms=k_ms, plain_ms=p_ms, hashes=count,
            kernel_mhash_s=count / k_ms / 1e3, plain_mhash_s=count / p_ms / 1e3)

    for log_n, iters in ((8, 5), (16, 3)):
        trace = fib_trace(1 << log_n)
        StarkProver(trace, seed=1, device=dev).generate_proof()  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(iters):
            StarkProver(trace, seed=2 + i, device=dev).generate_proof()
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / iters
        say(f"  proof trace 2^{log_n}: {sec:.4f} s/proof ({1 / sec:.3f} proofs/s, "
            f"mean of {iters} after one warm-up)")
        out[f"proof_2^{log_n}"] = dict(s_per_proof=sec, iters=iters)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs a CUDA card",
              file=sys.stderr)
        return 1
    from toyni_tpu_torch import _build

    dev = "cuda:0"
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say(f"[1] device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    say(smi)

    t0 = time.perf_counter()
    _build.load()
    say(f"[2] kernel build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.BUILD_INFO.get('seconds', 0.0):.2f} s) -> "
        f"{_build.library_path().name}")
    # ptxas -v: registers, shared memory and spills of each kernel
    for line in _build.BUILD_INFO.get("log", "").splitlines():
        if "Compiling entry function" in line or "Used" in line or "spill" in line:
            say("  " + line.strip())

    chk = Checks()
    say("[3] kernels against their plain versions on the card")
    check_kernels(chk, dev)

    say("[4] golden 64-row proof on the card")
    golden_proof(dev)

    say(f"[5] trace 2^{MAIN_LOG_TRACE} proof on the card (main path)")
    counts = main_proof(dev)

    say(f"[6] timings on {smi}")
    t = timings(dev)
    say(json.dumps({"timings": t, "card": smi}))

    kernels = [
        dict(name="ntt", route="cuda", source="toyni_tpu_torch/csrc/ntt.cu",
             replaces="toyni_tpu/ops/ntt_mxu.py:301", launches=counts["ntt"],
             max_abs_err=chk.err["ntt"], ms=t["ntt_2^21"]["kernel_ms"],
             plain_ms=t["ntt_2^21"]["plain_ms"]),
        dict(name="sha256", route="cuda", source="toyni_tpu_torch/csrc/sha256.cu",
             replaces="toyni_tpu/ops/sha256.py:376", launches=counts["sha256"],
             max_abs_err=chk.err["sha256"], ms=t["sha256_salted"]["kernel_ms"],
             plain_ms=t["sha256_salted"]["plain_ms"]),
    ]
    say(smi)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
