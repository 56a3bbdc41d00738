"""toyni_tpu_torch.ops.ntt and domain against toyni_tpu.

The port's NTT on a CPU tensor is its plain radix-2 version (`ntt_plain`),
the version the CUDA kernel is held against on the card. Here it is held
against the JAX package's transforms, including the TPU's Pallas kernel K1
(`apply_mxu_ntt` with the int8 tables) run in interpret mode. Inputs are
numpy draws from a seed; every comparison is exact (tolerance zero)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from toyni_tpu import config as jconfig
from toyni_tpu.domain import Domain as JDomain
from toyni_tpu.field.babybear import P, get_root_of_unity
from toyni_tpu.ops import ntt as jntt
from toyni_tpu.trace import ExecutionTrace as JExecutionTrace
from toyni_tpu_torch import config, convert
from toyni_tpu_torch.domain import Domain
from toyni_tpu_torch.field import babybear as bb
from toyni_tpu_torch.ops import ntt
from toyni_tpu_torch.trace import ExecutionTrace

RNG = np.random.default_rng(0x4E77)
# jitted references: one XLA compile per size instead of one per eager op
jax_ntt = jax.jit(jntt.ntt, static_argnums=1)
jax_intt = jax.jit(jntt.intt, static_argnums=1)


def t(a):
    return torch.from_numpy(np.asarray(a, np.uint64).astype(np.int64))


def j(a):
    return jnp.asarray(np.asarray(a, np.uint64).astype(np.uint32))


def same(port, ref):
    np.testing.assert_array_equal(
        port.numpy().astype(np.uint64), np.asarray(ref, np.uint64)
    )


@pytest.mark.parametrize(
    "log_ns", [(1, 2, 3, 4, 5, 6), (7, 8, 9, 10, 11), (12, 14)],
    ids=["flat-small", "flat-large", "four-step"],
)
def test_ntt_intt_match_jax(log_ns):
    """2^1 .. 2^11 cover the JAX flat stages, 2^12 and 2^14 its four-step."""
    for log_n in log_ns:
        n = 1 << log_n
        om = get_root_of_unity(log_n)
        x = RNG.integers(0, P, n, dtype=np.uint64)
        fwd = ntt.ntt(t(x), om)
        same(fwd, jax_ntt(j(x), om))
        same(ntt.intt(t(x), om), jax_intt(j(x), om))
        assert torch.equal(ntt.intt(fwd, om), t(x))


def test_ntt_matches_pallas_level_kernel():
    """The TPU kernel K1 itself: `apply_mxu_ntt` with the int8 digit tables,
    in interpret mode on the CPU (as tests/test_ntt_mxu.py runs it)."""
    from toyni_tpu.ops.ntt_mxu import apply_mxu_ntt, mxu_ntt_tables_i8

    log_n = 12
    n = 1 << log_n
    om = get_root_of_unity(log_n)
    tabs = mxu_ntt_tables_i8(n, om)
    for x in (RNG.integers(0, P, n, dtype=np.uint64),
              np.full(n, P - 1, np.uint64)):
        same(ntt.ntt(t(x), om), apply_mxu_ntt(j(x), tabs))


def test_all_p_minus_1_and_batched():
    log_n = 10
    n = 1 << log_n
    om = get_root_of_unity(log_n)
    ones = np.full(n, P - 1, np.uint64)
    same(ntt.ntt(t(ones), om), jax_ntt(j(ones), om))
    rows = RNG.integers(0, P, (4, n), dtype=np.uint64)
    batched = ntt.ntt_batched(t(rows), om)
    for r in range(4):
        assert torch.equal(batched[r], ntt.ntt(t(rows[r]), om))
    same(batched, jax_ntt(j(rows), om))


def test_roots_of_unity_domain_powers_and_interpolation():
    same(ntt.roots_of_unity_domain(64), jntt.roots_of_unity_domain(64))
    np.testing.assert_array_equal(ntt.np_powers(7, 100), jntt.np_powers(7, 100))
    col = RNG.integers(0, P, 64, dtype=np.uint64)
    tr, jtr = ExecutionTrace(), JExecutionTrace()
    tr.insert_column(col)
    jtr.insert_column(col)
    same(tr.interpolate_column(Domain.new(64), 0),
         jax.jit(jtr.interpolate_column, static_argnums=(0, 1))(JDomain.new(64), 0))


@pytest.mark.parametrize("shift", [1, 7])
def test_domain_fft_ifft_match_jax(shift):
    size = 256
    dom, jdom = Domain.new(size).get_coset(shift), JDomain.new(size).get_coset(shift)
    coeffs = RNG.integers(0, P, 100, dtype=np.uint64)  # zero-padded: an LDE
    evals = dom.fft(t(coeffs))
    jevals = jax.jit(jdom.fft)(j(coeffs))
    same(evals, jevals)
    same(dom.ifft(evals), jax.jit(jdom.ifft)(jevals))
    same(dom.elements(), jdom.elements())
    z = int(RNG.integers(0, P))
    assert dom.eval_vanishing(z) == jdom.eval_vanishing(z)


def test_tables_from_jax_equal_port_tables():
    """The port's own standard-form tables equal the JAX package's
    Montgomery-form tables carried over by `convert.tables_from_jax`."""
    from toyni_tpu.air import FibonacciAir as JAir
    from toyni_tpu.prover import _phase_fns, _xs_inv0_dev
    from toyni_tpu_torch.prover import phase_tables

    cfg = jconfig.DEFAULT_CONFIG
    n = 64
    N = n * cfg.blowup
    jt = _phase_fns(n, N, n + cfg.mask_degree, cfg.blowup, cfg.coset_shift,
                    JAir(), False, cfg.final_layer_size(n), cfg.num_queries,
                    cfg.hash)["tables"]
    np_tables = {
        "trace_intt": tuple(np.asarray(a) for a in jt["trace_intt"]),
        "fft": tuple(np.asarray(a) for a in jt["fft"]),
        "shift_fwd": np.asarray(jt["shift_fwd"]),
        "zh_tile": np.asarray(jt["zh_tile"]),
        "x": np.asarray(jt["x"]),
        "xs_inv": np.asarray(_xs_inv0_dev(N, cfg.coset_shift, get_root_of_unity(11))),
    }
    port = phase_tables(n, N, cfg.coset_shift, "cpu")
    conv = convert.tables_from_jax(np_tables)
    assert set(conv) == set(port)
    for key in port:
        assert torch.equal(conv[key], port[key]), key


def test_four_step_tables_from_jax():
    """The JAX four-step triple (column twiddles, row twiddles, W) at 2^12,
    converted, equals the port's packed tables and omega^(k1 j2)."""
    n, log_n = 1 << 12, 12
    om = get_root_of_unity(log_n)
    n1, n2, col, row, W = jntt._four_step_tables(n, om)
    conv = convert.tables_from_jax({"fft": (col, row, W)})["fft"]
    assert torch.equal(conv["col"], ntt.twiddle_table(n1, pow(om, n2, P)))
    assert torch.equal(conv["row"], ntt.twiddle_table(n2, pow(om, n1, P)))
    k1 = torch.arange(n1)[:, None]
    j2 = torch.arange(n2)[None, :]
    want = bb.powers(om, n)[(k1 * j2) % n]
    assert torch.equal(conv["w"], want)


def test_config_matches_jax():
    port, ref = config.StarkConfig(), jconfig.StarkConfig()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    for n in (64, 256, 1 << 16):
        assert port.mask_degree == ref.mask_degree
        assert port.fri_degree_bound(n) == ref.fri_degree_bound(n)
        assert port.final_layer_size(n) == ref.final_layer_size(n)
